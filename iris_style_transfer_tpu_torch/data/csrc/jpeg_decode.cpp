// JPEG decoder for the port's image readers (utils/jpeg.py).
//
// Baseline, extended 8-bit Huffman and progressive files (SOF0, SOF1,
// SOF2), with restart intervals, decoded to 8-bit gray, RGB or the file's
// own components, equal bit for bit to libjpeg-turbo under its defaults
// (the library behind PIL's Image.open):
//   - every scan is decoded into a whole-image coefficient buffer, and the
//     IDCT runs after the last scan, as libjpeg's non-buffered mode takes
//     in every scan of a progressive file before its first output row;
//   - dequantization and the "ISLOW" integer IDCT of jidctint.c
//     (CONST_BITS 13, PASS1_BITS 2) with its range-limit table;
//   - chroma upsampling as jdsample.c picks it with do_fancy_upsampling on:
//     the triangle filters h2v1 and h2v2 (when the component is wider than
//     2 samples) and h1v2, the integer box replication otherwise;
//   - YCbCr to RGB with jdcolor.c's 16-bit fixed-point tables; files coded
//     in RGB (Adobe transform 0, or component ids 'R','G','B' without JFIF
//     or Adobe markers, jdapimin.c's rule) skip it.
// Gray output of a colour file folds RGB with PIL's fixed-point luma, as
// Image.convert("L") does; a 1-component file is its Y plane.
//
// Errors: a truncated or corrupt stream (a bad Huffman code, entropy data
// that runs out, a missing or misnumbered restart marker, a bad marker
// segment, bytes where a marker belongs, an MCU of more than 10 blocks)
// returns 1; a form this decoder
// does not read (arithmetic coding, lossless, hierarchical, 12-bit, 2 or 4
// components, non-integral sampling, a progressive file whose scans leave
// coefficients 0-9 incomplete, which libjpeg would block-smooth) returns
// 2.  The message goes to the caller's buffer.  No external header: the
// port assumes no libjpeg on its machine.  Called through ctypes, which
// releases the GIL, so the loader's threads decode in parallel.
//
// Build: c++ -O3 -std=c++17 -shared -fPIC (ops/cuda_build.py:load_host_library).

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kCorrupt = 1, kUnsupported = 2 };

struct Failure {
  int status;
  std::string msg;
};

[[noreturn]] void fail(int status, const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Failure{status, buf};
}

// zigzag position -> natural (row-major) position; 16 spare entries keep a
// run past 63 inside the block, as jutils.c's table does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t counts[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoff[17] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | symbol; 0: a code longer than kLookBits
};

// jdhuff.c:jpeg_make_d_derived_tbl: canonical codes, the same overflow
// check, DC symbols at most 15
void build_table(HuffTable& t, bool dc) {
  int sizes[257], p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < t.counts[l]; ++i) sizes[p++] = l;
  sizes[p] = 0;
  const int n = p;
  uint32_t codes[257];
  uint32_t code = 0;
  int si = sizes[0];
  p = 0;
  while (sizes[p]) {
    while (sizes[p] == si) codes[p++] = code++;
    if (code >= (1u << si)) fail(kCorrupt, "bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.counts[l]) {
      t.valoff[l] = p - static_cast<int32_t>(codes[p]);
      p += t.counts[l];
      t.maxcode[l] = static_cast<int32_t>(codes[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.look, 0, sizeof t.look);
  p = 0;
  for (int l = 1; l <= kLookBits; ++l)
    for (int i = 0; i < t.counts[l]; ++i, ++p) {
      uint32_t first = codes[p] << (kLookBits - l);
      for (uint32_t k = 0; k < (1u << (kLookBits - l)); ++k)
        t.look[first + k] = static_cast<uint16_t>((l << 8) | t.vals[p]);
    }
  if (dc)
    for (int i = 0; i < n; ++i)
      if (t.vals[i] > 15) fail(kCorrupt, "bad Huffman table");
  t.defined = true;
}

// Entropy-coded data: bytes after 0xFF 0x00 unstuffed; at a marker (or the
// end of the file) the reader feeds zeros, as libjpeg does, and counts the
// real bits, so that a decode that eats into the zeros fails.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;   // bits in buf
  int real = 0;  // of them, bits that came from the stream
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint64_t byte = 0;
      bool data = false;
      if (!at_marker && p < end) {
        if (*p != 0xFF) {
          byte = *p++;
          data = true;
        } else {  // 0xFF, fill bytes, then 0x00 (a stuffed 0xFF) or a marker
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q < end && *q == 0) {
            byte = 0xFF;
            p = q + 1;
            data = true;
          } else {
            at_marker = true;  // p stays on the marker's first 0xFF
          }
        }
      }
      buf |= byte << (56 - cnt);
      cnt += 8;
      if (data) real += 8;
    }
  }
  uint32_t peek(int n) const { return static_cast<uint32_t>(buf >> (64 - n)); }
  void skip(int n) {
    if (n > real) fail(kCorrupt, "premature end of entropy-coded data");
    buf <<= n;
    cnt -= n;
    real -= n;
  }
  uint32_t get(int n) {  // n in 0..16
    if (n == 0) return 0;
    if (cnt < 32) fill();
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  int decode(const HuffTable& t) {
    if (cnt < 32) fill();
    uint16_t e = t.look[peek(kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(peek(l));
      if (code <= t.maxcode[l]) {
        skip(l);
        return t.vals[(t.valoff[l] + code) & 0xFF];
      }
    }
    fail(kCorrupt, "bad Huffman code");
  }
  // the end of a scan or restart interval: what is left is padding, less
  // than a byte; returns the position of the marker that follows
  const uint8_t* finish() {
    if (real >= 8) fail(kCorrupt, "extraneous bytes in the entropy-coded data");
    if (p >= end || *p != 0xFF) fail(kCorrupt, "extraneous bytes in the entropy-coded data");
    return p;
  }
  void restart(const uint8_t* at) {
    p = at;
    buf = 0;
    cnt = real = 0;
    at_marker = false;
  }
};

inline int extend(uint32_t r, int s) {
  return s == 0 ? 0 : (r < (1u << (s - 1)) ? static_cast<int>(r) - (1 << s) + 1 : static_cast<int>(r));
}

// Buffers reused by every decode on a thread: a fresh allocation of this
// size comes from mmap and faults its pages in under the process's memory
// lock, which serializes the loader's threads.
struct Scratch {
  std::vector<int16_t> coef[4];
  std::vector<uint8_t> plane[4], full[3], line;
  std::vector<int> sums;
};

Scratch& scratch() {
  static thread_local Scratch s;
  return s;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;            // the current scan's tables
  int bw = 0, bh = 0;            // blocks allocated (whole MCUs)
  int wib = 0, hib = 0;          // width/height_in_blocks
  int dsw = 0, dsh = 0;          // downsampled width/height
  bool latched = false;
  int32_t quant[64] = {};        // latched at the component's first scan
  int coef_bits[64];
  int16_t* coef = nullptr;       // bh * bw blocks of 64 (Scratch::coef)
  uint8_t* plane = nullptr;      // hib*8 rows of wib*8 samples (Scratch::plane)
  int dc_pred = 0;
};

// Fails on the marker of a coding process this decoder does not read.
void refuse_frame(int m) {
  if (m == 0xC3) fail(kUnsupported, "lossless JPEG (SOF3)");
  if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE || m == 0xCF || m == 0xDE || m == 0xDF)
    fail(kUnsupported, "hierarchical JPEG (marker 0x%02X)", m);
  if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCC)  // SOF9-11, DAC
    fail(kUnsupported, "arithmetic-coded JPEG (marker 0x%02X)", m);
}

struct Decoder {
  const uint8_t* data;
  int64_t n;
  int64_t pos = 0;
  bool have_frame = false, progressive = false;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int scans = 0;

  uint8_t byte_at(int64_t i) const {
    if (i >= n) fail(kCorrupt, "truncated file");
    return data[i];
  }
  int u16(int64_t i) const { return (byte_at(i) << 8) | byte_at(i + 1); }

  // the next marker at pos (fill bytes skipped); pos moves past it
  int next_marker() {
    if (byte_at(pos) != 0xFF) fail(kCorrupt, "bytes where a marker belongs");
    while (byte_at(pos) == 0xFF) ++pos;
    return data[pos++];
  }

  // a marker segment's body [pos + 2, pos + len); pos moves past it
  int64_t segment(int64_t* body) {
    int len = u16(pos);
    if (len < 2 || pos + len > n) fail(kCorrupt, "truncated marker segment");
    *body = pos + 2;
    int64_t end = pos + len;
    pos = end;
    return end;
  }

  void parse_sof(int marker) {
    int64_t b, end = segment(&b);
    if (have_frame) fail(kCorrupt, "a second frame header");
    if (end - b < 6) fail(kCorrupt, "bad frame header");
    int precision = byte_at(b);
    if (precision != 8) fail(kUnsupported, "%d-bit sample precision (8-bit only)", precision);
    height = u16(b + 1);
    width = u16(b + 3);
    ncomp = byte_at(b + 5);
    if (width == 0 || height == 0) fail(kCorrupt, "empty image (or a DNL height, which is not read)");
    if (ncomp == 4) fail(kUnsupported, "4 components (CMYK/YCCK)");
    if (ncomp != 1 && ncomp != 3) fail(kUnsupported, "%d components (1 or 3 are read)", ncomp);
    if (end - b != 6 + 3 * ncomp) fail(kCorrupt, "bad frame header length");
    progressive = marker == 0xC2;
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = byte_at(b + 6 + 3 * c);
      int hv = byte_at(b + 7 + 3 * c);
      k.h = hv >> 4;
      k.v = hv & 15;
      k.tq = byte_at(b + 8 + 3 * c);
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4) fail(kCorrupt, "bad sampling factors");
      if (k.tq > 3) fail(kCorrupt, "bad quantization table index");
      if (k.h > hmax) hmax = k.h;
      if (k.v > vmax) vmax = k.v;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      if (hmax % k.h || vmax % k.v)
        fail(kUnsupported, "non-integral sampling factors (%dx%d of %dx%d)", k.h, k.v, hmax, vmax);
      k.dsw = static_cast<int>((static_cast<int64_t>(width) * k.h + hmax - 1) / hmax);
      k.dsh = static_cast<int>((static_cast<int64_t>(height) * k.v + vmax - 1) / vmax);
      k.wib = (k.dsw + 7) / 8;
      k.hib = (k.dsh + 7) / 8;
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
    }
    have_frame = true;
  }

  void parse_dht() {
    int64_t b, end = segment(&b);
    while (b < end) {
      int tc_th = byte_at(b++);
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail(kCorrupt, "bad Huffman table class or index");
      HuffTable& t = tc ? ac[th] : dc[th];
      int total = 0;
      t.counts[0] = 0;
      for (int l = 1; l <= 16; ++l) total += (t.counts[l] = byte_at(b++));
      if (total > 256 || b + total > end) fail(kCorrupt, "bad Huffman table");
      for (int i = 0; i < total; ++i) t.vals[i] = data[b++];
      build_table(t, tc == 0);
    }
  }

  void parse_dqt() {
    int64_t b, end = segment(&b);
    while (b < end) {
      int pq_tq = byte_at(b++);
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) fail(kCorrupt, "bad quantization table");
      if (b + 64 * (pq + 1) > end) fail(kCorrupt, "bad quantization table length");
      for (int i = 0; i < 64; ++i) {  // stored in zigzag order
        int q = pq ? u16(b + 2 * i) : byte_at(b + i);
        qt[tq][kNatural[i]] = static_cast<uint16_t>(q);
      }
      b += 64 * (pq + 1);
      qt_defined[tq] = true;
    }
  }

  void parse_app(int marker) {
    int64_t b, end = segment(&b);
    int64_t len = end - b;
    if (marker == 0xE0 && len >= 14 && std::memcmp(data + b, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(data + b, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = data[b + 11];
    }
  }

  // the whole-image coefficient buffers, zeroed, at the first scan (the
  // frame header alone, as jpeg_header reads it, allocates nothing)
  void allocate() {
    for (int c = 0; c < ncomp; ++c) {
      std::vector<int16_t>& coef = scratch().coef[c];
      coef.assign(static_cast<size_t>(comp[c].bw) * comp[c].bh * 64, 0);
      comp[c].coef = coef.data();
    }
  }

  void parse_sos_and_decode() {
    if (!have_frame) fail(kCorrupt, "a scan before the frame header");
    if (scans == 0) allocate();
    int64_t b, end = segment(&b);
    int ns = byte_at(b);
    if (ns < 1 || ns > 4 || end - b != 4 + 2 * ns) fail(kCorrupt, "bad scan header");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int id = byte_at(b + 1 + 2 * i), t = byte_at(b + 2 + 2 * i);
      Component* k = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) k = &comp[c];
      if (!k) fail(kCorrupt, "a scan names component %d, which the frame lacks", id);
      for (int j = 0; j < i; ++j)
        if (sc[j] == k) fail(kCorrupt, "a scan names a component twice");
      k->td = t >> 4;
      k->ta = t & 15;
      if (k->td > 3 || k->ta > 3) fail(kCorrupt, "bad Huffman table index");
      sc[i] = k;
    }
    if (ns > 1) {  // jdinput.c:per_scan_setup
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) fail(kCorrupt, "an MCU of %d blocks (at most 10)", blocks);
    }
    int ss = byte_at(b + 1 + 2 * ns), se = byte_at(b + 2 + 2 * ns), a = byte_at(b + 3 + 2 * ns);
    int ah = a >> 4, al = a & 15;
    // jdinput.c:latch_quant_tables
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      if (k.latched) continue;
      if (!qt_defined[k.tq]) fail(kCorrupt, "a component's quantization table is undefined");
      // libjpeg keeps the table in 16-bit multipliers
      for (int j = 0; j < 64; ++j) k.quant[j] = static_cast<int16_t>(qt[k.tq][j]);
      k.latched = true;
    }
    if (progressive) {
      // jdphuff.c:start_pass_phuff_decoder's checks; its warnings fail here
      bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail(kCorrupt, "bad progression parameters Ss=%d Se=%d Ah=%d Al=%d", ss, se, ah, al);
      for (int i = 0; i < ns; ++i) {
        int* bits = sc[i]->coef_bits;
        if (ss != 0 && bits[0] < 0) fail(kCorrupt, "an AC scan before the component's DC scan");
        for (int k = ss; k <= se; ++k) {
          int expected = bits[k] < 0 ? 0 : bits[k];
          if (ah != expected) fail(kCorrupt, "bogus progression: coefficient %d refined out of order", k);
          bits[k] = al;
        }
      }
      for (int i = 0; i < ns; ++i) {
        if ((ss == 0 && ah == 0 && !dc[sc[i]->td].defined) || (ss != 0 && !ac[sc[i]->ta].defined))
          fail(kCorrupt, "a scan uses an undefined Huffman table");
      }
    } else {
      if (ss != 0 || se != 63 || ah != 0 || al != 0) fail(kCorrupt, "a sequential scan with Ss/Se/Ah/Al set");
      for (int i = 0; i < ns; ++i) {
        if (!dc[sc[i]->td].defined || !ac[sc[i]->ta].defined)
          fail(kCorrupt, "a scan uses an undefined Huffman table");
        for (int k = 0; k < 64; ++k) sc[i]->coef_bits[k] = 0;
      }
    }
    ++scans;
    decode_scan(sc, ns, ss, se, ah, al);
  }

  void decode_scan(Component** sc, int ns, int ss, int se, int ah, int al) {
    Bits bits{data + pos, data + n};
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    int eobrun = 0, next_rst = 0;
    // one component: one block an MCU over the component's own blocks;
    // several: whole MCUs of h x v blocks each
    const int64_t mcus = ns == 1 ? static_cast<int64_t>(sc[0]->wib) * sc[0]->hib
                                 : static_cast<int64_t>(mcux) * mcuy;
    for (int64_t m = 0; m < mcus; ++m) {
      if (restart_interval && m && m % restart_interval == 0) {
        const uint8_t* at = bits.finish();
        int64_t mp = at - data;
        while (mp < n && data[mp] == 0xFF) ++mp;
        if (mp >= n) fail(kCorrupt, "truncated file");
        if (data[mp] != 0xD0 + next_rst) fail(kCorrupt, "restart marker %d expected", next_rst);
        bits.restart(data + mp + 1);
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        eobrun = 0;
      }
      if (ns == 1) {
        Component& k = *sc[0];
        int64_t bx = m % k.wib, by = m / k.wib;
        decode_block(bits, k, &k.coef[(by * k.bw + bx) * 64], ss, se, ah, al, eobrun);
      } else {
        int64_t mx = m % mcux, my = m / mcux;
        for (int i = 0; i < ns; ++i) {
          Component& k = *sc[i];
          for (int v = 0; v < k.v; ++v)
            for (int h = 0; h < k.h; ++h) {
              int64_t by = my * k.v + v, bx = mx * k.h + h;
              decode_block(bits, k, &k.coef[(by * k.bw + bx) * 64], ss, se, ah, al, eobrun);
            }
        }
      }
    }
    pos = bits.finish() - data;
  }

  void decode_block(Bits& b, Component& k, int16_t* blk, int ss, int se, int ah, int al, int& eobrun) {
    if (!progressive) {  // jdhuff.c:decode_mcu
      int s = b.decode(dc[k.td]);
      k.dc_pred += extend(b.get(s), s);
      blk[0] = static_cast<int16_t>(k.dc_pred);
      const HuffTable& t = ac[k.ta];
      for (int i = 1; i < 64; ++i) {
        int rs = b.decode(t);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          i += r;
          if (i > 63) fail(kCorrupt, "a coefficient run past the block");
          blk[kNatural[i]] = static_cast<int16_t>(extend(b.get(s), s));
        } else {
          if (r != 15) break;
          i += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // jdphuff.c: DC first and refine
      if (ah == 0) {
        int s = b.decode(dc[k.td]);
        k.dc_pred += extend(b.get(s), s);
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(k.dc_pred) << al);
      } else if (b.get(1)) {
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
      }
      return;
    }
    const HuffTable& t = ac[k.ta];
    if (ah == 0) {  // AC first
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int i = ss; i <= se; ++i) {
        int rs = b.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          i += r;
          if (i > 63) fail(kCorrupt, "a coefficient run past the block");
          blk[kNatural[i]] = static_cast<int16_t>(static_cast<uint32_t>(extend(b.get(s), s)) << al);
        } else if (r == 15) {
          i += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          --eobrun;
          break;
        }
      }
      return;
    }
    // AC refine (jdphuff.c:decode_mcu_AC_refine)
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    if (eobrun == 0) {
      for (; i <= se; ++i) {
        int rs = b.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail(kCorrupt, "bad Huffman code in a refinement scan");
          s = b.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[i];
          if (*c != 0) {
            if (b.get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
          } else if (--r < 0) {
            break;
          }
          ++i;
        } while (i <= se);
        if (s) {
          if (i > 63) fail(kCorrupt, "a coefficient run past the block");
          blk[kNatural[i]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; i <= se; ++i) {
        int16_t* c = blk + kNatural[i];
        if (*c != 0 && b.get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
      }
      --eobrun;
    }
  }

  void read() {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail(kCorrupt, "not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      int64_t b;
      refuse_frame(m);
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
          parse_sof(m);
          break;
        case 0xC4:
          parse_dht();
          break;
        case 0xDB:
          parse_dqt();
          break;
        case 0xDD: {
          int64_t end = segment(&b);
          if (end - b != 2) fail(kCorrupt, "bad DRI segment");
          restart_interval = u16(b);
          break;
        }
        case 0xDA:
          parse_sos_and_decode();
          break;
        case 0xD9:  // EOI
          if (!have_frame || scans == 0) fail(kCorrupt, "no image data before EOI");
          return;
        case 0xDC:
          fail(kUnsupported, "a DNL marker");
        case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        case 0x01:  // parameterless; libjpeg passes over them
          break;
        case 0xD8:
          fail(kCorrupt, "a second SOI marker");
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
            parse_app(m);
            break;
          }
          fail(kCorrupt, "unknown marker 0x%02X", m);
      }
    }
  }

  // jdcoefct.c:smoothing_ok would turn block smoothing on: some coefficient
  // 0-9 of a component still unknown or unrefined after the last scan
  void check_complete() const {
    if (!progressive) return;
    for (int c = 0; c < ncomp; ++c)
      for (int k = 0; k < 10; ++k)
        if (comp[c].coef_bits[k] != 0)
          fail(kUnsupported, "progressive scans leave coefficient %d of component %d incomplete (libjpeg would "
                             "smooth the blocks)", k, c);
  }

  bool rgb_coded() const {  // jdapimin.c:default_decompress_parms
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }
};

// jidctint.c:jpeg_idct_islow and jdmaster.c's range-limit table
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    // the IDCT's table: index (x & 1023) for a centred x; 0..127 -> 128..255,
    // 128..511 -> 255, 512..895 -> 0, 896..1023 -> 0..127
    for (int x = 0; x < 1024; ++x) {
      int v = x < 128 ? x + 128 : x < 512 ? 255 : x < 896 ? 0 : x - 896;
      t[x] = static_cast<uint8_t>(v);
    }
  }
};

inline int32_t descale(int64_t x, int n) { return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n); }

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, int stride, const uint8_t* limit) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int32_t* qp = q + c;
    int32_t* w = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int32_t dc = static_cast<int32_t>(static_cast<uint32_t>(ip[0] * qp[0]) << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, sh);
    w[56] = descale(tmp10 - tmp3, sh);
    w[8] = descale(tmp11 + tmp2, sh);
    w[48] = descale(tmp11 - tmp2, sh);
    w[16] = descale(tmp12 + tmp1, sh);
    w[40] = descale(tmp12 - tmp1, sh);
    w[24] = descale(tmp13 + tmp0, sh);
    w[32] = descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + static_cast<int64_t>(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = limit[descale(w[0], kPass1Bits + 3) & 1023];
      std::memset(o, v, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int sh = kConstBits + kPass1Bits + 3;
    o[0] = limit[descale(tmp10 + tmp3, sh) & 1023];
    o[7] = limit[descale(tmp10 - tmp3, sh) & 1023];
    o[1] = limit[descale(tmp11 + tmp2, sh) & 1023];
    o[6] = limit[descale(tmp11 - tmp2, sh) & 1023];
    o[2] = limit[descale(tmp12 + tmp1, sh) & 1023];
    o[5] = limit[descale(tmp12 - tmp1, sh) & 1023];
    o[3] = limit[descale(tmp13 + tmp0, sh) & 1023];
    o[4] = limit[descale(tmp13 - tmp0, sh) & 1023];
  }
}

void idct_component(Component& k, std::vector<uint8_t>& plane) {
  static const RangeLimit limit;
  const int stride = k.wib * 8;
  plane.resize(static_cast<size_t>(stride) * k.hib * 8);
  k.plane = plane.data();
  for (int by = 0; by < k.hib; ++by)
    for (int bx = 0; bx < k.wib; ++bx)
      idct_islow(&k.coef[(static_cast<int64_t>(by) * k.bw + bx) * 64], k.quant,
                 k.plane + static_cast<size_t>(by) * 8 * stride + bx * 8, stride, limit.t);
}

// jdsample.c: one component to full size, (height, width) samples.  The
// fancy filters replicate the edge samples (jdmainct.c gives the first row
// itself as the row above it and the last real row as the rows below).
void upsample(const Component& k, int hmax, int vmax, int height, int width, std::vector<uint8_t>& out) {
  const int stride = k.wib * 8;
  const uint8_t* in = k.plane;
  const int dsw = k.dsw, dsh = k.dsh;
  out.resize(static_cast<size_t>(height) * width);
  auto row = [&](int r) { return in + static_cast<size_t>(r < 0 ? 0 : r >= dsh ? dsh - 1 : r) * stride; };
  std::vector<int>& sums = scratch().sums;
  std::vector<uint8_t>& line = scratch().line;
  sums.resize(2 * static_cast<size_t>(dsw) + 2);
  line.resize(2 * static_cast<size_t>(dsw) + 2);
  const bool h2 = k.h * 2 == hmax, v2 = k.v * 2 == vmax;
  if (h2 && k.v == vmax && dsw > 2) {  // h2v1 fancy
    for (int y = 0; y < height; ++y) {
      const uint8_t* ip = row(y);
      uint8_t* o = line.data();
      o[0] = ip[0];
      o[1] = static_cast<uint8_t>((ip[0] * 3 + ip[1] + 2) >> 2);
      for (int i = 1; i < dsw - 1; ++i) {
        int x = ip[i] * 3;
        o[2 * i] = static_cast<uint8_t>((x + ip[i - 1] + 1) >> 2);
        o[2 * i + 1] = static_cast<uint8_t>((x + ip[i + 1] + 2) >> 2);
      }
      o[2 * dsw - 2] = static_cast<uint8_t>((ip[dsw - 1] * 3 + ip[dsw - 2] + 1) >> 2);
      o[2 * dsw - 1] = ip[dsw - 1];
      std::memcpy(&out[static_cast<size_t>(y) * width], o, width);
    }
    return;
  }
  if (k.h == hmax && v2) {  // h1v2 fancy
    for (int y = 0; y < height; ++y) {
      int r = y >> 1;
      const uint8_t* near = row(r);
      const uint8_t* far = row((y & 1) ? r + 1 : r - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = &out[static_cast<size_t>(y) * width];
      for (int x = 0; x < width; ++x) o[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
    }
    return;
  }
  if (h2 && v2 && dsw > 2) {  // h2v2 fancy
    for (int y = 0; y < height; ++y) {
      int r = y >> 1;
      const uint8_t* near = row(r);
      const uint8_t* far = row((y & 1) ? r + 1 : r - 1);
      int* cs = sums.data();
      for (int i = 0; i < dsw; ++i) cs[i] = near[i] * 3 + far[i];
      uint8_t* o = line.data();
      o[0] = static_cast<uint8_t>((cs[0] * 4 + 8) >> 4);
      o[1] = static_cast<uint8_t>((cs[0] * 3 + cs[1] + 7) >> 4);
      for (int i = 1; i < dsw - 1; ++i) {
        o[2 * i] = static_cast<uint8_t>((cs[i] * 3 + cs[i - 1] + 8) >> 4);
        o[2 * i + 1] = static_cast<uint8_t>((cs[i] * 3 + cs[i + 1] + 7) >> 4);
      }
      o[2 * dsw - 2] = static_cast<uint8_t>((cs[dsw - 1] * 3 + cs[dsw - 2] + 8) >> 4);
      o[2 * dsw - 1] = static_cast<uint8_t>((cs[dsw - 1] * 4 + 7) >> 4);
      std::memcpy(&out[static_cast<size_t>(y) * width], o, width);
    }
    return;
  }
  // fullsize copy and the integer box replication (h2v1, h2v2, int_upsample)
  const int he = hmax / k.h, ve = vmax / k.v;
  for (int y = 0; y < height; ++y) {
    const uint8_t* ip = row(y / ve);
    uint8_t* o = &out[static_cast<size_t>(y) * width];
    if (he == 1) {
      std::memcpy(o, ip, width);
    } else {
      for (int x = 0; x < width; ++x) o[x] = ip[x / he];
    }
  }
}

// jdcolor.c:build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = int32_t{1} << (kScale - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << kScale) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (fix(1.40200) * x + kHalf) >> kScale;
      cb_b[i] = (fix(1.77200) * x + kHalf) >> kScale;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// PIL's Convert.c: L24(rgb) >> 16
inline uint8_t luma(int r, int g, int b) {
  return static_cast<uint8_t>((r * 19595u + g * 38470u + b * 7471u + 0x8000u) >> 16);
}

// out_channels: 0 the file's own (1 or 3), 1 gray, 3 RGB
void emit(Decoder& d, uint8_t* out, int out_channels) {
  Scratch& sc = scratch();
  for (int c = 0; c < d.ncomp; ++c) idct_component(d.comp[c], sc.plane[c]);
  const int h = d.height, w = d.width;
  if (d.ncomp == 1) {
    const Component& k = d.comp[0];
    const int stride = k.wib * 8;
    const int ch = out_channels == 3 ? 3 : 1;
    for (int y = 0; y < h; ++y) {
      const uint8_t* ip = k.plane + static_cast<size_t>(y) * stride;
      uint8_t* o = out + static_cast<size_t>(y) * w * ch;
      if (ch == 1) {
        std::memcpy(o, ip, w);
      } else {
        for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = ip[x];
      }
    }
    return;
  }
  std::vector<uint8_t>* full = sc.full;
  for (int c = 0; c < 3; ++c) upsample(d.comp[c], d.hmax, d.vmax, h, w, full[c]);
  static const YccTables tab;
  const bool ycc = !d.rgb_coded();
  const bool gray = out_channels == 1;
  const size_t n = static_cast<size_t>(h) * w;
  const uint8_t *c0 = full[0].data(), *c1 = full[1].data(), *c2 = full[2].data();
  for (size_t i = 0; i < n; ++i) {
    int r, g, b;
    if (ycc) {
      int y = c0[i], cb = c1[i], cr = c2[i];
      r = clamp255(y + tab.cr_r[cr]);
      g = clamp255(y + static_cast<int>((tab.cb_g[cb] + tab.cr_g[cr]) >> 16));
      b = clamp255(y + tab.cb_b[cb]);
    } else {
      r = c0[i];
      g = c1[i];
      b = c2[i];
    }
    if (gray) {
      out[i] = luma(r, g, b);
    } else {
      out[3 * i] = static_cast<uint8_t>(r);
      out[3 * i + 1] = static_cast<uint8_t>(g);
      out[3 * i + 2] = static_cast<uint8_t>(b);
    }
  }
}

int report(const Failure& f, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, f.msg.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
  return f.status;
}

}  // namespace

extern "C" {

// The frame header of a JPEG held in data[0, n): info = (height, width,
// components).  Returns 0, 1 (corrupt or truncated) or 2 (a form not read),
// with a message in err.
int jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  try {
    Decoder d{data, n};
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) fail(kCorrupt, "not a JPEG file (no SOI marker)");
    d.pos = 2;
    while (!d.have_frame) {
      int m = d.next_marker();
      refuse_frame(m);
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        d.parse_sof(m);
      } else if (m == 0xD9 || m == 0xDA) {
        fail(kCorrupt, "no frame header");
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        continue;
      } else {
        int64_t b;
        d.segment(&b);
      }
    }
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    return kOk;
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Failure{kCorrupt, "out of memory"}, err, errlen);
  }
}

// Decode the JPEG in data[0, n) into out: (height, width, out_channels)
// uint8 with out_channels 1 (gray) or 3 (RGB), or 0 for the file's own
// components (1 or 3); height and width must be the file's.  Returns as
// jpeg_header does.
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int32_t height, int32_t width, int32_t out_channels,
                char* err, int errlen) {
  try {
    Decoder d{data, n};
    d.read();
    if (d.height != height || d.width != width)
      fail(kCorrupt, "size %dx%d, not the %dx%d asked for", d.height, d.width, height, width);
    d.check_complete();
    emit(d, out, out_channels);
    return kOk;
  } catch (const Failure& f) {
    return report(f, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Failure{kCorrupt, "out of memory"}, err, errlen);
  }
}

}  // extern "C"
