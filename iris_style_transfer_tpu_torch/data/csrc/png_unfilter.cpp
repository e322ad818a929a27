// PNG row unfiltering and gray conversion for the port's frame decoder.
//
// The host side of the input pipeline (data/native_loader.py): Python's
// zlib inflates a file's IDAT stream, then these loops undo the five PNG
// row filters (spec section 9) and fold colour to 8-bit gray.  They are
// the byte-serial part of a decode (Paeth and Average depend on the byte
// just written), which Python cannot run at frame rate.  No external
// header: the port assumes no libpng or libjpeg on the machine.  Called
// through ctypes, which releases the GIL, so the loader's threads decode
// frames in parallel.
//
// Build: c++ -O3 -std=c++17 -shared -fPIC (ops/cuda_build.py:load_host_library).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Branch-free: on natural images the choice is data-dependent, and a
// branch would mispredict often.
inline int paeth(int a, int b, int c) {
  int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  int take_a = -static_cast<int>((pa <= pb) & (pa <= pc));
  int take_b = -static_cast<int>(pb <= pc);
  int bc = (b & take_b) | (c & ~take_b);
  return (a & take_a) | (bc & ~take_a);
}

// One row: Sub, Average and Paeth depend on the byte just written bpp
// bytes to the left, a serial chain.  For gray (bpp 1, both datasets) the
// left byte stays in a register: through memory, each step would also
// wait on a store-to-load forward.
void unfilter_row(uint8_t ftype, const uint8_t* line, const uint8_t* up, uint8_t* cur, int64_t n, int bpp) {
  if (n == 0) return;
  switch (ftype) {
    case 1:  // Sub
      for (int64_t i = 0; i < bpp; ++i) cur[i] = line[i];
      if (bpp == 1) {
        uint8_t left = cur[0];
        for (int64_t i = 1; i < n; ++i) cur[i] = left = static_cast<uint8_t>(line[i] + left);
      } else {
        for (int64_t i = bpp; i < n; ++i) cur[i] = static_cast<uint8_t>(line[i] + cur[i - bpp]);
      }
      return;
    case 2:  // Up
      for (int64_t i = 0; i < n; ++i) cur[i] = static_cast<uint8_t>(line[i] + up[i]);
      return;
    case 3:  // Average
      for (int64_t i = 0; i < bpp; ++i) cur[i] = static_cast<uint8_t>(line[i] + (up[i] >> 1));
      if (bpp == 1) {
        int left = cur[0];
        for (int64_t i = 1; i < n; ++i) cur[i] = static_cast<uint8_t>(left = (line[i] + ((left + up[i]) >> 1)) & 0xFF);
      } else {
        for (int64_t i = bpp; i < n; ++i) cur[i] = static_cast<uint8_t>(line[i] + ((cur[i - bpp] + up[i]) >> 1));
      }
      return;
    case 4:  // Paeth; for the first pixel left = upleft = 0, so it predicts up
      for (int64_t i = 0; i < bpp; ++i) cur[i] = static_cast<uint8_t>(line[i] + up[i]);
      if (bpp == 1) {
        int left = cur[0], upleft = up[0];
        for (int64_t i = 1; i < n; ++i) {
          int b = up[i];
          left = (line[i] + paeth(left, b, upleft)) & 0xFF;
          cur[i] = static_cast<uint8_t>(left);
          upleft = b;
        }
      } else {
        for (int64_t i = bpp; i < n; ++i)
          cur[i] = static_cast<uint8_t>(line[i] + paeth(cur[i - bpp], up[i], up[i - bpp]));
      }
      return;
    default:  // None
      std::memcpy(cur, line, n);
  }
}

}  // namespace

extern "C" {

// raw: h rows of (1 filter byte + stride bytes), as inflated; out: h rows
// of stride bytes; bpp: bytes per pixel (1-4).  Returns 0, or 1 + the
// index of the first row whose filter type is not 0-4.
int png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h, int64_t stride, int bpp) {
  std::vector<uint8_t> zeros(stride, 0);  // the row above the first
  const uint8_t* up = zeros.data();
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* row = raw + r * (stride + 1);
    if (row[0] > 4) return static_cast<int>(r + 1);
    uint8_t* cur = out + r * stride;
    unfilter_row(row[0], row + 1, up, cur, stride, bpp);
    up = cur;
  }
  return 0;
}

// n pixels of `channels` interleaved 8-bit samples (1 gray, 2 gray+alpha,
// 3 RGB, 4 RGBA) to n gray bytes, as PIL's convert("L") does: alpha
// dropped, colour by ITU-R 601-2 luma in 16-bit fixed point,
// (R*19595 + G*38470 + B*7471 + 0x8000) >> 16.  Returns 0, or 1 for a
// channel count it does not take.
int png_to_gray(const uint8_t* pix, uint8_t* out, int64_t n, int channels) {
  switch (channels) {
    case 1:
      std::memcpy(out, pix, n);
      return 0;
    case 2:
      for (int64_t i = 0; i < n; ++i) out[i] = pix[2 * i];
      return 0;
    case 3:
    case 4:
      for (int64_t i = 0; i < n; ++i) {
        const uint8_t* p = pix + i * channels;
        uint32_t v = p[0] * 19595u + p[1] * 38470u + p[2] * 7471u + 0x8000u;
        out[i] = static_cast<uint8_t>(v >> 16);
      }
      return 0;
    default:
      return 1;
  }
}

}  // extern "C"
