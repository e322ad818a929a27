"""CLAHE — contrast-limited adaptive histogram equalization, batched.

Counterpart of ``iris_style_transfer_tpu/ops/clahe.py``: OpenCV's algorithm
(clipLimit=1.5, tileGridSize=(8,8)) reproduced exactly —

  1. per-tile 256-bin histogram (a scatter-add of ones: counts are exact),
  2. clip at ``max(int(clip * tile_area / 256), 1)`` and redistribute the
     excess (uniform share + cv2's strided residual),
  3. per-tile LUT = round-half-even(cdf * 255 / tile_area),
  4. bilinear interpolation of the four neighbouring tile LUTs per pixel
     (a gather of the four tile LUTs at each pixel's level).

H and W must be divisible by the grid.  Input/output are float images in
[0,1], quantized to uint8 internally like the reference's uint8 round trip.
"""

from __future__ import annotations

import torch


def _tile_histograms(img_u8: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
    """(B, H, W) integer levels -> (B, gh*gw, 256) float32 counts."""
    b, h, w = img_u8.shape
    gh, gw = grid
    th, tw = h // gh, w // gw
    tiles = img_u8.reshape(b, gh, th, gw, tw).permute(0, 1, 3, 2, 4).reshape(b * gh * gw, th * tw)
    base = torch.arange(b * gh * gw, device=img_u8.device, dtype=torch.int64)[:, None] * 256
    idx = (base + tiles.to(torch.int64)).reshape(-1)
    hist = torch.zeros(b * gh * gw * 256, device=img_u8.device, dtype=torch.float32)
    hist.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    return hist.reshape(b, gh * gw, 256)


def _clip_redistribute(hist: torch.Tensor, clip_limit: float, tile_area: int) -> torch.Tensor:
    """cv2's clip + redistribution over the last (256-bin) axis."""
    limit = float(max(int(clip_limit * tile_area / 256.0), 1))
    clipped = torch.clamp_min(hist - limit, 0.0).sum(dim=-1, keepdim=True)
    hist = torch.clamp_max(hist, limit)
    redist = torch.floor(clipped / 256.0)
    residual = clipped - redist * 256.0
    hist = hist + redist
    # cv2: step = max(256 // residual, 1); bins 0, step, 2*step, ... get +1,
    # exactly `residual` times
    step = torch.clamp_min(torch.floor(256.0 / torch.clamp_min(residual, 1.0)), 1.0)
    i = torch.arange(256, device=hist.device, dtype=torch.float32)
    bump = (torch.floor(i / step) * step == i) & (torch.floor(i / step) < residual)
    return torch.where(residual > 0, hist + bump.to(torch.float32), hist)


def clahe(x: torch.Tensor, clip_limit: float = 1.5, grid: tuple[int, int] = (8, 8)) -> torch.Tensor:
    """CLAHE on a batch of float (B, H, W) images in [0,1]; returns float."""
    b, h, w = x.shape
    gh, gw = grid
    if h % gh or w % gw:
        raise ValueError(f"CLAHE requires H,W divisible by grid; got {tuple(x.shape)} vs {grid}")
    th, tw = h // gh, w // gw
    tile_area = th * tw

    # round (not truncate): float inputs are u8/255
    img_u8 = torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.int64)
    hists = _clip_redistribute(_tile_histograms(img_u8, grid), clip_limit, tile_area)
    cdf = torch.cumsum(hists, dim=-1)
    luts = torch.clamp(torch.round(cdf * (255.0 / tile_area)), 0.0, 255.0)  # (B, T, 256)

    # cv2's coordinate convention (txf = x/tileW - 0.5); base and +1
    # neighbour are clipped independently from the unclipped floor
    yy = torch.arange(h, device=x.device, dtype=torch.float32)
    xx = torch.arange(w, device=x.device, dtype=torch.float32)
    tyf = yy / th - 0.5
    txf = xx / tw - 0.5
    ty0 = torch.floor(tyf)
    tx0 = torch.floor(txf)
    wy = (tyf - ty0)[:, None]
    wx = (txf - tx0)[None, :]
    ty0i = ty0.to(torch.int64).clamp(0, gh - 1)
    ty1i = (ty0.to(torch.int64) + 1).clamp(0, gh - 1)
    tx0i = tx0.to(torch.int64).clamp(0, gw - 1)
    tx1i = (tx0.to(torch.int64) + 1).clamp(0, gw - 1)

    flat = luts.reshape(b, gh * gw * 256)

    def lookup(tyi, txi):
        idx = (tyi[:, None] * gw + txi[None, :]) * 256 + img_u8  # (B, H, W)
        return torch.gather(flat, 1, idx.reshape(b, -1)).reshape(b, h, w)

    l00, l01 = lookup(ty0i, tx0i), lookup(ty0i, tx1i)
    l10, l11 = lookup(ty1i, tx0i), lookup(ty1i, tx1i)
    top = l00 * (1 - wx) + l01 * wx
    bot = l10 * (1 - wx) + l11 * wx
    out = top * (1 - wy) + bot * wy
    return torch.clamp(torch.round(out), 0.0, 255.0).to(x.dtype) / 255.0
