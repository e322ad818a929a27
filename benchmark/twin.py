"""The synthetic eye twin, made on the device from the seed.

The same eyes as the port's numpy generator (``data/synthetic.py``):
sclera and iris ellipses and a pupil over a 0.35 background, a per-user
iris texture ``0.35 + 0.18 sin(f0 r + p0) cos(80 f1 theta + p1)``, a
Gaussian glint on the iris, N(0, 0.01) noise, clipped to [0, 1], with the
4-class labels (0 background, 1 sclera, 2 iris, 3 pupil).  With ``gaze``
the iris centre moves inside the sclera by the gaze's x/y offset and the
unit gaze vectors come back too.  Here every draw comes from a
``torch.Generator`` on the device and a batch is made in one pass, so a
batch of 128 frames at 400x640 takes milliseconds; batch ``b`` of a seed
is the same whatever other batches are made.
"""

from __future__ import annotations

import torch

MIX = 0x9E3779B97F4A7C15


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for (seed, stream), any non-negative seed."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream * MIX + 1) % (2**63 - 1))


def user_textures(seed: int, num_users: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    g = generator(seed, 0, device)
    freq = torch.rand(num_users, 2, generator=g, device=device) * 0.25 + 0.05
    phase = torch.rand(num_users, 2, generator=g, device=device) * 6.28
    return freq, phase


def eyes(seed: int, batch: int, n: int, num_users: int, height: int = 400, width: int = 640,
         gaze: bool = False, device="cuda") -> dict:
    """Batch ``batch`` of the seed's twin: ``frames`` (n, H, W, 1) uint8,
    ``labels`` (n, H, W) uint8, ``users`` (n,) int64, and with ``gaze``
    the unit ``gaze`` vectors (n, 3)."""
    freq, phase = user_textures(seed, num_users, device)
    g = generator(seed, batch + 1, device)
    u = lambda lo, hi: torch.rand(n, 1, 1, generator=g, device=device) * (hi - lo) + lo  # noqa: E731
    users = torch.randint(0, num_users, (n,), generator=g, device=device)
    cx, cy = width / 2 + u(-40, 40), height / 2 + u(-30, 30)
    sa, sb = u(200, 260), u(90, 130)
    iris_r = u(55, 80)
    pupil_r = iris_r * u(0.3, 0.5)
    out = {}
    if gaze:
        offs = torch.rand(n, 2, generator=g, device=device) * 2 - 1
        v = torch.cat([offs * 0.45, -torch.ones(n, 1, device=device)], 1)
        out["gaze"] = v / v.norm(dim=1, keepdim=True)
        icx = cx + offs[:, 0, None, None] * 0.45 * (sa - iris_r)
        icy = cy + offs[:, 1, None, None] * 0.45 * (sb - iris_r)
    else:
        icx, icy = cx, cy
    yy = torch.arange(height, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, None, :]
    d_scl = ((xx - cx) / sa) ** 2 + ((yy - cy) / sb) ** 2
    d_iris = (xx - icx) ** 2 + (yy - icy) ** 2
    seg = torch.zeros(n, height, width, dtype=torch.uint8, device=device)
    seg[(d_scl <= 1.0).expand_as(seg)] = 1
    seg[(d_iris <= iris_r**2).expand_as(seg)] = 2
    seg[(d_iris <= pupil_r**2).expand_as(seg)] = 3
    f, p = freq[users][:, :, None, None], phase[users][:, :, None, None]
    theta = torch.atan2(yy - icy, xx - icx)
    tex = 0.35 + 0.18 * torch.sin(f[:, 0] * torch.sqrt(d_iris) + p[:, 0]) * torch.cos(8 * theta * f[:, 1] * 10 + p[:, 1])
    img = torch.full((n, height, width), 0.35, device=device)
    img = torch.where(seg == 1, 0.85, img)
    img = torch.where(seg == 2, tex, img)
    img = torch.where(seg == 3, 0.05, img)
    gx = icx + u(-0.5, 0.5) * iris_r
    gy = icy + u(-0.5, 0.5) * iris_r
    img = (img + torch.exp(-((xx - gx) ** 2 + (yy - gy) ** 2) / 18.0)).clamp(0, 1)
    img = img + torch.randn(n, height, width, generator=g, device=device) * 0.01
    out["frames"] = torch.round(img.clamp(0, 1) * 255.0).to(torch.uint8)[..., None]
    out["labels"] = seg
    out["users"] = users
    return out
