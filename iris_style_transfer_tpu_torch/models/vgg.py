"""VGG19 feature extractor with layer taps.

Counterpart of ``iris_style_transfer_tpu/models/vgg.py`` (reference
``models/vgg/vgg.py``): torchvision's vgg19 ``features`` stack, ImageNet
normalization inside the forward, optional mask multiply, content/style
taps, ``truncate`` after the deepest tap, ``final`` in float32.

Inputs are NCHW in [0,1]; activations run in ``compute_dtype`` with
channels_last memory.  conv1_1 (C_in = 3) is the small-C_in conv
(``ops/conv1.py``) and block 1's relu1_2 + pool1 the fused relu+pool op
(``ops/relu_pool.py``): on a CUDA device both are always the hand-written
kernels.  Pools 2-4 are relu plus the tie-to-all ``max_pool``, and odd
extents take the plain pool, as in the JAX package.  ``stats_taps=True``
computes each style tap with the fused relu+stats op
(``ops/relu_stats.py``; on a CUDA device the hand-written kernels) and
returns its (mean, std) pair instead of the activation.

With a ``mesh`` whose model axis has m > 1 ranks (``parallel/mesh.py``,
the port of JAX's ``spatial_sharding``), ``x`` is this rank's slab of H
rows and every activation stays a slab: each 3x3 conv first takes one halo
row from each neighbouring rank (``halo_rows``, zeros at the image's edges)
and pads only W; the 2x2 pools stay within the slab, whose height must then
be even at each pool.  conv1_1's kernel pads 1 on every side, so it runs on
the h + 2 haloed rows and its rows 1..h are kept: no second kernel path and
no H-padding argument in the kernel and its plain twin, for 2 extra rows a
slab (1.8% of conv1_1 at m = 2 on a 224-px crop).  The stats taps' slab
sums are added over the model group in one packed reduction after the
forward, and their (mean, std) are the whole image's.  The JAX package
takes its XLA forms under ``model_sharded`` because a ``pallas_call`` has
no SPMD rule; here the kernels run on the slabs, computing the same
function.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops import conv1
from ..ops.image import imagenet_normalize
from ..ops.losses import stats_from_slab_sums, stats_from_sums
from ..parallel.mesh import Mesh, halo_rows
from . import layers as L

_CFG = [
    64, 64, "M",
    128, 128, "M",
    256, 256, 256, 256, "M",
    512, 512, 512, 512, "M",
    512, 512, 512, 512, "M",
]

VGG19_LAYERS: dict[str, int] = {}
VGG19_BN_LAYERS: dict[str, int] = {}
_CFG_CHANNELS: dict[str, int] = {}


def _build_tables():
    idx = idx_bn = 0
    block, conv_in_block = 1, 1
    for c in _CFG:
        if c == "M":
            VGG19_LAYERS[f"pool{block}"] = idx
            VGG19_BN_LAYERS[f"pool{block}"] = idx_bn
            idx += 1
            idx_bn += 1
            block += 1
            conv_in_block = 1
        else:
            name = f"{block}_{conv_in_block}"
            VGG19_LAYERS[f"conv{name}"] = idx
            VGG19_LAYERS[f"relu{name}"] = idx + 1
            idx += 2
            VGG19_BN_LAYERS[f"conv{name}"] = idx_bn
            VGG19_BN_LAYERS[f"bn{name}"] = idx_bn + 1
            VGG19_BN_LAYERS[f"relu{name}"] = idx_bn + 2
            idx_bn += 3
            _CFG_CHANNELS[f"conv{name}"] = c
            conv_in_block += 1


_build_tables()

CONV_NAMES = [n for n in VGG19_LAYERS if n.startswith("conv")]
DEFAULT_CONTENT_LAYERS = ("relu4_2",)
DEFAULT_STYLE_LAYERS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1")


class VGG19:
    """Functional VGG19: ``params = VGG19.init(gen)``,
    ``final, content, style = VGG19.apply(params, x, ...)``."""

    layers = VGG19_LAYERS
    conv_names = CONV_NAMES

    @staticmethod
    def stats_taps_eligible(style_layers: Sequence[str], content_layers: Sequence[str]) -> bool:
        """True iff every style tap is a relu not shared with the content
        taps: the one rule for whether ``stats_taps`` may apply (a partial
        set would return a mixed tensor / (mean, std) style list)."""
        return all(n.startswith("relu") and n not in content_layers for n in style_layers)

    @staticmethod
    def init(gen: torch.Generator, device="cpu", dtype=torch.float32, bn: bool = False) -> dict:
        """Seeded He-normal (fan_out) init with zero bias, torchvision's own
        distribution for VGG; ``bn=True`` builds the vgg19_bn variant."""
        params = {}
        cin = 3
        for name in CONV_NAMES:
            cout = _CFG_CHANNELS[name]
            params[name] = L.init_conv_he(gen, 3, 3, cin, cout, device, dtype)
            if bn:
                params["bn" + name[4:]] = L.init_batchnorm(cout, device, dtype)
            cin = cout
        return params

    @staticmethod
    def cast(params: dict, dtype: torch.dtype) -> dict:
        """Conv weights in ``dtype`` and channels_last memory, done once
        ahead of a loop that runs many forwards (batchnorm leaves stay)."""
        out = {}
        for k, p in params.items():
            if k.startswith("conv"):
                out[k] = {"w": p["w"].to(dtype).contiguous(memory_format=torch.channels_last),
                          "b": p["b"].to(dtype)}
            else:
                out[k] = p
        return out

    @staticmethod
    def apply(
        params: dict,
        x: torch.Tensor,
        mask: torch.Tensor | None = None,
        content_layers: Sequence[str] = DEFAULT_CONTENT_LAYERS,
        style_layers: Sequence[str] = DEFAULT_STYLE_LAYERS,
        compute_dtype=torch.float32,
        truncate: bool = False,
        bn: bool = False,
        stats_taps: bool = False,
        mesh: Mesh | None = None,
    ):
        """x: (B, 3, H, W) in [0,1].  Returns ``(final, content_feats,
        style_feats)``; taps stay in ``compute_dtype``, ``final`` is float32.
        ``truncate=True`` stops after the deepest requested tap.
        ``stats_taps=True`` returns each style entry as its (mean, std)
        pair, (B, C) float32 each; every style layer must then be a relu
        that is not also a content layer (else ``ValueError``).  With a
        ``mesh`` of more than one model rank, ``x`` is this rank's slab of
        H and so are ``final`` and the tensor taps; the (mean, std) pairs
        are the whole image's."""
        taps_wanted = set(content_layers) | set(style_layers)
        if stats_taps and not VGG19.stats_taps_eligible(style_layers, content_layers):
            raise ValueError("stats_taps=True requires every style layer to be a relu not shared "
                             f"with content_layers; got {list(style_layers)}")
        stats_set = set(style_layers) if stats_taps else set()
        table = VGG19_BN_LAYERS if bn else VGG19_LAYERS
        stop_idx = max(table[n] for n in taps_wanted) if truncate else None

        h = imagenet_normalize(x.float())
        if mask is not None:
            h = h * mask.to(h.dtype)
        h = h.to(compute_dtype).contiguous(memory_format=torch.channels_last)

        sharded = mesh is not None and mesh.shape["model"] > 1
        taps: dict[str, torch.Tensor] = {}
        slab_sums: dict[str, tuple] = {}  # sharded stats taps: (s1, s2, the whole tap's H*W)
        block, conv_in_block, idx = 1, 1, 0
        fuse_next_pool = False
        for ci, c in enumerate(_CFG):
            if stop_idx is not None and idx > stop_idx:
                break
            if c == "M":
                if sharded and h.shape[2] % 2:
                    raise ValueError(f"pool{block} of a slab of {h.shape[2]} rows: the 2x2 pools must stay "
                                     "within a slab (parallel/mesh.py:height_sharding)")
                h = L.relu_max_pool(h) if fuse_next_pool else L.max_pool(h, 2)
                fuse_next_pool = False
                idx += 1
                block += 1
                conv_in_block = 1
                continue
            cname = f"conv{block}_{conv_in_block}"
            bname = f"bn{block}_{conv_in_block}"
            rname = f"relu{block}_{conv_in_block}"
            if h.shape[1] <= conv1.MAX_CIN:  # conv1_1: the small-C_in kernel, as JAX's h.shape[-1] * 9 <= 128
                h = conv1.conv1(halo_rows(h, mesh), params[cname])[:, :, 1:-1] if sharded else \
                    conv1.conv1(h, params[cname])
            elif sharded:
                h = L.conv2d(halo_rows(h, mesh), params[cname], stride=1, padding=(0, 1))
            else:
                h = L.conv2d(h, params[cname], stride=1, padding=1)
            if cname in taps_wanted:
                taps[cname] = h
            idx += 1
            if bn:
                h = L.batchnorm(h, params[bname])
                if bname in taps_wanted:
                    taps[bname] = h
                idx += 1
            nxt = _CFG[ci + 1] if ci + 1 < len(_CFG) else None
            if (
                block == 1  # the fused kernel serves pool1 (C = 64), as in JAX
                and nxt == "M"
                and rname not in taps_wanted
                and (stop_idx is None or idx + 1 <= stop_idx)
                and h.shape[2] % 2 == 0
                and h.shape[3] % 2 == 0
            ):
                fuse_next_pool = True  # relu applied inside the pool
            elif rname in stats_set:
                # the fused tap reads NHWC bytes; after the plain pools 2-3
                # the activations are NCHW-contiguous (amax's default layout)
                h, s1, s2 = L.relu_stats(h.contiguous(memory_format=torch.channels_last))
                if sharded:
                    slab_sums[rname] = (s1, s2, h.shape[2] * mesh.shape["model"] * h.shape[3])
                else:
                    taps[rname] = stats_from_sums(s1, s2, h.shape[2] * h.shape[3])
            else:
                h = torch.relu(h)
                if rname in taps_wanted:
                    taps[rname] = h
            idx += 1
            conv_in_block += 1

        if slab_sums:  # one reduction over the model group for every tap
            stats = stats_from_slab_sums([v[:2] for v in slab_sums.values()], [v[2] for v in slab_sums.values()],
                                         mesh.model_group)
            taps.update(zip(slab_sums, stats))
        final = h.float()
        return final, [taps[n] for n in content_layers], [taps[n] for n in style_layers]
