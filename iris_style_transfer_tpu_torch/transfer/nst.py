"""Neural style transfer as one device-resident optimization loop.

Counterpart of ``iris_style_transfer_tpu/transfer/nst.py`` (reference
``pipelines.nst``): Gatys optimization in image space — init from the
content image or uniform noise, content/style targets from one VGG pass
each, then ``epochs`` closure evaluations of ``c_loss*alpha + s_loss*beta``,
each followed by one L-BFGS (or Adam) update, with x clamped to [0,1] at
the start of every closure.  The batch is optimized jointly (one summed
loss), as in the reference.

The JAX package runs the loop as one ``lax.scan``.  Here it is a Python
loop whose every step only enqueues device work: the loss histories are
preallocated device tensors written in place, and nothing is read back
until the loop ends.  Images are NCHW; the VGG forward turns them into
channels_last activations.

Three style losses, as in the JAX package: the BN statistics of the taps
(the default), the same on (mean, std) pairs that the fused relu+stats tap
computes inside the VGG forward (``stats_taps=True``, ``ops/relu_stats.py``),
and the Gram loss (``bn_loss=False``), whose Gram matrices, targets and
closure alike, go through ``ops/blockwise_gram.py``.  On a CUDA device
both of those are the hand-written kernels.

With a ``mesh`` (``parallel/mesh.py``) each rank holds its block of the
batch, and, with more than one model rank, its slab of each image's H rows
(JAX's ``spatial_sharding``: the VGG19 forward exchanges halo rows, and the
style statistics are reduced over the model group).  The joint problem
stays the single-device one: each rank's loss is its share of the global
loss, so the gradient on a rank's pixels is its block of the global
gradient.  The content loss is a mean over the whole batch and every
pixel, so a rank's mean is divided by its share count (the world size);
the style losses are sums over the batch of functions of whole-image
statistics, which the model ranks of one data block all compute, so they
add over the data group.  The L-BFGS reduces its inner products over every
rank that holds a piece of the image (the world group).  The loss
histories are reduced once, after the loop.

Under a profiler each closure's loss and gradient is a span ``nst.grad``
and each L-BFGS step one ``lbfgs.step`` (``runtime/profiler.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch

from ..models.vgg import VGG19
from ..ops.blockwise_gram import gram_matrix
from ..ops.losses import (
    content_loss_l2,
    style_loss_bn_stats,
    style_loss_gram,
    style_stats,
    style_stats_split,
)
from ..parallel.mesh import Mesh, all_reduce, gather_batch, gather_height, spatial_sharding, sum_over_group
from ..runtime.profiler import span
from .lbfgs import lbfgs_init, lbfgs_step

ADAM_B1, ADAM_B2 = 0.9, 0.999


class NSTResult(NamedTuple):
    x: torch.Tensor  # (B, 3, H, W) stylized images in [0,1]
    c_loss_hist: torch.Tensor  # (epochs,) content loss per closure
    s_loss_hist: torch.Tensor  # (epochs,) style loss per closure
    x_hist: torch.Tensor | None  # (epochs // history_every, B, 3, H, W) or None


def make_nst_fn(
    *,
    epochs: int = 200,
    clone_content: bool = True,
    bn_loss: bool = True,
    c_loss_weight: float = 1.0,
    s_loss_weight: float = 1.0,
    lr: float = 1.0,
    optimizer: str = "lbfgs",
    history_size: int = 10,
    lbfgs_dtype=torch.float32,
    history_every: int = 0,
    content_layers: Sequence[str] = ("relu4_2",),
    style_layers: Sequence[str] = ("relu1_1", "relu2_1", "relu3_1", "relu4_1"),
    compute_dtype=torch.float32,
    stats_taps: bool = False,
    mesh: Mesh | None = None,
):
    """Build ``fn(vgg_params, c_img, s_img, generator=None, gather=False)
    -> NSTResult``.  ``generator`` (a CPU ``torch.Generator``) draws the
    noise init when ``clone_content=False``; ``history_every=k`` keeps every
    k-th image.  ``stats_taps=True`` takes the fused relu+stats taps for the
    BN loss; it needs the BN loss and every style layer a relu that is not a
    content layer, and otherwise the classic path runs, as in the JAX
    package.  With ``mesh``, the images are this rank's block of the batch
    and of H (``spatial_sharding``), the histories come back as the one-rank
    histories, and ``gather=True`` returns ``x`` and ``x_hist`` whole."""
    if optimizer not in ("lbfgs", "adam"):
        raise ValueError(f"unknown optimizer: {optimizer}")
    use_stats = stats_taps and bn_loss and VGG19.stats_taps_eligible(style_layers, content_layers)
    n_model = mesh.shape["model"] if mesh is not None else 1
    vgg_apply = functools.partial(
        VGG19.apply,
        content_layers=tuple(content_layers),
        style_layers=tuple(style_layers),
        compute_dtype=compute_dtype,
        truncate=True,
        stats_taps=use_stats,
        mesh=mesh if n_model > 1 else None,
    )
    group = mesh.world_group if mesh is not None else None  # every rank holds a piece of x
    shares = mesh.world_size if mesh is not None else 1
    model_group = mesh.model_group if n_model > 1 else None

    def gram(f):
        """The whole image's Gram matrix: the slabs' add up, each over its
        own rows' share of the image."""
        return gram_matrix(f) if n_model == 1 else sum_over_group(gram_matrix(f).float(), model_group) / n_model

    def stats(feats):
        return [style_stats(f) for f in feats] if n_model == 1 else style_stats_split(feats, model_group, n_model)

    @torch.no_grad()
    def fn(vgg_params, c_img, s_img, generator: torch.Generator | None = None, gather: bool = False) -> NSTResult:
        params = VGG19.cast(vgg_params, compute_dtype)
        c_img = c_img.float()
        s_img = s_img.float()
        device = c_img.device

        _, c_targets, _ = vgg_apply(params, c_img)
        _, _, s_feats = vgg_apply(params, s_img)
        if use_stats:
            s_targets = s_feats  # already (mean, std) pairs
        else:
            s_targets = stats(s_feats) if bn_loss else [gram(f) for f in s_feats]

        def loss_fn(x):
            _, x_c, x_s = vgg_apply(params, x)
            c_loss = content_loss_l2(x_c, c_targets)
            if shares > 1:  # this block's share of the mean over the whole batch and image
                c_loss = c_loss / shares
            if use_stats:
                s_loss = style_loss_bn_stats(x_s, s_targets)
            elif bn_loss:
                s_loss = style_loss_bn_stats(stats(x_s), s_targets)
            else:
                s_loss = style_loss_gram(x_s, s_targets, gram_fn=gram)
            return c_loss * c_loss_weight + s_loss * s_loss_weight, c_loss, s_loss

        if clone_content:
            x = c_img.clone()
        else:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            if shares > 1:  # this rank's block of the whole batch's draw
                b, ch, h, w = c_img.shape
                shape = (b * mesh.batch_shards, ch, h * n_model, w)
                x = torch.rand(shape, generator=generator)[spatial_sharding(mesh, shape)].to(device)
            else:
                x = torch.rand(c_img.shape, generator=generator).to(device)

        shape = x.shape
        n_snaps = epochs // history_every if history_every else 0
        snaps = torch.zeros((n_snaps, *shape), device=device) if n_snaps else None
        c_hist = torch.zeros(epochs, device=device)
        s_hist = torch.zeros(epochs, device=device)
        if optimizer == "lbfgs":
            state = lbfgs_init(shape, history_size, dtype=lbfgs_dtype, device=device)
        else:
            m = torch.zeros(shape, device=device)
            v = torch.zeros(shape, device=device)

        for i in range(epochs):
            x = x.clamp(0.0, 1.0)  # the closure's clamp (pipelines.py:81-82)
            with span("nst.grad"), torch.enable_grad():
                x.requires_grad_(True)
                loss, c_loss, s_loss = loss_fn(x)
                (g,) = torch.autograd.grad(loss, x)
            x = x.detach()
            c_hist[i] = c_loss
            s_hist[i] = s_loss
            if optimizer == "lbfgs":
                with span("lbfgs.step"):
                    update, state = lbfgs_step(state, g, lr, group=group)
            else:
                t = i + 1.0
                m = ADAM_B1 * m + (1 - ADAM_B1) * g
                v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
                mhat = m / (1 - ADAM_B1**t)
                vhat = v / (1 - ADAM_B2**t)
                update = -lr * mhat / (torch.sqrt(vhat) + 1e-8)
            if n_snaps and i % history_every == 0 and i // history_every < n_snaps:
                snaps[i // history_every] = x
            x = x + update
        if group is not None:  # the content shares of every rank; the style losses of one model rank a block
            s_part = s_hist if mesh.model_index == 0 else torch.zeros_like(s_hist)
            c_hist, s_hist = all_reduce(torch.stack([c_hist, s_part]), group)
        x = x.clamp(0.0, 1.0)
        if gather and mesh is not None:
            x = gather_batch(mesh, gather_height(mesh, x))
            snaps = None if snaps is None else gather_batch(mesh, gather_height(mesh, snaps), dim=1)
        return NSTResult(x, c_hist, s_hist, snaps)

    return fn


def nst(
    c_img: torch.Tensor,
    s_img: torch.Tensor,
    vgg_params: dict,
    clone_content: bool = True,
    BN_loss: bool = True,
    c_loss_weight: float = 1.0,
    s_loss_weight: float = 1.0,
    lr: float = 1.0,
    epochs: int = 200,
    optimizer: str = "lbfgs",
    history_every: int = 0,
    history_size: int = 10,
    compute_dtype=torch.float32,
    generator: torch.Generator | None = None,
    mesh: Mesh | None = None,
) -> NSTResult:
    """Convenience wrapper with the reference's flag names
    (``pipelines.py:8-19``), built once per configuration.  Images are NCHW
    in [0,1]; ``generator`` takes the place of the JAX ``noise_key``, and
    ``scan_unroll`` has no counterpart in an eager loop.  With ``mesh``,
    the images are this rank's block of the batch (and of H, with more
    than one model rank)."""
    fn = _cached_nst_fn(
        epochs=epochs,
        clone_content=clone_content,
        bn_loss=BN_loss,
        c_loss_weight=float(c_loss_weight),
        s_loss_weight=float(s_loss_weight),
        lr=float(lr),
        optimizer=optimizer,
        history_every=history_every,
        history_size=history_size,
        compute_dtype=compute_dtype,
        mesh=mesh,
    )
    return fn(vgg_params, c_img, s_img, generator)


@functools.lru_cache(maxsize=32)
def _cached_nst_fn(**kwargs):
    """The one cache in front of :func:`make_nst_fn`, for :func:`nst` and
    :func:`cached_nst_program` alike."""
    return make_nst_fn(**kwargs)


def cached_nst_program(
    nst_epochs: int,
    c_w: float,
    s_w: float,
    compute_dtype_name: str,
    history_size: int = 10,
    stats_taps: str = "off",
    mesh: Mesh | None = None,
):
    """The production NST program shared by the IST workload mains: BN
    loss, content-clone init, compact L-BFGS with a bfloat16 history.
    ``stats_taps`` is ``--stats_taps``: "on" takes the fused relu+stats
    taps; "auto" is resolved to "off" before the cache, the JAX default.
    ``mesh`` is the main's (None: one device)."""
    if stats_taps not in ("auto", "on", "off"):
        raise ValueError(f"stats_taps must be auto, on or off, got {stats_taps!r}")
    return _cached_nst_fn(
        epochs=nst_epochs,
        c_loss_weight=float(c_w),
        s_loss_weight=float(s_w),
        compute_dtype=torch.bfloat16 if compute_dtype_name == "bfloat16" else torch.float32,
        history_size=history_size,
        lbfgs_dtype=torch.bfloat16,
        stats_taps=stats_taps == "on",
        mesh=mesh,
    )
