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
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch

from ..models.vgg import VGG19
from ..ops.gram import gram_matrix
from ..ops.losses import content_loss_l2, style_loss_bn, style_loss_gram, style_stats
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
):
    """Build ``fn(vgg_params, c_img, s_img, generator=None) -> NSTResult``.
    ``generator`` (a CPU ``torch.Generator``) draws the noise init when
    ``clone_content=False``; ``history_every=k`` keeps every k-th image."""
    if optimizer not in ("lbfgs", "adam"):
        raise ValueError(f"unknown optimizer: {optimizer}")
    vgg_apply = functools.partial(
        VGG19.apply,
        content_layers=tuple(content_layers),
        style_layers=tuple(style_layers),
        compute_dtype=compute_dtype,
        truncate=True,
    )

    @torch.no_grad()
    def fn(vgg_params, c_img, s_img, generator: torch.Generator | None = None) -> NSTResult:
        params = VGG19.cast(vgg_params, compute_dtype)
        c_img = c_img.float()
        s_img = s_img.float()
        device = c_img.device

        _, c_targets, _ = vgg_apply(params, c_img)
        _, _, s_feats = vgg_apply(params, s_img)
        s_targets = [style_stats(f) if bn_loss else gram_matrix(f) for f in s_feats]

        def loss_fn(x):
            _, x_c, x_s = vgg_apply(params, x)
            c_loss = content_loss_l2(x_c, c_targets)
            s_loss = style_loss_bn(x_s, s_targets) if bn_loss else style_loss_gram(x_s, s_targets)
            return c_loss * c_loss_weight + s_loss * s_loss_weight, c_loss, s_loss

        if clone_content:
            x = c_img.clone()
        else:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
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
            with torch.enable_grad():
                x.requires_grad_(True)
                loss, c_loss, s_loss = loss_fn(x)
                (g,) = torch.autograd.grad(loss, x)
            x = x.detach()
            c_hist[i] = c_loss
            s_hist[i] = s_loss
            if optimizer == "lbfgs":
                update, state = lbfgs_step(state, g, lr)
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
        return NSTResult(x.clamp(0.0, 1.0), c_hist, s_hist, snaps)

    return fn


@functools.lru_cache(maxsize=16)
def cached_nst_program(
    nst_epochs: int,
    c_w: float,
    s_w: float,
    compute_dtype_name: str,
    history_size: int = 10,
):
    """The production NST program shared by the IST workload mains: BN
    loss, content-clone init, compact L-BFGS with a bfloat16 history."""
    compute_dtype = torch.bfloat16 if compute_dtype_name == "bfloat16" else torch.float32
    return make_nst_fn(
        epochs=nst_epochs,
        c_loss_weight=c_w,
        s_loss_weight=s_w,
        compute_dtype=compute_dtype,
        history_size=history_size,
        lbfgs_dtype=torch.bfloat16,
    )
