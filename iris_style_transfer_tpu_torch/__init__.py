"""iris_style_transfer_tpu_torch — the PyTorch + CUDA port of
``iris_style_transfer_tpu`` for NVIDIA H100s: one card, or a rank per card
with ``torch.distributed``.

The JAX package stays the reference; each subpackage here mirrors the one
at the same path there:

  * ``ops``        — image ops, CLAHE, losses, Gram, metrics, the batched
                     eye landmarks, and the hand-written CUDA kernels
                     (``ops/csrc``) with their plain torch versions.
  * ``models``     — VGG19, RITnet, the EfficientNet-B7 U-Net, ResNet50,
                     the classifier heads and the gaze estimators over
                     explicit parameter dicts, plus the weight bridge from
                     the JAX package's npz/pytree format.
  * ``transfer``   — the NST loop and the sync-free compact L-BFGS.
  * ``pipelines``  — masked-iris extraction and recomposition.
  * ``data``       — the synthetic OpenEDS twin and IST dataset building.
  * ``runtime``    — config, JSONL metric logging, checkpoint restore,
                     step timing.
  * ``parallel``   — the ``(data, model)`` mesh of ranks: batch blocks,
                     parameter broadcast and tensor-parallel splits, the
                     collectives, and ``run_ranks`` to spawn a host's ranks.
  * ``utils``      — seeding, output directories, sweep markers.
  * ``workloads``  — ``ist_openeds2019`` (recognition privacy),
                     ``ist_openeds2020`` (gaze preservation) and the two
                     trainers, each data-parallel over ``parallel``.

No module imports JAX.
"""

__version__ = "0.1.0"
