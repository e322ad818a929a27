"""The synthetic-twin replication tools and the weight converter, run as ``python -m
iris_style_transfer_tpu_torch.tools.<name>``:

  * ``replicate_synthetic``      — recognition and privacy: RITnet trained
                                   on the twin, the classifier trainer, the
                                   2019 IST pipeline on the held-out split.
  * ``replicate_rotation``       — rotation and perspective robustness of
                                   the two heads the first tool trained.
  * ``replicate_synthetic_gaze`` — gaze preservation: the B7 U-Net trained
                                   on the twin, both gaze estimators, the
                                   2020 IST pipeline.
  * ``port_weights``             — a PyTorch checkpoint (torchvision, smp,
                                   the reference's heads) -> the npz both
                                   packages read.

Counterparts of the repository's ``tools/replicate_*.py`` and
``tools/port_weights.py``; the replication tools keep their
flags and summary keys, plus ``--device`` (default ``cuda``).  Each writes
its summary to stdout and, with ``--out``, to ``<out>.json``; run them
from a scratch directory, since they write ``saved/``.
"""
