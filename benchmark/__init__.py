"""The benchmark of ``iris_style_transfer_tpu_torch`` on NVIDIA GPUs.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell: a configuration (``configs/``) under a traffic mix
(``traffic/``), driven through one of the port's entry points
(``entries/``), judged against the plain reference (``reference/``), with
each per-layer metric read by its own reader (``metrics/``) and the work
counted by ``work/``.  Nothing here imports JAX or the JAX package.
"""
