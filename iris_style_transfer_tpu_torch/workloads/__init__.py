"""Workload entry points (run as ``python -m iris_style_transfer_tpu_torch.workloads.<name>``)."""
