"""The plain reference: float32 PyTorch, TF32 off, no kernels of the port.

It imports nothing of ``iris_style_transfer_tpu_torch``.  Every matrix
product and convolution goes through a :class:`~.precision.Precision`, so
that the control (the same reference one precision lower) is this code
with another ``Precision``.
"""
