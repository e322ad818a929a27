"""B7's depthwise conv + batchnorm + SiLU kernel against its bound,
counted from the cell's shapes."""

from benchmark.metrics._roofline import share


def read(run):
    return share(run, ("dw_conv_bn_silu_kernel",))
