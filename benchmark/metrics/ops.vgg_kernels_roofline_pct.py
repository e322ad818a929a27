"""The VGG path's hand-written kernels (ReLU + pool forward and backward,
conv1_1) against their bound, counted from the cell's shapes."""

from benchmark.metrics._roofline import share

NAMES = ("relu_pool_fwd_kernel", "relu_pool_bwd_kernel", "conv1_mma_kernel")


def read(run):
    return share(run, NAMES)
