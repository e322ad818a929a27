"""The work counts against hand arithmetic."""

import pytest

from benchmark.work import b7, conv1, relu_pool, vgg19


def test_vgg19_to_relu4_2_is_13_96_gmac():
    # (side, C_in, C_out) of conv1_1 .. conv4_2 at a 224x224 crop
    layers = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128), (56, 128, 256)] + \
        [(56, 256, 256)] * 3 + [(28, 256, 512), (28, 512, 512)]
    macs = sum(side * side * cout * cin * 9 for side, cin, cout in layers)
    assert macs / 1e9 == pytest.approx(13.96, abs=0.005)
    assert vgg19.nst_forward_flops(1) == 2 * macs


def test_closure_counts_forward_and_input_gradient():
    assert vgg19.nst_closure_flops(1) == pytest.approx(55.84e9, rel=1e-3)
    # conv1_1's forward and input gradient at (64, 3, 224, 224): 22.2 GFLOP
    assert 2 * 2 * 64 * 224 * 224 * 64 * 27 == pytest.approx(22.2e9, rel=1e-3)


def test_kernel_bounds():
    assert relu_pool.fwd_bound_s(64, 64, 224, 224) * 1e3 == pytest.approx(0.1534, abs=1e-4)
    assert relu_pool.bwd_bound_s(64, 64, 224, 224) * 1e3 == pytest.approx(0.3067, abs=1e-4)
    assert conv1.bound_s(64, 3, 64, 224, 224) * 1e3 == pytest.approx(0.1285, abs=1e-4)
    assert len(b7.depthwise_calls()) == 51
    assert b7.depthwise_bound_s(32) * 1e3 == pytest.approx(3.2384, abs=2e-3)
