"""The frozen operation and byte counts against numbers worked by hand."""
import pytest

from bench import harness
from bench.kernels import k3, k3_bwd, k4, k4_bwd

BM = harness.load_benchmark()
PEAKS = harness.peaks()


def cell(name):
    c = harness.cell(BM, name)
    return harness.ref_config(c["config"]), c["traffic"]


def test_deepseek_step_flops():
    # active matrix parameters: 5 x 16.78 M attention, 67.24 M dense FFN,
    # 4 x (0.13 M router + 8 x 8.65 M experts), 209.72 M head = 638.1 M;
    # 6 x 638.1 M x 4,096 = 15.68 TFLOP, attention 5 x 6 x 4,096^2 x 2,048
    # = 1.03 TFLOP
    c, tf = cell("moe16b.train.4k")
    assert harness.flops_per_step({"family": "moe", "run": c}, tf) == \
        pytest.approx(16.715e12, rel=1e-3)


def test_rwkv6_step_flops():
    # 8 x 219.9 M a block + 268.4 M head = 2,027.8 M; x 6 x 4,096
    c, tf = cell("rwkv6.train.4k")
    assert harness.flops_per_step({"family": "ssm", "run": c}, tf) == \
        pytest.approx(49.84e12, rel=1e-3)


def test_accum8_is_eight_sequences():
    c, tf = cell("moe16b.train.accum8")
    one = harness.flops_per_step({"family": "moe", "run": c},
                                 dict(tf, global_batch=1))
    assert harness.flops_per_step({"family": "moe", "run": c}, tf) == \
        pytest.approx(8 * one)


def test_k3_bounds():
    # q (1, 16, 4096, 128) causal: 4 x 16 x 128 x 4096 x 4097 / 2 = 68.7
    # GFLOP at 989 TFLOP/s; the backward's five products 2.5 times that
    c, tf = cell("moe16b.train.4k")
    assert k3.shape(c, tf) == (1, 16, 16, 4096, 128)
    assert k3.bound_s(c, tf, PEAKS) * 1e3 == pytest.approx(0.0695, rel=1e-3)
    assert k3_bwd.bound_s(c, tf, PEAKS) * 1e3 == pytest.approx(0.1737,
                                                               rel=1e-3)
    c, tf = cell("moe16b.train.accum8")
    assert k3.shape(c, tf)[0] == 1              # a micro-batch a call


def test_k4_bounds():
    # 64 heads x 128 chunks x (4 x 32 x 64^2 + 2 x 32 x 31 x 64 + 10 x 32
    # x 64) = 5.50 GFLOP on the CUDA cores (67 TFLOP/s); the backward's
    # 405 MB at 3.35 TB/s
    c, tf = cell("rwkv6.train.4k")
    assert k4.bound_s(c, tf, PEAKS) * 1e3 == pytest.approx(0.0821, rel=1e-3)
    assert k4_bwd.nbytes(c, tf) == pytest.approx(404.8e6, rel=1e-3)
    assert k4_bwd.bound_s(c, tf, PEAKS) * 1e3 == pytest.approx(0.1208,
                                                               rel=1e-3)
