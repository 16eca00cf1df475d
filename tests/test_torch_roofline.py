"""``repro_torch.launch.roofline`` against ``repro.launch.roofline``.

- ``model_flops_for`` equals the reference's for every (arch x shape)
  pair the dry run walks (32).
- ``Roofline.to_dict()`` equals the reference's on synthetic inputs once
  the reference module's three constants are patched to the port's
  (``monkeypatch``: nothing is edited), so the arithmetic is the same and
  only the constants differ.
- The port's constants are the H100's: bf16 dense tensor cores, HBM3, one
  NDR InfiniBand port a GPU.
"""
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.launch import roofline as jax_roofline
from repro_torch.configs import (applicable_shapes, get_config, get_shape,
                                 list_configs)
from repro_torch.launch import roofline

PAIRS = [(arch, shape) for arch in list_configs()
         for shape in applicable_shapes(get_config(arch))]


def test_the_walk_has_32_pairs():
    assert len(PAIRS) == 32


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_model_flops_for_matches_reference(arch, shape):
    got = roofline.model_flops_for(get_config(arch), get_shape(shape))
    want = jax_roofline.model_flops_for(jax_get_config(arch),
                                        jax_get_shape(shape))
    assert got == want and got > 0


CASES = [
    dict(arch="qwen3-4b", shape="train_4k", mesh="16x16", chips=256,
         hlo_flops=6.05e16, hlo_bytes=9.85e14, coll_bytes_per_chip=1.01e11,
         coll_breakdown={"all-gather": 6e10, "reduce-scatter": 4.1e10},
         model_flops=2.61e16, peak_mem_bytes=1.12e9,
         hlo_bytes_lower=1.1e14),
    dict(arch="rwkv6-7b", shape="decode_32k", mesh="2x16x16", chips=512,
         hlo_flops=3.1e12, hlo_bytes=7.7e12, coll_bytes_per_chip=2.2e6,
         coll_breakdown={"all-reduce": 2.2e6}, model_flops=1.9e12),
    dict(arch="whisper-small", shape="prefill_32k", mesh="16x16", chips=256,
         hlo_flops=0.0, hlo_bytes=0.0, coll_bytes_per_chip=0.0,
         coll_breakdown={}, model_flops=0.0, hlo_bytes_lower=0.0),
]


@pytest.mark.parametrize("case", CASES, ids=[c["arch"] for c in CASES])
def test_roofline_matches_reference_with_the_ports_constants(case,
                                                             monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jax_roofline, name, getattr(roofline, name))
    got = roofline.Roofline(**case)
    want = jax_roofline.Roofline(**case)
    assert got.to_dict() == want.to_dict()
    assert got.step_bound_s == want.step_bound_s


def test_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12      # bf16 dense tensor cores
    assert roofline.HBM_BW == 3.35e12         # HBM3
    assert roofline.LINK_BW == 400e9 / 8      # one 400 Gb/s NDR port
