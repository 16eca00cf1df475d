"""Parity of the port's burn chain with the JAX package's Pallas kernel.

The plain PyTorch version is held against the reference ``burn`` in
interpret mode with the reference's own tolerance (atol 1e-3), repeats
bit for bit, and counts the same flops. The CUDA kernel is held against
the plain version on the card (marked ``cuda``: skips here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sweep_burn import burn as jax_burn
from repro.kernels.sweep_burn import burn_flops as jax_burn_flops
from repro_torch.core.sweep import SweepReference
from repro_torch.kernels.sweep_burn import (COUNTER, LocalTorchSweepBackend,
                                            burn, burn_flops, burn_ref,
                                            measure_tflops, run_burn)


def _inputs(m, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k), dtype=np.float32),
            rng.standard_normal((k, k), dtype=np.float32))


@pytest.mark.parametrize("M,K,iters", [(128, 128, 16), (256, 256, 8)])
def test_plain_matches_reference_kernel(M, K, iters):
    a, b = _inputs(M, K, seed=M + iters)
    want = np.asarray(jax_burn(jnp.asarray(a), jnp.asarray(b), iters=iters,
                               iters_per_block=8))
    got = run_burn(torch.from_numpy(a), torch.from_numpy(b), iters=iters)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_plain_is_bit_repeatable():
    a, b = (torch.from_numpy(x) for x in _inputs(128, 128, seed=1))
    assert torch.equal(burn_ref(a, b, iters=16), burn_ref(a, b, iters=16))


@pytest.mark.parametrize("M,K,iters", [(512, 512, 64), (128, 256, 8)])
def test_flops_accounting_matches_reference(M, K, iters):
    assert burn_flops(M, K, iters) == jax_burn_flops(M, K, iters)


def test_kernel_wrapper_refuses_cpu_tensors():
    a, b = (torch.from_numpy(x) for x in _inputs(64, 64, seed=2))
    before = COUNTER.launches
    with pytest.raises(ValueError):
        burn(a, b, iters=2)
    assert COUNTER.launches == before


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: asking for it is legitimate here")
    with pytest.raises(RuntimeError):
        measure_tflops(m=64, k=64, iters=1, device="cuda")
    with pytest.raises(RuntimeError):
        LocalTorchSweepBackend(device="cuda")


def test_local_backend_on_cpu_probes_and_calibrates():
    ref = SweepReference(1.0, 1.0, 1.0)
    be = LocalTorchSweepBackend(reference=ref, device="cpu")
    assert be.reference() is ref
    assert be.device_count(0) == 1
    assert measure_tflops(m=64, k=64, iters=2, repeats=1,
                          device="cpu") > 0
    assert be.intra_bw_probe(0, 0, 1) > 0
    assert be.multi_node_probe([0, 1], 3).shape == (3,)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false); the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,iters", [(512, 512, 64), (128, 256, 8),
                                       (2048, 2048, 16)])
def test_kernel_matches_plain_on_card(cuda, M, K, iters):
    a, b = (torch.from_numpy(x).to(cuda) for x in _inputs(M, K, seed=3))
    before = COUNTER.launches
    o1 = burn(a, b, iters=iters)
    o2 = burn(a, b, iters=iters)
    assert COUNTER.launches == before + 2
    assert torch.equal(o1, o2)
    want = burn_ref(a, b, iters=iters)
    np.testing.assert_allclose(o1.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,mode", [(512, 512, "resident"),
                                      (2048, 2048, "streaming")])
def test_kernel_is_one_launch_on_card(cuda, M, K, mode):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.sweep_burn.sweep_burn import LAST
    a, b = (torch.from_numpy(x).to(cuda) for x in _inputs(M, K, seed=4))
    burn(a, b, iters=4)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        burn(a, b, iters=4)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "burn" in names[0], names
    assert LAST["mode"] == mode
