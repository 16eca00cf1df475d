"""Parity of the port's WKV6 recurrence with the JAX package's Pallas
kernel and token-by-token oracle.

The plain PyTorch versions are held against the reference ``wkv6``
(Pallas in interpret mode) and ``wkv6_naive`` on the shapes and with the
tolerances of ``tests/test_kernels.py``: atol 2e-3 / rtol 1e-3 against
the oracles, 1e-4 between chunk sizes, 1e-3 for a state carried across
two calls. The CUDA kernel is held against the plain version on the card
(marked ``cuda``: skips here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6 as jax_wkv6
from repro.kernels.wkv6 import wkv6_naive as jax_wkv6_naive
from repro_torch.kernels.wkv6 import (COUNTER, wkv6, wkv6_bytes,
                                      wkv6_chunked, wkv6_naive)
from repro_torch.models.rwkv6 import wkv_chunked

SHAPES = [(2, 128, 2, 64, 32), (1, 64, 4, 32, 64), (2, 96, 1, 16, 32),
          (1, 256, 2, 128, 64)]      # B, S, H, hd, chunk


def _inputs(B, S, H, hd, seed):
    """Model layout (B, S, H, hd), as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    r, k, v = mk(B, S, H, hd), mk(B, S, H, hd), mk(B, S, H, hd)
    logw = -np.exp(rng.standard_normal((B, S, H, hd)) * 0.5 - 2.0
                   ).astype(np.float32)
    u = mk(H, hd) * 0.3
    s0 = mk(B, H, hd, hd) * 0.1
    return r, k, v, logw, u, s0


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("B,S,H,hd,chunk", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(B, S, H, hd, chunk):
    xs = _inputs(B, S, H, hd, seed=S + hd)
    jy, js = jax_wkv6(*(jnp.asarray(x) for x in xs), chunk=chunk)
    y, s = wkv6(*_t(xs), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=2e-3,
                               rtol=1e-3)
    r, k, v, logw, u, s0 = xs
    to_k = lambda x: jnp.moveaxis(jnp.asarray(x), 1, 2)
    ny, ns = jax_wkv6_naive(to_k(r), to_k(k), to_k(v), to_k(logw),
                            jnp.asarray(u), jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jnp.moveaxis(ny, 1, 2)),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(ns), atol=2e-3,
                               rtol=1e-3)


def test_port_naive_matches_reference_naive():
    r, k, v, logw, u, s0 = _inputs(2, 48, 2, 16, seed=3)
    to_k = lambda x: np.ascontiguousarray(np.moveaxis(x, 1, 2))
    args = [to_k(x) for x in (r, k, v, logw)] + [u, s0]
    jy, js = jax_wkv6_naive(*(jnp.asarray(x) for x in args))
    y, s = wkv6_naive(*_t(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5,
                               rtol=1e-5)


def test_chunk_invariance():
    xs = _t(_inputs(1, 128, 2, 32, seed=4))
    y32, s32 = wkv6(*xs, chunk=32)
    y64, s64 = wkv6(*xs, chunk=64)
    np.testing.assert_allclose(y32.numpy(), y64.numpy(), atol=1e-4)
    np.testing.assert_allclose(s32.numpy(), s64.numpy(), atol=1e-4)


def test_state_carries_across_calls():
    """Processing 2*S tokens == two chained S-token calls."""
    r, k, v, logw, u, s0 = _t(_inputs(1, 128, 2, 32, seed=5))
    y_full, s_full = wkv6(r, k, v, logw, u, s0, chunk=32)
    h = 64
    _, s1 = wkv6(r[:, :h], k[:, :h], v[:, :h], logw[:, :h], u, s0, chunk=32)
    y2, s2 = wkv6(r[:, h:], k[:, h:], v[:, h:], logw[:, h:], u, s1,
                  chunk=32)
    np.testing.assert_allclose(y_full[:, h:].numpy(), y2.numpy(), atol=1e-3)
    np.testing.assert_allclose(s_full.numpy(), s2.numpy(), atol=1e-3)


@pytest.mark.parametrize("S", [64, 40])
def test_model_chunking_matches_reference_model(S):
    # the model's own chunk: 32 when S is a multiple of 32, else all of S
    from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked
    xs = _inputs(1, S, 2, 32, seed=S)
    jy, js = jax_wkv_chunked(*(jnp.asarray(x) for x in xs))
    y, s = wkv_chunked(*_t(xs))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=2e-5,
                               rtol=2e-5)


def test_plain_rejects_a_chunk_that_does_not_divide():
    with pytest.raises(ValueError):
        wkv6(*_t(_inputs(1, 48, 1, 16, seed=6)), chunk=32)


def test_bytes_of_the_main_shape():
    # rwkv6-7b prefill at 2048 tokens, bfloat16 r/k/v: ~117 MB of
    # sequence data and ~2 MB of state read and written
    assert 119e6 < wkv6_bytes(1, 64, 2048, 64, 2) < 120e6


def test_kernel_wrapper_refuses_cpu_tensors():
    xs = [x.transpose(1, 2) if x.dim() == 4 and i < 4 else x
          for i, x in enumerate(_t(_inputs(1, 32, 1, 16, seed=8)))]
    before = COUNTER.launches
    with pytest.raises(ValueError):
        wkv6_chunked(*xs, chunk=32)
    assert COUNTER.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false); the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,chunk", SHAPES + [(1, 64, 2, 64, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda, B, S, H, hd, chunk, dtype):
    r, k, v, logw, u, s0 = _t(_inputs(B, S, H, hd, seed=9))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    before = COUNTER.launches
    y, s = wkv6(*(x.to(cuda) for x in (r, k, v, logw, u, s0)), chunk=chunk)
    assert COUNTER.launches == before + 1
    wy, ws = wkv6(r, k, v, logw, u, s0, chunk=chunk)
    np.testing.assert_allclose(y.cpu().numpy(), wy.numpy(), atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(s.cpu().numpy(), ws.numpy(), atol=2e-3,
                               rtol=1e-3)
