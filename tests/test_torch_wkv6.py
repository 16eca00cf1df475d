"""Parity of the port's WKV6 recurrence with the JAX package's Pallas
kernel and token-by-token oracle.

The plain PyTorch versions are held against the reference ``wkv6``
(Pallas in interpret mode) and ``wkv6_naive`` on the shapes and with the
tolerances of ``tests/test_kernels.py``: atol 2e-3 / rtol 1e-3 against
the oracles, 1e-4 between chunk sizes, 1e-3 for a state carried across
two calls. A plain emulation of the CUDA kernels' two-pass order (every
chunk-start state materialised first, then y formed chunk by chunk in
32-token query and key tiles) is held to the same oracles at chunk lengths
that are no multiple of 32, single chunks of the whole sequence among
them; the shape rule is pinned against the lengths the reference model
takes. The CUDA kernels are held against the plain version on the card
(marked ``cuda``: skips here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6 as jax_wkv6
from repro.kernels.wkv6 import wkv6_naive as jax_wkv6_naive
from repro_torch.kernels.wkv6 import (COUNTER, scratch_bytes, supports,
                                      wkv6, wkv6_bytes, wkv6_chunked,
                                      wkv6_naive, wkv6_ref)
from repro_torch.models.rwkv6 import CHUNK, wkv_chunked

SHAPES = [(2, 128, 2, 64, 32), (1, 64, 4, 32, 64), (2, 96, 1, 16, 32),
          (1, 256, 2, 128, 64)]      # B, S, H, hd, chunk
# chunks the kernels walk in several 32-token tiles, or one ragged tile:
# single chunks of the whole sequence (the model's chunk for a prompt
# length that is no multiple of 32) and a chunk of 35 = 32 + 3
TILED = [(1, 48, 2, 16, 48), (2, 100, 1, 32, 100), (1, 7, 2, 64, 7),
         (1, 70, 1, 16, 35), (1, 96, 2, 32, 32), (1, 130, 1, 128, 130)]


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


@pytest.mark.parametrize("S", [64, 40, 1, 7, 100])
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


def _two_pass(r, k, v, logw, u, s0, C, T=32):
    """The CUDA kernels' order in plain torch, kernel layout (B, H, S, hd).
    Pass 1 walks the chunks and keeps every chunk-start state; pass 2 forms
    each chunk's y from its own state alone, query tile by query tile,
    adding A v for the tile's own keys (strictly lower) and every earlier
    key tile of the chunk. The cumsum runs in T-token sub-tiles, each
    adding its predecessors' total (the carry)."""
    rf, kf, vf, lw = (t.float() for t in (r, k, v, logw))
    uf = u.float()[None, :, None, :]
    S = r.shape[2]

    def clip_exp(x):
        return torch.exp(x.clamp(-25.0, 25.0))

    def tiled_cumsum(w):
        parts, carry = [], torch.zeros_like(w[:, :, :1])
        for t0 in range(0, w.shape[2], T):
            part = carry + torch.cumsum(w[:, :, t0:t0 + T], dim=2)
            parts.append(part)
            carry = part[:, :, -1:]
        return torch.cat(parts, dim=2)

    starts, st = [], s0.float()
    for c0 in range(0, S, C):                      # pass 1: the states
        starts.append(st)
        clw = tiled_cumsum(lw[:, :, c0:c0 + C])
        total = clw[:, :, -1]
        kd = kf[:, :, c0:c0 + C] * clip_exp(total[:, :, None] - clw)
        st = (clip_exp(total)[..., None] * st
              + kd.transpose(-1, -2) @ vf[:, :, c0:c0 + C])
    ys = []
    for n, c0 in enumerate(range(0, S, C)):        # pass 2: y, chunk-parallel
        rr, kk, vv, w = (t[:, :, c0:c0 + C] for t in (rf, kf, vf, lw))
        clw = tiled_cumsum(w)
        q_, k_ = rr * clip_exp(clw - w), kk * clip_exp(-clw)
        diag = (rr * (uf * kk)).sum(-1, keepdim=True)
        for q0 in range(0, C, T):
            qs = slice(q0, min(q0 + T, C))
            y = diag[:, :, qs] * vv[:, :, qs] + q_[:, :, qs] @ starts[n]
            for k0 in range(0, q0 + 1, T):
                ks = slice(k0, min(k0 + T, C))
                A = q_[:, :, qs] @ k_[:, :, ks].transpose(-1, -2)
                if k0 == q0:
                    A = torch.tril(A, -1)
                y = y + A @ vv[:, :, ks]
            ys.append(y)
    return torch.cat(ys, dim=2), st


@pytest.mark.parametrize("B,S,H,hd,C", TILED)
def test_two_pass_order_matches_reference_kernel_and_plain(B, S, H, hd, C):
    xs = _inputs(B, S, H, hd, seed=S + C)
    jy, js = jax_wkv6(*(jnp.asarray(x) for x in xs), chunk=C)
    r, k, v, logw, u, s0 = _t(xs)
    kl = [t.transpose(1, 2) for t in (r, k, v, logw)]
    y, s = _two_pass(*kl, u, s0, C)
    wy, ws = wkv6_ref(*kl, u, s0, chunk=C)
    for want_y, want_s in ((np.asarray(jnp.moveaxis(jy, 1, 2)),
                            np.asarray(js)), (wy.numpy(), ws.numpy())):
        np.testing.assert_allclose(y.numpy(), want_y, atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(s.numpy(), want_s, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("S", [1, 7, 48, 100, 2048, 2049])
def test_shape_rule_takes_what_the_reference_model_takes(S):
    """The reference's wkv_chunked runs any prompt length with its chunk
    (32 when it divides S, else S); the kernels' shape rule accepts the
    same (S, C) at every head dim."""
    from repro.models.rwkv6 import CHUNK as REF_CHUNK
    from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked
    C = REF_CHUNK if S % REF_CHUNK == 0 else S
    assert CHUNK == REF_CHUNK
    jy, _ = jax_wkv_chunked(*(jnp.asarray(x) for x in _inputs(1, S, 1, 16,
                                                              seed=S)))
    assert np.isfinite(np.asarray(jy)).all()
    assert all(supports(S, hd, C) for hd in (16, 32, 64, 128))


def test_shape_rule_refusals():
    assert not supports(48, 64, 32)                # the chunk must divide S
    assert not supports(48, 48, 48)                # head dims 16/32/64/128
    assert not supports(48, 64, 0)
    assert not supports(0, 64, 1)


def test_scratch_of_the_main_shape():
    # rwkv6-7b prefill, 2,048 tokens in chunks of 32: 64 chunk-start states
    # of 64 x 64 float32 per head, 64 heads: 64 MiB
    assert scratch_bytes(1, 64, 2048, 64, 32) == 64 * 2 ** 20


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
@pytest.mark.parametrize("B,S,H,hd,chunk", SHAPES + [(1, 64, 2, 64, 16)]
                         + TILED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda, B, S, H, hd, chunk, dtype):
    r, k, v, logw, u, s0 = _t(_inputs(B, S, H, hd, seed=9))
    r, k, v = (x.to(dtype) for x in (r, k, v))
    before = COUNTER.launches
    args = [x.to(cuda) for x in (r, k, v, logw, u, s0)]
    y, s = wkv6(*args, chunk=chunk)
    assert COUNTER.launches == before + 1
    y2, s2 = wkv6(*args, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(s, s2)     # bit-repeatable
    wy, ws = wkv6(r, k, v, logw, u, s0, chunk=chunk)
    np.testing.assert_allclose(y.cpu().numpy(), wy.numpy(), atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(s.cpu().numpy(), ws.numpy(), atol=2e-3,
                               rtol=1e-3)


@pytest.mark.cuda
def test_kernel_refuses_unaligned_rows_on_card(cuda):
    r, k, v, logw, u, s0 = (x.to(cuda) for x in _t(_inputs(1, 32, 1, 16,
                                                            seed=10)))
    odd = torch.empty(r.numel() + 1, device=cuda)[1:].view(r.shape)
    odd.copy_(r)                                   # base 4 bytes off
    before = COUNTER.launches
    with pytest.raises(ValueError):
        wkv6_chunked(*(t.transpose(1, 2) for t in (odd, k, v, logw)), u, s0,
                     chunk=32)
    assert COUNTER.launches == before
