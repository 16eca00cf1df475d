"""Parity of the port's WKV6 recurrence and its backward with the JAX
package's Pallas kernel, token-by-token oracle and differentiated model
recurrence.

The plain PyTorch versions are held against the reference ``wkv6``
(Pallas in interpret mode) and ``wkv6_naive`` on the shapes and with the
tolerances of ``tests/test_kernels.py``: atol 2e-3 / rtol 1e-3 against
the oracles, 1e-4 between chunk sizes, 1e-3 for a state carried across
two calls. A plain emulation of the CUDA kernels' two-pass order (every
chunk-start state materialised first, then y formed chunk by chunk in
32-token query and key tiles) is held to the same oracles at chunk lengths
that are no multiple of 32, single chunks of the whole sequence among
them; the shape rule is pinned against the lengths the reference model
takes. The explicit backward ``wkv6_bwd_ref`` is held to ``jax.vjp`` of
the reference model's ``wkv_chunked`` and to autograd of ``wkv6_ref`` in
float32 within 1e-5 of each gradient's largest magnitude (measured: 2e-6
and 2e-7), at C = 32 and at one chunk of a length 32 does not divide,
with exponents driven past the +-25 clamp and a nonzero state gradient.
The backward kernel's products run on the tensor cores in TF32 with the
3xTF32 split; an emulation of TF32 rounding holds that split of a tile's
32 x 64 x 64 product to the float32 product (1e-5 of its max) and shows
that one TF32 pass does not hold the kernel's 1e-4. The CUDA kernels are
held against the plain versions on the card (marked ``cuda``: skips
here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6 as jax_wkv6
from repro.kernels.wkv6 import wkv6_naive as jax_wkv6_naive
from repro.models.rwkv6 import wkv_chunked as jax_wkv_chunked
from repro_torch.kernels.wkv6 import (BWD_COUNTER, COUNTER, scratch_bytes,
                                      supports, wkv6, wkv6_bwd_bytes,
                                      wkv6_bwd_flops, wkv6_bwd_ref,
                                      wkv6_bytes, wkv6_chunked,
                                      wkv6_chunked_bwd, wkv6_naive,
                                      wkv6_plain, wkv6_ref)
from repro_torch.models.rwkv6 import CHUNK, wkv_chunked

SHAPES = [(2, 128, 2, 64, 32), (1, 64, 4, 32, 64), (2, 96, 1, 16, 32),
          (1, 256, 2, 128, 64)]      # B, S, H, hd, chunk
# chunks the kernels walk in several 32-token tiles, or one ragged tile:
# single chunks of the whole sequence (the model's chunk for a prompt
# length that is no multiple of 32) and a chunk of 35 = 32 + 3
TILED = [(1, 48, 2, 16, 48), (2, 100, 1, 32, 100), (1, 7, 2, 64, 7),
         (1, 70, 1, 16, 35), (1, 96, 2, 32, 32), (1, 130, 1, 128, 130)]


def _inputs(B, S, H, hd, seed, decay=-2.0):
    """Model layout (B, S, H, hd), as tests/test_kernels.py draws them;
    ``decay`` the mean of log(-logw) (-2: about -0.14 a token; 0.5: about
    -1.9, so a chunk of 32 tokens drives clw far past the -25 clamp)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    r, k, v = mk(B, S, H, hd), mk(B, S, H, hd), mk(B, S, H, hd)
    logw = -np.exp(rng.standard_normal((B, S, H, hd)) * 0.5 + decay
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


# the backward: B, S, H, hd, decay, with a state gradient. The model's
# chunk: 32 for S = 64 and 96, one chunk of S for S = 40, 100 and 7.
BWD = [(2, 64, 2, 16, -2.0, True), (1, 40, 2, 32, -2.0, True),
       (1, 64, 2, 16, 0.5, True), (1, 100, 1, 32, 0.5, True),
       (1, 96, 1, 64, 0.5, False), (2, 7, 1, 16, -2.0, True)]


def _cotangents(B, S, H, hd, seed, with_ds):
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    ds = rng.standard_normal((B, H, hd, hd)).astype(np.float32) \
        if with_ds else np.zeros((B, H, hd, hd), np.float32)
    return dy, ds


def _bwd_close(got, want, what, tol=1e-5):
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                          want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, name)
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, f"{what} {name}: {err:.2e}"


@pytest.mark.parametrize("B,S,H,hd,decay,with_ds", BWD)
def test_bwd_ref_matches_jax_vjp_and_autograd(B, S, H, hd, decay, with_ds):
    xs = _inputs(B, S, H, hd, seed=S + hd, decay=decay)
    dy, ds = _cotangents(B, S, H, hd, seed=S, with_ds=with_ds)
    C = CHUNK if S % CHUNK == 0 else S
    if decay > 0:                        # the clamp really cuts
        clw = np.cumsum(xs[3][:, :min(C, 32)], axis=1)
        assert (clw < -25).mean() > 0.2
    _, vjp = jax.vjp(jax_wkv_chunked, *(jnp.asarray(x) for x in xs))
    jg = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    r, k, v, logw, u, s0 = _t(xs)
    kl = [t.transpose(1, 2) for t in (r, k, v, logw)]
    got = wkv6_bwd_ref(*kl, u, s0, torch.from_numpy(dy).transpose(1, 2),
                       torch.from_numpy(ds) if with_ds else None, chunk=C)
    got = [g.transpose(1, 2) if i < 4 else g for i, g in enumerate(got)]
    _bwd_close(got, [np.asarray(g) for g in jg], "vs jax.vjp")
    ts = [x.clone().requires_grad_(True) for x in _t(xs)]
    y, st = wkv6_ref(*(t.transpose(1, 2) for t in ts[:4]), ts[4], ts[5],
                     chunk=C)
    torch.autograd.backward([y, st], [torch.from_numpy(dy).transpose(1, 2),
                                      torch.from_numpy(ds)])
    _bwd_close(got, [t.grad for t in ts], "vs autograd")


def test_plain_function_differentiates_through_bwd_ref(monkeypatch):
    """On the CPU ``wkv6`` (and ``wkv6_plain``) with gradients on runs the
    autograd function whose backward is ``wkv6_bwd_ref``: one call each,
    the same gradients as autograd through ``wkv6_ref`` (1e-5)."""
    import repro_torch.kernels.wkv6.ops as ops
    calls = []

    def counted(*a, **kw):
        calls.append(kw["chunk"])
        return wkv6_bwd_ref(*a, **kw)

    monkeypatch.setattr(ops, "wkv6_bwd_ref", counted)
    xs = _inputs(1, 40, 2, 16, seed=11)
    dy, _ = _cotangents(1, 40, 2, 16, seed=12, with_ds=False)
    grads = []
    for fn in (wkv6, wkv6_plain, None):
        ts = [x.clone().requires_grad_(True) for x in _t(xs)]
        if fn is None:
            y, _ = wkv6_ref(*(t.transpose(1, 2) for t in ts[:4]), ts[4],
                            ts[5], chunk=40)
            y = y.transpose(1, 2)
        else:
            y, _ = fn(*ts, chunk=40)
        (y * torch.from_numpy(dy)).sum().backward()
        grads.append([t.grad for t in ts])
    assert calls == [40, 40]
    for got in grads[:2]:
        _bwd_close(got, grads[2], "function vs autograd")
    with torch.no_grad():
        y, _ = wkv6(*_t(xs), chunk=40)
    assert calls == [40, 40] and not y.requires_grad


def test_bwd_bound_of_the_training_shape():
    # rwkv6-7b training, one 4,096-token sequence in chunks of 32, bf16
    # r/k/v: ~11.8 GFLOP float32 and ~405 MB to move
    assert 11.7e9 < wkv6_bwd_flops(1, 64, 4096, 64, 32) < 11.8e9
    assert 404e6 < wkv6_bwd_bytes(1, 64, 4096, 64, 2) < 405e6


def _tf32(x: torch.Tensor, nearest: bool = True) -> torch.Tensor:
    """x as TF32 (its 13 low mantissa bits cleared): rounded to nearest,
    ties away from zero, as the kernel rounds its hi part (and
    ``cvt.rna.tf32.f32``), or truncated, as the tensor core reads a float32
    register (the kernel's lo part)."""
    bits = x.contiguous().view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_split_holds_a_tile_product(seed):
    """dq_ = dy S_{c-1}^T of one 32-token tile at hd 64, with dy ~ N(0, 1)
    and S the state K4 carries at phase 13(a)'s input scales: the kernel's
    3xTF32 split (hi = x to nearest TF32, lo = x - hi read truncated;
    lo.hi + hi.lo + hi.hi, each product exact) is within 1e-5 of the
    float32 product's max (measured: ~3e-7, float32's own rounding), one
    TF32 pass is not within 1e-4 (measured: 2.5-3e-4)."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.5):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    S, hd = 256, 64
    r, k, v = (mk(1, 1, S, hd) for _ in range(3))
    logw = -torch.exp(mk(1, 1, S, hd) - 2.0)
    _, state = wkv6_ref(r, k, v, logw, torch.zeros(1, hd),
                        torch.zeros(1, 1, hd, hd), chunk=32)
    dy, st = mk(32, hd, scale=1.0), state[0, 0].T.contiguous()
    want = dy @ st
    a_hi, b_hi = _tf32(dy), _tf32(st)
    a_lo, b_lo = _tf32(dy - a_hi, False), _tf32(st - b_hi, False)
    assert torch.equal(_tf32(a_hi), a_hi) and torch.equal(_tf32(b_lo), b_lo)
    d = torch.float64
    split = (a_lo.to(d) @ b_hi.to(d) + a_hi.to(d) @ b_lo.to(d)
             + a_hi.to(d) @ b_hi.to(d)).float()
    one = (a_hi.to(d) @ b_hi.to(d)).float()
    top = want.abs().max()
    assert float((split - want).abs().max() / top) <= 1e-5
    assert float((one - want).abs().max() / top) > 1e-4


def test_bwd_kernel_wrapper_refuses_cpu_tensors():
    r, k, v, logw, u, s0 = _t(_inputs(1, 32, 1, 16, seed=13))
    kl = [x.transpose(1, 2) for x in (r, k, v, logw)]
    starts = torch.zeros((1, 1, 1, 16, 16))
    before = BWD_COUNTER.launches
    with pytest.raises(ValueError):
        wkv6_chunked_bwd(*kl, u, starts, kl[0].float(), chunk=32)
    assert BWD_COUNTER.launches == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd,decay,with_ds",
                         BWD + [(1, 4096, 4, 64, -2.0, True),
                                (1, 1000, 1, 128, 0.5, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain_on_card(cuda, B, S, H, hd, decay, with_ds,
                                          dtype):
    xs = [x.to(cuda) for x in _t(_inputs(B, S, H, hd, seed=14,
                                          decay=decay))]
    dy, ds = (torch.from_numpy(x).to(cuda) for x in _cotangents(
        B, S, H, hd, seed=15, with_ds=with_ds))
    r, k, v = (x.to(dtype).transpose(1, 2) for x in xs[:3])
    logw, u, s0 = xs[3].transpose(1, 2), xs[4], xs[5]
    C = CHUNK if S % CHUNK == 0 else S
    _, _, starts = wkv6_chunked(r, k, v, logw, u, s0, chunk=C,
                                keep_states=True)
    dy = dy.transpose(1, 2)
    before = BWD_COUNTER.launches
    got = wkv6_chunked_bwd(r, k, v, logw, u, starts, dy, ds, chunk=C)
    again = wkv6_chunked_bwd(r, k, v, logw, u, starts, dy, ds, chunk=C)
    assert BWD_COUNTER.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = wkv6_bwd_ref(r, k, v, logw, u, s0, dy, ds, chunk=C)
    # float32 outputs differ by summation order and ex2 (1e-4); bfloat16
    # dr, dk, dv are each rounded once from float32 values a few roundings
    # apart: at most one bfloat16 step, 2^-8 of the element (8e-3)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                          want):
        tol = 8e-3 if g.dtype == torch.bfloat16 else 1e-4
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, f"kernel vs plain {name}: {err:.2e}"
