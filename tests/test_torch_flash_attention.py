"""Parity of the port's flash attention with the JAX package's Pallas
kernel.

The plain PyTorch version is held against the reference ``attention``
(Pallas in interpret mode, as ``tests/test_kernels.py`` runs it) with the
reference's own tolerances: float32 atol/rtol 2e-5, bfloat16 3e-2. So is
a plain emulation of the bfloat16 kernel's arithmetic (P rounded to
bfloat16 before P.V), which shows that the rounding the tensor-core
kernel adds fits the bfloat16 tolerance. The CUDA kernel is held against
the plain version on the card (marked ``cuda``: skips here).

The backward: the plain ``attention_bwd_ref`` (P rebuilt from the
forward's log-sum-exp, D = rowsum(dO o O)) is held against ``jax.vjp`` of
the reference ``attention`` (its custom VJP differentiates the XLA
``attention_ref``) and against ``torch.autograd`` of ``attention_ref`` in
float32 at 1e-5 of each gradient's largest magnitude (measured: below
1.1e-6). A plain emulation of the bfloat16 backward kernel's arithmetic
(P and dS rounded to bfloat16 before their products, bfloat16 outputs),
fed the bfloat16 forward's output (P rounded before P.V, O in bfloat16)
and bfloat16 dO, stays within 2e-2 of the largest magnitude of the
reference's bfloat16 gradients (measured: up to 6.9e-3): the rounding the
card's bfloat16 path adds fits that tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention as jax_attention
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import (BWD_COUNTER, COUNTER,
                                                 attention,
                                                 attention_bwd_flops,
                                                 attention_bwd_ref,
                                                 attention_flops,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd)

SHAPES = [  # B, S, T, Hq, Hkv, hd, causal (tests/test_kernels.py's five)
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 8, 128, True),
    (2, 96, 96, 4, 1, 64, False),       # padding + MQA
    (1, 300, 300, 2, 2, 32, True),      # non-multiple lengths
    (2, 64, 192, 4, 2, 64, False),      # cross-shaped T != S
]


def _qkv(B, S, T, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, hd), dtype=np.float32),
            rng.standard_normal((B, T, Hkv, hd), dtype=np.float32),
            rng.standard_normal((B, T, Hkv, hd), dtype=np.float32))


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal", SHAPES)
def test_plain_matches_reference_kernel(B, S, T, Hq, Hkv, hd, causal):
    q, k, v = _qkv(B, S, T, Hq, Hkv, hd, seed=S + T + hd)
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    block_q=64, block_k=64))
    got = attention(*(torch.from_numpy(x) for x in (q, k, v)),
                    causal=causal)
    assert got.shape == (B, S, Hq, hd)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_plain_dtypes_match_reference_kernel(dtype, tol):
    q, k, v = _qkv(1, 128, 128, 4, 2, 64, seed=11)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    want = jax_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                         jnp.asarray(v, jd), block_q=64, block_k=64)
    # the same rounded inputs on both sides
    got = attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("q_offset", [64, 128])
def test_q_offset_matches_reference_kernel(q_offset):
    # a query block placed after the keys it may see: the decode-chunk
    # case the kernel's q_offset exists for (kernel layout, as the
    # reference kernel takes it)
    q, k, v = _qkv(1, 64, 192, 4, 2, 32, seed=q_offset)
    to_k = lambda x: np.ascontiguousarray(np.moveaxis(x, 1, 2))
    want = np.asarray(jax_flash_attention(
        jnp.asarray(to_k(q)), jnp.asarray(to_k(k)), jnp.asarray(to_k(v)),
        causal=True, block_q=64, block_k=64, q_offset=q_offset,
        interpret=True))
    got = attention_ref(*(torch.from_numpy(to_k(x)) for x in (q, k, v)),
                        causal=True, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def _tensor_core_emulation(q, k, v, *, causal, q_offset=0, tile=128):
    """The bfloat16 kernel's arithmetic in plain torch, kernel layout q
    (B, Hq, S, hd), k/v (B, Hkv, T, hd): float32 scores, the online
    softmax over 128-key tiles in float32 with the finite -1e30 mask, P
    rounded to bfloat16 before P.V with float32 accumulation, the
    denominator summed from the unrounded P."""
    B, Hq, S, hd = q.shape
    _, Hkv, T, _ = k.shape
    qf = q.float().reshape(B, Hkv, Hq // Hkv, S, hd)
    m = torch.full((B, Hkv, Hq // Hkv, S), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    qpos = q_offset + torch.arange(S)
    for k0 in range(0, T, tile):
        kt, vt = k[:, :, k0:k0 + tile].float(), v[:, :, k0:k0 + tile].float()
        s = torch.einsum("bhgsd,bhtd->bhgst", qf, kt) / math.sqrt(hd)
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2])
            s = s.masked_fill(kpos[None, :] > qpos[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhgst,bhtd->bhgsd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    o = o / l.clamp_min(1e-30)[..., None]
    return o.reshape(B, Hq, S, hd).to(torch.bfloat16)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal", SHAPES)
def test_tensor_core_rounding_matches_reference_kernel(B, S, T, Hq, Hkv, hd,
                                                       causal):
    q, k, v = _qkv(B, S, T, Hq, Hkv, hd, seed=S + T + hd + 1)
    want = jax_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                         causal=causal, block_q=64, block_k=64)
    got = _tensor_core_emulation(*(_bf16(x).transpose(1, 2)
                                   for x in (q, k, v)),
                                 causal=causal).transpose(1, 2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.parametrize("q_offset", [64, 128])
def test_tensor_core_rounding_with_q_offset(q_offset):
    q, k, v = _qkv(1, 64, 192, 4, 2, 32, seed=q_offset + 1)
    to_k = lambda x: np.ascontiguousarray(np.moveaxis(x, 1, 2))
    want = jax_flash_attention(
        *(jnp.asarray(to_k(x), jnp.bfloat16) for x in (q, k, v)),
        causal=True, block_q=64, block_k=64, q_offset=q_offset,
        interpret=True)
    got = _tensor_core_emulation(*(_bf16(to_k(x)) for x in (q, k, v)),
                                 causal=True, q_offset=q_offset)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_kv_len_masks_padded_keys():
    q, k, v = _qkv(1, 64, 128, 2, 2, 32, seed=5)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    padded = attention_ref(tq, tk, tv, causal=False, kv_len=100)
    cut = attention_ref(tq, tk[:, :, :100], tv[:, :, :100], causal=False)
    np.testing.assert_allclose(padded.numpy(), cut.numpy(), atol=1e-6)


def test_flops_count_the_live_pairs():
    assert attention_flops(1, 1, 4, 4, 8, causal=False) == 4 * 8 * 16
    assert attention_flops(1, 1, 4, 4, 8, causal=True) == 4 * 8 * 10
    # prefill of qwen3-4b at 4096 tokens: ~137 GFLOP
    f = attention_flops(1, 32, 4096, 4096, 128, causal=True)
    assert 137e9 < f < 138e9


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x).transpose(1, 2)
               for x in _qkv(1, 64, 64, 2, 2, 32, seed=3))
    before = COUNTER.launches
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
    assert COUNTER.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false); the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_kernel_matches_plain_on_card(cuda, B, S, T, Hq, Hkv, hd, causal,
                                      dtype, tol):
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _qkv(B, S, T, Hq, Hkv, hd, seed=7))
    before = COUNTER.launches
    got = attention(q, k, v, causal=causal)
    assert COUNTER.launches == before + 1
    want = attention(q.cpu(), k.cpu(), v.cpu(), causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), atol=tol, rtol=tol)


# bfloat16 cases of the tensor-core kernel: B, S, T, Hq, Hkv, hd, causal,
# q_offset, kv_len (every head dim, a ragged S, MQA and Hq/Hkv = 4, a
# decode chunk, kv_len < T)
CARD_BF16 = [
    (1, 300, 300, 4, 1, 32, True, 0, 0),
    (2, 300, 300, 8, 8, 64, True, 0, 0),
    (1, 300, 300, 8, 2, 128, True, 0, 0),
    (1, 64, 576, 8, 2, 128, True, 512, 0),
    (2, 256, 512, 8, 1, 64, False, 0, 400),
    (1, 200, 333, 4, 4, 32, True, 133, 300),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,q_offset,kv_len", CARD_BF16)
def test_tensor_core_kernel_matches_plain_on_card(cuda, B, S, T, Hq, Hkv, hd,
                                                  causal, q_offset, kv_len):
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16).transpose(1, 2)
               for x in _qkv(B, S, T, Hq, Hkv, hd, seed=9))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = flash_attention(q, k, v, **kw)
    want = attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=3e-2,
                               rtol=3e-2)


@pytest.mark.cuda
def test_tensor_core_kernel_refuses_unaligned_strides(cuda):
    # TMA needs 16-byte aligned rows: a head dim sliced out of a wider
    # buffer at an odd offset is refused, never sent to a slower path
    q = torch.zeros(1, 2, 64, 40, device=cuda, dtype=torch.bfloat16)
    q = q[..., 4:36]
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


# ------------------------------------------------------------- backward

def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _do(B, S, Hq, hd, seed):
    return np.random.default_rng(seed).standard_normal((B, S, Hq, hd),
                                                       dtype=np.float32)


def _plain_bwd(q, k, v, do, **kw):
    """attention_bwd_ref on model-layout numpy inputs (float32 or the
    given torch dtype), with o and lse from attention_ref."""
    tq, tk, tv, tdo = (torch.from_numpy(x).transpose(1, 2)
                       for x in (q, k, v, do))
    o, lse = attention_ref(tq, tk, tv, return_lse=True, **kw)
    return [g.transpose(1, 2).numpy()
            for g in attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)]


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal", SHAPES)
def test_backward_plain_matches_reference_vjp(B, S, T, Hq, Hkv, hd, causal):
    q, k, v = _qkv(B, S, T, Hq, Hkv, hd, seed=S + hd + 3)
    do = _do(B, S, Hq, hd, seed=S + 4)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(
        a, b, c, causal=causal, block_q=64, block_k=64),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _plain_bwd(q, k, v, do, causal=causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= 1e-5, name


@pytest.mark.parametrize("q_offset", [64, 128])
def test_backward_q_offset_matches_reference_vjp(q_offset):
    q, k, v = _qkv(1, 64, 192, 4, 2, 32, seed=q_offset + 5)
    do = _do(1, 64, 4, 32, seed=q_offset + 6)
    to_k = lambda x: np.ascontiguousarray(np.moveaxis(x, 1, 2))
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(
        a, b, c, causal=True, q_offset=q_offset),
        *(jnp.asarray(to_k(x)) for x in (q, k, v)))
    want = vjp(jnp.asarray(to_k(do)))
    got = _plain_bwd(q, k, v, do, causal=True, q_offset=q_offset)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(to_k(g), w) <= 1e-5, name


# B, S, T, Hq, Hkv, hd, causal, q_offset, kv_len: GQA, MQA, Hq = Hkv,
# ragged S, q_offset and kv_len; then the bfloat16 kernels' tile edges, as
# chip_smoke.py's K3B_CASES has them: S between 64 and 128 with T no
# multiple of 128, S = 333 (log-sum-exp rows not 16-byte aligned),
# Hq / Hkv = 8, and hd 32 and 64 with kv_len ending mid-tile
BWD_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0, 0),
    (1, 100, 100, 4, 1, 32, True, 0, 0),
    (2, 96, 96, 4, 4, 128, False, 0, 0),
    (1, 64, 192, 4, 2, 32, True, 128, 0),
    (2, 64, 160, 4, 2, 64, False, 0, 130),
    (1, 70, 200, 2, 1, 64, True, 100, 180),
    (1, 100, 200, 8, 2, 128, False, 0, 0),
    (2, 333, 333, 8, 2, 128, True, 0, 0),
    (1, 384, 384, 16, 2, 128, True, 0, 0),
    (2, 200, 320, 4, 2, 32, True, 120, 250),
    (1, 190, 190, 4, 1, 64, False, 0, 170),
]


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,q_offset,kv_len",
                         BWD_CASES)
def test_backward_plain_matches_autograd(B, S, T, Hq, Hkv, hd, causal,
                                         q_offset, kv_len):
    q, k, v = _qkv(B, S, T, Hq, Hkv, hd, seed=S + T + 7)
    do = _do(B, S, Hq, hd, seed=S + 8)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    xs = [torch.from_numpy(x).transpose(1, 2).requires_grad_(True)
          for x in (q, k, v)]
    attention_ref(*xs, **kw).backward(torch.from_numpy(do).transpose(1, 2))
    got = _plain_bwd(q, k, v, do, **kw)
    for name, g, x in zip(("dq", "dk", "dv"), got, xs):
        assert _rel(g, x.grad.transpose(1, 2).numpy()) <= 1e-5, name


def test_model_layout_entry_point_differentiates_on_cpu():
    # attention() on CPU tensors is attention_ref under ordinary autograd
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, seed=21)
    do = _do(1, 64, 4, 32, seed=22)
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    attention(*xs, causal=True).backward(torch.from_numpy(do))
    for g, x in zip(_plain_bwd(q, k, v, do, causal=True), xs):
        assert _rel(g, x.grad.numpy()) <= 1e-5


def _tensor_core_bwd_emulation(q, k, v, o, lse, do, *, causal):
    """The bfloat16 backward kernel's arithmetic in plain torch (kernel
    layout): float32 scores and P = exp(s - lse), D from the bfloat16 O
    and dO, P and dS rounded to bfloat16 before the products that take
    them, float32 sums, bfloat16 outputs."""
    B, Hq, S, hd = q.shape
    _, Hkv, T, _ = k.shape
    G = Hq // Hkv
    r = lambda x: x.to(torch.bfloat16).float()
    qf = q.float().reshape(B, Hkv, G, S, hd)
    dof = do.float().reshape(B, Hkv, G, S, hd)
    s = torch.einsum("bhgsd,bhtd->bhgst", qf, k.float()) / math.sqrt(hd)
    p = torch.exp(s - lse.reshape(B, Hkv, G, S)[..., None])
    if causal:
        t = torch.arange(T)
        p = p.masked_fill(t[None, :] > torch.arange(S)[:, None], 0.0)
    d = (dof * o.float().reshape(B, Hkv, G, S, hd)).sum(-1)
    dp = torch.einsum("bhgsd,bhtd->bhgst", dof, v.float())
    ds = r(p * (dp - d[..., None]))
    dv = torch.einsum("bhgst,bhgsd->bhtd", r(p), dof)
    dq = torch.einsum("bhgst,bhtd->bhgsd", ds, k.float()) / math.sqrt(hd)
    dk = torch.einsum("bhgst,bhgsd->bhtd", ds, qf) / math.sqrt(hd)
    return tuple(x.to(torch.bfloat16)
                 for x in (dq.reshape(B, Hq, S, hd), dk, dv))


@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal", SHAPES)
def test_backward_after_tensor_core_rounding(B, S, T, Hq, Hkv, hd, causal):
    # the card's bfloat16 path: O from the forward that rounds P to
    # bfloat16, bfloat16 dO, P and dS rounded to bfloat16; held to the
    # reference's bfloat16 gradients
    q, k, v = _qkv(B, S, T, Hq, Hkv, hd, seed=S + T + 9)
    do = _do(B, S, Hq, hd, seed=S + 10)
    bq, bk, bv, bdo = (_bf16(x).transpose(1, 2) for x in (q, k, v, do))
    o = _tensor_core_emulation(bq, bk, bv, causal=causal)
    _, lse = attention_ref(bq, bk, bv, causal=causal, return_lse=True)
    got = _tensor_core_bwd_emulation(bq, bk, bv, o, lse, bdo, causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention(
        a, b, c, causal=causal, block_q=64, block_k=64),
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g.transpose(1, 2).float().numpy(), w) <= 2e-2, name


def test_lse_is_the_masked_logsumexp():
    q, k, v = _qkv(1, 50, 80, 2, 1, 32, seed=23)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    _, lse = attention_ref(tq, tk, tv, causal=True, q_offset=20, kv_len=60,
                           return_lse=True)
    s = torch.einsum("bhsd,bhtd->bhst", tq, tk.expand(1, 2, 80, 32))
    s = s / math.sqrt(32)
    t = torch.arange(80)
    live = (t[None, :] <= 20 + torch.arange(50)[:, None]) & (t < 60)
    want = torch.logsumexp(s.masked_fill(~live, float("-inf")), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-6)


def test_backward_flops_are_five_products():
    assert attention_bwd_flops(1, 1, 4, 4, 8, causal=False) == 10 * 8 * 16
    # qwen3-4b's training shape at 4,096 tokens: ~344 GFLOP
    f = attention_bwd_flops(1, 32, 4096, 4096, 128, causal=True)
    assert 343e9 < f < 345e9


def test_backward_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x).transpose(1, 2)
               for x in _qkv(1, 64, 64, 2, 2, 32, seed=3))
    o, lse = attention_ref(q, k, v, return_lse=True)
    before = BWD_COUNTER.launches
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse, o)
    assert BWD_COUNTER.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,T,Hq,Hkv,hd,causal,q_offset,kv_len",
                         BWD_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_backward_kernel_matches_plain_on_card(cuda, B, S, T, Hq, Hkv, hd,
                                               causal, q_offset, kv_len,
                                               dtype, tol):
    q, k, v = (torch.from_numpy(x).to(cuda, dtype).transpose(1, 2)
               for x in _qkv(B, S, T, Hq, Hkv, hd, seed=13))
    do = torch.from_numpy(_do(B, S, Hq, hd, seed=14)).to(
        cuda, dtype).transpose(1, 2)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    o, lse = flash_attention(q, k, v, lse=True, **kw)
    before = BWD_COUNTER.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert BWD_COUNTER.launches == before + 2
    # the plain backward from the plain forward: the forward's log-sum-exp
    # (within 2e-5 absolute, natural units) is part of what is compared
    o_ref, lse_ref = attention_ref(q, k, v, return_lse=True, **kw)
    assert float((lse - lse_ref).abs().max()) <= 2e-5
    want = attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)                   # bit-repeatable
        assert _rel(g.float().cpu().numpy(), w.float().cpu().numpy()) <= tol


@pytest.mark.cuda
def test_training_entry_point_runs_both_kernels_on_card(cuda):
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               .requires_grad_(True)
               for x in _qkv(1, 256, 256, 4, 2, 64, seed=15))
    fwd, bwd = COUNTER.launches, BWD_COUNTER.launches
    attention(q, k, v, causal=True).float().sum().backward()
    assert COUNTER.launches == fwd + 1 and BWD_COUNTER.launches == bwd + 1
    assert all(bool(torch.isfinite(x.grad).all()) for x in (q, k, v))
