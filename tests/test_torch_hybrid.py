"""Parity of the port's hybrid family (``repro_torch.models.rglru``, the
windowed ``local_attention``, the ring decode and the hybrid ``Model``)
with the JAX package's ``repro.models.rglru``, ``attention``,
``transformer`` and ``Model``.

Inputs come from numpy seeds and go through both packages; the model's
weights are the reference's, carried across with ``convert.model_params``.
The small config is recurrentgemma-9b's reduced to 5 layers (one (rec,
rec, attn) unit and a (rec, rec) tail), d 64, 4 query heads over 1 KV
head of 16, window 8, ``lru_width`` 64 and a vocabulary of 512. Limits
(``PERF.md`` §2): a function's float32 outputs within 1e-5, the model's
logits and caches within 1e-4 in float32 (elementwise, as
``tests/test_torch_models.py``), in bfloat16 within 5e-2 of each tensor's
largest magnitude (the two frameworks round at other places, XLA's
attention rounds its probabilities to bfloat16, and the flips grow layer
by layer through the five: measured up to 4.1e-2 at the tail layers, 0 at
the first layer's state), greedy token streams equal.

- ``rg_lru`` against the reference's associative scan, from a nonzero
  state, and ``h_last`` equal to float32 ``H[:, -1]``; a plain emulation
  of the RG-LRU kernel's order (the sequence in tiles of 128 steps, each
  tile's gates computed once, then walked from the state the tile before
  left) against the plain version, at the tile edges (the
  kernel itself runs on the CPU through the CUDA stand-in in
  ``tests/test_torch_rglru_shim.py``);
- the gates, one decode step, the conv with and without its state, the
  recurrent block over a sequence (with ``collect_state``) and its decode
  step;
- geglu, whose gelu is JAX's tanh approximation: the exact erf form,
  PyTorch's default, misses the limit on these inputs;
- ``local_attention`` at S = 5 (< W), 16 and 24, and the raise where the
  reference asserts (S > W, S % W != 0); the plain version's window mask
  with q_offset and kv_len against a direct masked softmax, and the FLOP
  count of the live pairs;
- the ring decode over 20 positions (two wraps of the window);
- the hybrid ``Model``: prefill (logits and every cache) then decode
  steps past the window, float32 and bfloat16; the ``BatchedServer``
  token for token; ``train_loss``, ``param_axes`` and ``zero3_units``
  run and give the reference's answers (the training checks are in
  ``tests/test_torch_hybrid_train.py``).

The RG-LRU kernel and the windowed flash-attention kernel are held to
their plain versions on the card (marked ``cuda``: skips here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import rglru as jax_rglru
from repro.models import transformer as jax_tfm
from repro.models.common import Policy as JaxPolicy
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params
from repro_torch.kernels.flash_attention import (attention_flops,
                                                 attention_ref,
                                                 flash_attention)
from repro_torch.kernels.rglru import (decay_and_input, rglru_ref,
                                       rglru_scan)
from repro_torch.launch import serve
from repro_torch.models import attention, rglru, transformer
from repro_torch.models.common import Init, Policy
from repro_torch.models.layers import MLP

ARCH = "recurrentgemma-9b"
SMALL = dict(num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
             head_dim=16, window=8, lru_width=64, d_ff=128, vocab_size=512)
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
FN_TOL = 1e-5


def _cfgs():
    return (jax_reduced(jax_get_config(ARCH), **SMALL),
            reduced(get_config(ARCH), **SMALL))


def _pair(dtype):
    jcfg, cfg = _cfgs()
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=getattr(jnp, dtype)))
    params, _ = jm.init_params(jax.random.key(0))
    model = model_params(jax.tree.map(np.asarray, params), cfg,
                         policy=Policy(compute_dtype=getattr(torch, dtype)),
                         device="cpu")
    return jm, params, model


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol=FN_TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else _np(got)
    np.testing.assert_allclose(got, _np(want), atol=tol, rtol=tol,
                               err_msg=what)


def _model_close(got, want, dtype, what):
    """The model's limit: float32 elementwise, bfloat16 of the largest
    magnitude."""
    if dtype == "float32":
        _close(got, want, TOL[dtype], what)
        return
    g, w = got.float().numpy(), _np(want)
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= TOL[dtype], f"{what}: {err:.3e} of the largest magnitude"


def _randn(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _rec_params(seed):
    """A recurrent block's parameters with gates far from their init, so
    that the decay and the input gate both vary."""
    _, cfg = _cfgs()
    rng = np.random.default_rng(seed)
    d, w, K = cfg.d_model, cfg.lru_width, cfg.conv_width
    return {"wx": _randn(rng, d, w, scale=d ** -0.5),
            "wg": _randn(rng, d, w, scale=d ** -0.5),
            "conv": _randn(rng, K, w, scale=K ** -0.5),
            "conv_b": _randn(rng, w, scale=0.1),
            "wa": _randn(rng, w, scale=0.5), "wi": _randn(rng, w, scale=0.5),
            "lam": _randn(rng, w, shift=0.65),
            "wo": _randn(rng, w, d, scale=w ** -0.5)}


def _rec_block(p, dtype=torch.float32):
    _, cfg = _cfgs()
    block = rglru.RecBlock(Init(Policy(compute_dtype=dtype), "cpu",
                                seed=None), cfg)
    for key, val in p.items():
        getattr(block, key).data.copy_(torch.from_numpy(val))
    return block


def _jax_rec(p, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in p.items()}


# ------------------------------------------------------------- the RG-LRU


@pytest.mark.parametrize("B,S", [(2, 13), (1, 1), (3, 40)])
def test_rg_lru_matches_reference_scan(B, S):
    p = _rec_params(1)
    rng = np.random.default_rng(S)
    xb, h0 = _randn(rng, B, S, 64), _randn(rng, B, 64)
    want, want_last = jax_rglru.rg_lru(_jax_rec(p), jnp.asarray(xb),
                                       jnp.asarray(h0))
    got, last = rglru.rg_lru(_rec_block(p), torch.from_numpy(xb),
                             torch.from_numpy(h0))
    _close(got, want, what="H")
    _close(last, want_last, what="h_last")
    assert last.dtype == torch.float32
    assert torch.equal(last, got[:, -1].float())


def _tiled_like_the_kernel(xb, wa, wi, lam, h0, tile=128):
    """The RG-LRU kernel's decomposition in plain float32: the sequence in
    tiles of ``tile`` steps (a slot of its ring), each tile's gates
    computed from its own slice of xb, then walked from the state the tile
    before left. This holds the decomposition (gates per slice, the state
    carried across tile edges), not the kernel: the kernel's own source
    runs on the CPU in ``tests/test_torch_rglru_shim.py``."""
    S = xb.shape[1]
    h = h0.clone()
    out = torch.empty(xb.shape, dtype=torch.float32)
    for t0 in range(0, S, tile):
        a, bx = decay_and_input(xb[:, t0:t0 + tile], wa, wi, lam)
        for u in range(a.shape[1]):
            h = a[:, u] * h + bx[:, u]
            out[:, t0 + u] = h
    return out


@pytest.mark.parametrize("S", [1, 31, 33, 100, 127, 128, 129, 257, 383,
                               385])
def test_kernel_chunk_order_matches_plain(S):
    # the tile edges 128 k - 1, 128 k, 128 k + 1; 385 is one step past the
    # ring's three slots
    p = _rec_params(2)
    rng = np.random.default_rng(10 + S)
    xb = torch.from_numpy(_randn(rng, 2, S, 64))
    h0 = torch.from_numpy(_randn(rng, 2, 64))
    args = [torch.from_numpy(p[k]) for k in ("wa", "wi", "lam")]
    want, _ = rglru_ref(xb, *args, h0)
    _close(_tiled_like_the_kernel(xb, *args, h0), want.numpy())


def test_gates_and_step_match_reference():
    p = _rec_params(3)
    rng = np.random.default_rng(3)
    x, h0 = _randn(rng, 4, 64, scale=2.0), _randn(rng, 4, 64)
    block, jp = _rec_block(p), _jax_rec(p)
    log_a, gate_i = rglru._gates(block, torch.from_numpy(x))
    jlog_a, jgate_i = jax_rglru._gates(jp, jnp.asarray(x))
    _close(log_a, jlog_a, what="log_a")
    _close(gate_i, jgate_i, what="gate_i")
    y, h = rglru.rg_lru_step(block, torch.from_numpy(x),
                             torch.from_numpy(h0))
    jy, jh = jax_rglru.rg_lru_step(jp, jnp.asarray(x), jnp.asarray(h0))
    _close(y, jy, what="y")
    _close(h, jh, what="h")


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches_reference(with_state):
    p = _rec_params(4)
    rng = np.random.default_rng(4)
    x = _randn(rng, 2, 7, 64)
    state = _randn(rng, 2, 3, 64) if with_state else None
    got = rglru._conv1d(torch.from_numpy(x), torch.from_numpy(p["conv"]),
                        torch.from_numpy(p["conv_b"]),
                        None if state is None else torch.from_numpy(state))
    want = jax_rglru._conv1d(jnp.asarray(x), jnp.asarray(p["conv"]),
                             jnp.asarray(p["conv_b"]),
                             None if state is None else jnp.asarray(state))
    if with_state:
        _close(got[0], want[0], what="y")
        _close(got[1], want[1], what="state")
        assert got[1].dtype == torch.float32
    else:
        _close(got, want)


@pytest.mark.parametrize("S", [3, 9])
def test_rec_block_and_step_match_reference(S):
    p = _rec_params(5)
    _, cfg = _cfgs()
    jcfg = _cfgs()[0]
    rng = np.random.default_rng(5 + S)
    x, h0 = _randn(rng, 2, S, 64), _randn(rng, 2, 64)
    block, jp = _rec_block(p), _jax_rec(p)
    out, h_last, conv = rglru.rec_block(block, cfg, torch.from_numpy(x),
                                        torch.from_numpy(h0),
                                        collect_state=True)
    jout, jh_last, jconv = jax_rglru.rec_block(
        jp, jcfg, jnp.asarray(x), jnp.asarray(h0), collect_state=True)
    _close(out, jout, what="out")
    _close(h_last, jh_last, what="h_last")
    _close(conv, jconv, what="conv state")
    # a decode step from the sequence's state
    xs = _randn(rng, 2, 64)
    state = {"h": h_last, "conv": conv}
    out, new = rglru.rec_block_step(block, cfg, torch.from_numpy(xs), state)
    jout, jnew = jax_rglru.rec_block_step(
        jp, jcfg, jnp.asarray(xs), {"h": jh_last, "conv": jconv})
    _close(out, jout, what="step out")
    for name in ("h", "conv"):
        _close(new[name], jnew[name], what=f"step {name}")


def test_geglu_matches_reference_tanh_gelu():
    rng = np.random.default_rng(6)
    d, f = 64, 128
    p = {"wg": _randn(rng, d, f, scale=0.5), "wu": _randn(rng, d, f),
         "wo": _randn(rng, f, d, scale=f ** -0.5)}
    x = _randn(rng, 2, 5, d)
    mlp = MLP(Init(Policy(compute_dtype=torch.float32), "cpu", seed=None),
              d, f, "geglu")
    for key, val in p.items():
        getattr(mlp, key).data.copy_(torch.from_numpy(val))
    want = jax_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), "geglu")
    got = mlp(torch.from_numpy(x))
    _close(got, want)
    # the trap: PyTorch's default gelu (exact erf) misses the limit
    xt = torch.from_numpy(x)
    exact = (torch.nn.functional.gelu(xt @ mlp.wg) * (xt @ mlp.wu)) @ mlp.wo
    assert np.abs(exact.numpy() - _np(want)).max() > 10 * FN_TOL


# ---------------------------------------------------- windowed attention


@pytest.mark.parametrize("S", [5, 16, 24])
def test_local_attention_matches_reference(S):
    rng = np.random.default_rng(20 + S)
    q = _randn(rng, 2, S, 4, 16)
    k, v = _randn(rng, 2, S, 1, 16), _randn(rng, 2, S, 1, 16)
    want = jax_attention.local_attention(*map(jnp.asarray, (q, k, v)),
                                         window=8)
    got = attention.local_attention(*map(torch.from_numpy, (q, k, v)),
                                    window=8)
    _close(got, want)


def test_local_attention_raises_where_reference_asserts():
    rng = np.random.default_rng(7)
    q = _randn(rng, 1, 12, 4, 16)
    k = v = _randn(rng, 1, 12, 1, 16)
    with pytest.raises(AssertionError):
        jax_attention.local_attention(*map(jnp.asarray, (q, k, v)),
                                      window=8)
    with pytest.raises(ValueError, match="multiple of"):
        attention.local_attention(*map(torch.from_numpy, (q, k, v)),
                                  window=8)


@pytest.mark.parametrize("S,T,q_offset,kv_len,window",
                         [(24, 24, 0, 0, 8), (10, 30, 20, 0, 5),
                          (12, 40, 25, 33, 6), (16, 16, 0, 0, 1)])
def test_windowed_plain_attention_is_the_masked_softmax(S, T, q_offset,
                                                        kv_len, window):
    rng = np.random.default_rng(S + T + window)
    q, k, v = (_randn(rng, 1, h, n, 16) for h, n in ((4, S), (2, T), (2, T)))
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True,
                        q_offset=q_offset, kv_len=kv_len, window=window)
    qpos = q_offset + np.arange(S)[:, None]
    kpos = np.arange(T)[None, :]
    live = (kpos <= qpos) & (kpos > qpos - window) & (kpos < (kv_len or T))
    kg = np.repeat(k, 2, axis=1)
    vg = np.repeat(v, 2, axis=1)
    s = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64), kg) / 4.0
    s = np.where(live, s, -np.inf)
    prob = np.exp(s - s.max(-1, keepdims=True))
    prob /= prob.sum(-1, keepdims=True)
    _close(got, np.einsum("bhst,bhtd->bhsd", prob, vg))
    assert attention_flops(1, 4, S, kv_len or T, 16, causal=True,
                           q_offset=q_offset, window=window) == \
        4.0 * 4 * 16 * live.sum()


def test_ring_decode_matches_reference_across_a_wrap():
    rng = np.random.default_rng(8)
    W, B, Hq, Hkv, hd = 8, 2, 4, 1, 16
    kc = np.zeros((B, Hkv, W, hd), np.float32)
    vc = kc.copy()
    jkc, jvc = jnp.asarray(kc), jnp.asarray(vc)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    for pos in range(2 * W + 4):
        q = _randn(rng, B, Hq, hd)
        kn, vn = _randn(rng, B, Hkv, hd), _randn(rng, B, Hkv, hd)
        want, jkc, jvc = jax_tfm._ring_decode(
            jnp.asarray(q), jkc, jvc, jnp.asarray(kn), jnp.asarray(vn),
            jnp.int32(pos), W)
        got = transformer._ring_decode(torch.from_numpy(q), tkc, tvc,
                                       torch.from_numpy(kn),
                                       torch.from_numpy(vn), pos)
        _close(got, want, what=f"position {pos}")
        _close(tkc, jkc, what=f"k ring at {pos}")
        _close(tvc, jvc, what=f"v ring at {pos}")


# ------------------------------------------------------------- the model


def _caches(cache):
    """Every tensor of a hybrid cache by name."""
    out = {}
    for key, c in cache["units"].items():
        items = zip("kv", c) if isinstance(c, tuple) else c.items()
        out.update({f"units.{key}.{n}": t for n, t in items})
    for i, c in enumerate(cache["tail"]):
        items = zip("kv", c) if isinstance(c, tuple) else c.items()
        out.update({f"tail.{i}.{n}": t for n, t in items})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,steps", [(16, 3), (5, 6), (24, 3)])
def test_prefill_then_decode_matches_reference(dtype, S, steps):
    jm, params, model = _pair(dtype)
    rng = np.random.default_rng(30 + S)
    tokens = rng.integers(0, 512, (2, S)).astype(np.int32)
    jlogits, jcache = jax.jit(jm.prefill)(params,
                                          {"tokens": jnp.asarray(tokens)})
    logits, cache = model.prefill(torch.from_numpy(tokens))
    assert cache["pos"] == S and int(jcache["pos"]) == S
    assert logits.shape == (2, model.vocab_padded)
    _model_close(logits, jlogits, dtype, "prefill logits")
    got, want = _caches(cache), _caches(jcache)
    assert sorted(got) == sorted(want) and len(got) == 10
    for name, t in got.items():
        assert t.shape == want[name].shape, name
        _model_close(t, want[name], dtype, name)
    step = jax.jit(jm.decode_step)
    for i in range(steps):                  # past the window: ring wraps
        tok = rng.integers(0, 512, (2,)).astype(np.int32)
        jlogits, jcache = step(params, jnp.asarray(tok), jcache)
        logits, cache = model.decode_step(torch.from_numpy(tok), cache)
        _model_close(logits, jlogits, dtype, f"decode step {i}")
    assert cache["pos"] == S + steps
    got, want = _caches(cache), _caches(jcache)
    for name, t in got.items():
        _model_close(t, want[name], dtype, f"{name} after decode")


def test_init_cache_matches_reference_layout():
    jm, _, model = _pair("float32")
    want = _caches(jm.init_cache(3, 100))
    got = _caches(model.init_cache(3, 100))
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        {n: tuple(t.shape) for n, t in want.items()}
    assert all(str(t.dtype).split(".")[-1] == str(want[n].dtype)
               for n, t in got.items())


def test_server_matches_reference_token_for_token():
    jm, params, model = _pair("float32")
    jqueue = jax_serve.synthetic_requests(12, jm.cfg.vocab_size, 0)
    jreqs = list(jqueue)
    jout = jax_serve.BatchedServer(jm, params, 4, 256).run(jqueue)
    queue = serve.synthetic_requests(12, model.cfg.vocab_size, 0)
    reqs = list(queue)
    out = serve.BatchedServer(model, 4, 256).run(queue)
    assert out["decode_steps"] == jout["decode_steps"]
    assert out["requests_done"] == jout["requests_done"] == 12
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_serve_main_runs_the_reduced_hybrid_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--requests", "3", "--slots", "2",
                       "--cache-len", "128", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}" in out and "3 done" in out


def test_convert_fills_every_parameter_from_the_reference_tree():
    _, params, model = _pair("float32")
    leaves = jax.tree.leaves(params)
    n_units = SMALL["num_layers"] // 3
    stacked = sum(np.asarray(x).size for x in
                  jax.tree.leaves(params["units"]))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(np.asarray(x).size for x in leaves)
    assert sum(p.numel() for p in model.units.parameters()) == stacked
    assert len(model.units) == n_units and len(model.tail) == 2


@pytest.mark.parametrize("entry", ["train_loss", "param_axes",
                                   "zero3_units"])
def test_training_entry_points_match_reference_for_the_hybrid_family(
        entry):
    """Each training entry point of the hybrid family runs and gives the
    reference's answer: the loss (float32 1e-5), the axes of a unit's and
    of the tail's parameters (the reference's without its stacked axis),
    the ZeRO-3 units over every parameter. The full checks are in
    ``tests/test_torch_hybrid_train.py``."""
    jm, params, model = _pair("float32")
    if entry == "train_loss":
        rng = np.random.default_rng(5)
        batch = {"tokens": rng.integers(0, 512, (1, 16), dtype=np.int32),
                 "labels": rng.integers(0, 512, (1, 16), dtype=np.int32)}
        want, _ = jm.train_loss(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        loss, metrics = model.train_loss(batch)
        assert float(loss) == pytest.approx(float(want), rel=1e-5)
        assert float(metrics["aux"]) == 0.0
    elif entry == "param_axes":
        axes, want = model.param_axes(), jm.param_axes()
        assert tuple(axes["units.0.l0_rec.rec.wx"]) == tuple(
            want["units"]["l0_rec"]["rec"]["wx"])[1:]
        assert tuple(axes["tail.1.rec.lam"]) == tuple(
            want["tail"][1]["rec"]["lam"])
    else:
        units = model.zero3_units()
        assert list(units) == ["in", "units.0", "tail", "out"]
        assert sorted(sum(units.values(), [])) == sorted(
            n for n, _ in model.named_parameters())


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    w, h0 = torch.zeros(8), torch.zeros(1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan(x, w, w, w, h0)
    q = torch.zeros(1, 2, 16, 256)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q[:, :1], q[:, :1], window=8)


# -------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W,dtype", [(1, 4096, 4096, "bfloat16"),
                                         (2, 1000, 300, "float32"),
                                         (3, 37, 33, "float32"),
                                         (2, 20, 64, "bfloat16")])
def test_rglru_kernel_matches_plain_on_card(cuda, B, S, W, dtype):
    rng = np.random.default_rng(S)
    xb = torch.from_numpy(_randn(rng, B, S, W)).to(cuda, getattr(torch,
                                                                 dtype))
    wa, wi = (torch.from_numpy(_randn(rng, W, scale=0.5)).to(cuda)
              for _ in range(2))
    lam = torch.from_numpy(_randn(rng, W, shift=0.65)).to(cuda)
    h0 = torch.from_numpy(_randn(rng, B, W)).to(cuda)
    got, last = rglru_scan(xb, wa, wi, lam, h0)
    again, last2 = rglru_scan(xb, wa, wi, lam, h0)
    want, want_last = rglru_ref(xb.float(), wa, wi, lam, h0)
    assert torch.equal(got, again) and torch.equal(last, last2)
    scale = float(want_last.abs().max())
    assert float((last - want_last).abs().max()) <= FN_TOL * scale
    tol = FN_TOL if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=tol,
                               atol=FN_TOL * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("S,hd,window,dtype,tol",
                         [(4096, 256, 2048, "bfloat16", 3e-2),
                          (600, 256, 256, "float32", 2e-5),
                          (700, 64, 128, "bfloat16", 3e-2)])
def test_windowed_flash_attention_matches_plain_on_card(cuda, S, hd, window,
                                                        dtype, tol):
    rng = np.random.default_rng(hd)
    q, k, v = (torch.from_numpy(_randn(rng, 1, S, h, hd)).to(
        cuda, getattr(torch, dtype)).transpose(1, 2) for h in (16, 1, 1))
    got = flash_attention(q, k, v, causal=True, window=window)
    want = attention_ref(q, k, v, causal=True, window=window)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max())

