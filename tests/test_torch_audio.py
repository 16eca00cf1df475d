"""Parity of the port's audio family (whisper: the gelu MLP, the encoder
layer, the decoder layer with cross attention, ``_plain_decode_attn``, the
encoder-decoder ``Model``, its server) with the JAX package's
``repro.models.layers``, ``transformer`` and ``Model``.

Inputs come from numpy seeds and go through both packages; the model's
weights are the reference's, carried across with ``convert.model_params``.
The config is whisper-small reduced as the JAX package reduces it: 2
encoder and 2 decoder layers, d 128, 4 query heads over 2 KV heads (G = 2)
of 32, gelu d_ff 256, a vocabulary of 512, 16 encoder frames. The frames
(B, 16, 128), which neither package's data pipeline makes, are drawn with
numpy, the shape the reference's ``input_specs`` gives. Limits
(``PERF.md`` §2): a layer function's float32 outputs within 1e-5; the
model's logits and all four caches (self K/V, cross K/V) after prefill,
and the logits of each decode step after ``init_cache`` and after
``prefill``, within 1e-4 in float32 (elementwise, as
``tests/test_torch_models.py``) and within 5e-2 of each tensor's largest
magnitude in bfloat16 (the two frameworks round at other places, and the
port's attention keeps its probabilities in float32); greedy token streams
of the ``BatchedServer`` equal in float32.

The reference's server never prefills (it feeds prompts one decode step
at a time), so its cross caches stay the zeros of ``init_cache`` and each
decoder layer's cross attention reads zero values; the port keeps that,
and a test pins it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tfm
from repro.models.common import Policy as JaxPolicy
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.common import Init, Policy
from repro_torch.models.layers import MLP

ARCH = "whisper-small"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
FN_TOL = 1e-5


def _cfgs():
    return jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    """(reference model, its parameters, the port's model on them); shared
    by the tests, none of which changes a parameter."""
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


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _frames(rng, B, cfg):
    return _randn(rng, B, cfg.encoder_seq_len, cfg.d_model)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


# ------------------------------------------------------------- the layers


def test_gelu_mlp_matches_reference():
    rng = np.random.default_rng(1)
    d, f = 64, 128
    p = {"wi": _randn(rng, d, f, scale=0.5),
         "wo": _randn(rng, f, d, scale=f ** -0.5)}
    x = _randn(rng, 2, 5, d)
    mlp = MLP(Init(Policy(compute_dtype=torch.float32), "cpu", seed=None),
              d, f, "gelu")
    for key, val in p.items():
        getattr(mlp, key).data.copy_(torch.from_numpy(val))
    want = jax_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), "gelu")
    _close(mlp(torch.from_numpy(x)), want)
    # one token a sequence: the reference's decode MLP
    want = jax_tfm._mlp_step({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x[:, 0]), "gelu")
    _close(mlp(torch.from_numpy(x[:, 0])), want)


def test_encoder_layer_matches_reference():
    jm, params, model = _pair("float32")
    x = _frames(np.random.default_rng(2), 2, model.cfg)
    want = jax_tfm.encoder_layer(_layer0(params["enc_layers"]), jm.cfg,
                                 jnp.asarray(x))
    got = transformer.encoder_layer(model.enc_layers[0], model.cfg,
                                    torch.from_numpy(x))
    _close(got, want)


def test_cross_decoder_layer_matches_reference():
    """The prefill / training layer with ``enc_out``: its output and the
    four caches, the self K/V in the model layout (B, S, Hkv, hd) and the
    cross K/V of ``project_cross_kv`` in the cache layout (B, Hkv, T,
    hd)."""
    jm, params, model = _pair("float32")
    rng = np.random.default_rng(3)
    B, S, d = 2, 7, model.cfg.d_model
    x, enc = _randn(rng, B, S, d), _frames(rng, B, model.cfg)
    positions = jnp.arange(S, dtype=jnp.int32)[None].repeat(B, 0)
    wx, _, (wk, wv, wck, wcv) = jax_tfm.decoder_layer(
        _layer0(params["dec_layers"]), jm.cfg, jnp.asarray(x), positions,
        enc_out=jnp.asarray(enc), collect_cache=True)
    gx, aux, (k, v, ck, cv) = transformer.decoder_layer(
        model.dec_layers[0], model.cfg, torch.from_numpy(x), None,
        enc_out=torch.from_numpy(enc))
    _close(gx, wx, what="x")
    assert float(aux) == 0.0
    _close(k.transpose(1, 2), wk, what="k")
    _close(v.transpose(1, 2), wv, what="v")
    assert ck.shape == (B, model.cfg.num_kv_heads, model.cfg.encoder_seq_len,
                        model.cfg.resolved_head_dim)
    _close(ck, wck, what="cross k")
    _close(cv, wcv, what="cross v")


def test_plain_decode_attn_and_cross_decode_step_match_reference():
    jm, params, model = _pair("float32")
    cfg = model.cfg
    rng = np.random.default_rng(4)
    B, T, hd = 3, cfg.encoder_seq_len, cfg.resolved_head_dim
    q = _randn(rng, B, cfg.num_heads, hd)
    ck, cv = (_randn(rng, B, cfg.num_kv_heads, T, hd) for _ in range(2))
    _close(transformer._plain_decode_attn(*map(torch.from_numpy,
                                               (q, ck, cv))),
           jax_tfm._plain_decode_attn(*map(jnp.asarray, (q, ck, cv))))
    # a decoder layer's step over a self cache of 8 (position 5 written)
    # and the cross caches
    x = _randn(rng, B, cfg.d_model)
    kc, vc = (_randn(rng, B, cfg.num_kv_heads, 8, hd) for _ in range(2))
    wx, wkc, wvc = jax_tfm.decoder_layer_step(
        _layer0(params["dec_layers"]), jm.cfg, jnp.asarray(x),
        jnp.asarray(kc), jnp.asarray(vc), jnp.int32(5),
        enc_kv=(jnp.asarray(ck), jnp.asarray(cv)))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    gx = transformer.decoder_layer_step(
        model.dec_layers[0], cfg, torch.from_numpy(x), tkc, tvc, 5, None,
        enc_kv=(torch.from_numpy(ck), torch.from_numpy(cv)))
    _close(gx, wx, what="x")
    _close(tkc, wkc, what="k cache")
    _close(tvc, wvc, what="v cache")


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    jm, params, model = _pair(dtype)
    rng = np.random.default_rng(5)
    B, S = 2, 9
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    frames = _frames(rng, B, model.cfg)
    jlogits, jcache = jax.jit(jm.prefill)(
        params, {"tokens": jnp.asarray(tokens),
                 "enc_frames": jnp.asarray(frames)})
    logits, cache = model.prefill(torch.from_numpy(tokens), frames)
    assert cache["pos"] == S and int(jcache["pos"]) == S
    assert logits.shape == (B, model.vocab_padded)
    _model_close(logits, jlogits, dtype, "prefill logits")
    assert len(cache["layers"]) == len(jcache["layers"]) == 4
    for name, got, want in zip(("k", "v", "cross k", "cross v"),
                               cache["layers"], jcache["layers"]):
        assert tuple(got.shape) == tuple(want.shape), name
        _model_close(got, want, dtype, name)
    step = jax.jit(jm.decode_step)
    # decode past the prefill's S positions: the self caches are S long,
    # so a write past them writes nothing, in both packages
    for i in range(3):
        tok = rng.integers(0, 512, (B,)).astype(np.int32)
        jlogits, jcache = step(params, jnp.asarray(tok), jcache)
        logits, cache = model.decode_step(torch.from_numpy(tok), cache)
        _model_close(logits, jlogits, dtype, f"decode step {i}")
    assert cache["pos"] == S + 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_from_empty_cache_matches_reference(dtype):
    jm, params, model = _pair(dtype)
    rng = np.random.default_rng(6)
    jcache = jm.init_cache(2, 16)
    cache = model.init_cache(2, 16)
    step = jax.jit(jm.decode_step)
    for i in range(4):
        tok = rng.integers(0, 512, (2,)).astype(np.int32)
        jlogits, jcache = step(params, jnp.asarray(tok), jcache)
        logits, cache = model.decode_step(torch.from_numpy(tok), cache)
        _model_close(logits, jlogits, dtype, f"decode step {i}")
    for name, got, want in zip(("k", "v", "cross k", "cross v"),
                               cache["layers"], jcache["layers"]):
        _model_close(got, want, dtype, name)


def test_init_cache_matches_reference_layout():
    jm, _, model = _pair("bfloat16")
    want = jm.init_cache(3, 100)["layers"]
    got = model.init_cache(3, 100)["layers"]
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert all(t.dtype == torch.bfloat16 for t in got)
    assert all(str(t.dtype) == "bfloat16" for t in want)


def test_prefill_without_frames_raises():
    _, _, model = _pair("float32")
    with pytest.raises(ValueError, match="enc_frames"):
        model.prefill(np.zeros((1, 4), np.int64))


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


def test_server_leaves_the_cross_caches_zero():
    """The server feeds prompts by decode steps and never prefills, as the
    reference's: no encoder pass, so every cross cache stays zero after a
    run, and a cross attention over them adds nothing (its values are
    zero, whatever its queries)."""
    _, _, model = _pair("float32")
    server = serve.BatchedServer(model, 2, 64)
    out = server.run(serve.synthetic_requests(3, model.cfg.vocab_size, 1))
    assert out["requests_done"] == 3 and server.cache["pos"] > 0
    _, _, ck, cv = server.cache["layers"]
    assert not ck.any() and not cv.any()
    q = torch.randn(2, model.cfg.num_heads, model.cfg.resolved_head_dim)
    assert not transformer._plain_decode_attn(q, ck[0], cv[0]).any()


def test_serve_main_runs_the_reduced_audio_model_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--requests", "3", "--slots", "2",
                       "--cache-len", "128", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}" in out and "3 done" in out


def test_convert_fills_every_parameter_from_the_reference_tree():
    _, params, model = _pair("float32")
    assert sum(p.numel() for p in model.parameters()) == \
        sum(np.asarray(x).size for x in jax.tree.leaves(params))
    for stack, n in (("enc_layers", 2), ("dec_layers", 2)):
        assert len(getattr(model, stack)) == n
        assert sum(p.numel() for p in getattr(model, stack).parameters()) \
            == sum(np.asarray(x).size for x in jax.tree.leaves(params[stack]))
    assert tuple(model.pos_dec.shape) == (32_768, model.cfg.d_model)
    _close(model.pos_enc, params["pos_enc"], 0.0)
