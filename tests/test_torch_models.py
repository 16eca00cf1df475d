"""Parity of the port's serving models with the JAX package's ``Model``.

Reduced qwen3-4b (dense, through flash attention's plain version) and
rwkv6-7b (ssm, through WKV6's plain version) carry the JAX parameters
across with ``convert.model_params``; ``prefill`` logits and cache, then
three ``decode_step``s, are held against JAX. Tolerances: float32 compute
atol/rtol 1e-4 (the largest difference measured on these inputs is
~1.2e-5, in the rwkv state); bfloat16 compute atol/rtol 5e-2 (the two
frameworks round bfloat16 products at different places, and the port's
attention keeps its probabilities in float32 where the JAX XLA path
rounds them to bfloat16; measured up to ~0.047 on the logits). The
bfloat16 rwkv state is a float32 sum of products of those bfloat16 keys
and values over every token, so its error grows with its size: it is held
to 5e-2 of its largest entry (measured: 0.14 on entries up to ~10).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_configs as jax_list_configs
from repro.configs import reduced as jax_reduced
from repro.models.common import Policy as JaxPolicy
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config, list_configs, reduced
from repro_torch.convert import model_params
from repro_torch.models.common import Policy
from repro_torch.models.model import Model

from torch_dist_workers import qwen2vl_positions

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _pair(arch, dtype):
    jcfg = jax_reduced(jax_get_config(arch))
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=getattr(jnp, dtype)))
    params, _ = jm.init_params(jax.random.key(0))
    model = model_params(jax.tree.map(np.asarray, params),
                         reduced(get_config(arch)),
                         policy=Policy(compute_dtype=getattr(torch, dtype)),
                         device="cpu")
    return jm, params, model


def _close(got, want, tol, what, *, of_largest=False):
    want = np.asarray(want, np.float32)
    atol = tol * float(np.abs(want).max()) if of_largest else tol
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=tol, err_msg=what)


def _cache_close(arch, cache, jcache, tol):
    if arch == "qwen3-4b":
        for name, got, want in zip("kv", cache["layers"], jcache["layers"]):
            _close(got, want, tol, f"{name} cache")
    else:
        for name in ("wkv", "x_tm", "x_cm"):
            _close(cache[name], jcache[name], tol, name,
                   of_largest=name == "wkv" and tol == TOL["bfloat16"])
    assert cache["pos"] == int(jcache["pos"])


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 40])
def test_prefill_then_decode_matches_reference(arch, dtype, S):
    jm, params, model = _pair(arch, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(S)
    vocab = model.cfg.vocab_size
    tokens = rng.integers(0, vocab, (2, S)).astype(np.int32)
    jlogits, jcache = jax.jit(jm.prefill)(params,
                                          {"tokens": jnp.asarray(tokens)})
    logits, cache = model.prefill(torch.from_numpy(tokens))
    assert logits.shape == (2, model.vocab_padded)
    assert logits.dtype == getattr(torch, dtype)
    _close(logits, jlogits, tol, "prefill logits")
    _cache_close(arch, cache, jcache, tol)
    step = jax.jit(jm.decode_step)
    for i in range(3):
        tok = rng.integers(0, vocab, (2,)).astype(np.int32)
        jlogits, jcache = step(params, jnp.asarray(tok), jcache)
        logits, cache = model.decode_step(torch.from_numpy(tok), cache)
        _close(logits, jlogits, tol, f"decode step {i} logits")
        _cache_close(arch, cache, jcache, tol)


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-7b"])
def test_decode_from_empty_cache_matches_reference(arch):
    jm, params, model = _pair(arch, "float32")
    jcache = jm.init_cache(3, 16)
    cache = model.init_cache(3, 16)
    _cache_close(arch, cache, jcache, 0.0)
    step = jax.jit(jm.decode_step)
    rng = np.random.default_rng(1)
    for i in range(4):
        tok = rng.integers(0, model.cfg.vocab_size, (3,)).astype(np.int32)
        jlogits, jcache = step(params, jnp.asarray(tok), jcache)
        logits, cache = model.decode_step(torch.from_numpy(tok), cache)
        _close(logits, jlogits, TOL["float32"], f"step {i}")
    _cache_close(arch, cache, jcache, TOL["float32"])


def test_qkv_biases_match_reference():
    """Reduced qwen1.5-110b (``qkv_bias``) in float32. The reference
    initializes the q/k/v biases to zero, so they are drawn here from
    N(0, 0.5^2) (numpy, seeded) into the reference's tree before both
    packages take it."""
    jm = JaxModel(jax_reduced(jax_get_config("qwen1.5-110b")),
                  JaxPolicy(compute_dtype=jnp.float32))
    params, _ = jm.init_params(jax.random.key(0))
    tree = jax.tree.map(lambda x: np.array(x, copy=True), params)
    rng = np.random.default_rng(11)
    attn = tree["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        assert not attn[name].any()
        attn[name] = (rng.standard_normal(attn[name].shape) * 0.5
                      ).astype(np.float32)
    model = model_params(tree, reduced(get_config("qwen1.5-110b")),
                         policy=Policy(compute_dtype=torch.float32),
                         device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = rng.integers(0, model.cfg.vocab_size, (2, 40)).astype(np.int32)
    jlogits, jcache = jax.jit(jm.prefill)(jparams,
                                          {"tokens": jnp.asarray(tokens)})
    logits, cache = model.prefill(torch.from_numpy(tokens))
    tol = TOL["float32"]
    _close(logits, jlogits, tol, "prefill logits")
    for name, got, want in zip("kv", cache["layers"], jcache["layers"]):
        _close(got, want, tol, f"{name} cache")
    step = jax.jit(jm.decode_step)
    for i in range(3):
        tok = rng.integers(0, model.cfg.vocab_size, (2,)).astype(np.int32)
        jlogits, jcache = step(jparams, jnp.asarray(tok), jcache)
        logits, cache = model.decode_step(torch.from_numpy(tok), cache)
        _close(logits, jlogits, tol, f"decode step {i} logits")


def test_given_positions_and_patches_match_reference():
    """The dense family reads a batch's "positions" (B, S) and
    "patch_embeds" (B, P, D) where given, as the reference's ``_forward``
    does (its ``_positions`` and ``_embed``): reduced qwen3-4b in float32,
    each row's positions shifted, two patch rows."""
    jm, params, model = _pair("qwen3-4b", "float32")
    rng = np.random.default_rng(12)
    B, S = 2, 16
    batch = {"tokens": rng.integers(0, model.cfg.vocab_size, (B, S)),
             "positions": np.arange(S)[None] + np.array([[7], [3]]),
             "patch_embeds": rng.standard_normal((B, 2, model.cfg.d_model))}
    batch = {k: v.astype(np.int32 if k != "patch_embeds" else np.float32)
             for k, v in batch.items()}
    batch["labels"] = batch["tokens"]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = jax.jit(jm.prefill)(params, jbatch)
    logits, _ = model.prefill(batch["tokens"], positions=batch["positions"],
                              patch_embeds=batch["patch_embeds"])
    _close(logits, jlogits, TOL["float32"], "prefill logits")
    plain, _ = model.prefill(batch["tokens"])
    assert not torch.allclose(plain, logits, atol=1e-2)
    jloss, _ = jax.jit(jm.train_loss)(params, jbatch)
    loss, _ = model.train_loss(batch)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


def test_configs_match_the_reference_registry():
    assert list_configs() == jax_list_configs()
    for name in list_configs():
        a, b = get_config(name), jax_get_config(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.param_count() == b.param_count()
        ra, rb = reduced(a), jax_reduced(b)
        assert dataclasses.asdict(ra) == dataclasses.asdict(rb)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-small",
                                  "qwen2-vl-72b"])
def test_later_families_train(arch):
    """The hybrid, audio and vlm families are ported: each builds and
    gives a finite scalar ``train_loss`` (the audio family's batch with
    seeded encoder frames, the vlm family's with seeded patch embeddings
    and M-RoPE positions in Qwen2-VL's layout; the full checks are in
    tests/test_torch_hybrid*.py, tests/test_torch_audio*.py and
    tests/test_torch_vlm*.py)."""
    cfg = reduced(get_config(arch))
    model = Model(cfg, device="cpu")
    tokens = np.zeros((1, 8), np.int64)
    batch = {"tokens": tokens, "labels": tokens}
    rng = np.random.default_rng(0)
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = rng.standard_normal(
            (1, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        batch["patch_embeds"] = rng.standard_normal(
            (1, 4, cfg.d_model)).astype(np.float32)
        batch["positions"] = qwen2vl_positions(1, 8, (2, 2))
    loss, _ = model.train_loss(batch)
    assert bool(torch.isfinite(loss)) and loss.dim() == 0


def test_seeded_init_is_repeatable_and_has_the_reference_scales():
    cfg = reduced(get_config("qwen3-4b"))
    pol = Policy(compute_dtype=torch.float32)
    a = Model(cfg, pol, device="cpu", seed=3)
    b = Model(cfg, pol, device="cpu", seed=3)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    wq = a.layers[0].attn.wq            # dense: N(0, 1) / sqrt(fan_in)
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(a.embed.tok.std()) / 0.02 - 1.0) < 0.05
    assert float(a.layers[0].ln_attn.abs().max()) == 0.0
    assert a.layers[0].attn.wq.dtype == torch.float32
    assert Model(cfg, device="cpu").layers[0].attn.wq.dtype == torch.bfloat16


def test_model_params_checks_the_tree():
    jm = JaxModel(jax_reduced(jax_get_config("qwen3-4b")))
    params, _ = jm.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    cfg = reduced(get_config("qwen3-4b"))
    del tree["layers"]["attn"]["wq"]
    with pytest.raises(KeyError):
        model_params(tree, cfg, device="cpu")
    with pytest.raises(ValueError):
        model_params(jax.tree.map(np.asarray, params),
                     reduced(get_config("qwen3-4b"), d_ff=128), device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b",
                                  "llama4-scout-17b-a16e"])
def test_cuda_without_a_card_raises(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: asking for it is legitimate here")
    with pytest.raises(RuntimeError):
        Model(reduced(get_config(arch)))
