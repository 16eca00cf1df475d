"""Parity of the port's vlm family (qwen2-vl: M-RoPE, the stub vision
tower's patch embeddings, the dense layer stack with q/k/v biases) with
the JAX package's ``repro.models.layers.apply_mrope`` and ``Model``.

Inputs come from numpy seeds and go through both packages; the model's
weights are the reference's, carried across with ``convert.model_params``,
its q/k/v biases (zero at the reference's init) drawn from N(0, 0.5^2)
first so that they count. The config is qwen2-vl-72b reduced as the JAX
package reduces it: 2 layers, d 128, 4 query heads over 2 KV heads of
32, M-RoPE sections (4, 6, 6). Every batch holds one image of 2 x 2
merged patches (P = 4 seeded patch embeddings) at the front, with
positions in Qwen2-VL's layout (``torch_dist_workers.qwen2vl_positions``:
patch (i, j) at (0, i, j), the text from 2 on, on all three streams), so
the three streams differ: with equal streams M-RoPE is plain RoPE, and a
wrong section map would pass. Limits (``PERF.md`` §2): ``mrope_tables``
with ``apply_rope`` within 1e-5 of ``apply_mrope`` in float32; the
model's prefill logits and K/V caches and the logits of each decode step
within 1e-4 in float32 (elementwise, as ``tests/test_torch_models.py``)
and within 5e-2 of each tensor's largest magnitude in bfloat16; the
``BatchedServer``'s greedy token streams equal in float32.

Decode rotates by the cache's ``pos`` on all three streams, as the
reference does: after a prefill that opens with an image, Qwen2-VL's
rope deltas would put the next token lower. The port keeps the
reference's answer, and a test pins it.
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
from repro.models.common import Policy as JaxPolicy
from repro.models.model import Model as JaxModel
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params
from repro_torch.launch import serve
from repro_torch.models.common import Policy
from repro_torch.models.layers import apply_rope, mrope_tables, rope_tables

from torch_dist_workers import VLM_GRID, qwen2vl_positions

ARCH = "qwen2-vl-72b"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
FN_TOL = 1e-5
THETA = 1_000_000.0


def _cfgs():
    return jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    """(reference model, its parameters with drawn biases, the port's model
    on them); shared by the tests, none of which changes a parameter."""
    jcfg, cfg = _cfgs()
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=getattr(jnp, dtype)))
    params, _ = jm.init_params(jax.random.key(0))
    tree = jax.tree.map(lambda x: np.array(x, copy=True), params)
    rng = np.random.default_rng(11)
    attn = tree["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        assert not attn[name].any()
        attn[name] = (rng.standard_normal(attn[name].shape) * 0.5
                      ).astype(np.float32)
    model = model_params(tree, cfg,
                         policy=Policy(compute_dtype=getattr(torch, dtype)),
                         device="cpu")
    return jm, jax.tree.map(jnp.asarray, tree), model


def _np(x):
    return np.asarray(x, np.float32)


def _model_close(got, want, dtype, what):
    """The model's limit: float32 elementwise, bfloat16 of the largest
    magnitude."""
    g, w = got.float().numpy(), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=TOL[dtype], rtol=TOL[dtype],
                                   err_msg=what)
        return
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= TOL[dtype], f"{what}: {err:.3e} of the largest magnitude"


def _inputs(rng, B, S, d_model, grid=VLM_GRID):
    """tokens (B, S), patch embeddings (B, gh gw, D), positions (3, B, S)
    in Qwen2-VL's layout."""
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, grid[0] * grid[1], d_model),
                                  dtype=np.float32)
    return tokens, patches, qwen2vl_positions(B, S, grid)


def _rotate(x, positions, sections, theta=THETA):
    """The port's M-RoPE of x (B, S, H, hd) at positions (3, B, S)."""
    tables = mrope_tables(torch.from_numpy(positions), x.shape[-1],
                          sections, theta)
    return apply_rope(torch.from_numpy(x), tables)


# ------------------------------------------------------------- M-RoPE


@pytest.mark.parametrize("hd,sections,grid,S", [
    (32, (4, 6, 6), (2, 2), 12),            # the reduced model's
    (128, (16, 24, 24), (16, 16), 300),     # qwen2-vl-72b's, P = 256
    (128, (16, 24, 24), (8, 12), 140)])     # a grid that is not square
def test_mrope_tables_match_apply_mrope(hd, sections, grid, S):
    rng = np.random.default_rng(hd + S)
    B, H = 2, 3
    x = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    pos = qwen2vl_positions(B, S, grid)
    assert len({tuple(p.ravel()) for p in pos}) == 3     # streams differ
    want = jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                  sections, THETA)
    cos, sin = mrope_tables(torch.from_numpy(pos), hd, sections, THETA)
    assert cos.shape == sin.shape == (B, S, 1, hd // 2)
    assert cos.dtype == torch.float32
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), (cos, sin)).numpy(), _np(want),
        atol=FN_TOL, rtol=FN_TOL)


def test_mrope_with_equal_streams_is_rope_and_the_layout_is_not():
    """Three equal streams give plain RoPE of that stream (in both
    packages); the Qwen2-VL layout's distinct streams move the result
    away from it by O(1), so the parity test above sees the section
    map."""
    rng = np.random.default_rng(1)
    B, S, H, hd = 2, 12, 2, 32
    x = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    pos = qwen2vl_positions(B, S, VLM_GRID)
    equal = np.broadcast_to(pos[2:], pos.shape).copy()   # width everywhere
    got = _rotate(x, equal, (4, 6, 6))
    rope = apply_rope(torch.from_numpy(x),
                      rope_tables(torch.from_numpy(equal[0]), hd, THETA))
    np.testing.assert_allclose(got.numpy(), rope.numpy(), atol=FN_TOL,
                               rtol=FN_TOL)
    np.testing.assert_allclose(
        got.numpy(), _np(jax_layers.apply_mrope(
            jnp.asarray(x), jnp.asarray(equal), (4, 6, 6), THETA)),
        atol=FN_TOL, rtol=FN_TOL)
    moved = np.abs(_rotate(x, pos, (4, 6, 6)).numpy() - got.numpy()).max()
    assert moved > 0.1, moved


@pytest.mark.parametrize("hd,sections,permuted,grid,S", [
    (32, (4, 6, 6), (6, 4, 6), (4, 6), 40),
    (128, (16, 24, 24), (24, 24, 16), (16, 16), 300)])
def test_permuted_sections_differ_from_the_reference(hd, sections, permuted,
                                                     grid, S):
    """A permuted section map rotates the slots by other streams: its
    result differs from the reference's by O(1) at the image's positions,
    and agrees with the reference run at the same permutation."""
    rng = np.random.default_rng(hd)
    B, H = 2, 2
    x = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    pos = qwen2vl_positions(B, S, grid)

    def reference(secs):
        return _np(jax_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos),
                                          secs, THETA))
    got = _rotate(x, pos, permuted).numpy()
    assert np.abs(got - reference(sections)).max() > 0.1
    np.testing.assert_allclose(got, reference(permuted), atol=FN_TOL,
                               rtol=FN_TOL)


def test_mrope_tables_check_the_sections():
    pos = torch.from_numpy(qwen2vl_positions(1, 8, VLM_GRID))
    with pytest.raises(ValueError, match="sum"):
        mrope_tables(pos, 32, (4, 6, 5), THETA)
    with pytest.raises(AssertionError):          # the reference asserts
        jax_layers.apply_mrope(jnp.zeros((1, 8, 1, 32)), jnp.asarray(pos),
                               (4, 6, 5), THETA)


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    jm, params, model = _pair(dtype)
    rng = np.random.default_rng(5)
    B, S = 2, 14
    tokens, patches, pos = _inputs(rng, B, S, model.cfg.d_model)
    jlogits, jcache = jax.jit(jm.prefill)(
        params, {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(pos),
                 "patch_embeds": jnp.asarray(patches)})
    logits, cache = model.prefill(torch.from_numpy(tokens), positions=pos,
                                  patch_embeds=patches)
    assert cache["pos"] == S and int(jcache["pos"]) == S
    assert logits.shape == (B, model.vocab_padded)
    assert logits.dtype == getattr(torch, dtype)
    _model_close(logits, jlogits, dtype, "prefill logits")
    for name, got, want in zip("kv", cache["layers"], jcache["layers"]):
        assert tuple(got.shape) == tuple(want.shape), name
        _model_close(got, want, dtype, f"{name} cache")
    step = jax.jit(jm.decode_step)
    for i in range(3):
        tok = rng.integers(0, 512, (B,)).astype(np.int32)
        jlogits, jcache = step(params, jnp.asarray(tok), jcache)
        logits, cache = model.decode_step(torch.from_numpy(tok), cache)
        _model_close(logits, jlogits, dtype, f"decode step {i}")
    assert cache["pos"] == S + 3


def test_decode_from_empty_cache_matches_reference():
    jm, params, model = _pair("float32")
    rng = np.random.default_rng(6)
    jcache = jm.init_cache(3, 16)
    cache = model.init_cache(3, 16)
    step = jax.jit(jm.decode_step)
    for i in range(4):
        tok = rng.integers(0, 512, (3,)).astype(np.int32)
        jlogits, jcache = step(params, jnp.asarray(tok), jcache)
        logits, cache = model.decode_step(torch.from_numpy(tok), cache)
        _model_close(logits, jlogits, "float32", f"decode step {i}")
    for name, got, want in zip("kv", cache["layers"], jcache["layers"]):
        _model_close(got, want, "float32", f"{name} cache")


def test_decode_after_an_image_rotates_at_the_cache_pos():
    """The reference decodes at ``cache["pos"]`` on all three streams, so
    after a prefill of S tokens that opens with the 2 x 2 image the next
    token sits at S, where Qwen2-VL's rope deltas would put it at S - 2
    (its text runs at index - P + 2). The port keeps the reference's
    answer: the decode step's logits equal the last logits of a prefill
    of the S + 1 tokens whose last positions are S on every stream, and
    differ from those of one whose last positions are S - 2. (The
    prefill's caches hold S rows, where a decode at S writes nothing, so
    they are copied into caches of S + 1 first.)"""
    _, _, model = _pair("float32")
    rng = np.random.default_rng(8)
    S = 10
    tokens, patches, pos = _inputs(rng, 1, S + 1, model.cfg.d_model)
    _, pre = model.prefill(torch.from_numpy(tokens[:, :S]),
                           positions=pos[:, :, :S], patch_embeds=patches)
    cache = model.init_cache(1, S + 1)
    for got, want in zip(cache["layers"], pre["layers"]):
        got[..., :S, :] = want
    cache["pos"] = S
    got, _ = model.decode_step(torch.from_numpy(tokens[:, S]), cache)
    assert pos[0, 0, S] == S - 2                  # the layout's own answer
    ends = {}
    for at in (S, S - 2):
        p = pos.copy()
        p[:, :, S] = at
        ends[at], _ = model.prefill(torch.from_numpy(tokens), positions=p,
                                    patch_embeds=patches)
    np.testing.assert_allclose(got.numpy(), ends[S].numpy(),
                               atol=TOL["float32"], rtol=TOL["float32"])
    assert np.abs(got.numpy() - ends[S - 2].numpy()).max() > 1e-2


def test_prefill_without_positions_raises_as_the_reference():
    jm, params, model = _pair("float32")
    tokens = np.zeros((1, 8), np.int32)
    with pytest.raises(KeyError, match="positions"):
        model.prefill(tokens)
    with pytest.raises(KeyError, match="positions"):
        jm.prefill(params, {"tokens": jnp.asarray(tokens)})


def test_patches_overwrite_the_first_rows():
    """The patch rows replace the token rows (the tokens under them do not
    matter); a text-only prompt equals the same prompt with P = 0."""
    _, _, model = _pair("float32")
    rng = np.random.default_rng(9)
    tokens, patches, pos = _inputs(rng, 2, 8, model.cfg.d_model)
    other = tokens.copy()
    other[:, :4] = rng.integers(0, 512, (2, 4))
    a, _ = model.prefill(tokens, positions=pos, patch_embeds=patches)
    b, _ = model.prefill(other, positions=pos, patch_embeds=patches)
    assert torch.equal(a, b)
    c, _ = model.prefill(tokens, positions=pos)
    d, _ = model.prefill(tokens, positions=pos, patch_embeds=patches[:, :0])
    assert torch.equal(c, d) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="patch_embeds"):
        model.prefill(tokens[:, :3], positions=pos[:, :, :3],
                      patch_embeds=patches)


def test_server_matches_reference_token_for_token():
    """The server never prefills (prompts go in by decode steps), in both
    packages: text requests, M-RoPE at the cache's ``pos``."""
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


def test_serve_main_runs_the_reduced_vlm_model_on_the_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--requests", "3", "--slots", "2",
                       "--cache-len", "128", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {ARCH}" in out and "3 done" in out
