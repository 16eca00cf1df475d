"""The port's tensor parallelism over "model" for the dense and vlm families,
in four gloo ranks on the CPU, against the JAX package.

One subprocess runs the reference (``tests/torch_tp_workers.py``: four
forced CPU devices, its meshes from ``repro.launch.mesh._make_mesh``) and
one spawn of four gloo ranks runs the port (float32, reduced configs:
2 layers, d 128, 4 query heads over 2 KV heads of 32, vocab 512; one
batch of 4 x 32 tokens). Cases (``torch_tp_workers.DENSE``):

- qwen3-4b at (1, 2) and (2, 2) (the port's (2, 2) mesh: a plain call
  does not split its batch, so each "model" group is a (1, 2) run; the
  reference at both meshes); at (1, 4), where the 2 KV heads do not
  divide "model" and replicate, each rank attending with the KV head its
  query head reads;
- qwen3-4b with 6 query heads at (1, 4): the heads do not divide, the
  32-token query chunk does, so the query rows split over "model" (the
  reference's ``_seq_shard_fallback``);
- qwen2-vl-72b at (1, 2), with a 2 x 2 image (M-RoPE positions in
  Qwen2-VL's layout).

The weights are the port's seed-0 draw with q/k/v biases drawn non-zero
(``torch_tp_workers.write_inits``). Limits: ``train_loss`` within 1e-5
(relative) of the reference's unsharded loss and of its loss under each
mesh; each rank's gradient of each parameter, its tensor-parallel slice,
within 1e-4 of the leaf's largest magnitude of the unsharded reference's;
prefill logits and the K/V caches (each rank's slice of
every KV head, the sequence split where the length divides "model")
within 1e-4 elementwise of the reference's; decode logits after the
prefill (a position past the cache: no rank writes) and over three steps
from an empty cache at positions 14-16 (flash-decode: the writes cross a
shard boundary) within 1e-4; the ``BatchedServer``'s greedy
tokens equal to the reference's server's.
"""
import json

import numpy as np
import pytest

import torch_tp_workers as workers

CASES = tuple(workers.DENSE)
LOSS_TOL, GRAD_TOL, MESH_TOL, OUT_TOL = 1e-5, 1e-4, 1e-5, 1e-4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_dense")
    workers.run_suite("dense", str(out))
    return out


def _ranks(out, case):
    """Each rank's (arrays, facts)."""
    return [(workers.load(out / f"{case}_rank{r}.npz"),
             json.loads((out / f"{case}_rank{r}.json").read_text()))
            for r in range(4)]


def _slice(full, dim, rank, tp):
    if dim is None:
        return full
    n = full.shape[dim] // tp
    index = [slice(None)] * full.ndim
    index[dim] = slice(rank * n, (rank + 1) * n)
    return full[tuple(index)]


def _leaf_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cache(ranks, key):
    """The whole cache ``key`` from one "model" group's slices."""
    _, facts = ranks[0]
    tp, shards = facts["tp"], facts["kv_shards"]
    by_rank = {f["model_rank"]: a[key] for a, f in ranks[:tp]}
    if shards == 1:
        return by_rank[0]
    return np.concatenate([by_rank[r] for r in range(tp)], axis=-2)


@pytest.mark.parametrize("case", CASES)
def test_train_loss_and_grads_match_reference(run, case):
    ref = workers.load(run / f"ref_{case}.npz")
    meshes = [f"mesh{workers.mesh_tag(m)}" for m in workers.DENSE[case][2]]
    for arrays, facts in _ranks(run, case):
        loss = float(arrays["loss"])
        assert loss == pytest.approx(float(ref["plain/loss"]), rel=LOSS_TOL)
        for tag in meshes:
            assert loss == pytest.approx(float(ref[f"{tag}/loss"]),
                                         rel=MESH_TOL)
        grads = {k[5:]: v for k, v in arrays.items()
                 if k.startswith("grad/")}
        assert sorted(grads) == sorted(k[len("plain/grad/"):] for k in ref
                                       if k.startswith("plain/grad/"))
        for name, g in grads.items():
            dim = facts["tp_dims"].get(name)
            want = _slice(ref[f"plain/grad/{name}"], dim,
                          facts["model_rank"], facts["tp"])
            assert g.shape == want.shape, name
            assert _leaf_err(g, want) <= GRAD_TOL, name


@pytest.mark.parametrize("case", CASES)
def test_prefill_logits_and_caches_match_reference(run, case):
    ref = workers.load(run / f"ref_{case}.npz")
    ranks = _ranks(run, case)
    for arrays, _ in ranks:
        np.testing.assert_allclose(arrays["prefill"], ref["plain/prefill"],
                                   atol=OUT_TOL, rtol=0)
    shards = ranks[0][1]["kv_shards"]
    assert shards == (ranks[0][1]["tp"] if workers.SEQ %
                      ranks[0][1]["tp"] == 0 else 1)
    tp = ranks[0][1]["tp"]
    for base in range(0, 4, tp):       # each "model" group
        group = ranks[base:base + tp]
        for j in range(2):
            got = _cache(group, f"cache/layers/{j}")
            np.testing.assert_allclose(got, ref["plain/cache/layers"][j],
                                       atol=OUT_TOL, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_flash_decode_matches_reference(run, case):
    ref = workers.load(run / f"ref_{case}.npz")
    for arrays, facts in _ranks(run, case):
        assert facts["decode_kv_shards"] == facts["tp"]   # flash-decode
        np.testing.assert_allclose(arrays["decode_after"],
                                   ref["plain/decode_after"], atol=OUT_TOL,
                                   rtol=0)
        for i in range(workers.DECODE_STEPS):
            np.testing.assert_allclose(arrays[f"decode/{i}"],
                                       ref[f"plain/decode/{i}"],
                                       atol=OUT_TOL, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_server_tokens_match_reference(run, case):
    want = json.loads((run / "ref.json").read_text())[case]["server"]
    for _, facts in _ranks(run, case):
        assert facts["server_kv_shards"] == facts["tp"]
        assert facts["server"] == want


def test_layouts_of_the_cases(run):
    """Which attention path each case took: heads and KV heads sliced at
    (2, 2); KV heads replicated at (1, 4); neither (the query rows split)
    with 6 heads at (1, 4)."""
    want = {"qwen3-4b@2x2": (True, True), "qwen3-4b@1x4": (True, False),
            "qwen3-4b-h6@1x4": (False, False),
            "qwen2-vl-72b@2x2": (True, True)}
    for case, (heads, kv) in want.items():
        for _, facts in _ranks(run, case):
            assert (facts["heads_local"], facts["kv_local"]) == (heads, kv)
            split = facts["tp_dims"]
            assert ("layers.0.attn.wq" in split) == heads
            assert ("layers.0.attn.wk" in split) == kv
            assert split["embed.tok"] == 0 and split["layers.0.mlp.wo"] == 0
