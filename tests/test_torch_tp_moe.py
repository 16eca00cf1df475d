"""The port's expert parallelism (the moe family under a "model" axis wider
than 1) in four gloo ranks on the CPU, against the JAX package's run under
the same mesh.

Under expert parallelism the reference routes on the whole (replicated)
batch but each shard dispatches its own tokens (its S / tp sequence
slice) at the capacity of those tokens, so its loss differs from its
unsharded loss (by 1e-2 at (1, 4) on the issue's inputs): the port is
held to the reference's *mesh* run. One subprocess runs the reference
(``tests/torch_tp_workers.py``, four forced CPU devices, the meshes of
``repro.launch.mesh._make_mesh``, its experts recorded by a
``jax.debug.callback`` on ``repro.models.moe._route``) and one spawn of
four gloo ranks runs the port (each rank records the experts of every
MoE call and the keep bit of every slot it dispatched). Reduced
deepseek-moe-16b (a dense first layer and one MoE layer: 4 experts, top
2, a shared expert; float32; one batch of 4 x 32 tokens), the seed-0
weights of ``torch_tp_workers.write_inits``. Cases
(``torch_tp_workers.MOE``): (1, 2) (two experts a rank; the port's (2, 2)
mesh, whose plain calls do not split the batch over "data"), (1, 4) (one
expert a rank) and (1, 4) at capacity 0.5.

Limits: the experts of the prefill's MoE call equal to the reference's;
each slot's keep bit equal to the reference's rule, applied to each
shard's tokens at that shard's capacity (at capacity 0.5 the rule over
the whole batch keeps other slots, so a port that routed the batch as
one would fail); prefill logits, the decode step after it and three
decode steps from an empty cache (every rank dispatches all 4 tokens)
within 1e-4 elementwise of the mesh run's; ``train_loss`` within 1e-5
(relative) of it and each rank's gradients (its slice) within 1e-4 of
each leaf's largest magnitude.
"""
import json

import numpy as np
import pytest

import repro_torch.configs
import torch_tp_workers as workers
from repro_torch.models.moe import capacity

CASES = tuple(workers.MOE)
LOSS_TOL, GRAD_TOL, OUT_TOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_moe")
    workers.run_suite("moe", str(out))
    return out


def _ranks(out, case):
    return [(workers.load(out / f"{case}_rank{r}.npz"),
             json.loads((out / f"{case}_rank{r}.json").read_text()))
            for r in range(4)]


def _mesh(case):
    return f"mesh{workers.mesh_tag(workers.MOE[case][2][0])}"


def _keep_rule(idx, C):
    """The reference's drop rule: slot s (flat (token, choice) order) is
    kept while fewer than C earlier slots chose its expert."""
    flat = idx.reshape(-1)
    seen: dict = {}
    keep = np.zeros(flat.size, bool)
    for s, e in enumerate(flat):
        keep[s] = seen.get(int(e), 0) < C
        seen[int(e)] = seen.get(int(e), 0) + 1
    return keep.reshape(idx.shape)


def _per_shard_keep(idx, tp, cfg):
    """The keep bits of idx (B, S, k) where each of ``tp`` shards
    dispatches its S / tp slice at its own capacity."""
    B, S, _ = idx.shape
    n = S // tp
    C = capacity(B * n, cfg)
    return np.concatenate([_keep_rule(idx[:, r * n:(r + 1) * n], C)
                           for r in range(tp)], axis=1)


def _slice(full, dim, rank, tp):
    if dim is None:
        return full
    n = full.shape[dim] // tp
    index = [slice(None)] * full.ndim
    index[dim] = slice(rank * n, (rank + 1) * n)
    return full[tuple(index)]


@pytest.mark.parametrize("case", CASES)
def test_experts_and_keep_bits_match_the_mesh_run(run, case):
    ref = workers.load(run / f"ref_{case}.npz")
    cfg = workers.case_config(case, repro_torch.configs)
    want_idx = ref[f"{_mesh(case)}/experts/0"]
    ranks = _ranks(run, case)
    tp = ranks[0][1]["tp"]
    for arrays, _ in ranks:
        np.testing.assert_array_equal(arrays["experts/0"], want_idx)
    want_keep = _per_shard_keep(want_idx, tp, cfg)
    for base in range(0, 4, tp):
        by_rank = {f["model_rank"]: a["keep/0"]
                   for a, f in ranks[base:base + tp]}
        got = np.concatenate([by_rank[r] for r in range(tp)], axis=1)
        np.testing.assert_array_equal(got, want_keep)
    if workers.MOE[case][4] is not None:      # the capacity cut
        assert not want_keep.all()
        B, S, _ = want_idx.shape
        whole = _keep_rule(want_idx, capacity(B * S, cfg))
        assert (whole != want_keep).any()


@pytest.mark.parametrize("case", CASES)
def test_outputs_match_the_mesh_run(run, case):
    ref = workers.load(run / f"ref_{case}.npz")
    tag = _mesh(case)
    for arrays, _ in _ranks(run, case):
        for key in ["prefill", "decode_after"] + [
                f"decode/{i}" for i in range(workers.DECODE_STEPS)]:
            np.testing.assert_allclose(arrays[key], ref[f"{tag}/{key}"],
                                       atol=OUT_TOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_train_loss_and_grads_match_the_mesh_run(run, case):
    ref = workers.load(run / f"ref_{case}.npz")
    tag = _mesh(case)
    for arrays, facts in _ranks(run, case):
        assert float(arrays["loss"]) == pytest.approx(
            float(ref[f"{tag}/loss"]), rel=LOSS_TOL)
        for key, g in arrays.items():
            if not key.startswith("grad/"):
                continue
            name = key[5:]
            want = _slice(ref[f"{tag}/grad/{name}"],
                          facts["tp_dims"].get(name), facts["model_rank"],
                          facts["tp"])
            err = np.abs(g - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= GRAD_TOL, name


def test_the_mesh_run_is_not_the_unsharded_run(run):
    """The comparison can tell: at (1, 4) the per-shard capacity changes
    the reference's loss beyond the limit, and at capacity 0.5 the port's
    ranks drop slots."""
    for case in ("deepseek-moe-16b@1x4", "deepseek-moe-16b-drops@1x4"):
        ref = workers.load(run / f"ref_{case}.npz")
        mesh, plain = float(ref["mesh1x4/loss"]), float(ref["plain/loss"])
        assert abs(mesh - plain) > 10 * LOSS_TOL * abs(plain), case
    drops = [f["dropped"][0] for _, f in
             _ranks(run, "deepseek-moe-16b-drops@1x4")]
    assert all(d > 0 for d in drops), drops


def test_experts_split_over_model(run):
    for case in CASES:
        for _, facts in _ranks(run, case):
            assert facts["tp_dims"]["layers.0.moe.wi"] == 0
            assert facts["tp_dims"]["layers.0.moe.wo"] == 0
            assert "layers.0.moe.router" not in facts["tp_dims"]
