"""The moe family's routing across the batch ranks where "model" is wider
than 1 and does not divide the experts, in four gloo ranks on the CPU,
against the JAX package's run under the same mesh.

Reduced deepseek-moe-16b (a dense first layer and one MoE layer, top 2, a
shared expert) with 3 experts and its capacity cut to 0.5 (so full
experts drop slots), float32, ``DataConfig(vocab, 32, 4)``: two
``Trainer`` steps at ("data", "model") = (2, 2), the port's seed-0
weights in both packages (``tests/torch_moe_route_workers.py``). 3 experts
do not divide "model" = 2, so the experts are whole on every rank; each
"data" rank holds two rows of the batch and the two "model" ranks of a
"data" rank the same two. The reference's GSPMD step routes the whole
batch at the capacity of all its tokens; the port's ranks gather their
per-expert counts over the batch ranks only ("pod" x "data", the ranks
that share their "model" coordinate) and route the same way. Gathered
over the whole world, the counts of each "data" rank would be counted
twice.

Limits (``tests/test_torch_dist_train.py``'s): both steps' loss and
gradient norm within 1e-4 (relative) of the reference's; every moment
within 1e-4 of its leaf's largest magnitude after each step, and every
master weight too but for at most 1 in 10^4 entries, none by more than 5 %
of the summed learning rate; the experts of step 1's first MoE call equal
to the reference's, and each rank's keep bits the whole batch's drop rule
at its capacity (which keeps other slots than each rank's own capacity
would).
"""
import json

import numpy as np
import pytest

import repro_torch.configs
import torch_moe_route_workers as workers
import torch_tp_workers as tpw
from repro_torch.models.moe import capacity


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_route")
    workers.run(str(out))
    ranks = [(tpw.load(out / f"rank{r}.npz"),
              json.loads((out / f"rank{r}.json").read_text()))
             for r in range(4)]
    return {"out": out, "ranks": ranks,
            "ref": tpw.load(out / "ref.npz"),
            "ref_hist": json.loads((out / "ref.json").read_text())}


def test_two_steps_match_the_reference_mesh_run(run):
    want = run["ref_hist"]
    hist = run["ranks"][0][1]["history"]
    assert [h["step"] for h in hist] == [1, 2]
    for _, facts in run["ranks"][1:]:        # the metrics are global means
        assert facts["history"] == hist
    for h, w in zip(hist, want):
        assert h["loss"] == pytest.approx(w["loss"], rel=1e-4)
        assert h["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)
        assert h["lr"] == pytest.approx(w["lr"], rel=1e-6)


@pytest.mark.parametrize("step", [1, 2])
def test_masters_and_moments_match_the_reference_mesh_run(run, step):
    got = tpw.load(run["out"] / f"step{step}.npz")
    tag = f"step{step}/"
    want = {k[len(tag):]: v for k, v in run["ref"].items()
            if k.startswith(tag)}
    lr_sum = sum(h["lr"] for h in run["ref_hist"][:step])
    tpw._hold_state(got, want, lr_sum)


def test_experts_and_keep_bits_are_the_whole_batchs(run):
    cfg = workers.config(repro_torch.configs)
    want_idx = run["ref"]["experts"]
    B, S, _ = want_idx.shape
    keep = {}
    for arrays, facts in run["ranks"]:
        index, shards = facts["batch_shard"]
        assert shards == workers.MESH[0]
        n = B // shards
        np.testing.assert_array_equal(arrays["experts"],
                                      want_idx[index * n:(index + 1) * n])
        keep.setdefault(index, []).append(arrays["keep"])
    for bits in keep.values():              # a "model" group's ranks agree
        assert all(np.array_equal(b, bits[0]) for b in bits)
    got = np.concatenate([keep[i][0] for i in sorted(keep)])
    whole = tpw.keep_rule(want_idx, capacity(B * S, cfg))
    np.testing.assert_array_equal(got, whole)
    assert not whole.all()
    n = B // len(keep)
    own = np.concatenate([tpw.keep_rule(want_idx[i * n:(i + 1) * n],
                                        capacity(n * S, cfg))
                          for i in range(len(keep))])
    assert (own != whole).any()
