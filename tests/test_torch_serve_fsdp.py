"""Serving under the mesh with the working weights sharded over "fsdp"
(``repro_torch.models.fsdp.ServeShards``, ``convert.serve_shards``), in
four gloo ranks on the CPU, against the JAX package.

One subprocess runs the reference (``tests/torch_serve_fsdp_workers.py``:
four forced CPU devices, meshes from ``repro.launch.mesh._make_mesh``)
and one spawn of four gloo ranks runs the port (float32, the reduced
configurations of ``tests/test_torch_tp{,_ssm,_hybrid,_audio}.py`` and
``test_torch_vlm.py``: qwen3-4b, deepseek-moe-16b, rwkv6-7b,
recurrentgemma-9b at 5 layers, whisper-small, qwen2-vl-72b; one batch of
4 x 32 tokens, 4 x 128 for recurrentgemma). Every family runs at (4, 1)
and (2, 2): each "data" rank serves its own rows (1 or 2), its weights
held as its shards and gathered a unit at a time. deepseek-moe-16b also
runs at (2, 2) with 3 experts ("model" does not split them) and its
capacity cut to 0.5: whole experts route the whole batch at its global
capacity, as the reference's GSPMD prefill does.

Limits: the prefill's logits, every cache tensor (each rank's rows,
gathered over "model" into the reference's layout) and two decode steps'
logits within 1e-4 elementwise of the reference's unsharded ``Model``
(the moe cases: of its run under the case's mesh, whose expert-parallel
capacity is per shard); the ``BatchedServer``'s greedy tokens (every rank
serving all four slots, its holder built with ``batch_shard=(0, 1)``)
equal to the reference's; the holder's block of
each parameter of the shape the reference's resolution gives its
``param_sharding`` placement on the case's mesh, and its bytes their sum;
every working weight empty (and on the serving device: the model is built
on the meta device) before and after a prefill and a decode step,
and after each release of its unit; the 3-expert case's experts equal to
the reference's and its keep bits the whole-batch rule's at the global
capacity (which differs from each rank's own capacity there).
"""
import json
import math
import types

import numpy as np
import pytest

import repro_torch.configs
import torch_serve_fsdp_workers as workers
import torch_tp_workers as tpw
from repro.dist import api as jax_dist
from repro_torch.models.model import Model
from repro_torch.models.moe import capacity

CASES = tuple(workers.CASES)
OUT_TOL = 1e-4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_fsdp")
    workers.run(str(out))
    return out


def _ranks(out, case):
    return [(tpw.load(out / f"{case}_rank{r}.npz"),
             json.loads((out / f"{case}_rank{r}.json").read_text()))
            for r in range(4)]


def _rows(facts):
    index, shards = facts["token_shard"]
    n = tpw.BATCH // shards
    return slice(index * n, (index + 1) * n)


def _batch_rows(got, want, rows):
    """``want``'s rows of ``got``'s batch dim: the one dim whose size
    differs (every case splits the batch of 4)."""
    dims = [d for d, (g, w) in enumerate(zip(got.shape, want.shape))
            if g != w]
    assert len(dims) == 1 and got.ndim == want.ndim, (got.shape, want.shape)
    index = [slice(None)] * want.ndim
    index[dims[0]] = rows
    return want[tuple(index)]


@pytest.mark.parametrize("case", CASES)
def test_prefill_and_caches_match_the_reference(run, case):
    ref = tpw.load(run / f"ref_{case}.npz")
    names = sorted(k for k in ref if k.startswith("cache/"))
    for arrays, facts in _ranks(run, case):
        rows = _rows(facts)
        np.testing.assert_allclose(arrays["prefill"], ref["prefill"][rows],
                                   atol=OUT_TOL, rtol=0)
        assert sorted(k for k in arrays if k.startswith("cache/")) == names
        for name in names:
            np.testing.assert_allclose(
                arrays[name], _batch_rows(arrays[name], ref[name], rows),
                atol=OUT_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_decode_steps_match_the_reference(run, case):
    ref = tpw.load(run / f"ref_{case}.npz")
    for arrays, facts in _ranks(run, case):
        for i in range(workers.DECODE_STEPS):
            np.testing.assert_allclose(arrays[f"decode/{i}"],
                                       ref[f"decode/{i}"][_rows(facts)],
                                       atol=OUT_TOL, rtol=0)


@pytest.mark.parametrize("case", workers.SERVER_CASES)
def test_server_tokens_equal_the_references(run, case):
    want = json.loads((run / "ref.json").read_text())[case]
    for _, facts in _ranks(run, case):
        assert facts["server_token_shard"] == [0, 1]
        assert facts["server"] == want


def _fake_mesh(shape):
    names = ("data", "model")
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


@pytest.mark.parametrize("case", CASES)
def test_holder_keeps_param_shardings_shard_of_every_parameter(run, case):
    cfg = workers.case_config(case, repro_torch.configs)
    model = Model(cfg, device="meta", seed=None)
    mesh = workers.CASES[case][1]
    jctx = jax_dist.DistContext(_fake_mesh(mesh))
    sizes = dict(zip(("data", "model"), mesh))
    want = {}
    for name, axes in model.param_axes().items():
        shape = model.global_shapes()[name]
        spec = jctx.spec(axes, shape)
        want[name] = [n // math.prod(sizes[a] for a in (
            (e,) if isinstance(e, str) else e or ())) for n, e in
            zip(shape, spec)]
    total = 4 * sum(math.prod(s) for s in want.values())     # float32
    for _, facts in _ranks(run, case):
        assert facts["blocks"] == want
        assert facts["nbytes"] == total


@pytest.mark.parametrize("case", CASES)
def test_no_weight_stays_gathered(run, case):
    units = set(Model(workers.case_config(case, repro_torch.configs),
                      device="meta", seed=None).zero3_units())
    for _, facts in _ranks(run, case):
        assert facts["empty_at_start"] and facts["empty_after_prefill"] \
            and facts["empty_after_decode"]
        assert facts["devices"] == ["cpu"]      # built on meta, served here
        assert set(facts["gathered"]) == units
        assert sorted(u for u, _ in facts["released"]) == \
            sorted(facts["gathered"])
        assert all(empty for _, empty in facts["released"])
        assert 0 < facts["peak_bytes"]


def test_whole_experts_route_the_whole_batch_at_its_capacity(run):
    """3 experts at (2, 2): the experts of each rank's rows are the
    reference's, and the keep bits of the two "data" ranks together are
    the drop rule over the whole batch at its capacity, which keeps other
    slots than each rank's own capacity would."""
    case = "deepseek-moe-16b-e3@2x2"
    cfg = workers.case_config(case, repro_torch.configs)
    want_idx = tpw.load(run / f"ref_{case}.npz")["experts/0"]
    B, S, _ = want_idx.shape
    ranks = _ranks(run, case)
    keep = {}
    for arrays, facts in ranks:
        rows = _rows(facts)
        np.testing.assert_array_equal(arrays["experts/0"], want_idx[rows])
        keep.setdefault(facts["token_shard"][0], []).append(
            arrays["keep/0"])
    for index, bits in keep.items():        # a "model" group's ranks agree
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
