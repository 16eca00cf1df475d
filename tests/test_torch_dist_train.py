"""The port's sharded training step in four ranks on the CPU, against the
port's single-process step and the JAX package.

One spawn of four gloo ranks (``tests/torch_dist_workers.py``: a
``FileStore`` in the test's temporary directory, a join limit of
``JOIN_S``) runs reduced qwen3-4b, rwkv6-7b, deepseek-moe-16b (also
with its capacity factor cut to 0.5, so that full experts drop slots),
recurrentgemma-9b (5 layers: a unit and the tail, whose ZeRO-3 units
are "units.0" and "tail"), whisper-small (2 encoder and 2 decoder
layers, whose batches carry seeded encoder frames, ``workers.WithFrames``)
and qwen2-vl-72b (2 layers, whose batches carry seeded patch embeddings
and M-RoPE positions of a 2 x 2 image, ``workers.WithPatches``;
``workers.RUNS``) from the reference's weights,
float32,
``DataConfig(vocab, 32, 4)`` (one sequence a rank), two ``Trainer`` steps
under ``make_cpu_mesh()`` of (4, 1), the plain versions of the kernels.
The reference routes the whole batch in one call; the port's ranks
route it as one through a count all-gather (``models.moe``), so the
capacity cut falls on the same slots. Limits:

- the loss of each step against the reference's ``Trainer`` under its
  one-device CPU mesh: 1e-4 relative, the reference's own
  ``TestShardedEquivalence`` limit;
- the loss against the port's single-process run: 1e-5 relative; every
  moment within 1e-4 of its leaf's largest magnitude, and every master
  weight too but for at most 1 in 10^4 entries (none by more than 5 % of
  the summed learning rate), where AdamW's ratio m / (sqrt(v) + eps) is
  ill-conditioned (``test_two_trainer_steps_match_reference``'s
  allowance);
- every master's and moment's placements equal ``param_sharding``'s;
- gradient accumulation under the mesh (two rows a rank, microbatch 1)
  against the same step without it: 1e-5 of each leaf's largest
  magnitude;
- elastic (the port of ``tests/test_elastic.py``): a checkpoint saved at
  step 3 under four ranks restores under the mesh bit for bit, and twice
  in one process without a mesh, bit-equal, and trains on to step 5;
- a restart that rank 0 alone asks for at step 2 makes every rank restore
  from the peer tier, and all four finish with the master weights and
  moments of the uninterrupted run, bit for bit; where rank 1 alone has
  lost its peer replica, every rank restores its own shards from the
  local tier, bit for bit too;
- a restart that rank 0 asks for right after an asynchronous save at
  step 3, whose writer thread is slowed to be still publishing it: every
  rank restores step 3 from the durable tier, and the four finish equal,
  within the limits above of the single-process run of four steps;
- the multi-pod layout, ("pod", "data", "model") of (2, 2, 1): the batch
  split over pod x data, the masters sharded over "data" and replicated
  over "pod", two qwen3-4b steps within the limits above of the
  single-process run.
"""
import json
import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs
import repro_torch.configs
from repro.dist import api as jax_dist
from repro.launch.mesh import make_cpu_mesh as jax_cpu_mesh
from repro.models.common import Policy as JaxPolicy
from repro.models.model import Model as JaxModel
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import DataConfig as JaxDataConfig
from repro.train import SyntheticLM as JaxSyntheticLM
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro_torch.configs import get_config, reduced
from repro_torch.convert import model_params
from repro_torch.models.common import Policy
from repro_torch.train import (AdamWConfig, CheckpointManager, DataConfig,
                               SyntheticLM, TrainConfig, Trainer)

import torch_dist_workers as workers

WORLD = 4
JOIN_S = 120.0
ARCHS = tuple(workers.RUNS)


def _reference(arch):
    """The reference's initial weights (numpy) and its two steps' history
    under its one-device CPU mesh."""
    jcfg = workers.run_config(arch, repro.configs)
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=jnp.float32))
    data = workers.run_data(jcfg, JaxSyntheticLM(
        JaxDataConfig(jcfg.vocab_size, workers.SEQ, WORLD)))
    mesh = jax_cpu_mesh()
    with mesh, jax_dist.use_mesh(mesh):
        ref = JaxTrainer(jm, data, JaxTrainConfig(
            steps=2, ckpt_interval=100,
            opt=JaxAdamWConfig(**workers.OPT)), seed=0)
        init = jax.tree.map(lambda x: np.array(x, copy=True), ref.params)
        hist = ref.run()["history"]
    return init, hist


def _single(arch, init, steps=2):
    model = model_params(init, workers.run_config(arch, repro_torch.configs),
                         policy=Policy(compute_dtype=torch.float32),
                         device="cpu")
    data = workers.run_data(model.cfg, SyntheticLM(
        DataConfig(model.cfg.vocab_size, workers.SEQ, WORLD)))
    tr = Trainer(model, data, TrainConfig(steps=steps, ckpt_interval=100,
                                          opt=AdamWConfig(**workers.OPT)))
    return tr, tr.run()["history"]


def _spawn(out, inits):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=workers.run_rank,
                         args=(r, WORLD, str(out / "store"), str(out), inits))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"rank exit codes {codes}"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("four_ranks")
    refs = {arch: _reference(arch) for arch in ARCHS}
    _spawn(out, {arch: refs[arch][0] for arch in ARCHS})
    facts = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(WORLD)]

    def arrays(name):
        with np.load(out / f"{name}.npz") as z:
            return {k: z[k] for k in z.files}
    return {"out": out, "refs": refs, "facts": facts, "arrays": arrays}


def _state(tr):
    st = {f"p/{k}": v.detach().numpy() for k, v in tr.params.items()}
    for m in ("mu", "nu"):
        st.update({f"{m}/{k}": v.numpy()
                   for k, v in tr.opt_state[m].items()})
    return st


def _hold_to_single(got, hist, single_hist, want):
    """Losses and gradient norms within 1e-5 of the single-process run's;
    moments within 1e-4 of each leaf's largest magnitude, master weights
    too but for <= 1 in 10^4 entries, none by more than 5 % of the summed
    learning rate."""
    for h, sh in zip(hist, single_hist):
        assert h["loss"] == pytest.approx(sh["loss"], rel=1e-5)
        assert h["grad_norm"] == pytest.approx(sh["grad_norm"], rel=1e-5)
    assert sorted(got) == sorted(want)
    lr_sum = sum(h["lr"] for h in single_hist)
    outside = total = 0
    for key, w in want.items():
        d = np.abs(got[key] - w)
        tol = 1e-4 * float(np.abs(w).max())
        if key.startswith("p/"):
            assert float(d.max()) <= tol + 0.05 * lr_sum, key
            outside += int((d > tol).sum())
            total += d.size
        else:
            assert float(d.max()) <= tol, key
    assert outside <= 1e-4 * total, (outside, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_four_rank_steps_match_reference_and_single_process(run, arch):
    init, ref_hist = run["refs"][arch]
    tr, single_hist = _single(arch, init)
    hist = run["facts"][0]["history"][arch]
    assert [h["step"] for h in hist] == [1, 2]
    for h, rh, sh in zip(hist, ref_hist, single_hist):
        assert h["loss"] == pytest.approx(rh["loss"], rel=1e-4)
        assert h["lr"] == sh["lr"]
    for f in run["facts"][1:]:           # the metrics are global means
        assert f["history"][arch] == hist
    _hold_to_single(run["arrays"](arch), hist, single_hist, _state(tr))


def test_pod_mesh_steps_match_single_process(run):
    tr, single_hist = _single("qwen3-4b", run["refs"]["qwen3-4b"][0])
    hist = run["facts"][0]["pod"]["history"]
    assert [h["step"] for h in hist] == [1, 2]
    for f in run["facts"]:
        pod = f["pod"]
        assert pod["placements_equal"] and pod["history"] == hist
        # ("fsdp", "heads"): Replicate on "pod", Shard(0) on "data", and
        # Shard(1) on the 1-wide "model"
        assert pod["wq_dims"] == [None, 0, 1]
        assert pod["batch_shard"] == [f["rank"], WORLD]
    _hold_to_single(run["arrays"]("pod"), hist, single_hist, _state(tr))


def test_masters_and_moments_take_param_shardings_placements(run):
    for f in run["facts"]:
        assert f["placements_equal"] == {arch: True for arch in ARCHS}
        assert f["batch_shard"] == [f["rank"], WORLD]


def test_gather_fsdp_drops_only_fsdp_across_ranks(run):
    for f in run["facts"]:
        g = f["gather"]
        # (fsdp, tp) on (data 4, model 1): Shard(0), Shard(1); gathered:
        # Replicate, Shard(1)
        assert g["w_before"] == [0, 1]
        assert g["w_local_shape"] == [2, 8]
        assert g["w_after"] == [None, 1]
        assert g["b_after"] == [None, None]
        assert g["values_equal"]
        assert f["constraint_plain_is_identity"]
        assert f["constraint_redistributes"]


def test_microbatch_accumulation_under_the_mesh(run):
    full, micro = run["arrays"]("micro0"), run["arrays"]("micro1")
    for key, w in full.items():
        err = float(np.abs(micro[key] - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), key


def test_elastic_restore_across_topologies(run):
    """Saved at step 3 under four ranks; restored under the mesh, and
    twice in one process without one."""
    for f in run["facts"]:
        assert f["mesh_restore_step"] == 3 and f["mesh_restore_equal"]
    init = run["refs"]["qwen3-4b"][0]
    saved = run["arrays"]("elastic_run")
    d = str(run["out"] / "elastic")
    trs = []
    for _ in range(2):
        model = model_params(init, reduced(get_config("qwen3-4b")),
                             policy=Policy(compute_dtype=torch.float32),
                             device="cpu")
        data = SyntheticLM(DataConfig(model.cfg.vocab_size, workers.SEQ,
                                      WORLD))
        tr = Trainer(model, data, TrainConfig(
            steps=5, ckpt_interval=3, opt=AdamWConfig(**workers.OPT)),
            ckpt=CheckpointManager(d, async_save=False))
        assert tr.restore() == 3
        trs.append(tr)
    a, b = _state(trs[0]), _state(trs[1])
    for key in saved:
        np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a[key], saved[key])
    out = trs[0].run()
    assert out["final_step"] == 5
    assert [h["step"] for h in out["history"]] == [4, 5]
    assert all(np.isfinite(h["loss"]) for h in out["history"])


def test_rank0_restart_leaves_every_rank_equal(run):
    facts = [f["restart"] for f in run["facts"]]
    for f in facts:
        assert f["final_step"] == 3
        assert f["restarts"] == [2]          # every rank restored, at 2
        assert f["recovery"]["ckpt_tier"] == "peer"
        assert f["steps"] == [1, 2, 3]
        assert f["digest"] == facts[0]["digest"]
    got, want = run["arrays"]("restart_run"), run["arrays"]("elastic_run")
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_local_tier_restart_when_one_rank_lost_its_peer_replica(run):
    facts = [f["restart_local"] for f in run["facts"]]
    for f in facts:
        assert f["final_step"] == 3 and f["restarts"] == [2]
        assert f["recovery"]["ckpt_tier"] == "local"
        assert f["steps"] == [1, 2, 3]
        assert f["digest"] == facts[0]["digest"]
    got = run["arrays"]("restart_local_run")
    want = run["arrays"]("elastic_run")
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_cold_restart_after_an_async_save_leaves_every_rank_equal(run):
    facts = [f["restart_cold"] for f in run["facts"]]
    for f in facts:
        assert f["final_step"] == 4
        assert f["restarts"] == [3]          # not 0: every rank saw step 3
        assert f["recovery"]["ckpt_tier"] == "cold"
        assert f["steps"] == [1, 2, 3, 4]
        assert f["history"] == facts[0]["history"]
        assert f["digest"] == facts[0]["digest"]
    tr, single_hist = _single("qwen3-4b", run["refs"]["qwen3-4b"][0],
                              steps=4)
    _hold_to_single(run["arrays"]("restart_cold_run"), facts[0]["history"],
                    single_hist, _state(tr))
