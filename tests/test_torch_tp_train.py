"""The port's sharded training step under tensor parallelism, in four gloo
ranks on the CPU, against the port's single-process step.

One spawn of four gloo ranks (``tests/torch_tp_workers.py``, suite
"train") runs two float32 ``Trainer`` steps of each run of
``torch_tp_workers.TRAIN`` from the port's seed-0 weights (every rank
draws them whole and keeps its tensor-parallel slice): reduced qwen3-4b
under ("data", "model") of (2, 2) and ("pod", "data", "model") of (1, 2,
2); reduced qwen3-4b with one KV head at (2, 2), whose KV masters split
over "model" while every rank computes with all of them (the ZeRO-3
gather also gathers them over "model" and cuts their gradients to the
rank's slice); reduced qwen2-vl-72b at (2, 2) with a 2 x 2 image. The
batch (4 x 32) splits over "data" (and "pod"); the masters and moments
split over "data" and "model". No reference subprocess runs here: the
single-process step is held to the JAX package by
``tests/test_torch_train.py`` and ``tests/test_torch_vlm_train.py``, and
the tensor-parallel loss and gradients by ``tests/test_torch_tp.py``.

Limits, ``tests/test_torch_dist_train.py``'s: losses and gradient norms
within 1e-5 (relative) of the single-process run's; every moment within
1e-4 of its leaf's largest magnitude, and every master weight too but
for at most 1 in 10^4 entries, none by more than 5 % of the summed
learning rate; every master's and moment's placements equal
``param_sharding``'s. A checkpoint of step 2 at (2, 2) restores under the
mesh bit for bit from the durable tier (each leaf gathered to rank 0 over
both axes) and from the fast local tier (each rank's own shards). Under
a "model" axis of 4 the audio, ssm and hybrid families build, each
parameter the "model" slice ``param_sharding`` gives its master, or whole
(their steps: ``tests/test_torch_tp_{ssm,hybrid,audio}.py``).
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.configs
import torch_tp_workers as workers
from repro_torch.models.common import Policy
from repro_torch.models.model import Model
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                               TrainConfig, Trainer)
from torch_dist_workers import run_data

RUNS = tuple(workers.TRAIN)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_train")
    workers.spawn_ranks(out, "train")
    facts = [json.loads((out / f"train_rank{r}.json").read_text())
             for r in range(4)]
    return {"out": out, "facts": facts}


def _single(run_name):
    cfg = workers.train_config(run_name, repro_torch.configs)
    model = Model(cfg, Policy(compute_dtype=torch.float32), device="cpu",
                  seed=0)
    data = run_data(cfg, SyntheticLM(DataConfig(cfg.vocab_size,
                                                workers.SEQ, 4)))
    tr = Trainer(model, data, TrainConfig(
        steps=workers.TRAIN_STEPS, ckpt_interval=100,
        opt=AdamWConfig(**workers.OPT)))
    hist = tr.run()["history"]
    state = {f"p/{k}": v.detach().numpy() for k, v in tr.params.items()}
    for m in ("mu", "nu"):
        state.update({f"{m}/{k}": v.numpy()
                      for k, v in tr.opt_state[m].items()})
    return hist, state


@pytest.mark.parametrize("run_name", RUNS)
def test_trainer_steps_match_single_process(run, run_name):
    single_hist, want = _single(run_name)
    hist = run["facts"][0][run_name]["history"]
    assert [h["step"] for h in hist] == [1, 2]
    for f in run["facts"][1:]:              # the metrics are global means
        assert f[run_name]["history"] == hist
    for h, sh in zip(hist, single_hist):
        assert h["loss"] == pytest.approx(sh["loss"], rel=1e-5)
        assert h["grad_norm"] == pytest.approx(sh["grad_norm"], rel=1e-5)
        assert h["lr"] == sh["lr"]
    got = workers.load(run["out"] / f"{run_name}.npz")
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


@pytest.mark.parametrize("run_name", RUNS)
def test_placements_and_batch_shards(run, run_name):
    """Masters and moments placed by ``param_sharding``, over "model" too
    (the attention's, the MLP's, the vocabulary's); the batch split over
    the batch axes only."""
    shape = workers.TRAIN[run_name][1]
    data = shape[-2] * (shape[0] if len(shape) == 3 else 1)
    for f in run["facts"]:
        r = f[run_name]
        assert r["placements_equal"]
        assert {"embed.tok", "layers.0.attn.wq", "layers.0.attn.wk",
                "layers.0.mlp.wo"} <= set(r["model_split"])
        assert r["batch_shard"][1] == data
    kv1 = run["facts"][0]["qwen3-4b-kv1@2x2"]
    assert "layers.0.attn.wk" not in kv1["tp_dims"]     # whole on each rank
    assert "layers.0.attn.wk" in kv1["model_split"]     # its master split


@pytest.mark.parametrize("tier", ["durable", "local"])
def test_checkpoint_restores_bit_for_bit_at_2x2(run, tier):
    for f in run["facts"]:
        ck = f[f"ckpt_{tier}"]
        assert ck["step"] == 2 and ck["equal"]
        assert ck["tier"] == ("cold" if tier == "durable" else "local")


@pytest.mark.parametrize("arch", ["whisper-small", "rwkv6-7b",
                                  "recurrentgemma-9b"])
def test_families_build_under_model_4_with_param_sharding_shapes(run, arch):
    """The audio, ssm and hybrid families build under a "model" axis of 4:
    each parameter is the slice of its whole shape that ``param_sharding``
    gives its master on "model", or, where the model computes with all of
    it, the whole (the ZeRO-3 step then gathers its master over "model");
    at least the attention's query heads, the MLP's ff and the vocabulary
    split."""
    for f in run["facts"]:
        built = f["builds"][arch]
        split = 0
        for name, (shape, whole, dim) in built.items():
            want = list(whole)
            if dim is not None and shape != whole:
                want[dim] //= 4
                split += 1
            assert shape == want, name
        assert split >= 3, arch
