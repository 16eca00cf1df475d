"""Rank processes of the port's multi-rank CPU tests
(``tests/test_torch_dist_train.py``).

Each rank is a spawned process that joins a gloo process group through a
``FileStore`` in the test's temporary directory (no TCP port, so parallel
test workers cannot collide), builds the port's ``make_cpu_mesh`` and runs
every multi-rank check of the suite in turn, so that the suite spawns
once. It imports only the port; what the parent compares is written to
the output directory: ``rank<r>.json`` (small facts, every rank) and
``<run>.npz`` (full master weights and moments, rank 0).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
SEQ = 32
# run name -> (arch, MoE capacity factor or None, ``reduced`` overrides):
# "deepseek-moe-16b-drops" cuts the capacity so that full experts drop
# slots of every rank; recurrentgemma-9b takes 5 layers, a (rec, rec,
# attn) unit and the (rec, rec) tail, its window (64) above SEQ;
# whisper-small's batches carry seeded encoder frames (``WithFrames``),
# qwen2-vl-72b's seeded patch embeddings and M-RoPE positions
# (``WithPatches``)
RUNS = {"qwen3-4b": ("qwen3-4b", None, {}),
        "rwkv6-7b": ("rwkv6-7b", None, {}),
        "deepseek-moe-16b": ("deepseek-moe-16b", None, {}),
        "deepseek-moe-16b-drops": ("deepseek-moe-16b", 0.5, {}),
        "recurrentgemma-9b": ("recurrentgemma-9b", None,
                              {"num_layers": 5}),
        "whisper-small": ("whisper-small", None, {}),
        "qwen2-vl-72b": ("qwen2-vl-72b", None, {})}
# the image of a reduced vlm batch: 2 x 2 merged patches
VLM_GRID = (2, 2)


class WithFrames:
    """A ``SyntheticLM`` of either package whose batches also carry the
    audio family's encoder input, ``enc_frames`` (B, T, D): standard
    normal float32 frames of the whole global batch, drawn with numpy from
    (``seed``, step), then sliced for the shard as the tokens are. Neither
    package's data pipeline makes frames; the reference's ``input_specs``
    gives their shape."""

    def __init__(self, data, frames: int, d_model: int, seed: int = 0):
        self.data, self.cfg = data, data.cfg
        self.shape, self.seed = (frames, d_model), seed

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        batch = self.data.batch_at(step, shard, num_shards)
        rows = self.cfg.global_batch // num_shards
        rng = np.random.default_rng((self.seed, step))
        frames = rng.standard_normal((self.cfg.global_batch,) + self.shape,
                                     dtype=np.float32)
        batch["enc_frames"] = frames[shard * rows:(shard + 1) * rows]
        return batch


def qwen2vl_positions(batch: int, seq: int, grid) -> np.ndarray:
    """(3, batch, seq) int32 M-RoPE positions in Qwen2-VL's layout
    (arXiv:2409.12191, section 2.1): one image of gh x gw merged patches
    at the front, patch (i, j) at (temporal 0, height i, width j), then
    the text at max + 1, max + 2, ... on all three streams (at a 16 x 16
    grid the text starts at 16)."""
    gh, gw = grid
    P = gh * gw
    if P > seq:
        raise ValueError(f"an image of {P} patches in {seq} tokens")
    i, j = np.divmod(np.arange(P), gw)
    image = np.stack([np.zeros(P, np.int64), i, j])
    start = max(gh, gw)
    text = np.broadcast_to(np.arange(start, start + seq - P), (3, seq - P))
    pos = np.concatenate([image, text], axis=1).astype(np.int32)
    return np.repeat(pos[:, None], batch, axis=1)


class WithPatches:
    """A ``SyntheticLM`` of either package whose batches also carry the vlm
    family's stub vision input: ``patch_embeds`` (B, P, D), standard
    normal float32 rows of the whole global batch drawn with numpy from
    (``seed``, step) and sliced on axis 0 for the shard, and
    ``positions`` (3, B, S) in Qwen2-VL's layout (``qwen2vl_positions``,
    P = gh x gw patches of ``grid``), sliced on axis 1 for the shard. The
    reference's ``input_specs`` gives their shapes; neither package's data
    pipeline makes them."""

    def __init__(self, data, grid, d_model: int, seed: int = 0):
        self.data, self.cfg = data, data.cfg
        self.grid, self.d_model, self.seed = tuple(grid), d_model, seed

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        batch = self.data.batch_at(step, shard, num_shards)
        B, S = self.cfg.global_batch, self.cfg.seq_len
        rows = slice(shard * B // num_shards, (shard + 1) * B // num_shards)
        rng = np.random.default_rng((self.seed, step))
        P = self.grid[0] * self.grid[1]
        patches = rng.standard_normal((B, P, self.d_model), dtype=np.float32)
        batch["patch_embeds"] = patches[rows]
        batch["positions"] = qwen2vl_positions(B, S, self.grid)[:, rows]
        return batch


def run_data(cfg, data):
    """``data`` with encoder frames added where ``cfg`` is the audio
    family's, patch embeddings and M-RoPE positions where it is the vlm
    family's."""
    if cfg.is_encoder_decoder:
        return WithFrames(data, cfg.encoder_seq_len, cfg.d_model)
    if cfg.mrope_sections:
        return WithPatches(data, VLM_GRID, cfg.d_model)
    return data


def run_config(run: str, package):
    """The reduced config of ``run`` from ``package``'s configs (the
    port's ``repro_torch.configs`` or the reference's)."""
    import dataclasses
    arch, cf, overrides = RUNS[run]
    cfg = package.reduced(package.get_config(arch), **overrides)
    if cf is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _full(tree) -> Dict[str, np.ndarray]:
    """Every DTensor leaf gathered in full, as numpy (a collective)."""
    return {k: v.full_tensor().numpy() for k, v in tree.items()}


def _trainer(run: str, init, steps: int, batch: int = 4, seq: int = SEQ,
             ckpt=None, hook=None, microbatch: int = 0):
    import torch
    import repro_torch.configs
    from repro_torch.convert import model_params
    from repro_torch.models.common import Policy
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                                   TrainConfig, Trainer)
    cfg = run_config(run, repro_torch.configs)
    model = model_params(init, cfg, policy=Policy(compute_dtype=torch.float32),
                         device="cpu")
    data = run_data(cfg, SyntheticLM(DataConfig(cfg.vocab_size, seq, batch)))
    return Trainer(model, data, TrainConfig(
        steps=steps, ckpt_interval=3, microbatch=microbatch,
        opt=AdamWConfig(**OPT)), ckpt=ckpt, hook=hook)


class Rank0Restart:
    """Asks for a restart at ``at`` on rank 0 only; records what the
    trainer tells it. ``lose`` runs on rank 1 just before (a replica that
    rank alone lost)."""

    def __init__(self, rank: int, at: int, lose=None):
        self.rank, self.at, self.lose = rank, at, lose
        self.asked = False
        self.restarts = []

    def __call__(self, step, wall_s, metrics) -> bool:
        if step != self.at or self.asked:
            return False
        self.asked = True
        if self.lose is not None and self.rank == 1:
            self.lose()
        return self.rank == 0

    def on_restart(self, step: int) -> None:
        self.restarts.append(step)


def _slow_writer(directory: str):
    """A ``CheckpointManager`` whose writer thread waits half a second
    before it writes: rank 0's asynchronous save is still in flight when
    the restart it is followed by asks every rank for the latest step."""
    from repro_torch.train import CheckpointManager

    class SlowWriter(CheckpointManager):
        def _write(self, *args):
            time.sleep(0.5)
            super()._write(*args)
    return SlowWriter(directory, async_save=True)


def _restart_facts(tr, hook, res) -> dict:
    final = _state(tr)
    return {"final_step": res["final_step"], "restarts": hook.restarts,
            "recovery": tr.last_recovery,
            "steps": [h["step"] for h in res["history"]],
            "history": [{k: h[k] for k in ("step", "loss", "grad_norm",
                                           "lr")} for h in res["history"]],
            "digest": float(sum(np.abs(v).sum() for v in final.values()))}


def _dims(x) -> list:
    return [getattr(p, "dim", None) for p in x.placements]


def _save(out: str, name: str, rank: int, **arrays) -> None:
    if rank == 0:
        np.savez(os.path.join(out, f"{name}.npz"), **arrays)


def _state(tr) -> Dict[str, np.ndarray]:
    arrays = {f"p/{k}": v for k, v in _full(tr.params).items()}
    for m in ("mu", "nu"):
        arrays.update({f"{m}/{k}": v
                       for k, v in _full(tr.opt_state[m]).items()})
    return arrays


def run_rank(rank: int, world: int, store: str, out: str, inits) -> None:
    import torch
    import torch.distributed as tdist
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                             rank=rank, world_size=world)
    try:
        _suite(rank, out, inits)
    finally:
        tdist.destroy_process_group()


def _suite(rank: int, out: str, inits) -> None:
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.dist import api as dist
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.train import CheckpointManager, TieredCheckpointManager

    facts: Dict[str, object] = {"rank": rank}
    mesh = make_cpu_mesh()
    with dist.use_mesh(mesh) as ctx:
        # gather_fsdp drops only "fsdp": (fsdp, tp) on a (4, 1) mesh is
        # Shard(0) on "data" and Shard(1) on the 1-wide "model"
        full = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        axes = {"w": ("fsdp", "tp"), "b": ("fsdp",), "s": ()}
        tree = {"w": full, "b": full[0].clone(), "s": torch.ones(())}
        sh = dist.param_sharding(axes, tree, ctx)
        placed = {k: dist.distribute(v, mesh, sh[k]) for k, v in tree.items()}
        gathered = dist.gather_fsdp(placed, axes)
        facts["gather"] = {       # the dim each mesh dim shards, or None
            "w_before": _dims(placed["w"]),
            "w_after": _dims(gathered["w"]),
            "b_after": _dims(gathered["b"]),
            "values_equal": all(
                torch.equal(gathered[k].full_tensor(), tree[k])
                for k in tree),
            "w_local_shape": list(placed["w"].to_local().shape),
        }
        facts["constraint_plain_is_identity"] = \
            dist.constraint(full, "act_batch", None) is full
        c = dist.constraint(gathered["w"], "fsdp", None)
        facts["constraint_redistributes"] = (
            list(c.placements) == [Shard(0), Replicate()]
            and isinstance(c, DTensor))

        # two Trainer steps of each run, from the reference's weights
        facts["placements_equal"] = {}
        facts["history"] = {}
        for arch in inits:
            tr = _trainer(arch, inits[arch], steps=2)
            want = dist.param_sharding(tr.model.param_axes(), tr.params, ctx)
            ok = all(list(tr.params[n].placements) == want[n]
                     and list(tr.opt_state[m][n].placements) == want[n]
                     for n in want for m in ("mu", "nu"))
            facts["placements_equal"][arch] = ok
            facts["batch_shard"] = list(tr.batch_shard)
            res = tr.run()
            facts["history"][arch] = [
                {k: h[k] for k in ("step", "loss", "grad_norm", "lr")}
                for h in res["history"]]
            _save(out, arch, rank, **_state(tr))

        # gradient accumulation under the mesh: 2 rows a rank, microbatch 1
        for micro in (0, 1):
            tr = _trainer("qwen3-4b", inits["qwen3-4b"], steps=1, batch=8,
                          seq=16, microbatch=micro)
            tr.run()
            _save(out, f"micro{micro}", rank, **_state(tr))

        # elastic: save at step 3 under the mesh; restore it under the
        # mesh into a fresh trainer (each rank keeps its shards)
        ckpt_dir = os.path.join(out, "elastic")
        tr = _trainer("qwen3-4b", inits["qwen3-4b"], steps=3,
                      ckpt=CheckpointManager(ckpt_dir, async_save=False))
        tr.run()
        saved = _state(tr)
        _save(out, "elastic_run", rank, **saved)
        again = _trainer("qwen3-4b", inits["qwen3-4b"], steps=3,
                         ckpt=CheckpointManager(ckpt_dir, async_save=True))
        facts["mesh_restore_step"] = again.restore()
        restored = _state(again)
        facts["mesh_restore_equal"] = all(
            np.array_equal(restored[k], saved[k]) for k in saved)

        # a restart that rank 0 alone asks for at step 2: every rank
        # restores (the fast tiers, every step) and finishes equal
        hook = Rank0Restart(rank, at=2)
        tier = TieredCheckpointManager(os.path.join(out, "restart"),
                                       async_save=True, fast_interval_s=0.0)
        tr = _trainer("qwen3-4b", inits["qwen3-4b"], steps=3, ckpt=tier,
                      hook=hook)
        facts["restart"] = _restart_facts(tr, hook, tr.run())
        _save(out, "restart_run", rank, **_state(tr))

        # the same, but rank 1 has lost its peer replica: the peer tier
        # no longer holds the step on every rank, so every rank restores
        # its own shards from the local tier
        tier = TieredCheckpointManager(os.path.join(out, "restart_local"),
                                       async_save=True, fast_interval_s=0.0)
        hook = Rank0Restart(rank, at=2, lose=tier.drop_peer)
        tr = _trainer("qwen3-4b", inits["qwen3-4b"], steps=3, ckpt=tier,
                      hook=hook)
        facts["restart_local"] = _restart_facts(tr, hook, tr.run())
        _save(out, "restart_local_run", rank, **_state(tr))

        # a restart right after an asynchronous save at step 3: rank 0's
        # writer is still publishing it when every rank asks for the
        # latest step, so the restore must take rank 0's answer after its
        # wait() (the durable tier only)
        hook = Rank0Restart(rank, at=3)
        tr = _trainer("qwen3-4b", inits["qwen3-4b"], steps=4,
                      ckpt=_slow_writer(os.path.join(out, "restart_cold")),
                      hook=hook)
        facts["restart_cold"] = _restart_facts(tr, hook, tr.run())
        _save(out, "restart_cold_run", rank, **_state(tr))

    # the multi-pod layout at four ranks: ("pod", "data", "model") of
    # (2, 2, 1); the batch splits over pod x data, the masters shard over
    # "data" and replicate over "pod"
    from torch.distributed.device_mesh import init_device_mesh
    pod = init_device_mesh("cpu", (2, 2, 1),
                           mesh_dim_names=("pod", "data", "model"))
    with dist.use_mesh(pod) as ctx:
        tr = _trainer("qwen3-4b", inits["qwen3-4b"], steps=2)
        want = dist.param_sharding(tr.model.param_axes(), tr.params, ctx)
        facts["pod"] = {
            "placements_equal": all(
                list(tr.params[n].placements) == want[n] for n in want),
            "wq_dims": _dims(tr.params["layers.0.attn.wq"]),
            "batch_shard": list(tr.batch_shard),
            "history": [{k: h[k] for k in ("step", "loss", "grad_norm")}
                        for h in tr.run()["history"]]}
        _save(out, "pod", rank, **_state(tr))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(facts, f)
