"""The dry run: every (architecture x input shape) cell built as one rank of
the production mesh, its step run and counted, without a card: the port
of ``repro.launch.dryrun``.

For every cell, on the (16, 16) and the (2, 16, 16) mesh, one process:

  - joins a fake process group of 256 or 512 ranks as rank ``--rank``
    (torch's ``FakeStore`` and "fake" backend: collectives are issued and
    seen, nothing is sent) and builds the mesh on it,
  - builds the full-size model on the meta device as that rank builds it
    (its tensor-parallel slices; shapes only, nothing allocated),
  - runs the cell's step through the port's own code on meta inputs of the
    rank's rows: train the ZeRO-3 step (``shard_params``,
    ``init_opt_state``, ``make_train_step``), prefill ``Model.prefill``,
    decode ``Model.decode_step`` on an ``init_cache`` of the rank's rows,
    both served with the working weights sharded over "fsdp" and gathered
    a unit at a time (``models.fsdp.ServeShards``, as the reference passes
    ``param_sharding``'s ``p_sh`` to both); the hand-written kernels run
    as their stand-ins
    (``repro_torch.kernels.meta``), so a shape or placement that does not
    fit raises here,
  - counts the step's FLOPs, memory traffic and collective bytes
    (``repro_torch.launch.step_analysis``), and bounds it on H100 figures
    (``repro_torch.launch.roofline``),
  - sums the rank's exact bytes of working weights, masters, moments,
    caches and batch from the meta tensors' shapes (activations and
    temporaries not counted), and says whether they fit the card's 85.02e9
    bytes; a cell that does not fit is reported, not raised. A served
    cell's "weights" are the rank's shards (in the compute dtype,
    ``weights_dtype``; the reference's dry run holds float32 params) and
    its "gathered" the most weights it held gathered at once (its "in"
    unit, kept through the call, and one other); a training cell's
    "weights" are its working weights, gathered whole over "data".

The reference jits, lowers and compiles each cell (``lower_s``,
``compile_s``, XLA's ``memory_analysis``); the port builds and runs it
(``build_s``, ``step_s``, ``memory``), and ``step_static`` takes the place
of ``hlo_static``. The reference's ``fsdp_gather=False`` baseline (a
GSPMD choice: its params stay sharded and XLA gathers them where it
will) has no counterpart: the port's ZeRO-3 step and its served cells
always gather each unit's working weights just in time, one all-gather
over "data" a unit, which the collective term counts. Every bound is of
a mesh of H100s that no one here has: none of them is a measurement.

Usage (the CPU only; results of ``--all`` in ``build/dryrun/``):
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \
      [--multi-pod] [--rank R]
  python -m repro_torch.launch.dryrun --all     # every cell, a process each
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as tdist
from torch.utils._pytree import tree_flatten

from repro_torch.configs import (applicable_shapes, get_config, get_shape,
                                 list_configs)
from repro_torch.dist import api as dist
from repro_torch.launch import step_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import Roofline, model_flops_for
from repro_torch.models.fsdp import ServeShards, batch_shard
from repro_torch.models.model import Model, input_specs
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.trainer import make_train_step, shard_params

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
CARD_BYTES = 85.02e9          # an H100 80GB HBM3's memory, as torch sees it


def init_fake_group(world: int, rank: int) -> None:
    """This process as rank ``rank`` of a fake process group of ``world``
    ranks. Raises where torch lacks the fake group's store, or where the
    process already has a group: the dry run owns its process's group."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as exc:
        raise RuntimeError(
            "the dry run needs torch's fake process group (torch.testing."
            "_internal.distributed.fake_pg.FakeStore), which this torch "
            "lacks") from exc
    if tdist.is_initialized():
        raise RuntimeError("a process group is already initialised: run each "
                           "dry-run cell in a process of its own")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    tdist.init_process_group("fake", store=FakeStore(), rank=rank,
                             world_size=world)


def batch_rows(ctx: dist.DistContext, global_batch: int) -> int:
    """The rank's rows of a global batch: split over "act_batch" ("pod" and
    "data"), or all of them where they do not divide it (the reference's
    divisibility fallback replicates the batch)."""
    return global_batch // batch_shard(ctx, global_batch)[1]


def _bytes(tree: Any) -> int:
    """Bytes of the tensors in ``tree`` on this rank (a DTensor's local
    shard)."""
    total = 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


@dataclasses.dataclass
class Cell:
    """One rank of a built cell: ``step()`` runs its step under its mesh
    and returns what the step returns."""
    meta: Dict[str, Any]
    cfg: Any
    shape: Any
    step: Callable[[], Any]
    memory: Dict[str, int]
    holder: Optional[ServeShards] = None     # a served cell's weights


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               remat: str = "full", microbatch: int = 0,
               rules_override: Optional[dict] = None, rank: int = 0,
               cfg=None) -> Cell:
    """Sets up rank ``rank`` of one (arch x shape x mesh) cell (see the
    module's docstring); ``cfg`` in place of ``arch``'s configuration (a
    reduced one, in the tests). The caller destroys the process group
    (``run_cell`` does)."""
    cfg = cfg or get_config(arch)
    shape = get_shape(shape_name)
    chips = 512 if multi_pod else 256
    init_fake_group(chips, rank)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    rules = dict(dist.DEFAULT_RULES)
    rules.update(rules_override or {})
    memory: Dict[str, int] = {}
    holder = None
    with dist.use_mesh(mesh, rules) as ctx:
        model = Model(cfg, device="meta", seed=None, remat=remat)
        rows = batch_rows(ctx, shape.global_batch)
        specs = input_specs(cfg, shape, rows=rows, model=model)
        if shape.kind == "train":
            memory["weights"] = _bytes(list(model.parameters()))
        else:
            holder = ServeShards(model, ctx,
                                 batch_shard(ctx, shape.global_batch))
            memory["weights"] = holder.nbytes()
        if shape.kind == "train":
            params = shard_params(model, ctx)
            opt = init_opt_state(params)
            memory["masters"] = _bytes(params)
            memory["moments"] = _bytes((opt["mu"], opt["nu"]))
            train_step = make_train_step(model, AdamWConfig(),
                                         microbatch=microbatch)
            batch = specs["batch"]

            def run():
                return train_step(params, opt, batch)
        elif shape.kind == "prefill":
            batch = specs["batch"]

            def run():
                return model.prefill(
                    batch["tokens"], batch.get("enc_frames"),
                    positions=batch.get("positions"),
                    patch_embeds=batch.get("patch_embeds"))
        else:
            batch = {"tokens": specs["tokens"]}
            cache = specs["cache"]
            memory["cache"] = _bytes(cache)

            def run():
                return model.decode_step(batch["tokens"], cache)
    memory["batch"] = _bytes(batch)

    def step():
        with dist.use_mesh(mesh, rules):
            return run()

    meta = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
            "kind": shape.kind, "rank": rank, "rows": rows,
            "weights_dtype": str(model.policy.compute_dtype).split(".")[-1],
            "reference_weights_dtype": "float32"}
    return Cell(meta, cfg, shape, step, memory, holder)


def cache_shapes(cache, prefix: str = "") -> Dict[str, list]:
    """``{path: shape}`` of the tensors of a cache ("layers.0",
    "units.l0_rec.h", "tail.1.conv", ...); ints ("pos", "kv_shards")
    left out."""
    if isinstance(cache, torch.Tensor):
        return {prefix[:-1]: list(cache.shape)}
    items = cache.items() if isinstance(cache, dict) else enumerate(cache) \
        if isinstance(cache, (list, tuple)) else ()
    out: Dict[str, list] = {}
    for key, val in items:
        out.update(cache_shapes(val, f"{prefix}{key}."))
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             remat: str = "full", microbatch: int = 0, rank: int = 0,
             verbose: bool = True, cfg=None) -> dict:
    """Builds rank ``rank`` of the cell, runs and counts its step, and
    returns the result (the reference's keys; see the module's
    docstring; ``cfg`` as ``build_cell``'s). The process group is
    destroyed on the way out."""
    try:
        t0 = time.time()
        cell = build_cell(arch, shape_name, multi_pod, remat, microbatch,
                          rank=rank, cfg=cfg)
        t_build = time.time() - t0
        result = {}
        t0 = time.time()
        mc = step_analysis.analyze(
            lambda: result.setdefault("out", cell.step()))
        t_step = time.time() - t0
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    memory = dict(cell.memory)
    cache = {} if cell.shape.kind == "train" else result["out"][1]
    if cell.shape.kind == "prefill":
        memory["cache"] = _bytes(cache)
    if cell.holder is not None:
        memory["gathered"] = cell.holder.peak
    memory["total"] = sum(memory.values())
    memory["fits"] = memory["total"] <= CARD_BYTES
    chips = cell.meta["chips"]
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=cell.meta["mesh"], chips=chips,
        hlo_flops=mc.flops * chips, hlo_bytes=mc.traffic_bytes * chips,
        hlo_bytes_lower=mc.dot_traffic_bytes * chips,
        coll_bytes_per_chip=mc.collective_bytes,
        coll_breakdown=dict(mc.collective_breakdown),
        model_flops=model_flops_for(cell.cfg, cell.shape),
        peak_mem_bytes=float(memory["total"]))
    out = {**cell.meta, "build_s": t_build, "step_s": t_step,
           "memory": memory, "cache_shapes": cache_shapes(cache),
           "step_static": {
               "flops_per_chip": mc.flops,
               "traffic_per_chip": mc.traffic_bytes,
               "traffic_upper_per_chip": mc.traffic_bytes_upper,
               "dot_traffic_per_chip": mc.dot_traffic_bytes,
               "flops_by_comp": mc.flops_by_comp,
               "coll_by_comp": mc.coll_by_comp,
               "kernel_calls": mc.kernel_calls,
               "kernel_flops_per_chip": mc.kernel_flops,
               "kernel_bytes_per_chip": mc.kernel_bytes},
           "roofline": rl.to_dict()}
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} on {cell.meta['mesh']} "
              f"(rank {rank}, {cell.meta['rows']} rows): build "
              f"{t_build:.1f}s step {t_step:.1f}s")
        print(f"  memory/rank: weights {memory['weights'] / 1e9:.2f} GB, "
              f"total {memory['total'] / 1e9:.2f} GB "
              f"({'fits' if memory['fits'] else 'does NOT fit'} "
              f"{CARD_BYTES / 1e9:.2f})")
        print(f"  FLOPs/rank {mc.flops:.3e}  traffic/rank "
              f"{mc.traffic_bytes:.3e} (matmul-only "
              f"{mc.dot_traffic_bytes:.3e})  coll bytes/rank "
              f"{mc.collective_bytes:.3e}")
        print(f"  roofline: compute {rl.compute_s * 1e3:.1f} ms | memory "
              f"{rl.memory_s * 1e3:.1f} ms | collective "
              f"{rl.collective_s * 1e3:.1f} ms -> {rl.dominant}-bound, "
              f"useful {rl.useful_ratio:.2f}, roofline-fraction "
              f"{rl.roofline_fraction:.2f}")
    return out


def cells():
    """Every (arch, shape, multi_pod) of the walk: 32 pairs x 2 meshes."""
    out = []
    for arch in list_configs():
        for shp in applicable_shapes(get_config(arch)):
            for mp in (False, True):
                out.append((arch.replace("_", "-"), shp, mp))
    return out


def _run_all(args) -> int:
    results = Path(args.out)
    results.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    todo = cells()
    failures = []
    print(f"[dryrun] {len(todo)} cells")
    t_all = time.time()
    for arch, shp, mp in todo:
        tag = f"{arch}__{shp}__{'multi' if mp else 'single'}"
        path = results / f"{tag}.json"
        if args.resume and path.exists():
            print(f"[dryrun] skip {tag} (cached)")
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shp, "--json", str(path),
               "--rank", str(args.rank), "--remat", args.remat,
               "--microbatch", str(args.microbatch)]
        if mp:
            cmd.append("--multi-pod")
        t0 = time.time()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout, env=env)
            ok, tail = r.returncode == 0, r.stdout[-2000:] + "\n" + \
                r.stderr[-4000:]
        except subprocess.TimeoutExpired:
            ok, tail = False, f"timed out after {args.timeout} s\n"
        print(f"[dryrun] {tag}: {'OK' if ok else 'FAIL'} "
              f"({time.time() - t0:.1f}s)", flush=True)
        if not ok:
            failures.append(tag)
            sys.stdout.write(tail)
    print(f"[dryrun] done: {len(todo) - len(failures)}/{len(todo)} OK in "
          f"{time.time() - t_all:.1f}s")
    for f in failures:
        print("  FAILED:", f)
    print(summary(results))
    return 1 if failures else 0


def summary(results: Path) -> str:
    """A markdown table of the results in ``results``, a row per (arch,
    shape) with the (16, 16) and (2, 16, 16) cells side by side: the
    rank's bytes and whether they fit, its FLOPs, the three roofline terms
    and the dominant one."""
    rows = ["| cell | GB a rank | fits | TFLOP a rank | compute ms | "
            "memory ms | collective ms | bound by |",
            "|---|---|---|---|---|---|---|---|"]
    for arch, shp, mp in cells():
        if mp:
            continue
        got = []
        for tag in ("single", "multi"):
            path = results / f"{arch}__{shp}__{tag}.json"
            got.append(json.loads(path.read_text()) if path.exists()
                       else None)
        if None in got:
            rows.append(f"| {arch} {shp} | missing |||||||")
            continue

        def pair(fn):
            return " / ".join(fn(r) for r in got)
        rl = [r["roofline"] for r in got]
        rows.append(
            f"| {arch} {shp} | "
            + pair(lambda r: f"{r['memory']['total'] / 1e9:.2f}") + " | "
            + pair(lambda r: "yes" if r["memory"]["fits"] else "NO") + " | "
            + pair(lambda r: f"{r['step_static']['flops_per_chip'] / 1e12:.2f}")
            + " | " + " | ".join(
                " / ".join(f"{x[k] * 1e3:.1f}" for x in rl)
                for k in ("compute_s", "memory_s", "collective_s"))
            + " | " + " / ".join(x["dominant"] for x in rl) + " |")
    return "\n".join(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the mesh this process builds")
    ap.add_argument("--json", help="write the cell result to this path")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="--all: the directory of the results")
    ap.add_argument("--resume", action="store_true",
                    help="--all: skip cells with results")
    ap.add_argument("--timeout", type=int, default=3000)
    args = ap.parse_args(argv)

    if args.all:
        return _run_all(args)
    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required (or use --all)")

    out = run_cell(args.arch, args.shape, args.multi_pod, args.remat,
                   args.microbatch, rank=args.rank)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
