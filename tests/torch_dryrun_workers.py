"""Subprocess side of the dry-run CPU tests (``tests/test_torch_dryrun.py``,
``tests/test_torch_step_analysis.py``).

A fake process group (``repro_torch.launch.dryrun.init_fake_group``) set
up inside a test worker would stay with the files that worker runs later,
so every fake-group build runs here, in a subprocess of its own
(``run_suite``: ``python tests/torch_dryrun_workers.py <suite> <out>``),
which writes its results as JSON for the test to compare:

  collectives  rank 37 of the (16, 16) mesh: ``reduce_out``,
               ``gather_dim`` and ``all_to_all`` on the "model" group,
               each counted by ``step_analysis.analyze``
  walk         for one reduced configuration of each family (``WALK``,
               ``config``), its train, prefill and decode cells
               (``CELLS``) on (16, 16) as rank 37, each through
               ``dryrun.run_cell``; and the moe train cell at ``reduced``'s
               4 experts, which "model" = 16 does not split (``PINNED``):
               the sharded step routes the batch across its 16 batch
               ranks there, and the served cells gather their weights
               over "data" a unit at a time
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

RANK = 37
WALK = {"dense": "qwen3-4b", "moe": "deepseek-moe-16b", "ssm": "rwkv6-7b",
        "hybrid": "recurrentgemma-9b", "audio": "whisper-small",
        "vlm": "qwen2-vl-72b"}
CELLS = ("train_4k", "prefill_32k", "decode_32k")
# the moe walk takes 16 experts, so that "model" = 16 splits them as it
# splits the full-width configurations' 64 and 16 (expert parallelism)
MOE_EXPERTS = 16
PINNED = ("moe", "train_4k")
TIMEOUT_S = 240


def config(family: str, cfg, reduced, experts: int = MOE_EXPERTS):
    """The walk's reduced configuration of ``family`` (either package's
    ``cfg`` and ``reduced``)."""
    import dataclasses
    cfg = reduced(cfg)
    if family == "moe":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    return cfg


def collectives() -> dict:
    import torch

    from repro_torch.dist import api as dist
    from repro_torch.launch import dryrun, step_analysis
    from repro_torch.launch.mesh import make_production_mesh
    import torch.distributed as tdist

    dryrun.init_fake_group(256, RANK)
    try:
        mesh = make_production_mesh(device="cpu")
        with dist.use_mesh(mesh) as ctx:
            tp = dist.tp_group(ctx)
            x = torch.empty((4, 32, 64), dtype=torch.bfloat16,
                            device="meta")
            out = {"x_bytes": x.numel() * x.element_size(), "tp": tp.size,
                   "rank": tp.rank}
            for name, fn in (("reduce_out", lambda: dist.reduce_out(x, tp)),
                             ("gather_dim",
                              lambda: dist.gather_dim(x, 1, tp)),
                             ("all_to_all",
                              lambda: dist.all_to_all(x, 1, 2, tp))):
                mc = step_analysis.analyze(fn)
                out[name] = {"bytes": mc.collective_bytes,
                             "breakdown": mc.collective_breakdown,
                             "flops": mc.flops}
        return out
    finally:
        tdist.destroy_process_group()


def walk() -> dict:
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import dryrun

    out = {}
    for family, arch in WALK.items():
        cfg = config(family, get_config(arch), reduced)
        for shape in CELLS:
            out[f"{family}/{shape}"] = dryrun.run_cell(
                arch, shape, False, rank=RANK, verbose=False, cfg=cfg)
    family, shape = PINNED
    out["pinned"] = dryrun.run_cell(WALK[family], shape, False, rank=RANK,
                                    verbose=False,
                                    cfg=reduced(get_config(WALK[family])))
    return out


SUITES = {"collectives": collectives, "walk": walk}


def run_suite(suite: str, tmp_path) -> dict:
    """Runs ``suite`` in a subprocess and returns what it wrote."""
    out = os.path.join(str(tmp_path), f"{suite}.json")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(root, "src"), env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), suite,
                        out], env=env, capture_output=True, text=True,
                       timeout=TIMEOUT_S)
    if r.returncode:
        raise AssertionError(f"suite {suite} failed:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-6000:]}")
    with open(out) as f:
        return json.load(f)


if __name__ == "__main__":
    suite, path = sys.argv[1], sys.argv[2]
    result = SUITES[suite]()
    with open(path, "w") as f:
        json.dump(result, f)
