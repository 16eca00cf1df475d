"""Reference run and rank processes of
``tests/test_torch_moe_route_across.py``: two ``Trainer`` steps of a moe
model whose experts "model" does not split, at ("data", "model") = (2,
2).

The weights are the port's seed-0 draw of reduced deepseek-moe-16b with 3
experts and its capacity cut to 0.5 (``config``), written as the
reference's tree (``init.npz``). The reference runs in a subprocess that
sees four CPU devices (``python tests/torch_moe_route_workers.py <out>``):
its ``Trainer`` under its (2, 2) mesh, its parameters and AdamW state set
to those weights, takes two steps and writes its history and every master
weight and moment after each step (``ref.npz``, ``ref.json``, by the
port's parameter names) and the experts of its first MoE call (step 1's
forward). Each of the four gloo ranks (``torch_tp_workers.spawn_ranks``,
suite "route") builds the port's ``Trainer`` under its (2, 2) mesh from
the same weights, records the experts and keep bits of its first MoE call
(``torch_tp_workers._MoERecord``), takes the two steps and writes its
history and its batch shard (``rank<r>.json``, ``rank<r>.npz``); rank 0
also every master weight and moment after each step (``step1.npz``,
``step2.npz``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

import torch_tp_workers as tpw

ARCH, EXPERTS, CAPACITY = "deepseek-moe-16b", 3, 0.5
MESH = (2, 2)
SEQ, BATCH, STEPS = tpw.SEQ, tpw.BATCH, 2
OPT = tpw.OPT


def config(package):
    import dataclasses
    cfg = package.reduced(package.get_config(ARCH))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=EXPERTS, capacity_factor=CAPACITY))


def write_init(out: str) -> None:
    import torch
    import repro_torch.configs
    from repro_torch.convert import reference_tree
    from repro_torch.models.common import Policy
    from repro_torch.models.model import Model
    model = Model(config(repro_torch.configs),
                  Policy(compute_dtype=torch.float32), device="cpu", seed=0)
    named = {n: p.detach().numpy().copy()
             for n, p in model.named_parameters()}
    np.savez(os.path.join(out, "init.npz"),
             **tpw._flat(reference_tree(named)))


def _reference(out: str) -> None:
    import jax
    import jax.numpy as jnp

    import repro.configs
    from repro.dist import api as jax_dist
    from repro.launch.mesh import _make_mesh
    from repro.models import moe as jax_moe
    from repro.models.common import Policy
    from repro.models.model import Model
    from repro.train import (AdamWConfig, DataConfig, SyntheticLM,
                             TrainConfig, Trainer)
    from repro.train.optimizer import init_opt_state
    from repro_torch.convert import named_params

    routes: list = []
    orig_route = jax_moe._route

    def route(router_w, x, E, k):
        w, idx, aux = orig_route(router_w, x, E, k)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)), idx)
        return w, idx, aux
    jax_moe._route = route

    cfg = config(repro.configs)
    depth = tpw.depth_of(cfg)
    jm = Model(cfg, Policy(compute_dtype=jnp.float32))
    data = SyntheticLM(DataConfig(cfg.vocab_size, SEQ, BATCH))
    mesh = _make_mesh(MESH, ("data", "model"))
    arrays = {}

    def state(tr, tag):
        for key, tree in (("p", tr.params), ("mu", tr.opt_state["mu"]),
                          ("nu", tr.opt_state["nu"])):
            for name, v in named_params(jax.tree.map(np.asarray, tree),
                                        depth).items():
                arrays[f"{tag}/{key}/{name}"] = v
    with mesh, jax_dist.use_mesh(mesh):
        tr = Trainer(jm, data, TrainConfig(steps=STEPS, ckpt_interval=100,
                                           opt=AdamWConfig(**OPT)), seed=0)
        tr.params = jax.tree.map(jnp.asarray, tpw.nested(tpw.load(
            os.path.join(out, "init.npz"))))
        tr.opt_state = init_opt_state(tr.params)
        hist = tr.run(lambda step, _: step == 1 and state(tr, "step1"))
        jax.effects_barrier()
        state(tr, "step2")
    arrays["experts"] = routes[0]
    np.savez(os.path.join(out, "ref.npz"), **arrays)
    with open(os.path.join(out, "ref.json"), "w") as f:
        json.dump([{k: float(h[k]) for k in ("step", "loss", "grad_norm",
                                             "lr")} for h in hist["history"]],
                  f)


def run(out: str) -> None:
    """``write_init``, then the reference's subprocess and the four ranks
    side by side."""
    write_init(out)
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"), here] +
        [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), out],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        tpw.spawn_ranks(out, "route")
    finally:
        tpw.finish(proc)


def route_suite(rank: int, out: str) -> None:
    import torch
    import repro_torch.configs
    from repro_torch.convert import model_params
    from repro_torch.dist import api as dist
    from repro_torch.models.common import Policy
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                                   TrainConfig, Trainer)

    cfg = config(repro_torch.configs)
    init = tpw.nested(tpw.load(os.path.join(out, "init.npz")))
    with dist.use_mesh(tpw.mesh_of(MESH)):
        model = model_params(init, cfg,
                             policy=Policy(compute_dtype=torch.float32),
                             device="cpu")
        tr = Trainer(model, SyntheticLM(DataConfig(cfg.vocab_size, SEQ,
                                                   BATCH)),
                     TrainConfig(steps=STEPS, ckpt_interval=100,
                                 opt=AdamWConfig(**OPT)))

        def after(step, _):
            state = tpw.state_of(tr)        # a collective: every rank
            if rank == 0:
                np.savez(os.path.join(out, f"step{step}.npz"), **state)
        record = tpw._MoERecord()
        try:
            hist = tr.run(after)["history"]
        finally:
            record.close()
        np.savez(os.path.join(out, f"rank{rank}.npz"),
                 experts=record.experts[0], keep=record.keep[0])
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"batch_shard": list(tr.batch_shard),
                       "model_rank": model.tp.rank,
                       "history": [{k: h[k] for k in ("step", "loss",
                                                      "grad_norm", "lr")}
                                   for h in hist]}, f)


if __name__ == "__main__":
    _reference(sys.argv[1])
