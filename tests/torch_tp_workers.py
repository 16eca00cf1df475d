"""Reference runs and rank processes of the port's tensor-parallel CPU tests
(``tests/test_torch_tp.py``, ``test_torch_tp_moe.py``,
``test_torch_tp_train.py``).

The parameters of each case are the port's seed-0 draw, its q/k/v biases
drawn from N(0, 0.5^2) so that they count, written as the reference's
tree to ``init_<case>.npz`` (``write_inits``). The reference side runs in
one subprocess per test file (``python tests/torch_tp_workers.py <suite>
<out>``, started by ``start_reference`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` so that JAX sees
four CPU devices) while the ranks run: for each case it runs the reduced
model unsharded and under each of the case's meshes, built with
``repro.launch.mesh._make_mesh`` (``train_loss``, and where ``SERVED``
says so its gradients, ``prefill``, a decode step after it, decode
steps from an empty cache, the experts each MoE call chose and the
``BatchedServer``'s tokens), writing ``ref_<case>.npz`` and
``ref.json``.

The port side is one spawn of four gloo ranks per test file
(``spawn_ranks``, as ``tests/torch_dist_workers.py``: a ``FileStore`` in
the test's temporary directory, ``torch.set_num_threads(1)``). A rank
imports only the port, builds each case's model under its mesh from the
reference's parameters (``convert.model_params`` keeps the rank's
tensor-parallel slice) and writes what it computed: ``<case>_rank<r>.npz``
(its loss, its own gradients, the whole logits, its slice of the caches)
and ``<case>_rank<r>.json`` (its "model" coordinate, the split dim of
each parameter, the cache layout, the server's tokens). A (1, 2) case runs
on the four ranks' (2, 2) mesh: a plain ``train_loss``, ``prefill`` or
``decode_step`` call does not split its batch over "data", so each of the
mesh's two "model" groups is a (1, 2) run.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

SEQ, BATCH = 32, 4
CACHE_LEN, DECODE_FROM, DECODE_STEPS = SEQ, 14, 3
SERVER = dict(requests=6, slots=4, cache_len=64)
JOIN_S = 150.0
REFERENCE_S = 300.0

# case -> (arch, the port's mesh, the reference's meshes, ``reduced``
# overrides, MoE capacity factor or None)
DENSE = {
    "qwen3-4b@2x2": ("qwen3-4b", (2, 2), ((1, 2), (2, 2)), {}, None),
    # 2 KV heads on 4 ranks: K/V replicate
    "qwen3-4b@1x4": ("qwen3-4b", (1, 4), ((1, 4),), {}, None),
    # 6 query heads on 4 ranks: the query rows split instead
    "qwen3-4b-h6@1x4": ("qwen3-4b", (1, 4), ((1, 4),), {"num_heads": 6},
                        None),
    "qwen2-vl-72b@2x2": ("qwen2-vl-72b", (2, 2), ((1, 2),), {}, None),
}
MOE = {
    "deepseek-moe-16b@2x2": ("deepseek-moe-16b", (2, 2), ((1, 2),), {},
                             None),
    "deepseek-moe-16b@1x4": ("deepseek-moe-16b", (1, 4), ((1, 4),), {},
                             None),
    # capacity cut: full experts drop slots on every rank
    "deepseek-moe-16b-drops@1x4": ("deepseek-moe-16b", (1, 4), ((1, 4),),
                                   {}, 0.5),
}
SUITES = {"dense": DENSE, "moe": MOE}
# what the reference runs beyond the loss and its gradients: the dense
# family's port is held to the unsharded prefill, decode and server (a
# mesh does not change them), the moe family's to the mesh run's
SERVED = {"dense": ("plain",), "moe": ("mesh",)}
DECODE_TOKENS = [[7, 11, 13, 17], [19, 23, 29, 31], [37, 41, 43, 47],
                 [53, 59, 61, 67]]


def case_config(case: str, package):
    """The reduced config of ``case`` from ``package``'s configs."""
    import dataclasses
    arch, _, _, overrides, cf = {**DENSE, **MOE}[case]
    cfg = package.reduced(package.get_config(arch), **overrides)
    if cf is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def case_batch(cfg, data_cls, config_cls) -> dict:
    """Step 0's batch of ``SyntheticLM(DataConfig(vocab, SEQ, BATCH))``
    (either package's), with the vlm family's image and positions."""
    from torch_dist_workers import run_data
    return run_data(cfg, data_cls(config_cls(cfg.vocab_size, SEQ,
                                             BATCH))).batch_at(0)


def mesh_tag(shape) -> str:
    return "x".join(str(n) for n in shape)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def nested(flat) -> dict:
    """``init_<case>.npz``'s "/"-joined keys as the nested parameter
    tree ``convert.model_params`` takes."""
    out: dict = {}
    for key, val in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def load(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------------------- reference


def _reference(suite: str, out: str) -> None:
    import contextlib

    import jax
    import jax.numpy as jnp

    import repro.configs
    from repro.dist import api as jax_dist
    from repro.launch import serve as jax_serve
    from repro.launch.mesh import _make_mesh
    from repro.models import moe as jax_moe
    from repro.models.common import Policy
    from repro.models.model import Model
    from repro.train import DataConfig, SyntheticLM
    from repro_torch.convert import named_params

    routes: list = []
    orig_route = jax_moe._route

    def route(router_w, x, E, k):
        w, idx, aux = orig_route(router_w, x, E, k)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)), idx)
        return w, idx, aux
    jax_moe._route = route

    facts = {}
    for case in SUITES[suite]:
        _, _, meshes, _, _ = SUITES[suite][case]
        cfg = case_config(case, repro.configs)
        jm = Model(cfg, Policy(compute_dtype=jnp.float32))
        params = jax.tree.map(jnp.asarray, nested(load(
            os.path.join(out, f"init_{case}.npz"))))
        batch = {k: jnp.asarray(v) for k, v in
                 case_batch(cfg, SyntheticLM, DataConfig).items()}
        fwd = {k: v for k, v in batch.items() if k != "labels"}
        depth = cfg.num_layers - (1 if cfg.moe and cfg.moe.first_layer_dense
                                  else 0)
        arrays = {}
        for tag, shape in [("plain", None)] + [(f"mesh{mesh_tag(m)}", m)
                                               for m in meshes]:
            mesh = None if shape is None else _make_mesh(shape,
                                                         ("data", "model"))
            scope = contextlib.nullcontext() if mesh is None else \
                contextlib.ExitStack()
            with scope as stack:
                if mesh is not None:
                    stack.enter_context(mesh)
                    stack.enter_context(jax_dist.use_mesh(mesh))
                served = ("plain" if mesh is None else "mesh") in \
                    SERVED[suite]
                if served:
                    loss, grads = jax.jit(jax.value_and_grad(
                        lambda p, b: jm.train_loss(p, b)[0]))(params, batch)
                    for name, g in named_params(
                            jax.tree.map(np.asarray, grads), depth).items():
                        arrays[f"{tag}/grad/{name}"] = g
                else:
                    loss = jax.jit(lambda p, b: jm.train_loss(p, b)[0])(
                        params, batch)
                arrays[f"{tag}/loss"] = np.asarray(loss)
                if not served:
                    continue
                del routes[:]
                logits, cache = jax.jit(jm.prefill)(params, fwd)
                jax.effects_barrier()
                for i, r in enumerate(routes):
                    arrays[f"{tag}/experts/{i}"] = r
                arrays[f"{tag}/prefill"] = np.asarray(logits)
                for name, c in _flat({k: v for k, v in cache.items()
                                      if k != "pos"}).items():
                    arrays[f"{tag}/cache/{name}"] = c
                step = jax.jit(jm.decode_step)
                tok = jnp.asarray(DECODE_TOKENS[0], jnp.int32)
                arrays[f"{tag}/decode_after"] = np.asarray(
                    step(params, tok, cache)[0])
                cache = jm.init_cache(BATCH, CACHE_LEN)
                cache["pos"] = jnp.asarray(DECODE_FROM, jnp.int32)
                for i in range(DECODE_STEPS):
                    tok = jnp.asarray(DECODE_TOKENS[i + 1], jnp.int32)
                    logits, cache = step(params, tok, cache)
                    arrays[f"{tag}/decode/{i}"] = np.asarray(logits)
        np.savez(os.path.join(out, f"ref_{case}.npz"), **arrays)
        if "plain" in SERVED[suite]:
            queue = jax_serve.synthetic_requests(SERVER["requests"],
                                                 cfg.vocab_size, 0)
            reqs = list(queue)
            jax_serve.BatchedServer(jm, params, SERVER["slots"],
                                    SERVER["cache_len"]).run(queue)
            facts[case] = {"server": [r.out for r in reqs]}
    with open(os.path.join(out, "ref.json"), "w") as f:
        json.dump(facts, f)


def write_inits(suite: str, out: str) -> None:
    """``init_<case>.npz`` of each case of ``suite`` (see the module's
    docstring)."""
    import torch
    import repro_torch.configs
    from repro_torch.convert import reference_tree
    from repro_torch.models.common import Policy
    from repro_torch.models.model import Model
    rng = np.random.default_rng(0)
    for case in SUITES[suite]:
        model = Model(case_config(case, repro_torch.configs),
                      Policy(compute_dtype=torch.float32), device="cpu",
                      seed=0)
        named = {n: p.detach().numpy().copy()
                 for n, p in model.named_parameters()}
        for n, v in named.items():
            if n.endswith((".bq", ".bk", ".bv")):
                named[n] = rng.normal(0.0, 0.5, v.shape).astype(np.float32)
        np.savez(os.path.join(out, f"init_{case}.npz"),
                 **_flat(reference_tree(named)))


def start_reference(suite: str, out: str) -> subprocess.Popen:
    """The reference's runs of ``suite`` in a subprocess that sees four CPU
    devices (the flag must be set before JAX starts); ``finish`` waits
    for it."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src, here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             suite, out], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen) -> None:
    try:
        _, err = proc.communicate(timeout=REFERENCE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]


def run_suite(suite: str, out: str) -> None:
    """``write_inits``, then the reference's subprocess and the four ranks
    side by side."""
    write_inits(suite, out)
    proc = start_reference(suite, out)
    try:
        spawn_ranks(out, suite)
    finally:
        finish(proc)


# ------------------------------------------------------------------ ranks


def spawn_ranks(out, suite: str, world: int = 4) -> None:
    """``run_rank`` in ``world`` spawned processes, joined within
    ``JOIN_S``; asserts that each finished and exited 0."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run_rank,
                         args=(r, world, os.path.join(str(out), "store"),
                               str(out), suite))
             for r in range(world)]
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
    assert codes == [0] * world, f"rank exit codes {codes}"


def run_rank(rank: int, world: int, store: str, out: str, suite: str
             ) -> None:
    import torch
    import torch.distributed as tdist
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(store, world),
                             rank=rank, world_size=world)
    try:
        if suite == "train":
            _train_suite(rank, out)
        else:
            _model_suite(rank, out, suite)
    finally:
        tdist.destroy_process_group()


_MESHES: dict = {}


def mesh_of(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    key = (tuple(shape), tuple(names))
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh("cpu", tuple(shape),
                                        mesh_dim_names=tuple(names))
    return _MESHES[key]


class _MoERecord:
    """The experts of each MoE call (``moe._top_k``) and the keep bit of
    each of this rank's dispatched slots (``moe.plan_slots``), in order."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.top_k, self.plan = moe, moe._top_k, moe.plan_slots
        self.experts, self.keep = [], []
        moe._top_k, moe.plan_slots = self._top_k_rec, self._plan_rec

    def _top_k_rec(self, probs, k):
        w, idx = self.top_k(probs, k)
        self.experts.append(idx.numpy().copy())
        return w, idx

    def _plan_rec(self, idx, *, capacity, num_experts, offset=None):
        import torch
        order, dest, C = self.plan(idx, capacity=capacity,
                                   num_experts=num_experts, offset=offset)
        keep = torch.empty_like(dest, dtype=torch.bool)
        keep[order] = dest < num_experts * C
        self.keep.append(keep.reshape(idx.shape).numpy().copy())
        return order, dest, C

    def close(self):
        self.moe._top_k, self.moe.plan_slots = self.top_k, self.plan


def _model_suite(rank: int, out: str, suite: str) -> None:
    import torch
    import repro_torch.configs
    from repro_torch.convert import model_params
    from repro_torch.dist import api as dist
    from repro_torch.launch import serve
    from repro_torch.models.common import Policy
    from repro_torch.train import DataConfig, SyntheticLM

    for case, (_, shape, _, _, _) in SUITES[suite].items():
        cfg = case_config(case, repro_torch.configs)
        init = nested(load(os.path.join(out, f"init_{case}.npz")))
        batch = case_batch(cfg, SyntheticLM, DataConfig)
        fwd = {k: batch[k] for k in ("positions", "patch_embeds")
               if k in batch}
        arrays, facts = {}, {}
        with dist.use_mesh(mesh_of(shape)):
            model = model_params(init, cfg,
                                 policy=Policy(compute_dtype=torch.float32),
                                 device="cpu")
            facts["model_rank"] = model.tp.rank
            facts["tp"] = model.tp.size
            facts["tp_dims"] = model.tp_dims
            facts["heads_local"] = model.layers[0].attn.heads_local
            facts["kv_local"] = model.layers[0].attn.kv_local
            for p in model.parameters():
                p.requires_grad_(True)
            loss, metrics = model.train_loss(batch)
            loss.backward()
            arrays["loss"] = loss.detach().numpy()
            arrays["aux"] = metrics["aux"].detach().numpy()
            for name, p in model.named_parameters():
                arrays[f"grad/{name}"] = p.grad.numpy()
                p.requires_grad_(False)
            record = _MoERecord() if cfg.moe else None
            try:
                with torch.no_grad():
                    logits, cache = model.prefill(batch["tokens"], **fwd)
            finally:
                if record is not None:
                    record.close()
            if record is not None:
                for i, (e, k) in enumerate(zip(record.experts,
                                               record.keep)):
                    arrays[f"experts/{i}"], arrays[f"keep/{i}"] = e, k
                facts["dropped"] = [int((~k).sum()) for k in record.keep]
            arrays["prefill"] = logits.numpy()
            facts["kv_shards"] = cache["kv_shards"]
            for name in ("layers", "dense0"):
                for j, t in enumerate(cache.get(name, ())):
                    arrays[f"cache/{name}/{j}"] = t.numpy()
            tok = torch.tensor(DECODE_TOKENS[0])
            arrays["decode_after"] = model.decode_step(tok, cache)[0].numpy()
            cache = model.init_cache(BATCH, CACHE_LEN)
            facts["decode_kv_shards"] = cache["kv_shards"]
            cache["pos"] = DECODE_FROM
            for i in range(DECODE_STEPS):
                tok = torch.tensor(DECODE_TOKENS[i + 1])
                arrays[f"decode/{i}"] = model.decode_step(tok,
                                                          cache)[0].numpy()
            queue = serve.synthetic_requests(SERVER["requests"],
                                             cfg.vocab_size, 0)
            reqs = list(queue)
            srv = serve.BatchedServer(model, SERVER["slots"],
                                      SERVER["cache_len"])
            facts["server_kv_shards"] = srv.cache["kv_shards"]
            srv.run(queue)
            facts["server"] = [r.out for r in reqs]
        np.savez(os.path.join(out, f"{case}_rank{rank}.npz"), **arrays)
        with open(os.path.join(out, f"{case}_rank{rank}.json"), "w") as f:
            json.dump(facts, f)


# ------------------------------------------------------------ the trainer

OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
# run -> (arch, mesh shape, mesh axis names, ``reduced`` overrides)
TRAIN = {
    "qwen3-4b@2x2": ("qwen3-4b", (2, 2), ("data", "model"), {}),
    "qwen3-4b@1x2x2": ("qwen3-4b", (1, 2, 2), ("pod", "data", "model"), {}),
    # one KV head on two "model" ranks: its masters split over "model",
    # every rank computes with all of it (gathered, its gradient cut)
    "qwen3-4b-kv1@2x2": ("qwen3-4b", (2, 2), ("data", "model"),
                         {"num_kv_heads": 1}),
    "qwen2-vl-72b@2x2": ("qwen2-vl-72b", (2, 2), ("data", "model"), {}),
}
TRAIN_STEPS = 2


def train_config(run: str, package):
    arch, _, _, overrides = TRAIN[run]
    return package.reduced(package.get_config(arch), **overrides)


def trainer(run: str, steps: int = TRAIN_STEPS, ckpt=None):
    """A float32 ``Trainer`` of ``run`` from the port's seed-0 weights
    (every rank draws them whole; under a mesh each keeps its slice)."""
    import torch
    import repro_torch.configs
    from repro_torch.models.common import Policy
    from repro_torch.models.model import Model
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                                   TrainConfig, Trainer)
    from torch_dist_workers import run_data
    cfg = train_config(run, repro_torch.configs)
    model = Model(cfg, Policy(compute_dtype=torch.float32), device="cpu",
                  seed=0)
    data = run_data(cfg, SyntheticLM(DataConfig(cfg.vocab_size, SEQ, 4)))
    return Trainer(model, data, TrainConfig(steps=steps, ckpt_interval=2,
                                            opt=AdamWConfig(**OPT)),
                   ckpt=ckpt)


def state_of(tr) -> dict:
    """Every master weight and moment in full (a collective), as numpy."""
    arrays = {f"p/{k}": v.full_tensor().numpy() for k, v in
              tr.params.items()}
    for m in ("mu", "nu"):
        arrays.update({f"{m}/{k}": v.full_tensor().numpy()
                       for k, v in tr.opt_state[m].items()})
    return arrays


def _train_suite(rank: int, out: str) -> None:
    import repro_torch.configs
    from repro_torch.dist import api as dist
    from repro_torch.models.model import Model
    from repro_torch.train import CheckpointManager, TieredCheckpointManager

    facts: dict = {"rank": rank}
    for run, (_, shape, names, _) in TRAIN.items():
        with dist.use_mesh(mesh_of(shape, names)) as ctx:
            tr = trainer(run)
            want = dist.param_sharding(tr.model.param_axes(), tr.params, ctx)
            facts[run] = {
                "placements_equal": all(
                    list(tr.params[n].placements) == want[n]
                    and list(tr.opt_state[m][n].placements) == want[n]
                    for n in want for m in ("mu", "nu")),
                "model_split": sorted(
                    n for n, pl in want.items()
                    if any(getattr(p, "dim", None) is not None
                           and a == "model" for a, p in zip(ctx.sizes, pl))),
                "tp_dims": tr.model.tp_dims,
                "batch_shard": list(tr.batch_shard),
                "history": [{k: h[k] for k in ("step", "loss", "grad_norm",
                                               "lr")}
                            for h in tr.run()["history"]]}
            state = state_of(tr)
            if rank == 0:
                np.savez(os.path.join(out, f"{run}.npz"), **state)

    # a checkpoint at (2, 2): the durable tier and the fast local tier,
    # each restored under the mesh into a fresh trainer
    run = "qwen3-4b@2x2"
    with dist.use_mesh(mesh_of((2, 2))):
        for tier, make in (("durable", lambda d: CheckpointManager(
                d, async_save=False)), ("local", lambda d:
                TieredCheckpointManager(d, async_save=False,
                                        fast_interval_s=0.0))):
            d = os.path.join(out, f"ckpt_{tier}")
            tr = trainer(run, ckpt=make(d))
            tr.run()
            saved = state_of(tr)
            again = trainer(run, ckpt=make(d))
            step = again.restore()      # a fresh manager holds no peer
            used = again.last_recovery["ckpt_tier"]
            got = state_of(again)
            facts[f"ckpt_{tier}"] = {
                "step": step, "tier": used,
                "equal": sorted(got) == sorted(saved) and all(
                    np.array_equal(got[k], saved[k]) for k in saved)}

    # the families outside this slice raise under a "model" axis of 4
    facts["raises"] = {}
    with dist.use_mesh(mesh_of((1, 4))):
        for arch in ("whisper-small", "rwkv6-7b", "recurrentgemma-9b"):
            cfg = repro_torch.configs.reduced(
                repro_torch.configs.get_config(arch))
            try:
                Model(cfg, device="cpu")
                facts["raises"][arch] = None
            except NotImplementedError as e:
                facts["raises"][arch] = str(e)
    with open(os.path.join(out, f"train_rank{rank}.json"), "w") as f:
        json.dump(facts, f)


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
