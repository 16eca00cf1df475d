"""Reference runs and rank processes of the port's tensor-parallel CPU tests
(``tests/test_torch_tp.py``, ``test_torch_tp_moe.py``,
``test_torch_tp_train.py``, ``test_torch_tp_ssm.py``,
``test_torch_tp_hybrid.py``, ``test_torch_tp_audio.py``).

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

The ssm, hybrid and audio suites (``FAMILY_SUITES``, ``family_suite``)
write each rank's prefill cache gathered into the reference's whole layout
(``repro_torch.convert.whole_cache``), decode from one seeded cache that
both packages read (``seeded_<case>.npz``, written by ``write_inits``; the
ranks take their slices, ``rank_cache``), run a mutant of the
family's partly used replicated leaf (``MUTANT``) and two ``Trainer``
steps at (2, 2) (``FAMILY_TRAIN``) in the same spawn.
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
# the hybrid cases: a unit and the (rec, rec) tail, two windows of tokens
# (the windowed path); the other suites run SEQ tokens
HYBRID_LAYERS, HYBRID_SEQ = 5, 128
SSM = {
    # 4 heads of 32: 2 (or 1) a rank; the reference's (2, 2) run splits
    # the batch over "data" too, which moves u's float32 gradient sum
    "rwkv6-7b@2x2": ("rwkv6-7b", (2, 2), ((2, 2),), {}, None),
    "rwkv6-7b@1x4": ("rwkv6-7b", (1, 4), (), {}, None),
    # 3 heads on 4 ranks: the time mix replicates, the channel mix splits
    "rwkv6-7b-d96@1x4": ("rwkv6-7b", (1, 4), (), {"d_model": 96}, None),
}
HYBRID = {
    # 4 query heads over 1 KV head: 2 (or 1) a rank, the KV head whole
    "recurrentgemma-9b@2x2": ("recurrentgemma-9b", (2, 2), (),
                              {"num_layers": HYBRID_LAYERS}, None),
    "recurrentgemma-9b@1x4": ("recurrentgemma-9b", (1, 4), (),
                              {"num_layers": HYBRID_LAYERS}, None),
    # 6 query heads on 4 ranks: the windowed attention's query rows split
    "recurrentgemma-9b-h6@1x4": ("recurrentgemma-9b", (1, 4), (),
                                 {"num_layers": HYBRID_LAYERS,
                                  "num_heads": 6}, None),
}
AUDIO = {
    # 4 heads over 2 KV heads: both split at (1, 2), the KV whole at (1, 4)
    "whisper-small@2x2": ("whisper-small", (2, 2), (), {}, None),
    "whisper-small@1x4": ("whisper-small", (1, 4), (), {}, None),
    # 6 heads on 4 ranks: every attention's query rows split
    "whisper-small-h6@1x4": ("whisper-small", (1, 4), (),
                             {"num_heads": 6, "num_kv_heads": 6}, None),
}
SUITES = {"dense": DENSE, "moe": MOE, "ssm": SSM, "hybrid": HYBRID,
          "audio": AUDIO}
FAMILY_SUITES = ("ssm", "hybrid", "audio")
CASES = {case: spec for suite in SUITES.values()
         for case, spec in suite.items()}
# what the reference runs beyond the loss and its gradients: the dense,
# ssm, hybrid and audio families' port is held to the unsharded prefill,
# decode and server (a mesh does not change them), the moe family's to
# the mesh run's
SERVED = {"dense": ("plain",), "moe": ("mesh",), "ssm": ("plain",),
          "hybrid": ("plain",), "audio": ("plain",)}
# the suites whose mesh runs also take the gradients: rwkv6's bonus u at
# (2, 2) is held to the reference's own mesh run
MESH_GRADS = ("ssm",)
# suite -> (case, the collective taken out, the leaf whose gradient it
# makes partial): a rank's partly used replicated leaf
MUTANT = {"ssm": ("rwkv6-7b@1x4", "split_dim", "layers.0.tm.ln_x_s"),
          "hybrid": ("recurrentgemma-9b@1x4", "split_dim",
                     "units.0.l0_rec.rec.wx"),
          "audio": ("whisper-small@1x4", "copy_in",
                    "dec_layers.0.cross.wk")}
DECODE_TOKENS = [[7, 11, 13, 17], [19, 23, 29, 31], [37, 41, 43, 47],
                 [53, 59, 61, 67]]


def case_config(case: str, package):
    """The reduced config of ``case`` from ``package``'s configs."""
    import dataclasses
    arch, _, _, overrides, cf = CASES[case]
    cfg = package.reduced(package.get_config(arch), **overrides)
    if cf is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def seq_of(case: str) -> int:
    return HYBRID_SEQ if case in HYBRID else SEQ


def case_batch(cfg, data_cls, config_cls, seq: int = SEQ) -> dict:
    """Step 0's batch of ``SyntheticLM(DataConfig(vocab, seq, BATCH))``
    (either package's), with the vlm family's image and positions and the
    audio family's frames."""
    from torch_dist_workers import run_data
    return run_data(cfg, data_cls(config_cls(cfg.vocab_size, seq,
                                             BATCH))).batch_at(0)


def depth_of(cfg):
    """The stacked depth ``convert.named_params`` takes for ``cfg``."""
    if cfg.is_encoder_decoder:
        return {"enc_layers": cfg.encoder_layers,
                "dec_layers": cfg.num_layers}
    if cfg.block_pattern:
        return cfg.num_layers // len(cfg.block_pattern)
    return cfg.num_layers - (1 if cfg.moe and cfg.moe.first_layer_dense
                             else 0)


def flat_tree(tree, prefix: str = "") -> dict:
    """A cache's tensors (nested dicts, lists and tuples) as ``{"/"-joined
    path: numpy array}``, "pos" and "kv_shards" left out."""
    if isinstance(tree, dict):
        items = [(k, v) for k, v in tree.items()
                 if k not in ("pos", "kv_shards")]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix[:-1]: np.array(tree, np.float32)}
    out = {}
    for k, v in items:
        out.update(flat_tree(v, f"{prefix}{k}/"))
    return out


def fill_tree(template, flat: dict, wrap, prefix: str = ""):
    """``template``'s structure (a cache) with each tensor taken from
    ``flat`` (``flat_tree``'s keys) through ``wrap``."""
    if isinstance(template, dict):
        return {k: (v if k in ("pos", "kv_shards") else
                    fill_tree(v, flat, wrap, f"{prefix}{k}/"))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(fill_tree(v, flat, wrap, f"{prefix}{i}/")
                              for i, v in enumerate(template))
    return wrap(flat[prefix[:-1]])


def mesh_tag(shape) -> str:
    return "x".join(str(n) for n in shape)


def _flat(tree, prefix=""):
    """A parameter tree as ``{"/"-joined path: array}``; a list (the hybrid
    ``tail``) by its indices."""
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def nested(flat) -> dict:
    """``init_<case>.npz``'s "/"-joined keys as the nested parameter
    tree ``convert.model_params`` takes (a node of indices a list)."""
    out: dict = {}
    for key, val in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(out)


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
    family = suite in FAMILY_SUITES
    for case in SUITES[suite]:
        _, _, meshes, _, _ = SUITES[suite][case]
        cfg = case_config(case, repro.configs)
        jm = Model(cfg, Policy(compute_dtype=jnp.float32))
        params = jax.tree.map(jnp.asarray, nested(load(
            os.path.join(out, f"init_{case}.npz"))))
        batch = {k: jnp.asarray(v) for k, v in
                 case_batch(cfg, SyntheticLM, DataConfig,
                            seq_of(case)).items()}
        fwd = {k: v for k, v in batch.items() if k != "labels"}
        depth = depth_of(cfg)
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
                if served or suite in MESH_GRADS:
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
                flat = flat_tree if family else lambda c: _flat(
                    {k: v for k, v in c.items() if k != "pos"})
                for name, c in flat(cache).items():
                    arrays[f"{tag}/cache/{name}"] = c
                step = jax.jit(jm.decode_step)
                tok = jnp.asarray(DECODE_TOKENS[0], jnp.int32)
                arrays[f"{tag}/decode_after"] = np.asarray(
                    step(params, tok, cache)[0])
                cache = jm.init_cache(BATCH, CACHE_LEN)
                if family:          # the seeded cache both packages read
                    cache = fill_tree(cache, load(os.path.join(
                        out, f"seeded_{case}.npz")), jnp.asarray)
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
    """``init_<case>.npz`` of each case of ``suite``, and for the ssm,
    hybrid and audio suites ``seeded_<case>.npz``, a whole decode cache of
    N(0, 0.5^2) draws (see the module's docstring)."""
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
            elif suite in FAMILY_SUITES and v.size > 1 and \
                    np.all(v == v.flat[0]):
                # a leaf drawn constant (norm scales and biases, rwkv6's
                # dw0, the RG-LRU's lam and conv_b): a rank reading another
                # rank's slice of it would read the same values
                named[n] = (v + rng.normal(0.0, 0.1, v.shape)).astype(
                    np.float32)
        np.savez(os.path.join(out, f"init_{case}.npz"),
                 **_flat(reference_tree(named)))
        if suite in FAMILY_SUITES:
            seeded = {k: rng.normal(0.0, 0.5, v.shape).astype(np.float32)
                      for k, v in flat_tree(model.init_cache(
                          BATCH, CACHE_LEN)).items()}
            np.savez(os.path.join(out, f"seeded_{case}.npz"), **seeded)


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
        elif suite == "serve_fsdp":
            import torch_serve_fsdp_workers
            torch_serve_fsdp_workers.serve_suite(rank, out)
        elif suite == "route":
            import torch_moe_route_workers
            torch_moe_route_workers.route_suite(rank, out)
        elif suite in FAMILY_SUITES:
            family_suite(rank, out, suite)
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


def keep_rule(idx, C):
    """The reference's drop rule on experts idx (..., k): slot s (flat
    (token, choice) order) is kept while fewer than C earlier slots chose
    its expert."""
    flat = idx.reshape(-1)
    seen: dict = {}
    keep = np.zeros(flat.size, bool)
    for s, e in enumerate(flat):
        keep[s] = seen.get(int(e), 0) < C
        seen[int(e)] = seen.get(int(e), 0) + 1
    return keep.reshape(idx.shape)


def rank_cache(model, seeded: dict) -> dict:
    """``model``'s ``init_cache`` at DECODE_FROM holding the rank's slice
    (``Model.cache_tp_dims``) of each tensor of ``seeded``, a whole cache
    by ``flat_tree`` path."""
    import torch
    cache = model.init_cache(BATCH, CACHE_LEN)

    def fill(c, d, prefix):
        if isinstance(d, dict):
            for k in d:
                fill(c[k], d[k], f"{prefix}{k}/")
        elif isinstance(d, (list, tuple)):
            for i, (ci, di) in enumerate(zip(c, d)):
                fill(ci, di, f"{prefix}{i}/")
        else:
            t = torch.from_numpy(seeded[prefix[:-1]])
            if d is not None:
                n = c.shape[d]
                t = t.narrow(d, model.tp.rank * n, n)
            c.copy_(t)
    fill(cache, model.cache_tp_dims(cache), "")
    cache["pos"] = DECODE_FROM
    return cache


def _layout(model) -> dict:
    """Which of the case's modules hold the rank's slice."""
    from repro_torch.models import rglru, rwkv6
    from repro_torch.models.attention import Attention
    mods = list(model.modules())

    def first(cls):
        return next((m for m in mods if isinstance(m, cls)), None)
    out = {}
    att = first(Attention)
    if att is not None:
        out.update(heads_local=att.heads_local, kv_local=att.kv_local)
    if model.cfg.is_encoder_decoder:
        out["cross_kv_local"] = model.dec_layers[0].cross.kv_local
    if first(rwkv6.TimeMix) is not None:
        out.update(tm_split=first(rwkv6.TimeMix).tp is not None,
                   cm_split=first(rwkv6.ChannelMix).tp is not None)
    if first(rglru.RecBlock) is not None:
        out["rec_split"] = first(rglru.RecBlock).tp is not None
    return out


def _mutant(name: str, leaf):
    """The collective ``name`` of ``repro_torch.dist`` as it is, but
    without its backward's sum or gather where it takes the parameter
    ``leaf``: that leaf keeps the rank's own share of its gradient."""
    from repro_torch.dist import api as dist
    real = getattr(dist, name)
    if name == "copy_in":
        return lambda x, tp: x if x is leaf else real(x, tp)

    def split(x, d, tp):
        if x is not leaf:
            return real(x, d, tp)
        n = x.shape[d] // tp.size
        return x.narrow(d, tp.rank * n, n)
    return split


def family_suite(rank: int, out: str, suite: str) -> None:
    """A rank's runs of the ssm, hybrid or audio ``suite`` (see the
    module's docstring), then its ``FAMILY_TRAIN`` run."""
    from unittest import mock

    import torch
    import repro_torch.configs
    from repro_torch.convert import model_params, whole_cache
    from repro_torch.dist import api as dist
    from repro_torch.launch import serve
    from repro_torch.models.common import Policy
    from repro_torch.train import DataConfig, SyntheticLM

    for case, (_, shape, _, _, _) in SUITES[suite].items():
        cfg = case_config(case, repro_torch.configs)
        init = nested(load(os.path.join(out, f"init_{case}.npz")))
        batch = case_batch(cfg, SyntheticLM, DataConfig, seq_of(case))
        fwd = {"enc_frames": batch["enc_frames"]} \
            if "enc_frames" in batch else {}
        arrays, facts = {}, {}
        with dist.use_mesh(mesh_of(shape)):
            model = model_params(init, cfg,
                                 policy=Policy(compute_dtype=torch.float32),
                                 device="cpu")
            facts.update(model_rank=model.tp.rank, tp=model.tp.size,
                         tp_dims=model.tp_dims, layout=_layout(model))
            params = dict(model.named_parameters())
            for p in params.values():
                p.requires_grad_(True)
            loss, _ = model.train_loss(batch)
            loss.backward()
            arrays["loss"] = loss.detach().numpy()
            for name, p in params.items():
                arrays[f"grad/{name}"] = p.grad.numpy()
                p.grad = None
            if MUTANT[suite][0] == case:
                _, fn, leaf = MUTANT[suite]
                with mock.patch.object(dist, fn, _mutant(fn, params[leaf])):
                    model.train_loss(batch)[0].backward()
                arrays["mutant"] = params[leaf].grad.numpy()
            for p in params.values():
                p.requires_grad_(False)
            logits, cache = model.prefill(batch["tokens"], **fwd)
            arrays["prefill"] = logits.numpy()
            facts["kv_shards"] = cache.get("kv_shards")
            for name, t in flat_tree(whole_cache(model, cache)).items():
                arrays[f"cache/{name}"] = t
            tok = torch.tensor(DECODE_TOKENS[0])
            arrays["decode_after"] = model.decode_step(tok, cache)[0].numpy()
            cache = rank_cache(model, load(os.path.join(
                out, f"seeded_{case}.npz")))
            facts["decode_kv_shards"] = cache.get("kv_shards")
            for i in range(DECODE_STEPS):
                tok = torch.tensor(DECODE_TOKENS[i + 1])
                arrays[f"decode/{i}"] = model.decode_step(tok,
                                                          cache)[0].numpy()
            queue = serve.synthetic_requests(SERVER["requests"],
                                             cfg.vocab_size, 0)
            reqs = list(queue)
            serve.BatchedServer(model, SERVER["slots"],
                                SERVER["cache_len"]).run(queue)
            facts["server"] = [r.out for r in reqs]
        np.savez(os.path.join(out, f"{case}_rank{rank}.npz"), **arrays)
        with open(os.path.join(out, f"{case}_rank{rank}.json"), "w") as f:
            json.dump(facts, f)
    facts = {run: trainer_run(rank, out, run) for run in FAMILY_TRAIN[suite]}
    with open(os.path.join(out, f"train_rank{rank}.json"), "w") as f:
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
# the ssm, hybrid and audio suites' Trainer runs, in their own spawns
FAMILY_TRAIN = {
    "ssm": {"rwkv6-7b@2x2": ("rwkv6-7b", (2, 2), ("data", "model"), {})},
    "hybrid": {"recurrentgemma-9b@2x2": (
        "recurrentgemma-9b", (2, 2), ("data", "model"),
        {"num_layers": HYBRID_LAYERS})},
    "audio": {"whisper-small@2x2": ("whisper-small", (2, 2),
                                    ("data", "model"), {})},
}
RUNS = {**TRAIN, **{run: spec for runs in FAMILY_TRAIN.values()
                    for run, spec in runs.items()}}


def train_config(run: str, package):
    arch, _, _, overrides = RUNS[run]
    return package.reduced(package.get_config(arch), **overrides)


def train_seq(run: str) -> int:
    return HYBRID_SEQ if run in FAMILY_TRAIN["hybrid"] else SEQ


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
    data = run_data(cfg, SyntheticLM(DataConfig(cfg.vocab_size,
                                                train_seq(run), 4)))
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


def trainer_run(rank: int, out: str, run: str) -> dict:
    """Two steps of ``run`` under its mesh: this rank's facts, and (rank
    0) ``<run>_step1.npz`` and ``<run>.npz``, every master weight and
    moment in full after the first and after the last step."""
    from repro_torch.dist import api as dist
    _, shape, names, _ = RUNS[run]

    def after(step, _):
        if step == 1:
            state = state_of(tr)            # a collective: every rank
            if rank == 0:
                np.savez(os.path.join(out, f"{run}_step1.npz"), **state)
    with dist.use_mesh(mesh_of(shape, names)) as ctx:
        tr = trainer(run)
        want = dist.param_sharding(tr.model.param_axes(), tr.params, ctx)
        facts = {
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
                        for h in tr.run(after)["history"]]}
        state = state_of(tr)
        if rank == 0:
            np.savez(os.path.join(out, f"{run}.npz"), **state)
    return facts


def _state(tr) -> dict:
    state = {f"p/{k}": v.detach().numpy().copy() for k, v in
             tr.params.items()}
    for m in ("mu", "nu"):
        state.update({f"{m}/{k}": v.numpy().copy()
                      for k, v in tr.opt_state[m].items()})
    return state


def single_steps(run: str, state1: dict):
    """``run`` in one process, no mesh: (the history of its two steps,
    every master weight and moment as numpy after its first step, and
    after a second step taken from ``state1``, a state after one step)."""
    import torch
    tr, kept = trainer(run), []

    def after(step, _):
        if step == 1:
            kept.append(_state(tr))
    hist = tr.run(after)["history"]
    again = trainer(run)
    with torch.no_grad():
        for k, v in again.params.items():
            v.copy_(torch.from_numpy(state1[f"p/{k}"]))
        for m in ("mu", "nu"):
            for k, v in again.opt_state[m].items():
                v.copy_(torch.from_numpy(state1[f"{m}/{k}"]))
        again.opt_state["count"].fill_(1)
    again.params, again.opt_state, _ = again._step_fn(
        again.params, again.opt_state, again.data.batch_at(1))
    return hist, kept[0], _state(again)


def _hold_state(got: dict, want: dict, lr_sum: float) -> None:
    """``tests/test_torch_dist_train.py``'s limits: every moment within
    1e-4 of its leaf's largest magnitude, and every master weight too but
    for at most 1 in 10^4 entries, none by more than 5 % of the summed
    learning rate ``lr_sum``."""
    assert sorted(got) == sorted(want)
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


def check_trainer(out, facts: list, run: str, step2: bool = True) -> None:
    """Rank facts, ``<run>_step1.npz`` and ``<run>.npz`` of ``trainer_run``
    against ``single_steps``: the two steps' losses and gradient norms
    within 1e-5 (relative) of the single-process run's, the state after
    the first step against its state, and (``step2``) the state after the
    second against its second step from the sharded first step's state,
    each at ``_hold_state``'s limits: step by step, since the first AdamW
    step turns float32 noise in near-zero gradients into master weights
    that differ by up to 5 % of its learning rate, which compounds into the
    second step (rwkv6's there, ``tests/test_torch_tp_ssm.py``)."""
    import pytest
    got1 = load(os.path.join(str(out), f"{run}_step1.npz"))
    single_hist, want1, want2 = single_steps(run, got1)
    hist = facts[0][run]["history"]
    assert [h["step"] for h in hist] == [1, 2]
    for f in facts[1:]:                     # the metrics are global means
        assert f[run]["history"] == hist
    for h, sh in zip(hist, single_hist):
        assert h["loss"] == pytest.approx(sh["loss"], rel=1e-5)
        assert h["grad_norm"] == pytest.approx(sh["grad_norm"], rel=1e-5)
        assert h["lr"] == sh["lr"]
    _hold_state(got1, want1, single_hist[0]["lr"])
    if step2:
        _hold_state(load(os.path.join(str(out), f"{run}.npz")), want2,
                    single_hist[1]["lr"])
    for f in facts:
        assert f[run]["placements_equal"]


def _train_suite(rank: int, out: str) -> None:
    import repro_torch.configs
    from repro_torch.dist import api as dist
    from repro_torch.models.model import Model
    from repro_torch.train import CheckpointManager, TieredCheckpointManager

    facts: dict = {"rank": rank}
    for run in TRAIN:
        facts[run] = trainer_run(rank, out, run)

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

    # the ssm, hybrid and audio families built under a "model" axis of 4:
    # each parameter's shape, its whole shape and param_sharding's split
    # dim over "model" (None: whole)
    facts["builds"] = {}
    with dist.use_mesh(mesh_of((1, 4))) as ctx:
        for arch in ("whisper-small", "rwkv6-7b", "recurrentgemma-9b"):
            cfg = repro_torch.configs.reduced(
                repro_torch.configs.get_config(arch))
            model = Model(cfg, device="cpu")
            shapes = model.global_shapes()
            placements = dist.param_sharding(model.param_axes(), shapes, ctx)
            model_dim = {n: next((pl.dim for a, pl in zip(ctx.sizes, p)
                                  if a == "model" and hasattr(pl, "dim")),
                                 None) for n, p in placements.items()}
            facts["builds"][arch] = {
                n: [list(p.shape), list(shapes[n]), model_dim[n]]
                for n, p in model.named_parameters()}
    with open(os.path.join(out, f"train_rank{rank}.json"), "w") as f:
        json.dump(facts, f)


# ---------------------------------------------- the family suites' checks

LOSS_TOL, GRAD_TOL, MESH_TOL, OUT_TOL = 1e-5, 1e-4, 1e-5, 1e-4


def ranks_of(out, case: str) -> list:
    """Each rank's (arrays, facts) of ``case``."""
    return [(load(os.path.join(str(out), f"{case}_rank{r}.npz")),
             json.loads(open(os.path.join(str(out),
                                          f"{case}_rank{r}.json")).read()))
            for r in range(4)]


def rank_slice(full, dim, rank: int, tp: int):
    """The rank's slice of ``full`` along ``dim`` (None: ``full``)."""
    if dim is None:
        return full
    n = full.shape[dim] // tp
    index = [slice(None)] * full.ndim
    index[dim] = slice(rank * n, (rank + 1) * n)
    return full[tuple(index)]


def leaf_err(got, want) -> float:
    """max |got - want| over the largest magnitude of ``want``."""
    return float(np.abs(got - want).max() /
                 max(np.abs(want).max(), 1e-30))


def check_loss_and_grads(out, case: str, grads_of: str = "plain") -> None:
    """Every rank's ``train_loss`` within LOSS_TOL of the reference's
    unsharded loss and MESH_TOL of each mesh run's; its gradients (its
    slice of each) within GRAD_TOL of each leaf's largest magnitude of the
    reference's ``grads_of`` run."""
    import pytest
    ref = load(os.path.join(str(out), f"ref_{case}.npz"))
    for arrays, facts in ranks_of(out, case):
        loss = float(arrays["loss"])
        assert loss == pytest.approx(float(ref["plain/loss"]), rel=LOSS_TOL)
        for m in CASES[case][2]:
            assert loss == pytest.approx(float(ref[f"mesh{mesh_tag(m)}/loss"]),
                                         rel=MESH_TOL)
        grads = {k[5:]: v for k, v in arrays.items()
                 if k.startswith("grad/")}
        prefix = f"{grads_of}/grad/"
        assert sorted(grads) == sorted(k[len(prefix):] for k in ref
                                       if k.startswith(prefix))
        for name, g in grads.items():
            want = rank_slice(ref[prefix + name], facts["tp_dims"].get(name),
                              facts["model_rank"], facts["tp"])
            assert g.shape == want.shape, name
            assert leaf_err(g, want) <= GRAD_TOL, name


def check_prefill(out, case: str) -> None:
    """Every rank's prefill logits and its cache gathered into the
    reference's layout within OUT_TOL of the reference's, elementwise."""
    ref = load(os.path.join(str(out), f"ref_{case}.npz"))
    names = sorted(k[len("plain/cache/"):] for k in ref
                   if k.startswith("plain/cache/"))
    for arrays, _ in ranks_of(out, case):
        np.testing.assert_allclose(arrays["prefill"], ref["plain/prefill"],
                                   atol=OUT_TOL, rtol=0)
        got = sorted(k[len("cache/"):] for k in arrays
                     if k.startswith("cache/"))
        assert got == names
        for name in names:
            np.testing.assert_allclose(arrays[f"cache/{name}"],
                                       ref[f"plain/cache/{name}"],
                                       atol=OUT_TOL, rtol=0, err_msg=name)


def check_decode(out, case: str) -> None:
    """The decode step after the prefill and DECODE_STEPS steps from the
    seeded cache at DECODE_FROM within OUT_TOL of the reference's."""
    ref = load(os.path.join(str(out), f"ref_{case}.npz"))
    for arrays, _ in ranks_of(out, case):
        np.testing.assert_allclose(arrays["decode_after"],
                                   ref["plain/decode_after"], atol=OUT_TOL,
                                   rtol=0)
        for i in range(DECODE_STEPS):
            np.testing.assert_allclose(arrays[f"decode/{i}"],
                                       ref[f"plain/decode/{i}"],
                                       atol=OUT_TOL, rtol=0)


def check_server(out, case: str) -> None:
    want = json.loads(open(os.path.join(str(out), "ref.json")).read())
    for _, facts in ranks_of(out, case):
        assert facts["server"] == want[case]["server"]


def check_mutant(out, suite: str) -> None:
    """``MUTANT``: without its collective's backward the leaf's gradient
    on a rank is the rank's share, beyond GRAD_TOL of the whole, and the
    shares of a "model" group sum to the whole; with it, each rank's
    gradient is the whole."""
    case, _, leaf = MUTANT[suite]
    want = load(os.path.join(str(out), f"ref_{case}.npz"))[
        f"plain/grad/{leaf}"]
    ranks = ranks_of(out, case)
    assert leaf not in ranks[0][1]["tp_dims"]        # whole on every rank
    shares = [a["mutant"] for a, _ in ranks]
    for (arrays, _), share in zip(ranks, shares):
        assert leaf_err(arrays[f"grad/{leaf}"], want) <= GRAD_TOL
        assert leaf_err(share, want) > 100 * GRAD_TOL
    assert leaf_err(sum(shares), want) <= GRAD_TOL


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
