"""Reference runs and rank processes of ``tests/test_torch_serve_fsdp.py``:
serving under the mesh with the working weights sharded over "fsdp"
(``repro_torch.models.fsdp.ServeShards``).

The parameters of each case are the port's seed-0 draw written as the
reference's tree (``torch_tp_workers.write_inits``, q/k/v biases drawn
non-zero). The reference side runs in one subprocess (``python
tests/torch_serve_fsdp_workers.py <out>``, four forced CPU devices, its
meshes from ``repro.launch.mesh._make_mesh``): for each case its
unsharded ``Model`` (the moe cases: under the case's mesh, whose
expert-parallel capacity is per shard) takes a prefill of the whole batch
and two decode steps from the prefill's cache at position S - 2 (each
overwrites its row), and, where ``SERVER_CASES`` lists the case, its
``BatchedServer`` serves the request stream; it writes ``ref_<case>.npz``
(logits, every cache tensor, the experts of the prefill's MoE calls) and
``ref.json`` (the server's tokens).

The port side is one spawn of four gloo ranks (``torch_tp_workers``'
``FileStore`` and thread settings). Each rank builds the case under its
mesh with ``convert.serve_shards`` (its "fsdp" shards of the reference's
parameters), serves its own rows of the batch (shard ``token_shard`` of
"act_batch"), gathers its cache over "model" into the reference's layout
(``convert.whole_cache``) and writes ``<case>_rank<r>.npz`` (its logits,
cache rows, decode logits, MoE experts and keep bits) and
``<case>_rank<r>.json`` (its batch shard, the holder's bytes and block
shapes, every unit it gathered and whether each release left the unit's
weights empty, the largest number of weights gathered at once, the
server's tokens).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

import torch_tp_workers as tpw

SEQ, BATCH, HYBRID_SEQ = tpw.SEQ, tpw.BATCH, tpw.HYBRID_SEQ
DECODE_STEPS = 2
SERVER = tpw.SERVER

# case -> (arch, mesh, ``reduced`` overrides, experts or None, capacity
# factor or None). Every mesh splits the batch of 4 over "data" (4 or 2).
CASES = {
    "qwen3-4b@4x1": ("qwen3-4b", (4, 1), {}, None, None),
    "qwen3-4b@2x2": ("qwen3-4b", (2, 2), {}, None, None),
    # 4 experts: whole at (4, 1), two a rank at (2, 2) (expert parallel)
    "deepseek-moe-16b@4x1": ("deepseek-moe-16b", (4, 1), {}, None, None),
    "deepseek-moe-16b@2x2": ("deepseek-moe-16b", (2, 2), {}, None, None),
    # 3 experts that "model" = 2 does not split: whole, routed over the
    # whole batch at the global capacity, cut so that full experts drop
    "deepseek-moe-16b-e3@2x2": ("deepseek-moe-16b", (2, 2), {}, 3, 0.5),
    "rwkv6-7b@4x1": ("rwkv6-7b", (4, 1), {}, None, None),
    "rwkv6-7b@2x2": ("rwkv6-7b", (2, 2), {}, None, None),
    "recurrentgemma-9b@4x1": ("recurrentgemma-9b", (4, 1),
                              {"num_layers": tpw.HYBRID_LAYERS}, None, None),
    "recurrentgemma-9b@2x2": ("recurrentgemma-9b", (2, 2),
                              {"num_layers": tpw.HYBRID_LAYERS}, None, None),
    "whisper-small@4x1": ("whisper-small", (4, 1), {}, None, None),
    "whisper-small@2x2": ("whisper-small", (2, 2), {}, None, None),
    "qwen2-vl-72b@4x1": ("qwen2-vl-72b", (4, 1), {}, None, None),
    "qwen2-vl-72b@2x2": ("qwen2-vl-72b", (2, 2), {}, None, None),
}
# the cases whose BatchedServer runs (every rank serves all slots)
SERVER_CASES = tuple(c for c in CASES if c.endswith("@2x2")
                     and "-e3" not in c)


def is_moe(case: str) -> bool:
    return CASES[case][0] == "deepseek-moe-16b"


def case_config(case: str, package):
    import dataclasses
    arch, _, overrides, experts, cf = CASES[case]
    cfg = package.reduced(package.get_config(arch), **overrides)
    moe = {}
    if experts is not None:
        moe["num_experts"] = experts
    if cf is not None:
        moe["capacity_factor"] = cf
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def seq_of(case: str) -> int:
    return HYBRID_SEQ if CASES[case][0] == "recurrentgemma-9b" else SEQ


def batch_of(cfg, data_cls, config_cls, seq: int, shard: int = 0,
             shards: int = 1) -> dict:
    """Step 0's batch of ``SyntheticLM(DataConfig(vocab, seq, BATCH))``
    (either package's; the vlm family's image and positions, the audio
    family's frames), shard ``shard`` of ``shards``."""
    from torch_dist_workers import run_data
    return run_data(cfg, data_cls(config_cls(cfg.vocab_size, seq,
                                             BATCH))).batch_at(0, shard,
                                                               shards)


def forward_inputs(batch: dict) -> dict:
    """The prefill's keyword inputs of a batch."""
    return {k: batch[k] for k in ("enc_frames", "positions", "patch_embeds")
            if k in batch}


def write_inits(out: str) -> None:
    """``init_<case>.npz``: the port's seed-0 draw as the reference's tree
    (``torch_tp_workers.write_inits``' rule: q/k/v biases drawn)."""
    import torch
    import repro_torch.configs
    from repro_torch.convert import reference_tree
    from repro_torch.models.common import Policy
    from repro_torch.models.model import Model
    rng = np.random.default_rng(0)
    for case in CASES:
        model = Model(case_config(case, repro_torch.configs),
                      Policy(compute_dtype=torch.float32), device="cpu",
                      seed=0)
        named = {n: p.detach().numpy().copy()
                 for n, p in model.named_parameters()}
        for n, v in named.items():
            if n.endswith((".bq", ".bk", ".bv")):
                named[n] = rng.normal(0.0, 0.5, v.shape).astype(np.float32)
        np.savez(os.path.join(out, f"init_{case}.npz"),
                 **tpw._flat(reference_tree(named)))


# ------------------------------------------------------------- reference


def _reference(out: str) -> None:
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

    routes: list = []
    orig_route = jax_moe._route

    def route(router_w, x, E, k):
        w, idx, aux = orig_route(router_w, x, E, k)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)), idx)
        return w, idx, aux
    jax_moe._route = route

    facts = {}
    for case, (_, shape, _, _, _) in CASES.items():
        cfg = case_config(case, repro.configs)
        jm = Model(cfg, Policy(compute_dtype=jnp.float32))
        params = jax.tree.map(jnp.asarray, tpw.nested(tpw.load(
            os.path.join(out, f"init_{case}.npz"))))
        seq = seq_of(case)
        batch = batch_of(cfg, SyntheticLM, DataConfig, seq)
        fwd = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
        arrays = {}
        with contextlib.ExitStack() as stack:
            if is_moe(case):
                mesh = _make_mesh(shape, ("data", "model"))
                stack.enter_context(mesh)
                stack.enter_context(jax_dist.use_mesh(mesh))
            del routes[:]
            logits, cache = jax.jit(jm.prefill)(params, fwd)
            jax.effects_barrier()
            for i, r in enumerate(routes):
                arrays[f"experts/{i}"] = r
            arrays["prefill"] = np.asarray(logits)
            for name, c in tpw.flat_tree(cache).items():
                arrays[f"cache/{name}"] = c
            step = jax.jit(jm.decode_step)
            cache["pos"] = jnp.asarray(seq - DECODE_STEPS, jnp.int32)
            for i in range(DECODE_STEPS):
                tok = jnp.asarray(tpw.DECODE_TOKENS[i], jnp.int32)
                logits, cache = step(params, tok, cache)
                arrays[f"decode/{i}"] = np.asarray(logits)
        np.savez(os.path.join(out, f"ref_{case}.npz"), **arrays)
        if case in SERVER_CASES:
            queue = jax_serve.synthetic_requests(SERVER["requests"],
                                                 cfg.vocab_size, 0)
            reqs = list(queue)
            jax_serve.BatchedServer(jm, params, SERVER["slots"],
                                    SERVER["cache_len"]).run(queue)
            facts[case] = [r.out for r in reqs]
    with open(os.path.join(out, "ref.json"), "w") as f:
        json.dump(facts, f)


def start_reference(out: str) -> subprocess.Popen:
    """The reference's runs in a subprocess that sees four CPU devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=4").strip()
    env["JAX_PLATFORMS"] = "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env["PYTHONPATH"] = os.pathsep.join(
        [src, here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), out],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def run(out: str) -> None:
    """``write_inits``, then the reference's subprocess and the four ranks
    side by side."""
    write_inits(out)
    proc = start_reference(out)
    try:
        tpw.spawn_ranks(out, "serve_fsdp")
    finally:
        tpw.finish(proc)


# ------------------------------------------------------------------ ranks


class _Watch:
    """Records every unit ``holder`` gathers and, at each release, whether
    every weight of the unit is empty afterwards."""

    def __init__(self, holder):
        self.holder, self.gathered, self.released = holder, [], []
        self.gather, self.release = holder.gather, holder.release
        holder.gather, holder.release = self._gather, self._release

    def _gather(self, name):
        self.gathered.append(name)
        self.gather(name)

    def _release(self, name):
        self.release(name)
        self.released.append([name, all(
            self.holder.working[p].numel() == 0
            for p in self.holder.units[name].names)])

    def empty(self) -> bool:
        return _empty(self.holder)


def _empty(holder) -> bool:
    """Whether every working weight of the holder's model is empty."""
    return all(p.numel() == 0 for p in holder.working.values())


def serve_suite(rank: int, out: str) -> None:
    import torch
    import repro_torch.configs
    from repro_torch.convert import serve_shards, whole_cache
    from repro_torch.dist import api as dist
    from repro_torch.launch import serve
    from repro_torch.models.common import Policy
    from repro_torch.train import DataConfig, SyntheticLM

    for case, (_, shape, _, _, _) in CASES.items():
        cfg = case_config(case, repro_torch.configs)
        init = tpw.nested(tpw.load(os.path.join(out, f"init_{case}.npz")))
        seq = seq_of(case)
        arrays, facts = {}, {}
        with dist.use_mesh(tpw.mesh_of(shape)):
            holder = serve_shards(init, cfg,
                                  policy=Policy(compute_dtype=torch.float32),
                                  device="cpu")
            model = holder.model
            index, shards = holder.token_shard
            n = BATCH // shards
            rows = slice(index * n, (index + 1) * n)
            batch = batch_of(cfg, SyntheticLM, DataConfig, seq, index,
                             shards)
            facts.update(
                token_shard=[index, shards], nbytes=holder.nbytes(),
                blocks={p: list(holder._slot(p).shape)
                        for p in holder.working},
                whole_model=sorted(holder.whole),
                empty_at_start=_empty(holder),
                devices=sorted({str(p.device) for p in model.parameters()}
                               | {str(t.device) for t in
                                  (*holder.flat.values(),
                                   *holder.rep.values())}))
            watch = _Watch(holder)
            record = tpw._MoERecord() if cfg.moe else None
            try:
                logits, cache = model.prefill(batch["tokens"],
                                              **forward_inputs(batch))
            finally:
                if record is not None:
                    record.close()
            if record is not None:
                for i, (e, k) in enumerate(zip(record.experts, record.keep)):
                    arrays[f"experts/{i}"], arrays[f"keep/{i}"] = e, k
            facts["empty_after_prefill"] = watch.empty()
            facts["peak_bytes"] = holder.peak
            arrays["prefill"] = logits.numpy()
            for name, t in tpw.flat_tree(whole_cache(model, cache)).items():
                arrays[f"cache/{name}"] = t
            cache["pos"] = seq - DECODE_STEPS
            for i in range(DECODE_STEPS):
                tok = torch.tensor(tpw.DECODE_TOKENS[i])[rows]
                arrays[f"decode/{i}"] = model.decode_step(tok,
                                                          cache)[0].numpy()
            facts["empty_after_decode"] = watch.empty()
            facts["gathered"], facts["released"] = (watch.gathered,
                                                    watch.released)
            if case in SERVER_CASES:
                # every rank runs every slot: a batch it holds whole
                whole = serve_shards(
                    init, cfg, policy=Policy(compute_dtype=torch.float32),
                    device="cpu", batch_shard=(0, 1))
                facts["server_token_shard"] = list(whole.token_shard)
                queue = serve.synthetic_requests(SERVER["requests"],
                                                 cfg.vocab_size, 0)
                reqs = list(queue)
                serve.BatchedServer(whole.model, SERVER["slots"],
                                    SERVER["cache_len"]).run(queue)
                facts["server"] = [r.out for r in reqs]
        np.savez(os.path.join(out, f"{case}_rank{rank}.npz"), **arrays)
        with open(os.path.join(out, f"{case}_rank{rank}.json"), "w") as f:
            json.dump(facts, f)


if __name__ == "__main__":
    _reference(sys.argv[1])
