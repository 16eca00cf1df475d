"""Training loop with Guard hooks, sharded step construction,
fault-tolerant restart and optional gradient accumulation: the port of
``repro.train.trainer``.

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) step. ``params`` are the float32 master weights, a
dict keyed by the model's parameter names: the step first copies them
into the model's working weights (the compute dtype, rounded to nearest
even: the cast the JAX package applies to its tree on every call; nothing
to copy under a float32 policy, where the two are one), takes the loss
and its gradient through the working weights, and applies AdamW to the
master weights and moments in place.

Under a mesh context (``repro_torch.dist``; one process per rank) the
step is the reference's ZeRO-3 step: the master weights and moments are
DTensors placed by ``param_sharding`` ("fsdp" dims sharded over "data",
and, under tensor parallelism, the heads, ff, vocab and expert dims over
"model"),
each rank takes its rows of the batch (``act_batch`` over "pod" and
"data"), each unit's working weights (``Model.zero3_units``: the
embedding, each layer, the head) are gathered from the cast masters just
before it computes, as one flat all-gather over "data" (the reference's
``gather_fsdp``), and released after; a unit's gradients are reduced
into its masters' placements, as one flat reduce-scatter over "data" and
an all-reduce over "pod", once autograd has accumulated the last of them,
and divided by the batch ranks; the clip takes the norm of the whole
gradient, and AdamW updates each rank's local shards. The metrics are the
global means. Under tensor parallelism (a model built under a mesh whose
"model" axis is wider than 1) the gather and the reduce-scatter run over
"data" alone, on the rank's tensor-parallel slice, which is its working
weight; a parameter whose master splits over "model" while every rank
computes with all of it (KV heads that do not divide "model", query
heads on the sequence fallback) is also gathered over "model", and its
gradient, whole on every rank, is cut to the rank's slice. The clip's
norm counts each leaf once (``optimizer.global_norm``). Host decisions
that steer collectives (a restart the hook asks for, the checkpoint to
restore) are rank 0's. Without a context
nothing of this runs. After a sharded step the model's working weights
hold no storage: ``load_working(model, trainer.params)`` brings them back
before the model serves or trains without a mesh, and the model raises
until then.

Guard integration: the trainer reports its per-step wall time to a
``StepHook``; when the hook requests a restart (Guard's IMMEDIATE tier),
the trainer restores the last checkpoint, notifies the hook via
``on_restart`` (so partial telemetry windows are dropped) and
``on_recovery``, and continues: the closed loop of Fig. 1.
``repro_torch.guard.GuardStepHook`` is the production implementation.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
import weakref
from typing import Any, Callable, Dict, Mapping, Optional, Protocol, Tuple

import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.tensor import DTensor

from repro_torch.dist import api as dist
from repro_torch.models import fsdp
from repro_torch.models.model import Model
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import SyntheticLM
from repro_torch.train.optimizer import (AdamWConfig, apply_adamw,
                                         init_opt_state)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    ckpt_interval: int = 50
    log_interval: int = 10
    microbatch: int = 0          # >0: grad-accumulation chunk (batch dim)
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def master_params(model: Model) -> Dict[str, torch.Tensor]:
    """The float32 master weights of ``model``'s working weights: the
    parameters themselves when they are float32 (no second copy), else a
    float32 copy (exact: widening)."""
    model.require_weights()
    return {name: p.detach() if p.dtype == torch.float32
            else p.detach().float()
            for name, p in model.named_parameters()}


@torch.no_grad()
def load_working(model: Model, params: Mapping[str, torch.Tensor]) -> None:
    """Copy the master weights into the model's working weights (a no-op
    for a parameter that is its own master). DTensor masters (a sharded
    step's) are gathered in full, a collective every rank joins, and cut
    to the model's tensor-parallel slice: so a model whose working weights
    a sharded step released can serve, or train without a mesh, again."""
    for name, p in model.named_parameters():
        src = params[name]
        if isinstance(src, DTensor):
            src = model.tp_slice(name, src.full_tensor())
        if p.shape != src.shape:            # released by a sharded step
            p.data = torch.empty(src.shape, dtype=p.dtype, device=p.device)
        if src.data_ptr() != p.data_ptr():
            p.copy_(src)
    model.weights_released = False


def decay_mask(model: Model) -> Dict[str, bool]:
    """Which parameters AdamW decays. The reference's rule is "two or more
    dimensions", applied to its tree, where each layer's parameters are
    stacked on a leading layer axis (the hybrid family's on a unit axis,
    the audio family's on its encoder's and its decoder's): so every layer
    (unit) parameter decays, its norm scales, biases and the RG-LRU's
    gates too, and of the rest only the matrices (the audio family's
    position tables among them). The hybrid tail is a plain list there, so
    its vectors do not decay."""
    stacks = tuple(f"{s}." for s in model.stacks())
    return {name: name.startswith(stacks) or p.dim() >= 2
            for name, p in model.named_parameters()}


def _grads(model: Model) -> Dict[str, torch.Tensor]:
    """Takes the working weights' gradients, clearing ``.grad``."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = p.grad
        p.grad = None
    return out


def _microbatches(batch, microbatch: int) -> list:
    """``batch`` split along its batch dim into chunks of ``microbatch``.
    A batch with the vlm family's (3, B, S) "positions" is refused: their
    batch dim is not dim 0, and the reference's split (which reshapes only
    a leaf whose dim 0 is B and gives every other leaf whole to each
    chunk) hands each chunk all B rows of them. (B, S) positions split as
    the tokens do."""
    if np.ndim(batch.get("positions")) == 3:
        raise NotImplementedError(
            "gradient accumulation of batches with (3, B, S) M-RoPE "
            "positions is not supported (microbatch > 0)")
    B = np.shape(batch["tokens"])[0]
    if B % microbatch:
        raise ValueError(f"batch of {B} is no multiple of the "
                         f"microbatch {microbatch}")
    return [{k: v[i:i + microbatch] for k, v in batch.items()}
            for i in range(0, B, microbatch)]


def shard_params(model: Model, ctx: dist.DistContext
                 ) -> Dict[str, DTensor]:
    """The float32 master weights of ``model``'s working weights (every
    rank holds the same, or under tensor parallelism its slice of them),
    each a DTensor placed by ``param_sharding`` on ``ctx``'s mesh; a rank
    keeps only its shards."""
    model.require_weights()
    shapes = model.global_shapes()
    placements = dist.param_sharding(model.param_axes(), shapes, ctx)
    out = {}
    for name, p in model.named_parameters():
        skip = {dist.TP_AXIS: model.tp_dims[name]} \
            if name in model.tp_dims else {}
        block = dist.local_block(p.detach().float(), ctx.mesh,
                                 placements[name], skip)
        out[name] = DTensor.from_local(
            block.clone(memory_format=torch.contiguous_format), ctx.mesh,
            placements[name], shape=torch.Size(shapes[name]),
            stride=torch.empty(shapes[name], device="meta").stride())
    return out


_reduce_scatter = dist.reduce_scatter_single


class _Zero3(fsdp.Shards):
    """The ZeRO-3 state of a sharded step, one flat buffer a unit of
    ``Model.zero3_units`` (the layout and the gather of ``models.fsdp``).
    ``gather`` casts the unit's local master shards into its buffer and
    all-gathers that over "data", one collective a unit (the reference's
    ``gather_fsdp`` of the cast masters: "fsdp" dropped); each working
    weight is a view of the result at one data rank and a copy of its rows
    otherwise; replicated parameters are cast on each rank. ``release``
    frees a unit's working weights. A post-accumulate-grad
    hook moves each working gradient, widened to float32, into its unit's
    gradient buffer (the data ranks' shards one after another) and frees
    the weight; when the unit's last gradient is in, ``reduce``
    reduce-scatters the buffer over "data", all-reduces the result over
    "pod" (and the replicated parameters' buffer over every batch rank),
    and divides by the number of batch ranks. A collective over one rank
    is the identity and is skipped. Under ``accumulate`` the
    buffers sum the microbatches and are reduced once, at the end. The
    gradients handed on (``take``) are this rank's local shards, plain
    tensors, in the parameters' order. A master split over "model" whose
    working weight is whole (``whole``) has its gradient cut to the
    rank's slice."""

    def __init__(self, model: Model, ctx: dist.DistContext):
        super().__init__(model, ctx)
        self.replicas = ctx.axis_size("act_batch")
        self.local: Dict[str, torch.Tensor] = {}   # the masters' shards
        self.grads: Dict[str, torch.Tensor] = {}
        self.accumulate = False
        self.active = False
        self.pod_group = ctx.mesh.get_group("pod") \
            if "pod" in ctx.sizes else None
        # a unit's float32 gradient buffers (allocated on first use) and
        # the names whose gradient is in
        self.grad: Dict[str, torch.Tensor] = {}
        self.rep_grad: Dict[str, torch.Tensor] = {}
        self.seen: Dict[str, set] = {u: set() for u in self.units}
        self.handles = [p.register_post_accumulate_grad_hook(
            functools.partial(self._on_grad, name))
            for name, p in self.working.items()]

    def begin(self, params: Mapping[str, DTensor]) -> None:
        self.local = {name: m.to_local() for name, m in params.items()}
        self.active, self.model.zero3 = True, self

    def end(self) -> None:
        """After the step's backward, or its failure: every working weight
        released, the buffers dropped."""
        self.active, self.model.zero3 = False, None
        self.local, self.grads = {}, {}
        self.grad, self.rep_grad = {}, {}
        self.seen = {u: set() for u in self.units}
        for p in self.working.values():
            if p.numel():
                self._release(p)
        self.model.weights_released = True

    @torch.no_grad()
    def gather(self, name: str) -> None:
        unit = self.units[name]
        for pname in unit.rep:
            p = self.working[pname]
            p.data = self._whole(pname, self.local[pname].to(p.dtype,
                                                             copy=True))
        if not unit.shard:
            return
        first = self.local[unit.shard[0][0]]
        dtype = self.working[unit.shard[0][0]].dtype
        send = torch.empty(unit.size, dtype=dtype, device=first.device)
        for pname, _, shape, off in unit.shard:
            send[off:off + math.prod(shape)].view(shape).copy_(
                self.local[pname])
        self._gather_shards(unit, send)

    @torch.no_grad()
    def _on_grad(self, name: str, p: torch.Tensor) -> None:
        if not self.active:
            return
        g, p.grad = p.grad, None
        self._release(p)
        if name in self.whole:          # whole on every rank: my slice
            m = self.whole[name]
            k = g.shape[m] // self.tp.size
            g = g.narrow(m, self.tp.rank * k, k)
        u = self.unit_of[name]
        unit, seen = self.units[u], self.seen[u]
        if u not in self.grad and unit.shard:
            self.grad[u] = torch.empty(self.n * unit.size,
                                       dtype=torch.float32, device=g.device)
        if u not in self.rep_grad and unit.rep:
            self.rep_grad[u] = torch.empty(unit.rep_size,
                                           dtype=torch.float32,
                                           device=g.device)
        d, shape, off = unit.slot[name]
        if d is None:
            dst = self.rep_grad[u][off:off + g.numel()].view(shape)
            src = g
        else:
            dst = self.grad[u].view(self.n, unit.size)[
                :, off:off + math.prod(shape)].unflatten(1, shape)
            src = g.unflatten(d, (self.n, shape[d])).movedim(d, 0)
        if name in seen:                # a later microbatch
            dst.add_(src)
        else:
            dst.copy_(src)              # widening: exact
            seen.add(name)
        if not self.accumulate and len(seen) == len(unit.names):
            self.reduce(u)

    @torch.no_grad()
    def reduce(self, name: str) -> None:
        """The unit's float32 gradients summed over the batch ranks into
        its masters' placements, over their number."""
        unit = self.units[name]
        if unit.shard:
            out = grad = self.grad.pop(name)
            if self.n > 1:
                out = torch.empty(unit.size, dtype=torch.float32,
                                  device=grad.device)
                _reduce_scatter(out, grad, group=self.data_group)
            self._sum(out, self.pod_group)
            for pname, _, shape, off in unit.shard:
                self.grads[pname] = out[off:off + math.prod(shape)].view(
                    shape)
        if unit.rep:
            out = self.rep_grad.pop(name)
            self._sum(out, self.data_group)
            self._sum(out, self.pod_group)
            for pname in unit.rep:
                _, shape, off = unit.slot[pname]
                self.grads[pname] = out[off:off + math.prod(shape)].view(
                    shape)
        if self.replicas > 1:
            for pname in unit.names:
                self.grads[pname].div_(self.replicas)
        self.seen[name] = set()

    @staticmethod
    def _sum(t: torch.Tensor, group) -> None:
        if group is not None and tdist.get_world_size(group) > 1:
            dist.all_reduce(t, group)

    def take(self) -> Dict[str, torch.Tensor]:
        """The step's gradients in the parameters' order (the clip's norm
        sums the leaves in that order, as the unsharded step does)."""
        missing = [n for n in self.working if n not in self.grads]
        if missing:
            raise RuntimeError(f"no gradient reached {missing[:4]} "
                               f"({len(missing)} parameters)")
        grads, self.grads = self.grads, {}
        return {name: grads[name] for name in self.working}


def _remove_hooks(handles) -> None:
    for h in handles:
        h.remove()


def _global_mean(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the ranks (one all-reduce)."""
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].float() for k in keys])
    vals = dist.all_reduce(vals) / tdist.get_world_size()
    return {k: vals[i] for i, k in enumerate(keys)}


def _sharded_step(model: Model, opt_cfg: AdamWConfig, microbatch: int,
                  decay: Dict[str, bool], ctx: dist.DistContext,
                  batch_shard: Tuple[int, int]) -> Callable:
    """``make_train_step`` under ``ctx``: the ZeRO-3 step on DTensor
    master weights and moments (``shard_params``, ``init_opt_state``) and
    this rank's rows of the batch, shard ``batch_shard`` of the whole."""
    if ctx.mesh.size() != tdist.get_world_size():
        raise ValueError(f"the mesh holds {ctx.mesh.size()} of the "
                         f"{tdist.get_world_size()} ranks: a sharded step "
                         f"reduces over the whole process group")
    zero = _Zero3(model, ctx)
    zero.token_shard = batch_shard

    def grads_of(batch):
        if not microbatch:
            loss, metrics = model.train_loss(batch)
            loss.backward()
            return zero.take(), {k: v.detach() for k, v in metrics.items()}
        chunks = _microbatches(batch, microbatch)
        zero.accumulate = True
        per_chunk = []
        for chunk in chunks:
            loss, metrics = model.train_loss(chunk)
            loss.backward()
            per_chunk.append({k: v.detach() for k, v in metrics.items()})
        zero.accumulate = False
        for unit in zero.units:
            zero.reduce(unit)
        grads = {name: g / len(chunks) for name, g in zero.take().items()}
        metrics = {k: torch.stack([m[k] for m in per_chunk]).mean()
                   for k in per_chunk[0]}
        return grads, metrics

    def train_step(params, opt_state, batch):
        with dist.use_mesh(ctx.mesh, ctx.rules):   # the step's own context
            zero.begin(params)
            try:
                grads, metrics = grads_of(batch)
            finally:
                zero.end()
            metrics = _global_mean(metrics)
            params, opt_state, opt_metrics = apply_adamw(
                params, grads, opt_state, opt_cfg, decay)
        return params, opt_state, {**metrics, **opt_metrics}

    # the hooks go when the step does
    weakref.finalize(train_step, _remove_hooks, zero.handles)
    return train_step


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatch: int = 0,
                    batch_shard: Optional[Tuple[int, int]] = None
                    ) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    metrics are device tensors. Switches ``requires_grad`` on for the
    model's working weights. Under a mesh context the step is the ZeRO-3
    one: ``params`` and the moments are ``shard_params``' DTensors and
    ``batch`` is this rank's rows: shard ``batch_shard`` = (index, count)
    of the global batch (``Trainer.batch_shard``; default: the rank's own
    shard of "act_batch")."""
    for p in model.parameters():
        p.requires_grad_(True)
    decay = decay_mask(model)
    ctx = dist.current()
    if ctx is not None:
        if batch_shard is None:
            batch_shard = fsdp.row_shard(ctx)
        return _sharded_step(model, opt_cfg, microbatch, decay, ctx,
                             batch_shard)

    def grads_of(batch):
        if not microbatch:
            loss, metrics = model.train_loss(batch)
            loss.backward()
            return _grads(model), {k: v.detach()
                                   for k, v in metrics.items()}
        # gradient accumulation over batch-dim chunks, summed in float32
        chunks = _microbatches(batch, microbatch)
        n = len(chunks)
        acc: Dict[str, torch.Tensor] = {}
        per_chunk = []
        for chunk in chunks:
            loss, metrics = model.train_loss(chunk)
            loss.backward()
            for name, g in _grads(model).items():
                g = g.float()
                acc[name] = g if name not in acc else acc[name].add_(g)
            per_chunk.append({k: v.detach() for k, v in metrics.items()})
        grads = {name: g / n for name, g in acc.items()}
        metrics = {k: torch.stack([m[k] for m in per_chunk]).mean()
                   for k in per_chunk[0]}
        return grads, metrics

    def train_step(params, opt_state, batch):
        load_working(model, params)
        grads, metrics = grads_of(batch)
        params, opt_state, opt_metrics = apply_adamw(
            params, grads, opt_state, opt_cfg, decay)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_serve_step(model: Model) -> Callable:
    """(tokens, cache) -> (logits, cache): the decode-shape step."""
    def serve_step(tokens, cache):
        return model.decode_step(tokens, cache)
    return serve_step


class StepHook(Protocol):
    """Guard-side per-step callback. Return True to request a restart."""

    def __call__(self, step: int, wall_s: float,
                 metrics: Dict[str, float]) -> bool: ...


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@torch.no_grad()
def _assign(dst: Mapping, src: Mapping) -> None:
    """Copy a restored tree into the live one in place, so a parameter
    that is its own master stays shared with the model."""
    for key, val in src.items():
        if isinstance(val, Mapping):
            _assign(dst[key], val)
        else:
            dst[key].copy_(val)


class Trainer:
    """Trains the port's ``model`` (parameters already drawn or converted)
    on ``data``. ``params`` holds the float32 master weights by parameter
    name, at first the working weights widened; built under a mesh
    context, they and the moments are DTensors (``shard_params``) and each
    step takes this rank's rows of the batch."""

    def __init__(self, model: Model, data: SyntheticLM, cfg: TrainConfig,
                 ckpt: Optional[CheckpointManager] = None,
                 hook: Optional[StepHook] = None):
        self.model = model
        self.data = data
        self.cfg = cfg
        self.ckpt = ckpt
        self.hook = hook
        self.history: list = []
        self.last_recovery: Optional[Dict[str, Any]] = None

        self.ctx = dist.current()
        self.params = master_params(model) if self.ctx is None \
            else shard_params(model, self.ctx)
        self.batch_shard = (0, 1) if self.ctx is None \
            else fsdp.batch_shard(self.ctx, data.cfg.global_batch)
        self.opt_state = init_opt_state(self.params)
        self._step_fn = make_train_step(model, cfg.opt, cfg.microbatch,
                                        self.batch_shard)

    # ------------------------------------------------------------- loop

    def restore(self) -> int:
        """Restore from the fastest checkpoint tier available. With a
        ``TieredCheckpointManager`` this is the hot-spare path: the peer
        replica or local shard serves before durable storage; the tier
        used is recorded in ``self.last_recovery``."""
        if self.ckpt is None:
            return 0
        restore_any = getattr(self.ckpt, "restore_any", None)
        if restore_any is not None:
            out = restore_any(self.params, self.opt_state)
            if out is None:
                return 0
            params, opt_state, step, tier = out
            self.last_recovery = {"step": step, "ckpt_tier": tier.value,
                                  "hot_spare": tier.value == "peer"}
        else:
            out = self.ckpt.restore(self.params, self.opt_state)
            if out is None:
                return 0
            params, opt_state, step = out
            self.last_recovery = {"step": step, "ckpt_tier": "cold",
                                  "hot_spare": False}
        _assign(self.params, params)
        _assign(self.opt_state, opt_state)
        return step

    def run(self, on_metrics: Optional[Callable[[int, dict], None]] = None
            ) -> Dict[str, Any]:
        step = self.restore()
        while step < self.cfg.steps:
            batch = self.data.batch_at(step, *self.batch_shard)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            _sync(metrics["loss"])
            wall = time.perf_counter() - t0
            step += 1
            # one device-to-host read per step
            keys = sorted(metrics)
            vals = torch.stack([metrics[k].float() for k in keys]).tolist()
            m = dict(zip(keys, vals))
            self.history.append({"step": step, "wall_s": wall, **m})
            if on_metrics:
                on_metrics(step, m)

            if self.ckpt:
                # fast-tier snapshots (tiered manager only): peer replica
                # + local shard on the MTTF-tuned cadence
                on_step = getattr(self.ckpt, "on_step", None)
                if on_step:
                    on_step(step, self.params, self.opt_state)

            if self.ckpt and step % self.cfg.ckpt_interval == 0:
                self.ckpt.save(step, self.params, self.opt_state)
                # checkpoint boundary: Guard lands deferred mitigations
                # here (the hook may request a restart on the next step)
                on_ckpt = getattr(self.hook, "on_checkpoint", None)
                if on_ckpt:
                    on_ckpt(step)

            restart = bool(self.hook and self.hook(step, wall, m))
            if self.ctx is not None:
                restart = dist.rank0_value(restart)
            if restart:
                # Guard requested an immediate restart: rewind to the last
                # checkpoint (replacement happens at the cluster layer)
                fail_step = step
                t_restore = time.perf_counter()
                step = self.restore()
                restore_wall = time.perf_counter() - t_restore
                on_restart = getattr(self.hook, "on_restart", None)
                if on_restart:
                    on_restart(step)
                on_recovery = getattr(self.hook, "on_recovery", None)
                if on_recovery:
                    info = dict(self.last_recovery or
                                {"ckpt_tier": "cold", "hot_spare": False})
                    info["restore_s"] = restore_wall
                    info["replay_steps"] = max(fail_step - step, 0)
                    on_recovery(step, info)
        if self.ckpt:
            self.ckpt.wait()
        return {"final_step": step, "history": self.history}


__all__ = ["StepHook", "TrainConfig", "Trainer", "decay_mask", "load_working",
           "make_serve_step", "make_train_step", "master_params",
           "shard_params"]
