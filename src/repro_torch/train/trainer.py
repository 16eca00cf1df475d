"""Training loop with Guard hooks, fault-tolerant restart and optional
gradient accumulation: the port of ``repro.train.trainer`` (single
device; the sharded step comes with the port's ``dist``).

``make_train_step`` builds the (params, opt_state, batch) -> (params,
opt_state, metrics) step. ``params`` are the float32 master weights, a
dict keyed by the model's parameter names: the step first copies them
into the model's working weights (the compute dtype, rounded to nearest
even: the cast the JAX package applies to its tree on every call; nothing
to copy under a float32 policy, where the two are one), takes the loss
and its gradient through the working weights, and applies AdamW to the
master weights and moments in place.

Guard integration: the trainer reports its per-step wall time to a
``StepHook``; when the hook requests a restart (Guard's IMMEDIATE tier),
the trainer restores the last checkpoint, notifies the hook via
``on_restart`` (so partial telemetry windows are dropped) and
``on_recovery``, and continues: the closed loop of Fig. 1.
``repro_torch.guard.GuardStepHook`` is the production implementation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, Optional, Protocol

import numpy as np
import torch

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
    return {name: p.detach() if p.dtype == torch.float32
            else p.detach().float()
            for name, p in model.named_parameters()}


@torch.no_grad()
def load_working(model: Model, params: Mapping[str, torch.Tensor]) -> None:
    """Copy the master weights into the model's working weights (a no-op
    for a parameter that is its own master)."""
    for name, p in model.named_parameters():
        src = params[name]
        if src.data_ptr() != p.data_ptr():
            p.copy_(src)


def decay_mask(model: Model) -> Dict[str, bool]:
    """Which parameters AdamW decays. The reference's rule is "two or more
    dimensions", applied to its tree, where each layer's parameters are
    stacked on a leading layer axis: so every layer parameter decays, its
    norm scales and biases too, and of the rest only the matrices."""
    return {name: name.startswith("layers.") or p.dim() >= 2
            for name, p in model.named_parameters()}


def _grads(model: Model) -> Dict[str, torch.Tensor]:
    """Takes the working weights' gradients, clearing ``.grad``."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = p.grad
        p.grad = None
    return out


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    microbatch: int = 0) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    metrics are device tensors. Switches ``requires_grad`` on for the
    model's working weights."""
    for p in model.parameters():
        p.requires_grad_(True)
    decay = decay_mask(model)

    def grads_of(batch):
        if not microbatch:
            loss, metrics = model.train_loss(batch)
            loss.backward()
            return _grads(model), {k: v.detach()
                                   for k, v in metrics.items()}
        # gradient accumulation over batch-dim chunks, summed in float32
        B = np.shape(batch["tokens"])[0]
        if B % microbatch:
            raise ValueError(f"batch of {B} is no multiple of the "
                             f"microbatch {microbatch}")
        n = B // microbatch
        acc: Dict[str, torch.Tensor] = {}
        per_chunk = []
        for i in range(n):
            chunk = {k: v[i * microbatch:(i + 1) * microbatch]
                     for k, v in batch.items()}
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
    name, at first the working weights widened."""

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

        self.params = master_params(model)
        self.opt_state = init_opt_state(self.params)
        self._step_fn = make_train_step(model, cfg.opt, cfg.microbatch)

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
            batch = self.data.batch_at(step)
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

            if self.hook and self.hook(step, wall, m):
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
           "make_serve_step", "make_train_step", "master_params"]
