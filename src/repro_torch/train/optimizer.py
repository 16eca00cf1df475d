"""AdamW with global-norm clipping and a warmup + cosine schedule: the JAX
package's ``repro.train.optimizer`` in PyTorch.

State is a dict ``{"mu", "nu", "count"}``: float32 moments keyed like the
parameters (``{name: tensor}``) and a 0-d int32 step count, all on the
parameters' device. The arithmetic is the reference's, in float32 on the
device, including its rule that only parameters of two or more dimensions
decay (a caller whose parameter layout differs from the reference's tree
passes the reference's answer as ``decay``; see
``repro_torch.train.trainer.decay_mask``). Unlike the reference (pure
functions), ``apply_adamw`` updates the parameters and moments in place,
so that a step holds no second copy of them; ``grad_norm`` and ``lr``
stay device tensors until the caller reads them.

Under a mesh the parameters and moments are DTensors (ZeRO-3,
``repro_torch.train.trainer``) and each gradient is a DTensor or this
rank's local shard of its parameter's placement: the update runs on each
rank's local shards, and ``global_norm`` is the norm of the whole
gradient, one all-reduce of the ranks' sums of squares.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.dist import api as dist

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac * peak``; a float32
    tensor on ``step``'s device (the CPU for a Python number)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.peak_lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) *
                         0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Mapping[str, torch.Tensor]) -> Dict:
    first = next(iter(params.values()))
    return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def _replicas(x: torch.Tensor) -> int:
    """How many ranks hold each element of ``x``: 1 for a plain tensor."""
    if not isinstance(x, DTensor):
        return 1
    return math.prod(x.device_mesh.size(i)
                     for i, pl in enumerate(x.placements)
                     if isinstance(pl, Replicate))


def global_norm(tree: Mapping[str, torch.Tensor],
                placed: Optional[Mapping[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares. Under a mesh
    each leaf is a DTensor, or this rank's local shard of the DTensor of
    its name in ``placed``: each rank sums its local shards (a leaf
    replicated on r ranks counted 1/r on each), and one all-reduce over the
    process group (the mesh's ranks) adds the ranks' sums."""
    placed = tree if placed is None else placed
    leaves = list(tree.values())
    if not any(isinstance(placed[k], DTensor) for k in tree):
        return torch.sqrt(sum(torch.linalg.vector_norm(
            x, dtype=torch.float32).square() for x in leaves))
    total = sum(torch.linalg.vector_norm(
        _local(x), dtype=torch.float32).square() / _replicas(placed[k])
        for k, x in tree.items())
    return torch.sqrt(dist.all_reduce(total))


@torch.no_grad()
def apply_adamw(params: Params, grads: Mapping[str, torch.Tensor],
                state: Dict, cfg: AdamWConfig,
                decay: Optional[Mapping[str, bool]] = None
                ) -> Tuple[Params, Dict, Dict[str, torch.Tensor]]:
    """One AdamW update of the float32 ``params`` (in place, with the
    moments). ``decay`` says which parameters take weight decay (default:
    those of two or more dimensions). Returns (params, state,
    {"grad_norm", "lr"})."""
    count = state["count"] + 1
    gnorm = global_norm(grads, params)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, count)
    b1c = 1 - torch.pow(cfg.b1, count.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, count.to(torch.float32))
    for name, p in params.items():
        mu, nu = _local(state["mu"][name]), _local(state["nu"][name])
        p = _local(p)
        g = _local(grads[name]).float() * scale
        mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        nu.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        step = (mu / b1c).div_((nu / b2c).sqrt_().add_(cfg.eps))
        if (p.dim() >= 2) if decay is None else decay[name]:
            step.add_(cfg.weight_decay * p)
        p.sub_(step.mul_(lr))
    return params, {"mu": state["mu"], "nu": state["nu"], "count": count}, \
        {"grad_norm": gnorm, "lr": lr}


__all__ = ["AdamWConfig", "apply_adamw", "global_norm", "init_opt_state",
           "lr_at"]
