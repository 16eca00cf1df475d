"""Dtype policy, vocabulary padding and the seeded parameter initializer.

Parameters live in ``nn.Module``s (no annotated trees). The JAX package
keeps float32 parameters and casts the whole tree to the compute dtype on
every call; the port draws each parameter in ``Policy.param_dtype`` and
stores it cast to ``Policy.compute_dtype`` once. The cast rounds to
nearest even either way, so the numbers the model computes with are the
same.

Training keeps that split: the module holds the working weights in the
compute dtype (``requires_grad`` is switched on by the trainer), and the
trainer (``repro_torch.train.trainer``) holds the float32 master copy and
the AdamW moments, updates the master and copies it into the working
weights (rounding to nearest even) before each step. The reference's
float32 gradient is the float32 cast of its compute-dtype cotangent, which
is what the working weights' gradient holds, so the numbers are the same;
serving (prefill, decode) is untouched. Under a float32 ``Policy`` the
working weights are the master weights, with no second copy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16


def pad_vocab(vocab_size: int, multiple: int = 128) -> int:
    """Megatron-style vocab padding: TPU-lane friendly and TP-divisible."""
    return ((vocab_size + multiple - 1) // multiple) * multiple


class Init:
    """Draws parameters from one seeded ``torch.Generator`` on the target
    device, with the distributions and scales of the JAX package's
    ``dense`` / ``normal`` / ``zeros`` / ``ones``, and casts each to the
    compute dtype. The numbers differ from ``jax.random``'s; a test that
    needs both packages on the same weights carries them across with
    ``repro_torch.convert.model_params``.

    ``seed=None`` allocates without drawing, for a caller that fills every
    parameter itself."""

    def __init__(self, policy: Policy, device: DeviceLike = "cuda",
                 seed: Optional[int] = 0):
        self.policy = policy
        self.device = resolve(device)
        self.gen = None
        if seed is not None:
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    def _store(self, x: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(x.to(self.policy.compute_dtype),
                            requires_grad=False)

    def normal(self, shape: Sequence[int], scale: float = 0.02
               ) -> nn.Parameter:
        x = torch.empty(tuple(shape), dtype=self.policy.param_dtype,
                        device=self.device)
        if self.gen is not None:
            x.normal_(generator=self.gen).mul_(scale)
        return self._store(x)

    def dense(self, in_dim: int, out_dim: int,
              scale: Optional[float] = None) -> nn.Parameter:
        """(in, out) matrix, N(0, 1) * scale with scale 1/sqrt(in)."""
        scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
        return self.normal((in_dim, out_dim), scale)

    def full(self, shape: Sequence[int], value: float) -> nn.Parameter:
        return self._store(torch.full(tuple(shape), value,
                                      dtype=self.policy.param_dtype,
                                      device=self.device))

    def zeros(self, shape: Sequence[int]) -> nn.Parameter:
        return self.full(shape, 0.0)

    def ones(self, shape: Sequence[int]) -> nn.Parameter:
        return self.full(shape, 1.0)


__all__ = ["Init", "Policy", "pad_vocab"]
