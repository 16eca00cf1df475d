"""The RG-LRU recurrent block of the hybrid family (Griffin /
RecurrentGemma), the port of ``repro.models.rglru``.

The block: two input projections (a gate branch and a recurrence branch),
a short causal depthwise conv over time, the Real-Gated LRU

    a_t = exp(-c softplus(lam) sigmoid(wa x_t)),     c = 8,
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (sigmoid(wi x_t) x_t),

and an output projection gated by gelu of the gate branch. Over a
sequence (prefill) the LRU is the RG-LRU scan kernel on the card
(``repro_torch.kernels.rglru``, K5) and its plain version on the CPU,
where the JAX package runs ``lax.associative_scan``; one decode step is
plain tensor code, elementwise on (B, W), as there.

Under tensor parallelism (``RecBlock.tp``, set by the model where "model"
divides the LRU width) the block runs on the rank's slice of the width:
the reference gives the LRU's weights the logical axis "lru", which has no
rule, so they stay whole on every rank, and only its activations split
("act_ff"). Each rank takes its columns of ``wx``, ``wg``, ``conv``,
``conv_b``, ``wa``, ``wi`` and ``lam`` and its rows of ``wo`` through
``dist.split_dim`` (so each gradient is gathered whole on every rank),
its input through ``dist.copy_in``, runs the conv and the scan on (B, S,
W / tp), and sums the partial outputs over "model". Its decode state is
the rank's slice: ``h`` (B, W / tp), ``conv`` (B, K-1, W / tp).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.dist import api as dist
from repro_torch.kernels.rglru import decay_and_input
from repro_torch.kernels.rglru import gates as lru_gates
from repro_torch.kernels.rglru import rglru as lru_scan
from repro_torch.models.common import Init
from repro_torch.models.layers import MLP, gelu

State = Dict[str, torch.Tensor]


class RecBlock(nn.Module):
    """``wx`` (recurrence branch) and ``wg`` (gate branch) (D, W), the conv
    ``conv`` (K, W) and ``conv_b`` (W,), the LRU's diagonal gates ``wa``,
    ``wi`` and ``lam`` (W,), and ``wo`` (W, D), as in the JAX tree
    (``init_rec_block``); W is ``lru_width`` (or D)."""

    AXES = {"wx": ("fsdp", "lru"), "wg": ("fsdp", "lru"),
            "conv": (None, "lru"), "conv_b": ("lru",), "wa": ("lru",),
            "wi": ("lru",), "lam": ("lru",), "wo": ("lru", "fsdp")}

    def __init__(self, init: Init, cfg):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width or cfg.d_model
        self.lru_width = w
        self.wx = init.dense(d, w)
        self.wg = init.dense(d, w)
        self.conv = init.normal((cfg.conv_width, w),
                                1.0 / math.sqrt(cfg.conv_width))
        self.conv_b = init.zeros((w,))
        self.wa = init.normal((w,), 0.1)
        self.wi = init.normal((w,), 0.1)
        self.lam = init.full((w,), 0.65)            # a ~ .9 at init
        self.wo = init.dense(w, d)
        self.tp: Optional[dist.TPGroup] = None     # set when width-sharded

    # the dim of each parameter that holds the LRU width
    WIDTH = {"wx": 1, "wg": 1, "conv": 1, "conv_b": 0, "wa": 0, "wi": 0,
             "lam": 0, "wo": 0}


def width(p: RecBlock) -> int:
    """The LRU width this rank computes: W, or W / tp under tensor
    parallelism."""
    return p.lru_width // (1 if p.tp is None else p.tp.size)


def _used(p: RecBlock):
    """The block's parameters as this rank computes with them: ``p``
    itself without tensor parallelism, else each cut to the rank's slice of
    the width by ``dist.split_dim``."""
    if p.tp is None:
        return p
    return SimpleNamespace(**{name: dist.split_dim(getattr(p, name), d, p.tp)
                              for name, d in RecBlock.WIDTH.items()})


def _out(p: RecBlock, y: torch.Tensor) -> torch.Tensor:
    """The rank's partial output projections summed over "model"."""
    return y if p.tp is None else dist.reduce_out(y, p.tp)


class RecLayer(nn.Module):
    """A "rec" layer of the hybrid pattern: ``ln_rec``, ``rec``
    (``RecBlock``), ``ln_mlp`` and ``mlp``, as the JAX package's
    ``Model._init_hybrid_layer`` builds it."""

    AXES = {"ln_rec": (None,), "ln_mlp": (None,)}

    def __init__(self, init: Init, cfg):
        super().__init__()
        self.ln_rec = init.zeros((cfg.d_model,))
        self.rec = RecBlock(init, cfg)
        self.ln_mlp = init.zeros((cfg.d_model,))
        self.mlp = MLP(init, cfg.d_model, cfg.d_ff, cfg.act)


def _conv1d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
            state: Optional[torch.Tensor] = None):
    """Causal depthwise temporal conv. x (B, S, W); kernel (K, W).

    ``state`` (B, K-1, W) carries the last K-1 raw inputs for decode;
    returns (y, new_state), the new state float32, when it is given."""
    K, S = kernel.shape[0], x.shape[1]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + S] * kernel[i].to(x.dtype) for i in range(K))
    y = y + bias.to(x.dtype)
    if state is None:
        return y
    return y, xp[:, -(K - 1):].float()


def _gates(p: RecBlock, xb: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log-decay (float32, < 0) and input gate for the LRU. xb (..., W).
    The plain version's gates (``kernels.rglru.gates``, whose
    ``DECAY_SCALE`` is the reference's ``_C``), shared with the scan."""
    return lru_gates(xb, p.wa, p.wi, p.lam)


def rg_lru(p: RecBlock, xb: torch.Tensor, h0: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb (B, S, W) conv output; h0 (B, W) float32 carry -> (H (B, S, W)
    in xb's dtype, h_last (B, W) float32 = H[:, -1] before the cast)."""
    return lru_scan(xb, p.wa, p.wi, p.lam, h0)


def rg_lru_step(p: RecBlock, xb: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. xb (B, W); h0 (B, W) float32 -> (y in xb's dtype,
    h float32)."""
    a, bx = decay_and_input(xb, p.wa, p.wi, p.lam)
    h = a * h0 + bx
    return h.to(xb.dtype), h


def rec_block(p: RecBlock, cfg, x: torch.Tensor, h0: torch.Tensor, *,
              collect_state: bool = False):
    """The recurrent block over a sequence (prefill). x (B, S, D); h0 (B,
    ``width(p)``).

    Returns (out (B, S, D), h_last (B, W) float32, conv_state): the last
    K-1 raw conv inputs in float32, the decode's seed (None unless
    ``collect_state``); W the rank's width."""
    if p.tp is not None:
        x = dist.copy_in(x, p.tp)
    w = _used(p)
    gate = gelu(x @ w.wg)
    xb = x @ w.wx
    conv_state = None
    if collect_state:
        K = w.conv.shape[0]
        conv_state = xb[:, -(K - 1):].float()
    xbc = _conv1d(xb, w.conv, w.conv_b)
    y, h_last = rg_lru(w, xbc, h0)
    return _out(p, (y * gate) @ w.wo), h_last, conv_state


def rec_block_step(p: RecBlock, cfg, x: torch.Tensor, state: State
                   ) -> Tuple[torch.Tensor, State]:
    """One decode step. x (B, D); state {"h" (B, W), "conv" (B, K-1, W)},
    both float32, W the rank's width -> (out (B, D), the new state)."""
    w = _used(p)
    gate = gelu(x @ w.wg)
    xb = x @ w.wx
    xb2, conv_state = _conv1d(xb[:, None], w.conv, w.conv_b, state["conv"])
    y, h = rg_lru_step(w, xb2[:, 0], state["h"])
    return _out(p, (y * gate) @ w.wo), {"h": h, "conv": conv_state}


__all__ = ["RecBlock", "RecLayer", "State", "rec_block", "rec_block_step",
           "rg_lru", "rg_lru_step", "width"]
