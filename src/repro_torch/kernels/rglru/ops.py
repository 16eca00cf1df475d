"""Public RG-LRU scan entry point.

``rglru`` dispatches on where its input lies: a CPU tensor goes to the
plain PyTorch versions (``ref.py``), a CUDA tensor to the hand-written
kernels (``rglru.py``), which either launch or raise. There is no fall
back from a kernel to a plain version. When a gradient is wanted the call
is a ``torch.autograd.Function``: on the card its forward is K5, which
then also writes the float32 states, and its backward is K5'; on the CPU
the plain pair (``rglru_states_ref``, ``rglru_bwd_ref``). Without a
gradient (prefill) it is the forward alone. Meta tensors (the dry run)
go to the kernels' stand-ins (``rglru_scan_meta``,
``rglru_scan_bwd_meta``; see ``repro_torch.kernels.meta``) through the
same two paths.

``rglru_plain`` is the plain pair on any device: the CPU path, and the
yardstick a training step on the card is held to.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.rglru.ref import (rglru_bwd_ref, rglru_ref,
                                           rglru_states_ref)
from repro_torch.kernels.rglru.rglru import (rglru_scan, rglru_scan_bwd,
                                             rglru_scan_bwd_meta,
                                             rglru_scan_meta)

# the forward and backward of each path of ``_RGLRU``
_PATHS = {"kernel": (rglru_scan, rglru_scan_bwd),
          "meta": (rglru_scan_meta, rglru_scan_bwd_meta)}


class _RGLRU(torch.autograd.Function):
    """(xb, wa, wi, lam, h0) -> (H, h_last), saving the float32 states for
    the backward; ``path`` picks K5 / K5' ("kernel"), their stand-ins
    ("meta") or the plain pair ("plain")."""

    @staticmethod
    def forward(ctx, xb, wa, wi, lam, h0, path):
        if path in _PATHS:
            H, h_last, states = _PATHS[path][0](xb, wa, wi, lam, h0,
                                                keep_states=True)
        else:
            states, h_last = rglru_states_ref(xb, wa, wi, lam, h0)
            H = states.to(xb.dtype)
        ctx.save_for_backward(xb, wa, wi, lam, h0, states)
        ctx.path = path
        return H, h_last

    @staticmethod
    def backward(ctx, dH, dh_last):
        xb, wa, wi, lam, h0, states = ctx.saved_tensors
        if dH is None:
            dH = torch.zeros_like(xb)
        bwd = _PATHS[ctx.path][1] if ctx.path in _PATHS else rglru_bwd_ref
        dxb, dwa, dwi, dlam, dh0 = bwd(xb, wa, wi, lam, h0, states, dH,
                                       dh_last)
        return (dxb, dwa.to(wa.dtype), dwi.to(wi.dtype), dlam.to(lam.dtype),
                dh0.to(h0.dtype), None)


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rglru_plain(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
                lam: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rglru`` through the plain versions on any device: ``rglru_ref``,
    differentiated by ``rglru_bwd_ref`` (not by autograd through its
    in-place loop, which would copy the whole gradient every step)."""
    if _wants_grad(xb, wa, wi, lam, h0):
        return _RGLRU.apply(xb, wa, wi, lam, h0, "plain")
    return rglru_ref(xb, wa, wi, lam, h0)


def rglru(xb: torch.Tensor, wa: torch.Tensor, wi: torch.Tensor,
          lam: torch.Tensor, h0: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb (B, S, W), wa/wi/lam (W,), h0 (B, W) float32 -> (H (B, S, W) in
    xb's dtype, h_last (B, W) float32)."""
    if xb.device.type == "cpu":
        return rglru_plain(xb, wa, wi, lam, h0)
    if xb.device.type not in ("cuda", "meta"):
        raise ValueError(f"rglru: unsupported device {xb.device}")
    path = "meta" if xb.device.type == "meta" else "kernel"
    xb = xb.contiguous()
    if _wants_grad(xb, wa, wi, lam, h0):
        return _RGLRU.apply(xb, wa, wi, lam, h0, path)
    return _PATHS[path][0](xb, wa, wi, lam, h0)


__all__ = ["rglru", "rglru_plain"]
