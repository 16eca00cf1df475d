"""RWKV6 (Finch): attention-free linear recurrence with data-dependent decay.

Training and prefill run the chunked WKV recurrence through the WKV6
kernel on the card (its plain version on the CPU), with the model's
chunking: 32 tokens when the sequence is a multiple of 32, else one chunk
of the whole sequence. With gradients on, the call is differentiated by
the WKV6 backward kernel (``kernels.wkv6.ops``). Decode is one O(1) state
update in plain PyTorch, as in the JAX package, where it is no Pallas
kernel either.

Under tensor parallelism (``TimeMix.tp`` and ``ChannelMix.tp``, set by
the model where "model" divides the heads and the channel mix's ff, see
``repro_torch.dist.api``) the time mix runs on the rank's heads: ``wr``,
``wk``, ``wv`` and ``wg`` hold the rank's columns, ``u`` its rows and
``wo`` its rows (row-parallel, the partial outputs summed over "model");
the token shift's interpolation (``_ddlerp``) and the decay's low-rank
product stay whole on every rank, and the per-channel ``dw0``, ``dw2``,
``ln_x_s`` and ``ln_x_b`` are cut to the rank's heads (the group norm has
one group a head, so it is local). The channel mix holds the rank's ff
slice of ``wk`` and ``wv`` and the whole ``wr``. Every replicated tensor a
rank uses for its part only enters through ``dist.copy_in`` (or, cut to
its slice, ``dist.split_dim``), so its gradient is whole on every rank.
The decode state's ``wkv`` is the rank's heads (B, H / tp, hd, hd).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import api as dist
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.common import Init
from repro_torch.models.layers import group_norm, layer_norm

CHUNK = 32
LORA_MIX = 32
LORA_DECAY = 64


class TimeMix(nn.Module):
    AXES = {"mu_x": (None,), "mu_rkvgw": (None, None), "w1": ("fsdp", None),
            "w2": (None, None, "fsdp"), "dw0": (None,),
            "dw1": ("fsdp", None), "dw2": (None, "fsdp"),
            "u": ("heads", None), "wr": ("fsdp", "heads"),
            "wk": ("fsdp", "heads"), "wv": ("fsdp", "heads"),
            "wg": ("fsdp", "heads"), "wo": ("heads", "fsdp"),
            "ln_x_s": (None,), "ln_x_b": (None,)}

    def __init__(self, init: Init, cfg):
        super().__init__()
        d = cfg.d_model
        H, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        self.mu_x = init.normal((d,), 0.1)
        self.mu_rkvgw = init.normal((5, d), 0.1)
        self.w1 = init.dense(d, 5 * LORA_MIX)
        self.w2 = init.normal((5, LORA_MIX, d), 0.01)
        self.dw0 = init.full((d,), -3.0)                  # decay ~ .95
        self.dw1 = init.dense(d, LORA_DECAY)
        self.dw2 = init.normal((LORA_DECAY, d), 0.01)
        self.heads = H
        self.u = init.normal((H, hd), 0.1)
        self.wr = init.dense(d, d)
        self.wk = init.dense(d, d)
        self.wv = init.dense(d, d)
        self.wg = init.dense(d, d)
        self.wo = init.dense(d, d)
        self.ln_x_s = init.ones((d,))
        self.ln_x_b = init.zeros((d,))
        self.tp: Optional[dist.TPGroup] = None     # set when head-sharded

    # the replicated parameters that feed the rank's heads: whole, and cut
    # to the rank's channels (their dim)
    WHOLE = ("mu_x", "mu_rkvgw", "w1", "w2", "dw1")
    CUT = {"dw0": 0, "dw2": 1, "ln_x_s": 0, "ln_x_b": 0}


class ChannelMix(nn.Module):
    AXES = {"mu_k": (None,), "mu_r": (None,), "wk": ("fsdp", "ff"),
            "wv": ("ff", "fsdp"), "wr": ("fsdp", None)}

    def __init__(self, init: Init, cfg):
        super().__init__()
        d = cfg.d_model
        self.mu_k = init.normal((d,), 0.1)
        self.mu_r = init.normal((d,), 0.1)
        self.wk = init.dense(d, cfg.d_ff)
        self.wv = init.dense(cfg.d_ff, d)
        self.wr = init.dense(d, d)
        self.tp: Optional[dist.TPGroup] = None     # set when ff-sharded


class Block(nn.Module):
    """``ln1``, ``ln2``, ``tm`` (time mix), ``cm`` (channel mix)."""

    AXES = {"ln1": (None,), "ln2": (None,)}

    def __init__(self, init: Init, cfg):
        super().__init__()
        self.ln1 = init.zeros((cfg.d_model,))
        self.ln2 = init.zeros((cfg.d_model,))
        self.tm = TimeMix(init, cfg)
        self.cm = ChannelMix(init, cfg)


def _ddlerp(tm: TimeMix, x: torch.Tensor, sx: torch.Tensor):
    """Data-dependent token-shift interpolation -> (xr, xk, xv, xg, xw)."""
    xxx = x + sx * tm.mu_x.to(x.dtype)
    t = torch.tanh(xxx @ tm.w1)
    B, S, _ = t.shape
    t = t.reshape(B, S, 5, LORA_MIX)
    mix = torch.einsum("bsrk,rkd->bsrd", t, tm.w2.to(x.dtype))
    mus = tm.mu_rkvgw.to(x.dtype)
    return [x + sx * (mus[i] + mix[:, :, i]) for i in range(5)]


def _decay_logw(tm: TimeMix, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel log-decay (negative, float32)."""
    lo = xw.float() @ tm.dw1.float()
    dd = torch.tanh(lo) @ tm.dw2.float()
    return -torch.exp(tm.dw0.float() + dd)


def wkv_chunked(r, k, v, logw, u, state):
    """Chunked WKV6. r/k/v (B, S, H, hd) compute dtype; logw (B, S, H, hd)
    float32; u (H, hd); state (B, H, hd, hd) float32 -> (y (B, S, H, hd)
    float32, state). The exponent clamp makes the result depend on the
    chunk, so the kernel gets the model's chunk, not its own default. When
    gradients are on, ``wkv6`` returns through its autograd function (K4
    forward, K4' backward on the card)."""
    S = r.shape[1]
    return wkv6(r, k, v, logw, u, state,
                chunk=CHUNK if S % CHUNK == 0 else S)


def wkv_step(r, k, v, logw, u, state):
    """One decode step. r/k/v (B, H, hd); logw (B, H, hd) float32; state
    (B, H, hd, hd) float32."""
    rf, kf, vf = (t.float() for t in (r, k, v))
    y = torch.einsum("bhk,bhkv->bhv", rf, state) + \
        (rf * u.float()[None] * kf).sum(-1, keepdim=True) * vf
    state = torch.exp(logw)[..., None] * state + kf[..., None] * vf[:, :, None]
    return y, state


def _used(tm: TimeMix):
    """The time mix's parameters as this rank computes with them: ``tm``
    itself without tensor parallelism; else the rank's slices as they are,
    the replicated parameters through ``dist.copy_in`` and the
    per-channel ones cut to the rank's heads by ``dist.split_dim``."""
    tp = tm.tp
    if tp is None:
        return tm
    used = dict(tm.named_parameters(recurse=False))
    for name in TimeMix.WHOLE:
        used[name] = dist.copy_in(used[name], tp)
    for name, d in TimeMix.CUT.items():
        used[name] = dist.split_dim(used[name], d, tp)
    return SimpleNamespace(**used)


def _mix(tm: TimeMix, x, sx, state, wkv):
    """The time mix over x (B, S, D) (sx = shifted x minus x), the WKV
    recurrence ``wkv(r, k, v, logw, u, state)`` on the rank's heads ->
    (out (B, S, D), state); the row-parallel partial outputs are summed
    over "model"."""
    B, S, _ = x.shape
    hd = tm.u.shape[1]
    tp = tm.tp
    if tp is not None:
        x, sx = dist.copy_in(x, tp), dist.copy_in(sx, tp)
    w = _used(tm)
    xr, xk, xv, xg, xw = _ddlerp(w, x, sx)
    r = (xr @ w.wr).reshape(B, S, -1, hd)
    H = r.shape[2]
    k = (xk @ w.wk).reshape(B, S, H, hd)
    v = (xv @ w.wv).reshape(B, S, H, hd)
    g = F.silu(xg @ w.wg)
    logw = _decay_logw(w, xw).reshape(B, S, H, hd)
    y, state = wkv(r, k, v, logw, w.u, state)
    y = y.reshape(B, S, H * hd).to(x.dtype)
    y = group_norm(y, w.ln_x_s, w.ln_x_b, num_groups=H) * g
    out = y @ w.wo
    return (out if tp is None else dist.reduce_out(out, tp)), state


def time_mix(p: Block, cfg, x, sx, state):
    """x (B, S, D) prefill (sx = shifted x minus x); state (B, H, hd, hd),
    H the heads the rank holds."""
    return _mix(p.tm, x, sx, state, wkv_chunked)


def channel_mix(p: Block, x, sx):
    """x (..., D); with ``tp`` the rank's ff slice, its partial outputs
    summed over "model" (the receptance gate stays whole)."""
    pc = p.cm
    xk = x + sx * pc.mu_k.to(x.dtype)
    xr = x + sx * pc.mu_r.to(x.dtype)
    if pc.tp is not None:
        xk = dist.copy_in(xk, pc.tp)
    k = F.relu(xk @ pc.wk).square()
    kv = k @ pc.wv
    if pc.tp is not None:
        kv = dist.reduce_out(kv, pc.tp)
    return torch.sigmoid(xr @ pc.wr) * kv


def shift(x: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros at t = 0)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ln(x, scale, eps):
    return layer_norm(x, 1.0 + scale, torch.zeros_like(scale), eps)


def block(p: Block, cfg, x, wkv_state, *, collect_last: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor,
                     Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """One block (prefill). Returns (x, new_state, last), ``last`` the
    float32 (x_tm, x_cm) last-token activations that seed the decode token
    shift (None unless ``collect_last``)."""
    h = _ln(x, p.ln1, cfg.norm_eps)
    dt, wkv_state = time_mix(p, cfg, h, shift(h) - h, wkv_state)
    x = x + dt
    h2 = _ln(x, p.ln2, cfg.norm_eps)
    x = x + channel_mix(p, h2, shift(h2) - h2)
    last = (h[:, -1].float(), h2[:, -1].float()) if collect_last else None
    return x, wkv_state, last


def _step_wkv(r, k, v, logw, u, state):
    """``wkv_step`` on the (B, 1, H, hd) rows of ``_mix``."""
    y, state = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, state)
    return y[:, None], state


def block_step(p: Block, cfg, x, state: Dict[str, torch.Tensor]):
    """One decode step. x (B, D); state dict(wkv, x_tm, x_cm)."""
    h = _ln(x, p.ln1, cfg.norm_eps)
    sx = state["x_tm"].to(h.dtype) - h
    dt, wkv = _mix(p.tm, h[:, None], sx[:, None], state["wkv"], _step_wkv)
    x = x + dt[:, 0]

    h2 = _ln(x, p.ln2, cfg.norm_eps)
    sx2 = state["x_cm"].to(h2.dtype) - h2
    x = x + channel_mix(p, h2, sx2)
    return x, {"wkv": wkv, "x_tm": h.float(), "x_cm": h2.float()}


__all__ = ["Block", "CHUNK", "block", "block_step", "channel_mix", "shift",
           "time_mix", "wkv_chunked", "wkv_step"]
