"""Plain reference of the ssm family (RWKV6, "Finch"): blocks of a time
mix (data-dependent token-shift interpolation, a data-dependent decay and
the WKV recurrence with a per-head bonus u, a group norm a head, a SiLU
gate) and a channel mix (squared ReLU, a sigmoid receptance gate), each
after a LayerNorm, with a LayerNorm after the embedding and an RMSNorm
before the head. Norms take ``1 + scale`` (the group norm its own scale).

The WKV recurrence is taken in chunks of 32 tokens, from a zero state,
with each chunk's relative decays exponentiated through a clamp to
[-25, 25] (the model's chunked form; the clamp binds only where a chunk's
summed log-decay passes 25): within a chunk of decays w and inclusive
prefix sums L,

  y_t = sum_{s<t} (r_t e^{L_{t-1}}) . (k_s e^{-L_s}) v_s
        + (r_t . u k_t) v_t + (r_t e^{L_{t-1}}) S

and the state passes on as e^{L_C} S + sum_s (k_s e^{L_C - L_s}) v_s^T.
Autograd differentiates it. Parameter names are the program's.

The loss is ``embed``, each ``block`` (``time_mix_in``, the recurrence,
``time_mix_out``, ``channel_mix``) and ``head_loss`` in turn, so that a
check can run any one part alone on the activations it is handed.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.common import (Prec, Spec, cross_entropy, group_norm,
                                    layer_norm, rms_norm)

CHUNK = 32
CLAMP = 25.0
HEAD = "embed.head"          # the output head's parameter
LORA_MIX = 32
LORA_DECAY = 64


def param_spec(c: Mapping) -> List[Spec]:
    d, V, ff = c["d_model"], c["vocab_padded"], c["d_ff"]
    hd = c["rwkv_head_dim"]
    H = d // hd
    dense = lambda i, o: ((i, o), ("normal", 1.0 / math.sqrt(i)))
    out: List[Spec] = [
        ("embed.tok", (V, d), ("normal", 0.02)),
        ("embed.head", *dense(d, V)),
        ("ln_f", (d,), ("zeros",)),
        ("ln0", (d,), ("zeros",))]
    for i in range(c["num_layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), ("zeros",)),
                (p + "ln2", (d,), ("zeros",)),
                (p + "tm.mu_x", (d,), ("normal", 0.1)),
                (p + "tm.mu_rkvgw", (5, d), ("normal", 0.1)),
                (p + "tm.w1", *dense(d, 5 * LORA_MIX)),
                (p + "tm.w2", (5, LORA_MIX, d), ("normal", 0.01)),
                (p + "tm.dw0", (d,), ("full", -3.0)),
                (p + "tm.dw1", *dense(d, LORA_DECAY)),
                (p + "tm.dw2", (LORA_DECAY, d), ("normal", 0.01)),
                (p + "tm.u", (H, hd), ("normal", 0.1)),
                (p + "tm.wr", *dense(d, d)),
                (p + "tm.wk", *dense(d, d)),
                (p + "tm.wv", *dense(d, d)),
                (p + "tm.wg", *dense(d, d)),
                (p + "tm.wo", *dense(d, d)),
                (p + "tm.ln_x_s", (d,), ("ones",)),
                (p + "tm.ln_x_b", (d,), ("zeros",)),
                (p + "cm.mu_k", (d,), ("normal", 0.1)),
                (p + "cm.mu_r", (d,), ("normal", 0.1)),
                (p + "cm.wk", *dense(d, ff)),
                (p + "cm.wv", *dense(ff, d)),
                (p + "cm.wr", *dense(d, d))]
    return out


def decays(name: str, shape) -> bool:
    return name.startswith("layers.") or len(shape) >= 2


def _cexp(x):
    return torch.exp(x.clamp(-CLAMP, CLAMP))


def wkv(r, k, v, logw, u, prec: Prec = None, s0=None):
    """r/k/v/logw (B, S, H, hd) float32, u (H, hd), s0 (B, H, hd, hd) or
    None (zero) -> (y (B, S, H, hd), final state)."""
    prec = prec or Prec()
    mm = prec.mm32
    B, S, H, hd = r.shape
    C = CHUNK if S % CHUNK == 0 else S
    rt, kt, vt, wt = (t.transpose(1, 2) for t in (r, k, v, logw))
    state = rt.new_zeros(B, H, hd, hd) if s0 is None else s0
    strict = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
    ys = []
    for c0 in range(0, S, C):
        rr, kk, vv, w = (t[:, :, c0:c0 + C] for t in (rt, kt, vt, wt))
        incl = torch.cumsum(w, dim=2)
        excl = incl - w
        q_ = rr * _cexp(excl)
        a = mm(q_, (kk * _cexp(-incl)).transpose(-1, -2)).masked_fill(
            ~strict, 0.0)
        bonus = (rr * u[None, :, None] * kk).sum(-1, keepdim=True)
        ys.append(mm(a, vv) + bonus * vv + mm(q_, state))
        total = incl[:, :, -1]
        state = _cexp(total)[..., None] * state + \
            mm((kk * _cexp(total[:, :, None] - incl)).transpose(-1, -2), vv)
    y = torch.cat(ys, dim=2).transpose(1, 2)
    if prec.record is not None:
        prec.record.setdefault("wkv", []).append(
            {"in": [t.detach() for t in (r, k, v, logw, u)],
             "y": y.detach(), "state": state.detach()})
    return y, state


def _shift(x):
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ln(t, scale, eps):
    return layer_norm(t, 1.0 + scale, torch.zeros_like(scale), eps)


def time_mix_in(P, p: str, c: Mapping, prec: Prec, h):
    """The time mix up to the recurrence, over h (the first LayerNorm's
    output, (B, S, d)) -> r, k, v, logw (B, S, H, hd), the gate g (B, S,
    d)."""
    B, S, d = h.shape
    hd = c["rwkv_head_dim"]
    H = d // hd
    sx = _shift(h) - h
    t = torch.tanh(prec.mm(h + sx * P[p + "tm.mu_x"], P[p + "tm.w1"]))
    t = t.reshape(B, S, 5, LORA_MIX)
    mix = torch.einsum("bsrk,rkd->bsrd", prec.q(t), prec.q(P[p + "tm.w2"]))
    xr, xk, xv, xg, xw = (h + sx * (P[p + "tm.mu_rkvgw"][i] + mix[:, :, i])
                          for i in range(5))
    r = prec.mm(xr, P[p + "tm.wr"]).reshape(B, S, H, hd)
    k = prec.mm(xk, P[p + "tm.wk"]).reshape(B, S, H, hd)
    v = prec.mm(xv, P[p + "tm.wv"]).reshape(B, S, H, hd)
    g = F.silu(prec.mm(xg, P[p + "tm.wg"]))
    logw = -torch.exp(P[p + "tm.dw0"] + torch.tanh(xw @ P[p + "tm.dw1"])
                      @ P[p + "tm.dw2"]).reshape(B, S, H, hd)
    return r, k, v, logw, g


def time_mix_out(P, p: str, c: Mapping, prec: Prec, y, g):
    """The time mix after the recurrence: y (B, S, H, hd) through the group
    norm (one group a head), the gate and the output projection."""
    B, S, H, hd = y.shape
    y = group_norm(y.reshape(B, S, H * hd), P[p + "tm.ln_x_s"],
                   P[p + "tm.ln_x_b"], H, 1e-5) * g
    return prec.mm(y, P[p + "tm.wo"])


def channel_mix(P, p: str, c: Mapping, prec: Prec, x):
    """x plus the channel mix over its second LayerNorm."""
    h2 = _ln(x, P[p + "ln2"], c["norm_eps"])
    sx2 = _shift(h2) - h2
    kk = F.relu(prec.mm(h2 + sx2 * P[p + "cm.mu_k"], P[p + "cm.wk"])).square()
    gate = torch.sigmoid(prec.mm(h2 + sx2 * P[p + "cm.mu_r"], P[p + "cm.wr"]))
    return x + gate * prec.mm(kk, P[p + "cm.wv"])


def block(P, p: str, c: Mapping, prec: Prec, x):
    """The block whose parameters are named ``p`` + ..., over x (B, S, d).
    With a ``prec.record``, the recurrence's record also receives the
    gradient at its output ("dy")."""
    r, k, v, logw, g = time_mix_in(P, p, c, prec,
                                   _ln(x, P[p + "ln1"], c["norm_eps"]))
    y = wkv(r, k, v, logw, P[p + "tm.u"], prec)[0]
    if prec.record is not None and y.requires_grad:
        rec = prec.record["wkv"][-1]
        y.register_hook(lambda gy: rec.__setitem__("dy", gy.detach()))
    return channel_mix(P, p, c, prec, x + time_mix_out(P, p, c, prec, y, g))


def embed(P: Dict[str, torch.Tensor], c: Mapping,
          tokens: torch.Tensor) -> torch.Tensor:
    """The embedding and the LayerNorm after it: the first block's input."""
    return _ln(P["embed.tok"][tokens], P["ln0"], c["norm_eps"])


def head_loss(P: Dict[str, torch.Tensor], c: Mapping, x: torch.Tensor,
              labels: torch.Tensor, prec: Prec) -> torch.Tensor:
    """The final RMSNorm, the head and the mean cross-entropy over the last
    block's output x."""
    x = rms_norm(x, P["ln_f"], c["norm_eps"])
    logits = prec.mm(x, P[HEAD])
    V = c["vocab_size"]
    if logits.shape[-1] != V:
        pad = torch.arange(logits.shape[-1], device=x.device) >= V
        logits = logits.masked_fill(pad, -1e9)
    return cross_entropy(logits, labels)


def _keep(rec: dict, i: int, x: torch.Tensor, out: torch.Tensor) -> None:
    """Block i's input and output, and (by a hook) its output gradient."""
    rec["x"].append(x.detach())
    rec["out"].append(out.detach())
    rec["dout"].append(None)
    out.register_hook(lambda g: rec["dout"].__setitem__(i, g.detach()))
    if i == 0:
        x.register_hook(lambda g: rec.__setitem__("dx0", g.detach()))


def loss(P: Dict[str, torch.Tensor], c: Mapping, tokens: torch.Tensor,
         labels: torch.Tensor, prec: Prec):
    """-> (loss, cross-entropy, aux = 0), each block checkpointed. With a
    ``prec.record``, its "blocks" receives each block's input, output and
    output gradient."""
    rec = None
    if prec.record is not None:
        rec = prec.record.setdefault("blocks", {"x": [], "out": [],
                                                "dout": []})
    x = embed(P, c, tokens)
    for i in range(c["num_layers"]):
        out = checkpoint(block, P, f"layers.{i}.", c, prec, x,
                         use_reentrant=False)
        if rec is not None and len(rec["x"]) < c["num_layers"]:
            _keep(rec, i, x, out)
        x = out
    ce = head_loss(P, c, x, labels, prec)
    return ce, ce, ce.new_zeros(())
