"""Plain reference of the moe family (deepseek-moe): a decoder of full
multi-head causal attention with RoPE, a leading dense SwiGLU layer, then
layers whose FFN is a routed mixture of SwiGLU experts plus shared ones.

Router: float32 logits, softmax, the top-k probabilities (the lower
expert first among equal ones) renormalised to sum to one. Each expert
keeps at most C = max(ceil(T k cf / E), k) of the call's (token, choice)
slots, taken in token order; a slot past that is dropped (adds nothing).
The loss is the mean cross-entropy plus ``router_aux_loss`` times the sum
over the MoE layers of E * sum_e(top-1 share_e * mean probability_e).
RMSNorms take ``1 + scale``. Parameter names are the program's, so that
the same drawn weights can be handed to both.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.common import (Prec, Spec, causal_attention,
                                    cross_entropy, rms_norm, rope)

HEAD = "embed.head"          # the output head's parameter


def _attn_spec(prefix: str, c: Mapping) -> List[Spec]:
    d, hd = c["d_model"], c["head_dim"]
    nq, nkv = c["num_heads"], c["num_kv_heads"]
    dense = lambda i, o: ((i, o), ("normal", 1.0 / math.sqrt(i)))
    return [(f"{prefix}ln_attn", (d,), ("zeros",)),
            (f"{prefix}attn.wq", *dense(d, nq * hd)),
            (f"{prefix}attn.wk", *dense(d, nkv * hd)),
            (f"{prefix}attn.wv", *dense(d, nkv * hd)),
            (f"{prefix}attn.wo", *dense(nq * hd, d)),
            (f"{prefix}ln_mlp", (d,), ("zeros",))]


def _mlp_spec(prefix: str, d: int, ff: int) -> List[Spec]:
    return [(f"{prefix}wg", (d, ff), ("normal", 1.0 / math.sqrt(d))),
            (f"{prefix}wu", (d, ff), ("normal", 1.0 / math.sqrt(d))),
            (f"{prefix}wo", (ff, d), ("normal", 1.0 / math.sqrt(ff)))]


def param_spec(c: Mapping) -> List[Spec]:
    """(name, shape, init) of every parameter, init ("normal", scale),
    ("zeros",), ("ones",) or ("full", value)."""
    d, V = c["d_model"], c["vocab_padded"]
    m = c["moe"]
    E, f = m["num_experts"], m["expert_d_ff"]
    out: List[Spec] = [
        ("embed.tok", (V, d), ("normal", 0.02)),
        (HEAD, (d, V), ("normal", 1.0 / math.sqrt(d))),
        ("ln_f", (d,), ("zeros",))]
    n_dense = 1 if m["first_layer_dense"] else 0
    if n_dense:
        out += _attn_spec("dense0.", c)
        out += _mlp_spec("dense0.mlp.", d, m["dense_d_ff"])
    for i in range(c["num_layers"] - n_dense):
        p = f"layers.{i}."
        out += _attn_spec(p, c)
        out += [(f"{p}moe.router", (d, E), ("normal", 1.0 / math.sqrt(d))),
                (f"{p}moe.wi", (E, d, 2 * f), ("normal", 1.0 / math.sqrt(d))),
                (f"{p}moe.wo", (E, f, d), ("normal", 1.0 / math.sqrt(f)))]
        if m["num_shared_experts"]:
            out += _mlp_spec(f"{p}moe.shared.", d,
                             m["num_shared_experts"] * f)
    return out


def decays(name: str, shape) -> bool:
    """AdamW decays every parameter of the layer stack and every matrix."""
    return name.startswith("layers.") or len(shape) >= 2


def _swiglu(P, p: str, x, prec: Prec):
    return prec.mm(F.silu(prec.mm(x, P[p + "wg"])) * prec.mm(x, P[p + "wu"]),
                   P[p + "wo"])


def _attention(P, p: str, c: Mapping, x, prec: Prec):
    B, S, _ = x.shape
    hd = c["head_dim"]
    h = rms_norm(x, P[p + "ln_attn"], c["norm_eps"])
    q, k, v = (prec.mm(h, P[p + n]).reshape(B, S, -1, hd)
               for n in ("attn.wq", "attn.wk", "attn.wv"))
    q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    o = causal_attention(q, k, v, prec).reshape(B, S, -1)
    return x + prec.mm(o, P[p + "attn.wo"])


def moe_ffn(P, p: str, c: Mapping, h, prec: Prec):
    """h (B, S, D) -> (routed + shared output (B, S, D), aux)."""
    m = c["moe"]
    E, K = m["num_experts"], m["top_k"]
    B, S, D = h.shape
    T = B * S
    x = h.reshape(T, D)
    probs = torch.softmax(x @ P[p + "moe.router"], dim=-1)       # (T, E)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = srt[:, :K], order[:, :K]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    frac = F.one_hot(idx[:, 0], E).float().mean(0)
    aux = E * (frac * probs.mean(0)).sum()
    C = max(math.ceil(T * K * m["capacity_factor"] / E), K)
    flat = idx.reshape(-1)                                      # token order
    rank = (F.one_hot(flat, E).cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    keep = rank < C
    dest = flat * C + rank.clamp(max=C - 1)
    tok = torch.arange(T, device=h.device).repeat_interleave(K)
    buf = x.new_zeros(E * C, D).index_copy(0, dest[keep], x[tok[keep]])
    hid = prec.bmm(buf.reshape(E, C, D), P[p + "moe.wi"])
    g, u = hid.chunk(2, dim=-1)
    y = prec.bmm(F.silu(g) * u, P[p + "moe.wo"]).reshape(E * C, D)
    slot = y[dest] * keep[:, None]
    out = (slot.reshape(T, K, D) * w[..., None]).sum(1).reshape(B, S, D)
    if m["num_shared_experts"]:
        out = out + _swiglu(P, p + "moe.shared.", h, prec)
    return out, aux


def _layer(P, p: str, c: Mapping, prec: Prec, moe: bool, x):
    x = _attention(P, p, c, x, prec)
    h = rms_norm(x, P[p + "ln_mlp"], c["norm_eps"])
    if not moe:
        return x + _swiglu(P, p + "mlp.", h, prec), x.new_zeros(())
    d, aux = moe_ffn(P, p, c, h, prec)
    return x + d, aux


def loss(P: Dict[str, torch.Tensor], c: Mapping, tokens: torch.Tensor,
         labels: torch.Tensor, prec: Prec):
    """-> (loss, cross-entropy, summed aux), each layer checkpointed."""
    m = c["moe"]
    x = P["embed.tok"][tokens]
    if m["first_layer_dense"]:
        x = _layer(P, "dense0.", c, prec, False, x)[0]
    auxes = []
    for i in range(c["num_layers"] - (1 if m["first_layer_dense"] else 0)):
        x, aux = checkpoint(_layer, P, f"layers.{i}.", c, prec, True, x,
                            use_reentrant=False)
        auxes.append(aux)
    x = rms_norm(x, P["ln_f"], c["norm_eps"])
    logits = prec.mm(x, P[HEAD])
    V = c["vocab_size"]
    if logits.shape[-1] != V:
        pad = torch.arange(logits.shape[-1], device=x.device) >= V
        logits = logits.masked_fill(pad, -1e9)
    ce = cross_entropy(logits, labels)
    aux = torch.stack(auxes).sum() if auxes else ce.new_zeros(())
    return ce + m["router_aux_loss"] * aux, ce, aux
