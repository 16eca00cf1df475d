"""Plain PyTorch pieces shared by the families' references: the precision
of the matrix products, norms, RoPE, causal attention, the cross-entropy
and AdamW, written from the equations of the model the program trains.

Nothing here imports the program. Every product runs in float32 with
TF32 off (``Prec("fp32")``), or, for the control, on operands rounded to
float8 e4m3 (``Prec("fp8")``): each operand scaled per tensor so that its
largest magnitude is e4m3's largest finite value (448), rounded, and
scaled back; the gradient passes the rounding unchanged (the operands'
rounded values are what the backward multiplies with).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10 mantissa bits (to nearest)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class Prec:
    """How the reference multiplies: "fp32", or "fp8" (the control: the
    products the program makes in bfloat16 on float8 operands, and those
    it makes in float32, the WKV recurrence's, on TF32 operands).
    ``record``, where a dict, receives under a family's keys what its
    checks read of the run (each WKV call, each block's input, output
    and output gradient)."""

    def __init__(self, name: str = "fp32", record=None):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name
        self.record = record

    def mm32(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A product the program makes in float32."""
        if self.name == "fp32":
            return a @ b
        ra, rb = tf32(a.detach()), tf32(b.detach())
        return (a + (ra - a).detach()) @ (b + (rb - b).detach())

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x as the product sees it: itself in float32, or rounded to e4m3
        with a per-tensor scale (straight-through)."""
        x = x.float()
        if self.name == "fp32":
            return x
        with torch.no_grad():
            s = E4M3_MAX / x.abs().amax().clamp_min(1e-30)
            r = (x * s).to(torch.float8_e4m3fn).float() / s
        return x + (r - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.bmm(self.q(a), self.q(b))


def no_tf32() -> None:
    """float32 products in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the ``1 + scale`` convention."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        (1.0 + scale)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float) -> torch.Tensor:
    *lead, d = x.shape
    xg = x.reshape(*lead, groups, d // groups)
    mu = xg.mean(-1, keepdim=True)
    var = (xg - mu).square().mean(-1, keepdim=True)
    return ((xg - mu) * torch.rsqrt(var + eps)).reshape(*lead, d) * scale \
        + bias


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) rotated by position, the two halves of each head
    as the pairs (GPT-NeoX's layout)."""
    S, hd = x.shape[1], x.shape[3]
    half = hd // 2
    inv = 1.0 / torch.pow(torch.tensor(float(theta)),
                          torch.arange(half, dtype=torch.float32) / half)
    ang = torch.arange(S, dtype=torch.float32)[:, None] * inv[None]
    cos = torch.cos(ang).to(x.device)[None, :, None]
    sin = torch.sin(ang).to(x.device)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     prec: Prec) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, H, hd) -> (B, S, H, hd): softmax of the
    scaled scores over the keys at or before each query."""
    B, S, H, hd = q.shape
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    s = prec.q(qt) @ prec.q(kt).transpose(-1, -2) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return (prec.q(p) @ prec.q(vt)).transpose(1, 2)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy of logits (B, S, V) against labels."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


# ---------------------------------------------------------------- AdamW


def lr_at(opt: Mapping, step: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of the peak."""
    peak, warm = opt["peak_lr"], opt["warmup_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(opt["total_steps"] - warm, 1), 0.0),
               1.0)
    return peak * (opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 *
                   (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(params: Dict[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
          state: Dict, opt: Mapping, decays: Iterable[str]) -> float:
    """One AdamW step in place: the gradient clipped to a global norm of
    ``grad_clip``, bias-corrected moments, decoupled weight decay on the
    parameters named in ``decays``. Returns the global norm before the
    clip."""
    decays = set(decays)
    state["count"] = count = state.get("count", 0) + 1
    gnorm = math.sqrt(sum(float(g.double().square().sum())
                          for g in grads.values()))
    scale = min(opt["grad_clip"] / max(gnorm, 1e-9), 1.0)
    lr = lr_at(opt, count)
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1 ** count, 1 - b2 ** count
    for name, p in params.items():
        g = grads[name] * scale
        mu = state.setdefault("mu", {}).setdefault(name, torch.zeros_like(p))
        nu = state.setdefault("nu", {}).setdefault(name, torch.zeros_like(p))
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).add_(g.square(), alpha=1 - b2)
        upd = (mu / b1c) / ((nu / b2c).sqrt() + opt["eps"])
        if name in decays:
            upd = upd + opt["weight_decay"] * p
        p.sub_(lr * upd)
    return gnorm


def leaf_norms(tree: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tree.items()}


Spec = Tuple[str, Tuple[int, ...], tuple]
