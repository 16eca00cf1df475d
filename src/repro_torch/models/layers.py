"""Shared layers: norms, RoPE, the dense MLPs, embeddings, the logits head
and the training loss, with the JAX package's dtype handling (statistics
in float32, the result in the input's dtype).

Under tensor parallelism (``tp``, set on a module by
``repro_torch.models.model.Model`` when it keeps the rank's slice, see
``repro_torch.dist.api``) the MLP is column-parallel in ``wg``, ``wu``
and ``wi`` (the "ff" slice) and row-parallel in ``wo``; the token table
and head are vocab-parallel: a lookup of the rank's rows, the logits of
the rank's vocabulary slice, and the cross-entropy over the slices with a
global max and all-reduced sums."""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import api as dist
from repro_torch.models.common import Init

# ---------------------------------------------------------------- norms


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with the ``1 + scale`` convention (scale starts at zero)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim (RWKV's ln_x)."""
    *lead, d = x.shape
    xg = x.float().reshape(*lead, num_groups, d // num_groups)
    mu = xg.mean(dim=-1, keepdim=True)
    var = (xg - mu).square().mean(dim=-1, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------- RoPE


@functools.lru_cache(maxsize=16)
def _inv_freq(head_dim: int, theta: float, device: str) -> torch.Tensor:
    """1 / theta^(i / half) in float32, computed once on the host (so every
    device rotates by the same numbers) and kept on ``device``."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32) / half
    freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    return freq.to(device)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S) -> cos/sin (B, S, 1, head_dim // 2), float32: the
    JAX package's ``_rope_angles``, made once per forward or decode step
    and shared by every layer's q and k."""
    ang = positions.float()[..., None] * _inv_freq(
        head_dim, float(theta), str(positions.device))
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


@functools.lru_cache(maxsize=16)
def _mrope_streams(sections: Tuple[int, ...], device: str) -> torch.Tensor:
    """The stream of each frequency slot, ``repeat(arange(3), sections)``,
    made once on the host and kept on ``device`` (as ``_inv_freq``), so
    that a decode step copies nothing to the card."""
    return torch.repeat_interleave(torch.arange(len(sections)),
                                   torch.tensor(sections)).to(device)


def mrope_tables(positions3: torch.Tensor, head_dim: int,
                 sections: Sequence[int], theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (the vlm family, qwen2-vl): positions3 (3, B, S), one stream
    each for temporal, height and width -> cos/sin (B, S, 1, head_dim //
    2), float32, the tables ``apply_rope`` takes. Frequency slot i rotates
    by the position of its section's stream (the first ``sections[0]``
    slots by the temporal one, and so on), with ``rope_tables``'
    frequencies: the JAX package's ``apply_mrope``, split as RoPE is."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {half}")
    dev = positions3.device
    stream = _mrope_streams(tuple(sections), str(dev))
    ang = positions3.float()[stream].movedim(0, -1) * _inv_freq(
        head_dim, float(theta), str(dev))                   # (B, S, half)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]
               ) -> torch.Tensor:
    """x (B, S, H, hd) rotated by ``rope_tables`` (or ``mrope_tables``);
    GPT-NeoX half-split."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLPs


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (PyTorch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """Gated swiglu or geglu (``wg``, ``wu``), or plain gelu or squared-relu
    (``wi``) MLP, with ``wo``; every matrix is stored (in, out) as in the
    JAX package."""

    AXES = {"wg": ("fsdp", "ff"), "wu": ("fsdp", "ff"),
            "wi": ("fsdp", "ff"), "wo": ("ff", "fsdp")}

    def __init__(self, init: Init, d_model: int, d_ff: int, act: str):
        super().__init__()
        if act not in ("swiglu", "geglu", "gelu", "relu_sq"):
            raise NotImplementedError(f"activation {act!r} is not ported")
        self.act = act
        if act in ("swiglu", "geglu"):
            self.wg = init.dense(d_model, d_ff)
            self.wu = init.dense(d_model, d_ff)
        else:
            self.wi = init.dense(d_model, d_ff)
        self.wo = init.dense(d_ff, d_model)
        self.tp: Optional[dist.TPGroup] = None     # set when ff-sharded

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., D) -> (..., D): ``apply_mlp`` and, for one token per
        sequence, ``_mlp_step`` of the JAX package; with ``tp`` the rank's
        ff slice, its partial outputs summed over "model"."""
        if self.tp is not None:
            x = dist.copy_in(x, self.tp)
        if self.act == "swiglu":
            h = F.silu(x @ self.wg) * (x @ self.wu)
        elif self.act == "geglu":
            h = gelu(x @ self.wg) * (x @ self.wu)
        elif self.act == "gelu":
            h = gelu(x @ self.wi)
        else:
            h = F.relu(x @ self.wi).square()
        if self.tp is not None:
            return dist.reduce_out(h @ self.wo, self.tp)
        return h @ self.wo


# ---------------------------------------------------------------- embeddings


class Embed(nn.Module):
    """Token table ``tok`` (Vp, D) and, unless tied, the head (D, Vp)."""

    AXES = {"tok": ("vocab", "fsdp"), "head": ("fsdp", "vocab")}

    def __init__(self, init: Init, vocab_padded: int, d_model: int,
                 tie: bool):
        super().__init__()
        self.tok = init.normal((vocab_padded, d_model), 0.02)
        if not tie:
            self.head = init.dense(d_model, vocab_padded)
        self.tp: Optional[dist.TPGroup] = None     # set when vocab-sharded


def embed_tokens(embed: Embed, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding``: the same rows as ``tok[tokens]``, and on the card
    its backward sorts the indices and sums each row's gradient in float32
    (indexing's backward would add bfloat16 rows with atomics, in no fixed
    order). With ``tp`` each rank looks up the tokens of its rows, zeros
    for the others, and the ranks' rows are summed."""
    if embed.tp is None:
        return F.embedding(tokens, embed.tok)
    n = embed.tok.shape[0]
    local = tokens - embed.tp.rank * n
    outside = (local < 0) | (local >= n)
    x = F.embedding(local.clamp(0, n - 1), embed.tok)
    return dist.reduce_out(x.masked_fill(outside[..., None], 0), embed.tp)


def logits_from_hidden(embed: Embed, x: torch.Tensor, vocab_size: int,
                       tie: bool) -> torch.Tensor:
    """x (..., D) -> logits (..., Vp); padded vocab slots get -1e9 in x's
    dtype. With ``tp``, the logits of the rank's vocabulary slice (...,
    Vp / tp), the padded slots found by their global index."""
    if embed.tp is not None:
        x = dist.copy_in(x, embed.tp)
    w = embed.tok.t() if tie else embed.head
    logits = x @ w.to(x.dtype)
    vp = logits.shape[-1]
    start = 0 if embed.tp is None else embed.tp.rank * vp
    if vp * (1 if embed.tp is None else embed.tp.size) != vocab_size:
        pad = torch.arange(start, start + vp, device=x.device) >= vocab_size
        logits = logits + pad.to(x.dtype) * -1e9
    return logits


# ---------------------------------------------------------------- loss


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int, tp: Optional[dist.TPGroup] = None
                  ) -> torch.Tensor:
    """Mean token cross-entropy of logits (B, S, Vp) against labels (B, S);
    labels of -1 or >= ``vocab_size`` are masked.

    The JAX package's arithmetic: the row max is subtracted in the logits'
    dtype with no gradient through it, the log-sum-exp is taken in
    float32, and the mean runs over the valid count. The correct-class
    logit is a ``gather`` where the reference sums a one-hot mask: it
    picks the same value exactly, without a (B, S, Vp) mask.

    With ``tp`` the logits are the rank's vocabulary slice (B, S, Vp /
    tp): the max is taken over every rank (no gradient), and the sum of
    exponentials and the correct-class logit (zero on the ranks whose
    slice does not hold the label) are summed over the ranks."""
    vp = logits.shape[-1]
    lmax = logits.amax(dim=-1, keepdim=True).detach()
    if tp is not None:
        lmax = dist.max_all_reduce(lmax, tp)
    shifted = (logits - lmax).float()
    sumexp = torch.exp(shifted).sum(dim=-1)
    labels = labels.long()
    local = labels if tp is None else labels - tp.rank * vp
    correct = logits.gather(-1, local.clamp(0, vp - 1)[..., None])
    correct = correct[..., 0].float()
    if tp is not None:
        sumexp = dist.reduce_out(sumexp, tp)
        inside = (local >= 0) & (local < vp)
        correct = dist.reduce_out(
            torch.where(inside, correct, torch.zeros_like(correct)), tp)
    lse = torch.log(sumexp) + lmax[..., 0].float()
    mask = (labels >= 0) & (labels < vocab_size)
    nll = torch.where(mask, lse - correct, torch.zeros_like(lse))
    return nll.sum() / mask.sum().clamp_min(1)


__all__ = ["Embed", "MLP", "apply_rope", "cross_entropy", "embed_tokens",
           "gelu", "group_norm", "layer_norm", "logits_from_hidden",
           "mrope_tables", "rms_norm", "rope_tables"]
