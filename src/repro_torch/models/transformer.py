"""The dense decoder layer: prefill (``decoder_layer``) and one decode step
(``decoder_layer_step``). Sliding windows, cross attention and MoE FFNs
come with the hybrid, audio and moe families."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import Init
from repro_torch.models.layers import MLP, rms_norm


class DecoderLayer(nn.Module):
    """``ln_attn``, ``attn``, ``ln_mlp``, ``mlp`` as in the JAX tree."""

    AXES = {"ln_attn": (None,), "ln_mlp": (None,)}

    def __init__(self, init: Init, cfg):
        super().__init__()
        self.ln_attn = init.zeros((cfg.d_model,))
        self.attn = attn.Attention(init, cfg)
        self.ln_mlp = init.zeros((cfg.d_model,))
        self.mlp = MLP(init, cfg.d_model, cfg.d_ff, cfg.act)


Rope = Tuple[torch.Tensor, torch.Tensor]


def decoder_layer(p: DecoderLayer, cfg, x: torch.Tensor, rope: Rope
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill layer. x (B, S, D); ``rope`` the tables of positions 0..S-1.
    Returns (x, (k, v)) with k/v (B, S, Hkv, hd) for the cache."""
    h = rms_norm(x, p.ln_attn, cfg.norm_eps)
    q, k, v = attn.project_qkv(p.attn, cfg, h, rope)
    o = attn.full_attention(q, k, v, causal=True)
    x = x + attn.out_projection(p.attn, o)
    h = rms_norm(x, p.ln_mlp, cfg.norm_eps)
    return x + p.mlp(h), (k, v)


def decoder_layer_step(p: DecoderLayer, cfg, x: torch.Tensor,
                       kcache: torch.Tensor, vcache: torch.Tensor, pos: int,
                       rope: Rope) -> torch.Tensor:
    """Decode-step layer. x (B, D); caches (B, Hkv, Sc, hd), written in
    place at ``pos``; ``rope`` the (B, 1) tables of ``pos``. Returns x."""
    B, _ = x.shape
    h = rms_norm(x, p.ln_attn, cfg.norm_eps)[:, None]          # (B, 1, D)
    q, k, v = attn.project_qkv(p.attn, cfg, h, rope)
    o = attn.decode_attention(q[:, 0], kcache, vcache, k[:, 0], v[:, 0],
                              pos)
    x = x + o.reshape(B, -1) @ p.attn.wo
    h = rms_norm(x, p.ln_mlp, cfg.norm_eps)
    return x + p.mlp(h)


__all__ = ["DecoderLayer", "decoder_layer", "decoder_layer_step"]
