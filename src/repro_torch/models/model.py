"""The model of the dense, moe, ssm, hybrid, audio and vlm families:
training loss, prefill and KV-cache (or state) decode, the port of
``repro.models.model.Model``.

  Model(cfg, policy, device=..., seed=..., remat=...)   parameters drawn
                             on the device
  train_loss(batch)          -> (loss, metrics)
  prefill(tokens, enc_frames=None, *, positions=None, patch_embeds=None)
                             -> (last-token logits (B, Vp), cache)
  init_cache(batch, length)  -> zero cache
  decode_step(tokens, cache) -> (logits (B, Vp), cache)

The cache has the JAX package's layout: dense ``{"layers": (K, V), "pos"}``
with K/V (L, B, Hkv, Sc, hd) in the compute dtype; moe the same over its
MoE layers, and, where the first layer is dense (deepseek-moe's
``first_layer_dense``), ``"dense0"``: that layer's (K, V) of (B, Hkv, Sc,
hd); ssm ``{"wkv", "x_tm", "x_cm", "pos"}`` in float32; hybrid
``{"units", "tail", "pos"}``: ``units`` maps each layer of the pattern
(``"l0_rec"``, ``"l1_rec"``, ``"l2_attn"``) to its cache stacked over the
units, a rec layer's ``{"h" (n, B, W), "conv" (n, B, K-1, W)}`` in
float32 and an attention layer's ring (K, V) of (n, B, Hkv, window, hd)
in the compute dtype, and ``tail`` lists the remaining layers' caches
unstacked; audio ``{"layers": (K, V, CK, CV), "pos"}``: the decoder's
self-attention K/V (L, B, Hkv, Sc, hd) and its cross-attention K/V of the
encoder output (L, B, Hkv, T, hd), T the encoder's frames, all in the
compute dtype. ``pos`` is a Python int here (a 0-d int32 array there).
``decode_step`` updates the
cache's tensors in place and returns the same dict with ``pos`` advanced;
the JAX package returns a new cache. ``train_loss`` runs with gradients
through the working weights (see ``models.common``); with
``remat="full"`` (the reference's default) each layer is
``torch.utils.checkpoint``-ed, so its forward, flash attention or the
WKV6 kernel included, runs again in the backward; the moe family's
``dense0`` runs outside the checkpoint, as in the reference, and its
loss adds ``router_aux_loss`` times the MoE layers' summed aux. The
hybrid family (recurrentgemma: units of (rec, rec, attn) layers, a tail
of the pattern's first layers, the gemma embedding scale, the attention
in a sliding window) checkpoints each unit as one function, as the
reference's remat wraps its unit scan, and runs the tail outside any
checkpoint, as the reference runs it after the scan; its RG-LRU calls
differentiate through K5' and its attention through K3' with the window
on the card. The audio family (whisper: an encoder of full self-attention
over precomputed frames, ``batch["enc_frames"]`` (B, T, D), and a decoder
with cross attention over its output, LayerNorm throughout, learned
position tables ``pos_enc`` and ``pos_dec`` and no RoPE) checkpoints each
encoder and each decoder layer; every one of its attentions runs through
K3, and K3' when training. The vlm family (qwen2-vl) is the dense
family's layer stack with two changes, as in the reference: M-RoPE
(``layers.mrope_tables`` of the (3, B, S) temporal, height and width
positions, which come from the caller: ``batch["positions"]``, or
``prefill``'s ``positions``; decode puts all three streams at the
cache's ``pos``), and the stub vision tower's precomputed patch
embeddings ``patch_embeds`` (B, P, D), which overwrite the first P token
embeddings (no gradient reaches the token table from those rows).

  param_axes()               -> {parameter name: logical axes}, the
                                reference's ``Model.param_axes()`` without
                                its stacked "layer" axis

Under a mesh (``repro_torch.dist``), ``train_loss`` constrains the
activations at the reference's sites, and a sharded training step sets
``zero3`` (``repro_torch.train.trainer``) to gather each unit of
``zero3_units`` just in time: "in" (the token table, ``ln0``) before the
embedding (the audio family: also ``pos_enc``, ``ln_enc`` and
``pos_dec``), "dense0" before that layer, each layer (the hybrid family:
each unit; the audio family: each encoder, then each decoder layer) at its
start, inside the checkpointed function so that the
recompute gathers again, the hybrid "tail" once before it, and "out"
(``ln_f``, the head) after the layers. After such a step the working
weights hold no storage (``weights_released``) and every entry point
raises until ``repro_torch.train.load_working`` brings them back.
Serving under a mesh with the working weights sharded over "fsdp" hangs
a ``models.fsdp.ServeShards`` on ``zero3`` the same way: ``prefill`` and
``decode_step`` (the hybrid family's decode included) gather "in" for
the whole call, and each other unit just before it runs, releasing it
once its output exists; each "data" rank serves its own rows, and the
moe family's layers route them with the holder's ``token_shard``. The
reference's decode leaves this gather to GSPMD on its sharded params;
the port gathers each unit in decode as in prefill. Without a holder, a
model served under the mesh keeps its working weights whole over
"data".

Tensor parallelism: a model of any family built under a mesh whose
"model" axis is wider than 1 draws (or, with ``seed=None``, allocates)
every parameter whole, as every rank does, and keeps the rank's slice
(``tp_dims``: parameter -> the dim split; ``global_shapes`` the whole
shapes) of the query heads (``wq``, ``bq``, ``wo``; the audio family's
encoder and cross attention too), the KV heads where "model" divides them
(``wk``, ``wv``, ``bk``, ``bv``), the MLPs' ff, the vocabulary (``tok``,
``head``), the experts (``wi``, ``wo``), rwkv6's time-mix heads (``wr``,
``wk``, ``wv``, ``wg``, ``u``, ``wo``) and channel-mix ff (``wk``,
``wv``); each slice only where "model" divides what it splits, else the
module computes whole on every rank, as the reference's divisibility
fallback replicates it. The RG-LRU block keeps its weights whole (the
reference's "lru" axis has no rule) and computes on the rank's slice of
its width (``models.rglru``). The residual stream stays replicated over
"model"; in training with remat "full" each checkpointed layer of the
dense, moe and vlm families keeps the rank's S / tp sequence slice of its
input (the reference's "act_seq_ckpt") and gathers it in the forward and
in the recompute. Logits are the rank's vocabulary slice in training
(``cross_entropy`` over the slices) and gathered whole at the last
position (``prefill``, ``decode_step``), so every rank's server takes the
same greedy token. The self-attention KV cache (the audio family's
decoder's too) holds every KV head; where its length divides "model" it
is the rank's sequence slice (B, Hkv, Sl / tp, hd) and decode is
flash-decode, else the whole cache on every rank; ``cache["kv_shards"]``
says which (prefill turns its head-sliced K/V into that layout with one
``all_to_all`` a tensor). The hybrid family's rings hold their KV heads
whole on every rank (its one KV head of 2,048 x 256 is 1 MB a layer and a
row in bf16, and ring decode is no flash-decode in the reference either).
The other per-rank caches: the ssm family's ``wkv`` holds the rank's
heads (L, B, H / tp, hd, hd) (``x_tm``, ``x_cm`` whole); the hybrid
family's ``h`` and ``conv`` the rank's LRU width; the audio family's cross
K/V the rank's KV heads (L, B, Hkv / tp, T, hd) where "model" divides
them: they never grow, so cross decode needs no collective (the
reference's "act_kv_seq" layout is a placement, not an answer), else every
KV head. ``cache_tp_dims`` names each cache tensor's split dim and
``repro_torch.convert.whole_cache`` gathers a rank's cache into the
reference's layout. Every entry point raises ``ValueError`` under a mesh
whose "model" width is not the one the model was built for.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve
from repro_torch.dist import api as dist
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru
from repro_torch.models import rwkv6
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import Attention
from repro_torch.models.common import Init, Policy, pad_vocab
from repro_torch.models.layers import (MLP, Embed, cross_entropy,
                                       embed_tokens, layer_norm,
                                       logits_from_hidden, mrope_tables,
                                       rms_norm, rope_tables)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
MAX_DECODE_LEN = 32_768       # rows of the audio decoder's position table
REMAT = ("full", "none")

Cache = Dict[str, Any]


class Model(nn.Module):
    AXES = {"ln_f": (None,), "ln0": (None,), "ln_enc": (None,),
            "pos_enc": (None, "fsdp"), "pos_dec": (None, "fsdp")}

    def __init__(self, cfg, policy: Optional[Policy] = None, *,
                 device: DeviceLike = "cuda", seed: Optional[int] = 0,
                 remat: str = "full"):
        """Build the model with its parameters on ``device``, drawn from a
        ``torch.Generator`` seeded with ``seed`` (``None``: allocated, not
        drawn, for ``repro_torch.convert.model_params`` to fill).
        ``remat`` ("full" or "none") is how ``train_loss`` keeps
        activations."""
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet; "
                f"the port serves and trains {FAMILIES}")
        if remat not in REMAT:
            raise ValueError(f"remat={remat!r}, expected one of {REMAT}")
        self.remat = remat
        self.cfg = cfg
        self.policy = policy or Policy()
        self.device = resolve(device)
        self.vocab_padded = pad_vocab(cfg.vocab_size)
        init = Init(self.policy, self.device, seed)
        self.embed = Embed(init, self.vocab_padded, cfg.d_model,
                           cfg.tie_embeddings)
        self.ln_f = init.zeros((cfg.d_model,))
        if cfg.family == "ssm":
            self.ln0 = init.zeros((cfg.d_model,))
            self.layers = nn.ModuleList(rwkv6.Block(init, cfg)
                                        for _ in range(cfg.num_layers))
        elif cfg.family == "hybrid":
            # the reference's scan-stacked units, one module each, and its
            # tail list
            n_units = cfg.num_layers // len(cfg.block_pattern)
            self.units = nn.ModuleList(
                nn.ModuleDict({key: self._hybrid_layer(init, kind)
                               for key, kind in self._hybrid_keys()})
                for _ in range(n_units))
            self.tail = nn.ModuleList(self._hybrid_layer(init, kind)
                                      for kind in self._hybrid_tail_kinds())
        elif cfg.is_encoder_decoder:
            self.enc_layers = nn.ModuleList(
                tfm.EncoderLayer(init, cfg)
                for _ in range(cfg.encoder_layers))
            self.ln_enc = init.zeros((cfg.d_model,))
            self.dec_layers = nn.ModuleList(
                tfm.DecoderLayer(init, cfg, cross=True)
                for _ in range(cfg.num_layers))
            self.pos_enc = init.normal((cfg.encoder_seq_len, cfg.d_model))
            self.pos_dec = init.normal((MAX_DECODE_LEN, cfg.d_model))
        elif cfg.moe:
            n_dense = 1 if cfg.moe.first_layer_dense else 0
            if n_dense:
                self.dense0 = tfm.DecoderLayer(init, cfg,
                                               d_ff=cfg.moe.dense_d_ff)
            self.layers = nn.ModuleList(
                tfm.DecoderLayer(init, cfg, moe_layer=True)
                for _ in range(cfg.num_layers - n_dense))
        else:
            self.layers = nn.ModuleList(tfm.DecoderLayer(init, cfg)
                                        for _ in range(cfg.num_layers))
        # the sharded step's ZeRO-3 gather (an object with ``gather(unit)``
        # and ``release(unit)`` of the units of ``zero3_units``), None
        # outside one; set when such a step has released the weights
        self.zero3 = None
        self.weights_released = False
        self.tp: Optional[dist.TPGroup] = None
        self.tp_dims: Dict[str, int] = {}
        self._full_shapes: Dict[str, Tuple[int, ...]] = {}
        ctx = dist.current()
        if ctx is not None and ctx.sizes.get(dist.TP_AXIS, 1) > 1:
            self._shard_tp(dist.tp_group(ctx))

    # ------------------------------------------------ tensor parallelism

    def _shard_tp(self, tp: dist.TPGroup) -> None:
        """Keep the rank's slice of each tensor-parallel parameter (see the
        module's docstring) and mark its module."""
        cfg, n = self.cfg, tp.size
        for prefix, mod in self.named_modules():
            dims: Dict[str, int] = {}
            if isinstance(mod, Attention):
                mod.tp = tp
                mod.heads_local = cfg.num_heads % n == 0
                mod.kv_local = mod.heads_local and cfg.num_kv_heads % n == 0
                if mod.heads_local:
                    dims.update(wq=1, bq=0, wo=0)
                if mod.kv_local:
                    dims.update(wk=1, wv=1, bk=0, bv=0)
            elif isinstance(mod, MLP) and mod.wo.shape[0] % n == 0:
                mod.tp = tp
                dims.update(wg=1, wu=1, wi=1, wo=0)
            elif isinstance(mod, Embed) and mod.tok.shape[0] % n == 0:
                mod.tp = tp
                dims.update(tok=0, head=1)
            elif isinstance(mod, moe_mod.MoE) and \
                    cfg.moe.num_experts % n == 0:
                mod.tp = tp
                dims.update(wi=0, wo=0)
            elif isinstance(mod, rwkv6.TimeMix) and mod.heads % n == 0:
                mod.tp = tp
                dims.update(u=0, wr=1, wk=1, wv=1, wg=1, wo=0)
            elif isinstance(mod, rwkv6.ChannelMix) and \
                    mod.wv.shape[0] % n == 0:
                mod.tp = tp
                dims.update(wk=1, wv=0)
            elif isinstance(mod, rglru.RecBlock) and mod.lru_width % n == 0:
                mod.tp = tp             # whole weights, the rank's width
            for pname, d in dims.items():
                param = getattr(mod, pname, None)
                if param is None:
                    continue
                name = f"{prefix}.{pname}" if prefix else pname
                self._full_shapes[name] = tuple(param.shape)
                self.tp_dims[name] = d
                param.data = self._slice(param.data, d, tp).clone()
        self.tp = tp

    @staticmethod
    def _slice(t, d: int, tp: dist.TPGroup):
        """The rank's slice of ``t`` (a tensor or an array) along ``d``, a
        view."""
        n = t.shape[d] // tp.size
        index = [slice(None)] * t.ndim
        index[d] = slice(tp.rank * n, (tp.rank + 1) * n)
        return t[tuple(index)]

    def tp_slice(self, name: str, full):
        """The rank's slice of parameter ``name``'s whole value ``full`` (a
        tensor or an array; a view, ``full`` itself where the parameter is
        not split)."""
        d = self.tp_dims.get(name)
        return full if d is None else self._slice(full, d, self.tp)

    def global_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """{parameter name: its whole shape} (the rank's slice is
        ``tp_slice`` of it)."""
        return {name: self._full_shapes.get(name, tuple(p.shape))
                for name, p in self.named_parameters()}

    def _require_mesh(self) -> None:
        """Raises under a mesh whose "model" width is not this model's."""
        ctx = dist.current()
        width = 1 if ctx is None else ctx.sizes.get(dist.TP_AXIS, 1)
        if width != (1 if self.tp is None else self.tp.size):
            raise ValueError(
                f"the model was built for a {dist.TP_AXIS!r} axis of "
                f"{1 if self.tp is None else self.tp.size}, the mesh's is "
                f"{width}: build the model under the mesh it runs on")

    # ------------------------------------------------------------ hybrid

    def _hybrid_keys(self) -> List[Tuple[str, str]]:
        """(cache and parameter key, kind) of each layer of a unit."""
        return [(f"l{i}_{kind}", kind)
                for i, kind in enumerate(self.cfg.block_pattern)]

    def _hybrid_tail_kinds(self) -> List[str]:
        pat = self.cfg.block_pattern
        return [pat[i % len(pat)]
                for i in range(self.cfg.num_layers % len(pat))]

    def _hybrid_layer(self, init: Init, kind: str) -> nn.Module:
        if kind == "attn":
            return tfm.DecoderLayer(init, self.cfg)
        return rglru.RecLayer(init, self.cfg)

    def param_axes(self) -> Dict[str, dist.Axes]:
        """``{parameter name: logical axes}`` from each module's ``AXES``
        table (the axes the reference initializes each parameter with);
        the port's layers are not stacked, so no axis is "layer"."""
        return {f"{mod}.{name}" if mod else name: type(m).AXES[name]
                for mod, m in self.named_modules()
                for name, _ in m.named_parameters(recurse=False)}

    def stacks(self) -> Tuple[str, ...]:
        """The names of the model's lists of like layers, in the order the
        forward runs them: the reference's scan-stacked subtrees."""
        if self.cfg.family == "hybrid":
            return ("units",)
        if self.cfg.is_encoder_decoder:
            return ("enc_layers", "dec_layers")
        return ("layers",)

    def zero3_units(self) -> Dict[str, List[str]]:
        """The sharded step's units, each gathered as one, in the order
        the forward reads them: {unit: parameter names}. "in" is what it
        reads outside the layers before the head (the audio family:
        ``pos_enc``, ``ln_enc`` after the encoder, and the token table
        and ``pos_dec``), "dense0" the moe family's dense first layer,
        "layers.<i>" each layer (the hybrid family: "units.<u>" each unit
        of its pattern, then "tail" its remaining layers; the audio
        family: "enc_layers.<i>" each encoder layer, then
        "dec_layers.<i>" each decoder layer), "out" what it reads after
        them (``ln_f`` and an untied head). "in", "dense0", "tail" and
        "out" are not checkpointed: their gathered weights stay until
        their gradients arrive."""
        names = [n for n, _ in self.named_parameters()]
        late = ("ln_f", "embed.head")
        stacks = tuple(f"{s}." for s in self.stacks()) + ("dense0.",
                                                          "tail.")
        units = {"in": [n for n in names
                        if not n.startswith(stacks) and n not in late]}
        if hasattr(self, "dense0"):
            units["dense0"] = [n for n in names if n.startswith("dense0.")]
        for stack in self.stacks():
            for i in range(len(getattr(self, stack))):
                units[f"{stack}.{i}"] = [n for n in names
                                         if n.startswith(f"{stack}.{i}.")]
        if len(getattr(self, "tail", ())):
            units["tail"] = [n for n in names if n.startswith("tail.")]
        units["out"] = [n for n in names if n in late]
        return units

    def _gather(self, unit: str) -> None:
        if self.zero3 is not None:
            self.zero3.gather(unit)

    def _release(self, unit: str) -> None:
        """Frees ``unit``'s gathered weights in a serving path, once its
        output exists (``models.fsdp``)."""
        if self.zero3 is not None:
            self.zero3.release(unit)

    def _token_shard(self) -> Optional[moe_mod.TokenShard]:
        """(this rank's batch shard, shards) inside a sharded step or under
        a serving holder (``models.fsdp.ServeShards``)."""
        return None if self.zero3 is None else self.zero3.token_shard

    def require_weights(self) -> None:
        """Raises where a sharded step left the working weights empty, or
        under a mesh the model was not built for."""
        self._require_mesh()
        if self.weights_released and self.zero3 is None:
            raise RuntimeError(
                "the working weights were released by a sharded training "
                "step; load them from the master weights first "
                "(repro_torch.train.load_working(model, trainer.params))")

    # ------------------------------------------------------------ forward

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _positions(self, B: int, S: int, positions=None) -> torch.Tensor:
        """The reference's ``_positions``: the caller's positions where
        given, else 0..S-1 for each row (B, S); the vlm family's (3, B,
        S) M-RoPE streams must be given: without them it raises
        ``KeyError``, as the reference's ``batch["positions"]`` does."""
        if positions is not None:
            return torch.as_tensor(positions, device=self.device)
        if self.cfg.mrope_sections:
            raise KeyError("positions")
        return torch.arange(S, dtype=torch.int32,
                            device=self.device)[None].expand(B, S)

    def _rope(self, positions: torch.Tensor) -> tfm.Rope:
        """The RoPE tables of ``positions`` (B, S), or M-RoPE's of the vlm
        family's (3, B, S) streams, shared by every layer."""
        cfg = self.cfg
        if cfg.mrope_sections:
            return mrope_tables(positions, cfg.resolved_head_dim,
                                cfg.mrope_sections, cfg.rope_theta)
        return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)

    def _rope_at(self, B: int, pos: int) -> tfm.Rope:
        """The tables of the decode position ``pos`` for B rows; the vlm
        family's three streams all at ``pos``, as the reference broadcasts
        it (``decoder_layer_step``)."""
        shape = (3, B, 1) if self.cfg.mrope_sections else (B, 1)
        return self._rope(torch.full(shape, pos, dtype=torch.int32,
                                     device=self.device))

    def _embed(self, tokens: torch.Tensor, patch_embeds=None
               ) -> torch.Tensor:
        """The token rows of the dense, moe and vlm families; the first P
        overwritten, out of place, by ``patch_embeds`` (B, P, D) in the
        compute dtype (the reference's ``dynamic_update_slice`` of the
        stub vision tower's output)."""
        x = embed_tokens(self.embed, tokens)
        if patch_embeds is None:
            return x
        pe = torch.as_tensor(patch_embeds, device=self.device).to(x.dtype)
        B, S, D = x.shape
        if pe.dim() != 3 or pe.shape[0] != B or pe.shape[2] != D \
                or pe.shape[1] > S:
            raise ValueError(f"patch_embeds of shape {tuple(pe.shape)} do "
                             f"not fit the embeddings {(B, S, D)}")
        return torch.cat([pe, x[:, pe.shape[1]:]], dim=1)

    def _forward(self, tokens: torch.Tensor, enc_frames=None,
                 positions=None, patch_embeds=None
                 ) -> Tuple[torch.Tensor, Cache]:
        """Prefill body -> (hidden (B, S, D), cache)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return self._forward_rwkv(tokens)
        if cfg.family == "hybrid":
            return self._forward_hybrid(tokens)
        if cfg.is_encoder_decoder:
            return self._forward_encdec(tokens, enc_frames)
        B, S = tokens.shape
        x = self._embed(tokens, patch_embeds)
        L, hd = len(self.layers), cfg.resolved_head_dim
        rope = self._rope(self._positions(B, S, positions))
        shards = self._kv_shards(S)
        cache: Cache = {}
        if hasattr(self, "dense0"):
            self._gather("dense0")
            x, _, (k, v) = tfm.decoder_layer(self.dense0, cfg, x, rope)
            self._release("dense0")
            cache["dense0"] = (
                self._to_cache(self.dense0, k, shards).contiguous(),
                self._to_cache(self.dense0, v, shards).contiguous())
        shape = (L, B, cfg.num_kv_heads, S // shards, hd)
        kc = torch.empty(shape, dtype=x.dtype, device=self.device)
        vc = torch.empty(shape, dtype=x.dtype, device=self.device)
        for i, lp in enumerate(self.layers):
            self._gather(f"layers.{i}")
            x, _, (k, v) = tfm.decoder_layer(
                lp, cfg, x, rope, token_shard=self._token_shard())
            self._release(f"layers.{i}")
            kc[i] = self._to_cache(lp, k, shards)
            vc[i] = self._to_cache(lp, v, shards)
        cache["layers"] = (kc, vc)
        if self.tp is not None:
            cache["kv_shards"] = shards
        return x, cache

    def _kv_shards(self, length: int) -> int:
        """The ranks a KV cache of ``length`` positions is split over: the
        "model" width where it divides the length (flash-decode), else 1
        (every rank holds the whole cache)."""
        tp = self.tp
        return tp.size if tp is not None and length % tp.size == 0 else 1

    def _to_cache(self, lp: tfm.DecoderLayer, t: torch.Tensor,
                  shards: int) -> torch.Tensor:
        """A layer's prefill K or V (B, S, H, hd) in the cache layout (B,
        Hkv, S / shards, hd): under tensor parallelism every KV head,
        gathered over "model" where the rank holds its slice of them (by
        one ``all_to_all`` where the cache is sequence-sharded), and this
        rank's sequence slice of it where ``shards`` > 1."""
        t = t.transpose(1, 2)
        tp = lp.attn.tp
        if tp is None:
            return t
        if lp.attn.kv_local:
            return dist.all_to_all(t, 2, 1, tp) if shards > 1 \
                else dist.gather_dim(t, 1, tp)
        return self._slice(t, 2, tp) if shards > 1 else t

    # ------------------------------------------------------------ audio

    def _frames(self, enc_frames) -> torch.Tensor:
        """The encoder's input frames (B, T, D) on the device in the
        compute dtype; the audio family reads them from
        ``batch["enc_frames"]``, as the reference."""
        if enc_frames is None:
            raise ValueError(
                f"{self.cfg.name}: the audio family needs enc_frames, the "
                f"encoder's input frames (B, {self.cfg.encoder_seq_len}, "
                f"{self.cfg.d_model})")
        return torch.as_tensor(enc_frames, device=self.device).to(
            self.policy.compute_dtype)

    def _encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder: frames plus ``pos_enc``, each encoder layer
        (checkpointed under remat "full" when a gradient is wanted), then
        ``ln_enc``. -> (B, T, D)."""
        x = frames + self.pos_enc.to(frames.dtype)[None]
        for i, lp in enumerate(self.enc_layers):
            x = self._unit(f"enc_layers.{i}", self._enc_layer, i, lp, x)
        return tfm.norm(self.cfg, x, self.ln_enc)

    def _enc_layer(self, i: int, lp: tfm.EncoderLayer, x: torch.Tensor
                   ) -> torch.Tensor:
        self._gather(f"enc_layers.{i}")
        return tfm.encoder_layer(lp, self.cfg, x)

    def _dec_layer(self, i: int, lp: tfm.DecoderLayer, x: torch.Tensor,
                   enc: torch.Tensor) -> torch.Tensor:
        self._gather(f"dec_layers.{i}")
        return tfm.decoder_layer(lp, self.cfg, x, None, enc_out=enc)[0]

    def _embed_audio(self, tokens: torch.Tensor) -> torch.Tensor:
        """The decoder's input: the token rows plus ``pos_dec[:S]``, no
        embedding scale."""
        x = dist.constraint(embed_tokens(self.embed, tokens), "act_batch",
                            "act_seq", "act_embed")
        return x + self.pos_dec.to(x.dtype)[:tokens.shape[1]][None]

    def _forward_encdec(self, tokens: torch.Tensor, enc_frames
                        ) -> Tuple[torch.Tensor, Cache]:
        """The reference's ``_forward_encdec`` with ``collect_cache``: the
        encoder, then each decoder layer, its self and cross K/V
        collected."""
        cfg = self.cfg
        enc = self._encode(self._frames(enc_frames))
        x = self._embed_audio(tokens)
        B, S = tokens.shape
        L, hd = len(self.dec_layers), cfg.resolved_head_dim
        shards = self._kv_shards(S)
        kv = dict(dtype=x.dtype, device=self.device)
        kc, vc = (torch.empty((L, B, cfg.num_kv_heads, S // shards, hd),
                              **kv) for _ in range(2))
        ck, cv = (torch.empty((L, B, self._cross_kv_heads(), enc.shape[1],
                               hd), **kv) for _ in range(2))
        for i, lp in enumerate(self.dec_layers):
            self._gather(f"dec_layers.{i}")
            x, _, (k, v, kx, vx) = tfm.decoder_layer(lp, cfg, x, None,
                                                     enc_out=enc)
            self._release(f"dec_layers.{i}")
            kc[i] = self._to_cache(lp, k, shards)
            vc[i] = self._to_cache(lp, v, shards)
            ck[i], cv[i] = kx, vx
        cache = {"layers": (kc, vc, ck, cv)}
        if self.tp is not None:
            cache["kv_shards"] = shards
        return x, cache

    def _cross_kv_heads(self) -> int:
        """The KV heads of the audio family's cross caches on this rank."""
        cross = self.dec_layers[0].cross
        return self.cfg.num_kv_heads // (self.tp.size if cross.kv_local
                                         else 1)

    def _rec_block(self) -> rglru.RecBlock:
        """The hybrid family's first RG-LRU block (all hold one width)."""
        return next(m for m in self.modules()
                    if isinstance(m, rglru.RecBlock))

    def _rwkv_heads(self) -> int:
        """The WKV heads this rank computes: H, or H / tp where the time
        mix is head-sharded."""
        tm = self.layers[0].tm
        return tm.heads // (1 if tm.tp is None else tm.tp.size)

    def _forward_rwkv(self, tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, Cache]:
        cfg = self.cfg
        B, S = tokens.shape
        x = embed_tokens(self.embed, tokens)
        x = layer_norm(x, 1.0 + self.ln0, torch.zeros_like(self.ln0),
                       cfg.norm_eps)
        H, hd = self._rwkv_heads(), cfg.rwkv_head_dim
        states, x_tm, x_cm = [], [], []
        for i, lp in enumerate(self.layers):
            s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                             device=self.device)
            self._gather(f"layers.{i}")
            x, st, (ltm, lcm) = rwkv6.block(lp, cfg, x, s0,
                                            collect_last=True)
            self._release(f"layers.{i}")
            states.append(st)
            x_tm.append(ltm)
            x_cm.append(lcm)
        return x, {"wkv": torch.stack(states), "x_tm": torch.stack(x_tm),
                   "x_cm": torch.stack(x_cm)}

    def _embed_hybrid(self, tokens: torch.Tensor) -> torch.Tensor:
        """The token rows times sqrt(d_model) in their dtype (gemma)."""
        x = embed_tokens(self.embed, tokens)
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype,
                                device=x.device)

    def _rec_layer(self, lp: rglru.RecLayer, x: torch.Tensor,
                   collect: bool = True
                   ) -> Tuple[torch.Tensor, rglru.State]:
        """A rec layer over a sequence from a zero state -> (x, its decode
        state {"h", "conv"}; "conv" None unless ``collect``)."""
        cfg = self.cfg
        h = rms_norm(x, lp.ln_rec, cfg.norm_eps)
        h0 = torch.zeros((x.shape[0], rglru.width(lp.rec)),
                         dtype=torch.float32, device=x.device)
        out, h_last, conv = rglru.rec_block(lp.rec, cfg, h, h0,
                                            collect_state=collect)
        x = x + out
        x = x + lp.mlp(rms_norm(x, lp.ln_mlp, cfg.norm_eps))
        return x, {"h": h_last, "conv": conv}

    def _rec_layer_step(self, lp: rglru.RecLayer, x: torch.Tensor,
                        state: rglru.State
                        ) -> Tuple[torch.Tensor, rglru.State]:
        cfg = self.cfg
        out, state = rglru.rec_block_step(
            lp.rec, cfg, rms_norm(x, lp.ln_rec, cfg.norm_eps), state)
        x = x + out
        return x + lp.mlp(rms_norm(x, lp.ln_mlp, cfg.norm_eps)), state

    def _to_ring(self, lp: tfm.DecoderLayer, t: torch.Tensor
                 ) -> torch.Tensor:
        """Layer ``lp``'s (B, S, H, hd) K or V -> the ring (B, Hkv, W, hd)
        of every KV head (gathered over "model" where the rank holds its
        slice of them): slot i holds the position p with p % W == i. S < W
        is right-padded with zeros (the decode's warm-up mask covers them);
        S >= W keeps the last W rows, which S % W == 0 keeps aligned."""
        W = self.cfg.window
        t = self._to_cache(lp, t, 1)
        S = t.shape[2]
        if S < W:
            return torch.nn.functional.pad(t, (0, 0, 0, W - S))
        if S % W:
            raise ValueError(f"{S} tokens: the ring needs a multiple of the "
                             f"window {W}")
        return t[:, :, -W:].contiguous()

    def _forward_hybrid(self, tokens: torch.Tensor
                        ) -> Tuple[torch.Tensor, Cache]:
        """The reference's ``_forward_hybrid`` with ``collect_cache``: every
        unit, then the tail, each layer's cache collected (the units'
        stacked as the reference's scan stacks them)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed_hybrid(tokens)
        rope = self._rope(self._positions(B, S))

        def one_layer(lp, kind, x):
            if kind == "attn":
                x, _, (k, v) = tfm.decoder_layer(lp, cfg, x, rope,
                                                 window=cfg.window)
                return x, (self._to_ring(lp, k), self._to_ring(lp, v))
            return self._rec_layer(lp, x)

        per_key: Dict[str, list] = {key: [] for key, _ in self._hybrid_keys()}
        for u, unit in enumerate(self.units):
            self._gather(f"units.{u}")
            for key, kind in self._hybrid_keys():
                x, c = one_layer(unit[key], kind, x)
                per_key[key].append(c)
            self._release(f"units.{u}")
        units: Dict[str, Any] = {}
        for key, kind in self._hybrid_keys():
            cs = per_key[key]
            if kind == "attn":
                units[key] = (torch.stack([c[0] for c in cs]),
                              torch.stack([c[1] for c in cs]))
            else:
                units[key] = {name: torch.stack([c[name] for c in cs])
                              for name in ("h", "conv")}
        tail = []
        if len(self.tail):
            self._gather("tail")
        for lp, kind in zip(self.tail, self._hybrid_tail_kinds()):
            x, c = one_layer(lp, kind, x)
            tail.append(c)
        if len(self.tail):
            self._release("tail")
        return x, {"units": units, "tail": tail}

    # ------------------------------------------------------------ train

    def train_loss(self, batch) -> Tuple[torch.Tensor,
                                         Dict[str, torch.Tensor]]:
        """batch {"tokens", "labels"} (B, S), for the audio family
        "enc_frames" (B, T, D), for the vlm family "positions" (3, B, S)
        and, optionally, "patch_embeds" (B, P, D) -> (loss, {"loss",
        "ce", "aux"}), the loss a scalar float32 tensor with a graph back
        to the working weights. The ssm family runs the reference's
        ``_forward_rwkv`` (``ln0``, then each block from a zero WKV
        state), whose WKV6 call differentiates through K4' on the card.
        The moe family's loss is ``ce + router_aux_loss * aux``, aux the
        sum of its MoE layers' (``dense0``'s is not counted). The hybrid
        family runs the reference's ``_forward_hybrid`` (the gemma
        embedding scale, each unit checkpointed as one function, the tail
        outside the checkpoints); its aux is 0. The audio family runs the
        reference's ``_forward_encdec`` (each encoder and each decoder
        layer checkpointed) and its LayerNorm on ``ln_f``; its aux is 0,
        and a batch without "enc_frames" raises, as the reference's
        lookup does. The dense, moe and vlm families read "positions" and
        "patch_embeds" where the batch has them, as the reference's
        ``_forward`` does; a vlm batch without "positions" raises
        ``KeyError``."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        labels = self._tokens(batch["labels"])
        B, S = tokens.shape
        self.require_weights()
        if cfg.is_encoder_decoder:
            frames = self._frames(batch["enc_frames"])
            self._gather("in")
            return self._loss(self._train_encdec(tokens, frames), labels, [])
        self._gather("in")
        positions = None          # the hybrid family's forward reads none
        if cfg.family == "hybrid":
            x = self._embed_hybrid(tokens)
        elif cfg.family == "ssm":
            x = embed_tokens(self.embed, tokens)
        else:
            x = self._embed(tokens, batch.get("patch_embeds"))
            positions = batch.get("positions")
        x = dist.constraint(x, "act_batch", "act_seq", "act_embed")
        if cfg.family == "ssm":
            x = layer_norm(x, 1.0 + self.ln0, torch.zeros_like(self.ln0),
                           cfg.norm_eps)
            layer, extra = self._train_rwkv_layer, ()
        else:
            layer = self._train_layer
            extra = (self._rope(self._positions(B, S, positions)),)
        auxes = []
        if cfg.family == "hybrid":
            x = self._train_hybrid(x, *extra)
        if hasattr(self, "dense0"):
            # outside the checkpoint, as in the reference; its aux is 0
            self._gather("dense0")
            x = tfm.decoder_layer(self.dense0, cfg, x, *extra)[0]
        # under tensor parallelism each checkpointed decoder layer keeps the
        # rank's sequence slice of its input (the reference's
        # "act_seq_ckpt")
        sliced = self.tp is not None and S % self.tp.size == 0 and \
            self.remat == "full" and torch.is_grad_enabled() and \
            cfg.family in ("dense", "moe", "vlm")
        if sliced:
            x = dist.split_dim(x, 1, self.tp)
            layer = functools.partial(self._train_layer, sliced=True)
        for i, lp in enumerate(getattr(self, "layers", ())):
            x = self._unit(f"layers.{i}", layer, i, lp, x, *extra)
            if cfg.moe:
                x, aux = x
                auxes.append(aux)
        if sliced:
            x = dist.gather_dim(x, 1, self.tp)
        return self._loss(x, labels, auxes)

    def _unit(self, unit: str, fn, *args):
        """``fn(*args)``, which gathers ``unit`` first: under remat "full",
        when a gradient is wanted, as one checkpointed function (no
        randomness inside a layer, so the RNG state is not saved for the
        recompute), after which a sharded step releases the unit's weights
        (the recompute gathers again); without a gradient (serving) the
        unit's weights are released once its output exists."""
        if self.remat == "full" and torch.is_grad_enabled():
            out = checkpoint(fn, *args, use_reentrant=False,
                             preserve_rng_state=False)
            if self.zero3 is not None:
                self.zero3.release(unit)
            return out
        out = fn(*args)
        if not torch.is_grad_enabled():
            self._release(unit)
        return out

    def _train_encdec(self, tokens: torch.Tensor, frames: torch.Tensor
                      ) -> torch.Tensor:
        """The audio family's training forward: the encoder, then each
        decoder layer over its output. -> the decoder's hidden (B, S,
        D)."""
        enc = self._encode(frames)
        x = self._embed_audio(tokens)
        for i, lp in enumerate(self.dec_layers):
            x = self._unit(f"dec_layers.{i}", self._dec_layer, i, lp, x, enc)
        return x

    def _loss(self, x: torch.Tensor, labels: torch.Tensor, auxes: list
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The head over the layers' output x (B, S, D): the final norm,
        the logits, the cross-entropy, and the moe family's aux term."""
        cfg = self.cfg
        self._gather("out")
        x = tfm.norm(cfg, x, self.ln_f.to(x.dtype))
        x = dist.constraint(x, "act_batch", "act_seq", "act_embed")
        logits = logits_from_hidden(self.embed, x, cfg.vocab_size,
                                    cfg.tie_embeddings)
        logits = dist.constraint(logits, "act_batch", "act_seq", "act_vocab")
        ce = cross_entropy(logits, labels, cfg.vocab_size, self.embed.tp)
        if not auxes:
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
            return ce, {"loss": ce, "ce": ce, "aux": aux}
        aux = torch.stack(auxes).sum()
        loss = ce + cfg.moe.router_aux_loss * aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}

    def _train_layer(self, i: int, lp, x: torch.Tensor, rope,
                     sliced: bool = False):
        """x of the next layer; (x, aux) in the moe family. ``sliced``: x
        in and out is the rank's sequence slice, gathered for the layer."""
        self._gather(f"layers.{i}")
        if sliced:
            x = dist.gather_dim(x, 1, self.tp)
        x, aux, _ = tfm.decoder_layer(lp, self.cfg, x, rope,
                                      token_shard=self._token_shard())
        if sliced:
            x = dist.split_dim(x, 1, self.tp)
        return (x, aux) if self.cfg.moe else x

    def _train_hybrid(self, x: torch.Tensor, rope) -> torch.Tensor:
        """The units, each one checkpointed function with remat "full"
        (the reference's remat of its unit scan), then the tail, outside
        any checkpoint (it runs after the reference's scan)."""
        for u, unit in enumerate(self.units):
            x = self._unit(f"units.{u}", self._train_unit, u, unit, x, rope)
        if len(self.tail):
            self._gather("tail")
        for lp, kind in zip(self.tail, self._hybrid_tail_kinds()):
            x = self._train_hybrid_layer(lp, kind, x, rope)
        return x

    def _train_unit(self, u: int, unit: nn.ModuleDict, x: torch.Tensor,
                    rope) -> torch.Tensor:
        self._gather(f"units.{u}")
        for key, kind in self._hybrid_keys():
            x = self._train_hybrid_layer(unit[key], kind, x, rope)
        return x

    def _train_hybrid_layer(self, lp, kind: str, x: torch.Tensor,
                            rope) -> torch.Tensor:
        if kind == "attn":
            return tfm.decoder_layer(lp, self.cfg, x, rope,
                                     window=self.cfg.window)[0]
        return self._rec_layer(lp, x, collect=False)[0]

    def _train_rwkv_layer(self, i: int, lp, x: torch.Tensor) -> torch.Tensor:
        self._gather(f"layers.{i}")
        cfg = self.cfg
        H, hd = self._rwkv_heads(), cfg.rwkv_head_dim
        s0 = torch.zeros((x.shape[0], H, hd, hd), dtype=torch.float32,
                         device=self.device)
        return rwkv6.block(lp, cfg, x, s0)[0]

    def _final_logits(self, x_last: torch.Tensor) -> torch.Tensor:
        """The last position's logits over the whole (padded) vocabulary,
        gathered over "model" under tensor parallelism. A serving holder's
        "out" is gathered for them and released with "in", which the
        entry point gathered at its start."""
        self._gather("out")
        x_last = tfm.norm(self.cfg, x_last, self.ln_f.to(x_last.dtype))
        logits = logits_from_hidden(self.embed, x_last, self.cfg.vocab_size,
                                    self.cfg.tie_embeddings)
        self._release("out")
        self._release("in")
        if self.embed.tp is not None:
            logits = dist.gather_dim(logits, -1, self.embed.tp)
        return logits

    @torch.no_grad()
    def prefill(self, tokens, enc_frames=None, *, positions=None,
                patch_embeds=None) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, S) -> (last-token logits (B, Vp), cache). The audio
        family also takes the encoder's input frames ``enc_frames`` (B, T,
        D), the reference's ``batch["enc_frames"]``; the other families
        do not read them. The dense, moe and vlm families take the
        reference's ``batch["positions"]`` and ``batch["patch_embeds"]``
        as ``positions`` and ``patch_embeds`` (see ``train_loss``); the
        vlm family raises ``KeyError`` without ``positions``."""
        self.require_weights()
        tokens = self._tokens(tokens)
        self._gather("in")
        x, cache = self._forward(tokens, enc_frames, positions,
                                 patch_embeds)
        cache["pos"] = int(tokens.shape[1])
        return self._final_logits(x[:, -1]), cache

    # ------------------------------------------------------------ decode

    def init_cache(self, batch_size: int, cache_len: int) -> Cache:
        """Zero-filled decode cache (under tensor parallelism, in the layout
        of the module's docstring)."""
        self._require_mesh()
        cfg = self.cfg
        B, L, d = batch_size, cfg.num_layers, cfg.d_model
        f32 = dict(dtype=torch.float32, device=self.device)
        if cfg.family == "ssm":
            H, rhd = self._rwkv_heads(), cfg.rwkv_head_dim
            return {"wkv": torch.zeros((L, B, H, rhd, rhd), **f32),
                    "x_tm": torch.zeros((L, B, d), **f32),
                    "x_cm": torch.zeros((L, B, d), **f32),
                    "pos": 0}
        kv = dict(dtype=self.policy.compute_dtype, device=self.device)
        if cfg.family == "hybrid":
            # the ring of ``window`` slots: cache_len does not enter
            ring = (B, cfg.num_kv_heads, cfg.window, cfg.resolved_head_dim)
            K, w = cfg.conv_width, rglru.width(self._rec_block())

            def layer_cache(kind, lead=()):
                if kind == "attn":
                    return (torch.zeros(lead + ring, **kv),
                            torch.zeros(lead + ring, **kv))
                return {"h": torch.zeros(lead + (B, w), **f32),
                        "conv": torch.zeros(lead + (B, K - 1, w), **f32)}
            n = (len(self.units),)
            return {"units": {key: layer_cache(kind, n)
                              for key, kind in self._hybrid_keys()},
                    "tail": [layer_cache(kind)
                             for kind in self._hybrid_tail_kinds()],
                    "pos": 0}
        shards = self._kv_shards(cache_len)
        if cfg.is_encoder_decoder:
            # the cross K/V stay zero until a prefill writes them
            hd = cfg.resolved_head_dim
            self_kv = (L, B, cfg.num_kv_heads, cache_len // shards, hd)
            cross_kv = (L, B, self._cross_kv_heads(), cfg.encoder_seq_len,
                        hd)
            cache = {"layers": tuple(torch.zeros(shape, **kv) for shape in
                                     (self_kv, self_kv, cross_kv, cross_kv)),
                     "pos": 0}
            if self.tp is not None:
                cache["kv_shards"] = shards
            return cache
        shape = (len(self.layers), B, cfg.num_kv_heads, cache_len // shards,
                 cfg.resolved_head_dim)
        cache = {"layers": (torch.zeros(shape, **kv),
                            torch.zeros(shape, **kv)), "pos": 0}
        if hasattr(self, "dense0"):
            cache["dense0"] = (torch.zeros(shape[1:], **kv),
                               torch.zeros(shape[1:], **kv))
        if self.tp is not None:
            cache["kv_shards"] = shards
        return cache

    @torch.no_grad()
    def decode_step(self, tokens, cache: Cache) -> Tuple[torch.Tensor, Cache]:
        """tokens (B,) -> (logits (B, Vp), cache), the cache updated in
        place. The ssm family, as in the JAX package, embeds the token
        without the ``ln0`` norm that prefill applies; the vlm family
        rotates by M-RoPE with all three streams at ``pos`` (the
        reference's answer, which Qwen2-VL's rope deltas would move after
        an image; the port keeps it); the audio family
        adds ``pos_dec[pos]`` and its decoder layers attend to the cross
        caches, which a decode step reads and never writes."""
        self.require_weights()
        cfg = self.cfg
        pos = int(cache["pos"])
        self._gather("in")
        if cfg.family == "hybrid":
            return self._decode_hybrid(self._tokens(tokens), cache, pos)
        x = dist.constraint(embed_tokens(self.embed, self._tokens(tokens)),
                            "act_batch", "act_embed")
        sharded = cache.get("kv_shards", 1) > 1
        if cfg.is_encoder_decoder:
            x = x + self.pos_dec.to(x.dtype)[pos]
            kc, vc, ck, cv = cache["layers"]
            for i, lp in enumerate(self.dec_layers):
                self._gather(f"dec_layers.{i}")
                x = tfm.decoder_layer_step(lp, cfg, x, kc[i], vc[i], pos,
                                           None, enc_kv=(ck[i], cv[i]),
                                           kv_sharded=sharded)
                self._release(f"dec_layers.{i}")
        elif cfg.family == "ssm":
            for i, lp in enumerate(self.layers):
                st = {name: cache[name][i] for name in ("wkv", "x_tm",
                                                         "x_cm")}
                self._gather(f"layers.{i}")
                x, new = rwkv6.block_step(lp, cfg, x, st)
                self._release(f"layers.{i}")
                for name, val in new.items():
                    cache[name][i] = val
        else:
            kc, vc = cache["layers"]
            rope = self._rope_at(x.shape[0], pos)
            if hasattr(self, "dense0"):
                self._gather("dense0")
                x = tfm.decoder_layer_step(self.dense0, cfg, x,
                                           *cache["dense0"], pos, rope,
                                           kv_sharded=sharded)
                self._release("dense0")
            for i, lp in enumerate(self.layers):
                self._gather(f"layers.{i}")
                x = tfm.decoder_layer_step(
                    lp, cfg, x, kc[i], vc[i], pos, rope, kv_sharded=sharded,
                    token_shard=self._token_shard())
                self._release(f"layers.{i}")
        cache["pos"] = pos + 1
        return self._final_logits(x), cache

    def cache_dims(self) -> Dict[str, Any]:
        """The reference's ``cache_dims``: logical axes of every cache leaf,
        in ``init_cache``'s structure ("pos" ``()``): the batch over
        "act_batch", the KV cache's sequence over "act_kv_seq", the ssm
        state's heads over "act_heads", the RG-LRU width over "act_ff".
        The port's layout over "model" follows ``cache_tp_dims``, which
        differs where the module's docstring says (the hybrid rings and
        the audio cross caches); the batch rows (the "data" placement) are
        the reference's."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return {"wkv": (None, "act_batch", "act_heads", None, None),
                    "x_tm": (None, "act_batch", None),
                    "x_cm": (None, "act_batch", None), "pos": ()}
        kv = (None, "act_batch", None, "act_kv_seq", None)
        if cfg.family == "hybrid":
            def layer_dims(kind, lead):
                pre = (None,) * lead
                if kind == "attn":
                    return (pre + ("act_batch", None, "act_kv_seq", None),) * 2
                return {"h": pre + ("act_batch", "act_ff"),
                        "conv": pre + ("act_batch", None, "act_ff")}
            return {"units": {key: layer_dims(kind, 1)
                              for key, kind in self._hybrid_keys()},
                    "tail": [layer_dims(kind, 0)
                             for kind in self._hybrid_tail_kinds()],
                    "pos": ()}
        if cfg.is_encoder_decoder:
            return {"layers": (kv, kv, kv, kv), "pos": ()}
        out: Dict[str, Any] = {"layers": (kv, kv), "pos": ()}
        if hasattr(self, "dense0"):
            out["dense0"] = (kv[1:], kv[1:])
        return out

    def cache_tp_dims(self, cache: Cache):
        """``cache``'s structure (without "pos" and "kv_shards") with, in
        place of each tensor, the dim that holds the rank's slice of it over
        "model", or None where the rank holds it whole (see the module's
        docstring)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            heads = 2 if self.layers[0].tm.tp is not None else None
            return {"wkv": heads, "x_tm": None, "x_cm": None}
        if cfg.family == "hybrid":
            split = self._rec_block().tp is not None

            def dims(c, lead):
                if isinstance(c, tuple):        # a ring: whole
                    return (None, None)
                return {"h": lead + 1 if split else None,
                        "conv": lead + 2 if split else None}
            return {"units": {key: dims(c, 1)
                              for key, c in cache["units"].items()},
                    "tail": [dims(c, 0) for c in cache["tail"]]}
        seq = 3 if cache.get("kv_shards", 1) > 1 else None
        if cfg.is_encoder_decoder:
            cross = 2 if self.dec_layers[0].cross.kv_local else None
            return {"layers": (seq, seq, cross, cross)}
        out: Dict[str, Any] = {"layers": (seq, seq)}
        if "dense0" in cache:
            out["dense0"] = (None if seq is None else seq - 1,) * 2
        return out

    def _decode_hybrid(self, tokens: torch.Tensor, cache: Cache, pos: int
                       ) -> Tuple[torch.Tensor, Cache]:
        """The reference's hybrid ``decode_step``: rec layers step their
        state, attention layers decode over their ring."""
        cfg = self.cfg
        x = self._embed_hybrid(tokens)
        rope = self._rope_at(x.shape[0], pos)

        def one_step(lp, kind, x, c):
            """Layer ``lp`` on its cache ``c`` (views of the stacked
            tensors for a unit's layer), updated in place."""
            if kind == "attn":
                return tfm.decoder_layer_step(lp, cfg, x, c[0], c[1], pos,
                                              rope, window=cfg.window)
            x, new = self._rec_layer_step(lp, x, c)
            for name, val in new.items():
                c[name].copy_(val)
            return x

        for i, unit in enumerate(self.units):
            self._gather(f"units.{i}")
            for key, kind in self._hybrid_keys():
                c = cache["units"][key]
                c = ((c[0][i], c[1][i]) if kind == "attn"
                     else {name: t[i] for name, t in c.items()})
                x = one_step(unit[key], kind, x, c)
            self._release(f"units.{i}")
        if len(self.tail):
            self._gather("tail")
        for lp, kind, c in zip(self.tail, self._hybrid_tail_kinds(),
                               cache["tail"]):
            x = one_step(lp, kind, x, c)
        if len(self.tail):
            self._release("tail")
        cache["pos"] = pos + 1
        return self._final_logits(x), cache


def input_specs(cfg, shape, policy: Optional[Policy] = None, *,
                rows: Optional[int] = None, model: Optional[Model] = None
                ) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every input of a cell (``cfg`` x
    ``shape``) in the port's call signature: the reference's
    ``input_specs`` with ``rows`` batch rows (default: the shape's global
    batch). train and prefill -> {"batch": {"tokens", and for train
    "labels", (B, S) int32; the vlm family's "positions" (3, B, S) and
    "patch_embeds" (B, min(256, S), D), the audio family's "enc_frames"
    (B, T, D), both in the compute dtype}}; ``Model.train_loss`` takes the
    batch, ``Model.prefill`` its tokens, ``enc_frames``, ``positions`` and
    ``patch_embeds``. decode -> {"tokens" (B,) int32, "cache": the
    ``init_cache`` of B rows and ``seq_len`` positions of ``model`` (built
    on the meta device; default: a new one of ``cfg``), in its layout
    over "model"}."""
    policy = policy or Policy()
    B, S = (shape.global_batch if rows is None else rows), shape.seq_len

    def empty(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        model = model or Model(cfg, policy, device="meta", seed=None)
        return {"tokens": empty((B,), torch.int32),
                "cache": model.init_cache(B, S)}
    batch = {"tokens": empty((B, S), torch.int32)}
    if shape.kind == "train":
        batch["labels"] = empty((B, S), torch.int32)
    if cfg.mrope_sections:
        batch["positions"] = empty((3, B, S), torch.int32)
        batch["patch_embeds"] = empty((B, min(256, S), cfg.d_model),
                                      policy.compute_dtype)
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = empty((B, cfg.encoder_seq_len, cfg.d_model),
                                    policy.compute_dtype)
    return {"batch": batch}


__all__ = ["Cache", "FAMILIES", "Model", "input_specs"]
