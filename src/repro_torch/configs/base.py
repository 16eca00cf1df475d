"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig`` built from published
numbers; ``SHAPES`` is the assigned input-shape set shared by the LM family.
``get_config(name)`` / ``list_configs()`` are the public registry API used by
the launcher (``--arch <id>``), the dry-run, and the benchmarks.

The port's own copy of ``repro.configs.base``: the same dataclasses and
registry, so ``get_config`` resolves every id without importing ``repro``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    top_k: int = 1
    num_shared_experts: int = 0     # always-on shared experts
    expert_d_ff: int = 0            # hidden dim of each routed/shared expert
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001  # load-balance loss weight
    first_layer_dense: bool = False  # deepseek-moe: layer 0 is a dense FFN
    dense_d_ff: int = 0             # hidden dim of that dense layer


@dataclass(frozen=True)
class ArchConfig:
    """A single named architecture (exact published numbers)."""

    name: str
    family: str                     # dense | ssm | moe | audio | hybrid | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # feature flags
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen1.5
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (per rotary half)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "swiglu"             # swiglu | geglu | gelu

    # MoE
    moe: Optional[MoEConfig] = None

    # hybrid (recurrentgemma / griffin)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    window: int = 0                 # local-attention window (0 = full causal)
    lru_width: int = 0              # RG-LRU recurrence width
    conv_width: int = 4             # temporal conv width in recurrent block

    # rwkv6
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0        # e.g. 1500 audio frames after conv stub
    learned_pos_emb: bool = False

    # modality frontend stub: "none" | "audio_frames" | "vision_patches"
    frontend: str = "none"

    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k-token context (long_500k shape)?"""
        if self.family == "ssm":
            return True
        if self.family == "hybrid" and self.window > 0:
            return True
        return False

    def param_count(self) -> int:
        """Analytic parameter count (matches init within rounding)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d

        def attn_params() -> int:
            p = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
            if self.qkv_bias:
                p += (n_q + 2 * n_kv) * hd
            if self.qk_norm:
                p += 2 * hd
            return p

        def dense_ffn(dff: int) -> int:
            n_in = 2 if self.act in ("swiglu", "geglu") else 1
            return n_in * d * dff + dff * d

        total = embed + head + d  # final norm
        if self.family == "ssm":  # rwkv6
            H = d // self.rwkv_head_dim
            per_layer = (
                5 * d * d            # r,k,v,g,o mats (w is lora only)
                + 6 * d              # mus
                + 5 * (d * 32 + 32 * d)  # ddlerp loras (rank 32)
                + d * 64 + 64 * d    # decay lora (rank 64)
                + d + H * self.rwkv_head_dim  # w0, u(bonus)
                + 2 * d              # ln_x groupnorm
                + dense_ffn(self.d_ff) + 2 * d  # channel mix hidden + mus
                + 4 * d              # 2 layer norms
            )
            return total + self.num_layers * per_layer

        if self.family == "hybrid":
            pattern = self._layer_kinds()
            per_norms = 4 * d
            tot = total
            for kind in pattern:
                if kind == "attn":
                    tot += attn_params() + dense_ffn(self.d_ff) + per_norms
                else:  # recurrent block
                    w = self.lru_width or d
                    rec = (
                        2 * d * w            # two input branches
                        + self.conv_width * w  # temporal conv
                        + 2 * w              # lru input gate + a gate (diag-ish)
                        + 2 * (w * w // 8)   # block-diag gate projections
                        + w                  # lambda
                        + w * d              # out proj
                    )
                    tot += rec + dense_ffn(self.d_ff) + per_norms
            return tot

        per_layer = attn_params() + 2 * d
        if self.moe:
            m = self.moe
            expert = dense_ffn(m.expert_d_ff)
            router = d * m.num_experts
            moe_layer = (
                per_layer + router
                + m.num_experts * expert
                + m.num_shared_experts * expert
            )
            dense_layer = per_layer + dense_ffn(m.dense_d_ff or self.d_ff)
            n_moe = self.num_layers - (1 if m.first_layer_dense else 0)
            n_dense = self.num_layers - n_moe
            total += n_moe * moe_layer + n_dense * dense_layer
        else:
            total += self.num_layers * (per_layer + dense_ffn(self.d_ff))

        if self.is_encoder_decoder:
            # encoder stack + decoder cross-attention
            enc = self.encoder_layers * (attn_params() + dense_ffn(self.d_ff) + 2 * d)
            cross = self.num_layers * (attn_params() + d)
            total += enc + cross
            if self.learned_pos_emb:
                total += (self.encoder_seq_len + 32768) * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k routed only)."""
        if not self.moe:
            return self.param_count()
        m = self.moe
        d = self.d_model
        n_in = 2 if self.act in ("swiglu", "geglu") else 1
        expert = (n_in + 1) * d * m.expert_d_ff
        inactive = (m.num_experts - m.top_k) * expert
        n_moe = self.num_layers - (1 if m.first_layer_dense else 0)
        return self.param_count() - n_moe * inactive

    def _layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kind list for hybrid archs."""
        if not self.block_pattern:
            return tuple("attn" for _ in range(self.num_layers))
        kinds = []
        i = 0
        while len(kinds) < self.num_layers:
            kinds.append(self.block_pattern[i % len(self.block_pattern)])
            i += 1
        return tuple(kinds)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch        # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_NAMES: Tuple[str, ...] = (
    "phi3_mini_3_8b",
    "glm4_9b",
    "qwen3_4b",
    "qwen1_5_110b",
    "rwkv6_7b",
    "llama4_scout_17b_a16e",
    "deepseek_moe_16b",
    "whisper_small",
    "recurrentgemma_9b",
    "qwen2_vl_72b",
)

# public ids (hyphenated, as assigned) -> module names
_ALIASES = {n.replace("_", "-"): n for n in ARCH_NAMES}
_ALIASES.update({
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
})


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_NAMES:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def list_configs() -> Tuple[str, ...]:
    return ARCH_NAMES


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def applicable_shapes(cfg: ArchConfig) -> Tuple[str, ...]:
    """The assigned shapes this arch actually runs (skips noted in DESIGN.md)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue  # quadratic attention cannot serve 500k ctx
        out.append(s.name)
    return tuple(out)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes: dict = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 1,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        lru_width=128 if cfg.lru_width else 0,
        window=min(cfg.window, 64) if cfg.window else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 16) if cfg.encoder_seq_len else 0,
    )
    if cfg.mrope_sections:
        changes["mrope_sections"] = (4, 6, 6)   # sums to reduced head_dim//2
    if cfg.family == "ssm":
        changes["rwkv_head_dim"] = 32
        changes["num_heads"] = 4
    if cfg.moe:
        changes["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            expert_d_ff=64,
            dense_d_ff=256 if cfg.moe.first_layer_dense else 0,
        )
    if cfg.block_pattern:
        changes["num_layers"] = 3  # one full (rec, rec, attn) unit
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
