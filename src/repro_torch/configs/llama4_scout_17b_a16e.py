"""llama4-scout-17b-a16e — MoE: 16 routed experts, top-1, plus one shared
expert per MoE layer; GQA kv=8. Early-fusion multimodal in the original —
the text backbone is what is exercised here.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,             # expert hidden size
    vocab_size=202048,
    head_dim=128,
    rope_theta=500_000.0,
    act="swiglu",
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        num_shared_experts=1,
        expert_d_ff=8192,
        capacity_factor=1.25,
    ),
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
