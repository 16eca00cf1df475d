"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed experts, top-6,
expert hidden 1408; first layer is a dense FFN (hidden 10944); full MHA.

[arXiv:2401.06066; hf]
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,             # routed-expert hidden size
    vocab_size=102400,
    head_dim=128,
    rope_theta=10_000.0,
    act="swiglu",
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        num_shared_experts=2,
        expert_d_ff=1408,
        capacity_factor=1.25,
        first_layer_dense=True,
        dense_d_ff=10944,
    ),
    source="arXiv:2401.06066",
)
