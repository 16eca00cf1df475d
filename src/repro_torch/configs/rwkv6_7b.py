"""rwkv6-7b (Finch) — attention-free linear recurrence with data-dependent
decay; O(1) state per layer, so long_500k decode is natively supported.

[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # d_model / rwkv_head_dim
    num_kv_heads=64,
    d_ff=14336,            # channel-mix hidden (3.5x)
    vocab_size=65536,
    rwkv_head_dim=64,
    act="relu_sq",         # rwkv channel-mix uses squared relu
    source="arXiv:2404.05892",
)
