"""qwen1.5-110b — dense, GQA kv=8, QKV bias. The largest dense assigned arch.

[hf:Qwen/Qwen1.5-0.5B (family); hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    act="swiglu",
    source="hf:Qwen/Qwen1.5-110B",
)
