"""qwen3-4b — dense, GQA kv=8, per-head RMS qk_norm.

[hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="swiglu",
    source="hf:Qwen/Qwen3-8B",
)
