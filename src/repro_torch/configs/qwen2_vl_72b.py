"""qwen2-vl-72b — VLM; the 80-layer text backbone with M-RoPE (multimodal
rotary: temporal/height/width sections). The vision tower is a STUB:
``input_specs()`` provides precomputed patch embeddings and (3, B, S)
M-RoPE position ids.

[arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    act="swiglu",
    frontend="vision_patches",
    source="arXiv:2409.12191",
)
