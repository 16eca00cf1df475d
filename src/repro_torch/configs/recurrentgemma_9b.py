"""recurrentgemma-9b (Griffin) — hybrid: RG-LRU recurrent blocks + local
sliding-window attention (window 2048), pattern (rec, rec, attn); MQA kv=1.
Sub-quadratic: runs long_500k with O(window) cache + O(1) recurrent state.

[arXiv:2402.19427; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    act="geglu",
    block_pattern=("rec", "rec", "attn"),
    window=2048,
    lru_width=4096,
    conv_width=4,
    tie_embeddings=True,
    source="arXiv:2402.19427",
)
