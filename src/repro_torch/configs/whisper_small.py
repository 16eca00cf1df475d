"""whisper-small — encoder-decoder audio transformer backbone. The conv
mel-frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (batch, 1500, d_model). Learned positional embeddings, GELU MLP,
full MHA, cross-attention in the decoder.

[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,              # decoder layers
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    act="gelu",
    is_encoder_decoder=True,
    encoder_layers=12,
    encoder_seq_len=1500,
    learned_pos_emb=True,
    frontend="audio_frames",
    source="arXiv:2212.04356",
)
