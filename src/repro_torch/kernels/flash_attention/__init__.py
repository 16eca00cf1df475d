"""Flash-attention forward (tiled online-softmax, causal or full, GQA) as a
hand-written CUDA kernel with its plain PyTorch version."""
from repro_torch.kernels.flash_attention.flash_attention import (
    COUNTER, HEAD_DIMS, attention_flops, flash_attention)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["COUNTER", "HEAD_DIMS", "attention", "attention_flops",
           "attention_ref", "flash_attention"]
