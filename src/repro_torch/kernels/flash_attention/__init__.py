"""Flash attention (tiled online-softmax, causal or full, GQA) as
hand-written CUDA kernels, forward and backward, with their plain PyTorch
versions."""
from repro_torch.kernels.flash_attention.flash_attention import (
    BWD_COUNTER, BWD_HEAD_DIMS, COUNTER, HEAD_DIMS, attention_bwd_bytes,
    attention_bwd_flops, attention_bytes, attention_flops, dkdv_split,
    flash_attention, flash_attention_bwd, flash_attention_bwd_meta,
    flash_attention_meta)
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

__all__ = ["BWD_COUNTER", "BWD_HEAD_DIMS", "COUNTER", "HEAD_DIMS",
           "attention", "attention_bwd_bytes", "attention_bwd_flops",
           "attention_bwd_ref", "attention_bytes", "attention_flops",
           "attention_ref", "dkdv_split",
           "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_meta", "flash_attention_meta"]
