"""Chunked RWKV6 WKV recurrence as a hand-written CUDA kernel with its
plain PyTorch versions (chunked, and token by token)."""
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import chunk_of, wkv6_naive, wkv6_ref
from repro_torch.kernels.wkv6.wkv6 import (COUNTER, HEAD_DIMS, scratch_bytes,
                                           supports, wkv6_bytes, wkv6_chunked,
                                           wkv6_flops)

__all__ = ["COUNTER", "HEAD_DIMS", "chunk_of", "scratch_bytes", "supports",
           "wkv6", "wkv6_bytes", "wkv6_chunked", "wkv6_flops", "wkv6_naive",
           "wkv6_ref"]
