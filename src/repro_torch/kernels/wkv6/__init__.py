"""Chunked RWKV6 WKV recurrence as hand-written CUDA kernels (the forward
and its backward) with their plain PyTorch versions (chunked, its explicit
backward, and token by token)."""
from repro_torch.kernels.wkv6.ops import wkv6, wkv6_plain
from repro_torch.kernels.wkv6.ref import (chunk_of, wkv6_bwd_ref, wkv6_naive,
                                          wkv6_ref)
from repro_torch.kernels.wkv6.wkv6 import (BWD_COUNTER, COUNTER, HEAD_DIMS,
                                           scratch_bytes, supports,
                                           wkv6_bwd_bytes, wkv6_bwd_flops,
                                           wkv6_bytes, wkv6_chunked,
                                           wkv6_chunked_bwd,
                                           wkv6_chunked_bwd_meta,
                                           wkv6_chunked_meta, wkv6_flops)

__all__ = ["BWD_COUNTER", "COUNTER", "HEAD_DIMS", "chunk_of", "scratch_bytes",
           "supports", "wkv6", "wkv6_bwd_bytes", "wkv6_bwd_flops",
           "wkv6_bwd_ref", "wkv6_bytes", "wkv6_chunked", "wkv6_chunked_bwd",
           "wkv6_chunked_bwd_meta", "wkv6_chunked_meta",
           "wkv6_flops", "wkv6_naive", "wkv6_plain", "wkv6_ref"]
