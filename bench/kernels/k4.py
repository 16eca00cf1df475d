"""K4, the chunked WKV6 forward (``wkv6_state`` then ``wkv6_out``), at the
training step's call: r/k/v (B, H, S, hd) in bfloat16, chunks of C = 32.
Frozen from the program's ``wkv6_flops`` / ``wkv6_bytes``: per chunk and
head 4 C hd^2 for the state products, 2 C (C - 1) hd for the strictly
lower products and ~10 C hd elementwise, on the CUDA cores in float32;
r, k, v read in bfloat16, logw read and y written in float32, u, the
state read and written. The chunk-start states the kernel also keeps for
K4' are an intermediate, not counted."""
from __future__ import annotations

COUNT = "wkv6_state"
PREFIX = ("wkv6_state", "wkv6_out")
CHUNK = 32


def shape(c: dict, traffic: dict) -> tuple:
    hd = c["rwkv_head_dim"]
    rows = traffic["microbatch"] or traffic["global_batch"]
    return rows, c["d_model"] // hd, traffic["seq_len"], hd


def flops(c: dict, traffic: dict) -> float:
    B, H, S, hd = shape(c, traffic)
    C = min(CHUNK, S)
    per_chunk = 4 * C * hd * hd + 2 * C * (C - 1) * hd + 10 * C * hd
    return float(B * H * (S // C) * per_chunk)


def nbytes(c: dict, traffic: dict, itemsize: int = 2) -> float:
    B, H, S, hd = shape(c, traffic)
    n = B * H * S * hd
    return n * (3 * itemsize + 4 + 4) + H * hd * 4 + 2 * B * H * hd * hd * 4


def bound_s(c: dict, traffic: dict, peaks: dict) -> float:
    return max(flops(c, traffic) / peaks["fp32_simt_flops"],
               nbytes(c, traffic) / peaks["hbm_bytes_per_s"])
