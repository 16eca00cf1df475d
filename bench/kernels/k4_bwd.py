"""K4', the chunked WKV6 backward (``wkv6_bwd_state``, ``wkv6_bwd_out``,
``wkv6_bwd_du``), at the training step's call. Frozen from the program's
``wkv6_bwd_flops`` / ``wkv6_bwd_bytes``: per chunk and head 8 C hd^2, 5 C
(C - 1) hd and ~30 C hd + 2 hd^2 operations, as TF32 tensor-core
products; r, k, v read and dr, dk, dv written in bfloat16, logw and dy
read and dlogw written in float32, u read and du written, the state's
gradient read and written."""
from __future__ import annotations

from bench.kernels import k4

COUNT = "wkv6_bwd_state"
PREFIX = "wkv6_bwd"


def flops(c: dict, traffic: dict) -> float:
    B, H, S, hd = k4.shape(c, traffic)
    C = min(k4.CHUNK, S)
    per_chunk = (8 * C * hd * hd + 5 * C * (C - 1) * hd + 30 * C * hd
                 + 2 * hd * hd)
    return float(B * H * (S // C) * per_chunk)


def nbytes(c: dict, traffic: dict, itemsize: int = 2) -> float:
    B, H, S, hd = k4.shape(c, traffic)
    n = B * H * S * hd
    return (n * (6 * itemsize + 3 * 4) + 2 * H * hd * 4
            + 2 * B * H * hd * hd * 4)


def bound_s(c: dict, traffic: dict, peaks: dict) -> float:
    return max(flops(c, traffic) / peaks["tf32_tensor_flops"],
               nbytes(c, traffic) / peaks["hbm_bytes_per_s"])
