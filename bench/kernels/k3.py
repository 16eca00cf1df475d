"""K3, the causal flash-attention forward (``fa_fwd_tc`` in bfloat16), at
the call the training step makes: q (B, Hq, S, hd), k/v (B, Hkv, S, hd),
B the rows of a (micro-)batch. Frozen from the program's
``attention_flops`` / ``attention_bytes`` (operations: 2 multiply-adds a
live (query, key) pair and head dim, 4 operations; bytes: q, k, v read and
o written once, the float32 log-sum-exp rows written for the backward)."""
from __future__ import annotations

COUNT = "fa_fwd_tc"          # one a call
PREFIX = "fa_fwd_tc"         # the call's kernels


def shape(c: dict, traffic: dict) -> tuple:
    rows = traffic["microbatch"] or traffic["global_batch"]
    return (rows, c["num_heads"], c["num_kv_heads"], traffic["seq_len"],
            c["head_dim"])


def live_pairs(S: int) -> int:
    return S * (S + 1) // 2


def flops(c: dict, traffic: dict) -> float:
    B, Hq, _, S, hd = shape(c, traffic)
    return 4.0 * B * Hq * hd * live_pairs(S)


def nbytes(c: dict, traffic: dict, itemsize: int = 2) -> float:
    B, Hq, Hkv, S, hd = shape(c, traffic)
    return (2 * B * Hq * S + 2 * B * Hkv * S) * hd * itemsize + 4 * B * Hq * S


def bound_s(c: dict, traffic: dict, peaks: dict) -> float:
    return max(flops(c, traffic) / peaks["bf16_tensor_flops"],
               nbytes(c, traffic) / peaks["hbm_bytes_per_s"])
