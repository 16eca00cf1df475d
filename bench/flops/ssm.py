"""Model operations of one training step of the ssm family (RWKV6): 6 x
the matrix parameters a token passes through (the time mix's five square
projections and its low-rank interpolation and decay products, the
channel mix's three, the head) x the step's tokens. The WKV recurrence
(under 0.5 % of it at 4,096 tokens) and recomputation are not counted."""
from __future__ import annotations


def per_step(c: dict, traffic: dict) -> float:
    d, ff = c["d_model"], c["d_ff"]
    time_mix = 5 * d * d + d * 5 * 32 + 5 * 32 * d + d * 64 + 64 * d
    channel_mix = 2 * d * ff + d * d
    active = c["num_layers"] * (time_mix + channel_mix) + \
        d * c["vocab_padded"]
    return 6.0 * active * traffic["global_batch"] * traffic["seq_len"]
