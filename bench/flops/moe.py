"""Model operations of one training step of the moe family: 6 x the
matrix parameters a token passes through x the step's tokens (the
attention projections, the leading dense FFN, the router, the top-k
routed experts and the shared experts, the head; the embedding lookup is
no product), plus causal attention's 6 S^2 (heads x head size) a layer.
Recomputation (remat) and the capacity buffer's empty slots are not
counted."""
from __future__ import annotations


def per_step(c: dict, traffic: dict) -> float:
    m = c["moe"]
    d, hd = c["d_model"], c["head_dim"]
    attn = d * c["num_heads"] * hd * 2 + d * c["num_kv_heads"] * hd * 2
    f = m["expert_d_ff"]
    moe_layer = attn + d * m["num_experts"] + \
        3 * d * f * (m["top_k"] + m["num_shared_experts"])
    n_dense = 1 if m["first_layer_dense"] else 0
    active = n_dense * (attn + 3 * d * m["dense_d_ff"]) + \
        (c["num_layers"] - n_dense) * moe_layer + d * c["vocab_padded"]
    S = traffic["seq_len"]
    tokens = traffic["global_batch"] * S
    # QK^T and PV over the S^2 / 2 live pairs, 2 operations a
    # multiply-add: 2 S^2 (heads x head size) forward, 3 times that with
    # the backward
    attention = 6 * S * S * c["num_heads"] * hd * c["num_layers"] * \
        traffic["global_batch"]
    return 6.0 * active * tokens + attention
