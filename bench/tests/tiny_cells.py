"""Each cell of BENCHMARK.json cut to a size a CPU test run holds: the same
family, traffic shape (a micro-batch where the cell has one) and metric
entries, with every width and count small. Its limits are the cell's
times its family's ``LIMIT_SCALE``: at these widths a sound bfloat16 moe
run reads up to about three times what the cell reads on the card (d 64
against 2,048; the gaps of a bfloat16 sum shrink with its length), while
the ssm family's numbers, each of one part on its own inputs, read about
what they read there."""
from __future__ import annotations

import copy

from bench import harness

TINY_RUN = {
    "moe": dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
                d_ff=32, vocab_size=256, head_dim=16),
    "ssm": dict(num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
                d_ff=256, vocab_size=256, rwkv_head_dim=64),
}
TINY_MOE = dict(num_experts=8, top_k=2, expert_d_ff=32, dense_d_ff=96)
LIMIT_SCALE = {"moe": 4.0, "ssm": 1.5}


def names() -> list:
    return [w["name"] for w in harness.load_benchmark()["workloads"]]


def tiny(name: str) -> dict:
    """The cell ``name`` at a tiny size."""
    c = copy.deepcopy(harness.cell(harness.load_benchmark(), name))
    conf, tf = c["config"], c["traffic"]
    conf["run"].update(TINY_RUN[conf["family"]])
    if "moe" in conf["run"]:
        conf["run"]["moe"].update(TINY_MOE)
    tf["seq_len"] = 64
    tf["guard"] = {"n_peers": 63, "window_steps": 2}
    scale = LIMIT_SCALE[conf["family"]]
    c["limits"] = {k: v * scale for k, v in c["limits"].items()}
    return c
