#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port of Guard on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package ``repro``. In
order, it

  1. builds the port's CUDA kernels from ``src/repro_torch/csrc`` into
     ``build/repro_torch/`` (one nvcc per source, all started together)
     and prints the card's name and power limit;
  2. holds the fleet_score kernel against its plain PyTorch version on the
     card, bit for bit, at 16,384 nodes (staged in shared memory) and
     131,072 (streamed), with NaN rows and with edge rows (N = 1 and 2,
     all equal, signed zeros, infinities, ties), and times both;
  3. holds the sweep_burn kernel against its plain version (atol 1e-3,
     two runs bit-equal) at 512^2 x 64, 128x256 x 8 and 2048^2 x 16,
     checks with the profiler that a call is one launch, and times it
     beside a cuBLAS float32 matmul chain of the same flops;
  4. drives Guard's closed loop through ``GuardSession`` on a synthetic
     16,384-node fleet with 64 spares and four planted faults, asserts
     the actions, swaps and quarantines, that both kernels ran on that
     path, and that the same frames through the port on the CPU give the
     identical JSONL event stream;
  5. holds the flash-attention kernel against its plain version on the
     card at qwen3-4b's prefill shape (bfloat16 and float32), at a ragged
     non-causal shape, at bfloat16 cases covering head dims 32/64/128,
     MQA, q_offset and kv_len, at whisper-small's prefill shapes and at
     qwen2-vl-72b's (64 query heads over 8 of 128, 4,096 tokens:
     ``VLM_ATTN``) (``K3_CASES``), and times it beside PyTorch's
     ``scaled_dot_product_attention``;
  6. holds the WKV6 kernels against their plain version at rwkv6-7b's
     prefill shape and at the other ``K4_CASES`` (every head dim, B = 2,
     single chunks of 7, 100, 300 and 1,000 tokens), checks that two calls
     are bit-equal, that a call runs the state pass and the output pass
     and that a state carried over two calls agrees, and times it;
  7. serves full-width, full-depth qwen3-4b (weights from a seeded
     generator on the card): ``Model.prefill`` of 4,096 tokens on the
     kernel path, which must launch flash attention once per layer and
     agree with the same model run through the plain attention, then a
     ``BatchedServer`` of 12 requests on 4 slots to completion;
  8. the same for full rwkv6-7b, with WKV6 once per layer at 2,048 tokens
     and again at 1,000 (one chunk of the whole prompt);
  9. holds the flash-attention backward kernel against its plain version
     on the card at qwen3-4b's training shape (bfloat16 and float32) and
     at the other ``K3B_CASES`` (head dims 32/64/128, a ragged S, MQA and
     Hq = Hkv, G = 8, q_offset, kv_len, the tiles' ragged edges,
     whisper-small's training shapes, and qwen2-vl-72b's G = 8 at 4,096
     tokens), checks that two calls are bit-equal, and times it beside the
     backward of ``scaled_dot_product_attention``;
 10. trains qwen3-4b at full width (8 of its 36 layers, one 4,096-token
     sequence, bf16, remat "full"): one step on the kernel path against
     the plain path (loss, every gradient, the AdamW-updated master
     weights), then a ``Trainer`` of 12 steps with a ``GuardStepHook``
     whose detector runs fleet_score on the card (flash attention 16 and
     its backward 8 launches a step, fleet_score one a Guard window; the
     loss finite and falling), then the ``examples/train_with_guard.py``
     scenario at that example's reduced size: an injected stall, a Guard
     restart, and a recovery from the peer tier of a
     ``TieredCheckpointManager`` (a hot spare);
 11. drives Guard's attribution and simulation path on the card, each
     run against the same run with the detector on the CPU: (a)
     ``simulate_run`` of 16,384 nodes and 512 spares under
     bench_diagnose's rack-thermal, switch-failure and congestion
     scenarios with the diagnoser and the hang watchdog (every
     ``RunResult`` field equal, fleet_score once an observed window, at
     least one true culprit accusation and no false one); (b)
     bench_hang's three quick scenarios (events equal, each with a
     ``HangDetected`` that names a culprit); (c) ``GuardStepHook(
     diagnose=True)`` on seeded step walls with a stall (JSONL equal);
     (d) prints, not gated, the p50 of ``session.observe`` fed by
     ``SimCluster`` with a ``Diagnoser`` at 16,384 and 131,072 nodes,
     split into the detector's update, the diagnosis and the rest, and
     the feed's own time;
 12. drives Guard's fleet control plane: ``simulate_fleet`` of
     bench_fleet's quick mix (16 jobs of 256 nodes, 2 simulated hours)
     and of the same mix at 1,024 nodes a job (16,384 nodes), each on the
     card and with every detector on the CPU: every ``FleetRunResult``
     field but the wall clocks equal, the fleet JSONL (``JsonlStreamSink``)
     equal line for line, the census conserved, no starvation, and
     fleet_score once an observed window; prints the walls, the
     controller's overhead (bench_fleet gates it at 5 %; not gated here)
     and the p50 of ``session.observe``;
 13. holds the WKV6 backward kernel against its plain version on the card
     at rwkv6-7b's training shape (bfloat16 and float32) and at the other
     ``K4B_CASES`` (head dims 16/32/128, B = 2, a state gradient, one chunk
     of 1,000 tokens past the clamp), checks that two calls are bit-equal
     and times it; then trains rwkv6-7b at full width (8 of its 32 layers,
     one 4,096-token sequence, bf16, remat "full"): one bf16 step on the
     kernel path against the plain path (WKV6 16 and its backward 8
     launches a step; the loss, and every WKV6 and WKV6-backward call of
     the step against its plain version on the inputs the step gave it;
     the gradient and update gaps printed beside a noise twin's, see
     ``NOISE_EPS``), the same step in float32 held to phase 10's limits,
     then a ``Trainer`` of 12 steps with a ``GuardStepHook``;
 14. trains phase 10's qwen3-4b cell under a one-rank NCCL mesh (a
     ``FileStore`` process group of world size 1, the port's ``make_mesh``
     of (1, 1) on the card, ``use_mesh``): the ZeRO-3 step of
     ``repro_torch.dist`` (DTensor master weights and moments placed by
     ``param_sharding``; each unit's working weights gathered in one flat
     all-gather, its gradients reduced in one flat reduce-scatter); the
     premise of bit-equality first (the float32 norm of a bfloat16 tensor
     is that of its float32 widening at every parameter shape), then after
     two steps the loss, every master weight and both moments bit-equal to
     the same two steps without a mesh, flash attention 16 and its
     backward 8 launches a step, then the step time and peak memory beside
     phase 10's;
 15. serves the moe family: deepseek-moe-16b at full width and depth
     (28 layers, 16.4 B parameters) and llama4-scout-17b-a16e at full
     width, 4 of 48 layers: a prefill of 4,096 tokens on the kernel path
     (flash attention once per layer) against the plain path (see
     ``TIE_EPS``: the routing flips between the paths counted, those of
     the first MoE layer held to be ties, the logits and caches held on
     the kernel path's routing), the prefill's operator rows, a
     ``BatchedServer`` of 12 requests on 4 slots, and the slots each of
     32 decode steps over 4 slots drops;
 16. trains deepseek-moe-16b at full width (4 of 28 layers: dense0 and
     three MoE layers, one 4,096-token sequence, bf16, remat "full"): one
     step on the kernel path against the plain path on its routing at
     phase 10's limits (flash attention 7 and its backward 4 launches a
     step), the step's operator rows, then a ``Trainer`` of 12 steps with
     a ``GuardStepHook``; the step is not bit-repeatable (the dispatch
     gather's backward adds with atomics);
 17. holds the RG-LRU scan kernel against its plain version on the card
     at recurrentgemma-9b's prefill shape (bfloat16, and float32) and at
     the other ``K5_CASES`` (B = 2 and 3, sequence lengths no multiple of
     the kernel's 128-step tiles, one step past a tile and past its ring
     of three, widths no multiple of its 32-channel blocks or of a 16-byte
     vector, a nonzero initial state), checks that two calls are bit-equal
     and that a call is one launch, and times it, its special-function
     floor printed beside its bound; then holds the flash-attention kernel
     with a sliding window against its plain version at
     recurrentgemma-9b's local attention (16 query heads over one KV head
     of 256, window 2,048, 4,096 tokens, bfloat16 and float32) and at the
     other ``K3W_CASES``, two calls bit-equal, and times it beside
     ``scaled_dot_product_attention`` with the window's boolean mask;
 18. serves recurrentgemma-9b at full width and depth (38 layers, 8.5 B
     parameters): prefills of 4,096 and 1,000 tokens on the kernel path
     (flash attention 12 and the RG-LRU scan 26 launches) against the
     plain path, six ring decode steps from each path's cache, the
     prefill's operator rows, and a ``BatchedServer`` of 12 requests on 4
     slots;
 19. holds the RG-LRU scan's backward kernel against its plain version on
     the card at recurrentgemma-9b's training shape (bfloat16, and
     float32 from a nonzero state and h_last cotangent) and at the other
     ``K5B_CASES`` (``K5_CASES``' odd shapes and the edges of the kernel's
     ring of tiles), on the float32 states the
     forward kernel keeps for it, two calls bit-equal, two launches a
     call, and times it beside the forward; then holds the
     flash-attention backward kernel with a sliding window and at head
     dim 256 against its plain version at recurrentgemma-9b's training
     shape (window 2,048, 4,096 tokens, bfloat16 and float32) and at the
     other ``K3BW_CASES``, at phase 9's limits, and times it beside the
     backward of ``scaled_dot_product_attention`` with the window's
     boolean mask;
 20. trains recurrentgemma-9b at full width (5 of its 38 layers: one
     (rec, rec, attn) unit, checkpointed as one function, and the (rec,
     rec) tail; one 4,096-token sequence, twice the window; bf16): one
     step on the kernel path against the plain path at phase 10's limits
     (the RG-LRU scan 6 and its backward 4, flash attention 2 and its
     backward 1 launches a step), the step's operator rows, then a
     ``Trainer`` of 12 steps with a ``GuardStepHook``;
 21. serves whisper-small uncut (12 encoder and 12 decoder layers, 0.30 B
     parameters, seeded weights and frames): a prefill of 4 x (1,500
     frames, 448 tokens) on the kernel path, which must launch flash
     attention exactly 36 times (each encoder layer's self attention,
     each decoder layer's self and cross attention) and nothing else,
     against the plain path (logits and the four caches; decoder layer
     0's self K/V, which no kernel feeds, bit-equal), the prefill's and a
     decode step's device profile, then a ``BatchedServer`` of 12
     requests on 4 slots with caches of 448 (its decode runs no kernel);
 22. trains whisper-small uncut (8 x (1,500 frames, 448 tokens) a step,
     remat "full"): one bf16 step on the kernel path (flash attention 72
     and its backward 36 launches a step) against the plain path: the
     loss and the AdamW updates at phase 10's limits, and each of the
     step's 36 flash-attention backward calls, and its forward, against
     the plain versions on the inputs the step gave it (the per-leaf
     gradient gaps printed, not gated: see the note above
     ``AUDIO_PER_STEP``); the same step in float32 at all of phase 10's
     limits; then a ``Trainer`` of 12 bf16 steps with a
     ``GuardStepHook``;
 23. serves qwen2-vl-72b at full width, 16 of its 80 layers (16.5 B
     parameters, seeded weights; the vision tower a stub, as in the
     reference): prefills of 4,096 tokens whose first 256 are a 16 x 16
     image's seeded patch embeddings, in Qwen2-VL's M-RoPE layout, and of
     1,000 tokens with the same image, on the kernel path (flash attention
     exactly 16 launches, nothing else) against the plain path, the
     prefill's and a decode step's device profile, then a
     ``BatchedServer`` of 12 requests on 4 slots;
 24. trains qwen2-vl-72b at full width, 1 of its 80 layers (one
     4,096-token sequence with the image, bf16, remat "full"): one step on
     the kernel path against the plain path at phase 10's limits (flash
     attention 2 and its backward 1 launches a step), and so steps 2 and
     3 of a ``Trainer``, from its state, where the loss jumps; then a
     ``Trainer`` of 12 steps with a ``GuardStepHook`` at a peak learning
     rate scaled to the width (``VLM_PEAK_LR``);
 25. runs tensor parallelism over "model" as four ranks on the one card
     (spawned processes in a gloo group, all on cuda:0: NCCL refuses two
     ranks on one device; every tensor-parallel collective goes through a
     host copy on that group), mesh (1, 4), each rank against the
     unsharded kernel path run first in this process: (a) qwen3-4b uncut,
     a 4,096-token prefill (K3 36 launches a rank at q (1, 8, 4,096, 128),
     k/v (1, 2, 4,096, 128)), its logits and gathered caches, then 4
     flash-decode steps over the prefill's cache from position 4,092;
     (b) qwen3-4b at 8 layers, one step's loss, gradients (each rank's
     slice) and AdamW updates at phase 10's limits, then two ``Trainer``
     steps with a ``GuardStepHook`` (K3 16 and K3' 8 a step, K1 once a
     window), their losses against the unsharded Trainer's; (c)
     deepseek-moe-16b at 4 layers, 16 experts a rank through the
     ``all_to_all``: a prefill and a training step on the kernel path
     against the plain path under the same mesh, on the kernel path's
     routing, at phases 15–16's limits, and each rank's dropped slots;
     (d)-(f) the ssm, hybrid and audio families (``TP_PARTS``), each
     served (a prefill, its logits and caches gathered into the unsharded
     layout, then decode steps) and trained one step against the
     unsharded kernel path, each kernel at the rank's shapes: (d)
     rwkv6-7b, 8 of 32 layers served (a 2,048-token prefill, K4 at 16
     heads a rank) and 4 trained (K4 8 and K4' 4 a step, each call held to
     its plain version on its own inputs; the float32 step at phase 10's
     limits); (e) recurrentgemma-9b, 5 of 38 layers served (a 4,096-token
     prefill: K5 at 1,024 of the LRU's 4,096 channels a rank, the windowed
     K3 at 4 query heads over the whole KV head; decode over the ring) and
     one unit trained at phase 10's limits (K5 4, K5' 2, K3 2, K3' 1 a
     step); (f) whisper-small uncut, 3 of 12 heads a rank in the encoder,
     the decoder and the cross attention (K3 36 a prefill of 4 x (1,500
     frames, 448 tokens); K3 72, K3' 36 a step, held as phase 22 holds
     them, the float32 step at phase 10's limits); one card shows that
     tensor parallelism computes the right thing, not how fast it is
     (phases 5, 6, 9, 13(a), 17 and 19 also time each kernel at its
     per-rank shape: ``TP_ATTN``, ``TP_AUDIO_ATTN``, ``TP_K4``, ``TP_K4B``,
     ``TP_K5``, ``TP_K5B``, ``TP_WINDOW``);
 26. holds the dry run's counts (``repro_torch.launch.step_analysis`` on
     the meta device, the kernels as their stand-ins, as
     ``repro_torch.launch.dryrun`` counts every cell) against the card, at
     phase 7's qwen3-4b prefill and phase 10's 8-layer training step,
     without a mesh: (a) the stand-ins of K3 and K3' give the shapes,
     dtypes and strides of one real call each, and the meta count's aten
     FLOPs equal ``FlopCounterMode``'s count of one real call of each on
     the card (which does not see the hand-written kernels); (b) the
     counted bound (``Roofline.step_bound_s``, H100 peaks) is no more than
     phase 7's prefill time and phase 10's step median, and the roofline
     fraction the card reached is printed; (c) the counted working-weight
     bytes equal the bytes of the card's parameters, and the counted
     memory of the step is printed beside phase 10's peak;
 27. serves under the mesh with the working weights sharded over "fsdp"
     (``repro_torch.models.fsdp.ServeShards``): four gloo ranks on cuda:0
     at ("data", "model") = (2, 2), each holding its shards of every
     weight and gathering a unit at a time over "data", serve a row each of
     a 2 x 2,048-token prefill and 4 decode steps of qwen3-4b at 8 of 36
     layers (K3 8 launches a rank at q (1, 2,048, 16, 128), k (1, 2,048,
     4, 128)) and of rwkv6-7b at 4 of 32 (K4 4 at r (1, 2,048, 32, 64)),
     each against the unsharded kernel path run first in this process: the
     logits, the caches gathered into the unsharded layout and every
     decode step's logits at PATH_REL_TOL, each rank's resident weights
     between units equal to its shard bytes under ``param_sharding``, the
     launch counts and shapes exact; the phase has FSDP_LIMIT_S (120 s)
     (phases 5 and 6 hold and time K3 and K4 at these per-rank shapes:
     ``FSDP_ATTN``, ``FSDP_K4``);
 28. prints one JSON line of per-kernel numbers, then
     ``{"ok": true, "device": {...}}`` as its last line.

The phases run in the order 1–6, 9, 13(a), 17, 19, 7, 8, 10–12, 13(b),
14–16, 18, 20–27: the kernel phases whose checks read profiler traces come
before the model phases' profiles, after which sessions of one call can
trace nothing (``call_segments``).

Every phase prints a start line (with the card's free memory) and, when
it passes, a line with its seconds and peak memory; its models and
tensors are dropped before the next phase starts. A failed check, or any
exception (an out-of-memory error included, with its traceback), prints
``FAIL: phase <n> <name>: ...`` and exits 1 before the last line is
printed. Without a CUDA device, or without the repository next to it, it
fails at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# one NVIDIA H100 SXM (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_SIMT_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12
# special-function unit results a clock an SM (Hopper white paper) and the
# H100 SXM's boost clock (data sheet): K5's pace, printed beside its bound
SFU_PER_CLOCK_SM = 16
BOOST_CLOCK_HZ = 1.98e9

N_MAIN = 16_384            # nodes on the main path
N_SPARES = 64
WINDOWS = 30               # evaluation windows, 60 s apart
WINDOW_S = 60.0
CKPT_EVERY = 5             # windows between checkpoints
PLANTED = {"immediate": 101, "defer": 2_202, "hardware": 3_303,
           "heartbeat": 4_404}
HEARTBEAT_LOST_AT = 10     # window from which node "heartbeat" is silent


# the phase running now, named in every FAIL line (``run_phase``)
PHASE = {"label": None}


def fail(msg: str) -> None:
    where = f"phase {PHASE['label']}: " if PHASE["label"] else ""
    print(f"FAIL: {where}{msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------------ timing

def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median milliseconds of ``fn`` on the card: CUDA events around each
    repeat, after warm-up and a synchronize."""
    import numpy as np
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end))
    return float(np.median(ts))


def max_abs_err(a, b) -> float:
    """Largest |a - b|, NaN equal to NaN, a NaN mismatch infinite."""
    import torch
    a, b = a.float(), b.float()
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return float("inf")
    d = torch.where(na, torch.zeros_like(a), a - b).abs()
    return float(d.max()) if d.numel() else 0.0


# A profiler session after the first one in a process can lose the kernels
# of its first few milliseconds on the card (seen on an H100: up to ~3 ms
# of them). A session that reads kernel names or times starts with a spin
# of LEAD_CYCLES clock cycles (torch.cuda._sleep, ~20 ms), which takes
# that loss instead, and splits the calls at marker kernels
# (``call_segments``), so that a lossy session is seen and taken again.
LEAD_CYCLES = 40_000_000
# profiler sessions ``call_segments`` took, and those that traced no whole
# call (printed at the end of a run)
SESSIONS = {"taken": 0, "lost": 0}


def kernel_device_ms(torch, fn, name: str, calls: int = 3):
    """Device ms per call of ``fn`` in its kernels whose base name holds
    ``name``: the sum of their ``kernel_split_ms``; None when no whole call
    was traced or none of its kernels has such a name."""
    rows = [ms for n, ms in kernel_split_ms(torch, fn, calls).items()
            if name in n]
    return sum(rows) if rows else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


# ------------------------------------------------------------ phase 2: K1

def k1_inputs(r: int, m: int, n: int, kind: str, seed: int):
    """Seeded (r, m, n) rows: plain, with NaN rows ("nan"), or with the
    selection's edge cases ("edge": an all-equal row, signed zeros, both
    infinities, sign-bit NaNs and ties)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mats = (rng.random((r, m, n), dtype=np.float32) * 0.1 + 1.0)
    mats[:, 0, n - 1] *= 1.5                 # planted step-time stragglers
    mats[:, 0, min(3, n - 1)] *= 1.3
    sign_nan = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]
    if kind == "nan":
        mats[:, 2, :] = np.nan               # a metric with no readings
        drop = rng.choice(n, n // 50, replace=False)
        mats[:, 3, drop] = np.nan            # sensor dropouts
        mats[:, 0, drop[:7]] = sign_nan      # x86 inf - inf NaNs
    elif kind == "edge":
        mats[:, 1, :] = 1.25                 # all equal
        mats[:, 2, ::2] = 0.0                # +0 and -0
        mats[:, 2, 1::3] = -0.0
        mats[:, 3, ::5] = np.inf             # both infinities
        mats[:, 3, 1::7] = -np.inf
        mats[:, 4, ::4] = sign_nan
        mats[:, 5, :] = np.round(mats[:, 5, :] * 4) / 4   # ties
    return mats


# K1 cases: R, M, N, kind. The first is the main path's steady state; rows
# of up to 49,152 nodes are staged in shared memory, longer ones streamed.
K1_CASES = [(1, 8, 16_384, ""), (6, 8, 16_384, ""), (1, 8, 131_072, ""),
            (1, 8, 16_383, "nan"), (1, 8, 1, "edge"), (1, 8, 2, "edge"),
            (2, 8, 4_097, "edge"), (1, 8, 131_072, "edge")]


def phase_k1(torch, np, dirs):
    from repro_torch.kernels.fleet_score import fleet_score, score_rows_ref
    kw = dict(z_threshold=3.0, slowdown_floor=0.025, mad_floor_frac=0.01)
    main = None
    for i, (r, m, n, kind) in enumerate(K1_CASES):
        mats = torch.from_numpy(k1_inputs(r, m, n, kind, i)).cuda()
        got = fleet_score(mats, dirs, 0, **kw)
        again = fleet_score(mats, dirs, 0, **kw)
        want = score_rows_ref(mats, dirs, 0, **kw)
        torch.cuda.synchronize()
        tag = (f"K1 fleet_score R,M,N={r},{m},{n}{f' {kind} rows' if kind else ''}"
               f" ({'staged' if n <= 49_152 else 'streamed'})")
        check(torch.equal(got[0], want[0]), f"{tag}: dev differs")
        err = max(max_abs_err(got[1], want[1]),
                  max_abs_err(got[2], want[2]))
        check(err == 0.0, f"{tag}: rel/contrib differ, max abs err {err}")
        check(all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                  for a, b in zip(got, again)), f"{tag}: two calls differ")
        line = f"{tag}: bit-equal to plain, two calls bit-equal"
        if kind != "edge":                      # timed at the real shapes
            ms = time_ms(lambda: fleet_score(mats, dirs, 0, **kw))
            dev_ms = kernel_device_ms(
                torch, lambda: fleet_score(mats, dirs, 0, **kw),
                "fleet_score")
            plain = time_ms(lambda: score_rows_ref(mats, dirs, 0, **kw))
            nbytes = r * m * n * 4 + r * m * n + 2 * r * n * 4 + m * 4
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            line += (f"; kernel {ms:.4f} ms a call ({fmt_ms(dev_ms)} on "
                     f"the device), plain {plain:.4f} ms, bound {bound:.6f} "
                     f"ms (bytes)")
            if main is None:                     # the main path's shape
                main = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                            plain_ms=plain, bound_ms=bound, shape=[r, m, n])
        print(line, flush=True)
    return main


# ------------------------------------------------------------ phase 3: K2

def call_segments(torch, fn, calls: int = 3, tries: int = 8):
    """The device kernels of each call of ``fn``, as (name, ms) lists, from
    the profiler over ``calls`` calls, each followed by a marker kernel
    (``torch.cuda._sleep``'s ``spin_kernel``), after the lead-in spin; ms
    is each kernel's own start-to-end time in the trace. What comes before
    the first marker is dropped, and a session whose calls between markers
    are empty or disagree in their kernels is taken again, its lead-in
    spin four times as long up to 64 LEAD_CYCLES (~1.4 s), up to ``tries``
    sessions. On an H100, late in a full run (from phase 9 or 13 on), the
    first session of a call often traced no kernel at all and up to three
    in a row did; a fresh process tracing 250 sessions lost none. None when
    no session agreed (the last one's kernels and its count of device
    events are printed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        SESSIONS["taken"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(LEAD_CYCLES * 4 ** min(attempt, 3))
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        segments = [[]]
        for e in events:
            if "spin_kernel" in e.name:
                segments.append([])
            else:
                segments[-1].append((e.name, (e.time_range.end -
                                              e.time_range.start) / 1e3))
        whole = segments[1:-1]           # each between two markers
        names = [[basename(n) for n, _ in seg] for seg in whole]
        if names and names[0] and all(n == names[0] for n in names):
            SESSIONS["lost"] += attempt
            if attempt:
                print(f"  (traced in session {attempt + 1} of {tries})",
                      flush=True)
            return whole
    SESSIONS["lost"] += tries
    print(f"  no whole call traced in {tries} sessions; the last one's "
          f"kernels between markers: {names} ({len(events)} device events "
          f"in it)", flush=True)
    return None


def kernels_in(torch, fn, calls: int = 3, tries: int = 8) -> list:
    """Names of the device kernels one call of ``fn`` runs
    (``call_segments``); empty when no whole call was traced."""
    segs = call_segments(torch, fn, calls, tries)
    return [] if segs is None else [n for n, _ in segs[0]]


def basename(name: str) -> str:
    """A kernel's name cut to its function's own name: no return type,
    namespaces, template arguments or parameters."""
    return name.replace("(anonymous namespace)::", "").split("<")[0] \
        .split("(")[0].split("::")[-1].split()[-1]


def kernel_split_ms(torch, fn, calls: int = 3) -> dict:
    """Device ms of each kernel of one call of ``fn``, by its base name,
    the mean over the whole calls of one profiler session
    (``call_segments``); empty when no whole call was traced."""
    segs = call_segments(torch, fn, calls) or []
    out = {}
    for seg in segs:
        for n, ms in seg:
            out[basename(n)] = out.get(basename(n), 0.0) + ms / len(segs)
    return out


def kernel_basenames(torch, fn) -> list:
    """``kernels_in`` with each name cut to its ``basename``."""
    return [basename(n) for n in kernels_in(torch, fn)]


def phase_k2(torch, np):
    from repro_torch.kernels.sweep_burn import burn, burn_flops, burn_ref
    from repro_torch.kernels.sweep_burn.sweep_burn import LAST
    main = None
    # the first is the compute probe's shape (the main path's)
    for m, k, iters in [(512, 512, 64), (128, 256, 8), (2048, 2048, 16)]:
        rng = np.random.default_rng(m + k)
        a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
        b = torch.from_numpy(rng.standard_normal((k, k), dtype=np.float32))
        a, b = a.cuda(), b.cuda()
        o1 = burn(a, b, iters=iters)
        o2 = burn(a, b, iters=iters)
        want = burn_ref(a, b, iters=iters)
        torch.cuda.synchronize()
        check(torch.equal(o1, o2), f"burn not bit-repeatable at {(m, k)}")
        err = max_abs_err(o1, want)
        check(err <= 1e-3, f"burn differs from plain at {(m, k, iters)}: "
                           f"max abs err {err}")
        names = kernels_in(torch, lambda: burn(a, b, iters=iters))
        check(len(names) == 1 and "burn" in names[0],
              f"burn at {(m, k, iters)} ran {names}, not one launch")
        ms = time_ms(lambda: burn(a, b, iters=iters), reps=5, warm=1)
        plain = time_ms(lambda: burn_ref(a, b, iters=iters), reps=5, warm=1)
        y = torch.empty_like(a)

        def matmul_chain():                   # cuBLAS float32 yardstick
            for _ in range(iters):
                torch.matmul(a, b, out=y)
        torch.backends.cuda.matmul.allow_tf32 = False
        lib = time_ms(matmul_chain, reps=5, warm=1)
        flops = burn_flops(m, k, iters)
        bnd = flops / FP32_SIMT_FLOPS * 1e3
        print(f"K2 sweep_burn M,K,iters={m},{k},{iters}: max abs err "
              f"{err:.3e}, bit-repeatable, one launch ({LAST['mode']}, "
              f"{LAST['blocks']} blocks); kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s, {bnd / ms:.1%} of bound), "
              f"plain {plain:.4f} ms, matmul chain {lib:.4f} ms "
              f"({flops / lib / 1e9:.2f} TFLOP/s), bound {bnd:.4f} ms "
              f"(operations)", flush=True)
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=bnd, library_ms=lib,
                        shape=[m, k, iters])
    return main


# ------------------------------------------------------- phase 4: the loop

class SyntheticFleet:
    """Seeded telemetry for a 16,384-node job with four planted faults.

    Healthy readings carry bounded (uniform) noise, so no healthy node
    can reach a robust z of 3; the planted nodes are unambiguous. The
    fleet follows the session's swaps: a replaced column reports as a
    healthy node under the spare's id."""

    def __init__(self, control, n: int = N_MAIN, seed: int = 0):
        import numpy as np
        self.np = np
        self.control = control
        self.ids = np.arange(n, dtype=np.int64)
        self.seed = seed
        self._applied = 0

    def frame(self, w: int):
        np = self.np
        from repro_torch.core import Frame
        for old, new in self.control.swaps[self._applied:]:
            self.ids[self.ids == old] = new
        self._applied = len(self.control.swaps)
        n = len(self.ids)
        rng = np.random.default_rng([self.seed, w])

        def around(v, a):
            return v + rng.uniform(-a, a, n)
        m = {
            "step_time": 10.0 * (1.0 + rng.uniform(-0.004, 0.004, n)),
            "gpu_temp": around(58.0, 1.0),
            "gpu_util": around(0.97, 0.005),
            "gpu_freq": around(1.93, 0.01),
            "gpu_power": around(350.0, 5.0),
            "nic_errors": rng.integers(0, 5, n).astype(np.float64),
            "nic_tx_rate": around(50.0, 1.0),
            "nic_up": np.ones(n),
        }
        valid = np.ones(n, bool)
        col = {k: np.flatnonzero(self.ids == v) for k, v in PLANTED.items()}
        m["step_time"][col["immediate"]] *= 1.30
        m["step_time"][col["defer"]] *= 1.12
        m["gpu_temp"][col["hardware"]] = 88.0
        m["gpu_freq"][col["hardware"]] = 1.20
        if w >= HEARTBEAT_LOST_AT:
            valid[col["heartbeat"]] = False
        t = WINDOW_S * (w + 1)
        return Frame(t=t, step=100 * (w + 1), node_ids=self.ids.copy(),
                     metrics=m, valid=valid)


def drive(device: str, frames=None, jsonl: Path = None):
    """Run the closed loop on ``device``; replay ``frames`` when given,
    else draw them from the synthetic fleet. Returns (session, control,
    frames, observe seconds per window)."""
    from repro_torch.guard import (GuardSession, JsonlSink, LocalHostControl,
                                   Tier)
    from repro_torch.kernels.sweep_burn import LocalTorchSweepBackend
    control = LocalHostControl()
    session = GuardSession.from_tier(
        Tier.ENHANCED, control, LocalTorchSweepBackend(device=device),
        device=device)
    session.register_active(range(N_MAIN))
    session.register_spares(range(N_MAIN, N_MAIN + N_SPARES))
    sink = JsonlSink(str(jsonl))
    session.add_sink(sink)
    fleet = SyntheticFleet(control) if frames is None else None
    seen, secs = [], []
    for w in range(WINDOWS):
        f = fleet.frame(w) if frames is None else frames[w]
        seen.append(f)
        control.t = f.t
        t0 = time.perf_counter()
        session.observe(f)
        if device != "cpu":
            import torch
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if (w + 1) % CKPT_EVERY == 0:
            session.on_checkpoint()
        session.advance(control.t)
    sink.close()
    return session, control, seen, secs


def phase_main(torch, np):
    from repro_torch.core import Action, NodeState
    from repro_torch.kernels.fleet_score import COUNTER as K1
    from repro_torch.kernels.sweep_burn import COUNTER as K2
    out = ROOT / "build" / "repro_torch" / "smoke"
    out.mkdir(parents=True, exist_ok=True)
    for p in out.glob("*.jsonl"):
        p.unlink()
    K1.reset()
    K2.reset()
    session, control, frames, secs = drive("cuda", jsonl=out / "cuda.jsonl")
    k1, k2 = K1.launches, K2.launches
    check(k1 == WINDOWS, f"fleet_score launched {k1} times in {WINDOWS} "
                         f"windows (expected one per window)")
    check(k2 > 0, "the sweep never launched the burn kernel")

    acts = {}
    for ev in session.events():
        if ev.kind == "straggler_flagged":
            acts.setdefault(ev.node_id, set()).add(ev.action)
    want = {PLANTED["immediate"]: {Action.IMMEDIATE_RESTART.value},
            PLANTED["defer"]: {Action.DEFER_TO_CHECKPOINT.value},
            PLANTED["hardware"]: {Action.PENDING_VERIFICATION.value},
            PLANTED["heartbeat"]: {Action.IMMEDIATE_RESTART.value}}
    check(acts == want, f"actions {acts} != expected {want}")
    swapped = sorted(old for old, _ in control.swaps)
    check(swapped == sorted([PLANTED["immediate"], PLANTED["defer"],
                             PLANTED["heartbeat"]]),
          f"swaps {control.swaps}")
    quarantined = sorted(e.node_id for e in session.events()
                         if e.kind == "quarantine")
    check(quarantined == swapped, f"quarantines {quarantined}")
    st = session.stats
    check(st.immediate_restarts == 2 and st.deferred_swaps == 1,
          f"stats {st}")
    check(session.node_state(PLANTED["hardware"]) == NodeState.PENDING,
          "hardware-only node is not pending verification")
    for nid in swapped:
        check(session.node_state(nid) == NodeState.QUARANTINED,
              f"node {nid} not quarantined")
    started = [e.node_id for e in session.events() if e.kind == "sweep_start"]
    check(len(started) >= 1, "no offline qualification started")

    _, _, _, cpu_secs = drive("cpu", frames=frames, jsonl=out / "cpu.jsonl")
    a = (out / "cuda.jsonl").read_text()
    b = (out / "cpu.jsonl").read_text()
    check(a == b, "event stream on the card differs from the CPU stream")
    p50 = float(np.median(secs)) * 1e3
    print(f"main path: {N_MAIN} nodes, {N_SPARES} spares, {WINDOWS} windows;"
          f" actions {dict(sorted((k, sorted(v)) for k, v in acts.items()))};"
          f" swaps {control.swaps}; sweeps started {started}; "
          f"{len(a.splitlines())} events, identical to the CPU run; "
          f"fleet_score launches {k1}, sweep_burn launches {k2}; "
          f"session.observe p50 {p50:.3f} ms on the card "
          f"(CPU run p50 {float(np.median(cpu_secs)) * 1e3:.3f} ms)",
          flush=True)
    return k1, k2


# ------------------------------------------------------------ phase 5: K3

def close_err(got, want, atol: float, rtol: float, what: str) -> float:
    """Largest |got - want|; fails unless every element of ``got`` is
    finite and within atol + rtol |want|."""
    import torch
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (d <= atol + rtol * w.abs()).all())
    err = float(d.max())
    check(ok, f"{what}: max abs err {err} beyond atol {atol}, rtol {rtol}")
    return err


def bound(flops: float, peak: float, nbytes: float):
    """(bound ms, what bounds it): the larger of operations over the peak
    rate of their type and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# K3 cases: B, Hq, Hkv, S, T, hd, causal, q_offset, kv_len, dtype. The
# first is qwen3-4b's prefill at 4,096 tokens, the main path's shape; the
# bfloat16 ones after the float32 case cover every head dim, a ragged S,
# MQA and Hq/Hkv = 4, a decode chunk (q_offset > 0, causal) and kv_len < T;
# then whisper-small's prefill (phase 21) at 4 x (1,500 frames, 448
# tokens): the encoder's full self attention over 1,500 frames (23.4 tiles
# of 64), the decoder's cross attention (S < T) and its causal self
# attention, Hq = Hkv = 12 at hd 64, and the encoder's in float32; the
# last, VLM_ATTN, is qwen2-vl-72b's (phases 23 and 24), timed beside plain
# and sdpa too.
# qwen2-vl-72b's causal attention at 4,096 tokens: 64 query heads over 8
# KV heads of 128, a group of G = 8
VLM_ATTN = (1, 64, 8, 4096, 4096, 128, True, 0, 0, "bfloat16")
# qwen3-4b's attention on each rank of phase 25's (1, 4) mesh: its 8 of
# the 32 query heads over its 2 of the 8 KV heads (G = 4)
TP_ATTN = (1, 8, 2, 4096, 4096, 128, True, 0, 0, "bfloat16")
# qwen3-4b's prefill on each rank of phase 27's (2, 2) mesh: its row of
# 2,048 tokens, its 16 of the 32 query heads over its 4 of the 8 KV heads
FSDP_ATTN = (1, 16, 4, 2048, 2048, 128, True, 0, 0, "bfloat16")
# whisper-small's encoder attention on each rank of phase 25(f): 3 of its
# 12 heads at 4 x 1,500 frames; then its cross and decoder self attention
# there (checked, not timed beside plain and sdpa)
TP_AUDIO_ATTN = (4, 3, 3, 1500, 1500, 64, False, 0, 0, "bfloat16")
TP_AUDIO_OTHER = [(4, 3, 3, 448, 1500, 64, False, 0, 0, "bfloat16"),
                  (4, 3, 3, 448, 448, 64, True, 0, 0, "bfloat16")]
K3_CASES = [
    (1, 32, 8, 4096, 4096, 128, True, 0, 0, "bfloat16"),
    (1, 32, 8, 4096, 4096, 128, True, 0, 0, "float32"),
    (2, 8, 2, 300, 450, 64, False, 0, 0, "bfloat16"),
    (1, 4, 1, 300, 300, 32, True, 0, 0, "bfloat16"),
    (2, 8, 8, 300, 300, 64, True, 0, 0, "bfloat16"),
    (1, 8, 2, 300, 300, 128, True, 0, 0, "bfloat16"),
    (1, 8, 2, 64, 576, 128, True, 512, 0, "bfloat16"),
    (2, 8, 1, 256, 512, 64, False, 0, 400, "bfloat16"),
    (1, 4, 4, 200, 333, 32, True, 133, 300, "bfloat16"),
    (1, 4, 1, 130, 200, 64, True, 70, 190, "float32"),
    (4, 12, 12, 1500, 1500, 64, False, 0, 0, "bfloat16"),
    (4, 12, 12, 448, 1500, 64, False, 0, 0, "bfloat16"),
    (4, 12, 12, 448, 448, 64, True, 0, 0, "bfloat16"),
    (4, 12, 12, 1500, 1500, 64, False, 0, 0, "float32"),
    VLM_ATTN,
    TP_ATTN,
    TP_AUDIO_ATTN,
    *TP_AUDIO_OTHER,
    FSDP_ATTN,
]
K3_TOL = {"bfloat16": 3e-2, "float32": 2e-5}   # the reference's own


def phase_k3(torch, np):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_flops,
                                                     attention_ref,
                                                     flash_attention)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: fp32
    torch.backends.cudnn.allow_tf32 = False
    main = None
    for i, case in enumerate(K3_CASES):
        b, hq, hkv, s, t, hd, causal, qo, kvl, dname = case
        dt, tol = getattr(torch, dname), K3_TOL[dname]
        rng = np.random.default_rng(100 + i)
        # the model's (B, S, H, hd) layout, seen through transposes
        q, k, v = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to("cuda", dt).transpose(1, 2)
            for shape in ((b, s, hq, hd), (b, t, hkv, hd), (b, t, hkv, hd)))
        kw = dict(causal=causal, q_offset=qo, kv_len=kvl)
        got = flash_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        tag = (f"K3 flash_attention B,Hq,Hkv,S,T,hd={b},{hq},{hkv},{s},{t},"
               f"{hd} {'causal' if causal else 'full'}"
               f"{f' q_offset {qo}' if qo else ''}"
               f"{f' kv_len {kvl}' if kvl else ''} {dname}")
        err = close_err(got, want, tol, tol, tag)
        del got, want
        ms = time_ms(lambda: flash_attention(q, k, v, **kw), reps=10, warm=2)
        flops = attention_flops(b, hq, s, kvl or t, hd, causal=causal,
                                q_offset=qo)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else FP32_SIMT_FLOPS
        bnd, by = bound(flops, peak, nbytes)
        line = (f"{tag}: max abs err {err:.3e} (tol {tol}); kernel "
                f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s, "
                f"{bnd / ms:.1%} of bound), bound {bnd:.4f} ms ({by}; "
                f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
        if i < 3 or case in (VLM_ATTN, TP_ATTN, TP_AUDIO_ATTN,  # plain,
                             FSDP_ATTN):                        # sdpa
            plain = time_ms(lambda: attention_ref(q, k, v, **kw), reps=5,
                            warm=1)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps=10,
                warm=2)
            line += f"; plain {plain:.4f} ms, sdpa {lib:.4f} ms"
            nums = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=bnd, bound_by=by, library_ms=lib,
                        shape=[b, hq, hkv, s, t, hd])
        print(line, flush=True)
        if main is None:
            main = nums
        if case == VLM_ATTN:
            main["vlm"] = nums
        if case == TP_ATTN:
            main["tp"] = nums
        if case == TP_AUDIO_ATTN:
            main["tp_audio"] = nums
        if case == FSDP_ATTN:
            main["fsdp"] = nums
        del q, k, v
    torch.cuda.empty_cache()
    return main


# ------------------------------------------------------------ phase 6: K4

# K4 cases: B, S, H, hd, chunk, r/k/v dtype. The first is rwkv6-7b's
# prefill at 2,048 tokens with the model's chunk of 32, the main path's
# shape; the rest cover every head dim, B = 2, and single chunks whose
# length is no multiple of 32 (the model's chunk for a ragged prompt),
# 1,000 tokens at rwkv6-7b's width among them.
K4_CASES = [(1, 2048, 64, 64, 32, "bfloat16"), (2, 128, 4, 32, 32, "float32"),
            (1, 256, 2, 128, 64, "float32"), (2, 100, 4, 16, 100, "bfloat16"),
            (1, 1000, 64, 64, 1000, "bfloat16"),
            (2, 300, 2, 128, 300, "bfloat16"), (1, 7, 2, 64, 7, "float32")]
# rwkv6-7b's prefill on each rank of phase 25(d): 16 of its 64 heads
TP_K4 = (1, 2048, 16, 64, 32, "bfloat16")
# rwkv6-7b's prefill on each rank of phase 27's (2, 2) mesh: its row of
# 2,048 tokens at 32 of its 64 heads
FSDP_K4 = (1, 2048, 32, 64, 32, "bfloat16")
K4_CASES += [TP_K4, FSDP_K4]


def phase_k4(torch, np):
    from repro_torch.kernels.wkv6 import (scratch_bytes, wkv6_bytes,
                                          wkv6_chunked, wkv6_flops, wkv6_ref)
    main = None
    for i, (b, s, h, hd, c, dname) in enumerate(K4_CASES):
        dt = getattr(torch, dname)
        rng = np.random.default_rng(200 + i)

        def mk(*shape, scale=0.5):
            x = rng.standard_normal(shape, dtype=np.float32) * scale
            return torch.from_numpy(x).cuda()
        # model layout, seen through transposes as the model passes them
        r, k, v = (mk(b, s, h, hd).to(dt).transpose(1, 2) for _ in range(3))
        logw = (-torch.exp(mk(b, s, h, hd) - 2.0)).transpose(1, 2)
        u, s0 = mk(h, hd, scale=0.15), mk(b, h, hd, hd, scale=0.05)
        y, st = wkv6_chunked(r, k, v, logw, u, s0, chunk=c)
        y2, st2 = wkv6_chunked(r, k, v, logw, u, s0, chunk=c)
        wy, ws = wkv6_ref(r, k, v, logw, u, s0, chunk=c)
        torch.cuda.synchronize()
        tag = f"K4 wkv6 B,S,H,hd={b},{s},{h},{hd} chunk {c} {dname}"
        err = max(close_err(y, wy, 2e-3, 1e-3, tag + " y"),
                  close_err(st, ws, 2e-3, 1e-3, tag + " state"))
        check(torch.equal(y, y2) and torch.equal(st, st2),
              f"{tag}: two calls are not bit-equal")
        line = (f"{tag}: max abs err {err:.3e} (atol 2e-3, rtol 1e-3), two "
                f"calls bit-equal, scratch "
                f"{scratch_bytes(b, h, s, hd, c) / 2**20:.2f} MiB")
        if i == 0:
            # a call is the state pass, then the output pass
            names = kernel_basenames(torch, lambda: wkv6_chunked(
                r, k, v, logw, u, s0, chunk=c))
            check(names == ["wkv6_state", "wkv6_out"],
                  f"{tag}: one call ran {names}")
            # the state carried across two calls of half the tokens
            half = s // 2
            ya, sa = wkv6_chunked(r[:, :, :half], k[:, :, :half],
                                  v[:, :, :half], logw[:, :, :half], u, s0,
                                  chunk=c)
            yb, sb = wkv6_chunked(r[:, :, half:], k[:, :, half:],
                                  v[:, :, half:], logw[:, :, half:], u, sa,
                                  chunk=c)
            carry = max(close_err(torch.cat([ya, yb], 2), y, 2e-3, 1e-3,
                                  tag + " two calls y"),
                        close_err(sb, st, 2e-3, 1e-3, tag + " two calls s"))
            line += (f", {len(names)} device kernels per call "
                     f"({', '.join(names)}), "
                     f"state carried over two calls of {half} tokens "
                     f"within {carry:.3e}")
        ms = time_ms(lambda: wkv6_chunked(r, k, v, logw, u, s0, chunk=c))
        split = kernel_split_ms(torch, lambda: wkv6_chunked(
            r, k, v, logw, u, s0, chunk=c))
        split = {n: split.get(n) for n in ("wkv6_state", "wkv6_out")}
        dev_ms = (None if None in split.values()
                  else split["wkv6_state"] + split["wkv6_out"])
        plain = time_ms(lambda: wkv6_ref(r, k, v, logw, u, s0, chunk=c),
                        reps=5, warm=1)
        flops = wkv6_flops(b, h, s, hd, c)
        nbytes = wkv6_bytes(b, h, s, hd, r.element_size())
        bnd, by = bound(flops, FP32_SIMT_FLOPS, nbytes)
        print(f"{line}; kernel {ms:.4f} ms a call ({fmt_ms(dev_ms)} on the "
              f"device: state pass {fmt_ms(split['wkv6_state'])}, output "
              f"pass {fmt_ms(split['wkv6_out'])}), plain {plain:.4f} ms, "
              f"library none, bound "
              f"{bnd:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP fp32, "
              f"{nbytes / 1e6:.2f} MB)", flush=True)
        nums = dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                    plain_ms=plain, bound_ms=bnd, bound_by=by,
                    library_ms=None, shape=[b, s, h, hd, c],
                    kernels_per_call=len(names))
        if main is None:
            main = nums
        if K4_CASES[i] == TP_K4:
            main["tp"] = nums
        if K4_CASES[i] == FSDP_K4:
            main["fsdp"] = nums
        del r, k, v, logw, y, y2, wy
    torch.cuda.empty_cache()
    return main


# ---------------------------------------------- phases 7 and 8: serving

# The kernel path and the plain path of one bfloat16 model differ only in
# the order of float32 sums inside attention / WKV. That flips single
# bfloat16 roundings, which then travel through every later layer of the
# random-weight model and grow (measured on an H100: 2.1e-2 for qwen3-4b
# at 36 layers, 5.4e-2 for rwkv6-7b at 32). Logits and caches must agree
# within PATH_REL_TOL of their largest magnitude, and the first cache the
# kernel feeds, before any growth, within FIRST_REL_TOL: qwen3-4b's layer
# 1 K/V (one bfloat16 rounding of layer 0's attention away) and rwkv6-7b's
# layer 0 WKV state (the kernel's own float32 output). The moe family's
# first such cache is the same kind as the dense one's, one attention
# away: deepseek-moe-16b's MoE layer 0 K/V (after its dense first layer)
# and llama4-scout's MoE layer 1 K/V (measured on an H100: 1.16e-2 and
# 9.1e-3), so it takes the dense limit; the moe family is held on the
# kernel path's routing (see TIE_EPS). The hybrid family's first such
# state is unit 0's first rec layer's h, the RG-LRU kernel's own float32
# output on the inputs both paths share, so it takes the ssm limit. The
# audio family's decoder layer 0 self K/V is computed from the token
# embedding and pos_dec alone, with no kernel before it: it must be
# bit-equal (a limit of 0). The vlm family is the dense layer stack: its
# layer 1 K/V takes the dense limit.
PATH_REL_TOL = 1e-1
FIRST_REL_TOL = {"dense": 2e-2, "ssm": 1e-3, "moe": 2e-2, "hybrid": 1e-3,
                 "audio": 0.0, "vlm": 2e-2}


@contextlib.contextmanager
def plain_paths():
    """Send the models' attention, WKV and RG-LRU calls to the plain
    versions on the card (the WKV6 backward too), for the comparison run;
    nothing of the port changes."""
    from unittest import mock
    import repro_torch.models.attention as attention_mod
    import repro_torch.models.rglru as rglru_mod
    import repro_torch.models.rwkv6 as rwkv6_mod
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.kernels.rglru import rglru_plain
    from repro_torch.kernels.wkv6 import wkv6_plain

    def attn(q, k, v, *, causal, q_offset=0, kv_len=0, window=0):
        return attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                             causal=causal, q_offset=q_offset,
                             kv_len=kv_len, window=window).transpose(1, 2)

    # wkv6_plain: wkv6_ref, differentiated by wkv6_bwd_ref when training;
    # rglru_plain: rglru_ref, differentiated by rglru_bwd_ref
    with mock.patch.object(attention_mod, "flash", attn), \
            mock.patch.object(rwkv6_mod, "wkv6", wkv6_plain), \
            mock.patch.object(rglru_mod, "lru_scan", rglru_plain):
        yield


def device_profile(torch, fn, reps: int):
    """Host-clock ms per call of ``fn`` (ending in a synchronize), and, from
    ``torch.profiler`` over the same number of calls, the device's busy ms
    per call (the sum of its kernels' times: the CPU-side operator rows,
    which repeat their kernels' time, are left out) and the five kernels
    with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)     # the tracer's first kernel
        torch.cuda.synchronize()                 # may be lost: not fn's
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(t for _, t in rows) / reps / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:5]
    return wall, busy, [(k[:60], round(t / reps / 1e3, 4)) for k, t in top]


def rel_err(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def prefill_vs_plain(torch, model, cfg, tokens, counters: dict, tag: str,
                     frames=None, image=None):
    """Prefill ``tokens`` (and the audio family's encoder ``frames``, the
    vlm family's ``image``: ``prefill``'s ``positions`` and
    ``patch_embeds``) on the kernel path and on the plain path; fails
    unless both agree within PATH_REL_TOL / FIRST_REL_TOL. Returns the
    launches of each kernel during the kernel-path prefill and its
    seconds."""
    image = image or {}
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, frames, **image)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    check(bool(torch.isfinite(logits).all()),
          f"{tag}: non-finite prefill logits")
    with plain_paths():
        plain_logits, plain_cache = model.prefill(tokens, frames, **image)
    torch.cuda.synchronize()
    check(all(c.launches == launches[n] for n, c in counters.items()),
          f"{tag}: the plain path launched a kernel")
    # the real vocabulary's logits: the padded slots' -1e9 would be the
    # largest magnitude (whisper-small pads 51,865 to 51,968)
    errs = {"logits": rel_err(logits[..., :cfg.vocab_size],
                              plain_logits[..., :cfg.vocab_size])}
    if cfg.family == "ssm":
        for name in ("wkv", "x_tm", "x_cm"):
            errs[name] = rel_err(cache[name], plain_cache[name])
        first = ("layer 0 wkv", rel_err(cache["wkv"][0],
                                        plain_cache["wkv"][0]))
    elif cfg.family == "hybrid":
        want = hybrid_leaves(plain_cache)
        for name, got in hybrid_leaves(cache).items():
            errs[name] = rel_err(got, want[name])
        first = ("unit 0 l0_rec h", rel_err(
            cache["units"]["l0_rec"]["h"][0],
            plain_cache["units"]["l0_rec"]["h"][0]))
    elif cfg.family == "audio":
        names = ("k", "v", "cross k", "cross v")
        for name, got, want in zip(names, cache["layers"],
                                   plain_cache["layers"]):
            errs[f"{name} cache"] = rel_err(got, want)
        first = ("decoder layer 0 self k/v", max(
            rel_err(got[0], want[0]) for got, want in
            zip(cache["layers"][:2], plain_cache["layers"][:2])))
    else:
        for name, got, want in zip("kv", cache["layers"],
                                   plain_cache["layers"]):
            errs[f"{name} cache"] = rel_err(got, want)
        first = ("layer 1 k/v", max(
            rel_err(got[1], want[1]) for got, want in
            zip(cache["layers"], plain_cache["layers"])))
    print(f"{tag} prefill kernel vs plain path, max abs err / max abs: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; {first[0]} {first[1]:.3e}; launches {launches}", flush=True)
    for name, e in errs.items():
        check(e <= PATH_REL_TOL, f"{tag}: prefill {name} differs from the "
                                 f"plain path by {e:.3e} of its largest "
                                 f"magnitude (> {PATH_REL_TOL})")
    check(first[1] <= FIRST_REL_TOL[cfg.family],
          f"{tag}: {first[0]} differs from the plain path by "
          f"{first[1]:.3e} (> {FIRST_REL_TOL[cfg.family]})")
    if cfg.family == "hybrid":
        ring_decode_vs_plain(torch, model, cache, plain_cache, counters,
                             tag)
    return launches, secs


def hybrid_leaves(cache) -> dict:
    """The hybrid cache's tensors by name: each unit layer's (stacked over
    the units) and each tail layer's."""
    out = {}

    def add(prefix, c):
        items = zip("kv", c) if isinstance(c, tuple) else c.items()
        for name, t in items:
            out[f"{prefix}.{name}"] = t
    for key, c in cache["units"].items():
        add(f"units.{key}", c)
    for j, c in enumerate(cache["tail"]):
        add(f"tail.{j}", c)
    return out


HYBRID_DECODE_STEPS = 6


def ring_decode_vs_plain(torch, model, cache, plain_cache, counters: dict,
                         tag: str) -> None:
    """HYBRID_DECODE_STEPS decode steps from the kernel path's prefill cache
    and from the plain path's, on the same seeded tokens (decode runs no
    kernel: the two differ only by their caches); fails unless each
    step's logits agree within PATH_REL_TOL and no kernel launched. After
    a prefill of a multiple of the window the first step overwrites ring
    slot 0."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for c in counters.values():
        c.reset()
    errs = []
    for _ in range(HYBRID_DECODE_STEPS):
        toks = torch.randint(0, model.cfg.vocab_size, (1,), device="cuda",
                             generator=gen)
        got, cache = model.decode_step(toks, cache)
        want, plain_cache = model.decode_step(toks, plain_cache)
        check(bool(torch.isfinite(got).all()),
              f"{tag}: non-finite decode logits")
        errs.append(rel_err(got, want))
    check(all(c.launches == 0 for c in counters.values()),
          f"{tag}: a decode step launched a kernel")
    print(f"{tag}: {HYBRID_DECODE_STEPS} ring decode steps from position "
          f"{cache['pos'] - HYBRID_DECODE_STEPS} (ring slot "
          f"{(cache['pos'] - HYBRID_DECODE_STEPS) % model.cfg.window} "
          f"first), logits kernel-path cache vs plain-path cache, max abs "
          f"err / max abs: {[f'{e:.3e}' for e in errs]}", flush=True)
    for i, e in enumerate(errs):
        check(e <= PATH_REL_TOL, f"{tag}: decode step {i} logits differ "
                                 f"from the plain path's by {e:.3e} "
                                 f"(> {PATH_REL_TOL})")


def phase_serve(torch, np, arch: str, seq: int, counters: dict,
                ragged: int = 0, layers: int = 0, batch: int = 1,
                cache_len: int = 512):
    """Prefill of ``batch`` sequences of ``seq`` tokens (the audio family:
    with seeded encoder frames; the vlm family: opening with an image of
    VLM_GRID seeded patch embeddings, in Qwen2-VL's M-RoPE layout) at full
    width and depth (``layers`` deep when given) on the kernel path,
    checked against the plain path (again at a ``ragged`` prompt length,
    with the same image, when given; the moe family by
    ``moe_prefill_vs_plain``; the hybrid family's each followed by
    ``ring_decode_vs_plain``), then a BatchedServer with caches of
    ``cache_len`` to completion; the moe and hybrid families also print
    their prefill's operator rows, the moe family the slots
    MOE_DECODE_STEPS decode steps drop. Returns the launches of each
    kernel during the prefill and the numbers (``ragged_launches`` among
    them)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, synthetic_requests
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, seq))).cuda()
    frames = image = rimage = None
    if cfg.is_encoder_decoder:
        frames = torch.from_numpy(rng.standard_normal(
            (batch, cfg.encoder_seq_len, cfg.d_model),
            dtype=np.float32)).cuda()
    if cfg.mrope_sections:
        patches = torch.from_numpy(rng.standard_normal(
            (batch, VLM_GRID[0] * VLM_GRID[1], cfg.d_model),
            dtype=np.float32)).cuda()
        image = vlm_image(torch, np, patches, seq)
        rimage = vlm_image(torch, np, patches[:1], ragged or seq)
    tag = f"{arch} {seq} tokens" + (f" x {batch}" if batch > 1 else "")
    extra = {}
    if cfg.moe:
        launches, first_s, extra["vs_plain"] = moe_prefill_vs_plain(
            torch, model, cfg, tokens, counters, tag)
    else:
        launches, first_s = prefill_vs_plain(torch, model, cfg, tokens,
                                             counters, tag, frames, image)
    if ragged:
        rtoks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              (1, ragged))).cuda()
        extra["ragged_launches"], extra["ragged_prefill_s"] = \
            prefill_vs_plain(torch, model, cfg, rtoks, counters,
                             f"{arch} {ragged} tokens", image=rimage)
    image = image or {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(tokens, frames, **image)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    p_wall, p_busy, p_top = device_profile(
        torch, lambda: model.prefill(tokens, frames, **image), reps=2)
    print(f"{arch} prefill profile: {p_wall:.1f} ms wall, device busy "
          f"{p_busy:.1f} ms ({p_busy / p_wall:.0%}); top kernels (ms per "
          f"prefill): {p_top}", flush=True)
    if cfg.moe or cfg.family == "hybrid":
        extra["prefill_ops"] = op_rows(torch, lambda: model.prefill(tokens),
                                       reps=2)
        print(f"{arch} prefill operators (device ms per prefill): "
              f"{extra['prefill_ops']}", flush=True)
    dcache = model.init_cache(4, cache_len)
    dtoks = torch.zeros(4, dtype=torch.long, device=model.device)
    d_wall, d_busy, d_top = device_profile(
        torch, lambda: model.decode_step(dtoks, dcache), reps=8)
    print(f"{arch} decode step profile (batch 4): {d_wall:.2f} ms wall, "
          f"device busy {d_busy:.2f} ms ({d_busy / d_wall:.0%}); top kernels"
          f" (ms per step): {d_top}", flush=True)
    del dcache

    server = BatchedServer(model, 4, cache_len)
    decode = model.decode_step
    finite = []

    def checked_step(toks, c):
        out, c = decode(toks, c)
        finite.append(torch.isfinite(out).all())
        return out, c
    model.decode_step = checked_step
    queue = synthetic_requests(12, cfg.vocab_size, 0)
    reqs = list(queue)
    out = server.run(queue)
    check(out["requests_done"] == 12 and all(r.done for r in reqs),
          f"{arch}: server finished {out['requests_done']} of 12 requests")
    check(bool(torch.stack(finite).all()),
          f"{arch}: non-finite logits in a decode step")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
          f"{arch}: a token outside the vocabulary")
    if cfg.moe:
        model.decode_step = decode
        drops = decode_drops(torch, model, MOE_DECODE_STEPS)
        extra["decode_drops"] = drops
        from repro_torch.models.moe import capacity
        print(f"{arch} decode over 4 slots, slots dropped by the capacity "
              f"(C = {capacity(4, cfg)}) in each of {MOE_DECODE_STEPS} "
              f"steps, summed over the {len(model.layers)} MoE layers: "
              f"{drops}", flush=True)
    nums = dict(init_s=init_s, first_prefill_s=first_s, prefill_s=prefill_s,
                seq=seq, batch=batch, params=n_params,
                prefill_tok_per_s=batch * seq / prefill_s,
                prefill_busy_ms=p_busy,
                decode_step_ms=d_wall, decode_busy_ms=d_busy, **extra, **out)
    print(f"{arch} ({n_params / 1e9:.3f} B params, {cfg.num_layers} layers):"
          f" init {init_s:.2f} s; prefill of {batch} x {seq} tokens "
          f"{prefill_s * 1e3:.1f} ms ({batch * seq / prefill_s:.0f} tok/s; "
          f"first call {first_s * 1e3:.1f}"
          f" ms); launches {launches}; server: {out['requests_done']} "
          f"requests in {out['decode_steps']} decode steps, "
          f"{out['tokens_out']} tokens, {out['wall_s']:.2f} s, "
          f"{out['tok_per_s']:.1f} tok/s "
          f"({out['decode_steps'] / out['wall_s']:.1f} steps/s at batch 4)"
          + (f"; ragged prefill of {ragged} tokens (one chunk) "
             f"{extra['ragged_prefill_s'] * 1e3:.1f} ms, first call"
             if ragged else ""), flush=True)
    del model, server, decode
    gc.collect()
    torch.cuda.empty_cache()
    return launches, nums


# ------------------------------------------- phases 15 and 16: the moe family

MOE_SEQ = 4096
LLAMA4_LAYERS = 4          # of llama4-scout's 48: 107.8 B parameters
                           # (216 GB in bf16) do not fit one card
MOE_TRAIN_LAYERS = 4       # of deepseek-moe-16b's 28: dense0 + 3 MoE layers
MOE_DECODE_STEPS = 32      # recorded decode steps over 4 slots
# The kernel path and the plain path round the hidden states differently
# (K3 rounds its probabilities to bf16), so a near-tied router choice can
# flip between them, and a flip moves where a full expert's capacity cut
# falls. With random weights the routers are near flat and most experts
# overflow, so flips spread layer by layer (measured on an H100 in the
# 28-layer deepseek prefill: 1,072 flipped (token, choice) slots of
# 24,576 in the first MoE layer, 7,564 in the last, one token of 4,096
# routed alike in every layer). A flipped token cannot be held to a
# rounding limit. So phases 15 and 16 count the flips, check that those
# of the first MoE layer, whose inputs differ by rounding only, are near
# ties (the two experts' kernel-path probabilities within TIE_EPS), and
# hold the plain path to the kernel path's limits on the kernel path's
# routing: the plain path's router takes the kernel path's experts call
# by call, with its own probabilities as weights.
TIE_EPS = 2e-2


@contextlib.contextmanager
def recorded_routes(torch, log: list):
    """Keep in ``log``, for every MoE call, its router probabilities
    (T, E), experts (B, S, k) and each dispatched slot's keep bit
    (``moe.plan_slots``; under expert parallelism, of the rank's own
    slots)."""
    from unittest import mock
    import repro_torch.models.moe as moe_mod
    top_k, inner = moe_mod._top_k, moe_mod.dispatch_compute_combine
    routed = []

    def kept_top_k(p, k):
        w, idx = top_k(p, k)
        routed.append((p.detach().reshape(-1, p.shape[-1]).clone(),
                       idx.detach().clone()))
        return w, idx

    def rec(x, idx, w, wi, wo, *, capacity, num_experts, top_k,
            offset=None, tp=None):
        # under expert parallelism ``idx`` is this rank's slice of the
        # call's experts: the keep bits are of its slots
        order, dest, c = moe_mod.plan_slots(idx, capacity=capacity,
                                            num_experts=num_experts,
                                            offset=offset)
        keep = torch.empty_like(dest, dtype=torch.bool)
        keep[order] = dest < num_experts * c
        log.append(routed.pop(0) + (keep.view(idx.shape),))
        return inner(x, idx, w, wi, wo, capacity=capacity,
                     num_experts=num_experts, top_k=top_k, offset=offset,
                     tp=tp)
    with mock.patch.object(moe_mod, "_top_k", kept_top_k), \
            mock.patch.object(moe_mod, "dispatch_compute_combine", rec):
        yield


@contextlib.contextmanager
def forced_routes(torch, log: list):
    """The MoE calls take the experts of ``log`` (``recorded_routes``),
    call by call, with their own probabilities as weights."""
    from unittest import mock
    import repro_torch.models.moe as moe_mod
    queue = [idx for _, idx, _ in log]

    def forced(p, k):
        idx = queue.pop(0)
        w = p.gather(-1, idx)
        return w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9), idx
    with mock.patch.object(moe_mod, "_top_k", forced):
        yield
    check(not queue, f"{len(queue)} recorded routes were not taken")


def route_flips(torch, got: list, want: list, tag: str):
    """Per MoE call, the (token, choice) slots whose expert differs
    between two recorded runs, and the number of tokens routed alike in
    every call; fails unless each flip of the first call is a tie within
    TIE_EPS of ``got``'s probabilities. Returns (flips, alike, the first
    call's largest tie margin)."""
    check(len(got) == len(want), f"{tag}: {len(got)} MoE calls against "
          f"{len(want)}")
    flips, alike = [], None
    for (_, gi, gk), (_, wi, wk) in zip(got, want):
        flips.append(int((gi != wi).sum()))
        same = gi == wi
        if gk.shape == gi.shape:       # not a rank's slice of the slots
            same &= gk == wk
        same = same.all(dim=-1)
        alike = same if alike is None else alike & same
    p, gi, _ = got[0]
    wi = want[0][1]
    diff = (gi != wi).reshape(-1, gi.shape[-1])
    pg = p.gather(-1, gi.reshape(-1, gi.shape[-1]))[diff]
    pw = p.gather(-1, wi.reshape(-1, wi.shape[-1]))[diff]
    margin = float((pg - pw).abs().max()) if diff.any() else 0.0
    check(margin <= TIE_EPS, f"{tag}: a slot of the first MoE layer flipped "
          f"between experts whose probabilities differ by {margin:.3e} "
          f"(> TIE_EPS {TIE_EPS}): not a rounding tie")
    return flips, int(alike.sum()), margin


def moe_prefill_vs_plain(torch, model, cfg, tokens, counters: dict,
                         tag: str):
    """``prefill_vs_plain`` for the moe family (see TIE_EPS): the kernel
    path (its launches, seconds and routing kept), the plain path (its
    routing compared: ``route_flips``), and the plain path on the kernel
    path's routing, whose logits and caches must hold PATH_REL_TOL and
    the first K/V an attention feeds FIRST_REL_TOL["moe"]. Returns
    (launches, seconds, numbers)."""
    for c in counters.values():
        c.reset()
    routes_k, routes_p = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_routes(torch, routes_k):
        logits, cache = model.prefill(tokens)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    check(bool(torch.isfinite(logits).all()),
          f"{tag}: non-finite prefill logits")
    with plain_paths(), recorded_routes(torch, routes_p):
        model.prefill(tokens)
    flips, alike, margin = route_flips(torch, routes_k, routes_p, tag)
    del routes_p
    with plain_paths(), forced_routes(torch, routes_k):
        plain_logits, plain_cache = model.prefill(tokens)
    torch.cuda.synchronize()
    check(all(c.launches == launches[n] for n, c in counters.items()),
          f"{tag}: the plain path launched a kernel")
    errs = {"logits": rel_err(logits, plain_logits)}
    for name, got, want in zip("kv", cache["layers"], plain_cache["layers"]):
        errs[f"{name} cache"] = rel_err(got, want)
    # the first K/V one attention away: after dense0, else MoE layer 1
    j = 0 if "dense0" in cache else 1
    first = max(rel_err(got[j], want[j]) for got, want in
                zip(cache["layers"], plain_cache["layers"]))
    slots = routes_k[0][1].numel()
    dropped = [int((~k).sum()) for _, _, k in routes_k]
    print(f"{tag} prefill kernel vs plain path: {sum(flips)} of "
          f"{slots * len(flips)} (token, choice) slots routed to another "
          f"expert (per MoE layer {flips}; the first layer's within "
          f"{margin:.3e} of a tie, TIE_EPS {TIE_EPS}), {alike} of "
          f"{tokens.numel()} tokens routed alike in every layer; slots "
          f"dropped by the capacity per MoE layer {dropped} of {slots}; "
          f"on the kernel path's routing, max abs err / max abs: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; cache layer {j} k/v {first:.3e}; launches {launches}",
          flush=True)
    for name, e in errs.items():
        check(e <= PATH_REL_TOL, f"{tag}: prefill {name} differs from the "
                                 f"plain path by {e:.3e} of its largest "
                                 f"magnitude (> {PATH_REL_TOL})")
    check(first <= FIRST_REL_TOL["moe"],
          f"{tag}: cache layer {j}'s k/v differ from the plain path by "
          f"{first:.3e} (> {FIRST_REL_TOL['moe']})")
    nums = dict(route_flips=flips, tokens_alike=alike, tie_margin=margin,
                slots=slots, dropped=dropped, first_err=first,
                **{f"{k.replace(' ', '_')}_err": v for k, v in errs.items()})
    return launches, secs, nums


def decode_drops(torch, model, steps: int) -> list:
    """Slots each of ``steps`` decode steps over 4 slots drops, summed
    over the MoE layers (seeded tokens, a zero cache of 512)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    cache = model.init_cache(4, 512)
    out = []
    for _ in range(steps):
        toks = torch.randint(0, model.cfg.vocab_size, (4,), device="cuda",
                             generator=gen)
        log = []
        with recorded_routes(torch, log):
            model.decode_step(toks, cache)
        out.append(sum(int((~k).sum()) for _, _, k in log))
    return out


def op_rows(torch, fn, reps: int, top: int = 12):
    """The operators with the most device time a call of ``fn`` (the
    profiler's CPU-side rows, each with its kernels' device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_device_time_total]
    rows.sort(key=lambda r: -r[1])
    return [(k[:40], round(t / reps / 1e3, 3)) for k, t in rows[:top]]


def phase_train_moe(torch, np, counters: dict):
    """Phase 16: deepseek-moe-16b training at full width, MOE_TRAIN_LAYERS
    deep (dense0 and three MoE layers): one bf16 step on the kernel path
    against the plain path on the kernel path's routing at phase 10's
    limits (the plain path's own routing compared: ``route_flips``), the
    operators of a step, then ``trainer_run``. Returns (launches of the
    Trainer run, numbers)."""
    import gc
    # dense0 once; each MoE layer in the forward and in the recompute
    per_step = {"flash_attention": 2 * MOE_TRAIN_LAYERS - 1,
                "flash_attention_bwd": MOE_TRAIN_LAYERS}
    model, data, batch, opt, tag = train_setup(torch, "deepseek-moe-16b",
                                               MOE_TRAIN_LAYERS)
    routes, routes_p = [], []
    loss_k, grads_k, loss_p, grads_p, launches = step_vs_plain(
        torch, counters, per_step, model, batch, tag, routes)
    n_moe = MOE_TRAIN_LAYERS - 1
    check(len(routes) == 2 * n_moe, f"{tag}: {len(routes)} MoE calls in "
          f"the kernel step, not {2 * n_moe} (forward and recompute)")
    with torch.no_grad(), plain_paths(), recorded_routes(torch, routes_p):
        model.train_loss(batch)
    flips, alike, margin = route_flips(torch, routes[:n_moe], routes_p, tag)
    dropped = [int((~k).sum()) for _, _, k in routes[:n_moe]]
    slots = routes[0][1].numel()
    del routes, routes_p
    g = step_gaps(torch, model, loss_k, grads_k, loss_p, grads_p, opt)
    print(f"{tag}: {flips} of {slots} (token, choice) slots a MoE layer "
          f"routed to another expert by the plain path (the first layer's "
          f"within {margin:.3e} of a tie), {alike} of {MOE_SEQ} tokens "
          f"routed alike in every layer; slots dropped by the capacity "
          f"{dropped} of {slots}", flush=True)
    step_nums = hold_step(g, loss_k, loss_p, tag,
                          "in bfloat16, on the kernel path's routing",
                          launches)
    step_nums.update(route_flips=flips, tokens_alike=alike,
                     tie_margin=margin, dropped=dropped)
    del grads_k, grads_p, g
    gc.collect()
    torch.cuda.empty_cache()
    step_nums["step_ops"] = op_rows(
        torch, lambda: train_step_grads(torch, model, batch), reps=1)
    print(f"{tag} operators (device ms per step): {step_nums['step_ops']}",
          flush=True)
    return trainer_run(torch, np, counters, per_step, model, data, batch,
                       opt, tag, step_nums)


def phase_moe_serve(torch, np, counters: dict):
    """Phase 15: deepseek-moe-16b at full width and depth, then
    llama4-scout at full width, LLAMA4_LAYERS deep: prefill of MOE_SEQ
    tokens against the plain path, profiles, a BatchedServer of 12
    requests on 4 slots, and the slots MOE_DECODE_STEPS decode steps
    drop. Returns ({arch: prefill launches}, numbers)."""
    launches, nums = {}, {}
    for arch, layers in (("deepseek-moe-16b", 0),
                         ("llama4-scout-17b-a16e", LLAMA4_LAYERS)):
        launches[arch], nums[arch] = phase_serve(
            torch, np, arch, MOE_SEQ, counters, layers=layers)
    return launches, nums


# ------------------------------------------------------------ phase 9: K3'

# K3' cases: B, Hq, Hkv, S, T, hd, causal, q_offset, kv_len, dtype. The
# first is qwen3-4b's training shape at 4,096 tokens, the main path's; then
# float32 there, and every head dim, a ragged non-causal S != T, MQA,
# Hq = Hkv, a decode-chunk q_offset, kv_len < T, and phase 10's
# train_with_guard shape (6 heads of 64, 128 tokens). The bfloat16 cases
# after it hit the tensor-core kernels' tile edges (128 keys and 64
# queries a dK/dV tile, 128 queries and 128 keys a dQ tile): S between 64
# and 128 with T no multiple of 128, S = 333 (log-sum-exp rows not 16-byte
# aligned), G = Hq / Hkv = 8, and hd 32 and 64 with kv_len ending mid-tile.
K3B_CASES = [
    (1, 32, 8, 4096, 4096, 128, True, 0, 0, "bfloat16"),
    (1, 32, 8, 4096, 4096, 128, True, 0, 0, "float32"),
    (2, 8, 2, 300, 450, 64, False, 0, 0, "bfloat16"),
    (1, 4, 1, 300, 300, 32, True, 0, 0, "bfloat16"),
    (2, 8, 8, 300, 300, 64, True, 0, 0, "bfloat16"),
    (1, 8, 2, 64, 576, 128, True, 512, 0, "bfloat16"),
    (2, 8, 1, 256, 512, 64, False, 0, 400, "bfloat16"),
    (1, 4, 4, 200, 333, 32, True, 133, 300, "float32"),
    (4, 6, 6, 128, 128, 64, True, 0, 0, "bfloat16"),
    (1, 8, 2, 100, 200, 128, False, 0, 0, "bfloat16"),
    (2, 8, 2, 333, 333, 128, True, 0, 0, "bfloat16"),
    (1, 16, 2, 384, 384, 128, True, 0, 0, "bfloat16"),
    (2, 4, 2, 200, 320, 32, True, 120, 250, "bfloat16"),
    (1, 4, 1, 190, 190, 64, False, 0, 170, "bfloat16"),
    # whisper-small's training (phase 22) at 8 x (1,500 frames, 448
    # tokens): the encoder, the cross attention (S < T, T's last tile
    # partial), the decoder's self attention, and the encoder in float32
    (8, 12, 12, 1500, 1500, 64, False, 0, 0, "bfloat16"),
    (8, 12, 12, 448, 1500, 64, False, 0, 0, "bfloat16"),
    (8, 12, 12, 448, 448, 64, True, 0, 0, "bfloat16"),
    (8, 12, 12, 1500, 1500, 64, False, 0, 0, "float32"),
    # qwen2-vl-72b's training (phase 24): dK/dV summed over a group of 8
    # query heads at 4,096 tokens; timed beside plain and sdpa too; then
    # qwen3-4b's on each rank of phase 25's (1, 4) mesh
    VLM_ATTN,
    TP_ATTN,
    # whisper-small's encoder attention on each rank of phase 25(f)
    TP_AUDIO_ATTN,
]
# the kernels of one call, in launch order: the D pass, then the dK/dV
# and dQ kernels (wgmma in bfloat16, the CUDA cores in float32)
K3B_KERNELS = {"bfloat16": ["fa_bwd_dot", "fa_bwd_dkdv_wgmma",
                            "fa_bwd_dq_wgmma"],
               "float32": ["fa_bwd_dot", "fa_bwd_dkdv", "fa_bwd_dq"]}
# The forward's log-sum-exp (natural units, about log T) against the plain
# forward's, largest absolute difference: both sum exp of the same float32
# scores (bfloat16 inputs are exact in float32), in another order and with
# exp2 in the kernel.
LSE_TOL = 2e-5
# Each gradient's largest |kernel - plain| over its largest magnitude. The
# plain version runs the same equations in float32 from the plain
# forward's o and lse and the same dO: float32 differs by summation order
# only (2.9e-7 measured on an H100, from the kernel's o and lse); the
# bfloat16 kernel rounds P and dS to bfloat16 before their
# products on the tensor cores and writes dq, dk, dv in bfloat16 (up to
# 7.2e-3 measured on an H100; the CPU emulation of that arithmetic in
# tests/test_torch_flash_attention.py stays within 6.9e-3 of the JAX
# package's bfloat16 gradients).
K3B_TOL = {"bfloat16": 2e-2, "float32": 1e-5}


def phase_k3_bwd(torch, np):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_bwd_flops, attention_bwd_ref, attention_ref,
        flash_attention, flash_attention_bwd)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: fp32
    main = None
    for i, case in enumerate(K3B_CASES):
        b, hq, hkv, s, t, hd, causal, qo, kvl, dname = case
        dt, tol = getattr(torch, dname), K3B_TOL[dname]
        rng = np.random.default_rng(300 + i)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to("cuda", dt).transpose(1, 2)
            for shape in ((b, s, hq, hd), (b, t, hkv, hd), (b, t, hkv, hd),
                          (b, s, hq, hd)))
        kw = dict(causal=causal, q_offset=qo, kv_len=kvl)
        o, lse = flash_attention(q, k, v, lse=True, **kw)
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        # the plain backward from the plain forward's o and log-sum-exp:
        # the comparison covers the forward's lse epilogue too
        o_ref, lse_ref = attention_ref(q, k, v, return_lse=True, **kw)
        want = attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        torch.cuda.synchronize()
        tag = (f"K3' flash_attention_bwd B,Hq,Hkv,S,T,hd={b},{hq},{hkv},{s},"
               f"{t},{hd} {'causal' if causal else 'full'}"
               f"{f' q_offset {qo}' if qo else ''}"
               f"{f' kv_len {kvl}' if kvl else ''} {dname}")
        lse_err = max_abs_err(lse, lse_ref)
        check(lse_err <= LSE_TOL, f"{tag}: the forward's log-sum-exp "
              f"differs from plain by {lse_err:.3e} (> {LSE_TOL})")
        del o_ref
        errs = {}
        for n, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[n] = rel_err(g, w)
            check(bool(torch.isfinite(g).all()) and errs[n] <= tol,
                  f"{tag}: {n} differs from plain by {errs[n]:.3e} of its "
                  f"largest magnitude (> {tol})")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{tag}: two calls are not bit-equal")
        err = max(errs.values())
        abs_err = max(max_abs_err(g, w) for g, w in zip(got, want))
        del got, again, want
        names = kernel_basenames(torch, lambda: flash_attention_bwd(
            q, k, v, o, lse, do, **kw))
        check(names == K3B_KERNELS[dname], f"{tag}: one call ran {names}, "
              f"not {K3B_KERNELS[dname]}")
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw),
                     reps=5, warm=1)
        dev_ms = kernel_device_ms(torch, lambda: flash_attention_bwd(
            q, k, v, o, lse, do, **kw), "fa_bwd")
        flops = attention_bwd_flops(b, hq, s, kvl or t, hd, causal=causal,
                                    q_offset=qo)
        nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * \
            q.element_size() + lse.numel() * 4
        peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else FP32_SIMT_FLOPS
        bnd, by = bound(flops, peak, nbytes)
        line = (f"{tag}: forward lse max abs err {lse_err:.3e} (tol "
                f"{LSE_TOL}); max err / max abs " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items()) + f" (tol {tol}), two "
            f"calls bit-equal; kernel {ms:.4f} ms a call ({fmt_ms(dev_ms)} "
            f"on the device, {len(names)} kernels: {', '.join(names)}), "
            f"{flops / ms / 1e9:.2f} TFLOP/s, "
            f"{bnd / ms:.2%} of bound, bound {bnd:.4f} ms ({by}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
        plain = lib = None
        if i < 3 or case in (VLM_ATTN, TP_ATTN, TP_AUDIO_ATTN):  # beside
            plain = time_ms(lambda: attention_bwd_ref(q, k, v, o, lse_ref,
                                                      do, **kw),
                            reps=3, warm=1)
            qq, kk, vv = (x.detach().clone().requires_grad_(True)
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(qq, kk, vv,
                                                 is_causal=causal,
                                                 enable_gqa=True)
            lib = time_ms(lambda: torch.autograd.grad(
                out, (qq, kk, vv), do, retain_graph=True), reps=5, warm=2)
            del out, qq, kk, vv
            line += f"; plain {plain:.4f} ms, sdpa backward {lib:.4f} ms"
        if i == 0:
            split = kernel_split_ms(torch, lambda: flash_attention_bwd(
                q, k, v, o, lse, do, **kw))
            split = {n: split.get(n) for n in names}
            check(None not in split.values(), f"{tag}: the device split "
                  f"{split} lacks a kernel")
            # the dK/dV kernel does four of the five products (S, dP, dV,
            # dK), the dQ kernel three (S, dP, dQ): each against its own
            one = flops / 5 / BF16_TENSOR_FLOPS * 1e3
            own = {names[1]: 4 * one, names[2]: 3 * one}
            line += "; device split " + ", ".join(
                f"{n} {m:.4f} ms" + (
                    f" ({own[n] / m:.1%} of its {own[n]:.4f} ms bound)"
                    if n in own else "")
                for n, m in split.items())
        print(line, flush=True)
        nums = dict(max_abs_err=abs_err, max_rel_err=err, ms=ms,
                    device_ms=dev_ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, library_ms=lib,
                    shape=[b, hq, hkv, s, t, hd],
                    kernels_per_call=len(names))
        if main is None:
            main = nums
        if case == VLM_ATTN:
            main["vlm"] = nums
        if case == TP_ATTN:
            main["tp"] = nums
        if case == TP_AUDIO_ATTN:
            main["tp_audio"] = nums
        del q, k, v, do, o, lse, lse_ref
        torch.cuda.empty_cache()
    return main


# ---------------------------------------------------- phase 10: training

TRAIN_LAYERS = 8           # of qwen3-4b's 36: 16 B a parameter must fit
TRAIN_SEQ = 4096
TRAIN_STEPS = 12
TRAIN_LR = 3e-4            # AdamW's peak learning rate, after 2 warmup steps
# kernel path against plain path, one bf16 step at full width (8 layers):
# the loss within LOSS_REL_TOL of the plain path's, every gradient within
# GRAD_REL_TOL of its largest magnitude (measured on an H100: 7.9e-6 and
# 9.5e-3; the same bf16 rounding flips as in serving, through 8 layers and
# their backward). AdamW's first step from zero moments moves each master
# weight by about lr times the sign of its gradient (|m / (sqrt(v) + eps)|
# <= 1) plus the decay term, which is the same on both paths: so the two
# updates must point the same way. Their cosine must be at least
# UPDATE_COS (measured on an H100: 0.9995; each entry whose update changes
# sign, a gradient near zero, costs it about 2 / n), and at most
# UPDATE_FLIP of the entries may change sign (from the cosine, about
# (1 - 0.9995) / 2 = 2.5e-4 are expected).
LOSS_REL_TOL = 1e-3
GRAD_REL_TOL = 5e-2
UPDATE_COS = 0.99
UPDATE_FLIP = 5e-3


def train_step_grads(torch, model, batch):
    """Loss and a copy of every working-weight gradient of one step."""
    loss, _ = model.train_loss(batch)
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        grads[name] = p.grad
        p.grad = None
    torch.cuda.synchronize()
    return loss.detach(), grads


# entries of a leaf that ``update_agreement`` updates at a time (256 MiB in
# float32)
UPDATE_PIECE = 1 << 26


def update_agreement(torch, model, grads_a, grads_b, opt):
    """One AdamW step from zero moments of ``model``'s float32 master
    weights with each of two gradient sets, compared: (the share of
    entries whose updates differ in sign, the cosine of the two updates,
    the step's lr). It goes a piece of a leaf at a time (rows of at most
    UPDATE_PIECE entries), so that no whole copy of the masters or the
    moments is held (at qwen2-vl-72b's width whole copies would not fit
    beside the two gradient sets): each set is scaled by ``apply_adamw``'s
    own global clip first and the per-piece call's clip is switched off
    (a scale of exactly 1), which leaves every update bit-equal to the
    whole-tree call's (``tests/test_torch_train.py`` holds this on the
    CPU). The gradients may lie on the host; each piece is updated on the
    model's device."""
    import math
    from repro_torch.train import apply_adamw, global_norm, init_opt_state
    from repro_torch.train.trainer import decay_mask
    decay = decay_mask(model)
    dev = next(model.parameters()).device
    unclipped = dataclasses.replace(opt, grad_clip=math.inf)
    scales = [torch.clamp(opt.grad_clip / torch.clamp(
        global_norm({n: g.to(dev) for n, g in grads.items()}), min=1e-9),
        max=1.0) for grads in (grads_a, grads_b)]
    flips, total, dot, na, nb = 0, 0, 0.0, 0.0, 0.0
    for name, p in model.named_parameters():
        rows = max(1, UPDATE_PIECE // (p[0].numel() if p.dim() > 1 else 1))
        pieces = zip(p.detach().split(rows), grads_a[name].split(rows),
                     grads_b[name].split(rows))
        for w, ga, gb in pieces:
            master = w.float()
            ups = []
            for g, scale in ((ga, scales[0]), (gb, scales[1])):
                new = {name: master.clone()}
                _, _, metrics = apply_adamw(
                    new, {name: g.to(dev).float() * scale},
                    init_opt_state(new), unclipped, {name: decay[name]})
                ups.append((new[name] - master).double())
            ua, ub = ups
            flips += int((ua.sign() != ub.sign()).sum())
            total += ua.numel()
            dot += float((ua * ub).sum())
            na += float(ua.square().sum())
            nb += float(ub.square().sum())
    return (flips / total, dot / max((na * nb) ** 0.5, 1e-300),
            float(metrics["lr"]))


class WithFrames:
    """A ``SyntheticLM`` whose batches also carry the audio family's
    encoder input, ``enc_frames`` (B, T, D): standard normal float32 frames
    of the whole batch, drawn with numpy from (``seed``, step) and sliced
    for the shard as the tokens are (the port's data pipeline makes no
    frames)."""

    def __init__(self, data, frames: int, d_model: int, seed: int = 0):
        self.data, self.cfg = data, data.cfg
        self.shape, self.seed = (frames, d_model), seed

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        import numpy as np
        batch = self.data.batch_at(step, shard, num_shards)
        rows = self.cfg.global_batch // num_shards
        rng = np.random.default_rng((self.seed, step))
        frames = rng.standard_normal((self.cfg.global_batch,) + self.shape,
                                     dtype=np.float32)
        batch["enc_frames"] = frames[shard * rows:(shard + 1) * rows]
        return batch


# the vlm family's image (phases 23 and 24): 16 x 16 merged patches, the
# reference's P = min(256, S) patch rows at 4,096 tokens
VLM_GRID = (16, 16)


def qwen2vl_positions(np, batch: int, seq: int, grid):
    """(3, batch, seq) int32 M-RoPE positions in Qwen2-VL's layout
    (arXiv:2409.12191, section 2.1): one image of gh x gw merged patches
    at the front, patch (i, j) at (temporal 0, height i, width j), then
    the text at max + 1, max + 2, ... on all three streams (at a 16 x 16
    grid the text starts at 16). The port takes positions from its
    caller, as the reference does; ``tests/torch_dist_workers.py`` holds
    the same layout for the CPU tests."""
    gh, gw = grid
    P = gh * gw
    if P > seq:
        raise ValueError(f"an image of {P} patches in {seq} tokens")
    i, j = np.divmod(np.arange(P), gw)
    image = np.stack([np.zeros(P, np.int64), i, j])
    start = max(gh, gw)
    text = np.broadcast_to(np.arange(start, start + seq - P), (3, seq - P))
    pos = np.concatenate([image, text], axis=1).astype(np.int32)
    return np.repeat(pos[:, None], batch, axis=1)


def vlm_image(torch, np, patches, seq: int) -> dict:
    """``prefill``'s vlm inputs for sequences of ``seq`` tokens that open
    with a VLM_GRID image: its ``patches`` (B, P, D) on the card, and the
    ``positions`` (3, B, seq) of Qwen2-VL's layout."""
    return {"patch_embeds": patches,
            "positions": torch.from_numpy(qwen2vl_positions(
                np, patches.shape[0], seq, VLM_GRID)).cuda()}


class WithPatches:
    """A ``SyntheticLM`` whose batches also carry the vlm family's stub
    vision input: ``patch_embeds`` (B, P, D), standard normal float32 rows
    of the whole batch drawn with numpy from (``seed``, step) and sliced
    on axis 0 for the shard, and ``positions`` (3, B, S) in Qwen2-VL's
    layout for a VLM_GRID image, sliced on axis 1 (the twin of
    ``tests/torch_dist_workers.WithPatches``)."""

    def __init__(self, data, d_model: int, seed: int = 0):
        self.data, self.cfg = data, data.cfg
        self.d_model, self.seed = d_model, seed

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        import numpy as np
        batch = self.data.batch_at(step, shard, num_shards)
        B, S = self.cfg.global_batch, self.cfg.seq_len
        rows = slice(shard * B // num_shards, (shard + 1) * B // num_shards)
        rng = np.random.default_rng((self.seed, step))
        P = VLM_GRID[0] * VLM_GRID[1]
        patches = rng.standard_normal((B, P, self.d_model), dtype=np.float32)
        batch["patch_embeds"] = patches[rows]
        batch["positions"] = qwen2vl_positions(np, B, S, VLM_GRID)[:, rows]
        return batch


def train_setup(torch, arch: str, layers: int, seq: int = TRAIN_SEQ,
                batch: int = 1, peak_lr: float = TRAIN_LR):
    """``arch`` at its published widths, ``layers`` deep, seeded weights,
    remat "full", and ``batch`` ``SyntheticLM`` sequences of ``seq``
    tokens a step (the audio family's with ``WithFrames``' encoder frames,
    the vlm family's with ``WithPatches``' image) -> (model, data, batch,
    AdamW config, tag)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.train import AdamWConfig, DataConfig, SyntheticLM
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0, remat="full")
    for p in model.parameters():
        p.requires_grad_(True)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch, seed=0))
    if cfg.is_encoder_decoder:
        data = WithFrames(data, cfg.encoder_seq_len, cfg.d_model)
    if cfg.mrope_sections:
        data = WithPatches(data, cfg.d_model)
    opt = AdamWConfig(peak_lr=peak_lr, warmup_steps=2,
                      total_steps=TRAIN_STEPS)
    tag = f"{arch} train ({layers} layers, {batch} x {seq} tokens)"
    print(f"{tag}: {n_params / 1e9:.3f} B parameters, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return model, data, data.batch_at(0), opt, tag


def step_vs_plain(torch, counters: dict, per_step: dict, model, batch,
                  tag: str, routes: list = None):
    """One step of ``model`` on the kernel path, then on the plain path.
    Fails unless the kernel path launched each kernel ``per_step`` times
    and the plain path none, and the loss and gradients are finite. With
    ``routes`` (the moe family), the kernel step's routing is recorded
    there and the plain step takes it (``forced_routes``). Returns
    (loss_k, grads_k, loss_p, grads_p, launches)."""
    moe = routes is not None
    for c in counters.values():
        c.reset()
    with recorded_routes(torch, routes) if moe else contextlib.nullcontext():
        loss_k, grads_k = train_step_grads(torch, model, batch)
    launches = {n: c.launches for n, c in counters.items()}
    check(launches == {n: per_step.get(n, 0) for n in counters},
          f"{tag}: a kernel-path step launched {launches}, not {per_step} "
          f"(forward and remat, one backward a layer)")
    with plain_paths(), \
            forced_routes(torch, routes) if moe else contextlib.nullcontext():
        loss_p, grads_p = train_step_grads(torch, model, batch)
    check(all(c.launches == launches[n] for n, c in counters.items()),
          f"{tag}: the plain path launched a kernel")
    check(bool(torch.isfinite(loss_k)), f"{tag}: non-finite loss")
    check(all(bool(torch.isfinite(g).all()) for g in grads_k.values()),
          f"{tag}: non-finite gradients")
    return loss_k, grads_k, loss_p, grads_p, launches


def step_gaps(torch, model, loss_a, grads_a, loss_b, grads_b, opt):
    """How far step a is from step b on ``model``'s weights: the loss's
    relative gap, each gradient's largest |a - b| over its largest |b|,
    and one AdamW update from zero moments of each (the share of entries
    whose update changes sign, the cosine)."""
    loss_err = abs(float(loss_a) - float(loss_b)) / abs(float(loss_b))
    gerr = {n: rel_err(grads_a[n].cuda(), grads_b[n].cuda())
            for n in grads_a}
    flip, cos, lr1 = update_agreement(torch, model, grads_a, grads_b, opt)
    worst = max(gerr, key=gerr.get)
    return dict(loss_err=loss_err, grad_err=gerr[worst], worst=worst,
                update_cos=cos, update_flip=flip, lr=lr1, gaps=gerr)


def hold_step(g: dict, loss_k, loss_p, tag: str, what: str,
              launches: dict, pair: str = "kernel vs plain path") -> dict:
    """Phase 10's limits on ``step_gaps`` of the kernel path against the
    plain path (or the ``pair`` the caller names); prints them. Returns
    the numbers."""
    check(g["loss_err"] <= LOSS_REL_TOL, f"{tag}: loss {float(loss_k)} vs "
          f"plain {float(loss_p)} ({g['loss_err']:.3e})")
    check(g["grad_err"] <= GRAD_REL_TOL,
          f"{tag}: gradient {g['worst']} differs from the plain path by "
          f"{g['grad_err']:.3e} of its largest magnitude")
    check(g["update_cos"] >= UPDATE_COS and g["update_flip"] <= UPDATE_FLIP,
          f"{tag}: AdamW updates' cosine {g['update_cos']:.5f} (< "
          f"{UPDATE_COS}?) or share of entries whose update changes sign "
          f"{g['update_flip']:.3e} (> {UPDATE_FLIP}?)")
    print(f"{tag} step {what}, {pair}: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f} ({g['loss_err']:.3e});"
          f" gradients within {g['grad_err']:.3e} of their largest magnitude "
          f"(worst {g['worst']}); AdamW updates (lr {g['lr']:.3e}): cosine "
          f"{g['update_cos']:.6f} (limit {UPDATE_COS}), {g['update_flip']:.3e}"
          f" of entries change sign (limit {UPDATE_FLIP}); launches "
          f"{launches}", flush=True)
    return {k: v for k, v in g.items() if k not in ("gaps", "lr")}


def later_steps_vs_plain(torch, counters: dict, per_step: dict, model,
                         data, opt, tag: str, steps: int) -> list:
    """Steps 2 .. 1 + ``steps`` of a ``Trainer`` of ``model``, each held
    kernel path against plain path to phase 10's limits (``step_vs_plain``,
    ``hold_step``) from the Trainer's state before it. The Trainer takes
    its steps first; the working weights it leaves before each held step
    wait on the host, and the held steps run after the Trainer is gone,
    at the first step's memory (at qwen2-vl-72b's width the plain path's
    step does not fit beside the Trainer's masters and moments). Leaves
    ``model`` at the last state held. Returns each held step's numbers,
    its losses on both paths among them."""
    import gc
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.trainer import load_working
    trainer = Trainer(model, data, TrainConfig(steps=TRAIN_STEPS,
                                               ckpt_interval=10 ** 9,
                                               opt=opt))
    states = []
    for step in range(1, 1 + steps):
        trainer.params, trainer.opt_state, _ = trainer._step_fn(
            trainer.params, trainer.opt_state, data.batch_at(step - 1))
        load_working(model, trainer.params)
        states.append({n: p.detach().to("cpu")
                       for n, p in model.named_parameters()})
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    held = []
    for step, state in enumerate(states, 2):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(state[n])
        loss_k, grads_k, loss_p, grads_p, launches = step_vs_plain(
            torch, counters, per_step, model, data.batch_at(step - 1), tag)
        g = step_gaps(torch, model, loss_k, grads_k, loss_p, grads_p, opt)
        nums = hold_step(g, loss_k, loss_p, tag, f"{step} of a Trainer",
                         launches)
        held.append(dict(nums, step=step, loss_kernel=float(loss_k),
                         loss_plain=float(loss_p)))
        del grads_k, grads_p, g
        gc.collect()
        torch.cuda.empty_cache()
    return held


def train_full_width(torch, np, counters: dict, arch: str, layers: int,
                     per_step: dict, peak_lr: float = TRAIN_LR,
                     later: int = 0):
    """(a) one bf16 step of ``arch`` (``train_setup``) on the kernel path
    against the plain path, held to phase 10's limits, and the ``later``
    steps after it (``later_steps_vs_plain``); (b) ``trainer_run`` at
    ``peak_lr``.
    ``per_step`` is each kernel's launches in one step. Returns (launches
    of the Trainer run, numbers)."""
    import gc
    model, data, batch, opt, tag = train_setup(torch, arch, layers,
                                               peak_lr=peak_lr)
    loss_k, grads_k, loss_p, grads_p, launches = step_vs_plain(
        torch, counters, per_step, model, batch, tag)
    g = step_gaps(torch, model, loss_k, grads_k, loss_p, grads_p, opt)
    step_nums = hold_step(g, loss_k, loss_p, tag, "in bfloat16", launches)
    del grads_k, grads_p, g
    gc.collect()
    torch.cuda.empty_cache()
    if later:
        step_nums["later_steps"] = later_steps_vs_plain(
            torch, counters, per_step, model, data, opt, tag, later)
        del model
        gc.collect()
        # the same seeded weights again for the Trainer run
        model, data, batch, opt, tag = train_setup(torch, arch, layers,
                                                   peak_lr=peak_lr)
    return trainer_run(torch, np, counters, per_step, model, data, batch,
                       opt, tag, step_nums)


def trainer_run(torch, np, counters: dict, per_step: dict, model, data,
                batch, opt, tag: str, step_nums: dict):
    """A ``Trainer`` of TRAIN_STEPS bf16 steps of ``model`` with a
    ``GuardStepHook`` on the card. Returns (its launches, numbers)."""
    import gc
    from repro_torch.guard import GuardStepHook
    from repro_torch.train import TrainConfig, Trainer
    # no durable checkpoint (a save at this size is ~25 GB: fp32 master
    # weights and two moments)
    n_params = sum(p.numel() for p in model.parameters())
    hook = GuardStepHook(window_steps=4, device="cuda")
    model_gb = torch.cuda.memory_allocated() / 1e9
    trainer = Trainer(model, data, TrainConfig(steps=TRAIN_STEPS,
                                               ckpt_interval=10 ** 9,
                                               opt=opt), hook=hook)
    init_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    out = trainer.run()
    launches = {n: c.launches for n, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # what stays between steps: working weights, fp32 master, two moments
    state_gb = torch.cuda.memory_allocated() / 1e9
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    walls = [h["wall_s"] for h in hist]
    check(out["final_step"] == TRAIN_STEPS and len(hist) == TRAIN_STEPS,
          f"{tag}: trainer stopped at {out['final_step']}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{tag}: losses {losses} not finite and falling")
    want = {n: per_step.get(n, 0) * TRAIN_STEPS for n in counters}
    want["fleet_score"] = hook.frames_fed
    check(hook.frames_fed >= 1 and launches == want,
          f"{tag}: the Trainer run launched {launches}, expected {want}")
    step_ms = float(np.median(walls[1:])) * 1e3
    s_wall, s_busy, s_top = device_profile(
        torch, lambda: trainer._step_fn(trainer.params, trainer.opt_state,
                                        batch), reps=2)
    tokens = data.cfg.global_batch * data.cfg.seq_len
    nums = dict(params=n_params, step_ms=step_ms, first_step_s=walls[0],
                **step_nums,
                tok_per_s=tokens / (step_ms / 1e3), peak_gb=peak_gb,
                state_gb=state_gb, model_gb=model_gb, trainer_gb=init_gb,
                busy_ms=s_busy, profiled_step_ms=s_wall,
                losses=[round(x, 4) for x in losses],
                frames=hook.frames_fed)
    print(f"{tag}, Trainer + GuardStepHook on the card: {TRAIN_STEPS} steps, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; step median "
          f"{step_ms:.1f} ms (first {walls[0] * 1e3:.0f} ms), "
          f"{nums['tok_per_s']:.0f} tokens/s; peak memory {peak_gb:.2f} GB "
          f"({state_gb:.2f} GB held between steps; {model_gb:.2f} GB before "
          f"the Trainer, {init_gb:.2f} GB after its master weights and "
          f"moments); "
          f"launches per step: " + ", ".join(
              f"{n} {launches[n] / TRAIN_STEPS:.0f}" for n in per_step)
          + f"; fleet_score {launches['fleet_score']} in {hook.frames_fed} Guard "
          f"windows; profiled step {s_wall:.1f} ms wall, card busy "
          f"{s_busy:.1f} ms ({s_busy / s_wall:.0%}); top kernels (ms per "
          f"step): {s_top}", flush=True)
    del trainer, model, hook
    gc.collect()
    torch.cuda.empty_cache()
    return launches, nums


def phase_train(torch, np, counters: dict):
    """Phase 10: qwen3-4b training at full width, then the train_with_guard
    scenario. Returns (launches of the Trainer run, numbers)."""
    import gc
    import tempfile
    from repro_torch.configs import get_config, reduced
    from repro_torch.guard import (GuardStepHook, NodeSwapped, RecoveryEvent,
                                   StragglerFlagged)
    from repro_torch.models.model import Model
    from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                                   TieredCheckpointManager, TrainConfig,
                                   Trainer)
    launches, nums = train_full_width(
        torch, np, counters, "qwen3-4b", TRAIN_LAYERS,
        {"flash_attention": 2 * TRAIN_LAYERS,
         "flash_attention_bwd": TRAIN_LAYERS})

    # (c) examples/train_with_guard.py at that example's reduced size
    steps = 200
    small = reduced(get_config("phi3-mini-3.8b"), num_layers=6, d_model=384,
                    num_heads=6, num_kv_heads=6, d_ff=1024, head_dim=64,
                    vocab_size=4096)
    model = Model(small, device="cuda", seed=0)
    data = SyntheticLM(DataConfig(small.vocab_size, seq_len=128,
                                  global_batch=4))
    window, stall_at, stall_steps = 4, steps // 2, 4
    hook = GuardStepHook(window_steps=window, n_peers=15, device="cuda")
    hook.inject_stall(at_step=stall_at, factor=8.0, steps=stall_steps)
    swaps, recoveries, flags = [], [], []
    hook.session.bus.subscribe(NodeSwapped, swaps.append)
    hook.session.bus.subscribe(RecoveryEvent, recoveries.append)
    hook.session.bus.subscribe(StragglerFlagged, flags.append)
    tmp = tempfile.TemporaryDirectory(prefix="train_with_guard_")
    ckpt = TieredCheckpointManager(tmp.name, node_id=hook.node_id,
                                   fast_interval_s=5.0)
    hook.bind_checkpoint(ckpt)
    trainer = Trainer(model, data, TrainConfig(
        steps=steps, ckpt_interval=50,
        opt=AdamWConfig(peak_lr=6e-4, warmup_steps=20, total_steps=steps)),
        ckpt=ckpt, hook=hook)
    t0 = time.perf_counter()
    out = trainer.run()
    secs = time.perf_counter() - t0
    losses = [h["loss"] for h in out["history"]]
    walls = np.array([h["wall_s"] for h in out["history"]]) * 1e3
    tier = [(e.ckpt_tier, e.hot_spare, e.step, e.replay_steps)
            for e in recoveries]
    # the step at which Guard asked for each restart: a recovery restores
    # to e.step and replays the steps up to it
    restart_steps = [e.step + e.replay_steps for e in recoveries]
    # A scored window of `window` consecutive steps that ends at step r
    # holds a stalled step, inflated 8-fold, when stall_at <= r <=
    # stall_at + stall_steps + window - 2. Guard must restart the host at
    # the end of such a window (an immediate-restart flag from the
    # detector at that step, not a deferred swap landing at a checkpoint),
    # onto a hot spare from the peer tier. The host's own spread on the
    # card brings restarts elsewhere in the run too; they are printed.
    scored = range(stall_at, stall_at + stall_steps + window - 1)
    immediate = {e.step for e in flags if e.action == "immediate_restart"}
    stall_flags = [(e.step, e.action, e.reason) for e in flags
                   if e.step in scored]
    stall_restarts = [e for e in recoveries
                      if e.step + e.replay_steps in scored
                      and e.step + e.replay_steps in immediate]
    check(out["final_step"] == steps,
          f"train_with_guard: final step {out['final_step']}")
    check(any(e.hot_spare and e.ckpt_tier == "peer"
              for e in stall_restarts),
          f"train_with_guard: no immediate restart onto a hot spare from "
          f"the peer tier at the end of a window holding the stall (steps "
          f"{scored.start}-{scored.stop - 1}); restarts at {restart_steps}, "
          f"recoveries {tier}, flags there {stall_flags}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "train_with_guard: loss not finite and falling")
    print(f"train_with_guard ({small.name} reduced, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"parameters, bf16, on the card): {out['final_step']} steps in "
          f"{secs:.1f} s, loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"{hook.frames_fed} Guard windows, {hook.restarts_requested} "
          f"restart(s) at steps {restart_steps}; flags in steps "
          f"{scored.start}-{scored.stop - 1} (stall at {stall_at}-"
          f"{stall_at + stall_steps - 1}): {stall_flags}; swaps "
          f"{[(e.old, e.new) for e in swaps]}, recoveries "
          f"(tier, hot spare, restored step, replayed) {tier}; "
          f"{ckpt.snapshots_taken} fast snapshots; measured step ms p10 / "
          f"p50 / p90 / max {np.percentile(walls, 10):.1f} / "
          f"{np.median(walls):.1f} / {np.percentile(walls, 90):.1f} / "
          f"{walls.max():.1f} (the hook's synthetic peers jitter 1 %)",
          flush=True)
    ckpt.wait()
    tmp.cleanup()
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, nums


# ------------------------------------------ phase 14: training under a mesh

MESH_CHECK_STEP = 2        # the state compared with the unsharded steps'


def train_state(torch, params, opt_state) -> dict:
    """Host copies of a trainer's master weights and moments (DTensors in
    full), keyed "p/<name>", "mu/<name>", "nu/<name>"."""
    from torch.distributed.tensor import DTensor

    def host(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).cpu()
    out = {f"p/{k}": host(v) for k, v in params.items()}
    for m in ("mu", "nu"):
        out.update({f"{m}/{k}": host(v) for k, v in opt_state[m].items()})
    return out


def norm_orders_differ(torch, model) -> list:
    """The parameter shapes of ``model`` at which the float32 norm of a
    seeded bfloat16 tensor differs from the norm of its float32 widening.
    The unsharded step's clip reads bfloat16 gradients and the mesh step's
    float32 ones: their bit-equality rests on there being none."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    differ = []
    for shape in sorted({tuple(p.shape) for p in model.parameters()}):
        x = (torch.randn(shape, device="cuda", generator=gen) * 1e-3).to(
            torch.bfloat16)
        if not torch.equal(
                torch.linalg.vector_norm(x, dtype=torch.float32),
                torch.linalg.vector_norm(x.float(), dtype=torch.float32)):
            differ.append(shape)
    return differ


def phase_train_mesh(torch, np, counters: dict, tnums: dict, card: str):
    """Phase 14: phase 10's qwen3-4b cell, two steps without a mesh, then
    TRAIN_STEPS under a one-rank NCCL mesh, the state after
    MESH_CHECK_STEP steps held bit-equal. Returns (launches of the mesh
    run, numbers)."""
    import gc
    import os
    import tempfile
    import torch.distributed as tdist
    from repro_torch.dist import api as dist
    from repro_torch.guard import GuardStepHook
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import TrainConfig, Trainer
    per_step = {"flash_attention": 2 * TRAIN_LAYERS,
                "flash_attention_bwd": TRAIN_LAYERS}
    # (a) the unsharded steps
    model, data, _, opt, tag = train_setup(torch, "qwen3-4b", TRAIN_LAYERS)
    differ = norm_orders_differ(torch, model)
    check(not differ, f"{tag}: the float32 norms of a bfloat16 tensor and "
          f"of its float32 widening differ at shapes {differ}")
    trainer = Trainer(model, data, TrainConfig(
        steps=MESH_CHECK_STEP, ckpt_interval=10 ** 9, opt=opt))
    plain_hist = trainer.run()["history"]
    want = train_state(torch, trainer.params, trainer.opt_state)
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the same cell under a one-rank mesh
    tmp = tempfile.TemporaryDirectory(prefix="mesh_store_")
    tdist.init_process_group(
        "nccl", store=tdist.FileStore(os.path.join(tmp.name, "store"), 1),
        rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        model, data, _, opt, tag = train_setup(torch, "qwen3-4b",
                                               TRAIN_LAYERS)
        tag += " under a one-rank NCCL mesh"
        mesh = make_mesh("cuda")
        held = {}

        def hold(step, metrics):
            if step != MESH_CHECK_STEP:
                return
            got = train_state(torch, trainer.params, trainer.opt_state)
            held["differ"] = sorted(k for k in want
                                    if not torch.equal(got[k], want[k]))
            held["leaves"] = len(want)
            del got
        with dist.use_mesh(mesh) as ctx:
            hook = GuardStepHook(window_steps=4, device="cuda")
            trainer = Trainer(model, data, TrainConfig(
                steps=TRAIN_STEPS, ckpt_interval=10 ** 9, opt=opt),
                hook=hook)
            sharding = dist.param_sharding(model.param_axes(),
                                           trainer.params, ctx)
            check(all(list(trainer.params[n].placements) == sharding[n] and
                      list(trainer.opt_state[m][n].placements) == sharding[n]
                      for n in sharding for m in ("mu", "nu")),
                  f"{tag}: master or moment placements differ from "
                  f"param_sharding's")
            torch.cuda.reset_peak_memory_stats()
            for c in counters.values():
                c.reset()
            out = trainer.run(on_metrics=hold)
            launches = {n: c.launches for n, c in counters.items()}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            state_gb = torch.cuda.memory_allocated() / 1e9
        hist = out["history"]
        check(out["final_step"] == TRAIN_STEPS,
              f"{tag}: trainer stopped at {out['final_step']}")
        check([h["loss"] for h in hist[:MESH_CHECK_STEP]] ==
              [h["loss"] for h in plain_hist],
              f"{tag}: losses {[h['loss'] for h in hist[:MESH_CHECK_STEP]]}"
              f" are not the unsharded steps' "
              f"{[h['loss'] for h in plain_hist]}")
        check(held.get("differ") == [],
              f"{tag}: after {MESH_CHECK_STEP} steps these of "
              f"{held.get('leaves')} master weights and moments differ from "
              f"the unsharded steps': {held.get('differ', 'not held')[:8]}")
        want_l = {n: per_step.get(n, 0) * TRAIN_STEPS for n in counters}
        want_l["fleet_score"] = hook.frames_fed
        check(launches == want_l,
              f"{tag}: the Trainer run launched {launches}, expected "
              f"{want_l}")
        losses = [h["loss"] for h in hist]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{tag}: losses {losses} not finite and falling")
        walls = [h["wall_s"] for h in hist]
        step_ms = float(np.median(walls[1:])) * 1e3
        batch = data.batch_at(0, *trainer.batch_shard)
        s_wall, s_busy, s_top = device_profile(
            torch, lambda: trainer._step_fn(trainer.params, trainer.opt_state,
                                            batch), reps=2)
        nums = dict(step_ms=step_ms, first_step_s=walls[0],
                    tok_per_s=TRAIN_SEQ / (step_ms / 1e3), peak_gb=peak_gb,
                    state_gb=state_gb, leaves_bit_equal=held["leaves"],
                    busy_ms=s_busy, profiled_step_ms=s_wall,
                    losses=[round(x, 4) for x in losses],
                    frames=hook.frames_fed)
        print(f"{tag} ({card}): float32 norms of bfloat16 tensors and of "
              f"their widening equal at every parameter shape; after "
              f"{MESH_CHECK_STEP} steps the loss and "
              f"all {held['leaves']} master weights and moments bit-equal to "
              f"the unsharded steps'; placements param_sharding's; "
              f"{TRAIN_STEPS} steps, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; step median {step_ms:.1f} ms (phase 10: "
              f"{tnums['step_ms']:.1f}), {nums['tok_per_s']:.0f} tokens/s "
              f"(phase 10: {tnums['tok_per_s']:.0f}); peak memory "
              f"{peak_gb:.2f} GB (phase 10: {tnums['peak_gb']:.2f}), "
              f"{state_gb:.2f} GB held between steps (phase 10: "
              f"{tnums['state_gb']:.2f}); launches per step: " + ", ".join(
                  f"{n} {launches[n] / TRAIN_STEPS:.0f}" for n in per_step)
              + f"; fleet_score {launches['fleet_score']} in "
              f"{hook.frames_fed} Guard windows; profiled step {s_wall:.1f} "
              f"ms wall, card busy {s_busy:.1f} ms ({s_busy / s_wall:.0%}; "
              f"phase 10: {tnums['busy_ms'] / tnums['profiled_step_ms']:.0%})"
              f"; top kernels (ms per step): {s_top}", flush=True)
        del trainer, model, hook, want
    finally:
        tdist.destroy_process_group()
        tmp.cleanup()
    gc.collect()
    torch.cuda.empty_cache()
    return launches, nums


# ------------------------------------ phase 11: attribution and simulation

SIM_NODES = 16_384         # bench_diagnose's scenarios placed at fleet size
SIM_SPARES = 512
SIM_HOURS = 2.0
SIM_SEED = 7
TIMING_NODES = (16_384, 131_072)   # 131,072 reaches K1's streamed path
TIMING_WINDOWS = 30
# benchmarks/bench_diagnose.py's rule: a verdict that accuses the node
# itself is true when the node had one of these faults active within
# 120 s of the verdict, false otherwise
CULPRIT_CAUSES = ("compute_degraded", "comm_degraded", "data_stall")
PERF_KINDS = ("thermal", "power", "mem_ecc", "nic_down", "nic_degraded",
              "host_cpu", "congestion")


def quiet_rates(sim):
    return sim.FaultRates(thermal=0, power=0, mem_ecc=0, nic_down=0,
                          nic_degraded=0, host_cpu=0, congestion=0,
                          fail_stop=0, admission_grey_p=0)


def bench_workload(sim, name: str):
    """bench_diagnose's and bench_hang's comm-heavier step split."""
    return sim.WorkloadProfile(name=name, compute_s=6.0, comm_exposed_s=2.5,
                               host_s=1.5)


def attribution_config(sim, device: str):
    """(a): bench_diagnose's three scenarios inside a 16,384-node fleet."""
    return sim.RunConfig(
        tier=sim.Tier.ENHANCED, n_nodes=SIM_NODES, n_spare=SIM_SPARES,
        duration_h=SIM_HOURS, dp_group_size=16, diagnose=True,
        hang_watchdog=True, workload=bench_workload(sim, "diagnose_bench"),
        rates=quiet_rates(sim), initial_grey_p=0.0, seed=SIM_SEED,
        device=device, scenarios=(
            sim.RackThermal(at_h=0.5, rack_size=8, rack_start=24,
                            severity=0.85, power_fraction=0.0),
            sim.SwitchFailure(at_h=0.8, group_size=16, group_start=4096,
                              down_fraction=0.25, severity=0.9),
            sim.CongestionStorm(at_h=0.4, duration_h=0.8, hit_fraction=0.2,
                                severity=0.7)))


def hang_configs(sim, device: str) -> dict:
    """(b): bench_hang's quick suite, from the port's scenario registry."""
    base = dict(tier=sim.Tier.ENHANCED, n_nodes=64, n_spare=10,
                duration_h=3.0, dp_group_size=16, diagnose=True,
                hang_watchdog=True, workload=bench_workload(sim, "hang_bench"),
                rates=quiet_rates(sim), initial_grey_p=0.0, seed=11,
                device=device)
    fields = {"deadlocked_collective": dict(at_h=1.0, count=2,
                                            interval_h=0.75),
              "partial_nic_brownout": dict(at_h=1.0, group_size=8),
              "straggler_timeout_cascade": dict(at_h=1.0, count=2,
                                                interval_h=0.75)}
    return {name: sim.RunConfig(scenarios=(sim.scenario(name, **kw),),
                                **base) for name, kw in fields.items()}


def active_fault(log, node: int, t: float, kinds, slack_s: float) -> bool:
    for f in log:
        if f["node"] != node or f["kind"] not in kinds:
            continue
        cleared = f["t_cleared"]
        if f["t_start"] - slack_s <= t and \
                (cleared is None or t <= cleared + slack_s):
            return True
    return False


def score_accusations(result):
    """(true, false) culprit accusations of a run, by bench_diagnose's
    ``score_run`` rule."""
    tp = fp = 0
    for e in result.events:
        if e["kind"] == "diagnosis" and e["root_cause"] in CULPRIT_CAUSES:
            if active_fault(result.fault_log, e["node_id"], e["t"],
                            PERF_KINDS, 120.0):
                tp += 1
            else:
                fp += 1
    return tp, fp


def differing_fields(a, b) -> list:
    """Names of the ``RunResult`` fields in which two runs differ."""
    import numpy as np
    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            same = np.array_equal(x, y, equal_nan=True)
        elif isinstance(x, float) and x != x:
            same = y != y
        else:
            same = x == y
        if not same:
            out.append(f.name)
    return out


@contextlib.contextmanager
def counting_observe():
    """Counts the windows every ``GuardSession`` observes meanwhile."""
    from repro_torch.guard import GuardSession
    seen = [0]
    observe = GuardSession.observe

    def counted(self, frame):
        seen[0] += 1
        return observe(self, frame)

    GuardSession.observe = counted
    try:
        yield seen
    finally:
        GuardSession.observe = observe


def run_on_card(torch, counters: dict, fn):
    """``fn()`` on the card with every count at 0; returns its result,
    seconds, windows observed and launches."""
    for c in counters.values():
        c.reset()
    with counting_observe() as seen:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return out, secs, seen[0], {n: c.launches for n, c in counters.items()}


def only_k1(launches: dict, windows: int) -> bool:
    return launches == {n: (windows if n == "fleet_score" else 0)
                        for n in launches}


def drive_hook(hook, n_steps: int = 72, ckpt_every: int = 10) -> list:
    """(c): the trainer's side of the step-hook protocol on seeded step
    walls (hardware telemetry every third step, a rewind on each restart
    the hook asks for); returns every answer the hook gave."""
    import numpy as np
    rng = np.random.RandomState(11)
    answers, step = [], 0
    while step < n_steps:
        step += 1
        wall = 0.5 * (1.0 + 0.004 * rng.standard_normal())
        metrics = {"loss": 2.0}
        if step % 3 == 0:
            metrics.update(gpu_temp=61.0 + rng.rand(), nic_errors=0.0,
                           gpu_power=300.0 + rng.rand())
        if step % ckpt_every == 0:
            hook.on_checkpoint(step)
        restart = hook(step, wall, metrics)
        answers.append((step, restart))
        if restart:
            back = (step // ckpt_every) * ckpt_every
            hook.on_restart(back)
            step = back
    return answers


def time_window(torch, np, sim, n: int, counters: dict) -> dict:
    """(d): ``session.observe`` fed by ``SimCluster`` with a ``Diagnoser``
    for ``TIMING_WINDOWS`` windows at ``n`` nodes, split into the
    detector's update (frame staging, K1 and the flagged rows' host copy),
    ``Diagnoser.diagnose`` and the rest (policy and manager); the feed is
    ``run_window`` + ``collect``."""
    from repro_torch.diagnose import Diagnoser, TimingTrace, Topology
    from repro_torch.guard import GuardSession, Tier
    topo = Topology.grouped(n, 16)
    cluster = sim.SimCluster(n, n_spare=64, rates=quiet_rates(sim),
                             topology=topo, seed=SIM_SEED,
                             workload=bench_workload(sim, "diagnose_bench"))
    trace = TimingTrace(depth=8)
    cluster.attach_timing(trace)
    diag = Diagnoser(trace, topo)
    session = GuardSession.from_tier(Tier.ENHANCED, control=cluster,
                                     sweep_backend=cluster, diagnoser=diag,
                                     device="cuda")
    session.register_active(cluster.active)
    session.register_spares(cluster.spares)
    sim.arm_all([sim.RackThermal(at_h=0.0, rack_size=8, rack_start=24,
                                 severity=0.85, power_fraction=0.0),
                 sim.SwitchFailure(at_h=0.0, group_size=16,
                                   group_start=n // 4, down_fraction=0.25,
                                   severity=0.9)],
                cluster, np.random.RandomState(SIM_SEED))
    cluster.fleet.advance_thermals(3600.0)
    det = session.monitor.detector
    update, diagnose = det.update, diag.diagnose
    part = {"update": 0.0, "diagnose": 0.0}

    def timed_update(frame):
        t0 = time.perf_counter()
        fleet = update(frame)
        fleet.flagged_indices()          # the flagged rows' host copy
        torch.cuda.synchronize()
        part["update"] += time.perf_counter() - t0
        return fleet

    def timed_diagnose(frame, fleet):
        t0 = time.perf_counter()
        out = diagnose(frame, fleet)
        part["diagnose"] += time.perf_counter() - t0
        return out

    det.update, diag.diagnose = timed_update, timed_diagnose
    for c in counters.values():
        c.reset()
    rows, flagged = [], []
    for w in range(TIMING_WINDOWS):
        t0 = time.perf_counter()
        cluster.run_window()
        frame = cluster.collect()
        t1 = time.perf_counter()
        part["update"] = part["diagnose"] = 0.0
        out = session.observe(frame)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rows.append((t2 - t1, part["update"], part["diagnose"],
                     t2 - t1 - part["update"] - part["diagnose"], t1 - t0))
        flagged.append(len(diag.last_fleet.records)
                       if diag.last_fleet is not None else 0)
        if (w + 1) % CKPT_EVERY == 0:
            session.on_checkpoint(now=cluster.t, step=cluster.step)
        session.advance(cluster.t, step=cluster.step)
    launches = {k: c.launches for k, c in counters.items()}
    check(only_k1(launches, TIMING_WINDOWS),
          f"timing at {n} nodes launched {launches} in {TIMING_WINDOWS} "
          f"windows (fleet_score once a window, nothing else)")
    ms = np.array(rows) * 1e3
    hit = np.array(flagged) > 0
    keys = ("window_ms", "update_ms", "diagnose_ms", "policy_manager_ms",
            "feed_ms")
    out = dict(nodes=n, windows=TIMING_WINDOWS,
               diagnosed_windows=int(hit.sum()),
               max_flagged=int(max(flagged)))
    out.update({k: float(v) for k, v in zip(keys, np.median(ms, axis=0))})
    # the windows in which the diagnoser ran its what-if over the fleet
    out["diagnosed"] = ({k: float(v) for k, v in
                         zip(keys, np.median(ms[hit], axis=0))}
                        if hit.any() else None)
    return out


def phase_sim(torch, np, counters: dict):
    import repro_torch.simcluster as sim
    out = ROOT / "build" / "repro_torch" / "smoke"
    out.mkdir(parents=True, exist_ok=True)

    # (a) attribution at fleet scale, card against CPU
    card, card_s, windows, launches = run_on_card(
        torch, counters, lambda: sim.simulate_run(
            attribution_config(sim, "cuda")))
    check(windows > 0 and only_k1(launches, windows),
          f"simulate_run on the card launched {launches} in {windows} "
          f"observed windows (fleet_score once a window, nothing else)")
    t0 = time.perf_counter()
    cpu = sim.simulate_run(attribution_config(sim, "cpu"))
    cpu_s = time.perf_counter() - t0
    diff = differing_fields(card, cpu)
    check(not diff, f"simulate_run on the card differs from the CPU run in "
                    f"{diff}")
    tp, fp = score_accusations(card)
    check(tp >= 1 and fp == 0, f"attribution: {tp} true and {fp} false "
                               f"culprit accusations (need >= 1 and 0)")
    kinds = {}
    for e in card.events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    held = sum(1 for e in card.events
               if e["kind"] == "diagnosis" and e["held"])
    k1_sim = launches["fleet_score"]
    nums = dict(sim_nodes=SIM_NODES, sim_windows=windows, steps=card.steps,
                events=len(card.events), restarts=kinds.get("restart", 0),
                true_accusations=tp, false_accusations=fp,
                held_verdicts=held, card_s=card_s, cpu_s=cpu_s)
    print(f"attribution (phase 11a): simulate_run of {SIM_NODES} nodes + "
          f"{SIM_SPARES} spares, {SIM_HOURS} h, rack thermal + switch "
          f"failure + congestion storm, diagnose and hang watchdog on: "
          f"{card.steps} steps, {len(card.events)} events "
          f"({kinds.get('restart', 0)} restarts, {kinds.get('diagnosis', 0)}"
          f" diagnoses of which {held} held), {tp} true and {fp} false "
          f"culprit accusations; every RunResult field equal to the CPU "
          f"run; fleet_score launched {launches['fleet_score']} times in "
          f"{windows} observed windows; wall {card_s:.2f} s on the card, "
          f"{cpu_s:.2f} s on the CPU", flush=True)

    # (b) hangs: bench_hang's quick suite, card against CPU
    hangs = {}
    for name, cfg in hang_configs(sim, "cuda").items():
        card, secs, windows, launches = run_on_card(
            torch, counters, lambda: sim.simulate_run(cfg))
        check(only_k1(launches, windows),
              f"{name}: launched {launches} in {windows} observed windows")
        cpu = sim.simulate_run(hang_configs(sim, "cpu")[name])
        diff = differing_fields(card, cpu)
        check(not diff, f"{name}: the card's run differs from the CPU run "
                        f"in {diff}")
        verdicts = [e for e in card.events
                    if e["kind"] == "hang" and e["op"] != "step"]
        check(any(e["culprits"] for e in verdicts),
              f"{name}: no HangDetected names a culprit ({verdicts})")
        hangs[name] = dict(verdicts=len(verdicts),
                           attributed=sum(1 for e in verdicts
                                          if e["culprits"]),
                           windows=windows, card_s=secs)
        k1_sim += launches["fleet_score"]
    print(f"hangs (phase 11b): bench_hang's quick suite on the card, each "
          f"run equal to its CPU run: {json.dumps(hangs)}", flush=True)

    # (c) the step hook's timing-trace feed, card against CPU
    from repro_torch.guard import GuardStepHook, JsonlSink
    streams = {}
    for device in ("cuda", "cpu"):
        hook = GuardStepHook(n_peers=15, window_steps=4, seed=3,
                             diagnose=True, device=device)
        hook.inject_stall(at_step=30, factor=8.0, steps=4)
        path = out / f"hook_{device}.jsonl"
        path.unlink(missing_ok=True)         # the sink appends
        sink = JsonlSink(str(path))
        hook.session.add_sink(sink)
        if device == "cuda":
            answers, _, _, launches = run_on_card(
                torch, counters, lambda: drive_hook(hook))
            check(only_k1(launches, hook.frames_fed),
                  f"hook: launched {launches} in {hook.frames_fed} windows")
            k1_sim += launches["fleet_score"]
        else:
            answers = drive_hook(hook)
        sink.close()
        streams[device] = (answers, path.read_text(), hook.trace.pushes)
    check(streams["cuda"] == streams["cpu"],
          "hook: the card's answers, JSONL or trace differ from the CPU's")
    jsonl = streams["cuda"][1]
    restarts = sum(1 for _, r in streams["cuda"][0] if r)
    check(restarts >= 1 and '"kind": "diagnosis"' in jsonl,
          "hook: the stall was not caught or nothing was diagnosed")
    print(f"hook feed (phase 11c): GuardStepHook(diagnose=True) on the "
          f"card, {restarts} restart(s), {len(jsonl.splitlines())} events "
          f"and {streams['cuda'][2]} timing-trace rows, identical to the "
          f"CPU run", flush=True)

    # (d) the window's time and its split, printed and not gated
    timing = [time_window(torch, np, sim, n, counters) for n in TIMING_NODES]
    for t in timing:
        for what, d in (("all", t), ("diagnosed", t["diagnosed"])):
            if d is None:
                continue
            print(f"window timing (phase 11d) at {t['nodes']} nodes, p50 "
                  f"of the {what} windows ({t['windows']} windows, "
                  f"{t['diagnosed_windows']} diagnosed, up to "
                  f"{t['max_flagged']} flagged): session.observe "
                  f"{d['window_ms']:.3f} ms = detector.update "
                  f"{d['update_ms']:.3f} ms (staging + fleet_score + flagged"
                  f" copy) + Diagnoser.diagnose {d['diagnose_ms']:.3f} ms + "
                  f"policy and manager {d['policy_manager_ms']:.3f} ms; "
                  f"SimCluster feed {d['feed_ms']:.3f} ms a window",
                  flush=True)
    nums.update(hangs=hangs, timing=timing)
    return k1_sim, nums


# ------------------------------------------- phase 12: the fleet control plane

# benchmarks/bench_fleet.py's quick mix (fleet_config(True)), copied: 16
# jobs, ENHANCED and ONLINE in turn, priorities 1-4, 2 private spares each,
# 2 simulated hours, 8 bench slots, healthscan every 1,800 s in batches of
# 8, a global spare target of 24 and one homed spare a job, seed 11; at
# 256 nodes a job (the benchmark's own), then at 1,024 (16,384 in all,
# phase 4's fleet size).
FLEET_JOBS = 16
FLEET_NODES = (256, 1024)
FLEET_HOURS = 2.0
FLEET_WALL_FIELDS = ("overhead_s", "wall_s", "overhead_frac")


def fleet_config(sim, per_job: int, device: str):
    tiers = (sim.Tier.ENHANCED, sim.Tier.ONLINE)
    jobs = tuple(sim.FleetJobSpec(name=f"job{i:02d}", tier=tiers[i % 2],
                                  n_nodes=per_job, n_spare=2,
                                  priority=1 + i % 4, seed=i)
                 for i in range(FLEET_JOBS))
    return sim.FleetRunConfig(jobs=jobs, duration_h=FLEET_HOURS,
                              bench_slots=8, healthscan_period_s=1800.0,
                              healthscan_batch=8, starvation_age_s=3600.0,
                              floor_frac=0.5, spare_target=24, home_min=1,
                              seed=11, device=device)


@contextlib.contextmanager
def fleet_jsonl(path: Path):
    """Every ``FleetController`` built meanwhile writes its fleet log to
    ``path`` through ``JsonlStreamSink`` (``simulate_fleet`` builds one)."""
    import repro_torch.fleet as fleet
    base = fleet.FleetController
    sinks = []

    class Logged(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            sinks.append(fleet.JsonlStreamSink(str(path)))
            self.log.attach(sinks[-1])

    fleet.FleetController = Logged
    try:
        yield
    finally:
        fleet.FleetController = base
        for sink in sinks:
            sink.close()


@contextlib.contextmanager
def timed_observe(torch, card: bool):
    """Host ms of every ``GuardSession.observe`` meanwhile (ending in a
    synchronize on the card): one entry an observed window."""
    from repro_torch.guard import GuardSession
    ms = []
    observe = GuardSession.observe

    def timed(self, frame):
        t0 = time.perf_counter()
        out = observe(self, frame)
        if card:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    GuardSession.observe = timed
    try:
        yield ms
    finally:
        GuardSession.observe = observe


def phase_fleet(torch, np, counters: dict):
    """Phase 12: ``simulate_fleet`` on the card and on the CPU, at 256 and
    1,024 nodes a job. Returns (K1 launches, numbers)."""
    import repro_torch.simcluster as sim
    out = ROOT / "build" / "repro_torch" / "smoke"
    out.mkdir(parents=True, exist_ok=True)
    k1, nums = 0, {}
    for per_job in FLEET_NODES:
        runs = {}
        for device in ("cuda", "cpu"):
            path = out / f"fleet_{per_job}_{device}.jsonl"
            path.unlink(missing_ok=True)        # the sink appends
            for c in counters.values():
                c.reset()
            card = device == "cuda"
            with fleet_jsonl(path), timed_observe(torch, card) as ms:
                t0 = time.perf_counter()
                res = sim.simulate_fleet(fleet_config(sim, per_job, device))
                if card:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            runs[device] = dict(res=res, wall=wall, ms=ms,
                                launches={n: c.launches
                                          for n, c in counters.items()},
                                log=path.read_text().splitlines())
        card, cpu = runs["cuda"], runs["cpu"]
        tag = (f"fleet (phase 12) {FLEET_JOBS} jobs x {per_job} nodes, "
               f"{FLEET_HOURS} h")
        res = card["res"]
        diff = [f.name for f in dataclasses.fields(res)
                if f.name not in FLEET_WALL_FIELDS
                and getattr(res, f.name) != getattr(cpu["res"], f.name)]
        check(not diff, f"{tag}: the card's FleetRunResult differs from the "
                        f"CPU run in {diff}")
        check(card["log"] == cpu["log"] and len(card["log"]) ==
              res.events_logged > 0, f"{tag}: the fleet JSONL of the card "
              f"({len(card['log'])} lines) differs from the CPU's "
              f"({len(cpu['log'])})")
        check(res.census_ok and res.starvation_events == 0,
              f"{tag}: census_ok {res.census_ok}, "
              f"{res.starvation_events} starvation events")
        windows = len(card["ms"])
        check(windows > 0 and only_k1(card["launches"], windows),
              f"{tag}: launched {card['launches']} in {windows} observed "
              f"windows (fleet_score once a window, nothing else)")
        check(not any(cpu["launches"].values()),
              f"{tag}: the CPU run launched {cpu['launches']}")
        k1 += windows
        p50 = {d: float(np.median(r["ms"])) for d, r in runs.items()}
        row = dict(nodes=per_job * FLEET_JOBS, windows=windows,
                   events=res.events_logged, steps=sum(
                       j["steps"] for j in res.jobs), **res.pool,
                   healthscan=res.healthscan,
                   card_wall_s=card["wall"], cpu_wall_s=cpu["wall"],
                   card_overhead_s=res.overhead_s,
                   card_overhead_frac=res.overhead_frac,
                   cpu_overhead_s=cpu["res"].overhead_s,
                   cpu_overhead_frac=cpu["res"].overhead_frac,
                   observe_p50_ms_card=p50["cuda"],
                   observe_p50_ms_cpu=p50["cpu"])
        nums[str(per_job)] = row
        print(f"{tag}: every FleetRunResult field but the wall clocks equal "
              f"to the CPU run, fleet JSONL equal line for line "
              f"({res.events_logged} events), census conserved, 0 "
              f"starvation events; {res.pool['grants']} grants, "
              f"{res.pool['transfers']} transfers, {res.pool['provisions']} "
              f"provisions, healthscan {res.healthscan}; fleet_score "
              f"launched {windows} times in {windows} observed windows; "
              f"wall {card['wall']:.2f} s on the card, {cpu['wall']:.2f} s "
              f"on the CPU; controller overhead {res.overhead_s:.3f} s = "
              f"{res.overhead_frac:.2%} of the wall on the card "
              f"({cpu['res'].overhead_s:.3f} s = "
              f"{cpu['res'].overhead_frac:.2%} on the CPU; bench_fleet's "
              f"gate is 5 %, not applied here); session.observe p50 "
              f"{p50['cuda']:.3f} ms a window on the card, {p50['cpu']:.3f}"
              f" ms on the CPU", flush=True)
    return k1, nums


# ------------------------------------------ phase 13: K4' and ssm training

# K4' cases: B, S, H, hd, C, dtype, decay (the mean of log(-logw): -2 is
# about -0.14 a token; 0.5 about -1.9, so a chunk's exponents pass the
# +-25 clamp), with a nonzero d(state) and s0. The first is rwkv6-7b's
# training shape at 4,096 tokens, the main path's; then float32 there,
# head dims 16, 32 and 128, B = 2, a state gradient, and one chunk of
# 1,000 tokens (C = S, which 32 does not divide) past the clamp.
K4B_CASES = [
    (1, 4096, 64, 64, 32, "bfloat16", -2.0, False),
    (1, 4096, 64, 64, 32, "float32", -2.0, False),
    (1, 1024, 8, 16, 32, "bfloat16", -2.0, False),
    (1, 1024, 8, 32, 32, "bfloat16", -2.0, False),
    (1, 1024, 8, 128, 32, "bfloat16", -2.0, False),
    (2, 1024, 8, 64, 32, "bfloat16", -2.0, False),
    (1, 1024, 8, 64, 32, "bfloat16", -2.0, True),
    (1, 1000, 4, 64, 1000, "bfloat16", 0.5, True),
]
# rwkv6-7b's training step on each rank of phase 25(d): 16 of 64 heads
TP_K4B = (1, 2048, 16, 64, 32, "bfloat16", -2.0, False)
K4B_CASES.append(TP_K4B)
# Each gradient's largest |kernel - plain| over its largest magnitude.
# Both run the same equations on the same inputs and the same chunk-start
# states, in another order of sums, with e^x as ex2 and the products on
# the tensor cores in TF32 split three ways (3xTF32: ~21 bits a product,
# float32 keeps 24): float32 outputs (all of them in float32, dlogw, du
# and ds0 in both) differ by a few float32 roundings, up to 1.0e-5
# measured on an H100 (dlogw of the 1,000-token chunk past the clamp;
# <= 2e-6 elsewhere), so 1e-4. In bfloat16, dr, dk and dv are rounded
# once to bfloat16 by both, from float32 values a few roundings apart: at
# most one bfloat16 step, 2^-8 of the element's magnitude (up to 3.7e-3
# of the largest measured on an H100), so 8e-3.
K4B_TOL = {"bfloat16": 8e-3, "float32": 1e-4}
K4B_KERNELS = ["wkv6_bwd_state", "wkv6_bwd_out", "wkv6_bwd_du"]


def k4b_inputs(torch, np, i: int):
    """Seeded inputs of ``K4B_CASES[i]`` on the card, in the kernel's
    (B, H, S, hd) layout: r, k, v, logw, u, s0, dy, ds (None unless the
    case has a state gradient) and the chunk-start states K4 keeps."""
    from repro_torch.kernels.wkv6 import wkv6_chunked
    b, s, h, hd, c, dname, decay, full = K4B_CASES[i]
    dt = getattr(torch, dname)
    rng = np.random.default_rng(400 + i)

    def mk(*shape, scale=0.5):
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(x).cuda()
    r, k, v = (mk(b, s, h, hd).to(dt).transpose(1, 2) for _ in range(3))
    logw = (-torch.exp(mk(b, s, h, hd) + decay)).transpose(1, 2)
    u = mk(h, hd, scale=0.15)
    s0 = mk(b, h, hd, hd, scale=0.05 if full else 0.0)
    dy = mk(b, s, h, hd, scale=1.0).transpose(1, 2)
    ds = mk(b, h, hd, hd, scale=1.0) if full else None
    _, _, starts = wkv6_chunked(r, k, v, logw, u, s0, chunk=c,
                                keep_states=True)
    return r, k, v, logw, u, s0, dy, ds, starts


def phase_k4_bwd(torch, np):
    from repro_torch.kernels.wkv6 import (wkv6_bwd_bytes, wkv6_bwd_flops,
                                          wkv6_bwd_ref, wkv6_chunked_bwd)
    main = None
    for i, (b, s, h, hd, c, dname, decay, full) in enumerate(K4B_CASES):
        dt = getattr(torch, dname)
        r, k, v, logw, u, s0, dy, ds, starts = k4b_inputs(torch, np, i)

        def call():
            return wkv6_chunked_bwd(r, k, v, logw, u, starts, dy, ds,
                                    chunk=c)
        got, again = call(), call()
        want = wkv6_bwd_ref(r, k, v, logw, u, s0, dy, ds, chunk=c)
        torch.cuda.synchronize()
        tag = (f"K4' wkv6_bwd B,S,H,hd={b},{s},{h},{hd} chunk {c} {dname}"
               f"{' past the clamp' if decay > 0 else ''}"
               f"{', d(state) and s0 nonzero' if full else ''}")
        errs, abs_err = {}, 0.0
        for n, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                           want):
            tol = K4B_TOL[dname if g.dtype == dt else "float32"]
            errs[n] = rel_err(g, w)
            abs_err = max(abs_err, max_abs_err(g, w))
            check(bool(torch.isfinite(g).all()) and errs[n] <= tol,
                  f"{tag}: {n} differs from plain by {errs[n]:.3e} of its "
                  f"largest magnitude (> {tol})")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{tag}: two calls are not bit-equal")
        del got, again, want
        names = kernel_basenames(torch, call)
        kinds = K4B_KERNELS[:2] + (["wkv6_bwd_fix"] if c > 32 else []) + \
            K4B_KERNELS[2:]
        check(names == kinds, f"{tag}: one call ran {names}, not {kinds}")
        ms = time_ms(call, reps=5, warm=1)
        split = kernel_split_ms(torch, call)
        check(sorted(split) == sorted(names), f"{tag}: the device split "
              f"{split} is not of the kernels {names}")
        dev_ms = sum(split.values())
        flops = wkv6_bwd_flops(b, h, s, hd, c)
        nbytes = wkv6_bwd_bytes(b, h, s, hd, r.element_size())
        # the products run on the tensor cores in TF32 (three per product:
        # the 3xTF32 split); the CUDA cores' bound is printed beside it
        bnd, by = bound(flops, TF32_TENSOR_FLOPS, nbytes)
        simt = flops / FP32_SIMT_FLOPS * 1e3
        tf32 = flops / TF32_TENSOR_FLOPS * 1e3
        line = (f"{tag}: max err / max abs " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items()) + f" (tol "
            f"{K4B_TOL[dname]} for {dname} outputs, 1e-4 float32), two "
            f"calls bit-equal; kernel {ms:.4f} ms a call ({dev_ms:.4f} ms "
            f"on the device, {len(names)} kernels: "
            f"{', '.join(names)}), {bnd / ms:.2%} of bound, bound "
            f"{bnd:.4f} ms ({by}; {nbytes / 1e6:.2f} MB; "
            f"{flops / 1e9:.3f} GFLOP: {tf32:.4f} ms at 495 TFLOP/s TF32, "
            f"{3 * tf32:.4f} ms for the split's three products; the CUDA "
            f"cores' bound {simt:.4f} ms)")
        plain = None
        if i < 2 or K4B_CASES[i] == TP_K4B:   # plain at the main shapes
            plain = time_ms(lambda: wkv6_bwd_ref(r, k, v, logw, u, s0, dy,
                                                 ds, chunk=c), reps=3,
                            warm=1)
            line += f"; plain {plain:.4f} ms, library none"
        if i == 0:
            line += "; device split " + ", ".join(
                f"{n} {m:.4f} ms" for n, m in split.items())
        print(line, flush=True)
        nums = dict(max_abs_err=abs_err, max_rel_err=max(errs.values()),
                    ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, library_ms=None, shape=[b, s, h, hd, c],
                    kernels_per_call=len(names))
        if main is None:
            main = nums
        if K4B_CASES[i] == TP_K4B:
            main["tp"] = nums
        del r, k, v, logw, dy, starts
        torch.cuda.empty_cache()
    return main


TRAIN_SSM_LAYERS = 8       # of rwkv6-7b's 32: ~2.3 B parameters
# What the bf16 step can be held to. The random-weight rwkv6-7b's bf16
# gradients at this width depend on the last float32 bit of the WKV
# output: K4's y differs from wkv6_ref's on the same inputs by ~5e-7 of
# its largest magnitude (a different order of float32 sums), which flips
# ~3,500 of layer 0's 16.8 M bf16 roundings; the flips spread (at layer 7
# most r/k/v elements differ between the paths), and where a head's
# first-token output y_0 = (r_0 . u k_0) v_0 comes out nearly zero, its
# variance falls below the group norm's eps (1e-5) and the norm's slope,
# 1/sqrt(eps), puts a spike into dy there and into u's gradient. Which
# head that is depends on the rounding history. Measured on an H100
# (tools/ssm_bf16_step.py): kernel vs plain path 37x a leaf's largest
# magnitude (layers.7.tm.u), the plain path with its WKV output times
# (1 + 1e-7 N(0, 1)) 0.9x against itself, the plain bf16 path 5.8x from
# the plain float32 one; K4 forward with the plain backward reproduces
# the kernel path's gradients, the plain forward with K4' the plain
# path's. So no gradient or update limit holds between two bf16 paths
# that differ in that last bit. The bf16 step is held to phase 10's loss
# limit, and every K4 and K4' call in it to its plain version on the
# inputs the step gave it (K4B_TOL; K4's float32 y like K4''s float32
# outputs); its gradient and update gaps are printed beside those of the
# noise twin (NOISE_EPS). The same step in float32, on the bf16 weights
# widened, is held to all of phase 10's limits.
NOISE_EPS = 1e-7


@contextlib.contextmanager
def kept_wkv6_bwd_calls(log: list):
    """Keep in ``log``, for every K4' call of the kernel path, its inputs
    (the forward's r, k, v, logw, u and chunk-start states, dy, d(state),
    the chunk) and its outputs, each a copy."""
    from unittest import mock
    from repro_torch.kernels.wkv6 import ops
    bwd = ops.wkv6_chunked_bwd

    def kept(r, k, v, logw, u, starts, dy, ds=None, *, chunk):
        out = bwd(r, k, v, logw, u, starts, dy, ds, chunk=chunk)
        log.append(dict(
            args=[t.detach().clone() for t in (r, k, v, logw, u, starts,
                                               dy)],
            ds=None if ds is None else ds.detach().clone(), chunk=chunk,
            out=[t.detach().clone() for t in out]))
        return out
    with mock.patch.object(ops, "wkv6_chunked_bwd", kept):
        yield


def hold_wkv6_calls(torch, calls: list, tag: str) -> dict:
    """Every kept K4' call (``kept_wkv6_bwd_calls``) against
    ``wkv6_bwd_ref`` on its own inputs, and K4 on those inputs against
    ``wkv6_ref``; fails outside K4B_TOL, or when K4 does not give the
    chunk-start states the step kept bit for bit. Prints the first call's
    (the last layer's) largest |dy| and the variance of its head's y
    there. Returns the worst gaps."""
    from repro_torch.kernels.wkv6 import (wkv6_bwd_ref, wkv6_chunked,
                                          wkv6_ref)
    fwd = bwd = 0.0
    for i, c in enumerate(calls):
        r, k, v, logw, u, starts, dy = c["args"]
        s0 = starts[:, :, 0]                 # the first chunk-start state
        y, _, again = wkv6_chunked(r, k, v, logw, u, s0, chunk=c["chunk"],
                                   keep_states=True)
        check(torch.equal(again, starts), f"{tag}: K4 on the inputs of "
              f"backward call {i} gave other chunk-start states than the "
              f"step kept")
        e = rel_err(y, wkv6_ref(r, k, v, logw, u, s0, chunk=c["chunk"])[0])
        check(e <= K4B_TOL["float32"], f"{tag}: K4's y on the inputs of "
              f"backward call {i} differs from wkv6_ref by {e:.3e}")
        fwd = max(fwd, e)
        want = wkv6_bwd_ref(r, k, v, logw, u, s0, dy, c["ds"],
                            chunk=c["chunk"])
        for n, got, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"),
                             c["out"], want):
            tol = K4B_TOL["bfloat16" if got.dtype == torch.bfloat16
                          else "float32"]
            e = rel_err(got, w)
            check(e <= tol, f"{tag}: K4' call {i} differs from "
                  f"wkv6_bwd_ref in {n} by {e:.3e} (> {tol})")
            bwd = max(bwd, e / tol)
        if i == 0:
            b, h, t, j = (int(x) for x in torch.unravel_index(
                dy.abs().argmax(), dy.shape))
            var = float(y[b, h, t].bfloat16().float().var(unbiased=False))
            spike = dict(dy=float(dy[b, h, t, j].abs()), token=t, head=h,
                         y_var=var)
        del y, again, want
    print(f"{tag} step in bfloat16: each of its {len(calls)} K4' calls "
          f"within {bwd:.3f} of K4B_TOL of wkv6_bwd_ref on its own inputs, "
          f"K4 on them within {fwd:.3e} of wkv6_ref (tol "
          f"{K4B_TOL['float32']}), chunk-start states bit-equal to the "
          f"step's; last layer's largest |dy| {spike['dy']:.3e} at token "
          f"{spike['token']}, head {spike['head']}, where y's variance is "
          f"{spike['y_var']:.3e} (group norm eps 1e-5)", flush=True)
    return dict(k4_vs_ref=fwd, k4b_of_tol=bwd, last_dy=spike)


def phase_train_ssm(torch, np, counters: dict):
    """Phase 13(b): rwkv6-7b training at full width, K4 and K4' on the
    path: (a) one bf16 step against the plain path (see NOISE_EPS), then
    the same step in float32 held to phase 10's limits; (b)
    ``trainer_run``. Returns (launches of the Trainer run, numbers)."""
    import gc
    from unittest import mock
    import repro_torch.models.rwkv6 as rwkv6_mod
    from repro_torch.kernels.wkv6 import wkv6_plain
    from repro_torch.models.common import Policy
    from repro_torch.models.model import Model
    per_step = {"wkv6": 2 * TRAIN_SSM_LAYERS, "wkv6_bwd": TRAIN_SSM_LAYERS}
    model, data, batch, opt, tag = train_setup(torch, "rwkv6-7b",
                                               TRAIN_SSM_LAYERS)
    calls = []
    with kept_wkv6_bwd_calls(calls):
        loss_k, grads_k, loss_p, grads_p, launches = step_vs_plain(
            torch, counters, per_step, model, batch, tag)
    check(len(calls) == TRAIN_SSM_LAYERS, f"{tag}: {len(calls)} K4' calls "
          f"kept, not one a layer")
    held = hold_wkv6_calls(torch, calls, tag)
    del calls
    g16 = step_gaps(torch, model, loss_k, grads_k, loss_p, grads_p, opt)
    check(g16["loss_err"] <= LOSS_REL_TOL, f"{tag}: bf16 loss "
          f"{float(loss_k)} vs plain {float(loss_p)} ({g16['loss_err']:.3e})")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def noisy(r, k, v, logw, u, s0, *, chunk=64):
        y, s = wkv6_plain(r, k, v, logw, u, s0, chunk=chunk)
        n = torch.randn(y.shape, generator=gen, device=y.device)
        return y * (1 + NOISE_EPS * n), s
    with plain_paths(), mock.patch.object(rwkv6_mod, "wkv6", noisy):
        loss_n, grads_n = train_step_grads(torch, model, batch)
    gn = step_gaps(torch, model, loss_n, grads_n, loss_p, grads_p, opt)
    del grads_n
    print(f"{tag} step in bfloat16, kernel vs plain path: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f} ({g16['loss_err']:.3e},"
          f" limit {LOSS_REL_TOL}); not gated (see NOISE_EPS): gradients "
          f"within {g16['grad_err']:.3e} of their largest magnitude (worst "
          f"{g16['worst']}), AdamW updates' cosine {g16['update_cos']:.6f}, "
          f"{g16['update_flip']:.3e} of entries change sign; the plain path "
          f"with y x (1 + {NOISE_EPS:g} N(0, 1)) against itself: gradients "
          f"{gn['grad_err']:.3e} (worst {gn['worst']}), cosine "
          f"{gn['update_cos']:.6f}, {gn['update_flip']:.3e} change sign; "
          f"launches {launches}", flush=True)
    grads_k = {n: t.cpu() for n, t in grads_k.items()}
    grads_p = {n: t.cpu() for n, t in grads_p.items()}
    gc.collect()
    torch.cuda.empty_cache()

    f32 = Model(model.cfg, Policy(compute_dtype=torch.float32),
                device="cuda", seed=None, remat="full")
    with torch.no_grad():
        for (_, a), (_, b) in zip(f32.named_parameters(),
                                  model.named_parameters()):
            a.copy_(b)
    for p in f32.parameters():
        p.requires_grad_(True)
    lk, gk, lp, gp, l32 = step_vs_plain(torch, counters, per_step, f32,
                                        batch, tag)
    step_nums = hold_step(step_gaps(torch, f32, lk, gk, lp, gp, opt), lk,
                          lp, tag, "in float32 (the bf16 weights widened)",
                          l32)
    del gk
    kf = {n: rel_err(grads_k[n].cuda(), gp[n]) for n in gp}
    pf = {n: rel_err(grads_p[n].cuda(), gp[n]) for n in gp}
    top = sorted(kf, key=kf.get, reverse=True)[:5]
    print(f"{tag}: each gradient's gap to the float32 plain step, bf16 "
          f"kernel path | bf16 plain path (the five largest kernel gaps): "
          + ", ".join(f"{n} {kf[n]:.3e} | {pf[n]:.3e}" for n in top)
          + f"; largest plain gap {max(pf.values()):.3e} "
          f"({max(pf, key=pf.get)})", flush=True)
    step_nums.update(
        bf16_loss_err=g16["loss_err"], bf16_grad_err=g16["grad_err"],
        bf16_worst=g16["worst"], bf16_update_cos=g16["update_cos"],
        bf16_update_flip=g16["update_flip"], noise_grad_err=gn["grad_err"],
        noise_update_cos=gn["update_cos"],
        noise_update_flip=gn["update_flip"],
        bf16_kernel_vs_fp32=max(kf.values()),
        bf16_plain_vs_fp32=max(pf.values()), **held)
    del f32, gp, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    return trainer_run(torch, np, counters, per_step, model, data, batch,
                       opt, tag, step_nums)


# ------------------------------------------ phases 17 and 18: the hybrid family

# K5 cases: B, S, W, xb dtype, h0 nonzero. The first is recurrentgemma-9b's
# prefill at 4,096 tokens (lru_width 4,096) from the zero state, the main
# path's shape; then the same in float32 from a nonzero state, and small
# odd shapes: B = 2 and 3, S of one step, inside one 128-step tile of the
# kernel's ring and over many (1, 20, 37, 1,000, 4,097), W no multiple of a
# block's 32 channels (33, 300). The last two are edges of the ring design:
# S one step past a tile (129) with a last block of 4 live channels at 129
# blocks, and S one step past the ring's three slots (385, its first wrap)
# in bfloat16 with W no multiple of 8 (element accesses, not 16-byte ones).
K5_CASES = [(1, 4096, 4096, "bfloat16", False),
            (1, 4096, 4096, "float32", True),
            (2, 1000, 300, "float32", True), (2, 37, 64, "bfloat16", True),
            (3, 4097, 96, "float32", True), (1, 1, 33, "float32", True),
            (2, 20, 4096, "bfloat16", True),
            (1, 129, 4100, "float32", True), (2, 385, 300, "bfloat16", True)]
# recurrentgemma-9b's prefill on each rank of phase 25(e): 1,024 of the
# LRU's 4,096 channels
TP_K5 = (1, 4096, 1024, "bfloat16", False)
K5_CASES.append(TP_K5)
# H and h_last against the plain version's float32 H and h_last: the
# largest difference over the largest magnitude (the card's special
# functions and a fused multiply-add a step against torch's: both walk the
# sequence in order). A bfloat16 H is held by the float32 error its
# rounding implies: how far the plain version's float32 value lies outside
# the kernel's bfloat16 value's rounding interval (half a bfloat16 ulp each
# way).
K5_TOL = 1e-5
# K5' against rglru_bwd_ref on the same inputs (the forward's float32
# states included): each float32 gradient's largest difference over its
# largest magnitude, as K4B_TOL holds K4''s float32 outputs. The chain and
# the gates are the same float32 operations in another order (the chunks'
# carries compose the reverse chain's products in another order, and
# dwa, dwi, dlam sum 4,096 to 16 M terms per chunk and batch row, then
# over them); a bfloat16 dxb is held by the float32 error its rounding
# implies (bf16_rounding_excess).
K5B_TOL = 1e-4

# Windowed K3 cases: B, Hq, Hkv, S, T, hd, q_offset, kv_len, window, dtype.
# The first is recurrentgemma-9b's local attention at 4,096 tokens (16
# query heads over one KV head of 256, window 2,048), the main path's
# shape; then float32 there; its 1,000-token prefill (S <= W: the model
# calls plain causal attention) with and without the window; float32 at
# hd 256; hd 64 with GQA; q_offset and kv_len ragged; hd 32 and 128;
# windows of 7 and 50.
K3W_CASES = [
    (1, 16, 1, 4096, 4096, 256, 0, 0, 2048, "bfloat16"),
    (1, 16, 1, 4096, 4096, 256, 0, 0, 2048, "float32"),
    (1, 16, 1, 1000, 1000, 256, 0, 0, 0, "bfloat16"),
    (1, 16, 1, 1000, 1000, 256, 0, 0, 2048, "bfloat16"),
    (1, 4, 1, 600, 600, 256, 0, 0, 256, "float32"),
    (2, 8, 2, 700, 700, 64, 0, 0, 128, "bfloat16"),
    (1, 4, 1, 200, 520, 256, 320, 500, 100, "bfloat16"),
    (2, 4, 4, 333, 333, 128, 0, 0, 64, "float32"),
    (1, 8, 2, 300, 300, 32, 0, 0, 50, "bfloat16"),
    (1, 4, 1, 129, 300, 256, 171, 0, 7, "bfloat16"),
]
# recurrentgemma-9b's local attention on each rank of phase 25(e): 4 of
# its 16 query heads over the one KV head, forward and backward
TP_WINDOW = (1, 4, 1, 4096, 4096, 256, 0, 0, 2048, "bfloat16")
K3W_CASES.append(TP_WINDOW)


def bf16_rounding_excess(torch, got, want):
    """Elementwise, how far the float32 ``want`` lies outside the rounding
    interval of the bfloat16 ``got`` (half a bfloat16 ulp of ``got`` each
    way; 0 inside): a lower bound of the float32 error that rounded to
    ``got``."""
    g = got.float()
    _, e = torch.frexp(g)                    # |g| = m 2^e, m in [0.5, 1)
    half_ulp = torch.where(g == 0, torch.zeros_like(g),
                           torch.ldexp(torch.ones_like(g), e - 9))
    return ((g - want).abs() - half_ulp).clamp_min(0.0)


def phase_k5(torch, np):
    """Phase 17(a): the RG-LRU scan kernel against its plain version."""
    from repro_torch.kernels.rglru import (rglru_bytes, rglru_flops,
                                           rglru_ref, rglru_scan,
                                           rglru_sfu_ops)
    main = None
    for i, (b, s, w, dname, warm_h0) in enumerate(K5_CASES):
        dt = getattr(torch, dname)
        rng = np.random.default_rng(300 + i)

        def mk(*shape, scale=1.0, shift=0.0):
            x = rng.standard_normal(shape, dtype=np.float32) * scale + shift
            return torch.from_numpy(x).cuda()
        xb = mk(b, s, w).to(dt)
        wa, wi, lam = mk(w, scale=0.5), mk(w, scale=0.5), mk(w, shift=0.65)
        h0 = mk(b, w) if warm_h0 else torch.zeros(b, w, device="cuda")
        H, hl = rglru_scan(xb, wa, wi, lam, h0)
        H2, hl2 = rglru_scan(xb, wa, wi, lam, h0)
        want, want_hl = rglru_ref(xb.float(), wa, wi, lam, h0)
        torch.cuda.synchronize()
        tag = f"K5 rglru B,S,W={b},{s},{w} {dname}" + (
            " h0 != 0" if warm_h0 else "")
        check(torch.equal(H, H2) and torch.equal(hl, hl2),
              f"{tag}: two calls are not bit-equal")
        check(bool(torch.isfinite(H.float()).all()),
              f"{tag}: non-finite output")
        scale_h = float(want.abs().max().clamp_min(1e-30))
        if dt == torch.float32:
            err_h = float((H - want).abs().max()) / scale_h
        else:
            err_h = float(bf16_rounding_excess(torch, H, want).max()) / \
                scale_h
        err_l = float((hl - want_hl).abs().max() /
                      want_hl.abs().max().clamp_min(1e-30))
        abs_err = max_abs_err(H, want.to(dt))
        for what, e in (("H", err_h), ("h_last", err_l)):
            check(e <= K5_TOL, f"{tag}: {what} differs from the plain "
                  f"version by {e:.3e} of its largest magnitude "
                  f"(> {K5_TOL})")
        line = (f"{tag}: H {err_h:.3e}, h_last {err_l:.3e} of the largest "
                f"magnitude (limit {K5_TOL}: {max(err_h, err_l) / K5_TOL:.1%}"
                f" of it), max abs err against the plain output "
                f"{abs_err:.3e}, two calls bit-equal")
        if i == 0 or K5_CASES[i] == TP_K5:
            fn = lambda: rglru_scan(xb, wa, wi, lam, h0)   # noqa: E731
            names = kernel_basenames(torch, fn)
            check(names == ["rglru_scan"], f"{tag}: one call ran {names}")
            ms = time_ms(fn)
            dev_ms = kernel_device_ms(torch, fn, "rglru_scan")
            plain = time_ms(lambda: rglru_ref(xb, wa, wi, lam, h0), reps=2,
                            warm=1)
            flops = rglru_flops(b, s, w)
            nbytes = rglru_bytes(b, s, w, xb.element_size())
            bnd, by = bound(flops, FP32_SIMT_FLOPS, nbytes)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            sfu = rglru_sfu_ops(b, s, w) / (
                SFU_PER_CLOCK_SM * sms * BOOST_CLOCK_HZ) * 1e3
            line += (f"; kernel {ms:.4f} ms a call ({fmt_ms(dev_ms)} on the "
                     f"device, {bnd / ms:.1%} of bound), plain {plain:.4f} "
                     f"ms, library none, bound {bnd:.4f} ms ({by}; "
                     f"{flops / 1e9:.3f} GFLOP fp32, {nbytes / 1e6:.2f} MB); "
                     f"note, not the bound: the special-function floor "
                     f"{sfu:.4f} ms ({rglru_sfu_ops(b, s, w) / 1e6:.1f} M "
                     f"operations at {SFU_PER_CLOCK_SM} a clock on {sms} "
                     f"SMs, {BOOST_CLOCK_HZ / 1e9:.2f} GHz)")
            nums = dict(max_abs_err=abs_err, h_err=err_h, h_last_err=err_l,
                        ms=ms, device_ms=dev_ms, plain_ms=plain,
                        bound_ms=bnd, bound_by=by, library_ms=None,
                        shape=[b, s, w])
            if i == 0:
                main = nums
            else:
                main["tp"] = nums
        print(line, flush=True)
        main["worst_ratio"] = max(main.get("worst_ratio", 0.0),
                                  max(err_h, err_l) / K5_TOL)
        del xb, H, H2, want
    return main


def window_mask(torch, s: int, t: int, q_offset: int, kv_len: int,
                window: int):
    """The (S, T) boolean mask of live pairs, for sdpa."""
    qpos = q_offset + torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(t, device="cuda")[None, :]
    live = (kpos <= qpos) & (kpos < (kv_len or t))
    return live & (kpos > qpos - window) if window else live


def phase_k3_window(torch, np):
    """Phase 17(b): the flash-attention kernel with a sliding window and
    at head dim 256 against its plain version."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_flops,
                                                     attention_ref,
                                                     flash_attention)
    main = None
    for i, (b, hq, hkv, s, t, hd, qo, kvl, win, dname) in enumerate(
            K3W_CASES):
        dt, tol = getattr(torch, dname), K3_TOL[dname]
        rng = np.random.default_rng(400 + i)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to("cuda", dt).transpose(1, 2)
            for shape in ((b, s, hq, hd), (b, t, hkv, hd), (b, t, hkv, hd)))
        kw = dict(causal=True, q_offset=qo, kv_len=kvl, window=win)
        got = flash_attention(q, k, v, **kw)
        again = flash_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        tag = (f"K3 flash_attention B,Hq,Hkv,S,T,hd={b},{hq},{hkv},{s},{t},"
               f"{hd} causal{f' window {win}' if win else ''}"
               f"{f' q_offset {qo}' if qo else ''}"
               f"{f' kv_len {kvl}' if kvl else ''} {dname}")
        check(torch.equal(got, again), f"{tag}: two calls are not "
                                       f"bit-equal")
        check(bool(torch.isfinite(got.float()).all()),
              f"{tag}: non-finite output")
        err = max_abs_err(got, want)
        rel = err / float(want.float().abs().max().clamp_min(1e-30))
        check(rel <= tol, f"{tag}: max abs err {err:.3e} is {rel:.3e} of "
                          f"the output's largest magnitude (> {tol})")
        flops = attention_flops(b, hq, s, kvl or t, hd, causal=True,
                                q_offset=qo, window=win)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else FP32_SIMT_FLOPS
        bnd, by = bound(flops, peak, nbytes)
        fn = lambda: flash_attention(q, k, v, **kw)   # noqa: E731
        ms = time_ms(fn, reps=10, warm=2)
        line = (f"{tag}: max abs err {err:.3e}, {rel:.3e} of the largest "
                f"magnitude (limit {tol}: {rel / tol:.1%} of it), two calls "
                f"bit-equal; kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} "
                f"TFLOP/s, {bnd / ms:.1%} of bound), bound {bnd:.4f} ms "
                f"({by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
        if i < 2 or K3W_CASES[i] == TP_WINDOW:   # device, plain, sdpa
            dev_ms = kernel_device_ms(torch, fn, "fa_fwd")
            plain = time_ms(lambda: attention_ref(q, k, v, **kw), reps=3,
                            warm=1)
            mask = window_mask(torch, s, t, qo, kvl, win)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True), reps=10, warm=2)
            line += (f"; {fmt_ms(dev_ms)} on the device, plain "
                     f"{plain:.4f} ms, sdpa with the window's boolean mask "
                     f"{lib:.4f} ms")
            nums = dict(max_abs_err=err, rel_err=rel, ms=ms,
                        device_ms=dev_ms, plain_ms=plain, bound_ms=bnd,
                        bound_by=by, library_ms=lib,
                        shape=[b, hq, hkv, s, t, hd, win])
            if main is None:
                main = nums
            elif K3W_CASES[i] == TP_WINDOW:
                main["tp"] = nums
        print(line, flush=True)
        main["worst_ratio"] = max(main.get("worst_ratio", 0.0), rel / tol)
        del q, k, v, got, again, want
    return main


# --------------------------------- phases 19 and 20: the hybrid family trains

# K5' cases: B, S, W, xb dtype, h0 and dh_last nonzero. The first is
# recurrentgemma-9b's training shape (4,096 tokens, lru_width 4,096) from
# the zero state, the main path's; then float32 there from a nonzero state,
# and K5_CASES' odd shapes: B = 2 and 3, S of one step and no multiple of
# the kernel's tiles (1,000, 37, 4,097, 129, 385), W no multiple of a
# block's 32 channels (33, 300, 4,100); then the ring's edges (the kernel
# walks the sequence from its end in tiles of 88 bfloat16 or 44 float32
# steps through two slots): one step in bfloat16, one step past a tile
# (89, 45), the ring wrapped more than once plus one step (441 = 5 x 88
# + 1 = 10 x 44 + 1).
K5B_CASES = [(1, 4096, 4096, "bfloat16", False),
             (1, 4096, 4096, "float32", True),
             (2, 1000, 300, "float32", True), (2, 37, 64, "bfloat16", True),
             (3, 4097, 96, "float32", True), (1, 1, 33, "float32", True),
             (1, 129, 4100, "float32", True),
             (2, 385, 300, "bfloat16", True),
             (1, 1, 40, "bfloat16", True), (2, 89, 4096, "bfloat16", True),
             (1, 45, 300, "float32", True), (2, 441, 1000, "bfloat16", True),
             (1, 441, 64, "float32", True)]
# recurrentgemma-9b's training step on each rank of phase 25(e)
TP_K5B = (1, 4096, 1024, "bfloat16", False)
K5B_CASES.append(TP_K5B)
K5B_KERNELS = ["rglru_bwd_ring", "rglru_bwd_params"]


def phase_k5_bwd(torch, np):
    """Phase 19(a): the RG-LRU scan's backward kernel against its plain
    version, on the float32 states K5 writes for it."""
    from repro_torch.kernels.rglru import (rglru_bwd_bytes, rglru_bwd_flops,
                                           rglru_bwd_ref, rglru_bwd_sfu_ops,
                                           rglru_ref, rglru_scan,
                                           rglru_scan_bwd)
    main = None
    for i, (b, s, w, dname, warm) in enumerate(K5B_CASES):
        dt = getattr(torch, dname)
        rng = np.random.default_rng(500 + i)

        def mk(*shape, scale=1.0, shift=0.0):
            x = rng.standard_normal(shape, dtype=np.float32) * scale + shift
            return torch.from_numpy(x).cuda()
        xb = mk(b, s, w).to(dt)
        wa, wi, lam = mk(w, scale=0.5), mk(w, scale=0.5), mk(w, shift=0.65)
        h0 = mk(b, w) if warm else torch.zeros(b, w, device="cuda")
        dh_last = mk(b, w) if warm else None
        dH = mk(b, s, w).to(dt)
        _, _, states = rglru_scan(xb, wa, wi, lam, h0, keep_states=True)
        got = rglru_scan_bwd(xb, wa, wi, lam, h0, states, dH, dh_last)
        again = rglru_scan_bwd(xb, wa, wi, lam, h0, states, dH, dh_last)
        # float32 inputs of the same values: dxb before its cast
        want = rglru_bwd_ref(xb.float(), wa, wi, lam, h0, states,
                             dH.float(), dh_last)
        torch.cuda.synchronize()
        tag = f"K5' rglru_bwd B,S,W={b},{s},{w} {dname}" + (
            " h0, dh_last != 0" if warm else "")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{tag}: two calls are not bit-equal")
        # the states K5 kept are its H before the cast
        st_err = rel_err(states, rglru_ref(xb.float(), wa, wi, lam, h0)[0])
        check(st_err <= K5_TOL, f"{tag}: K5's float32 states differ from "
              f"the plain H by {st_err:.3e} (> {K5_TOL})")
        errs = {}
        for n, g, w_ in zip(("dxb", "dwa", "dwi", "dlam", "dh0"), got, want):
            check(bool(torch.isfinite(g.float()).all()),
                  f"{tag}: non-finite {n}")
            scale = float(w_.abs().max().clamp_min(1e-30))
            if g.dtype == torch.bfloat16:
                e = float(bf16_rounding_excess(torch, g, w_).max()) / scale
            else:
                e = float((g - w_).abs().max()) / scale
            errs[n] = e
            check(e <= K5B_TOL, f"{tag}: {n} differs from the plain version "
                  f"by {e:.3e} of its largest magnitude (> {K5B_TOL})")
        abs_err = max(max_abs_err(g, w_.to(g.dtype)) for g, w_ in
                      zip(got, want))
        worst = max(errs.values())
        line = (f"{tag}: " + ", ".join(f"{n} {e:.3e}" for n, e in
                                       errs.items())
                + f" of the largest magnitude (limit {K5B_TOL}: "
                f"{worst / K5B_TOL:.1%} of it), K5's states {st_err:.3e}, "
                f"max abs err {abs_err:.3e}, two calls bit-equal")
        if i == 0 or K5B_CASES[i] == TP_K5B:
            fn = lambda: rglru_scan_bwd(xb, wa, wi, lam, h0,   # noqa: E731
                                        states, dH, dh_last)
            names = kernel_basenames(torch, fn)
            check(names == K5B_KERNELS, f"{tag}: one call ran {names}, not "
                  f"{K5B_KERNELS}")
            ms = time_ms(fn)
            dev_ms = kernel_device_ms(torch, fn, "rglru_bwd")
            fwd_ms = time_ms(lambda: rglru_scan(xb, wa, wi, lam, h0))
            kept_ms = time_ms(lambda: rglru_scan(xb, wa, wi, lam, h0,
                                                 keep_states=True))
            plain = time_ms(lambda: rglru_bwd_ref(xb, wa, wi, lam, h0,
                                                  states, dH, dh_last),
                            reps=1, warm=1)
            flops = rglru_bwd_flops(b, s, w)
            nbytes = rglru_bwd_bytes(b, s, w, xb.element_size())
            bnd, by = bound(flops, FP32_SIMT_FLOPS, nbytes)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            sfu = rglru_bwd_sfu_ops(b, s, w) / (
                SFU_PER_CLOCK_SM * sms * BOOST_CLOCK_HZ) * 1e3
            line += (f"; kernel {ms:.4f} ms a call ({fmt_ms(dev_ms)} on the "
                     f"device, {len(names)} kernels: {', '.join(names)}; "
                     f"{bnd / ms:.1%} of bound), plain {plain:.4f} ms, "
                     f"library none, bound {bnd:.4f} ms ({by}; "
                     f"{flops / 1e9:.3f} GFLOP fp32, {nbytes / 1e6:.2f} MB); "
                     f"note, not the bound: the special-function floor "
                     f"{sfu:.4f} ms; K5 {fwd_ms:.4f} ms a call, "
                     f"{kept_ms:.4f} with the float32 states kept")
            nums = dict(max_abs_err=abs_err, max_rel_err=worst, ms=ms,
                        device_ms=dev_ms, plain_ms=plain, bound_ms=bnd,
                        bound_by=by, library_ms=None, shape=[b, s, w],
                        kernels_per_call=len(names), fwd_ms=fwd_ms,
                        fwd_states_ms=kept_ms)
            if i == 0:
                main = nums
            else:
                main["tp"] = nums
        print(line, flush=True)
        main["worst_ratio"] = max(main.get("worst_ratio", 0.0),
                                  worst / K5B_TOL)
        del xb, dH, states, got, again, want
    return main


# Windowed K3' cases: B, Hq, Hkv, S, T, hd, q_offset, kv_len, window,
# dtype. The first is recurrentgemma-9b's training shape (16 query heads
# over one KV head of 256, window 2,048, 4,096 tokens), the main path's;
# then float32 there; hd 256 with no window (1,000 tokens, the model's
# plain causal attention below the window) and at a ragged S with a
# window of 100; the window at hd 128, 64 (float32) and 32 (a window of 7)
# with GQA; q_offset and kv_len ragged at hd 256; a ragged float32 hd 256
# with no window; at hd 256 in bfloat16, S = 707 (no multiple of the dQ
# kernel's 48-key tiles, its 128-query blocks or the dK/dV kernel's 64-key
# blocks) with a window of 300, and a window of 77 (starting inside a
# 48-key tile at every row, shorter than one query tile and two key tiles)
# over 4 query heads in 4 parts.
K3BW_CASES = [
    (1, 16, 1, 4096, 4096, 256, 0, 0, 2048, "bfloat16"),
    (1, 16, 1, 4096, 4096, 256, 0, 0, 2048, "float32"),
    (1, 16, 1, 1000, 1000, 256, 0, 0, 0, "bfloat16"),
    (1, 4, 1, 333, 333, 256, 0, 0, 100, "bfloat16"),
    (2, 8, 2, 700, 700, 128, 0, 0, 128, "bfloat16"),
    (1, 4, 1, 300, 300, 64, 0, 0, 50, "float32"),
    (1, 8, 2, 300, 300, 32, 0, 0, 7, "bfloat16"),
    (1, 4, 1, 200, 520, 256, 320, 500, 100, "bfloat16"),
    (1, 4, 2, 129, 129, 256, 0, 0, 0, "float32"),
    (1, 8, 1, 707, 707, 256, 0, 0, 300, "bfloat16"),
    (1, 4, 1, 640, 640, 256, 0, 0, 77, "bfloat16"),
    TP_WINDOW,
]
# hd 256's own bfloat16 dK/dV kernel, in place of K3B_KERNELS' second
K3B_DKDV_HD256 = "fa_bwd_dkdv_hd256"


def phase_k3_bwd_window(torch, np):
    """Phase 19(b): the flash-attention backward kernel with a sliding
    window and at head dim 256 against its plain version, at phase 9's
    limits."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        attention_bwd_flops, attention_bwd_ref, attention_ref, dkdv_split,
        flash_attention, flash_attention_bwd)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version: fp32
    main = None
    for i, (b, hq, hkv, s, t, hd, qo, kvl, win, dname) in enumerate(
            K3BW_CASES):
        dt, tol = getattr(torch, dname), K3B_TOL[dname]
        rng = np.random.default_rng(700 + i)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to("cuda", dt).transpose(1, 2)
            for shape in ((b, s, hq, hd), (b, t, hkv, hd), (b, t, hkv, hd),
                          (b, s, hq, hd)))
        kw = dict(causal=True, q_offset=qo, kv_len=kvl, window=win)
        o, lse = flash_attention(q, k, v, lse=True, **kw)
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        o_ref, lse_ref = attention_ref(q, k, v, return_lse=True, **kw)
        want = attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
        torch.cuda.synchronize()
        tag = (f"K3' flash_attention_bwd B,Hq,Hkv,S,T,hd={b},{hq},{hkv},{s},"
               f"{t},{hd} causal{f' window {win}' if win else ''}"
               f"{f' q_offset {qo}' if qo else ''}"
               f"{f' kv_len {kvl}' if kvl else ''} {dname}")
        lse_err = max_abs_err(lse, lse_ref)
        check(lse_err <= LSE_TOL, f"{tag}: the forward's log-sum-exp "
              f"differs from plain by {lse_err:.3e} (> {LSE_TOL})")
        del o_ref
        errs = {}
        for n, g, w in zip(("dq", "dk", "dv"), got, want):
            errs[n] = rel_err(g, w)
            check(bool(torch.isfinite(g).all()) and errs[n] <= tol,
                  f"{tag}: {n} differs from plain by {errs[n]:.3e} of its "
                  f"largest magnitude (> {tol})")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{tag}: two calls are not bit-equal")
        err = max(errs.values())
        abs_err = max(max_abs_err(g, w) for g, w in zip(got, want))
        del got, again, want
        fn = lambda: flash_attention_bwd(q, k, v, o, lse, do,  # noqa: E731
                                         **kw)
        line = (f"{tag}: forward lse max abs err {lse_err:.3e} (tol "
                f"{LSE_TOL}); max err / max abs " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items()) + f" (tol {tol}), two "
            f"calls bit-equal")
        if i < 2 or K3BW_CASES[i] == TP_WINDOW:   # device, plain, sdpa
            names = kernel_basenames(torch, fn)
            want_names = list(K3B_KERNELS[dname])
            if dt == torch.bfloat16 and hd == 256:
                want_names[1] = K3B_DKDV_HD256
            split = 1 if dt != torch.bfloat16 else dkdv_split(
                b, hkv, t, hd, hq // hkv, torch.cuda.get_device_properties(
                    0).multi_processor_count)
            if split > 1:         # the parts' summing pass after dK/dV
                want_names.insert(2, "fa_bwd_kv_sum")
            check(names == want_names, f"{tag}: one call ran {names}, not "
                  f"{want_names}")
            ms = time_ms(fn, reps=5, warm=1)
            dev_ms = kernel_device_ms(torch, fn, "fa_bwd")
            flops = attention_bwd_flops(b, hq, s, kvl or t, hd, causal=True,
                                        q_offset=qo, window=win)
            nbytes = (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) * \
                q.element_size() + lse.numel() * 4
            peak = (BF16_TENSOR_FLOPS if dt == torch.bfloat16
                    else FP32_SIMT_FLOPS)
            bnd, by = bound(flops, peak, nbytes)
            plain = time_ms(lambda: attention_bwd_ref(q, k, v, o, lse_ref,
                                                      do, **kw),
                            reps=2, warm=1)
            mask = window_mask(torch, s, t, qo, kvl, win)
            qq, kk, vv = (x.detach().clone().requires_grad_(True)
                          for x in (q, k, v))
            out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                                 enable_gqa=True)
            lib = time_ms(lambda: torch.autograd.grad(
                out, (qq, kk, vv), do, retain_graph=True), reps=3, warm=1)
            del out, qq, kk, vv
            line += (f"; kernel {ms:.4f} ms a call ({fmt_ms(dev_ms)} on the "
                     f"device, {len(names)} kernels), "
                     f"{flops / ms / 1e9:.2f} TFLOP/s, {bnd / ms:.2%} of "
                     f"bound, bound {bnd:.4f} ms ({by}; {flops / 1e9:.3f} "
                     f"GFLOP, {nbytes / 1e6:.2f} MB); plain {plain:.4f} ms, "
                     f"sdpa backward with the window's boolean mask "
                     f"{lib:.4f} ms")
            if i == 0:
                split_ms = kernel_split_ms(torch, fn)
                split_ms = {n: split_ms.get(n) for n in names}
                check(None not in split_ms.values(), f"{tag}: the device "
                      f"split {split_ms} lacks a kernel")
                line += (f"; the dK/dV kernel's query heads in {split} "
                         f"parts; device split " + ", ".join(
                             f"{n} {m:.4f} ms" for n, m in split_ms.items()))
                main = dict(max_abs_err=abs_err, max_rel_err=err, ms=ms,
                            device_ms=dev_ms, plain_ms=plain, bound_ms=bnd,
                            bound_by=by, library_ms=lib,
                            shape=[b, hq, hkv, s, t, hd, win],
                            kernels_per_call=len(names), dkdv_split=split,
                            device_split=split_ms)
            elif K3BW_CASES[i] == TP_WINDOW:
                main["tp"] = dict(max_abs_err=abs_err, max_rel_err=err,
                                  ms=ms, device_ms=dev_ms, plain_ms=plain,
                                  bound_ms=bnd, bound_by=by, library_ms=lib,
                                  shape=[b, hq, hkv, s, t, hd, win],
                                  kernels_per_call=len(names),
                                  dkdv_split=split)
            else:
                main["ms_float32"] = ms
                main["device_ms_float32"] = dev_ms
        print(line, flush=True)
        main["worst_ratio"] = max(main.get("worst_ratio", 0.0), err / tol)
        del q, k, v, do, o, lse, lse_ref
        torch.cuda.empty_cache()
    return main


TRAIN_HYBRID_LAYERS = 5    # of recurrentgemma-9b's 38: a unit and the tail
# a step: each of the unit's two rec layers and its attention layer in the
# forward and in the recompute, each of the tail's two rec layers once; a
# backward a layer
HYBRID_PER_STEP = {"rglru": 6, "rglru_bwd": 4, "flash_attention": 2,
                   "flash_attention_bwd": 1}


def phase_train_hybrid(torch, np, counters: dict):
    """Phase 20: recurrentgemma-9b training at full width,
    TRAIN_HYBRID_LAYERS deep (one (rec, rec, attn) unit checkpointed as one
    function, then the (rec, rec) tail), one TRAIN_SEQ-token sequence,
    twice the window: one bf16 step on the kernel path against the plain
    path at phase 10's limits, the step's operator rows, then
    ``trainer_run``. Returns (launches of the Trainer run, numbers)."""
    import gc
    model, data, batch, opt, tag = train_setup(torch, "recurrentgemma-9b",
                                               TRAIN_HYBRID_LAYERS)
    loss_k, grads_k, loss_p, grads_p, launches = step_vs_plain(
        torch, counters, HYBRID_PER_STEP, model, batch, tag)
    g = step_gaps(torch, model, loss_k, grads_k, loss_p, grads_p, opt)
    step_nums = hold_step(g, loss_k, loss_p, tag, "in bfloat16", launches)
    del grads_k, grads_p, g
    gc.collect()
    torch.cuda.empty_cache()
    step_nums["step_ops"] = op_rows(
        torch, lambda: train_step_grads(torch, model, batch), reps=1)
    print(f"{tag} operators (device ms per step): {step_nums['step_ops']}",
          flush=True)
    return trainer_run(torch, np, counters, HYBRID_PER_STEP, model, data,
                       batch, opt, tag, step_nums)


# ------------------------------- phases 21 and 22: the audio family, uncut

AUDIO_BATCH = 4            # prefill: 4 x (1,500 frames, 448 tokens)
AUDIO_SEQ = 448            # whisper's decoder context
AUDIO_TRAIN_BATCH = 8      # training: 8 x (1,500 frames, 448 tokens)
# a prefill: each encoder layer's self attention, each decoder layer's
# self and cross attention, once
AUDIO_PREFILL = {"flash_attention": 36}
# a step under remat "full": each of those 36 attentions in the forward
# and again in its layer's recompute, and one backward each
AUDIO_PER_STEP = {"flash_attention": 72, "flash_attention_bwd": 36}
# What the bf16 step can be held to. The q and k projections' gradients of
# whisper's upper decoder layers are ill-conditioned: a key's gradient is
# sum_q dS_qk q_q and each query's dS sums to zero over the keys, so dK's
# sum over positions vanishes and wk's gradient sees only how the layer's
# normed input varies across positions; by decoder layer 11 the residual
# stream carries a large component common to every position (the cross
# attention over the one encoder output adds nearly the same vector to
# each), and the bfloat16 backward kernel rounds dS before dK = dS^T Q,
# which breaks the zero sum by ~2^-9 of each term. Measured on an H100
# (700 W) on this step, gradient gaps to the float32 step's as a share of
# the leaf's largest magnitude: dec_layers.11.attn.wk 5.6e-2 on the kernel
# path, 1.4e-2 on the plain path (which keeps P and dS in float32), 6.9e-2
# between the two paths. So phase 10's gradient limit does not hold
# between two bf16 paths here.
# Within one call the same holds for dQ = scale dS K where the keys share
# a large common component (the cross attention's, and the upper layers'
# self attention's): K3''s dq on the step's own inputs lies up to 1.35e-1
# of its largest magnitude from the float32 attention_bwd_ref, while dk and
# dv stay within 6.3e-3 (tests/test_torch_audio_train.py shows the effect
# on the CPU). The bf16 step is held to phase 10's loss and AdamW-update
# limits against the plain path, and every K3 and K3' call in it to its
# plain version on the inputs the step gave it, K3' to the one with its
# roundings (K3_TOL, LSE_TOL, K3B_TOL; see hold_attention_calls); the
# per-leaf gradient gaps to the plain path are printed, and each path's
# gradient gaps to the float32 step's. The same step in float32 (the bf16
# weights widened) is held to all of phase 10's limits.


@contextlib.contextmanager
def kept_attention_bwd_calls(log: list):
    """Keep in ``log``, for every K3' call of the kernel path, its inputs
    (q, k, v, the forward's o and log-sum-exp, dO, the mask's keywords)
    and its outputs, each a copy in its own layout."""
    from unittest import mock
    from repro_torch.kernels.flash_attention import ops
    bwd = ops.flash_attention_bwd

    def kept(q, k, v, o, lse, do, **kw):
        out = bwd(q, k, v, o, lse, do, **kw)
        log.append(dict(args=[t.detach().clone()
                              for t in (q, k, v, o, lse, do)], kw=kw,
                        out=[t.detach().clone() for t in out]))
        return out
    with mock.patch.object(ops, "flash_attention_bwd", kept):
        yield


def hold_attention_calls(torch, calls: list, tag: str) -> dict:
    """Every kept K3' call (``kept_attention_bwd_calls``) on its own
    inputs: the forward's o within K3_TOL (as a share of its largest
    magnitude) and its log-sum-exp within LSE_TOL of ``attention_ref``'s;
    dq, dk, dv within K3B_TOL of ``attention_bwd_ref`` with the kernel's
    operand roundings (``bf16_operands``: P and dS in bfloat16) fed the
    kernel's o and lse. Their gaps to the float32 ``attention_bwd_ref``
    (fed the plain forward's o and lse, phase 9's comparison) are
    printed: dq's is the ill-conditioned one (see the note above
    AUDIO_PER_STEP). Returns the worst gaps."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_ref)
    worst = dict(o=0.0, lse=0.0, grads=0.0)
    fp32 = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    rounded_dq = 0.0          # the roundings' own dq gap to float32
    for i, c in enumerate(calls):
        q, k, v, o, lse, do = c["args"]
        dname = str(q.dtype).split(".")[-1]
        what = f"{tuple(q.shape)}, {tuple(k.shape)}, {c['kw']}"
        o_ref, lse_ref = attention_ref(q, k, v, return_lse=True, **c["kw"])
        e_o, e_lse = rel_err(o, o_ref), max_abs_err(lse, lse_ref)
        check(e_o <= K3_TOL[dname] and e_lse <= LSE_TOL,
              f"{tag}: K3 on the inputs of backward call {i} ({what}) "
              f"differs from attention_ref: o {e_o:.3e}, lse {e_lse:.3e}")
        worst["o"], worst["lse"] = max(worst["o"], e_o), max(worst["lse"],
                                                               e_lse)
        want = attention_bwd_ref(q, k, v, o, lse, do,
                                 bf16_operands=dname == "bfloat16",
                                 **c["kw"])
        exact = attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **c["kw"])
        for n, got, w, x in zip(("dq", "dk", "dv"), c["out"], want, exact):
            e = rel_err(got, w)
            check(e <= K3B_TOL[dname], f"{tag}: K3' call {i} ({what}) "
                  f"differs from attention_bwd_ref with its roundings in "
                  f"{n} by {e:.3e}")
            worst["grads"] = max(worst["grads"], e)
            fp32[n] = max(fp32[n], rel_err(got, x))
        rounded_dq = max(rounded_dq, rel_err(want[0], exact[0]))
        del o_ref, lse_ref, want, exact
    print(f"{tag} step in bfloat16: each of its {len(calls)} K3' calls on "
          f"its own inputs within {worst['grads']:.3e} of "
          f"attention_bwd_ref with the kernel's roundings (tol "
          f"{K3B_TOL['bfloat16']}; the float32 one's largest gaps, not "
          f"gated: " + ", ".join(f"{n} {e:.3e}" for n, e in fp32.items())
          + f"; the plain version with the roundings: dq {rounded_dq:.3e}"
          f"), the forward's o within {worst['o']:.3e} (tol "
          f"{K3_TOL['bfloat16']}) and its lse within {worst['lse']:.3e} "
          f"(tol {LSE_TOL}) of attention_ref", flush=True)
    return {**{f"k3_call_{k}_err": v for k, v in worst.items()},
            **{f"k3_call_{k}_vs_fp32": v for k, v in fp32.items()},
            "rounded_dq_vs_fp32": rounded_dq}


def phase_train_audio(torch, np, counters: dict):
    """Phase 22: whisper-small training at full width and depth,
    AUDIO_TRAIN_BATCH x (1,500 seeded frames, AUDIO_SEQ tokens) a step,
    remat "full": (a) one bf16 step on the kernel path (AUDIO_PER_STEP
    launches) against the plain path (see the note above AUDIO_PER_STEP:
    the loss, the AdamW updates, and every K3/K3' call on its own
    inputs), then the same step in float32 held to phase 10's limits; (b) ``trainer_run`` in
    bf16. Returns (launches of the Trainer run, numbers)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.common import Policy
    from repro_torch.models.model import Model
    model, data, batch, opt, tag = train_setup(
        torch, "whisper-small", get_config("whisper-small").num_layers,
        seq=AUDIO_SEQ, batch=AUDIO_TRAIN_BATCH)
    calls = []
    with kept_attention_bwd_calls(calls):
        loss_k, grads_k, loss_p, grads_p, launches = step_vs_plain(
            torch, counters, AUDIO_PER_STEP, model, batch, tag)
    check(len(calls) == AUDIO_PER_STEP["flash_attention_bwd"],
          f"{tag}: {len(calls)} K3' calls kept, not one an attention")
    held = hold_attention_calls(torch, calls, tag)
    del calls
    g16 = step_gaps(torch, model, loss_k, grads_k, loss_p, grads_p, opt)
    check(g16["loss_err"] <= LOSS_REL_TOL, f"{tag}: bf16 loss "
          f"{float(loss_k)} vs plain {float(loss_p)} ({g16['loss_err']:.3e})")
    check(g16["update_cos"] >= UPDATE_COS
          and g16["update_flip"] <= UPDATE_FLIP,
          f"{tag}: bf16 AdamW updates' cosine {g16['update_cos']:.5f} (< "
          f"{UPDATE_COS}?) or share of entries whose update changes sign "
          f"{g16['update_flip']:.3e} (> {UPDATE_FLIP}?)")
    print(f"{tag} step in bfloat16, kernel vs plain path: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f} ({g16['loss_err']:.3e},"
          f" limit {LOSS_REL_TOL}); AdamW updates (lr {g16['lr']:.3e}): "
          f"cosine {g16['update_cos']:.6f} (limit {UPDATE_COS}), "
          f"{g16['update_flip']:.3e} of entries change sign (limit "
          f"{UPDATE_FLIP}); not gated (see the note above AUDIO_PER_STEP): "
          f"gradients within {g16['grad_err']:.3e} of their largest "
          f"magnitude (worst {g16['worst']}); launches {launches}",
          flush=True)
    grads_k = {n: t.cpu() for n, t in grads_k.items()}
    grads_p = {n: t.cpu() for n, t in grads_p.items()}
    gc.collect()
    torch.cuda.empty_cache()

    f32 = Model(model.cfg, Policy(compute_dtype=torch.float32),
                device="cuda", seed=None, remat="full")
    with torch.no_grad():
        for (_, a), (_, b) in zip(f32.named_parameters(),
                                  model.named_parameters()):
            a.copy_(b)
    for p in f32.parameters():
        p.requires_grad_(True)
    lk, gk, lp, gp, l32 = step_vs_plain(torch, counters, AUDIO_PER_STEP, f32,
                                        batch, tag)
    step_nums = hold_step(step_gaps(torch, f32, lk, gk, lp, gp, opt), lk,
                          lp, tag, "in float32 (the bf16 weights widened)",
                          l32)
    del gk
    kf = {n: rel_err(grads_k[n].cuda(), gp[n]) for n in gp}
    pf = {n: rel_err(grads_p[n].cuda(), gp[n]) for n in gp}
    top = sorted(kf, key=kf.get, reverse=True)[:5]
    print(f"{tag}: each gradient's gap to the float32 plain step, bf16 "
          f"kernel path | bf16 plain path (the five largest kernel gaps): "
          + ", ".join(f"{n} {kf[n]:.3e} | {pf[n]:.3e}" for n in top)
          + f"; largest plain gap {max(pf.values()):.3e} "
          f"({max(pf, key=pf.get)})", flush=True)
    step_nums.update(
        bf16_loss_err=g16["loss_err"], bf16_grad_err=g16["grad_err"],
        bf16_worst=g16["worst"], bf16_update_cos=g16["update_cos"],
        bf16_update_flip=g16["update_flip"],
        bf16_kernel_vs_fp32=max(kf.values()),
        bf16_plain_vs_fp32=max(pf.values()), **held)
    del f32, gp, grads_k, grads_p
    gc.collect()
    torch.cuda.empty_cache()
    return trainer_run(torch, np, counters, AUDIO_PER_STEP, model, data,
                       batch, opt, tag, step_nums)


# ------------------------ phases 23 and 24: the vlm family, at full width

# qwen2-vl-72b (72.7 B parameters, 145 GB in bf16) keeps its width and
# loses depth to fit one card: serving at 16 of its 80 layers (16.5 B
# parameters, 33 GB in bf16; the plain path's (64, 4,096, 4,096) float32
# scores are 4.3 GB a call), training at 1 (3.37 B parameters, 54 GB at 16
# B a parameter: the untied embedding and head alone are 2.49 B, and each
# layer adds 0.88 B, 14 GB). Every sequence opens with a VLM_GRID image of
# seeded patch embeddings, in Qwen2-VL's M-RoPE layout.
VLM_SERVE_LAYERS = 16
VLM_TRAIN_LAYERS = 1
# a step under remat "full": the layer's attention in the forward and in
# the recompute, and one backward
VLM_PER_STEP = {"flash_attention": 2 * VLM_TRAIN_LAYERS,
                "flash_attention_bwd": VLM_TRAIN_LAYERS}
# The Trainer's peak learning rate. At any lr tried (3e-5 to 3e-4) the
# loss jumps after the first AdamW steps (12.53 -> 37.61 at TRAIN_LR): an
# update of +-lr on every entry moves each position's residual along the
# sign pattern of the frequent targets' head rows, and past the final
# RMSNorm the top logit stands ~56 above the median (4.4 at init), with
# or without the image. The reference's Trainer jumps alike at d 4,096 on
# the CPU (``tests/vlm_first_steps.py``), and steps 2 and 3 are held
# against the plain path (VLM_LATER_STEPS). What the lr sets is whether 12
# steps recover: at TRAIN_LR the last loss, 13.33, lies above the first;
# at 1e-4, TRAIN_LR scaled by width as Adam's learning rates transfer
# (x 2,560 / 8,192 from qwen3-4b), it is 7.44 (measured on an H100, 700 W;
# PERF.md section 6).
VLM_PEAK_LR = 1e-4
# Trainer steps after the first held kernel path against plain path
VLM_LATER_STEPS = 2


# ------------------------------ phase 25: tensor parallelism, four ranks

TP_RANKS = 4               # the ("data", "model") mesh (1, 4) on one card
TP_SEQ = 4096
# (a)'s decode steps and (b)'s Trainer steps, cut from 8 and 3, and (f)'s
# training batch (TP_PARTS), cut from 4, keep the phase within 180 s with
# parts (d)-(f), which took it to 169.0 s on an H100 before the cuts;
# ``phase_tp`` prints them
TP_DECODE_STEPS = 4        # at positions 4,092-4,095 of the prefill's cache
TP_TRAIN_STEPS = 2
TP_JOIN_S = 480.0          # the ranks' limit; a collective's is TP_WAIT_S
TP_WAIT_S = 240.0
# launches a rank: a K3 a layer in the prefill; forward, remat and one K3'
# a layer in a training step (the moe family's dense0 outside the remat)
TP_PREFILL = {"flash_attention": 36}
TP_PER_STEP = {"flash_attention": 2 * TRAIN_LAYERS,
               "flash_attention_bwd": TRAIN_LAYERS}
TP_MOE_PER_STEP = {"flash_attention": 2 * MOE_TRAIN_LAYERS - 1,
                   "flash_attention_bwd": MOE_TRAIN_LAYERS}


def tp_counters():
    """This process's launch counters, by kernel."""
    from repro_torch.kernels.fleet_score import COUNTER as C1
    from repro_torch.kernels.flash_attention import BWD_COUNTER as C3B
    from repro_torch.kernels.flash_attention import COUNTER as C3
    from repro_torch.kernels.rglru import BWD_COUNTER as C5B
    from repro_torch.kernels.rglru import COUNTER as C5
    from repro_torch.kernels.sweep_burn import COUNTER as C2
    from repro_torch.kernels.wkv6 import BWD_COUNTER as C4B
    from repro_torch.kernels.wkv6 import COUNTER as C4
    return {"fleet_score": C1, "sweep_burn": C2, "flash_attention": C3,
            "flash_attention_bwd": C3B, "wkv6": C4, "wkv6_bwd": C4B,
            "rglru": C5, "rglru_bwd": C5B}


def tp_tokens(torch, np, vocab: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (1, n))).cuda()


def tp_references(torch, np, d: Path) -> dict:
    """Phase 25's unsharded runs on the kernel path, saved under ``d`` for
    the ranks: (a) qwen3-4b uncut, a prefill of TP_SEQ tokens (logits and
    caches) and TP_DECODE_STEPS decode steps over the prefill's cache from
    position TP_SEQ - TP_DECODE_STEPS (each overwrites its row); (b)
    qwen3-4b at TRAIN_LAYERS layers, one step's loss and gradients, and
    the losses of a ``Trainer`` of TP_TRAIN_STEPS steps. Returns their
    times."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.train import TrainConfig, Trainer
    cfg = get_config("qwen3-4b")
    model = Model(cfg, device="cuda", seed=0)
    tokens = tp_tokens(torch, np, cfg.vocab_size, TP_SEQ, 7)
    steps = tp_tokens(torch, np, cfg.vocab_size, TP_DECODE_STEPS, 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    torch.save({"tokens": tokens.cpu(), "steps": steps.cpu(),
                "logits": logits.cpu(), "k": cache["layers"][0].cpu(),
                "v": cache["layers"][1].cpu()}, d / "serve.pt")
    cache["pos"] = TP_SEQ - TP_DECODE_STEPS
    decode = []
    for i in range(TP_DECODE_STEPS):
        decode.append(model.decode_step(steps[:, i], cache)[0].cpu())
    torch.save(decode, d / "decode.pt")
    del model, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    model, data, batch, opt, tag = train_setup(torch, "qwen3-4b",
                                               TRAIN_LAYERS)
    loss, grads = train_step_grads(torch, model, batch)
    torch.save({"loss": float(loss),
                "grads": {n: g.cpu() for n, g in grads.items()}},
               d / "step.pt")
    del grads
    trainer = Trainer(model, data, TrainConfig(
        steps=TP_TRAIN_STEPS, ckpt_interval=10 ** 9, opt=opt))
    hist = trainer.run()["history"]
    torch.save([h["loss"] for h in hist], d / "losses.pt")
    out = {"prefill_ms": prefill_ms,
           "step_ms": float(np.median([h["wall_s"] for h in hist[1:]]))
           * 1e3}
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_gloo_cuda(torch) -> dict:
    """Which collectives the gloo world group runs on CUDA tensors here
    (the torch docs: broadcast and all_reduce only)."""
    import torch.distributed as tdist
    from repro_torch.dist import api as dist
    out = {}
    x = torch.ones(4, device="cuda")
    for name, fn in (
            ("all_reduce", lambda: tdist.all_reduce(x)),
            ("broadcast", lambda: tdist.broadcast(x, 0)),
            ("all_gather_single", lambda: dist.all_gather_single(
                torch.empty(4 * TP_RANKS, device="cuda"), x)),
            ("all_to_all_single", lambda: tdist.all_to_all_single(
                torch.empty(4, device="cuda"), x))):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "runs"
        except (RuntimeError, ValueError) as e:
            out[name] = f"{type(e).__name__}: {str(e)[:80]}"
    tdist.barrier()
    return out


def profiled_call(torch, fn):
    """``fn()`` once under ``torch.profiler``: (its result, host-clock ms
    ending in a synchronize, the device's busy ms: the sum of the call's
    kernel times, the five kernels with the most device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)     # the tracer's first kernel
        torch.cuda.synchronize()                 # may be lost: not fn's
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    top = sorted(rows, key=lambda r: -r[1])[:5]
    return (out, wall, sum(t for _, t in rows) / 1e3,
            [(k[:60], round(t / 1e3, 4)) for k, t in top])


def tp_span(torch, got, want) -> tuple:
    """(max |got - want|, max |want|) over ``got``'s elements."""
    g, w = got.float(), want.float().to(got.device)
    return float((g - w).abs().max()), float(w.abs().max())


def tp_serve(torch, np, d: Path, mesh, counters: dict, rank: int) -> dict:
    """Phase 25(a) on one rank: qwen3-4b uncut under the mesh, the prefill
    and decode steps of ``tp_references``, held against them."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.dist import api as dist
    from repro_torch.models.model import Model
    ref = torch.load(d / "serve.pt", mmap=True)
    cfg = get_config("qwen3-4b")
    with dist.use_mesh(mesh):
        model = Model(cfg, device="cuda", seed=0)
        tokens, steps = ref["tokens"].cuda(), ref["steps"].cuda()
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        (logits, cache), prefill_ms, busy, top = profiled_call(
            torch, lambda: model.prefill(tokens))
        launches = {n: c.launches for n, c in counters.items()}
        V = cfg.vocab_size
        spans = {"logits": tp_span(torch, logits[..., :V],
                                   ref["logits"][..., :V])}
        out = {"launches": launches, "prefill_ms": prefill_ms,
               "busy_ms": busy, "top": top, "kv_shards": cache["kv_shards"],
               "spans": spans}
        n = TP_SEQ // cache["kv_shards"]
        part = slice(rank * n, (rank + 1) * n)
        for name, got in zip("kv", cache["layers"]):
            want = ref[name][:, :, :, part]
            spans[f"{name} cache"] = tp_span(torch, got, want)
            spans[f"{name} cache layer 1"] = tp_span(torch, got[1], want[1])
        cache["pos"] = TP_SEQ - TP_DECODE_STEPS
        decode = torch.load(d / "decode.pt")
        walls = []
        for i in range(TP_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = model.decode_step(steps[:, i], cache)[0]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            spans[f"decode {i}"] = tp_span(torch, got, decode[i])
        out["decode_ms"] = float(np.median(walls)) * 1e3
        out["decode_launches"] = {n: c.launches - launches[n]
                                  for n, c in counters.items()}
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del cache, logits
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_train(torch, np, d: Path, mesh, counters: dict) -> dict:
    """Phase 25(b) on one rank: qwen3-4b at TRAIN_LAYERS layers under the
    mesh, one step's loss and gradients (this rank's slice of each) and
    AdamW updates against ``tp_references``', then a ``Trainer`` of
    TP_TRAIN_STEPS steps with a ``GuardStepHook``, its losses against the
    unsharded Trainer's."""
    import gc
    from repro_torch.dist import api as dist
    from repro_torch.guard import GuardStepHook
    from repro_torch.train import TrainConfig, Trainer
    ref = torch.load(d / "step.pt", mmap=True)
    with dist.use_mesh(mesh):
        model, data, batch, opt, tag = train_setup(torch, "qwen3-4b",
                                                   TRAIN_LAYERS)
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        (loss, grads), wall, busy, top = profiled_call(
            torch, lambda: train_step_grads(torch, model, batch))
        launches = {n: c.launches for n, c in counters.items()}
        want = {n: model.tp_slice(n, g) for n, g in ref["grads"].items()}
        gaps = step_gaps(torch, model, loss, grads, ref["loss"], want, opt)
        out = {"step_launches": launches, "loss": float(loss),
               "profiled_step_ms": wall, "busy_ms": busy, "top": top,
               **{k: v for k, v in gaps.items() if k != "gaps"}}
        del grads, want
        gc.collect()
        torch.cuda.empty_cache()
        hook = GuardStepHook(window_steps=1, device="cuda")
        trainer = Trainer(model, data, TrainConfig(
            steps=TP_TRAIN_STEPS, ckpt_interval=10 ** 9, opt=opt), hook=hook)
        for c in counters.values():
            c.reset()
        hist = trainer.run()["history"]
        out.update(
            run_launches={n: c.launches for n, c in counters.items()},
            frames=hook.frames_fed, losses=[h["loss"] for h in hist],
            step_ms=float(np.median([h["wall_s"] for h in hist[1:]])) * 1e3,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del trainer, model, hook
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_moe(torch, np, mesh, counters: dict) -> dict:
    """Phase 25(c) on one rank: deepseek-moe-16b at MOE_TRAIN_LAYERS layers
    under the mesh (E / 4 experts a rank, through the all_to_all): one
    prefill and one training step on the kernel path against the plain
    path under the same mesh, on the kernel path's routing, at phases
    15-16's limits."""
    import gc
    from repro_torch.dist import api as dist
    with dist.use_mesh(mesh):
        model, data, batch, opt, tag = train_setup(
            torch, "deepseek-moe-16b", MOE_TRAIN_LAYERS)
        tag += f" at (1, {TP_RANKS}), rank {mesh.get_local_rank('model')}"
        tokens = tp_tokens(torch, np, model.cfg.vocab_size, TP_SEQ, 9)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            launches, secs, nums = moe_prefill_vs_plain(
                torch, model, model.cfg, tokens, counters, tag)
        routes = []
        loss_k, grads_k, loss_p, grads_p, step_l = step_vs_plain(
            torch, counters, TP_MOE_PER_STEP, model, batch, tag, routes)
        dropped = [int((~k).sum()) for _, _, k in
                   routes[:MOE_TRAIN_LAYERS - 1]]
        g = step_gaps(torch, model, loss_k, grads_k, loss_p, grads_p, opt)
        step = hold_step(g, loss_k, loss_p, tag,
                         "in bfloat16, on the kernel path's routing", step_l)
        del grads_k, grads_p, routes
        _, step_ms, busy, _ = profiled_call(
            torch, lambda: train_step_grads(torch, model, batch))
        out = {"prefill_launches": launches, "prefill_ms": secs * 1e3,
               "step_launches": step_l, "step_ms": step_ms,
               "busy_ms": busy,
               "dropped_prefill": nums["dropped"],
               "dropped_step": dropped, "experts": int(model.layers[0].moe
                                                       .wi.shape[0]),
               "prefill_errs": {k: v for k, v in nums.items()
                                if k.endswith("_err")},
               "step": {k: v for k, v in step.items() if k != "worst"},
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 25 (d)-(f): the ssm, hybrid and audio families under the same
# (1, 4) mesh, each at its published width with its depth cut (the four
# ranks and the unsharded run share one card). Per part: the model served
# (``serve_layers`` deep) to a prefill of ``batch`` x ``seq`` tokens (the
# audio family's with seeded frames) and ``decode`` steps from its cache,
# held against the unsharded kernel path's logits and cache (gathered into
# its layout, ``convert.whole_cache``) at PATH_REL_TOL; one training step
# (``train_layers`` deep, ``train_batch`` x ``train_seq`` tokens) in bf16,
# its loss within LOSS_REL_TOL of the unsharded step's, and where the bf16
# step is well-conditioned (the hybrid family, PERF.md section 2) its
# gradients and AdamW updates at phase 10's limits; where it is not (rwkv6
# and whisper: phases 13(b) and 22) each K4/K4' or K3' call of the step
# against its plain version on the call's own inputs, whisper's AdamW
# updates at phase 10's limits, and the same step in float32 (the bf16
# weights widened) against the unsharded float32 step at all of them.
# ``launches`` are a rank's, ``shapes`` the per-rank shapes each kernel
# must see (model layout: K4's r (B, S, H, hd), K5's xb (B, S, W), K3's q
# and k (B, S, H, hd); ``step_shapes`` where a step's differ).
TP_PARTS = {
    "ssm": dict(arch="rwkv6-7b", serve_layers=8, batch=1, seq=2048,
                decode=4, train_layers=4, train_batch=1, train_seq=2048,
                prefill={"wkv6": 8}, step={"wkv6": 8, "wkv6_bwd": 4},
                shapes={"wkv6": [(1, 2048, 16, 64)]}, fp32=True),
    "hybrid": dict(arch="recurrentgemma-9b", serve_layers=5, batch=1,
                   seq=4096, decode=4, train_layers=3, train_batch=1,
                   train_seq=4096, prefill={"rglru": 4, "flash_attention": 1},
                   step={"rglru": 4, "rglru_bwd": 2, "flash_attention": 2,
                         "flash_attention_bwd": 1},
                   shapes={"rglru": [(1, 4096, 1024)],
                           "flash_attention": [(1, 4096, 4, 256),
                                               (1, 4096, 1, 256)]},
                   fp32=False),
    "audio": dict(arch="whisper-small", serve_layers=12, batch=AUDIO_BATCH,
                  seq=AUDIO_SEQ, decode=2, train_layers=12,
                  train_batch=2, train_seq=AUDIO_SEQ,
                  prefill=AUDIO_PREFILL, step=AUDIO_PER_STEP,
                  shapes={"flash_attention": [
                      (AUDIO_BATCH, 1500, 3, 64),
                      (AUDIO_BATCH, AUDIO_SEQ, 3, 64)]},
                  step_shapes={"flash_attention": [(2, 1500, 3, 64),
                                                   (2, AUDIO_SEQ, 3, 64)]},
                  fp32=True),
}


@contextlib.contextmanager
def kernel_shapes(log: dict):
    """Record in ``log`` (kernel -> set of shapes) the shapes of the first
    operands the model hands each kernel's entry point: K4's r, K5's xb,
    K3's q and k."""
    from unittest import mock
    import repro_torch.models.attention as attention
    import repro_torch.models.rglru as rglru
    import repro_torch.models.rwkv6 as rwkv6

    def rec(name, fn, n):
        def wrapped(*args, **kw):
            log.setdefault(name, set()).update(
                tuple(a.shape) for a in args[:n])
            return fn(*args, **kw)
        return wrapped
    with mock.patch.object(rwkv6, "wkv6", rec("wkv6", rwkv6.wkv6, 1)), \
            mock.patch.object(rglru, "lru_scan",
                              rec("rglru", rglru.lru_scan, 1)), \
            mock.patch.object(attention, "flash",
                              rec("flash_attention", attention.flash, 2)):
        yield


def cache_leaves(cache, prefix: str = "") -> dict:
    """A decode cache's tensors by "/"-joined path ("pos", "kv_shards"
    left out)."""
    if isinstance(cache, dict):
        items = [(k, v) for k, v in cache.items()
                 if k not in ("pos", "kv_shards")]
    elif isinstance(cache, (list, tuple)):
        items = list(enumerate(cache))
    else:
        return {prefix[:-1]: cache}
    out = {}
    for k, v in items:
        out.update(cache_leaves(v, f"{prefix}{k}/"))
    return out


def tp_part_inputs(torch, np, cfg, spec: dict) -> dict:
    """A part's seeded prefill tokens (batch x seq), decode tokens (batch x
    decode) and, for the audio family, encoder frames, on the host."""
    rng = np.random.default_rng(10)
    b = spec["batch"]
    out = {"tokens": torch.from_numpy(rng.integers(
               0, cfg.vocab_size, (b, spec["seq"]))),
           "steps": torch.from_numpy(rng.integers(
               0, cfg.vocab_size, (b, spec["decode"])))}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32))
    return out


def tp_part_references(torch, np, d: Path, name: str) -> dict:
    """Part ``name`` of phase 25 (d)-(f) unsharded on the kernel path,
    saved under ``d`` for the ranks: the prefill's logits and cache, the
    decode steps' logits (from position seq - decode of the audio family's
    self cache, each step overwriting its row; the others go on from the
    prefill), and the bf16 step's loss and gradients (and the float32
    step's where ``fp32``). Returns their times."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import Policy
    from repro_torch.models.model import Model
    spec = TP_PARTS[name]
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              num_layers=spec["serve_layers"])
    model = Model(cfg, device="cuda", seed=0)
    inp = tp_part_inputs(torch, np, cfg, spec)
    fwd = {"enc_frames": inp["frames"].cuda()} if "frames" in inp else {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(inp["tokens"].cuda(), **fwd)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    saved = {**inp, "logits": logits.cpu(),
             "cache": {k: t.to("cpu", copy=True)
                       for k, t in cache_leaves(cache).items()}}
    if cfg.is_encoder_decoder:
        cache["pos"] = spec["seq"] - spec["decode"]
    saved["pos"] = cache["pos"]
    saved["decode"] = [model.decode_step(inp["steps"][:, i].cuda(),
                                         cache)[0].cpu()
                       for i in range(spec["decode"])]
    torch.save(saved, d / f"{name}_serve.pt")
    del model, cache, logits, saved
    gc.collect()
    torch.cuda.empty_cache()
    model, _, batch, _, _ = train_setup(
        torch, spec["arch"], spec["train_layers"], seq=spec["train_seq"],
        batch=spec["train_batch"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = train_step_grads(torch, model, batch)
    step_ms = (time.perf_counter() - t0) * 1e3
    step = {"loss": float(loss)}
    if name != "ssm":            # its bf16 gradients hold nothing (13(b))
        step["grads"] = {n: g.cpu() for n, g in grads.items()}
    del grads
    if spec["fp32"]:
        f32 = widened(torch, model)
        del model
        loss32, grads32 = train_step_grads(torch, f32, batch)
        step.update(loss32=float(loss32),
                    grads32={n: g.cpu() for n, g in grads32.items()})
        del f32, grads32
    else:
        del model
    torch.save(step, d / f"{name}_step.pt")
    del step
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "step_ms": step_ms}


def widened(torch, model):
    """``model`` in float32: its bf16 weights widened into a model of the
    same config and mesh (the rank's slices under tensor parallelism),
    each weight wanting a gradient."""
    from repro_torch.models.common import Policy
    from repro_torch.models.model import Model
    f32 = Model(model.cfg, Policy(compute_dtype=torch.float32),
                device="cuda", seed=None, remat="full")
    with torch.no_grad():
        for (_, a), (_, b) in zip(f32.named_parameters(),
                                  model.named_parameters()):
            a.copy_(b)
    for p in f32.parameters():
        p.requires_grad_(True)
    return f32


def tp_part(torch, np, d: Path, mesh, counters: dict, name: str) -> dict:
    """Part ``name`` of phase 25 (d)-(f) on one rank (see TP_PARTS): the
    served model and the training step under the mesh, held against
    ``tp_part_references``'. Fails on a rank whose kernels launched other
    counts or saw other shapes, or whose numbers miss a limit."""
    from repro_torch.configs import get_config
    from repro_torch.convert import whole_cache
    from repro_torch.dist import api as dist
    from repro_torch.models.model import Model
    spec = TP_PARTS[name]
    ref = torch.load(d / f"{name}_serve.pt", mmap=True)
    cfg = dataclasses.replace(get_config(spec["arch"]),
                              num_layers=spec["serve_layers"])
    rank = mesh.get_local_rank("model")
    tag = f"(25 {name}) {spec['arch']} at (1, {TP_RANKS}), rank {rank}"

    def only(want):
        return {n: want.get(n, 0) for n in counters}

    def held(spans: dict, what: str) -> dict:
        errs = {k: e / max(m, 1e-30) for k, (e, m) in spans.items()}
        worst = max(errs, key=errs.get)
        check(errs[worst] <= PATH_REL_TOL, f"{tag}: {what} {worst} differs "
              f"from the unsharded kernel path by {errs[worst]:.3e} of its "
              f"largest magnitude (> {PATH_REL_TOL})")
        return {"worst": worst, "err": errs[worst]}

    def shaped(log: dict, what: str) -> None:
        want_shapes = spec["shapes"] if what == "prefill" else \
            spec.get("step_shapes", spec["shapes"])
        for kernel, want in want_shapes.items():
            got = sorted(log.get(kernel, ()))
            check(got == sorted(set(want)), f"{tag}: the {what} handed "
                  f"{kernel} {got}, not the rank's {sorted(set(want))}")
    out = {}
    with dist.use_mesh(mesh):
        model = Model(cfg, device="cuda", seed=0)
        fwd = {"enc_frames": ref["frames"].cuda()} if "frames" in ref \
            else {}
        for c in counters.values():
            c.reset()
        torch.cuda.reset_peak_memory_stats()
        shapes: dict = {}
        with kernel_shapes(shapes):
            (logits, cache), ms, busy, top = profiled_call(
                torch, lambda: model.prefill(ref["tokens"].cuda(), **fwd))
        launches = {n: c.launches for n, c in counters.items()}
        check(launches == only(spec["prefill"]), f"{tag}: the prefill "
              f"launched {launches}, not {spec['prefill']}")
        shaped(shapes, "prefill")
        V = cfg.vocab_size
        spans = {"logits": tp_span(torch, logits[..., :V],
                                   ref["logits"][..., :V])}
        whole = whole_cache(model, cache)
        for path, t in cache_leaves(whole).items():
            spans[f"cache {path}"] = tp_span(torch, t, ref["cache"][path])
        del whole
        out["prefill"] = dict(launches=launches, ms=ms, busy_ms=busy,
                              top=top, shapes={k: sorted(v) for k, v in
                                               shapes.items()},
                              **held(spans, "the prefill's"))
        cache["pos"] = ref["pos"]
        spans, walls = {}, []
        for i in range(spec["decode"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = model.decode_step(ref["steps"][:, i].cuda(), cache)[0]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            spans[f"decode {i}"] = tp_span(torch, got[..., :V],
                                           ref["decode"][i][..., :V])
        check(not any(c.launches - launches[n]
                      for n, c in counters.items()),
              f"{tag}: a decode step launched a kernel")
        out["decode"] = dict(ms=float(np.median(walls)) * 1e3,
                             **held(spans, "a decode step's"))
        out["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model, cache, logits, ref
        gc.collect()
        torch.cuda.empty_cache()
        out["step"] = tp_part_step(torch, d, counters, name, tag, only,
                                   shaped)
    return out


def tp_part_step(torch, d: Path, counters: dict, name: str, tag: str,
                 only, shaped) -> dict:
    """The training half of ``tp_part`` (under the mesh)."""
    spec = TP_PARTS[name]
    ref = torch.load(d / f"{name}_step.pt", mmap=True)
    model, _, batch, opt, _ = train_setup(
        torch, spec["arch"], spec["train_layers"], seq=spec["train_seq"],
        batch=spec["train_batch"])
    calls: list = []
    keep = {"ssm": kept_wkv6_bwd_calls, "audio": kept_attention_bwd_calls
            }.get(name)
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    shapes: dict = {}
    with keep(calls) if keep else contextlib.nullcontext(), \
            kernel_shapes(shapes):
        (loss, grads), ms, busy, top = profiled_call(
            torch, lambda: train_step_grads(torch, model, batch))
    launches = {n: c.launches for n, c in counters.items()}
    check(launches == only(spec["step"]), f"{tag}: a step launched "
          f"{launches}, not {spec['step']}")
    shaped(shapes, "step")
    loss_err = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    check(loss_err <= LOSS_REL_TOL, f"{tag}: the bf16 step's loss "
          f"{float(loss)} vs the unsharded {ref['loss']} ({loss_err:.3e})")
    out = dict(launches=launches, ms=ms, busy_ms=busy, top=top,
               loss_err=loss_err)
    if name == "ssm":
        out.update(hold_wkv6_calls(torch, calls, tag))
    elif name == "audio":
        out.update(hold_attention_calls(torch, calls, tag))
    del calls
    if "grads" in ref:
        want = {n: model.tp_slice(n, g) for n, g in ref["grads"].items()}
        g = step_gaps(torch, model, loss, grads, ref["loss"], want, opt)
        if spec["fp32"]:        # ill-conditioned in bf16: the updates only
            check(g["update_cos"] >= UPDATE_COS
                  and g["update_flip"] <= UPDATE_FLIP,
                  f"{tag}: bf16 AdamW updates' cosine {g['update_cos']:.5f}"
                  f" or sign changes {g['update_flip']:.3e} against the "
                  f"unsharded step's")
            out.update(bf16_update_cos=g["update_cos"],
                       bf16_update_flip=g["update_flip"],
                       bf16_grad_err=g["grad_err"])
        else:
            out.update(hold_step(g, loss, ref["loss"], tag, "in bfloat16",
                                 launches, "sharded vs unsharded"))
        del want, g
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    if spec["fp32"]:
        f32 = widened(torch, model)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        loss32, grads32 = train_step_grads(torch, f32, batch)
        want = {n: f32.tp_slice(n, g) for n, g in ref["grads32"].items()}
        g = step_gaps(torch, f32, loss32, grads32, ref["loss32"], want, opt)
        out["fp32"] = hold_step(g, loss32, ref["loss32"], tag, "in float32 "
                                "(the bf16 weights widened)", launches,
                                "sharded vs unsharded")
        del f32, grads32, want, g
    else:
        del model
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_rank(rank: int, d: str) -> None:
    """One rank of phase 25: a gloo process group of TP_RANKS ranks, all on
    cuda:0 (NCCL refuses two ranks on one device), the (1, 4) mesh, parts
    (a)-(c), then the ssm, hybrid and audio parts (d)-(f); writes
    ``rank<r>.json``. A failed check or an exception
    prints its traceback and exits non-zero."""
    import numpy as np
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, str(ROOT / "src"))
    PHASE["label"] = f"25 rank {rank}"
    d = Path(d)
    torch.cuda.set_device(0)
    # a rank that fails exits; the others' collectives then give up
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(d / "store"), TP_RANKS),
        rank=rank, world_size=TP_RANKS,
        timeout=datetime.timedelta(seconds=TP_WAIT_S))
    try:
        from repro_torch.dist import api as dist
        from repro_torch.launch.mesh import _make_mesh
        counters = tp_counters()
        out = {"gloo_cuda": tp_gloo_cuda(torch)}
        mesh = _make_mesh((1, TP_RANKS), ("data", "model"), "cuda")
        tp = dist.tp_group(dist.DistContext(mesh))
        out["model_rank"], out["host_copies"] = tp.rank, tp.host
        out["backend"] = tdist.get_backend(tp.group)
        for part, fn, args in (
                ("serve", tp_serve, (torch, np, d, mesh, counters, rank)),
                ("train", tp_train, (torch, np, d, mesh, counters)),
                ("moe", tp_moe, (torch, np, mesh, counters)),
                *((name, tp_part, (torch, np, d, mesh, counters, name))
                  for name in TP_PARTS)):
            t0 = time.perf_counter()
            out[part] = fn(*args)
            out[part]["seconds"] = time.perf_counter() - t0
            tdist.barrier()
        (d / f"rank{rank}.json").write_text(json.dumps(out))
    except Exception as e:           # noqa: BLE001 - named, then failed
        traceback.print_exc(file=sys.stdout)
        fail(f"{type(e).__name__}: {e}")
    finally:
        tdist.destroy_process_group()


def phase_tp(torch, np, card: str):
    """Phase 25: tensor parallelism over "model" in TP_RANKS ranks on one
    card. The unsharded references first (``tp_references``), then the
    ranks (``tp_rank``), then the checks over their reports: (a) the
    prefill's logits and the gathered caches, and each decode step's
    logits, at PATH_REL_TOL (layer 1's caches at FIRST_REL_TOL), K3 once a
    layer at per-rank heads; (b) one step's loss, gradients and AdamW
    updates at phase 10's limits, TP_TRAIN_STEPS Trainer steps' losses at
    LOSS_REL_TOL, K3 16 and K3' 8 a step, K1 once a Guard window; (c) the
    moe checks inside each rank (``tp_moe``); (d)-(f) the ssm, hybrid and
    audio families' checks inside each rank (``tp_part``), their numbers
    printed here. One card shows that the ranks compute the right thing,
    not how fast tensor parallelism is. Returns (rank 0's launches by
    part, numbers)."""
    import multiprocessing
    import tempfile
    tmp = tempfile.TemporaryDirectory(prefix="tp_")
    d = Path(tmp.name)
    try:
        ref = tp_references(torch, np, d)
        for name in TP_PARTS:
            t0 = time.perf_counter()
            ref[name] = tp_part_references(torch, np, d, name)
            ref[name]["seconds"] = time.perf_counter() - t0
        print(f"phase 25: the unsharded runs (a)-(f) in "
              f"{sum(ref[n]['seconds'] for n in TP_PARTS):.1f} s for "
              f"(d)-(f); cut for the phase's time: (a) {TP_DECODE_STEPS} "
              f"decode steps (was 8), (b) {TP_TRAIN_STEPS} Trainer steps "
              f"(was 3), (f) training at "
              f"{TP_PARTS['audio']['train_batch']} x (1,500 frames, "
              f"{AUDIO_SEQ} tokens) (was {AUDIO_BATCH}); the depths of "
              f"(d)-(f) as TP_PARTS gives them", flush=True)
        procs = [multiprocessing.get_context("spawn").Process(
            target=tp_rank, args=(r, str(d))) for r in range(TP_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_JOIN_S
        while any(p.is_alive() for p in procs) and \
                time.monotonic() < deadline and \
                not any(p.exitcode for p in procs):   # a rank failed
            time.sleep(0.5)
        hung = [r for r, p in enumerate(procs) if p.is_alive()
                and not any(q.exitcode for q in procs)]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        check(not hung, f"ranks {hung} did not finish within {TP_JOIN_S} s")
        codes = [p.exitcode for p in procs]
        check(codes == [0] * TP_RANKS, f"rank exit codes {codes}")
        facts = [json.loads((d / f"rank{r}.json").read_text())
                 for r in range(TP_RANKS)]
        losses = torch.load(d / "losses.pt")
    finally:
        tmp.cleanup()
    f0 = facts[0]
    print(f"phase 25 ({card}): {TP_RANKS} gloo ranks on cuda:0, mesh (1, "
          f"{TP_RANKS}); gloo on CUDA tensors: {f0['gloo_cuda']}; the "
          f"'model' group's backend is {f0['backend']}, so every "
          f"tensor-parallel collective copies through the host: "
          f"{f0['host_copies']}", flush=True)

    def worst(key):     # over the ranks: the gathered tensor's
        err = max(f["serve"]["spans"][key][0] for f in facts)
        return err / max(max(f["serve"]["spans"][key][1] for f in facts),
                         1e-30)
    a = {f"{k}_err": worst(k) for k in f0["serve"]["spans"]}
    for f in facts:
        check(f["serve"]["launches"] == {n: TP_PREFILL.get(n, 0)
                                         for n in f["serve"]["launches"]},
              f"rank {f['model_rank']}: the prefill launched "
              f"{f['serve']['launches']}, not {TP_PREFILL}")
        check(f["serve"]["kv_shards"] == TP_RANKS,
              f"rank {f['model_rank']}: the cache is not sequence-sharded")
        check(not any(f["serve"]["decode_launches"].values()),
              f"rank {f['model_rank']}: a decode step launched a kernel")
    for k, e in a.items():
        lim = FIRST_REL_TOL["dense"] if "layer 1" in k else PATH_REL_TOL
        check(e <= lim, f"(a) {k[:-4]} differs from the unsharded kernel "
                        f"path by {e:.3e} of its largest magnitude (> {lim})")
    sv = f0["serve"]
    print(f"(a) ({card}) qwen3-4b uncut, {TP_SEQ}-token prefill at (1, "
          f"{TP_RANKS}) "
          f"against the unsharded kernel path, max abs err / max abs over "
          f"the ranks (caches gathered): " + ", ".join(
              f"{k[:-4]} {v:.3e}" for k, v in a.items()) + f"; K3 "
          f"{sv['launches']['flash_attention']} launches a rank (q (1, 8, "
          f"{TP_SEQ}, 128), k/v (1, 2, {TP_SEQ}, 128)); prefill "
          f"{sv['prefill_ms']:.1f} ms under the profiler, the first call "
          f"(unsharded {ref['prefill_ms']:.1f}, the first call, no "
          f"profiler), rank 0's kernels {sv['busy_ms']:.1f} ms "
          f"({sv['busy_ms'] / sv['prefill_ms']:.0%}); flash-decode step median {sv['decode_ms']:.1f} ms; peak "
          f"{max(f['serve']['peak_gb'] for f in facts):.2f} GB a rank; top "
          f"kernels {sv['top']}", flush=True)
    tr = f0["train"]
    for f in facts:
        t = f["train"]
        want = {n: TP_PER_STEP.get(n, 0) for n in t["step_launches"]}
        check(t["step_launches"] == want, f"rank {f['model_rank']}: a "
              f"step launched {t['step_launches']}, not {want}")
        want = {n: TP_PER_STEP.get(n, 0) * TP_TRAIN_STEPS
                for n in t["run_launches"]}
        want["fleet_score"] = t["frames"]
        check(t["frames"] >= 1 and t["run_launches"] == want,
              f"rank {f['model_rank']}: the Trainer launched "
              f"{t['run_launches']}, not {want}")
        check(t["loss_err"] <= LOSS_REL_TOL and t["grad_err"] <= GRAD_REL_TOL
              and t["update_cos"] >= UPDATE_COS
              and t["update_flip"] <= UPDATE_FLIP,
              f"(b) rank {f['model_rank']}: loss gap {t['loss_err']:.3e}, "
              f"gradient {t['worst']} {t['grad_err']:.3e}, update cosine "
              f"{t['update_cos']:.5f}, sign changes {t['update_flip']:.3e} "
              f"(limits {LOSS_REL_TOL}, {GRAD_REL_TOL}, {UPDATE_COS}, "
              f"{UPDATE_FLIP})")
        gaps = [abs(x - y) / abs(y) for x, y in zip(t["losses"], losses)]
        check(len(gaps) == TP_TRAIN_STEPS and max(gaps) <= LOSS_REL_TOL,
              f"(b) rank {f['model_rank']}: Trainer losses {t['losses']} "
              f"against the unsharded {losses}")
    print(f"(b) ({card}) qwen3-4b at {TRAIN_LAYERS} layers, (1, "
          f"{TP_RANKS}), one "
          f"step against the unsharded step, worst rank: loss gap "
          f"{max(f['train']['loss_err'] for f in facts):.3e}, gradients "
          f"within {max(f['train']['grad_err'] for f in facts):.3e} of "
          f"their largest magnitude (each rank's slice), AdamW updates' "
          f"cosine {min(f['train']['update_cos'] for f in facts):.6f}, "
          f"{max(f['train']['update_flip'] for f in facts):.3e} change "
          f"sign; {TP_TRAIN_STEPS} Trainer steps, losses {tr['losses']} "
          f"(unsharded {losses}); step median {tr['step_ms']:.1f} ms "
          f"(unsharded {ref['step_ms']:.1f}); the held step under the "
          f"profiler {tr['profiled_step_ms']:.1f} ms (forward and backward, "
          f"no update), rank 0's kernels "
          f"{tr['busy_ms']:.1f} ms "
          f"({tr['busy_ms'] / tr['profiled_step_ms']:.0%}); launches a step "
          f"{tr['step_launches']}, fleet_score "
          f"{tr['run_launches']['fleet_score']} in {tr['frames']} Guard "
          f"windows; peak "
          f"{max(f['train']['peak_gb'] for f in facts):.2f} GB a rank; top "
          f"kernels {tr['top']}", flush=True)
    mo = f0["moe"]
    print(f"(c) ({card}) deepseek-moe-16b at {MOE_TRAIN_LAYERS} layers, "
          f"(1, {TP_RANKS}), {mo['experts']} experts a rank: prefill "
          f"{mo['prefill_ms']:.1f} ms, step {mo['step_ms']:.1f} ms under "
          f"the profiler (forward and backward), rank 0's kernels "
          f"{mo['busy_ms']:.1f} ms ({mo['busy_ms'] / mo['step_ms']:.0%}); "
          f"slots "
          f"dropped a rank (prefill, per MoE layer): "
          f"{[f['moe']['dropped_prefill'] for f in facts]}, (step) "
          f"{[f['moe']['dropped_step'] for f in facts]}; peak "
          f"{max(f['moe']['peak_gb'] for f in facts):.2f} GB a rank; ranks' "
          f"seconds (a, b, c) " + str([[round(f[p]["seconds"], 1) for p in
                                         ("serve", "train", "moe")]
                                        for f in facts]), flush=True)
    parts = {}
    for name, spec in TP_PARTS.items():
        p0 = f0[name]
        pre, dec, st = p0["prefill"], p0["decode"], p0["step"]
        fp32 = st.get("fp32", {})
        parts[name] = dict(
            prefill_ms=pre["ms"], prefill_busy_ms=pre["busy_ms"],
            decode_ms=dec["ms"], step_ms=st["ms"], step_busy_ms=st["busy_ms"],
            prefill_err=max(f[name]["prefill"]["err"] for f in facts),
            decode_err=max(f[name]["decode"]["err"] for f in facts),
            step_loss_err=max(f[name]["step"]["loss_err"] for f in facts),
            peak_gb=max(max(f[name]["serve_peak_gb"], f[name]["step"][
                "peak_gb"]) for f in facts),
            prefill_launches=pre["launches"], step_launches=st["launches"],
            shapes=pre["shapes"], unsharded=ref[name],
            seconds=[round(f[name]["seconds"], 1) for f in facts],
            **{k: v for k, v in st.items() if k not in (
                "launches", "ms", "busy_ms", "top", "loss_err", "peak_gb",
                "fp32")},
            **{f"fp32_{k}": v for k, v in fp32.items()})
        q = parts[name]
        print(f"({'def'[list(TP_PARTS).index(name)]}) ({card}) "
              f"{spec['arch']} at {spec['serve_layers']} layers served, "
              f"{spec['train_layers']} trained, (1, {TP_RANKS}): prefill "
              f"of {spec['batch']} x {spec['seq']} tokens "
              f"{q['prefill_ms']:.1f} ms under the profiler (unsharded "
              f"{ref[name]['prefill_ms']:.1f}), rank 0's kernels "
              f"{q['prefill_busy_ms']:.1f} ms "
              f"({q['prefill_busy_ms'] / q['prefill_ms']:.0%}); logits and "
              f"gathered caches within {q['prefill_err']:.3e} of the "
              f"unsharded kernel path's largest magnitude (worst "
              f"{pre['worst']}); {spec['decode']} decode steps, median "
              f"{q['decode_ms']:.1f} ms, within {q['decode_err']:.3e}; "
              f"kernels saw {q['shapes']}; launches a prefill "
              f"{q['prefill_launches']}; a bf16 step {q['step_ms']:.1f} ms "
              f"(unsharded {ref[name]['step_ms']:.1f}), rank 0's kernels "
              f"{q['step_busy_ms']:.1f} ms "
              f"({q['step_busy_ms'] / q['step_ms']:.0%}), launches "
              f"{q['step_launches']}, loss gap {q['step_loss_err']:.3e}"
              + (f", float32 step: loss gap {fp32['loss_err']:.3e}, "
                 f"gradients within {fp32['grad_err']:.3e} (worst "
                 f"{fp32['worst']}), update cosine {fp32['update_cos']:.6f}"
                 if fp32 else "")
              + f"; peak {q['peak_gb']:.2f} GB a rank; ranks' seconds "
              f"{q['seconds']}", flush=True)
    launches = {"prefill": sv["launches"], "train": tr["run_launches"],
                "moe_prefill": mo["prefill_launches"],
                "moe_step": mo["step_launches"],
                **{f"{n}_prefill": parts[n]["prefill_launches"]
                   for n in TP_PARTS},
                **{f"{n}_step": parts[n]["step_launches"]
                   for n in TP_PARTS}}
    nums = dict(card=card, serve={**{k: v for k, v in sv.items()
                                     if k not in ("top", "spans")}, **a,
                                  "unsharded_prefill_ms": ref["prefill_ms"]},
                train={**{k: v for k, v in tr.items() if k != "top"},
                       "unsharded_losses": losses,
                       "unsharded_step_ms": ref["step_ms"]},
                moe=[f["moe"] for f in facts], gloo_cuda=f0["gloo_cuda"],
                **parts)
    return launches, nums


# -------------------------------- phase 26: dry-run counts against the card

DRYRUN_SEQ = 4096          # phase 7's prefill and phase 10's step


def same_layout(torch, got, want, what: str) -> None:
    """Fails unless the stand-in's outputs have the real call's shapes,
    dtypes and strides."""
    for i, (g, w) in enumerate(zip(got, want)):
        check((tuple(g.shape), g.dtype, g.stride()) ==
              (tuple(w.shape), w.dtype, w.stride()),
              f"{what} output {i}: stand-in {tuple(g.shape)} {g.dtype} "
              f"{g.stride()}, kernel {tuple(w.shape)} {w.dtype} "
              f"{w.stride()}")
    check(len(got) == len(want), f"{what}: {len(got)} outputs, kernel "
          f"{len(want)}")


def real_aten_flops(torch, fn) -> float:
    """``FlopCounterMode``'s count of one call of ``fn`` on the card."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    torch.cuda.synchronize()
    return float(fc.get_total_flops())


def phase_dryrun(torch, np, measured: dict):
    """Phase 26 (see the module's docstring). ``measured`` holds phase 7's
    prefill ms and phase 10's step median and peak; run alone, the phase
    times both itself (a prefill after one warm call, the median of three
    steps after one)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_meta,
        flash_attention_meta)
    from repro_torch.launch.roofline import (HBM_BW, PEAK_FLOPS, Roofline,
                                             model_flops_for)
    from repro_torch.launch.step_analysis import analyze
    from repro_torch.models.model import Model
    from repro_torch.train import AdamWConfig
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.trainer import make_train_step, master_params
    S = DRYRUN_SEQ
    out = {}

    # (a) K3 and K3' stand-ins against one real call each at phase 7's
    # shape, in the model's layout seen through transposes
    rng = np.random.default_rng(26)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        shp, dtype=np.float32)).to("cuda", torch.bfloat16).transpose(1, 2)
        for shp in ((1, S, 32, 128), (1, S, 8, 128), (1, S, 8, 128)))
    o, lse = flash_attention(q, k, v, lse=True)
    do = torch.randn_like(o)
    real_bwd = flash_attention_bwd(q, k, v, o, lse, do)
    qm, km, vm = (t.to("meta") for t in (q, k, v))
    same_layout(torch, flash_attention_meta(qm, km, vm, lse=True), (o, lse),
                "K3 stand-in")
    same_layout(torch, flash_attention_bwd_meta(qm, km, vm), real_bwd,
                "K3' stand-in")
    del q, k, v, o, lse, do, real_bwd

    cfg = get_config("qwen3-4b")
    meta_model = Model(cfg, device="meta", seed=None)
    tok_meta = torch.empty((1, S), dtype=torch.long, device="meta")
    mc_p = analyze(meta_model.prefill, tok_meta)
    weights_p = sum(p.numel() * p.element_size()
                    for p in meta_model.parameters())
    del meta_model
    before = torch.cuda.memory_allocated()
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    alloc_p = torch.cuda.memory_allocated() - before
    card_p = sum(p.untyped_storage().nbytes() for p in model.parameters())
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, S))).cuda()
    aten_p = real_aten_flops(torch, lambda: model.prefill(tokens))
    prefill_ms = measured.get("prefill_ms")
    if prefill_ms is None:
        model.prefill(tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(tokens)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    del model, tokens
    gc.collect()
    torch.cuda.empty_cache()

    layers8 = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS)
    meta_model = Model(layers8, device="meta", seed=None, remat="full")
    step = make_train_step(meta_model, AdamWConfig(
        peak_lr=TRAIN_LR, warmup_steps=2, total_steps=TRAIN_STEPS))
    params = master_params(meta_model)
    opt = init_opt_state(params)
    batch = {"tokens": tok_meta, "labels": tok_meta}
    mc_s = analyze(step, params, opt, batch)
    weights_s = sum(p.numel() * p.element_size()
                    for p in meta_model.parameters())
    state_s = sum(t.numel() * t.element_size() for tree in
                  (params, opt["mu"], opt["nu"]) for t in tree.values())
    del meta_model, step, params, opt, batch
    model, data, batch, opt_cfg, tag = train_setup(torch, "qwen3-4b",
                                                   TRAIN_LAYERS)
    card_s = sum(p.untyped_storage().nbytes() for p in model.parameters())
    step = make_train_step(model, opt_cfg)
    params = master_params(model)
    opt = init_opt_state(params)
    aten_s = real_aten_flops(torch, lambda: step(params, opt, batch))
    step_ms = measured.get("step_ms")
    if step_ms is None:
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, opt, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        step_ms = float(np.median(walls[1:]))
    del model, data, batch, step, params, opt
    gc.collect()
    torch.cuda.empty_cache()

    for what, mc, aten in (("prefill", mc_p, aten_p), ("step", mc_s, aten_s)):
        counted = mc.flops - mc.kernel_flops
        check(counted == aten,
              f"{what}: the meta count's aten FLOPs {counted:.6e} differ "
              f"from FlopCounterMode's on the card {aten:.6e}")
    check(mc_p.kernel_calls == {"flash_attention": 36},
          f"prefill stand-ins {mc_p.kernel_calls} (flash_attention 36)")
    check(mc_s.kernel_calls == {"flash_attention": 2 * TRAIN_LAYERS,
                                "flash_attention_bwd": TRAIN_LAYERS},
          f"step stand-ins {mc_s.kernel_calls}")

    # (b) the counted bounds against the measured times
    for what, mc, c, kind, ms in (
            ("prefill", mc_p, cfg, "prefill", prefill_ms),
            ("step", mc_s, layers8, "train", step_ms)):
        rl = Roofline(arch="qwen3-4b", shape=f"{kind} 1 x {S}", mesh="1",
                      chips=1, hlo_flops=mc.flops,
                      hlo_bytes=mc.traffic_bytes,
                      coll_bytes_per_chip=mc.collective_bytes,
                      coll_breakdown=mc.collective_breakdown,
                      model_flops=model_flops_for(
                          c, ShapeConfig(kind, S, 1, kind)),
                      hlo_bytes_lower=mc.dot_traffic_bytes)
        bound_ms = rl.step_bound_s * 1e3
        ideal_ms = max(rl.model_flops / PEAK_FLOPS,
                       rl.hlo_bytes_lower / HBM_BW) * 1e3
        check(bound_ms <= ms,
              f"{what}: counted bound {bound_ms:.2f} ms above the measured "
              f"{ms:.2f} ms: a count is wrong")
        out[what] = dict(measured_ms=ms, bound_ms=bound_ms,
                         dominant=rl.dominant, compute_ms=rl.compute_s * 1e3,
                         memory_ms=rl.memory_s * 1e3, ideal_ms=ideal_ms,
                         fraction_reached=ideal_ms / ms,
                         flops=mc.flops, aten_flops=mc.flops - mc.kernel_flops,
                         kernel_flops=mc.kernel_flops,
                         traffic_bytes=mc.traffic_bytes,
                         dot_traffic_bytes=mc.dot_traffic_bytes)
        print(f"dry-run count of qwen3-4b's {what} (1 x {S}): "
              f"{mc.flops / 1e12:.3f} TFLOP ({(mc.flops - mc.kernel_flops) / 1e12:.3f} "
              f"aten, equal to the card's count; {mc.kernel_flops / 1e12:.3f} "
              f"in the kernels), {mc.traffic_bytes / 1e9:.2f} GB traffic "
              f"(matmul-only {mc.dot_traffic_bytes / 1e9:.2f}); bound "
              f"{bound_ms:.2f} ms ({rl.dominant}) <= measured {ms:.2f} ms; "
              f"ideal {ideal_ms:.2f} ms, roofline fraction reached "
              f"{ideal_ms / ms:.3f}", flush=True)

    # (c) the counted bytes against the card's
    for what, counted, card in (("prefill model", weights_p, card_p),
                                ("step model", weights_s, card_s)):
        check(counted == card,
              f"{what}: counted working weights {counted} B, the card's "
              f"parameters {card} B")
    check(alloc_p >= weights_p,
          f"the card allocated {alloc_p} B for {weights_p} B of parameters")
    peak_gb = measured.get("peak_gb")
    counted_gb = (weights_s + state_s) / 1e9
    out["memory"] = dict(weights_prefill=weights_p, allocated_prefill=alloc_p,
                         weights_step=weights_s, state_step=state_s,
                         counted_step_gb=counted_gb, phase10_peak_gb=peak_gb)
    print(f"dry-run bytes: qwen3-4b's working weights {weights_p / 1e9:.4f} "
          f"GB counted = the card's parameters (allocated {alloc_p / 1e9:.4f} "
          f"GB); 8 layers {weights_s / 1e9:.4f} GB; the step's counted "
          f"memory (weights, masters, moments; no activations) "
          f"{counted_gb:.2f} GB beside phase 10's peak "
          f"{'not measured' if peak_gb is None else f'{peak_gb:.2f} GB'}",
          flush=True)
    return out


# ------------------------ phase 27: serving under fsdp, four ranks

FSDP_MESH = (2, 2)         # ("data", "model") on one card, four gloo ranks
FSDP_LIMIT_S = 120.0       # the phase's limit, its references included
FSDP_WAIT_S = 90.0         # a collective's
# each part: the layers served, a prefill of FSDP_BATCH x FSDP_SEQ tokens
# (a row a "data" rank), FSDP_DECODE decode steps over the prefill's cache
# from position FSDP_SEQ - FSDP_DECODE (each overwrites its row); a rank's
# launches a prefill and the per-rank shapes its kernels see: K3's q and k
# (B, S, H, hd), K4's r (B, S, H, hd)
FSDP_BATCH, FSDP_SEQ, FSDP_DECODE = 2, 2048, 4
FSDP_PARTS = {
    "dense": dict(arch="qwen3-4b", layers=8, prefill={"flash_attention": 8},
                  shapes={"flash_attention": [
                      (1, FSDP_SEQ, FSDP_ATTN[1], 128),
                      (1, FSDP_SEQ, FSDP_ATTN[2], 128)]}),
    "ssm": dict(arch="rwkv6-7b", layers=4, prefill={"wkv6": 4},
                shapes={"wkv6": [FSDP_K4[:4]]}),
}


def fsdp_config(name: str):
    from repro_torch.configs import get_config
    spec = FSDP_PARTS[name]
    return dataclasses.replace(get_config(spec["arch"]),
                               num_layers=spec["layers"])


def fsdp_references(torch, np, d: Path, name: str) -> dict:
    """Part ``name`` of phase 27 unsharded on the kernel path (seed-0
    weights, the whole batch), saved under ``d`` for the ranks: the
    tokens, the prefill's logits and cache, the decode steps' logits.
    Returns the prefill's ms."""
    from repro_torch.models.model import Model
    cfg = fsdp_config(name)
    rng = np.random.default_rng(27)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (FSDP_BATCH, FSDP_SEQ)))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                          (FSDP_BATCH, FSDP_DECODE)))
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens.cuda())
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    saved = {"tokens": tokens, "steps": steps, "logits": logits.cpu(),
             "cache": {k: t.to("cpu", copy=True)
                       for k, t in cache_leaves(cache).items()}}
    cache["pos"] = FSDP_SEQ - FSDP_DECODE
    saved["decode"] = [model.decode_step(steps[:, i].cuda(), cache)[0].cpu()
                       for i in range(FSDP_DECODE)]
    torch.save(saved, d / f"fsdp_{name}.pt")
    del model, cache, logits, saved
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms}


def shard_bytes(torch, model, ctx) -> int:
    """A rank's bytes of ``model``'s working weights under
    ``param_sharding``'s placements on ``ctx``'s mesh: each parameter's
    whole shape cut by the mesh axes it is split over, in the compute
    dtype."""
    import math
    from repro_torch.dist import api as dist
    shapes = model.global_shapes()
    placed = dist.param_sharding(model.param_axes(), shapes, ctx)
    size = torch.empty((), dtype=model.policy.compute_dtype).element_size()
    total = 0
    for name, shape in shapes.items():
        local = list(shape)
        for axis, pl in zip(ctx.sizes, placed[name]):
            if isinstance(pl, dist.Shard):
                local[pl.dim] //= ctx.sizes[axis]
        total += math.prod(local) * size
    return total


def fsdp_part(torch, np, d: Path, mesh, counters: dict, name: str) -> dict:
    """Part ``name`` of phase 27 on one rank: the model built under the
    mesh, its working weights handed to a ``ServeShards`` (this rank's
    "fsdp" shards), its row of the prefill and the decode steps, held
    against ``fsdp_references``'. Fails where the rank's resident weights
    between units are not its shard bytes, where its kernels launched
    other counts or saw other shapes, or where its numbers miss
    PATH_REL_TOL."""
    from repro_torch.convert import whole_cache
    from repro_torch.dist import api as dist
    from repro_torch.models.fsdp import ServeShards
    from repro_torch.models.model import Model
    spec = FSDP_PARTS[name]
    ref = torch.load(d / f"fsdp_{name}.pt", mmap=True)
    cfg = fsdp_config(name)
    out = {}
    with dist.use_mesh(mesh) as ctx:
        model = Model(cfg, device="cuda", seed=0)
        want_bytes = shard_bytes(torch, model, ctx)
        holder = ServeShards(model)
        index, shards = holder.token_shard
        tag = (f"(27 {name}) {spec['arch']} at {FSDP_MESH}, rank "
               f"{tdist_rank()}, batch shard {index} of {shards}")
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()

        def resident(when: str) -> int:
            held = holder.nbytes() + sum(p.numel() * p.element_size()
                                         for p in model.parameters())
            check(held == want_bytes, f"{tag}: {held} B of weights resident "
                  f"{when}, not its {want_bytes} B of shards")
            return held

        resident("before the prefill")
        rows = slice(index, index + 1)

        def held(spans: dict, what: str) -> dict:
            errs = {k: e / max(m, 1e-30) for k, (e, m) in spans.items()}
            worst = max(errs, key=errs.get)
            check(errs[worst] <= PATH_REL_TOL, f"{tag}: {what} {worst} "
                  f"differs from the unsharded kernel path by "
                  f"{errs[worst]:.3e} of its largest magnitude (> "
                  f"{PATH_REL_TOL})")
            return {"worst": worst, "err": errs[worst]}

        for c in counters.values():
            c.reset()
        shapes: dict = {}
        tokens = ref["tokens"][rows].cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with kernel_shapes(shapes):
            logits, cache = model.prefill(tokens)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = {n: c.launches for n, c in counters.items()}
        want = {n: spec["prefill"].get(n, 0) for n in counters}
        check(launches == want, f"{tag}: the prefill launched {launches}, "
              f"not {want}")
        for kernel, want_shapes in spec["shapes"].items():
            got = sorted(shapes.get(kernel, ()))
            check(got == sorted(want_shapes), f"{tag}: the prefill handed "
                  f"{kernel} {got}, not the rank's {sorted(want_shapes)}")
        out["resident_bytes"] = resident("after the prefill")
        V = cfg.vocab_size
        spans = {"logits": tp_span(torch, logits[..., :V],
                                   ref["logits"][rows][..., :V])}
        for path, t in cache_leaves(whole_cache(model, cache)).items():
            want_t = ref["cache"][path]       # the batch: its one dim
            bdim = [i for i, (g, w) in enumerate(zip(t.shape, want_t.shape))
                    if g != w]                # of another size
            check(len(bdim) == 1 and t.dim() == want_t.dim(),
                  f"{tag}: cache {path} of shape {tuple(t.shape)} against "
                  f"the unsharded {tuple(want_t.shape)}")
            spans[f"cache {path}"] = tp_span(
                torch, t, want_t.narrow(bdim[0], index, 1))
        out["prefill"] = dict(ms=prefill_ms, launches=launches,
                              shapes={k: sorted(v) for k, v in
                                      shapes.items()},
                              **held(spans, "the prefill's"))
        cache["pos"] = FSDP_SEQ - FSDP_DECODE
        spans, walls = {}, []
        for i in range(FSDP_DECODE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = model.decode_step(ref["steps"][rows, i].cuda(), cache)[0]
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            spans[f"decode {i}"] = tp_span(torch, got[..., :V],
                                           ref["decode"][i][rows][..., :V])
            resident(f"after decode step {i}")
        check(not any(c.launches - launches[n] for n, c in counters.items()),
              f"{tag}: a decode step launched a kernel")
        out["decode"] = dict(ms=float(np.median(walls)) * 1e3,
                             **held(spans, "a decode step's"))
        out["shard_bytes"] = want_bytes
        out["gathered_peak_bytes"] = holder.peak
        out["batch_shard"] = [index, shards]
        del model, holder, cache, logits, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tdist_rank() -> int:
    import torch.distributed as tdist
    return tdist.get_rank()


def fsdp_rank(rank: int, d: str) -> None:
    """One rank of phase 27: a gloo process group of four ranks on cuda:0,
    the (2, 2) mesh, each part of FSDP_PARTS; writes ``fsdp<r>.json``. A
    failed check or an exception prints its traceback and exits
    non-zero."""
    import numpy as np
    import torch
    import torch.distributed as tdist
    sys.path.insert(0, str(ROOT / "src"))
    PHASE["label"] = f"27 rank {rank}"
    d = Path(d)
    torch.cuda.set_device(0)
    world = FSDP_MESH[0] * FSDP_MESH[1]
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(str(d / "fsdp_store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=FSDP_WAIT_S))
    try:
        from repro_torch.launch.mesh import _make_mesh
        counters = tp_counters()
        mesh = _make_mesh(FSDP_MESH, ("data", "model"), "cuda")
        out = {"model_rank": mesh.get_local_rank("model")}
        for name in FSDP_PARTS:
            t0 = time.perf_counter()
            out[name] = fsdp_part(torch, np, d, mesh, counters, name)
            out[name]["seconds"] = time.perf_counter() - t0
            tdist.barrier()
        (d / f"fsdp{rank}.json").write_text(json.dumps(out))
    except Exception as e:           # noqa: BLE001 - named, then failed
        traceback.print_exc(file=sys.stdout)
        fail(f"{type(e).__name__}: {e}")
    finally:
        tdist.destroy_process_group()


def phase_fsdp(torch, np, card: str):
    """Phase 27: serving under the mesh with the working weights sharded
    over "fsdp", four gloo ranks on one card at ("data", "model") = (2,
    2). The unsharded references first (``fsdp_references``), then the
    ranks (``fsdp_rank``), each serving its row of every part of
    FSDP_PARTS with its shards (``fsdp_part``): qwen3-4b at 8 of 36
    layers (K3 8 a prefill at 16 query and 4 KV heads a rank) and
    rwkv6-7b at 4 of 32 (K4 4 at 32 heads a rank). The phase, its
    references included, must end within FSDP_LIMIT_S. Returns (rank 0's
    launches by part, numbers)."""
    import multiprocessing
    import tempfile
    t_start = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="fsdp_")
    d = Path(tmp.name)
    world = FSDP_MESH[0] * FSDP_MESH[1]
    try:
        ref = {name: fsdp_references(torch, np, d, name)
               for name in FSDP_PARTS}
        procs = [multiprocessing.get_context("spawn").Process(
            target=fsdp_rank, args=(r, str(d))) for r in range(world)]
        for p in procs:
            p.start()
        deadline = t_start + FSDP_LIMIT_S
        while any(p.is_alive() for p in procs) and \
                time.perf_counter() < deadline and \
                not any(p.exitcode for p in procs):   # a rank failed
            time.sleep(0.5)
        hung = [r for r, p in enumerate(procs) if p.is_alive()
                and not any(q.exitcode for q in procs)]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        check(not hung, f"ranks {hung} did not finish within the phase's "
                        f"{FSDP_LIMIT_S} s")
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"rank exit codes {codes}")
        facts = [json.loads((d / f"fsdp{r}.json").read_text())
                 for r in range(world)]
    finally:
        tmp.cleanup()
    seconds = time.perf_counter() - t_start
    check(seconds <= FSDP_LIMIT_S, f"the phase took {seconds:.1f} s, over "
                                   f"its {FSDP_LIMIT_S} s")
    nums = {"card": card, "seconds": seconds, "mesh": list(FSDP_MESH)}
    for name, spec in FSDP_PARTS.items():
        parts = [f[name] for f in facts]
        nums[name] = dict(
            arch=spec["arch"], layers=spec["layers"],
            unsharded_prefill_ms=ref[name]["prefill_ms"],
            prefill_ms=[p["prefill"]["ms"] for p in parts],
            decode_ms=[p["decode"]["ms"] for p in parts],
            prefill_err=max(p["prefill"]["err"] for p in parts),
            decode_err=max(p["decode"]["err"] for p in parts),
            shard_bytes=[p["shard_bytes"] for p in parts],
            gathered_peak_bytes=[p["gathered_peak_bytes"] for p in parts],
            launches=parts[0]["prefill"]["launches"],
            shapes=parts[0]["prefill"]["shapes"],
            seconds=[round(p["seconds"], 1) for p in parts])
        q = nums[name]
        print(f"(27 {name}) ({card}) {spec['arch']} at {spec['layers']} "
              f"layers, {FSDP_MESH} = (data, model), a row of {FSDP_SEQ} "
              f"tokens a data rank: each rank holds "
              f"{q['shard_bytes'][0] / 1e9:.4f} GB of shards between units "
              f"(resident weights equal to them at every check), at most "
              f"{max(q['gathered_peak_bytes']) / 1e9:.4f} GB gathered at "
              f"once; prefill ms a rank "
              f"{[round(x, 1) for x in q['prefill_ms']]} (unsharded, both "
              f"rows: {q['unsharded_prefill_ms']:.1f}); decode ms a step a "
              f"rank {[round(x, 1) for x in q['decode_ms']]}; logits and "
              f"gathered caches within {q['prefill_err']:.3e}, decode "
              f"logits within {q['decode_err']:.3e} of the unsharded "
              f"kernel path's largest magnitude; launches a prefill "
              f"{q['launches']}; kernels saw {q['shapes']}; ranks' seconds "
              f"{q['seconds']}", flush=True)
    print(f"phase 27 ({card}): {seconds:.1f} s of its {FSDP_LIMIT_S} s",
          flush=True)
    launches = {name: nums[name]["launches"] for name in FSDP_PARTS}
    return launches, nums


def run_phase(torch, label: str, fn, *args):
    """Run one phase: print its start with the card's free memory, then,
    on success, its seconds and peak memory, and drop what it held. Any
    exception (an out-of-memory error included) prints its traceback and
    fails naming the phase; ``fail`` stays the only way out."""
    free, total = torch.cuda.mem_get_info()
    print(f"phase {label}: start, {free / 1e9:.2f} of {total / 1e9:.2f} GB "
          f"free", flush=True)
    from unittest import mock
    PHASE["label"] = label
    reset = torch.cuda.reset_peak_memory_stats
    peaks = [0]

    def keep_then_reset(*a, **kw):
        # a phase that resets the peak for its own reading keeps the
        # phase's earlier peak here
        peaks.append(torch.cuda.max_memory_allocated())
        reset(*a, **kw)
    reset()
    t0 = time.perf_counter()
    try:
        with mock.patch.object(torch.cuda, "reset_peak_memory_stats",
                               keep_then_reset):
            out = fn(*args)
        torch.cuda.synchronize()
    except Exception as e:            # noqa: BLE001 - named, then failed
        traceback.print_exc(file=sys.stdout)
        fail(f"{type(e).__name__}: {e}")
    peak = max(peaks + [torch.cuda.max_memory_allocated()]) / 1e9
    print(f"phase {label}: passed in {time.perf_counter() - t0:.1f} s, "
          f"peak {peak:.2f} GB", flush=True)
    PHASE["label"] = None
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------------------- main

def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch next to {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = run_phase(torch, "1 build", _build.build_all)
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"setup: kernels built in {build_s:.1f} s; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas {name}: {line.strip()}")
    card = smi[0] if smi else "nvidia-smi: no output"
    print(card, flush=True)

    dirs = [1.0, 1.0, -1.0, -1.0, -1.0, 1.0, -1.0, -1.0]
    k1 = run_phase(torch, "2 fleet_score", phase_k1, torch, np, dirs)
    k2 = run_phase(torch, "3 sweep_burn", phase_k2, torch, np)
    n1, n2 = run_phase(torch, "4 guard loop", phase_main, torch, np)
    k3 = run_phase(torch, "5 flash_attention", phase_k3, torch, np)
    k4 = run_phase(torch, "6 wkv6", phase_k4, torch, np)
    # The kernel phases whose checks read profiler traces run before the
    # model phases: on an H100, after the model phases' profiles (phases
    # 7, 8, 10) sessions of one call often traced nothing, up to eight in a
    # row (see call_segments), and none did before them.
    k3b = run_phase(torch, "9 flash_attention_bwd", phase_k3_bwd, torch, np)
    k4b = run_phase(torch, "13(a) wkv6_bwd", phase_k4_bwd, torch, np)
    k5 = run_phase(torch, "17(a) rglru", phase_k5, torch, np)
    k3w = run_phase(torch, "17(b) flash_attention window", phase_k3_window,
                    torch, np)
    k5b = run_phase(torch, "19(a) rglru_bwd", phase_k5_bwd, torch, np)
    k3bw = run_phase(torch, "19(b) flash_attention_bwd window",
                     phase_k3_bwd_window, torch, np)

    from repro_torch.kernels.fleet_score import COUNTER as C1
    from repro_torch.kernels.flash_attention import BWD_COUNTER as C3B
    from repro_torch.kernels.flash_attention import COUNTER as C3
    from repro_torch.kernels.rglru import BWD_COUNTER as C5B
    from repro_torch.kernels.rglru import COUNTER as C5
    from repro_torch.kernels.sweep_burn import COUNTER as C2
    from repro_torch.kernels.wkv6 import BWD_COUNTER as C4B
    from repro_torch.kernels.wkv6 import COUNTER as C4
    counters = {"fleet_score": C1, "sweep_burn": C2, "flash_attention": C3,
                "flash_attention_bwd": C3B, "wkv6": C4, "wkv6_bwd": C4B,
                "rglru": C5, "rglru_bwd": C5B}

    def only(**want):
        return {n: want.get(n, 0) for n in counters}

    measured = {}               # phase 26 reads phases 7 and 10

    def serve_dense():
        dense, nums = phase_serve(torch, np, "qwen3-4b", 4096, counters)
        measured["prefill_ms"] = nums["prefill_s"] * 1e3
        check(dense == only(flash_attention=36),
              f"qwen3-4b prefill launched {dense} (flash_attention once per "
              f"layer, 36)")
        return dense

    def serve_ssm():
        ssm, nums = phase_serve(torch, np, "rwkv6-7b", 2048, counters,
                                ragged=1000)
        for n, got in ((2048, ssm), (1000, nums["ragged_launches"])):
            check(got == only(wkv6=32),
                  f"rwkv6-7b prefill of {n} tokens launched {got} (wkv6 "
                  f"once per layer, 32)")
        return ssm

    def serve_moe():
        moe, moe_nums = phase_moe_serve(torch, np, counters)
        for arch, layers in (("deepseek-moe-16b", 28),
                             ("llama4-scout-17b-a16e", LLAMA4_LAYERS)):
            check(moe[arch] == only(flash_attention=layers),
                  f"{arch} prefill launched {moe[arch]} (flash_attention "
                  f"once per layer, {layers})")
        return moe, moe_nums

    def serve_hybrid():
        # prefills of 4,096 tokens (twice the window: the shortest prompt
        # above it that the ring takes) and of 1,000 (below it), each
        # followed by ring decode steps from both paths' caches
        hyb, nums = phase_serve(torch, np, "recurrentgemma-9b", 4096,
                                counters, ragged=1000)
        # 12 attention layers (12 units) and 26 rec layers (12 units' two
        # and the tail's two), each once
        for n, got in ((4096, hyb), (1000, nums["ragged_launches"])):
            check(got == only(flash_attention=12, rglru=26),
                  f"recurrentgemma-9b prefill of {n} tokens launched {got} "
                  f"(flash_attention 12, rglru 26)")
        return hyb, nums

    def serve_audio():
        # a prefill of AUDIO_BATCH x (1,500 seeded frames, AUDIO_SEQ
        # tokens) against the plain path (decoder layer 0's self K/V, which
        # no kernel feeds, bit-equal), then a BatchedServer of 12 requests
        # on 4 slots with caches of AUDIO_SEQ, whose decode runs no kernel
        audio, nums = phase_serve(torch, np, "whisper-small", AUDIO_SEQ,
                                  counters, batch=AUDIO_BATCH,
                                  cache_len=AUDIO_SEQ)
        check(audio == only(**AUDIO_PREFILL),
              f"whisper-small prefill launched {audio} ({AUDIO_PREFILL}: "
              f"12 encoder, 12 decoder self and 12 cross attentions)")
        return audio, nums

    def serve_vlm():
        # prefills of 4,096 tokens (the first 256 a 16 x 16 image) and of
        # 1,000 (the same image) against the plain path, then a
        # BatchedServer of 12 requests on 4 slots
        vlm, nums = phase_serve(torch, np, "qwen2-vl-72b", 4096, counters,
                                ragged=1000, layers=VLM_SERVE_LAYERS)
        for n, got in ((4096, vlm), (1000, nums["ragged_launches"])):
            check(got == only(flash_attention=VLM_SERVE_LAYERS),
                  f"qwen2-vl-72b prefill of {n} tokens launched {got} "
                  f"(flash_attention once per layer, {VLM_SERVE_LAYERS})")
        return vlm, nums

    dense = run_phase(torch, "7 qwen3-4b serving", serve_dense)
    ssm = run_phase(torch, "8 rwkv6-7b serving", serve_ssm)
    n3, n4 = dense["flash_attention"], ssm["wkv6"]
    train, tnums = run_phase(torch, "10 qwen3-4b training", phase_train,
                             torch, np, counters)
    k1_sim, snums = run_phase(torch, "11 attribution and simulation",
                              phase_sim, torch, np, counters)
    k1_fleet, fnums = run_phase(torch, "12 fleet control plane",
                                phase_fleet, torch, np, counters)
    train_ssm, ssm_nums = run_phase(torch, "13(b) rwkv6-7b training",
                                    phase_train_ssm, torch, np, counters)
    train_mesh, mesh_nums = run_phase(
        torch, "14 training under a one-rank mesh", phase_train_mesh, torch,
        np, counters, tnums, card)
    moe, moe_nums = run_phase(torch, "15 moe serving", serve_moe)
    train_moe, moe_tnums = run_phase(torch, "16 moe training",
                                     phase_train_moe, torch, np, counters)
    hybrid, hyb_nums = run_phase(torch, "18 recurrentgemma-9b serving",
                                 serve_hybrid)
    train_hyb, hyb_tnums = run_phase(torch, "20 recurrentgemma-9b training",
                                     phase_train_hybrid, torch, np,
                                     counters)
    audio, audio_nums = run_phase(torch, "21 whisper-small serving",
                                  serve_audio)
    train_audio, audio_tnums = run_phase(torch, "22 whisper-small training",
                                         phase_train_audio, torch, np,
                                         counters)
    vlm, vlm_nums = run_phase(torch, "23 qwen2-vl-72b serving", serve_vlm)
    train_vlm, vlm_tnums = run_phase(
        torch, "24 qwen2-vl-72b training", train_full_width, torch, np,
        counters, "qwen2-vl-72b", VLM_TRAIN_LAYERS, VLM_PER_STEP,
        VLM_PEAK_LR, VLM_LATER_STEPS)
    tp, tp_nums = run_phase(torch, "25 tensor parallelism, four ranks",
                            phase_tp, torch, np, card)
    measured.update(step_ms=tnums["step_ms"], peak_gb=tnums["peak_gb"])
    dry_nums = run_phase(torch, "26 dry-run counts against the card",
                         phase_dryrun, torch, np, measured)
    fsdp, fsdp_nums = run_phase(torch, "27 serving under fsdp, four ranks",
                                phase_fsdp, torch, np, card)

    kernels = [
        {"name": "fleet_score", "route": "cuda",
         "source": "src/repro_torch/csrc/fleet_score.cu",
         "replaces": "src/repro/kernels/fleet_score/fleet_score.py:146",
         "launches": n1 + k1_sim + k1_fleet, "launches_loop": n1,
         "launches_sim": k1_sim, "launches_fleet": k1_fleet,
         "launches_tp_train_a_rank": tp["train"]["fleet_score"],
         "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"],
         "device_ms": k1["device_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "shape": k1["shape"]},
        {"name": "sweep_burn", "route": "cuda",
         "source": "src/repro_torch/csrc/sweep_burn.cu",
         "replaces": "src/repro/kernels/sweep_burn/sweep_burn.py:47",
         "launches": n2, "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": "operations", "library_ms": k2["library_ms"],
         "shape": k2["shape"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:81",
         "launches": n3, "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "shape": k3["shape"],
         "launches_train": train["flash_attention"],
         "launches_mesh": train_mesh["flash_attention"],
         "launches_moe_prefill": moe["deepseek-moe-16b"]["flash_attention"],
         "launches_moe_prefill_llama4":
             moe["llama4-scout-17b-a16e"]["flash_attention"],
         "launches_moe_train": train_moe["flash_attention"],
         "launches_hybrid_prefill": hybrid["flash_attention"],
         "launches_hybrid_train": train_hyb["flash_attention"],
         "launches_audio_prefill": audio["flash_attention"],
         "launches_audio_train": train_audio["flash_attention"],
         "launches_vlm_prefill": vlm["flash_attention"],
         "launches_vlm_train": train_vlm["flash_attention"],
         "launches_tp_prefill_a_rank": tp["prefill"]["flash_attention"],
         "launches_tp_train_a_rank": tp["train"]["flash_attention"],
         "launches_tp_moe_prefill_a_rank":
             tp["moe_prefill"]["flash_attention"],
         "launches_tp_moe_step_a_rank": tp["moe_step"]["flash_attention"],
         "launches_tp_hybrid_prefill_a_rank":
             tp["hybrid_prefill"]["flash_attention"],
         "launches_tp_hybrid_step_a_rank":
             tp["hybrid_step"]["flash_attention"],
         "launches_tp_audio_prefill_a_rank":
             tp["audio_prefill"]["flash_attention"],
         "launches_tp_audio_step_a_rank": tp["audio_step"]["flash_attention"],
         "launches_fsdp_prefill_a_rank": fsdp["dense"]["flash_attention"],
         "vlm": k3["vlm"], "tp": k3["tp"], "tp_audio": k3["tp_audio"],
         "fsdp": k3["fsdp"], "window": k3w},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention/ops.py:42",
         "launches": train["flash_attention_bwd"],
         "launches_mesh": train_mesh["flash_attention_bwd"],
         "launches_moe_train": train_moe["flash_attention_bwd"],
         "launches_hybrid_train": train_hyb["flash_attention_bwd"],
         "launches_audio_prefill": audio["flash_attention_bwd"],
         "launches_audio_train": train_audio["flash_attention_bwd"],
         "launches_vlm_prefill": vlm["flash_attention_bwd"],
         "launches_vlm_train": train_vlm["flash_attention_bwd"],
         "launches_tp_train_a_rank": tp["train"]["flash_attention_bwd"],
         "launches_tp_moe_step_a_rank":
             tp["moe_step"]["flash_attention_bwd"],
         "launches_tp_hybrid_step_a_rank":
             tp["hybrid_step"]["flash_attention_bwd"],
         "launches_tp_audio_step_a_rank":
             tp["audio_step"]["flash_attention_bwd"],
         "max_abs_err": k3b["max_abs_err"],
         "max_rel_err": k3b["max_rel_err"], "ms": k3b["ms"],
         "device_ms": k3b["device_ms"],
         "device_kernels_per_call": k3b["kernels_per_call"],
         "plain_ms": k3b["plain_ms"], "bound_ms": k3b["bound_ms"],
         "bound_by": k3b["bound_by"], "library_ms": k3b["library_ms"],
         "shape": k3b["shape"], "vlm": k3b["vlm"], "tp": k3b["tp"],
         "tp_audio": k3b["tp_audio"], "window": k3bw},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/wkv6/wkv6.py:76",
         "launches": n4, "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
         "device_ms": k4["device_ms"],
         "device_kernels_per_call": k4["kernels_per_call"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None,
         "shape": k4["shape"], "launches_train": train_ssm["wkv6"],
         "launches_tp_ssm_prefill_a_rank": tp["ssm_prefill"]["wkv6"],
         "launches_tp_ssm_step_a_rank": tp["ssm_step"]["wkv6"],
         "launches_fsdp_prefill_a_rank": fsdp["ssm"]["wkv6"],
         "tp": k4["tp"], "fsdp": k4["fsdp"]},
        {"name": "wkv6_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv6_bwd.cu",
         "replaces": "src/repro/models/rwkv6.py:82",
         "launches": train_ssm["wkv6_bwd"],
         "launches_tp_ssm_step_a_rank": tp["ssm_step"]["wkv6_bwd"],
         "tp": k4b["tp"],
         "max_abs_err": k4b["max_abs_err"],
         "max_rel_err": k4b["max_rel_err"], "ms": k4b["ms"],
         "device_ms": k4b["device_ms"],
         "device_kernels_per_call": k4b["kernels_per_call"],
         "plain_ms": k4b["plain_ms"], "bound_ms": k4b["bound_ms"],
         "bound_by": k4b["bound_by"], "library_ms": None,
         "shape": k4b["shape"]},
        {"name": "rglru", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru.cu",
         "replaces": "src/repro/models/rglru.py:81",
         "launches": hybrid["rglru"], "max_abs_err": k5["max_abs_err"],
         "max_rel_err": max(k5["h_err"], k5["h_last_err"]),
         "worst_limit_ratio": k5["worst_ratio"], "ms": k5["ms"],
         "device_ms": k5["device_ms"], "plain_ms": k5["plain_ms"],
         "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
         "library_ms": None, "shape": k5["shape"],
         "launches_train": train_hyb["rglru"],
         "launches_tp_hybrid_prefill_a_rank": tp["hybrid_prefill"]["rglru"],
         "launches_tp_hybrid_step_a_rank": tp["hybrid_step"]["rglru"],
         "tp": k5["tp"]},
        {"name": "rglru_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/rglru_bwd.cu",
         "replaces": "src/repro/models/rglru.py:81",
         "launches": train_hyb["rglru_bwd"],
         "launches_tp_hybrid_step_a_rank": tp["hybrid_step"]["rglru_bwd"],
         "tp": k5b["tp"],
         "max_abs_err": k5b["max_abs_err"],
         "max_rel_err": k5b["max_rel_err"],
         "worst_limit_ratio": k5b["worst_ratio"], "ms": k5b["ms"],
         "device_ms": k5b["device_ms"],
         "device_kernels_per_call": k5b["kernels_per_call"],
         "plain_ms": k5b["plain_ms"], "bound_ms": k5b["bound_ms"],
         "bound_by": k5b["bound_by"], "library_ms": None,
         "shape": k5b["shape"]},
    ]
    print(f"training (phase 10): {json.dumps(tnums)}", flush=True)
    print(f"attribution and simulation (phase 11): {json.dumps(snums)}",
          flush=True)
    print(f"fleet control plane (phase 12): {json.dumps(fnums)}", flush=True)
    print(f"ssm training (phase 13): {json.dumps(ssm_nums)}", flush=True)
    print(f"training under a one-rank mesh (phase 14): "
          f"{json.dumps(mesh_nums)}", flush=True)
    print(f"moe serving (phase 15): {json.dumps(moe_nums)}", flush=True)
    print(f"moe training (phase 16): {json.dumps(moe_tnums)}", flush=True)
    print(f"hybrid serving (phase 18): {json.dumps(hyb_nums)}", flush=True)
    print(f"hybrid training (phase 20): {json.dumps(hyb_tnums)}", flush=True)
    print(f"audio serving (phase 21): {json.dumps(audio_nums)}", flush=True)
    print(f"audio training (phase 22): {json.dumps(audio_tnums)}",
          flush=True)
    print(f"vlm serving (phase 23): {json.dumps(vlm_nums)}", flush=True)
    print(f"vlm training (phase 24): {json.dumps(vlm_tnums)}", flush=True)
    print(f"tensor parallelism (phase 25): {json.dumps(tp_nums)}",
          flush=True)
    print(f"dry-run counts (phase 26): {json.dumps(dry_nums)}", flush=True)
    print(f"serving under fsdp (phase 27): {json.dumps(fsdp_nums)}",
          flush=True)
    print(f"every phase passed in {time.perf_counter() - t0:.1f} s, the "
          f"builds included; {SESSIONS['lost']} of {SESSIONS['taken']} "
          f"profiler sessions traced no whole call and were taken again",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
