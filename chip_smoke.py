#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port of Guard on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package ``repro``. In
order, it

  1. builds the port's CUDA kernels from ``src/repro_torch/csrc`` into
     ``build/repro_torch/`` (one nvcc per source, all started together)
     and prints the card's name and power limit;
  2. holds the fleet_score kernel against its plain PyTorch version on the
     card at 16,384 and 131,072 nodes, bit for bit, and times both;
  3. holds the sweep_burn kernel against its plain version (atol 1e-3,
     two runs bit-equal), and times it beside a cuBLAS float32 matmul
     chain of the same flops;
  4. drives Guard's closed loop through ``GuardSession`` on a synthetic
     16,384-node fleet with 64 spares and four planted faults, asserts
     the actions, swaps and quarantines, that both kernels ran on that
     path, and that the same frames through the port on the CPU give the
     identical JSONL event stream;
  5. prints one JSON line of per-kernel numbers, then
     ``{"ok": true, "device": {...}}`` as its last line.

Any failed check exits non-zero before the last line is printed. Without
a CUDA device, or without the repository next to it, it fails at once.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# one NVIDIA H100 SXM (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_SIMT_FLOPS = 67e12

N_MAIN = 16_384            # nodes on the main path
N_SPARES = 64
WINDOWS = 30               # evaluation windows, 60 s apart
WINDOW_S = 60.0
CKPT_EVERY = 5             # windows between checkpoints
PLANTED = {"immediate": 101, "defer": 2_202, "hardware": 3_303,
           "heartbeat": 4_404}
HEARTBEAT_LOST_AT = 10     # window from which node "heartbeat" is silent


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
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


# ------------------------------------------------------------ phase 2: K1

def k1_inputs(r: int, m: int, n: int, nan_rows: bool, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    mats = (rng.random((r, m, n), dtype=np.float32) * 0.1 + 1.0)
    mats[:, 0, n - 1] *= 1.5                 # planted step-time stragglers
    mats[:, 0, 3] *= 1.3
    if nan_rows:
        sign_nan = np.frombuffer(np.uint32(0xFFC00000).tobytes(),
                                 np.float32)[0]
        mats[:, 2, :] = np.nan               # a metric with no readings
        drop = rng.choice(n, n // 50, replace=False)
        mats[:, 3, drop] = np.nan            # sensor dropouts
        mats[:, 0, drop[:7]] = sign_nan      # x86 inf - inf NaNs
    return mats


def phase_k1(torch, np, dirs):
    from repro_torch.kernels.fleet_score import fleet_score, score_rows_ref
    kw = dict(z_threshold=3.0, slowdown_floor=0.025, mad_floor_frac=0.01)
    main = None
    for i, (r, m, n, nans) in enumerate([(1, 8, 16_384, False),
                                         (6, 8, 16_384, False),
                                         (1, 8, 131_072, False),
                                         (1, 8, 16_383, True)]):
        mats = torch.from_numpy(k1_inputs(r, m, n, nans, i)).cuda()
        got = fleet_score(mats, dirs, 0, **kw)
        want = score_rows_ref(mats, dirs, 0, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]),
              f"fleet_score dev differs at {(r, m, n)}")
        err = max(max_abs_err(got[1], want[1]),
                  max_abs_err(got[2], want[2]))
        check(err == 0.0, f"fleet_score rel/contrib differ at {(r, m, n)}: "
                          f"max abs err {err}")
        ms = time_ms(lambda: fleet_score(mats, dirs, 0, **kw))
        plain = time_ms(lambda: score_rows_ref(mats, dirs, 0, **kw))
        nbytes = r * m * n * 4 + r * m * n + 2 * r * n * 4 + m * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"K1 fleet_score R,M,N={r},{m},{n}{' +NaN rows' if nans else ''}"
              f": bit-equal to plain; kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bound:.6f} ms (bytes)", flush=True)
        if main is None:                     # the main path's shape
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=bound, shape=[r, m, n])
    return main


# ------------------------------------------------------------ phase 3: K2

def phase_k2(torch, np):
    from repro_torch.kernels.sweep_burn import burn, burn_flops, burn_ref
    main = None
    for m, k, iters in [(512, 512, 64), (2048, 2048, 16)]:
        rng = np.random.default_rng(m)
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
        ms = time_ms(lambda: burn(a, b, iters=iters), reps=5, warm=1)
        plain = time_ms(lambda: burn_ref(a, b, iters=iters), reps=5, warm=1)
        y = torch.empty_like(a)

        def matmul_chain():                   # cuBLAS float32 yardstick
            for _ in range(iters):
                torch.matmul(a, b, out=y)
        torch.backends.cuda.matmul.allow_tf32 = False
        lib = time_ms(matmul_chain, reps=5, warm=1)
        flops = burn_flops(m, k, iters)
        bound = flops / FP32_SIMT_FLOPS * 1e3
        print(f"K2 sweep_burn M,K,iters={m},{k},{iters}: max abs err "
              f"{err:.3e}, bit-repeatable; kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
              f"matmul chain {lib:.4f} ms ({flops / lib / 1e9:.2f} TFLOP/s)"
              f", bound {bound:.4f} ms (operations)", flush=True)
        if main is None:
            main = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=bound, library_ms=lib,
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
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"setup: kernels built in {build_s:.1f} s; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)

    dirs = [1.0, 1.0, -1.0, -1.0, -1.0, 1.0, -1.0, -1.0]
    k1 = phase_k1(torch, np, dirs)
    k2 = phase_k2(torch, np)
    n1, n2 = phase_main(torch, np)

    kernels = [
        {"name": "fleet_score", "route": "cuda",
         "source": "src/repro_torch/csrc/fleet_score.cu",
         "replaces": "src/repro/kernels/fleet_score/fleet_score.py:146",
         "launches": n1, "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": "bytes", "library_ms": None, "shape": k1["shape"]},
        {"name": "sweep_burn", "route": "cuda",
         "source": "src/repro_torch/csrc/sweep_burn.cu",
         "replaces": "src/repro/kernels/sweep_burn/sweep_burn.py:47",
         "launches": n2, "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": "operations", "library_ms": k2["library_ms"],
         "shape": k2["shape"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
