#!/usr/bin/env python3
"""Time an earlier design of the fleet_score (K1), flash-attention
backward (K3') and WKV6 backward (K4') kernels beside this tree's, in
turns, on one card.

Run from the repository root:

    mkdir -p build/parent
    git archive <commit> src/repro_torch/csrc | tar -x -C build/parent
    python3 tools/kernel_ab.py --parent build/parent

Both designs are built by nvcc with the flags of
``repro_torch.kernels._build`` (the earlier one into
``build/repro_torch/parent/``) and run on the same seeded inputs, timed in
the order earlier, this tree, this tree, earlier (median of CUDA-event
timings each). Their outputs are held against each other: K1 bit for bit,
K3' (qwen3-4b's training shape, causal, bfloat16) each of dq, dk, dv
within 2e-2 of its largest magnitude (a redesign may sum in another
order), K4' (rwkv6-7b's training shape, bfloat16 and float32, the inputs
of ``chip_smoke.py`` phase 13(a)) each of its six gradients within
``chip_smoke.K4B_TOL`` of its largest magnitude. K4' is timed by its C
entry point on both sides, into buffers allocated once, so the times are
the device's. A kernel is compared only when the earlier tree holds its
source and that source differs from this tree's. Prints the card's name
and power limit, one line per shape, and a JSON line of all times.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

K1_SHAPES = [(1, 8, 16_384), (6, 8, 16_384), (1, 8, 131_072)]
K3B_SHAPES = [(1, 32, 8, 4096, 128)]      # B, Hq, Hkv, S = T, hd; causal
K4B_CASES = [0, 1]        # chip_smoke.K4B_CASES: the training shape, bf16, fp32


def build_parent(parent: Path, names) -> dict:
    """nvcc the earlier sources, all at once; returns the loaded libraries
    with their C signatures declared."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = parent / "src" / "repro_torch" / "csrc" / f"{name}.cu"
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS[name], "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the earlier {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    if "fleet_score" in libs:
        libs["fleet_score"].fleet_score_launch.argtypes = (
            [p, p, i, i, i, i, f, f, f, p, p, p, p])
    if "flash_attention_bwd" in libs:
        libs["flash_attention_bwd"].flash_attention_bwd_launch.argtypes = (
            [p] * 10 + [i] * 10 + [f, ctypes.POINTER(ll), p])
    if "wkv6_bwd" in libs:
        libs["wkv6_bwd"].wkv6_bwd_launch.argtypes = (
            [p] * 18 + [i] * 6 + [ctypes.POINTER(ll), p])
    return libs


def turns(time_ms, earlier, current) -> dict:
    """Earlier, current, current, earlier."""
    a1, b1 = time_ms(earlier), time_ms(current)
    b2, a2 = time_ms(current), time_ms(earlier)
    return {"earlier_ms": [a1, a2], "ms": [b1, b2]}


def k1_ab(torch, lib, time_ms, k1_inputs) -> list:
    from repro_torch.kernels.fleet_score import fleet_score
    dirs = [1.0, 1.0, -1.0, -1.0, -1.0, 1.0, -1.0, -1.0]
    kw = dict(z_threshold=3.0, slowdown_floor=0.025, mad_floor_frac=0.01)
    rows = []
    for i, (r, m, n) in enumerate(K1_SHAPES):
        mats = torch.from_numpy(k1_inputs(r, m, n, "", i)).cuda()
        d = torch.tensor(dirs, dtype=torch.float32, device="cuda")
        dev = torch.empty((r, m, n), dtype=torch.uint8, device="cuda")
        rel = torch.empty((r, n), device="cuda")
        con = torch.empty((r, n), device="cuda")

        def earlier():
            err = lib.fleet_score_launch(
                mats.data_ptr(), d.data_ptr(), r, m, n, 0, 3.0, 0.025, 0.01,
                dev.data_ptr(), rel.data_ptr(), con.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"earlier fleet_score failed: {err}")

        def current():
            return fleet_score(mats, d, 0, **kw)
        earlier()
        got = current()
        torch.cuda.synchronize()
        same = (torch.equal(got[0].view(torch.uint8), dev)
                and torch.equal(got[1].view(torch.int32),
                                rel.view(torch.int32))
                and torch.equal(got[2].view(torch.int32),
                                con.view(torch.int32)))
        if not same:
            raise RuntimeError(f"K1 designs disagree at {(r, m, n)}")
        row = {"kernel": "fleet_score", "shape": [r, m, n],
               **turns(time_ms, earlier, current)}
        print(f"K1 fleet_score R,M,N={r},{m},{n}: bit-equal; earlier "
              f"{row['earlier_ms']} ms, this tree {row['ms']} ms", flush=True)
        rows.append(row)
    return rows


def k3b_ab(torch, np, lib, time_ms) -> list:
    import math

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    rows = []
    for i, (b, hq, hkv, s, hd) in enumerate(K3B_SHAPES):
        rng = np.random.default_rng(300 + i)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to("cuda", torch.bfloat16)
            .transpose(1, 2) for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                                           (b, s, hkv, hd), (b, s, hq, hd)))
        o, lse = flash_attention(q, k, v, lse=True)
        dq = torch.empty((b, s, hq, hd), dtype=q.dtype,
                         device="cuda").transpose(1, 2)
        dk, dv = (torch.empty((b, s, hkv, hd), dtype=q.dtype,
                              device="cuda").transpose(1, 2)
                  for _ in range(2))
        scratch = torch.empty((b, hq, s), device="cuda")
        strides = (ctypes.c_longlong * 24)(
            *[x for t in (q, k, v, o, do, dq, dk, dv) for x in t.stride()[:3]])

        def earlier():
            err = lib.flash_attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, b, hq, hkv, s,
                s, hd, s, 0, 1, 1.0 / math.sqrt(hd), strides,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"earlier flash_attention_bwd failed: "
                                   f"{err}")

        def current():
            return flash_attention_bwd(q, k, v, o, lse, do)
        earlier()
        got = current()
        torch.cuda.synchronize()
        errs = {}
        for n, g, w in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
            g, w = g.float(), w.float()
            errs[n] = float((g - w).abs().max() / w.abs().max())
            if not (bool(torch.isfinite(g).all()) and errs[n] <= 2e-2):
                raise RuntimeError(f"K3' designs disagree at "
                                   f"{(b, hq, hkv, s, hd)}: {n} {errs[n]}")
        row = {"kernel": "flash_attention_bwd", "shape": [b, hq, hkv, s, hd],
               "max_rel_diff": errs, **turns(time_ms, earlier, current)}
        print(f"K3' flash_attention_bwd B,Hq,Hkv,S,hd={b},{hq},{hkv},{s},{hd} "
              f"causal bfloat16: agree (largest difference over largest "
              f"magnitude " + ", ".join(f"{n} {e:.2e}" for n, e in
                                         errs.items())
              + f"); earlier {row['earlier_ms']} ms, this tree {row['ms']} ms",
              flush=True)
        rows.append(row)
    return rows


def k4b_ab(torch, np, lib, time_ms) -> list:
    from chip_smoke import K4B_CASES as CASES
    from chip_smoke import K4B_TOL, k4b_inputs
    from repro_torch.kernels.wkv6.wkv6 import _bwd_lib
    current_lib = _bwd_lib()
    rows = []
    for i in K4B_CASES:
        b, s, h, hd, c, dname, _, _ = CASES[i]
        r, k, v, logw, u, _, dy, ds, starts = k4b_inputs(torch, np, i)
        nc, tpc = s // c, -(-c // 32)

        def outputs():
            f32 = dict(dtype=torch.float32, device="cuda")
            seq = [torch.empty((b, s, h, hd), dtype=r.dtype, device="cuda")
                   .transpose(1, 2) for _ in range(3)]
            seq.append(torch.empty((b, s, h, hd), **f32).transpose(1, 2))
            rest = [torch.empty((h, hd), **f32),
                    torch.empty((b, h, hd, hd), **f32),
                    torch.empty((b, h, nc, hd, hd), **f32),
                    torch.empty((b, h, nc * tpc, hd), **f32)]
            return seq + rest              # dr dk dv dw du ds0 gscratch dupart
        strides = (ctypes.c_longlong * 27)(*[
            x for t in (r, k, v, logw, dy) for x in t.stride()[:3]],
            *[x for _ in range(4) for x in
              (s * h * hd, hd, h * hd)])

        def launcher(which, out):
            def run():
                err = which.wkv6_bwd_launch(
                    r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                    dy.data_ptr(), u.data_ptr(), starts.data_ptr(),
                    None if ds is None else ds.data_ptr(),
                    *[t.data_ptr() for t in out], None, None,
                    1 if r.dtype == torch.bfloat16 else 0, b, h, s, hd, c,
                    strides, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"wkv6_bwd launch failed: {err}")
            return run
        got, want = outputs(), outputs()
        earlier, current = launcher(lib, want), launcher(current_lib, got)
        earlier()
        current()
        torch.cuda.synchronize()
        errs = {}
        for n, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got,
                           want):
            tol = K4B_TOL[dname if g.dtype == r.dtype else "float32"]
            g, w = g.float(), w.float()
            errs[n] = float((g - w).abs().max() / w.abs().max())
            if not (bool(torch.isfinite(g).all()) and errs[n] <= tol):
                raise RuntimeError(f"K4' designs disagree at "
                                   f"{(b, s, h, hd, c, dname)}: {n} "
                                   f"{errs[n]}")
        row = {"kernel": "wkv6_bwd", "shape": [b, s, h, hd, c],
               "dtype": dname, "max_rel_diff": errs,
               **turns(time_ms, earlier, current)}
        ratio = sum(row["earlier_ms"]) / sum(row["ms"])
        row["earlier_over_this"] = ratio
        print(f"K4' wkv6_bwd B,S,H,hd={b},{s},{h},{hd} chunk {c} {dname}: "
              f"agree within K4B_TOL (largest difference over largest "
              f"magnitude " + ", ".join(f"{n} {e:.2e}" for n, e in
                                         errs.items())
              + f"); earlier {row['earlier_ms']} ms, this tree "
              f"{row['ms']} ms, earlier / this tree {ratio:.2f}x",
              flush=True)
        rows.append(row)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory holding the earlier src/repro_torch/csrc")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("FAIL: torch.cuda.is_available() is false: this script "
                 "needs a card")
    from chip_smoke import k1_inputs, time_ms
    from repro_torch.kernels import _build
    csrc = Path("src") / "repro_torch" / "csrc"
    names = [n for n in ("fleet_score", "flash_attention_bwd", "wkv6_bwd")
             if (args.parent / csrc / f"{n}.cu").exists()
             and (args.parent / csrc / f"{n}.cu").read_bytes()
             != (ROOT / csrc / f"{n}.cu").read_bytes()]
    forwards = {"flash_attention_bwd": "flash_attention", "wkv6_bwd": "wkv6"}
    _build.build_all([forwards[n] for n in names if n in forwards] + names)
    libs = build_parent(args.parent, names)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rows = []
    if "fleet_score" in libs:
        rows += k1_ab(torch, libs["fleet_score"], time_ms, k1_inputs)
    if "flash_attention_bwd" in libs:
        rows += k3b_ab(torch, np, libs["flash_attention_bwd"], time_ms)
    if "wkv6_bwd" in libs:
        rows += k4b_ab(torch, np, libs["wkv6_bwd"], time_ms)
    print(json.dumps({"card": smi, "ab": rows}), flush=True)


if __name__ == "__main__":
    main()
