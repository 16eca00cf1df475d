#!/usr/bin/env python3
"""Time an earlier design of the fleet_score (K1) and WKV6 (K4) kernels
beside this tree's, in turns, on one card.

Run from the repository root:

    mkdir -p build/parent
    git archive <commit> src/repro_torch/csrc | tar -x -C build/parent
    python3 tools/kernel_ab.py --parent build/parent

Both designs are built by nvcc with the flags of
``repro_torch.kernels._build`` (the earlier one into
``build/repro_torch/parent/``) and run on the same seeded inputs, timed in
the order earlier, this tree, this tree, earlier (median of CUDA-event
timings each). Their outputs are held against each other: K1 bit for bit,
K4 within atol 2e-3 / rtol 1e-3. The earlier K4 is the single-kernel design
whose C entry point takes no scratch. Prints the card's name and power
limit, one line per shape, and a JSON line of all times.
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
K4_SHAPES = [(1, 2048, 64, 64, 32)]        # B, S, H, hd, C; bfloat16 r/k/v


def build_parent(parent: Path) -> dict:
    """nvcc the earlier sources, both at once; returns the loaded libraries
    with their C signatures declared."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("fleet_score", "wkv6"):
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
    libs["fleet_score"].fleet_score_launch.argtypes = (
        [p, p, i, i, i, i, f, f, f, p, p, p, p])
    libs["wkv6"].wkv6_launch.argtypes = [p] * 8 + [i] * 6 + [ll] * 15 + [p]
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


def k4_ab(torch, np, lib, time_ms) -> list:
    from repro_torch.kernels.wkv6 import wkv6_chunked
    rows = []
    for i, (b, s, h, hd, c) in enumerate(K4_SHAPES):
        rng = np.random.default_rng(200 + i)

        def mk(*shape, scale=0.5):
            x = rng.standard_normal(shape, dtype=np.float32) * scale
            return torch.from_numpy(x).cuda()
        r, k, v = (mk(b, s, h, hd).to(torch.bfloat16).transpose(1, 2)
                   for _ in range(3))
        logw = (-torch.exp(mk(b, s, h, hd) - 2.0)).transpose(1, 2)
        u, s0 = mk(h, hd, scale=0.15), mk(b, h, hd, hd, scale=0.05)
        y = torch.empty((b, s, h, hd), device="cuda").transpose(1, 2)
        st = torch.empty_like(s0)
        strides = [x for t in (r, k, v, logw, y) for x in t.stride()[:3]]

        def earlier():
            err = lib.wkv6_launch(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                u.data_ptr(), s0.data_ptr(), y.data_ptr(), st.data_ptr(), 1,
                b, h, s, hd, c, *strides,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"earlier wkv6 failed: {err}")

        def current():
            return wkv6_chunked(r, k, v, logw, u, s0, chunk=c)
        earlier()
        gy, gs = current()
        torch.cuda.synchronize()
        for got, want in ((gy, y), (gs, st)):
            if not torch.allclose(got, want, atol=2e-3, rtol=1e-3):
                raise RuntimeError(f"K4 designs disagree at {(b, s, h, hd)}")
        row = {"kernel": "wkv6", "shape": [b, s, h, hd, c],
               **turns(time_ms, earlier, current)}
        print(f"K4 wkv6 B,S,H,hd={b},{s},{h},{hd} chunk {c} bfloat16: agree; "
              f"earlier {row['earlier_ms']} ms, this tree {row['ms']} ms",
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
    _build.build_all(["fleet_score", "wkv6"])
    libs = build_parent(args.parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rows = (k1_ab(torch, libs["fleet_score"], time_ms, k1_inputs)
            + k4_ab(torch, np, libs["wkv6"], time_ms))
    print(json.dumps({"card": smi, "ab": rows}), flush=True)


if __name__ == "__main__":
    main()
