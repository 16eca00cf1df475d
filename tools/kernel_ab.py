#!/usr/bin/env python3
"""Time an earlier design of the fleet_score (K1), flash-attention forward
(K3) and backward (K3'), WKV6 backward (K4'), RG-LRU scan (K5) and RG-LRU
scan backward (K5') kernels beside this tree's, in turns, on one card.

Run from the repository root:

    mkdir -p build/parent
    git archive <commit> src/repro_torch | tar -x -C build/parent
    python3 tools/kernel_ab.py --parent build/parent

Both designs are built by nvcc with the flags of
``repro_torch.kernels._build`` (the earlier one into
``build/repro_torch/parent/``) and run on the same seeded inputs, timed in
the order earlier, this tree, this tree, earlier (median of CUDA-event
timings each). Their outputs are held against each other: K1 bit for bit;
K3 at recurrentgemma-9b's local attention (q (1, 16, 4096, 256) over one
KV head, window 2,048) within ``chip_smoke.K3_TOL`` of the largest
magnitude, the largest difference printed with whether it is 0, and at
qwen3-4b's prefill (q (1, 32, 4096, 128), k/v 8 heads, causal) bit for
bit; K3' at qwen3-4b's training shape (causal, bfloat16) bit for bit, and
at recurrentgemma-9b's (q (1, 16, 4096, 256) over one KV head, window
2,048) each of dq, dk, dv within 2e-2 of its largest magnitude (a
redesign may sum in another order), with each design's head split (the
earlier tree's ``dkdv_split`` where it holds
``kernels/flash_attention/flash_attention.py``), each design's device
split by kernel, and this tree's call at 1, 2, 4, 8 and 16 parts; K4'
(rwkv6-7b's training shape, bfloat16 and float32, the inputs of
``chip_smoke.py`` phase 13(a)) each of its six gradients within
``chip_smoke.K4B_TOL`` of its largest magnitude; K5 at recurrentgemma-9b's
prefill (1, 4096, 4096), bfloat16 and float32 (phase 17(a)'s inputs), H
and h_last within ``chip_smoke.K5_TOL`` of the largest magnitude (a
bfloat16 H by the float32 difference its two roundings imply); K5' at
recurrentgemma-9b's training shape, bfloat16 and float32 (phase 19(a)'s
first two cases), each gradient within ``chip_smoke.K5B_TOL`` of its
largest magnitude (a bfloat16 dxb by its two roundings). K3', K4', K5
and K5' are timed by their C entry points on both sides, into buffers
allocated once, so the times are the device's. A kernel is compared only
when the earlier tree holds its source and that source differs from this
tree's. K5's gates run the compiler's division 1 / y and ``sqrtf``
through branch-free copies of their fast paths (``rcp_rn``, ``sqrt_rn``
in ``rglru.cu``) wherever ``in_rcp_range`` and ``in_sqrt_range`` hold;
every float32 bit pattern is put through both, and the script fails
unless they give the same bits over those ranges. Prints the card's name
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
# B, Hq, Hkv, S = T, hd, window; causal, bfloat16
K3B_SHAPES = [(1, 32, 8, 4096, 128, 0), (1, 16, 1, 4096, 256, 2048)]
K3B_SPLITS = (1, 2, 4, 8, 16)   # head splits timed at hd 256
K4B_CASES = [0, 1]        # chip_smoke.K4B_CASES: the training shape, bf16, fp32
K3_SHAPES = [(1, 16, 1, 4096, 256, 2048),    # B, Hq, Hkv, S = T, hd, window
             (1, 32, 8, 4096, 128, 0)]       # causal, bfloat16
K5_SHAPES = [(1, 4096, 4096, "bfloat16"), (1, 4096, 4096, "float32")]
K5B_CASES = [0, 1]        # chip_smoke.K5B_CASES: the training shape, bf16, fp32


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
        # the window, split and part arguments came with the hybrid
        # family's training
        src = parent / "src" / "repro_torch" / "csrc" / \
            "flash_attention_bwd.cu"
        windowed = "int window, float scale, int split" in src.read_text()
        libs["flash_attention_bwd"].flash_attention_bwd_launch.argtypes = (
            [p] * 10 + [i] * (11 if windowed else 10) + [f]
            + ([i, p] if windowed else []) + [ctypes.POINTER(ll), p])
    if "wkv6_bwd" in libs:
        libs["wkv6_bwd"].wkv6_bwd_launch.argtypes = (
            [p] * 18 + [i] * 6 + [ctypes.POINTER(ll), p])
    if "flash_attention" in libs:
        libs["flash_attention"].flash_attention_launch.argtypes = (
            [p] * 5 + [i] * 11 + [f] + [ll] * 12 + [p])
    if "rglru_bwd" in libs:
        libs["rglru_bwd"].rglru_bwd_launch.argtypes = [p] * 14 + [i] * 4 + [p]
    if "rglru" in libs:
        # the float32 states pointer came with the scan's backward
        src = (parent / "src" / "repro_torch" / "csrc" / "rglru.cu")
        n_ptr = 8 if "void* Hs" in src.read_text() else 7
        libs["rglru"].rglru_launch.argtypes = [p] * n_ptr + [i] * 4 + [p]
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


def parent_split(parent: Path):
    """The earlier tree's ``dkdv_split``, where it holds the wrapper, else
    None."""
    import importlib.util
    src = (parent / "src" / "repro_torch" / "kernels" / "flash_attention"
           / "flash_attention.py")
    if not src.exists():
        return None
    spec = importlib.util.spec_from_file_location("earlier_flash_attention",
                                                  src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, "dkdv_split", None)


def k3b_ab(torch, np, lib, time_ms, parent: Path) -> list:
    import math

    from chip_smoke import kernel_split_ms
    from repro_torch.kernels.flash_attention import dkdv_split, flash_attention
    from repro_torch.kernels.flash_attention.flash_attention import _bwd_lib
    current_lib = _bwd_lib()
    # window, split and part arguments came with the hybrid family's training
    windowed = len(lib.flash_attention_bwd_launch.argtypes) == 26
    earlier_split = parent_split(parent) or dkdv_split
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for i, (b, hq, hkv, s, hd, win) in enumerate(K3B_SHAPES):
        if win and not windowed:
            continue
        rng = np.random.default_rng(300 + i)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to("cuda", torch.bfloat16)
            .transpose(1, 2) for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                                           (b, s, hkv, hd), (b, s, hq, hd)))
        o, lse = flash_attention(q, k, v, lse=True, window=win)
        g = hq // hkv
        splits = {"earlier": earlier_split(b, hkv, s, hd, g, sms)
                  if windowed else 1, "this": dkdv_split(b, hkv, s, hd, g, sms)}

        def outputs():
            dq = torch.empty((b, s, hq, hd), dtype=q.dtype,
                             device="cuda").transpose(1, 2)
            dk, dv = (torch.empty((b, s, hkv, hd), dtype=q.dtype,
                                  device="cuda").transpose(1, 2)
                      for _ in range(2))
            scratch = torch.empty((b, hq, s), device="cuda")
            part = torch.empty((2, max(K3B_SPLITS), b, hkv, s, hd),
                               device="cuda") if hd == 256 else None
            return dq, dk, dv, scratch, part

        def launcher(which, out, split, new_args=True):
            dq, dk, dv, scratch, part = out
            strides = (ctypes.c_longlong * 24)(
                *[x for t in (q, k, v, o, do, dq, dk, dv)
                  for x in t.stride()[:3]])
            extra = ([win], [split, None if split == 1 else
                             part.data_ptr()]) if new_args else ([], [])

            def run():
                err = which.flash_attention_bwd_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, b, hq,
                    hkv, s, s, hd, s, 0, 1, *extra[0], 1.0 / math.sqrt(hd),
                    *extra[1], strides,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"flash_attention_bwd launch failed: "
                                       f"{err}")
            return run
        got, want = outputs(), outputs()
        earlier = launcher(lib, want, splits["earlier"], windowed)
        current = launcher(current_lib, got, splits["this"])
        earlier()
        current()
        torch.cuda.synchronize()
        errs, equal = {}, {}
        for n, g_, w_ in zip(("dq", "dk", "dv"), got, want):
            equal[n] = torch.equal(g_, w_)
            g_, w_ = g_.float(), w_.float()
            errs[n] = float((g_ - w_).abs().max() / w_.abs().max())
            if not (bool(torch.isfinite(g_).all()) and errs[n] <= 2e-2
                    and (hd == 256 or equal[n])):
                raise RuntimeError(f"K3' designs disagree at "
                                   f"{(b, hq, hkv, s, hd, win)}: {n} "
                                   f"{errs[n]}, bit-equal {equal[n]}")
        row = {"kernel": "flash_attention_bwd",
               "shape": [b, hq, hkv, s, hd], "window": win,
               "max_rel_diff": errs, "bit_equal": equal, "splits": splits,
               **turns(time_ms, earlier, current)}
        row["earlier_over_this"] = sum(row["earlier_ms"]) / sum(row["ms"])
        line = (f"K3' flash_attention_bwd B,Hq,Hkv,S,hd={b},{hq},{hkv},{s},"
                f"{hd} causal{f' window {win}' if win else ''} bfloat16: "
                f"largest difference over largest magnitude "
                + ", ".join(f"{n} {e:.2e}" + (" (bit-equal)" if equal[n]
                                              else "")
                            for n, e in errs.items())
                + f"; earlier {row['earlier_ms']} ms, this tree "
                f"{row['ms']} ms, earlier / this tree "
                f"{row['earlier_over_this']:.2f}x")
        if hd == 256:
            row["device_split"] = {
                "earlier": kernel_split_ms(torch, earlier),
                "this": kernel_split_ms(torch, current)}
            row["split_ms"] = {
                sp: time_ms(launcher(current_lib, got, sp))
                for sp in K3B_SPLITS if g % sp == 0}
            line += (f"; head splits {splits}; device split (ms) earlier "
                     + ", ".join(f"{n} {m:.4f}" for n, m in
                                 row["device_split"]["earlier"].items())
                     + ", this tree " + ", ".join(
                         f"{n} {m:.4f}" for n, m in
                         row["device_split"]["this"].items())
                     + "; this tree at each split " + ", ".join(
                         f"{sp} parts {m:.4f} ms"
                         for sp, m in row["split_ms"].items()))
        print(line, flush=True)
        rows.append(row)
    return rows


def k5b_ab(torch, np, lib, time_ms) -> list:
    from chip_smoke import K5B_CASES as CASES
    from chip_smoke import K5B_TOL
    from repro_torch.kernels.rglru import rglru_scan
    from repro_torch.kernels.rglru.rglru import _bwd_lib
    current_lib = _bwd_lib()
    rows = []
    for i in K5B_CASES:
        b, s, w, dname, warm = CASES[i]
        dt = getattr(torch, dname)
        rng = np.random.default_rng(500 + i)      # phase 19(a)'s inputs

        def mk(*shape, scale=1.0, shift=0.0):
            x = rng.standard_normal(shape, dtype=np.float32) * scale + shift
            return torch.from_numpy(x).cuda()
        xb = mk(b, s, w).to(dt)
        wa, wi, lam = mk(w, scale=0.5), mk(w, scale=0.5), mk(w, shift=0.65)
        h0 = mk(b, w) if warm else torch.zeros(b, w, device="cuda")
        dh_last = mk(b, w) if warm else None
        dH = mk(b, s, w).to(dt)
        _, _, states = rglru_scan(xb, wa, wi, lam, h0, keep_states=True)

        def outputs():
            f32 = dict(dtype=torch.float32, device="cuda")
            return [torch.empty_like(xb)] + [torch.empty(w, **f32)
                                             for _ in range(3)] + [
                torch.empty((b, w), **f32), torch.empty((b, 3, w), **f32)]

        def launcher(which, out):
            def run():
                err = which.rglru_bwd_launch(
                    xb.data_ptr(), wa.data_ptr(), wi.data_ptr(),
                    lam.data_ptr(), h0.data_ptr(), states.data_ptr(),
                    dH.data_ptr(),
                    None if dh_last is None else dh_last.data_ptr(),
                    *[t.data_ptr() for t in out],
                    1 if dt == torch.bfloat16 else 0, b, s, w,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"rglru_bwd launch failed: {err}")
            return run
        got, want = outputs(), outputs()
        earlier, current = launcher(lib, want), launcher(current_lib, got)
        earlier()
        current()
        torch.cuda.synchronize()
        errs = {}
        for n, g_, w_ in zip(("dxb", "dwa", "dwi", "dlam", "dh0"), got,
                             want):
            scale = float(w_.float().abs().max().clamp_min(1e-30))
            if g_.dtype == torch.bfloat16:
                e = float(_bf16_pair_excess(torch, g_, w_).max()) / scale
            else:
                e = float((g_ - w_).abs().max()) / scale
            errs[n] = e
            if not (bool(torch.isfinite(g_.float()).all()) and e <= K5B_TOL):
                raise RuntimeError(f"K5' designs disagree at "
                                   f"{(b, s, w, dname)}: {n} {e}")
        row = {"kernel": "rglru_bwd", "shape": [b, s, w], "dtype": dname,
               "max_rel_diff": errs, **turns(time_ms, earlier, current)}
        row["earlier_over_this"] = sum(row["earlier_ms"]) / sum(row["ms"])
        print(f"K5' rglru_bwd B,S,W={b},{s},{w} {dname}: agree within "
              f"K5B_TOL (" + ", ".join(f"{n} {e:.2e}" for n, e in
                                       errs.items())
              + f" of the largest magnitude); earlier {row['earlier_ms']} "
              f"ms, this tree {row['ms']} ms, earlier / this tree "
              f"{row['earlier_over_this']:.2f}x", flush=True)
        rows.append(row)
        del xb, dH, states, got, want
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


def k3_ab(torch, np, lib, time_ms) -> list:
    import math

    from chip_smoke import K3_TOL
    from repro_torch.kernels.flash_attention.flash_attention import _lib
    current_lib = _lib()
    rows = []
    for i, (b, hq, hkv, s, hd, win) in enumerate(K3_SHAPES):
        rng = np.random.default_rng(400 + i)
        q, k, v = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to("cuda", torch.bfloat16)
            .transpose(1, 2) for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                                           (b, s, hkv, hd)))

        def launcher(which, out):
            strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]

            def run():
                err = which.flash_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None, 1, b, hq, hkv, s, s, hd, s, 0, 1, win,
                    1.0 / math.sqrt(hd), *strides,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"flash_attention launch failed: "
                                       f"{err}")
            return run
        got, want = (torch.empty((b, s, hq, hd), dtype=q.dtype,
                                 device="cuda").transpose(1, 2)
                     for _ in range(2))
        earlier, current = launcher(lib, want), launcher(current_lib, got)
        earlier()
        current()
        torch.cuda.synchronize()
        diff = float((got.float() - want.float()).abs().max())
        rel = diff / float(want.float().abs().max())
        equal = torch.equal(got, want)
        if not bool(torch.isfinite(got.float()).all()) or (
                rel > K3_TOL["bfloat16"] or (hd != 256 and not equal)):
            raise RuntimeError(f"K3 designs disagree at {(b, hq, hkv, s, hd)}"
                               f" window {win}: largest difference {diff} "
                               f"({rel:.3e} of the largest magnitude), "
                               f"bit-equal {equal}")
        row = {"kernel": "flash_attention", "shape": [b, hq, hkv, s, hd],
               "window": win, "max_abs_diff": diff, "bit_equal": equal,
               **turns(time_ms, earlier, current)}
        row["earlier_over_this"] = sum(row["earlier_ms"]) / sum(row["ms"])
        print(f"K3 flash_attention B,Hq,Hkv,S,hd={b},{hq},{hkv},{s},{hd} "
              f"causal{f' window {win}' if win else ''} bfloat16: largest "
              f"difference {diff:.3e} ({rel:.3e} of the largest magnitude), "
              f"{'bit-equal' if equal else 'not bit-equal'}; earlier "
              f"{row['earlier_ms']} ms, this tree {row['ms']} ms, earlier / "
              f"this tree {row['earlier_over_this']:.2f}x", flush=True)
        rows.append(row)
    return rows


def _bf16_pair_excess(torch, a, b):
    """Elementwise, how far two bfloat16 values lie apart beyond the half
    ulps each rounding allows (0 when one float32 value could round to
    both within them)."""
    out = (a.float() - b.float()).abs()
    for t in (a.float(), b.float()):
        _, e = torch.frexp(t)
        out = out - torch.where(t == 0, torch.zeros_like(t),
                                torch.ldexp(torch.ones_like(t), e - 9))
    return out.clamp_min(0.0)


def k5_ab(torch, np, lib, time_ms) -> list:
    from chip_smoke import K5_TOL
    from repro_torch.kernels.rglru.rglru import _lib
    current_lib = _lib()
    rows = []
    for b, s, w, dname in K5_SHAPES:
        dt = getattr(torch, dname)
        rng = np.random.default_rng(300)          # phase 17(a)'s first case

        def mk(*shape, scale=1.0, shift=0.0):
            x = rng.standard_normal(shape, dtype=np.float32) * scale + shift
            return torch.from_numpy(x).cuda()
        xb = mk(b, s, w).to(dt)
        wa, wi, lam = mk(w, scale=0.5), mk(w, scale=0.5), mk(w, shift=0.65)
        h0 = mk(b, w)

        def launcher(which, H, hl):
            def run():
                states = [None] * (len(which.rglru_launch.argtypes) - 12)
                err = which.rglru_launch(
                    xb.data_ptr(), wa.data_ptr(), wi.data_ptr(),
                    lam.data_ptr(), h0.data_ptr(), H.data_ptr(),
                    hl.data_ptr(), *states,
                    1 if dt == torch.bfloat16 else 0, b, s, w,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"rglru launch failed: {err}")
            return run
        got, want = (torch.empty_like(xb), torch.empty_like(xb))
        got_l, want_l = (torch.empty((b, w), device="cuda") for _ in range(2))
        earlier = launcher(lib, want, want_l)
        current = launcher(current_lib, got, got_l)
        earlier()
        current()
        torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        if dt == torch.float32:
            err_h = float((got - want).abs().max()) / scale
        else:
            err_h = float(_bf16_pair_excess(torch, got, want).max()) / scale
        err_l = float((got_l - want_l).abs().max() / want_l.abs().max())
        if not (bool(torch.isfinite(got.float()).all()) and err_h <= K5_TOL
                and err_l <= K5_TOL):
            raise RuntimeError(f"K5 designs disagree at {(b, s, w, dname)}: "
                               f"H {err_h}, h_last {err_l}")
        row = {"kernel": "rglru", "shape": [b, s, w], "dtype": dname,
               "max_rel_diff": {"H": err_h, "h_last": err_l},
               **turns(time_ms, earlier, current)}
        row["earlier_over_this"] = sum(row["earlier_ms"]) / sum(row["ms"])
        print(f"K5 rglru B,S,W={b},{s},{w} {dname}: agree within K5_TOL (H "
              f"{err_h:.2e}, h_last {err_l:.2e} of the largest magnitude); "
              f"earlier {row['earlier_ms']} ms, this tree {row['ms']} ms, "
              f"earlier / this tree {row['earlier_over_this']:.2f}x",
              flush=True)
        rows.append(row)
    return rows


_K5_MATH_CHECK = r"""
#include "%s"

// Every float32 bit pattern: where the range test holds, the fast-path
// copy against the compiler's own operation, bit for bit.
__global__ void rglru_math_check(unsigned long long* out) {
  unsigned long long in_range = 0, differ = 0;
  const unsigned long long step =
      (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i =
           (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += step) {
    const float y = __uint_as_float((uint32_t)i);
    if (in_rcp_range(y)) {
      ++in_range;
      differ += __float_as_uint(rcp_rn(y)) != __float_as_uint(1.0f / y);
    }
    if (in_sqrt_range(y)) {
      ++in_range;
      differ += __float_as_uint(sqrt_rn(y)) != __float_as_uint(sqrtf(y));
    }
  }
  atomicAdd(out, in_range);
  atomicAdd(out + 1, differ);
}

extern "C" int rglru_math_check_launch(unsigned long long* out,
                                       cudaStream_t stream) {
  rglru_math_check<<<132 * 8, 256, 0, stream>>>(out);
  return (int)cudaGetLastError();
}
"""


def k5_math_check(torch) -> dict:
    """rcp_rn and sqrt_rn against 1 / y and sqrtf over every float32 in
    their ranges, built with K5's flags."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "math_check"
    out.mkdir(parents=True, exist_ok=True)
    cu, lib = out / "rglru_math_check.cu", out / "librglru_math_check.so"
    cu.write_text(_K5_MATH_CHECK % (ROOT / "src" / "repro_torch" / "csrc"
                                    / "rglru.cu"))
    proc = subprocess.run([_build.nvcc(), *_build.FLAGS["rglru"], "-o",
                           str(lib), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the K5 math check:\n"
                           f"{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.rglru_math_check_launch.argtypes = [ctypes.c_void_p] * 2
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")
    err = dll.rglru_math_check_launch(
        counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K5 math check launch failed: {err}")
    in_range, differ = (int(x) for x in counts.cpu())
    if differ or not in_range:
        raise RuntimeError(f"K5: rcp_rn/sqrt_rn differ from 1 / y and sqrtf "
                           f"on {differ} of {in_range} inputs in range")
    print(f"K5 rcp_rn and sqrt_rn: bit-equal to 1 / y and sqrtf on every "
          f"float32 in range ({in_range} inputs, the two ranges together)",
          flush=True)
    return {"kernel": "rglru", "check": "rcp_rn, sqrt_rn", "in_range":
            in_range, "differ": differ}


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
    names = [n for n in ("fleet_score", "flash_attention",
                         "flash_attention_bwd", "wkv6_bwd", "rglru",
                         "rglru_bwd")
             if (args.parent / csrc / f"{n}.cu").exists()
             and (args.parent / csrc / f"{n}.cu").read_bytes()
             != (ROOT / csrc / f"{n}.cu").read_bytes()]
    forwards = {"flash_attention_bwd": "flash_attention", "wkv6_bwd": "wkv6",
                "rglru_bwd": "rglru"}
    _build.build_all(sorted({forwards.get(n, n) for n in names} |
                            set(names)))
    libs = build_parent(args.parent, names)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    rows = [k5_math_check(torch)]
    if "fleet_score" in libs:
        rows += k1_ab(torch, libs["fleet_score"], time_ms, k1_inputs)
    if "flash_attention" in libs:
        rows += k3_ab(torch, np, libs["flash_attention"], time_ms)
    if "flash_attention_bwd" in libs:
        rows += k3b_ab(torch, np, libs["flash_attention_bwd"], time_ms,
                       args.parent)
    if "wkv6_bwd" in libs:
        rows += k4b_ab(torch, np, libs["wkv6_bwd"], time_ms)
    if "rglru" in libs:
        rows += k5_ab(torch, np, libs["rglru"], time_ms)
    if "rglru_bwd" in libs:
        rows += k5b_ab(torch, np, libs["rglru_bwd"], time_ms)
    print(json.dumps({"card": smi, "ab": rows}), flush=True)


if __name__ == "__main__":
    main()
