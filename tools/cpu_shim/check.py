"""Run a CUDA kernel of the port on the CPU, through its C entry point,
against the CPU stand-in of the CUDA runtime in this directory, and hold
it to its plain PyTorch version at the kernel's own limits:

- ``wkv6_bwd`` (csrc/wkv6_bwd.cu): its six gradients against
  ``wkv6_bwd_ref``, 1e-4 of each gradient's largest magnitude in float32,
  8e-3 for bfloat16 dr, dk, dv;
- ``rglru`` (csrc/rglru.cu): H and h_last against ``rglru_ref``, 1e-5 of
  the largest magnitude (``chip_smoke.K5_TOL``; a bfloat16 H by the
  float32 error its rounding implies), from a nonzero h0; in bfloat16 also
  the float32 states it writes for the backward;
- ``rglru_bwd`` (csrc/rglru_bwd.cu): dxb, dwa, dwi, dlam and dh0 against
  ``rglru_bwd_ref``, 1e-4 of each gradient's largest magnitude
  (``chip_smoke.K5B_TOL``; a bfloat16 dxb by the float32 error its
  rounding implies), from a nonzero h0 and dh_last.

Needs g++ (C++20) and PyTorch for the CPU; no card, no nvcc.

    python3 tools/cpu_shim/check.py               # every kernel, every case
    python3 tools/cpu_shim/check.py rglru         # one kernel
    python3 tools/cpu_shim/check.py wkv6_bwd 0 4  # its cases 0 and 4

It checks a kernel's logic (indexing, swizzles, fragment layouts, scans,
masks, tiles, the handoffs between warps), not its speed or its PTX: the
stand-in runs each CUDA thread as an OS thread. A handoff that deadlocks
hangs; run it under a timeout (tests/test_torch_rglru_shim.py does).
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import K5_TOL, K5B_TOL, bf16_rounding_excess  # noqa: E402
from repro_torch.kernels.rglru.ref import (rglru_bwd_ref, rglru_ref,  # noqa
                                           rglru_states_ref)
from repro_torch.kernels.wkv6.ref import _clip_exp, wkv6_bwd_ref  # noqa: E402

OUT = ROOT / "build" / "cpu_shim"

# wkv6_bwd: B, S, H, hd, C, dtype, decay (mean of log(-logw)), d(state)
# and s0
WKV6_CASES = [
    (1, 64, 1, 64, 32, torch.float32, -2.0, False),
    (1, 64, 1, 64, 32, torch.bfloat16, -2.0, True),
    (1, 64, 2, 16, 32, torch.float32, -2.0, True),
    (1, 64, 1, 32, 32, torch.bfloat16, 0.5, True),
    (2, 64, 1, 128, 32, torch.float32, -2.0, True),
    (1, 100, 1, 32, 100, torch.float32, 0.5, True),
    (1, 70, 1, 16, 35, torch.bfloat16, -2.0, True),
    (1, 130, 1, 128, 130, torch.float32, -2.0, True),
    (1, 7, 1, 64, 7, torch.float32, -2.0, True),
    (1, 96, 1, 64, 96, torch.bfloat16, 0.5, False),
]

# rglru: B, S, W, dtype. S: one step, part of a tile, 300 = two and a
# third 128-step tiles (the ring of 3 slots not yet full), and 769 = 6
# tiles and one step (the ring wrapped twice, a last tile of one step).
# W: 33 (element accesses, a block with one live channel) and 64 (16-byte
# vectors, two full blocks).
RGLRU_CASES = [(2, s, w, dt) for s in (1, 37, 300, 769) for w in (33, 64)
               for dt in (torch.float32, torch.bfloat16)]

# rglru_bwd: B, S, W, dtype[, big]. The kernel walks the sequence from its
# end in tiles of 44 (float32) or 88 (bfloat16) steps through a ring of two
# slots. S: one step (a tile of one live row), 15 and 37 (one partial
# tile), 44 and 88 (one whole tile of either dtype), 45 and 89 (one step
# past a tile: a last tile of one step), 300 (float32: 6 tiles and 36
# steps; bfloat16: 3 and 36), 385 (8 tiles and 33 steps; 4 and 33) and 441
# (10 tiles and one step; 5 and one: the ring wrapped more than once, plus
# one step); W 33 (a block with one live channel, element accesses) and
# 64 (16-byte vectors, two full blocks). `big`: every fifth x is +-400, so
# that exp(-x w) overflows and the sigmoids' reciprocals meet their clamp.
RGLRU_BWD_CASES = [(2, s, w, dt) for s in (1, 15, 37, 300, 385, 44, 45,
                                           88, 89, 441)
                   for w in (33, 64) for dt in (torch.float32,
                                                torch.bfloat16)] + [
    (2, 89, 64, dt, True) for dt in (torch.float32, torch.bfloat16)]


def build(name: str) -> ctypes.CDLL:
    """Rewrite csrc/<name>.cu for the stand-in, compile and load it."""
    OUT.mkdir(parents=True, exist_ok=True)
    cpp = OUT / f"{name}_cpu.cpp"
    cpp.write_text(subprocess.run(
        [sys.executable, str(HERE / "rewrite.py"),
         str(ROOT / f"src/repro_torch/csrc/{name}.cu")],
        check=True, capture_output=True, text=True).stdout)
    lib = OUT / f"lib{name}_cpu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", f"-I{HERE}", "-o", str(lib), str(cpp)],
                   check=True)
    return ctypes.CDLL(str(lib))


def starts_of(k, v, logw, s0, C):
    """The forward's chunk-start states (B, H, S / C, hd, hd)."""
    out, state = [], s0.float()
    for c0 in range(0, k.shape[2], C):
        out.append(state)
        kk, vv, w = (t[:, :, c0:c0 + C].float() for t in (k, v, logw))
        clw = torch.cumsum(w, 2)
        total = clw[:, :, -1]
        kd = kk * _clip_exp(total[:, :, None] - clw)
        state = (_clip_exp(total)[..., None] * state
                 + kd.transpose(-1, -2) @ vv)
    return torch.stack(out, 2).contiguous()


def wkv6_case(lib, B, S, H, hd, C, dtype, decay, full, seed) -> bool:
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.5):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    r, k, v = (mk(B, S, H, hd).to(dtype).transpose(1, 2) for _ in range(3))
    logw = (-torch.exp(mk(B, S, H, hd) + decay)).transpose(1, 2)
    u = mk(H, hd, scale=0.15)
    s0 = mk(B, H, hd, hd, scale=0.05 if full else 0.0)
    dy = mk(B, S, H, hd, scale=1.0).transpose(1, 2)
    ds = mk(B, H, hd, hd, scale=1.0) if full else None
    starts = starts_of(k, v, logw, s0, C)
    NC, TPC = S // C, -(-C // 32)
    dr, dk, dv = (torch.empty((B, S, H, hd), dtype=dtype).transpose(1, 2)
                  for _ in range(3))
    dw = torch.empty((B, S, H, hd)).transpose(1, 2)
    du, ds0 = torch.empty((H, hd)), torch.empty((B, H, hd, hd))
    scratch = [torch.empty((B, H, NC, hd, hd)),
               torch.empty((B, H, NC * TPC, hd)),
               torch.empty((B, H, NC * TPC, 2, hd)) if TPC > 1 else None,
               torch.empty((B, H, NC, hd)) if TPC > 1 else None]
    strides = (ctypes.c_longlong * 27)(*(
        s for t in (r, k, v, logw, dy, dr, dk, dv, dw)
        for s in t.stride()[:3]))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = lib.wkv6_bwd_launch(
        *map(ptr, (r, k, v, logw, dy, u, starts, ds, dr, dk, dv, dw, du,
                   ds0, *scratch)),
        1 if dtype == torch.bfloat16 else 0, B, H, S, hd, C, strides, None)
    assert err == 0, err
    want = wkv6_bwd_ref(r, k, v, logw, u, s0, dy, ds, chunk=C)
    errs, ok = {}, True
    for n, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"),
                       (dr, dk, dv, dw, du, ds0), want):
        tol = 8e-3 if g.dtype == torch.bfloat16 else 1e-4
        g, w = g.float(), w.float()
        errs[n] = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        ok &= bool(torch.isfinite(g).all()) and errs[n] <= tol
    print(f"wkv6_bwd B,S,H,hd,C={B},{S},{H},{hd},{C} {str(dtype)[6:]} decay "
          f"{decay}{' with d(state), s0' if full else ''}: " + ", ".join(
              f"{n} {e:.2e}" for n, e in errs.items())
          + (" ok" if ok else " FAIL"), flush=True)
    return ok


def rglru_case(lib, B, S, W, dtype, seed) -> bool:
    """phase 17(a)'s inputs and measure, at a small shape."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * scale + shift)
    xb = mk(B, S, W).to(dtype)
    wa, wi, lam = mk(W, scale=0.5), mk(W, scale=0.5), mk(W, shift=0.65)
    h0 = mk(B, W)
    H, hl = torch.empty_like(xb), torch.empty((B, W))
    states = torch.empty((B, S, W)) if dtype == torch.bfloat16 else None
    err = lib.rglru_launch(xb.data_ptr(), wa.data_ptr(), wi.data_ptr(),
                           lam.data_ptr(), h0.data_ptr(), H.data_ptr(),
                           hl.data_ptr(),
                           None if states is None else states.data_ptr(),
                           1 if dtype == torch.bfloat16 else 0, B, S, W,
                           None)
    assert err == 0, err
    want, want_hl = rglru_ref(xb.float(), wa, wi, lam, h0)
    if states is not None:               # the float32 states the backward
        want_s = want.float()            # reads: H before its cast
        err_s = float((states - want_s).abs().max()) / float(
            want_s.abs().max().clamp_min(1e-30))
        ok_s = err_s <= K5_TOL and torch.equal(states[:, -1], hl) and \
            torch.equal(states.to(dtype), H)
    scale = float(want.abs().max().clamp_min(1e-30))
    if dtype == torch.float32:
        err_h = float((H - want).abs().max()) / scale
    else:
        err_h = float(bf16_rounding_excess(torch, H, want).max()) / scale
    err_l = float((hl - want_hl).abs().max()
                  / want_hl.abs().max().clamp_min(1e-30))
    ok = (bool(torch.isfinite(H.float()).all()) and err_h <= K5_TOL
          and err_l <= K5_TOL)
    if dtype == torch.float32:           # h_last is H's last step
        ok = ok and torch.equal(hl, H[:, -1])
    else:
        ok = ok and ok_s
    print(f"rglru B,S,W={B},{S},{W} {str(dtype)[6:]} h0 != 0: H {err_h:.2e}, "
          f"h_last {err_l:.2e} of the largest magnitude"
          + (f", float32 states {err_s:.2e} (H their cast, h_last their "
             f"last step)" if states is not None else "")
          + (" ok" if ok else " FAIL"), flush=True)
    return ok


def rglru_bwd_case(lib, B, S, W, dtype, big=False, *, seed) -> bool:
    """phase 19(a)'s inputs and measure, at a small shape: the float32
    gradients within K5B_TOL of their largest magnitude, a bfloat16 dxb by
    the error its rounding implies; a nonzero h0 and dh_last. `big`: every
    fifth x +-400."""
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32) * scale + shift)
    xb = mk(B, S, W)
    if big:
        xb.view(-1)[::5] = 400.0 * torch.sign(xb.view(-1)[::5])
    xb = xb.to(dtype)
    wa, wi, lam = mk(W, scale=0.5), mk(W, scale=0.5), mk(W, shift=0.65)
    h0, dh_last = mk(B, W), mk(B, W)
    dH = mk(B, S, W).to(dtype)
    H, _ = rglru_states_ref(xb.float(), wa, wi, lam, h0)
    dxb = torch.empty_like(xb)
    dwa, dwi, dlam = (torch.empty(W) for _ in range(3))
    dh0, part = torch.empty((B, W)), torch.empty((B, 3, W))
    err = lib.rglru_bwd_launch(*(t.data_ptr() for t in (
        xb, wa, wi, lam, h0, H, dH, dh_last, dxb, dwa, dwi, dlam, dh0,
        part)), 1 if dtype == torch.bfloat16 else 0, B, S, W, None)
    assert err == 0, err
    # float32 inputs of the same values: dxb before its cast
    want = rglru_bwd_ref(xb.float(), wa, wi, lam, h0, H, dH.float(),
                         dh_last)
    errs, ok = {}, True
    for n, g, w in zip(("dxb", "dwa", "dwi", "dlam", "dh0"),
                       (dxb, dwa, dwi, dlam, dh0), want):
        if g.dtype == torch.bfloat16:
            e = float(bf16_rounding_excess(torch, g, w).max())
        else:
            e = float((g - w).abs().max())
        errs[n] = e / float(w.float().abs().max().clamp_min(1e-30))
        ok &= bool(torch.isfinite(g.float()).all()) and errs[n] <= K5B_TOL
    print(f"rglru_bwd B,S,W={B},{S},{W} {str(dtype)[6:]} h0, dh_last != 0"
          + (", |x| = 400 at every fifth" if big else "") + ": "
          + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
          + " of the largest magnitude" + (" ok" if ok else " FAIL"),
          flush=True)
    return ok


SUITES = {
    "wkv6_bwd": (WKV6_CASES, wkv6_case,
                 lambda lib: lib.wkv6_bwd_launch, [ctypes.c_void_p] * 18
                 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]),
    "rglru": (RGLRU_CASES, rglru_case, lambda lib: lib.rglru_launch,
              [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
              + [ctypes.c_void_p]),
    "rglru_bwd": (RGLRU_BWD_CASES, rglru_bwd_case,
                  lambda lib: lib.rglru_bwd_launch,
                  [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p]),
}


def run(name: str, chosen=None) -> bool:
    cases, case_fn, entry, argtypes = SUITES[name]
    lib = build(name)
    entry(lib).argtypes = argtypes
    chosen = chosen or range(len(cases))
    return all([case_fn(lib, *cases[j], seed=j) for j in chosen])


def main() -> None:
    args = sys.argv[1:]
    names = [args.pop(0)] if args and args[0] in SUITES else list(SUITES)
    chosen = [int(a) for a in args]
    failed = [n for n in names if not run(n, chosen)]
    if failed:
        sys.exit(f"FAIL: {', '.join(failed)} differs from its plain version")
    print("every case within the kernel's limits")


if __name__ == "__main__":
    main()
