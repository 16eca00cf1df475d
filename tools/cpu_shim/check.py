"""Run csrc/wkv6_bwd.cu on the CPU, through its C entry point, against the
CPU stand-in of the CUDA runtime in this directory, and hold its six
gradients to ``wkv6_bwd_ref`` (the kernel's limits: 1e-4 of each
gradient's largest magnitude in float32, 8e-3 for bfloat16 dr, dk, dv).
Needs g++ (C++20) and PyTorch for the CPU; no card, no nvcc.

    python3 tools/cpu_shim/check.py          # every case
    python3 tools/cpu_shim/check.py 0 4      # cases 0 and 4

It checks the kernel's logic (indexing, swizzles, fragment layouts,
scans, masks, tiles of a chunk), not its speed or its PTX: the stand-in
runs each CUDA thread as an OS thread, a few seconds a case.
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
from repro_torch.kernels.wkv6.ref import _clip_exp, wkv6_bwd_ref  # noqa: E402

OUT = ROOT / "build" / "cpu_shim"
# B, S, H, hd, C, dtype, decay (mean of log(-logw)), d(state) and s0
CASES = [
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


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cpp = OUT / "wkv6_bwd_cpu.cpp"
    cpp.write_text(subprocess.run(
        [sys.executable, str(HERE / "rewrite.py"),
         str(ROOT / "src/repro_torch/csrc/wkv6_bwd.cu")],
        check=True, capture_output=True, text=True).stdout)
    lib = OUT / "libwkv6_bwd_cpu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", f"-I{HERE}", "-o", str(lib), str(cpp)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.wkv6_bwd_launch.argtypes = ([p] * 18 + [i] * 6 +
                                    [ctypes.POINTER(ctypes.c_longlong), p])
    return dll


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


def run_case(lib, B, S, H, hd, C, dtype, decay, full, seed) -> bool:
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
    print(f"B,S,H,hd,C={B},{S},{H},{hd},{C} {str(dtype)[6:]} decay {decay}"
          f"{' with d(state), s0' if full else ''}: " + ", ".join(
              f"{n} {e:.2e}" for n, e in errs.items())
          + (" ok" if ok else " FAIL"), flush=True)
    return ok


def main() -> None:
    lib = build()
    chosen = [int(a) for a in sys.argv[1:]] or range(len(CASES))
    results = [run_case(lib, *CASES[j], seed=j) for j in chosen]
    if not all(results):
        sys.exit("FAIL: the kernel differs from wkv6_bwd_ref")
    print("every case within the kernel's limits")


if __name__ == "__main__":
    main()
