"""A kernel's share of its roofline in a traced run: the bound of its
calls (the larger of operations over the peak and bytes over the memory
rate, per call, from the kernel's own count file) over the device time
of its kernels in the trace, in %. None where the trace holds none of its
calls."""
from __future__ import annotations

import importlib
from typing import Optional


def share(kernel: str, ctx: dict) -> Optional[float]:
    k = importlib.import_module(f"bench.kernels.{kernel}")
    tr = ctx["trace"]
    if tr is None:
        return None
    calls = tr.count(k.COUNT)
    prefixes = k.PREFIX if isinstance(k.PREFIX, tuple) else (k.PREFIX,)
    seconds = sum(tr.kernel_s(p) for p in prefixes)
    if not calls or seconds <= 0:
        return None
    return 100.0 * calls * k.bound_s(ctx["run"], ctx["traffic"],
                                     ctx["peaks"]) / seconds
