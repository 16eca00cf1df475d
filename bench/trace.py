"""Reading a profiler trace of a few training steps: the device's busy and
idle time, each kernel's device time, the idle gaps by what the host was
doing. Frozen from ``chip_smoke.py``'s profiler pieces (``LEAD_CYCLES``,
the lead-in spin against lost kernels, ``basename``, and the check that
the traced calls agree, from ``call_segments``), so that later changes to
the program's own tooling do not move these numbers.

Two sessions follow the window, each over the same number of whole
steps. The first traces the host too, between spans that the harness
opens around the calls into each layer: ``bench.batch`` (the data
source's ``batch_at``), ``bench.step`` (the trainer's step function) and
``bench.hook`` (Guard's step hook); it labels the device's idle gaps and
counts each step's device events. The second traces the device alone, so
that the host runs at its untraced pace: its events give the busy time
over the steps' host-clock seconds, and each kernel's time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# A profiler session after the first one in a process can lose the kernels
# of its first few milliseconds (seen on an H100: up to ~3 ms of them): a
# session starts with a spin of LEAD_CYCLES clock cycles (~20 ms), which
# takes that loss instead.
LEAD_CYCLES = 40_000_000
SPANS = ("bench.batch", "bench.step", "bench.hook")


def basename(name: str) -> str:
    """A kernel's name cut to its function's own name: no return type,
    namespaces, template arguments or parameters."""
    return name.replace("(anonymous namespace)::", "").split("<")[0] \
        .split("(")[0].split("::")[-1].split()[-1]


def label(name: str) -> str:
    """A device event's name as the breakdown gives it: copies and fills
    by their kind, a kernel by its base name and, for PyTorch's
    elementwise and reduction templates, the operation they apply."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    base = basename(name)
    if base.endswith(("elementwise_kernel", "reduce_kernel")):
        ops = [w for w in name.replace("<", " ").replace(",", " ")
               .replace(">", " ").replace("(", " ").split()
               if w.endswith("Functor") or w.endswith("_kernel_cuda")
               or "Ops" in w]
        if ops:
            return f"{base}[{ops[-1].split('::')[-1]}]"
    return base


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    steps: int
    kernels: List[Tuple[str, float, float]]   # (base name, start s, dur s)
    gaps: List[Tuple[str, float]]             # (host activity, seconds)

    def kernel_s(self, prefix: str) -> float:
        return sum(d for n, _, d in self.kernels if n.startswith(prefix))

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.kernels if n == name)


    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for n, _, d in self.kernels:
            tot[n] = tot.get(n, 0.0) + d
        return [[n, s] for n, s in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:k]]

    def top_gaps(self, k: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for n, s in self.gaps:
            tot[n] = tot.get(n, 0.0) + s
        return [[n, s] for n, s in sorted(tot.items(),
                                           key=lambda kv: -kv[1])[:k]]


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _labels(ts, cpu: List[Tuple[str, float, float]]) -> List[str]:
    """For each time in ``ts``: the bench span and the innermost host
    operation running then."""
    import numpy as np
    names = [n for n, _, _ in cpu]
    a = np.array([x for _, x, _ in cpu])
    b = np.array([y for _, _, y in cpu])
    is_span = np.array([n in SPANS for n in names])
    out = []
    for t in ts:
        live = (a <= t) & (t < b)
        span = [names[i] for i in np.flatnonzero(live & is_span)]
        ops = np.flatnonzero(live & ~is_span)
        label = span[0] if span else "trainer loop"
        if ops.size:
            label += " > " + names[ops[np.argmin((b - a)[ops])]]
        out.append(label)
    return out


LABELLED_GAPS = 200


def _events(prof):
    """(host operations, device events) of a finished session: (name,
    start s, end s), the lead-in spin and the spans' own ranges on the
    device timeline left out."""
    from torch.autograd import DeviceType
    cpu, dev = [], []
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if "spin_kernel" not in e.name and e.name not in SPANS:
                dev.append((label(e.name), a, b))
        elif b > a:
            cpu.append((e.name, a, b))
    return cpu, dev


def read_spans(prof) -> Optional[dict]:
    """A session with host tracing over whole steps: the device events a
    step (each step's between its ``bench.step`` span's start and the
    next one's, since the trainer synchronises every step) and the idle
    gaps labelled by what the host was doing. None where a step holds far
    fewer events than another (lost to the tracer) or none was traced.
    Host tracing slows the host, so these gaps are longer than in an
    untraced step: they say where the host holds the device, not how
    long."""
    cpu, dev = _events(prof)
    spans = sorted((n, a, b) for n, a, b in cpu if n in SPANS)
    steps = sorted(a for n, a, _ in spans if n == "bench.step")
    if not steps or not dev:
        return None
    edges = steps + [float("inf")]
    per = [sum(1 for _, a, _ in dev if edges[i] <= a < edges[i + 1])
           for i in range(len(steps))]
    if min(per) < 0.9 * max(per):
        return None
    t0 = min(a for _, a, _ in spans)
    t1 = max(b for _, _, b in spans)
    busy_iv = _merge([(max(a, t0), min(b, t1)) for _, a, b in dev
                      if b > t0 and a < t1])
    raw, last = [], t0
    for a, b in busy_iv + [(t1, t1)]:
        if a > last:
            raw.append(((a + last) / 2, a - last))
        last = max(last, b)
    raw.sort(key=lambda g: -g[1])
    top = raw[:LABELLED_GAPS]
    gaps = list(zip(_labels([t for t, _ in top], cpu), [s for _, s in top]))
    gaps += [("shorter gaps", s) for _, s in raw[LABELLED_GAPS:]]
    return {"events": sum(per), "steps": len(steps), "gaps": gaps}


def read_device(prof, window_s: float, steps: int,
                expect: int) -> Optional[Trace]:
    """A session with device tracing alone over ``steps`` whole steps that
    took ``window_s`` on the host clock: the device's busy time (its
    events merged) and every kernel. None where it holds under 98 % of
    the ``expect``ed events (lost to the tracer)."""
    _, dev = _events(prof)
    if not dev or len(dev) < 0.98 * expect:
        return None
    busy = sum(b - a for a, b in _merge([(a, b) for _, a, b in dev]))
    return Trace(window_s=window_s, busy_s=busy, steps=steps,
                 kernels=[(n, a, b - a) for n, a, b in dev], gaps=[])
