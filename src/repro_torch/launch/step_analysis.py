"""What one step of the port costs a rank: the counterpart of
``repro.launch.hlo_analysis``.

The reference parses the post-SPMD HLO that XLA compiled and counts, per
device and per step, the dot FLOPs, an HBM-traffic proxy and each
collective's bytes. The port has no HLO to parse, so ``analyze`` runs the
step itself once, eagerly, under ``torch.utils.flop_counter.FlopCounterMode``
and a ``TorchDispatchMode`` that sees every aten operator and every
``c10d`` collective the step issues, and counts them. On the meta device
(the dry run, ``repro_torch.launch.dryrun``) nothing is computed and
nothing allocated; the hand-written kernels, which aten does not see, are
replaced there by their stand-ins (``repro_torch.kernels.meta``), which
report the operations and bytes each call needs.

``ModuleCost`` keeps the reference's fields and their meaning, per rank and
per step:

  flops               FlopCounterMode's count (matmuls, convolutions,
                      attention) plus the stand-ins' operations
  traffic_bytes       the reference's ``fused=True`` rule: twice each
                      operator's output bytes (written once, read once by
                      its consumer), plus the operand bytes of mm, bmm,
                      addmm and baddbmm (whose inputs stream from memory),
                      plus the stand-ins' bytes
  traffic_bytes_upper the operand and result bytes of every operator,
                      plus the stand-ins' bytes
  dot_traffic_bytes   the operand and result bytes of mm, bmm, addmm and
                      baddbmm, plus the stand-ins' bytes
  collective_bytes    every collective counted once, as the larger of its
                      operand and result bytes; ``collective_breakdown``
                      by the reference's kind names ("all-reduce",
                      "all-gather", "reduce-scatter", "all-to-all", ...)
  flops_by_comp       FlopCounterMode's module breakdown, the top 20
  coll_by_comp        collective bytes by the module that issued them

Views (view, ``_unsafe_view``, transpose, expand, slice, ``as_strided``,
alias, and every operator whose schema returns an alias of its input) and
allocations that write nothing (``empty``) move no bytes and are not
counted. The reference's ``trip_counts`` is dropped: XLA's cost analysis
counts a ``while`` body once, so the reference multiplies each
computation by its loops' trip counts, while eager code runs every
iteration of every loop, each operator is seen as often as it runs, and
nothing needs multiplying. ``kernel_calls``, ``kernel_flops`` and
``kernel_bytes`` are the stand-ins' share (``flops - kernel_flops`` is
the aten count), which the reference has no need of.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict
from typing import Any, Callable, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import meta

aten = torch.ops.aten

_MATMUL = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_NO_TRAFFIC = {aten._unsafe_view, aten.empty, aten.empty_strided,
               aten.empty_like, aten.new_empty, aten.new_empty_strided}
_KINDS = (("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
          ("reduce_scatter", "reduce-scatter"), ("allgather", "all-gather"),
          ("all_gather", "all-gather"), ("alltoall", "all-to-all"),
          ("all_to_all", "all-to-all"), ("broadcast", "collective-broadcast"),
          ("send", "collective-permute"), ("recv", "collective-permute"))


def _nbytes(x: Any) -> int:
    """Bytes of the tensors in ``x`` (a pytree); a DTensor's local shard."""
    total = 0
    for t in tree_flatten(x)[0]:
        if isinstance(t, torch.Tensor):
            t = getattr(t, "_local_tensor", t)
            total += t.numel() * t.element_size()
    return total


def collective_kind(op) -> str:
    """The reference's kind name of a ``c10d`` operator, "" for one that
    moves no data (a barrier, a monitored wait)."""
    name = op.name().split("::")[-1].split(".")[0]
    for key, kind in _KINDS:
        if key in name:
            return kind
    return ""


@dataclasses.dataclass
class ModuleCost:
    flops: float                        # per rank, per step
    traffic_bytes: float                # the fused estimate
    traffic_bytes_upper: float          # unfused upper bound
    dot_traffic_bytes: float            # matmul-streaming lower bound
    collective_bytes: float             # per rank
    collective_breakdown: Dict[str, float]
    flops_by_comp: Dict[str, float]     # top contributors
    coll_by_comp: Dict[str, float]
    kernel_calls: Dict[str, int]        # stand-in calls by kernel
    kernel_flops: float
    kernel_bytes: float


class _Traffic(TorchDispatchMode):
    """Counts each operator's bytes and each collective's, by module."""

    def __init__(self, modules: Callable[[], Iterable[str]]):
        super().__init__()
        self.modules = modules
        self.fused = self.upper = self.dot = 0.0
        self.coll: Dict[str, float] = defaultdict(float)
        self.coll_by: Dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = collective_kind(func)
            if kind:
                first, rest = _nbytes(args[:1]), _nbytes((args[1:], kwargs))
                n = float(max(first, rest, _nbytes(out)))
                self.coll[kind] += n
                for mod in set(self.modules()):
                    self.coll_by[mod] += n
            return out
        packet = func.overloadpacket
        if func.is_view or packet in _NO_TRAFFIC:
            return out
        out_b, in_b = _nbytes(out), _nbytes((args, kwargs))
        self.upper += out_b + in_b
        self.fused += 2 * out_b
        if packet in _MATMUL:
            self.fused += in_b
            self.dot += out_b + in_b
        return out


def analyze(fn: Callable, *args, **kwargs) -> ModuleCost:
    """Runs ``fn(*args, **kwargs)`` once and counts what it issued (see the
    module's docstring). The result of ``fn`` is dropped."""
    fc = FlopCounterMode(display=False)
    tracker = getattr(fc, "mod_tracker", None)
    traffic = _Traffic(lambda: getattr(tracker, "parents", ("Global",)))
    with meta.recording() as calls, fc, traffic:
        fn(*args, **kwargs)
    kflops = sum(c.flops for c in calls)
    kbytes = sum(c.bytes for c in calls)
    by_mod = {name: float(sum(ops.values()))
              for name, ops in fc.get_flop_counts().items()}
    if kflops:
        by_mod["kernels"] = kflops
    return ModuleCost(
        flops=float(fc.get_total_flops()) + kflops,
        traffic_bytes=traffic.fused + kbytes,
        traffic_bytes_upper=traffic.upper + kbytes,
        dot_traffic_bytes=traffic.dot + kbytes,
        collective_bytes=float(sum(traffic.coll.values())),
        collective_breakdown=dict(traffic.coll),
        flops_by_comp=dict(sorted(by_mod.items(),
                                  key=lambda kv: -kv[1])[:20]),
        coll_by_comp=dict(sorted(traffic.coll_by.items(),
                                 key=lambda kv: -kv[1])[:20]),
        kernel_calls=dict(Counter(c.name for c in calls)),
        kernel_flops=kflops, kernel_bytes=kbytes)


__all__ = ["ModuleCost", "analyze", "collective_kind"]
