"""Shape-only stand-ins of the hand-written kernels, for meta tensors.

A model built on ``device="meta"`` (the dry run,
``repro_torch.launch.dryrun``) holds no data, so no kernel can launch,
and the plain versions are no stand-in either: the recurrences' plain
versions loop over the sequence in Python (minutes to hours a cell at
32k-500k tokens), and the plain attention computes the masked half of a
causal score matrix that the kernel skips. So each dispatcher on the
model path (``flash_attention.ops``, ``wkv6.ops``, ``rglru.ops``) sends
a meta tensor to its kernel's stand-in (``*_meta`` beside each wrapper):
it returns empty meta tensors of the shapes, dtypes and strides the
kernel's wrapper returns, and reports the operations and bytes the
kernel needs for the call (the formulas behind the bound column of
``PERF.md``'s kernel table) to every ``recording`` block open, which is
how ``repro_torch.launch.step_analysis`` counts them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One stand-in call: the kernel's name, the operations and the bytes
    its work needs (each input read once, each output written once)."""
    name: str
    flops: float
    bytes: float


_sinks: List[List[KernelCall]] = []


def report(name: str, flops: float, nbytes: float) -> None:
    """Adds one call of kernel ``name`` to every open ``recording``."""
    call = KernelCall(name, float(flops), float(nbytes))
    for sink in _sinks:
        sink.append(call)


@contextlib.contextmanager
def recording() -> Iterator[List[KernelCall]]:
    """A list that collects the stand-ins' calls inside the block."""
    calls: List[KernelCall] = []
    _sinks.append(calls)
    try:
        yield calls
    finally:
        _sinks.remove(calls)


__all__ = ["KernelCall", "recording", "report"]
