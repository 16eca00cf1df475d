"""Seeded weights, drawn on the device in a few large calls.

Every parameter of a configuration's spec (``reference.<family>.
param_spec``) is a slice of one stream of standard normal numbers, drawn
in float32 in blocks of ``BLOCK`` values, block b from a generator seeded
with (seed, b), and scaled by its initializer; constant initializers
(zeros, ones, a value) take no numbers from the stream. Each value is then
rounded to the type it is trained in (bfloat16 working weights; the
float32 master weights are their widening), so the program and the
reference start from the same numbers. Any block can be drawn again on
its own, so the starting weights can be rebuilt later without keeping a
copy.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch

BLOCK = 1 << 27          # values a draw (512 MiB of float32)


def _layout(spec) -> Tuple[List[tuple], int]:
    """(name, shape, init, offset into the stream or -1), stream length."""
    out, off = [], 0
    for name, shape, init in spec:
        if init[0] == "normal":
            out.append((name, tuple(shape), init, off))
            off += math.prod(shape)
        else:
            out.append((name, tuple(shape), init, -1))
    return out, off


def _block(seed: int, b: int, n: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + b) % (1 << 63))
    return torch.randn(n, generator=gen, device=device, dtype=torch.float32)


def leaves(spec, seed: int, device, dtype=torch.bfloat16
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, value in ``dtype``) of every parameter, in the spec's order;
    the stream is drawn block by block as the leaves reach it."""
    layout, total = _layout(spec)
    cur_b, cur = -1, None
    for name, shape, init, off in layout:
        if off < 0:
            value = {"zeros": 0.0, "ones": 1.0}.get(init[0])
            value = init[1] if value is None else value
            yield name, torch.full(shape, float(value), dtype=dtype,
                                   device=device)
            continue
        n = math.prod(shape)
        out = torch.empty(n, dtype=dtype, device=device)
        done = 0
        while done < n:
            pos = off + done
            b = pos // BLOCK
            if b != cur_b:
                cur = _block(seed, b, min(BLOCK, total - b * BLOCK), device)
                cur_b = b
            lo = pos - b * BLOCK
            take = min(n - done, BLOCK - lo)
            out[done:done + take] = cur[lo:lo + take] * init[1]
            done += take
        yield name, out.view(shape)


def load_into(named: Dict[str, torch.Tensor], spec, seed: int) -> None:
    """Draw the spec's weights into the tensors of ``named`` (the program's
    parameters by name), which must hold exactly the spec's names and
    shapes."""
    want = {n: tuple(s) for n, s, _ in spec}
    have = {n: tuple(t.shape) for n, t in named.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise ValueError(f"the program's parameters differ from the "
                         f"configuration's spec: {diff}")
    device = next(iter(named.values())).device
    with torch.no_grad():
        for name, value in leaves(spec, seed, device,
                                  next(iter(named.values())).dtype):
            named[name].copy_(value)


def per_leaf(spec, seed: int, device,
             fn: Callable[[str, torch.Tensor], float]) -> Dict[str, float]:
    """``fn(name, float32 widening of the bfloat16 starting value)`` for
    every leaf, drawing the stream again."""
    return {name: fn(name, v.float())
            for name, v in leaves(spec, seed, device)}
