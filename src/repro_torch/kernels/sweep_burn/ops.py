"""Public burn entry points: timed sustained-throughput measurement and a
local-device ``SweepBackend``, so the offline sweep (§5.2) runs for real
on the card that hosts this process.

``run_burn`` dispatches on where its inputs lie: CPU tensors go to the
plain PyTorch version, CUDA tensors to the hand-written kernel, which
either launches or raises.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.sweep import SweepReference
from repro_torch.device import DeviceLike, resolve
from repro_torch.kernels.sweep_burn.ref import burn_ref
from repro_torch.kernels.sweep_burn.sweep_burn import burn, burn_flops


def run_burn(a: torch.Tensor, b: torch.Tensor, *, iters: int = 64
             ) -> torch.Tensor:
    """The burn chain on the inputs' device (see ``ref.burn_ref``)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return burn_ref(a, b, iters=iters)
    return burn(a, b, iters=iters)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _burn_inputs(m: int, k: int, seed: int, dev: torch.device):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, k), dtype=np.float32)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


def measure_tflops(m: int = 512, k: int = 512, iters: int = 64,
                   repeats: int = 3, seed: int = 0,
                   device: DeviceLike = "cuda") -> float:
    """Median sustained TFLOP/s of the burn chain on ``device``: CUDA
    events around each repeat on the card, the host clock on the CPU."""
    dev = resolve(device)
    a, b = _burn_inputs(m, k, seed, dev)
    run_burn(a, b, iters=iters)                   # build / warm
    _sync(dev)
    ts = []
    for _ in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run_burn(a, b, iters=iters)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run_burn(a, b, iters=iters)
            ts.append(time.perf_counter() - t0)
    return burn_flops(m, k, iters) / float(np.median(ts)) / 1e12


class LocalTorchSweepBackend:
    """SweepBackend over the local device: compute probes run the burn
    kernel; the bandwidth probe times a 16 MB elementwise round trip on
    one device; the multi-node probe times a sum-shaped reduction (a
    single-host stand-in, as in the JAX package's backend)."""

    def __init__(self, reference: Optional[SweepReference] = None,
                 device: DeviceLike = "cuda"):
        self.device = resolve(device)
        self._ref = reference

    def device_count(self, node_id: int) -> int:
        if self.device.type == "cuda":
            return torch.cuda.device_count()
        return 1

    def compute_probe(self, node_id: int, device: int,
                      seconds: float) -> float:
        iters = max(8, min(int(seconds), 64))
        return measure_tflops(iters=iters, seed=device, device=self.device)

    def intra_bw_probe(self, node_id: int, dev_a: int, dev_b: int) -> float:
        x = torch.ones((4 << 20,), dtype=torch.float32,
                       device=self.device)            # 16 MB
        x = x + 1                                     # warm
        _sync(self.device)
        t0 = time.perf_counter()
        for _ in range(4):
            x = x + 1
        _sync(self.device)
        dt = time.perf_counter() - t0
        return 4 * 2 * x.numel() * x.element_size() / dt / 1e9

    def multi_node_probe(self, node_ids: Sequence[int],
                         steps: int) -> np.ndarray:
        x = torch.ones((1 << 20,), dtype=torch.float32, device=self.device)
        (x.sum() + x).sum()                           # warm
        _sync(self.device)
        ts = []
        for _ in range(min(steps, 10)):
            t0 = time.perf_counter()
            x.sum() + x
            _sync(self.device)
            ts.append(time.perf_counter() - t0)
        return np.asarray(ts)

    def reference(self) -> SweepReference:
        if self._ref is None:
            # self-calibrate: the current device defines "healthy"
            tf = measure_tflops(device=self.device)
            bw = self.intra_bw_probe(0, 0, 1)
            st = float(np.median(self.multi_node_probe([0, 1], 5)))
            self._ref = SweepReference(tf, bw, st)
        return self._ref


__all__ = ["LocalTorchSweepBackend", "measure_tflops", "run_burn"]
