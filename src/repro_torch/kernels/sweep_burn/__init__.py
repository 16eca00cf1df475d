"""Sustained-matmul burn: the offline sweep's compute probe, as a
hand-written CUDA kernel with its plain PyTorch version."""
from repro_torch.kernels.sweep_burn.ops import (LocalTorchSweepBackend,
                                                measure_tflops, run_burn)
from repro_torch.kernels.sweep_burn.ref import burn_ref
from repro_torch.kernels.sweep_burn.sweep_burn import (COUNTER, burn,
                                                       burn_flops)

__all__ = ["COUNTER", "LocalTorchSweepBackend", "burn", "burn_flops",
           "burn_ref", "measure_tflops", "run_burn"]
