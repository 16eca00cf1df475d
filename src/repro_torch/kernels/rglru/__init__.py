"""The RG-LRU scan (Griffin's Real-Gated Linear Recurrent Unit, gates
included) as a hand-written CUDA kernel, with its plain PyTorch version."""
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rglru.ref import (DECAY_SCALE, decay_and_input,
                                           gates, rglru_bytes, rglru_flops,
                                           rglru_ref, rglru_sfu_ops)
from repro_torch.kernels.rglru.rglru import COUNTER, rglru_scan

__all__ = ["COUNTER", "DECAY_SCALE", "decay_and_input", "gates", "rglru",
           "rglru_bytes", "rglru_flops", "rglru_ref", "rglru_scan",
           "rglru_sfu_ops"]
