"""The RG-LRU scan (Griffin's Real-Gated Linear Recurrent Unit, gates
included) and its backward as hand-written CUDA kernels, with their plain
PyTorch versions."""
from repro_torch.kernels.rglru.ops import rglru, rglru_plain
from repro_torch.kernels.rglru.ref import (DECAY_SCALE, decay_and_input,
                                           gates, rglru_bwd_bytes,
                                           rglru_bwd_flops, rglru_bwd_ref,
                                           rglru_bwd_sfu_ops, rglru_bytes,
                                           rglru_flops, rglru_ref,
                                           rglru_sfu_ops, rglru_states_ref)
from repro_torch.kernels.rglru.rglru import (BWD_COUNTER, COUNTER,
                                             rglru_scan, rglru_scan_bwd,
                                             rglru_scan_bwd_meta,
                                             rglru_scan_meta)

__all__ = ["BWD_COUNTER", "COUNTER", "DECAY_SCALE", "decay_and_input",
           "gates", "rglru", "rglru_bwd_bytes", "rglru_bwd_flops",
           "rglru_bwd_ref", "rglru_bwd_sfu_ops",
           "rglru_bytes", "rglru_flops", "rglru_plain", "rglru_ref",
           "rglru_scan", "rglru_scan_bwd", "rglru_scan_bwd_meta",
           "rglru_scan_meta", "rglru_sfu_ops",
           "rglru_states_ref"]
