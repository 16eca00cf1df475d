"""Fused fleet-score scoring of (R, M, N) detector rows: peer median,
MAD, robust z and threshold verdicts in float32, as a hand-written CUDA
kernel with its plain PyTorch version."""
from repro_torch.kernels.fleet_score.fleet_score import COUNTER, fleet_score
from repro_torch.kernels.fleet_score.ops import score_rows
from repro_torch.kernels.fleet_score.ref import median_lastdim, score_rows_ref

__all__ = ["COUNTER", "fleet_score", "median_lastdim", "score_rows",
           "score_rows_ref"]
