# guardlint: hot  (fleet-sized arrays live here: float32, no per-node loops)
"""Public fleet-score entry point: one call scores R ring-buffer rows.

``score_rows`` dispatches on where its input lies: a CPU tensor goes to
the plain PyTorch version (``ref.py``), a CUDA tensor to the hand-written
kernel (``fleet_score.py``), which either launches or raises. There is no
fall back from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels.fleet_score.fleet_score import fleet_score
from repro_torch.kernels.fleet_score.ref import score_rows_ref


def score_rows(
    mats: torch.Tensor,
    dirs: Union[Sequence[float], torch.Tensor],
    st_j: Optional[int],
    *,
    z_threshold: float = 3.0,
    slowdown_floor: float = 0.025,
    mad_floor_frac: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score R history rows of M metrics over N nodes in one fused pass.

    Returns ``(dev, rel, contrib)`` on the input's device: (R, M, N) bool
    verdicts, (R, N) float32 step-time relative excess, (R, N) float32
    deviation-masked contribution. See ``ref.score_rows_ref``."""
    kw = dict(z_threshold=z_threshold, slowdown_floor=slowdown_floor,
              mad_floor_frac=mad_floor_frac)
    if mats.device.type == "cpu":
        return score_rows_ref(mats, dirs, st_j, **kw)
    if mats.device.type == "cuda":
        return fleet_score(mats.contiguous(), dirs, st_j, **kw)
    raise ValueError(f"score_rows: unsupported device {mats.device}")


__all__ = ["score_rows"]
