# guardlint: hot  (fleet-sized arrays live here: float32, no per-node loops)
"""Plain PyTorch version of the fleet-score kernel: batched peer-relative
scoring of ring-buffer rows, float32 end-to-end.

The same function as the NumPy oracle ``score_rows_ref`` of the JAX
package: for each of R history rows and M metrics, score all N nodes
against their peer baseline (median, MAD, robust z, directional
threshold) and derive the step-time relative excess and its
deviation-masked contribution.

Medians are exact order statistics selected on uint32 keys in IEEE total
order, with every NaN first made the canonical quiet NaN ``0x7fc00000``,
so that all NaNs sort last, where ``np.partition`` puts them. (Keying the
raw bits would put a NaN with its sign bit set, such as x86's default
``0xffc00000`` from ``inf - inf``, below ``-inf``.) ``torch.median`` is
not used: it returns the lower middle value for even N. Every constant is
a float32 and every operation a correctly rounded float32 one, so the
results are bit-identical to the oracle's and to the CUDA kernel's.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

_F32 = np.float32
_SIGN = 0x80000000
_MASK = 0xFFFFFFFF
_CANON_NAN = 0x7FC00000


def float_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 keys in [0, 2**32) in IEEE total order, NaNs
    canonicalized first (so they are all largest)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & _MASK
    u = torch.where(torch.isnan(x), torch.full_like(u, _CANON_NAN), u)
    return torch.where(u >= _SIGN, _MASK - u, u | _SIGN)


def key_float(k: torch.Tensor) -> torch.Tensor:
    """Inverse of ``float_key``: the exact float32 bit pattern back."""
    u = torch.where(k >= _SIGN, k ^ _SIGN, _MASK - k)
    u = torch.where(u >= _SIGN, u - (1 << 32), u)      # to int32 range
    return u.to(torch.int32).view(torch.float32)


def median_lastdim(x: torch.Tensor) -> torch.Tensor:
    """(..., N) float32 -> (..., 1) median along the last axis, equal to
    ``np.median``'s float32 result: the middle order statistic for odd N,
    ``(a + b) / 2`` of the two middle ones for even N."""
    n = x.shape[-1]
    h = n // 2
    keys, _ = torch.sort(float_key(x), dim=-1)
    hi = key_float(keys[..., h:h + 1])
    if n % 2:
        return hi
    lo = key_float(keys[..., h - 1:h])
    return (lo + hi) / 2.0


def score_rows_ref(
    mats: torch.Tensor,
    dirs: Union[Sequence[float], torch.Tensor],
    st_j: Optional[int],
    *,
    z_threshold: float = 3.0,
    slowdown_floor: float = 0.025,
    mad_floor_frac: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score R ring-buffer rows in one pass.

    Args:
      mats: (R, M, N) float32 - R history rows x M metrics x N nodes.
      dirs: (M,) unhealthy-deviation directions (+1 higher-is-bad).
      st_j: metric index of ``step_time`` (None: no primary signal).

    Returns ``(dev, rel, contrib)`` on ``mats``' device:
      dev     (R, M, N) bool - peer-relative deviation verdicts; the
              step_time row also needs the relative excess to clear
              ``slowdown_floor``.
      rel     (R, N) float32 - step-time excess over the peer median.
      contrib (R, N) float32 - ``rel`` where step-deviant, else 0.
    """
    if mats.dim() != 3 or mats.dtype != torch.float32:
        raise ValueError(f"mats must be (R, M, N) float32, got "
                         f"{tuple(mats.shape)} {mats.dtype}")
    r, m, n = mats.shape
    dev_ = mats.device

    def f32(v: float) -> torch.Tensor:
        return torch.tensor(_F32(v), dtype=torch.float32, device=dev_)

    d = torch.as_tensor(dirs, dtype=torch.float32, device=dev_).reshape(
        1, m, 1)
    med = median_lastdim(mats)                              # (R, M, 1)
    diff = mats - med
    mad = median_lastdim(torch.abs(diff))
    floor = torch.maximum(torch.abs(med) * f32(mad_floor_frac), f32(1e-9))
    scale = torch.maximum(mad / f32(0.6745), floor)
    z = (diff / scale) * d
    dev = z > f32(z_threshold)
    rel = torch.zeros((r, n), dtype=torch.float32, device=dev_)
    contrib = torch.zeros((r, n), dtype=torch.float32, device=dev_)
    if st_j is not None:
        med_st = torch.maximum(med[:, st_j], f32(1e-9))     # (R, 1)
        rel = mats[:, st_j] / med_st - f32(1.0)
        sdev = dev[:, st_j] & (rel > f32(slowdown_floor))
        dev[:, st_j] = sdev
        contrib = torch.where(sdev, rel, f32(0.0))
    return dev, rel, contrib


__all__ = ["float_key", "key_float", "median_lastdim", "score_rows_ref"]
