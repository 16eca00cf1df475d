"""Roofline terms of a dry-run cell on NVIDIA H100s: the port of
``repro.launch.roofline``.

Three terms, in seconds, per training or serving step:

  compute    = flops       / (chips x PEAK_FLOPS)
  memory     = bytes       / (chips x HBM_BW)
  collective = coll_bytes  / LINK_BW            (bytes a chip sends)

The counts come from ``repro_torch.launch.step_analysis`` (per rank; the
dry run multiplies by the chips, as the reference does). ``Roofline`` and
``model_flops_for`` keep the reference's fields, properties, ``to_dict``
keys and arithmetic; only the constants are the H100's:

  PEAK_FLOPS  989e12 FLOP/s, bf16 dense on the tensor cores (NVIDIA H100
              SXM data sheet; ``PERF.md`` section 3).
  HBM_BW      3.35e12 B/s of HBM3 (the same data sheet).
  LINK_BW     50e9 B/s a direction, an assumption: the slowest link a
              collective of the production meshes crosses. A DGX H100
              node holds 8 GPUs joined by NVLink (450 GB/s a direction
              each), and each GPU has one 400 Gb/s NDR InfiniBand port to
              the other nodes: 400e9 / 8 = 50e9 B/s a direction. Every
              group of the (16, 16) and (2, 16, 16) meshes crosses a node
              boundary ("model" = 16 spans two nodes; "data" and "pod"
              span nodes), so a ring collective over any of them is paced
              by InfiniBand, not by NVLink. That this equals the
              reference's v5e ICI figure is a coincidence.

The reference's ``collective_bytes(hlo_text)`` parses HLO text and has no
counterpart: ``step_analysis`` counts the collectives as the step issues
them. None of these terms is a measurement: they bound a mesh of H100s
that the card machine does not have.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12          # bf16 dense tensor cores, per chip
HBM_BW = 3.35e12             # bytes/s per chip
LINK_BW = 50e9               # bytes/s per chip, one InfiniBand port


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # global, all chips
    hlo_bytes: float             # global memory traffic (upper-bound proxy)
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, int]
    model_flops: float           # 6·N(active)·D tokens-based
    peak_mem_bytes: Optional[float] = None
    hlo_bytes_lower: float = 0.0  # global matmul-only traffic (fused ideal)

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The ideal step time over the bound: the ideal is bounded below
        by both the useful-FLOPs compute time and the irreducible
        (matmul-streaming) memory time; decode steps are bandwidth-bound,
        so the memory floor is part of the roofline."""
        ideal = max(self.model_flops / (self.chips * PEAK_FLOPS),
                    self.hlo_bytes_lower / (self.chips * HBM_BW))
        return ideal / self.step_bound_s if self.step_bound_s else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "peak_mem_bytes": self.peak_mem_bytes,
            "hlo_bytes_lower": self.hlo_bytes_lower,
            "memory_lower_s": self.hlo_bytes_lower / (self.chips * HBM_BW),
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape) -> float:
    """Useful FLOPs per step: 6·N·D for training (forward and backward),
    2·N·D for inference (forward only), N the active parameters (MoE), D
    the tokens of this step; a decode step processes ``global_batch``
    tokens."""
    n = cfg.active_param_count()
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n * shape.tokens


__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "Roofline", "model_flops_for"]
