"""Carry configuration and detector state into the port.

For Guard, state takes the place of weights: a detector that has seen
windows holds ring buffers, latch state and clean streaks. This module
moves both across without importing ``repro``:

  detector_config / policy_config / sweep_config / triage_config
      build the port's config from any object with the reference's field
      names (duck typing; a reference-only field such as ``scorer`` is
      ignored, and the port's ``device`` comes from the caller).
  load_detector_state(detector, state)
      resume a port detector from a dict of numpy arrays, so that it
      continues where another detector (of either package) stopped.
  detector_state_to_numpy(detector)
      the inverse: that dict, from a port detector or a reference one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.detector import DetectorConfig, StragglerDetector
from repro_torch.core.policy import PolicyConfig
from repro_torch.core.sweep import SweepConfig
from repro_torch.core.triage import Stage, TriageConfig
from repro_torch.device import DeviceLike


def _fields_of(cls, obj, **override) -> dict:
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
          if hasattr(obj, f.name)}
    kw.update(override)
    return kw


def detector_config(cfg, device: DeviceLike = "cuda") -> DetectorConfig:
    return DetectorConfig(**_fields_of(DetectorConfig, cfg,
                                       device=str(device)))


def policy_config(cfg) -> PolicyConfig:
    return PolicyConfig(**_fields_of(PolicyConfig, cfg))


def sweep_config(cfg) -> SweepConfig:
    return SweepConfig(**_fields_of(SweepConfig, cfg))


def triage_config(cfg) -> TriageConfig:
    kw = _fields_of(TriageConfig, cfg)
    for lane in ("gpu_stages", "nic_stages", "host_stages"):
        if lane in kw:
            kw[lane] = tuple(Stage(s.name, s.duration_s, s.human_s)
                             for s in kw[lane])
    return TriageConfig(**kw)


def detector_state_to_numpy(detector) -> Dict[str, object]:
    """Ring buffers, ids, ring position and latch state as numpy arrays.

    Works on a port detector and, by duck typing, on the JAX package's
    detector (whose ring keeps one numpy buffer per metric)."""
    h = detector.history
    if h._ids is None:
        raise ValueError("detector has seen no frame yet")
    if hasattr(h, "_bufs"):                  # the JAX package's ring
        bufs = {m: np.array(b, copy=True) for m, b in h._bufs.items()}
        valid = np.array(h._valid, copy=True)
        latched, clean = detector._latched, detector._clean
    else:
        buf = h._buf.cpu().numpy()
        bufs = {m: buf[:, j].copy() for j, m in enumerate(h._names)}
        valid = h._valid.cpu().numpy()
        latched = None if detector._latched is None \
            else detector._latched.cpu().numpy()
        clean = None if detector._clean is None \
            else detector._clean.cpu().numpy()
    has_state = detector._state_ids is not None
    return {
        "bufs": bufs,
        "valid": valid,
        "ids": np.array(h._ids, copy=True),
        "head": int(h._head),
        "used": int(h._used),
        "state_ids": np.array(detector._state_ids, copy=True)
        if has_state else None,
        "latched": np.array(latched, bool) if has_state else None,
        "clean": np.array(clean, np.int64) if has_state else None,
        "off": {int(k): (bool(v[0]), int(v[1]))
                for k, v in detector._off.items()},
    }


def load_detector_state(detector: StragglerDetector,
                        state: Dict[str, object]) -> None:
    """Resume ``detector`` from ``state`` (see ``detector_state_to_numpy``).

    The score caches are not carried: every ring row is scored again at
    the next window, which gives the same verdicts, since a row's scores
    depend on that row alone."""
    h = detector.history
    bufs = state["bufs"]
    names = tuple(bufs)
    depth = np.shape(state["valid"])[0]
    if depth != h.depth:
        raise ValueError(f"state has ring depth {depth}, detector "
                         f"{h.depth}")
    dev = detector.device
    stacked = np.stack([np.asarray(bufs[m], np.float32) for m in names],
                       axis=1)                           # (depth, M, N)
    h._names = names
    h._buf = torch.from_numpy(stacked).to(dev)
    h._valid = torch.from_numpy(np.array(state["valid"], bool)).to(dev)
    h._ids = np.array(state["ids"], copy=True)
    h._head = int(state["head"])
    h._used = int(state["used"])
    h._last = None
    h.last_backfill = None
    h.generation += 1                # forces a full rescore next window
    if state["state_ids"] is None:
        detector._state_ids = detector._latched = detector._clean = None
    else:
        detector._state_ids = np.array(state["state_ids"], copy=True)
        detector._latched = torch.from_numpy(
            np.array(state["latched"], bool)).to(dev)
        detector._clean = torch.from_numpy(
            np.array(state["clean"], np.int64)).to(dev)
    detector._latched_host = None
    detector._off = {int(k): (bool(v[0]), int(v[1]))
                     for k, v in state["off"].items()}


__all__ = ["detector_config", "detector_state_to_numpy",
           "load_detector_state", "policy_config", "sweep_config",
           "triage_config"]
