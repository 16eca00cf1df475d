"""Checkpoint managers: atomic, asynchronous, retention-managed, and tiered;
the port of ``repro.train.checkpoint``.

``CheckpointManager`` (the durable/COLD tier) saves the flattened
(params, opt_state, step) state as an ``.npz`` plus a JSON manifest.
Writes go to a unique temp path and are renamed atomically, so a crash
mid-save can never corrupt the restore point. Saves can run on a
background thread (overlapping the next training steps); ``wait()`` joins
before exit and surfaces any writer failure instead of swallowing it, and
``restore`` skips torn or incomplete directories: an in-flight snapshot
racing a crash either lands fully or is discarded.

``TieredCheckpointManager`` adds the two fast tiers of the recovery
architecture (see ``repro_torch.guard.goodput``):

  PEER    the full flattened state mirrored in a DP peer's host memory
          (``replica_partner`` over the data-parallel width; in this
          single-process setting the replica is held in RAM). A hot spare
          promoted into the job restores from here.
  LOCAL   a node-local fast shard (``local/`` subdir, synchronous atomic
          writes) that survives evictions but dies with the node.

State is nested dicts whose leaves are tensors (on any device) or numpy
arrays; every leaf is copied to host numpy before a writer thread starts,
so later in-place updates of the live state cannot reach a snapshot.
Leaves are stored under their dict path joined by "/" (``p/<parameter
name>``, ``o/mu/<parameter name>``, ``o/count``). The port's parameter
names (``layers.0.attn.wq``) are not the JAX package's tree paths
(``layers/attn/wq``, stacked over layers), so neither package reads the
other's checkpoints. A restore rebuilds the structure of the templates it
is given: tensors on the template's device and dtype, numpy arrays for
numpy templates. The data-parallel width is 1 unless given: the port has
no device mesh yet.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.guard.goodput import (CheckpointTier, RecoveryModel,
                                       replica_partner, young_daly_interval)


def _host(leaf) -> np.ndarray:
    """A private host copy of one leaf."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, f"{name}/"))
        else:
            flat[name] = _host(val)
    return flat


def _rebuild(data: Mapping[str, np.ndarray], prefix: str, like: Mapping):
    """Unflatten ``data[prefix + <dict path>]`` into the structure of
    ``like``; each leaf takes its template's kind, device and dtype."""
    out = {}
    for key, leaf in like.items():
        name = f"{prefix}{key}"
        if isinstance(leaf, Mapping):
            out[key] = _rebuild(data, f"{name}/", leaf)
            continue
        arr = data[name]
        if arr.shape != tuple(np.shape(leaf)):
            raise ValueError(f"checkpoint leaf {name} has shape {arr.shape}, "
                             f"the template {tuple(np.shape(leaf))}")
        if isinstance(leaf, torch.Tensor):
            out[key] = torch.from_numpy(np.array(arr, copy=True)).to(
                device=leaf.device, dtype=leaf.dtype)
        else:
            out[key] = arr
    return out


def _snapshot(params, opt_state) -> Dict[str, np.ndarray]:
    flat = {f"p/{k}": v for k, v in _flatten(params).items()}
    flat.update({f"o/{k}": v for k, v in _flatten(opt_state).items()})
    return flat


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_ctx: Optional[Tuple[int, int]] = None   # (step, seq)
        self._seq = 0           # unique tmp suffix: re-saves never collide
        os.makedirs(directory, exist_ok=True)
        self._clean_debris()

    def _clean_debris(self) -> None:
        """Remove leftovers of writes that died mid-flight (tmp dirs and
        displaced old versions) so they can never shadow a valid
        checkpoint or block a future rename."""
        for name in os.listdir(self.dir):
            if name.startswith(".tmp-") or name.startswith(".old-"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, params, opt_state,
             extra: Optional[Dict[str, Any]] = None) -> None:
        flat = _snapshot(params, opt_state)       # host copies, now
        manifest = {"step": int(step), "time": time.time(),
                    "extra": extra or {}}
        self.wait()
        self._seq += 1
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_safe, args=(step, self._seq, flat,
                                               manifest), daemon=True)
            self._thread.start()
        else:
            self._write(step, self._seq, flat, manifest)

    def _write_safe(self, step: int, seq: int, flat, manifest) -> None:
        try:
            self._write(step, seq, flat, manifest)
        except Exception as e:          # surfaced by the next wait()
            self._error = e
            self._error_ctx = (int(step), int(seq))

    def _write(self, step: int, seq: int, flat, manifest) -> None:
        tmp = os.path.join(self.dir, f".tmp-{step}-{seq}")
        final = os.path.join(self.dir, f"ckpt-{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # atomic publish. rename() can't replace a non-empty directory, so
        # a re-save of the same step (rewind after restore) first swings
        # the stale version aside: readers only ever see a complete dir.
        if os.path.isdir(final):
            old = os.path.join(self.dir, f".old-{step}-{seq}")
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"ckpt-{s:08d}"))

    def wait(self, raise_errors: bool = True) -> None:
        """Join the in-flight async save. A writer failure is re-raised
        here (the save call site) unless ``raise_errors=False``: restore
        paths pass False and fall back to the last *complete* checkpoint
        instead of dying on a snapshot that raced the crash."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            ctx, self._error_ctx = self._error_ctx, None
            if raise_errors:
                where = f" (step {ctx[0]}, seq {ctx[1]})" if ctx else ""
                raise RuntimeError(
                    f"async checkpoint write failed{where}") from err

    # ---------------------------------------------------------- restore

    def _is_complete(self, step: int) -> bool:
        path = os.path.join(self.dir, f"ckpt-{step:08d}")
        return (os.path.isfile(os.path.join(path, "arrays.npz"))
                and os.path.isfile(os.path.join(path, "manifest.json")))

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("ckpt-"):
                out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """Newest checkpoint that is fully on disk (torn dirs skipped)."""
        for s in reversed(self.all_steps()):
            if self._is_complete(s):
                return s
        return None

    def restore(self, params_like, opt_like, step: Optional[int] = None
                ) -> Optional[Tuple[Any, Any, int]]:
        """Restore into the structure of (params_like, opt_like)."""
        self.wait(raise_errors=False)
        step = step if step is not None else self.latest_step()
        if step is None or not self._is_complete(step):
            return None
        path = os.path.join(self.dir, f"ckpt-{step:08d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            data = {k: z[k] for k in z.files}
        return _rebuild(data, "p/", params_like), \
            _rebuild(data, "o/", opt_like), step


class TieredCheckpointManager(CheckpointManager):
    """Durable tier + node-local fast shards + in-memory DP peer replica.

    ``on_step`` is the fast-tier driver: call it every step with the live
    state; it snapshots when the MTTF-tuned cadence says one is due.
    ``restore_any`` is the recovery entry point: it serves from the
    fastest tier that has a complete snapshot (PEER → LOCAL → COLD) and
    reports which one, so callers can charge the right MTTR.
    """

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True, *,
                 node_id: int = 0,
                 dp_size: Optional[int] = None,
                 recovery: Optional[RecoveryModel] = None,
                 fast_interval_s: Optional[float] = None,
                 keep_local: int = 2):
        super().__init__(directory, keep=keep, async_save=async_save)
        self.recovery = recovery or RecoveryModel()
        self.node_id = int(node_id)
        self.dp_size = max(int(dp_size or 1), 1)
        self.peer_rank = replica_partner(self.node_id % self.dp_size,
                                         self.dp_size)
        self.keep_local = keep_local
        self.local_dir = os.path.join(directory, "local")
        os.makedirs(self.local_dir, exist_ok=True)
        self._fixed_interval = fast_interval_s
        self._interval_s = (fast_interval_s
                            if fast_interval_s is not None
                            else self.recovery.max_interval_s)
        self._last_snap_t: Optional[float] = None
        self._peer: Optional[Dict[str, Any]] = None   # in-memory replica
        self.snapshots_taken = 0

    # -------------------------------------------------------- cadence

    @property
    def fast_interval_s(self) -> float:
        """Current fast-snapshot interval (seconds of wall time)."""
        return self._interval_s

    def update_mttf(self, mttf_s: float) -> float:
        """Re-tune the fast-tier cadence to the live MTTF estimate
        (Young-Daly optimum, clamped). No-op when the interval was pinned
        explicitly at construction. Returns the interval now in force."""
        if self._fixed_interval is None:
            self._interval_s = young_daly_interval(
                mttf_s, self.recovery.snapshot_cost_s,
                self.recovery.min_interval_s, self.recovery.max_interval_s)
        return self._interval_s

    # ------------------------------------------------------ fast tiers

    def on_step(self, step: int, params, opt_state,
                now: Optional[float] = None) -> bool:
        """Per-step driver: take a fast snapshot when one is due.
        Returns True when a snapshot was taken this call."""
        t = time.monotonic() if now is None else float(now)
        if self._last_snap_t is not None and \
                t - self._last_snap_t < self._interval_s:
            return False
        self.save_fast(step, params, opt_state)
        self._last_snap_t = t
        return True

    def save_fast(self, step: int, params, opt_state) -> None:
        """Snapshot into both fast tiers: the in-memory peer replica and
        the node-local shard. Same flat layout as the durable tier, so a
        restore from any tier is bit-identical."""
        flat = _snapshot(params, opt_state)       # private host copies
        # PEER: the replica handed to the DP partner
        self._peer = {"step": int(step), "holder": self.peer_rank,
                      "flat": flat}
        # LOCAL: synchronous atomic write of the node-local shard
        tmp = os.path.join(self.local_dir, f".tmp-fast-{step}")
        final = os.path.join(self.local_dir, f"fast-{step:08d}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
        self.snapshots_taken += 1
        self._gc_local()

    def _gc_local(self) -> None:
        for s in self.local_steps()[:-self.keep_local]:
            os.unlink(os.path.join(self.local_dir, f"fast-{s:08d}.npz"))

    def local_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.local_dir):
            if name.startswith("fast-") and name.endswith(".npz"):
                out.append(int(name[5:-4]))
        return sorted(out)

    def peer_step(self) -> Optional[int]:
        return self._peer["step"] if self._peer is not None else None

    def drop_peer(self) -> None:
        """The replica holder left the job (its memory is gone), e.g. a
        fail-stop that took out the partner. PEER tier degrades away."""
        self._peer = None

    def drop_local(self) -> None:
        """The node died; its local shards died with it."""
        for s in self.local_steps():
            os.unlink(os.path.join(self.local_dir, f"fast-{s:08d}.npz"))

    # ---------------------------------------------------------- restore

    def restore_any(self, params_like, opt_like,
                    step: Optional[int] = None
                    ) -> Optional[Tuple[Any, Any, int, CheckpointTier]]:
        """Restore from the fastest available tier; returns the tier the
        state came from alongside (params, opt_state, step). Pass
        ``step`` to demand an exact snapshot step (tiers that can't serve
        it are skipped)."""
        if self._peer is not None and \
                (step is None or self._peer["step"] == step):
            data = self._peer["flat"]
            return (_rebuild(data, "p/", params_like),
                    _rebuild(data, "o/", opt_like),
                    self._peer["step"], CheckpointTier.PEER)
        local = self.local_steps()
        pick = None
        if local:
            pick = local[-1] if step is None else \
                (step if step in local else None)
        if pick is not None:
            path = os.path.join(self.local_dir, f"fast-{pick:08d}.npz")
            with np.load(path) as z:
                data = {k: z[k] for k in z.files}
            return (_rebuild(data, "p/", params_like),
                    _rebuild(data, "o/", opt_like),
                    pick, CheckpointTier.LOCAL)
        out = self.restore(params_like, opt_like, step=step)
        if out is None:
            return None
        return out[0], out[1], out[2], CheckpointTier.COLD


__all__ = ["CheckpointManager", "TieredCheckpointManager"]
