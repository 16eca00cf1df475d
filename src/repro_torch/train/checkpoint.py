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
numpy templates.

Sharded state (the DTensor master weights and moments of a step under a
mesh, one process per rank) goes to the durable tier as the same files as
unsharded state: every rank sends its shards of each leaf to rank 0 (one
gather a leaf), and rank 0 alone holds the leaf in full and writes it. A
restore into DTensor templates reads the full leaves on every rank and
keeps each rank's shards, so a job saved under a mesh restores without
one and the other way round. The fast tiers hold each rank's own shards
and nothing more: the PEER replica in its memory and the LOCAL file in
its own directory (``local/rank<r>/``), written with no collective, and
they restore only into the same placements. Whether a fast snapshot is
due and the step of a COLD restore are rank 0's (the latter read after
its ``wait()``, so a save still on its writer thread is published before
any rank reads it); the fast tier to restore from is the fastest one that
holds the same snapshot on every rank.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist import api as dist
from repro_torch.guard.goodput import (CheckpointTier, RecoveryModel,
                                       replica_partner, young_daly_interval)


def _host(leaf) -> np.ndarray:
    """A private host copy of one plain leaf."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _sharded(tree: Mapping) -> bool:
    """Whether ``tree`` holds DTensors: state of a step under a mesh."""
    return any(_sharded(v) if isinstance(v, Mapping)
               else isinstance(v, DTensor) for v in tree.values())


def _to_rank0(x: DTensor) -> Optional[np.ndarray]:
    """Rank 0's host copy of ``x`` in full, None on the other ranks. Each
    rank sends its local shard to rank 0 (one gather), which places the
    shards by the ranks' mesh coordinates; a split that is not even (which
    ``param_sharding`` never makes) is gathered by ``full_tensor()``."""
    mesh = x.device_mesh
    rank = tdist.get_rank()
    splits: Dict[int, List[int]] = {}     # tensor dim -> mesh dims, in order
    even = mesh.size() == tdist.get_world_size()
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard):
            splits.setdefault(pl.dim, []).append(i)
        elif not isinstance(pl, Replicate):
            even = False                  # a pending reduction
    even = even and all(x.shape[d] % math.prod(mesh.size(i) for i in dims)
                        == 0 for d, dims in splits.items())
    if not even:
        full = x.full_tensor()
        return _host(full) if rank == 0 else None
    local = x.to_local().contiguous()
    pieces = [torch.empty_like(local) for _ in range(mesh.size())] \
        if rank == 0 else None
    tdist.gather(local, pieces, dst=0)
    if rank != 0:
        return None
    full = torch.empty(tuple(x.shape), dtype=x.dtype)
    layout = mesh.mesh
    for r, piece in enumerate(pieces):
        coord = (layout == r).nonzero()[0].tolist()
        index = [slice(None)] * x.dim()
        for d, dims in splits.items():
            k, n = 0, 1
            for i in dims:
                k, n = k * mesh.size(i) + coord[i], n * mesh.size(i)
            size = x.shape[d] // n
            index[d] = slice(k * size, (k + 1) * size)
        full[tuple(index)] = piece.cpu()
    return full.numpy()


def _to_rank0_leaf(x) -> Optional[np.ndarray]:
    if isinstance(x, DTensor):
        return _to_rank0(x)
    return _host(x) if tdist.get_rank() == 0 else None


def _flatten(tree: Mapping, leaf_fn, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, leaf_fn, f"{name}/"))
        else:
            flat[name] = leaf_fn(val)
    return flat


def _rebuild(data: Mapping[str, np.ndarray], prefix: str, like: Mapping,
             local: bool = False):
    """Unflatten ``data[prefix + <dict path>]`` into the structure of
    ``like``; each leaf takes its template's kind, device and dtype. With
    ``local`` the data holds each DTensor leaf's local shard (a fast
    tier's), which must have the template's placements."""
    out = {}
    for key, leaf in like.items():
        name = f"{prefix}{key}"
        if isinstance(leaf, Mapping):
            out[key] = _rebuild(data, f"{name}/", leaf, local)
            continue
        arr = data[name]
        want = tuple(leaf.to_local().shape) \
            if local and isinstance(leaf, DTensor) else tuple(np.shape(leaf))
        if arr.shape != want:
            raise ValueError(f"checkpoint leaf {name} has shape {arr.shape}, "
                             f"the template {want}")
        if isinstance(leaf, DTensor) and local:
            out[key] = DTensor.from_local(
                torch.from_numpy(np.array(arr, copy=True)).to(
                    device=leaf.device, dtype=leaf.dtype),
                leaf.device_mesh, leaf.placements, shape=leaf.shape,
                stride=leaf.stride())
        elif isinstance(leaf, DTensor):         # this rank's shards, copied
            out[key] = dist.distribute(
                torch.from_numpy(arr).to(device=leaf.device,
                                         dtype=leaf.dtype),
                leaf.device_mesh, leaf.placements)
        elif isinstance(leaf, torch.Tensor):
            out[key] = torch.from_numpy(np.array(arr, copy=True)).to(
                device=leaf.device, dtype=leaf.dtype)
        else:
            out[key] = arr
    return out


def _snapshot(params, opt_state, leaf_fn=None) -> Optional[Dict[str, Any]]:
    """Host copies of the flattened state. For sharded state (a DTensor
    leaf anywhere), each leaf in full on rank 0 and None on the other
    ranks (every rank must call it: a gather a leaf); with ``leaf_fn``,
    that function of each leaf."""
    if leaf_fn is None:
        leaf_fn = _to_rank0_leaf if _sharded(params) else _host
    flat = {f"p/{k}": v for k, v in _flatten(params, leaf_fn).items()}
    flat.update({f"o/{k}": v
                 for k, v in _flatten(opt_state, leaf_fn).items()})
    return None if any(v is None for v in flat.values()) else flat


def _local_shard(x) -> np.ndarray:
    """A host copy of this rank's shard of ``x`` (of ``x`` if plain)."""
    return _host(x.to_local() if isinstance(x, DTensor) else x)


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
        if flat is None:                          # sharded: rank 0 writes
            return
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
        ok = step is not None and self._is_complete(step)
        if _sharded(params_like):
            # rank 0 alone writes, on its own writer thread: its answer,
            # taken after its wait(), holds for every rank
            step, ok = dist.rank0_value((step, ok))
        if not ok:
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
        if dp_size is None:
            # the reference's name "batch", which no rule maps (the batch
            # rule is "act_batch"): 1 under every mesh, kept so that the
            # peer replica is the reference's
            ctx = dist.current()
            dp_size = ctx.axis_size("batch") if ctx is not None else 1
        self.dp_size = max(int(dp_size), 1)
        self.peer_rank = replica_partner(self.node_id % self.dp_size,
                                         self.dp_size)
        self.keep_local = keep_local
        # node-local: one directory a rank where a process group runs
        self.local_dir = os.path.join(directory, "local")
        if tdist.is_initialized():
            self.local_dir = os.path.join(self.local_dir,
                                          f"rank{tdist.get_rank()}")
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
        due = self._last_snap_t is None or \
            t - self._last_snap_t >= self._interval_s
        if _sharded(params):
            due = dist.rank0_value(due)
        if not due:
            return False
        self.save_fast(step, params, opt_state)
        self._last_snap_t = t
        return True

    def save_fast(self, step: int, params, opt_state) -> None:
        """Snapshot into both fast tiers: the in-memory peer replica and
        the node-local shard. Same flat layout as the durable tier, so a
        restore from any tier is bit-identical. Sharded state: this rank's
        shards of each leaf, with no collective."""
        sharded = _sharded(params)
        flat = _snapshot(params, opt_state,       # private host copies
                         _local_shard if sharded else _host)
        # PEER: the replica handed to the DP partner
        self._peer = {"step": int(step), "holder": self.peer_rank,
                      "flat": flat, "local": sharded}
        self.snapshots_taken += 1
        # LOCAL: synchronous atomic write of the node-local shard
        tmp = os.path.join(self.local_dir, f".tmp-fast-{step}")
        final = os.path.join(self.local_dir, f"fast-{step:08d}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
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
        sharded = _sharded(params_like)
        tier, pick = self._fastest(step, sharded)
        if tier is CheckpointTier.PEER:
            data = self._peer["flat"]
            return (_rebuild(data, "p/", params_like, self._peer["local"]),
                    _rebuild(data, "o/", opt_like, self._peer["local"]),
                    self._peer["step"], CheckpointTier.PEER)
        if tier is CheckpointTier.LOCAL:
            path = os.path.join(self.local_dir, f"fast-{pick:08d}.npz")
            with np.load(path) as z:
                data = {k: z[k] for k in z.files}
            return (_rebuild(data, "p/", params_like, sharded),
                    _rebuild(data, "o/", opt_like, sharded),
                    pick, CheckpointTier.LOCAL)
        out = self.restore(params_like, opt_like, step=step)
        if out is None:
            return None
        return out[0], out[1], out[2], CheckpointTier.COLD

    def _fastest(self, step: Optional[int], sharded: bool = False
                 ) -> Tuple[CheckpointTier, Optional[int]]:
        """The fastest tier holding a snapshot (of ``step``, if given) and
        that snapshot's step; COLD when no fast tier serves. For sharded
        state, a fast tier serves where every rank holds the same step in
        it (each rank holds only its own shards)."""
        peer, local = self.peer_step(), self.local_steps()
        if sharded:
            views: List[Any] = [None] * tdist.get_world_size()
            tdist.all_gather_object(views, (peer, local))
            peers = {v[0] for v in views}
            peer = peers.pop() if len(peers) == 1 else None
            local = sorted(set.intersection(*(set(v[1]) for v in views)))
        if peer is not None and (step is None or peer == step):
            return CheckpointTier.PEER, peer
        if local and (step is None or step in local):
            return CheckpointTier.LOCAL, local[-1] if step is None else step
        return CheckpointTier.COLD, step


__all__ = ["CheckpointManager", "TieredCheckpointManager"]
