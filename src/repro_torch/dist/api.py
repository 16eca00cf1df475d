"""Logical-axis sharding layer over a ``torch.distributed`` DeviceMesh: the
port of ``repro.dist.api``.

Model code never mentions mesh axes. Parameters and activations carry
*logical* axis names ("fsdp", "heads", "act_batch", ...) and this module
resolves them against the active mesh through a rule table:

    logical name  ->  tuple of mesh axes (resolved left to right)

Resolution for one tensor dimension (``DistContext.spec``) is the
reference's, exactly:

  1. ``None`` (or a name with no rule / no mapped axis present in the
     mesh) -> the dim is replicated.
  2. Duplicate suppression: a dim whose mapped mesh axes intersect the
     axes already used by an earlier dim of the same spec replicates.
  3. Divisibility fallback: when the dim size is known and does not
     divide the mapped mesh-axis product, the dim replicates.

``spec`` returns a per-dim tuple in the reference's ``PartitionSpec``
form (``None``, a mesh-axis name, or a tuple of names) and reads only the
mesh's axis names and sizes, so it needs no process group;
``sharding`` turns it into DTensor placements, one per mesh dim.

The port runs one process per rank (the reference is one process over a
mesh), so a plain tensor inside a context is the rank's local shard:
``constraint`` redistributes a DTensor and returns a plain tensor as it
is. Training keeps the ZeRO-3 split of the reference: the float32 master
weights and AdamW moments are DTensors placed by ``param_sharding``, and
the compute copy of each unit is gathered just in time (``gather_fsdp``
drops the "fsdp" entry; ``repro_torch.train.trainer`` drives it).

Not ported yet: tensor parallelism over "model" (a mesh whose "model"
axis is wider than 1 raises ``NotImplementedError`` wherever placements
are made) and ``shard_map`` (moe's expert-parallel dispatch and
attention's flash-decode come with their families).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as tdist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

Axes = Tuple[Optional[str], ...]
Rules = Dict[str, Tuple[str, ...]]
SpecEntry = Union[None, str, Tuple[str, ...]]

# Logical axis -> mesh axes. Mesh axes missing from the active mesh are
# skipped at resolution time, so one table covers the single-pod
# ("data", "model") and multi-pod ("pod", "data", "model") meshes.
DEFAULT_RULES: Rules = {
    # -- parameter axes -------------------------------------------------
    "fsdp": ("data",),          # ZeRO-3 weight/moment sharding
    "tp": ("model",),           # generic tensor-parallel dim
    "heads": ("model",),        # attention Q heads (TP)
    "kv_heads": ("model",),     # attention KV heads (TP)
    "ff": ("model",),           # MLP hidden dim (TP)
    "vocab": ("model",),        # embedding / logits vocab dim (TP)
    "expert": ("model",),       # MoE expert dim (EP)
    "layer": (),                # scan-stacked layer dim: never sharded
    # -- activation axes ------------------------------------------------
    "act_batch": ("pod", "data"),   # batch: pure DP across pods + data
    "act_seq": (),                  # sequence: replicated by default
    "act_seq_ckpt": ("model",),     # context-parallel fallback chunks
    "act_embed": (),                # d_model: replicated (norms are local)
    "act_vocab": ("model",),        # logits vocab dim
    "act_heads": ("model",),        # Q-head activations
    "act_kv_heads": ("model",),     # KV-head activations
    "act_kv_seq": ("model",),       # decode KV-cache sequence (flash-decode)
    "act_ff": ("model",),           # MLP hidden activations
    "act_expert": ("model",),       # MoE expert-parallel axis
    # -- fleet-monitoring axes -------------------------------------------
    "fleet_node": ("data",),        # detector node axis: peer-median rank
                                    # counts psum across node shards
}

# the mesh axis tensor parallelism would use; only a 1-wide one is ported
TP_AXIS = "model"


def _axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names``,
    ``shape``) or of any object with the reference mesh's ``axis_names``
    and a ``shape`` mapping names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


class DistContext:
    """A mesh plus the rule table resolving logical axes onto it."""

    def __init__(self, mesh, rules: Optional[Rules] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES) if rules is None else dict(rules)
        self.sizes = _axis_sizes(mesh)

    # ------------------------------------------------------- resolution

    def mesh_axes(self, name: Optional[str]) -> Tuple[str, ...]:
        """Mesh axes a logical name maps to, restricted to this mesh.

        Unknown names (and ``None``) resolve to () — replicated."""
        if name is None:
            return ()
        return tuple(a for a in self.rules.get(name, ()) if a in self.sizes)

    def axis_size(self, name: Optional[str]) -> int:
        """Total shard count of a logical axis on this mesh (1 = unmapped)."""
        return math.prod(self.sizes[a] for a in self.mesh_axes(name))

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Tuple[SpecEntry, ...]:
        """Resolve per-dim logical names to a per-dim tuple, the
        reference's ``PartitionSpec`` entries.

        ``shape`` (when given) enables the divisibility fallback; it must
        have the same rank as ``logical_axes``."""
        logical_axes = tuple(logical_axes)
        if shape is not None and len(shape) != len(logical_axes):
            raise ValueError(
                f"rank mismatch: axes {logical_axes} vs shape {tuple(shape)}")
        used: set = set()
        entries = []
        for i, name in enumerate(logical_axes):
            axes = self.mesh_axes(name)
            if not axes or used & set(axes):
                entries.append(None)
                continue
            size = math.prod(self.sizes[a] for a in axes)
            if shape is not None and shape[i] % size != 0:
                entries.append(None)        # doesn't divide: replicate
                continue
            used.update(axes)
            entries.append(axes[0] if len(axes) == 1 else axes)
        return tuple(entries)

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> list:
        """DTensor placements of ``spec(logical_axes, shape)``, one per
        mesh dim in the mesh's order: ``Shard(i)`` on each mesh axis that
        tensor dim ``i`` is split over (several axes on one dim nest left
        to right, as the reference's tuple entries do), else
        ``Replicate()``. Raises ``NotImplementedError`` on a mesh whose
        "model" axis is wider than 1: tensor parallelism is not ported."""
        if self.sizes.get(TP_AXIS, 1) > 1:
            raise NotImplementedError(
                f"tensor parallelism over {TP_AXIS!r} (width "
                f"{self.sizes[TP_AXIS]}) is not ported: the port shards "
                f"over 'pod' and 'data' only")
        dim_of: Dict[str, int] = {}
        for i, entry in enumerate(self.spec(logical_axes, shape)):
            for axis in (entry,) if isinstance(entry, str) else entry or ():
                dim_of[axis] = i
        return [Shard(dim_of[a]) if a in dim_of else Replicate()
                for a in self.sizes]


# ----------------------------------------------------------------- context

_context: Optional[DistContext] = None


def set_context(ctx: Optional[DistContext]) -> None:
    global _context
    _context = ctx


def current() -> Optional[DistContext]:
    return _context


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Rules] = None):
    """Install a DistContext for the dynamic extent of the block.

    The prior context is restored on exit — including on exception — so
    nested meshes and failing tests can't leak sharding state."""
    prev = current()
    ctx = DistContext(mesh, rules)
    set_context(ctx)
    try:
        yield ctx
    finally:
        set_context(prev)


def constraint(x, *logical_axes: Optional[str]):
    """Place ``x`` as its logical axes resolve on the active mesh.

    Without a context it returns ``x`` itself. A DTensor is redistributed
    to the resolved placements. A plain tensor inside a context is this
    rank's local shard (one process per rank) and is returned as it is."""
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, ctx.sharding(logical_axes, x.shape))


# ------------------------------------------------------------ param trees


def param_sharding(axes: Mapping[str, Axes],
                   params: Mapping[str, torch.Tensor],
                   ctx: Optional[DistContext] = None) -> Dict[str, list]:
    """``{name: logical axes}`` + ``{name: tensor}`` -> ``{name: DTensor
    placements}``, each resolved with the tensor's (global) shape."""
    ctx = ctx if ctx is not None else current()
    if ctx is None:
        raise RuntimeError("param_sharding requires an active mesh context")
    return {name: ctx.sharding(axes[name], tuple(p.shape))
            for name, p in params.items()}


def gather_fsdp(tree: Mapping[str, torch.Tensor],
                axes: Mapping[str, Axes]):
    """ZeRO-3 just-in-time gather: each DTensor leaf redistributed with
    "fsdp" dropped from its axes (an all-gather over "data"); other
    logical axes keep their placement. No-op (``tree`` itself) without a
    context; a plain leaf is returned as it is."""
    ctx = current()
    if ctx is None:
        return tree
    def gathered(x, ax):
        return x.redistribute(x.device_mesh, ctx.sharding(
            tuple(None if a == "fsdp" else a for a in ax), x.shape))
    return {name: gathered(x, axes[name]) if isinstance(x, DTensor) else x
            for name, x in tree.items()}


# ------------------------------------------------- one process per rank


def distribute(full: torch.Tensor, mesh, placements) -> DTensor:
    """``full``, the same tensor on every rank, as a DTensor of
    ``placements`` on ``mesh``: each rank keeps a private copy of its own
    shard; no collective runs."""
    d = distribute_tensor(full, mesh, placements, src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), mesh, d.placements,
                              shape=d.shape, stride=d.stride())


def rank0_value(value):
    """``value`` as rank 0 of the process group holds it. The reference is
    one process over a mesh; the port runs one process per rank, so a host
    decision that steers collectives (a restart, the checkpoint step to
    restore) must be the same on every rank: rank 0's. ``value`` itself
    when no process group is initialised."""
    if not tdist.is_initialized():
        return value
    box = [value]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


__all__ = ["DEFAULT_RULES", "DistContext", "TP_AXIS", "constraint",
           "current", "distribute", "gather_fsdp", "param_sharding",
           "rank0_value", "set_context", "use_mesh"]
