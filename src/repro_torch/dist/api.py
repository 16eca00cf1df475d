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

Tensor parallelism over "model" (the reference's GSPMD partitioning of
the same logical axes) is explicit here: a model built under a mesh
whose "model" axis is wider than 1 keeps each rank's slice of its
heads, ff, vocab and expert weights (``repro_torch.models.model``), the
activations between layers stay replicated over "model", and every
collective of the forward and backward goes through the helpers below,
on the "model" sub-group (``tp_group``). Each is an autograd function
with its own backward:

  copy_in(x)          identity           | all-reduce (sum)
  reduce_out(x)       all-reduce (sum)   | identity
  gather_dim(x, d)    all-gather along d | this rank's slice
  split_dim(x, d)     this rank's slice  | all-gather along d
  all_to_all(x, s, c) all_to_all         | the inverse all_to_all
  max_all_reduce(x)   all-reduce (max)   | none (the reference's
                                           ``stop_gradient``)

They replace the reference's two ``shard_map`` users as well: moe's
expert-parallel ``all_to_all`` dispatch and attention's flash-decode
(partial attention over a sequence-sharded KV cache, combined by a max
and two sums). On a gloo group a CUDA tensor moves through one host copy
each way (gloo takes CUDA tensors for few collectives); the group's
backend decides that, and NCCL groups stay on the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

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

# the mesh axis of tensor (and expert) parallelism
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
        ``Replicate()``."""
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


def param_sharding(axes: Mapping[str, Axes], params: Mapping[str, Any],
                   ctx: Optional[DistContext] = None) -> Dict[str, list]:
    """``{name: logical axes}`` + ``{name: tensor or shape}`` -> ``{name:
    DTensor placements}``, each resolved with the (global) shape."""
    ctx = ctx if ctx is not None else current()
    if ctx is None:
        raise RuntimeError("param_sharding requires an active mesh context")
    return {name: ctx.sharding(axes[name], tuple(getattr(p, "shape", p)))
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


def local_block(t: torch.Tensor, mesh, placements,
                skip: Mapping[str, int] = {}) -> torch.Tensor:
    """This rank's block of ``t`` under ``placements`` (a view): ``t``
    narrowed by the rank's mesh coordinate on every ``Shard``, several
    mesh dims on one tensor dim nested left to right. ``skip`` maps mesh
    dims whose split ``t`` already is, by name, to that tensor dim."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if not isinstance(pl, Shard) or skip.get(names[i]) == pl.dim:
            continue
        size = t.shape[pl.dim] // mesh.size(i)
        t = t.narrow(pl.dim, coord[i] * size, size)
    return t


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


# ------------------------------------------------- tensor parallelism

# torch 2.13 renames these two (the old names then warn)
all_gather_single = getattr(tdist, "all_gather_single", None) \
    or tdist.all_gather_into_tensor
reduce_scatter_single = getattr(tdist, "reduce_scatter_single", None) \
    or tdist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The "model" sub-group of a rank: its process group, the rank's
    coordinate on "model", the axis's width, and whether CUDA tensors go
    through a host copy (a gloo group)."""
    group: Any
    rank: int
    size: int
    host: bool


def tp_group(ctx: Optional[DistContext] = None) -> Optional[TPGroup]:
    """The "model" sub-group of ``ctx`` (default: the active context), or
    None where the axis is absent or 1 wide."""
    ctx = ctx if ctx is not None else current()
    if ctx is None or ctx.sizes.get(TP_AXIS, 1) == 1:
        return None
    group = ctx.mesh.get_group(TP_AXIS)
    return TPGroup(group, ctx.mesh.get_local_rank(TP_AXIS),
                   ctx.sizes[TP_AXIS], tdist.get_backend(group) == "gloo")


def all_reduce(t: torch.Tensor, group=None, op=tdist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``tdist.all_reduce`` of ``t`` in place over ``group`` (default: the
    world), through a host copy for a CUDA tensor on a gloo group."""
    if t.is_cuda and tdist.get_backend(group) == "gloo":
        buf = t.detach().cpu()
        tdist.all_reduce(buf, op=op, group=group)
        t.copy_(buf)
    else:
        tdist.all_reduce(t, op=op, group=group)
    return t


def gather_batch(t: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """The ``t`` of every rank that shares this rank's "model" coordinate,
    stacked in the batch's row-major order over "pod" and "data" (the
    ``act_batch`` axes): (batch ranks, *t.shape). One all-gather a batch
    axis wider than 1, on that axis's group; no gradient."""
    out = t.detach()[None]
    for axis in reversed(ctx.mesh_axes("act_batch")):
        n = ctx.sizes[axis]
        if n == 1:
            continue
        buf = out.new_empty((n * out.numel(),))
        all_gather_single(buf, out.contiguous().view(-1),
                          group=ctx.mesh.get_group(axis))
        out = buf.view((n * out.shape[0],) + tuple(out.shape[1:]))
    return out


def _send(t: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """A private contiguous copy of ``t`` to communicate: on the host for a
    CUDA tensor on a gloo group."""
    if tp.host and t.is_cuda:
        return t.detach().to("cpu", copy=True).contiguous()
    return t.detach().clone(memory_format=torch.contiguous_format)


def _all_reduce(t: torch.Tensor, tp: TPGroup, op=tdist.ReduceOp.SUM
                ) -> torch.Tensor:
    return all_reduce(t.detach().clone(), tp.group, op)


def _all_gather(t: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    src = _send(t, tp)
    out = src.new_empty(tp.size * src.numel())
    all_gather_single(out, src.view(-1), group=tp.group)
    out = out.view((tp.size,) + tuple(src.shape))
    return torch.cat(out.unbind(0), dim=dim).to(t.device)


def _slice(t: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    n = t.shape[dim] // tp.size
    return t.narrow(dim, tp.rank * n, n).contiguous()


def _all_to_all(t: torch.Tensor, split: int, concat: int, tp: TPGroup
                ) -> torch.Tensor:
    send = _send(torch.stack(t.chunk(tp.size, dim=split)), tp)
    recv = torch.empty_like(send)
    tdist.all_to_all_single(recv, send, group=tp.group)
    return torch.cat(recv.unbind(0), dim=concat).to(t.device)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _all_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.tp), None, None


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _slice(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.tp), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, tp):
        ctx.split, ctx.concat, ctx.tp = split, concat, tp
        return _all_to_all(x, split, concat, tp)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.concat, ctx.split, ctx.tp), None, None, \
            None


def copy_in(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """``x`` as it is; its gradient summed over "model". Where a tensor
    replicated over "model" enters work that each rank does only part of
    (its heads, its ff slice), each rank's gradient is partial."""
    return _CopyIn.apply(x, tp)


def reduce_out(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The sum of the ranks' ``x`` (partial results, e.g. of a row-parallel
    product); the gradient passes as it is."""
    return _ReduceOut.apply(x, tp)


def gather_dim(x: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    gradient's slice of this rank goes back."""
    return _GatherDim.apply(x, dim, tp)


def split_dim(x: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    """This rank's slice of ``x`` (replicated) along ``dim``; the ranks'
    gradients are gathered back into the whole."""
    return _SplitDim.apply(x, dim, tp)


def all_to_all(x: torch.Tensor, split: int, concat: int, tp: TPGroup
               ) -> torch.Tensor:
    """The reference's tiled ``lax.all_to_all``: ``x`` split into
    ``tp.size`` chunks along ``split``, chunk j sent to rank j, and the
    chunks received concatenated along ``concat`` in rank order."""
    return _AllToAll.apply(x, split, concat, tp)


def max_all_reduce(x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """The elementwise max over the ranks, without a gradient."""
    return _all_reduce(x, tp, op=tdist.ReduceOp.MAX)


__all__ = ["DEFAULT_RULES", "DistContext", "TPGroup", "TP_AXIS",
           "all_gather_single", "all_reduce", "all_to_all", "constraint", "copy_in",
           "current", "distribute", "gather_batch", "gather_dim",
           "gather_fsdp",
           "local_block", "max_all_reduce", "param_sharding", "rank0_value",
           "reduce_out", "reduce_scatter_single", "set_context", "split_dim",
           "tp_group", "use_mesh"]
