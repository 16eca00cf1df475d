"""Working weights sharded over "fsdp" and gathered one unit at a time.

The reference keeps its parameters placed by ``param_sharding`` ("fsdp"
dims split over "data"; under tensor parallelism the heads, ff, vocab and
expert dims over "model") and lets its compiled step gather them:
``Model._gather`` -> ``dist.gather_fsdp`` in training and prefill, and
GSPMD on the sharded params in decode. The port runs one process per
rank and gathers explicitly, a unit of ``Model.zero3_units`` at a time,
as one flat all-gather over "data":

  Shards        what both holders share: each parameter's split dims
                (``split_dims``), the flat layout of each unit
                (``Unit``), the "data" group, and ``gather``'s
                all-gather into the working weights and ``release``.
  ServeShards   serving under the mesh: this rank's shard of every working
                weight, in the compute dtype, one flat buffer a unit (and
                one of the unit's parameters that replicate over "data");
                the working weights hold nothing between units.

The training step's holder (``repro_torch.train.trainer._Zero3``) is a
``Shards`` too: it casts its float32 master shards into the flat buffer
before the same all-gather, and reduce-scatters the gradients.

Attached (``ServeShards`` sets ``model.zero3``), a holder is driven by the
model's serving paths: ``Model.prefill`` and ``Model.decode_step`` (the
hybrid family's decode included) gather "in" at the start and keep it to
the end (the token table, which the tied head reads again, the audio
family's position tables and ``ln_enc``), gather each other unit just
before it runs and release it once its output exists, and gather "out"
for the logits. Decode gathers every unit at every step, as prefill does;
the reference's decode leaves that gather to GSPMD on the sharded params,
which gathers each weight where the step reads it. The holder's
``token_shard`` = (this rank's batch shard, batch shards) tells the moe
family's layers that each batch rank holds its own rows of the call
(``models.moe.apply_moe``): whole experts then route the batch as one,
at the capacity of all its tokens, as the reference's GSPMD prefill does;
under expert parallelism each rank's capacity stays its own. A batch that
every rank holds whole (a ``BatchedServer`` whose slots every rank runs)
takes ``batch_shard=(0, 1)``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import Shard

from repro_torch.dist import api as dist


def split_dims(ctx: dist.DistContext, placements, name: str
               ) -> Tuple[Optional[int], Optional[int]]:
    """The tensor dims a parameter's placement splits over "data" and over
    a "model" axis wider than 1, None where it replicates there. The
    holders shard over those two: a split on another axis wider than 1 is
    not their layout."""
    dims = {"data": None, dist.TP_AXIS: None}
    for axis, pl in zip(ctx.sizes, placements):
        if not isinstance(pl, Shard) or (axis == dist.TP_AXIS
                                         and ctx.sizes[axis] == 1):
            continue
        if axis in dims:
            dims[axis] = pl.dim
        elif ctx.sizes[axis] > 1:
            raise NotImplementedError(
                f"{name} is split over {axis!r}: the sharded weights split "
                f"over 'data' and {dist.TP_AXIS!r} only")
    return dims["data"], dims[dist.TP_AXIS]


def row_shard(ctx: dist.DistContext) -> Tuple[int, int]:
    """(this rank's shard, number of shards) of ``act_batch`` (row-major
    over "pod" and "data")."""
    coord = dict(zip(ctx.sizes, ctx.mesh.get_coordinate()))
    index = 0
    for axis in ctx.mesh_axes("act_batch"):
        index = index * ctx.sizes[axis] + coord[axis]
    return index, ctx.axis_size("act_batch")


def batch_shard(ctx: dist.DistContext, global_batch: int) -> Tuple[int, int]:
    """(this rank's shard, number of shards) of the batch dim, which
    ``act_batch`` splits over "pod" and "data" (row-major), or (0, 1) where
    the batch does not divide them and replicates."""
    if ctx.spec(("act_batch",), (global_batch,))[0] is None:
        return 0, 1
    return row_shard(ctx)


class Unit:
    """The flat layout of one unit (``Model.zero3_units``): for each
    parameter (name -> (dim, local shape, offset)) whose placement splits
    it over "data" on ``dim``, its place in a flat local buffer of
    ``size`` elements; for each replicated one (dim None, its full shape),
    its place in a flat buffer of ``rep_size``. ``shapes`` are the working
    weights' shapes cut to the placement's "model" slice."""

    def __init__(self, names, shapes, dims, n: int):
        self.names = list(names)
        self.slot: Dict[str, Tuple[Optional[int], Tuple[int, ...], int]] = {}
        self.size = self.rep_size = 0
        for name in self.names:
            shape, d = list(shapes[name]), dims[name]
            if d is None:
                self.slot[name] = (None, tuple(shape), self.rep_size)
                self.rep_size += math.prod(shape)
            else:
                shape[d] //= n
                self.slot[name] = (d, tuple(shape), self.size)
                self.size += math.prod(shape)
        self.shard = [(k, *v) for k, v in self.slot.items()
                      if v[0] is not None]
        self.rep = [k for k, v in self.slot.items() if v[0] is None]


class Shards:
    """The placement of ``model``'s working weights under ``ctx`` and the
    gather of a unit (see the module's docstring). A parameter whose
    placement splits it over "model" while every rank computes with all of
    it (``whole``: KV heads that do not divide "model", the sequence
    fallback's heads) is also gathered over "model"."""

    def __init__(self, model, ctx: dist.DistContext):
        model.require_weights()
        self.model = model
        self.ctx = ctx
        self.working = dict(model.named_parameters())
        self.placements = dist.param_sharding(model.param_axes(),
                                              model.global_shapes(), ctx)
        split = {name: split_dims(ctx, pl, name)
                 for name, pl in self.placements.items()}
        dims = {name: d for name, (d, _) in split.items()}
        # parameters split over "model" whose working weight is whole: the
        # dim gathered over "model"
        self.tp = model.tp
        self.whole: Dict[str, int] = {}
        for name, (_, m) in split.items():
            if m is None or model.tp_dims.get(name) == m:
                continue
            if name in model.tp_dims:
                raise ValueError(f"{name}: the model splits dim "
                                 f"{model.tp_dims[name]} over "
                                 f"{dist.TP_AXIS!r}, the placement dim {m}")
            self.whole[name] = m
        shapes = {}
        for name, p in self.working.items():
            shape = list(p.shape)
            if name in self.whole:
                shape[self.whole[name]] //= self.tp.size
            shapes[name] = shape
        self.n = ctx.sizes.get("data", 1)
        self.data_group = ctx.mesh.get_group("data") \
            if "data" in ctx.sizes else None
        self.units = {u: Unit(names, shapes, dims, self.n)
                      for u, names in model.zero3_units().items()}
        self.unit_of = {name: u for u, unit in self.units.items()
                        for name in unit.names}
        # (this rank's batch shard, shards): the model's MoE layers route
        # the ranks' rows as one batch (``models.moe.apply_moe``)
        self.token_shard: Tuple[int, int] = (0, 1)

    def _whole(self, pname: str, t: torch.Tensor) -> torch.Tensor:
        """``t``, the placement's "model" slice of a working weight,
        gathered whole over "model" where every rank computes with all of
        it."""
        if pname not in self.whole:
            return t
        return dist.gather_dim(t, self.whole[pname], self.tp)

    def _block(self, pname: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t``, a working weight's value (the
        model's "model" slice), under the parameter's placement: what
        ``train.shard_params`` keeps of it (a view)."""
        skip = {dist.TP_AXIS: self.model.tp_dims[pname]} \
            if pname in self.model.tp_dims else {}
        return dist.local_block(t, self.ctx.mesh, self.placements[pname],
                                skip)

    @torch.no_grad()
    def _gather_shards(self, unit: Unit, send: torch.Tensor) -> None:
        """The unit's "data"-split working weights from ``send``, this
        rank's flat shard buffer: all-gathered over "data" (one collective;
        over one rank the identity, skipped), each weight a view of the
        result at one data rank and a copy of its rows otherwise."""
        recv = send
        if self.n > 1:
            recv = torch.empty(self.n * unit.size, dtype=send.dtype,
                               device=send.device)
            dist.all_gather_single(recv, send, group=self.data_group)
        rows = recv.view(self.n, unit.size)
        for pname, d, shape, off in unit.shard:
            piece = rows[:, off:off + math.prod(shape)].unflatten(1, shape)
            self.working[pname].data = self._whole(
                pname, piece.movedim(0, d).flatten(d, d + 1))

    def release(self, name: str) -> None:
        for pname in self.units[name].names:
            self._release(self.working[pname])

    @staticmethod
    def _release(p: torch.Tensor) -> None:
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)


class ServeShards(Shards):
    """Serving under a mesh with the working weights sharded over "fsdp"
    (see the module's docstring). Built from ``model``, a model built under
    ``ctx``'s mesh (default: the active context): it keeps, for every
    parameter, this rank's block under ``param_sharding`` (the placement
    ``shard_params`` gives the training step's masters) in the compute
    dtype, on ``device`` (default: the model's), releases the working
    weights and attaches itself (``model.zero3``). Without ``values`` the
    blocks are cut from the working weights, the model's whole "model"
    slice. ``values`` maps each parameter's name to its whole value (the
    reference's layout, a tensor or an array), as ``convert.serve_shards``
    passes the reference's parameters: the model may then be built on the
    meta device, so that its slice is never allocated, and its working
    weights move to ``device`` empty. ``batch_shard`` (default: the rank's
    shard of "act_batch") is ``token_shard``. The reference's dry run holds
    float32 params; these shards are the working weights' dtype."""

    def __init__(self, model, ctx: Optional[dist.DistContext] = None,
                 batch_shard: Optional[Tuple[int, int]] = None,
                 values: Optional[Mapping[str, object]] = None,
                 device: Optional[torch.device] = None):
        ctx = ctx if ctx is not None else dist.current()
        if ctx is None:
            raise RuntimeError("ServeShards needs a mesh context")
        super().__init__(model, ctx)
        self.token_shard = row_shard(ctx) if batch_shard is None \
            else tuple(batch_shard)
        if values is not None and set(values) != set(self.working):
            odd = sorted(set(values) ^ set(self.working))
            raise KeyError(f"values for {odd[:8]} do not match the model's "
                           f"parameters")
        device = model.device if device is None else torch.device(device)
        if values is None and device != model.device:
            raise ValueError(f"a model on {model.device} without values "
                             f"gives no shards on {device}")
        kw = dict(dtype=model.policy.compute_dtype, device=device)
        self.flat: Dict[str, torch.Tensor] = {}
        self.rep: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for name, unit in self.units.items():
                self.flat[name] = torch.empty(unit.size, **kw)
                self.rep[name] = torch.empty(unit.rep_size, **kw)
                for pname in unit.names:
                    value = self.working[pname] if values is None else \
                        torch.as_tensor(model.tp_slice(pname, values[pname]))
                    self._slot(pname).copy_(self._block(pname, value))
        for p in self.working.values():
            if p.device.type != "meta" or device.type == "meta":
                self._release(p)
            else:       # the same object, now an empty tensor on ``device``
                torch.utils.swap_tensors(p, torch.nn.Parameter(
                    torch.empty(0, dtype=p.dtype, device=device),
                    requires_grad=p.requires_grad))
        model.device = device
        self.live = self.peak = 0        # bytes of weights gathered
        model.zero3, model.weights_released = self, True

    def _slot(self, pname: str) -> torch.Tensor:
        """Parameter ``pname``'s block in its unit's buffer (a view)."""
        unit = self.unit_of[pname]
        d, shape, off = self.units[unit].slot[pname]
        buf = self.rep[unit] if d is None else self.flat[unit]
        return buf[off:off + math.prod(shape)].view(shape)

    def nbytes(self) -> int:
        """The bytes this rank holds between units: its shards."""
        return sum(t.numel() * t.element_size()
                   for bufs in (self.flat, self.rep) for t in bufs.values())

    @torch.no_grad()
    def gather(self, name: str) -> None:
        unit = self.units[name]
        for pname in unit.rep:
            self.working[pname].data = self._whole(pname, self._slot(pname))
        if unit.shard:
            self._gather_shards(unit, self.flat[name])
        self.live += sum(self.working[p].numel() *
                         self.working[p].element_size() for p in unit.names)
        self.peak = max(self.peak, self.live)

    def release(self, name: str) -> None:
        self.live -= sum(self.working[p].numel() *
                         self.working[p].element_size()
                         for p in self.units[name].names)
        super().release(name)


__all__ = ["ServeShards", "Shards", "Unit", "batch_shard", "row_shard",
           "split_dims"]
