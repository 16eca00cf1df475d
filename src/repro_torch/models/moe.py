"""Mixture-of-Experts block, the port of ``repro.models.moe`` on its local
path (``ep_axis=None``).

  1. Router: float32 logits on the compute-dtype router weights, softmax,
     top-k, the top-k weights renormalised, and the Switch load-balance aux
     loss ``E * sum_e(frac_top1_e * mean_prob_e)`` over the call's tokens.
  2. Dispatch: the (token, choice) slots sorted by expert (stable), each
     slot's rank within its expert, the slots of rank >= C dropped, the
     kept tokens packed into an (E, C, D) capacity buffer.
  3. Expert FFN: the gated MLP of every expert as two batched products
     (``torch.bmm``) in the compute dtype; ``wi`` holds gate and up fused,
     the gate first.
  4. Combine: each slot reads its expert's row (zero when dropped), weighted
     by its router weight in the compute dtype, summed over the k choices.

Shared experts (always on) run as a dense MLP and are added to the routed
output. The capacity is ``max(ceil(T * k * capacity_factor / E), k)`` with
T the call's tokens, so a decode step routes T = B tokens and may drop
slots, as the reference does.

Ties: ``jax.lax.top_k`` takes the lower index among equal probabilities;
the port sorts the probabilities with ``torch.sort(descending=True,
stable=True)`` and keeps the first k, which does the same (``torch.topk``
gives no such order). The dispatch sort is stable too, so a full expert
drops the same slots as the reference's ``jnp.argsort(stable=True)``.

Under the sharded training step (``repro_torch.train.trainer``) and
when serving with the weights sharded over "fsdp"
(``repro_torch.models.fsdp.ServeShards``), each batch rank holds its
own rows of the call, where the reference routes the whole batch in one
call. ``apply_moe`` then takes ``token_shard`` = (this rank's shard,
shards) and routes as the reference does over the whole batch: one
all-gather of each rank's per-expert slot and top-1 counts over the
batch ranks ("pod" x "data": the ranks that share this rank's "model"
coordinate, and so hold other rows) gives the capacity of all the call's
tokens, each slot's rank within its expert counted over the ranks before
it (the batch's rows in order), and the aux loss's token fractions over
the whole batch. Every rank's call must hold the same number of tokens,
as the even split gives, and the world must be (batch shards x "model").
Each rank's aux is the whole batch's fractions against its own mean
probabilities, so the batch ranks' mean is the reference's aux, and so is
its gradient once the step averages the ranks' gradients. Where "model"
is wider than 1 and does not divide the experts, the experts are whole:
the "model" ranks of a batch rank hold the same rows, route them alike
and compute the same routed output, so nothing sums their shares of x's
gradient (a sliced layer's ``gather_dim`` hands each rank back its own
slice) and nothing is scaled.

Expert parallelism (the reference's ``shard_map`` over "model", where
"model" is wider than 1 and divides E) runs where the model keeps each
rank's E / tp experts (``MoE.tp``, set by the model): routing runs on
the replicated x, so the aux loss is global; each rank dispatches its own
tokens (its data shard's rows, and its S / tp sequence slice where S
divides "model"; all of the call's tokens where not, as at decode) into
an (E, C, D) buffer at the capacity of those tokens, ``all_to_all``
exchanges it for the (E / tp, tp C, D) tokens of its own experts, the
inverse ``all_to_all`` brings the outputs back, and the sequence slices
are gathered. The rows-as-one-batch routing above (``_route_across``) does
not run there: each rank's capacity is its own, as the reference's. In a
sharded step, the aux loss's token fractions are still the whole
batch's (one all-reduce of top-1 counts).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import api as dist
from repro_torch.models.common import Init
from repro_torch.models.layers import MLP

TokenShard = Tuple[int, int]


class MoE(nn.Module):
    """``router`` (D, E), ``wi`` (E, D, 2F), ``wo`` (E, F, D) and, with
    shared experts, ``shared``: an MLP of d_ff = shared experts x F."""

    AXES = {"router": (None, None), "wi": ("expert", "fsdp", None),
            "wo": ("expert", "fsdp", None)}

    def __init__(self, init: Init, cfg):
        super().__init__()
        if cfg.act != "swiglu":
            raise NotImplementedError(
                f"MoE activation {cfg.act!r} is not ported")
        m, d = cfg.moe, cfg.d_model
        f = m.expert_d_ff
        self.router = init.dense(d, m.num_experts)
        self.wi = init.normal((m.num_experts, d, 2 * f), 1.0 / math.sqrt(d))
        self.wo = init.normal((m.num_experts, f, d), 1.0 / math.sqrt(f))
        if m.num_shared_experts:
            self.shared = MLP(init, d, m.num_shared_experts * f, cfg.act)
        # expert parallelism (set by the model): the "model" group over
        # which this rank holds E / tp experts
        self.tp: Optional[dist.TPGroup] = None


def capacity(tokens: int, cfg) -> int:
    """Slots each expert keeps for a call of ``tokens`` tokens."""
    m = cfg.moe
    return max(int(math.ceil(tokens * m.top_k * m.capacity_factor
                             / m.num_experts)), m.top_k)


def _probs(router_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) -> router probabilities (B, S, E) in float32."""
    return torch.softmax(x.float() @ router_w.float(), dim=-1)


def _top_k(probs: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities, the lower index first among equal
    ones, renormalised, and their experts."""
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = srt[..., :top_k], order[..., :top_k]
    return w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9), idx


def route(router_w: torch.Tensor, x: torch.Tensor, num_experts: int,
          top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_route``: x (B, S, D) -> (weights (B, S, k) float32, experts
    (B, S, k) int64, aux scalar float32)."""
    probs = _probs(router_w, x)
    w, idx = _top_k(probs, top_k)
    frac = F.one_hot(idx[..., 0], num_experts).float().mean(dim=(0, 1))
    aux = num_experts * (frac * probs.mean(dim=(0, 1))).sum()
    return w, idx, aux


def plan_slots(idx: torch.Tensor, *, capacity: int, num_experts: int,
               offset: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Where each (token, choice) slot of idx (B, S, k) goes: (order,
    dest, C). ``order`` sorts the flat slots by expert (stable); ``dest[j]``
    is the buffer cell e * C + rank of sorted slot j, or E * C where its
    rank within its expert reaches ``capacity`` (dropped); C is the
    buffer's slots an expert.

    ``offset`` (E,), when given, is each expert's count of slots on the
    ranks before this one: a slot is kept when its rank over the whole
    call is below ``capacity``, and C is at most this rank's T k."""
    E, dev = num_experts, idx.device
    flat_e = idx.reshape(-1)
    n = flat_e.numel()
    # stable sort by expert; rank within expert = i - first index of it
    se, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(se, torch.arange(E, device=dev), side="left")
    rank = torch.arange(n, device=dev) - first[se]
    if offset is None:
        C = capacity
        keep = rank < C
    else:
        C = min(capacity, n)
        keep = offset[se] + rank < capacity
    return order, torch.where(keep, se * C + rank, E * C), C


def dispatch_compute_combine(x: torch.Tensor, idx: torch.Tensor,
                             w: torch.Tensor, wi: torch.Tensor,
                             wo: torch.Tensor, *, capacity: int,
                             num_experts: int, top_k: int,
                             offset: Optional[torch.Tensor] = None,
                             tp: Optional[dist.TPGroup] = None
                             ) -> torch.Tensor:
    """``_dispatch_compute_combine``: x (B, S, D), idx / w (B, S, k) ->
    the routed output (B, S, D) in x's dtype; ``offset`` see
    ``plan_slots``. With ``tp`` (the reference's ``ep_axis``) ``wi`` and
    ``wo`` are this rank's E / tp experts and the buffer goes to their
    ranks and back by ``all_to_all``."""
    B, S, D = x.shape
    T, E, K = B * S, num_experts, top_k
    order, dest, C = plan_slots(idx, capacity=capacity, num_experts=E,
                                offset=offset)

    # src[e*C + c] = the token feeding that cell (T: empty -> zero row)
    tok_of_slot = torch.arange(T, device=x.device).repeat_interleave(K)
    src = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    src[dest] = tok_of_slot[order]
    xf = x.reshape(T, D)
    xpad = torch.cat([xf, xf.new_zeros((1, D))])
    # index_select, not xpad[src]: its backward adds rows with atomics,
    # where indexing's sorts the indices and adds each run of equal ones
    # in one thread, and every empty cell reads the zero row T
    xd = xpad.index_select(0, src[:-1]).reshape(E, C, D)   # dispatch
    if tp is not None:      # (E, C, D) -> (E/tp, tp C, D): my experts' tokens
        xd = dist.all_to_all(xd, 0, 1, tp)

    h = torch.bmm(xd, wi.to(x.dtype))
    g, u = h.chunk(2, dim=-1)
    y = torch.bmm(F.silu(g) * u, wo.to(x.dtype))
    if tp is not None:                                     # back to (E, C, D)
        y = dist.all_to_all(y, 1, 0, tp)

    # combine: slot s (in token order) reads y[dest of s], zero if dropped
    ypad = torch.cat([y.reshape(E * C, D), y.new_zeros((1, D))])
    slot_dest = torch.empty_like(dest)
    slot_dest[order] = dest
    gathered = ypad.index_select(0, slot_dest).reshape(T, K, D)
    out = (gathered * w.reshape(T, K, 1).to(gathered.dtype)).sum(dim=1)
    return out.reshape(B, S, D)


def _counts(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(idx, minlength=n)`` of expert indices below ``n``;
    on the meta device (the dry run), where ``bincount`` has no kernel, an
    empty count of that shape."""
    if idx.device.type == "meta":
        return torch.empty(n, dtype=torch.long, device=idx.device)
    return torch.bincount(idx, minlength=n)


def _route_across(p: MoE, x: torch.Tensor, cfg, token_shard: TokenShard
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, int]:
    """``route`` over the call's tokens on every batch rank (see the
    module's docstring) -> (weights, experts, aux, offset (E,),
    capacity)."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    index, shards = token_shard
    ctx = dist.current()
    batch = 1 if ctx is None else ctx.axis_size("act_batch")
    width = 1 if ctx is None else ctx.sizes.get(dist.TP_AXIS, 1)
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    if batch != shards or world != shards * width:
        raise NotImplementedError(
            f"{shards} batch shards over a world of {world} ranks, where "
            f"the mesh gives {batch} batch shards x {width} "
            f"{dist.TP_AXIS!r} ranks = {batch * width}: routing across "
            f"the batch ranks needs a world of (batch shards x "
            f"{dist.TP_AXIS!r})")
    probs = _probs(p.router, x)
    w, idx = _top_k(probs, K)
    T = x.shape[0] * x.shape[1]
    mine = torch.cat([_counts(idx.reshape(-1), E),
                      _counts(idx[..., 0].reshape(-1), E)])
    rows = dist.gather_batch(mine, ctx)               # batch order
    slots, top1 = rows[:, :E], rows[:, E:]
    offset = slots[:index].sum(dim=0)
    frac = top1.sum(dim=0).float() / (T * shards)
    aux = E * (frac * probs.mean(dim=(0, 1))).sum()
    return w, idx, aux, offset, capacity(T * shards, cfg)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _expert_parallel(p: MoE, cfg, x: torch.Tensor,
                     token_shard: Optional[TokenShard]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_moe`` under expert parallelism over ``p.tp`` (see the
    module's docstring)."""
    m, tp = cfg.moe, p.tp
    E, K = m.num_experts, m.top_k
    B, S, D = x.shape
    shards = 1 if token_shard is None else token_shard[1]
    if shards == 1:
        w, idx, aux = route(p.router, x, E, K)
    else:                   # the whole batch's top-1 counts, each rank once
        probs = _probs(p.router, x)
        w, idx = _top_k(probs, K)
        top1 = dist.all_reduce(_counts(idx[..., 0].reshape(-1), E).float())
        frac = top1 / (tp.size * B * S * shards)
        aux = E * (frac * probs.mean(dim=(0, 1))).sum()
    if S % tp.size == 0:
        n = S // tp.size
        out = dispatch_compute_combine(
            dist.split_dim(x, 1, tp), idx.narrow(1, tp.rank * n, n),
            dist.split_dim(w, 1, tp), p.wi, p.wo,
            capacity=capacity(B * n, cfg), num_experts=E, top_k=K, tp=tp)
        return dist.gather_dim(out, 1, tp), aux
    # every rank dispatches all of the call's tokens (decode): each expert
    # then sees tp copies of them, so every rank's output passes 1/tp of
    # its gradient, and the ranks' shares of x's and w's are summed
    out = dispatch_compute_combine(
        dist.copy_in(x, tp), idx, dist.copy_in(w, tp), p.wi, p.wo,
        capacity=capacity(B * S, cfg), num_experts=E, top_k=K, tp=tp)
    return _ScaleGrad.apply(out, 1.0 / tp.size), aux


def apply_moe(p: MoE, cfg, x: torch.Tensor,
              token_shard: Optional[TokenShard] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux). ``token_shard`` = (this rank's
    batch shard, shards) where each rank holds its own rows of the call
    (the sharded training step, or serving with ``models.fsdp``'s
    ``ServeShards``); None or one shard routes the call alone. Under
    expert parallelism (``p.tp``) see the module's docstring; a layer
    whose experts are whole raises under a context that would split them
    over "model" (a model built outside the mesh)."""
    m = cfg.moe
    ctx = dist.current()
    width = 1 if ctx is None else ctx.sizes.get(dist.TP_AXIS, 1)
    if p.tp is None and width > 1 and m.num_experts % width == 0:
        raise ValueError(
            f"the {m.num_experts} experts are whole under a mesh whose "
            f"{dist.TP_AXIS!r} axis ({width}) would split them: build the "
            f"model under the mesh it runs on")
    if p.tp is not None:
        out, aux = _expert_parallel(p, cfg, x, token_shard)
    else:
        offset = None
        if token_shard is not None and token_shard[1] > 1:
            w, idx, aux, offset, cap = _route_across(p, x, cfg, token_shard)
        else:
            w, idx, aux = route(p.router, x, m.num_experts, m.top_k)
            cap = capacity(x.shape[0] * x.shape[1], cfg)
        out = dispatch_compute_combine(
            x, idx, w, p.wi, p.wo, capacity=cap, num_experts=m.num_experts,
            top_k=m.top_k, offset=offset)
    if m.num_shared_experts:
        out = out + p.shared(x)
    return out, aux


__all__ = ["MoE", "apply_moe", "capacity", "dispatch_compute_combine",
           "plan_slots", "route"]
