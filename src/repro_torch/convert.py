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
  model_params(jax_params, cfg, policy=..., device=...)
      a port ``Model`` holding the JAX package's parameter tree (nested
      dicts of numpy arrays): each stacked axis unstacked (``layers``,
      the hybrid family's ``units``, the audio family's ``enc_layers``
      and ``dec_layers``), the hybrid ``tail`` list taken layer by layer,
      every (in, out) matrix kept as it is, each leaf cast to the compute
      dtype once.
  serve_shards(jax_params, cfg, policy=..., device=..., batch_shard=...)
      serving under the current mesh with the working weights sharded
      over "fsdp": a ``models.fsdp.ServeShards`` whose every rank holds
      its shards of the JAX package's parameter tree, attached to a
      ``Model`` of ``cfg`` built under the mesh;
  named_params(jax_tree, depth)
      any tree shaped like the parameters (float32 master weights, AdamW
      moments, gradients) as ``{port parameter name: array}``;
  opt_state(jax_opt_state, model)
      the reference's ``{"mu", "nu", "count"}`` as the port's optimizer
      state for ``model``;
  reference_tree(named)
      the inverse of ``named_params``: port parameters, gradients or
      moments as the JAX package's nested tree of numpy arrays, layers
      stacked again, so tests compare leaf by leaf.
  whole_cache(model, cache)
      a rank's decode cache under tensor parallelism gathered over
      "model" into the reference's whole layout (a collective on every
      rank of the group), so tests compare it with the reference's.
  run_config(cfg, device=...)
      the port's simulator ``RunConfig`` from the reference's, nested
      ``FaultRates`` / ``WorkloadProfile`` / ``RecoveryModel`` /
      ``RootCauseConfig`` / ``WatchdogConfig`` and scenarios (by registry
      name and fields) included; each nested converter is public too.
  fleet_job_spec(spec) / fleet_run_config(cfg, device=...)
      the port's ``FleetJobSpec`` and ``FleetRunConfig`` (every job spec,
      ``FaultRates`` and ``WorkloadProfile`` included) from the
      reference's.
  topology(topo) / timing_trace(trace)
      the port's ``Topology`` and ``TimingTrace`` holding a copy of a
      reference one's state, so two diagnosers start from one mid-run
      state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.ccltrace import WatchdogConfig
from repro_torch.core.detector import DetectorConfig, StragglerDetector
from repro_torch.core.policy import PolicyConfig
from repro_torch.core.sweep import SweepConfig
from repro_torch.core.triage import Stage, TriageConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.diagnose import (RootCauseConfig, TimingTrace, Topology,
                                  WindowTiming)
from repro_torch.guard import RecoveryModel, Tier
from repro_torch.models.common import Policy
from repro_torch.models.model import Model
from repro_torch.simcluster import (FaultRates, FleetJobSpec,
                                    FleetRunConfig, RunConfig,
                                    WorkloadProfile, scenario)


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


def _copy_tree(module: torch.nn.Module, tree: Mapping, prefix: str,
               loaded: Set[str], model: Model) -> None:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            _copy_tree(getattr(module, key), val, f"{name}.", loaded, model)
            continue
        param = getattr(module, key, None)
        if not isinstance(param, torch.nn.Parameter):
            raise KeyError(f"the port's model has no parameter {name}")
        # a writable copy of the rank's tensor-parallel slice
        arr = np.array(model.tp_slice(name, np.asarray(val, np.float32)),
                       np.float32)
        if arr.shape != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {arr.shape}, port "
                             f"shape {tuple(param.shape)}")
        param.data.copy_(torch.from_numpy(arr))
        loaded.add(name)


def _layer(tree: Mapping, i: int, depth: int) -> dict:
    """Layer ``i`` of a tree whose every leaf is stacked ``depth`` deep."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out[key] = _layer(val, i, depth)
            continue
        if np.shape(val)[0] != depth:
            raise ValueError(f"{key}: reference layer axis "
                             f"{np.shape(val)[0]}, port has {depth} layers")
        out[key] = np.asarray(val)[i]
    return out


def model_params(jax_params: Mapping, cfg, *,
                 policy: Optional[Policy] = None,
                 device: DeviceLike = "cuda") -> Model:
    """The port's ``Model`` of ``cfg`` carrying ``jax_params``, the values
    of ``repro.models.model.Model.init_params`` as nested dicts of numpy
    arrays. Raises unless every leaf of the tree finds its parameter, with
    its shape, and every parameter of the port is set. Built under a mesh
    whose "model" axis is wider than 1, the model keeps each rank's
    tensor-parallel slice (``Model.tp_slice``) of the reference's
    parameters, the same placement ``param_sharding`` gives their masters
    on "model" (where the model computes with a whole parameter that
    ``param_sharding`` splits, it keeps the whole)."""
    model = Model(cfg, policy, device=device, seed=None)
    loaded: Set[str] = set()
    _copy_tree(model, {k: v for k, v in jax_params.items()
                       if k not in model.stacks() + ("tail",)}, "", loaded,
               model)
    for stacked in model.stacks():
        layers = getattr(model, stacked)
        for i, lp in enumerate(layers):
            _copy_tree(lp, _layer(jax_params[stacked], i, len(layers)),
                       f"{stacked}.{i}.", loaded, model)
    tail = jax_params.get("tail", [])
    if len(tail) != len(getattr(model, "tail", [])):
        raise ValueError(f"reference tail of {len(tail)} layers, port "
                         f"{len(getattr(model, 'tail', []))}")
    for i, lp in enumerate(tail):
        _copy_tree(model.tail[i], lp, f"tail.{i}.", loaded, model)
    missing = sorted(set(dict(model.named_parameters())) - loaded)
    if missing:
        raise KeyError(f"reference tree leaves port parameters unset: "
                       f"{missing[:8]}")
    return model


def serve_shards(jax_params: Mapping, cfg, *,
                 policy: Optional[Policy] = None,
                 device: DeviceLike = "cuda",
                 batch_shard: Optional[Tuple[int, int]] = None):
    """A ``models.fsdp.ServeShards`` of a ``Model`` of ``cfg`` built under
    the current mesh (its "model" slices), holding this rank's shard under
    ``param_sharding`` of each parameter of ``jax_params`` (the reference's
    tree of numpy arrays, as ``model_params`` takes it), in the compute
    dtype, on ``device``; ``batch_shard`` as ``ServeShards`` takes it
    (``(0, 1)``: a batch every rank holds whole). The model is built on the
    meta device: a rank allocates its shards and, while it serves, the
    units it gathers, never its whole "model" slice. The holder is
    attached (``holder.model`` serves). Raises unless every parameter's
    whole shape is the reference's."""
    from repro_torch.models.fsdp import ServeShards
    model = Model(cfg, policy, device="meta", seed=None)
    named = named_params(jax_params, {s: len(getattr(model, s))
                                      for s in model.stacks()})
    shapes = model.global_shapes()
    for name, val in named.items():
        if name in shapes and tuple(np.shape(val)) != tuple(shapes[name]):
            raise ValueError(f"{name}: reference shape {np.shape(val)}, "
                             f"port shape {tuple(shapes[name])}")
    values = {name: np.asarray(val, np.float32)
              for name, val in named.items()}
    return ServeShards(model, batch_shard=batch_shard, values=values,
                       device=resolve(device))


def named_params(jax_tree: Mapping, depth: Union[int, Mapping[str, int]]
                 ) -> Dict[str, np.ndarray]:
    """``{port parameter name: array}`` of a tree shaped like the JAX
    package's parameters, whose stacked subtree (``layers``, the hybrid
    family's ``units``) has leaves ``depth`` deep, or, with ``depth`` a
    mapping (the audio family's ``{"enc_layers": ..., "dec_layers":
    ...}``), each named subtree that deep; the hybrid ``tail`` list
    becomes ``tail.<i>.``."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree: Mapping, prefix: str) -> None:
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = np.asarray(val)

    if not isinstance(depth, Mapping):
        depth = {"units" if "units" in jax_tree else "layers": depth}
    walk({k: v for k, v in jax_tree.items()
          if k not in tuple(depth) + ("tail",)}, "")
    for stacked, n in depth.items():
        for i in range(n):
            walk(_layer(jax_tree[stacked], i, n), f"{stacked}.{i}.")
    for i, lp in enumerate(jax_tree.get("tail", [])):
        walk(lp, f"tail.{i}.")
    return out


def opt_state(jax_opt_state: Mapping, model: Model) -> Dict[str, object]:
    """The reference's AdamW state ``{"mu", "nu", "count"}`` as the port's
    (``repro_torch.train.optimizer``) for ``model``: float32 moments keyed
    by parameter name on the model's device, a 0-d int32 count. Raises
    unless the moments cover exactly the model's parameters."""
    params = dict(model.named_parameters())
    depth = {s: len(getattr(model, s)) for s in model.stacks()}
    out: Dict[str, object] = {}
    for key in ("mu", "nu"):
        flat = named_params(jax_opt_state[key], depth)
        if set(flat) != set(params):
            raise KeyError(f"{key}: reference names "
                           f"{sorted(set(flat) ^ set(params))[:8]} do not "
                           f"match the port's parameters")
        out[key] = {n: torch.from_numpy(np.array(flat[n], np.float32)).to(
            model.device) for n in params}
    out["count"] = torch.tensor(int(np.asarray(jax_opt_state["count"])),
                                dtype=torch.int32, device=model.device)
    return out


def reference_tree(named: Mapping[str, object]) -> Dict[str, object]:
    """Port-named leaves (tensors or arrays) as the JAX package's nested
    tree of float32 numpy arrays: the leaves of each list of layers
    (``<stack>.<i>.``: ``layers``, the hybrid family's ``units``, the
    audio family's ``enc_layers`` and ``dec_layers``) stacked on a
    leading layer axis, and the hybrid ``tail.<i>.`` leaves a list of
    trees."""
    tree: Dict[str, object] = {}
    groups: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}

    def put(node: dict, parts, arr) -> None:
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    for name, val in named.items():
        arr = (val.detach().float().cpu().numpy()
               if isinstance(val, torch.Tensor) else np.asarray(val))
        parts = name.split(".")
        if len(parts) > 2 and parts[1].isdigit():
            groups.setdefault(parts[0], {}).setdefault(
                int(parts[1]), {})[".".join(parts[2:])] = arr
            continue
        put(tree, parts, arr)
    for group, layers in groups.items():
        if group == "tail":
            tree["tail"] = []
            for i in sorted(layers):
                lp: Dict[str, object] = {}
                for key, arr in layers[i].items():
                    put(lp, key.split("."), arr)
                tree["tail"].append(lp)
            continue
        stacked: Dict[str, object] = {}
        for key in layers[0]:
            put(stacked, key.split("."),
                np.stack([layers[i][key] for i in sorted(layers)]))
        tree[group] = stacked
    return tree


def _map_cache(fn, cache, dims):
    """``fn(tensor, dim)`` over the tensors of ``cache`` and the split dims
    ``Model.cache_tp_dims`` gives them, in ``dims``' structure."""
    if isinstance(dims, Mapping):
        return {k: _map_cache(fn, cache[k], d) for k, d in dims.items()}
    if isinstance(dims, (list, tuple)):
        return type(dims)(_map_cache(fn, c, d) for c, d in zip(cache, dims))
    return fn(cache, dims)


def whole_cache(model: Model, cache: Mapping) -> Dict[str, object]:
    """``cache``, a rank's decode cache (``prefill``'s or
    ``init_cache``'s), in the reference's layout: each tensor the rank
    holds a slice of gathered over "model" (every rank of the group must
    call this), the others as they are, "pos" kept and "kv_shards"
    dropped."""
    from repro_torch.dist import api as dist

    def whole(t, d):
        return t if d is None else dist.gather_dim(t, d, model.tp)
    out = _map_cache(whole, cache, model.cache_tp_dims(cache))
    out["pos"] = cache["pos"]
    return out


def fault_rates(cfg) -> FaultRates:
    return FaultRates(**_fields_of(FaultRates, cfg))


def workload_profile(cfg) -> WorkloadProfile:
    return WorkloadProfile(**_fields_of(WorkloadProfile, cfg))


def recovery_model(cfg) -> RecoveryModel:
    return RecoveryModel(**_fields_of(RecoveryModel, cfg))


def rootcause_config(cfg) -> RootCauseConfig:
    return RootCauseConfig(**_fields_of(RootCauseConfig, cfg))


def watchdog_config(cfg) -> WatchdogConfig:
    return WatchdogConfig(**_fields_of(WatchdogConfig, cfg))


def scenario_spec(sc):
    """A registry name stays a name (both registries hold the same
    names); a scenario instance becomes the port's scenario of the same
    registry name and fields."""
    if isinstance(sc, str):
        return sc
    return scenario(sc.name, **{f.name: getattr(sc, f.name)
                                for f in dataclasses.fields(sc)})


def run_config(cfg, device: DeviceLike = "cuda") -> RunConfig:
    """The port's ``RunConfig`` of the reference's ``cfg``; ``device``
    places the session's detector."""
    kw = _fields_of(RunConfig, cfg, device=str(device))
    kw["tier"] = Tier(int(cfg.tier))
    for f in dataclasses.fields(RunConfig):
        if isinstance(kw[f.name], dict):
            kw[f.name] = dict(kw[f.name])
    kw["scenarios"] = tuple(scenario_spec(sc) for sc in cfg.scenarios)
    kw["rootcause_cfg"] = None if cfg.rootcause_cfg is None \
        else rootcause_config(cfg.rootcause_cfg)
    kw["hang_cfg"] = None if cfg.hang_cfg is None \
        else watchdog_config(cfg.hang_cfg)
    kw["recovery"] = recovery_model(cfg.recovery)
    kw["workload"] = workload_profile(cfg.workload)
    kw["rates"] = fault_rates(cfg.rates)
    return RunConfig(**kw)


def fleet_job_spec(spec) -> FleetJobSpec:
    """The port's ``FleetJobSpec`` of the reference's ``spec``."""
    return FleetJobSpec(**_fields_of(FleetJobSpec, spec,
                                     tier=Tier(int(spec.tier))))


def fleet_run_config(cfg, device: DeviceLike = "cuda") -> FleetRunConfig:
    """The port's ``FleetRunConfig`` of the reference's ``cfg``; ``device``
    places every job's detector."""
    return FleetRunConfig(**_fields_of(
        FleetRunConfig, cfg, device=str(device),
        jobs=tuple(fleet_job_spec(j) for j in cfg.jobs),
        workload=workload_profile(cfg.workload),
        rates=fault_rates(cfg.rates)))


def topology(topo) -> Topology:
    """The port's ``Topology`` over the same row -> group map."""
    return Topology(np.array(topo.stage_of, copy=True))


def timing_trace(trace) -> TimingTrace:
    """A port ``TimingTrace`` holding a copy of ``trace``'s state (ring
    rows, ids, position, rolling sums, push counters), so that it goes on
    exactly as ``trace`` would."""
    out = TimingTrace(depth=trace.depth)
    out._bufs = {ch: np.array(b, copy=True) for ch, b in trace._bufs.items()}
    out._ids = None if trace._ids is None \
        else np.array(trace._ids, copy=True)
    out._used, out._head = int(trace._used), int(trace._head)
    out._sums = {ch: np.array(v, copy=True) for ch, v in trace._sums.items()}
    out._means = {ch: np.array(v, copy=True)
                  for ch, v in getattr(trace, "_means", {}).items()}
    out._sums_stale = bool(trace._sums_stale)
    out.generation = int(trace.generation)
    out.pushes = int(trace.pushes)
    out.last_backfill = None if trace.last_backfill is None \
        else np.array(trace.last_backfill, copy=True)
    last = trace._last
    out._last = None if last is None else WindowTiming(
        t=last.t, step=last.step, node_ids=np.array(last.node_ids),
        compute=np.array(last.compute), comm=np.array(last.comm),
        host=np.array(last.host), stall=np.array(last.stall))
    return out


__all__ = ["detector_config", "detector_state_to_numpy", "fault_rates",
           "fleet_job_spec", "fleet_run_config", "load_detector_state",
           "model_params", "named_params", "opt_state", "policy_config",
           "recovery_model", "reference_tree", "rootcause_config",
           "run_config", "scenario_spec", "serve_shards", "sweep_config",
           "timing_trace",
           "topology", "triage_config", "watchdog_config",
           "workload_profile"]
