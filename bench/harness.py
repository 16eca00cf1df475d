"""One run of one cell: the program trains a configuration on a traffic
mix for a measured window, and its first steps and Guard verdicts are
held against the plain references.

Set-up builds one ``Trainer`` (the program's ``repro_torch.train``) on a
``Model`` whose weights are drawn from the seed (``weights``), the data
of the traffic file (``traffic``) and a ``GuardStepHook`` scoring a frame
of ``n_peers + 1`` nodes every ``window_steps`` steps, and drives it
through ``Trainer.run`` itself: the first ``checked_steps`` steps are the
ones held against the reference; the window opens at the end of the
first step that is at least ``warmup_steps`` after them and after the
hook has scored its first frame (whose one-time costs are set-up), and
closes at the first step's end after ``seconds``. A step is timed end
to end: from one step's end to the next (the data, the step, the read of
its metrics, the hook). With tracing on, a few more steps run under the
profiler after the window closed.

After the window (its numbers read, the program's state freed) the
checks run: Guard's verdicts on every frame of the run against
``guard_ref``, and the first steps against the family's plain reference
(``reference.<family>``): each step's loss, each leaf's norm of the first
gradient as the optimizer got it (from the first moment after one step,
unclipped by the global norm the step reported) and each leaf's norm of
its change over the checked steps. A family may add numbers of its own in
``checks.<family>``: its ``NUMBERS``, a ``Probe(model, names)`` made at
set-up where the cell's limits name one of them (``first_step_done()``
after the first step, ``remove()``, ``numbers(c, tf, seed, device,
grad)`` after the window)
and ``control(...)``, the same numbers of the control. ``judge`` holds
the numbers to the cell's limits, for the runs and for the control.
"""
from __future__ import annotations

import gc
import importlib
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from bench import guard_ref, trace as trace_mod, traffic as traffic_mod
from bench import weights
from bench.reference.common import (Prec, adamw, leaf_norms, lr_at,
                                    no_tf32)

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_TRIES = 3
LATER_STEPS = {"loss", "change"}   # numbers that need every checked step


class WindowClosed(Exception):
    """Raised from the step hook at the step boundary that ends a run."""


# ------------------------------------------------------------ the cell


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bm: dict, name: str) -> dict:
    """The workload ``name`` with its configuration file, traffic file,
    limits and metric entries."""
    wl = {w["name"]: w for w in bm["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bm["configs"]}[wl["config"]]
    applies = lambda m: name in m.get("workloads", [name])
    return {"workload": wl,
            "config": json.loads((ROOT / conf["file"]).read_text()),
            "traffic": traffic_mod.load(wl["traffic"]),
            "limits": json.loads((HERE / "limits" / f"{name}.json")
                                 .read_text()),
            "end_to_end": [m for m in bm["end_to_end"] if applies(m)],
            "per_layer": [m for m in bm["per_layer"] if applies(m)]}


def ref_config(conf: dict) -> dict:
    """The sizes the reference reads: the configuration's run block with
    the head size and the vocabulary padded to a multiple of 128."""
    c = dict(conf["run"])
    if "num_heads" in c and not c.get("head_dim"):
        c["head_dim"] = c["d_model"] // c["num_heads"]
    c["vocab_padded"] = -(-c["vocab_size"] // 128) * 128
    c.setdefault("rope_theta", 10_000.0)
    return c


def family(conf: dict):
    return importlib.import_module(f"bench.reference.{conf['family']}")


def family_checks(conf: dict):
    """The family's own checks (``bench/checks/<family>.py``), or None."""
    try:
        return importlib.import_module(f"bench.checks.{conf['family']}")
    except ModuleNotFoundError as e:
        if e.name != f"bench.checks.{conf['family']}":
            raise
        return None


def flops_per_step(conf: dict, traffic: dict) -> float:
    mod = importlib.import_module(f"bench.flops.{conf['family']}")
    return mod.per_step(ref_config(conf), traffic)


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())


# ------------------------------------------------------------ the program


def build_model(conf: dict, seed: int, device: str):
    from repro_torch.configs.base import ArchConfig, MoEConfig
    from repro_torch.models.model import Model
    run = dict(conf["run"])
    moe = run.pop("moe", None)
    cfg = ArchConfig(**run, moe=MoEConfig(**moe) if moe else None)
    model = Model(cfg, device=device, seed=None, remat="full")
    spec = family(conf).param_spec(ref_config(conf))
    weights.load_into(dict(model.named_parameters()), spec, seed)
    return model


SPANS_ON = {"on": False}      # set while the profiler runs


def _span(name: str, fn, *args):
    if not SPANS_ON["on"]:
        return fn(*args)
    with torch.profiler.record_function(name):
        return fn(*args)


class _SpannedData:
    """The data source with each ``batch_at`` inside a ``bench.batch``
    span while the profiler runs."""

    def __init__(self, data):
        self.data, self.cfg = data, data.cfg

    def batch_at(self, *args):
        return _span("bench.batch", self.data.batch_at, *args)


def _spanned_step(fn):
    def step(*args):
        return _span("bench.step", fn, *args)
    return step


class BenchHook:
    """The trainer's step hook: hands each step to the Guard hook, reads
    the checked steps' numbers, opens and closes the window and, with
    tracing on, profiles the steps after it."""

    def __init__(self, inner, trainer_ref: Callable, spec, seed: int,
                 traffic: dict, seconds: float, tracing: bool, device,
                 needed=(), probe=None, decays: Callable = None):
        self.inner, self.trainer, self.spec = inner, trainer_ref, spec
        self.needed, self.probe, self.decays = set(needed), probe, decays
        self.adamw_gap = None
        self.seed, self.device, self.seconds = seed, device, seconds
        self.checked = traffic["checked_steps"]
        self.open_at = self.checked + traffic["warmup_steps"]
        self.opt = traffic["optimizer"]
        self.tracing, self.trace_steps = tracing, traffic["guard"][
            "window_steps"]
        self.calls = 0
        self.losses: List[float] = []
        self.grad_leaf: Dict[str, float] = {}
        self.change_leaf: Dict[str, float] = {}
        self.t_open = self.t_close = None
        self.stamps: List[float] = []
        self.window_losses: List[float] = []
        self.guard_s: List[float] = []
        self.restarts = 0
        self.setup_peak = self.window_peak = 0
        self.alloc: Dict[str, int] = {}
        self.prof = self.phase = self.spans = None
        self.traced = None
        self.trace_tries = 0
        self._traced_calls = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_step(self, n: int, m: dict) -> None:
        tr = self.trainer()
        self.losses.append(float(m["loss"]))
        if n == 1:
            # mu = (1 - b1) g min(1, clip / |g|): the unclipped gradient
            scale = min(self.opt["grad_clip"] / max(m["grad_norm"], 1e-9),
                        1.0)
            mu = leaf_norms(tr.opt_state["mu"])
            self.grad_leaf = {k: v / ((1 - self.opt["b1"]) * scale)
                              for k, v in mu.items()}
            if self.probe is not None:
                self.probe.first_step_done()
            if "adamw" in self.needed:
                self.adamw_gap = self._adamw_stage(tr)
        if n == self.checked:
            self.change_leaf = weights.per_leaf(
                self.spec, self.seed, self.device,
                lambda name, p0: float(torch.linalg.vector_norm(
                    (tr.params[name] - p0).double())))

    def _adamw_stage(self, tr) -> float:
        """The optimizer's first update against the reference's AdamW of
        the gradient the step's first moment holds: the worst leaf's norm
        of the gap of the masters (and of the second moment) over the norm
        of the reference's update (or of its second moment), at least the
        median leaf's."""
        opt = self.opt
        b1, b2 = opt["b1"], opt["b2"]
        lr = lr_at(opt, 1)
        rows = []
        for name, p0 in weights.leaves(self.spec, self.seed, self.device):
            p0 = p0.float()
            p1 = tr.params[name]
            mu, nu = tr.opt_state["mu"][name], tr.opt_state["nu"][name]
            g = mu / (1 - b1)                      # the clipped gradient
            nu_r = (1 - b2) * g.square()
            upd = g / (g.abs() + opt["eps"])       # (mu/b1c)/(sqrt(nu/b2c)+eps)
            if self.decays(name, tuple(p0.shape)):
                upd = upd + opt["weight_decay"] * p0
            step = lr * upd
            rows.append((float(torch.linalg.vector_norm(
                (p1 - (p0 - step)).double())), float(
                torch.linalg.vector_norm(step.double())), float(
                torch.linalg.vector_norm((nu - nu_r).double())), float(
                torch.linalg.vector_norm(nu_r.double()))))
        med_s = float(np.median([r[1] for r in rows]))
        med_n = float(np.median([r[3] for r in rows]))
        return max(max(a / max(b, med_s, 1e-30), c / max(d, med_n, 1e-30))
                   for a, b, c, d in rows)

    def _start_trace(self, phase: str) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA]
        if phase == "spans":
            acts.insert(0, ProfilerActivity.CPU)
        self.phase = phase
        SPANS_ON["on"] = True
        self.prof = profile(activities=acts)
        self.prof.start()
        torch.cuda._sleep(trace_mod.LEAD_CYCLES * 4 ** self.trace_tries)
        torch.cuda.synchronize()
        self._traced_calls = 0
        self._t_trace = time.perf_counter()

    def _trace_step(self) -> None:
        """Counts the traced steps; after ``trace_steps`` of them reads the
        session, retakes a lossy one (its lead-in four times as long, at
        most TRACE_TRIES sessions a phase), goes on to the device phase
        and ends the run after it."""
        self._traced_calls += 1
        if self._traced_calls < self.trace_steps:
            return
        torch.cuda.synchronize()
        window = time.perf_counter() - self._t_trace
        self.prof.stop()
        SPANS_ON["on"] = False
        prof, self.prof = self.prof, None
        self.trace_tries += 1
        if self.phase == "spans":
            self.spans = trace_mod.read_spans(prof)
            if self.spans is None and self.trace_tries < TRACE_TRIES:
                return self._start_trace("spans")
            if self.spans is None:
                raise WindowClosed
            self.trace_tries = 0
            return self._start_trace("device")
        tr = trace_mod.read_device(prof, window, self.trace_steps,
                                   self.spans["events"])
        if tr is None and self.trace_tries < TRACE_TRIES:
            return self._start_trace("device")
        if tr is not None:
            tr.gaps = self.spans["gaps"]
        self.traced = tr
        raise WindowClosed

    def __call__(self, step: int, wall_s: float, m: dict) -> bool:
        self.calls += 1
        n = self.calls
        if n <= self.checked:
            self._check_step(n, m)
        fed = self.inner.frames_fed
        t_in = time.perf_counter()
        restart = _span("bench.hook", self.inner, step, wall_s, m)
        t = time.perf_counter()
        self.restarts += bool(restart)
        if self.t_close is not None:          # the traced steps
            self._trace_step()
            return restart
        if self.t_open is not None:
            self.stamps.append(t)
            self.window_losses.append(float(m["loss"]))
            if self.inner.frames_fed > fed:
                self.guard_s.append(t - t_in)
            if t - self.t_open >= self.seconds:
                self.t_close = t
                if self.device.type == "cuda":
                    self.window_peak = torch.cuda.max_memory_allocated(
                        self.device)
                    self.alloc = _alloc_counts(self.device, self.alloc)
                if not self.tracing:
                    raise WindowClosed
                self._start_trace("spans")
        elif n >= self.open_at and self.inner.frames_fed:
            self._sync()
            if self.device.type == "cuda":
                self.setup_peak = torch.cuda.max_memory_allocated(
                    self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
                self.alloc = _alloc_counts(self.device)
            self.t_open = time.perf_counter()
        return restart


ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def _alloc_counts(device, since: Dict[str, int] = None) -> Dict[str, int]:
    """The caching allocator's calls to the driver (and its retries after
    freeing its cache), or their growth ``since`` an earlier reading."""
    st = torch.cuda.memory_stats(device)
    now = {k: int(st.get(k, 0)) for k in ALLOC_KEYS}
    return now if since is None else {k: now[k] - since[k] for k in now}


def _record_detector(hook) -> List[tuple]:
    """Every (frame, assessment) the hook's detector makes, kept as they
    are (device tensors read after the window)."""
    det = hook.session.monitor.detector
    seen: List[tuple] = []
    update = det.update

    def recorded(frame):
        out = update(frame)
        seen.append((frame, out))
        return out
    det.update = recorded
    return seen


def run_program(c: dict, seed: int, seconds: float, tracing: bool,
                device: str) -> dict:
    """Set-up, window and the program's side of the checks."""
    from repro_torch.guard import GuardStepHook
    from repro_torch.train import AdamWConfig, TrainConfig, Trainer
    conf, tf = c["config"], c["traffic"]
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    model = build_model(conf, seed, device)
    data = traffic_mod.source(tf, conf["run"]["vocab_size"], seed)
    g = tf["guard"]
    inner = GuardStepHook(n_peers=g["n_peers"], window_steps=g["window_steps"],
                          seed=seed % (1 << 32), device=device)
    frames = _record_detector(inner)
    holder: Dict[str, object] = {}
    fam = family(conf)
    spec = fam.param_spec(ref_config(conf))
    needed = set(c["limits"])
    checks = family_checks(conf)
    probe = checks.Probe(model, needed) if checks is not None and \
        needed & checks.NUMBERS else None
    hook = BenchHook(inner, lambda: holder["t"], spec, seed, tf, seconds,
                     tracing, dev, needed, probe, fam.decays)
    trainer = Trainer(
        model, _SpannedData(data) if tracing else data,
        TrainConfig(steps=1 << 40, ckpt_interval=1 << 40,
                    microbatch=tf["microbatch"],
                    opt=AdamWConfig(**tf["optimizer"])), hook=hook)
    if tracing:
        trainer._step_fn = _spanned_step(trainer._step_fn)
    holder["t"] = trainer
    try:
        trainer.run()
    except WindowClosed:
        pass
    finally:
        if probe is not None:
            probe.remove()
    if hook.prof is not None:
        hook.prof.stop()
    SPANS_ON["on"] = False
    got = [a.numpy() for _, a in frames]
    fed = [{"node_ids": f.node_ids, "step_time": f.metrics["step_time"],
            "valid": f.valid} for f, _ in frames]
    out = {"hook": hook, "frames": fed, "verdicts": got, "probe": probe,
           "frames_fed": inner.frames_fed,
           "tokens_per_step": tf["global_batch"] * tf["seq_len"]}
    del trainer, model, holder, frames, inner
    hook.inner = hook.trainer = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ reference


def reference(conf: dict, tf: dict, seed: int, device: str,
              prec: str = "fp32", drop_half: bool = False,
              steps: int = 0, record=None) -> dict:
    """The reference's checked steps from the same weights and batches:
    losses, each leaf's first-gradient norm, each leaf's change.
    ``drop_half`` plants a fault: half of each batch left out and the
    mean taken over the rest (the later half of the micro-batches, or of
    each sequence's tokens where a step has one micro-batch). ``record``,
    a dict, receives what the family's checks keep of the first step."""
    no_tf32()
    fam, c = family(conf), ref_config(conf)
    spec = fam.param_spec(c)
    dev = torch.device(device)
    # the float32 master weights; each step computes on their bfloat16
    # rounding, the working weights the configuration trains with
    P = {n: v.float() for n, v in weights.leaves(spec, seed, dev)}
    data = traffic_mod.source(tf, c["vocab_size"], seed)
    decays = [n for n, s, _ in spec if fam.decays(n, s)]
    p = Prec(prec, record)
    state: dict = {}
    losses, grad_leaf, gnorms = [], {}, []
    mb = tf["microbatch"] or tf["global_batch"]
    for step in range(steps or tf["checked_steps"]):
        batch = data.batch_at(step)
        toks = torch.as_tensor(batch["tokens"], device=dev).long()
        labs = torch.as_tensor(batch["labels"], device=dev).long()
        parts = range(0, toks.shape[0], mb)
        if drop_half and len(parts) > 1:
            parts = parts[:len(parts) // 2]
        elif drop_half:
            labs[:, labs.shape[1] // 2:] = -100
        W = {n: t.bfloat16().float().requires_grad_(True)
             for n, t in P.items()}
        total = 0.0
        for i in parts:
            loss = fam.loss(W, c, toks[i:i + mb], labs[i:i + mb], p)[0]
            loss.backward()
            total += loss.item()
            del loss
        grads = {n: t.grad / len(parts) for n, t in W.items()}
        del W
        if step == 0:
            grad_leaf = leaf_norms(grads)
            if record is not None:
                p.record = None
        losses.append(total / len(parts))
        gnorms.append(adamw(P, grads, state, tf["optimizer"], decays))
        del grads
    change = weights.per_leaf(spec, seed, dev, lambda n, p0: float(
        torch.linalg.vector_norm((P[n] - p0).double())))
    del P, state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"loss": losses, "grad": grad_leaf, "change": change,
            "grad_norm": gnorms}


def gaps(prog: dict, ref: dict, head: str) -> Dict[str, float]:
    """The numbers a cell may compare: the worst step's relative loss gap
    ("loss") and the first step's alone ("loss_first"); the relative gap
    of the output head's (``head``) first-gradient norm ("grad_head": the loss
    reaches the head before any layer's backward, so it reads the
    forward's conditioning alone); for the first-gradient norms and the
    change norms, the worst leaf's gap over the larger of its reference
    norm and the median leaf's ("grad", "change"). Leaves whose reference
    gradient is under a thousandth of the median leaf's (moved by
    round-off alone under Adam) are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    if len(prog["loss"]) < len(ref["loss"]):
        loss = math.inf

    def leaf_gaps(a: dict, b: dict, keys) -> list:
        keys = list(keys)
        if not keys or set(keys) - set(a):
            return [math.inf]
        med = float(np.median([b[k] for k in keys]))
        return [abs(a[k] - b[k]) / max(b[k], med) for k in keys]
    gmed = float(np.median(list(ref["grad"].values())))
    moving = [k for k, v in ref["grad"].items() if v >= 1e-3 * gmed]
    first = abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    gh = abs(prog["grad"].get(head, math.inf) - ref["grad"][head]) / \
        ref["grad"][head]
    return {"loss": loss, "loss_first": first, "grad_head": gh,
            "grad": max(leaf_gaps(prog["grad"], ref["grad"], ref["grad"])),
            "change": max(leaf_gaps(prog["change"], ref["change"],
                                    moving))}


def control_numbers(c: dict, seed: int, device: str) -> dict:
    """The control and the half-batch fault, each in the program's place,
    by the cell's numbers against the float32 reference, and whether the
    cell's limits (``judge``) find each correct: the control is the
    reference with float8 products where the program's are bfloat16 and
    TF32 ones where they are float32, its family's numbers read from what
    its first step kept, as the program's are."""
    conf, tf = c["config"], c["traffic"]
    head = family(conf).HEAD
    ref = reference(conf, tf, seed, device)
    record: dict = {}
    low = reference(conf, tf, seed, device, "fp8", record=record)
    out = {"control": gaps(low, ref, head),
           "half_batch": gaps(reference(conf, tf, seed, device,
                                        drop_half=True), ref, head)}
    checks = family_checks(conf)
    if checks is not None:
        out["control"].update(checks.control(
            record, low["grad"], ref_config(conf), tf, seed, device,
            c["limits"]))
    del record
    for k in ("control", "half_batch"):
        out[k + "_correct"] = judge(out[k], c["limits"], partial=True)[0]
    return out


def judge(g: Dict[str, float], lim: Dict[str, float],
          partial: bool = False):
    """-> (every number within its limit, {name: {"value", "limit"}}).
    A number the cell limits and ``g`` lacks fails, unless ``partial``
    (the control's, which reads no verdicts and no optimizer state)."""
    keys = [k for k in lim if k in g or not partial]
    checks = {k: {"value": g.get(k, math.inf), "limit": lim[k]}
              for k in keys}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in checks.values())
    return ok, checks


# ------------------------------------------------------------ the run


def program_numbers(hook: BenchHook) -> dict:
    return {"loss": hook.losses, "grad": hook.grad_leaf,
            "change": hook.change_leaf}


def run_cell(c: dict, seed: int, seconds: float, tracing: bool,
             device: str, t_start: float) -> dict:
    """One run of a cell -> the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, a traced run's
    ``breakdown``, then ``checks``), the lines to print on standard error,
    and the numbers behind them."""
    prog = run_program(c, seed, seconds, tracing, device)
    hook: BenchHook = prog["hook"]
    conf, tf = c["config"], c["traffic"]
    win_s = hook.t_close - hook.t_open
    steps = len(hook.stamps)
    intervals = np.diff([hook.t_open] + hook.stamps)
    ctx = {"config": conf, "run": ref_config(conf), "traffic": tf,
           "steps": steps, "window_s": win_s,
           "tokens": steps * prog["tokens_per_step"],
           "intervals_s": intervals, "guard_s": hook.guard_s,
           "trace": hook.traced, "peaks": peaks(),
           "flops_per_step": flops_per_step(conf, tf)}
    e2e = {"tokens_per_s": ctx["tokens"] / win_s,
           "step_ms_p90": float(np.percentile(intervals, 90)) * 1e3,
           "peak_mem_gb": hook.window_peak / 1e9,
           "setup_s": hook.t_open - t_start}
    metrics = {}
    if tracing:
        for m in c["per_layer"]:
            mod = importlib.import_module(f"bench.metrics.{m['name']}")
            v = mod.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in c["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the checks, the program's state freed
    mism = guard_ref.mismatches(prog["frames"], prog["verdicts"])
    lim = c["limits"]
    # the reference runs every checked step where a number needs more
    # than the first
    first_only = not set(lim) & LATER_STEPS
    ref = reference(conf, tf, seed, device, steps=1 if first_only else 0)
    g = gaps(program_numbers(hook), ref, family(conf).HEAD)
    if first_only:                    # numbers of later steps not taken
        for k in LATER_STEPS:
            g.pop(k)
    g["guard"] = float(mism)
    probe = prog["probe"]
    if probe is not None:
        g.update(probe.numbers(ref_config(conf), tf, seed,
                               torch.device(device), hook.grad_leaf))
    if hook.adamw_gap is not None:
        g["adamw"] = hook.adamw_gap
    failed = sum(1 for x in hook.window_losses if not math.isfinite(x))
    ok, checks = judge(g, lim)
    ok = ok and steps > 0 and failed == 0 and prog["frames_fed"] > 0
    lines = [f"steps in window {steps} in {win_s:.3f} s; Guard frames "
             f"{prog['frames_fed']}, restarts requested {hook.restarts}",
             f"losses program {hook.losses} reference {ref['loss']}"]
    lines.append("numbers: " + ", ".join(f"{k} {v:.6g}"
                                         for k, v in g.items()))
    if len(intervals):
        q = np.percentile(intervals * 1e3, [0, 10, 50, 90, 100])
        lines.append("step intervals ms (min, p10, p50, p90, max): " +
                     ", ".join(f"{x:.2f}" for x in q) +
                     f"; allocator calls in the window {hook.alloc}")
    lines.append("Guard's scored windows, ms: " + ", ".join(
        f"{1e3 * x:.3f}" for x in hook.guard_s))
    lines += [f"check {k}: {g[k]:.6g} (limit {lim[k]:g})" for k in lim]
    result = {"correct": bool(ok), "attempted": steps, "failed": failed,
              "metrics": metrics,
              "device": device_info(device, max(hook.setup_peak,
                                                hook.window_peak))}
    if tracing and hook.traced is not None:
        result["device"]["busy_s"] = hook.traced.busy_s
        result["device"]["window_s"] = hook.traced.window_s
        result["breakdown"] = {"device_ops": hook.traced.top_ops(),
                               "idle_gaps": hook.traced.top_gaps()}
    result["checks"] = checks
    return {"result": result, "lines": lines, "gaps": g, "ref": ref,
            "program": program_numbers(hook), "e2e": e2e,
            "detail": probe.detail if probe is not None else {}}


def device_info(device: str, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
