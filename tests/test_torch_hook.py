"""The port's ``GuardStepHook`` against the JAX package's, and the
``train_with_guard`` scenario on the port.

One seeded sequence of (step, wall, metrics), with an injected stall,
hardware telemetry on some steps, checkpoint boundaries, rewinds on every
restart the hook asks for and a liveness check at the end, drives both
hooks (the port's detector on the CPU). Their restart answers must be
equal step by step, their sessions' JSONL event streams equal line for
line, and the Young–Daly cadence each hook sets on its tiered checkpoint
manager equal. Then a tiny phi3-mini trains through the port's
``Trainer`` with the hook, a ``TieredCheckpointManager`` and an injected
stall, as ``examples/train_with_guard.py`` does: the stall must be caught
and the job must resume from the peer tier (a hot spare). There the hook
sees a steady host step time, so that the CPU's load while the tests run
cannot move the synthetic peers' baseline past the stall.

With ``diagnose=True`` the same drive also compares the timing trace
each hook feeds, row by row, with the configured split and with the
trainer's own ``compute_s``/``comm_s``/``host_s``; a caller's session
takes ``trace=`` and refuses ``diagnose=True`` in both packages.
"""
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.diagnose import Diagnoser as JaxDiagnoser
from repro.diagnose import TimingTrace as JaxTimingTrace
from repro.diagnose import Topology as JaxTopology
from repro.guard import GuardSession as JaxGuardSession
from repro.guard import GuardStepHook as JaxGuardStepHook
from repro.guard import JsonlSink as JaxJsonlSink
from repro.guard import Tier as JaxTier
from repro.guard.hook import LocalHostControl as JaxLocalHostControl
from repro.guard.hook import LocalSweepBackend as JaxLocalSweepBackend
from repro.train import TieredCheckpointManager as JaxTiered
from repro_torch.configs import get_config, reduced
from repro_torch.diagnose import Diagnoser, TimingTrace, Topology
from repro_torch.guard import (GuardSession, GuardStepHook, JsonlSink,
                               LocalHostControl, LocalSweepBackend,
                               NodeSwapped, RecoveryEvent, Tier)
from repro_torch.models.model import Model
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                               TieredCheckpointManager, TrainConfig, Trainer)


def drive(hook, n_steps: int = 72, ckpt_every: int = 10,
          components: bool = False):
    """The trainer's side of the protocol on a synthetic wall sequence;
    returns every answer the hook gave. ``components`` adds the trainer's
    own compute/comm/host seconds to every step's metrics."""
    rng = np.random.RandomState(11)
    answers = []
    step = 0
    while step < n_steps:
        step += 1
        wall = 0.5 * (1.0 + 0.004 * rng.standard_normal())
        metrics = {"loss": 2.0}
        if components:
            metrics.update(compute_s=0.3 * wall, comm_s=0.15 * wall,
                           host_s=0.05 + 0.001 * rng.rand())
        if step % 3 == 0:                  # a slower hardware exporter
            metrics.update(gpu_temp=61.0 + rng.rand(), nic_errors=0.0,
                           gpu_power=300.0 + rng.rand())
        if step % ckpt_every == 0:
            hook.on_checkpoint(step)
        restart = hook(step, wall, metrics)
        answers.append((step, restart))
        if restart:
            back = (step // ckpt_every) * ckpt_every
            hook.on_restart(back)
            hook.on_recovery(back, {"ckpt_tier": "peer", "hot_spare": True,
                                    "restore_s": 0.25,
                                    "replay_steps": step - back})
            step = back
    t = hook.control.now()
    answers.append(("deadline", hook.step_deadline()))
    answers.append(("alive", hook.check_liveness(t + 10.0)))
    answers.append(("hung", hook.check_liveness(t + 1000.0)))
    return answers


def test_hook_matches_reference_step_by_step(tmp_path):
    kw = dict(n_peers=15, window_steps=4, seed=3)
    ref, port = JaxGuardStepHook(**kw), GuardStepHook(device="cpu", **kw)
    streams = []
    for hook, sink_cls, tiered, name in (
            (ref, JaxJsonlSink, JaxTiered, "ref"),
            (port, JsonlSink, TieredCheckpointManager, "port")):
        hook.inject_stall(at_step=30, factor=8.0, steps=4)
        hook.inject_stall(at_step=55, factor=1.2, steps=8)
        sink = sink_cls(str(tmp_path / f"{name}.jsonl"))
        hook.session.add_sink(sink)
        ckpt = tiered(str(tmp_path / f"ckpt-{name}"))
        hook.bind_checkpoint(ckpt)
        answers = drive(hook)
        sink.close()
        streams.append((answers, ckpt.fast_interval_s,
                        (tmp_path / f"{name}.jsonl").read_text()))
    (ra, rint, rjs), (pa, pint, pjs) = streams
    assert pa == ra
    assert sum(1 for _, r in pa if r is True) >= 1    # the stall was caught
    assert pjs == rjs
    kinds = {line.split('"kind": "')[1].split('"')[0]
             for line in pjs.splitlines()}
    assert {"straggler_flagged", "swap", "recovery", "hang"} <= kinds
    assert pint == rint
    assert port.frames_fed == ref.frames_fed
    assert port.restarts_requested == ref.restarts_requested
    assert port.hangs_detected == ref.hangs_detected == 1
    assert port.node_id == ref.node_id != 0           # swapped out


def trace_rows(trace):
    return [[trace.rows(ch).tolist() for ch in ("compute", "comm", "host",
                                                 "stall")],
            trace.node_ids.tolist(), trace.pushes, trace.last().step]


@pytest.mark.parametrize("components", [False, True])
def test_diagnose_hook_matches_reference_step_by_step(tmp_path, components):
    kw = dict(n_peers=15, window_steps=4, seed=3, diagnose=True)
    ref, port = JaxGuardStepHook(**kw), GuardStepHook(device="cpu", **kw)
    out = []
    for hook, sink_cls, name in ((ref, JaxJsonlSink, "ref"),
                                 (port, JsonlSink, "port")):
        hook.inject_stall(at_step=30, factor=8.0, steps=4)
        sink = sink_cls(str(tmp_path / f"{name}.jsonl"))
        hook.session.add_sink(sink)
        answers = drive(hook, components=components)
        sink.close()
        out.append((answers, (tmp_path / f"{name}.jsonl").read_text(),
                    trace_rows(hook.trace), hook.frames_fed,
                    hook.restarts_requested, hook.node_id))
    assert out[1] == out[0]
    assert sum(1 for _, r in out[1][0] if r is True) >= 1
    assert '"kind": "diagnosis"' in out[1][1]


def test_hook_refuses_what_is_not_ported(tmp_path):
    """A caller's session keeps its own wiring: it takes the trace its
    diagnoser reads (``trace=``) and refuses ``diagnose=True``, in both
    packages, with the same answers and event stream."""
    out = []
    for (hook_cls, session_cls, tier, diag_cls, trace_cls, topo_cls,
         control_cls, backend_cls, sink_cls, name, kw) in (
            (JaxGuardStepHook, JaxGuardSession, JaxTier, JaxDiagnoser,
             JaxTimingTrace, JaxTopology, JaxLocalHostControl,
             JaxLocalSweepBackend, JaxJsonlSink, "ref", {}),
            (GuardStepHook, GuardSession, Tier, Diagnoser, TimingTrace,
             Topology, LocalHostControl, LocalSweepBackend, JsonlSink,
             "port", {"device": "cpu"})):
        trace = trace_cls()
        session = session_cls.from_tier(
            tier.ONLINE, control_cls(), backend_cls(),
            diagnoser=diag_cls(trace, topo_cls.single(8)), **kw)
        session.register_active(list(range(8)))
        session.register_spares([8, 9])
        with pytest.raises(ValueError, match="diagnose=True"):
            hook_cls(session=session, n_peers=7, diagnose=True)
        hook = hook_cls(session=session, n_peers=7, window_steps=4,
                        trace=trace, seed=5)
        hook.inject_stall(at_step=30, factor=8.0, steps=4)
        sink = sink_cls(str(tmp_path / f"{name}.jsonl"))
        session.add_sink(sink)
        answers = drive(hook)
        sink.close()
        out.append((answers, (tmp_path / f"{name}.jsonl").read_text(),
                    trace_rows(trace)))
    assert out[1] == out[0]
    assert '"kind": "diagnosis"' in out[1][1]


def test_hook_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        GuardStepHook()


class SteadyHostHook(GuardStepHook):
    """The hook with this host's measured step time replaced by a steady
    50 ms: the only slowdown Guard sees is the injected stall."""

    def __call__(self, step, wall_s, metrics):
        return super().__call__(step, 0.05, metrics)


def test_train_with_guard_scenario_recovers_from_the_peer_tier():
    # examples/train_with_guard.py at a tiny size, on the port
    cfg = reduced(get_config("phi3-mini-3.8b"), num_layers=2, d_model=64,
                  num_heads=2, num_kv_heads=2, d_ff=128, head_dim=32,
                  vocab_size=512)
    steps = 48
    model = Model(cfg, device="cpu", seed=0)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len=32,
                                  global_batch=2))
    hook = SteadyHostHook(window_steps=4, n_peers=15, device="cpu")
    hook.inject_stall(at_step=steps // 2, factor=8.0, steps=4)
    swaps = []
    hook.session.bus.subscribe(NodeSwapped, swaps.append)
    recoveries = []
    hook.session.bus.subscribe(RecoveryEvent, recoveries.append)
    with tempfile.TemporaryDirectory() as d:
        ckpt = TieredCheckpointManager(d, node_id=hook.node_id,
                                       fast_interval_s=5.0)
        hook.bind_checkpoint(ckpt)
        trainer = Trainer(model, data, TrainConfig(
            steps=steps, ckpt_interval=50,
            opt=AdamWConfig(peak_lr=6e-4, warmup_steps=5,
                            total_steps=steps)), ckpt=ckpt, hook=hook)
        out = trainer.run()
        assert ckpt.snapshots_taken >= 1
        assert Path(d, "local").is_dir()
    losses = [h["loss"] for h in out["history"]]
    assert out["final_step"] == steps
    assert hook.restarts_requested >= 1, "stall was not detected"
    # the window that holds three of the stall's four steps ends at 28
    assert [e.step + e.replay_steps for e in recoveries] == [28]
    assert swaps and swaps[0].old == 0
    assert recoveries and any(e.hot_spare and e.ckpt_tier == "peer"
                              for e in recoveries)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
