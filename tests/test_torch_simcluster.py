"""Parity of the port's ``simcluster`` with the JAX package's.

The same ``RunConfig`` and seed go through both ``simulate_run``s (the
port's detector on the CPU, converted by ``repro_torch.convert``): every
``SimCluster.collect`` frame must be equal window by window, and so must
every field of the two ``RunResult``s. The configurations are the
benchmarks' own: the four ``bench_diagnose`` scenarios at ``--quick``
length, a ``bench_hang`` scenario with the watchdog, and the four tiers
of the ``run_all`` ablation at 128 nodes. The quickstart example runs on
each package's own cluster and session. Everything is exact (atol 0).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.simcluster as rs
import repro_torch.simcluster as ts
from repro.ccltrace import WatchdogConfig
from repro.diagnose import RootCauseConfig
from repro.guard import GuardSession as RefSession
from repro.guard import JsonlSink as RefSink
from repro_torch import convert
from repro_torch.guard import GuardSession, JsonlSink

QUIET = rs.FaultRates(thermal=0, power=0, mem_ecc=0, nic_down=0,
                      nic_degraded=0, host_cpu=0, congestion=0, fail_stop=0,
                      admission_grey_p=0)
# benchmarks/bench_diagnose.py and bench_hang.py: comm-heavier split
DIAG_WORKLOAD = rs.WorkloadProfile(name="diagnose_bench", compute_s=6.0,
                                   comm_exposed_s=2.5, host_s=1.5)
HANG_WORKLOAD = rs.WorkloadProfile(name="hang_bench", compute_s=6.0,
                                   comm_exposed_s=2.5, host_s=1.5)


def diagnose_config(**kw):
    kw.setdefault("rates", QUIET)
    kw.setdefault("initial_grey_p", 0.0)
    return rs.RunConfig(tier=rs.Tier.ENHANCED, n_nodes=128, n_spare=16,
                        duration_h=2.5, dp_group_size=16, diagnose=True,
                        workload=DIAG_WORKLOAD, seed=7, **kw)


CONFIGS = {
    "diagnose_rack_thermal": diagnose_config(scenarios=(
        rs.RackThermal(at_h=0.5, rack_size=8, rack_start=24, severity=0.85,
                       power_fraction=0.0),)),
    "diagnose_switch_failure": diagnose_config(scenarios=(
        rs.SwitchFailure(at_h=0.5, group_size=16, group_start=48,
                         down_fraction=0.25, severity=0.9),)),
    "diagnose_congestion_storm": diagnose_config(scenarios=(
        rs.CongestionStorm(at_h=0.5, duration_h=1.0, hit_fraction=0.25,
                           severity=0.7),)),
    "diagnose_mixed": diagnose_config(
        rates=rs.FaultRates(), initial_grey_p=0.03, scenarios=(
            rs.RackThermal(at_h=0.6, rack_size=8, rack_start=24,
                           severity=0.85, power_fraction=0.0),
            rs.SwitchFailure(at_h=1.0, group_size=8, group_start=96,
                             down_fraction=0.25, severity=0.9),
            rs.CongestionStorm(at_h=0.4, duration_h=0.8, hit_fraction=0.2,
                               severity=0.7))),
    "hang_straggler_timeout_cascade": rs.RunConfig(
        tier=rs.Tier.ENHANCED, n_nodes=64, n_spare=10, duration_h=3.0,
        dp_group_size=16, diagnose=True, hang_watchdog=True,
        workload=HANG_WORKLOAD, rates=QUIET, initial_grey_p=0.0, seed=11,
        scenarios=("straggler_timeout_cascade",)),
    **{f"ablation_{t.name.lower()}": rs.RunConfig(
        tier=t, n_nodes=128, n_spare=21, duration_h=10.0,
        initial_grey_p=0.2, workload=rs.WorkloadProfile(),
        rates=rs.FaultRates(), seed=0) for t in rs.Tier},
}


def frame_dict(f):
    return {"t": f.t, "step": f.step, "node_ids": f.node_ids.tolist(),
            "valid": f.valid.tolist(),
            "metrics": {k: np.asarray(v).tolist()
                        for k, v in f.metrics.items()}}


def record_frames(monkeypatch, cls):
    frames = []
    collect = cls.collect

    def recording(self):
        f = collect(self)
        if f is not None:
            frames.append(frame_dict(f))
        return f

    monkeypatch.setattr(cls, "collect", recording)
    return frames


def assert_same_run(ref, port):
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if f.name == "tier":
            assert int(b) == int(a)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a)
        elif isinstance(a, float) and np.isnan(a):
            assert np.isnan(b)
        else:
            assert b == a, f.name


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_matches_reference_frame_by_frame(name, monkeypatch):
    cfg = CONFIGS[name]
    ref_frames = record_frames(monkeypatch, rs.SimCluster)
    port_frames = record_frames(monkeypatch, ts.SimCluster)
    ref = rs.simulate_run(cfg)
    port = ts.simulate_run(convert.run_config(cfg, device="cpu"))
    assert len(port_frames) == len(ref_frames)
    for w, (a, b) in enumerate(zip(ref_frames, port_frames)):
        assert b == a, f"frame {w}"
    assert_same_run(ref, port)
    kinds = {e["kind"] for e in port.events}
    if cfg.tier >= rs.Tier.ONLINE:
        assert port_frames                     # the detector was fed
    if cfg.diagnose and name != "diagnose_congestion_storm":
        assert "diagnosis" in kinds
    if cfg.hang_watchdog:
        assert "hang" in kinds


def run_quickstart(pkg, session_cls, sink_cls, path, **kw):
    """``examples/quickstart.py`` on one package's cluster and session."""
    rates = QUIET if pkg is rs else convert.fault_rates(QUIET)
    cluster = pkg.SimCluster(n_active=32, n_spare=4, rates=rates, seed=0)
    session = session_cls.from_tier(pkg.Tier.ENHANCED, control=cluster,
                                    sweep_backend=cluster, **kw)
    sink = sink_cls(str(path))
    session.add_sink(sink)
    session.register_active(cluster.active)
    session.register_spares(cluster.spares)
    cluster.injector.inject(pkg.FaultKind.THERMAL, 5, severity=0.9)
    cluster.injector.inject(pkg.FaultKind.NIC_DOWN, 9, device=7)
    frames = []
    for step in range(1, 601):
        cluster.run_step()
        if step % cluster.window_steps == 0:
            frame = cluster.collect()
            if frame is not None:
                frames.append(frame_dict(frame))
                session.observe(frame)
        if step % 90 == 0:
            session.on_checkpoint()
        session.advance(cluster.t)
    session.scheduler.drain(cluster.t)
    sink.close()
    tail = [cluster.run_step()["step_time"] for _ in range(20)]
    return (frames, path.read_text(), dataclasses.asdict(session.stats),
            session.node_state(5).value, session.node_state(9).value, tail)


def test_quickstart_matches_reference(tmp_path):
    ref = run_quickstart(rs, RefSession, RefSink, tmp_path / "ref.jsonl")
    port = run_quickstart(ts, GuardSession, JsonlSink,
                          tmp_path / "port.jsonl", device="cpu")
    assert port == ref
    assert '"kind": "swap"' in port[1]


def test_run_config_converts_every_field():
    cfg = CONFIGS["diagnose_mixed"]
    cfg = dataclasses.replace(
        cfg, hang_watchdog=True, scenarios=cfg.scenarios + ("rack_thermal",),
        hang_cfg=WatchdogConfig(deadline_mult=6.0),
        rootcause_cfg=RootCauseConfig(blame_floor=0.05))
    port = convert.run_config(cfg, device="cpu")
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(port, f.name)
        if f.name == "tier":
            assert int(b) == int(a)
        elif f.name == "scenarios":
            assert [getattr(s, "name", s) for s in b] == \
                [getattr(s, "name", s) for s in a]
            assert [dataclasses.asdict(s) for s in b
                    if not isinstance(s, str)] == \
                [dataclasses.asdict(s) for s in a if not isinstance(s, str)]
        elif dataclasses.is_dataclass(a):
            assert type(b).__module__.startswith("repro_torch.")
            assert dataclasses.asdict(b) == dataclasses.asdict(a)
        else:
            assert b == a, f.name
    assert port.device == "cpu"


def test_simulate_run_defaults_to_the_card():
    assert ts.RunConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        ts.simulate_run(ts.RunConfig(n_nodes=8, n_spare=2, duration_h=0.1))
