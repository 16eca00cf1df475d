"""Parity of the port's ``diagnose`` with the JAX package's.

The what-if engine, the medians and the timing trace get the same NumPy
inputs in both packages. The root-cause classifier gets the reference
test suite's cases, then the frames and timing traces recorded from the
reference's ``SimCluster`` under a rack-thermal, a switch-failure and a
congestion scenario, each side behind its own detector (the port's on the
CPU), from the first window and from a mid-run state carried across by
``repro_torch.convert``. Verdict codes, root causes, held sets, evidence
and what-if arrays must be equal (atol 0). A diagnosed window copies the
flagged rows to the host once, and the diagnoser reads no device tensor.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.ccltrace as rc
import repro.diagnose as rd
import repro.simcluster as rs
import repro_torch.ccltrace as tc
import repro_torch.diagnose as td
from repro.core import DetectorConfig as RefDetectorConfig
from repro.core import StragglerDetector as RefDetector
from repro.core.detector import FleetAssessment as RefAssessment
from repro.core.policy import Action as RefAction
from repro.core.policy import Decision as RefDecision
from repro.core.telemetry import Frame as RefFrame
from repro.diagnose.whatif import fast_median as ref_fast_median
from repro.diagnose.whatif import row_median as ref_row_median
from repro_torch import convert
from repro_torch.core import DetectorConfig, Frame, StragglerDetector
from repro_torch.core.detector import FleetAssessment
from repro_torch.core.policy import Action, Decision
from repro_torch.diagnose.whatif import fast_median, row_median

QUIET = rs.FaultRates(thermal=0, power=0, mem_ecc=0, nic_down=0,
                      nic_degraded=0, host_cpu=0, congestion=0, fail_stop=0,
                      admission_grey_p=0)


def wt(pkg, node_ids, compute, comm, host, stall=None, t=0.0, step=0):
    n = len(node_ids)
    return pkg.WindowTiming(
        t=t, step=step, node_ids=np.asarray(node_ids, np.int64),
        compute=np.asarray(compute, float), comm=np.asarray(comm, float),
        host=np.asarray(host, float),
        stall=np.zeros(n) if stall is None else np.asarray(stall, float))


def port_wt(w):
    return td.WindowTiming(**{f.name: getattr(w, f.name)
                              for f in dataclasses.fields(w)})


def diag_dict(d):
    return {**dataclasses.asdict(d), "root_cause": d.root_cause.value}


def fleet_dict(fd):
    if fd is None:
        return None
    return {
        "arrays": [np.asarray(getattr(fd, k)).tolist() for k in
                   ("node_ids", "blame", "blame_rel", "marginal",
                    "stall_share")],
        "records": {n: diag_dict(r) for n, r in fd.records.items()},
        "new": [diag_dict(r) for r in fd.new_records],
    }


def diagnoser_dict(dg, ids):
    return {"last": {n: diag_dict(r) for n, r in sorted(dg.last.items())},
            "hold": [dg.should_hold(int(n)) for n in ids],
            "signals": [None if dg.signals_for(int(n)) is None else
                        dataclasses.asdict(dg.signals_for(int(n)))
                        for n in ids],
            "windows": dg.windows_diagnosed}


# ------------------------------------------------------------- what-if

_TOPOS = {
    "single": lambda n, pkg: pkg.Topology.single(n),
    "grouped8": lambda n, pkg: pkg.Topology.grouped(n, 8),
    "pipeline3": lambda n, pkg: pkg.Topology.pipeline(n, min(n, 3)),
    "shuffled": lambda n, pkg: pkg.Topology(
        np.random.RandomState(1).randint(0, 5, size=n)),
}


@pytest.mark.parametrize("topo", sorted(_TOPOS))
@pytest.mark.parametrize("n", [1, 37, 64])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ref_own", [None, 9.5])
def test_whatif_matches_reference(topo, n, dtype, ref_own):
    rng = np.random.RandomState(n)
    own = (10.0 + rng.standard_normal(n)).astype(dtype)
    own[rng.randint(n, size=max(n // 6, 1))] = own.max()   # ties at max
    a = rd.whatif(own.copy(), _TOPOS[topo](n, rd), ref_own=ref_own)
    b = td.whatif(own.copy(), _TOPOS[topo](n, td), ref_own=ref_own)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert y.dtype == x.dtype
            np.testing.assert_array_equal(y, x)
        else:
            assert y == x
    x = rng.rand(3, n).astype(dtype)
    np.testing.assert_array_equal(_TOPOS[topo](n, td).group_max(x),
                                  _TOPOS[topo](n, rd).group_max(x))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1001])
def test_medians_match_reference(n):
    rng = np.random.RandomState(n)
    a = rng.rand(n).astype(np.float32)
    assert fast_median(a) == ref_fast_median(a)
    m = rng.rand(5, n).astype(np.float32)
    np.testing.assert_array_equal(row_median(m), ref_row_median(m))


# --------------------------------------------------------------- trace


def _trace_history(pkg):
    tr = pkg.TimingTrace(depth=3)
    out = []
    rng = np.random.RandomState(5)
    ids = np.arange(6, dtype=np.int64)
    for k in range(7):
        if k == 4:
            ids = ids.copy()
            ids[2] = 99                      # same-size swap: backfill
        x = rng.rand(4, 6) + 1.0
        tr.push(wt(pkg, ids, *x, t=60.0 * k, step=6 * k))
        out.append([tr.mean(ch).tolist() for ch in pkg.CHANNELS])
        out.append([tr.own_mean().tolist(), tr.wall_mean().tolist(),
                    tr.last_row, tr.pushes, tr.generation,
                    None if tr.last_backfill is None
                    else tr.last_backfill.tolist()])
    tr.push(wt(pkg, np.arange(4), *np.ones((4, 4))))   # resize
    out.append([len(tr), tr.generation, tr.nbytes,
                tr.rows("compute").tolist()])
    tr.clear()
    out.append([len(tr), tr.full])
    return out


def test_timing_trace_matches_reference():
    assert _trace_history(td) == _trace_history(rd)


# ------------------------------------------------------ classification

N = 16


def _assess_ref(flagged_ids, support=None):
    ids = np.arange(N, dtype=np.int64)
    flagged = np.isin(ids, flagged_ids)
    return RefAssessment(
        node_ids=ids, slowdown=np.where(flagged, 0.3, 0.0),
        stalled=np.zeros(N, bool), step_deviant=flagged.copy(),
        support_masks={m: np.isin(ids, v)
                       for m, v in (support or {}).items()},
        flagged=flagged)


def _assess_port(flagged_ids, support=None):
    ref = _assess_ref(flagged_ids, support)
    t = torch.from_numpy
    return FleetAssessment(
        node_ids=ref.node_ids,
        slowdown=t(ref.slowdown.astype(np.float32)), stalled=t(ref.stalled),
        step_deviant=t(ref.step_deviant),
        support_masks={m: t(v) for m, v in ref.support_masks.items()},
        flagged=t(ref.flagged))


def _frame(pkg_frame):
    return pkg_frame(t=0.0, step=0, node_ids=np.arange(N, dtype=np.int64),
                     metrics={"step_time": np.full(N, 10.0)},
                     valid=np.ones(N, bool))


def _comp(i=None, v=11.0):
    x = np.full(N, 8.0)
    if i is not None:
        x[i] = v
    return x


_STALL_G0 = np.where(np.arange(N) < 8, 3.0, 0.0)
_STALL_G0[3] = 0.0
_BURST = np.full(N, 2.0)
_BURST[5] = 6.0

# name -> (windows of (compute, comm, host, stall), flagged, support)
_CASES = {
    "compute_culprit": ([(_comp(3), 0.6, 1.4, None)] * 4, [3], None),
    "sustained_comm": ([(_comp(), np.where(np.arange(N) == 5, 4.5, 2.0),
                         1.4, None)] * 4, [5], None),
    "transient_comm": ([(_comp(), _BURST, 1.4, None)] * 2 +
                       [(_comp(), 2.0, 1.4, None)] * 2, [5], None),
    "cascade_victims": ([(_comp(3), 0.6, 1.4, _STALL_G0)] * 4,
                        list(range(8)), None),
    "data_stall": ([(_comp(), 0.6, np.where(np.arange(N) == 7, 4.0, 1.4),
                     None)] * 4, [7], None),
    "presymptomatic_gpu": ([(_comp(), 0.6, 1.4, None)] * 4, [9],
                           {"gpu_temp": [9], "gpu_freq": [9]}),
    "presymptomatic_nic": ([(_comp(), 0.6, 1.4, None)] * 4, [2, 9],
                           {"nic_tx_rate": [9, 2], "nic_up": [9],
                            "gpu_power": [2]}),
    "fabric_wide_comm": ([(_comp(), np.where(np.arange(N) < 6, 4.0, 2.0),
                           1.4, None)] * 4, [0, 1, 2], None),
    "too_few_windows": ([(_comp(3), 0.6, 1.4, None)], [3], None),
    "nothing_flagged": ([(_comp(3), 0.6, 1.4, None)] * 4, [], None),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_rootcause_cases_match_reference(case):
    windows, flagged, support = _CASES[case]
    out = []
    for pkg, frame_cls, assess, act, dec in (
            (rd, RefFrame, _assess_ref, RefAction, RefDecision),
            (td, Frame, _assess_port, Action, Decision)):
        trace = pkg.TimingTrace(depth=4)
        diag = pkg.Diagnoser(trace, pkg.Topology.grouped(N, 8),
                             cfg=pkg.RootCauseConfig())
        for w, (c, m, h, s) in enumerate(windows):
            trace.push(wt(pkg, range(N), c, np.broadcast_to(m, (N,)),
                          np.broadcast_to(h, (N,)), s, t=60.0 * w))
        fr, fa = _frame(frame_cls), assess(flagged, support)
        d1 = diag.diagnose(fr, fa)
        d2 = diag.diagnose(fr, assess(flagged, support))   # steady state
        reroutes = None if d1 is None else [
            (r.node_id, r.action.value, r.reason, r.slowdown)
            for r in (d1.reroute(dec(i, act.IMMEDIATE_RESTART, "severe",
                                     0.3)) for i in range(N))]
        out.append((fleet_dict(d1), fleet_dict(d2), reroutes,
                    diagnoser_dict(diag, range(N))))
    assert out[1] == out[0]


# --------------------------------------- recorded simcluster windows


def _record(windows=150, seed=5):
    """Frames and timing rows of the reference cluster under three
    scenarios, 64 nodes in DP groups of 16."""
    topo = rd.Topology.grouped(64, 16)
    c = rs.SimCluster(n_active=64, n_spare=4, rates=QUIET, topology=topo,
                      seed=seed,
                      workload=rs.WorkloadProfile(compute_s=6.0,
                                                  comm_exposed_s=2.5,
                                                  host_s=1.5))
    trace = rd.TimingTrace(depth=8)
    c.attach_timing(trace)
    rs.arm_all([rs.RackThermal(at_h=0.3, rack_size=8, rack_start=24,
                               severity=0.85, power_fraction=0.0),
                rs.SwitchFailure(at_h=0.6, group_size=16, group_start=40,
                                 down_fraction=0.25, severity=0.9),
                rs.CongestionStorm(at_h=0.9, duration_h=0.5,
                                   hit_fraction=0.25, severity=0.7)],
               c, np.random.RandomState(seed))
    frames, timings = [], []
    for _ in range(windows):
        c.run_window()
        frames.append(c.collect())
        timings.append(trace.last())
    return topo, frames, timings


@pytest.fixture(scope="module")
def recorded():
    return _record()


@pytest.mark.parametrize("start,lanes", [
    (0, {"compute_degraded", "comm_degraded", "cascade_victim",
         "undiagnosed"}),
    (70, {"compute_degraded", "comm_degraded"})])
def test_diagnoser_on_recorded_windows_matches_reference(recorded, start,
                                                         lanes):
    topo, frames, timings = recorded
    ref_det = RefDetector(RefDetectorConfig())
    ref_trace = rd.TimingTrace(depth=8)
    for f, w in zip(frames[:start], timings[:start]):
        ref_det.update(f)
        ref_trace.push(w)
    # both sides start here: the port's detector and trace carry the
    # reference's state over, and each side gets a fresh diagnoser
    port_det = StragglerDetector(DetectorConfig(device="cpu"))
    if start:
        convert.load_detector_state(
            port_det, convert.detector_state_to_numpy(ref_det))
    port_trace = convert.timing_trace(ref_trace)
    ref_diag = rd.Diagnoser(ref_trace, topo)
    port_diag = td.Diagnoser(port_trace, convert.topology(topo))
    causes = set()
    for f, w in zip(frames[start:], timings[start:]):
        ref_trace.push(w)
        port_trace.push(port_wt(w))
        pf = Frame(t=f.t, step=f.step, node_ids=f.node_ids,
                   metrics=f.metrics, valid=f.valid)
        a = ref_diag.diagnose(f, ref_det.update(f))
        b = port_diag.diagnose(pf, port_det.update(pf))
        assert fleet_dict(b) == fleet_dict(a), f"window at t={f.t}"
        if a is not None:
            causes |= {r.root_cause.value for r in a.records.values()}
    assert diagnoser_dict(port_diag, frames[-1].node_ids) == \
        diagnoser_dict(ref_diag, frames[-1].node_ids)
    assert causes == lanes                 # the lanes the stream reaches


def test_record_hang_matches_reference():
    out = []
    for pkg, ccl in ((rd, rc), (td, tc)):
        diag = pkg.Diagnoser(pkg.TimingTrace(), pkg.Topology.single(8))
        wd = ccl.HangWatchdog(cfg=ccl.WatchdogConfig(default_deadline_s=60))
        entered = np.array([True, False] + [True] * 6)
        p = ccl.PendingCollective(
            t_start=0.0, step=3, op="all_reduce",
            node_ids=np.arange(8, dtype=np.int64),
            group_of=np.repeat(np.arange(2, dtype=np.int64), 4),
            entered=entered, enter_t=np.where(entered, 1.0, np.inf),
            completed=np.zeros(8, bool),
            nic_suspect=np.array([False] * 5 + [True, False, False]))
        recs = [diag_dict(r) for v in wd.check(p, now=100.0)
                for r in diag.record_hang(v, t=100.0, step=3)]
        out.append((recs, diagnoser_dict(diag, range(8))))
    assert out[1] == out[0]
    assert {r["root_cause"] for r in out[0][0]} == {"hang_culprit",
                                                    "hang_victim"}


# ------------------------------------- host copies, not device tensors


class _DeviceOnly:
    """Stands in for a device tensor: any read fails the test."""

    def __getattr__(self, name):
        raise AssertionError(f"diagnose read a device tensor ({name})")

    def __getitem__(self, key):
        raise AssertionError("diagnose indexed a device tensor")


def test_diagnosed_window_copies_flagged_rows_once(recorded, monkeypatch):
    topo, frames, timings = recorded
    builds = []
    build = FleetAssessment._flagged_host

    def counting(self):
        if self._host is None:
            builds.append(id(self))
        return build(self)

    monkeypatch.setattr(FleetAssessment, "_flagged_host", counting)
    det = StragglerDetector(DetectorConfig(device="cpu"))
    trace = td.TimingTrace(depth=8)
    diag = td.Diagnoser(trace, convert.topology(topo))
    diagnosed = 0
    for f, w in zip(frames, timings):
        trace.push(port_wt(w))
        pf = Frame(t=f.t, step=f.step, node_ids=f.node_ids,
                   metrics=f.metrics, valid=f.valid)
        fleet = det.update(pf)
        builds.clear()
        expect = diag.diagnose(pf, fleet)
        assert len(builds) == 1            # one gather, one transfer
        if expect is None:
            continue
        # the same window's host copy behind unreadable device tensors,
        # through a fresh diagnoser on a copy of the trace
        blind = FleetAssessment(
            node_ids=fleet.node_ids, slowdown=_DeviceOnly(),
            stalled=_DeviceOnly(), step_deviant=_DeviceOnly(),
            support_masks={m: _DeviceOnly() for m in fleet.support_masks},
            flagged=_DeviceOnly())
        blind._host = fleet._host
        got = td.Diagnoser(convert.timing_trace(trace),
                           convert.topology(topo)).diagnose(pf, blind)
        assert fleet_dict(got)["arrays"] == fleet_dict(expect)["arrays"]
        assert {n: r.root_cause for n, r in got.records.items()} == \
            {n: r.root_cause for n, r in expect.records.items()}
        diagnosed += 1
    assert diagnosed > 10
