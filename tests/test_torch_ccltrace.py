"""Parity of the port's ``ccltrace`` with the JAX package's.

The span ring, the adaptive-deadline rule and the watchdog's CCL-D
decision table get the same inputs in both packages, and so does each
``SimCluster``'s hang surface; the end-to-end hang runs of
``tests/test_ccltrace.py`` run through both ``simulate_run``s (the port's
detector on the CPU). Everything is exact: both sides run the same NumPy
arithmetic, and the fleet_score kernel's plain version is bit-identical
to the reference's scorer.
"""
import dataclasses

import numpy as np
import pytest

import repro.ccltrace as rc
import repro.simcluster as rs
import repro_torch.ccltrace as tc
import repro_torch.simcluster as ts
from repro.guard import GuardStepHook as RefHook
from repro_torch import convert
from repro_torch.guard import GuardStepHook

QUIET = rs.FaultRates(thermal=0, power=0, mem_ecc=0, nic_down=0,
                      nic_degraded=0, host_cpu=0, congestion=0, fail_stop=0,
                      admission_grey_p=0)


def span(pkg, step, n=4, enter=1.0, exit_=2.0, ids=None, groups=None):
    ids = np.arange(n, dtype=np.int64) if ids is None else ids
    groups = np.zeros(n, np.int64) if groups is None else groups
    return pkg.SpanWindow(t=60.0 * step, step=step, op="all_reduce",
                          node_ids=ids, group_of=groups,
                          enter=np.full(n, float(enter)),
                          exit=np.full(n, float(exit_)))


def pending(pkg, n=4, entered=None, suspect=None, groups=None,
            completed=None, t_start=0.0):
    entered = np.ones(n, bool) if entered is None else entered
    suspect = np.zeros(n, bool) if suspect is None else suspect
    groups = np.zeros(n, np.int64) if groups is None else groups
    completed = np.zeros(n, bool) if completed is None else completed
    return pkg.PendingCollective(
        t_start=t_start, step=10, op="all_reduce",
        node_ids=np.arange(n, dtype=np.int64), group_of=groups,
        entered=entered,
        enter_t=np.where(entered, t_start + 1.0, np.inf),
        completed=completed, nic_suspect=suspect)


def verdict_dict(v):
    d = dataclasses.asdict(v)
    d["roles"] = {int(k): r.value for k, r in v.roles.items()}
    return d


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


# --------------------------------------------------------------- spans


def _span_history(pkg):
    """Rotation past depth, a same-size swap, then a resize."""
    tr = pkg.CollectiveSpanTrace(depth=3)
    snaps = []
    for s in range(5):
        tr.push(span(pkg, s, enter=1.0 + 0.1 * s, exit_=2.0 + s))
        snaps.append(tr.trailing_duration().copy())
    ids = np.arange(4, dtype=np.int64)
    ids[2] = 99
    tr.push(span(pkg, 5, enter=1.0, exit_=8.0, ids=ids,
                 groups=np.array([0, 0, 1, 1])))
    snaps.append(tr.duration_rows().copy())
    snaps.append(tr.node_ids.copy())
    snaps.append(tr.group_of.copy())
    tr.push(span(pkg, 6, n=6))
    snaps.append(tr.rows("exit").copy())
    return snaps, (len(tr), tr.full, tr.generation, tr.node_count,
                   tr.last().step)


def test_span_trace_matches_reference():
    ref, port = _span_history(rc), _span_history(tc)
    assert port[1] == ref[1]
    for a, b in zip(ref[0], port[0]):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("trailing,mult,floor,cap", [
    (10.0, 8.0, 30.0, 600.0), (1.0, 8.0, 30.0, 600.0),
    (500.0, 8.0, 30.0, 600.0), (0.37, 3.5, 0.1, 2.0)])
def test_adaptive_deadline_matches_reference(trailing, mult, floor, cap):
    assert tc.adaptive_deadline(trailing, mult, floor, cap) == \
        rc.adaptive_deadline(trailing, mult, floor, cap)


# ------------------------------------------------------ decision table

_CASES = {
    "never_entered": dict(entered=np.array([True, False, True, True])),
    "stalled_with_link_evidence": dict(
        suspect=np.array([False, False, True, False])),
    "no_evidence": dict(),
    "completed_group_excluded": dict(
        groups=np.array([0, 0, 1, 1], np.int64),
        entered=np.array([True, False, True, True]),
        completed=np.array([False, False, True, True])),
    "two_groups_hung": dict(
        n=8, groups=np.repeat(np.arange(2, dtype=np.int64), 4),
        entered=np.array([True, True, False, True] + [True] * 4),
        suspect=np.array([False] * 6 + [True, False])),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("history", [0, 1, 3])
def test_watchdog_verdicts_match_reference(case, history):
    """Each case polled under, at and past its deadline, and again after
    firing, with a cold (fallback) or warm (adaptive) span trace."""
    out = []
    for pkg in (rc, tc):
        kw = _CASES[case]
        n = kw.get("n", 4)
        tr = pkg.CollectiveSpanTrace(depth=4)
        for s in range(history):
            tr.push(span(pkg, s, n=n, enter=1.0, exit_=4.0 + 3.0 * s))
        wd = pkg.HangWatchdog(tr, pkg.WatchdogConfig(
            default_deadline_s=60.0, deadline_floor_s=20.0))
        p = pending(pkg, **kw)
        polls = [[verdict_dict(v) for v in wd.check(p, now=now)]
                 for now in (-1.0, 10.0, 30.0, 60.0, 100.0, 200.0)]
        polls.append([verdict_dict(v) for v in wd.check(
            pending(pkg, t_start=500.0, **kw), now=700.0)])
        polls.append(wd.check(None, now=800.0))
        out.append((polls, [verdict_dict(v) for v in wd.verdicts]))
    assert out[1] == out[0]
    assert any(out[0][0])                  # something fired


# --------------------------------------------------- sim hang surface


@pytest.mark.parametrize("inject", [
    [("COLLECTIVE_HANG", 3, -1, 1.0)],
    [("COLLECTIVE_HANG", 4, 1, 1.0)],
    [("NIC_BROWNOUT", 2, 0, 0.9), ("NIC_BROWNOUT", 5, 0, 0.2)],
    [("COLLECTIVE_HANG", 1, -1, 1.0), ("NIC_DOWN", 6, 2, 1.0)]])
def test_hang_surface_matches_reference(inject):
    """Spans fed from a few clean windows, then the injected wedge: the
    window record, the pending snapshot and the probes agree."""
    out = []
    for pkg, ccl, rates in ((rs, rc, QUIET),
                            (ts, tc, convert.fault_rates(QUIET))):
        c = pkg.SimCluster(n_active=8, n_spare=2, rates=rates, seed=4)
        tr = ccl.CollectiveSpanTrace(depth=4)
        c.attach_spans(tr)
        for _ in range(3):
            c.run_window(6)
            c.collect()
        for kind, node, dev, sev in inject:
            c.injector.inject(pkg.FaultKind[kind], node, device=dev,
                              severity=sev)
        win = c.run_window(6)
        pend = c.hang_pending()
        out.append((
            {k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in win.items()},
            None if pend is None else {
                k: (v.tolist() if isinstance(v, np.ndarray) else v)
                for k, v in dataclasses.asdict(pend).items()},
            c.fleet.hang_phase.tolist(),
            c.batch_compute_probe([1, 2, 3, 4], 1.0).tolist(),
            tr.duration_rows().tolist()))
    assert out[1] == out[0]


# ---------------------------------------------------------- end to end

_E2E = {
    "deadlock": (rs.DeadlockedCollective(at_h=0.5, count=1), True, 3.0),
    "brownout": (rs.PartialNicBrownout(at_h=0.5, group_size=4), True, 3.0),
    "cascade": (rs.StragglerTimeoutCascade(at_h=0.5, count=1, lag_h=0.02),
                True, 3.0),
    "no_watchdog": (rs.DeadlockedCollective(at_h=0.5, count=1), False, 3.0),
}


@pytest.mark.parametrize("name", sorted(_E2E))
def test_end_to_end_hang_runs_match_reference(name):
    scen, watchdog, hours = _E2E[name]
    cfg = rs.RunConfig(tier=rs.Tier.ENHANCED, n_nodes=32, n_spare=6,
                       duration_h=hours, dp_group_size=8, diagnose=True,
                       hang_watchdog=watchdog, initial_grey_p=0.0,
                       rates=QUIET, scenarios=(scen,), seed=11)
    ref = rs.simulate_run(cfg)
    port = ts.simulate_run(convert.run_config(cfg, device="cpu"))
    assert_same_run(ref, port)
    hangs = [e for e in port.events if e["kind"] == "hang"]
    if watchdog:
        assert hangs and any(e["culprits"] for e in hangs)
        held = [e for e in port.events if e["kind"] == "diagnosis"
                and e["root_cause"] == "hang_victim"]
        assert all(e["held"] for e in held)
    else:
        assert not hangs
        assert any("CCL timeout" in e["reason"] for e in port.events
                   if e["kind"] == "restart")


# ------------------------------------------------------ hook liveness


def test_hook_liveness_matches_reference():
    """The hook's step deadline comes from ccltrace's rule in both
    packages: same deadlines, same firing, same HangDetected."""
    out = []
    for mk in (lambda **kw: RefHook(**kw),
               lambda **kw: GuardStepHook(device="cpu", **kw)):
        seq = []
        for floor in (None, 30.0, 100.0):
            h = mk(node_id=0, n_peers=7, window_steps=3, warmup_windows=0,
                   step_deadline_s=floor)
            seq.append(h.step_deadline())
            for s in range(6):
                h(s, 10.0 + 0.5 * s, {})
            seq.append(h.step_deadline())
            seq.append(h.check_liveness())
            h.control.t += 99.0
            seq.append(h.check_liveness())
            h.control.t += 300.0
            seq.append(h.check_liveness())
            seq.append(h.check_liveness())
            seq.append([e.to_dict() for e in h.session.trace.of_kind("hang")])
        out.append(seq)
    assert out[1] == out[0]
