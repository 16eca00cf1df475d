"""Parity of the port's fleet control plane with the JAX package's.

Every scenario runs once through ``repro.fleet`` and once through
``repro_torch.fleet`` (the port's detectors on the CPU) and the two are
compared exactly (atol 0): the event taxonomy (names, kinds, fields), the
scripted pool sequences of ``tests/test_fleet.py`` (grants, leases,
statistics and census), the controller and healthscan scenarios (every
fleet-log record, the census and the per-job counters), the event log's
cursor replay and framing, a hypothesis twin of the pool-contention
property of ``tests/test_properties.py`` and ``simulate_fleet`` on
``tests/test_fleet.py``'s two-job mix and on ``benchmarks/bench_fleet.py``'s
quick mix. A ``FleetRunResult`` must equal the reference's in every field
but the three wall-clock ones (``overhead_s``, ``wall_s``,
``overhead_frac``, which time the host), and the fleet JSONL, written
through ``JsonlStreamSink``, must equal it line for line.
"""
import dataclasses
import io

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.fleet as rf
import repro.simcluster as rs
import repro_torch.fleet as tf
import repro_torch.simcluster as ts
from repro.guard.events import NodeSwapped as RefNodeSwapped
from repro.guard.session import GuardSession as RefSession
from repro.guard.session import Tier as RefTier
from repro_torch import convert
from repro_torch.guard.events import NodeSwapped
from repro_torch.guard.session import GuardSession, Tier

WALL_FIELDS = {"overhead_s", "wall_s", "overhead_frac"}


class Pkg:
    """One package's fleet API, so that a scenario is written once."""

    def __init__(self, port: bool):
        self.port = port
        self.fleet = tf if port else rf
        self.sim = ts if port else rs
        self.NodeSwapped = NodeSwapped if port else RefNodeSwapped
        self.quiet = self.sim.FaultRates(
            thermal=0, power=0, mem_ecc=0, nic_down=0, nic_degraded=0,
            host_cpu=0, congestion=0, fail_stop=0, admission_grey_p=0)

    def session(self, tier, cluster):
        if self.port:
            return GuardSession.from_tier(Tier(int(tier)), cluster, cluster,
                                          device="cpu")
        return RefSession.from_tier(RefTier(int(tier)), cluster, cluster)

    def make_job(self, ctl, name, tier=4, n=32, n_spare=4, seed=0,
                 priority=None):
        c = self.sim.SimCluster(n, n_spare=n_spare, rates=self.quiet,
                                seed=seed)
        s = self.session(tier, c)
        s.register_active(c.active)
        s.register_spares(c.spares)
        ctl.register_job(name, s, priority=priority)
        return c, s


PKGS = (Pkg(False), Pkg(True))


def log_records(ctl):
    return [r.to_dict() for r in ctl.log.subscribe(after=0)[0]]


# ------------------------------------------------------------- taxonomy


def test_fleet_event_taxonomy_matches_reference():
    assert [c.__name__ for c in tf.FLEET_EVENT_TYPES] == \
        [c.__name__ for c in rf.FLEET_EVENT_TYPES]
    for port, ref in zip(tf.FLEET_EVENT_TYPES, rf.FLEET_EVENT_TYPES):
        assert port.kind == ref.kind
        assert [(f.name, f.default) for f in dataclasses.fields(port)] == \
            [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert sorted(tf.__all__) == sorted(rf.__all__)
    assert [k.name for k in tf.LeaseKind] == [k.name for k in rf.LeaseKind]
    assert [int(k) for k in tf.LeaseKind] == [int(k) for k in rf.LeaseKind]
    for s in ("swap", "crash", "hang", "other"):
        assert int(tf.LeaseKind.from_str(s)) == int(rf.LeaseKind.from_str(s))


# ----------------------------------------------------------------- pool


def pool_state(pool):
    st_ = pool.stats
    return {"census": pool.census(), "free": pool.free_ids(),
            "granted_to": dict(pool.granted_to), "jobs": list(pool.jobs),
            "stats": (st_.grants, st_.transfers, st_.provisions,
                      st_.starvation_events, st_.max_wait_s),
            "leases": sorted((k, dataclasses.asdict(v) | {
                "kind": int(v.kind)})
                for k, v in pool.open_leases().items())}


def lease_of(lease):
    if lease is None:
        return None
    return dataclasses.asdict(lease) | {"kind": int(lease.kind)}


def served_of(served):
    return [(r.job, int(r.kind), r.priority, r.seq, lease_of(r.lease))
            for r in served]


def home_vs_transfer(f):
    pool = f.GlobalSparePool()
    pool.add(1, home="a", now=0.0)
    pool.add(2, home="b", now=1.0)
    out = [lease_of(pool.grant("b", f.LeaseKind.SLOW_SWAP, now=2.0)),
           lease_of(pool.grant("b", f.LeaseKind.CRASH, now=3.0)),
           lease_of(pool.grant("c", f.LeaseKind.CRASH, now=4.0))]
    return out, pool


def namespaced_ids(f):
    pool = f.GlobalSparePool()
    pool.add(7, home="a", now=0.0)
    pool.add(7, home="b", now=0.0)
    with pytest.raises(AssertionError):
        pool.add(7, home="a", now=1.0)        # a true double give
    rec = pool.remove(7, home="b")
    return [pool.free_count(), pool.free_ids(home="a"),
            dataclasses.asdict(rec)], pool


def urgency_ladder(f):
    pool = f.GlobalSparePool()
    pool.request("a", f.LeaseKind.SLOW_SWAP, priority=4, now=0.0)
    pool.request("b", f.LeaseKind.HANG_EVICT, priority=3, now=0.0)
    pool.request("c", f.LeaseKind.CRASH, priority=3, now=0.0)
    for nid, home in [(1, "a"), (2, "b"), (3, "c")]:
        pool.add(nid, home=home, now=0.0)
    return served_of(pool.serve(now=1.0)), pool


def priority_ties(f):
    pool = f.GlobalSparePool()
    pool.request("low", f.LeaseKind.SLOW_SWAP, priority=3, now=0.0)
    pool.request("high", f.LeaseKind.SLOW_SWAP, priority=4, now=0.0)
    pool.request("high", f.LeaseKind.SLOW_SWAP, priority=4, now=0.5)
    pool.add(1, home="low", now=0.0)
    pool.add(2, home="high", now=0.0)
    return served_of(pool.serve(now=1.0)), pool


def fair_share_floor(f):
    pool = f.GlobalSparePool(floor_frac=0.5)
    pool.register_job("big")
    pool.register_job("small")
    for i in range(10):
        pool.add(100 + i, home="big", now=0.0)
        pool.grant("big", f.LeaseKind.SLOW_SWAP, now=0.0)
    pool.request("big", f.LeaseKind.HANG_EVICT, priority=4, now=0.0)
    pool.request("small", f.LeaseKind.SLOW_SWAP, priority=1, now=0.0)
    pool.add(1, home="small", now=0.0)
    return served_of(pool.serve(now=1.0)), pool


def starvation_bound(f):
    pool = f.GlobalSparePool(starvation_age_s=100.0)
    pool.request("old", f.LeaseKind.SLOW_SWAP, priority=1, now=0.0)
    pool.request("new", f.LeaseKind.HANG_EVICT, priority=4, now=190.0)
    pool.add(1, home="old", now=0.0)
    return served_of(pool.serve(now=200.0)), pool


def materialize(f):
    pool = f.GlobalSparePool()
    pool.request("a", f.LeaseKind.CRASH, priority=3, now=0.0)
    pool.request("b", f.LeaseKind.SLOW_SWAP, priority=1, now=0.0)
    pool.request("a", f.LeaseKind.HANG_EVICT, priority=1, now=0.5)
    fresh = iter([50, 51])
    served = pool.serve(now=1.0, materialize=lambda job: next(fresh, None))
    return [served_of(served), [(r.job, r.seq) for r in pool.pending()]], \
        pool


POOL_SCRIPTS = {f.__name__: f for f in (
    home_vs_transfer, namespaced_ids, urgency_ladder, priority_ties,
    fair_share_floor, starvation_bound, materialize)}


@pytest.mark.parametrize("name", sorted(POOL_SCRIPTS))
def test_pool_script_matches_reference(name):
    (ref_out, ref_pool), (out, pool) = (POOL_SCRIPTS[name](p.fleet)
                                        for p in PKGS)
    assert out == ref_out
    assert pool_state(pool) == pool_state(ref_pool)


# ----------------------------------------------------------- controller


def registration(p):
    ctl = p.fleet.FleetController(bench_slots=2)
    c, s = p.make_job(ctl, "a", n=16, n_spare=3)
    assert s.manager.spares == [] and s.scheduler.bench is ctl.bench
    return ctl, [ctl.pool.free_count(home="a")]


def take_spare(p):
    ctl = p.fleet.FleetController(bench_slots=2)
    c, s = p.make_job(ctl, "a", n=16, n_spare=2)
    nid = s.take_spare(kind="crash")
    return ctl, [nid, s.manager.state[nid].value]


def transfer(p):
    ctl = p.fleet.FleetController(bench_slots=2)
    p.make_job(ctl, "a", n=16, n_spare=0, seed=1)
    p.make_job(ctl, "b", n=16, n_spare=2, seed=2)
    nid = ctl.jobs["a"].session.take_spare()
    return ctl, [nid, list(ctl.ghosts), ctl.jobs["a"].transfer_grants]


def dry_pool(p):
    ctl = p.fleet.FleetController(bench_slots=2)
    p.make_job(ctl, "a", n=8, n_spare=0)
    nid = ctl.jobs["a"].session.take_spare()
    return ctl, [nid, ctl.jobs["a"].provision_grants]


def return_spare(p):
    ctl = p.fleet.FleetController(bench_slots=2)
    c, s = p.make_job(ctl, "a", n=16, n_spare=1)
    nid = s.take_spare()
    s.return_spare(nid)
    return ctl, [nid, nid in s.manager.state]


def top_up(p):
    ctl = p.fleet.FleetController(bench_slots=2)
    p.make_job(ctl, "a", n=8, n_spare=0, seed=1)
    p.make_job(ctl, "b", n=8, n_spare=0, seed=2)
    return ctl, [ctl.top_up(global_target=6, home_min=2)]


def requalify(p):
    ctl = p.fleet.FleetController(bench_slots=2)
    c, s = p.make_job(ctl, "a", n=16, n_spare=4)
    bad = c.active[0]
    s.replace_node(bad, reason="test eviction", step=0)
    s.scheduler.drain(c.t, step=0)
    return ctl, [bad in s.manager.state, [e.to_dict() for e in s.events()]]


def shared_bench(p):
    ctl = p.fleet.FleetController(bench_slots=1)
    c1, s1 = p.make_job(ctl, "a", n=16, n_spare=4, seed=1)
    c2, s2 = p.make_job(ctl, "b", n=16, n_spare=4, seed=2)
    s1.replace_node(c1.active[0], reason="evict", step=0)
    s2.replace_node(c2.active[0], reason="evict", step=0)
    s1.scheduler.advance(0.0)
    s2.scheduler.advance(0.0)
    busy = s1.scheduler.busy + s2.scheduler.busy
    s1.scheduler.drain(1e9)
    s2.scheduler.drain(1e9)
    return ctl, [busy, [e.to_dict() for e in s1.events() + s2.events()]]


def queued_requests(p):
    ctl = p.fleet.FleetController(bench_slots=2, starvation_age_s=50.0)
    p.make_job(ctl, "a", n=8, n_spare=1, seed=1, priority=1)
    p.make_job(ctl, "b", n=8, n_spare=0, seed=2, priority=4)
    reqs = [ctl.request_spare("b", "hang"), ctl.request_spare("a", "swap"),
            ctl.request_spare("b", "crash")]
    served = ctl.tick(100.0)
    return ctl, [served, [lease_of(r.lease) for r in reqs]]


def healthscan_campaign(p):
    ctl = p.fleet.FleetController(bench_slots=2, healthscan_period_s=100.0)
    c, s = p.make_job(ctl, "a", n=16, n_spare=4)
    c.advance_idle(150.0)
    ctl.tick()
    hs = ctl.healthscan
    return ctl, [hs.campaigns, hs.scanned, list(hs.failed)]


def healthscan_grey_spare(p):
    ctl = p.fleet.FleetController(bench_slots=2, healthscan_period_s=100.0)
    c, s = p.make_job(ctl, "a", n=16, n_spare=4)
    bad = ctl.pool.free_ids(home="a")[0]
    c.injector.inject(p.sim.FaultKind.THERMAL, bad, now=c.t, severity=0.9)
    c.advance_idle(150.0)
    ctl.tick()
    return ctl, [list(ctl.healthscan.failed), s.manager.state[bad].value,
                 ctl.pool.free_ids(home="a")]


def healthscan_busy_bench(p):
    ctl = p.fleet.FleetController(bench_slots=1, healthscan_period_s=100.0)
    c, s = p.make_job(ctl, "a", n=16, n_spare=4)
    ctl.bench.occupy(0.0, 1e6)
    c.advance_idle(150.0)
    ctl.tick()
    return ctl, [ctl.healthscan.campaigns]


def session_tap(p):
    ctl = p.fleet.FleetController(bench_slots=2)
    c, s = p.make_job(ctl, "a", n=16, n_spare=2)
    s.publish(p.NodeSwapped(t=0.0, step=0, old=0, new=1))
    return ctl, []


CONTROLLER_SCRIPTS = {f.__name__: f for f in (
    registration, take_spare, transfer, dry_pool, return_spare, top_up,
    requalify, shared_bench, queued_requests, healthscan_campaign,
    healthscan_grey_spare, healthscan_busy_bench, session_tap)}


def controller_state(ctl):
    jobs = {k: (j.priority, j.registered_t, j.inventory, j.leases,
                j.provision_grants, j.transfer_grants, j.provisions)
            for k, j in ctl.jobs.items()}
    return {"log": log_records(ctl), "census": ctl.census(), "jobs": jobs,
            "pool": pool_state(ctl.pool), "ghosts": list(ctl.ghosts),
            "starvation": ctl.starvation_events()}


@pytest.mark.parametrize("name", sorted(CONTROLLER_SCRIPTS))
def test_controller_script_matches_reference(name):
    (ref_ctl, ref_out), (ctl, out) = (CONTROLLER_SCRIPTS[name](p)
                                      for p in PKGS)
    assert out == ref_out
    assert controller_state(ctl) == controller_state(ref_ctl)
    assert ctl.census()["conserved"]
    assert ctl.overhead_s >= 0.0


# ------------------------------------------------------------ event log


@pytest.mark.parametrize("capacity,n,after,limit",
                         [(100, 10, 0, None), (100, 10, 7, None),
                          (5, 12, 2, None), (100, 10, 0, 4), (3, 3, 0, 2)])
def test_event_log_replay_matches_reference(capacity, n, after, limit):
    outs = []
    for p in PKGS:
        log = p.fleet.FleetEventLog(capacity=capacity)
        buf = io.StringIO()
        log.attach(p.fleet.SSEStreamSink(buf))
        for i in range(n):
            log.append(f"job{i % 2}", p.NodeSwapped(t=float(i), step=i,
                                                    old=i, new=i + 1))
        recs, lost = log.subscribe(after=after, limit=limit)
        outs.append(([r.to_dict() for r in recs], lost, log.head, log.tail,
                     len(log), buf.getvalue()))
    assert outs[1] == outs[0]


def test_jsonl_sink_writes_the_reference_lines(tmp_path):
    texts = []
    for p in PKGS:
        path = tmp_path / f"{p.port}.jsonl"
        log = p.fleet.FleetEventLog()
        with p.fleet.JsonlStreamSink(str(path)) as sink:
            log.attach(sink)
            log.append("a", p.fleet.SpareLeased(t=1.5, step=-1, node_id=3,
                                                job="a", lease_kind="hang",
                                                priority=4, wait_s=2.0))
            log.append("", p.fleet.CampaignScheduled(
                t=2.0, step=-1, job="b", nodes=(1, 2), start_t=2.0,
                finish_t=9.5))
        with pytest.raises(ValueError):
            sink.emit(log.subscribe()[0][0])
        texts.append(path.read_text())
    assert texts[1] == texts[0] and len(texts[0].splitlines()) == 2


# -------------------------------------------------- contention property


@given(st.integers(2, 4),                       # concurrent jobs
       st.lists(st.tuples(st.integers(0, 3),   # job index (mod n_jobs)
                          st.integers(0, 4)),  # op selector
                min_size=4, max_size=30),
       st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_pool_contention_invariants_and_parity(n_jobs, ops, seed):
    """The twin of tests/test_properties.py's pool-contention property on
    the port: the census is conserved after every operation, no home node
    is granted more often than it entered the pool, a tick serves every
    queued request; and the port's fleet log equals the reference's."""
    logs = []
    for p in PKGS:
        rng = np.random.RandomState(seed)
        ctl = p.fleet.FleetController(bench_slots=2, starvation_age_s=1e9)
        jobs = []
        for i in range(n_jobs):
            c = p.sim.SimCluster(8, n_spare=int(rng.randint(0, 4)),
                                 rates=p.quiet, seed=seed + i)
            s = p.session(3, c)
            s.register_active(c.active)
            s.register_spares(c.spares)
            ctl.register_job(f"j{i}", s, priority=int(rng.randint(1, 5)))
            jobs.append(s)
        kinds = ["swap", "crash", "hang"]
        held = [[] for _ in range(n_jobs)]
        requests = []
        t = 0.0
        for j_raw, op in ops:
            j = j_raw % n_jobs
            t += 1.0
            if op <= 2:
                held[j].append(jobs[j].take_spare(kind=kinds[op]))
            elif op == 3 and held[j]:
                jobs[j].return_spare(held[j].pop())
            else:
                requests.append(ctl.request_spare(f"j{j}", kinds[op % 3]))
            assert ctl.census()["conserved"]
        gives, grants = {}, {}
        for rec in ctl.log.subscribe(after=0)[0]:
            d = rec.event.to_dict()
            key = (rec.job, d.get("node_id"))
            if d["kind"] == "spare_reclaimed":
                gives[key] = gives.get(key, 0) + 1
            elif d["kind"] == "spare_leased" and not d["provisioned"] \
                    and not d["transfer"]:
                grants[key] = grants.get(key, 0) + 1
                assert grants[key] <= gives.get(key, 0), key
        ctl.tick(t + 1.0)
        assert all(r.served for r in requests)
        assert not ctl.pool.pending()
        assert ctl.census()["conserved"] and ctl.starvation_events() == 0
        logs.append((log_records(ctl), ctl.census()))
    assert logs[1] == logs[0]


# -------------------------------------------------------- simulate_fleet


class LoggedController:
    """Patches a package's ``FleetController`` so that the controller
    ``simulate_fleet`` builds writes its fleet log to ``path``."""

    def __init__(self, fleet_module, path):
        base = fleet_module.FleetController
        self.sinks = []
        sinks = self.sinks

        class Controller(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                sink = fleet_module.JsonlStreamSink(str(path))
                sinks.append(sink)
                self.log.attach(sink)

        self.cls = Controller

    def close(self):
        for s in self.sinks:
            s.close()


def two_job_mix():
    return rs.FleetRunConfig(
        jobs=(rs.FleetJobSpec("a", tier=rs.Tier.ENHANCED, n_nodes=32,
                              n_spare=2, seed=1),
              rs.FleetJobSpec("b", tier=rs.Tier.ONLINE, n_nodes=32,
                              n_spare=2, seed=2)),
        duration_h=3.0, spare_target=6, home_min=1,
        healthscan_period_s=3600.0, seed=5)


def quick_mix():
    from benchmarks.bench_fleet import fleet_config
    return fleet_config(True)


MIXES = {"two_jobs": two_job_mix, "bench_fleet_quick": quick_mix}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_simulate_fleet_matches_reference(mix, tmp_path, monkeypatch):
    cfg = MIXES[mix]()
    results, texts = [], []
    for p, run in ((PKGS[0], lambda: rs.simulate_fleet(cfg)),
                   (PKGS[1], lambda: ts.simulate_fleet(
                       convert.fleet_run_config(cfg, device="cpu")))):
        path = tmp_path / f"{p.port}.jsonl"
        logged = LoggedController(p.fleet, path)
        monkeypatch.setattr(p.fleet, "FleetController", logged.cls)
        results.append(run())
        logged.close()
        texts.append(path.read_text())
    ref, res = results
    for f in dataclasses.fields(ref):
        if f.name not in WALL_FIELDS:
            assert getattr(res, f.name) == getattr(ref, f.name), f.name
    assert texts[1].splitlines() == texts[0].splitlines()
    assert len(texts[0].splitlines()) == ref.events_logged > 0
    assert res.census_ok and res.starvation_events == 0
    assert res.wall_s > 0 and 0.0 <= res.overhead_frac < 1.0


def test_fleet_run_config_converts_every_field():
    cfg = quick_mix()
    got = convert.fleet_run_config(cfg, device="cpu")
    assert got.device == "cpu"
    for f in dataclasses.fields(cfg):
        want, have = getattr(cfg, f.name), getattr(got, f.name)
        if f.name == "jobs":
            assert [dataclasses.asdict(j) | {"tier": int(j.tier)}
                    for j in have] == \
                [dataclasses.asdict(j) | {"tier": int(j.tier)}
                 for j in want]
        elif dataclasses.is_dataclass(want):
            assert dataclasses.asdict(have) == dataclasses.asdict(want)
        else:
            assert have == want, f.name
    assert all(isinstance(j.tier, Tier) for j in got.jobs)


def test_simulate_fleet_defaults_to_the_card():
    assert ts.FleetRunConfig().device == "cuda"
