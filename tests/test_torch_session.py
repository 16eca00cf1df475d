"""Parity of the port's closed loop with the JAX package's.

Each package's ``GuardSession`` runs on its own reference ``SimCluster``
with the quickstart's seeds (32 active nodes, 4 spares, seed 0, quiet
rates, THERMAL 0.9 on node 5, NIC_DOWN on node 9, 600 steps). The
cluster serves as control plane, sweep backend and collector for both;
each reference ``Frame`` is handed to the port as the port's ``Frame``.
Both event streams go through a ``JsonlSink``: the two files must be
equal, and so must ``ManagerStats``. The event taxonomy is thereby pinned
class for class and ``kind`` for ``kind``.
"""
import dataclasses

from repro.guard import GuardSession as RefSession
from repro.guard import JsonlSink as RefSink
from repro.guard import Tier as RefTier
from repro.simcluster import FaultKind, FaultRates, SimCluster
from repro_torch.core import Frame
from repro_torch.guard import EVENT_TYPES, GuardSession, JsonlSink, Tier

QUIET = FaultRates(thermal=0, power=0, mem_ecc=0, nic_down=0,
                   nic_degraded=0, host_cpu=0, congestion=0, fail_stop=0,
                   admission_grey_p=0)


def run_quickstart(port: bool, path):
    cluster = SimCluster(n_active=32, n_spare=4, rates=QUIET, seed=0)
    if port:
        session = GuardSession.from_tier(Tier.ENHANCED, control=cluster,
                                         sweep_backend=cluster, device="cpu")
        sink = JsonlSink(str(path))
    else:
        session = RefSession.from_tier(RefTier.ENHANCED, control=cluster,
                                       sweep_backend=cluster)
        sink = RefSink(str(path))
    session.add_sink(sink)
    session.register_active(cluster.active)
    session.register_spares(cluster.spares)
    cluster.injector.inject(FaultKind.THERMAL, 5, severity=0.9)
    cluster.injector.inject(FaultKind.NIC_DOWN, 9, device=7)
    for step in range(1, 601):
        cluster.run_step()
        if step % cluster.window_steps == 0:
            f = cluster.collect()
            if f is not None:
                if port:
                    f = Frame(t=f.t, step=f.step, node_ids=f.node_ids,
                              metrics=f.metrics, valid=f.valid)
                session.observe(f)
        if step % 90 == 0:
            session.on_checkpoint()
        session.advance(cluster.t)
    session.scheduler.drain(cluster.t)
    sink.close()
    return session


def test_quickstart_event_stream_and_stats_match(tmp_path):
    ref = run_quickstart(False, tmp_path / "ref.jsonl")
    port = run_quickstart(True, tmp_path / "port.jsonl")
    a = (tmp_path / "ref.jsonl").read_text()
    b = (tmp_path / "port.jsonl").read_text()
    assert a == b
    kinds = {line.split('"kind": ')[1].split('"')[1]
             for line in a.splitlines()}
    # the loop really closed: detection, mitigation and qualification
    assert {"straggler_flagged", "swap", "quarantine", "sweep_start",
            "sweep_finish", "checkpoint"} <= kinds
    assert dataclasses.asdict(ref.stats) == dataclasses.asdict(port.stats)
    assert ref.node_state(5).value == port.node_state(5).value
    assert ref.node_state(9).value == port.node_state(9).value


def test_event_taxonomy_matches_reference():
    from repro.guard import EVENT_TYPES as REF_TYPES
    assert [c.__name__ for c in EVENT_TYPES] == \
        [c.__name__ for c in REF_TYPES]
    assert [c.kind for c in EVENT_TYPES] == [c.kind for c in REF_TYPES]
    for mine, theirs in zip(EVENT_TYPES, REF_TYPES):
        assert [f.name for f in dataclasses.fields(mine)] == \
            [f.name for f in dataclasses.fields(theirs)]
