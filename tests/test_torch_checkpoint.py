"""The port's checkpoint managers: the twins of ``tests/test_train.py``'s
checkpoint tests and of ``tests/test_checkpoint_tiers.py``, on torch
state and on numpy state.

Covers the recovery contract: round trip and retention, torn writes never
visible, a re-save of a step after a rewind, a writer failure surfacing
at ``wait``, PEER → LOCAL → COLD selection, bit-identical tiers, and the
Young–Daly cadence (values held to the reference's ``young_daly_interval``
exactly). Restores give back what went in, bit for bit.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

from repro.guard.goodput import RecoveryModel as JaxRecoveryModel
from repro.guard.goodput import young_daly_interval as jax_young_daly
from repro_torch.guard.goodput import (CheckpointTier, RecoveryModel,
                                       young_daly_interval)
from repro_torch.train import CheckpointManager, TieredCheckpointManager


def tree(scale: float):
    """A small (params, opt) pair of numpy state; ``scale`` tells versions
    apart."""
    params = {"w": np.full((4, 3), scale), "b": np.arange(3.0) * scale}
    opt = {"mu": {"w": np.zeros((4, 3)), "b": np.zeros(3)},
           "count": np.asarray(int(scale))}
    return params, opt


def torch_tree(scale: float):
    """The same as the port's trainer holds it: tensors keyed by parameter
    name, float32 moments, a 0-d int32 count."""
    params = {"layers.0.attn.wq": torch.full((4, 3), scale),
              "ln_f": torch.arange(3.0) * scale}
    opt = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
           "nu": {k: torch.full_like(v, scale) for k, v in params.items()},
           "count": torch.tensor(int(scale), dtype=torch.int32)}
    return params, opt


def assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            assert_tree_equal(a[k], b[k])
        else:
            x, y = a[k], b[k]
            assert type(x) is type(y)
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y)
            else:
                np.testing.assert_array_equal(x, y)


class TestCheckpoint:
    @pytest.mark.parametrize("make", [tree, torch_tree])
    def test_roundtrip_and_retention(self, make):
        params, opt = make(3.0)
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, keep=2, async_save=False)
            for s in (10, 20, 30):
                mgr.save(s, params, opt)
            assert mgr.all_steps() == [20, 30]     # retention
            p2, o2, step = mgr.restore(*make(0.0))
            assert step == 30
            assert_tree_equal(p2, params)
            assert_tree_equal(o2, opt)

    def test_atomicity_tmp_never_visible(self):
        params, opt = torch_tree(1.0)
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, async_save=True)
            mgr.save(5, params, opt)
            mgr.wait()
            assert all(not n.startswith(".tmp") for n in os.listdir(d))

    def test_async_save_is_a_snapshot_of_the_call(self):
        # the state is copied to the host before the writer starts: an
        # in-place update right after save() cannot reach the checkpoint
        params, opt = torch_tree(1.0)
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, async_save=True)
            mgr.save(5, params, opt)
            params["ln_f"].fill_(-7.0)
            opt["count"].fill_(99)
            mgr.wait()
            p2, o2, _ = mgr.restore(*torch_tree(0.0))
            assert_tree_equal(p2, torch_tree(1.0)[0])
            assert int(o2["count"]) == 1

    def test_restore_keeps_template_dtype(self):
        params, opt = torch_tree(2.0)
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, async_save=False)
            mgr.save(1, params, opt)
            _, o2, _ = mgr.restore(params, opt)
            assert o2["count"].dtype == torch.int32


class TestWaitRaceRegression:
    def test_resave_same_step_after_rewind_lands(self):
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, async_save=True)
            p1, o1 = torch_tree(1.0)
            mgr.save(10, p1, o1)
            mgr.wait()
            p2, o2 = torch_tree(2.0)      # the job replays and re-saves 10
            mgr.save(10, p2, o2)
            mgr.wait()
            out = mgr.restore(p1, o1)
            assert out is not None and out[2] == 10
            assert_tree_equal(out[0], p2)

    def test_writer_failure_surfaces_at_wait(self, monkeypatch):
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, async_save=True)

            def boom(step, seq, flat, manifest):
                raise OSError("disk full")

            monkeypatch.setattr(mgr, "_write", boom)
            p, o = tree(1.0)
            mgr.save(5, p, o)
            with pytest.raises(RuntimeError, match=r"checkpoint write failed"
                                                   r" \(step 5, seq 1\)"):
                mgr.wait()
            mgr.wait()                   # the error is consumed

    def test_restore_mid_flight_never_loads_torn_checkpoint(self):
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, async_save=False)
            p1, o1 = tree(1.0)
            mgr.save(10, p1, o1)
            torn = os.path.join(d, "ckpt-00000020")
            os.makedirs(torn)
            with open(os.path.join(torn, "manifest.json"), "w") as f:
                f.write("{}")
            assert mgr.latest_step() == 10
            out = mgr.restore(p1, o1)
            assert out is not None and out[2] == 10
            assert_tree_equal(out[0], p1)

    def test_tmp_debris_cleaned_on_init(self):
        with tempfile.TemporaryDirectory() as d:
            os.makedirs(os.path.join(d, ".tmp-5-1"))
            os.makedirs(os.path.join(d, ".old-5-1"))
            CheckpointManager(d)
            assert not any(n.startswith((".tmp", ".old"))
                           for n in os.listdir(d))


class TestTierSelection:
    def test_peer_then_local_then_cold(self):
        with tempfile.TemporaryDirectory() as d:
            mgr = TieredCheckpointManager(d, async_save=False, dp_size=8,
                                          fast_interval_s=0.0)
            p, o = torch_tree(3.0)
            mgr.save(10, p, o)           # durable
            mgr.save_fast(12, p, o)      # peer + local
            out = mgr.restore_any(p, o)
            assert out[2] == 12 and out[3] is CheckpointTier.PEER
            mgr.drop_peer()
            out = mgr.restore_any(p, o)
            assert out[2] == 12 and out[3] is CheckpointTier.LOCAL
            mgr.drop_local()
            out = mgr.restore_any(p, o)
            assert out[2] == 10 and out[3] is CheckpointTier.COLD

    @pytest.mark.parametrize("make", [tree, torch_tree])
    def test_all_tiers_bit_identical(self, make):
        with tempfile.TemporaryDirectory() as d:
            mgr = TieredCheckpointManager(d, async_save=False, dp_size=4,
                                          fast_interval_s=0.0)
            p, o = make(7.0)
            mgr.save(20, p, o)
            mgr.save_fast(20, p, o)
            peer = mgr.restore_any(p, o, step=20)
            assert peer[3] is CheckpointTier.PEER
            mgr.drop_peer()
            local = mgr.restore_any(p, o, step=20)
            assert local[3] is CheckpointTier.LOCAL
            mgr.drop_local()
            cold = mgr.restore_any(p, o, step=20)
            assert cold[3] is CheckpointTier.COLD
            for fast in (peer, local):
                assert_tree_equal(fast[0], cold[0])
                assert_tree_equal(fast[1], cold[1])
            assert_tree_equal(cold[0], p)

    def test_peer_replica_is_a_copy(self):
        with tempfile.TemporaryDirectory() as d:
            mgr = TieredCheckpointManager(d, async_save=False,
                                          fast_interval_s=0.0)
            p, o = torch_tree(1.0)
            mgr.save_fast(3, p, o)
            p["layers.0.attn.wq"][:] = -99.0
            out = mgr.restore_any(torch_tree(0.0)[0], o)
            assert torch.equal(out[0]["layers.0.attn.wq"],
                               torch.full((4, 3), 1.0))

    def test_replica_partner_metadata(self):
        with tempfile.TemporaryDirectory() as d:
            assert TieredCheckpointManager(d, node_id=4,
                                           dp_size=8).peer_rank == 5
            assert TieredCheckpointManager(d, node_id=5,
                                           dp_size=8).peer_rank == 4
            # no dp_size: the port has no mesh, so one replica slot
            assert TieredCheckpointManager(d, node_id=5).dp_size == 1


class TestCadence:
    def test_young_daly_tuning_reacts_to_mttf(self):
        with tempfile.TemporaryDirectory() as d:
            mgr = TieredCheckpointManager(d)
            long = mgr.update_mttf(100 * 3600.0)
            short = mgr.update_mttf(0.5 * 3600.0)
            assert short < long
            rm = RecoveryModel()
            assert rm.min_interval_s <= short <= rm.max_interval_s
            assert mgr.update_mttf(1.0) == rm.min_interval_s
            assert mgr.update_mttf(1e9) == rm.max_interval_s
            jrm = JaxRecoveryModel()
            for mttf in (1.0, 600.0, 0.5 * 3600.0, 100 * 3600.0):
                assert mgr.update_mttf(mttf) == jax_young_daly(
                    mttf, jrm.snapshot_cost_s, jrm.min_interval_s,
                    jrm.max_interval_s) == young_daly_interval(
                    mttf, rm.snapshot_cost_s, rm.min_interval_s,
                    rm.max_interval_s)

    def test_fixed_interval_not_retuned(self):
        with tempfile.TemporaryDirectory() as d:
            mgr = TieredCheckpointManager(d, fast_interval_s=42.0)
            assert mgr.update_mttf(1.0) == 42.0
            assert mgr.fast_interval_s == 42.0

    def test_on_step_honors_interval(self):
        with tempfile.TemporaryDirectory() as d:
            mgr = TieredCheckpointManager(d, fast_interval_s=100.0)
            p, o = torch_tree(1.0)
            assert mgr.on_step(1, p, o, now=0.0)       # first is free
            assert not mgr.on_step(2, p, o, now=50.0)  # not due yet
            assert mgr.on_step(3, p, o, now=150.0)
            assert mgr.snapshots_taken == 2
            assert mgr.peer_step() == 3
            assert mgr.local_steps() == [1, 3]
