"""Parity of the port's detector with the JAX package's.

The frame sequences of ``test_detector_golden`` (warmup, sustained
straggler, replacement backfill, stall, heartbeat loss, hardware-only
deviation, hysteresis, fleet resize, simulated fault churn, NaN sensor
rows) go through both detectors. ``flagged``, ``stalled``,
``step_deviant`` and ``support_masks`` must be array-equal and
``slowdown`` bit-identical, window by window. A state-carry case resumes
a port detector from a reference detector's state via ``convert``.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import DetectorConfig as RefConfig
from repro.core import StragglerDetector as RefDetector
from repro_torch import convert
from repro_torch.core import DetectorConfig, Frame, StragglerDetector
from test_detector_golden import (nan_sensor_sequence, scripted_sequence,
                                  simulated_sequence)

STRICT = dict(persistence=2, clear_windows=2, z_threshold=2.5)


def port_frame(f) -> Frame:
    return Frame(t=f.t, step=f.step, node_ids=f.node_ids.copy(),
                 metrics={k: v.copy() for k, v in f.metrics.items()},
                 valid=f.valid.copy())


def assert_same_window(a, b, w):
    """``a`` a reference FleetAssessment, ``b`` a port one."""
    h = b.numpy()
    np.testing.assert_array_equal(a.node_ids, h["node_ids"])
    for k in ("flagged", "stalled", "step_deviant"):
        np.testing.assert_array_equal(getattr(a, k), h[k],
                                      err_msg=f"{k} w={w}")
    np.testing.assert_array_equal(          # bit for bit
        a.slowdown.view(np.uint32), h["slowdown"].view(np.uint32),
        err_msg=f"slowdown w={w}")
    assert list(a.support_masks) == list(h["support_masks"])
    for m, msk in a.support_masks.items():
        np.testing.assert_array_equal(msk, h["support_masks"][m],
                                      err_msg=f"support[{m}] w={w}")
    # the host view the policy reads agrees with the arrays
    np.testing.assert_array_equal(b.flagged_indices(),
                                  np.flatnonzero(a.flagged))
    np.testing.assert_array_equal(b.flagged_slowdown(),
                                  a.slowdown[a.flagged])


def run_both(frames, cfg_kw=None, resets=(), carry_at=None):
    cfg_kw = cfg_kw or {}
    ref = RefDetector(RefConfig(**cfg_kw))
    port = StragglerDetector(DetectorConfig(device="cpu", **cfg_kw))
    resets = dict(resets)
    for w, frame in enumerate(frames):
        if w == carry_at:
            # the port picks up where the reference stopped
            port = StragglerDetector(DetectorConfig(device="cpu", **cfg_kw))
            convert.load_detector_state(
                port, convert.detector_state_to_numpy(ref))
        a = ref.update(copy.deepcopy(frame))
        b = port.update(port_frame(frame))
        assert_same_window(a, b, w)
        ids = set(int(n) for n in frame.node_ids) | set(ref._off)
        for nid in ids:
            assert port.is_latched(nid) == ref.is_latched(nid), (w, nid)
        assert port.latched_nodes() == ref.latched_nodes()
        if w in resets:
            ref.reset_node(resets[w])
            port.reset_node(resets[w])
    return ref, port


def test_scripted_sequence():
    run_both(scripted_sequence())


def test_scripted_sequence_strict_config():
    run_both(scripted_sequence(), STRICT)


def test_simulated_sequence():
    run_both(simulated_sequence())


def test_simulated_sequence_with_reset():
    run_both(simulated_sequence(), resets={13: 7})


def test_nan_sensor_rows():
    run_both(nan_sensor_sequence())


@pytest.mark.parametrize("carry_at", [4, 12, 31])
def test_state_carry_from_reference(carry_at):
    # 4: mid-straggler; 12: after a replacement backfill; 31: across resize
    run_both(scripted_sequence(), carry_at=carry_at)


def test_state_round_trip_through_numpy():
    frames = [port_frame(f) for f in simulated_sequence()]
    a = StragglerDetector(DetectorConfig(device="cpu"))
    for f in frames[:15]:
        a.update(copy.deepcopy(f))
    b = StragglerDetector(DetectorConfig(device="cpu"))
    convert.load_detector_state(b, convert.detector_state_to_numpy(a))
    for w, f in enumerate(frames[15:]):
        x, y = a.update(copy.deepcopy(f)), b.update(copy.deepcopy(f))
        for k, v in x.numpy().items():
            if k == "support_masks":
                for m in v:
                    np.testing.assert_array_equal(v[m],
                                                  y.numpy()[k][m])
            else:
                np.testing.assert_array_equal(v, y.numpy()[k],
                                              err_msg=f"{k} w={w}")


def test_config_conversion_is_duck_typed():
    ref = RefConfig(persistence=2, z_threshold=2.5, scorer="pallas")
    cfg = convert.detector_config(ref, device="cpu")
    assert cfg == DetectorConfig(persistence=2, z_threshold=2.5,
                                 device="cpu")
    from repro.core import PolicyConfig, SweepConfig, TriageConfig
    pc = convert.policy_config(PolicyConfig(severe_slowdown=0.3))
    assert pc.severe_slowdown == 0.3
    sc = convert.sweep_config(SweepConfig(burn_seconds=7.0))
    assert sc.burn_seconds == 7.0
    tc = convert.triage_config(TriageConfig(strike_limit=5))
    assert tc.strike_limit == 5
    assert [dataclasses.astuple(s) for s in tc.gpu_stages] == \
        [dataclasses.astuple(s) for s in TriageConfig().gpu_stages]


def test_state_lives_on_the_detector_device():
    det = StragglerDetector(DetectorConfig(device="cpu"))
    fa = det.update(port_frame(scripted_sequence()[0]))
    assert det.history.buffer().device == torch.device("cpu")
    assert fa.slowdown.dtype == torch.float32
    assert det.history.buffer().dtype == torch.float32


def test_cuda_detector_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: asking for it is legitimate here")
    with pytest.raises(RuntimeError):
        StragglerDetector(DetectorConfig())          # default is "cuda"
