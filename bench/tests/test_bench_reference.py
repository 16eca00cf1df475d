"""The plain references against the program at a tiny size on the CPU:
the families' losses and gradients in float32 from the same drawn
weights, and Guard's verdicts on the same frames."""
import numpy as np
import pytest
import torch

from bench import guard_ref, harness, traffic, weights
from bench.reference.common import Prec
from bench.tests.tiny_cells import tiny


@pytest.mark.parametrize("name", ["moe16b.train.4k", "rwkv6.train.4k"])
def test_family_loss_and_grads(name):
    from repro_torch.configs.base import ArchConfig, MoEConfig
    from repro_torch.models.common import Policy
    from repro_torch.models.model import Model
    c = tiny(name)
    conf, tf = c["config"], c["traffic"]
    run = dict(conf["run"])
    moe = run.pop("moe", None)
    cfg = ArchConfig(**run, moe=MoEConfig(**moe) if moe else None)
    model = Model(cfg, Policy(compute_dtype=torch.float32), device="cpu",
                  seed=None)
    fam, rc = harness.family(conf), harness.ref_config(conf)
    spec = fam.param_spec(rc)
    weights.load_into(dict(model.named_parameters()), spec, 7)
    for p in model.parameters():
        p.requires_grad_(True)
    batch = traffic.source(tf, rc["vocab_size"], 7).batch_at(0)
    loss, _ = model.train_loss(batch)
    loss.backward()
    P = {n: v.requires_grad_(True)
         for n, v in weights.leaves(spec, 7, "cpu", torch.float32)}
    ref = fam.loss(P, rc, torch.as_tensor(batch["tokens"]).long(),
                   torch.as_tensor(batch["labels"]).long(), Prec())[0]
    ref.backward()
    assert loss.item() == pytest.approx(ref.item(), rel=1e-5)
    for n, p in model.named_parameters():
        g, w = p.grad, P[n].grad
        scale = float(w.abs().max()) or 1.0
        assert float((g - w).abs().max()) <= 1e-4 * scale, n


def test_weights_redraw_equal():
    spec = [("a", (3, 5), ("normal", 0.5)), ("b", (4,), ("full", -3.0)),
            ("c", (300,), ("normal", 1.0))]
    one = dict(weights.leaves(spec, 2 ** 31 + 9, "cpu"))
    two = dict(weights.leaves(spec, 2 ** 31 + 9, "cpu"))
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert one["a"].dtype == torch.bfloat16
    assert (one["b"] == -3).all()
    other = dict(weights.leaves(spec, 2 ** 31 + 10, "cpu"))
    assert not torch.equal(one["c"], other["c"])


def _frames(n=257, windows=14, seed=0):
    """Peers around 1.0 with 1 % jitter; node 5 slowed 8 % from window 2,
    node 9 stalled in window 4, node 11 invalid in window 6, node 3
    replaced by a new id in window 8."""
    rng = np.random.RandomState(seed)
    ids = np.arange(n, dtype=np.int64)
    out = []
    for w in range(windows):
        st = 1.0 + rng.normal(0, 0.01, n)
        if w >= 2:
            st[5] *= 1.08
        if w == 4:
            st[9] *= 7.0
        valid = np.ones(n, bool)
        if w == 6:
            valid[11] = False
        if w == 8:
            ids = ids.copy()
            ids[3] = 10_000
        out.append({"node_ids": ids, "step_time": st, "valid": valid})
    return out


def test_guard_verdicts_equal_the_program():
    from repro_torch.core.detector import DetectorConfig, StragglerDetector
    from repro_torch.core.telemetry import Frame
    det = StragglerDetector(DetectorConfig(device="cpu"))
    frames = _frames()
    got = [det.update(Frame(t=float(i), step=i, node_ids=f["node_ids"],
                            metrics={"step_time": f["step_time"]},
                            valid=f["valid"])).numpy()
           for i, f in enumerate(frames)]
    assert any(g["flagged"][5] for g in got)         # the planted straggler
    assert any(g["stalled"][9] for g in got)
    assert guard_ref.mismatches(frames, got) == 0
    got[9]["slowdown"] = got[9]["slowdown"].copy()
    got[9]["slowdown"][5] = np.nextafter(got[9]["slowdown"][5], np.float32(2))
    assert guard_ref.mismatches(frames, got) == 1
