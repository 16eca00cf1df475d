"""The check that decides ``correct`` fails what it must, at a tiny size on
the CPU with each cell's own limits: the control (the plain reference with
float8 products in the program's place) and, in a whole run with the
look for a card skipped, each fault a one-card training cell can have: a
step that leaves its state unchanged, half of the batch left out (the
mean over the rest), an answer altered where it is produced (Guard's
verdict on a node; the step's loss where the cell compares it, else a
layer's output). A cell on one card has no exchange between chips to
leave out. The control and the faults come out not correct by the
harness's own ``judge``."""
import pytest
import torch

from bench import harness
from bench.tests.tiny_cells import names, tiny


@pytest.mark.parametrize("name", names())
def test_control_separates(name):
    """On one seed, the control reads at least three times what a sound
    run of the program reads on one of the cell's numbers, and fails
    that number's limit."""
    c = tiny(name)
    sound = harness.run_cell(c, 11, 0.3, False, "cpu", 0.0)["gaps"]
    read = harness.control_numbers(c, 11, "cpu")
    control = read["control"]
    apart = [k for k in c["limits"] if k in control
             and control[k] >= 3 * sound[k] and control[k] > c["limits"][k]]
    assert apart, (sound, control)
    assert not read["control_correct"]
    assert not read["half_batch_correct"], read["half_batch"]


def _unchanged(monkeypatch):
    import repro_torch.train.trainer as tr
    real = tr.apply_adamw

    def frozen(params, grads, state, cfg, decay=None):
        keep = {k: v.clone() for k, v in params.items()}
        params, state, m = real(params, grads, state, cfg, decay)
        for k, v in params.items():
            v.copy_(keep[k])
        for t in (*state["mu"].values(), *state["nu"].values()):
            t.zero_()
        return params, state, m
    monkeypatch.setattr(tr, "apply_adamw", frozen)


def _half_batch(monkeypatch):
    from repro_torch.models.model import Model
    real = Model.train_loss

    def half(self, batch):
        labels = batch["labels"].copy()
        labels[:, labels.shape[1] // 2:] = -1       # masked: mean over rest
        return real(self, {**batch, "labels": labels})
    monkeypatch.setattr(Model, "train_loss", half)


def _verdict(monkeypatch):
    from repro_torch.core.detector import StragglerDetector
    real = StragglerDetector.update

    def flipped(self, frame):
        out = real(self, frame)
        out.flagged = out.flagged.clone()
        out.flagged[1] = ~out.flagged[1]
        return out
    monkeypatch.setattr(StragglerDetector, "update", flipped)


def _loss(monkeypatch):
    import repro_torch.train.trainer as tr
    real = tr.apply_adamw

    def reported(params, grads, state, cfg, decay=None):
        return real(params, grads, state, cfg, decay)
    real_step = tr.make_train_step

    def step_maker(*a, **k):
        fn = real_step(*a, **k)

        def step(params, opt_state, batch):
            params, opt_state, m = fn(params, opt_state, batch)
            return params, opt_state, {**m, "loss": m["loss"] * 1.01}
        return step
    monkeypatch.setattr(tr, "make_train_step", step_maker)


def _layer_output(monkeypatch):
    """The first layer's output at the last position negated where the
    layer produces it."""
    from repro_torch.models.model import Model
    real = Model._unit

    def unit(self, name, fn, *args):
        out = real(self, name, fn, *args)
        if name != "layers.0":
            return out
        x = out[0] if isinstance(out, tuple) else out
        x = torch.cat([x[:, :-1], -x[:, -1:]], dim=1)
        return (x, *out[1:]) if isinstance(out, tuple) else x
    monkeypatch.setattr(Model, "_unit", unit)


FAULTS = {"state_unchanged": _unchanged, "half_batch": _half_batch,
          "verdict_altered": _verdict, "loss_altered": _loss,
          "layer_output_altered": _layer_output}


def _faults() -> list:
    """(cell, fault): every cell's faults, the altered answer the step's
    loss where the cell compares it, else the first layer's output."""
    out = []
    for name in names():
        lim = tiny(name)["limits"]
        answer = "loss_altered" if {"loss", "loss_first"} & set(lim) \
            else "layer_output_altered"
        out += [(name, f) for f in ("state_unchanged", "half_batch",
                                    "verdict_altered", answer)]
    return out


@pytest.mark.parametrize("name,fault", _faults())
def test_fault_fails(name, fault, monkeypatch):
    c = tiny(name)
    sound = harness.run_cell(c, 13, 0.3, False, "cpu", 0.0)
    assert sound["result"]["correct"], sound["lines"]
    FAULTS[fault](monkeypatch)
    out = harness.run_cell(c, 13, 0.3, False, "cpu", 0.0)
    assert not out["result"]["correct"], out["lines"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", names())
def test_cell_on_card(name):
    """One short run of the cell on the card is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.cell(harness.load_benchmark(), name)
    out = harness.run_cell(c, 17, 5.0, False, "cuda", 0.0)
    assert out["result"]["correct"], out["lines"]


@pytest.mark.parametrize("name", names())
def test_wrong_leaf_gradient_fails(name, monkeypatch):
    """One leaf's gradient 50 % off in the first layer (the first matrix
    there, its gradient scaled as the backward produces it) fails the
    cell's numbers."""
    c = tiny(name)
    real = harness.build_model

    def build(conf, seed, device):
        model = real(conf, seed, device)
        leaf = next(p for n, p in model.named_parameters()
                    if n.startswith("layers.0.") and p.dim() == 2)
        leaf.requires_grad_(True).register_hook(lambda g: g * 1.5)
        return model
    monkeypatch.setattr(harness, "build_model", build)
    out = harness.run_cell(c, 13, 0.3, False, "cpu", 0.0)
    assert not out["result"]["correct"], out["lines"]
