"""Parity of the port's training slice with the JAX package's.

Inputs come from numpy seeds and go through both packages. Tolerances:

- optimizer (``lr_at``, ``apply_adamw`` over three updates, clipping on
  and off): float32, 1e-6 relative;
- ``SyntheticLM.batch_at``: bit-equal;
- ``cross_entropy`` with masked labels: float32 1e-6 (value) and 1e-6 of
  the largest magnitude (gradient); bfloat16 logits the same, since the
  reduction runs in float32 on the same bfloat16 values;
- ``Model.train_loss`` on reduced qwen3-4b and phi3-mini against
  ``jax.value_and_grad`` of the reference ``Model.train_loss``: float32
  loss 1e-5 relative and every gradient 1e-4 of its leaf's largest
  magnitude (measured: 7e-8 and 1.2e-6); bfloat16 loss 1e-3 and gradients
  5e-2 of the largest magnitude (measured: 4e-5 and 1.7e-2; the frameworks
  round bfloat16 products at different places, and the port's attention
  keeps P in float32 where XLA rounds it);
- two ``Trainer`` steps from the same parameters against the reference
  ``Trainer`` (float32): the moments within 1e-5 of each leaf's largest
  magnitude (measured: 7e-6), and so are the master weights but for the
  few entries where AdamW's ratio m / (sqrt(v) + eps) is ill-conditioned
  (a gradient near zero or near eps, whose float32 summation-order
  difference the division amplifies): at most 1 in 10,000 entries may
  exceed it (measured: 17 of 426,752), and none by more than 5 % of the
  summed learning rate (measured: 1.9 %). The weight-decay set is the
  reference's (``decay_mask``: its scan-stacked layer tree decays the
  layers' norm scales too);
- gradient accumulation over microbatches against the full batch on the
  port: 1e-5 of each leaf's largest magnitude;
- the ssm family (reduced rwkv6-7b: 2 layers, d 128, heads of 32) at a
  sequence 32 divides and one it does not (one WKV chunk of all 40
  tokens): ``Model.train_loss`` against ``jax.value_and_grad`` at the same
  float32 1e-5 / 1e-4 (measured: 7e-8 and 3.8e-6) and bfloat16 1e-3 /
  5e-2 (measured: 8e-5 and 4.2e-2, the u gradient: a sum over every token
  whose terms cancel, 6e-2 from float32 in the reference's own bfloat16
  run); its WKV6 backward is ``wkv6_bwd_ref`` on the CPU, once a layer;
  two ``Trainer`` steps against the reference's as for the dense family,
  but the moments within 2e-5 (measured: 1.0e-5, the second moment of
  u's gradient);
  AdamW's decay set equal to the reference's ``ndim >= 2`` rule on its
  stacked tree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models.common import Policy as JaxPolicy
from repro.models.layers import cross_entropy as jax_cross_entropy
from repro.models.model import Model as JaxModel
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import DataConfig as JaxDataConfig
from repro.train import SyntheticLM as JaxSyntheticLM
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import apply_adamw as jax_apply_adamw
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import lr_at as jax_lr_at
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import (model_params, named_params, opt_state,
                                 reference_tree)
from repro_torch.launch import train as launch_train
from repro_torch.models.common import Policy
from repro_torch.models.layers import cross_entropy
from repro_torch.models.model import Model
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                               TrainConfig, Trainer, apply_adamw,
                               global_norm, init_opt_state, lr_at,
                               make_train_step)
from repro_torch.train.trainer import (_assign, decay_mask, load_working,
                                      master_params)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves_close(got_tree, want_tree, tol, what):
    flat_g = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(want_tree)[0])
    assert len(flat_g) == len(want), what
    for path, g in flat_g:
        err = _rel(g, want[path])
        assert err <= tol, f"{what} {jax.tree_util.keystr(path)}: {err}"


# ------------------------------------------------------------ optimizer


def test_lr_schedule_matches_reference():
    cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    jcfg = JaxAdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(jax_lr_at(jcfg, step))
        assert float(lr_at(cfg, step)) == pytest.approx(want, rel=1e-6,
                                                        abs=1e-12)
    assert float(lr_at(cfg, 0)) == 0.0
    assert float(lr_at(cfg, 100)) == pytest.approx(1e-4, rel=1e-5)


@pytest.mark.parametrize("grad_scale", [100.0, 1e-3])   # clipped, not
def test_adamw_matches_reference(grad_scale):
    rng = np.random.default_rng(int(grad_scale * 10))
    shapes = {"w": (8, 6), "b": (6,), "e": (5, 3, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = JaxAdamWConfig(**dataclasses.asdict(cfg))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jst = jax_init_opt_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    tst = init_opt_state(tp)
    for g in grads:
        jp, jst, jm = jax_apply_adamw(jp, {k: jnp.asarray(v)
                                           for k, v in g.items()}, jst, jcfg)
        tp, tst, tm = apply_adamw(tp, {k: torch.from_numpy(v)
                                       for k, v in g.items()}, tst, cfg)
        for name in ("grad_norm", "lr"):
            assert float(tm[name]) == pytest.approx(float(jm[name]),
                                                    rel=1e-6)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            for m in ("mu", "nu"):
                np.testing.assert_allclose(
                    tst[m][k].numpy(), np.asarray(jst[m][k]), rtol=1e-6,
                    atol=1e-6 * float(np.abs(np.asarray(jst[m][k])).max()))
    assert int(tst["count"]) == int(jst["count"]) == 3
    assert tst["count"].dtype == torch.int32


def test_global_norm_and_clipping():
    g = {"a": torch.full((3, 4), 2.0), "b": torch.full((4,), -1.0)}
    assert float(global_norm(g)) == pytest.approx(np.sqrt(12 * 4 + 4))
    # clip 1 scales the gradient by 1 / |g| into the first moment; after
    # one bias-corrected step from zero moments every entry moves by lr
    # against the sign of its gradient
    params = {k: torch.zeros_like(v) for k, v in g.items()}
    cfg = AdamWConfig(peak_lr=0.5, warmup_steps=0, total_steps=10,
                      weight_decay=0.0, grad_clip=1.0)
    _, st, m = apply_adamw(params, g, init_opt_state(params), cfg)
    scale = 1.0 / float(m["grad_norm"])
    lr = float(m["lr"])
    assert lr == pytest.approx(float(lr_at(cfg, 1)))
    np.testing.assert_allclose(st["mu"]["a"].numpy(), 0.1 * 2.0 * scale,
                               rtol=1e-6)
    np.testing.assert_allclose(params["a"].numpy(), -lr, rtol=1e-5)
    np.testing.assert_allclose(params["b"].numpy(), lr, rtol=1e-5)


# ----------------------------------------------------------------- data


@pytest.mark.parametrize("num_shards", [1, 2])
def test_batch_at_is_bit_equal(num_shards):
    cfg = dict(vocab_size=1000, seq_len=33, global_batch=4, seed=3)
    ours, ref = SyntheticLM(DataConfig(**cfg)), \
        JaxSyntheticLM(JaxDataConfig(**cfg))
    for step in (0, 1, 17):
        for shard in range(num_shards):
            a = ours.batch_at(step, shard, num_shards)
            b = ref.batch_at(step, shard, num_shards)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------- loss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(5)
    vocab, vp = 200, 256
    logits = (rng.standard_normal((2, 12, vp)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, (2, 12)).astype(np.int32)
    labels[0, :3] = -1                       # masked
    labels[1, 5] = vocab + 7                 # padded slot: masked
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jl = jnp.asarray(logits, jd)
    want, jgrad = jax.value_and_grad(
        lambda x: jax_cross_entropy(x, jnp.asarray(labels), vocab))(jl)
    x = torch.from_numpy(logits).to(td).requires_grad_(True)
    got = cross_entropy(x, torch.from_numpy(labels), vocab)
    got.backward()
    assert got.dtype == torch.float32
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    assert _rel(x.grad.float().numpy(), jgrad) <= 1e-6
    # masked positions take no gradient
    assert float(x.grad[0, :3].abs().max()) == 0.0


# ---------------------------------------------------------- train_loss

TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 5e-2)}


def _pair(arch, dtype, remat="full"):
    jcfg = jax_reduced(jax_get_config(arch))
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=getattr(jnp, dtype)))
    params, _ = jm.init_params(jax.random.key(0))
    model = model_params(jax.tree.map(np.asarray, params),
                         reduced(get_config(arch)),
                         policy=Policy(compute_dtype=getattr(torch, dtype)),
                         device="cpu")
    model.remat = remat
    return jm, params, model


def _batch(vocab, B=2, S=32, seed=0):
    b = SyntheticLM(DataConfig(vocab, S, B, seed=seed)).batch_at(0)
    b["labels"][0, :4] = -1                  # a masked prefix
    return b


def _port_grads(model, batch):
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = model.train_loss(batch)
    loss.backward()
    return loss, metrics, {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["qwen3-4b", "phi3-mini-3.8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_grads_match_reference(arch, dtype):
    jm, params, model = _pair(arch, dtype)
    batch = _batch(model.cfg.vocab_size)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(params, {k: jnp.asarray(v)
                                               for k, v in batch.items()})
    loss, metrics, grads = _port_grads(model, batch)
    ltol, gtol = TOL[dtype]
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert float(loss) == pytest.approx(float(jloss), rel=ltol)
    assert float(metrics["ce"]) == float(loss)
    assert float(metrics["aux"]) == float(jmet["aux"]) == 0.0
    _leaves_close(reference_tree(grads), jax.tree.map(np.asarray, jgrads),
                  gtol, f"{arch} {dtype} grad")


def test_remat_recomputes_the_same_numbers():
    _, _, full = _pair("qwen3-4b", "float32", remat="full")
    _, _, none = _pair("qwen3-4b", "float32", remat="none")
    batch = _batch(full.cfg.vocab_size, seed=1)
    lf, _, gf = _port_grads(full, batch)
    ln, _, gn = _port_grads(none, batch)
    assert float(lf) == float(ln)
    for name in gf:
        assert torch.equal(gf[name], gn[name]), name


@pytest.mark.parametrize("S", [32, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_train_loss_and_grads_match_reference(dtype, S):
    jm, params, model = _pair("rwkv6-7b", dtype)
    batch = _batch(model.cfg.vocab_size, S=S)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(params, {k: jnp.asarray(v)
                                               for k, v in batch.items()})
    loss, metrics, grads = _port_grads(model, batch)
    ltol, gtol = TOL[dtype]
    assert float(loss) == pytest.approx(float(jloss), rel=ltol)
    assert float(metrics["aux"]) == float(jmet["aux"]) == 0.0
    _leaves_close(reference_tree(grads), jax.tree.map(np.asarray, jgrads),
                  gtol, f"rwkv6-7b {dtype} S={S} grad")


def test_ssm_step_runs_the_wkv6_backward_once_a_layer(monkeypatch):
    import repro_torch.kernels.wkv6.ops as ops
    calls = []
    bwd = ops.wkv6_bwd_ref

    def counted(*a, **kw):
        calls.append(kw["chunk"])
        return bwd(*a, **kw)

    monkeypatch.setattr(ops, "wkv6_bwd_ref", counted)
    _, _, model = _pair("rwkv6-7b", "float32")
    _port_grads(model, _batch(model.cfg.vocab_size, S=64))
    assert calls == [32] * model.cfg.num_layers


def test_ssm_remat_recomputes_the_same_numbers():
    _, _, full = _pair("rwkv6-7b", "float32", remat="full")
    _, _, none = _pair("rwkv6-7b", "float32", remat="none")
    batch = _batch(full.cfg.vocab_size, seed=1)
    lf, _, gf = _port_grads(full, batch)
    ln, _, gn = _port_grads(none, batch)
    assert float(lf) == float(ln)
    for name in gf:
        assert torch.equal(gf[name], gn[name]), name


def test_ssm_decay_set_is_the_references():
    jm, params, model = _pair("rwkv6-7b", "float32")
    want = jax.tree.map(lambda x: np.asarray(np.ndim(x) >= 2, np.float32),
                        params)
    got = reference_tree({n: np.asarray(d, np.float32)
                          for n, d in decay_mask(model).items()})
    _leaves_close(got, want, 0.0, "decay")
    assert not decay_mask(model)["ln0"] and decay_mask(model)["embed.tok"]
    assert decay_mask(model)["layers.0.tm.u"]


def test_remat_option_is_checked():
    with pytest.raises(ValueError):
        Model(reduced(get_config("qwen3-4b")), device="cpu", remat="some")


# -------------------------------------------------------------- trainer


def test_two_trainer_steps_match_reference():
    _two_trainer_steps("qwen3-4b", moment_tol=1e-5)


def test_ssm_two_trainer_steps_match_reference():
    # the second moment of u's gradient (a sum over every token whose
    # terms cancel) reads 1.0e-5 of its largest magnitude
    _two_trainer_steps("rwkv6-7b", moment_tol=2e-5)


def _two_trainer_steps(arch, moment_tol):
    opt = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jcfg = jax_reduced(jax_get_config(arch))
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=jnp.float32))
    jdata = JaxSyntheticLM(JaxDataConfig(jcfg.vocab_size, 32, 2))
    ref = JaxTrainer(jm, jdata, JaxTrainConfig(
        steps=2, ckpt_interval=100, opt=JaxAdamWConfig(**opt)), seed=0)
    init = jax.tree.map(np.asarray, ref.params)
    ref_out = ref.run()

    model = model_params(init, reduced(get_config(arch)),
                         policy=Policy(compute_dtype=torch.float32),
                         device="cpu")
    data = SyntheticLM(DataConfig(jcfg.vocab_size, 32, 2))
    tr = Trainer(model, data, TrainConfig(steps=2, ckpt_interval=100,
                                          opt=AdamWConfig(**opt)))
    # float32: the master weights are the model's own parameters
    for name, p in model.named_parameters():
        assert tr.params[name].data_ptr() == p.data_ptr()
    out = tr.run()
    assert out["final_step"] == ref_out["final_step"] == 2
    for h, rh in zip(out["history"], ref_out["history"]):
        assert h["loss"] == pytest.approx(rh["loss"], rel=1e-5)
        assert h["grad_norm"] == pytest.approx(rh["grad_norm"], rel=1e-5)
        assert h["lr"] == pytest.approx(rh["lr"], rel=1e-6)
    lr_sum = sum(h["lr"] for h in out["history"])
    want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, ref.params))[0])
    outside = total = 0
    for path, g in jax.tree_util.tree_flatten_with_path(
            reference_tree(tr.params))[0]:
        w = want[path]
        d = np.abs(g - w)
        tol = 1e-5 * float(np.abs(w).max())
        assert float(d.max()) <= tol + 0.05 * lr_sum, \
            jax.tree_util.keystr(path)
        outside += int((d > tol).sum())
        total += d.size
    assert outside <= 1e-4 * total, (outside, total)
    for m in ("mu", "nu"):
        _leaves_close(reference_tree(tr.opt_state[m]),
                      jax.tree.map(np.asarray, ref.opt_state[m]),
                      moment_tol, m)
    assert int(tr.opt_state["count"]) == int(ref.opt_state["count"]) == 2


def test_microbatch_accumulation_equals_full_batch():
    _, _, model = _pair("qwen3-4b", "float32")
    batch = SyntheticLM(DataConfig(model.cfg.vocab_size, 16, 4)).batch_at(0)
    cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    outs = []
    for micro in (0, 2):
        params = {k: v.clone() for k, v in master_params(model).items()}
        state = init_opt_state(params)
        step = make_train_step(model, cfg, microbatch=micro)
        params, state, metrics = step(params, state, batch)
        outs.append((params, state, metrics))
    (p0, s0, m0), (p2, s2, m2) = outs
    assert float(m2["loss"]) == pytest.approx(float(m0["loss"]), rel=1e-5)
    assert float(m2["grad_norm"]) == pytest.approx(float(m0["grad_norm"]),
                                                   rel=1e-5)
    for name in p0:
        assert _rel(s2["mu"][name], s0["mu"][name]) <= 1e-5, name
        assert _rel(p2[name], p0[name]) <= 1e-5, name


def test_microbatches_of_dense_positions_match_reference():
    """The dense family's (B, S) "positions" split with the tokens: four
    rows, each with its own offset, in microbatches of 2 give the full
    batch's step in the port, and the loss, norm and first moments of the
    reference's microbatched step (whose split reshapes every leaf whose
    dim 0 is B)."""
    jm, params, model = _pair("qwen3-4b", "float32")
    batch = SyntheticLM(DataConfig(model.cfg.vocab_size, 16, 4)).batch_at(0)
    batch["positions"] = (np.arange(16)[None] +
                          np.array([[0], [5], [2], [9]])).astype(np.int32)
    cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    outs = []
    for micro in (0, 2):
        params_t = {k: v.clone() for k, v in master_params(model).items()}
        outs.append(make_train_step(model, cfg, microbatch=micro)(
            params_t, init_opt_state(params_t), batch))
    (_, s0, m0), (p2, s2, m2) = outs
    assert float(m2["loss"]) == pytest.approx(float(m0["loss"]), rel=1e-5)
    for name in p2:
        assert _rel(s2["mu"][name], s0["mu"][name]) <= 1e-5, name
    _, jstate, jm2 = jax_make_train_step(
        jm, JaxAdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10),
        microbatch=2)(params, jax_init_opt_state(params),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(m2["loss"]) == pytest.approx(float(jm2["loss"]), rel=1e-5)
    assert float(m2["grad_norm"]) == pytest.approx(float(jm2["grad_norm"]),
                                                   rel=1e-5)
    _leaves_close(reference_tree(s2["mu"]),
                  jax.tree.map(np.asarray, jstate["mu"]), 1e-4, "mu")


def test_chip_smokes_piecewise_update_agreement_equals_whole_tree_adamw(
        monkeypatch):
    """``chip_smoke.update_agreement`` (every training phase's AdamW check)
    updates a row-piece of a leaf at a time, with ``apply_adamw``'s global
    clip applied first and the per-piece clip off. With pieces that split
    the leaves and the clip active (a gradient norm far above 1), its
    share of flipped signs equals that of two whole-tree ``apply_adamw``
    calls from zero moments, and its cosine theirs. One leaf's gradient is
    large enough to set the clip's scale, and the others are so small that
    the clipped gradients come near AdamW's eps, where an update depends
    on the scale."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "UPDATE_PIECE", 100)
    model = Model(reduced(get_config("qwen3-4b")), device="cpu", seed=0)
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    gen = torch.Generator().manual_seed(3)
    big = "embed.tok"
    grads_a, grads_b = ({n: torch.randn(p.shape, generator=gen) * scale
                         * (1e6 if n == big else 1.0)
                         for n, p in model.named_parameters()}
                        for scale in (1e-4, 5e-5))
    grads_b = {n: grads_a[n] + g for n, g in grads_b.items()}
    assert float(global_norm(grads_a)) > 1e4 * opt.grad_clip
    assert any(p.shape[0] > 100 // p[0].numel()
               for p in model.parameters() if p.dim() > 1)
    decay = decay_mask(model)
    ups = []
    for grads in (grads_a, grads_b):
        master = {n: p.detach().float().clone()
                  for n, p in model.named_parameters()}
        new = {n: w.clone() for n, w in master.items()}
        apply_adamw(new, grads, init_opt_state(new), opt, decay)
        ups.append(torch.cat([(new[n] - master[n]).double().flatten()
                              for n in master]))
    ua, ub = ups
    flips = int((ua.sign() != ub.sign()).sum()) / ua.numel()
    cos = float((ua * ub).sum() / (ua.norm() * ub.norm()))
    got_flips, got_cos, lr = cs.update_agreement(torch, model, grads_a,
                                                 grads_b, opt)
    assert 0 < flips < 0.5
    assert got_flips == flips
    assert got_cos == pytest.approx(cos, rel=1e-12)
    assert lr == pytest.approx(float(lr_at(opt, 1)))


def test_bf16_working_weights_follow_the_fp32_master():
    jm, params, model = _pair("qwen3-4b", "bfloat16")
    master = named_params(jax.tree.map(np.asarray, params),
                          len(model.layers))
    data = SyntheticLM(DataConfig(model.cfg.vocab_size, 16, 2))
    tr = Trainer(model, data, TrainConfig(steps=2, ckpt_interval=100))
    _assign(tr.params, {k: torch.tensor(v) for k, v in master.items()})
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16
        assert tr.params[name].dtype == torch.float32
        np.testing.assert_array_equal(tr.params[name].numpy(),
                                      master[name])
    tr.run()
    # the next step computes with the updated master, rounded to bf16
    load_working(model, tr.params)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), tr.params[name].to(torch.bfloat16))
        assert not torch.equal(tr.params[name], torch.from_numpy(
            master[name])), name


def test_converted_optimizer_state_round_trips():
    jcfg = jax_reduced(jax_get_config("qwen3-4b"))
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=jnp.float32))
    params, _ = jm.init_params(jax.random.key(2))
    tree = jax.tree.map(np.asarray, params)
    model = model_params(tree, reduced(get_config("qwen3-4b")),
                         policy=Policy(compute_dtype=torch.float32),
                         device="cpu")
    rng = np.random.default_rng(0)
    jopt = {"mu": jax.tree.map(lambda x: rng.standard_normal(x.shape)
                               .astype(np.float32), tree),
            "nu": jax.tree.map(lambda x: rng.random(x.shape)
                               .astype(np.float32), tree),
            "count": np.int32(7)}
    st = opt_state(jopt, model)
    assert int(st["count"]) == 7 and st["count"].dtype == torch.int32
    for m in ("mu", "nu"):
        _leaves_close(reference_tree(st[m]), jopt[m], 0.0, m)
    _leaves_close(reference_tree(dict(model.named_parameters())), tree, 0.0,
                  "params")


def test_launcher_trains_on_cpu(tmp_path, capsys):
    assert launch_train.main(["--device", "cpu", "--steps", "6",
                              "--seq-len", "16", "--batch", "2",
                              "--ckpt-interval", "3",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "done: 6 steps" in out
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("ckpt-")) == ["ckpt-00000003",
                                                     "ckpt-00000006"]


def test_launcher_trains_rwkv6_on_cpu(tmp_path, capsys):
    assert launch_train.main(["--arch", "rwkv6-7b", "--device", "cpu",
                              "--steps", "4", "--seq-len", "40", "--batch",
                              "2", "--ckpt-interval", "2",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "rwkv6-7b" in out and "done: 4 steps" in out
