"""Parity of the port's vlm-family training (``Model.train_loss`` of
qwen2-vl with M-RoPE and the patch overwrite, its remat, ``param_axes``,
``zero3_units``, the decay set, ``convert``, two ``Trainer`` steps, the
launcher, the microbatch refusal) with the JAX package's.

Inputs come from numpy seeds and go through both packages; the model's
weights are the reference's, carried across with ``convert.model_params``.
The config is the reduced qwen2-vl-72b of ``tests/test_torch_vlm.py`` (2
layers, d 128, 4 query heads over 2 KV heads of 32, sections (4, 6, 6));
each batch is a ``SyntheticLM`` batch with seeded patch embeddings of a
2 x 2 image and M-RoPE positions in Qwen2-VL's layout
(``torch_dist_workers.WithPatches``). Limits (``PERF.md`` §2):

- ``train_loss``: the loss and every gradient against
  ``jax.value_and_grad`` of the reference's: float32 1e-5 / 1e-4 of each
  leaf's largest magnitude; bfloat16 1e-3 / 5e-2;
- the patches overwrite the first P token embeddings: a token id that
  appears only under them gets a gradient of exactly zero in its row of
  the token table, in both packages;
- remat "full" bit-equal to "none";
- ``param_axes``, the decay set, ``zero3_units`` and ``convert`` are the
  dense family's: the reference's without its stacked axis, its ``ndim
  >= 2`` rule leaf by leaf, "in", "layers.<i>", "out";
- two ``Trainer`` steps against the reference's at the limits of
  ``tests/test_torch_train.py::test_two_trainer_steps_match_reference``;
- the training launcher, which feeds ``SyntheticLM`` batches without
  positions, raises a ``KeyError`` naming ``positions`` in both packages;
- gradient accumulation (``microbatch`` > 0) of a batch with (3, B, S)
  positions raises ``NotImplementedError`` in the port, where the
  reference's split hands every chunk all B rows of the positions and
  fails (B = 4, microbatch 2).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import train as jax_launch_train
from repro.models.common import Policy as JaxPolicy
from repro.models.model import Model as JaxModel
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import DataConfig as JaxDataConfig
from repro.train import SyntheticLM as JaxSyntheticLM
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import init_opt_state as jax_init_opt_state
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.convert import (model_params, named_params, opt_state,
                                 reference_tree)
from repro_torch.launch import train as launch_train
from repro_torch.models.common import Policy
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                               TrainConfig, Trainer)
from repro_torch.train.trainer import (decay_mask, make_train_step,
                                       master_params)

from torch_dist_workers import VLM_GRID, WithPatches

ARCH = "qwen2-vl-72b"
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 5e-2)}
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


def _cfgs():
    return jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))


def _pair(dtype, remat="full"):
    jcfg, cfg = _cfgs()
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=getattr(jnp, dtype)))
    params, _ = jm.init_params(jax.random.key(0))
    model = model_params(jax.tree.map(np.asarray, params), cfg,
                         policy=Policy(compute_dtype=getattr(torch, dtype)),
                         device="cpu")
    model.remat = remat
    return jm, params, model


@functools.lru_cache(maxsize=None)
def _shared(dtype):
    """``_pair`` for the tests that read the parameters and change none."""
    return _pair(dtype)


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaf_errs(got_tree, want_tree):
    flat_g = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(want_tree)[0])
    assert len(flat_g) == len(want)
    return {jax.tree_util.keystr(path): _rel(g, want[path])
            for path, g in flat_g}


def _data(cfg, B=2, S=16, seed=0, package=None):
    lm, dc = (SyntheticLM, DataConfig) if package is None else package
    return WithPatches(lm(dc(cfg.vocab_size, S, B, seed=seed)), VLM_GRID,
                       cfg.d_model, seed)


def _batch(cfg, seed=0, S=16, B=2):
    b = _data(cfg, B=B, S=S, seed=seed).batch_at(0)
    b["labels"][0, :4] = -1                  # a masked prefix
    return b


def _port_grads(model, batch):
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = model.train_loss(batch)
    loss.backward()
    return loss.detach(), metrics, {n: p.grad
                                    for n, p in model.named_parameters()}


def _reference_grads(jm, params, batch):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, metrics, grads


# ----------------------------------------------------------- train_loss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_grads_match_reference(dtype):
    jm, params, model = _pair(dtype)
    batch = _batch(model.cfg)
    assert batch["positions"].shape == (3, 2, 16)
    assert batch["patch_embeds"].shape == (2, 4, model.cfg.d_model)
    jloss, jmet, jgrads = _reference_grads(jm, params, batch)
    loss, metrics, grads = _port_grads(model, batch)
    ltol, gtol = TOL[dtype]
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert float(loss) == pytest.approx(float(jloss), rel=ltol)
    assert float(metrics["ce"].detach()) == float(loss)
    assert float(metrics["aux"]) == float(jmet["aux"]) == 0.0
    errs = _leaf_errs(reference_tree(grads), jax.tree.map(np.asarray,
                                                          jgrads))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= gtol, (worst, errs[worst])


def test_the_patch_rows_give_the_token_table_no_gradient():
    """Token ids 500-503 stand only under the patches (the first P = 4
    positions of each row), the text draws from 0-499: their rows of the
    token table get exactly zero gradient in both packages, and the text's
    ids do not."""
    jm, params, model = _pair("float32")
    batch = _batch(model.cfg, seed=3)
    rng = np.random.default_rng(3)
    batch["tokens"] = rng.integers(0, 500, batch["tokens"].shape)
    batch["tokens"][:, :4] = 500 + np.arange(4)
    jgrads = _reference_grads(jm, params, batch)[2]
    grads = _port_grads(model, batch)[2]
    under = slice(500, 504)
    assert not grads["embed.tok"][under].any()
    assert not np.asarray(jgrads["embed"]["tok"])[under].any()
    text = np.unique(batch["tokens"][:, 4:])
    assert grads["embed.tok"][text].abs().sum(dim=1).min() > 0
    assert max(_leaf_errs(reference_tree(grads), jax.tree.map(
        np.asarray, jgrads)).values()) <= TOL["float32"][1]


def test_remat_recomputes_the_same_numbers():
    _, _, full = _pair("float32", remat="full")
    _, _, none = _pair("float32", remat="none")
    batch = _batch(full.cfg, seed=1)
    lf, _, gf = _port_grads(full, batch)
    ln, _, gn = _port_grads(none, batch)
    assert float(lf) == float(ln)
    for name in gf:
        assert torch.equal(gf[name], gn[name]), name


# ------------------------------------- axes, decay set, ZeRO-3 units, convert


def _reference_names(tree, fn):
    """{port parameter name: fn(leaf)} of a reference tree, its stacked
    ``layers`` unstacked (``fn`` gets the stacked leaf)."""
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = fn(val)
    walk({k: v for k, v in tree.items() if k != "layers"}, "")
    for i in range(2):
        walk(tree["layers"], f"layers.{i}.")
    return out


def test_param_axes_are_the_references():
    jm, _, model = _shared("float32")
    got = {n: tuple(a) for n, a in model.param_axes().items()}
    want = _reference_names(
        jm.param_axes(),
        lambda ax: tuple(ax)[1:] if ax and ax[0] == "layer" else tuple(ax))
    assert got == want
    assert got["layers.0.attn.bq"] == ("heads",)
    assert got["layers.1.attn.bk"] == ("kv_heads",)


def test_decay_set_and_zero3_units_are_the_dense_familys():
    _, params, model = _shared("float32")
    want = jax.tree.map(lambda x: np.asarray(np.ndim(x) >= 2, np.float32),
                        params)
    mask = decay_mask(model)
    got = reference_tree({n: np.asarray(d, np.float32)
                          for n, d in mask.items()})
    assert max(_leaf_errs(got, want).values()) == 0.0
    assert mask["layers.0.attn.bq"] and not mask["ln_f"]
    units = model.zero3_units()
    assert list(units) == ["in", "layers.0", "layers.1", "out"]
    assert units["in"] == ["embed.tok"]
    assert sorted(units["out"]) == ["embed.head", "ln_f"]
    names = [n for n, _ in model.named_parameters()]
    every = sum(units.values(), [])
    assert len(every) == len(set(every)) and sorted(every) == sorted(names)


def test_convert_round_trips_parameters_and_optimizer_state():
    _, params, model = _shared("float32")
    tree = jax.tree.map(np.asarray, params)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in jax.tree.leaves(tree))
    assert max(_leaf_errs(reference_tree(dict(model.named_parameters())),
                          tree).values()) == 0.0
    assert set(named_params(tree, 2)) == set(dict(model.named_parameters()))
    rng = np.random.default_rng(0)
    jopt = {"mu": jax.tree.map(lambda x: rng.standard_normal(x.shape)
                               .astype(np.float32), tree),
            "nu": jax.tree.map(lambda x: rng.random(x.shape)
                               .astype(np.float32), tree),
            "count": np.int32(3)}
    st = opt_state(jopt, model)
    for m in ("mu", "nu"):
        assert max(_leaf_errs(reference_tree(st[m]),
                              jopt[m]).values()) == 0.0, m
    assert int(st["count"]) == 3


# -------------------------------------------------------------- trainer


def test_two_trainer_steps_match_reference():
    jcfg, cfg = _cfgs()
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=jnp.float32))
    jdata = _data(jcfg, package=(JaxSyntheticLM, JaxDataConfig))
    ref = JaxTrainer(jm, jdata, JaxTrainConfig(
        steps=2, ckpt_interval=100, opt=JaxAdamWConfig(**OPT)), seed=0)
    init = jax.tree.map(np.asarray, ref.params)
    ref_out = ref.run()
    model = model_params(init, cfg, policy=Policy(compute_dtype=torch.float32),
                         device="cpu")
    tr = Trainer(model, _data(cfg), TrainConfig(steps=2, ckpt_interval=100,
                                                opt=AdamWConfig(**OPT)))
    out = tr.run()
    assert out["final_step"] == ref_out["final_step"] == 2
    for h, rh in zip(out["history"], ref_out["history"]):
        assert h["loss"] == pytest.approx(rh["loss"], rel=1e-5)
        assert h["grad_norm"] == pytest.approx(rh["grad_norm"], rel=1e-5)
        assert h["lr"] == pytest.approx(rh["lr"], rel=1e-6)
    # every master within 1e-5 of its leaf's largest magnitude plus 5 % of
    # the summed lr, and at most 1 in 10^4 entries of the leaves drawn at
    # init beyond 1e-5 (AdamW's m / (sqrt(v) + eps) is ill-conditioned
    # there; the zero-initialized norm scales and biases are held by the
    # bound)
    lr_sum = sum(h["lr"] for h in out["history"])
    want = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, ref.params))[0])
    init = dict(jax.tree_util.tree_flatten_with_path(init)[0])
    outside = total = 0
    for path, g in jax.tree_util.tree_flatten_with_path(
            reference_tree(tr.params))[0]:
        w = want[path]
        d = np.abs(g - w)
        tol = 1e-5 * float(np.abs(w).max())
        assert float(d.max()) <= tol + 0.05 * lr_sum, \
            jax.tree_util.keystr(path)
        if np.any(init[path]):
            outside += int((d > tol).sum())
            total += d.size
    assert outside <= 1e-4 * total, (outside, total)
    for m in ("mu", "nu"):
        errs = _leaf_errs(reference_tree(tr.opt_state[m]),
                          jax.tree.map(np.asarray, ref.opt_state[m]))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 1e-4, (m, worst, errs[worst])
    assert int(tr.opt_state["count"]) == int(ref.opt_state["count"]) == 2


def test_launcher_raises_on_batches_without_positions(tmp_path):
    """Both packages' training launchers feed ``SyntheticLM`` batches,
    which hold no M-RoPE positions: both stop at the first step on the
    missing key, and the port invents no input."""
    argv = ["--arch", ARCH, "--steps", "1", "--seq-len", "8", "--batch",
            "2"]
    with pytest.raises(KeyError, match="positions"):
        jax_launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "jax")])
    with pytest.raises(KeyError, match="positions"):
        launch_train.main(argv + ["--device", "cpu", "--ckpt-dir",
                                  str(tmp_path / "port")])


def test_microbatches_of_positions_are_refused_where_the_reference_fails():
    """At B = 4, microbatch 2 the reference's split gives each 2-row chunk
    the whole (3, 4, S) positions, whose tables do not broadcast against
    the chunk's rows: its step fails. The port refuses such a batch
    outright, and still steps on it without a microbatch."""
    jm, params, model = _pair("float32")
    batch = _batch(model.cfg, B=4, S=8)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax_make_train_step(jm, JaxAdamWConfig(**OPT), microbatch=2)
    with pytest.raises((TypeError, ValueError)):
        step(params, jax_init_opt_state(params), jbatch)
    from repro_torch.train import init_opt_state
    master = master_params(model)
    with pytest.raises(NotImplementedError, match="positions"):
        make_train_step(model, AdamWConfig(**OPT), microbatch=2)(
            master, init_opt_state(master), batch)
    _, _, metrics = make_train_step(model, AdamWConfig(**OPT))(
        master, init_opt_state(master), batch)
    assert np.isfinite(float(metrics["loss"]))


def test_first_steps_witness_runs_both_packages_alike():
    """``tests/vlm_first_steps.py`` (the CPU witness of the loss after the
    first AdamW steps at qwen2-vl's widths) at the reduced width: both
    packages' Trainer losses within the float32 loss limit, step by step,
    and one collapse reading per step, of cosines and positive gaps."""
    from vlm_first_steps import main
    run, = main(["--steps", "3", "--seq", "32", "--threads", "2"])["runs"]
    assert len(run["port"]["losses"]) == len(run["reference"]) == 3
    assert run["max_rel_gap"] <= TOL["float32"][0]
    assert len(run["port"]["collapse"]) == 3
    assert all(-1 <= r["text_cos"] <= 1 and r["top_logit"] > 0
               for r in run["port"]["collapse"])
