"""Parity of the port's audio-family training (``Model.train_loss`` of
whisper, its remat, ``param_axes``, ``zero3_units``, the decay set,
``convert``'s two stacked trees, two ``Trainer`` steps, the launcher)
with the JAX package's.

Inputs come from numpy seeds and go through both packages; the model's
weights are the reference's, carried across with ``convert.model_params``.
The config is the reduced whisper-small of ``tests/test_torch_audio.py``
(2 encoder and 2 decoder layers, d 128, 4 query heads over 2 KV heads of
32, 16 encoder frames); each batch is a ``SyntheticLM`` batch with seeded
frames (``torch_dist_workers.WithFrames``). Limits (``PERF.md`` §2):

- ``train_loss``: the loss and every gradient against
  ``jax.value_and_grad`` of the reference's: float32 1e-5 / 1e-4 of each
  leaf's largest magnitude; bfloat16 1e-3 / 5e-2. The encoder output's
  gradient sums the cross K/V products of both decoder layers and the
  encoder's own path: ``pos_enc``'s and every ``enc_layers`` gradient
  holds it;
- remat "full" bit-equal to "none"; a step calls the attention twice a
  layer (the forward and the recompute: the encoder's self attention,
  the decoder's self and cross attention), the count that the card's
  step gives K3 (72 for whisper-small's 12 + 12 layers);
- ``param_axes`` equal to the reference's without its stacked axis;
  ``decay_mask`` equal to the reference's ``ndim >= 2`` rule leaf by leaf
  (every stacked layer parameter decays, vectors included, and
  ``pos_enc`` / ``pos_dec``; ``ln_enc`` and ``ln_f`` do not);
  ``zero3_units`` (every parameter once, in the forward's order);
  ``model_params``, ``named_params``, ``opt_state`` and
  ``reference_tree`` round trips over the two stacks;
- two ``Trainer`` steps against the reference's at the limits of
  ``tests/test_torch_train.py::test_two_trainer_steps_match_reference``;
- the training launcher, which feeds ``SyntheticLM`` batches without
  frames, raises a ``KeyError`` naming ``enc_frames`` in both packages.

K3 and K3' at whisper-small's encoder, cross-attention and decoder
shapes are held to their plain versions on the card (marked ``cuda``:
skips here).
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
from repro_torch.configs import get_config, reduced
from repro_torch.convert import (model_params, named_params, opt_state,
                                 reference_tree)
from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.launch import train as launch_train
from repro_torch.models import attention
from repro_torch.models.common import Policy
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                               TrainConfig, Trainer)
from repro_torch.train.trainer import decay_mask

from torch_dist_workers import WithFrames

ARCH = "whisper-small"
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 5e-2)}


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


def _data(cfg, B=2, S=16, seed=0):
    return WithFrames(SyntheticLM(DataConfig(cfg.vocab_size, S, B,
                                             seed=seed)),
                      cfg.encoder_seq_len, cfg.d_model, seed)


def _batch(cfg, seed=0, S=16):
    b = _data(cfg, S=S, seed=seed).batch_at(0)
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


# ----------------------------------------------------------- train_loss


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_grads_match_reference(dtype):
    jm, params, model = _pair(dtype)
    batch = _batch(model.cfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_grads(model, batch)
    ltol, gtol = TOL[dtype]
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert float(loss) == pytest.approx(float(jloss), rel=ltol)
    assert float(metrics["ce"]) == float(loss)
    assert float(metrics["aux"]) == float(jmet["aux"]) == 0.0
    errs = _leaf_errs(reference_tree(grads), jax.tree.map(np.asarray,
                                                          jgrads))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= gtol, (worst, errs[worst])
    # the encoder's gradient arrives through both decoder layers' cross
    # K/V: it is not zero
    assert float(grads["pos_enc"].abs().max()) > 0
    assert float(grads["enc_layers.0.attn.wq"].abs().max()) > 0


def test_remat_recomputes_the_same_numbers():
    _, _, full = _pair("float32", remat="full")
    _, _, none = _pair("float32", remat="none")
    batch = _batch(full.cfg, seed=1)
    lf, _, gf = _port_grads(full, batch)
    ln, _, gn = _port_grads(none, batch)
    assert float(lf) == float(ln)
    for name in gf:
        assert torch.equal(gf[name], gn[name]), name


def test_step_calls_attention_twice_a_layer(monkeypatch):
    """Under remat "full" each attention runs in the forward and again in
    the recompute: 2 x (2 encoder + 2 x 2 decoder) = 12 calls a step, the
    encoder's full ones over its 16 frames, the decoder's causal ones over
    its 8 tokens and its cross ones from them over the 16 frames."""
    calls = []
    flash = attention.flash

    def counted(q, k, v, *, causal, **kw):
        calls.append((q.shape[1], k.shape[1], causal))
        return flash(q, k, v, causal=causal, **kw)

    monkeypatch.setattr(attention, "flash", counted)
    _, _, model = _pair("float32")
    _port_grads(model, _batch(model.cfg, S=8))
    enc, cross, self_ = (16, 16, False), (8, 16, False), (8, 8, True)
    assert sorted(calls) == sorted([enc] * 4 + [cross] * 4 + [self_] * 4)
    assert sum(c[2] for c in calls) == 4


def test_rounded_dq_is_ill_conditioned_where_keys_share_a_component():
    """Why phase 22 of ``chip_smoke.py`` holds K3' to
    ``attention_bwd_ref(..., bf16_operands=True)``: each query's dS sums to
    zero over the keys, so dQ = scale dS K sees only how the keys vary;
    rounding dS to bfloat16, as the kernel does, breaks that sum, and the
    error then scales with the keys' common component. On random keys the
    rounded backward stays within K3B_TOL (2e-2) of the float32 one; with
    a common component added to every key (it changes no score's softmax,
    only the rounding's reach), 30 times the keys' spread, dq moves beyond
    it (measured 5.0e-2) while dk and dv do not."""
    rng = np.random.default_rng(9)
    B, H, S, T, hd = 1, 2, 64, 96, 32

    def gaps(shift):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (B, H, n, hd), dtype=np.float32)).bfloat16()
            for n in (S, T, T, S))
        k = (k.float() + shift * torch.from_numpy(rng.standard_normal(
            (1, 1, 1, hd), dtype=np.float32))).bfloat16()
        o, lse = attention_ref(q, k, v, causal=False, return_lse=True)
        exact = attention_bwd_ref(q, k, v, o, lse, do, causal=False)
        rounded = attention_bwd_ref(q, k, v, o, lse, do, causal=False,
                                    bf16_operands=True)
        return [_rel(a, b.float().numpy()) for a, b in zip(rounded, exact)]
    assert max(gaps(0.0)) <= 2e-2
    dq, dk, dv = gaps(30.0)
    assert dq > 2e-2 and max(dk, dv) <= 2e-2, (dq, dk, dv)


# ------------------------------------- axes, decay set, ZeRO-3 units, convert


def _reference_names(tree, fn):
    """{port parameter name: fn(leaf)} of a reference tree, its stacked
    subtrees unstacked (``fn`` gets the stacked leaf)."""
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = fn(val)
    stacks = ("enc_layers", "dec_layers")
    walk({k: v for k, v in tree.items() if k not in stacks}, "")
    for stack in stacks:
        for i in range(2):
            walk(tree[stack], f"{stack}.{i}.")
    return out


def test_param_axes_are_the_references():
    jm, _, model = _shared("float32")
    got = {n: tuple(a) for n, a in model.param_axes().items()}
    want = _reference_names(
        jm.param_axes(),
        lambda ax: tuple(ax)[1:] if ax and ax[0] == "layer" else tuple(ax))
    assert got == want
    assert got["pos_enc"] == got["pos_dec"] == (None, "fsdp")
    assert got["ln_enc"] == (None,)
    assert got["dec_layers.1.cross.wq"] == ("fsdp", "heads")


def test_decay_set_is_the_references():
    _, params, model = _shared("float32")
    want = jax.tree.map(lambda x: np.asarray(np.ndim(x) >= 2, np.float32),
                        params)
    mask = decay_mask(model)
    got = reference_tree({n: np.asarray(d, np.float32)
                          for n, d in mask.items()})
    assert max(_leaf_errs(got, want).values()) == 0.0
    for name in ("enc_layers.0.ln_attn", "enc_layers.1.ln_mlp",
                 "dec_layers.0.ln_cross", "dec_layers.1.ln_attn",
                 "pos_enc", "pos_dec", "embed.tok", "embed.head"):
        assert mask[name], name
    for name in ("ln_enc", "ln_f"):
        assert not mask[name], name


def test_zero3_units_names_and_order():
    _, _, model = _shared("float32")
    units = model.zero3_units()
    assert list(units) == ["in", "enc_layers.0", "enc_layers.1",
                           "dec_layers.0", "dec_layers.1", "out"]
    assert sorted(units["in"]) == ["embed.tok", "ln_enc", "pos_dec",
                                   "pos_enc"]
    assert sorted(units["out"]) == ["embed.head", "ln_f"]
    for unit in units:
        if unit not in ("in", "out"):
            assert all(n.startswith(f"{unit}.") for n in units[unit])
    names = [n for n, _ in model.named_parameters()]
    every = sum(units.values(), [])
    assert len(every) == len(set(every)) and sorted(every) == sorted(names)


def test_convert_round_trips_parameters_and_optimizer_state():
    _, params, model = _shared("float32")
    tree = jax.tree.map(np.asarray, params)
    assert max(_leaf_errs(reference_tree(dict(model.named_parameters())),
                          tree).values()) == 0.0
    flat = named_params(tree, {"enc_layers": 2, "dec_layers": 2})
    assert set(flat) == set(dict(model.named_parameters()))
    with pytest.raises(ValueError):      # a stack's depth is checked
        named_params(tree, {"enc_layers": 3, "dec_layers": 2})
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
    opt = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jcfg, cfg = _cfgs()
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=jnp.float32))
    jdata = WithFrames(JaxSyntheticLM(JaxDataConfig(jcfg.vocab_size, 16, 2)),
                       jcfg.encoder_seq_len, jcfg.d_model)
    ref = JaxTrainer(jm, jdata, JaxTrainConfig(
        steps=2, ckpt_interval=100, opt=JaxAdamWConfig(**opt)), seed=0)
    init = jax.tree.map(np.asarray, ref.params)
    ref_out = ref.run()
    model = model_params(init, cfg, policy=Policy(compute_dtype=torch.float32),
                         device="cpu")
    tr = Trainer(model, _data(cfg), TrainConfig(steps=2, ckpt_interval=100,
                                                opt=AdamWConfig(**opt)))
    out = tr.run()
    assert out["final_step"] == ref_out["final_step"] == 2
    for h, rh in zip(out["history"], ref_out["history"]):
        assert h["loss"] == pytest.approx(rh["loss"], rel=1e-5)
        assert h["grad_norm"] == pytest.approx(rh["grad_norm"], rel=1e-5)
        assert h["lr"] == pytest.approx(rh["lr"], rel=1e-6)
    # every master within 1e-5 of its leaf's largest magnitude plus 5 % of
    # the summed lr, and at most 1 in 10^4 entries of the leaves drawn at
    # init beyond 1e-5 (AdamW's m / (sqrt(v) + eps) is ill-conditioned
    # there; the zero-initialized norm scales are held by the bound)
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


def test_launcher_raises_on_batches_without_frames(tmp_path):
    """Both packages' training launchers feed ``SyntheticLM`` batches,
    which hold no frames: both stop at the first step on the missing
    key, and the port invents no input."""
    argv = ["--arch", ARCH, "--steps", "1", "--seq-len", "8", "--batch",
            "2"]
    with pytest.raises(KeyError, match="enc_frames"):
        jax_launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "jax")])
    with pytest.raises(KeyError, match="enc_frames"):
        launch_train.main(argv + ["--device", "cpu", "--ckpt-dir",
                                  str(tmp_path / "port")])


# -------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


# B, Hq, Hkv, S, T, causal: whisper-small's encoder self attention over
# its 1,500 frames (23.4 tiles of 64), its decoder's cross attention from
# 448 tokens over them, and its decoder's causal self attention
WHISPER_SHAPES = [(2, 12, 12, 1500, 1500, False),
                  (2, 12, 12, 448, 1500, False),
                  (2, 12, 12, 448, 448, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,Hq,Hkv,S,T,causal", WHISPER_SHAPES)
def test_flash_attention_at_whisper_shapes_matches_plain_on_card(
        cuda, B, Hq, Hkv, S, T, causal, dtype):
    """K3 and K3' at hd 64 against their plain versions, at the limits of
    ``chip_smoke.py`` phases 5 and 9 (``K3_TOL``, ``K3B_TOL``), the
    inputs in the model layout seen through transposes."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S + T)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda, dt).transpose(1, 2)
        for shape in ((B, S, Hq, 64), (B, T, Hkv, 64), (B, T, Hkv, 64),
                      (B, S, Hq, 64)))
    tol, btol = {"bfloat16": (3e-2, 2e-2), "float32": (2e-5, 1e-5)}[dtype]
    o, lse = flash_attention(q, k, v, causal=causal, lse=True)
    o_ref, lse_ref = attention_ref(q, k, v, causal=causal, return_lse=True)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = attention_bwd_ref(q, k, v, o_ref, lse_ref, do, causal=causal)
    for g, w in zip(got, want):
        assert _rel(g, w.float().cpu().numpy()) <= btol
