"""Parity of the port's hybrid-family training (``Model.train_loss`` of
recurrentgemma, the RG-LRU scan's backward, the windowed attention's
backward, the decay set, ``param_axes``, ``zero3_units``, two ``Trainer``
steps) with the JAX package's.

Inputs come from numpy seeds and go through both packages; the model's
weights are the reference's, carried across with ``convert.model_params``.
The config is the 5-layer reduced recurrentgemma-9b of
``tests/test_torch_hybrid.py`` (one (rec, rec, attn) unit and a (rec, rec)
tail, d 64, 4 query heads over 1 KV head of 16, window 8, ``lru_width``
64, a vocabulary of 512). Limits (``PERF.md`` §2):

- ``rglru_bwd_ref`` against ``jax.vjp`` of the reference's ``rg_lru``,
  from a nonzero h0 with a nonzero cotangent of h_last and one element
  whose beta takes the 1e-12 clip: each float32 gradient within 1e-5 of
  its largest magnitude; the plain autograd function (``rglru_plain``)
  against ordinary autograd of a ``torch.stack``-built loop, the same;
- a plain emulation of K5''s decomposition (one walk from the end in
  tiles of 44 steps, each element's gates once as a decay and the four
  coefficients its dh multiplies, the chain dh_t = dH_t + a_{t+1}
  dh_{t+1}, each tile row's parameter sums kept apart and added in row
  order) against ``rglru_bwd_ref`` at S = 127, 128, 129, 383 and 385,
  1e-5 (the kernel's own source runs on the CPU in
  ``tests/test_torch_rglru_shim.py``);
- the plain windowed attention backward (autograd of ``attention_ref``
  with the window, and ``attention_bwd_ref`` with it, K3''s equations)
  against ``jax.vjp`` of ``local_attention`` at S = 5, 16 and 24: 1e-5;
- ``train_loss``: the loss and every gradient against
  ``jax.value_and_grad`` of the reference's, at 8 tokens (one window) and
  32 (four): float32 1e-5 / 1e-4 of each leaf's largest magnitude
  (measured: every leaf within 1e-4); bfloat16 the loss within 1e-3 and
  each gradient within 5e-2 of the reference's bfloat16 gradient or, where
  it is not (measured up to 7.4e-2: this model's bfloat16 gradients are at
  the noise floor, the reference's own up to 1.25e-1 from its float32
  ones), no farther from the reference's float32 gradient than the
  reference's bfloat16 gradient, plus 5e-2; remat "full" bit-equal to
  "none"; the plain RG-LRU backward once a rec layer;
- ``param_axes`` equal to the reference's without its stacked axis;
  ``decay_mask`` equal to the reference's ``ndim >= 2`` rule leaf by leaf
  (a unit's vectors decay, stacked there; the tail's do not);
  ``zero3_units``' names and order;
- two ``Trainer`` steps against the reference's at the limits of
  ``tests/test_torch_train.py::test_two_trainer_steps_match_reference``
  (the loss and the gradient norm 1e-5; every master within 1e-5 of its
  leaf's largest magnitude plus 5 % of the summed lr, and at most 1 in
  10,000 entries beyond 1e-5), except where this model's float32
  gradients, 7.2e-6 from the reference's (1.2e-6 in the dense family),
  meet AdamW's normalisation: the zero-initialized vectors are held by
  the bound alone, the moments within 1e-4 (the gradients' own limit);
- the launcher trains the reduced model on the CPU.

K5' and the windowed K3' are held to their plain versions on the card
(marked ``cuda``: skips here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import attention as jax_attention
from repro.models import rglru as jax_rglru
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
from repro_torch.kernels.rglru import (decay_and_input, rglru_bwd_ref,
                                       rglru_plain, rglru_scan,
                                       rglru_scan_bwd, rglru_states_ref)
from repro_torch.kernels.rglru.ref import DECAY_SCALE
from repro_torch.launch import train as launch_train
from repro_torch.models import attention
from repro_torch.models.common import Policy
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                               TrainConfig, Trainer)
from repro_torch.train.trainer import decay_mask

ARCH = "recurrentgemma-9b"
SMALL = dict(num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
             head_dim=16, window=8, lru_width=64, d_ff=128, vocab_size=512)
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 5e-2)}
FN_TOL = 1e-5


def _cfgs():
    return (jax_reduced(jax_get_config(ARCH), **SMALL),
            reduced(get_config(ARCH), **SMALL))


def _pair(dtype, remat="full"):
    jcfg, cfg = _cfgs()
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=getattr(jnp, dtype)))
    params, _ = jm.init_params(jax.random.key(0))
    model = model_params(jax.tree.map(np.asarray, params), cfg,
                         policy=Policy(compute_dtype=getattr(torch, dtype)),
                         device="cpu")
    model.remat = remat
    return jm, params, model


def _randn(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaf_errs(got_tree, want_tree):
    flat_g = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(want_tree)[0])
    assert len(flat_g) == len(want)
    return {jax.tree_util.keystr(path): _rel(g, want[path])
            for path, g in flat_g}


def _lru_inputs(seed, B, S, W=64, clip=True):
    """xb, wa, wi, lam, h0, dH, dh_last; with ``clip`` one element whose
    x wa is -80: its decay rounds to 1 and its beta takes the 1e-12
    clip."""
    rng = np.random.default_rng(seed)
    xb, h0 = _randn(rng, B, S, W), _randn(rng, B, W)
    wa, wi = _randn(rng, W, scale=0.5), _randn(rng, W, scale=0.5)
    lam = _randn(rng, W, shift=0.65)
    dH, dh_last = _randn(rng, B, S, W), _randn(rng, B, W)
    if clip:
        wa[1], xb[0, S // 2, 1] = -2.0, 40.0
    return xb, wa, wi, lam, h0, dH, dh_last


# ------------------------------------------------------ the RG-LRU backward


@pytest.mark.parametrize("B,S", [(2, 13), (1, 1), (3, 40)])
def test_rglru_bwd_ref_matches_reference_vjp(B, S):
    xb, wa, wi, lam, h0, dH, dh_last = _lru_inputs(S, B, S)
    p = {"wa": jnp.asarray(wa), "wi": jnp.asarray(wi),
         "lam": jnp.asarray(lam)}
    (H, last), vjp = jax.vjp(jax_rglru.rg_lru, p, jnp.asarray(xb),
                             jnp.asarray(h0))
    dp, dxb, dh0 = vjp((jnp.asarray(dH), jnp.asarray(dh_last)))
    t = [torch.from_numpy(a) for a in (xb, wa, wi, lam, h0)]
    states, _ = rglru_states_ref(*t)
    if S > 1:      # the clipped element's 1 - exp(2 log_a) is exactly 0
        assert float(1.0 - torch.exp(2.0 * torch.log(
            decay_and_input(t[0], *t[1:4])[0][0, S // 2, 1]))) == 0.0
    got = rglru_bwd_ref(*t, states, torch.from_numpy(dH),
                        torch.from_numpy(dh_last))
    for name, g, w in zip(("dxb", "dwa", "dwi", "dlam", "dh0"), got,
                          (dxb, dp["wa"], dp["wi"], dp["lam"], dh0)):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= FN_TOL, (name, _rel(g, w))


def _stacked_loop(xb, wa, wi, lam, h0):
    a, bx = decay_and_input(xb, wa, wi, lam)
    h, out = h0, []
    for t in range(xb.shape[1]):
        h = a[:, t] * h + bx[:, t]
        out.append(h)
    return torch.stack(out, 1), h


@pytest.mark.parametrize("with_last", [False, True])
def test_plain_autograd_function_matches_autograd_of_a_loop(with_last):
    xb, wa, wi, lam, h0, dH, dh_last = _lru_inputs(7, 2, 21)
    grads = []
    for fn in (rglru_plain, _stacked_loop):
        ts = [torch.from_numpy(a).requires_grad_(True)
              for a in (xb, wa, wi, lam, h0)]
        H, last = fn(*ts)
        loss = (H.float() * torch.from_numpy(dH)).sum()
        if with_last:
            loss = loss + (last * torch.from_numpy(dh_last)).sum()
        loss.backward()
        grads.append([t.grad for t in ts])
    for name, g, w in zip(("xb", "wa", "wi", "lam", "h0"), *grads):
        assert _rel(g, w) <= FN_TOL, (name, _rel(g, w))


def _walked_like_the_kernel(xb, wa, wi, lam, h0, H, dH, dh_last,
                            steps=44):
    """K5''s decomposition in plain float32: each batch row walked once
    from its end in tiles of ``steps`` steps (its float32 tile); every
    element's gates computed once, as its decay a and the four
    coefficients that its dh multiplies (dxb's, and the dwa, dwi and dlam
    terms': all linear in dh); the chain dh_t = dH_t + a_{t+1} dh_{t+1};
    the parameter sums kept apart for each row of a tile (a worker's) over
    the tiles in walk order, then added in row order, then over the batch
    in order. This holds the decomposition, not the kernel: the kernel's
    own source runs on the CPU in ``tests/test_torch_rglru_shim.py``."""
    B, S, W = xb.shape
    c = -DECAY_SCALE * torch.nn.functional.softplus(lam)
    ra = torch.sigmoid(xb * wa)
    log_a = c * ra
    a, e2 = torch.exp(log_a), torch.exp(2.0 * log_a)
    u = 1.0 - e2
    bt = torch.sqrt(torch.clamp_min(u, 1e-12))
    gi = torch.sigmoid(xb * wi)
    hp = torch.cat([h0[:, None], H[:, :-1]], dim=1)
    m = hp * a - torch.where(u > 1e-12, e2 * gi * xb / bt,
                             torch.zeros_like(u))
    sa = c * ra * (1.0 - ra) * m
    si = bt * xb * gi * (1.0 - gi)
    k_dx = bt * gi + sa * wa + si * wi
    k_sum = torch.stack([sa * xb, si * xb, m * ra])          # (3, B, S, W)
    dh = torch.empty_like(xb)
    g, a_next = dh_last.clone(), torch.ones(B, W)
    for t in range(S - 1, -1, -1):
        g = dH[:, t] + a_next * g
        dh[:, t], a_next = g, a[:, t]
    rows = torch.zeros(steps, 3, B, W)           # a tile row's sums
    nt = -(-S // steps)
    for i in range(nt):                          # walk order
        for r in range(steps):
            t = S - (i + 1) * steps + r
            if t >= 0:
                rows[r] += dh[:, t] * k_sum[:, :, t]
    sums = rows.sum(0)                           # in row order
    dlam = -DECAY_SCALE * torch.sigmoid(lam) * sums[2].sum(0)
    return (dh * k_dx, sums[0].sum(0), sums[1].sum(0), dlam,
            a[:, 0] * dh[:, 0])


@pytest.mark.parametrize("S", [127, 128, 129, 383, 385])
def test_kernel_chunk_decomposition_matches_plain(S):
    xb, wa, wi, lam, h0, dH, dh_last = (torch.from_numpy(a) for a in
                                        _lru_inputs(50 + S, 2, S))
    states, _ = rglru_states_ref(xb, wa, wi, lam, h0)
    want = rglru_bwd_ref(xb, wa, wi, lam, h0, states, dH, dh_last)
    got = _walked_like_the_kernel(xb, wa, wi, lam, h0, states, dH,
                                  dh_last)
    for name, g, w in zip(("dxb", "dwa", "dwi", "dlam", "dh0"), got, want):
        assert _rel(g, w) <= FN_TOL, (name, _rel(g, w))


# -------------------------------------------- the windowed attention backward


@pytest.mark.parametrize("S", [5, 16, 24])
def test_windowed_attention_backward_matches_reference(S):
    rng = np.random.default_rng(40 + S)
    q = _randn(rng, 2, S, 4, 16)
    k, v = _randn(rng, 2, S, 1, 16), _randn(rng, 2, S, 1, 16)
    do = _randn(rng, 2, S, 4, 16)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention.local_attention(
        a, b, c, window=8), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    attention.local_attention(*ts, window=8).backward(torch.from_numpy(do))
    for name, t, w in zip(("dq", "dk", "dv"), ts, want):
        assert _rel(t.grad, w) <= FN_TOL, (name, _rel(t.grad, w))
    # K3''s equations with the window, from the plain forward's o and lse
    qt, kt, vt, dot = (torch.from_numpy(a).transpose(1, 2)
                       for a in (q, k, v, do))
    o, lse = attention_ref(qt, kt, vt, causal=True, window=8,
                           return_lse=True)
    got = attention_bwd_ref(qt, kt, vt, o, lse, dot, causal=True, window=8)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g.transpose(1, 2), w) <= FN_TOL, name


# ------------------------------------------------------------- train_loss


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


def _reference_grads(jm, params, batch):
    return jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})


@pytest.mark.parametrize("S", [8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_grads_match_reference(dtype, S):
    jm, params, model = _pair(dtype)
    batch = _batch(model.cfg.vocab_size, S=S)
    (jloss, jmet), jgrads = _reference_grads(jm, params, batch)
    loss, metrics, grads = _port_grads(model, batch)
    ltol, gtol = TOL[dtype]
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert float(loss) == pytest.approx(float(jloss), rel=ltol)
    assert float(metrics["ce"]) == float(loss)
    assert float(metrics["aux"]) == float(jmet["aux"]) == 0.0
    errs = _leaf_errs(reference_tree(grads), jax.tree.map(np.asarray,
                                                          jgrads))
    if dtype == "float32":
        worst = max(errs, key=errs.get)
        assert errs[worst] <= gtol, (worst, errs[worst])
        return
    # bfloat16: this model's gradients are at the bfloat16 noise floor.
    # The reference's own bfloat16 gradients lie up to 1.25e-1 of a leaf's
    # largest magnitude from its float32 ones (the port's up to 9.9e-2),
    # and the two frameworks' bfloat16 gradients up to 7.4e-2 apart, the
    # same with the attention's probabilities rounded as XLA rounds them
    # or XLA's excess precision off; the port against itself with the
    # RG-LRU states times (1 + 1e-4 N(0, 1)) before their cast (a few
    # bfloat16 roundings flipped) moves them up to 5.3e-2. A leaf within gtol of the reference's
    # bfloat16 gradient passes; any other must lie no farther from the
    # reference's float32 gradient than the reference's own bfloat16 one,
    # plus gtol.
    jm32, params32, _ = _pair("float32")
    _, j32 = _reference_grads(jm32, params32, batch)
    exact = jax.tree.map(np.asarray, j32)
    port_gap = _leaf_errs(reference_tree(grads), exact)
    ref_gap = _leaf_errs(jax.tree.map(np.asarray, jgrads), exact)
    over = {n: (errs[n], port_gap[n], ref_gap[n]) for n in errs
            if errs[n] > gtol and port_gap[n] > ref_gap[n] + gtol}
    assert not over, over


def test_remat_recomputes_the_same_numbers():
    _, _, full = _pair("float32", remat="full")
    _, _, none = _pair("float32", remat="none")
    batch = _batch(full.cfg.vocab_size, seed=1)
    lf, _, gf = _port_grads(full, batch)
    ln, _, gn = _port_grads(none, batch)
    assert float(lf) == float(ln)
    for name in gf:
        assert torch.equal(gf[name], gn[name]), name


def test_step_runs_the_plain_rglru_backward_once_a_rec_layer(monkeypatch):
    import repro_torch.kernels.rglru.ops as ops
    calls = []
    bwd = ops.rglru_bwd_ref

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return bwd(*a, **kw)

    monkeypatch.setattr(ops, "rglru_bwd_ref", counted)
    _, _, model = _pair("float32")
    _port_grads(model, _batch(model.cfg.vocab_size, S=16))
    assert calls == [(2, 16, 64)] * 4        # the unit's two, the tail's two


def test_windowed_call_longer_than_the_window_must_be_a_multiple():
    _, _, model = _pair("float32")
    with pytest.raises(ValueError, match="multiple"):
        _port_grads(model, _batch(model.cfg.vocab_size, S=12))


# ------------------------------------- axes, decay set, ZeRO-3 units, convert


def _strip(axes):
    return axes[1:] if axes and axes[0] == "layer" else axes


def _reference_axes(jm):
    """{port parameter name: logical axes} of the reference's
    ``param_axes`` tree, its stacked "layer" axis dropped."""
    tree = jm.param_axes()
    n_units = SMALL["num_layers"] // 3
    out = {}

    def walk(node, prefix):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}.")
            else:
                out[f"{prefix}{key}"] = tuple(_strip(tuple(val)))
    walk({k: v for k, v in tree.items() if k not in ("units", "tail")}, "")
    for u in range(n_units):
        walk(tree["units"], f"units.{u}.")
    for i, lp in enumerate(tree["tail"]):
        walk(lp, f"tail.{i}.")
    return out


def test_param_axes_are_the_references():
    jm, _, model = _pair("float32")
    got = {n: tuple(a) for n, a in model.param_axes().items()}
    assert got == _reference_axes(jm)
    assert got["units.0.l0_rec.rec.wa"] == ("lru",)
    assert got["units.0.l2_attn.attn.wq"][0] == "fsdp"


def test_decay_set_is_the_references():
    _, params, model = _pair("float32")
    want = jax.tree.map(lambda x: np.asarray(np.ndim(x) >= 2, np.float32),
                        params)
    mask = decay_mask(model)
    got = reference_tree({n: np.asarray(d, np.float32)
                          for n, d in mask.items()})
    assert max(_leaf_errs(got, want).values()) == 0.0
    # stacked there, a unit's vectors decay; the tail's, a list, do not
    for name in ("units.0.l0_rec.rec.wa", "units.0.l1_rec.rec.lam",
                 "units.0.l0_rec.rec.conv_b", "units.0.l2_attn.ln_attn",
                 "units.0.l1_rec.ln_rec"):
        assert mask[name], name
    for name in ("tail.0.rec.wa", "tail.1.rec.lam", "tail.0.rec.conv_b",
                 "tail.1.ln_mlp", "ln_f"):
        assert not mask[name], name
    assert mask["tail.0.rec.wx"] and mask["embed.tok"]


def test_zero3_units_names_and_order():
    _, _, model = _pair("float32")
    units = model.zero3_units()
    assert list(units) == ["in", "units.0", "tail", "out"]
    assert units["in"] == ["embed.tok"] and units["out"] == ["ln_f"]
    assert all(n.startswith("units.0.") for n in units["units.0"])
    assert all(n.startswith("tail.") for n in units["tail"])
    names = [n for n, _ in model.named_parameters()]
    assert sorted(sum(units.values(), [])) == sorted(names)


def test_convert_round_trips_parameters_and_optimizer_state():
    _, params, model = _pair("float32")
    tree = jax.tree.map(np.asarray, params)
    assert max(_leaf_errs(reference_tree(dict(model.named_parameters())),
                          tree).values()) == 0.0
    flat = named_params(tree, len(model.units))
    assert set(flat) == set(dict(model.named_parameters()))
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
    jdata = JaxSyntheticLM(JaxDataConfig(jcfg.vocab_size, 32, 2))
    ref = JaxTrainer(jm, jdata, JaxTrainConfig(
        steps=2, ckpt_interval=100, opt=JaxAdamWConfig(**opt)), seed=0)
    init = jax.tree.map(np.asarray, ref.params)
    ref_out = ref.run()
    model = model_params(init, cfg, policy=Policy(compute_dtype=torch.float32),
                         device="cpu")
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 2))
    tr = Trainer(model, data, TrainConfig(steps=2, ckpt_interval=100,
                                          opt=AdamWConfig(**opt)))
    out = tr.run()
    assert out["final_step"] == ref_out["final_step"] == 2
    for h, rh in zip(out["history"], ref_out["history"]):
        assert h["loss"] == pytest.approx(rh["loss"], rel=1e-5)
        assert h["grad_norm"] == pytest.approx(rh["grad_norm"], rel=1e-5)
        assert h["lr"] == pytest.approx(rh["lr"], rel=1e-6)
    # Every master within 1e-5 of its leaf's largest magnitude plus 5 % of
    # the summed lr. Of the leaves drawn at init, at most 1 in 10^4
    # entries beyond 1e-5 (AdamW's ratio m / (sqrt(v) + eps) is
    # ill-conditioned there); the zero-initialized norm scales and conv
    # biases, whose largest magnitude after two steps is about the summed
    # lr itself, are held by the bound alone (measured: 59 of their 1,600
    # entries beyond 1e-5 of it, 14 of the other 216,192 entries). The
    # float32 gradients agree to 7.2e-6 of a leaf's largest magnitude here
    # (1.2e-6 in the dense family): the moments within the gradients' own
    # limit, 1e-4 (measured: 5.0e-5, the second moment of lam's gradient).
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


def test_launcher_trains_the_reduced_hybrid_on_the_cpu(tmp_path, capsys):
    assert launch_train.main(["--arch", ARCH, "--device", "cpu", "--steps",
                              "4", "--seq-len", "64", "--batch", "2",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert ARCH in out and "done: 4 steps" in out


# -------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W,dtype", [(1, 4096, 4096, "bfloat16"),
                                         (2, 385, 300, "float32"),
                                         (3, 37, 33, "bfloat16"),
                                         (1, 1, 64, "float32")])
def test_rglru_bwd_kernel_matches_plain_on_card(cuda, B, S, W, dtype):
    xb, wa, wi, lam, h0, dH, dh_last = (torch.from_numpy(a).to(cuda) for a
                                        in _lru_inputs(S, B, S, W,
                                                       clip=W > 1))
    xb, dH = xb.to(getattr(torch, dtype)), dH.to(getattr(torch, dtype))
    H, _, states = rglru_scan(xb, wa, wi, lam, h0, keep_states=True)
    got = rglru_scan_bwd(xb, wa, wi, lam, h0, states, dH, dh_last)
    again = rglru_scan_bwd(xb, wa, wi, lam, h0, states, dH, dh_last)
    want = rglru_bwd_ref(xb.float(), wa, wi, lam, h0, states, dH.float(),
                         dh_last)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for name, g, w in zip(("dxb", "dwa", "dwi", "dlam", "dh0"), got, want):
        tol = 1e-4 if g.dtype == torch.float32 else 2.0 ** -7
        assert _rel(g.cpu(), w.cpu()) <= tol, (name, _rel(g.cpu(),
                                                          w.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("S,window,dtype,tol",
                         [(4096, 2048, "bfloat16", 2e-2),
                          (4096, 2048, "float32", 1e-5),
                          (1000, 256, "bfloat16", 2e-2)])
def test_windowed_flash_attention_bwd_matches_plain_on_card(cuda, S, window,
                                                            dtype, tol):
    rng = np.random.default_rng(S)
    q, k, v, do = (torch.from_numpy(_randn(rng, 1, S, h, 256)).to(
        cuda, getattr(torch, dtype)).transpose(1, 2) for h in (16, 1, 1, 16))
    kw = dict(causal=True, window=window)
    o, lse = flash_attention(q, k, v, lse=True, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    o_ref, lse_ref = attention_ref(q, k, v, return_lse=True, **kw)
    want = attention_bwd_ref(q, k, v, o_ref, lse_ref, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g.cpu(), w.cpu()) <= tol, name
