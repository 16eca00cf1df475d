"""Parity of the port's moe family (``repro_torch.models.moe`` and the moe
``Model``) with the JAX package's ``repro.models.moe`` and ``Model``.

Inputs come from numpy seeds and go through both packages; the weights
are the reference's, carried across with ``convert.model_params``.
Limits:

- ``route`` and ``dispatch_compute_combine`` against ``_route`` and
  ``_dispatch_compute_combine`` in float32: the experts equal, each
  slot's keep bit equal to the plain rule (a slot is kept while fewer
  than C earlier slots, in flat (token, choice) order, chose its expert),
  the weights, aux and routed output within 1e-5 (measured: ~3e-7);
- ties: router weights of zero make every probability equal, and both
  packages choose experts 0..k-1;
- drops: ``capacity_factor=0.5`` makes the reference drop slots (its
  output differs from the same call without a capacity cut), and the
  port drops the same ones;
- reduced deepseek-moe-16b (a dense first layer, two shared experts
  reduced to one, top-2 of 4) and llama4-scout-17b-a16e (top-1 of 4, a
  shared expert): prefill and three decode steps at float32 1e-4 and
  bfloat16 5e-2 (the limits of ``tests/test_torch_models.py``) on eight
  rows, six of which hold one sequence and take one token a step: their
  hidden states are equal, so they choose equal experts, and every decode
  step drops slots in every MoE layer (C is 5 for deepseek's top-2, 3 for
  llama4's top-1, against six equal slots an expert);
- routing, in both of the above: in float32 every call's experts equal
  the reference's. In bfloat16 the two frameworks round the hidden states
  differently (the port's CPU attention keeps its probabilities in
  float32 where XLA rounds them to bfloat16), so a near-tied choice can
  flip: each slot whose expert differs must be a tie within ``TIE_EPS``
  of the port's own probabilities (measured: 1 to 9 flipped slots a
  test, margins up to 1.1e-2). A flip changes that token's output by
  O(1), and, where its expert is full, which later slots drop (one flip
  a layer puts reduced llama4's bf16 loss outside 1e-3), so the
  bfloat16 values are then held on the same routing: the port takes the
  reference's experts call by call (``_Routes.forced``), with its
  own probabilities, and everything else is the port's;
- ``BatchedServer`` token streams, token for token in float32;
- ``train_loss``, its ce and aux and every gradient at float32 1e-5 /
  1e-4 and bfloat16 1e-3 / 5e-2 of each leaf's largest magnitude (the
  dense family's limits, ``tests/test_torch_train.py``), at capacity
  factors 1.25 and 0.5 (on these inputs both drop slots);
- two ``Trainer`` steps against the reference's (float32), as
  ``tests/test_torch_train.py`` holds the dense family, the moments
  within 2e-5 of each leaf's largest magnitude (as the ssm family's:
  measured 1.1e-5, the second moment of llama4's router gradient);
- AdamW's decay set equal to the reference's ``ndim >= 2`` rule on its
  stacked tree (``dense0`` is not stacked: its norms do not decay);
- ``convert``: parameters and optimizer state round-trip exactly.

The four-rank ZeRO-3 step of reduced deepseek-moe-16b is held to the
reference in ``tests/test_torch_dist_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import serve as jax_serve
from repro.models import moe as jax_moe
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
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models.common import Policy
from repro_torch.models.model import Model
from repro_torch.train import (AdamWConfig, DataConfig, SyntheticLM,
                               TrainConfig, Trainer)
from repro_torch.train.trainer import decay_mask

ARCHS = ("deepseek-moe-16b", "llama4-scout-17b-a16e")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TRAIN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 5e-2)}
# a bfloat16 routing flip between the packages: the two experts' port
# probabilities within TIE_EPS (measured: up to 1.1e-2, on probabilities
# near 1/4)
TIE_EPS = 2e-2


def _cfgs(arch, **moe_kw):
    """The reduced config of both packages, with MoE fields replaced."""
    jcfg, cfg = jax_reduced(jax_get_config(arch)), reduced(get_config(arch))
    if moe_kw:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _pair(arch, dtype, remat="full", **moe_kw):
    jcfg, cfg = _cfgs(arch, **moe_kw)
    jm = JaxModel(jcfg, JaxPolicy(compute_dtype=getattr(jnp, dtype)))
    params, _ = jm.init_params(jax.random.key(0))
    model = model_params(jax.tree.map(np.asarray, params), cfg,
                         policy=Policy(compute_dtype=getattr(torch, dtype)),
                         device="cpu")
    model.remat = remat
    return jm, params, model


def _np(x):
    return np.asarray(x, np.float32)


def _keep_rule(idx: np.ndarray, C: int) -> np.ndarray:
    """The plain rule: slot s (flat (token, choice) order) is kept while
    fewer than C earlier slots chose its expert."""
    flat = idx.reshape(-1)
    seen: dict = {}
    keep = np.zeros(flat.size, bool)
    for s, e in enumerate(flat):
        keep[s] = seen.get(int(e), 0) < C
        seen[int(e)] = seen.get(int(e), 0) + 1
    return keep


def _port_keep(idx: torch.Tensor, C: int, E: int) -> np.ndarray:
    order, dest, c = moe.plan_slots(idx, capacity=C, num_experts=E)
    keep = torch.empty_like(dest, dtype=torch.bool)
    keep[order] = dest < E * c
    return keep.numpy()


def _moe_inputs(cfg, T, seed, router_scale=1.0):
    rng = np.random.default_rng(seed)
    m, d = cfg.moe, cfg.d_model
    x = rng.standard_normal((2, T // 2, d)).astype(np.float32)
    router = (rng.standard_normal((d, m.num_experts)) / np.sqrt(d)
              * router_scale).astype(np.float32)
    wi = (rng.standard_normal((m.num_experts, d, 2 * m.expert_d_ff))
          / np.sqrt(d)).astype(np.float32)
    wo = (rng.standard_normal((m.num_experts, m.expert_d_ff, d))
          / np.sqrt(m.expert_d_ff)).astype(np.float32)
    return x, router, wi, wo


def _route_both(cfg, x, router):
    m = cfg.moe
    jw, jidx, jaux = jax_moe._route(jnp.asarray(router), jnp.asarray(x),
                                    m.num_experts, m.top_k)
    w, idx, aux = moe.route(torch.from_numpy(router), torch.from_numpy(x),
                            m.num_experts, m.top_k)
    return (jw, jidx, jaux), (w, idx, aux)


def _dcc_both(cfg, x, idx_np, w_np, wi, wo, C):
    m = cfg.moe
    want = jax_moe._dispatch_compute_combine(
        jnp.asarray(x), jnp.asarray(idx_np, jnp.int32), jnp.asarray(w_np),
        jnp.asarray(wi), jnp.asarray(wo), act=cfg.act, capacity=C,
        num_experts=m.num_experts, top_k=m.top_k, ep_axis=None)
    got = moe.dispatch_compute_combine(
        torch.from_numpy(x), torch.from_numpy(idx_np.astype(np.int64)),
        torch.from_numpy(w_np), torch.from_numpy(wi), torch.from_numpy(wo),
        capacity=C, num_experts=m.num_experts, top_k=m.top_k)
    return _np(want), got.numpy()


# ------------------------------------------------------------- the block


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [128, 6])
def test_route_and_dispatch_match_reference(arch, T):
    _, cfg = _cfgs(arch)
    m = cfg.moe
    x, router, wi, wo = _moe_inputs(cfg, T, seed=T)
    (jw, jidx, jaux), (w, idx, aux) = _route_both(cfg, x, router)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), _np(jw), atol=1e-5, rtol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    C = moe.capacity(T, cfg)
    np.testing.assert_array_equal(_port_keep(idx, C, m.num_experts),
                                  _keep_rule(np.asarray(jidx), C))
    want, got = _dcc_both(cfg, x, np.asarray(jidx), _np(jw), wi, wo, C)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_ties_choose_the_lowest_experts_as_the_reference(arch):
    _, cfg = _cfgs(arch)
    m = cfg.moe
    x, router, _, _ = _moe_inputs(cfg, 16, seed=1, router_scale=0.0)
    (jw, jidx, jaux), (w, idx, aux) = _route_both(cfg, x, router)
    want = np.broadcast_to(np.arange(m.top_k), idx.shape)
    np.testing.assert_array_equal(np.asarray(jidx), want)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_allclose(w.numpy(), 1.0 / m.top_k, rtol=1e-6)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_the_references_slots(arch):
    _, cfg = _cfgs(arch, capacity_factor=0.5)
    m = cfg.moe
    T = 64
    x, router, wi, wo = _moe_inputs(cfg, T, seed=3)
    (jw, jidx, _), (w, idx, _) = _route_both(cfg, x, router)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    C = moe.capacity(T, cfg)
    keep = _keep_rule(np.asarray(jidx), C)
    assert not keep.all()
    np.testing.assert_array_equal(_port_keep(idx, C, m.num_experts), keep)
    want, got = _dcc_both(cfg, x, np.asarray(jidx), _np(jw), wi, wo, C)
    uncut, _ = _dcc_both(cfg, x, np.asarray(jidx), _np(jw), wi, wo,
                         T * m.top_k)
    assert np.abs(want - uncut).max() > 1e-2      # the reference dropped
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_expert_parallel_context_raises():
    _, cfg = _cfgs("llama4-scout-17b-a16e")
    model = Model(cfg, device="cpu")

    class Mesh:                      # a stand-in with "model" of width 2
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 2}
    from repro_torch.dist import api as dist
    x = torch.zeros((1, 4, cfg.d_model), dtype=torch.bfloat16)
    # expert parallelism is ported: experts left whole (a model built
    # outside the mesh) under a mesh that would split them raise
    with dist.use_mesh(Mesh()), pytest.raises(ValueError,
                                              match="build the model under"):
        moe.apply_moe(model.layers[0].moe, cfg, x)


# ------------------------------------------------------------ serving


class _Routes:
    """Both packages' routing, call by call. ``reference(fn)`` runs ``fn``
    with the reference's ``_route`` recording its experts (a host
    callback, in call order); the port's ``_top_k`` then records its own
    experts and probabilities (``forced=False``) or takes the reference's
    experts, call by call, with its own probabilities (``forced=True``),
    and every dispatch counts the slots the capacity dropped."""

    def __init__(self, monkeypatch):
        self.mp = monkeypatch
        self.ref, self.port, self.probs, self.drops = [], [], [], []
        self.forced = False
        self._next = 0
        top_k, dcc = moe._top_k, moe.dispatch_compute_combine

        def port_top_k(probs, k):
            w, idx = top_k(probs, k)
            if self.forced:
                idx = torch.from_numpy(
                    self.ref[self._next].astype(np.int64))
                self._next += 1
                w = probs.gather(-1, idx)
                w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
            else:
                self.port.append(idx.numpy().copy())
                self.probs.append(probs.detach().numpy().copy())
            return w, idx

        def counted(x, idx, w, wi, wo, *, capacity, num_experts, top_k,
                    offset=None):
            self.drops.append(int((~_port_keep(idx, capacity,
                                               num_experts)).sum()))
            return dcc(x, idx, w, wi, wo, capacity=capacity,
                       num_experts=num_experts, top_k=top_k, offset=offset)
        monkeypatch.setattr(moe, "_top_k", port_top_k)
        monkeypatch.setattr(moe, "dispatch_compute_combine", counted)

    def reference(self, fn):
        orig = jax_moe._route

        def route(router_w, x, E, k):
            w, idx, aux = orig(router_w, x, E, k)
            jax.debug.callback(lambda i: self.ref.append(np.asarray(i)),
                               idx)
            return w, idx, aux
        self.mp.setattr(jax_moe, "_route", route)
        try:
            return fn()
        finally:
            self.mp.setattr(jax_moe, "_route", orig)

    def flips(self) -> int:
        """Slots whose expert differs between the packages. In float32
        there must be none; in bfloat16 each must be a near tie of the
        port's own probabilities (the two frameworks round the hidden
        states differently: the port's attention keeps its probabilities
        in float32 where XLA rounds them to bfloat16)."""
        assert len(self.port) == len(self.ref)
        n = 0
        for got, want, p in zip(self.port, self.ref, self.probs):
            diff = got != want
            n += int(diff.sum())
            pg = np.take_along_axis(p, got, -1)[diff]
            pw = np.take_along_axis(p, want.astype(np.int64), -1)[diff]
            assert np.all(np.abs(pg - pw) <= TIE_EPS), (pg, pw)
        return n


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(arch, dtype, monkeypatch):
    jm, params, model = _pair(arch, dtype)
    tol = TOL[dtype]
    routes = _Routes(monkeypatch)
    rng = np.random.default_rng(5)
    vocab = model.cfg.vocab_size
    tokens = rng.integers(0, vocab, (8, 40)).astype(np.int32)
    tokens[3:] = tokens[2]           # six rows of one sequence
    steps = []
    for i in range(3):
        tok = rng.integers(0, vocab, (8,)).astype(np.int32)
        tok[3:] = tok[2]
        steps.append(tok)

    def reference():
        logits, cache = jax.jit(jm.prefill)(
            params, {"tokens": jnp.asarray(tokens)})
        out = [(logits, cache)]
        step = jax.jit(jm.decode_step)
        for tok in steps:
            logits, cache = step(params, jnp.asarray(tok), cache)
            out.append((logits, cache))
        return out
    want = routes.reference(reference)

    def port():
        logits, cache = model.prefill(torch.from_numpy(tokens))
        out = [(logits, {k: v for k, v in cache.items() if k != "pos"})]
        drops = [sum(routes.drops)]
        for tok in steps:
            before = len(routes.drops)
            logits, cache = model.decode_step(torch.from_numpy(tok), cache)
            out.append((logits, None))
            drops.append(sum(routes.drops[before:]))
        return out, drops, cache
    got, drops, cache = port()
    assert cache["pos"] == 43
    assert min(drops[1:]) >= len(model.layers), drops
    flips = routes.flips()
    assert flips == 0 or dtype == "bfloat16", flips
    if dtype == "bfloat16":          # hold the rest on the same routing
        routes.forced = True
        routes.drops.clear()
        got, drops, _ = port()
        assert routes._next == len(routes.ref)
    (logits, pcache), (jlogits, jcache) = got[0], want[0]
    assert logits.shape == (8, model.vocab_padded)
    np.testing.assert_allclose(logits.float().numpy(), _np(jlogits),
                               atol=tol, rtol=tol, err_msg="prefill")
    assert ("dense0" in pcache) == ("dense0" in jcache) \
        == (arch == "deepseek-moe-16b")
    assert sorted(pcache) == sorted(k for k in jcache if k != "pos")
    for key, kv in pcache.items():
        for g, w in zip(kv, jcache[key]):
            np.testing.assert_allclose(g.float().numpy(), _np(w), atol=tol,
                                       rtol=tol, err_msg=key)
    for i, ((logits, _), (jlogits, _)) in enumerate(zip(got[1:], want[1:])):
        np.testing.assert_allclose(logits.float().numpy(), _np(jlogits),
                                   atol=tol, rtol=tol,
                                   err_msg=f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_reference_token_for_token(arch):
    jm, params, model = _pair(arch, "float32")
    jcfg = jm.cfg
    jqueue = jax_serve.synthetic_requests(12, jcfg.vocab_size, 0)
    jreqs = list(jqueue)
    jout = jax_serve.BatchedServer(jm, params, 4, 256).run(jqueue)
    queue = serve.synthetic_requests(12, model.cfg.vocab_size, 0)
    reqs = list(queue)
    out = serve.BatchedServer(model, 4, 256).run(queue)
    assert out["decode_steps"] == jout["decode_steps"]
    assert out["requests_done"] == jout["requests_done"] == 12
    assert out["tokens_out"] == jout["tokens_out"]
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_serve_launcher_runs_the_reduced_moe_on_the_cpu(capsys):
    assert serve.main(["--arch", "deepseek-moe-16b", "--requests", "3",
                       "--slots", "2", "--cache-len", "128",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] deepseek-moe-16b" in out and "3 done" in out


def test_train_launcher_trains_the_reduced_moe_on_the_cpu(tmp_path,
                                                         capsys):
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--arch", "llama4-scout-17b-a16e", "--device",
                              "cpu", "--steps", "4", "--seq-len", "16",
                              "--batch", "2", "--ckpt-interval", "2",
                              "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "llama4-scout-17b-a16e" in out and "done: 4 steps" in out


# ------------------------------------------------------------ training


def _leaf_errs(got_tree, want_tree):
    flat_g = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want = dict(jax.tree_util.tree_flatten_with_path(want_tree)[0])
    assert len(flat_g) == len(want)
    out = {}
    for path, g in flat_g:
        w = _np(want[path])
        out[jax.tree_util.keystr(path)] = float(
            np.abs(_np(g) - w).max() / max(np.abs(w).max(), 1e-30))
    return out


def _batch(vocab, B=2, S=32, seed=0):
    b = SyntheticLM(DataConfig(vocab, S, B, seed=seed)).batch_at(0)
    b["labels"][0, :4] = -1                  # a masked prefix
    return b


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_train_loss_and_grads_match_reference(arch, dtype, cf, monkeypatch):
    jm, params, model = _pair(arch, dtype, remat="none", capacity_factor=cf)
    routes = _Routes(monkeypatch)
    batch = _batch(model.cfg.vocab_size)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    routes.reference(lambda: jm.train_loss(params, jbatch))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.train_loss, has_aux=True))(params, jbatch)
    with torch.no_grad():
        model.train_loss(batch)
    assert sum(routes.drops) > 0     # both capacity factors drop here
    flips = routes.flips()
    assert flips == 0 or dtype == "bfloat16", flips
    routes.forced = dtype == "bfloat16"   # bf16: on the same routing
    for p in model.parameters():
        p.requires_grad_(True)
    loss, metrics = model.train_loss(batch)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    ltol, gtol = TRAIN_TOL[dtype]
    for key in ("loss", "ce", "aux"):
        assert float(metrics[key]) == pytest.approx(float(jmet[key]),
                                                    rel=ltol), key
    assert float(metrics["aux"]) > 0.0
    assert float(loss) == pytest.approx(
        float(metrics["ce"]) + model.cfg.moe.router_aux_loss
        * float(metrics["aux"]), rel=1e-6)
    errs = _leaf_errs(reference_tree(grads), jax.tree.map(np.asarray,
                                                          jgrads))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= gtol, (worst, errs[worst])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_same_numbers(arch):
    _, _, full = _pair(arch, "float32", remat="full")
    _, _, none = _pair(arch, "float32", remat="none")
    batch = _batch(full.cfg.vocab_size, seed=1)
    out = []
    for model in (full, none):
        for p in model.parameters():
            p.requires_grad_(True)
        loss, metrics = model.train_loss(batch)
        loss.backward()
        out.append((float(loss), float(metrics["aux"]),
                    {n: p.grad for n, p in model.named_parameters()}))
    assert out[0][:2] == out[1][:2]
    for name, g in out[0][2].items():
        assert torch.equal(g, out[1][2][name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_two_trainer_steps_match_reference(arch):
    opt = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jcfg, cfg = _cfgs(arch)
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
        for key in ("loss", "ce", "aux", "grad_norm"):
            assert h[key] == pytest.approx(rh[key], rel=1e-5), key
    # masters and moments as tests/test_torch_train.py holds the dense
    # family: the masters but for <= 1 in 10^4 entries where AdamW's
    # ratio is ill-conditioned, none by more than 5 % of the summed lr
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
        errs = _leaf_errs(reference_tree(tr.opt_state[m]),
                          jax.tree.map(np.asarray, ref.opt_state[m]))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= 2e-5, (m, worst, errs[worst])


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_set_is_the_references(arch):
    _, params, model = _pair(arch, "float32")
    want = jax.tree.map(lambda x: np.asarray(np.ndim(x) >= 2, np.float32),
                        params)
    got = reference_tree({n: np.asarray(d, np.float32)
                          for n, d in decay_mask(model).items()})
    assert max(_leaf_errs(got, want).values()) == 0.0
    mask = decay_mask(model)
    assert mask["layers.0.moe.router"] and mask["layers.0.ln_attn"]
    if arch == "deepseek-moe-16b":
        assert not mask["dense0.ln_attn"] and mask["dense0.attn.wq"]


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trips_parameters_and_optimizer_state(arch):
    _, params, model = _pair(arch, "float32")
    tree = jax.tree.map(np.asarray, params)
    assert max(_leaf_errs(reference_tree(dict(model.named_parameters())),
                          tree).values()) == 0.0
    flat = named_params(tree, len(model.layers))
    assert set(flat) == set(dict(model.named_parameters()))
    assert flat["layers.0.moe.wi"].shape == tuple(
        model.layers[0].moe.wi.shape)
    rng = np.random.default_rng(0)
    jopt = {"mu": jax.tree.map(lambda x: rng.standard_normal(x.shape)
                               .astype(np.float32), tree),
            "nu": jax.tree.map(lambda x: rng.random(x.shape)
                               .astype(np.float32), tree),
            "count": np.int32(3)}
    st = opt_state(jopt, model)
    for m in ("mu", "nu"):
        errs = _leaf_errs(reference_tree(st[m]), jopt[m])
        assert max(errs.values()) == 0.0, m


def test_zero3_units_and_axes():
    _, _, model = _pair("deepseek-moe-16b", "float32")
    units = model.zero3_units()
    assert list(units)[:3] == ["in", "dense0", "layers.0"]
    assert all(n.startswith("dense0.") for n in units["dense0"])
    assert not any(n.startswith("dense0.") for n in units["in"])
    axes = model.param_axes()
    assert axes["layers.0.moe.wi"] == ("expert", "fsdp", None)
    assert axes["layers.0.moe.router"] == (None, None)
    assert axes["layers.0.moe.shared.wg"] == ("fsdp", "ff")
