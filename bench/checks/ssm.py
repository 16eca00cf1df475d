"""The ssm family's own checks, beside the harness's generic ones.

Both follow the program from its own state, recorded in its first step,
and recompute in float32 what it did with that state:

- each WKV6 call (K4 forward, K4' backward) on its own inputs, by the
  plain chunked recurrence (``wkv_fwd``: y and the final state;
  ``wkv_bwd``: the decays' and the initial state's float32 gradients;
  ``wkv_bwd16``: r's, k's, v's and u's bfloat16 ones);
- each part of the model on the program's own input and output gradient:
  the embedding; each block split at its recurrence into the time mix up
  to it (``time_mix_in``, from the block's input), the recurrence (on the
  program's r, k, v, decays and u, and the gradient at its output), and
  the rest (``time_mix_out`` and ``channel_mix``, from the program's
  recurrence output); the head. ``layer_fwd``: the worst gap of the
  parts' outputs (the recurrence's inputs each over its largest
  magnitude, the block's output over the largest of what the block
  added); ``layer_dx``: of their input gradients (the block's input, the
  recurrence's output, the head's input); ``layer_grad``: the worst
  leaf's gap of gradient norms, as the optimizer got them, over the
  larger of its reference norm and the median leaf's.

The block is split so because its gradient is ill-conditioned across the
group norm at random weights: at t = 0 the recurrence's output is the
bonus alone, c v_0 with c = r_0 . (u k_0), which the group norm makes
invariant to c, so the exact v_0 . dy_0 is about 0 and a bfloat16 v_0 or
dy_0 leaves a rounding term that 1 / (|c| std v_0) amplifies into r's,
k's and u's gradients. On the program's own r, k, v and dy the
recurrence's gradients are well-conditioned; so is each part alone.

The control reads the same numbers of the reference computed one
precision lower in the program's place (``control``): its WKV calls, its
blocks' activations and its gradients, recomputed alike.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np
import torch

from bench import traffic as traffic_mod
from bench import weights
from bench.reference import ssm as ref
from bench.reference.common import E4M3_MAX, Prec, leaf_norms

WKV = {"wkv_fwd", "wkv_bwd", "wkv_bwd16"}
LAYER = {"layer_fwd", "layer_grad", "layer_dx"}
NUMBERS = WKV | LAYER


def _host(t):
    return None if t is None else t.detach().to("cpu", copy=True)


def _gap(got, want) -> float:
    """The largest gap of ``got`` from ``want`` over ``want``'s largest
    magnitude."""
    got, want = got.detach().to(want.device).float(), want.detach()
    return float((got - want).abs().max() /
                 want.abs().max().clamp_min(1e-30))


# ------------------------------------------------------------ the program


class WkvCalls:
    """The WKV6 calls of the first step, kept on the host: each forward's
    inputs and outputs (until the first backward; the recomputation under
    remat repeats them) and each backward's inputs and outputs."""

    def __init__(self):
        from repro_torch.kernels.wkv6 import ops
        self.fwd: List[dict] = []
        self.bwd: List[dict] = []
        self._saved = []
        for cls in (ops._Kernel, ops._Plain):
            f0, b0 = cls.__dict__["forward"], cls.__dict__["backward"]
            self._saved.append((cls, f0, b0))
            cls.forward = staticmethod(self._fwd(f0.__func__))
            cls.backward = staticmethod(self._bwd(b0.__func__))

    def _fwd(self, f):
        def forward(ctx, r, k, v, logw, u, s0, chunk, *rest):
            out = f(ctx, r, k, v, logw, u, s0, chunk, *rest)
            ctx.bench_in = (r, k, v, logw, u, s0)
            if not self.bwd:
                self.fwd.append({"in": [_host(t) for t in
                                        (r, k, v, logw, u, s0)],
                                 "out": [_host(t) for t in out],
                                 "chunk": chunk})
            return out
        return forward

    def _bwd(self, b):
        def backward(ctx, dy, ds):
            out = b(ctx, dy, ds)
            self.bwd.append({"in": [_host(t) for t in ctx.bench_in],
                             "dout": [_host(dy), _host(ds)],
                             "out": [_host(t) for t in out[:6]],
                             "chunk": ctx.chunk})
            return out
        return backward

    def remove(self) -> None:
        for cls, f0, b0 in self._saved:
            cls.forward, cls.backward = f0, b0
        self._saved = []


class BlockCalls:
    """Each block's input, output and output gradient in the first step,
    kept on the host, and the gradient at the first block's input: the
    model's ``_unit`` wrapped on the instance until ``remove``."""

    def __init__(self, model):
        self.model = model
        self.rec: Dict = {"x": [], "out": [], "dout": [], "dx0": None}
        n, real = len(model.layers), model._unit

        def unit(name, fn, *args):
            out = real(name, fn, *args)
            i = len(self.rec["x"])
            if i < n and torch.is_grad_enabled():
                x = args[2]
                self.rec["x"].append(_host(x))
                self.rec["out"].append(_host(out))
                self.rec["dout"].append(None)
                out.register_hook(lambda g: self._keep("dout", i, g))
                if i == 0:
                    x.register_hook(lambda g: self._keep("dx0", None, g))
            return out
        model._unit = unit

    def _keep(self, key: str, i, g) -> None:
        if i is None:
            self.rec[key] = _host(g)
        else:
            self.rec[key][i] = _host(g)

    def remove(self) -> None:
        if self.model is not None:
            self.model.__dict__.pop("_unit", None)
        self.model = None


def _model(t):
    """A recorded WKV tensor in the kernel's layout (B, H, S, hd) -> the
    model's (B, S, H, hd)."""
    return t.transpose(1, 2)


class Probe:
    """What the family's numbers read of the program's first step."""

    def __init__(self, model, names):
        names = set(names)
        self.wkv = WkvCalls() if names & NUMBERS else None
        self.blocks = BlockCalls(model) if names & LAYER else None
        self.detail: Dict[str, float] = {}

    def first_step_done(self) -> None:
        for r in (self.wkv, self.blocks):
            if r is not None:
                r.remove()

    remove = first_step_done

    def layers(self) -> List[dict]:
        """Each block's record of the first step: its input, output and
        output gradient, and its recurrence's inputs, output and output
        gradient (model layout), or [] where one is missing."""
        b, w = self.blocks.rec, self.wkv
        L = len(b["x"])
        if not L or len(w.fwd) < L or len(w.bwd) != L or \
                any(g is None for g in b["dout"]):
            return []
        out = []
        for i, (f, bw) in enumerate(zip(w.fwd[:L], reversed(w.bwd))):
            r, k, v, logw, u, _ = f["in"]
            out.append({"x": b["x"][i], "out": b["out"][i],
                        "dout": b["dout"][i],
                        "r": _model(r), "k": _model(k), "v": _model(v),
                        "logw": _model(logw), "u": u,
                        "y": _model(f["out"][0]),
                        "dy": _model(bw["dout"][0])})
        return out

    def numbers(self, c: Mapping, tf: Mapping, seed: int, device,
                grad: Mapping[str, float]) -> Dict[str, float]:
        """The numbers of the first step's records; ``c`` the reference's
        sizes, ``grad`` the program's first-gradient leaf norms."""
        out: Dict[str, float] = {}
        if self.wkv is not None:
            out.update(wkv_gaps(self.wkv.fwd, self.wkv.bwd, device))
        if self.blocks is not None:
            nums, self.detail = layer_gaps(
                self.layers(), self.blocks.rec["dx0"], grad, c, tf, seed,
                device)
            out.update(nums)
        return out


# ------------------------------------------------------------ the checks


def _wkv_run(inp, chunk, device):
    r, k, v, logw, u, s0 = (t.to(device).float().requires_grad_(True)
                            for t in inp)
    if r.shape[2] % chunk:
        raise ValueError("a chunk that does not divide the sequence")
    lay = [t.transpose(1, 2) for t in (r, k, v, logw)]   # (B, S, H, hd)
    y, st = ref.wkv(*lay, u, s0=s0)
    return (r, k, v, logw, u, s0), y.transpose(1, 2), st


def wkv_gaps(fwd: List[dict], bwd: List[dict], device) -> Dict[str, float]:
    """Each recorded call (kernel layout (B, H, S, hd)) recomputed by the
    plain recurrence in float32, its gradients by autograd: the worst
    call's gap of each output."""
    if not fwd or not bwd:
        return {k: math.inf for k in WKV}
    f = b32 = b16 = 0.0
    for c in fwd:
        _, y, st = _wkv_run(c["in"], c["chunk"], device)
        f = max(f, _gap(c["out"][0], y.detach()), _gap(c["out"][1],
                                                        st.detach()))
    for c in bwd:
        ins, y, st = _wkv_run(c["in"], c["chunk"], device)
        dy, ds = c["dout"]
        ds = torch.zeros_like(st) if ds is None else ds.to(device).float()
        grads = torch.autograd.grad((y, st), ins, (dy.to(device).float(), ds))
        each = [_gap(g, w) for g, w in zip(c["out"], grads)]
        b32 = max(b32, each[3], each[5])
        b16 = max([b16] + each[:3] + [each[4]])
    return {"wkv_fwd": f, "wkv_bwd": b32, "wkv_bwd16": b16}


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale, as the program
    rounds its float32 results to bfloat16."""
    s = E4M3_MAX / x.abs().amax().clamp_min(1e-30)
    return (x * s).to(torch.float8_e4m3fn).float() / s


def control_wkv(calls: List[dict], seed: int) -> Dict[str, float]:
    """The control's WKV calls (model layout) against the float32
    recurrence on the same inputs: forward; backward of a seeded cotangent
    (dy ~ N(0, 1)) computed on TF32 operands, its float32 gradients (the
    decays', the initial state's) as they come and its bfloat16 ones (r's,
    k's, v's, u's) rounded to e4m3."""
    low = Prec("fp8")
    f = b32 = b16 = 0.0
    for i, call in enumerate(calls):
        r, k, v, logw, u = call["in"]
        y, st = ref.wkv(r, k, v, logw, u)
        f = max(f, _gap(call["y"], y), _gap(call["state"], st))
        gen = torch.Generator(device=r.device)
        gen.manual_seed(seed * 1000 + i)
        dy = torch.randn(y.shape, generator=gen, device=r.device)
        grads = []
        for prec in (low, Prec()):
            ins = [t.detach().clone().requires_grad_(True)
                   for t in (r, k, v, logw, u)]
            s0 = torch.zeros_like(st).requires_grad_(True)
            yy, _ = ref.wkv(*ins, prec, s0=s0)
            grads.append(torch.autograd.grad(yy, ins + [s0], dy))
        got, want = grads
        b32 = max(b32, _gap(got[3], want[3]), _gap(got[5], want[5]))
        b16 = max([b16] + [_gap(_e4m3(got[j]), want[j]) for j in
                           (0, 1, 2, 4)])
    return {"wkv_fwd": f, "wkv_bwd": b32, "wkv_bwd16": b16}


def layer_gaps(layers: List[dict], dx0, grad: Mapping[str, float],
               c: Mapping, tf: Mapping, seed: int, device):
    """Each part of the model run alone by the float32 reference on the
    bfloat16 starting weights, on the inputs and output gradients that
    ``layers`` (and ``dx0``, the gradient at the first block's input) hold
    of the first step; against the outputs, input gradients and per-leaf
    gradient norms (``grad``) of that step. -> (numbers, each leaf's
    gradient gap)."""
    L = c["num_layers"]
    if len(layers) != L or dx0 is None or \
            any(lay["dy"] is None for lay in layers):
        return {k: math.inf for k in LAYER}, {}
    dev = torch.device(device)
    spec = ref.param_spec(c)
    W = {n: v.float() for n, v in weights.leaves(spec, seed, dev)}
    batch = traffic_mod.source(tf, c["vocab_size"], seed).batch_at(0)
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    on = lambda t: t.to(dev).float()
    eps = c["norm_eps"]
    norms: Dict[str, float] = {}
    fwd = dx = 0.0

    def leaves(names):
        return {n: W[n].detach().requires_grad_(True) for n in names}

    P = leaves(["embed.tok", "ln0"])
    x0 = ref.embed(P, c, tokens)
    norms.update(leaf_norms(dict(zip(P, torch.autograd.grad(
        x0, list(P.values()), on(dx0))))))
    fwd = _gap(layers[0]["x"], x0)
    for i, lay in enumerate(layers):
        p = f"layers.{i}."
        # the recurrence's gradients on the program's own inputs
        ins = [on(lay[n]).requires_grad_(True)
               for n in ("r", "k", "v", "logw", "u")]
        y, _ = ref.wkv(*ins)
        d_in = torch.autograd.grad(y, ins, on(lay["dy"]))
        norms[p + "tm.u"] = float(torch.linalg.vector_norm(d_in[4].double()))
        del ins, y
        # the rest of the block, from its input and the program's output
        # of the recurrence
        P = leaves([n for n in W if n.startswith(p) and n != p + "tm.u"])
        xin = on(lay["x"]).requires_grad_(True)
        yin = on(lay["y"]).requires_grad_(True)
        r, k, v, logw, g = ref.time_mix_in(P, p, c, Prec(),
                                          ref._ln(xin, P[p + "ln1"], eps))
        out = ref.channel_mix(P, p, c, Prec(), xin + ref.time_mix_out(
            P, p, c, Prec(), yin, g))
        o = out.detach()
        fwd = max(fwd, *(_gap(lay[n], t) for n, t in
                         zip(("r", "k", "v", "logw"), (r, k, v, logw))),
                  float((on(lay["out"]) - o).abs().max() /
                        (o - xin.detach()).abs().max().clamp_min(1e-30)))
        gs = torch.autograd.grad([out, r, k, v, logw],
                                 [*P.values(), xin, yin],
                                 [on(lay["dout"]), *d_in[:4]])
        norms.update(leaf_norms(dict(zip(P, gs))))
        dx = max(dx, _gap(layers[i - 1]["dout"] if i else dx0, gs[-2]),
                 _gap(lay["dy"], gs[-1]))
        del P, xin, yin, out, gs, d_in
    P = leaves(["ln_f", ref.HEAD])
    xl = on(layers[-1]["out"]).requires_grad_(True)
    gs = torch.autograd.grad(ref.head_loss(P, c, xl, labels, Prec()),
                             [*P.values(), xl])
    norms.update(leaf_norms(dict(zip(P, gs))))
    dx = max(dx, _gap(layers[-1]["dout"], gs[-1]))
    del W, P
    med = float(np.median(list(norms.values())))
    each = {k: abs(grad.get(k, math.inf) - v) / max(v, med)
            for k, v in norms.items()}
    return ({"layer_fwd": fwd, "layer_grad": max(each.values()),
             "layer_dx": dx}, each)


def control(record: Mapping, grad: Mapping[str, float], c: Mapping,
            tf: Mapping, seed: int, device, names) -> Dict[str, float]:
    """The family's numbers of the control: the reference one precision
    lower in the program's place, ``record`` what its first step kept
    (``Prec.record``: its WKV calls, the first ``num_layers`` of them its
    blocks' in order, and its blocks) and ``grad`` its first gradient's
    leaf norms."""
    out: Dict[str, float] = {}
    names = set(names)
    calls = record.get("wkv", [])
    if names & WKV and calls:
        out.update(control_wkv(calls, seed))
    if names & LAYER and "blocks" in record:
        b, L = record["blocks"], c["num_layers"]
        layers = [{"x": b["x"][i], "out": b["out"][i], "dout": b["dout"][i],
                   **dict(zip(("r", "k", "v", "logw", "u"), w["in"])),
                   "y": w["y"], "dy": w.get("dy")}
                  for i, w in enumerate(calls[:L])] if len(b["x"]) == L \
            else []
        out.update(layer_gaps(layers, b.get("dx0"), grad, c, tf, seed,
                              device)[0])
    return out
