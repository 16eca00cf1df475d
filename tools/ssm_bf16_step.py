#!/usr/bin/env python3
"""Trace where rwkv6-7b's bfloat16 training step on the kernel path (K4
forward, K4' backward) parts from the same step on the plain path
(``wkv6_ref`` / ``wkv6_bwd_ref``), on one card.

Run from the repository root:

    python3 tools/ssm_bf16_step.py [--layers 8] [--seq 4096]

The model is rwkv6-7b at its published widths, ``--layers`` deep, seeded
random weights, one ``SyntheticLM`` sequence, remat "none" (so that each
layer's WKV call runs once a step). Printed, each against the plain bf16
step unless said otherwise:

1. Layer by layer, the inputs each path hands the WKV call, K4's y
   against ``wkv6_ref`` on the kernel path's own inputs (and how many of
   its elements round to another bfloat16), y and dy of the two paths,
   and K4' against ``wkv6_bwd_ref`` on the kernel path's own inputs.
2. Every gradient leaf's gap (max |a - b| over max |b|), the worst few,
   for: the kernel path; K4 forward with the plain backward; the plain
   forward with K4' (fed the chunk-start states of a K4 call on the same
   inputs); and the plain path with its WKV output y multiplied by
   (1 + eps N(0, 1)) for eps 1e-7 and 1e-6 (float32-level noise, seeded).
3. The last layer's largest |dy| on each path: its token and head, and
   the variance of that head's y there against the group norm's eps.
4. The plain float32 step on the bf16 weights, widened: the kernel and
   plain bf16 steps' gaps to it, and the agreement of one AdamW update
   from zero moments (cosine, share of entries that change sign) for
   each pair.
5. For one K4' call at the training shape, the rows ``torch.profiler``'s
   ``key_averages`` holds over five calls (each kernel's mean time a
   launch from them), and ``chip_smoke.kernel_split_ms``.

The last line is a JSON object of the headline numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

GN_EPS = 1e-5          # rwkv6's ln_x group norm (models/layers.group_norm)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from unittest import mock

    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build_all(["wkv6", "wkv6_bwd"])
    import repro_torch.models.rwkv6 as rw
    from repro_torch.configs import get_config
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.kernels.wkv6 import wkv6_plain
    from repro_torch.kernels.wkv6.ref import wkv6_bwd_ref, wkv6_ref
    from repro_torch.kernels.wkv6.wkv6 import wkv6_chunked, wkv6_chunked_bwd
    from repro_torch.models.common import Policy
    from repro_torch.models.model import Model
    from repro_torch.train import AdamWConfig, DataConfig, SyntheticLM

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cfg = dataclasses.replace(get_config("rwkv6-7b"),
                              num_layers=args.layers)
    model = Model(cfg, device="cuda", seed=0, remat="none")
    for p in model.parameters():
        p.requires_grad_(True)
    batch = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, 1,
                                   seed=0)).batch_at(0)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim

    class KernelFwdPlainBwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, logw, u, s0, chunk):
            ctx.save_for_backward(r, k, v, logw, u, s0)
            ctx.chunk = chunk
            return wkv6_chunked(r, k, v, logw, u, s0, chunk=chunk)

        @staticmethod
        def backward(ctx, dy, ds):
            r, k, v, logw, u, s0 = ctx.saved_tensors
            return ops._as_inputs(u, s0, wkv6_bwd_ref(
                r, k, v, logw, u, s0, dy, ds, chunk=ctx.chunk))

    class PlainFwdKernelBwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, logw, u, s0, chunk):
            _, _, starts = wkv6_chunked(r, k, v, logw, u, s0, chunk=chunk,
                                        keep_states=True)
            ctx.save_for_backward(r, k, v, logw, u, s0, starts)
            ctx.chunk = chunk
            return wkv6_ref(r, k, v, logw, u, s0, chunk=chunk)

        @staticmethod
        def backward(ctx, dy, ds):
            r, k, v, logw, u, s0, starts = ctx.saved_tensors
            return ops._as_inputs(u, s0, wkv6_chunked_bwd(
                r, k, v, logw, u, starts, dy.contiguous(), ds,
                chunk=ctx.chunk))

    def through(fn_cls):
        def wkv(r, k, v, logw, u, s0, *, chunk=64):
            a = [t.transpose(1, 2) for t in (r, k, v, logw.float())]
            y, s = fn_cls.apply(*a, u, s0, chunk)
            return y.transpose(1, 2), s
        return wkv

    def noisy(eps):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)

        def wkv(r, k, v, logw, u, s0, *, chunk=64):
            y, s = wkv6_plain(r, k, v, logw, u, s0, chunk=chunk)
            n = torch.randn(y.shape, generator=gen, device=y.device)
            return y * (1 + eps * n), s
        return wkv

    def recorded(fn, log):
        def wkv(r, k, v, logw, u, s0, *, chunk=64):
            y, s = fn(r, k, v, logw, u, s0, chunk=chunk)
            rec = dict(r=r.detach().clone(), k=k.detach().clone(),
                       v=v.detach().clone(), logw=logw.detach().clone(),
                       u=u.detach(), y=y.detach().clone(), chunk=chunk)
            log.append(rec)
            y.register_hook(lambda g: rec.__setitem__("dy",
                                                      g.detach().clone()))
            return y, s
        return wkv

    def step(m, fn, log=None):
        f = fn if log is None else recorded(fn, log)
        with mock.patch.object(rw, "wkv6", f):
            loss, g = cs.train_step_grads(torch, m, batch)
        return float(loss), {n: t.to("cpu") for n, t in g.items()}

    def gaps(ga, gb):
        return {n: cs.rel_err(ga[n], gb[n]) for n in ga}

    def worst(tag, gp, top=5):
        rows = sorted(gp.items(), key=lambda kv: -kv[1])[:top]
        print(f"{tag}: worst leaf gaps " + ", ".join(
            f"{n} {e:.3e}" for n, e in rows), flush=True)
        return rows[0]

    out = {}
    log_k, log_p = [], []
    loss_k, g_k = step(model, ops.wkv6, log_k)
    loss_p, g_p = step(model, wkv6_plain, log_p)
    print(f"loss: kernel {loss_k:.6f}, plain {loss_p:.6f}", flush=True)

    # 1. layer by layer
    s0 = torch.zeros(1, H, hd, hd, device="cuda")
    layers = []
    for i, (a, b) in enumerate(zip(log_k, log_p)):
        ins = {n: int((a[n] != b[n]).sum()) for n in ("r", "k", "v",
                                                      "logw")}
        kl = [a[n].transpose(1, 2) for n in ("r", "k", "v", "logw")]
        y_ref, _ = wkv6_ref(*kl, a["u"], s0, chunk=a["chunk"])
        y_ref = y_ref.transpose(1, 2)
        y_kern, _ = ops.wkv6(a["r"], a["k"], a["v"], a["logw"], a["u"], s0,
                             chunk=a["chunk"])
        fwd = cs.rel_err(y_kern, y_ref)
        flips = int((y_kern.bfloat16() != y_ref.bfloat16()).sum())
        dy = a["dy"].transpose(1, 2).contiguous()
        _, _, starts = wkv6_chunked(*kl, a["u"], s0, chunk=a["chunk"],
                                    keep_states=True)
        got = wkv6_chunked_bwd(*kl, a["u"], starts, dy, None,
                               chunk=a["chunk"])
        want = wkv6_bwd_ref(*kl, a["u"], s0, dy, None, chunk=a["chunk"])
        bwd = {n: cs.rel_err(x, w) for n, x, w in
               zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got, want)}
        row = dict(layer=i, inputs_differing=ins, k4_vs_ref=fwd,
                   k4_bf16_flips=flips, y_gap=cs.rel_err(a["y"], b["y"]),
                   dy_gap=cs.rel_err(a["dy"], b["dy"]),
                   k4b_vs_ref=max(bwd.values()))
        layers.append(row)
        print(f"layer {i}: elements of r/k/v/logw that differ between the "
              f"paths {ins}; K4 y vs wkv6_ref on the kernel path's inputs "
              f"{fwd:.3e} ({flips} of {y_ref.numel()} round to another "
              f"bf16); y gap {row['y_gap']:.3e}, dy gap {row['dy_gap']:.3e}; "
              f"K4' vs wkv6_bwd_ref on the kernel path's inputs " +
              ", ".join(f"{n} {e:.2e}" for n, e in bwd.items()), flush=True)
        del y_ref, y_kern, starts, got, want, dy
    out["layers"] = layers

    # 3. the last layer's largest |dy|
    spikes = {}
    for tag, rec in (("kernel", log_k[-1]), ("plain", log_p[-1])):
        dy = rec["dy"][0].abs()                         # (S, H, hd)
        t, h, c = (int(x) for x in torch.unravel_index(dy.argmax(),
                                                       dy.shape))
        yh = rec["y"][0, t, h].bfloat16().float()
        var = float(yh.var(unbiased=False))
        spikes[tag] = dict(token=t, head=h, dy=float(dy[t, h, c]), var=var)
        other = log_p[-1] if tag == "kernel" else log_k[-1]
        print(f"last layer, {tag} path: largest |dy| {float(dy[t, h, c]):.3e}"
              f" at token {t}, head {h}; that head's y variance there "
              f"{var:.3e} (group norm eps {GN_EPS:g}; on the other path "
              f"{float(other['y'][0, t, h].bfloat16().float().var(unbiased=False)):.3e}"
              f", |dy| {float(other['dy'][0, t, h].abs().max()):.3e})",
              flush=True)
    out["last_layer_dy_max"] = spikes
    del log_k, log_p
    gc.collect()
    torch.cuda.empty_cache()

    # 2. where the gap enters
    out["kernel_vs_plain"] = worst("kernel path vs plain", gaps(g_k, g_p))
    for tag, fn in (("K4 forward + plain backward",
                     through(KernelFwdPlainBwd)),
                    ("plain forward + K4' backward",
                     through(PlainFwdKernelBwd)),
                    ("plain, y x (1 + 1e-7 N)", noisy(1e-7)),
                    ("plain, y x (1 + 1e-6 N)", noisy(1e-6))):
        _, g = step(model, fn)
        out[tag] = dict(vs_plain=worst(f"{tag} vs plain", gaps(g, g_p)),
                        vs_kernel=worst(f"{tag} vs kernel path",
                                        gaps(g, g_k)))
        del g

    # 4. against the float32 step on the same weights
    f32 = Model(cfg, Policy(compute_dtype=torch.float32), device="cuda",
                seed=None, remat="none")
    with torch.no_grad():
        for (_, a), (_, b) in zip(f32.named_parameters(),
                                  model.named_parameters()):
            a.copy_(b)
    for p in f32.parameters():
        p.requires_grad_(True)
    _, g_f = step(f32, wkv6_plain)
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    gk, gp = gaps(g_k, g_f), gaps(g_p, g_f)
    print("per leaf, bf16 kernel vs fp32 plain | bf16 plain vs fp32 plain "
          "(the 10 leaves with the largest kernel gap): " + ", ".join(
              f"{n} {gk[n]:.3e} | {gp[n]:.3e}" for n in
              sorted(gk, key=lambda n: -gk[n])[:10]), flush=True)
    out["bf16_kernel_vs_fp32"] = max(gk.items(), key=lambda kv: kv[1])
    out["bf16_plain_vs_fp32"] = max(gp.items(), key=lambda kv: kv[1])
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=12)
    agree = {}
    for tag, ga, gb in (("kernel vs plain", g_k, g_p),
                        ("kernel vs fp32", g_k, g_f),
                        ("plain vs fp32", g_p, g_f)):
        flip, cos, _ = cs.update_agreement(torch, model, ga, gb, opt)
        agree[tag] = dict(cos=cos, flip=flip)
        print(f"AdamW update from zero moments, {tag}: cosine {cos:.6f}, "
              f"{flip:.3e} of entries change sign", flush=True)
        torch.cuda.empty_cache()
    out["adamw"] = agree
    del g_k, g_p, g_f, model
    gc.collect()
    torch.cuda.empty_cache()

    # 5. what the profiler holds for one K4' call
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    r, k, v = (torch.randn(1, args.seq, H, hd, device="cuda")
               .bfloat16().transpose(1, 2) * 0.5 for _ in range(3))
    logw = -torch.exp(torch.randn(1, args.seq, H, hd, device="cuda")
                      - 2.0).transpose(1, 2)
    u = torch.randn(H, hd, device="cuda") * 0.15
    dy = torch.randn(1, args.seq, H, hd, device="cuda").transpose(1, 2)
    _, _, starts = wkv6_chunked(r, k, v, logw, u, s0, chunk=32,
                                keep_states=True)

    def call():
        return wkv6_chunked_bwd(r, k, v, logw, u, starts, dy, None,
                                chunk=32)
    call()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(cs.LEAD_CYCLES)
        torch.cuda.synchronize()
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        print(f"key_averages row: device_type {e.device_type}, count "
              f"{e.count}, self_device_time_total "
              f"{e.self_device_time_total:.1f} us, key {e.key[:150]!r}",
              flush=True)
    kinds = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    print(f"events on the card: {len(kinds)}; names "
          f"{sorted(set(n[:90] for n in kinds))}", flush=True)
    out["key_averages_ms"] = {
        n: [e.self_device_time_total / e.count / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and n in e.key and e.count]
        for n in cs.K4B_KERNELS}
    out["kernel_split_ms"] = cs.kernel_split_ms(torch, call)
    print(f"key_averages ms a launch {out['key_averages_ms']}; "
          f"kernel_split_ms "
          f"{out['kernel_split_ms']}", flush=True)
    print(json.dumps(out, default=str), flush=True)


if __name__ == "__main__":
    main()
