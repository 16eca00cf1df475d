"""``repro_torch.launch.step_analysis`` and the kernels' meta stand-ins.

- Counting: a Python loop of 7 matmuls of 64 x 64 counts 7 x 2 x 64^3
  (eager code runs every iteration: the counterpart of the reference's
  ``test_scan_trip_count_multiplies_flops``); views move no bytes; each
  collective of ``repro_torch.dist`` counts its exact bytes under the
  reference's kind name, under a fake process group of 256 ranks in a
  subprocess (``tests/torch_dryrun_workers.py``).
- The stand-ins (``repro_torch.kernels.meta``): each gives the plain
  version's output and gradient shapes and dtypes at small shapes, the
  windowed attention too; at ``PERF.md``'s main shapes each one's count
  reproduces the kernel table's bound column; meta tensors reach only the
  stand-ins and CPU tensors only the plain versions.
- Parity with ``repro.launch.hlo_analysis``: on reduced configurations
  (B = 2, S = 64) on the CPU plain path, ``analyze(...).flops`` equals the
  reference's ``analyze(compiled.as_text()).flops`` exactly for every
  case in ``EXACT``. rwkv6-7b's prefill and train step differ (within 1 %)
  by what its two chunked WKV formulations compute as products, each
  gap held to its formula (``rwkv_gap``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dryrun_workers as workers
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import hlo_analysis
from repro.models.model import Model as JaxModel
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
from repro.train.trainer import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import meta, rglru, wkv6
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.launch.step_analysis import analyze, collective_kind
from repro_torch.models.model import Model
from repro_torch.models.rwkv6 import CHUNK
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.trainer import make_train_step, master_params


# ------------------------------------------------------------- counting


def test_loop_of_matmuls_counts_every_iteration():
    a = torch.randn(64, 64)
    b = torch.randn(64, 64)

    def loop():
        x = a
        for _ in range(7):
            x = x @ b
        return x

    mc = analyze(loop)
    assert mc.flops == 7 * 2 * 64 ** 3
    assert mc.dot_traffic_bytes == 7 * 3 * 64 * 64 * 4
    assert mc.kernel_calls == {} and mc.collective_bytes == 0


def test_views_move_no_bytes():
    x = torch.randn(4, 8, 16)

    def views():
        y = x.view(32, 16).transpose(0, 1)[:, 2:10]
        y = y.expand(3, 16, 8).as_strided((16, 8), (1, 16))
        return y.unsqueeze(0).permute(0, 2, 1).reshape(8, 16)

    mc = analyze(views)
    assert mc.traffic_bytes == mc.traffic_bytes_upper == 0.0
    assert mc.flops == 0.0
    nbytes = x.numel() * 4
    # one elementwise op: read once, written once; fused: 2 x its output
    mc = analyze(lambda: x + 1.0)
    assert mc.traffic_bytes_upper == 2 * nbytes
    assert mc.traffic_bytes == 2 * nbytes


def test_collective_kinds_are_the_references():
    c10d = torch.ops.c10d
    assert collective_kind(c10d.allreduce_.default) == "all-reduce"
    assert collective_kind(c10d._allgather_base_.default) == "all-gather"
    assert collective_kind(c10d._reduce_scatter_base_.default) == \
        "reduce-scatter"
    assert collective_kind(c10d.alltoall_base_.default) == "all-to-all"
    assert collective_kind(c10d.barrier.default) == ""


def test_collectives_count_their_exact_bytes(tmp_path):
    got = workers.run_suite("collectives", tmp_path)
    n, tp = got["x_bytes"], got["tp"]
    assert tp == 16 and got["rank"] == workers.RANK % 16
    assert got["reduce_out"]["breakdown"] == {"all-reduce": n}
    assert got["gather_dim"]["breakdown"] == {"all-gather": tp * n}
    assert got["all_to_all"]["breakdown"] == {"all-to-all": n}
    for name in ("reduce_out", "gather_dim", "all_to_all"):
        assert got[name]["bytes"] == sum(got[name]["breakdown"].values())
        assert got[name]["flops"] == 0


# ------------------------------------------------------------- stand-ins


def _pair(shapes, dtypes, grad=True):
    """Each shape as a CPU tensor (seeded) and an empty meta tensor."""
    rng = np.random.default_rng(0)
    cpu, met = [], []
    for shp, dt in zip(shapes, dtypes):
        t = torch.from_numpy(rng.standard_normal(shp).astype(np.float32)
                             * 0.1).to(dt)
        cpu.append(t.requires_grad_(grad))
        met.append(torch.empty(shp, dtype=dt, device="meta")
                   .requires_grad_(grad))
    return cpu, met


def _outputs_and_grads(fn, inputs):
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum(o.float().sum() for o in outs)
    grads = torch.autograd.grad(loss, inputs)
    return [(tuple(t.shape), t.dtype) for t in (*outs, *grads)]


ATTN_CASES = [  # B, Hq, Hkv, S, T, hd, causal, window, dtype
    (2, 4, 2, 24, 24, 32, True, 0, torch.bfloat16),
    (1, 4, 1, 32, 32, 16, True, 8, torch.float32),
    (2, 2, 2, 12, 20, 32, False, 0, torch.bfloat16),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_stand_in_has_the_plain_shapes(case):
    B, hq, hkv, S, T, hd, causal, window, dt = case
    cpu, met = _pair([(B, S, hq, hd), (B, T, hkv, hd), (B, T, hkv, hd)],
                     [dt] * 3)

    def fn(q, k, v):
        return fa.attention(q, k, v, causal=causal, window=window)

    with meta.recording() as calls:
        got = _outputs_and_grads(fn, met)
    assert got == _outputs_and_grads(fn, cpu)
    assert [c.name for c in calls] == ["flash_attention",
                                       "flash_attention_bwd"]
    with meta.recording() as calls:
        fn(*[t.detach() for t in met])
    assert [c.name for c in calls] == ["flash_attention"]
    # the forward's log-sum-exp, which the backward reads
    o, lse = fa.flash_attention_meta(*[t.detach().transpose(1, 2)
                                       for t in met], causal=causal,
                                     window=window, lse=True)
    want_o, want_lse = fa.attention_ref(*[t.detach().transpose(1, 2)
                                          for t in cpu], causal=causal,
                                        window=window, return_lse=True)
    assert (o.shape, o.dtype, lse.shape, lse.dtype) == \
        (want_o.shape, want_o.dtype, want_lse.shape, want_lse.dtype)


@pytest.mark.parametrize("S,dt", [(64, torch.bfloat16), (48, torch.float32)])
def test_wkv6_stand_in_has_the_plain_shapes(S, dt):
    B, H, hd = 2, 3, 16
    seq = (B, S, H, hd)
    cpu, met = _pair([seq, seq, seq, seq, (H, hd), (B, H, hd, hd)],
                     [dt, dt, dt, torch.float32, torch.float32,
                      torch.float32])
    cpu[3].data = -torch.exp(cpu[3].data)

    def fn(r, k, v, logw, u, s0):       # the model's chunk
        return wkv6.wkv6(r, k, v, logw, u, s0,
                         chunk=CHUNK if S % CHUNK == 0 else S)

    with meta.recording() as calls:
        got = _outputs_and_grads(fn, met)
    assert got == _outputs_and_grads(fn, cpu)
    assert [c.name for c in calls] == ["wkv6", "wkv6_bwd"]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_rglru_stand_in_has_the_plain_shapes(dt):
    B, S, W = 2, 40, 24
    f32 = torch.float32
    cpu, met = _pair([(B, S, W), (W,), (W,), (W,), (B, W)],
                     [dt, f32, f32, f32, f32])

    with meta.recording() as calls:
        got = _outputs_and_grads(rglru.rglru, met)
    assert got == _outputs_and_grads(rglru.rglru, cpu)
    assert [c.name for c in calls] == ["rglru", "rglru_bwd"]


BF16, FP32, TF32, HBM = 989e12, 67e12, 495e12, 3.35e12


def _bound_ms(call, peak):
    return max(call.flops / peak, call.bytes / HBM) * 1e3


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# the kernel table's main shapes (PERF.md section 6) and bound column
def _k3(window, hd, hq, hkv):
    q, k = _meta(1, hq, 4096, hd), _meta(1, hkv, 4096, hd)
    return lambda: fa.flash_attention_meta(q, k, k, window=window)


def _k3_bwd(window, hd, hq, hkv):
    q, k = _meta(1, hq, 4096, hd), _meta(1, hkv, 4096, hd)
    return lambda: fa.flash_attention_bwd_meta(q, k, k, window=window)


def _k4(bwd):
    S = 4096 if bwd else 2048
    x, lw = _meta(1, 64, S, 64), _meta(1, 64, S, 64, dtype=torch.float32)
    u, s0 = _meta(64, 64, dtype=torch.float32), \
        _meta(1, 64, 64, 64, dtype=torch.float32)
    if bwd:
        return lambda: wkv6.wkv6_chunked_bwd_meta(x, x, x, lw, u, chunk=32)
    return lambda: wkv6.wkv6_chunked_meta(x, x, x, lw, u, s0, chunk=32)


def _k5(bwd):
    from repro_torch.kernels.rglru.rglru import (rglru_scan_bwd_meta,
                                                 rglru_scan_meta)
    xb, w = _meta(1, 4096, 4096), _meta(4096, dtype=torch.float32)
    h0 = _meta(1, 4096, dtype=torch.float32)
    if bwd:
        states = _meta(1, 4096, 4096, dtype=torch.float32)
        return lambda: rglru_scan_bwd_meta(xb, w, w, w, h0, states, xb)
    return lambda: rglru_scan_meta(xb, w, w, w, h0)


TABLE = {  # kernel: (stand-in call, peak of its operations, bound ms)
    "K3": (_k3(0, 128, 32, 8), BF16, 0.1390),
    "K3 window": (_k3(2048, 256, 16, 1), BF16, 0.1042),
    "K3'": (_k3_bwd(0, 128, 32, 8), BF16, 0.3475),
    "K3' window": (_k3_bwd(2048, 256, 16, 1), BF16, 0.2606),
    "K4": (_k4(False), FP32, 0.0411),
    "K4'": (_k4(True), TF32, 0.1208),
    "K5": (_k5(False), FP32, 0.0201),
    "K5'": (_k5(True), FP32, 0.0501),
}


@pytest.mark.parametrize("kernel", sorted(TABLE))
def test_stand_in_counts_reproduce_the_bound_column(kernel):
    call, peak, bound = TABLE[kernel]
    with meta.recording() as calls:
        call()
    assert len(calls) == 1
    assert round(_bound_ms(calls[0], peak), 4) == bound


def test_stand_in_counts_are_the_tables():
    (fwd,) = _calls(TABLE["K3"][0])
    (bwd,) = _calls(TABLE["K3'"][0])
    (wfwd,) = _calls(TABLE["K3 window"][0])
    for call, gflop in ((fwd, 137.4), (bwd, 343.7), (wfwd, 103.1)):
        assert abs(call.flops / 1e9 - gflop) < 0.1   # as the table
    (k4b,) = _calls(TABLE["K4'"][0])
    (k5,) = _calls(TABLE["K5"][0])
    (k5b,) = _calls(TABLE["K5'"][0])
    assert (round(k4b.bytes / 1e6), round(k5.bytes / 1e6, 1),
            round(k5b.bytes / 1e6, 1)) == (405, 67.2, 167.9)


def _calls(fn):
    with meta.recording() as calls:
        fn()
    return calls


def _boom(*args, **kwargs):
    raise AssertionError("the wrong path ran")


def test_meta_reaches_only_the_stand_ins_and_cpu_only_the_plain(
        monkeypatch):
    (cq, ck, cv), (mq, mk, mv) = _pair([(1, 16, 2, 16)] * 3,
                                       [torch.float32] * 3)
    for name in ("attention_ref",):
        monkeypatch.setattr(fa_ops, name, _boom)
    for name in ("wkv6_ref", "wkv6_bwd_ref"):
        monkeypatch.setattr(wkv6_ops, name, _boom)
    for name in ("rglru_ref", "rglru_states_ref", "rglru_bwd_ref"):
        monkeypatch.setattr(rglru_ops, name, _boom)
    loss = fa.attention(mq, mk, mv).sum()
    loss.backward()
    f32 = torch.float32
    _, met = _pair([(1, 32, 2, 16)] * 4 + [(2, 16), (1, 2, 16, 16)],
                   [f32] * 6)
    y, s = wkv6.wkv6(*met, chunk=CHUNK)
    (y.sum() + s.sum()).backward()
    _, met = _pair([(1, 8, 4), (4,), (4,), (4,), (1, 4)], [f32] * 5)
    h, h_last = rglru.rglru(*met)
    (h.sum() + h_last.sum()).backward()
    with pytest.raises(AssertionError, match="wrong path"):
        fa.attention(cq, ck, cv)
    monkeypatch.undo()
    for mod, name in ((fa_ops, "flash_attention_meta"),
                      (fa_ops, "flash_attention_bwd_meta")):
        monkeypatch.setattr(mod, name, _boom)
    fa.attention(cq, ck, cv).sum().backward()
    with pytest.raises(AssertionError, match="wrong path"):
        fa.attention(mq, mk, mv)


# ------------------------------------------------ parity with the reference

B, S = 2, 64
EXACT = [("qwen3-4b", "prefill"), ("phi3-mini-3.8b", "prefill"),
         ("deepseek-moe-16b", "prefill"), ("qwen2-vl-72b", "prefill"),
         ("qwen3-4b", "train"), ("recurrentgemma-9b", "train"),
         ("whisper-small", "train"),
         ("qwen3-4b", "decode"), ("rwkv6-7b", "decode"),
         ("recurrentgemma-9b", "decode"),
         # the families the first comparison did not try
         ("deepseek-moe-16b", "train"), ("qwen2-vl-72b", "train"),
         ("whisper-small", "prefill")]


def _reference_flops(arch, kind):
    cfg = jax_reduced(jax_get_config(arch))
    model = JaxModel(cfg)
    sds = jax.ShapeDtypeStruct
    params = jax.tree.map(lambda x: sds(x.shape, x.dtype),
                          model.param_shapes())
    batch = {"tokens": sds((B, S), jnp.int32)}
    if cfg.mrope_sections:
        batch["positions"] = sds((3, B, S), jnp.int32)
        batch["patch_embeds"] = sds((B, 4, cfg.d_model), jnp.bfloat16)
    if cfg.is_encoder_decoder:
        batch["enc_frames"] = sds((B, cfg.encoder_seq_len, cfg.d_model),
                                  jnp.bfloat16)
    if kind == "prefill":
        lowered = jax.jit(model.prefill).lower(params, batch)
    elif kind == "train":
        batch["labels"] = batch["tokens"]
        opt = {"mu": params, "nu": params, "count": sds((), jnp.int32)}
        step = jax_make_train_step(model, JaxAdamWConfig())
        lowered = jax.jit(step).lower(params, opt, batch)
    else:
        cache = jax.eval_shape(functools.partial(model.init_cache, B, S))
        lowered = jax.jit(model.decode_step).lower(
            params, sds((B,), jnp.int32), cache)
    # the backend's optimisation level changes the machine code, not the
    # HLO the count reads (the same counts, a third less compile time)
    compiled = lowered.compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return hlo_analysis.analyze(compiled.as_text()).flops


def _port_flops(arch, kind):
    cfg = reduced(get_config(arch))
    model = Model(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    extra = {}
    if cfg.mrope_sections:
        extra["positions"] = torch.arange(S, dtype=torch.int32).expand(
            3, B, S)
        extra["patch_embeds"] = torch.zeros((B, 4, cfg.d_model),
                                            dtype=torch.bfloat16)
    if cfg.is_encoder_decoder:
        extra["enc_frames"] = torch.zeros(
            (B, cfg.encoder_seq_len, cfg.d_model), dtype=torch.bfloat16)
    if kind == "prefill":
        return analyze(model.prefill, tokens, **extra).flops
    if kind == "train":
        step = make_train_step(model, AdamWConfig())
        params = master_params(model)
        batch = {"tokens": tokens, "labels": tokens, **extra}
        return analyze(step, params, init_opt_state(params), batch).flops
    return analyze(model.decode_step, tokens[:, 0],
                   model.init_cache(B, S)).flops


@pytest.mark.parametrize("arch,kind", EXACT)
def test_flops_equal_the_references_count(arch, kind):
    assert _port_flops(arch, kind) == _reference_flops(arch, kind)


def rwkv_gap(kind):
    """The port's count minus the reference's for reduced rwkv6-7b: the
    reference computes the u bonus (sum over hd of r u k) as a batched dot
    product, 2 B S H hd a layer in each forward, where the port multiplies
    and sums; in training (remat "full": two forwards a layer) the port's
    explicit backward (``wkv6_bwd_ref``) also recomputes each chunk's
    start state (kd^T v) and A (q_ k_^T), 2 C hd^2 + 2 C^2 hd a chunk and
    head, which the reference's autodiff takes from the scan's saved
    residuals."""
    cfg = reduced(get_config("rwkv6-7b"))
    L, hd = cfg.num_layers, cfg.rwkv_head_dim
    H, C = cfg.d_model // hd, min(CHUNK, S)
    bonus = 2 * B * S * H * hd
    if kind == "prefill":
        return -L * bonus
    return L * (B * H * (S // C) * (2 * C * hd * hd + 2 * C * C * hd)
                - 2 * bonus)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_rwkv_flops_differ_by_the_formulations_gap(kind):
    got, want = _port_flops("rwkv6-7b", kind), _reference_flops("rwkv6-7b",
                                                                kind)
    assert abs(got - want) <= 0.01 * want
    assert got - want == rwkv_gap(kind)
