"""The first ``Trainer`` steps of qwen2-vl-72b's stack at a chosen width:
in the port and in the JAX package on the CPU, from the same weights and
the same batches, or in the port alone on the card.

It answers whether a loss that jumps after the first AdamW step is the
model's own behaviour or the port's fault. With ``--packages
port,reference`` both packages start from the reference's initial
weights (carried across with ``convert.model_params``) and take
``--steps`` float32 steps of ``SyntheticLM`` batches with the vlm
family's stub image (``torch_dist_workers.WithPatches``: seeded
standard-normal patch rows, Qwen2-VL's M-RoPE layout) at AdamW's peak
``--lr`` (each of a comma-separated list) after 2 warmup steps. With
``--device cuda`` the port alone runs, from its own seeded weights, in
bfloat16 with remat "full" (as ``chip_smoke.py`` phase 24 does), and
imports nothing of JAX. For the port it prints, before each step, how
far the hidden rows have collapsed: the mean cosine of the final-normed
hidden rows of the text positions with their mean (``text_cos``), and
the mean over those positions of the top logit above the median one
(``top_logit``).

Run from the repository root. On the CPU (it imports both packages, as
the tests do)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/vlm_first_steps.py \\
        --d-model 4096 --vocab 32768 --seq 1024 --grid 8

On one card, qwen2-vl-72b at its full width, one layer::

    PYTHONPATH=src python3 tests/vlm_first_steps.py --device cuda \\
        --d-model 8192 --vocab 152064 --seq 4096 --grid 16 --lr 3e-4,1e-4

Widths below 1,024 take head dim 32 and sections (4, 6, 6), the reduced
config's; from 1,024 up, head dim 128 and qwen2-vl's (16, 24, 24), with a
query group of 8, qwen2-vl's. d_ff is 3.61 x d_model (qwen2-vl's 29,568 /
8,192) unless given. ``--grid 0`` drops the image (text positions on all
three streams); ``--patch-scale`` multiplies the patch rows.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_dist_workers import WithPatches  # noqa: E402

ARCH = "qwen2-vl-72b"


class TextPositions:
    """A ``SyntheticLM`` of either package whose batches carry M-RoPE
    positions 0..S-1 on all three streams and no image."""

    def __init__(self, data):
        self.data, self.cfg = data, data.cfg

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        batch = self.data.batch_at(step, shard, num_shards)
        B, S = batch["tokens"].shape
        batch["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
        return batch


class ScaledPatches:
    """``WithPatches`` with its patch rows times ``scale``."""

    def __init__(self, data, scale: float):
        self.data, self.cfg, self.scale = data, data.cfg, scale

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        batch = self.data.batch_at(step, shard, num_shards)
        batch["patch_embeds"] = (batch["patch_embeds"] *
                                 np.float32(self.scale))
        return batch


def config(cfgs, d_model: int, d_ff: int, vocab: int, layers: int):
    """qwen2-vl-72b from a package's ``configs`` at the given widths."""
    hd = 128 if d_model >= 1024 else 32
    heads = d_model // hd
    kv = max(1, heads // 8) if hd == 128 else 2
    cfg = cfgs.reduced(cfgs.get_config(ARCH), num_layers=layers,
                       d_model=d_model, d_ff=d_ff, vocab_size=vocab,
                       num_heads=heads, num_kv_heads=kv, head_dim=hd)
    if hd == 128:
        cfg = dataclasses.replace(cfg, mrope_sections=(16, 24, 24))
    return cfg


def data_for(train, cfg, args):
    """A package's ``SyntheticLM`` batches of one sequence, with the image
    that ``args`` asks for."""
    data = train.SyntheticLM(train.DataConfig(cfg.vocab_size, args.seq, 1,
                                              seed=0))
    if args.grid == 0:
        return TextPositions(data)
    data = WithPatches(data, (args.grid, args.grid), cfg.d_model)
    return data if args.patch_scale == 1.0 else \
        ScaledPatches(data, args.patch_scale)


def collapse(model, batch, P: int) -> dict:
    """The port's hidden rows on ``batch``: the mean cosine of the
    final-normed text rows with their mean, and the mean top logit above
    the median logit over those rows."""
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import logits_from_hidden
    with torch.no_grad():
        h, _ = model._forward(
            torch.as_tensor(batch["tokens"], device=model.device),
            positions=batch.get("positions"),
            patch_embeds=batch.get("patch_embeds"))
        h = tfm.norm(model.cfg, h, model.ln_f.to(h.dtype))[0, P:].float()
        cos = torch.nn.functional.cosine_similarity(
            h, h.mean(0, keepdim=True), dim=-1).mean()
        z = logits_from_hidden(model.embed, h, model.cfg.vocab_size,
                               model.cfg.tie_embeddings)
        top = (z.max(-1).values - z.median(-1).values).mean()
    return {"text_cos": round(float(cos), 4), "top_logit": round(float(top), 3)}


def port_run(model, data, opt, steps: int, P: int) -> dict:
    """A port ``Trainer`` of ``steps`` steps, with ``collapse`` read
    before each."""
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.trainer import load_working
    tr = Trainer(model, data, TrainConfig(steps=steps, ckpt_interval=10 ** 9,
                                          opt=opt))
    rows = [collapse(model, data.batch_at(0), P)]

    def after(step, _metrics):
        if step < steps:
            load_working(model, tr.params)
            rows.append(collapse(model, data.batch_at(step), P))
    hist = tr.run(on_metrics=after)["history"]
    return {"losses": [round(h["loss"], 4) for h in hist],
            "grad_norm": [round(h["grad_norm"], 2) for h in hist],
            "collapse": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--d-ff", type=int, default=0,
                    help="default: 3.61 x d_model, rounded to 8")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grid", type=int, default=2,
                    help="the image's g x g patches (0: no image)")
    ap.add_argument("--patch-scale", type=float, default=1.0)
    ap.add_argument("--lr", default="3e-4",
                    help="peak learning rates, comma-separated")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--packages", default="port,reference",
                    help="on the CPU: port, reference or both")
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    d_ff = args.d_ff or 8 * round(args.d_model * 29568 / 8192 / 8)

    import torch
    import repro_torch.configs as tcfgs
    import repro_torch.train as ttrain
    from repro_torch.models.model import Model
    on_card = args.device != "cpu"
    packages = ["port"] if on_card else args.packages.split(",")
    torch.set_num_threads(args.threads)
    cfg = config(tcfgs, args.d_model, d_ff, args.vocab, args.layers)
    P = args.grid ** 2
    out = {"args": vars(args), "d_ff": d_ff, "runs": []}
    if on_card:
        from repro_torch.kernels import _build
        _build.build_all(["flash_attention", "flash_attention_bwd"])
    else:
        import jax
        import repro.configs as jcfgs
        import repro.train as jtrain
        from repro.models.common import Policy as JaxPolicy
        from repro.models.model import Model as JaxModel
        from repro_torch.convert import model_params
        from repro_torch.models.common import Policy
        jcfg = config(jcfgs, args.d_model, d_ff, args.vocab, args.layers)
        jm = JaxModel(jcfg, JaxPolicy(compute_dtype=jax.numpy.float32))
        init, _ = jm.init_params(jax.random.key(0))
        init = jax.tree.map(np.asarray, init)
    for lr in map(float, args.lr.split(",")):
        opt = dict(peak_lr=lr, warmup_steps=2, total_steps=args.steps)
        run = {"lr": lr}
        if "reference" in packages:
            ref = jtrain.Trainer(jm, data_for(jtrain, jcfg, args),
                                 jtrain.TrainConfig(
                                     steps=args.steps, ckpt_interval=10 ** 9,
                                     opt=jtrain.AdamWConfig(**opt)), seed=0)
            run["reference"] = [round(h["loss"], 4)
                                for h in ref.run()["history"]]
            del ref
        if "port" in packages:
            if on_card:
                model = Model(cfg, device=args.device, seed=0, remat="full")
            else:
                model = model_params(init, cfg, policy=Policy(
                    compute_dtype=torch.float32), device="cpu")
            run["port"] = port_run(model, data_for(ttrain, cfg, args),
                                   ttrain.AdamWConfig(**opt), args.steps, P)
            del model
        if "port" in run and "reference" in run:
            run["max_rel_gap"] = max(
                abs(a - b) / abs(b)
                for a, b in zip(run["port"]["losses"], run["reference"]))
        out["runs"].append(run)
        print(json.dumps(run), flush=True)
        if on_card:
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
