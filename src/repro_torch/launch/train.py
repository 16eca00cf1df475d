"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``. By default it trains a REDUCED config
end to end on ``--device`` (``cuda`` unless asked otherwise); ``--full``
trains the published config, at ~16 bytes a parameter (working weights,
gradients, float32 master weights and the two moments: ~70 GB for
qwen3-4b before activations). ``--arch`` takes the dense family
(qwen3-4b, phi3-mini-3.8b, ...), the moe family (deepseek-moe-16b,
llama4-scout-17b-a16e: routed experts, whose loss adds the router's aux
term), the ssm family (rwkv6-7b, whose WKV6 runs through the forward
and backward kernels on the card) and the hybrid family
(recurrentgemma-9b, whose RG-LRU scan and windowed attention do too; a
sequence longer than its window must be a multiple of it). The audio
family (whisper-small) needs encoder frames that ``SyntheticLM`` batches
do not hold: as with the reference's launcher, its first step raises a
``KeyError`` naming ``enc_frames``; train it through ``Trainer`` with a
data source whose batches carry them. Guard is wired in as the per-step
hook: step times stream into the online monitor, and an IMMEDIATE-tier
event restarts from the last checkpoint, the closed loop of Fig. 1 at
single-host scale.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core import DetectorConfig, Frame, OnlineMonitor, PolicyConfig
from repro_torch.device import DeviceLike, resolve
from repro_torch.models.model import Model
from repro_torch.train import (AdamWConfig, CheckpointManager, DataConfig,
                               SyntheticLM, TrainConfig, Trainer)


class GuardStepHook:
    """Adapts trainer step timing to Guard telemetry frames.

    Single-host stand-in: each step contributes one 'node' sample; on a real
    deployment every host reports its own barrier time into the fleet frame.
    The detector runs on ``device``.
    """

    def __init__(self, window: int = 6, device: DeviceLike = "cuda"):
        self.monitor = OnlineMonitor(
            DetectorConfig(window=6, persistence=4, device=str(device)),
            PolicyConfig())
        self.window = window
        self._buf = []
        self.restarts = 0

    def __call__(self, step: int, wall_s: float, metrics) -> bool:
        self._buf.append(wall_s)
        if len(self._buf) < self.window:
            return False
        frame = Frame(
            t=float(step), step=step,
            node_ids=np.arange(1, dtype=np.int64),
            metrics={"step_time": np.asarray([np.mean(self._buf)])},
            valid=np.ones(1, bool))
        self._buf.clear()
        # peer-relative detection needs peers; at single-host scale this
        # exercises the plumbing (stall detection still works)
        events = self.monitor.observe(frame)
        for ev in events:
            if ev.decision.action.value == "immediate_restart":
                self.restarts += 1
                return True
        return False


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    help="a dense, moe, ssm or hybrid architecture id, "
                         "e.g. qwen3-4b, deepseek-moe-16b, "
                         "llama4-scout-17b-a16e, rwkv6-7b, "
                         "recurrentgemma-9b (an audio id such as "
                         "whisper-small raises: SyntheticLM batches hold "
                         "no enc_frames; so does the vlm id qwen2-vl-72b: "
                         "they hold no M-RoPE positions)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "directory, so a stale checkpoint cannot skip "
                         "training)")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the detector run "
                         "(cuda or cpu)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    device = resolve(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    print(f"[train] {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"params={cfg.param_count()/1e6:.1f}M on {device}")

    model = Model(cfg, device=device, seed=args.seed)
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq_len, args.batch,
                                  seed=args.seed))
    hook = GuardStepHook(device=device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    trainer = Trainer(
        model, data,
        TrainConfig(steps=args.steps, ckpt_interval=args.ckpt_interval,
                    microbatch=args.microbatch,
                    opt=AdamWConfig(peak_lr=args.lr,
                                    warmup_steps=max(args.steps // 20, 1),
                                    total_steps=args.steps)),
        ckpt=CheckpointManager(ckpt_dir), hook=hook)

    def log(step, m):
        if step % 10 == 0 or step == 1:
            print(f"  step {step:5d}  loss {m['loss']:.4f}  "
                  f"gnorm {m['grad_norm']:.3f}  lr {m['lr']:.2e}")

    out = trainer.run(on_metrics=log)
    losses = [h["loss"] for h in out["history"]]
    walls = [h["wall_s"] for h in out["history"]]
    print(f"[train] done: {out['final_step']} steps, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"median step {np.median(walls)*1e3:.0f} ms, "
          f"guard restarts {hook.restarts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
