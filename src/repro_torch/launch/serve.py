"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Batched decode serving with continuous batching over a synthetic request
stream, the port of ``repro.launch.serve``: requests arrive with a prompt
length and a decode budget; slots are backfilled as sequences finish.
Without ``--full`` it serves the reduced config; ``--full`` serves the
published widths and depth. ``--arch`` takes the dense, moe, ssm, hybrid,
audio and vlm families (qwen3-4b, deepseek-moe-16b, llama4-scout-17b-a16e,
rwkv6-7b, recurrentgemma-9b, whisper-small, qwen2-vl-72b, ...). It runs on
the card (``--device cuda``, the default) unless asked for the CPU.

The server keeps the reference's behaviour on purpose, so that both
packages give the same token streams: prompts are fed by decode steps
(no prefill call), one cache position ``pos`` is shared by all slots, so
a request admitted later attends to the rows its slot's earlier occupant
wrote, and a position past the cache writes nothing. An idle slot is fed
token 0, and in the moe family a decode step routes all slots as one
call: idle slots take expert capacity, and slots beyond an expert's
capacity lose their routed output for that layer. In the hybrid family
the attention layers' caches are rings of ``window`` slots (``--cache-len``
only bounds the run) and the recurrent layers carry their state. In the
audio family no prefill means no encoder pass: the cross caches stay the
zeros of ``init_cache``, so each decoder layer's cross attention reads
zero values and adds nothing. In the vlm family no prefill means no image:
the requests are text, and M-RoPE rotates by the cache's ``pos`` on all
three streams, which is plain RoPE.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cursor: int = 0


def synthetic_requests(n: int, vocab: int, seed: int = 0) -> List[Request]:
    """The JAX package's request stream: the same numpy generator, so both
    packages draw the same prompts and budgets."""
    rng = np.random.RandomState(seed)
    return [Request(i, rng.randint(0, vocab, rng.randint(4, 17)),
                    int(rng.randint(8, 33))) for i in range(n)]


class BatchedServer:
    """Fixed-slot continuous batching decode server."""

    def __init__(self, model: Model, slots: int, cache_len: int):
        self.model = model
        self.slots = slots
        self.cache_len = cache_len
        self.cache = model.init_cache(slots, cache_len)
        self.slot_req: List[Optional[Request]] = [None] * slots

    def _feed(self, queue: List[Request]) -> None:
        for s in range(self.slots):
            if self.slot_req[s] is None and queue:
                req = queue.pop(0)
                req.cursor = 0       # prefill-by-decode: one prompt token
                self.slot_req[s] = req   # per step

    def run(self, queue: List[Request]) -> dict:
        """Greedy decoding until the queue and the slots are empty or the
        cache is exhausted. Wall time ends with a synchronize."""
        done: List[Request] = []
        steps = 0
        dev = self.model.device
        t0 = time.perf_counter()
        self._feed(queue)
        while any(r is not None for r in self.slot_req) or queue:
            toks = np.zeros(self.slots, np.int64)
            for s, req in enumerate(self.slot_req):
                if req is None:
                    continue
                if req.cursor < len(req.prompt):
                    toks[s] = req.prompt[req.cursor]
                elif req.out:
                    toks[s] = req.out[-1]
            logits, self.cache = self.model.decode_step(
                torch.from_numpy(toks).to(dev), self.cache)
            steps += 1
            nxt = logits.argmax(dim=-1).cpu().numpy()
            for s, req in enumerate(self.slot_req):
                if req is None:
                    continue
                if req.cursor < len(req.prompt) - 1:
                    req.cursor += 1              # still consuming the prompt
                    continue
                req.cursor += 1
                req.out.append(int(nxt[s]))
                if len(req.out) >= req.max_new:
                    req.done = True
                    done.append(req)
                    self.slot_req[s] = None
            self._feed(queue)
            if self.cache["pos"] >= self.cache_len - 1:
                break                            # cache exhausted (demo bound)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        toks_out = sum(len(r.out) for r in done)
        return {"requests_done": len(done), "decode_steps": steps,
                "tokens_out": toks_out, "wall_s": dt,
                "tok_per_s": toks_out / dt if dt else 0.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    help="a dense, moe, ssm, hybrid, audio or vlm "
                         "architecture id, e.g. qwen3-4b, deepseek-moe-16b, "
                         "llama4-scout-17b-a16e, rwkv6-7b, "
                         "recurrentgemma-9b, whisper-small, qwen2-vl-72b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    model = Model(cfg, device=args.device, seed=args.seed)
    server = BatchedServer(model, args.slots, args.cache_len)
    queue = synthetic_requests(args.requests, cfg.vocab_size, args.seed)
    print(f"[serve] {cfg.name} on {model.device}: {args.requests} requests, "
          f"{args.slots} slots, cache {args.cache_len}")
    out = server.run(queue)
    print(f"[serve] {out['requests_done']} done in {out['decode_steps']} "
          f"steps, {out['tokens_out']} tokens, "
          f"{out['tok_per_s']:.1f} tok/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
