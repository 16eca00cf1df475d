"""How far the sharded Trainer's state lies from the single-process
port's after one and after two steps, and why: the numbers behind
``tests/test_torch_tp_ssm.py``'s Trainer check, on the CPU.

Four gloo ranks run two float32 ``Trainer`` steps of a reduced model
(``tests/torch_tp_workers.py``'s ``trainer``: the port's seed-0 weights,
4 x 32 tokens, AdamW at peak 1e-3) under each mesh of ``--meshes``, then
take plain ``train_loss`` gradients (no Trainer) of step 2's batch under
a (1, 4) mesh at two step-1 states: the single process's and the first
mesh's sharded run's. One process runs the same two steps with no mesh,
step 2 again from each mesh's step-1 state, and step 2 from its own
step-1 state with every master weight, or (rwkv6) each WKV output inside
the step, times (1 + eps N(0, 1)) for each ``--eps``. Prints the five
largest gaps over each leaf's largest magnitude: of the moments after
each step, of step 2 taken from the sharded step-1 state, of the
perturbed steps, and of the plain gradients; and (rwkv6) the smallest
per-head variance of the group norm's input in each layer at the single
process's step-1 state (the norm's eps is 1e-5).

    PYTHONPATH=src:tests python tools/tp_trainer_noise.py --arch rwkv6-7b
"""
from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import sys
import tempfile
from unittest import mock

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.join(HERE, "..", "src"),
                os.path.join(HERE, "..", "tests")]
import torch_tp_workers as w  # noqa: E402


def _name(arch: str, shape) -> str:
    return f"{arch}@" + "x".join(map(str, shape))


def _single(arch: str) -> str:
    name = _name(arch, (1,))
    w.RUNS[name] = (arch, (1,), ("data",), {})
    return name


def _grads(arch: str, masters: dict, rank: int = 0):
    """Plain ``train_loss`` gradients of step 2's batch at ``masters`` (the
    rank's slices under the active mesh), as numpy, and the split dims."""
    import torch
    tr = w.trainer(_single(arch))          # a model under the active mesh
    model = tr.model
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(model.tp_slice(n, masters[f"p/{n}"])))
            p.requires_grad_(True)
    model.train_loss(tr.data.batch_at(1))[0].backward()
    return ({n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            dict(model.tp_dims), 0 if model.tp is None else model.tp.rank,
            1 if model.tp is None else model.tp.size)


def _rank(r: int, out: str, arch: str, meshes) -> None:
    import torch
    import torch.distributed as tdist
    from repro_torch.dist import api as dist
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(
        os.path.join(out, "store"), 4), rank=r, world_size=4)
    for shape in meshes:
        name = _name(arch, shape)
        w.RUNS[name] = (arch, shape, ("data", "model"), {})
        w.trainer_run(r, out, name)
    tdist.barrier()
    tr = w.trainer(_single(arch), steps=1)      # no mesh: the same on each
    tr.run()
    states = {"single": w._state(tr), "sharded": w.load(os.path.join(
        out, f"{_name(arch, meshes[0])}_step1.npz"))}
    with dist.use_mesh(w.mesh_of((1, 4))):
        for tag, st in states.items():
            g, dims, rank, size = _grads(arch, st)
            if r == 0:
                np.savez(os.path.join(out, f"grads_{tag}.npz"), **g)
                np.save(os.path.join(out, "dims.npy"),
                        np.array([dims, rank, size], dtype=object))
    tdist.destroy_process_group()


def _gaps(got: dict, want: dict, top: int = 5, moments: bool = True
          ) -> list:
    gaps = sorted(((float(np.abs(got[k] - v).max() /
                          max(np.abs(v).max(), 1e-30)), k)
                   for k, v in want.items()
                   if not (moments and k.startswith("p/"))), reverse=True)
    return [(k, f"{g:.3e}") for g, k in gaps[:top]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--meshes", default="2x2,4x1,1x4")
    ap.add_argument("--eps", default="1e-7")
    args = ap.parse_args(argv)
    meshes = [tuple(int(n) for n in m.split("x"))
              for m in args.meshes.split(",")]
    out = tempfile.mkdtemp(prefix="tp_noise_")
    procs = [mp.get_context("spawn").Process(
        target=_rank, args=(r, out, args.arch, meshes)) for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    assert [p.exitcode for p in procs] == [0] * 4
    single = _single(args.arch)
    tr = w.trainer(single)
    tr.run()
    two = w._state(tr)
    for shape in meshes:
        name = _name(args.arch, shape)
        w.RUNS[name] = (args.arch, shape, ("data", "model"), {})
        got1 = w.load(os.path.join(out, f"{name}_step1.npz"))
        got2 = w.load(os.path.join(out, f"{name}.npz"))
        _, want1, want2 = w.single_steps(single, got1)
        print(f"{name}: step 1 {_gaps(got1, want1)}")
        print(f"{name}: step 2 of two independent runs {_gaps(got2, two)}")
        print(f"{name}: step 2 from the sharded step-1 state "
              f"{_gaps(got2, want2)}")
    tr = w.trainer(single, steps=1)
    tr.run()
    state1 = w._state(tr)
    _, _, base = w.single_steps(single, state1)
    rng = np.random.default_rng(0)
    for eps in (float(e) for e in args.eps.split(",")):
        noisy = {k: (v * (1 + eps * rng.standard_normal(v.shape))).astype(
            np.float32) if k.startswith("p/") else v
            for k, v in state1.items()}
        _, _, twin = w.single_steps(single, noisy)
        print(f"single process, step 2 from its step-1 state with the "
              f"masters times (1 + {eps:g} N(0, 1)): {_gaps(twin, base)}")
        if args.arch != "rwkv6-7b":
            continue
        import torch
        import repro_torch.models.rwkv6 as rwkv6
        real, gen = rwkv6.wkv6, torch.Generator().manual_seed(0)

        def noisy_wkv(*a, **kw):
            y, s = real(*a, **kw)
            return y * (1 + eps * torch.randn(y.shape, generator=gen)), s
        with mock.patch.object(rwkv6, "wkv6", noisy_wkv):
            _, _, twin = w.single_steps(single, state1)
        print(f"single process, step 2 from its step-1 state with each WKV "
              f"output times (1 + {eps:g} N(0, 1)): {_gaps(twin, base)}")
    dims, rank, size = np.load(os.path.join(out, "dims.npy"),
                               allow_pickle=True)
    sharded1 = w.load(os.path.join(
        out, f"{_name(args.arch, meshes[0])}_step1.npz"))
    for tag, st in (("single", state1), ("sharded", sharded1)):
        got = w.load(os.path.join(out, f"grads_{tag}.npz"))
        want, _, _, _ = _grads(args.arch, st)
        want = {n: w.rank_slice(g, dims.get(n), rank, size)
                for n, g in want.items()}
        print(f"plain train_loss gradients at (1, 4), rank {rank}, at the "
              f"{tag} step-1 state ({_name(args.arch, meshes[0])} for the "
              f"sharded): {_gaps(got, want, moments=False)}")
    if args.arch == "rwkv6-7b":
        import torch
        import repro_torch.models.rwkv6 as rwkv6
        tr = w.trainer(single, steps=1)
        tr.run()
        lows, real_gn = [], rwkv6.group_norm

        def gn(x, s, b, num_groups, eps=1e-5):
            xg = x.float().reshape(*x.shape[:-1], num_groups, -1)
            lows.append(float(xg.var(-1, unbiased=False).min()))
            return real_gn(x, s, b, num_groups=num_groups, eps=eps)
        with mock.patch.object(rwkv6, "group_norm", gn), torch.no_grad():
            tr.model.train_loss(tr.data.batch_at(1))
        print(f"smallest per-head group-norm input variance by layer at the "
              f"single process's step-1 state: "
              + ", ".join(f"{v:.3e}" for v in lows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
