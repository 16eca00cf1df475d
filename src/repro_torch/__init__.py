"""Guard on PyTorch and CUDA: the port of the JAX package ``repro``.

The package imports ``torch`` and never ``jax``, nor anything of
``repro``; its tests hold it against ``repro`` on the same inputs. Every
entry point takes an explicit ``device`` that defaults to ``"cuda"``, and
each TPU kernel on the ported path has a hand-written Hopper kernel in
``repro_torch/csrc/``, wrapped in ``repro_torch.kernels``.

  device    device resolution (no silent CPU fall back)
  core      telemetry, detector, policy, monitor, sweep, triage, manager
  guard     GuardSession facade, events, scheduler, local substrates
  kernels   fleet_score and sweep_burn (CUDA kernels + plain versions)
  convert   reference configs and detector state into the port
"""
