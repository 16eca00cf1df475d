"""Guard on PyTorch and CUDA: the port of the JAX package ``repro``.

The package imports ``torch`` and never ``jax``, nor anything of
``repro``; its tests hold it against ``repro`` on the same inputs. Every
entry point takes an explicit ``device`` that defaults to ``"cuda"``, and
each TPU kernel on the ported path has a hand-written Hopper kernel in
``repro_torch/csrc/``, wrapped in ``repro_torch.kernels``.

  device    device resolution (no silent CPU fall back)
  core      telemetry, detector, policy, monitor, sweep, triage, manager
  guard     GuardSession facade, events, scheduler, step hook, goodput
  diagnose  timing trace, what-if blame, root-cause Diagnoser (host NumPy)
  ccltrace  collective span trace and the hang watchdog (host NumPy)
  simcluster  simulated fleet, faults, scenarios, ``simulate_run`` (host
            NumPy; each window's frame is scored on ``device``)
  kernels   fleet_score, sweep_burn, flash_attention and wkv6 (CUDA
            kernels + plain versions)
  configs   the architecture configs (the port's own copy)
  models    dense and ssm models: training loss, prefill and decode
  dist      logical-axis sharding over a DeviceMesh (ZeRO-3 over "data")
  train     AdamW, data, checkpoints, the (sharded) train step, Trainer
  launch    serve, train, and mesh construction
  convert   reference configs, detector and timing-trace state, run
            configs and model parameters into the port
"""
