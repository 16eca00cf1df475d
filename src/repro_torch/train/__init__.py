"""``repro_torch.train``: the training slice of the port.

  optimizer   AdamW with global-norm clipping, warmup + cosine schedule
  data        the deterministic synthetic LM stream (numpy, bit-equal)
  checkpoint  atomic async durable checkpoints + peer/local fast tiers
  trainer     train step (float32 master weights, bf16 working weights;
              ZeRO-3 over "data" under a mesh), Guard step hook
              protocol, the fault-tolerant Trainer loop
"""
from repro_torch.train.checkpoint import (CheckpointManager,
                                          TieredCheckpointManager)
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import (AdamWConfig, apply_adamw,
                                         global_norm, init_opt_state, lr_at)
from repro_torch.train.trainer import (TrainConfig, Trainer,
                                       make_serve_step, make_train_step)

__all__ = [
    "AdamWConfig", "CheckpointManager", "DataConfig", "SyntheticLM",
    "TieredCheckpointManager",
    "TrainConfig", "Trainer", "apply_adamw", "global_norm", "init_opt_state",
    "lr_at", "make_serve_step", "make_train_step",
]
