"""The PyTorch port imports with JAX absent and loads nothing of the JAX
package: every ``repro_torch`` module is imported in a fresh interpreter
where ``import jax`` fails."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
print(json.dumps({"imported": names, "reference_modules": bad}))
"""


def _module_names():
    return ["repro_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch."))


def test_imports_without_jax_and_without_repro():
    import json
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["reference_modules"] == []
    assert sorted(out["imported"]) == sorted(_module_names())


def test_every_module_is_covered():
    # the walk must reach the slice's modules, so a rename cannot make the
    # probe above vacuous
    names = set(_module_names())
    for want in ("repro_torch.core.detector", "repro_torch.guard.session",
                 "repro_torch.kernels.fleet_score.fleet_score",
                 "repro_torch.kernels.sweep_burn.sweep_burn",
                 "repro_torch.convert", "repro_torch.device",
                 "repro_torch.configs", "repro_torch.configs.qwen3_4b",
                 "repro_torch.configs.rwkv6_7b",
                 "repro_torch.models.model", "repro_torch.models.rwkv6",
                 "repro_torch.models.transformer",
                 "repro_torch.kernels.flash_attention.flash_attention",
                 "repro_torch.kernels.wkv6.wkv6",
                 "repro_torch.launch.serve", "repro_torch.launch.train",
                 "repro_torch.train", "repro_torch.train.optimizer",
                 "repro_torch.train.data", "repro_torch.train.checkpoint",
                 "repro_torch.train.trainer", "repro_torch.guard.hook",
                 "repro_torch.guard.goodput", "repro_torch.ccltrace.spans",
                 "repro_torch.ccltrace.watchdog",
                 "repro_torch.diagnose.rootcause",
                 "repro_torch.diagnose.whatif", "repro_torch.diagnose.trace",
                 "repro_torch.simcluster.cluster",
                 "repro_torch.simcluster.runtime",
                 "repro_torch.simcluster.scenarios",
                 "repro_torch.dist", "repro_torch.dist.api",
                 "repro_torch.launch.mesh", "repro_torch.models.moe",
                 "repro_torch.configs.deepseek_moe_16b",
                 "repro_torch.configs.llama4_scout_17b_a16e",
                 "repro_torch.models.rglru",
                 "repro_torch.kernels.rglru",
                 "repro_torch.kernels.rglru.rglru",
                 "repro_torch.kernels.rglru.ops",
                 "repro_torch.kernels.rglru.ref",
                 "repro_torch.configs.recurrentgemma_9b",
                 "repro_torch.launch.dryrun",
                 "repro_torch.launch.step_analysis",
                 "repro_torch.launch.roofline",
                 "repro_torch.kernels.meta", "repro_torch.models.fsdp"):
        assert want in names


def test_cuda_sources_ship_with_the_package():
    csrc = SRC / "repro_torch" / "csrc"
    assert (csrc / "fleet_score.cu").is_file()
    assert (csrc / "sweep_burn.cu").is_file()
    assert (csrc / "flash_attention.cu").is_file()
    assert (csrc / "rglru.cu").is_file()
    assert (csrc / "flash_attention_bwd.cu").is_file()
    assert (csrc / "wkv6.cu").is_file()


_ENTRY_PROBE = r"""
import sys
sys.modules["jax"] = None
from repro_torch.guard import GuardStepHook
from repro_torch.launch.train import main
from repro_torch.train import Trainer
print("ok")
"""


def test_training_entry_points_import_without_jax_and_default_to_cuda():
    import inspect

    from repro_torch.guard import GuardStepHook
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _ENTRY_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
    for entry in (GuardStepHook, Model):
        assert inspect.signature(entry).parameters["device"].default \
            == "cuda"
    assert train.parser().parse_args([]).device == "cuda"
