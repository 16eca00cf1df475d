"""What the benchmark loads: no module whose top-level name (the part
before the first dot, compared whole) is jax, jaxlib, flax, the JAX
package ``repro`` or its harness ``benchmarks``; the references load
nothing of the program ``repro_torch`` either."""
import json
import os
import subprocess
import sys

import pytest

from bench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
REFERENCE = ["bench.reference.common", "bench.reference.moe",
             "bench.reference.ssm", "bench.guard_ref", "bench.weights",
             "bench.traffic", "bench.flops.moe", "bench.flops.ssm",
             "bench.kernels.roofline", "bench.trace"]


def _top_names(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=ROOT, env=env, check=True,
        capture_output=True, text=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_reference_loads_no_program():
    names = _top_names("\n".join(f"import {m}" for m in REFERENCE))
    assert not names & (FORBIDDEN | {"repro_torch"})


@pytest.mark.parametrize("name", ["moe16b.train.4k", "rwkv6.train.4k"])
def test_a_run_loads_no_jax(name):
    code = ("import bench.run as run\n"
            "from bench import harness\n"
            "from bench.tests.tiny_cells import tiny\n"
            f"harness.run_cell(tiny({name!r}), 5, 0.5, False, 'cpu',"
            " 0.0)\n"
            "assert not run.forbidden_modules(), run.forbidden_modules()")
    names = _top_names(code)
    assert "repro_torch" in names
    assert not names & FORBIDDEN
