"""Every file BENCHMARK.json names loads by its name, and the entries keep
to the benchmark's own shape rules."""
import importlib
import json
import re

import pytest

from bench import harness, traffic
from bench.tests.tiny_cells import names

BM = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["paths"] == ["bench"]
    assert 1 <= BM["run_seconds"] <= 51


@pytest.mark.parametrize("name", names())
def test_cell_loads(name):
    c = harness.cell(BM, name)
    assert c["workload"]["chips"] == 1
    fam = harness.family(c["config"])
    spec = fam.param_spec(harness.ref_config(c["config"]))
    assert len({n for n, _, _ in spec}) == len(spec)
    assert harness.flops_per_step(c["config"], c["traffic"]) > 0
    assert "guard" in c["limits"]
    checks = harness.family_checks(c["config"])
    own = checks.NUMBERS if checks is not None else set()
    assert set(c["limits"]) <= {"loss", "loss_first", "grad_head", "grad",
                                "change", "adamw", "guard"} | own
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s",
                                                    "tokens_per_s"}
    assert c["per_layer"]


@pytest.mark.parametrize("entry", BM["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    conf = json.loads((harness.ROOT / entry["file"]).read_text())
    assert conf["source"] == entry["source"]
    assert entry["file"].startswith("bench/configs/")
    for key in entry["reduced"]:
        assert key in conf["reduced"]


@pytest.mark.parametrize("name", sorted({w["traffic"]
                                         for w in BM["workloads"]}))
def test_traffic_file(name):
    tf = traffic.load(name)
    data = traffic.source(tf, 1000, 2 ** 31 + 5)
    b = data.batch_at(3)
    assert b["tokens"].shape == (tf["global_batch"], tf["seq_len"])
    again = traffic.source(tf, 1000, 2 ** 31 + 5).batch_at(3)
    assert (b["tokens"] == again["tokens"]).all()


@pytest.mark.parametrize("metric", BM["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    mod = importlib.import_module(f"bench.metrics.{metric['name']}")
    assert callable(mod.read)
    assert metric["moves"] in {m["name"] for m in BM["end_to_end"]}
    assert set(metric["workloads"]) <= set(names())


def test_names_and_bounds():
    every = [*BM["configs"], *BM["workloads"], *BM["end_to_end"],
             *BM["per_layer"]]
    for e in every:
        assert NAME.match(e["name"]), e["name"]
    for m in BM["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BM["end_to_end"])
    assert len(json.dumps(BM)) < 64 * 1024
