"""Every name in BENCHMARK.json resolves to its file under ptbench/, and
the files keep to the benchmark's contract."""

import json
import re

import pytest

from ptbench import harness, trace

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    data = harness.load_json("workloads", cell)
    assert data["config"] == entry["config"]
    assert data["traffic"] == entry["traffic"]
    config = harness.load_json("configs", data["config"])
    assert config["chips"] == entry["chips"]
    mode = harness.load_module("modes", data["mode"])
    assert hasattr(mode, "Mode") and hasattr(mode, "main")
    assert data["limits"]


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_resolves(config):
    from pathtracer_tpu_torch.config import RenderConfig

    data = harness.load_json("configs", config["name"])
    assert config["file"] == f"ptbench/configs/{config['name']}.json"
    assert data["reduced"] == config["reduced"]
    RenderConfig(**data["preset"])


@pytest.mark.parametrize(
    "metric", BENCH["end_to_end"] + BENCH["per_layer"],
    ids=[m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_resolves(metric):
    mod = harness.load_module("metrics", metric["name"])
    assert callable(mod.read)
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    for cell in metric.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, w["name"],
                                                       False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, w["name"], True)


@pytest.mark.parametrize("span", sorted(trace.span_specs()))
def test_span_targets_resolve(span):
    for module, dotted in trace.span_specs()[span]["targets"]:
        owner, attr = trace._resolve(module, dotted)
        assert callable(getattr(owner, attr))


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
