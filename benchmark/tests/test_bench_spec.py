"""BENCHMARK.json against the contract it is written to, and every piece it
names found by name under benchmark/."""

import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["workloads"]) <= 24
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    names = [x["name"] for x in SPEC["configs"] + SPEC["workloads"]
             + METRICS]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    path = os.path.join(harness.ROOT, conf["file"])
    data = harness.load_json(path)
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"]
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    widths = re.compile(r"(_dim|_rank|hidden|intermediate|latent|size)")
    assert not any(widths.search(k) for k in conf["reduced"])
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_pieces_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    harness.config(cell["config"])
    traffic = harness.traffic(cell["traffic"])
    driver = harness.driver(traffic["mode"])
    assert callable(driver.unit_flops) and callable(driver.control_readings)
    assert traffic.get("ranks", 1) in (1, cell["chips"])
    limits = harness.limits(cell["name"])
    assert limits and all(v >= 0 for v in limits.values())
    e2e = harness.cell_metrics(SPEC, cell["name"], False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = harness.cell_metrics(SPEC, cell["name"], True)
    assert layer
    for m in layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    assert callable(harness.reader(metric["name"]))
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        reported = {c for c in CELLS if metric["moves"] in {
            m["name"] for m in harness.cell_metrics(SPEC, c, False)}}
        assert set(metric.get("workloads", reported)) <= reported
    if "roofline" in metric["name"]:
        assert metric["name"].endswith("_roofline") \
            and metric["unit"] == "%"


def test_layers_named_alike():
    for m in SPEC["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("stage", sorted(harness.stages()))
def test_kernel_stage(stage):
    st = harness.stages()[stage]
    assert st["kernels"] and all(isinstance(k, str) for k in st["kernels"])
    assert callable(st["least_s"])


def test_roofline_metrics_name_a_stage():
    stages = harness.stages()
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["name"][:-len("_roofline")] in stages


def test_command():
    assert SPEC["command"] == ["python3", "-m", "benchmark.run"]
    assert json.dumps(SPEC["command"]).count("/") == 0
