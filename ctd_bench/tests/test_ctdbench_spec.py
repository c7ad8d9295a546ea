"""BENCHMARK.json against the benchmark's contract, and every cell's
pieces found by name from files alone."""

import json
import os
import re

import pytest

from ctd_bench import harness, traffic
from ctd_bench.compare import load_limits

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "ctd_bench/run.py"]
    assert BENCH["paths"] == ["ctd_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(BENCH["end_to_end"]) + len(
        BENCH["per_layer"])


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"ctd_bench/configs/{cfg['name']}.json"
    config = harness.load_config(cfg["name"])
    assert config["name"] == cfg["name"] and config["dtype"] in ("bfloat16", "float32")
    assert os.path.exists(os.path.join(harness.ROOT, config["weights"]))
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and cell["chips"] in (1, 4)
    assert len(cell["why"]) <= 200
    mix = traffic.load_mix(cell["traffic"])
    loop = harness.load_loop(mix["loop"])
    for fn in ("setup", "window", "outputs", "release", "check"):
        assert callable(getattr(loop, fn))
    limits = load_limits(cell["name"])
    assert limits and all(v > 0 for v in limits.values())
    wanted = harness.metrics_of(BENCH, cell["name"])
    e2e = {m["name"] for m in wanted["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert wanted["per_layer"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_reader_found_by_name(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    read = harness.load_reader(metric["name"])
    assert read({}) is None  # nothing to read: nothing returned


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert UNIT.match(metric["unit"])
