"""BENCHMARK.json and the files the harness finds by its names: every
configuration, traffic mix and metric has its file, each metric file
names itself, and the entries keep to the benchmark's contract."""

import json
import re

import pytest

from rxbench import spec
from rxbench.run import ROOT

BENCH = spec.load_bench(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "rxbench/run.py"]
    assert BENCH["paths"] == ["rxbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    c = spec.cell(BENCH, w["name"], ROOT)
    assert c.config["name"] == w["config"]
    assert {"esn0_db", "ring_frames", "in_flight", "warmup_calls",
            "check_frames", "profile"} <= set(c.traffic)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    with open(ROOT / c["file"]) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"]
    assert c["file"].startswith("rxbench/configs/")
    assert set(c["reduced"]) <= set(cfg)
    assert cfg["control"]["why"] and cfg["control"]["precision"]
    drv = spec.driver(cfg["driver"])
    assert drv.Driver and all(v >= 0 for v in drv.LIMITS.values())
    for f in cfg.get("faults", {}).values():
        assert f["why"] and f["rx"]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_files(m):
    mod = spec.metric(m["name"])
    assert mod.NAME == m["name"] and mod.UNIT == m["unit"]
    assert mod.LAYER == m["layer"]
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_files(m):
    mod = spec.end_to_end(m["name"])
    assert mod.NAME == m["name"] and mod.UNIT == m["unit"]
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


def test_names_and_units():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_merge_overrides_nested():
    base = {"a": {"b": 1, "c": 2}, "d": [1]}
    assert spec.merge(base, {"a": {"b": 5}}) == {"a": {"b": 5, "c": 2},
                                                 "d": [1]}
    assert base["a"]["b"] == 1
