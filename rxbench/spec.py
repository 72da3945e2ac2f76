"""Finds a cell's files by the names in ``BENCHMARK.json``.

- the configuration: the ``file`` of its ``configs`` entry (a JSON object:
  the ``driver`` of the receiver surface the window drives, its
  ``RxConfig``, the transmitter's MODCODs and schedule, the control);
- the driver: ``rxbench/drivers/<driver>.py`` (its ``Driver`` class, and
  ``LIMITS``, the numbers it compares and their limits);
- the traffic mix: ``rxbench/traffic/<traffic>.json``;
- an end-to-end metric: ``rxbench/end_to_end/<name>.py``;
- a per-layer metric: ``rxbench/metrics/<name>.py``.

A metric applies to a cell when its ``workloads`` list names the cell, or
when it has no such list. A later cell, configuration, traffic mix,
receiver surface or metric is new files and new entries, never an edit
of a file here.
"""

import copy
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_bench(root):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _module(folder, name):
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"rxbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name):
    """The per-layer metric file ``rxbench/metrics/<name>.py``."""
    return _module("metrics", name)


def end_to_end(name):
    """The end-to-end metric file ``rxbench/end_to_end/<name>.py``."""
    return _module("end_to_end", name)


def driver(name):
    """The receiver surface's file ``rxbench/drivers/<name>.py``."""
    return _module("drivers", name)


def _applies(entry, cell):
    return cell in entry.get("workloads", [cell])


def merge(base, over):
    """``base`` with the nested dict ``over`` laid over it (a copy)."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list        # BENCHMARK.json entries that apply
    per_layer: list
    patterns: tuple         # every per-layer metric's kernel patterns


def cell(bench, workload, root, config_over=None, traffic_over=None):
    """The cell ``workload`` of ``bench``, with optional overrides laid
    over its configuration and traffic (the CPU rehearsals')."""
    w = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(Path(root) / c["file"]) as f:
        config = merge(json.load(f), config_over)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = merge(json.load(f), traffic_over)
    patterns = tuple(p for m in bench["per_layer"]
                     for p in metric(m["name"]).__dict__.get("PATTERNS", ()))
    return Cell(w["name"], w["chips"], config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, w["name"])],
                [m for m in bench["per_layer"] if _applies(m, w["name"])],
                patterns)
