"""Everything the harness runs is found by name from BENCHMARK.json.

- a cell (`workloads[]`) names its configuration and its traffic mix;
- a configuration's file (`configs[].file`) holds the server's flags and
  the inputs' recipe;
- a traffic mix is `benchmark/traffic/<traffic>.json`;
- a metric, end-to-end or per layer, is read by
  `benchmark/metrics/<name>.py`, whose `read(window)` returns a number or
  None when the window holds nothing it reads;
- a route's reference is `benchmark/ops/<operation>.py`;
- a configuration's answers are judged by `benchmark/judges/<gap>.py`,
  named by its `judge.gap`: `read(answer)`, `encode(frame, judge)` (the
  control's answer) and `gap(read answer, frame, judge)`.

A later cell, mix, metric or route is new files and new entries, never an
edit of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, here: str = HERE) -> dict:
    with open(os.path.join(here, "traffic", _checked(name) + ".json")) as f:
        return json.load(f)


def metrics_for(bench: dict, cell_name: str, traced: bool) -> list:
    """The metric entries a cell reports: its end-to-end ones untraced, its
    per-layer ones traced; an entry without `workloads` is every cell's."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def _module_from(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, here: str = HERE):
    """`read(window)` of benchmark/metrics/<name>.py (the file name keeps
    the metric's dots)."""
    path = os.path.join(here, "metrics", _checked(name) + ".py")
    return _module_from(path, "benchmark_metric_" + name.replace(".", "_").replace("-", "_")).read


def route_reference(operation: str):
    """The module of benchmark/ops/<operation>.py: `geometry(query, h, w)`
    and `reference(query, body, dtype)`."""
    if not re.match(r"^[a-z]+$", operation):
        raise ValueError(f"not an operation: {operation!r}")
    return importlib.import_module(f"benchmark.ops.{operation}")


def judge(gap: str):
    """The module of benchmark/judges/<gap>.py."""
    return importlib.import_module(f"benchmark.judges.{_checked(gap)}")
