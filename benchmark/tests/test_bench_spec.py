"""BENCHMARK.json and the files it names: found by name, within the
contract's limits, and extensible by new files alone."""

import json
import os
import re
import shutil

import pytest

from benchmark import run, spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    mix = spec.traffic(w["traffic"])
    assert {"flags", "inputs", "judge", "limits"} <= set(cfg)
    assert mix["loop"] in ("closed", "open") and mix["routes"]
    routes = run.route_table(mix, (cfg["inputs"]["height"], cfg["inputs"]["width"]))
    assert all(g["out"][0] > 0 and g["out"][1] > 0 for _, _, g, _ in routes)
    for traced in (False, True):
        for m in spec.metrics_for(BENCH, cell, traced):
            assert callable(spec.metric_reader(m["name"]))


def test_names_units_and_moves():
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[g]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        mine = {m["name"] for m in spec.metrics_for(BENCH, w["name"], False)}
        assert "setup_s" in mine and len(mine) >= 2
        layer = spec.metrics_for(BENCH, w["name"], True)
        assert layer and all(m["moves"] in mine for m in layer)


def test_a_new_metric_is_new_files_only(tmp_path):
    """A metric added as a reader file and a BENCHMARK.json entry is read
    without any existing file changing."""
    here = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("_out", "__pycache__"))
    (here / "metrics" / "dummy.twice_setup_s.py").write_text(
        "def read(w):\n    return 2 * w.setup_s\n")
    bench = json.loads(json.dumps(BENCH))
    cell = bench["workloads"][0]["name"]
    bench["per_layer"].append({"name": "dummy.twice_setup_s", "unit": "s", "better": "lower",
                               "source": "host_clock", "layer": "load generator",
                               "moves": "setup_s", "workloads": [cell]})
    assert "dummy.twice_setup_s" in [m["name"] for m in spec.metrics_for(bench, cell, True)]
    reader = spec.metric_reader("dummy.twice_setup_s", here=str(here))

    class W:
        setup_s = 1.5

    assert reader(W()) == 3.0
    for name in os.listdir(os.path.join(spec.HERE, "metrics")):
        if name.endswith(".py"):
            assert (here / "metrics" / name).read_bytes() == \
                open(os.path.join(spec.HERE, "metrics", name), "rb").read()


def test_a_name_with_a_slash_is_refused():
    with pytest.raises(ValueError):
        spec.traffic("../BENCHMARK")
