"""What the harness promises around its result: no JAX anywhere it runs,
the yardstick frozen, the last line's keys, and no result without a card
or without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run, spec, yardstick

FORBIDDEN = {"jax", "jaxlib", "flax", "imaginary_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("package", ["benchmark", "imaginary_tpu_torch"])
def test_no_module_imports_jax_or_the_jax_package(package):
    """Each imported module's top-level name is compared whole, so the
    port's `imaginary_tpu_torch` is not the JAX package's `imaginary_tpu`."""
    found = []
    for dirpath, _, files in os.walk(os.path.join(spec.ROOT, package)):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                found += [(path, m) for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not found


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "imaginary_tpu_torch_like", object())
    assert "imaginary_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in run.forbidden_modules()


def test_yardstick_reproduces_the_kernel_table():
    """Three bound entries of PERF.md's kernel table, from chip_smoke.py's
    shapes: K1 on config 3's 4K uint8 bucket, K6 at config 3 B=1, K3 at
    config 1's bucket."""
    k1 = yardstick.bound_ms(2560 * 4096 * 3 + 736 * 1280 * 3 * 4, 0.0)
    assert round(k1[0], 4) == 0.0128 and k1[1] == "bytes"
    k6 = yardstick.bound_ms(736 * 1280 * 3 * 4 * 2, yardstick.blur_flops(720, 1280, 4, 3))
    assert round(k6[0], 4) == 0.0067 and k6[1] == "bytes"
    k3 = yardstick.bound_ms(208 * 304 * 3 * 4 + 312 * 304, 20.0 * 208 * 304)
    assert round(k3[0], 5) == 0.00025 and k3[1] == "bytes"
    assert yardstick.k10_work(8, 8, 9, 9, 8, 8) == (8, 0.0)


def test_result_line_keys(monkeypatch, capsys):
    canned = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
              "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                         "memory_peak_bytes": 1},
              "checks": {"unanswered": {"value": 0, "limit": 0}}}
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: canned)
    assert run.main(["--workload", "x", "--seed", str(2**31 + 3), "--seconds", "1"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1] == "check unanswered: 0 (limit 0)"


def _run_cli(cwd, extra_env=None):
    env = dict(os.environ, **(extra_env or {}))
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "jpeg1080.upstream.c32", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_no_result_without_a_card():
    """This host's torch sees no card (CUDA_VISIBLE_DEVICES hides any)."""
    p = _run_cli(spec.ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""
    assert "no result" in p.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    """A directory with only BENCHMARK.json and benchmark/ has no program."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_out", "__pycache__"))
    p = _run_cli(str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""
