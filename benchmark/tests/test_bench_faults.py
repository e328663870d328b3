"""The comparison that decides `correct`, against its control and against
faults planted in the program.

The control (`benchmark/control.py`: the reference in the program's
place, computed in bfloat16, one step below the configuration's float32)
must read above the configuration's limit, as a run reads it: the worst
sampled answer. Each fault
drives the rest of a run (the harness's look for a card skipped, the
server on the CPU, where the port runs its kernels' plain versions) with
the timed path broken underneath, and `correct` must come out false:

- `unchanged`: the resample hands its input on unchanged (cut to the
  output's bucket), a step that returns its state;
- `half_batch`: the chain's last stage computes the first half of each
  batch and hands the first image's answer to the rest;
- `corrupt`: the program's own `device.corrupt` failpoint flips the high
  bit of a quarter of each answer's bytes where the chain drains them.

A cell on one card has no exchange between cards to leave out.
"""

import os

import pytest

from benchmark import control, run, spec

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]

SITECUSTOMIZE = '''
import os
import sys

import torch

sys.path.insert(0, os.environ["BENCH_TEST_ROOT"])

_fault = os.environ.get("BENCH_TEST_FAULT", "")
if _fault in ("unchanged", "half_batch"):
    from imaginary_tpu_torch.kernels import reference as _ref

if _fault == "unchanged":
    def _resample(x, h, w, dst_h, dst_w, out_hb, out_wb, kind, out_u8=False, cols=None,
                  in_col0=0, in_wb=None):
        xf = x.float()
        out = torch.zeros(xf.shape[0], out_hb, out_wb, xf.shape[3])
        hh, ww = min(out_hb, xf.shape[1]), min(out_wb, xf.shape[2])
        out[:, :hh, :ww] = xf[:, :hh, :ww]
        out = _ref.epilogue_u8(out) if out_u8 else out
        return out, dst_h.to(torch.int32), dst_w.to(torch.int32)
    _ref.resample = _resample

if _fault == "half_batch":
    def _halve(fn):
        def wrapped(x, *args, **kwargs):
            out = fn(x, *args, **kwargs)
            b = out.shape[0]
            if b > 1:
                out[b - b // 2:] = out[0]
            return out
        return wrapped
    _ref.rgb_to_yuv420 = _halve(_ref.rgb_to_yuv420)
'''

CPU_MIX = {  # loads this host's CPU serves: the same routes and pools
    "upstream-trio.c32": {"warmup_s": 2.0},
}


def test_control_fails_the_limit():
    cell = "jpeg1080.upstream.c32"
    cfg = spec.config(BENCH, spec.cell(BENCH, cell)["config"])
    gaps = control.readings(cell, 2**31 + 17, per_route=2)
    assert len(gaps) == 6 and max(gaps) > cfg["limits"][cfg["judge"]["gap"]]


@pytest.fixture
def cpu_mix(monkeypatch):
    load = spec.traffic

    def smaller(name, here=spec.HERE):
        return dict(load(name, here), **CPU_MIX[name])

    monkeypatch.setattr(spec, "traffic", smaller)


def _run(cell, out_root, seconds=4.0):
    return run.run_cell(cell, 2**31 + 99, seconds, False, device="cpu", out_root=str(out_root))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "corrupt"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(cell, fault, cpu_mix, tmp_path, monkeypatch):
    (tmp_path / "sitecustomize.py").write_text(SITECUSTOMIZE)
    monkeypatch.setenv("BENCH_TEST_ROOT", spec.ROOT)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    if fault == "corrupt":
        monkeypatch.setenv("IMAGINARY_TPU_FAILPOINTS", "device.corrupt=error")
    else:
        monkeypatch.setenv("BENCH_TEST_FAULT", fault)
    result = _run(cell, tmp_path / "out")
    assert result["correct"] is False, result["checks"]


def test_a_sound_run_is_correct(cpu_mix, tmp_path):
    result = _run("jpeg1080.upstream.c32", tmp_path, seconds=3.0)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
