"""The golden suite of `tests/test_golden.py` held against the port, on
the CPU.

1. The reference's fit-dimension table (image_test.go:146-180) against
   the port's `_fit_dims`, value for value.
2. Every MATRIX, PIPELINES and SMARTCROP case of `tests/gen_goldens.py`
   through the port's `process_operation` / `process_pipeline` on
   `device="cpu"` (the plain versions of the kernels): exact dims, the
   pipelines' SampleSpec counts, pixels at the same 45 dB floor against
   the committed goldens, and the smartcrop window K10 chose equal to
   `tests/goldens/smartcrop_window.json`. The runners are
   `chip_smoke.py`'s phase 13(c) ones, which run the same cases on the
   card.
"""

from __future__ import annotations

import json
import os

import pytest

import chip_smoke
from tests.conftest import fixture_bytes
from tests.gen_goldens import GOLDEN_DIR, MATRIX, PIPELINES, SMARTCROP


@pytest.fixture(scope="module", autouse=True)
def _fixtures(testdata):
    return testdata


# image_test.go:146-180, both rounding directions
FIT_CASES = [
    (1280, 1000, 710, 9999, 710, 555),
    (1279, 1000, 710, 9999, 710, 555),
    (900, 500, 312, 312, 312, 173),  # rounding down
    (900, 500, 313, 313, 313, 174),  # rounding up
    (1299, 2000, 710, 999, 649, 999),
    (1500, 2000, 710, 999, 710, 947),
]


@pytest.mark.parametrize("iw,ih,ow,oh,fw,fh", FIT_CASES)
def test_fit_dimension_table(iw, ih, ow, oh, fw, fh):
    from imaginary_tpu.ops.plan import _fit_dims as ref_fit_dims
    from imaginary_tpu_torch.ops.plan import _fit_dims

    assert _fit_dims(iw, ih, ow, oh) == (fw, fh) == ref_fit_dims(iw, ih, ow, oh)


@pytest.mark.parametrize("name,op,kw,expect_wh", MATRIX, ids=[m[0] for m in MATRIX])
def test_matrix_dims_and_pixels(name, op, kw, expect_wh):
    arr = chip_smoke.golden_case(fixture_bytes("imaginary.jpg"), op, kw, "cpu")
    assert chip_smoke.golden_grade(name, arr, expect_wh) >= chip_smoke.GOLDEN_PSNR_DB


@pytest.mark.parametrize("name,ops,expect_wh,n_samples", PIPELINES,
                         ids=[p[0] for p in PIPELINES])
def test_pipeline_dims_and_pixels(name, ops, expect_wh, n_samples):
    """The combined plan keeps the reference's resample topology (fused,
    extract-blocked, single-sample), and its pixels the goldens'."""
    from tests.gen_goldens import _pipeline_sample_count

    arr, samples = chip_smoke.golden_pipeline(fixture_bytes("imaginary.jpg"), ops, "cpu")
    assert samples == n_samples == _pipeline_sample_count(ops)
    assert chip_smoke.golden_grade(name, arr, expect_wh) >= chip_smoke.GOLDEN_PSNR_DB


def test_smartcrop_pixels_and_window():
    name, _op, kw, expect_wh = SMARTCROP
    arr, window = chip_smoke.golden_window(fixture_bytes("smart-crop.jpg"), kw, "cpu")
    assert chip_smoke.golden_grade(name, arr, expect_wh) >= chip_smoke.GOLDEN_PSNR_DB
    with open(os.path.join(GOLDEN_DIR, "smartcrop_window.json")) as f:
        assert window == json.load(f)


def test_grade_refuses_drift_and_wrong_dims():
    """The grader itself: a golden against itself passes, one off by a
    few LSB everywhere falls under the floor, a transposed one fails on
    dims."""
    import numpy as np

    name, _op, _kw, expect_wh = MATRIX[0]
    gold = chip_smoke.golden_pixels(
        open(os.path.join(GOLDEN_DIR, f"{name}.png"), "rb").read())
    assert chip_smoke.golden_grade(name, gold, expect_wh) == float("inf")
    noisy = np.clip(gold.astype(np.int16) + 2 * np.where(
        np.arange(gold.size).reshape(gold.shape) % 2, 1, -1), 0, 255).astype(np.uint8)
    with pytest.raises(AssertionError, match="PSNR"):
        chip_smoke.golden_grade(name, noisy, expect_wh)
    with pytest.raises(AssertionError, match="want"):
        chip_smoke.golden_grade(name, gold.transpose(1, 0, 2), expect_wh)
