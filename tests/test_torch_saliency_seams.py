"""K9 (saliency + integral image) and K10 (window argmax) at the seams of
their designs, held against the JAX package on the CPU.

The cases are `chip_smoke.SAL_SEAM_CASES`, the ones the card holds the
CUDA kernels to, but for the 8192-wide bucket and the 2160x3840 frame:
buckets narrower than 256 columns and 257 wide (a row scan of 256
segments leaves some empty or short), heights of 8, 15 and 17 (a column
scan of 16 row chunks leaves some empty, or past the bucket), config 4's
320x640 bucket, valid dims short of the bucket, one valid row, one valid
column, a B=3 batch of mixed dims, windows equal to the valid dims (one
candidate), larger than them (every candidate masked) and 1x1, uint8 and
f32 at C = 3 and 4, and a flat red image whose windows all tie. The same
seeded numpy inputs go through `imaginary_tpu.ops.saliency` (the map, its
cumsums as `test_torch_saliency._jax_ii` takes them, and
`smart_offsets`) and through the port's wrappers on CPU tensors.

Tolerances, as in `test_torch_saliency.py`: the saliency map 1e-5
absolute; the integral image 1e-5 relative per entry (non-negative terms
summed in another order); the window equal, or its saliency (f64, on the
JAX map) within 1e-5 relative of the JAX window's. On the flat image
every window scores exactly its area, so both packages answer (0, 0).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imaginary_tpu.ops import saliency as jsal
from imaginary_tpu_torch import kernels
from imaginary_tpu_torch.ops import saliency as psal
from tests.test_torch_saliency import II_RTOL, SAL_ATOL, WINDOW_RTOL, _jax_ii

# all but the 8192-wide bucket and the 2160x3840 frame
CASES = [(i, *c) for i, c in enumerate(chip_smoke.SAL_SEAM_CASES)
         if c[1][0] * c[1][1] <= 320 * 640]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(i, bucket, dims, wins, c, u8, flat):
    rng = np.random.default_rng(2000 + i)
    x = chip_smoke.sal_seam_inputs(bucket, len(dims), c, u8, flat, rng)
    h = np.array([a for a, _ in dims], np.int32)
    w = np.array([b for _, b in dims], np.int32)
    wh = np.array([a for a, _ in wins], np.int32)
    ww = np.array([b for _, b in wins], np.int32)
    return x, h, w, wh, ww


def _t(a):
    return torch.from_numpy(np.array(a))


PARAMS = "i,case,bucket,dims,wins,c,u8,flat"


@pytest.mark.parametrize(PARAMS, CASES, ids=lambda v: str(v))
def test_saliency_map_seam_matches_reference(i, case, bucket, dims, wins, c, u8, flat):
    x, h, w, _, _ = _inputs(i, bucket, dims, wins, c, u8, flat)
    want = np.asarray(jsal._saliency_map(jnp.asarray(x, jnp.float32), h, w))
    got = psal.saliency_map(_t(x), _t(h), _t(w)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=SAL_ATOL)


@pytest.mark.parametrize(PARAMS, CASES, ids=lambda v: str(v))
def test_integral_image_seam_matches_reference(i, case, bucket, dims, wins, c, u8, flat):
    x, h, w, _, _ = _inputs(i, bucket, dims, wins, c, u8, flat)
    want = _jax_ii(x, h, w)
    got = kernels.saliency_ii(_t(x), _t(h), _t(w)).numpy()
    assert got.shape == (len(dims), bucket[0] + 1, bucket[1] + 1)
    assert not got[:, 0].any() and not got[:, :, 0].any()
    assert np.all(np.abs(got - want) <= II_RTOL * np.abs(want))


@pytest.mark.parametrize(PARAMS, CASES, ids=lambda v: str(v))
def test_window_seam_matches_reference(i, case, bucket, dims, wins, c, u8, flat):
    x, h, w, wh, ww = _inputs(i, bucket, dims, wins, c, u8, flat)
    xf = jnp.asarray(x, jnp.float32)
    jt, jl = (np.asarray(a) for a in jsal.smart_offsets(xf, h, w, wh, ww))
    ii = kernels.saliency_ii(_t(x), _t(h), _t(w))
    pt, pl = (a.numpy() for a in kernels.window_argmax(ii, _t(h), _t(w), _t(wh), _t(ww)))
    if flat:
        assert not (jt.any() or jl.any() or pt.any() or pl.any())
    sal = np.asarray(jsal._saliency_map(xf, h, w)).astype(np.float64)
    for k in range(len(dims)):
        if (pt[k], pl[k]) == (jt[k], jl[k]):
            continue
        # a tie within rounding: the port's window holds as much saliency
        assert 0 <= pt[k] <= h[k] - wh[k] and 0 <= pl[k] <= w[k] - ww[k]
        want = sal[k, jt[k]:jt[k] + wh[k], jl[k]:jl[k] + ww[k]].sum()
        got = sal[k, pt[k]:pt[k] + wh[k], pl[k]:pl[k] + ww[k]].sum()
        assert abs(got - want) <= WINDOW_RTOL * want
