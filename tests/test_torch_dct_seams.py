"""K11 (FromDctSpec) and K12 (ToDctSpec) at the seams of their tiles,
held against the JAX package on the CPU.

The cases are `chip_smoke.DCT_SEAM_CASES`, the ones the card holds the
CUDA kernels to: odd valid dims inside a larger bucket (4:2:0's and
4:2:2's chroma columns then clamp inside the bucket, not at its edge), B=3
batches whose images have different valid dims, buckets 8 rows short of a
16-row tile and only one 128-column tile wide, a valid width ending
inside a later tile, every layout at k = 8, the three-plane layouts at
k = 1, 2 and 4, and K12 at the /resize?width=1600 output bucket. The same
seeded numpy inputs go through the reference's stage (jitted, as
`test_torch_dct.py` runs it) and through the port's plain version
(`kernels/reference.py`), which the wrappers run on CPU tensors.

Tolerances: K11 1e-3 absolute on the 0-255 scale (f32; the IDCT's
products are summed in another order); K12 int16 coefficients within 1,
at most 0.1 % of them differing (a coefficient within rounding of a .5
tie can round the other way).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from imaginary_tpu.ops import stages as jst
from imaginary_tpu_torch import kernels
from imaginary_tpu_torch.codecs import jpeg_dct as pdct
from imaginary_tpu_torch.kernels import reference

F32_TOL = 1e-3
COEF_TOL = 1
COEF_SHARE = 1e-3

CASES = [(i, *c) for i, c in enumerate(chip_smoke.DCT_SEAM_CASES)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(i, kernel, layout, k, bucket, hw):
    rng = np.random.default_rng(1000 + i)
    x = chip_smoke.dct_seam_inputs(kernel, layout, k, bucket, len(hw), rng)
    h = np.array([a for a, _ in hw], np.int32)
    w = np.array([b for _, b in hw], np.int32)
    return x, h, w


@pytest.mark.parametrize("i,kernel,case,layout,k,bucket,hw",
                         [c for c in CASES if c[1] == "from_dct"], ids=lambda v: str(v))
def test_from_dct_seam_matches_reference(i, kernel, case, layout, k, bucket, hw):
    x, h, w = _inputs(i, kernel, layout, k, bucket, hw)
    hb, wb = bucket
    assert x.shape == (len(hw), *kernels.dct_in_shape(layout, k, hb, wb))
    spec = jst.FromDctSpec(hb, wb, k, layout)
    want = np.asarray(jax.jit(lambda x, h, w: spec.apply(x.astype(jnp.float32), h, w, {})[0])(
        x, h, w))
    got = reference.from_dct(torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(w),
                             hb, wb, k, layout)
    assert got.dtype == torch.float32 and got.shape == want.shape == (len(hw), hb, wb, 3)
    assert np.abs(got.numpy() - want).max() <= F32_TOL, case


@pytest.mark.parametrize("i,kernel,case,layout,k,bucket,hw",
                         [c for c in CASES if c[1] == "to_dct"], ids=lambda v: str(v))
def test_to_dct_seam_matches_reference(i, kernel, case, layout, k, bucket, hw):
    x, h, w = _inputs(i, kernel, layout, k, bucket, hw)
    hb, wb = bucket
    bsz = len(hw)
    qy, qc = pdct.quality_tables(80)
    dyn = {"qy": np.stack([qy] * bsz).astype(np.float32),
           "qc": np.stack([qc] * bsz).astype(np.float32)}
    spec = jst.ToDctSpec(hb, wb)
    want = jax.jit(lambda x, h, w, dyn: spec.apply(x, h, w, dyn)[0])(x, h, w, dyn)
    want = np.asarray(jnp.clip(jnp.round(want), -32768.0, 32767.0).astype(jnp.int16))
    got = reference.to_dct(*(torch.from_numpy(a) for a in (x, h, w, dyn["qy"], dyn["qc"])),
                           hb, wb)
    assert got.dtype == torch.int16 and tuple(got.shape) == want.shape
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert int(d.max()) <= COEF_TOL, case
    assert float((d > 0).mean()) <= COEF_SHARE, case
