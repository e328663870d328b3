"""The port's smartcrop (saliency K9, window argmax K10, SmartExtractSpec and
/smartcrop) held against the JAX package on the CPU.

The same seeded numpy inputs go through `imaginary_tpu.ops.saliency` and
the port's plain versions (`imaginary_tpu_torch.ops.saliency`, and the
kernel wrappers on CPU tensors). Tolerances:

- saliency map: 1e-5 absolute (values are at most ~10.5; the two
  packages round the same f32 expression in another order);
- integral image: 1e-5 relative per entry (every term is non-negative,
  so the error of a prefix sum is relative to its value; the sums run in
  another order);
- window choice: on smart-crop.jpg as the pipeline decodes it (JPEG
  noise makes its best window unique) the offsets are equal; on the raw
  disc fixture (a flat background, so windows that differ only in how
  much background they hold tie to within rounding) and on noise, the
  port's window sum (recomputed in f64) is within 1e-5 relative of the
  JAX window's;
- pixels: the route's output at most 1 LSB from the JAX package's, and
  the golden window of `tests/goldens/smartcrop_window.json` exactly.
"""

from __future__ import annotations

import io
import json
import os
import urllib.parse

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imaginary_tpu import pipeline as jpipeline
from imaginary_tpu.ops import chain as jchain
from imaginary_tpu.ops import saliency as jsal
from imaginary_tpu.ops.plan import plan_operation as jplan_operation
from imaginary_tpu.params import build_params_from_query as jquery
from imaginary_tpu_torch import kernels
from imaginary_tpu_torch import pipeline as ppipeline
from imaginary_tpu_torch.ops import chain as pchain
from imaginary_tpu_torch.ops import saliency as psal
from imaginary_tpu_torch.ops.plan import plan_operation as pplan_operation
from imaginary_tpu_torch.params import build_params_from_query as pquery
from tests.conftest import fixture_bytes
from tests.gen_fixtures import _smart_crop_array
from tests.test_torch_plan import assert_same_plan
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

SAL_ATOL = 1e-5
II_RTOL = 1e-5
WINDOW_RTOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "smartcrop_window.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _i32(*v):
    return np.array(v, dtype=np.int32)


# (bucket, valid (h, w) per image): one valid row, one valid column, the
# whole bucket, and dims short of it, mixed in one batch
SAL_CASES = [
    ((24, 40), ((1, 40), (24, 1), (24, 40), (17, 29))),
    ((48, 64), ((45, 61), (48, 64))),
    ((8, 8), ((3, 5),)),
]


def _noise(rng, bsz, hb, wb, c, dtype):
    x = rng.uniform(0.0, 255.0, size=(bsz, hb, wb, c))
    return x.astype(np.uint8) if dtype == "u8" else x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "u8"])
@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("bucket,dims", SAL_CASES, ids=lambda v: str(v))
def test_saliency_map_matches_reference(bucket, dims, c, dtype):
    rng = np.random.default_rng(11)
    x = _noise(rng, len(dims), *bucket, c, dtype)
    h = _i32(*(d[0] for d in dims))
    w = _i32(*(d[1] for d in dims))
    want = np.asarray(jsal._saliency_map(jnp.asarray(x, jnp.float32), h, w))
    got = psal.saliency_map(_t(x), _t(h), _t(w)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=SAL_ATOL)
    outside = np.ones_like(want, dtype=bool)
    for i, (vh, vw) in enumerate(dims):
        outside[i, :vh, :vw] = False
    assert not got[outside].any()


def _jax_ii(x, h, w):
    sal = jsal._saliency_map(jnp.asarray(x, jnp.float32), h, w)
    return np.asarray(jnp.pad(jnp.cumsum(jnp.cumsum(sal, axis=1), axis=2),
                              ((0, 0), (1, 0), (1, 0))))


@pytest.mark.parametrize("bucket,dims", SAL_CASES, ids=lambda v: str(v))
def test_integral_image_matches_reference(bucket, dims):
    rng = np.random.default_rng(12)
    x = _noise(rng, len(dims), *bucket, 3, "f32")
    h = _i32(*(d[0] for d in dims))
    w = _i32(*(d[1] for d in dims))
    want = _jax_ii(x, h, w)
    got = kernels.saliency_ii(_t(x), _t(h), _t(w)).numpy()
    assert got.shape == (len(dims), bucket[0] + 1, bucket[1] + 1)
    assert not got[:, 0].any() and not got[:, :, 0].any()
    assert np.all(np.abs(got - want) <= II_RTOL * np.abs(want))


def _offsets_both(x, h, w, wh, ww):
    jt, jl = jsal.smart_offsets(jnp.asarray(x, jnp.float32), h, w, wh, ww)
    ii = kernels.saliency_ii(_t(x), _t(h), _t(w))
    pt, pl = kernels.window_argmax(ii, _t(h), _t(w), _t(wh), _t(ww))
    return (np.asarray(jt), np.asarray(jl)), (pt.numpy(), pl.numpy())


def _window_sum64(sal, t, l, wh, ww) -> float:
    return float(sal[t:t + wh, l:l + ww].astype(np.float64).sum())


# windows on the 800x600 disc fixture (disc of radius 75 and its ring of
# radius 81 at (600, 180)): larger than the ring, and smaller
DISC_WINDOWS = [(260, 300), (200, 200), (100, 120), (600, 300), (150, 800)]


@pytest.mark.parametrize("wh,ww", DISC_WINDOWS, ids=lambda v: str(v))
def test_window_choice_on_the_disc_fixture_has_the_reference_window_sum(wh, ww):
    """The fixture's background is flat, so windows that hold the whole
    ring and differ only in how much background they take score within
    rounding of each other: the two packages, summing in another order,
    may pick different ones of them. The port's window holds as much
    saliency as the reference's (f64 sums, 1e-5 relative) and covers the
    disc's centre or, when smaller than the ring, lies on the ring."""
    im = _smart_crop_array(800, 600).astype(np.float32)
    x = np.zeros((1, 640, 896, 3), np.float32)
    x[0, :600, :800] = im
    h, w = _i32(600), _i32(800)
    (jt, jl), (pt, pl) = _offsets_both(x, h, w, _i32(wh), _i32(ww))
    sal = np.asarray(jsal._saliency_map(jnp.asarray(x), h, w))[0]
    want = _window_sum64(sal, int(jt[0]), int(jl[0]), wh, ww)
    got = _window_sum64(sal, int(pt[0]), int(pl[0]), wh, ww)
    assert abs(got - want) <= WINDOW_RTOL * want
    cy, cx, ring = 180, 600, 81
    t, l = int(pt[0]), int(pl[0])
    assert t - ring <= cy < t + wh + ring and l - ring <= cx < l + ww + ring


def _smartcrop_input(buf: bytes, kw: dict):
    """The image SmartExtractSpec sees in /smartcrop on buf, as the JAX
    package's process_operation decodes and plans it (the rgb decode at
    its shrink-on-load, then the stages before SmartExtractSpec)."""
    from imaginary_tpu import codecs as jcodecs
    from imaginary_tpu.options import ImageOptions

    o = ImageOptions(**kw)
    for k in kw:
        o.mark_defined(k)
    d = jcodecs.decode(buf, jpipeline._pick_shrink("smartcrop", buf, o))
    plan = jplan_operation("smartcrop", o, *d.array.shape[:2], d.orientation,
                           d.array.shape[2])
    dyns = jchain._stack_dyns([plan])
    x = jnp.asarray(jchain.pad_to_bucket(d.array)[None]).astype(jnp.float32)
    h = jnp.array([d.array.shape[0]], jnp.int32)
    w = jnp.array([d.array.shape[1]], jnp.int32)
    for st, dyn in zip(plan.stages, dyns):
        if type(st.spec).__name__ == "SmartExtractSpec":
            return np.asarray(x), np.asarray(h), np.asarray(w), dyn
        x, h, w = st.spec.apply(x, h, w, dyn)
    raise AssertionError("no SmartExtractSpec in the smartcrop plan")


@pytest.mark.parametrize("kw", [{"width": 300, "height": 260}, {"width": 120, "height": 200},
                                {"width": 500, "height": 100}], ids=str)
def test_window_choice_on_smart_crop_jpg_equals_reference(kw):
    x, h, w, dyn = _smartcrop_input(fixture_bytes("smart-crop.jpg"), kw)
    (jt, jl), (pt, pl) = _offsets_both(x, h, w, dyn["new_h"], dyn["new_w"])
    assert (int(pt[0]), int(pl[0])) == (int(jt[0]), int(jl[0]))
    st, sl = psal.smart_offsets(*(_t(a) for a in (x, h, w, dyn["new_h"], dyn["new_w"])))
    assert (int(st[0]), int(sl[0])) == (int(pt[0]), int(pl[0]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_window_choice_on_noise_has_the_reference_window_sum(seed):
    rng = np.random.default_rng(100 + seed)
    hb, wb = 64, 96
    h = _i32(64, 57, 33)
    w = _i32(96, 71, 90)
    x = _noise(rng, 3, hb, wb, 3, "f32")
    wh = _i32(20, 57, 10)
    ww = _i32(30, 12, 90)
    (jt, jl), (pt, pl) = _offsets_both(x, h, w, wh, ww)
    sal = np.asarray(jsal._saliency_map(jnp.asarray(x), h, w))
    for i in range(3):
        assert 0 <= pt[i] <= h[i] - wh[i] and 0 <= pl[i] <= w[i] - ww[i]
        want = _window_sum64(sal[i], int(jt[i]), int(jl[i]), wh[i], ww[i])
        got = _window_sum64(sal[i], int(pt[i]), int(pl[i]), wh[i], ww[i])
        assert abs(got - want) <= WINDOW_RTOL * want


def test_window_argmax_ties_and_masks_follow_jnp_argmax():
    """A constant integral image makes every allowed window tie: the first
    in row-major order wins. A window larger than the image masks every
    candidate: (0, 0), as jnp.argmax over a constant -1 gives."""
    ii = np.zeros((2, 17, 25), np.float32)
    h, w = _i32(16, 10), _i32(24, 5)
    wh, ww = _i32(4, 11), _i32(6, 3)
    pt, pl = kernels.window_argmax(_t(ii), _t(h), _t(w), _t(wh), _t(ww))
    assert pt.tolist() == [0, 0] and pl.tolist() == [0, 0]
    # a single hot pixel: the first window that covers it
    sal = np.zeros((1, 16, 24), np.float32)
    sal[0, 9, 13] = 1.0
    ii1 = psal.integral_image(_t(sal))
    pt, pl = kernels.window_argmax(ii1, _t(_i32(16)), _t(_i32(24)), _t(_i32(4)), _t(_i32(6)))
    assert (int(pt[0]), int(pl[0])) == (6, 8)


def _pixels(body: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB")).astype(np.int32)


def _psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def test_smartcrop_route_reproduces_the_golden_window(monkeypatch):
    with open(GOLDEN) as f:
        golden = json.load(f)
    seen = []
    real = kernels.window_argmax

    def spy(ii, h, w, win_h, win_w):
        top, left = real(ii, h, w, win_h, win_w)
        seen.append((int(top[0]), int(left[0]), int(win_h[0]), int(win_w[0])))
        return top, left

    monkeypatch.setattr(kernels, "window_argmax", spy)
    buf = fixture_bytes("smart-crop.jpg")
    q = {"width": "300", "height": "260"}
    got = ppipeline.process_operation("smartcrop", buf, pquery(q), device="cpu")
    assert seen == [(golden["top"], golden["left"], golden["new_h"], golden["new_w"])]
    assert got.mime == "image/jpeg" and (got.width, got.height) == (300, 260)
    want = jpipeline.process_operation("smartcrop", buf, jquery(q))
    assert _psnr(_pixels(got.body), _pixels(want.body)) >= 45.0


@pytest.mark.parametrize("fixture,query", [
    ("smart-crop.jpg", {"width": "300", "height": "300"}),
    ("large.jpg", {"width": "300", "height": "300"}),
    ("test.png", {"width": "200", "height": "120"}),
    ("test.webp", {"width": "90", "height": "300"}),
], ids=lambda v: v if isinstance(v, str) else "x".join(v.values()))
def test_smartcrop_plan_and_chain_match_reference(fixture, query):
    """The port's planner emits the JAX package's smartcrop plan, and its
    chain output on the decoded source is within 1 LSB of the JAX chain's
    (the rgb transport: the window is chosen on the chain's own pixels)."""
    from imaginary_tpu import codecs as jcodecs

    buf = fixture_bytes(fixture)
    d = jcodecs.decode(buf)
    jp = jplan_operation("smartcrop", jquery(query), *d.array.shape[:2], d.orientation,
                         d.array.shape[2])
    pp = pplan_operation("smartcrop", pquery(query), *d.array.shape[:2], d.orientation,
                         d.array.shape[2])
    assert_same_plan(jp, pp)
    want = jchain.run_single(d.array, jp)
    got = pchain.run_single(d.array, pp, device="cpu")
    assert got.shape == want.shape
    assert int(np.abs(got.astype(np.int32) - want.astype(np.int32)).max()) <= 1


def test_smartcrop_run_batch_matches_run_single():
    """Three images of one bucket in one batch: each keeps its own window."""
    buf = fixture_bytes("smart-crop.jpg")
    from imaginary_tpu_torch import codecs as pcodecs

    base = pcodecs.decode(buf).array
    arrs = [base, base[:, ::-1].copy(), base[::-1].copy()]
    plan = pplan_operation("smartcrop", pquery({"width": "200", "height": "200"}),
                           *base.shape[:2], 0, 3)
    batch = pchain.run_batch(arrs, [plan] * 3, device="cpu")
    for a, got in zip(arrs, batch):
        assert np.array_equal(got, pchain.run_single(a, plan, device="cpu"))
    assert not np.array_equal(batch[0], batch[1])


@pytest.fixture()
def service():
    from imaginary_tpu_torch.web.handlers import ImageService

    svc = ImageService(device="cpu", max_batch=4, batch_form_ms=1)
    yield svc
    svc.close()


@pytest.mark.parametrize("path,dims", [
    ("/smartcrop?width=300&height=300", (300, 300)),
    ("/smartcrop?width=200", (600, 200)),
    ("/pipeline?operations=%5B%7B%22operation%22%3A%20%22smartcrop%22%2C%20%22params"
     "%22%3A%20%7B%22width%22%3A%20300%2C%20%22height%22%3A%20200%7D%7D%5D", (200, 300)),
])
def test_smartcrop_route_serves_jpeg(service, path, dims):
    url, _, qs = path.partition("?")
    resp = service.process(url.lstrip("/"), fixture_bytes("smart-crop.jpg"),
                           dict(urllib.parse.parse_qsl(qs)))
    assert (resp.status, resp.content_type) == (200, "image/jpeg")
    assert _pixels(resp.body).shape[:2] == dims
