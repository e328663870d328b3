"""The port's chain, codec and pipeline held against the JAX package on the CPU.

- `run_batch` of the port (plans carried over with `plan_from_dict`) against
  the reference `run_batch`, for the resize and crop plans of config 1 and
  the thumbnail, rotate, flip and flop plans of config 2, in both
  transports, at B=1 and B=4: uint8 outputs to at most 1 LSB;
- the port's packed 4:2:0 decode byte-equal to the reference's;
- `process_operation` on the 1080p main-path JPEG, and on an EXIF-rotated
  JPEG: the reference's dimensions and metadata, and PSNR >= 45 dB against
  the reference's output;
- `process_pipeline` (BASELINE config 3's chain on a small PNG, the 1080p
  JPEG /pipeline chain, ignore_failure, the operation-count limits) and
  /blur, /watermark, /convert, colorspace=bw, /fit, /enlarge, /extract and
  /zoom through `process_operation`: each package's chain output (the
  array it encodes) within 1 LSB of the other's, same dims and MIME type;
  the lossy WEBP at PSNR >= 30 dB against that array;
- `_encode`'s three fallbacks, as the reference's (pipeline.py:159-192):
  a WEBP target over WEBP's size limit answers JPEG, planes whose raw
  encode fails are encoded from `yuv_planes_to_rgb`, and egress blocks
  whose entropy encode fails from `blocks_to_planes`; the port's copies
  of those two give the reference's arrays bit for bit.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch
from PIL import Image

from imaginary_tpu import codecs as jcodecs
from imaginary_tpu import pipeline as jpipeline
from imaginary_tpu.ops import chain as jchain
from imaginary_tpu.ops import plan as jplan
from imaginary_tpu.ops.buckets import bucket_shape
from imaginary_tpu.params import build_params_from_query as jquery
from imaginary_tpu_torch import codecs as pcodecs
from imaginary_tpu_torch import pipeline as ppipeline
from imaginary_tpu_torch.ops import chain as pchain
from imaginary_tpu_torch.ops import plan as pplan
from imaginary_tpu_torch.params import build_params_from_query as pquery
from tests.conftest import fixture_bytes, psnr
from tests.test_torch_plan import plan_to_dict
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

U8_TOL = 1
QUERY = {"width": "300", "height": "200"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def large():
    return fixture_bytes("large.jpg")


def _variants(base: np.ndarray, n: int, seed: int) -> list:
    """base plus n-1 seeded noisy copies (distinct images in one batch)."""
    rng = np.random.default_rng(seed)
    out = [np.array(base)]
    for _ in range(n - 1):
        noise = rng.integers(-12, 13, size=base.shape)
        out.append(np.clip(base.astype(np.int32) + noise, 0, 255).astype(np.uint8))
    return out


def _max_lsb(a, b) -> int:
    if hasattr(a, "y"):
        return max(int(np.abs(getattr(a, k).astype(int) - getattr(b, k).astype(int)).max())
                   for k in ("y", "u", "v"))
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("transport", ["yuv420", "rgb"])
@pytest.mark.parametrize("op", ["resize", "crop"])
def test_run_batch_matches_reference(large, op, transport, batch):
    meta = jcodecs.probe_fast(large)
    shrink = jplan.choose_decode_shrink(op, jquery(QUERY), meta.height, meta.width, 0, 3)
    assert shrink == 4
    sh, sw = -(-meta.height // shrink), -(-meta.width // shrink)
    jp = jplan.plan_operation(op, jquery(QUERY), sh, sw, 0, 3)
    if transport == "yuv420":
        hb, wb = bucket_shape(sh, sw)
        base, _, _, _ = jcodecs.decode_yuv420(large, shrink, hb, wb)
        jp = jplan.wrap_plan_yuv420(jp, sh, sw)
    else:
        base = jcodecs.decode(large, shrink).array
    arrs = _variants(base, batch, seed=batch)
    pp = pplan.plan_from_dict(plan_to_dict(jp))
    want = jchain.run_batch(arrs, [jp] * batch)
    got = pchain.run_batch(arrs, [pp] * batch, device="cpu")
    assert len(got) == batch
    for g, w in zip(got, want):
        if transport == "yuv420":
            assert (g.y.shape, g.u.shape, g.v.shape) == (w.y.shape, w.u.shape, w.v.shape)
        else:
            assert g.shape == w.shape == (200, 300, 3)
        assert _max_lsb(g, w) <= U8_TOL


ORIENT_QUERIES = [
    ("thumbnail", {"width": "300", "height": "200"}),
    ("rotate", {"rotate": "90"}),
    ("rotate", {"rotate": "180"}),
    ("rotate", {"rotate": "270"}),
    ("flip", {}),
    ("flop", {}),
]


@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("transport", ["yuv420", "rgb"])
@pytest.mark.parametrize("op,query", ORIENT_QUERIES,
                         ids=[f"{op}-{'-'.join(q.values()) or 'plain'}" for op, q in ORIENT_QUERIES])
def test_run_batch_matches_reference_on_orientation_plans(large, op, query, transport, batch):
    """The orientation chains (K5 with K2, K3 and K4 around it), planned on
    large.jpg decoded at 1/4 (480x270) so the CPU runs stay short; the
    thumbnail plan is config 2's own."""
    sh, sw = 270, 480
    jp = jplan.plan_operation(op, jquery(query), sh, sw, 0, 3)
    if transport == "yuv420":
        hb, wb = bucket_shape(sh, sw)
        base, _, _, _ = jcodecs.decode_yuv420(large, 4, hb, wb)
        jp = jplan.wrap_plan_yuv420(jp, sh, sw)
    else:
        base = jcodecs.decode(large, 4).array
    arrs = _variants(base, batch, seed=10 + batch)
    pp = pplan.plan_from_dict(plan_to_dict(jp))
    want = jchain.run_batch(arrs, [jp] * batch)
    got = pchain.run_batch(arrs, [pp] * batch, device="cpu")
    assert len(got) == batch
    for g, w in zip(got, want):
        if transport == "yuv420":
            assert (g.y.shape, g.u.shape, g.v.shape) == (w.y.shape, w.u.shape, w.v.shape)
        else:
            assert g.shape == w.shape == (jp.out_h, jp.out_w, 3)
        assert _max_lsb(g, w) <= U8_TOL


def test_chain_surface(large):
    """The executor-facing helpers: identity chains skip the device, the
    checksum is order sensitive, OOM errors are recognised, donation is on
    (the reference's default) and nothing refuses it."""
    arr = np.zeros((4, 4, 3), np.uint8)
    ident = pplan.ImagePlan(stages=[], out_h=4, out_w=4)
    assert pchain.launch_batch([arr], [ident], device="cpu") is None
    assert np.array_equal(pchain.run_single(arr, ident, device="cpu"), arr)
    assert pchain.output_checksum(np.arange(4, dtype=np.uint8)) != pchain.output_checksum(
        np.arange(4, dtype=np.uint8)[::-1])
    assert pchain.is_oom_error(MemoryError()) and pchain.is_oom_error(
        RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert not pchain.is_oom_error(RuntimeError("device-side assert"))
    ds = pchain.donation_stats()
    assert (ds["enabled"], ds["rejected"]) == (True, 0)
    padded = pchain.pad_to_bucket(np.ones((270, 480, 3), np.uint8))
    assert padded.shape == (320, 512, 3) and padded[270:].sum() == 0
    pchain.clear_cache()
    p = pplan.plan_operation("resize", pquery(QUERY), 40, 60, 0, 3)
    for _ in range(2):
        pchain.run_single(np.zeros((40, 60, 3), np.uint8), p, device="cpu")
    assert pchain.cache_size() == 1


@pytest.mark.parametrize("shrink", [1, 4])
def test_decode_yuv420_byte_equal_to_reference(large, shrink):
    sh, sw = -(-1080 // shrink), -(-1920 // shrink)
    hb, wb = bucket_shape(sh, sw)
    want = jcodecs.decode_yuv420(large, shrink, hb, wb)
    got = pcodecs.decode_yuv420(large, shrink, hb, wb)
    assert got[1:] == want[1:]
    assert got[0].shape == want[0].shape and got[0].tobytes() == want[0].tobytes()
    meta = pcodecs.probe_fast(large)
    assert (meta.width, meta.height, meta.subsampling) == (1920, 1080, "420")


def _pixels(body: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


@pytest.mark.parametrize("op", ["resize", "crop"])
def test_process_operation_matches_reference(large, op):
    want = jpipeline.process_operation(op, large, jquery(QUERY))
    got = ppipeline.process_operation(op, large, pquery(QUERY), device="cpu")
    assert got.mime == want.mime == "image/jpeg"
    assert (got.width, got.height) == (300, 200)
    a, b = _pixels(got.body), _pixels(want.body)
    assert a.shape == b.shape == (200, 300, 3)
    assert psnr(a, b) >= 45.0


def test_process_operation_rgb_transport_matches_reference(large):
    """A 4:4:4 JPEG cannot ride the packed 4:2:0 transport: the RGB path
    (uint8 cast and epilogue fused into the first and last kernels)."""
    img = Image.open(io.BytesIO(large)).convert("RGB").resize((480, 270))
    bio = io.BytesIO()
    img.save(bio, format="JPEG", quality=90, subsampling=0)
    buf = bio.getvalue()
    assert pcodecs.probe_fast(buf).subsampling == "444"
    for op in ("resize", "crop"):
        want = jpipeline.process_operation(op, buf, jquery(QUERY))
        got = ppipeline.process_operation(op, buf, pquery(QUERY), device="cpu")
        assert (got.width, got.height) == (300, 200)
        assert psnr(_pixels(got.body), _pixels(want.body)) >= 45.0


def test_process_operation_carries_metadata_like_reference():
    buf = fixture_bytes("exif-orient-6.jpg")
    q = {"width": "120", "height": "90", "norotation": "true"}
    want = jpipeline.process_operation("resize", buf, jquery(q))
    got = ppipeline.process_operation("resize", buf, pquery(q), device="cpu")
    assert pcodecs.jpeg_metadata_segments(got.body) == jcodecs.jpeg_metadata_segments(want.body)
    assert (got.width, got.height) == (want.width, want.height)


def test_process_operation_applies_exif_orientation_like_reference():
    """An EXIF-rotated JPEG (orientation 6) without norotation: the chain
    transposes and flops on the card before it resizes."""
    buf = fixture_bytes("exif-orient-6.jpg")
    q = {"width": "120", "height": "90"}
    want = jpipeline.process_operation("resize", buf, jquery(q))
    got = ppipeline.process_operation("resize", buf, pquery(q), device="cpu")
    assert got.mime == want.mime == "image/jpeg"
    assert (got.width, got.height) == (want.width, want.height) == (120, 90)
    assert pcodecs.jpeg_metadata_segments(got.body) == jcodecs.jpeg_metadata_segments(want.body)
    a, b = _pixels(got.body), _pixels(want.body)
    assert a.shape == b.shape == (90, 120, 3)
    assert psnr(a, b) >= 45.0


def test_process_operation_runs_through_a_given_runner(large):
    """The web layer's executor hook: the runner sees every chain the
    request runs, and its output is what gets encoded."""
    seen = []

    def runner(arr, plan):
        seen.append(type(plan.stages[1].spec).__name__)
        return pchain.run_single(arr, plan, device="cpu")

    direct = ppipeline.process_operation("rotate", large, pquery({"rotate": "90"}), device="cpu")
    via = ppipeline.process_operation("rotate", large, pquery({"rotate": "90"}), device="cpu",
                                      runner=runner)
    assert seen == ["TransposeSpec"]
    assert via.body == direct.body and (via.width, via.height) == (1080, 1920)


# --- /pipeline and the slice-3 routes ----------------------------------------

def _png(seed: int, h: int = 270, w: int = 480, c: int = 3) -> bytes:
    """A seeded test pattern with noise, as PNG."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [xx * 255 // w, yy * 255 // h, (xx // 8 + yy // 8) * 16 % 256, 255 - yy * 200 // h]
    img = np.stack(chans[:c], axis=-1) + rng.integers(-6, 7, size=(h, w, c))
    out = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(out, "PNG")
    return out.getvalue()


def _ops(*ops) -> dict:
    import json

    return {"operations": json.dumps(list(ops))}


def _both(name, buf, query, mark=None):
    """(reference result, port result, reference pre-encode arrays, port
    pre-encode arrays): each package's process_operation with a runner
    that records what its chain returned, and the RGBA `mark` of a
    watermarkImage (the reference's fetcher returns it for any URL)."""
    jseen, pseen = [], []

    def jrun(arr, plan):
        jseen.append(jchain.run_single(arr, plan))
        return jseen[-1]

    def prun(arr, plan):
        pseen.append(pchain.run_single(arr, plan, device="cpu"))
        return pseen[-1]

    fetcher = (lambda url: mark) if mark is not None else None
    want = jpipeline.process_operation(name, buf, jquery(query), runner=jrun,
                                       watermark_fetcher=fetcher)
    got = ppipeline.process_operation(name, buf, pquery(query), device="cpu", runner=prun,
                                      watermark_rgba=mark)
    return want, got, jseen, pseen


def _assert_same_result(want, got, jseen, pseen):
    assert got.mime == want.mime
    assert (got.width, got.height) == (want.width, want.height)
    assert len(jseen) == len(pseen)
    for a, b in zip(pseen, jseen):
        assert _max_lsb(a, b) <= U8_TOL


CONFIG3 = [
    {"operation": "resize", "params": {"width": 1280}},
    {"operation": "blur", "params": {"sigma": 1.2}},
    {"operation": "watermark", "params": {"text": "bench", "opacity": 0.5}},
    {"operation": "convert", "params": {"type": "webp"}},
]
JPEG_PIPELINE = [
    {"operation": "crop", "params": {"width": 1600, "height": 900}},
    {"operation": "resize", "params": {"width": 640}},
    {"operation": "blur", "params": {"sigma": 1.5}},
    {"operation": "convert", "params": {"type": "jpeg"}},
]


@pytest.mark.parametrize("width", [160, 1280])
def test_pipeline_config3_chain_matches_reference(width):
    """BASELINE config 3's chain on a small PNG: the resize to 1/3 of the
    width as config 3 does at 4K, and the exact width 1280."""
    ops = [dict(CONFIG3[0], params={"width": width})] + CONFIG3[1:]
    want, got, jseen, pseen = _both("pipeline", _png(3), _ops(*ops))
    _assert_same_result(want, got, jseen, pseen)
    assert got.mime == "image/webp" and len(pseen) == 1
    # the lossy WEBP decodes within a bound of the chain's own array
    dec = np.asarray(Image.open(io.BytesIO(got.body)).convert("RGB"))
    assert dec.shape == pseen[0].shape and psnr(dec, pseen[0]) >= 30.0


def test_pipeline_jpeg_chain_on_the_yuv_transport_matches_reference(large):
    want, got, jseen, pseen = _both("pipeline", large, _ops(*JPEG_PIPELINE))
    _assert_same_result(want, got, jseen, pseen)
    assert hasattr(pseen[0], "y") and (got.width, got.height) == (640, 360)
    assert psnr(_pixels(got.body), _pixels(want.body)) >= 45.0


@pytest.mark.parametrize("ignore", [True, False])
def test_pipeline_ignore_failure_skips_an_op_that_fails_planning(ignore):
    from imaginary_tpu.errors import ImageError as JImageError
    from imaginary_tpu_torch.errors import ImageError

    ops = [{"operation": "resize", "params": {"width": 200}},
           {"operation": "crop", "params": {}, "ignore_failure": ignore},
           {"operation": "flip", "params": {}}]
    buf = _png(5)
    if ignore:
        _assert_same_result(*_both("pipeline", buf, _ops(*ops)))
        return
    with pytest.raises(JImageError) as je:
        jpipeline.process_operation("pipeline", buf, jquery(_ops(*ops)))
    with pytest.raises(ImageError) as pe:
        ppipeline.process_operation("pipeline", buf, pquery(_ops(*ops)), device="cpu")
    assert (pe.value.code, pe.value.message) == (je.value.code, je.value.message) == \
        (400, "Missing required param: height or width")


@pytest.mark.parametrize("n_ops", [0, 11])
def test_pipeline_operation_count_limits_match_reference(n_ops):
    from imaginary_tpu.errors import ImageError as JImageError
    from imaginary_tpu_torch.errors import ImageError

    query = _ops(*[{"operation": "flip", "params": {}}] * n_ops) if n_ops else {}
    buf = _png(6)
    with pytest.raises(JImageError) as je:
        jpipeline.process_operation("pipeline", buf, jquery(query))
    with pytest.raises(ImageError) as pe:
        ppipeline.process_operation("pipeline", buf, pquery(query), device="cpu")
    assert (pe.value.code, pe.value.message) == (je.value.code, je.value.message)
    assert pe.value.code == 400


def test_pipeline_of_ten_operations_is_served():
    ops = [{"operation": "flip", "params": {}}, {"operation": "flop", "params": {}}] * 5
    _assert_same_result(*_both("pipeline", _png(7), _ops(*ops)))


def _mark(h: int = 60, w: int = 150) -> np.ndarray:
    """A seeded RGBA mark with an alpha ramp across it."""
    rng = np.random.default_rng(14)
    rgb = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    alpha = np.tile(np.linspace(0, 255, w).astype(np.uint8), (h, 1))[..., None]
    return np.concatenate([rgb, alpha], axis=2)


def _watermark_query(where, **params):
    q = {"image": "http://example.invalid/mark.png", **params}
    if where == "alone":
        return "watermarkImage", q
    return "pipeline", _ops({"operation": "resize", "params": {"width": 100}},
                            {"operation": "watermarkImage", "params": q})


@pytest.mark.parametrize("where", ["alone", "in-pipeline"])
def test_watermark_image_answers_501(where):
    """Named for the 501 these requests answered before the watermark
    image was served: the port's process_operation, given the RGBA mark,
    holds the reference's (whose fetcher returns the same array) within 1
    LSB, placed past the right edge so the planner clamps it."""
    name, query = _watermark_query(where, top=12, left=470, opacity=0.7)
    want, got, jseen, pseen = _both(name, _png(8), query, mark=_mark())
    _assert_same_result(want, got, jseen, pseen)
    assert len(pseen) == 1 and got.mime == "image/png"


@pytest.mark.parametrize("where", ["alone", "in-pipeline"])
def test_watermark_image_on_the_yuv_transport_matches_reference(large, where):
    """A 4:2:0 JPEG in and out: K2 -> K7 (placed) -> K3, the planes within
    1 LSB of the reference's."""
    name, query = _watermark_query(where, top=40, left=1500, opacity=0.6)
    want, got, jseen, pseen = _both(name, large, query, mark=_mark(96, 240))
    _assert_same_result(want, got, jseen, pseen)
    assert hasattr(pseen[0], "y") and got.mime == "image/jpeg"


@pytest.mark.parametrize("where", ["alone", "in-pipeline"])
def test_watermark_image_without_its_mark_answers_like_reference(where):
    from imaginary_tpu.errors import ImageError as JImageError
    from imaginary_tpu_torch.errors import ImageError

    name, query = _watermark_query(where)
    with pytest.raises(JImageError) as je:
        jpipeline.process_operation(name, _png(8), jquery(query))
    with pytest.raises(ImageError) as pe:
        ppipeline.process_operation(name, _png(8), pquery(query), device="cpu")
    assert (pe.value.code, pe.value.message) == (je.value.code, je.value.message)
    assert pe.value.message == "Unable to retrieve watermark image: " + query.get(
        "image", "http://example.invalid/mark.png")


# (operation, query, source): the slice's routes, colorspace=bw through
# K8 on both transports and on an RGBA PNG, and the routes this slice
# serves with K1 and K4 alone
ROUTES = [
    ("blur", {"sigma": "2"}, "png"),
    ("blur", {"sigma": "1.5", "minampl": "0.1"}, "jpg"),
    ("watermark", {"text": "imaginary port", "opacity": "0.6"}, "png"),
    ("watermark", {"text": "once", "noreplicate": "true", "margin": "12",
                   "color": "255,0,0", "font": "sans bold 14"}, "png-rgba"),
    ("convert", {"type": "webp"}, "png"),
    ("convert", {"type": "png"}, "jpg"),
    ("resize", {"width": "300", "colorspace": "bw"}, "jpg"),
    ("resize", {"width": "200", "colorspace": "bw", "type": "png"}, "png-rgba"),
    ("fit", {"width": "300", "height": "300"}, "jpg"),
    ("enlarge", {"width": "2400", "height": "1400"}, "jpg"),
    ("extract", {"top": "40", "left": "60", "areawidth": "500", "areaheight": "300"}, "jpg"),
    ("zoom", {"factor": "2"}, "png"),
]


@pytest.mark.parametrize("op,query,src", ROUTES,
                         ids=[f"{r[0]}-{r[2]}-{i}" for i, r in enumerate(ROUTES)])
def test_route_matrix_matches_reference(large, op, query, src):
    buf = {"png": _png(9), "png-rgba": _png(10, c=4), "jpg": large}[src]
    want, got, jseen, pseen = _both(op, buf, query)
    _assert_same_result(want, got, jseen, pseen)
    if got.mime in ("image/png", "image/jpeg") and src != "jpg":
        assert psnr(_pixels(got.body), _pixels(want.body)) >= 45.0


def _wide_png() -> bytes:
    rng = np.random.default_rng(11)
    out = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (64, 17000, 3), dtype=np.uint8)).save(out, "PNG")
    return out.getvalue()


@pytest.mark.parametrize("how", ["convert", "pipeline"])
def test_failed_webp_encode_falls_back_to_jpeg_like_reference(how):
    """17000 columns pass WEBP's 16383-pixel limit: the reference re-encodes
    as JPEG and reports image/jpeg (pipeline.py:183-192)."""
    import json

    buf = _wide_png()
    if how == "convert":
        out = ppipeline.process_operation("convert", buf, pquery({"type": "webp"}),
                                          device="cpu")
        want = jpipeline.process_operation("convert", buf, jquery({"type": "webp"}))
    else:
        q = {"operations": json.dumps([{"operation": "convert", "params": {"type": "webp"}}])}
        out = ppipeline.process_operation("pipeline", buf, pquery(q), device="cpu")
        want = jpipeline.process_operation("pipeline", buf, jquery(q))
    assert out.mime == want.mime == "image/jpeg"
    got = pcodecs.decode(out.body).array
    ref = jcodecs.decode(want.body).array
    assert got.shape == ref.shape == (64, 17000, 3)
    assert psnr(got, ref) >= 30.0


def _planes(seed: int, h: int = 37, w: int = 53) -> tuple:
    """Smooth 4:2:0 planes with seeded noise of +-3 (JPEG keeps them)."""
    rng = np.random.default_rng(seed)
    ch, cw = -(-h // 2), -(-w // 2)

    def plane(rows, cols, lo, hi):
        yy, xx = np.mgrid[0:rows, 0:cols]
        ramp = lo + (hi - lo) * (yy + xx) / (rows + cols)
        return np.clip(ramp + rng.integers(-3, 4, (rows, cols)), 0, 255).astype(np.uint8)

    return plane(h, w, 30, 220), plane(ch, cw, 90, 160), plane(ch, cw, 160, 100)


def test_failed_raw_plane_encode_falls_back_to_rgb_like_reference(monkeypatch):
    """A raw-plane JPEG encode that fails is retried from RGB pixels:
    `yuv_planes_to_rgb`, equal to the reference's bit for bit, then the
    RGB encoder (the parent raised the raw encoder's error)."""
    y, u, v = _planes(3)
    planes = pcodecs.YuvPlanes(y=y, u=u, v=v)
    rgb = pcodecs.yuv_planes_to_rgb(planes)
    assert np.array_equal(rgb, jcodecs.yuv_planes_to_rgb(jcodecs.YuvPlanes(y=y, u=u, v=v)))

    def fail(*a, **k):
        raise pcodecs.CodecError("Cannot encode image: raw path refused", 400)

    monkeypatch.setattr(pcodecs, "encode_yuv", fail)
    out = ppipeline._encode(planes, pquery({}), ppipeline.ImageType.JPEG)
    assert out.mime == "image/jpeg"
    back = pcodecs.decode(out.body).array
    assert back.shape == rgb.shape and psnr(back, rgb) >= 30.0


def test_failed_encode_quantized_falls_back_to_planes_like_reference(monkeypatch):
    """Egress blocks whose entropy encode fails are rebuilt into planes by
    `blocks_to_planes` (equal to the reference's bit for bit) and take the
    raw-plane encoder (the parent raised the entropy encoder's error)."""
    from imaginary_tpu.codecs import jpeg_dct as jdct
    from imaginary_tpu_torch.codecs import jpeg_dct as pdct

    h, w = 37, 53
    rng = np.random.default_rng(5)
    my, mx = -(-h // 16), -(-w // 16)

    def blocks(rows, cols):
        # a DC ramp over the blocks and the lowest AC terms at +-1
        b = np.zeros((rows, cols, 8, 8), np.int16)
        rr, cc = np.mgrid[0:rows, 0:cols]
        b[..., 0, 0] = 2 * (rr + cc) - 8
        b[..., 0, 1] = rng.integers(-1, 2, (rows, cols))
        b[..., 1, 0] = rng.integers(-1, 2, (rows, cols))
        return b

    parts = dict(y=blocks(2 * my, 2 * mx), u=blocks(my, mx), v=blocks(my, mx))
    qb = pdct.QuantizedBlocks(h=h, w=w, quality=80, **parts)
    got = pdct.blocks_to_planes(qb)
    want = jdct.blocks_to_planes(jdct.QuantizedBlocks(h=h, w=w, quality=80, **parts))
    assert all(np.array_equal(g, r) for g, r in zip(got, want))
    assert [p.shape for p in got] == [(h, w), (19, 27), (19, 27)]

    def fail(*a, **k):
        raise pcodecs.CodecError("Cannot encode image: entropy coder refused", 400)

    monkeypatch.setattr(pdct, "encode_quantized", fail)
    out = ppipeline._encode(qb, pquery({}), ppipeline.ImageType.JPEG)
    assert out.mime == "image/jpeg"
    rgb = pcodecs.yuv_planes_to_rgb(pcodecs.YuvPlanes(*got))
    back = pcodecs.decode(out.body).array
    assert back.shape == rgb.shape and psnr(back, rgb) >= 30.0
