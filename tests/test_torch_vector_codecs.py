"""SVG, PDF, HEIF and AVIF in the port, held against the reference.

The port's copies of the reference's `tests/test_vector_codecs.py` cases,
each also asking the reference for its answer on the same bytes, then the
two aiohttp apps on the same requests:

- decodes are bit-equal (both bind the same host libraries, librsvg,
  poppler-glib and libheif, and run the same `pdf_mini` arithmetic);
- HTTP answers have equal status, content type and dims, and PNG answers
  pixels within 1 LSB (the bound of ROADMAP.md's ground rules: the
  resample after the decode runs the port's plain versions on the CPU
  against the reference's XLA program);
- the crafted inflate bomb and the self-referencing `/Length` answer what
  the reference answers.

A case skips only where the reference's own test skips: for lack of the
loader on the host, which gates both packages alike.
"""

from __future__ import annotations

import asyncio
import dataclasses
import io
import json
import zlib

import numpy as np
import pytest
from PIL import Image

from imaginary_tpu import codecs as rcodecs
from imaginary_tpu.codecs import pdf_mini as rpdf
from imaginary_tpu.codecs import vector_backend as rvb
from imaginary_tpu_torch import codecs as pcodecs
from imaginary_tpu_torch.codecs import pdf_mini as ppdf
from imaginary_tpu_torch.codecs import vector_backend as pvb
from tests.conftest import fixture_bytes
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


def _meta(m) -> dict:
    return dataclasses.asdict(m)


def _both_decode(buf: bytes, shrink: int = 1):
    got, want = pcodecs.decode(buf, shrink), rcodecs.decode(buf, shrink)
    assert np.array_equal(got.array, want.array)
    assert (got.type.value, got.orientation, got.has_alpha) == (
        want.type.value, want.orientation, want.has_alpha)
    return got


def _both_raise(fn_port, fn_ref):
    with pytest.raises(Exception) as got:
        fn_port()
    with pytest.raises(Exception) as want:
        fn_ref()
    assert getattr(got.value, "code", None) == getattr(want.value, "code", None)
    return got.value


def _port_op(name: str, buf: bytes, **kw):
    from imaginary_tpu_torch.options import ImageOptions
    from imaginary_tpu_torch.pipeline import process_operation

    o = ImageOptions(**kw)
    for k in kw:
        o.mark_defined(k)
    return process_operation(name, buf, o, device="cpu")


def _ref_op(name: str, buf: bytes, **kw):
    from imaginary_tpu.options import ImageOptions
    from imaginary_tpu.pipeline import process_operation

    o = ImageOptions(**kw)
    for k in kw:
        o.mark_defined(k)
    return process_operation(name, buf, o)


def _dims(body: bytes) -> tuple:
    return Image.open(io.BytesIO(body)).size


class TestSVG:
    @pytest.fixture(autouse=True)
    def _need_rsvg(self):
        if not rvb.svg_available():
            pytest.skip("librsvg not on host")
        assert pvb.svg_available()

    def test_probe_reports_intrinsic_size(self):
        m = pcodecs.probe(fixture_bytes("button.svg"))
        assert (m.width, m.height) == (240, 160)
        assert m.type == "svg"
        assert _meta(m) == _meta(rcodecs.probe(fixture_bytes("button.svg")))

    def test_decode_rasterizes(self):
        d = _both_decode(fixture_bytes("button.svg"))
        assert d.array.shape == (160, 240, 4)
        assert tuple(d.array[80, 120][:3]) == (47, 158, 68)
        assert tuple(d.array[80, 60][:3]) == (224, 49, 49)
        assert tuple(d.array[5, 5][:3]) == (16, 32, 48)

    @pytest.mark.parametrize("shrink", [2, 4, 8])
    def test_shrink_on_load_renders_into_the_box(self, shrink):
        d = _both_decode(fixture_bytes("button.svg"), shrink)
        assert d.array.shape[:2] == (-(-160 // shrink), -(-240 // shrink))

    def test_resize_svg_end_to_end(self):
        buf = fixture_bytes("button.svg")
        out, ref = _port_op("resize", buf, width=120), _ref_op("resize", buf, width=120)
        assert out.mime == ref.mime == "image/jpeg"  # svg is not encodable
        assert pcodecs.probe(out.body).width == 120
        assert _dims(out.body) == _dims(ref.body)

    def test_resize_svg_picks_the_references_shrink(self):
        from imaginary_tpu import pipeline as rpipe
        from imaginary_tpu.options import ImageOptions as RefOptions
        from imaginary_tpu_torch import pipeline as ppipe
        from imaginary_tpu_torch.imgtype import ImageType
        from imaginary_tpu_torch.options import ImageOptions

        buf = fixture_bytes("button.svg")
        meta = pcodecs.probe_fast(buf)
        got = ppipe._pick_shrink("resize", ImageType.SVG, ImageOptions(width=60), meta)
        want = rpipe._pick_shrink("resize", buf, RefOptions(width=60))
        assert got == want > 1

    def test_info_svg(self):
        buf = fixture_bytes("button.svg")
        meta = json.loads(_port_op("info", buf).body)
        assert (meta["width"], meta["height"]) == (240, 160)
        assert meta == json.loads(_ref_op("info", buf).body)


class TestPDF:
    def test_page_size_pure_python(self):
        size = pvb.pdf_page_size(fixture_bytes("page.pdf"))
        assert size == (240, 160) == rvb.pdf_page_size(fixture_bytes("page.pdf"))

    def test_probe_pdf(self):
        m = pcodecs.probe(fixture_bytes("page.pdf"))
        assert (m.width, m.height) == (240, 160)
        assert m.type == "pdf"
        assert _meta(m) == _meta(rcodecs.probe(fixture_bytes("page.pdf")))

    def test_decode_pdf(self):
        d = _both_decode(fixture_bytes("page.pdf"))
        assert d.array.shape == (160, 240, 4)
        assert tuple(d.array[5, 5][:3]) == (255, 255, 255)
        assert d.array[80, 120][0] > 180
        assert d.array[80, 120][1] < 100

    def test_resize_pdf_end_to_end(self):
        buf = fixture_bytes("page.pdf")
        out = _port_op("resize", buf, width=120, type="png")
        ref = _ref_op("resize", buf, width=120, type="png")
        assert out.mime == ref.mime == "image/png"
        assert _dims(out.body)[0] == 120
        a = np.asarray(Image.open(io.BytesIO(out.body)), np.int16)
        b = np.asarray(Image.open(io.BytesIO(ref.body)), np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1


def _mk_pdf(content: bytes, media=(0, 0, 240, 160), flate=False, length=None) -> bytes:
    """The reference test's classic-xref single-page PDF writer; `length`
    replaces the content stream's /Length value (bytes)."""
    extra = b""
    data = content
    if flate:
        data = zlib.compress(content)
        extra = b" /Filter /FlateDecode"
    if length is None:
        length = str(len(data)).encode()
    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [%d %d %d %d] "
        b"/Contents 4 0 R >>" % media,
        b"<< /Length " + length + extra + b" >>\nstream\n" + data + b"\nendstream",
    ]
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objs, start=1):
        offsets.append(len(out))
        out += str(i).encode() + b" 0 obj\n" + body + b"\nendobj\n"
    xref_at = len(out)
    out += b"xref\n0 " + str(len(objs) + 1).encode() + b"\n0000000000 65535 f \n"
    for off in offsets:
        out += ("%010d 00000 n \n" % off).encode()
    out += (b"trailer\n<< /Size " + str(len(objs) + 1).encode()
            + b" /Root 1 0 R >>\nstartxref\n" + str(xref_at).encode()
            + b"\n%%EOF\n")
    return bytes(out)


def inflate_bomb() -> bytes:
    """A page whose content stream inflates past pdf_mini's 64 MB budget
    (about 65 KB on the wire)."""
    return _mk_pdf(b" " * (65 * 1024 * 1024), flate=True)


def circular_length() -> bytes:
    """A page whose content stream's /Length is a reference to its own
    object."""
    return _mk_pdf(b"0 0 1 rg 10 10 50 50 re f", length=b"4 0 R")


class TestPdfMiniRenderer:
    def test_transform_bezier_evenodd_flate(self):
        content = b"""
q 1 0 0 1 20 20 cm
0 0 1 rg
0 0 m 100 0 l 100 100 l 0 100 l h f
Q
1 0 0 rg
150 30 m 230 30 l 230 110 l 150 110 l h
170 50 m 210 50 l 210 90 l 170 90 l h
f*
0 1 0 rg
30 130 m 60 160 90 160 120 130 c 120 130 l 30 130 l h f
"""
        pdf = _mk_pdf(content, flate=True)
        arr = ppdf.rasterize(pdf)
        assert np.array_equal(arr, rpdf.rasterize(pdf))
        assert tuple(arr[100, 60][:3]) == (0, 0, 255)
        assert tuple(arr[120, 160][:3]) == (255, 0, 0)
        assert tuple(arr[90, 190][:3]) == (255, 255, 255)
        assert tuple(arr[20, 75][:3]) == (0, 255, 0)

    @pytest.mark.parametrize("content,what", [
        (b"BT /F1 12 Tf (Hi) Tj ET", "text"),
        (b"/Im0 Do", "xobject/image"),
        (b"/P1 scn", "pattern color"),
        (b"0 0 240 160 re W n", "clipping"),
    ])
    def test_beyond_subset_is_refused(self, content, what):
        pdf = _mk_pdf(content)
        with pytest.raises(ppdf.UnsupportedPdf) as got:
            ppdf.rasterize(pdf)
        with pytest.raises(rpdf.UnsupportedPdf) as want:
            rpdf.rasterize(pdf)
        assert str(got.value) == str(want.value)

    def test_no_paint_operator_discards_path(self):
        pdf = _mk_pdf(b"0 0 240 160 re n 0 0 1 rg 10 10 50 50 re f")
        arr = ppdf.rasterize(pdf)
        assert np.array_equal(arr, rpdf.rasterize(pdf))
        assert tuple(arr[100, 200][:3]) == (255, 255, 255)
        assert tuple(arr[120, 30][:3]) == (0, 0, 255)

    def test_beyond_subset_gates_406_through_codecs(self):
        if rvb.pdf_available():
            pytest.skip("poppler present: renders for real, no gate")
        pdf = _mk_pdf(b"BT ET")
        err = _both_raise(lambda: pcodecs.decode(pdf), lambda: rcodecs.decode(pdf))
        assert err.code == 406

    @pytest.mark.parametrize("make", [inflate_bomb, circular_length],
                             ids=["inflate-bomb", "circular-length"])
    def test_crafted_pdfs_are_refused_like_the_reference(self, make):
        pdf = make()
        with pytest.raises(ppdf.UnsupportedPdf) as got:
            ppdf.rasterize(pdf)
        with pytest.raises(rpdf.UnsupportedPdf) as want:
            rpdf.rasterize(pdf)
        assert str(got.value) == str(want.value)
        if not rvb.pdf_available():
            err = _both_raise(lambda: pcodecs.decode(pdf), lambda: rcodecs.decode(pdf))
            assert err.code == 406


class TestAVIF:
    @pytest.fixture(autouse=True)
    def _need_avif(self, testdata):
        import os

        if not os.path.exists(os.path.join(testdata, "test.avif")):
            pytest.skip("no AVIF encoder on host")

    def test_probe_and_decode(self):
        buf = fixture_bytes("test.avif")
        m = pcodecs.probe(buf)
        assert (m.width, m.height) == (320, 240)
        assert _meta(m) == _meta(rcodecs.probe(buf))
        d = _both_decode(buf)
        assert d.array.shape[0] == 240 and d.array.shape[1] == 320

    def test_resize_avif_to_avif(self):
        from imaginary_tpu_torch.imgtype import determine_image_type

        buf = fixture_bytes("test.avif")
        out = _port_op("resize", buf, width=160, type="avif")
        ref = _ref_op("resize", buf, width=160, type="avif")
        assert out.mime == ref.mime == "image/avif"
        assert determine_image_type(out.body).value == "avif"
        assert _meta(pcodecs.probe(out.body)) == _meta(rcodecs.probe(ref.body))


class TestHEIFGate:
    def test_heif_size_or_gate(self):
        junk = b"\x00\x00\x00\x18ftypheic" + b"\x00" * 64
        err = _both_raise(lambda: pcodecs.decode(junk), lambda: rcodecs.decode(junk))
        assert err.code in (400, 406)


def _jpeg(w: int, h: int) -> bytes:
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // max(w - 1, 1)).astype(np.uint8),
                    (yy * 255 // max(h - 1, 1)).astype(np.uint8),
                    np.full((h, w), 90, np.uint8)], axis=-1)
    out = io.BytesIO()
    Image.fromarray(img).save(out, "JPEG", quality=90, subsampling=2)
    return out.getvalue()


class TestHeifEncode:
    def test_convert_to_heif_end_to_end(self):
        if not rvb.heif_encode_available("hevc"):
            pytest.skip("no libheif HEVC encoder on this host")
        buf = _jpeg(320, 240)
        out = _port_op("convert", buf, type="heif", width=160)
        ref = _ref_op("convert", buf, type="heif", width=160)
        assert out.mime == ref.mime == "image/heif"
        back, _alpha = pvb.decode_heif(out.body)
        assert back.shape[:2] == (120, 160) == rvb.decode_heif(ref.body)[0].shape[:2]
        want = np.asarray(Image.open(io.BytesIO(buf)).convert("RGB").resize((160, 120)))
        mse = np.mean((back[..., :3].astype(float) - want.astype(float)) ** 2)
        assert 10 * np.log10(255.0**2 / max(mse, 1e-9)) > 25.0

    def test_heif_encode_failure_falls_back_to_jpeg(self, monkeypatch):
        monkeypatch.setattr(pvb, "heif_encode_available", lambda fmt="hevc": False)
        monkeypatch.setattr(rvb, "heif_encode_available", lambda fmt="hevc": False)
        buf = _jpeg(160, 120)
        out = _port_op("convert", buf, type="heif")
        assert out.mime == _ref_op("convert", buf, type="heif").mime == "image/jpeg"


class TestSpeedParam:
    def test_heif_speed_changes_encode(self):
        if not rvb.heif_encode_available("av1"):
            pytest.skip("no AV1 encoder plugin on host")
        row = np.linspace(0, 255, 256).astype(np.uint8)
        arr = np.dstack([np.tile(row, (256, 1))] * 3)
        slow = pvb.encode_heif(arr, 60, "av1", speed=2)
        fast = pvb.encode_heif(arr, 60, "av1", speed=9)
        assert pvb.encode_heif(arr, 60, "av1", speed=2) == slow
        assert slow != fast
        assert slow == rvb.encode_heif(arr, 60, "av1", speed=2)

    def test_speed_flows_from_query_to_avif_encode(self):
        from imaginary_tpu.params import build_params_from_query as ref_params
        from imaginary_tpu_torch.params import build_params_from_query

        o = build_params_from_query({"type": "avif", "speed": "9"})
        assert o.speed == 9 == ref_params({"type": "avif", "speed": "9"}).speed


def test_no_route_answers_501_for_a_format_the_reference_decodes():
    """Every fixture format decodes or is refused with the reference's
    status, never the port's old 501."""
    for name in ("button.svg", "page.pdf", "test.avif"):
        buf = fixture_bytes(name)
        assert np.array_equal(pcodecs.decode(buf).array, rcodecs.decode(buf).array)
    for t in ("avif", "heif"):
        from imaginary_tpu.codecs import EncodeOptions as RefEncode
        from imaginary_tpu.imgtype import ImageType as RefType
        from imaginary_tpu_torch.codecs import EncodeOptions
        from imaginary_tpu_torch.imgtype import ImageType

        arr = np.full((16, 16, 3), 90, np.uint8)
        try:
            got = pcodecs.encode(arr, EncodeOptions(type=ImageType(t)))[:12]
        except Exception as e:  # noqa: BLE001 - compared below
            got = getattr(e, "code", None)
        try:
            want = rcodecs.encode(arr, RefEncode(type=RefType(t)))[:12]
        except Exception as e:  # noqa: BLE001 - compared below
            want = getattr(e, "code", None)
        assert got != 501 and type(got) is type(want)


# --- the two aiohttp apps on the same requests ------------------------------

# (id, path, source): a fixture is sent as `GET <path>&file=<name>` from
# both apps' mount, a function's bytes as a POSTed body
HTTP_CASES = [
    ("svg-resize", "/resize?width=300", "button.svg"),
    ("svg-resize-png", "/resize?width=300&type=png", "button.svg"),
    ("svg-thumbnail-png", "/thumbnail?width=60&height=40&type=png", "button.svg"),
    ("svg-info", "/info?", "button.svg"),
    ("pdf-resize", "/resize?width=300", "page.pdf"),
    ("pdf-resize-png", "/resize?width=300&type=png", "page.pdf"),
    ("pdf-info", "/info?", "page.pdf"),
    ("avif-resize", "/resize?width=300", "test.avif"),
    ("avif-info", "/info?", "test.avif"),
    ("jpeg-to-avif", "/resize?width=300&type=avif", "large.jpg"),
    ("jpeg-to-heif", "/resize?width=300&type=heif", "large.jpg"),
    ("svg-to-svg", "/resize?width=300&type=svg", "button.svg"),
    ("pdf-to-pdf", "/convert?type=pdf", "page.pdf"),
    ("pdf-inflate-bomb", "/resize?width=100", inflate_bomb),
    ("pdf-circular-length", "/resize?width=100", circular_length),
]
# POSTed SVG bodies: the reference's streamed body is a bytearray, which
# its ctypes binding of librsvg refuses (a 400 "argument 1: TypeError:
# wrong type"; its /info answers 0x0 unless the file's size is in its
# size cache already); the port hands librsvg bytes, and its answer is the
# reference's to the same file from its mount
POSTED_SVG = [("svg-resize", "/resize?width=300"), ("svg-info", "/info")]


async def _serve(create_app, options_cls, **extra) -> dict:
    from aiohttp.test_utils import TestClient, TestServer

    from tests.conftest import FIXTURES

    app = create_app(options_cls(mount=FIXTURES, **extra), log_stream=io.StringIO())
    client = TestClient(TestServer(app))
    await client.start_server()
    out = {}

    async def answer(r):
        return r.status, r.headers.get("Content-Type"), await r.read()

    try:
        for cid, path, src in HTTP_CASES:
            if callable(src):
                r = await client.post(path, data=src(),
                                      headers={"Content-Type": "application/pdf"})
            else:
                r = await client.get(f"{path}&file={src}")
            out[cid] = await answer(r)
        for cid, path in POSTED_SVG:
            r = await client.post(path, data=fixture_bytes("button.svg"),
                                  headers={"Content-Type": "image/svg+xml"})
            out["posted-" + cid] = await answer(r)
    finally:
        await client.close()
    return out


@pytest.fixture(scope="module")
def http_answers(testdata):
    """{case: (reference answer, port answer)}."""
    from imaginary_tpu.web.app import create_app as ref_app
    from imaginary_tpu.web.config import ServerOptions as RefOptions
    from imaginary_tpu_torch.web.app import create_app as port_app
    from imaginary_tpu_torch.web.config import ServerOptions as PortOptions

    async def run():
        ref = await _serve(ref_app, RefOptions, host_spill=False)
        got = await _serve(port_app, PortOptions, device="cpu")
        return {cid: (ref[cid], got[cid]) for cid in ref}

    return asyncio.run(run())


def _image_dims(ctype: str, body: bytes) -> tuple:
    if ctype == "image/heif":
        w, h, _ = pvb.heif_size(body)
        return w, h
    return _dims(body)


def _check_answer(want: tuple, got: tuple) -> None:
    (rs, rt, rb), (ps, pt, pb) = want, got
    assert (ps, pt) == (rs, rt), (pb[:200], rb[:200])
    if ps != 200 or pt == "application/json":
        assert json.loads(pb) == json.loads(rb)
        return
    assert _image_dims(pt, pb) == _image_dims(rt, rb)
    if pt == "image/png":
        a = np.asarray(Image.open(io.BytesIO(pb)), np.int16)
        b = np.asarray(Image.open(io.BytesIO(rb)), np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1


@pytest.mark.parametrize("cid", [c[0] for c in HTTP_CASES])
def test_http_answer_equals_the_reference_apps(http_answers, cid):
    want, got = http_answers[cid]
    _check_answer(want, got)
    if cid.startswith(("pdf-inflate", "pdf-circular")):
        assert got[0] == (200 if rvb.pdf_available() else 406)


@pytest.mark.parametrize("cid", [c[0] for c in POSTED_SVG])
def test_posted_svg_answers_as_the_reference_serves_the_file(http_answers, cid):
    if not rvb.svg_available():
        pytest.skip("librsvg not on host")
    ref_posted, got = http_answers["posted-" + cid]
    _check_answer(http_answers[cid][0], got)
    if cid == "svg-resize":
        assert ref_posted[0] == 400 and b"TypeError" in ref_posted[2]
