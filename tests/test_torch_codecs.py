"""The port's codec layer held against the JAX package's on the CPU.

PNG, WEBP, GIF and TIFF decode through the port's native codec, as JPEG
does, and must give the reference's native `decode` arrays exactly; PNG
and TIFF encodes round trip exactly, GIF as the reference's native
encoder's does, WEBP within a PSNR bound. The backend is picked by
format, never by failure: a bad JPEG stays a native-codec error that
never reaches Pillow, SVG, AVIF and PDF decode bit-equal to the
reference through the host's loaders (and AVIF encodes through its
ladder), PDF and SVG targets answer the reference's 400, and the
decompression-bomb gate refuses an over-cap PNG before decoding it.
16-bit PNGs (gray, gray + alpha, RGB, RGBA) and 16-bit gray TIFFs decode
as the reference's native codec decodes them (libpng's simplified reader
takes 16-bit samples as linear light to 8-bit sRGB; libtiff's RGBA
reader), at 0 LSB. tests/test_torch_native_codecs.py holds the rest of
the native codec.

The reference answers through whichever backend `imaginary_tpu.codecs`
picked first in the process (its native extension where it loads, else
cv2, else Pillow; the module global `_BACKEND`), and those backends
disagree on some headers (a gray PNG's channels). So the parity tests
ask the reference's native backend's functions directly, and never go
through that choice.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch
from PIL import Image

from imaginary_tpu import codecs as jcodecs
from imaginary_tpu.codecs import native_backend as jnative
from imaginary_tpu.codecs import pil_backend as jpil
from imaginary_tpu.imgtype import determine_image_type
from imaginary_tpu_torch import codecs as pcodecs
from imaginary_tpu_torch.codecs import EncodeOptions, native_backend
from imaginary_tpu_torch.errors import ImageError
from imaginary_tpu_torch.imgtype import ImageType
from tests.conftest import fixture_bytes, psnr
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png(arr: np.ndarray) -> bytes:
    out = io.BytesIO()
    Image.fromarray(arr).save(out, "PNG")
    return out.getvalue()


def _sources() -> dict:
    rng = np.random.default_rng(7)
    rgb = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, size=(29, 41, 4), dtype=np.uint8)
    gray = rng.integers(0, 256, size=(23, 31), dtype=np.uint8)
    pal = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE, colors=16)
    out = io.BytesIO()
    pal.save(out, "PNG", transparency=3)
    return {
        "png-rgb": _png(rgb),
        "png-rgba": _png(rgba),
        "png-gray": _png(gray),
        "png-palette-transparent": out.getvalue(),
        "test.png": fixture_bytes("test.png"),
        "test.webp": fixture_bytes("test.webp"),
        "test.gif": fixture_bytes("test.gif"),
    }


SOURCES = sorted(_sources())


def _probe_fields(meta) -> tuple:
    return meta.width, meta.height, meta.type, meta.has_alpha, meta.channels


def _reference_probe(buf: bytes) -> tuple:
    """The reference's hot-path probe answer, fixed: dims, type and alpha
    from its Pillow header parse, and the channel count as its native
    header probe reports it, the decoded one (decode gives RGB or RGBA;
    Pillow's probe reports the file's bands, 1 for a gray PNG). Where the
    native extension loads, its own `probe_fast` must give the same; where
    it does not, the channel count follows the native convention by
    construction, not by a native answer."""
    t = determine_image_type(buf)
    meta = jpil.probe(buf, t)
    want = (meta.width, meta.height, meta.type, meta.has_alpha,
            jpil.decode(buf, t).array.shape[2])
    if jnative.available():
        assert _probe_fields(jnative.probe_fast(buf, t)) == want
    return want


@pytest.mark.parametrize("name", SOURCES)
def test_decode_equals_reference(name):
    buf = _sources()[name]
    want = jnative.decode(buf, determine_image_type(buf))
    got = pcodecs.decode(buf)
    assert got.array.dtype == np.uint8 and got.array.shape == want.array.shape
    assert np.array_equal(got.array, want.array)
    assert (got.type.value, got.orientation, got.has_alpha) == \
        (want.type.value, want.orientation, want.has_alpha)


@pytest.mark.parametrize("name", SOURCES)
def test_probe_fast_equals_reference_dims(name):
    buf = _sources()[name]
    assert _probe_fields(pcodecs.probe_fast(buf)) == _reference_probe(buf)


@pytest.mark.parametrize("backend", ["native", "cv2", "pil"])
def test_parity_holds_whatever_backend_the_reference_picked(backend, monkeypatch):
    """Both parity tests give the same result whichever backend the
    reference's `_BACKEND` holds (set here to each in turn, whether or not
    its extension loads in this process, and restored by monkeypatch),
    because they never ask the reference's choice: `_backend()` fails
    here if anything calls it. The source is the gray PNG, on which cv2's
    probe disagrees with the others."""
    import importlib

    module = importlib.import_module(f"imaginary_tpu.codecs.{backend}_backend")
    monkeypatch.setattr(jcodecs, "_BACKEND", module)

    def chosen():
        raise AssertionError("a parity test asked the reference's backend choice")

    monkeypatch.setattr(jcodecs, "_backend", chosen)
    test_decode_equals_reference("png-gray")
    test_probe_fast_equals_reference_dims("png-gray")
    assert jcodecs._BACKEND is module


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("fmt", ["png", "tiff", "gif", "webp"])
def test_encode_round_trips(fmt, c):
    yy, xx = np.mgrid[0:48, 0:64]
    arr = np.stack([xx * 4, yy * 5, (xx + yy) * 2] + ([255 - yy * 3] if c == 4 else []),
                   axis=-1).astype(np.uint8)
    if fmt == "gif":
        # GIF holds 256 colours: encode an image that has fewer
        arr = (arr // 64 * 64).astype(np.uint8)[..., :3]
    arr = np.ascontiguousarray(arr)
    t = {"png": ImageType.PNG, "tiff": ImageType.TIFF, "gif": ImageType.GIF,
         "webp": ImageType.WEBP}[fmt]
    body = pcodecs.encode(arr, EncodeOptions(type=t))
    back = pcodecs.decode(body).array
    assert pcodecs.decode(body).type is t
    if fmt == "webp":
        assert back.shape[:2] == arr.shape[:2] and psnr(back[..., :3], arr[..., :3]) >= 30.0
    elif fmt == "gif":
        # the reference's median cut spends its 256 boxes halving the
        # commonest colours, so it may merge some of the 64: the round trip
        # is the reference's own, close to the frame
        from imaginary_tpu.codecs import EncodeOptions as JOpts
        from imaginary_tpu.imgtype import ImageType as JType

        want = jnative.decode(jnative.encode(arr, JOpts(type=JType.GIF)), JType.GIF).array
        assert np.array_equal(back, want) and psnr(back, arr) >= 30.0
    else:
        assert np.array_equal(back, arr)


def test_routes_pick_the_backend_by_format():
    assert pcodecs.routes() == {"jpeg": "native", "png": "native", "webp": "native",
                                "gif": "native", "tiff": "native"}


def test_a_bad_jpeg_never_retries_in_pillow(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("Pillow was asked to decode a JPEG")

    monkeypatch.setattr(Image, "open", boom)
    buf = b"\xff\xd8\xff\xe0" + bytes(range(256)) * 4  # a JPEG marker, then junk
    with pytest.raises(ImageError) as e:
        pcodecs.decode(buf)
    assert e.value.code == 400 and "Cannot decode image" in e.value.message


@pytest.mark.parametrize("fixture", ["button.svg", "test.avif", "page.pdf"])
def test_vector_formats_answer_as_the_reference(fixture):
    """SVG, AVIF and PDF decode bit-equal to the reference (the same host
    loaders; tests/test_torch_vector_codecs.py has the rest), and an AVIF
    target encodes through the reference's ladder instead of a 501."""
    from imaginary_tpu.codecs import EncodeOptions as JOpts
    from imaginary_tpu.imgtype import ImageType as JType

    buf = fixture_bytes(fixture)
    got, want = pcodecs.decode(buf), jcodecs.decode(buf)
    assert np.array_equal(got.array, want.array) and got.has_alpha == want.has_alpha
    arr = np.ascontiguousarray(got.array[..., :3])
    body = pcodecs.encode(arr, EncodeOptions(type=ImageType.AVIF))
    assert determine_image_type(body).value == "avif"
    assert body == jcodecs.encode(arr, JOpts(type=JType.AVIF))


def test_bomb_gate_refuses_an_over_cap_png_before_decoding(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the gate let the decode run")

    buf = fixture_bytes("test.png")  # 512x512: 0.26 megapixels
    token = pcodecs.set_decode_pixel_cap(0.2)
    try:
        monkeypatch.setattr(native_backend, "decode", boom)
        with pytest.raises(ImageError) as e:
            pcodecs.decode(buf)
        assert e.value.code == 413 and "megapixel decode limit" in e.value.message
        monkeypatch.undo()
        pcodecs.set_decode_pixel_cap(0.3)
        assert pcodecs.decode(buf).array.shape == (512, 512, 3)
    finally:
        pcodecs._DECODE_PIXEL_CAP.reset(token)


@pytest.mark.parametrize("fmt", ["pdf", "svg"])
def test_pdf_and_svg_targets_answer_the_references_400(fmt):
    """No backend of the reference can write these: 400 "Cannot encode
    image: unsupported format ..." (native_backend.py:117-122), not 501."""
    from imaginary_tpu.codecs import native_backend as jnb
    from imaginary_tpu.codecs import EncodeOptions as JOpts
    from imaginary_tpu.imgtype import ImageType as JType

    arr = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ImageError) as e:
        pcodecs.encode(arr, EncodeOptions(type=ImageType(fmt)))
    with pytest.raises(Exception) as want:
        jnb.encode(arr, JOpts(type=JType(fmt)))
    assert (e.value.code, e.value.message) == (want.value.code, want.value.message) == \
        (400, f"Cannot encode image: unsupported format {fmt}")


def png16(a: np.ndarray) -> bytes:
    """A non-interlaced 16-bit PNG of uint16 a [H, W] or [H, W, C] (C = 2
    gray + alpha, 3 RGB, 4 RGBA), written here: Pillow writes 16 bits
    only for gray."""
    import struct
    import zlib

    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + a[y].astype(">u2").tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("c", [1, 2, 3, 4], ids=["gray", "gray-alpha", "rgb", "rgba"])
def test_16bit_png_scales_like_the_references_cv2_backend(c):
    """Uniform 16-bit noise decodes as the reference's native codec
    decodes it, at 0 LSB: libpng's simplified reader takes the samples as
    linear light and writes 8-bit sRGB (brighter than the high byte, by
    up to 72 levels), where the port's Pillow route took v / 257 by the
    reference's cv2 backend's rule; never clipped to white (the Pillow
    route's first gray decode averaged 254.5)."""
    rng = np.random.default_rng(16 + c)
    a = rng.integers(0, 65536, (48, 64, c) if c > 1 else (48, 64), dtype=np.uint16)
    buf = png16(a)
    want = jnative.decode(buf, determine_image_type(buf))
    got = pcodecs.decode(buf)
    assert got.array.dtype == np.uint8 and got.array.shape == want.array.shape
    assert np.array_equal(got.array, want.array)
    assert got.has_alpha == want.has_alpha == (c in (2, 4))
    assert float(got.array[..., :3].mean()) < 250.0
    assert pcodecs.probe_fast(buf).channels == got.array.shape[2]


def test_16bit_gray_tiff_scales_by_the_same_rule():
    """A 16-bit gray TIFF decodes as the reference's native codec decodes
    it (libtiff's RGBA reader, gray to RGB), at 0 LSB."""
    rng = np.random.default_rng(21)
    a = rng.integers(0, 65536, (20, 30), dtype=np.uint16)
    out = io.BytesIO()
    Image.fromarray(a).save(out, "TIFF")
    buf = out.getvalue()
    got = pcodecs.decode(buf).array
    want = jnative.decode(buf, determine_image_type(buf)).array
    assert got.shape == (20, 30, 3)
    assert np.array_equal(got, want)
    assert all(np.array_equal(got[..., k], got[..., 0]) for k in range(3))


def _alpha_ramp_png(h: int = 240, w: int = 320) -> bytes:
    """An RGBA PNG: smooth colour, alpha rising from 0 to 255 across."""
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (w + h)], -1)
    alpha = xx * 255 // (w - 1)
    return _png(np.dstack([rgb, alpha]).astype(np.uint8))


def test_rgba_gif_keeps_the_references_alpha_mask(monkeypatch):
    """/resize?width=160&type=gif on an RGBA PNG with an alpha ramp: the
    port's alpha mask equals the reference app's (its native encoder's
    rule, alpha < 128 transparent), and the port's GIF is the reference's
    native encoder's bytes for the frame the port encoded."""
    from imaginary_tpu import pipeline as jpipeline
    from imaginary_tpu.params import build_params_from_query as jquery
    from imaginary_tpu_torch import pipeline as ppipeline
    from imaginary_tpu_torch.params import build_params_from_query as pquery

    frames = []
    real = native_backend.encode

    def encode(arr, opts):
        frames.append(arr)
        return real(arr, opts)

    monkeypatch.setattr(native_backend, "encode", encode)
    buf = _alpha_ramp_png()
    query = {"width": "160", "type": "gif"}
    got = ppipeline.process_operation("resize", buf, pquery(query), device="cpu")
    want = jpipeline.process_operation("resize", buf, jquery(query))
    assert got.mime == want.mime == "image/gif"
    g = np.asarray(Image.open(io.BytesIO(got.body)).convert("RGBA"))
    w = np.asarray(Image.open(io.BytesIO(want.body)).convert("RGBA"))
    assert g.shape == w.shape == (120, 160, 4)
    assert set(np.unique(w[..., 3]).tolist()) == {0, 255}
    assert np.array_equal(g[..., 3], w[..., 3])
    (frame,) = frames
    assert frame.shape == (120, 160, 4)
    assert got.body == jnative.encode(frame, jcodecs.EncodeOptions(
        type=determine_image_type(got.body)))


def test_opaque_gif_and_palette_png_are_unchanged():
    """Frames without a pixel under alpha 128 encode as the reference's
    native encoder writes them: the same GIF bytes, and a palette PNG of
    the same colours with no transparency; a palette PNG with such pixels
    takes the GIF's rule (alpha 0 below 128, else 255)."""
    from imaginary_tpu.imgtype import ImageType as JType

    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
    rgba = np.dstack([rgb, np.full((24, 40), 200, np.uint8)])
    for arr in (rgb, rgba):
        gif = pcodecs.encode(arr, EncodeOptions(type=ImageType.GIF))
        assert gif == jnative.encode(arr, jcodecs.EncodeOptions(type=JType.GIF))
        body = pcodecs.encode(arr, EncodeOptions(type=ImageType.PNG, palette=True))
        got = Image.open(io.BytesIO(body))
        assert got.mode == "P" and "transparency" not in got.info
        want = jnative.encode(arr, jcodecs.EncodeOptions(type=JType.PNG, palette=True))
        assert np.array_equal(np.asarray(got.convert("RGB")),
                              np.asarray(Image.open(io.BytesIO(want)).convert("RGB")))
    ramp = np.dstack([rgb, np.tile(np.arange(40, dtype=np.uint8) * 6, (24, 1))])
    got = np.asarray(Image.open(io.BytesIO(
        pcodecs.encode(ramp, EncodeOptions(type=ImageType.PNG, palette=True)))).convert("RGBA"))
    assert np.array_equal(got[..., 3], np.where(ramp[..., 3] < 128, 0, 255))


def _reference_and_port(op: str, buf: bytes, query: dict):
    """The answers of the reference's pipeline (its app's processing, on
    its native codec) and the port's to one request."""
    from imaginary_tpu import pipeline as jpipeline
    from imaginary_tpu.params import build_params_from_query as jquery
    from imaginary_tpu_torch import pipeline as ppipeline
    from imaginary_tpu_torch.params import build_params_from_query as pquery

    assert jnative.available(), "the reference's native codec sets the rules held here"
    want = jpipeline.process_operation(op, buf, jquery(dict(query)))
    got = ppipeline.process_operation(op, buf, pquery(dict(query)), device="cpu")
    assert got.mime == want.mime
    return got.body, want.body


@pytest.mark.parametrize("op,query", [
    ("resize", {"width": "64", "type": "png", "palette": "true"}),
    ("convert", {"type": "png", "palette": "true"}),
])
def test_palette_png_keeps_the_references_alpha_mask(op, query):
    """`palette=true` PNG of an RGBA source: the alpha mask equals the
    reference app's (two values, 0 below alpha 128)."""
    got, want = _reference_and_port(op, _alpha_ramp_png(), query)
    g = np.asarray(Image.open(io.BytesIO(got)).convert("RGBA"))
    w = np.asarray(Image.open(io.BytesIO(want)).convert("RGBA"))
    assert g.shape == w.shape
    assert set(np.unique(w[..., 3]).tolist()) == {0, 255}
    assert np.array_equal(g[..., 3], w[..., 3])


def test_interlaced_png_is_adam7_with_the_references_pixels():
    """/resize?width=100&interlace=true&type=png on large.jpg: IHDR's
    interlace byte is 1 in both answers, and the pixels agree within
    1 LSB."""
    got, want = _reference_and_port(
        "resize", fixture_bytes("large.jpg"),
        {"width": "100", "interlace": "true", "type": "png"})
    assert got[28] == want[28] == 1
    g = np.asarray(Image.open(io.BytesIO(got)).convert("RGB")).astype(int)
    w = np.asarray(Image.open(io.BytesIO(want)).convert("RGB")).astype(int)
    assert g.shape == w.shape and np.abs(g - w).max() <= 1


def _tiff_compression(body: bytes) -> int:
    return Image.open(io.BytesIO(body)).tag_v2[259]


def test_tiff_out_is_lzw_like_the_reference():
    got, want = _reference_and_port("resize", fixture_bytes("large.jpg"),
                                    {"width": "100", "type": "tiff"})
    assert _tiff_compression(got) == _tiff_compression(want) == 5
    g = np.asarray(Image.open(io.BytesIO(got)).convert("RGB")).astype(int)
    w = np.asarray(Image.open(io.BytesIO(want)).convert("RGB")).astype(int)
    assert g.shape == w.shape and np.abs(g - w).max() <= 1


def test_plain_png_ignores_compression_as_the_reference_does():
    """Without interlace, palette or speed the reference's PNG writer is
    libpng's simplified one, which never reads `compression`: both
    answers are the same bytes at levels 1 and 9. With `speed` the
    level is read again."""
    buf = fixture_bytes("large.jpg")
    bodies = {}
    for level in ("1", "9"):
        bodies[level] = _reference_and_port(
            "resize", buf, {"width": "100", "type": "png", "compression": level})
    assert bodies["1"][0] == bodies["9"][0] and bodies["1"][1] == bodies["9"][1]
    assert bodies["1"][0][28] == 0
    fast = [_reference_and_port("resize", buf, {"width": "100", "type": "png",
                                                "compression": lv, "speed": "1"})
            for lv in ("1", "9")]
    assert len(fast[0][0]) > len(fast[1][0]) and len(fast[0][1]) > len(fast[1][1])
