"""The port's native host codec held against the JAX package's on the CPU.

The port's `imaginary_tpu_torch/native/codecs.cpp` is the JAX package's
`imaginary_tpu/native/codecs.cpp` for JPEG, PNG (libpng's simplified
reader and writer, and its low-level writer for interlace, palette and
speed), WEBP, TIFF and the in-tree GIF codec with its median-cut
palette. Every case here goes through both on the same seeded input and
holds:

- decoded pixels equal at 0 LSB (16-bit and gAMA PNGs, palette output
  and GIF included), with the same channel count and alpha flag;
- encoded bytes equal where both link the same library: the GIF codec is
  in-tree, so always; PNG, WEBP and TIFF when the port's build took the
  system route for that library (`native_backend.linked()`), as the JAX
  package's build links the system's;
- the same through both HTTP apps (`/convert` and `/resize` to png, gif,
  tiff and webp, with `palette` and `interlace`).

Also: the build reports each library's route, a library with no route
fails the build loudly (no partial build), and the codec digests that
`chip_smoke.py` checks on the card equal the JAX package's answers.
"""

from __future__ import annotations

import asyncio
import ctypes
import ctypes.util
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from imaginary_tpu.codecs import EncodeOptions as JOpts
from imaginary_tpu.codecs import native_backend as jnative
from imaginary_tpu.imgtype import ImageType as JType
from imaginary_tpu_torch import codecs as pcodecs
from imaginary_tpu_torch.codecs import EncodeOptions, native_backend
from imaginary_tpu_torch.imgtype import ImageType
from imaginary_tpu_torch.native import build
from tests.conftest import fixture_bytes
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

# the library behind each format's bytes (GIF needs none)
LIBRARY = {"jpeg": "jpeg", "png": "png", "webp": "webp", "tiff": "tiff", "gif": None}


def same_library(fmt: str) -> bool:
    """True when the port links the library the JAX package links for
    `fmt` (the system's), so their encoded bytes must be equal."""
    lib = LIBRARY[fmt]
    return lib is None or native_backend.linked()[lib].startswith("system ")


# --- inputs --------------------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


COLOR_TYPE = {"gray": 0, "gray-alpha": 4, "rgb": 2, "rgba": 6, "palette": 3}
CHANNELS = {"gray": 1, "gray-alpha": 2, "rgb": 3, "rgba": 4, "palette": 1}


def png_bytes(form: str, depth: int, gamma: int, seed: int) -> bytes:
    """A seeded non-interlaced PNG of colour type `form` at bit depth
    `depth`, with a gAMA chunk (in 1/100000) unless gamma is 0; a palette
    PNG has 1 << depth entries and a tRNS chunk giving some of them
    partial alpha."""
    rng = np.random.default_rng(seed)
    h, w, c = 19, 23, CHANNELS[form]
    extra = b""
    if form == "palette":
        n = 1 << depth
        extra = (_chunk(b"PLTE", rng.integers(0, 256, (n, 3), dtype=np.uint8).tobytes())
                 + _chunk(b"tRNS", rng.integers(0, 256, n // 2, dtype=np.uint8).tobytes()))
        idx = rng.integers(0, n, (h, w), dtype=np.uint8)
        per_byte = 8 // depth
        rows = []
        for y in range(h):
            row = np.zeros(-(-w // per_byte), np.uint8)
            for x in range(w):
                row[x // per_byte] |= idx[y, x] << (8 - depth * (x % per_byte + 1))
            rows.append(row.tobytes())
    else:
        hi = 65536 if depth == 16 else 256
        a = rng.integers(0, hi, (h, w, c), dtype=np.uint16 if depth == 16 else np.uint8)
        rows = [(a[y].astype(">u2") if depth == 16 else a[y]).tobytes() for y in range(h)]
    raw = b"".join(b"\x00" + r for r in rows)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, COLOR_TYPE[form], 0, 0, 0)
    gama = _chunk(b"gAMA", struct.pack(">I", gamma)) if gamma else b""
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + gama + extra
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _pil(arr: np.ndarray, fmt: str, **kw) -> bytes:
    out = io.BytesIO()
    Image.fromarray(arr).save(out, fmt, **kw)
    return out.getvalue()


def frame(c: int, seed: int, h: int = 61, w: int = 83) -> np.ndarray:
    """A smooth seeded frame with noise of +-8; its alpha (C = 4) a ramp
    across that is under 128 on the left."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (w + h)], -1)
    rgb = np.clip(base + rng.integers(-8, 9, base.shape), 0, 255).astype(np.uint8)
    alpha = (xx * 255 // (w - 1)).astype(np.uint8)
    if c == 1:
        return np.ascontiguousarray(rgb[..., :1])
    return np.ascontiguousarray(rgb) if c == 3 else np.dstack([rgb, alpha])


def gif_sources() -> dict:
    rgb = frame(3, 31)
    idx = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE, colors=32)
    transparent = io.BytesIO()
    idx.save(transparent, "GIF", transparency=5)
    offset = io.BytesIO()  # a second, smaller frame placed inside the screen
    first = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE, colors=16)
    first.save(offset, "GIF", save_all=True, interlace=False, append_images=[
        Image.fromarray(rgb[:20, :30]).convert("P", palette=Image.Palette.ADAPTIVE)])
    return {
        "test.gif": fixture_bytes("test.gif"),
        "transparent-index": transparent.getvalue(),
        "interlaced": _pil(rgb, "GIF", interlace=True),
        "two-frames": offset.getvalue(),
        "native-rgba": jnative.encode(frame(4, 32), JOpts(type=JType.GIF)),
    }


def tiff_sources() -> dict:
    tiff_bytes = chip_smoke.tiff_bytes
    rng = np.random.default_rng(41)
    u16 = rng.integers(0, 65536, (17, 29, 3), dtype=np.uint16)
    return {
        "rgb8": tiff_bytes(frame(3, 42)),
        "rgba8": tiff_bytes(frame(4, 43)),
        "gray8": tiff_bytes(frame(1, 44)),
        "gray16": tiff_bytes(u16[..., :1]),
        "rgb16": tiff_bytes(u16),
        "lzw-rgb8": _pil(frame(3, 45), "TIFF", compression="tiff_lzw"),
    }


def webp_sources() -> dict:
    return {
        "test.webp": fixture_bytes("test.webp"),
        "lossy-rgb": _pil(frame(3, 51), "WEBP", quality=60),
        "lossless-rgba": _pil(frame(4, 52), "WEBP", lossless=True),
    }


PNG_FORMS = [("gray", 8), ("gray", 16), ("gray-alpha", 8), ("gray-alpha", 16),
             ("rgb", 8), ("rgb", 16), ("rgba", 8), ("rgba", 16),
             ("palette", 8), ("palette", 4)]


def _held_equal(buf: bytes, t: ImageType) -> None:
    got = native_backend.decode(buf, t)
    want = jnative.decode(buf, JType(t.value))
    assert got.array.dtype == np.uint8 and got.array.shape == want.array.shape
    assert np.array_equal(got.array, want.array)
    assert (got.orientation, got.has_alpha) == (want.orientation, want.has_alpha)
    # the whole codec layer decodes the same, and probes the same header
    assert np.array_equal(pcodecs.decode(buf).array, want.array)
    p, r = native_backend.native_probe(buf, t), jnative._native_probe(buf, JType(t.value))
    assert (p.width, p.height, p.channels, p.has_alpha) == \
        (r.width, r.height, r.channels, r.has_alpha)


def _system_libpng() -> int:
    return ctypes.CDLL(ctypes.util.find_library("png16")).png_access_version_number()


# --- decode --------------------------------------------------------------------

@pytest.mark.parametrize("gamma", [0, 45455], ids=["no-gAMA", "gAMA"])
@pytest.mark.parametrize("form,depth", PNG_FORMS, ids=[f"{f}-{d}" for f, d in PNG_FORMS])
def test_png_decode_equals_the_jax_package(form, depth, gamma):
    """libpng's simplified reader in both: 16-bit samples (linear light
    where no gAMA says otherwise) and any gAMA to 8-bit sRGB, palettes
    and tRNS to RGB(A), gray to RGB."""
    _held_equal(png_bytes(form, depth, gamma, seed=depth * 7 + len(form) + gamma % 97),
                ImageType.PNG)


@pytest.mark.parametrize("name", ["interlaced", "native-rgba", "test.gif",
                                  "transparent-index", "two-frames"])
def test_gif_decode_equals_the_jax_package(name):
    """The in-tree GIF decoder: the first frame on its logical screen, a
    transparent index as alpha 0, interlaced rows in pass order."""
    _held_equal(gif_sources()[name], ImageType.GIF)


@pytest.mark.parametrize("name", ["gray16", "gray8", "lzw-rgb8", "rgb16", "rgb8", "rgba8"])
def test_tiff_decode_equals_the_jax_package(name):
    """libtiff's scanline reader for 8-bit contiguous RGB(A), its RGBA
    reader (16 bits to 8, gray to RGB) for the rest."""
    _held_equal(tiff_sources()[name], ImageType.TIFF)


@pytest.mark.parametrize("name", ["lossless-rgba", "lossy-rgb", "test.webp"])
def test_webp_decode_equals_the_jax_package(name):
    _held_equal(webp_sources()[name], ImageType.WEBP)


# --- encode --------------------------------------------------------------------

PNG_MODES = {
    "plain": {},
    "interlace": {"interlace": True},
    "palette": {"palette": True},
    "speed": {"speed": 5, "compression": 9},
}


def _encode_both(arr: np.ndarray, fmt: str, **kw) -> tuple:
    got = pcodecs.encode(arr, EncodeOptions(type=ImageType(fmt), **kw))
    want = jnative.encode(arr, JOpts(type=JType(fmt), **kw))
    if same_library(fmt):
        assert got == want
    g = jnative.decode(got, JType(fmt)).array
    w = jnative.decode(want, JType(fmt)).array
    assert g.shape == w.shape and np.array_equal(g, w)
    return got, want


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("mode", sorted(PNG_MODES))
def test_png_encode_equals_the_jax_package(mode, c):
    """Plain PNG through libpng's simplified writer; interlace (Adam7),
    palette (median cut, Floyd-Steinberg, index 0 transparent where any
    alpha is under 128) and speed (its filters, compression's zlib level)
    through the low-level writer."""
    got, _ = _encode_both(frame(c, 60 + c), "png", **PNG_MODES[mode])
    assert got[28] == (1 if mode == "interlace" else 0)  # IHDR's interlace byte
    assert (got[25] == 3) == (mode == "palette" and c >= 3)  # colour type


@pytest.mark.parametrize("c", [1, 3, 4])
def test_gif_encode_equals_the_jax_package(c):
    """The in-tree GIF encoder: byte-equal whatever the libraries."""
    got, want = _encode_both(frame(c, 70 + c), "gif")
    assert got == want


@pytest.mark.parametrize("c", [1, 3, 4])
def test_tiff_encode_equals_the_jax_package(c):
    got, _ = _encode_both(frame(c, 80 + c), "tiff")
    assert Image.open(io.BytesIO(got)).tag_v2[259] == 5  # LZW


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("quality", [50, 90])
def test_webp_encode_equals_the_jax_package(quality, c):
    _encode_both(frame(c, 90 + c), "webp", quality=quality)


# --- both HTTP apps ------------------------------------------------------------

HTTP_SOURCE = "rgba.png"
HTTP_QUERIES = ("type=png", "type=gif", "type=tiff", "type=webp", "type=png&palette=true",
                "type=png&interlace=true", "type=png&palette=true&interlace=true&speed=3")
HTTP_REQUESTS = ([f"/convert?{q}" for q in HTTP_QUERIES]
                 + [f"/resize?width=120&{q}" for q in HTTP_QUERIES])


def _http_sources() -> dict:
    return {HTTP_SOURCE: _pil(frame(4, 101, 150, 210), "PNG"),
            "test.gif": fixture_bytes("test.gif"), "imaginary.jpg": fixture_bytes("imaginary.jpg")}


async def _answers(create_app, options, paths: list, body: bytes) -> list:
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(create_app(options, log_stream=io.StringIO())))
    await client.start_server()
    try:
        out = []
        for path in paths:
            r = await client.post(path, data=body, headers={"Content-Type": "image/png"})
            out.append((r.status, r.headers.get("Content-Type"), await r.read()))
        return out
    finally:
        await client.close()


def _recording(module, calls: list):
    """`module.encode` that also keeps each frame and its options."""
    real = module.encode

    def encode(arr, opts):
        calls.append((np.array(arr), opts))
        return real(arr, opts)

    return encode


@pytest.fixture(scope="module")
def http_answers():
    """{(source, path): (reference (answer, frame, opts), port's)} through
    both apps, with the frame and options each handed its native encoder."""
    from imaginary_tpu.web.app import create_app as ref_app
    from imaginary_tpu.web.config import ServerOptions as RefOptions
    from imaginary_tpu_torch.web.app import create_app as port_app
    from imaginary_tpu_torch.web.config import ServerOptions as PortOptions

    out = {}
    mp = pytest.MonkeyPatch()
    ref_calls, port_calls = [], []
    mp.setattr(jnative, "encode", _recording(jnative, ref_calls))
    mp.setattr(native_backend, "encode", _recording(native_backend, port_calls))
    try:
        for name, body in _http_sources().items():
            paths = [p for s, p in HTTP_CASES if s == name]
            ref = asyncio.run(_answers(ref_app, RefOptions(host_spill=False), paths, body))
            got = asyncio.run(_answers(port_app, PortOptions(device="cpu"), paths, body))
            assert len(ref_calls) == len(port_calls) == len(paths)
            for path, r, g, rc, gc in zip(paths, ref, got, ref_calls, port_calls):
                out[(name, path)] = ((r, *rc), (g, *gc))
            ref_calls.clear()
            port_calls.clear()
    finally:
        mp.undo()
    return out


HTTP_CASES = [(s, p) for s in (HTTP_SOURCE, "test.gif", "imaginary.jpg")
              for p in HTTP_REQUESTS]


@pytest.mark.parametrize("source,path", HTTP_CASES, ids=[f"{s}:{p}" for s, p in HTTP_CASES])
def test_http_answers_equal_the_reference_apps(http_answers, source, path):
    """Each app hands its native encoder a frame and options: the options
    are the same, the frames equal (a /resize's within the chain's 1 LSB,
    held in the chain's own tests), and the port's answer is the JAX
    package's native encode of the port's frame under the reference's
    options: 0 LSB after decoding, the same bytes on the same library,
    and the reference's own bytes wherever the frames are equal."""
    ((rs, rt, rb), rframe, ropts), ((gs, gt, gb), gframe, gopts) = http_answers[(source, path)]
    assert (gs, gt) == (rs, rt) and rs == 200
    fields = ("effective_quality", "effective_compression")
    assert [getattr(gopts, f)() for f in fields] == [getattr(ropts, f)() for f in fields]
    assert (gopts.type.value, gopts.interlace, gopts.palette, gopts.speed) == \
        (ropts.type.value, ropts.interlace, ropts.palette, ropts.speed)
    assert gframe.shape == rframe.shape
    diff = np.abs(gframe.astype(int) - rframe).max()
    assert diff <= (0 if path.startswith("/convert") else 1)
    fmt = rt.split("/")[1]
    want = jnative.encode(gframe, ropts)
    if same_library(fmt):
        assert gb == want
        assert diff > 0 or gb == rb
    w = jnative.decode(want, JType(fmt)).array
    g = jnative.decode(gb, JType(fmt)).array
    assert g.shape == w.shape and np.array_equal(g, w)


# --- the build -----------------------------------------------------------------

def test_the_build_carries_every_format_and_names_each_route():
    ext = native_backend.extension()
    assert ext.FORMATS == "jpeg,png,webp,gif,tiff"
    linked = native_backend.linked()
    assert sorted(linked) == ["jpeg", "png", "tiff", "webp"]
    for lib, route in linked.items():
        assert route.startswith("system ") or "/" in route, (lib, route)
    if linked["png"].startswith("system "):
        # the version the module reports is the loaded library's
        assert ext.LIBPNG == _system_libpng()
    assert pcodecs.routes() == dict.fromkeys(["jpeg", "png", "webp", "gif", "tiff"], "native")


@pytest.mark.parametrize("lib", [lib[0] for lib in build.LIBRARIES])
def test_a_library_without_a_route_fails_the_build_loudly(lib, monkeypatch):
    """No partial build: a library that neither the system nor a wheel
    offers stops the build before anything compiles."""
    real = build.library_routes
    monkeypatch.setattr(build, "library_routes",
                        lambda spec: [] if spec[0] == lib else real(spec))
    monkeypatch.setattr(build.subprocess, "run", lambda *a, **k: pytest.fail("compiled"))
    with pytest.raises(RuntimeError, match=f"no route to {lib}"):
        build.build()


def test_without_system_libraries_every_route_is_a_wheels(monkeypatch):
    """Where the loader knows none of the libraries (the card machine),
    each library's routes are wheel copies, Pillow's first, compiled
    against the vendored headers and found through the module's RPATH."""
    system = build.link_routes()
    monkeypatch.setattr(build.ctypes.util, "find_library", lambda name: None)
    wheels = build.link_routes()
    for spec, routes in zip(build.LIBRARIES, wheels):
        assert routes and "/pillow.libs/" in routes[0][0], spec[0]
        for _, cflags, libs in routes:
            assert libs[1] == f"-Wl,-rpath,{os.path.dirname(libs[0])}"
            assert cflags == ([f"-I{os.path.join(build.HERE, spec[4])}"] if spec[4] else [])
    # the build's digest covers the routes, so the two builds never mix
    assert (build.library_path(system) == build.library_path(wheels)) == (system == wheels)


# --- chip_smoke.py's pins -------------------------------------------------------

def test_chip_smokes_codec_pins_equal_the_jax_package():
    """CODEC_DIGESTS, the WEBP shapes and the pinned 16-bit pixels are the
    JAX package's answers on the CPU (its build links the system libpng,
    the release CODEC_LIBPNG_PIN names), and the port gives the same here;
    `codec_phase`, which the card runs, passes on them."""
    digests, webp, pixels = chip_smoke.codec_digests(jnative._ext)
    assert digests == chip_smoke.CODEC_DIGESTS
    assert webp == chip_smoke.CODEC_WEBP_SHAPES
    assert _system_libpng() == chip_smoke.CODEC_LIBPNG_PIN
    for name, arr in pixels.items():
        assert np.array_equal(arr, chip_smoke.pinned_pixels(name)), name
    assert sorted(pixels) == sorted(chip_smoke.CODEC_PIXEL_SHAPES)
    got = chip_smoke.codec_phase()
    assert got["digests"] == digests and got["webp"] == webp
    if native_backend.extension().LIBPNG == chip_smoke.CODEC_LIBPNG_PIN:
        assert all(v["max_abs"] == 0 for v in got["linear_png16"].values())
