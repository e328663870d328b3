"""SVG / PDF / HEIF / AVIF decode via host native libraries (ctypes): the
port's copy of `imaginary_tpu/codecs/vector_backend.py`.

The reference serves these formats through libvips' loaders, which delegate
to librsvg, libpoppler(-glib) and libheif (reference Dockerfile installs
librsvg-2.4, poppler-glib, libheif — Dockerfile:14-17; type detection
type.go:25-44). Those libraries expose stable C APIs, so we bind them with
ctypes directly — no compile step, no Python wheels — and rasterize to HWC
uint8 RGBA for the TPU pipeline.

Availability is probed per-library: on hosts without librsvg/libheif/
poppler-glib the corresponding decode gates to a 406 (same behavior as a
libvips build compiled without that loader). The deploy Dockerfile installs
all three, so the container always serves them.

All rasterization happens on host (these are inherently serial,
pointer-chasing codecs); the resulting RGBA tensor rides the normal
micro-batched device path afterwards.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

_lock = threading.Lock()  # librsvg/cairo calls are serialized (glib not re-entrant-safe here)


def _load(*names):
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    return None


_cairo = _load("libcairo.so.2", "libcairo.so")
_rsvg = _load("librsvg-2.so.2", "librsvg-2.so")
_gobject = _load("libgobject-2.0.so.0", "libgobject-2.0.so")
_glib = _load("libglib-2.0.so.0", "libglib-2.0.so")
_heif = _load("libheif.so.1", "libheif.so")
_poppler = _load("libpoppler-glib.so.8", "libpoppler-glib.so")

_CAIRO_FORMAT_ARGB32 = 0


def _setup_cairo():
    c = _cairo
    c.cairo_image_surface_create.restype = ctypes.c_void_p
    c.cairo_image_surface_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    c.cairo_create.restype = ctypes.c_void_p
    c.cairo_create.argtypes = [ctypes.c_void_p]
    c.cairo_image_surface_get_data.restype = ctypes.POINTER(ctypes.c_ubyte)
    c.cairo_image_surface_get_data.argtypes = [ctypes.c_void_p]
    c.cairo_image_surface_get_stride.restype = ctypes.c_int
    c.cairo_image_surface_get_stride.argtypes = [ctypes.c_void_p]
    c.cairo_surface_flush.argtypes = [ctypes.c_void_p]
    c.cairo_destroy.argtypes = [ctypes.c_void_p]
    c.cairo_surface_destroy.argtypes = [ctypes.c_void_p]
    c.cairo_scale.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_double]
    c.cairo_set_source_rgb.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_double
    ]
    c.cairo_paint.argtypes = [ctypes.c_void_p]
    c.cairo_surface_status.restype = ctypes.c_int
    c.cairo_surface_status.argtypes = [ctypes.c_void_p]


if _cairo is not None:
    _setup_cairo()


_CAIRO_MAX_DIM = 16384  # cairo errors past 32767; clamp well below


def _new_surface(width: int, height: int):
    """ARGB32 surface with status checked — an error surface (dimension
    overflow, OOM) returns a NULL data pointer and wrapping that in numpy
    would segfault the server instead of 400ing the request."""
    surface = _cairo.cairo_image_surface_create(_CAIRO_FORMAT_ARGB32, width, height)
    if _cairo.cairo_surface_status(surface) != 0:
        _cairo.cairo_surface_destroy(surface)
        raise ValueError(f"cairo surface {width}x{height} failed")
    return surface


def _argb32_to_rgba(surface, width: int, height: int) -> np.ndarray:
    """Cairo ARGB32 (premultiplied, native-endian BGRA on LE) -> RGBA uint8."""
    _cairo.cairo_surface_flush(surface)
    if _cairo.cairo_surface_status(surface) != 0:
        raise ValueError("cairo surface in error state after render")
    data_ptr = _cairo.cairo_image_surface_get_data(surface)
    if not data_ptr:
        raise ValueError("cairo surface has no pixel data")
    stride = _cairo.cairo_image_surface_get_stride(surface)
    buf = np.ctypeslib.as_array(data_ptr, shape=(height, stride))
    px = buf[:, : width * 4].reshape(height, width, 4).copy()
    b, g, r, a = px[..., 0], px[..., 1], px[..., 2], px[..., 3]
    rgba = np.stack([r, g, b, a], axis=-1).astype(np.uint16)
    # unpremultiply
    alpha = rgba[..., 3:4]
    nz = np.maximum(alpha, 1)
    rgba[..., :3] = np.minimum(255, (rgba[..., :3] * 255 + nz // 2) // nz)
    rgba[..., :3] = np.where(alpha == 0, 0, rgba[..., :3])
    return rgba.astype(np.uint8)


# ---------------------------------------------------------------------------
# SVG via librsvg
# ---------------------------------------------------------------------------

class _RsvgRectangle(ctypes.Structure):
    _fields_ = [("x", ctypes.c_double), ("y", ctypes.c_double),
                ("width", ctypes.c_double), ("height", ctypes.c_double)]


class _RsvgDimensionData(ctypes.Structure):
    _fields_ = [("width", ctypes.c_int), ("height", ctypes.c_int),
                ("em", ctypes.c_double), ("ex", ctypes.c_double)]


def svg_available() -> bool:
    return _rsvg is not None and _cairo is not None and _gobject is not None


def _svg_handle(buf: bytes):
    _rsvg.rsvg_handle_new_from_data.restype = ctypes.c_void_p
    _rsvg.rsvg_handle_new_from_data.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p
    ]
    err = ctypes.c_void_p(None)
    h = _rsvg.rsvg_handle_new_from_data(buf, len(buf), ctypes.byref(err))
    if not h:
        raise ValueError("librsvg could not parse SVG")
    return h


# sha1(svg bytes) -> (w, h). Keyed on a 20-byte digest, NOT the payload:
# an lru_cache on buf would pin up to 256 entire (multi-MB) request bodies
# in memory with no size-based eviction. 28 bytes/entry here is negligible,
# but the STRUCTURE is still per-process state a key-flood can grow, so it
# is a real LRU with per-entry eviction + an eviction counter — the same
# accounting discipline every other cache in the tree carries (cache.py
# ByteBudgetLRU, the GCRA key store) — instead of the old stop-the-world
# clear() that dropped 4096 warm entries to admit one.
_SVG_SIZE_CACHE: OrderedDict = OrderedDict()
_SVG_SIZE_CACHE_MAX = 4096
_SVG_SIZE_EVICTIONS = 0
_svg_cache_lock = threading.Lock()


def svg_size_cache_stats() -> dict:
    """Items/evictions/capacity of the SVG size memo (test + /debugz
    accounting surface)."""
    with _svg_cache_lock:
        return {"items": len(_SVG_SIZE_CACHE),
                "evictions": _SVG_SIZE_EVICTIONS,
                "max": _SVG_SIZE_CACHE_MAX}


def svg_intrinsic_size(buf: bytes) -> tuple:
    """(width, height) in px; falls back to the legacy dimensions API.

    Cached so a request that probes the size (shrink selection, /info) and
    then rasterizes pays one size parse per distinct SVG, leaving only the
    (unavoidable) render parse inside rasterize_svg."""
    global _SVG_SIZE_EVICTIONS
    digest = hashlib.sha1(buf).digest()
    with _svg_cache_lock:
        hit = _SVG_SIZE_CACHE.get(digest)
        if hit is not None:
            _SVG_SIZE_CACHE.move_to_end(digest)
            return hit
    with _lock:
        h = _svg_handle(buf)
        try:
            size = _svg_size_from_handle(h)
        finally:
            _gobject.g_object_unref(ctypes.c_void_p(h))
    with _svg_cache_lock:
        _SVG_SIZE_CACHE[digest] = size
        _SVG_SIZE_CACHE.move_to_end(digest)
        while len(_SVG_SIZE_CACHE) > _SVG_SIZE_CACHE_MAX:
            _SVG_SIZE_CACHE.popitem(last=False)
            _SVG_SIZE_EVICTIONS += 1
    return size


def _svg_size_from_handle(h) -> tuple:
    try:
        fn = _rsvg.rsvg_handle_get_intrinsic_size_in_pixels
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                       ctypes.POINTER(ctypes.c_double)]
        w = ctypes.c_double(0)
        ht = ctypes.c_double(0)
        if fn(h, ctypes.byref(w), ctypes.byref(ht)) and w.value > 0 and ht.value > 0:
            return int(round(w.value)), int(round(ht.value))
    except AttributeError:
        pass
    dims = _RsvgDimensionData()
    _rsvg.rsvg_handle_get_dimensions.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _rsvg.rsvg_handle_get_dimensions(h, ctypes.byref(dims))
    return max(1, dims.width), max(1, dims.height)


def rasterize_svg(buf: bytes, shrink: int = 1) -> np.ndarray:
    """Render SVG bytes to RGBA uint8 at the intrinsic size, or with
    shrink=N at exactly ceil(intrinsic/N) — the shrink-on-load dimension
    contract, vector-sharp like libvips' svgload scale — reusing THIS
    handle's size so the request parses the XML once, not once per
    probe."""
    if not svg_available():
        raise RuntimeError("librsvg not available on this host")
    with _lock:
        h = _svg_handle(buf)
        try:
            iw, ih = _svg_size_from_handle(h)
            w, ht = -(-iw // max(1, shrink)), -(-ih // max(1, shrink))  # ceil
            w, ht = max(1, min(w, _CAIRO_MAX_DIM)), max(1, min(ht, _CAIRO_MAX_DIM))
            surface = _new_surface(w, ht)
            cr = _cairo.cairo_create(surface)
            try:
                try:
                    render = _rsvg.rsvg_handle_render_document  # librsvg >= 2.46
                except AttributeError:
                    render = None
                if render is not None:
                    render.restype = ctypes.c_int
                    render.argtypes = [
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p
                    ]
                    viewport = _RsvgRectangle(0.0, 0.0, float(w), float(ht))
                    err = ctypes.c_void_p(None)
                    ok = render(h, cr, ctypes.byref(viewport), ctypes.byref(err))
                else:
                    # legacy path (librsvg < 2.46): scale the cairo context
                    # to the target box, then render at intrinsic size
                    legacy = _rsvg.rsvg_handle_render_cairo
                    legacy.restype = ctypes.c_int
                    legacy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                    _cairo.cairo_scale(cr, w / iw, ht / ih)
                    ok = legacy(h, cr)
                if not ok:
                    raise ValueError("librsvg render failed")
                return _argb32_to_rgba(surface, w, ht)
            finally:
                _cairo.cairo_destroy(cr)
                _cairo.cairo_surface_destroy(surface)
        finally:
            _gobject.g_object_unref(ctypes.c_void_p(h))


# ---------------------------------------------------------------------------
# HEIF/AVIF via libheif
# ---------------------------------------------------------------------------

class _HeifError(ctypes.Structure):
    _fields_ = [("code", ctypes.c_int), ("subcode", ctypes.c_int),
                ("message", ctypes.c_char_p)]


_HEIF_COLORSPACE_RGB = 1
_HEIF_CHROMA_INTERLEAVED_RGBA = 11
_HEIF_CHANNEL_INTERLEAVED = 10


def heif_available() -> bool:
    return _heif is not None


_heif_ready = False


def _setup_heif():
    """One-time prototype setup (pattern of _setup_cairo)."""
    global _heif_ready
    if _heif_ready:
        return
    h = _heif
    h.heif_context_alloc.restype = ctypes.c_void_p
    h.heif_context_read_from_memory_without_copy.restype = _HeifError
    h.heif_context_read_from_memory_without_copy.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p
    ]
    h.heif_context_get_primary_image_handle.restype = _HeifError
    h.heif_context_get_primary_image_handle.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    ]
    h.heif_decode_image.restype = _HeifError
    h.heif_decode_image.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    h.heif_image_get_plane_readonly.restype = ctypes.POINTER(ctypes.c_ubyte)
    h.heif_image_get_plane_readonly.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    ]
    h.heif_image_handle_get_width.restype = ctypes.c_int
    h.heif_image_handle_get_width.argtypes = [ctypes.c_void_p]
    h.heif_image_handle_get_height.restype = ctypes.c_int
    h.heif_image_handle_get_height.argtypes = [ctypes.c_void_p]
    h.heif_image_handle_has_alpha_channel.restype = ctypes.c_int
    h.heif_image_handle_has_alpha_channel.argtypes = [ctypes.c_void_p]
    h.heif_context_free.argtypes = [ctypes.c_void_p]
    h.heif_image_handle_release.argtypes = [ctypes.c_void_p]
    h.heif_image_release.argtypes = [ctypes.c_void_p]
    _heif_ready = True


def decode_heif(buf: bytes) -> tuple:
    """HEIF/AVIF bytes -> (RGB/RGBA uint8, has_alpha); libheif applies
    EXIF/irot/imir. Opaque sources drop the decoded alpha plane so the
    decode path agrees with _probe_special's alpha flag (and PNG/WebP
    re-encodes don't grow a spurious channel, matching libvips' loader)."""
    if not heif_available():
        raise RuntimeError("libheif not available on this host")
    _setup_heif()
    h = _heif
    ctx = h.heif_context_alloc()
    handle = ctypes.c_void_p(None)
    img = ctypes.c_void_p(None)
    try:
        e = h.heif_context_read_from_memory_without_copy(ctx, buf, len(buf), None)
        if e.code != 0:
            raise ValueError(f"libheif read: {e.message.decode() if e.message else e.code}")
        e = h.heif_context_get_primary_image_handle(ctx, ctypes.byref(handle))
        if e.code != 0:
            raise ValueError("libheif: no primary image")
        e = h.heif_decode_image(
            handle, ctypes.byref(img), _HEIF_COLORSPACE_RGB,
            _HEIF_CHROMA_INTERLEAVED_RGBA, None,
        )
        if e.code != 0:
            raise ValueError(f"libheif decode: {e.message.decode() if e.message else e.code}")
        w = h.heif_image_handle_get_width(handle)
        ht = h.heif_image_handle_get_height(handle)
        stride = ctypes.c_int(0)
        plane = h.heif_image_get_plane_readonly(
            img, _HEIF_CHANNEL_INTERLEAVED, ctypes.byref(stride)
        )
        if not plane:
            raise ValueError("libheif: no interleaved plane")
        arr = np.ctypeslib.as_array(plane, shape=(ht, stride.value))
        rgba = arr[:, : w * 4].reshape(ht, w, 4)
        has_alpha = bool(h.heif_image_handle_has_alpha_channel(handle))
        return (rgba.copy() if has_alpha else rgba[:, :, :3].copy()), has_alpha
    finally:
        if img:
            h.heif_image_release(img)
        if handle:
            h.heif_image_handle_release(handle)
        h.heif_context_free(ctx)


def heif_size(buf: bytes) -> tuple:
    """(width, height, has_alpha) from the primary image handle — no pixel
    decode (the /info probe must stay cheap)."""
    if not heif_available():
        raise RuntimeError("libheif not available on this host")
    _setup_heif()
    h = _heif
    ctx = h.heif_context_alloc()
    handle = ctypes.c_void_p(None)
    try:
        e = h.heif_context_read_from_memory_without_copy(ctx, buf, len(buf), None)
        if e.code != 0:
            raise ValueError(f"libheif read: {e.message.decode() if e.message else e.code}")
        e = h.heif_context_get_primary_image_handle(ctx, ctypes.byref(handle))
        if e.code != 0:
            raise ValueError("libheif: no primary image")
        return (
            h.heif_image_handle_get_width(handle),
            h.heif_image_handle_get_height(handle),
            bool(h.heif_image_handle_has_alpha_channel(handle)),
        )
    finally:
        if handle:
            h.heif_image_handle_release(handle)
        h.heif_context_free(ctx)


_HEIF_COMPRESSION = {"hevc": 1, "av1": 4}
_HEIF_CHROMA_INTERLEAVED_RGB = 10
_heif_enc_ready = False


def _setup_heif_encode():
    global _heif_enc_ready
    if _heif_enc_ready:
        return
    h = _heif
    h.heif_context_get_encoder_for_format.restype = _HeifError
    h.heif_context_get_encoder_for_format.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
    ]
    h.heif_encoder_set_lossy_quality.restype = _HeifError
    h.heif_encoder_set_lossy_quality.argtypes = [ctypes.c_void_p, ctypes.c_int]
    h.heif_encoder_set_parameter_integer.restype = _HeifError
    h.heif_encoder_set_parameter_integer.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
    ]
    h.heif_encoder_set_parameter_string.restype = _HeifError
    h.heif_encoder_set_parameter_string.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p
    ]
    h.heif_image_create.restype = _HeifError
    h.heif_image_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    h.heif_image_add_plane.restype = _HeifError
    h.heif_image_add_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int
    ]
    h.heif_image_get_plane.restype = ctypes.POINTER(ctypes.c_ubyte)
    h.heif_image_get_plane.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    ]
    h.heif_context_encode_image.restype = _HeifError
    h.heif_context_encode_image.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    h.heif_context_write_to_file.restype = _HeifError
    h.heif_context_write_to_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    h.heif_encoder_release.argtypes = [ctypes.c_void_p]
    _heif_enc_ready = True


_heif_enc_probe: dict = {}


def heif_encode_available(fmt: str = "hevc") -> bool:
    """True when libheif carries an encoder plugin for the format — the
    reference CANNOT encode HEIF at all (its ImageType maps 'heif' to
    bimg.UNKNOWN and requests are rejected), so this whole path is an
    above-reference capability, gated like every optional loader.
    Probed once per format: constructing an x265 encoder instance just to
    check availability is too expensive for the per-request path."""
    if fmt in _heif_enc_probe:
        return _heif_enc_probe[fmt]
    ok = False
    if heif_available():
        _setup_heif()
        _setup_heif_encode()
        h = _heif
        ctx = h.heif_context_alloc()
        try:
            enc = ctypes.c_void_p(None)
            e = h.heif_context_get_encoder_for_format(
                ctx, _HEIF_COMPRESSION[fmt], ctypes.byref(enc)
            )
            if e.code == 0 and enc:
                h.heif_encoder_release(enc)
                ok = True
        finally:
            h.heif_context_free(ctx)
    _heif_enc_probe[fmt] = ok
    return ok


def encode_heif(arr: np.ndarray, quality: int = 80, fmt: str = "hevc",
                speed: int = 0) -> bytes:
    """HWC uint8 (C in 1/3/4) -> HEIF (hevc) or AVIF (av1) bytes.

    speed is the reference's Speed param (options.go:47 -> bimg -> vips
    heifsave effort): 0 leaves the encoder default; higher trades size/
    quality for encode time. AV1 (aom) takes an integer "speed" 0-9;
    HEVC (x265) maps to a "preset" name. Unsupported parameters are
    ignored — a foreign encoder plugin must not fail the request.

    Writes through a temp file: libheif's streaming writer callback
    returns a struct by value, which ctypes callbacks cannot express
    portably; the file detour costs one buffer copy."""
    if not heif_available():
        raise RuntimeError("libheif not available on this host")
    _setup_heif()
    _setup_heif_encode()
    h = _heif
    if arr.ndim != 3 or arr.dtype != np.uint8:
        raise ValueError("encode_heif wants HWC uint8")
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    has_alpha = arr.shape[2] == 4
    chroma = _HEIF_CHROMA_INTERLEAVED_RGBA if has_alpha else _HEIF_CHROMA_INTERLEAVED_RGB
    ht, w, c = arr.shape
    ctx = h.heif_context_alloc()
    enc = ctypes.c_void_p(None)
    img = ctypes.c_void_p(None)
    try:
        e = h.heif_context_get_encoder_for_format(
            ctx, _HEIF_COMPRESSION[fmt], ctypes.byref(enc)
        )
        if e.code != 0:
            raise ValueError(f"libheif: no {fmt} encoder")
        h.heif_encoder_set_lossy_quality(enc, max(1, min(int(quality), 100)))
        if speed > 0:
            s = min(int(speed), 9)
            if fmt == "av1":
                h.heif_encoder_set_parameter_integer(enc, b"speed", s)
            else:  # x265 understands presets, not a numeric speed; x265's
                # default is "medium", so the ladder starts there to keep
                # speed monotonic (speed=1 must never be SLOWER than 0)
                presets = [b"medium", b"fast", b"fast", b"faster", b"veryfast",
                           b"veryfast", b"superfast", b"superfast", b"ultrafast"]
                h.heif_encoder_set_parameter_string(enc, b"preset", presets[s - 1])
        e = h.heif_image_create(w, ht, _HEIF_COLORSPACE_RGB, chroma, ctypes.byref(img))
        if e.code != 0:
            raise ValueError("libheif: image_create failed")
        e = h.heif_image_add_plane(img, _HEIF_CHANNEL_INTERLEAVED, w, ht, 8)
        if e.code != 0:
            raise ValueError("libheif: add_plane failed")
        stride = ctypes.c_int(0)
        plane = h.heif_image_get_plane(img, _HEIF_CHANNEL_INTERLEAVED, ctypes.byref(stride))
        if not plane:
            raise ValueError("libheif: no plane")
        dst = np.ctypeslib.as_array(plane, shape=(ht, stride.value))
        src = np.ascontiguousarray(arr).reshape(ht, w * c)
        dst[:, : w * c] = src
        e = h.heif_context_encode_image(ctx, img, enc, None, None)
        if e.code != 0:
            raise ValueError(
                f"libheif encode: {e.message.decode() if e.message else e.code}"
            )
        import os
        import tempfile

        fd, path = tempfile.mkstemp(suffix=".heif")
        os.close(fd)
        try:
            e = h.heif_context_write_to_file(ctx, path.encode())
            if e.code != 0:
                raise ValueError("libheif: write failed")
            with open(path, "rb") as f:
                return f.read()
        finally:
            os.unlink(path)
    finally:
        if img:
            h.heif_image_release(img)
        if enc:
            h.heif_encoder_release(enc)
        h.heif_context_free(ctx)


# ---------------------------------------------------------------------------
# PDF via poppler-glib (present in the deploy image; gated elsewhere)
# ---------------------------------------------------------------------------

def pdf_available() -> bool:
    return _poppler is not None and _cairo is not None and _glib is not None


_poppler_ready = False


def _setup_poppler():
    """One-time prototype setup (pattern of _setup_cairo)."""
    global _poppler_ready
    if _poppler_ready:
        return
    p, g = _poppler, _glib
    g.g_bytes_new.restype = ctypes.c_void_p
    g.g_bytes_new.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    g.g_bytes_unref.argtypes = [ctypes.c_void_p]
    _gobject.g_object_unref.argtypes = [ctypes.c_void_p]
    p.poppler_document_new_from_bytes.restype = ctypes.c_void_p
    p.poppler_document_new_from_bytes.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p
    ]
    p.poppler_document_get_page.restype = ctypes.c_void_p
    p.poppler_document_get_page.argtypes = [ctypes.c_void_p, ctypes.c_int]
    p.poppler_page_get_size.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)
    ]
    p.poppler_page_render.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _poppler_ready = True


def _pdf_open_page(buf: bytes, page_index: int):
    """(gbytes, doc, page) with new references — caller must _pdf_close.
    poppler_document_new_from_bytes and poppler_document_get_page are both
    transfer-full; failing to unref them leaks the whole parsed document
    (and the pinned input buffer) per request."""
    p, g = _poppler, _glib
    gbytes = g.g_bytes_new(buf, len(buf))
    doc = p.poppler_document_new_from_bytes(gbytes, None, None)
    if not doc:
        g.g_bytes_unref(gbytes)
        raise ValueError("poppler could not parse PDF")
    page = p.poppler_document_get_page(doc, page_index)
    if not page:
        _gobject.g_object_unref(ctypes.c_void_p(doc))
        g.g_bytes_unref(gbytes)
        raise ValueError("PDF has no pages")
    return gbytes, doc, page


def _pdf_close(gbytes, doc, page):
    _gobject.g_object_unref(ctypes.c_void_p(page))
    _gobject.g_object_unref(ctypes.c_void_p(doc))
    _glib.g_bytes_unref(gbytes)


def rasterize_pdf(buf: bytes, dpi: float = 72.0, page_index: int = 0) -> np.ndarray:
    """First page of a PDF -> RGBA uint8 over white (libvips pdfload
    semantics: white page background, 72 dpi default)."""
    if not pdf_available():
        raise RuntimeError("poppler-glib not available on this host")
    _setup_poppler()
    p = _poppler
    with _lock:
        gbytes, doc, page = _pdf_open_page(buf, page_index)
        try:
            wpt = ctypes.c_double(0)
            hpt = ctypes.c_double(0)
            p.poppler_page_get_size(page, ctypes.byref(wpt), ctypes.byref(hpt))
            scale = dpi / 72.0
            w = max(1, min(int(round(wpt.value * scale)), _CAIRO_MAX_DIM))
            ht = max(1, min(int(round(hpt.value * scale)), _CAIRO_MAX_DIM))
            surface = _new_surface(w, ht)
            cr = _cairo.cairo_create(surface)
            try:
                _cairo.cairo_set_source_rgb(cr, 1.0, 1.0, 1.0)
                _cairo.cairo_paint(cr)
                _cairo.cairo_scale(cr, scale, scale)
                p.poppler_page_render(page, cr)
                rgba = _argb32_to_rgba(surface, w, ht)
                rgba[..., 3] = 255  # page composites over opaque white
                return rgba
            finally:
                _cairo.cairo_destroy(cr)
                _cairo.cairo_surface_destroy(surface)
        finally:
            _pdf_close(gbytes, doc, page)


def pdf_page_size(buf: bytes) -> Optional[tuple]:
    """(width_px, height_px) of page 1 at 72 dpi, via poppler when present,
    else a pure-Python MediaBox parse — so /info stays correct on hosts
    without poppler-glib."""
    if pdf_available():
        try:
            _setup_poppler()
            with _lock:
                gbytes, doc, page = _pdf_open_page(buf, 0)
                try:
                    w = ctypes.c_double(0)
                    h = ctypes.c_double(0)
                    _poppler.poppler_page_get_size(page, ctypes.byref(w), ctypes.byref(h))
                    return int(round(w.value)), int(round(h.value))
                finally:
                    _pdf_close(gbytes, doc, page)
        # itpu: allow[ITPU004] poppler page-size probe is best-effort; the MediaBox regex below is the fallback
        except Exception:
            pass
    m = re.search(
        rb"/MediaBox\s*\[\s*([\d.+-]+)\s+([\d.+-]+)\s+([\d.+-]+)\s+([\d.+-]+)\s*\]",
        buf[:65536] or b"",
    )
    if not m:
        m = re.search(
            rb"/MediaBox\s*\[\s*([\d.+-]+)\s+([\d.+-]+)\s+([\d.+-]+)\s+([\d.+-]+)\s*\]",
            buf,
        )
    if m:
        x0, y0, x1, y1 = (float(v) for v in m.groups())
        return int(round(abs(x1 - x0))), int(round(abs(y1 - y0)))
    return None
