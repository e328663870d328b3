"""Native raster codec backend of the port: JPEG, PNG, WEBP, GIF and TIFF.

Wraps the `_itpu_torch_codecs` extension (`imaginary_tpu_torch/native/
codecs.cpp`: libjpeg, libpng, libwebp, libtiff, an in-tree GIF codec and
the median-cut palette, all codec work with the GIL released), the port's
copy of the reference's `native_backend`. The extension is built with g++
at first use into `imaginary_tpu_torch/_build/` and loaded from there; a
failed build raises, there is no other decoder and no partial build.
Pillow appears only in the probes, as in the reference: its header parse
is /info's first choice, and the hot path's fallback where the native
header parser refuses a file.
"""

from __future__ import annotations

import importlib.machinery
import importlib.util
import threading

import numpy as np

from imaginary_tpu_torch.codecs import CodecError, DecodedImage, EncodeOptions, ImageMetadata
from imaginary_tpu_torch.imgtype import ImageType

NAME = "native"

_EXT = None
_LOCK = threading.Lock()
# the host resampler's module (native/resample.cpp): None = not yet
# loaded, False = its build failed here
_RESAMPLE = None
# the per-thread scratch-arena cap in MB (--arena-mb), applied to each
# module as it loads
_ARENA_CAP_MB = 0.0


def extension():
    """The loaded extension module, built on first call."""
    global _EXT
    if _EXT is None:
        with _LOCK:
            if _EXT is None:
                from imaginary_tpu_torch.native import build

                path, _, _ = build.build()
                mod = _load(build.MODULE, path)
                if _ARENA_CAP_MB:
                    mod.set_arena_cap(_ARENA_CAP_MB)
                _EXT = mod
    return _EXT


def _load(name: str, path: str):
    loader = importlib.machinery.ExtensionFileLoader(name, path)
    spec = importlib.util.spec_from_file_location(name, path, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def _resample_ext():
    """The host resampler module, built on first call; None where g++
    cannot build it (the host interpreter then takes its numpy taps)."""
    global _RESAMPLE
    if _RESAMPLE is None:
        with _LOCK:
            if _RESAMPLE is None:
                from imaginary_tpu_torch.native import build

                try:
                    path, _ = build.build_resample()
                    mod = _load(build.RESAMPLE_MODULE, path)
                except (RuntimeError, OSError, ImportError):
                    _RESAMPLE = False
                else:
                    if _ARENA_CAP_MB:
                        mod.set_arena_cap(_ARENA_CAP_MB)
                    _RESAMPLE = mod
    return _RESAMPLE or None


def arena_stats():
    """The scratch-arena counters (reuses, misses, evictions, bytes,
    cap_bytes) of the codec module (loaded here, as the reference's is at
    import) and, once it is loaded, the host resampler's, summed: each
    module keeps its own thread-local arenas. None when the codec module
    cannot be built."""
    try:
        mods = [extension()]
    except (RuntimeError, OSError, ImportError):
        return None
    if _RESAMPLE:
        mods.append(_RESAMPLE)
    out: dict = {}
    for mod in mods:
        for k, v in mod.arena_stats().items():
            out[k] = v if k == "cap_bytes" else out.get(k, 0) + v
    return out


def set_arena_cap(mb: float) -> bool:
    """Set the per-thread scratch-arena cap in MB (0 = unlimited) on every
    native module, now and as each loads. True once it is recorded."""
    global _ARENA_CAP_MB
    _ARENA_CAP_MB = max(0.0, float(mb))
    for mod in (_EXT, _RESAMPLE):
        if mod:
            mod.set_arena_cap(_ARENA_CAP_MB)
    return True


def resample_available() -> bool:
    """True when the host resampler module is built and loaded."""
    return _resample_ext() is not None


def resize_separable(arr: np.ndarray, dst_h: int, dst_w: int,
                     kernel: str) -> np.ndarray:
    """Separable precomputed-tap resize of an HWC uint8 array, GIL
    released (the reference's native_backend.resize_separable): the
    device sampling matrix's kernel semantics, per-axis stretch,
    edge-clamp renormalisation, round half up to uint8."""
    ext = _resample_ext()
    if ext is None:
        raise CodecError("native resampler not built", 500)
    h, w, c = arr.shape
    out = ext.resize_separable(np.ascontiguousarray(arr), h, w, c,
                               dst_h, dst_w, kernel)
    return np.frombuffer(out, dtype=np.uint8).reshape(dst_h, dst_w, c)


def linked() -> dict:
    """{library: route} of the loaded build (its `LINKED`), e.g.
    {"png": "system libpng16.so.16", ...} or a wheel library's path."""
    return dict(part.split(": ", 1) for part in extension().LINKED.split("; "))


def decode(buf: bytes, t: ImageType, shrink: int = 1) -> DecodedImage:
    """RGB or RGBA pixels; shrink in {2, 4, 8} is JPEG's DCT scaling, other
    formats decode at full size (libpng's simplified reader converts any
    bit depth, gamma and palette to 8-bit sRGB)."""
    denom = shrink if (t is ImageType.JPEG and shrink in (2, 4, 8)) else 1
    try:
        pixels, h, w, c, orientation, has_alpha = extension().decode(buf, t.value, denom)
    except ValueError as e:
        raise CodecError(f"Cannot decode image: {e}", 400) from None
    arr = np.frombuffer(pixels, dtype=np.uint8).reshape(h, w, c)
    return DecodedImage(array=arr, type=t, orientation=orientation, has_alpha=bool(has_alpha))


def encode(arr: np.ndarray, opts: EncodeOptions) -> bytes:
    arr = np.ascontiguousarray(arr)
    h, w, c = arr.shape
    try:
        return extension().encode(arr, h, w, c, opts.type.value,
                                  opts.effective_quality(), opts.effective_compression(),
                                  1 if opts.interlace else 0,
                                  1 if opts.palette else 0, max(0, opts.speed))
    except ValueError as e:
        raise CodecError(f"Cannot encode image: {e}", 400) from None


def probe_fast(buf: bytes, t: ImageType) -> ImageMetadata:
    """Dims/orientation (and JPEG subsampling) from the header alone, GIL
    released; Pillow's header probe where the native parser refuses the
    file (the reference's rule)."""
    try:
        return native_probe(buf, t)
    except CodecError:
        pass
    from imaginary_tpu_torch.codecs import pil_backend

    return pil_backend.probe(buf, t)


def native_probe(buf: bytes, t: ImageType) -> ImageMetadata:
    """The native header parser's answer, or its 400."""
    try:
        w, h, c, has_alpha, orientation, subsampling = extension().probe(buf, t.value)
    except ValueError as e:
        raise CodecError(f"Cannot retrieve image metadata: {e}", 400) from None
    return ImageMetadata(
        width=w, height=h, type=t.value, space="srgb",
        has_alpha=bool(has_alpha), has_profile=False,
        channels=c, orientation=orientation, subsampling=subsampling,
    )


def decode_yuv420(buf: bytes, shrink: int, hb: int, wb: int):
    """Decode a 4:2:0 JPEG straight into the packed transport layout.

    Returns (packed [hb + hb/2, wb, 1] uint8, h, w, orientation); raises
    CodecError when the source isn't plain 4:2:0 YCbCr (callers then take
    the RGB path)."""
    denom = shrink if shrink in (2, 4, 8) else 1
    try:
        packed, h, w, orientation = extension().decode_yuv420(buf, denom, hb, wb)
    except ValueError as e:
        raise CodecError(f"Cannot decode image: {e}", 400) from None
    arr = np.frombuffer(packed, dtype=np.uint8).reshape(hb + hb // 2, wb, 1)
    return arr, h, w, orientation


def encode_yuv420(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                  quality: int, progressive: bool) -> bytes:
    """Raw-plane JPEG encode (no host color conversion / subsampling)."""
    h, w = y.shape[:2]
    try:
        return extension().encode_yuv420(
            np.ascontiguousarray(y), np.ascontiguousarray(u),
            np.ascontiguousarray(v), h, w, quality, 1 if progressive else 0,
        )
    except ValueError as e:
        raise CodecError(f"Cannot encode image: {e}", 400) from None
