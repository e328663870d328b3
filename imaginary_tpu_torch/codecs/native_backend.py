"""Native JPEG codec backend of the port (JPEG only: `codecs._backend`
routes every other format elsewhere).

Wraps the `_itpu_torch_codecs` extension (`imaginary_tpu_torch/native/
codecs.cpp`, libjpeg, all codec work with the GIL released). The extension
is built with g++ at first use into `imaginary_tpu_torch/_build/` and
loaded from there; a failed build raises, there is no other decoder.
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


def extension():
    """The loaded extension module, built on first call."""
    global _EXT
    if _EXT is None:
        with _LOCK:
            if _EXT is None:
                from imaginary_tpu_torch.native import build

                path, _, _ = build.build()
                name = build.MODULE
                loader = importlib.machinery.ExtensionFileLoader(name, path)
                spec = importlib.util.spec_from_file_location(name, path, loader=loader)
                mod = importlib.util.module_from_spec(spec)
                loader.exec_module(mod)
                _EXT = mod
    return _EXT


def decode(buf: bytes, t: ImageType, shrink: int = 1) -> DecodedImage:
    denom = shrink if shrink in (2, 4, 8) else 1
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
                                  opts.effective_quality(),
                                  1 if opts.interlace else 0)
    except ValueError as e:
        raise CodecError(f"Cannot encode image: {e}", 400) from None


def probe_fast(buf: bytes, t: ImageType) -> ImageMetadata:
    """Dims/orientation/subsampling from the JPEG header alone."""
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
