"""Pillow's part in the port's codec layer: /info's header metadata, the
hot path's header probe where the native parser refuses a file, and
AVIF's first encode rung.

The port's copy of the parts of `imaginary_tpu/codecs/pil_backend.py`
that the reference's native backend still uses: its probe (native_backend.py:
136-149) and the AVIF rung of its encode ladder. Every raster decode and
encode is native (`native_backend`). Nothing here loads pixels.
"""

from __future__ import annotations

import io
import struct

import numpy as np
from PIL import Image, ImageFile

from imaginary_tpu_torch.codecs import CodecError, EncodeOptions, ImageMetadata
from imaginary_tpu_torch.imgtype import ImageType

# Tolerate slightly-truncated files the way libvips' sequential access does.
ImageFile.LOAD_TRUNCATED_IMAGES = True

_MODE_SPACE = {
    "RGB": "srgb",
    "RGBA": "srgb",
    "L": "b-w",
    "LA": "b-w",
    "1": "b-w",
    "P": "srgb",
    "CMYK": "cmyk",
    "YCbCr": "srgb",
    "I": "b-w",
    "F": "b-w",
}


def _has_alpha(im: Image.Image) -> bool:
    return im.mode in ("RGBA", "LA", "PA") or (im.mode == "P" and "transparency" in im.info)


def encode_avif(arr: np.ndarray, opts: EncodeOptions) -> bytes:
    """AVIF through Pillow's plugin where Pillow has one; else this 400
    sends the ladder on to libheif (codecs._encode_avif). speed 0 leaves
    the encoder default, as the reference's does."""
    im = Image.fromarray(arr[:, :, 0], mode="L") if arr.shape[2] == 1 else Image.fromarray(arr)
    out = io.BytesIO()
    try:
        im.save(out, "AVIF", quality=opts.effective_quality(),
                speed=max(1, min(opts.speed, 10)) if opts.speed else 6)
    except Exception as e:
        raise CodecError(f"Cannot encode image: {e}", 400) from None
    return out.getvalue()


def _declared_dims(buf: bytes, t: ImageType):
    """(width, height) a PNG's IHDR or a GIF's logical screen declares,
    or None: what a header-only probe reads where Pillow refuses to open
    the image (its own bomb limit, or a stream with no frame)."""
    if t is ImageType.PNG and len(buf) >= 24 and buf[12:16] == b"IHDR":
        return struct.unpack(">II", buf[16:24])
    if t is ImageType.GIF and len(buf) >= 10:
        return struct.unpack("<HH", buf[6:10])
    return None


def probe(buf: bytes, t: ImageType) -> ImageMetadata:
    """Dims, alpha and orientation from the header: Image.open parses
    metadata lazily and nothing here loads pixels. A PNG or GIF that
    Pillow will not open still reports the dims its header declares, as
    the reference's header probe does (a decompression bomb is then
    refused by the resolution guard, not by a decode error)."""
    try:
        im = Image.open(io.BytesIO(buf))
    except Exception as e:
        dims = _declared_dims(buf, t)
        if dims is None:
            raise CodecError(f"Cannot retrieve image metadata: {e}", 400) from None
        return ImageMetadata(width=dims[0], height=dims[1], type=t.value, space="srgb",
                             has_alpha=False, has_profile=False, channels=3,
                             orientation=0)
    has_alpha = _has_alpha(im)
    return ImageMetadata(
        width=im.width,
        height=im.height,
        type=t.value,
        space=_MODE_SPACE.get(im.mode, "srgb"),
        has_alpha=has_alpha,
        has_profile="icc_profile" in im.info,
        # the decoded channel count (decode gives RGB or RGBA), as the
        # reference's native header probe reports it
        channels=4 if has_alpha else 3,
        orientation=_orientation(im),
    )


def metadata(buf: bytes, t: ImageType) -> ImageMetadata:
    """/info's metadata from the header (ref: pil_backend.probe): the
    band count as Pillow opens the image, a palette counting as the RGB(A)
    it decodes to."""
    try:
        im = Image.open(io.BytesIO(buf))
    except Exception as e:
        raise CodecError(f"Cannot decode image: {e}", 400) from None
    has_alpha = _has_alpha(im)
    channels = len(im.getbands())
    if im.mode == "P":
        channels = 4 if has_alpha else 3
    return ImageMetadata(
        width=im.width,
        height=im.height,
        type=t.value if t is not ImageType.UNKNOWN else (im.format or "unknown").lower(),
        space=_MODE_SPACE.get(im.mode, "srgb"),
        has_alpha=has_alpha,
        has_profile="icc_profile" in im.info,
        channels=channels,
        orientation=_orientation(im),
    )


def _orientation(im: Image.Image) -> int:
    try:
        val = im.getexif().get(274, 0)  # 274 = Orientation
    except Exception:
        return 0
    return int(val) if isinstance(val, int) and 0 <= val <= 8 else 0
