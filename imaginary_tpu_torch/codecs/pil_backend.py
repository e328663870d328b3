"""Pillow codec backend of the port: PNG, WEBP, GIF and TIFF, and AVIF's
first encode rung.

The port's copy of `imaginary_tpu/codecs/pil_backend.py`, trimmed to the
formats the port routes here (JPEG stays on the native codec; the
dispatch in `codecs/__init__.py` picks the backend by format, never by
failure). Decoding is RAW: EXIF orientation is reported, not applied.
"""

from __future__ import annotations

import io
import struct

import numpy as np
from PIL import Image, ImageFile

from imaginary_tpu_torch.codecs import CodecError, DecodedImage, EncodeOptions, ImageMetadata
from imaginary_tpu_torch.imgtype import ImageType

NAME = "pil"

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


# Pillow's 16- and 32-bit gray modes, whose `convert` clips to 255
_WIDE_GRAY = ("I;16", "I;16B", "I;16L", "I")


def _to_u8(samples: np.ndarray) -> np.ndarray:
    """16-bit samples -> uint8 by the reference's cv2 backend's rule
    (cv2_backend.py:69-70): v / 257 + 0.5, truncated. Within 1 LSB of
    libvips's 16 -> 8 shift."""
    return (np.clip(samples, 0, 65535).astype(np.float32) / 257.0 + 0.5).astype(np.uint8)


def _png16_rgb(buf: bytes) -> np.ndarray:
    """The samples of a 16-bit PNG as uint8 RGB or RGBA, scaled by `_to_u8`.
    Pillow keeps 16 bits only for gray (RGB, RGBA and gray + alpha come
    back as their high bytes), so these are read with cv2, as the
    reference's cv2 backend reads them."""
    import cv2

    arr = cv2.imdecode(np.frombuffer(buf, np.uint8),
                       cv2.IMREAD_UNCHANGED | cv2.IMREAD_IGNORE_ORIENTATION)
    if arr is None:
        raise CodecError("Cannot decode image: corrupt 16-bit PNG", 400)
    if arr.ndim == 2:
        arr = cv2.cvtColor(arr, cv2.COLOR_GRAY2RGB)
    else:
        arr = cv2.cvtColor(arr, cv2.COLOR_BGRA2RGBA if arr.shape[2] == 4 else cv2.COLOR_BGR2RGB)
    return np.ascontiguousarray(_to_u8(arr))


def decode(buf: bytes, t: ImageType, shrink: int = 1) -> DecodedImage:
    """Full-size decode to RGB, or RGBA where the source has alpha
    (shrink-on-load is a JPEG feature; other formats ignore it). 16-bit
    samples are scaled to 8 bits (`_to_u8`), never clipped."""
    try:
        im = Image.open(io.BytesIO(buf))
        if t is ImageType.PNG and buf[24:25] == b"\x10":  # IHDR bit depth 16
            arr = _png16_rgb(buf)
            return DecodedImage(array=arr, type=t, orientation=_orientation(im),
                                has_alpha=arr.shape[2] == 4)
        im.load()
    except CodecError:
        raise
    except Exception as e:
        raise CodecError(f"Cannot decode image: {e}", 400) from None
    orientation = _orientation(im)
    has_alpha = _has_alpha(im)
    if im.mode in _WIDE_GRAY:
        arr = np.repeat(_to_u8(np.asarray(im))[..., None], 3, axis=2)
        return DecodedImage(array=arr, type=t, orientation=orientation, has_alpha=False)
    target = "RGBA" if has_alpha else "RGB"
    if im.mode != target:
        im = im.convert(target)
    arr = np.asarray(im, dtype=np.uint8)
    return DecodedImage(array=arr, type=t, orientation=orientation, has_alpha=has_alpha)


def encode(arr: np.ndarray, opts: EncodeOptions) -> bytes:
    t = opts.type
    im = Image.fromarray(arr[:, :, 0], mode="L") if arr.shape[2] == 1 else Image.fromarray(arr)
    out = io.BytesIO()
    try:
        if t == ImageType.PNG:
            if opts.palette:
                im = im.convert("P", palette=Image.Palette.ADAPTIVE)
            im.save(out, "PNG", compress_level=opts.effective_compression())
        elif t == ImageType.WEBP:
            im.save(out, "WEBP", quality=opts.effective_quality())
        elif t == ImageType.TIFF:
            im.save(out, "TIFF")
        elif t == ImageType.GIF:
            _save_gif(im, arr, out)
        elif t == ImageType.AVIF:
            # Pillow's plugin where Pillow has one; else this 400 sends the
            # ladder on to libheif (codecs._encode_avif). speed 0 leaves the
            # encoder default, as the reference's does
            im.save(out, "AVIF", quality=opts.effective_quality(),
                    speed=max(1, min(opts.speed, 10)) if opts.speed else 6)
        else:
            raise CodecError(f"Unsupported output image format: {t.value}", 400)
    except CodecError:
        raise
    except Exception as e:
        raise CodecError(f"Cannot encode image: {e}", 400) from None
    return out.getvalue()


def _save_gif(im: Image.Image, arr: np.ndarray, out: io.BytesIO) -> None:
    """A GIF with Pillow's palette (the one `im.save(out, "GIF")` makes)
    and, when the frame has alpha, the reference's native rule for it
    (imaginary_tpu/native/codecs.cpp:1224-1241): every pixel with alpha
    below 128 takes one reserved, transparent index. The reserved index
    is a new palette entry, else an entry that no opaque pixel uses;
    opaque pixels keep their colour either way, but for a 256-colour
    palette that every opaque pixel index uses, where the rarest colour
    moves to its nearest other entry to free its index."""
    if arr.shape[2] != 4 or not (arr[:, :, 3] < 128).any():
        im.save(out, "GIF")
        return
    pim = im.convert("P", palette=Image.Palette.ADAPTIVE)
    idx = np.array(pim, dtype=np.uint8)
    pal = np.asarray(pim.getpalette("RGB") or [], dtype=np.int32).reshape(-1, 3)
    clear = arr[:, :, 3] < 128
    used = np.bincount(idx[~clear].ravel(), minlength=256)
    n = int(idx.max()) + 1
    if n < 256:
        tidx = n
    elif (used[:256] == 0).any():
        tidx = int(np.flatnonzero(used[:256] == 0)[0])
    else:
        tidx = int(np.argmin(used[:256]))
        d = ((pal[:256] - pal[tidx]) ** 2).sum(axis=1)
        d[tidx] = np.iinfo(np.int32).max
        idx[(idx == tidx) & ~clear] = int(np.argmin(d))
    pal = np.concatenate([pal, np.zeros((max(0, tidx + 1 - len(pal)), 3), np.int32)])
    pal[tidx] = 0
    idx[clear] = tidx
    gif = Image.fromarray(idx, mode="P")
    gif.putpalette(pal[:256].astype(np.uint8).ravel().tolist())
    gif.save(out, "GIF", transparency=tidx)


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
