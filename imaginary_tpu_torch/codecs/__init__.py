"""Host codec layer of the port: bytes <-> HWC uint8 arrays and packed
YUV 4:2:0 planes, plus the JPEG metadata carry.

The port's own copy of the parts of `imaginary_tpu/codecs` that its
slices use. The backend is chosen by format, never by failure: JPEG, PNG,
WEBP, GIF and TIFF go to the native extension (`native_backend`: libjpeg,
libpng, libwebp, libtiff and an in-tree GIF codec, also the packed-YUV
transport), as the reference's native build takes them; a native error
never retries in Pillow, which reads only /info's header metadata and
writes AVIF's first rung (`pil_backend`). SVG, PDF, HEIF and AVIF go to the
host's loaders (`vector_backend`: librsvg, poppler-glib, libheif) by the
reference's routes, with only the reference's own second rungs (PDF:
`pdf_mini` after poppler; AVIF: libheif after Pillow's plugin); a format
whose loader is absent answers the reference's 406, a PDF or SVG target
its 400. Decoding is RAW: EXIF rotation is *not* applied here —
orientation is reported and the planner decides.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Optional

import numpy as np

from imaginary_tpu_torch.errors import ImageError
from imaginary_tpu_torch.imgtype import ImageType, determine_image_type


class CodecError(ImageError):
    def __init__(self, message: str, code: int = 400):
        super().__init__(message, code)


@dataclasses.dataclass
class DecodedImage:
    """A decoded frame plus the source facts the pipeline needs."""

    array: np.ndarray  # HWC uint8, C in {3, 4}
    type: ImageType
    orientation: int  # EXIF orientation 0..8 (0 = absent)
    has_alpha: bool


@dataclasses.dataclass
class ImageMetadata:
    """The `/info` contract (ref: image.go:41-50, ImageInfo JSON).

    subsampling is an internal extra (not part of the /info JSON): the JPEG
    chroma layout ("420"/"422"/"444"/"gray", "" when unknown/not JPEG), used
    to gate the packed-YUV420 device transport.
    """

    width: int
    height: int
    type: str
    space: str
    has_alpha: bool
    has_profile: bool
    channels: int
    orientation: int
    subsampling: str = ""

    def to_dict(self) -> dict:
        """The /info JSON (subsampling stays internal)."""
        return {
            "width": self.width,
            "height": self.height,
            "type": self.type,
            "space": self.space,
            "hasAlpha": self.has_alpha,
            "hasProfile": self.has_profile,
            "channels": self.channels,
            "orientation": self.orientation,
        }


@dataclasses.dataclass
class EncodeOptions:
    """Encode-side knobs (subset of bimg.Options consumed by save paths)."""

    type: ImageType = ImageType.JPEG
    quality: int = 0  # 0 -> default 80 (README.md:571)
    compression: int = 0  # PNG zlib level, 0 -> default 6
    interlace: bool = False  # progressive JPEG / interlaced PNG
    palette: bool = False  # PNG8
    speed: int = 0  # encoder effort: HEIF/AVIF speed, PNG filter strategy
    strip_metadata: bool = False

    def effective_quality(self) -> int:
        q = self.quality if self.quality > 0 else 80
        return max(1, min(q, 100))

    def effective_compression(self) -> int:
        c = self.compression if self.compression > 0 else 6
        return max(0, min(c, 9))


@dataclasses.dataclass
class YuvPlanes:
    """Raw 4:2:0 planes: Y is (h, w) uint8, U/V are (ceil(h/2), ceil(w/2)).

    The packed-transport output format: the device returns these instead of
    RGB for JPEG-in/JPEG-out requests, and encode_yuv() writes them through
    libjpeg's raw-data path with zero host color math.
    """

    y: np.ndarray
    u: np.ndarray
    v: np.ndarray


def unpack_planes(packed: np.ndarray, h: int, w: int, hb: int, wb: int) -> YuvPlanes:
    """Slice Y/U/V out of the packed transport layout (the ONE definition
    of the layout's geometry on the Python side; the C++ packer in
    native/codecs.cpp mirrors it): Y in rows [0, hb), chroma block below
    with U in columns [0, wb/2) and V in [wb/2, wb)."""
    ch, cw = (h + 1) // 2, (w + 1) // 2
    a = packed[..., 0] if packed.ndim == 3 else packed
    return YuvPlanes(
        y=np.ascontiguousarray(a[:h, :w]),
        u=np.ascontiguousarray(a[hb : hb + ch, :cw]),
        v=np.ascontiguousarray(a[hb : hb + ch, wb // 2 : wb // 2 + cw]),
    )


def yuv_planes_to_rgb(p: YuvPlanes) -> np.ndarray:
    """BT.601 full-range planes -> HWC uint8 RGB (nearest chroma upsample):
    the pixels of planes whose raw JPEG encode failed (ref:
    codecs/__init__.py:135-148)."""
    h, w = p.y.shape
    yf = p.y.astype(np.float32)
    u = p.u.astype(np.float32).repeat(2, 0)[:h].repeat(2, 1)[:, :w] - 128.0
    v = p.v.astype(np.float32).repeat(2, 0)[:h].repeat(2, 1)[:, :w] - 128.0
    r = yf + 1.402 * v
    g = yf - 0.344136 * u - 0.714136 * v
    b = yf + 1.772 * u
    return np.clip(np.stack([r, g, b], axis=-1) + 0.5, 0, 255).astype(np.uint8)


# --- JPEG metadata carry-through (ref: options.go:139 StripMetadata) ---------
#
# libvips preserves EXIF/ICC unless StripMetadata is set, and the reference
# defaults stripmeta to false. Our encoders write clean JPEGs, so metadata
# preservation is a byte-level splice: lift the source's APP1(Exif)/APP2(ICC)
# segments and re-insert them into the encoded output. Orientation is reset
# to 1 when the pipeline applied the EXIF rotation (otherwise viewers would
# rotate twice) — the same normalization libvips autorotate performs.


def jpeg_metadata_segments(buf: bytes) -> list:
    """Raw APP1(Exif) + APP2(ICC_PROFILE) segments of a JPEG, marker included."""
    segs: list = []
    if len(buf) < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        return segs
    i = 2
    while i + 4 <= len(buf):
        if buf[i] != 0xFF:
            break
        # ISO 10918-1 B.1.1.2: any number of 0xFF fill bytes may precede a
        # marker — skip them or the length read lands on the marker byte
        while i + 4 <= len(buf) and buf[i + 1] == 0xFF:
            i += 1
        if i + 4 > len(buf):
            break
        marker = buf[i + 1]
        if marker == 0xD8 or 0xD0 <= marker <= 0xD9:
            i += 2
            continue
        seglen = (buf[i + 2] << 8) | buf[i + 3]
        if seglen < 2 or i + 2 + seglen > len(buf):
            break
        if marker == 0xE1 and buf[i + 4 : i + 10] == b"Exif\x00\x00":
            segs.append(bytes(buf[i : i + 2 + seglen]))
        elif marker == 0xE2 and buf[i + 4 : i + 16] == b"ICC_PROFILE\x00":
            segs.append(bytes(buf[i : i + 2 + seglen]))
        if marker == 0xDA:
            break
        i += 2 + seglen
    return segs


def patch_exif_segment(seg: bytes, orientation: Optional[int] = None,
                       pixel_w: Optional[int] = None,
                       pixel_h: Optional[int] = None) -> bytes:
    """Rewrite in-place EXIF tags so carried metadata describes the OUTPUT:
    IFD0 Orientation (0x0112), and the Exif sub-IFD's PixelXDimension
    (0xA002) / PixelYDimension (0xA003) — libvips re-syncs the same fields
    on save. None leaves a field untouched; missing tags are skipped."""
    # segment: FF E1 len 'Exif\0\0' TIFF...
    t = 10  # TIFF header offset within the segment
    if len(seg) < t + 8:
        return seg
    le = seg[t : t + 2] == b"II"
    if not le and seg[t : t + 2] != b"MM":
        return seg
    endian = "little" if le else "big"

    def rd16(o):
        return int.from_bytes(seg[o : o + 2], endian)

    def rd32(o):
        return int.from_bytes(seg[o : o + 4], endian)

    out = bytearray(seg)

    def write_value(off, value):
        # entry: tag(2) type(2) count(4) value(4); SHORT(3) and LONG(4)
        # values of count 1 sit left-justified in the value field
        typ = rd16(off + 2)
        if typ == 3:
            out[off + 8 : off + 10] = value.to_bytes(2, endian)
        elif typ == 4:
            out[off + 8 : off + 12] = value.to_bytes(4, endian)

    def walk(ifd, wanted):
        """Patch wanted tags in one IFD; returns the Exif sub-IFD offset."""
        sub = None
        if ifd + 2 > len(seg):
            return None
        n = rd16(ifd)
        for e in range(n):
            off = ifd + 2 + 12 * e
            if off + 12 > len(seg):
                return sub
            tag = rd16(off)
            if tag in wanted and wanted[tag] is not None:
                write_value(off, wanted[tag])
            if tag == 0x8769:  # ExifIFD pointer
                sub = t + rd32(off + 8)
        return sub

    sub_ifd = walk(t + rd32(t + 4), {0x0112: orientation})
    if sub_ifd is not None and (pixel_w is not None or pixel_h is not None):
        walk(sub_ifd, {0xA002: pixel_w, 0xA003: pixel_h})
    return bytes(out)


def insert_jpeg_segments(jpeg: bytes, segs: list) -> bytes:
    """Splice metadata segments into a JPEG after SOI (and any APP0/JFIF)."""
    if not segs or len(jpeg) < 4 or jpeg[0] != 0xFF or jpeg[1] != 0xD8:
        return jpeg
    i = 2
    while i + 4 <= len(jpeg) and jpeg[i] == 0xFF and jpeg[i + 1] == 0xE0:
        i += 2 + ((jpeg[i + 2] << 8) | jpeg[i + 3])
    return jpeg[:i] + b"".join(segs) + jpeg[i:]


# The codec route of each format the port decodes and encodes.
ROUTES = {
    ImageType.JPEG: "native",
    ImageType.PNG: "native",
    ImageType.WEBP: "native",
    ImageType.GIF: "native",
    ImageType.TIFF: "native",
}


def routes() -> dict:
    """{format name: backend name}, as /health reports it."""
    return {t.value: r for t, r in ROUTES.items()}


# Formats the host's loaders serve (vector_backend): never a raster backend
SPECIAL_TYPES = frozenset({ImageType.SVG, ImageType.PDF, ImageType.HEIF, ImageType.AVIF})


def _native():
    from imaginary_tpu_torch.codecs import native_backend

    return native_backend


# Formats that no backend of the reference can write (native_backend.py:117-122)
NEVER_ENCODED = (ImageType.PDF, ImageType.SVG)


def _backend(t: ImageType, what: str):
    """The raster backend of format t; PDF and SVG targets answer the
    reference's 400, a format no backend knows 501."""
    if ROUTES.get(t) == "native":
        return _native()
    if what == "encoding" and t in NEVER_ENCODED:
        raise CodecError(f"Cannot encode image: unsupported format {t.value}", 400)
    raise CodecError(f"{what} {t.value} is not ported to the PyTorch/CUDA package yet", 501)


# Pre-decode dimension gate, in megapixels (0 = disarmed), per context.
_DECODE_PIXEL_CAP: contextvars.ContextVar = contextvars.ContextVar(
    "itpu_torch_decode_pixel_cap", default=0.0)


def set_decode_pixel_cap(mpix: float):
    """Arm the pre-decode dimension gate for the current context, in
    megapixels (0 disarms). Returns the Token for callers that restore."""
    return _DECODE_PIXEL_CAP.set(max(0.0, float(mpix)))


def _bomb_gate(buf: bytes, t: ImageType) -> None:
    """Reject a decode whose DECLARED dimensions exceed the armed cap,
    before any frame is allocated (413: the payload demands more memory
    than this server will commit). The `codec.bomb` failpoint rejects
    the decode the same way."""
    from imaginary_tpu_torch import failpoints

    try:
        failpoints.hit("codec.bomb")
    except Exception as e:  # noqa: BLE001 - any injected fault is the 413
        raise CodecError(f"image rejected by decode bomb guard: {e}", 413) from None
    bomb_gate_prefix(buf)


def bomb_gate_prefix(buf) -> None:
    """The dimension check alone, on a whole body or a streamed body's
    header prefix (the reference's codecs.bomb_gate_prefix): web/sources.py
    runs it as soon as the first 64 KB land, so an over-cap upload is
    refused 413 while its body is still on the wire. A no-op while the cap
    is disarmed or the header does not parse (the decoder then raises the
    user-facing error)."""
    cap = _DECODE_PIXEL_CAP.get()
    if cap <= 0.0:
        return
    try:
        m = probe_fast(buf if isinstance(buf, bytes) else bytes(buf))
    except ImageError:
        return
    if m.width * m.height / 1_000_000.0 > cap:
        raise CodecError(
            f"image dimensions {m.width}x{m.height} exceed the "
            f"{cap:g} megapixel decode limit", 413)


def yuv420_supported() -> bool:
    """True once the native extension (with the packed-YUV420 entry points)
    is built and loaded; a failed build raises instead of answering False."""
    return _native().extension() is not None


def decode_yuv420(buf: bytes, shrink: int, hb: int, wb: int):
    """Packed-layout 4:2:0 decode; see native_backend.decode_yuv420."""
    return _native().decode_yuv420(buf, shrink, hb, wb)


def encode_yuv(planes: YuvPlanes, opts: EncodeOptions) -> bytes:
    """Encode raw planes as JPEG via the native raw-data path."""
    if opts.type is not ImageType.JPEG:
        raise CodecError("raw YUV planes can only encode to JPEG", 500)
    return _native().encode_yuv420(
        planes.y, planes.u, planes.v, opts.effective_quality(), opts.interlace)


def decode(buf: bytes, shrink: int = 1) -> DecodedImage:
    """Decode bytes into an HWC uint8 array (RGB, or RGBA where the source
    has alpha).

    shrink in {2, 4, 8} asks for 1/N-scale shrink-on-load (JPEG DCT
    scaling; result dims are ceil(dim/N)); other formats decode at full
    size."""
    if not buf:
        raise CodecError("Empty or unreadable image", 400)
    t = determine_image_type(buf)
    if t in SPECIAL_TYPES:
        _bomb_gate(buf, t)
        return _decode_special(buf, t, shrink)
    backend = _backend(t, "decoding")
    _bomb_gate(buf, t)
    return backend.decode(buf, t, shrink)


def _pil_open_rgba(buf: bytes) -> tuple:
    """(array, has_alpha) through Pillow: AVIF's first rung."""
    from io import BytesIO

    from PIL import Image

    with Image.open(BytesIO(buf)) as im:
        has_alpha = im.mode in ("RGBA", "LA", "PA")
        arr = np.asarray(im.convert("RGBA" if has_alpha else "RGB"))
    return arr, has_alpha


def _decode_special(buf: bytes, t: ImageType, shrink: int = 1) -> DecodedImage:
    """SVG, PDF, HEIF and AVIF through the host's loaders (the reference's
    `_decode_special`, codecs/__init__.py:425-481): SVG rendered straight
    into the 1/N box of shrink-on-load; PDF through poppler-glib, else the
    vendored `pdf_mini` (a document beyond its subset falls to the 406);
    AVIF through Pillow's plugin, else libheif; HEIF through libheif. A
    loader the host lacks answers 406, as a libvips built without it."""
    from imaginary_tpu_torch.codecs import vector_backend as vb

    try:
        if t is ImageType.SVG and vb.svg_available():
            arr = vb.rasterize_svg(buf, shrink=shrink)
            return DecodedImage(array=arr, type=t, orientation=0, has_alpha=True)
        if t is ImageType.PDF:
            if vb.pdf_available():
                arr = vb.rasterize_pdf(buf)
                return DecodedImage(array=arr, type=t, orientation=0, has_alpha=False)
            from imaginary_tpu_torch.codecs import pdf_mini

            try:
                arr = pdf_mini.rasterize(buf)
                return DecodedImage(array=arr, type=t, orientation=0, has_alpha=False)
            except pdf_mini.UnsupportedPdf:
                pass
        if t is ImageType.AVIF:
            try:
                arr, has_alpha = _pil_open_rgba(buf)
                return DecodedImage(array=arr, type=t, orientation=0, has_alpha=has_alpha)
            except Exception:  # noqa: BLE001 - libheif is the reference's second rung
                if vb.heif_available():
                    arr, has_alpha = vb.decode_heif(buf)
                    return DecodedImage(array=arr, type=t, orientation=0,
                                        has_alpha=has_alpha)
        if t is ImageType.HEIF and vb.heif_available():
            arr, has_alpha = vb.decode_heif(buf)
            return DecodedImage(array=arr, type=t, orientation=0, has_alpha=has_alpha)
    except CodecError:
        raise
    except Exception as e:
        raise CodecError(f"Error processing image: {e}", 400) from None
    raise CodecError(
        f"decoding {t.value} requires native loader support not present on this host", 406)


def encode(arr: np.ndarray, opts: EncodeOptions) -> bytes:
    """Encode an HWC uint8 array (JPEG flattens alpha onto black)."""
    if arr.ndim != 3 or arr.shape[2] not in (1, 3, 4):
        raise CodecError(f"cannot encode array of shape {arr.shape}", 500)
    if arr.dtype != np.uint8:
        raise CodecError(f"cannot encode dtype {arr.dtype}", 500)
    if opts.type is ImageType.HEIF:
        return _encode_heif(arr, opts)
    if opts.type is ImageType.AVIF:
        return _encode_avif(arr, opts)
    return _backend(opts.type, "encoding").encode(arr, opts)


def _encode_heif(arr: np.ndarray, opts: EncodeOptions) -> bytes:
    """HEIF through libheif's HEVC encoder (the reference's ladder,
    codecs/__init__.py:502-517); without one a 400, which the pipeline
    answers as JPEG (image.go:99-103)."""
    from imaginary_tpu_torch.codecs import vector_backend as vb

    if not vb.heif_encode_available("hevc"):
        raise CodecError("HEIF encoding requires a libheif HEVC encoder", 400)
    try:
        return vb.encode_heif(arr, opts.effective_quality(), "hevc", speed=opts.speed)
    except Exception as e:
        raise CodecError(f"Cannot encode image: {e}", 400) from None


def _encode_avif(arr: np.ndarray, opts: EncodeOptions) -> bytes:
    """AVIF through Pillow's plugin, else libheif's AV1 encoder (the
    reference's ladder, codecs/__init__.py:518-535)."""
    from imaginary_tpu_torch.codecs import pil_backend

    try:
        return pil_backend.encode_avif(arr, opts)
    except ImageError:
        from imaginary_tpu_torch.codecs import vector_backend as vb

        if not vb.heif_encode_available("av1"):
            raise
        try:
            return vb.encode_heif(arr, opts.effective_quality(), "av1", speed=opts.speed)
        except Exception as e:
            raise CodecError(f"Cannot encode image: {e}", 400) from None


def probe(buf: bytes) -> ImageMetadata:
    """The rich header metadata /info reports (colour space, ICC flag and
    the decoded channel count), from Pillow's header parse as the
    reference takes it (native_backend.py:137-149); an image Pillow cannot
    open falls back to the native header parser. Nothing loads pixels."""
    if not buf:
        raise CodecError("Cannot retrieve image metadata: empty buffer", 400)
    t = determine_image_type(buf)
    if t in SPECIAL_TYPES:
        return _probe_special(buf, t)
    _backend(t, "probing")  # a format no backend knows answers 501
    from imaginary_tpu_torch.codecs import pil_backend

    try:
        return pil_backend.metadata(buf, t)
    except CodecError:
        return _native().native_probe(buf, t)


def probe_fast(buf: bytes) -> ImageMetadata:
    """Dims/orientation (and JPEG subsampling) from the header, for the
    request hot path (shrink-on-load selection and the transport gate)."""
    if not buf:
        raise CodecError("Cannot retrieve image metadata: empty buffer", 400)
    t = determine_image_type(buf)
    if t in SPECIAL_TYPES:
        return _probe_special(buf, t)
    return _backend(t, "probing").probe_fast(buf, t)


def _pil_header(buf: bytes, t: ImageType) -> ImageMetadata:
    """A HEIF or AVIF header through Pillow, or Pillow's 400."""
    from io import BytesIO

    from PIL import Image

    try:
        with Image.open(BytesIO(buf)) as im:
            has_alpha = im.mode in ("RGBA", "LA", "PA")
            return ImageMetadata(im.width, im.height, t.value, "srgb", has_alpha, False,
                                 4 if has_alpha else 3, 0)
    except Exception as e:
        raise CodecError(f"Cannot decode image: {e}", 400) from None


def _probe_special(buf: bytes, t: ImageType) -> ImageMetadata:
    """Dimensions of SVG, PDF, HEIF and AVIF by the reference's
    `_probe_special` (codecs/__init__.py:560-600): librsvg's intrinsic
    size, poppler's page size or the MediaBox, Pillow's header, else
    libheif's handle. Where none answers, the reference falls to its
    raster backend's probe: 0x0 for SVG, else Pillow's header or its
    "Cannot decode image" 400."""
    from imaginary_tpu_torch.codecs import vector_backend as vb

    try:
        if t is ImageType.SVG and vb.svg_available():
            w, h = vb.svg_intrinsic_size(buf)
            return ImageMetadata(w, h, "svg", "srgb", True, False, 4, 0)
        if t is ImageType.PDF:
            size = vb.pdf_page_size(buf)
            if size:
                return ImageMetadata(size[0], size[1], "pdf", "srgb", False, False, 3, 0)
        if t in (ImageType.HEIF, ImageType.AVIF):
            try:
                return _pil_header(buf, t)
            except CodecError:
                if vb.heif_available():
                    w, h, has_alpha = vb.heif_size(buf)
                    return ImageMetadata(w, h, t.value, "srgb", has_alpha, False,
                                         4 if has_alpha else 3, 0)
    except Exception:  # itpu: allow[ITPU004] an unidentified header falls to the rule below
        pass
    if t is ImageType.SVG:
        return ImageMetadata(0, 0, "svg", "srgb", False, False, 3, 0)
    return _pil_header(buf, t)
