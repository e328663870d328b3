"""Image format names, MIME mapping, and support matrix (the port's copy
of `imaginary_tpu/imgtype.py`).

Behavioral contract from the reference's type.go:8-60 and bimg's type
detection (SURVEY.md section 2.12): format names are lowercase, `jpg` aliases
`jpeg`, `image/svg+xml` maps to `svg`, a bare `xml` subtype is treated as
`svg`, and unknown output types render as `image/jpeg`.
"""

from __future__ import annotations

import enum


class ImageType(enum.Enum):
    """Supported image formats (ref: bimg ImageType enum, type.go:25-44)."""

    UNKNOWN = "unknown"
    JPEG = "jpeg"
    PNG = "png"
    WEBP = "webp"
    TIFF = "tiff"
    GIF = "gif"
    SVG = "svg"
    PDF = "pdf"
    HEIF = "heif"
    AVIF = "avif"


# Formats the pixel backend can decode into tensors.
DECODABLE = {ImageType.JPEG, ImageType.PNG, ImageType.WEBP, ImageType.TIFF, ImageType.GIF}
# Formats the pixel backend can encode from tensors.
ENCODABLE = {ImageType.JPEG, ImageType.PNG, ImageType.WEBP, ImageType.TIFF, ImageType.GIF}

_NAME_TO_TYPE = {
    "jpeg": ImageType.JPEG,
    "jpg": ImageType.JPEG,
    "png": ImageType.PNG,
    "webp": ImageType.WEBP,
    "tiff": ImageType.TIFF,
    "gif": ImageType.GIF,
    "svg": ImageType.SVG,
    "pdf": ImageType.PDF,
    # heif/avif accepted for the encode-fallback contract (image.go:99-103)
    "heif": ImageType.HEIF,
    "avif": ImageType.AVIF,
}

_TYPE_TO_MIME = {
    ImageType.PNG: "image/png",
    ImageType.WEBP: "image/webp",
    ImageType.TIFF: "image/tiff",
    ImageType.GIF: "image/gif",
    ImageType.SVG: "image/svg+xml",
    ImageType.PDF: "application/pdf",
    ImageType.HEIF: "image/heif",
    ImageType.AVIF: "image/avif",
}


def image_type(name: str) -> ImageType:
    """Map a format name to an ImageType (ref: type.go:25-44).

    Unknown names (including heif/avif-less builds in the reference) map to
    UNKNOWN; the reference maps heif/avif to UNKNOWN here but we accept them
    because the encode fallback needs to recognize them.
    """
    return _NAME_TO_TYPE.get(name.strip().lower(), ImageType.UNKNOWN)


def extract_image_type_from_mime(mime: str) -> str:
    """`image/svg+xml; charset=utf-8` -> `svg` (ref: type.go:8-15)."""
    parts = mime.split(";", 1)[0]
    sub = parts.split("/", 1)
    if len(sub) < 2:
        return ""
    return sub[1].split("+", 1)[0].lower()


def is_image_mime_type_supported(mime: str) -> bool:
    """ref: type.go:17-23 (`xml` is treated as `svg`)."""
    fmt = extract_image_type_from_mime(mime)
    if fmt == "xml":
        fmt = "svg"
    return is_type_name_supported(fmt)


def is_type_name_supported(name: str) -> bool:
    """Whether the format name is known to the backend (ref: bimg.IsTypeNameSupported)."""
    t = image_type(name)
    return t is not ImageType.UNKNOWN and t in (DECODABLE | ENCODABLE | {ImageType.SVG, ImageType.PDF})


def get_image_mime_type(t: ImageType) -> str:
    """Format -> MIME; unknown renders as image/jpeg (ref: type.go:46-60)."""
    return _TYPE_TO_MIME.get(t, "image/jpeg")


# --- content sniffing (role of bimg.DetermineImageType) -----------------------

_MAGIC = [
    (b"\xff\xd8\xff", ImageType.JPEG),
    (b"\x89PNG\r\n\x1a\n", ImageType.PNG),
    (b"GIF87a", ImageType.GIF),
    (b"GIF89a", ImageType.GIF),
    (b"II*\x00", ImageType.TIFF),
    (b"MM\x00*", ImageType.TIFF),
    (b"%PDF-", ImageType.PDF),
]


def determine_image_type(buf: bytes) -> ImageType:
    """Sniff format from magic bytes (role of bimg.DetermineImageType).

    WEBP is RIFF....WEBP; HEIF/AVIF are ISO-BMFF `ftyp` brands; SVG is
    sniffed by looking for an `<svg` tag in the head of the buffer.
    """
    if not buf:
        return ImageType.UNKNOWN
    for magic, t in _MAGIC:
        if buf.startswith(magic):
            return t
    if len(buf) >= 12 and buf[:4] == b"RIFF" and buf[8:12] == b"WEBP":
        return ImageType.WEBP
    if len(buf) >= 12 and buf[4:8] == b"ftyp":
        brand = buf[8:12]
        if brand in (b"avif", b"avis"):
            return ImageType.AVIF
        if brand in (b"heic", b"heix", b"hevc", b"hevx", b"mif1", b"msf1"):
            return ImageType.HEIF
    head = buf[:1024].lstrip()
    if head.startswith(b"<?xml") or head.startswith(b"<svg") or b"<svg" in buf[:4096]:
        return ImageType.SVG
    return ImageType.UNKNOWN

