"""Placeholder-image degradation (the port's copy of
`imaginary_tpu/web/placeholder.py`; ref: error.go:69-107, placeholder.go).

When enabled, errors return a placeholder image resized to the requested
dimensions, with the real error JSON in the `Error` response header and
the status from -placeholder-status (or the original error's). The
default placeholder is the reference's procedural 1200x1200 gray JPEG.
The resize runs as any request does: through the service's executor, on
its device (`ImageService.placeholder`).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
from aiohttp import web

from imaginary_tpu_torch import codecs
from imaginary_tpu_torch.codecs import EncodeOptions
from imaginary_tpu_torch.errors import ImageError
from imaginary_tpu_torch.imgtype import ImageType, get_image_mime_type, image_type
from imaginary_tpu_torch.params import parse_int
from imaginary_tpu_torch.web.config import ServerOptions


@functools.lru_cache(maxsize=1)
def default_placeholder() -> bytes:
    """1200x1200 neutral placeholder (role of placeholder.go:10-13)."""
    side = 1200
    yy, xx = np.mgrid[0:side, 0:side]
    base = (208 + 16 * np.cos(xx / 97.0) * np.cos(yy / 97.0)).astype(np.uint8)
    arr = np.stack([base, base, base], axis=-1)
    return codecs.encode(arr, EncodeOptions(type=ImageType.JPEG, quality=85))


def placeholder_response(request: web.Request, err: ImageError,
                         o: ServerOptions) -> Optional[web.Response]:
    """Build the placeholder reply; None falls back to the JSON error
    (mirrors replyWithPlaceholder's own error path, error.go:90-93)."""
    buf = o.placeholder_image or default_placeholder()
    try:
        width = parse_int(request.query.get("width", ""))
        height = parse_int(request.query.get("height", ""))
    except Exception:
        return None
    type_name = request.query.get("type", "")
    if type_name and image_type(type_name) is ImageType.UNKNOWN:
        type_name = ""
    try:
        if width or height:
            body, mime = request.app["service"].placeholder(
                buf, width or 0, height or 0, type_name)
        else:
            body, mime = buf, get_image_mime_type(ImageType.JPEG)
    except Exception:
        return None
    status = o.placeholder_status if o.placeholder_status else err.http_code()
    return web.Response(
        body=body,
        status=status,
        content_type=mime,
        headers={"Error": err.json_bytes().decode()},
    )
