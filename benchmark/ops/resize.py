"""/resize?width=&height= on a JPEG: bimg's embed path. The frame is
fitted inside width x height, then centred on that canvas with its edges
copied outward; the JPEG is decoded at the largest shrink that keeps the
output."""

from __future__ import annotations

from benchmark import refcore, yardstick


def _dims(query: dict) -> tuple:
    return int(query.get("width", 0) or 0), int(query.get("height", 0) or 0)


def geometry(query: dict, src_h: int, src_w: int) -> dict:
    width, height = _dims(query)

    def resized(h, w):
        return refcore.embed_size(h, w, width, height)

    def out(h, w):
        rh, rw = resized(h, w)
        return (height or rh, width or rw)

    shrink = refcore.shrink_on_load(src_h, src_w, out, resized)
    dh, dw = -(-src_h // shrink), -(-src_w // shrink)
    return {"shrink": shrink, "decoded": (dh, dw), "resized": resized(dh, dw),
            "out": out(dh, dw)}


def reference(query: dict, body: bytes, dtype=refcore.REF) -> tuple:
    """(the answer's format, the float frame it encodes)."""
    src_w, src_h = refcore.image_size(body)
    g = geometry(query, src_h, src_w)
    img = refcore.decode_jpeg(body, g["shrink"], dtype)
    img = refcore.resample(img, *g["resized"])
    img = refcore.embed_copy(img, *g["out"])
    return "jpeg", img


def work(query: dict, geometry: dict) -> tuple:
    """(bytes, operations) the request's chain needs on the card."""
    return yardstick.jpeg_chain_work(geometry)
