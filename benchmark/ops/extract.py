"""/extract?top=&left=&areawidth=&areaheight= on a JPEG: the area cut out
of the frame decoded at full size (an absolute box allows no shrink)."""

from __future__ import annotations

from benchmark import refcore, yardstick


def geometry(query: dict, src_h: int, src_w: int) -> dict:
    top, left = int(query.get("top", 0) or 0), int(query.get("left", 0) or 0)
    eh, ew = int(query["areaheight"]), int(query["areawidth"])
    if top < 0 or left < 0 or top + eh > src_h or left + ew > src_w:
        raise ValueError("extract area outside the image")
    return {"shrink": 1, "decoded": (src_h, src_w), "resized": None,
            "box": (top, left, eh, ew), "out": (eh, ew)}


def reference(query: dict, body: bytes, dtype=refcore.REF) -> tuple:
    src_w, src_h = refcore.image_size(body)
    g = geometry(query, src_h, src_w)
    img = refcore.decode_jpeg(body, 1, dtype)
    top, left, eh, ew = g["box"]
    return "jpeg", img[top:top + eh, left:left + ew]


def work(query: dict, geometry: dict) -> tuple:
    """(bytes, operations) the request's chain needs on the card."""
    return yardstick.jpeg_chain_work(geometry)
