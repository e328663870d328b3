"""/crop?width=&height= on a JPEG: bimg's crop path, centre gravity. The
frame is scaled to cover width x height and the centre window cut out;
the JPEG is decoded at the largest shrink that keeps the output."""

from __future__ import annotations

from benchmark import refcore, yardstick


def geometry(query: dict, src_h: int, src_w: int) -> dict:
    width, height = int(query.get("width", 0) or 0), int(query.get("height", 0) or 0)

    def box(h, w):
        return refcore.crop_size(h, w, width, height)

    shrink = refcore.shrink_on_load(src_h, src_w, lambda h, w: box(h, w)[4:],
                                    lambda h, w: box(h, w)[:2])
    dh, dw = -(-src_h // shrink), -(-src_w // shrink)
    rh, rw, top, left, eh, ew = box(dh, dw)
    return {"shrink": shrink, "decoded": (dh, dw), "resized": (rh, rw),
            "box": (top, left, eh, ew), "out": (eh, ew)}


def reference(query: dict, body: bytes, dtype=refcore.REF) -> tuple:
    src_w, src_h = refcore.image_size(body)
    g = geometry(query, src_h, src_w)
    img = refcore.decode_jpeg(body, g["shrink"], dtype)
    img = refcore.resample(img, *g["resized"])
    top, left, eh, ew = g["box"]
    return "jpeg", img[top:top + eh, left:left + ew]


def work(query: dict, geometry: dict) -> tuple:
    """(bytes, operations) the request's chain needs on the card."""
    return yardstick.jpeg_chain_work(geometry)
