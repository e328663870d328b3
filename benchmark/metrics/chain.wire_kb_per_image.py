"""KiB the chain staged across the host-device link (both ways) per image
launched, over the window."""


def read(w):
    items = w.delta("imaginary_tpu_executor_items")
    if items <= 0:
        return None
    moved = sum(w.delta("imaginary_tpu_wire_bytes_total", direction=d) for d in ("h2d", "d2h"))
    return moved / items / 1024.0
