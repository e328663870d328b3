"""Shape-bucketing ladder (the port's copy of `imaginary_tpu/ops/buckets.py`).

Every image entering the device is padded to a bucket (H, W) from this
ladder. The rungs are the reference's, unchanged: plans (and so their
buckets) must compare one for one across the two packages.

The ladder is geometric-ish (ratio <= 1.25 through the common photo range)
so padding waste stays small — the host<->device link charges for every
padded byte in BOTH directions, so rung density through 256..2048 is worth
the extra compiled programs. Every rung is a multiple of 8 to line up with
TPU tiling (f32 sublane = 8), and even, so YUV420 chroma blocks split
cleanly.
"""

from __future__ import annotations

LADDER = (
    8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 320, 384, 448, 512,
    640, 768, 896, 1024, 1152, 1280, 1536, 1792, 2048, 2560, 3072,
    4096, 6144, 8192,
)

MAX_DIM = LADDER[-1]


def bucket_dim(n: int) -> int:
    """Smallest rung >= n."""
    if n <= 0:
        return LADDER[0]
    for rung in LADDER:
        if n <= rung:
            return rung
    raise ValueError(f"dimension {n} exceeds maximum supported {MAX_DIM}")


def bucket_shape(h: int, w: int) -> tuple:
    return bucket_dim(h), bucket_dim(w)


def dct_packed_geometry(src_h: int, src_w: int, shrink: int,
                        layout: str = "420") -> tuple:
    """Packed coefficient-plane geometry for the dct transport.

    Returns (k, h2, w2, hb, wb): k = 8/shrink kept coefficients per block
    axis, (h2, w2) = ceil(dim/shrink) valid pixel dims after the scaled
    IDCT, and (hb, wb) = the Y coefficient-plane bucket. The bucket covers
    BOTH the shrunk pixel dims and the full MCU-padded block grid — JPEG
    entropy-codes whole MCUs, so edge blocks past the valid dims still need
    packed slots. The Y block grid per MCU depends on the sampling layout:
    4:2:0 MCUs are 16x16 (2x2 Y blocks), 4:2:2 are 8x16 (1x2), and
    4:4:4/grayscale are 8x8 (1x1). Keeping 4:2:0's grid an even number of
    blocks is what lets its chroma coefficient planes split the
    [hb, hb + hb/2) rows exactly like yuv420; 4:2:2 stacks chroma in a
    second full-height band instead (see codecs/jpeg_dct.pack_dct).
    """
    if shrink not in (1, 2, 4, 8):
        raise ValueError(f"unsupported dct shrink {shrink}")
    k = 8 // shrink
    if layout == "420":
        mh, mw, by, bx = 16, 16, 2, 2
    elif layout == "422":
        mh, mw, by, bx = 8, 16, 1, 2
    elif layout in ("444", "gray"):
        mh, mw, by, bx = 8, 8, 1, 1
    else:
        raise ValueError(f"unsupported dct layout {layout!r}")
    mcu_y = -(-src_h // mh)
    mcu_x = -(-src_w // mw)
    h2 = -(-src_h // shrink)
    w2 = -(-src_w // shrink)
    hb, wb = bucket_shape(max(h2, by * mcu_y * k), max(w2, bx * mcu_x * k))
    return k, h2, w2, hb, wb


def tight_dim(n: int) -> int:
    """Snug bucket for *output* dims: device->host readback over the
    interconnect is the scarce resource (~fixed-cost + low bandwidth, see
    engine/executor.py), so final-stage buckets round up much tighter than
    the geometric input ladder — mult-of-16 under 512, coarser above, ladder
    beyond 2048 (which also bounds the number of distinct compiled programs).
    """
    if n <= 0:
        return 8
    if n <= 512:
        t = (n + 15) // 16 * 16
    elif n <= 1024:
        t = (n + 31) // 32 * 32
    elif n <= 2048:
        t = (n + 63) // 64 * 64
    else:
        t = bucket_dim(n)
    return min(t, bucket_dim(n))  # never exceed the ladder rung (8..24 rungs)
