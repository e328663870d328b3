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
