"""The yardstick of card time: the published peaks of one H100 SXM and the
least time a request's chain could take on it.

`bound_ms`, `blur_flops` and `k10_work` are frozen copies of the
arithmetic `chip_smoke.py` used for PERF.md's kernel table (the copies
live here so that an edit of that script cannot move the benchmark).

A request's least card time counts its decoded frame read once and its
output frame written once, at their sample widths, and the operations its
stages need, from the request's own geometry as the reference works it
out (`benchmark/ops`); it is the larger of the bytes at HBM3's rate and
the operations at the f32 rate outside the tensor cores.
"""

from __future__ import annotations

import math

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
PEAK_POWER_W = 700.0  # the data sheet's rates assume this power limit


def bound_ms(nbytes: int, flops: float) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def k10_work(h: int, w: int, win_h: int, win_w: int, hb: int, wb: int, c0: int = 0,
             c1=None) -> tuple:
    """(bytes, operations) K10 needs for one image's candidates whose left
    lies in [c0, c1): the f32 integral image entries it reads once (rows
    [0, nr) and [win_h, win_h + nr) at the candidates' lefts and rights,
    nr = h - win_h + 1; column 0 is zeros and not read), its 8-byte
    answer, and 4 operations a candidate (3 subtractions, a compare)."""
    lim_t, lim_l = h - win_h, w - win_w
    nr = 0 if lim_t < 0 else min(lim_t, hb - 1) + 1
    ncols = 0 if lim_l < 0 else min(lim_l, wb - 1) + 1
    lefts = range(c0, min(ncols, wb if c1 is None else c1))
    if nr == 0 or not lefts:
        return 8, 0.0
    rows = len(set(range(nr)) | set(range(win_h, win_h + nr)))
    cols = set(lefts) | {min(lft + win_w, wb) for lft in lefts}
    cols.discard(0)
    return rows * len(cols) * 4 + 8, 4.0 * nr * len(lefts)


def blur_flops(h, w, r: int, c: int) -> float:
    """Flops that K6's function needs for these valid dims: per valid
    element 2 per vertical tap, 2 per horizontal tap and 2 for the
    normalisation by rowden[y] * colden[x]; per image one add per tap of
    each valid row's rowden and each valid column's colden. The tap loops
    are clipped to the valid region."""

    def taps(n):
        i = np.arange(n)
        return int((np.minimum(r, n - 1 - i) - np.maximum(-r, -i) + 1).sum())

    total = 0.0
    for hh, ww in zip(np.atleast_1d(h).tolist(), np.atleast_1d(w).tolist()):
        th, tw = taps(hh), taps(ww)
        total += c * (2.0 * ww * th + 2.0 * hh * tw + 2.0 * hh * ww) + th + tw
    return total


def resample_flops(in_h: int, in_w: int, out_h: int, out_w: int, c: int) -> float:
    """lanczos3 rows then columns: 2 flops a tap, 6 taps stretched by each
    axis's downscale factor."""
    ty = 6.0 * max(1.0, in_h / out_h)
    tx = 6.0 * max(1.0, in_w / out_w)
    return 2.0 * c * (ty * out_h * in_w + tx * out_h * out_w)


YCC_FLOPS = 15.0  # a pixel's BT.601 conversion each way: 9 multiply-adds, offsets, clamps


def jpeg_chain_work(geometry: dict) -> tuple:
    """(bytes, operations) of a JPEG request's chain: its decoded and its
    output 4:2:0 planes (1.5 bytes a pixel), the BT.601 conversion of each
    frame, and the resample where the route has one."""
    dh, dw = geometry["decoded"]
    oh, ow = geometry["out"]
    nbytes = int(math.ceil(dh * dw * 1.5) + math.ceil(oh * ow * 1.5))
    flops = YCC_FLOPS * (dh * dw + oh * ow)
    if geometry.get("resized"):
        flops += resample_flops(dh, dw, *geometry["resized"], 3)
    return nbytes, flops
