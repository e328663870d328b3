"""The JPEG encoder's arithmetic, as libjpeg does it by default: the
integer forward DCT `jpeg_fdct_islow` (jfdctint.c, 13-bit constants, two
passes) on samples less 128, then each coefficient divided by eight times
its quantisation step, rounded half away from zero (jcdctmgr.c). On the
same 8-bit samples this gives libjpeg's quantised coefficients exactly,
so an answer's coefficients can be held to it one for one.
"""

from __future__ import annotations

import numpy as np

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172

# ITU T.81 Annex K's tables, natural order, as jpeg_set_quality scales them
LUMA_BASE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]).reshape(8, 8)
CHROMA_BASE = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99]).reshape(8, 8)


def quality_tables(quality: int) -> tuple:
    """(luma, chroma) [8, 8] steps of jpeg_set_quality(quality, baseline)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((base * scale + 50) // 100, 1, 255) for base in (LUMA_BASE, CHROMA_BASE))


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One pass of jpeg_fdct_islow along the last axis of int64 d."""
    d0, d1, d2, d3, d4, d5, d6, d7 = (d[..., i] for i in range(8))
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    shift = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out[2] = _descale(z1 + tmp13 * FIX_0_765366865, shift)
    out[6] = _descale(z1 - tmp12 * FIX_1_847759065, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4, tmp5 = tmp4 * FIX_0_298631336, tmp5 * FIX_2_053119869
    tmp6, tmp7 = tmp6 * FIX_3_072711026, tmp7 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    out[7] = _descale(tmp4 + z1 + z3, shift)
    out[5] = _descale(tmp5 + z2 + z4, shift)
    out[3] = _descale(tmp6 + z2 + z3, shift)
    out[1] = _descale(tmp7 + z1 + z4, shift)
    return np.stack(out, axis=-1)


def blocks(plane: np.ndarray) -> tuple:
    """([n, 8, 8] whole 8x8 blocks of a plane in raster order, block rows,
    block columns); partial blocks at the right and bottom are left out."""
    rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
    b = plane[:rows * 8, :cols * 8].reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
    return b.reshape(-1, 8, 8), rows, cols


def quantised(plane_u8: np.ndarray, q: np.ndarray) -> np.ndarray:
    """[block rows, block cols, 64] (natural order) coefficients libjpeg
    writes for the whole blocks of an 8-bit plane under steps q [8, 8]."""
    b, rows, cols = blocks(plane_u8)
    d = b.astype(np.int64) - 128
    d = _pass(_pass(d, True).transpose(0, 2, 1), False).transpose(0, 2, 1)
    div = q.astype(np.int64) * 8
    v = (np.abs(d) + div // 2) // div
    return np.where(d < 0, -v, v).reshape(rows, cols, 64)
