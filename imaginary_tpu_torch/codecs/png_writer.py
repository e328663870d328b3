"""A PNG writer in numpy and zlib: the reference's libpng path for PNG
with `interlace`, `palette` or `speed` (imaginary_tpu/native/codecs.cpp,
`png_encode_full`).

Pillow cannot write Adam7, and the card machine has no `png.h`, so the
port writes these files itself: 8-bit gray, gray + alpha, RGB, RGBA or
palette (with a tRNS chunk), at the caller's zlib level, each row with
libpng's filter rule (the type of least absolute signed sum among those
the speed allows), interlaced by Adam7 or not.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# PNG colour types by channel count (8-bit samples)
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
_PALETTE = 3

# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

NONE, SUB, UP, AVG, PAETH = range(5)


def filters_for(speed: int, palette: bool) -> tuple:
    """The filter types a row may take (codecs.cpp:1306-1312): speed 7+
    none, 4-6 none or sub, 1-3 all five; with no speed, libpng's default,
    which is none for a palette image and all five otherwise."""
    if speed >= 7:
        return (NONE,)
    if speed >= 4:
        return (NONE, SUB)
    if speed > 0 or not palette:
        return (NONE, SUB, UP, AVG, PAETH)
    return (NONE,)


def _filter_rows(rows: np.ndarray, bpp: int, allowed: tuple) -> bytes:
    """Each row of `rows` ([n, stride] uint8) filtered by the allowed
    type with the least sum of absolute signed bytes, with its type byte
    in front. Every predictor reads unfiltered neighbours, so all rows
    filter at once."""
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[:, bpp:] = up[:, :-bpp]
    cands = []
    for kind in allowed:
        if kind == NONE:
            f = x
        elif kind == SUB:
            f = x - left
        elif kind == UP:
            f = x - up
        elif kind == AVG:
            f = x - (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
            f = x - pred
        cands.append((f & 0xFF).astype(np.uint8))
    if len(cands) == 1:
        best = np.zeros(len(rows), np.intp)
        chosen = cands[0]
    else:
        stack = np.stack(cands)
        signed = stack.astype(np.int16)
        cost = np.minimum(signed, 256 - signed).sum(axis=2)
        best = np.argmin(cost, axis=0)
        chosen = stack[best, np.arange(len(rows))]
    kinds = np.asarray(allowed, np.uint8)[best]
    return np.concatenate([kinds[:, None], chosen], axis=1).tobytes()


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(pixels: np.ndarray, *, level: int = 6, interlace: bool = False,
           speed: int = 0, palette: np.ndarray | None = None,
           transparent: np.ndarray | None = None) -> bytes:
    """A PNG of `pixels`: [H, W, C] uint8 samples (C = 1 to 4), or with
    `palette` ([N, 3] uint8, N <= 256) [H, W] indices and, for the
    indices in order, `transparent`'s alpha values (the tRNS chunk)."""
    if palette is not None:
        if pixels.ndim != 2:
            raise ValueError("a palette image takes [H, W] indices")
        samples = pixels[:, :, None]
        color_type = _PALETTE
    else:
        if pixels.ndim != 3 or pixels.shape[2] not in _COLOR_TYPE:
            raise ValueError(f"cannot write a PNG of shape {pixels.shape}")
        samples = pixels
        color_type = _COLOR_TYPE[pixels.shape[2]]
    samples = np.ascontiguousarray(samples, dtype=np.uint8)
    h, w, c = samples.shape
    allowed = filters_for(speed, palette is not None)
    if interlace:
        parts = []
        for x0, y0, dx, dy in _ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                parts.append(_filter_rows(sub.reshape(sub.shape[0], -1), c, allowed))
        raw = b"".join(parts)
    else:
        raw = _filter_rows(samples.reshape(h, w * c), c, allowed)
    out = [_SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0,
                                       1 if interlace else 0))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).reshape(-1, 3).tobytes()))
        if transparent is not None and len(transparent):
            out.append(_chunk(b"tRNS", np.asarray(transparent, np.uint8).tobytes()))
    out.append(_chunk(b"IDAT", zlib.compress(raw, max(0, min(level, 9)))))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)
