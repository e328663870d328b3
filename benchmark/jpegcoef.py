"""The quantised DCT coefficients of a baseline JPEG, read from its
entropy-coded data (ITU T.81, Annex F: Huffman, sequential), without the
decoder's rounding to 8-bit samples. A block whose AC coefficients all
quantise to zero decodes to a flat block whose 8-bit value two adjacent DC
values can share (the luma DC step is under one sample at quality 80), so
only the entropy data says which one the encoder chose.
"""

from __future__ import annotations

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])  # zigzag -> natural
_NATURAL = ZIGZAG.tolist()


def _huffman(counts: bytes, symbols: bytes) -> tuple:
    """A 16-bit lookahead table: (symbol, code length) per 16-bit prefix."""
    sym = np.zeros(1 << 16, dtype=np.int32)
    length = np.zeros(1 << 16, dtype=np.int32)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            lo = code << (16 - n)
            sym[lo:lo + (1 << (16 - n))] = symbols[k]
            length[lo:lo + (1 << (16 - n))] = n
            code += 1
            k += 1
        code <<= 1
    return sym.tolist(), length.tolist()


def _unstuff(data: bytes, start: int) -> tuple:
    """The scan's bytes from `start`, 0xFF00 turned into 0xFF, split at
    restart markers; and the offset after the scan."""
    segments, cur, i = [], bytearray(), start
    while i < len(data):
        b = data[i]
        if b != 0xFF:
            cur.append(b)
            i += 1
            continue
        nxt = data[i + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            i += 2
        elif 0xD0 <= nxt <= 0xD7:
            segments.append(bytes(cur))
            cur = bytearray()
            i += 2
        else:
            break
    segments.append(bytes(cur))
    return segments, i


class _Bits:
    def __init__(self, data: bytes):
        self.b = data + b"\x00\x00\x00\x00"
        self.pos = 0

    def peek16(self) -> int:
        i, r = self.pos >> 3, self.pos & 7
        b = self.b
        return (((b[i] << 16) | (b[i + 1] << 8) | b[i + 2]) >> (8 - r)) & 0xFFFF

    def take(self, n: int) -> int:
        if n == 0:
            return 0
        i, r = self.pos >> 3, self.pos & 7
        b = self.b
        v = ((b[i] << 24) | (b[i + 1] << 16) | (b[i + 2] << 8) | b[i + 3]) >> (32 - r - n)
        self.pos += n
        return v & ((1 << n) - 1)


def _extend(v: int, n: int) -> int:
    return v - (1 << n) + 1 if n and v < (1 << (n - 1)) else v


def coefficients(body: bytes) -> list:
    """Per component of a baseline JPEG, in frame order: (its quantised
    coefficients [block rows, block cols, 64] in natural order, its
    quantisation table [8, 8])."""
    qt, dc_tabs, ac_tabs, comps, restart = {}, {}, {}, [], 0
    i = 2
    while i < len(body):
        if body[i] != 0xFF:
            raise ValueError("not a JPEG marker")
        marker = body[i + 1]
        seg_len = (body[i + 2] << 8) | body[i + 3]
        seg = body[i + 4:i + 2 + seg_len]
        if marker == 0xDB:
            j = 0
            while j < len(seg):
                prec, tid = seg[j] >> 4, seg[j] & 15
                n = 128 if prec else 64
                raw = np.frombuffer(seg[j + 1:j + 1 + n], dtype=">u2" if prec else np.uint8)
                tab = np.zeros(64)
                tab[ZIGZAG] = raw
                qt[tid] = tab.reshape(8, 8)
                j += 1 + n
        elif marker in (0xC0, 0xC1):
            height, width, nc = (seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5]
            comps = [(seg[6 + 3 * k], seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15, seg[8 + 3 * k])
                     for k in range(nc)]
        elif marker in (0xC2, 0xC3) or (0xC5 <= marker <= 0xCF and marker not in (0xC8, 0xCC)):
            raise ValueError(f"not a baseline JPEG (SOF marker 0x{marker:02X})")
        elif marker == 0xC4:
            j = 0
            while j < len(seg):
                cls, tid = seg[j] >> 4, seg[j] & 15
                counts = seg[j + 1:j + 17]
                n = sum(counts)
                (ac_tabs if cls else dc_tabs)[tid] = _huffman(counts, seg[j + 17:j + 17 + n])
                j += 17 + n
        elif marker == 0xDD:
            restart = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:
            ns = seg[0]
            sel = {seg[1 + 2 * k]: (seg[2 + 2 * k] >> 4, seg[2 + 2 * k] & 15) for k in range(ns)}
            segments, _ = _unstuff(body, i + 2 + seg_len)
            return _decode_scan(segments, restart, width, height, comps, sel, qt,
                                dc_tabs, ac_tabs)
        i += 2 + seg_len
    raise ValueError("no scan in the JPEG")


def _decode_scan(segments, restart, width, height, comps, sel, qt, dc_tabs, ac_tabs):
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    blocks = [[[0] * 64 for _ in range(mcuy * v * mcux * h)] for _, h, v, _ in comps]
    layout = [(cid, h, v, dc_tabs[sel[cid][0]], ac_tabs[sel[cid][1]]) for cid, h, v, _ in comps]
    total = mcux * mcuy
    per = restart or total
    m = 0
    for seg in segments:
        if m >= total:
            break
        bits = _Bits(seg)
        pred = [0] * len(layout)
        for _ in range(min(per, total - m)):
            my, mx = divmod(m, mcux)
            for k, (cid, h, v, (dsym, dlen), (asym, alen)) in enumerate(layout):
                for by in range(v):
                    for bx in range(h):
                        p = bits.peek16()
                        s = dsym[p]
                        bits.pos += dlen[p]
                        pred[k] += _extend(bits.take(s), s)
                        blk = blocks[k][(my * v + by) * mcux * h + mx * h + bx]
                        blk[0] = pred[k]
                        z = 1
                        while z < 64:
                            p = bits.peek16()
                            rs = asym[p]
                            bits.pos += alen[p]
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break
                                z += 16
                                continue
                            z += r
                            blk[_NATURAL[z]] = _extend(bits.take(s), s)
                            z += 1
            m += 1
    return [(np.array(b, dtype=np.int32).reshape(mcuy * c[2], mcux * c[1], 64), qt[c[3]])
            for b, c in zip(blocks, comps)]
