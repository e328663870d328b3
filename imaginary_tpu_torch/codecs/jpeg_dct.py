"""Host-side JPEG entropy codec -> packed quantized DCT coefficients.

The port's copy of `imaginary_tpu/codecs/jpeg_dct.py`, trimmed to what the
DCT transport of the port calls (`decode_packed` on ingest,
`unpack_dct_egress` + `encode_quantized` on egress, and `blocks_to_planes`
when that encode fails).

The dct transport (ops/plan.wrap_plan_dct) splits JPEG decode across the
link: the host does only the serial, un-vectorizable part — Huffman entropy
decode plus an exact integer dequantize/fold — and ships coefficient
blocks; the k-point IDCT, chroma upsampling, and the level shift run on
the card (ops/stages.FromDctSpec, kernel K11). Shrink-on-load happens in
the DCT domain: for a 1/N decode (N in {2, 4, 8}) each 8x8 block is
reduced to a k x k block (k = 8/N) by a *weighted frequency fold* —
algebraically identical to libjpeg's scaled IDCT (jidctred.c), which is the
full IDCT followed by adjacent-pair box averaging: each halving multiplies
frequency u by cos(u*pi/16) (then /8, /4) in the frequency domain, and the
weighted frequencies alias onto the k-point basis with signs
(u = 2qk ± r -> (-1)^q, r == k lands on a cosine zero). Naive top-left
truncation instead diverges strongly at sharp edges. Dims match
`choose_decode_shrink`'s ceil(dim/N) contract exactly.

Folding mixes coefficients across quant bins, so dequantization happens
here on the host too — it is exact integer math (value*step fits int16
comfortably: |dequantized| is bounded by the true DCT range ~±1100, and a
fold sums at most 4 terms), and it removes any per-image dynamic input to
the device stage.

The entropy scan has three interchangeable decoder arms behind one
segment-ranged signature (set_decoder):

  * native — `native/entropy.cpp` (`_itpu_torch_entropy`), the same
    Huffman walk in C++ with the GIL released, built with g++ into
    `imaginary_tpu_torch/_build/` at first use (`native/build.py`).
  * numpy — a lockstep decoder with one bit-cursor lane per restart
    segment; its per-op overhead amortizes only across many segments.
  * python — the `_Bits` loop. It is the parity oracle the other arms
    are tested against.

"auto" takes the native arm when it builds; without it, numpy for scans
of 16 or more restart segments and python below that.

A scan with restart markers is split into contiguous segment ranges
across the host pool registered with set_segment_pool (the server's
request pool): segments are independent (DC prediction resets at RSTn)
and each range writes its own block rows of the shared planes. The
calling thread decodes the first range itself and takes back any range
no worker has started, so a request thread sharing the pool with its own
submissions cannot deadlock. The numpy arm runs its lanes in one call
and is not split.

Packed layouts, per source sampling (`DctCoefficients.layout`):

  * 420, shrink 1: int16 [hb + hb/2, wb, 1] mirroring the yuv420
    transport — Y rows [0, hb), then U in columns [0, wb/2) and V in
    [wb/2, wb) of the quarter-size rows below.
  * 420, shrunk: int16 [hb, wb, 3] — Y folds to k x k while chroma folds
    to 2k x 2k (libjpeg scales chroma at twice the luma factor), so all
    block grids land at the same resolution, channel-packed.
  * 422, shrink 1: int16 [2*hb, wb, 1] — Y rows [0, hb); half-width U/V
    coefficient planes side by side in rows [hb, 2*hb); the device
    upsamples chroma 2x horizontally only.
  * 422, shrunk: int16 [hb, wb, 3] — chroma folds to k x 2k.
  * 444 and grayscale: int16 [hb, wb, 3] / [hb, wb, 1] at every scale,
    all planes folded to k x k, no upsample.

Either way block (i, j)'s folded coefficient (u, v) sits at row i*kk + u,
col j*kk + v of its plane.

The egress direction reuses the same machinery backwards: the device's
forward-DCT stage (ops/stages.ToDctSpec, kernel K12) drains quantized
int16 coefficient planes, `unpack_dct_egress` re-blocks them, and
`encode_quantized` entropy-codes a complete baseline 4:2:0 JPEG around
them (Annex K quant tables scaled libjpeg-style, the standard K.3-K.6
Huffman tables) — on the native arm when it is built, in Python
otherwise.

Scope is baseline-only: 8-bit sequential DCT (SOF0), Huffman, the four
sampling layouts above. Anything else (progressive, arithmetic, 16-bit
quant tables, exotic sampling) returns None and the caller serves the
request on the rgb/yuv420 pixel paths.
"""

from __future__ import annotations

import contextvars
import dataclasses
import importlib.machinery
import importlib.util
import threading

import numpy as np

from imaginary_tpu_torch.ops.buckets import dct_packed_geometry

# zigzag scan position -> natural (row-major) index within the 8x8 block
ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
)

_ZZ = np.array(ZIGZAG, dtype=np.int64)


class _Unsupported(Exception):
    """Stream is valid-but-out-of-scope or corrupt; callers fall back."""


@dataclasses.dataclass
class DctCoefficients:
    """Entropy-decoded (still quantized) coefficients for one JPEG.

    planes: per-component arrays of shape [block_rows, block_cols, 8, 8]
    in natural (row-major) coefficient order, int16 — (y, u, v), or just
    (y,) for grayscale. Block grids cover the full MCU-padded frame,
    which is what makes the packed layouts' chroma regions fit by
    construction. qy/qc: dequantization tables, natural order, float32
    (qc is qy for grayscale). layout: "420" | "422" | "444" | "gray".
    """

    h: int
    w: int
    qy: np.ndarray
    qc: np.ndarray
    planes: tuple
    layout: str = "420"


def _build_lut(counts, symbols):
    """Canonical Huffman table -> flat 16-bit-peek LUT.

    lut[peek16] = (code_length << 8) | symbol; 0 marks an invalid prefix.
    One numpy slice-assign per symbol keeps table build O(symbols), and
    decode becomes one array index + shift per symbol — the difference
    between a usable and an unusable pure-Python entropy decoder. The
    native and numpy arms index the exact same tables.
    """
    lut = np.zeros(1 << 16, dtype=np.int32)
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            if k >= len(symbols) or code >= (1 << ln):
                raise _Unsupported("overfull huffman table")
            lo = code << (16 - ln)
            lut[lo: lo + (1 << (16 - ln))] = (ln << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut


class _Bits:
    """MSB-first bit reader over de-stuffed entropy-coded bytes."""

    __slots__ = ("d", "n", "i", "acc", "cnt")

    def __init__(self, d: bytes):
        self.d = d
        self.n = len(d)
        self.i = 0
        self.acc = 0
        self.cnt = 0

    def peek16(self) -> int:
        while self.cnt < 16:
            if self.i < self.n:
                self.acc = (self.acc << 8) | self.d[self.i]
                self.i += 1
            else:
                # zero-pad past the end: a well-formed scan never *consumes*
                # pad bits for a symbol, and a truncated one hits an invalid
                # LUT prefix and raises
                self.acc <<= 8
            self.cnt += 8
        return (self.acc >> (self.cnt - 16)) & 0xFFFF

    def drop(self, k: int) -> None:
        self.cnt -= k
        self.acc &= (1 << self.cnt) - 1

    def take(self, k: int) -> int:
        while self.cnt < k:
            if self.i < self.n:
                self.acc = (self.acc << 8) | self.d[self.i]
                self.i += 1
            else:
                self.acc <<= 8
            self.cnt += 8
        self.cnt -= k
        v = self.acc >> self.cnt
        self.acc &= (1 << self.cnt) - 1
        return v


def _extend(v: int, t: int) -> int:
    """JPEG F.2.2.1 sign extension of a t-bit magnitude."""
    return v - (1 << t) + 1 if v < (1 << (t - 1)) else v


def _split_scan_bounds(data: bytes, pos: int) -> list:
    """Byte ranges of the scan's restart intervals.

    Returns [(lo, hi), ...] offsets into `data`, still byte-stuffed; a
    segment boundary is an RSTn marker, and any other marker ends the
    scan. Offsets rather than slices so the native arm can hand the
    kernel one buffer + bounds instead of per-segment copies.
    """
    segs = []
    start = i = pos
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            segs.append((start, n))
            return segs
        m = data[j + 1]
        if m == 0x00:
            i = j + 2  # stuffed literal 0xFF
        elif m == 0xFF:
            i = j + 1  # fill byte
        elif 0xD0 <= m <= 0xD7:
            segs.append((start, j))
            start = i = j + 2
        else:
            segs.append((start, j))
            return segs


def _be16(d: bytes, p: int) -> int:
    return (d[p] << 8) | d[p + 1]


# --------------------------------------------------------------------------
# decoder arm selection
# --------------------------------------------------------------------------

_DECODER_MODES = ("auto", "native", "numpy", "python")
_DECODER_MODE = "auto"
_SEGMENT_POOL = None

_ENTROPY = None  # the loaded extension, once built
_ENTROPY_ERROR = None  # why the build failed, once it has
_ENTROPY_LOCK = threading.Lock()


def _entropy():
    """The native entropy extension, built and loaded on first call; None
    when the build failed (no C++ toolchain), with the reason kept."""
    global _ENTROPY, _ENTROPY_ERROR
    if _ENTROPY is None and _ENTROPY_ERROR is None:
        with _ENTROPY_LOCK:
            if _ENTROPY is None and _ENTROPY_ERROR is None:
                from imaginary_tpu_torch.native import build

                try:
                    path, _ = build.build_entropy()
                except (RuntimeError, OSError) as e:
                    _ENTROPY_ERROR = str(e)
                    return None
                name = build.ENTROPY_MODULE
                loader = importlib.machinery.ExtensionFileLoader(name, path)
                spec = importlib.util.spec_from_file_location(name, path, loader=loader)
                mod = importlib.util.module_from_spec(spec)
                loader.exec_module(mod)
                if getattr(mod, "ABI", 0) != 1:
                    raise RuntimeError(f"{path}: entropy codec ABI {getattr(mod, 'ABI', 0)}, need 1")
                _ENTROPY = mod
    return _ENTROPY


def native_available() -> bool:
    """True when the native entropy codec is built (building it now if it
    was not tried yet)."""
    return _entropy() is not None


def set_decoder(mode: str) -> None:
    """Pick the entropy-scan decoder arm: auto | native | numpy | python.

    auto takes the native arm when it builds, else numpy for scans of 16
    or more restart segments and python below; native raises when it
    cannot be built."""
    global _DECODER_MODE
    if mode not in _DECODER_MODES:
        raise ValueError(f"unknown dct decoder {mode!r}")
    _DECODER_MODE = mode


def set_segment_pool(pool) -> None:
    """Executor used to fan restart-segment ranges of one image out; None
    keeps decode on the calling thread."""
    global _SEGMENT_POOL
    _SEGMENT_POOL = pool


def release_segment_pool(pool) -> None:
    """Detach `pool` if it is the registered one (a server closing its
    pool leaves a newer server's in place)."""
    global _SEGMENT_POOL
    if _SEGMENT_POOL is pool:
        _SEGMENT_POOL = None


def _resolve_name(mode: str, nseg: int) -> str:
    if mode in ("numpy", "python"):
        return mode
    if mode == "native":
        if _entropy() is None:
            raise RuntimeError(f"native entropy codec unavailable: {_ENTROPY_ERROR}")
        return "native"
    # auto: native always wins; the lockstep decoder only amortizes its
    # per-op numpy overhead across many parallel segments
    if _entropy() is not None:
        return "native"
    return "numpy" if nseg >= 16 else "python"


def decoder_name(nseg: int = 1) -> str:
    """The arm the current mode resolves to for an nseg-segment scan."""
    return _resolve_name(_DECODER_MODE, nseg)


# --------------------------------------------------------------------------
# scan parsing
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Scan:
    """Parsed frame+scan headers: everything a decoder arm needs.

    comps: dicts (scan order) with h/v sampling, tq quant selector, and
    dc/ac row indices into lut_stack (int32 [nluts, 65536], contiguous —
    the native kernel receives it as one buffer).
    """

    h: int
    w: int
    layout: str
    comps: list
    lut_stack: np.ndarray
    restart: int
    mcu_y: int
    mcu_x: int
    total_mcus: int
    data: bytes
    entropy_pos: int
    qt: dict


def _parse(data: bytes):
    """Marker walk up to SOS. None = not a JPEG / no scan; raises
    _Unsupported for valid-but-out-of-scope streams."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return None
    pos = 2
    qt: dict = {}
    huff: dict = {}
    frame = None
    comps = None
    scan = None
    restart = 0
    n = len(data)
    while pos < n - 1:
        if data[pos] != 0xFF:
            raise _Unsupported("marker desync")
        m = data[pos + 1]
        pos += 2
        if m == 0xFF:  # fill byte
            pos -= 1
            continue
        if m in (0x01,) or 0xD0 <= m <= 0xD7:
            continue  # standalone markers
        if m == 0xD9:  # EOI before any scan
            return None
        seg_len = _be16(data, pos)
        seg = data[pos + 2: pos + seg_len]
        pos += seg_len
        if m == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 0x0F
                if pq != 0:
                    raise _Unsupported("16-bit quant tables")
                tbl = np.zeros(64, dtype=np.float32)
                for z in range(64):
                    tbl[ZIGZAG[z]] = seg[p + 1 + z]
                qt[tq] = tbl.reshape(8, 8)
                p += 65
        elif m == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 0x0F
                counts = list(seg[p + 1: p + 17])
                total = sum(counts)
                symbols = list(seg[p + 17: p + 17 + total])
                huff[(tc, th)] = _build_lut(counts, symbols)
                p += 17 + total
        elif m == 0xC0:  # SOF0: baseline sequential
            if seg[0] != 8:
                raise _Unsupported("non-8-bit precision")
            h, w = _be16(seg, 1), _be16(seg, 3)
            nc = seg[5]
            if h == 0 or w == 0 or nc not in (1, 3):
                raise _Unsupported("need 1- or 3-component frame with dims")
            frame = (h, w)
            comps = []
            for ci in range(nc):
                b = 6 + ci * 3
                comps.append({
                    "id": seg[b],
                    "h": seg[b + 1] >> 4,
                    "v": seg[b + 1] & 0x0F,
                    "tq": seg[b + 2],
                })
        elif 0xC1 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            raise _Unsupported("non-baseline frame type")
        elif m == 0xDD:  # DRI
            restart = _be16(seg, 0)
        elif m == 0xDA:  # SOS
            if frame is None:
                raise _Unsupported("scan before frame header")
            ns = seg[0]
            if ns != len(comps):
                raise _Unsupported("partial (non-interleaved) scan")
            sel = []
            for si in range(ns):
                cs, tt = seg[1 + si * 2], seg[2 + si * 2]
                comp = next((c for c in comps if c["id"] == cs), None)
                if comp is None:
                    raise _Unsupported("scan references unknown component")
                sel.append((comp, tt >> 4, tt & 0x0F))
            ss, se = seg[1 + ns * 2], seg[2 + ns * 2]
            if ss != 0 or se != 63:
                raise _Unsupported("spectral selection (progressive?)")
            scan = (sel, pos)
            break
        # everything else (APPn, COM): skip
    if scan is None:
        return None
    sel, entropy_pos = scan
    samp = [(c["h"], c["v"]) for c, _, _ in sel]
    if len(sel) == 1:
        if samp != [(1, 1)]:
            raise _Unsupported("grayscale with non-1x1 sampling")
        layout = "gray"
    elif samp == [(2, 2), (1, 1), (1, 1)]:
        layout = "420"
    elif samp == [(2, 1), (1, 1), (1, 1)]:
        layout = "422"
    elif samp == [(1, 1), (1, 1), (1, 1)]:
        layout = "444"
    else:
        raise _Unsupported("unsupported sampling layout")
    h, w = frame
    hmax = max(c["h"] for c, _, _ in sel)
    vmax = max(c["v"] for c, _, _ in sel)
    mcu_y = -(-h // (8 * vmax))
    mcu_x = -(-w // (8 * hmax))
    lut_list: list = []
    lut_index: dict = {}
    scomps = []
    for comp, td, ta in sel:
        keys = ((0, td), (1, ta))
        for key in keys:
            if key not in huff:
                raise _Unsupported("missing huffman table")
            if key not in lut_index:
                lut_index[key] = len(lut_list)
                lut_list.append(huff[key])
        scomps.append({
            "h": comp["h"], "v": comp["v"], "tq": comp["tq"],
            "dc": lut_index[keys[0]], "ac": lut_index[keys[1]],
        })
    return _Scan(
        h=h, w=w, layout=layout, comps=scomps,
        lut_stack=np.ascontiguousarray(np.stack(lut_list)),
        restart=restart, mcu_y=mcu_y, mcu_x=mcu_x,
        total_mcus=mcu_y * mcu_x, data=data, entropy_pos=entropy_pos, qt=qt,
    )


# --------------------------------------------------------------------------
# decoder arms — shared signature fn(sc, planes, bounds, s0, s1): decode
# restart segments [s0, s1) into the int16 [rows, cols, 64] planes.
# Distinct segments touch distinct MCUs, hence distinct blocks: calls for
# disjoint ranges are safe to run concurrently on the same planes.
# --------------------------------------------------------------------------

def _scan_python(sc: _Scan, planes: list, bounds: list, s0: int, s1: int):
    """The parity oracle: one _Bits cursor, one symbol at a time."""
    per = sc.restart if sc.restart else sc.total_mcus
    zz = ZIGZAG
    for si in range(s0, s1):
        lo, hi = bounds[si]
        bits = _Bits(sc.data[lo:hi].replace(b"\xff\x00", b"\xff"))
        pred = [0] * len(sc.comps)
        m1 = min((si + 1) * per, sc.total_mcus)
        for m in range(si * per, m1):
            my, mx = divmod(m, sc.mcu_x)
            for ci, comp in enumerate(sc.comps):
                dc_lut = sc.lut_stack[comp["dc"]]
                ac_lut = sc.lut_stack[comp["ac"]]
                for by in range(comp["v"]):
                    for bx in range(comp["h"]):
                        vals = [0] * 64
                        code = int(dc_lut[bits.peek16()])
                        ln = code >> 8
                        if ln == 0:
                            raise _Unsupported("bad DC code")
                        bits.drop(ln)
                        t = code & 0xFF
                        if t:
                            pred[ci] += _extend(bits.take(t), t)
                        vals[0] = pred[ci]
                        kk = 1
                        while kk < 64:
                            code = int(ac_lut[bits.peek16()])
                            ln = code >> 8
                            if ln == 0:
                                raise _Unsupported("bad AC code")
                            bits.drop(ln)
                            rs = code & 0xFF
                            s = rs & 0x0F
                            if s == 0:
                                if rs != 0xF0:
                                    break  # EOB
                                kk += 16
                                continue
                            kk += rs >> 4
                            if kk > 63:
                                raise _Unsupported("AC run overflow")
                            vals[zz[kk]] = _extend(bits.take(s), s)
                            kk += 1
                        planes[ci][my * comp["v"] + by,
                                   mx * comp["h"] + bx] = vals


def _scan_native(sc: _Scan, planes: list, bounds: list, s0: int, s1: int):
    """Hand the segment range to the C++ kernel (GIL released inside)."""
    per = sc.restart if sc.restart else sc.total_mcus
    nc = len(sc.comps)
    hdr = np.empty(6 + 2 * nc, dtype=np.int64)
    hdr[0] = nc
    hdr[1] = sc.restart
    hdr[2] = s0 * per
    hdr[3] = sc.total_mcus
    hdr[4] = sc.mcu_x
    hdr[5] = sc.lut_stack.shape[0]
    for ci, p in enumerate(planes):
        hdr[6 + ci * 2] = p.shape[0]
        hdr[7 + ci * 2] = p.shape[1]
    comp = np.array(
        [x for c in sc.comps for x in (c["h"], c["v"], c["dc"], c["ac"])],
        dtype=np.int32)
    bnd = np.array(bounds[s0:s1], dtype=np.int64).reshape(-1)
    try:
        _entropy().decode_segments(sc.data, hdr, comp, bnd, sc.lut_stack,
                                   *planes)
    except ValueError as e:
        raise _Unsupported(str(e)) from None


def _scan_numpy(sc: _Scan, planes: list, bounds: list, s0: int, s1: int):
    """Vectorized lockstep decode: one bit-cursor lane per segment.

    Every lane advances through the same (component, block, symbol)
    schedule; Huffman lookups become one gather through the shared LUTs
    and bit reads become shifted 3-/4-byte window gathers. Lanes whose
    segment holds fewer MCUs (the tail segment) or that hit EOB early go
    inactive under a mask. Rows are padded with >= 8 zero bytes and byte
    indices clamped per-row, reproducing _Bits' zero-pad-past-end
    semantics without ever reading a neighbour lane. The unstuffed
    segments are held as one int64 row each, eight bytes for every byte
    of the scan.
    """
    nseg = s1 - s0
    per = sc.restart if sc.restart else sc.total_mcus
    segs = [sc.data[lo:hi].replace(b"\xff\x00", b"\xff")
            for lo, hi in bounds[s0:s1]]
    maxlen = max(len(s) for s in segs) + 8
    rows = np.zeros((nseg, maxlen), dtype=np.uint8)
    for i, s in enumerate(segs):
        rows[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    flat = rows.reshape(-1).astype(np.int64)
    base = np.arange(nseg, dtype=np.int64) * maxlen
    rel = np.zeros(nseg, dtype=np.int64)  # bit cursor per lane

    mcu_lo = np.arange(s0, s1, dtype=np.int64) * per
    lane_n = np.minimum(per, sc.total_mcus - mcu_lo)
    preds = [np.zeros(nseg, dtype=np.int64) for _ in sc.comps]
    pflats = [p.reshape(-1) for p in planes]
    cols = [p.shape[1] for p in planes]
    one = np.int64(1)

    def peek16():
        idx = base + np.minimum(rel >> 3, maxlen - 3)
        w = (flat[idx] << 16) | (flat[idx + 1] << 8) | flat[idx + 2]
        return (w >> (8 - (rel & 7))) & 0xFFFF

    def take(t):
        idx = base + np.minimum(rel >> 3, maxlen - 4)
        w = ((flat[idx] << 24) | (flat[idx + 1] << 16)
             | (flat[idx + 2] << 8) | flat[idx + 3])
        return (w >> (32 - (rel & 7) - t)) & ((one << t) - 1)

    def extend(v, t):
        ext = np.where(v < (one << (np.maximum(t, 1) - 1)),
                       v - (one << t) + 1, v)
        return np.where(t > 0, ext, 0)

    for m in range(int(lane_n.max())):
        active = lane_n > m
        g = mcu_lo + m
        my = g // sc.mcu_x
        mx = g % sc.mcu_x
        for ci, comp in enumerate(sc.comps):
            dc_lut = sc.lut_stack[comp["dc"]]
            ac_lut = sc.lut_stack[comp["ac"]]
            for by in range(comp["v"]):
                for bx in range(comp["h"]):
                    bb = ((my * comp["v"] + by) * cols[ci]
                          + (mx * comp["h"] + bx)) * 64
                    code = dc_lut[peek16()].astype(np.int64)
                    ln = code >> 8
                    if np.any(active & (ln == 0)):
                        raise _Unsupported("bad DC code")
                    rel = rel + np.where(active, ln, 0)
                    t = np.where(active, code & 0xFF, 0)
                    if np.any(t > 16):
                        raise _Unsupported("bad DC category")
                    v = take(t)
                    rel = rel + t
                    preds[ci] = preds[ci] + extend(v, t)
                    pflats[ci][bb[active]] = \
                        preds[ci][active].astype(np.int16)
                    kk = np.ones(nseg, dtype=np.int64)
                    lane = active.copy()
                    while True:
                        alive = lane & (kk < 64)
                        if not alive.any():
                            break
                        code = ac_lut[peek16()].astype(np.int64)
                        ln = code >> 8
                        if np.any(alive & (ln == 0)):
                            raise _Unsupported("bad AC code")
                        rel = rel + np.where(alive, ln, 0)
                        rs = np.where(alive, code & 0xFF, 0)
                        s4 = rs & 0x0F
                        r4 = rs >> 4
                        iszrl = alive & (s4 == 0) & (r4 == 15)
                        iseob = alive & (s4 == 0) & (r4 != 15)
                        isval = alive & (s4 > 0)
                        kk = (kk + np.where(iszrl, 16, 0)
                              + np.where(isval, r4, 0))
                        if np.any(isval & (kk > 63)):
                            raise _Unsupported("AC run overflow")
                        t = np.where(isval, s4, 0)
                        v = take(t)
                        rel = rel + t
                        ext = extend(v, t)
                        tgt = bb + _ZZ[np.minimum(kk, 63)]
                        pflats[ci][tgt[isval]] = \
                            ext[isval].astype(np.int16)
                        kk = kk + np.where(isval, 1, 0)
                        lane = lane & ~iseob


_ARMS = {
    "python": _scan_python,
    "native": _scan_native,
    "numpy": _scan_numpy,
}


def _resolve(mode, nseg: int):
    return _ARMS[_resolve_name(mode or _DECODER_MODE, nseg)]


def _run_scan(sc: _Scan, planes: list, bounds: list, fn) -> None:
    """Run a decoder arm, fanning contiguous segment ranges across the
    registered pool when the scan has enough restart segments.

    The numpy arm already parallelizes across segments internally; for
    the others the submitting thread decodes chunk 0 inline, then drains
    — cancelling an unstarted future and running its range inline — so a
    request thread that shares the pool with these submissions can never
    deadlock waiting on itself (the handler pool is also the request
    executor). When a range fails, the chunks no worker started are
    dropped and the started ones finish before the error goes up, so no
    chunk writes into the planes after the call returns.
    """
    nseg = len(bounds)
    pool = _SEGMENT_POOL
    if pool is None or nseg < 4 or fn is _scan_numpy:
        fn(sc, planes, bounds, 0, nseg)
        return
    workers = max(2, int(getattr(pool, "_max_workers", 2)))
    nchunk = min(nseg, workers)
    edges = [round(i * nseg / nchunk) for i in range(nchunk + 1)]
    futs = []
    for a, b in zip(edges[1:-1], edges[2:]):
        if a >= b:
            continue
        ctx = contextvars.copy_context()
        futs.append((a, b, pool.submit(ctx.run, fn, sc, planes, bounds,
                                       a, b)))
    try:
        fn(sc, planes, bounds, edges[0], edges[1])
        for a, b, f in futs:
            if f.cancel():
                fn(sc, planes, bounds, a, b)
            else:
                f.result()
    finally:
        for f in [f for _, _, f in futs if not f.cancel()]:
            f.exception()


# --------------------------------------------------------------------------
# decode entry points
# --------------------------------------------------------------------------

def decode_coefficients(buf: bytes, decoder: str = None):
    """Entropy-decode a baseline JPEG. None when out of scope.

    decoder overrides the module-level arm (set_decoder) for this call:
    auto | native | numpy | python.
    """
    try:
        return _decode(buf, decoder)
    except (_Unsupported, IndexError, ValueError, KeyError):
        # corrupt or merely unsupported: both mean "use the pixel decoders"
        return None


def _decode(buf: bytes, decoder: str = None):
    data = bytes(buf)
    sc = _parse(data)
    if sc is None:
        return None
    bounds = _split_scan_bounds(data, sc.entropy_pos)
    needed = -(-sc.total_mcus // sc.restart) if sc.restart else 1
    if len(bounds) < needed:
        raise _Unsupported("missing restart segment")
    bounds = bounds[:needed]
    planes = [
        np.zeros((sc.mcu_y * c["v"], sc.mcu_x * c["h"], 64), dtype=np.int16)
        for c in sc.comps
    ]
    _run_scan(sc, planes, bounds, _resolve(decoder, len(bounds)))
    qy = sc.qt.get(sc.comps[0]["tq"])
    if qy is None:
        raise _Unsupported("missing quant table")
    if sc.layout == "gray":
        qc = qy
    else:
        qc = sc.qt.get(sc.comps[1]["tq"])
        if qc is None or sc.comps[1]["tq"] != sc.comps[2]["tq"]:
            raise _Unsupported("missing or asymmetric chroma quant tables")
    shaped = tuple(p.reshape(p.shape[0], p.shape[1], 8, 8) for p in planes)
    return DctCoefficients(h=sc.h, w=sc.w, qy=qy, qc=qc, planes=shaped,
                           layout=sc.layout)


# --------------------------------------------------------------------------
# frequency fold + packing
# --------------------------------------------------------------------------

def _fold_weights(k: int) -> np.ndarray:
    """Per-frequency weight of libjpeg's reduced-size IDCT.

    An 8->k reduction is the full 8-point IDCT followed by log2(8/k)
    rounds of adjacent-pair averaging; each round multiplies frequency u
    by cos(u*pi/16), then cos(u*pi/8), then cos(u*pi/4) in the frequency
    domain. These are exactly the jidctred.c constants (4x4's row-2/row-6
    pair 1.8477/0.7654 = 2cos(pi/8)/2cos(3pi/8)), and for k == 1 every AC
    weight hits a cosine zero or cancels — libjpeg's DC-only 1x1 case.
    """
    w = np.ones(8, dtype=np.float64)
    step, n = 16, 8
    while n > k:
        w *= np.cos(np.arange(8) * np.pi / step)
        step //= 2
        n //= 2
    return w


_FOLD_MATRICES: dict = {}


def _fold_matrix(k: int) -> np.ndarray:
    """The 8 x k frequency-alias matrix F with F[u, r] = the signed weight
    frequency u contributes to folded frequency r (see _fold_axis)."""
    F = _FOLD_MATRICES.get(k)
    if F is None:
        w = _fold_weights(k)
        F = np.zeros((8, k), dtype=np.float64)
        for u in range(8):
            q, r = divmod(u, 2 * k)
            sign = -1 if q & 1 else 1
            if r > k:
                r = 2 * k - r
                sign = -sign
            if r == k:
                continue
            F[u, r] += sign * w[u]
        _FOLD_MATRICES[k] = F
    return F


def _fold_axis(arr: np.ndarray, axis: int, k: int) -> np.ndarray:
    """Alias the 8 basis frequencies along `axis` onto the k-point basis.

    On the half-sample grid x_j = (2j+1)/(2k), cos(pi*u*x) for u = 2qk ± r
    equals (-1)^q * cos(pi*r*x) (and vanishes for r == k), so the weighted
    8-frequency block collapses to k frequencies with summed, sign-flipped
    coefficients: e.g. k=4 keeps G(r) = w(r)D(r) - w(8-r)D(8-r). Together
    with _fold_weights this reproduces libjpeg's scaled decode bit-for-bit
    up to rounding (measured max 0.54 grey levels across the test corpus).
    """
    if k == 8:
        return arr.astype(np.float64)
    out = np.tensordot(arr, _fold_matrix(k), axes=([axis], [0]))
    return np.moveaxis(out, -1, axis)


_FOLD_KERNELS: dict = {}


def _fold_kernel(q: np.ndarray, kv: int, kh: int) -> np.ndarray:
    """The fused dequantize+fold kernel: a (64, kv*kh) float32 matrix
    W[(u,v), (r,s)] = q[u,v] * Fv[u,r] * Fh[v,s], so one GEMM over the
    flattened block grid replaces dequantization and both axis folds.
    Keyed by the quant table bytes — JPEG streams reuse a handful."""
    key = (q.tobytes(), kv, kh)
    W = _FOLD_KERNELS.get(key)
    if W is None:
        fv = np.eye(8) if kv == 8 else _fold_matrix(kv)
        fh = np.eye(8) if kh == 8 else _fold_matrix(kh)
        W = np.einsum("uv,ur,vs->uvrs", q.astype(np.float64), fv, fh)
        W = np.ascontiguousarray(
            W.reshape(64, kv * kh).astype(np.float32))
        _FOLD_KERNELS[key] = W
    return W


def _fold_plane(blocks: np.ndarray, q: np.ndarray, kv: int,
                kh: int) -> np.ndarray:
    """Dequantize + fold one block grid to kv x kh per block, tiled out
    to a [rows*kv, cols*kh] coefficient plane.

    One float32 GEMM against the fused _fold_kernel — the separable
    tensordot formulation materialized an int32 dequantized copy and a
    float64 temporary per axis, and was most of decode_packed's time.
    Products |coeff*q| stay under 2^24 so the float32 dequantization is
    exact; the fold then rounds once to int16 (worst case one ulp from
    the float64 path at exact .5 ties, well inside the parity budget).
    """
    W = _fold_kernel(q, kv, kh)
    rows, cols = blocks.shape[:2]
    flat = blocks.reshape(rows * cols, 64).astype(np.float32)
    sub = np.rint(flat @ W).astype(np.int16)
    sub = sub.reshape(rows, cols, kv, kh)
    return sub.transpose(0, 2, 1, 3).reshape(rows * kv, cols * kh)


def pack_dct(c: DctCoefficients, shrink: int) -> np.ndarray:
    """Dequantize, frequency-fold, and pack into the transport buffer.

    See the module docstring for the per-layout buffer shapes. For 4:2:0
    chroma folds at 2k (libjpeg's per-component scaling: chroma
    DCT_scaled_size is twice luma's), for 4:2:2 at k x 2k, and for
    4:4:4/gray at k — so every plane's block grid lands at the same
    output resolution and only the two full-scale single-channel layouts
    need a device-side chroma upsample. FromDctSpec applies the matching
    scaled IDCT per plane; k == 8 (fold = identity) is the exact JPEG
    IDCT, k < 8 is libjpeg's scaled decode. Dequantization is exact
    integer math; the weighted fold rounds once to int16 (|values| stay
    under ~5k: the true DCT range ~±1100 per term, at most 4
    cosine-weighted terms per fold).
    """
    k, h2, w2, hb, wb = dct_packed_geometry(c.h, c.w, shrink, c.layout)
    if c.layout == "gray":
        packed = np.zeros((hb, wb, 1), dtype=np.int16)
        yp = _fold_plane(c.planes[0], c.qy, k, k)
        packed[: yp.shape[0], : yp.shape[1], 0] = yp
        return packed
    if c.layout == "444":
        packed = np.zeros((hb, wb, 3), dtype=np.int16)
        for i, (blocks, q) in enumerate(
                zip(c.planes, (c.qy, c.qc, c.qc))):
            p = _fold_plane(blocks, q, k, k)
            packed[: p.shape[0], : p.shape[1], i] = p
        return packed
    if c.layout == "422":
        if shrink == 1:
            packed = np.zeros((2 * hb, wb, 1), dtype=np.int16)
            yp = _fold_plane(c.planes[0], c.qy, 8, 8)
            packed[: yp.shape[0], : yp.shape[1], 0] = yp
            up = _fold_plane(c.planes[1], c.qc, 8, 8)
            vp = _fold_plane(c.planes[2], c.qc, 8, 8)
            packed[hb: hb + up.shape[0], : up.shape[1], 0] = up
            packed[hb: hb + vp.shape[0],
                   wb // 2: wb // 2 + vp.shape[1], 0] = vp
            return packed
        packed = np.zeros((hb, wb, 3), dtype=np.int16)
        yp = _fold_plane(c.planes[0], c.qy, k, k)
        packed[: yp.shape[0], : yp.shape[1], 0] = yp
        up = _fold_plane(c.planes[1], c.qc, k, 2 * k)
        vp = _fold_plane(c.planes[2], c.qc, k, 2 * k)
        packed[: up.shape[0], : up.shape[1], 1] = up
        packed[: vp.shape[0], : vp.shape[1], 2] = vp
        return packed
    # 420
    if shrink == 1:
        packed = np.zeros((hb + hb // 2, wb, 1), dtype=np.int16)
        yp = _fold_plane(c.planes[0], c.qy, 8, 8)
        packed[: yp.shape[0], : yp.shape[1], 0] = yp
        up = _fold_plane(c.planes[1], c.qc, 8, 8)
        vp = _fold_plane(c.planes[2], c.qc, 8, 8)
        packed[hb: hb + up.shape[0], : up.shape[1], 0] = up
        packed[hb: hb + vp.shape[0], wb // 2: wb // 2 + vp.shape[1], 0] = vp
        return packed
    packed = np.zeros((hb, wb, 3), dtype=np.int16)
    yp = _fold_plane(c.planes[0], c.qy, k, k)
    packed[: yp.shape[0], : yp.shape[1], 0] = yp
    up = _fold_plane(c.planes[1], c.qc, 2 * k, 2 * k)
    vp = _fold_plane(c.planes[2], c.qc, 2 * k, 2 * k)
    packed[: up.shape[0], : up.shape[1], 1] = up
    packed[: vp.shape[0], : vp.shape[1], 2] = vp
    return packed


def decode_packed(buf: bytes, shrink: int, decoder: str = None):
    """decode_coefficients + pack_dct in one call.

    Returns (packed, h2, w2, layout) — h2/w2 are the shrunk valid dims,
    ceil(dim/shrink), matching libjpeg scaled-decode sizing, and layout
    is the source sampling ("420" | "422" | "444" | "gray") that selects
    the matching FromDctSpec geometry — or None when the stream is out of
    scope for the dct transport.
    """
    c = decode_coefficients(buf, decoder)
    if c is None:
        return None
    packed = pack_dct(c, shrink)
    _, h2, w2, _, _ = dct_packed_geometry(c.h, c.w, shrink, c.layout)
    return packed, h2, w2, c.layout


# --------------------------------------------------------------------------
# egress: quantized device coefficients -> baseline 4:2:0 JPEG
# --------------------------------------------------------------------------

# Annex K base quantization tables, natural (row-major) order
_BASE_QY = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32).reshape(8, 8)

_BASE_QC = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32).reshape(8, 8)

# Annex K standard Huffman tables (K.3-K.6): (bits-per-length, symbols)
_STD_DC_LUM = (
    (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
    tuple(range(12)),
)
_STD_DC_CHROM = (
    (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
    tuple(range(12)),
)
_STD_AC_LUM = (
    (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
    (0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
     0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
     0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
     0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
     0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
     0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
     0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
     0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
     0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
     0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
     0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
     0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
     0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
     0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
     0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
     0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
     0xF9, 0xFA),
)
_STD_AC_CHROM = (
    (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
    (0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
     0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
     0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
     0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
     0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
     0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
     0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
     0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
     0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
     0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
     0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
     0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
     0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
     0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
     0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
     0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
     0xF9, 0xFA),
)


def quality_tables(quality: int) -> tuple:
    """libjpeg-compatible quality scaling of the Annex K base tables.

    Returns (qy, qc) int32 [8, 8] in natural order. Shared between the
    device quantizer (ops/stages.ToDctSpec bakes them into the compiled
    stage) and the host encoder's DQT segments — the two MUST agree or
    the decoded image dequantizes with the wrong steps.
    """
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def tab(base):
        t = (base * scale + 50) // 100
        return np.clip(t, 1, 255).astype(np.int32)

    return tab(_BASE_QY), tab(_BASE_QC)


def _huff_codes(counts, symbols) -> np.ndarray:
    """Canonical Huffman table -> int32 [256, 2] of (code, bitlength)
    per symbol; length 0 marks an absent symbol. The encoder-side dual
    of _build_lut."""
    tab = np.zeros((256, 2), dtype=np.int32)
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            tab[symbols[k], 0] = code
            tab[symbols[k], 1] = ln
            code += 1
            k += 1
        code <<= 1
    return tab


@dataclasses.dataclass
class QuantizedBlocks:
    """Device-quantized coefficients for one JPEG-bound response.

    y/u/v: int16 [block_rows, block_cols, 8, 8], natural coefficient
    order, already divided by the `quality`-scaled Annex K tables
    (ops/stages.ToDctSpec). Grids are MCU-padded: Y covers
    2*ceil(h/16) x 2*ceil(w/16) blocks, chroma ceil(h/16) x ceil(w/16).
    """

    h: int
    w: int
    quality: int
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray


def _dct_basis8() -> np.ndarray:
    """Orthonormal 8-point DCT-II basis, b[u, x] = a(u) cos((2x+1)u pi/16)."""
    x = np.arange(8)
    b = np.cos((2 * x[None, :] + 1) * np.arange(8)[:, None] * np.pi / 16)
    b *= 0.5
    b[0] *= np.sqrt(0.5)
    return b


def blocks_to_planes(qb: QuantizedBlocks) -> tuple:
    """The pixels of an egress buffer whose entropy encode failed: (y, u, v)
    uint8 planes at (h, w) and (ceil(h/2), ceil(w/2)), dequantized and
    inverse-transformed exactly in f64 (ref: jpeg_dct.py:1252-1275)."""
    qy, qc = quality_tables(qb.quality)
    b = _dct_basis8()

    def pix(blocks, q, vh, vw):
        deq = blocks.astype(np.float64) * q.astype(np.float64)[None, None]
        img = np.einsum("abuv,ux,vz->abxz", deq, b, b) + 128.0
        out = img.transpose(0, 2, 1, 3).reshape(blocks.shape[0] * 8, blocks.shape[1] * 8)
        return np.clip(np.rint(out[:vh, :vw]), 0, 255).astype(np.uint8)

    ch, cw = -(-qb.h // 2), -(-qb.w // 2)
    return (pix(qb.y, qy, qb.h, qb.w), pix(qb.u, qc, ch, cw), pix(qb.v, qc, ch, cw))


def unpack_dct_egress(packed: np.ndarray, h: int, w: int, hb: int, wb: int,
                      quality: int) -> QuantizedBlocks:
    """Re-block one device-drained egress buffer.

    `packed` is ToDctSpec's int16 [hb + hb/2, wb(, 1)] output — the
    yuv420 transport layout with coefficient blocks in place of pixels:
    block (i, j)'s coefficient (u, v) at row i*8 + u, col j*8 + v. Needs
    hb/wb multiples of 16 so the chroma half-planes split on block
    boundaries (tight_dim guarantees this for every output bucket).
    """
    if hb % 16 or wb % 16:
        raise ValueError(f"egress bucket {hb}x{wb} not block-aligned")
    mcu_y, mcu_x = -(-h // 16), -(-w // 16)
    a = np.asarray(packed)
    if a.ndim == 3:
        a = a[..., 0]

    def grid(plane, ph, pw, br, bc):
        g = np.ascontiguousarray(plane).reshape(ph // 8, 8, pw // 8, 8)
        return np.ascontiguousarray(
            g.transpose(0, 2, 1, 3)[:br, :bc]).astype(np.int16)

    ch, cw = hb // 2, wb // 2
    return QuantizedBlocks(
        h=h, w=w, quality=int(quality),
        y=grid(a[:hb, :wb], hb, wb, 2 * mcu_y, 2 * mcu_x),
        u=grid(a[hb: hb + ch, :cw], ch, cw, mcu_y, mcu_x),
        v=grid(a[hb: hb + ch, cw: wb], ch, cw, mcu_y, mcu_x),
    )


def _category(v: int) -> int:
    """Magnitude category: bits needed for |v| (0 for 0)."""
    a = -v if v < 0 else v
    t = 0
    while a:
        a >>= 1
        t += 1
    return t


class _BitsOut:
    """MSB-first bit writer with JPEG byte stuffing (encoder-side _Bits)."""

    __slots__ = ("out", "acc", "cnt")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.cnt = 0

    def put(self, code: int, ln: int) -> None:
        self.acc = (self.acc << ln) | (code & ((1 << ln) - 1))
        self.cnt += ln
        while self.cnt >= 8:
            b = (self.acc >> (self.cnt - 8)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)
            self.cnt -= 8
        self.acc &= (1 << self.cnt) - 1

    def flush(self) -> None:
        """Pad the partial byte with 1-bits (F.1.2.3) and emit it."""
        if self.cnt:
            pad = 8 - self.cnt
            b = ((self.acc << pad) | ((1 << pad) - 1)) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)
            self.acc = 0
            self.cnt = 0


def _encode_scan_python(planes: list, mcu_y: int, mcu_x: int,
                        restart: int) -> bytes:
    """Pure-Python entropy encoder: the parity oracle for the native
    kernel and the fallback when it is absent."""
    tabs = [_huff_codes(*t) for t in (_STD_DC_LUM, _STD_AC_LUM,
                                      _STD_DC_CHROM, _STD_AC_CHROM)]
    comp = ((2, 2, tabs[0], tabs[1]), (1, 1, tabs[2], tabs[3]),
            (1, 1, tabs[2], tabs[3]))
    zz = ZIGZAG
    bw = _BitsOut()
    pred = [0, 0, 0]
    for m in range(mcu_y * mcu_x):
        if restart and m and m % restart == 0:
            bw.flush()
            bw.out += bytes((0xFF, 0xD0 + ((m // restart - 1) & 7)))
            pred = [0, 0, 0]
        my, mx = divmod(m, mcu_x)
        for ci, (ch, cv, dct, act) in enumerate(comp):
            pl = planes[ci]
            for by in range(cv):
                for bx in range(ch):
                    blk = pl[my * cv + by, mx * ch + bx]
                    dc = int(blk[0])
                    diff = dc - pred[ci]
                    pred[ci] = dc
                    t = _category(diff)
                    if t > 11 or int(dct[t, 1]) == 0:
                        raise ValueError("DC difference out of range")
                    bw.put(int(dct[t, 0]), int(dct[t, 1]))
                    if t:
                        bw.put(diff + (1 << t) - 1 if diff < 0 else diff, t)
                    run = 0
                    for kk in range(1, 64):
                        v = int(blk[zz[kk]])
                        if v == 0:
                            run += 1
                            continue
                        while run > 15:
                            bw.put(int(act[0xF0, 0]), int(act[0xF0, 1]))
                            run -= 16
                        s = _category(v)
                        if s > 10 or int(act[(run << 4) | s, 1]) == 0:
                            raise ValueError("AC coefficient out of range")
                        rs = (run << 4) | s
                        bw.put(int(act[rs, 0]), int(act[rs, 1]))
                        bw.put(v + (1 << s) - 1 if v < 0 else v, s)
                        run = 0
                    if run:
                        bw.put(int(act[0, 0]), int(act[0, 1]))
    bw.flush()
    return bytes(bw.out)


def _encode_scan(qb: QuantizedBlocks, mcu_y: int, mcu_x: int,
                 restart: int) -> bytes:
    planes = [
        np.ascontiguousarray(
            p.astype(np.int16).reshape(p.shape[0], p.shape[1], 64))
        for p in (qb.y, qb.u, qb.v)
    ]
    # the numpy arm decodes only; its mode encodes natively where built
    ext = None if _resolve_name(_DECODER_MODE, 1) == "python" else _entropy()
    if ext is not None:
        hdr = np.array([
            3, restart, mcu_y * mcu_x, mcu_x,
            planes[0].shape[0], planes[0].shape[1],
            planes[1].shape[0], planes[1].shape[1],
            planes[2].shape[0], planes[2].shape[1],
        ], dtype=np.int64)
        comp = np.array([2, 2, 0, 1, 1, 1, 2, 3, 1, 1, 2, 3],
                        dtype=np.int32)
        codes = np.ascontiguousarray(np.concatenate([
            _huff_codes(*_STD_DC_LUM), _huff_codes(*_STD_AC_LUM),
            _huff_codes(*_STD_DC_CHROM), _huff_codes(*_STD_AC_CHROM),
        ]).reshape(-1))
        return ext.encode_segments(hdr, comp, codes, *planes)
    return _encode_scan_python(planes, mcu_y, mcu_x, restart)


def encode_quantized(qb: QuantizedBlocks, restart_interval: int = 0) -> bytes:
    """Entropy-code device-quantized coefficients into a complete
    baseline 4:2:0 JFIF stream.

    The coefficients are used exactly as quantized on the device — no
    host DCT, no requantization — so the bytes are a faithful transport
    of the device's output; any stdlib/libjpeg decoder dequantizes with
    the same `quality_tables` steps written into DQT. restart_interval
    emits DRI/RSTn markers every that many MCUs.
    """
    qy, qc = quality_tables(qb.quality)
    mcu_y, mcu_x = -(-qb.h // 16), -(-qb.w // 16)
    out = bytearray(b"\xff\xd8")
    out += b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    out += b"\xff\xdb" + (2 + 65 + 65).to_bytes(2, "big")
    out.append(0x00)
    out += bytes(int(qy.reshape(64)[ZIGZAG[z]]) for z in range(64))
    out.append(0x01)
    out += bytes(int(qc.reshape(64)[ZIGZAG[z]]) for z in range(64))
    out += b"\xff\xc0" + (8 + 3 * 3).to_bytes(2, "big")
    out.append(8)
    out += int(qb.h).to_bytes(2, "big") + int(qb.w).to_bytes(2, "big")
    out.append(3)
    out += bytes((1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1))
    dht = bytearray()
    for tc_th, (bits, vals) in ((0x00, _STD_DC_LUM), (0x10, _STD_AC_LUM),
                                (0x01, _STD_DC_CHROM), (0x11, _STD_AC_CHROM)):
        dht.append(tc_th)
        dht += bytes(bits)
        dht += bytes(vals)
    out += b"\xff\xc4" + (2 + len(dht)).to_bytes(2, "big") + dht
    restart = int(restart_interval)
    if restart:
        out += b"\xff\xdd\x00\x04" + restart.to_bytes(2, "big")
    out += b"\xff\xda\x00\x0c\x03\x01\x00\x02\x11\x03\x11\x00\x3f\x00"
    out += _encode_scan(qb, mcu_y, mcu_x, restart)
    out += b"\xff\xd9"
    return bytes(out)
