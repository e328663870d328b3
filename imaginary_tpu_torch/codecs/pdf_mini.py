"""Minimal classic-xref PDF rasterizer — the vendored fallback renderer
(the port's copy of `imaginary_tpu/codecs/pdf_mini.py`, the same
arithmetic, so both packages render a page to the same pixels).

The reference renders PDF through libvips -> poppler (Dockerfile:16); the
primary path binds poppler-glib via ctypes (vector_backend.py), and this
module renders when poppler-glib is absent. It rasterizes the honest vector subset — classic xref
tables, FlateDecode/raw content streams, path construction (m/l/c/v/y/
re/h), nonzero and even-odd fills, gray/RGB color, q/Q graphics state,
cm transforms, basic stroking — and raises UnsupportedPdf for anything
beyond it (xref streams, encryption, fonts/text, images, shading,
patterns), so complex documents still gate to 406 exactly as a
poppler-less libvips build would refuse them, rather than mis-render.

Geometry matches poppler's pdfload semantics: 72 dpi (1 pt = 1 px),
white page background, PDF y-up flipped to raster y-down.
"""

from __future__ import annotations

import re
import zlib

import numpy as np


class UnsupportedPdf(Exception):
    """Document uses features beyond the vendored subset."""


_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


class _Ref:
    __slots__ = ("num",)

    def __init__(self, num: int):
        self.num = num


class _Lexer:
    """Tokenizer for PDF object syntax (ISO 32000-1 section 7.3)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.d = data
        self.p = pos

    def _skip_ws(self):
        d, p = self.d, self.p
        while p < len(d):
            c = d[p : p + 1]
            if c in b"%":  # comment to EOL
                while p < len(d) and d[p] not in b"\r\n":
                    p += 1
            elif c in _WS:
                p += 1
            else:
                break
        self.p = p

    def parse(self):
        self._skip_ws()
        d, p = self.d, self.p
        if p >= len(d):
            raise UnsupportedPdf("truncated object")
        c = d[p : p + 1]
        if c == b"<" and d[p : p + 2] == b"<<":
            return self._dict()
        if c == b"<":
            return self._hexstring()
        if c == b"[":
            return self._array()
        if c == b"/":
            return self._name()
        if c == b"(":
            return self._litstring()
        if c in b"+-.0123456789":
            return self._number_or_ref()
        word = self._word()
        if word == b"true":
            return True
        if word == b"false":
            return False
        if word == b"null":
            return None
        raise UnsupportedPdf(f"unexpected token {word[:16]!r}")

    def _word(self):
        d, p = self.d, self.p
        s = p
        while p < len(d) and d[p : p + 1] not in _WS and d[p : p + 1] not in _DELIM:
            p += 1
        self.p = p
        return d[s:p]

    def _name(self):
        self.p += 1
        return "/" + self._word().decode("latin-1")

    def _number_or_ref(self):
        first = self._word()
        try:
            n = float(first) if b"." in first else int(first)
        except ValueError:
            raise UnsupportedPdf(f"bad number {first[:16]!r}") from None
        if isinstance(n, int) and n >= 0:
            # lookahead for "G R" (indirect reference)
            save = self.p
            self._skip_ws()
            gen = self._word()
            if gen.isdigit():
                self._skip_ws()
                if self._word() == b"R":
                    return _Ref(n)
            self.p = save
        return n

    def _array(self):
        self.p += 1
        out = []
        while True:
            self._skip_ws()
            if self.d[self.p : self.p + 1] == b"]":
                self.p += 1
                return out
            out.append(self.parse())

    def _dict(self):
        self.p += 2
        out = {}
        while True:
            self._skip_ws()
            if self.d[self.p : self.p + 2] == b">>":
                self.p += 2
                return out
            key = self.parse()
            out[key] = self.parse()

    def _hexstring(self):
        end = self.d.index(b">", self.p)
        raw = re.sub(rb"\s", b"", self.d[self.p + 1 : end])
        self.p = end + 1
        return bytes.fromhex(raw.decode("latin-1") + ("0" if len(raw) % 2 else ""))

    def _litstring(self):
        d, p = self.d, self.p + 1
        depth, out = 1, bytearray()
        while p < len(d) and depth:
            ch = d[p : p + 1]
            if ch == b"\\":
                out += d[p + 1 : p + 2]
                p += 2
                continue
            if ch == b"(":
                depth += 1
            elif ch == b")":
                depth -= 1
                if not depth:
                    p += 1
                    break
            out += ch
            p += 1
        self.p = p
        return bytes(out)


# Decompressed-stream budget: the 64 MB request-body cap bounds what a
# client can SEND, not what a few KB of crafted deflate can EXPAND to
# (zlib tops out around 1000:1, so a 64 MB body could otherwise demand
# ~64 GB). 64 MB of decompressed content is far beyond any honest page's
# content stream in this renderer's subset.
_MAX_STREAM_BYTES = 64 * 1024 * 1024


class _Doc:
    def __init__(self, data: bytes):
        self.d = data
        self.offsets: dict = {}
        self.trailer: dict = {}
        self._cache: dict = {}
        self._resolving: set = set()
        self._parse_xref()

    def _parse_xref(self):
        tail = self.d[-2048:]
        m = list(re.finditer(rb"startxref\s+(\d+)", tail))
        if not m:
            raise UnsupportedPdf("no startxref")
        pos = int(m[-1].group(1))
        seen = set()
        while pos not in seen:
            seen.add(pos)
            if not self.d[pos : pos + 4] == b"xref":
                # cross-reference STREAMS (PDF 1.5 compressed xref) are out
                # of subset — poppler handles them, this fallback refuses
                raise UnsupportedPdf("xref stream (PDF 1.5+) not supported")
            lex = _Lexer(self.d, pos + 4)
            while True:
                lex._skip_ws()
                if self.d[lex.p : lex.p + 7] == b"trailer":
                    lex.p += 7
                    break
                start = lex.parse()
                count = lex.parse()
                lex._skip_ws()
                for i in range(int(count)):
                    ent = self.d[lex.p : lex.p + 20]
                    if len(ent) < 18:
                        raise UnsupportedPdf("short xref entry")
                    off, _gen, kind = ent[:10], ent[11:16], ent[17:18]
                    num = int(start) + i
                    if kind == b"n" and num not in self.offsets:
                        self.offsets[num] = int(off)
                    lex.p += 20
            trailer = lex.parse()
            for k, v in trailer.items():
                self.trailer.setdefault(k, v)
            if "/Prev" in trailer and trailer["/Prev"] not in seen:
                pos = int(trailer["/Prev"])
            else:
                break
        if "/Encrypt" in self.trailer:
            raise UnsupportedPdf("encrypted PDF")

    def obj(self, ref):
        """Resolve a _Ref (or pass through a direct object)."""
        if not isinstance(ref, _Ref):
            return ref
        if ref.num in self._cache:
            return self._cache[ref.num]
        # A /Length (or /Filter) that resolves back into its own object —
        # directly or through a cycle — would recurse here forever; a real
        # renderer refuses such a file, it doesn't RecursionError.
        if ref.num in self._resolving:
            raise UnsupportedPdf("circular reference")
        off = self.offsets.get(ref.num)
        if off is None:
            raise UnsupportedPdf(f"missing object {ref.num}")
        m = re.match(rb"\s*\d+\s+\d+\s+obj", self.d[off : off + 64])
        if not m:
            raise UnsupportedPdf(f"bad object header at {off}")
        self._resolving.add(ref.num)
        try:
            lex = _Lexer(self.d, off + m.end())
            val = lex.parse()
            if isinstance(val, dict):
                lex._skip_ws()
                if self.d[lex.p : lex.p + 6] == b"stream":
                    p = lex.p + 6
                    if self.d[p : p + 2] == b"\r\n":
                        p += 2
                    elif self.d[p : p + 1] in (b"\n", b"\r"):
                        p += 1
                    length = self.obj(val.get("/Length", 0))
                    raw = self.d[p : p + int(length)]
                    val = (val, raw)
        finally:
            self._resolving.discard(ref.num)
        self._cache[ref.num] = val
        return val

    def stream_data(self, sobj) -> bytes:
        meta, raw = sobj
        filt = self.obj(meta.get("/Filter"))
        if filt is None:
            return raw
        filters = filt if isinstance(filt, list) else [filt]
        for f in filters:
            f = self.obj(f)
            if f == "/FlateDecode":
                raw = _bounded_inflate(raw)
            else:
                raise UnsupportedPdf(f"filter {f} not supported")
        return raw


def _bounded_inflate(raw: bytes, budget: int = 0) -> bytes:
    """zlib.decompress with an output cap: inflate in max_length chunks and
    refuse past the budget, so a decompression bomb costs at most the
    budget in memory instead of whatever the deflate stream demands."""
    budget = budget or _MAX_STREAM_BYTES
    dec = zlib.decompressobj()
    out = []
    got = 0
    data = raw
    while True:
        chunk = dec.decompress(data, max(1, min(budget - got + 1, 1 << 20)))
        got += len(chunk)
        if got > budget:
            raise UnsupportedPdf("stream exceeds decompression budget")
        out.append(chunk)
        data = dec.unconsumed_tail
        if dec.eof:
            break
        if not data and not chunk:
            # input exhausted short of the stream end: the strict
            # zlib.decompress this replaces raised on truncation too
            raise UnsupportedPdf("truncated deflate stream")
    return b"".join(out)


def _mat_mul(m1, m2):
    a1, b1, c1, d1, e1, f1 = m1
    a2, b2, c2, d2, e2, f2 = m2
    return (
        a1 * a2 + b1 * c2, a1 * b2 + b1 * d2,
        c1 * a2 + d1 * c2, c1 * b2 + d1 * d2,
        e1 * a2 + f1 * c2 + e2, e1 * b2 + f1 * d2 + f2,
    )


def _apply(m, x, y):
    a, b, c, d, e, f = m
    return (a * x + c * y + e, b * x + d * y + f)


def _flatten_bezier(p0, p1, p2, p3, n=16):
    pts = []
    for i in range(1, n + 1):
        t = i / n
        mt = 1 - t
        x = (mt**3 * p0[0] + 3 * mt**2 * t * p1[0]
             + 3 * mt * t**2 * p2[0] + t**3 * p3[0])
        y = (mt**3 * p0[1] + 3 * mt**2 * t * p1[1]
             + 3 * mt * t**2 * p2[1] + t**3 * p3[1])
        pts.append((x, y))
    return pts


def _fill_polygons(canvas, subpaths, color, evenodd):
    """Scanline fill over the uint8 RGBA canvas (y-down device space)."""
    h, w = canvas.shape[:2]
    edges = []  # (y0, y1, x_at_y0, dx/dy, winding)
    for sp in subpaths:
        if len(sp) < 2:
            continue
        pts = sp + [sp[0]]
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            if y0 == y1:
                continue
            winding = 1 if y1 > y0 else -1
            if y0 > y1:
                x0, y0, x1, y1 = x1, y1, x0, y0
            edges.append((y0, y1, x0, (x1 - x0) / (y1 - y0), winding))
    if not edges:
        return
    ymin = max(0, int(np.floor(min(e[0] for e in edges))))
    ymax = min(h - 1, int(np.ceil(max(e[1] for e in edges))))
    rgb = np.array(color, np.uint8)
    for yi in range(ymin, ymax + 1):
        yc = yi + 0.5
        xs = []
        for y0, y1, x0, slope, winding in edges:
            if y0 <= yc < y1:
                xs.append((x0 + (yc - y0) * slope, winding))
        if not xs:
            continue
        xs.sort()
        if evenodd:
            for i in range(0, len(xs) - 1, 2):
                a = max(0, int(np.ceil(xs[i][0] - 0.5)))
                b = min(w, int(np.floor(xs[i + 1][0] + 0.5)))
                if b > a:
                    canvas[yi, a:b, :3] = rgb
                    canvas[yi, a:b, 3] = 255
        else:  # nonzero winding
            wind = 0
            for i in range(len(xs) - 1):
                wind += xs[i][1]
                if wind != 0:
                    a = max(0, int(np.ceil(xs[i][0] - 0.5)))
                    b = min(w, int(np.floor(xs[i + 1][0] + 0.5)))
                    if b > a:
                        canvas[yi, a:b, :3] = rgb
                        canvas[yi, a:b, 3] = 255


def _stroke_to_fill(subpaths, width):
    """Approximate stroking: each segment becomes a filled quad of the
    stroke width (no joins/caps — the subset's honest limit)."""
    wid = max(width, 0.8) / 2.0
    quads = []
    for sp in subpaths:
        for (x0, y0), (x1, y1) in zip(sp, sp[1:]):
            dx, dy = x1 - x0, y1 - y0
            ln = (dx * dx + dy * dy) ** 0.5
            if ln == 0:
                continue
            nx, ny = -dy / ln * wid, dx / ln * wid
            quads.append([(x0 + nx, y0 + ny), (x1 + nx, y1 + ny),
                          (x1 - nx, y1 - ny), (x0 - nx, y0 - ny)])
    return quads


_OP_RE = re.compile(rb"[^\s()<>\[\]{}/%]+|\(|<|\[|/|%")

# operators consumed with no effect (honest no-ops for fills-only output)
_NOOP_OPS = {b"j", b"J", b"M", b"d", b"ri", b"i", b"gs", b"cs", b"CS"}
# clipping (W/W*) is OUT of subset: silently ignoring it would paint
# content real renderers clip away — refuse, per the module charter
_UNSUPPORTED_OPS = {b"BT", b"Do", b"sh", b"BI", b"scn", b"SCN", b"W", b"W*"}


def _exec_content(data: bytes, canvas, base_ctm):
    lex = _Lexer(data)
    stack: list = []
    ctm = base_ctm
    gstack: list = []
    fill_rgb = (0, 0, 0)
    stroke_rgb = (0, 0, 0)
    line_width = 1.0
    subpaths: list = []
    cur: list = []
    start_pt = None
    last_pt = (0.0, 0.0)

    def dev(x, y):
        return _apply(ctm, x, y)

    def flush_path():
        nonlocal subpaths, cur, start_pt
        if cur:
            subpaths.append(cur)
        subpaths, cur, start_pt = [], [], None
        return

    while True:
        lex._skip_ws()
        if lex.p >= len(lex.d):
            break
        c = lex.d[lex.p : lex.p + 1]
        if c in b"+-.0123456789([</":
            stack.append(lex.parse())
            continue
        op = lex._word()
        if not op:
            break
        if op in _UNSUPPORTED_OPS:
            raise UnsupportedPdf(f"operator {op.decode('latin-1')} not in subset")
        if op == b"q":
            gstack.append((ctm, fill_rgb, stroke_rgb, line_width))
        elif op == b"Q":
            if gstack:
                ctm, fill_rgb, stroke_rgb, line_width = gstack.pop()
        elif op == b"cm":
            m = tuple(float(v) for v in stack[-6:])
            ctm = _mat_mul(m, ctm)
        elif op == b"w":
            line_width = float(stack[-1])
        elif op == b"g":
            v = int(round(float(stack[-1]) * 255))
            fill_rgb = (v, v, v)
        elif op == b"G":
            v = int(round(float(stack[-1]) * 255))
            stroke_rgb = (v, v, v)
        elif op == b"rg":
            fill_rgb = tuple(int(round(float(v) * 255)) for v in stack[-3:])
        elif op == b"RG":
            stroke_rgb = tuple(int(round(float(v) * 255)) for v in stack[-3:])
        elif op == b"m":
            if cur:
                subpaths.append(cur)
            x, y = float(stack[-2]), float(stack[-1])
            cur = [dev(x, y)]
            start_pt = cur[0]
            last_pt = (x, y)
        elif op == b"l":
            x, y = float(stack[-2]), float(stack[-1])
            cur.append(dev(x, y))
            last_pt = (x, y)
        elif op in (b"c", b"v", b"y"):
            vals = [float(v) for v in stack[-(6 if op == b"c" else 4):]]
            if op == b"c":
                p1, p2, p3 = vals[0:2], vals[2:4], vals[4:6]
            elif op == b"v":
                p1, p2, p3 = list(last_pt), vals[0:2], vals[2:4]
            else:  # y
                p1, p2, p3 = vals[0:2], vals[2:4], vals[2:4]
            cur.extend(
                _flatten_bezier(dev(*last_pt), dev(*p1), dev(*p2), dev(*p3))
            )
            last_pt = tuple(p3)
        elif op == b"h":
            if cur and start_pt:
                cur.append(start_pt)
        elif op == b"re":
            x, y, rw, rh = (float(v) for v in stack[-4:])
            if cur:
                subpaths.append(cur)
                cur = []
            subpaths.append([dev(x, y), dev(x + rw, y), dev(x + rw, y + rh),
                             dev(x, y + rh)])
        elif op in (b"f", b"F", b"f*", b"b", b"B", b"b*", b"B*"):
            if cur:
                subpaths.append(cur)
                cur = []
            _fill_polygons(canvas, subpaths, fill_rgb, op in (b"f*", b"b*", b"B*"))
            if op in (b"b", b"B", b"b*", b"B*"):
                for q in _stroke_to_fill(subpaths, line_width):
                    _fill_polygons(canvas, [q], stroke_rgb, False)
            flush_path()
        elif op in (b"S", b"s"):
            if cur:
                subpaths.append(cur)
                cur = []
            for q in _stroke_to_fill(subpaths, line_width):
                _fill_polygons(canvas, [q], stroke_rgb, False)
            flush_path()
        elif op == b"n":
            # no-paint path-painting operator: ENDS the path (a clip-less
            # "re n" must not leak its rectangle into the next fill)
            flush_path()
        elif op in _NOOP_OPS:
            pass
        else:
            raise UnsupportedPdf(f"operator {op.decode('latin-1')} not in subset")
        stack.clear()


def rasterize(buf: bytes, page_index: int = 0) -> np.ndarray:
    """First page -> RGBA uint8 at 72 dpi over a white background
    (poppler pdfload geometry). Raises UnsupportedPdf both beyond the
    subset and for malformed input (corrupt bytes are a refusal, not a
    crash); genuine bug classes (RecursionError, MemoryError,
    AssertionError) propagate so the fuzz suite can catch them."""
    try:
        return _rasterize(buf, page_index)
    except (UnsupportedPdf, RecursionError, MemoryError, AssertionError):
        raise
    except Exception as e:
        raise UnsupportedPdf(f"malformed pdf: {type(e).__name__}") from e


def _rasterize(buf: bytes, page_index: int) -> np.ndarray:
    doc = _Doc(buf)
    root = doc.obj(doc.trailer.get("/Root"))
    if not isinstance(root, dict):
        raise UnsupportedPdf("no document catalog")
    pages = doc.obj(root.get("/Pages"))
    kids = doc.obj(pages.get("/Kids", []))
    if not kids or page_index >= len(kids):
        raise UnsupportedPdf("no such page")
    page = doc.obj(kids[page_index])
    media = [float(doc.obj(v)) for v in doc.obj(page.get("/MediaBox", pages.get("/MediaBox", [0, 0, 612, 792])))]
    w = max(1, int(round(media[2] - media[0])))
    h = max(1, int(round(media[3] - media[1])))
    if w * h > 50_000_000:
        raise UnsupportedPdf("page too large for fallback renderer")
    canvas = np.zeros((h, w, 4), np.uint8)
    canvas[..., :3] = 255
    canvas[..., 3] = 255
    # PDF user space is y-up with origin at MediaBox lower-left; raster is
    # y-down: flip via the base CTM
    base_ctm = (1.0, 0.0, 0.0, -1.0, -media[0], media[3])
    contents = doc.obj(page.get("/Contents"))
    chunks = contents if isinstance(contents, list) else [contents]
    data = b"\n".join(doc.stream_data(doc.obj(cobj) if isinstance(cobj, _Ref) else cobj)
                      for cobj in chunks)
    _exec_content(data, canvas, base_ctm)
    return canvas
