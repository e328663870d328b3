"""Host-side text rasterization for text watermarks.

The port's copy of `imaginary_tpu/ops/text.py`, searching the system
font directories only. The reference renders text via libvips/pango
(image.go:322-341, opts.Watermark fields). Rasterization is inherently
host work; the rendered RGBA block ships to the device in the chunk's one
copy, where CompositeSpec (kernel K7) alpha-blends (and optionally tiles)
it. PIL's bitmap font engine plays pango's role.
"""

from __future__ import annotations

import functools
import glob
import os

import numpy as np
from PIL import Image, ImageDraw, ImageFont

_DEFAULT_POINT = 12.0

# pango generic families -> truetype file stems searched on the host.
# (pango resolves via fontconfig; we resolve against the font dirs below —
# DejaVu is the stock family on the deploy image.)
_FAMILIES = {
    "sans": ("DejaVuSans", "LiberationSans", "Arial"),
    "sans-serif": ("DejaVuSans", "LiberationSans", "Arial"),
    "serif": ("DejaVuSerif", "LiberationSerif", "TimesNewRoman"),
    "mono": ("DejaVuSansMono", "LiberationMono", "CourierNew"),
    "monospace": ("DejaVuSansMono", "LiberationMono", "CourierNew"),
}

_FONT_DIRS = (
    "/usr/share/fonts",
    "/usr/local/share/fonts",
)


@functools.lru_cache(maxsize=1)
def _font_index() -> dict:
    """lowercase file stem -> path for every TTF visible on the host."""
    index: dict = {}
    for d in _FONT_DIRS:
        for path in glob.glob(os.path.join(d, "**", "*.ttf"), recursive=True):
            index.setdefault(os.path.splitext(os.path.basename(path))[0].lower(), path)
    return index


def _parse_font_spec(spec: str):
    """Parse a pango-style spec: "family [styles...] [size]".

    e.g. "sans bold 16", "DejaVu Serif 12", "monospace". Returns
    (family_words, bold, italic, size_pt). Ref: the reference passes the
    spec through to pango via vips_text (image.go:328-338)."""
    size = _DEFAULT_POINT
    words = (spec or "").split()
    if words:
        try:
            size = float(words[-1])
            words = words[:-1]
        except ValueError:
            pass
    bold = any(w.lower() in ("bold", "semibold", "heavy") for w in words)
    italic = any(w.lower() in ("italic", "oblique") for w in words)
    fam = [w for w in words if w.lower() not in
           ("bold", "semibold", "heavy", "italic", "oblique", "normal", "regular")]
    return fam, bold, italic, size


def _resolve_font_path(fam: list, bold: bool, italic: bool):
    index = _font_index()
    stems: list = []
    fam_key = " ".join(fam).lower()
    for candidate in _FAMILIES.get(fam_key, ()):  # generic family
        stems.append(candidate)
    if fam:  # literal family name, spaces stripped ("DejaVu Serif" -> DejaVuSerif)
        stems.append("".join(fam))
    stems.extend(_FAMILIES["sans"])  # last resort: any sans on the host
    suffixes = []
    if bold and italic:
        suffixes += ["-bolditalic", "-boldoblique"]
    if bold:
        suffixes += ["-bold"]
    if italic:
        suffixes += ["-italic", "-oblique"]
    # regular weight is a suffix in many families (LiberationSans-Regular.ttf)
    suffixes += ["", "-regular", "-book"]
    for stem in stems:
        for suf in suffixes:
            path = index.get((stem + suf).lower())
            if path:
                return path
    return None


@functools.lru_cache(maxsize=64)
def _load_font(spec: str, dpi: int):
    """`"sans bold 12"` pango-style font spec (ref README watermark `font`
    param; reference renders via pango, image.go:328-338) resolved against
    host truetype fonts; PIL's bitmap default only when no TTF exists."""
    fam, bold, italic, size = _parse_font_spec(spec)
    px = max(6, int(round(size * (dpi or 72) / 72.0)))
    path = _resolve_font_path(fam, bold, italic)
    if path:
        try:
            return ImageFont.truetype(path, px)
        # any TTF load failure (corrupt font, old FreeType) falls back to PIL's default font
        except Exception:
            pass
    try:
        return ImageFont.load_default(size=px)
    except Exception:  # pragma: no cover - ancient PIL
        return ImageFont.load_default()


def rasterize_text(text: str, font: str, dpi: int, text_width: int,
                   color: tuple, max_w: int, max_h: int) -> np.ndarray:
    """Render text to an RGBA uint8 block, word-wrapped to text_width px."""
    fnt = _load_font(font or "sans 12", dpi or 72)
    text_width = max(16, min(text_width or max_w, max_w))

    # word-wrap with a probe draw
    probe = ImageDraw.Draw(Image.new("RGBA", (8, 8)))
    lines, line = [], ""
    for word in text.split():
        cand = (line + " " + word).strip()
        if probe.textlength(cand, font=fnt) <= text_width or not line:
            line = cand
        else:
            lines.append(line)
            line = word
    if line:
        lines.append(line)
    if not lines:
        lines = [""]

    asc, desc = fnt.getmetrics() if hasattr(fnt, "getmetrics") else (12, 4)
    lh = asc + desc + 2
    bw = int(min(max_w, max(probe.textlength(ln, font=fnt) for ln in lines) + 4))
    bh = int(min(max_h, lh * len(lines) + 4))
    img = Image.new("RGBA", (max(bw, 8), max(bh, 8)), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    rgb = tuple(int(c) for c in color[:3]) if len(color) >= 3 else (255, 255, 255)
    for i, ln in enumerate(lines):
        draw.text((2, 2 + i * lh), ln, font=fnt, fill=rgb + (255,))
    return np.asarray(img, dtype=np.uint8)
