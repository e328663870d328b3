"""Request-level image options model (the port's copy of `imaginary_tpu/options.py`).

Behavioral contract from options.go:11-125 and params.go enum parsing:
`ImageOptions` has a first-class field per request parameter, a parallel
`defined` set tracking which tri-state booleans were present in the request
(options.go:56-68), pipeline operation records, and aspect-ratio derivation.

The reference's quirks we intentionally preserve (SURVEY.md section 2.13):
  * aspect-ratio math uses truncating integer division in the reference
    (`width / arW * arH`, options.go:92-94); we reproduce it exactly so
    documented behavior (and any cached URLs) keep their output dimensions.
  * builders default extend to COPY (params.go:342,356) while the `extend`
    parameter itself defaults to MIRROR for unknown values (params.go:435).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Gravity(enum.Enum):
    """Crop anchor (ref: params.go:439-453)."""

    CENTRE = "centre"
    NORTH = "north"
    SOUTH = "south"
    EAST = "east"
    WEST = "west"
    SMART = "smart"


class Extend(enum.Enum):
    """Canvas extension mode for embedding (ref: params.go:421-437)."""

    BLACK = "black"
    COPY = "copy"
    MIRROR = "mirror"
    WHITE = "white"
    LAST = "lastpixel"
    BACKGROUND = "background"


class Colorspace(enum.Enum):
    """Output interpretation (ref: params.go:392-397)."""

    SRGB = "srgb"
    BW = "bw"


@dataclasses.dataclass
class PipelineOperation:
    """One JSON pipeline stage (ref: options.go:71-80)."""

    name: str = ""
    ignore_failure: bool = False
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ImageOptions:
    """All supported request parameters (ref: options.go:11-52)."""

    width: int = 0
    height: int = 0
    area_width: int = 0
    area_height: int = 0
    quality: int = 0
    compression: int = 0
    rotate: int = 0
    top: int = 0
    left: int = 0
    margin: int = 0
    factor: int = 0
    dpi: int = 0
    text_width: int = 0
    flip: bool = False
    flop: bool = False
    force: bool = False
    embed: bool = False
    no_crop: bool = False
    no_replicate: bool = False
    no_rotation: bool = False
    no_profile: bool = False
    strip_metadata: bool = False
    interlace: bool = False
    palette: bool = False
    opacity: float = 0.0
    sigma: float = 0.0
    min_ampl: float = 0.0
    speed: int = 0
    text: str = ""
    image: str = ""
    font: str = ""
    type: str = ""
    aspect_ratio: str = ""
    color: tuple = ()
    background: tuple = ()
    extend: Extend = Extend.MIRROR
    gravity: Gravity = Gravity.CENTRE
    colorspace: Colorspace = Colorspace.SRGB
    operations: list = dataclasses.field(default_factory=list)
    # Which tri-state boolean params were present in the request
    # (ref: IsDefinedField, options.go:56-68).
    defined: set = dataclasses.field(default_factory=set)

    def is_defined(self, field: str) -> bool:
        return field in self.defined

    def mark_defined(self, field: str) -> None:
        self.defined.add(field)


def parse_aspect_ratio(val: str) -> Optional[dict]:
    """`"16:9"` -> {"width":16,"height":9} (ref: options.go:100-115)."""
    val = val.strip().lower()
    parts = val.split(":")
    if len(parts) < 2:
        return None

    def _atoi(s: str) -> int:
        # Go's strconv.Atoi: optional sign + ASCII digits only; errors are
        # ignored upstream and yield 0. Python int() is laxer (whitespace,
        # underscores), so gate explicitly.
        body = s[1:] if s[:1] in ("+", "-") else s
        if not body or not all("0" <= c <= "9" for c in body):
            return 0
        return int(s)

    return {"width": _atoi(parts[0]), "height": _atoi(parts[1])}


def should_transform_by_aspect_ratio(width: int, height: int) -> bool:
    """Only when exactly one of width/height is given (ref: options.go:117-125)."""
    if (width != 0 and height != 0) or (width == 0 and height == 0):
        return False
    return True


def transform_by_aspect_ratio(width: int, height: int, ratio: Optional[dict]) -> tuple:
    """Derive the missing dimension from the aspect ratio.

    Reproduces the reference's truncating integer-division order
    (`w // arW * arH`, options.go:82-98) including its division-by-zero
    hazard, which we guard by returning the inputs unchanged.
    """
    if not ratio:
        return width, height
    ar_w, ar_h = ratio.get("width", 0), ratio.get("height", 0)
    if width != 0:
        if ar_w == 0:
            return width, height
        height = width // ar_w * ar_h
    else:
        if ar_h == 0:
            return width, height
        width = height // ar_h * ar_w
    return width, height


def apply_aspect_ratio(o: ImageOptions) -> tuple:
    """Final (width, height) after aspect-ratio derivation (ref: options.go:155-162)."""
    w, h = o.width, o.height
    if should_transform_by_aspect_ratio(w, h) and o.aspect_ratio:
        w, h = transform_by_aspect_ratio(w, h, parse_aspect_ratio(o.aspect_ratio))
    return w, h
