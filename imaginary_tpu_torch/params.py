"""Request-parameter coercion (the port's copy of `imaginary_tpu/params.py`).

Behavioral contract from params.go:20-453: a table maps the 39 supported
parameter names to typed coercers shared by the URL query string and the
pipeline JSON `params` objects. Unknown keys are silently ignored; a coercion
failure aborts the request with HTTP 400.

Reference quirks preserved on purpose (they are tested upstream,
params_test.go:43-100):
  * `parse_int`/`parse_float` take the ABSOLUTE value ("-100" -> 100) and
    ints round half-up (params.go:376-390).
  * `parse_color` clamps overflowing components to 255 and maps unparsable
    components to 0 (params.go:399-409 via Go strconv.ParseUint semantics).
  * `parse_bool("")` is False; otherwise Go strconv.ParseBool tokens only.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Mapping

from imaginary_tpu_torch.options import (
    Colorspace,
    Extend,
    Gravity,
    ImageOptions,
    PipelineOperation,
)


class ParamError(ValueError):
    """A request parameter failed coercion (rendered as HTTP 400)."""


_UNSUPPORTED = "unsupported value"


# --- scalar parsers (ref: params.go:369-409) ---------------------------------

_BOOL_TOKENS = {
    "1": True, "t": True, "T": True, "true": True, "TRUE": True, "True": True,
    "0": False, "f": False, "F": False, "false": False, "FALSE": False, "False": False,
}


def parse_bool(val: str) -> bool:
    """Go strconv.ParseBool with empty-string -> False (ref: params.go:369-374)."""
    if val == "":
        return False
    try:
        return _BOOL_TOKENS[val]
    except KeyError:
        raise ParamError(f"invalid boolean value: {val!r}") from None


def parse_float(val: str) -> float:
    """Absolute float value; empty -> 0.0 (ref: params.go:384-390).

    NaN/Infinity are rejected with a 400 (deliberate divergence: Go's
    strconv.ParseFloat admits them and downstream int conversion is
    undefined; a 400 is the only sane rendering).
    """
    if val == "":
        return 0.0
    try:
        f = abs(float(val))
    except ValueError:
        raise ParamError(f"invalid number: {val!r}") from None
    if f != f or f == float("inf"):
        raise ParamError(f"invalid number: {val!r}")
    return f


def parse_int(val: str) -> int:
    """Absolute value, round half-up; empty -> 0 (ref: params.go:376-382)."""
    if val == "":
        return 0
    import math

    return int(math.floor(parse_float(val) + 0.5))


def parse_color(val: str) -> tuple:
    """CSV of uint8 components (ref: params.go:399-409).

    Mirrors Go strconv.ParseUint(_, 10, 8): syntax errors (including
    negatives) yield 0, range overflow clamps to 255.
    """
    if not val:
        return ()
    out = []
    for raw in val.split(","):
        tok = raw.strip()
        # ASCII digits only, matching Go strconv.ParseUint (no unicode digits).
        if tok and all("0" <= c <= "9" for c in tok):
            out.append(min(int(tok), 255))
        else:
            out.append(0)
    return tuple(out)


def parse_colorspace(val: str) -> Colorspace:
    """`bw` -> BW else SRGB (ref: params.go:392-397)."""
    return Colorspace.BW if val == "bw" else Colorspace.SRGB


def parse_extend_mode(val: str) -> Extend:
    """Unknown/empty -> MIRROR (ref: params.go:421-437)."""
    val = val.strip().lower()
    return {
        "white": Extend.WHITE,
        "black": Extend.BLACK,
        "copy": Extend.COPY,
        "background": Extend.BACKGROUND,
        "lastpixel": Extend.LAST,
    }.get(val, Extend.MIRROR)


def parse_gravity(val: str) -> Gravity:
    """Unknown/empty -> CENTRE (ref: params.go:439-453)."""
    val = val.strip().lower()
    return {
        "south": Gravity.SOUTH,
        "north": Gravity.NORTH,
        "east": Gravity.EAST,
        "west": Gravity.WEST,
        "smart": Gravity.SMART,
    }.get(val, Gravity.CENTRE)


def parse_json_operations(data: str) -> list:
    """Pipeline JSON -> [PipelineOperation]; unknown fields rejected
    (ref: params.go:411-419, DisallowUnknownFields)."""
    if len(data) < 2:
        return []

    def _reject_constant(token: str):
        # Go's encoding/json rejects NaN/Infinity literals; so do we.
        raise ParamError(f"invalid operations JSON: constant {token}")

    try:
        raw = json.loads(data, parse_constant=_reject_constant)
    except json.JSONDecodeError as e:
        raise ParamError(f"invalid operations JSON: {e}") from None
    if not isinstance(raw, list):
        raise ParamError("operations JSON must be a list")
    ops = []
    allowed = {"operation", "ignore_failure", "params"}
    for item in raw:
        if not isinstance(item, dict):
            raise ParamError("operation entries must be objects")
        unknown = set(item) - allowed
        if unknown:
            raise ParamError(f"unknown operation field: {sorted(unknown)[0]}")
        params = item.get("params") or {}
        if not isinstance(params, dict):
            raise ParamError("operation params must be an object")
        name = item.get("operation", "")
        if not isinstance(name, str):
            raise ParamError("operation name must be a string")
        ignore = item.get("ignore_failure", False)
        if not isinstance(ignore, bool):
            # Go decodes into a typed bool field and errors on mismatch.
            raise ParamError("ignore_failure must be a boolean")
        ops.append(PipelineOperation(name=name, ignore_failure=ignore, params=params))
    return ops


# --- generic coercers (ref: params.go:63-102) --------------------------------

def _coerce_int(v: Any) -> int:
    if isinstance(v, bool):
        raise ParamError(_UNSUPPORTED)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if v != v or abs(v) == float("inf"):
            raise ParamError(_UNSUPPORTED)
        return int(v)  # Go truncates float64 -> int
    if isinstance(v, str):
        return parse_int(v)
    raise ParamError(_UNSUPPORTED)


def _coerce_float(v: Any) -> float:
    if isinstance(v, bool):
        raise ParamError(_UNSUPPORTED)
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        return parse_float(v)
    raise ParamError(_UNSUPPORTED)


def _coerce_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return parse_bool(v)
    raise ParamError(_UNSUPPORTED)


def _coerce_string(v: Any) -> str:
    if isinstance(v, str):
        return v
    raise ParamError(_UNSUPPORTED)


def _coerce_string_only(fn: Callable[[str], Any]) -> Callable[[Any], Any]:
    def inner(v: Any) -> Any:
        if isinstance(v, str):
            return fn(v)
        raise ParamError(_UNSUPPORTED)

    return inner


# --- the coercion table (ref: params.go:20-60) -------------------------------

# param key -> (ImageOptions field, coercer, marks-defined)
_INT = _coerce_int
_FLOAT = _coerce_float
_BOOL = _coerce_bool
_STR = _coerce_string

PARAM_COERCIONS: Mapping[str, tuple] = {
    "width": ("width", _INT, False),
    "height": ("height", _INT, False),
    "quality": ("quality", _INT, False),
    "top": ("top", _INT, False),
    "left": ("left", _INT, False),
    "areawidth": ("area_width", _INT, False),
    "areaheight": ("area_height", _INT, False),
    "compression": ("compression", _INT, False),
    "rotate": ("rotate", _INT, False),
    "margin": ("margin", _INT, False),
    "factor": ("factor", _INT, False),
    "dpi": ("dpi", _INT, False),
    "textwidth": ("text_width", _INT, False),
    "opacity": ("opacity", _FLOAT, False),
    "flip": ("flip", _BOOL, True),
    "flop": ("flop", _BOOL, True),
    "nocrop": ("no_crop", _BOOL, True),
    "noprofile": ("no_profile", _BOOL, True),
    "norotation": ("no_rotation", _BOOL, True),
    "noreplicate": ("no_replicate", _BOOL, True),
    "force": ("force", _BOOL, True),
    "embed": ("embed", _BOOL, True),
    "stripmeta": ("strip_metadata", _BOOL, True),
    "interlace": ("interlace", _BOOL, True),
    "palette": ("palette", _BOOL, True),
    "text": ("text", _STR, False),
    "image": ("image", _STR, False),
    "font": ("font", _STR, False),
    "type": ("type", _STR, False),
    "aspectratio": ("aspect_ratio", _STR, False),
    "color": ("color", _coerce_string_only(parse_color), False),
    "background": ("background", _coerce_string_only(parse_color), False),
    "colorspace": ("colorspace", _coerce_string_only(parse_colorspace), False),
    "gravity": ("gravity", _coerce_string_only(parse_gravity), False),
    "extend": ("extend", _coerce_string_only(parse_extend_mode), False),
    "sigma": ("sigma", _FLOAT, False),
    "minampl": ("min_ampl", _FLOAT, False),
    "operations": ("operations", _coerce_string_only(parse_json_operations), False),
    "speed": ("speed", _INT, False),
}


def _apply(options: ImageOptions, key: str, value: Any) -> None:
    field, coercer, marks = PARAM_COERCIONS[key]
    try:
        setattr(options, field, coercer(value))
    except ParamError as e:
        raise ParamError(f"error processing parameter {key!r} with value {value!r}: {e}") from None
    if marks:
        options.mark_defined(field)


def build_params_from_query(query: Mapping[str, Any]) -> ImageOptions:
    """URL query -> ImageOptions (ref: params.go:354-366).

    `query` maps key -> first value (multi-valued keys collapse to the first,
    matching Go's url.Values.Get).
    """
    options = ImageOptions()
    options.extend = Extend.COPY  # builder default (params.go:356)
    for key, value in query.items():
        if key in PARAM_COERCIONS:
            if isinstance(value, (list, tuple)):
                value = value[0] if value else ""
            _apply(options, key, value)
    return options


def build_params_from_operation(op: PipelineOperation) -> ImageOptions:
    """Pipeline stage params -> ImageOptions (ref: params.go:340-352)."""
    options = ImageOptions()
    options.extend = Extend.COPY  # the reference parser's default (params.go:342)
    for key, value in op.params.items():
        if key in PARAM_COERCIONS:
            _apply(options, key, value)
    return options
