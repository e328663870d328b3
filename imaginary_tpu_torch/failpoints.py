"""Fault injection for the port (a trimmed copy of
`imaginary_tpu/failpoints.py:244-355`).

One site is ported, the one the lane tier and its fault domains drive:

  device.chip_error  one chunk launch on one mesh entry, and that
                     entry's re-admission probe (engine/executor.py);
                     keyable by the entry's flat index:
                     `device.chip_error[1]=error` fails entry 1 alone.

Spec grammar: `site=action` clauses joined by `;`, where action is
`error` or `error(p)` (fire with probability p). A bare site matches
every key. `hit()` is one falsy check while nothing is armed.
"""

from __future__ import annotations

import random
import re
import threading
from typing import Optional

SITES = ("device.chip_error",)

_KEYED_SITE_RE = re.compile(r"^([\w.]+)\[(\w+)\]$")


class FailpointError(RuntimeError):
    """An injected fault. It surfaces through the same exception paths a
    real device failure takes."""


def _parse_action(text: str) -> float:
    """The firing probability of an `error` / `error(p)` action."""
    m = re.match(r"^error(?:\((.*)\))?$", text.strip())
    if not m:
        raise ValueError(f"bad action {text!r} (want error or error(p))")
    p = float(m.group(1)) if m.group(1) else 1.0
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"error probability {p} outside [0, 1]")
    return p


def parse(spec: str) -> dict:
    """Parse a spec into {site: probability}; raises ValueError on an
    unknown site or a malformed clause."""
    out: dict = {}
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad failpoint clause {part!r} (want site=action)")
        site, action = (s.strip() for s in part.split("=", 1))
        m = _KEYED_SITE_RE.match(site)
        base = m.group(1) if m else site
        if base not in SITES:
            raise ValueError(
                f"unknown failpoint site {base!r} (known: {', '.join(SITES)})")
        out[site] = _parse_action(action)
    return out


# Swapped whole on (de)activation, so hit() reads it without a lock.
_active: dict = {}
_lock = threading.Lock()


def activate(spec: str) -> None:
    """Arm the failpoints described by `spec`; an empty spec disarms."""
    global _active
    parsed = parse(spec)
    with _lock:
        _active = parsed


def deactivate() -> None:
    global _active
    with _lock:
        _active = {}


def hit(site: str, key=None) -> None:
    """Raise FailpointError when `site` (or its `site[key]` spelling) is
    armed and fires; a no-op otherwise."""
    active = _active
    if not active:
        return
    p: Optional[float] = active.get(f"{site}[{key}]") if key is not None else None
    if p is None:
        p = active.get(site)
    if p is None or (p < 1.0 and random.random() >= p):
        return
    raise FailpointError(f"failpoint {site}: injected error")
