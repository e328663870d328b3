"""Fault injection for the port (a trimmed copy of
`imaginary_tpu/failpoints.py`).

Every site of the reference is ported:

  source.fetch       one remote ?url= or watermark GET attempt
                     (web/sources.py);
  source.head        the HEAD size pre-check (web/sources.py);
  qos.admit          the admission gate (web/handlers.py): an injected
                     error sheds the request (503 + Retry-After, the
                     overload contract), with qos on or off;
  codec.decode       the host decode of each transport (pipeline.py,
                     pool thread);
  codec.encode       the host encode (pipeline.py, pool thread);
  codec.bomb         the pre-decode dimension gate (codecs/__init__.py):
                     an injected error rejects the decode 413, as a
                     header-dimension bomb is;
  memory.rss         the pressure governor's RSS sample
                     (engine/pressure.py): an injected error reads as RSS
                     at the ceiling, driving the brownout ladder without
                     exhausting the host;
  executor.submit    the micro-batch executor's entry
                     (engine/executor.py);
  device.execute     the global collector's dispatch, before the launch
                     (engine/executor.py): delay() models a slow device
                     or link, error() a failed dispatch (one device
                     failure, the chunk's futures fail);
  device.chip_error  one chunk launch on one device (the global ladder's
                     pick or a lane's mesh entry), and that device's
                     probe (engine/executor.py); keyable by the device's
                     index: `device.chip_error[1]=error` fails entry 1
                     alone;
  device.oom         one chunk launch and each bisection retry on one
                     device, keyable: an injected error reads as a
                     capacity error (chain.is_oom_error) and takes the
                     bisection, never the breaker;
  device.corrupt     one drained chunk's outputs and the golden probe's,
                     keyable: an armed error() makes the executor flip
                     the high bit of a quarter of each output's bytes
                     (integrity.corrupt_copy), before verification;
  device.slow        one device's chunk launches and golden probes,
                     keyable: delay() makes that device limp, the shape
                     fail-slow demotion exists for;
  host.spill         the host interpreter's run in the spill branch
                     (engine/executor.py): an error falls back to the
                     device, counted in spill_errors;
  cache.get          any cache tier's lookup (cache.py ByteBudgetLRU):
                     every consumer reads an injected error as a miss;
  fleet.write        inside a shared-cache slot deposit, between acquire
                     and seal (fleet/shmcache.py), keyable by worker
                     index: delay() with a SIGKILL leaves a real torn
                     slot, error() abandons the deposit cleanly;
  worker.zombie      the shared-cache publish gate (fleet/shmcache.py),
                     keyable by worker index: an injected error makes the
                     worker behave as a deposed zombie (publish refused,
                     counted as fenced);
  fleet.claim        the fleet-singleflight claim acquire
                     (fleet/shmcache.py), keyable by worker index: an
                     error() fails open to an uncoordinated local run;
  fleet.forward      the ownership forward hop, client side, before the
                     dial (fleet/ownership.py), keyable by the owner's
                     worker index: an error() forces the local fallback,
                     a delay() burns the hop budget;
  worker.hang        the /health handler, synchronously
                     (web/handlers.py): a delay() blocks the worker's
                     event loop for its duration, the "process alive,
                     loop wedged" failure the supervisor's liveness probe
                     exists to catch;
  peer.forward       the cross-host forward and spill hop, client side,
                     before the dial (fleet/router.py), keyable by the
                     owning peer's host id: an error() forces the local
                     run, a delay() burns the hop budget against the
                     request deadline;
  peer.health        one gossip probe of a peer's /fleetz
                     (fleet/multihost.py): an error() makes that peer
                     read dead, so routing and spillover go around it.

Spec grammar: `site=action` clauses joined by `;`, where action is

  error["(" P ")"]           raise FailpointError, with probability P
                             (default 1);
  delay "(" DURATION ")"     sleep DURATION, then go on normally;
  timeout["(" DURATION ")"]  sleep DURATION (default 60s), then raise
                             TimeoutError (asyncio.TimeoutError at an
                             async site, so the caller's timeout mapping
                             fires);
  once "(" ACTION ")"        fire the wrapped action exactly once;

and DURATION is a number with `ms` or `s` (200ms, 1.5s). A bare site
matches every key. `hit()` and `ahit()` are one falsy check while
nothing is armed. `snapshot()` reports each armed site's hits and
firings, spent `once` sites included.
"""

from __future__ import annotations

import asyncio
import random
import re
import threading
import time
from typing import Optional

SITES = ("source.fetch", "source.head", "qos.admit", "codec.decode", "codec.encode",
         "codec.bomb", "memory.rss", "executor.submit", "device.execute",
         "device.chip_error", "host.spill", "device.oom", "device.corrupt",
         "device.slow", "cache.get", "fleet.write", "worker.zombie", "fleet.claim",
         "fleet.forward", "worker.hang", "peer.forward", "peer.health")

# a key is a device or worker index, or a host id (letters, digits, _ and -)
_KEYED_SITE_RE = re.compile(r"^([\w.]+)\[([\w-]+)\]$")
_DURATION_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s)$")
_DEFAULT_TIMEOUT_S = 60.0


class FailpointError(RuntimeError):
    """An injected fault. It surfaces through the same exception paths a
    real failure takes."""


class _Spec:
    __slots__ = ("kind", "p", "duration_s", "once", "raw")

    def __init__(self, kind: str, p: float = 1.0, duration_s: float = 0.0,
                 once: bool = False, raw: str = ""):
        self.kind = kind  # error | delay | timeout
        self.p = p
        self.duration_s = duration_s
        self.once = once
        self.raw = raw


def _parse_duration(text: str) -> float:
    m = _DURATION_RE.match(text.strip())
    if not m:
        raise ValueError(f"bad duration {text!r} (want e.g. 200ms or 1.5s)")
    v = float(m.group(1))
    return v / 1000.0 if m.group(2) == "ms" else v


def _parse_action(text: str) -> _Spec:
    text = text.strip()
    m = re.match(r"^(\w+)(?:\((.*)\))?$", text)
    if not m:
        raise ValueError(f"bad action {text!r}")
    name, arg = m.group(1), m.group(2)
    if name == "once":
        if not arg:
            raise ValueError("once needs a wrapped action, e.g. once(error)")
        inner = _parse_action(arg)
        inner.once = True
        inner.raw = text
        return inner
    if name == "error":
        p = float(arg) if arg else 1.0
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"error probability {p} outside [0, 1]")
        return _Spec("error", p=p, raw=text)
    if name == "delay":
        if not arg:
            raise ValueError("delay needs a duration, e.g. delay(200ms)")
        return _Spec("delay", duration_s=_parse_duration(arg), raw=text)
    if name == "timeout":
        dur = _parse_duration(arg) if arg else _DEFAULT_TIMEOUT_S
        return _Spec("timeout", duration_s=dur, raw=text)
    raise ValueError(f"unknown failpoint action {name!r} "
                     "(want error, delay, timeout or once)")


def parse(spec: str) -> dict:
    """Parse a spec into {site: _Spec}; raises ValueError on an unknown
    site or a malformed clause."""
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
# _counts ({site: [hits, fired]}) outlives deactivation until the next
# activate, so a finished run can still be read.
_active: dict = {}
_counts: dict = {}
_lock = threading.Lock()


def activate(spec: str) -> None:
    """Arm the failpoints described by `spec`; an empty spec disarms."""
    global _active, _counts
    parsed = parse(spec)
    with _lock:
        _active = parsed
        _counts = {site: [0, 0] for site in parsed}


def deactivate() -> None:
    global _active
    with _lock:
        _active = {}


def snapshot() -> dict:
    """{"enabled", "sites": {site: {"action", "hits", "fired"}}}."""
    with _lock:
        sites = {site: {"action": sp.raw, "hits": _counts.get(site, [0, 0])[0],
                        "fired": _counts.get(site, [0, 0])[1]}
                 for site, sp in _active.items()}
        for site, c in _counts.items():
            sites.setdefault(site, {"action": "(spent)", "hits": c[0], "fired": c[1]})
    return {"enabled": bool(_active), "sites": sites}


def _decide(site: str, key=None) -> Optional[_Spec]:
    active = _active
    if not active:
        return None
    name, sp = site, None
    if key is not None:
        name = f"{site}[{key}]"
        sp = active.get(name)
    if sp is None:
        name, sp = site, active.get(site)
    if sp is None:
        return None
    with _lock:
        c = _counts.setdefault(name, [0, 0])
        c[0] += 1
        if sp.p < 1.0 and random.random() >= sp.p:
            return None
        c[1] += 1
        if sp.once:
            active.pop(name, None)
    return sp


def hit(site: str, key=None) -> None:
    """Synchronous site: raise when `site` (or its `site[key]` spelling)
    is armed and fires; a no-op otherwise."""
    sp = _decide(site, key)
    if sp is None:
        return
    if sp.kind == "delay":
        time.sleep(sp.duration_s)
        return
    if sp.kind == "timeout":
        time.sleep(sp.duration_s)
        raise TimeoutError(f"failpoint {site}: injected timeout")
    raise FailpointError(f"failpoint {site}: injected error")


async def ahit(site: str, key=None) -> None:
    """Async site (event-loop paths): a `timeout` raises
    asyncio.TimeoutError, as a real stall does."""
    sp = _decide(site, key)
    if sp is None:
        return
    if sp.kind == "delay":
        await asyncio.sleep(sp.duration_s)
        return
    if sp.kind == "timeout":
        await asyncio.sleep(sp.duration_s)
        raise asyncio.TimeoutError(f"failpoint {site}: injected timeout")
    raise FailpointError(f"failpoint {site}: injected error")
