"""SLO burn-rate engine (`--slo-config`; the port's copy of
`imaginary_tpu/obs/slo.py`).

Per-route latency and availability objectives, evaluated over 5-minute
and 1-hour sliding windows into burn rates: the multiplier on error-budget
spending (burn 1.0 spends exactly the budget over the window; 14.4 is
the classic page-now threshold for a 1 h window on a 30 d budget).

The config is JSON, inline or a file path (as --qos-config):

    {"/resize": {"latency_ms": 250, "latency_target": 0.99,
                 "availability": 0.999},
     "*":       {"latency_ms": 500, "latency_target": 0.95,
                 "availability": 0.99}}

`*` is the catch-all for routes without their own entry, except the
observability routes (/health, /metrics, /debugz*: INFRA_ROUTE_SUFFIXES),
which count only with an explicit entry. A request counts against
availability when its status is 5xx, and against latency when it ran
longer than `latency_ms`. Burn rate is `bad_fraction / (1 - target)`
over the window; `budget_remaining` takes the hour window as the budget
period (the engine keeps an hour of state).

Cumulative per-route [total, err, slow] triples plus a timestamped
snapshot ring (one entry per >= 5 s, pruned past 1 h). A window's delta
is the current count minus the newest snapshot older than the window; an
engine younger than the window reports its lifetime delta.

Off unless --slo-config is set: then no engine is built and /health,
/metrics and /debugz carry no `slo` block.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

# the imaginary_tpu_slo_* families web/metrics.py renders
SLO_METRICS = (
    "imaginary_tpu_slo_burn_rate",
    "imaginary_tpu_slo_error_budget_remaining",
)

WINDOWS = (("5m", 300.0), ("1h", 3600.0))

# Observability routes the trace middleware sees but users never call:
# liveness probes and scrapes would dilute a "*" catch-all's burn rates
# with guaranteed-fast 200s. Matched as path suffixes, so a --path-prefix
# deployment is covered; an explicit objective for one still applies.
INFRA_ROUTE_SUFFIXES = (
    "/health", "/metrics", "/debugz", "/debugz/profile",
    "/debugz/failpoints",
)


def is_infra_route(route: str) -> bool:
    return route.endswith(INFRA_ROUTE_SUFFIXES)

_RING_MIN_INTERVAL_S = 5.0
_RING_RETAIN_S = 3700.0  # 1h window + slack


class Objective:
    __slots__ = ("latency_ms", "latency_target", "availability")

    def __init__(self, latency_ms: float, latency_target: float,
                 availability: float):
        self.latency_ms = float(latency_ms)
        self.latency_target = float(latency_target)
        self.availability = float(availability)


def load_config(spec: str) -> dict[str, Objective]:
    """Parse --slo-config (inline JSON if it starts with '{', else a
    file path). Raises ValueError on anything malformed — cli.py turns
    that into a boot-time SystemExit, same as --qos-config."""
    spec = (spec or "").strip()
    if not spec:
        return {}
    if spec.startswith("{"):
        raw = spec
    else:
        try:
            with open(spec, encoding="utf-8") as f:
                raw = f.read()
        except OSError as exc:
            raise ValueError(f"slo config unreadable: {exc}") from exc
    try:
        data = json.loads(raw)
    except json.JSONDecodeError as exc:
        raise ValueError(f"slo config is not valid JSON: {exc}") from exc
    if not isinstance(data, dict):
        raise ValueError("slo config must be a JSON object of routes")
    out: dict[str, Objective] = {}
    for route, obj in data.items():
        if not isinstance(obj, dict):
            raise ValueError(f"slo route {route!r}: objective must be an object")
        try:
            latency_ms = float(obj.get("latency_ms", 1000.0))
            latency_target = float(obj.get("latency_target", 0.99))
            availability = float(obj.get("availability", 0.999))
        except (TypeError, ValueError) as exc:
            raise ValueError(f"slo route {route!r}: {exc}") from exc
        if latency_ms <= 0:
            raise ValueError(f"slo route {route!r}: latency_ms must be > 0")
        for field, v in (("latency_target", latency_target),
                         ("availability", availability)):
            if not 0.0 < v < 1.0:
                raise ValueError(
                    f"slo route {route!r}: {field} must be in (0, 1)")
        out[route] = Objective(latency_ms, latency_target, availability)
    return out


class SloEngine:
    """Thread-safe; the trace middleware calls `observe` once a request
    (one dict update and now and then a ring append)."""

    def __init__(self, objectives: dict[str, Objective],
                 clock=time.time):
        self.objectives = objectives
        self._clock = clock
        self._lock = threading.Lock()
        # route -> [total, err5xx, slow_over_objective]
        self._cum: dict[str, list] = {}
        # ring of (ts, {route: (total, err, slow)}) snapshots
        self._ring: deque = deque(maxlen=1024)
        self._last_ring_ts = 0.0
        self._t0 = clock()

    def _objective_for(self, route: str):
        obj = self.objectives.get(route)
        if obj is not None:
            return obj
        if is_infra_route(route):
            return None  # probes/scrapes don't dilute the catch-all
        return self.objectives.get("*")

    def observe(self, route: str, status: int, elapsed_s: float) -> None:
        obj = self._objective_for(route)
        if obj is None:
            return
        now = self._clock()
        with self._lock:
            rec = self._cum.get(route)
            if rec is None:
                rec = self._cum[route] = [0, 0, 0]
            rec[0] += 1
            if status >= 500:
                rec[1] += 1
            if elapsed_s * 1000.0 > obj.latency_ms:
                rec[2] += 1
            if now - self._last_ring_ts >= _RING_MIN_INTERVAL_S:
                self._last_ring_ts = now
                self._ring.append(
                    (now, {r: tuple(v) for r, v in self._cum.items()})
                )
                while self._ring and now - self._ring[0][0] > _RING_RETAIN_S:
                    self._ring.popleft()

    def _window_base(self, now: float, horizon_s: float) -> dict:
        """Newest ring snapshot at least horizon_s old (zeros if the
        engine is younger than the window)."""
        base: dict = {}
        for ts, snap in self._ring:
            if now - ts >= horizon_s:
                base = snap
            else:
                break
        return base

    def snapshot(self) -> dict:
        """The /health `slo` block (the same dict /metrics renders and
        /debugz serves)."""
        now = self._clock()
        with self._lock:
            cum = {r: tuple(v) for r, v in self._cum.items()}
            bases = {
                label: self._window_base(now, horizon)
                for label, horizon in WINDOWS
            }
        routes: dict = {}
        for route, (total, err, slow) in sorted(cum.items()):
            obj = self._objective_for(route)
            if obj is None:
                continue
            entry: dict = {
                "objective": {
                    "latency_ms": obj.latency_ms,
                    "latency_target": obj.latency_target,
                    "availability": obj.availability,
                },
                "total": total,
            }
            for kind, target, bad_idx in (
                ("availability", obj.availability, 1),
                ("latency", obj.latency_target, 2),
            ):
                block: dict = {}
                for label, _horizon in WINDOWS:
                    b = bases[label].get(route, (0, 0, 0))
                    d_total = total - b[0]
                    d_bad = (err, slow)[bad_idx - 1] - b[bad_idx]
                    frac = (d_bad / d_total) if d_total > 0 else 0.0
                    block[f"burn_{label}"] = round(
                        frac / (1.0 - target), 4)
                    block[f"bad_{label}"] = d_bad
                    block[f"total_{label}"] = d_total
                # hour-as-period proxy: remaining budget this hour
                block["budget_remaining"] = round(
                    max(0.0, 1.0 - block["burn_1h"]), 4)
                entry[kind] = block
            routes[route] = entry
        return {"age_s": round(now - self._t0, 1), "routes": routes}


def from_options(options) -> "SloEngine | None":
    """None when --slo-config is unset (the off state)."""
    spec = getattr(options, "slo_config", "") or ""
    if not spec.strip():
        return None
    objectives = load_config(spec)
    if not objectives:
        return None
    return SloEngine(objectives)
