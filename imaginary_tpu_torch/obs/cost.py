"""Per-tenant cost attribution and the capacity plane (`--cost-attribution`;
the port's copy of `imaginary_tpu/obs/cost.py`).

Spans and SLO burn say how slow a request was; this module says who is
using the hardware and what the serving path is bound by now:

  * a per-request cost vector: device ms (the item's share of its
    drain, the number that settles the lanes' owed ledgers), host-pool
    ms (the probe/decode/encode/host_spill span sum), wire bytes, bytes
    copied (CopyLedger) and cache bytes served, assembled by the trace
    middleware at response time and booked against bounded attribution
    keys (tenant x qos_class x route x op);
  * a ring of 1-second buckets rolled into the configured windows
    (10s/1m/5m by default) and per-tenant cumulative vectors;
  * a space-saving top-K sketch that caps the tenant and op label
    values: everything past K folds into `other`;
  * utilization: chip and lane busy fractions, the split of the idle
    gaps (formation wait, dispatch wait, link stall, drain), host-pool
    and link occupancy, as deltas between snapshot calls off the
    process-wide stage and wire ledgers;
  * a live bound_by advisor: the offline link projection's arithmetic on
    the executor's running EWMAs (`_drain_floor_ms` and the port's
    `_ms_per_mb`) and the measured per-request profile of the windows.

What "device ms" measures on the port: the executor's drain is host
wall time from the fetcher's wait to the chunk's completed event, so it
holds the card's kernels and copies and whatever waiting the event adds.
`device_ms_per_req` and `chip_busy` therefore read above the card's own
busy time; a number is the card's only when it comes from CUDA events or
the profiler. `link_stall` reads the `device_wait` stage: an executor
bound to a plane records a second CUDA event in each launch, before its
copy back to the host (ops/chain.py), and its fetchers book the wait up
to it.

Off by default: `from_options` returns None without --cost-attribution,
and None means no ring, no /topz, no `imaginary_tpu_cost_*` families and
no stamps: the capacity block's presence is the armed signal. The stamps
follow the service's own plane, not the process's (the reference reads a
process global): its executor's `cost_armed` gates the drain stamps and
the second event, and the request's `RequestTrace.cost` the byte-touch
ledger's, so an armed server and a server without a plane can run in one
process. `install`/`active` keep the reference's process plane for the
label normalizer alone.

Module-level imports stay stdlib-only; the utilization sampler imports
the ledgers it reads when it runs.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque

# Attribution label value used when a tenant/op falls out of the top-K
# sketch: past-K series fold here so cardinality stays bounded.
OTHER = "other"

# The cost-vector fields, in booking order. `device_ms` is the drain's
# share (rendered as chip_ms in /topz), `host_ms` is host-pool codec time.
VEC_FIELDS = (
    "device_ms", "host_ms", "wire_bytes", "copied_bytes", "cache_bytes",
    "requests",
)

# Span names whose sum is a request's host-pool ms: the stages the host
# thread pool runs (engine/host_exec.py and the codec's probe/decode/encode).
HOST_STAGES = frozenset(("probe", "decode", "encode", "host_spill"))

# Label kinds the bounded-cardinality normalizer accepts.
_LABEL_KINDS = ("tenant", "op", "route", "qos_class")

# Batch size the link projection prices its fixed per-dispatch cost
# against (the reference's offline projection divides the same way).
SERVING_BATCH = 16

DEFAULT_WINDOWS = "10s,1m,5m"
_MAX_WINDOWS = 6
_MAX_WINDOW_S = 3600
# Hard per-bucket key ceiling: tenant/op are sketch-capped but the
# product with route x class could still creep, so past this the bucket
# books into one fold key instead of growing.
_BUCKET_KEY_CAP = 512
_FOLD_KEY = (OTHER, "-", "-", "-")

# Infra routes never booked: scrapes and probes are not tenant work and
# would otherwise dominate the `requests` column of every window.
_SKIP_ROUTE_SUFFIXES = (
    "/health", "/metrics", "/form", "/version", "/debugz", "/topz",
    "/fleetz",
)

_WINDOW_RE = re.compile(r"^(\d+)(s|m)$")


def parse_windows(spec: str):
    """``"10s,1m,5m"`` -> ((label, seconds), ...), strictly ascending.

    Raises ValueError with an operator-actionable message on any junk;
    cli.py turns that into a boot-time SystemExit, as for --slo-config."""
    parts = [p.strip() for p in str(spec).split(",") if p.strip()]
    if not parts:
        raise ValueError("cost windows: empty spec (want e.g. '10s,1m,5m')")
    if len(parts) > _MAX_WINDOWS:
        raise ValueError(
            f"cost windows: {len(parts)} windows (max {_MAX_WINDOWS})")
    out = []
    prev = 0
    for p in parts:
        m = _WINDOW_RE.match(p)
        if not m:
            raise ValueError(
                f"cost windows: bad window {p!r} (want <n>s or <n>m)")
        sec = int(m.group(1)) * (60 if m.group(2) == "m" else 1)
        if sec <= 0 or sec > _MAX_WINDOW_S:
            raise ValueError(
                f"cost windows: {p!r} out of range (1s..{_MAX_WINDOW_S}s)")
        if sec <= prev:
            raise ValueError(
                f"cost windows: {p!r} not ascending (windows must grow)")
        prev = sec
        out.append((p, sec))
    return tuple(out)


class SpaceSaving:
    """Metwally space-saving heavy-hitters sketch, deterministic flavor.

    `offer` admits every name: tracked names accumulate weight; when the
    table is full the minimum entry — ties broken by (count, name) so
    replay order alone decides nothing — is evicted and the newcomer
    inherits its count floor (the classic overestimate guarantee). The
    evicted name is returned so the caller can fold that series into
    ``other``. `tracked`/`top` are read-only."""

    def __init__(self, k: int):
        self.k = max(1, int(k))
        self._counts: dict = {}

    def offer(self, name: str, weight: float = 1.0):
        """Admit `name`; returns the evicted name (to fold) or None."""
        c = self._counts.get(name)
        if c is not None:
            self._counts[name] = c + weight
            return None
        if len(self._counts) < self.k:
            self._counts[name] = weight
            return None
        victim, floor = min(
            self._counts.items(), key=lambda kv: (kv[1], kv[0]))
        del self._counts[victim]
        self._counts[name] = floor + weight
        return victim

    def tracked(self, name: str) -> bool:
        return name in self._counts

    def top(self, n: int = 0):
        items = sorted(self._counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return items[:n] if n else items


class CostPlane:
    """The armed cost-attribution plane: ring + sketches + advisor."""

    def __init__(self, topk: int = 20, windows: str = DEFAULT_WINDOWS,
                 clock=time.monotonic):
        self.topk = max(1, int(topk))
        self.windows_spec = windows
        self.windows = parse_windows(windows)
        self._horizon = max(sec for _, sec in self.windows)
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants = SpaceSaving(self.topk)
        self._ops = SpaceSaving(self.topk)
        # ring of (int_second, {(tenant, qos_class, route, op): vec})
        self._buckets: deque = deque()
        # per-tenant cumulative vectors (monotonic except for the
        # documented reset-to-floor when a tenant re-enters the sketch
        # after folding — counter-reset semantics scrapers already handle)
        self._cum: dict = {}
        self._folds = 0
        self._booked = 0
        # utilization delta state: previous _util_now() sample
        self._util_prev = None
        # live sources the owning service binds (None-safe everywhere:
        # a bare plane in a unit test still books and snapshots)
        self._executor = None
        self._host_view = None

    # ---------------- wiring ----------------

    def bind(self, executor=None, host_view=None) -> None:
        """Attach live signal sources: the executor (its drain floor and
        ms/MB EWMA) and a ()->(workers, inflight) host-pool view.
        ImageService calls this once at construction."""
        if executor is not None:
            self._executor = executor
        if host_view is not None:
            self._host_view = host_view

    def seed_tenants(self, names) -> None:
        """Pre-admit configured tenants at weight 0 so a policy-file
        tenant never reports as ``other`` before its first request."""
        with self._lock:
            for n in names:
                if len(self._tenants._counts) < self._tenants.k:
                    self._tenants.offer(str(n), 0.0)

    # ---------------- booking ----------------

    def normalize(self, kind: str, value: str) -> str:
        """Read-only bounded-cardinality mapping for metric labels:
        tenant/op values outside the top-K sketch render as ``other``;
        route/qos_class pass through (both are bounded upstream — the
        route labeler and the fixed QoS class set). Never admits."""
        if kind not in _LABEL_KINDS:
            raise ValueError(f"unknown label kind {kind!r}")
        if kind == "tenant":
            sketch = self._tenants
        elif kind == "op":
            sketch = self._ops
        else:
            return value
        value = str(value)
        with self._lock:
            return value if sketch.tracked(value) or value == OTHER else OTHER

    def should_book(self, route: str) -> bool:
        return not (route == "/" or route.endswith(_SKIP_ROUTE_SUFFIXES))

    def book(self, tenant: str, qos_class: str, route: str, op: str,
             device_ms: float = 0.0, host_ms: float = 0.0,
             wire_bytes: float = 0.0, copied_bytes: float = 0.0,
             cache_bytes: float = 0.0) -> None:
        """Book one request's cost vector under its attribution key."""
        tenant = str(tenant or "default")
        op = str(op or "-")
        qos_class = str(qos_class or "-")
        route = str(route or "-")
        sec = int(self._clock())
        with self._lock:
            evicted = self._tenants.offer(tenant, 1.0)
            if evicted is not None and evicted != tenant:
                self._fold_cum(evicted)
                self._folds += 1
            ev_op = self._ops.offer(op, 1.0)
            if ev_op is not None and ev_op != op:
                self._folds += 1
            bucket = self._bucket_for(sec)
            key = (tenant, qos_class, route, op)
            if key not in bucket and len(bucket) >= _BUCKET_KEY_CAP:
                key = _FOLD_KEY
            vec = bucket.get(key)
            if vec is None:
                vec = bucket[key] = [0.0] * len(VEC_FIELDS)
            cum_name = tenant if key is not _FOLD_KEY else OTHER
            cum = self._cum.get(cum_name)
            if cum is None:
                cum = self._cum[cum_name] = [0.0] * len(VEC_FIELDS)
            for tgt in (vec, cum):
                tgt[0] += device_ms
                tgt[1] += host_ms
                tgt[2] += wire_bytes
                tgt[3] += copied_bytes
                tgt[4] += cache_bytes
                tgt[5] += 1
            self._booked += 1

    def _bucket_for(self, sec: int) -> dict:
        if self._buckets:
            last_sec, last = self._buckets[-1]
            if sec <= last_sec:  # same second, or a clock hiccup: reuse
                return last
        bucket: dict = {}
        self._buckets.append((sec, bucket))
        floor = sec - self._horizon
        while self._buckets and self._buckets[0][0] <= floor:
            self._buckets.popleft()
        return bucket

    def _fold_cum(self, victim: str) -> None:
        vec = self._cum.pop(victim, None)
        if vec is None:
            return
        other = self._cum.get(OTHER)
        if other is None:
            self._cum[OTHER] = vec
        else:
            for i, v in enumerate(vec):
                other[i] += v

    # ---------------- read side ----------------

    @staticmethod
    def _vec_dict(vec) -> dict:
        return {
            "device_ms": round(vec[0], 3),
            "host_ms": round(vec[1], 3),
            "wire_bytes": int(vec[2]),
            "copied_bytes": int(vec[3]),
            "cache_bytes": int(vec[4]),
            "requests": int(vec[5]),
        }

    def _window_sums(self, now_s: int) -> dict:
        """label -> {key: vec} summed over buckets inside the window.
        Caller holds the lock."""
        out = {}
        buckets = list(self._buckets)
        for label, sec in self.windows:
            floor = now_s - sec
            agg: dict = {}
            for b_sec, bucket in buckets:
                if b_sec <= floor:
                    continue
                for key, vec in bucket.items():
                    cur = agg.get(key)
                    if cur is None:
                        agg[key] = list(vec)
                    else:
                        for i, v in enumerate(vec):
                            cur[i] += v
            out[label] = agg
        return out

    def snapshot(self) -> dict:
        """The `capacity` block /health //debugz serve and /metrics
        renders: window totals, per-tenant cumulative vectors,
        utilization deltas, and the live bound_by verdict."""
        now_s = int(self._clock())
        with self._lock:
            sums = self._window_sums(now_s)
            tenants = {t: list(v) for t, v in self._cum.items()}
            folds = self._folds
            booked = self._booked
        windows = {}
        for label, agg in sums.items():
            total = [0.0] * len(VEC_FIELDS)
            for vec in agg.values():
                for i, v in enumerate(vec):
                    total[i] += v
            windows[label] = self._vec_dict(total)
        return {
            "topk": self.topk,
            "windows_spec": self.windows_spec,
            "folds": folds,
            "booked": booked,
            "windows": windows,
            "tenants": {t: self._vec_dict(v)
                        for t, v in sorted(tenants.items())},
            "utilization": self.utilization(),
            "bound_by": self.advise(sums),
        }

    def topz(self) -> dict:
        """The /topz body: top-K consumers by chip-ms / host-ms / wire
        bytes per window (chip_ms is the cost vector's device_ms)."""
        now_s = int(self._clock())
        with self._lock:
            sums = self._window_sums(now_s)
            folds = self._folds
        windows = {}
        for label, agg in sums.items():
            by_tenant: dict = {}
            for (tenant, _klass, _route, _op), vec in agg.items():
                cur = by_tenant.get(tenant)
                if cur is None:
                    by_tenant[tenant] = list(vec)
                else:
                    for i, v in enumerate(vec):
                        cur[i] += v
            total = [0.0] * len(VEC_FIELDS)
            for vec in by_tenant.values():
                for i, v in enumerate(vec):
                    total[i] += v

            def rank(idx, name):
                rows = sorted(
                    by_tenant.items(), key=lambda kv: (-kv[1][idx], kv[0]))
                return [
                    {"tenant": t, name: round(v[idx], 3),
                     "requests": int(v[5])}
                    for t, v in rows[:self.topk] if v[idx] > 0
                ]

            windows[label] = {
                "totals": self._vec_dict(total),
                "by_chip_ms": rank(0, "chip_ms"),
                "by_host_ms": rank(1, "host_ms"),
                "by_wire_bytes": rank(2, "wire_bytes"),
            }
        return {"k": self.topk, "folds": folds, "windows": windows}

    # ---------------- utilization timelines ----------------

    def _util_now(self) -> dict:
        """One cumulative sample off the process-wide ledgers; deltas
        between successive samples become busy fractions."""
        from imaginary_tpu_torch.engine.timing import LANE_TIMES, TIMES, WIRE

        stage = TIMES.totals()
        wire = WIRE.snapshot()
        lanes = {}
        for (lane, st), total_ms in LANE_TIMES.totals().items():
            # drain_busy cells carry drain wall ms (cost-gated records
            # from the executor's fetchers); lane -1 is the global path
            if st == "drain_busy":
                label = str(lane) if lane >= 0 else "all"
                lanes[label] = lanes.get(label, 0.0) + total_ms
        return {
            "t": self._clock(),
            "stage_ms": {s: ms for s, (_n, ms) in stage.items()},
            "lane_drain_ms": lanes,
            "wire_bytes": float(wire.get("h2d", 0))
            + float(wire.get("d2h", 0)),
        }

    def utilization(self) -> dict:
        """Busy fractions + idle-gap attribution since the previous
        snapshot call (each scrape consumes the delta window; `age_s`
        reports how wide it was)."""
        try:
            cur = self._util_now()
        except Exception:  # ledgers unavailable in a bare unit test
            return {"age_s": 0.0}
        with self._lock:
            prev, self._util_prev = self._util_prev, cur
        out: dict = {"age_s": 0.0}
        cum = cur["stage_ms"]
        out["wait_cum_ms"] = {
            "batch_form": round(cum.get("batch_form", 0.0), 3),
            "dispatch_wait": round(cum.get("dispatch_wait", 0.0), 3),
            "link_stall": round(cum.get("device_wait", 0.0), 3),
            "drain": round(cum.get("drain", 0.0), 3),
        }
        host_view = self._host_view
        if host_view is not None:
            try:
                workers, inflight = host_view()
                out["host_pool"] = round(
                    min(1.0, inflight / max(1, workers)), 4)
            except Exception:  # itpu: allow[ITPU004] a torn view must not fail a scrape
                pass
        if prev is None:
            return out
        dt = cur["t"] - prev["t"]
        if dt <= 0:
            return out
        out["age_s"] = round(dt, 3)
        budget_ms = dt * 1000.0

        def delta(stage):
            return max(0.0, cum.get(stage, 0.0)
                       - prev["stage_ms"].get(stage, 0.0))

        out["wait_split_ms"] = {
            "batch_form": round(delta("batch_form"), 3),
            "dispatch_wait": round(delta("dispatch_wait"), 3),
            "link_stall": round(delta("device_wait"), 3),
            "drain": round(delta("drain"), 3),
        }
        lane_busy = {}
        for lane, ms in cur["lane_drain_ms"].items():
            d = max(0.0, ms - prev["lane_drain_ms"].get(lane, 0.0))
            lane_busy[str(lane)] = round(min(1.0, d / budget_ms), 4)
        out["lanes"] = lane_busy
        if lane_busy:
            out["chip_busy"] = round(
                sum(lane_busy.values()) / len(lane_busy), 4)
        else:
            out["chip_busy"] = round(
                min(1.0, delta("drain") / budget_ms), 4)
        ex = self._executor
        ms_per_mb = getattr(ex, "_ms_per_mb", None)
        if ms_per_mb:
            wire_mb = max(
                0.0, cur["wire_bytes"] - prev["wire_bytes"]) / 1e6
            out["link"] = round(
                min(1.0, wire_mb * ms_per_mb / budget_ms), 4)
        return out

    # ---------------- live bound_by advisor ----------------

    def advise(self, sums=None) -> dict:
        """The live bound_by verdict: the link projection's arithmetic
        (rate = 1000 / per-request ms, e2e = min(link, chip, host)) fed
        by the executor's running EWMAs and the measured per-request
        profile of the widest non-empty cost window."""
        if sums is None:
            now_s = int(self._clock())
            with self._lock:
                sums = self._window_sums(now_s)
        profile = None
        for label, _sec in reversed(self.windows):
            total = [0.0] * len(VEC_FIELDS)
            for vec in sums.get(label, {}).values():
                for i, v in enumerate(vec):
                    total[i] += v
            if total[5] > 0:
                profile = (label, total)
                break
        out: dict = {"verdict": "unknown", "serving_batch": SERVING_BATCH}
        ex = self._executor
        floor_ms = getattr(ex, "_drain_floor_ms", None)
        ms_per_mb = getattr(ex, "_ms_per_mb", None)
        if floor_ms is not None:
            out["drain_floor_ms"] = round(floor_ms, 3)
        if ms_per_mb is not None:
            out["device_ms_per_mb"] = round(ms_per_mb, 4)
        if profile is None:
            return out
        label, total = profile
        n = total[5]
        wire_mb = total[2] / n / 1e6
        device_ms = total[0] / n
        host_ms = total[1] / n
        out.update({
            "window": label,
            "requests": int(n),
            "wire_mb_per_req": round(wire_mb, 4),
            "device_ms_per_req": round(device_ms, 3),
            "host_ms_per_req": round(host_ms, 3),
        })
        rates = {}
        if floor_ms and ms_per_mb and wire_mb > 0:
            per_req = floor_ms / SERVING_BATCH + wire_mb * ms_per_mb
            if per_req > 0:
                rates["link"] = 1000.0 / per_req
        if device_ms > 0:
            rates["chip"] = 1000.0 / device_ms
        if host_ms > 0:
            workers = 1
            host_view = self._host_view
            if host_view is not None:
                try:
                    workers = max(1, int(host_view()[0]))
                except Exception:  # itpu: allow[ITPU004] a torn view counts one worker
                    pass
            out["host_workers"] = workers
            rates["host-codecs"] = workers * 1000.0 / host_ms
        for k, v in rates.items():
            out[f"{k.replace('-', '_')}_rate"] = round(v, 2)
        if rates:
            out["verdict"] = min(rates.items(), key=lambda kv: kv[1])[0]
            out["e2e_rate"] = round(min(rates.values()), 2)
        return out


# ---------------- module-level plane ----------------
#
# The process's plane: the label normalizer below reads it (the latest
# create_app wins, the one serving app per process that the transport
# switches rely on too). The stamps follow each service's own plane (the
# module docstring); the web layer holds its own reference for booking.

_PLANE = None


def install(plane):
    global _PLANE
    _PLANE = plane
    return plane


def active():
    return _PLANE


def normalize_label(kind: str, value: str) -> str:
    """Bounded-cardinality guard for metric label values derived from
    tenants, ops and routes. With no plane armed it is the identity: slo
    route labels render unchanged when cost attribution is off."""
    plane = _PLANE
    if plane is None:
        if kind not in _LABEL_KINDS:
            raise ValueError(f"unknown label kind {kind!r}")
        return value
    return plane.normalize(kind, value)


def from_options(options):
    """CostPlane when --cost-attribution is set, else None (no ring, no
    /topz, no cost families). Always installs the result as the process
    plane, which the label normalizer reads."""
    if not getattr(options, "cost_attribution", False):
        return install(None)
    return install(CostPlane(
        topk=getattr(options, "cost_topk", 20),
        windows=getattr(options, "cost_windows", DEFAULT_WINDOWS) or
        DEFAULT_WINDOWS,
    ))
