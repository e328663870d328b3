"""Prometheus text-format /metrics endpoint (the port's copy of
`imaginary_tpu/web/metrics.py`).

Two layers of exposition, both format-0.0.4-strict (`# HELP`/`# TYPE`
per family, label values escaped, families grouped):

  1. The /health mirror: the same numbers /health serves, as gauges and
     counters under the `imaginary_tpu_` namespace (executor counters,
     per-lane families, the fault domains, the link ledger by direction,
     the byte-touch ledger by stage, the qos classes, the pressure
     governor, the codec arena, the cache tiers, per-stage latency
     percentile gauges, and with their planes armed the SLO burn rates,
     the cost and utilization families, the read guard's counters; the
     event-loop lag gauges once the probe has sampled).
  2. The obs registry (obs/histogram.py): fixed-bucket cumulative
     histograms (`imaginary_tpu_request_duration_seconds`,
     `imaginary_tpu_stage_duration_seconds{stage=}`,
     `imaginary_tpu_event_loop_lag_seconds`) and the RED counters per
     route x status class.

The fleet families belong to the --workers supervisor, which the port
does not have yet; they are absent, as the reference leaves them out
when the fleet is off.
"""

from __future__ import annotations

import re

from imaginary_tpu_torch.obs.cost import normalize_label
from imaginary_tpu_torch.obs.histogram import REGISTRY, escape_label_value

# Occupancy/level metrics mirrored from /health; everything else in the
# executor block is a monotonically-increasing counter.
_EXEC_GAUGES = {
    "avg_batch", "avg_group", "max_group", "queue_depth",
    "compile_cache_size", "device_owed_mb", "device_ms_per_mb",
    "host_ms_per_mpix", "host_inflight", "host_owed_mpix",
    "host_spill_p50_ms", "host_spill_p99_ms",
    "batch_form_p50_ms", "batch_form_p99_ms",
    "dispatch_wait_p50_ms", "dispatch_wait_p99_ms", "donation_enabled",
    "mesh_generation",
}
# the cache block's occupancy; its other keys are counters
_CACHE_GAUGES = {
    "result_items", "result_bytes", "frame_items", "frame_bytes",
    "source_items", "source_bytes", "device_items", "device_bytes",
}


def _snake(name: str) -> str:
    return re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", name).lower()


class _Exposition:
    """Line accumulator that emits each family's `# HELP`/`# TYPE` header
    exactly once, before its first sample."""

    def __init__(self):
        self.lines: list = []
        self._seen: set = set()

    def emit(self, name: str, value, labels: str = "",
             mtype: str = "gauge", help_text: str = "") -> None:
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            return
        if name not in self._seen:
            self._seen.add(name)
            if help_text:
                self.lines.append(f"# HELP {name} {help_text}")
            self.lines.append(f"# TYPE {name} {mtype}")
        self.lines.append(
            f"{name}{{{labels}}} {value}" if labels else f"{name} {value}"
        )


def render_metrics(stats: dict, exemplars: bool = False) -> str:
    """Health-stats dict + obs registry -> Prometheus exposition text.

    exemplars=True (the /metrics?exemplars=1 opt-in) appends
    OpenMetrics-style ` # {trace_id=,request_id=} value` clauses to the
    latency histogram buckets."""
    x = _Exposition()
    # deferred so each family's samples stay contiguous
    stage_ms: list = []
    stage_total: list = []
    lanes_list: list = []
    copies: dict = {}
    device_health: dict = {}
    hedge_outcomes: dict = {}
    integrity: dict = {}
    wire: dict = {}
    wire_by_device: dict = {}
    qos_classes: dict = {}
    pressure: dict = {}
    arena: dict = {}
    ingress: dict = {}
    slo: dict = {}
    capacity: dict = {}
    event_loop: dict = {}
    oom_splits = None
    for key, value in stats.items():
        if key == "executor" and isinstance(value, dict):
            # the headline counter also rides under its own name
            oom_splits = value.get("oom_splits")
            for k, v in value.items():
                if k == "lanes" and isinstance(v, list):
                    lanes_list = v
                    continue
                if k == "hedges" and isinstance(v, dict):
                    # one labelled family (imaginary_tpu_hedges_total)
                    hedge_outcomes = v
                    continue
                if k in ("copied_bytes", "copy_events") and isinstance(v, dict):
                    # stage-labeled families, below
                    copies[k] = v
                    continue
                if k in ("wire_bytes", "wire_transfers") and isinstance(v, dict):
                    # direction-labeled families, below
                    wire[k] = v
                    continue
                if k == "wire_bytes_by_device" and isinstance(v, dict):
                    wire_by_device = v
                    continue
                mtype = "gauge" if k in _EXEC_GAUGES else "counter"
                x.emit(f"imaginary_tpu_executor_{_snake(k)}", v, mtype=mtype,
                       help_text=f"Executor {k.replace('_', ' ')} (see /health).")
        elif key == "deviceHealth" and isinstance(value, dict):
            device_health = value
        elif key == "integrity" and isinstance(value, dict):
            integrity = value
        elif key == "qos" and isinstance(value, dict):
            qos_classes = value.get("classes", {})
        elif key == "pressure" and isinstance(value, dict):
            pressure = value
        elif key == "arena" and isinstance(value, dict):
            arena = value
        elif key == "ingress" and isinstance(value, dict):
            ingress = value
        elif key == "slo" and isinstance(value, dict):
            slo = value
        elif key == "capacity" and isinstance(value, dict):
            capacity = value
        elif key == "eventLoop" and isinstance(value, dict):
            event_loop = value
        elif key == "cache" and isinstance(value, dict):
            # the cache tiers (cache.py): hit/miss/eviction per tier,
            # singleflight coalescing and 304s
            for k, v in value.items():
                mtype = "gauge" if k in _CACHE_GAUGES else "counter"
                x.emit(f"imaginary_tpu_cache_{_snake(k)}", v, mtype=mtype,
                       help_text=f"Cache {k.replace('_', ' ')} (see /health).")
        elif key == "stageTimesMs" and isinstance(value, dict):
            for stage, pcts in value.items():
                lab = escape_label_value(stage)
                for q, v in pcts.items():
                    if q == "count":
                        stage_total.append((f'stage="{lab}"', v))
                    else:
                        qlab = escape_label_value(
                            _snake(q).replace("_ms", ""))
                        stage_ms.append(
                            (f'stage="{lab}",q="{qlab}"', v))
        elif key == "backend":
            x.emit("imaginary_tpu_backend_info", 1,
                   f'backend="{escape_label_value(value)}"',
                   help_text="Active torch device type (value is always 1).")
        else:
            x.emit(f"imaginary_tpu_{_snake(key)}", value,
                   help_text=f"{key} (see /health).")
    _qos_help = {
        "queued": "Requests waiting in the executor intake queue per class.",
        "admitted": "Requests that passed the admission gate per class.",
        "shed": "Requests shed 503 by overload/admission control per class.",
        "share_rejected": "Queue puts rejected by a tenant share cap.",
        "rate_limited": "Requests 429d by the per-tenant GCRA per class.",
        "dispatched": "Items popped from the qos scheduler per class.",
    }
    for metric, help_text in _qos_help.items():
        for cls, counters in qos_classes.items():
            if metric not in counters:
                continue
            name = "imaginary_tpu_qos_" + (metric if metric == "queued"
                                           else metric + "_total")
            x.emit(name, counters[metric], f'class="{escape_label_value(cls)}"',
                   mtype="gauge" if metric == "queued" else "counter",
                   help_text=help_text)
    for direction, v in sorted(wire.get("wire_bytes", {}).items()):
        x.emit("imaginary_tpu_wire_bytes_total", v,
               f'direction="{escape_label_value(direction)}"', mtype="counter",
               help_text="Bytes actually staged across the device link "
                         "(h2d = host-to-device batch stages, d2h = "
                         "result drains).")
    for direction, v in sorted(wire.get("wire_transfers", {}).items()):
        x.emit("imaginary_tpu_wire_transfers_total", v,
               f'direction="{escape_label_value(direction)}"', mtype="counter",
               help_text="Device-link transfer operations by direction.")
    for direction, per_dev in sorted(wire_by_device.items()):
        for dev, v in sorted(per_dev.items()):
            x.emit("imaginary_tpu_wire_device_bytes_total", v,
                   f'direction="{escape_label_value(direction)}",'
                   f'device="{escape_label_value(str(dev))}"', mtype="counter",
                   help_text="Device-link bytes attributed to one device "
                             "(the sharded and spatial launches).")
    if arena:
        for k, kind, text in (
                ("reuses", "counter", "Native codec-scratch requests served from "
                                      "the thread-local arena without allocating."),
                ("misses", "counter", "Native codec-scratch requests that had to "
                                      "grow an arena slot (cold thread or "
                                      "high-water bump)."),
                ("evictions", "counter", "Arena trims forced by the --arena-mb "
                                         "per-thread cap (slots released back "
                                         "to the allocator)."),
                ("bytes", "gauge", "High-water bytes currently held by codec "
                                   "scratch arenas across threads."),
                ("cap_bytes", "gauge", "Configured per-thread arena cap in bytes "
                                       "(0 = unlimited).")):
            x.emit(f"imaginary_tpu_arena_{k}" + ("_total" if kind == "counter" else ""),
                   arena.get(k, 0), mtype=kind, help_text=text)
    if oom_splits is not None:
        x.emit("imaginary_tpu_oom_splits_total", oom_splits, mtype="counter",
               help_text="Chunk bisections performed by OOM recovery.")
    # per-lane families, one loop per family so each family's samples
    # stay contiguous
    for s in lanes_list:
        x.emit("imaginary_tpu_lane_queued", s.get("queued", 0),
               f'lane="{s.get("lane", 0)}"', mtype="gauge",
               help_text="Items placed on this device's lane and not yet "
                         "inside a drain (engine/lanes.py).")
    for s in lanes_list:
        x.emit("imaginary_tpu_lane_inflight", s.get("inflight", 0),
               f'lane="{s.get("lane", 0)}"', mtype="gauge",
               help_text="Items inside the drain this lane's fetcher is "
                         "blocked on right now.")
    for s in lanes_list:
        x.emit("imaginary_tpu_lane_dispatches_total", s.get("dispatches", 0),
               f'lane="{s.get("lane", 0)}"', mtype="counter",
               help_text="Device calls launched on this device's lane.")
    for stage, v in sorted(copies.get("copied_bytes", {}).items()):
        x.emit("imaginary_tpu_bytes_copied_total", v,
               f'stage="{escape_label_value(stage)}"', mtype="counter",
               help_text="Host bytes actually copied per stage of the "
                         "request journey (decode/transform/encode): the "
                         "byte-touch ledger.")
    for stage, v in sorted(copies.get("copy_events", {}).items()):
        x.emit("imaginary_tpu_copy_events_total", v,
               f'stage="{escape_label_value(stage)}"', mtype="counter",
               help_text="Copy events booked per stage (copies per request "
                         "derive as events over requests).")
    # launched outside the outcome family, so sum(rate()) over the
    # outcomes does not count it twice
    if "launched" in hedge_outcomes:
        x.emit("imaginary_tpu_hedges_launched_total",
               hedge_outcomes["launched"], mtype="counter",
               help_text="Speculative host-path hedge twins started.")
    for outcome, v in sorted(hedge_outcomes.items()):
        if outcome == "launched":
            continue
        x.emit("imaginary_tpu_hedges_total", v,
               f'outcome="{escape_label_value(outcome)}"', mtype="counter",
               help_text="Hedged failover dispatches by outcome "
                         "(won|lost|failed|skipped_budget).")
    if device_health:
        x.emit("imaginary_tpu_devices_healthy", device_health.get("healthy", 0),
               help_text="Dispatchable devices in the healthy state.")
        x.emit("imaginary_tpu_devices_quarantined",
               device_health.get("quarantined", 0),
               help_text="Devices removed from the dispatchable set by "
                         "their per-device breaker.")
        x.emit("imaginary_tpu_devices_degraded",
               device_health.get("degraded", 0),
               help_text="Devices demoted by fail-slow detection (probe "
                         "latency EWMA above the peers' median ratio).")
        x.emit("imaginary_tpu_corruption_strikes_total",
               device_health.get("corruptions", 0), mtype="counter",
               help_text="Corruption strikes booked (golden-probe "
                         "mismatches and failed sampled verifications).")
        for d in device_health.get("per_device", ()):
            x.emit(
                "imaginary_tpu_device_state", 1,
                f'device="{d.get("device", "")}",'
                f'state="{escape_label_value(str(d.get("state", "")))}"',
                help_text="Per-device fault-domain state "
                          "(healthy|degraded|quarantined|half_open); "
                          "value is always 1.")
    if integrity:
        for k, kind, text in (
                ("checks", "counter", "Sampled verification comparisons made "
                                      "before release."),
                ("mismatches", "counter", "Verification comparisons that failed."),
                ("reserved", "counter", "Answers re-served from the verified copy."),
                ("skipped", "counter", "Sampled items with no independent "
                                       "recompute."),
                ("poison_entries", "gauge", "Inputs in the poison list."),
                ("poison_hits", "counter", "Submits sent to host/422 by the "
                                           "poison list."),
                ("poison_isolated", "counter", "Inputs the bisection convicted.")):
            x.emit(f"imaginary_tpu_integrity_{k}" + ("_total" if kind == "counter" else ""),
                   integrity.get(k, 0), mtype=kind, help_text=text)
    if pressure:
        x.emit("imaginary_tpu_pressure_state", pressure.get("state", 0),
               help_text="Memory-pressure rung (0=ok 1=elevated 2=critical).")
        x.emit("imaginary_tpu_pressure_rss_mb", pressure.get("rss_mb", 0.0),
               help_text="Sampled process RSS in MB (governor view).")
        x.emit("imaginary_tpu_pressure_rss_limit_mb", pressure.get("rss_limit_mb", 0.0),
               help_text="Configured RSS ceiling in MB.")
        x.emit("imaginary_tpu_pressure_ratio", pressure.get("ratio", 0.0),
               help_text="Worst-signal pressure ratio (used/limit).")
        for rung, v in sorted((pressure.get("transitions") or {}).items()):
            x.emit("imaginary_tpu_pressure_transitions_total", v,
                   f'level="{escape_label_value(rung)}"', mtype="counter",
                   help_text="Entries into each pressure rung.")
        x.emit("imaginary_tpu_pressure_batch_sheds_total",
               pressure.get("batch_sheds", 0), mtype="counter",
               help_text="Batch-class requests shed 503 at critical pressure.")
        x.emit("imaginary_tpu_pressure_pixel_clamps_total",
               pressure.get("pixel_clamps", 0), mtype="counter",
               help_text="Requests rejected 413 by the critical-rung "
                         "pixel-admission clamp.")
    if ingress:
        x.emit("imaginary_tpu_ingress_read_timeouts_total",
               ingress.get("read_timeouts", 0), mtype="counter",
               help_text="Connections closed by the --read-timeout guard: a "
                         "request read stalled past the inactivity window.")
        x.emit("imaginary_tpu_ingress_guarded_connections_total",
               ingress.get("guarded_connections", 0), mtype="counter",
               help_text="Connections accepted under the read-timeout guard.")
    _render_slo(x, slo)
    if capacity:
        _render_capacity(x, capacity)
    if event_loop:
        x.emit("imaginary_tpu_event_loop_lag_last_seconds",
               float(event_loop.get("lagMsLast", 0.0)) / 1000.0,
               help_text="Most recent event-loop lag probe sample.")
        x.emit("imaginary_tpu_event_loop_lag_max_seconds",
               float(event_loop.get("lagMsMax", 0.0)) / 1000.0,
               help_text="Max event-loop lag observed since start.")
    for labels, v in stage_total:
        x.emit("imaginary_tpu_stage_total", v, labels, mtype="counter",
               help_text="Samples recorded per pipeline stage.")
    for labels, v in stage_ms:
        x.emit("imaginary_tpu_stage_ms", v, labels,
               help_text="Per-stage latency percentile gauges (single-"
                         "process window; use the _duration_seconds "
                         "histograms for fleet aggregation).")
    # layer 2: request/stage duration histograms + RED counters
    x.lines.extend(REGISTRY.render_lines(exemplars=exemplars))
    return "\n".join(x.lines) + "\n"


def _render_slo(x: _Exposition, slo: dict) -> None:
    """The SLO engine's burn rates and remaining budgets (obs/slo.py),
    one family at a time so each family's samples stay contiguous."""
    burn: list = []
    budget: list = []
    for route, entry in sorted((slo.get("routes") or {}).items()):
        rlab = escape_label_value(normalize_label("route", route))
        for kind in ("availability", "latency"):
            block = entry.get(kind) or {}
            for window in ("5m", "1h"):
                v = block.get(f"burn_{window}")
                if v is not None:
                    burn.append((f'route="{rlab}",slo="{kind}",window="{window}"', v))
            if "budget_remaining" in block:
                budget.append((f'route="{rlab}",slo="{kind}"', block["budget_remaining"]))
    for labels, v in burn:
        x.emit("imaginary_tpu_slo_burn_rate", v, labels,
               help_text="Error-budget burn rate per route/objective/window "
                         "(1.0 = spending exactly the budget).")
    for labels, v in budget:
        x.emit("imaginary_tpu_slo_error_budget_remaining", v, labels,
               help_text="Fraction of the error budget left this hour per "
                         "route/objective (hour-as-period proxy).")


_COST_HELP = {
    "device_ms": "Device milliseconds (each item's share of its measured "
                 "drain) booked per tenant.",
    "host_ms": "Host-pool codec milliseconds (probe/decode/encode/host_spill "
               "spans) booked per tenant.",
    "wire_bytes": "Device-link bytes (H2D + D2H) booked per tenant.",
    "copied_bytes": "Host bytes copied (byte-touch ledger) booked per tenant.",
    "cache_bytes": "Response bytes served from cache hits booked per tenant.",
    "requests": "Requests booked into the cost ledger per tenant.",
}


def _render_capacity(x: _Exposition, capacity: dict) -> None:
    """The cost plane's per-tenant counters and the utilization gauges
    (obs/cost.py); tenant values pass the cardinality normalizer."""
    tenants = sorted((capacity.get("tenants") or {}).items())
    for field, help_text in _COST_HELP.items():
        for tenant, vec in tenants:
            tlab = escape_label_value(normalize_label("tenant", tenant))
            x.emit(f"imaginary_tpu_cost_{field}_total", vec.get(field, 0),
                   f'tenant="{tlab}"', mtype="counter", help_text=help_text)
    x.emit("imaginary_tpu_cost_folds_total", capacity.get("folds", 0), mtype="counter",
           help_text="Attribution series folded into the `other` label by the "
                     "top-K cardinality sketch.")
    x.emit("imaginary_tpu_cost_booked_total", capacity.get("booked", 0), mtype="counter",
           help_text="Requests booked into the cost attribution ring.")
    util = capacity.get("utilization") or {}
    for kind, v in sorted((util.get("wait_cum_ms") or {}).items()):
        x.emit("imaginary_tpu_utilization_wait_ms_total", v,
               f'kind="{escape_label_value(kind)}"', mtype="counter",
               help_text="Cumulative idle-gap attribution per kind (batch_form|"
                         "dispatch_wait|link_stall|drain) in milliseconds.")
    for lane, v in sorted((util.get("lanes") or {}).items()):
        x.emit("imaginary_tpu_utilization_lane_busy", v,
               f'lane="{escape_label_value(lane)}"',
               help_text="Per-lane drain busy fraction over the last scrape "
                         "delta window.")
    if "chip_busy" in util:
        x.emit("imaginary_tpu_utilization_chip_busy", util["chip_busy"],
               help_text="Mean chip busy fraction (drain wall time) over the "
                         "last scrape delta window.")
    if "host_pool" in util:
        x.emit("imaginary_tpu_utilization_host_pool", util["host_pool"],
               help_text="Host codec pool occupancy (inflight/workers), instant.")
    if "link" in util:
        x.emit("imaginary_tpu_utilization_link", util["link"],
               help_text="Device-link occupancy over the last scrape delta window "
                         "(wire MB priced at the live ms/MB EWMA).")
