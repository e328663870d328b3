"""Wide events: one structured JSON line per request (the port's copy of
`imaginary_tpu/obs/events.py`).

The access log says what happened; the wide event says why it was slow
or wrong: one self-contained JSON object per request with its identity,
its operation, plan digest, cache outcome, placement, bytes in and out,
status and every recorded span. Off by default (`--wide-events`); the
lines go to the access log's stream, told apart by their leading '{'.

Schema (the reference's field names; tests/test_torch_obs.py holds the
port's against the reference's):

  ts            unix seconds (float)
  request_id    echoed X-Request-ID
  trace_id      W3C trace-id (an inbound traceparent is honoured)
  span_id       this request's span
  method/route/path/status   request facts
  remote        peer address
  duration_ms   end-to-end wall time
  bytes_in/bytes_out         source size / response size
  op            image operation name (image routes only)
  plan          16-hex digest of the operation, output type and query
  cache         off | result_miss | result_hit | etag_304
  coalesced     true when this request waited on another's pipeline run
  placement     device | host (where the pixels were computed)
  placement_attempts  the placement ladder the request walked
                (device:K, device:K:lane, device:mesh..., host_spill,
                shed_503), stamped by engine/executor.py and admission
  hedge         won | lost (only when a hedged host twin launched)
  tenant/qos_class    the resolved qos tenant and class (--qos-config)
  spans         [{name, start_ms, dur_ms}] the full timeline
  lane          serving-lane index of a device-path request on lanes
  device        device index of a global-queue dispatch
  cost_device_ms / cost_wire_bytes / cost_copied_bytes /
  cost_cache_bytes / cost_host_ms   the request's cost vector (only with
                --cost-attribution; obs/cost.py books the same numbers)
  loop_lag_ms   the last event-loop lag sample, only when it exceeded
                obs/looplag.WIDE_EVENT_THRESHOLD_MS
  deadline_budget_ms / deadline_remaining_ms / deadline_stages
                the request deadline's state (--request-timeout)
  sampled_reason  why the event survived tail sampling (SAMPLED_REASONS)

The reference's `worker` and `epoch` stamps belong to its --workers
supervisor, which the port does not have yet.

Tail sampling (--wide-events-sample): the interesting tail (errors,
sheds, deadline 504s, hedges, placement-ladder trouble, fenced publishes,
slow requests) is always emitted; the boring rest rolls a die. At the
default sample of 1.0 every event is kept ("random").
"""

from __future__ import annotations

import json
import random
import sys
import time

# every sampled_reason classify() can return
SAMPLED_REASONS = (
    "error",       # status >= 400 (but the shed and deadline specials)
    "shed",        # 503: admission, qos or pressure shed
    "deadline",    # 504: request deadline exceeded
    "hedged",      # a host hedge twin launched (won or lost)
    "placement",   # the placement ladder hit an error, quarantined or shed rung
    "fenced",      # the request touched a fenced shared-cache publish
    "slow",        # duration >= SLOW_KEEP_MS
    "random",      # boring, but won the probabilistic roll
    "unsampled",   # boring, lost the roll: classified but not emitted
)

# a request this slow is always kept, so the slow ring and the event
# stream agree on what the tail looks like
SLOW_KEEP_MS = 1000.0


def classify(event: dict, sample: float = 1.0, roll=None) -> str:
    """Tail-sampling verdict for a finished request's event. The most
    actionable signal wins: a shed 503 reads "shed", not "error", and a
    slow hedge "hedged", not "slow". `roll` is injectable for tests
    (random.random by default)."""
    status = event.get("status", 0)
    if status == 503:
        return "shed"
    if status == 504:
        return "deadline"
    if isinstance(status, int) and status >= 400:
        return "error"
    if event.get("hedge"):
        return "hedged"
    attempts = event.get("placement_attempts") or ()
    if any(
        ("error" in a) or ("quarantined" in a) or ("shed" in a)
        for a in attempts
        if isinstance(a, str)
    ):
        return "placement"
    if event.get("fenced_publish"):
        return "fenced"
    if float(event.get("duration_ms") or 0.0) >= SLOW_KEEP_MS:
        return "slow"
    if sample >= 1.0:
        return "random"
    if sample > 0.0 and (roll or random.random)() < sample:
        return "random"
    return "unsampled"


def emit(event: dict, out=None) -> None:
    event.setdefault("ts", round(time.time(), 6))
    line = json.dumps(event, separators=(",", ":"), default=str)
    (out or sys.stdout).write(line + "\n")
