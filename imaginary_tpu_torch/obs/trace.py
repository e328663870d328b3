"""Per-request trace identity and span accumulation (the port's copy of
`imaginary_tpu/obs/trace.py`).

One RequestTrace per HTTP request, carried by a contextvar: the web
middleware creates and activates it, and `contextvars.copy_context()`
carries it into the host pool, so spans recorded there (probe, decode,
execute, encode through engine/timing.py's record hook) attribute to the
right request. The executor's collector and fetcher threads carry no
trace: the stage times they measure for an item (batch_form,
dispatch_wait, drain) travel back with its result and are added on the
thread that submitted it (`engine/timing.attribute`).

The one exception is an executor item: it holds its request's trace
(`item.trace`), so the collector and fetcher stamp the placement ladder,
the hedge's outcome and, with a cost plane armed (obs/cost.py), the
item's share of its drain (`accumulate`) onto the right request from
their own threads; the trace's lock makes that safe.

The trace also carries the request's deadline (deadline.py) and, with a
qos policy, its tenant (qos/tenancy.TenantSpec, resolved by the trace
middleware), so `copy_context()` takes one vehicle into the pool
threads, and its wide-event fields (`annotate`, `accumulate`), which the
trace middleware turns into the request's wide event (`to_event`,
obs/events.py) and the slow ring's entry (obs/debugz.py).

Identity follows W3C Trace Context: an inbound `traceparent` header is
honored (same trace-id continues, this request's span becomes a child).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import re
import secrets
import threading
import time
from typing import Optional

# 00-<trace-id 32hex>-<parent-id 16hex>-<flags 2hex> (W3C Trace Context)
_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)
# Echoed into response headers and log lines: restrict to a safe charset
# so a hostile inbound id cannot inject headers or forge log fields.
_REQID_RE = re.compile(r"^[A-Za-z0-9._@=+/-]{1,128}$")
# Server-Timing metric names must be RFC 9110 tokens.
_TOKEN_SUB = re.compile(r"[^A-Za-z0-9_.-]").sub

_MAX_SPANS = 256  # hard cap; a runaway loop must not grow a trace unbounded


def new_request_id() -> str:
    return secrets.token_hex(16)


def sanitize_request_id(raw: str) -> str:
    """An inbound X-Request-ID is reused verbatim when it is a sane token;
    anything else (empty, oversized, hostile chars) is discarded and the
    middleware generates a fresh id."""
    return raw if raw and _REQID_RE.match(raw) else ""


class Span:
    __slots__ = ("name", "start_ms", "dur_ms")

    def __init__(self, name: str, start_ms: float, dur_ms: float):
        self.name = name
        self.start_ms = start_ms
        self.dur_ms = dur_ms

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "start_ms": round(self.start_ms, 3),
            "dur_ms": round(self.dur_ms, 3),
        }


class RequestTrace:
    """One request's identity, span timeline and wide-event fields."""

    __slots__ = ("request_id", "trace_id", "parent_span_id", "span_id",
                 "flags", "enabled", "t0", "spans", "fields", "deadline",
                 "tenant", "cost", "_lock")

    def __init__(self, request_id: str, traceparent: str = "",
                 enabled: bool = True):
        self.request_id = request_id
        m = _TRACEPARENT_RE.match(traceparent.strip().lower()) if traceparent else None
        if m:
            self.trace_id = m.group(1)
            self.parent_span_id = m.group(2)
            self.flags = m.group(3)
            self.span_id = os.urandom(8).hex()
        else:
            # one urandom call covers both ids (hot path: every request)
            rand = os.urandom(24).hex()
            self.trace_id = rand[:32]
            self.span_id = rand[32:]
            self.parent_span_id = ""
            self.flags = "01"
        self.enabled = enabled
        self.t0 = time.monotonic()
        self.spans: list = []
        self.fields: dict = {}
        # The request's Deadline (deadline.py), set by the web middleware
        # when --request-timeout is on. Enforcement works with tracing off:
        # `enabled` gates spans and fields, not the deadline.
        self.deadline = None
        # The request's qos TenantSpec (qos/tenancy.py), set by the web
        # middleware when a policy is armed; None with qos off.
        self.tenant = None
        # The cost plane (obs/cost.py) that books this request, set by the
        # trace middleware when --cost-attribution is armed; the byte-touch
        # ledger stamps the request's copied bytes only then.
        self.cost = None
        self._lock = threading.Lock()

    def add_span(self, name: str, dur_ms: float,
                 end: Optional[float] = None) -> None:
        if not self.enabled:
            return
        end = time.monotonic() if end is None else end
        start_ms = (end - self.t0) * 1000.0 - dur_ms
        with self._lock:
            if len(self.spans) < _MAX_SPANS:
                self.spans.append(Span(name, start_ms, dur_ms))

    def annotate(self, **fields) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.fields.update(fields)

    def accumulate(self, key: str, delta: float) -> None:
        """A thread-safe additive field: the cost stamps (cost_device_ms,
        cost_wire_bytes, ...) sum contributions from the executor's and
        the ledgers' threads here. Not gated on `enabled`: cost booking
        works with tracing off, and the fields reach a wide event only
        through `to_event`, which a request without tracing never builds."""
        with self._lock:
            self.fields[key] = self.fields.get(key, 0.0) + delta

    def field(self, key: str, default=None):
        with self._lock:
            return self.fields.get(key, default)

    def span_sum(self, names) -> float:
        """The summed duration of every span whose name is in `names`
        (the middleware's host-pool ms of a request, from its probe,
        decode, encode and host_spill spans)."""
        with self._lock:
            return sum(s.dur_ms for s in self.spans if s.name in names)

    def duration_ms(self) -> float:
        return (time.monotonic() - self.t0) * 1000.0

    def traceparent(self) -> str:
        """This request's own span context."""
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"

    def outbound_traceparent(self) -> str:
        """A fresh child span id for each outbound hop (each ?url= or
        watermark fetch is its own child of this request's span)."""
        return f"00-{self.trace_id}-{secrets.token_hex(8)}-{self.flags}"

    def exemplar(self) -> tuple:
        """(request_id, trace_id): the identity pair the latency
        histograms attach to their buckets."""
        return self.request_id, self.trace_id

    def server_timing(self, limit: int = 16) -> str:
        """RFC draft Server-Timing: one `name;dur=` entry per distinct span
        name (durations of repeated spans sum), first-seen order."""
        agg: dict = {}
        with self._lock:
            for s in self.spans:
                agg[s.name] = agg.get(s.name, 0.0) + s.dur_ms
        parts = [
            f"{_TOKEN_SUB('_', name)};dur={dur:.2f}"
            for name, dur in list(agg.items())[:limit]
        ]
        return ", ".join(parts)

    def to_event(self, **extra) -> dict:
        """The wide-event dict: identity, the extra keys (route, method,
        status, ...), the annotations and the full span timeline."""
        with self._lock:
            fields = dict(self.fields)
            spans = [s.to_dict() for s in self.spans]
        event = {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
        }
        event.update(extra)
        event.update(fields)
        event["spans"] = spans
        return event


_current: contextvars.ContextVar = contextvars.ContextVar(
    "imaginary_tpu_torch_trace", default=None
)


def activate(tr: RequestTrace):
    """Install `tr` as the current context's trace; returns a reset token."""
    return _current.set(tr)


def deactivate(token) -> None:
    _current.reset(token)


def current() -> Optional[RequestTrace]:
    return _current.get()


@contextlib.contextmanager
def span(name: str):
    """Time a block into the current trace; no-op when no trace is active
    (the pipeline works unchanged outside a request)."""
    tr = _current.get()
    if tr is None or not tr.enabled:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        end = time.monotonic()
        tr.add_span(name, (end - t0) * 1000.0, end=end)
