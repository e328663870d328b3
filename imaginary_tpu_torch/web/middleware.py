"""Middleware chain (the port's copy of `imaginary_tpu/web/middleware.py`;
ref: middleware.go:21-245).

The outermost `trace_middleware` assigns the request identity (and,
with a qos policy, the tenant), stamps the memory-pressure rung, sheds
image work with a 503 while the server drains for shutdown, and emits
Server-Timing, the request-duration histogram and the RED counters; with
their planes armed it feeds the SLO engine, books the request's cost
vector, and writes the wide event, which the slow-request ring notes
whenever tracing is on.
Inside it, `build_middlewares` composes in the reference's order:
request validation -> default headers -> cache headers -> API key ->
CORS -> throttle (keyed by tenant with qos) -> endpoint disabling. The HMAC URL signature
check and the image-request validation apply to image routes
(`web/handlers.py`).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import threading
import time
from email.utils import formatdate
from urllib.parse import urlencode

from aiohttp import web

from imaginary_tpu_torch import Version
from imaginary_tpu_torch import deadline as deadline_mod
from imaginary_tpu_torch.errors import (
    ErrGetMethodNotAllowed,
    ErrInvalidAPIKey,
    ErrInvalidURLSignature,
    ErrMethodNotAllowed,
    ErrNotImplemented,
    ErrURLSignatureMismatch,
    ImageError,
)
from imaginary_tpu_torch.obs import cost as obs_cost
from imaginary_tpu_torch.obs import events as obs_events
from imaginary_tpu_torch.obs import histogram as obs_hist
from imaginary_tpu_torch.obs import looplag as obs_looplag
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.obs.debugz import SLOW as obs_slow
from imaginary_tpu_torch.web.config import ServerOptions

# ref: middleware.go:231-238; /metrics is public like /health
PUBLIC_PATHS = ("/", "/health", "/form", "/metrics")

SERVER_HEADER = f"imaginary-tpu-torch {Version}"


def is_public_path(o: ServerOptions, path: str) -> bool:
    prefix = o.path_prefix.rstrip("/")
    if prefix and path.startswith(prefix):
        path = path[len(prefix):] or "/"
    return path in PUBLIC_PATHS


class GCRARateLimiter:
    """Generic cell rate algorithm, keyed by request method (the reference
    uses throttled/v2 with VaryBy{Method}; middleware.go:125-145).

    MAX_KEYS mirrors the reference's memstore cap (middleware.go:131,
    NewMemStore(65536)). Expired entries (tat in the past contributes
    nothing) are dropped first; if every key is live, the OLDEST-tat half
    is evicted — clients closest to throttle (largest tat) keep their
    state, so a key-flood cannot reset currently-throttled clients."""

    MAX_KEYS = 65536

    def __init__(self, per_sec: int, burst: int):
        self.emission = 1.0 / max(per_sec, 1)
        self.tau = self.emission * max(burst, 0)
        self._tat: dict = {}
        self._lock = threading.Lock()

    def allow(self, key: str, emission: float = None, tau: float = None):
        """Returns (allowed, retry_after_seconds). emission/tau override
        this limiter's own per call (the qos layer's per-tenant rates over
        one shared store, qos/limiter.py)."""
        emission = self.emission if emission is None else emission
        tau = self.tau if tau is None else tau
        now = time.monotonic()
        with self._lock:
            if len(self._tat) >= self.MAX_KEYS and key not in self._tat:
                self._tat = {k: t for k, t in self._tat.items() if t > now}
                if len(self._tat) >= self.MAX_KEYS:
                    keep = sorted(self._tat.items(), key=lambda kv: kv[1],
                                  reverse=True)[: self.MAX_KEYS // 2]
                    self._tat = dict(keep)
            tat = max(self._tat.get(key, now), now)
            if tat - now > tau:
                return False, tat - tau - now
            self._tat[key] = tat + emission
            return True, 0.0


def error_response(request: web.Request, err: ImageError,
                   o: ServerOptions) -> web.StreamResponse:
    """ErrorReply equivalent (error.go:58-67): JSON error, or placeholder
    image when enabled."""
    if o.enable_placeholder or o.placeholder:
        from imaginary_tpu_torch.web.placeholder import placeholder_response

        resp = placeholder_response(request, err, o)
        if resp is not None:
            if err.headers:
                resp.headers.update(err.headers)
            return resp
    return web.Response(
        body=err.json_bytes(),
        status=err.http_code(),
        content_type="application/json",
        headers=err.headers or None,
    )


def _route_label(request: web.Request) -> str:
    """Bounded RED-counter route label: the matched route's canonical
    pattern, never the raw path (an unmatched path must not mint a metric
    series per URL)."""
    try:
        canonical = request.match_info.route.resource.canonical
    except AttributeError:
        return "unmatched"
    return canonical or "unmatched"


def trace_middleware(o: ServerOptions, qos=None, pressure=None, slo=None, cost=None,
                     events_out=None):
    """Outermost middleware: request identity and trace lifecycle.

    Assigns or propagates X-Request-ID and W3C traceparent and installs
    the contextvar-carried RequestTrace that every inner layer records
    spans into (the access log runs inside it and reads the id), with the
    request's deadline when --request-timeout is set. With a qos policy
    the tenant is resolved here and rides the trace (the throttle, the
    admission gate and the executor's scheduler read it); with a
    pressure governor every traced request carries the rung it was
    admitted under. While the server drains for shutdown
    (`app["draining"]`), image routes answer 503 with Retry-After and the
    public paths (/health) keep answering. On the way out it
    echoes X-Request-ID, emits Server-Timing, observes the
    request-duration histogram (with the request's identity as a bucket
    exemplar when tracing is on) and the RED counters, feeds the SLO
    engine (`slo`), books the request's cost vector into the cost plane
    (`cost`; with tracing off too), stamps the event loop's lag when it
    passed the threshold, writes the deadline's budget, remaining ms and
    stages into the trace's fields, and with tracing on builds the wide
    event: tail-sampled (obs/events.classify), noted in the slow ring
    with its verdict, and with --wide-events written to `events_out`
    unless it lost the roll."""

    from imaginary_tpu_torch.web.workers import worker_epoch, worker_index

    # fixed for the life of a serving process: the supervisor stamps both
    # into its environment before the exec
    widx, wepoch = worker_index(), worker_epoch()

    @web.middleware
    async def mw(request: web.Request, handler):
        rid = obs_trace.sanitize_request_id(
            request.headers.get("X-Request-ID", "")
        ) or obs_trace.new_request_id()
        tr = obs_trace.RequestTrace(
            rid,
            traceparent=request.headers.get("traceparent", ""),
            enabled=o.trace_enabled,
        )
        if qos is not None:
            ten = qos.resolve(request)
            tr.tenant = ten
            if tr.enabled:
                tr.annotate(tenant=ten.name, qos_class=ten.klass)
        if pressure is not None and tr.enabled:
            # the rung this request was admitted under (the image handler
            # re-stamps after its own sample)
            tr.annotate(pressure=pressure.level_name())
        # the end-to-end deadline, minted next to the request id: the
        # server default, lowered (never raised) by X-Request-Timeout
        budget = deadline_mod.resolve_budget(
            o.request_timeout_s, request.headers.get("X-Request-Timeout", ""))
        if budget > 0.0:
            tr.deadline = deadline_mod.Deadline(budget)
        tr.cost = cost
        token = obs_trace.activate(tr)
        t0 = time.monotonic()
        status = 500  # a non-HTTP exception books as a 500
        resp = None
        try:
            if request.app.get("draining") and not is_public_path(o, request.path):
                # the shutdown drain: new image work is shed fast, with the
                # Retry-After the other 503s carry (another instance takes
                # the retry); /health stays live so a balancer sees the
                # drain itself
                from imaginary_tpu_torch.errors import new_error

                resp = error_response(
                    request, new_error("Server is shutting down, retry later", 503,
                                       headers={"Retry-After": "2"}), o)
                status = resp.status
                return resp
            resp = await handler(request)
            status = resp.status
            return resp
        except web.HTTPException as e:
            status = e.status
            e.headers["X-Request-ID"] = tr.request_id
            raise
        finally:
            obs_trace.deactivate(token)
            elapsed = time.monotonic() - t0
            route = _route_label(request)
            obs_hist.REQUEST_SECONDS.observe(
                elapsed, exemplar=tr.exemplar() if tr.enabled else None
            )
            obs_hist.REQUESTS_TOTAL.inc((route, f"{status // 100}xx"))
            if slo is not None:
                slo.observe(route, status, elapsed)
            if cost is not None and cost.should_book(route):
                # the executor's and the ledgers' stamps plus the host-pool
                # ms of the host-stage spans, booked with tracing off too
                host_ms = tr.span_sum(obs_cost.HOST_STAGES)
                if host_ms and tr.enabled:
                    tr.accumulate("cost_host_ms", host_ms)
                ten = tr.tenant
                cost.book(
                    tenant=ten.name if ten is not None else "default",
                    qos_class=ten.klass if ten is not None else "-",
                    route=route,
                    op=route.strip("/").split("/")[-1] or "-",
                    device_ms=tr.field("cost_device_ms", 0.0),
                    host_ms=host_ms,
                    wire_bytes=tr.field("cost_wire_bytes", 0.0),
                    copied_bytes=tr.field("cost_copied_bytes", 0.0),
                    cache_bytes=tr.field("cost_cache_bytes", 0.0),
                )
            if tr.enabled:
                # a slow request during a lag spike carries the evidence
                lag_ms = obs_looplag.last_ms()
                if lag_ms >= obs_looplag.WIDE_EVENT_THRESHOLD_MS:
                    tr.annotate(loop_lag_ms=round(lag_ms, 3))
            if resp is not None:
                resp.headers["X-Request-ID"] = tr.request_id
                if tr.enabled:
                    st = tr.server_timing()
                    if st:
                        resp.headers["Server-Timing"] = st
            if tr.enabled and tr.deadline is not None:
                # the budget, what was left at the end, and the remaining
                # ms at each stage the hops noted
                dl = tr.deadline
                tr.annotate(
                    deadline_budget_ms=round(dl.budget_s * 1000.0, 1),
                    deadline_remaining_ms=round(dl.remaining_s() * 1000.0, 1),
                    deadline_stages=dl.stages_dict(),
                )
            if tr.enabled:
                event = tr.to_event(
                    method=request.method,
                    route=route,
                    path=request.path_qs,
                    status=status,
                    remote=request.remote or "-",
                    duration_ms=round(elapsed * 1000.0, 3),
                    bytes_out=(resp.content_length or 0) if resp is not None else 0,
                    # a fleet's merged streams name the process and its
                    # fencing generation
                    worker=widx,
                    epoch=wepoch,
                )
                # classified before the slow ring notes it, so /debugz shows
                # the verdict the emitted line carries
                event["sampled_reason"] = obs_events.classify(event, o.wide_events_sample)
                obs_slow.note(event)
                if o.wide_events and event["sampled_reason"] != "unsampled":
                    obs_events.emit(event, events_out)

    return mw


def build_middlewares(o: ServerOptions, qos=None) -> list:
    """The chain, outermost first."""
    mws = [_validate_request(o), _default_headers(o)]
    if o.http_cache_ttl >= 0:
        mws.append(_cache_headers(o))
    if o.api_key:
        mws.append(_authorize(o))
    if o.cors:
        mws.append(_cors(o))
    # the throttle installs for the global --concurrency, and also when a
    # qos tenant carries its own rate (its contract binds with no global
    # ceiling)
    if o.concurrency > 0 or (qos is not None and qos.any_rate()):
        mws.append(_throttle(o, qos))
    if o.endpoints:
        mws.append(_endpoints_guard(o))
    return mws


def _validate_request(o: ServerOptions):
    @web.middleware
    async def mw(request, handler):
        # GET/POST only (ref: middleware.go:179-187); OPTIONS passes only
        # for CORS preflight, PUT only for the gated failpoint control
        # (/debugz/failpoints)
        if request.method not in ("GET", "POST") and not (
            request.method == "OPTIONS" and o.cors
        ) and not (
            request.method == "PUT"
            and o.enable_debug
            and request.path.endswith("/debugz/failpoints")
        ):
            return error_response(request, ErrMethodNotAllowed, o)
        return await handler(request)

    return mw


def _default_headers(o: ServerOptions):
    @web.middleware
    async def mw(request, handler):
        try:
            resp = await handler(request)
        except web.HTTPException as e:
            e.headers["Server"] = SERVER_HEADER
            raise
        resp.headers["Server"] = SERVER_HEADER
        return resp

    return mw


def _cache_headers(o: ServerOptions):
    ttl = o.http_cache_ttl

    @web.middleware
    async def mw(request, handler):
        resp = await handler(request)
        if request.method == "GET" and not is_public_path(o, request.path):
            if ttl == 0:
                control = "private, no-cache, no-store, must-revalidate"
            else:
                control = f"public, s-maxage={ttl}, max-age={ttl}, no-transform"
            resp.headers["Cache-Control"] = control
            resp.headers["Expires"] = formatdate(time.time() + ttl, usegmt=True)
        return resp

    return mw


def _authorize(o: ServerOptions):
    @web.middleware
    async def mw(request, handler):
        key = request.headers.get("API-Key") or request.query.get("key", "")
        if key != o.api_key:
            return error_response(request, ErrInvalidAPIKey, o)
        return await handler(request)

    return mw


def _cors(o: ServerOptions):
    @web.middleware
    async def mw(request, handler):
        if request.method == "OPTIONS":
            resp = web.Response(status=204)
        else:
            resp = await handler(request)
        resp.headers["Access-Control-Allow-Origin"] = "*"
        resp.headers["Access-Control-Allow-Methods"] = "GET, POST"
        resp.headers["Access-Control-Allow-Headers"] = "Origin, Accept, Content-Type, API-Key"
        return resp

    return mw


def _throttle(o: ServerOptions, qos=None):
    """Without qos: the reference's method-keyed GCRA on the global
    --concurrency and --burst. With qos: keyed by the tenant the trace
    middleware stamped, each tenant's rate and burst overriding the
    global ones (qos/limiter.py), and counted per class. The 429 carries
    the JSON error body (or the placeholder, when enabled) like every
    other terminal error."""
    limiter = GCRARateLimiter(o.concurrency, o.burst)
    tenant_limiter = None
    if qos is not None:
        from imaginary_tpu_torch.qos.limiter import TenantLimiter

        tenant_limiter = TenantLimiter(o.concurrency, o.burst)

    @web.middleware
    async def mw(request, handler):
        if tenant_limiter is None:
            allowed, retry = limiter.allow(request.method)
        else:
            tr = obs_trace.current()
            ten = getattr(tr, "tenant", None) if tr is not None else None
            if ten is None:
                ten = qos.default
            allowed, retry = tenant_limiter.allow(ten)
            if not allowed:
                qos.stats.note_rate_limited(ten.class_index)
        if not allowed:
            err = ImageError(
                "Too Many Requests", 429,
                headers={"Retry-After": str(max(1, int(retry + 0.5)))})
            return error_response(request, err, o)
        return await handler(request)

    return mw


def _endpoints_guard(o: ServerOptions):
    @web.middleware
    async def mw(request, handler):
        if not o.is_endpoint_enabled(request.path):
            return error_response(request, ErrNotImplemented, o)
        return await handler(request)

    return mw


# --- image-route-only guards (ref: ImageMiddleware, middleware.go:43-54) ------

def check_url_signature(request: web.Request, o: ServerOptions):
    """HMAC-SHA256 over path + sorted query minus `sign`, base64url-raw
    (ref: middleware.go:205-229). Raises on failure."""
    query = [(k, v) for k, v in request.query.items() if k != "sign"]
    sign = request.query.get("sign", "")
    mac = hmac.new(o.url_signature_key.encode(), digestmod=hashlib.sha256)
    mac.update(request.path.encode())
    mac.update(urlencode(sorted(query)).encode())
    try:
        # raw (unpadded) URL-safe base64, strict alphabet (Go's
        # base64.RawURLEncoding errors on invalid chars)
        given = base64.b64decode(sign + "=" * (-len(sign) % 4), altchars=b"-_", validate=True)
    except Exception:
        raise ErrInvalidURLSignature from None
    if not hmac.compare_digest(given, mac.digest()):
        raise ErrURLSignatureMismatch


def validate_image_request(request: web.Request, o: ServerOptions):
    """GET image requests need -mount or -enable-url-source
    (ref: middleware.go:189-203)."""
    if request.method == "GET" and not is_public_path(o, request.path):
        if not o.mount and not o.enable_url_source:
            raise ErrGetMethodNotAllowed


def sign_url(key: str, path: str, query_pairs: list) -> str:
    """Client-side signing helper (inverse of check_url_signature)."""
    mac = hmac.new(key.encode(), digestmod=hashlib.sha256)
    mac.update(path.encode())
    mac.update(urlencode(sorted(query_pairs)).encode())
    return base64.urlsafe_b64encode(mac.digest()).decode().rstrip("=")
