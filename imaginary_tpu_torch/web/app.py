"""Application assembly and server lifecycle (the port's copy of
`imaginary_tpu/web/app.py`; ref: server.go:69-174).

`create_app` builds the reference's aiohttp application: the qos policy
(--qos-config) and the memory-pressure governor (--pressure-rss-mb), each
once and shared by the trace middleware, the throttle, the service and
its executor; the trace middleware outermost, the access log inside it,
then the middleware chain, and the route table under --path-prefix (`/`,
`/form`, `/health`, `/metrics` and the 18 image routes), and with
--prewarm launches the common chains on the service's device before it
returns, so before any server binds (prewarm.py). `serve` runs it until
SIGINT or SIGTERM, with TLS when a cert and key are given (HTTP/1.1; h2
is a later slice), a periodic memory release (engine/pressure.
release_memory: gc.collect, then malloc_trim), and a graceful drain: on
the signal `app["draining"]` is set (the trace middleware then answers
image routes 503 with Retry-After while /health keeps answering), the
listener stays open for DRAIN_NOTICE_S so clients and balancers meet
that answer, and in-flight requests then get the reference's 5 s. The
notice is the port's own: the reference closes its listener and its
idle keep-alive connections at once, so its drain answer is seldom
seen.
`make_server` is the programmatic runner of the same application: it
binds at once and serves on the thread that calls `serve_forever`.
"""

from __future__ import annotations

import asyncio
import gc
import socket
import ssl
import threading
from functools import partial
from typing import Optional

from aiohttp import web

from imaginary_tpu_torch.engine import pressure as pressure_mod
from imaginary_tpu_torch.ops.plan import OPERATION_NAMES
from imaginary_tpu_torch.qos.tenancy import load_policy
from imaginary_tpu_torch.web.accesslog import access_log_middleware
from imaginary_tpu_torch.web.config import ServerOptions
from imaginary_tpu_torch.web.handlers import (
    ImageService,
    form_controller,
    health_controller,
    index_controller,
)
from imaginary_tpu_torch.web.metrics import render_metrics
from imaginary_tpu_torch.web.middleware import build_middlewares, trace_middleware

ALL_OPERATIONS = OPERATION_NAMES + ("info", "pipeline")

CLIENT_MAX_SIZE = 1 << 26  # 64 MB body cap (ref: source_body.go:13)
DRAIN_NOTICE_S = 0.5  # seconds the draining server keeps answering (serve)


def tune_gc_for_serving() -> None:
    """Raise CPython's GC thresholds for the serving process: image
    serving churns large short-lived buffers that refcounting frees, and
    the default gen0 threshold fires collections constantly. Called from
    `serve`, the process owner, not from building an app."""
    gc.set_threshold(50_000, 50, 100)


def create_app(o: ServerOptions, log_stream=None) -> web.Application:
    # the qos policy and the pressure governor, built once and handed to
    # everyone who enforces a slice of them (None when their flags are
    # off: every consumer takes its plain path)
    qos = load_policy(o.qos_config)
    governor = pressure_mod.from_options(o)
    # the trace middleware is outermost: it assigns the request identity
    # and installs the contextvar trace before the access log (which
    # reads the id) and everything inside it runs
    app = web.Application(
        middlewares=[trace_middleware(o, qos=qos, pressure=governor),
                     access_log_middleware(o.log_level, log_stream)]
        + build_middlewares(o, qos=qos),
        client_max_size=CLIENT_MAX_SIZE,
    )
    service = ImageService(o, qos=qos, pressure=governor)
    app["service"] = service
    app["options"] = o
    if o.prewarm:
        # after the executor is built, before any server binds
        try:
            service.prewarm()
        except BaseException:
            service.close()
            raise

    async def on_cleanup(app):
        await service.aclose()

    app.on_cleanup.append(on_cleanup)
    prefix = o.path_prefix.rstrip("/")

    def add(path, handler, methods=("GET", "POST")):
        for m in methods:
            app.router.add_route(m, path, handler)

    add(prefix + "/" if prefix else "/", partial(_index, o, service))
    add(prefix + "/form", partial(_form, o), methods=("GET",))
    add(prefix + "/health", partial(_health, service), methods=("GET",))
    add(prefix + "/metrics", partial(_metrics, service), methods=("GET",))
    for name in ALL_OPERATIONS:
        route = "/" + name.lower()  # /watermarkimage
        add(prefix + route, partial(_image, service, name))
    return app


async def _index(o, service, request):
    return await index_controller(request, o, service)


async def _form(o, request):
    return await form_controller(request, o)


async def _health(service, request):
    return await health_controller(request, service)


async def _metrics(service, request):
    # the numbers of /health in the Prometheus exposition format;
    # ?exemplars=1 adds OpenMetrics exemplar clauses to the histograms
    exemplars = request.query.get("exemplars", "") in ("1", "true")
    return web.Response(text=render_metrics(service.health(), exemplars=exemplars),
                        content_type="text/plain", charset="utf-8")


async def _image(service, name, request):
    return await service.handle(request, name)


def _pin_groups(ctx) -> bool:
    """Pin the reference's curve preferences (X25519, P-256, P-384 —
    server.go:116-120) where ssl has set_groups (Python >= 3.13); before
    that the default order, which already leads with X25519, stays.
    Returns whether the pin was applied."""
    if hasattr(ctx, "set_groups"):
        ctx.set_groups("x25519:prime256v1:secp384r1")
        return True
    return False


def make_ssl_context(o: ServerOptions) -> Optional[ssl.SSLContext]:
    if not (o.cert_file and o.key_file):
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2  # ref: server.go:115
    # the reference's cipher suites (server.go:114-131): ECDHE with
    # AES-GCM or ChaCha20-Poly1305 only; TLS 1.3 suites stay default-on
    ctx.set_ciphers(
        "ECDHE-ECDSA-AES256-GCM-SHA384:ECDHE-RSA-AES256-GCM-SHA384:"
        "ECDHE-ECDSA-AES128-GCM-SHA256:ECDHE-RSA-AES128-GCM-SHA256:"
        "ECDHE-ECDSA-CHACHA20-POLY1305:ECDHE-RSA-CHACHA20-POLY1305"
    )
    _pin_groups(ctx)
    # HTTP/1.1 only: ALPN never selects a protocol this server cannot speak
    ctx.set_alpn_protocols(["http/1.1"])
    ctx.load_cert_chain(o.cert_file, o.key_file)
    return ctx


async def serve(o: ServerOptions, mrelease: int = 30) -> None:
    """Run until SIGINT/SIGTERM; graceful 5 s drain (ref: server.go:144-165)."""
    import signal

    tune_gc_for_serving()
    app = create_app(o)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, o.address or None, o.port, ssl_context=make_ssl_context(o))
    await site.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)

    async def memory_release():
        # the reference's FreeOSMemory ticker, returning memory for real
        while not stop.is_set():
            await asyncio.sleep(max(mrelease, 1))
            pressure_mod.release_memory()

    ticker = asyncio.create_task(memory_release()) if mrelease > 0 else None
    scheme = "https" if o.cert_file and o.key_file else "http"
    print(f"imaginary-tpu-torch server listening on "
          f"{scheme}://{o.address or '0.0.0.0'}:{o.port} "
          f"(device {app['service'].device})", flush=True)
    await stop.wait()
    print("shutting down server", flush=True)
    # the drain: image work arriving in the notice gets a fast 503 with
    # Retry-After (trace middleware), not a reset connection
    app["draining"] = True
    if ticker:
        ticker.cancel()
    await asyncio.sleep(DRAIN_NOTICE_S)
    await asyncio.wait_for(runner.cleanup(), timeout=5)


class _Discard:
    """A log stream that drops what it is given."""

    def write(self, _s: str) -> None:
        pass


class AppServer:
    """The aiohttp application of `create_app` on a socket bound at
    construction, served on the thread that calls `serve_forever` (its own
    event loop), with the lifecycle of the standard library's servers:
    `server_address`, `serve_forever`, `shutdown` (from another thread;
    returns once in-flight requests have drained) and `server_close`
    (closes the socket and the service's executor)."""

    def __init__(self, o: ServerOptions, log_stream=None):
        self.app = create_app(o, log_stream=log_stream)
        self.service: ImageService = self.app["service"]
        try:
            self._ssl = make_ssl_context(o)
            self.socket = socket.create_server((o.address or "0.0.0.0", o.port),
                                               backlog=128)
        except BaseException:
            self.service.close()
            raise
        self.server_address = self.socket.getsockname()[:2]
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None
        self._ready = threading.Event()
        self._done = threading.Event()

    def serve_forever(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(self.app, access_log=None, handle_signals=False)
        try:
            loop.run_until_complete(runner.setup())
            loop.run_until_complete(
                web.SockSite(runner, self.socket, ssl_context=self._ssl).start())
            self._stop = asyncio.Event()
            self._loop = loop
            self._ready.set()
            loop.run_until_complete(self._stop.wait())
            loop.run_until_complete(asyncio.wait_for(runner.cleanup(), timeout=5))
        finally:
            self._ready.set()
            loop.close()
            self._done.set()

    def shutdown(self) -> None:
        """Stop serve_forever (called from another thread) and wait for it
        to return."""
        self._ready.wait()
        loop = self._loop
        if loop is not None and not self._done.is_set():
            loop.call_soon_threadsafe(self._stop.set)
            self._done.wait()

    def server_close(self) -> None:
        self.socket.close()
        self.service.close()


def make_server(host: str = "0.0.0.0", port: int = 9000, device="cuda",
                mount: str = "", log_stream=None, **options) -> AppServer:
    """Bind (not start) the server; `serve_forever()` runs it and
    `shutdown()` + `server_close()` stop it (and its executor). Keyword
    arguments set the fields of ServerOptions (max_batch, batch_form_ms,
    max_inflight, transport_dct, mesh_policy, n_devices, devices, spatial,
    api_key, enable_placeholder, ...). The access log is dropped unless
    `log_stream` is given."""
    o = ServerOptions(address=host, port=port, device=str(device), mount=mount,
                      **options)
    return AppServer(o, log_stream=log_stream if log_stream is not None else _Discard())
