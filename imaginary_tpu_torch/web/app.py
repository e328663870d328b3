"""Application assembly and server lifecycle (the port's copy of
`imaginary_tpu/web/app.py`; ref: server.go:69-174).

`create_app` builds the reference's aiohttp application: it arms the
failpoints from IMAGINARY_TPU_FAILPOINTS first (a bad spec raises), then
builds the qos policy (--qos-config), the memory-pressure governor
(--pressure-rss-mb), the SLO engine (--slo-config) and the cost plane
(--cost-attribution, seeded with the qos tenants), each once and shared
by the trace middleware, the throttle, the service and its executor; the
trace middleware outermost, the access log inside it, then the
middleware chain, and the route table under --path-prefix (`/`, `/form`, `/health`, `/metrics`, the
gated `/debugz`, `/debugz/profile` and `/debugz/failpoints`
(--enable-debug) and `/topz` (--cost-attribution), each a 404 while its
gate is off, and the 18 image routes); the event-loop lag probe runs
from the app's startup to its cleanup. With --prewarm it launches the
common chains on the service's device before it returns, so before any
server binds (prewarm.py). `serve` runs it until SIGINT or SIGTERM, with
TLS when a cert and key are given, HTTP/2 beside HTTP/1.1 there when
libnghttp2 loads and --disable-http2 is off (web/http2.py), the
--read-timeout guard on a listener without h2 (web/ingress.py), a
periodic memory release (engine/pressure.release_memory: gc.collect,
then malloc_trim), and a graceful drain: on the signal `app["draining"]`
is set (the trace middleware then answers image routes 503 with
Retry-After while /health keeps answering, and the h2 terminator sheds
new streams the same way), the listeners stay open for DRAIN_NOTICE_S so
clients and balancers meet that answer, and in-flight requests then get
the reference's 5 s. The notice is the port's own: the reference closes
its listener and its idle keep-alive connections at once, so its drain
answer is seldom seen.
`make_server` is the programmatic runner of the same application: it
binds at once and serves on the thread that calls `serve_forever`,
through the same listener.
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

from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.engine import pressure as pressure_mod
from imaginary_tpu_torch.errors import ErrNotFound
from imaginary_tpu_torch.obs import cost as cost_mod
from imaginary_tpu_torch.obs import debugz, looplag
from imaginary_tpu_torch.obs import slo as slo_mod
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
from imaginary_tpu_torch.web.middleware import (
    build_middlewares,
    error_response,
    trace_middleware,
)

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
    # arm the failpoints from IMAGINARY_TPU_FAILPOINTS here, not at import,
    # so a process that only imports the package stays unarmed; a bad
    # spec raises and fails the boot rather than arming nothing
    failpoints.activate_from_env()
    # the qos policy and the pressure governor, built once and handed to
    # everyone who enforces a slice of them (None when their flags are
    # off: every consumer takes its plain path)
    qos = load_policy(o.qos_config)
    governor = pressure_mod.from_options(o)
    slo = slo_mod.from_options(o)
    # from_options also installs the process's plane (None when off), the
    # one the metric label normalizer reads
    cost = cost_mod.from_options(o)
    if cost is not None and qos is not None:
        cost.seed_tenants(qos.tenant_names())
    # the trace middleware is outermost: it assigns the request identity
    # and installs the contextvar trace before the access log (which
    # reads the id) and everything inside it runs
    app = web.Application(
        middlewares=[trace_middleware(o, qos=qos, pressure=governor, slo=slo, cost=cost,
                                      events_out=log_stream),
                     access_log_middleware(o.log_level, log_stream)]
        + build_middlewares(o, qos=qos),
        client_max_size=CLIENT_MAX_SIZE,
    )
    service = ImageService(o, qos=qos, pressure=governor, slo=slo, cost=cost)
    app["service"] = service
    app["options"] = o
    if o.prewarm:
        # after the executor is built, before any server binds
        try:
            service.prewarm()
        except BaseException:
            service.close()
            raise

    async def on_startup(app):
        # the event-loop lag probe: the one host signal no stage ledger
        # covers, on while the server runs
        app["_looplag_task"] = looplag.start()
        # the fleet's forward-hop server needs the running loop; a no-op
        # unless --fleet-coherence
        await service.start_coherence()
        # the cross-host gossip thread: started with the server, not the
        # service, so a service built alone never polls; a no-op unless
        # --peers
        service.start_multihost()

    async def on_cleanup(app):
        looplag.stop(app.get("_looplag_task"))
        await service.aclose()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    prefix = o.path_prefix.rstrip("/")

    def add(path, handler, methods=("GET", "POST")):
        for m in methods:
            app.router.add_route(m, path, handler)

    add(prefix + "/" if prefix else "/", partial(_index, o, service))
    add(prefix + "/form", partial(_form, o), methods=("GET",))
    add(prefix + "/health", partial(_health, service), methods=("GET",))
    add(prefix + "/metrics", partial(_metrics, service), methods=("GET",))
    # gated introspection: a 404 unless --enable-debug, and not a public
    # path, so an API key (when set) is required as on an image route
    add(prefix + "/debugz", partial(_debugz, service, o), methods=("GET",))
    add(prefix + "/debugz/profile", partial(_debugz_profile, service, o), methods=("GET",))
    # the failpoints: GET their spec and counters, PUT a new spec (an
    # empty body disarms)
    add(prefix + "/debugz/failpoints", partial(_debugz_failpoints, o),
        methods=("GET", "PUT"))
    # the top-K consumers per window: a 404 unless a cost plane is armed
    add(prefix + "/topz", partial(_topz, service, o), methods=("GET",))
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


async def _debugz(service, o, request):
    if not o.enable_debug:
        return error_response(request, ErrNotFound, o)
    return web.json_response(debugz.debug_payload(service))


async def _topz(service, o, request):
    if service.cost is None:
        return error_response(request, ErrNotFound, o)
    return web.json_response(service.cost.topz())


async def _debugz_profile(service, o, request):
    if not o.enable_debug:
        return error_response(request, ErrNotFound, o)
    body, status = await debugz.profile_capture(request.query, str(service.device))
    return web.json_response(body, status=status)


async def _debugz_failpoints(o, request):
    if not o.enable_debug:
        return error_response(request, ErrNotFound, o)
    if request.method == "PUT":
        spec = (await request.text()).strip()
        try:
            failpoints.activate(spec)
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
    return web.json_response(failpoints.snapshot())


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
    # ALPN: h2 and http/1.1 like the reference (Go advertises h2 natively,
    # server.go:114) when the h2 terminator can run; http/1.1 alone when
    # libnghttp2 is absent or --disable-http2 is set, so negotiation never
    # selects a protocol this server cannot speak
    ctx.set_alpn_protocols(["h2", "http/1.1"] if _h2_active(o) else ["http/1.1"])
    ctx.load_cert_chain(o.cert_file, o.key_file)
    return ctx


def _h2_active(o: ServerOptions) -> bool:
    if not o.http2:
        return False
    from imaginary_tpu_torch.web.http2 import load_nghttp2

    return load_nghttp2() is not None


class _Listener:
    """The listening side of a server: with TLS and h2 active, the ALPN
    dispatcher in front of the h2 terminator and aiohttp's HTTP/1.1
    handler, the terminator forwarding each stream over a Unix socket in
    a mode-0700 directory with a per-process hop token (web/http2.py);
    else, with --read-timeout, aiohttp's handler behind the read guard
    (web/ingress.py); else aiohttp's own site. `sock` is a bound socket
    to serve on (AppServer's); None binds o.address:o.port."""

    def __init__(self):
        self.h2_server = None
        self.h2_client = None
        self.h2_conns: set = set()
        self.hop_dir = None
        self.server = None
        self.site = None

    async def start(self, runner, o: ServerOptions, ssl_ctx, sock=None) -> None:
        loop = asyncio.get_running_loop()
        # a --workers fleet shares the port through SO_REUSEPORT, on every
        # listener form
        reuse = o.workers > 1 or None
        where = {"sock": sock} if sock is not None else {"host": o.address or None,
                                                         "port": o.port,
                                                         "reuse_port": reuse}
        if ssl_ctx is not None and _h2_active(o):
            import os
            import secrets
            import tempfile

            import aiohttp

            from imaginary_tpu_torch.web import accesslog, http2

            # AF_UNIX paths cap at about 104-108 bytes: a deep TMPDIR
            # falls back to /tmp
            base = tempfile.gettempdir()
            if len(os.path.join(base, "imaginary-h2-XXXXXXXX", "hop.sock")) > 100:
                base = "/tmp"
            self.hop_dir = tempfile.mkdtemp(prefix="imaginary-h2-", dir=base)
            hop_sock = os.path.join(self.hop_dir, "hop.sock")
            await web.UnixSite(runner, hop_sock).start()
            self.h2_client = aiohttp.ClientSession(
                auto_decompress=False,  # bytes pass through verbatim
                connector=aiohttp.UnixConnector(path=hop_sock, limit=0))
            # the access log trusts X-Forwarded-* only from requests that
            # carry this process's token
            hop_token = secrets.token_hex(16)
            accesslog.set_trusted_hop_token(hop_token)
            http2.set_draining(False)
            client, conns = self.h2_client, self.h2_conns
            self.h2_server = await loop.create_server(
                lambda: http2.AlpnDispatcher(
                    runner.server,
                    lambda: http2.H2Protocol(client, hop_token=hop_token, conns=conns)),
                ssl=ssl_ctx, **where)
        elif o.read_timeout_s > 0:
            from imaginary_tpu_torch.web.ingress import ReadTimeoutGuard

            self.server = await loop.create_server(
                lambda: ReadTimeoutGuard(runner.server(), o.read_timeout_s),
                ssl=ssl_ctx, **where)
        elif sock is not None:
            self.site = web.SockSite(runner, sock, ssl_context=ssl_ctx)
            await self.site.start()
        else:
            self.site = web.TCPSite(runner, o.address or None, o.port, ssl_context=ssl_ctx,
                                    reuse_port=reuse)
            await self.site.start()

    async def stop_accepting(self) -> None:
        """Close the listening socket only (the rolling restart's SIGUSR1):
        SO_REUSEPORT sends new connections to the replacement worker,
        while in-flight and keep-alive requests here run to completion."""
        if self.h2_server is not None:
            self.h2_server.close()
        elif self.server is not None:
            self.server.close()
        elif self.site is not None:
            await self.site.stop()
            self.site = None

    def drain(self) -> None:
        """New h2 streams get the drain's 503 from now on."""
        if self.h2_server is not None:
            from imaginary_tpu_torch.web import http2

            http2.set_draining(True)

    async def close(self) -> None:
        """Stop accepting; in-flight h2 streams get the 5 s that HTTP/1.1
        requests get from runner.cleanup, before the hop's client closes."""
        if self.h2_server is not None:
            self.h2_server.close()
            await self.h2_server.wait_closed()
            deadline = asyncio.get_running_loop().time() + 5.0
            while (any(p.has_inflight() for p in self.h2_conns)
                   and asyncio.get_running_loop().time() < deadline):
                await asyncio.sleep(0.05)
        if self.h2_client is not None:
            await self.h2_client.close()
        if self.server is not None:
            self.server.close()
            await self.server.wait_closed()

    def cleanup(self) -> None:
        if self.hop_dir is not None:
            import shutil

            shutil.rmtree(self.hop_dir, ignore_errors=True)


async def serve(o: ServerOptions, mrelease: int = 30) -> None:
    """Run until SIGINT/SIGTERM; graceful 5 s drain (ref: server.go:144-165)."""
    import signal

    tune_gc_for_serving()
    app = create_app(o)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    listener = _Listener()
    try:
        await listener.start(runner, o, make_ssl_context(o))
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)

        def stop_accepting():
            print("imaginary-tpu-torch: SIGUSR1, listener closed, draining in-flight "
                  "work", flush=True)
            asyncio.ensure_future(listener.stop_accepting())

        loop.add_signal_handler(signal.SIGUSR1, stop_accepting)
        # SIGHUP is the supervisor's roll trigger, and often reaches the
        # whole process group: a serving process ignores it rather than die
        loop.add_signal_handler(
            signal.SIGHUP, lambda: print("imaginary-tpu-torch: SIGHUP ignored (rolling "
                                         "restarts are the supervisor's)", flush=True))

        async def memory_release():
            # the reference's FreeOSMemory ticker, returning memory for real
            while not stop.is_set():
                await asyncio.sleep(max(mrelease, 1))
                pressure_mod.release_memory()
                shm = app["service"].caches.shm
                if shm is not None:
                    # the fleet's sweepers: slots whose writer died
                    # mid-deposit, and claims whose holder died or was
                    # deposed
                    shm.sweep()
                    shm.claim_sweep()

        ticker = asyncio.create_task(memory_release()) if mrelease > 0 else None
        scheme = "https" if o.cert_file and o.key_file else "http"
        proto = " (h2+http/1.1)" if listener.h2_server is not None else ""
        print(f"imaginary-tpu-torch server listening on "
              f"{scheme}://{o.address or '0.0.0.0'}:{o.port}{proto} "
              f"(device {app['service'].device})", flush=True)
        await stop.wait()
        print("shutting down server", flush=True)
        # the drain: image work arriving in the notice gets a fast 503 with
        # Retry-After (trace middleware, and the h2 terminator's streams),
        # not a reset connection
        app["draining"] = True
        listener.drain()
        if ticker:
            ticker.cancel()
        await asyncio.sleep(DRAIN_NOTICE_S)
        await listener.close()
        await asyncio.wait_for(runner.cleanup(), timeout=5)
    finally:
        # a failed boot or a cleanup timeout must not leak the hop dir
        listener.cleanup()


class _Discard:
    """A log stream that drops what it is given."""

    def write(self, _s: str) -> None:
        pass


class AppServer:
    """The aiohttp application of `create_app` on a socket bound at
    construction, served on the thread that calls `serve_forever` (its own
    event loop) through the listener `serve` uses (h2 with TLS, the read
    guard), with the lifecycle of the standard library's servers:
    `server_address`, `serve_forever`, `shutdown` (from another thread;
    returns once in-flight requests have drained) and `server_close`
    (closes the socket and the service's executor)."""

    def __init__(self, o: ServerOptions, log_stream=None):
        self.app = create_app(o, log_stream=log_stream)
        self.options = o
        self.service: ImageService = self.app["service"]
        self.listener: Optional[_Listener] = None
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
            self.listener = _Listener()
            loop.run_until_complete(self.listener.start(runner, self.options, self._ssl,
                                                        sock=self.socket))
            self._stop = asyncio.Event()
            self._loop = loop
            self._ready.set()
            loop.run_until_complete(self._stop.wait())
            self.listener.drain()
            loop.run_until_complete(self.listener.close())
            loop.run_until_complete(asyncio.wait_for(runner.cleanup(), timeout=5))
        finally:
            self._ready.set()
            if self.listener is not None:
                self.listener.cleanup()
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
