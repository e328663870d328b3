"""Controllers and the image handler (the port's copy of
`imaginary_tpu/web/handlers.py`, trimmed to the subsystems the port has).

`ImageService` owns the micro-batching executor, the host thread pool
and the sources. Its `handle` coroutine is the image routes' controller:
the URL signature and GET-source checks and the source fetch (a remote
GET for `?url=`, inside the `fetch` span), then the framework-free core,
`ImageService.process`, on the pool (`--cpus` workers, or max(4, usable
CPUs)) under the request's context, so its spans land in the request's
trace. The core runs the reference's handler semantics
(controllers.go:79-156): media-type sniffing, param parsing, `type=auto`
Accept negotiation with `Vary: Accept`, output-format validation, the
--max-allowed-resolution guard, the pipeline, and --return-size's
headers. For `/watermarkimage` and `/pipeline` those checks run on the
event loop, and then the watermark image's URL is fetched and decoded
there too (`_prefetch_watermark`), before the pool dispatch, as the
reference's handler does. The device work of concurrent requests batches
in the executor, on the service's device. Every processed image answers
`X-Imaginary-Backend` with where its pixels were computed: `device`, or
`host` for the executor's counted host placements (engine/executor.py:
--force-host, the spill, the breaker's outage, a hedge's twin, an OOM
bisection's item, integrity's verified copy); the value rides on the
request's trace as `placement`, beside the other wide-event fields the
handler stamps (obs/events.py): `op`, `bytes_in`, and once the request
is past the core's checks its `plan` digest and `cache` outcome.

Admission (`_admit`, the reference's handlers.py:352-470, in its
order), before the source is fetched: the `qos.admit` failpoint (an
injected shed, 503 + Retry-After 1); with a memory-pressure governor,
the critical rung's shed of batch-class qos work (503 + Retry-After 2);
`--max-queue-ms`, graded per qos class (qos/shed.py: batch sheds at half
the budget, standard at three quarters), a 503 with Retry-After from the
queue estimate; the request deadline's admission below; then the class's
`admitted` count. With a governor, `prepare` arms the codec's pre-decode
dimension gate at --max-allowed-resolution (an over-cap source is a 413,
where the reference's plain guard answers 422), and at critical clamps
both the source and the requested output to `pressure_pixel_frac` of it
(413 + Retry-After 2). The governor's transition callback is the cache
tiers' brownout (`CacheSet.apply_pressure`: halved budgets at elevated;
at critical a quarter, and the source and device tiers off). A tenant
over its queue share gets the executor's 503.

The cache tiers (cache.py, the reference's handlers.py:593-805), all off
by default. With a keyed tier (--cache-result-mb or --cache-coalesce)
the core's checks run on the event loop, and the request key (the
source's sha256 x the operation's options after Accept negotiation)
answers a matching If-None-Match with 304 (`ETag`, `Vary`, no body)
before the pipeline, serves a stored result with its stored
X-Imaginary-Backend, and with --cache-coalesce runs N concurrent
identical requests as one pool dispatch (one `_inflight` unit); a
successful result is stored and every answer of the result tier carries
its strong `ETag`. Errors are never stored. Without a keyed tier the
checks run in the pool, as they always have. --cache-frame-mb hands the
decoded-frame tier and the digest to the pipeline, --cache-device-mb
arms the device-resident frame tier (ops/chain.py) and
--cache-source-ttl the sources' TTL cache. /health carries the tiers'
counters (`cache`).

The cross-host plane (fleet/router.py, the reference's handlers.py:160-172,
:396-405, :480-507, :673-715), off unless --peers: every answer carries
`X-Imaginary-Host-Epoch` (this host's `id:epoch`); with --router (or a
request's `X-Imaginary-Route: route`) a request whose shared key another
host owns is shipped one hop there after the local cache lookups and
before the intra-host forward (the source in the body, `url`, `file` and
`sign` dropped from the query, `type=auto` resolved), and any fault runs
it here; at the critical rung, batch-class work is offered verbatim to
the least-loaded non-critical peer before its 503. A request that came
over a hop is neither routed nor spilled again. A host-fenced worker
(a newer host incarnation in the shm header) refuses the forward hop.

With `--request-timeout` set, the request's deadline (deadline.py) is
enforced at each hop here: admission sheds a 503 with Retry-After when
the estimated queue delay already exceeds the remaining budget (a 504
when it is spent), the wait for the pool is bounded by the budget (a 504
at stage `queue`), a pool worker checks it before decoding a byte
(`host_pool`), and the wait for the executor's result is bounded too (a
504 at stage `device_execute`, the item cancelled so the executor drops
it before launch and releases its owed MB).

Served: `/`, `/form`, `/health`, `/metrics`, `/info` and every image
route on JPEG (the native codec) and PNG, WEBP, GIF and TIFF (Pillow).
"""

from __future__ import annotations

import asyncio
import collections
import contextvars
import dataclasses
import hashlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Optional

import numpy as np
import torch
from aiohttp import web

from imaginary_tpu_torch import Version, codecs, failpoints, pipeline
from imaginary_tpu_torch import cache as cache_mod
from imaginary_tpu_torch import deadline as deadline_mod
from imaginary_tpu_torch.codecs import jpeg_dct, native_backend
from imaginary_tpu_torch.engine import Executor, ExecutorConfig, host_exec
from imaginary_tpu_torch.engine import executor as executor_mod
from imaginary_tpu_torch.engine import integrity as integrity_mod
from imaginary_tpu_torch.engine import pressure as pressure_mod
from imaginary_tpu_torch.engine.timing import COPIES, attribute
from imaginary_tpu_torch.errors import (
    ErrEmptyBody,
    ErrNotFound,
    ErrOutputFormat,
    ErrResolutionTooBig,
    ErrUnsupportedMedia,
    ImageError,
    new_error,
)
from imaginary_tpu_torch.imgtype import (
    ImageType,
    determine_image_type,
    get_image_mime_type,
    image_type,
    is_image_mime_type_supported,
)
from imaginary_tpu_torch.obs import cost as cost_mod
from imaginary_tpu_torch.obs import slo as slo_mod
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.options import ImageOptions
from imaginary_tpu_torch.params import ParamError, build_params_from_query
from imaginary_tpu_torch.qos.shed import shed_for_pressure
from imaginary_tpu_torch.qos.tenancy import load_policy
from imaginary_tpu_torch.web.config import ServerOptions
from imaginary_tpu_torch.web.health import get_health_stats
from imaginary_tpu_torch.web.middleware import (
    check_url_signature,
    error_response,
    validate_image_request,
)
from imaginary_tpu_torch.web.sources import SourceRegistry

# routes whose options may name a watermark image to fetch
_MARKED_ROUTES = ("watermarkImage", "pipeline")

_ACCEPT_TO_TYPE = {"image/webp": "webp", "image/png": "png", "image/jpeg": "jpeg"}

# the header bytes a --return-size probe of a fleet tier entry reads
_PROBE_PREFIX = 64 * 1024

# resized placeholders kept per service: an error storm asks for the same
# few shapes again and again (ref: placeholder.py:37-47)
_PLACEHOLDER_CACHE = 64


@dataclasses.dataclass
class Prepared:
    """A request past the core's checks: its options, the Vary header of
    its Accept negotiation, and the header probe the guard made."""

    opts: ImageOptions
    vary: str
    meta: object = None


@dataclasses.dataclass
class Response:
    """An image route's answer, free of any HTTP framework."""

    status: int
    content_type: str
    body: bytes
    headers: dict = dataclasses.field(default_factory=dict)


def determine_accept_mime_type(accept: str) -> str:
    """Preferred output format from the Accept header
    (ref: controllers.go:63-76)."""
    for part in accept.split(","):
        media = part.split(";", 1)[0].strip().lower()
        if media in _ACCEPT_TO_TYPE:
            return _ACCEPT_TO_TYPE[media]
    return ""


def _retry_after_s(est_ms: Optional[float]) -> str:
    """Retry-After seconds of a shed 503, from the queue estimate (floor
    1 s)."""
    return str(max(1, int((est_ms or 0.0) / 1000.0 + 0.5)))


def available_cpus() -> int:
    """CPUs this process may run on (the affinity mask, not the host's
    core count)."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except AttributeError:  # not Linux
        return os.cpu_count() or 1


class ImageService:
    """Owns the micro-batch executor (on `o.device`, or one lane per mesh
    entry with a `mesh_policy`), the host thread pool and the sources.
    Keyword arguments override fields of `o` (ServerOptions() when None).
    `qos`, `pressure`, `slo` and `cost` are the app's policy, governor,
    SLO engine and cost plane (create_app builds each once); a service
    built alone derives them from `o`. The cost plane is bound to the
    executor (its drain floor and ms/MB EWMA) and to the host pool's
    occupancy. The
    dct transport switches, the dct decoder arm, donation and the codec
    arena's cap are process-wide, set here from the options as the
    reference's service sets them, and so is the device frame tier
    (`chain.set_device_frame_cache`, released again by `close()`).
    `close()` shuts the executor and the pool down."""

    def __init__(self, o: Optional[ServerOptions] = None, qos=None, pressure=None,
                 slo=None, cost=None, **overrides):
        o = dataclasses.replace(o or ServerOptions(), **overrides)
        if o.transport_dct_egress and not o.transport_dct:
            raise ValueError("the dct egress requires the dct transport")
        self.options = o
        self.device = torch.device(o.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass --device cpu to serve on the CPU")
        self.started = time.time()
        # the content-addressed cache tiers (cache.py), all off by default
        self.caches = cache_mod.CacheSet.from_options(o)
        # the fleet data plane (fleet/), off unless --fleet-cache-mb: the
        # shm result tier behind the local one (under a supervisor its
        # file rides in through IMAGINARY_TPU_FLEET_PATH, this worker's
        # index and fencing epoch through the environment); with
        # --fleet-coherence the ownership ring, the forward hop and fleet
        # singleflight; with --fleet-qos the shared GCRA and share tables
        # the qos layer reads (unregistered again by close())
        self.coherence = None
        self._forward_server = None
        self._armed_fleet_qos = False
        if o.fleet_cache_mb > 0:
            from imaginary_tpu_torch.fleet import ownership
            from imaginary_tpu_torch.fleet.shmcache import ShmCache
            from imaginary_tpu_torch.web.workers import worker_epoch, worker_index

            self.caches.attach_shm(ShmCache.from_options(
                o, worker=worker_index(), epoch=worker_epoch()))
            if o.fleet_coherence:
                self.coherence = ownership.FleetCoherence(
                    self.caches.shm, worker=worker_index(), hop_s=o.fleet_hop_ms / 1000.0)
            if o.fleet_qos:
                ownership.set_fleet_qos(ownership.FleetQos(self.caches.shm))
                self._armed_fleet_qos = True
        # the cross-host plane (fleet/multihost.py, fleet/router.py): None
        # unless --peers, and then no peer table, no gossip thread, no
        # route or spill code on the request path and no new header
        self.multihost = None
        if o.peers:
            from imaginary_tpu_torch.fleet import multihost as multihost_mod
            from imaginary_tpu_torch.fleet import router as router_mod

            hid, hepoch = multihost_mod.ensure_host_identity(o.host_id)
            self.multihost = router_mod.HostRouter(
                multihost_mod.PeerTable(multihost_mod.parse_peers(o.peers)),
                self_id=hid, self_epoch=hepoch, route_all=o.router,
                hop_s=o.fleet_hop_ms / 1000.0,
                probe_interval_s=o.peer_probe_interval)
        self.frame_cache = cache_mod.FrameCache(self.caches.frames, self.caches.stats)
        self.registry = SourceRegistry(o, caches=self.caches)
        # output integrity (None when --integrity is off); the golden
        # triple is built at boot when its probe is armed
        self.integrity = integrity_mod.from_options(o)
        if self.integrity is not None or o.failslow_ratio > 0.0:
            integrity_mod.golden()
        host_exec.set_dct_spill(o.host_dct_spill)
        self.qos = qos if qos is not None else load_policy(o.qos_config)
        self.pressure = pressure if pressure is not None else pressure_mod.from_options(o)
        if self.pressure is not None:
            # the tiers shrink and restore on the governor's transitions
            self.pressure.on_transition(lambda _old, new: self.caches.apply_pressure(new))
        # None when their flags are off: no slo or capacity block anywhere
        self.slo = slo if slo is not None else slo_mod.from_options(o)
        if cost is None and o.cost_attribution:
            cost = cost_mod.from_options(o)
            if self.qos is not None:
                cost.seed_tenants(self.qos.tenant_names())
        self.cost = cost
        jpeg_dct.set_decoder(o.dct_native)
        if o.arena_mb > 0:
            native_backend.set_arena_cap(o.arena_mb)
        # before the executor exists, so its first launch serves as the
        # server will
        chain_mod.set_donation(o.donation)
        self._device_frames = None
        # with coherence the card's shared state (the device frame tier,
        # the lanes, the mesh) lives on the device owner alone; every
        # worker still launches its own kernels on its device
        is_dev_owner = self.coherence is None or self.coherence.is_device_owner()
        if o.cache_device_mb > 0 and is_dev_owner:
            self._device_frames = cache_mod.DeviceFrameCache(self.caches.device,
                                                             self.caches.stats)
        chain_mod.set_device_frame_cache(self._device_frames)
        self.executor = Executor(ExecutorConfig(
            window_ms=o.batch_window_ms, max_batch=o.max_batch,
            batch_policy=o.batch_policy, max_form_ms=o.batch_form_ms,
            max_inflight=max(1, o.max_inflight), device=str(self.device),
            mesh_policy=o.mesh_policy, n_devices=o.n_devices, devices=o.devices,
            lane_form_ms=o.lane_form_ms, lane_inflight=max(1, o.lane_inflight),
            shard_min_items=o.shard_min_items,
            breaker_threshold=o.breaker_threshold,
            breaker_cooldown_s=o.breaker_cooldown_s, spatial=o.spatial, use_mesh=o.use_mesh,
            spatial_threshold_px=o.spatial_threshold_px,
            spatial_mpix=o.spatial_mpix, host_spill=o.host_spill,
            force_host=o.force_host, hedge_threshold_ms=o.hedge_threshold_ms,
            hedge_budget=o.hedge_budget, integrity=self.integrity, failslow_ratio=o.failslow_ratio,
            failslow_min_samples=o.failslow_min_samples,
            failslow_share=o.failslow_share, qos=self.qos, pressure=self.pressure,
            device_owner=is_dev_owner))
        pipeline.set_transport_dct(o.transport_dct)
        pipeline.set_transport_dct_egress(o.transport_dct_egress)
        workers = o.cpus if o.cpus > 0 else max(4, available_cpus())
        self.pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="itpu-host")
        self.pool_workers = workers
        if self.cost is not None:
            self.cost.bind(executor=self.executor,
                           host_view=lambda: (self.pool_workers, self._inflight))
            self.executor.cost_armed = True
        # host tasks submitted and not finished, and an EWMA of their
        # service time: the host side of estimated_queue_ms
        self._inflight = 0
        self._service_ewma_ms = 20.0
        self._inflight_lock = threading.Lock()
        self._placeholders: collections.OrderedDict = collections.OrderedDict()
        self._placeholder_lock = threading.Lock()
        self._closed = False

    def prewarm(self) -> dict:
        """--prewarm (prewarm.py): the common chains on this service's
        device at every B up to its max_batch, and the lane tier's
        signatures with a mesh policy, before the server binds. Returns
        the prewarm's report ({"warmed", "failed", "seconds", "seed"})."""
        from imaginary_tpu_torch import prewarm

        report: dict = {}
        prewarm.prewarm_common_chains(device=self.executor.config.device,
                                      max_batch=self.options.max_batch,
                                      executor=self.executor, report=report)
        return report

    def close(self) -> None:
        """Shut the executor and the pool down; `aclose()` also closes the
        sources' client sessions."""
        if self._closed:
            return
        self._closed = True
        if self.multihost is not None:
            self.multihost.close()
        if self._armed_fleet_qos:
            # this service's handle only: a later app must not read a
            # closed mapping
            from imaginary_tpu_torch.fleet import ownership

            ownership.set_fleet_qos(None)
            self._armed_fleet_qos = False
        self.executor.shutdown()
        self.pool.shutdown(wait=False)
        if (self._device_frames is not None
                and chain_mod.device_frame_cache() is self._device_frames):
            # the resident frames go back to the card with the service
            chain_mod.set_device_frame_cache(None)
            self._device_frames.clear()
        if self.caches.shm is not None:
            self.caches.shm.close()

    def start_multihost(self) -> None:
        """Start the cross-host gossip thread (a no-op without --peers),
        from the app's startup hook, so a service built alone never
        polls."""
        if self.multihost is not None:
            self.multihost.start()

    async def aclose(self) -> None:
        await self.stop_coherence()
        await self.registry.close()
        self.close()

    # -- fleet coherence: the forward hop's server ----------------------------

    async def start_coherence(self) -> None:
        """Bind this worker's forward socket (fleet/ipc.py), from the app's
        startup hook (the server needs the running loop). A no-op without
        coherence. A failed bind leaves this worker forwarding out and
        claiming; siblings forwarding here fall back to local work."""
        if self.coherence is None or self._forward_server is not None:
            return
        from imaginary_tpu_torch.fleet import ipc

        srv = ipc.ForwardServer(ipc.socket_path(self.caches.shm.path, self.coherence.worker),
                                self._handle_forward)
        try:
            await srv.start()
        except OSError:
            return
        self._forward_server = srv

    async def stop_coherence(self) -> None:
        if self._forward_server is not None:
            await self._forward_server.stop()
            self._forward_server = None

    async def _handle_forward(self, header: dict, body: bytes):
        """The owner's side of the forward hop: answer a sibling's request
        for a digest this worker owns, from its caches or by running it.
        The sibling already ran the ingress checks and the Accept
        negotiation, so the header's query holds the resolved type and
        both sides derive the same key. The run carries the hop's budget
        as its deadline. A fenced worker refuses: a deposed zombie must
        not compute for the fleet."""
        flc = self.coherence
        shm = self.caches.shm
        if flc is None or shm is None or shm.fenced() or shm.host_fenced():
            if flc is not None:
                flc.stats.serve_refused += 1
            return {"status": "fenced"}, b""
        op_name = str(header.get("op", ""))
        query = {str(k): str(v) for k, v in dict(header.get("query") or {}).items()}
        try:
            prepared = self.prepare(body, query)
        except ImageError:
            return {"status": "error", "error": "request"}, b""
        caches = self.caches
        digest = cache_mod.source_digest(body)
        key = cache_mod.request_key(digest, op_name, prepared.opts)
        tr = obs_trace.RequestTrace(request_id="fleet-forward", enabled=False)
        budget_ms = float(header.get("budget_ms") or 0)
        if budget_ms > 0:
            tr.deadline = deadline_mod.Deadline(budget_ms / 1000.0)
        token = obs_trace.activate(tr)
        try:
            hit = None
            if caches.result.enabled:
                try:
                    hit = caches.result.get(key)
                except Exception:  # itpu: allow[ITPU004] a failing tier reads as a miss
                    hit = None
                if hit is not None:
                    caches.stats.result_hits += 1
            if hit is None:
                hit = caches.shm_lookup(key)
            if hit is None:
                async def produce() -> tuple:
                    watermark = await self._prefetch_watermark(op_name, prepared.opts)
                    out, placement, _vary = await self._dispatch(
                        op_name, body, query, None, prepared, digest, watermark)
                    return out, placement

                async def claimed() -> tuple:
                    # the flight outside the claim, as on the request path,
                    # so a local leader and a forwarded request for one
                    # key never wait on each other
                    return await flc.run_claimed(key, cache_mod.shared_key(key), produce,
                                                 caches)

                if caches.coalesce:
                    hit = await caches.flight.run(key, claimed)
                else:
                    hit = await claimed()
                if caches.result.enabled:
                    caches.result.put(key, hit, len(hit[0].body))
            out, placement = hit
            flc.stats.serve_forwarded += 1
            return ({"status": "ok", "mime": out.mime, "placement": placement or ""},
                    bytes(out.body))
        finally:
            obs_trace.deactivate(token)

    def versions(self) -> dict:
        """`/`'s JSON: the port's version, the torch stack and the device
        type, in the place of the reference's {imaginary_tpu, jax, backend}."""
        return {"imaginary_tpu_torch": Version, "torch": torch.__version__,
                "backend": self.device.type}

    def health(self) -> dict:
        """The one stats assembly that /health and /metrics both serve."""
        return get_health_stats(self)

    def estimated_queue_ms(self) -> float:
        """Expected queueing delay for a new request: the host-pool backlog
        (tasks beyond the worker count, at the measured service time) plus
        the executor's owed device work."""
        backlog = max(0, self._inflight - self.pool_workers)
        host_wait = backlog * self._service_ewma_ms / max(1, self.pool_workers)
        return host_wait + self.executor.estimated_wait_ms()

    # -- the image route handler ----------------------------------------------

    async def handle(self, request: web.Request, op_name: str) -> web.StreamResponse:
        o = self.options
        tr = obs_trace.current()
        if tr is not None:
            tr.annotate(op=op_name)
        try:
            if o.enable_url_signature:
                check_url_signature(request, o)
            validate_image_request(request, o)
            spilled = await self._admit(request)
            if spilled is not None:
                return spilled
            if self.pressure is not None and o.max_allowed_pixels > 0:
                # the pre-decode dimension gate, armed before the fetch
                codecs.set_decode_pixel_cap(o.max_allowed_pixels)
            with obs_trace.span("fetch"):
                buf = await self._get_source_image(request)
            if not buf:
                raise ErrEmptyBody
            if tr is not None:
                tr.annotate(bytes_in=len(buf))
            return await self._process_and_respond(request, op_name, buf)
        except ImageError as e:
            return error_response(request, e, o)

    async def _admit(self, request: web.Request) -> Optional[web.Response]:
        """Admission before any work (module docstring), in the
        reference's order; raises the shed's ImageError. The deadline's
        rung: a 504 when the budget is already spent, and a 503 with
        Retry-After when the estimated queue delay exceeds what is left of
        it (a 503 now beats a sure 504 later). With --peers, work the
        critical rung is about to shed is first offered to a peer
        (`_try_spill`): its answer is returned, None otherwise."""
        o = self.options
        tr = obs_trace.current()
        dl = deadline_mod.current()
        qos = self.qos
        kidx = 1  # qos.CLASSES' "standard" when qos is off
        if qos is not None:
            ten = getattr(tr, "tenant", None) if tr is not None else None
            kidx = (ten or qos.default).class_index

        def shed(message: str, retry_after: str) -> ImageError:
            if qos is not None:
                qos.stats.note_shed(kidx)
            if tr is not None:
                tr.annotate(placement_attempts=["shed_503"])
            return new_error(message, 503, headers={"Retry-After": retry_after})

        try:
            # an injected error is a shed decision, with the overload's
            # 503 contract
            await failpoints.ahit("qos.admit")
        except failpoints.FailpointError:
            raise shed("Request shed by admission control, retry later", "1") from None
        gov = self.pressure
        if gov is not None:
            plevel = gov.level()
            if tr is not None and tr.enabled:
                tr.annotate(pressure=pressure_mod.LEVEL_NAMES[plevel])
            if qos is not None and shed_for_pressure(plevel, kidx):
                if self.multihost is not None:
                    spilled = await self._try_spill(request)
                    if spilled is not None:
                        if tr is not None:
                            tr.annotate(placement_attempts=["spill_peer"])
                        return spilled
                gov.note_shed()
                raise shed("Server under memory pressure, batch work shed, retry later",
                           "2")
        est_ms = None
        if o.max_queue_ms > 0 or dl is not None:
            est_ms = self.estimated_queue_ms()
        limit_ms = o.max_queue_ms
        if qos is not None and o.max_queue_ms > 0:
            # the lowest class sheds first (qos/shed.py)
            limit_ms = qos.shed_threshold_ms(kidx, o.max_queue_ms)
        if o.max_queue_ms > 0 and est_ms > limit_ms:
            raise shed("Server queue is full, retry later", _retry_after_s(est_ms))
        if dl is not None:
            rem = dl.note("admission")
            if rem <= 0.0:
                raise dl.error("admission")
            if est_ms > rem * 1000.0:
                raise shed("Server queue exceeds request deadline, retry later",
                           _retry_after_s(est_ms))
        if qos is not None:
            qos.stats.note_admitted(kidx)
        return None

    async def _try_spill(self, request: web.Request) -> Optional[web.Response]:
        """Offer one about-to-shed request to the least-loaded
        non-critical peer: the ORIGINAL request, verbatim (method, path
        and query, body), and the peer runs its own fetch and admission.
        None on any fault, when no peer qualifies, or for a request that
        already came over a hop (two critical hosts shed; they do not
        ping-pong): the caller sheds as it would have."""
        from imaginary_tpu_torch.fleet import router as router_mod

        mh = self.multihost
        if str(request.headers.get(router_mod.ROUTE_HEADER, "")).startswith("fwd"):
            return None
        peer = mh.spill_target()
        if peer is None:
            return None
        try:
            body = await request.read()
        except Exception:  # itpu: allow[ITPU004] an unreadable body is not offered: the caller sheds
            return None
        res = await mh.try_spill(peer, request.method, request.path_qs, body,
                                 dict(request.headers))
        if res is None:
            return None
        status, mime, rbody = res
        return web.Response(body=rbody, status=status,
                            content_type=mime or "application/octet-stream")

    async def _get_source_image(self, request: web.Request) -> bytes:
        try:
            return await self.registry.get_image(request)
        except ImageError:
            raise
        except Exception as e:
            raise new_error("Error getting image: " + str(e), 400) from None

    async def _process_and_respond(self, request, op_name, buf) -> web.Response:
        """Run the core on the host pool under the request's context (so
        its spans land in this request's trace), behind the cache tiers
        (module docstring). On the routes that may name a watermark image,
        and whenever a keyed tier needs the options for its key, the
        core's checks run here first; the mark is fetched on the event
        loop. The inflight ledger decrements in the pool thread; a task
        cancelled while still queued never runs, and the done-callback
        balances it."""
        query = dict(request.query)
        caches = self.caches
        prepared = None
        if op_name in _MARKED_ROUTES or caches.keyed or self.multihost is not None:
            prepared = self.prepare(buf, query, request.headers)
        digest = key = etag = None
        if caches.keyed:
            # after Accept negotiation: a negotiated webp and jpeg never
            # share an entry or an ETag
            digest = cache_mod.source_digest(buf)
            key = cache_mod.request_key(digest, op_name, prepared.opts)
        tr = obs_trace.current()
        if tr is not None and tr.enabled and prepared is not None:
            _annotate_plan(tr, op_name, prepared.opts, query)
        if (caches.result.enabled or caches.shm is not None) and key is not None:
            with obs_trace.span("cache_lookup"):
                etag = cache_mod.strong_etag(key)
                if request.method == "GET" and cache_mod.etag_matches(
                        request.headers.get("If-None-Match", ""), etag):
                    # the conditional GET, answered before the pipeline
                    caches.stats.etag_304 += 1
                    if tr is not None:
                        tr.annotate(cache="etag_304")
                    headers = {"ETag": etag}
                    if prepared.vary:
                        headers["Vary"] = prepared.vary
                    return web.Response(status=304, headers=headers)
                hit = None
                if caches.result.enabled:
                    try:
                        hit = caches.result.get(key)
                    except Exception:  # itpu: allow[ITPU004] a failing tier reads as a miss
                        hit = None
            if hit is not None:
                caches.stats.result_hits += 1
                if tr is not None:
                    tr.annotate(cache="result_hit")
                out, placement = hit
                # the one read of the stored body a hit pays
                COPIES.add("cache_hit", len(out.body))
                return self._web_response(self._build_response(
                    out, op_name, prepared.vary, placement, etag))
            if caches.result.enabled:
                caches.stats.result_misses += 1
            # the fleet tier next: a sibling worker may hold this answer
            # (checksum-verified; a corrupt or torn entry reads as a miss)
            shm_hit = caches.shm_lookup(key)
            if shm_hit is not None:
                out, placement = shm_hit
                # the shm tier's one snapshot of the mapping is the copy a
                # fleet hit pays
                COPIES.add("cache_hit", len(out.body))
                if caches.result.enabled:
                    # the next local occurrence skips the mapping
                    caches.result.put(key, shm_hit, len(out.body))
                if tr is not None:
                    tr.annotate(cache="shm_hit")
                return self._web_response(self._build_response(
                    out, op_name, prepared.vary, placement, etag))
            if tr is not None:
                tr.annotate(cache="result_miss")

        # the cross-host hop (--peers, with --router or a request's route
        # hint): host rendezvous elects one owner host a shared key, and a
        # non-owner ships the source bytes and the resolved query one hop
        # there; after the local lookups (a local hit pays no hop), before
        # the intra-host forward (the owner host runs its own). Any fault
        # falls through to the local run
        mh = self.multihost
        if mh is not None and not mh.note_hop_marker(request.headers):
            rkey = key if key is not None else cache_mod.request_key(
                cache_mod.source_digest(buf), op_name, prepared.opts)
            peer = mh.route_target(request.headers, cache_mod.shared_key(rkey))
            if peer is not None:
                # the owner fetches nothing: the source rides the body
                fwd_query = {k: v for k, v in query.items()
                             if k not in ("url", "file", "sign")}
                if fwd_query.get("type") == "auto":
                    # the negotiated type: the owner has no Accept header
                    fwd_query["type"] = prepared.opts.type
                fwd = await mh.try_forward(peer, op_name, fwd_query, buf,
                                           get_image_mime_type(determine_image_type(buf)))
                if fwd is not None:
                    out, placement = fwd
                    if caches.result.enabled and key is not None:
                        caches.result.put(key, (out, placement), len(out.body))
                    if tr is not None:
                        tr.annotate(cache="host_forward", placement=placement)
                    return self._web_response(self._build_response(
                        out, op_name, prepared.vary, placement, etag))

        # fleet coherence: the digest's owner answers over the forward hop;
        # any fault of the hop falls through to the local run below
        flc = self.coherence
        skey = None
        if flc is not None and key is not None:
            skey = cache_mod.shared_key(key)
            fwd_query = dict(query)
            if fwd_query.get("type") == "auto":
                # the negotiated type: the owner has no Accept header
                fwd_query["type"] = prepared.opts.type
            fwd = await flc.try_forward(op_name, fwd_query, buf, skey)
            if fwd is not None:
                out, placement = fwd
                if caches.result.enabled:
                    caches.result.put(key, (out, placement), len(out.body))
                if tr is not None:
                    tr.annotate(cache="fleet_forward", placement=placement)
                return self._web_response(self._build_response(
                    out, op_name, prepared.vary, placement, etag))

        async def work() -> tuple:
            watermark = None
            if prepared is not None:
                try:
                    watermark = await self._prefetch_watermark(op_name, prepared.opts)
                except ImageError:
                    raise
                except Exception as e:
                    # ref: handlers.py:787-790, as a failure of the work
                    raise new_error("Error processing image: " + str(e), 400) from None
            return await self._dispatch(op_name, buf, query, request.headers, prepared,
                                        digest, watermark)

        async def run_work() -> tuple:
            body_fn = work
            if flc is not None and key is not None:
                # fleet singleflight: N workers x one digest run the
                # pipeline once fleet-wide; the claim runner deposits in
                # the shm tier before its claim drops, and every failure
                # runs locally
                async def produce() -> tuple:
                    out, placement, _vary = await work()
                    return out, placement

                async def claimed() -> tuple:
                    out, placement = await flc.run_claimed(key, skey, produce, caches)
                    return out, placement, prepared.vary

                body_fn = claimed
            if caches.coalesce and key is not None:
                # singleflight: one pool dispatch (one _inflight unit) for
                # every concurrent identical request; each waiter is
                # shielded, so a waiter's cancellation (its deadline, a
                # disconnect) never cancels the shared run
                return await caches.flight.run(key, body_fn)
            return await body_fn()

        dl = deadline_mod.current()
        if dl is None:
            out, placement, vary = await run_work()
        else:
            # the one await-side bound: the coalesce wait, the watermark
            # fetch, the pool's queue and the work itself. A pool future
            # still queued is cancelled and never runs
            # (_release_if_cancelled balances it); a coalesced follower
            # detaches from the leader's run without cancelling it
            rem = dl.note("queue")
            if rem <= 0.0:
                raise dl.error("queue")
            try:
                out, placement, vary = await asyncio.wait_for(run_work(), rem)
            except asyncio.TimeoutError:
                raise dl.error("queue") from None
        if caches.result.enabled and key is not None:
            # the placement rides along, so a replayed answer carries the
            # X-Imaginary-Backend of the run that produced it
            caches.result.put(key, (out, placement), len(out.body))
        if key is not None and flc is None:
            # the fleet deposit (a no-op without the shm tier), refused
            # when this worker is fenced; with coherence the claim runner
            # has deposited already
            caches.shm_store(key, out, placement)
        if prepared is not None:  # a coalesced waiter's own negotiation
            vary = prepared.vary
        return self._web_response(self._build_response(out, op_name, vary, placement, etag))

    async def _dispatch(self, op_name, buf, query, headers, prepared, digest,
                        watermark=None) -> tuple:
        """One run of the core on the host pool under the caller's context:
        (out, placement, vary). The inflight ledger decrements in the pool
        thread; a task cancelled while still queued never runs, and the
        done-callback balances it."""
        with self._inflight_lock:
            self._inflight += 1
        ctx = contextvars.copy_context()
        fut = self.pool.submit(ctx.run, self._process_counted, op_name, bytes(buf),
                               query, headers, prepared, watermark, digest)
        fut.add_done_callback(self._release_if_cancelled)
        return await asyncio.wrap_future(fut)

    @staticmethod
    def _web_response(got: "Response") -> web.Response:
        return web.Response(body=got.body, status=got.status,
                            content_type=got.content_type, headers=got.headers)

    def _release_if_cancelled(self, fut) -> None:
        if fut.cancelled():
            with self._inflight_lock:
                self._inflight -= 1

    async def _prefetch_watermark(self, op_name: str,
                                  opts: ImageOptions) -> Optional[np.ndarray]:
        """The RGBA watermark of `watermarkImage`, or of the first
        `watermarkImage` op of a pipeline (ref: handlers.py:962-983):
        fetched through the registry (origin-checked, 1 MB cap), decoded,
        and given an opaque alpha plane when it has none. None when no
        mark is named."""
        url = ""
        if op_name == "watermarkImage":
            url = opts.image
        elif op_name == "pipeline":
            for op in opts.operations:
                if op.name == "watermarkImage":
                    url = str(op.params.get("image", ""))
                    break
        if not url:
            return None
        raw = await self.registry.fetch_watermark(url)
        if not raw:
            raise new_error("Unable to read watermark image", 400)
        arr = codecs.decode(raw).array
        if arr.shape[2] == 3:
            alpha = np.full(arr.shape[:2] + (1,), 255, dtype=np.uint8)
            arr = np.concatenate([arr, alpha], axis=2)
        return arr

    def _process_counted(self, op_name, buf, query, headers, prepared,
                         watermark, digest=None) -> tuple:
        """The pool's task: (out, placement, vary)."""
        t0 = time.monotonic()
        try:
            # a request that expired while queued costs no decoded byte
            deadline_mod.check("host_pool")
            if prepared is None:
                prepared = self.prepare(buf, query, headers)
                tr = obs_trace.current()
                if tr is not None and tr.enabled:
                    _annotate_plan(tr, op_name, prepared.opts, query)
            out, placement = self.run(op_name, buf, prepared, watermark, digest)
            return out, placement, prepared.vary
        finally:
            dt_ms = (time.monotonic() - t0) * 1000.0
            with self._inflight_lock:
                self._inflight -= 1
                self._service_ewma_ms += 0.1 * (dt_ms - self._service_ewma_ms)

    def process(self, op_name: str, buf: bytes, query: dict, headers=None) -> Response:
        """The framework-free core of an image route: `buf` under the
        operation `op_name` with the request's query ({key: first value})
        and headers. Raises ImageError for the error reply."""
        prepared = self.prepare(buf, query, headers)
        out, placement = self.run(op_name, buf, prepared)
        return self._build_response(out, op_name, prepared.vary, placement)

    def prepare(self, buf: bytes, query: dict, headers=None) -> Prepared:
        """The core's checks, in the reference's order: the media-type
        sniff, the params, the output type and the resolution guard."""
        o = self.options
        # media-type sniff (ref: imageHandler controllers.go:80-84)
        sniffed = determine_image_type(buf)
        if sniffed is ImageType.UNKNOWN or not is_image_mime_type_supported(
            get_image_mime_type(sniffed)
        ):
            raise ErrUnsupportedMedia
        try:
            opts = build_params_from_query(query)
        except ParamError as e:
            raise new_error("Error while processing parameters: " + str(e), 400) from None
        # type=auto Accept negotiation (ref: controllers.go:89-99)
        vary = ""
        if opts.type == "auto":
            opts.type = determine_accept_mime_type((headers or {}).get("Accept", ""))
            vary = "Accept"
        elif opts.type and image_type(opts.type) is ImageType.UNKNOWN:
            raise ErrOutputFormat
        # resolution guard (ref: controllers.go:101-110); the header probe's
        # metadata is reused downstream, so the path parses headers once.
        # With a governor (module docstring): the codec's pre-decode gate,
        # a 413 past the cap, and at critical the pixel clamp on the
        # source and on the requested output
        gov = self.pressure
        limit_mpix = o.max_allowed_pixels
        clamp_mpix = 0.0
        if gov is not None and limit_mpix > 0:
            codecs.set_decode_pixel_cap(limit_mpix)
            if gov.level() >= pressure_mod.LEVEL_CRITICAL:
                clamp_mpix = limit_mpix * gov.config.pixel_frac
        if clamp_mpix > 0.0:
            out_w, out_h = opts.width or 0, opts.height or 0
            if out_w > 0 and out_h > 0 and out_w * out_h / 1e6 > clamp_mpix:
                gov.note_pixel_clamp()
                raise new_error("Requested output resolution exceeds the memory-"
                                "pressure admission clamp, retry later", 413,
                                headers={"Retry-After": "2"})
        meta = None
        if limit_mpix > 0:
            try:
                meta = codecs.probe_fast(buf)
                src_mpix = meta.width * meta.height / 1_000_000.0
                if clamp_mpix > 0.0 and src_mpix > clamp_mpix:
                    gov.note_pixel_clamp()
                    raise new_error("Image resolution exceeds the memory-pressure "
                                    "admission clamp, retry later", 413,
                                    headers={"Retry-After": "2"})
                if src_mpix > limit_mpix:
                    if gov is not None:
                        raise new_error("Image resolution is too big", 413)
                    raise ErrResolutionTooBig
            except ImageError as e:
                if e is ErrResolutionTooBig or e.code in (413, 501):
                    raise
                meta = None  # probe failure falls through; the decode raises
        return Prepared(opts, vary, meta)

    def run(self, op_name: str, buf: bytes, prepared: Prepared,
            watermark_rgba: Optional[np.ndarray] = None, digest=None) -> tuple:
        """The pipeline on a prepared request: (out, placement), where the
        executor computed it (None: the device). `digest`: the source's
        sha256 when the handler took it; with the decoded-frame tier on
        and none given, it is taken here."""
        executor_mod.reset_placement()
        frames = None
        if self.caches.frames.enabled:
            frames = self.frame_cache
            if digest is None:
                digest = cache_mod.source_digest(buf)
        try:
            out = pipeline.process_operation(op_name, buf, prepared.opts,
                                             device=self.device, meta=prepared.meta,
                                             runner=self._execute_within_deadline,
                                             watermark_rgba=watermark_rgba,
                                             frame_cache=frames, source_digest=digest)
        except ImageError:
            raise
        except Exception as e:
            # ref: handlers.py:787-790, any other failure of the work
            raise new_error("Error processing image: " + str(e), 400) from None
        return out, executor_mod.last_placement()

    def _execute_within_deadline(self, arr, plan):
        """Executor.process with the wait for the result bounded by the
        request's remaining budget: on expiry the item is cancelled (the
        executor drops it before launch and releases its owed MB; a
        launched one's result is dropped) and the request answers 504."""
        dl = deadline_mod.current()
        if dl is None:
            return self.executor.process(arr, plan)
        rem = dl.note("device_queue")
        if rem <= 0.0:
            raise dl.error("device_queue")
        fut = self.executor.submit(arr, plan)
        try:
            out = fut.result(timeout=rem)
        except FuturesTimeout:
            fut.cancel()
            raise dl.error("device_execute") from None
        attribute(getattr(fut, "stage_ms", None))
        hp = getattr(fut, "_hedge_placement", None)
        if hp:  # a host twin, an OOM bisection's item or a verified copy
            executor_mod.note_placement(hp)
        return out

    def _build_response(self, out, op_name, vary, placement=None, etag=None) -> Response:
        headers = {}
        if op_name != "info":  # /info produces no pixels
            placement = placement or "device"
            headers["X-Imaginary-Backend"] = placement
            tr = obs_trace.current()
            if tr is not None:
                tr.annotate(placement=placement)
        if vary:
            headers["Vary"] = vary
        if etag:
            headers["ETag"] = etag
        if self.multihost is not None:
            # the incarnation stamp: a cross-host forwarder refuses an
            # answer whose epoch gossip has deposed (fleet/router.py)
            from imaginary_tpu_torch.fleet import router as router_mod

            headers[router_mod.HOST_EPOCH_HEADER] = self.multihost.identity_header
        # every image the pipeline answers carries its output geometry; a
        # fleet tier entry carries none, and its header is probed
        if self.options.return_size and out.mime != "application/json":
            w, h = out.width, out.height
            if not (w and h):
                try:
                    m = codecs.probe(bytes(memoryview(out.body)[:_PROBE_PREFIX]))
                    w, h = m.width, m.height
                except ImageError:
                    w = h = 0
            headers["Image-Width"] = str(w)
            headers["Image-Height"] = str(h)
        return Response(200, out.mime, out.body, headers)

    # -- placeholders -----------------------------------------------------------

    def placeholder(self, buf: bytes, width: int, height: int,
                    type_name: str) -> tuple:
        """(body, mime) of `buf` resized to width x height: one resize
        through this service's executor on its device, cached per
        (source, width, height, type). A failed resize is not cached."""
        key = (buf, width, height, type_name)
        with self._placeholder_lock:
            hit = self._placeholders.get(key)
            if hit is not None:
                self._placeholders.move_to_end(key)
                return hit
        opts = ImageOptions(width=width, height=height, force=True, type=type_name)
        out = pipeline.process_operation("resize", buf, opts, device=self.device,
                                         runner=self.executor.process)
        got = (out.body, out.mime)
        with self._placeholder_lock:
            self._placeholders[key] = got
            while len(self._placeholders) > _PLACEHOLDER_CACHE:
                self._placeholders.popitem(last=False)
        return got


def _annotate_plan(tr, op_name: str, opts: ImageOptions, query: dict) -> None:
    """The wide event's plan digest (the operation, the negotiated output
    type and the sorted query without the source-naming params: a
    grouping key, "which transformation shape was slow") and the cache
    outcome so far, once the request is past the core's checks, as the
    reference stamps them."""
    qs = tuple(sorted((k, v) for k, v in query.items() if k not in ("url", "file", "sign")))
    tr.annotate(plan=hashlib.sha256(repr((op_name, opts.type, qs)).encode()).hexdigest()[:16],
                cache="off")


# --- simple controllers -------------------------------------------------------

async def index_controller(request: web.Request, o: ServerOptions,
                           service: ImageService) -> web.Response:
    """Version JSON (ref: controllers.go:17-26)."""
    prefix = o.path_prefix.rstrip("/") or ""
    if request.path not in (prefix + "/", prefix or "/"):
        return error_response(request, ErrNotFound, o)
    return web.json_response(service.versions())


async def health_controller(request: web.Request,
                            service: ImageService) -> web.Response:
    # a chaos site, deliberately synchronous: a delay() armed here blocks
    # the whole event loop, the "process alive, loop wedged" failure the
    # supervisor's liveness probe exists to catch
    # itpu: allow[ITPU001] deliberate sync block: this failpoint simulates the wedged-loop failure
    failpoints.hit("worker.hang")
    return web.json_response(service.health())


async def form_controller(request: web.Request, o: ServerOptions) -> web.Response:
    """HTML playground (ref: controllers.go:159-194)."""
    prefix = o.path_prefix.rstrip("/")
    demos = [
        ("Resize", "resize", "width=300&height=200&type=jpeg"),
        ("Force resize", "resize", "width=300&height=200&force=true"),
        ("Crop", "crop", "width=300&quality=95"),
        ("SmartCrop", "crop", "width=300&height=260&quality=95&gravity=smart"),
        ("Extract", "extract", "top=100&left=100&areawidth=300&areaheight=150"),
        ("Enlarge", "enlarge", "width=1440&height=900&quality=95"),
        ("Rotate", "rotate", "rotate=180"),
        ("AutoRotate", "autorotate", "quality=90"),
        ("Flip", "flip", ""),
        ("Flop", "flop", ""),
        ("Thumbnail", "thumbnail", "width=100"),
        ("Zoom", "zoom", "factor=2&areawidth=300&top=80&left=80"),
        ("Color space (black&white)", "resize", "width=400&height=300&colorspace=bw"),
        ("Add watermark", "watermark", "textwidth=100&text=Hello&font=sans%2012&opacity=0.5&color=255,200,50"),
        ("Convert format", "convert", "type=png"),
        ("Image metadata", "info", ""),
        ("Gaussian blur", "blur", "sigma=15.0&minampl=0.2"),
        ("Pipeline", "pipeline",
         "operations=%5B%7B%22operation%22:%20%22crop%22,%20%22params%22:%20%7B%22width%22:%20300,"
         "%20%22height%22:%20260%7D%7D,%20%7B%22operation%22:%20%22convert%22,%20%22params%22:"
         "%20%7B%22type%22:%20%22webp%22%7D%7D%5D"),
    ]
    parts = ["<html><body>"]
    for title, op, args in demos:
        action = f"{prefix}/{op}" + (f"?{args}" if args else "")
        parts.append(
            f'<h1>{title}</h1>'
            f'<form method="POST" action="{action}" enctype="multipart/form-data">'
            f'<input type="file" name="file" /><input type="submit" value="Upload" />'
            f"</form>"
        )
    parts.append("</body></html>")
    return web.Response(text="".join(parts), content_type="text/html")
