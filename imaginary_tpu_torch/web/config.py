"""Server configuration (the port's copy of `imaginary_tpu/web/config.py`;
ref: ServerOptions, server.go:20-51).

Immutable after startup and threaded through every constructor. Trimmed
to the fields the port's HTTP layer, its URL sources, its admission
(qos, the memory-pressure governor, --max-queue-ms) and its
observability planes (wide events, /debugz, the SLO engine, the cost
plane) read, plus the executor, lane, spatial and transport knobs the
port serves with and its own `device`.
The reference's --gzip, --http-read-timeout and --http-write-timeout
parse (cli.py) but set nothing, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional
from urllib.parse import urlparse

from imaginary_tpu_torch.engine.executor import MAX_BATCH


@dataclasses.dataclass
class ServerOptions:
    port: int = 9000
    address: str = ""
    path_prefix: str = "/"
    burst: int = 100
    concurrency: int = 0
    http_cache_ttl: int = -1
    max_allowed_size: int = 0  # bytes of a fetched URL source, 0 = no cap
    max_allowed_pixels: float = 18.0  # megapixels (ref: imaginary.go:36)
    cors: bool = False
    auth_forwarding: bool = False
    enable_url_source: bool = False
    enable_placeholder: bool = False
    enable_url_signature: bool = False
    url_signature_key: str = ""
    api_key: str = ""
    mount: str = ""
    cert_file: str = ""
    key_file: str = ""
    # HTTP/2 over TLS (ALPN h2), served by the nghttp2 terminator in
    # web/http2.py; http/1.1 only when libnghttp2 is absent
    http2: bool = True
    authorization: str = ""
    placeholder: str = ""
    placeholder_status: int = 0
    forward_headers: tuple = ()
    placeholder_image: bytes = b""
    endpoints: tuple = ()  # disabled endpoint names (ref: Endpoints)
    allowed_origins: tuple = ()  # (host, path prefix) pairs of parse_origins
    log_level: str = "info"
    return_size: bool = False
    cpus: int = 0  # host worker-thread cap, 0 = auto
    # Ingress slow-client guard (web/ingress.py): close a connection whose
    # request read (headers or body) goes this many seconds without a
    # byte; 0 = off
    read_timeout_s: float = 0.0
    # --- observability (obs/) ------------------------------------------------
    # Per-request span tracing: X-Request-ID is always assigned and
    # echoed; this gates span accumulation, Server-Timing, wide events and
    # the slow-request ring.
    trace_enabled: bool = True
    # one JSON wide event per request (obs/events.py) on the access log's
    # stream, tail-sampled: the interesting tail always, the boring rest
    # with this probability
    wide_events: bool = False
    wide_events_sample: float = 1.0
    # per-route SLO objectives (obs/slo.py): inline JSON or a file path;
    # "" = off
    slo_config: str = ""
    # /debugz, /debugz/profile and /debugz/failpoints (obs/debugz.py)
    enable_debug: bool = False
    # per-tenant cost attribution and the capacity plane (obs/cost.py):
    # the top-K sketch's width and the rollup windows
    cost_attribution: bool = False
    cost_topk: int = 20
    cost_windows: str = "10s,1m,5m"
    # ?url= and watermark origin fetches (web/sources.py): bounded retries
    # with full-jitter backoff on connect errors, timeouts, 5xx and 429
    # (Retry-After honoured, other 4xx never retried), and per-attempt
    # connect and read timeouts under the 60 s ceiling
    source_retries: int = 2
    source_connect_timeout_s: float = 5.0
    source_read_timeout_s: float = 30.0
    # End-to-end per-request deadline in seconds (deadline.py), also the
    # ceiling of the X-Request-Timeout header; 0 = off, the default
    request_timeout_s: float = 0.0
    # warm the common chains on the card before the server binds
    # (prewarm.py)
    prewarm: bool = False
    # --- admission (web/handlers.py, engine/pressure.py, qos/) -------------
    # shed (503 + Retry-After) when the estimated queueing delay exceeds
    # this many ms, graded per qos class; 0 = off
    max_queue_ms: float = 0.0
    # the memory-pressure governor; pressure_rss_mb 0 builds none
    pressure_rss_mb: float = 0.0
    pressure_hbm_mb: float = 0.0
    pressure_elevated_frac: float = 0.75
    pressure_critical_frac: float = 0.90
    pressure_batch_mb: float = 32.0
    pressure_oversize_mpix: float = 4.0
    pressure_pixel_frac: float = 0.25
    # the multi-tenant qos policy: inline JSON or a file path; "" = off
    qos_config: str = ""
    # --- the device and the executor (engine/executor.py) -------------------
    device: str = "cuda"  # torch device of the kernels: cuda, cuda:N or cpu
    batch_window_ms: float = 3.0  # the convoy policy's window
    max_batch: int = MAX_BATCH
    batch_policy: str = "continuous"  # or "convoy"
    batch_form_ms: float = 5.0
    max_inflight: int = 4
    donation: bool = True  # the chain's last launch into its staged buffer
    arena_mb: float = 0.0  # per-thread native codec scratch cap, 0 = unlimited
    # Multi-GPU serving (engine/lanes.py): "off", "lanes", "sharded", "auto"
    mesh_policy: str = "off"
    n_devices: int = 0
    devices: Optional[list] = None
    lane_form_ms: Optional[float] = None  # per-lane formation cap (None = inherit)
    lane_inflight: int = 2
    shard_min_items: int = 0
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    spatial: int = 1  # spatial mesh axis (W-sharding of oversize singles)
    spatial_threshold_px: int = 3840 * 2160
    spatial_mpix: float = 0.0
    # the global collector's mesh batch sharding (mesh_policy "off" only)
    use_mesh: bool = False
    # multi-process fleet join (parallel/mesh.init_distributed) at boot:
    # --distributed, or --mesh-hosts N with its coordinator and process id
    distributed: bool = False
    coordinator_address: str = ""
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    mesh_hosts: int = 0
    # compressed-domain transport both ways (pipeline.py)
    transport_dct: bool = False
    transport_dct_egress: bool = False
    dct_native: str = "auto"  # the entropy decoder arm (codecs/jpeg_dct.py)
    # --- content-addressed caching (cache.py) --------------------------------
    # All tiers default OFF: with every knob at 0/False the serving path is
    # byte-identical to the uncached build.
    # encoded-result LRU byte budget in MB (serves repeat requests without
    # touching the executor; also enables strong ETag + If-None-Match 304)
    cache_result_mb: float = 0.0
    # decoded-frame LRU byte budget in MB (different ops on the same hot
    # source skip decode)
    cache_frame_mb: float = 0.0
    # device-resident packed-frame tier byte budget in MB of device memory
    # (ops/chain.py): a hot dct-transport source pays zero batch H2D bytes
    # on repeat requests. Halved at elevated memory pressure, off at
    # critical (cache.py apply_pressure).
    cache_device_mb: float = 0.0
    # singleflight: N concurrent identical (digest, plan) requests run the
    # pipeline once and fan the result out
    cache_coalesce: bool = False
    # TTL'd remote-source cache for ?url= fetches: seconds (0 = off) and
    # its own byte budget
    cache_source_ttl: float = 0.0
    cache_source_mb: float = 32.0
    # --- placement and the card's fault domain (engine/executor.py) --------
    # Host placement: the cost model's spill to the host interpreter, the
    # breaker outage's host serving and the host route of an item that
    # runs out of device memory alone. False (the port's default,
    # --host-spill off), True (on) or None (auto, the reference's
    # default: enabled, the spill governed by the measured costs).
    host_spill: Optional[bool] = False
    force_host: bool = False  # every host-executable plan on the host
    host_dct_spill: bool = True  # the host's DCT-domain shrink-on-load
    hedge_threshold_ms: float = 0.0  # 0 = no hedging
    hedge_budget: float = 0.05
    # output integrity (engine/integrity.py); off builds no state
    integrity: bool = False
    integrity_sample: float = 1.0 / 256.0
    integrity_clean_probes: int = 3
    integrity_poison_ttl: float = 300.0
    integrity_poison_cap: int = 256
    # fail-slow demotion (engine/devhealth.py); 0 = off
    failslow_ratio: float = 0.0
    failslow_min_samples: int = 8
    failslow_share: float = 0.0

    def is_endpoint_enabled(self, path: str) -> bool:
        """Endpoint disabling by last path segment (ref: server.go:57-66)."""
        segment = path.rstrip("/").split("/")[-1]
        return segment not in self.endpoints


def parse_endpoints(value: str) -> tuple:
    """CSV of endpoint names to disable (ref: imaginary.go:328-337)."""
    return tuple(e.strip().lower() for e in value.split(",") if e.strip())


def parse_origins(value: str) -> tuple:
    """CSV of allowed origin URLs as (host, path prefix) pairs
    (ref: imaginary.go:303-326).

    An origin given without a scheme parses host-less with `*.example.com`
    in its path; the wildcard moves back into the host, as the
    reference's documented examples need."""
    origins = []
    for raw in value.split(","):
        raw = raw.strip()
        if not raw:
            continue
        u = urlparse(raw if "//" in raw else "//" + raw)
        host, path = u.netloc, u.path or ""
        if host == "" and path.startswith("*."):
            parts = path.split("/", 1)
            host = parts[0]
            path = "/" + parts[1] if len(parts) > 1 else ""
        if path:
            # ref: imaginary.go:314-321: a trailing "*" makes the path a
            # raw prefix ("/bucket*" matches "/bucket-a/..."); any other
            # path gets a trailing "/", so "/assets" never admits
            # "/assetsevil/..."
            if path.endswith("*"):
                path = path[:-1]
            elif not path.endswith("/"):
                path += "/"
        origins.append((host, path))
    return tuple(origins)


def parse_forward_headers(value: str) -> tuple:
    """CSV of header names forwarded to origins (ref: imaginary.go:289-301)."""
    return tuple(h.strip() for h in value.split(",") if h.strip())
