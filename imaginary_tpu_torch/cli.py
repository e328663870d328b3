"""Command line of the port (the port's copy of `imaginary_tpu/cli.py`;
ref: imaginary.go:20-229): `python -m imaginary_tpu_torch --port 9000`.

The reference's flags for every subsystem the port has, with the
reference's defaults. Every flag reads its default from
`IMAGINARY_TPU_<FLAG>` (dashes as underscores), and the historical names
PORT, URL_SIGNATURE_KEY and LOG_LEVEL still win, as in the reference.
`--device` is the port's own: the torch device of the kernels, and
`--host-spill` defaults to off where the reference's defaults to auto
(the card serves every request unless asked otherwise). `--dct-native`
offers the port's two arms (native, python) and auto; the reference's
numpy arm is not ported. IMAGINARY_TPU_PROFILE_DIR captures a
torch.profiler trace of the whole serving run, of the card's activity
too on a CUDA device, exported there at exit. The
server runs on the card: without CUDA it refuses to start unless
`--device cpu` asks for the CPU, and `--require-device` refuses anything
but a CUDA device. `--workers N` makes this process the supervisor of N
serving processes on one port (web/workers.py), each on the same device.
`--peers` arms the cross-host plane (fleet/multihost.py, fleet/router.py):
the host identity is stamped into the environment here, once, so every
worker a supervisor spawns inherits it.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

from imaginary_tpu_torch import Version
from imaginary_tpu_torch.engine.executor import MAX_BATCH, MESH_POLICIES
from imaginary_tpu_torch.web.config import (
    ServerOptions,
    parse_endpoints,
    parse_forward_headers,
    parse_origins,
)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_bool(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "on", "yes")


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, "") or default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="imaginary_tpu_torch",
        description="imaginary-tpu on PyTorch/CUDA: the HTTP image service "
                    "with its device work in hand-written Hopper kernels",
    )
    # the reference's flags (imaginary.go:20-55)
    p.add_argument("-p", "--port", type=int,
                   default=_env_int("IMAGINARY_TPU_PORT", 9000), help="TCP port")
    p.add_argument("-a", "--addr", default=_env_str("IMAGINARY_TPU_ADDR", ""),
                   help="bind address")
    p.add_argument("--path-prefix",
                   default=_env_str("IMAGINARY_TPU_PATH_PREFIX", "/"),
                   help="URL path prefix")
    p.add_argument("--cors", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_CORS"), help="enable CORS")
    p.add_argument("--gzip", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_GZIP"),
                   help="deprecated no-op (parity)")
    p.add_argument("--key", default=_env_str("IMAGINARY_TPU_KEY", ""),
                   help="API key for authorization")
    p.add_argument("--mount", default=_env_str("IMAGINARY_TPU_MOUNT", ""),
                   help="local directory to serve images from")
    p.add_argument("--http-cache-ttl", type=int,
                   default=_env_int("IMAGINARY_TPU_HTTP_CACHE_TTL", -1),
                   help="cache TTL seconds (0=no-cache)")
    p.add_argument("--http-read-timeout", type=int,
                   default=_env_int("IMAGINARY_TPU_HTTP_READ_TIMEOUT", 60))
    p.add_argument("--http-write-timeout", type=int,
                   default=_env_int("IMAGINARY_TPU_HTTP_WRITE_TIMEOUT", 60))
    p.add_argument("--enable-url-source", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_ENABLE_URL_SOURCE"),
                   help="allow GET ?url= fetches")
    p.add_argument("--enable-placeholder", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_ENABLE_PLACEHOLDER"),
                   help="placeholder on errors")
    p.add_argument("--enable-auth-forwarding", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_ENABLE_AUTH_FORWARDING"))
    p.add_argument("--enable-url-signature", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_ENABLE_URL_SIGNATURE"))
    p.add_argument("--url-signature-key",
                   default=_env_str("IMAGINARY_TPU_URL_SIGNATURE_KEY", ""))
    p.add_argument("--allowed-origins",
                   default=_env_str("IMAGINARY_TPU_ALLOWED_ORIGINS", ""),
                   help="CSV of allowed origin URLs")
    p.add_argument("--max-allowed-size", type=int,
                   default=_env_int("IMAGINARY_TPU_MAX_ALLOWED_SIZE", 0),
                   help="max source bytes")
    p.add_argument("--max-allowed-resolution", type=float,
                   default=_env_float("IMAGINARY_TPU_MAX_ALLOWED_RESOLUTION", 18.0),
                   help="max megapixels")
    p.add_argument("--certfile", default=_env_str("IMAGINARY_TPU_CERTFILE", ""))
    p.add_argument("--keyfile", default=_env_str("IMAGINARY_TPU_KEYFILE", ""))
    p.add_argument("--require-device", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_REQUIRE_DEVICE"),
                   help="refuse to start unless the kernels run on a CUDA device")
    p.add_argument("--disable-http2", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_DISABLE_HTTP2"),
                   help="serve http/1.1 only over TLS (h2 is on by default, like "
                        "the reference)")
    p.add_argument("--authorization",
                   default=_env_str("IMAGINARY_TPU_AUTHORIZATION", ""),
                   help="fixed Authorization header for origins")
    p.add_argument("--forward-headers",
                   default=_env_str("IMAGINARY_TPU_FORWARD_HEADERS", ""),
                   help="CSV of headers to forward")
    p.add_argument("--placeholder",
                   default=_env_str("IMAGINARY_TPU_PLACEHOLDER", ""),
                   help="placeholder image path")
    p.add_argument("--placeholder-status", type=int,
                   default=_env_int("IMAGINARY_TPU_PLACEHOLDER_STATUS", 0))
    p.add_argument("--concurrency", type=int,
                   default=_env_int("IMAGINARY_TPU_CONCURRENCY", 0),
                   help="rate limit (req/sec)")
    p.add_argument("--burst", type=int,
                   default=_env_int("IMAGINARY_TPU_BURST", 100),
                   help="rate limit burst")
    p.add_argument("--mrelease", type=int,
                   default=_env_int("IMAGINARY_TPU_MRELEASE", 30),
                   help="memory release interval seconds")
    p.add_argument("--cpus", type=int,
                   default=_env_int("IMAGINARY_TPU_CPUS", 0),
                   help="worker thread cap (0=auto)")
    p.add_argument("--log-level",
                   default=_env_str("IMAGINARY_TPU_LOG_LEVEL", "info"),
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("--return-size", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_RETURN_SIZE"),
                   help="Image-Width/Height headers")
    p.add_argument("--disable-endpoints",
                   default=_env_str("IMAGINARY_TPU_DISABLE_ENDPOINTS", ""),
                   help="CSV of endpoints to disable")
    p.add_argument("--version", action="store_true")
    p.add_argument("--disable-tracing", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_DISABLE_TRACING"),
                   help="disable per-request span tracing and Server-Timing "
                        "(X-Request-ID is still assigned)")
    # the observability planes (obs/); all off by default
    p.add_argument("--wide-events", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_WIDE_EVENTS"),
                   help="emit one structured JSON line per request "
                        "(op, plan digest, cache outcome, placement, spans)")
    p.add_argument("--wide-events-sample", type=float,
                   default=_env_float("IMAGINARY_TPU_WIDE_EVENTS_SAMPLE", 1.0),
                   help="tail-based sampling probability for boring wide "
                        "events; errors, sheds, 504s, hedges, placement "
                        "trouble and slow requests are always emitted")
    p.add_argument("--slo-config",
                   default=os.environ.get("IMAGINARY_TPU_SLO_CONFIG", ""),
                   help="per-route SLO objectives: inline JSON (starting "
                        "with '{') or a file path mapping route -> "
                        "{latency_ms, latency_target, availability} with '*' "
                        "as catch-all; burn rates over 5m/1h windows in "
                        "/health, /metrics and /debugz; empty disables")
    p.add_argument("--enable-debug", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_ENABLE_DEBUG")
                   or _env_bool("IMAGINARY_TPU_DEBUG"),
                   help="serve /debugz runtime introspection (task dump, "
                        "executor and cache snapshots, slow-request "
                        "exemplars, a torch.profiler capture, failpoints)")
    p.add_argument("--cost-attribution", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_COST_ATTRIBUTION"),
                   help="per-tenant cost attribution and the capacity plane: "
                        "cost vectors per tenant x qos_class x route x op, a "
                        "capacity block in /health, /topz, the live bound_by "
                        "advisor, imaginary_tpu_cost_*/_utilization_* metrics")
    p.add_argument("--cost-topk", type=int,
                   default=_env_int("IMAGINARY_TPU_COST_TOPK", 20),
                   help="cost-attribution sketch width: at most K distinct "
                        "tenant/op label values; the rest fold into 'other'")
    p.add_argument("--cost-windows",
                   default=_env_str("IMAGINARY_TPU_COST_WINDOWS", "10s,1m,5m"),
                   help="cost rollup windows over the 1s ring: ascending CSV "
                        "of <n>s/<n>m spans (max 6, each <= 1h)")
    p.add_argument("--workers", type=int,
                   default=_env_int("IMAGINARY_TPU_WORKERS", 1),
                   help="serving processes on one port through SO_REUSEPORT "
                        "under a supervisor (0 = one per CPU core); every "
                        "worker serves on --device with its own CUDA "
                        "context, and --require-device holds for each")
    p.add_argument("--fleet-cache-mb", type=float,
                   default=_env_float("IMAGINARY_TPU_FLEET_CACHE_MB", 0.0),
                   help="byte budget in MB for the crash-safe mmap result "
                        "cache shared by all local workers (sealed "
                        "checksummed entries, torn-write detection, "
                        "worker fencing by epochs); 0 disables the fleet "
                        "data plane")
    p.add_argument("--fleet-roll-grace", type=float,
                   default=_env_float("IMAGINARY_TPU_FLEET_ROLL_GRACE", 5.0),
                   help="SIGHUP rolling restart: seconds an old worker keeps "
                        "finishing in-flight work after its replacement "
                        "answers and it stops accepting, before SIGTERM "
                        "starts its drain")
    p.add_argument("--fleet-coherence", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_FLEET_COHERENCE"),
                   help="rendezvous digest ownership with a local forward "
                        "hop, fleet-wide singleflight through the shm claim "
                        "table, and the device-owner rule (the lanes, the "
                        "mesh and the device frame tier on one worker); "
                        "requires --fleet-cache-mb > 0; every fault of the "
                        "owner path falls back to local work")
    p.add_argument("--fleet-hop-ms", type=float,
                   default=_env_float("IMAGINARY_TPU_FLEET_HOP_MS", 250.0),
                   help="the forward hop's budget in ms (clamped by the "
                        "request deadline) before a non-owner runs the "
                        "request itself")
    p.add_argument("--fleet-qos", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_FLEET_QOS"),
                   help="enforce per-tenant GCRA rates and queue-share caps "
                        "across the fleet through the shm qos table; "
                        "requires --fleet-cache-mb > 0; a shared-table "
                        "fault falls back to each worker's own limits")
    p.add_argument("--fleet-admin-port", type=int,
                   default=_env_int("IMAGINARY_TPU_FLEET_ADMIN_PORT", 0),
                   help="the supervisor's admin plane on 127.0.0.1: /metrics "
                        "(the fleet's merged exposition, counters monotonic "
                        "across respawns) and /fleetz (each worker's epoch, "
                        "restarts, liveness and /health); 0 disables; "
                        "meaningful only with --workers > 1")
    p.add_argument("--peers",
                   default=_env_str("IMAGINARY_TPU_PEERS", ""),
                   help="peer supervisors' admin bases (http://host:admin-port) "
                        "as a CSV/whitespace list or @file; arms the cross-host "
                        "plane: host identity, /fleetz gossip, digest routing "
                        "and pressure spillover; empty = entirely off")
    p.add_argument("--router", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_ROUTER"),
                   help="route non-owned digests one HTTP hop to the "
                        "rendezvous owner host (requires --peers); without it "
                        "only requests carrying an X-Imaginary-Route: route "
                        "hint are routed")
    p.add_argument("--host-id",
                   default=_env_str("IMAGINARY_TPU_HOST_ID", ""),
                   help="stable host identity for cross-host rendezvous and "
                        "fencing (default: the hostname)")
    p.add_argument("--peer-probe-interval", type=float,
                   default=_env_float("IMAGINARY_TPU_PEER_PROBE_INTERVAL", 2.0),
                   help="gossip's poll cadence against each peer's /fleetz, "
                        "seconds")
    p.add_argument("--read-timeout", type=float,
                   default=_env_float("IMAGINARY_TPU_READ_TIMEOUT", 0.0),
                   help="close a connection whose request read (headers or "
                        "body) goes this many seconds without a byte "
                        "(slowloris hardening); 0 disables")
    # the request deadline (deadline.py); off by default
    p.add_argument("--request-timeout", type=float,
                   default=_env_float("IMAGINARY_TPU_REQUEST_TIMEOUT", 0.0),
                   help="end-to-end per-request deadline in seconds, "
                        "enforced at every hop (admission, fetch, queue, "
                        "execute, encode); also the clamp ceiling for the "
                        "X-Request-Timeout header; 0 disables")
    # admission (web/handlers.py): the depth gate, graded per qos class
    p.add_argument("--max-queue-ms", type=float,
                   default=_env_float("IMAGINARY_TPU_MAX_QUEUE_MS", 0.0),
                   help="shed load (503) when estimated queueing delay "
                        "exceeds this; 0 disables")
    # the retry policy of remote sources (web/sources.py)
    p.add_argument("--source-retries", type=int,
                   default=_env_int("IMAGINARY_TPU_SOURCE_RETRIES", 2),
                   help="retry budget for remote ?url=/watermark fetches "
                        "(connect errors, timeouts, 5xx, 429; exponential "
                        "backoff + full jitter, honors Retry-After)")
    p.add_argument("--source-connect-timeout", type=float,
                   default=_env_float("IMAGINARY_TPU_SOURCE_CONNECT_TIMEOUT", 5.0),
                   help="per-attempt origin connect timeout in seconds")
    p.add_argument("--source-read-timeout", type=float,
                   default=_env_float("IMAGINARY_TPU_SOURCE_READ_TIMEOUT", 30.0),
                   help="per-attempt origin total read timeout in seconds")
    # the memory-pressure governor (engine/pressure.py); off by default
    p.add_argument("--pressure-rss-mb", type=float,
                   default=_env_float("IMAGINARY_TPU_PRESSURE_RSS_MB", 0.0),
                   help="RSS ceiling in MB for the memory-pressure "
                        "governor: elevated at 75%%, critical at 90%% "
                        "(see --pressure-*-frac); drives the brownout "
                        "ladder (oversize-to-host, batch byte cap, batch "
                        "shed, pixel clamp); 0 disables the subsystem")
    p.add_argument("--pressure-hbm-mb", type=float,
                   default=_env_float("IMAGINARY_TPU_PRESSURE_HBM_MB", 0.0),
                   help="estimated device-memory budget in MB (fed by the "
                        "executor's owed wire-byte ledger); per process: "
                        "under --workers each worker reads its own ledger, "
                        "while the card's memory is shared; 0 skips the "
                        "device signal")
    p.add_argument("--pressure-elevated-frac", type=float,
                   default=_env_float("IMAGINARY_TPU_PRESSURE_ELEVATED_FRAC", 0.75),
                   help="fraction of a limit at which pressure reads "
                        "'elevated'")
    p.add_argument("--pressure-critical-frac", type=float,
                   default=_env_float("IMAGINARY_TPU_PRESSURE_CRITICAL_FRAC", 0.90),
                   help="fraction of a limit at which pressure reads "
                        "'critical'")
    p.add_argument("--pressure-batch-mb", type=float,
                   default=_env_float("IMAGINARY_TPU_PRESSURE_BATCH_MB", 32.0),
                   help="admitted device-batch wire-MB cap under pressure "
                        "(halved at critical); 0 never caps")
    p.add_argument("--pressure-oversize-mpix", type=float,
                   default=_env_float("IMAGINARY_TPU_PRESSURE_OVERSIZE_MPIX", 4.0),
                   help="source megapixels at which batch-class work is "
                        "forced to the host interpreter under elevated "
                        "pressure")
    p.add_argument("--pressure-pixel-frac", type=float,
                   default=_env_float("IMAGINARY_TPU_PRESSURE_PIXEL_FRAC", 0.25),
                   help="fraction of --max-allowed-resolution the critical "
                        "rung's pixel-admission clamp allows (source and "
                        "requested output dims)")
    # multi-tenant qos (qos/); off by default
    p.add_argument("--qos-config",
                   default=os.environ.get("IMAGINARY_TPU_QOS_CONFIG", ""),
                   help="multi-tenant QoS policy: inline JSON (starts "
                        "with '{') or a file path; tenants carry a class "
                        "(interactive|standard|batch), rate/burst "
                        "overrides, and a max queue share; empty disables "
                        "qos")
    # the executor (engine/executor.py)
    p.add_argument("--batch-window-ms", type=float,
                   default=_env_float("IMAGINARY_TPU_BATCH_WINDOW_MS", 3.0),
                   help="micro-batch window (convoy policy only)")
    p.add_argument("--max-batch", type=int,
                   default=_env_int("IMAGINARY_TPU_MAX_BATCH", MAX_BATCH),
                   help="micro-batch size cap")
    p.add_argument("--batch-policy",
                   default=_env_str("IMAGINARY_TPU_BATCH_POLICY", "continuous"),
                   choices=["continuous", "convoy"],
                   help="batch formation policy: continuous admits "
                        "arrivals into the next in-flight chunk "
                        "(formation capped at --batch-form-ms); convoy is "
                        "the legacy accumulate-until-the-link-idles policy")
    p.add_argument("--batch-form-ms", type=float,
                   default=_env_float("IMAGINARY_TPU_BATCH_FORM_MS", 5.0),
                   help="max milliseconds an item may wait for its chunk to "
                        "close (the batch-formation latency cap)")
    p.add_argument("--max-inflight", type=int,
                   default=_env_int("IMAGINARY_TPU_MAX_INFLIGHT", 4),
                   help="device groups launched but not yet fetched")
    p.add_argument("--donation",
                   default=_env_str("IMAGINARY_TPU_DONATION", "on"),
                   choices=["on", "off"],
                   help="write each chunk's last kernel output into its "
                        "staged input buffer on the card when it fits "
                        "(ops/chain.py); off always allocates the output")
    p.add_argument("--arena-mb", type=float,
                   default=_env_float("IMAGINARY_TPU_ARENA_MB", 0.0),
                   help="per-thread native codec scratch-arena budget in "
                        "MB: worker threads reuse decode/resize/encode "
                        "scratch at its high-water size, an over-budget "
                        "thread drops its arena after the call (0 = "
                        "unlimited)")
    # multi-GPU serving (engine/lanes.py) and the spatial route
    p.add_argument("--devices", type=int,
                   default=_env_int("IMAGINARY_TPU_DEVICES", 0),
                   help="device count of the lanes' mesh (0 = all visible "
                        "cards; with --device cpu, that many cpu entries)")
    p.add_argument("--spatial", type=int,
                   default=_env_int("IMAGINARY_TPU_SPATIAL", 1),
                   help="spatial axis of the lanes' mesh: a single image "
                        "whose input bucket crosses the bar is W-sharded "
                        "over that many entries (1 = off)")
    p.add_argument("--spatial-threshold-px", type=int,
                   default=_env_int("IMAGINARY_TPU_SPATIAL_THRESHOLD_PX", 3840 * 2160),
                   help="input-bucket pixel count at which a single image "
                        "W-shards over the spatial axis")
    p.add_argument("--mesh-policy",
                   default=_env_str("IMAGINARY_TPU_MESH_POLICY", "off"),
                   choices=list(MESH_POLICIES),
                   help="multi-GPU serving: 'lanes' gives every card its own "
                        "continuous-batching lane (own stream, formation "
                        "cap, in-flight window and fault domain); "
                        "'sharded'/'auto' also split big chunks over the "
                        "healthy cards; 'off' (default) is one "
                        "collector/fetcher pair on --device")
    p.add_argument("--spatial-mpix", type=float,
                   default=_env_float("IMAGINARY_TPU_SPATIAL_MPIX", 0.0),
                   help="the spatial bar in megapixels (maps onto "
                        "--spatial-threshold-px; 0 keeps the pixel knob)")
    p.add_argument("--use-mesh", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_USE_MESH"),
                   help="shard batches over the device mesh (--devices, "
                        "--spatial); --mesh-policy other than off "
                        "supersedes it")
    p.add_argument("--distributed", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_DISTRIBUTED"),
                   help="join a multi-process fleet (torch.distributed "
                        "init_process_group: nccl on the card, gloo with "
                        "--device cpu) before the executor touches a device")
    p.add_argument("--coordinator-address",
                   default=_env_str("IMAGINARY_TPU_COORDINATOR_ADDRESS", ""),
                   help="host:port of process 0 (empty: torchrun's "
                        "environment, env://)")
    p.add_argument("--num-processes", type=int,
                   default=_env_int("IMAGINARY_TPU_NUM_PROCESSES", 0),
                   help="total process count (0: from the environment)")
    p.add_argument("--process-id", type=int,
                   default=_env_int("IMAGINARY_TPU_PROCESS_ID", -1),
                   help="this process's rank (-1: from the environment)")
    p.add_argument("--mesh-hosts", type=int,
                   default=_env_int("IMAGINARY_TPU_MESH_HOSTS", 0),
                   help="join an N-process group at serving boot (requires "
                        "--coordinator-address, --process-id and --workers "
                        "1); each process serves on its own devices; "
                        "<=1 = off")
    p.add_argument("--lane-form-ms", type=float,
                   default=_env_float("IMAGINARY_TPU_LANE_FORM_MS", -1.0),
                   help="per-lane batch-formation cap in ms (negative = "
                        "inherit --batch-form-ms)")
    p.add_argument("--lane-inflight", type=int,
                   default=_env_int("IMAGINARY_TPU_LANE_INFLIGHT", 2),
                   help="per-lane chunks launched but not yet fetched "
                        "(the lane's only backpressure)")
    p.add_argument("--prewarm", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_PREWARM"),
                   help="launch the common op chains at every batch size "
                        "on the card before the server binds")
    # the compressed-domain transport (pipeline.py)
    p.add_argument("--transport-dct", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_TRANSPORT_DCT"),
                   help="serve baseline JPEG requests (4:2:0/4:2:2/4:4:4/"
                        "grayscale) over the compressed-domain transport: "
                        "host entropy decode ships DCT coefficients, the "
                        "device runs the IDCT, and shrink-on-load folds in "
                        "the DCT domain")
    p.add_argument("--transport-dct-egress", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_TRANSPORT_DCT_EGRESS"),
                   help="drain JPEG-bound dct-transport responses as "
                        "quantized DCT coefficients: the device runs the "
                        "forward DCT + quantization and the host only "
                        "entropy-codes (requires --transport-dct)")
    p.add_argument("--dct-native", choices=("auto", "native", "python"),
                   default=os.environ.get("IMAGINARY_TPU_DCT_NATIVE", "auto"),
                   help="entropy-decoder arm for the dct transport: the "
                        "native C kernel, the pure-python oracle, or auto "
                        "(native if built, else python)")
    # content-addressed caching (cache.py); every knob also honors an
    # IMAGINARY_TPU_CACHE_* env override and defaults OFF so the uncached
    # serving path stays byte-identical
    p.add_argument("--cache-result-mb", type=float,
                   default=_env_float("IMAGINARY_TPU_CACHE_RESULT_MB", 0.0),
                   help="encoded-result LRU byte budget in MB (0=off); "
                        "enables strong ETag + If-None-Match 304")
    p.add_argument("--cache-frame-mb", type=float,
                   default=_env_float("IMAGINARY_TPU_CACHE_FRAME_MB", 0.0),
                   help="decoded-frame LRU byte budget in MB (0=off)")
    p.add_argument("--cache-device-mb", type=float,
                   default=_env_float("IMAGINARY_TPU_CACHE_DEVICE_MB", 0.0),
                   help="device-resident packed-frame cache byte budget in "
                        "MB of HBM (0=off); hot sources skip the H2D "
                        "transfer entirely on repeat requests")
    p.add_argument("--cache-coalesce", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_CACHE_COALESCE"),
                   help="coalesce concurrent identical requests onto one "
                        "pipeline run")
    p.add_argument("--cache-source-ttl", type=float,
                   default=_env_float("IMAGINARY_TPU_CACHE_SOURCE_TTL", 0.0),
                   help="TTL seconds for the remote ?url= source cache (0=off)")
    p.add_argument("--cache-source-mb", type=float,
                   default=_env_float("IMAGINARY_TPU_CACHE_SOURCE_MB", 32.0),
                   help="remote-source cache byte budget in MB")
    # placement and the card's fault domain (engine/executor.py)
    p.add_argument("--host-spill",
                   default=_env_str("IMAGINARY_TPU_HOST_SPILL", "off"),
                   choices=["auto", "on", "off"],
                   help="spill to the host interpreter when the device "
                        "backlog outprices it, and serve host-executable "
                        "work on the host during an outage or when an item "
                        "does not fit the device alone (auto/on: the "
                        "measured cost model decides the spill; host answers "
                        "carry X-Imaginary-Backend: host). off by default: "
                        "the card serves every request or answers its error")
    p.add_argument("--force-host", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_FORCE_HOST"),
                   help="pin every host-executable plan to the host "
                        "interpreter (a measurement override; device-only "
                        "plans still ride the card)")
    p.add_argument("--host-dct-spill",
                   default=_env_str("IMAGINARY_TPU_HOST_DCT_SPILL", "on"),
                   choices=["on", "off"],
                   help="DCT-domain shrink-on-load for dct-transport plans "
                        "placed on the host (off: such plans never run "
                        "on the host)")
    p.add_argument("--hedge-threshold-ms", type=float,
                   default=_env_float("IMAGINARY_TPU_HEDGE_THRESHOLD_MS", 0.0),
                   help="launch a host twin for a device request pending "
                        "this long (floored at 50 ms and at 4x its "
                        "estimated service); first answer wins; 0 disables")
    p.add_argument("--hedge-budget", type=float,
                   default=_env_float("IMAGINARY_TPU_HEDGE_BUDGET", 0.05),
                   help="max concurrent hedges as a fraction of in-flight "
                        "device items (floor 1)")
    p.add_argument("--integrity", action="store_true",
                   default=_env_bool("IMAGINARY_TPU_INTEGRITY"),
                   help="arm output integrity: the golden probe, sampled "
                        "verification of device chunks (a mismatch is a "
                        "corruption strike and the answer is re-served "
                        "from the verified copy) and poison isolation")
    p.add_argument("--integrity-sample", type=float,
                   default=_env_float("IMAGINARY_TPU_INTEGRITY_SAMPLE", 1.0 / 256.0),
                   help="fraction of device chunks recomputed and compared "
                        "before release (1.0 verifies every chunk)")
    p.add_argument("--integrity-clean-probes", type=int,
                   default=_env_int("IMAGINARY_TPU_INTEGRITY_CLEAN_PROBES", 3),
                   help="consecutive clean golden probes a corruption-"
                        "struck device needs to be re-admitted")
    p.add_argument("--integrity-poison-ttl", type=float,
                   default=_env_float("IMAGINARY_TPU_INTEGRITY_POISON_TTL", 300.0),
                   help="seconds a convicted input stays in the poison list")
    p.add_argument("--integrity-poison-cap", type=int,
                   default=_env_int("IMAGINARY_TPU_INTEGRITY_POISON_CAP", 256),
                   help="max poison-list entries (oldest evicted)")
    p.add_argument("--failslow-ratio", type=float,
                   default=_env_float("IMAGINARY_TPU_FAILSLOW_RATIO", 0.0),
                   help="demote a device whose golden-probe latency EWMA "
                        "exceeds this ratio x its peers' median; 0 disables")
    p.add_argument("--failslow-min-samples", type=int,
                   default=_env_int("IMAGINARY_TPU_FAILSLOW_MIN_SAMPLES", 8),
                   help="probe samples a device and its peers each need "
                        "before fail-slow demotion may trigger")
    p.add_argument("--failslow-share", type=float,
                   default=_env_float("IMAGINARY_TPU_FAILSLOW_SHARE", 0.0),
                   help="share of its rotation a demoted device keeps "
                        "(0 = full shed)")
    # the port's own
    p.add_argument("--device", default=_env_str("IMAGINARY_TPU_DEVICE", "cuda"),
                   help="torch device to run the kernels on (cuda, cuda:N, or cpu)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    p = build_parser()
    args = p.parse_args(argv)
    if args.transport_dct_egress and not args.transport_dct:
        p.error("--transport-dct-egress requires --transport-dct")
    return args


def _resolve_workers(n: int) -> int:
    if n == 0:  # one per core
        return max(1, os.cpu_count() or 1)
    return max(1, n)


def options_from_args(args: argparse.Namespace) -> ServerOptions:
    """ServerOptions from the parsed flags, with the reference's boot
    checks (imaginary.go:196-229); a failed check exits."""
    port = args.port
    if os.environ.get("PORT"):
        try:
            port = int(os.environ["PORT"])
        except ValueError:
            pass
    signature_key = args.url_signature_key or os.environ.get("URL_SIGNATURE_KEY", "")
    log_level = os.environ.get("LOG_LEVEL", args.log_level)
    placeholder_image = b""
    if args.placeholder:
        with open(args.placeholder, "rb") as f:
            placeholder_image = f.read()
        from imaginary_tpu_torch.imgtype import ImageType, determine_image_type

        if determine_image_type(placeholder_image) is ImageType.UNKNOWN:
            raise SystemExit("placeholder image is not a valid image")
    if args.enable_url_signature and len(signature_key) < 32:
        raise SystemExit("URL signature key must be at least 32 characters long")
    if args.mount and not os.path.isdir(args.mount):
        raise SystemExit(f"mount directory does not exist: {args.mount}")
    if args.http_cache_ttl < -1 or args.http_cache_ttl > 31556926:
        raise SystemExit("The -http-cache-ttl flag only accepts a value from 0 to 31556926")
    if (args.fleet_coherence or args.fleet_qos) and args.fleet_cache_mb <= 0:
        # the claim and qos tables live in the shared cache file
        raise SystemExit(
            "--fleet-coherence/--fleet-qos require --fleet-cache-mb > 0 "
            "(the ownership/claim/qos tables live in the shared cache file)")
    if args.router and not args.peers:
        # a router with no peer table can never route
        raise SystemExit("--router requires --peers (the routing ring is "
                         "built from the gossiped peer table)")
    if args.peers:
        # an unreadable @file or an empty list refuses to start, never
        # gossips into the void
        from imaginary_tpu_torch.fleet import multihost

        try:
            if not multihost.parse_peers(args.peers):
                raise ValueError("--peers resolved to an empty peer list")
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if args.mesh_hosts > 1:
        if not args.coordinator_address:
            raise SystemExit("--mesh-hosts requires --coordinator-address (process 0 of "
                             "the mesh)")
        if args.process_id < 0:
            raise SystemExit("--mesh-hosts requires --process-id")
        if _resolve_workers(args.workers) != 1:
            # a mesh process owns its devices outright; a local worker
            # fleet would fight the mesh for them
            raise SystemExit("--mesh-hosts requires --workers 1")
    if args.qos_config:
        # a malformed policy fails the boot loudly, never serves unisolated
        from imaginary_tpu_torch.qos.tenancy import load_policy

        try:
            load_policy(args.qos_config)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if args.slo_config:
        # a typo'd objective table refuses to start, never tracks nothing
        from imaginary_tpu_torch.obs.slo import load_config as load_slo_config

        try:
            load_slo_config(args.slo_config)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if args.cost_attribution:
        # a malformed window spec refuses to start
        from imaginary_tpu_torch.obs.cost import parse_windows

        try:
            parse_windows(args.cost_windows)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    return ServerOptions(
        port=port,
        address=args.addr,
        path_prefix=args.path_prefix,
        cors=args.cors,
        api_key=args.key,
        mount=args.mount,
        http_cache_ttl=args.http_cache_ttl,
        enable_url_source=args.enable_url_source,
        enable_placeholder=args.enable_placeholder,
        auth_forwarding=args.enable_auth_forwarding,
        enable_url_signature=args.enable_url_signature,
        url_signature_key=signature_key,
        allowed_origins=parse_origins(args.allowed_origins),
        max_allowed_size=args.max_allowed_size,
        max_allowed_pixels=args.max_allowed_resolution,
        cert_file=args.certfile,
        key_file=args.keyfile,
        http2=not args.disable_http2,
        read_timeout_s=max(0.0, args.read_timeout),
        workers=_resolve_workers(args.workers),
        fleet_cache_mb=max(0.0, args.fleet_cache_mb),
        fleet_roll_grace_s=max(0.0, args.fleet_roll_grace),
        fleet_coherence=args.fleet_coherence,
        fleet_hop_ms=max(1.0, args.fleet_hop_ms),
        fleet_qos=args.fleet_qos,
        fleet_admin_port=max(0, args.fleet_admin_port),
        peers=args.peers,
        router=args.router,
        host_id=args.host_id,
        peer_probe_interval=max(0.05, args.peer_probe_interval),
        authorization=args.authorization,
        forward_headers=parse_forward_headers(args.forward_headers),
        placeholder=args.placeholder,
        placeholder_image=placeholder_image,
        placeholder_status=args.placeholder_status,
        concurrency=args.concurrency,
        burst=args.burst,
        log_level=log_level,
        return_size=args.return_size,
        cpus=args.cpus,
        endpoints=parse_endpoints(args.disable_endpoints),
        trace_enabled=not args.disable_tracing,
        wide_events=args.wide_events,
        wide_events_sample=min(1.0, max(0.0, args.wide_events_sample)),
        slo_config=args.slo_config,
        enable_debug=args.enable_debug,
        cost_attribution=args.cost_attribution,
        cost_topk=max(1, args.cost_topk),
        cost_windows=args.cost_windows,
        source_retries=max(0, args.source_retries),
        source_connect_timeout_s=max(0.001, args.source_connect_timeout),
        source_read_timeout_s=max(0.001, args.source_read_timeout),
        request_timeout_s=max(0.0, args.request_timeout),
        prewarm=args.prewarm,
        max_queue_ms=max(0.0, args.max_queue_ms),
        qos_config=args.qos_config,
        pressure_rss_mb=max(0.0, args.pressure_rss_mb),
        pressure_hbm_mb=max(0.0, args.pressure_hbm_mb),
        pressure_elevated_frac=min(1.0, max(0.01, args.pressure_elevated_frac)),
        pressure_critical_frac=min(1.0, max(0.01, args.pressure_critical_frac)),
        pressure_batch_mb=max(0.0, args.pressure_batch_mb),
        pressure_oversize_mpix=max(0.0, args.pressure_oversize_mpix),
        pressure_pixel_frac=min(1.0, max(0.01, args.pressure_pixel_frac)),
        device=args.device,
        batch_window_ms=args.batch_window_ms,
        max_batch=args.max_batch,
        batch_policy=args.batch_policy,
        batch_form_ms=max(0.0, args.batch_form_ms),
        max_inflight=max(1, args.max_inflight),
        donation=args.donation != "off",
        arena_mb=max(0.0, args.arena_mb),
        mesh_policy=args.mesh_policy,
        n_devices=max(0, args.devices),
        lane_form_ms=args.lane_form_ms if args.lane_form_ms >= 0 else None,
        lane_inflight=max(1, args.lane_inflight),
        spatial=max(1, args.spatial),
        spatial_threshold_px=max(1, args.spatial_threshold_px),
        spatial_mpix=max(0.0, args.spatial_mpix),
        use_mesh=args.use_mesh,
        distributed=args.distributed,
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes or None,
        process_id=args.process_id if args.process_id >= 0 else None,
        mesh_hosts=max(0, args.mesh_hosts),
        transport_dct=args.transport_dct,
        transport_dct_egress=args.transport_dct_egress,
        dct_native=args.dct_native,
        cache_result_mb=max(0.0, args.cache_result_mb),
        cache_frame_mb=max(0.0, args.cache_frame_mb),
        cache_device_mb=max(0.0, args.cache_device_mb),
        cache_coalesce=args.cache_coalesce,
        cache_source_ttl=max(0.0, args.cache_source_ttl),
        cache_source_mb=max(0.0, args.cache_source_mb),
        host_spill={"auto": None, "on": True, "off": False}[args.host_spill],
        force_host=args.force_host,
        host_dct_spill=args.host_dct_spill != "off",
        hedge_threshold_ms=max(0.0, args.hedge_threshold_ms),
        hedge_budget=min(1.0, max(0.0, args.hedge_budget)),
        integrity=args.integrity,
        integrity_sample=min(1.0, max(0.0, args.integrity_sample)),
        integrity_clean_probes=max(1, args.integrity_clean_probes),
        integrity_poison_ttl=max(0.0, args.integrity_poison_ttl),
        integrity_poison_cap=max(1, args.integrity_poison_cap),
        failslow_ratio=max(0.0, args.failslow_ratio),
        failslow_min_samples=max(1, args.failslow_min_samples),
        failslow_share=min(1.0, max(0.0, args.failslow_share)),
    )


def nvml_device_count() -> int:
    """The cards NVML sees, or -1 where NVML is absent: a count that
    neither initialises the CUDA driver nor creates a context."""
    import ctypes

    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return -1
    if nvml.nvmlInit_v2() != 0:
        return -1
    try:
        n = ctypes.c_uint(0)
        return n.value if nvml.nvmlDeviceGetCount_v2(ctypes.byref(n)) == 0 else -1
    finally:
        nvml.nvmlShutdown()


def device_refusal(args: argparse.Namespace, nvml: bool = False) -> str:
    """Why the server must not start on this machine ("" when it may):
    the kernels run on the card, and nothing falls back to the CPU unless
    --device cpu asked for it; --require-device accepts only CUDA. With
    `nvml` the card is counted through NVML (`nvml_device_count`), so the
    asking process (the supervisor) never initialises CUDA; without NVML
    the check is left to the workers."""
    import torch

    cuda = torch.device(args.device).type == "cuda"
    if args.require_device and not cuda:
        return f"--require-device is set and --device is {args.device}"
    if cuda and (nvml_device_count() == 0 if nvml else not torch.cuda.is_available()):
        return "CUDA is not available; pass --device cpu to serve on the CPU"
    return ""


def join_fleet(o: ServerOptions) -> None:
    """Join the process group before the executor touches a device, as the
    reference's boot does (cli.py:930-952): --distributed with its
    arguments, or --mesh-hosts N processes. The backend follows --device
    (parallel/mesh.init_distributed)."""
    if not (o.distributed or o.mesh_hosts > 1):
        return
    from imaginary_tpu_torch.parallel.mesh import init_distributed

    init_distributed(coordinator_address=o.coordinator_address or None,
                     num_processes=o.num_processes if o.distributed else o.mesh_hosts,
                     process_id=o.process_id, device=o.device)


def make_server_from_args(args: argparse.Namespace):
    """Bind (not start) the server the parsed command line describes."""
    from imaginary_tpu_torch.web.app import AppServer

    return AppServer(options_from_args(args))


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.version:
        print(Version)
        return 0
    o = options_from_args(args)
    if args.gzip:  # ref: imaginary.go:168-171
        print("warning: -gzip flag is deprecated and will not have effect")
    host_info = host_identity(o)
    from imaginary_tpu_torch.web.workers import WORKER_ENV

    if o.workers > 1 and WORKER_ENV not in os.environ:
        return _supervise(args, o, argv, host_info)
    why = device_refusal(args)
    if why:
        print(f"imaginary_tpu_torch: refusing to start: {why}", file=sys.stderr)
        return 2
    join_fleet(o)
    # IMAGINARY_TPU_PROFILE_DIR=<dir>: a torch.profiler capture of the whole
    # serving run, exported into <dir> at exit (engine/timing.py)
    from imaginary_tpu_torch.engine.timing import maybe_start_profiler, stop_profiler

    if maybe_start_profiler(o.device):
        import atexit

        atexit.register(stop_profiler)
    from imaginary_tpu_torch.parallel.mesh import shutdown_distributed
    from imaginary_tpu_torch.web.app import serve

    try:
        asyncio.run(serve(o, mrelease=args.mrelease))
    except KeyboardInterrupt:
        pass
    finally:
        shutdown_distributed()
    return 0


def host_identity(o: ServerOptions):
    """With --peers, this host's identity for the cross-host plane: the
    (id, epoch) pair stamped into the environment once (so the workers a
    supervisor spawns inherit the same incarnation, and never mint their
    own epoch) and the serving base peers forward to. None without
    --peers."""
    if not o.peers:
        return None
    from imaginary_tpu_torch.fleet import multihost

    hid, hepoch = multihost.ensure_host_identity(o.host_id)
    scheme = "https" if o.cert_file and o.key_file else "http"
    return {"id": hid, "epoch": hepoch,
            "serve_url": (f"{scheme}://{o.address or '127.0.0.1'}:{o.port}"
                          f"{o.path_prefix.rstrip('/')}")}


def _supervise(args: argparse.Namespace, o: ServerOptions, argv, host_info=None) -> int:
    """The parent of a --workers fleet becomes its supervisor
    (web/workers.py): the device check (through NVML, never a CUDA
    context), the kernels built before the first spawn, the shared cache
    file created once for every worker, then the workers, each a fresh
    `python -m imaginary_tpu_torch.cli` with the same arguments. With
    --peers (`host_info`) it also runs the host's gossip and stamps the
    host epoch into the shared cache file."""
    from imaginary_tpu_torch.web import workers

    # refuse loudly before any worker pays its boot
    workers.check_reuseport()
    why = device_refusal(args, nvml=True)
    if why:
        print(f"imaginary_tpu_torch: refusing to start: {why}", file=sys.stderr)
        return 2
    workers.prepare_kernels(o.device)
    # the liveness probe's target (/health needs no key); a TLS fleet is
    # probed without verification, over loopback
    scheme = "https" if o.cert_file and o.key_file else "http"
    health_url = f"{scheme}://127.0.0.1:{o.port}{o.path_prefix.rstrip('/')}/health"
    fleet = None
    if o.fleet_cache_mb > 0:
        from imaginary_tpu_torch.fleet import shmcache

        fleet = shmcache.ShmCache.create_for_fleet(o.fleet_cache_mb)
        os.environ[shmcache.PATH_ENV] = fleet.path
    try:
        return workers.run_supervisor(
            list(argv) if argv is not None else sys.argv[1:], o.workers,
            health_url=health_url, fleet=fleet, roll_grace_s=o.fleet_roll_grace_s,
            admin_port=o.fleet_admin_port, host_info=host_info, peers=o.peers,
            peer_probe_interval=o.peer_probe_interval)
    finally:
        if fleet is not None:
            fleet.close()


if __name__ == "__main__":
    sys.exit(main())
