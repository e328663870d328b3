"""Server configuration (the port's copy of `imaginary_tpu/web/config.py`;
ref: ServerOptions, server.go:20-51).

Immutable after startup and threaded through every constructor. Trimmed
to the fields the port's HTTP layer reads, plus the executor, lane,
spatial and transport knobs the port serves with and its own `device`.
The reference's --gzip, --http-read-timeout and --http-write-timeout
parse (cli.py) but set nothing, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from imaginary_tpu_torch.engine.executor import MAX_BATCH


@dataclasses.dataclass
class ServerOptions:
    port: int = 9000
    address: str = ""
    path_prefix: str = "/"
    burst: int = 100
    concurrency: int = 0
    http_cache_ttl: int = -1
    max_allowed_size: int = 0  # bytes of a fetched URL source (URL sources: not ported)
    max_allowed_pixels: float = 18.0  # megapixels (ref: imaginary.go:36)
    cors: bool = False
    enable_placeholder: bool = False
    enable_url_signature: bool = False
    url_signature_key: str = ""
    api_key: str = ""
    mount: str = ""
    cert_file: str = ""
    key_file: str = ""
    placeholder: str = ""
    placeholder_status: int = 0
    placeholder_image: bytes = b""
    endpoints: tuple = ()  # disabled endpoint names (ref: Endpoints)
    log_level: str = "info"
    return_size: bool = False
    cpus: int = 0  # host worker-thread cap, 0 = auto
    # Per-request span tracing: X-Request-ID is always assigned and
    # echoed; this gates span accumulation and Server-Timing.
    trace_enabled: bool = True
    # --- the device and the executor (engine/executor.py) -------------------
    device: str = "cuda"  # torch device of the kernels: cuda, cuda:N or cpu
    max_batch: int = MAX_BATCH
    batch_form_ms: float = 5.0
    max_inflight: int = 4
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
    # compressed-domain transport both ways (pipeline.py)
    transport_dct: bool = False
    transport_dct_egress: bool = False

    def is_endpoint_enabled(self, path: str) -> bool:
        """Endpoint disabling by last path segment (ref: server.go:57-66)."""
        segment = path.rstrip("/").split("/")[-1]
        return segment not in self.endpoints


def parse_endpoints(value: str) -> tuple:
    """CSV of endpoint names to disable (ref: imaginary.go:328-337)."""
    return tuple(e.strip().lower() for e in value.split(",") if e.strip())
