"""HTTP handlers of the port: sources, params, errors and the image routes.

The port's counterpart of `imaginary_tpu/web/{sources,handlers}.py` for
this slice, free of any HTTP framework: `ImageService.handle` takes the
method, path, query, headers and body and returns a `Response`, and
`web/app.py` binds it to the standard library's HTTP server. It keeps the
reference's param parsing, error JSON and status codes.

Served: `/`, `/health`, `/resize`, `/fit`, `/enlarge`, `/extract`,
`/crop`, `/smartcrop`, `/thumbnail`, `/zoom`, `/rotate`, `/autorotate`,
`/flip`, `/flop`, `/convert`, `/blur`, `/watermark` and `/pipeline`, on
JPEG (the native codec) and PNG, WEBP, GIF and TIFF (Pillow) sources and
targets; with the dct transport switched on, JPEG in and out rides the
compressed domain. The reference's other routes (`/watermarkimage`,
`/info`) answer 501 until their slice lands. Requests run concurrently on
the server's threads: decode and encode on the request's own thread, the
device work through one micro-batching `Executor` per service, which
groups concurrent requests that share a chain into one launch.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import logging
import os
import threading
import time
import urllib.parse
from email.parser import BytesParser
from email.policy import HTTP

import torch

from imaginary_tpu_torch import Version, codecs, kernels, pipeline
from imaginary_tpu_torch.engine import MAX_BATCH, Executor, ExecutorConfig
from imaginary_tpu_torch.errors import (
    ErrEmptyBody,
    ErrGetMethodNotAllowed,
    ErrInvalidFilePath,
    ErrMethodNotAllowed,
    ErrMissingParamFile,
    ErrNotImplemented,
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
from imaginary_tpu_torch.params import ParamError, build_params_from_query

MAX_BODY_SIZE = 1 << 26  # 64 MB (ref: source_body.go:13)
FORM_FIELD = "file"  # ref: source_body.go:12
MAX_ALLOWED_MPIX = 18.0  # ref: imaginary.go:36

SERVED_OPERATIONS = ("resize", "fit", "enlarge", "extract", "crop",
                     "smartcrop", "thumbnail", "zoom", "rotate", "autorotate",
                     "flip", "flop", "convert", "blur", "watermark", "pipeline")
# The reference's image routes (ref: OperationsMap, image.go:15-32, plus
# /info and /pipeline): known here so they answer 501, not 404.
REFERENCE_OPERATIONS = (
    "resize", "fit", "enlarge", "extract", "crop", "smartcrop", "rotate",
    "autorotate", "flip", "flop", "thumbnail", "zoom", "convert", "blur",
    "watermark", "watermarkimage", "info", "pipeline",
)

_ACCEPT_TO_TYPE = {"image/webp": "webp", "image/png": "png", "image/jpeg": "jpeg"}

_LOG = logging.getLogger(__name__)


@dataclasses.dataclass
class Response:
    status: int
    content_type: str
    body: bytes
    headers: dict = dataclasses.field(default_factory=dict)


# The reference's router and server answer these two themselves (aiohttp's
# plain-text pages): a path no route matches, and an exception raised
# outside the image handler's processing.
NOT_FOUND = Response(404, "text/plain; charset=utf-8", b"404: Not Found")
INTERNAL_ERROR = Response(500, "text/plain; charset=utf-8",
                          b"500 Internal Server Error\n\nServer got itself in trouble")


def error_response(err: ImageError) -> Response:
    """ErrorReply equivalent (error.go:58-67): the JSON error body."""
    return Response(err.http_code(), "application/json", err.json_bytes(),
                    dict(err.headers))


def determine_accept_mime_type(accept: str) -> str:
    """Preferred output format from the Accept header (ref: controllers.go:63-76)."""
    for part in accept.split(","):
        media = part.split(";", 1)[0].strip().lower()
        if media in _ACCEPT_TO_TYPE:
            return _ACCEPT_TO_TYPE[media]
    return ""


def _read_form(body: bytes, ctype: str, field: str) -> bytes:
    """The multipart part named `field` (ref: source_body.go:30-100)."""
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + ctype.encode("latin-1") + b"\r\n\r\n" + body)
    if msg.is_multipart():
        for part in msg.iter_parts():
            if part.get_param("name", header="content-disposition") == field:
                return part.get_payload(decode=True) or b""
    raise ErrMissingParamFile


class ImageService:
    """Serves the slice's routes on `device`, or with a `mesh_policy` on
    one executor lane per mesh entry; `handle` may run on many threads at
    once. `close()` shuts the executor down. The dct transport
    switches are process-wide (`pipeline.set_transport_dct`), set here
    from the server's options as the reference's server sets them."""

    def __init__(self, device="cuda", mount: str = "", max_batch: int = MAX_BATCH,
                 batch_form_ms: float = 5.0, max_inflight: int = 4,
                 transport_dct: bool = False, transport_dct_egress: bool = False,
                 mesh_policy: str = "off", n_devices: int = 0, devices=None,
                 lane_form_ms=None, lane_inflight: int = 2, shard_min_items: int = 0,
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 30.0,
                 spatial: int = 1, spatial_threshold_px: int = 3840 * 2160,
                 spatial_mpix: float = 0.0):
        if transport_dct_egress and not transport_dct:
            raise ValueError("the dct egress requires the dct transport")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass --device cpu to serve on the CPU")
        self.mount = os.path.abspath(mount) if mount else ""
        self._started = time.time()
        self.executor = Executor(ExecutorConfig(
            max_batch=max_batch, max_form_ms=batch_form_ms,
            max_inflight=max(1, max_inflight), device=str(self.device),
            mesh_policy=mesh_policy, n_devices=n_devices, devices=devices,
            lane_form_ms=lane_form_ms, lane_inflight=max(1, lane_inflight),
            shard_min_items=shard_min_items, breaker_threshold=breaker_threshold,
            breaker_cooldown_s=breaker_cooldown_s, spatial=spatial,
            spatial_threshold_px=spatial_threshold_px, spatial_mpix=spatial_mpix))
        pipeline.set_transport_dct(transport_dct)
        pipeline.set_transport_dct_egress(transport_dct_egress)

    def close(self) -> None:
        self.executor.shutdown()

    def handle(self, method: str, path: str, query: dict, headers,
               body: bytes) -> Response:
        """Route one request. `query` maps key -> first value."""
        try:
            # GET and POST only, on every path (ref: middleware.go:179-187)
            if method not in ("GET", "POST"):
                raise ErrMethodNotAllowed
            if path == "/":
                return self._json(self.versions())
            if path == "/health":
                return self._json(self.health())
            name = path.lstrip("/").lower()
            if name not in REFERENCE_OPERATIONS or "/" in name:
                return NOT_FOUND
            if name not in SERVED_OPERATIONS:
                raise ErrNotImplemented
            buf = self._source(method, query, headers, body)
            try:
                return self._process(name, buf, query, headers)
            except (ImageError, ParamError):
                raise
            except Exception as e:
                # ref: handlers.py:787-790, any other failure of the work
                raise new_error("Error processing image: " + str(e), 400) from None
        except ImageError as e:
            return error_response(e)
        except ParamError as e:
            return error_response(new_error(str(e), 400))
        except Exception:
            _LOG.exception("error handling %s %s", method, path)
            return INTERNAL_ERROR

    def versions(self) -> dict:
        return {"imaginary_tpu_torch": Version, "torch": torch.__version__,
                "backend": self.device.type}

    def health(self) -> dict:
        cuda = self.device.type == "cuda"
        stats = {
            "uptime": round(time.time() - self._started, 2),
            "allocatedMemoryMb": _rss_mb(),
            "threads": threading.active_count(),
            "cpus": os.cpu_count() or 1,
            "gcCollections": sum(s["collections"] for s in gc.get_stats()),
            "pid": os.getpid(),
            "devices": torch.cuda.device_count() if cuda else 1,
            "backend": self.device.type,
            "device": str(self.device),
            "kernelLaunches": kernels.launch_counts(),
            "codecs": codecs.routes(),
            "dctTransport": {"ingress": pipeline.transport_dct_enabled(),
                             "egress": pipeline.transport_dct_egress_enabled(),
                             **pipeline.dct_counts()},
            "executor": self.executor.stats.to_dict(),
        }
        if self.executor.devhealth is not None:  # the lane tier's fault domains
            stats["deviceHealth"] = self.executor.devhealth.snapshot()
        if cuda:
            stats["deviceName"] = torch.cuda.get_device_name(self.device)
            stats["allocatedDeviceMb"] = round(
                torch.cuda.memory_allocated(self.device) / (1 << 20), 2)
        return stats

    @staticmethod
    def _json(obj: dict) -> Response:
        return Response(200, "application/json", json.dumps(obj).encode())

    def _source(self, method: str, query: dict, headers, body: bytes) -> bytes:
        """POST: multipart field or raw body; GET: ?file= under the mount
        (ref: source_body.go, source_fs.go)."""
        if method == "POST":
            ctype = headers.get("Content-Type", "") or ""
            if ctype.startswith("multipart/"):
                buf = _read_form(body, ctype, query.get("field") or FORM_FIELD)
            else:
                buf = body
        else:
            if not self.mount:
                raise ErrGetMethodNotAllowed
            if not query.get("file"):
                # no source matches (ref: sources.py:454-457)
                raise new_error("missing image source", 400)
            buf = self._read_file(query["file"])
        if not buf:
            raise ErrEmptyBody
        return buf

    def _read_file(self, raw: str) -> bytes:
        name = urllib.parse.unquote(raw)
        path = os.path.normpath(os.path.join(self.mount, name.lstrip("/")))
        if not (path == self.mount or path.startswith(self.mount + os.sep)):
            raise ErrInvalidFilePath
        try:
            with open(path, "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            raise ErrInvalidFilePath from None

    def _process(self, name: str, buf: bytes, query: dict, headers) -> Response:
        sniffed = determine_image_type(buf)
        if sniffed is ImageType.UNKNOWN or not is_image_mime_type_supported(
                get_image_mime_type(sniffed)):
            raise ErrUnsupportedMedia
        try:
            opts = build_params_from_query(query)
        except ParamError as e:
            raise new_error("Error while processing parameters: " + str(e), 400) from None
        vary = {}
        if opts.type == "auto":
            opts.type = determine_accept_mime_type(headers.get("Accept", "") or "")
            vary = {"Vary": "Accept"}
        elif opts.type and image_type(opts.type) is ImageType.UNKNOWN:
            raise ErrOutputFormat
        meta = None
        try:
            meta = codecs.probe_fast(buf)
        except ImageError as e:
            if e.code == 501:
                raise
            # probe failure falls through; the decode produces the error
        if meta is not None and meta.width * meta.height / 1e6 > MAX_ALLOWED_MPIX:
            raise ErrResolutionTooBig
        out = pipeline.process_operation(name, buf, opts, device=self.device,
                                         meta=meta, runner=self.executor.process)
        return Response(200, out.mime, out.body, vary)


def _rss_mb() -> float:
    """The process's resident set in MB, from /proc (0.0 where there is none)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 2)
    except OSError:
        pass
    return 0.0


def parse_query(qs: str) -> dict:
    """Query string -> {key: first value} (Go's url.Values.Get)."""
    out: dict = {}
    for k, v in urllib.parse.parse_qsl(qs, keep_blank_values=True):
        out.setdefault(k, v)
    return out

