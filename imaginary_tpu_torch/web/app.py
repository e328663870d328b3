"""The port's HTTP server: `ImageService` behind `http.server`.

`make_server` binds a `ThreadingHTTPServer`; each connection gets a thread,
on which `ImageService` decodes, plans and encodes, while its executor
batches the device work of concurrent requests. Closing the server shuts
the executor down. The aiohttp layer of the reference (middleware, h2,
workers) is a later slice.
"""

from __future__ import annotations

import re
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from imaginary_tpu_torch.engine import MAX_BATCH
from imaginary_tpu_torch.errors import ErrEntityTooLarge, new_error
from imaginary_tpu_torch.web.handlers import (
    MAX_BODY_SIZE,
    ImageService,
    Response,
    error_response,
    parse_query,
)

# a chunk-size line: hex digits only, so no sign, prefix or underscore
_HEX = re.compile(rb"[0-9A-Fa-f]+")


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "imaginary-tpu-torch"

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def __getattr__(self, name: str):
        # every other method (PUT, DELETE, PATCH, HEAD, OPTIONS, ...) reaches
        # the service too, which answers the reference's 405, instead of
        # http.server's 501 page
        if name.startswith("do_"):
            return lambda: self._dispatch(name[3:])
        raise AttributeError(name)

    def _dispatch(self, method: str) -> None:
        url = urllib.parse.urlsplit(self.path)
        try:
            body = self._read_body()
        except ValueError:
            self.close_connection = True
            self._send(error_response(new_error("Malformed request body", 400)))
            return
        if body is None:
            self.close_connection = True  # the rest of the body stays unread
            self._send(error_response(ErrEntityTooLarge))
            return
        service: ImageService = self.server.service
        self._send(service.handle(method, url.path, parse_query(url.query),
                                  self.headers, body))

    def _read_body(self):
        """The request body: Content-Length bytes, or the chunks of a
        `Transfer-Encoding: chunked` body joined. None once it passes
        MAX_BODY_SIZE; ValueError on a malformed length or chunk size."""
        if "chunked" not in (self.headers.get("Transfer-Encoding") or "").lower():
            length = int(self.headers.get("Content-Length") or 0)
            if length > MAX_BODY_SIZE:
                return None
            return self.rfile.read(length) if length > 0 else b""
        parts, total = [], 0
        while True:
            line = self.rfile.readline(1 << 16).split(b";", 1)[0].strip()
            if not _HEX.fullmatch(line):
                raise ValueError(f"chunk size {line[:32]!r}")
            size = int(line, 16)
            if size == 0:
                while self.rfile.readline(1 << 16) not in (b"\r\n", b"\n", b""):
                    pass  # trailer fields, unused
                return b"".join(parts)
            total += size
            if total > MAX_BODY_SIZE:
                return None
            chunk = self.rfile.read(size)
            if len(chunk) != size:
                raise ValueError("chunk cut short")
            parts.append(chunk)
            if self.rfile.readline(1 << 16) not in (b"\r\n", b"\n"):
                raise ValueError("no CRLF after a chunk")

    def _send(self, resp: Response) -> None:
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        for k, v in resp.headers.items():
            self.send_header(k, v)
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(resp.body)

    def log_message(self, fmt, *args):  # access logging is a later slice
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # concurrent clients connect at once; the default backlog of 5 would
    # make the kernel drop their SYNs and the clients retry a second later
    request_queue_size = 128

    def server_close(self) -> None:
        super().server_close()
        service = getattr(self, "service", None)
        if service is not None:
            service.close()


def make_server(host: str = "0.0.0.0", port: int = 9000, device="cuda",
                mount: str = "", max_batch: int = MAX_BATCH,
                batch_form_ms: float = 5.0, max_inflight: int = 4,
                transport_dct: bool = False,
                transport_dct_egress: bool = False, mesh_policy: str = "off",
                n_devices: int = 0, devices=None, lane_form_ms=None,
                lane_inflight: int = 2, shard_min_items: int = 0,
                breaker_threshold: int = 3,
                breaker_cooldown_s: float = 30.0, spatial: int = 1,
                spatial_threshold_px: int = 3840 * 2160,
                spatial_mpix: float = 0.0) -> ThreadingHTTPServer:
    """Bind (not start) the server; `serve_forever()` runs it and
    `shutdown()` + `server_close()` stop it (and its executor)."""
    srv = _Server((host, port), _Handler)
    try:
        srv.service = ImageService(device=device, mount=mount, max_batch=max_batch,
                                   batch_form_ms=batch_form_ms,
                                   max_inflight=max_inflight,
                                   transport_dct=transport_dct,
                                   transport_dct_egress=transport_dct_egress,
                                   mesh_policy=mesh_policy, n_devices=n_devices,
                                   devices=devices, lane_form_ms=lane_form_ms,
                                   lane_inflight=lane_inflight,
                                   shard_min_items=shard_min_items,
                                   breaker_threshold=breaker_threshold,
                                   breaker_cooldown_s=breaker_cooldown_s,
                                   spatial=spatial,
                                   spatial_threshold_px=spatial_threshold_px,
                                   spatial_mpix=spatial_mpix)
    except BaseException:
        srv.server_close()
        raise
    return srv
