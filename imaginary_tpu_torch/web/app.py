"""The port's HTTP server: `ImageService` behind `http.server`.

`make_server` binds a `ThreadingHTTPServer`; each connection gets a thread,
and `ImageService` runs the image work one request at a time. The aiohttp
layer of the reference (middleware, h2, workers) is a later slice.
"""

from __future__ import annotations

import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from imaginary_tpu_torch.errors import ErrEntityTooLarge
from imaginary_tpu_torch.web.handlers import (
    MAX_BODY_SIZE,
    ImageService,
    Response,
    error_response,
    parse_query,
)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "imaginary-tpu-torch"

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_PUT(self):
        self._dispatch("PUT")

    def _dispatch(self, method: str) -> None:
        url = urllib.parse.urlsplit(self.path)
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_SIZE:
            self.close_connection = True  # the body stays unread
            self._send(error_response(ErrEntityTooLarge))
            return
        body = self.rfile.read(length) if length > 0 else b""
        service: ImageService = self.server.service
        self._send(service.handle(method, url.path, parse_query(url.query),
                                  self.headers, body))

    def _send(self, resp: Response) -> None:
        self.send_response(resp.status)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        for k, v in resp.headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(resp.body)

    def log_message(self, fmt, *args):  # access logging is a later slice
        pass


def make_server(host: str = "0.0.0.0", port: int = 9000, device="cuda",
                mount: str = "") -> ThreadingHTTPServer:
    """Bind (not start) the server; `serve_forever()` runs it and
    `shutdown()` + `server_close()` stop it."""
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.daemon_threads = True
    srv.service = ImageService(device=device, mount=mount)
    return srv
