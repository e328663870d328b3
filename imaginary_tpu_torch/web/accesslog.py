"""Access log (the port's copy of `imaginary_tpu/web/accesslog.py`;
ref: log.go:12-100).

Apache-combined-ish line per request with latency in seconds (4
decimals), level-gated: info logs everything, warning logs status >= 400,
error logs status >= 500 (ref: log.go:88-99). The timestamp carries the
numeric timezone offset, and every line ends with the request's
X-Request-ID. A request forwarded by the HTTP/2 terminator (web/http2.py)
logs the client's address and HTTP/2.0 from its X-Forwarded-* headers,
trusted only when it carries the process's hop token.
"""

from __future__ import annotations

import sys
import time

from aiohttp import web

from imaginary_tpu_torch.obs import trace as obs_trace

_LEVELS = {"debug": 0, "info": 0, "warning": 400, "error": 500}

# Set by serve() when the HTTP/2 terminator runs: a random per-process
# token the terminator attaches as X-Internal-Hop. X-Forwarded-* is
# trusted only on requests carrying it; a loopback peer is not enough.
_TRUSTED_HOP_TOKEN: str = ""


def set_trusted_hop_token(token: str) -> None:
    global _TRUSTED_HOP_TOKEN
    _TRUSTED_HOP_TOKEN = token


def _apache_timestamp() -> str:
    """`04/Aug/2026:12:00:00 +0000`: localtime with its UTC offset."""
    lt = time.localtime()
    off = lt.tm_gmtoff if lt.tm_gmtoff is not None else 0
    sign = "+" if off >= 0 else "-"
    off = abs(off)
    return (time.strftime("%d/%b/%Y:%H:%M:%S", lt)
            + f" {sign}{off // 3600:02d}{(off % 3600) // 60:02d}")


def access_log_middleware(level: str = "info", out=None):
    threshold = _LEVELS.get(level.lower(), 0)
    stream = out or sys.stdout

    @web.middleware
    async def mw(request: web.Request, handler):
        start = time.monotonic()
        status, length = 500, 0  # any non-HTTP exception logs as a 500
        try:
            resp = await handler(request)
            status = resp.status
            length = resp.content_length or 0
        except web.HTTPException as e:
            status = e.status
            raise
        finally:
            if status >= threshold:
                elapsed = time.monotonic() - start
                tr = obs_trace.current()
                rid = tr.request_id if tr is not None else "-"
                peer = request.remote or "-"
                httpv = f"{request.version.major}.{request.version.minor}"
                if (_TRUSTED_HOP_TOKEN
                        and request.headers.get("X-Internal-Hop") == _TRUSTED_HOP_TOKEN):
                    peer = request.headers.get("X-Forwarded-For", peer)
                    httpv = request.headers.get("X-Forwarded-HTTP-Version", httpv)
                stream.write(
                    f'{peer} - - [{_apache_timestamp()}] '
                    f'"{request.method} {request.path_qs} HTTP/{httpv}" '
                    f"{status} {length} {elapsed:.4f} {rid}\n"
                )
        return resp

    return mw
