"""Ingress slow-client hardening: the --read-timeout connection guard
(the port's copy of `imaginary_tpu/web/ingress.py`).

A slowloris connection (headers trickled forever, or an upload that
stalls after its first chunk) costs aiohttp nothing to keep open, and
that is the problem: it pins a connection slot, and during a drain the
draining server itself. aiohttp's server has no header or body read
timeout, so this wrapper protocol adds one at the transport with just
enough HTTP framing to know whether a request is being read right now.

State machine, fed by the raw received bytes:

  IDLE     between requests. No deadline: an idle keep-alive connection
           is the keep-alive timeout's business, and a request the
           server is still processing (client silent, response pending)
           is never killed by a read timeout.
  HEADERS  the first byte after IDLE arms the guard; every received byte
           pushes the deadline (inactivity semantics). Ends at the blank
           line, where Content-Length or Transfer-Encoding decides what
           follows.
  BODY     counts the declared bytes down (or, chunked, watches for the
           terminal 0-chunk), with the same rolling deadline: a flowing
           slow upload lives, a stalled one dies.

A fired deadline closes the transport: aiohttp sees a disconnect and
reclaims everything. Counted in `read_timeouts` (/health's `ingress`
block, /metrics' imaginary_tpu_ingress_read_timeouts_total).

Off by default: with --read-timeout 0 the guard is never installed.
"""

from __future__ import annotations

import asyncio
import re
import threading

_CL_RE = re.compile(rb"content-length:\s*(\d+)", re.IGNORECASE)
_CHUNKED_RE = re.compile(rb"transfer-encoding:[^\r\n]*chunked", re.IGNORECASE)

_IDLE, _HEADERS, _BODY, _BODY_CHUNKED = 0, 1, 2, 3


class IngressStats:
    """Process-wide guard counters (one serving loop per process)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.read_timeouts = 0
        self.guarded_connections = 0

    def note_timeout(self) -> None:
        with self._lock:
            self.read_timeouts += 1

    def note_connection(self) -> None:
        with self._lock:
            self.guarded_connections += 1

    def to_dict(self) -> dict:
        with self._lock:
            return {"read_timeouts": self.read_timeouts,
                    "guarded_connections": self.guarded_connections}


STATS = IngressStats()


class ReadTimeoutGuard(asyncio.Protocol):
    """Transparent protocol wrapper enforcing the read-inactivity
    deadline around an aiohttp RequestHandler."""

    def __init__(self, inner, timeout_s: float, stats: IngressStats = None):
        self._inner = inner
        self._timeout = timeout_s
        self._stats = stats or STATS
        self._transport = None
        self._timer = None
        self._last_rx = 0.0
        self._state = _IDLE
        self._head = b""  # header bytes so far (bounded; framing only)
        self._body_left = 0
        self._tail = b""  # chunked-terminator scan window

    # -- protocol plumbing (everything delegates) ------------------------

    def connection_made(self, transport):
        self._transport = transport
        self._stats.note_connection()
        self._inner.connection_made(transport)

    def connection_lost(self, exc):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._inner.connection_lost(exc)

    def pause_writing(self):
        self._inner.pause_writing()

    def resume_writing(self):
        self._inner.resume_writing()

    def eof_received(self):
        return self._inner.eof_received()

    # -- the guard -------------------------------------------------------

    def data_received(self, data):
        self._last_rx = asyncio.get_running_loop().time()
        self._feed(data)
        if self._state != _IDLE and self._timer is None:
            self._schedule(self._timeout)
        elif self._state == _IDLE and self._timer is not None:
            self._timer.cancel()
            self._timer = None
        self._inner.data_received(data)

    def _feed(self, data: bytes) -> None:
        """Advance the framing state machine. Best-effort by design: a
        pipelined burst that crosses request boundaries mid-chunk may
        briefly misattribute bytes, which only ever errs toward keeping
        the guard ARMED — never toward killing an idle-but-healthy
        connection mid-processing."""
        while data:
            if self._state == _IDLE:
                self._state = _HEADERS
                self._head = b""
            if self._state == _HEADERS:
                self._head += data
                data = b""
                end = self._head.find(b"\r\n\r\n")
                if end < 0:
                    if len(self._head) > 65536:
                        # header block past any sane size: keep armed,
                        # stop buffering (the deadline will judge it)
                        self._head = self._head[-4:]
                    return
                headers, data = self._head[:end + 4], self._head[end + 4:]
                self._head = b""
                if _CHUNKED_RE.search(headers):
                    self._state = _BODY_CHUNKED
                    self._tail = b""
                else:
                    m = _CL_RE.search(headers)
                    self._body_left = int(m.group(1)) if m else 0
                    self._state = _BODY if self._body_left > 0 else _IDLE
            elif self._state == _BODY:
                take = min(len(data), self._body_left)
                self._body_left -= take
                data = data[take:]
                if self._body_left == 0:
                    self._state = _IDLE
            elif self._state == _BODY_CHUNKED:
                self._tail = (self._tail + data)[-1024:]
                data = b""
                if self._tail.endswith(b"0\r\n\r\n") \
                        or b"\r\n0\r\n\r\n" in self._tail:
                    self._state = _IDLE

    def _schedule(self, delay: float) -> None:
        self._timer = asyncio.get_running_loop().call_later(
            delay, self._check)

    def _check(self) -> None:
        self._timer = None
        if self._state == _IDLE or self._transport is None \
                or self._transport.is_closing():
            return
        now = asyncio.get_running_loop().time()
        remaining = self._last_rx + self._timeout - now
        if remaining > 0:
            self._schedule(remaining)
            return
        # a request is mid-read and no byte has arrived for the whole
        # window: this connection is pinning a slot, not using it
        self._stats.note_timeout()
        self._transport.close()
