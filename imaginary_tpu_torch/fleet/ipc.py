"""Local IPC hop for the fleet data plane (Unix domain sockets); the
port's copy of `imaginary_tpu/fleet/ipc.py`.

SO_REUSEPORT gives the fleet kernel-balanced ingress but no way to
TARGET a specific worker, so digest ownership (fleet/ownership.py)
needs its own hop: each worker listens on a per-index Unix socket next
to the shm file, and non-owners forward a request's source bytes +
resolved parameters to the digest's owner, getting the computed body
back. One request per connection — a UDS connect is microseconds, and
connection-per-forward means a dead owner fails the dial instead of
poisoning a pool.

Wire format, both directions (little-endian):

    u32 header_len | u32 body_len | JSON header | raw body

The hop is strictly best-effort: every client-side fault — dial
refused, frame error, timeout against the request deadline — is the
caller's signal to fall back to LOCAL execution (fail-open), so the
subsystem can never introduce a 5xx class of its own. The server side
refuses work when its process is epoch-fenced (a deposed zombie must
not compute for the fleet) by answering status="fenced".
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import struct
import tempfile
from typing import Awaitable, Callable, Optional, Tuple

_FRAME = struct.Struct("<II")
# a header is a small dict of strings; a body is one source image (the
# ingress layer already enforced the real size ceiling before this hop)
_MAX_HEADER = 1 << 20
_MAX_BODY = 1 << 30


def socket_path(fleet_path: str, idx: int) -> str:
    """Worker idx's forward socket, derived from the shm file path so
    every process that can find the cache can find the sockets. sun_path
    caps at ~104 bytes; long fleet paths fall back to a hashed name in
    the temp dir (same derivation everywhere, so it still rendezvouses)."""
    p = f"{fleet_path}.w{idx}.sock"
    if len(p.encode("utf-8")) > 96:
        h = hashlib.blake2b(fleet_path.encode("utf-8"),
                            digest_size=8).hexdigest()
        p = os.path.join(tempfile.gettempdir(), f"itpu-{h}.w{idx}.sock")
    return p


async def _read_frame(reader: asyncio.StreamReader) -> Tuple[dict, bytes]:
    hlen, blen = _FRAME.unpack(await reader.readexactly(_FRAME.size))
    if hlen > _MAX_HEADER or blen > _MAX_BODY:
        raise ValueError(f"ipc frame too large ({hlen}+{blen} bytes)")
    header = json.loads((await reader.readexactly(hlen)).decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError("ipc header is not an object")
    body = await reader.readexactly(blen) if blen else b""
    return header, body


def _write_frame(writer: asyncio.StreamWriter, header: dict,
                 body: bytes) -> None:
    hb = json.dumps(header, separators=(",", ":")).encode("utf-8")
    writer.write(_FRAME.pack(len(hb), len(body)))
    writer.write(hb)
    if body:
        writer.write(body)


Handler = Callable[[dict, bytes], Awaitable[Tuple[dict, bytes]]]


class ForwardServer:
    """This worker's end of the hop: serve forwarded requests from
    sibling workers. The handler is async and must never raise for a
    request-shaped fault — it answers a status!="ok" header instead
    (the client falls back locally either way, but an orderly answer
    beats making the peer eat a timeout)."""

    def __init__(self, path: str, handler: Handler):
        self.path = path
        self.handler = handler
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        try:
            os.unlink(self.path)  # a stale socket from a dead incarnation
        except OSError:  # itpu: allow[ITPU004] no stale socket to replace
            pass
        self._server = await asyncio.start_unix_server(
            self._serve, path=self.path)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        try:
            os.unlink(self.path)
        except OSError:  # itpu: allow[ITPU004] already gone; nothing leaked
            pass

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            header, body = await _read_frame(reader)
            try:
                resp, rbody = await self.handler(header, body)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # the hop's contract: a computing fault is an answered
                # "error", never a torn connection the client must
                # classify — it forwards the fail-open decision cleanly
                resp, rbody = {"status": "error",
                               "error": type(e).__name__}, b""
            _write_frame(writer, resp, rbody)
            await writer.drain()
        except (asyncio.IncompleteReadError, ValueError, OSError):
            # itpu: allow[ITPU004] torn/garbled frame from a dying peer: drop the
            # connection; the client's timeout or EOF is its fallback signal
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except OSError:  # itpu: allow[ITPU004] peer already gone mid-close
                pass


async def forward_request(path: str, header: dict, body: bytes,
                          timeout_s: float) -> Tuple[dict, bytes]:
    """One forwarded request over the hop. Raises on ANY fault (dial,
    frame, timeout) — the caller maps every exception to the same
    fail-open local fallback, so there is nothing to classify here."""

    async def _roundtrip() -> Tuple[dict, bytes]:
        reader, writer = await asyncio.open_unix_connection(path)
        try:
            _write_frame(writer, header, body)
            await writer.drain()
            return await _read_frame(reader)
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except OSError:  # itpu: allow[ITPU004] server closed first; frame already read
                pass

    return await asyncio.wait_for(_roundtrip(), timeout=max(0.001, timeout_s))
