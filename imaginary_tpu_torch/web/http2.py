"""HTTP/2 termination over libnghttp2 (the port's copy of
`imaginary_tpu/web/http2.py`; ref: server.go:114-131).

The reference advertises `h2` because Go's net/http ships an HTTP/2
server. aiohttp has none, and no Python h2 package is at hand, but
libnghttp2 (the C library nginx and curl use) usually is: this module
binds it with ctypes and terminates HTTP/2 as an asyncio protocol.

The nginx-upstream pattern: the public TLS port negotiates ALPN; `h2`
connections land on `H2Protocol`, which decodes streams with nghttp2 and
forwards each request over an internal HTTP/1.1 hop to the same
process's listener on a mode-0700 Unix domain socket, so the middleware,
the handlers and the access log run once, the same for both protocols,
and the plaintext hop is reachable by this uid only. `http/1.1`
connections go to aiohttp's own protocol untouched (AlpnDispatcher).
Without the library (`load_nghttp2` returns None) the server offers
`http/1.1` only, as the reference does.

Request and response bodies are buffered per stream; the service's own
64 MB body cap (source_body.go:13) bounds one, and a per-connection
budget bounds them all. Flow-control WINDOW_UPDATEs are left to
nghttp2's automatic mode. While the server drains (`set_draining`), new
streams get a 503 with Retry-After, as new HTTP/1.1 requests do.
"""

from __future__ import annotations

import asyncio
import ctypes
import ctypes.util
import os
import sys
from typing import Optional

_DEBUG = os.environ.get("IMAGINARY_TPU_H2_DEBUG", "") == "1"


def _dbg(msg: str) -> None:
    if _DEBUG:
        print(f"[h2] {msg}", file=sys.stderr, flush=True)

# -- nghttp2 constants ---------------------------------------------------------

NGHTTP2_DATA = 0x00
NGHTTP2_HEADERS = 0x01
NGHTTP2_FLAG_END_STREAM = 0x01
NGHTTP2_ERR_CALLBACK_FAILURE = -902
NGHTTP2_DATA_FLAG_EOF = 0x01
NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS = 0x03
NGHTTP2_INTERNAL_ERROR = 0x02

# The drain flag, set by serve() when the stop signal lands: live
# connections can still open streams, and those get a fast 503 with
# Retry-After (as the trace middleware answers HTTP/1.1 during the drain)
# instead of racing the hop's teardown into a bare 502.
_DRAINING = False


def set_draining(value: bool) -> None:
    global _DRAINING
    _DRAINING = bool(value)


# connection-specific headers that must not cross into HTTP/2
# (RFC 9113 section 8.2.2)
_HOP_HEADERS = {
    "connection", "keep-alive", "proxy-connection", "transfer-encoding",
    "upgrade", "te", "host",
}


class _FrameHd(ctypes.Structure):
    _fields_ = [
        ("length", ctypes.c_size_t),
        ("stream_id", ctypes.c_int32),
        ("type", ctypes.c_uint8),
        ("flags", ctypes.c_uint8),
        ("reserved", ctypes.c_uint8),
    ]


class _NV(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.POINTER(ctypes.c_uint8)),
        ("value", ctypes.POINTER(ctypes.c_uint8)),
        ("namelen", ctypes.c_size_t),
        ("valuelen", ctypes.c_size_t),
        ("flags", ctypes.c_uint8),
    ]


class _SettingsEntry(ctypes.Structure):
    _fields_ = [("settings_id", ctypes.c_int32), ("value", ctypes.c_uint32)]


class _DataSource(ctypes.Union):
    _fields_ = [("fd", ctypes.c_int), ("ptr", ctypes.c_void_p)]


_READ_CB = ctypes.CFUNCTYPE(
    ctypes.c_ssize_t,
    ctypes.c_void_p,                    # session
    ctypes.c_int32,                     # stream_id
    ctypes.POINTER(ctypes.c_uint8),     # buf
    ctypes.c_size_t,                    # length
    ctypes.POINTER(ctypes.c_uint32),    # data_flags
    ctypes.POINTER(_DataSource),        # source
    ctypes.c_void_p,                    # user_data
)


class _DataProvider(ctypes.Structure):
    _fields_ = [("source", _DataSource), ("read_callback", _READ_CB)]


_ON_FRAME_RECV_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(_FrameHd), ctypes.c_void_p
)
_ON_HEADER_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(_FrameHd),
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ctypes.c_uint8, ctypes.c_void_p,
)
_ON_BEGIN_HEADERS_CB = _ON_FRAME_RECV_CB
_ON_DATA_CHUNK_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_uint8, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_void_p,
)
_ON_STREAM_CLOSE_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int32, ctypes.c_uint32, ctypes.c_void_p
)


_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def load_nghttp2() -> Optional[ctypes.CDLL]:
    """dlopen libnghttp2 and declare the handful of entry points used.
    Returns None (cached) when the library is absent — the server then
    stays HTTP/1.1-only, exactly the pre-h2 behavior."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    for name in ("libnghttp2.so.14", "libnghttp2.so",
                 ctypes.util.find_library("nghttp2") or ""):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        return None
    lib.nghttp2_session_callbacks_new.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.nghttp2_session_callbacks_new.restype = ctypes.c_int
    lib.nghttp2_session_callbacks_del.argtypes = [ctypes.c_void_p]
    lib.nghttp2_session_callbacks_del.restype = None
    for setter, cbt in (
        ("nghttp2_session_callbacks_set_on_frame_recv_callback", _ON_FRAME_RECV_CB),
        ("nghttp2_session_callbacks_set_on_header_callback", _ON_HEADER_CB),
        ("nghttp2_session_callbacks_set_on_begin_headers_callback", _ON_BEGIN_HEADERS_CB),
        ("nghttp2_session_callbacks_set_on_data_chunk_recv_callback", _ON_DATA_CHUNK_CB),
        ("nghttp2_session_callbacks_set_on_stream_close_callback", _ON_STREAM_CLOSE_CB),
    ):
        fn = getattr(lib, setter)
        fn.argtypes = [ctypes.c_void_p, cbt]
        fn.restype = None
    lib.nghttp2_session_server_new.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p
    ]
    lib.nghttp2_session_server_new.restype = ctypes.c_int
    lib.nghttp2_session_del.argtypes = [ctypes.c_void_p]
    lib.nghttp2_session_del.restype = None
    lib.nghttp2_submit_settings.argtypes = [
        ctypes.c_void_p, ctypes.c_uint8, ctypes.POINTER(_SettingsEntry), ctypes.c_size_t
    ]
    lib.nghttp2_submit_settings.restype = ctypes.c_int
    lib.nghttp2_session_mem_recv.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t
    ]
    lib.nghttp2_session_mem_recv.restype = ctypes.c_ssize_t
    lib.nghttp2_session_mem_send.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    ]
    lib.nghttp2_session_mem_send.restype = ctypes.c_ssize_t
    lib.nghttp2_submit_response.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(_NV), ctypes.c_size_t,
        ctypes.POINTER(_DataProvider)
    ]
    lib.nghttp2_submit_response.restype = ctypes.c_int
    lib.nghttp2_submit_rst_stream.argtypes = [
        ctypes.c_void_p, ctypes.c_uint8, ctypes.c_int32, ctypes.c_uint32
    ]
    lib.nghttp2_submit_rst_stream.restype = ctypes.c_int
    lib.nghttp2_session_want_read.argtypes = [ctypes.c_void_p]
    lib.nghttp2_session_want_read.restype = ctypes.c_int
    lib.nghttp2_session_want_write.argtypes = [ctypes.c_void_p]
    lib.nghttp2_session_want_write.restype = ctypes.c_int
    _LIB = lib
    return _LIB


class _Stream:
    __slots__ = ("headers", "body", "resp_body", "resp_off", "task", "read_cb")

    def __init__(self):
        self.headers: list = []  # (name, value) in arrival order
        self.body = bytearray()
        self.resp_body = b""
        self.resp_off = 0
        self.task: Optional[asyncio.Task] = None
        self.read_cb = None  # CFUNCTYPE ref: must outlive the stream's DATA frames


class H2Protocol(asyncio.Protocol):
    """One HTTP/2 connection: nghttp2 server session + loopback forward."""

    # Per-connection stream cap and AGGREGATE buffered-body budget. The
    # app's own 64 MB cap bounds one body; without an aggregate budget,
    # 128 streams x 64 MB on a single connection could pin ~8 GB before
    # anything reached the app — an amplification h1 (one in-flight body
    # per connection) does not have.
    MAX_STREAMS = 32
    MAX_CONN_BUFFER = 2 << 26  # 128 MB of request bodies per connection

    def __init__(self, client: "object", max_body: int = 1 << 26,
                 hop_token: str = "", conns: Optional[set] = None):
        self._client = client  # shared aiohttp.ClientSession
        self._max_body = max_body
        self._hop_token = hop_token
        self._conns = conns  # serve()'s live-connection registry, for drain
        self._buffered = 0  # aggregate request-body bytes across streams
        self._transport: Optional[asyncio.Transport] = None
        self._session = ctypes.c_void_p()
        self._callbacks = ctypes.c_void_p()
        self._streams: dict = {}
        self._peer = "-"
        self._closed = False
        # CFUNCTYPE objects must outlive the session: bind them to self
        self._cb_refs = []

    # -- asyncio protocol ------------------------------------------------------

    def connection_made(self, transport):
        self._transport = transport
        if self._conns is not None:
            self._conns.add(self)
        peer = transport.get_extra_info("peername")
        if peer:
            self._peer = peer[0]
        lib = load_nghttp2()
        lib.nghttp2_session_callbacks_new(ctypes.byref(self._callbacks))

        on_begin = _ON_BEGIN_HEADERS_CB(self._on_begin_headers)
        on_header = _ON_HEADER_CB(self._on_header)
        on_frame = _ON_FRAME_RECV_CB(self._on_frame_recv)
        on_chunk = _ON_DATA_CHUNK_CB(self._on_data_chunk)
        on_close = _ON_STREAM_CLOSE_CB(self._on_stream_close)
        self._cb_refs = [on_begin, on_header, on_frame, on_chunk, on_close]
        lib.nghttp2_session_callbacks_set_on_begin_headers_callback(self._callbacks, on_begin)
        lib.nghttp2_session_callbacks_set_on_header_callback(self._callbacks, on_header)
        lib.nghttp2_session_callbacks_set_on_frame_recv_callback(self._callbacks, on_frame)
        lib.nghttp2_session_callbacks_set_on_data_chunk_recv_callback(self._callbacks, on_chunk)
        lib.nghttp2_session_callbacks_set_on_stream_close_callback(self._callbacks, on_close)
        lib.nghttp2_session_server_new(ctypes.byref(self._session), self._callbacks, None)
        iv = (_SettingsEntry * 1)(
            _SettingsEntry(NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS, self.MAX_STREAMS)
        )
        lib.nghttp2_submit_settings(self._session, 0, iv, 1)
        self._pump()

    def data_received(self, data: bytes):
        if self._closed:
            return
        lib = load_nghttp2()
        n = lib.nghttp2_session_mem_recv(self._session, data, len(data))
        if n < 0:
            self._abort()
            return
        self._pump()

    def eof_received(self):
        return False  # close when the peer half-closes

    def connection_lost(self, exc):
        self._closed = True
        if self._conns is not None:
            self._conns.discard(self)
        for st in self._streams.values():
            if st.task is not None:
                st.task.cancel()
        self._streams.clear()
        lib = load_nghttp2()
        if lib is not None and self._session:
            lib.nghttp2_session_del(self._session)
            self._session = ctypes.c_void_p()
        if self._callbacks:
            lib.nghttp2_session_callbacks_del(self._callbacks)
            self._callbacks = ctypes.c_void_p()
        self._cb_refs = []

    # -- nghttp2 callbacks (all run on the event-loop thread, inside
    #    mem_recv; exceptions must not cross the C boundary) ------------------

    def _on_begin_headers(self, _s, frame_p, _ud):
        try:
            hd = frame_p.contents
            _dbg(f"begin_headers sid={hd.stream_id} type={hd.type}")
            if hd.type == NGHTTP2_HEADERS:
                self._streams[hd.stream_id] = _Stream()
            return 0
        except Exception:
            return NGHTTP2_ERR_CALLBACK_FAILURE

    def _on_header(self, _s, frame_p, name_p, namelen, value_p, valuelen, _f, _ud):
        try:
            st = self._streams.get(frame_p.contents.stream_id)
            if st is None:
                return 0
            name = ctypes.string_at(name_p, namelen).decode("latin-1")
            value = ctypes.string_at(value_p, valuelen).decode("latin-1")
            st.headers.append((name, value))
            return 0
        except Exception:
            return NGHTTP2_ERR_CALLBACK_FAILURE

    def _on_data_chunk(self, _s, _flags, stream_id, data_p, length, _ud):
        try:
            st = self._streams.get(stream_id)
            if st is not None:
                if (
                    len(st.body) + length > self._max_body
                    or self._buffered + length > self.MAX_CONN_BUFFER
                ):
                    # per-stream cap (the app's own 64 MB limit) or the
                    # per-connection aggregate budget: refuse the stream
                    lib = load_nghttp2()
                    lib.nghttp2_submit_rst_stream(
                        self._session, 0, stream_id, NGHTTP2_INTERNAL_ERROR
                    )
                    self._drop_stream(stream_id)
                else:
                    st.body += ctypes.string_at(data_p, length)
                    self._buffered += length
                    _dbg(f"data sid={stream_id} +{length} total={len(st.body)}")
            return 0
        except Exception:
            return NGHTTP2_ERR_CALLBACK_FAILURE

    def _on_frame_recv(self, _s, frame_p, _ud):
        try:
            hd = frame_p.contents
            _dbg(f"frame_recv sid={hd.stream_id} type={hd.type} flags={hd.flags:#x}")
            if (
                hd.type in (NGHTTP2_HEADERS, NGHTTP2_DATA)
                and hd.flags & NGHTTP2_FLAG_END_STREAM
            ):
                st = self._streams.get(hd.stream_id)
                if st is not None and st.task is None:
                    st.task = asyncio.get_running_loop().create_task(
                        self._handle(hd.stream_id, st)
                    )
            return 0
        except Exception:
            return NGHTTP2_ERR_CALLBACK_FAILURE

    def _drop_stream(self, stream_id: int):
        st = self._streams.pop(stream_id, None)
        if st is not None:
            self._buffered -= len(st.body)
            if st.task is not None and not st.task.done():
                st.task.cancel()

    def _on_stream_close(self, _s, stream_id, _err, _ud):
        try:
            self._drop_stream(stream_id)
            return 0
        except Exception:
            return NGHTTP2_ERR_CALLBACK_FAILURE

    def has_inflight(self) -> bool:
        """True while any stream's handler task is still running — the
        graceful-drain signal serve() polls at shutdown."""
        return any(
            st.task is not None and not st.task.done()
            for st in self._streams.values()
        )

    # -- request forwarding ----------------------------------------------------

    async def _handle(self, stream_id: int, st: _Stream):
        # Request identity is assigned at the EDGE: when the client sent
        # no X-Request-ID, the terminator mints one and forwards it, so
        # the app echoes the same id the terminator will attach to a
        # hop-failure 502 — every h2 response carries the id either way.
        from imaginary_tpu_torch.obs.trace import new_request_id, sanitize_request_id

        rid = sanitize_request_id(next(
            (v for n, v in st.headers if n.lower() == "x-request-id"), ""
        )) or new_request_id()
        try:
            _dbg(f"dispatch sid={stream_id} body={len(st.body)}")
            if _DRAINING:
                self._submit_response(
                    stream_id, st,
                    [(":status", "503"), ("x-request-id", rid),
                     ("retry-after", "2"), ("content-length", "0")], b"",
                )
                return
            pseudo = {n: v for n, v in st.headers if n.startswith(":")}
            method = pseudo.get(":method", "GET")
            path = pseudo.get(":path", "/")
            authority = pseudo.get(":authority", "")
            headers = []
            cookies = []
            for n, v in st.headers:
                ln = n.lower()
                if ln.startswith(":") or ln in _HOP_HEADERS:
                    continue
                # client-supplied forwarding/hop-identity headers must not
                # reach the trusted loopback hop — they would be read as
                # OUR attestation of the client's identity
                if ln.startswith("x-forwarded-") or ln == "x-internal-hop":
                    continue
                if ln == "cookie":
                    cookies.append(v)
                    continue
                headers.append((n, v))
            if cookies:  # h2 splits cookies into separate fields (RFC 9113 8.2.3)
                headers.append(("Cookie", "; ".join(cookies)))
            if authority:
                headers.append(("Host", authority))
            # client-sent ids were forwarded above only if sane; replace
            # with the sanitized/minted one the 502 path also uses
            headers = [(n, v) for n, v in headers
                       if n.lower() != "x-request-id"]
            headers.append(("X-Request-ID", rid))
            headers.append(("X-Forwarded-For", self._peer))
            headers.append(("X-Forwarded-Proto", "https"))
            headers.append(("X-Forwarded-HTTP-Version", "2.0"))
            if self._hop_token:
                headers.append(("X-Internal-Hop", self._hop_token))
            from multidict import CIMultiDict

            # the client's UnixConnector ignores the URL authority; "h2-hop"
            # only labels the hop in tracebacks (real Host rides the header)
            url = f"http://h2-hop{path}"
            async with self._client.request(
                method, url, headers=CIMultiDict(headers),
                data=bytes(st.body) if st.body else None,
                allow_redirects=False,
            ) as resp:
                body = await resp.read()
                out_headers = [(":status", str(resp.status))]
                for n, v in resp.headers.items():
                    if n.lower() in _HOP_HEADERS or n.lower() == "content-length":
                        continue
                    out_headers.append((n.lower(), v))
                out_headers.append(("content-length", str(len(body))))
            self._submit_response(stream_id, st, out_headers, body)
        except asyncio.CancelledError:
            raise
        except Exception:
            # loopback hop failed: the stream gets a bare 502 (which
            # still carries the request id, for log correlation)
            try:
                self._submit_response(
                    stream_id, st,
                    [(":status", "502"), ("x-request-id", rid),
                     ("content-length", "0")], b"",
                )
            except Exception:
                self._abort()

    def _submit_response(self, stream_id: int, st: _Stream, headers: list, body: bytes):
        if self._closed or stream_id not in self._streams:
            return
        lib = load_nghttp2()
        st.resp_body = body
        st.resp_off = 0

        def read_cb(_s, sid, buf, length, data_flags, _src, _ud):
            try:
                stream = self._streams.get(sid)
                if stream is None:
                    data_flags[0] |= NGHTTP2_DATA_FLAG_EOF
                    return 0
                chunk = stream.resp_body[stream.resp_off: stream.resp_off + length]
                ctypes.memmove(buf, chunk, len(chunk))
                stream.resp_off += len(chunk)
                if stream.resp_off >= len(stream.resp_body):
                    data_flags[0] |= NGHTTP2_DATA_FLAG_EOF
                return len(chunk)
            except Exception:
                return NGHTTP2_ERR_CALLBACK_FAILURE

        st.read_cb = cb = _READ_CB(read_cb)  # freed with the stream, not the conn
        prd = _DataProvider()
        prd.source.ptr = None
        prd.read_callback = cb

        # nghttp2_submit_response copies names/values (flags=0), so these
        # buffers only need to live through the call itself
        enc = [(n.encode("latin-1"), v.encode("latin-1")) for n, v in headers]
        nva = (_NV * len(enc))()
        bufs = []
        for i, (n, v) in enumerate(enc):
            nb = ctypes.create_string_buffer(n, len(n))
            vb = ctypes.create_string_buffer(v, len(v))
            bufs.append((nb, vb))
            nva[i].name = ctypes.cast(nb, ctypes.POINTER(ctypes.c_uint8))
            nva[i].value = ctypes.cast(vb, ctypes.POINTER(ctypes.c_uint8))
            nva[i].namelen = len(n)
            nva[i].valuelen = len(v)
            nva[i].flags = 0
        rv = lib.nghttp2_submit_response(self._session, stream_id, nva, len(enc),
                                         ctypes.byref(prd))
        if rv != 0:
            self._abort()
            return
        self._pump()

    # -- plumbing --------------------------------------------------------------

    def _pump(self):
        """Drain nghttp2's send queue into the transport."""
        if self._closed or self._transport is None:
            return
        lib = load_nghttp2()
        while True:
            data_p = ctypes.POINTER(ctypes.c_uint8)()
            n = lib.nghttp2_session_mem_send(self._session, ctypes.byref(data_p))
            if n <= 0:
                if n < 0:
                    self._abort()
                break
            self._transport.write(ctypes.string_at(data_p, n))
        if (
            not lib.nghttp2_session_want_read(self._session)
            and not lib.nghttp2_session_want_write(self._session)
        ):
            self._abort()

    def _abort(self):
        if not self._closed and self._transport is not None:
            self._closed = True
            self._transport.close()


class AlpnDispatcher(asyncio.Protocol):
    """Routes a freshly-handshaken TLS connection to the protocol its ALPN
    selection asks for: `h2` -> H2Protocol, anything else -> aiohttp's own
    HTTP/1.1 RequestHandler. asyncio completes the TLS handshake before
    connection_made fires, so the choice is known immediately."""

    def __init__(self, h1_factory, h2_factory):
        self._h1_factory = h1_factory
        self._h2_factory = h2_factory
        self._inner: Optional[asyncio.Protocol] = None

    def connection_made(self, transport):
        ssl_obj = transport.get_extra_info("ssl_object")
        alpn = ssl_obj.selected_alpn_protocol() if ssl_obj else None
        self._inner = self._h2_factory() if alpn == "h2" else self._h1_factory()
        self._inner.connection_made(transport)

    def data_received(self, data):
        self._inner.data_received(data)

    def eof_received(self):
        return self._inner.eof_received()

    def connection_lost(self, exc):
        if self._inner is not None:
            self._inner.connection_lost(exc)

    def pause_writing(self):
        if self._inner is not None:
            self._inner.pause_writing()

    def resume_writing(self):
        if self._inner is not None:
            self._inner.resume_writing()
