"""Image sources: where request pixels come from (the port's copy of
`imaginary_tpu/web/sources.py`; ref: source.go, source_http.go,
source_fs.go, source_body.go).

A request is matched against the registered sources in a fixed order
(body, then the mounted directory, then `?url=` with
--enable-url-source) and the first match fetches the bytes.

Remote fetches (`?url=` and the watermark image) run on one aiohttp
client session a source, with per-attempt connect and read timeouts
under the 60 s ceiling, and bounded retries (full-jitter exponential
backoff, floored by the origin's Retry-After) on connect errors,
timeouts, 5xx and 429, never on another 4xx. An origin timeout answers
504, an origin's non-200 answers 502 with its status in the message,
and any other fetch failure 502. With --max-allowed-size an advisory
HEAD pre-check refuses a declared oversize body with 413, and the GET's
streaming cap refuses one that lied. The origin allow-list applies to
the watermark image too. With a request deadline (`deadline.py`) each
attempt notes the `fetch` stage and answers 504 once the budget is
spent, its timeouts are clipped to what is left, and a backoff the
budget cannot absorb answers the origin's failure at once. With
--cache-source-ttl a fetched body is kept for the TTL (`cache.py`'s
source tier), keyed by the URL, the size limit and the headers the
origin sees, taken before the trace headers go in (a per-request
X-Request-ID in the key would make every fetch a miss); a failing tier
reads as a miss.
"""

from __future__ import annotations

import asyncio
import os
import random
import urllib.parse
from typing import Optional

import aiohttp
from aiohttp import web

from imaginary_tpu_torch import Version, codecs, failpoints
from imaginary_tpu_torch import deadline as deadline_mod
from imaginary_tpu_torch.errors import (
    ErrEntityTooLarge,
    ErrInvalidFilePath,
    ErrInvalidImageURL,
    ErrMissingParamFile,
    ImageError,
    new_error,
)
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.web.config import ServerOptions

MAX_BODY_SIZE = 1 << 26  # 64 MB (ref: source_body.go:13)
GATE_PREFIX = 1 << 16  # header bytes streamed before the early dimension gate runs
FORM_FIELD = "file"  # ref: source_body.go:12
HTTP_TIMEOUT = 60  # seconds: the per-attempt ceiling (ref: source_http.go:16)
WATERMARK_MAX_BYTES = 1_000_000  # ref: image.go:352
RETRY_BACKOFF_BASE_S = 0.1  # attempt n sleeps up to base * 2**n
RETRY_BACKOFF_CAP_S = 2.0  # and never more than this
RETRY_AFTER_CAP_S = 10.0  # a longer Retry-After is not waited for


async def _stream_body(next_chunk) -> bytearray:
    """Read a body into one growable buffer, refusing it with 413 as soon
    as it passes MAX_BODY_SIZE (also for a request that lied about, or
    omitted, its Content-Length). Once the header prefix (GATE_PREFIX
    bytes) has landed, the codec's dimension gate runs on it: armed by
    the memory-pressure governor, an over-cap image is refused 413 with
    the rest of its body unread."""
    data = bytearray()
    gated = False
    while True:
        try:
            chunk = await next_chunk()
        except StopAsyncIteration:
            break
        if not chunk:
            break
        data.extend(chunk)
        if len(data) > MAX_BODY_SIZE:
            raise ErrEntityTooLarge
        if not gated and len(data) >= GATE_PREFIX:
            # shorter bodies skip this: the decode-time gate covers them
            codecs.bomb_gate_prefix(memoryview(data)[:GATE_PREFIX])
            gated = True
    return data


class BodyImageSource:
    """POST/PUT payloads: multipart `file` field or raw body
    (ref: source_body.go:30-100). `?field=` selects another multipart
    field name, as the reference's README documents."""

    name = "payload"

    def matches(self, request: web.Request) -> bool:
        return request.method in ("POST", "PUT")

    async def get_image(self, request: web.Request) -> bytes:
        ctype = request.headers.get("Content-Type", "")
        if ctype.startswith("multipart/"):
            return await self._read_form(request)
        return await self._read_raw(request)

    async def _read_form(self, request: web.Request) -> bytes:
        field = request.query.get("field", FORM_FIELD) or FORM_FIELD
        reader = await request.multipart()
        async for part in reader:
            if part.name == field:
                # reject on the part's own declared length before reading
                declared = part.headers.get("Content-Length", "")
                if declared.isdigit() and int(declared) > MAX_BODY_SIZE:
                    raise ErrEntityTooLarge
                return await _stream_body(lambda: part.read_chunk(1 << 16))
        raise ErrMissingParamFile

    async def _read_raw(self, request: web.Request) -> bytes:
        # a declared oversize body is refused with none of it read
        length = request.content_length
        if length is not None and length > MAX_BODY_SIZE:
            raise ErrEntityTooLarge
        it = request.content.iter_chunked(1 << 16)
        return await _stream_body(it.__anext__)


class FileSystemImageSource:
    """GET ?file= under the -mount directory with traversal protection
    (ref: source_fs.go:28-91). The read runs in a thread: a slow disk
    stalls this request, not the event loop."""

    name = "fs"

    def __init__(self, mount: str):
        self.mount = os.path.abspath(mount)

    def matches(self, request: web.Request) -> bool:
        return request.method == "GET" and bool(request.query.get("file"))

    async def get_image(self, request: web.Request) -> bytes:
        name = urllib.parse.unquote(request.query.get("file", ""))
        path = os.path.normpath(os.path.join(self.mount, name.lstrip("/")))
        if not (path == self.mount or path.startswith(self.mount + os.sep)):
            raise ErrInvalidFilePath

        def _read() -> bytes:
            with open(path, "rb") as f:
                return f.read()

        try:
            return await asyncio.to_thread(_read)
        except (FileNotFoundError, IsADirectoryError):
            raise ErrInvalidFilePath from None


class _OriginStatus(Exception):
    """The origin answered a non-200: its status and Retry-After, for the
    retry loop to classify."""

    def __init__(self, status: int, retry_after_s: float = 0.0):
        super().__init__(f"origin status {status}")
        self.status = status
        self.retry_after_s = retry_after_s


def _parse_retry_after(value: str) -> float:
    """Retry-After in delta-seconds (the HTTP-date form counts as 0)."""
    try:
        return max(0.0, float(value.strip()))
    except (ValueError, AttributeError):
        return 0.0


def _is_retryable_exc(e: BaseException) -> bool:
    """Connect-class errors and timeouts: the GET never reached, or never
    finished reaching, an origin that served it, so a retry is safe."""
    return isinstance(e, (
        asyncio.TimeoutError,
        aiohttp.ClientConnectionError,
        aiohttp.ClientPayloadError,
        failpoints.FailpointError,
        ConnectionError,
    ))


def _map_fetch_error(e: BaseException, url: str) -> ImageError:
    """The status of a fetch that failed for good: 504 for a timeout, 502
    for an origin's non-200 (its status in the message only) and for any
    other failure."""
    if isinstance(e, asyncio.TimeoutError):
        return new_error(
            f"origin timed out fetching remote http image: (url={url})", 504)
    if isinstance(e, _OriginStatus):
        return new_error(
            f"error fetching remote http image: origin answered "
            f"status={e.status} (url={url})", 502)
    return new_error(
        f"error fetching remote http image: {str(e) or type(e).__name__} "
        f"(url={url})", 502)


class HTTPImageSource:
    """GET ?url= remote fetch with the origin allow-list, the HEAD size
    pre-check and auth and header forwarding (ref: source_http.go:24-160).
    `close()` closes its client session."""

    name = "http"

    def __init__(self, o: ServerOptions, caches=None):
        self.options = o
        self._caches = caches
        self._session: Optional[aiohttp.ClientSession] = None

    def matches(self, request: web.Request) -> bool:
        return request.method == "GET" and bool(request.query.get("url"))

    def session(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=HTTP_TIMEOUT),
                auto_decompress=False,
                connector=aiohttp.TCPConnector(limit=100, limit_per_host=10),
            )
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    async def get_image(self, request: web.Request) -> bytes:
        raw = request.query.get("url", "")
        u = urllib.parse.urlparse(raw)
        if not u.scheme or not u.netloc:
            raise ErrInvalidImageURL
        if should_restrict_origin(u, self.options.allowed_origins):
            raise new_error(f"not allowed remote URL origin: {u.netloc}{u.path}", 400)
        return await self.fetch(raw, request)

    def _attempt_timeout(self) -> aiohttp.ClientTimeout:
        """One attempt's budget: connect and total, under HTTP_TIMEOUT,
        both clipped to the request deadline's remaining budget, so an
        attempt never outlives the request that wants its bytes."""
        o = self.options
        total = min(float(HTTP_TIMEOUT), max(o.source_read_timeout_s, 0.001))
        connect = max(min(o.source_connect_timeout_s, total), 0.001)
        dl = deadline_mod.current()
        if dl is not None:
            rem = max(dl.remaining_s(), 0.001)
            total = min(total, rem)
            connect = min(connect, rem)
        return aiohttp.ClientTimeout(total=total, sock_connect=connect)

    async def _fetch_once(self, sess, url: str, headers: dict, max_size: int) -> bytes:
        """One GET attempt: raises _OriginStatus on a non-200 and lets
        network and timeout errors through for the retry loop."""
        await failpoints.ahit("source.fetch")
        async with sess.get(url, headers=headers, timeout=self._attempt_timeout()) as res:
            if res.status != 200:
                raise _OriginStatus(
                    res.status, _parse_retry_after(res.headers.get("Retry-After", "")))
            data = bytearray()
            async for chunk in res.content.iter_chunked(1 << 16):
                data.extend(chunk)
                if max_size and len(data) > max_size:
                    # the reference's LimitReader would cut the body and
                    # hand on corrupt bytes; refusing is the honest answer
                    raise ErrEntityTooLarge
            return bytes(data)

    async def fetch(self, url: str, request: Optional[web.Request],
                    limit: Optional[int] = None) -> bytes:
        """The body at `url`, capped at `limit` bytes (the watermark's) or
        --max-allowed-size, with the request's forwarded headers."""
        sess = self.session()
        headers = self._build_headers(request)
        # the TTL'd source cache: keyed by the URL and the exact headers
        # the origin would see (with auth forwarding two users may get
        # different bytes for one URL); a failing tier reads as a miss
        ckey = None
        caches = self._caches
        if caches is not None and caches.source.enabled:
            ckey = (url, limit, tuple(sorted(headers.items())))
            try:
                hit = caches.source.get(ckey)
            except Exception:  # noqa: BLE001 - the cache.get contract
                hit = None
            if hit is not None:
                caches.stats.source_hits += 1
                return hit
            caches.stats.source_misses += 1
        # trace propagation, injected after the cache key is taken
        tr = obs_trace.current()
        if tr is not None and tr.enabled:
            headers = dict(headers)
            headers["traceparent"] = tr.outbound_traceparent()
            headers["X-Request-ID"] = tr.request_id
        max_size = limit or self.options.max_allowed_size
        if self.options.max_allowed_size > 0 and limit is None:
            await self._check_size(sess, url, headers)
        retries = max(0, self.options.source_retries)
        dl = deadline_mod.current()
        attempt = 0
        while True:
            if dl is not None and dl.note("fetch") <= 0.0:
                raise dl.error("fetch")
            try:
                body = await self._fetch_once(sess, url, headers, max_size)
            except ImageError:
                raise  # the 413 cap: policy, never retried
            except (Exception, asyncio.TimeoutError) as e:
                retry_after = 0.0
                if isinstance(e, _OriginStatus):
                    # only 5xx and 429 may heal; another 4xx is the
                    # origin's considered refusal
                    if not (e.status >= 500 or e.status == 429):
                        raise _map_fetch_error(e, url) from None
                    retry_after = min(e.retry_after_s, RETRY_AFTER_CAP_S)
                elif not _is_retryable_exc(e):
                    raise _map_fetch_error(e, url) from None
                if attempt >= retries:
                    raise _map_fetch_error(e, url) from None
                # full jitter, floored by the origin's Retry-After
                delay = max(retry_after, random.uniform(
                    0.0, min(RETRY_BACKOFF_BASE_S * (2 ** attempt), RETRY_BACKOFF_CAP_S)))
                if dl is not None and delay >= dl.remaining_s():
                    # the budget cannot absorb the wait: the origin's
                    # failure answers now
                    raise _map_fetch_error(e, url) from None
                attempt += 1
                await asyncio.sleep(delay)
                continue
            if ckey is not None:
                caches.source.put(ckey, body, len(body))
            return body

    async def _check_size(self, sess, url: str, headers: dict) -> None:
        """HEAD pre-check (ref: source_http.go:105-124, 200-206 accepted).
        Advisory: an odd status, a network fault or a timeout leaves the
        decision to the capped GET; only a well-formed Content-Length
        over the cap answers 413."""
        try:
            await failpoints.ahit("source.head")
            async with sess.head(url, headers=headers,
                                 timeout=self._attempt_timeout()) as res:
                if res.status < 200 or res.status > 206:
                    return
                length = res.headers.get("Content-Length")
                if length and int(length) > self.options.max_allowed_size:
                    raise new_error(
                        f"content length {length} exceeds maximum allowed "
                        f"{self.options.max_allowed_size} bytes", 413)
        except ImageError:
            raise
        except Exception:
            return

    def _build_headers(self, request: Optional[web.Request]) -> dict:
        headers = {"User-Agent": f"imaginary-tpu-torch/{Version}"}
        o = self.options
        if request is not None:
            # fixed --authorization > X-Forward-Authorization >
            # Authorization (ref: source_http.go:142-151)
            if o.authorization:
                headers["Authorization"] = o.authorization
            elif o.auth_forwarding:
                fwd = (request.headers.get("X-Forward-Authorization")
                       or request.headers.get("Authorization"))
                if fwd:
                    headers["Authorization"] = fwd
            for h in o.forward_headers:
                v = request.headers.get(h)
                if v:
                    headers[h] = v
        elif o.authorization:
            headers["Authorization"] = o.authorization
        return headers


def should_restrict_origin(u, origins: tuple) -> bool:
    """Whether the parsed URL `u` lies outside the allow-list of
    `parse_origins` pairs, with `*.host` wildcards and path prefixes
    (ref: source_http.go:57-78). An empty list restricts nothing."""
    if not origins:
        return False
    host, path = u.netloc, u.path or ""
    for origin_host, origin_path in origins:
        if origin_host == host and path.startswith(origin_path):
            return False
        if origin_host.startswith("*."):
            if ((host == origin_host[2:] or host.endswith(origin_host[1:]))
                    and path.startswith(origin_path)):
                return False
    return True


class SourceRegistry:
    """Deterministic-order source matching (ref: source.go:33-99). The
    HTTP source also fetches watermark images, but is matched against
    requests only with --enable-url-source (the reference registers it
    for matching on its first watermark fetch, after which a server
    without the flag serves ?url=)."""

    def __init__(self, o: ServerOptions, caches=None):
        self.options = o
        self.http = HTTPImageSource(o, caches=caches)
        self.sources: list = [BodyImageSource()]
        if o.mount:
            self.sources.append(FileSystemImageSource(o.mount))
        if o.enable_url_source:
            self.sources.append(self.http)

    def match(self, request: web.Request):
        for source in self.sources:
            if source.matches(request):
                return source
        return None

    async def get_image(self, request: web.Request) -> bytes:
        source = self.match(request)
        if source is None:
            raise new_error("missing image source", 400)
        return await source.get_image(request)

    async def fetch_watermark(self, url: str) -> bytes:
        """The watermark image's bytes (ref: image.go:343-357): capped at
        WATERMARK_MAX_BYTES and held to the origin allow-list, which the
        reference's bare http.Get skips."""
        u = urllib.parse.urlparse(url)
        if (not u.scheme or not u.netloc
                or should_restrict_origin(u, self.options.allowed_origins)):
            raise new_error(f"Unable to retrieve watermark image: {url}", 400)
        return await self.http.fetch(url, None, limit=WATERMARK_MAX_BYTES)

    async def close(self) -> None:
        await self.http.close()
