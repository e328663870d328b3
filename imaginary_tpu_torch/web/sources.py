"""Image sources: where request pixels come from (the port's copy of the
body and file sources of `imaginary_tpu/web/sources.py`; ref: source.go,
source_fs.go, source_body.go).

A request is matched against the registered sources in a fixed order
(body, then the mounted directory) and the first match fetches the
bytes. URL sources (`?url=`, `--enable-url-source`) are a later slice.
"""

from __future__ import annotations

import asyncio
import os
import urllib.parse

from aiohttp import web

from imaginary_tpu_torch.errors import (
    ErrEntityTooLarge,
    ErrInvalidFilePath,
    ErrMissingParamFile,
    new_error,
)

MAX_BODY_SIZE = 1 << 26  # 64 MB (ref: source_body.go:13)
FORM_FIELD = "file"  # ref: source_body.go:12


async def _stream_body(next_chunk) -> bytearray:
    """Read a body into one growable buffer, refusing it with 413 as soon
    as it passes MAX_BODY_SIZE (also for a request that lied about, or
    omitted, its Content-Length)."""
    data = bytearray()
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


class SourceRegistry:
    """Deterministic-order source matching (ref: source.go:33-99)."""

    def __init__(self, mount: str = ""):
        self.sources: list = [BodyImageSource()]
        if mount:
            self.sources.append(FileSystemImageSource(mount))

    async def get_image(self, request: web.Request) -> bytes:
        for source in self.sources:
            if source.matches(request):
                return await source.get_image(request)
        raise new_error("missing image source", 400)
