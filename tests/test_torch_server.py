"""The port's aiohttp server (`make_server`, the runner of `create_app`)
on the CPU, and its isolation from the JAX package.

The server answers the reference's status codes and error JSON: 200 for
/resize, /crop, /smartcrop, /thumbnail, /rotate, /autorotate, /flip,
/flop, /fit, /enlarge, /extract, /zoom, /convert, /blur, /watermark,
/pipeline and /info (raw body, multipart `file` field, or ?file= under
--mount; JPEG, PNG, WEBP and GIF in and out), 400 for bad params, 404
for unknown paths, 405 for GET without a mount and for every method
other than GET and POST (HEAD without a body), 406 for non-images, a
POSTed SVG as the reference serves the file; a watermark image outside the allow-list
or missing at its origin gets the reference app's 400 or 502, and one at
the local origin is composited; type=auto answers Vary: Accept,
chunked bodies read like plain ones, and /health has the reference's
keys. A chunked body, one past the size limit, malformed chunked bodies
sent as raw bytes, and a fault raised outside processing get the answers
the reference app gives the same bytes.
Where the reference answers otherwise than with its error JSON (an
exception raised while an image is processed, a PDF or SVG target, an
unknown path, a GET that no source matches, a wide PNG to WEBP), the
port's status, content type and body are held against the reference's
aiohttp app serving the same request.
Concurrent requests
get the bodies they get alone. The port must import neither `jax` nor
`imaginary_tpu` (checked in a fresh interpreter and by a scan of its
sources).
"""

from __future__ import annotations

import ast
import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request
import uuid

import numpy as np
import pytest
import torch

from imaginary_tpu_torch import codecs as pcodecs
from imaginary_tpu_torch.web.app import make_server
from tests.conftest import FIXTURES, fixture_bytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve_on_a_thread(app) -> tuple:
    """Run an aiohttp app on an event loop of its own thread: (port,
    stop), where stop() ends the loop and joins the thread."""
    import asyncio

    from aiohttp import web

    loop = asyncio.new_event_loop()
    ready = threading.Event()
    box: dict = {}

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(app, access_log=None, handle_signals=False)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", 0).start())
        box["port"] = runner.addresses[0][1]
        ready.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(120)

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=30)

    return box["port"], stop


@pytest.fixture(scope="module")
def origin():
    """A local origin on 127.0.0.1 serving /mark.png (404 elsewhere);
    yields its base URL. The servers below allow this origin alone, so a
    watermark URL on any other host is refused before any lookup."""
    from aiohttp import web

    async def handler(request):
        if request.path == "/mark.png":
            return web.Response(body=fixture_bytes("test.png"), content_type="image/png")
        return web.Response(status=404, text="not here")

    app = web.Application()
    app.router.add_route("*", "/{tail:.*}", handler)
    port, stop = _serve_on_a_thread(app)
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        stop()


@pytest.fixture(scope="module")
def server(origin):
    from imaginary_tpu_torch.web.config import parse_origins

    fixture_bytes("large.jpg")  # make sure the fixture directory exists
    srv = make_server("127.0.0.1", 0, device="cpu", mount=FIXTURES,
                      allowed_origins=parse_origins(origin))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
        assert not th.is_alive()


@pytest.fixture(scope="module")
def reference_server(origin):
    """The reference's aiohttp app (mounted on the fixtures, allowing the
    local origin alone, as `server`) on a thread of its own, for raw
    requests; yields its port."""
    import io

    from imaginary_tpu.web.app import create_app
    from imaginary_tpu.web.config import ServerOptions, parse_origins

    app = create_app(ServerOptions(mount=FIXTURES, allowed_origins=parse_origins(origin)),
                     log_stream=io.StringIO())
    port, stop = _serve_on_a_thread(app)
    try:
        yield port
    finally:
        stop()


def _req(port, path, body=None, ctype="image/jpeg"):
    headers = {"Content-Type": ctype} if body is not None else {}
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                               headers=headers)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _dims(body: bytes) -> tuple:
    return pcodecs.decode(body).array.shape[:2]


@pytest.mark.parametrize("op", ["resize", "crop"])
def test_raw_post_serves_300x200_jpeg(server, op):
    status, ctype, body = _req(server, f"/{op}?width=300&height=200",
                               fixture_bytes("large.jpg"))
    assert (status, ctype) == (200, "image/jpeg")
    assert _dims(body) == (200, 300)


def test_multipart_and_mounted_file_sources(server):
    buf = fixture_bytes("large.jpg")
    bd = uuid.uuid4().hex
    form = (f"--{bd}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"large.jpg\"\r\nContent-Type: image/jpeg\r\n\r\n").encode() \
        + buf + f"\r\n--{bd}--\r\n".encode()
    status, _, body = _req(server, "/resize?width=300&height=200", form,
                           f"multipart/form-data; boundary={bd}")
    assert status == 200 and _dims(body) == (200, 300)
    status, _, body = _req(server, "/crop?width=300&height=200&file=large.jpg")
    assert status == 200 and _dims(body) == (200, 300)
    status, _, body = _req(server, "/crop?width=300&file=../../etc/passwd")
    assert status == 400 and json.loads(body)["message"] == "Invalid file path"


ERRORS = [
    ("/resize", "large.jpg", 400, "Missing required param: height or width"),
    ("/resize?width=abc", "large.jpg", 400, None),
    ("/crop?width=300&type=bogus", "large.jpg", 400, "Unsupported output image format"),
    ("/resize?width=300", "1024bytes", 406, "Unsupported media type"),
    ("/nope?width=300", "large.jpg", 404, None),
    ("/watermarkimage?image=http://example.invalid/m.png", "large.jpg", 400,
     "Unable to retrieve watermark image: http://example.invalid/m.png"),
    ("/info", "1024bytes", 406, "Unsupported media type"),
    ("/pipeline?operations=" + urllib.parse.quote(
        '[{"operation": "watermarkImage", "params": {"image": "{origin}/gone.png"}}]'),
     "large.jpg", 502, None),
    ("/pipeline", "test.png", 400, "Missing pipeline operations"),
]


@pytest.mark.parametrize("path,fixture,code,message", ERRORS,
                         ids=[f"{e[2]}-{e[0]}" for e in ERRORS])
def test_error_statuses_and_json(server, origin, path, fixture, code, message):
    path = path.replace(urllib.parse.quote("{origin}"), urllib.parse.quote(origin))
    status, ctype, body = _req(server, path, fixture_bytes(fixture))
    if code == 404:
        # no route matches: the reference's router answers aiohttp's page
        assert (status, ctype, body) == (404, "text/plain; charset=utf-8",
                                         b"404: Not Found")
        return
    assert status == code and ctype == "application/json"
    err = json.loads(body)
    assert err["status"] == code
    if message is not None:
        assert err["message"] == message


def test_svg_body_answers_as_the_reference_serves_the_file(server, reference_server):
    """A POSTed button.svg is rasterized by librsvg and resized: the
    reference's answer to the same file from its mount (its POSTed body
    reaches librsvg as a bytearray, which its ctypes binding refuses;
    tests/test_torch_vector_codecs.py)."""
    status, ctype, body = _req(server, "/resize?width=300", fixture_bytes("button.svg"))
    want = _req(reference_server, "/resize?width=300&file=button.svg")
    assert (status, ctype) == want[:2] == (200, "image/jpeg")
    assert _dims(body) == _dims(want[2])


WATERMARK_ERRORS = [e for e in ERRORS if "watermark" in e[0]]


@pytest.mark.parametrize("path,fixture,code,message", WATERMARK_ERRORS,
                         ids=[f"{e[2]}-{e[0].split('?')[0]}" for e in WATERMARK_ERRORS])
def test_watermark_errors_equal_the_reference_apps(server, reference_server, origin,
                                                   path, fixture, code, message):
    """The statuses and JSON above are the reference app's own answers to
    the same requests: an origin off the allow-list, and a mark the local
    origin does not have (502 with its status=404)."""
    path = path.replace(urllib.parse.quote("{origin}"), urllib.parse.quote(origin))
    got = _req(server, path, fixture_bytes(fixture))
    want = _req(reference_server, path, fixture_bytes(fixture))
    assert got[:2] == want[:2] == (code, "application/json")
    assert json.loads(got[2]) == json.loads(want[2])
    if code == 502:
        assert "status=404" in json.loads(got[2])["message"]


def test_watermark_image_from_the_local_origin(server, origin):
    status, ctype, body = _req(server, f"/watermarkimage?image={origin}/mark.png"
                                       "&top=20&left=20&opacity=0.5", fixture_bytes("large.jpg"))
    assert (status, ctype) == (200, "image/jpeg")
    assert _dims(body) == (1080, 1920)


# (path, fixture, decoded output (h, w)); exif-orient-6.jpg is 400x300
# stored with EXIF orientation 6, so every chain first turns it upright
ORIENT_ROUTES = [
    ("/thumbnail?width=300&height=200", "large.jpg", (200, 300)),
    ("/rotate?rotate=90", "large.jpg", (1920, 1080)),
    ("/rotate?rotate=180", "exif-orient-6.jpg", (400, 300)),
    ("/flip", "exif-orient-6.jpg", (400, 300)),
    ("/flop", "exif-orient-6.jpg", (400, 300)),
    ("/autorotate", "exif-orient-6.jpg", (400, 300)),
]


@pytest.mark.parametrize("path,fixture,dims", ORIENT_ROUTES,
                         ids=[r[0].split("?")[0].strip("/") + "-" + r[1] for r in ORIENT_ROUTES])
def test_orientation_routes_serve_jpeg(server, path, fixture, dims):
    status, ctype, body = _req(server, path, fixture_bytes(fixture))
    assert (status, ctype) == (200, "image/jpeg")
    assert _dims(body) == dims


_CONFIG3_OPS = urllib.parse.quote(
    '[{"operation": "resize", "params": {"width": 1280}},'
    ' {"operation": "blur", "params": {"sigma": 1.2}},'
    ' {"operation": "watermark", "params": {"text": "bench", "opacity": 0.5}},'
    ' {"operation": "convert", "params": {"type": "webp"}}]')

# (path, fixture, content type, decoded output (h, w)); test.png and
# test.webp are 512x512, test.gif 240x320
SLICE3_ROUTES = [
    # config 3 on a 512x512 PNG: 1280x512, as the JAX package answers
    ("/pipeline?operations=" + _CONFIG3_OPS, "test.png", "image/webp", (512, 1280)),
    ("/blur?sigma=2", "test.png", "image/png", (512, 512)),
    ("/watermark?text=port&opacity=0.5", "test.webp", "image/webp", (512, 512)),
    ("/convert?type=webp", "large.jpg", "image/webp", (1080, 1920)),
    ("/convert?type=png", "test.gif", "image/png", (240, 320)),
    ("/resize?width=300&colorspace=bw", "large.jpg", "image/jpeg", (169, 300)),
    ("/fit?width=300&height=300", "large.jpg", "image/jpeg", (169, 300)),
    ("/enlarge?width=2400&height=1400", "large.jpg", "image/jpeg", (1400, 2400)),
    ("/extract?top=10&left=20&areawidth=300&areaheight=200", "large.jpg", "image/jpeg",
     (200, 300)),
    ("/zoom?factor=2", "test.gif", "image/gif", (480, 640)),
    ("/smartcrop?width=300&height=200", "large.jpg", "image/jpeg", (200, 300)),
    ("/smartcrop?width=200&height=200", "test.png", "image/png", (200, 200)),
]


@pytest.mark.parametrize("path,fixture,ctype,dims", SLICE3_ROUTES,
                         ids=[r[0].split("?")[0].strip("/") + "-" + r[1] for r in SLICE3_ROUTES])
def test_slice3_routes_serve_their_formats(server, path, fixture, ctype, dims):
    status, got_ctype, body = _req(server, path, fixture_bytes(fixture))
    assert (status, got_ctype) == (200, ctype)
    assert _dims(body) == dims


def test_concurrent_mixed_requests_get_the_bodies_they_get_alone():
    """Eight requests at once through a server that batches across a wide
    formation window: each answer is byte-equal to the same request
    served alone (every kernel computes each image on its own)."""
    reqs = [("/thumbnail?width=300&height=200", "large.jpg"),
            ("/crop?width=300&height=200", "large.jpg"),
            ("/resize?width=120&height=90", "exif-orient-6.jpg"),
            ("/flop", "exif-orient-6.jpg")] * 2
    srv = make_server("127.0.0.1", 0, device="cpu", batch_form_ms=50.0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        port = srv.server_address[1]
        alone = {r: _req(port, r[0], fixture_bytes(r[1])) for r in reqs[:4]}
        got = [None] * len(reqs)

        def send(i):
            got[i] = _req(port, reqs[i][0], fixture_bytes(reqs[i][1]))

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = srv.service.executor.stats
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    assert not srv.service.executor._thread.is_alive()
    for r, g in zip(reqs, got):
        assert g is not None and g[0] == 200, r
        assert g == alone[r], r
    assert stats.items == 12 and stats.device_failures == 0


def test_get_without_mount_is_405():
    srv = make_server("127.0.0.1", 0, device="cpu")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        status, _, body = _req(srv.server_address[1], "/resize?width=300&file=large.jpg")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    assert status == 405 and json.loads(body)["status"] == 405


def test_index_and_health(server):
    status, ctype, body = _req(server, "/")
    assert status == 200 and ctype == "application/json; charset=utf-8"  # the reference's
    assert json.loads(body)["backend"] == "cpu"
    status, _, body = _req(server, "/health")
    stats = json.loads(body)
    assert status == 200 and stats["device"] == "cpu"
    assert set(stats["kernelLaunches"]) == {"resample", "yuv420_unpack", "yuv420_pack",
                                            "gather", "orient", "blur", "composite", "gray",
                                            "saliency", "window_argmax", "from_dct",
                                            "to_dct", "blur_halo"}
    assert stats["codecs"] == {"jpeg": "native", "png": "pil", "webp": "pil",
                               "gif": "pil", "tiff": "pil"}
    ex = stats["executor"]
    assert {"items", "batches", "groups", "avg_batch", "max_group", "queue_depth",
            "device_failures", "batch_form_p99_ms", "dispatch_wait_p99_ms"} <= set(ex)
    assert ex["device_failures"] == 0 and ex["items"] >= ex["batches"] >= 0


def _raw(port, method, path, body=None, headers=None):
    """(status, headers, body) of one request sent with http.client, which
    sends any method and a chunked body from an iterable."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {},
                     encode_chunked=not isinstance(body, (bytes, type(None))))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_health_carries_the_reference_keys_and_device_health_at_the_top(server):
    """ref: imaginary_tpu/web/health.py: process RSS, GC collections, the
    device count and backend beside the executor's block."""
    stats = json.loads(_req(server, "/health")[2])
    assert stats["allocatedMemoryMb"] > 0
    assert isinstance(stats["gcCollections"], int) and stats["gcCollections"] >= 0
    assert (stats["devices"], stats["backend"]) == (1, "cpu")
    assert "deviceHealth" not in stats["executor"]


@pytest.mark.parametrize("accept,ctype", [
    ("image/webp,*/*", "image/webp"),
    ("text/html,application/xhtml+xml,application/xml;q=0.9,image/avif,image/webp,"
     "image/apng,*/*;q=0.8", "image/webp"),
    (None, "image/jpeg"),
], ids=["webp", "chrome", "none"])
def test_type_auto_answers_vary_accept(server, accept, ctype):
    """ref: TestTypeAuto, tests/test_server.py: type=auto resolves the
    format from Accept and says so with Vary: Accept."""
    headers = {"Content-Type": "image/jpeg"}
    if accept is not None:
        headers["Accept"] = accept
    status, got, _ = _raw(server, "POST", "/resize?width=100&type=auto",
                          fixture_bytes("large.jpg"), headers)
    assert (status, got["Content-Type"], got["Vary"]) == (200, ctype, "Accept")
    status, got, _ = _raw(server, "POST", "/resize?width=100",
                          fixture_bytes("large.jpg"), {"Content-Type": "image/jpeg"})
    assert status == 200 and "Vary" not in got


@pytest.mark.parametrize("method,path", [
    ("DELETE", "/resize?width=300"), ("PATCH", "/resize?width=300"),
    ("HEAD", "/resize?width=300"), ("OPTIONS", "/resize?width=300"),
    ("PUT", "/"), ("PUT", "/health"), ("PUT", "/resize?width=300"),
])
def test_methods_other_than_get_and_post_get_the_405_json(server, method, path):
    """ref: _validate_request, imaginary_tpu/web/middleware.py: every path,
    `/` and `/health` too; a HEAD answer carries no body."""
    status, headers, body = _raw(server, method, path)
    assert status == 405 and headers["Content-Type"] == "application/json"
    if method == "HEAD":
        assert body == b""
        return
    err = json.loads(body)
    assert err["status"] == 405 and err["message"].startswith("HTTP method not allowed")


def test_chunked_post_is_answered_like_the_plain_one(server, reference_server):
    """A chunked body is read like the plain one, and the reference app
    answers the same chunked bytes with the same status, content type and
    pixels (within 1 LSB)."""
    buf = fixture_bytes("large.jpg")
    path = "/resize?width=300&height=200"
    plain = _raw(server, "POST", path, buf, {"Content-Type": "image/jpeg"})

    def chunked_to(port):
        chunks = (buf[i:i + 7919] for i in range(0, len(buf), 7919))
        return _raw(port, "POST", path, chunks,
                    {"Content-Type": "image/jpeg", "Transfer-Encoding": "chunked"})

    chunked = chunked_to(server)
    want = chunked_to(reference_server)
    assert plain[0] == chunked[0] == want[0] == 200
    assert chunked[1]["Content-Type"] == want[1]["Content-Type"] == "image/jpeg"
    assert chunked[2] == plain[2] and _dims(chunked[2]) == (200, 300)
    got_px = pcodecs.decode(chunked[2]).array.astype(int)
    want_px = pcodecs.decode(want[2]).array.astype(int)
    assert got_px.shape == want_px.shape and np.abs(got_px - want_px).max() <= 1


def test_chunked_body_over_the_limit_is_413(server, reference_server, monkeypatch):
    """A chunked body past the limit answers what the reference app
    answers for the same bytes under the same limit: the 413 JSON."""
    from imaginary_tpu.web import sources as reference_sources

    from imaginary_tpu_torch.web import sources

    monkeypatch.setattr(sources, "MAX_BODY_SIZE", 1000)
    monkeypatch.setattr(reference_sources, "MAX_BODY_SIZE", 1000)

    def over_to(port):
        status, headers, body = _raw(port, "POST", "/resize?width=300",
                                     iter([b"x" * 600, b"y" * 600]),
                                     {"Content-Type": "image/jpeg",
                                      "Transfer-Encoding": "chunked"})
        return status, headers["Content-Type"], body

    got = over_to(server)
    assert got == over_to(reference_server)
    assert got[0] == 413 and json.loads(got[2])["status"] == 413


MALFORMED_CHUNKS = [
    b"-1\r\nabc\r\n0\r\n\r\n", b"0x3\r\nabc\r\n0\r\n\r\n", b"1_0\r\nabc\r\n0\r\n\r\n",
    b"zz\r\n0\r\n\r\n", b"3\r\nabcd\r\n0\r\n\r\n", b"a\r\nabc",
]
MALFORMED_IDS = ["negative", "prefix", "underscore", "not-hex", "no-crlf", "cut-short"]


def _raw_chunked(port: int, chunks: bytes) -> tuple:
    """(status, content type, body) of a chunked POST sent as raw bytes;
    (None, None, b"") when the server closes without an answer. The
    connection stays open for writing, so a server that read on would
    leave the client waiting; only the cut-short body ends the stream."""
    with socket.create_connection(("127.0.0.1", port), timeout=20) as s:
        s.sendall(b"POST /resize?width=300 HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
                  b"Content-Type: image/jpeg\r\nTransfer-Encoding: chunked\r\n\r\n" + chunks)
        if chunks.endswith(b"abc"):
            s.shutdown(socket.SHUT_WR)
        got = b""
        while data := s.recv(65536):
            got += data
    if not got:
        return None, None, b""
    head, _, body = got.partition(b"\r\n\r\n")
    lines = head.split(b"\r\n")
    fields = dict(ln.split(b": ", 1) for ln in lines[1:] if b": " in ln)
    return int(lines[0].split(b" ", 2)[1]), fields.get(b"Content-Type"), body


@pytest.mark.parametrize("chunks", MALFORMED_CHUNKS, ids=MALFORMED_IDS)
def test_malformed_chunked_body_is_400(server, reference_server, chunks):
    """A chunk size that is not plain hex (a negative one would read on
    with no limit), or a chunk that does not end where its size says, is
    refused with aiohttp's plain-text 400; a body cut short before the
    client's half-close gets no answer. In every case the port's status,
    content type and body are the reference app's for the same raw
    bytes, and no case hangs."""
    cid = MALFORMED_IDS[MALFORMED_CHUNKS.index(chunks)]
    got = _raw_chunked(server, chunks)
    want = _raw_chunked(reference_server, chunks)
    assert want[0] == (None if cid == "cut-short" else 400)
    assert got == want


def test_cuda_device_without_cuda_raises():
    """No silent CPU fallback: asking for the card where there is none fails."""
    if torch.cuda.is_available():
        srv = make_server("127.0.0.1", 0, device="cuda")
        srv.server_close()
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_server("127.0.0.1", 0, device="cuda")


def test_import_leaves_jax_and_the_reference_out():
    code = (
        "import sys\n"
        "import imaginary_tpu_torch, imaginary_tpu_torch.pipeline\n"
        "import imaginary_tpu_torch.web.app, imaginary_tpu_torch.kernels\n"
        "import imaginary_tpu_torch.cli, imaginary_tpu_torch.ops.chain\n"
        "import imaginary_tpu_torch.engine.executor\n"
        "import imaginary_tpu_torch.obs.events, imaginary_tpu_torch.obs.debugz\n"
        "import imaginary_tpu_torch.obs.slo, imaginary_tpu_torch.obs.cost\n"
        "import imaginary_tpu_torch.obs.looplag, imaginary_tpu_torch.web.http2\n"
        "import imaginary_tpu_torch.web.ingress, imaginary_tpu_torch.web.workers\n"
        "import imaginary_tpu_torch.fleet.shmcache, imaginary_tpu_torch.fleet.ipc\n"
        "import imaginary_tpu_torch.fleet.ownership, imaginary_tpu_torch.obs.aggregate\n"
        "import imaginary_tpu_torch.codecs.png_writer\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'imaginary_tpu' or m.startswith('imaginary_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imports(path: str) -> list:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return names


def test_no_source_of_the_port_imports_jax_or_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "imaginary_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "imaginary_tpu"), (path, name)


def test_server_output_matches_pipeline_output(server):
    from imaginary_tpu_torch import pipeline
    from imaginary_tpu_torch.params import build_params_from_query

    buf = fixture_bytes("large.jpg")
    direct = pipeline.process_operation(
        "resize", buf, build_params_from_query({"width": "300", "height": "200"}), device="cpu")
    _, _, body = _req(server, "/resize?width=300&height=200", buf)
    assert np.array_equal(pcodecs.decode(body).array, pcodecs.decode(direct.body).array)


def test_mesh_policy_lanes_serves_the_off_bytes_with_one_lane_per_device():
    """`--mesh-policy lanes --device cpu --devices 2` through the command
    line's own wiring: /resize answers the bytes the default server does,
    and /health shows two lanes and two fault domains."""
    from imaginary_tpu_torch import cli

    buf = fixture_bytes("large.jpg")
    bodies, healths = {}, {}
    for policy in ("off", "lanes"):
        args = cli.parse_args(["--port", "0", "--addr", "127.0.0.1", "--device", "cpu",
                               "--mesh-policy", policy, "--devices", "2"])
        srv = cli.make_server_from_args(args)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            port = srv.server_address[1]
            bodies[policy] = [_req(port, "/resize?width=300&height=200", buf)
                              for _ in range(3)]
            healths[policy] = json.loads(_req(port, "/health")[2])
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=10)
    assert all(b[0] == 200 for b in bodies["off"])
    assert bodies["lanes"] == bodies["off"]
    assert "lanes" not in healths["off"]["executor"]
    # the off policy's global ladder: one fault domain a device, no lanes
    assert healths["off"]["deviceHealth"]["count"] == 2
    assert "lanes" not in healths["off"]["deviceHealth"]
    ex = healths["lanes"]["executor"]
    assert [ln["lane"] for ln in ex["lanes"]] == [0, 1]
    assert sum(ln["dispatches"] for ln in ex["lanes"]) == ex["batches"] >= 1
    dh = healths["lanes"]["deviceHealth"]
    assert dh["count"] == 2 and len(dh["lanes"]) == 2
    assert "deviceHealth" not in ex


def test_multi_gpu_modules_import_without_jax_or_the_reference():
    code = (
        "import sys\n"
        "import imaginary_tpu_torch.parallel.mesh, imaginary_tpu_torch.parallel.spatial\n"
        "import imaginary_tpu_torch.engine.lanes, imaginary_tpu_torch.engine.devhealth\n"
        "import imaginary_tpu_torch.failpoints\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'imaginary_tpu' or m.startswith('imaginary_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


# --- the port against the reference's aiohttp app on the same requests ----

def _png(arr: np.ndarray) -> bytes:
    import io

    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(arr).save(out, "PNG")
    return out.getvalue()


def _wide_png() -> bytes:
    """17000x64: under the 18 Mpix gate, wider than the planner's 8192
    buckets and WEBP's 16383-pixel limit."""
    rng = np.random.default_rng(11)
    return _png(rng.integers(0, 256, (64, 17000, 3), dtype=np.uint8))


_PIPELINE_WEBP = "/pipeline?operations=" + urllib.parse.quote(
    '[{"operation": "convert", "params": {"type": "webp"}}]')
# (id, method, path, source): the requests on which the parent port's
# answer differed from the reference's
REFERENCE_CASES = [
    ("resize-wide", "POST", "/resize?width=300", "wide"),
    ("rotate-wide", "POST", "/rotate?rotate=90", "wide"),
    ("thumbnail-wide", "POST", "/thumbnail?width=100&height=100", "wide"),
    ("blur-wide", "POST", "/blur?sigma=2", "wide"),
    ("flip-wide", "POST", "/flip", "wide"),
    ("watermark-wide", "POST", "/watermark?text=hi", "wide"),
    ("pipeline-wide", "POST", "/pipeline?operations=" + urllib.parse.quote(
        '[{"operation": "resize", "params": {"width": 300}}]'), "wide"),
    ("convert-pdf", "POST", "/convert?type=pdf", "large.jpg"),
    ("convert-svg", "POST", "/convert?type=svg", "large.jpg"),
    ("get-unknown-path", "GET", "/nope?width=300", None),
    ("post-unknown-path", "POST", "/nope?width=300", "large.jpg"),
    ("get-nested-path", "GET", "/resize/x?width=300", None),
    ("get-no-source", "GET", "/resize?width=300", None),
    ("get-empty-file", "GET", "/resize?width=300&file=", None),
]
# the WEBP targets that the reference re-encodes as JPEG: held by status,
# content type and decoded dims (the two JPEG encoders differ)
JPEG_FALLBACK_CASES = [
    ("convert-webp-wide", "POST", "/convert?type=webp", "wide"),
    ("pipeline-webp-wide", "POST", _PIPELINE_WEBP, "wide"),
]


def _case_body(src):
    if src is None:
        return None
    return _wide_png() if src == "wide" else fixture_bytes(src)


@pytest.fixture(scope="module")
def reference_answers():
    """{case id: (status, content type, body)} from the reference's aiohttp
    app (`create_app`, mounted on the fixtures) on every case, one app run."""
    import asyncio
    import io

    from aiohttp.test_utils import TestClient, TestServer

    from imaginary_tpu.web.app import create_app
    from imaginary_tpu.web.config import ServerOptions

    async def run():
        app = create_app(ServerOptions(mount=FIXTURES), log_stream=io.StringIO())
        client = TestClient(TestServer(app))
        await client.start_server()
        out = {}
        try:
            for cid, method, path, src in REFERENCE_CASES + JPEG_FALLBACK_CASES:
                body = _case_body(src)
                headers = {"Content-Type": "image/png"} if body is not None else {}
                r = await client.request(method, path, data=body, headers=headers)
                out[cid] = (r.status, r.headers.get("Content-Type"), await r.read())
        finally:
            await client.close()
        return out

    return asyncio.run(run())


def _port_answer(port, method, path, body):
    headers = {"Content-Type": "image/png"} if body is not None else {}
    status, got, data = _raw(port, method, path, body, headers)
    return status, got["Content-Type"], data


@pytest.mark.parametrize("cid,method,path,src", REFERENCE_CASES,
                         ids=[c[0] for c in REFERENCE_CASES])
def test_answers_equal_the_reference_apps(server, reference_answers, cid, method, path,
                                          src):
    """Status, content type and body equal the reference's: 400 "Error
    processing image: ..." for any exception raised while the image is
    processed (here the planner's ValueError on a 17000-wide PNG; the
    parent dropped the connection), 400 "Cannot encode image:
    unsupported format pdf|svg" (the parent answered 501), aiohttp's
    plain-text 404 for an unknown path (the parent: a 404 JSON), and 400
    "missing image source" for a GET that no source matches (the parent:
    "Missing required param: file")."""
    got = _port_answer(server, method, path, _case_body(src))
    assert got == reference_answers[cid]


@pytest.mark.parametrize("cid,method,path,src", JPEG_FALLBACK_CASES,
                         ids=[c[0] for c in JPEG_FALLBACK_CASES])
def test_failed_webp_encode_answers_jpeg_like_the_reference(server, reference_answers,
                                                             cid, method, path, src):
    """A WEBP encode over WEBP's 16383-pixel limit is retried as JPEG and
    answered as image/jpeg, as the reference does (the parent answered 400)."""
    status, ctype, body = _port_answer(server, method, path, _case_body(src))
    want = reference_answers[cid]
    assert (status, ctype) == want[:2] == (200, "image/jpeg")
    assert _dims(body) == _dims(want[2]) == (64, 17000)


def test_a_fault_outside_processing_answers_like_aiohttp(server, reference_server,
                                                          monkeypatch):
    """An exception raised outside an image's processing (here in /health)
    gets the answer the reference app gives for the same fault, aiohttp's
    500 page, and never a dropped connection; the server serves on
    afterwards."""
    from imaginary_tpu.web import handlers as reference_handlers

    from imaginary_tpu_torch.web.handlers import ImageService

    def boom(*_a, **_k):
        raise RuntimeError("boom")

    monkeypatch.setattr(reference_handlers, "collect_health_stats", boom)
    monkeypatch.setattr(ImageService, "health", boom)
    want = _port_answer(reference_server, "GET", "/health", None)
    assert want[0] == 500
    assert _port_answer(server, "GET", "/health", None) == want
    monkeypatch.undo()
    assert _req(server, "/health")[0] == 200


def test_a_device_error_while_processing_is_a_400_and_not_retried(server, monkeypatch):
    """A RuntimeError from the card's side of a request (here the chain's
    launch) answers the reference's 400 and is not retried on the CPU or
    through a plain version: the chain ran once."""
    from imaginary_tpu_torch.ops import chain

    calls = []

    def launch(*a, **k):
        calls.append(1)
        raise RuntimeError("gray kernel launch failed: CUDA error 700")

    monkeypatch.setattr(chain, "launch_batch", launch)
    status, ctype, body = _req(server, "/resize?width=300&height=200",
                               fixture_bytes("large.jpg"))
    assert (status, ctype) == (400, "application/json")
    assert "CUDA error 700" in json.loads(body)["message"]
    assert calls == [1]
