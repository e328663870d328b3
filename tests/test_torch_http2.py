"""HTTP/2 serving of the port (imaginary_tpu_torch/web/http2.py), the
reference's `tests/test_http2.py` against `python -m imaginary_tpu_torch
--device cpu`: ALPN negotiation, stream decode, the Unix-socket hop and
the http/1.1 fallback on the same port, graded with curl's own
nghttp2-backed client as the protocol oracle, PIL as the dimension
oracle. Then the drain: with the listener draining, a new h2 stream gets
the 503 with Retry-After that HTTP/1.1 requests get.

The reference's skip rule: without curl built with HTTP/2, libnghttp2 or
openssl a test skips (decided in a fixture, never at import).
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def h2_tools():
    """Skip unless curl speaks HTTP/2 and libnghttp2 and openssl are here."""
    if shutil.which("curl") is None:
        pytest.skip("curl unavailable")
    version = subprocess.run(["curl", "-V"], capture_output=True).stdout
    if b"HTTP2" not in version and b"nghttp2" not in version:
        pytest.skip("curl without HTTP/2 support")
    if not _lib_present():
        pytest.skip("libnghttp2 not present")
    if shutil.which("openssl") is None:
        pytest.skip("openssl unavailable for test certs")


def _lib_present() -> bool:
    from imaginary_tpu_torch.web.http2 import load_nghttp2

    return load_nghttp2() is not None


def _cert(tmp) -> tuple:
    cert, key = str(tmp / "cert.pem"), str(tmp / "key.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
         "-out", cert, "-days", "2", "-nodes", "-subj", "/CN=localhost"],
        check=True, capture_output=True,
    )
    return cert, key


@pytest.fixture(scope="module")
def h2_server(h2_tools, tmp_path_factory, testdata):
    from tests.conftest import free_port

    cert, key = _cert(tmp_path_factory.mktemp("h2"))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "imaginary_tpu_torch", "--device", "cpu", "--port", str(port),
         "--certfile", cert, "--keyfile", key, "--log-level", "error"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    base = f"https://127.0.0.1:{port}"
    deadline = time.time() + 90
    up = False
    while time.time() < deadline:
        r = subprocess.run(["curl", "-sk", "-o", "/dev/null", "-w", "%{http_code}",
                            base + "/health"], capture_output=True, timeout=10)
        if r.stdout == b"200":
            up = True
            break
        if proc.poll() is not None:
            break
        time.sleep(0.5)
    if not up:
        out = proc.stdout.read().decode(errors="replace") if proc.poll() is not None else ""
        proc.kill()
        pytest.fail(f"h2 test server failed to start: {out[-2000:]}")
    yield base, os.path.join(testdata, "large.jpg")
    proc.terminate()
    try:
        proc.wait(timeout=15)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def _curl(args, timeout=60):
    return subprocess.run(["curl", "-sk"] + args, capture_output=True, timeout=timeout)


def test_h2_negotiated_and_resize_correct(h2_server, tmp_path):
    base, img = h2_server
    out = str(tmp_path / "out.jpg")
    r = _curl(["--http2", "-o", out, "-w", "%{http_version} %{http_code} %{content_type}",
               "-F", f"file=@{img}", base + "/resize?width=300&height=200"])
    ver, code, ctype = r.stdout.decode().split()
    assert (ver, code, ctype) == ("2", "200", "image/jpeg")
    from PIL import Image

    assert Image.open(out).size == (300, 200)


def test_http11_fallback_same_port_and_same_bytes(h2_server, tmp_path):
    """HTTP/1.1 on the same port answers, with the body h2 gives."""
    base, img = h2_server
    outs = {}
    for flag, want in (("--http1.1", "1.1"), ("--http2", "2")):
        out = str(tmp_path / f"out{want}.jpg")
        r = _curl([flag, "-o", out, "-w", "%{http_version} %{http_code}",
                   "-F", f"file=@{img}", base + "/resize?width=300&height=200"])
        assert r.stdout.decode().split() == [want, "200"]
        with open(out, "rb") as f:
            outs[want] = f.read()
    from PIL import Image

    assert Image.open(str(tmp_path / "out1.1.jpg")).size == (300, 200)
    assert outs["1.1"] == outs["2"]


def test_h2_error_semantics_preserved(h2_server):
    base, _img = h2_server
    # missing params: the service's own 400, not a protocol error
    r = _curl(["--http2", "-o", "/dev/null", "-w", "%{http_version} %{http_code}",
               "-X", "POST", base + "/resize?width=100"])
    assert r.stdout.decode().split() == ["2", "400"]
    r = _curl(["--http2", "-o", "/dev/null", "-w", "%{http_version} %{http_code}",
               base + "/nonexistent"])
    assert r.stdout.decode().split() == ["2", "404"]


def test_h2_multiplexed_streams(h2_server, tmp_path):
    """curl --parallel multiplexes streams over one connection; every
    stream comes back whole (bodies by --data-binary: curl's parallel
    mode sends empty bodies for repeated form uploads)."""
    base, img = h2_server
    args = ["--http2", "--parallel", "--parallel-max", "8", "-H", "Content-Type: image/jpeg"]
    for i in range(6):
        args += ["-o", str(tmp_path / f"p{i}.jpg"), "--data-binary", f"@{img}",
                 base + f"/resize?width={100 + 10 * i}&height=80"]
    r = _curl(args, timeout=120)
    assert r.returncode == 0
    from PIL import Image

    for i in range(6):
        assert Image.open(str(tmp_path / f"p{i}.jpg")).size == (100 + 10 * i, 80)


def test_forwarded_identity_needs_hop_token(monkeypatch):
    """The access log honours X-Forwarded-* only with the per-process hop
    token: a client's own X-Forwarded-For never forges the logged peer,
    the terminator's token-bearing hop does."""
    import asyncio
    import io

    from aiohttp.test_utils import TestClient, TestServer

    from imaginary_tpu_torch.web import accesslog
    from imaginary_tpu_torch.web.app import create_app
    from imaginary_tpu_torch.web.config import ServerOptions

    monkeypatch.setattr(accesslog, "_TRUSTED_HOP_TOKEN", "")

    async def scenario():
        out = io.StringIO()
        app = create_app(ServerOptions(device="cpu"), log_stream=out)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await client.get("/health", headers={"X-Forwarded-For": "6.6.6.6"})
            accesslog.set_trusted_hop_token("sekrit")
            await client.get("/health", headers={"X-Forwarded-For": "6.6.6.6"})
            await client.get("/health", headers={
                "X-Forwarded-For": "198.51.100.7",
                "X-Forwarded-HTTP-Version": "2.0",
                "X-Internal-Hop": "sekrit",
            })
        finally:
            await client.close()
        return out.getvalue().splitlines()

    lines = asyncio.run(scenario())
    assert "6.6.6.6" not in lines[0] and "6.6.6.6" not in lines[1]
    assert "198.51.100.7" in lines[2] and "HTTP/2.0" in lines[2]


def test_h2_active_respects_disable_flag():
    from imaginary_tpu.web.app import _h2_active as ref_h2_active
    from imaginary_tpu.web.config import ServerOptions as RefOptions

    from imaginary_tpu_torch.web.app import _h2_active
    from imaginary_tpu_torch.web.config import ServerOptions

    assert _h2_active(ServerOptions(http2=False)) is False
    assert _h2_active(ServerOptions()) is _lib_present()
    assert _h2_active(ServerOptions()) is ref_h2_active(RefOptions())


def _negotiated(server_ctx) -> str:
    """The protocol a client offering h2 and http/1.1 gets (ALPN lists are
    write-only in the ssl module: negotiate against the context)."""
    import ssl as ssl_mod

    client_ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_CLIENT)
    client_ctx.check_hostname = False
    client_ctx.verify_mode = ssl_mod.CERT_NONE
    client_ctx.set_alpn_protocols(["h2", "http/1.1"])
    left, right = socket.socketpair()
    try:
        def srv():
            s = server_ctx.wrap_socket(left, server_side=True)
            s.close()

        t = threading.Thread(target=srv)
        t.start()
        c = client_ctx.wrap_socket(right)
        got = c.selected_alpn_protocol()
        c.close()
        t.join(timeout=10)
        return got
    finally:
        left.close()
        right.close()


def test_alpn_list_tracks_h2_support(h2_tools, tmp_path, monkeypatch):
    """make_ssl_context never advertises a protocol the server cannot
    speak: h2 is offered exactly when the terminator is active."""
    from imaginary_tpu_torch.web import http2
    from imaginary_tpu_torch.web.app import make_ssl_context
    from imaginary_tpu_torch.web.config import ServerOptions

    cert, key = _cert(tmp_path)
    on = ServerOptions(cert_file=cert, key_file=key, http2=True)
    off = ServerOptions(cert_file=cert, key_file=key, http2=False)
    assert _negotiated(make_ssl_context(on)) == "h2"
    assert _negotiated(make_ssl_context(off)) == "http/1.1"
    monkeypatch.setattr(http2, "load_nghttp2", lambda: None)  # no library
    assert _negotiated(make_ssl_context(on)) == "http/1.1"


def test_h2_connection_churn_no_leak(h2_server):
    """100 short-lived h2 connections: every nghttp2 session, callback set
    and stream is freed on connection_lost; the server's RSS does not grow
    materially with the connection count."""
    base, _img = h2_server

    def rss_mb():
        r = _curl(["-o", "-", base + "/health"])
        return float(json.loads(r.stdout)["allocatedMemoryMb"])

    for _ in range(10):
        _curl(["--http2", "-o", "/dev/null", base + "/health"])
    before = rss_mb()
    for _ in range(100):
        r = _curl(["--http2", "-o", "/dev/null", "-w", "%{http_code}", base + "/health"])
        assert r.stdout == b"200"
    after = rss_mb()
    assert after - before < 30.0, f"RSS grew {after - before:.1f} MB over 100 conns"


def test_draining_listener_sheds_new_h2_streams(h2_tools, tmp_path, testdata):
    """While the server drains, a new h2 stream gets 503 with Retry-After
    and the request id, as a new HTTP/1.1 image request does."""
    from imaginary_tpu_torch.web.app import make_server

    cert, key = _cert(tmp_path)
    srv = make_server("127.0.0.1", 0, device="cpu", cert_file=cert, key_file=key,
                      mount=testdata)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"https://127.0.0.1:{srv.server_address[1]}"
    path = "/resize?width=100&file=imaginary.jpg"
    try:
        srv._ready.wait(30)
        assert srv.listener.h2_server is not None
        r = _curl(["--http2", "-o", "/dev/null", "-w", "%{http_version} %{http_code}",
                   base + path])
        assert r.stdout.decode().split() == ["2", "200"]
        srv.listener.drain()
        r = _curl(["--http2", "-D", "-", "-o", "/dev/null", base + path])
        head = r.stdout.decode().lower()
        assert head.startswith("http/2 503"), head
        assert "retry-after: 2" in head and "x-request-id:" in head
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
