"""The port's HTTP layer on the CPU: a port copy of `tests/test_server.py`'s
route and status matrix, run on the port's `create_app` through aiohttp's
TestClient (`device="cpu"`).

Each class asserts what the reference's class of the same name asserts,
on the port. Where the reference's test reaches a subsystem the port has
not ported, the port's case says what the port answers instead:
`/` names the torch stack where the reference names jax; the host-spill
flag of TestBackendHeader gives way to the error answers' missing
backend header; TestMaxAllowedSize holds here that the flag caps no body
or file source, as in the reference (its URL-source cases are in
tests/test_torch_url_source.py, with TestURLSource and
TestShouldRestrictOriginMatrix); and TestBootLivenessGate becomes
TestDeviceGate: the port refuses to start without a CUDA device, and
never falls back to the CPU. Not copied, each waiting for its module:
TestQueueDepthAdmission and
TestInflightLedgerOnCancellation (admission control), and
TestSpatialServedRequest (tests/test_torch_spatial_route.py serves it).
"""

import asyncio
import io
import json
import re

import pytest
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from imaginary_tpu_torch.web.app import create_app
from imaginary_tpu_torch.web.config import ServerOptions
from imaginary_tpu_torch.web.middleware import sign_url
from tests.conftest import FIXTURES, fixture_bytes


def opts(**kw) -> ServerOptions:
    return ServerOptions(device="cpu", **kw)


def run(options, fn):
    """Run `fn(client)` against a fresh app instance."""

    async def runner():
        app = create_app(options, log_stream=io.StringIO())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await fn(client)
        finally:
            await client.close()

    asyncio.run(runner())


def oracle_size(body: bytes):
    im = Image.open(io.BytesIO(body))
    return im.width, im.height


def multipart_jpg():
    form = FormData()
    form.add_field("file", fixture_bytes("imaginary.jpg"),
                   filename="imaginary.jpg", content_type="image/jpeg")
    return form


@pytest.fixture(scope="module", autouse=True)
def _fixtures(testdata):
    return testdata


class TestPublicEndpoints:
    def test_index_versions(self):
        async def fn(client):
            res = await client.get("/")
            assert res.status == 200
            body = await res.json()
            assert "imaginary_tpu_torch" in body and "torch" in body
            assert body["backend"] == "cpu"
            assert res.headers["Server"].startswith("imaginary-tpu")

        run(opts(), fn)

    def test_health(self):
        async def fn(client):
            res = await client.get("/health")
            body = await res.json()
            assert res.status == 200
            assert body["uptime"] >= 0 and "executor" in body
            assert (body["worker"], body["epoch"]) == (0, 0)
            assert body["estimatedQueueMs"] >= 0

        run(opts(), fn)

    def test_form_html(self):
        async def fn(client):
            res = await client.get("/form")
            text = await res.text()
            assert res.status == 200
            assert 'action="/resize' in text and "multipart/form-data" in text

        run(opts(), fn)

    def test_unknown_path_404(self):
        async def fn(client):
            res = await client.get("/bogus-path")
            assert res.status == 404

        run(opts(), fn)

    def test_method_not_allowed(self):
        async def fn(client):
            res = await client.delete("/resize")
            assert res.status == 405

        run(opts(), fn)


class TestImagePost:
    def test_crop_multipart(self):
        async def fn(client):
            res = await client.post("/crop?width=300", data=multipart_jpg())
            assert res.status == 200, await res.text()
            assert res.headers["Content-Type"] == "image/jpeg"
            body = await res.read()
            assert oracle_size(body) == (300, 740)

        run(opts(), fn)

    def test_resize_raw_body(self):
        async def fn(client):
            res = await client.post(
                "/resize?width=200&height=150",
                data=fixture_bytes("imaginary.jpg"),
                headers={"Content-Type": "image/jpeg"},
            )
            assert res.status == 200
            assert oracle_size(await res.read()) == (200, 150)

        run(opts(), fn)

    def test_empty_body_400(self):
        async def fn(client):
            res = await client.post("/resize?width=200", data=b"",
                                    headers={"Content-Type": "image/jpeg"})
            assert res.status == 400

        run(opts(), fn)

    def test_non_image_payload_406(self):
        async def fn(client):
            res = await client.post("/resize?width=200", data=b"clearly not an image",
                                    headers={"Content-Type": "image/jpeg"})
            assert res.status == 406

        run(opts(), fn)

    def test_bad_param_400(self):
        async def fn(client):
            res = await client.post("/resize?width=bogus", data=multipart_jpg())
            assert res.status == 400
            body = await res.json()
            assert "width" in body["message"]

        run(opts(), fn)

    def test_info(self):
        async def fn(client):
            res = await client.post("/info", data=multipart_jpg())
            meta = await res.json()
            assert meta["width"] == 550 and meta["height"] == 740

        run(opts(), fn)

    def test_pipeline(self):
        async def fn(client):
            ops = json.dumps([
                {"operation": "crop", "params": {"width": 300, "height": 260}},
                {"operation": "convert", "params": {"type": "webp"}},
            ])
            res = await client.post(f"/pipeline?operations={ops}", data=multipart_jpg())
            assert res.status == 200, await res.text()
            assert res.headers["Content-Type"] == "image/webp"
            assert oracle_size(await res.read()) == (300, 260)

        run(opts(), fn)


class TestTypeAuto:
    """ref: TestTypeAuto server_test.go:178-233."""

    def test_accept_webp(self):
        async def fn(client):
            res = await client.post("/resize?width=100&type=auto", data=multipart_jpg(),
                                    headers={"Accept": "image/webp,*/*"})
            assert res.status == 200
            assert res.headers["Content-Type"] == "image/webp"
            assert res.headers["Vary"] == "Accept"

        run(opts(), fn)

    def test_chrome_accept_header(self):
        chrome = ("text/html,application/xhtml+xml,application/xml;q=0.9,image/avif,"
                  "image/webp,image/apng,*/*;q=0.8")

        async def fn(client):
            res = await client.post("/resize?width=100&type=auto", data=multipart_jpg(),
                                    headers={"Accept": chrome})
            assert res.headers["Content-Type"] == "image/webp"
            assert res.headers["Vary"] == "Accept"

        run(opts(), fn)

    def test_no_accept_keeps_source(self):
        async def fn(client):
            res = await client.post("/resize?width=100&type=auto", data=multipart_jpg())
            assert res.headers["Content-Type"] == "image/jpeg"
            assert res.headers["Vary"] == "Accept"

        run(opts(), fn)

    def test_invalid_type_400(self):
        async def fn(client):
            res = await client.post("/resize?width=100&type=bogus", data=multipart_jpg())
            assert res.status == 400

        run(opts(), fn)


class TestResolutionGuard:
    def test_too_many_pixels_422(self):
        async def fn(client):
            res = await client.post("/resize?width=100", data=multipart_jpg())
            assert res.status == 422

        run(opts(max_allowed_pixels=0.1), fn)

    def test_limit_off_serves_anything(self):
        """--max-allowed-resolution 0 turns the guard off (the constant the
        port had before could not)."""
        async def fn(client):
            res = await client.post("/resize?width=100", data=multipart_jpg())
            assert res.status == 200

        run(opts(max_allowed_pixels=0.0), fn)


class TestMountSource:
    def test_fs_serving(self):
        async def fn(client):
            res = await client.get("/resize?file=imaginary.jpg&width=300")
            assert res.status == 200
            assert oracle_size(await res.read()) == (300, 404)

        run(opts(mount=FIXTURES), fn)

    def test_path_traversal_rejected(self):
        async def fn(client):
            res = await client.get("/resize?file=../../etc/passwd&width=100")
            assert res.status == 400

        run(opts(mount=FIXTURES), fn)

    def test_missing_file_400(self):
        async def fn(client):
            res = await client.get("/resize?file=nope.jpg&width=100")
            assert res.status == 400

        run(opts(mount=FIXTURES), fn)

    def test_get_without_sources_405(self):
        async def fn(client):
            res = await client.get("/resize?width=100")
            assert res.status == 405

        run(opts(), fn)


class TestAuthAndSignature:
    def test_api_key(self):
        async def fn(client):
            res = await client.post("/crop?width=100", data=multipart_jpg())
            assert res.status == 401
            res = await client.post("/crop?width=100", data=multipart_jpg(),
                                    headers={"API-Key": "s3cret"})
            assert res.status == 200
            res = await client.post("/crop?width=100&key=s3cret", data=multipart_jpg())
            assert res.status == 200

        run(opts(api_key="s3cret"), fn)

    def test_url_signature(self):
        key = "x" * 32

        async def fn(client):
            pairs = [("width", "100")]
            sig = sign_url(key, "/crop", pairs)
            res = await client.post(f"/crop?width=100&sign={sig}", data=multipart_jpg())
            assert res.status == 200
            res = await client.post("/crop?width=100&sign=invalid!!", data=multipart_jpg())
            assert res.status == 400
            bad = sign_url(key, "/crop", [("width", "999")])
            res = await client.post(f"/crop?width=100&sign={bad}", data=multipart_jpg())
            assert res.status == 403

        run(opts(enable_url_signature=True, url_signature_key=key), fn)


class TestMiddlewareExtras:
    def test_throttle_429(self):
        async def fn(client):
            # sent together: the throttle decides on arrival, so a slow
            # first answer cannot let the second through a second later
            first, second = await asyncio.gather(
                client.post("/crop?width=50", data=multipart_jpg()),
                client.post("/crop?width=50", data=multipart_jpg()))
            if first.status == 429:
                first, second = second, first
            assert first.status == 200
            assert second.status == 429
            assert "Retry-After" in second.headers

        run(opts(concurrency=1, burst=0), fn)

    def test_disabled_endpoint_501(self):
        async def fn(client):
            res = await client.post("/blur?sigma=3", data=multipart_jpg())
            assert res.status == 501
            res = await client.post("/crop?width=50", data=multipart_jpg())
            assert res.status == 200

        run(opts(endpoints=("blur",)), fn)

    def test_cache_headers(self):
        async def fn(client):
            res = await client.get("/resize?file=imaginary.jpg&width=100")
            assert res.headers["Cache-Control"] == "public, s-maxage=300, max-age=300, no-transform"
            assert "Expires" in res.headers
            # public paths excluded
            res = await client.get("/health")
            assert "Cache-Control" not in res.headers

        run(opts(mount=FIXTURES, http_cache_ttl=300), fn)

    def test_no_cache_ttl_zero(self):
        async def fn(client):
            res = await client.get("/resize?file=imaginary.jpg&width=100")
            assert res.headers["Cache-Control"] == "private, no-cache, no-store, must-revalidate"

        run(opts(mount=FIXTURES, http_cache_ttl=0), fn)

    def test_cors_headers(self):
        async def fn(client):
            res = await client.post("/crop?width=50", data=multipart_jpg())
            assert res.headers["Access-Control-Allow-Origin"] == "*"
            res = await client.options("/crop")
            assert res.status == 204

        run(opts(cors=True), fn)

    def test_return_size_headers(self):
        async def fn(client):
            res = await client.post("/crop?width=120&height=90", data=multipart_jpg())
            assert res.headers["Image-Width"] == "120"
            assert res.headers["Image-Height"] == "90"

        run(opts(return_size=True), fn)


class TestPlaceholder:
    def test_placeholder_on_error(self):
        async def fn(client):
            res = await client.post("/resize?width=120&height=90", data=b"not an image",
                                    headers={"Content-Type": "image/jpeg"})
            assert res.status == 406  # original error status preserved
            assert res.headers["Content-Type"] == "image/jpeg"
            assert "Error" in res.headers
            assert oracle_size(await res.read()) == (120, 90)

        run(opts(enable_placeholder=True), fn)

    def test_placeholder_custom_status(self):
        async def fn(client):
            res = await client.post("/resize?width=60&height=60", data=b"junk",
                                    headers={"Content-Type": "image/jpeg"})
            assert res.status == 202

        run(opts(enable_placeholder=True, placeholder_status=202), fn)

    def test_placeholder_runs_through_the_services_executor(self):
        """The resize of the placeholder is a request like any other: it
        runs through the service's executor (on the card in production),
        once per shape (a second error of the same shape is cached)."""
        async def fn(client):
            ex = client.app["service"].executor
            before = ex.stats.items
            for _ in range(2):
                res = await client.post("/resize?width=300&height=200", data=b"junk",
                                        headers={"Content-Type": "image/jpeg"})
                assert res.status == 406
                assert oracle_size(await res.read()) == (300, 200)
            assert ex.stats.items == before + 1

        run(opts(enable_placeholder=True), fn)


class TestPathPrefix:
    def test_prefixed_routes(self):
        async def fn(client):
            res = await client.post("/api/v1/crop?width=50", data=multipart_jpg())
            assert res.status == 200
            res = await client.get("/api/v1/health")
            assert res.status == 200

        run(opts(path_prefix="/api/v1"), fn)


class TestBackendHeader:
    """X-Imaginary-Backend: every processed image says where its pixels
    came from; the port serves them all from the device path."""

    def test_device_placement_header(self):
        async def fn(client):
            res = await client.post("/resize?width=100", data=multipart_jpg())
            assert res.status == 200
            assert res.headers["X-Imaginary-Backend"] == "device"
            # identity plans (re-encode only) never reach the executor but
            # still carry the header: untouched pixels cannot diverge
            res = await client.post("/convert?type=png", data=multipart_jpg())
            assert res.status == 200
            assert res.headers["X-Imaginary-Backend"] == "device"
            # /info never produces pixels: no header
            res = await client.post("/info", data=multipart_jpg())
            assert res.status == 200
            assert "X-Imaginary-Backend" not in res.headers

        run(opts(), fn)

    def test_error_answers_carry_no_backend_header(self):
        async def fn(client):
            res = await client.post("/resize?width=bogus", data=multipart_jpg())
            assert res.status == 400
            assert "X-Imaginary-Backend" not in res.headers

        run(opts(), fn)


class TestGCRAEviction:
    def test_key_cap_evicts(self):
        """The TAT map is bounded like the reference's memstore
        (middleware.go:131, NewMemStore(65536))."""
        import time as _time

        from imaginary_tpu_torch.web.middleware import GCRARateLimiter

        rl = GCRARateLimiter(per_sec=1000, burst=1)
        rl.MAX_KEYS = 8  # shadow the class cap for the test
        for i in range(50):
            rl.allow(f"client-{i}")
        assert len(rl._tat) <= 8
        # expired entries are preferred victims
        _time.sleep(0.005)
        rl.allow("fresh")
        assert "fresh" in rl._tat and len(rl._tat) <= 8

    def test_flood_does_not_reset_throttled_clients(self):
        """A unique-key flood must not wipe a throttled client's state:
        eviction keeps the LARGEST-tat half."""
        from imaginary_tpu_torch.web.middleware import GCRARateLimiter

        rl = GCRARateLimiter(per_sec=10, burst=3)  # emission 0.1s, tau 0.3s
        rl.MAX_KEYS = 8
        for _ in range(4):  # burn the burst: tat climbs ~0.4s ahead
            rl.allow("victim")
        blocked, retry = rl.allow("victim")
        assert not blocked and retry > 0  # throttled now
        for i in range(20):  # live-key flood past the cap
            rl.allow(f"flood-{i}")
        assert "victim" in rl._tat, "flood evicted a throttled client"
        still_blocked, _ = rl.allow("victim")
        assert not still_blocked, "flood reset a throttled client's TAT"


def _self_signed(tmp_path):
    import subprocess

    crt, key = tmp_path / "t.crt", tmp_path / "t.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(crt), "-days", "1",
         "-subj", "/CN=localhost"],
        check=True, capture_output=True,
    )
    return crt, key


class TestTLSConfig:
    """The TLS context pins the reference's config (server.go:114-131):
    TLS >= 1.2, the ECDHE + AES-GCM/ChaCha20 cipher list and, where ssl
    has set_groups, the X25519/P-256/P-384 curve list; ALPN offers h2
    beside HTTP/1.1 exactly when the h2 terminator can run (libnghttp2
    loads and --disable-http2 is off), as the reference's does."""

    def test_ssl_context_pins_reference_ciphers(self, tmp_path):
        import ssl

        from imaginary_tpu_torch.web.app import make_ssl_context

        crt, key = _self_signed(tmp_path)
        ctx = make_ssl_context(opts(cert_file=str(crt), key_file=str(key)))
        assert ctx is not None
        assert ctx.minimum_version == ssl.TLSVersion.TLSv1_2
        names = {c["name"] for c in ctx.get_ciphers()}
        tls12 = {n for n in names if not n.startswith("TLS_")}
        assert tls12 == {
            "ECDHE-ECDSA-AES256-GCM-SHA384", "ECDHE-RSA-AES256-GCM-SHA384",
            "ECDHE-ECDSA-AES128-GCM-SHA256", "ECDHE-RSA-AES128-GCM-SHA256",
            "ECDHE-ECDSA-CHACHA20-POLY1305", "ECDHE-RSA-CHACHA20-POLY1305",
        }

    def test_alpn_follows_h2_active(self, tmp_path, monkeypatch):
        import socket
        import ssl
        import threading

        from imaginary_tpu_torch.web import http2
        from imaginary_tpu_torch.web.app import _h2_active, make_ssl_context

        crt, key = _self_signed(tmp_path)

        def negotiated(o) -> str:
            client = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            client.check_hostname = False
            client.verify_mode = ssl.CERT_NONE
            client.set_alpn_protocols(["h2", "http/1.1"])
            left, right = socket.socketpair()
            server = threading.Thread(target=lambda: make_ssl_context(o).wrap_socket(
                left, server_side=True).close())
            server.start()
            try:
                with client.wrap_socket(right) as c:
                    return c.selected_alpn_protocol()
            finally:
                server.join(timeout=10)
                left.close()
                right.close()

        for http2_on in (True, False):
            o = opts(cert_file=str(crt), key_file=str(key), http2=http2_on)
            want = "h2" if _h2_active(o) else "http/1.1"
            assert negotiated(o) == want
        monkeypatch.setattr(http2, "load_nghttp2", lambda: None)
        o = opts(cert_file=str(crt), key_file=str(key))
        assert not _h2_active(o) and negotiated(o) == "http/1.1"

    def test_no_tls_without_both_files(self):
        from imaginary_tpu_torch.web.app import make_ssl_context

        assert make_ssl_context(opts(cert_file="/tmp/x.crt")) is None

    def test_group_pinning_on_py313(self):
        import ssl as ssl_mod
        import sys

        from imaginary_tpu_torch.web.app import _pin_groups

        calls = []

        class WithGroups:  # the >= 3.13 surface
            def set_groups(self, groups):
                calls.append(groups)

        class WithoutGroups:  # pre-3.13 surface
            pass

        assert _pin_groups(WithGroups()) is True
        assert calls == ["x25519:prime256v1:secp384r1"]
        assert _pin_groups(WithoutGroups()) is False
        ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_SERVER)
        assert _pin_groups(ctx) is (sys.version_info >= (3, 13))

    def test_make_server_serves_https(self, tmp_path):
        """The runner serves the same app over TLS (HTTP/1.1 to a client
        that offers no h2)."""
        import ssl
        import threading
        import urllib.request

        from imaginary_tpu_torch.web.app import make_server

        crt, key = _self_signed(tmp_path)
        srv = make_server("127.0.0.1", 0, device="cpu", cert_file=str(crt),
                          key_file=str(key))
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            ctx = ssl.create_default_context(cafile=str(crt))
            ctx.check_hostname = False
            with urllib.request.urlopen(
                    f"https://127.0.0.1:{srv.server_address[1]}/health",
                    context=ctx, timeout=30) as r:
                assert r.status == 200 and "executor" in json.loads(r.read())
        finally:
            srv.shutdown()
            srv.server_close()
            th.join(timeout=10)


class TestMultipartFieldOverride:
    """?field= selects the multipart form field name, as the reference's
    README documents (default `file`)."""

    def test_custom_field_name_accepted(self):
        async def fn(client):
            form = FormData()
            form.add_field("photo", fixture_bytes("imaginary.jpg"),
                           filename="p.jpg", content_type="image/jpeg")
            r = await client.post("/resize?width=100&field=photo", data=form)
            assert r.status == 200
            assert oracle_size(await r.read())[0] == 100

        run(opts(), fn)

    def test_default_field_still_file(self):
        async def fn(client):
            r = await client.post("/resize?width=100", data=multipart_jpg())
            assert r.status == 200

        run(opts(), fn)

    def test_wrong_field_is_missing_file_error(self):
        async def fn(client):
            form = FormData()
            form.add_field("photo", fixture_bytes("imaginary.jpg"),
                           filename="p.jpg", content_type="image/jpeg")
            r = await client.post("/resize?width=100", data=form)
            assert r.status == 400

        run(opts(), fn)


class TestDeviceGate:
    """In the place of the reference's boot liveness gate, which falls back
    to the CPU when the accelerator does not answer: the port refuses to
    start without a CUDA device unless --device cpu asks for the CPU, and
    --require-device accepts nothing but CUDA. Nothing falls back."""

    def _no_serve(self, monkeypatch):
        from imaginary_tpu_torch.web import app as app_mod

        served = {}

        async def fake_serve(o, mrelease=30):
            served["device"] = o.device

        monkeypatch.setattr(app_mod, "serve", fake_serve)
        return served

    def test_refuses_to_start_without_cuda(self, monkeypatch):
        import torch

        from imaginary_tpu_torch import cli

        monkeypatch.delenv("IMAGINARY_TPU_DEVICE", raising=False)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        served = self._no_serve(monkeypatch)
        assert cli.main(["--port", "0"]) == 2
        assert served == {}

    def test_require_device_refuses_the_cpu(self, monkeypatch):
        from imaginary_tpu_torch import cli

        served = self._no_serve(monkeypatch)
        assert cli.main(["--require-device", "--device", "cpu", "--port", "0"]) == 2
        assert served == {}

    def test_device_cpu_is_served_when_asked(self, monkeypatch):
        from imaginary_tpu_torch import cli

        served = self._no_serve(monkeypatch)
        assert cli.main(["--device", "cpu", "--port", "0"]) == 0
        assert served == {"device": "cpu"}

    def test_server_without_cuda_raises(self, monkeypatch):
        import torch

        from imaginary_tpu_torch.web.app import make_server

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_server("127.0.0.1", 0, device="cuda")


class TestMetricsEndpoint:
    """Prometheus /metrics: the numbers of /health in exposition format,
    plus the request and stage histograms; public like /health."""

    def test_metrics_shape(self):
        async def fn(client):
            # process one image so executor counters are live
            await client.post("/resize?width=100", data=multipart_jpg())
            res = await client.get("/metrics")
            assert res.status == 200
            assert res.headers["Content-Type"].startswith("text/plain")
            text = await res.text()
            lines = dict(
                ln.rsplit(" ", 1) for ln in text.strip().splitlines()
                if " " in ln and not ln.startswith("#")
            )
            assert float(lines["imaginary_tpu_uptime"]) >= 0
            assert "imaginary_tpu_pid" in lines
            assert float(lines["imaginary_tpu_executor_items"]) >= 0
            assert float(lines["imaginary_tpu_estimated_queue_ms"]) >= 0
            assert any(k.startswith('imaginary_tpu_backend_info{backend=')
                       for k in lines)
            # per-stage latency gauges carry stage/quantile labels
            assert any(k.startswith('imaginary_tpu_stage_ms{stage="')
                       for k in lines)

        run(opts(), fn)

    def test_metrics_gated_like_health(self):
        """Exactly /health's auth posture: a scraper needs the key when one
        is set."""
        async def fn(client):
            res = await client.get("/metrics")
            assert res.status == 401
            res = await client.get("/metrics", headers={"API-Key": "sekrit"})
            assert res.status == 200

        run(opts(api_key="sekrit"), fn)

    def test_requests_are_counted(self):
        async def fn(client):
            for _ in range(3):
                await client.post("/resize?width=100", data=multipart_jpg())
            text = await (await client.get("/metrics")).text()
            got = re.search(r'^imaginary_tpu_requests_total\{route="/resize",code="2xx"\} (\d+)$',
                            text, re.M)
            assert got is not None and int(got.group(1)) >= 3

        run(opts(), fn)


class TestTraceHeaders:
    """X-Request-ID in and out, and Server-Timing with the executor's
    stages, which ride back on the item's future to the pool thread."""

    def test_server_timing_carries_the_executors_spans(self):
        async def fn(client):
            res = await client.post("/resize?width=300&height=200",
                                    data=fixture_bytes("large.jpg"),
                                    headers={"Content-Type": "image/jpeg"})
            assert res.status == 200
            names = [p.split(";")[0] for p in res.headers["Server-Timing"].split(", ")]
            assert names == ["fetch", "probe", "decode", "batch_form", "dispatch_wait",
                             "drain", "execute", "encode", "total"]

        run(opts(), fn)

    def test_request_id_is_echoed_or_minted(self):
        async def fn(client):
            res = await client.get("/health", headers={"X-Request-ID": "abc-123"})
            assert res.headers["X-Request-ID"] == "abc-123"
            res = await client.get("/health", headers={"X-Request-ID": "bad\tid"})
            assert re.fullmatch(r"[0-9a-f]{32}", res.headers["X-Request-ID"])

        run(opts(), fn)

    def test_disable_tracing_drops_server_timing(self):
        async def fn(client):
            res = await client.post("/resize?width=100", data=multipart_jpg())
            assert res.status == 200
            assert "Server-Timing" not in res.headers
            assert "X-Request-ID" in res.headers

        run(opts(trace_enabled=False), fn)


class TestAccessLogContract:
    """log_test.go ported: info level logs a 200 line carrying method,
    HTTP version and status; error level emits nothing for a 200; warning
    catches 4xx (log.go:88-99)."""

    def _capture(self, level, fn_inner):
        stream = io.StringIO()

        async def runner():
            app = create_app(opts(log_level=level), log_stream=stream)
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                await fn_inner(client)
            finally:
                await client.close()

        asyncio.run(runner())
        return stream.getvalue()

    def test_info_logs_full_line(self):
        async def fn(client):
            await client.get("/health")

        line = self._capture("info", fn)
        assert "GET" in line and "HTTP/1.1" in line and " 200 " in line
        assert re.search(r'" 200 \d+ \d+\.\d{4} [0-9a-f]{32}\n', line)
        assert re.search(r'\[\d{2}/\w{3}/\d{4}:\d{2}:\d{2}:\d{2} [+-]\d{4}\]', line)

    def test_error_level_silent_on_200(self):
        async def fn(client):
            await client.get("/health")

        assert self._capture("error", fn) == ""

    def test_warning_catches_4xx_not_2xx(self):
        async def fn(client):
            await client.get("/health")          # 200: silent
            await client.get("/bogus-route")     # 404: logged

        line = self._capture("warning", fn)
        assert " 200 " not in line and " 404 " in line


class TestMaxAllowedSize:
    """The reference's --max-allowed-size caps only what a URL source
    fetches (sources.py:327-391; tests/test_torch_url_source.py): a body
    or file source larger than the cap is served, as the reference serves
    it."""

    def test_body_larger_than_the_cap_is_served(self):
        async def fn(client):
            res = await client.post("/resize?width=100", data=multipart_jpg())
            assert res.status == 200

        run(opts(max_allowed_size=1023), fn)

    def test_file_larger_than_the_cap_is_served(self):
        async def fn(client):
            res = await client.get("/resize?file=imaginary.jpg&width=100")
            assert res.status == 200

        run(opts(mount=FIXTURES, max_allowed_size=1023), fn)

    def test_flag_reaches_the_options(self):
        from imaginary_tpu_torch import cli

        args = cli.parse_args(["--max-allowed-size", "1023"])
        assert cli.options_from_args(args).max_allowed_size == 1023
