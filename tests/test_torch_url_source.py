"""The port's URL sources (`?url=`, the origin allow-list, auth and header
forwarding, retries, the size cap) and the watermark fetch, on the CPU.

Port copies of `tests/test_server.py`'s TestURLSource,
TestShouldRestrictOriginMatrix and TestMaxAllowedSize, and of the
`source.*` cases of `tests/test_failpoints.py`, each run on the port's
`create_app` (`device="cpu"`) against a local aiohttp origin on
127.0.0.1, as the reference's tests run theirs. The reference's
`request_timeout_s` (the request deadline) is not ported: its dead-origin
case holds the same time bound without it. Then what the reference's
tests leave implicit: which statuses retry (503 and 429 with
Retry-After, not 403), a refused connection retried then 502, a read
timeout 504, the Authorization priority, --forward-headers, the
traceparent and X-Request-ID the origin sees, the watermark's 1 MB cap,
the client session closed with the app, and a watermark fetch leaving
`?url=` unserved on a server without --enable-url-source (where the
reference's registry starts serving it).
"""

import asyncio
import io

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.web.app import create_app
from imaginary_tpu_torch.web.config import ServerOptions, parse_origins
from imaginary_tpu_torch.web.sources import WATERMARK_MAX_BYTES, should_restrict_origin
from tests.conftest import fixture_bytes


def opts(**kw) -> ServerOptions:
    return ServerOptions(device="cpu", **kw)


def run(options, fn, origin_handler=None):
    """Run `fn(client, origin_url)` against a fresh app instance, with a
    local origin serving `origin_handler` when one is given."""

    async def runner():
        origin_url = None
        origin = None
        if origin_handler is not None:
            oapp = web.Application()
            oapp.router.add_route("*", "/{tail:.*}", origin_handler)
            origin = TestServer(oapp)
            await origin.start_server()
            origin_url = f"http://127.0.0.1:{origin.port}"
        app = create_app(options, log_stream=io.StringIO())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await fn(client, origin_url)
        finally:
            await client.close()
            if origin is not None:
                await origin.close()

    asyncio.run(runner())


def oracle_size(body: bytes):
    im = Image.open(io.BytesIO(body))
    return im.width, im.height


def serving(blob: bytes, ctype: str = "image/jpeg", seen: list = None):
    """An origin handler answering `blob`, recording each request's
    (method, headers) in `seen`."""

    async def origin(request):
        if seen is not None:
            seen.append((request.method, dict(request.headers)))
        return web.Response(body=blob, content_type=ctype)

    return origin


@pytest.fixture(scope="module", autouse=True)
def _fixtures(testdata):
    return testdata


@pytest.fixture(autouse=True)
def _disarm():
    failpoints.deactivate()
    yield
    failpoints.deactivate()


class TestURLSource:
    def test_remote_fetch(self):
        async def fn(client, origin_url):
            res = await client.get(f"/resize?url={origin_url}/img.jpg&width=300")
            assert res.status == 200
            w, h = oracle_size(await res.read())
            assert w == 300

        run(opts(enable_url_source=True), fn,
            origin_handler=serving(fixture_bytes("large.jpg")))

    def test_origin_error_maps_to_502(self):
        """An origin error is the server's gateway failure: the origin's
        status stays in the message only."""

        async def origin(request):
            return web.Response(status=404, text="not here")

        async def fn(client, origin_url):
            res = await client.get(f"/resize?url={origin_url}/gone.jpg&width=300")
            assert res.status == 502
            body = await res.json()
            assert "status=404" in body["message"]

        run(opts(enable_url_source=True), fn, origin_handler=origin)

    def test_restricted_origin(self):
        async def fn(client, origin_url):
            res = await client.get(f"/resize?url={origin_url}/img.jpg&width=300")
            assert res.status == 400
            body = await res.json()
            assert "not allowed" in body["message"]

        run(opts(enable_url_source=True,
                 allowed_origins=parse_origins("https://images.example.com")),
            fn, origin_handler=serving(fixture_bytes("large.jpg")))

    def test_invalid_url_400(self):
        async def fn(client, _):
            res = await client.get("/resize?url=not-a-url&width=300")
            assert res.status == 400
            assert (await res.json())["message"] == "Invalid image URL"

        run(opts(enable_url_source=True), fn)


class TestShouldRestrictOriginMatrix:
    """The reference's allowed-origins matrix (source_http_test.go:300-443):
    wildcard subdomains, path prefixes, double slashes, trailing-slash
    normalisation, bucket pairs and the trailing-* path wildcard."""

    def _restricted(self, url, origins_csv):
        from urllib.parse import urlparse

        return should_restrict_origin(urlparse(url), parse_origins(origins_csv))

    PLAIN = "https://example.org"
    WILD = ("https://localhost,https://*.example.org,"
            "https://some.s3.bucket.on.aws.org,https://*.s3.bucket.on.aws.org")
    WITH_PATH = ("https://localhost/foo/bar/,https://*.example.org/foo/,"
                 "https://some.s3.bucket.on.aws.org/my/bucket/,"
                 "https://*.s3.bucket.on.aws.org/my/bucket/,"
                 "https://no-leading-path-slash.example.org/assets")
    TWO_BUCKETS = ("https://some.s3.bucket.on.aws.org/my/bucket1/,"
                   "https://some.s3.bucket.on.aws.org/my/bucket2/")
    PATH_WILDCARD = "https://some.s3.bucket.on.aws.org/my-bucket-name*"

    @pytest.mark.parametrize("url,origins,allowed", [
        ("https://example.org/logo.jpg", PLAIN, True),
        ("https://example.org/logo.jpg", WILD, True),
        ("https://node-42.example.org/logo.jpg", WILD, True),
        ("https://n.s3.bucket.on.aws.org/our/bucket/logo.jpg", WILD, True),
        ("https://myexample.org/logo.jpg", PLAIN, False),
        ("https://myexample.org/logo.jpg", WILD, False),
        ("https://localhost/foo/bar/logo.png", WITH_PATH, True),
        ("https://localhost/wrong/logo.png", WITH_PATH, False),
        ("https://our.company.s3.bucket.on.aws.org/my/bucket/logo.gif",
         WITH_PATH, True),
        ("https://our.company.s3.bucket.on.aws.org/my/bucket/a/b/c/d/e/logo.gif",
         WITH_PATH, True),
        ("https://static.example.org/foo//a//b//c/d/e/logo.webp",
         WITH_PATH, True),
        ("https://no-leading-path-slash.example.org/assets/logo.webp",
         "https://*.example.org/assets", True),
        ("https://no-leading-path-slash.example.org/assetsevil/logo.webp",
         "https://*.example.org/assets", False),
        ("https://some.s3.bucket.on.aws.org/my/bucket1/logo.jpg", TWO_BUCKETS, True),
        ("https://some.s3.bucket.on.aws.org/my/bucket2/logo.jpg", TWO_BUCKETS, True),
        ("https://some.s3.bucket.on.aws.org/my-bucket-name/logo.jpg",
         PATH_WILDCARD, True),
        ("https://some.s3.bucket.on.aws.org/my-other-bucket-name/logo.jpg",
         PATH_WILDCARD, False),
    ])
    def test_matrix(self, url, origins, allowed):
        assert self._restricted(url, origins) is (not allowed)

    @pytest.mark.parametrize("csv", [
        PLAIN, WILD, WITH_PATH, TWO_BUCKETS, PATH_WILDCARD,
        "*.example.org/foo,example.com", "", " , https://a.example/x/ ,"])
    def test_parse_origins_equals_the_reference(self, csv):
        from imaginary_tpu.web.config import parse_origins as reference

        assert parse_origins(csv) == reference(csv)


class TestMaxAllowedSize:
    """source_http_test.go:270-298: a remote image larger than
    --max-allowed-size is refused, by the HEAD Content-Length pre-check
    or by the GET's streaming cap."""

    def test_oversized_remote_rejected(self):
        async def fn(client, origin_url):
            res = await client.get(f"/resize?url={origin_url}/img.jpg&width=100")
            assert res.status == 413
            body = await res.json()
            assert "exceeds maximum allowed" in body["message"]

        run(opts(enable_url_source=True, max_allowed_size=1023), fn,
            origin_handler=serving(fixture_bytes("1024bytes"), "application/octet-stream"))

    def test_within_cap_fetches(self):
        blob = fixture_bytes("imaginary.jpg")

        async def fn(client, origin_url):
            res = await client.get(f"/resize?url={origin_url}/img.jpg&width=100")
            assert res.status == 200

        run(opts(enable_url_source=True, max_allowed_size=len(blob) + 100), fn,
            origin_handler=serving(blob))

    def test_head_failure_degrades_to_capped_get(self):
        async def origin(request):
            if request.method == "HEAD":
                return web.Response(status=403)
            return web.Response(body=fixture_bytes("imaginary.jpg"),
                                content_type="image/jpeg")

        async def fn(client, origin_url):
            res = await client.get(f"/resize?url={origin_url}/img.jpg&width=100")
            assert res.status == 200

        run(opts(enable_url_source=True, max_allowed_size=10_000_000), fn,
            origin_handler=origin)

    def test_head_oversize_still_capped_by_get(self):
        async def origin(request):
            if request.method == "HEAD":
                return web.Response(status=500)
            return web.Response(body=fixture_bytes("1024bytes"),
                                content_type="application/octet-stream")

        async def fn(client, origin_url):
            res = await client.get(f"/resize?url={origin_url}/img.jpg&width=100")
            assert res.status == 413
            assert (await res.json())["message"] == "Entity is too large"

        run(opts(enable_url_source=True, max_allowed_size=1023), fn,
            origin_handler=origin)


class TestSourceFailpoints:
    """The `source.*` cases of tests/test_failpoints.py."""

    def test_source_fetch_site(self):
        failpoints.activate("source.fetch=once(error)")

        async def fn(client, origin_url):
            # the first attempt takes the injected fault; the retry serves
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            assert res.status == 200
            assert failpoints.snapshot()["sites"]["source.fetch"]["fired"] == 1

        run(opts(enable_url_source=True), fn,
            origin_handler=serving(fixture_bytes("imaginary.jpg")))

    def test_source_head_site_degrades(self):
        failpoints.activate("source.head=error")

        async def fn(client, origin_url):
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            assert res.status == 200
            assert failpoints.snapshot()["sites"]["source.head"]["fired"] >= 1

        run(opts(enable_url_source=True, max_allowed_size=10_000_000), fn,
            origin_handler=serving(fixture_bytes("imaginary.jpg")))

    def test_flaky_origin_retries_converge(self):
        """error(0.5) with 4 retries: a request fails with odds 0.5^5."""
        failpoints.activate("source.fetch=error(0.5)")

        async def fn(client, origin_url):
            statuses = []
            for _ in range(20):
                res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
                statuses.append(res.status)
            assert sum(1 for s in statuses if s == 200) >= 15, statuses
            assert all(s in (200, 502) for s in statuses), statuses

        run(opts(enable_url_source=True, source_retries=4), fn,
            origin_handler=serving(fixture_bytes("imaginary.jpg")))

    def test_dead_origin_502_within_budget(self):
        failpoints.activate("source.fetch=error")

        async def fn(client, origin_url):
            t0 = asyncio.get_running_loop().time()
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            elapsed = asyncio.get_running_loop().time() - t0
            assert res.status == 502
            assert "injected error" in (await res.json())["message"]
            assert elapsed < 2.0

        run(opts(enable_url_source=True), fn,
            origin_handler=serving(fixture_bytes("imaginary.jpg")))

    def test_origin_timeout_maps_to_504(self):
        failpoints.activate("source.fetch=timeout(10ms)")

        async def fn(client, origin_url):
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            assert res.status == 504
            assert "timed out" in (await res.json())["message"]

        run(opts(enable_url_source=True, source_retries=1), fn,
            origin_handler=serving(b"unreached"))

    @pytest.mark.parametrize("spec", ["source.fetch=once(error)",
                                      "source.head=timeout(5ms)",
                                      "source.fetch=error(0.25);device.chip_error[1]=error"])
    def test_spec_parses_as_the_references(self, spec):
        from imaginary_tpu import failpoints as reference

        got, want = failpoints.parse(spec), reference.parse(spec)
        assert set(got) == set(want)
        for site, sp in got.items():
            w = want[site]
            assert (sp.kind, sp.p, sp.duration_s, sp.once) == (
                w.kind, w.p, w.duration_s, w.once)


class TestRetries:
    @pytest.mark.parametrize("status,extra", [(503, {"Retry-After": "0"}),
                                              (429, {"Retry-After": "0.05"})])
    def test_retried_then_served(self, status, extra):
        """A 503 or a 429 is retried after at least its Retry-After; the
        second GET serves."""
        gets: list = []

        async def origin(request):
            gets.append(asyncio.get_running_loop().time())
            if len(gets) == 1:
                return web.Response(status=status, headers=extra)
            return web.Response(body=fixture_bytes("imaginary.jpg"),
                                content_type="image/jpeg")

        async def fn(client, origin_url):
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            assert res.status == 200
            assert len(gets) == 2
            assert gets[1] - gets[0] >= float(extra["Retry-After"])

        run(opts(enable_url_source=True), fn, origin_handler=origin)

    def test_403_is_not_retried(self):
        gets: list = []

        async def origin(request):
            gets.append(request.method)
            return web.Response(status=403)

        async def fn(client, origin_url):
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            assert res.status == 502
            assert "status=403" in (await res.json())["message"]
            assert gets == ["GET"]

        run(opts(enable_url_source=True, source_retries=3), fn, origin_handler=origin)

    def test_exhausted_5xx_keeps_the_origin_status(self):
        gets: list = []

        async def origin(request):
            gets.append(request.method)
            return web.Response(status=500)

        async def fn(client, origin_url):
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            assert res.status == 502
            assert "status=500" in (await res.json())["message"]
            assert len(gets) == 3  # the first GET and source_retries = 2

        run(opts(enable_url_source=True), fn, origin_handler=origin)

    def test_refused_connection_retried_then_502(self):
        """A refused connect is a connect-class error: every attempt (one
        `source.fetch` hit each; error(0) never fires) is made, then 502."""
        import socket

        with socket.socket() as s:  # a local port that nothing listens on
            s.bind(("127.0.0.1", 0))
            dead = s.getsockname()[1]
        failpoints.activate("source.fetch=error(0)")

        async def fn(client, _):
            res = await client.get(f"/resize?width=100&url=http://127.0.0.1:{dead}/i.jpg")
            assert res.status == 502
            assert "error fetching remote http image" in (await res.json())["message"]
            assert failpoints.snapshot()["sites"]["source.fetch"]["hits"] == 3

        run(opts(enable_url_source=True), fn)

    def test_read_timeout_answers_504(self):
        async def origin(request):
            await asyncio.sleep(1.0)
            return web.Response(body=fixture_bytes("imaginary.jpg"),
                                content_type="image/jpeg")

        async def fn(client, origin_url):
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            assert res.status == 504
            assert "timed out" in (await res.json())["message"]

        run(opts(enable_url_source=True, source_retries=0, source_read_timeout_s=0.2),
            fn, origin_handler=origin)


class TestForwarding:
    def _seen(self, options, headers) -> dict:
        seen: list = []

        async def fn(client, origin_url):
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg",
                                   headers=headers)
            assert res.status == 200

        run(options, fn, origin_handler=serving(fixture_bytes("imaginary.jpg"), seen=seen))
        assert [m for m, _ in seen] == ["GET"]
        return seen[0][1]

    def test_fixed_authorization_wins(self):
        got = self._seen(opts(enable_url_source=True, auth_forwarding=True,
                              authorization="Bearer fixed"),
                         {"X-Forward-Authorization": "Bearer fwd",
                          "Authorization": "Bearer own"})
        assert got["Authorization"] == "Bearer fixed"

    def test_forward_authorization_over_authorization(self):
        got = self._seen(opts(enable_url_source=True, auth_forwarding=True),
                         {"X-Forward-Authorization": "Bearer fwd",
                          "Authorization": "Bearer own"})
        assert got["Authorization"] == "Bearer fwd"

    def test_authorization_forwarded_alone(self):
        got = self._seen(opts(enable_url_source=True, auth_forwarding=True),
                         {"Authorization": "Bearer own"})
        assert got["Authorization"] == "Bearer own"

    def test_nothing_forwarded_without_the_flag(self):
        got = self._seen(opts(enable_url_source=True),
                         {"Authorization": "Bearer own", "X-Custom": "v"})
        assert "Authorization" not in got and "X-Custom" not in got

    def test_forward_headers(self):
        got = self._seen(opts(enable_url_source=True, forward_headers=("X-Custom", "X-Other")),
                         {"X-Custom": "v1", "X-Unlisted": "v3"})
        assert got["X-Custom"] == "v1"
        assert "X-Other" not in got and "X-Unlisted" not in got

    def test_traceparent_and_request_id_reach_the_origin(self):
        trace_id = "0af7651916cd43dd8448eb211c80319c"
        got = self._seen(opts(enable_url_source=True),
                         {"traceparent": f"00-{trace_id}-b7ad6b7169203331-01",
                          "X-Request-ID": "url-source-1"})
        version, tid, span, flags = got["traceparent"].split("-")
        assert (version, tid, flags) == ("00", trace_id, "01")
        assert span != "b7ad6b7169203331" and len(span) == 16
        assert got["X-Request-ID"] == "url-source-1"

    def test_no_trace_headers_with_tracing_off(self):
        got = self._seen(opts(enable_url_source=True, trace_enabled=False), {})
        assert "traceparent" not in got


class TestWatermarkFetch:
    def test_mark_over_the_cap_answers_413(self):
        """The watermark fetch is capped at 1,000,000 bytes whatever
        --max-allowed-size says."""
        big = b"\x89PNG" + b"\0" * WATERMARK_MAX_BYTES

        async def origin(request):
            return web.Response(body=big, content_type="image/png")

        async def fn(client, origin_url):
            res = await client.post(f"/watermarkimage?image={origin_url}/m.png",
                                    data=fixture_bytes("imaginary.jpg"),
                                    headers={"Content-Type": "image/jpeg"})
            assert res.status == 413
            assert (await res.json())["message"] == "Entity is too large"

        run(opts(), fn, origin_handler=origin)

    def test_mark_outside_the_allow_list_answers_400(self):
        async def fn(client, origin_url):
            res = await client.post(f"/watermarkimage?image={origin_url}/m.png",
                                    data=fixture_bytes("imaginary.jpg"),
                                    headers={"Content-Type": "image/jpeg"})
            assert res.status == 400
            assert (await res.json())["message"] == (
                f"Unable to retrieve watermark image: {origin_url}/m.png")

        run(opts(allowed_origins=parse_origins("https://images.example.com")), fn,
            origin_handler=serving(fixture_bytes("test.png"), "image/png"))

    def test_mark_is_fetched_once_a_request(self):
        seen: list = []

        async def fn(client, origin_url):
            res = await client.post(
                f"/watermarkimage?image={origin_url}/m.png&top=5&left=5&opacity=0.5",
                data=fixture_bytes("imaginary.jpg"), headers={"Content-Type": "image/jpeg"})
            assert res.status == 200
            assert oracle_size(await res.read()) == oracle_size(fixture_bytes("imaginary.jpg"))

        run(opts(), fn, origin_handler=serving(fixture_bytes("test.png"), "image/png",
                                               seen=seen))
        assert [m for m, _ in seen] == ["GET"]


def test_session_closes_with_the_app():
    box: dict = {}

    async def fn(client, origin_url):
        res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
        assert res.status == 200
        source = client.app["service"].registry.http
        assert source in client.app["service"].registry.sources
        box["session"] = source._session
        assert not box["session"].closed

    run(opts(enable_url_source=True), fn,
        origin_handler=serving(fixture_bytes("imaginary.jpg")))
    assert box["session"].closed


def test_a_watermark_fetch_leaves_url_sources_off():
    """Without --enable-url-source a GET ?url= matches no source, before
    and after a watermark image was fetched (the reference's registry
    starts serving ?url= after its first watermark fetch)."""
    from tests.conftest import FIXTURES

    async def fn(client, origin_url):
        get = f"/resize?width=100&url={origin_url}/i.jpg"
        res = await client.get(get)
        assert res.status == 400
        assert (await res.json())["message"] == "missing image source"
        res = await client.post(f"/watermarkimage?image={origin_url}/m.png",
                                data=fixture_bytes("imaginary.jpg"),
                                headers={"Content-Type": "image/jpeg"})
        assert res.status == 200
        res = await client.get(get)
        assert res.status == 400
        assert (await res.json())["message"] == "missing image source"

    run(opts(mount=FIXTURES), fn,
        origin_handler=serving(fixture_bytes("test.png"), "image/png"))


def test_get_needs_a_mount_or_url_sources():
    async def fn(client, _):
        res = await client.get("/resize?width=100&file=large.jpg")
        assert res.status == 405

    run(opts(), fn)
