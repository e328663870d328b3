"""The port's cache tiers (`imaginary_tpu_torch/cache.py`) held against the
reference's (`imaginary_tpu/cache.py`, `tests/test_cache.py`).

The reference's ten classes run against the port (its app on
`device="cpu"`), with their names: the LRU, keys and ETags, singleflight,
the result tier and 304 over HTTP, coalescing, the frame tier, the source
tier, the oversize remote body, cache-off parity and the /health and
/metrics surface. Beside them, the port is held to the reference on the
same inputs: one put/get/set_budget sequence leaves both LRUs with the
same keys, bytes and evictions; the same request gives the same request
key and strong ETag; and for each tier the two apps answer the same
requests with the same statuses, `ETag`, `Vary` and 304s and count the
same hits. Then the reference's `cache.get` and mid-coalesce failpoint
cases (tests/test_failpoints.py), the local-hit case of
tests/test_host_bytes.py's `TestCacheHitLedgerParity`, and a
singleflight follower whose own deadline runs out while the leader is
held back on the device.

What differs, and why: the port's pool task is `_process_counted` (the
reference's `_process_sync`) and its pipeline call `run` (the reference's
`_process_sync_inner`); and the port books no `ingress` copy (the
reference's streaming ingress is not ported), so a hit's ledger holds
`cache_hit` alone.
"""

from __future__ import annotations

import asyncio
import dataclasses
import io
import json
import random

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from imaginary_tpu import cache as jcache
from imaginary_tpu import failpoints as jfailpoints
from imaginary_tpu.params import build_params_from_query as jparams
from imaginary_tpu_torch import cache as cache_mod
from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.engine.timing import COPIES
from imaginary_tpu_torch.params import build_params_from_query
from imaginary_tpu_torch.web.config import ServerOptions
from tests.conftest import FIXTURES, fixture_bytes
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


@pytest.fixture(scope="module", autouse=True)
def _fixtures(testdata):
    return testdata


@pytest.fixture(autouse=True)
def _disarm():
    yield
    failpoints.deactivate()
    jfailpoints.deactivate()


def run(options, fn, origin_handler=None, ref: bool = False):
    """Run `fn(client, origin_url, app)` against a fresh app: the port's
    on the CPU (`options` a ServerOptions or a dict of its fields), or
    with `ref` the reference's (host spill off, as the port's)."""

    async def runner():
        origin_url = None
        origin = None
        if origin_handler is not None:
            oapp = web.Application()
            oapp.router.add_route("*", "/{tail:.*}", origin_handler)
            origin = TestServer(oapp)
            await origin.start_server()
            origin_url = f"http://127.0.0.1:{origin.port}"
        fields = options if isinstance(options, dict) else None
        if ref:
            from imaginary_tpu.web.app import create_app
            from imaginary_tpu.web.config import ServerOptions as JServerOptions

            app = create_app(JServerOptions(**fields, host_spill=False),
                             log_stream=io.StringIO())
        else:
            from imaginary_tpu_torch.web.app import create_app

            o = ServerOptions(**fields) if fields is not None else options
            app = create_app(dataclasses.replace(o, device="cpu"), log_stream=io.StringIO())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            await fn(client, origin_url, app)
        finally:
            await client.close()
            if origin is not None:
                await origin.close()

    asyncio.run(runner())


def jpg() -> bytes:
    return fixture_bytes("imaginary.jpg")


# --- ByteBudgetLRU unit behavior ---------------------------------------------

class TestByteBudgetLRU:
    def test_hit_miss_and_lru_order(self):
        lru = cache_mod.ByteBudgetLRU(100)
        assert lru.get("a") is None
        lru.put("a", b"xxxx", 40)
        lru.put("b", b"yyyy", 40)
        assert lru.get("a") == b"xxxx"  # refreshes a's recency
        lru.put("c", b"zzzz", 40)  # budget 100: evicts b (LRU), not a
        assert lru.get("b") is None
        assert lru.get("a") == b"xxxx"
        assert lru.get("c") == b"zzzz"

    def test_eviction_respects_byte_budget_and_counts(self):
        evicted = []
        lru = cache_mod.ByteBudgetLRU(100, on_evict=evicted.append)
        for i in range(5):
            lru.put(i, i, 30)  # 5 x 30 > 100: two must go
        assert lru.bytes_used <= 100
        assert sum(evicted) == 2
        assert len(lru) == 3

    def test_oversize_entry_refused(self):
        lru = cache_mod.ByteBudgetLRU(100)
        lru.put("big", b"x", 101)
        assert lru.get("big") is None
        assert lru.bytes_used == 0

    def test_replace_same_key_adjusts_bytes(self):
        lru = cache_mod.ByteBudgetLRU(100)
        lru.put("a", 1, 60)
        lru.put("a", 2, 30)
        assert lru.bytes_used == 30
        assert lru.get("a") == 2

    def test_zero_budget_disabled(self):
        lru = cache_mod.ByteBudgetLRU(0)
        assert not lru.enabled
        lru.put("a", 1, 1)
        assert lru.get("a") is None

    def test_ttl_expiry(self, monkeypatch):
        now = [1000.0]
        monkeypatch.setattr(cache_mod.time, "monotonic", lambda: now[0])
        lru = cache_mod.ByteBudgetLRU(100, ttl_s=5.0)
        lru.put("a", b"v", 10)
        assert lru.get("a") == b"v"
        now[0] += 6.0
        assert lru.get("a") is None
        assert len(lru) == 0


# --- key derivation / ETag ----------------------------------------------------

class TestKeys:
    def test_key_sensitive_to_source_op_and_options(self):
        from imaginary_tpu_torch.options import ImageOptions

        d1 = cache_mod.source_digest(b"abc")
        d2 = cache_mod.source_digest(b"abd")
        o1 = ImageOptions(width=100)
        o2 = ImageOptions(width=101)
        k = cache_mod.request_key
        assert k(d1, "resize", o1) == k(d1, "resize", ImageOptions(width=100))
        assert k(d1, "resize", o1) != k(d2, "resize", o1)
        assert k(d1, "resize", o1) != k(d1, "crop", o1)
        assert k(d1, "resize", o1) != k(d1, "resize", o2)

    def test_key_covers_pipeline_operations(self):
        from imaginary_tpu_torch.options import ImageOptions, PipelineOperation

        d = cache_mod.source_digest(b"abc")
        o1 = ImageOptions(operations=[
            PipelineOperation(name="crop", params={"width": 100})])
        o2 = ImageOptions(operations=[
            PipelineOperation(name="crop", params={"width": 200})])
        assert (cache_mod.request_key(d, "pipeline", o1)
                != cache_mod.request_key(d, "pipeline", o2))

    def test_strong_etag_stable_and_quoted(self):
        from imaginary_tpu_torch.options import ImageOptions

        d = cache_mod.source_digest(b"abc")
        k = cache_mod.request_key(d, "resize", ImageOptions(width=9))
        e1 = cache_mod.strong_etag(k)
        e2 = cache_mod.strong_etag(
            cache_mod.request_key(d, "resize", ImageOptions(width=9)))
        assert e1 == e2
        assert e1.startswith('"') and e1.endswith('"')

    def test_etag_match_list_and_star(self):
        m = cache_mod.etag_matches
        assert m('"abc"', '"abc"')
        assert m('"x", "abc"', '"abc"')
        assert m("*", '"abc"')
        assert not m('W/"abc"', '"abc"')
        assert not m("", '"abc"')


# --- singleflight -------------------------------------------------------------

class TestSingleflight:
    def test_fanout_and_leader_counts(self):
        async def go():
            sf = cache_mod.Singleflight()
            runs = []

            async def thunk():
                runs.append(1)
                await asyncio.sleep(0.05)
                return "v"

            got = await asyncio.gather(*[sf.run("k", thunk) for _ in range(8)])
            assert got == ["v"] * 8
            assert len(runs) == 1
            assert sf.stats.flight_executed == 1
            assert sf.stats.flight_coalesced == 7
            assert sf.inflight() == 0

        asyncio.run(go())

    def test_error_propagates_to_all_waiters(self):
        async def go():
            sf = cache_mod.Singleflight()

            async def thunk():
                await asyncio.sleep(0.02)
                raise ValueError("boom")

            results = await asyncio.gather(
                *[sf.run("k", thunk) for _ in range(4)], return_exceptions=True
            )
            assert all(isinstance(r, ValueError) for r in results)
            assert sf.inflight() == 0

        asyncio.run(go())

    def test_waiter_cancellation_does_not_cancel_group(self):
        async def go():
            sf = cache_mod.Singleflight()
            done = asyncio.Event()

            async def thunk():
                await asyncio.sleep(0.05)
                done.set()
                return "v"

            leader = asyncio.ensure_future(sf.run("k", thunk))
            await asyncio.sleep(0.01)
            waiter = asyncio.ensure_future(sf.run("k", thunk))
            await asyncio.sleep(0.01)
            waiter.cancel()
            # the cancelled waiter detaches; the group still completes and
            # the leader still gets the value
            assert await leader == "v"
            assert done.is_set()
            assert sf.inflight() == 0

        asyncio.run(go())

    def test_leader_request_cancellation_keeps_group_running(self):
        async def go():
            sf = cache_mod.Singleflight()
            done = asyncio.Event()

            async def thunk():
                await asyncio.sleep(0.05)
                done.set()
                return "v"

            leader = asyncio.ensure_future(sf.run("k", thunk))
            await asyncio.sleep(0.01)
            follower = asyncio.ensure_future(sf.run("k", thunk))
            await asyncio.sleep(0.0)
            leader.cancel()
            # the group task is independent of the leader's await: the
            # follower still gets the result
            assert await follower == "v"
            assert done.is_set()
            assert sf.inflight() == 0

        asyncio.run(go())


# --- end-to-end: result cache + ETag over HTTP --------------------------------

def _caches(app):
    return app["service"].caches


class TestResultCacheHTTP:
    def test_hit_serves_identical_bytes_without_second_run(self):
        async def fn(client, _origin, app):
            res1 = await client.post("/resize?width=120&height=80",
                                     data=jpg())
            assert res1.status == 200
            body1 = await res1.read()
            etag = res1.headers.get("ETag")
            assert etag  # result tier on => strong ETag on the response
            res2 = await client.post("/resize?width=120&height=80",
                                     data=jpg())
            body2 = await res2.read()
            assert body2 == body1
            assert res2.headers.get("ETag") == etag
            st = _caches(app).stats
            assert st.result_hits == 1
            assert st.result_misses == 1

        run(ServerOptions(cache_result_mb=8.0), fn)

    def test_distinct_params_distinct_entries(self):
        async def fn(client, _origin, app):
            r1 = await client.post("/resize?width=120&height=80", data=jpg())
            r2 = await client.post("/resize?width=121&height=80", data=jpg())
            assert r1.headers["ETag"] != r2.headers["ETag"]
            assert _caches(app).stats.result_hits == 0
            assert _caches(app).stats.result_misses == 2

        run(ServerOptions(cache_result_mb=8.0), fn)

    def test_if_none_match_304_before_pipeline(self, monkeypatch):
        async def fn(client, _origin, app):
            res1 = await client.get("/resize?width=120&height=80&file=imaginary.jpg")
            assert res1.status == 200
            etag = res1.headers["ETag"]

            # a 304 must answer BEFORE the pipeline runs: poison the
            # process path and prove it is never reached
            from imaginary_tpu_torch.web.handlers import ImageService

            def boom(*a, **k):
                raise AssertionError("pipeline ran on a conditional GET hit")

            monkeypatch.setattr(ImageService, "_process_counted", boom)
            res2 = await client.get(
                "/resize?width=120&height=80&file=imaginary.jpg",
                headers={"If-None-Match": etag},
            )
            assert res2.status == 304
            assert res2.headers["ETag"] == etag
            assert await res2.read() == b""
            assert _caches(app).stats.etag_304 == 1

            # non-matching validator: full 200 (from cache)
            res3 = await client.get(
                "/resize?width=120&height=80&file=imaginary.jpg",
                headers={"If-None-Match": '"deadbeef"'},
            )
            assert res3.status == 200

        run(ServerOptions(cache_result_mb=8.0, mount=FIXTURES), fn)

    def test_eviction_under_byte_budget_http(self):
        # pass 1 measures the bodies, pass 2 sets the budget from the
        # measurement: large enough for any single body, too small for
        # any two (force_host pins placement, as in the reference)
        sizes: dict = {}

        async def measure(client, _origin, app):
            for w in (100, 110, 120):
                res = await client.post(f"/resize?width={w}&height=70",
                                        data=jpg())
                assert res.status == 200
                sizes[w] = len(await res.read())

        run(ServerOptions(force_host=True), measure)
        ordered = sorted(sizes.values())
        budget_bytes = ordered[0] + ordered[1] - 1  # any one fits, no two do
        assert budget_bytes >= max(ordered)

        async def fn(client, _origin, app):
            # at most one entry ever resident: every request must miss
            # and evict its predecessor
            for w in (100, 110, 120, 100, 110, 120):
                res = await client.post(f"/resize?width={w}&height=70",
                                        data=jpg())
                assert res.status == 200
            st = _caches(app).stats
            assert st.result_evictions > 0
            assert st.result_hits == 0
            assert st.result_misses == 6

        run(ServerOptions(cache_result_mb=budget_bytes / 1e6,
                          force_host=True), fn)

    def test_accept_negotiation_keys_separately(self):
        async def fn(client, _origin, app):
            r1 = await client.post("/resize?width=100&type=auto", data=jpg(),
                                   headers={"Accept": "image/png"})
            r2 = await client.post("/resize?width=100&type=auto", data=jpg(),
                                   headers={"Accept": "image/jpeg"})
            assert r1.headers["Content-Type"] == "image/png"
            assert r2.headers["Content-Type"] == "image/jpeg"
            # negotiated outputs must not share an entry or an ETag
            assert r1.headers["ETag"] != r2.headers["ETag"]
            assert _caches(app).stats.result_hits == 0

        run(ServerOptions(cache_result_mb=8.0), fn)


class TestCoalescingHTTP:
    def test_n_identical_concurrent_requests_one_pipeline_run(self):
        async def fn(client, _origin, app):
            from imaginary_tpu_torch.web import handlers as handlers_mod

            runs = []
            inner = handlers_mod.ImageService.run

            def counting(self, *a, **k):
                runs.append(1)
                return inner(self, *a, **k)

            handlers_mod.ImageService.run = counting
            try:
                body = jpg()
                res = await asyncio.gather(*[
                    client.post("/resize?width=140&height=90", data=body)
                    for _ in range(12)
                ])
                assert all(r.status == 200 for r in res)
                bodies = [await r.read() for r in res]
                assert len(set(bodies)) == 1  # one result fanned out
            finally:
                handlers_mod.ImageService.run = inner
            st = _caches(app).stats
            assert len(runs) == 1  # the pipeline executed exactly once
            assert st.flight_executed == 1
            assert st.flight_coalesced == 11
            # the group counted as ONE unit of queue pressure and released it
            assert app["service"]._inflight == 0

        run(ServerOptions(cache_coalesce=True), fn)

    def test_error_fans_out_to_every_waiter_without_inflight_leak(self):
        async def fn(client, _origin, app):
            # /extract without area params raises in the pool thread
            body = jpg()
            res = await asyncio.gather(*[
                client.post("/extract?top=10", data=body) for _ in range(6)
            ])
            assert all(r.status == 400 for r in res)
            payloads = [json.loads(await r.read()) for r in res]
            assert len({p["message"] for p in payloads}) == 1
            assert app["service"]._inflight == 0

        run(ServerOptions(cache_coalesce=True), fn)


class TestFrameCacheHTTP:
    def test_second_request_on_same_source_skips_decode(self):
        async def fn(client, _origin, app):
            # same geometry (=> same shrink-on-load, same frame key) but
            # different encode quality: distinct results, shared frame
            r1 = await client.post("/resize?width=130&height=85&quality=80",
                                   data=jpg())
            r2 = await client.post("/resize?width=130&height=85&quality=55",
                                   data=jpg())
            assert r1.status == 200 and r2.status == 200
            st = _caches(app).stats
            assert st.frame_hits >= 1

        run(ServerOptions(cache_frame_mb=64.0), fn)


class TestSourceCacheHTTP:
    def test_hot_url_fetched_once_per_ttl(self):
        fetches = []

        async def origin(request):
            fetches.append(request.method)
            return web.Response(body=jpg(), content_type="image/jpeg")

        async def fn(client, origin_url, app):
            url = origin_url + "/img.jpg"
            for _ in range(3):
                res = await client.get(f"/resize?width=100&url={url}")
                assert res.status == 200
            st = _caches(app).stats
            assert fetches.count("GET") == 1
            assert st.source_hits == 2
            assert st.source_misses == 1

        run(ServerOptions(enable_url_source=True, cache_source_ttl=60.0),
            fn, origin_handler=origin)

    def test_source_cache_off_fetches_every_time(self):
        fetches = []

        async def origin(request):
            fetches.append(request.method)
            return web.Response(body=jpg(), content_type="image/jpeg")

        async def fn(client, origin_url, app):
            url = origin_url + "/img.jpg"
            for _ in range(2):
                res = await client.get(f"/resize?width=100&url={url}")
                assert res.status == 200
            assert fetches.count("GET") == 2

        run(ServerOptions(enable_url_source=True), fn, origin_handler=origin)


class TestOversizeRemoteBody:
    def test_oversize_streamed_body_rejected_not_truncated(self):
        async def origin(request):
            # chunked response (no Content-Length): the HEAD pre-check
            # cannot catch it, so the streaming guard must
            resp = web.StreamResponse()
            resp.enable_chunked_encoding()
            await resp.prepare(request)
            if request.method != "HEAD":
                await resp.write(b"\xff" * 5000)
            await resp.write_eof()
            return resp

        async def fn(client, origin_url, app):
            res = await client.get(f"/resize?width=100&url={origin_url}/big.jpg")
            # entity-too-large, NOT a 400 corrupt-decode from truncation
            assert res.status == 413
            payload = json.loads(await res.read())
            assert "large" in payload["message"].lower()

        run(ServerOptions(enable_url_source=True, max_allowed_size=1000),
            fn, origin_handler=origin)


class TestCacheOffParity:
    def test_disabled_tiers_are_byte_identical_to_uncached(self):
        bodies = {}

        async def capture(label, client):
            res = await client.post("/resize?width=150&height=100", data=jpg())
            assert res.status == 200
            assert "ETag" not in res.headers or label == "on"
            bodies[label] = await res.read()
            return res

        async def fn_off(client, _origin, app):
            res = await capture("off", client)
            assert "ETag" not in res.headers
            # default options: every tier reads disabled
            c = _caches(app)
            assert not c.result.enabled and not c.frames.enabled
            assert not c.source.enabled and not c.coalesce

        async def fn_off2(client, _origin, app):
            await capture("off2", client)

        async def fn_on(client, _origin, app):
            await capture("on", client)

        run(ServerOptions(), fn_off)
        run(ServerOptions(), fn_off2)
        run(ServerOptions(cache_result_mb=8.0, cache_frame_mb=64.0,
                          cache_coalesce=True), fn_on)
        # deterministic encode: two uncached runs agree, and the cached
        # MISS path produces those same bytes (the cache may never alter
        # response bytes, only skip work)
        assert bodies["off"] == bodies["off2"]
        assert bodies["on"] == bodies["off"]


class TestHealthAndMetricsSurface:
    def test_cache_counters_in_health_and_metrics(self):
        async def fn(client, _origin, app):
            await client.post("/resize?width=100&height=66", data=jpg())
            await client.post("/resize?width=100&height=66", data=jpg())
            health = await (await client.get("/health")).json()
            assert health["cache"]["result_hits"] == 1
            assert health["cache"]["result_misses"] == 1
            assert health["cache"]["result_bytes"] > 0
            text = await (await client.get("/metrics")).text()
            assert "imaginary_tpu_cache_result_hits 1" in text
            assert "imaginary_tpu_cache_result_misses 1" in text

        run(ServerOptions(cache_result_mb=8.0), fn)


# --- the port against the reference on the same inputs -----------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lru_sequence_equals_the_references(seed):
    """One seeded put/get/set_budget sequence leaves both LRUs with the
    same keys in the same order, the same bytes, the same evictions and
    the same lookups."""
    rng = random.Random(seed)
    ev_p, ev_j = [], []
    port = cache_mod.ByteBudgetLRU(500, on_evict=ev_p.append)
    ref = jcache.ByteBudgetLRU(500, on_evict=ev_j.append)
    for _ in range(400):
        op = rng.random()
        k = rng.randrange(24)
        if op < 0.5:
            size = rng.randrange(1, 140)
            port.put(k, k, size)
            ref.put(k, k, size)
        elif op < 0.95:
            assert port.get(k) == ref.get(k)
        else:
            budget = rng.choice((0, 100, 300, 500))
            port.set_budget(budget)
            ref.set_budget(budget)
        assert list(port._map) == list(ref._map)
        assert port.bytes_used == ref.bytes_used
        assert sum(ev_p) == sum(ev_j)


_KEY_QUERIES = [
    ("resize", {"width": "300", "height": "200"}),
    ("resize", {"width": "100", "type": "png"}),
    ("crop", {"width": "300", "height": "260", "gravity": "smart"}),
    ("pipeline", {"operations": json.dumps([
        {"operation": "crop", "params": {"width": 300, "height": 260}},
        {"operation": "convert", "params": {"type": "webp"}}])}),
    ("watermark", {"text": "hi", "opacity": "0.5", "color": "255,200,50"}),
    ("rotate", {"rotate": "90", "flip": "true"}),
    ("resize", {"width": "300", "colorspace": "bw", "extend": "mirror",
                "background": "255,0,0"}),
]


@pytest.mark.parametrize("op,query", _KEY_QUERIES, ids=[q[0] for q in _KEY_QUERIES])
def test_request_key_and_etag_equal_the_references(op, query):
    digest = cache_mod.source_digest(jpg())
    assert digest == jcache.source_digest(jpg())
    key = cache_mod.request_key(digest, op, build_params_from_query(dict(query)))
    want = jcache.request_key(digest, op, jparams(dict(query)))
    assert key == want
    assert cache_mod.strong_etag(key) == jcache.strong_etag(want)
    assert cache_mod.shared_key(key) == jcache.shared_key(want)


async def _origin_handler(request):
    return web.Response(body=fixture_bytes("imaginary.jpg"), content_type="image/jpeg")


# (tier, ServerOptions fields): each tier alone, and the device tier with
# the dct transport it serves
TIERS = [
    ("result", {"cache_result_mb": 8.0, "mount": FIXTURES}),
    ("frame", {"cache_frame_mb": 64.0, "mount": FIXTURES}),
    ("coalesce", {"cache_coalesce": True, "mount": FIXTURES}),
    ("source", {"cache_source_ttl": 60.0, "enable_url_source": True}),
    ("device", {"cache_frame_mb": 64.0, "cache_device_mb": 64.0,
                "transport_dct": True, "mount": FIXTURES}),
]
_COUNTERS = ("result_hits", "result_misses", "frame_hits", "frame_misses",
             "device_hits", "device_misses", "source_hits", "source_misses",
             "etag_304")


@pytest.mark.parametrize("tier,fields", TIERS, ids=[t[0] for t in TIERS])
def test_tier_answers_equal_the_reference_apps(tier, fields):
    """The same requests to both apps: the statuses, `ETag`, `Vary`, the
    304's empty body, the tiers' hit and miss counts after the sequential
    requests and the concurrent identical requests' answers are equal."""
    answers = {}

    def fn_for(side):
        async def fn(client, origin_url, app):
            src = (f"url={origin_url}/i.jpg" if tier == "source"
                   else "file=imaginary.jpg")
            out = []
            for path, headers in (
                    (f"/resize?width=120&height=80&{src}", {}),
                    (f"/resize?width=120&height=80&{src}", {}),
                    (f"/crop?width=120&height=80&{src}", {}),
                    (f"/resize?width=100&type=auto&{src}", {"Accept": "image/png"})):
                res = await client.get(path, headers=headers)
                out.append((res.status, res.headers.get("ETag"), res.headers.get("Vary"),
                            res.headers.get("Content-Type")))
                await res.read()
                etag = res.headers.get("ETag")
                if etag:
                    res = await client.get(path, headers={"If-None-Match": etag, **headers})
                    out.append((res.status, res.headers.get("ETag"),
                                res.headers.get("Vary"), await res.read()))
            h = await (await client.get("/health")).json()
            out.append({k: h["cache"][k] for k in _COUNTERS})
            res = await asyncio.gather(*[
                client.get(f"/resize?width=90&height=60&{src}") for _ in range(6)])
            bodies = [await r.read() for r in res]
            # the concurrent requests' counts follow each app's timing
            # (which of them miss before the first store) and, on the
            # device tier, the reference's power-of-two launch padding
            out.append(([r.status for r in res], len(set(bodies)),
                        {r.headers.get("ETag") for r in res}))
            answers[side] = out

        return fn

    for side in ("ref", "port"):
        run(dict(fields), fn_for(side), origin_handler=_origin_handler, ref=side == "ref")
    assert answers["port"] == answers["ref"]


# --- failpoints (tests/test_failpoints.py) -------------------------------------

def test_cache_get_site_degrades_to_miss():
    """A failing cache tier costs latency, never availability: both the
    cold and would-be-hot request serve 200."""
    failpoints.activate("cache.get=error")

    async def fn(client, _origin, app):
        for _ in range(2):
            res = await client.post("/resize?width=100", data=jpg(),
                                    headers={"Content-Type": "image/jpeg"})
            assert res.status == 200
        assert failpoints.snapshot()["sites"]["cache.get"]["fired"] >= 2
        st = _caches(app).stats
        assert st.result_hits == 0 and st.result_misses == 2

    run(ServerOptions(cache_result_mb=8.0, cache_frame_mb=8.0), fn)


def test_fault_mid_coalesce_fans_out_to_all_waiters():
    """N concurrent identical requests coalesce onto one run; an injected
    decode fault fans the SAME error out to every waiter — no hangs, no
    stragglers, and the group ledger drains."""
    failpoints.activate("codec.decode=error")

    async def fn(client, _origin, app):
        svc = app["service"]
        blob = jpg()

        async def one():
            res = await client.post("/resize?width=100", data=blob)
            return res.status, (await res.json())["message"]

        results = await asyncio.gather(*[one() for _ in range(8)])
        assert all(status == 400 for status, _ in results), results
        assert all("injected error" in msg for _, msg in results)
        # the coalescer's group map drained (no leaked groups)
        assert svc.caches.flight.inflight() == 0
        assert svc._inflight == 0

    run(ServerOptions(cache_coalesce=True), fn)


# --- the byte-touch ledger (tests/test_host_bytes.py) --------------------------

class TestCacheHitLedgerParity:
    def test_local_hit_books_exactly_one_copy(self):
        """A result hit books one cache_hit copy (the single read of the
        stored body) and nothing else; the port books no `ingress`."""
        buf = fixture_bytes("imaginary.jpg")
        got = {}

        async def resize(client):
            COPIES.reset()
            res = await client.post("/resize?width=120&height=80", data=buf,
                                    headers={"Content-Type": "image/jpeg"})
            body = await res.read()
            assert res.status == 200, await res.text()
            return COPIES.snapshot(), body

        async def fn(client, _origin, app):
            got["miss"], miss_body = await resize(client)
            got["hit"], hit_body = await resize(client)
            assert hit_body == miss_body
            got["served"] = len(hit_body)

        run(ServerOptions(cache_result_mb=16.0), fn)
        hit = got["hit"]
        assert set(hit["copies"]) == {"cache_hit"}
        assert hit["copies"]["cache_hit"] == 1
        assert hit["bytes"]["cache_hit"] == got["served"]
        # the miss ran the pipeline: decode and encode booked real bytes
        assert got["miss"]["bytes"].get("decode", 0) > 0
        assert got["miss"]["bytes"].get("encode", 0) > 0


# --- the coalesce wait under a request deadline --------------------------------

def test_follower_deadline_expires_in_the_coalesce_wait():
    """The leader is held back on the device (`device.slow`); a follower
    whose own X-Request-Timeout runs out in the coalesce wait answers 504
    at stage `queue`, its trace marked coalesced with a `coalesce_wait`
    span; the leader's run is not cancelled, the other waiters get 200,
    and nothing stays owed at rest."""
    failpoints.activate("device.slow=delay(600ms)")
    path = "/resize?width=120&height=80&file=imaginary.jpg"

    async def fn(client, _origin, app):
        svc = app["service"]
        leader = asyncio.ensure_future(client.get(path, headers={"X-Request-Timeout": "30"}))
        await asyncio.sleep(0.2)
        others = [asyncio.ensure_future(client.get(path, headers={"X-Request-Timeout": "30"}))
                  for _ in range(3)]
        short = await client.get(path, headers={"X-Request-Timeout": "0.1"})
        body = await short.json()
        assert short.status == 504 and body["stage"] == "queue"
        assert "coalesce_wait" in short.headers.get("Server-Timing", "")
        res = await asyncio.gather(leader, *others)
        assert [r.status for r in res] == [200] * 4
        assert len({await r.read() for r in res}) == 1
        st = svc.caches.stats
        assert st.flight_executed == 1 and st.flight_coalesced == 4
        assert svc._inflight == 0
        stats = svc.executor.stats.to_dict()
        assert stats["device_owed_mb"] == 0 and stats["host_inflight"] == 0

    run(ServerOptions(cache_coalesce=True, request_timeout_s=30.0, mount=FIXTURES), fn)
