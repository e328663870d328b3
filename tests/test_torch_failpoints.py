"""The port's failpoint harness (`imaginary_tpu_torch/failpoints.py`): a port
copy of tests/test_failpoints.py's five classes, on apps and executors of
`device="cpu"` whose kernels are the plain versions, plus the operator
surface held against the reference's: the /debugz/failpoints GET and PUT
bodies key for key under one spec, arming from IMAGINARY_TPU_FAILPOINTS
through both packages' `create_app`, and a bad spec failing both.

Adapted where the port differs:
- the reference's wall-clock bound on 200,000 disarmed hits becomes an
  assertion of the disarmed path's work (no lock taken, no counter
  touched, no random draw), which no load on the host can break;
- the breaker's host failover runs with `host_spill=None`, the
  reference's auto default (the port's own default, off, answers a
  struck card's error without the host: its case follows the copy).
"""

import asyncio
import io
import os
import socket
import subprocess
import sys
import time

import pytest
from aiohttp import web as aioweb
from aiohttp.test_utils import TestClient, TestServer

from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.web.app import create_app
from imaginary_tpu_torch.web.config import ServerOptions
from tests.conftest import fixture_bytes
from tests.test_torch_http import multipart_jpg
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the acceptance spec: an error that never fires and a keyed delay
ENV_SPEC = "codec.encode=error(0.0);device.slow[0]=delay(1ms)"


@pytest.fixture(autouse=True)
def _disarm(monkeypatch):
    from imaginary_tpu import failpoints as ref_failpoints

    monkeypatch.delenv(failpoints.ENV_VAR, raising=False)
    failpoints.deactivate()
    ref_failpoints.deactivate()
    yield
    failpoints.deactivate()
    ref_failpoints.deactivate()


@pytest.fixture(scope="module", autouse=True)
def _fixtures(testdata):
    return testdata


def opts(**kw) -> ServerOptions:
    return ServerOptions(device="cpu", **kw)


def run(options, fn, origin_handler=None, app_factory=create_app):
    """Run `fn(client, origin_url)` against a fresh app (the port's by
    default), with a local origin serving `origin_handler` when given."""

    async def runner():
        origin = origin_url = None
        if origin_handler is not None:
            oapp = aioweb.Application()
            oapp.router.add_route("*", "/{tail:.*}", origin_handler)
            origin = TestServer(oapp)
            await origin.start_server()
            origin_url = f"http://127.0.0.1:{origin.port}"
        client = TestClient(TestServer(app_factory(options, log_stream=io.StringIO())))
        await client.start_server()
        try:
            return await fn(client, origin_url)
        finally:
            await client.close()
            if origin is not None:
                await origin.close()

    return asyncio.run(runner())


def run_ref(fn, **fields):
    from imaginary_tpu.web.app import create_app as ref_app
    from imaginary_tpu.web.config import ServerOptions as RefOptions

    return run(RefOptions(host_spill=False, **fields), fn, app_factory=ref_app)


async def _jpeg_origin(request):
    return aioweb.Response(body=fixture_bytes("imaginary.jpg"), content_type="image/jpeg")


class TestSpecParsing:
    def test_basic_clauses(self):
        parsed = failpoints.parse("source.fetch=error(0.5);device.execute=delay(200ms)")
        assert parsed["source.fetch"].kind == "error"
        assert parsed["source.fetch"].p == 0.5
        assert parsed["device.execute"].kind == "delay"
        assert parsed["device.execute"].duration_s == pytest.approx(0.2)

    def test_error_defaults_p1(self):
        assert failpoints.parse("codec.decode=error")["codec.decode"].p == 1.0

    def test_durations(self):
        assert failpoints.parse("cache.get=delay(1.5s)")["cache.get"].duration_s == 1.5
        assert failpoints.parse("cache.get=timeout(50ms)")["cache.get"].duration_s == 0.05
        assert failpoints.parse("cache.get=timeout")["cache.get"].duration_s == 60.0

    def test_once_wrapper(self):
        sp = failpoints.parse("source.fetch=once(error)")["source.fetch"]
        assert sp.kind == "error" and sp.once

    def test_unknown_site_rejected(self):
        with pytest.raises(ValueError, match="unknown failpoint site"):
            failpoints.parse("bogus.site=error")

    def test_unknown_action_rejected(self):
        with pytest.raises(ValueError, match="unknown failpoint action"):
            failpoints.parse("source.fetch=explode")

    def test_malformed_rejected(self):
        for spec in ("source.fetch", "source.fetch=delay", "source.fetch=error(2.0)",
                     "source.fetch=delay(10)"):
            with pytest.raises(ValueError):
                failpoints.parse(spec)

    def test_empty_spec_disarms(self):
        failpoints.activate("source.fetch=error")
        failpoints.activate("")
        assert not failpoints.snapshot()["enabled"]

    def test_active_spec_round_trips(self):
        spec = "source.fetch=error(0.5);device.execute=delay(200ms)"
        failpoints.activate(spec)
        assert failpoints.parse(failpoints.active_spec()).keys() == \
            failpoints.parse(spec).keys()

    def test_activate_from_env(self):
        assert failpoints.ENV_VAR == "IMAGINARY_TPU_FAILPOINTS"
        assert not failpoints.activate_from_env({"OTHER": "x"})
        assert not failpoints.snapshot()["enabled"]
        assert failpoints.activate_from_env({failpoints.ENV_VAR: "codec.encode=error"})
        assert failpoints.snapshot()["sites"]["codec.encode"]["action"] == "error"

    def test_bad_env_spec_fails_loudly(self):
        with pytest.raises(ValueError):
            failpoints.activate_from_env({failpoints.ENV_VAR: "nope=error"})

    @pytest.mark.parametrize("spec", [
        ENV_SPEC,
        "source.fetch=once(error(0.25));peer.health[host-b]=error",
        "device.chip_error[1]=timeout(5ms);worker.hang=delay(1.5s)",
        "",
    ], ids=["acceptance", "once-nested", "keyed-timeout", "empty"])
    def test_parse_and_active_spec_equal_the_references(self, spec):
        from imaginary_tpu import failpoints as ref

        want = ref.parse(spec)
        got = failpoints.parse(spec)
        assert {k: (v.kind, v.p, v.duration_s, v.once, v.raw) for k, v in got.items()} == \
            {k: (v.kind, v.p, v.duration_s, v.once, v.raw) for k, v in want.items()}
        failpoints.activate(spec)
        ref.activate(spec)
        assert failpoints.active_spec() == ref.active_spec()

    def test_sites_are_the_references_in_its_order(self):
        from imaginary_tpu import failpoints as ref

        assert failpoints.SITES == ref.SITES


class TestActionsAndOverhead:
    def test_disarmed_is_noop(self):
        failpoints.hit("source.fetch")
        asyncio.run(failpoints.ahit("source.fetch"))

    def test_disarmed_path_takes_no_lock_and_touches_no_counter(self, monkeypatch):
        """The off path is one falsy check of the active map: no lock, no
        counter, no random draw. (The reference bounds 200,000 disarmed
        hits by wall time; this asserts the work instead.)"""

        class Refusing:
            def __enter__(self):
                raise AssertionError("the disarmed path took the lock")

            def __exit__(self, *exc):
                return False

        failpoints.activate("codec.decode=error(0.0)")
        failpoints.deactivate()
        counts = failpoints._counts
        before = {k: list(v) for k, v in counts.items()}
        with monkeypatch.context() as m:
            m.setattr(failpoints, "_lock", Refusing())
            m.setattr(failpoints.random, "random",
                      lambda: pytest.fail("the disarmed path drew a number"))
            for site in failpoints.SITES:
                failpoints.hit(site)
                failpoints.hit(site, key=0)
                asyncio.run(failpoints.ahit(site))
                assert failpoints._decide(site) is None
        assert failpoints._counts is counts
        assert {k: list(v) for k, v in counts.items()} == before
        assert failpoints._active == {}

    def test_error_raises(self):
        failpoints.activate("codec.decode=error")
        with pytest.raises(failpoints.FailpointError):
            failpoints.hit("codec.decode")
        failpoints.hit("codec.encode")  # other sites untouched

    def test_error_probability_zero_never_fires(self):
        failpoints.activate("codec.decode=error(0.0)")
        for _ in range(100):
            failpoints.hit("codec.decode")
        snap = failpoints.snapshot()["sites"]["codec.decode"]
        assert snap["hits"] == 100 and snap["fired"] == 0

    def test_once_fires_exactly_once(self):
        failpoints.activate("codec.decode=once(error)")
        with pytest.raises(failpoints.FailpointError):
            failpoints.hit("codec.decode")
        failpoints.hit("codec.decode")  # spent: a no-op
        snap = failpoints.snapshot()
        assert snap["sites"]["codec.decode"]["fired"] == 1
        assert snap["sites"]["codec.decode"]["action"] == "(spent)"
        assert snap["spec"] == ""

    def test_delay_sleeps_then_continues(self):
        failpoints.activate("codec.decode=delay(50ms)")
        t0 = time.monotonic()
        failpoints.hit("codec.decode")
        assert time.monotonic() - t0 >= 0.045

    def test_timeout_sync_raises_timeout_error(self):
        failpoints.activate("codec.decode=timeout(10ms)")
        with pytest.raises(TimeoutError):
            failpoints.hit("codec.decode")

    def test_timeout_async_raises_asyncio_timeout(self):
        failpoints.activate("source.fetch=timeout(10ms)")
        with pytest.raises(asyncio.TimeoutError):
            asyncio.run(failpoints.ahit("source.fetch"))


class TestEverySiteReachable:
    """Each site armed with error(1.0), its effect observed through the
    port's serving stack: reachability and the degradation policy at that
    boundary."""

    def test_source_fetch_site(self):
        failpoints.activate("source.fetch=once(error)")

        async def fn(client, origin_url):
            # the first attempt eats the fault; the retry serves
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            assert res.status == 200
            assert failpoints.snapshot()["sites"]["source.fetch"]["fired"] == 1

        run(opts(enable_url_source=True), fn, origin_handler=_jpeg_origin)

    def test_source_head_site_degrades(self):
        failpoints.activate("source.head=error")

        async def fn(client, origin_url):
            # the HEAD pre-check faulted: the size-capped GET serves anyway
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            assert res.status == 200
            assert failpoints.snapshot()["sites"]["source.head"]["fired"] >= 1

        run(opts(enable_url_source=True, max_allowed_size=10_000_000), fn,
            origin_handler=_jpeg_origin)

    def test_codec_decode_site(self):
        failpoints.activate("codec.decode=error")

        async def fn(client, _):
            res = await client.post("/resize?width=100", data=fixture_bytes("imaginary.jpg"))
            assert res.status == 400
            assert "injected error" in (await res.json())["message"]

        run(opts(), fn)

    def test_executor_submit_site(self):
        failpoints.activate("executor.submit=error")

        async def fn(client, _):
            res = await client.post("/resize?width=100", data=fixture_bytes("imaginary.jpg"))
            assert res.status == 400

        run(opts(), fn)

    def test_device_execute_site_trips_breaker_to_host(self):
        """Injected device failures surface per request until the
        breaker's threshold, then host failover serves 200s (host
        placement on, the reference's auto)."""
        failpoints.activate("device.execute=error")

        async def fn(client, _):
            svc = client.app["service"]
            statuses = []
            for _ in range(6):
                res = await client.post("/resize?width=100",
                                        data=fixture_bytes("imaginary.jpg"))
                statuses.append(res.status)
                if res.status == 200:
                    assert res.headers.get("X-Imaginary-Backend") == "host"
                    break
            assert statuses[-1] == 200, statuses
            assert all(s == 400 for s in statuses[:-1]), statuses
            assert svc.executor.stats.breaker_opens >= 1
            assert svc.executor.stats.breaker_host_served >= 1

        run(opts(host_spill=None), fn)

    def test_device_execute_site_with_host_spill_off_answers_the_error(self):
        """The port's default: the breaker opens, and the host serves
        nothing."""
        failpoints.activate("device.execute=error")

        async def fn(client, _):
            svc = client.app["service"]
            for _ in range(4):
                res = await client.post("/resize?width=100",
                                        data=fixture_bytes("imaginary.jpg"))
                assert res.status == 400
            assert svc.executor.stats.breaker_opens >= 1
            assert svc.executor.stats.breaker_host_served == 0

        run(opts(), fn)

    def test_host_spill_site_falls_back_to_device(self):
        """A faulted spill does not fail the request: it books a spill
        error and rides the device path."""
        failpoints.activate("host.spill=error")

        async def fn(client, _):
            svc = client.app["service"]
            res = await client.post("/resize?width=100", data=fixture_bytes("imaginary.jpg"))
            assert res.status == 200
            assert res.headers.get("X-Imaginary-Backend") == "device"
            assert svc.executor.stats.spill_errors >= 1

        run(opts(force_host=True), fn)

    def test_codec_encode_site(self):
        failpoints.activate("codec.encode=error")

        async def fn(client, _):
            res = await client.post("/resize?width=100", data=fixture_bytes("imaginary.jpg"))
            assert res.status == 400

        run(opts(), fn)

    def test_cache_get_site_degrades_to_miss(self):
        """A failing cache tier costs latency, never availability."""
        failpoints.activate("cache.get=error")

        async def fn(client, _):
            for _ in range(2):
                res = await client.post("/resize?width=100", data=multipart_jpg())
                assert res.status == 200
            assert failpoints.snapshot()["sites"]["cache.get"]["fired"] >= 2

        run(opts(cache_result_mb=8.0, cache_frame_mb=8.0), fn)


class TestChaosScenarios:
    def test_flaky_origin_retries_converge(self):
        """source.fetch=error(0.5) with four retries: a request fails
        with odds 0.5^5 (about 3 %)."""
        failpoints.activate("source.fetch=error(0.5)")

        async def fn(client, origin_url):
            statuses = []
            for _ in range(20):
                res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
                statuses.append(res.status)
            assert sum(1 for s in statuses if s == 200) >= 15, statuses
            assert all(s in (200, 502) for s in statuses), statuses

        run(opts(enable_url_source=True, source_retries=4), fn, origin_handler=_jpeg_origin)

    def test_dead_origin_502_within_budget(self):
        """error(1.0): the retries run out and the request maps to 502
        inside the request deadline."""
        failpoints.activate("source.fetch=error")

        async def fn(client, origin_url):
            t0 = time.monotonic()
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            elapsed = time.monotonic() - t0
            assert res.status == 502
            assert "injected error" in (await res.json())["message"]
            assert elapsed < 2.0

        run(opts(enable_url_source=True, request_timeout_s=2.0), fn,
            origin_handler=_jpeg_origin)

    def test_origin_timeout_maps_to_504(self):
        failpoints.activate("source.fetch=timeout(10ms)")

        async def origin(request):
            return aioweb.Response(body=b"unreached")

        async def fn(client, origin_url):
            res = await client.get(f"/resize?width=100&url={origin_url}/i.jpg")
            assert res.status == 504
            assert "timed out" in (await res.json())["message"]

        run(opts(enable_url_source=True, source_retries=1), fn, origin_handler=origin)

    def test_fault_mid_coalesce_fans_out_to_all_waiters(self):
        """Eight identical requests coalesce onto one run: an injected
        decode fault fans the same error out to every waiter, and the
        group map drains."""
        failpoints.activate("codec.decode=error")

        async def fn(client, _):
            svc = client.app["service"]
            blob = fixture_bytes("imaginary.jpg")

            async def one():
                res = await client.post("/resize?width=100", data=blob)
                return res.status, (await res.json())["message"]

            results = await asyncio.gather(*[one() for _ in range(8)])
            assert all(status == 400 for status, _ in results), results
            assert all("injected error" in msg for _, msg in results)
            assert svc.caches.flight.inflight() == 0

        run(opts(cache_coalesce=True), fn)

    def test_breaker_invariants_under_concurrent_chaos(self):
        """Concurrent traffic against a dead device: every request
        resolves (400 until the breaker opens, then host-served 200),
        nothing hangs, and the ledgers return to rest."""
        failpoints.activate("device.execute=error")

        async def fn(client, _):
            svc = client.app["service"]
            blob = fixture_bytes("imaginary.jpg")

            async def one(i):
                res = await client.post(f"/resize?width=10{i % 3}", data=blob)
                return res.status

            statuses = await asyncio.gather(*[one(i) for i in range(12)])
            assert all(s in (200, 400) for s in statuses), statuses
            assert 200 in statuses
            for _ in range(50):
                with svc._inflight_lock:
                    if svc._inflight == 0:
                        break
                await asyncio.sleep(0.02)
            with svc._inflight_lock:
                assert svc._inflight == 0
            assert svc.executor.estimated_wait_ms() == pytest.approx(0.0, abs=1e-6)

        run(opts(host_spill=None), fn)


class TestDebugzControlSurface:
    def test_get_put_round_trip(self):
        async def fn(client, _):
            res = await client.put("/debugz/failpoints", data="codec.decode=error")
            assert res.status == 200
            body = await res.json()
            assert body["enabled"] and "codec.decode" in body["sites"]
            assert body["spec"] == "codec.decode=error"
            assert body["known_sites"] == list(failpoints.SITES)

            bad = await client.post("/resize?width=100", data=fixture_bytes("imaginary.jpg"))
            assert bad.status == 400

            snap = await (await client.get("/debugz/failpoints")).json()
            assert snap["sites"]["codec.decode"]["fired"] >= 1

            res = await client.put("/debugz/failpoints", data="")
            body = await res.json()
            assert body["enabled"] is False and body["spec"] == ""

            ok = await client.post("/resize?width=100", data=fixture_bytes("imaginary.jpg"))
            assert ok.status == 200

        run(opts(enable_debug=True), fn)

    def test_bad_spec_rejected_400(self):
        async def fn(client, _):
            res = await client.put("/debugz/failpoints", data="nope=error")
            assert res.status == 400
            assert "unknown failpoint site" in (await res.json())["error"]

        run(opts(enable_debug=True), fn)

    def test_gated_behind_enable_debug(self):
        async def fn(client, _):
            assert (await client.get("/debugz/failpoints")).status == 404
            res = await client.put("/debugz/failpoints", data="codec.decode=error")
            assert res.status == 405  # a gated PUT never validates
            assert not failpoints.snapshot()["enabled"]

        run(opts(), fn)

    def test_env_arming_through_create_app(self, monkeypatch):
        monkeypatch.setenv(failpoints.ENV_VAR, "codec.encode=error(0.0)")

        async def fn(client, _):
            assert failpoints.snapshot()["enabled"]
            assert "codec.encode" in failpoints.snapshot()["sites"]

        run(opts(), fn)

    def test_import_alone_arms_nothing(self):
        env = dict(os.environ, **{failpoints.ENV_VAR: "codec.encode=error"})
        code = ("import imaginary_tpu_torch.web.app\n"
                "from imaginary_tpu_torch import failpoints\n"
                "assert not failpoints.snapshot()['enabled']\n")
        subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, check=True,
                       timeout=120)

    def test_failpoints_in_debugz_payload(self):
        failpoints.activate("codec.decode=error(0.0)")

        async def fn(client, _):
            body = await (await client.get("/debugz")).json()
            assert body["failpoints"]["enabled"]
            assert "codec.decode" in body["failpoints"]["sites"]
            assert body["failpoints"]["known_sites"] == list(failpoints.SITES)

        run(opts(enable_debug=True), fn)


# --- the operator surface against the reference's -----------------------------

def _failpoint_bodies(spec_put: str, post: bool):
    """[GET before traffic, PUT `spec_put`, GET after one /resize] bodies of
    /debugz/failpoints; `post` sends the /resize between the PUT and the
    last GET."""

    async def fn(client, _):
        out = [await (await client.get("/debugz/failpoints")).json()]
        res = await client.put("/debugz/failpoints", data=spec_put)
        out.append((res.status, await res.json()))
        if post:
            assert (await client.post("/resize?width=100",
                                      data=fixture_bytes("imaginary.jpg"))).status == 200
        out.append(await (await client.get("/debugz/failpoints")).json())
        return out

    return fn


def test_debugz_failpoints_bodies_equal_the_references(monkeypatch):
    """Both apps built with IMAGINARY_TPU_FAILPOINTS set: the GET bodies
    have the same keys, spec, known_sites and sites; a PUT of a new spec
    answers the same body; after one /resize each app counts the same hit
    at codec.encode."""
    from imaginary_tpu import failpoints as ref_failpoints

    monkeypatch.setenv(failpoints.ENV_VAR, ENV_SPEC)
    put = "codec.encode=error(0.0);source.fetch=once(error)"
    ref = run_ref(_failpoint_bodies(put, post=True), enable_debug=True)
    ref_failpoints.deactivate()
    port = run(opts(enable_debug=True), _failpoint_bodies(put, post=True))
    assert set(port[0]) == set(ref[0]) == {"enabled", "spec", "sites", "known_sites"}
    assert port[0] == ref[0]
    assert port[0]["spec"] == ENV_SPEC
    assert port[0]["known_sites"] == ref[0]["known_sites"] == list(failpoints.SITES)
    assert port[1] == ref[1]
    assert port[2]["spec"] == ref[2]["spec"] == put
    assert port[2]["sites"]["codec.encode"] == ref[2]["sites"]["codec.encode"] == \
        {"action": "error(0.0)", "hits": 1, "fired": 0}
    assert port[2]["known_sites"] == ref[2]["known_sites"]


def test_bad_put_answers_equal_the_references():
    def fn_for(out):
        async def fn(client, _):
            for spec in ("nope=error", "codec.decode=explode", "codec.decode"):
                res = await client.put("/debugz/failpoints", data=spec)
                out.append((res.status, await res.json()))
        return fn

    ref, port = [], []
    run_ref(fn_for(ref), enable_debug=True)
    run(opts(enable_debug=True), fn_for(port))
    assert port == ref
    assert all(status == 400 for status, _ in port)


def test_env_arming_equals_the_references(monkeypatch):
    """create_app arms each package's failpoints from the variable, to
    the same snapshot."""
    from imaginary_tpu import failpoints as ref_failpoints

    monkeypatch.setenv(failpoints.ENV_VAR, ENV_SPEC)

    async def noop(client, _):
        return None

    run_ref(noop)
    run(opts(), noop)
    assert failpoints.snapshot() == ref_failpoints.snapshot()
    assert failpoints.active_spec() == ref_failpoints.active_spec() == ENV_SPEC


@pytest.mark.parametrize("spec", ["nope=error", "codec.encode=explode",
                                  "device.slow[0]=delay(5)"],
                         ids=["site", "action", "duration"])
def test_bad_env_spec_fails_both_create_apps(monkeypatch, spec):
    from imaginary_tpu.web.app import create_app as ref_app
    from imaginary_tpu.web.config import ServerOptions as RefOptions

    monkeypatch.setenv(failpoints.ENV_VAR, spec)
    with pytest.raises(ValueError) as ref_err:
        ref_app(RefOptions(host_spill=False), log_stream=io.StringIO())
    with pytest.raises(ValueError) as port_err:
        create_app(opts(), log_stream=io.StringIO())
    assert str(port_err.value) == str(ref_err.value)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_bad_env_spec_fails_the_boot():
    """`python -m imaginary_tpu_torch` with a bad spec exits non-zero
    before it binds, naming the bad site."""
    env = dict(os.environ, **{failpoints.ENV_VAR: "nope=error"})
    env.pop("IMAGINARY_TPU_WORKERS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "imaginary_tpu_torch", "--device", "cpu", "--port",
         str(_free_port()), "--log-level", "error"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "unknown failpoint site 'nope'" in proc.stderr


def test_workers_inherit_the_spec_and_each_arms(monkeypatch):
    """A --workers supervisor hands each worker its own environment, the
    variable included, and each worker arms when it assembles its app, as
    the reference's do."""
    from imaginary_tpu_torch.web import workers

    seen = {}

    class FakePopen:
        def __init__(self, argv, env=None, **kw):
            seen["argv"], seen["env"] = argv, env

    monkeypatch.setenv(failpoints.ENV_VAR, ENV_SPEC)
    monkeypatch.setattr(workers.subprocess, "Popen", FakePopen)
    workers._spawn(["--device", "cpu"], 1, epoch=3)
    assert seen["env"][failpoints.ENV_VAR] == ENV_SPEC
    assert seen["env"][workers.WORKER_ENV] == "1"
    # the worker's own assembly, in the environment it was given
    monkeypatch.setenv(workers.WORKER_ENV, "1")
    create_app(opts(), log_stream=io.StringIO())["service"].close()
    assert failpoints.active_spec() == ENV_SPEC
