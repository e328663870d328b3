"""The request deadline of the port (`imaginary_tpu_torch/deadline.py` and
its hops in web/middleware.py, web/handlers.py, web/sources.py,
pipeline.py and engine/executor.py), the four codec and executor
failpoint sites, and the COPIES ledger, on the CPU.

- the arithmetic cases of `tests/test_deadline.py`, each also held
  against the reference's `imaginary_tpu/deadline.py`;
- its HTTP cases on the port's `create_app` (`device="cpu"`); in the
  place of the slow-ring case, whose module comes with a later slice,
  the trace's three deadline fields;
- the same requests to the reference's app (`host_spill=False`: the port
  has no host path) and the port's: the 504 with its `stage` and
  `budget_ms`, the admission 503, the fetch bounded by the deadline on a
  local origin, and the answers with `--request-timeout` off;
- `codec.decode`, `codec.encode`, `executor.submit` and `device.execute`
  armed in both apps: the same status and message;
- the COPIES ledger's decode, transform and encode bytes for one request,
  equal to the reference's.
"""

from __future__ import annotations

import asyncio
import io
import json
import time

import pytest
from aiohttp import web as aioweb
from aiohttp.test_utils import TestClient, TestServer

from imaginary_tpu_torch import deadline as deadline_mod
from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.engine import executor as executor_mod
from imaginary_tpu_torch.engine.timing import COPIES
from imaginary_tpu_torch.errors import DeadlineExceeded
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.web.app import create_app
from imaginary_tpu_torch.web.config import ServerOptions
from tests.conftest import fixture_bytes
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


@pytest.fixture(autouse=True)
def _disarm_failpoints(monkeypatch):
    from imaginary_tpu import failpoints as ref_failpoints

    monkeypatch.setattr(executor_mod, "_LINK_SEED", None)
    yield
    failpoints.deactivate()
    ref_failpoints.deactivate()


@pytest.fixture(scope="module", autouse=True)
def _fixtures(testdata):
    return testdata


def opts(**kw) -> ServerOptions:
    return ServerOptions(device="cpu", **kw)


async def _start_origin(handler):
    app = aioweb.Application()
    app.router.add_route("*", "/{tail:.*}", handler)
    origin = TestServer(app)
    await origin.start_server()
    return origin


def run(options, fn, origin_handler=None, app_factory=create_app):
    """Run `fn(client, origin_url)` against a fresh app (the port's by
    default), with a local origin when `origin_handler` is given."""

    async def runner():
        origin = await _start_origin(origin_handler) if origin_handler else None
        url = f"http://127.0.0.1:{origin.port}" if origin else None
        client = TestClient(TestServer(app_factory(options, log_stream=io.StringIO())))
        await client.start_server()
        try:
            return await fn(client, url)
        finally:
            await client.close()
            if origin is not None:
                await origin.close()

    return asyncio.run(runner())


def run_ref(fields: dict, fn, origin_handler=None):
    from imaginary_tpu.web.app import create_app as ref_app
    from imaginary_tpu.web.config import ServerOptions as RefOptions

    return run(RefOptions(host_spill=False, **fields), fn, origin_handler, ref_app)


def run_port(fields: dict, fn, origin_handler=None):
    return run(opts(**fields), fn, origin_handler)


def _post(client, path="/resize?width=100", headers=None, name="imaginary.jpg"):
    return client.post(path, data=fixture_bytes(name), headers=headers or {})


# --- budget arithmetic (tests/test_deadline.py:36-96) -------------------------

@pytest.mark.parametrize("server_max,header,want", [
    (5.0, "", 5.0),           # the default
    (5.0, "2", 2.0),          # the header lowers
    (5.0, "0.25", 0.25),
    (5.0, "30", 5.0),         # clamped to the server's max
    (0.0, "2", 0.0),          # a header cannot enable what the operator left off
    (5.0, "soon", 5.0),       # garbage falls back to the default
    (5.0, "-1", 5.0),
    (5.0, "0", 5.0),
], ids=["default", "lowers", "lowers-fraction", "clamped", "off-ignores-header",
        "garbage", "negative", "zero"])
def test_resolve_budget(server_max, header, want):
    from imaginary_tpu import deadline as ref

    assert deadline_mod.resolve_budget(server_max, header) == want
    assert ref.resolve_budget(server_max, header) == want


def test_deadline_remaining_and_expiry():
    d = deadline_mod.Deadline(0.05)
    assert 0.0 < d.remaining_s() <= 0.05
    assert not d.expired()
    time.sleep(0.06)
    assert d.expired()
    assert d.remaining_s() < 0.0


def test_checkpoints_record_remaining():
    d = deadline_mod.Deadline(10.0)
    d.note("fetch")
    d.note("queue")
    stages = d.stages_dict()
    assert set(stages) == {"fetch", "queue"}
    assert all(0 < v <= 10_000 for v in stages.values())


def test_checkpoints_bounded_as_the_references():
    from imaginary_tpu import deadline as ref

    d = deadline_mod.Deadline(10.0)
    for i in range(100):
        d.note(f"s{i}")
    assert len(d.checkpoints) == deadline_mod._MAX_CHECKPOINTS == ref._MAX_CHECKPOINTS


def test_check_raises_504_with_breakdown():
    from imaginary_tpu import deadline as ref

    t0 = time.monotonic() - 1.0
    with pytest.raises(DeadlineExceeded) as ei:
        deadline_mod.Deadline(0.001, t0=t0).check("encode")
    err = ei.value
    assert err.http_code() == 504 and err.stage == "encode"
    body = json.loads(err.json_bytes())
    assert body["status"] == 504
    assert body["stage"] == "encode"
    assert body["elapsed_ms"] >= 1000.0
    assert body["budget_ms"] == 1.0
    assert "deadline exceeded at encode" in body["message"]
    want = json.loads(ref.Deadline(0.001, t0=t0).error("encode").json_bytes())
    assert set(body) == set(want) and body["budget_ms"] == want["budget_ms"]


def test_module_check_noop_without_trace():
    deadline_mod.check("anything")  # must not raise outside a request


def test_current_none_without_deadline():
    assert deadline_mod.current() is None


# --- the wire on the port ----------------------------------------------------

class TestDeadlineHTTP:
    def test_off_by_default(self):
        """With --request-timeout unset, X-Request-Timeout is inert."""
        async def fn(client, _):
            res = await _post(client, headers={"X-Request-Timeout": "0.000001"})
            assert res.status == 200

        run(opts(), fn)

    def test_generous_budget_serves_normally(self):
        async def fn(client, _):
            assert (await _post(client)).status == 200

        run(opts(request_timeout_s=30.0), fn)

    def test_header_lowers_budget_to_504(self):
        failpoints.activate("codec.decode=delay(50ms)")

        async def fn(client, _):
            t0 = time.monotonic()
            res = await _post(client, headers={"X-Request-Timeout": "0.001"})
            elapsed = time.monotonic() - t0
            assert res.status == 504
            body = await res.json()
            assert body["budget_ms"] == 1.0
            assert body["elapsed_ms"] >= body["budget_ms"]
            assert "stage" in body
            assert elapsed < 5.0

        run(opts(request_timeout_s=30.0), fn)

    def test_header_cannot_raise_above_server_max(self):
        failpoints.activate("device.execute=delay(300ms)")

        async def fn(client, _):
            t0 = time.monotonic()
            res = await _post(client, headers={"X-Request-Timeout": "30"})
            elapsed = time.monotonic() - t0
            assert res.status == 504
            assert (await res.json())["budget_ms"] == 100.0
            assert elapsed < 3.0

        run(opts(request_timeout_s=0.1), fn)

    def test_slow_device_504_within_budget_plus_tick(self):
        """A 200 ms device delay against a 150 ms budget: a 504 bounded by
        the budget, not by the device; the cancelled item is dropped
        before its launch and its owed MB released, and with the delay
        cleared the same server answers 200 (on a 5 s budget, which a
        loaded test host's CPU chain keeps inside)."""
        failpoints.activate("device.execute=delay(200ms)")

        async def fn(client, _):
            svc = client.app["service"]
            t0 = time.monotonic()
            res = await _post(client, headers={"X-Request-Timeout": "0.15"})
            elapsed = time.monotonic() - t0
            assert res.status == 504
            assert elapsed < 2.0
            body = await res.json()
            assert body["status"] == 504 and "deadline exceeded" in body["message"]
            for _ in range(100):
                if svc.executor.stats.device_owed_mb == 0.0:
                    break
                await asyncio.sleep(0.02)
            assert svc.executor.stats.device_owed_mb == 0.0
            assert svc.executor.stats.items == 0  # dropped before its launch
            failpoints.deactivate()
            assert (await _post(client)).status == 200

        run(opts(request_timeout_s=5.0), fn)

    def test_admission_shed_503_when_queue_exceeds_budget(self):
        async def fn(client, _):
            svc = client.app["service"]
            svc._service_ewma_ms = 10_000.0
            svc._inflight = svc.pool_workers + 50
            res = await _post(client)
            assert res.status == 503
            body = await res.json()
            assert "deadline" in body["message"]
            assert int(res.headers["Retry-After"]) >= 1
            svc._inflight = 0

        run(opts(request_timeout_s=1.0), fn)

    def test_504_vs_503_vs_shed_triple(self):
        failpoints.activate("codec.decode=delay(80ms)")

        async def fn(client, _):
            svc = client.app["service"]
            assert (await _post(client)).status == 200
            late = await _post(client, headers={"X-Request-Timeout": "0.04"})
            assert late.status == 504
            svc._service_ewma_ms = 10_000.0
            svc._inflight = svc.pool_workers + 50
            assert (await _post(client)).status == 503
            svc._inflight = 0

        run(opts(request_timeout_s=5.0), fn)

    def test_cancelled_while_queued_frees_slot(self):
        """A request whose deadline passes while its pool future is still
        queued is cancelled: it answers at its budget, not behind the
        occupant, and the inflight ledger balances back to zero."""
        failpoints.activate("codec.decode=delay(400ms)")

        async def fn(client, _):
            svc = client.app["service"]

            async def expiring():
                await asyncio.sleep(0.08)  # arrive while the worker is busy
                t0 = time.monotonic()
                res = await _post(client, headers={"X-Request-Timeout": "0.1"})
                return res, time.monotonic() - t0

            a, (b, b_elapsed) = await asyncio.gather(_post(client), expiring())
            assert a.status == 200
            assert b.status == 504
            assert b_elapsed < 0.35
            for _ in range(50):
                with svc._inflight_lock:
                    if svc._inflight == 0:
                        break
                await asyncio.sleep(0.02)
            with svc._inflight_lock:
                assert svc._inflight == 0

        run(opts(request_timeout_s=30.0, cpus=1), fn)

    def test_deadline_lands_in_the_trace_fields(self, monkeypatch):
        """The budget, the remaining ms and the stage checkpoints land in
        the request trace's fields."""
        seen = []
        real = obs_trace.activate

        def spy(tr):
            seen.append(tr)
            return real(tr)

        monkeypatch.setattr(obs_trace, "activate", spy)

        async def fn(client, _):
            assert (await _post(client)).status == 200

        run(opts(request_timeout_s=7.0), fn)
        mine = [tr for tr in seen if tr.fields.get("deadline_budget_ms") == 7000.0]
        assert mine, "deadline fields missing from the trace"
        fields = mine[0].fields
        assert 0.0 < fields["deadline_remaining_ms"] <= 7000.0
        stages = fields["deadline_stages"]
        assert {"admission", "queue", "host_pool", "device_queue", "encode"} <= set(stages)

    def test_origin_fetch_bounded_by_deadline(self):
        async def origin(request):
            await asyncio.sleep(2.0)
            return aioweb.Response(body=b"late")

        async def fn(client, origin_url):
            t0 = time.monotonic()
            res = await client.get(f"/resize?width=100&url={origin_url}/img.jpg")
            assert res.status == 504
            assert time.monotonic() - t0 < 3.0

        run(opts(enable_url_source=True, request_timeout_s=0.3, source_retries=0),
            fn, origin_handler=origin)


# --- the port against the reference's app ------------------------------------

def _answers(fields: dict, requests: list, spec: str = "", origin_handler=None) -> tuple:
    """(reference's, port's) [(status, body JSON or bytes, headers)] for
    `requests` ([(method, path, headers, fixture or None)]), with the
    failpoint `spec` armed in each package for its own app."""
    from imaginary_tpu import failpoints as ref_failpoints

    def fn_for(out):
        async def fn(client, url):
            for method, path, headers, name in requests:
                path = path.replace("{origin}", url or "")
                data = fixture_bytes(name) if name else None
                res = await client.request(method, path, data=data, headers=headers)
                body = await res.read()
                if res.content_type == "application/json":
                    # each run has its own origin port
                    body = json.loads(body.decode().replace(url or "{origin}", "{origin}"))
                out.append((res.status, body, dict(res.headers)))
        return fn

    ref, port = [], []
    ref_failpoints.activate(spec)
    try:
        run_ref(fields, fn_for(ref), origin_handler)
    finally:
        ref_failpoints.deactivate()
    failpoints.activate(spec)
    try:
        run_port(fields, fn_for(port), origin_handler)
    finally:
        failpoints.deactivate()
    return ref, port


@pytest.mark.parametrize("fields,spec,headers", [
    ({"request_timeout_s": 0.15}, "device.execute=delay(200ms)", {}),
    ({"request_timeout_s": 0.1}, "device.execute=delay(300ms)", {"X-Request-Timeout": "30"}),
    ({"request_timeout_s": 30.0}, "codec.decode=delay(100ms)", {"X-Request-Timeout": "0.02"}),
], ids=["device-delay", "header-clamped", "header-budget"])
def test_504_stage_and_budget_equal_the_references(fields, spec, headers):
    """The header's budget is 20 ms here, not the 1 ms of the port's own
    case: both apps must reach admission inside it, or each answers at
    `admission` or `queue` by the host's load."""
    req = ("POST", "/resize?width=100", headers, "imaginary.jpg")
    ref, port = _answers(fields, [req], spec)
    (rs, rb, _), (ps, pb, _) = ref[0], port[0]
    assert rs == ps == 504
    assert (pb["stage"], pb["budget_ms"], pb["status"]) == (rb["stage"], rb["budget_ms"],
                                                           rb["status"])
    assert set(pb) == set(rb)


def test_admission_503_equals_the_references(monkeypatch):
    """A backlog past the budget: the same 503, message and Retry-After.
    The backlog is the host pool's (its inflight count at the service
    EWMA), set alike on both services."""
    from imaginary_tpu.web.handlers import ImageService as RefService
    from imaginary_tpu_torch.web.handlers import ImageService as PortService

    monkeypatch.setattr(RefService, "estimated_queue_ms", lambda self: 10_000.0)
    monkeypatch.setattr(PortService, "estimated_queue_ms", lambda self: 10_000.0)
    req = ("POST", "/resize?width=100", {}, "imaginary.jpg")
    ref, port = _answers({"request_timeout_s": 1.0}, [req])
    (rs, rb, rh), (ps, pb, ph) = ref[0], port[0]
    assert rs == ps == 503
    assert pb == rb
    assert ph["Retry-After"] == rh["Retry-After"] == "10"


def test_fetch_bounded_by_the_deadline_equals_the_references():
    async def origin(request):
        await asyncio.sleep(2.0)
        return aioweb.Response(body=b"late")

    fields = {"enable_url_source": True, "request_timeout_s": 0.3, "source_retries": 0}
    req = ("GET", "/resize?width=100&url={origin}/img.jpg", {}, None)
    ref, port = _answers(fields, [req], origin_handler=origin)
    (rs, rb, _), (ps, pb, _) = ref[0], port[0]
    assert rs == ps == 504
    assert pb == rb


@pytest.mark.parametrize("path,name", [
    ("/resize?width=100", "imaginary.jpg"),
    ("/flip?type=png", "test.png"),
    ("/info", "imaginary.jpg"),
    ("/resize?width=100", None),
], ids=["jpeg-resize", "png-flip", "info", "no-body"])
def test_request_timeout_off_leaves_answers_unchanged(path, name):
    """With --request-timeout off, X-Request-Timeout changes nothing: the
    port's answer with the header is byte-equal to its answer without
    it, and JSON answers equal the reference's."""
    method = "POST"
    reqs = [(method, path, {}, name),
            (method, path, {"X-Request-Timeout": "0.000001"}, name)]
    ref, port = _answers({}, reqs)
    assert [a[0] for a in port] == [a[0] for a in ref]
    assert port[0][1] == port[1][1]
    if isinstance(ref[0][1], (dict, list)):
        assert port[0][1] == ref[0][1]


# --- the four new failpoint sites ---------------------------------------------

SITES = ("codec.decode", "codec.encode", "executor.submit", "device.execute")


def test_new_sites_parse_as_the_references():
    from imaginary_tpu import failpoints as ref_failpoints

    for site in SITES:
        for action in ("error", "error(0.5)", "delay(200ms)", "timeout(1s)", "once(error)"):
            spec = f"{site}={action}"
            got, want = failpoints.parse(spec)[site], ref_failpoints.parse(spec)[site]
            assert (got.kind, got.p, got.duration_s, got.once) == (
                want.kind, want.p, want.duration_s, want.once), spec
    with pytest.raises(ValueError, match="delay needs a duration"):
        failpoints.parse("codec.decode=delay")


@pytest.mark.parametrize("site", SITES)
def test_armed_site_answers_as_the_references(site):
    """An error at each site: the same status and message from both apps,
    and the site's hit counted."""
    req = ("POST", "/resize?width=100", {}, "imaginary.jpg")
    ref, port = _answers({}, [req], f"{site}=error")
    (rs, rb, _), (ps, pb, _) = ref[0], port[0]
    assert ps == rs == 400
    assert pb == rb
    assert failpoints.snapshot()["sites"][site]["fired"] == 1


def test_device_execute_error_counts_one_device_failure():
    failpoints.activate("device.execute=once(error)")

    async def fn(client, _):
        svc = client.app["service"]
        assert (await _post(client)).status == 400
        assert svc.executor.stats.device_failures == 1
        assert svc.executor.stats.device_owed_mb == 0.0
        assert (await _post(client)).status == 200

    run(opts(), fn)


@pytest.mark.parametrize("site", ["codec.decode", "codec.encode", "device.execute"])
def test_delay_holds_the_request(site):
    failpoints.activate(f"{site}=delay(300ms)")

    async def fn(client, _):
        t0 = time.monotonic()
        assert (await _post(client)).status == 200
        assert time.monotonic() - t0 >= 0.3

    run(opts(), fn)


# --- the COPIES ledger ----------------------------------------------------------

@pytest.mark.parametrize("path,name,stages", [
    ("/flip?type=png", "test.png", ("decode", "transform", "encode")),
    ("/resize?width=100", "imaginary.jpg", ("decode",)),
], ids=["png-flip", "jpeg-resize"])
def test_copies_for_one_request_equal_the_references(path, name, stages):
    """One request's decode (and, on the exact PNG flip, transform and
    encode) bytes and events, equal to the reference's on the same
    request. Both run their native codecs: the encode stage books the
    body's length, which is the same PNG from the same libpng writer, and
    the JPEG's packed 4:2:0 decode is the same."""
    from imaginary_tpu.engine.timing import COPIES as REF_COPIES

    def one(runner, ledger):
        async def fn(client, _):
            ledger.reset()
            res = await _post(client, path, name=name)
            assert res.status == 200
            await res.read()
            return ledger.snapshot()

        return runner({}, fn)

    want = one(run_ref, REF_COPIES)
    got = one(run_port, COPIES)
    for stage in stages:
        assert got["bytes"][stage] == want["bytes"][stage] > 0, stage
        assert got["copies"][stage] == want["copies"][stage], stage


def test_copies_on_metrics():
    async def fn(client, _):
        COPIES.reset()
        assert (await _post(client, "/flip?type=png", name="test.png")).status == 200
        text = await (await client.get("/metrics")).text()
        snap = COPIES.snapshot()
        for stage in ("decode", "transform", "encode"):
            assert (f'imaginary_tpu_bytes_copied_total{{stage="{stage}"}} '
                    f'{snap["bytes"][stage]}') in text
            assert f'imaginary_tpu_copy_events_total{{stage="{stage}"}} 1' in text
        assert "# TYPE imaginary_tpu_bytes_copied_total counter" in text

    run(opts(), fn)
