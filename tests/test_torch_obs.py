"""The port's observability planes (imaginary_tpu_torch/obs/ and their web
and engine wiring) against the reference's, on the CPU.

- port copies of `tests/test_obs.py`'s classes for the ported modules,
  on the port's `create_app` (`device="cpu"`): the trace's wide-event
  methods, wide events, /debugz with its torch.profiler capture, the
  slow ring, tail sampling, exemplars, the SLO engine and its surfaces,
  the cost plane and its surfaces, and the loop-lag probe; where a class
  is pure arithmetic (classify, the SLO engine, the cost plane's parsing
  and booking) each case is also held against the reference's module;
- the two traps of the port: the cost plane reads the port's ms/MB EWMA
  (`Executor._ms_per_mb`), so advise() carries `device_ms_per_mb` and
  `link_rate` after drains where the reference's copy would read
  nothing, and the drain's `device_wait` split (the capacity plane's
  `link_stall`) is booked only while a plane is armed;
- a capture on a CUDA server whose profiler saw no card activity answers
  500 and writes no trace;
- the port's copy of `tests/test_deadline.py`'s
  test_deadline_lands_in_wide_event_surfaces;
- a parity group: the same requests to the reference's app (host_spill
  off: the port has no host path) and the port's with every plane armed:
  the wide events' field names (the supervisor's `worker` and `epoch`
  among them), the `slo` and `capacity`
  key sets of /health, the new /metrics families and their types,
  /topz's keys, and the 404s of the gates with every plane off.
"""

from __future__ import annotations

import asyncio
import io
import json
import os
import re
import secrets
import threading

import pytest
from aiohttp.test_utils import TestClient, TestServer

from imaginary_tpu_torch.engine import executor as executor_mod
from imaginary_tpu_torch.obs import cost as cost_mod
from imaginary_tpu_torch.obs import debugz as obs_debugz
from imaginary_tpu_torch.obs import events as obs_events
from imaginary_tpu_torch.obs import slo as slo_mod
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.web.app import create_app
from imaginary_tpu_torch.web.config import ServerOptions
from tests.conftest import FIXTURES, fixture_bytes
from tests.test_obs import check_histograms, parse_exposition_strict

SLO = '{"*": {"latency_ms": 500, "latency_target": 0.99, "availability": 0.999}}'


@pytest.fixture(scope="module", autouse=True)
def _fixtures(testdata):
    return testdata


@pytest.fixture(autouse=True)
def _disarm_planes():
    """No cost plane outlives its test, the port's or the reference's."""
    from imaginary_tpu.obs import cost as ref_cost

    yield
    cost_mod.install(None)
    ref_cost.install(None)


def opts(**kw) -> ServerOptions:
    return ServerOptions(device="cpu", **kw)


def run(options, fn, log_stream=None, app_factory=create_app):
    """fn(client, app) against a fresh app (the port's by default), its
    access log and wide events on `log_stream`."""

    async def runner():
        app = app_factory(options, log_stream=log_stream or io.StringIO())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await fn(client, app)
        finally:
            await client.close()

    return asyncio.run(runner())


def jpg() -> bytes:
    return fixture_bytes("imaginary.jpg")


def _wide_events(stream: io.StringIO) -> list:
    return [json.loads(ln) for ln in stream.getvalue().splitlines() if ln.startswith("{")]


# --- the trace's wide-event methods -------------------------------------------

class TestTraceUnit:
    def test_accumulate_and_field_work_with_tracing_off(self):
        for enabled in (True, False):
            tr = obs_trace.RequestTrace("rid", enabled=enabled)
            tr.accumulate("cost_device_ms", 1.5)
            tr.accumulate("cost_device_ms", 2.0)
            assert tr.field("cost_device_ms") == 3.5
            assert tr.field("missing", 7) == 7

    def test_accumulate_is_thread_safe(self):
        tr = obs_trace.RequestTrace("rid")

        def add():
            for _ in range(1000):
                tr.accumulate("n", 1.0)

        threads = [threading.Thread(target=add) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert tr.field("n") == 8000.0

    def test_span_sum_duration_and_to_event_equal_the_references(self):
        from imaginary_tpu.obs import trace as ref_trace

        tid, sid = secrets.token_hex(16), secrets.token_hex(8)
        got, want = (mod.RequestTrace("rid", f"00-{tid}-{sid}-01")
                     for mod in (obs_trace, ref_trace))
        for tr in (got, want):
            tr.add_span("decode", 2.0, end=tr.t0 + 0.004)
            tr.add_span("encode", 1.25, end=tr.t0 + 0.006)
            tr.add_span("drain", 0.5, end=tr.t0 + 0.007)
            tr.annotate(op="resize", cache="off")
            tr.accumulate("cost_wire_bytes", 10.0)
        names = ("decode", "encode", "probe")
        assert got.span_sum(names) == want.span_sum(names) == 3.25
        assert got.duration_ms() >= 0.0
        g = got.to_event(route="/resize", status=200)
        w = want.to_event(route="/resize", status=200)
        g.pop("span_id")
        w.pop("span_id")
        assert g == w
        assert list(g) == list(w)
        assert got.spans[0].to_dict() == want.spans[0].to_dict() == {
            "name": "decode", "start_ms": 2.0, "dur_ms": 2.0}


# --- wide events ----------------------------------------------------------------

class TestWideEvents:
    def test_schema_and_5xx_correlation(self):
        stream = io.StringIO()

        async def fn(client, _app):
            res = await client.post("/resize?width=100", data=jpg())
            assert res.status == 200
            rid_ok = res.headers["X-Request-ID"]
            res = await client.post("/resize?width=100", data=b"notanimage")
            rid_bad = res.headers["X-Request-ID"]
            assert res.status >= 400
            events = _wide_events(stream)
            assert len(events) == 2
            ok = next(e for e in events if e["status"] == 200)
            for field in ("ts", "request_id", "trace_id", "span_id", "method", "route",
                          "path", "status", "remote", "duration_ms", "bytes_in",
                          "bytes_out", "op", "plan", "cache", "placement", "spans"):
                assert field in ok, field
            assert ok["request_id"] == rid_ok
            assert ok["op"] == "resize" and ok["cache"] == "off"
            assert ok["placement"] == "device"
            assert ok["bytes_in"] > 0 and ok["bytes_out"] > 0
            assert re.fullmatch(r"[0-9a-f]{16}", ok["plan"])
            names = [s["name"] for s in ok["spans"]]
            assert "decode" in names and "encode" in names and "drain" in names
            assert all(s["dur_ms"] >= 0 and "start_ms" in s for s in ok["spans"])
            bad = next(e for e in events if e["status"] >= 400)
            assert bad["request_id"] == rid_bad

        run(opts(wide_events=True), fn, log_stream=stream)

    def test_access_log_line_and_wide_event_share_id(self):
        stream = io.StringIO()

        async def fn(client, _app):
            res = await client.post("/resize?width=100", data=jpg())
            rid = res.headers["X-Request-ID"]
            log_line = next(ln for ln in stream.getvalue().splitlines()
                            if not ln.startswith("{"))
            assert log_line.rstrip().endswith(rid)
            assert _wide_events(stream)[0]["request_id"] == rid

        run(opts(wide_events=True), fn, log_stream=stream)

    def test_cache_outcomes_recorded(self):
        stream = io.StringIO()

        async def fn(client, _app):
            for _ in range(2):
                res = await client.post("/resize?width=100", data=jpg())
                assert res.status == 200
            events = _wide_events(stream)
            assert [e["cache"] for e in events] == ["result_miss", "result_hit"]
            # the plan digest groups the two: the same operation and query
            assert events[0]["plan"] == events[1]["plan"]

        run(opts(wide_events=True, cache_result_mb=16.0), fn, log_stream=stream)

    def test_plan_digest_equals_the_references(self):
        """The digest is the reference's: the same request, the same key."""
        from imaginary_tpu.web.app import create_app as ref_app
        from imaginary_tpu.web.config import ServerOptions as RefOptions

        plans = []
        for factory, options in ((create_app, opts(wide_events=True)),
                                 (ref_app, RefOptions(wide_events=True, host_spill=False))):
            stream = io.StringIO()

            async def fn(client, _app):
                res = await client.post("/resize?width=120&height=90&type=png", data=jpg())
                assert res.status == 200

            run(options, fn, log_stream=stream, app_factory=factory)
            plans.append(_wide_events(stream)[0]["plan"])
        assert plans[0] == plans[1]

    def test_no_event_line_without_the_flag(self):
        stream = io.StringIO()

        async def fn(client, _app):
            res = await client.post("/resize?width=100", data=jpg())
            assert res.status == 200
            assert _wide_events(stream) == []

        run(opts(), fn, log_stream=stream)


# --- /debugz ---------------------------------------------------------------------

class TestDebugz:
    def test_gated_off_by_default(self):
        async def fn(client, _app):
            for path in ("/debugz", "/debugz/profile?seconds=1", "/debugz/failpoints"):
                res = await client.get(path)
                assert res.status == 404, path
            res = await client.put("/debugz/failpoints", data=b"")
            assert res.status == 405

        run(opts(), fn)

    def test_enabled_payload_shape(self):
        async def fn(client, _app):
            await client.post("/resize?width=100", data=jpg())
            res = await client.get("/debugz")
            assert res.status == 200
            body = await res.json()
            for key in ("pid", "threads", "tasks", "slowest_requests", "failpoints",
                        "copies", "executor", "executor_counters", "host_pool", "cache"):
                assert key in body, key
            assert isinstance(body["tasks"], list) and body["tasks"]
            for key in ("queue_depth", "inflight_groups", "breaker_open",
                        "device_ms_per_mb", "drain_floor_ms"):
                assert key in body["executor"], key
            assert body["host_pool"]["workers"] >= 1
            slow = body["slowest_requests"]
            assert slow and "spans" in slow[0] and "request_id" in slow[0]
            assert "slo" not in body and "capacity" not in body

        obs_debugz.SLOW.clear()
        run(opts(enable_debug=True), fn)

    def test_api_key_guards_debugz_when_set(self):
        async def fn(client, _app):
            assert (await client.get("/debugz")).status == 401
            assert (await client.get("/debugz", headers={"API-Key": "sekrit"})).status == 200

        run(opts(enable_debug=True, api_key="sekrit"), fn)

    def test_failpoints_get_and_put(self):
        from imaginary_tpu_torch import failpoints

        async def fn(client, _app):
            res = await client.put("/debugz/failpoints", data=b"codec.decode=error")
            assert res.status == 200
            body = await res.json()
            assert "codec.decode" in json.dumps(body)
            res = await client.post("/resize?width=100", data=jpg())
            assert res.status >= 400
            assert (await client.put("/debugz/failpoints", data=b"nope=")).status == 400
            await client.put("/debugz/failpoints", data=b"")
            res = await client.post("/resize?width=100", data=jpg())
            assert res.status == 200

        try:
            run(opts(enable_debug=True), fn)
        finally:
            failpoints.deactivate()

    def test_profile_requires_destination(self, monkeypatch):
        monkeypatch.delenv("IMAGINARY_TPU_PROFILE_DIR", raising=False)

        async def fn(client, _app):
            res = await client.get("/debugz/profile?seconds=0.1")
            assert res.status == 400
            assert "IMAGINARY_TPU_PROFILE_DIR" in (await res.json())["error"]

        run(opts(enable_debug=True), fn)

    def test_profile_capture_writes_a_trace(self, monkeypatch, tmp_path):
        """The no-restart path: ?dir= names the destination; the capture
        exports a Chrome trace of the host there, the seconds clamped to
        0.05, and the session is closed after."""
        monkeypatch.delenv("IMAGINARY_TPU_PROFILE_DIR", raising=False)

        async def fn(client, _app):
            res = await client.get("/debugz/profile",
                                   params={"seconds": "0", "dir": str(tmp_path)})
            assert res.status == 200
            body = await res.json()
            assert body["profile_dir"] == str(tmp_path)
            assert body["seconds"] == 0.05
            assert body["activities"] == ["cpu"]
            assert os.path.dirname(body["trace_file"]) == str(tmp_path)
            with open(body["trace_file"]) as f:
                assert "traceEvents" in json.load(f)
            from imaginary_tpu_torch.engine import timing

            assert not timing.profiler_active()

        run(opts(enable_debug=True), fn)

    def test_profile_dir_from_environment(self, monkeypatch, tmp_path):
        monkeypatch.setenv("IMAGINARY_TPU_PROFILE_DIR", str(tmp_path))

        async def fn(client, _app):
            res = await client.get("/debugz/profile?seconds=0.05")
            assert res.status == 200
            assert (await res.json())["profile_dir"] == str(tmp_path)
            assert any(os.scandir(str(tmp_path)))

        run(opts(enable_debug=True), fn)

    def test_profile_bad_seconds_rejected(self, monkeypatch, tmp_path):
        monkeypatch.setenv("IMAGINARY_TPU_PROFILE_DIR", str(tmp_path))

        async def fn(client, _app):
            assert (await client.get("/debugz/profile?seconds=nope")).status == 400

        run(opts(enable_debug=True), fn)

    def test_one_capture_at_a_time(self, tmp_path):
        """A second capture while one runs answers 409, as a capture
        during a whole-run boot capture does."""
        from imaginary_tpu_torch.engine import timing

        async def fn(client, _app):
            first = asyncio.ensure_future(client.get(
                "/debugz/profile", params={"seconds": "0.6", "dir": str(tmp_path / "a")}))
            for _ in range(100):
                if timing.profiler_active():
                    break
                await asyncio.sleep(0.01)
            second = await client.get(
                "/debugz/profile", params={"seconds": "0.05", "dir": str(tmp_path / "b")})
            assert second.status == 409
            assert "already active" in (await second.json())["error"]
            assert (await first).status == 200
            assert not (tmp_path / "b").exists()

        run(opts(enable_debug=True), fn)

    def test_card_capture_without_card_activity_is_an_error(self, tmp_path, monkeypatch):
        """A capture of the card whose profiler recorded no card activity
        answers 500 with the profiler's error and writes no trace: never a
        host-only trace passed off as the card's."""
        from imaginary_tpu_torch.engine import timing

        class _Blind:  # a profiler that sees the host only
            def stop(self):
                pass

            def events(self):
                return []

            def export_chrome_trace(self, path):
                raise AssertionError("no trace may be written")

        def start(trace_dir, device="cpu"):
            with timing._profiler_lock:
                timing._profiler = (_Blind(), trace_dir, True)
            return True

        monkeypatch.setattr(timing, "start_profiler", start)

        async def fn(client, _app):
            res = await client.get("/debugz/profile",
                                   params={"seconds": "0.05", "dir": str(tmp_path)})
            assert res.status == 500
            assert "no CUDA activity" in (await res.json())["error"]
            assert not timing.profiler_active()
            assert not any(os.scandir(str(tmp_path)))

        run(opts(enable_debug=True), fn)


class TestSlowRing:
    def test_slowest_ordering_and_bound(self):
        ring = obs_debugz.SlowRing(keep=4)
        for i, dur in enumerate([5.0, 50.0, 1.0, 20.0, 9.0]):
            ring.note({"request_id": str(i), "duration_ms": dur})
        assert [e["duration_ms"] for e in ring.slowest(2)] == [50.0, 20.0]
        assert len(ring.slowest(100)) == 4
        ring.clear()
        assert ring.slowest() == []


# --- tail sampling ----------------------------------------------------------------

CLASSIFY_CASES = [
    ({"status": 503}, 0.0, None),
    ({"status": 504}, 0.0, None),
    ({"status": 418}, 0.0, None),
    ({"status": 200, "hedge": "won"}, 0.0, None),
    ({"status": 200, "placement_attempts": ["device:0:error", "host_spill"]}, 0.0, None),
    ({"status": 200, "placement_attempts": ["device:quarantined", "host_spill"]}, 0.0, None),
    ({"status": 200, "placement_attempts": ["shed_503"]}, 0.0, None),
    ({"status": 200, "fenced_publish": True}, 0.0, None),
    ({"status": 200, "duration_ms": 1500.0}, 0.0, None),
    ({"status": 503, "duration_ms": 9000.0}, 0.0, None),
    ({"status": 200, "hedge": "lost", "duration_ms": 9000.0}, 0.0, None),
    ({"status": 200, "duration_ms": 3.0, "placement_attempts": ["device:0"]}, 1.0, None),
    ({"status": 200, "duration_ms": 3.0}, 0.0, None),
    ({"status": 200, "duration_ms": 3.0}, 0.5, 0.4),
    ({"status": 200, "duration_ms": 3.0}, 0.5, 0.6),
]


class TestClassify:
    @pytest.mark.parametrize("event,sample,roll", CLASSIFY_CASES,
                             ids=[f"case{i}" for i in range(len(CLASSIFY_CASES))])
    def test_verdict_equals_the_references(self, event, sample, roll):
        from imaginary_tpu.obs import events as ref_events

        roll_fn = (lambda: roll) if roll is not None else None
        got = obs_events.classify(event, sample=sample, roll=roll_fn)
        assert got == ref_events.classify(event, sample=sample, roll=roll_fn)
        assert got in obs_events.SAMPLED_REASONS

    def test_precedence(self):
        assert obs_events.classify({"status": 503, "duration_ms": 9000.0}, 0.0) == "shed"
        assert obs_events.classify({"status": 200, "hedge": "lost",
                                    "duration_ms": 9000.0}, 0.0) == "hedged"

    def test_registry_equals_the_references(self):
        from imaginary_tpu.obs import events as ref_events

        assert obs_events.SAMPLED_REASONS == ref_events.SAMPLED_REASONS
        assert obs_events.SLOW_KEEP_MS == ref_events.SLOW_KEEP_MS


def _boring(event: dict, verdict: str) -> str:
    """A boring request's verdict: `verdict`, or "slow" when a loaded host
    made it one."""
    return "slow" if event["duration_ms"] >= obs_events.SLOW_KEEP_MS else verdict


class TestTailSampling:
    def test_sample_zero_keeps_only_the_interesting_tail(self):
        stream = io.StringIO()

        async def fn(client, _app):
            for _ in range(3):
                assert (await client.post("/resize?width=100", data=jpg())).status == 200
            assert (await client.post("/resize?width=100", data=b"nope")).status >= 400
            events = _wide_events(stream)
            # a boring request survives only by being slow (a loaded host)
            assert all(e["duration_ms"] >= obs_events.SLOW_KEEP_MS for e in events
                       if e["sampled_reason"] == "slow")
            events = [e for e in events if e["sampled_reason"] != "slow"]
            assert len(events) == 1
            assert events[0]["status"] >= 400 and events[0]["sampled_reason"] == "error"

        obs_debugz.SLOW.clear()
        run(opts(wide_events=True, wide_events_sample=0.0), fn, log_stream=stream)

    def test_default_sample_emits_everything(self):
        stream = io.StringIO()

        async def fn(client, _app):
            assert (await client.post("/resize?width=100", data=jpg())).status == 200
            events = _wide_events(stream)
            assert len(events) == 1
            assert events[0]["sampled_reason"] == _boring(events[0], "random")

        run(opts(wide_events=True), fn, log_stream=stream)

    def test_slow_ring_carries_verdict_even_for_unsampled(self):
        async def fn(client, _app):
            assert (await client.post("/resize?width=100", data=jpg())).status == 200

        obs_debugz.SLOW.clear()
        run(opts(wide_events=True, wide_events_sample=0.0), fn)
        entries = obs_debugz.SLOW.slowest(10)
        assert entries and entries[0]["sampled_reason"] == _boring(entries[0], "unsampled")


class TestExemplars:
    def test_metrics_endpoint_exemplar_query(self):
        async def fn(client, _app):
            res = await client.post("/resize?width=100", data=jpg())
            rid = res.headers["X-Request-ID"]
            plain = await (await client.get("/metrics")).text()
            assert " # {" not in plain
            parse_exposition_strict(plain)
            rich = await (await client.get("/metrics?exemplars=1")).text()
            assert f'request_id="{rid}"' in rich
            stripped = "\n".join(ln.split(" # {")[0] for ln in rich.splitlines()) + "\n"
            parse_exposition_strict(stripped)

        run(opts(), fn)


# --- the SLO engine ----------------------------------------------------------------

class TestSloEngine:
    def test_load_config_inline_file_and_errors(self, tmp_path):
        from imaginary_tpu.obs import slo as ref_slo

        objectives = slo_mod.load_config(
            '{"/resize": {"latency_ms": 250, "latency_target": 0.99, "availability": 0.999}}')
        assert objectives["/resize"].latency_ms == 250.0
        p = tmp_path / "slo.json"
        p.write_text('{"*": {"availability": 0.99}}')
        got, want = slo_mod.load_config(str(p)), ref_slo.load_config(str(p))
        assert {k: vars_of(v) for k, v in got.items()} == {k: vars_of(v) for k, v in want.items()}
        assert got["*"].latency_ms == 1000.0
        for bad in ("{nope", '{"*": 5}', '{"*": {"availability": 1.5}}',
                    '{"*": {"latency_ms": -1}}', "[1]", str(tmp_path / "missing")):
            with pytest.raises(ValueError):
                slo_mod.load_config(bad)
            with pytest.raises(ValueError):
                ref_slo.load_config(bad)

    @staticmethod
    def _both(spec: str, t: list):
        from imaginary_tpu.obs import slo as ref_slo

        return (slo_mod.SloEngine(slo_mod.load_config(spec), clock=lambda: t[0]),
                ref_slo.SloEngine(ref_slo.load_config(spec), clock=lambda: t[0]))

    def test_burn_rate_math(self):
        t = [1000.0]
        engines = self._both('{"*": {"availability": 0.999, "latency_ms": 100, '
                             '"latency_target": 0.99}}', t)
        for eng in engines:
            for _ in range(99):
                eng.observe("/resize", 200, 0.01)
            eng.observe("/resize", 500, 0.01)
            eng.observe("/resize", 200, 0.2)
        got, want = (e.snapshot() for e in engines)
        assert got == want
        r = got["routes"]["/resize"]
        assert r["availability"]["bad_5m"] == 1
        assert r["availability"]["burn_5m"] == pytest.approx(1 / 101 / 0.001, abs=1e-3)
        assert r["latency"]["bad_5m"] == 1

    def test_sliding_window_forgets_old_badness(self):
        t = [1000.0]
        engines = self._both('{"*": {"availability": 0.999}}', t)
        for eng in engines:
            eng.observe("/x", 500, 0.01)
            for _ in range(9):
                eng.observe("/x", 200, 0.01)
        t[0] += 6.0
        for eng in engines:
            eng.observe("/x", 200, 0.01)
        t[0] += 400.0
        for eng in engines:
            eng.observe("/x", 200, 0.01)
        got, want = (e.snapshot() for e in engines)
        assert got == want
        snap = got["routes"]["/x"]["availability"]
        assert snap["bad_5m"] == 0 and snap["burn_5m"] == 0.0 and snap["bad_1h"] == 1

    @pytest.mark.parametrize("spec,routes", [
        ('{"/resize": {"availability": 0.999}}', ("/other",)),
        ('{"*": {"availability": 0.999}}', ("/health", "/metrics", "/debugz", "/api/health",
                                             "/api/metrics", "/resize")),
        ('{"/health": {"availability": 0.999}}', ("/health",)),
    ], ids=["unmatched", "infra-excluded", "explicit-infra"])
    def test_route_matching_equals_the_references(self, spec, routes):
        t = [1000.0]
        engines = self._both(spec, t)
        for eng in engines:
            for route in routes:
                eng.observe(route, 500 if route == "/resize" else 200, 0.001)
        got, want = (e.snapshot() for e in engines)
        assert got == want

    def test_from_options_off(self):
        assert slo_mod.from_options(ServerOptions()) is None
        assert slo_mod.from_options(ServerOptions(slo_config="  ")) is None
        assert slo_mod.SLO_METRICS == ("imaginary_tpu_slo_burn_rate",
                                       "imaginary_tpu_slo_error_budget_remaining")


def vars_of(obj) -> dict:
    return {k: getattr(obj, k) for k in obj.__slots__}


class TestSloSurfaces:
    def test_health_metrics_and_debugz_blocks(self):
        async def fn(client, _app):
            assert (await client.post("/resize?width=100", data=jpg())).status == 200
            health = await (await client.get("/health")).json()
            route = health["slo"]["routes"]["/resize"]
            assert route["total"] >= 1 and "burn_5m" in route["availability"]
            assert "/health" not in health["slo"]["routes"]
            text = await (await client.get("/metrics")).text()
            types, samples = parse_exposition_strict(text)
            assert types["imaginary_tpu_slo_burn_rate"] == "gauge"
            burn = [labels for n, labels, _ in samples if n == "imaginary_tpu_slo_burn_rate"]
            assert {b["slo"] for b in burn} == {"availability", "latency"}
            assert {b["window"] for b in burn} == {"5m", "1h"}
            assert any(n == "imaginary_tpu_slo_error_budget_remaining" for n, _, _ in samples)
            assert "slo" in await (await client.get("/debugz")).json()

        run(opts(enable_debug=True, slo_config=SLO), fn)

    def test_no_slo_block_without_config(self):
        async def fn(client, _app):
            await client.post("/resize?width=100", data=jpg())
            assert "slo" not in await (await client.get("/health")).json()
            assert "imaginary_tpu_slo_" not in await (await client.get("/metrics")).text()

        run(opts(), fn)

    def test_malformed_config_refuses_the_boot(self):
        from imaginary_tpu_torch import cli

        with pytest.raises(SystemExit, match="availability"):
            cli.options_from_args(cli.parse_args(
                ["--slo-config", '{"*": {"availability": 2}}']))


# --- the cost plane -----------------------------------------------------------------

class TestCostPlaneUnit:
    def test_parse_windows_equals_the_references(self):
        from imaginary_tpu.obs import cost as ref_cost

        assert cost_mod.parse_windows("10s,1m,5m") == (("10s", 10), ("1m", 60), ("5m", 300))
        for spec in ("10s,1m,5m", "1s", "59m", "1s,2s,3s,4s,5s,6s"):
            assert cost_mod.parse_windows(spec) == ref_cost.parse_windows(spec)
        for bad in ("", " , ", "10x", "10s,5s", "0s", "120m", "1s,2s,3s,4s,5s,6s,7s"):
            with pytest.raises(ValueError):
                cost_mod.parse_windows(bad)

    def test_space_saving_fold_is_deterministic(self):
        sk = cost_mod.SpaceSaving(2)
        assert sk.offer("a") is None and sk.offer("a") is None and sk.offer("b") is None
        assert sk.offer("c") == "b"
        assert sk.tracked("a") and sk.tracked("c") and not sk.tracked("b")
        assert dict(sk.top())["c"] == 2.0

    @staticmethod
    def _book_both(topk: int, windows: str, t: list, bookings: list):
        from imaginary_tpu.obs import cost as ref_cost

        planes = (cost_mod.CostPlane(topk=topk, windows=windows, clock=lambda: t[0]),
                  ref_cost.CostPlane(topk=topk, windows=windows, clock=lambda: t[0]))
        for step in bookings:
            if isinstance(step, float):
                t[0] += step
                continue
            for plane in planes:
                plane.book(*step[0], **step[1])
        return planes

    def test_booking_windows_and_topz_equal_the_references(self):
        t = [1000.0]
        bookings = (
            [(("hog", "batch", "/process", "process"),
              {"device_ms": 100.0, "wire_bytes": 5e6})] * 3
            + [(("inter", "interactive", "/resize", "resize"),
                {"device_ms": 1.0, "host_ms": 2.0, "wire_bytes": 1e4})] * 2
            + [11.0, (("late", "-", "/resize", "resize"), {"device_ms": 7.0})])
        got, want = self._book_both(4, "10s,1m", t, bookings)
        g, w = got.snapshot(), want.snapshot()
        assert {k: g[k] for k in ("booked", "windows", "tenants", "folds")} == \
            {k: w[k] for k in ("booked", "windows", "tenants", "folds")}
        assert g["windows"]["10s"]["requests"] == 1
        assert g["windows"]["1m"]["requests"] == 6
        assert got.topz() == want.topz()
        ranked = got.topz()["windows"]["1m"]["by_chip_ms"]
        assert [r["tenant"] for r in ranked] == ["hog", "late", "inter"]

    def test_topk_folds_into_other(self):
        t = [1000.0]
        got, want = self._book_both(2, "10s", t, [
            (("a", "-", "/x", "x"), {"device_ms": 5.0}),
            (("a", "-", "/x", "x"), {"device_ms": 5.0}),
            (("b", "-", "/x", "x"), {"device_ms": 5.0}),
            (("c", "-", "/x", "x"), {"device_ms": 5.0})])
        snap = got.snapshot()
        assert snap["folds"] == want.snapshot()["folds"] == 1
        assert set(snap["tenants"]) == {"a", "c", cost_mod.OTHER}
        assert snap["tenants"][cost_mod.OTHER]["device_ms"] == pytest.approx(5.0)
        assert got.normalize("tenant", "b") == cost_mod.OTHER
        assert got.normalize("tenant", "a") == "a"
        assert got.normalize("route", "/whatever") == "/whatever"
        with pytest.raises(ValueError):
            got.normalize("flavor", "x")

    def test_seeded_tenants_never_report_other(self):
        plane = cost_mod.CostPlane(topk=4, windows="10s")
        plane.seed_tenants(("gold", "bronze"))
        assert plane.normalize("tenant", "gold") == "gold"
        assert plane.normalize("tenant", "stranger") == "other"

    def test_should_book_skips_infra_routes(self):
        plane = cost_mod.CostPlane()
        for route in ("/", "/health", "/metrics", "/topz", "/fleetz", "/api/health", "/debugz"):
            assert not plane.should_book(route), route
        for route in ("/resize", "/pipeline", "/api/crop"):
            assert plane.should_book(route), route

    def test_advisor_unknown_without_traffic(self):
        assert cost_mod.CostPlane(windows="10s").advise()["verdict"] == "unknown"

    def test_advisor_reads_the_ports_ewma(self):
        """The port's executor names its ms/MB EWMA `_ms_per_mb`: the
        plane reads it, where the reference's copy (which reads
        `_device_ms_per_mb`) would drop device_ms_per_mb, the link rate
        and the link busy fraction."""
        from imaginary_tpu.obs import cost as ref_cost

        class _PortEx:  # the port's executor's names
            _drain_floor_ms = 80.0
            _ms_per_mb = 2.0

        t = [1000.0]
        out = {}
        for name, mod in (("port", cost_mod), ("verbatim", ref_cost)):
            plane = mod.CostPlane(topk=4, windows="10s", clock=lambda: t[0])
            plane.bind(executor=_PortEx(), host_view=lambda: (4, 0))
            plane.book("t", "-", "/process", "process", device_ms=20.0, host_ms=1.0,
                       wire_bytes=10e6)
            out[name] = plane.advise()
        got = out["port"]
        # link: 80/16 + 10*2 = 25 ms/req; chip: 20 ms/req; host: 1/4
        assert got["serving_batch"] == cost_mod.SERVING_BATCH
        assert got["device_ms_per_mb"] == 2.0
        assert got["link_rate"] == pytest.approx(40.0)
        assert got["chip_rate"] == pytest.approx(50.0)
        assert got["verdict"] == "link" and got["e2e_rate"] == pytest.approx(40.0)
        assert "device_ms_per_mb" not in out["verbatim"]
        assert "link_rate" not in out["verbatim"]

    def test_from_options_and_install(self):
        assert cost_mod.from_options(ServerOptions()) is None
        assert cost_mod.active() is None
        plane = cost_mod.from_options(ServerOptions(cost_attribution=True, cost_topk=7))
        assert plane is not None and plane.topk == 7 and cost_mod.active() is plane
        assert cost_mod.normalize_label("tenant", "ghost") == "other"
        cost_mod.install(None)
        assert cost_mod.normalize_label("tenant", "ghost") == "ghost"
        with pytest.raises(ValueError):
            cost_mod.normalize_label("flavor", "x")

    def test_malformed_windows_refuse_the_boot(self):
        from imaginary_tpu_torch import cli

        with pytest.raises(SystemExit, match="cost windows"):
            cli.options_from_args(cli.parse_args(
                ["--cost-attribution", "--cost-windows", "5m,1m"]))


class TestCostStamps:
    def test_advise_carries_the_drained_ewma(self, monkeypatch):
        """After real drains on the CPU the advisor reports the executor's
        own EWMA and a link rate (the rename trap, end to end)."""
        monkeypatch.setattr(executor_mod, "_LINK_SEED", None)

        async def fn(client, app):
            service = app["service"]
            assert service.executor._ms_per_mb is None
            for _ in range(3):
                assert (await client.post("/resize?width=100", data=jpg())).status == 200
            ewma = service.executor._ms_per_mb
            assert ewma is not None and ewma > 0.0
            got = service.cost.advise()
            assert got["device_ms_per_mb"] == round(ewma, 4)
            assert got["link_rate"] > 0.0
            assert got["device_ms_per_req"] > 0.0 and got["host_ms_per_req"] > 0.0
            service.cost.utilization()
            assert (await client.post("/resize?width=100", data=jpg())).status == 200
            util = service.cost.utilization()
            assert "link" in util and util["lanes"].keys() == {"all"}

        run(opts(cost_attribution=True), fn)

    @pytest.mark.parametrize("armed", [True, False], ids=["armed", "off"])
    def test_device_wait_booked_only_when_armed(self, armed):
        """The drain's split at the kernels event (link_stall's source) and
        the drain_busy cells exist only while a plane is armed."""
        from imaginary_tpu_torch.engine.timing import LANE_TIMES, TIMES

        def count(stage):
            return TIMES.totals().get(stage, (0, 0.0))[0]

        async def fn(client, app):
            before = {s: count(s) for s in ("device_wait", "d2h", "drain")}
            busy0 = LANE_TIMES.totals().get((-1, "drain_busy"), 0.0)
            for _ in range(3):
                assert (await client.post("/resize?width=100", data=jpg())).status == 200
            grew = {s: count(s) - before[s] for s in before}
            assert grew["drain"] >= 3
            if armed:
                # the first launch of a signature is cold and unsplit
                assert grew["device_wait"] >= 2 and grew["d2h"] == grew["device_wait"]
                assert LANE_TIMES.totals()[(-1, "drain_busy")] > busy0
                health = await (await client.get("/health")).json()
                assert "link_stall" in health["capacity"]["utilization"]["wait_cum_ms"]
            else:
                assert grew["device_wait"] == grew["d2h"] == 0
                assert LANE_TIMES.totals().get((-1, "drain_busy"), 0.0) == busy0

        run(opts(cost_attribution=armed), fn)

    def test_cost_vector_stamped_on_the_wide_event(self):
        stream = io.StringIO()

        async def fn(client, _app):
            assert (await client.post("/resize?width=100", data=jpg())).status == 200
            ev = _wide_events(stream)[0]
            for key in ("cost_device_ms", "cost_wire_bytes", "cost_copied_bytes",
                        "cost_host_ms"):
                assert ev[key] > 0.0, key
            assert ev["device"] == 0

        run(opts(cost_attribution=True, wide_events=True), fn, log_stream=stream)


class TestCostSurfaces:
    def test_armed_health_metrics_topz_debugz(self):
        async def fn(client, _app):
            for _ in range(2):
                assert (await client.post("/resize?width=100", data=jpg())).status == 200
            cap = (await (await client.get("/health")).json())["capacity"]
            assert cap["booked"] >= 2
            assert set(cap["windows"]) == {"10s", "1m", "5m"}
            assert cap["tenants"]["default"]["requests"] >= 2
            assert "verdict" in cap["bound_by"] and "wait_cum_ms" in cap["utilization"]
            await client.get("/metrics")
            text = await (await client.get("/metrics")).text()
            types, samples = parse_exposition_strict(text)
            check_histograms(types, samples)
            names = {n for n, _, _ in samples}
            for field in ("device_ms", "host_ms", "wire_bytes", "copied_bytes",
                          "cache_bytes", "requests"):
                assert types[f"imaginary_tpu_cost_{field}_total"] == "counter", field
            assert {"imaginary_tpu_cost_folds_total", "imaginary_tpu_cost_booked_total",
                    "imaginary_tpu_utilization_host_pool"} <= names
            assert {labels["kind"] for n, labels, _ in samples
                    if n == "imaginary_tpu_utilization_wait_ms_total"} == \
                {"batch_form", "dispatch_wait", "link_stall", "drain"}
            assert types["imaginary_tpu_utilization_chip_busy"] == "gauge"
            assert any(labels.get("tenant") == "default" and v >= 2 for n, labels, v in samples
                       if n == "imaginary_tpu_cost_requests_total")
            topz = await client.get("/topz")
            assert topz.status == 200
            body = await topz.json()
            assert body["k"] == 20 and body["windows"]["5m"]["totals"]["requests"] >= 2
            assert body["windows"]["5m"]["by_chip_ms"][0]["tenant"] == "default"
            assert "capacity" in await (await client.get("/debugz")).json()

        run(opts(cost_attribution=True, enable_debug=True), fn)

    def test_off_by_default_and_bodies_unchanged(self):
        collected = {}

        async def armed(client, _app):
            res = await client.post("/resize?width=100", data=jpg())
            collected["armed"] = await res.read()

        async def off(client, _app):
            res = await client.post("/resize?width=100", data=jpg())
            collected["off"] = await res.read()
            assert "capacity" not in await (await client.get("/health")).json()
            text = await (await client.get("/metrics")).text()
            assert "imaginary_tpu_cost_" not in text
            assert "imaginary_tpu_utilization_" not in text
            assert (await client.get("/topz")).status == 404
            assert "capacity" not in await (await client.get("/debugz")).json()

        run(opts(cost_attribution=True, wide_events=True, slo_config=SLO,
                 enable_debug=True), armed)
        assert cost_mod.active() is not None
        run(opts(enable_debug=True), off)
        assert cost_mod.active() is None  # the off app uninstalled the plane
        assert collected["armed"] == collected["off"]

    def test_an_off_server_beside_an_armed_one_stays_off(self):
        """The stamps follow each service's own plane: a server without a
        plane built after an armed one leaves the armed one's stamps on
        and books none of its own."""
        from imaginary_tpu_torch.web.handlers import ImageService

        armed = ImageService(opts(cost_attribution=True))
        off = ImageService(opts())
        try:
            assert armed.executor.cost_armed and not off.executor.cost_armed
        finally:
            armed.close()
            off.close()
        stream = io.StringIO()

        async def fn(client, _app):
            assert (await client.post("/resize?width=100", data=jpg())).status == 200
            ev = _wide_events(stream)[0]
            assert not any(k.startswith("cost_") for k in ev)

        cost_mod.install(cost_mod.CostPlane())  # another app's plane, process-wide
        run(opts(wide_events=True), fn, log_stream=stream)

    def test_capacity_render_is_strict_and_normalized(self):
        from imaginary_tpu.web.metrics import render_metrics as ref_render

        from imaginary_tpu_torch.web.metrics import render_metrics

        stats = {
            "capacity": {
                "topk": 2, "folds": 3, "booked": 9,
                "windows": {"10s": {"device_ms": 1.0, "requests": 2}},
                "tenants": {'we"ird': {"device_ms": 1.5, "host_ms": 0.0, "wire_bytes": 10,
                                       "copied_bytes": 4, "cache_bytes": 0, "requests": 2}},
                "utilization": {"age_s": 1.0, "wait_cum_ms": {"batch_form": 1.0, "drain": 2.0},
                                "lanes": {"0": 0.5, "all": 0.1}, "chip_busy": 0.3,
                                "host_pool": 0.25, "link": 0.1},
                "bound_by": {"verdict": "chip"},
            },
            "slo": {"age_s": 1.0, "routes": {"/resize": {
                "objective": {}, "total": 3,
                "availability": {"burn_5m": 1.0, "burn_1h": 0.5, "budget_remaining": 0.5},
                "latency": {"burn_5m": 0.0, "burn_1h": 0.0, "budget_remaining": 1.0}}}},
            "ingress": {"read_timeouts": 2, "guarded_connections": 5},
            "eventLoop": {"lagMsLast": 12.0, "lagMsMax": 80.0, "samples": 5},
        }
        text = render_metrics(stats)
        types, samples = parse_exposition_strict(text)
        assert {n for n, _, _ in samples if not n.startswith("imaginary_tpu_event_loop_lag_sec")
                and not n.startswith(("imaginary_tpu_request_", "imaginary_tpu_stage_",
                                      "imaginary_tpu_requests_"))} == \
            {n for n, _, _ in parse_exposition_strict(ref_render(stats))[1]
             if not n.startswith("imaginary_tpu_event_loop_lag_sec")
             and not n.startswith(("imaginary_tpu_request_", "imaginary_tpu_stage_",
                                   "imaginary_tpu_requests_"))}
        assert {labels["tenant"] for n, labels, _ in samples
                if n == "imaginary_tpu_cost_device_ms_total"} == {'we\\"ird'}
        assert {labels["lane"]: v for n, labels, v in samples
                if n == "imaginary_tpu_utilization_lane_busy"} == {"0": 0.5, "all": 0.1}
        gauges = {n: v for n, _l, v in samples}
        assert gauges["imaginary_tpu_utilization_chip_busy"] == 0.3
        assert gauges["imaginary_tpu_event_loop_lag_last_seconds"] == pytest.approx(0.012)
        assert gauges["imaginary_tpu_event_loop_lag_max_seconds"] == pytest.approx(0.080)
        assert gauges["imaginary_tpu_ingress_read_timeouts_total"] == 2


class TestLoopLag:
    def test_probe_samples_and_snapshot(self):
        from imaginary_tpu_torch.obs import looplag

        async def probe():
            task = looplag.start(0.01)
            await asyncio.sleep(0.08)
            looplag.stop(task)

        asyncio.run(probe())
        snap = looplag.snapshot()
        assert snap is not None and snap["samples"] >= 1
        assert snap["lagMsMax"] >= snap["lagMsLast"] >= 0.0
        assert looplag.last_ms() == pytest.approx(snap["lagMsLast"], abs=1e-3)

    def test_health_and_metrics_carry_the_event_loop(self):
        async def fn(client, _app):
            await asyncio.sleep(0.3)  # the probe runs at 4 Hz from startup
            health = await (await client.get("/health")).json()
            assert health["eventLoop"]["samples"] >= 1
            text = await (await client.get("/metrics")).text()
            types, _ = parse_exposition_strict(text)
            assert types["imaginary_tpu_event_loop_lag_seconds"] == "histogram"
            assert types["imaginary_tpu_event_loop_lag_last_seconds"] == "gauge"

        run(opts(), fn)

    def test_lag_stamp_on_a_wide_event(self, monkeypatch):
        from imaginary_tpu_torch.obs import looplag

        stream = io.StringIO()
        monkeypatch.setattr(looplag, "last_ms", lambda: 75.0)

        async def fn(client, _app):
            assert (await client.post("/resize?width=100", data=jpg())).status == 200
            assert _wide_events(stream)[0]["loop_lag_ms"] == 75.0

        run(opts(wide_events=True), fn, log_stream=stream)


def test_deadline_lands_in_wide_event_surfaces():
    """The deadline's budget, remaining ms and stage checkpoints ride the
    slow-ring events /debugz serves."""
    async def fn(client, _app):
        obs_debugz.SLOW.clear()
        res = await client.post("/resize?width=100", data=jpg())
        assert res.status == 200
        mine = [e for e in obs_debugz.SLOW.slowest(256)
                if e.get("deadline_budget_ms") == 7000.0]
        assert mine, "deadline fields missing from the event surface"
        ev = mine[0]
        assert 0.0 < ev["deadline_remaining_ms"] <= 7000.0
        assert "admission" in ev["deadline_stages"] and "queue" in ev["deadline_stages"]

    run(opts(request_timeout_s=7.0), fn)


# --- parity with the reference's app, every plane armed --------------------------

PLANES = {"wide_events": True, "slo_config": SLO, "enable_debug": True,
          "cost_attribution": True, "mount": FIXTURES}
# (method, path, source fixture or raw bytes or None)
PARITY_REQUESTS = [
    # twice: the second drain is warm in both apps, so both executors
    # have a ms/MB EWMA (and the utilization block its `link`)
    ("POST", "/resize?width=100", "imaginary.jpg"),
    ("POST", "/resize?width=100", "imaginary.jpg"),
    ("GET", "/resize?width=300&height=200&file=large.jpg", None),
    ("GET", "/crop?width=300&height=200&file=large.jpg", None),
    ("POST", "/resize?width=100", b"not an image"),
    ("GET", "/nope", None),
]
NEW_FAMILIES = ("imaginary_tpu_slo_", "imaginary_tpu_cost_", "imaginary_tpu_utilization_",
                "imaginary_tpu_event_loop_")
GATES = ("/debugz", "/debugz/profile?seconds=1", "/debugz/failpoints", "/topz")


def _keys(tree) -> object:
    """The nested key structure of a JSON value (lists by their first)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(tree[0])] if tree else []
    return None


def _families(text: str) -> dict:
    return dict(ln.split()[2:4] for ln in text.splitlines() if ln.startswith("# TYPE "))


@pytest.fixture(scope="module")
def parity():
    """{app: surfaces} of the reference's and the port's app with every
    plane armed, and of each with every plane off (the gates)."""
    from imaginary_tpu.obs import cost as ref_cost
    from imaginary_tpu.web.app import create_app as ref_app
    from imaginary_tpu.web.config import ServerOptions as RefOptions

    def armed(factory, options_cls, extra):
        stream = io.StringIO()

        async def fn(client, _app):
            got = {"statuses": []}
            for method, path, src in PARITY_REQUESTS:
                data = fixture_bytes(src) if isinstance(src, str) else src
                res = await client.request(method, path, data=data)
                got["statuses"].append(res.status)
                await res.read()
            await asyncio.sleep(0.3)  # a loop-lag sample
            await client.get("/health")  # the first utilization delta
            got["health"] = await (await client.get("/health")).json()
            got["metrics"] = await (await client.get("/metrics")).text()
            got["topz"] = await (await client.get("/topz")).json()
            got["debugz"] = await (await client.get("/debugz")).json()
            return got

        got = run(options_cls(**PLANES, **extra), fn, log_stream=stream, app_factory=factory)
        got["events"] = _wide_events(stream)
        return got

    def gates(factory, options_cls, extra):
        async def fn(client, _app):
            out = {}
            for path in GATES:
                res = await client.get(path)
                out[path] = (res.status, await res.read())
            return out

        return run(options_cls(**extra), fn, app_factory=factory)

    out = {"ref": armed(ref_app, RefOptions, {"host_spill": False}),
           "port": armed(create_app, ServerOptions, {"device": "cpu"})}
    ref_cost.install(None)
    cost_mod.install(None)
    out["ref_gates"] = gates(ref_app, RefOptions, {"host_spill": False})
    out["port_gates"] = gates(create_app, ServerOptions, {"device": "cpu"})
    return out


class TestParity:
    def test_statuses(self, parity):
        assert parity["port"]["statuses"] == parity["ref"]["statuses"]

    def test_wide_event_field_names(self, parity):
        got, want = parity["port"]["events"], parity["ref"]["events"]
        # the image requests', then /health, /metrics, /topz and /debugz's
        assert len(got) == len(want) == len(PARITY_REQUESTS) + 5
        for g, w in zip(got, want):
            assert (g["method"], g["path"], g["status"]) == (w["method"], w["path"], w["status"])
            want = set(w)
            if g["status"] >= 400:
                # the port's byte-touch ledger books no `ingress` stage, so a
                # request refused before its decode copied nothing
                want -= {"cost_copied_bytes"}
            assert set(g) == want, g["path"]
            slow = obs_events.SLOW_KEEP_MS
            if g["duration_ms"] < slow and w["duration_ms"] < slow:  # a compile is slow
                assert g["sampled_reason"] == w["sampled_reason"]
            assert [s["name"] for s in g["spans"]] == [s["name"] for s in w["spans"]] or \
                g["status"] != 200

    def test_slo_and_capacity_blocks(self, parity):
        got, want = parity["port"]["health"], parity["ref"]["health"]
        assert set(want) - {"worker", "epoch"} <= set(got)
        assert _keys(got["slo"]) == _keys(want["slo"])
        g, w = got["capacity"], want["capacity"]
        assert set(g) == set(w)
        assert _keys(g["windows"]) == _keys(w["windows"])
        assert _keys(g["tenants"]) == _keys(w["tenants"])
        assert _keys(g["utilization"]) == _keys(w["utilization"])
        assert set(g["bound_by"]) == set(w["bound_by"])
        assert set(got["eventLoop"]) == set(want["eventLoop"])

    def test_metrics_families(self, parity):
        got, want = (_families(parity[k]["metrics"]) for k in ("port", "ref"))
        new = {n: t for n, t in want.items() if n.startswith(NEW_FAMILIES)}
        assert new and {n: got.get(n) for n in new} == new
        assert {n for n in got if n.startswith(NEW_FAMILIES)} == set(new)

    def test_topz_and_debugz_keys(self, parity):
        got, want = parity["port"], parity["ref"]
        assert _keys(got["topz"]) == _keys(want["topz"])
        assert {"slo", "capacity", "slowest_requests", "failpoints", "copies"} <= \
            set(got["debugz"]) & set(want["debugz"])
        assert _keys(got["debugz"]["capacity"]) == _keys(want["debugz"]["capacity"]) or \
            set(got["debugz"]["capacity"]) == set(want["debugz"]["capacity"])

    @pytest.mark.parametrize("path", GATES)
    def test_gates_answer_the_references_404(self, parity, path):
        assert parity["port_gates"][path] == parity["ref_gates"][path]
        assert parity["port_gates"][path][0] == 404
