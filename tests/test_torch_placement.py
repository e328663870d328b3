"""The executor's placement and the card's fault domain on the CPU, held
against the reference where both can take the same steps.

- Port copies of tests/test_engine.py::TestSpillPolicy and
  tests/test_breaker.py::TestDrainWatchdog (the hung drain is a fetch
  that blocks, as the reference's tests make it).
- OOM bisection: the `device.oom` failpoint, a launch monkeypatched to
  raise `torch.cuda.OutOfMemoryError` above a chunk size (bisected down
  to chunks that fit, bit-equal to the unsplit run), an item that does
  not fit alone (host-served, counted, marked), and the line the port
  draws: a hand-written kernel's failed launch is a crash strike.
- Hedging's deadline check: no twin once the request's deadline comes
  before the threshold, or has passed when the timer fires.
- HTTP parity: the same failpoint sequence against the reference's app
  and the port's (integrity on, eight devices of the CPU, the reference's
  count on this host) gives the same statuses and `X-Imaginary-Backend`
  values, and the same `/health` `deviceHealth` keys. The reference runs
  with `host_spill=False`, which turns off only its cost model's spill;
  the port's switch also governs the outage's and the OOM's host routes,
  so the port runs with `host_spill=True` and its cost model held off.
  With the port's default (`host_spill=False`) the item that does not
  fit alone answers the device's error instead.
"""

from __future__ import annotations

import asyncio
import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from imaginary_tpu_torch import deadline as deadline_mod
from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.engine import Executor, ExecutorConfig
from imaginary_tpu_torch.engine import executor as ex_mod
from imaginary_tpu_torch.obs import trace as obs_trace
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.plan import plan_operation
from imaginary_tpu_torch.options import ImageOptions
from tests.conftest import FIXTURES
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

WAIT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    failpoints.deactivate()


def _img(h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _plan(h=96, w=128, width=48):
    return plan_operation("resize", ImageOptions(width=width), h, w, 0, 3)


def _ex(**kw) -> Executor:
    kw.setdefault("max_form_ms", 1.0)
    return Executor(ExecutorConfig(device="cpu", **kw))


class TestSpillPolicy:
    def test_spill_error_falls_through_to_device(self, monkeypatch):
        """A host-interpreter failure does not fail the request: the item
        goes to the device queue."""
        ex = _ex(probe_interval=10**9, host_spill=True)
        ex._ms_per_mb = 10000.0
        ex._host_ms_per_mpix = 0.01
        monkeypatch.setattr(ex_mod.host_exec, "run",
                            lambda arr, plan: (_ for _ in ()).throw(RuntimeError("edge")))
        out = ex.process(_img(100, 80), _plan(100, 80, 40))
        assert out.shape == (50, 40, 3)
        assert ex.stats.spill_errors == 1
        assert ex.stats.spilled == 0
        ex.shutdown()

    def test_successful_spill_counts(self):
        ex = _ex(probe_interval=10**9, host_spill=True)
        ex._ms_per_mb = 10000.0
        ex._host_ms_per_mpix = 0.01
        out = ex.process(_img(100, 80), _plan(100, 80, 40))
        assert out.shape == (50, 40, 3)
        assert ex.stats.spilled == 1
        assert ex.stats.spill_errors == 0
        ex.shutdown()

    def test_cold_compile_does_not_seed_cost_model(self):
        """The first drain of a signature this process never launched is
        cold (the allocator's first blocks): it does not price the
        device; a second, warm drain does."""
        chain_mod.clear_cache()
        ex = _ex()
        ex.process(_img(100, 80), _plan(100, 80, 40))
        for _ in range(100):
            if ex.stats.groups >= 1:
                break
            time.sleep(0.01)
        assert ex._ms_per_mb is None
        ex.process(_img(100, 80, seed=1), _plan(100, 80, 40))
        for _ in range(100):
            if ex._ms_per_mb is not None:
                break
            time.sleep(0.01)
        assert ex._ms_per_mb is not None
        ex.shutdown()


class TestDrainWatchdog:
    """A half-dead device hangs inside its runtime instead of erroring, so
    no failure is booked and queued requests would wait their whole
    timeout. The watchdog abandons the stuck drain, fails its futures,
    opens the breaker outright and hands the queue to a fresh fetcher;
    the zombie's results are discarded if its call ever returns."""

    def test_hung_drain_abandoned_breaker_opens_and_host_serves(self, monkeypatch):
        release = threading.Event()
        hung = threading.Event()
        real_fetch = ex_mod.chain_mod.fetch_batch
        calls = {"n": 0}

        def hang_once(y, arrs, plans):
            calls["n"] += 1
            if calls["n"] == 1:
                hung.set()
                release.wait(timeout=30)
            return real_fetch(y, arrs, plans)

        monkeypatch.setattr(ex_mod.chain_mod, "fetch_batch", hang_once)
        # host placement on, as the reference's auto default has it
        ex = _ex(drain_watchdog_s=0.5, breaker_cooldown_s=60, host_spill=True)
        try:
            fut = ex.submit(_img(), _plan())
            assert hung.wait(timeout=30)
            with pytest.raises(RuntimeError, match="watchdog"):
                fut.result(timeout=30)
            assert ex.stats.breaker_opens == 1
            assert ex.stats.device_failures >= 1
            assert ex.stats.device_owed_mb == 0.0
            ex_mod.reset_placement()
            out = ex.process(_img(seed=1), _plan(), timeout=30)
            assert out.shape[0] > 0
            assert ex_mod.last_placement() == "host"
            assert ex.stats.breaker_host_served == 1
            release.set()
            ex.devhealth.note_ok(0)  # the cooldown is behind us
            ex_mod.reset_placement()
            out2 = ex.process(_img(seed=2), _plan(), timeout=30)
            assert out2.shape[0] > 0 and ex_mod.last_placement() == "device"
            assert calls["n"] >= 2  # the replacement fetcher drained it
            assert ex.debug_snapshot()["fetcher_generation"] == 1
        finally:
            release.set()
            ex.shutdown()

    def test_hung_drain_with_host_spill_off_serves_the_next_request_on_the_device(
            self, monkeypatch):
        """The port's default: the watchdog fails the stuck chunk and opens
        the breaker, and the next request still rides the device, served
        by the fresh fetcher, with nothing placed on the host."""
        release = threading.Event()
        hung = threading.Event()
        real_fetch = ex_mod.chain_mod.fetch_batch
        calls = {"n": 0}

        def hang_once(y, arrs, plans):
            calls["n"] += 1
            if calls["n"] == 1:
                hung.set()
                release.wait(timeout=30)
            return real_fetch(y, arrs, plans)

        monkeypatch.setattr(ex_mod.chain_mod, "fetch_batch", hang_once)
        ex = _ex(drain_watchdog_s=0.5, breaker_cooldown_s=60)
        try:
            fut = ex.submit(_img(), _plan())
            assert hung.wait(timeout=30)
            with pytest.raises(RuntimeError, match="watchdog"):
                fut.result(timeout=30)
            assert ex.stats.breaker_opens == 1 and ex.stats.device_owed_mb == 0.0
            ex_mod.reset_placement()
            out = ex.process(_img(seed=1), _plan(), timeout=30)
            np.testing.assert_array_equal(
                out, chain_mod.run_batch([_img(seed=1)], [_plan()], device="cpu")[0])
            assert ex_mod.last_placement() == "device"
            assert ex.stats.breaker_host_served == 0 and ex.stats.spilled == 0
            assert calls["n"] >= 2
        finally:
            release.set()
            ex.shutdown()

    def test_groups_queued_behind_hung_drain_fail_fast(self, monkeypatch):
        release = threading.Event()
        calls = {"n": 0}

        def hang(y, arrs, plans):
            calls["n"] += 1
            if calls["n"] == 1:
                release.wait(timeout=30)
            raise RuntimeError("late failure")

        monkeypatch.setattr(ex_mod.chain_mod, "fetch_batch", hang)
        ex = _ex(drain_watchdog_s=0.5, breaker_cooldown_s=60)
        try:
            futs = [ex.submit(_img(seed=i), _plan()) for i in range(3)]
            for f in futs:
                with pytest.raises(RuntimeError):
                    f.result(timeout=30)
        finally:
            release.set()
            ex.shutdown()


class TestOomBisection:
    def _chunk(self, n=8):
        arrs = [_img(seed=i) for i in range(n)]
        return arrs, [_plan() for _ in range(n)]

    def _submit_chunk(self, ex, arrs, plans):
        """Submit one chunk's worth inside the formation cap."""
        return [ex.submit(a, p) for a, p in zip(arrs, plans)]

    def test_oom_failpoint_bisects_and_serves_every_item(self):
        arrs, plans = self._chunk(8)
        want = chain_mod.run_batch(arrs, plans, device="cpu")
        failpoints.activate("device.oom=once(error)")
        ex = _ex(max_form_ms=200)
        try:
            futs = self._submit_chunk(ex, arrs, plans)
            for f, w in zip(futs, want):
                assert np.array_equal(f.result(timeout=WAIT_S), w)
            assert ex.stats.oom_events == 1 and ex.stats.oom_splits == 1
            assert ex.stats.oom_failed == 0 and ex.stats.breaker_opens == 0
            assert ex.devhealth.record(0).oom_events == 1
            assert ex.devhealth.record(0).failures == 0
        finally:
            ex.shutdown()

    def test_real_out_of_memory_bisects_to_chunks_that_fit(self, monkeypatch):
        """A launch of more than 2 items raises torch.cuda.OutOfMemoryError:
        8 -> 4 + 4 -> 2 + 2 + 2 + 2, every answer bit-equal to the unsplit
        run, no strike."""
        arrs, plans = self._chunk(8)
        want = chain_mod.run_batch(arrs, plans, device="cpu")
        real = chain_mod.launch_batch
        sizes = []

        def tight(arrs_, plans_, **kw):
            sizes.append(len(arrs_))
            if len(arrs_) > 2:
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 2.00 GiB")
            return real(arrs_, plans_, **kw)

        monkeypatch.setattr(chain_mod, "launch_batch", tight)
        ex = _ex(max_form_ms=200)
        try:
            futs = self._submit_chunk(ex, arrs, plans)
            for f, w in zip(futs, want):
                assert np.array_equal(f.result(timeout=WAIT_S), w)
                assert getattr(f, "_hedge_placement", None) is None  # the device
            assert sizes[0] == 8 and sorted(sizes[1:]) == [2, 2, 2, 2, 4, 4]
            assert ex.stats.oom_events == 1 and ex.stats.oom_splits == 3
            assert ex.stats.oom_host_routed == 0 and ex.stats.device_failures == 0
        finally:
            ex.shutdown()

    def test_item_that_does_not_fit_alone_is_host_served(self, monkeypatch):
        def never(arrs_, plans_, **kw):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

        monkeypatch.setattr(chain_mod, "launch_batch", never)
        # host placement on, as the reference's auto default has it
        ex = _ex(max_form_ms=200, oom_split_depth=1, host_spill=True)
        try:
            arrs, plans = self._chunk(2)
            want = [ex_mod.host_exec.run(a, p) for a, p in zip(arrs, plans)]
            futs = self._submit_chunk(ex, arrs, plans)
            for f, w in zip(futs, want):
                np.testing.assert_array_equal(f.result(timeout=WAIT_S), w)
                assert f._hedge_placement == "host"
            assert ex.stats.oom_host_routed == 2 and ex.stats.oom_failed == 0
        finally:
            ex.shutdown()

    def test_item_that_does_not_fit_alone_fails_with_host_spill_off(self, monkeypatch):
        """The port's default: an item that runs out of memory alone fails
        with the device's error, counted in oom_failed; nothing goes to the
        host."""
        def never(arrs_, plans_, **kw):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

        monkeypatch.setattr(chain_mod, "launch_batch", never)
        ex = _ex(max_form_ms=200, oom_split_depth=1)
        try:
            arrs, plans = self._chunk(2)
            futs = self._submit_chunk(ex, arrs, plans)
            for f in futs:
                with pytest.raises(torch.cuda.OutOfMemoryError):
                    f.result(timeout=WAIT_S)
                assert getattr(f, "_hedge_placement", None) is None
            assert ex.stats.oom_host_routed == 0 and ex.stats.oom_failed == 2
        finally:
            ex.shutdown()

    def test_a_kernel_launch_error_is_a_crash_strike(self, monkeypatch):
        def crash(arrs_, plans_, **kw):
            raise RuntimeError("resample kernel launch failed: CUDA error 2")

        monkeypatch.setattr(chain_mod, "launch_batch", crash)
        assert not chain_mod.is_oom_error(RuntimeError(
            "resample kernel launch failed: CUDA error 2"))
        assert chain_mod.is_oom_error(torch.cuda.OutOfMemoryError("x"))
        assert chain_mod.is_oom_error(failpoints.FailpointError(
            "failpoint device.oom: injected error"))
        ex = _ex(breaker_threshold=5)
        try:
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                ex.process(_img(), _plan(), timeout=WAIT_S)
            assert ex.stats.oom_events == 0 and ex.stats.device_failures == 1
            assert ex.devhealth.record(0).failures == 1
        finally:
            ex.shutdown()


class _BlockedDevice:
    def __init__(self, monkeypatch):
        self.release = threading.Event()
        real = ex_mod.chain_mod.launch_batch

        def blocked(*a, **k):
            self.release.wait(timeout=60)
            return real(*a, **k)

        monkeypatch.setattr(ex_mod.chain_mod, "launch_batch", blocked)


class TestHedgeDeadline:
    def _submit_with_deadline(self, ex, budget_s):
        tr = obs_trace.RequestTrace("req-hedge")
        tr.deadline = deadline_mod.Deadline(budget_s)
        token = obs_trace.activate(tr)
        try:
            return ex.submit(_img(), _plan())
        finally:
            obs_trace.deactivate(token)

    def test_no_hedge_when_the_deadline_comes_first(self, monkeypatch):
        blocked = _BlockedDevice(monkeypatch)
        ex = _ex(hedge_threshold_ms=50.0)
        try:
            fut = self._submit_with_deadline(ex, 0.03)  # below the 50 ms threshold
            time.sleep(0.3)
            assert ex.stats.hedges_launched == 0
            assert not fut.done()
            blocked.release.set()
            assert fut.result(timeout=WAIT_S).shape == (36, 48, 3)
            assert not hasattr(fut, "_hedge_placement")
        finally:
            blocked.release.set()
            ex.shutdown()

    def test_a_hedge_fires_within_the_deadline(self, monkeypatch):
        blocked = _BlockedDevice(monkeypatch)
        ex = _ex(hedge_threshold_ms=50.0)
        try:
            fut = self._submit_with_deadline(ex, 5.0)
            assert fut.result(timeout=WAIT_S).shape == (36, 48, 3)
            assert fut._hedge_placement == "host" and ex.stats.hedges_won == 1
        finally:
            blocked.release.set()
            ex.shutdown()

    def test_no_hedge_once_the_deadline_has_passed(self, monkeypatch):
        """The timer itself re-checks: a deadline that ran out between the
        arming and the firing launches no twin."""
        blocked = _BlockedDevice(monkeypatch)
        ex = _ex(hedge_threshold_ms=50.0)
        try:
            tr = obs_trace.RequestTrace("req-late")
            tr.deadline = deadline_mod.Deadline(5.0)
            item = ex_mod._Item(_img(), _plan())
            item.trace = tr
            outer = ex._arm_hedge(item)
            assert outer is not None
            tr.deadline = deadline_mod.Deadline(0.0)
            time.sleep(0.3)
            assert ex.stats.hedges_launched == 0 and not outer.done()
            item.future.set_result(_img())
            outer.result(timeout=5)
        finally:
            blocked.release.set()
            ex.shutdown()


class TestPlacementMarks:
    """Every host answer is marked for X-Imaginary-Backend, also under a
    hedge's outer future and across a request's several submits."""

    def test_a_verified_copy_under_an_armed_hedge_is_marked_host(self):
        from imaginary_tpu_torch.engine.integrity import IntegrityConfig, IntegrityState

        integ = IntegrityState(IntegrityConfig(enabled=True, sample=1.0))
        ex = _ex(hedge_threshold_ms=5000.0, integrity=integ)
        try:
            want = ex_mod.host_exec.run(_img(), _plan())
            failpoints.activate("device.corrupt=error")
            fut = ex.submit(_img(), _plan())
            assert fut is not None and ex.stats.hedges_launched == 0
            np.testing.assert_array_equal(fut.result(timeout=WAIT_S), want)
            assert fut._hedge_placement == "host"
            assert integ.mismatches >= 1 and integ.reserved >= 1
            ex_mod.reset_placement()
            ex.process(_img(), _plan(), timeout=WAIT_S)
            assert ex_mod.last_placement() == "host"
            assert ex.stats.hedges_launched == 0
        finally:
            failpoints.deactivate()
            ex.shutdown()

    def test_a_host_answer_stays_marked_for_the_rest_of_the_request(self):
        ex = _ex(force_host=True)
        try:
            ex_mod.reset_placement()
            ex.process(_img(), _plan(), timeout=WAIT_S)
            assert ex_mod.last_placement() == "host"
            ex.config.force_host = False
            ex.process(_img(seed=1), _plan(), timeout=WAIT_S)
            assert ex_mod.last_placement() == "host"  # the request's first answer
            ex_mod.reset_placement()  # the next request
            ex.process(_img(seed=1), _plan(), timeout=WAIT_S)
            assert ex_mod.last_placement() == "device"
        finally:
            ex.shutdown()


# -- HTTP parity: the same failpoint sequence against both apps ------------------

GET = "/resize?width=300&height=200&file=large.jpg"
# (id, failpoint spec, path): sent to each app in this order
SEQUENCE = [
    ("ok", "", GET),
    ("oom-alone", "device.oom=once(error)", GET),
    ("corrupt", "device.corrupt=error", GET),
    ("failed-over", "", GET),
    ("chip-error", "device.chip_error[1]=error", GET),
    ("blur", "", "/blur?sigma=2&file=large.jpg"),
]


async def _run_sequence(create_app, options_cls, fps, **extra):
    from aiohttp.test_utils import TestClient, TestServer

    app = create_app(options_cls(mount=FIXTURES, integrity=True, integrity_sample=1.0,
                                 **extra), log_stream=io.StringIO())
    client = TestClient(TestServer(app))
    await client.start_server()
    out = {}
    try:
        for cid, spec, path in SEQUENCE:
            fps.activate(spec)
            try:
                r = await client.get(path)
                out[cid] = (r.status, r.headers.get("X-Imaginary-Backend"))
                await r.read()
            finally:
                fps.deactivate()
        r = await client.get("/health")
        out["health"] = json.loads(await r.read())
    finally:
        await client.close()
    return out


@pytest.fixture(scope="module")
def sequences(testdata):
    from imaginary_tpu import failpoints as jfailpoints
    from imaginary_tpu.web.app import create_app as ref_app
    from imaginary_tpu.web.config import ServerOptions as RefOptions
    from imaginary_tpu_torch.web.app import create_app as port_app
    from imaginary_tpu_torch.web.config import ServerOptions as PortOptions

    import jax

    n = len(jax.local_devices())

    async def run():
        ref = await _run_sequence(ref_app, RefOptions, jfailpoints, host_spill=False)
        with pytest.MonkeyPatch.context() as mp:
            # the reference's host_spill=False: no cost-model spill, the
            # outage's and the OOM's host routes on
            mp.setattr(Executor, "_should_spill", lambda self, item: False)
            got = await _run_sequence(port_app, PortOptions, failpoints, device="cpu",
                                      n_devices=n, host_spill=True)
        off = await _run_sequence(port_app, PortOptions, failpoints, device="cpu",
                                  n_devices=n, host_spill=False)
        return ref, got, off

    return asyncio.run(run())


@pytest.mark.parametrize("cid", [c[0] for c in SEQUENCE])
def test_failpoint_sequence_answers_like_the_reference(sequences, cid):
    ref, got, _ = sequences
    assert got[cid] == ref[cid]


def test_the_sequence_reaches_the_host_and_fails_over(sequences):
    ref, got, _ = sequences
    assert got["oom-alone"] == got["corrupt"] == (200, "host")
    assert got["ok"] == got["failed-over"] == (200, "device")


def test_host_spill_off_answers_the_oom_with_the_devices_error(sequences):
    """The port's default sends no OOM to the host; integrity's verified
    copy is the one host answer of the sequence, and the rest agree."""
    _, got, off = sequences
    assert off["oom-alone"][0] != 200 and off["oom-alone"][1] is None
    assert off["health"]["executor"]["oom_host_routed"] == 0
    assert off["health"]["executor"]["oom_failed"] == 1
    for cid in ("ok", "corrupt", "failed-over", "chip-error", "blur"):
        assert off[cid] == got[cid], cid


def test_device_health_keys_equal_the_references(sequences):
    ref, got, _ = sequences
    rdh, gdh = ref["health"]["deviceHealth"], got["health"]["deviceHealth"]
    assert set(gdh) == set(rdh)
    assert [set(d) for d in gdh["per_device"]] == [set(d) for d in rdh["per_device"]]
    assert gdh["count"] == rdh["count"] and gdh["corruptions"] == rdh["corruptions"] == 1
    assert set(got["health"]["integrity"]) == set(ref["health"]["integrity"])
    for k in ("checks", "mismatches", "reserved"):
        assert got["health"]["integrity"][k] == ref["health"]["integrity"][k], k
