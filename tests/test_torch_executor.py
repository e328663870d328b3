"""The port's micro-batch executor on the CPU (mirrors tests/test_engine.py
TestExecutor and tests/test_continuous.py TestStageSplit).

Every wait is bounded (`future.result(timeout=...)`) and every executor is
shut down by the fixture, so a stuck collector fails a test instead of
hanging the run.
"""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

from imaginary_tpu.engine import executor as jexecutor
from imaginary_tpu.web import config as jconfig
from imaginary_tpu_torch.engine import MAX_BATCH, Executor, ExecutorConfig
from imaginary_tpu_torch.engine import executor as executor_mod
from imaginary_tpu_torch.engine.timing import TIMES, WIRE
from imaginary_tpu_torch.ops import chain as pchain
from imaginary_tpu_torch.ops.plan import plan_operation
from imaginary_tpu_torch.options import ImageOptions

WAIT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on few cores,
    and torch's default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def make_ex():
    made = []

    def make(**kw):
        ex = Executor(ExecutorConfig(device="cpu", **kw))
        made.append(ex)
        return ex

    yield make
    for ex in made:
        ex.shutdown()
        assert not ex._thread.is_alive() and not ex._fetcher.is_alive()


def _img(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _resize_plan(h, w, width):
    return plan_operation("resize", ImageOptions(width=width), h, w, 0, 3)


def test_single_item(make_ex):
    ex = make_ex(max_form_ms=1)
    out = ex.process(_img(100, 80), _resize_plan(100, 80, 40), timeout=WAIT_S)
    assert out.shape == (50, 40, 3)
    assert ex.stats.items == 1 and ex.stats.batches == 1


def test_identity_plan_short_circuits(make_ex):
    ex = make_ex(max_form_ms=1)
    arr = _img(64, 64)
    plan = plan_operation("autorotate", ImageOptions(), 64, 64, 0, 3)
    assert ex.process(arr, plan, timeout=WAIT_S) is arr
    assert ex.stats.batches == 0


def test_same_signature_items_batch_together(make_ex):
    ex = make_ex(max_form_ms=200, max_batch=8)
    plan = _resize_plan(100, 80, 40)
    arrs = [_img(100, 80, seed=i) for i in range(6)]
    futs = [ex.submit(a, plan) for a in arrs]
    outs = [f.result(timeout=WAIT_S) for f in futs]
    # all six shared one launch
    assert ex.stats.batches == 1 and ex.stats.max_group_seen == 6
    # each output is its own image's (no cross-item mixing)
    for a, o in zip(arrs, outs):
        assert np.array_equal(o, pchain.run_single(a, plan, device="cpu"))
    assert not np.array_equal(outs[0], outs[1])


def test_mixed_signatures_batch_separately(make_ex):
    ex = make_ex(max_form_ms=200, max_batch=8)
    f1 = [ex.submit(_img(100, 80, seed=i), _resize_plan(100, 80, 40)) for i in range(3)]
    f2 = [ex.submit(_img(300, 200, seed=i), _resize_plan(300, 200, 64)) for i in range(3)]
    assert {f.result(timeout=WAIT_S).shape for f in f1} == {(50, 40, 3)}
    assert {f.result(timeout=WAIT_S).shape for f in f2} == {(96, 64, 3)}
    assert ex.stats.batches == 2 and ex.stats.max_group_seen == 3


def test_launch_error_reaches_every_future_of_its_chunk(make_ex, monkeypatch):
    ex = make_ex(max_form_ms=200, max_batch=8)
    plan = _resize_plan(100, 80, 40)
    real = executor_mod.chain_mod.launch_batch
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device fell over")
        return real(*a, **k)

    monkeypatch.setattr(executor_mod.chain_mod, "launch_batch", flaky)
    futs = [ex.submit(_img(100, 80, seed=i), plan) for i in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device fell over"):
            f.result(timeout=WAIT_S)
    assert ex.stats.device_failures == 1
    # the executor survives and keeps serving
    assert ex.process(_img(100, 80), plan, timeout=WAIT_S).shape == (50, 40, 3)
    assert ex.stats.device_failures == 1


def test_fetch_error_reaches_its_chunk_only(make_ex, monkeypatch):
    ex = make_ex(max_form_ms=1)
    plan = _resize_plan(100, 80, 40)
    real = executor_mod.chain_mod.fetch_batch

    def failing(launched, arrs, plans):
        if arrs[0][0, 0, 0] == 7:
            raise RuntimeError("copy back failed")
        return real(launched, arrs, plans)

    monkeypatch.setattr(executor_mod.chain_mod, "fetch_batch", failing)
    bad = _img(100, 80)
    bad[0, 0, 0] = 7
    good = _img(100, 80, seed=1)
    good[0, 0, 0] = 8
    with pytest.raises(RuntimeError, match="copy back failed"):
        ex.process(bad, plan, timeout=WAIT_S)
    assert ex.process(good, plan, timeout=WAIT_S).shape == (50, 40, 3)
    assert ex.stats.device_failures == 1


def test_concurrent_submitters(make_ex):
    """More submitting threads than cores, with a short switch interval:
    every result is its own image's, and no count or owed byte is lost."""
    ex = make_ex(max_form_ms=5, max_batch=8)
    plan = _resize_plan(100, 80, 40)
    results, errors = {}, []

    def worker(i):
        try:
            results[i] = ex.process(_img(100, 80, seed=i), plan, timeout=WAIT_S)
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 32
    for i, out in results.items():
        assert np.array_equal(out, pchain.run_single(_img(100, 80, seed=i), plan, device="cpu"))
    d = ex.stats.to_dict()
    assert d["items"] == 32 and d["device_owed_mb"] == 0.0


def test_stats_dict(make_ex):
    WIRE.reset()  # no labelled bytes from an earlier sharded launch
    ex = make_ex(max_form_ms=1)
    ex.process(_img(64, 64), _resize_plan(64, 64, 32), timeout=WAIT_S)
    d = ex.stats.to_dict()
    assert set(d) == {
        "items", "batches", "groups", "avg_batch", "avg_group", "max_group",
        "queue_depth", "compile_cache_size", "batch_form_p50_ms", "batch_form_p99_ms",
        "dispatch_wait_p50_ms", "dispatch_wait_p99_ms", "device_failures",
        "device_owed_mb", "compile_misses", "copied_bytes", "copy_events",
        # placement and the fault domain
        "spilled", "spill_errors", "breaker_opens", "breaker_host_served",
        "shadow_probes", "hedges", "oom_events", "oom_splits", "oom_host_routed",
        "oom_failed", "device_ms_per_mb", "host_ms_per_mpix", "host_inflight",
        "host_owed_mpix", "host_spill_p50_ms", "host_spill_p99_ms",
        # admission: donation, the pressure rungs and the link ledger
        "donation_enabled", "donation_rejected", "pressure_host_forced",
        "pressure_capped_batches", "wire_bytes", "wire_transfers",
    }
    assert d["items"] == 1 and d["batches"] == 1 and d["groups"] == 1
    assert d["compile_cache_size"] >= 1 and d["device_owed_mb"] == 0.0
    # every key is one of the reference's /health keys, under its name
    assert set(d) <= set(jexecutor.ExecutorStats().to_dict())


def test_batch_form_and_dispatch_wait_sum_to_queue_wait(make_ex):
    TIMES.reset()
    ex = make_ex(max_form_ms=2.0)
    ex.process(_img(100, 80), _resize_plan(100, 80, 40), timeout=WAIT_S)
    ex.process(_img(100, 80, seed=1), _resize_plan(100, 80, 40), timeout=WAIT_S)
    snap = TIMES.snapshot()
    for stage in ("queue_wait", "batch_form", "dispatch_wait", "launch", "drain"):
        assert snap[stage]["count"] == 2, stage
    # exact by construction (both halves stamped at the same instant);
    # the means agree to their rounding
    total = snap["batch_form"]["mean_ms"] + snap["dispatch_wait"]["mean_ms"]
    assert abs(total - snap["queue_wait"]["mean_ms"]) < 0.5
    # formation respected its cap (plus scheduler slack)
    assert snap["batch_form"]["p99_ms"] <= 2.0 + 50.0


def test_chunk_closes_at_max_batch(make_ex):
    """A formation cap of a minute: only reaching max_batch can close
    these chunks in time. Two rounds of exactly max_batch items, so no
    round leaves a remainder (a due key's remainder closes with it)."""
    ex = make_ex(max_form_ms=60_000.0, max_batch=4)
    plan = _resize_plan(100, 80, 40)
    t0 = time.monotonic()
    for r in range(2):
        futs = [ex.submit(_img(100, 80, seed=4 * r + i), plan) for i in range(4)]
        for f in futs:
            assert f.result(timeout=WAIT_S).shape == (50, 40, 3)
    assert time.monotonic() - t0 < WAIT_S
    assert ex.stats.batches == 2 and ex.stats.max_group_seen == 4


def test_shutdown_resolves_pending_items():
    ex = Executor(ExecutorConfig(device="cpu", max_form_ms=60_000.0, max_batch=8))
    plan = _resize_plan(100, 80, 40)
    futs = [ex.submit(_img(100, 80, seed=i), plan) for i in range(3)]
    assert not any(f.done() for f in futs)
    ex.shutdown()
    assert all(f.done() for f in futs)
    assert [f.result(timeout=0).shape for f in futs] == [(50, 40, 3)] * 3
    assert not ex._thread.is_alive() and not ex._fetcher.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit(_img(100, 80), plan)
    ex.shutdown()  # a second call is a no-op


def test_config_and_ladder_match_reference():
    """The chunk cap and the defaults are the reference's: MAX_BATCH and
    max_inflight as in its ExecutorConfig, and the formation cap as its
    config derives it (max_form_ms None: the window_ms; the server passes
    its --batch-form-ms). The port launches every chunk at its own size,
    so it has no batch ladder; its largest chunk is the top of the
    reference's ladder."""
    assert MAX_BATCH == jexecutor.MAX_BATCH == 16
    ref = jexecutor.ExecutorConfig()
    mine = ExecutorConfig()
    assert (mine.max_batch, mine.max_inflight) == (ref.max_batch, ref.max_inflight)
    assert mine.max_form_ms is ref.max_form_ms is None
    assert mine.window_ms == ref.window_ms == 3.0
    assert jconfig.ServerOptions().batch_form_ms == 5.0
    assert jexecutor.batch_ladder(mine.max_batch)[-1] == mine.max_batch
    assert mine.device == "cuda"


# --- the per-key device price (the reference's executor.py:658-665,
# :1029-1038, :2867-2889) -------------------------------------------------------


class _Drained:
    """A drained item as `_note_drain` reads it: its chain key and wire MB."""

    def __init__(self, key, wire_mb: float = 1.0):
        self.key = key
        self.wire_mb = wire_mb
        self.stage_ms = {}
        self.trace = None


def _reference_key_rule(table: dict, key, per_mb: float, glob_prev) -> None:
    """The reference's per-key update (executor.py:2874-2889), verbatim in
    its arithmetic: the seed clamped to 16x the global before the drain,
    a later sample to 4x the key's own history, the dict cleared when a
    new key finds 256."""
    kprev = table.get(key)
    if kprev is None and len(table) >= 256:
        table.clear()
    if kprev is None:
        table[key] = per_mb if glob_prev is None else min(per_mb, 16.0 * glob_prev)
    else:
        table[key] = 0.7 * kprev + 0.3 * min(per_mb, 4.0 * kprev)


def _reference_rate_for(ex, key) -> float:
    """The reference's `Executor._rate_for` on the port's state."""
    import types

    state = types.SimpleNamespace(_device_ms_per_mb=ex._ms_per_mb,
                                  _rate_by_key=dict(ex._rate_by_key),
                                  _owed_lock=threading.Lock())
    return jexecutor.Executor._rate_for(state, key)


class TestPerKeyPrice:
    A, B = ("chain-a", 64, 64, 3), ("chain-b", 64, 64, 3)

    def _drain(self, ex, model, key, per_mb):
        prev = ex._ms_per_mb
        ex._note_drain([_Drained(key)], per_mb)
        _reference_key_rule(model, key, per_mb, prev)
        assert ex._rate_by_key == pytest.approx(model)
        for k in (self.A, self.B, ("never-drained",)):
            assert ex._rate_for(k) == pytest.approx(_reference_rate_for(ex, k))

    def test_two_keys_follow_the_reference_rule(self, make_ex):
        ex = make_ex()
        model: dict = {}
        assert ex._rate_for(self.A) == 0.0  # unpriced, never free
        self._drain(ex, model, self.A, 1.0)
        assert ex._rate_by_key[self.A] == 1.0 and ex._ms_per_mb == 1.0
        # a new key's seed: 100 ms/MB clamped to 16x the global of 1.0
        self._drain(ex, model, self.B, 100.0)
        assert ex._rate_by_key[self.B] == pytest.approx(16.0)
        assert ex._rate_for(self.B) == pytest.approx(16.0)
        # a known key's sample: 1000 clamped to 4x its own 16, then the EWMA
        self._drain(ex, model, self.B, 1000.0)
        assert ex._rate_by_key[self.B] == pytest.approx(0.7 * 16.0 + 0.3 * 64.0)
        # the global falls under cheap drains of A until B's price is capped
        # at 8x it
        while 8.0 * ex._ms_per_mb >= ex._rate_by_key[self.B]:
            self._drain(ex, model, self.A, 0.01)
        assert ex._rate_for(self.B) == pytest.approx(8.0 * ex._ms_per_mb)
        assert ex._rate_for(self.B) < ex._rate_by_key[self.B]
        # an unknown key reads the global
        assert ex._rate_for(("never-drained",)) == pytest.approx(ex._ms_per_mb)
        assert ex.debug_snapshot()["rate_keys"] == 2

    def test_the_257th_key_resets_the_table(self, make_ex):
        ex = make_ex()
        model: dict = {}
        self._drain(ex, model, self.A, 2.0)
        self._drain(ex, model, self.B, 3.0)
        for i in range(254):
            self._drain(ex, model, ("filler", i), 2.5)
        assert len(ex._rate_by_key) == 256
        self._drain(ex, model, ("the-257th",), 4.0)
        assert list(ex._rate_by_key) == [("the-257th",)]
        assert ex._rate_for(self.B) == pytest.approx(ex._ms_per_mb)
        assert ex.debug_snapshot()["rate_keys"] == 1

    def test_a_chunk_of_two_keys_prices_only_the_global(self, make_ex):
        ex = make_ex()
        ex._note_drain([_Drained(self.A), _Drained(self.B)], 4.0)
        assert ex._ms_per_mb == pytest.approx(2.0)
        assert ex._rate_by_key == {}

    def test_a_dear_key_spills_where_the_global_would_not(self, make_ex, monkeypatch):
        """The item's own term and the owed ledger read its key's price."""
        ex = make_ex(host_spill=True, probe_interval=10**9)
        monkeypatch.setattr(executor_mod.host_exec, "can_execute", lambda *a, **k: True)
        item = executor_mod._Item(_img(64, 64), _resize_plan(64, 64, 32))
        ex._host_ms_per_mpix = 8.0
        # the global prices the item at a third of the host's cost x the
        # spill factor, its key at 8x that
        host_ms = ex.config.spill_factor * item.mpix * ex._host_ms_per_mpix
        ex._ms_per_mb = host_ms / item.wire_mb / 3.0
        assert not ex._should_spill(item)
        with ex._lock:
            ex._rate_by_key[item.key] = 100.0 * ex._ms_per_mb  # capped at 8x
        dear = 8.0 * ex._ms_per_mb
        assert ex._rate_for(item.key) == pytest.approx(dear)
        assert ex._should_spill(item)
        # a queued item of the dear key owes its MB at 8x the global
        with ex._lock:
            ex._charge_owed(item)
            owed = ex._owed_ms_locked()
        assert owed == pytest.approx(item.wire_mb * dear)
        assert ex.estimated_wait_ms() == pytest.approx(owed)
        item.future.cancel()
        assert ex.estimated_wait_ms() == 0.0 and ex.stats.device_owed_mb == 0.0


def test_rate_keys_on_debugz():
    """`rate_keys` rides the executor's snapshot, which /debugz serves, as
    in the reference (its /health executor block is ExecutorStats, which
    has no such key)."""
    import asyncio
    import io

    from aiohttp.test_utils import TestClient, TestServer

    from imaginary_tpu_torch.web.app import create_app
    from imaginary_tpu_torch.web.config import ServerOptions

    async def run():
        app = create_app(ServerOptions(device="cpu", enable_debug=True),
                         log_stream=io.StringIO())
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            ex = app["service"].executor
            ex._note_drain([_Drained(("k",))], 1.0)
            body = await (await client.get("/debugz")).json()
            health = await (await client.get("/health")).json()
        finally:
            await client.close()
        return body, health

    body, health = asyncio.run(run())
    assert body["executor"]["rate_keys"] == 1
    assert "rate_keys" not in health["executor"]
    assert "rate_keys" not in jexecutor.ExecutorStats().to_dict()
