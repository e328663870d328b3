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
