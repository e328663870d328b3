"""The port's per-GPU batching lanes on the CPU (mirrors tests/test_lanes.py
for `imaginary_tpu_torch/engine/lanes.py` and the executor's lane loops).

Lanes run over meshes of `cpu` entries (four entries on one device, as
four lanes share one card on the chip):
  * placement: (queue depth x EWMA) scoring, frame-key affinity with the
    imbalance fallback, and, since the port's plans carry no frame key
    (no device frame cache yet), least-loaded placement of real items;
  * parity: mesh_policy "off" builds no lane object, adds no key, and
    serves the direct chain's bytes; lanes serve `run_batch`'s bytes;
  * routing: chunks below shard_min_items ride one lane; at the threshold
    a chunk splits over the mesh's entries, sub-chunk sizes sum to the
    chunk, and the outputs are equal;
  * degraded mesh: `device.chip_error[0]` drains lane 0 with every ledger
    at rest and the mesh generation +1; re-admission makes it +2;
  * the stats and debug snapshot keys, and launch counts that stay exact
    under eight launching threads.

The reference's compile-key, prewarm and `wire_bytes_by_device` classes
are not mirrored: their subjects are XLA-only or not ported yet (ROADMAP
queue 1). Its spatial-route test is mirrored in
tests/test_torch_spatial_route.py.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from imaginary_tpu_torch import failpoints, kernels
from imaginary_tpu_torch.engine import Executor, ExecutorConfig
from imaginary_tpu_torch.engine import lanes as lanes_mod
from imaginary_tpu_torch.engine.executor import _Item
from imaginary_tpu_torch.engine.timing import WIRE
from imaginary_tpu_torch.kernels import build as kbuild
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.plan import plan_operation
from imaginary_tpu_torch.options import ImageOptions

WAIT_S = 60

# ExecutorStats.to_dict()'s keys without lanes
OFF_KEYS = {"items", "batches", "groups", "avg_batch", "avg_group", "max_group",
            "queue_depth", "compile_cache_size", "batch_form_p50_ms",
            "batch_form_p99_ms", "dispatch_wait_p50_ms", "dispatch_wait_p99_ms",
            "device_failures", "device_owed_mb", "compile_misses", "copied_bytes",
            "copy_events", "spilled", "spill_errors", "breaker_opens",
            "breaker_host_served", "shadow_probes", "hedges", "oom_events",
            "oom_splits", "oom_host_routed", "oom_failed", "device_ms_per_mb",
            "host_ms_per_mpix", "host_inflight", "host_owed_mpix",
            "host_spill_p50_ms", "host_spill_p99_ms", "donation_enabled",
            "donation_rejected", "pressure_host_forced", "pressure_capped_batches",
            "wire_bytes", "wire_transfers"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_failpoints():
    yield
    failpoints.deactivate()


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
        threads = [ex._thread, ex._fetcher]
        if ex._lanes is not None:
            threads += [t for ln in ex._lanes.lanes for t in (ln.collector, ln.fetcher)]
        assert not any(t.is_alive() for t in threads)


def _img(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _resize_plan(h, w, width=48):
    return plan_operation("resize", ImageOptions(width=width), h, w, 0, 3)


def _direct(arr, plan):
    return chain_mod.run_batch([arr], [plan], device="cpu")[0]


def _wait_for(cond, seconds=10.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


class _FakeItem:
    """Placement stand-in: place() reads .plan.frame_key and .future (the
    ledger primitives read .lane)."""

    class _Plan:
        def __init__(self, fk):
            self.frame_key = fk

    def __init__(self, frame_key=None):
        self.plan = self._Plan(frame_key)
        self.future = Future()
        self.lane = None
        self.hops = 0


# -- placement (the scheduler alone) -------------------------------------------


class TestLanePlacement:
    def test_least_loaded_by_depth_times_ewma(self):
        fast = lanes_mod.Lane(0, None)
        slow = lanes_mod.Lane(1, None)
        fast.note_service(10.0)
        slow.note_service(100.0)
        sched = lanes_mod.LaneScheduler([fast, slow])
        assert sched.place(_FakeItem()) is fast
        for _ in range(10):
            lanes_mod._lane_owe(fast, _FakeItem())
        assert sched.place(_FakeItem()) is slow

    def test_affinity_prefers_the_lane_of_the_last_placement(self):
        a, b = lanes_mod.Lane(0, None), lanes_mod.Lane(1, None)
        sched = lanes_mod.LaneScheduler([a, b])
        it1 = _FakeItem(frame_key="digest-1")
        first = sched.place(it1)
        lanes_mod._lane_owe(first, it1)
        again = sched.place(_FakeItem(frame_key="digest-1"))
        assert again is first
        assert first.affinity_hits >= 1

    def test_imbalance_falls_back_to_least_loaded(self):
        a, b = lanes_mod.Lane(0, None), lanes_mod.Lane(1, None)
        sched = lanes_mod.LaneScheduler([a, b], imbalance=2.0)
        it1 = _FakeItem(frame_key="digest-2")
        first = sched.place(it1)
        other = b if first is a else a
        for _ in range(20):
            lanes_mod._lane_owe(first, _FakeItem())
        chosen = sched.place(_FakeItem(frame_key="digest-2"))
        assert chosen is other
        assert other.affinity_misses >= 1
        assert sched.place(_FakeItem(frame_key="digest-2")) is other

    def test_quarantined_and_excluded_lanes_skipped(self):
        a, b = lanes_mod.Lane(0, None), lanes_mod.Lane(1, None)
        sched = lanes_mod.LaneScheduler([a, b])
        a.active = False
        assert sched.place(_FakeItem()) is b
        assert sched.place(_FakeItem(), exclude={1}) is None

    def test_owe_moves_charge_and_done_callback_refunds(self):
        a, b = lanes_mod.Lane(0, None), lanes_mod.Lane(1, None)
        it = _FakeItem()
        lanes_mod._lane_owe(a, it)
        assert (a.owed, b.owed) == (1, 0)
        lanes_mod._lane_owe(b, it)
        assert (a.owed, b.owed) == (0, 1)
        it.future.set_result(None)
        assert (a.owed, b.owed) == (0, 0)
        assert it.lane is None

    def test_port_items_carry_no_frame_key_so_placement_is_least_loaded(self):
        """No device frame cache in the port yet: a repeated image gets no
        affinity, and each item goes to the lane with the lowest score."""
        lanes = [lanes_mod.Lane(i, None) for i in range(3)]
        sched = lanes_mod.LaneScheduler(lanes)
        arr, plan = _img(96, 96), _resize_plan(96, 96)
        placed = []
        for _ in range(6):
            it = _Item(arr, plan)
            ln = sched.place(it)
            lanes_mod._lane_owe(ln, it)
            placed.append(ln.idx)
        assert sorted(placed) == [0, 0, 1, 1, 2, 2]
        assert all(ln.affinity_hits == ln.affinity_misses == 0 for ln in lanes)

    def test_lane_snapshot_keys(self):
        ln = lanes_mod.Lane(3, torch.device("cpu"))
        snap = ln.snapshot()
        assert snap["lane"] == 3 and snap["active"] is True
        for k in ("queued", "inflight", "dispatches", "ewma_ms", "served_ms",
                  "served_items", "affinity_hits", "affinity_misses",
                  "affinity_hit_ratio"):
            assert k in snap


# -- parity ---------------------------------------------------------------------


class TestPolicyOffParity:
    def test_off_builds_no_lanes_and_serves_identical_bytes(self, make_ex):
        arr, plan = _img(96, 96, seed=3), _resize_plan(96, 96)
        WIRE.reset()  # no labelled bytes from an earlier sharded launch
        ex = make_ex(max_form_ms=1.0)
        # no lane object; the device is one fault domain of its own
        assert ex._lanes is None and len(ex.devhealth) == 1
        out = ex.submit(arr, plan).result(timeout=WAIT_S)
        np.testing.assert_array_equal(out, _direct(arr, plan))
        assert set(ex.stats.to_dict()) == OFF_KEYS
        assert "lanes" not in ex.debug_snapshot()

    @pytest.mark.parametrize("policy", ["lanes", "sharded", "auto"])
    def test_lanes_serve_same_bytes_as_run_batch(self, make_ex, policy):
        ex = make_ex(mesh_policy=policy, n_devices=4, max_form_ms=20.0)
        jobs = []
        for i in range(12):
            h, w = (96, 96) if i % 2 else (80, 120)
            jobs.append((_img(h, w, seed=i), _resize_plan(h, w, 40 + i % 3)))
        futs = [ex.submit(a, p) for a, p in jobs]
        for (a, p), f in zip(jobs, futs):
            np.testing.assert_array_equal(f.result(timeout=WAIT_S), _direct(a, p))
        assert len(ex._lanes.lanes) == 4
        assert ex.stats.device_failures == 0

    def test_lanes_on_cuda_without_a_card_are_refused(self):
        """No silent CPU fallback for the lanes' mesh either."""
        if torch.cuda.is_available():
            return
        before = threading.active_count()
        for kw in ({}, {"devices": ["cuda:0"] * 2}):
            with pytest.raises((RuntimeError, ValueError)):
                Executor(ExecutorConfig(device="cuda", mesh_policy="lanes", **kw))
        assert threading.active_count() == before

    def test_unknown_policy_is_refused(self):
        with pytest.raises(ValueError, match="unknown mesh policy"):
            Executor(ExecutorConfig(device="cpu", mesh_policy="ring"))


# -- routing --------------------------------------------------------------------


class TestShardedRouting:
    def _spy(self, monkeypatch):
        """Record every launch; a sharded launch also records the sizes of
        the sub-launches its own thread made inside it."""
        calls = {"batch": [], "sharded": []}
        real_batch, real_sharded = chain_mod.launch_batch, chain_mod.launch_sharded
        local = threading.local()

        def batch(arrs, plans, device="cuda", stream=None, **kw):
            calls["batch"].append({"n": len(arrs), "device": device})
            subs = getattr(local, "subs", None)
            if subs is not None:
                subs.append(len(arrs))
            return real_batch(arrs, plans, device=device, stream=stream, **kw)

        def sharded(arrs, plans, mesh, streams=None):
            local.subs = []
            try:
                return real_sharded(arrs, plans, mesh, streams)
            finally:
                calls["sharded"].append({"n": len(arrs), "mesh": mesh.shape,
                                         "subs": local.subs})
                local.subs = None

        monkeypatch.setattr(chain_mod, "launch_batch", batch)
        monkeypatch.setattr(chain_mod, "launch_sharded", sharded)
        return calls

    def test_below_threshold_rides_one_lane(self, monkeypatch, make_ex):
        calls = self._spy(monkeypatch)
        ex = make_ex(mesh_policy="sharded", n_devices=4, max_form_ms=2.0,
                     shard_min_items=8)
        arr, plan = _img(96, 96), _resize_plan(96, 96)
        futs = [ex.submit(arr, plan) for _ in range(2)]
        for f in futs:
            np.testing.assert_array_equal(f.result(timeout=WAIT_S), _direct(arr, plan))
        assert calls["batch"] and not calls["sharded"]

    def test_at_threshold_splits_over_the_mesh(self, monkeypatch, make_ex):
        calls = self._spy(monkeypatch)
        ex = make_ex(mesh_policy="sharded", n_devices=4, max_form_ms=50.0,
                     shard_min_items=2, max_batch=16)
        jobs = [(_img(96, 96, seed=i), _resize_plan(96, 96)) for i in range(16)]
        futs = [ex.submit(a, p) for a, p in jobs]
        for (a, p), f in zip(jobs, futs):
            np.testing.assert_array_equal(f.result(timeout=WAIT_S), _direct(a, p))
        assert calls["sharded"]
        for call in calls["sharded"]:
            assert call["mesh"] == (4, 1)
            sizes = call["subs"]
            assert len(sizes) == min(call["n"], 4)
            assert sum(sizes) == call["n"] and max(sizes) - min(sizes) <= 1
        assert ex.debug_snapshot()["lanes"]["shard_min_items"] == 2

    def test_default_threshold_is_twice_the_batch_axis(self, make_ex):
        ex = make_ex(mesh_policy="auto", n_devices=4)
        assert ex._shard_min() == 8
        lanes = make_ex(mesh_policy="lanes", n_devices=4)
        assert lanes._lane_mesh is None


# -- degraded mesh --------------------------------------------------------------


class TestDegradedMesh:
    def test_quarantine_drains_lane_and_ledgers_rest(self, make_ex):
        ex = make_ex(mesh_policy="sharded", n_devices=4, max_form_ms=1.0,
                     breaker_threshold=1, breaker_cooldown_s=300.0)
        arr, plan = _img(96, 96), _resize_plan(96, 96)
        want = _direct(arr, plan)
        for _ in range(4):
            ex.submit(arr, plan).result(timeout=WAIT_S)
        gen0 = ex._mesh_generation
        failpoints.activate("device.chip_error[0]=error")
        futs = [ex.submit(arr, plan) for _ in range(24)]
        outs = [f.result(timeout=WAIT_S) for f in futs]
        assert len(outs) == 24
        assert all(np.array_equal(o, want) for o in outs)
        failpoints.deactivate()
        lane0 = ex._lanes.lane(0)
        assert _wait_for(lambda: not lane0.active)
        assert ex._mesh_generation - gen0 == 1
        assert _wait_for(lambda: all(ln.owed == 0 and ln.inflight == 0
                                     for ln in ex._lanes.lanes))
        snap = ex.stats.to_dict()
        assert [s["active"] for s in snap["lanes"]].count(False) == 1
        assert snap["mesh_generation"] == ex._mesh_generation
        assert ex._lane_mesh.shape == (3, 1)  # sharded dispatch over survivors
        assert ex.devhealth.snapshot()["quarantined"] == 1

    def test_readmission_restores_lane_and_bumps_generation(self, make_ex):
        ex = make_ex(mesh_policy="lanes", n_devices=4, max_form_ms=1.0,
                     breaker_threshold=1, breaker_cooldown_s=3.0)
        arr, plan = _img(96, 96), _resize_plan(96, 96)
        for _ in range(4):
            ex.submit(arr, plan).result(timeout=WAIT_S)
        gen0 = ex._mesh_generation
        failpoints.activate("device.chip_error[0]=error")
        futs = [ex.submit(arr, plan) for _ in range(8)]
        for f in futs:
            f.result(timeout=WAIT_S)
        failpoints.deactivate()
        lane0 = ex._lanes.lane(0)
        deadline = time.monotonic() + 15.0
        while not lane0.active and time.monotonic() < deadline:
            ex.submit(arr, plan).result(timeout=WAIT_S)
            time.sleep(0.1)
        assert lane0.active
        assert ex._mesh_generation - gen0 == 2
        assert ex.devhealth.record(0).readmissions == 1

    def _quarantine_every_lane(self, ex, arr, plan):
        """An error storm on every entry: each answer is either the
        failpoint's error or the direct chain's bytes; every lane ends
        quarantined."""
        failpoints.activate("device.chip_error=error")
        try:
            futs = [ex.submit(arr, plan) for _ in range(6)]
            for f in futs:
                exc = f.exception(timeout=WAIT_S)
                if exc is None:
                    np.testing.assert_array_equal(f.result(), _direct(arr, plan))
                else:
                    assert isinstance(exc, failpoints.FailpointError)
            assert _wait_for(lambda: not any(ln.active for ln in ex._lanes.lanes))
        finally:
            failpoints.deactivate()

    def test_every_lane_quarantined_falls_through_to_the_global_pair(self, make_ex):
        """With every lane quarantined and host placement off (the port's
        default), work falls through to the global pair's ladder, which
        still launches on the primary entry: the direct chain's bytes, on
        the device, and no lane dispatches."""
        from imaginary_tpu_torch.engine import executor as ex_mod

        ex = make_ex(mesh_policy="lanes", n_devices=2, max_form_ms=1.0,
                     breaker_threshold=1, breaker_cooldown_s=300.0)
        arr, plan = _img(96, 96), _resize_plan(96, 96)
        self._quarantine_every_lane(ex, arr, plan)
        ex_mod.reset_placement()
        out = ex.process(arr, plan, timeout=WAIT_S)
        np.testing.assert_array_equal(out, _direct(arr, plan))
        assert ex_mod.last_placement() == "device"
        assert ex.stats.breaker_host_served == 0 and ex.stats.spilled == 0
        assert all(ln.dispatches == 0 for ln in ex._lanes.lanes)

    def test_every_lane_quarantined_with_host_spill_serves_host_work_on_the_host(
            self, make_ex, monkeypatch):
        """With host placement on (the reference's auto), host-executable
        work is served by the host for the outage, counted in
        breaker_host_served and within integrity's bars (max 96, mean 16)
        of the direct chain; a device-only plan still falls through to the
        global pair, bit-equal, and no lane dispatches."""
        from imaginary_tpu_torch.engine import executor as ex_mod
        from imaginary_tpu_torch.engine import host_exec

        ex = make_ex(mesh_policy="lanes", n_devices=2, max_form_ms=1.0,
                     breaker_threshold=1, breaker_cooldown_s=300.0, host_spill=True)
        arr, plan = _img(96, 96), _resize_plan(96, 96)
        self._quarantine_every_lane(ex, arr, plan)
        served = ex.stats.breaker_host_served
        ex_mod.reset_placement()
        out = ex.process(arr, plan, timeout=WAIT_S)
        assert ex_mod.last_placement() == "host"
        assert ex.stats.breaker_host_served == served + 1
        want = _direct(arr, plan)
        assert out.shape == want.shape
        d = np.abs(out.astype(np.int16) - want.astype(np.int16))
        assert d.max() <= 96 and d.mean() <= 16
        monkeypatch.setattr(host_exec, "can_execute", lambda plan, for_spill=True: False)
        out = ex.submit(arr, plan).result(timeout=WAIT_S)
        np.testing.assert_array_equal(out, want)
        assert all(ln.dispatches == 0 for ln in ex._lanes.lanes)


# -- observability --------------------------------------------------------------


class TestLaneObservability:
    def test_stats_and_debug_snapshots(self, make_ex):
        WIRE.reset()  # no labelled bytes from an earlier sharded launch
        ex = make_ex(mesh_policy="lanes", n_devices=4, max_form_ms=1.0)
        arr, plan = _img(96, 96), _resize_plan(96, 96)
        futs = [ex.submit(arr, plan) for _ in range(8)]
        for f in futs:
            f.result(timeout=WAIT_S)
        d = ex.stats.to_dict()
        assert set(d) == OFF_KEYS | {"lanes", "mesh_generation"}
        assert len(d["lanes"]) == 4
        for s in d["lanes"]:
            for k in ("lane", "active", "queued", "inflight", "dispatches",
                      "ewma_ms", "affinity_hit_ratio"):
                assert k in s
        assert sum(s["dispatches"] for s in d["lanes"]) == d["batches"] >= 1
        dz = ex.debug_snapshot()["lanes"]
        assert dz["policy"] == "lanes"
        assert "stage_times" in dz and "mesh_generation" in dz
        dh = ex.devhealth.snapshot()
        assert len(dh["lanes"]) == 4 and dh["count"] == 4


# -- launch counts under concurrent lanes ---------------------------------------


def test_launch_counts_stay_exact_under_eight_launching_threads(monkeypatch):
    """Eight threads launch through `kernels._launch` at once, the first of
    them loading the libraries: the load happens once and every count is
    exact. The C functions, the library build and the CUDA device and
    stream are stand-ins, since the CPU has no card."""
    builds = []

    def fake_build_all(names=kbuild.KERNELS):
        builds.append(names)
        time.sleep(0.05)  # the other threads arrive while this one builds
        return {n: {"path": n, "seconds": 0.0, "log": ""} for n in names}

    class _Lib:
        def __getattr__(self, symbol):
            def fn(*args):
                time.sleep(0)  # yield to the other threads mid-launch
                return 0
            return fn

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(kbuild, "build_all", fake_build_all)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: _Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    monkeypatch.setattr(kernels, "_FNS", {})
    kernels.reset_launches()
    n_iter = 300
    start = threading.Barrier(8)

    def worker():
        start.wait()
        for _ in range(n_iter):
            kernels._launch("saliency", "cuda", passes=2)
            kernels._launch("blur_halo", "cuda")
            kernels._launch("gather", "cuda")

    threads = [threading.Thread(target=worker) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        counts = kernels.launch_counts()
    finally:
        kernels.reset_launches()
    assert len(builds) == 1
    assert counts["saliency"] == 8 * n_iter * 2
    assert counts["blur_halo"] == 8 * n_iter
    assert counts["gather"] == 8 * n_iter
    assert counts["resample"] == 0
