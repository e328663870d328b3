"""The port's output integrity (`engine/integrity.py`), its devhealth
branches and the executor's verification, poison and OOM bisection, on
the CPU: port copies of tests/test_integrity.py's classes, on executors of
`device="cpu"` whose kernels are the plain versions, and the golden
triple held equal between the packages (input and plan exactly, the host
reference within 1 LSB).

Adapted where the port differs: a second device is `n_devices=2` of the
CPU, so a sick device 0 is the keyed `device.chip_error[0]` failpoint (the
CPU entries are not told apart by the launch's device argument); /health
is a service's (`ImageService(device="cpu", integrity=True, ...)`).
"""

import time
import unittest.mock as mock

import numpy as np
import pytest
import torch

from imaginary_tpu.engine import integrity as jintegrity
from imaginary_tpu_torch import failpoints
from imaginary_tpu_torch.engine import Executor, ExecutorConfig, host_exec
from imaginary_tpu_torch.engine import integrity as integrity_mod
from imaginary_tpu_torch.engine.devhealth import (
    STATE_DEGRADED,
    STATE_HEALTHY,
    CorruptionError,
    DeviceHealthRegistry,
)
from imaginary_tpu_torch.engine.integrity import (
    IntegrityConfig,
    IntegrityState,
    corrupt_copy,
    item_digest,
    outputs_match,
)
from imaginary_tpu_torch.options import ImageOptions
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.plan import plan_operation
from tests.test_torch_plan import assert_same_plan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def Executor_(window_ms=1, **kw):  # noqa: N802 - the reference's call shape
    return Executor(ExecutorConfig(device="cpu", max_form_ms=window_ms, **kw))


def _img(h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _plan(h=96, w=128, width=48):
    return plan_operation("resize", ImageOptions(width=width), h, w, 0, 3)


def _integ(**kw):
    kw.setdefault("enabled", True)
    return IntegrityState(IntegrityConfig(**kw))


# --- checksum / golden math ---------------------------------------------------


class TestChecksumAndGolden:
    def test_output_checksum_deterministic_and_content_sensitive(self):
        a = _img(seed=1)
        assert chain_mod.output_checksum(a) == chain_mod.output_checksum(a.copy())
        b = a.copy()
        b[0, 0, 0] ^= 0x80
        assert chain_mod.output_checksum(a) != chain_mod.output_checksum(b)
        assert chain_mod.output_checksum(None) == 0

    def test_output_checksum_covers_all_yuv_planes(self):
        from imaginary_tpu_torch.codecs import YuvPlanes

        p = YuvPlanes(y=_img(seed=2)[:, :, 0], u=_img(24, 32, 3)[:, :, 0],
                      v=_img(24, 32, 4)[:, :, 0])
        base = chain_mod.output_checksum(p)
        v2 = p.v.copy()
        v2[0, 0] ^= 0x80
        assert base != chain_mod.output_checksum(
            YuvPlanes(y=p.y, u=p.u, v=v2))

    def test_golden_case_cached_and_deterministic(self):
        g1 = integrity_mod.golden()
        g2 = integrity_mod.golden()
        assert g1 is g2  # computed once at boot, cached
        from imaginary_tpu_torch.prewarm import golden_case, golden_input

        assert np.array_equal(golden_input(), golden_input())
        arr, plan, ref = golden_case()
        assert ref.shape == (36, 48, 3)
        assert np.array_equal(ref, g1[2])

    def test_golden_device_run_matches_host_reference(self):
        arr, plan, ref = integrity_mod.golden()
        out = chain_mod.run_single(arr, plan, device="cpu")
        assert outputs_match(out, ref, exact=False)
        # and a corrupted device run does NOT
        assert not outputs_match(corrupt_copy(out), ref, exact=False)

    def test_outputs_match_dual_tolerance(self):
        a = _img(seed=3)
        # honest kernel-level divergence: small max, small mean -> match
        jitter = a.astype(np.int16)
        jitter[0, 0, 0] += 40  # one pixel, under the max bar
        assert outputs_match(np.clip(jitter, 0, 255).astype(np.uint8), a,
                             exact=False)
        # widespread moderate divergence trips the MEAN bar even though
        # no single pixel trips the max bar
        smear = np.clip(a.astype(np.int16) + 40, 0, 255).astype(np.uint8)
        assert not outputs_match(smear, a, exact=False)
        # exact mode: any bit difference is a mismatch
        one = a.copy()
        one[0, 0, 0] ^= 1
        assert outputs_match(one, a, exact=False)
        assert not outputs_match(one, a, exact=True)

    def test_outputs_match_shape_mismatch_is_mismatch(self):
        assert not outputs_match(_img(10, 10), _img(10, 12), exact=False)

    def test_corrupt_copy_never_mutates_the_original(self):
        a = _img(seed=4)
        keep = a.copy()
        c = corrupt_copy(a)
        assert np.array_equal(a, keep)
        assert not np.array_equal(c, a)


# --- devhealth: corruption strikes + the EWMA seeding fix ---------------------


class TestCorruptionStrikes:
    def test_corruption_quarantines_instantly_crash_needs_three(self):
        reg = DeviceHealthRegistry(2, threshold=3, cooldown_s=60)
        reg.note_failure(0)
        assert not reg.is_quarantined(0)  # one crash strike: still closed
        assert reg.note_corruption(1, "bad bytes")
        assert reg.is_quarantined(1)  # one corruption strike: open
        assert reg.record(1).corruptions == 1
        assert [s["kind"] for s in reg.strike_history()] == ["corruption"]

    def test_clean_probe_debt_gates_readmission(self):
        reg = DeviceHealthRegistry(2, threshold=3, cooldown_s=0.0)
        reg.note_corruption(1, "bad", clean_probes=3)
        reg.note_probe_ok(1, latency_ms=2.0)
        reg.note_probe_ok(1, latency_ms=2.0)
        assert reg.record(1).quarantined_until > 0.0  # 2 clean: still open
        reg.note_probe_ok(1, latency_ms=2.0)
        assert reg.record(1).quarantined_until == 0.0  # 3rd clean re-admits
        assert reg.record(1).readmissions == 1

    def test_request_success_clears_debt_single_device_degeneration(self):
        # with one device the next REQUEST is the probe (the one-device half-open rule):
        # note_ok must clear the debt or the only capacity stays locked out
        reg = DeviceHealthRegistry(1, threshold=3, cooldown_s=0.0)
        reg.note_corruption(0, "bad", clean_probes=5)
        reg.note_ok(0)
        assert reg.record(0).clean_probes_needed == 0
        assert reg.record(0).quarantined_until == 0.0

    def test_probe_loop_books_corruption_error_as_corruption(self):
        reg = DeviceHealthRegistry(2, threshold=1, cooldown_s=0.1)
        reg.note_failure(1)

        def probe(idx):
            raise CorruptionError("golden mismatch")

        reg.start_probing(probe, timeout_s=2.0)
        try:
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if reg.record(1).corruptions >= 1:
                    break
                time.sleep(0.05)
            assert reg.record(1).corruptions >= 1
            assert reg.record(1).clean_probes_needed >= 1
        finally:
            reg.close()

    def test_probe_fn_returned_latency_wins_over_wall_clock(self):
        """The golden probe returns its own warm-run milliseconds (a
        compile-contaminated first run re-times) — the loop must book
        that, not the wall clock that includes the compile."""
        reg = DeviceHealthRegistry(2, threshold=1, cooldown_s=0.1)
        reg.configure_failslow(2.0, min_samples=1, share=0.0)
        reg.note_failure(1)

        def probe(idx):
            time.sleep(0.05)  # "compile" the wall clock would see
            return 3.25

        reg.start_probing(probe, timeout_s=2.0)
        try:
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if reg.record(1).probe_latency_samples >= 1:
                    break
                time.sleep(0.05)
            assert reg.record(1).probe_latency_ewma_ms == pytest.approx(3.25)
        finally:
            reg.close()

    def test_latency_ewma_zero_first_sample_seeds_once(self):
        # `== 0.0` would treat a genuine 0.0 ms first
        # sample as "unseeded" and re-seed the EWMA on every sample
        reg = DeviceHealthRegistry(1)
        reg.note_ok(0, latency_ms=0.0)
        reg.note_ok(0, latency_ms=100.0)
        assert reg.record(0).latency_ewma_ms == pytest.approx(20.0)
        assert reg.record(0).latency_samples == 2


# --- fail-slow demotion -------------------------------------------------------


def _feed(reg, idx, ms, n):
    for _ in range(n):
        reg.note_probe_ok(idx, latency_ms=ms)


class TestFailslow:
    def test_demote_on_ratio_with_min_sample_hysteresis(self):
        reg = DeviceHealthRegistry(2)
        reg.configure_failslow(2.0, min_samples=3, share=0.0)
        _feed(reg, 1, 10.0, 3)
        _feed(reg, 0, 100.0, 2)
        assert not reg.record(0).degraded  # under min_samples: no verdict
        _feed(reg, 0, 100.0, 1)
        r0 = reg.record(0)
        assert r0.degraded
        assert r0.state(time.monotonic()) == STATE_DEGRADED
        assert r0.demotions == 1
        snap = reg.snapshot()
        assert snap["degraded"] == 1 and snap["healthy"] == 1

    def test_single_device_no_op_degeneration(self):
        reg = DeviceHealthRegistry(1)
        reg.configure_failslow(2.0, min_samples=2, share=0.0)
        _feed(reg, 0, 500.0, 10)
        assert not reg.record(0).degraded  # no peers, no verdict, ever
        assert reg.pick() == 0

    def test_degraded_sheds_to_healthy_peer_and_half_open_beats_nothing(self):
        reg = DeviceHealthRegistry(2)
        reg.configure_failslow(2.0, min_samples=2, share=0.0)
        _feed(reg, 1, 10.0, 2)
        _feed(reg, 0, 100.0, 2)
        assert reg.pick() == 1  # full shed off the degraded primary
        # but a degraded chip still beats no chip at all
        assert reg.pick(exclude={1}) == 0

    def test_degraded_share_keeps_weighted_trickle(self):
        reg = DeviceHealthRegistry(2)
        reg.configure_failslow(2.0, min_samples=2, share=0.5)
        _feed(reg, 1, 10.0, 2)
        _feed(reg, 0, 100.0, 2)
        picks = [reg.pick() for _ in range(8)]
        assert picks.count(0) == 4  # every 2nd pick rides the degraded chip
        assert picks.count(1) == 4

    def test_readmit_hysteresis_at_half_the_demotion_bar(self):
        reg = DeviceHealthRegistry(2)
        reg.configure_failslow(2.0, min_samples=2, share=0.0, strikes=100)
        _feed(reg, 1, 10.0, 2)
        _feed(reg, 0, 100.0, 2)
        assert reg.record(0).degraded
        # hovering between the readmit bar (10) and the demote bar (20):
        # stays degraded — no flapping
        _feed(reg, 0, 15.0, 6)
        assert reg.record(0).degraded
        # well under the readmit bar: recovers
        _feed(reg, 0, 2.0, 10)
        assert not reg.record(0).degraded
        assert reg.record(0).state(time.monotonic()) == STATE_HEALTHY

    def test_keeps_slipping_quarantines_and_slow_probes_cannot_readmit(self):
        reg = DeviceHealthRegistry(2, cooldown_s=0.1)
        reg.configure_failslow(2.0, min_samples=2, share=0.0, strikes=3)
        _feed(reg, 1, 10.0, 2)
        _feed(reg, 0, 100.0, 2)  # demoted
        _feed(reg, 0, 100.0, 3)  # three more slow: quarantine
        r0 = reg.record(0)
        assert reg.is_quarantined(0)
        assert r0.failslow_quarantines == 1
        kinds = [s["kind"] for s in reg.strike_history()]
        assert kinds == ["failslow_demote", "failslow_quarantine"]
        time.sleep(0.15)  # cooldown expires -> half-open
        reg.note_probe_ok(0, latency_ms=100.0)
        assert r0.quarantined_until > 0.0  # clean-but-slow: NOT re-admitted
        _feed(reg, 0, 2.0, 20)  # probe EWMA recovers through the bar
        assert r0.quarantined_until == 0.0
        assert r0.readmissions == 1
        # re-admission reset the latency trust it re-enters with
        assert r0.probe_latency_samples < 20


# --- executor: sampled cross-verification ------------------------------------


class TestSampledVerification:
    def teardown_method(self):
        failpoints.deactivate()

    def test_should_sample_cadence_deterministic(self):
        st = _integ(sample=0.25)
        assert [st.should_sample() for _ in range(8)] == [
            False, False, False, True, False, False, False, True]
        assert _integ(sample=0.0).should_sample() is False
        off = IntegrityState(IntegrityConfig(enabled=False, sample=1.0))
        assert off.should_sample() is False

    def test_clean_traffic_verifies_without_mismatch(self):
        integ = _integ(sample=1.0)
        ex = Executor_(window_ms=1, host_spill=False,
                                     integrity=integ)
        try:
            out = ex.process(_img(), _plan(), timeout=120)
            assert out.shape == (36, 48, 3)
            assert integ.checks >= 1
            assert integ.mismatches == 0
        finally:
            ex.shutdown()

    def test_corrupt_device_mismatch_strike_and_transparent_reserve(self):
        integ = _integ(sample=1.0)
        ex = Executor_(window_ms=1, host_spill=False,
                                     integrity=integ)
        try:
            ex.process(_img(), _plan(), timeout=120)  # warm + clean
            failpoints.activate("device.corrupt[0]=error")
            fut = ex.submit(_img(seed=1), _plan())
            out = fut.result(timeout=120)
            # the released bytes are the VERIFIED host copy, not the
            # corrupted device output
            assert np.array_equal(out, host_exec.run(_img(seed=1), _plan()))
            assert getattr(fut, "_hedge_placement", None) == "host"
            assert integ.mismatches >= 1
            assert integ.reserved == integ.mismatches
            # the lying chip took a corruption strike and quarantined alone
            assert ex.devhealth.is_quarantined(0)
            assert ex.devhealth.record(0).corruptions >= 1
            if len(ex.devhealth) > 1:
                assert not ex.devhealth.is_quarantined(1)
        finally:
            failpoints.deactivate()
            ex.shutdown()

    def test_corruption_strike_counts_as_device_failure_stat(self):
        integ = _integ(sample=1.0)
        ex = Executor_(window_ms=1, host_spill=False,
                                     integrity=integ)
        try:
            failpoints.activate("device.corrupt[0]=error")
            ex.process(_img(seed=2), _plan(), timeout=120)
            assert ex.stats.device_failures >= 1
            snap = ex.devhealth.snapshot()
            assert snap["corruptions"] >= 1
        finally:
            failpoints.deactivate()
            ex.shutdown()


# --- poison quarantine list ---------------------------------------------------


class TestPoisonQuarantine:
    def test_ttl_expiry(self):
        st = _integ(poison_ttl_s=0.05)
        st.poison_add("d1")
        assert st.poison_hit("d1")
        time.sleep(0.08)
        assert not st.poison_hit("d1")
        assert st.poison_len() == 0
        assert st.poison_evictions >= 1

    def test_cap_evicts_oldest(self):
        st = _integ(poison_cap=2)
        for d in ("a", "b", "c"):
            st.poison_add(d)
        assert st.poison_len() == 2
        assert not st.poison_hit("a")  # oldest evicted
        assert st.poison_hit("b") and st.poison_hit("c")

    def test_item_digest_content_and_chain_sensitive(self):
        a, b = _img(seed=1), _img(seed=2)
        assert item_digest(a, ("k",)) == item_digest(a.copy(), ("k",))
        assert item_digest(a, ("k",)) != item_digest(b, ("k",))
        assert item_digest(a, ("k",)) != item_digest(a, ("other",))

    def test_poison_hit_routes_to_host_with_header(self):
        integ = _integ(sample=0.0)
        ex = Executor_(window_ms=1, host_spill=False,
                                     integrity=integ)
        try:
            arr, plan = _img(seed=7), _plan()
            from imaginary_tpu_torch.engine.executor import _Item

            integ.poison_add(item_digest(arr, _Item(arr, plan).key))
            fut = ex.submit(arr, plan)
            out = fut.result(timeout=120)
            assert np.array_equal(out, host_exec.run(arr, plan))
            assert getattr(fut, "_hedge_placement", None) is None  # submit path
            from imaginary_tpu_torch.engine.executor import last_placement

            assert last_placement() == "host"
            assert integ.poison_hits == 1
        finally:
            ex.shutdown()

    def test_poison_hit_422_when_host_inexecutable(self):
        from imaginary_tpu_torch.errors import ImageError

        integ = _integ(sample=0.0)
        ex = Executor_(window_ms=1, host_spill=False,
                                     integrity=integ)
        try:
            arr, plan = _img(seed=8), _plan()
            from imaginary_tpu_torch.engine.executor import _Item

            integ.poison_add(item_digest(arr, _Item(arr, plan).key))
            with mock.patch.object(host_exec, "can_execute",
                                   return_value=False):
                fut = ex.submit(arr, plan)
                with pytest.raises(ImageError) as ei:
                    fut.result(timeout=120)
            assert ei.value.code == 422
        finally:
            ex.shutdown()


# --- generalized bisect: poison conviction + OOM pinned -----------------------


def _marker_raiser(marker, real):
    def fn(arrs, plans, **kw):
        if any(a.shape == marker.shape and np.array_equal(a, marker)
               for a in arrs):
            raise RuntimeError("kernel launch failed: illegal address")
        return real(arrs, plans, **kw)
    return fn


class TestPoisonBisect:
    def test_bisect_convicts_poison_serves_siblings_no_strike(self):
        from imaginary_tpu_torch.engine import executor as ex_mod

        marker = _img(seed=99)
        integ = _integ(sample=0.0)
        ex = Executor_(window_ms=30, host_spill=False,
                                     integrity=integ)
        try:
            with mock.patch.object(
                ex_mod.chain_mod, "launch_batch",
                side_effect=_marker_raiser(marker, chain_mod.launch_batch)
            ), mock.patch.object(
                ex_mod.chain_mod, "run_batch",
                side_effect=_marker_raiser(marker, chain_mod.run_batch)
            ):
                futs = [ex.submit(_img(seed=i), _plan()) for i in (1, 2)]
                pfut = ex.submit(marker, _plan())
                for f in futs:
                    assert f.result(timeout=120).shape == (36, 48, 3)
                out = pfut.result(timeout=120)
                # the convict itself is host-routed, header says so
                assert getattr(pfut, "_hedge_placement", None) == "host"
                assert np.array_equal(out, host_exec.run(marker, _plan()))
            assert integ.poison_isolated == 1
            assert integ.poison_len() == 1
            # input-attributable: NO fault domain took a strike
            assert ex.devhealth.record(0).failures == 0
            assert not ex.devhealth.is_quarantined(0)
            # and the next submit of the same input short-circuits
            f2 = ex.submit(marker, _plan())
            f2.result(timeout=120)
            assert integ.poison_hits == 1
        finally:
            ex.shutdown()

    def test_whole_chunk_failure_still_reads_as_chip_fault(self):
        """Every item fails alone on device 0 -> the bisection rolls back and
        the failover ladder strikes and retries as without integrity."""
        integ = _integ(sample=0.0)
        ex = Executor_(window_ms=30, integrity=integ, n_devices=2)
        failpoints.activate("device.chip_error[0]=error")
        try:
            futs = [ex.submit(_img(seed=i), _plan()) for i in (1, 2)]
            for f in futs:
                assert f.result(timeout=120).shape == (36, 48, 3)
            # a device fault: device 0 struck, nothing convicted as poison
            assert ex.devhealth.record(0).failures >= 1
            assert integ.poison_isolated == 0
            assert integ.poison_len() == 0
        finally:
            failpoints.deactivate()
            ex.shutdown()


class TestOomBisectPinned:
    def teardown_method(self):
        failpoints.deactivate()

    def test_oom_recovery_unchanged_through_generalized_bisect(self):
        """The OOM contract, byte for byte: device.oom reads as
        CAPACITY — bisect/host-route, never a breaker strike, never a
        poison conviction — with integrity armed or not."""
        for integ in (None, _integ(sample=0.0)):
            failpoints.activate("device.oom=once(error)")
            # the reference's host_spill=False keeps its OOM host route; the
            # port's switch governs that route, so it is on here
            ex = Executor_(window_ms=1, host_spill=True,
                                         integrity=integ)
            try:
                out = ex.process(_img(seed=3), _plan(), timeout=120)
                assert out.shape == (36, 48, 3)
                assert ex.stats.oom_events == 1
                assert ex.stats.oom_failed == 0
                assert ex.stats.breaker_opens == 0
                assert ex.devhealth.record(0).oom_events == 1
                if integ is not None:
                    assert integ.poison_isolated == 0
            finally:
                failpoints.deactivate()
                ex.shutdown()

    def test_recover_oom_chunk_alias_preserved(self):
        # embedders/tests reference the older spelling; it must stay the
        # OOM mode of the generalized bisect
        assert Executor._recover_oom_chunk is not None
        assert Executor._bisect_chunk is not None


# --- integrity-off parity -----------------------------------------------------


class TestIntegrityOffParity:
    def test_off_executor_has_no_integrity_machinery(self):
        ex = Executor_(window_ms=1)
        try:
            assert ex.integrity is None
            assert not ex._golden_probe_armed()
            out = ex.process(_img(), _plan(), timeout=120)
            assert out.shape == (36, 48, 3)
            snap = ex.debug_snapshot()
            assert "integrity" not in snap
            assert snap["strike_history"] == []
        finally:
            ex.shutdown()

    def test_on_clean_responses_byte_identical_to_off(self):
        arr, plan = _img(seed=11), _plan()
        ex_off = Executor_(window_ms=1, host_spill=False)
        try:
            ref = ex_off.process(arr, plan, timeout=120)
        finally:
            ex_off.shutdown()
        ex_on = Executor_(window_ms=1, host_spill=False,
                                        integrity=_integ(sample=1.0))
        try:
            out = ex_on.process(arr, plan, timeout=120)
        finally:
            ex_on.shutdown()
        assert np.array_equal(ref, out)

    def test_off_options_build_no_state(self):
        from imaginary_tpu_torch.web.config import ServerOptions

        assert integrity_mod.from_options(ServerOptions()) is None
        st = integrity_mod.from_options(ServerOptions(
            integrity=True, integrity_sample=0.5, integrity_clean_probes=4))
        assert st is not None and st.enabled
        assert st.config.sample == 0.5
        assert st.config.clean_probes == 4

    def test_failslow_off_by_default_ewma_never_consulted(self):
        reg = DeviceHealthRegistry(2)
        for _ in range(50):
            reg.note_probe_ok(0, latency_ms=1000.0)
            reg.note_probe_ok(1, latency_ms=1.0)
        assert not reg.record(0).degraded
        assert reg.pick() == 0  # sticky primary untouched


# --- surfaces -----------------------------------------------------------------


class TestSurfaces:
    def test_health_and_debugz_blocks(self):
        from imaginary_tpu_torch.web.handlers import ImageService

        svc = ImageService(device="cpu", integrity=True, integrity_sample=1.0)
        try:
            ex = svc.executor
            ex.process(_img(), _plan(), timeout=120)
            stats = svc.health()
            assert stats["integrity"]["checks"] >= 1
            assert "poison_entries" in stats["integrity"]
            assert "degraded" in stats["deviceHealth"]
            assert "corruptions" in stats["deviceHealth"]
            snap = ex.debug_snapshot()
            assert "integrity" in snap and "strike_history" in snap
        finally:
            svc.close()

    def test_metrics_families_render_strict(self):
        from imaginary_tpu_torch.web.metrics import render_metrics

        text = render_metrics({
            "integrity": _integ().snapshot(),
            "deviceHealth": DeviceHealthRegistry(2).snapshot(),
        })
        for family in ("imaginary_tpu_integrity_checks_total",
                       "imaginary_tpu_integrity_mismatches_total",
                       "imaginary_tpu_integrity_reserved_total",
                       "imaginary_tpu_integrity_poison_entries",
                       "imaginary_tpu_devices_degraded",
                       "imaginary_tpu_corruption_strikes_total"):
            assert f"# TYPE {family}" in text, family

    def test_new_failpoint_sites_registered_and_keyed(self):
        assert "device.corrupt" in failpoints.SITES
        assert "device.slow" in failpoints.SITES
        failpoints.activate("device.corrupt[1]=error;device.slow[0]=delay(10ms)")
        try:
            failpoints.hit("device.corrupt", key=0)  # other chip: no-op
            with pytest.raises(failpoints.FailpointError):
                failpoints.hit("device.corrupt", key=1)
            t0 = time.monotonic()
            failpoints.hit("device.slow", key=0)
            assert time.monotonic() - t0 >= 0.008
            assert failpoints.snapshot()["sites"]["device.corrupt[1]"]["fired"] == 1
            assert "device.corrupt" in failpoints.snapshot()["known_sites"]
            assert {"device.oom", "host.spill"} <= set(failpoints.SITES)
        finally:
            failpoints.deactivate()


# --- the golden triple between the packages -----------------------------------


def test_golden_triple_equals_the_references():
    """Input and plan exactly, the host reference within 1 LSB."""
    arr, plan, ref = integrity_mod.golden()
    jarr, jplan_, jref = jintegrity.golden()
    assert arr.dtype == jarr.dtype and np.array_equal(arr, jarr)
    assert_same_plan(jplan_, plan)
    assert ref.shape == jref.shape
    assert int(np.abs(ref.astype(int) - jref.astype(int)).max()) <= 1


def test_golden_probe_runs_the_chain_and_books_corruption():
    """The executor's probe, armed by integrity: the golden chain through
    the plain kernels returns its warm ms; device.corrupt makes it raise
    CorruptionError; device.slow slows it."""
    ex = Executor_(integrity=_integ(sample=0.0), breaker_cooldown_s=60)
    try:
        assert ex._golden_probe_armed()
        ms = ex._probe_device(0)
        assert isinstance(ms, float) and ms >= 0.0
        failpoints.activate("device.corrupt[0]=error")
        with pytest.raises(CorruptionError, match="golden probe mismatch"):
            ex._probe_device(0)
        failpoints.activate("device.slow=delay(60ms)")
        assert ex._probe_device(0) >= 50.0
    finally:
        failpoints.deactivate()
        ex.shutdown()


def test_single_device_golden_probe_readmits_after_clean_probes():
    """One device with integrity armed: the prober runs the golden probe,
    a corruption strike quarantines, host serving counts, and the clean
    probes re-admit the device after the cooldown."""
    integ = _integ(sample=1.0, clean_probes=2)
    # host placement on, for the outage's host serving
    ex = Executor_(integrity=integ, breaker_cooldown_s=0.2, host_spill=True)
    try:
        failpoints.activate("device.corrupt=error")
        fut = ex.submit(_img(seed=3), _plan())
        fut.result(timeout=60)
        assert getattr(fut, "_hedge_placement", None) == "host"
        assert ex.devhealth.record(0).corruptions >= 1
        from imaginary_tpu_torch.engine.executor import last_placement, reset_placement

        reset_placement()
        ex.process(_img(seed=4), _plan(), timeout=60)
        assert last_placement() == "host" and ex.stats.breaker_host_served >= 1
        failpoints.deactivate()
        deadline = time.monotonic() + 15
        rec = ex.devhealth.record(0)
        while time.monotonic() < deadline and rec.state(time.monotonic()) != STATE_HEALTHY:
            time.sleep(0.05)
        assert rec.state(time.monotonic()) == STATE_HEALTHY
        assert rec.readmissions >= 1 and rec.probes >= 2
        reset_placement()
        ex.process(_img(seed=5), _plan(), timeout=60)
        assert last_placement() == "device"
    finally:
        failpoints.deactivate()
        ex.shutdown()
