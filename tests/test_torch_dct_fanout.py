"""The restart-segment fan-out of the port's entropy decoder
(`jpeg_dct._run_scan` over `set_segment_pool`), held against the JAX
package's decode on the CPU.

Its hazards one by one: a pool of one whose only thread is itself
decoding (it must not deadlock), chunks that tile the segment range once
and carry the caller's context, a failing range (unstarted chunks
dropped, started ones waited out), many requests sharing one pool, and
the service's pool registered and released. `decode_packed` with the
pool attached is bit for bit the reference's.
"""

from __future__ import annotations

import contextvars
import io
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from imaginary_tpu.codecs import jpeg_dct as jdct
from imaginary_tpu_torch.codecs import jpeg_dct as pdct
from tests.conftest import fixture_bytes
from tests.test_torch_dct_arms import (  # noqa: F401
    LAYOUTS,
    _reencoded,
    _reset_arms,
    _save,
)

SHRINKS = [1, 2, 4, 8]

class TestFanOut:
    def test_a_pool_of_one_busy_in_the_decoding_request_does_not_deadlock(self):
        """The pool's only thread runs the request, which fans its own scan
        out to that pool: the queued chunk is taken back and decoded
        inline."""
        buf = _reencoded("420", restart_marker_rows=1)
        serial = pdct.decode_coefficients(buf, decoder="native")
        pool = ThreadPoolExecutor(1)
        try:
            pdct.set_segment_pool(pool)
            for arm in ("native", "python"):
                got = pool.submit(pdct.decode_coefficients, buf, arm).result(timeout=120)
                assert got is not None, arm
                for a, b in zip(got.planes, serial.planes):
                    assert np.array_equal(a, b), arm
        finally:
            pdct.set_segment_pool(None)
            pool.shutdown()

    @pytest.mark.parametrize("nseg", [4, 5, 9, 64])
    @pytest.mark.parametrize("workers", [1, 3, 8])
    def test_chunks_tile_the_segments_once_and_carry_the_callers_context(self, nseg, workers):
        var = contextvars.ContextVar("request", default=None)
        seen, lock = [], threading.Lock()

        def arm(sc, planes, bounds, s0, s1):
            with lock:
                seen.append((s0, s1, var.get()))

        pool = ThreadPoolExecutor(workers)
        try:
            pdct.set_segment_pool(pool)
            var.set("req-1")
            pdct._run_scan(None, [], [(0, 0)] * nseg, arm)
        finally:
            pdct.set_segment_pool(None)
            pool.shutdown()
        ranges = sorted((a, b) for a, b, _ in seen)
        assert ranges[0][0] == 0 and ranges[-1][1] == nseg
        assert all(b0 == a1 for (_, b0), (a1, _) in zip(ranges, ranges[1:]))
        assert all(a < b for a, b in ranges)
        assert len(ranges) == min(nseg, max(2, workers))
        assert {v for _, _, v in seen} == {"req-1"}

    def test_a_failing_range_drops_unstarted_chunks_and_waits_out_started_ones(self):
        """Three chunks past the first on a pool of three whose two other
        threads are held: chunk 1 starts, chunk 2 waits in the queue. The
        first range fails; chunk 2 is dropped and chunk 1 has finished
        by the time the error reaches the caller."""
        events, lock = [], threading.Lock()
        started, gate = threading.Event(), threading.Event()

        def arm(sc, planes, bounds, s0, s1):
            if s0 == 0:
                started.wait(10)
                raise pdct._Unsupported("bad segment")
            with lock:
                events.append(("start", s0))
            started.set()
            time.sleep(0.2)
            with lock:
                events.append(("end", s0))

        pool = ThreadPoolExecutor(3)
        blockers = [pool.submit(gate.wait, 10) for _ in range(2)]
        try:
            pdct.set_segment_pool(pool)
            with pytest.raises(pdct._Unsupported):
                pdct._run_scan(None, [], [(0, 0)] * 9, arm)
            at_return = list(events)
        finally:
            pdct.set_segment_pool(None)
            gate.set()
            pool.shutdown()
        assert all(b.result() for b in blockers)
        assert at_return == [("start", 3), ("end", 3)]
        assert events == at_return  # chunk 6 never ran

    def test_many_requests_share_one_segment_pool(self):
        """More request threads and segment workers than cores, with a short
        switch interval: every fanned-out decode equals its serial one."""
        bufs = [_reencoded(layout, restart_marker_rows=1) for layout in LAYOUTS]
        serial = [pdct.decode_coefficients(b, decoder="native") for b in bufs]
        n = 4 * (os.cpu_count() or 2)
        interval = sys.getswitchinterval()
        seg_pool, req_pool = ThreadPoolExecutor(n), ThreadPoolExecutor(n)
        try:
            sys.setswitchinterval(1e-5)
            pdct.set_segment_pool(seg_pool)
            futs = [(i % len(bufs), req_pool.submit(pdct.decode_coefficients,
                                                    bufs[i % len(bufs)], "native"))
                    for i in range(2 * n)]
            got = [(i, f.result(timeout=120)) for i, f in futs]
        finally:
            sys.setswitchinterval(interval)
            pdct.set_segment_pool(None)
            req_pool.shutdown()
            seg_pool.shutdown()
        for i, c in got:
            for a, b in zip(c.planes, serial[i].planes):
                assert np.array_equal(a, b)

    def test_short_scans_and_the_numpy_arm_stay_on_the_calling_thread(self, monkeypatch):
        calls = []

        def arm(sc, planes, bounds, s0, s1):
            calls.append((s0, s1, threading.current_thread()))

        monkeypatch.setattr(pdct, "_scan_numpy", arm)
        pool = ThreadPoolExecutor(4)
        try:
            pdct.set_segment_pool(pool)
            pdct._run_scan(None, [], [(0, 0)] * 3, arm)
            pdct._run_scan(None, [], [(0, 0)] * 64, pdct._scan_numpy)
        finally:
            pdct.set_segment_pool(None)
            pool.shutdown()
        me = threading.current_thread()
        assert calls == [(0, 3, me), (0, 64, me)]

    @pytest.mark.parametrize("shrink", SHRINKS)
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_decode_packed_with_the_pool_equals_the_references(self, layout, shrink):
        buf = _reencoded(layout, restart_marker_rows=1)
        want = jdct.decode_packed(buf, shrink, decoder="python")
        pool = ThreadPoolExecutor(4)
        try:
            pdct.set_segment_pool(pool)
            got = {arm: pdct.decode_packed(buf, shrink, decoder=arm)
                   for arm in ("native", "python")}
        finally:
            pdct.set_segment_pool(None)
            pool.shutdown()
        for arm, g in got.items():
            assert g is not None and g[1:] == want[1:], arm
            assert g[0].dtype == np.int16 and np.array_equal(g[0], want[0]), arm


class TestServicePool:
    def test_the_service_registers_its_pool_and_releases_it_on_close(self):
        from imaginary_tpu_torch.web.handlers import ImageService

        a = ImageService(device="cpu", cpus=2)
        b = ImageService(device="cpu", cpus=2)
        try:
            assert pdct._SEGMENT_POOL is b.pool
            a.close()
            assert pdct._SEGMENT_POOL is b.pool
        finally:
            a.close()
            b.close()
        assert pdct._SEGMENT_POOL is None

    @pytest.mark.parametrize("arm", ["native", "numpy"])
    def test_a_one_thread_service_answers_a_segmented_jpeg_as_served_serially(self, arm):
        """`--cpus 1 --transport-dct`: the request runs on the pool's only
        thread and fans its scan out to that pool; the bytes equal a
        decode with no pool."""
        from imaginary_tpu_torch.web.handlers import ImageService

        im = Image.open(io.BytesIO(fixture_bytes("large.jpg")))
        buf = _save(im, "420", quality=90, restart_marker_rows=1)
        query = {"width": "300"}
        svc = ImageService(device="cpu", cpus=1, transport_dct=True, dct_native=arm)
        try:
            assert svc.pool_workers == 1 and pdct._SEGMENT_POOL is svc.pool
            before = svc.health()["dctTransport"]["served"]
            pooled = svc.pool.submit(svc.process, "resize", buf, query).result(timeout=300)
            assert svc.health()["dctTransport"]["served"] == before + 1
            pdct.set_segment_pool(None)
            serial = svc.process("resize", buf, query)
        finally:
            svc.close()
        assert pooled.status == serial.status == 200
        assert pooled.body == serial.body
