"""The executor's mesh batch sharding (`ExecutorConfig.use_mesh`) on CPU
entries, held bit-equal to the unsharded executor.

- Config 5's stream (bench_firehose.py's `_gen_stream`: mixed JPEG, PNG
  and WEBP at jittered dims, seeded), cut to a few images, served as
  `/resize?width=300` through `pipeline.process_operation` from several
  threads, over 2 and 4 entries: every chunk is split over the mesh
  (`sharded_batches`, `mesh_dispatches`, `wire_bytes_by_device`).
- After a quarantine, as `_refresh_mesh_sharding` re-forms the batch axis
  over the healthy entries.
- An oversize bucket over `spatial` 2: each item W-sharded over a row.
- `mesh_policy` other than "off" supersedes `use_mesh`.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from imaginary_tpu_torch.engine import Executor, ExecutorConfig
from imaginary_tpu_torch.engine.timing import WIRE
from imaginary_tpu_torch.ops.plan import plan_operation
from imaginary_tpu_torch.options import ImageOptions

STREAM_N = 9  # three of each format
STREAM_SEED = 23


def config5_stream(n: int = STREAM_N, seed: int = STREAM_SEED) -> list:
    """bench_firehose.py:_gen_stream(n, seed) (cv2 draws and encodes)."""
    import cv2

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h = int(rng.integers(420, 780))
        w = int(rng.integers(560, 1100))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = np.stack([
            128 + 90 * np.sin(xx / (23 + (i % 7))),
            128 + 90 * np.cos(yy / (29 + (i % 5))),
            (xx + yy) % 255,
        ], axis=-1)
        cy, cx = int(h * (0.3 + 0.4 * rng.random())), int(w * (0.3 + 0.4 * rng.random()))
        r = int(min(h, w) * 0.12)
        cv2.circle(base, (cx, cy), r, (255, 255, 255), -1)
        cv2.circle(base, (cx, cy), r // 2, (0, 0, 0), -1)
        noise = rng.normal(0, 6, (h, w, 3))
        img = np.clip(base + noise, 0, 255).astype(np.uint8)
        ok, buf = cv2.imencode((".jpg", ".png", ".webp")[i % 3], img)
        assert ok
        out.append(buf.tobytes())
    return out


@pytest.fixture(autouse=True)
def _fresh_wire():
    """The mesh launches book WIRE by device; leave the process-wide ledger
    as the next test file expects it (unlabelled)."""
    WIRE.reset()
    yield
    WIRE.reset()


@pytest.fixture(scope="module")
def stream():
    return config5_stream()


def _serve_stream(ex: Executor, stream: list, clients: int = 6) -> list:
    """Each source's /resize?width=300 body through the executor, from
    `clients` threads at once."""
    from imaginary_tpu_torch.pipeline import process_operation

    out = [None] * len(stream)

    def client(k):
        for j in range(k, len(stream), clients):
            o = ImageOptions(width=300)
            o.mark_defined("width")
            out[j] = process_operation("resize", stream[j], o, device="cpu",
                                       runner=ex.process).body

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _executor(**kw) -> Executor:
    return Executor(ExecutorConfig(device="cpu", window_ms=20.0, max_form_ms=20.0,
                                   max_batch=8, **kw))


@pytest.fixture(scope="module")
def unsharded(stream):
    ex = _executor()
    try:
        return _serve_stream(ex, stream)
    finally:
        ex.shutdown()


@pytest.mark.parametrize("entries", [2, 4])
def test_config5_stream_is_bit_equal_to_the_unsharded_executor(stream, unsharded, entries):
    ex = _executor(use_mesh=True, n_devices=entries)
    try:
        got = _serve_stream(ex, stream)
        stats = ex.stats.to_dict()
    finally:
        ex.shutdown()
    assert got == unsharded
    assert ex._batch_mesh.shape == (entries, 1)
    assert stats["sharded_batches"] == stats["batches"] > 0
    assert sum(stats["mesh_dispatches"]) >= stats["batches"]
    assert stats["items"] == len(stream)
    # four entries of one device book their link bytes under its one name
    assert set(stats["wire_bytes_by_device"]["h2d"]) == {"cpu"}


def _quarantine(ex: Executor, idx: int) -> None:
    for _ in range(ex.config.breaker_threshold):
        ex.devhealth.note_failure(idx, RuntimeError("test strike"))
    assert idx not in ex.devhealth.available_indices()


def test_a_quarantine_reforms_the_batch_axis(stream, unsharded):
    ex = _executor(use_mesh=True, n_devices=4, breaker_threshold=1,
                   breaker_cooldown_s=600.0)
    try:
        _quarantine(ex, 1)
        got = _serve_stream(ex, stream)
        assert ex._batch_mesh.shape == (3, 1)
        assert ex._batch_rows == [0, 2, 3]
        assert ex.stats.mesh_dispatches[1] == 0
        assert ex.stats.mesh_dispatches[0] >= ex.stats.batches > 0
    finally:
        ex.shutdown()
    assert got == unsharded


def _frames(n: int, h: int, w: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def _run_all(ex: Executor, frames: list, plan) -> list:
    out = [None] * len(frames)

    def client(j):
        out[j] = ex.process(frames[j], plan)

    threads = [threading.Thread(target=client, args=(j,)) for j in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@pytest.mark.parametrize("op,kw", [
    ("resize", {"width": 120}),
    ("blur", {"sigma": 2.0}),
    ("flip", {}),
])
def test_oversize_buckets_ride_the_spatial_route(op, kw):
    frames = _frames(4, 150, 256, seed=5)
    o = ImageOptions(**kw)
    for k in kw:
        o.mark_defined(k)
    plan = plan_operation(op, o, 150, 256, 0, 3)
    base = _executor()
    try:
        want = _run_all(base, frames, plan)
    finally:
        base.shutdown()
    ex = _executor(use_mesh=True, n_devices=4, spatial=2, spatial_threshold_px=1)
    try:
        got = _run_all(ex, frames, plan)
        stats = ex.stats.to_dict()
    finally:
        ex.shutdown()
    assert ex._mesh.shape == (2, 2)
    assert stats["spatial_batches"] > 0
    assert stats["sharded_batches"] == 0  # every chunk took the spatial route
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_a_quarantine_turns_the_spatial_route_off():
    frames = _frames(3, 150, 256, seed=6)
    o = ImageOptions(width=120)
    o.mark_defined("width")
    plan = plan_operation("resize", o, 150, 256, 0, 3)
    ex = _executor(use_mesh=True, n_devices=4, spatial=2, spatial_threshold_px=1,
                   breaker_threshold=1, breaker_cooldown_s=600.0)
    try:
        want = [ex.process(f, plan) for f in frames]
        assert ex.stats.spatial_batches == len(frames)
        _quarantine(ex, 3)
        got = _run_all(ex, frames, plan)
        assert ex._batch_mesh.shape == (3, 1) and not ex._spatial_on
        assert ex.stats.spatial_batches == len(frames)  # no spatial launch since
        assert ex.stats.sharded_batches > 0
    finally:
        ex.shutdown()
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_mesh_policy_supersedes_use_mesh():
    ex = Executor(ExecutorConfig(device="cpu", use_mesh=True, mesh_policy="lanes",
                                 devices=["cpu", "cpu"]))
    try:
        assert ex._lanes is not None and ex._batch_mesh is None
        assert ex.stats.mesh_dispatches is None
        assert "mesh_dispatches" not in ex.stats.to_dict()
    finally:
        ex.shutdown()


def test_use_mesh_threads_from_the_server_options():
    from imaginary_tpu_torch.web.app import make_server

    srv = make_server("127.0.0.1", 0, device="cpu", use_mesh=True, n_devices=2)
    try:
        ex = srv.service.executor
        assert ex.config.use_mesh and ex._batch_mesh.shape == (2, 1)
    finally:
        srv.server_close()
