"""The port's boot prewarm (`imaginary_tpu_torch/prewarm.py`) and the
executor's `compile_misses`, link seed and `batch_ladder`, on the CPU.

- `tests/test_prewarm.py`'s eight cases but the persistent cache's (the
  port has no XLA cache), on `device="cpu"`, with `run_batch`
  monkeypatched where that test monkeypatches it. The seed case asks the
  port's own question: the port has no host spill, so a new executor's
  owed ledger is priced at the seed instead of routing to the host;
- the (spec names, input bucket, B) triples the port's `warm_chain`
  launches for `_COMMON` on the rgb, yuv420 and both DCT transports, equal
  to those the reference's launches (both packages' `run_batch`
  recorded);
- an `Executor(device="cpu")` at small dims: a warmed chain serves at
  B = 1 and 2 with `compile_misses == 0`, an unwarmed one counts 1; a
  4:2:0 JPEG's request through the pipeline meets the yuv420 chain
  prewarm launched; a lane tier warmed by `warm_mesh_paths` serves
  without a miss; `create_app` with `prewarm` warms before it returns;
  a failed warm is written to stderr and counted, never retried on the
  CPU.
"""

from __future__ import annotations

import asyncio
import io
import time

import numpy as np
import pytest
from PIL import Image

from imaginary_tpu_torch import prewarm
from imaginary_tpu_torch.engine import executor as executor_mod
from imaginary_tpu_torch.engine.executor import Executor, ExecutorConfig, batch_ladder
from imaginary_tpu_torch.ops import chain as chain_mod
from imaginary_tpu_torch.ops.plan import choose_decode_shrink, plan_operation
from imaginary_tpu_torch.options import ImageOptions
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

WAIT_S = 60


@pytest.fixture(autouse=True)
def _unseeded(monkeypatch):
    """Every test starts with no link seed (a timing-dependent seed must
    not leak into later tests) and the dct switches off."""
    from imaginary_tpu_torch import pipeline

    monkeypatch.setattr(executor_mod, "_LINK_SEED", None)
    monkeypatch.setattr(pipeline, "_TRANSPORT_DCT", False)
    monkeypatch.setattr(pipeline, "_TRANSPORT_DCT_EGRESS", False)


def _dims(op, opts, h, w) -> set:
    shrink = choose_decode_shrink(op, opts, h, w, 0, 3)
    return {(h, w), (-(-h // shrink), -(-w // shrink))}


def _transports() -> int:
    from imaginary_tpu_torch import codecs

    return 2 if codecs.yuv420_supported() else 1


# --- tests/test_prewarm.py's cases -------------------------------------------

def test_prewarm_ladder_and_shrink_bucket(monkeypatch):
    """Every requested B at the full and the shrink-on-load bucket, on each
    transport, deduplicated by (chain, bucket, B)."""
    opts = ImageOptions(width=24)
    monkeypatch.setattr(prewarm, "_COMMON", [("resize", opts, (64, 96))])
    before = chain_mod.cache_size()
    n = prewarm.prewarm_common_chains(batch_sizes=(1, 2), verbose=False, device="cpu")
    assert n == 2 * len(_dims("resize", opts, 64, 96)) * _transports()
    assert chain_mod.cache_size() >= before


def test_prewarm_env_override(monkeypatch):
    opts = ImageOptions(width=16)
    monkeypatch.setattr(prewarm, "_COMMON", [("resize", opts, (32, 48))])
    monkeypatch.setenv("IMAGINARY_TPU_PREWARM_BATCHES", "1")
    assert prewarm.prewarm_common_chains(verbose=False, device="cpu") == (
        len(_dims("resize", opts, 32, 48)) * _transports())


def test_prewarm_bad_env_degrades(monkeypatch):
    """A malformed batch list falls back to the ladder, never kills boot."""
    monkeypatch.setattr(prewarm, "_COMMON",
                        [("resize", ImageOptions(width=16), (32, 48))])
    monkeypatch.setenv("IMAGINARY_TPU_PREWARM_BATCHES", "1 2;bogus")
    seen = []
    monkeypatch.setattr(prewarm.chain_mod, "run_batch",
                        lambda arrs, pls, device=None: seen.append(len(arrs)))
    assert prewarm.prewarm_common_chains(verbose=False, device="cpu", max_batch=4) >= 1
    assert sorted(set(seen)) == list(batch_ladder(4)) == [1, 2, 3, 4]


def test_seed_link_rate_consumed_by_new_executor(monkeypatch):
    """A prewarm-installed seed prices a new executor's owed ledger before
    its first drain (the port has no host spill to route to)."""
    from imaginary_tpu_torch import failpoints

    executor_mod.seed_link_rate(500.0, 40.0)
    ex = Executor(ExecutorConfig(device="cpu", max_form_ms=1))
    try:
        assert ex._ms_per_mb == 500.0
        failpoints.activate("device.execute=delay(300ms)")
        arr = np.zeros((64, 96, 3), dtype=np.uint8)
        plan = plan_operation("resize", ImageOptions(width=24), 64, 96, 0, 3)
        fut = ex.submit(arr, plan)
        mb = ex.stats.device_owed_mb
        assert mb > 0 and ex.estimated_wait_ms() == pytest.approx(mb * 500.0)
        assert fut.result(timeout=WAIT_S).shape[1] == 24
    finally:
        failpoints.deactivate()
        ex.shutdown()


def test_seed_link_rate_solved_from_warm_drains():
    """_seed_link_rate times a small and a large warm drain (warmed here
    first, as prewarm has warmed them: a first CPU launch of a shape is
    slow) and installs a nonnegative (ms/MB, floor) pair."""
    small = plan_operation("resize", ImageOptions(width=24), 64, 96, 0, 3)
    big = plan_operation("resize", ImageOptions(width=300), 512, 768, 0, 3)
    warmed = [(small, None, 64, 96, 1), (big, None, 512, 768, 2)]
    for pl, kind, dh, dw, b in warmed:
        arr = prewarm._dummy_input(pl, kind, dh, dw)
        chain_mod.run_batch([arr] * b, [pl] * b, device="cpu")
    got = prewarm._seed_link_rate(warmed, device="cpu")
    assert got is not None
    rate, floor = got
    assert rate >= 0.0 and floor >= 0.0
    assert executor_mod.link_seed() == (rate, floor)


def test_seed_link_rate_rejects_inverted_slope(monkeypatch):
    """The big drain timed faster than the small one: no seed (a zero
    seed would price the link free)."""

    def stalled_small(arrs, pls, device=None):
        if len(arrs) == 1:
            time.sleep(0.02)

    monkeypatch.setattr(prewarm.chain_mod, "run_batch", stalled_small)
    small = plan_operation("resize", ImageOptions(width=24), 64, 96, 0, 3)
    big = plan_operation("resize", ImageOptions(width=300), 512, 768, 0, 3)
    assert prewarm._seed_link_rate(
        [(small, None, 64, 96, 1), (big, None, 512, 768, 2)], device="cpu") is None
    assert executor_mod.link_seed() is None


def test_zero_rate_seed_treated_as_unpriced():
    executor_mod.seed_link_rate(0.0, 5.0)
    ex = Executor(ExecutorConfig(device="cpu"))
    try:
        assert ex._ms_per_mb is None
        assert ex.estimated_wait_ms() == 0.0
    finally:
        ex.shutdown()


def test_seed_link_rate_skips_degenerate_spread():
    pl = plan_operation("resize", ImageOptions(width=24), 64, 96, 0, 3)
    assert prewarm._seed_link_rate([(pl, None, 64, 96, 1)], device="cpu") is None
    assert executor_mod.link_seed() is None


# --- the port's warm set against the reference's ------------------------------

def _names(pl) -> tuple:
    return tuple(type(st.spec).__name__ for st in pl.stages)


@pytest.mark.parametrize("dct", [False, True], ids=["rgb-yuv420", "with-dct-both-ways"])
def test_warm_chain_visits_the_references_chains(monkeypatch, dct):
    """For every `_COMMON` row, the port launches the chains the
    reference launches: the same (spec names, input bucket, B)."""
    from imaginary_tpu import pipeline as ref_pipeline
    from imaginary_tpu import prewarm as ref_prewarm
    from imaginary_tpu_torch import pipeline

    monkeypatch.setattr(ref_pipeline, "_TRANSPORT_DCT", dct)
    monkeypatch.setattr(ref_pipeline, "_TRANSPORT_DCT_EGRESS", dct)
    monkeypatch.setattr(pipeline, "_TRANSPORT_DCT", dct)
    monkeypatch.setattr(pipeline, "_TRANSPORT_DCT_EGRESS", dct)

    def recorder(out):
        def run_batch(arrs, pls, device=None, **kw):
            pl = pls[0]
            bucket = pl.in_bucket or chain_mod.bucket_shape(*arrs[0].shape[:2])
            out.append((_names(pl), tuple(bucket), arrs[0].shape[2], len(arrs)))
        return run_batch

    ref, port = [], []
    monkeypatch.setattr(ref_prewarm.chain_mod, "run_batch", recorder(ref))
    monkeypatch.setattr(prewarm.chain_mod, "run_batch", recorder(port))
    for (op, _o, (h, w)), (_, ref_opts, _d) in zip(prewarm._COMMON, ref_prewarm._COMMON):
        assert prewarm.warm_chain(op, _o, h, w, (1, 3), device="cpu") == (
            ref_prewarm.warm_chain(op, ref_opts, h, w, (1, 3)))
    assert port == ref and len(port) >= len(prewarm._COMMON) * 2
    kinds = {names[0] for names, *_ in port}
    assert {"FromYuv420Spec"} <= kinds and (("FromDctSpec" in kinds) == dct)


# --- compile_misses on the executor ---------------------------------------------

def _submit_together(ex, arrs, plans) -> list:
    futs = [ex.submit(a, p) for a, p in zip(arrs, plans)]
    return [f.result(timeout=WAIT_S) for f in futs]


def test_warmed_chain_serves_without_a_miss(monkeypatch):
    chain_mod.clear_cache()
    opts = ImageOptions(width=24)
    monkeypatch.setattr(prewarm, "_COMMON", [("resize", opts, (64, 96))])
    prewarm.prewarm_common_chains(batch_sizes=(1, 2), verbose=False, device="cpu")
    ex = Executor(ExecutorConfig(device="cpu", max_form_ms=200))
    try:
        arr = np.zeros((64, 96, 3), dtype=np.uint8)
        plan = plan_operation("resize", opts, 64, 96, 0, 3)
        ex.process(arr, plan, timeout=WAIT_S)
        _submit_together(ex, [arr, arr], [plan, plan])
        assert ex.stats.max_group_seen == 2
        assert ex.stats.compile_misses == 0
        other = plan_operation("resize", ImageOptions(width=25), 64, 96, 0, 3)
        ex.process(arr, other, timeout=WAIT_S)
        assert ex.stats.compile_misses == 1
        assert ex.stats.to_dict()["compile_misses"] == 1
        ex.process(arr, other, timeout=WAIT_S)  # now seen
        assert ex.stats.compile_misses == 1
    finally:
        ex.shutdown()


def _jpeg(h: int, w: int) -> bytes:
    rng = np.random.default_rng(7)
    img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=90, subsampling=2)  # 4:2:0
    return buf.getvalue()


def test_jpeg_request_meets_the_warmed_yuv420_chain(monkeypatch):
    """A 4:2:0 JPEG request rides the packed-YUV420 transport at its
    shrink-on-load bucket: prewarm's dummy input has the shape its decode
    stages, so the request launches a warmed signature."""
    from imaginary_tpu_torch import codecs, pipeline

    assert codecs.yuv420_supported()  # g++ builds the port's codec on first use
    chain_mod.clear_cache()
    opts = ImageOptions(width=60)
    monkeypatch.setattr(prewarm, "_COMMON", [("resize", opts, (200, 320))])
    prewarm.prewarm_common_chains(batch_sizes=(1,), verbose=False, device="cpu")
    ex = Executor(ExecutorConfig(device="cpu", max_form_ms=1))
    try:
        out = pipeline.process_operation("resize", _jpeg(200, 320), ImageOptions(width=60),
                                         device="cpu", runner=ex.process)
        assert out.mime == "image/jpeg" and out.width == 60
        assert ex.stats.items == 1 and ex.stats.compile_misses == 0
    finally:
        ex.shutdown()


def test_warm_mesh_paths_cover_the_lanes(monkeypatch):
    chain_mod.clear_cache()
    opts = ImageOptions(width=24)
    monkeypatch.setattr(prewarm, "_COMMON", [("resize", opts, (64, 96))])
    ex = Executor(ExecutorConfig(device="cpu", mesh_policy="sharded", n_devices=2,
                                 max_form_ms=100, max_batch=4, shard_min_items=3))
    try:
        n = prewarm.prewarm_common_chains(batch_sizes=(1, 2, 3, 4), verbose=False,
                                          device="cpu", executor=ex)
        assert n > 0
        arr = np.zeros((64, 96, 3), dtype=np.uint8)
        plan = plan_operation("resize", opts, 64, 96, 0, 3)
        _submit_together(ex, [arr] * 4, [plan] * 4)
        ex.process(arr, plan, timeout=WAIT_S)
        assert ex.stats.compile_misses == 0
    finally:
        ex.shutdown()


def test_create_app_prewarms_before_it_returns(monkeypatch):
    from aiohttp.test_utils import TestClient, TestServer

    from imaginary_tpu_torch.web.app import create_app
    from imaginary_tpu_torch.web.config import ServerOptions
    from tests.conftest import fixture_bytes

    chain_mod.clear_cache()
    monkeypatch.setattr(prewarm, "_COMMON",
                        [("resize", ImageOptions(width=100), (740, 550))])
    monkeypatch.setenv("IMAGINARY_TPU_PREWARM_BATCHES", "1")
    app = create_app(ServerOptions(device="cpu", prewarm=True), log_stream=io.StringIO())
    assert chain_mod.cache_size() > 0

    async def go():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            res = await client.post("/resize?width=100", data=fixture_bytes("imaginary.jpg"))
            assert res.status == 200
            health = await (await client.get("/health")).json()
            return health["executor"]
        finally:
            await client.close()

    ex = asyncio.run(go())
    assert ex["items"] == 1 and ex["compile_misses"] == 0


def test_failed_warm_is_reported_and_counted(monkeypatch, capsys):
    """A warm that fails is written to stderr with its chain, bucket and
    B, counted in the summary, and never retried anywhere else."""
    opts = ImageOptions(width=24)
    monkeypatch.setattr(prewarm, "_COMMON", [("resize", opts, (64, 96))])
    devices = []

    def flaky(arrs, pls, device=None):
        devices.append(device)
        if len(arrs) == 2:
            raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(prewarm.chain_mod, "run_batch", flaky)
    report: dict = {}
    n = prewarm.prewarm_common_chains(batch_sizes=(1, 2), device="cuda", report=report)
    per_b = len(_dims("resize", opts, 64, 96)) * _transports()
    assert n == report["warmed"] == per_b and report["failed"] == per_b
    assert set(devices) == {"cuda"}  # nothing fell back to the CPU
    out, err = capsys.readouterr()
    assert err.count("prewarm: chain [") == per_b and "B=2 failed: RuntimeError" in err
    assert f"prewarmed {per_b} op-chain programs ({per_b} failed)" in out


def test_batch_ladder_is_every_chunk_size():
    assert batch_ladder(1) == (1,)
    assert batch_ladder(5) == (1, 2, 3, 4, 5)
    assert batch_ladder() == tuple(range(1, executor_mod.MAX_BATCH + 1))


def test_common_routes_meet_their_warmed_chains(monkeypatch):
    """Each `_COMMON` row's route, parsed from its query as a request is,
    launches a chain prewarm launched (on the yuv420 transport of
    large.jpg and imaginary.jpg): no miss. The reference's ImageOptions
    rows would miss the 300x200 /resize's EmbedSpec (its extend)."""
    import chip_smoke
    from imaginary_tpu_torch.ops.stages import EmbedSpec
    from imaginary_tpu_torch.web.config import ServerOptions
    from imaginary_tpu_torch.web.handlers import ImageService
    from tests.conftest import fixture_bytes

    chain_mod.clear_cache()
    monkeypatch.setenv("IMAGINARY_TPU_PREWARM_BATCHES", "1")
    svc = ImageService(ServerOptions(device="cpu", max_batch=1))
    try:
        assert svc.prewarm()["failed"] == 0
        for path, name in chip_smoke.common_routes():
            op, _, q = path[1:].partition("?")
            query = dict(p.split("=") for p in q.split("&") if not p.startswith("file="))
            assert svc.process(op, fixture_bytes(name), query).status == 200
            assert svc.executor.stats.compile_misses == 0, path
    finally:
        svc.close()
    from imaginary_tpu_torch.options import Extend

    def embed_modes(o):
        return [st.spec.mode for st in plan_operation("resize", o, 270, 480, 0, 3).stages
                if isinstance(st.spec, EmbedSpec)]

    assert embed_modes(prewarm._COMMON[1][1]) == [Extend.COPY]
    assert embed_modes(ImageOptions(width=300, height=200)) == [Extend.MIRROR]


def test_dct_requests_meet_their_warmed_chains(monkeypatch):
    """With both DCT switches on, prewarm's coefficient dummies have the
    shapes the entropy decoder packs: a 4:2:0 JPEG's request over the
    DCT transport both ways launches a warmed signature."""
    from imaginary_tpu_torch import pipeline

    chain_mod.clear_cache()
    monkeypatch.setattr(pipeline, "_TRANSPORT_DCT", True)
    monkeypatch.setattr(pipeline, "_TRANSPORT_DCT_EGRESS", True)
    opts = ImageOptions(width=60)
    monkeypatch.setattr(prewarm, "_COMMON", [("resize", opts, (200, 320))])
    prewarm.prewarm_common_chains(batch_sizes=(1,), verbose=False, device="cpu")
    ex = Executor(ExecutorConfig(device="cpu", max_form_ms=1))
    try:
        before = pipeline.dct_counts()["served"]
        out = pipeline.process_operation("resize", _jpeg(200, 320), ImageOptions(width=60),
                                         device="cpu", runner=ex.process)
        assert out.mime == "image/jpeg" and out.width == 60
        assert pipeline.dct_counts()["served"] == before + 1
        assert ex.stats.items == 1 and ex.stats.compile_misses == 0
    finally:
        ex.shutdown()


def test_prewarm_and_deadline_import_neither_jax_nor_the_reference():
    import os
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import imaginary_tpu_torch.prewarm, imaginary_tpu_torch.deadline\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'imaginary_tpu' or m.startswith('imaginary_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
