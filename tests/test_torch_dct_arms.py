"""The port's entropy-decoder arms, held against the JAX package's
`decode_coefficients` on the CPU.

Copies of `tests/test_dct_codec.py::TestDecoderArms` run through the
port's `jpeg_dct`: the python, numpy and native arms, and the native and
python arms fanned out across a segment pool, each bit for bit equal to
the reference's python arm (the planes are integers from the same
algorithm, so the tolerance is zero) on the corpus, on every layout and
on restart-segmented re-encodes of both. The fan-out's own hazards are
in `tests/test_torch_dct_fanout.py`.
"""

from __future__ import annotations

import io
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from imaginary_tpu.codecs import jpeg_dct as jdct
from imaginary_tpu_torch.codecs import jpeg_dct as pdct
from tests.conftest import fixture_bytes
from tests.test_dct_codec import _planes_equal, _random_quantized_blocks

CORPUS = ["imaginary.jpg", "medium.jpg", "large.jpg", "smart-crop.jpg",
          "exif-orient-6.jpg"]
LAYOUTS = ["gray", "420", "422", "444"]
_SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


@pytest.fixture(autouse=True)
def _reset_arms(testdata):
    # the reference's service registers its request pool as the segment
    # pool and leaves it registered once closed (its own tests detach it
    # the same way), so the oracle decodes serially here
    jdct.set_segment_pool(None)
    yield
    pdct.set_decoder("auto")
    pdct.set_segment_pool(None)


def _save(im: Image.Image, layout: str, quality: int = 88, **restart) -> bytes:
    b = io.BytesIO()
    if layout == "gray":
        im.convert("L").save(b, "JPEG", quality=quality, **restart)
    else:
        im.convert("RGB").save(b, "JPEG", quality=quality,
                               subsampling=_SUBSAMPLING[layout], **restart)
    return b.getvalue()


def _reencoded(layout: str, **restart) -> bytes:
    return _save(Image.open(io.BytesIO(fixture_bytes("medium.jpg"))), layout, **restart)


def _segmented(name: str) -> bytes:
    """A corpus image saved again with a restart marker after every MCU row."""
    im = Image.open(io.BytesIO(fixture_bytes(name)))
    return _save(im, "420", quality=90, restart_marker_rows=1)


def _nseg(buf: bytes) -> int:
    return sum(buf.count(bytes([0xFF, 0xD0 + i])) for i in range(8)) + 1


def _decode_all(buf: bytes) -> dict:
    """Every way the port decodes a scan: each arm serially, and the
    native and python arms fanned out across a pool of four."""
    out = {arm: pdct.decode_coefficients(buf, decoder=arm)
           for arm in ("python", "numpy", "native")}
    pool = ThreadPoolExecutor(4)
    try:
        pdct.set_segment_pool(pool)
        for arm in ("native", "python"):
            out[f"{arm}+pool"] = pdct.decode_coefficients(buf, decoder=arm)
    finally:
        pdct.set_segment_pool(None)
        pool.shutdown()
    return out


def _assert_equal_to_reference(buf: bytes, got: dict, tag: str) -> None:
    want = jdct.decode_coefficients(buf, decoder="python")
    assert want is not None
    for arm, c in got.items():
        assert c is not None, f"{tag}/{arm}"
        assert c.layout == want.layout and (c.h, c.w) == (want.h, want.w), f"{tag}/{arm}"
        assert np.array_equal(c.qy, want.qy) and np.array_equal(c.qc, want.qc)
        assert len(c.planes) == len(want.planes)
        for a, b in zip(c.planes, want.planes):
            assert a.dtype == np.int16 and np.array_equal(a, b), f"{tag}/{arm}"


class TestDecoderArms:
    @pytest.mark.parametrize("name", CORPUS)
    def test_arm_parity_on_corpus(self, name):
        buf = fixture_bytes(name)
        _assert_equal_to_reference(buf, _decode_all(buf), name)

    @pytest.mark.parametrize("name", CORPUS)
    def test_arm_parity_on_the_segmented_corpus(self, name):
        buf = _segmented(name)
        assert _nseg(buf) >= 4
        _assert_equal_to_reference(buf, _decode_all(buf), name)

    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_arm_parity_on_layouts(self, layout):
        buf = _reencoded(layout)
        assert pdct.decode_coefficients(buf, decoder="python").layout == layout
        _assert_equal_to_reference(buf, _decode_all(buf), layout)

    @pytest.mark.parametrize("restart", [{"restart_marker_rows": 1},
                                         {"restart_marker_blocks": 7}], ids=["rows", "blocks"])
    @pytest.mark.parametrize("layout", LAYOUTS)
    def test_arm_parity_on_segmented_layouts(self, layout, restart):
        buf = _reencoded(layout, **restart)
        assert _nseg(buf) >= 16
        _assert_equal_to_reference(buf, _decode_all(buf), layout)

    def test_segment_pool_fanout_matches_serial(self):
        # a DRI stream decoded with the handler pool attached must yield
        # byte-for-byte the serial result (DC prediction resets at RSTn
        # make segments independent; the pool must not reorder rows)
        qb = _random_quantized_blocks(h=160, w=240, seed=5)
        body = pdct.encode_quantized(qb, restart_interval=1)
        assert body == jdct.encode_quantized(qb, restart_interval=1)
        serial = pdct.decode_coefficients(body, decoder="python")
        assert serial is not None and _planes_equal(serial.planes, qb)
        pool = ThreadPoolExecutor(4)
        try:
            pdct.set_segment_pool(pool)
            pooled = {arm: pdct.decode_coefficients(body, decoder=arm)
                      for arm in ("python", "native", "numpy")}
        finally:
            pdct.set_segment_pool(None)
            pool.shutdown()
        for arm, got in pooled.items():
            assert got is not None, arm
            for a, b in zip(got.planes, serial.planes):
                assert np.array_equal(a, b), arm

    def test_decoder_mode_switch(self):
        pdct.set_decoder("python")
        assert pdct.decoder_name() == "python"
        pdct.set_decoder("numpy")
        assert pdct.decoder_name() == pdct.decoder_name(64) == "numpy"
        pdct.set_decoder("auto")
        expect = "native" if pdct.native_available() else "python"
        assert pdct.decoder_name(1) == expect
        assert pdct.decoder_name(64) in ("native", "numpy")
        with pytest.raises(ValueError):
            pdct.set_decoder("turbo")

    def test_auto_without_native_picks_numpy_at_sixteen_segments(self, monkeypatch):
        monkeypatch.setattr(pdct, "_entropy", lambda: None)
        got = [pdct.decoder_name(n) for n in (1, 15, 16, 64)]
        assert got == ["python", "python", "numpy", "numpy"]
        monkeypatch.setattr(jdct, "_entropy", None)
        assert [jdct.decoder_name(n) for n in (1, 15, 16, 64)] == got
        # the port's native arm fails loudly where the reference's degrades
        with pytest.raises(RuntimeError):
            pdct._resolve_name("native", 1)
