"""stripmeta on the port (ref: options.go:139 StripMetadata, default false):
a port copy of tests/test_metadata.py's twelve cases, on the CPU.

EXIF and ICC survive processing unless stripmeta is set, with Orientation
reset to 1 once the chain has applied the rotation and the ExifIFD's
PixelX/YDimension re-synced to the output. Each case runs the port's
segment helpers (`imaginary_tpu_torch.codecs`) or its `process_operation`
and `process_pipeline` on `device="cpu"`, asserts the reference case's
own expectation, and holds the answer's EXIF tags, ICC bytes, ExifIFD
dimensions and size equal to the JAX package's on the same request (the
helpers: their bytes equal the reference's). The port spells the
reference's `reset_exif_orientation(seg)` as `patch_exif_segment(seg,
orientation=1)`, which the reference's helper calls.
"""

import json
from io import BytesIO

import numpy as np
import pytest
from PIL import Image

from imaginary_tpu import codecs as jcodecs
from imaginary_tpu import pipeline as jpipeline
from imaginary_tpu.params import build_params_from_query as jquery
from imaginary_tpu_torch import codecs, pipeline
from imaginary_tpu_torch.params import build_params_from_query as pquery
from tests.test_torch_refnative import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

# a tiny ICC profile: PIL takes any bytes as icc_profile, and a reader only
# needs the segment to come through intact
FAKE_ICC = b"\x00\x00\x02\x00" + b"ADBE" + b"\x00" * 120
MAKE = "imaginary-tpu-test"


def _jpeg_with_metadata(orientation=6, w=320, h=240) -> bytes:
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    exif = Image.Exif()
    exif[274] = orientation  # Orientation
    exif[271] = MAKE  # Make
    out = BytesIO()
    Image.fromarray(img).save(out, "JPEG", quality=85, subsampling=2,
                              exif=exif.tobytes(), icc_profile=FAKE_ICC)
    return out.getvalue()


def _read_meta(body: bytes):
    im = Image.open(BytesIO(body))
    return dict(im.getexif()), im.info.get("icc_profile")


def _meta(body: bytes) -> dict:
    """What the carry decides: EXIF tags, ICC bytes, the ExifIFD's
    PixelX/YDimension, the size and the MIME's format."""
    im = Image.open(BytesIO(body))
    exif = im.getexif()
    sub = exif.get_ifd(0x8769)
    return {"exif": dict(exif), "icc": im.info.get("icc_profile"),
            "dims": (sub.get(0xA002), sub.get(0xA003)), "size": im.size,
            "format": im.format}


def _operation(name: str, buf: bytes, query: dict):
    """The port's answer, after holding its metadata equal to the JAX
    package's on the same request."""
    want = jpipeline.process_operation(name, buf, jquery(query))
    got = pipeline.process_operation(name, buf, pquery(query), device="cpu")
    assert got.mime == want.mime
    assert _meta(got.body) == _meta(want.body)
    return got


def _pipeline(buf: bytes, query: dict):
    want = jpipeline.process_pipeline(buf, jquery(query))
    got = pipeline.process_pipeline(buf, pquery(query), device="cpu")
    assert got.mime == want.mime
    assert _meta(got.body) == _meta(want.body)
    return got


def _ops(*ops) -> str:
    return json.dumps(list(ops))


class TestSegmentHelpers:
    def test_extract_finds_exif_and_icc(self):
        buf = _jpeg_with_metadata()
        segs = codecs.jpeg_metadata_segments(buf)
        assert segs == jcodecs.jpeg_metadata_segments(buf)
        assert any(s[4:10] == b"Exif\x00\x00" for s in segs)
        assert any(s[4:16] == b"ICC_PROFILE\x00" for s in segs)

    def test_no_metadata_yields_empty(self):
        out = BytesIO()
        Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(out, "JPEG")
        assert codecs.jpeg_metadata_segments(out.getvalue()) == []
        assert jcodecs.jpeg_metadata_segments(out.getvalue()) == []

    def test_reset_orientation(self):
        segs = codecs.jpeg_metadata_segments(_jpeg_with_metadata(orientation=6))
        exif_seg = next(s for s in segs if s[4:10] == b"Exif\x00\x00")
        patched = codecs.patch_exif_segment(exif_seg, orientation=1)
        assert patched != exif_seg
        assert patched == jcodecs.reset_exif_orientation(exif_seg)
        # re-wrapped into a minimal JPEG so PIL parses the patched segment
        out = BytesIO()
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(out, "JPEG")
        jpg = codecs.insert_jpeg_segments(out.getvalue(), [patched])
        assert jpg == jcodecs.insert_jpeg_segments(out.getvalue(), [patched])
        exif, _ = _read_meta(jpg)
        assert exif[274] == 1
        assert exif[271] == MAKE  # other tags untouched


class TestCarryThrough:
    def test_default_preserves_exif_and_icc_with_orientation_reset(self):
        out = _operation("resize", _jpeg_with_metadata(orientation=6), {"width": "100"})
        exif, icc = _read_meta(out.body)
        assert exif.get(271) == MAKE
        assert exif.get(274) == 1  # the rotation was applied, the tag reset
        assert icc == FAKE_ICC
        # the pixels were rotated: 320x240 oriented 6 is a 240x320 source
        assert Image.open(BytesIO(out.body)).size == (100, 133)

    def test_stripmeta_true_strips(self):
        out = _operation("resize", _jpeg_with_metadata(),
                         {"width": "100", "stripmeta": "true"})
        exif, icc = _read_meta(out.body)
        assert 271 not in exif
        assert icc is None

    def test_norotation_keeps_original_orientation_tag(self):
        out = _operation("resize", _jpeg_with_metadata(orientation=6),
                         {"width": "100", "norotation": "true"})
        exif, _ = _read_meta(out.body)
        assert exif.get(274) == 6  # pixels unrotated, the tag kept

    def test_rgb_path_also_carries(self):
        # a 4:4:4 source takes the rgb transport, whose JPEG still carries
        rng = np.random.default_rng(6)
        img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
        exif = Image.Exif()
        exif[271] = MAKE
        out = BytesIO()
        Image.fromarray(img).save(out, "JPEG", quality=90, subsampling=0,
                                  exif=exif.tobytes())
        got = _operation("resize", out.getvalue(), {"width": "80"})
        ex, _ = _read_meta(got.body)
        assert ex.get(271) == MAKE

    def test_pipeline_route_carries(self):
        out = _pipeline(_jpeg_with_metadata(orientation=1), {"operations": _ops(
            {"operation": "resize", "params": {"width": 90}})})
        exif, icc = _read_meta(out.body)
        assert exif.get(271) == MAKE
        assert icc == FAKE_ICC

    def test_pipeline_top_level_stripmeta_wins(self):
        """?stripmeta=true on /pipeline strips although each op's options
        default to keeping metadata."""
        out = _pipeline(_jpeg_with_metadata(), {"stripmeta": "true", "operations": _ops(
            {"operation": "resize", "params": {"width": 90}})})
        exif, icc = _read_meta(out.body)
        assert 271 not in exif
        assert icc is None

    def test_pipeline_mid_chain_stripmeta_strips(self):
        """stripmeta on any op of a pipeline strips: the reference encodes
        after each op, so a strip mid-chain is for good."""
        out = _pipeline(_jpeg_with_metadata(), {"operations": _ops(
            {"operation": "resize", "params": {"width": 100, "stripmeta": "true"}},
            {"operation": "flip", "params": {}})})
        exif, icc = _read_meta(out.body)
        assert 271 not in exif
        assert icc is None

    def test_fill_bytes_before_marker_still_found(self):
        """ISO 10918-1 B.1.1.2 allows 0xFF fill bytes before any marker: the
        scan skips them."""
        buf = _jpeg_with_metadata()
        padded = buf[:2] + b"\xff\xff" + buf[2:]
        segs = codecs.jpeg_metadata_segments(padded)
        assert segs == jcodecs.jpeg_metadata_segments(padded)
        assert any(s[4:10] == b"Exif\x00\x00" for s in segs)

    def test_exif_pixel_dimensions_resync_to_output(self):
        """PixelX/YDimension in the carried EXIF describe the output (libvips
        re-syncs them on save)."""
        rng = np.random.default_rng(9)
        img = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
        exif = Image.Exif()
        exif[271] = MAKE
        ifd = exif.get_ifd(0x8769)
        ifd[0xA002] = 320
        ifd[0xA003] = 240
        out = BytesIO()
        Image.fromarray(img).save(out, "JPEG", quality=85, subsampling=2,
                                  exif=exif.tobytes())
        got = _operation("resize", out.getvalue(), {"width": "100"})
        im = Image.open(BytesIO(got.body))
        sub = im.getexif().get_ifd(0x8769)
        assert im.size == (100, 75)
        assert (sub.get(0xA002), sub.get(0xA003)) == (100, 75)

    def test_pipeline_norotation_first_op_keeps_orientation_tag(self):
        """A first op with norotation leaves the pixels unrotated for the
        whole chain (orientation is consumed once), so the Orientation tag
        stays, whatever later ops set."""
        out = _pipeline(_jpeg_with_metadata(orientation=6), {"operations": _ops(
            {"operation": "resize", "params": {"width": 100, "norotation": "true"}},
            {"operation": "flip", "params": {}})})
        exif, _ = _read_meta(out.body)
        assert exif.get(274) == 6


@pytest.mark.parametrize("name,query", [
    ("crop", {"width": "120", "height": "90"}),
    ("rotate", {"rotate": "90"}),
    ("smartcrop", {"width": "100", "height": "100"}),
    ("thumbnail", {"width": "80", "height": "80"}),
    ("resize", {"width": "100", "interlace": "true"}),
    ("resize", {"width": "100", "type": "webp"}),
    ("resize", {"width": "100", "type": "png"}),
], ids=["crop", "rotate", "smartcrop", "thumbnail", "interlace", "webp", "png"])
def test_carry_on_other_routes_equals_the_references(name, query):
    """The carry on the other operations and output formats: EXIF, ICC
    and ExifIFD dimensions equal to the JAX package's (WEBP and PNG carry
    nothing in either)."""
    out = _operation(name, _jpeg_with_metadata(orientation=6), query)
    exif, icc = _read_meta(out.body)
    if out.mime == "image/jpeg":
        assert exif.get(271) == MAKE and exif.get(274) == 1 and icc == FAKE_ICC
