"""Malformed input through the port's own host codec: a port copy of
tests/test_robustness.py's twelve cases, on the CPU.

The port's native codec (imaginary_tpu_torch/native/codecs.cpp) is
hand-written C++ over libjpeg, libpng, libwebp and libtiff, with an
in-tree GIF codec, a median-cut palette, an EXIF parser and JPEG segment
splicing, and it meets untrusted bytes in every request. These cases feed
truncations and bit flips of real encodes through every entry point. The
contract is a result or an ImageError: any other exception fails the
case, a crash kills the pytest worker (which fails it too), and nothing
may hang.

Beside the copy: phase 2c's sweep (`chip_smoke.robustness_sweep`, which
the chip run makes on the card machine's build of the codec) run here at
a smaller count, each format's "other" count held at zero.
"""

import threading
import zlib

import numpy as np
import pytest

import chip_smoke
from imaginary_tpu_torch import codecs
from imaginary_tpu_torch.codecs import EncodeOptions
from imaginary_tpu_torch.errors import ImageError
from imaginary_tpu_torch.imgtype import ImageType

FORMATS = ["jpeg", "png", "webp", "gif", "tiff"]


def _mk(fmt: str) -> bytes:
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    return codecs.encode(arr, EncodeOptions(type=ImageType(fmt), quality=85))


def _cuts(buf: bytes):
    """Truncation points: every header byte, then strided body cuts."""
    head = list(range(0, min(len(buf), 40)))
    body = list(range(40, len(buf), max(1, len(buf) // 50)))
    return head + body


@pytest.mark.parametrize("fmt", FORMATS)
def test_truncations_never_crash_decode(fmt):
    buf = _mk(fmt)
    for cut in _cuts(buf):
        try:
            assert codecs.decode(buf[:cut], 1).array.ndim == 3
        except ImageError:
            pass
    assert codecs.decode(buf, 1).array.shape[:2] == (64, 96)


@pytest.mark.parametrize("fmt", FORMATS)
def test_bitflips_never_crash_decode(fmt):
    buf = bytearray(_mk(fmt))
    rng = np.random.default_rng(11)
    for _ in range(80):
        pos = int(rng.integers(0, len(buf)))
        bit = 1 << int(rng.integers(0, 8))
        mutated = bytes(buf[:pos]) + bytes([buf[pos] ^ bit]) + bytes(buf[pos + 1:])
        try:
            codecs.decode(mutated, 1)
        except ImageError:
            pass


def test_probe_on_truncations_and_noise():
    for fmt in FORMATS:
        buf = _mk(fmt)
        for cut in _cuts(buf):
            try:
                m = codecs.probe(buf[:cut])
                assert m.width >= 0 and m.height >= 0
            except ImageError:
                pass
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 3, 7, 11, 64, 4096):
        try:
            codecs.probe(bytes(rng.integers(0, 256, n, dtype=np.uint8)))
        except ImageError:
            pass


def test_probe_fast_matches_probe_contract_on_garbage():
    rng = np.random.default_rng(9)
    for n in (0, 3, 12, 100, 2048):
        blob = b"\xff\xd8\xff" + bytes(rng.integers(0, 256, n, dtype=np.uint8))
        for fn in (codecs.probe, codecs.probe_fast):
            try:
                fn(blob)
            except ImageError:
                pass


def test_yuv_decode_truncations_never_crash():
    """The packed 4:2:0 decode is the port's JPEG transport: it is always
    built (the reference skips where its raw codec is absent), and a
    truncation answers a result or an ImageError (the reference also lets
    a ValueError through)."""
    from imaginary_tpu_torch.ops.buckets import bucket_shape

    assert codecs.yuv420_supported()
    buf = _mk("jpeg")
    hb, wb = bucket_shape(64, 96)
    for cut in _cuts(buf):
        try:
            codecs.decode_yuv420(buf[:cut], 1, hb, wb)
        except ImageError:
            pass
    assert codecs.decode_yuv420(buf, 1, hb, wb) is not None


def test_exif_carry_on_corrupt_exif_segments(testdata):
    """The metadata splice survives hostile APP1 payloads: the output is a
    JPEG with whatever could be carried, or the plain encode."""
    from imaginary_tpu_torch.pipeline import ProcessedImage, _carry_metadata
    from tests.conftest import fixture_bytes

    src = bytearray(fixture_bytes("exif-orient-6.jpg"))
    i = src.find(b"\xff\xe1")
    assert i > 0
    out = ProcessedImage(body=codecs.encode(np.zeros((8, 8, 3), np.uint8),
                                            EncodeOptions(type=ImageType.JPEG)),
                         mime="image/jpeg")
    for mutation in (
        src[:i] + b"\xff\xe1\x00\x02" + src[i + 4:],        # an empty segment
        src[:i] + b"\xff\xe1\xff\xff" + src[i + 4:],        # a huge length
        src[:i + 4] + b"\x00" * 20 + src[i + 24:],          # a zeroed TIFF head
    ):
        got = _carry_metadata(bytes(mutation), False, out, True, 8, 8)
        assert bytes(got.body[:2]) == b"\xff\xd8"


def test_pipeline_rejects_hostile_inputs_cleanly():
    """Random blobs through the whole operation path answer ImageError."""
    from imaginary_tpu_torch.options import ImageOptions
    from imaginary_tpu_torch.pipeline import process_operation

    rng = np.random.default_rng(17)
    for n in (0, 1, 16, 512):
        blob = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        with pytest.raises(ImageError):
            process_operation("resize", blob, ImageOptions(width=32), device="cpu")
    jpg = _mk("jpeg")  # a valid magic, a truncated body
    for cut in (3, 20, len(jpg) // 2):
        try:
            process_operation("resize", jpg[:cut], ImageOptions(width=32), device="cpu")
        except ImageError:
            pass


def test_vector_decode_truncations_never_crash(testdata):
    """SVG (librsvg) and PDF (poppler, else pdf_mini) go through ctypes
    or hand-written parsing: a hostile byte gives an ImageError (406),
    never a crash. A missing loader makes the decode an ImageError, which
    meets the contract."""
    from tests.conftest import fixture_bytes

    for fixture in ("button.svg", "page.pdf"):
        buf = fixture_bytes(fixture)
        for cut in _cuts(buf):
            try:
                codecs.decode(buf[:cut], 1)
            except ImageError:
                pass
    rng = np.random.default_rng(23)
    for fixture in ("button.svg", "page.pdf"):
        buf = bytearray(fixture_bytes(fixture))
        for _ in range(40):
            pos = int(rng.integers(0, len(buf)))
            mutated = bytes(buf[:pos]) + bytes([buf[pos] ^ 0x41]) + bytes(buf[pos + 1:])
            try:
                codecs.decode(mutated, 1)
            except ImageError:
                pass


def test_pdf_mini_fuzz_never_crashes(testdata):
    """The port's PDF renderer (codecs/pdf_mini.py) parses untrusted bytes
    by hand: it renders or raises UnsupportedPdf. It is called directly,
    so an escaping IndexError or RecursionError fails the case."""
    from imaginary_tpu_torch.codecs import pdf_mini
    from tests.conftest import fixture_bytes

    buf = fixture_bytes("page.pdf")
    for cut in _cuts(buf):
        try:
            assert pdf_mini.rasterize(buf[:cut]).ndim == 3
        except pdf_mini.UnsupportedPdf:
            pass
    rng = np.random.default_rng(17)
    for _ in range(120):
        pos = int(rng.integers(0, len(buf)))
        bit = 1 << int(rng.integers(0, 8))
        try:
            pdf_mini.rasterize(buf[:pos] + bytes([buf[pos] ^ bit]) + buf[pos + 1:])
        except pdf_mini.UnsupportedPdf:
            pass
    assert pdf_mini.rasterize(buf).shape == (160, 240, 4)


def _mini_pdf(objects: dict) -> bytes:
    """A minimal classic-xref PDF of {num: object body}: byte offsets,
    20-byte xref entries, trailer and startxref."""
    out = bytearray(b"%PDF-1.4\n")
    offsets = {}
    for num in sorted(objects):
        offsets[num] = len(out)
        out += b"%d 0 obj\n" % num
        out += objects[num]
        out += b"\nendobj\n"
    xref_off = len(out)
    top = max(objects) + 1
    out += b"xref\n0 %d\n" % top
    out += b"0000000000 65535 f \n"
    for num in range(1, top):
        out += b"%010d 00000 n \n" % offsets.get(num, 0)
    out += b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (top, xref_off)
    return bytes(out)


def test_pdf_mini_decompression_bomb_refused(monkeypatch):
    """A few KB of crafted deflate do not expand past the budget:
    stream_data inflates in bounded chunks and refuses beyond it."""
    from imaginary_tpu_torch.codecs import pdf_mini

    bomb = zlib.compress(b"\x00" * (4 * 1024 * 1024), 9)  # ~4 KB -> 4 MB
    assert len(bomb) < 16 * 1024
    body = (b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(bomb)
            + bomb + b"\nendstream")
    doc = pdf_mini._Doc(_mini_pdf({1: body}))
    sobj = doc.obj(pdf_mini._Ref(1))
    assert isinstance(sobj, tuple)
    monkeypatch.setattr(pdf_mini, "_MAX_STREAM_BYTES", 1024 * 1024)
    with pytest.raises(pdf_mini.UnsupportedPdf, match="decompression budget"):
        doc.stream_data(sobj)
    monkeypatch.setattr(pdf_mini, "_MAX_STREAM_BYTES", 8 * 1024 * 1024)
    assert doc.stream_data(sobj) == b"\x00" * (4 * 1024 * 1024)


def test_pdf_mini_circular_length_refused():
    """A /Length that resolves back into its own object refuses, and the
    guard leaves a well-formed document resolvable."""
    from imaginary_tpu_torch.codecs import pdf_mini

    doc = pdf_mini._Doc(_mini_pdf({1: b"<< /Length 1 0 R >>\nstream\nxyzzy\nendstream"}))
    with pytest.raises(pdf_mini.UnsupportedPdf, match="circular reference"):
        doc.obj(pdf_mini._Ref(1))
    doc2 = pdf_mini._Doc(_mini_pdf({1: b"<< /Length 5 >>\nstream\nhello\nendstream"}))
    assert doc2.obj(pdf_mini._Ref(1))[1] == b"hello"


def _rss_mb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def test_new_codec_paths_leak_free_and_thread_safe(testdata):
    """GIF, TIFF and the palette PNG are the codec's hand-written paths
    (the in-tree GIF codec, libtiff's ABI declared in codecs.cpp, the
    median-cut palette): 8 threads of 40 encodes and decodes each, RSS
    flat. A leak of one raster buffer a call (~90 KB here) over the 960
    calls would move RSS by ~85 MB."""
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (120, 160, 4), dtype=np.uint8)
    encs = {
        "gif": codecs.encode(arr, EncodeOptions(type=ImageType.GIF)),
        "tiff": codecs.encode(arr, EncodeOptions(type=ImageType.TIFF)),
        "png8": codecs.encode(arr, EncodeOptions(type=ImageType.PNG, palette=True)),
    }

    def hammer(k):
        for i in range(40):
            t = (ImageType.GIF, ImageType.TIFF, ImageType.PNG)[(k + i) % 3]
            codecs.encode(arr, EncodeOptions(type=t, palette=(t is ImageType.PNG)))
            codecs.decode(encs[("gif", "tiff", "png8")[(k + i) % 3]])

    hammer(0)  # warm the allocators before the baseline
    base = _rss_mb()
    threads = [threading.Thread(target=hammer, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    grown = _rss_mb() - base
    assert grown < 40.0, f"RSS grew {grown:.1f} MB across 960 codec calls"


def test_phase_2c_sweep_meets_the_contract():
    """chip_smoke's phase 2c sweep at a smaller count: every format's calls
    are results or ImageErrors, each format has both, and the JPEG's
    include probe_fast and decode_yuv420."""
    sweep = chip_smoke.robustness_sweep(flips=150, body_cuts=40)
    assert list(sweep) == list(chip_smoke.ROBUST_FORMATS) == FORMATS
    for fmt, c in sweep.items():
        assert c["other"] == 0, (fmt, c["examples"])
        assert c["results"] > 0 and c["image_errors"] > 0, (fmt, c)
        per = 4 if fmt == "jpeg" else 2
        assert c["calls"] == per * (c["truncations"] + c["flips"]), (fmt, c)
