"""The judge of JPEG answers: libjpeg's arithmetic reproduced exactly,
the judge found by the name a configuration gives, and the reference's
own answer read as sound."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from benchmark import inputs, islow, jpegcoef, refcore, spec

JUDGE = spec.config(spec.load(), "jpeg1080-upstream")["judge"]


@pytest.mark.parametrize("quality", [80, 92, 35])
def test_islow_is_libjpegs_encode(quality):
    """Pillow's libjpeg, at 4:4:4 so that it writes the planes it is
    given, quantises every coefficient as `islow` does."""
    rng = np.random.default_rng(quality)
    img = (rng.uniform(0, 80, (72, 96, 3)) + np.linspace(0, 170, 96)[None, :, None]).astype(np.uint8)
    out = io.BytesIO()
    Image.fromarray(img, "YCbCr").save(out, "JPEG", quality=quality, subsampling=0)
    comps = jpegcoef.coefficients(out.getvalue())
    luma, chroma = islow.quality_tables(quality)
    for k, ((coef, q), want_q) in enumerate(zip(comps, (luma, chroma, chroma))):
        assert np.array_equal(q, want_q)
        assert np.array_equal(coef, islow.quantised(img[..., k], q))


def test_the_judge_is_found_by_name():
    mod = spec.judge(JUDGE["gap"])
    assert all(callable(getattr(mod, f)) for f in ("read", "encode", "gap"))
    with pytest.raises(ValueError):
        spec.judge("../run")


def test_the_references_own_answer_reads_zero_and_a_shift_does_not():
    body = inputs.make_pool(2**31 + 3, dict(spec.config(spec.load(), "jpeg1080-upstream")
                                            ["inputs"], width=256, height=144), 1)[0]
    frame = refcore.resample(refcore.decode_jpeg(body, 2), 60, 104)
    mod = spec.judge(JUDGE["gap"])
    assert mod.gap(mod.encode(frame, JUDGE), frame, JUDGE) == 0.0
    assert mod.gap(mod.encode(frame + 0.6, JUDGE), frame, JUDGE) > 0.05


def test_decode_rebuilds_chroma_from_the_4_2_0_planes():
    """A flat chroma plane stays flat through the rebuild, and luma is
    libjpeg's own at every scale."""
    y = np.tile(np.linspace(30, 220, 64).astype(np.uint8), (48, 1))
    ycc = np.stack([y, np.full_like(y, 120), np.full_like(y, 135)], axis=-1)
    out = io.BytesIO()
    Image.fromarray(ycc, "YCbCr").save(out, "JPEG", quality=95, subsampling=2)
    for shrink in (1, 2, 4):
        rgb = refcore.decode_jpeg(out.getvalue(), shrink)
        back = refcore.rgb_to_ycc(rgb)
        with Image.open(io.BytesIO(out.getvalue())) as im:
            im.draft("YCbCr", (64 // shrink, 48 // shrink))
            want_y = np.asarray(im)[..., 0].copy()
        assert rgb.shape == (48 // shrink, 64 // shrink, 3)
        assert torch.allclose(back[..., 0], torch.from_numpy(want_y).double(), atol=1e-3)
        assert float(back[..., 1].std()) < 1.5 and float(back[..., 2].std()) < 1.5
