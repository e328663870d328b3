"""The cells' source images, made on the host from the seed by recipes a
configuration names (`inputs.recipe`). Every seed gets images of the same
sizes and encodings; only the content differs.

- `photo_jpeg`: a photo-like frame (a smooth colour field, mid-scale
  structure, hard-edged shapes and fine grain) as a baseline JPEG, 4:2:0,
  at the configured quality. Grain keeps the entropy coder as busy as a
  real photo's detail does, so a flat gradient cannot flatter the codec.
  Samples stay inside `range` (video range by default 16-235), so that
  decoding never clips RGB: where it clips, a pixel's luma depends on how
  the decoder rebuilt the chroma, which JPEG leaves to the decoder.
"""

from __future__ import annotations

import io
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image, ImageDraw


def _smooth(rng, h: int, w: int, cells: tuple, amp: float) -> np.ndarray:
    """A [h, w, 3] field of random values on a coarse grid, upsampled
    bicubically: structure at the grid's scale."""
    gh, gw = cells
    grid = rng.uniform(0, 255, size=(gh, gw, 3)).astype(np.uint8)
    up = Image.fromarray(grid, "RGB").resize((w, h), Image.BICUBIC)
    return (np.asarray(up, dtype=np.float32) - 127.5) * (amp / 127.5)


def photo_jpeg(seed: int, spec: dict) -> bytes:
    h, w = spec["height"], spec["width"]
    lo, hi = spec.get("range", (0, 255))
    rng = np.random.default_rng(seed)
    mid, span = (lo + hi) / 2.0, (hi - lo) / 2.0
    img = mid + _smooth(rng, h, w, (5, 9), 0.45 * span) + _smooth(rng, h, w, (34, 60), 0.2 * span)
    canvas = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "RGB")
    draw = ImageDraw.Draw(canvas)
    for _ in range(spec.get("shapes", 24)):
        x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
        x1, y1 = x0 + int(rng.integers(20, w // 4)), y0 + int(rng.integers(20, h // 4))
        fill = tuple(int(c) for c in rng.integers(lo + 0.2 * span, hi - 0.2 * span, size=3))
        if rng.random() < 0.5:
            draw.ellipse((x0, y0, x1, y1), fill=fill)
        else:
            draw.rectangle((x0, y0, x1, y1), fill=fill)
    px = np.asarray(canvas, dtype=np.float32)
    grain = rng.standard_normal((h, w, 3), dtype=np.float32) * spec.get("grain", 8.0)
    px = np.clip(px + grain, lo, hi).astype(np.uint8)
    out = io.BytesIO()
    Image.fromarray(px, "RGB").save(out, "JPEG", quality=spec["quality"], subsampling=2)
    return out.getvalue()


RECIPES = {"photo_jpeg": photo_jpeg}


def image_seed(seed: int, i: int) -> int:
    """The i-th pool image's own seed, spread from the run's."""
    return int(np.random.SeedSequence([seed & 0xFFFFFFFF, seed >> 32, i]).generate_state(1)[0])


def make_pool(seed: int, spec: dict, count: int, threads: int = 4) -> list:
    """`count` distinct source images of the configured recipe."""
    fn = RECIPES[spec["recipe"]]
    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(lambda i: fn(image_seed(seed, i), spec), range(count)))
