"""A JPEG answer held to the reference coefficient by coefficient.

The reference's frame gives the 8-bit planes the service's encoder should
receive: Y, and Cb and Cr each the mean of 2x2 pixels (4:2:0), all from
the clipped float frame, rounded half up. libjpeg's arithmetic on those
planes (`benchmark/islow.py`) gives the one set of quantised coefficients
a sound answer holds; the answer's own are read from its entropy-coded
data (`benchmark/jpegcoef.py`), so no decoder rounds them.

A sample within `TIE` of a rounding tie may round either way in float32,
and a block that holds one may differ from the reference without fault:
such blocks are left out. `jpeg_coef_mismatch` is the share of the other
whole blocks' coefficients, among those that the answer or the reference
holds non-zero, that the answer quantised to another value. A sound
answer reads 0 but for the rare tie that float32 moves by more than
`TIE`; an answer of coarser arithmetic moves a sample across a rounding
boundary wherever its error is larger than the sample's distance to one.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import islow, jpegcoef, refcore

TIE = 1e-3  # levels: a reference sample this near x.5 may round either way


def planes(frame: torch.Tensor) -> list:
    """Float64 Y, Cb and Cr planes (chroma pooled 2x2, a lone edge row or
    column on its own) of the clipped frame."""
    ycc = refcore.rgb_to_ycc(torch.clamp(frame.double(), 0.0, 255.0))
    chroma = torch.nn.functional.avg_pool2d(ycc[..., 1:].permute(2, 0, 1)[None], 2,
                                            ceil_mode=True)[0]
    return [ycc[..., 0].numpy(), chroma[0].numpy(), chroma[1].numpy()]


def _u8(plane: np.ndarray) -> np.ndarray:
    return np.floor(np.clip(plane, 0.0, 255.0) + 0.5).astype(np.uint8)


def read(answer: bytes) -> list:
    """The answer's (quantised coefficients, steps) per component."""
    return jpegcoef.coefficients(answer)


def encode(frame: torch.Tensor, judge: dict) -> list:
    """The coefficients the service's encoder writes for a frame at the
    configured quality: the control's answer."""
    luma, chroma = islow.quality_tables(judge["quality"])
    return [(islow.quantised(_u8(p), q), q) for p, q in zip(planes(frame), (luma, chroma, chroma))]


def gap(answer: list, frame: torch.Tensor, judge: dict) -> float:
    """The share of the reference's settled coefficients the answer holds
    otherwise (see the module's docstring)."""
    if len(answer) != 3:
        return float("inf")
    differ = counted = 0
    for (got, q), plane in zip(answer, planes(frame)):
        want = islow.quantised(_u8(plane), q)
        rows, cols = want.shape[:2]
        if got.shape[0] < rows or got.shape[1] < cols:
            return float("inf")
        got = got[:rows, :cols]
        b, _, _ = islow.blocks(np.clip(plane, 0.0, 255.0))
        settled = ~(np.abs(b - np.floor(b) - 0.5) < TIE).reshape(rows, cols, 64).any(axis=-1)
        live = ((got != 0) | (want != 0)) & settled[..., None]
        differ += int(((got != want) & live).sum())
        counted += int(live.sum())
    return differ / max(1, counted)
