"""FAST-16 corner detection over whole images (port of
`openmavis_tpu/frontend/fast.py`; reference: the per-cell FAST calls of
src/ORBextractor.cc:745-779 with iniThFAST -> minThFAST fallback).

Dense bright/dark arc masks from 16 shifted copies, contiguous-run test on
a packed ring word, 3x3 non-max suppression, per-cell threshold fallback
and per-cell top-K. All functions take a leading batch of images
([..., H, W]).
"""

from __future__ import annotations

import numpy as np
import torch

# Bresenham circle of radius 3, clockwise from 12 o'clock, as (dx, dy).
CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)

ARC_LEN = 9


def _ring(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [16, B, H, W] circle-shifted copies (roll wraps; the
    border mask hides the wrapped pixels)."""
    return torch.stack([torch.roll(img, shifts=(-int(dy), -int(dx)),
                                   dims=(-2, -1)) for dx, dy in CIRCLE])


def _arc_word(mask16: torch.Tensor) -> torch.Tensor:
    """[16, ...] bool -> [...] int64 packed ring word (bit i = sample i)."""
    weights = torch.as_tensor(1 << np.arange(16), dtype=torch.int64,
                              device=mask16.device)
    shape = (16,) + (1,) * (mask16.ndim - 1)
    return torch.sum(mask16.to(torch.int64) * weights.reshape(shape), dim=0)


def _word_has_arc(x: torch.Tensor) -> torch.Tensor:
    """Packed ring word -> any circular run of >= 9 set bits (int64, so
    every shift is logical on the 32 used bits)."""
    x = x | (x << 16)
    r = x & (x >> 1)
    r = r & (r >> 2)
    r = r & (r >> 4)
    r = r & (x >> 8)
    return r != 0


def _arc_word_cpu(mask16: torch.Tensor) -> torch.Tensor:
    """`_arc_word` by 16 int32 shifts of [...]-sized planes (the [16, ...]
    int64 product of the dense form dominates on the CPU)."""
    w = mask16[0].to(torch.int32)
    for i in range(1, 16):
        w |= mask16[i].to(torch.int32) << i
    return w.to(torch.int64)


def _score_from_diff(diff: torch.Tensor, threshold: float,
                     inside: torch.Tensor) -> torch.Tensor:
    bright = diff > threshold
    dark = diff < -threshold
    if diff.device.type == "cpu":
        return _score_from_diff_cpu(diff, threshold, bright, dark, inside)
    return _score_from_diff_dense(diff, threshold, bright, dark, inside)


def _score_from_diff_dense(diff, threshold, bright, dark, inside):
    is_corner = (_word_has_arc(_arc_word(bright))
                 | _word_has_arc(_arc_word(dark)))
    zero = torch.zeros((), dtype=diff.dtype, device=diff.device)
    excess_b = torch.sum(torch.where(bright, diff - threshold, zero), dim=0)
    excess_d = torch.sum(torch.where(dark, -diff - threshold, zero), dim=0)
    score = torch.maximum(excess_b, excess_d)
    return torch.where(is_corner & inside, score, zero)


def _score_from_diff_cpu(diff, threshold, bright, dark, inside):
    """The CPU route of `_score_from_diff`: the same score, exactly, with
    the arc words packed plane by plane and the excess sums taken over
    the corner pixels only. torch's CPU sum over dim 0 adds the 16 planes
    in order at every pixel but the last few of the whole tensor (outside
    the border, never a corner), so the sums here add them in order."""
    corner = ((_word_has_arc(_arc_word_cpu(bright))
               | _word_has_arc(_arc_word_cpu(dark))) & inside).reshape(-1)
    idx = torch.nonzero(corner)[:, 0]
    d = diff.reshape(16, -1)[:, idx]
    zero = torch.zeros((), dtype=diff.dtype)
    exc_b = torch.where(d > threshold, d - threshold, zero)
    exc_d = torch.where(d < -threshold, -d - threshold, zero)
    sum_b, sum_d = exc_b[0], exc_d[0]
    for i in range(1, 16):
        sum_b = sum_b + exc_b[i]
        sum_d = sum_d + exc_d[i]
    score = torch.zeros(corner.shape, dtype=diff.dtype)
    score[idx] = torch.maximum(sum_b, sum_d)
    return score.reshape(diff.shape[1:])


def _inside_mask(h: int, w: int, border: int, device) -> torch.Tensor:
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return ((ys >= border) & (ys < h - border)
            & (xs >= border) & (xs < w - border))


def fast_score_map(img: torch.Tensor, threshold: float,
                   border: int = 16) -> torch.Tensor:
    """Dense FAST-9/16 response of [..., H, W]; 0 where not a corner."""
    h, w = img.shape[-2:]
    diff = _ring(img) - img[None]
    return _score_from_diff(diff, threshold,
                            _inside_mask(h, w, border, img.device))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only 3x3-local maxima (ties kept); -inf padding like
    reduce_window's SAME padding."""
    flat = score.reshape((-1, 1) + score.shape[-2:])
    m = torch.nn.functional.max_pool2d(flat, 3, stride=1, padding=1)
    m = m.reshape(score.shape)
    return torch.where(score >= m, score, torch.zeros_like(score))


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties lowest-index first (the order
    `lax.top_k` guarantees; `torch.topk` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect(img: torch.Tensor, th_high: float, th_low: float,
           cell: int = 32, topk_per_cell: int = 8, border: int = 16):
    """FAST with per-cell high->low threshold fallback + per-cell top-K.

    img: [..., H, W]. Returns (xy [..., N, 2] float32 (x, y), score
    [..., N], valid [..., N]) with N = n_cells * topk_per_cell in cell
    order."""
    h, w = img.shape[-2:]
    batch = img.shape[:-2]
    diff = _ring(img) - img[None]
    inside = _inside_mask(h, w, border, img.device)
    s_low = nms3x3(_score_from_diff(diff, th_low, inside))
    s_high = nms3x3(_score_from_diff(diff, th_high, inside))

    ch = cw = cell
    ny, nx = h // ch, w // cw

    def cells(s):
        s = s[..., :ny * ch, :nx * cw].reshape(batch + (ny, ch, nx, cw))
        return s.movedim(-2, -3).reshape(batch + (ny * nx, ch * cw))

    s_low_c, s_high_c = cells(s_low), cells(s_high)
    has_high = torch.any(s_high_c > 0, dim=-1, keepdim=True)
    s_cell = torch.where(has_high, s_high_c, s_low_c)

    k = topk_per_cell
    vals, idx = topk_stable(s_cell, k)                   # [..., nC, k]
    cell_ids = torch.arange(ny * nx, device=img.device)[:, None]
    cy = cell_ids // nx
    cx = cell_ids % nx
    xs = (cx * cw + idx % cw).to(torch.float32)
    ys = (cy * ch + idx // cw).to(torch.float32)
    xy = torch.stack([xs.reshape(batch + (-1,)),
                      ys.reshape(batch + (-1,))], dim=-1)
    return xy, vals.reshape(batch + (-1,)), (vals > 0).reshape(batch + (-1,))
