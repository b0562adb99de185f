"""Descriptor matching over {0,1} descriptor planes (port of
`openmavis_tpu/frontend/matcher.py`; reference: ORBmatcher, src/ORBmatcher.cc
— projection search, knn with Lowe ratio, mutual check).

All search structure (spatial windows, scale gates, validity) is a boolean
admissibility relation over the [N, M] query x target grid. The best-2
search itself goes through the hand-written Hopper kernels of
`matcher_cuda` on CUDA tensors: `match_nn` hands `masked_best2_fused` the
relation as a bool mask; `match_projection` hands `projection_best2` the
O(N + M) factors of the relation and never builds the [N, M] mask there.
`masked_best2`, `window_mask` and `level_mask` here make up the kernels'
plain versions.

Thresholds follow the reference: TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30.
"""

from __future__ import annotations

import math

import torch

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30

BIG = 1 << 20
_INVALID = 300  # > max Hamming distance (256); packs safely


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[N, 256] x [M, 256] {0,1} int8 -> [N, M] int32 Hamming distances
    (|a| + |b| - 2 a.b; exact in float32: row sums <= 256)."""
    a = d1.to(torch.float32)
    b = d2.to(torch.float32)
    dot = (a @ b.T).to(torch.int32)
    s1 = d1.to(torch.int32).sum(-1)
    s2 = d2.to(torch.int32).sum(-1)
    return s1[:, None] + s2[None, :] - 2 * dot


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _packed(dist: torch.Tensor, mask: torch.Tensor):
    """(comb [N, M] int64 = dist' * 2^k + col, 2^k, cols) with dist'
    clamped below _INVALID on admissible entries and _INVALID elsewhere."""
    mp = _next_pow2(dist.shape[1])
    d = torch.where(mask, torch.clamp(dist, max=_INVALID - 1),
                    torch.full_like(dist, _INVALID)).to(torch.int64)
    cols = torch.arange(dist.shape[1], device=dist.device)[None, :]
    return d * mp + cols, mp, cols


def masked_argmin(dist: torch.Tensor, mask: torch.Tensor):
    """Masked argmin per row with smallest-index tie-breaking.
    Returns (best_idx [N], best [N]) int32; best == _INVALID where no
    admissible column."""
    comb, mp, _ = _packed(dist, mask)
    best = comb.min(dim=1).values
    return (best % mp).to(torch.int32), (best // mp).to(torch.int32)


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Best and second-best per row over distinct columns.
    Returns (best_idx, best, second) int32 [N]; rows with no admissible
    column give (0, _INVALID, _INVALID)."""
    comb, mp, cols = _packed(dist, mask)
    best_comb = comb.min(dim=1).values
    best_idx = best_comb % mp
    comb2 = torch.where(cols == best_idx[:, None], _INVALID * mp + cols,
                        comb)
    second = comb2.min(dim=1).values // mp
    return (best_idx.to(torch.int32), (best_comb // mp).to(torch.int32),
            second.to(torch.int32))


def mutual_filter(best_idx_12, valid_12, best_idx_21):
    """Keep matches where argmin(1->2) and argmin(2->1) agree."""
    back = best_idx_21[best_idx_12.to(torch.int64)]
    return valid_12 & (back == torch.arange(best_idx_12.shape[0],
                                            device=back.device))


def rotation_histogram_filter(angle1, angle2_matched, valid,
                              n_bins: int = HISTO_LENGTH,
                              keep_bins: int = 3):
    """Keep matches whose angle difference falls in the `keep_bins` most
    populated bins (reference: ORBmatcher::ComputeThreeMaxima)."""
    rot = torch.remainder((angle1 - angle2_matched) * (180.0 / math.pi),
                          360.0)
    bins = torch.clamp((rot * n_bins / 360.0).to(torch.int64), 0,
                       n_bins - 1)
    counts = torch.zeros(n_bins, dtype=torch.int32, device=bins.device)
    counts.index_add_(0, bins, valid.to(torch.int32))
    _, top_bins = torch.sort(counts, descending=True, stable=True)
    top_bins = top_bins[:keep_bins]
    top_counts = counts[top_bins]
    bin_ok = top_counts.to(torch.float32) > 0.1 * top_counts[0]
    in_top = torch.any((bins[:, None] == top_bins[None, :])
                       & bin_ok[None, :], dim=1)
    return valid & in_top


def match_nn(d1, valid1, d2, valid2, max_dist: int = TH_LOW,
             ratio: float = 0.9, mutual: bool = True, extra_mask=None):
    """Nearest-neighbour matching with Lowe ratio + optional mutual check.

    d1 [N,256], d2 [M,256] {0,1} int8; valid1/valid2 masks; extra_mask
    optional [N, M] bool of admissible pairs.
    Returns (idx2 [N] int32 match in d2 or -1, dist [N] int32)."""
    from . import matcher_cuda

    mask = valid1[:, None] & valid2[None, :]
    if extra_mask is not None:
        mask = mask & extra_mask
    bi, b, s = matcher_cuda.masked_best2_fused(d1, d2, mask)
    ok = _accept(b, s, max_dist, ratio)
    if mutual:
        # the transposed view: the kernel reads it through its strides
        bi21, _, _ = matcher_cuda.masked_best2_fused(d2, d1, mask.T)
        ok = mutual_filter(bi, ok, bi21)
    return _matches(bi, b, ok)


def _accept(best, second, max_dist: int, ratio: float) -> torch.Tensor:
    """Distance threshold and Lowe ratio test on a best-2 result."""
    return (best <= max_dist) & (best.to(torch.float32)
                                 <= ratio * second.to(torch.float32))


def _matches(best_idx, best, ok):
    """(idx or -1, dist or BIG) per query."""
    return torch.where(ok, best_idx, -1), torch.where(ok, best, BIG)


def window_mask(xy1, xy2, radius) -> torch.Tensor:
    """[N,2] x [M,2] -> [N,M] bool: chebyshev window |dx|,|dy| < r
    (scalar or per-row [N] radius)."""
    dx = (xy1[:, None, 0] - xy2[None, :, 0]).abs()
    dy = (xy1[:, None, 1] - xy2[None, :, 1]).abs()
    r = torch.as_tensor(radius, dtype=xy1.dtype, device=xy1.device)
    if r.ndim == 1:
        r = r[:, None]
    return (dx < r) & (dy < r)


def level_mask(level1, level2, lo_off: int = -1,
               hi_off: int = 1) -> torch.Tensor:
    """Scale-consistency gate: level2 in [level1+lo_off, level1+hi_off]."""
    l1 = level1[:, None]
    l2 = level2[None, :]
    return (l2 >= l1 + lo_off) & (l2 <= l1 + hi_off)


def match_projection(proj_xy, pred_level, radius, d_query, valid_query,
                     feat_xy, feat_level, feat_desc, feat_valid,
                     max_dist: int = TH_HIGH, ratio: float = 1.0):
    """Projection-guided search (ORBmatcher::SearchByProjection): each
    projected landmark searches frame features within a spatial window and
    within +-1 pyramid level of its predicted level. On CUDA tensors the
    window, level and validity tests run inside the kernel; on the CPU the
    plain version builds the mask from `window_mask` and `level_mask`.
    Returns (idx [N], dist [N])."""
    from . import matcher_cuda

    bi, b, s = matcher_cuda.projection_best2(
        proj_xy, pred_level, radius, d_query, valid_query, feat_xy,
        feat_level, feat_desc, feat_valid)
    return _matches(bi, b, _accept(b, s, max_dist, ratio))


def dedup_targets(idx: torch.Tensor, dist: torch.Tensor,
                  n_targets: int) -> torch.Tensor:
    """Keep, per target column, only the query with minimal distance;
    exact ties go to the first query index."""
    N = idx.shape[0]
    has = idx >= 0
    safe_t = torch.where(has, idx, n_targets).to(torch.int64)
    big = torch.full((n_targets + 1,), BIG, dtype=dist.dtype,
                     device=dist.device)
    best = big.scatter_reduce(0, safe_t, torch.where(
        has, dist, torch.full_like(dist, BIG)), "amin")
    keep = has & (dist <= best[safe_t])
    qi = torch.arange(N, dtype=torch.int32, device=idx.device)
    first = torch.full((n_targets + 1,), N, dtype=torch.int32,
                       device=idx.device).scatter_reduce(
        0, safe_t, torch.where(keep, qi, torch.full_like(qi, N)), "amin")
    keep = keep & (first[safe_t] == qi)
    return torch.where(keep, idx, torch.full_like(idx, -1))
