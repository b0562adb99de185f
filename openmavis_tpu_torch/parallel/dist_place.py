"""Sharded place recognition: the keyframe descriptor bank partitioned
over a process group (port of `openmavis_tpu/parallel/dist_place.py`).

Each rank scores the query against its block of keyframes and the [K]
scores are assembled by one collective per query.
"""

from __future__ import annotations

import torch

from ..frontend import matcher
from .dist_ba import Mesh, assemble


def sharded_place_scores(mesh: Mesh, kf_desc, kf_feat_valid, kf_valid,
                         q_desc, q_valid):
    """Scores [K] int32: per keyframe, the query features whose best
    Hamming distance among its features is < TH_LOW.

    kf_desc [K, F, 256] is sharded over the mesh by contiguous blocks of
    keyframes; the query is replicated. K must be a multiple of the mesh
    size (use padded slabs)."""
    K, F = kf_feat_valid.shape
    if K % mesh.size:
        raise ValueError(f"K={K} keyframes is not a multiple of "
                         f"{mesh.size} ranks")
    Ks = K // mesh.size
    blk = slice(mesh.rank * Ks, (mesh.rank + 1) * Ks)
    dist = matcher.hamming_matrix(
        q_desc, kf_desc[blk].reshape(Ks * F, 256)).reshape(-1, Ks, F)
    t_valid = kf_feat_valid[blk] & kf_valid[blk, None]
    dist = torch.where(t_valid[None], dist, 1 << 20)
    good = (dist.min(dim=2).values < matcher.TH_LOW) & q_valid[:, None]
    return assemble(mesh, torch.sum(good, dim=0, dtype=torch.int32), K)
