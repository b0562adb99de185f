"""Keyframe database: place recognition by BoW scores (port of
`openmavis_tpu/slam_map/keyframe_db.py`; reference: src/
KeyFrameDatabase.cc — the BoW inverted file, DetectNBestCandidates at
:581, the covisible-score floor at :589-607).

Two layouts: the dense `KeyframeDB` holds one [n_words] tf-idf row a
keyframe and scores a query as one batched L1; the word-sparse
`SparseKeyframeDB` holds each keyframe's top-W (word id, weight) pairs
and scores a query by scattering it once into a transient dense
[n_words] vector, gathered at every stored word id — the inverted-file
accumulation with the roles transposed, O(K W) work and memory. Top-3
selections break ties toward the lower slot, as `lax.top_k` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..frontend.fast import topk_stable
from ..ops import scatter_max, set_rows
from . import vocabulary as voc


class KeyframeDB(NamedTuple):
    bow: torch.Tensor      # [K, n_words] L1-normalized tf-idf per keyframe
    valid: torch.Tensor    # [K] bool


def allocate(max_kf: int, n_words: int, device=None) -> KeyframeDB:
    dev = resolve_device(device)
    return KeyframeDB(
        bow=torch.zeros((max_kf, n_words), dtype=torch.float32, device=dev),
        valid=torch.zeros(max_kf, dtype=torch.bool, device=dev))


def add(db: KeyframeDB, slot, bow_vec) -> KeyframeDB:
    return KeyframeDB(bow=set_rows(db.bow, slot, bow_vec),
                      valid=set_rows(db.valid, slot, True))


def _top3(scores, valid, exclude, min_score):
    scores = torch.where(valid & ~exclude, scores, -1.0)
    top_scores, top_idx = topk_stable(scores, 3)
    ok = top_scores > torch.clamp(torch.as_tensor(
        min_score, dtype=scores.dtype, device=scores.device), min=0.0)
    return scores, top_idx, ok


def query(db: KeyframeDB, bow_vec: torch.Tensor, exclude: torch.Tensor,
          min_score):
    """Loop / relocalization candidates by BoW similarity.

    bow_vec: [n_words] query; exclude: [K] bool, the keyframes to skip
    (the query's covisibility group, KeyFrameDatabase.cc:589-607);
    min_score: the score floor. Returns (scores [K], top-3 slots [3],
    top-3 ok [3])."""
    return _top3(voc.l1_score(db.bow, bow_vec[None, :]), db.valid, exclude,
                 min_score)


def _min_over(scores, valid, cov_row, cov_threshold: int):
    neigh = (cov_row >= cov_threshold) & valid
    mn = torch.min(torch.where(neigh, scores, torch.inf))
    return torch.where(torch.isfinite(mn), mn, 0.0)


def min_covisible_score(db: KeyframeDB, bow_vec, cov_row,
                        cov_threshold: int = 15):
    """The candidate score floor: the least BoW score between the query
    and its covisible keyframes (>= cov_threshold shared points), 0 when
    there is none (LoopClosing.cc / KeyFrameDatabase.cc:589)."""
    return _min_over(voc.l1_score(db.bow, bow_vec[None, :]), db.valid,
                     cov_row, cov_threshold)


# -- word-sparse database (inverted-file semantics, bounded memory) ------

class SparseKeyframeDB(NamedTuple):
    word: torch.Tensor     # [K, W] int32 word ids (pad slots: wt == 0)
    wt: torch.Tensor       # [K, W] f32 L1-normalized tf-idf weights
    valid: torch.Tensor    # [K] bool


def allocate_sparse(max_kf: int, top_w: int, device=None) -> SparseKeyframeDB:
    dev = resolve_device(device)
    return SparseKeyframeDB(
        word=torch.zeros((max_kf, top_w), dtype=torch.int32, device=dev),
        wt=torch.zeros((max_kf, top_w), dtype=torch.float32, device=dev),
        valid=torch.zeros(max_kf, dtype=torch.bool, device=dev))


def add_sparse(db: SparseKeyframeDB, slot, word, wt) -> SparseKeyframeDB:
    return SparseKeyframeDB(word=set_rows(db.word, slot, word),
                            wt=set_rows(db.wt, slot, wt),
                            valid=set_rows(db.valid, slot, True))


def scores_sparse(db: SparseKeyframeDB, q_word, q_wt, n_words: int):
    """L1 similarity of the query against every stored keyframe, in the
    min-intersection form (`vocabulary.l1_score_sparse`): the query
    scatters into a dense [n_words] vector, gathered at each stored word.
    The scatter takes the max: pad slots alias word 0 with weight 0 and
    must not clobber a real word-0 weight."""
    q_dense = scatter_max(torch.zeros(n_words, dtype=torch.float32,
                                      device=q_wt.device), q_word, q_wt)
    return torch.sum(torch.minimum(db.wt, q_dense[db.word.to(torch.int64)]),
                     dim=-1)


def query_sparse(db: SparseKeyframeDB, q_word, q_wt, exclude: torch.Tensor,
                 min_score, n_words: int):
    """`query` on the word-sparse database; q_word / q_wt from
    `vocabulary.transform_sparse`."""
    return _top3(scores_sparse(db, q_word, q_wt, n_words), db.valid, exclude,
                 min_score)


def min_covisible_score_sparse(db: SparseKeyframeDB, q_word, q_wt, cov_row,
                               n_words: int, cov_threshold: int = 15):
    """`min_covisible_score` on the word-sparse database."""
    return _min_over(scores_sparse(db, q_word, q_wt, n_words), db.valid,
                     cov_row, cov_threshold)
