"""Loop closing: place recognition -> Sim3 verification -> graph correction
(port of `openmavis_tpu/pipeline/loop_closing.py`; reference:
src/LoopClosing.cc :401 NewDetectCommonRegions, :695
DetectCommonRegionsFromBoW, :1108 CorrectLoop).

The building blocks — matched pairs between two keyframes, covisible-group
projection verification and the map correction — serve both closers:
`streaming_lc.make_lc_step` strings them into the per-frame device loop
closer, and `LoopCloser` is the host-policy closer the trackers call on
each new keyframe (`loop_closer=`): retrieval (spatial, the session
vocabulary's word-sparse keyframe database once the map has
`vocab_train_kf` keyframes, dense descriptor scores before), Sim3 RANSAC
and refinement, the covisible-group gate, temporal consistency, the
essential-graph correction (4-DoF for inertial maps, Sim3 otherwise) and
the post-loop whole-map BA. Its accept / reject policy reads device
values on the host, as the reference package's does.

Merge detection (`LoopCloser.detect_merge`, and `streaming_lc`'s device
weld) runs the same pieces across two maps of an `Atlas`:
`cross_place_scores`, `_matched_pairs_cross` and
`group_projection_score_cross`.

Every descriptor search here goes through `matcher.match_nn` or
`matcher.match_projection`, i.e. through the hand-written kernels on CUDA
tensors: two whole keyframes against each other ([C F, C F] mask, both
directions), and the landmark slab against each camera band of the
current keyframe. `cross_place_scores` stays a plain Hamming product,
taken a few keyframes at a time.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..frontend import matcher
from ..frontend.fast import topk_stable
from ..geometry import cameras, lie
from ..ops import scatter_max, set_rows
from ..optim import pose_graph, sim3_refine
from ..slam_map import atlas as atlas_mod
from ..slam_map import keyframe_db as kdb
from ..slam_map import map_state as ms
from ..slam_map import vocabulary as voc
from ..solvers import sim3 as sim3_mod
from . import tracking as mono


@dataclass
class LoopConfig:
    """The host closer's settings (the reference's `LoopConfig`, every
    field and default)."""
    candidate_source: str = "descriptor"  # "descriptor" | "spatial"
    min_desc_matches: int = 60    # direct-descriptor score floor
    spatial_radius: float = 1.0   # candidate gate (estimate units)
    recent_exclude: int = 8       # skip this many latest keyframes
    covis_exclude: int = 15       # shared-point threshold for exclusion
    min_sim3_inliers: int = 20
    covis_edge_threshold: int = 30
    loop_edge_weight: float = 5.0
    # covisible-group projection verification: the hypothesized Sim3 must
    # re-find this many of the candidate's local landmarks in the current
    # keyframe (nProjMatches, src/LoopClosing.cc:944-994)
    min_group_matches: int = 25
    # temporal consistency: this many CONSECUTIVE keyframes must verify
    # the same candidate before the map is corrected
    # (mnLoopNumCoincidences, src/LoopClosing.cc:440-520, 1019)
    temporal_consistency: int = 2
    # train a session vocabulary and switch retrieval to the word-sparse
    # keyframe database once the map has this many keyframes; dense
    # descriptor scoring (O(K^2 F^2)) serves the smaller maps
    vocab_train_kf: int = 40
    vocab_train_samples: int = 20000
    # k = 10, L = 4: 10,000 words (the reference ORBvoc is k = 10, L = 6);
    # the database keeps each keyframe's top-W (word, weight) pairs
    vocab_levels: int = 4
    bow_top_w: int = 512
    # whole-map BA after a correction (CorrectLoop ->
    # RunGlobalBundleAdjustment, src/LoopClosing.cc:1372; FullInertialBA
    # for inertial maps, :2366-2368)
    run_gba: bool = True
    # gravity-direction gate of inertial maps ("BAD LOOP",
    # src/LoopClosing.cc:307-335 gates |phi_xy| < 0.008, |phi_z| < 0.349;
    # tilt_max is wider: this estimator's tilt drifts 0.02-0.06 rad)
    tilt_max: float = 0.08
    yaw_max: float = 0.349


class MatchedPairs(NamedTuple):
    p_a: torch.Tensor        # [F,3] landmark in body frame of KF a
    p_b: torch.Tensor        # [F,3] ... of KF b
    uv_a: torch.Tensor       # [F,2] observed keypoint in KF a
    uv_b: torch.Tensor       # [F,2]
    sigma2_a: torch.Tensor   # [F]
    sigma2_b: torch.Tensor   # [F]
    cam_a: torch.Tensor      # [F] camera band of the observation
    cam_b: torch.Tensor      # [F]
    valid: torch.Tensor      # [F] bool


def _to_body(R, t, p_w):
    """World points [N,3] in the body frame of pose (R, t): R^T (p - t)."""
    return (p_w - t) @ R


def _pairs_from_tables(kfa, kfb, slot_a, slot_b) -> MatchedPairs:
    """Descriptor-NN pairs between keyframe `slot_a` of one map and
    `slot_b` of another (or the same). kfa/kfb: per-map (R, t, xy, desc,
    sigma2, cam, feat_valid, obs, mp_pos, mp_valid) tuples (`_tables`)."""
    (Ra, ta, xya, desca, s2a, cama, fva, obsa, posa, mpva) = kfa
    (Rb, tb, xyb, descb, s2b, camb, fvb, obsb, posb, mpvb) = kfb
    F = xya.shape[1]
    has_a = (obsa[slot_a] >= 0) & fva[slot_a]
    has_b = (obsb[slot_b] >= 0) & fvb[slot_b]
    idx, hd = matcher.match_nn(desca[slot_a], has_a, descb[slot_b], has_b,
                               max_dist=64, ratio=0.9, mutual=True)
    idx = matcher.dedup_targets(idx, hd, F)
    okm = idx >= 0
    safe = torch.where(okm, idx, 0).to(torch.int64)
    mp_a = torch.where(okm, obsa[slot_a], 0).to(torch.int64)
    mp_b = torch.where(okm, obsb[slot_b][safe], 0).to(torch.int64)
    return MatchedPairs(
        p_a=_to_body(Ra[slot_a], ta[slot_a], posa[mp_a]),
        p_b=_to_body(Rb[slot_b], tb[slot_b], posb[mp_b]),
        uv_a=xya[slot_a], uv_b=xyb[slot_b][safe],
        sigma2_a=s2a[slot_a], sigma2_b=s2b[slot_b][safe],
        cam_a=cama[slot_a], cam_b=camb[slot_b][safe],
        valid=okm & mpva[mp_a] & mpvb[mp_b])


def _tables(m: ms.MapState):
    return (m.kf_R, m.kf_t, m.kf_xy, m.kf_desc, m.kf_sigma2, m.kf_cam,
            m.kf_feat_valid, m.kf_obs, m.mp_pos, m.mp_valid)


def _matched_pairs_cross(m_a: ms.MapState, slot_a, m_b: ms.MapState,
                         slot_b) -> MatchedPairs:
    """Descriptor-NN pairs between keyframe `slot_a` of map `m_a` and
    `slot_b` of another map `m_b` (merge candidates in another Atlas map,
    src/LoopClosing.cc:176-204)."""
    return _pairs_from_tables(_tables(m_a), _tables(m_b), slot_a, slot_b)


def cross_place_scores(desc_q, valid_q, m_b: ms.MapState,
                       kf_chunk: int = 8) -> torch.Tensor:
    """Place-recognition scores of a query descriptor bank [N, 256]
    against every keyframe of ANOTHER map: per keyframe, the number of
    valid query rows whose nearest valid feature of that keyframe lies
    under TH_LOW. Returns [K] int32.

    The [N, K F] distance table is built `kf_chunk` keyframes at a time
    (the whole one is 1 GB of int32 at the flagship's 2,048 x 131,072);
    every keyframe's count is the same as from the whole table."""
    K, F = m_b.kf_obs.shape
    t_valid = m_b.kf_feat_valid & m_b.kf_valid[:, None]
    out = []
    for k0 in range(0, K, kf_chunk):
        k1 = min(k0 + kf_chunk, K)
        dist = matcher.hamming_matrix(
            desc_q, m_b.kf_desc[k0:k1].reshape(-1, 256)).reshape(
            -1, k1 - k0, F)
        dist = torch.where(t_valid[None, k0:k1] & valid_q[:, None, None],
                           dist, 1 << 20)
        best = torch.amin(dist, dim=2)
        out.append(torch.sum(best < matcher.TH_LOW, dim=0,
                             dtype=torch.int32))
    return torch.cat(out)


def pairs_by_projection(m: ms.MapState, slot, cand, rig_kind: int,
                        n_cams: int, rig, img_w: float, img_h: float,
                        radius: float = 40.0) -> MatchedPairs:
    """Projection-GUIDED Sim3 pairs: project the candidate keyframe's
    bound landmarks into the current keyframe's cameras from the current
    (drifted) poses and match descriptors within `radius` px (the
    reference's SearchByProjection companion, src/LoopClosing.cc:888).
    At loop time the relative drift is small against a 40 px gate, so
    this recovers dense true pairs where raw NN across two keyframes
    suffers from perceptual aliasing; the RANSAC still validates the
    geometry. Returns MatchedPairs padded to [C*F], keyed by current-KF
    feature."""
    CF = m.kf_obs.shape[1]
    F = CF // n_cams
    M = m.mp_pos.shape[0]
    dev = m.kf_obs.device
    # candidate's bound-landmark set
    obs_c = m.kf_obs[cand]
    has_c = (obs_c >= 0) & m.kf_feat_valid[cand]
    lm_c = torch.where(has_c, obs_c, 0)
    sel_b = scatter_max(torch.zeros(M, dtype=torch.bool, device=dev),
                        lm_c, has_c) & m.mp_valid

    idx_all, dist_all = [], []
    for c in range(n_cams):
        uv_proj, lvl, vis_c, _ = mono.project_landmarks(
            m, m.kf_R[slot], m.kf_t[slot], rig_kind, rig.params[c],
            rig.R_cb[c], rig.t_cb[c], img_w, img_h)
        sl = slice(c * F, (c + 1) * F)
        feat_ok = m.kf_feat_valid[slot][sl] & (m.kf_obs[slot][sl] >= 0)
        idx_c, dist_c = matcher.match_projection(
            uv_proj, lvl, radius, m.mp_desc, vis_c & sel_b,
            m.kf_xy[slot][sl], m.kf_level[slot][sl], m.kf_desc[slot][sl],
            feat_ok, max_dist=matcher.TH_LOW, ratio=0.9)
        idx_c = matcher.dedup_targets(idx_c, dist_c, F)
        idx_all.append(torch.where(idx_c >= 0, idx_c + c * F, -1))
        dist_all.append(dist_c)

    idx_sc = torch.stack(idx_all, dim=1)          # [M, C]
    dist_sc = torch.stack(dist_all, dim=1)
    best_c = torch.argmin(torch.where(idx_sc >= 0, dist_sc, 1 << 20),
                          dim=1)
    feat = torch.gather(idx_sc, 1, best_c[:, None])[:, 0]
    matched = feat >= 0                           # [M] landmark -> feat

    # scatter to per-feature rows: feature f pairs with landmark b
    ids = torch.arange(M, dtype=torch.int32, device=dev)
    lm_of_feat = scatter_max(
        torch.full((CF,), -1, dtype=torch.int32, device=dev),
        torch.where(matched, feat, CF - 1), torch.where(matched, ids, -1))
    okf = lm_of_feat >= 0
    obs_s = m.kf_obs[slot]
    mp_b = torch.where(okf, lm_of_feat, 0).to(torch.int64)
    mp_a = torch.where(okf, obs_s, 0).to(torch.int64)
    valid = okf & (obs_s >= 0) & m.mp_valid[mp_a] & m.mp_valid[mp_b]
    # image observation of the landmark in the CANDIDATE keyframe: the
    # feature of cand bound to mp_b
    feats = torch.arange(CF, dtype=torch.int32, device=dev)
    feat_of_lm = scatter_max(
        torch.full((M,), -1, dtype=torch.int32, device=dev),
        lm_c, torch.where(has_c, feats, -1))
    fb = feat_of_lm[mp_b]
    valid = valid & (fb >= 0)
    fb = torch.clamp(fb, min=0).to(torch.int64)
    return MatchedPairs(
        p_a=_to_body(m.kf_R[slot], m.kf_t[slot], m.mp_pos[mp_a]),
        p_b=_to_body(m.kf_R[cand], m.kf_t[cand], m.mp_pos[mp_b]),
        uv_a=m.kf_xy[slot], uv_b=m.kf_xy[cand][fb],
        sigma2_a=m.kf_sigma2[slot], sigma2_b=m.kf_sigma2[cand][fb],
        cam_a=m.kf_cam[slot], cam_b=m.kf_cam[cand][fb],
        valid=valid)


def group_projection_score(m: ms.MapState, slot, cand, cov_row, s, R, t,
                           rig_kind: int, n_cams: int, rig, img_w: float,
                           img_h: float, radius: float = 8.0,
                           cov_threshold: int = 15) -> torch.Tensor:
    """Count matches when projecting the candidate's covisible-group
    landmarks into the current keyframe through the hypothesized Sim3
    (the projection-verification step of DetectCommonRegionsFromBoW,
    src/LoopClosing.cc:944-994): `group_projection_score_cross` with both
    keyframes in map `m`.

    s, R, t: body(slot) -> body(cand) Sim3 (p_cand = s R p_slot + t).
    Returns n_matches ([] int32)."""
    return group_projection_score_cross(m, slot, m, cand, cov_row, s, R, t,
                                        rig_kind, n_cams, rig, img_w,
                                        img_h, radius, cov_threshold)


def group_projection_score_cross(m_cur: ms.MapState, slot,
                                 m_cand: ms.MapState, cand, cov_row, s, R,
                                 t, rig_kind: int, n_cams: int, rig,
                                 img_w: float, img_h: float,
                                 radius: float = 8.0,
                                 cov_threshold: int = 15) -> torch.Tensor:
    """Cross-MAP form of `group_projection_score`: the candidate keyframe
    and its covisible-group landmarks live in `m_cand` (another Atlas
    map), the current keyframe's features in `m_cur` (the same
    nProjMatches verification run on merge candidates,
    src/LoopClosing.cc:695-994).

    s, R, t: body(slot in m_cur) -> body(cand in m_cand) Sim3.
    Returns n_matches ([] int32)."""
    CF = m_cand.kf_obs.shape[1]
    F = CF // n_cams
    M2 = m_cand.mp_pos.shape[0]
    dev = m_cand.kf_obs.device
    group_kf = (set_rows(cov_row >= cov_threshold, cand, True)
                & m_cand.kf_valid)
    sel = (group_kf[:, None] & (m_cand.kf_obs >= 0)).reshape(-1)
    group = scatter_max(torch.zeros(M2, dtype=torch.bool, device=dev),
                        torch.where(sel, m_cand.kf_obs.reshape(-1), 0),
                        sel) & m_cand.mp_valid

    p_bc = _to_body(m_cand.kf_R[cand], m_cand.kf_t[cand], m_cand.mp_pos)
    p_bs = ((p_bc - t) @ R) / s

    n = torch.zeros((), dtype=torch.int32, device=dev)
    for c in range(n_cams):
        p_c = p_bs @ rig.R_cb[c].T + rig.t_cb[c]
        uv = cameras.project(rig_kind, rig.params[c], p_c)
        vis = (group & (p_c[:, 2] > 0.1)
               & (uv[:, 0] >= 0) & (uv[:, 0] < img_w)
               & (uv[:, 1] >= 0) & (uv[:, 1] < img_h))
        sl = slice(c * F, (c + 1) * F)
        lvl = ms.predict_scale_level(torch.linalg.norm(p_c, dim=-1),
                                     m_cand.mp_dmax)
        idx, _ = matcher.match_projection(
            uv, lvl, radius, m_cand.mp_desc, vis,
            m_cur.kf_xy[slot][sl], m_cur.kf_level[slot][sl],
            m_cur.kf_desc[slot][sl], m_cur.kf_feat_valid[slot][sl],
            max_dist=matcher.TH_LOW)
        n = n + torch.sum(idx >= 0, dtype=torch.int32)
    return n


def _correct_map(m: ms.MapState, s_new, R_new, t_new) -> ms.MapState:
    """Apply optimized world->keyframe Sim3s back to the map. Keyframe
    poses absorb the scale; each landmark is corrected through its
    reference keyframe's old->new Sim3 (reference: CorrectLoop's
    CorrectedSim3 propagation, LoopClosing.cc:2410-2470)."""
    K = m.kf_R.shape[0]
    # new keyframe poses: world-from-kf of (s, R, t): x_kf = s R x_w + t
    R_wk = R_new.transpose(-1, -2)
    t_wk = -lie._mv(R_wk, t_new) / s_new[:, None]

    # landmark correction via reference KF r: p' = S_new_r^{-1}(S_old_r(p))
    r_kf = torch.clamp(m.mp_first_kf, 0, K - 1).to(torch.int64)
    p_kf = lie._mv(m.kf_R[r_kf].transpose(-1, -2), m.mp_pos - m.kf_t[r_kf])
    si, Ri, ti = lie.sim3_inverse(s_new[r_kf], R_new[r_kf], t_new[r_kf])
    p_new = lie.sim3_apply(si, Ri, ti, p_kf)
    return m._replace(
        kf_R=lie.normalize_rotation(R_wk), kf_t=t_wk,
        mp_pos=torch.where(m.mp_valid[:, None], p_new, m.mp_pos))


def _cat_edges(a, b):
    """Two edge sets of one type as one (`PoseGraphEdges` or its SE3
    form)."""
    return type(a)(*(torch.cat([x, y]) for x, y in zip(a, b)))


class LoopCloser:
    """The host-policy loop closer (the reference's LoopClosing thread as
    a call after keyframe insertion; reference: src/LoopClosing.cc:98
    Run). A tracker given `loop_closer=` calls `on_keyframe` on each new
    keyframe (the streaming trackers from `maybe_close_loop`).

    Usage (as the flagship example builds it):
        lc = LoopCloser(None, cfg.max_kf, rig=rig, inertial=True,
                        img_w=W, img_h=H)        # on the current GPU
        tr = StreamingVITracker(rig, cfg, noise, loop_closer=lc)
        for ...: tr.push(...); tr.maybe_close_loop()

    The map is on `device` (the current CUDA device when None); the rig
    is moved there. The accept / reject policy runs on the host and reads
    device values where the reference does: the matched-pair count, the
    RANSAC's and the refinement's verdicts, the gravity gate's angles,
    the group score, the candidate list.

    Randomness: a `torch.Generator` seeded from `seed` draws the RANSAC
    samples (the reference splits a JAX key for each RANSAC call).
    `samples`, an optional iterable of [128, 3] sample-index tensors, one
    per RANSAC call in call order, replaces those draws while it lasts,
    so a test can hand the port the reference's draws (`self.samples`, a
    deque, can be refilled between calls)."""

    def __init__(self, vocab: voc.Vocabulary | None, max_kf: int,
                 cfg: LoopConfig = LoopConfig(), seed: int = 100,
                 rig=None, inertial: bool = False, img_w: float = 640.0,
                 img_h: float = 480.0, device=None, samples=()):
        self.device = resolve_device(device)
        self.vocab = vocab            # None: trained from the session
        self.cfg = cfg
        self.max_kf = max_kf
        self.db = (kdb.allocate_sparse(max_kf, cfg.bow_top_w,
                                       device=self.device)
                   if vocab is not None else None)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.samples = collections.deque(samples)
        self.n_loops = 0
        self.n_merges = 0
        # the world Sim3 (s, R, t) of the last weld, as host values: the
        # tracker scales its trajectory entries of the welded map by s
        self.last_weld = None
        # the rig enables reprojection verification (the OptimizeSim3
        # analog); inertial switches the correction to the 4-DoF graph
        # and fixes the scale (bFixScale, src/LoopClosing.cc:1329)
        self.rig = None if rig is None else rig.to(self.device)
        self.inertial = inertial
        self.img_w = float(img_w)
        self.img_h = float(img_h)
        # temporal-consistency hypothesis: {cand, slot, s, R, t, count}
        # (mnLoopNumCoincidences and the Scw carried between keyframes,
        # src/LoopClosing.cc:440-520)
        self.pending: dict | None = None
        self._chain = (None, None)

    def _ransac_samples(self):
        return self.samples.popleft() if self.samples else None

    def _verify_sim3(self, pairs: MatchedPairs, res):
        """Projection refinement of a RANSAC Sim3 (SearchByProjection +
        OptimizeSim3, src/LoopClosing.cc:888-994). Returns the refined
        result, or None when the rig is unknown (the RANSAC inliers then
        stand alone)."""
        if self.rig is None:
            return None
        rig = self.rig
        C = rig.params.shape[0]
        cam_a = torch.clamp(pairs.cam_a, 0, C - 1).to(torch.int64)
        cam_b = torch.clamp(pairs.cam_b, 0, C - 1).to(torch.int64)
        return sim3_refine.refine_sim3(
            res.s, res.R, res.t, pairs.p_a, pairs.p_b, pairs.uv_a,
            pairs.uv_b, pairs.sigma2_a, pairs.sigma2_b,
            pairs.valid & res.inlier, rig.kind, rig.params[cam_a],
            rig.params[cam_b], rig.R_cb[cam_a], rig.t_cb[cam_a],
            rig.R_cb[cam_b], rig.t_cb[cam_b], fix_scale=self.inertial)

    # -- retrieval ---------------------------------------------------------
    def _maybe_train_vocab(self, m: ms.MapState):
        """Train a session vocabulary from the map's own descriptors and
        backfill the keyframe database once the map outgrows dense scoring
        (the reference system's pre-trained ORBvoc + KeyFrameDatabase,
        src/KeyFrameDatabase.cc:581)."""
        cfg = self.cfg
        if self.vocab is not None or int(m.n_kf) < cfg.vocab_train_kf:
            return
        flat = m.kf_desc[m.kf_valid][m.kf_feat_valid[m.kf_valid]]
        flat = flat.cpu().numpy()
        if len(flat) < 1000:
            return
        rng = np.random.default_rng(0)
        take = min(cfg.vocab_train_samples, len(flat))
        flat = flat[rng.permutation(len(flat))[:take]]
        self.vocab = voc.train(flat, k=10, levels=cfg.vocab_levels,
                               device=self.device)
        # backfill the word-sparse database for every existing keyframe,
        # one keyframe at a time (the tree descent of a whole slab at once
        # would hold [K F, k, 256] differences)
        db = kdb.allocate_sparse(self.max_kf, cfg.bow_top_w,
                                 device=self.device)
        slots = torch.nonzero(m.kf_valid).flatten()
        words, wts = voc.transform_sparse(
            self.vocab, m.kf_desc[slots], m.kf_feat_valid[slots],
            cfg.bow_top_w)
        self.db = kdb.SparseKeyframeDB(
            word=db.word.index_copy(0, slots, words),
            wt=db.wt.index_copy(0, slots, wts), valid=m.kf_valid.clone())

    def _candidates(self, m: ms.MapState, slot: int, cov) -> list:
        """Top loop candidates: the spatial gate, the word-sparse
        database's scores once the session vocabulary exists, dense
        descriptor scores before."""
        cfg = self.cfg
        K = m.kf_valid.shape[0]
        recent = torch.arange(K, device=cov.device) > slot - cfg.recent_exclude
        exclude = (cov[slot] >= cfg.covis_exclude) | recent | ~m.kf_valid

        if cfg.candidate_source == "spatial":
            d = torch.linalg.norm(m.kf_t - m.kf_t[slot], dim=-1)
            scores = torch.where(exclude | (d > cfg.spatial_radius),
                                 -torch.inf, -d)
            top = topk_stable(scores, 3)[1]
            ok = torch.isfinite(scores[top])
        elif self.vocab is not None:
            q_word, q_wt = voc.transform_sparse(
                self.vocab, m.kf_desc[slot], m.kf_feat_valid[slot],
                cfg.bow_top_w)
            self.db = kdb.add_sparse(self.db, slot, q_word, q_wt)
            nw = self.vocab.n_words
            min_score = kdb.min_covisible_score_sparse(
                self.db, q_word, q_wt, cov[slot], nw,
                cov_threshold=cfg.covis_exclude)
            _, top, ok = kdb.query_sparse(self.db, q_word, q_wt, exclude,
                                          min_score, nw)
        else:
            scores = mono.descriptor_place_scores(m, slot)
            scores = torch.where(exclude, -1, scores)
            top = topk_stable(scores, 3)[1]
            ok = scores[top] >= cfg.min_desc_matches
        top, ok = torch.stack([top, ok.to(top.dtype)]).tolist()
        return [int(c) for c, o in zip(top, ok) if o]

    def _group_score(self, m, slot: int, cand: int, cov, s, R, t) -> int:
        if self.rig is None:
            return 1 << 20   # no rig: the gate degrades to a no-op
        return int(group_projection_score(
            m, slot, cand, cov[cand], s, R, t, self.rig.kind,
            int(self.rig.params.shape[0]), self.rig, self.img_w,
            self.img_h))

    def _solve_pair(self, m, slot: int, cand: int):
        """Matched pairs -> RANSAC Sim3 -> projection refinement -> (on
        inertial maps) the gravity gate. Returns the result or None."""
        cfg = self.cfg
        tables = _tables(m)
        pairs = _pairs_from_tables(tables, tables, slot, cand)
        if int(pairs.valid.sum()) < cfg.min_sim3_inliers:
            return None
        if self.rig is not None:
            # reprojection-gated (Sim3Solver::CheckInliers semantics)
            res = sim3_mod.ransac_sim3_reproj(
                self.gen, pairs, self.rig.kind, self.rig,
                fix_scale=self.inertial, min_inliers=cfg.min_sim3_inliers,
                sample_idx=self._ransac_samples())
        else:
            res = sim3_mod.ransac_sim3(
                self.gen, pairs.p_a, pairs.p_b, pairs.valid,
                fix_scale=self.inertial, min_inliers=cfg.min_sim3_inliers,
                sample_idx=self._ransac_samples())
        if not bool(res.success):
            return None
        ref = self._verify_sim3(pairs, res)
        if ref is not None:
            if int(ref.n_inliers) < cfg.min_sim3_inliers:
                return None
            res = res._replace(s=ref.s, R=ref.R, t=ref.t, inlier=ref.inlier,
                               n_inliers=ref.n_inliers)
        if self.inertial:
            # gravity-direction gate ("BAD LOOP", src/LoopClosing.cc:
            # 307-335): refuse a world correction that tilts roll / pitch
            # or jumps in yaw
            R_corr = (m.kf_R[cand] @ res.R) @ m.kf_R[slot].T
            phi = torch.abs(lie.so3_log(R_corr)).tolist()
            if not (phi[0] < cfg.tilt_max and phi[1] < cfg.tilt_max
                    and phi[2] < cfg.yaw_max):
                return None
        return res

    def on_keyframe(self, m: ms.MapState, slot: int, chain=None,
                    chain_valid=None):
        """Detect, temporally confirm and (once verified) correct a loop
        at keyframe `slot`. Returns (m, closed).

        Acceptance chain (src/LoopClosing.cc:401-1019): (1) retrieval;
        (2) Sim3 RANSAC on matched landmark pairs and projection
        refinement; (3) covisible-group projection verification; (4)
        temporal consistency: `temporal_consistency` consecutive keyframes
        must re-verify the hypothesis before the map is corrected. After a
        correction `cfg.run_gba` runs the whole-map BA, FullInertialBA when
        `chain` / `chain_valid` (the per-keyframe preintegration chain,
        entry k the interval k-1 -> k) are given."""
        cfg = self.cfg
        self._maybe_train_vocab(m)
        self._chain = (chain, chain_valid)
        cov = ms.covisibility_matrix(m)

        # step 4 first: re-verify a pending hypothesis from this keyframe
        if self.pending is not None:
            p = self.pending
            if slot <= p["slot"]:
                self.pending = None
            else:
                # compose: S'(new -> cand) = S(old -> cand) o T(old <- new)
                R_o, t_o = m.kf_R[p["slot"]], m.kf_t[p["slot"]]
                R_n, t_n = m.kf_R[slot], m.kf_t[slot]
                R2 = p["R"] @ R_o.T @ R_n
                t2 = p["s"] * (p["R"] @ (R_o.T @ (t_n - t_o))) + p["t"]
                score = self._group_score(m, slot, p["cand"], cov, p["s"],
                                          R2, t2)
                if score < cfg.min_group_matches:
                    self.pending = None
                else:
                    p.update(slot=slot, R=R2, t=t2, count=p["count"] + 1)
                    if p["count"] < cfg.temporal_consistency:
                        return m, False
                    res = self._solve_pair(m, slot, p["cand"])
                    self.pending = None
                    if res is not None:
                        m = self._correct(m, slot, p["cand"], res, cov)
                        self.n_loops += 1
                        return m, True

        # steps 1-3: fresh detection
        for cand in self._candidates(m, slot, cov):
            res = self._solve_pair(m, slot, cand)
            if res is None:
                continue
            score = self._group_score(m, slot, cand, cov, res.s, res.R,
                                      res.t)
            if score < cfg.min_group_matches:
                continue
            if cfg.temporal_consistency <= 1:
                m = self._correct(m, slot, cand, res, cov)
                self.n_loops += 1
                return m, True
            self.pending = dict(cand=cand, slot=slot, s=res.s, R=res.R,
                                t=res.t, count=1)
            return m, False
        return m, False

    def _correct(self, m: ms.MapState, slot: int, cand: int, res, cov):
        """Essential-graph correction with the verified loop constraint
        (OptimizeEssentialGraph, src/Optimizer.cc:1826; 4-DoF for inertial
        maps, src/LoopClosing.cc:1329), then the post-loop BA."""
        cfg = self.cfg
        K = m.kf_R.shape[0]
        n_kf = int(m.n_kf)
        dev = m.kf_R.device

        def ones(n, dtype=torch.float32):
            return torch.ones(n, dtype=dtype, device=dev)

        # nodes: the current poses as world -> keyframe Sim3 (scale 1)
        R_cw = m.kf_R.transpose(-1, -2)
        t_cw = -lie._mv(R_cw, m.kf_t)
        s0 = ones(K, t_cw.dtype)
        edges = pose_graph.sequential_edges(s0, R_cw, t_cw, n_kf, K)

        def measured(i, j, weight, valid):
            """Edges i -> j measured from the current poses."""
            se, Re, te = lie.sim3_compose(
                s0[j], R_cw[j], t_cw[j],
                *lie.sim3_inverse(s0[i], R_cw[i], t_cw[i]))
            return pose_graph.PoseGraphEdges(
                i=i, j=j, s=se, R=Re, t=te,
                weight=torch.full(i.shape, weight, dtype=t_cw.dtype,
                                  device=dev), valid=valid)

        # covisibility edges (the essential graph's strong-covisibility
        # edges), capped at the 128 of highest weight, equal weights in
        # index order
        cov_np = cov.cpu().numpy()
        ii, jj = np.nonzero(np.triu(cov_np, 2) >= cfg.covis_edge_threshold)
        keep = (ii < n_kf) & (jj < n_kf)
        ii, jj = ii[keep], jj[keep]
        if len(ii) > 128:
            order = np.argsort(-cov_np[ii, jj], kind="stable")[:128]
            dropped = len(ii) - 128
            ii, jj = ii[order], jj[order]
            print(f"[loop_closing] covisibility edge cap: kept top 128 "
                  f"of {len(order) + dropped} by weight "
                  f"({dropped} dropped)")
        if len(ii) > 0:
            i_t = torch.as_tensor(ii, dtype=torch.int64, device=dev)
            j_t = torch.as_tensor(jj, dtype=torch.int64, device=dev)
            edges = _cat_edges(edges, measured(
                i_t, j_t, 1.0, ones(len(ii), torch.bool)))

        # the loop edge: res maps body(slot) -> body(cand), so the edge
        # cand -> slot measures S_slot S_cand^-1 = S_res^-1
        si_r, Ri_r, ti_r = lie.sim3_inverse(res.s, res.R, res.t)
        edges = _cat_edges(edges, pose_graph.PoseGraphEdges(
            i=torch.tensor([cand], device=dev),
            j=torch.tensor([slot], device=dev),
            s=si_r[None], R=Ri_r[None], t=ti_r[None],
            weight=torch.full((1,), cfg.loop_edge_weight, dtype=t_cw.dtype,
                              device=dev),
            valid=ones(1, torch.bool)))
        # persistent edges of earlier loops, re-measured from the current
        # poses (mspLoopEdges in every OptimizeEssentialGraph solve)
        li = torch.clamp(m.loop_i, 0, K - 1).to(torch.int64)
        lj = torch.clamp(m.loop_j, 0, K - 1).to(torch.int64)
        lv = (m.loop_valid & (m.loop_i >= 0) & (m.loop_j >= 0)
              & m.kf_valid[li] & m.kf_valid[lj])
        if bool(lv.any()):
            edges = _cat_edges(edges, measured(li, lj, cfg.loop_edge_weight,
                                               lv))
        m = ms.add_loop_edge(m, cand, slot)

        fixed = set_rows(torch.zeros(K, dtype=torch.bool, device=dev), cand,
                         True)
        if self.inertial:
            # gravity is observable: correct yaw and translation only
            edges3 = pose_graph.PoseGraphEdgesSE3(
                i=edges.i, j=edges.j, R=edges.R, t=edges.t,
                weight=edges.weight, valid=edges.valid)
            R_o, t_o, _ = pose_graph.optimize_pose_graph_4dof(
                R_cw, t_cw, edges3, fixed, m.kf_valid)
            s_o = s0
        else:
            s_o, R_o, t_o, _ = pose_graph.optimize_pose_graph(
                s0, R_cw, t_cw, edges, fixed, m.kf_valid)
        m = _correct_map(m, s_o, R_o, t_o)
        return self._post_loop_gba(m)

    def _post_loop_gba(self, m: ms.MapState):
        """Whole-map BA after a correction (RunGlobalBundleAdjustment,
        src/LoopClosing.cc:1372, 2351-2470; FullInertialBA for inertial
        maps, :2366-2368). The solve covers every keyframe and landmark
        of the slab, so no spanning-tree propagation is left to do."""
        if not self.cfg.run_gba or self.rig is None:
            return m
        chain, chain_valid = self._chain
        if chain is not None and chain_valid is not None:
            m, _ = mono.global_inertial_ba_step(
                m, chain.map(lambda x: x[1:]), chain_valid[1:],
                self.rig.kind, self.rig)
        else:
            m, _ = mono.global_ba_step(m, self.rig.kind, self.rig)
        return m

    # -- Atlas merge detection (the merge path of LoopClosing,
    # src/LoopClosing.cc:176-204 scale sanity, MergeLocal / MergeLocal2) --
    def detect_merge(self, atlas, slot: int):
        """Try to weld the CURRENT atlas map into an older map through a
        verified cross-map Sim3.

        On success the merged map replaces the older map, the current map
        leaves the atlas, `last_weld` holds the world Sim3 (s, R, t) that
        moved the current map, and (map_index, kf_offset, mp_offset) is
        returned so that the caller can remap its bookkeeping (the
        reference migrates pointers in MergeLocal; slabs shift indices
        instead). Returns None when no merge happened."""
        cfg = self.cfg
        cur_id = atlas.current
        m_cur = atlas.maps[cur_id]
        q_desc = m_cur.kf_desc[slot]
        q_valid = m_cur.kf_feat_valid[slot]
        for other_id in range(len(atlas.maps)):
            if other_id == cur_id:
                continue
            m_old = atlas.maps[other_id]
            if int(m_old.n_kf) < 2:
                continue
            scores = cross_place_scores(q_desc, q_valid, m_old)
            top = topk_stable(scores, 2)[1]
            top, ok = torch.stack(
                [top, (scores[top] >= cfg.min_desc_matches).to(top.dtype)]
            ).tolist()
            for cand in [c for c, o in zip(top, ok) if o]:
                hit = self._try_weld(atlas, cur_id, other_id, slot, cand)
                if hit is not None:
                    return hit
        return None

    def _try_weld(self, atlas, cur_id: int, other_id: int, slot: int,
                  cand: int):
        """One merge candidate: cross pairs -> RANSAC -> refinement ->
        the inertial scale gate -> the weld, its merge edge and the
        welding BA. Returns detect_merge's hit or None."""
        cfg = self.cfg
        m_cur, m_old = atlas.maps[cur_id], atlas.maps[other_id]
        pairs = _matched_pairs_cross(m_cur, slot, m_old, cand)
        if int(pairs.valid.sum()) < cfg.min_sim3_inliers:
            return None
        if self.rig is not None:
            res = sim3_mod.ransac_sim3_reproj(
                self.gen, pairs, self.rig.kind, self.rig,
                fix_scale=self.inertial, min_inliers=cfg.min_sim3_inliers,
                sample_idx=self._ransac_samples())
        else:
            res = sim3_mod.ransac_sim3(
                self.gen, pairs.p_a, pairs.p_b, pairs.valid,
                fix_scale=self.inertial, min_inliers=cfg.min_sim3_inliers,
                sample_idx=self._ransac_samples())
        if not bool(res.success):
            return None
        ref = self._verify_sim3(pairs, res)
        if ref is not None:
            if int(ref.n_inliers) < cfg.min_sim3_inliers:
                return None
            res = res._replace(s=ref.s, R=ref.R, t=ref.t)
        # scale sanity of inertial merges (the 0.9-1.1 gate,
        # src/LoopClosing.cc:176-204)
        if self.inertial and not 0.9 < float(res.s) < 1.1:
            return None
        # world Sim3 current-map world -> old-map world:
        # S_w = T_wb(cand) o S_ba o T_bw(slot)
        one = torch.ones((), device=res.s.device)
        s1, R1, t1 = lie.sim3_compose(one, m_old.kf_R[cand],
                                      m_old.kf_t[cand], res.s, res.R, res.t)
        s_w, R_w, t_w = lie.sim3_compose(
            s1, R1, t1, *lie.sim3_inverse(one, m_cur.kf_R[slot],
                                          m_cur.kf_t[slot]))
        kf_off, mp_off = torch.stack([m_old.n_kf, m_old.n_mp]).tolist()
        merged, ok_m = atlas_mod.merge_maps(m_old, m_cur, s_w, R_w, t_w)
        if not ok_m:
            return None
        # the weld as a permanent merge edge (mspMergeEdges,
        # KeyFrame.h:216-243)
        merged = ms.add_loop_edge(merged, cand, slot + kf_off)
        # welding BA over the seam: the welded-in keyframes move, the
        # older map anchors the gauge (the welding LocalBundleAdjustment
        # after MergeLocal's Sim3 transform, src/Optimizer.cc:3927; the
        # inertial MergeInertialBA analog, src/Optimizer.cc:4365, runs in
        # MultiTracker._remap_after_merge once the chains are welded)
        if self.rig is not None:
            K = merged.kf_R.shape[0]
            free = (torch.arange(K, device=merged.kf_valid.device)
                    >= kf_off) & merged.kf_valid
            merged, _ = mono.welding_ba_step(merged, free, self.rig.kind,
                                             self.rig)
        atlas.maps[other_id] = merged
        atlas.maps.pop(cur_id)
        atlas.current = other_id if other_id < cur_id else other_id - 1
        self.n_merges += 1
        self.last_weld = (float(s_w), R_w.cpu().numpy(), t_w.cpu().numpy())
        return atlas.current, kf_off, mp_off
