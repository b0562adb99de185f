"""Loop-closing building blocks: matched pairs between two keyframes,
covisible-group projection verification and the map correction (port of
`MatchedPairs`, `_pairs_from_tables`, `_tables`, `pairs_by_projection`,
`group_projection_score` and `_correct_map` of
`openmavis_tpu/pipeline/loop_closing.py`; reference: src/LoopClosing.cc
:695 DetectCommonRegionsFromBoW, :1108 CorrectLoop).

`streaming_lc.make_lc_step` strings these into the per-frame loop closer.
Every descriptor search here goes through `matcher.match_nn` or
`matcher.match_projection`, i.e. through the hand-written kernels on CUDA
tensors: two whole keyframes against each other ([C F, C F] mask, both
directions), and the landmark slab against each camera band of the
current keyframe.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..frontend import matcher
from ..geometry import cameras, lie
from ..ops import scatter_max, set_rows
from ..slam_map import map_state as ms
from . import tracking as mono


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
    src/LoopClosing.cc:944-994).

    s, R, t: body(slot) -> body(cand) Sim3 (p_cand = s R p_slot + t).
    Returns n_matches ([] int32)."""
    K, CF = m.kf_obs.shape
    F = CF // n_cams
    M = m.mp_pos.shape[0]
    dev = m.kf_obs.device
    # the loop-local landmark set: seen by cand or its strong covisibles
    group_kf = set_rows(cov_row >= cov_threshold, cand, True) & m.kf_valid
    sel = (group_kf[:, None] & (m.kf_obs >= 0)).reshape(-1)
    group = scatter_max(torch.zeros(M, dtype=torch.bool, device=dev),
                        torch.where(sel, m.kf_obs.reshape(-1), 0),
                        sel) & m.mp_valid

    # landmarks -> candidate body frame -> hypothesized slot body frame
    p_bc = _to_body(m.kf_R[cand], m.kf_t[cand], m.mp_pos)
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
                                     m.mp_dmax)
        idx, _ = matcher.match_projection(
            uv, lvl, radius, m.mp_desc, vis,
            m.kf_xy[slot][sl], m.kf_level[slot][sl], m.kf_desc[slot][sl],
            m.kf_feat_valid[slot][sl], max_dist=matcher.TH_LOW)
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
