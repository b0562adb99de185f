"""Tracking: the one-camera tracker and the map-side steps the trackers
share (port of `openmavis_tpu/pipeline/tracking.py`; reference:
src/Tracking.cc, src/LocalMapping.cc, src/LoopClosing.cc:2351).

* the per-frame steps: `project_landmarks`, `track_step` (projection
  search against the whole map, pose optimization) and `frame_step`
  (extraction, optional radtan undistortion and `track_step` as one call);
* the mapper steps: `spawn_landmarks` / `_spawn_pair` (triangulation
  against the four most recent keyframes), `bind_landmarks`,
  `fuse_new_landmarks`, `cull_landmarks`, `cull_keyframes`,
  `local_ba_step`; relocalization (`relocalize_step`,
  `descriptor_place_scores`); the whole-map BA steps
  (`full_map_observations`, `_writeback_gba`, `global_ba_step`,
  `global_inertial_ba_step`, `welding_ba_step`), `recycle_map_slots`
  and the trajectory list's replay across an Atlas's maps
  (`replay_trajectory`, `remap_after_weld`);
* the host-policy one-camera tracker `Tracker` with `TrackerConfig`, which
  `System` builds for MONOCULAR and RGBD (reference: Tracking::Track,
  src/Tracking.cc:1781-2230).

Keyframe slots are Python ints here; the reference package keeps them as
traced scalars.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..frontend import depth as depth_mod
from ..frontend import extractor, matcher
from ..geometry import cameras, triangulation
from ..imu import preintegration as pre_mod
from ..optim import ba, global_ba, pose_opt
from ..optim.reprojection import RigParams
from ..parallel import dist_ba
from ..ops import compact_indices, last_occurrence, scatter_max, set_rows
from ..slam_map import map_state as ms
from ..solvers import pnp as pnp_mod
from ..solvers import two_view


def project_landmarks(m: ms.MapState, R, t, rig_kind: int, rig_params,
                      R_cb, t_cb, img_w: float, img_h: float):
    """Project all landmarks into one camera with frustum, distance and
    viewing-angle gates (reference: Frame::isInFrustumChecks,
    src/Frame.cc:1529-1653).
    Returns (uv [M,2], pred_level [M], vis [M] bool, dist [M])."""
    p_b = (m.mp_pos - t) @ R
    p_c = p_b @ R_cb.T + t_cb
    uv = cameras.project(rig_kind, rig_params, p_c)
    depth_ok = p_c[:, 2] > 0.1
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < img_w)
              & (uv[:, 1] >= 0) & (uv[:, 1] < img_h))
    cam_center = t + R @ (-(R_cb.T @ t_cb))
    dvec = m.mp_pos - cam_center
    dist = torch.linalg.norm(dvec, dim=-1)
    dist_ok = (dist > 0.8 * m.mp_dmin) & (dist < 1.2 * m.mp_dmax)
    vdir = dvec / torch.clamp(dist[:, None], min=1e-9)
    angle_ok = torch.sum(vdir * m.mp_normal, dim=-1) > 0.5
    vis = m.mp_valid & depth_ok & in_img & dist_ok & angle_ok
    lvl = ms.predict_scale_level(dist, m.mp_dmax)
    return uv, lvl, vis, dist


def frame_step(m: ms.MapState, img, R_pred, t_pred, rig_kind: int,
               rig: RigParams, orb_cfg, img_w: float, img_h: float, radius,
               min_last_kf: int = -1, dist=None):
    """The fused per-frame step: ORB extraction (with radtan `dist` [4],
    undistortion) and `track_step` as one call.
    Returns track_step's outputs + (feats,)."""
    feats = extractor.extract(img, orb_cfg)
    if dist is not None:
        feats = extractor.undistort_features(feats, rig.params[0], dist)
    return track_step(m, feats, R_pred, t_pred, rig_kind, rig, img_w, img_h,
                      radius, min_last_kf) + (feats,)


def track_step(m: ms.MapState, feats: extractor.Features, R_pred, t_pred,
               rig_kind: int, rig: RigParams, img_w: float, img_h: float,
               radius, min_last_kf: int = -1):
    """Project-match-optimize against the whole map from a predicted pose:
    TrackWithMotionModel's projection search and PoseOptimization with
    TrackLocalMap's second pass (reference: Tracking.cc:2799-3001).
    `min_last_kf` >= 0 keeps only landmarks seen since that keyframe.
    Returns (R, t, feat_mp [F] landmark per feature or -1, n_inliers,
    vis [M], keep [M])."""
    uv_proj, lvl, vis, _ = project_landmarks(
        m, R_pred, t_pred, rig_kind, rig.params[0], rig.R_cb[0],
        rig.t_cb[0], img_w, img_h)
    vis = vis & (m.mp_last_kf >= min_last_kf)
    idx, hdist = matcher.match_projection(
        uv_proj, lvl, radius, m.mp_desc, vis, feats.xy, feats.level,
        feats.desc, feats.valid, max_dist=matcher.TH_HIGH, ratio=0.9)
    F = feats.xy.shape[0]
    M = idx.shape[0]
    idx = matcher.dedup_targets(idx, hdist, F)     # one landmark a feature
    matched = idx >= 0
    safe = torch.where(matched, idx, 0).to(torch.int64)
    R, t, inlier, n_in = pose_opt.pose_optimization(
        R_pred, t_pred, m.mp_pos, torch.zeros_like(idx), feats.xy[safe],
        feats.sigma2[safe], matched & m.mp_valid, rig)
    keep = matched & inlier
    return R, t, _feat_mp_from(idx, keep, F, M), n_in, vis, keep


def _feat_mp_from(idx, keep, F: int, M: int):
    """Per-feature landmark id of the kept matches, -1 elsewhere (a
    feature two landmarks claim keeps the larger id)."""
    dev = idx.device
    return scatter_max(
        torch.full((F,), -1, dtype=torch.int32, device=dev),
        torch.where(keep, idx, F - 1),
        torch.where(keep, torch.arange(M, dtype=torch.int32, device=dev),
                    -1))


def _cam0_pose(m: ms.MapState, slot: int, rig: RigParams):
    """World-from-camera-0 pose of keyframe `slot`."""
    R_cb, t_cb = rig.R_cb[0], rig.t_cb[0]
    return (m.kf_R[slot] @ R_cb.T,
            m.kf_t[slot] + m.kf_R[slot] @ (-R_cb.T @ t_cb))


def _spawn_pair(m: ms.MapState, slot_new: int, slot_ref: int, rig_kind: int,
                rig: RigParams, cap_new: int,
                min_parallax: float = 0.99995):
    """Triangulate new landmarks between keyframe `slot_new` and one
    reference keyframe. A negative reference (early in a map) is read as
    slot 0 and masked out by `ref_ok`: it matches nothing, and its row of
    `kf_obs` is rewritten unchanged, as in the reference package.
    Returns (m', n_new)."""
    F = m.kf_xy.shape[1]
    ref_ok = m.kf_valid[max(slot_ref, 0)] & (slot_ref >= 0) \
        & (slot_ref != slot_new)
    slot_ref = max(slot_ref, 0)
    d1 = m.kf_desc[slot_new]
    un1 = (m.kf_obs[slot_new] < 0) & m.kf_feat_valid[slot_new]
    un2 = (m.kf_obs[slot_ref] < 0) & m.kf_feat_valid[slot_ref] & ref_ok
    idx, hdist = matcher.match_nn(d1, un1, m.kf_desc[slot_ref], un2,
                                  max_dist=64, ratio=0.9, mutual=True)
    idx = matcher.dedup_targets(idx, hdist, F)

    # relative pose cam1 (new keyframe) <- cam2 (reference keyframe)
    R1, t1 = _cam0_pose(m, slot_new, rig)
    R2, t2 = _cam0_pose(m, slot_ref, rig)
    R12 = R1.T @ R2
    t12 = R1.T @ (t2 - t1)
    matched = idx >= 0
    safe = torch.where(matched, idx, 0).to(torch.int64)
    params = rig.params[0].expand(F, 8)
    X_c1, _, tri_ok = triangulation.triangulate_matches(
        rig_kind, params, params, R12.expand(F, 3, 3), t12.expand(F, 3),
        m.kf_xy[slot_new], m.kf_xy[slot_ref][safe],
        sigma_level1=m.kf_sigma2[slot_new],
        sigma_level2=m.kf_sigma2[slot_ref][safe],
        min_cos_parallax=min_parallax)
    good = matched & tri_ok
    X_w = X_c1 @ R1.T + t1
    m2, slot_mp, write, n = ms.write_new_landmarks(m, good, X_w, d1,
                                                   slot_new, cap_new)
    # the reference's two row writes, in its order: the new keyframe's,
    # then the reference keyframe's (the same row when slot_ref was
    # clamped onto slot_new, which then stays as it was)
    kf_obs = m.kf_obs.clone()
    kf_obs[slot_new] = torch.where(write, slot_mp, m.kf_obs[slot_new])
    kf_obs[slot_ref] = scatter_max(m.kf_obs[slot_ref], safe,
                                   torch.where(write, slot_mp, -1))
    return m2._replace(kf_obs=kf_obs), n


def spawn_landmarks(m: ms.MapState, slot_new: int, ref_slots, rig_kind: int,
                    rig: RigParams, cap_new: int, n_refs: int = 4,
                    min_parallax: float = 0.99995):
    """Triangulate new landmarks between a new keyframe and the `n_refs`
    reference keyframes `ref_slots` (Python ints, -1 skipped), then
    refresh the landmark geometry (reference: LocalMapping::
    CreateNewMapPoints, src/LocalMapping.cc:395, which searches ~10-20
    covisible keyframes; here the most recent ones).
    Returns (m', n_new)."""
    total = 0
    for j in range(n_refs):
        m, n = _spawn_pair(m, slot_new, int(ref_slots[j]), rig_kind, rig,
                           cap_new, min_parallax)
        total = total + n
    return ms.update_mp_geometry(m), total


def bind_landmarks(m: ms.MapState, slot: int, rig_kind: int, rig: RigParams,
                   img_w: float, img_h: float, radius: float = 10.0,
                   min_last_kf: int = -1):
    """Associate keyframe `slot`'s unbound features with existing
    landmarks by projection search (TH_LOW, ratio 0.9), leaving out the
    landmarks the keyframe already observes; bumps the found counters of
    the bound landmarks (reference: LocalMapping::SearchInNeighbors /
    ORBmatcher::Fuse, src/LocalMapping.cc:786)."""
    F = m.kf_xy.shape[1]
    M = m.mp_pos.shape[0]
    dev = m.kf_obs.device
    uv_proj, lvl, vis, _ = project_landmarks(
        m, m.kf_R[slot], m.kf_t[slot], rig_kind, rig.params[0],
        rig.R_cb[0], rig.t_cb[0], img_w, img_h)
    obs = m.kf_obs[slot]
    unbound = (obs < 0) & m.kf_feat_valid[slot]
    bound = scatter_max(torch.zeros(M, dtype=torch.bool, device=dev),
                        torch.where(obs >= 0, obs, 0), obs >= 0)
    vis = vis & (m.mp_last_kf >= min_last_kf)
    idx, hdist = matcher.match_projection(
        uv_proj, lvl, radius, m.mp_desc, vis & ~bound, m.kf_xy[slot],
        m.kf_level[slot], m.kf_desc[slot], unbound,
        max_dist=matcher.TH_LOW, ratio=0.9)
    idx = matcher.dedup_targets(idx, hdist, F)
    keep = idx >= 0
    new_obs = scatter_max(
        obs, torch.where(keep, idx, F - 1),
        torch.where(keep, torch.arange(M, dtype=torch.int32, device=dev),
                    -1))
    return m._replace(
        kf_obs=set_rows(m.kf_obs, slot, new_obs),
        mp_found=m.mp_found + keep.to(torch.int32),
        mp_last_kf=torch.where(keep, torch.full_like(m.mp_last_kf, slot),
                               m.mp_last_kf))


def _best_per_keyframe(m: ms.MapState, desc, t_valid):
    """[N, K] int32: each query descriptor's smallest Hamming distance
    among the features of every keyframe that `t_valid` [K, F] admits
    (1 << 20 where none). One dense product against all K*F keyframe
    features; on the CPU against the keyframes with an admitted feature
    only (the others give 1 << 20 unsearched)."""
    K, F = m.kf_obs.shape
    ks = (torch.nonzero(t_valid.any(dim=1))[:, 0]
          if desc.device.type == "cpu" else None)
    if ks is not None and ks.numel():
        dist = matcher.hamming_matrix(
            desc, m.kf_desc[ks].reshape(-1, 256)).reshape(-1, len(ks), F)
        best = torch.where(t_valid[ks][None], dist, 1 << 20).min(
            dim=2).values
        out = torch.full((desc.shape[0], K), 1 << 20, dtype=best.dtype)
        out[:, ks] = best
        return out
    dist = matcher.hamming_matrix(
        desc, m.kf_desc.reshape(K * F, 256)).reshape(-1, K, F)
    dist = torch.where(t_valid[None], dist, 1 << 20)
    return dist.min(dim=2).values


def descriptor_place_scores(m: ms.MapState, slot: int):
    """Direct place-recognition scores: for each keyframe, the number of
    features of keyframe `slot` whose best Hamming match in that keyframe
    is < TH_LOW (the dense stand-in for the reference's BoW inverted file,
    KeyFrameDatabase::DetectNBestCandidates). Returns scores [K] int32."""
    best = _best_per_keyframe(m, m.kf_desc[slot], m.kf_feat_valid)
    good = (best < matcher.TH_LOW) & m.kf_feat_valid[slot][:, None]
    return torch.sum(good, dim=0, dtype=torch.int32)


def cull_landmarks(m: ms.MapState, current_slot: int,
                   min_found_ratio: float = 0.25,
                   min_visible: int = 8, grace_kfs: int = 2):
    """Invalidate rarely-matched landmarks (reference:
    LocalMapping::MapPointCulling, src/LocalMapping.cc:360)."""
    age = current_slot - m.mp_first_kf
    ratio = (m.mp_found.to(torch.float32)
             / torch.clamp(m.mp_visible.to(torch.float32), min=1.0))
    bad = (m.mp_valid & (age >= grace_kfs)
           & (m.mp_visible >= min_visible) & (ratio < min_found_ratio))
    return m._replace(mp_valid=m.mp_valid & ~bad)


def _nearest_old(m: ms.MapState, new_ids, old_mask, old_ids,
                 rel_dist_th: float, desc_th: int):
    """(best id [N] int32, its distance key [N] or _INVALID): each new
    landmark's nearest old one inside the distance and descriptor gates,
    ties to the smallest id. Over the whole slab, or with `old_ids` (the
    CPU route) over those landmarks only; the answer is the same where a
    candidate exists (elsewhere the id is unused)."""
    pos_new = m.mp_pos[new_ids]
    if old_ids is None:
        pos_old, desc_old, ok_old = m.mp_pos, m.mp_desc, old_mask
    else:
        if old_ids.numel() == 0:
            n = new_ids.shape[0]
            return (torch.zeros(n, dtype=torch.int32),
                    torch.full((n,), matcher._INVALID, dtype=torch.int32))
        pos_old, desc_old = m.mp_pos[old_ids], m.mp_desc[old_ids]
        ok_old = old_mask[old_ids]
    d3 = torch.linalg.norm(pos_new[:, None, :] - pos_old[None, :, :], dim=-1)
    gate = rel_dist_th * torch.clamp(torch.linalg.norm(pos_new, dim=-1),
                                     min=1.0)[:, None]
    near = (d3 < gate) & ok_old[None, :]
    hd = matcher.hamming_matrix(m.mp_desc[new_ids], desc_old)
    cand = near & (hd < desc_th)
    bi, bv = matcher.masked_argmin((d3 * 1000.0).to(torch.int32), cand)
    if old_ids is not None:
        bi = old_ids[bi].to(torch.int32)
    return bi, bv


def fuse_new_landmarks(m: ms.MapState, slot: int, cap: int = 512,
                       rel_dist_th: float = 0.02, desc_th: int = 40):
    """Merge landmarks spawned at `slot` that duplicate older ones: each
    new landmark takes the nearest OLD landmark within a depth-relative
    radius and a descriptor gate (reference: SearchInNeighbors +
    ORBmatcher::Fuse, src/LocalMapping.cc:786). Plain torch, as XLA ran
    it in the reference."""
    M = m.mp_pos.shape[0]
    new_mask = m.mp_valid & (m.mp_first_kf == slot)
    old_mask = m.mp_valid & (m.mp_first_kf != slot)
    new_ids = compact_indices(new_mask, cap, M - 1)
    is_real = new_mask[new_ids]
    old_ids = (torch.nonzero(old_mask)[:, 0]
               if m.mp_pos.device.type == "cpu" else None)
    bi, bv = _nearest_old(m, new_ids, old_mask, old_ids, rel_dist_th,
                          desc_th)
    dup = is_real & (bv < matcher._INVALID)

    tgt = torch.where(dup, new_ids, M - 1)
    remap = set_rows(torch.arange(M, dtype=torch.int32, device=dup.device),
                     tgt, torch.where(dup, bi, M - 1).to(torch.int32))
    obs = m.kf_obs[slot]
    obs = torch.where(obs >= 0, remap[torch.clamp(obs, min=0).to(
        torch.int64)], obs)
    killed = scatter_max(torch.zeros(M, dtype=torch.bool, device=dup.device),
                         tgt, dup)
    return m._replace(kf_obs=set_rows(m.kf_obs, slot, obs),
                      mp_valid=m.mp_valid & ~killed)


_CULL_LEVELS = 8


def cull_keyframes(m: ms.MapState, current_slot: int, keep_recent: int = 5,
                   redundancy: float = 0.9, min_other_obs: int = 4,
                   max_cull: int = 2, inertial: bool = False,
                   imu_ok=True, min_map_kfs: int = 21,
                   max_gap_s: float = 3.0, recent_gap_s: float = 0.5):
    """Invalidate redundant keyframes (reference:
    LocalMapping::KeyFrameCulling, src/LocalMapping.cc:974, with the
    inertial gap rules of :1110-1120). Up to `max_cull` per call, never
    two temporally adjacent slots.
    Returns (m, culled [max_cull] int32, -1 padded)."""
    K, F = m.kf_obs.shape
    M = m.mp_pos.shape[0]
    L = _CULL_LEVELS
    dev = m.kf_obs.device
    valid_obs = (m.kf_obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    mp = torch.where(valid_obs, m.kf_obs, M).to(torch.int64)
    lvl = torch.clamp(m.kf_level, 0, L - 1).to(torch.int64)
    cnt = torch.zeros((M + 1) * L, dtype=torch.int32, device=dev)
    cnt.index_add_(0, (mp * L + lvl).reshape(-1),
                   valid_obs.reshape(-1).to(torch.int32))
    cnt_le = torch.cumsum(cnt.reshape(M + 1, L), dim=1)
    mp_safe = torch.clamp(mp, max=M - 1)
    others = cnt_le[mp_safe, torch.clamp(lvl + 1, max=L - 1)] - 1
    well = others >= min_other_obs
    frac = (torch.sum((valid_obs & well).to(torch.int32), dim=1)
            / torch.clamp(torch.sum(valid_obs.to(torch.int32), dim=1),
                          min=1))
    idx = torch.arange(K, device=dev)
    protected = (idx > current_slot - keep_recent) | (idx <= 1)
    if inertial:
        prev_i = torch.clamp(idx - 1, min=0)
        next_i = torch.clamp(idx + 1, max=K - 1)
        gap = m.kf_time[next_i] - m.kf_time[prev_i]
        neigh_ok = m.kf_valid[prev_i] & m.kf_valid[next_i]
        old_enough = idx <= current_slot - min_map_kfs
        imu_ok = torch.as_tensor(imu_ok, device=dev)
        allowed = neigh_ok & ((gap < recent_gap_s)
                              | (imu_ok & old_enough & (gap < max_gap_s)))
        protected = (protected | ~allowed
                     | (torch.sum(m.kf_valid.to(torch.int32))
                        <= min_map_kfs))
    cand = (m.kf_valid & ~protected & (frac > redundancy)
            & (torch.sum(valid_obs.to(torch.int32), dim=1) > 0))

    score = torch.where(cand, frac, torch.full_like(frac, -1.0))
    kf_valid = m.kf_valid
    kf_obs = m.kf_obs
    culled = []
    for _ in range(max_cull):
        worst = torch.argmax(score)
        do = score[worst] > 0
        kf_valid = set_rows(kf_valid, worst, kf_valid[worst] & ~do)
        kf_obs = set_rows(kf_obs, worst, torch.where(
            do, torch.full_like(kf_obs[worst], -1), kf_obs[worst]))
        culled.append(torch.where(do, worst, -1).to(torch.int32))
        score = torch.where((idx - worst).abs() <= 1,
                            torch.full_like(score, -1.0), score)
    return m._replace(kf_valid=kf_valid, kf_obs=kf_obs), torch.stack(culled)


N_RELOC_CAND = 3


def relocalization_candidates(m: ms.MapState, feats: extractor.Features):
    """Score every keyframe by how many of the frame's features find a
    landmark-bound feature of it within TH_LOW, and take the best
    `N_RELOC_CAND` (ties to the lower slot).
    Returns (scores [K] int32, kf_cand [N_RELOC_CAND] int64)."""
    t_valid = m.kf_feat_valid & (m.kf_obs >= 0) & m.kf_valid[:, None]
    best = _best_per_keyframe(m, feats.desc, t_valid)
    scores = torch.sum((best < matcher.TH_LOW) & feats.valid[:, None],
                       dim=0, dtype=torch.int32)
    order = torch.sort(scores, descending=True, stable=True).indices
    return scores, order[:N_RELOC_CAND]


def relocalization_matches(m: ms.MapState, feats: extractor.Features, kf):
    """2D-3D matches of the frame's features to the landmarks keyframe
    `kf` observes (mutual nearest neighbours under TH_LOW, ratio 0.85).
    Returns (idx [F0] feature of `kf` or -1, mp [F0] landmark id, 0 where
    unmatched, valid [F0])."""
    obs = m.kf_obs[kf]
    has_mp = (obs >= 0) & m.kf_feat_valid[kf]
    idx, _ = matcher.match_nn(feats.desc, feats.valid, m.kf_desc[kf],
                              has_mp, max_dist=matcher.TH_LOW, ratio=0.85,
                              mutual=True)
    matched = idx >= 0
    safe = torch.where(matched, idx, 0).to(torch.int64)
    mp = torch.where(matched, obs[safe], 0)
    return idx, mp, matched & m.mp_valid[mp.to(torch.int64)]


def relocalize_step(m: ms.MapState, feats: extractor.Features, gen,
                    rig_kind: int, rig: RigParams, sample_idx=None):
    """Relocalization: the best keyframes by dense descriptor scoring,
    2D-3D matches to their landmarks, RANSAC PnP on bearings (reference:
    Tracking::Relocalization, src/Tracking.cc:3543-3700 -- KFDB candidates
    + MLPnPsolver RANSAC).

    feats: the features of camera 0; gen: the generator the RANSAC samples
    are drawn from unless `sample_idx` ([N_RELOC_CAND, n_hyp, 6]) is given.
    Returns (success, R_wb, t_wb, n_inliers)."""
    _, kf_cand = relocalization_candidates(m, feats)
    bearing = cameras.unproject(rig_kind, rig.params[0], feats.xy)
    # bearings in the body frame of camera 0
    bearing_b = bearing @ rig.R_cb[0]
    res = []
    for j in range(N_RELOC_CAND):
        _, mp, valid = relocalization_matches(m, feats, kf_cand[j])
        # per-keypoint pyramid-level variance whitens the bearing
        # constraints (the reference's MLPnPsolver covariance input)
        res.append(pnp_mod.ransac_pnp(
            gen, m.mp_pos[mp.to(torch.int64)], bearing_b, valid,
            min_inliers=15, sigma2=feats.sigma2,
            sample_idx=None if sample_idx is None else sample_idx[j]))
    success, R_cw, t_cw, _, n_inliers = (torch.stack(x) for x in zip(*res))
    b = torch.argmax(n_inliers)
    # body(cam0 frame)-from-world -> world-from-body
    return success[b], R_cw[b].T, -R_cw[b].T @ t_cw[b], n_inliers[b]


def _local_landmarks(m: ms.MapState, mp_safe, valid, ML: int):
    """Window-local landmark compaction shared by the window BAs: the
    landmarks seen by valid observations, packed to <= ML local slots.
    Returns (order [M] local slot per map id, keep [M], inv [ML] map id per
    local slot, used [ML])."""
    M = m.mp_pos.shape[0]
    dev = valid.device
    seen = scatter_max(torch.zeros(M, dtype=torch.bool, device=dev),
                       mp_safe, valid)
    order = torch.cumsum(seen.to(torch.int64), 0) - 1
    keep = seen & (order < ML)
    inv = compact_indices(seen, ML, 0)
    n_local = torch.clamp(torch.sum(seen.to(torch.int64)), max=ML)
    used = torch.arange(ML, device=dev) < n_local
    return order, keep, inv, used


def local_ba_step(m: ms.MapState, newest_slot: int, rig_kind: int,
                  rig: RigParams, window: int = 8):
    """Visual window BA over the `window` most recent keyframes with the
    two oldest members fixed (reference: LocalMapping's
    LocalBundleAdjustment dispatch, src/LocalMapping.cc:156-177).

    Early in a map the clamped window repeats slot 0; the reference's
    scatters then resolve last-write-wins, which the writes here
    reproduce explicitly."""
    K, F = m.kf_obs.shape
    W = window
    dev = m.kf_obs.device
    w_ids = torch.clamp(newest_slot - W + 1 + torch.arange(W, device=dev),
                        0, K - 1)
    w_valid = m.kf_valid[w_ids] & (w_ids <= newest_slot)

    kf_local = torch.arange(W, device=dev).repeat_interleave(F)
    slots = w_ids[kf_local]
    feat = torch.arange(F, device=dev).repeat(W)
    mp = m.kf_obs[slots, feat]
    valid = (mp >= 0) & m.kf_feat_valid[slots, feat] & w_valid[kf_local]
    mp_safe = torch.where(valid, mp, 0).to(torch.int64)
    valid = valid & m.mp_valid[mp_safe]

    M = m.mp_pos.shape[0]
    ML = min(M, 1024)
    order, keep, inv, used = _local_landmarks(m, mp_safe, valid, ML)
    valid = valid & keep[mp_safe]
    obs = ba.BAObservations(
        kf=kf_local, mp=torch.where(valid, order[mp_safe], 0),
        cam=m.kf_cam[slots, feat], uv=m.kf_xy[slots, feat],
        sigma2=m.kf_sigma2[slots, feat], valid=valid)
    state0 = ba.BAState(
        R=m.kf_R[w_ids], t=m.kf_t[w_ids], v=m.kf_v[w_ids],
        bg=m.kf_bg[w_ids], ba=m.kf_ba[w_ids], points=m.mp_pos[inv])
    fixed = (torch.arange(W, device=dev) < 2) | ~w_valid
    state, inlier, chi = ba.bundle_adjust(
        state0, obs, rig, fixed, point_fixed=~used, stages=(5, 10),
        rows_per_kf=F)

    # last-write-wins over duplicated window slots, dump row K
    win = last_occurrence(w_ids)
    tgt = torch.where(win, w_ids, K)

    def wr(slab, vals):
        ext = torch.cat([slab, slab[:1]], dim=0)
        ext[tgt] = vals
        return ext[:K]

    R_w = torch.where(w_valid[:, None, None], state.R, m.kf_R[w_ids])
    t_w = torch.where(w_valid[:, None], state.t, m.kf_t[w_ids])
    pos = torch.cat([m.mp_pos, m.mp_pos[:1]], dim=0)
    pos[torch.where(used, inv, M)] = state.points
    obs_ext = torch.cat([m.kf_obs, m.kf_obs[:1]], dim=0)
    obs_ext[tgt[kf_local], feat] = torch.where(valid & ~inlier, -1,
                                               m.kf_obs[slots, feat])
    return m._replace(kf_R=wr(m.kf_R, R_w), kf_t=wr(m.kf_t, t_w),
                      mp_pos=pos[:M], kf_obs=obs_ext[:K]), chi


def full_map_observations(m: ms.MapState, cap: int | None = None):
    """Flatten every (keyframe, feature) -> landmark binding of the map
    into BAObservations + the observed-landmark mask; `cap` compacts the
    table to <= cap valid rows (overflow keeps the oldest keyframes).
    Returns (obs, observed [M], kf_local, feat)."""
    K, F = m.kf_obs.shape
    dev = m.kf_obs.device
    kf_local = torch.arange(K, device=dev).repeat_interleave(F)
    feat = torch.arange(F, device=dev).repeat(K)
    mp = m.kf_obs.reshape(-1)
    valid = ((mp >= 0) & m.kf_feat_valid.reshape(-1)
             & m.kf_valid[kf_local])
    mp_safe = torch.where(valid, mp, 0).to(torch.int64)
    valid = valid & m.mp_valid[mp_safe]
    if cap is not None and cap < K * F:
        idx = compact_indices(valid, cap, 0)
        taken = torch.arange(cap, device=dev) < torch.clamp(
            torch.sum(valid.to(torch.int64)), max=cap)
        kf_local, feat, mp_safe = kf_local[idx], feat[idx], mp_safe[idx]
        valid = taken & valid[idx]
    obs = ba.BAObservations(
        kf=kf_local, mp=mp_safe, cam=m.kf_cam[kf_local, feat],
        uv=m.kf_xy[kf_local, feat], sigma2=m.kf_sigma2[kf_local, feat],
        valid=valid)
    M = m.mp_pos.shape[0]
    observed = scatter_max(torch.zeros(M, dtype=torch.bool, device=dev),
                           mp_safe, valid)
    return obs, observed, kf_local, feat


def _writeback_gba(m: ms.MapState, state, inlier, chi, observed, kf_local,
                   feat, valid, with_imu: bool) -> ms.MapState:
    """Apply a whole-map BA result back to the slabs; gated on a finite
    chi2, so a diverged solve can never corrupt the map. Observations the
    solve gated out are unbound. (Padding rows of a capped table all name
    feature (0, 0) and rewrite its binding unchanged.)"""
    good = torch.isfinite(chi)
    upd = m.kf_valid & good
    kf_obs = m.kf_obs.clone()
    kf_obs[kf_local, feat] = torch.where(valid & ~inlier, -1,
                                         m.kf_obs[kf_local, feat])
    m = m._replace(
        kf_R=torch.where(upd[:, None, None], state.R, m.kf_R),
        kf_t=torch.where(upd[:, None], state.t, m.kf_t),
        mp_pos=torch.where((observed & good)[:, None], state.points,
                           m.mp_pos),
        kf_obs=torch.where(good, kf_obs, m.kf_obs))
    if with_imu:
        m = m._replace(
            kf_v=torch.where(upd[:, None], state.v, m.kf_v),
            kf_bg=torch.where(upd[:, None], state.bg, m.kf_bg),
            kf_ba=torch.where(upd[:, None], state.ba, m.kf_ba))
    return m


def _whole_map_state(m: ms.MapState) -> ba.BAState:
    return ba.BAState(R=m.kf_R, t=m.kf_t, v=m.kf_v, bg=m.kf_bg, ba=m.kf_ba,
                      points=m.mp_pos)


def global_ba_step(m: ms.MapState, rig_kind: int, rig: RigParams,
                   stages=(5, 8), cg_iters: int = 32,
                   obs_cap: int = 131072):
    """Whole-map bundle adjustment via the matrix-free Schur+PCG path
    (reference: LoopClosing::RunGlobalBundleAdjustment ->
    Optimizer::GlobalBundleAdjustemnt, src/LoopClosing.cc:2351); the first
    two keyframes fix the gauge. Returns (m, chi2)."""
    obs, observed, kf_local, feat = full_map_observations(m, obs_cap)
    _, fixed = _whole_map_chain(m, None, None)
    state, inlier, chi = global_ba.global_bundle_adjust(
        _whole_map_state(m), obs, rig, fixed, point_fixed=~observed,
        stages=stages, cg_iters=cg_iters)
    m = _writeback_gba(m, state, inlier, chi, observed, kf_local, feat,
                       obs.valid, with_imu=False)
    return m, chi


def global_inertial_ba_step(m: ms.MapState, pre_b, edge_valid,
                            rig_kind: int, rig: RigParams, stages=(4, 6),
                            cg_iters: int = 16, obs_cap: int = 131072):
    """Whole-map VISUAL-INERTIAL bundle adjustment: the reference's
    FullInertialBA as the post-loop GBA invokes it (src/LoopClosing.cc:
    2366-2368 -> Optimizer::FullInertialBA, src/Optimizer.cc:368). The
    temporal chain enters as [K-1] preintegrated edges; one keyframe fixes
    the gauge (gravity and scale are observable through the chain).

    pre_b: batched Preintegrated for intervals (k -> k+1), k in [0, K-1);
    edge_valid: [K-1] bool. Returns (m, chi2)."""
    obs, observed, kf_local, feat = full_map_observations(m, obs_cap)
    edges, fixed = _whole_map_chain(m, pre_b, edge_valid)
    state, inlier, chi = global_ba.global_bundle_adjust(
        _whole_map_state(m), obs, rig, fixed, point_fixed=~observed,
        edges=edges, stages=stages, cg_iters=cg_iters)
    m = _writeback_gba(m, state, inlier, chi, observed, kf_local, feat,
                       obs.valid, with_imu=True)
    return m, chi


def _whole_map_chain(m: ms.MapState, pre_b, edge_valid):
    """(edges, fixed) of a whole-map solve: with a chain (`pre_b` not
    None) the inertial edges between live keyframes, each interval
    relinearized at its keyframe's current bias, and the first keyframe
    fixed; without, no edges and the first two fixed."""
    K = m.kf_R.shape[0]
    idx = torch.arange(K, device=m.kf_valid.device)
    if pre_b is None:
        return None, (idx < 2) | ~m.kf_valid
    kf_in = m.kf_valid & (idx < m.n_kf)
    edge_ok = edge_valid & kf_in[1:] & kf_in[:-1]
    # relinearize each interval at its own keyframe's current bias
    # (first-order Reintegrate analog, reference: src/ImuTypes.cc:152)
    bias_k = torch.cat([m.kf_bg, m.kf_ba], dim=-1)[:-1]
    edges = ba.InertialEdges(pre=pre_mod.rebias(pre_b, bias_k),
                             valid=edge_ok)
    return edges, (idx < 1) | ~m.kf_valid


def distributed_global_ba_step(m: ms.MapState, rig_kind: int,
                               rig: RigParams, mesh: dist_ba.Mesh,
                               pre_b=None, edge_valid=None, stages=(4, 6),
                               cg_iters: int = 16, obs_cap: int = 131072):
    """Whole-map GBA (inertial when `pre_b` is given) SHARDED over the
    ranks of `mesh`: the landmarks, their Hessian blocks and the
    observation table are partitioned
    (`dist_ba.distributed_global_ba_lsharded`), one [K, D] all_reduce
    per CG matvec. Every rank of the mesh calls it; the solve starts from
    mesh rank 0's map and chain (broadcast first: ranks that tracked the
    same frames on a card may still part by a binding), so every rank
    returns the same map. The bucketing of the observations reads the
    table to the host once: call at event cadence (post-loop, post-merge,
    shutdown), as the reference's GBA thread runs
    (src/LoopClosing.cc:2351). Returns (m, chi2)."""
    bc = partial(dist_ba.broadcast, mesh)
    m = ms.MapState(*map(bc, m))
    if pre_b is not None:
        pre_b, edge_valid = pre_b.map(bc), bc(edge_valid)
    obs, observed, kf_local, feat = full_map_observations(m, obs_cap)
    edges, fixed = _whole_map_chain(m, pre_b, edge_valid)
    state, inlier, chi = dist_ba.distributed_global_ba_lsharded(
        mesh, _whole_map_state(m), obs, rig, fixed, point_fixed=~observed,
        edges=edges, stages=stages, cg_iters=cg_iters)
    m = _writeback_gba(m, state, inlier, chi, observed, kf_local, feat,
                       obs.valid, with_imu=pre_b is not None)
    return m, chi


def welding_ba_step(m: ms.MapState, free_mask, rig_kind: int,
                    rig: RigParams, obs_cap: int = 131072):
    """Weld-window bundle adjustment after an Atlas map merge (the welding
    LocalBundleAdjustment MergeLocal runs over the frontier after the Sim3
    transform, src/Optimizer.cc:3927; the inertial MergeInertialBA,
    src/Optimizer.cc:4365, is covered by `global_inertial_ba_step` once
    the preintegration chains are welded).

    free_mask: [K] bool, the keyframes allowed to move (the welded-in
    map's slots); the others are the fixed frontier. A landmark moves only
    when a free keyframe observes it. Returns (m, chi2)."""
    obs, observed, kf_local, feat = full_map_observations(m, obs_cap)
    M = m.mp_pos.shape[0]
    mp_free = scatter_max(torch.zeros(M, dtype=torch.bool,
                                      device=m.mp_pos.device),
                          obs.mp, obs.valid & free_mask[obs.kf])
    moving = observed & mp_free
    state, inlier, chi = global_ba.global_bundle_adjust(
        _whole_map_state(m), obs, rig, ~free_mask | ~m.kf_valid,
        point_fixed=~moving, stages=(4, 6), cg_iters=24)
    m = _writeback_gba(m, state, inlier, chi, moving, kf_local, feat,
                       obs.valid, with_imu=False)
    return m, chi


def relative_pose(m: ms.MapState, ref: int, R, t):
    """(R_rel, t_rel) as numpy: the pose (R, t) relative to keyframe
    `ref`, from one device-to-host transfer of both poses."""
    x = torch.cat([m.kf_R[ref].reshape(9), m.kf_t[ref], R.reshape(9),
                   t]).cpu().numpy()
    R_ref, t_ref = x[:9].reshape(3, 3), x[9:12]
    return R_ref.T @ x[12:21].reshape(3, 3), R_ref.T @ (x[21:] - t_ref)


def rebase_pose(old_m: ms.MapState, new_m: ms.MapState, ref, R, p):
    """The live pose (R, p) re-expressed through keyframe `ref` after the
    map moved from `old_m` to `new_m` (a loop correction, a global BA):
    its pose relative to that keyframe is kept, so tracking continues in
    the moved world. Returns (R', p', dR); dR @ v re-expresses a
    world-frame velocity."""
    ref = torch.clamp(torch.as_tensor(ref), min=0).to(torch.int64)
    oR, ot = old_m.kf_R[ref], old_m.kf_t[ref]
    nR, nt = new_m.kf_R[ref], new_m.kf_t[ref]
    return nR @ (oR.T @ R), nt + nR @ (oR.T @ (p - ot)), nR @ oR.T


def replay_trajectory(trajectory, maps):
    """(times, R [T,3,3], t [T,3]) of a host trajectory list of (time,
    map_id, ref_slot, R_rel, t_rel) replayed against the keyframe poses of
    the final maps (reference: mlRelativeFramePoses replayed at save time,
    src/System.cc:717-1090). `maps`: the list of maps indexed by each
    entry's map_id (an Atlas's), or one MapState for every entry."""
    if isinstance(maps, ms.MapState):
        maps = [maps]
    kf = [torch.cat([m.kf_R.reshape(-1, 9), m.kf_t], 1).cpu().numpy()
          for m in maps]
    times, Rs, ts = [], [], []
    for (tm, mid, ref, R_rel, t_rel) in trajectory:
        row = kf[mid][ref]
        R_ref = row[:9].reshape(3, 3)
        times.append(tm)
        Rs.append(R_ref @ R_rel)
        ts.append(row[9:] + R_ref @ t_rel)
    return (np.asarray(times),
            np.stack(Rs) if Rs else np.zeros((0, 3, 3)),
            np.stack(ts) if ts else np.zeros((0, 3)))


def remap_after_weld(trajectory, old_map_id: int, new_map_id: int,
                     kf_off: int, s: float):
    """The trajectory list after map `old_map_id` was welded into map
    `new_map_id` by a world Sim3 of scale `s`: the welded map's entries
    point to their shifted slots (+kf_off) in the new map, with t_rel
    scaled by s (the Sim3 scales every distance of the welded map, so the
    frame's offset from its keyframe too); the maps after the dropped one
    shift down by one. (The reference package shifts the slots and leaves
    t_rel, which puts each replayed frame (s - 1) |t_rel| off.)"""
    s = np.float32(s)
    out = []
    for (tm, mid, ref, R_rel, t_rel) in trajectory:
        if mid == old_map_id:
            out.append((tm, new_map_id, ref + kf_off, R_rel, s * t_rel))
        else:
            out.append((tm, mid - 1 if mid > old_map_id else mid, ref,
                        R_rel, t_rel))
    return out


def recycle_map_slots(m: ms.MapState, trajectory, map_id: int):
    """Re-base trajectory entries off culled reference keyframes, then
    compact the keyframe and landmark slabs so culled slots are reusable:
    the slab's equivalent of the reference deleting keyframes
    (LocalMapping::KeyFrameCulling, src/LocalMapping.cc:974).

    trajectory: host list of (time, map_id, ref_slot, R_rel, t_rel) with
    numpy poses relative to keyframe `ref_slot`.
    Returns (m', trajectory', old_of_new, new_of_old, n_mp)."""
    kf_valid = m.kf_valid.cpu().numpy()
    kf_R = m.kf_R.cpu().numpy()
    kf_t = m.kf_t.cpu().numpy()
    # nearest preceding valid slot per slot
    prev_valid = np.zeros(kf_valid.shape[0], np.int64)
    last = 0
    for k, v in enumerate(kf_valid):
        if v:
            last = k
        prev_valid[k] = last

    traj2 = []
    for (tm, mid, ref, R_rel, t_rel) in trajectory:
        if mid == map_id and not kf_valid[ref]:
            ref2 = int(prev_valid[ref])
            R_w = kf_R[ref] @ R_rel
            t_w = kf_t[ref] + kf_R[ref] @ t_rel
            R_rel = kf_R[ref2].T @ R_w
            t_rel = kf_R[ref2].T @ (t_w - kf_t[ref2])
            ref = ref2
        traj2.append((tm, mid, ref, R_rel, t_rel))

    m, old_of_new, new_of_old = ms.compact_keyframes(m)
    new_of_old = new_of_old.cpu().numpy()
    traj3 = [(tm, mid, int(new_of_old[ref]) if mid == map_id else ref,
              R_rel, t_rel) for (tm, mid, ref, R_rel, t_rel) in traj2]
    m, n_mp = ms.compact_landmarks(m)
    return m, traj3, old_of_new.cpu().numpy(), new_of_old, int(n_mp)


# ---------------------------------------------------------------------------
# The host-policy one-camera tracker
# ---------------------------------------------------------------------------

@dataclass
class TrackerConfig:
    img_w: int = 640
    img_h: int = 480
    orb: extractor.OrbConfig = field(default_factory=extractor.OrbConfig)
    max_kf: int = 64
    max_mp: int = 8192
    match_radius: float = 15.0
    relost_radius: float = 30.0
    min_inliers_track: int = 20
    local_map_window: Optional[int] = None  # None = whole-map tracking
    # extraction and tracking as one call (`frame_step`)
    fused_frontend: bool = False
    kf_min_inlier_frac: float = 0.75   # new KF if tracked < frac * ref
    kf_min_inliers_abs: int = 60       # ... or tracked below this count
    new_mp_cap: int = 256
    ba_window: int = 8
    # window that settles the map after a loop closure (the loop-closer
    # arm, `Tracker._close_loop`)
    gba_window: Optional[int] = 24
    init_min_matches: int = 80
    # LOST frames before the map is parked in the atlas for a fresh one
    # (reference: CreateMapInAtlas, src/Tracking.cc:1953-1968); read only
    # with an atlas
    max_lost_frames: int = 20


class Tracker:
    """One-camera (MONOCULAR, or RGBD when `process_frame` gets depth
    maps) tracker with its policy on the host; the state machine mirrors
    Tracking::Track (reference: src/Tracking.cc:1781-2230).

    Usage:
        tr = Tracker(rig, cfg)            # on the current GPU
        for img, t in frames:
            tr.process_frame(img, t)      # depth=... for RGB-D
        times, R, t = tr.get_trajectory()

    The map and the pose live on `device`; the state machine and the
    trajectory live on the host. The host reads device values where the
    reference package does: the inlier count of every tracking step, the
    init's match count and success (and its points), the relocalization's
    success, the depth init's counts, the keyframe count of a recycle, and
    the two poses each trajectory entry is stored from (one transfer)."""

    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2

    def __init__(self, rig: RigParams, cfg: TrackerConfig, seed: int = 0,
                 loop_closer=None, atlas=None, dist=None, device=None):
        """dist: optional [C, 4] radtan (k1, k2, p1, p2) of a distorted
        pinhole rig (the keypoints are undistorted right after extraction,
        reference: Frame::UndistortKeyPoints); device: where the map and
        the pose live (the current CUDA device when None)."""
        self.device = dev = resolve_device(device)
        self.rig = rig.to(dev)
        self.cfg = cfg
        self.dist = None if dist is None else torch.as_tensor(
            np.asarray(dist, np.float32)).to(dev)
        # optional `loop_closing.LoopCloser`, called on each new keyframe
        self.loop_closer = loop_closer
        # optional multi-map `atlas.Atlas`: a map lost for longer than
        # `max_lost_frames` is parked there for a fresh one, and the loop
        # closer's merge detection welds the maps again
        self.atlas = atlas
        self.state = self.NOT_INITIALIZED
        if atlas is not None:
            self.map, self.map_id = atlas.open(
                cfg.max_kf, cfg.orb.n_features, cfg.max_mp, dev)
        else:
            self.map = ms.allocate(cfg.max_kf, cfg.orb.n_features,
                                   cfg.max_mp, device=dev)
            self.map_id = 0
        self.lost_frames = 0
        # localization-only: track, never extend the map
        # (reference: ActivateLocalizationMode, System.h:132)
        self.localization_only = False
        # replaces the reference's PRNG key (two-view and PnP RANSAC draws)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self._init_feats = None
        self._init_time = None
        self._frame_depth = None
        self.R = torch.eye(3, device=dev)
        self.t = torch.zeros(3, device=dev)
        self.R_prev = torch.eye(3, device=dev)
        self.t_prev = torch.zeros(3, device=dev)
        self.vel_R = torch.eye(3, device=dev)   # T_k = T_{k-1} * vel
        self.vel_t = torch.zeros(3, device=dev)
        self.last_kf_slot = -1
        self.ref_kf_inliers = 0
        # (time, map_id, ref_kf, R_rel, t_rel) per frame, relative to the
        # latest keyframe so that map corrections move the trajectory
        # (reference: mlRelativeFramePoses, src/System.cc:717)
        self.trajectory = []
        self.n_kf = 0

    # -- helpers -----------------------------------------------------------
    def _ext(self, img) -> extractor.Features:
        feats = extractor.extract(img, self.cfg.orb)
        if self.dist is not None:
            feats = extractor.undistort_features(feats, self.rig.params[0],
                                                 self.dist[0])
        return feats

    def _bearing_z1(self, feats):
        """Normalized z=1 coordinates of features through camera 0."""
        ray = cameras.unproject(self.rig.kind, self.rig.params[0], feats.xy)
        z = torch.clamp(ray[:, 2], min=1e-6)
        return ray[:, :2] / z[:, None]

    # -- initialization ----------------------------------------------------
    def _try_initialize(self, feats, time, sample_idx=None):
        """Monocular two-view init against the reference frame, which slides
        forward while too few features match (reference:
        Tracking::MonocularInitialization, src/Tracking.cc:2411): median
        depth scaled to 1, keyframes 0 and 1, a two-keyframe BA.
        sample_idx: optional (idx8 [256, 8], idx4 [256, 4])."""
        cfg, rig, dev = self.cfg, self.rig, self.device
        if self._init_feats is None:
            self._init_feats, self._init_time = feats, time
            return False
        f0 = self._init_feats
        idx, _ = matcher.match_nn(
            feats.desc, feats.valid, f0.desc, f0.valid,
            max_dist=matcher.TH_LOW, ratio=0.9, mutual=True)
        if int((idx >= 0).sum()) < cfg.init_min_matches:
            self._init_feats, self._init_time = feats, time
            return False

        matched = idx >= 0
        safe = torch.where(matched, idx, 0).to(torch.int64)
        res = two_view.reconstruct(
            self.gen, self._bearing_z1(f0)[safe], self._bearing_z1(feats),
            matched, focal=float(rig.params[0, 0]), sample_idx=sample_idx)
        if not bool(res.success):
            return False

        good = res.is_good.cpu().numpy()
        points = res.points.cpu().numpy()
        med = float(np.median(points[:, 2][good])) if good.any() else 1.0
        scale = 1.0 / max(med, 1e-6)
        pts_c0 = points * scale                 # in the first camera
        R01 = res.R.cpu().numpy()               # cam1-from-cam0
        t01 = res.t.cpu().numpy() * scale
        # world = the first camera; keyframe 1 at inv(R01, t01)
        R_w1 = torch.as_tensor(R01.T).to(dev)
        t_w1 = torch.as_tensor(-R01.T @ t01).to(dev)

        F, M = cfg.orb.n_features, cfg.max_mp
        n_new = int(good.sum())
        # feature i of this frame matches feature idx[i] of the reference
        order = np.cumsum(good) - 1
        slot_np = np.where(good, order, -1).astype(np.int32)
        obs0 = np.full((F,), -1, np.int32)
        idx_np = idx.cpu().numpy()
        sel = good & (idx_np >= 0)
        obs0[idx_np[sel]] = slot_np[sel]

        m = self.map
        write = torch.as_tensor(good & (order < M)).to(dev)
        tgt = torch.where(write, torch.as_tensor(slot_np).to(dev),
                          M).to(torch.int64)
        mp_pos = torch.zeros((M + 1, 3), device=dev)
        mp_pos[tgt] = torch.as_tensor(pts_c0).to(dev)
        mp_desc = torch.zeros((M + 1, 256), dtype=torch.int8, device=dev)
        mp_desc[tgt] = feats.desc
        newly = torch.zeros(M + 1, dtype=torch.bool, device=dev)
        newly[tgt] = write
        newly = newly[:M]
        m = m._replace(
            mp_pos=torch.where(newly[:, None], mp_pos[:M], m.mp_pos),
            mp_desc=torch.where(newly[:, None], mp_desc[:M], m.mp_desc),
            mp_valid=newly,
            n_mp=torch.tensor(n_new, dtype=torch.int32, device=dev))
        z3 = torch.zeros(3, device=dev)
        zc = torch.zeros(F, dtype=torch.int32, device=dev)
        m = ms.insert_keyframe(
            m, 0, torch.eye(3, device=dev), z3, z3, z3, z3, self._init_time,
            f0.xy, f0.desc, f0.level, f0.sigma2, zc, f0.valid,
            torch.as_tensor(obs0).to(dev))
        m = ms.insert_keyframe(
            m, 1, R_w1, t_w1, z3, z3, z3, time, feats.xy, feats.desc,
            feats.level, feats.sigma2, zc, feats.valid,
            torch.as_tensor(slot_np).to(dev))
        m = ms.update_mp_geometry(m)
        self.map, _ = local_ba_step(m, 1, rig.kind, rig, window=2)
        self.R, self.t = R_w1, t_w1
        self.R_prev = torch.eye(3, device=dev)
        self.t_prev = torch.zeros(3, device=dev)
        self.last_kf_slot = 1
        self.n_kf = 2
        self.ref_kf_inliers = n_new
        self.state = self.OK
        return True

    # -- RGB-D -------------------------------------------------------------
    def _depth_at(self, feats, depth):
        """The depth map sampled at the features. Returns (d, valid)."""
        return depth_mod.sample_depth(depth, feats.xy)

    def _initialize_rgbd(self, feats, depth, time):
        """Metric initialization from one depth frame: keyframe 0 and its
        landmarks straight from measured depth (reference:
        Tracking::StereoInitialization, src/Tracking.cc:2232)."""
        cfg, rig, dev = self.cfg, self.rig, self.device
        d, ok = self._depth_at(feats, depth)
        if int((ok & feats.valid).sum()) < cfg.init_min_matches:
            return False
        z3 = torch.zeros(3, device=dev)
        F = cfg.orb.n_features
        m = ms.insert_keyframe(
            self.map, 0, torch.eye(3, device=dev), z3, z3, z3, z3, time,
            feats.xy, feats.desc, feats.level, feats.sigma2,
            torch.zeros(F, dtype=torch.int32, device=dev), feats.valid,
            torch.full((F,), -1, dtype=torch.int32, device=dev))
        m, n_new = depth_mod.spawn_from_depth(
            m, 0, rig.kind, rig.params[0], rig.R_cb[0], rig.t_cb[0], d,
            ok & feats.valid, cap_new=F)
        self.map = m
        self.R = torch.eye(3, device=dev)
        self.t = torch.zeros(3, device=dev)
        self.last_kf_slot = 0
        self.n_kf = 1
        self.ref_kf_inliers = int(n_new)
        self.state = self.OK
        return True

    # -- main entry --------------------------------------------------------
    def process_frame(self, img, time: float, depth=None, sample_idx=None):
        """img: [H, W] (uint8 or float32; numpy or a tensor); depth:
        [H, W] z-depth map, 0 = hole (RGB-D); sample_idx: optional RANSAC
        samples for this frame, handed to whichever solver runs: the
        two-view init's (idx8 [256, 8], idx4 [256, 4]) or the
        relocalization's ([3, n_hyp, 6]). Returns whether the frame
        tracked (or initialized)."""
        cfg, rig, dev = self.cfg, self.rig, self.device
        img = torch.as_tensor(img).to(device=dev, dtype=torch.float32)
        self._frame_depth = None if depth is None else torch.as_tensor(
            depth).to(device=dev, dtype=torch.float32)

        if self.state == self.NOT_INITIALIZED:
            feats = self._ext(img)
            if self._frame_depth is not None:
                ok = self._initialize_rgbd(feats, self._frame_depth, time)
            else:
                ok = self._try_initialize(feats, time, sample_idx)
            self._record(time)
            return ok

        if self.state == self.LOST:
            # relocalization attempt (reference: Tracking.cc:3543)
            feats = self._ext(img)
            ok_r, R_r, t_r, _ = relocalize_step(
                self.map, feats, self.gen, rig.kind, rig,
                sample_idx=sample_idx)
            if not bool(ok_r):
                self.lost_frames += 1
                if (self.atlas is not None
                        and self.lost_frames > cfg.max_lost_frames
                        and self.n_kf >= 2):
                    # abandon the map: park it in the atlas and start a
                    # fresh one; merge detection joins them later
                    # (reference: CreateMapInAtlas, Tracking.cc:1953-1968)
                    self._spawn_new_map()
                self._record(time)
                return False
            self.R, self.t = R_r, t_r
            self.vel_R = torch.eye(3, device=dev)
            self.vel_t = torch.zeros(3, device=dev)
            self.lost_frames = 0
            self.state = self.OK

        # motion-model prediction (reference: Tracking.cc mVelocity)
        R_pred = self.R @ self.vel_R
        t_pred = self.t + self.R @ self.vel_t
        min_last = (-1 if cfg.local_map_window is None
                    else self.last_kf_slot - cfg.local_map_window)
        W, H = float(cfg.img_w), float(cfg.img_h)
        if cfg.fused_frontend:
            R, t, feat_mp, n_in, vis, keep, feats = frame_step(
                self.map, img, R_pred, t_pred, rig.kind, rig, cfg.orb, W, H,
                cfg.match_radius, min_last,
                None if self.dist is None else self.dist[0])
        else:
            feats = self._ext(img)
            R, t, feat_mp, n_in, vis, keep = track_step(
                self.map, feats, R_pred, t_pred, rig.kind, rig, W, H,
                cfg.match_radius, min_last)
        n_in = int(n_in)
        if n_in < cfg.min_inliers_track:
            # wider search from the last pose against the whole map
            # (RECENTLY_LOST coast + implicit relocalization)
            R, t, feat_mp, n_in, vis, keep = track_step(
                self.map, feats, self.R, self.t, rig.kind, rig, W, H,
                cfg.relost_radius)
            n_in = int(n_in)
            if n_in < cfg.min_inliers_track:
                self.state = self.LOST
                self._record(time)
                return False

        # motion model: vel = T_{k-1}^-1 T_k (body frame)
        self.vel_R = self.R.T @ R
        self.vel_t = self.R.T @ (t - self.t)
        self.R_prev, self.t_prev = self.R, self.t
        self.R, self.t = R, t
        self.state = self.OK
        self.lost_frames = 0

        m = self.map
        self.map = m._replace(
            mp_visible=m.mp_visible + vis.to(torch.int32),
            mp_found=m.mp_found + keep.to(torch.int32))

        # keyframe decision (reference: NeedNewKeyFrame, simplified: the
        # tracked share against the reference keyframe's)
        need_kf = (n_in < cfg.kf_min_inlier_frac * max(self.ref_kf_inliers, 1)
                   or n_in < cfg.kf_min_inliers_abs)
        if need_kf and not self.localization_only:
            if self.n_kf >= cfg.max_kf:
                self._recycle_slots()
            if self.n_kf < cfg.max_kf:
                self._insert_keyframe(feats, time, feat_mp, n_in)

        self._record(time)
        return True

    def _record(self, time):
        """Store the frame's pose relative to the latest keyframe."""
        ref = max(self.last_kf_slot, 0)
        self.trajectory.append((time, self.map_id, ref) + relative_pose(
            self.map, ref, self.R, self.t))

    def get_trajectory(self):
        """(times, R [T,3,3], t [T,3]) replayed against the final map(s):
        each entry against the atlas map it was recorded in."""
        self._sync_atlas()
        maps = self.map if self.atlas is None else self.atlas.maps
        return replay_trajectory(self.trajectory, maps)

    # -- Atlas bookkeeping ---------------------------------------------------
    def _sync_atlas(self):
        if self.atlas is not None:
            self.atlas.maps[self.map_id] = self.map

    def _spawn_new_map(self):
        """Park the current map in the atlas and track into a fresh one."""
        cfg, dev = self.cfg, self.device
        self._sync_atlas()
        self.map_id = self.atlas.create_map(cfg.max_kf, cfg.orb.n_features,
                                            cfg.max_mp)
        self.map = self.atlas.current_map
        self.state = self.NOT_INITIALIZED
        self._init_feats = None
        self.R = torch.eye(3, device=dev)
        self.t = torch.zeros(3, device=dev)
        self.vel_R = torch.eye(3, device=dev)
        self.vel_t = torch.zeros(3, device=dev)
        self.last_kf_slot = -1
        self.n_kf = 0
        self.ref_kf_inliers = 0
        self.lost_frames = 0

    def _remap_after_merge(self, old_map_id: int, new_map_id: int,
                           kf_off: int, s: float = 1.0):
        """Trajectory references after the current map was welded into an
        older one by a world Sim3 of scale `s` (`remap_after_weld`)."""
        self.trajectory = remap_after_weld(self.trajectory, old_map_id,
                                           new_map_id, kf_off, s)

    def _merge(self, slot: int) -> int:
        """Cross-map merge detection on keyframe `slot` (the merge path of
        LoopClosing, MergeLocal, src/LoopClosing.cc:1381); after a weld the
        trajectory, the map index and the slots follow, and a wide window
        BA settles the junction (MergeLocal's welding BA). Returns the
        keyframe's slot, shifted by a weld."""
        cfg, rig = self.cfg, self.rig
        self._sync_atlas()
        old_id = self.map_id
        hit = self.loop_closer.detect_merge(self.atlas, slot)
        if hit is None:
            return slot
        new_id, kf_off, _ = hit
        self.map = self.atlas.current_map
        self._remap_after_merge(old_id, new_id, kf_off,
                                self.loop_closer.last_weld[0])
        self.map_id = new_id
        slot += kf_off
        self.last_kf_slot = slot
        self.n_kf = int(self.map.n_kf)
        self.map, _ = local_ba_step(self.map, slot, rig.kind, rig,
                                    window=(cfg.gba_window or cfg.ba_window))
        self._sync_atlas()
        return slot

    def _recycle_slots(self):
        """Free keyframe and landmark slots when the slab is full: compact
        the culled slots out; if culling freed nothing, temporally decimate
        the old half of the map first (reference deletes keyframes
        outright, src/LocalMapping.cc:974)."""
        if int(self.map.kf_valid.sum()) >= self.cfg.max_kf:
            self.map, _ = ms.decimate_keyframes(self.map, self.n_kf - 1)
        self.map, self.trajectory, _, new_of_old, _ = recycle_map_slots(
            self.map, self.trajectory, self.map_id)
        if self.last_kf_slot >= 0:
            self.last_kf_slot = int(new_of_old[self.last_kf_slot])
        self.n_kf = int(self.map.n_kf)
        self._sync_atlas()

    def _insert_keyframe(self, feats, time, feat_mp, n_in: int):
        """The mapper chain on a new keyframe: depth landmarks (RGB-D)
        first, then triangulation against the four most recent keyframes,
        bind, fuse, cull landmarks and keyframes, and the window BA
        (reference: src/LocalMapping.cc:59-283)."""
        cfg, rig, dev = self.cfg, self.rig, self.device
        slot = self.n_kf
        z3 = torch.zeros(3, device=dev)
        F = cfg.orb.n_features
        self.map = ms.insert_keyframe(
            self.map, slot, self.R, self.t, z3, z3, z3, time,
            feats.xy, feats.desc, feats.level, feats.sigma2,
            torch.zeros(F, dtype=torch.int32, device=dev), feats.valid,
            feat_mp)
        if self._frame_depth is not None:
            # RGB-D: close landmarks straight from measured depth
            # (reference: CreateNewKeyFrame, src/Tracking.cc:3159)
            d, ok = self._depth_at(feats, self._frame_depth)
            self.map, _ = depth_mod.spawn_from_depth(
                self.map, slot, rig.kind, rig.params[0], rig.R_cb[0],
                rig.t_cb[0], d, ok & feats.valid, cap_new=cfg.new_mp_cap)
        self.map, _ = spawn_landmarks(
            self.map, slot, [slot - 1 - j for j in range(4)], rig.kind, rig,
            cfg.new_mp_cap)
        min_last = (-1 if cfg.local_map_window is None
                    else slot - cfg.local_map_window)
        self.map = bind_landmarks(self.map, slot, rig.kind, rig,
                                  float(cfg.img_w), float(cfg.img_h),
                                  min_last_kf=min_last)
        self.map = fuse_new_landmarks(self.map, slot, cap=cfg.new_mp_cap)
        self.map = cull_landmarks(self.map, slot)
        self.map, _ = cull_keyframes(self.map, slot)
        self.map, _ = local_ba_step(self.map, slot, rig.kind, rig,
                                    window=cfg.ba_window)
        self.last_kf_slot = slot
        self.n_kf += 1
        self.ref_kf_inliers = max(n_in, 1)
        if self.loop_closer is not None:
            self._close_loop(slot)
            if self.atlas is not None and len(self.atlas.maps) > 1:
                slot = self._merge(slot)
        self.R = self.map.kf_R[slot]
        self.t = self.map.kf_t[slot]

    def _close_loop(self, slot: int) -> bool:
        """The loop closer on keyframe `slot`; after a closure a wide
        window BA (`gba_window`) settles the welded map. Returns whether a
        loop closed."""
        cfg, rig = self.cfg, self.rig
        self.map, closed = self.loop_closer.on_keyframe(self.map, slot)
        if closed:
            self.map, _ = local_ba_step(
                self.map, slot, rig.kind, rig,
                window=(cfg.gba_window or cfg.ba_window))
        return closed
