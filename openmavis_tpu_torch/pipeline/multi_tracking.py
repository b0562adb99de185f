"""Multi-camera visual-inertial tracking: the per-frame and keyframe
steps (port of `concat_bands`, `frame_step_multi`, `_match_bank`,
`_compact_matches`, `_local_map_compact`,
`track_step_multi`, `track_step_multi_vi`, `_lap`, `stereo_spawn`,
`_spawn_pair_band`, `temporal_spawn_multi`, `bind_landmarks_multi`,
`vi_window_ba_step` and `imu_init_step` of
`openmavis_tpu/pipeline/multi_tracking.py`; reference: the multi-camera
paths of src/Tracking.cc, src/Frame.cc:1767-1949, src/LocalMapping.cc),
and the host-policy rig tracker built on them, `MultiTracker` with
`MultiTrackerConfig` (reference: System::TrackMulti src/System.cc:311,
Tracking::GrabImageMulti src/Tracking.cc:1410).

Per-frame features of all C cameras form one bank of C*F slots (band c
occupies [c*F, (c+1)*F)).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..frontend import depth as depth_mod
from ..frontend import extractor, matcher
from ..geometry import cameras, triangulation
from ..imu import preintegration as pre_mod
from ..optim import ba, global_ba, inertial_init, pose_opt
from ..optim.reprojection import RigParams
from ..ops import compact_indices, scatter_max, set_rows
from ..slam_map import map_state as ms
from ..solvers import two_view
from . import tracking as mono


def concat_bands(feats: extractor.Features) -> dict:
    """[C, F, ...] camera-batched features -> one bank [C*F, ...]."""
    C, F = feats.valid.shape
    cam = torch.arange(C, dtype=torch.int32,
                       device=feats.valid.device).repeat_interleave(F)
    return dict(xy=feats.xy.reshape(C * F, 2),
                desc=feats.desc.reshape(C * F, 256),
                level=feats.level.reshape(C * F),
                sigma2=feats.sigma2.reshape(C * F), cam=cam,
                valid=feats.valid.reshape(C * F))


def frame_step_multi(m: ms.MapState, images, R_pred, t_pred, rig_kind: int,
                     n_cams: int, rig: RigParams, orb_cfg, img_w: float,
                     img_h: float, radius, min_last_kf: int = -1,
                     dist=None):
    """The fused per-frame step: multi-camera extraction (with radtan
    `dist`, undistortion), banding and `track_step_multi` as one function.
    Returns track_step_multi's outputs + (bank,)."""
    feats = extractor.extract_multicam(images, orb_cfg)
    if dist is not None:
        feats = extractor.undistort_features(feats, rig.params, dist)
    bank = concat_bands(feats)
    return track_step_multi(m, bank, R_pred, t_pred, rig_kind, n_cams, rig,
                            img_w, img_h, radius, min_last_kf) + (bank,)


def band0_feats(bank, F: int) -> extractor.Features:
    """Camera 0's band (the first F slots) of a bank as single-camera
    Features, for relocalization."""
    zero = torch.zeros(F, device=bank["xy"].device)
    return extractor.Features(
        xy=bank["xy"][:F], response=zero, angle=zero,
        level=bank["level"][:F], sigma2=bank["sigma2"][:F],
        desc=bank["desc"][:F], valid=bank["valid"][:F])


def _match_bank(m: ms.MapState, bank, R_pred, t_pred, rig_kind: int,
                n_cams: int, rig: RigParams, img_w: float, img_h: float,
                radius, min_last_kf: int):
    """Project every landmark into every camera band and match (the
    multi-camera SearchByProjection, src/ORBmatcher.cc:99-331).
    Returns (idx [M] bank-global feature id or -1, matched [M])."""
    CF = bank["xy"].shape[0]
    F = CF // n_cams
    all_idx, all_dist = [], []
    for c in range(n_cams):
        uv_proj, lvl, vis_c, _ = mono.project_landmarks(
            m, R_pred, t_pred, rig_kind, rig.params[c], rig.R_cb[c],
            rig.t_cb[c], img_w, img_h)
        vis_c = vis_c & (m.mp_last_kf >= min_last_kf)
        sl = slice(c * F, (c + 1) * F)
        idx_c, dist_c = matcher.match_projection(
            uv_proj, lvl, radius, m.mp_desc, vis_c,
            bank["xy"][sl], bank["level"][sl], bank["desc"][sl],
            bank["valid"][sl], max_dist=matcher.TH_HIGH, ratio=0.9)
        idx_c = matcher.dedup_targets(idx_c, dist_c, F)
        all_idx.append(torch.where(idx_c >= 0, idx_c + c * F, -1))
        all_dist.append(dist_c)
    idx_sc = torch.stack(all_idx, dim=1)                     # [M, C]
    dist_sc = torch.stack(all_dist, dim=1)
    best_c = torch.argmin(torch.where(idx_sc >= 0, dist_sc, 1 << 20), dim=1)
    idx = torch.gather(idx_sc, 1, best_c[:, None])[:, 0]
    return idx, idx >= 0


def _compact_matches(matched, cap: int):
    """Matched-landmark rows compacted to `cap` (the matches are injective
    into the C*F bank). Returns (rows [cap], taken [cap] bool)."""
    rows = compact_indices(matched, cap, 0)
    taken = torch.arange(cap, device=matched.device) < torch.clamp(
        torch.sum(matched.to(torch.int64)), max=cap)
    return rows, taken


def _local_map_compact(m: ms.MapState, min_last_kf: int, cap: int):
    """Gather the <= `cap` most recently observed valid landmarks into a
    compact sub-map for per-frame tracking, so that projection, matching
    and every residual evaluation cost O(cap) whatever the slab's size
    (the reference tracks against the local map of the covisible keyframe
    set, Tracking::UpdateLocalPoints, src/Tracking.cc:3462, never the whole
    atlas). Ties between landmarks of one keyframe go to the lower id.
    Returns (sub_map, inv [cap] int64 slab ids, used [cap] bool)."""
    sel = m.mp_valid & (m.mp_last_kf >= min_last_kf)
    score = torch.where(sel, m.mp_last_kf, -1)
    inv = torch.sort(score, descending=True, stable=True).indices[:cap]
    used = score[inv] >= 0
    sub = m._replace(
        mp_pos=m.mp_pos[inv], mp_desc=m.mp_desc[inv],
        mp_normal=m.mp_normal[inv], mp_dmin=m.mp_dmin[inv],
        mp_dmax=m.mp_dmax[inv], mp_valid=used,
        mp_last_kf=m.mp_last_kf[inv], mp_first_kf=m.mp_first_kf[inv],
        mp_visible=m.mp_visible[inv], mp_found=m.mp_found[inv])
    return sub, inv, used


def _track_matches(m: ms.MapState, bank, R_pred, t_pred, rig_kind: int,
                   n_cams: int, rig: RigParams, img_w: float, img_h: float,
                   radius, min_last_kf: int, map_cap: int, optimize):
    """The part the two tracking steps share: match the (capped) local map
    into the bank, compact the matches to C*F rows, hand them to
    `optimize(points, cam, uv, sigma2, taken) -> (result, inlier, n_in)`
    and express the outcome in slab ids.
    Returns (result, feat_mp [C*F], n_in, vis [M], keep [M])."""
    CF = bank["xy"].shape[0]
    M = m.mp_pos.shape[0]
    compact = bool(map_cap) and map_cap < M
    if compact:
        mt_, inv, used = _local_map_compact(m, min_last_kf, map_cap)
    else:
        mt_, used = m, m.mp_valid
    idx, matched = _match_bank(mt_, bank, R_pred, t_pred, rig_kind, n_cams,
                               rig, img_w, img_h, radius, min_last_kf)
    safe = torch.where(matched, idx, 0).to(torch.int64)
    rows, taken = _compact_matches(matched & used, CF)
    result, inlier_c, n_in = optimize(
        mt_.mp_pos[rows], bank["cam"][safe][rows], bank["xy"][safe][rows],
        bank["sigma2"][safe][rows], taken)
    inlier = scatter_max(torch.zeros_like(matched), rows, inlier_c & taken)
    vis, keep = matched, matched & inlier
    feat_mp = mono._feat_mp_from(idx, keep, CF, matched.shape[0])
    if compact:
        # back to slab ids
        feat_mp = torch.where(
            feat_mp >= 0,
            inv[torch.clamp(feat_mp, min=0).to(torch.int64)].to(
                torch.int32), -1)
        zeros = torch.zeros(M, dtype=torch.bool, device=matched.device)
        vis = scatter_max(zeros, inv, vis & used)
        keep = scatter_max(zeros, inv, keep & used)
    return result, feat_mp, n_in, vis, keep


def track_step_multi(m: ms.MapState, bank, R_pred, t_pred, rig_kind: int,
                     n_cams: int, rig: RigParams, img_w: float,
                     img_h: float, radius, min_last_kf: int = -1,
                     map_cap: int = 0, po_rounds: int = 4,
                     po_iters: int = 7):
    """Local-map projection tracking across all bands + visual pose
    optimization. `map_cap` > 0 caps the tracked landmark set (see
    `_local_map_compact`).
    Returns (R, t, feat_mp [C*F], n_in, vis [M], keep [M])."""
    def optimize(points, cam, uv, sigma2, taken):
        R, t, inlier_c, n_in = pose_opt.pose_optimization(
            R_pred, t_pred, points, cam, uv, sigma2, taken, rig,
            rounds=po_rounds, iters_per_round=po_iters)
        return (R, t), inlier_c, n_in

    (R, t), feat_mp, n_in, vis, keep = _track_matches(
        m, bank, R_pred, t_pred, rig_kind, n_cams, rig, img_w, img_h,
        radius, min_last_kf, map_cap, optimize)
    return R, t, feat_mp, n_in, vis, keep


def track_step_multi_vi(m: ms.MapState, bank, anchor, state_pred, pre,
                        rig_kind: int, n_cams: int, rig: RigParams,
                        img_w: float, img_h: float, radius,
                        min_last_kf: int = -1, map_cap: int = 0,
                        po_rounds: int = 4, po_iters: int = 7):
    """VI local-map tracking: match from the IMU-predicted pose, then
    optimize the full 15-dof state against the matches, the
    preintegration edge to the anchor and the bias random walk
    (reference: PoseInertialOptimizationLastFrame, src/Optimizer.cc:5580).
    `map_cap` as in `track_step_multi`.
    Returns (state, feat_mp, n_in, vis, keep)."""
    def optimize(points, cam, uv, sigma2, taken):
        return pose_opt.pose_inertial_optimization(
            state_pred, anchor, pre, points, cam, uv, sigma2, taken, rig,
            rounds=po_rounds, iters_per_round=po_iters)

    return _track_matches(
        m, bank, state_pred.R, state_pred.p, rig_kind, n_cams, rig, img_w,
        img_h, radius, min_last_kf, map_cap, optimize)


def _lap(cfg, cam: int):
    """(colBegin, colEnd) lapping area of camera `cam`, or None."""
    if not getattr(cfg, "lapping", ()):
        return None
    return tuple(cfg.lapping[cam])


def stereo_spawn(m: ms.MapState, slot: int, rig_kind: int, n_cams: int,
                 rig: RigParams, pair: tuple, cap_new: int = 512,
                 max_depth: float = 40.0, lap1=None, lap2=None):
    """Triangulate landmarks from one intra-rig camera pair of keyframe
    `slot` (reference: Frame::ComputeMultiFishEyeMatches +
    KannalaBrandt8::TriangulateMatches, src/Frame.cc:1461-1527); lap1/lap2
    optional (colBegin, colEnd) lapping areas.
    Returns (m', n_new)."""
    c1, c2 = pair
    CF = m.kf_xy.shape[1]
    F = CF // n_cams
    s1 = slice(c1 * F, (c1 + 1) * F)
    s2 = slice(c2 * F, (c2 + 1) * F)
    unbound = (m.kf_obs[slot] < 0) & m.kf_feat_valid[slot]
    d1, d2 = m.kf_desc[slot][s1], m.kf_desc[slot][s2]
    un1, un2 = unbound[s1], unbound[s2]
    if lap1 is not None:
        x1 = m.kf_xy[slot][s1][:, 0]
        un1 = un1 & (x1 >= lap1[0]) & (x1 <= lap1[1])
    if lap2 is not None:
        x2 = m.kf_xy[slot][s2][:, 0]
        un2 = un2 & (x2 >= lap2[0]) & (x2 <= lap2[1])
    idx, hdist = matcher.match_nn(d1, un1, d2, un2, max_dist=64,
                                  ratio=0.85, mutual=True)
    idx = matcher.dedup_targets(idx, hdist, F)
    matched = idx >= 0
    safe = torch.where(matched, idx, 0).to(torch.int64)

    R_c1b, t_c1b = rig.R_cb[c1], rig.t_cb[c1]
    R_c2b, t_c2b = rig.R_cb[c2], rig.t_cb[c2]
    R12 = R_c1b @ R_c2b.T
    t12 = t_c1b - R12 @ t_c2b
    X_c1, depth, tri_ok = triangulation.triangulate_matches(
        rig_kind, rig.params[c1].expand(F, 8), rig.params[c2].expand(F, 8),
        R12.expand(F, 3, 3), t12.expand(F, 3),
        m.kf_xy[slot][s1], m.kf_xy[slot][s2][safe],
        sigma_level1=m.kf_sigma2[slot][s1],
        sigma_level2=m.kf_sigma2[slot][s2][safe],
        min_cos_parallax=1.0)
    good = matched & tri_ok & (depth > 0.05) & (depth < max_depth)

    R_wb, t_wb = m.kf_R[slot], m.kf_t[slot]
    R_wc1 = R_wb @ R_c1b.T
    t_wc1 = t_wb + R_wb @ (-R_c1b.T @ t_c1b)
    X_w = X_c1 @ R_wc1.T + t_wc1

    m2, slot_mp, write, n = ms.write_new_landmarks(m, good, X_w, d1, slot,
                                                 cap_new)
    obs = m.kf_obs[slot].clone()
    obs[c1 * F:(c1 + 1) * F] = torch.where(write, slot_mp, obs[s1])
    obs = scatter_max(obs, c2 * F + safe, torch.where(write, slot_mp, -1))
    return m2._replace(kf_obs=set_rows(m.kf_obs, slot, obs)), n


def _spawn_pair_band(m: ms.MapState, slot_new: int, slot_ref: int,
                     cam: int, n_cams: int, rig: RigParams, rig_kind: int,
                     cap_new: int, min_parallax: float = 0.99995,
                     max_depth: float = 60.0):
    """Temporal triangulation between the `cam` band of a new keyframe and
    the same band of one reference keyframe (reference:
    LocalMapping::CreateNewMapPoints, src/LocalMapping.cc:395-786)."""
    CF = m.kf_xy.shape[1]
    F = CF // n_cams
    sl = slice(cam * F, (cam + 1) * F)
    ref_ok = (slot_ref >= 0) and (slot_ref != slot_new)
    slot_ref = max(slot_ref, 0)
    ref_ok = m.kf_valid[slot_ref] & ref_ok

    d1 = m.kf_desc[slot_new][sl]
    d2 = m.kf_desc[slot_ref][sl]
    un1 = ((m.kf_obs[slot_new] < 0) & m.kf_feat_valid[slot_new])[sl]
    un2 = ((m.kf_obs[slot_ref] < 0) & m.kf_feat_valid[slot_ref])[sl] \
        & ref_ok
    idx, hdist = matcher.match_nn(d1, un1, d2, un2, max_dist=64,
                                  ratio=0.9, mutual=True)
    idx = matcher.dedup_targets(idx, hdist, F)
    matched = idx >= 0
    safe = torch.where(matched, idx, 0).to(torch.int64)

    R_cb, t_cb = rig.R_cb[cam], rig.t_cb[cam]

    def cam_pose(s):
        return (m.kf_R[s] @ R_cb.T,
                m.kf_t[s] + m.kf_R[s] @ (-R_cb.T @ t_cb))

    R1, t1 = cam_pose(slot_new)
    R2, t2 = cam_pose(slot_ref)
    R12 = R1.T @ R2
    t12 = R1.T @ (t2 - t1)
    params = rig.params[cam].expand(F, 8)
    X_c1, depth, tri_ok = triangulation.triangulate_matches(
        rig_kind, params, params, R12.expand(F, 3, 3), t12.expand(F, 3),
        m.kf_xy[slot_new][sl], m.kf_xy[slot_ref][sl][safe],
        sigma_level1=m.kf_sigma2[slot_new][sl],
        sigma_level2=m.kf_sigma2[slot_ref][sl][safe],
        min_cos_parallax=min_parallax)
    good = matched & tri_ok & (depth > 0.05) & (depth < max_depth)

    X_w = X_c1 @ R1.T + t1
    m2, slot_mp, write, n = ms.write_new_landmarks(m, good, X_w, d1,
                                                 slot_new, cap_new)
    band = cam * F
    kf_obs = m.kf_obs.clone()
    kf_obs[slot_new, band:band + F] = torch.where(write, slot_mp,
                                                  m.kf_obs[slot_new][sl])
    kf_obs[slot_ref] = scatter_max(kf_obs[slot_ref], band + safe,
                                   torch.where(write, slot_mp, -1))
    return m2._replace(kf_obs=kf_obs), n


def temporal_spawn_multi(m: ms.MapState, slot_new: int, ref_slots,
                         rig_kind: int, n_cams: int, rig: RigParams,
                         cap_new: int, n_refs: int = 2):
    """Temporal triangulation for every band against recent keyframes
    (reference: LocalMapping::CreateNewMapPoints). The geometry refresh is
    left to the caller, as in the reference package."""
    total = 0
    for c in range(n_cams):
        for j in range(n_refs):
            m, n = _spawn_pair_band(m, slot_new, int(ref_slots[j]), c,
                                    n_cams, rig, rig_kind, cap_new)
            total = total + n
    return m, total


def bind_landmarks_multi(m: ms.MapState, slot: int, rig_kind: int,
                         n_cams: int, rig: RigParams, img_w: float,
                         img_h: float, radius: float = 10.0,
                         min_last_kf: int = -1):
    """Associate the new keyframe's unbound features with existing
    landmarks by per-camera projection search (reference:
    LocalMapping::SearchInNeighbors / ORBmatcher::Fuse,
    src/LocalMapping.cc:786)."""
    CF = m.kf_xy.shape[1]
    F = CF // n_cams
    M = m.mp_pos.shape[0]
    dev = m.kf_obs.device
    obs = m.kf_obs[slot].clone()
    bound = scatter_max(torch.zeros(M, dtype=torch.bool, device=dev),
                        torch.where(obs >= 0, obs, 0), obs >= 0)
    found = torch.zeros(M, dtype=torch.int32, device=dev)
    touched = torch.zeros(M, dtype=torch.bool, device=dev)
    ids = torch.arange(M, dtype=torch.int32, device=dev)
    for c in range(n_cams):
        sl = slice(c * F, (c + 1) * F)
        uv_proj, lvl, vis, _ = mono.project_landmarks(
            m, m.kf_R[slot], m.kf_t[slot], rig_kind, rig.params[c],
            rig.R_cb[c], rig.t_cb[c], img_w, img_h)
        vis = vis & (m.mp_last_kf >= min_last_kf) & ~bound
        unbound = (obs[sl] < 0) & m.kf_feat_valid[slot][sl]
        idx, hdist = matcher.match_projection(
            uv_proj, lvl, radius, m.mp_desc, vis, m.kf_xy[slot][sl],
            m.kf_level[slot][sl], m.kf_desc[slot][sl], unbound,
            max_dist=matcher.TH_LOW, ratio=0.9)
        idx = matcher.dedup_targets(idx, hdist, F)
        keep = idx >= 0
        obs[sl] = scatter_max(obs[sl], torch.where(keep, idx, F - 1),
                              torch.where(keep, ids, -1))
        found = found + keep.to(torch.int32)
        touched = touched | keep
        bound = bound | keep
    return m._replace(
        kf_obs=set_rows(m.kf_obs, slot, obs), mp_found=m.mp_found + found,
        mp_last_kf=torch.where(touched, torch.full_like(m.mp_last_kf, slot),
                               m.mp_last_kf))


def vi_window_ba_step(m: ms.MapState, ids, kf_in, pre_b, edge_ok,
                      last: int, rig_kind: int, rig: RigParams,
                      stages=(4, 6)):
    """VI window BA over a fixed-size keyframe window with the temporal
    inertial chain (reference: LocalInertialBA, src/Optimizer.cc:4763).

    ids [W] window slots; kf_in [W] entry mask; pre_b chain [W-1];
    edge_ok [W-1]; last: index of the newest window entry.
    Returns (m', bias' [6])."""
    K, CF = m.kf_obs.shape
    W = ids.shape[0]
    dev = m.kf_obs.device
    ids = torch.clamp(ids, max=K - 1)
    edges = ba.InertialEdges(pre=pre_b, valid=edge_ok)
    kf_local = torch.arange(W, device=dev).repeat_interleave(CF)
    slots = ids[kf_local]
    featix = torch.arange(CF, device=dev).repeat(W)
    mp = m.kf_obs[slots, featix]
    valid = (mp >= 0) & m.kf_feat_valid[slots, featix] & kf_in[kf_local]
    mp_safe = torch.where(valid, mp, 0).to(torch.int64)
    valid = valid & m.mp_valid[mp_safe]
    M = m.mp_pos.shape[0]
    ML = min(M, 4096)
    order, keep, inv, used = mono._local_landmarks(m, mp_safe, valid, ML)
    valid = valid & keep[mp_safe]
    obs = ba.BAObservations(
        kf=kf_local, mp=torch.where(valid, order[mp_safe], 0),
        cam=m.kf_cam[slots, featix], uv=m.kf_xy[slots, featix],
        sigma2=m.kf_sigma2[slots, featix], valid=valid)
    state0 = ba.BAState(R=m.kf_R[ids], t=m.kf_t[ids], v=m.kf_v[ids],
                        bg=m.kf_bg[ids], ba=m.kf_ba[ids],
                        points=m.mp_pos[inv])
    fixed = (torch.arange(W, device=dev) < 1) | ~kf_in
    state, inlier, chi = ba.bundle_adjust(
        state0, obs, rig, fixed, point_fixed=~used, edges=edges,
        stages=stages, rows_per_kf=CF)
    good = torch.isfinite(chi)
    # dump-row scatter: padded entries write to row K and are sliced away
    ids_w = torch.where(kf_in & good, ids, K)

    def wr(slab, vals):
        ext = torch.cat([slab, slab[:1]], dim=0)
        ext[ids_w] = vals
        return ext[:K]

    pos = torch.cat([m.mp_pos, m.mp_pos[:1]], dim=0)
    pos[torch.where(used & good, inv, M)] = state.points
    kf_obs = torch.cat([m.kf_obs, m.kf_obs[:1]], dim=0)
    kf_obs[torch.where(kf_in[kf_local] & good, slots, K), featix] = \
        torch.where(valid & ~inlier, -1, m.kf_obs[slots, featix])
    m = m._replace(
        kf_R=wr(m.kf_R, state.R), kf_t=wr(m.kf_t, state.t),
        kf_v=wr(m.kf_v, state.v), kf_bg=wr(m.kf_bg, state.bg),
        kf_ba=wr(m.kf_ba, state.ba), mp_pos=pos[:M], kf_obs=kf_obs[:K])
    bias = torch.where(
        good, torch.cat([state.bg[last], state.ba[last]]),
        torch.cat([state0.bg[last], state0.ba[last]]))
    return m, bias


def imu_init_step(m: ms.MapState, pre_b, edge_valid, bias, first: bool,
                  prior_g: float, prior_a: float, fix_scale: bool,
                  rig: RigParams, obs_cap: int = 131072):
    """One stage of the staged IMU initialization: InertialOptimization
    (poses fixed) -> gravity-align + scale the map -> whole-map
    FullInertialBA, applied only if the inertial solve is sane
    (reference: LocalMapping::InitializeIMU src/LocalMapping.cc:1255 with
    the VIBA schedule of :203-265; Optimizer::FullInertialBA :368).

    pre_b: chain [K-1]; first: warm-start switch (initial stage only).
    Returns (m', bias' [6], ok) with ok a Python bool."""
    K, CF = m.kf_obs.shape
    dev = m.kf_obs.device
    if first:
        v0, R_wg0 = inertial_init.initial_gravity_velocity(
            m.kf_R, m.kf_t, pre_b, edge_valid)
        bias0 = torch.zeros(6, dtype=bias.dtype, device=dev)
    else:
        v0, R_wg0, bias0 = m.kf_v, torch.eye(3, device=dev), bias
    res = inertial_init.inertial_optimization(
        m.kf_R, m.kf_t, v0, pre_b, edge_valid, fix_scale=fix_scale,
        prior_g=prior_g, prior_a=prior_a, R_wg0=R_wg0, bias0=bias0)
    ok = bool(torch.isfinite(res.chi2) & (res.scale > 0.1))
    if not ok:
        return m, bias, False

    R_gw = res.R_wg.T
    Rn, pn, _, ptn = inertial_init.apply_scaled_rotation(
        m.kf_R, m.kf_t, m.kf_v, m.mp_pos, R_gw, res.scale)
    vn = res.v @ R_gw.T
    kf_in = m.kf_valid
    m = m._replace(
        kf_R=torch.where(kf_in[:, None, None], Rn, m.kf_R),
        kf_t=torch.where(kf_in[:, None], pn, m.kf_t),
        kf_v=torch.where(kf_in[:, None], vn, m.kf_v),
        mp_pos=torch.where(m.mp_valid[:, None], ptn, m.mp_pos),
        kf_bg=res.bg.expand(K, 3).clone(), kf_ba=res.ba.expand(K, 3).clone())
    bias_new = torch.cat([res.bg, res.ba])

    obs, observed, kf_local, feat = mono.full_map_observations(m, obs_cap)
    # re-linearize the chain at the refreshed bias
    edges = ba.InertialEdges(pre=pre_mod.rebias(pre_b, bias_new),
                             valid=edge_valid)
    fixed = (torch.arange(K, device=dev) < 1) | ~m.kf_valid
    state, inlier, chi = global_ba.global_bundle_adjust(
        mono._whole_map_state(m), obs, rig, fixed, point_fixed=~observed,
        edges=edges, stages=(3, 4), cg_iters=12)
    m = mono._writeback_gba(m, state, inlier, chi, observed, kf_local,
                            feat, obs.valid, with_imu=True)
    return ms.update_mp_geometry(m), bias_new, True


# ---------------------------------------------------------------------------
# The host-policy rig tracker
# ---------------------------------------------------------------------------

@dataclass
class MultiTrackerConfig:
    img_w: int = 640
    img_h: int = 480
    n_cams: int = 4
    stereo_pairs: tuple = ((0, 1),)    # overlapping rig pairs
    # per-camera (colBegin, colEnd) stereo lapping areas; () = full width
    # (reference: CameraN.overlappingBegin/End, mvLappingArea)
    lapping: tuple = ()
    orb: extractor.OrbConfig = field(default_factory=extractor.OrbConfig)
    max_kf: int = 64
    max_mp: int = 16384
    match_radius: float = 15.0
    relost_radius: float = 30.0
    # frames to keep the wide search window after recovering from LOST
    # (reference: doubled search th when recently relocalized,
    # src/Tracking.cc:2020-2060)
    reentry_boost_frames: int = 5
    min_inliers_track: int = 30
    local_map_window: Optional[int] = None
    fused_frontend: bool = False
    kf_min_inlier_frac: float = 0.75
    kf_min_inliers_abs: int = 120
    kf_max_interval_s: float = 0.5     # inertial KF cadence (Tracking.cc:3003)
    new_mp_cap: int = 384
    ba_window: int = 8
    imu_freq: float = 200.0
    imu_buf: int = 256                 # max samples between keyframes
    imu_init_kfs: int = 8              # KFs before IMU initialization
    use_imu: bool = True
    # VIBA refinement schedule, seconds after the first keyframe
    # (reference: VIBA1 at mTinit>5s, VIBA2 at >15s, LocalMapping.cc:224-265)
    viba1_time: float = 5.0
    viba2_time: float = 15.0
    # mono-inertial two-view initialization thresholds
    init_min_matches: int = 80
    init_min_inliers: int = 50
    # temporal triangulation: reference KFs per camera band
    temporal_refs: int = 2
    # frames to coast in LOST before abandoning the map for a fresh one in
    # the atlas (reference: CreateMapInAtlas, src/Tracking.cc:1953-1968);
    # read only with an atlas
    max_lost_frames: int = 20
    # external per-camera depth priors (reference: depth maps sampled at
    # undistorted keypoints into pseudo-stereo, src/Frame.cc:1659-1765):
    # process_frame takes a [C, H, W] z-depth stack; unbound keyframe
    # features spawn metric landmarks from it (frontend/depth.py)
    use_depth: bool = False
    depth_cap: int = 256
    depth_max: float = 25.0
    depth_pin: tuple = ()     # per-cam virtual pinhole; () = raw frame

    @property
    def metric_scale(self) -> bool:
        """True when the rig baseline provides metric scale (any stereo
        pair) or depth priors do; mono-inertial estimates scale in the
        IMU init instead."""
        return len(self.stereo_pairs) > 0 or self.use_depth


class MultiTracker:
    """Multi-camera (optionally inertial) tracker with its policy on the
    host: one `process_frame` per frame, IMU samples queued by `feed_imu`.

    Usage:
        tr = MultiTracker(rig, cfg, noise)        # on the current GPU
        for t, images, samples in stream:
            for w, a, ts in samples:
                tr.feed_imu(w, a, ts)
            tr.process_frame(images, t)
        times, R, t = tr.get_trajectory()

    The map and the pose live on `device`; the state machine, the IMU
    queues, the per-keyframe preintegration list and the trajectory live
    on the host, as in the reference package. The host reads device
    values where the reference does: the inlier count of every tracking
    step, the relocalization's and the two-view init's success, the
    landmark counts of the rig init, the culled keyframes, the IMU init's
    sanity, and the keyframe pose each trajectory entry is stored
    against."""

    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2

    def __init__(self, rig: RigParams, cfg: MultiTrackerConfig,
                 noise: pre_mod.ImuNoise | None = None, seed: int = 0,
                 loop_closer=None, atlas=None, dist=None, device=None):
        """dist: optional [C, 4] radtan (k1, k2, p1, p2) per camera of a
        distorted pinhole rig; device: where the map and the pose live
        (the current CUDA device when None)."""
        self.device = dev = resolve_device(device)
        # optional `loop_closing.LoopCloser`, called on each new keyframe
        self.loop_closer = loop_closer
        self.rig = rig.to(dev)
        self.cfg = cfg
        self.dist = None if dist is None else torch.as_tensor(
            np.asarray(dist, np.float32)).to(dev)
        self.noise = (noise or pre_mod.ImuNoise.from_sigmas(
            1.7e-4, 2e-3, 1.9e-5, 3e-3, cfg.imu_freq, device=dev)).to(dev)
        # optional multi-map `atlas.Atlas` (a map lost for longer than
        # `max_lost_frames` is parked there; merge detection rejoins it)
        self.atlas = atlas
        self.state = self.NOT_INITIALIZED
        CF = cfg.n_cams * cfg.orb.n_features
        if atlas is not None:
            self.map, self.map_id = atlas.open(cfg.max_kf, CF, cfg.max_mp,
                                               dev)
        else:
            self.map = ms.allocate(cfg.max_kf, CF, cfg.max_mp, device=dev)
            self.map_id = 0
        # preintegration chains (`kf_pre` lists) of parked maps, by atlas
        # map index
        self._parked_pre = {}
        self.lost_frames = 0
        # localization-only: track, never extend the map
        # (reference: ActivateLocalizationMode, System.h:132)
        self.localization_only = False
        # replaces the reference's PRNG key (two-view and PnP RANSAC draws)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.R = torch.eye(3, device=dev)
        self.t = torch.zeros(3, device=dev)
        self.v = torch.zeros(3, device=dev)
        self.bias = torch.zeros(6, device=dev)
        self.vel_R = torch.eye(3, device=dev)
        self.vel_t = torch.zeros(3, device=dev)
        self.imu_initialized = False
        self._reentry_boost = 0
        # staged init bookkeeping: 0 = not initialized, 1 = initial stage
        # done, 2 = VIBA1 done, 3 = VIBA2 done (reference schedule at
        # src/LocalMapping.cc:224-265)
        self.viba_stage = 0
        self.first_kf_time = None
        self.last_kf_slot = -1
        self.last_kf_time = None
        self.last_time = None
        self.ref_kf_inliers = 0
        self.n_kf = 0
        self.trajectory = []
        self._init_bank = None          # mono-inertial two-view reference
        self._init_time = None
        self._depth_cur = None
        # IMU queues (host): samples since the last frame and since the
        # last keyframe
        self._imu_frame = []
        self._imu_kf = []
        # per-keyframe preintegrations (Preintegrated or None, index = slot)
        self.kf_pre = []

    def _ext(self, images) -> extractor.Features:
        feats = extractor.extract_multicam(images, self.cfg.orb)
        if self.dist is not None:
            feats = extractor.undistort_features(feats, self.rig.params,
                                                 self.dist)
        return feats

    # -- IMU ---------------------------------------------------------------
    def feed_imu(self, w, a, t):
        """Queue one IMU sample (gyro rad/s, accel m/s^2, timestamp)."""
        self._imu_frame.append((np.asarray(w, np.float32),
                                np.asarray(a, np.float32), float(t)))
        self._imu_kf.append(self._imu_frame[-1])

    def _integrate(self, queue, t_end, t_start):
        """Preintegrate the queued samples over (t_start, t_end]: the
        reference's sample list (at most `imu_buf` samples, the last one
        held up to t_end), without its zero-dt padding to `imu_buf`,
        which is an identity step up to float32 rounding."""
        n = self.cfg.imu_buf
        ws = np.zeros((n, 3), np.float32)
        accs = np.zeros((n, 3), np.float32)
        dts = np.zeros((n,), np.float32)
        prev_t = t_start
        j = 0
        for (w, a, t) in queue:
            if t <= t_start or j >= n:
                continue
            dt = min(t, t_end) - prev_t
            if dt <= 0:
                continue
            ws[j], accs[j], dts[j] = w, a, dt
            prev_t = min(t, t_end)
            j += 1
        if j < n and prev_t < t_end and j > 0:
            ws[j], accs[j] = ws[j - 1], accs[j - 1]
            dts[j] = t_end - prev_t
            j += 1
        dev = self.device
        return pre_mod.integrate(
            torch.as_tensor(ws[:j]).to(dev), torch.as_tensor(accs[:j]).to(dev),
            torch.as_tensor(dts[:j]).to(dev), self.bias, self.noise)

    # -- main --------------------------------------------------------------
    def process_frame(self, images, time: float, depth=None,
                      sample_idx=None):
        """images: [C, H, W] (uint8 or float32; numpy or a tensor); depth:
        [C, H, W] z-depth stack (cfg.use_depth rigs only); sample_idx:
        optional RANSAC samples for this frame, handed to whichever solver
        runs: the two-view init's (idx8 [256, 8], idx4 [256, 4]) or the
        relocalization's ([3, n_hyp, 6]). Returns whether the frame
        tracked (or initialized)."""
        cfg = self.cfg
        dev = self.device
        images = torch.as_tensor(images).to(device=dev, dtype=torch.float32)
        if cfg.use_depth:
            if depth is None:
                raise ValueError("cfg.use_depth=True but process_frame "
                                 "got no depth stack")
            self._depth_cur = torch.as_tensor(depth).to(
                device=dev, dtype=torch.float32)

        if self.state == self.NOT_INITIALIZED:
            bank = concat_bands(self._ext(images))
            ok = self._initialize(bank, time, sample_idx)
            self._record(time)
            self.last_time = time
            self._imu_frame = []
            return ok

        # frame-interval preintegration (always, when inertial: the
        # prediction and the VI pose optimization's edge need it)
        pre_f = None
        if cfg.use_imu and self._imu_frame and self.last_time is not None:
            pre_f = self._integrate(self._imu_frame, time, self.last_time)
        self._imu_frame = []

        # pose prediction: IMU once initialized, else constant velocity
        if self.imu_initialized and pre_f is not None:
            R_pred, t_pred, v_pred = pre_mod.predict_state(
                self.R, self.t, self.v, pre_f, self.bias)
        else:
            R_pred = self.R @ self.vel_R
            t_pred = self.t + self.R @ self.vel_t
            v_pred = self.v

        # relocalization attempt when LOST (reference: Tracking.cc:3543)
        bank0 = None
        if self.state == self.LOST and self.n_kf >= 2:
            bank0 = concat_bands(self._ext(images))
            ok_r, R_r, t_r, _ = mono.relocalize_step(
                self.map, self._band0_feats(bank0), self.gen,
                self.rig.kind, self.rig, sample_idx=sample_idx)
            if bool(ok_r):
                R_pred, t_pred = R_r, t_r
                self.vel_R = torch.eye(3, device=dev)
                self.vel_t = torch.zeros(3, device=dev)

        min_last = (-1 if cfg.local_map_window is None
                    else self.last_kf_slot - cfg.local_map_window)
        # post-recovery boost: search with the wide window for a few
        # frames after a LOST episode (reference: TrackWithMotionModel
        # doubles th when recently relocalized, src/Tracking.cc:2020-2060)
        radius = (cfg.relost_radius if self._reentry_boost > 0
                  else cfg.match_radius)
        W, H = float(cfg.img_w), float(cfg.img_h)
        use_vi = self.imu_initialized and pre_f is not None
        if use_vi:
            bank = bank0 if bank0 is not None else concat_bands(
                self._ext(images))
            anchor = pose_opt.InertialState(
                R=self.R, p=self.t, v=self.v,
                bg=self.bias[:3], ba=self.bias[3:])
            pred = pose_opt.InertialState(
                R=R_pred, p=t_pred, v=v_pred,
                bg=self.bias[:3], ba=self.bias[3:])
            st, feat_mp, n_in, vis, keep = track_step_multi_vi(
                self.map, bank, anchor, pred, pre_f, self.rig.kind,
                cfg.n_cams, self.rig, W, H, cfg.match_radius, min_last)
            R, t = st.R, st.p
        elif cfg.fused_frontend:
            R, t, feat_mp, n_in, vis, keep, bank = frame_step_multi(
                self.map, images, R_pred, t_pred, self.rig.kind,
                cfg.n_cams, self.rig, cfg.orb, W, H, radius, min_last,
                self.dist)
        else:
            bank = bank0 if bank0 is not None else concat_bands(
                self._ext(images))
            R, t, feat_mp, n_in, vis, keep = track_step_multi(
                self.map, bank, R_pred, t_pred, self.rig.kind, cfg.n_cams,
                self.rig, W, H, radius, min_last)
        n_in = int(n_in)
        if n_in < cfg.min_inliers_track:
            # wide visual retry from the last confirmed pose
            R, t, feat_mp, n_in, vis, keep = track_step_multi(
                self.map, bank, self.R, self.t, self.rig.kind, cfg.n_cams,
                self.rig, W, H, cfg.relost_radius)
            n_in = int(n_in)
            if n_in >= cfg.min_inliers_track:
                self._reentry_boost = cfg.reentry_boost_frames
            if n_in < cfg.min_inliers_track:
                self.state = self.LOST
                self.lost_frames += 1
                if self.imu_initialized and pre_f is not None:
                    # RECENTLY_LOST: coast on the IMU prediction so the
                    # pose stays usable for relocalization and re-entry
                    # (reference: Tracking.cc:1929-1940)
                    self.R, self.t, self.v = R_pred, t_pred, v_pred
                if (self.atlas is not None
                        and self.lost_frames > cfg.max_lost_frames
                        and self.n_kf >= 2):
                    # park the map and start fresh (reference:
                    # CreateMapInAtlas, src/Tracking.cc:1953-1968)
                    self._spawn_new_map()
                self._record(time)
                self.last_time = time
                return False
            use_vi = False

        dt = max(time - (self.last_time if self.last_time is not None
                         else time - 1e-3), 1e-3)
        self.vel_R = self.R.T @ R
        self.vel_t = self.R.T @ (t - self.t)
        if use_vi:
            self.v = st.v
            self.bias = torch.cat([st.bg, st.ba])
        else:
            self.v = (t - self.t) / dt
        self.R, self.t = R, t
        if self.state == self.LOST:
            self._reentry_boost = cfg.reentry_boost_frames
        elif self._reentry_boost > 0:
            self._reentry_boost -= 1
        self.state = self.OK
        self.lost_frames = 0

        need_kf = (n_in < cfg.kf_min_inlier_frac
                   * max(self.ref_kf_inliers, 1)
                   or n_in < cfg.kf_min_inliers_abs
                   or (cfg.use_imu and self.last_kf_time is not None
                       and time - self.last_kf_time > cfg.kf_max_interval_s))
        if need_kf and not self.localization_only:
            if self.n_kf >= cfg.max_kf:
                self._recycle_slots()
            if self.n_kf < cfg.max_kf:
                self._insert_keyframe(bank, time, feat_mp, n_in)

        self._record(time)
        self.last_time = time
        return True

    def _record(self, time):
        """Store the frame's pose relative to the latest keyframe, so that
        later map corrections (the IMU init's rotation, a global BA) move
        the whole trajectory (reference: mlRelativeFramePoses replayed
        against the final keyframe poses, src/System.cc:717-1090)."""
        ref = max(self.last_kf_slot, 0)
        self.trajectory.append((time, self.map_id, ref) + mono.relative_pose(
            self.map, ref, self.R, self.t))

    def get_trajectory(self):
        """(times, R [T,3,3], t [T,3]) against the final map(s): each
        entry against the atlas map it was recorded in."""
        self._sync_atlas()
        maps = self.map if self.atlas is None else self.atlas.maps
        return mono.replay_trajectory(self.trajectory, maps)

    # -- Atlas bookkeeping ---------------------------------------------------
    def _sync_atlas(self):
        if self.atlas is not None:
            self.atlas.maps[self.map_id] = self.map

    def _spawn_new_map(self):
        """Park the current map and its preintegration chain; start fresh.
        The IMU initializes again in the new map (the reference resets its
        IMU-init flags in CreateMapInAtlas); the bias estimate stays as the
        starting guess."""
        cfg, dev = self.cfg, self.device
        self._sync_atlas()
        self._parked_pre[self.map_id] = self.kf_pre
        self.map_id = self.atlas.create_map(
            cfg.max_kf, cfg.n_cams * cfg.orb.n_features, cfg.max_mp)
        self.map = self.atlas.current_map
        self.state = self.NOT_INITIALIZED
        self.R = torch.eye(3, device=dev)
        self.t = torch.zeros(3, device=dev)
        self.v = torch.zeros(3, device=dev)
        self.vel_R = torch.eye(3, device=dev)
        self.vel_t = torch.zeros(3, device=dev)
        self.imu_initialized = False
        self.last_kf_slot = -1
        self.last_kf_time = None
        self.n_kf = 0
        self.ref_kf_inliers = 0
        self.lost_frames = 0
        self.kf_pre = []
        self._imu_kf = []

    def _remap_after_merge(self, old_map_id: int, new_map_id: int,
                           kf_off: int, s: float = 1.0):
        """After the current map was welded into an older one by a world
        Sim3 of scale `s`: the trajectory (`mono.remap_after_weld`), the
        welded preintegration chain, and the MergeInertialBA analog."""
        self.trajectory = mono.remap_after_weld(self.trajectory, old_map_id,
                                                new_map_id, kf_off, s)
        # weld the chains: the parked (older) map's chain fills slots
        # [0, kf_off), this map's follows (MergeLocal2 keeps both temporal
        # chains, src/LoopClosing.cc:1956)
        parked, self._parked_pre = self._parked_pre, {}
        for mid, pres in parked.items():
            mid2 = mid - 1 if mid > old_map_id else mid
            if mid2 == new_map_id:
                chain = list(pres) + [None] * (kf_off - len(pres))
                self.kf_pre = chain[:kf_off] + self.kf_pre
            elif mid != old_map_id:
                self._parked_pre[mid2] = pres
        # MergeInertialBA analog (src/Optimizer.cc:4365, run by MergeLocal2
        # after the weld): the merged map with the whole inertial edge set.
        # The seam interval (last parked keyframe -> first welded one) has
        # no preintegration, so its edge stays invalid, as the reference's
        # broken chain across sessions
        if self.imu_initialized:
            K = self.cfg.max_kf
            pre_b, cvalid = self._kf_pre_batch(K)
            cvalid = cvalid & (torch.arange(1, K, device=self.device)
                               < self.map.n_kf)
            self.map, _ = mono.global_inertial_ba_step(
                self.map, pre_b, cvalid, self.rig.kind, self.rig)
            self._sync_atlas()

    def _merge(self, slot: int) -> int:
        """Cross-map merge detection on keyframe `slot` (the merge path of
        LoopClosing -> MergeLocal2 for inertial maps); after a weld the
        trajectory, the chains, the map index and the slots follow, and a
        window BA (VI once the IMU is initialized) welds the junction.
        Returns the keyframe's slot, shifted by a weld."""
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
        if self.imu_initialized:
            self._vi_local_ba(slot)
        else:
            self.map, _ = mono.local_ba_step(self.map, slot, rig.kind, rig,
                                             window=cfg.ba_window)
        self._sync_atlas()
        return slot

    def _recycle_slots(self):
        """Compact the keyframe and landmark slabs when full, welding the
        preintegration chain across dropped keyframes (the reference's
        IMU::Preintegrated::MergePrevious, src/ImuTypes.cc:241-263, as the
        closed-form composition of the adjoining intervals)."""
        m = self.map
        if int(m.kf_valid.sum()) >= self.cfg.max_kf:
            m, _ = ms.decimate_keyframes(m, self.n_kf - 1)
            self.map = m
        kf_valid = self.map.kf_valid.cpu().numpy()
        self.map, self.trajectory, old_of_new, new_of_old, _ = \
            mono.recycle_map_slots(self.map, self.trajectory, self.map_id)
        # new interval k covers everything between consecutive surviving
        # keyframes: the old intervals in (old_of_new[k-1], old_of_new[k]]
        old_pre = self.kf_pre
        n_new = int(self.map.n_kf)
        new_pre: list = [None] * n_new
        prev_old = -1
        for k in range(n_new):
            cur_old = int(old_of_new[k])
            acc = None
            for j in range(prev_old + 1, cur_old + 1):
                p = old_pre[j] if j < len(old_pre) else None
                if p is None:
                    continue
                acc = p if acc is None else pre_mod.compose(acc, p)
            new_pre[k] = acc
            prev_old = cur_old
        self.kf_pre = new_pre
        if self.last_kf_slot >= 0 and kf_valid[self.last_kf_slot]:
            self.last_kf_slot = int(new_of_old[self.last_kf_slot])
        else:
            self.last_kf_slot = n_new - 1
        self.n_kf = n_new
        self._sync_atlas()

    def _band0_feats(self, bank) -> extractor.Features:
        return band0_feats(bank, self.cfg.orb.n_features)

    def _initialize(self, bank, time, sample_idx=None):
        """Rigs with overlapping pairs (or depth) triangulate the first
        frame directly (metric); a single camera runs the two-view
        reconstruction and gets its scale in the IMU init."""
        if not self.cfg.stereo_pairs and not self.cfg.use_depth:
            return self._initialize_mono(bank, time, sample_idx)
        return self._initialize_rig(bank, time)

    def _initialize_mono(self, bank, time, sample_idx=None):
        """Two-view monocular init on camera 0's band (reference:
        Tracking::MonocularInitialization, src/Tracking.cc:2411; scale
        comes later from InertialOptimization with fix_scale=False)."""
        cfg, rig, dev = self.cfg, self.rig, self.device
        F = cfg.orb.n_features
        if self._init_bank is None:
            self._init_bank, self._init_time = bank, time
            return False
        b0 = self._init_bank
        idx, _ = matcher.match_nn(
            bank["desc"][:F], bank["valid"][:F],
            b0["desc"][:F], b0["valid"][:F],
            max_dist=matcher.TH_LOW, ratio=0.9, mutual=True)
        if int((idx >= 0).sum()) < cfg.init_min_matches:
            self._init_bank, self._init_time = bank, time
            return False

        def bearing_z1(b):
            ray = cameras.unproject(rig.kind, rig.params[0], b["xy"][:F])
            z = torch.clamp(ray[:, 2], min=1e-6)
            return ray[:, :2] / z[:, None]

        matched = idx >= 0
        safe = torch.where(matched, idx, 0).to(torch.int64)
        res = two_view.reconstruct(
            self.gen, bearing_z1(b0)[safe], bearing_z1(bank), matched,
            focal=float(rig.params[0, 0]), min_inliers=cfg.init_min_inliers,
            sample_idx=sample_idx)
        if not bool(res.success):
            return False
        good = res.is_good.cpu().numpy()
        points = res.points.cpu().numpy()
        depths = points[:, 2]
        med = float(np.median(depths[good])) if good.any() else 1.0
        scale = 1.0 / max(med, 1e-6)
        pts_c0 = points * scale
        R01 = res.R.cpu().numpy()
        t01 = res.t.cpu().numpy() * scale
        R_w1, t_w1 = R01.T, -R01.T @ t01

        CF = bank["xy"].shape[0]
        M = cfg.max_mp
        order = np.cumsum(good) - 1
        slot_np = np.where(good, order, -1).astype(np.int32)
        obs1 = np.full((CF,), -1, np.int32)
        obs1[:F] = slot_np
        obs0 = np.full((CF,), -1, np.int32)
        idx_np = idx.cpu().numpy()
        sel = good & (idx_np >= 0)
        obs0[idx_np[sel]] = slot_np[sel]
        n_new = int(good.sum())

        m = self.map
        write = torch.as_tensor(good & (order < M)).to(dev)
        tgt = torch.where(write, torch.as_tensor(slot_np).to(dev),
                          M).to(torch.int64)
        mp_pos = torch.zeros((M + 1, 3), device=dev)
        mp_pos[tgt] = torch.as_tensor(pts_c0).to(dev)
        mp_desc = torch.zeros((M + 1, 256), dtype=torch.int8, device=dev)
        mp_desc[tgt] = bank["desc"][:F]
        newly = torch.zeros(M + 1, dtype=torch.bool, device=dev)
        newly[tgt] = write
        newly = newly[:M]
        m = m._replace(
            mp_pos=torch.where(newly[:, None], mp_pos[:M], m.mp_pos),
            mp_desc=torch.where(newly[:, None], mp_desc[:M], m.mp_desc),
            mp_valid=newly,
            n_mp=torch.tensor(n_new, dtype=torch.int32, device=dev))
        z3 = torch.zeros(3, device=dev)
        m = ms.insert_keyframe(
            m, 0, torch.eye(3, device=dev), z3, z3, z3, z3, self._init_time,
            b0["xy"], b0["desc"], b0["level"], b0["sigma2"], b0["cam"],
            b0["valid"], torch.as_tensor(obs0).to(dev))
        R_w1 = torch.as_tensor(R_w1).to(dev)
        t_w1 = torch.as_tensor(t_w1).to(dev)
        m = ms.insert_keyframe(
            m, 1, R_w1, t_w1, z3, z3, z3, time, bank["xy"], bank["desc"],
            bank["level"], bank["sigma2"], bank["cam"], bank["valid"],
            torch.as_tensor(obs1).to(dev))
        m = ms.update_mp_geometry(m)
        self.map, _ = mono.local_ba_step(m, 1, rig.kind, rig, window=2)
        self.R, self.t = R_w1, t_w1
        self.last_kf_slot = 1
        self.last_kf_time = time
        self.first_kf_time = self._init_time
        self.n_kf = 2
        self.ref_kf_inliers = n_new
        # KF0 has no preceding interval; KF0 -> KF1 covers the init gap
        if cfg.use_imu and self._imu_kf and self._init_time is not None:
            self.kf_pre = [None, self._integrate(self._imu_kf, time,
                                                 self._init_time)]
        else:
            self.kf_pre = [None, None]
        self._imu_kf = []
        self._init_bank = None
        self.state = self.OK
        return True

    def _initialize_rig(self, bank, time):
        """Multi-camera init: triangulate the first frame's stereo pairs
        (and spawn from depth) directly (reference: MultiInitialization,
        src/Tracking.cc:2339: metric scale from the rig baseline)."""
        cfg, rig, dev = self.cfg, self.rig, self.device
        z3 = torch.zeros(3, device=dev)
        CF = bank["xy"].shape[0]
        m = ms.insert_keyframe(
            self.map, 0, torch.eye(3, device=dev), z3, z3, z3, z3, time,
            bank["xy"], bank["desc"], bank["level"], bank["sigma2"],
            bank["cam"], bank["valid"],
            torch.full((CF,), -1, dtype=torch.int32, device=dev))
        total = 0
        if cfg.use_depth:
            m, n_new = depth_mod.spawn_from_depth_multi(
                m, 0, rig.kind, cfg.n_cams, rig, self._depth_cur,
                pin_params=cfg.depth_pin or None, cap_new=cfg.depth_cap,
                max_spawn_depth=cfg.depth_max)
            total += int(n_new)
        for pair in cfg.stereo_pairs:
            m, n_new = stereo_spawn(m, 0, rig.kind, cfg.n_cams, rig, pair,
                                    lap1=_lap(cfg, pair[0]),
                                    lap2=_lap(cfg, pair[1]))
            total += int(n_new)
        if total < 50:
            self.map = ms.allocate(cfg.max_kf, CF, cfg.max_mp, device=dev)
            return False
        self.map = ms.update_mp_geometry(m)
        self.last_kf_slot = 0
        self.last_kf_time = time
        self.first_kf_time = time
        self.n_kf = 1
        self.ref_kf_inliers = total
        self.kf_pre = [None]
        self._imu_kf = []
        self.state = self.OK
        return True

    def _insert_keyframe(self, bank, time, feat_mp, n_in):
        cfg, rig = self.cfg, self.rig
        slot = self.n_kf
        self.map = ms.insert_keyframe(
            self.map, slot, self.R, self.t, self.v, self.bias[:3],
            self.bias[3:], time, bank["xy"], bank["desc"], bank["level"],
            bank["sigma2"], bank["cam"], bank["valid"], feat_mp)
        # depth-prior points first: measured metric depth needs no
        # parallax (reference: Frame.cc:1916-1922)
        if cfg.use_depth:
            self.map, _ = depth_mod.spawn_from_depth_multi(
                self.map, slot, rig.kind, cfg.n_cams, rig, self._depth_cur,
                pin_params=cfg.depth_pin or None, cap_new=cfg.depth_cap,
                max_spawn_depth=cfg.depth_max)
        # intra-rig stereo points (metric) ...
        for pair in cfg.stereo_pairs:
            self.map, _ = stereo_spawn(
                self.map, slot, rig.kind, cfg.n_cams, rig, pair,
                cap_new=cfg.new_mp_cap, lap1=_lap(cfg, pair[0]),
                lap2=_lap(cfg, pair[1]))
        # ... plus temporal points per camera band against recent KFs
        # (reference: CreateNewMapPoints, src/LocalMapping.cc:395)
        refs = [slot - 1 - j for j in range(cfg.temporal_refs)]
        self.map, _ = temporal_spawn_multi(
            self.map, slot, refs, rig.kind, cfg.n_cams, rig, cfg.new_mp_cap,
            n_refs=cfg.temporal_refs)
        self.map = bind_landmarks_multi(
            self.map, slot, rig.kind, cfg.n_cams, rig, float(cfg.img_w),
            float(cfg.img_h))
        self.map = mono.fuse_new_landmarks(self.map, slot,
                                           cap=cfg.new_mp_cap)
        self.map = mono.cull_landmarks(self.map, slot)
        self.map = ms.update_mp_geometry(self.map)

        # preintegration of this keyframe interval
        if cfg.use_imu and self._imu_kf and self.last_kf_time is not None:
            self.kf_pre.append(self._integrate(self._imu_kf, time,
                                               self.last_kf_time))
        else:
            self.kf_pre.append(None)
        self._imu_kf = []

        # window BA: visual until the IMU is initialized, VI after
        if self.imu_initialized:
            self._vi_local_ba(slot)
        else:
            self.map, _ = mono.local_ba_step(self.map, slot, rig.kind, rig,
                                             window=cfg.ba_window)

        # redundant-keyframe culling with the chain merged across each
        # culled keyframe (reference: KeyFrameCulling + MergePrevious,
        # src/LocalMapping.cc:974, src/ImuTypes.cc:241)
        self.map, culled = mono.cull_keyframes(
            self.map, slot, inertial=cfg.use_imu,
            imu_ok=bool(self.imu_initialized))
        for ck in culled.tolist():
            if ck >= 0 and ck + 1 < len(self.kf_pre):
                a = self.kf_pre[ck]
                b = self.kf_pre[ck + 1]
                if a is not None and b is not None:
                    self.kf_pre[ck + 1] = pre_mod.compose(a, b)
                elif a is not None:
                    self.kf_pre[ck + 1] = a
                self.kf_pre[ck] = None

        self.last_kf_slot = slot
        self.last_kf_time = time
        self.n_kf += 1
        self.ref_kf_inliers = max(n_in, 1)

        # staged IMU initialization + VIBA refinement schedule (reference:
        # InitializeIMU at LocalMapping.cc:203-265: initial stage priors
        # 1e2 / 1e5 (metric) or 1e10 (mono), VIBA1 at 5 s with 1.0 / 1e5,
        # VIBA2 at 15 s with 0 / 0, each followed by FullInertialBA)
        if cfg.use_imu:
            tinit = (time - self.first_kf_time
                     if self.first_kf_time is not None else 0.0)
            if self.viba_stage == 0 and self.n_kf >= cfg.imu_init_kfs:
                pa = 1e5 if cfg.metric_scale else 1e10
                if self._imu_init_stage(1e2, pa, first=True):
                    self.viba_stage = 1
            elif self.viba_stage == 1 and tinit > cfg.viba1_time:
                if self._imu_init_stage(1.0, 1e5, first=False):
                    self.viba_stage = 2
            elif self.viba_stage == 2 and tinit > cfg.viba2_time:
                if self._imu_init_stage(0.0, 0.0, first=False):
                    self.viba_stage = 3

        if self.loop_closer is not None:
            self._close_loop(slot)
            if self.atlas is not None and len(self.atlas.maps) > 1:
                slot = self._merge(slot)

        self.R = self.map.kf_R[slot]
        self.t = self.map.kf_t[slot]
        self.v = self.map.kf_v[slot]

    def _close_loop(self, slot: int) -> bool:
        """The loop closer on keyframe `slot`. Once the IMU is initialized
        it gets the stored preintegration chain (entry k the interval
        k-1 -> k, entry 0 the identity) for its post-loop FullInertialBA.
        Returns whether a loop closed."""
        lc_kw = {}
        if self.imu_initialized:
            pre_b, cvalid = self._kf_pre_batch(self.cfg.max_kf)
            ident = pre_mod.init_preintegrated(self.bias)
            lc_kw = dict(
                chain=pre_mod.Preintegrated(*(
                    torch.cat([i[None], p]) for i, p in zip(ident, pre_b))),
                chain_valid=torch.cat([torch.zeros(
                    1, dtype=torch.bool, device=self.device), cvalid]))
        self.map, closed = self.loop_closer.on_keyframe(self.map, slot,
                                                        **lc_kw)
        return closed

    def _kf_pre_batch(self, K):
        """The chain [1, K) as one batched Preintegrated + validity mask
        (a missing entry is the identity interval, invalid)."""
        ident = pre_mod.init_preintegrated(self.bias)
        pres, valid = [], []
        for k in range(1, K):
            p = self.kf_pre[k] if k < len(self.kf_pre) else None
            pres.append(p if p is not None else ident)
            valid.append(p is not None)
        pre_b = pre_mod.Preintegrated(*(torch.stack(xs)
                                        for xs in zip(*pres)))
        return pre_b, torch.tensor(valid, device=self.device)

    def _imu_init_stage(self, prior_g, prior_a, first: bool) -> bool:
        """One stage of the staged IMU initialization through
        `imu_init_step` (InertialOptimization -> gravity-align ->
        FullInertialBA; reference: LocalMapping::InitializeIMU,
        src/LocalMapping.cc:1255, priors of the VIBA schedule at
        :203-265)."""
        cfg = self.cfg
        if self.n_kf < 3:
            return False
        K = cfg.max_kf
        pre_b, edge_valid = self._kf_pre_batch(K)
        edge_valid = edge_valid & (
            torch.arange(1, K, device=self.device) < self.n_kf)
        if int(edge_valid.sum()) < self.n_kf - 2:
            return False
        m2, _, ok = imu_init_step(
            self.map, pre_b, edge_valid, self.bias, bool(first),
            max(prior_g, 0.0), max(prior_a, 0.0), cfg.metric_scale,
            self.rig)
        if not ok:
            return False
        self.map = m2
        s = self.last_kf_slot
        self.R, self.t, self.v = m2.kf_R[s], m2.kf_t[s], m2.kf_v[s]
        self.bias = torch.cat([m2.kf_bg[s], m2.kf_ba[s]])
        self.imu_initialized = True
        return True

    def _vi_local_ba(self, newest):
        """VI window BA over the stored preintegration chain, the window
        padded to `ba_window` with invalid entries (`vi_window_ba_step`);
        visual window BA when an interval of the window is missing."""
        cfg, rig = self.cfg, self.rig
        W = cfg.ba_window
        if newest < 1:
            return
        lo = max(newest - W + 1, 0)
        w_ids = list(range(lo, newest + 1))
        have_pre = all(k < len(self.kf_pre) and self.kf_pre[k] is not None
                       for k in w_ids[1:])
        if not have_pre:
            self.map, _ = mono.local_ba_step(self.map, newest, rig.kind, rig,
                                             window=W)
            return
        n_w = len(w_ids)
        ident = pre_mod.init_preintegrated(self.bias)
        pres = [self.kf_pre[k] for k in w_ids[1:]]
        pres += [ident] * (W - 1 - len(pres))
        dev = self.device
        pre_b = pre_mod.Preintegrated(*(torch.stack(xs)
                                        for xs in zip(*pres)))
        self.map, self.bias = vi_window_ba_step(
            self.map, torch.tensor(w_ids + [newest] * (W - n_w), device=dev),
            torch.tensor([True] * n_w + [False] * (W - n_w), device=dev),
            pre_b,
            torch.tensor([True] * (n_w - 1) + [False] * (W - n_w),
                         device=dev),
            n_w - 1, rig.kind, rig)
