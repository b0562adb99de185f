"""Multi-camera visual-inertial tracking and mapping steps (port of
`concat_bands`, `_match_bank`, `_feat_mp_from`, `_compact_matches`,
`_local_map_compact`, `track_step_multi`, `track_step_multi_vi`, `_lap`, `stereo_spawn`,
`_spawn_pair_band`, `temporal_spawn_multi`, `bind_landmarks_multi`,
`vi_window_ba_step` and `imu_init_step` of
`openmavis_tpu/pipeline/multi_tracking.py`; reference: the multi-camera
paths of src/Tracking.cc, src/Frame.cc:1767-1949, src/LocalMapping.cc).

Per-frame features of all C cameras form one bank of C*F slots (band c
occupies [c*F, (c+1)*F)).
"""

from __future__ import annotations

import torch

from ..frontend import extractor, matcher
from ..geometry import triangulation
from ..imu import preintegration as pre_mod
from ..optim import ba, global_ba, inertial_init, pose_opt
from ..optim.reprojection import RigParams
from ..ops import compact_indices, scatter_max, set_rows
from ..slam_map import map_state as ms
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


def _feat_mp_from(idx, keep, CF: int, M: int):
    """Per-feature landmark id (largest landmark id wins a collision)."""
    dev = idx.device
    return scatter_max(
        torch.full((CF,), -1, dtype=torch.int32, device=dev),
        torch.where(keep, idx, CF - 1),
        torch.where(keep, torch.arange(M, dtype=torch.int32, device=dev),
                    -1))


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
    feat_mp = _feat_mp_from(idx, keep, CF, matched.shape[0])
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
