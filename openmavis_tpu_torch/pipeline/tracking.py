"""Map-side steps shared by the trackers (port of `project_landmarks`,
`descriptor_place_scores`, `cull_landmarks`, `fuse_new_landmarks`,
`cull_keyframes`, `relocalize_step`, `local_ba_step`,
`full_map_observations`, `_writeback_gba`, `global_ba_step`,
`global_inertial_ba_step` and `recycle_map_slots` of
`openmavis_tpu/pipeline/tracking.py`; reference: src/Tracking.cc,
src/LocalMapping.cc, src/LoopClosing.cc:2351).

Keyframe slots are Python ints here; the reference package keeps them as
traced scalars.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend import extractor, matcher
from ..geometry import cameras
from ..imu import preintegration as pre_mod
from ..optim import ba, global_ba
from ..optim.reprojection import RigParams
from ..ops import compact_indices, last_occurrence, scatter_max, set_rows
from ..slam_map import map_state as ms
from ..solvers import pnp as pnp_mod


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


def _best_per_keyframe(m: ms.MapState, desc, t_valid):
    """[N, K] int32: each query descriptor's smallest Hamming distance
    among the features of every keyframe that `t_valid` [K, F] admits
    (1 << 20 where none). One dense product against all K*F keyframe
    features."""
    K, F = m.kf_obs.shape
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

    pos_new = m.mp_pos[new_ids]
    d3 = torch.linalg.norm(pos_new[:, None, :] - m.mp_pos[None, :, :],
                           dim=-1)
    gate = rel_dist_th * torch.clamp(torch.linalg.norm(pos_new, dim=-1),
                                     min=1.0)[:, None]
    near = (d3 < gate) & old_mask[None, :]
    hd = matcher.hamming_matrix(m.mp_desc[new_ids], m.mp_desc)
    cand = near & (hd < desc_th)
    bi, bv = matcher.masked_argmin((d3 * 1000.0).to(torch.int32), cand)
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
    K = m.kf_R.shape[0]
    fixed = (torch.arange(K, device=m.kf_valid.device) < 2) | ~m.kf_valid
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
    K = m.kf_R.shape[0]
    idx = torch.arange(K, device=m.kf_valid.device)
    kf_in = m.kf_valid & (idx < m.n_kf)
    edge_ok = edge_valid & kf_in[1:] & kf_in[:-1]
    # relinearize each interval at its own keyframe's current bias
    # (first-order Reintegrate analog, reference: src/ImuTypes.cc:152)
    bias_k = torch.cat([m.kf_bg, m.kf_ba], dim=-1)[:-1]
    edges = ba.InertialEdges(pre=pre_mod.rebias(pre_b, bias_k),
                             valid=edge_ok)
    fixed = (idx < 1) | ~m.kf_valid
    state, inlier, chi = global_ba.global_bundle_adjust(
        _whole_map_state(m), obs, rig, fixed, point_fixed=~observed,
        edges=edges, stages=stages, cg_iters=cg_iters)
    m = _writeback_gba(m, state, inlier, chi, observed, kf_local, feat,
                       obs.valid, with_imu=True)
    return m, chi


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
