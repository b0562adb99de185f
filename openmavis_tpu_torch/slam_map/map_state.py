"""Device-resident SLAM map: fixed-capacity structure-of-arrays slabs
(port of `MapState`, `allocate`, `add_loop_edge`, `covisibility_matrix`,
`insert_keyframe`, `update_mp_geometry`, `compact_keyframes`,
`compact_landmarks`, `decimate_keyframes` and `predict_scale_level` of
`openmavis_tpu/slam_map/map_state.py`;
reference: the KF/MP pointer graph of src/Map.cc, src/KeyFrame.cc,
src/MapPoint.cc), and `write_new_landmarks`, the landmark allocation that
the stereo, temporal and depth spawns share.

Keyframes and landmarks live in pre-allocated tensors with validity masks;
`kf_obs` [K, F] holds the landmark id per keyframe feature (-1 = none).
Updates are functional: a function returns a new `MapState` and never
writes into the tensors of the one it was given, so a caller can keep the
old state (the rig-init branch does).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import scatter_max, set_rows
from . import bow


class MapState(NamedTuple):
    # --- keyframes ---
    kf_R: torch.Tensor        # [K,3,3] world-from-body rotation
    kf_t: torch.Tensor        # [K,3]
    kf_v: torch.Tensor        # [K,3]
    kf_bg: torch.Tensor       # [K,3]
    kf_ba: torch.Tensor       # [K,3]
    kf_time: torch.Tensor     # [K]
    kf_valid: torch.Tensor    # [K] bool
    # --- per-keyframe features ---
    kf_xy: torch.Tensor       # [K,F,2]
    kf_desc: torch.Tensor     # [K,F,256] int8 {0,1}
    kf_level: torch.Tensor    # [K,F] int32
    kf_sigma2: torch.Tensor   # [K,F]
    kf_cam: torch.Tensor      # [K,F] int32
    kf_feat_valid: torch.Tensor  # [K,F] bool
    kf_obs: torch.Tensor      # [K,F] int32 landmark id or -1
    kf_bow: torch.Tensor      # [K, bow.W] int8
    # --- landmarks ---
    mp_pos: torch.Tensor      # [M,3]
    mp_desc: torch.Tensor     # [M,256] int8
    mp_normal: torch.Tensor   # [M,3]
    mp_dmin: torch.Tensor     # [M]
    mp_dmax: torch.Tensor     # [M]
    mp_valid: torch.Tensor    # [M] bool
    mp_visible: torch.Tensor  # [M] int32
    mp_found: torch.Tensor    # [M] int32
    mp_first_kf: torch.Tensor  # [M] int32
    mp_last_kf: torch.Tensor   # [M] int32
    # --- persistent loop/merge edges (written by loop closing) ---
    loop_i: torch.Tensor      # [L] int32
    loop_j: torch.Tensor      # [L] int32
    loop_valid: torch.Tensor  # [L] bool
    # --- counters ---
    n_kf: torch.Tensor        # [] int32
    n_mp: torch.Tensor        # [] int32
    n_loop: torch.Tensor      # [] int32


MAX_LOOP_EDGES = 16


def allocate(max_kf: int, max_feat: int, max_mp: int,
             device=None, dtype=torch.float32) -> MapState:
    K, F, M = max_kf, max_feat, max_mp
    i32, dev = torch.int32, resolve_device(device)

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)

    return MapState(
        kf_R=torch.eye(3, dtype=dtype, device=dev).repeat(K, 1, 1),
        kf_t=z(K, 3), kf_v=z(K, 3), kf_bg=z(K, 3), kf_ba=z(K, 3),
        kf_time=z(K), kf_valid=z(K, dt=torch.bool),
        kf_xy=z(K, F, 2), kf_desc=z(K, F, 256, dt=torch.int8),
        kf_level=z(K, F, dt=i32), kf_sigma2=full((K, F), 1.0, dtype),
        kf_cam=z(K, F, dt=i32), kf_feat_valid=z(K, F, dt=torch.bool),
        kf_obs=full((K, F), -1, i32),
        kf_bow=z(K, bow.W, dt=torch.int8),
        mp_pos=z(M, 3), mp_desc=z(M, 256, dt=torch.int8),
        mp_normal=z(M, 3), mp_dmin=z(M), mp_dmax=full((M,), 1e9, dtype),
        mp_valid=z(M, dt=torch.bool), mp_visible=z(M, dt=i32),
        mp_found=z(M, dt=i32), mp_first_kf=z(M, dt=i32),
        mp_last_kf=z(M, dt=i32),
        loop_i=full((MAX_LOOP_EDGES,), -1, i32),
        loop_j=full((MAX_LOOP_EDGES,), -1, i32),
        loop_valid=z(MAX_LOOP_EDGES, dt=torch.bool),
        n_kf=z(dt=i32), n_mp=z(dt=i32), n_loop=z(dt=i32),
    )


def add_loop_edge(m: MapState, i, j) -> MapState:
    """Record an accepted loop constraint between keyframe slots `i` and
    `j` (ring buffer over MAX_LOOP_EDGES)."""
    slot = torch.remainder(m.n_loop, m.loop_i.shape[0]).to(torch.int64)
    return m._replace(
        loop_i=set_rows(m.loop_i, slot, i),
        loop_j=set_rows(m.loop_j, slot, j),
        loop_valid=set_rows(m.loop_valid, slot, True),
        n_loop=m.n_loop + 1)


def covisibility_matrix(m: MapState) -> torch.Tensor:
    """[K, K] int32 count of shared landmarks between keyframes: one
    incidence product in place of KeyFrame::UpdateConnections' per-point
    counting loops (reference: src/KeyFrame.cc). The float32 incidence
    holds 0/1, so the product is exact (counts < 2^24)."""
    K, F = m.kf_obs.shape
    M = m.mp_pos.shape[0]
    valid_obs = (m.kf_obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    mp = torch.where(valid_obs, m.kf_obs, M).to(torch.int64)  # dump column
    inc = torch.zeros((K, M + 1), dtype=torch.float32,
                      device=m.kf_obs.device)
    inc.scatter_(1, mp, valid_obs.to(torch.float32))
    inc = inc[:, :M]
    cov = (inc @ inc.T).to(torch.int32)
    return cov - torch.diag(torch.diagonal(cov))


def insert_keyframe(m: MapState, slot: int, R, t, v, bg, ba, time,
                    xy, desc, level, sigma2, cam, feat_valid,
                    obs) -> MapState:
    """Write a keyframe into `slot` and update landmark statistics
    (Tracking::CreateNewKeyFrame + LocalMapping::ProcessNewKeyFrame).
    `obs` [F]: matched landmark id per feature (-1 = none)."""
    m = m._replace(
        kf_R=set_rows(m.kf_R, slot, R),
        kf_t=set_rows(m.kf_t, slot, t),
        kf_v=set_rows(m.kf_v, slot, v),
        kf_bg=set_rows(m.kf_bg, slot, bg),
        kf_ba=set_rows(m.kf_ba, slot, ba),
        kf_time=set_rows(m.kf_time, slot, time),
        kf_valid=set_rows(m.kf_valid, slot, True),
        kf_xy=set_rows(m.kf_xy, slot, xy),
        kf_desc=set_rows(m.kf_desc, slot, desc),
        kf_level=set_rows(m.kf_level, slot, level),
        kf_sigma2=set_rows(m.kf_sigma2, slot, sigma2),
        kf_cam=set_rows(m.kf_cam, slot, cam),
        kf_feat_valid=set_rows(m.kf_feat_valid, slot, feat_valid),
        kf_obs=set_rows(m.kf_obs, slot, obs),
        kf_bow=set_rows(m.kf_bow, slot, bow.histogram(desc, feat_valid)),
        n_kf=torch.clamp(m.n_kf, min=slot + 1),
    )
    # bump found counters and refresh descriptors of observed landmarks
    # (latest-observation descriptor, the reference package's streaming
    # stand-in for MapPoint::ComputeDistinctiveDescriptors); row M is the
    # dump row of unobserved features
    M = m.mp_pos.shape[0]
    has = obs >= 0
    tgt = torch.where(has, obs, M).to(torch.int64)
    found = torch.zeros(M + 1, dtype=torch.int32, device=obs.device)
    found.index_add_(0, tgt, torch.ones_like(obs))
    new_desc = torch.zeros((M + 1, 256), dtype=torch.int8,
                           device=obs.device)
    new_desc[tgt] = desc
    touched = torch.zeros(M + 1, dtype=torch.bool, device=obs.device)
    touched[tgt] = has
    touched = touched[:M]
    return m._replace(
        mp_found=m.mp_found + found[:M],
        mp_desc=torch.where(touched[:, None], new_desc[:M], m.mp_desc),
        mp_last_kf=torch.where(touched, torch.full_like(m.mp_last_kf, slot),
                               m.mp_last_kf))


def write_new_landmarks(m: MapState, good, X_w, desc, slot_new: int,
                         cap_new: int):
    """Allocate up to `cap_new` landmark slots after n_mp for the `good`
    rows, in row order (dump row M for the rest): the shared tail of the
    spawn functions (stereo, temporal, depth).
    Returns (m', slot_mp [F], write [F], n_written)."""
    M = m.mp_pos.shape[0]
    order = torch.cumsum(good.to(torch.int32), 0) - 1
    slot_mp = m.n_mp + order
    write = good & (order < cap_new) & (slot_mp < M)
    tgt = torch.where(write, slot_mp, M).to(torch.int64)
    dev = good.device
    mp_pos = torch.zeros((M + 1, 3), dtype=m.mp_pos.dtype, device=dev)
    mp_pos[tgt] = X_w
    mp_desc = torch.zeros((M + 1, 256), dtype=torch.int8, device=dev)
    mp_desc[tgt] = desc
    newly = torch.zeros(M + 1, dtype=torch.bool, device=dev)
    newly[tgt] = write
    newly = newly[:M]
    n = torch.sum(write, dtype=torch.int32)
    slot_t = torch.full_like(m.mp_first_kf, slot_new)
    m = m._replace(
        mp_pos=torch.where(newly[:, None], mp_pos[:M], m.mp_pos),
        mp_desc=torch.where(newly[:, None], mp_desc[:M], m.mp_desc),
        mp_valid=m.mp_valid | newly,
        mp_first_kf=torch.where(newly, slot_t, m.mp_first_kf),
        mp_last_kf=torch.where(newly, slot_t, m.mp_last_kf),
        n_mp=m.n_mp + n)
    return m, slot_mp.to(torch.int32), write, n


def update_mp_geometry(m: MapState, scale: float = 1.2,
                       n_levels: int = 8) -> MapState:
    """Refresh landmark normals and scale-invariance ranges from their
    observing keyframes (reference: MapPoint::UpdateNormalAndDepth).

    The normal sums are a float scatter-add, which runs as atomics in an
    order that varies between CUDA runs (last-bit differences)."""
    K, F = m.kf_obs.shape
    M = m.mp_pos.shape[0]
    valid_obs = (m.kf_obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
    mp = torch.where(valid_obs, m.kf_obs, M).to(torch.int64)
    centers = m.kf_t[:, None, :].expand(K, F, 3)
    dirs = m.mp_pos[torch.clamp(mp, max=M - 1)] - centers
    dist = torch.linalg.norm(dirs, dim=-1)
    dirs = dirs / torch.clamp(dist[..., None], min=1e-9)
    w = valid_obs.to(m.mp_pos.dtype)

    flat_mp = mp.reshape(-1)
    acc4 = torch.zeros((M + 1, 4), dtype=m.mp_pos.dtype,
                       device=m.mp_pos.device)
    acc4.index_add_(0, flat_mp, torch.cat(
        [(dirs * w[..., None]).reshape(-1, 3), w.reshape(-1, 1)], dim=-1))
    cnt = acc4[:M, 3]
    normal = acc4[:M, :3] / torch.clamp(cnt[:, None], min=1.0)

    dist_eff = torch.where(valid_obs, dist, torch.zeros_like(dist))
    level_factor = torch.pow(scale, m.kf_level.to(m.mp_pos.dtype))
    dmax = torch.zeros(M + 1, dtype=m.mp_pos.dtype,
                       device=m.mp_pos.device).scatter_reduce(
        0, flat_mp, (dist_eff * level_factor).reshape(-1), "amax")[:M]
    dmin = dmax / (scale ** (n_levels - 1))
    has_obs = cnt > 0
    return m._replace(
        mp_normal=torch.where(has_obs[:, None], normal, m.mp_normal),
        mp_dmax=torch.where(has_obs, torch.clamp(dmax, min=1e-3),
                            m.mp_dmax),
        mp_dmin=torch.where(has_obs, torch.clamp(dmin, min=1e-4),
                            m.mp_dmin))


def _pack_order(valid: torch.Tensor):
    """For a validity mask [n]: (order [n] int32 packed position of each
    entry, n_valid [] int32, old_of_new [n] int64 entry at each packed
    position, 0 beyond n_valid, used [n] bool)."""
    n = valid.shape[0]
    dev = valid.device
    order = torch.cumsum(valid.to(torch.int32), 0, dtype=torch.int32) - 1
    n_valid = torch.sum(valid, dtype=torch.int32)
    # invalid entries write to the dump row n
    old_of_new = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    old_of_new[torch.where(valid, order, n).to(torch.int64)] = \
        torch.arange(n, device=dev)
    used = torch.arange(n, device=dev) < n_valid
    return order, n_valid, old_of_new[:n], used


def compact_keyframes(m: MapState):
    """Pack valid keyframes to the front of the slab, preserving temporal
    order, so culled slots become reusable (the slab's stand-in for
    KeyFrame::SetBadFlag + erase, src/LocalMapping.cc:974).

    Returns (m', old_of_new [K] int32, new_of_old [K] int32):
    `new_of_old[k]` is the new slot of old keyframe k, or of the nearest
    preceding valid keyframe if k was culled (so relative-pose trajectory
    references stay meaningful), clamped to 0."""
    K = m.kf_obs.shape[0]
    valid = m.kf_valid
    order, n_valid, old_of_new, used = _pack_order(valid)
    new_of_old = torch.clamp(order, min=0)

    def gather(x):
        return x[old_of_new]

    def remap(slots):
        return new_of_old[torch.clamp(slots, 0, K - 1).to(torch.int64)]

    # loop edges follow their endpoints; an edge dies with either endpoint
    li = torch.clamp(m.loop_i, 0, K - 1).to(torch.int64)
    lj = torch.clamp(m.loop_j, 0, K - 1).to(torch.int64)
    le_ok = (m.loop_valid & (m.loop_i >= 0) & (m.loop_j >= 0)
             & valid[li] & valid[lj])
    gone = torch.full_like(m.loop_i, -1)
    m2 = m._replace(
        kf_R=gather(m.kf_R), kf_t=gather(m.kf_t), kf_v=gather(m.kf_v),
        kf_bg=gather(m.kf_bg), kf_ba=gather(m.kf_ba),
        kf_time=gather(m.kf_time), kf_valid=used,
        kf_xy=gather(m.kf_xy), kf_desc=gather(m.kf_desc),
        kf_level=gather(m.kf_level), kf_sigma2=gather(m.kf_sigma2),
        kf_cam=gather(m.kf_cam),
        kf_feat_valid=gather(m.kf_feat_valid) & used[:, None],
        kf_obs=torch.where(used[:, None], gather(m.kf_obs), -1),
        kf_bow=torch.where(used[:, None], gather(m.kf_bow), 0),
        mp_first_kf=remap(m.mp_first_kf), mp_last_kf=remap(m.mp_last_kf),
        loop_i=torch.where(le_ok, new_of_old[li], gone),
        loop_j=torch.where(le_ok, new_of_old[lj], gone),
        loop_valid=le_ok, n_kf=n_valid)
    return m2, old_of_new.to(torch.int32), new_of_old


def compact_landmarks(m: MapState):
    """Pack valid landmarks to the front and remap the observation table.
    Returns (m', n_valid [] int32)."""
    valid = m.mp_valid
    order, n_valid, old_of_new, used = _pack_order(valid)
    new_of_old = torch.where(valid, order, -1)       # -1 for culled

    def gather(x):
        return x[old_of_new]

    def gather_used(x):
        return torch.where(used, gather(x), 0)

    obs = m.kf_obs
    obs = torch.where(obs >= 0,
                      new_of_old[torch.clamp(obs, min=0).to(torch.int64)],
                      -1)
    return m._replace(
        mp_pos=gather(m.mp_pos), mp_desc=gather(m.mp_desc),
        mp_normal=gather(m.mp_normal), mp_dmin=gather(m.mp_dmin),
        mp_dmax=gather(m.mp_dmax), mp_valid=used,
        mp_visible=gather_used(m.mp_visible),
        mp_found=gather_used(m.mp_found),
        mp_first_kf=gather_used(m.mp_first_kf),
        mp_last_kf=gather_used(m.mp_last_kf),
        kf_obs=obs, n_mp=n_valid), n_valid


def decimate_keyframes(m: MapState, current_slot: int, keep_recent: int = 8,
                       keep_first: int = 2):
    """Emergency slot reclamation when the slab is full and redundancy
    culling freed nothing: invalidate every second keyframe in the old
    half of the history, except the endpoints of loop edges (they hold
    the closed-loop topology). Returns (m', drop [K] bool)."""
    K = m.kf_obs.shape[0]
    dev = m.kf_valid.device
    idx = torch.arange(K, device=dev)
    protected = ((idx < keep_first) | (idx > current_slot - keep_recent)
                 | ~m.kf_valid)
    drop = ~protected & (idx < current_slot // 2) & (idx % 2 == 1)
    anchor = torch.zeros(K, dtype=torch.bool, device=dev)
    for ends in (m.loop_i, m.loop_j):
        anchor = scatter_max(anchor, torch.clamp(ends, 0, K - 1),
                             m.loop_valid & (ends >= 0))
    drop = drop & ~anchor
    return m._replace(kf_valid=m.kf_valid & ~drop,
                      kf_obs=torch.where(drop[:, None], -1, m.kf_obs)), drop


def predict_scale_level(dist, dmax, scale: float = 1.2,
                        n_levels: int = 8) -> torch.Tensor:
    """Predicted pyramid level from distance (MapPoint::PredictScale)."""
    ratio = dmax / torch.clamp(dist, min=1e-6)
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-6))
                     / float(np.float32(np.log(scale))))
    return torch.clamp(lvl.to(torch.int32), 0, n_levels - 1)
