"""Depth-map measurements: RGB-D pseudo-stereo and depth priors (port of
`openmavis_tpu/frontend/depth.py`; reference:
  - `Frame::ComputeStereoFromRGBD` (src/Frame.cc — depth sampled at
    keypoints becomes a virtual right-image coordinate mvuRight),
  - `Frame::GetDepthFromUndistortedPoints` (src/Frame.cc:1659-1765 —
    fisheye keypoints are undistorted through a virtual pinhole to sample
    externally produced depth maps in the multi-camera pipeline),
  - depth-based landmark creation in `Tracking::StereoInitialization` /
    `CreateNewKeyFrame` (src/Tracking.cc:2232-2337, 3159 — close points are
    spawned directly from depth instead of waiting for parallax)).

All functions are batched over keypoints with fixed shapes and validity
masks.
"""

from __future__ import annotations

import torch

from ..geometry import cameras
from ..ops import set_rows
from ..slam_map import map_state as ms


def sample_depth(depth: torch.Tensor, xy: torch.Tensor,
                 min_d: float = 0.05, max_d: float = 40.0):
    """Bilinearly sample a depth map at pixel coords.

    Zero and out-of-range depths are holes: a sample is valid only if all
    four bilinear neighbours are in range (as conservative as the
    reference's nearest-pixel lookup).

    depth: [H, W] float32, 0 = no measurement; xy: [K, 2] pixels (x, y).
    Returns (d [K] float32, valid [K] bool)."""
    H, W = depth.shape
    x, y = xy[:, 0], xy[:, 1]
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    inb = (x0 >= 0) & (x0 + 1 <= W - 1) & (y0 >= 0) & (y0 + 1 <= H - 1)
    x0c = torch.clamp(x0, 0, W - 2)
    y0c = torch.clamp(y0, 0, H - 2)
    fx = x - x0c
    fy = y - y0c
    d00 = depth[y0c, x0c]
    d01 = depth[y0c, x0c + 1]
    d10 = depth[y0c + 1, x0c]
    d11 = depth[y0c + 1, x0c + 1]
    ok = ((d00 > min_d) & (d01 > min_d) & (d10 > min_d) & (d11 > min_d)
          & (d00 < max_d) & (d01 < max_d) & (d10 < max_d) & (d11 < max_d))
    d = (d00 * (1 - fx) * (1 - fy) + d01 * fx * (1 - fy)
         + d10 * (1 - fx) * fy + d11 * fx * fy)
    return d, inb & ok


def sample_depth_undistorted(depth: torch.Tensor, xy: torch.Tensor,
                             cam_kind: int, cam_params: torch.Tensor,
                             pin_params: torch.Tensor,
                             min_d: float = 0.05, max_d: float = 40.0):
    """Sample a depth map that lives in a *virtual undistorted pinhole*
    frame at keypoints detected on the raw (e.g. fisheye) image
    (reference: Frame::GetDepthFromUndistortedPoints,
    src/Frame.cc:1659-1765, which hard-codes the virtual pinholes per
    camera; here they are `pin_params`).

    The returned depth is the z-coordinate along the keypoint's ray in the
    REAL camera frame, so `ray * d / ray_z` backprojects correctly.
    Returns (d [K], valid [K])."""
    ray = cameras.unproject(cam_kind, cam_params, xy)        # [K, 3]
    z = ray[:, 2]
    front = z > 1e-6
    uv_pin = cameras.pinhole_project(
        pin_params, ray / torch.clamp(z, min=1e-6)[:, None])
    d, ok = sample_depth(depth, uv_pin, min_d, max_d)
    return d, ok & front


def backproject(cam_kind: int, cam_params: torch.Tensor, xy: torch.Tensor,
                d: torch.Tensor) -> torch.Tensor:
    """Lift keypoints to camera-frame points at z-depth d (any camera
    model: unproject to a ray, scale so that z == d). Returns [K, 3]."""
    ray = cameras.unproject(cam_kind, cam_params, xy)
    z = torch.clamp(ray[:, 2:3], min=1e-6)
    return ray / z * d[:, None]


def depth_to_uright(xy: torch.Tensor, d: torch.Tensor, bf: float):
    """Virtual right-image u-coordinate from depth (mvuRight convention;
    reference: Frame::ComputeStereoFromRGBD — u_r = u - bf / d with
    bf = fx * baseline)."""
    return xy[:, 0] - bf / torch.clamp(d, min=1e-6)


def _spawn_world_points(m: ms.MapState, slot: int, p_w: torch.Tensor,
                        good: torch.Tensor, cap_new: int):
    """Write up to `cap_new` new landmarks at world points `p_w` for
    keyframe `slot`'s features flagged `good`, bind them, and refresh the
    landmark geometry (shared tail of the depth-spawn entry points).
    Returns (m, n_spawned)."""
    m2, slot_mp, write, n = ms.write_new_landmarks(
        m, good, p_w, m.kf_desc[slot], slot, cap_new)
    m2 = m2._replace(kf_obs=set_rows(
        m.kf_obs, slot, torch.where(write, slot_mp, m.kf_obs[slot])))
    return ms.update_mp_geometry(m2), n


def _body_to_world(m: ms.MapState, slot: int, p_b: torch.Tensor):
    return (torch.einsum("ij,fj->fi", m.kf_R[slot], p_b)
            + m.kf_t[slot])


def spawn_from_depth(m: ms.MapState, slot: int, cam_kind: int, cam_params,
                     R_cb, t_cb, d: torch.Tensor, d_valid: torch.Tensor,
                     cap_new: int, max_spawn_depth: float = 25.0):
    """Create landmarks for a keyframe's unbound features from measured
    depth (no parallax needed; reference: Tracking::CreateNewKeyFrame's
    depth-sorted point creation and StereoInitialization,
    src/Tracking.cc:2232-2337).

    m: keyframe `slot` already inserted; cam_params / R_cb / t_cb:
    intrinsics and camera-from-body extrinsic of the features' camera;
    d: [F] z-depth per feature; d_valid: [F] bool. Returns (m, n)."""
    xy = m.kf_xy[slot]
    unbound = (m.kf_obs[slot] < 0) & m.kf_feat_valid[slot]
    good = unbound & d_valid & (d > 0.05) & (d < max_spawn_depth)
    p_c = backproject(cam_kind, cam_params, xy, d)
    # world point: p_w = R_wb (R_cb^T (p_c - t_cb)) + t_wb
    p_b = torch.einsum("ji,fj->fi", R_cb, p_c - t_cb)
    return _spawn_world_points(m, slot, _body_to_world(m, slot, p_b), good,
                               cap_new)


def spawn_from_depth_multi(m: ms.MapState, slot: int, rig_kind: int,
                           n_cams: int, rig, depth: torch.Tensor,
                           pin_params=None, cap_new: int = 256,
                           max_spawn_depth: float = 25.0):
    """Depth-prior landmarks for the multi-camera pipeline: every camera
    band's unbound features sample their camera's depth map and spawn
    landmarks at measured metric depth (reference: Frame.cc:1659-1765,
    sampled into pseudo-stereo for all bands at Frame.cc:1916-1922).

    depth: [C, H, W] per-camera z-depth maps, 0 = hole; pin_params:
    optional [C, >=4] virtual-pinhole intrinsics the depth maps live in
    (needed for fisheye rigs; None = the maps are in the raw camera frame,
    right for undistorted pinholes). Returns (m, n_spawned)."""
    F = m.kf_xy.shape[1]
    dev = m.kf_xy.device
    xy = m.kf_xy[slot]
    cam = m.kf_cam[slot]
    d = torch.zeros(F, device=dev)
    ok = torch.zeros(F, dtype=torch.bool, device=dev)
    p_b = torch.zeros((F, 3), device=dev)
    for c in range(n_cams):
        sel = cam == c
        if pin_params is None:
            dc, okc = sample_depth(depth[c], xy)
        else:
            dc, okc = sample_depth_undistorted(
                depth[c], xy, rig_kind, rig.params[c],
                torch.as_tensor(pin_params[c], dtype=torch.float32,
                                device=dev))
        pc = backproject(rig_kind, rig.params[c], xy, dc)
        pb = torch.einsum("ji,fj->fi", rig.R_cb[c], pc - rig.t_cb[c])
        d = torch.where(sel, dc, d)
        ok = torch.where(sel, okc, ok)
        p_b = torch.where(sel[:, None], pb, p_b)

    unbound = (m.kf_obs[slot] < 0) & m.kf_feat_valid[slot]
    good = unbound & ok & (d > 0.05) & (d < max_spawn_depth)
    return _spawn_world_points(m, slot, _body_to_world(m, slot, p_b), good,
                               cap_new)
