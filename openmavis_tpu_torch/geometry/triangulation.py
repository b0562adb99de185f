"""Batched checked two-ray triangulation (port of
`openmavis_tpu/geometry/triangulation.py`; reference:
KannalaBrandt8::TriangulateMatches, src/CameraModels/KannalaBrandt8.cpp, as
used by Frame::ComputeMultiFishEyeMatches, src/Frame.cc:1461-1527)."""

from __future__ import annotations

import torch

from . import cameras


def triangulate_dlt(P1, P2, x1, x2):
    """DLT triangulation from two [..., 3, 4] projection matrices and
    normalized image coordinates [..., 2]; returns [..., 3] points.

    The smallest eigenvector of A^T A has a free sign, which the
    homogeneous divide removes."""
    A = torch.stack([
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    X = V[..., :, 0]
    w = X[..., 3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w[..., None]


def triangulate_rays_midpoint(o1, d1, o2, d2):
    """Midpoint of the common perpendicular of two rays.
    Returns (point [..., 3], s1 [...], s2 [...]) with s_i the depths along
    each ray of the closest points."""
    b = torch.sum(d1 * d2, dim=-1)
    denom = 1.0 - b * b
    denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9),
                        denom)
    do = o2 - o1
    a1 = torch.sum(do * d1, dim=-1)
    a2 = torch.sum(do * d2, dim=-1)
    s1 = (a1 - b * a2) / denom
    s2 = (b * a1 - a2) / denom
    p1 = o1 + s1[..., None] * d1
    p2 = o2 + s2[..., None] * d2
    return 0.5 * (p1 + p2), s1, s2


def triangulate_matches(kind: int, params1, params2, R12, t12, uv1, uv2,
                        sigma_level1=None, sigma_level2=None,
                        min_cos_parallax: float = 0.9998,
                        reproj_chi2: float = 5.991):
    """Unproject both pixels, triangulate in the camera-1 frame, gate on
    parallax, cheirality and reprojection error in both images.

    R12, t12: pose of camera 2 in camera 1 (p_c1 = R12 p_c2 + t12).
    Returns (points_c1 [..., 3], depth1 [...], valid [...] bool)."""
    r1 = cameras.unproject(kind, params1, uv1)
    r2c2 = cameras.unproject(kind, params2, uv2)
    r2 = (R12 @ r2c2[..., None])[..., 0]
    o1 = torch.zeros_like(t12)
    o2 = t12

    cos_par = torch.sum(r1 * r2, dim=-1)
    p, s1, s2 = triangulate_rays_midpoint(o1, r1, o2, r2)

    uv1_hat = cameras.project(kind, params1, p)
    p_c2 = (R12.transpose(-1, -2) @ (p - t12)[..., None])[..., 0]
    uv2_hat = cameras.project(kind, params2, p_c2)
    e1 = torch.sum((uv1_hat - uv1) ** 2, dim=-1)
    e2 = torch.sum((uv2_hat - uv2) ** 2, dim=-1)
    s1v = torch.ones_like(e1) if sigma_level1 is None else sigma_level1
    s2v = torch.ones_like(e2) if sigma_level2 is None else sigma_level2

    valid = ((cos_par < min_cos_parallax)
             & (s1 > 0) & (s2 > 0)
             & (p[..., 2] > 0) & (p_c2[..., 2] > 0)
             & (e1 < reproj_chi2 * s1v)
             & (e2 < reproj_chi2 * s2v))
    return p, s1, valid


def stereo_depth_from_point(p_c1, baseline_dir=None):
    """Depth along the optical axis of camera 1."""
    return p_c1[..., 2]
