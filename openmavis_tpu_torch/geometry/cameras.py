"""Batched camera models: pinhole and Kannala-Brandt8 on torch tensors.

Port of `openmavis_tpu/geometry/cameras.py` (reference:
src/CameraModels/Pinhole.cpp, KannalaBrandt8.cpp). Each model is a set of
functions over a parameter vector; the model kind is a Python int chosen by
the caller.

Parameter layout (last axis): pinhole ``[fx, fy, cx, cy]`` (+ ignored
tail), KB8 ``[fx, fy, cx, cy, k0, k1, k2, k3]``. Projections return pixels
``[..., 2]``; unprojections return unit bearings ``[..., 3]``.
"""

from __future__ import annotations

import math

import torch

PINHOLE = 0
KB8 = 1

_EPS = 1e-8


def _guard(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)


# ---------------------------------------------------------------------------
# Pinhole
# ---------------------------------------------------------------------------

def pinhole_project(params: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    inv_z = 1.0 / _guard(p[..., 2])
    return torch.stack([fx * p[..., 0] * inv_z + cx,
                        fy * p[..., 1] * inv_z + cy], dim=-1)


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def pinhole_project_jac(params: torch.Tensor, p: torch.Tensor):
    """d(uv)/d(p): [..., 2, 3] (reference: Pinhole::projectJac)."""
    fx, fy = params[..., 0], params[..., 1]
    x, y = p[..., 0], p[..., 1]
    inv_z = 1.0 / _guard(p[..., 2])
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row_u = torch.stack([fx * inv_z + zero, zero, -fx * x * inv_z2], dim=-1)
    row_v = torch.stack([zero, fy * inv_z + zero, -fy * y * inv_z2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


# ---------------------------------------------------------------------------
# Radial-tangential distortion (keypoint undistortion as the reference's
# Frame::UndistortKeyPoints via cv::undistortPoints)
# ---------------------------------------------------------------------------

def radtan_distort(dist: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply [k1, k2, p1, p2] distortion to normalized coords [..., 2]."""
    k1, k2, p1, p2 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def radtan_undistort(dist: torch.Tensor, xy_d: torch.Tensor,
                     iters: int = 8) -> torch.Tensor:
    """Invert radtan by fixed-point iteration (a fixed trip count)."""
    k1, k2, p1, p2 = dist[..., 0], dist[..., 1], dist[..., 2], dist[..., 3]
    xd, yd = xy_d[..., 0], xy_d[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x, y], dim=-1)


def undistort_pixels(params: torch.Tensor, dist: torch.Tensor,
                     uv: torch.Tensor) -> torch.Tensor:
    """Distorted pixels -> ideal-pinhole pixels with the same K."""
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    xy_d = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy],
                       dim=-1)
    xy = radtan_undistort(dist, xy_d)
    return torch.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], dim=-1)


# ---------------------------------------------------------------------------
# Kannala-Brandt 8 (equidistant fisheye)
# ---------------------------------------------------------------------------

def _kb8_theta_d(k: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[..., 0] + t2 * (
        k[..., 1] + t2 * (k[..., 2] + t2 * k[..., 3]))))


def _kb8_theta_d_prime(k: torch.Tensor, theta: torch.Tensor):
    t2 = theta * theta
    return 1.0 + t2 * (3 * k[..., 0] + t2 * (
        5 * k[..., 1] + t2 * (7 * k[..., 2] + t2 * 9 * k[..., 3])))


def kb8_project(params: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(reference: KannalaBrandt8::project)"""
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    k = params[..., 4:8]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=_EPS * _EPS))
    theta = torch.atan2(r, z)
    theta_d = _kb8_theta_d(k, theta)
    s = torch.where(r2 < _EPS, 1.0 / _guard(z), theta_d / r)
    return torch.stack([fx * s * x + cx, fy * s * y + cy], dim=-1)


def kb8_unproject(params: torch.Tensor, uv: torch.Tensor,
                  iters: int = 10) -> torch.Tensor:
    """Unit bearing via a fixed 10-step Newton solve on theta (reference:
    KannalaBrandt8::unprojectEig)."""
    fx, fy, cx, cy = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    k = params[..., 4:8]
    wx = (uv[..., 0] - cx) / fx
    wy = (uv[..., 1] - cy) / fy
    theta_d = torch.sqrt(wx * wx + wy * wy)
    theta = theta_d
    for _ in range(iters):
        f = _kb8_theta_d(k, theta) - theta_d
        fp = _kb8_theta_d_prime(k, theta)
        theta = theta - f / _guard(fp)
    theta = torch.clamp(theta, 0.0, math.pi)
    scale = torch.where(theta_d < _EPS, torch.ones_like(theta_d),
                        torch.sin(theta) / torch.clamp(theta_d, min=_EPS))
    ray = torch.stack([wx * scale, wy * scale, torch.cos(theta)], dim=-1)
    return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)


def kb8_project_jac(params: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Analytic d(uv)/d(p): [..., 2, 3] (reference:
    KannalaBrandt8::projectJac); pinhole Jacobian on the optical axis."""
    fx, fy = params[..., 0], params[..., 1]
    k = params[..., 4:8]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=_EPS * _EPS))
    rho2 = r2 + z * z
    theta = torch.atan2(r, z)
    theta_d = _kb8_theta_d(k, theta)
    dtd = _kb8_theta_d_prime(k, theta)

    dth_dx = z * x / (rho2 * r)
    dth_dy = z * y / (rho2 * r)
    dth_dz = -r / rho2
    inv_r3 = 1.0 / (r * r2)
    dxr_dx = y * y * inv_r3
    dxr_dy = -x * y * inv_r3
    dyr_dy = x * x * inv_r3
    dyr_dx = dxr_dy

    xr = x / r
    yr = y / r
    du_dx = fx * (dtd * dth_dx * xr + theta_d * dxr_dx)
    du_dy = fx * (dtd * dth_dy * xr + theta_d * dxr_dy)
    du_dz = fx * (dtd * dth_dz * xr)
    dv_dx = fy * (dtd * dth_dx * yr + theta_d * dyr_dx)
    dv_dy = fy * (dtd * dth_dy * yr + theta_d * dyr_dy)
    dv_dz = fy * (dtd * dth_dz * yr)
    jac = torch.stack([torch.stack([du_dx, du_dy, du_dz], dim=-1),
                       torch.stack([dv_dx, dv_dy, dv_dz], dim=-1)], dim=-2)
    on_axis = (r2 < _EPS)[..., None, None]
    return torch.where(on_axis, pinhole_project_jac(params, p), jac)


# ---------------------------------------------------------------------------
# Dispatch (kind is a Python int)
# ---------------------------------------------------------------------------

def project(kind: int, params: torch.Tensor, p: torch.Tensor):
    if kind == PINHOLE:
        return pinhole_project(params, p)
    if kind == KB8:
        return kb8_project(params, p)
    raise ValueError(f"unknown camera kind {kind}")


def unproject(kind: int, params: torch.Tensor, uv: torch.Tensor):
    if kind == PINHOLE:
        return pinhole_unproject(params, uv)
    if kind == KB8:
        return kb8_unproject(params, uv)
    raise ValueError(f"unknown camera kind {kind}")


def project_jac(kind: int, params: torch.Tensor, p: torch.Tensor):
    if kind == PINHOLE:
        return pinhole_project_jac(params, p)
    if kind == KB8:
        return kb8_project_jac(params, p)
    raise ValueError(f"unknown camera kind {kind}")
