"""Batched RANSAC PnP for relocalization, MLPnP nullspace formulation
(port of `openmavis_tpu/solvers/pnp.py`; reference: src/MLPnPsolver.cpp:15,
Urban et al. "MLPnP", used only by Tracking::Relocalization,
src/Tracking.cc:3564-3593).

Hypotheses are a batch axis; each is a 6+ point linear resection built from
the nullspace constraints of each bearing (r_i^T (R p_i + t) = 0 and
s_i^T (R p_i + t) = 0 with [r_i, s_i] an orthonormal basis of the bearing's
tangent plane), scored by bearing-space reprojection against all
correspondences, with per-point covariance weighting in the refit. The
tangent-basis rows are orthonormal for every bearing direction, where the
classical cross-product rows shrink towards the optical axis' poles, so the
solver works on fisheye bearings as on pinhole ones.

The reference package draws the samples from a PRNG key; here `ransac_pnp`
draws them from a `torch.Generator` (`draw_samples`) unless the caller
hands it `sample_idx`, so that a test can give both packages the same
samples.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def bearing_nullspace(bearing: torch.Tensor):
    """Orthonormal tangent basis (r, s) of each unit bearing [..., 3]
    (MLPnP's per-observation nullspace J = null(v^T)). The seed axis is
    chosen per bearing so the basis is defined for every direction."""
    v = bearing
    near_z = v[..., 2].abs() > 0.9
    seed = torch.where(near_z[..., None],
                       v.new_tensor([1.0, 0.0, 0.0]),
                       v.new_tensor([0.0, 0.0, 1.0]))
    r = torch.linalg.cross(v, seed.expand_as(v))
    r = r / torch.clamp(torch.linalg.norm(r, dim=-1, keepdim=True),
                        min=1e-9)
    return r, torch.linalg.cross(v, r)


def _polar(P: torch.Tensor):
    """Project [R|t] (up to positive scale) onto SE(3)."""
    Rraw, t = P[..., :3], P[..., 3]
    U, s, Vt = torch.linalg.svd(Rraw)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    R = U @ (D[..., None] * Vt)
    # Rraw ~ scale * R with scale = trace(R^T Rraw) / 3
    scale = torch.sum(s * D, dim=-1) / 3.0
    scale = torch.where(scale.abs() < 1e-9, torch.full_like(scale, 1e-9),
                        scale)
    return R, t / scale[..., None]


def _dlt_pose(p_w: torch.Tensor, bearing: torch.Tensor, w=None,
              formulation: str = "nullspace"):
    """Linear 6+ point resection, batched over hypotheses.

    p_w: [..., P, 3] world points; bearing: [..., P, 3] unit bearings in the
    camera frame. Solves for [R|t] (camera-from-world) up to scale.
    `formulation`: "nullspace" (MLPnP tangent-basis rows) or "cross"
    (classical cross-product DLT rows). `w` ([..., P], optional) weights
    each point's constraint rows, which lets the refit solve over an inlier
    subset without gathers. Returns (R [..., 3, 3], t [..., 3]).

    The solution is the eigenvector of the smallest eigenvalue, whose sign
    is the library's choice; the depth vote below picks between it and its
    negative."""
    pw_h = torch.cat([p_w, torch.ones_like(p_w[..., :1])], dim=-1)
    if formulation == "nullspace":
        rb, sb = bearing_nullspace(bearing)
        r1 = torch.cat([rb[..., 0:1] * pw_h, rb[..., 1:2] * pw_h,
                        rb[..., 2:3] * pw_h], dim=-1)        # [..., P, 12]
        r2 = torch.cat([sb[..., 0:1] * pw_h, sb[..., 1:2] * pw_h,
                        sb[..., 2:3] * pw_h], dim=-1)
    else:
        x, y, z = bearing[..., 0:1], bearing[..., 1:2], bearing[..., 2:3]
        zero = torch.zeros_like(pw_h)
        r1 = torch.cat([zero, -z * pw_h, y * pw_h], dim=-1)
        r2 = torch.cat([z * pw_h, zero, -x * pw_h], dim=-1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    A = torch.cat([r1, r2], dim=-2)                          # [..., 2P, 12]
    AtA = A.transpose(-1, -2) @ A
    # a non-finite AtA would make eigh raise; its pose gates no inlier
    _, V = torch.linalg.eigh(torch.nan_to_num(AtA))
    sol = V[..., :, 0]
    P = sol.reshape(*sol.shape[:-1], 3, 4)

    # the solution's global sign: the one that puts the sample points in
    # front of the camera, by majority vote on depth
    Rp, tp = _polar(P)
    Rn, tn = _polar(-P)
    zp = (p_w @ Rp.transpose(-1, -2) + tp[..., None, :])[..., 2]
    cnt = torch.ones_like(zp) if w is None else (w > 0).to(zp.dtype)
    pos = torch.sum((zp > 0).to(zp.dtype) * cnt, dim=-1)
    use_p = pos * 2 >= torch.sum(cnt, dim=-1)
    return (torch.where(use_p[..., None, None], Rp, Rn),
            torch.where(use_p[..., None], tp, tn))


class PnPResult(NamedTuple):
    success: torch.Tensor
    R_cw: torch.Tensor     # [3,3] camera-from-world
    t_cw: torch.Tensor     # [3]
    inlier: torch.Tensor   # [N]
    n_inliers: torch.Tensor


def _gate(R, t, p_w, bearing, valid, cos_th):
    """Inlier mask and count for one pose (or a leading batch of poses)."""
    pred = p_w @ R.transpose(-1, -2) + t[..., None, :]
    pred = pred / torch.clamp(torch.linalg.norm(pred, dim=-1, keepdim=True),
                              min=1e-9)
    cosang = torch.sum(pred * bearing, dim=-1)
    inl = (cosang > cos_th) & valid
    return inl, torch.sum(inl, dim=-1, dtype=torch.int32)


def draw_samples(gen: torch.Generator, valid: torch.Tensor, n_hyp: int = 512,
                 sample_size: int = 6) -> torch.Tensor:
    """[n_hyp, sample_size] int64 indices drawn with replacement, uniformly
    among the valid rows (an invalid row has probability zero). With no
    valid row the draw is uniform over all rows, and `ransac_pnp` then
    rejects every hypothesis for its invalid samples."""
    w = valid.to(torch.float32)
    w = w + (w.sum() <= 0).to(torch.float32)
    return torch.multinomial(w, n_hyp * sample_size, replacement=True,
                             generator=gen).reshape(n_hyp, sample_size)


def ransac_pnp(gen, p_w: torch.Tensor, bearing: torch.Tensor,
               valid: torch.Tensor, n_hyp: int = 512, sample_size: int = 6,
               cos_th: float = 0.9998, min_inliers: int = 12,
               lo_rounds: int = 2, sigma2=None,
               formulation: str = "nullspace",
               sample_idx=None) -> PnPResult:
    """LO-RANSAC resection from 3D-point <-> bearing matches.

    p_w: [N, 3]; bearing: [N, 3] unit camera-frame bearings; valid: [N];
    gen: the generator the samples are drawn from when `sample_idx`
    ([n_hyp, sample_size]) is not given.
    cos_th: inlier gate on the angle between observed and predicted
      bearings (0.9998 ~ 1.15 deg ~ a few pixels at f = 400).
    lo_rounds: the best hypothesis is refit by a weighted DLT over all its
      inliers and gated again, which rescues near-degenerate minimal
      samples.
    sigma2: optional [N] per-observation variance (keypoint pyramid-level
      sigma^2), the maximum-likelihood weighting of the reference's
      MLPnPsolver: the refit weights each point's rows by 1/sigma and the
      gate widens with sigma (capped at 4x)."""
    if sigma2 is not None:
        sig = torch.sqrt(torch.clamp(sigma2, min=1e-9))
        th0 = math.acos(min(cos_th, 1.0))
        cos_th = torch.cos(th0 * torch.clamp(sig, 1.0, 4.0))
        ml_w = 1.0 / sig
    else:
        ml_w = None

    idx = (draw_samples(gen, valid, n_hyp, sample_size)
           if sample_idx is None else sample_idx.to(torch.int64))
    R, t = _dlt_pose(p_w[idx], bearing[idx], formulation=formulation)
    inl, n_inl = _gate(R, t, p_w, bearing, valid[None, :], cos_th)
    # a hypothesis drawn from an invalid sample counts nothing
    bad = torch.any(~valid[idx], dim=-1)
    n_inl = torch.where(bad, 0, n_inl)
    best = torch.argmax(n_inl)
    R_b, t_b, inl_b, n_b = R[best], t[best], inl[best], n_inl[best]

    for _ in range(lo_rounds):
        w = inl_b.to(p_w.dtype)
        if ml_w is not None:
            w = w * ml_w
        R_r, t_r = _dlt_pose(p_w, bearing, w=w, formulation=formulation)
        inl_r, n_r = _gate(R_r, t_r, p_w, bearing, valid, cos_th)
        # >=: at equal support the all-inlier refit beats a minimal sample
        take = n_r >= n_b
        R_b = torch.where(take, R_r, R_b)
        t_b = torch.where(take, t_r, t_b)
        inl_b = torch.where(take, inl_r, inl_b)
        n_b = torch.where(take, n_r, n_b)

    return PnPResult(success=n_b >= min_inliers, R_cw=R_b, t_cw=t_b,
                     inlier=inl_b, n_inliers=n_b)
