"""Sim3 refinement by mutual reprojection (port of
`openmavis_tpu/optim/sim3_refine.py`; reference: Optimizer::OptimizeSim3,
src/Optimizer.cc:2460 — refinement of a loop-candidate Sim3 with
EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ pairs and chi2 outlier
removal; called from loop detection, src/LoopClosing.cc:899).

Given matched landmark pairs expressed in the two keyframes' body frames
and their observed keypoints, refine S_21 (body2-from-body1 similarity) by
Levenberg-Marquardt over the 7-dim tangent, minimizing both projections:
  r2 = project(cam, T_cb * S(p1)) - uv2      (forward edge)
  r1 = project(cam, T_cb * S^{-1}(p2)) - uv1 (inverse edge)
with Huber weighting and a chi2 gate matching the reference's th2=10.
Jacobians come from forward-mode autodiff (`torch.func.jacfwd`) through
the Sim3 chain: this runs only on loop candidates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from ..geometry import cameras, lie

# the reference's default, jnp.sqrt(10.0), is a float32
_HUBER = float(np.sqrt(np.float32(10.0)))


class Sim3RefineResult(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inlier: torch.Tensor     # [N] bool (passes chi2 in both directions)
    n_inliers: torch.Tensor
    chi2: torch.Tensor


def _residuals(dx, s, R, t, p1, p2, rig_kind, cam1, cam2,
               R_cb1, t_cb1, R_cb2, t_cb2):
    """Projections of both edges under the update exp(dx) * (s, R, t).
    cam1/cam2 [N,8], R_cb* [N,3,3], t_cb* [N,3]: per-match camera (the
    band each match was observed in). Returns (uv2_hat, uv1_hat,
    depth_ok)."""
    # a [1, 7] batch: under jacfwd a 0-d tensor divided by a Python float
    # promotes to float64 (torch.func), which the [1] shape avoids
    ds, dR, dt = lie.sim3_exp(dx[None])
    s_n, R_n, t_n = lie.sim3_compose(ds, dR, dt, s[None], R[None], t[None])
    si, Ri, ti = lie.sim3_inverse(s_n, R_n, t_n)
    # forward: p1 (body1) -> body2 -> cam2 -> uv2
    q2 = lie.sim3_apply(s_n, R_n, t_n, p1)
    c2 = lie._mv(R_cb2, q2) + t_cb2
    uv2_hat = cameras.project(rig_kind, cam2, c2)
    # inverse: p2 (body2) -> body1 -> cam1 -> uv1
    q1 = lie.sim3_apply(si, Ri, ti, p2)
    c1 = lie._mv(R_cb1, q1) + t_cb1
    uv1_hat = cameras.project(rig_kind, cam1, c1)
    depth_ok = (c2[:, 2] > 0.05) & (c1[:, 2] > 0.05)
    return uv2_hat, uv1_hat, depth_ok


def refine_sim3(s, R, t, p1, p2, uv1, uv2, sigma2_1, sigma2_2, valid,
                rig_kind: int, cam1, cam2, R_cb1, t_cb1, R_cb2, t_cb2,
                iters: int = 8, chi2_th: float = 9.99,
                huber: float = _HUBER, fix_scale: bool = False,
                scale_prior_weight: float = 1e3) -> Sim3RefineResult:
    """Refine S_21 from matched body-frame points + image observations.

    s, R, t: initial Sim3 (p2 = s R p1 + t), e.g. from ransac_sim3_reproj;
    p1, p2 [N,3] matched landmarks in each keyframe's body frame; uv1, uv2
    [N,2] their keypoints; sigma2_1, sigma2_2 [N] level variances; valid
    [N]; cam1, cam2 [N,8] with R_cb*/t_cb*: per-match intrinsics and
    extrinsics."""
    dtype, dev = t.dtype, t.device
    z7 = torch.zeros(7, dtype=dtype, device=dev)
    sig2 = torch.sqrt(sigma2_2)[:, None]
    sig1 = torch.sqrt(sigma2_1)[:, None]
    h2 = huber * huber

    def res_vec(st, dx):
        uv2_hat, uv1_hat, depth_ok = _residuals(
            dx, st[0], st[1], st[2], p1, p2, rig_kind, cam1, cam2,
            R_cb1, t_cb1, R_cb2, t_cb2)
        r = torch.cat([(uv2_hat - uv2) / sig2, (uv1_hat - uv1) / sig1],
                      dim=0)
        return r.reshape(-1), depth_ok

    # weak prior anchoring log-scale to the initial (Horn/RANSAC) value:
    # reprojection cannot observe scale when the relative translation is
    # near zero, but the 3D closed form already fixed it
    s_init = s

    def chi2_of(st):
        r, depth_ok = res_vec(st, z7)
        w_obs = (valid & depth_ok).repeat(2)
        e2 = torch.sum(r.reshape(-1, 2) ** 2, dim=-1)
        # Huber-saturated chi2 so outliers can't dominate acceptance
        rho = torch.where(e2 > h2, 2 * huber * torch.sqrt(e2) - h2, e2)
        sig_dev = torch.log(st[0] / s_init)
        return (torch.sum(torch.where(w_obs, rho, torch.zeros_like(rho)))
                + scale_prior_weight * sig_dev * sig_dev)

    st = (s, R, t)
    chi = chi2_of(st)
    lam = torch.full((), 1e-3, dtype=dtype, device=dev)
    prior = torch.zeros(7, dtype=dtype, device=dev)
    prior[6] = scale_prior_weight
    for _ in range(iters):
        r, depth_ok = res_vec(st, z7)
        J = jacfwd(lambda dx: res_vec(st, dx)[0])(z7)          # [4N, 7]
        w_obs = (valid & depth_ok).repeat(2)
        e2 = torch.sum(r.reshape(-1, 2) ** 2, dim=-1)
        hw = torch.where(e2 > h2,
                         huber / torch.clamp(torch.sqrt(e2), min=1e-9), 1.0)
        w4 = (w_obs.to(dtype) * hw).repeat_interleave(2)
        Jw = torch.where(w4[:, None] > 0, J, torch.zeros_like(J))
        rw = torch.where(w4 > 0, r, torch.zeros_like(r))
        JtW = (Jw * w4[:, None]).T
        H = JtW @ Jw + torch.diag(prior)
        g = JtW @ rw + prior * torch.log(st[0] / s_init)
        # LM damping with an ABSOLUTE floor: near-degenerate directions
        # (scale when the relative translation ~ 0) must not produce
        # unbounded steps
        d = torch.clamp(torch.diagonal(H), min=1e-2)
        dx, info = torch.linalg.solve_ex(H + lam * torch.diag(d), -g)
        if fix_scale:   # inertial/stereo: scale is observable, hold it
            dx = torch.cat([dx[:6], torch.zeros_like(dx[6:])])
        ok = (info == 0) & torch.all(torch.isfinite(dx))
        dx = torch.where(ok, dx, torch.zeros_like(dx))
        ds, dR, dt = lie.sim3_exp(dx[None])
        s_n, R_n, t_n = lie.sim3_compose(ds[0], dR[0], dt[0], *st)
        new_st = (s_n, lie.normalize_rotation(R_n), t_n)
        chi_new = chi2_of(new_st)
        accept = chi_new < chi
        st = tuple(torch.where(accept, b, a) for a, b in zip(st, new_st))
        chi = torch.where(accept, chi_new, chi)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 5.0),
                          1e-6, 1e6)

    s_f, R_f, t_f = st
    uv2_hat, uv1_hat, depth_ok = _residuals(
        z7, s_f, R_f, t_f, p1, p2, rig_kind, cam1, cam2,
        R_cb1, t_cb1, R_cb2, t_cb2)
    e_fwd = torch.sum((uv2_hat - uv2) ** 2, dim=-1) / sigma2_2
    e_inv = torch.sum((uv1_hat - uv1) ** 2, dim=-1) / sigma2_1
    inlier = valid & depth_ok & (e_fwd < chi2_th) & (e_inv < chi2_th)
    chi2 = torch.sum(torch.where(inlier, e_fwd + e_inv,
                                 torch.zeros_like(e_fwd)))
    ok = torch.isfinite(s_f) & (s_f > 1e-3) & (s_f < 1e3)
    return Sim3RefineResult(
        s=torch.where(ok, s_f, s), R=torch.where(ok, R_f, R),
        t=torch.where(ok, t_f, t), inlier=inlier,
        n_inliers=torch.sum(inlier, dtype=torch.int32), chi2=chi2)
