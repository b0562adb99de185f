"""Batched Sim(3) pose-graph optimization over the essential graph (port
of `openmavis_tpu/optim/pose_graph.py`; reference:
Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:1826/2121, and its
4DoF variant at :6171).

All edge residuals and Jacobians are evaluated in one batch (Jacobians by
forward-mode autodiff through the Sim3 chain: this runs only at loop
closures), the dense [K*D, K*D] system is solved by Cholesky, iterated
under LM damping.

Node convention: S_i = (s_i, R_i, t_i) maps WORLD -> KEYFRAME i (like the
reference's Scw). Edge (i, j) measures S_ji = S_j * S_i^{-1}: residual
r = log(S_meas^{-1} * S_j * S_i^{-1}) in R^7. Update: S <- exp(dx) * S
(left-multiplicative, matching g2o's Sim3 vertex).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..geometry import lie
from . import lm as lm_mod


class PoseGraphEdges(NamedTuple):
    i: torch.Tensor        # [E] int
    j: torch.Tensor        # [E]
    s: torch.Tensor        # [E] measured relative scale (S_ji)
    R: torch.Tensor        # [E,3,3]
    t: torch.Tensor        # [E,3]
    weight: torch.Tensor   # [E] information scale
    valid: torch.Tensor    # [E] bool


class PoseGraphEdgesSE3(NamedTuple):
    i: torch.Tensor        # [E] int
    j: torch.Tensor        # [E]
    R: torch.Tensor        # [E,3,3] measured T_ji rotation
    t: torch.Tensor        # [E,3]
    weight: torch.Tensor   # [E]
    valid: torch.Tensor    # [E] bool


def _edge_residual(dx_i, dx_j, si, Ri, ti, sj, Rj, tj, sm, Rm, tm):
    """r = log(Sm^{-1} * (exp(dx_j) Sj) * (exp(dx_i) Si)^{-1}), batched
    over the edges: dx_* [E,7], the rest with a leading [E]."""
    si_n, Ri_n, ti_n = lie.sim3_compose(*lie.sim3_exp(dx_i), si, Ri, ti)
    sj_n, Rj_n, tj_n = lie.sim3_compose(*lie.sim3_exp(dx_j), sj, Rj, tj)
    s_ji, R_ji, t_ji = lie.sim3_compose(
        sj_n, Rj_n, tj_n, *lie.sim3_inverse(si_n, Ri_n, ti_n))
    se, Re, te = lie.sim3_compose(*lie.sim3_inverse(sm, Rm, tm),
                                  s_ji, R_ji, t_ji)
    return lie.sim3_log(se, Re, te)


def _edge_residual_4dof(dx_i, dx_j, Ri, ti, Rj, tj, Rm, tm):
    """SE3 residual with 4-dim node updates [tx, ty, tz, yaw], batched
    over the edges. The update is left-multiplicative with the rotation
    constrained to the gravity (world z) axis: T <- exp([rho, yaw*e_z]) T,
    the reference's VertexPose4DoF (G2oTypes.h:219-262 — roll/pitch frozen
    once IMU initialization has fixed gravity)."""
    def se3_of(dx):
        zero = torch.zeros_like(dx[..., :2])
        return lie.se3_exp(torch.cat([dx[..., :3], zero, dx[..., 3:4]],
                                     dim=-1))

    Ri_n, ti_n = lie.se3_compose(*se3_of(dx_i), Ri, ti)
    Rj_n, tj_n = lie.se3_compose(*se3_of(dx_j), Rj, tj)
    Rji, tji = lie.se3_compose(Rj_n, tj_n, *lie.se3_inverse(Ri_n, ti_n))
    Re, te = lie.se3_compose(*lie.se3_inverse(Rm, tm), Rji, tji)
    return lie.se3_log(Re, te)


def _res_and_jac(residual, D: int, *args):
    """(r [E,R], Ji [E,R,D], Jj [E,R,D]) of a batched edge residual at
    dx = 0. Every edge is given the same update pair d = [dx_i, dx_j];
    as an edge's residual depends on its own copy only, d r / d d is the
    per-edge Jacobian, and one jacfwd over 2 D directions yields them all."""
    E = args[0].shape[0]
    like = args[-1]

    def f(d):
        return residual(d[:D].expand(E, D), d[D:].expand(E, D), *args)

    z = torch.zeros(2 * D, dtype=like.dtype, device=like.device)
    J = jacfwd(f)(z)
    return f(z), J[..., :D], J[..., D:]


def _normal_equations(r, Ji, Jj, w, ei, ej, K: int, D: int):
    """Dense (H [K D, K D], g [K D]) from per-edge residuals/Jacobians."""
    Jiw = Ji.transpose(-1, -2) * w[:, None, None]
    Jjw = Jj.transpose(-1, -2) * w[:, None, None]
    Hij = Jiw @ Jj
    H = torch.zeros((K, K, D, D), dtype=r.dtype, device=r.device)
    H.index_put_((ei, ei), Jiw @ Ji, accumulate=True)
    H.index_put_((ej, ej), Jjw @ Jj, accumulate=True)
    H.index_put_((ei, ej), Hij, accumulate=True)
    H.index_put_((ej, ei), Hij.transpose(-1, -2), accumulate=True)
    g = torch.zeros((K, D), dtype=r.dtype, device=r.device)
    g.index_add_(0, ei, lie._mv(Jiw, r))
    g.index_add_(0, ej, lie._mv(Jjw, r))
    return H.permute(0, 2, 1, 3).reshape(K * D, K * D), g.reshape(K * D)


def _lm_loop(state, res_all, chi2_fn, retract, edges, fixed, node_valid,
             K: int, D: int, iters: int, lambda0: float):
    """The LM iteration shared by both graphs: assemble, pin the fixed
    nodes, damped Cholesky step (no step where it fails), accept on a
    lower chi2."""
    ei, ej = edges.i.to(torch.int64), edges.j.to(torch.int64)
    w = torch.where(edges.valid, edges.weight,
                    torch.zeros_like(edges.weight))
    fixmask = (fixed | ~node_valid).repeat_interleave(D)
    pin = torch.diag(fixmask.to(w.dtype))
    chi = chi2_fn(state, w)
    lam = torch.full((), lambda0, dtype=torch.float32, device=w.device)
    for _ in range(iters):
        r, Ji, Jj = res_all(state)
        H, g = _normal_equations(r, Ji, Jj, w, ei, ej, K, D)
        H = torch.where(fixmask[:, None] | fixmask[None, :],
                        torch.zeros_like(H), H) + pin
        g = torch.where(fixmask, torch.zeros_like(g), g)
        d = torch.diagonal(H)
        Hd = H + torch.diag(lam * torch.clamp(d, min=1e-9) + 1e-9)
        dx, ok = lm_mod.cholesky_solve(Hd, -g)
        dx = torch.where(ok, dx, torch.zeros_like(dx))
        new_state = retract(state, dx.reshape(K, D))
        chi_new = chi2_fn(new_state, w)
        accept = chi_new < chi
        state = tuple(torch.where(accept, b, a)
                      for a, b in zip(state, new_state))
        chi = torch.where(accept, chi_new, chi)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                          1e-9, 1e4)
    return state, chi


def optimize_pose_graph(s, R, t, edges: PoseGraphEdges,
                        fixed: torch.Tensor, node_valid: torch.Tensor,
                        iters: int = 12, lambda0: float = 1e-4):
    """Optimize keyframe Sim3 poses (world-to-keyframe).

    s [K], R [K,3,3], t [K,3]: initial Sim3 per keyframe; fixed [K] bool:
    gauge anchors (the reference fixes the loop keyframe).
    Returns (s, R, t, final_chi2)."""
    K = s.shape[0]
    ei, ej = edges.i.to(torch.int64), edges.j.to(torch.int64)

    def ends(state):
        s_, R_, t_ = state
        return (s_[ei], R_[ei], t_[ei], s_[ej], R_[ej], t_[ej],
                edges.s, edges.R, edges.t)

    def res_all(state):
        return _res_and_jac(_edge_residual, 7, *ends(state))

    def chi2_fn(state, w):
        z = torch.zeros((ei.shape[0], 7), dtype=t.dtype, device=t.device)
        r = _edge_residual(z, z, *ends(state))
        return torch.sum(w * torch.sum(r * r, dim=-1))

    def retract(state, dxn):
        s_, R_, t_ = state
        ds, dR, dt = lie.sim3_exp(dxn)
        return (ds * s_, lie.normalize_rotation(dR @ R_),
                ds[:, None] * lie._mv(dR, t_) + dt)

    state, chi = _lm_loop((s, R, t), res_all, chi2_fn, retract, edges,
                          fixed, node_valid, K, 7, iters, lambda0)
    return state[0], state[1], state[2], chi


def optimize_pose_graph_4dof(R, t, edges: PoseGraphEdgesSE3,
                             fixed: torch.Tensor, node_valid: torch.Tensor,
                             iters: int = 12, lambda0: float = 1e-4):
    """4DoF essential-graph optimization for inertial maps: after IMU
    init the gravity direction (roll/pitch) is observable and must not be
    bent by a loop correction, so only yaw and translation are optimized
    (reference: Optimizer::OptimizeEssentialGraph4DoF, src/Optimizer.cc:
    6171, called from CorrectLoop for inertial maps).

    R [K,3,3], t [K,3]: world->keyframe SE3 per node.
    Returns (R, t, final_chi2)."""
    K = R.shape[0]
    ei, ej = edges.i.to(torch.int64), edges.j.to(torch.int64)

    def ends(state):
        R_, t_ = state
        return R_[ei], t_[ei], R_[ej], t_[ej], edges.R, edges.t

    def res_all(state):
        return _res_and_jac(_edge_residual_4dof, 4, *ends(state))

    def chi2_fn(state, w):
        z = torch.zeros((ei.shape[0], 4), dtype=t.dtype, device=t.device)
        r = _edge_residual_4dof(z, z, *ends(state))
        return torch.sum(w * torch.sum(r * r, dim=-1))

    def retract(state, dxn):
        R_, t_ = state
        wz = torch.cat([torch.zeros_like(dxn[:, :2]), dxn[:, 3:4]], dim=-1)
        dR = lie.so3_exp(wz)
        dt = lie._mv(lie.so3_left_jacobian(wz), dxn[:, :3])
        return lie.normalize_rotation(dR @ R_), lie._mv(dR, t_) + dt

    state, chi = _lm_loop((R, t), res_all, chi2_fn, retract, edges, fixed,
                          node_valid, K, 4, iters, lambda0)
    return state[0], state[1], chi


def sequential_edges_se3(R, t, n_kf, max_k: int) -> PoseGraphEdgesSE3:
    """Odometry-chain SE3 edges from current world->kf poses."""
    i = torch.arange(max_k - 1, device=R.device)
    j = i + 1
    Re, te = lie.se3_compose(R[j], t[j], *lie.se3_inverse(R[i], t[i]))
    return PoseGraphEdgesSE3(
        i=i, j=j, R=Re, t=te,
        weight=torch.ones(max_k - 1, dtype=t.dtype, device=R.device),
        valid=j < n_kf)


def sequential_edges(s, R, t, n_kf, max_k: int) -> PoseGraphEdges:
    """Odometry-chain edges from current poses (the spanning-tree part of
    the essential graph): edge (k, k+1) with the current relative Sim3."""
    i = torch.arange(max_k - 1, device=R.device)
    j = i + 1
    se, Re, te = lie.sim3_compose(s[j], R[j], t[j],
                                  *lie.sim3_inverse(s[i], R[i], t[i]))
    return PoseGraphEdges(
        i=i, j=j, s=se, R=Re, t=te,
        weight=torch.ones(max_k - 1, dtype=t.dtype, device=R.device),
        valid=j < n_kf)
