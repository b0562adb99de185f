"""Schur-complement window bundle adjustment, visual and visual-inertial
(port of `bundle_adjust` with `InertialEdges` of `openmavis_tpu/optim/ba.py`;
reference: LocalBundleAdjustment src/Optimizer.cc:1280, LocalInertialBA
:2728).

Residuals and Jacobians of all observations are one batched computation;
landmark blocks are eliminated with batched 3x3 inverses and the reduced
camera system is a dense Cholesky solve, inside a fixed-iteration LM loop
whose accept/reject stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import lie
from ..imu.preintegration import Preintegrated
from . import inertial as inertial_mod
from . import lm as lm_mod
from . import robust
from .reprojection import RigParams, mono_residual, mono_residual_jac


class BAState(NamedTuple):
    R: torch.Tensor       # [K,3,3]
    t: torch.Tensor       # [K,3]
    v: torch.Tensor       # [K,3]
    bg: torch.Tensor      # [K,3]
    ba: torch.Tensor      # [K,3]
    points: torch.Tensor  # [M,3]


class BAObservations(NamedTuple):
    kf: torch.Tensor      # [O] keyframe index
    mp: torch.Tensor      # [O] landmark index
    cam: torch.Tensor     # [O] camera index
    uv: torch.Tensor      # [O,2]
    sigma2: torch.Tensor  # [O]
    valid: torch.Tensor   # [O] bool


class InertialEdges(NamedTuple):
    """Temporal chain: edge e connects keyframe e -> e+1."""
    pre: Preintegrated    # fields with a leading [E = K-1] axis
    valid: torch.Tensor   # [E] bool


def _visual_terms(state: BAState, obs: BAObservations, rig: RigParams,
                  active):
    kf = obs.kf.to(torch.int64)
    r, Jp, Jl, depth = mono_residual_jac(
        state.R[kf], state.t[kf], state.points[obs.mp.to(torch.int64)],
        obs.cam, obs.uv, rig)
    info = 1.0 / obs.sigma2
    chi2 = torch.sum(r * r, dim=-1) * info
    w = robust.huber_weight(chi2, robust.CHI2_2D) * info
    w = torch.where(active & (depth > 0.01), w, torch.zeros_like(w))
    return r, Jp, Jl, w, chi2


def _diag_add(A: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return A + torch.diag_embed(d)


def _schur_solve(Hpp, Hpl, Hll, gp, gl, lam, fixed, D):
    """Solve the damped normal equations by landmark elimination.
    Hpp [K*D, K*D]; Hpl [K, D, M, 3]; Hll [M,3,3]; gp [K*D]; gl [M,3];
    fixed [K] bool. Returns (dx_p [K*D], dx_l [M,3])."""
    K, M = Hpl.shape[0], Hll.shape[0]
    dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
    Hll_inv = lm_mod.inv3x3(_diag_add(Hll, lam * torch.clamp(dll, min=1e-9)
                                      + 1e-9))
    A = Hpl.reshape(K * D, M, 3)
    Y = torch.einsum("amj,mjk->amk", A, Hll_inv)
    S = Hpp - Y.reshape(K * D, -1) @ A.reshape(K * D, -1).T
    b_s = gp - Y.reshape(K * D, -1) @ gl.reshape(-1)

    dpp = torch.diagonal(S)
    S = _diag_add(S, lam * torch.clamp(dpp, min=1e-9) + 1e-9)
    fixmask = fixed.repeat_interleave(D)
    S = torch.where(fixmask[:, None] | fixmask[None, :],
                    torch.zeros_like(S), S)
    S = _diag_add(S, fixmask.to(S.dtype))
    b_s = torch.where(fixmask, torch.zeros_like(b_s), b_s)

    dx_p, ok = lm_mod.cholesky_solve(S, -b_s)
    dx_p = torch.where(ok, dx_p, torch.zeros_like(dx_p))
    rhs = -gl - (dx_p @ A.reshape(K * D, -1)).reshape(M, 3)
    dx_l = (Hll_inv @ rhs[..., None])[..., 0]
    return dx_p, dx_l


def _retract(state: BAState, dx_p, dx_l, D):
    K = state.R.shape[0]
    d = dx_p.reshape(K, D)
    R = lie.normalize_rotation(state.R @ lie.so3_exp(d[:, 0:3]))
    t = state.t + (state.R @ d[:, 3:6, None])[..., 0]
    if D == 15:
        v, bg, ba = (state.v + d[:, 6:9], state.bg + d[:, 9:12],
                     state.ba + d[:, 12:15])
    else:
        v, bg, ba = state.v, state.bg, state.ba
    return BAState(R=R, t=t, v=v, bg=bg, ba=ba, points=state.points + dx_l)


def inertial_edge_blocks(state: BAState, edges: InertialEdges):
    """Per-edge block-tridiagonal contributions of the temporal chain with
    the bias random walk folded in: (H11, H12, H22 [E,15,15], g1, g2
    [E,15], chi)."""
    pre = edges.pre
    info9 = inertial_mod.inertial_information(pre)
    info_g, info_a = inertial_mod.bias_rw_information(pre)
    r, J1, J2 = inertial_mod.inertial_residual_jac(
        state.R[:-1], state.t[:-1], state.v[:-1], state.bg[:-1],
        state.ba[:-1], state.R[1:], state.t[1:], state.v[1:], pre)
    ev = edges.valid.to(state.t.dtype)[:, None, None]
    info9, info_g, info_a = info9 * ev, info_g * ev, info_a * ev

    J2e = torch.zeros(J1.shape[:-1] + (15,), dtype=J1.dtype,
                      device=J1.device)
    J2e[..., :9] = J2
    J1T_I = J1.transpose(-1, -2) @ info9
    J2T_I = J2e.transpose(-1, -2) @ info9
    H11 = J1T_I @ J1
    H12 = J1T_I @ J2e
    H22 = J2T_I @ J2e
    g1 = (J1T_I @ r[..., None])[..., 0]
    g2 = (J2T_I @ r[..., None])[..., 0]
    chi = torch.sum(r * (info9 @ r[..., None])[..., 0])

    rg = state.bg[1:] - state.bg[:-1]
    ra = state.ba[1:] - state.ba[:-1]
    Ig_rg = (info_g @ rg[..., None])[..., 0]
    Ia_ra = (info_a @ ra[..., None])[..., 0]
    chi = chi + torch.sum(rg * Ig_rg) + torch.sum(ra * Ia_ra)
    H11[:, 9:12, 9:12] += info_g
    H11[:, 12:15, 12:15] += info_a
    H22[:, 9:12, 9:12] += info_g
    H22[:, 12:15, 12:15] += info_a
    H12[:, 9:12, 9:12] -= info_g
    H12[:, 12:15, 12:15] -= info_a
    g1[:, 9:12] -= Ig_rg
    g1[:, 12:15] -= Ia_ra
    g2[:, 9:12] += Ig_rg
    g2[:, 12:15] += Ia_ra
    return H11, H12, H22, g1, g2, chi


def _inertial_dense(state: BAState, edges: InertialEdges, prior,
                    prior_idx: int):
    """Dense [K*15, K*15] contributions of the temporal inertial chain."""
    K, D = state.R.shape[0], 15
    H11, H12, H22, g1, g2, chi = inertial_edge_blocks(state, edges)
    H = torch.zeros((K, D, K, D), dtype=state.t.dtype, device=state.t.device)
    g = torch.zeros((K, D), dtype=state.t.dtype, device=state.t.device)
    e = torch.arange(K - 1, device=state.t.device)
    f = e + 1
    H[e, :, e, :] += H11
    H[e, :, f, :] += H12
    H[f, :, e, :] += H12.transpose(-1, -2)
    H[f, :, f, :] += H22
    g[:-1] += g1
    g[1:] += g2
    if prior is not None:
        st = state
        rp, Jp15 = inertial_mod.prior_residual_jac(
            st.R[prior_idx], st.t[prior_idx], st.v[prior_idx],
            st.bg[prior_idx], st.ba[prior_idx], prior)
        H[prior_idx, :, prior_idx, :] += Jp15.T @ prior.H @ Jp15
        g[prior_idx] += Jp15.T @ (prior.H @ rp)
        chi = chi + rp @ (prior.H @ rp)
    return H.reshape(K * D, K * D), g.reshape(K * D), chi


def bundle_adjust(state: BAState, obs: BAObservations, rig: RigParams,
                  pose_fixed, point_fixed=None,
                  edges: InertialEdges | None = None,
                  prior=None, prior_idx: int = 0,
                  stages=(5, 10), lambda0: float = 1e-2,
                  chi2_th: float = robust.CHI2_2D,
                  rows_per_kf: int | None = None, psum=None):
    """Window BA with landmark Schur elimination.

    pose_fixed [K] bool; point_fixed optional [M] bool; edges: temporal
    inertial chain (None = visual-only, D = 6); stages: LM iterations per
    stage, observations chi2-re-gated between stages. `rows_per_kf`
    declares the observation table as K contiguous blocks of that many
    rows (pose blocks then reduce by reshape-sum); a table on the CPU
    that is not so laid out raises ValueError.
    `psum`: None, or a callable that sums a tensor over the ranks of a
    group when `obs` is this rank's shard of the observations and the
    state is replicated (`parallel.dist_ba.distributed_bundle_adjust`):
    the visual terms are then summed over the group; the inertial terms
    stay replicated and unreduced.
    Returns (state, obs_inlier [O] bool, final_chi2)."""
    D = 15 if edges is not None else 6
    K = state.R.shape[0]
    M = state.points.shape[0]
    O = obs.kf.shape[0]
    dt, dev = state.t.dtype, state.t.device
    sorted_rows = (rows_per_kf is not None and rows_per_kf * K == O
                   and psum is None)
    _psum = psum if psum is not None else (lambda x: x)
    kf64 = obs.kf.to(torch.int64)
    if sorted_rows and kf64.device.type == "cpu" and not torch.equal(
            kf64, torch.arange(K).repeat_interleave(rows_per_kf)):
        # checked on the CPU only: on the card it would cost a sync
        raise ValueError(
            "bundle_adjust: rows_per_kf=%d declares the observation table "
            "as %d contiguous keyframe blocks, but obs.kf is not laid out "
            "so" % (rows_per_kf, K))
    flat = kf64 * M + obs.mp.to(torch.int64)

    def assemble(st: BAState, active):
        r, Jp, Jl, w, _ = _visual_terms(st, obs, rig, active)
        Jpw = Jp * w[:, None, None]
        Jlw = Jl * w[:, None, None]
        vpp = (Jpw.transpose(1, 2) @ Jp).reshape(O, 36)
        vgp = (Jpw.transpose(1, 2) @ r[..., None])[..., 0]
        if sorted_rows:
            HppB = vpp.reshape(K, rows_per_kf, 36).sum(1).reshape(K, 6, 6)
            gpB = vgp.reshape(K, rows_per_kf, 6).sum(1)
        else:
            HppB = torch.zeros((K, 36), dtype=dt, device=dev).index_add_(
                0, kf64, vpp).reshape(K, 6, 6)
            gpB = torch.zeros((K, 6), dtype=dt, device=dev).index_add_(
                0, kf64, vgp)
        vll = (Jlw.transpose(1, 2) @ Jl).reshape(O, 9)
        vgl = (Jlw.transpose(1, 2) @ r[..., None])[..., 0]
        vpl = (Jpw.transpose(1, 2) @ Jl).reshape(O, 18)
        pk = torch.zeros((K * M, 30), dtype=dt, device=dev).index_add_(
            0, flat, torch.cat([vll, vgl, vpl], dim=-1))
        pk = _psum(pk).reshape(K, M, 30)
        HppB = _psum(HppB)
        gpB = _psum(gpB)
        Hll = pk[..., :9].sum(0).reshape(M, 3, 3)
        gl = pk[..., 9:12].sum(0)
        Hpl6 = pk[..., 12:].reshape(K, M, 6, 3).permute(0, 2, 1, 3)
        chi = _psum(torch.sum(w * torch.sum(r * r, dim=-1)))

        idx = torch.arange(K, device=dev)
        if D == 6:
            Hpp = torch.zeros((K, 6, K, 6), dtype=dt, device=dev)
            Hpp[idx, :, idx, :] = HppB
            Hpp = Hpp.reshape(K * 6, K * 6)
            gp = gpB.reshape(K * 6)
            Hpl = Hpl6
        else:
            Hpp = torch.zeros((K, 15, K, 15), dtype=dt, device=dev)
            Hpp[idx, :6, idx, :6] = HppB
            Hpp = Hpp.reshape(K * 15, K * 15)
            gp = torch.zeros((K, 15), dtype=dt, device=dev)
            gp[:, :6] = gpB
            Hi, gi, chi_i = _inertial_dense(st, edges, prior, prior_idx)
            Hpp = Hpp + Hi
            gp = gp.reshape(K * 15) + gi
            chi = chi + chi_i
            Hpl = torch.zeros((K, 15, M, 3), dtype=dt, device=dev)
            Hpl[:, :6] = Hpl6

        if point_fixed is not None:
            pf = point_fixed
            Hll = torch.where(pf[:, None, None],
                              torch.eye(3, dtype=dt, device=dev), Hll)
            gl = torch.where(pf[:, None], torch.zeros_like(gl), gl)
            Hpl = torch.where(pf[None, None, :, None], torch.zeros_like(Hpl),
                              Hpl)
        return Hpp, Hpl, Hll, gp, gl, chi

    def lm_stage(st, active, iters):
        A = assemble(st, active)
        lam = torch.full((), lambda0, dtype=dt, device=dev)
        for _ in range(iters):
            Hpp, Hpl, Hll, gp, gl, chi = A
            dx_p, dx_l = _schur_solve(Hpp, Hpl, Hll, gp, gl, lam,
                                      pose_fixed, D)
            st_new = _retract(st, dx_p, dx_l, D)
            A_new = assemble(st_new, active)
            accept = A_new[5] < chi
            st = lm_mod.select(accept, st_new, st)
            A = lm_mod.select(accept, A_new, A)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-9, 1e6)
        return st, A[5]

    active = obs.valid
    chi = torch.zeros((), dtype=dt, device=dev)
    mp64 = obs.mp.to(torch.int64)
    for iters in stages:
        state, chi = lm_stage(state, active, iters)
        r, depth = mono_residual(state.R[kf64], state.t[kf64],
                                 state.points[mp64], obs.cam, obs.uv, rig)
        chi2 = torch.sum(r * r, dim=-1) / obs.sigma2
        active = obs.valid & (chi2 < chi2_th) & (depth > 0.01)
    return state, active, chi
