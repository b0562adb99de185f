"""Matrix-free global bundle adjustment: Schur + PCG (port of
`global_bundle_adjust` of `openmavis_tpu/optim/global_ba.py`; reference:
Optimizer::FullInertialBA, src/Optimizer.cc:368).

Landmark blocks are inverted batched; the reduced camera system is applied
as an operator (observation-indexed gathers/scatters, never materialized)
and solved with block-Jacobi preconditioned conjugate gradients inside an
LM loop. The inertial chain enters as per-edge [15,15] blocks.

Distribution: every reduction of the operator goes through an optional
`psum`, so the same body runs on one rank's shard of the observations
(`parallel/dist_ba.py`); per CG step the collective is one [K, D] vector
plus scalars.
"""

from __future__ import annotations

import torch

from . import inertial as inertial_mod
from . import lm as lm_mod
from . import robust
from .ba import (BAObservations, BAState, InertialEdges, _retract,
                 _visual_terms, inertial_edge_blocks)
from .reprojection import RigParams


def _bmv(A, x):
    return (A @ x[..., None])[..., 0]


def global_bundle_adjust(state: BAState, obs: BAObservations,
                         rig: RigParams, pose_fixed, point_fixed=None,
                         edges: InertialEdges | None = None,
                         prior=None, prior_idx: int = 0,
                         stages=(5, 10), cg_iters: int = 24,
                         lambda0: float = 1e-2,
                         chi2_th: float = robust.CHI2_2D,
                         psum=None, points_local: bool = False):
    """Same contract as ba.bundle_adjust, scaled to whole maps.

    `psum`: None, or a callable that sums a tensor over the ranks of a
    group when `obs` is this rank's shard of the observations; every
    reduction is then summed over the group. `points_local=True` declares
    the landmark axis sharded too, with every observation of a landmark on
    its owner rank (`parallel.dist_ba.distributed_global_ba_lsharded`):
    the landmark reductions (Hll, gl, lx) then stay on the shard.
    Returns (state, obs_inlier [O] bool, final_chi2)."""
    D = 15 if edges is not None else 6
    K = state.R.shape[0]
    M = state.points.shape[0]
    dt, dev = state.t.dtype, state.t.device
    fixmask = pose_fixed[:, None].expand(K, D)
    kf64 = obs.kf.to(torch.int64)
    mp64 = obs.mp.to(torch.int64)

    def _psum(x):
        return x if psum is None else psum(x)

    def _psum_l(x):
        # landmark-axis reduction: none when the landmarks are sharded
        return x if psum is None or points_local else psum(x)

    def scat_kf(vals):
        """[O, d] -> [K, d] sum by keyframe."""
        return torch.zeros((K, vals.shape[1]), dtype=dt,
                           device=dev).index_add_(0, kf64, vals)

    def scat_mp(vals):
        return torch.zeros((M,) + vals.shape[1:], dtype=dt,
                           device=dev).index_add_(0, mp64, vals)

    def prepare(st, active, lam):
        r, Jp, Jl, w, _ = _visual_terms(st, obs, rig, active)
        Jlw = Jl * w[:, None, None]
        Jpw = Jp * w[:, None, None]
        Hll = scat_mp(Jlw.transpose(1, 2) @ Jl)
        gl = scat_mp(_bmv(Jlw.transpose(1, 2), r))
        Hll = _psum_l(Hll)
        gl = _psum_l(gl)
        dll = torch.diagonal(Hll, dim1=-2, dim2=-1)
        Hll_d = Hll + torch.diag_embed(lam * torch.clamp(dll, min=1e-9)
                                       + 1e-9)
        if point_fixed is not None:
            eye = torch.eye(3, dtype=dt, device=dev)
            Hll_d = torch.where(point_fixed[:, None, None], eye, Hll_d)
            gl = torch.where(point_fixed[:, None], torch.zeros_like(gl), gl)
        Hll_inv = lm_mod.inv3x3(Hll_d)

        Hpp_blk = scat_kf((Jpw.transpose(1, 2) @ Jp).reshape(-1, 36)
                          ).reshape(K, 6, 6)
        gp6 = scat_kf(_bmv(Jpw.transpose(1, 2), r))
        Hpp_blk = _psum(Hpp_blk)
        gp6 = _psum(gp6)
        chi = _psum(torch.sum(w * torch.sum(r * r, dim=-1)))

        gp = torch.zeros((K, D), dtype=dt, device=dev)
        gp[:, :6] = gp6
        HppD = torch.zeros((K, D, D), dtype=dt, device=dev)
        HppD[:, :6, :6] = Hpp_blk
        iblocks = None
        Hp_prior = None
        if D == 15:
            H11, H12, H22, g1, g2, chi_i = inertial_edge_blocks(st, edges)
            gp[:-1] += g1
            gp[1:] += g2
            HppD[:-1] += H11
            HppD[1:] += H22
            chi = chi + chi_i
            iblocks = (H11, H12, H22)
            if prior is not None:
                rp, Jp15 = inertial_mod.prior_residual_jac(
                    st.R[prior_idx], st.t[prior_idx], st.v[prior_idx],
                    st.bg[prior_idx], st.ba[prior_idx], prior)
                Hp_prior = Jp15.T @ prior.H @ Jp15
                HppD[prior_idx] += Hp_prior
                gp[prior_idx] += Jp15.T @ (prior.H @ rp)
                chi = chi + rp @ (prior.H @ rp)

        # reduced-system rhs b = gp - Hpl Hll^-1 gl
        u = _bmv(Hll_inv, gl)
        uo = _bmv(Jl, u[mp64])
        corr = _psum(scat_kf(_bmv(Jpw.transpose(1, 2), uo)))
        b = gp.clone()
        b[:, :6] -= corr
        return (Jp, Jl, w), Hll_inv, HppD, iblocks, Hp_prior, b, gl, chi

    def matvec(x, terms, Hll_inv, HppD, iblocks, Hp_prior, lam):
        """(S + lam diag) x with fixed poses projected out."""
        Jp, Jl, w = terms
        x = torch.where(fixmask, torch.zeros_like(x), x)
        yo = _bmv(Jp, x[:, :6][kf64]) * w[:, None]           # [O,2]
        hx = _psum(scat_kf(_bmv(Jp.transpose(1, 2), yo)))
        lx = _psum_l(scat_mp(_bmv(Jl.transpose(1, 2), yo)))
        v = _bmv(Hll_inv, lx)
        vo = _bmv(Jl, v[mp64]) * w[:, None]
        sx = _psum(scat_kf(_bmv(Jp.transpose(1, 2), vo)))
        y = torch.zeros((K, D), dtype=dt, device=dev)
        y[:, :6] = hx - sx
        if D == 15:
            H11, H12, H22 = iblocks
            y[:-1] += _bmv(H11, x[:-1]) + _bmv(H12, x[1:])
            y[1:] += _bmv(H12.transpose(-1, -2), x[:-1]) + _bmv(H22, x[1:])
            if Hp_prior is not None:
                y[prior_idx] += Hp_prior @ x[prior_idx]
        d = torch.clamp(torch.diagonal(HppD, dim1=-2, dim2=-1), min=1e-9)
        y = y + lam * d * x
        return torch.where(fixmask, x, y)

    def pcg(terms, Hll_inv, HppD, iblocks, Hp_prior, b, lam):
        d = torch.diagonal(HppD, dim1=-2, dim2=-1)
        Mb = (HppD + torch.diag_embed(lam * torch.clamp(d, min=1e-9))
              + 1e-6 * torch.eye(D, dtype=dt, device=dev))
        Minv = torch.linalg.inv_ex(Mb)[0]
        zero = torch.zeros((), dtype=dt, device=dev)

        def prec(r_):
            r_ = torch.where(fixmask, zero, r_)
            return torch.where(fixmask, zero, _bmv(Minv, r_))

        b_ = torch.where(fixmask, zero, -b)
        x = torch.zeros_like(b_)
        r_ = b_
        z = prec(r_)
        p = z
        rz = torch.sum(r_ * z)
        tiny = torch.full((), 1e-20, dtype=dt, device=dev)
        for _ in range(cg_iters):
            Ap = matvec(p, terms, Hll_inv, HppD, iblocks, Hp_prior, lam)
            Ap = torch.where(fixmask, zero, Ap)
            pAp = torch.sum(p * Ap)
            alpha = rz / torch.where(pAp.abs() < 1e-20, tiny, pAp)
            x = x + alpha * p
            r_n = r_ - alpha * Ap
            z_n = prec(r_n)
            rz_n = torch.sum(r_n * z_n)
            beta = rz_n / torch.where(rz.abs() < 1e-20, tiny, rz)
            p = z_n + beta * p
            r_, rz = r_n, rz_n
        return torch.where(fixmask, zero, x)

    def chi2_fn(st, active):
        r, _, _, w, _ = _visual_terms(st, obs, rig, active)
        chi = _psum(torch.sum(w * torch.sum(r * r, dim=-1)))
        if D == 15:
            chi = chi + inertial_edge_blocks(st, edges)[-1]
            if prior is not None:
                rp, _ = inertial_mod.prior_residual_jac(
                    st.R[prior_idx], st.t[prior_idx], st.v[prior_idx],
                    st.bg[prior_idx], st.ba[prior_idx], prior)
                chi = chi + rp @ (prior.H @ rp)
        return chi

    def backsub(terms, Hll_inv, gl, dx_p):
        """dl = Hll^-1 (-gl - Hlp dx_p)."""
        Jp, Jl, w = terms
        yo = _bmv(Jp, dx_p[:, :6][kf64]) * w[:, None]
        lx = _psum_l(scat_mp(_bmv(Jl.transpose(1, 2), yo)))
        dl = _bmv(Hll_inv, -gl - lx)
        if point_fixed is not None:
            dl = torch.where(point_fixed[:, None], torch.zeros_like(dl), dl)
        return dl

    def lm_stage(st, active, iters):
        chi = chi2_fn(st, active)
        lam = torch.full((), lambda0, dtype=dt, device=dev)
        for _ in range(iters):
            terms, Hll_inv, HppD, iblocks, Hp_prior, b, gl, _ = \
                prepare(st, active, lam)
            dx_p = pcg(terms, Hll_inv, HppD, iblocks, Hp_prior, b, lam)
            dx_l = backsub(terms, Hll_inv, gl, dx_p)
            st_new = _retract(st, dx_p.reshape(-1), dx_l, D)
            chi_new = chi2_fn(st_new, active)
            accept = chi_new < chi
            st = lm_mod.select(accept, st_new, st)
            chi = torch.where(accept, chi_new, chi)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-9, 1e6)
        return st, chi

    active = obs.valid
    chi = torch.zeros((), dtype=dt, device=dev)
    for iters in stages:
        state, chi = lm_stage(state, active, iters)
        _, _, _, _, chi2 = _visual_terms(state, obs, rig, obs.valid)
        active = obs.valid & (chi2 < chi2_th)
    return state, active, chi
