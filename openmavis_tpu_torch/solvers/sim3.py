"""Batched Horn closed-form Sim(3)/SE(3) RANSAC between two keyframes
(port of `horn_sim3`, `Sim3Result`, `ransac_sim3` and `ransac_sim3_reproj`
of `openmavis_tpu/solvers/sim3.py`; reference: src/Sim3Solver.cc — 3-point
Horn absolute orientation inside RANSAC with camera-aware reprojection
gating, used by loop detection, src/LoopClosing.cc:812-832).

Hypotheses are a batch axis. The reference package draws the 3-point
samples from a PRNG key; here a solver draws them from a
`torch.Generator` (`draw_samples`) unless the caller hands it
`sample_idx` ([n_hyp, 3] indices into the pairs), so that a test can give
both packages the same samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import cameras, lie


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = False):
    """Closed-form similarity p2 ~ s R p1 + t from paired points.

    p1, p2: [..., P, 3] (P >= 3). Returns (s [...], R [...,3,3], t [...,3]).
    Horn's quaternion method, batched (Sim3Solver::ComputeSim3)."""
    c1 = p1.mean(dim=-2, keepdim=True)
    c2 = p2.mean(dim=-2, keepdim=True)
    q1 = p1 - c1
    q2 = p2 - c2
    M = q1.transpose(-1, -2) @ q2                       # cross-covariance
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
                    dim=-1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
                    dim=-1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
                    dim=-1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
                    dim=-1),
    ], dim=-2)
    # a non-finite N would make eigh raise; s and t below still come out
    # non-finite from q1, q2 and the callers reject the hypothesis
    _, V = torch.linalg.eigh(torch.nan_to_num(N))
    R = lie.quat_to_rotmat(V[..., :, -1])               # largest eigenvalue

    rot_q1 = q1 @ R.transpose(-1, -2)
    if fix_scale:
        s = torch.ones(p1.shape[:-2], dtype=p1.dtype, device=p1.device)
    else:
        num = torch.sum(q2 * rot_q1, dim=(-1, -2))
        den = torch.sum(rot_q1 * rot_q1, dim=(-1, -2))
        s = num / torch.clamp(den, min=1e-12)
    t = c2[..., 0, :] - s[..., None] * lie._mv(R, c1[..., 0, :])
    return s, R, t


class Sim3Result(NamedTuple):
    success: torch.Tensor
    s: torch.Tensor
    R: torch.Tensor        # frame2-from-frame1
    t: torch.Tensor
    inlier: torch.Tensor   # [N]
    n_inliers: torch.Tensor


def draw_samples(gen: torch.Generator, valid: torch.Tensor,
                 n_hyp: int = 128) -> torch.Tensor:
    """[n_hyp, 3] int64 indices drawn with replacement, uniformly among
    the valid pairs (an invalid pair has probability zero). With no valid
    pair the draw is uniform over all pairs, and the solvers then reject
    every hypothesis for its invalid samples."""
    w = valid.to(torch.float32)
    w = w + (w.sum() <= 0).to(torch.float32)
    return torch.multinomial(w, 3 * n_hyp, replacement=True,
                             generator=gen).reshape(n_hyp, 3)


def _weighted_refit(p1, p2, inl, fix_scale: bool):
    """Full-set Horn refit on a hypothesis' inliers (weighted centroids)."""
    w = inl.to(p1.dtype)[:, None]
    cnt = torch.clamp(torch.sum(w), min=3.0)
    c1 = torch.sum(p1 * w, dim=0) / cnt
    c2 = torch.sum(p2 * w, dim=0) / cnt
    return horn_sim3((p1 - c1) * w + c1, (p2 - c2) * w + c2,
                     fix_scale=fix_scale)


def _sane_scale(s):
    return torch.isfinite(s) & (s > 0.1) & (s < 10.0)


def _samples(gen, valid, n_hyp: int, sample_idx):
    if sample_idx is None:
        return draw_samples(gen, valid, n_hyp)
    return sample_idx.to(torch.int64)


def ransac_sim3(gen, p1: torch.Tensor, p2: torch.Tensor,
                valid: torch.Tensor, fix_scale: bool = False,
                n_hyp: int = 128, inlier_th: float = 0.05,
                min_inliers: int = 20, relative_th: bool = True,
                sample_idx=None) -> Sim3Result:
    """RANSAC Sim3 from matched 3D points with a 3D-distance gate.

    p1, p2 [N, 3]: matched map points expressed in the two keyframes;
    gen: the generator the samples are drawn from when `sample_idx`
    ([S, 3]) is not given. inlier_th multiplies each point's range when
    `relative_th`, else it is metres."""
    idx = _samples(gen, valid, n_hyp, sample_idx)
    s, R, t = horn_sim3(p1[idx], p2[idx], fix_scale=fix_scale)
    pred = s[:, None, None] * (p1 @ R.transpose(-1, -2)) + t[:, None, :]
    err = torch.linalg.norm(pred - p2[None], dim=-1)    # [S, N]
    if relative_th:
        gate = inlier_th * torch.clamp(torch.linalg.norm(p2, dim=-1),
                                       min=1.0)[None, :]
    else:
        gate = inlier_th
    inl = (err < gate) & valid[None, :]
    bad = torch.any(~valid[idx], dim=-1) | (s < 0.1) | (s > 10.0)
    n_inl = torch.where(bad, 0, torch.sum(inl, dim=1, dtype=torch.int32))
    best = torch.argmax(n_inl)

    s_r, R_r, t_r = _weighted_refit(p1, p2, inl[best], fix_scale)
    ok = _sane_scale(s_r)
    return Sim3Result(success=n_inl[best] >= min_inliers,
                      s=torch.where(ok, s_r, s[best]),
                      R=torch.where(ok, R_r, R[best]),
                      t=torch.where(ok, t_r, t[best]),
                      inlier=inl[best], n_inliers=n_inl[best])


def ransac_sim3_reproj(gen, pairs, rig_kind: int, rig,
                       fix_scale: bool = False, n_hyp: int = 128,
                       chi2_th: float = 9.21, min_inliers: int = 20,
                       sample_idx=None) -> Sim3Result:
    """Sim3 RANSAC with the reference's REPROJECTION inlier test
    (Sim3Solver::CheckInliers: project the mapped points through both
    cameras and chi2-test the pixel errors), which only asks a hypothesis
    to explain the images, not two drift-distorted 3D clouds.

    pairs: loop_closing.MatchedPairs; gen: the generator the samples are
    drawn from when `sample_idx` ([S, 3]) is not given.
    Returns the Sim3 body(a) -> body(b)."""
    p1, p2, valid = pairs.p_a, pairs.p_b, pairs.valid
    idx = _samples(gen, valid, n_hyp, sample_idx)
    s, R, t = horn_sim3(p1[idx], p2[idx], fix_scale=fix_scale)

    C = rig.params.shape[0]
    cam_a = torch.clamp(pairs.cam_a, 0, C - 1).to(torch.int64)
    cam_b = torch.clamp(pairs.cam_b, 0, C - 1).to(torch.int64)
    R_cb_a, t_cb_a, par_a = rig.R_cb[cam_a], rig.t_cb[cam_a], \
        rig.params[cam_a]
    R_cb_b, t_cb_b, par_b = rig.R_cb[cam_b], rig.t_cb[cam_b], \
        rig.params[cam_b]
    inf = torch.full((), float("inf"), dtype=p1.dtype, device=p1.device)

    def reproj_chi2(s, R, t):
        """[S] hypotheses -> [S, N] mutual reprojection chi2."""
        # a -> b: project s R p1 + t into b's camera band
        pb = s[:, None, None] * (p1 @ R.transpose(-1, -2)) + t[:, None, :]
        pcb = lie._mv(R_cb_b, pb) + t_cb_b
        uvb = cameras.project(rig_kind, par_b, pcb)
        e_b = torch.sum((uvb - pairs.uv_b) ** 2, dim=-1) / pairs.sigma2_b
        # b -> a: inverse hypothesis into a's camera band
        pa = ((p2[None] - t[:, None, :]) @ R) / s[:, None, None]
        pca = lie._mv(R_cb_a, pa) + t_cb_a
        uva = cameras.project(rig_kind, par_a, pca)
        e_a = torch.sum((uva - pairs.uv_a) ** 2, dim=-1) / pairs.sigma2_a
        ok = (pcb[..., 2] > 0.05) & (pca[..., 2] > 0.05)
        return torch.where(ok, torch.maximum(e_a, e_b), inf)

    inl = (reproj_chi2(s, R, t) < chi2_th) & valid[None, :]
    bad = (torch.any(~valid[idx], dim=-1) | (s < 0.1) | (s > 10.0)
           | ~torch.isfinite(s))
    n_inl = torch.where(bad, 0, torch.sum(inl, dim=1, dtype=torch.int32))
    best = torch.argmax(n_inl)

    s_r, R_r, t_r = _weighted_refit(p1, p2, inl[best], fix_scale)
    inl_r = (reproj_chi2(s_r[None], R_r[None], t_r[None])[0]
             < chi2_th) & valid
    n_r = torch.sum(inl_r, dtype=torch.int32)
    take = (n_r >= n_inl[best]) & _sane_scale(s_r)
    n_f = torch.where(take, n_r, n_inl[best])
    return Sim3Result(success=n_f >= min_inliers,
                      s=torch.where(take, s_r, s[best]),
                      R=torch.where(take, R_r, R[best]),
                      t=torch.where(take, t_r, t[best]),
                      inlier=torch.where(take, inl_r, inl[best]),
                      n_inliers=n_f)
