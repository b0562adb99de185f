"""Batched two-view reconstruction for monocular initialization (port of
`openmavis_tpu/solvers/two_view.py`; reference:
src/TwoViewReconstruction.cc — RANSAC of a homography and a fundamental
matrix, model selection by score ratio, motion recovery, triangulation
and cheirality checks).

RANSAC hypotheses are a batch axis: all hypotheses are solved with one
batched eigendecomposition, scored against all correspondences at once,
and the winner is an argmax. The reference package draws the 8-point and
4-point samples from a PRNG key; here `reconstruct` draws them from a
`torch.Generator` (`draw_samples`) unless the caller hands it
`sample_idx=(idx8, idx4)`, so that a test can give both packages the same
samples.

Correspondences are *normalized camera coordinates* (z = 1 plane), i.e.
already undistorted and unprojected; `focal` converts normalized
residuals to pixels so that the chi2 thresholds match the reference's
pixel-domain gating.

Eigenvectors and singular vectors come with a free sign. The E path's four
motions and the H path's eight are each closed under those signs (a flip
permutes them or negates every t), so the motion that wins the cheirality
vote is the same whatever the library returns; only its index may differ.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _smallest_eigvec(AtA: torch.Tensor) -> torch.Tensor:
    """[..., 9, 9] symmetric -> [..., 9] eigenvector of smallest eigenvalue."""
    _, V = torch.linalg.eigh(AtA)
    return V[..., :, 0]


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _fix_singular(E: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold: singular values (1, 1, 0)."""
    U, _, Vt = torch.linalg.svd(E)
    s_fix = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return U @ (s_fix[:, None] * Vt)


def essential_from_8pt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """8-point algorithm, batched over hypothesis sets.

    x1, x2: [..., 8, 2] normalized coords. Returns E [..., 3, 3] with
    enforced (1, 1, 0) singular values."""
    p1, p2 = _homog(x1), _homog(x2)
    # row = kron(p2, p1): x2^T E x1 = 0
    A = (p2[..., :, None] * p1[..., None, :]).reshape(*x1.shape[:-2], 8, 9)
    e = _smallest_eigvec(A.transpose(-1, -2) @ A)
    return _fix_singular(e.reshape(*e.shape[:-1], 3, 3))


def epipolar_score(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                   focal, sigma: float = 1.0):
    """Symmetric epipolar-distance score (reference: CheckFundamental).

    E: [S, 3, 3]; x1, x2: [N, 2]. Returns (score [S], inlier [S, N]).
    Per-point contribution = (5.991 - d^2/sigma^2) when d^2/sigma^2 < 3.841
    (1 dof), matching the reference's scoring."""
    p1, p2 = _homog(x1), _homog(x2)
    l2 = torch.einsum("sij,nj->sni", E, p1)        # epiline in image 2
    l1 = torch.einsum("sji,nj->sni", E, p2)        # epiline in image 1
    num = torch.einsum("ni,sni->sn", p2, l2)       # [S, N]
    f2 = focal * focal
    d2_2 = num ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12) * f2
    d2_1 = num ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12) * f2
    s2 = sigma * sigma
    th, th_score = 3.841, 5.991
    c1 = torch.where(d2_1 / s2 < th, th_score - d2_1 / s2, 0.0)
    c2 = torch.where(d2_2 / s2 < th, th_score - d2_2 / s2, 0.0)
    inlier = (d2_1 / s2 < th) & (d2_2 / s2 < th)
    return torch.sum(c1 + c2, dim=-1), inlier


def homography_from_4pt(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """4-point DLT homography, batched over hypothesis sets.

    x1, x2: [..., 4, 2] normalized coords. Returns H [..., 3, 3] with
    x2 ~ H x1 (reference: TwoViewReconstruction::ComputeH21)."""
    p1 = _homog(x1)                                      # [..., 4, 3]
    u2, v2 = x2[..., 0], x2[..., 1]
    z = torch.zeros_like(p1)
    # rows: [-p1, 0, u2*p1] and [0, -p1, v2*p1]
    r1 = torch.cat([-p1, z, u2[..., None] * p1], dim=-1)
    r2 = torch.cat([z, -p1, v2[..., None] * p1], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                      # [..., 8, 9]
    h = _smallest_eigvec(A.transpose(-1, -2) @ A)
    return h.reshape(*h.shape[:-1], 3, 3)


def _transfer(q: torch.Tensor) -> torch.Tensor:
    """Dehomogenize with the reference's guard on the third coordinate."""
    w = q[..., 2:]
    return q[..., :2] / torch.clamp(w.abs(), min=1e-9) * torch.sign(w)


def homography_score(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                     focal, sigma: float = 1.0):
    """Symmetric transfer-error score (reference: CheckHomography).

    H: [S, 3, 3]; x1, x2: [N, 2]. th = 5.991 (2 dof) both directions."""
    p1, p2 = _homog(x1), _homog(x2)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hinv = torch.linalg.inv(H + 1e-12 * eye)
    q2 = torch.einsum("sij,nj->sni", H, p1)              # x1 -> image 2
    q1 = torch.einsum("sij,nj->sni", Hinv, p2)           # x2 -> image 1
    f2 = focal * focal
    d2_2 = torch.sum((_transfer(q2) - x2[None]) ** 2, -1) * f2
    d2_1 = torch.sum((_transfer(q1) - x1[None]) ** 2, -1) * f2
    s2 = sigma * sigma
    th = 5.991
    c1 = torch.where(d2_1 / s2 < th, th - d2_1 / s2, 0.0)
    c2 = torch.where(d2_2 / s2 < th, th - d2_2 / s2, 0.0)
    inlier = (d2_1 / s2 < th) & (d2_2 / s2 < th)
    return torch.sum(c1 + c2, dim=-1), inlier


def _mat3(*e):
    """[3, 3] from nine 0-dim tensors or floats, row by row."""
    z = next(x for x in e if isinstance(x, torch.Tensor))
    return torch.stack([x if isinstance(x, torch.Tensor) else z * 0 + x
                        for x in e]).reshape(3, 3)


def decompose_H(H: torch.Tensor):
    """Faugeras decomposition: H [3,3] -> 8 candidate (R [8,3,3], t [8,3])
    (reference: TwoViewReconstruction::ReconstructH; t is returned
    unit-norm like the E path)."""
    U, d, Vt = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    x1v = (aux1, aux1, -aux1, -aux1)
    x3v = (aux3, -aux3, aux3, -aux3)
    st_signs = (1.0, -1.0, -1.0, 1.0)
    cross = torch.sqrt(torch.clamp(
        (d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero = torch.zeros_like(d1)

    Rs, ts = [], []
    # case d' = +d2
    aux_st = cross / torch.clamp((d1 + d3) * d2, min=1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=1e-12)
    for i in range(4):
        st = st_signs[i] * aux_st
        Rp = _mat3(ct, 0.0, -st, 0.0, 1.0, 0.0, st, 0.0, ct)
        tp = torch.stack([x1v[i], zero, -x3v[i]]) * (d1 - d3)
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    # case d' = -d2
    aux_sp = cross / torch.clamp((d1 - d3) * d2, min=1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=1e-12)
    for i in range(4):
        sp = st_signs[i] * aux_sp
        Rp = _mat3(cp, 0.0, sp, 0.0, -1.0, 0.0, sp, 0.0, -cp)
        tp = torch.stack([x1v[i], zero, x3v[i]]) * (d1 + d3)
        Rs.append(s * U @ Rp @ Vt)
        ts.append(U @ tp)
    Rs = torch.stack(Rs)
    ts = torch.stack(ts)
    tn = torch.linalg.norm(ts, dim=-1, keepdim=True)
    return Rs, ts / torch.clamp(tn, min=1e-12)


def decompose_E(E: torch.Tensor):
    """E [3,3] -> 4 candidate (R [4,3,3], t [4,3]) with unit-norm t."""
    U, _, Vt = torch.linalg.svd(E)
    # ensure proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))[..., None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _triangulate_and_check(R, t, x1, x2, focal, sigma: float,
                           min_parallax_cos: float = 0.99998):
    """Triangulate all N correspondences under relative poses (R, t) of
    camera2-from-camera1 (p_c2 = R p_c1 + t), batched over B motions.

    R [B,3,3], t [B,3]; x1, x2 [N,2]. Returns (points_c1 [B,N,3],
    good [B,N], n_good [B], cos_parallax [B,N])
    (reference: TwoViewReconstruction::CheckRT)."""
    d1 = _homog(x1)
    d1 = d1 / torch.linalg.norm(d1, dim=-1, keepdim=True)
    d2c2 = _homog(x2)
    d2c2 = d2c2 / torch.linalg.norm(d2c2, dim=-1, keepdim=True)
    # camera-2 centre in the camera-1 frame: c2 = -R^T t; ray 2 in c1: R^T d2
    o2 = -torch.einsum("bji,bj->bi", R, t)                      # [B,3]
    d2 = torch.einsum("bji,nj->bni", R, d2c2)                   # [B,N,3]

    b = torch.sum(d1[None] * d2, dim=-1)                        # [B,N]
    denom = torch.clamp(1.0 - b * b, min=1e-9)
    # closest-point depths: midpoint formulas with o1 = 0
    a1 = torch.einsum("ni,bi->bn", d1, o2)
    a2 = torch.einsum("bni,bi->bn", d2, o2)
    s1 = (a1 - b * a2) / denom
    s2 = (b * a1 - a2) / denom
    p1c = 0.5 * (s1[..., None] * d1[None] + o2[:, None, :]
                 + s2[..., None] * d2)

    z1 = p1c[..., 2]
    p2c = torch.einsum("bij,bnj->bni", R, p1c) + t[:, None, :]
    z2 = p2c[..., 2]
    # reprojection errors in pixels
    e1 = (p1c[..., :2] / torch.clamp(z1[..., None], min=1e-9) - x1) * focal
    e2 = (p2c[..., :2] / torch.clamp(z2[..., None], min=1e-9) - x2) * focal
    err_ok = ((torch.sum(e1 ** 2, dim=-1) < 4 * sigma * sigma)
              & (torch.sum(e2 ** 2, dim=-1) < 4 * sigma * sigma))
    good = (z1 > 0) & (z2 > 0) & err_ok & (s1 > 0) & (s2 > 0)
    good_par = good & (b < min_parallax_cos)
    return p1c, good_par, torch.sum(good_par, dim=-1, dtype=torch.int32), b


class TwoViewResult(NamedTuple):
    success: torch.Tensor    # [] bool
    R: torch.Tensor          # [3,3] camera2-from-camera1
    t: torch.Tensor          # [3] unit baseline
    points: torch.Tensor     # [N,3] in camera-1 frame
    is_good: torch.Tensor    # [N] triangulated + checked
    homography: torch.Tensor  # [] bool: the H model was selected (a field
                              # the reference's result does not carry)


def draw_samples(gen: torch.Generator, valid: torch.Tensor, n_hyp: int,
                 size: int) -> torch.Tensor:
    """[n_hyp, size] int64 indices drawn with replacement, uniformly among
    the valid correspondences (an invalid one has probability zero). With
    none valid the draw is uniform over all, and every hypothesis is then
    rejected for its invalid samples."""
    w = valid.to(torch.float32)
    w = w + (w.sum() <= 0).to(torch.float32)
    return torch.multinomial(w, n_hyp * size, replacement=True,
                             generator=gen).reshape(n_hyp, size)


def _best_hypothesis(score, inl, idx, valid):
    """Reject hypotheses drawn with an invalid sample, count only valid
    correspondences, take the argmax. Returns (best, score', inl')."""
    score = score - torch.where(torch.any(~valid[idx], dim=-1), 1e9, 0.0)
    inl = inl & valid[None, :]
    return torch.argmax(score), score, inl


def reconstruct(gen, x1: torch.Tensor, x2: torch.Tensor,
                valid: torch.Tensor, focal, sigma: float = 1.0,
                n_hyp: int = 256, min_inliers: int = 50,
                min_triangulated_frac: float = 0.5,
                use_homography: bool = True,
                sample_idx=None) -> TwoViewResult:
    """Monocular two-view initialization: E and H RANSAC with model
    selection by score ratio (reference: TwoViewReconstruction::
    Reconstruct — FindHomography and FindFundamental in two threads,
    RH = SH/(SH+SF) > 0.5 selects the homography, then ReconstructH /
    ReconstructF, src/TwoViewReconstruction.cc:48-120).

    gen: the generator the samples are drawn from (the 8-point draw first,
      then the 4-point draw) when `sample_idx` is not given;
    x1, x2: [N, 2] matched normalized coordinates; valid [N];
    sample_idx: optional (idx8 [n_hyp, 8], idx4 [n_hyp, 4]).
    No host read: every branch is a `torch.where`."""
    n = x1.shape[0]
    if sample_idx is None:
        idx = draw_samples(gen, valid, n_hyp, 8)
        idx4 = (draw_samples(gen, valid, n_hyp, 4) if use_homography
                else None)
    else:
        idx, idx4 = (None if s is None else s.to(torch.int64)
                     for s in sample_idx)
    E = essential_from_8pt(x1[idx], x2[idx])
    score, inl = epipolar_score(E, x1, x2, focal, sigma)
    best, score, inl = _best_hypothesis(score, inl, idx, valid)
    inlier = inl[best]

    # refine: weighted 8-point over the full consensus set (rows of the
    # DLT system scaled by the inlier mask), then re-gate
    w = inlier.to(x1.dtype)
    p1h, p2h = _homog(x1), _homog(x2)
    A = (p2h[:, :, None] * p1h[:, None, :]).reshape(n, 9) * w[:, None]
    E_ref = _fix_singular(_smallest_eigvec(A.T @ A).reshape(3, 3))
    sc_ref, inl_ref = epipolar_score(E_ref[None], x1, x2, focal, sigma)
    use_ref = sc_ref[0] >= score[best]
    E_best = torch.where(use_ref, E_ref, E[best])
    inlier_e = torch.where(use_ref, inl_ref[0] & valid, inlier)

    Rs_e, ts_e = decompose_E(E_best)

    if use_homography:
        H = homography_from_4pt(x1[idx4], x2[idx4])
        score_h_all, inl_h = homography_score(H, x1, x2, focal, sigma)
        best_h, score_h_all, inl_h = _best_hypothesis(score_h_all, inl_h,
                                                      idx4, valid)
        inlier_h = inl_h[best_h]
        score_h = score_h_all[best_h]
        score_e = torch.maximum(sc_ref[0], score[best])
        Rs_h, ts_h = decompose_H(H[best_h])

        # model selection (reference: RH = SH/(SH+SF), H if RH > 0.50)
        ratio = score_h / torch.clamp(score_h + score_e, min=1e-9)
        use_h = ratio > 0.50

        inlier = torch.where(use_h, inlier_h, inlier_e)
        Rs = torch.cat([Rs_e, Rs_h])
        ts = torch.cat([ts_e, ts_h])
        model_mask = torch.cat([(~use_h).expand(4), use_h.expand(8)])
        # H's 8 motions contain near-duplicates; the reference requires a
        # clearer winner there (0.75 against 0.9 for the second best)
        second_gate = torch.where(use_h, 0.75, 0.9)
    else:
        inlier = inlier_e
        Rs, ts = Rs_e, ts_e
        use_h = torch.zeros((), dtype=torch.bool, device=x1.device)
        model_mask = torch.ones(4, dtype=torch.bool, device=x1.device)
        second_gate = torch.tensor(0.9, device=x1.device)

    pts_all, good_all, _, _ = _triangulate_and_check(Rs, ts, x1, x2, focal,
                                                     sigma)
    n_good = torch.sum(good_all & inlier[None, :], dim=1, dtype=torch.int32)
    n_good = torch.where(model_mask, n_good, -1)
    k = torch.argmax(n_good)
    n_best = n_good[k]
    n_second = torch.sort(n_good).values[-2]
    n_inl = torch.sum(inlier, dtype=torch.int32)

    success = ((n_best >= min_inliers)
               & (n_best.to(torch.float32)
                  > min_triangulated_frac * n_inl.to(torch.float32))
               & (n_second.to(torch.float32)
                  < second_gate * n_best.to(torch.float32)))
    return TwoViewResult(success=success, R=Rs[k], t=ts[k],
                         points=pts_all[k], is_good=good_all[k] & inlier,
                         homography=use_h)
