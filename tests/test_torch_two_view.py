"""Two-view reconstruction and radtan undistortion of the port against the
JAX reference on the CPU.

* Radtan (the EuRoC cam0 coefficients of ORB-SLAM3's
  Monocular-Inertial/EuRoC.yaml, k1 = -0.28): `radtan_distort`,
  `radtan_undistort` and `undistort_pixels` on a grid over the whole
  752 x 480 image, corners included, equal to the reference's to 1e-5 px;
  the round trip closes to 2e-2 px at the corners (8 fixed-point
  iterations leave 0.011 px there, in both packages), 1e-4 px in the
  middle.
* One distorted EuRoC frame at its real width, 752 (not a multiple of the
  32-pixel FAST cell, nor are most of its pyramid levels), 1,000 features
  x 8 levels: keypoints, levels and validity exact, descriptor bits as in
  `test_torch_frontend.py`; `undistort_features` on the camera-batched
  [C, K, 2] and the single-camera [K, 2] layout to 1e-5 px.
* Every `two_view` function on a general scene and a planar one (a 1 m
  baseline 3-8 m out, 0.2 px noise, 20% outliers, 10% invalid rows):
  scores to 1e-3 relative and inlier masks exact on the reference's 256
  hypotheses; E and H up to their free sign (1e-4) on exact
  correspondences, for the samples whose null vector is well separated
  (the reference solves the DLT in unnormalized coordinates, and for
  about half of its random samples the float32 null vector is set by each
  library's rounding); the decompositions as
  sets of motions (1e-4), also for -E and -H: a sign of the library's
  eigenvectors or singular vectors permutes the candidates or negates
  every t, but never changes which motions there are, so the motion that
  wins the cheirality vote is the same in both packages (no
  canonicalization is needed); `_triangulate_and_check` masks and counts
  exact, points 1e-3 relative; the H branch of `reconstruct` (best
  hypothesis, its inliers, the eight motions' counts, the winner 1e-4).
* `reconstruct` with the reference's own samples (`jax.random.categorical`
  from the same key and logits) handed in, on the general scene:
  `success`, `is_good` exact, R and t 1e-4, points 1e-3 relative. With the
  port's own draws: only valid rows are drawn, and the scene still
  initializes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.geometry import cameras as jcam
from openmavis_tpu.solvers import two_view as jtv
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.geometry import cameras as tcam
from openmavis_tpu_torch.io import synthetic
from openmavis_tpu_torch.solvers import two_view as ttv


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are tiny: one intra-op thread is as fast as
    eight, and eight per test worker oversubscribe the machine when the
    files of the suite run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = scene.EUROC_W, scene.EUROC_H
PIN = np.array(scene.EUROC_PINHOLE, np.float32)
DIST = np.array(scene.EUROC_RADTAN, np.float32)
FOCAL = float(PIN[0])
N_HYP = 256


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# radtan
# ---------------------------------------------------------------------------

def _pixel_grid():
    u, v = np.meshgrid(np.linspace(0, W - 1, 48), np.linspace(0, H - 1, 31))
    return np.stack([u.ravel(), v.ravel()], -1).astype(np.float32)


def test_radtan_against_reference():
    uv = _pixel_grid()
    xy = (uv - PIN[2:4]) / PIN[:2]
    np.testing.assert_allclose(
        _np(tcam.radtan_distort(_t(DIST), _t(xy))),
        _np(jcam.radtan_distort(jnp.asarray(DIST), jnp.asarray(xy))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        _np(tcam.radtan_undistort(_t(DIST), _t(xy))),
        _np(jcam.radtan_undistort(jnp.asarray(DIST), jnp.asarray(xy))),
        rtol=0, atol=1e-6)
    got = _np(tcam.undistort_pixels(_t(PIN), _t(DIST), _t(uv)))
    ref = _np(jcam.undistort_pixels(jnp.asarray(PIN), jnp.asarray(DIST),
                                    jnp.asarray(uv)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # k1 = -0.28 pulls the corners in by tens of pixels
    assert np.abs(got - uv).max() > 20


def test_radtan_round_trip():
    uv = _pixel_grid()
    ideal = _np(tcam.undistort_pixels(_t(PIN), _t(DIST), _t(uv)))
    xy = (ideal - PIN[2:4]) / PIN[:2]
    back = _np(tcam.radtan_distort(_t(DIST), _t(xy))) * PIN[:2] + PIN[2:4]
    err = np.linalg.norm(back - uv, axis=-1)
    centre = np.linalg.norm(uv - PIN[2:4], axis=-1) < 150
    assert err.max() < 2e-2, err.max()
    assert err[centre].max() < 1e-4, err[centre].max()
    ideal_j = np.asarray(jcam.undistort_pixels(
        jnp.asarray(PIN), jnp.asarray(DIST), jnp.asarray(uv)))
    xy_j = (ideal_j - PIN[2:4]) / PIN[:2]
    back_j = np.asarray(jcam.radtan_distort(
        jnp.asarray(DIST), jnp.asarray(xy_j))) * PIN[:2] + PIN[2:4]
    np.testing.assert_allclose(err, np.linalg.norm(back_j - uv, axis=-1),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def euroc_frame():
    """Camera 0's first frame of the mono-inertial scene, distorted."""
    world = synthetic.BlobWorld.create(seed=3, n=4000)
    R, t = synthetic.orbit_trajectory(2, radius=6.0, frac=0.01)
    params = np.zeros(8, np.float32)
    params[:4] = PIN
    img = synthetic.render_sequence(world, scene.PINHOLE, params, R[:1],
                                    t[:1], W, H, dist=DIST)
    return np.clip(img, 0, 255).astype(np.uint8).astype(np.float32)


def test_extract_and_undistort_at_ragged_width(euroc_frame):
    """Keypoints, levels and validity exact, but for the order of two
    keypoints whose responses tie to float32 rounding (pyramid levels >= 4
    differ by ~2e-4 between the packages, ROADMAP Queue 3): the top-k of a
    level may then swap them. Descriptors are compared by position."""
    cfg_j = jex.OrbConfig(n_features=1000, n_levels=8)
    cfg_t = tex.OrbConfig(n_features=1000, n_levels=8)
    assert W % cfg_t.cell != 0
    fj = jax.jit(lambda im: jex.extract_multicam(im, cfg_j))(
        jnp.asarray(euroc_frame))
    ft = tex.extract_multicam(torch.as_tensor(euroc_frame), cfg_t)
    xj, xt = _np(fj.xy)[0], _np(ft.xy)[0]
    np.testing.assert_array_equal(_np(ft.level), _np(fj.level))
    np.testing.assert_array_equal(_np(ft.valid), _np(fj.valid))
    moved = np.flatnonzero(np.any(xt != xj, axis=-1))
    assert len(moved) <= 4, moved
    resp_j = _np(fj.response)[0]
    for i in moved:
        # the same keypoint sits elsewhere in the port's list, on its
        # level, with a response that ties
        (j,) = np.flatnonzero(np.all(xt == xj[i], axis=-1))
        assert _np(ft.level)[0, j] == _np(fj.level)[0, i] >= 4
        assert abs(resp_j[i] - resp_j[j]) < 1e-3 * resp_j[i]
    order = np.array([np.flatnonzero(np.all(xt == p, axis=-1))[0]
                      for p in xj])
    assert int(ft.valid.sum()) > 900
    flips = _np(ft.desc)[0][order] != _np(fj.desc)[0]
    assert flips.mean() < 0.02, flips.mean()
    assert not flips[_np(fj.level)[0] == 0].any()
    # keypoints reach the right-hand border band
    assert xt[_np(ft.valid)[0], 0].max() > W - 60

    # undistortion of the same keypoints in both packages
    rig_params = np.tile(np.r_[PIN, np.zeros(4, np.float32)], (1, 1))
    dist = convert.dist_from_numpy(DIST[None], device="cpu")
    ref = jex.undistort_features(fj, jnp.asarray(rig_params),
                                 jnp.asarray(DIST[None]))
    ft = tex.Features(*(_t(x) for x in fj))
    got = tex.undistort_features(ft, _t(rig_params), dist)
    np.testing.assert_allclose(_np(got.xy), _np(ref.xy), rtol=0, atol=1e-5)
    one = tex.undistort_features(tex.Features(*(x[0] for x in ft)),
                                 _t(rig_params[0]), dist[0])
    np.testing.assert_allclose(_np(one.xy), _np(ref.xy)[0], rtol=0,
                               atol=1e-5)
    assert tex.undistort_features(ft, _t(rig_params), None) is ft
    for a, b in zip(got[1:], ft[1:]):
        assert a is b


# ---------------------------------------------------------------------------
# two_view
# ---------------------------------------------------------------------------

def _rot(axis, ang):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def _two_view_scene(planar: bool, seed: int = 0, n: int = 300,
                    noise: float = 0.2, outliers: float = 0.2):
    """Normalized correspondences of camera 1 (identity) and camera 2
    (p_c2 = R p_c1 + t, a 1 m baseline): points 3-8 m out, or on a tilted
    plane 4 m out; `noise` px, a share `outliers` of random x2, 10% of the
    rows invalid. Returns dict(x1, x2, valid, R, t) in float32."""
    rng = np.random.default_rng(seed)
    R = _rot([0.2, 1.0, 0.1], 0.1)
    t = np.array([1.0, 0.1, 0.2])
    xy = rng.uniform(-0.6, 0.6, (n, 2))
    if planar:
        z = 4.0 + 0.8 * xy[:, 0] - 0.5 * xy[:, 1]
    else:
        z = rng.uniform(3.0, 8.0, n)
    P = np.c_[xy * z[:, None], z]
    P2 = P @ R.T + t
    x1 = P[:, :2] / P[:, 2:]
    x2 = P2[:, :2] / P2[:, 2:]
    x1 = x1 + rng.normal(0, noise / FOCAL, x1.shape)
    x2 = x2 + rng.normal(0, noise / FOCAL, x2.shape)
    out = rng.random(n) < outliers
    x2[out] = rng.uniform(-0.6, 0.6, (out.sum(), 2))
    valid = rng.random(n) > 0.1
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(x1=f32(x1), x2=f32(x2), valid=valid, R=f32(R),
                t=f32(t / np.linalg.norm(t)))


SCENES = ("general", "planar")


def _reference_draws(key, valid):
    """The samples the reference's `reconstruct(key, ...)` draws."""
    key_e, key_h = jax.random.split(key)
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return (np.asarray(jax.random.categorical(
                key_e, logits[None, None, :], shape=(N_HYP, 8))),
            np.asarray(jax.random.categorical(
                key_h, logits[None, None, :], shape=(N_HYP, 4))))


@pytest.fixture(scope="module", params=SCENES)
def tv(request):
    planar = request.param == "planar"
    s = _two_view_scene(planar, seed=0)
    s["clean"] = _two_view_scene(planar, seed=0, noise=0.0, outliers=0.0)
    s["key"] = jax.random.PRNGKey(7)
    s["idx8"], s["idx4"] = _reference_draws(s["key"], s["valid"])
    s["name"] = request.param
    return s


def _points_close(a, b, rel=1e-3):
    """|a - b| <= rel |b| per point."""
    d = np.linalg.norm(a - b, axis=-1)
    assert np.all(d <= rel * np.linalg.norm(b, axis=-1)), d.max()


def _normalized(M):
    M = np.asarray(M)
    return M / np.linalg.norm(M, axis=(-1, -2), keepdims=True)


def _solve_tolerance(x1, x2, idx, rows):
    """Per sample: 1e-4 plus the float32 perturbation bound of the DLT's
    null vector (Davis-Kahan: rounding of A^T A, ~eps * lambda_max, over
    the gap to the second-smallest eigenvalue, in float64). The reference
    solves in unnormalized coordinates, so for many random samples that
    gap is small and the float32 null vector is set by each library's
    rounding. Samples with a repeated row have no gap and are dropped.
    Returns (idx', tol [S'])."""
    keep, tol = [], []
    for r in idx:
        if len(set(r)) < len(r):
            continue
        p1 = np.c_[x1[r], np.ones(len(r))].astype(np.float64)
        A = rows(p1, x2[r].astype(np.float64))
        ev = np.linalg.eigvalsh(A.T @ A)
        keep.append(r)
        tol.append(1e-4 + 16 * 6e-8 * ev[-1] / ev[1])
    return np.array(keep), np.array(tol)


def _rows_e(p1, u2):
    p2 = np.c_[u2, np.ones(len(u2))]
    return (p2[:, :, None] * p1[:, None, :]).reshape(len(u2), 9)


def _rows_h(p1, u2):
    z = np.zeros_like(p1)
    return np.r_[np.c_[-p1, z, u2[:, :1] * p1], np.c_[z, -p1, u2[:, 1:] * p1]]


def test_minimal_solvers(tv):
    """E (general scene only: eight coplanar points leave a 3-D null
    space) and H up to their free sign, on exact correspondences and the
    reference's samples of distinct rows, each within its float32 bound;
    a tenth of them or more within 2e-4."""
    x1, x2 = tv["clean"]["x1"], tv["clean"]["x2"]
    for idx, rows in ((tv["idx8"], _rows_e), (tv["idx4"], _rows_h)):
        if idx.shape[1] == 8 and tv["name"] == "planar":
            continue
        idx, tol = _solve_tolerance(x1, x2, idx, rows)
        assert len(idx) > 200
        if idx.shape[1] == 8:
            Mj = jtv.essential_from_8pt(jnp.asarray(x1[idx]),
                                        jnp.asarray(x2[idx]))
            Mt = ttv.essential_from_8pt(_t(x1[idx]), _t(x2[idx]))
        else:
            Mj = jtv.homography_from_4pt(jnp.asarray(x1[idx]),
                                         jnp.asarray(x2[idx]))
            Mt = ttv.homography_from_4pt(_t(x1[idx]), _t(x2[idx]))
        a, b = _normalized(_np(Mt)), _normalized(_np(Mj))
        a = a * np.sign(np.sum(a * b, axis=(-1, -2), keepdims=True))
        err = np.abs(a - b).max(axis=(-1, -2))
        assert np.all(err <= tol), (err / tol).max()
        assert np.mean(err <= 2e-4) > 0.1, np.mean(err <= 2e-4)


def test_scores(tv):
    """Both scores on the reference's own 256 hypotheses of the noisy
    scene: inlier masks exact, sums 1e-3 relative (each term divides a
    small epipolar residual, summed in another order)."""
    x1, x2 = tv["x1"], tv["x2"]
    i8, i4 = tv["idx8"], tv["idx4"]
    Ej = jtv.essential_from_8pt(jnp.asarray(x1[i8]), jnp.asarray(x2[i8]))
    Hj = jtv.homography_from_4pt(jnp.asarray(x1[i4]), jnp.asarray(x2[i4]))
    for fj, ft, Mj in ((jtv.epipolar_score, ttv.epipolar_score, Ej),
                       (jtv.homography_score, ttv.homography_score, Hj)):
        sj, ij = fj(Mj, jnp.asarray(x1), jnp.asarray(x2), FOCAL)
        st, it = ft(_t(Mj), _t(x1), _t(x2), FOCAL)
        np.testing.assert_array_equal(_np(it), _np(ij))
        np.testing.assert_allclose(_np(st), _np(sj), rtol=1e-3, atol=1e-3)
        assert _np(it).sum() > 1000


def _motion_sets_equal(Rs_a, ts_a, Rs_b, ts_b, atol=1e-4):
    """Every motion of one list is in the other, and the other way."""
    for (Ra, ta, Rb, tb) in ((Rs_a, ts_a, Rs_b, ts_b),
                             (Rs_b, ts_b, Rs_a, ts_a)):
        for R, t in zip(Ra, ta):
            d = (np.abs(Rb - R).max(axis=(1, 2))
                 + np.abs(tb - t).max(axis=1))
            assert d.min() < atol, d.min()


def test_decompositions(tv):
    x1, x2 = tv["clean"]["x1"], tv["clean"]["x2"]
    i8, i4 = tv["idx8"], tv["idx4"]
    E = np.asarray(jtv.essential_from_8pt(jnp.asarray(x1[i8[:1]]),
                                          jnp.asarray(x2[i8[:1]]))[0])
    H = np.asarray(jtv.homography_from_4pt(jnp.asarray(x1[i4[:1]]),
                                           jnp.asarray(x2[i4[:1]]))[0])
    for sign in (1.0, -1.0):
        Rj, tj = jtv.decompose_E(jnp.asarray(E))
        Rt, tt = ttv.decompose_E(_t(sign * E))
        _motion_sets_equal(_np(Rt), _np(tt), _np(Rj), _np(tj))
        Rj, tj = jtv.decompose_H(jnp.asarray(H))
        Rt, tt = ttv.decompose_H(_t(sign * H))
        _motion_sets_equal(_np(Rt), _np(tt), _np(Rj), _np(tj))
        dets = np.linalg.det(_np(Rt))
        np.testing.assert_allclose(dets, 1.0, atol=1e-4)


def test_triangulate_and_check(tv):
    x1, x2 = tv["x1"], tv["x2"]
    Rs = np.stack([tv["R"], tv["R"]])
    ts = np.stack([tv["t"], -tv["t"]])
    got = ttv._triangulate_and_check(_t(Rs), _t(ts), _t(x1), _t(x2), FOCAL,
                                     1.0)
    for b in range(2):
        ref = jtv._triangulate_and_check(jnp.asarray(Rs[b]),
                                         jnp.asarray(ts[b]),
                                         jnp.asarray(x1), jnp.asarray(x2),
                                         FOCAL, 1.0)
        np.testing.assert_array_equal(_np(got[1][b]), _np(ref[1]))
        assert int(got[2][b]) == int(ref[2])
        good = _np(ref[1])
        _points_close(_np(got[0][b])[good], _np(ref[0])[good])
        np.testing.assert_allclose(_np(got[3][b]), _np(ref[3]), rtol=0,
                                   atol=1e-6)
    # the true motion passes cheirality; with the baseline flipped only a
    # few outliers do
    assert int(got[2][0]) > 180 and int(got[2][1]) < 10


def test_homography_branch(tv):
    """The H branch of `reconstruct` on the reference's own 4-point
    hypotheses: the best one and its inliers, then the cheirality counts
    of its eight motions and the winner; on the planar scene the winner is
    the scene's motion."""
    x1, x2, valid, i4 = tv["x1"], tv["x2"], tv["valid"], tv["idx4"]
    X1, X2 = jnp.asarray(x1), jnp.asarray(x2)
    Hj = jtv.homography_from_4pt(X1[i4], X2[i4])
    sj, ij = jtv.homography_score(Hj, X1, X2, FOCAL)
    sj = sj - jnp.where(jnp.any(~jnp.asarray(valid)[i4], -1), 1e9, 0.0)
    bj = int(jnp.argmax(sj))
    st, it = ttv.homography_score(_t(Hj), _t(x1), _t(x2), FOCAL)
    bt, _, it = ttv._best_hypothesis(st, it, _t(i4), _t(valid))
    assert int(bt) == bj
    inl = _np(ij[bj]) & valid
    np.testing.assert_array_equal(_np(it[bt]), inl)
    Rj, tj = (np.asarray(a) for a in jtv.decompose_H(Hj[bj]))
    Rt, tt = (_np(a) for a in ttv.decompose_H(_t(Hj[bj])))
    _motion_sets_equal(Rt, tt, Rj, tj)
    n_j = [int(jnp.sum(jtv._triangulate_and_check(
        jnp.asarray(R), jnp.asarray(t), X1, X2, FOCAL, 1.0)[1] & inl))
        for R, t in zip(Rj, tj)]
    _, good_t, _, _ = ttv._triangulate_and_check(_t(Rt), _t(tt), _t(x1),
                                                 _t(x2), FOCAL, 1.0)
    n_t = _np((good_t & _t(inl)[None]).sum(1))
    assert sorted(n_t.tolist()) == sorted(n_j)
    k_j, k_t = int(np.argmax(n_j)), int(np.argmax(n_t))
    np.testing.assert_allclose(Rt[k_t], Rj[k_j], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tt[k_t], tj[k_j], rtol=0, atol=1e-4)
    if tv["name"] == "planar":
        np.testing.assert_allclose(Rt[k_t], tv["R"], atol=2e-2)
        assert float(np.dot(tt[k_t], tv["t"])) > 0.98


def test_reconstruct_with_reference_samples():
    """The general scene, the reference's samples handed in. (On a planar
    scene the 8-point system has a 3-D null space, so the reference's E
    hypotheses are its eigensolver's arbitrary picks and the H-or-E
    selection at a score ratio near 0.5 depends on them; the H branch is
    held above, by `test_homography_branch`.)"""
    s = _two_view_scene(False, seed=0)
    key = jax.random.PRNGKey(7)
    idx8, idx4 = _reference_draws(key, s["valid"])
    x1, x2, valid = s["x1"], s["x2"], s["valid"]
    ref = jtv.reconstruct(key, jnp.asarray(x1), jnp.asarray(x2),
                          jnp.asarray(valid), focal=FOCAL)
    got = ttv.reconstruct(None, _t(x1), _t(x2), _t(valid), focal=FOCAL,
                          sample_idx=(_t(idx8), _t(idx4)))
    assert bool(ref.success) and bool(got.success)
    assert not bool(got.homography)
    np.testing.assert_array_equal(_np(got.is_good), _np(ref.is_good))
    np.testing.assert_allclose(_np(got.R), _np(ref.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(got.t), _np(ref.t), rtol=0, atol=1e-4)
    good = _np(ref.is_good)
    _points_close(_np(got.points)[good], _np(ref.points)[good])
    # the right motion: the scene's own rotation and baseline direction
    np.testing.assert_allclose(_np(got.R), s["R"], atol=2e-2)
    assert float(np.dot(_np(got.t), s["t"])) > 0.98
    assert good.sum() > 180 and not good[~valid].any()


def test_reconstruct_own_draws():
    s = _two_view_scene(False, seed=3)
    gen = torch.Generator()
    gen.manual_seed(0)
    valid = _t(s["valid"])
    idx = ttv.draw_samples(gen, valid, N_HYP, 8)
    assert idx.shape == (N_HYP, 8) and bool(valid[idx].all())
    none = ttv.draw_samples(gen, torch.zeros_like(valid), 4, 8)
    assert none.shape == (4, 8)
    res = ttv.reconstruct(gen, _t(s["x1"]), _t(s["x2"]), valid, focal=FOCAL)
    assert bool(res.success)
    np.testing.assert_allclose(_np(res.R), s["R"], atol=2e-2)
    assert float(np.dot(_np(res.t), s["t"])) > 0.98
    # no valid correspondence: every hypothesis is rejected
    res = ttv.reconstruct(gen, _t(s["x1"]), _t(s["x2"]),
                          torch.zeros_like(valid), focal=FOCAL)
    assert not bool(res.success) and not bool(res.is_good.any())
