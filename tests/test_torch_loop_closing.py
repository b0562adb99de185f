"""Parity of the port's loop closer with the JAX reference on the CPU:
`bow.scores`, `covisibility_matrix`, `add_loop_edge`, the Sim3 solvers
(`horn_sim3`, `ransac_sim3_reproj`, `refine_sim3`), the pose-graph
optimizers, the matched-pair functions and the group verification of
`loop_closing.py`, `_correct_map`, the whole-map BA steps, and the loop
closing step `make_lc_step` as a whole on a staged revisit.

The staged revisit is a numpy-built map (14 keyframe slots, 2 cameras x
64 features, 512 landmarks): keyframes 0-3 map a set of world points,
keyframes 4-8 another set, and keyframes 9-11 come back to the first set
under a known drift (a yaw about gravity and a translation), binding it
to NEW landmarks that duplicate the old ones, as a drifted tracker does.
Keyframe 11 is the query: retrieval finds keyframe 0, the pairs, the
RANSAC, the refinement, the group verification and the tilt gate pass,
and the 4DoF essential-graph correction fires. Keyframe 12 then arrives
and the amortized post-loop FullInertialBA runs one step.

JAX runs on the CPU (its matcher then takes the plain `masked_best2`;
the Pallas form in interpret mode is held in test_torch_matcher.py); the
port runs with CPU tensors and so through its kernels' plain versions.
The RANSAC samples are the ones JAX drew, handed to the port.

Tolerances, stated at each test: indices, masks and counts exact; closed
forms 1e-5; iterated float32 solves 1e-4 (the staged step as a whole
1e-3: float32 normal equations summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.geometry import cameras as jcam
from openmavis_tpu.imu import preintegration as jpre
from openmavis_tpu.optim import pose_graph as jpg
from openmavis_tpu.optim import sim3_refine as jref
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu.pipeline import loop_closing as jlc
from openmavis_tpu.pipeline import streaming_lc as jslc
from openmavis_tpu.pipeline import streaming_vi as jsv
from openmavis_tpu.pipeline import tracking as jtrk
from openmavis_tpu.slam_map import bow as jbow
from openmavis_tpu.slam_map import map_state as jms
from openmavis_tpu.solvers import sim3 as jsim3
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.frontend import matcher_cuda
from openmavis_tpu_torch.imu import preintegration as tpre
from openmavis_tpu_torch.optim import pose_graph as tpg
from openmavis_tpu_torch.optim import sim3_refine as tref
from openmavis_tpu_torch.pipeline import loop_closing as tlc
from openmavis_tpu_torch.pipeline import streaming_lc as tslc
from openmavis_tpu_torch.pipeline import streaming_vi as tsv
from openmavis_tpu_torch.pipeline import tracking as ttrk
from openmavis_tpu_torch.slam_map import bow as tbow
from openmavis_tpu_torch.slam_map import map_state as tms
from openmavis_tpu_torch.solvers import sim3 as tsim3

K, C, F, M = 14, 2, 64, 512
CF = C * F
W, H = 320.0, 240.0
N_SET = 60                  # world points per set
SLOT, CAND = 11, 0
DT_KF = 0.25
G = np.array([0.0, 0.0, -9.81])
# body axes in the world: the cameras look along world +x, gravity is -z
R_LOOK = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
DRIFT_YAW, DRIFT_T = 0.015, np.array([0.06, -0.05, 0.02])
LC_KW = dict(score_min=10, temporal=1, recent_exclude=2, gba_steps=1)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _as_dict(nt):
    # np.array copies: arrays handed over from jax are read-only
    return {k: np.array(v) for k, v in nt._asdict().items()}


def _jmap(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _project(rig_np, cam, R_wb, t_wb, X):
    """uv [N,2] and depth [N] of world points in camera `cam` of a body at
    (R_wb, t_wb), by the JAX package's camera model."""
    p_b = (X - t_wb) @ R_wb
    p_c = p_b @ rig_np["R_cb"][cam].T + rig_np["t_cb"][cam]
    uv = np.asarray(jcam.project(rig_np["kind"],
                                 jnp.asarray(rig_np["params"][cam]),
                                 jnp.asarray(p_c, jnp.float32)))
    return uv, p_c[:, 2]


def build_revisit(n_cams: int = C):
    """The staged revisit as numpy: (map dict, carry pieces, rig dict), on
    the first `n_cams` cameras of the rig (C: two)."""
    rng = np.random.default_rng(11)
    rig_full = scene.build_rig("kb8", int(W), int(H))
    rig_np = {k: (v if k == "kind" else v[:n_cams])
              for k, v in rig_full.items()}

    # true trajectory: a small closed circuit in the y-z plane
    ang = np.linspace(0.0, 2.0 * np.pi, 12, endpoint=False)
    ang = np.concatenate([ang, [ang[1] * 0.4, ang[1] * 0.8]])
    t_true = np.stack([0.05 * np.sin(2 * ang), 0.3 * np.sin(ang),
                       0.2 * (1 - np.cos(ang))], axis=1)
    t_true[11] = t_true[0] + np.array([0.02, 0.04, -0.03])
    R_true = np.stack([_rot_z(0.03 * np.sin(a + 0.3)) @ R_LOOK for a in ang])

    # world points: set A in front, set B further to the side
    def cloud(center, n):
        return center + rng.uniform(-1.0, 1.0, (n, 3)) * np.array(
            [2.0, 0.9, 0.8])

    X_a = cloud(np.array([6.0, 0.0, 0.1]), N_SET)
    X_b = cloud(np.array([6.5, 0.3, -0.1]), N_SET)
    desc_a = (rng.random((N_SET, 256)) > 0.5).astype(np.int8)
    desc_b = (rng.random((N_SET, 256)) > 0.5).astype(np.int8)
    # the second camera sees each point with 6 of its bits flipped
    flip = np.zeros((2, N_SET, 256), bool)
    for n in range(N_SET):
        flip[1, n, rng.choice(256, 6, replace=False)] = True

    # estimated state: keyframes 9-11 and their landmarks carry the drift
    D_R, D_t = _rot_z(DRIFT_YAW), DRIFT_T
    drifted = np.zeros(K, bool)
    drifted[9:12] = True
    R_est = np.where(drifted[:, None, None], D_R @ R_true, R_true)
    t_est = np.where(drifted[:, None], t_true @ D_R.T + D_t, t_true)

    m = _as_dict(jms.allocate(K, n_cams * F, M))
    # landmark ids: A 0..59 (first seen by KF 0), B 60..119 (KF 4),
    # A' 120..179 (KF 9: the same world points, drifted)
    sets = {"A": (0, X_a, desc_a, 0), "B": (60, X_b, desc_b, 4),
            "A2": (120, X_a @ D_R.T + D_t, desc_a, 9)}
    for base, X, desc, first in sets.values():
        ids = base + np.arange(N_SET)
        m["mp_pos"][ids] = X
        m["mp_desc"][ids] = desc
        m["mp_valid"][ids] = True
        m["mp_first_kf"][ids] = first
        m["mp_last_kf"][ids] = first
        d = X - t_est[first]
        dist = np.linalg.norm(d, axis=1)
        m["mp_normal"][ids] = d / dist[:, None]
        m["mp_dmax"][ids] = dist
        m["mp_dmin"][ids] = dist / 1.2 ** 7
        m["mp_visible"][ids] = 4
        m["mp_found"][ids] = 4
    m["n_mp"] = np.asarray(180, np.int32)

    # which set, and how much of it, each keyframe observes
    plan = {0: ("A", 60), 1: ("A", 40), 2: ("A", 40), 3: ("A", 40),
            4: ("B", 60), 5: ("B", 60), 6: ("B", 60), 7: ("B", 60),
            8: ("B", 60), 9: ("A2", 40), 10: ("A2", 40), 11: ("A2", 60),
            12: ("A", 50)}
    for k, (name, n_obs) in plan.items():
        base, _, desc, _ = sets[name]
        X_true = X_a if name in ("A", "A2") else X_b
        for c in range(n_cams):
            uv, depth = _project(rig_np, c, R_true[k], t_true[k],
                                 X_true[:n_obs])
            assert np.all(depth > 1.0) and np.all(uv > 4.0) \
                and np.all(uv[:, 0] < W - 4) and np.all(uv[:, 1] < H - 4)
            sl = slice(c * F, c * F + n_obs)
            m["kf_xy"][k, sl] = uv + rng.normal(0, 0.3, uv.shape)
            m["kf_desc"][k, sl] = np.where(flip[c, :n_obs], 1 - desc[:n_obs],
                                           desc[:n_obs])
            m["kf_feat_valid"][k, sl] = True
            m["kf_obs"][k, sl] = base + np.arange(n_obs)
        m["kf_cam"][k] = np.repeat(np.arange(n_cams), F)
        m["kf_bow"][k] = np.asarray(jbow.histogram(
            jnp.asarray(m["kf_desc"][k]), jnp.asarray(m["kf_feat_valid"][k])))
    m["kf_R"][:] = R_est
    m["kf_t"][:] = t_est
    m["kf_time"][:] = np.arange(K) * DT_KF
    v = np.gradient(t_est, DT_KF, axis=0)
    m["kf_v"][:] = v
    m["kf_valid"][:12] = True
    m["n_kf"] = np.asarray(12, np.int32)
    m = {k: np.asarray(x, jms.allocate(1, 1, 1)._asdict()[k].dtype)
         for k, x in m.items()}

    # a preintegration chain consistent with the estimated trajectory
    # (entry k covers keyframe k-1 -> k); bias Jacobians zero
    chain = _as_dict(jpre.chain_allocate(K))
    for k in range(1, K):
        R1 = R_est[k - 1]
        chain["dR"][k] = R1.T @ R_est[k]
        chain["dV"][k] = R1.T @ (v[k] - v[k - 1] - G * DT_KF)
        chain["dP"][k] = R1.T @ (t_est[k] - t_est[k - 1] - v[k - 1] * DT_KF
                                 - 0.5 * G * DT_KF ** 2)
        chain["C"][k] = np.eye(15) * 1e-4
        chain["dT"][k] = DT_KF
    chain = {k: np.asarray(x, np.float32) for k, x in chain.items()}
    chain_valid = np.zeros(K, bool)
    chain_valid[1:12] = True
    return m, dict(chain=chain, chain_valid=chain_valid), rig_np


class Staged:
    """The revisit map in both packages."""

    def __init__(self):
        m_np, carry_np, rig_np = build_revisit()
        self.m_np, self.rig_np = m_np, rig_np
        self.jm = _jmap(m_np)
        self.tm = convert.map_from_numpy(m_np, device="cpu")
        self.jrig = JRig(rig_np["kind"], *(jnp.asarray(rig_np[k]) for k in
                                           ("params", "R_cb", "t_cb")))
        self.trig = convert.rig_from_numpy(rig_np, device="cpu")
        kw = scene.bench_config_kwargs(16, max_kf=K, max_mp=M)
        kw.update(img_w=int(W), img_h=int(H), n_cams=C, obs_cap=2048)
        self.jcfg = jsv.VIStreamConfig(
            orb=jex.OrbConfig(n_features=F, n_levels=3), **kw)
        self.tcfg = tsv.VIStreamConfig(
            orb=tex.OrbConfig(n_features=F, n_levels=3), **kw)
        jc = jsv.init_carry(self.jcfg, seed=5)
        self.jc = jc._replace(
            R=self.jm.kf_R[SLOT], p=self.jm.kf_t[SLOT], v=self.jm.kf_v[SLOT],
            imu_ok=jnp.asarray(True), mode=jnp.asarray(2, jnp.int32),
            last_kf_slot=jnp.asarray(SLOT, jnp.int32),
            chain=jpre.Preintegrated(**{k: jnp.asarray(x) for k, x in
                                        carry_np["chain"].items()}),
            chain_valid=jnp.asarray(carry_np["chain_valid"]))
        self.tc = self.port_carry(self.jc)

    @staticmethod
    def port_carry(jc):
        d = {k: (v._asdict() if hasattr(v, "_asdict") else v)
             for k, v in jc._asdict().items()}
        d = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else np.asarray(v))
             for k, v in d.items()}
        return convert.carry_from_numpy(d, device="cpu")

    def jax_pairs(self):
        nn = jlc._pairs_from_tables(jlc._tables(self.jm), jlc._tables(self.jm),
                                    SLOT, CAND)
        pr = jlc.pairs_by_projection(self.jm, SLOT, CAND, self.jrig.kind, C,
                                     self.jrig, W, H)
        return nn, pr


@pytest.fixture(scope="module")
def staged():
    return Staged()


def _pairs_close(tp, jp, tol=1e-5):
    """valid and camera ids exact, points/keypoints to `tol` where valid."""
    v = _np(jp.valid)
    np.testing.assert_array_equal(convert._np(tp.valid), v)
    assert v.sum() > 0
    for name in ("cam_a", "cam_b"):
        np.testing.assert_array_equal(convert._np(getattr(tp, name))[v],
                                      _np(getattr(jp, name))[v], err_msg=name)
    for name in ("p_a", "p_b", "uv_a", "uv_b", "sigma2_a", "sigma2_b"):
        np.testing.assert_allclose(convert._np(getattr(tp, name))[v],
                                   _np(getattr(jp, name))[v], atol=tol,
                                   rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# map-side pieces: exact
# ---------------------------------------------------------------------------

def test_bow_scores_exact(staged):
    for slot in (0, 5, SLOT):
        got = tbow.scores(staged.tm.kf_bow, staged.tm.kf_bow[slot])
        ref = jbow.scores(staged.jm.kf_bow, staged.jm.kf_bow[slot])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(convert._np(got), _np(ref))
    # the query scores its twin (same descriptors) as high as itself
    assert int(got[CAND]) == int(got[SLOT]) == 2 * 2 * N_SET


def test_covisibility_matrix_exact(staged):
    got = tms.covisibility_matrix(staged.tm)
    ref = jms.covisibility_matrix(staged.jm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(convert._np(got), _np(ref))
    assert int(got[SLOT, 9]) == 40 and int(got[SLOT, CAND]) == 0


def test_add_loop_edge_exact(staged):
    tm, jm = staged.tm, staged.jm
    for n, (i, j) in enumerate([(0, 11), (3, 9)] * 9):   # wraps the ring
        tm, jm = tms.add_loop_edge(tm, i, j), jms.add_loop_edge(jm, i, j)
    for name in ("loop_i", "loop_j", "loop_valid", "n_loop"):
        a, b = convert._np(getattr(tm, name)), _np(getattr(jm, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(tm.n_loop) == 18


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3(fix_scale):
    """Closed form: 1e-5."""
    rng = np.random.default_rng(0)
    p1 = rng.normal(0, 2.0, (7, 20, 3)).astype(np.float32)
    Rt = np.stack([_rot_z(a) @ R_LOOK for a in rng.uniform(-1, 1, 7)])
    s = rng.uniform(0.5, 2.0, 7)
    p2 = (s[:, None, None] * np.einsum("bij,bnj->bni", Rt, p1)
          + rng.normal(0, 1, (7, 1, 3))).astype(np.float32)
    p2 += rng.normal(0, 1e-3, p2.shape).astype(np.float32)
    got = tsim3.horn_sim3(_t(p1), _t(p2), fix_scale=fix_scale)
    ref = jsim3.horn_sim3(jnp.asarray(p1), jnp.asarray(p2),
                          fix_scale=fix_scale)
    for g_, r_ in zip(got, ref):
        np.testing.assert_allclose(convert._np(g_), _np(r_), atol=1e-5,
                                   rtol=1e-5)


def _noisy_pairs(staged, seed=3):
    """The revisit's NN + projection pairs, with pixel noise and a fifth
    of the pairs turned into outliers; (JAX pairs, port pairs)."""
    nn, pr = staged.jax_pairs()
    jp = jax.tree.map(lambda a, b: np.concatenate([_np(a), _np(b)]), nn, pr)
    rng = np.random.default_rng(seed)
    n = jp.valid.shape[0]
    uv_b = jp.uv_b + rng.normal(0, 0.4, (n, 2)).astype(np.float32)
    out = rng.random(n) < 0.2
    p_b = np.where(out[:, None], jp.p_b + rng.normal(0, 0.8, (n, 3)),
                   jp.p_b).astype(np.float32)
    jp = jp._replace(uv_b=uv_b, p_b=p_b)
    tp = tlc.MatchedPairs(*(_t(x) for x in jp))
    return jlc.MatchedPairs(*(jnp.asarray(x) for x in jp)), tp


@pytest.mark.parametrize("fix_scale", [False, True])
def test_ransac_sim3_reproj(staged, fix_scale):
    """With the samples JAX drew: inlier mask and counts exact, the Sim3
    to 1e-4."""
    jp, tp = _noisy_pairs(staged)
    key = jax.random.PRNGKey(7)
    logits = jnp.where(jp.valid, 0.0, -1e9)
    idx = jax.random.categorical(key, logits[None, None, :], shape=(128, 3))
    ref = jsim3.ransac_sim3_reproj(key, jp, staged.jrig.kind, staged.jrig,
                                   fix_scale=fix_scale)
    got = tsim3.ransac_sim3_reproj(None, tp, staged.trig.kind, staged.trig,
                                   fix_scale=fix_scale,
                                   sample_idx=_t(idx).to(torch.int64))
    assert bool(ref.success) and bool(got.success)
    assert int(got.n_inliers) == int(ref.n_inliers) >= 60
    np.testing.assert_array_equal(convert._np(got.inlier), _np(ref.inlier))
    for name in ("s", "R", "t"):
        np.testing.assert_allclose(convert._np(getattr(got, name)),
                                   _np(getattr(ref, name)), atol=1e-4,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("relative_th", [True, False])
def test_ransac_sim3_3d_gate(staged, relative_th):
    """The 3D-distance form with the samples JAX drew: inliers exact, the
    Sim3 to 1e-4."""
    jp, tp = _noisy_pairs(staged, seed=5)
    key = jax.random.PRNGKey(9)
    idx = jax.random.categorical(
        key, jnp.where(jp.valid, 0.0, -1e9)[None, None, :], shape=(128, 3))
    kw = dict(fix_scale=False, relative_th=relative_th,
              inlier_th=0.02 if relative_th else 0.1)
    ref = jsim3.ransac_sim3(key, jp.p_a, jp.p_b, jp.valid, **kw)
    got = tsim3.ransac_sim3(None, tp.p_a, tp.p_b, tp.valid,
                            sample_idx=_t(idx).to(torch.int64), **kw)
    assert bool(ref.success) and bool(got.success)
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(convert._np(got.inlier), _np(ref.inlier))
    for name in ("s", "R", "t"):
        np.testing.assert_allclose(convert._np(getattr(got, name)),
                                   _np(getattr(ref, name)), atol=1e-4,
                                   rtol=0, err_msg=name)


def test_ransac_draws_only_valid_pairs_and_survives_none(staged):
    """The port's own draw: invalid pairs are never sampled; with fewer
    than three valid pairs (or none) the solver rejects, it never raises."""
    _, tp = _noisy_pairs(staged)
    gen = torch.Generator().manual_seed(3)
    idx = tsim3.draw_samples(gen, tp.valid)
    assert idx.shape == (128, 3) and bool(tp.valid[idx].all())
    res = tsim3.ransac_sim3_reproj(gen, tp, staged.trig.kind, staged.trig,
                                   fix_scale=True)
    assert bool(res.success) and int(res.n_inliers) >= 60
    for n_valid in (0, 2):
        keep = torch.zeros_like(tp.valid)
        keep[torch.nonzero(tp.valid)[:n_valid, 0]] = True
        res = tsim3.ransac_sim3_reproj(gen, tp._replace(valid=keep),
                                       staged.trig.kind, staged.trig,
                                       fix_scale=True)
        assert not bool(res.success) and int(res.n_inliers) <= n_valid


@pytest.mark.parametrize("fix_scale", [False, True])
def test_refine_sim3(staged, fix_scale):
    """From a perturbed start: s, R, t to 1e-4, inliers exact."""
    jp, tp = _noisy_pairs(staged, seed=4)
    nn, _ = staged.jax_pairs()
    s0, R0, t0 = jsim3.horn_sim3(nn.p_a[_np(nn.valid)], nn.p_b[_np(nn.valid)],
                                 fix_scale=True)
    R0 = _np(R0) @ _rot_z(0.01)
    t0 = _np(t0) + np.array([0.03, -0.02, 0.01], np.float32)
    s0 = np.float32(1.0 if fix_scale else 1.02)
    rj, rt = staged.jrig, staged.trig
    ca, cb = _np(jp.cam_a), _np(jp.cam_b)
    ref = jref.refine_sim3(
        jnp.asarray(s0), jnp.asarray(R0, jnp.float32), jnp.asarray(t0),
        jp.p_a, jp.p_b, jp.uv_a, jp.uv_b, jp.sigma2_a, jp.sigma2_b, jp.valid,
        rj.kind, rj.params[ca], rj.params[cb], rj.R_cb[ca], rj.t_cb[ca],
        rj.R_cb[cb], rj.t_cb[cb], fix_scale=fix_scale)
    ca, cb = tp.cam_a.to(torch.int64), tp.cam_b.to(torch.int64)
    got = tref.refine_sim3(
        _t(s0), _t(R0.astype(np.float32)), _t(t0), tp.p_a, tp.p_b, tp.uv_a,
        tp.uv_b, tp.sigma2_a, tp.sigma2_b, tp.valid, rt.kind, rt.params[ca],
        rt.params[cb], rt.R_cb[ca], rt.t_cb[ca], rt.R_cb[cb], rt.t_cb[cb],
        fix_scale=fix_scale)
    assert got.s.dtype == torch.float32
    assert int(got.n_inliers) == int(ref.n_inliers) >= 60
    np.testing.assert_array_equal(convert._np(got.inlier), _np(ref.inlier))
    for name in ("s", "R", "t"):
        np.testing.assert_allclose(convert._np(getattr(got, name)),
                                   _np(getattr(ref, name)), atol=1e-4,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(float(got.chi2), float(ref.chi2), rtol=1e-3)


# ---------------------------------------------------------------------------
# pose graph: a 12-node ring with drift and one loop edge
# ---------------------------------------------------------------------------

def _ring(n=12):
    rng = np.random.default_rng(2)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    R_wk = np.stack([_rot_z(a) @ R_LOOK for a in ang])
    t_wk = np.stack([3 * np.cos(ang), 3 * np.sin(ang), 0.1 * ang], axis=1)
    R_cw = R_wk.transpose(0, 2, 1)
    t_cw = -np.einsum("kij,kj->ki", R_cw, t_wk)
    # drifting odometry: each node's pose gets an accumulated yaw/offset
    yaw = np.cumsum(rng.normal(0, 0.01, n))
    off = np.cumsum(rng.normal(0, 0.03, (n, 3)), axis=0)
    R_d = np.stack([R_cw[k] @ _rot_z(yaw[k]).T for k in range(n)])
    t_d = t_cw + off
    f32 = lambda x: np.asarray(x, np.float32)
    return f32(R_cw), f32(t_cw), f32(R_d), f32(t_d)


def test_sequential_edges_exact():
    _, _, R_d, t_d = _ring()
    s = np.ones(12, np.float32)
    je = jpg.sequential_edges(jnp.asarray(s), jnp.asarray(R_d),
                              jnp.asarray(t_d), jnp.asarray(9), 12)
    te = tpg.sequential_edges(_t(s), _t(R_d), _t(t_d), torch.tensor(9), 12)
    for name in ("i", "j", "valid"):
        np.testing.assert_array_equal(convert._np(getattr(te, name)),
                                      _np(getattr(je, name)), err_msg=name)
    for name in ("s", "R", "t", "weight"):
        np.testing.assert_allclose(convert._np(getattr(te, name)),
                                   _np(getattr(je, name)), atol=1e-6)
    j3 = jpg.sequential_edges_se3(jnp.asarray(R_d), jnp.asarray(t_d),
                                  jnp.asarray(9), 12)
    t3 = tpg.sequential_edges_se3(_t(R_d), _t(t_d), torch.tensor(9), 12)
    np.testing.assert_array_equal(convert._np(t3.valid), _np(j3.valid))
    np.testing.assert_allclose(convert._np(t3.t), _np(j3.t), atol=1e-6)


@pytest.mark.parametrize("dof4", [False, True])
def test_optimize_pose_graph(dof4):
    """Drifted ring + the true loop edge 0 -> 11: poses 1e-4, final chi2
    1e-3 relative, and the solve pulled the loop closed."""
    R_cw, t_cw, R_d, t_d = _ring()
    n = 12
    s = np.ones(n, np.float32)
    # the loop edge measures the TRUE relative pose of nodes 0 and 11
    R_l = R_cw[11] @ R_cw[0].T
    t_l = t_cw[11] - R_l @ t_cw[0]
    fixed = np.zeros(n, bool)
    fixed[0] = True
    valid = np.ones(n, bool)

    def run(xp, pg, arr):
        seq = pg.sequential_edges(arr(s), arr(R_d), arr(t_d), arr(n), n)
        cat = (jnp.concatenate if xp is jnp else torch.cat)
        loop = dict(i=arr(np.array([0])), j=arr(np.array([11])),
                    s=arr(np.ones(1, np.float32)), R=arr(R_l[None]),
                    t=arr(t_l[None]), weight=arr(np.full(1, 5.0, np.float32)),
                    valid=arr(np.ones(1, bool)))
        e = pg.PoseGraphEdges(*(cat([a, loop[k]]) for k, a in
                                zip(seq._fields, seq)))
        if dof4:
            e3 = pg.PoseGraphEdgesSE3(i=e.i, j=e.j, R=e.R, t=e.t,
                                      weight=e.weight, valid=e.valid)
            R_o, t_o, chi = pg.optimize_pose_graph_4dof(
                arr(R_d), arr(t_d), e3, arr(fixed), arr(valid))
            return np.ones(n), R_o, t_o, chi
        return pg.optimize_pose_graph(arr(s), arr(R_d), arr(t_d), e,
                                      arr(fixed), arr(valid))

    ref = [_np(x) for x in run(jnp, jpg, jnp.asarray)]
    got = [convert._np(x) if isinstance(x, torch.Tensor) else x
           for x in run(torch, tpg, _t)]
    for name, g_, r_ in zip(("s", "R", "t"), got, ref):
        np.testing.assert_allclose(g_, r_, atol=1e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-3, atol=1e-7)
    # the loop is closed: the relative pose of nodes 0 and 11 moved from
    # its drifted value towards the measured one
    before = np.linalg.norm(t_d[11] - (R_d[11] @ R_d[0].T) @ t_d[0] - t_l)
    after = np.linalg.norm(got[2][11] - (got[1][11] @ got[1][0].T) @ got[2][0]
                           - t_l)
    assert after < 0.25 * before


# ---------------------------------------------------------------------------
# the modules that reach the matching kernels
# ---------------------------------------------------------------------------

def test_pairs_from_tables(staged):
    """valid and camera ids exact, points 1e-5."""
    launches = matcher_cuda.launch_count()
    tp = tlc._pairs_from_tables(tlc._tables(staged.tm), tlc._tables(staged.tm),
                                SLOT, CAND)
    assert matcher_cuda.launch_count() == launches     # CPU run: plain version
    nn, _ = staged.jax_pairs()
    _pairs_close(tp, nn)
    assert int(tp.valid.sum()) >= 100


def test_pairs_by_projection(staged):
    tp = tlc.pairs_by_projection(staged.tm, SLOT, CAND, staged.trig.kind, C,
                                 staged.trig, W, H)
    _, pr = staged.jax_pairs()
    _pairs_close(tp, pr)
    # one pair per landmark of the candidate (its best camera)
    assert int(tp.valid.sum()) >= 50


@pytest.mark.parametrize("good", [True, False])
def test_group_projection_score(staged, good):
    """The score is an integer: exact. A hypothesis off by 0.5 m finds
    (next to) nothing."""
    jm, tm = staged.jm, staged.tm
    R_rel = _np(jm.kf_R[CAND]).T @ (_rot_z(DRIFT_YAW).T @ _np(jm.kf_R[SLOT]))
    t_true = (_np(jm.kf_t[SLOT]) - DRIFT_T) @ _rot_z(DRIFT_YAW)
    t_rel = _np(jm.kf_R[CAND]).T @ (t_true - _np(jm.kf_t[CAND]))
    if not good:
        t_rel = t_rel + np.array([0.5, 0.0, 0.0])
    s, R, t = np.float32(1.0), R_rel.astype(np.float32), \
        t_rel.astype(np.float32)
    cov_j = jms.covisibility_matrix(jm)
    ref = jlc.group_projection_score(jm, SLOT, CAND, cov_j[CAND],
                                     jnp.asarray(s), jnp.asarray(R),
                                     jnp.asarray(t), staged.jrig.kind, C,
                                     staged.jrig, W, H)
    cov_t = tms.covisibility_matrix(tm)
    got = tlc.group_projection_score(tm, SLOT, CAND, cov_t[CAND], _t(s),
                                     _t(R), _t(t), staged.trig.kind, C,
                                     staged.trig, W, H)
    assert got.dtype == torch.int32 and int(got) == int(ref)
    assert int(got) >= 100 if good else int(got) < 25


# ---------------------------------------------------------------------------
# correction and whole-map BA
# ---------------------------------------------------------------------------

def test_correct_map(staged):
    """Poses and points to 1e-4 (closed form; 1e-5 holds too)."""
    rng = np.random.default_rng(6)
    R_cw = _np(staged.jm.kf_R).transpose(0, 2, 1)
    t_cw = -np.einsum("kij,kj->ki", R_cw, _np(staged.jm.kf_t))
    R_new = np.stack([_rot_z(a) @ R for a, R in
                      zip(rng.normal(0, 0.02, K), R_cw)]).astype(np.float32)
    t_new = (t_cw + rng.normal(0, 0.05, (K, 3))).astype(np.float32)
    s_new = rng.uniform(0.95, 1.05, K).astype(np.float32)
    ref = jlc._correct_map(staged.jm, jnp.asarray(s_new), jnp.asarray(R_new),
                           jnp.asarray(t_new))
    got = tlc._correct_map(staged.tm, _t(s_new), _t(R_new), _t(t_new))
    for name in ("kf_R", "kf_t", "mp_pos"):
        np.testing.assert_allclose(convert._np(getattr(got, name)),
                                   _np(getattr(ref, name)), atol=1e-5,
                                   rtol=0, err_msg=name)
    # it is functional: the input map is untouched
    np.testing.assert_array_equal(convert._np(staged.tm.kf_t),
                                  staged.m_np["kf_t"])


def _chain_b(c):
    return c.chain.map(lambda x: x[1:]) if hasattr(c.chain, "map") \
        else jax.tree.map(lambda x: x[1:], c.chain)


@pytest.mark.parametrize("inertial", [True, False])
def test_global_ba_step(staged, inertial):
    """One reduced whole-map iteration (stages=(1,), cg_iters=8), as the
    amortized post-loop GBA dispatches it: poses and points 1e-4, the
    bindings exact."""
    kw = dict(stages=(1,), cg_iters=8, obs_cap=1500)
    if inertial:
        jm2, jchi = jtrk.global_inertial_ba_step(
            staged.jm, _chain_b(staged.jc), staged.jc.chain_valid[1:],
            staged.jrig.kind, staged.jrig, **kw)
        tm2, tchi = ttrk.global_inertial_ba_step(
            staged.tm, _chain_b(staged.tc), staged.tc.chain_valid[1:],
            staged.trig.kind, staged.trig, **kw)
    else:
        jm2, jchi = jtrk.global_ba_step(staged.jm, staged.jrig.kind,
                                        staged.jrig, **kw)
        tm2, tchi = ttrk.global_ba_step(staged.tm, staged.trig.kind,
                                        staged.trig, **kw)
    assert np.isfinite(float(tchi))
    np.testing.assert_allclose(float(tchi), float(jchi), rtol=1e-3)
    for name in ("kf_R", "kf_t", "kf_v", "kf_bg", "kf_ba", "mp_pos"):
        np.testing.assert_allclose(convert._np(getattr(tm2, name)),
                                   _np(getattr(jm2, name)), atol=1e-4,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(convert._np(tm2.kf_obs), _np(jm2.kf_obs))
    # the drifted and the undrifted half disagree, so the solve moved
    assert np.abs(convert._np(tm2.kf_t) - staged.m_np["kf_t"]).max() > 1e-4


@pytest.mark.parametrize("finite", [True, False])
def test_writeback_gba(staged, finite):
    """The write-back alone, on a made-up solver result: exact, and a
    non-finite chi2 leaves the map as it was."""
    rng = np.random.default_rng(8)
    jobs, jobserved, jkf, jfeat = jtrk.full_map_observations(staged.jm, 1500)
    tobs, tobserved, tkf, tfeat = ttrk.full_map_observations(staged.tm, 1500)
    np.testing.assert_array_equal(convert._np(tobs.valid), _np(jobs.valid))
    st = dict(R=_np(staged.jm.kf_R)[:, ::-1].copy(),
              t=_np(staged.jm.kf_t) + 1.0, v=_np(staged.jm.kf_v) + 2.0,
              bg=np.full((K, 3), 0.1, np.float32),
              ba=np.full((K, 3), 0.2, np.float32),
              points=_np(staged.jm.mp_pos) + 3.0)
    inlier = rng.random(1500) < 0.7
    chi = np.float32(12.5 if finite else np.nan)
    from openmavis_tpu.optim import ba as jba
    from openmavis_tpu_torch.optim import ba as tba
    ref = jtrk._writeback_gba(
        staged.jm, jba.BAState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jnp.asarray(inlier), jnp.asarray(chi), jobserved, jkf, jfeat,
        jobs.valid, with_imu=True)
    got = ttrk._writeback_gba(
        staged.tm, tba.BAState(**{k: _t(v) for k, v in st.items()}),
        _t(inlier), _t(chi), tobserved, tkf, tfeat, tobs.valid,
        with_imu=True)
    for name in staged.tm._fields:
        np.testing.assert_array_equal(convert._np(getattr(got, name)),
                                      _np(getattr(ref, name)), err_msg=name)
    changed = not np.array_equal(convert._np(got.kf_obs),
                                 staged.m_np["kf_obs"])
    assert changed == finite


# ---------------------------------------------------------------------------
# the slice as a whole: the loop-closing step on the staged revisit
# ---------------------------------------------------------------------------

_LC_INTS = ("last_slot", "cand", "pend_slot", "count", "n_loops", "cooldown",
            "gba_left", "merged", "merge_last", "n_merges", "kf_off")


def _lc_ints(lcc, to_np):
    return {k: to_np(getattr(lcc, k)) for k in _LC_INTS}


def _arrive(m_np_like, to_arr, m):
    """Keyframe 12 arrives: valid, and counted."""
    kf_valid = np.array(m_np_like(m.kf_valid))
    kf_valid[12] = True
    return m._replace(kf_valid=to_arr(kf_valid),
                      n_kf=to_arr(np.asarray(13, np.int32)))


def _jax_samples(key, jm, slot, jrig):
    """The RANSAC samples JAX's step draws for keyframe `slot` against
    CAND when its carry holds `key`."""
    nn = jlc._pairs_from_tables(jlc._tables(jm), jlc._tables(jm), slot, CAND)
    pr = jlc.pairs_by_projection(jm, slot, CAND, jrig.kind, C, jrig, W, H)
    valid = jnp.concatenate([nn.valid, pr.valid])
    k1 = jax.random.split(key)[1]
    idx = jax.random.categorical(k1, jnp.where(valid, 0.0, -1e9)[None, None],
                                 shape=(128, 3))
    return _t(idx).to(torch.int64)


def _run_both(staged, jm, tm, lc_kw):
    """Both packages' step on keyframe 11, then (keyframe 12 arrived) on
    keyframe 12. The port gets the RANSAC samples JAX drew."""
    jstep = jslc.make_lc_step(staged.jcfg, staged.jrig.kind, C, True, W, H,
                              **lc_kw)
    tstep = tslc.make_lc_step(staged.tcfg, staged.trig.kind, C, True, W, H,
                              **lc_kw)
    out = dict(j=[], t=[], events=[])
    jc, jl = staged.jc, jslc.init_lc_carry()
    tc, tl = staged.tc, tslc.init_lc_carry(device="cpu")
    launches = matcher_cuda.launch_count()
    for call in range(2):
        if call == 1:
            jm = _arrive(np.asarray, jnp.asarray, jm)
            tm = _arrive(convert._np, _t, tm)
        idx = _jax_samples(jc.key, jm, SLOT + call, staged.jrig)
        jm, jc, jl = jstep(jm, jc, jl, staged.jrig)
        tm, tc, tl = tstep(tm, tc, tl, staged.trig, sample_idx=idx)
        out["j"].append((jm, jc, jl))
        out["t"].append((tm, tc, tl))
        out["events"].append(tstep.events)
    # CPU run: plain versions
    assert matcher_cuda.launch_count() == launches
    return out


@pytest.fixture(scope="module")
def lc_runs(staged):
    """temporal=1: the first call closes the loop, the second runs one
    amortized GBA step."""
    return _run_both(staged, staged.jm, staged.tm, LC_KW)


def second_revisit(m_np):
    """The staged map with keyframe 12 a second drifted revisit: bound to
    the duplicated landmarks, its pose carrying the drift."""
    m = {k: v.copy() for k, v in m_np.items()}
    D_R = _rot_z(DRIFT_YAW)
    m["kf_R"][12] = D_R @ m["kf_R"][12]
    m["kf_t"][12] = D_R @ m["kf_t"][12] + DRIFT_T
    m["kf_obs"][12] = np.where(m["kf_obs"][12] >= 0, m["kf_obs"][12] + 120,
                               -1)
    return {k: np.asarray(v, m_np[k].dtype) for k, v in m.items()}


@pytest.fixture(scope="module")
def lc_runs_pending(staged):
    """temporal=2, and keyframe 12 a second drifted revisit
    (`second_revisit`): the first call verifies keyframe 0 and leaves the
    hypothesis pending, the second recomposes it through keyframe 11's
    pose, confirms it and corrects."""
    m = second_revisit(staged.m_np)
    return _run_both(staged, _jmap(m), convert.map_from_numpy(m, device="cpu"),
                     dict(LC_KW, temporal=2))


def _hold_discrete(runs, call):
    """Every integer and bool of LCCarry exact, the map's bindings and
    loop edges exact, the telemetry exact."""
    jm, _, jl = runs["j"][call]
    tm, _, tl = runs["t"][call]
    a, b = _lc_ints(tl, convert._np), _lc_ints(jl, np.asarray)
    for k in _LC_INTS:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ("loop_i", "loop_j", "loop_valid", "n_loop", "kf_obs",
                 "kf_valid", "mp_valid", "n_kf"):
        np.testing.assert_array_equal(convert._np(getattr(tm, name)),
                                      _np(getattr(jm, name)), err_msg=name)
    np.testing.assert_array_equal(convert._np(tl.dbg)[2:5], _np(jl.dbg)[2:5])
    np.testing.assert_array_equal(convert._np(tl.dbg), _np(jl.dbg))
    return tm, tl, jl


def _hold_poses(runs, call):
    """Keyframe poses, landmarks, the re-expressed live pose and the
    pending Sim3 to 1e-3."""
    jm, jc, jl = runs["j"][call]
    tm, tc, tl = runs["t"][call]
    for name in ("kf_R", "kf_t", "kf_v", "mp_pos"):
        np.testing.assert_allclose(convert._np(getattr(tm, name)),
                                   _np(getattr(jm, name)), atol=1e-3, rtol=0,
                                   err_msg=name)
    for name in ("R", "p", "v"):
        np.testing.assert_allclose(convert._np(getattr(tc, name)),
                                   _np(getattr(jc, name)), atol=1e-3, rtol=0,
                                   err_msg=name)
    for name in ("s", "R", "t", "max_tilt"):
        np.testing.assert_allclose(convert._np(getattr(tl, name)),
                                   _np(getattr(jl, name)), atol=1e-3, rtol=0,
                                   err_msg=name)
    assert np.all(np.isfinite(convert._np(tm.mp_pos)))
    return tm, tc, tl


@pytest.mark.parametrize("call", [0, 1])
def test_lc_step_discrete_state(lc_runs, call):
    """Every integer and bool of LCCarry exact, the loop edges exact, the
    attempt/pairs/success telemetry exact."""
    tm, tl, jl = _hold_discrete(lc_runs, call)
    assert int(tl.n_loops) == 1 and int(jl.n_loops) == 1
    assert int(tl.gba_left) == (1 if call == 0 else 0)
    assert int(tl.cooldown) == (10 if call == 0 else 9)
    assert int(tl.last_slot) == (SLOT if call == 0 else 12)
    assert int(tm.loop_i[0]) == CAND and int(tm.loop_j[0]) == SLOT
    assert lc_runs["events"][call] == (("attempt", "correction") if call == 0
                                       else ("gba_step",))


@pytest.mark.parametrize("call", [0, 1])
def test_lc_step_poses(lc_runs, staged, call):
    """Keyframe poses, landmarks, the re-expressed live pose and the
    pending Sim3 to 1e-3; after the correction the drifted keyframes sit
    on their true poses again."""
    tm, tc, tl = _hold_poses(lc_runs, call)
    if call == 0:
        # keyframe 11 is back on keyframe 0's frame: the drift is undone
        t_fixed = (staged.m_np["kf_t"][SLOT] - DRIFT_T) @ _rot_z(DRIFT_YAW)
        assert np.abs(convert._np(tm.kf_t[SLOT]) - t_fixed).max() < 0.02
        assert np.abs(staged.m_np["kf_t"][SLOT] - t_fixed).max() > 0.04
        # the live pose followed its reference keyframe
        np.testing.assert_allclose(convert._np(tc.p),
                                   convert._np(tm.kf_t[SLOT]), atol=1e-5)
        assert float(tl.max_tilt) < 0.02


@pytest.mark.parametrize("call", [0, 1])
def test_lc_step_pending_discrete_state(lc_runs_pending, call):
    """temporal=2: the verified hypothesis waits one keyframe (cand 0,
    pend_slot 11, count 1), then the pending branch confirms it. All of
    LCCarry's integers, the loop edge and the telemetry exact."""
    tm, tl, jl = _hold_discrete(lc_runs_pending, call)
    want = dict(cand=CAND, pend_slot=SLOT, count=1, n_loops=0, cooldown=0,
                gba_left=0, last_slot=SLOT) if call == 0 else \
        dict(cand=-1, pend_slot=-1, count=0, n_loops=1, cooldown=10,
             gba_left=1, last_slot=12)
    for k, v in want.items():
        assert int(getattr(tl, k)) == int(getattr(jl, k)) == v, k
    assert int(tm.n_loop) == call
    if call == 1:
        assert int(tm.loop_i[0]) == CAND and int(tm.loop_j[0]) == 12
    # two attempts, both solves succeeded
    assert float(tl.dbg[2]) == call + 1 and float(tl.dbg[4]) == call + 1
    assert lc_runs_pending["events"][call] == (
        ("attempt",) if call == 0 else ("attempt", "correction"))


@pytest.mark.parametrize("call", [0, 1])
def test_lc_step_pending_poses(lc_runs_pending, staged, call):
    """temporal=2: the pending Sim3 (call 0: the fresh solve; call 1: the
    one recomposed through keyframe 11's pose), the keyframe poses, the
    landmarks and the live pose to 1e-3. The first call moves nothing;
    the second undoes the drift of keyframe 12."""
    tm, tc, tl = _hold_poses(lc_runs_pending, call)
    t11 = convert._np(tm.kf_t[SLOT])
    t_fixed = (staged.m_np["kf_t"][SLOT] - DRIFT_T) @ _rot_z(DRIFT_YAW)
    if call == 0:
        np.testing.assert_array_equal(t11, staged.m_np["kf_t"][SLOT])
        # the hypothesis maps keyframe 11's body onto keyframe 0's
        assert abs(float(tl.s) - 1.0) < 1e-6
    else:
        assert np.abs(t11 - t_fixed).max() < 0.02
    assert float(tl.max_tilt) < 0.02


def test_lc_step_below_floor_changes_nothing(staged):
    """A retrieval floor no candidate reaches: no attempt, the map and the
    carry as they were, in both packages."""
    kw = dict(LC_KW, score_min=100000)
    jstep = jslc.make_lc_step(staged.jcfg, staged.jrig.kind, C, True, W, H,
                              **kw)
    tstep = tslc.make_lc_step(staged.tcfg, staged.trig.kind, C, True, W, H,
                              **kw)
    jm, jc, jl = jstep(staged.jm, staged.jc, jslc.init_lc_carry(),
                       staged.jrig)
    tm, tc, tl = tstep(staged.tm, staged.tc,
                       tslc.init_lc_carry(device="cpu"), staged.trig)
    assert tstep.events == ()
    for name in staged.tm._fields:
        np.testing.assert_array_equal(convert._np(getattr(tm, name)),
                                      staged.m_np[name], err_msg=name)
        np.testing.assert_array_equal(_np(getattr(jm, name)),
                                      staged.m_np[name], err_msg=name)
    a, b = _lc_ints(tl, convert._np), _lc_ints(jl, np.asarray)
    for k in _LC_INTS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(tl.n_loops) == 0 and int(tl.last_slot) == SLOT
    np.testing.assert_array_equal(convert._np(tl.dbg), _np(jl.dbg))
    assert float(tl.dbg[0]) == 240.0 and float(tl.dbg[1]) == 100000.0
    np.testing.assert_array_equal(convert._np(tc.p), _np(jc.p))
    # a call with no new keyframe is a no-op too
    tm2, _, tl2 = tstep(tm, tc, tl, staged.trig)
    assert tstep.events == () and tm2 is tm and tl2 is tl


def test_lc_carry_round_trip(lc_runs):
    """LCCarry carried from JAX into the port and back: same values, the
    dtypes `init_lc_carry` allocates."""
    jl = lc_runs["j"][0][2]
    d = _as_dict(jl)
    tl = convert.lc_carry_from_numpy(d, device="cpu")
    for name, x, r in zip(tl._fields, tl, tslc.init_lc_carry(device="cpu")):
        assert x.dtype == r.dtype and x.shape == r.shape, name
    for name, v in convert.lc_carry_to_numpy(tl).items():
        np.testing.assert_array_equal(v, d[name], err_msg=name)
    with pytest.raises(KeyError):
        convert.lc_carry_from_numpy({"cand": d["cand"]}, device="cpu")


# ---------------------------------------------------------------------------
# the tracker's wiring
# ---------------------------------------------------------------------------

def _small_tracker(**kw):
    rig_np = scene.build_rig("kb8", 160, 120)
    cfg_kw = scene.bench_config_kwargs(8, max_kf=8, max_mp=1024)
    cfg_kw.update(img_w=160, img_h=120, obs_cap=2048)
    cfg = tsv.VIStreamConfig(orb=tex.OrbConfig(n_features=64, n_levels=2),
                             **cfg_kw)
    return rig_np, tsv.StreamingVITracker(
        convert.rig_from_numpy(rig_np, device="cpu"), cfg,
        tpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS, device="cpu"),
        seed=0, device="cpu", **kw)


@pytest.mark.parametrize("device_lc", [True, dict(score_min=30, temporal=2)])
def test_tracker_with_device_lc(device_lc):
    _, frames, _, _, batches = scene.make_sequence(3, orbit_frac=0.02,
                                                   w=160, h=120)
    _, tr = _small_tracker(device_lc=device_lc)
    assert tr._lc_step.temporal == 2
    assert tr._lc_step.score_min == (40 if device_lc is True else 30)
    for i in range(3):
        tr.push(frames[i], *batches[i])
    s = tr.snapshot()
    assert int(s["n_loops"]) == 0 and int(s["gba_left"]) == 0
    assert s["lc_dbg"].shape == (6,) and float(s["lc_max_tilt"]) == 0.0
    assert int(tr.lc_carry.last_slot) == int(s["n_kf"]) - 1
    # without loop closing the snapshot has no such fields
    _, plain = _small_tracker()
    assert "n_loops" not in plain.snapshot() and plain.lc_carry is None


@pytest.mark.parametrize("kw, item", [
    (dict(secondary_map=object()), "item 6"),
    (dict(merge_kw=dict()), "item 6"),
    (dict(loop_closer=object(), merge_kw=dict()), "item 6")])
def test_tracker_unported_options_raise(kw, item):
    """The cross-map weld's options (ROADMAP Queue 1 `item`, ported) are
    taken: a secondary map that is no MapState of the tracker's
    capacities is refused with ValueError; `merge_kw` without a secondary
    map is ignored, as the reference package does; with one it configures
    the merge step."""
    if "secondary_map" in kw:
        with pytest.raises(ValueError, match="capacities"):
            _small_tracker(device_lc=True, **kw)
        return
    _, tr = _small_tracker(device_lc=True, **kw)
    assert tr._merge_step is None and tr.map2 is None
    if "loop_closer" in kw:
        own = tms.allocate(*tr.map.kf_obs.shape, tr.map.mp_pos.shape[0],
                           device="cpu")
        _, tr = _small_tracker(device_lc=True, secondary_map=own, **kw)
        assert tr._merge_step.min_kf == 5 and tr.map2.n_kf.shape == ()


def test_tracker_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rig_np = scene.build_rig("kb8", 160, 120)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsv.StreamingVITracker(
            convert.rig_from_numpy(rig_np, device="cpu"),
            tsv.VIStreamConfig(orb=tex.OrbConfig(n_features=64, n_levels=2)),
            device_lc=dict(score_min=30, temporal=2))
