"""Parity of the port's optimizers with the JAX reference on the CPU:
pose_optimization, pose_inertial_optimization, the VI window
bundle_adjust, global_bundle_adjust and inertial_optimization.

Inputs are a numpy-seeded VI window on the flagship KannalaBrandt8 rig;
the preintegration chain is integrated by the JAX package and carried to
the port with convert.py. Both sides run the same fixed LM schedules.

Tolerances: float32 normal equations summed in another order; after the
solves the poses agree to 1e-4 (rad, m), biases and velocities to 1e-3,
landmarks to 1e-3 m and inlier masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.geometry import lie as jlie
from openmavis_tpu.imu import preintegration as jpre
from openmavis_tpu.optim import ba as jba
from openmavis_tpu.optim import global_ba as jgba
from openmavis_tpu.optim import inertial_init as jii
from openmavis_tpu.optim import pose_opt as jpo
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.optim import ba as tba
from openmavis_tpu_torch.optim import global_ba as tgba
from openmavis_tpu_torch.optim import inertial_init as tii
from openmavis_tpu_torch.optim import pose_opt as tpo

G = np.array([0.0, 0.0, -9.81])
W_BODY = np.array([0.05, 0.12, 0.2])
A_W = np.array([0.4, 0.1, 0.05])
V0 = np.array([1.0, 0.0, 0.2])
DT_KF = 0.25
N_S = 100                                  # 400 Hz


def _exp(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(np.asarray(w, np.float32))),
                      np.float64)


def _state(t):
    R = _exp(W_BODY * t)
    return R, V0 * t + 0.5 * A_W * t * t, V0 + A_W * t


@pytest.fixture(scope="module")
def window():
    """K keyframes of an accelerating, turning body; M landmarks seen by
    the two front cameras; the JAX-integrated chain between keyframes."""
    K, M = 5, 160
    rng = np.random.default_rng(0)
    rig_np = scene.build_rig("kb8")
    noise = jpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS)
    Rs, ps, vs, pres = [], [], [], []
    h = DT_KF / N_S
    for k in range(K):
        R, p, v = _state(k * DT_KF)
        Rs.append(R), ps.append(p), vs.append(v)
        if k < K - 1:
            ts = k * DT_KF + (np.arange(N_S) + 0.5) * h
            acc = np.stack([_state(t)[0].T @ (A_W - G) for t in ts])
            pres.append(jpre.integrate(
                jnp.asarray(np.tile(W_BODY, (N_S, 1)), jnp.float32),
                jnp.asarray(acc, jnp.float32),
                jnp.full((N_S,), h, jnp.float32), jnp.zeros(6), noise))
    chain = jax.tree.map(lambda *x: jnp.stack(x), *pres)
    Rs, ps, vs = (np.asarray(x, np.float32) for x in (Rs, ps, vs))
    pts = rng.uniform([-3, -2, 4], [5, 2, 12], (M, 3)).astype(np.float32)

    kf = np.repeat(np.arange(K), M).astype(np.int32)
    mp = np.tile(np.arange(M), K).astype(np.int32)
    cam = rng.integers(0, 2, K * M).astype(np.int32)
    p_b = np.einsum("oji,oj->oi", Rs[kf], pts[mp] - ps[kf])
    p_c = np.einsum("oij,oj->oi", rig_np["R_cb"][cam], p_b) \
        + rig_np["t_cb"][cam]
    from openmavis_tpu_torch.geometry import cameras as tcam
    uv = tcam.project(tcam.KB8, torch.as_tensor(rig_np["params"][cam]),
                      torch.as_tensor(p_c)).numpy()
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[::23] += 40.0                                     # outliers
    valid = (p_c[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < 640) \
        & (uv[:, 1] > 0) & (uv[:, 1] < 480)
    obs = dict(kf=kf, mp=mp, cam=cam, uv=uv,
               sigma2=np.ones(K * M, np.float32), valid=valid)
    return dict(K=K, M=M, rig=rig_np, R=Rs, p=ps, v=vs, pts=pts, obs=obs,
                chain=chain, rng=rng)


def _rigs(w):
    r = w["rig"]
    return (JRig(r["kind"], *(jnp.asarray(r[k]) for k in
                              ("params", "R_cb", "t_cb"))),
            convert.rig_from_numpy(r, device="cpu"))


def _chain_t(w):
    return convert.pre_from_numpy(
        {k: np.asarray(v) for k, v in w["chain"]._asdict().items()},
        device="cpu")


def close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


def _frame_obs(w, k):
    o = w["obs"]
    sel = o["kf"] == k
    return (w["pts"][o["mp"][sel]], o["cam"][sel], o["uv"][sel],
            o["sigma2"][sel], o["valid"][sel])


def test_pose_optimization(window):
    w = window
    jr, tr = _rigs(w)
    p_w, cam, uv, s2, valid = _frame_obs(w, 2)
    R0 = (w["R"][2] @ _exp([0.02, -0.015, 0.01])).astype(np.float32)
    t0 = (w["p"][2] + [0.08, -0.05, 0.04]).astype(np.float32)
    args = (R0, t0, p_w, cam, uv, s2, valid)
    Rj, tj, inl_j, n_j = jpo.pose_optimization(
        *map(jnp.asarray, args), jr, rounds=2, iters_per_round=6)
    Rt, tt, inl_t, n_t = tpo.pose_optimization(
        *map(torch.as_tensor, args), tr, rounds=2, iters_per_round=6)
    close(Rt, Rj, 1e-4)
    close(tt, tj, 1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) and int(n_t) > 100
    assert np.abs(tt.numpy() - w["p"][2]).max() < 0.02


def test_pose_inertial_optimization(window):
    w = window
    jr, tr = _rigs(w)
    p_w, cam, uv, s2, valid = _frame_obs(w, 1)
    z3 = np.zeros(3, np.float32)
    anchor = (w["R"][0], w["p"][0], w["v"][0], z3, z3)
    pred = ((w["R"][1] @ _exp([0.01, 0.0, -0.01])).astype(np.float32),
            (w["p"][1] + 0.05).astype(np.float32),
            (w["v"][1] - 0.1).astype(np.float32), z3, z3)
    pre_j = jax.tree.map(lambda x: x[0], w["chain"])
    pre_t = _chain_t(w).map(lambda x: x[0])
    sj, inl_j, n_j = jpo.pose_inertial_optimization(
        jpo.InertialState(*map(jnp.asarray, pred)),
        jpo.InertialState(*map(jnp.asarray, anchor)), pre_j,
        *map(jnp.asarray, (p_w, cam, uv, s2, valid)), jr, rounds=2,
        iters_per_round=6)
    st, inl_t, n_t = tpo.pose_inertial_optimization(
        tpo.InertialState(*map(torch.as_tensor, pred)),
        tpo.InertialState(*map(torch.as_tensor, anchor)), pre_t,
        *map(torch.as_tensor, (p_w, cam, uv, s2, valid)), tr, rounds=2,
        iters_per_round=6)
    for name, a, b, tol in zip(("R", "p", "v", "bg", "ba"), st, sj,
                               (1e-4, 1e-4, 1e-3, 1e-4, 1e-3)):
        close(a, b, tol)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j)


def _ba_inputs(w):
    K, M = w["K"], w["M"]
    rng = np.random.default_rng(1)
    R0 = np.stack([w["R"][k] @ _exp(rng.normal(0, 0.01, 3))
                   for k in range(K)]).astype(np.float32)
    t0 = (w["p"] + rng.normal(0, 0.03, (K, 3))).astype(np.float32)
    v0 = (w["v"] + rng.normal(0, 0.05, (K, 3))).astype(np.float32)
    R0[0], t0[0], v0[0] = w["R"][0], w["p"][0], w["v"][0]
    z = np.zeros((K, 3), np.float32)
    pts = (w["pts"] + rng.normal(0, 0.05, (M, 3))).astype(np.float32)
    state = (R0, t0, v0, z, z, pts)
    fixed = np.arange(K) == 0
    return state, fixed


def _ba_compare(out_t, out_j):
    st, inl_t, chi_t = out_t
    sj, inl_j, chi_j = out_j
    for name, a, b, tol in zip(tba.BAState._fields, st, sj,
                               (1e-4, 1e-4, 1e-3, 1e-4, 1e-3, 1e-3)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=tol, err_msg=name)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(float(chi_t), float(chi_j), rtol=1e-3)


@pytest.mark.parametrize("solver", ["window", "global"])
def test_vi_bundle_adjust(window, solver):
    w = window
    jr, tr = _rigs(w)
    state, fixed = _ba_inputs(w)
    E = w["K"] - 1
    obs = w["obs"]
    j_edges = jba.InertialEdges(pre=w["chain"], valid=jnp.ones(E, bool))
    t_edges = tba.InertialEdges(pre=_chain_t(w),
                                valid=torch.ones(E, dtype=torch.bool))
    j_obs = jba.BAObservations(**{k: jnp.asarray(v) for k, v in obs.items()})
    t_obs = tba.BAObservations(**{k: torch.as_tensor(v)
                                  for k, v in obs.items()})
    j_state = jba.BAState(*map(jnp.asarray, state))
    t_state = tba.BAState(*map(torch.as_tensor, state))
    if solver == "window":
        out_j = jba.bundle_adjust(j_state, j_obs, jr, jnp.asarray(fixed),
                                  edges=j_edges, stages=(3, 4),
                                  rows_per_kf=w["M"])
        out_t = tba.bundle_adjust(t_state, t_obs, tr,
                                  torch.as_tensor(fixed), edges=t_edges,
                                  stages=(3, 4), rows_per_kf=w["M"])
    else:
        out_j = jgba.global_bundle_adjust(
            j_state, j_obs, jr, jnp.asarray(fixed), edges=j_edges,
            stages=(3, 4), cg_iters=12)
        out_t = tgba.global_bundle_adjust(
            t_state, t_obs, tr, torch.as_tensor(fixed), edges=t_edges,
            stages=(3, 4), cg_iters=12)
    _ba_compare(out_t, out_j)
    assert np.abs(out_t[0].t.numpy() - w["p"]).max() < 0.05


def test_inertial_optimization(window):
    w = window
    K = w["K"]
    s_gt = 0.5
    tilt = _exp([0.1, -0.08, 0.0]).astype(np.float32)
    R_vis = np.einsum("ji,kjl->kil", tilt, w["R"]).astype(np.float32)
    p_vis = ((1.0 / s_gt) * w["p"] @ tilt).astype(np.float32)
    args = (R_vis, p_vis, np.zeros((K, 3), np.float32))
    ev = np.ones(K - 1, bool)
    rj = jii.inertial_optimization(*map(jnp.asarray, args), w["chain"],
                                   jnp.asarray(ev))
    rt = tii.inertial_optimization(*map(torch.as_tensor, args),
                                   _chain_t(w), torch.as_tensor(ev))
    close(rt.scale, rj.scale, 1e-4, rtol=1e-4)
    close(rt.R_wg, rj.R_wg, 1e-4)
    close(rt.bg, rj.bg, 1e-4)
    close(rt.ba, rj.ba, 1e-3)
    close(rt.v, rj.v, 1e-3)
    assert abs(float(rt.scale) - s_gt) < 0.05
    # warm starts and the map re-expression
    v0j, Rg_j = jii.initial_gravity_velocity(
        *map(jnp.asarray, args[:2]), w["chain"], jnp.asarray(ev))
    v0t, Rg_t = tii.initial_gravity_velocity(
        *map(torch.as_tensor, args[:2]), _chain_t(w), torch.as_tensor(ev))
    close(v0t, v0j, 1e-5)
    close(Rg_t, Rg_j, 1e-5)
    out_j = jii.apply_scaled_rotation(
        *map(jnp.asarray, (R_vis, p_vis, w["v"], w["pts"])), rj.R_wg.T,
        rj.scale)
    out_t = tii.apply_scaled_rotation(
        *map(torch.as_tensor, (R_vis, p_vis, w["v"], w["pts"])),
        torch.as_tensor(np.asarray(rj.R_wg)).T,
        torch.as_tensor(np.asarray(rj.scale)))
    for a, b in zip(out_t, out_j):
        close(a, b, 1e-4, rtol=1e-5)


def test_stereo_and_inertial_residuals(window):
    """The residual functions the solvers above do not call: the 3-dof
    rectified-stereo residual (pinhole rigs) and the inertial residual.
    Pixel residuals and Jacobians (entries up to ~1e3) at 2e-3 absolute
    plus 1e-5 relative; the 9-dim inertial residual at 1e-5 + 1e-4 rel."""
    from openmavis_tpu.optim import inertial as jin
    from openmavis_tpu.optim import reprojection as jrep
    from openmavis_tpu_torch.optim import inertial as tin
    from openmavis_tpu_torch.optim import reprojection as trep
    w = window
    pin = scene.build_rig("pinhole")
    jr = JRig(pin["kind"], *(jnp.asarray(pin[k])
                             for k in ("params", "R_cb", "t_cb")))
    tr = convert.rig_from_numpy(pin, device="cpu")
    p_w, cam, uv, _, _ = _frame_obs(w, 1)
    uvr = np.concatenate([uv, uv[:, :1] - 10.0], 1).astype(np.float32)
    n = len(cam)
    args = (np.tile(w["R"][1], (n, 1, 1)), np.tile(w["p"][1], (n, 1)), p_w,
            cam, uvr)
    out_j = jrep.stereo_residual_jac(*map(jnp.asarray, args), 76.0, jr)
    out_t = trep.stereo_residual_jac(*map(torch.as_tensor, args), 76.0, tr)
    for a, b in zip(out_t, out_j):
        close(a, b, 2e-3, rtol=1e-5)
    z3 = np.full(3, 0.01, np.float32)
    st = (w["R"][0], w["p"][0], w["v"][0], z3, z3, w["R"][1], w["p"][1],
          w["v"][1])
    rj = jin.inertial_residual(*map(jnp.asarray, st),
                               jax.tree.map(lambda x: x[0], w["chain"]))
    rt = tin.inertial_residual(*map(torch.as_tensor, st),
                               _chain_t(w).map(lambda x: x[0]))
    close(rt, rj, 1e-5, rtol=1e-4)


def test_bundle_adjust_rejects_unsorted_rows(window):
    """`rows_per_kf` declares the table as K contiguous keyframe blocks;
    the reshape-sum would silently credit rows to the wrong keyframe if it
    were not, so a CPU table that breaks the layout raises."""
    w = window
    _, tr = _rigs(w)
    state, fixed = _ba_inputs(w)
    obs = dict(w["obs"])
    # every keyframe keeps its row count, but the rows are interleaved
    order = np.argsort(np.tile(np.arange(w["M"]), w["K"]), kind="stable")
    obs = {k: v[order] for k, v in obs.items()}
    assert np.bincount(obs["kf"]).tolist() == [w["M"]] * w["K"]
    t_obs = tba.BAObservations(**{k: torch.as_tensor(v)
                                  for k, v in obs.items()})
    with pytest.raises(ValueError, match="rows_per_kf"):
        tba.bundle_adjust(tba.BAState(*map(torch.as_tensor, state)), t_obs,
                          tr, torch.as_tensor(fixed), stages=(1, 1),
                          rows_per_kf=w["M"])
