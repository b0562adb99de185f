"""Parity of the port's geometry (lie, cameras, triangulation) and IMU
preintegration with the JAX reference on the CPU, on numpy inputs made
from a seed.

Tolerances: float32 transcendental functions differ between XLA's and
torch's CPU implementations by a few ulps, so values are compared at
rtol 1e-5 with a small atol for quantities near zero; pixel outputs of
the camera models at 1e-3 px (2e-6 relative at 500 px); triangulated
depths at 2e-3 relative (see test_triangulation); chained preintegration
over 400 Hz samples at 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.geometry import cameras as jcam
from openmavis_tpu.geometry import lie as jlie
from openmavis_tpu.geometry import triangulation as jtri
from openmavis_tpu.imu import preintegration as jpre
from openmavis_tpu_torch import convert
from openmavis_tpu_torch.geometry import cameras as tcam
from openmavis_tpu_torch.geometry import lie as tlie
from openmavis_tpu_torch.geometry import triangulation as ttri
from openmavis_tpu_torch.imu import preintegration as tpre

KB8 = np.array([352.0, 352.0, 320.0, 240.0, -0.0398, 0.0083, -0.0062,
                0.0010], np.float32)
PIN = np.array([380.0, 380.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread per test
    worker keeps the files of the suite from oversubscribing the machine
    when they run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t) else t,
                               np.asarray(j), rtol=rtol, atol=atol)


def _tangents(seed, n=64):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    w[:8] *= 1e-4                       # Taylor branches
    w[8:12] *= 3.1 / np.linalg.norm(w[8:12], axis=-1, keepdims=True)
    return w


@pytest.mark.parametrize("name", [
    "so3_exp", "so3_left_jacobian", "so3_right_jacobian",
    "so3_left_jacobian_inv", "so3_right_jacobian_inv", "so3_gamma2",
    "so3_hat"])
def test_so3_functions(name):
    w = _tangents(0)
    close(getattr(tlie, name)(torch.as_tensor(w)),
          getattr(jlie, name)(jnp.asarray(w)), atol=2e-6)


def test_so3_log_normalize_se3_sim3_quat():
    w = _tangents(1)
    R = np.array(jlie.so3_exp(jnp.asarray(w)))
    close(tlie.so3_log(torch.as_tensor(R)), jlie.so3_log(jnp.asarray(R)),
          atol=2e-5)
    Rn = R + 1e-3 * np.random.default_rng(2).normal(size=R.shape).astype(
        np.float32)
    close(tlie.normalize_rotation(torch.as_tensor(Rn)),
          jlie.normalize_rotation(jnp.asarray(Rn)), atol=1e-6)
    xi = np.random.default_rng(3).normal(0, 0.5, (16, 6)).astype(np.float32)
    for a, b in zip(tlie.se3_exp(torch.as_tensor(xi)),
                    jlie.se3_exp(jnp.asarray(xi))):
        close(a, b, atol=2e-6)
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    close(tlie.se3_log(torch.as_tensor(np.array(Rj)),
                       torch.as_tensor(np.array(tj))),
          jlie.se3_log(Rj, tj), atol=2e-5)
    x7 = np.random.default_rng(4).normal(0, 0.3, (16, 7)).astype(np.float32)
    x7[:4, 6] = 1e-5
    for a, b in zip(tlie.sim3_exp(torch.as_tensor(x7)),
                    jlie.sim3_exp(jnp.asarray(x7))):
        close(a, b, atol=2e-6)
    sj, Rj, tj = jlie.sim3_exp(jnp.asarray(x7))
    close(tlie.sim3_log(*(torch.as_tensor(np.array(v)) for v in
                          (sj, Rj, tj))), jlie.sim3_log(sj, Rj, tj),
          rtol=1e-4, atol=2e-5)
    q = np.asarray(jlie.rotmat_to_quat(jnp.asarray(R)))
    close(tlie.rotmat_to_quat(torch.as_tensor(R)), q, atol=2e-6)
    close(tlie.quat_to_rotmat(torch.as_tensor(q)),
          jlie.quat_to_rotmat(jnp.asarray(q)), atol=2e-6)


def _points(seed, n=200):
    rng = np.random.default_rng(seed)
    p = rng.uniform([-4, -3, 0.3], [4, 3, 12], (n, 3)).astype(np.float32)
    p[0] = [0.0, 0.0, 5.0]              # on the optical axis
    return p


@pytest.mark.parametrize("kind,params", [(jcam.PINHOLE, PIN),
                                         (jcam.KB8, KB8)])
def test_camera_models(kind, params):
    p = _points(5)
    pt, pj = torch.as_tensor(params), jnp.asarray(params)
    uv_t = tcam.project(kind, pt, torch.as_tensor(p))
    uv_j = jcam.project(kind, pj, jnp.asarray(p))
    close(uv_t, uv_j, rtol=0, atol=1e-3)
    close(tcam.project_jac(kind, pt, torch.as_tensor(p)),
          jcam.project_jac(kind, pj, jnp.asarray(p)), rtol=1e-4, atol=1e-3)
    uv = np.asarray(uv_j)
    close(tcam.unproject(kind, pt, torch.as_tensor(uv)),
          jcam.unproject(kind, pj, jnp.asarray(uv)), atol=2e-6)


def test_triangulation():
    rng = np.random.default_rng(6)
    F = 128
    X = rng.uniform([-3, -2, 2], [3, 2, 15], (F, 3)).astype(np.float32)
    R12 = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.05, 0.01])))
    t12 = np.array([-0.2, 0.01, 0.0], np.float32)
    p_c2 = (X - t12) @ R12                              # R12^T (X - t12)
    uv1 = np.asarray(jcam.project(jcam.KB8, jnp.asarray(KB8),
                                  jnp.asarray(X)))
    uv2 = np.asarray(jcam.project(jcam.KB8, jnp.asarray(KB8),
                                  jnp.asarray(p_c2)))
    uv2 = uv2 + rng.normal(0, 0.3, uv2.shape).astype(np.float32)
    sig = np.ones(F, np.float32)
    args = (np.broadcast_to(KB8, (F, 8)), np.broadcast_to(KB8, (F, 8)),
            np.broadcast_to(R12, (F, 3, 3)), np.broadcast_to(t12, (F, 3)),
            uv1, uv2, sig, sig)
    out_j = jtri.triangulate_matches(jcam.KB8, *map(jnp.asarray, args))
    out_t = ttri.triangulate_matches(
        tcam.KB8, *(torch.as_tensor(np.ascontiguousarray(a)) for a in args))
    # midpoint depth amplifies bearing differences (2e-6, the Newton
    # unprojection in float32) by depth / baseline (up to 75 here)
    close(out_t[0], out_j[0], rtol=2e-3, atol=1e-3)
    close(out_t[1], out_j[1], rtol=2e-3, atol=1e-3)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    assert int(out_t[2].sum()) > F // 2
    # DLT: the eigenvector's sign is free, compare after the divide
    P1 = np.broadcast_to(np.eye(3, 4, dtype=np.float32), (F, 3, 4))
    P2 = np.broadcast_to(np.concatenate([R12.T, (-R12.T @ t12)[:, None]],
                                        1), (F, 3, 4))
    x1 = X[:, :2] / X[:, 2:]
    x2 = p_c2[:, :2] / p_c2[:, 2:]
    dj = jtri.triangulate_dlt(*map(jnp.asarray, (P1, P2, x1, x2)))
    dt = ttri.triangulate_dlt(*(torch.as_tensor(np.ascontiguousarray(a))
                                for a in (P1, P2, x1, x2)))
    close(dt, dj, rtol=1e-3, atol=1e-3)


def _imu(seed, S=20):
    """400 Hz samples of one 20 fps frame interval."""
    rng = np.random.default_rng(seed)
    w = (np.array([0.1, -0.3, 0.2]) + rng.normal(0, 0.05, (S, 3))).astype(
        np.float32)
    a = (np.array([0.3, 0.1, 9.81]) + rng.normal(0, 0.2, (S, 3))).astype(
        np.float32)
    dt = np.full(S, 1.0 / 400.0, np.float32)
    dt[-3:] = 0.0                          # padded samples: exact no-ops
    return w, a, dt


def _pre_close(t, j, rtol=1e-5, atol=1e-7):
    for name, a, b in zip(tpre.Preintegrated._fields, t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=name)


def test_preintegration_integrate_compose_rebias_predict():
    noise_j = jpre.ImuNoise.from_sigmas(1.71e-4, 8.6e-3, 3.1e-6, 2.2e-4,
                                        400.0)
    noise_t = convert.noise_from_numpy(
        {k: np.asarray(v) for k, v in noise_j._asdict().items()},
        device="cpu")
    bias = np.array([0.01, -0.02, 0.005, 0.05, -0.03, 0.02], np.float32)
    pres = []
    for seed in (7, 8):
        w, a, dt = _imu(seed)
        pj = jpre.integrate(*map(jnp.asarray, (w, a, dt, bias)), noise_j)
        pt = tpre.integrate(*map(torch.as_tensor, (w, a, dt, bias)),
                            noise_t)
        _pre_close(pt, pj, atol=1e-6)
        pres.append((pt, pj))
    (a_t, a_j), (b_t, b_j) = pres
    _pre_close(tpre.compose(a_t, b_t), jpre.compose(a_j, b_j), atol=1e-6)
    nb = bias + np.float32(0.01)
    _pre_close(tpre.rebias(a_t, torch.as_tensor(nb)),
               jpre.rebias(a_j, jnp.asarray(nb)), atol=1e-6)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray([0.1, 0.2, -0.3])))
    p0 = np.array([1.0, 2.0, 0.5], np.float32)
    v0 = np.array([0.5, -0.2, 0.1], np.float32)
    for x, y in zip(tpre.predict_state(*map(torch.as_tensor, (R0, p0, v0)),
                                       a_t, torch.as_tensor(nb)),
                    jpre.predict_state(*map(jnp.asarray, (R0, p0, v0)),
                                       a_j, jnp.asarray(nb))):
        close(x, y, atol=1e-6)
    # chain storage round trip through convert (dtype preserved)
    ch = tpre.chain_set(tpre.chain_allocate(4, device="cpu"), 2, a_t)
    back = convert.pre_from_numpy(convert.pre_to_numpy(ch), device="cpu")
    _pre_close(tpre.chain_get(back, 2), a_j, atol=1e-6)
    assert all(x.dtype == torch.float32 for x in back)
    chj = jpre.chain_set(jpre.chain_allocate(4), 2, a_j)
    _pre_close(ch, chj, atol=1e-6)


def _pre_within(t, j, atol):
    """Every field but C within `atol`; C, of size 1e-6, within 1e-5 of
    its largest entry."""
    for name, a, b in zip(tpre.Preintegrated._fields, t, j):
        b = np.asarray(b)
        tol = 1e-5 * np.abs(b).max() if name == "C" else atol
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=tol,
                                   err_msg=name)


def test_integrate_batch():
    """`integrate_batch` at tests/test_preintegration.py's batched inputs
    (8 intervals of 30 samples at 200 Hz, 0.5 rad/s gyro noise, seed 4),
    with a bias per interval and padding here: every field of every
    interval within 4e-6 of the reference's vmap (the port's `integrate`
    of one interval parts from the reference's by as much: 2.3e-6 on a dV
    of 1.5 and 2.9e-6 on an avgA of 9.5, float32 sums in another order),
    and within 3e-7 of the port's `integrate` of that interval alone
    (batched products round otherwise: 1.2e-7 on dV)."""
    rng = np.random.default_rng(4)
    B = 8
    w = (0.5 * rng.normal(size=(B, 30, 3))).astype(np.float32)
    a = (1.0 * rng.normal(size=(B, 30, 3))
         + np.array([0, 0, 9.81])).astype(np.float32)
    dt = np.full((B, 30), 0.005, np.float32)
    dt[2, -4:] = 0.0                       # padded samples: exact no-ops
    bias = (0.01 * rng.normal(size=(B, 6))).astype(np.float32)
    noise_j = jpre.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    noise_t = convert.noise_from_numpy(
        {k: np.asarray(v) for k, v in noise_j._asdict().items()},
        device="cpu")
    pj = jpre.integrate_batch(*map(jnp.asarray, (w, a, dt, bias)), noise_j)
    pt = tpre.integrate_batch(*map(torch.as_tensor, (w, a, dt, bias)),
                              noise_t)
    assert pt.dR.shape == (B, 3, 3) and pt.C.shape == (B, 15, 15)
    for i in range(B):
        _pre_within((x[i] for x in pt), (x[i] for x in pj), 4e-6)
    for i in range(B):
        one = tpre.integrate(*(torch.as_tensor(x[i]) for x in
                               (w, a, dt, bias)), noise_t)
        _pre_within((x[i] for x in pt), one, 3e-7)


def test_se3_sim3_group_ops():
    """inverse / compose / apply / matrix of SE3 and Sim3 (float32)."""
    rng = np.random.default_rng(11)
    R = np.asarray(jlie.so3_exp(jnp.asarray(_tangents(12, 16))))
    t = rng.normal(0, 2.0, (16, 3)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    p = rng.normal(0, 5.0, (16, 3)).astype(np.float32)
    Rb, tb, sb = R[::-1].copy(), t[::-1].copy(), s[::-1].copy()
    T, J = torch.as_tensor, jnp.asarray
    pairs = [
        (tlie.se3_inverse(T(R), T(t)), jlie.se3_inverse(J(R), J(t))),
        (tlie.se3_compose(T(R), T(t), T(Rb), T(tb)),
         jlie.se3_compose(J(R), J(t), J(Rb), J(tb))),
        ((tlie.se3_apply(T(R), T(t), T(p)),),
         (jlie.se3_apply(J(R), J(t), J(p)),)),
        ((tlie.se3_matrix(T(R), T(t)),), (jlie.se3_matrix(J(R), J(t)),)),
        (tlie.sim3_inverse(T(s), T(R), T(t)),
         jlie.sim3_inverse(J(s), J(R), J(t))),
        (tlie.sim3_compose(T(s), T(R), T(t), T(sb), T(Rb), T(tb)),
         jlie.sim3_compose(J(s), J(R), J(t), J(sb), J(Rb), J(tb))),
        ((tlie.sim3_apply(T(s), T(R), T(t), T(p)),),
         (jlie.sim3_apply(J(s), J(R), J(t), J(p)),)),
    ]
    for got, ref in pairs:
        for a, b in zip(got, ref):
            close(a, b, rtol=1e-5, atol=1e-5)


def test_convert_rig_noise_pre_round_trip():
    """convert.py carries RigParams, ImuNoise and Preintegrated across as
    float32 and back unchanged."""
    from openmavis_tpu_torch import scene
    rig_np = scene.build_rig("kb8")
    rig = convert.rig_from_numpy(rig_np, device="cpu")
    assert rig.params.dtype == torch.float32
    for k, v in convert.rig_to_numpy(rig).items():
        np.testing.assert_array_equal(v, rig_np[k], err_msg=k)
    nj = jpre.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3, 400.0)
    dn = {k: np.asarray(v) for k, v in nj._asdict().items()}
    for k, v in convert.noise_to_numpy(
            convert.noise_from_numpy(dn, device="cpu")).items():
        np.testing.assert_array_equal(v, dn[k], err_msg=k)
    nt = tpre.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3, 400.0,
                                  device="cpu")
    close(nt.nga, nj.nga, rtol=0, atol=0)
    pj = jpre.init_preintegrated(jnp.arange(6, dtype=jnp.float32))
    dp = {k: np.asarray(v) for k, v in pj._asdict().items()}
    for k, v in convert.pre_to_numpy(
            convert.pre_from_numpy(dp, device="cpu")).items():
        np.testing.assert_array_equal(v, dp[k], err_msg=k)
