"""Depth priors of the port (`frontend/depth.py`,
`triangulation.stereo_depth_from_point`) against the JAX reference on the
CPU.

* `sample_depth` on a rendered BlobWorld depth map (holes between the
  blobs, 0 where nothing is hit) and on a tilted plane with holes that
  reaches beyond the 40 m range, at keypoints inside, on and outside the
  border: validity exact, depths 1e-5 relative.
* `sample_depth_undistorted` for a fisheye (KB8) camera whose depth map
  lives in a virtual pinhole; `backproject` (pinhole and KB8) and
  `depth_to_uright`: 1e-5.
* `spawn_from_depth` and `spawn_from_depth_multi` (two pinhole cameras in
  the raw frame; two KB8 cameras with `pin_params`) on a map with one
  keyframe, some of its features already bound, a cap below the number of
  candidates, and a landmark slab nearly full: every integer of the map
  exact (validity, bindings, first and last keyframe, counts), landmark
  positions 1e-5 relative, the spawned count exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import depth as jdepth
from openmavis_tpu.geometry import triangulation as jtri
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu.slam_map import map_state as jms
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.frontend import depth as tdepth
from openmavis_tpu_torch.geometry import triangulation as ttri
from openmavis_tpu_torch.io import synthetic


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are tiny: one intra-op thread is as fast as
    eight, and eight per test worker oversubscribe the machine when the
    files of the suite run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 160, 120
PIN = np.array([96.0, 96.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
KB8 = np.array([88.0, 88.0, W / 2, H / 2, -0.0398, 0.0083, -0.0062,
                0.0010], np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def depth_maps():
    """[2, H, W] z-depth: the BlobWorld seen from the orbit (mostly holes
    between the blobs), and a tilted plane from 2 to 45 m (beyond the
    40 m range in one corner) with square holes."""
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    R, t = synthetic.orbit_trajectory(2, radius=6.0, frac=0.05)
    blobs = synthetic.render_depth_sequence(world, scene.PINHOLE, PIN,
                                            R[:1], t[:1], W, H)[0]
    assert 0.3 < (blobs == 0).mean() < 0.95, (blobs == 0).mean()
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    plane = 2.0 + 43.0 * (u / W) ** 2 * (v / H)
    rng = np.random.default_rng(9)
    for x0, y0 in rng.integers(0, [W - 8, H - 8], (25, 2)):
        plane[y0:y0 + 8, x0:x0 + 8] = 0.0
    return np.stack([blobs, plane]).astype(np.float32)


def _keypoints(seed, n):
    """Pixels over the image and a band beyond its border."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform([-3.0, -3.0], [W + 2.0, H + 2.0], (n, 2))
    xy[:4] = [[0.0, 0.0], [W - 2.0, H - 2.0], [W - 1.0, 5.0],
              [W - 1.5, H - 1.5]]
    return xy.astype(np.float32)


def test_sample_depth(depth_maps):
    xy = _keypoints(0, 400)
    for d in depth_maps:
        dj, vj = jdepth.sample_depth(jnp.asarray(d), jnp.asarray(xy))
        dt, vt = tdepth.sample_depth(_t(d), _t(xy))
        np.testing.assert_array_equal(_np(vt), _np(vj))
        v = _np(vj)
        np.testing.assert_allclose(_np(dt)[v], _np(dj)[v], rtol=1e-5)
        assert 20 < v.sum() < len(xy) - 50
        # x0 + 1 and y0 + 1 must lie inside the map
        assert not v[3]


def test_sample_depth_undistorted_backproject_uright(depth_maps):
    xy = _keypoints(1, 300)
    pin = PIN[:4]
    dj, vj = jdepth.sample_depth_undistorted(
        jnp.asarray(depth_maps[1]), jnp.asarray(xy), scene.KB8,
        jnp.asarray(KB8), jnp.asarray(pin))
    dt, vt = tdepth.sample_depth_undistorted(_t(depth_maps[1]), _t(xy),
                                             scene.KB8, _t(KB8), _t(pin))
    np.testing.assert_array_equal(_np(vt), _np(vj))
    v = _np(vj)
    assert v.sum() > 50
    np.testing.assert_allclose(_np(dt)[v], _np(dj)[v], rtol=1e-5)
    d = np.where(v, _np(dj), 5.0).astype(np.float32)
    for kind, params in ((scene.PINHOLE, PIN), (scene.KB8, KB8)):
        pj = jdepth.backproject(kind, jnp.asarray(params), jnp.asarray(xy),
                                jnp.asarray(d))
        pt = tdepth.backproject(kind, _t(params), _t(xy), _t(d))
        np.testing.assert_allclose(_np(pt), _np(pj), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(pt)[:, 2], d, rtol=1e-5)
        np.testing.assert_allclose(
            _np(ttri.stereo_depth_from_point(pt)),
            _np(jtri.stereo_depth_from_point(pj)), rtol=1e-5)
    np.testing.assert_allclose(
        _np(tdepth.depth_to_uright(_t(xy), _t(d), 38.4)),
        _np(jdepth.depth_to_uright(jnp.asarray(xy), jnp.asarray(d), 38.4)),
        rtol=1e-6, atol=1e-5)


K, F, M = 4, 240, 200     # F = 2 cameras x 120 features


def _rig(kind, params):
    R_cb = np.stack([np.eye(3, dtype=np.float32),
                     np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]],
                              np.float32)])
    t_cb = np.array([[0.1, 0.0, 0.0], [0.0, 0.05, -0.1]], np.float32)
    rig = dict(kind=kind, params=np.stack([params] * 2), R_cb=R_cb,
               t_cb=t_cb)
    return (JRig(kind, *(jnp.asarray(rig[k]) for k in
                         ("params", "R_cb", "t_cb"))),
            convert.rig_from_numpy(rig, device="cpu"))


def _map_with_keyframe(seed, n_mp_before):
    """A slab with `n_mp_before` landmarks and keyframe 1 inserted: 240
    features in two camera bands, a fifth already bound."""
    rng = np.random.default_rng(seed)
    m = jms.allocate(K, F, M)
    m = m._replace(
        mp_valid=jnp.arange(M) < n_mp_before,
        mp_pos=jnp.asarray(rng.normal(size=(M, 3)).astype(np.float32)),
        n_mp=jnp.asarray(n_mp_before, jnp.int32))
    xy = np.concatenate([_keypoints(seed, F // 2),
                         _keypoints(seed + 1, F // 2)])
    obs = np.where(rng.random(F) < 0.2, rng.integers(0, n_mp_before, F),
                   -1).astype(np.int32)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    R *= np.sign(np.linalg.det(R))
    m = jms.insert_keyframe(
        m, 1, jnp.asarray(R), jnp.asarray([0.5, -0.2, 1.0]), jnp.zeros(3),
        jnp.zeros(3), jnp.zeros(3), 0.25, jnp.asarray(xy),
        jnp.asarray((rng.random((F, 256)) > 0.5).astype(np.int8)),
        jnp.asarray(rng.integers(0, 3, F).astype(np.int32)),
        jnp.ones(F), jnp.repeat(jnp.arange(2, dtype=jnp.int32), F // 2),
        jnp.asarray(rng.random(F) > 0.1), jnp.asarray(obs))
    return m


def _assert_maps_equal(tm, jm, what):
    for name in jm._fields:
        g, r = _np(getattr(tm, name)), np.asarray(getattr(jm, name))
        assert g.dtype == r.dtype, (what, name, g.dtype, r.dtype)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{what}.{name}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"{what}.{name}")


# (landmarks before, cap): room for all, a cap that binds, a slab that
# fills up before the cap
CAPS = [(20, 256), (20, 30), (180, 256)]


@pytest.mark.parametrize("n_before,cap", CAPS)
def test_spawn_from_depth_multi(depth_maps, n_before, cap):
    for kind, params, pin in ((scene.PINHOLE, PIN, None),
                              (scene.KB8, KB8, np.stack([PIN[:4]] * 2))):
        jrig, trig = _rig(kind, params)
        jm = _map_with_keyframe(3, n_before)
        tm = convert.map_from_numpy(
            {k: np.asarray(v) for k, v in jm._asdict().items()},
            device="cpu")
        jm2, jn = jdepth.spawn_from_depth_multi(
            jm, 1, kind, 2, jrig, jnp.asarray(depth_maps), pin_params=pin,
            cap_new=cap, max_spawn_depth=25.0)
        tm2, tn = tdepth.spawn_from_depth_multi(
            tm, 1, kind, 2, trig, _t(depth_maps), pin_params=pin,
            cap_new=cap, max_spawn_depth=25.0)
        assert tn.dtype == torch.int32 and int(tn) == int(jn) > 0
        # the cap and the slab's end bind where they are the smaller
        room = min(cap, M - n_before)
        assert int(jn) == room if room <= 30 else int(jn) < room
        _assert_maps_equal(tm2, jm2, f"kind {kind}, cap {cap}")


def test_spawn_from_depth_single_camera(depth_maps):
    jrig, trig = _rig(scene.PINHOLE, PIN)
    jm = _map_with_keyframe(5, 40)
    tm = convert.map_from_numpy(
        {k: np.asarray(v) for k, v in jm._asdict().items()}, device="cpu")
    xy = np.asarray(jm.kf_xy[1])
    dj, vj = jdepth.sample_depth(jnp.asarray(depth_maps[1]),
                                 jnp.asarray(xy))
    for max_d in (25.0, 8.0):
        jm2, jn = jdepth.spawn_from_depth(
            jm, 1, scene.PINHOLE, jrig.params[0], jrig.R_cb[0],
            jrig.t_cb[0], dj, vj, cap_new=64, max_spawn_depth=max_d)
        tm2, tn = tdepth.spawn_from_depth(
            tm, 1, scene.PINHOLE, trig.params[0], trig.R_cb[0],
            trig.t_cb[0], _t(dj), _t(vj), cap_new=64, max_spawn_depth=max_d)
        assert int(tn) == int(jn) > 0
        _assert_maps_equal(tm2, jm2, f"max depth {max_d}")
