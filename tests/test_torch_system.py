"""The port's `System` facade against the JAX reference's on the CPU.

What the facade adds is what it hands its trackers, so that is what is
held, without compiling a tracker step:
* construction, for all eight `Sensor`s from the same settings: the
  tracker's class and every config field, the rig (rectified for a
  rectifying STEREO pair), `dist`, the IMU noise, the loop closer's
  configuration and the Atlas, and the `ValueError` of an unknown sensor;
* three frames of every `track_*` with the trackers' `feed_imu` and
  `process_frame` replaced by recorders in both packages: the images
  (remapped for the rectified pair), timestamps, depth and the IMU
  samples, in order;
* one port-only MONOCULAR run at tests/test_system.py's configuration
  with that test's assertions, the viewer included;
* `reset` on the same device, `run_global_ba(mesh=)` beyond the world
  refused, and the current CUDA device as the default.

Tolerances: configurations, rigs, images and IMU samples exact (the same
numpy on both sides); the remapped pair 1e-4 on 0-255 images; the IMU
noise 1e-6 relative.
"""

import dataclasses
import json
import socket
import time
import urllib.request

import numpy as np
import pytest
import torch

from openmavis_tpu.pipeline import system as jsystem
from openmavis_tpu_torch import scene
from openmavis_tpu_torch.geometry import cameras
from openmavis_tpu_torch.io import synthetic, trajectory
from openmavis_tpu_torch.pipeline import system as tsystem

S = tsystem.Sensor
W, H = 96, 64
OVERRIDES = {"max_kf": 8, "max_mp": 256}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mono_settings():
    """One EuRoC-like radtan pinhole with an IMU node (MONOCULAR, RGBD and
    their inertial forms)."""
    pin = np.zeros(8, np.float32)
    pin[:4] = np.asarray(scene.EUROC_PINHOLE) * W / scene.EUROC_W
    rig = dict(kind=scene.PINHOLE, params=pin[None],
               R_cb=np.eye(3, dtype=np.float32)[None],
               t_cb=np.zeros((1, 3), np.float32))
    d = scene.system_settings(rig, 64, 2, scene.EUROC_NOISE_SIGMAS, w=W,
                              h=H)
    for k, v in zip(("k1", "k2", "p1", "p2"), scene.EUROC_RADTAN):
        d[f"Camera1.{k}"] = v
    return d


def _settings(sensor):
    if sensor in (S.MULTI, S.IMU_MULTI):
        return scene.system_settings(scene.build_rig("kb8", W, H), 64, 2,
                                     w=W, h=H)
    if sensor in (S.STEREO, S.IMU_STEREO):
        return scene.stereo_pair_settings(True, 64, 2, w=W, h=H,
                                          scale=W / scene.EUROC_W)
    return _mono_settings()


def _pair(sensor):
    kw = dict(tracker_overrides=dict(OVERRIDES), seed=3)
    j = jsystem.System(_settings(sensor), jsystem.Sensor[sensor.name], **kw)
    t = tsystem.System(_settings(sensor), sensor, device="cpu", **kw)
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rig_equal(a, b):
    assert a.kind == b.kind
    for f in ("params", "R_cb", "t_cb"):
        np.testing.assert_allclose(_np(getattr(b, f)), _np(getattr(a, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
        assert getattr(b, f).device.type == "cpu"


@pytest.mark.parametrize("sensor", list(S), ids=lambda s: s.name)
def test_sensor_builds_the_reference_tracker(sensor):
    j, t = _pair(sensor)
    jt, tt = j.tracker, t.tracker
    assert type(tt).__name__ == type(jt).__name__
    assert type(t.cfg).__name__ == type(j.cfg).__name__
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)
    _rig_equal(jt.rig, tt.rig)
    assert (tt.dist is None) == (jt.dist is None)
    if jt.dist is not None:
        np.testing.assert_array_equal(_np(tt.dist), _np(jt.dist))
    if hasattr(jt, "noise"):
        for f in ("nga", "nga_walk"):
            np.testing.assert_allclose(_np(getattr(tt.noise, f)),
                                       _np(getattr(jt.noise, f)), rtol=1e-6)
    assert (t._rect_maps is None) == (j._rect_maps is None)
    if j._rect_maps is not None:
        np.testing.assert_array_equal(_np(t._rect_maps), _np(j._rect_maps))
    jl, tl = j.loop_closer, t.loop_closer
    assert dataclasses.asdict(tl.cfg) == dataclasses.asdict(jl.cfg)
    for k in ("max_kf", "inertial", "img_w", "img_h"):
        assert getattr(tl, k) == getattr(jl, k), k
    assert tl.vocab is None and jl.vocab is None
    _rig_equal(jl.rig, tl.rig)
    assert tt.loop_closer is tl and tt.atlas is not None
    assert len(tt.atlas.maps) == len(jt.atlas.maps) == 1
    for a, b in zip(jt.atlas.maps[0], tt.atlas.maps[0]):
        assert tuple(b.shape) == tuple(np.shape(a))
        assert b.device.type == "cpu"
    assert tt.state == jt.state and tt.device == torch.device("cpu")
    t.shutdown()
    j.shutdown()


def test_unknown_sensor_and_no_loop_closer():
    for make in (lambda: jsystem.System(_mono_settings(), "LIDAR"),
                 lambda: tsystem.System(_mono_settings(), "LIDAR",
                                        device="cpu")):
        with pytest.raises(ValueError, match="unsupported sensor"):
            make()
    t = tsystem.System(_mono_settings(), S.MONOCULAR, device="cpu",
                       enable_loop_closing=False)
    assert t.loop_closer is None and t.tracker.loop_closer is None


# ---------------------------------------------------------------------------
# what the facade hands its tracker, frame by frame
# ---------------------------------------------------------------------------

def _record(slam):
    """Replace the tracker's `feed_imu` and `process_frame` by recorders
    writing one event list (in call order)."""
    log = []

    def feed_imu(w, a, t):
        log.append(("imu", np.asarray(w).tolist(), np.asarray(a).tolist(),
                    float(t)))

    def process_frame(images, time, depth=None):
        if isinstance(images, torch.Tensor):
            assert images.device.type == "cpu"
        log.append(("frame", _np(images), float(time),
                    None if depth is None else _np(depth)))
        return True

    slam.tracker.feed_imu = feed_imu
    slam.tracker.process_frame = process_frame
    return log


def _frames(sensor, i):
    rng = np.random.default_rng(100 + i)
    n = {S.MULTI: 4, S.IMU_MULTI: 4, S.STEREO: 2, S.IMU_STEREO: 2}.get(
        sensor, 1)
    imgs = rng.integers(0, 256, (n, H, W), np.uint8)
    depth = rng.uniform(0, 8, (n, H, W)).astype(np.float32)
    imu = [(rng.normal(size=3).astype(np.float32),
            rng.normal(size=3).astype(np.float32), i * 0.05 + k * 0.01)
           for k in range(3 + i)]
    return imgs, depth, imu


def _drive(slam, sensor):
    for i in range(3):
        imgs, depth, imu = _frames(sensor, i)
        inertial = sensor.name.startswith("IMU_")
        samples = imu if inertial else None
        t = 0.05 * i
        if sensor in (S.MONOCULAR, S.IMU_MONOCULAR):
            assert slam.track_monocular(imgs[0], t, samples)
        elif sensor in (S.RGBD, S.IMU_RGBD):
            assert slam.track_rgbd(imgs[0], depth[0], t, samples)
        elif sensor in (S.STEREO, S.IMU_STEREO):
            assert slam.track_stereo(imgs[0], imgs[1], t, samples)
        else:
            assert slam.track_multi(imgs, t, samples,
                                    depth=depth if i == 2 else None)


@pytest.mark.parametrize("sensor", list(S), ids=lambda s: s.name)
def test_track_hands_the_same_frames(sensor):
    j, t = _pair(sensor)
    logs = []
    for slam in (j, t):
        log = _record(slam)
        _drive(slam, sensor)
        logs.append(log)
    lj, lt = logs
    assert [e[0] for e in lt] == [e[0] for e in lj]
    assert sum(e[0] == "frame" for e in lt) == 3
    if sensor.name.startswith("IMU_"):
        assert sum(e[0] == "imu" for e in lt) == 3 + 4 + 5
    else:
        assert all(e[0] == "frame" for e in lt)
    rectified = sensor in (S.STEREO, S.IMU_STEREO)
    for a, b in zip(lj, lt):
        if a[0] == "imu":
            assert a == b
            continue
        assert a[2] == b[2]
        assert b[1].shape == a[1].shape and b[1].dtype == a[1].dtype
        if rectified:
            assert b[1].dtype == np.float32
            np.testing.assert_allclose(b[1], a[1], rtol=0, atol=1e-4)
        else:
            assert b[1].dtype == np.uint8
            np.testing.assert_array_equal(b[1], a[1])
        assert (a[3] is None) == (b[3] is None)
        if a[3] is not None:
            np.testing.assert_array_equal(b[3], a[3])
    assert t.timer.stats()["track"]["count"] == 3


# ---------------------------------------------------------------------------
# the port alone: tests/test_system.py's run
# ---------------------------------------------------------------------------

MW, MH = 384, 288


def _system_test_config():
    cfg = {"Camera": {"type": "PinHole", "width": MW, "height": MH,
                      "fps": 30.0},
           "ORBextractor": {"nFeatures": 384, "nLevels": 4},
           "IMU": {"NoiseGyro": 1.7e-4, "NoiseAcc": 2e-3,
                   "GyroWalk": 1.9e-5, "AccWalk": 3e-3, "Frequency": 200.0},
           "Camera1": {"fx": 300.0, "fy": 300.0, "cx": MW / 2, "cy": MH / 2,
                       "T_b_c": np.eye(4).tolist()}}
    return cfg


def test_system_mono_end_to_end(tmp_path):
    slam = tsystem.System(_system_test_config(), S.MONOCULAR,
                          enable_loop_closing=False,
                          tracker_overrides={"max_kf": 16, "max_mp": 4096},
                          use_viewer=True, device="cpu")
    world = synthetic.BlobWorld.create(seed=5, n=2500)
    params = np.array([300.0, 300.0, MW / 2, MH / 2, 0, 0, 0, 0],
                      np.float32)
    R_wc, t_wc = synthetic.orbit_trajectory(20, radius=6.0, frac=0.12)
    frames = synthetic.render_sequence(world, cameras.PINHOLE, params,
                                       R_wc, t_wc, MW, MH)
    for i, img in enumerate(frames):
        slam.track_monocular(img, i / 20.0)
    assert slam.tracking_state() == slam.tracker.OK

    traj_path = str(tmp_path / "traj_tum.txt")
    slam.save_trajectory_tum(traj_path)
    times, pos, _ = trajectory.load_tum(traj_path)
    assert len(times) == len(frames)

    kf_path = str(tmp_path / "kf_tum.txt")
    slam.save_keyframe_trajectory_tum(kf_path)
    times_kf, _, _ = trajectory.load_tum(kf_path)
    assert len(times_kf) == slam.tracker.n_kf

    atlas_path = str(tmp_path / "atlas.npz")
    slam.save_atlas(atlas_path)
    n_mp = int(slam.map.n_mp)
    slam.load_atlas(atlas_path)
    assert int(slam.map.n_mp) == n_mp
    assert slam.map.mp_pos.device.type == "cpu"

    stats = slam.timer.stats()
    assert "track" in stats and stats["track"]["count"] == len(frames)

    # the live viewer renders nothing while no client is attached; an
    # attached stream client makes the next track publish one snapshot
    v = slam.viewer
    assert v is not None and v.n_renders == 0
    host, port = v._srv.server_address[:2]
    sock = socket.create_connection((host, port), timeout=5)
    sock.sendall(b"GET /map HTTP/1.1\r\nHost: x\r\n\r\n")
    for _ in range(100):
        if v.attached:
            break
        time.sleep(0.05)
    assert v.attached
    slam.track_monocular(frames[-1], len(frames) / 20.0)
    assert v.n_renders == 1
    st = json.loads(urllib.request.urlopen(
        v.url + "state.json", timeout=5).read())
    assert st["n_keyframes"] == slam.tracker.n_kf
    sock.close()
    slam.shutdown()
    assert slam.viewer is None


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sensor", [S.MONOCULAR, S.IMU_MULTI, S.STEREO],
                         ids=lambda s: s.name)
def test_reset_keeps_the_device(sensor):
    slam = tsystem.System(_settings(sensor), sensor, device="cpu",
                          tracker_overrides=dict(OVERRIDES))
    tr = slam.tracker
    dist = None if tr.dist is None else tr.dist.clone()
    slam.activate_localization_mode()
    assert tr.localization_only
    slam.reset()
    assert slam.tracker is tr and not tr.localization_only
    assert tr.device == torch.device("cpu")
    assert tr.map.kf_R.device.type == "cpu" and len(tr.atlas.maps) == 1
    assert tr.state == tr.NOT_INITIALIZED and tr.loop_closer is not None
    assert (tr.dist is None) == (dist is None)
    if dist is not None:
        assert torch.equal(tr.dist, dist)
    slam.reset_active_map()
    assert len(tr.atlas.maps) == 2 and tr.map_id == 1
    slam.deactivate_lc()
    assert tr.loop_closer is None
    slam.activate_lc()
    assert tr.loop_closer is slam.loop_closer


def test_run_global_ba_mesh_not_ported():
    """`run_global_ba(mesh=)` asks for more ranks than a world that was
    never initialized has: ValueError, and no mesh-less solve in its
    place (tests/test_torch_parallel.py holds the sharded solve)."""
    slam = tsystem.System(_mono_settings(), S.MONOCULAR, device="cpu",
                          tracker_overrides=dict(OVERRIDES))
    m = slam.tracker.map
    for mesh in (2, [0, 1], [1]):
        with pytest.raises(ValueError, match="world of size 1"):
            slam.run_global_ba(mesh=mesh)
    assert slam.tracker.map is m


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsystem.System(_mono_settings(), S.MONOCULAR)


# ---------------------------------------------------------------------------
# a uint8 frame (the reference's documented input is float32,
# openmavis_tpu/pipeline/multi_tracking.py:850-852; the port casts on its
# device)
# ---------------------------------------------------------------------------

U8_W, U8_H = 256, 192


def _u8_frames(n=2):
    rig_np = scene.build_rig("kb8", U8_W, U8_H)
    R_wb, t_wb = synthetic.orbit_trajectory(4, radius=6.0, frac=0.02)
    imgs = scene.render_rig_sequence(rig_np, R_wb[:n], t_wb[:n], U8_W, U8_H)
    return rig_np, np.clip(imgs, 0, 255).astype(np.uint8)


def _recorded_ext(tracker):
    feats = []
    ext = tracker._ext

    def rec(images):
        f = ext(images)
        feats.append(f)
        return f

    tracker._ext = rec
    return feats


def _assert_same_state(a, b):
    fa, fb = a.features, b.features
    assert len(fa) == len(fb) > 0
    for x, y in zip(fa, fb):
        for name in x._fields:
            assert torch.equal(getattr(x, name), getattr(y, name)), name
    for name in a.tracker.map._fields:
        assert torch.equal(getattr(a.tracker.map, name),
                           getattr(b.tracker.map, name)), name
    for x, y in zip(a.tracker.get_trajectory(), b.tracker.get_trajectory()):
        np.testing.assert_array_equal(x, y)
    assert a.tracker.state == b.tracker.state


class _Run:
    def __init__(self, tracker):
        self.tracker = tracker
        self.features = _recorded_ext(tracker)


@pytest.mark.parametrize("entry", ["system_track_multi",
                                   "multi_tracker_process_frame"])
def test_uint8_frames_equal_float32(entry):
    """The same frames as uint8 and as float32 give the same features and
    the same state after the first frame (the stereo rig init) and the
    second (the first tracked frame)."""
    from openmavis_tpu_torch.pipeline import multi_tracking as tmt
    rig_np, frames = _u8_frames()
    settings = scene.system_settings(rig_np, 192, 3, w=U8_W, h=U8_H)
    runs = []
    for dtype in (np.uint8, np.float32):
        if entry == "system_track_multi":
            slam = tsystem.System(settings, S.MULTI, seed=3,
                                  tracker_overrides=dict(OVERRIDES,
                                                         max_mp=2048),
                                  device="cpu")
            run = _Run(slam.tracker)
            for i, img in enumerate(frames):
                slam.track_multi(img.astype(dtype), i / scene.FPS_IN)
        else:
            from openmavis_tpu_torch.io import settings as tset
            s = tset.load_settings(settings, device="cpu")
            cfg = tmt.MultiTrackerConfig(
                img_w=U8_W, img_h=U8_H, n_cams=4, orb=s["orb"],
                max_kf=8, max_mp=2048, use_imu=False)
            tr = tmt.MultiTracker(s["rig"], cfg, seed=3, device="cpu")
            run = _Run(tr)
            for i, img in enumerate(frames):
                arr = img.astype(dtype)
                tr.process_frame(torch.as_tensor(arr) if i else arr,
                                 i / scene.FPS_IN)
        runs.append(run)
    assert frames.dtype == np.uint8
    assert int(runs[0].features[0].valid.sum()) > 100
    assert int(runs[0].tracker.map.n_mp) > 50
    _assert_same_state(*runs)
