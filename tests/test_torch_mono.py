"""The single-camera inertial configurations of the streaming tracker,
port against the JAX reference on the CPU: one compile of the reference's
step for each.

* IMU_MONOCULAR with radtan (`dist`): one camera (the EuRoC cam0 of
  ORB-SLAM3's Monocular-Inertial/EuRoC.yaml at half its size, 376 x 240 —
  not a multiple of the 32-pixel FAST cell — with its distortion; the
  images rendered distorted), 256 features x 3 levels, 200 Hz IMU. Every
  frame of the port is stepped from the reference's state of the frame
  before (`convert`), fed the reference's raw features (descriptor bits on
  pyramid levels >= 1 differ by float32 ties, ROADMAP Queue 3) and
  undistorting them itself, and handed the reference's two-view samples
  (`jax.random.categorical` from the carry's key and the matches' mask).
  The run passes NEED_REF (frame 0), INIT (a frame whose two-view attempt
  fails, so the reference slides to it, then one that initializes), OK
  with a keyframe on every frame after, and the first, non-metric IMU
  init (`fix_scale=False`, prior_a 1e10). Integers exact (mode, counts,
  validity, bindings, the chain's validity, the reference's time), poses
  1e-3 and landmarks 1e-3 relative (the two-keyframe BA and the inertial
  init are float32 solves summed in another order); the IMU init's scale
  within 1e-3 of the reference's. The frame that initializes is the exception:
  its two-view solve, at 63 matches and 0.3 m of baseline 7 m out, is
  ill-conditioned in float32 (the reference's unnormalized 8-point and
  its A^T A): fed the same correspondences and samples, the two packages'
  rotations lie 7e-4 apart and each 4-5e-3 from the float64 solve, and one
  point of 50 passes the checks in one package only (ROADMAP Queue 3).
  There the discrete state is exact, the landmark count within 2 and the
  poses within 5e-3; the next frame starts from the reference's state
  again.
* IMU_RGBD (`use_depth`): an undistorted pinhole (the RGB-D camera of
  `scene` at half size) with BlobWorld depth maps; rig init from depth on
  frame 0, then tracking frames and keyframes that spawn from depth before
  anything else: stepped the same way, integers exact, poses 1e-3; `push`
  without a depth stack raises ValueError, as in the reference. This run
  has no window BA: early in a one-camera map both fixed members of the
  reference's BA window are slot 0, the scale is free, and from one state
  the two packages' keyframes land 2.3 cm apart (ROADMAP Queue 3; the mono
  run keeps the BA and holds it at 1e-3). Frame 1 is
  the exception: its prediction is keyframe 0's own pose (no velocity
  yet), and with the camera at the body's origin each landmark then lies
  exactly at the distance its scale range was set from, where
  log(dmax / dist) / log(1.2) is an integer; the two packages' float32
  `log` round it to either side, so `ceil` predicts the level or the next
  for 35 of 192 landmarks, the level gate admits other features, and 86
  against 92 landmarks match (ROADMAP Queue 3). There the discrete state
  is exact but for the landmark count (within 3%) and the pose within
  1e-2; the next frame starts from the reference's state again.
* The carry round-trips through `convert` in INIT mode (the reference
  bank and its time included) and `dist` reaches the tracker's device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.frontend import matcher as jmatcher
from openmavis_tpu.imu import preintegration as jpre
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu.pipeline import streaming_vi as jsv
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.imu import preintegration as tpre
from openmavis_tpu_torch.pipeline import multi_tracking as tmt
from openmavis_tpu_torch.pipeline import streaming_vi as tsv
from openmavis_tpu_torch.pipeline import tracking as ttrk
from openmavis_tpu_torch.pipeline.streaming import INIT, NEED_REF, OK


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are tiny: one intra-op thread is as fast as
    eight, and eight per test worker oversubscribe the machine when the
    files of the suite run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ORB = dict(n_features=256, n_levels=3)
N_HYP = 256
INTS = ("mode", "n_kf", "n_mp", "kf_valid", "kf_obs", "mp_valid",
        "last_kf_slot", "chain_valid", "viba_stage", "imu_ok", "ref_time",
        "ref_valid")
FLOATS = ("kf_R", "kf_t", "R", "p", "mp_pos")


def _state(jt):
    """The reference tracker's map and carry as numpy dicts."""
    m = {k: np.asarray(v) for k, v in jt.map._asdict().items()}
    c = {k: (v._asdict() if hasattr(v, "_asdict") else v)
         for k, v in jt.carry._asdict().items()}
    c = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
             if isinstance(v, dict) else np.asarray(v))
         for k, v in c.items()}
    return m, c


def _record(m, c, to_np):
    rec = {k: to_np(getattr(m, k)) for k in
           ("n_kf", "n_mp", "kf_valid", "kf_obs", "mp_valid", "kf_R",
            "kf_t", "mp_pos")}
    rec.update({k: to_np(getattr(c, k)) for k in
                ("mode", "last_kf_slot", "chain_valid", "viba_stage",
                 "imu_ok", "ref_time", "R", "p")})
    rec["ref_valid"] = to_np(c.ref_bank["valid"])
    return rec


def _run(cfg_kw, rig_np, frames, batches, depths=None, dist=None):
    """Both trackers over the frames; the port's every step taken from the
    reference's state of the frame before, with the reference's features
    and two-view samples. Returns dict(jax, port, samples_used, trackers)."""
    cfg_j = jex.OrbConfig(**ORB)
    jt = jsv.StreamingVITracker(
        JRig(rig_np["kind"], *(jnp.asarray(rig_np[k])
                               for k in ("params", "R_cb", "t_cb"))),
        jsv.VIStreamConfig(orb=cfg_j, **cfg_kw),
        jpre.ImuNoise.from_sigmas(*scene.EUROC_NOISE_SIGMAS), seed=0,
        dist=dist)
    tt = tsv.StreamingVITracker(
        convert.rig_from_numpy(rig_np, device="cpu"),
        tsv.VIStreamConfig(orb=tex.OrbConfig(**ORB), **cfg_kw),
        tpre.ImuNoise.from_sigmas(*scene.EUROC_NOISE_SIGMAS, device="cpu"),
        seed=0, device="cpu", dist=dist)
    j_extract = jax.jit(lambda im: jex.extract_multicam(im, cfg_j))
    step = tt._step

    def shared_bank(images):
        """The reference's raw features; the port undistorts them."""
        fj = j_extract(jnp.asarray(images.numpy()))
        feats = tex.Features(*(torch.as_tensor(np.array(x)) for x in fj))
        feats = tex.undistort_features(feats, step.rig.params, step.dist)
        return tmt.concat_bands(feats)

    step.extract_bank = shared_bank
    F = ORB["n_features"]
    out = dict(jax=[], port=[], attempts=[], states=[])
    for i in range(len(frames)):
        t, b = batches[i]
        m_np, c_np = _state(jt)
        out["states"].append((m_np, c_np))
        sample_idx = None
        if int(c_np["mode"]) == INIT:
            # the draws of the reference's mono_do_init on this frame
            fj = j_extract(jnp.asarray(frames[i].astype(np.float32)))
            idx, _ = jmatcher.match_nn(
                fj.desc[0], fj.valid[0], c_np["ref_bank"]["desc"][:F],
                c_np["ref_bank"]["valid"][:F], max_dist=jmatcher.TH_LOW,
                ratio=0.9, mutual=True)
            matched = np.asarray(idx) >= 0
            if matched.sum() >= cfg_kw["init_min_matches"]:
                sub = jax.random.split(jnp.asarray(c_np["key"]))[1]
                key_e, key_h = jax.random.split(sub)
                logits = jnp.where(jnp.asarray(matched), 0.0, -1e9)
                sample_idx = tuple(
                    torch.as_tensor(np.asarray(jax.random.categorical(
                        k, logits[None, None, :], shape=(N_HYP, n))))
                    for k, n in ((key_e, 8), (key_h, 4)))
                out["attempts"].append(i)
        tt.map = convert.map_from_numpy(m_np, device="cpu")
        tt.carry = convert.carry_from_numpy(c_np, device="cpu")
        tt._t_prev = batches[i - 1][0] if i else None
        dep = None if depths is None else depths[i]
        tt.push(frames[i], t, b, depth=dep, sample_idx=sample_idx)
        jt.push(frames[i], t, b, depth=dep)
        out["port"].append(_record(tt.map, tt.carry, convert._np))
        out["jax"].append(_record(jt.map, jt.carry, np.asarray))
    out["trackers"] = (jt, tt)
    return out


W, H = scene.EUROC_W // 2, scene.EUROC_H // 2
N_MONO = 6


@pytest.fixture(scope="module")
def mono():
    pin = np.array(scene.EUROC_PINHOLE, np.float32) / 2
    rig_np, frames, _, _, batches, _ = scene.make_single_camera_sequence(
        N_MONO, 1.25 * (N_MONO - 1) / 159, W, H, pin,
        dist=scene.EUROC_RADTAN)
    kw = scene.single_camera_config_kwargs(N_MONO, W, H, max_kf=12,
                                           max_mp=2048)
    # a keyframe every other frame; the IMU init after four keyframes;
    # 256 features match ~60 times between frames, so the two-view gates
    # are scaled down from the reference's 80 / 50 for 1,000+ features
    kw.update(imu_init_kfs=4, kf_max_interval_s=0.04, obs_cap=4096,
              init_min_matches=50, init_min_inliers=40)
    dist = np.array(scene.EUROC_RADTAN, np.float32)[None]
    return _run(kw, rig_np, frames, batches, dist=dist)


def test_mono_passes_every_mode(mono):
    """NEED_REF -> INIT, a failed attempt that slides the reference, the
    init, then OK with keyframes and the first IMU init."""
    modes = [int(r["mode"]) for r in mono["jax"]]
    assert modes[0] == INIT and modes[-1] == OK, modes
    first_ok = modes.index(OK)
    assert mono["attempts"] and mono["attempts"][-1] == first_ok
    failed = [i for i in mono["attempts"] if i < first_ok]
    assert failed, mono["attempts"]
    # a failed attempt slides the reference to its frame
    assert float(mono["jax"][failed[0]]["ref_time"]) == pytest.approx(
        failed[0] * 0.05)
    n_kf = [int(r["n_kf"]) for r in mono["jax"]]
    assert n_kf[first_ok] == 2 and n_kf[-1] > 2
    assert int(mono["jax"][-1]["viba_stage"]) >= 1
    states = mono["states"]
    assert int(states[0][1]["mode"]) == NEED_REF


def _init_frame(run):
    return [int(r["mode"]) for r in run["jax"]].index(OK)


# what the frame held within bounds may move (see the module docstring):
# the landmark list (one point more or less shifts every later slot)
LANDMARK_KEYS = ("n_mp", "kf_obs", "mp_valid", "mp_pos")


def _integers_equal(run, key, bounded):
    for i, (a, b) in enumerate(zip(run["port"], run["jax"])):
        assert a[key].dtype == b[key].dtype, (key, a[key].dtype)
        if i == bounded and key in LANDMARK_KEYS:
            continue
        np.testing.assert_array_equal(a[key], b[key],
                                      err_msg=f"frame {i}: {key}")


def _floats_close(run, key, bounded):
    # landmarks to 1e-3 relative: a temporal point 15 m out moves by a few
    # mm between the packages (z^2 / (b f) is metres per pixel there)
    rtol = 1e-3 if key == "mp_pos" else 0.0
    for i, (a, b) in enumerate(zip(run["port"], run["jax"])):
        if i != bounded:
            np.testing.assert_allclose(a[key], b[key], atol=1e-3, rtol=rtol,
                                       err_msg=f"frame {i}: {key}")


def _bounded_frame(run, i, n_mp_rel, pose_atol):
    a, b = run["port"][i], run["jax"][i]
    assert abs(int(a["n_mp"]) - int(b["n_mp"])) <= n_mp_rel * int(b["n_mp"])
    for key in ("kf_R", "kf_t", "R", "p"):
        np.testing.assert_allclose(a[key], b[key], atol=pose_atol, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("key", INTS)
def test_mono_integers_equal(mono, key):
    _integers_equal(mono, key, _init_frame(mono))


@pytest.mark.parametrize("key", FLOATS)
def test_mono_floats_close(mono, key):
    _floats_close(mono, key, _init_frame(mono))


def test_mono_init_frame(mono):
    """The frame that initializes (see the module docstring): within two
    landmarks of 50, poses 5e-3."""
    i = _init_frame(mono)
    assert int(mono["jax"][i]["n_mp"]) >= 40
    _bounded_frame(mono, i, 0.04, 5e-3)


def test_mono_init_scale_and_imu_init(mono):
    """The two-view init sets the median depth of its points to 1 (seen
    from keyframe 0); the non-metric IMU init then rescales the map, by
    the same factor in both packages."""
    modes = [int(r["mode"]) for r in mono["jax"]]
    i0 = modes.index(OK)
    for rec in (mono["port"][i0], mono["jax"][i0]):
        pts = rec["mp_pos"][rec["mp_valid"]]
        assert 0.5 < np.median(pts[:, 2]) < 2.0
    stages = [int(r["viba_stage"]) for r in mono["jax"]]
    k = stages.index(1)

    def baseline(rec):
        return np.linalg.norm(rec["kf_t"][1] - rec["kf_t"][0])

    s_j = baseline(mono["jax"][k]) / baseline(mono["jax"][k - 1])
    s_p = baseline(mono["port"][k]) / baseline(mono["jax"][k - 1])
    assert abs(s_p - s_j) < 1e-3 * s_j, (s_p, s_j)
    assert abs(s_j - 1.0) > 1e-2


def test_convert_round_trip_in_init_mode(mono):
    m_np, c_np = mono["states"][1]
    assert int(c_np["mode"]) == INIT
    back = convert.carry_to_numpy(convert.carry_from_numpy(c_np,
                                                           device="cpu"))
    for k, v in c_np["ref_bank"].items():
        np.testing.assert_array_equal(back["ref_bank"][k], v, err_msg=k)
        assert back["ref_bank"][k].dtype == v.dtype, k
    assert back["ref_time"] == c_np["ref_time"]
    np.testing.assert_array_equal(back["key"], c_np["key"])
    jt, tt = mono["trackers"]
    assert tt.dist.dtype == torch.float32 and tt.dist.shape == (1, 4)
    assert tt._step.dist is tt.dist


# ---------------------------------------------------------------------------
# RGB-D
# ---------------------------------------------------------------------------

W_D, H_D = scene.RGBD_W // 2, scene.RGBD_H // 2
N_DEPTH = 5


@pytest.fixture(scope="module")
def rgbd():
    pin = np.array(scene.RGBD_PINHOLE, np.float32) / 2
    rig_np, frames, _, _, batches, depths = \
        scene.make_single_camera_sequence(
            N_DEPTH, 1.25 * (N_DEPTH - 1) / 159, W_D, H_D, pin, depth=True)
    kw = scene.single_camera_config_kwargs(N_DEPTH, W_D, H_D, max_kf=8,
                                           max_mp=2048)
    # no window BA: early in a one-camera map both fixed members of the
    # reference's window are slot 0, which leaves the scale free
    # (ROADMAP Queue 3); `local_ba_step` is held on the mono run
    kw.update(use_depth=True, depth_cap=192, depth_max=25.0,
              kf_max_interval_s=0.04, obs_cap=4096, ba_every_kf=False)
    out = _run(kw, rig_np, frames, batches, depths=depths)
    out["frames"], out["batches"] = frames, batches
    return out


def test_rgbd_rig_init_from_depth(rgbd):
    """Frame 0 initializes from depth alone (no stereo pair), later
    keyframes spawn from depth too."""
    first = rgbd["jax"][0]
    assert int(first["mode"]) == OK and int(first["n_kf"]) == 1
    assert int(first["n_mp"]) >= 40
    assert int(rgbd["jax"][-1]["n_kf"]) >= 3
    assert int(rgbd["jax"][-1]["n_mp"]) > int(first["n_mp"])


@pytest.mark.parametrize("key", INTS)
def test_rgbd_integers_equal(rgbd, key):
    _integers_equal(rgbd, key, 1)


@pytest.mark.parametrize("key", FLOATS)
def test_rgbd_floats_close(rgbd, key):
    _floats_close(rgbd, key, 1)


def test_rgbd_first_tracked_frame(rgbd):
    """Frame 1, tracked from keyframe 0's own pose (see the module
    docstring): the predicted levels tie for a share of the landmarks in
    the reference's formula, in both packages."""
    _bounded_frame(rgbd, 1, 0.03, 1e-2)
    jt, tt = rgbd["trackers"]
    m_np, c_np = rgbd["states"][1]
    m = convert.map_from_numpy(m_np, device="cpu")
    _, lvl, vis, dist = ttrk.project_landmarks(
        m, torch.eye(3), torch.zeros(3), tt.rig.kind, tt.rig.params[0],
        tt.rig.R_cb[0], tt.rig.t_cb[0], float(W_D), float(H_D))
    x = torch.log(m.mp_dmax / dist) / np.log(1.2)
    at_tie = vis & ((x - torch.round(x)).abs() < 1e-5)
    assert int(at_tie.sum()) == int(vis.sum()) > 100
    # ceil lands on the exact level or the next one
    assert bool(((lvl - torch.round(x).to(torch.int32)) <= 1)[vis].all())


def test_rgbd_push_needs_depth(rgbd):
    _, tt = rgbd["trackers"]
    t, b = rgbd["batches"][-1]
    with pytest.raises(ValueError, match="depth"):
        tt.push(rgbd["frames"][-1], t + 0.05, b)
