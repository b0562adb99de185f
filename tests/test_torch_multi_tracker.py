"""The host-policy rig tracker `MultiTracker` of the port against the JAX
reference on the CPU.

Every frame of the port starts from the reference's state of the frame
before (`convert.multi_tracker_state_from_numpy`), is fed the reference's
own features (the port tracker's `_ext` replaced: descriptor bits on
pyramid levels >= 1 differ by float32 ties, ROADMAP Queue 3) and, where a
RANSAC runs, the reference's samples (`jax.random.categorical` from its
key, handed over as `sample_idx`). Each configuration runs the reference
once, in a module-scoped fixture; the configurations share the
reference's compiled steps where their shapes agree.

Tolerances: integers exact (mode, keyframe and landmark counts, validity,
bindings, `last_kf_slot`, `viba_stage`, the IMU flag, the re-entry boost,
the LOST count, which `kf_pre` entries exist, the trajectory's keyframe
references and the return value); poses, biases, `kf_pre` deltas and
trajectory entries 1e-3; velocities 2e-2 m/s, the pose tolerance over one
frame interval (before the IMU init a velocity is the difference of two
poses over 0.05 s); landmarks 1e-3 relative (float32
solves summed in another order), and beyond 15 m 1e-3 (r / 15 m)^2
relative: the stereo midpoint triangulation divides by 1 - cos^2 of the
parallax, which at a 0.2 m baseline cancels as (0.2 / r)^2 in float32, so
two orders of the same sums put a point 19 m out 2 cm apart and one 35 m
out 9 cm apart (ROADMAP Queue 3, "far stereo points").

Named exception: a fuse flip. A new point whose triangulation differs
between the packages by the float32 spread above can lie inside
`fuse_new_landmarks`'s 2% distance gate of an older landmark in one
package only. On such a frame (one in the stereo-inertial run, a stereo
point 16 m out) up to two bindings of the new
keyframe and up to two landmark validities differ, and the window BA that
follows re-solves with an observation more or less: the landmarks the
differing bindings name move by up to 1.6 m along their rays, and the
other landmarks are held to 2% relative. Poses and everything else are
held as everywhere; the next frame starts from the reference's state
again.

Configurations (256 features x 3 levels at 320 x 240, 400 Hz IMU on the
flagship's orbit):
* (a) stereo-inertial, the flagship's front KannalaBrandt8 pair: rig init,
  tracking, a keyframe on every tracked frame, the first staged IMU init
  (frame 2), then VI tracking and the VI window BA;
* (e) on the same run, frames 7 and 8 black: LOST (coasting on the IMU),
  a relocalization that fails on the black frame and one that succeeds on
  frame 9, then the re-entry boost counting down;
* (f) on the same run, the 12-keyframe slab full on frame 14:
  `_recycle_slots` decimates slot 3 and welds `kf_pre` across it;
* (b) visual-only (`use_imu=False`), constant-velocity prediction, and
  (h) the same frames through `fused_frontend=True`, which must give the
  unfused route's state exactly;
* (c) the KB8 pair with `lapping` (the reference's
  `tests/test_streaming_vi.py` rig's areas);
* (d) mono-inertial, one radtan-distorted EuRoC camera at half size:
  `_initialize_mono` with its `match_nn` (mutual) held exactly, the
  two-view init and tracking after it. Its init frame is held within the
  bounds `tests/test_torch_mono.py` states for the same float32 two-view
  solve: the discrete state exact but the landmark count (within 4%),
  poses 5e-3;
* (g) `_integrate` without the zero-dt padding against the reference's
  padded call: 1e-5 relative.
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
from openmavis_tpu.pipeline import multi_tracking as jmt
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.imu import preintegration as tpre
from openmavis_tpu_torch.pipeline import loop_closing as tlc
from openmavis_tpu_torch.pipeline import multi_tracking as tmt
from openmavis_tpu_torch.pipeline import tracking as ttrk
from openmavis_tpu_torch.slam_map import atlas as tatlas


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are tiny: one intra-op thread is as fast as
    eight, and eight per test worker oversubscribe the machine when the
    files of the suite run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 320, 240
FAR_M = 15.0
V_ATOL = 1e-3 / 0.05     # the pose tolerance over one frame interval
ORB = dict(n_features=256, n_levels=3)
NOT_INIT, OK, LOST = (tmt.MultiTracker.NOT_INITIALIZED, tmt.MultiTracker.OK,
                      tmt.MultiTracker.LOST)
INTS = ("ok", "state", "n_kf", "n_mp", "kf_valid", "kf_obs", "mp_valid",
        "last_kf_slot", "viba_stage", "imu_initialized", "_reentry_boost",
        "lost_frames", "kf_pre_valid", "traj_ref")
FLOATS = ("kf_R", "kf_t", "kf_v", "R", "t", "v", "bias", "mp_pos",
          "kf_pre_dR", "kf_pre_dV", "kf_pre_dP", "kf_pre_dT", "traj_R",
          "traj_t")


def _rig_pair():
    """The flagship rig's front KannalaBrandt8 pair (0.2 m baseline)."""
    rig = scene.build_rig("kb8", W, H)
    return {k: (v if k == "kind" else v[:2]) for k, v in rig.items()}


def _pair_sequence(n):
    """n frames of the flagship orbit at its angular step, 400 Hz IMU."""
    rig_np = _rig_pair()
    R_wb, t_wb = scene.synthetic.orbit_trajectory(
        n, radius=6.0, frac=1.25 * (n - 1) / (scene.N_FRAMES - 1))
    frames = np.clip(scene.render_rig_sequence(rig_np, R_wb, t_wb, W, H),
                     0, 255).astype(np.uint8)
    imu = scene.synthetic.imu_from_trajectory(R_wb, t_wb, 1.0 / scene.FPS_IN,
                                              rate_mult=20)
    return rig_np, frames, scene.imu_batches(imu, n)


def _pair_config(**kw):
    cfg = dict(img_w=W, img_h=H, n_cams=2, stereo_pairs=((0, 1),),
               max_kf=12, max_mp=2048, imu_freq=400.0, imu_init_kfs=3,
               kf_max_interval_s=0.04, ba_window=8, temporal_refs=2,
               local_map_window=10)
    cfg.update(kw)
    return cfg


def _np_tree(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _ref_state(jt) -> dict:
    """The reference tracker's attributes, laid out as
    `convert.multi_tracker_state_to_numpy` lays out the port's."""
    d = {k: getattr(jt, k) for k in convert._MT_HOST}
    d.update({k: np.asarray(getattr(jt, k)) for k in convert._MT_TENSORS})
    d["map"] = _np_tree(jt.map)
    d["kf_pre"] = [None if p is None else _np_tree(p) for p in jt.kf_pre]
    d["_imu_frame"] = list(jt._imu_frame)
    d["_imu_kf"] = list(jt._imu_kf)
    d["trajectory"] = list(jt.trajectory)
    d["_init_bank"] = (None if jt._init_bank is None else
                       {k: np.asarray(v) for k, v in jt._init_bank.items()})
    d["key"] = np.asarray(jt.key)
    return d


def _record(d: dict, ok) -> dict:
    """What the tests compare, from a state dict of either package."""
    m = d["map"]
    rec = {k: np.asarray(d[k]) for k in
           ("state", "n_kf", "last_kf_slot", "viba_stage", "imu_initialized",
            "_reentry_boost", "lost_frames", "R", "t", "v", "bias")}
    rec.update({k: m[k] for k in ("n_mp", "kf_valid", "kf_obs", "mp_valid",
                                  "kf_R", "kf_t", "kf_v", "mp_pos")})
    rec["ok"] = np.asarray(bool(ok))
    pre = d["kf_pre"]
    rec["kf_pre_valid"] = np.array([p is not None for p in pre])
    for f in ("dR", "dV", "dP", "dT"):
        rec["kf_pre_" + f] = np.stack(
            [p[f] for p in pre if p is not None] or [np.zeros(0)])
    traj = d["trajectory"]
    rec["traj_ref"] = np.array([(e[1], e[2]) for e in traj])
    rec["traj_R"] = np.stack([e[3] for e in traj])
    rec["traj_t"] = np.stack([e[4] for e in traj])
    return rec


def _two_view_samples(d, bank_j, cfg_kw, F):
    """The reference's two-view draws on a frame that attempts the mono
    init, or None: the key split as `_initialize_mono` splits it, then as
    `two_view.reconstruct` draws (`jax.random.categorical`)."""
    if d["state"] != NOT_INIT or d["_init_bank"] is None:
        return None
    b0 = d["_init_bank"]
    idx, _ = jmatcher.match_nn(
        bank_j["desc"][:F], bank_j["valid"][:F], jnp.asarray(b0["desc"][:F]),
        jnp.asarray(b0["valid"][:F]), max_dist=jmatcher.TH_LOW, ratio=0.9,
        mutual=True)
    matched = np.asarray(idx) >= 0
    if matched.sum() < cfg_kw.get("init_min_matches", 80):
        return None
    sub = jax.random.split(jnp.asarray(d["key"]))[1]
    key_e, key_h = jax.random.split(sub)
    logits = jnp.where(jnp.asarray(matched), 0.0, -1e9)
    return tuple(torch.as_tensor(np.array(jax.random.categorical(
        k, logits[None, None, :], shape=(256, n))))
        for k, n in ((key_e, 8), (key_h, 4)))


def _reloc_samples(d, tt, feats_t):
    """The reference's PnP draws on a LOST frame: the key split as
    `process_frame` splits it, one subkey per candidate keyframe as
    `relocalize_step` splits it, `ransac_pnp`'s 512 x 6 categorical over
    each candidate's valid matches."""
    if d["state"] != LOST or d["n_kf"] < 2:
        return None
    band0 = tt._band0_feats(tmt.concat_bands(feats_t))
    m = convert.map_from_numpy(d["map"], device="cpu")
    _, cand = ttrk.relocalization_candidates(m, band0)
    keys = jax.random.split(jax.random.split(jnp.asarray(d["key"]))[1],
                            ttrk.N_RELOC_CAND)
    out = []
    for kf, k in zip(cand.tolist(), keys):
        _, _, valid = ttrk.relocalization_matches(m, band0, kf)
        logits = jnp.where(jnp.asarray(valid.numpy()), 0.0, -1e9)
        out.append(np.asarray(jax.random.categorical(
            k, logits[None, None, :], shape=(512, 6))))
    return torch.as_tensor(np.stack(out))


def _run(cfg_kw, rig_np, frames, batches, noise_sigmas=scene.NOISE_SIGMAS,
         dist=None, fused=False, orb=ORB):
    """Both trackers over the frames, the port stepped from the
    reference's state each frame. With `fused`, a second port tracker
    (`fused_frontend=True`, its extraction handed the reference's
    features too) steps from the same states. Returns dict(jax, port,
    fused, states, trackers, events)."""
    jrig = JRig(rig_np["kind"], *(jnp.asarray(rig_np[k])
                                  for k in ("params", "R_cb", "t_cb")))
    jt = jmt.MultiTracker(
        jrig, jmt.MultiTrackerConfig(orb=jex.OrbConfig(**orb), **cfg_kw),
        jpre.ImuNoise.from_sigmas(*noise_sigmas), seed=0, dist=dist)

    def port(**kw):
        return tmt.MultiTracker(
            convert.rig_from_numpy(rig_np, device="cpu"),
            tmt.MultiTrackerConfig(orb=tex.OrbConfig(**orb),
                                   **dict(cfg_kw, **kw)),
            tpre.ImuNoise.from_sigmas(*noise_sigmas, device="cpu"),
            seed=0, dist=dist, device="cpu")

    shared = {}

    def ext(images):
        return shared["feats"]

    tt = port()
    tt._ext = ext
    ports = [tt]
    if fused:
        tf = port(fused_frontend=True)
        tf._ext = ext
        ports.append(tf)
    own_extract, own_integrate = tex.extract_multicam, jpre.integrate
    out = dict(jax=[], port=[], fused=[], states=[], events=[],
               frames=frames, batches=batches)
    try:
        # the fused route extracts inside `frame_step_multi`
        tex.extract_multicam = lambda images, cfg: shared["feats"]
        # the reference's host tracker integrates op by op (0.7 s a call
        # here); compiled, as its streaming tracker runs it
        jpre.integrate = jax.jit(own_integrate)
        for i in range(len(frames)):
            t, b = batches[i]
            for s in b:
                jt.feed_imu(*s)
            d = _ref_state(jt)
            out["states"].append(d)
            img_j = jnp.asarray(frames[i].astype(np.float32))
            fj = jt._ext(img_j)
            shared["feats"] = tex.Features(
                *(torch.as_tensor(np.array(x)) for x in fj))
            samples = (_two_view_samples(d, jmt.concat_bands(fj), cfg_kw,
                                         orb["n_features"])
                       if not cfg_kw["stereo_pairs"] else
                       _reloc_samples(d, tt, shared["feats"]))
            out["events"].append(
                None if samples is None else
                ("two_view" if isinstance(samples, tuple) else "reloc"))
            for p, name in zip(ports, ("port", "fused")):
                convert.multi_tracker_state_from_numpy(d, p)
                ok = p.process_frame(frames[i], t, sample_idx=samples)
                out[name].append(_record(
                    convert.multi_tracker_state_to_numpy(p), ok))
            ok = jt.process_frame(img_j, t)
            out["jax"].append(_record(_ref_state(jt), ok))
    finally:
        tex.extract_multicam, jpre.integrate = own_extract, own_integrate
    out["trackers"] = (jt, tt)
    return out


FLIP_KEYS = ("kf_obs", "mp_valid")


def _fuse_flips(run, name="port"):
    """The frames on which bindings or landmark validity differ: each must
    be a fuse flip (module docstring), and a run has at most one."""
    flips = [i for i, (a, b) in enumerate(zip(run[name], run["jax"]))
             if any((a[k] != b[k]).any() for k in FLIP_KEYS)]
    assert len(flips) <= 1, flips
    for i in flips:
        a, b = run[name][i], run["jax"][i]
        diff = a["kf_obs"] != b["kf_obs"]
        assert diff.sum() <= 2 and (a["mp_valid"] != b["mp_valid"]).sum() <= 2
        named = set(a["kf_obs"][diff].tolist()) | set(
            b["kf_obs"][diff].tolist())
        rest = np.array([j not in named for j in range(len(b["mp_pos"]))])
        r = np.linalg.norm(b["mp_pos"][rest], axis=-1)
        err = np.linalg.norm(a["mp_pos"][rest] - b["mp_pos"][rest], axis=-1)
        assert (err <= 1e-3 + 2e-2 * r).all(), (i, err.max())
    return tuple(flips)


def _integers_equal(run, key, skip=(), name="port"):
    if key in FLIP_KEYS:
        skip = skip + _fuse_flips(run, name)
    for i, (a, b) in enumerate(zip(run[name], run["jax"])):
        if i in skip:
            continue
        np.testing.assert_array_equal(a[key], b[key],
                                      err_msg=f"frame {i}: {key}")


def _landmarks_close(a, b, err_msg):
    """Landmark positions: 1e-3 relative, and beyond FAR_M of the origin
    1e-3 (r / FAR_M)^2 relative (see the module docstring)."""
    r = np.linalg.norm(b, axis=-1)
    tol = 1e-3 + 1e-3 * r * np.maximum(1.0, (r / FAR_M) ** 2)
    err = np.linalg.norm(a - b, axis=-1)
    bad = np.flatnonzero(err > tol)
    assert not bad.size, (err_msg, bad[:5], err[bad[:5]], r[bad[:5]])


def _floats_close(run, key, skip=(), name="port"):
    if key == "mp_pos":
        skip = skip + _fuse_flips(run, name)
    for i, (a, b) in enumerate(zip(run[name], run["jax"])):
        if i in skip:
            continue
        assert a[key].shape == b[key].shape, (i, key)
        if key == "mp_pos":
            _landmarks_close(a[key], b[key], f"frame {i}: {key}")
        else:
            atol = V_ATOL if key in ("v", "kf_v") else 1e-3
            np.testing.assert_allclose(a[key], b[key], atol=atol, rtol=0,
                                       err_msg=f"frame {i}: {key}")


# ---------------------------------------------------------------------------
# (a), (e), (f): stereo-inertial with a blackout and a full slab
# ---------------------------------------------------------------------------

N_S = 15
BLACK = (7, 8)
FIRST_RECYCLE = 14


@pytest.fixture(scope="module")
def stereo():
    rig_np, frames, batches = _pair_sequence(N_S)
    frames = frames.copy()
    frames[list(BLACK)] = 0
    return _run(_pair_config(), rig_np, frames, batches)


def test_stereo_inertial_course(stereo):
    """Rig init on frame 0, a keyframe on every tracked frame, the first
    staged IMU init on frame 2 (the third keyframe), VI tracking after."""
    rec = stereo["jax"]
    assert [int(r["n_kf"]) for r in rec[:7]] == list(range(1, 8))
    assert [int(r["viba_stage"]) for r in rec[:4]] == [0, 0, 1, 1]
    assert bool(rec[2]["imu_initialized"])
    # VI window BA from keyframe 3 on: every interval of the window exists
    assert rec[6]["kf_pre_valid"].tolist() == [False] + [True] * 6
    d = stereo["states"][4]
    assert d["imu_initialized"] and d["_imu_frame"]


@pytest.mark.parametrize("key", INTS)
def test_stereo_integers_equal(stereo, key):
    _integers_equal(stereo, key)


@pytest.mark.parametrize("key", FLOATS)
def test_stereo_floats_close(stereo, key):
    _floats_close(stereo, key)


def test_lost_relocalized_reentry(stereo):
    """Black frames 7 and 8: LOST on both (the pose coasting on the IMU),
    a failed relocalization on frame 8, a successful one on frame 9 with
    the reference's PnP samples, then the re-entry boost counting down."""
    rec = stereo["jax"]
    assert [int(r["state"]) for r in rec[6:10]] == [OK, LOST, LOST, OK]
    assert [bool(r["ok"]) for r in rec[6:10]] == [True, False, False, True]
    assert [int(r["lost_frames"]) for r in rec[6:10]] == [0, 1, 2, 0]
    assert [int(r["_reentry_boost"]) for r in rec[8:14]] == [0, 5, 4, 3,
                                                              2, 1]
    assert stereo["events"][8:10] == ["reloc", "reloc"]
    assert [int(r["n_kf"]) for r in rec[6:10]] == [7, 7, 7, 8]
    # the coasting pose moved with the IMU, not stood still
    assert np.linalg.norm(rec[8]["t"] - rec[6]["t"]) > 0.1


def test_recycle_full_slab(stereo):
    """From frame 14 the 12-keyframe slab is full: decimation drops slot 3
    (the only odd slot of the old half outside the recent eight), the
    slabs compact, and `kf_pre` is welded across the dropped keyframe;
    the welded entries equal the reference's (held with every other
    entry in `test_stereo_floats_close`)."""
    for i in range(FIRST_RECYCLE, N_S):
        before, after = stereo["states"][i], stereo["jax"][i]
        assert before["n_kf"] == 12 and int(after["n_kf"]) == 12
        assert after["kf_valid"].all()
        assert after["kf_pre_valid"].tolist() == [False] + [True] * 11
    # new slot 3 (old 4) carries the old intervals 3 and 4 composed; the
    # stacked entries start at slot 1
    d = stereo["states"][FIRST_RECYCLE]
    dT = float(d["kf_pre"][3]["dT"]) + float(d["kf_pre"][4]["dT"])
    for name in ("port", "jax"):
        welded = stereo[name][FIRST_RECYCLE]["kf_pre_dT"][2]
        assert float(welded) == pytest.approx(dT, abs=1e-6), name
    assert dT > 0.09


# ---------------------------------------------------------------------------
# (b), (h): visual-only stereo, unfused and fused
# ---------------------------------------------------------------------------

N_B = 4


@pytest.fixture(scope="module")
def visual():
    rig_np, frames, batches = _pair_sequence(N_B)
    return _run(_pair_config(use_imu=False), rig_np, frames, batches,
                fused=True)


def test_visual_only_course(visual):
    """No IMU: no preintegration at all, constant-velocity prediction, a
    keyframe whenever the inliers drop, never an IMU init."""
    rec = visual["jax"]
    assert all(bool(r["ok"]) for r in rec)
    assert all(int(r["viba_stage"]) == 0 for r in rec)
    assert not any(r["kf_pre_valid"].any() for r in rec)


@pytest.mark.parametrize("key", INTS)
def test_visual_only_integers_equal(visual, key):
    _integers_equal(visual, key)


@pytest.mark.parametrize("key", FLOATS)
def test_visual_only_floats_close(visual, key):
    _floats_close(visual, key)


@pytest.mark.parametrize("key", INTS + FLOATS)
def test_fused_frontend_equals_unfused(visual, key):
    """`fused_frontend=True` runs extraction, banding and tracking as
    `frame_step_multi`: from the same state and features, the same state
    as the unfused route, exactly."""
    for i, (a, b) in enumerate(zip(visual["fused"], visual["port"])):
        np.testing.assert_array_equal(a[key], b[key],
                                      err_msg=f"frame {i}: {key}")


# ---------------------------------------------------------------------------
# (c): the KB8 pair with lapping areas
# ---------------------------------------------------------------------------

N_C = 3
LAPPING = ((W // 8, W - 1), (0, W - W // 8))


@pytest.fixture(scope="module")
def lapping():
    rig_np, frames, batches = _pair_sequence(N_C)
    return _run(_pair_config(lapping=LAPPING), rig_np, frames, batches)


def test_lapping_restricts_stereo(lapping, stereo):
    """Only keypoints inside each camera's lapping columns are stereo
    candidates: the rig init spawns fewer landmarks than at full width,
    and every stereo landmark of keyframe 0 lies in camera 0's area."""
    n_lap = int(lapping["jax"][0]["n_mp"])
    assert 50 <= n_lap < int(stereo["jax"][0]["n_mp"])
    d = lapping["states"][1]["map"]
    F = ORB["n_features"]
    bound = d["kf_obs"][0][:F] >= 0
    x = d["kf_xy"][0][:F, 0]
    assert bound.any()
    assert ((x[bound] >= LAPPING[0][0]) & (x[bound] <= LAPPING[0][1])).all()


@pytest.mark.parametrize("key", INTS)
def test_lapping_integers_equal(lapping, key):
    _integers_equal(lapping, key)


@pytest.mark.parametrize("key", FLOATS)
def test_lapping_floats_close(lapping, key):
    _floats_close(lapping, key)


# ---------------------------------------------------------------------------
# (d): mono-inertial, one radtan camera
# ---------------------------------------------------------------------------

W_M, H_M = scene.EUROC_W // 2, scene.EUROC_H // 2
N_M = 4
# 512 features: at 256 the frames match ~60 times, and the reference's own
# two-view attempts fail (its unnormalized float32 8-point, ROADMAP Queue
# 3) on every frame; the gates are scaled down from the reference's
# 80 / 50 for 1,000+ features
ORB_M = dict(n_features=512, n_levels=3)


@pytest.fixture(scope="module")
def mono():
    pin = np.array(scene.EUROC_PINHOLE, np.float32) / 2
    rig_np, frames, _, _, batches, _ = scene.make_single_camera_sequence(
        N_M, 1.25 * (N_M - 1) / (scene.N_FRAMES - 1), W_M, H_M, pin,
        dist=scene.EUROC_RADTAN)
    kw = dict(img_w=W_M, img_h=H_M, n_cams=1, stereo_pairs=(), max_kf=12,
              max_mp=2048, imu_freq=200.0, imu_init_kfs=8,
              kf_max_interval_s=0.04, init_min_matches=50,
              init_min_inliers=40)
    return _run(kw, rig_np, frames, batches,
                noise_sigmas=scene.EUROC_NOISE_SIGMAS,
                dist=np.array(scene.EUROC_RADTAN, np.float32)[None],
                orb=ORB_M)


def _mono_init_frame(run):
    return [bool(r["ok"]) for r in run["jax"]].index(True)


def test_mono_course(mono):
    """Frame 0 becomes the two-view reference; a later frame initializes
    from two views (two keyframes), the frames after track against it."""
    rec = mono["jax"]
    i = _mono_init_frame(mono)
    assert not bool(rec[0]["ok"]) and mono["states"][1]["_init_bank"]
    assert int(rec[i]["n_kf"]) == 2 and int(rec[i]["state"]) == OK
    assert "two_view" in mono["events"][:i + 1]
    assert all(bool(r["ok"]) for r in rec[i:]) and i < N_M - 1
    # the KF0 -> KF1 interval is preintegrated over the init's gap
    assert rec[i]["kf_pre_valid"].tolist() == [False, True]


def test_mono_init_match_nn(mono):
    """`_initialize_mono`'s mutual `match_nn` on camera 0's band, the new
    kernel call site, against the reference's on the same features."""
    from openmavis_tpu_torch.frontend import matcher as tmatcher
    jt, _ = mono["trackers"]
    d = mono["states"][_mono_init_frame(mono)]
    b0 = d["_init_bank"]
    cur = mono["states"][_mono_init_frame(mono) + 1]["map"]
    F = ORB_M["n_features"]
    desc, valid = cur["kf_desc"][1][:F], cur["kf_feat_valid"][1][:F]
    ij, dj = jmatcher.match_nn(
        jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(b0["desc"][:F]),
        jnp.asarray(b0["valid"][:F]), max_dist=jmatcher.TH_LOW, ratio=0.9,
        mutual=True)
    it, dt = tmatcher.match_nn(
        torch.as_tensor(desc), torch.as_tensor(valid),
        torch.as_tensor(b0["desc"][:F]), torch.as_tensor(b0["valid"][:F]),
        max_dist=tmatcher.TH_LOW, ratio=0.9, mutual=True)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert int((it >= 0).sum()) >= 50


@pytest.mark.parametrize("key", INTS)
def test_mono_integers_equal(mono, key):
    i = _mono_init_frame(mono)
    skip = (i,) if key in ("n_mp", "kf_obs", "mp_valid") else ()
    _integers_equal(mono, key, skip)


@pytest.mark.parametrize("key", FLOATS)
def test_mono_floats_close(mono, key):
    _floats_close(mono, key, skip=(_mono_init_frame(mono),))


def test_mono_init_frame(mono):
    """The frame that initializes: its two-view solve at ~60 matches is
    ill-conditioned in float32 (`tests/test_torch_mono.py`); landmark
    count within 4%, poses 5e-3."""
    i = _mono_init_frame(mono)
    a, b = mono["port"][i], mono["jax"][i]
    assert abs(int(a["n_mp"]) - int(b["n_mp"])) <= 0.04 * int(b["n_mp"])
    for key in ("kf_R", "kf_t", "R", "t"):
        np.testing.assert_allclose(a[key], b[key], atol=5e-3, rtol=0,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# (g): _integrate without the padding
# ---------------------------------------------------------------------------

def _rel_err(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("span,offset", [(0.05, 0.0), (0.25, 0.0011),
                                         (0.8, 0.0), (0.0, 0.0)])
def test_integrate_trimmed_against_padded(stereo, span, offset):
    """One frame's samples, a keyframe interval of 100, more than
    `imu_buf` (the first 256 taken, no tail) and none at all: the port
    integrates only the filled samples (and the tail up to t_end), the
    reference pads to 256 with zero-dt steps. Every delta, Jacobian and
    the covariance within 1e-5 of the reference's, relative to each
    field's largest entry; dT exact to float32 rounding."""
    jt, tt = stereo["trackers"]
    bias = np.array([0.01, -0.02, 0.005, 0.05, -0.03, 0.02], np.float32)
    own = jt.bias, tt.bias
    jt.bias, tt.bias = jnp.asarray(bias), torch.as_tensor(bias)
    R_wb, t_wb = scene.synthetic.orbit_trajectory(20, radius=6.0, frac=0.15)
    queue = scene.synthetic.imu_from_trajectory(R_wb, t_wb, 0.05,
                                                rate_mult=20)
    t0 = 0.1 + offset
    t1 = t0 + span
    try:
        pj = jt._integrate(queue, t1, t0)
        pt = tt._integrate(queue, t1, t0)
    finally:
        jt.bias, tt.bias = own
    for f in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C"):
        a, b = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        assert _rel_err(a, b) <= 1e-5, (f, _rel_err(a, b))
    assert float(pt.dT) == pytest.approx(float(pj.dT), rel=1e-6, abs=1e-9)
    # the longest span is cut at imu_buf = 256 samples (0.64 s)
    assert float(pj.dT) == pytest.approx(min(span, 0.64), abs=1e-3)


# ---------------------------------------------------------------------------
# entry points and state transfer
# ---------------------------------------------------------------------------

def test_entry_points(monkeypatch, stereo):
    """The tracker builds on the current CUDA device unless told the CPU,
    and raises without a card; an atlas (ROADMAP item 6) is taken: the
    tracker allocates map 0 there on its own device and tracks into it; a
    loop closer is taken."""
    jt, tt = stereo["trackers"]
    rig = tt.rig
    cfg = tt.cfg
    for name in ("process_frame", "feed_imu", "get_trajectory"):
        assert callable(getattr(tt, name))
    assert tt.localization_only is False and tt.bias.shape == (6,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmt.MultiTracker(rig, cfg)
    atlas = tatlas.Atlas()
    at = tmt.MultiTracker(rig, cfg, atlas=atlas, device="cpu")
    assert at.atlas is atlas and atlas.n_maps() == 1 and at.map_id == 0
    assert atlas.device == torch.device("cpu") and at.map is atlas.maps[0]
    assert at.map.kf_obs.shape == (cfg.max_kf,
                                   cfg.n_cams * cfg.orb.n_features)
    lc = tlc.LoopCloser(None, cfg.max_kf, rig=rig, device="cpu")
    assert tmt.MultiTracker(rig, cfg, loop_closer=lc,
                            device="cpu").loop_closer is lc


def test_localization_only_adds_no_keyframe(stereo):
    """With `localization_only` the tracker tracks and never inserts a
    keyframe (the reference's ActivateLocalizationMode)."""
    frames, batches = stereo["frames"], stereo["batches"]
    _, tt = stereo["trackers"]
    d = stereo["states"][5]
    convert.multi_tracker_state_from_numpy(d, tt)
    tt._ext = lambda images: tex.extract_multicam(images, tt.cfg.orb)
    tt.localization_only = True
    try:
        for s in batches[5][1]:
            tt.feed_imu(*s)
        assert tt.process_frame(frames[5], batches[5][0])
        assert tt.n_kf == d["n_kf"] and tt.state == OK
    finally:
        tt.localization_only = False


def test_state_round_trip(stereo):
    """A reference state carried into the port and back: the same values
    in the port's dtypes, `kf_pre` and the queues included."""
    _, tt = stereo["trackers"]
    d = stereo["states"][FIRST_RECYCLE]
    convert.multi_tracker_state_from_numpy(d, tt)
    back = convert.multi_tracker_state_to_numpy(tt)
    for k in convert._MT_HOST:
        assert back[k] == d[k], k
    for k in convert._MT_TENSORS:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
    for k, v in d["map"].items():
        np.testing.assert_array_equal(back["map"][k], v, err_msg=k)
        assert back["map"][k].dtype == v.dtype, k
    assert [p is None for p in back["kf_pre"]] == [p is None
                                                    for p in d["kf_pre"]]
    for a, b in zip(back["kf_pre"], d["kf_pre"]):
        if b is not None:
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(back["_imu_kf"]) == len(d["_imu_kf"])
    for a, b in zip(back["trajectory"], d["trajectory"]):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])
    np.testing.assert_array_equal(back["key"], d["key"])
