"""`depth_pin`: depth priors of a fisheye rig whose depth maps live in a
virtual pinhole, through both trackers that spawn from depth, port
against the JAX reference on the CPU.

The rig is the flagship's front KannalaBrandt8 pair at 320 x 240 without
its stereo pair (`use_depth` alone initializes it), 256 features x 2
levels, 400 Hz IMU on the flagship's orbit, a keyframe on every frame.
Each camera's BlobWorld depth map is rendered in a virtual pinhole of the
camera's pose and size (tests/test_torch_depth.py's `PIN` at twice its
160 x 120), handed to both trackers as `depth_pin`:
* `StreamingVITracker`: frame 0 initializes from depth (`rig_init`'s
  `depth_spawn`), frame 1 tracks and inserts a keyframe that spawns from
  depth first (`VIStep.kf_insert`'s `depth_spawn`);
* `MultiTracker`: the same two frames through `_initialize_rig` and
  `_insert_keyframe`, each spawning with `spawn_from_depth_multi`. It
  runs its window BA on every keyframe; from frame 2 on that window has
  one fixed keyframe on a rig without a stereo pair, the scale is free,
  and the two packages' float32 solves part by a gauge (every landmark
  0.2% apart), which is why the streaming tracker runs none here.

Every frame of the port starts from the reference's state of the frame
before, fed the reference's features, as tests/test_torch_mono.py and
tests/test_torch_multi_tracker.py step them (their helpers are reused).
Tolerances are theirs: integers exact; poses 1e-3; landmarks 1e-3
relative (the multi-tracker's beyond 15 m 1e-3 (r / 15 m)^2 relative).
As in tests/test_torch_mono.py's RGB-D run the streaming
tracker runs no window BA (both fixed members of an early window are
slot 0 and the scale is free). The same state spawned without
`depth_pin` must not give the reference's landmarks: the option is
live.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.imu import preintegration as jpre
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.imu import preintegration as tpre
from openmavis_tpu_torch.io import synthetic
from openmavis_tpu_torch.pipeline import multi_tracking as tmt
from openmavis_tpu_torch.pipeline import streaming_vi as tsv
from openmavis_tpu_torch.pipeline.streaming import OK
import test_torch_mono as mono_t
import test_torch_multi_tracker as mt_t
import test_torch_ref_cache as ref_cache


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread per test worker, as in the other test_torch_*
    files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = mt_t.W, mt_t.H
# tests/test_torch_depth.py's virtual pinhole at this image size
PIN = (192.0, 192.0, W / 2, H / 2)
N = 2
# two pyramid levels: the reference's compiles are most of this file's time
ORB = dict(n_features=256, n_levels=2)


def _sequence():
    """The front pair on N frames of the flagship orbit, with each
    camera's z-depth rendered in the virtual pinhole: (rig_np, frames
    [T, 2, H, W] uint8, IMU batches, depths [T, 2, H, W] float32)."""
    rig_np, frames, batches = mt_t._pair_sequence(N)
    R_wb, t_wb = synthetic.orbit_trajectory(
        N, radius=6.0, frac=1.25 * (N - 1) / (scene.N_FRAMES - 1))
    world = synthetic.BlobWorld.create(seed=3, n=4000)
    pin = np.zeros(8, np.float32)
    pin[:4] = PIN
    depths = []
    for c in range(2):
        R_cb, t_cb = rig_np["R_cb"][c], rig_np["t_cb"][c]
        R_wc = R_wb @ R_cb.T
        t_wc = t_wb + np.einsum("tij,j->ti", R_wb, -R_cb.T @ t_cb)
        depths.append(synthetic.render_depth_sequence(
            world, scene.PINHOLE, pin, R_wc, t_wc, W, H))
    depths = np.stack(depths, axis=1).astype(np.float32)
    assert 0.05 < (depths > 0).mean() < 0.95
    return rig_np, frames, batches, depths


def _config(**kw):
    cfg = dict(img_w=W, img_h=H, n_cams=2, stereo_pairs=(), max_kf=8,
               max_mp=2048, imu_freq=400.0, kf_max_interval_s=0.04,
               use_depth=True, depth_pin=(PIN, PIN), depth_cap=192,
               depth_max=25.0)
    cfg.update(kw)
    return cfg


# ---------------------------------------------------------------------------
# StreamingVITracker
# ---------------------------------------------------------------------------

def _streaming_trackers(cfg_kw, rig_np):
    from openmavis_tpu.frontend import extractor as jex
    from openmavis_tpu.optim.reprojection import RigParams as JRig
    from openmavis_tpu.pipeline import streaming_vi as jsv
    jt = jsv.StreamingVITracker(
        JRig(rig_np["kind"], *(jnp.asarray(rig_np[k])
                               for k in ("params", "R_cb", "t_cb"))),
        jsv.VIStreamConfig(orb=jex.OrbConfig(**ORB), **cfg_kw),
        jpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS), seed=0)
    tt = _port_streaming(cfg_kw, rig_np)
    return jt, tt


def _port_streaming(cfg_kw, rig_np):
    return tsv.StreamingVITracker(
        convert.rig_from_numpy(rig_np, device="cpu"),
        tsv.VIStreamConfig(orb=tex.OrbConfig(**ORB), **cfg_kw),
        tpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS, device="cpu"),
        seed=0, device="cpu")


def _streaming_run(cfg_kw, rig_np, frames, batches, depths):
    from openmavis_tpu.frontend import extractor as jex
    jt, tt = _streaming_trackers(cfg_kw, rig_np)
    cfg_j = jex.OrbConfig(**ORB)
    j_extract = jax.jit(lambda im: jex.extract_multicam(im, cfg_j))

    def shared_bank(images):
        fj = j_extract(jnp.asarray(images.numpy()))
        return tmt.concat_bands(
            tex.Features(*(torch.as_tensor(np.array(x)) for x in fj)))

    tt._step.extract_bank = shared_bank
    out = dict(jax=[], port=[], states=[])
    for i in range(len(frames)):
        t, b = batches[i]
        m_np, c_np = mono_t._state(jt)
        out["states"].append((m_np, c_np))
        tt.map = convert.map_from_numpy(m_np, device="cpu")
        tt.carry = convert.carry_from_numpy(c_np, device="cpu")
        tt._t_prev = batches[i - 1][0] if i else None
        tt.push(frames[i], t, b, depth=depths[i])
        jt.push(frames[i], t, b, depth=depths[i])
        out["port"].append(mono_t._record(tt.map, tt.carry, convert._np))
        out["jax"].append(mono_t._record(jt.map, jt.carry, np.asarray))
    return out


@pytest.fixture(scope="module")
def scene_pin():
    return _sequence()


@pytest.fixture(scope="module")
def streaming(tmp_path_factory, scene_pin):
    rig_np, frames, batches, depths = scene_pin
    kw = _config(ba_every_kf=False, obs_cap=4096)
    return ref_cache.shared(
        tmp_path_factory, "depth_pin_streaming",
        lambda: _streaming_run(kw, rig_np, frames, batches, depths))


def test_streaming_course(streaming):
    """Frame 0 initializes from depth alone, frame 1 inserts a keyframe
    that adds depth landmarks."""
    rec = streaming["jax"]
    assert all(int(r["mode"]) == OK for r in rec)
    assert int(rec[0]["n_kf"]) == 1 and int(rec[0]["n_mp"]) >= 50
    assert int(rec[-1]["n_kf"]) == N
    assert int(rec[-1]["n_mp"]) > int(rec[0]["n_mp"])


@pytest.mark.parametrize("key", mono_t.INTS)
def test_streaming_integers_equal(streaming, key):
    mono_t._integers_equal(streaming, key, None)


@pytest.mark.parametrize("key", mono_t.FLOATS)
def test_streaming_floats_close(streaming, key):
    mono_t._floats_close(streaming, key, None)


def test_streaming_pin_is_live(streaming, scene_pin):
    """Frame 0 from the same state without `depth_pin`: the depths are
    read as if the maps were the fisheye's own, and the landmarks land
    elsewhere."""
    rig_np, frames, batches, depths = scene_pin
    tt = _port_streaming(_config(ba_every_kf=False, obs_cap=4096,
                                 depth_pin=()), rig_np)
    m_np, c_np = streaming["states"][0]
    tt.map = convert.map_from_numpy(m_np, device="cpu")
    tt.carry = convert.carry_from_numpy(c_np, device="cpu")
    t, b = batches[0]
    tt.push(frames[0], t, b, depth=depths[0])
    ref = streaming["jax"][0]
    got = convert._np(tt.map.mp_pos)
    n_got, n_ref = int(tt.map.n_mp), int(ref["n_mp"])
    n = min(n_got, n_ref)
    assert n_got != n_ref or np.abs(got[:n] - ref["mp_pos"][:n]).max() > 0.05


# ---------------------------------------------------------------------------
# MultiTracker
# ---------------------------------------------------------------------------

def _multi_run(cfg_kw, rig_np, frames, batches, depths):
    jt, port = mt_t._trackers(cfg_kw, rig_np, orb=ORB)
    shared = {}
    tt = port()
    tt._ext = lambda images: shared["feats"]
    own_integrate = jpre.integrate
    out = dict(jax=[], port=[], states=[])
    try:
        # compiled, as tests/test_torch_multi_tracker.py runs it
        jpre.integrate = jax.jit(own_integrate)
        for i in range(len(frames)):
            t, b = batches[i]
            for s in b:
                jt.feed_imu(*s)
            d = mt_t._ref_state(jt)
            out["states"].append(d)
            img_j = jnp.asarray(frames[i].astype(np.float32))
            fj = jt._ext(img_j)
            if i == 0:
                out["feats0"] = [np.array(x) for x in fj]
            shared["feats"] = tex.Features(
                *(torch.as_tensor(np.array(x)) for x in fj))
            convert.multi_tracker_state_from_numpy(d, tt)
            ok = tt.process_frame(frames[i], t, depth=depths[i])
            out["port"].append(mt_t._record(
                convert.multi_tracker_state_to_numpy(tt), ok))
            ok = jt.process_frame(img_j, t, depth=jnp.asarray(depths[i]))
            out["jax"].append(mt_t._record(mt_t._ref_state(jt), ok))
    finally:
        jpre.integrate = own_integrate
    return out


def _multi_config(**kw):
    return _config(imu_init_kfs=3, ba_window=8, temporal_refs=2,
                   local_map_window=10, **kw)


@pytest.fixture(scope="module")
def multi(tmp_path_factory, scene_pin):
    rig_np, frames, batches, depths = scene_pin
    kw = _multi_config()
    return ref_cache.shared(
        tmp_path_factory, "depth_pin_multi",
        lambda: _multi_run(kw, rig_np, frames, batches, depths))


def test_multi_course(multi):
    rec = multi["jax"]
    assert all(bool(r["ok"]) for r in rec)
    assert int(rec[0]["n_kf"]) == 1 and int(rec[0]["n_mp"]) >= 50
    assert int(rec[-1]["n_kf"]) == N
    assert int(rec[-1]["n_mp"]) > int(rec[0]["n_mp"])


@pytest.mark.parametrize("key", mt_t.INTS)
def test_multi_integers_equal(multi, key):
    mt_t._integers_equal(multi, key)


@pytest.mark.parametrize("key", mt_t.FLOATS)
def test_multi_floats_close(multi, key):
    mt_t._floats_close(multi, key)


def test_multi_pin_is_live(multi, scene_pin):
    """Frame 0 (`_initialize_rig`'s `spawn_from_depth_multi`) from the
    same state and features without `depth_pin`: the landmarks land
    elsewhere than the reference's."""
    rig_np, frames, batches, depths = scene_pin
    tt = tmt.MultiTracker(
        convert.rig_from_numpy(rig_np, device="cpu"),
        tmt.MultiTrackerConfig(orb=tex.OrbConfig(**ORB),
                               **_multi_config(depth_pin=())),
        tpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS, device="cpu"),
        seed=0, device="cpu")
    feats = tex.Features(*(torch.as_tensor(x) for x in multi["feats0"]))
    tt._ext = lambda images: feats
    convert.multi_tracker_state_from_numpy(multi["states"][0], tt)
    tt.process_frame(frames[0], batches[0][0], depth=depths[0])
    got = convert.multi_tracker_state_to_numpy(tt)["map"]
    ref = multi["jax"][0]
    n_got, n_ref = int(got["n_mp"]), int(ref["n_mp"])
    n = min(n_got, n_ref)
    assert n_got != n_ref or np.abs(
        np.asarray(got["mp_pos"])[:n] - ref["mp_pos"][:n]).max() > 0.05
