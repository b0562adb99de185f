"""The streaming one-camera tracker `streaming.StreamingTracker` of the
port (its step `StreamStep`) against the JAX reference's `make_step` on
the CPU: one compile of the reference's step.

Scene: `tests/test_torch_tracker.py`'s (the reference e2e tests' BlobWorld
seed 3, 512 x 384 pinhole, 512 ORB features x 4 levels, the orbit at
1/116 of a turn a frame), with frame 1 black, so that the init reference
slides twice before a two-view attempt, and frames 13 and 14 black with
the camera standing still from frame 12 to 15, so that the tracker goes
LOST and relocalizes on frame 15. A 12-keyframe / 2,048-landmark slab and
a 64-entry trajectory ring.

Every frame of the port starts from the reference's map and carry of the
frame before (`convert.stream_carry_from_numpy`), is fed the reference's
own features (the port's `extractor.extract` replaced: descriptor bits on
pyramid levels >= 1 differ by float32 ties, ROADMAP Queue 3) and, where a
RANSAC runs, the reference's samples (`jax.random.categorical` from the
carry's key, handed over as `sample_idx`).

Tolerances: integers exact (the mode, `last_kf_slot`, `ref_kf_inliers`,
`lost_frames`, the keyframe and landmark counts, validity, bindings,
found / visible counters, the ring's keyframe references, flags and
index); poses, the motion model and ring entries 1e-3, landmarks 1e-3
relative (float32 solves summed in another order). The frame that
initializes is the exception `tests/test_torch_tracker.py` records for
the same two-view solve: the landmark list (its count within 4%) and the
poses within 5e-3, every other integer exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.frontend import matcher as jmatcher
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu.pipeline import streaming as jst
from openmavis_tpu.slam_map import map_state as jms
from openmavis_tpu_torch import convert
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.io import synthetic
from openmavis_tpu_torch.pipeline import loop_closing as tlc
from openmavis_tpu_torch.pipeline import streaming as tst
from openmavis_tpu_torch.pipeline import tracking as ttrk
from openmavis_tpu_torch.slam_map import map_state as tms


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are tiny: one intra-op thread is as fast as
    eight, and eight per test worker oversubscribe the machine when the
    files of the suite run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
ORB = dict(n_features=512, n_levels=4)
STEP = 0.25 / 29
N = 22
BLACK = (1, 13, 14)
STILL = (13, 14, 15)
NEED_REF, INIT, OK, LOST = tst.NEED_REF, tst.INIT, tst.OK, tst.LOST
INTS = ("mode", "last_kf_slot", "ref_kf_inliers", "lost_frames", "n_kf",
        "n_mp", "kf_valid", "kf_obs", "mp_valid", "mp_found", "mp_visible",
        "ref_valid", "traj_ref", "traj_ok", "traj_idx")
FLOATS = ("R", "t", "vel_R", "vel_t", "kf_R", "kf_t", "mp_pos", "ref_time",
          "traj_time", "traj_R_rel", "traj_t_rel")
LANDMARK_KEYS = ("n_mp", "kf_obs", "mp_valid", "mp_found", "mp_visible",
                 "ref_kf_inliers", "mp_pos")


def scene():
    u, us = 0.0, []
    for i in range(N):
        us.append(u)
        if i + 1 not in STILL:
            u += STEP
    R_wc, t_wc = (np.concatenate(x) for x in zip(*[
        synthetic.orbit_trajectory(1, 6.0, 0.0, start=s) for s in us]))
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    frames = synthetic.render_sequence(world, 0, PIN, R_wc, t_wc, W, H)
    frames = frames.astype(np.float32)
    frames[list(BLACK)] = 0
    return frames


def _cfg(mod, **kw):
    orb = (jex if mod is jst else tex).OrbConfig(**ORB)
    return mod.StreamConfig(img_w=W, img_h=H, orb=orb, max_kf=12,
                            max_mp=2048, traj_cap=64, **kw)


def _jrig():
    return JRig(0, jnp.asarray(PIN)[None], jnp.eye(3)[None],
                jnp.zeros((1, 3)))


def _trig():
    return convert.rig_from_numpy(dict(
        kind=0, params=PIN[None], R_cb=np.eye(3, dtype=np.float32)[None],
        t_cb=np.zeros((1, 3), np.float32)), device="cpu")


def _state(jt):
    """The reference tracker's map and carry as numpy dicts."""
    m = {k: np.asarray(v) for k, v in jt.map._asdict().items()}
    c = {k: ({kk: np.asarray(vv) for kk, vv in v._asdict().items()}
             if hasattr(v, "_asdict") else np.asarray(v))
         for k, v in jt.carry._asdict().items()}
    return m, c


def _record(m, c) -> dict:
    """What the tests compare, from numpy dicts of either package."""
    rec = {k: c[k] for k in ("mode", "last_kf_slot", "ref_kf_inliers",
                             "lost_frames", "R", "t", "vel_R", "vel_t",
                             "ref_time")}
    rec.update({k: m[k] for k in ("n_kf", "n_mp", "kf_valid", "kf_obs",
                                  "mp_valid", "mp_found", "mp_visible",
                                  "kf_R", "kf_t", "mp_pos")})
    rec["ref_valid"] = c["ref_feats"]["valid"]
    rec.update({"traj_" + k: v for k, v in c["traj"].items()})
    return rec


def _samples(m_np, c_np, fj, ft):
    """The reference's draws on this frame, or None: the two-view samples
    of an init attempt (the key split as `_do_init` splits it, then as
    `two_view.reconstruct` draws), or the PnP samples of a LOST frame (the
    key split as `branch_track` splits it, one subkey per candidate
    keyframe as `relocalize_step` splits it)."""
    mode = int(c_np["mode"])
    sub = jax.random.split(jnp.asarray(c_np["key"]))[1]
    if mode == INIT:
        f0 = c_np["ref_feats"]
        idx, _ = jmatcher.match_nn(
            fj.desc, fj.valid, jnp.asarray(f0["desc"]),
            jnp.asarray(f0["valid"]), max_dist=jmatcher.TH_LOW, ratio=0.9,
            mutual=True)
        matched = np.asarray(idx) >= 0
        if matched.sum() < 80:
            return None
        key_e, key_h = jax.random.split(sub)
        logits = jnp.where(jnp.asarray(matched), 0.0, -1e9)
        return tuple(torch.as_tensor(np.array(jax.random.categorical(
            k, logits[None, None, :], shape=(256, n))))
            for k, n in ((key_e, 8), (key_h, 4)))
    if mode != LOST:
        return None
    m = convert.map_from_numpy(m_np, device="cpu")
    _, cand = ttrk.relocalization_candidates(m, ft)
    out = []
    for kf, k in zip(cand.tolist(),
                     jax.random.split(sub, ttrk.N_RELOC_CAND)):
        _, _, valid = ttrk.relocalization_matches(m, ft, kf)
        logits = jnp.where(jnp.asarray(valid.numpy()), 0.0, -1e9)
        out.append(np.asarray(jax.random.categorical(
            k, logits[None, None, :], shape=(512, 6))))
    return torch.as_tensor(np.stack(out))


@pytest.fixture(scope="module")
def run():
    """Both trackers over the scene, the port's every step taken from the
    reference's state of the frame before, with the reference's features
    and draws. Returns dict(jax, port, states, samples, events, trackers,
    frames)."""
    frames = scene()
    jt = jst.StreamingTracker(_jrig(), _cfg(jst), seed=0)
    tt = tst.StreamingTracker(_trig(), _cfg(tst), seed=0, device="cpu")
    j_extract = jax.jit(lambda im: jex.extract(im, jex.OrbConfig(**ORB)))
    shared = {}
    own = tex.extract
    out = dict(jax=[], port=[], states=[], samples=[], events=[],
               frames=frames)
    try:
        tex.extract = lambda img, cfg: shared["feats"]
        for i in range(N):
            m_np, c_np = _state(jt)
            out["states"].append((m_np, c_np))
            fj = j_extract(jnp.asarray(frames[i]))
            shared["feats"] = ft = tex.Features(
                *(torch.as_tensor(np.array(x)) for x in fj))
            samples = _samples(m_np, c_np, fj, ft)
            out["samples"].append(
                None if samples is None else
                ("two_view" if isinstance(samples, tuple) else "reloc"))
            tt.map = convert.map_from_numpy(m_np, device="cpu")
            tt.carry = convert.stream_carry_from_numpy(c_np, device="cpu")
            tt.push(frames[i], i / 20.0, sample_idx=samples)
            out["events"].append(tt.step_events)
            out["port"].append(_record(
                convert.map_to_numpy(tt.map),
                convert.stream_carry_to_numpy(tt.carry)))
            jt.push(jnp.asarray(frames[i]), i / 20.0)
            out["jax"].append(_record(*_state(jt)))
    finally:
        tex.extract = own
    out["trackers"] = (jt, tt)
    return out


def _init_frame(run):
    return [int(r["mode"]) for r in run["jax"]].index(OK)


def test_course(run):
    """NEED_REF on frame 0; frame 1 (black) and frame 2 (against the black
    reference) slide the reference; an attempt initializes; OK with
    keyframes; LOST on the black frames 13 and 14; relocalized on 15."""
    modes = [int(r["mode"]) for r in run["jax"]]
    assert int(run["states"][0][1]["mode"]) == NEED_REF
    assert modes[:3] == [INIT, INIT, INIT]
    assert [float(r["ref_time"]) for r in run["jax"][:3]] == \
        pytest.approx([0.0, 0.05, 0.1])
    assert run["samples"][:3] == [None, None, None]
    i0 = _init_frame(run)
    assert run["samples"][i0] == "two_view"
    assert "init" in run["events"][i0]
    n_kf = [int(r["n_kf"]) for r in run["jax"]]
    assert n_kf[i0] == 2 and n_kf[12] > 3
    assert modes[12:16] == [OK, LOST, LOST, OK]
    assert [int(r["lost_frames"]) for r in run["jax"][12:16]] == [0, 1, 2, 0]
    assert run["samples"][14:16] == ["reloc", "reloc"]
    assert "reloc_ok" in run["events"][15]
    assert all(m == OK for m in modes[15:])
    keyframes = [i for i, e in enumerate(run["events"]) if "keyframe" in e]
    assert len(keyframes) >= 3


@pytest.mark.parametrize("key", INTS)
def test_integers_equal(run, key):
    i0 = _init_frame(run)
    for i, (a, b) in enumerate(zip(run["port"], run["jax"])):
        assert a[key].dtype == b[key].dtype, (key, a[key].dtype)
        if i == i0 and key in LANDMARK_KEYS:
            continue
        np.testing.assert_array_equal(a[key], b[key],
                                      err_msg=f"frame {i}: {key}")


@pytest.mark.parametrize("key", FLOATS)
def test_floats_close(run, key):
    i0 = _init_frame(run)
    rtol = 1e-3 if key == "mp_pos" else 0.0
    for i, (a, b) in enumerate(zip(run["port"], run["jax"])):
        if i != i0:
            np.testing.assert_allclose(a[key], b[key], atol=1e-3, rtol=rtol,
                                       err_msg=f"frame {i}: {key}")


def test_init_frame(run):
    """The frame that initializes: the landmark count within 4%, poses
    5e-3 (module docstring)."""
    i = _init_frame(run)
    a, b = run["port"][i], run["jax"][i]
    assert abs(int(a["n_mp"]) - int(b["n_mp"])) <= 0.04 * int(b["n_mp"])
    for key in ("kf_R", "kf_t", "R", "t"):
        np.testing.assert_allclose(a[key], b[key], atol=5e-3, rtol=0,
                                   err_msg=key)


def test_snapshot_and_trajectory(run):
    """`snapshot()` in one transfer, as its fields' own dtypes, and the
    trajectory replayed against the final keyframes, against the
    reference's on the same final state."""
    jt, tt = run["trackers"]
    m_np, c_np = _state(jt)
    tt.map = convert.map_from_numpy(m_np, device="cpu")
    tt.carry = convert.stream_carry_from_numpy(c_np, device="cpu")
    tt._snap = None
    s = tt.snapshot()
    assert s["ref"].dtype == np.int32 and s["ok"].dtype == np.bool_
    assert s["idx"].shape == () and int(s["idx"]) == N
    np.testing.assert_array_equal(s["ok"], c_np["traj"]["ok"])
    np.testing.assert_array_equal(s["kf_R"], m_np["kf_R"])
    assert int(s["n_kf"]) == tt.n_kf == jt.n_kf
    tj, Rj, pj = jt.get_trajectory()
    tp, Rp, pp = tt.get_trajectory()
    assert len(tp) == N
    np.testing.assert_allclose(tp, tj, rtol=0, atol=0)
    np.testing.assert_allclose(Rp, Rj, atol=1e-5, rtol=0)
    np.testing.assert_allclose(pp, pj, atol=1e-5, rtol=0)
    tt.block()


def test_record_ring_overflow():
    """The reference's `test_record_ring_overflow` configuration: a ring of
    4 takes 6 writes, `idx` counts on, and the last entry holds the final
    write (the index is clamped, not wrapped)."""
    cfg = _cfg(tst)
    c = tst.init_carry(64, 4, 0, device="cpu")
    m = tms.allocate(4, 64, 128, device="cpu")
    cj = jst.init_carry(64, 4, 0)
    mj = jms.allocate(4, 64, 128)
    for k in range(6):
        c = tst._record(m, c, torch.tensor(float(k)), torch.tensor(True))
        cj = jst._record(mj, cj, float(k), jnp.asarray(True))
    assert int(c.traj.idx) == 6 and float(c.traj.time[3]) == 5.0
    back = convert.stream_carry_to_numpy(c)
    for k, v in cj.traj._asdict().items():
        np.testing.assert_array_equal(back["traj"][k], np.asarray(v),
                                      err_msg=k)
        assert back["traj"][k].dtype == np.asarray(v).dtype, k
    assert cfg.traj_cap == 64


def test_entry_points_and_round_trip(monkeypatch, run):
    """The tracker and `init_carry` build on the current CUDA device unless
    told the CPU and raise without a card; `maybe_close_loop` without a
    loop closer, or before a second keyframe, does nothing; the carry
    round-trips through `convert` in INIT and LOST modes."""
    _, tt = run["trackers"]
    assert tt.maybe_close_loop() is False
    lc = tlc.LoopCloser(None, 8, rig=_trig(), device="cpu")
    fresh = tst.StreamingTracker(_trig(), _cfg(tst), loop_closer=lc,
                                 device="cpu")
    assert fresh.loop_closer is lc and fresh.maybe_close_loop() is False
    assert fresh._last_lc_slot == -1 and lc.n_loops == 0
    for i in (2, 14):
        _, c_np = run["states"][i]
        back = convert.stream_carry_to_numpy(
            convert.stream_carry_from_numpy(c_np, device="cpu"))
        for k in convert._STREAM_SCALARS:
            np.testing.assert_array_equal(back[k], c_np[k], err_msg=k)
            assert back[k].dtype == c_np[k].dtype, k
        for k, v in c_np["ref_feats"].items():
            np.testing.assert_array_equal(back["ref_feats"][k], v)
            assert back["ref_feats"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(back["key"], c_np["key"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.StreamingTracker(_trig(), _cfg(tst))
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.init_carry(64, 8)
