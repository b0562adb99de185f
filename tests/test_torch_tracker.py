"""The one-camera host-policy tracker `tracking.Tracker` of the port, and
the module-level steps it runs (`track_step`, `frame_step`,
`spawn_landmarks`, `bind_landmarks`), against the JAX reference on the
CPU.

Scene: the reference e2e tests' (`tests/test_tracking_e2e.py`): BlobWorld
seed 3, a pinhole at 512 x 384 (f = 380), 512 ORB features x 4 levels (at
256 the reference's own two-view attempts fail, ROADMAP Queue 3), the
camera on the 6 m orbit at the e2e test's 1/116 of a turn a frame.
Frames 12 and 13 are black, and the camera stands still from keyframe
frame 11 to frame 14, so that frame 14 relocalizes (the reference's
relocalization on this scene finds nothing once the camera has moved: the
blob descriptors are ambiguous, and its PnP gets 14-27 inliers of the 15
it needs). The slab holds 12 keyframes and 2,048 landmarks: it fills,
and a later keyframe recycles it.

Every frame of the port starts from the reference's state of the frame
before (`convert.tracker_state_from_numpy`), is fed the reference's own
features (the port tracker's `_ext` replaced: descriptor bits on pyramid
levels >= 1 differ by float32 ties, ROADMAP Queue 3) and, where a RANSAC
runs, the reference's samples (`jax.random.categorical` from its key,
handed over as `sample_idx`). The reference runs once per configuration,
in a module-scoped fixture.

Tolerances: integers exact (state, counters, keyframe and landmark
counts, validity, bindings, found / visible / last-seen counters, the
trajectory's keyframe references, the return value); poses, the motion
model and trajectory entries 1e-3, landmarks 1e-3 relative (float32
solves summed in another order; measured: landmarks within 5.7e-4
relative, poses within 3.3e-5). The frame that
initializes is the exception: its two-view solve, at ~200 matches, is the
unnormalized float32 8-point of the reference (ROADMAP Queue 3): from the
same samples 189 against 191 points pass its checks and the poses lie
8e-4 apart; there the discrete state is exact but for the landmark list
(its count within 4%) and the poses within 5e-3, and the next frame
starts from the reference's state again.

Named exception: a weakly held scale. After the second recycle (frame 41)
the window BA's two fixed keyframes lie 0.04 map units apart, a
twenty-fifth of the scene's depth, so the window's scale rests on little
parallax: from one pre-BA map the two packages' solves (chi2 129.57
against 129.64) put the free keyframes up to 5.5e-3 apart and landmarks
up to 2.1e-2. On that frame the integers are held as everywhere, the
keyframe poses within 1e-2 and the landmarks within 3e-2 (3% of the
scene's depth); the next frame starts from the reference's state again.

RGB-D (`process_frame(depth=)`): frame 0 initializes from depth, frame 8
is a depth keyframe, held as above but for the landmarks (3e-3 relative,
`test_rgbd_floats_close`). Frame 1 is the exception that
`tests/test_torch_mono.py` records for the streaming tracker: tracked from
keyframe 0's own pose, every visible landmark lies exactly at the
distance its scale range was set from, the two packages' float32 `log`
put the predicted level on either side of an integer, and 629 against 633
landmarks result; there the landmark list is held within 3% and the poses
within 1e-2 (measured 4.5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.frontend import matcher as jmatcher
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu.pipeline import tracking as jtrk
from openmavis_tpu_torch import convert
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.io import synthetic
from openmavis_tpu_torch.pipeline import loop_closing as tlc
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


W, H = 512, 384
PIN = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
ORB = dict(n_features=512, n_levels=4)
STEP = 0.25 / 29       # of a turn, a frame
N = 44
BLACK = (12, 13)
STILL = (12, 13, 14)    # frames at the pose of the frame before
MAX_KF = 12
NOT_INIT, OK, LOST = (ttrk.Tracker.NOT_INITIALIZED, ttrk.Tracker.OK,
                      ttrk.Tracker.LOST)
INTS = ("ok", "state", "n_kf", "n_mp", "kf_valid", "kf_obs", "mp_valid",
        "mp_found", "mp_visible", "mp_last_kf", "last_kf_slot",
        "ref_kf_inliers", "lost_frames", "init_valid", "traj_ref")
FLOATS = ("kf_R", "kf_t", "R", "t", "vel_R", "vel_t", "mp_pos", "traj_R",
          "traj_t")
# what the init frame's two-view solve may move (module docstring)
LANDMARK_KEYS = ("n_mp", "kf_obs", "mp_valid", "mp_found", "mp_visible",
                 "mp_last_kf", "mp_pos", "ref_kf_inliers")


def scene(n, black=(), still=(), depth=False):
    """Frames (float32 [n, H, W]) of the orbit, the camera standing still
    on the `still` frames, and the depth maps with `depth`."""
    u, us = 0.0, []
    for i in range(n):
        us.append(u)
        if i + 1 not in still:
            u += STEP
    R_wc, t_wc = (np.concatenate(x) for x in zip(*[
        synthetic.orbit_trajectory(1, 6.0, 0.0, start=s) for s in us]))
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    frames = synthetic.render_sequence(world, 0, PIN, R_wc, t_wc, W, H)
    frames = frames.astype(np.float32)
    frames[list(black)] = 0
    depths = (synthetic.render_depth_sequence(world, 0, PIN, R_wc, t_wc, W,
                                              H).astype(np.float32)
              if depth else None)
    return frames, depths


def _jrig():
    return JRig(0, jnp.asarray(PIN)[None], jnp.eye(3)[None],
                jnp.zeros((1, 3)))


def _trig():
    return convert.rig_from_numpy(dict(
        kind=0, params=PIN[None], R_cb=np.eye(3, dtype=np.float32)[None],
        t_cb=np.zeros((1, 3), np.float32)), device="cpu")


def _cfg(mod, **kw):
    return mod.TrackerConfig(img_w=W, img_h=H, max_kf=MAX_KF, max_mp=2048,
                             orb=(jex if mod is jtrk else tex).OrbConfig(
                                 **ORB), **kw)


def _np_tree(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _ref_state(jt) -> dict:
    """The reference tracker's attributes, laid out as
    `convert.tracker_state_to_numpy` lays out the port's."""
    d = {k: getattr(jt, k, None) for k in convert._TR_HOST}
    d.update({k: np.asarray(getattr(jt, k)) for k in convert._TR_TENSORS})
    d["map"] = _np_tree(jt.map)
    d["_init_feats"] = (None if jt._init_feats is None
                        else _np_tree(jt._init_feats))
    d["trajectory"] = list(jt.trajectory)
    d["key"] = np.asarray(jt.key)
    return d


def _record(d: dict, ok) -> dict:
    """What the tests compare, from a state dict of either package."""
    m = d["map"]
    rec = {k: np.asarray(d[k]) for k in
           ("state", "n_kf", "last_kf_slot", "ref_kf_inliers", "lost_frames",
            "R", "t", "vel_R", "vel_t")}
    rec.update({k: m[k] for k in
                ("n_mp", "kf_valid", "kf_obs", "mp_valid", "mp_found",
                 "mp_visible", "mp_last_kf", "kf_R", "kf_t", "mp_pos")})
    rec["ok"] = np.asarray(bool(ok))
    f0 = d["_init_feats"]
    rec["init_valid"] = (np.zeros(0, bool) if f0 is None
                         else np.asarray(f0["valid"]))
    traj = d["trajectory"]
    rec["traj_ref"] = np.array([(e[1], e[2]) for e in traj])
    rec["traj_R"] = np.stack([e[3] for e in traj])
    rec["traj_t"] = np.stack([e[4] for e in traj])
    return rec


def _two_view_samples(d, fj):
    """The reference's two-view draws on a frame that attempts the init,
    or None: the key split as `_try_initialize` splits it, then as
    `two_view.reconstruct` draws (`jax.random.categorical`)."""
    if d["state"] != NOT_INIT or d["_init_feats"] is None:
        return None
    f0 = d["_init_feats"]
    idx, _ = jmatcher.match_nn(fj.desc, fj.valid, jnp.asarray(f0["desc"]),
                               jnp.asarray(f0["valid"]),
                               max_dist=jmatcher.TH_LOW, ratio=0.9,
                               mutual=True)
    matched = np.asarray(idx) >= 0
    if matched.sum() < 80:
        return None
    sub = jax.random.split(jnp.asarray(d["key"]))[1]
    key_e, key_h = jax.random.split(sub)
    logits = jnp.where(jnp.asarray(matched), 0.0, -1e9)
    return tuple(torch.as_tensor(np.array(jax.random.categorical(
        k, logits[None, None, :], shape=(256, n))))
        for k, n in ((key_e, 8), (key_h, 4)))


def _reloc_samples(d, feats_t):
    """The reference's PnP draws on a LOST frame: the key split as
    `process_frame` splits it, one subkey per candidate keyframe as
    `relocalize_step` splits it, `ransac_pnp`'s 512 x 6 categorical over
    each candidate's valid matches."""
    if d["state"] != LOST:
        return None
    m = convert.map_from_numpy(d["map"], device="cpu")
    _, cand = ttrk.relocalization_candidates(m, feats_t)
    keys = jax.random.split(jax.random.split(jnp.asarray(d["key"]))[1],
                            ttrk.N_RELOC_CAND)
    out = []
    for kf, k in zip(cand.tolist(), keys):
        _, _, valid = ttrk.relocalization_matches(m, feats_t, kf)
        logits = jnp.where(jnp.asarray(valid.numpy()), 0.0, -1e9)
        out.append(np.asarray(jax.random.categorical(
            k, logits[None, None, :], shape=(512, 6))))
    return torch.as_tensor(np.stack(out))


def _run(frames, depths=None, fused_frames=()):
    """Both trackers over the frames, the port stepped from the
    reference's state each frame with the reference's features and draws.
    On `fused_frames` a second port tracker (`fused_frontend=True`, its
    extraction handed the same features) steps from the same states.
    Returns dict(jax, port, fused, states, events, trackers)."""
    jt = jtrk.Tracker(_jrig(), _cfg(jtrk), seed=0)
    tt = ttrk.Tracker(_trig(), _cfg(ttrk), seed=0, device="cpu")
    tf = ttrk.Tracker(_trig(), _cfg(ttrk, fused_frontend=True), seed=0,
                      device="cpu")
    shared = {}
    tt._ext = tf._ext = lambda img: shared["feats"]
    own_extract = tex.extract
    out = dict(jax=[], port=[], fused={}, states=[], events=[],
               frames=frames, depths=depths)
    try:
        # the fused route extracts inside `frame_step`
        tex.extract = lambda img, cfg: shared["feats"]
        for i in range(len(frames)):
            d = _ref_state(jt)
            out["states"].append(d)
            img_j = jnp.asarray(frames[i])
            fj = jt._ext(img_j)
            shared["feats"] = tex.Features(
                *(torch.as_tensor(np.array(x)) for x in fj))
            samples = _two_view_samples(d, fj)
            if samples is None:
                samples = _reloc_samples(d, shared["feats"])
            out["events"].append(
                None if samples is None else
                ("two_view" if isinstance(samples, tuple) else "reloc"))
            dep = None if depths is None else depths[i]
            runs = [("port", tt)] + ([("fused", tf)] if i in fused_frames
                                     else [])
            for name, p in runs:
                convert.tracker_state_from_numpy(d, p)
                ok = p.process_frame(frames[i], i / 20.0, depth=dep,
                                     sample_idx=samples)
                rec = _record(convert.tracker_state_to_numpy(p), ok)
                if name == "port":
                    out["port"].append(rec)
                else:
                    out["fused"][i] = rec
            ok = jt.process_frame(img_j, i / 20.0,
                                  depth=None if dep is None
                                  else jnp.asarray(dep))
            out["jax"].append(_record(_ref_state(jt), ok))
    finally:
        tex.extract = own_extract
    out["trackers"] = (jt, tt)
    return out


def _init_frame(run):
    return [bool(r["ok"]) for r in run["jax"]].index(True)


def _integers_equal(run, key, bounded=()):
    for i, (a, b) in enumerate(zip(run["port"], run["jax"])):
        if i in bounded and key in LANDMARK_KEYS:
            continue
        np.testing.assert_array_equal(a[key], b[key],
                                      err_msg=f"frame {i}: {key}")


def _floats_close(run, key, bounded=(), weak=(), mp_rtol=1e-3):
    """1e-3 (landmarks `mp_rtol` relative); on the `weak` frames keyframe
    poses 1e-2 and landmarks 3e-2 (the module docstring's weakly held
    scale)."""
    rtol = mp_rtol if key == "mp_pos" else 0.0
    for i, (a, b) in enumerate(zip(run["port"], run["jax"])):
        if i in bounded:
            continue
        atol = 1e-3
        if i in weak and key in ("kf_R", "kf_t", "mp_pos", "R", "t",
                                 "traj_R", "traj_t"):
            atol = 3e-2 if key == "mp_pos" else 1e-2
        assert a[key].shape == b[key].shape, (i, key)
        np.testing.assert_allclose(a[key], b[key], atol=atol, rtol=rtol,
                                   err_msg=f"frame {i}: {key}")


def _bounded_frame(run, i, n_mp_rel, pose_atol):
    a, b = run["port"][i], run["jax"][i]
    assert abs(int(a["n_mp"]) - int(b["n_mp"])) <= n_mp_rel * int(b["n_mp"])
    for key in ("kf_R", "kf_t", "R", "t"):
        np.testing.assert_allclose(a[key], b[key], atol=pose_atol, rtol=0,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# the monocular run
# ---------------------------------------------------------------------------

FUSED = tuple(range(3, 12))


@pytest.fixture(scope="module")
def mono():
    frames, _ = scene(N, BLACK, STILL)
    return _run(frames, fused_frames=FUSED)


def test_mono_course(mono):
    """Frame 0 becomes the two-view reference, frame 1 initializes (two
    keyframes), keyframes follow; the black frames go LOST (the second
    one's relocalization finds nothing), frame 14 relocalizes and tracks;
    the slab fills and a later keyframe recycles it."""
    rec = mono["jax"]
    i0 = _init_frame(mono)
    assert i0 == 1 and int(rec[i0]["n_kf"]) == 2
    assert mono["events"][i0] == "two_view"
    assert int(rec[11]["n_kf"]) > mono["states"][11]["n_kf"]
    assert [int(r["state"]) for r in rec[11:15]] == [OK, LOST, LOST, OK]
    assert [bool(r["ok"]) for r in rec[11:15]] == [True, False, False, True]
    # the count grows on a failed relocalization, not on the failed track
    assert [int(r["lost_frames"]) for r in rec[11:15]] == [0, 0, 1, 0]
    assert mono["events"][13:15] == ["reloc", "reloc"]
    n_kf = [int(r["n_kf"]) for r in rec]
    full = n_kf.index(MAX_KF)
    assert full < N - 2 and n_kf[-1] == MAX_KF
    # the recycle: a full slab, a keyframe wanted, slots compacted, the
    # new keyframe in the freed slot
    recycled = [i for i in range(full + 1, N)
                if int(rec[i]["n_mp"]) < int(rec[i - 1]["n_mp"])]
    assert recycled, n_kf
    assert all(bool(r["ok"]) for r in rec[14:])


@pytest.mark.parametrize("key", INTS)
def test_mono_integers_equal(mono, key):
    _integers_equal(mono, key, (_init_frame(mono),))


WEAK = (41,)


@pytest.mark.parametrize("key", FLOATS)
def test_mono_floats_close(mono, key):
    _floats_close(mono, key, (_init_frame(mono),), WEAK)


def test_mono_weak_scale_frame(mono):
    """The named exception (module docstring): frame 41 recycles the slab,
    and its window BA (slots 4-11) holds slots 4 and 5 fixed, 0.04 map
    units apart, where the landmarks lie over 0.5 units away."""
    i, = WEAK
    after = mono["jax"][i]
    assert int(after["n_mp"]) < int(mono["jax"][i - 2]["n_mp"])
    kf_t = after["kf_t"]
    assert np.linalg.norm(kf_t[4] - kf_t[5]) < 0.05
    assert np.median(np.linalg.norm(after["mp_pos"][after["mp_valid"]]
                                    - kf_t[11], axis=1)) > 0.5


def test_mono_init_frame(mono):
    """The frame that initializes (module docstring): the landmark count
    within 4%, poses 5e-3, every other integer exact."""
    _bounded_frame(mono, _init_frame(mono), 0.04, 5e-3)


@pytest.mark.parametrize("key", INTS + FLOATS)
def test_fused_frontend_equals_unfused(mono, key):
    """`fused_frontend=True` runs extraction and tracking as `frame_step`:
    from the same state and features, the same state as the unfused
    route, exactly (frames 3-11: tracking and keyframes)."""
    for i, rec in mono["fused"].items():
        np.testing.assert_array_equal(rec[key], mono["port"][i][key],
                                      err_msg=f"frame {i}: {key}")
    assert sorted(mono["fused"]) == list(FUSED)


def test_localization_only_adds_no_keyframe(mono):
    """With `localization_only` the tracker tracks and never inserts a
    keyframe (the reference's ActivateLocalizationMode): frame 7 inserts
    one in the normal run."""
    i = 7
    assert int(mono["jax"][i]["n_kf"]) > mono["states"][i]["n_kf"]
    _, tt = mono["trackers"]
    d = mono["states"][i]
    convert.tracker_state_from_numpy(d, tt)
    feats = tex.extract(torch.as_tensor(mono["frames"][i]), tt.cfg.orb)
    tt._ext = lambda img: feats
    tt.localization_only = True
    try:
        assert tt.process_frame(mono["frames"][i], i / 20.0)
        assert tt.n_kf == d["n_kf"] and tt.state == OK
        assert int(tt.map.n_kf) == d["n_kf"]
    finally:
        tt.localization_only = False


# ---------------------------------------------------------------------------
# the module-level steps on the same numpy map
# ---------------------------------------------------------------------------

def _maps(d):
    m_np = d["map"]
    return ({k: jnp.asarray(v) for k, v in m_np.items()},
            convert.map_from_numpy(m_np, device="cpu"))


def _jmap(m_j):
    from openmavis_tpu.slam_map import map_state as jms
    return jms.MapState(**m_j)


def test_track_step(mono):
    """`track_step` from the reference's prediction on a tracked frame:
    feat_mp, n_in, vis, keep exact, the pose 1e-3."""
    i = 20
    d = mono["states"][i]
    m_j, m_t = _maps(d)
    fj = mono["trackers"][0]._ext(jnp.asarray(mono["frames"][i]))
    ft = tex.Features(*(torch.as_tensor(np.array(x)) for x in fj))
    R_pred = d["R"] @ d["vel_R"]
    t_pred = d["t"] + d["R"] @ d["vel_t"]
    oj = jtrk.track_step(_jmap(m_j), fj, jnp.asarray(R_pred),
                         jnp.asarray(t_pred), 0, _jrig(), float(W), float(H),
                         15.0, 3)
    ot = ttrk.track_step(m_t, ft, torch.as_tensor(R_pred),
                         torch.as_tensor(t_pred), 0, _trig(), float(W),
                         float(H), 15.0, 3)
    for a, b, name in zip(ot, oj, ("R", "t", "feat_mp", "n_in", "vis",
                                   "keep")):
        if name in ("R", "t"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                       rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    assert int(ot[3]) >= 40 and int(ot[4].sum()) > int(ot[3])


@pytest.mark.parametrize("with_dist", [False, True])
def test_frame_step(mono, with_dist):
    """`frame_step` (extraction, optional radtan undistortion, then
    `track_step`), both packages' extraction handed the same raw
    features: the same outputs as `track_step` on those features
    undistorted, against the reference's `frame_step` (integers exact,
    the pose 1e-3)."""
    i = 20
    d = mono["states"][i]
    m_j, m_t = _maps(d)
    fj = mono["trackers"][0]._ext(jnp.asarray(mono["frames"][i]))
    ft = tex.Features(*(torch.as_tensor(np.array(x)) for x in fj))
    dist = (np.array([-0.02, 0.004, 1e-4, -1e-4], np.float32) if with_dist
            else None)
    R_pred = d["R"] @ d["vel_R"]
    t_pred = d["t"] + d["R"] @ d["vel_t"]
    own_j, own_t = jex.extract, tex.extract
    try:
        jex.extract = lambda img, cfg: fj
        tex.extract = lambda img, cfg: ft
        oj = jtrk.frame_step(
            _jmap(m_j), jnp.zeros((H, W)), jnp.asarray(R_pred),
            jnp.asarray(t_pred), 0, _jrig(), jex.OrbConfig(**ORB), float(W),
            float(H), 15.0, -1, None if dist is None else jnp.asarray(dist))
        ot = ttrk.frame_step(
            m_t, torch.zeros((H, W)), torch.as_tensor(R_pred),
            torch.as_tensor(t_pred), 0, _trig(), tex.OrbConfig(**ORB),
            float(W), float(H), 15.0, -1,
            None if dist is None else torch.as_tensor(dist))
    finally:
        jex.extract, tex.extract = own_j, own_t
    for a, b, name in zip(ot[:6], oj[:6], ("R", "t", "feat_mp", "n_in",
                                           "vis", "keep")):
        if name in ("R", "t"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                       rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    np.testing.assert_allclose(ot[6].xy.numpy(), np.asarray(oj[6].xy),
                               atol=1e-3, rtol=0)
    moved = np.abs(ot[6].xy.numpy() - ft.xy.numpy()).max()
    assert (moved > 0.5) == with_dist
    same = ttrk.track_step(m_t, ot[6], torch.as_tensor(R_pred),
                           torch.as_tensor(t_pred), 0, _trig(), float(W),
                           float(H), 15.0, -1)
    for a, b in zip(same, ot[:6]):
        assert torch.equal(a, b)


def _inserted(mono, i):
    """The reference's map on frame `i` with the frame's keyframe inserted
    (its state before the mapper chain), the slot, and the rig pair."""
    from openmavis_tpu.slam_map import map_state as jms
    d = mono["states"][i]
    jt, _ = mono["trackers"]
    fj = mono["trackers"][0]._ext(jnp.asarray(mono["frames"][i]))
    m_j = _jmap(_maps(d)[0])
    R_pred = jnp.asarray(d["R"] @ d["vel_R"])
    t_pred = jnp.asarray(d["t"] + d["R"] @ d["vel_t"])
    R, t, feat_mp, _, _, _ = jtrk.track_step(m_j, fj, R_pred, t_pred, 0,
                                             _jrig(), float(W), float(H),
                                             15.0)
    slot = d["n_kf"]
    z3 = jnp.zeros(3)
    m_j = jms.insert_keyframe(
        m_j, slot, R, t, z3, z3, z3, i / 20.0, fj.xy, fj.desc, fj.level,
        fj.sigma2, jnp.zeros((ORB["n_features"],), jnp.int32), fj.valid,
        feat_mp)
    return {k: np.asarray(v) for k, v in m_j._asdict().items()}, slot


def _keyframe_frames(mono):
    """Tracked frames that inserted a keyframe, before the slab is full."""
    rec = mono["jax"]
    return [i for i in range(_init_frame(mono) + 1, N)
            if rec[i]["ok"] and int(rec[i]["n_kf"]) > mono["states"][i]["n_kf"]
            and mono["states"][i]["n_kf"] < MAX_KF]


def _maps_equal(mt_, mj_, ints, floats=("mp_pos",)):
    for k in ints:
        np.testing.assert_array_equal(convert._np(getattr(mt_, k)),
                                      np.asarray(getattr(mj_, k)),
                                      err_msg=k)
    for k in floats:
        np.testing.assert_allclose(convert._np(getattr(mt_, k)),
                                   np.asarray(getattr(mj_, k)), atol=1e-3,
                                   rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("which", ["first", "later"])
def test_spawn_and_bind(mono, which):
    """`spawn_landmarks` (4 references: at the first keyframe after the
    init, slot 2, two of them negative and clamped to slot 0 under
    `ref_ok`) and then `bind_landmarks` on the spawned map, against the
    reference on the same numpy maps: n_mp, kf_obs, mp_valid, mp_found,
    mp_last_kf, mp_first_kf exact, positions and geometry 1e-3."""
    from openmavis_tpu.slam_map import map_state as jms
    frames = _keyframe_frames(mono)
    i = frames[0] if which == "first" else frames[3]
    m_np, slot = _inserted(mono, i)
    if which == "first":
        assert slot == 2
    refs = [slot - 1 - j for j in range(4)]
    mj, nj = jtrk.spawn_landmarks(
        jms.MapState(**{k: jnp.asarray(v) for k, v in m_np.items()}),
        jnp.asarray(slot), jnp.asarray(refs, jnp.int32), 0, _jrig(), 256)
    mt_, nt = ttrk.spawn_landmarks(convert.map_from_numpy(m_np,
                                                          device="cpu"),
                                   slot, refs, 0, _trig(), 256)
    assert int(nt) == int(nj) > 0
    ints = ("n_mp", "kf_obs", "mp_valid", "mp_found", "mp_first_kf",
            "mp_last_kf")
    _maps_equal(mt_, mj, ints)
    # a scale range is an observer's distance times 1.2^level: it carries
    # the position's float32 error along the ray (1.5e-3 relative on a
    # point of two keyframes 0.04 apart)
    for k in ("mp_normal", "mp_dmin", "mp_dmax"):
        np.testing.assert_allclose(convert._np(getattr(mt_, k)),
                                   np.asarray(getattr(mj, k)), atol=1e-3,
                                   rtol=5e-3, err_msg=k)
    # bind on the reference's spawned map
    m2 = {k: np.asarray(v) for k, v in mj._asdict().items()}
    bj = jtrk.bind_landmarks(
        jms.MapState(**{k: jnp.asarray(v) for k, v in m2.items()}),
        jnp.asarray(slot), 0, _jrig(), float(W), float(H))
    bt = ttrk.bind_landmarks(convert.map_from_numpy(m2, device="cpu"), slot,
                             0, _trig(), float(W), float(H))
    _maps_equal(bt, bj, ("kf_obs", "mp_found", "mp_last_kf"), ())
    bound_before = (m2["kf_obs"][slot] >= 0).sum()
    assert int((bt.kf_obs[slot] >= 0).sum()) > bound_before


# ---------------------------------------------------------------------------
# RGB-D
# ---------------------------------------------------------------------------

N_D = 9


@pytest.fixture(scope="module")
def rgbd():
    frames, depths = scene(N_D, depth=True)
    return _run(frames, depths)


def test_rgbd_course(rgbd):
    """Frame 0 initializes from depth alone; a later keyframe spawns depth
    landmarks before it triangulates."""
    rec = rgbd["jax"]
    assert bool(rec[0]["ok"]) and int(rec[0]["n_kf"]) == 1
    assert int(rec[0]["n_mp"]) >= 80
    assert all(bool(r["ok"]) for r in rec)
    assert int(rec[-1]["n_kf"]) >= 2


@pytest.mark.parametrize("key", INTS)
def test_rgbd_integers_equal(rgbd, key):
    _integers_equal(rgbd, key, (1,))


@pytest.mark.parametrize("key", FLOATS)
def test_rgbd_floats_close(rgbd, key):
    """Landmarks 3e-3 relative: before slot 8 the window BA of a
    one-camera map holds slot 0 twice and leaves the scale free (ROADMAP
    Queue 3); at metric depths to 15 m the depth keyframe's BA (frame 8)
    moves one landmark of 893 by 1.3e-2 (2.7e-3 relative) between the
    packages, and its poses by 5.5e-4."""
    _floats_close(rgbd, key, (1,), mp_rtol=3e-3)


def test_rgbd_first_tracked_frame(rgbd):
    """Frame 1, tracked from keyframe 0's own pose (module docstring): the
    predicted levels of the visible landmarks lie at an integer in the
    reference's formula; the landmark count within 3%, poses 1e-2."""
    _bounded_frame(rgbd, 1, 0.03, 1e-2)
    d = rgbd["states"][1]
    m = convert.map_from_numpy(d["map"], device="cpu")
    rig = _trig()
    _, lvl, vis, dist = ttrk.project_landmarks(
        m, torch.eye(3), torch.zeros(3), rig.kind, rig.params[0],
        rig.R_cb[0], rig.t_cb[0], float(W), float(H))
    x = torch.log(m.mp_dmax / dist) / np.log(1.2)
    at_tie = vis & ((x - torch.round(x)).abs() < 1e-5)
    assert int(at_tie.sum()) == int(vis.sum()) > 100
    assert int(rgbd["jax"][8]["n_kf"]) == 3 > rgbd["states"][8]["n_kf"]


# ---------------------------------------------------------------------------
# entry points and state transfer
# ---------------------------------------------------------------------------

def test_entry_points(monkeypatch, mono):
    """The tracker builds on the current CUDA device unless told the CPU,
    and raises without a card; an atlas (ROADMAP item 6) is taken: the
    tracker allocates map 0 there on its own device and tracks into it; a
    loop closer is taken."""
    rig, cfg = _trig(), _cfg(ttrk)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrk.Tracker(rig, cfg)
    atlas = tatlas.Atlas()
    at = ttrk.Tracker(rig, cfg, atlas=atlas, device="cpu")
    assert at.atlas is atlas and atlas.n_maps() == 1 and at.map_id == 0
    assert atlas.device == torch.device("cpu") and at.map is atlas.maps[0]
    assert at.map.kf_obs.shape == (cfg.max_kf, cfg.orb.n_features)
    lc = tlc.LoopCloser(None, cfg.max_kf, rig=rig, device="cpu")
    assert ttrk.Tracker(rig, cfg, loop_closer=lc,
                        device="cpu").loop_closer is lc
    assert ttrk.TrackerConfig().max_mp == 8192
    assert ttrk.TrackerConfig().max_kf == 64


def test_state_round_trip(mono):
    """A reference state carried into the port and back: the same values
    in the port's dtypes, `_init_feats` and the trajectory included."""
    _, tt = mono["trackers"]
    for d in (mono["states"][1], mono["states"][N - 1]):
        convert.tracker_state_from_numpy(d, tt)
        back = convert.tracker_state_to_numpy(tt)
        for k in convert._TR_HOST:
            assert back[k] == d[k], k
        for k in convert._TR_TENSORS:
            np.testing.assert_array_equal(back[k], d[k], err_msg=k)
        for k, v in d["map"].items():
            np.testing.assert_array_equal(back["map"][k], v, err_msg=k)
            assert back["map"][k].dtype == v.dtype, k
        assert (back["_init_feats"] is None) == (d["_init_feats"] is None)
        if d["_init_feats"] is not None:
            for k, v in d["_init_feats"].items():
                np.testing.assert_array_equal(back["_init_feats"][k], v)
                assert back["_init_feats"][k].dtype == v.dtype, k
        for a, b in zip(back["trajectory"], d["trajectory"]):
            assert a[:3] == b[:3]
            np.testing.assert_array_equal(a[3], b[3])
        np.testing.assert_array_equal(back["key"], d["key"])
