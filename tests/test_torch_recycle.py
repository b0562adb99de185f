"""Slab recycling of the port against the JAX reference on the CPU, and
the LOST branch of the step (the two share one run of both trackers).

* `compact_keyframes`, `compact_landmarks`, `decimate_keyframes` on
  numpy-built maps (holes at the front, the back and the middle, a loop
  edge with a culled endpoint, no valid keyframe, all valid): every output
  array exactly equal, dtypes included.
* `recycle_map_slots` (the host-side form, numpy trajectory list):
  integers exact, relative poses 1e-6.
* The whole step: both `StreamingVITracker`s on the flagship rig cut to
  320x240, 128 features x 3 levels, a 12-keyframe / 2,048-landmark slab
  and a keyframe on every tracked frame, for 18 frames of which frames 8
  and 9 are black, the port fed the reference's features.
  - The LOST branch: LOST on both black frames, `relocalize_step` on the
    second and on the frame after, recovery there, five boosted frames
    counting down. `mode`, `lost_frames`, `boost` and the keyframe count
    per frame exact between a free-running port and the reference; with
    the three frames stepped from the reference's state, the pose after
    recovery within 1e-2 m (the RANSAC draws differ by construction).
  - Recycling: with 12 slots, inertial culling never fires (it needs more
    than 21 keyframes in the map) and the decimation frees one slot (slot
    3; a slab of 8 would free none: all of its slots are "recent"), so
    frames 14-17 each recycle through `decimate_keyframes`, both
    compactions and `weld_chain`. A keyframe on every frame amplifies
    float32 rounding (a stereo point 15 m out moves by a centimetre
    between the packages), and a free-running port parts from the
    reference in a few bindings by frame 3. Each recycling frame is
    therefore stepped in the port from the reference's own state of the
    frame before (`convert`): integers exact, keyframe poses, chain
    entries and the world trajectory 1e-3 (float32 solves summed in
    another order). The free-running port is held to the same keyframe
    counts and recycle frames.
* One deliberate difference: a trajectory entry whose reference keyframe
  is dropped keeps its world pose in the port (its relative pose is
  re-based, as the host-side `recycle_map_slots` does); the reference's
  device recycle remaps the slot only, which moves that frame. Held here
  on both sides.
* `weld_chain` alone against `compose(rebias(...))` written out slot by
  slot; `snapshot()["obs_dropped"]`; the `convert` round trip of a
  recycled map and carry.
* `StreamingVITracker.run_global_ba()` from the reference's final state:
  map integers exact, keyframe poses and the live pose 1e-3, chi2 1e-3
  relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.imu import preintegration as jpre
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu.pipeline import streaming_vi as jsv
from openmavis_tpu.pipeline import tracking as jtrk
from openmavis_tpu.slam_map import map_state as jms
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.imu import preintegration as tpre
from openmavis_tpu_torch.pipeline import multi_tracking as tmt
from openmavis_tpu_torch.pipeline import streaming_vi as tsv
from openmavis_tpu_torch.pipeline import tracking as ttrk
from openmavis_tpu_torch.pipeline.streaming import LOST, OK
from openmavis_tpu_torch.slam_map import map_state as tms
import test_torch_ref_cache as ref_cache

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are tiny: one intra-op thread is as fast as
    eight, and eight per test worker oversubscribe the machine when the
    files of the suite run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K, F, M = 10, 6, 24


def _numpy_map(seed, kf_valid, mp_valid, loops=()):
    """A map of K keyframes x F features and M landmarks with random
    content, the given validity masks and loop edges (i, j, valid)."""
    rng = np.random.default_rng(seed)
    d = {k: np.array(v) for k, v in
         convert.map_to_numpy(tms.allocate(K, F, M, device="cpu")).items()}
    for name, v in d.items():
        if v.dtype == np.float32:
            d[name] = rng.normal(size=v.shape).astype(np.float32)
    d["kf_desc"] = (rng.random((K, F, 256)) > 0.5).astype(np.int8)
    d["mp_desc"] = (rng.random((M, 256)) > 0.5).astype(np.int8)
    d["kf_bow"] = rng.integers(0, 5, d["kf_bow"].shape).astype(np.int8)
    d["kf_level"] = rng.integers(0, 8, (K, F)).astype(np.int32)
    d["kf_cam"] = rng.integers(0, 4, (K, F)).astype(np.int32)
    d["kf_feat_valid"] = rng.random((K, F)) < 0.8
    d["kf_obs"] = np.where(rng.random((K, F)) < 0.7,
                           rng.integers(0, M, (K, F)), -1).astype(np.int32)
    d["kf_valid"] = np.asarray(kf_valid, bool)
    d["mp_valid"] = np.asarray(mp_valid, bool)
    for name in ("mp_visible", "mp_found"):
        d[name] = rng.integers(0, 30, M).astype(np.int32)
    for name in ("mp_first_kf", "mp_last_kf"):
        d[name] = rng.integers(0, K, M).astype(np.int32)
    for n, (i, j, v) in enumerate(loops):
        d["loop_i"][n], d["loop_j"][n], d["loop_valid"][n] = i, j, v
    d["n_kf"] = np.int32(K)
    d["n_mp"] = np.int32(M)
    d["n_loop"] = np.int32(len(loops))
    return d


def _masks(name):
    rng = np.random.default_rng(11)
    holes = dict(
        front=[0, 1], back=[K - 2, K - 1], middle=[3, 4, 6],
        none_valid=list(range(K)), all_valid=[])[name]
    kf = np.ones(K, bool)
    kf[holes] = False
    mp = rng.random(M) < 0.6
    if name == "none_valid":
        mp[:] = False
    if name == "all_valid":
        mp[:] = True
    return kf, mp


# a loop edge between survivors, one with a culled endpoint (slot 4 in
# "middle"), one invalid, one with a free endpoint
LOOPS = ((2, 8, True), (4, 9, True), (1, 7, False), (-1, 5, True))
CASES = ["front", "back", "middle", "none_valid", "all_valid"]


def _both(d):
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    return jm, convert.map_from_numpy(d, device="cpu")


def _assert_same(got, ref, what):
    g, r = convert._np(got), np.asarray(ref)
    assert g.dtype == r.dtype, (what, g.dtype, r.dtype)
    np.testing.assert_array_equal(g, r, err_msg=what)


def _assert_maps_same(tm, jm, what):
    for name in jm._fields:
        _assert_same(getattr(tm, name), getattr(jm, name), f"{what}.{name}")


@pytest.mark.parametrize("case", CASES)
def test_compact_keyframes(case):
    kf, mp = _masks(case)
    jm, tm = _both(_numpy_map(1, kf, mp, LOOPS))
    jm2, j_oon, j_noo = jax.jit(jms.compact_keyframes)(jm)
    tm2, t_oon, t_noo = tms.compact_keyframes(tm)
    _assert_maps_same(tm2, jm2, case)
    _assert_same(t_oon, j_oon, "old_of_new")
    _assert_same(t_noo, j_noo, "new_of_old")


@pytest.mark.parametrize("case", CASES)
def test_compact_landmarks(case):
    kf, mp = _masks(case)
    jm, tm = _both(_numpy_map(2, kf, mp, LOOPS))
    jm2, jn = jax.jit(jms.compact_landmarks)(jm)
    tm2, tn = tms.compact_landmarks(tm)
    _assert_maps_same(tm2, jm2, case)
    _assert_same(tn, jn, "n_valid")


@pytest.mark.parametrize("current_slot", [K - 1, 5])
@pytest.mark.parametrize("case", CASES)
def test_decimate_keyframes(case, current_slot):
    kf, mp = _masks(case)
    # keep_recent=3 leaves an old half to decimate in a 10-slot slab: slot
    # 3 goes (slot 1 is one of the first two), unless a loop edge holds it
    for loops, dropped in ((LOOPS, [3]), (((3, 8, True),), [])):
        jm, tm = _both(_numpy_map(3, kf, mp, loops))
        jm2, jdrop = jms.decimate_keyframes(jm, current_slot, keep_recent=3)
        tm2, tdrop = tms.decimate_keyframes(tm, current_slot, keep_recent=3)
        _assert_maps_same(tm2, jm2, case)
        _assert_same(tdrop, jdrop, "drop")
        if case == "all_valid" and current_slot == K - 1:
            assert np.flatnonzero(convert._np(tdrop)).tolist() == dropped


@pytest.mark.parametrize("case", CASES)
def test_recycle_map_slots(case):
    kf, mp = _masks(case)
    d = _numpy_map(4, kf, mp, LOOPS)
    # proper rotations, so that re-based poses are well conditioned
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(K, 3, 3)))
    d["kf_R"] = q.astype(np.float32)
    jm, tm = _both(d)
    traj = [(0.05 * i, i % 2, int(rng.integers(0, K)),
             np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32),
             rng.normal(size=3).astype(np.float32)) for i in range(12)]
    jm2, jtraj, j_oon, j_noo, jn = jtrk.recycle_map_slots(jm, traj, 0)
    tm2, ttraj, t_oon, t_noo, tn = ttrk.recycle_map_slots(tm, traj, 0)
    _assert_maps_same(tm2, jm2, case)
    np.testing.assert_array_equal(t_oon, j_oon)
    np.testing.assert_array_equal(t_noo, j_noo)
    assert tn == jn and isinstance(tn, int)
    for a, b in zip(ttraj, jtraj):
        assert a[:3] == b[:3]
        np.testing.assert_allclose(a[3], b[3], atol=1e-6)
        np.testing.assert_allclose(a[4], b[4], atol=1e-6)


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------

W, H = 320, 240
N = 18
KMAX = 12
BLACK = (8, 9)
FIRST = 14            # the first frame that finds the slab full
# frames the port also steps from the reference's state of the frame
# before: the blackout with the recovery, and every recycle
SYNCED = BLACK + (BLACK[-1] + 1,) + tuple(range(FIRST, N))
ORB = dict(n_features=128, n_levels=3)
INTS = ("n_kf", "n_mp", "kf_valid", "mp_valid", "kf_obs", "ref",
        "last_kf_slot", "chain_valid", "loop_i", "loop_j", "loop_valid",
        "mode", "viba_stage")
FLOATS = ("kf_R", "kf_t", "dR", "dV", "dP", "dT")


def _cfg_kwargs():
    kw = scene.bench_config_kwargs(N, max_kf=KMAX, max_mp=2048)
    kw.update(img_w=W, img_h=H, kf_max_interval_s=0.04, imu_init_kfs=4,
              obs_cap=4096)
    return kw


def _record(tr, to_np):
    c, m = tr.carry, tr.map
    rec = {k: to_np(getattr(m, k)) for k in
           ("n_kf", "n_mp", "kf_valid", "loop_i", "loop_j", "loop_valid",
            "kf_R", "kf_t", "kf_obs", "mp_valid")}
    rec.update(last_kf_slot=to_np(c.last_kf_slot),
               chain_valid=to_np(c.chain_valid), ref=to_np(c.traj.ref),
               mode=to_np(c.mode), viba_stage=to_np(c.viba_stage),
               lost_frames=to_np(c.lost_frames), boost=to_np(c.boost),
               p=to_np(c.p),
               **{k: to_np(getattr(c.chain, k)) for k in FLOATS[2:]})
    rec["traj"] = tr.get_trajectory()
    return rec


def _state(jt):
    """The reference tracker's map and carry as numpy dicts."""
    m = {k: np.asarray(v) for k, v in jt.map._asdict().items()}
    c = {k: (v._asdict() if hasattr(v, "_asdict") else v)
         for k, v in jt.carry._asdict().items()}
    c = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
             if isinstance(v, dict) else np.asarray(v))
         for k, v in c.items()}
    return m, c


def _port_tracker(rig_np, shared_bank=None):
    tr = tsv.StreamingVITracker(
        convert.rig_from_numpy(rig_np, device="cpu"),
        tsv.VIStreamConfig(orb=tex.OrbConfig(**ORB), **_cfg_kwargs()),
        tpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS, device="cpu"),
        seed=0, device="cpu")
    if shared_bank is not None:
        tr._step.extract_bank = shared_bank
    return tr


def _jax_tracker(rig_np):
    return jsv.StreamingVITracker(
        JRig(rig_np["kind"], *(jnp.asarray(rig_np[k])
                               for k in ("params", "R_cb", "t_cb"))),
        jsv.VIStreamConfig(orb=jex.OrbConfig(**ORB), **_cfg_kwargs()),
        jpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS), seed=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runs, built once for all test workers
    (`test_torch_ref_cache.shared`); `jax` and `free` are fresh trackers
    holding the final map and carry of the reference's and the free
    port's run, `synced` a fresh port tracker."""
    rig_np = scene.build_rig("kb8", W, H)
    out = ref_cache.shared(tmp_path_factory, "recycle_runs", _runs)
    jt, free = _jax_tracker(rig_np), _port_tracker(rig_np)
    (jt.map, jt.carry), (free.map, free.carry) = out.pop("final")
    jt._snap = free._snap = None       # no snapshot cached of the new state
    return dict(out, jax=jt, free=free, synced=_port_tracker(rig_np))


def _runs():
    rig_np, frames, _, _, batches = scene.make_sequence(
        N, orbit_frac=0.16, w=W, h=H)
    frames = frames.copy()
    for i in BLACK:
        frames[i] = 0
    cfg_j = jex.OrbConfig(**ORB)
    jt = _jax_tracker(rig_np)
    j_extract = jax.jit(lambda im: jex.extract_multicam(im, cfg_j))

    def shared_bank(images):
        fj = j_extract(jnp.asarray(images.numpy()))
        return tmt.concat_bands(
            tex.Features(*(torch.as_tensor(np.array(x)) for x in fj)))

    free = _port_tracker(rig_np, shared_bank)
    synced = _port_tracker(rig_np, shared_bank)
    rec = dict(jax=[], free=[], synced={}, before={})
    events = dict(free=[], synced={})
    for i in range(N):
        t, b = batches[i]
        if i in SYNCED:
            # the port's step from the reference's state of frame i - 1
            m_np, c_np = _state(jt)
            synced.map = convert.map_from_numpy(m_np, device="cpu")
            synced.carry = convert.carry_from_numpy(c_np, device="cpu")
            synced._t_prev, synced._snap = batches[i - 1][0], None
            rec["before"][i] = synced.get_trajectory() + (
                c_np["traj"]["ref"][:i],)
            synced.push(frames[i], t, b)
            rec["synced"][i] = _record(synced, convert._np)
            events["synced"][i] = synced.step_events
        jt.push(frames[i], t, b)
        free.push(frames[i], t, b)
        rec["jax"].append(_record(jt, np.asarray))
        rec["free"].append(_record(free, convert._np))
        events["free"].append(free.step_events)
    return dict(rec=rec, events=events,
                final=((jt.map, jt.carry), (free.map, free.carry)))


def test_lost_branch_sequences(runs):
    """Two black frames: LOST on both, relocalization on the second and on
    the frame after, recovery there, then five boosted frames counting
    down: the same in the free-running port and the reference."""
    for key in ("mode", "lost_frames", "boost", "n_kf"):
        a = [int(r[key]) for r in runs["rec"]["free"]]
        b = [int(r[key]) for r in runs["rec"]["jax"]]
        assert a == b, (key, a, b)
    rec = runs["rec"]["free"]
    mode = [int(r["mode"]) for r in rec]
    assert [mode[i] for i in BLACK] == [LOST, LOST]
    assert all(m == OK for i, m in enumerate(mode) if i not in BLACK)
    assert [int(r["lost_frames"]) for r in rec][8:11] == [1, 2, 0]
    assert [int(r["boost"]) for r in rec][9:16] == [0, 5, 4, 3, 2, 1, 0]
    ev = runs["events"]["free"]
    assert ev[8] == ("lost",) and ev[9] == ("reloc", "lost")
    assert ev[10][0] == "reloc" and "lost" not in ev[10]
    assert all(e == () for e in ev[:8] + ev[11:FIRST])


def test_pose_after_recovery(runs):
    """Stepped from the reference's state, the blackout's frames give the
    same discrete state, and the recovering frame (relocalization with the
    port's own RANSAC draws, then tracking) the same pose to 1e-2 m."""
    for i in BLACK + (BLACK[-1] + 1,):
        a, b = runs["rec"]["synced"][i], runs["rec"]["jax"][i]
        for key in ("mode", "lost_frames", "boost", "n_kf"):
            assert int(a[key]) == int(b[key]), (i, key)
        assert np.abs(a["p"] - b["p"]).max() < 1e-2, i
    ev = runs["events"]["synced"]
    assert ev[9] == ("reloc", "lost") and ev[10][0] == "reloc"


def test_step_recycles(runs):
    """The slab fills at frame 13; every later keyframe recycles by
    decimation, in both packages, and drops slot 3."""
    for ev in (dict(enumerate(runs["events"]["free"])),
               runs["events"]["synced"]):
        recycled = [i for i in sorted(ev) if "recycle" in ev[i]]
        assert recycled == list(range(FIRST, N))
        assert all("decimate" in ev[i] for i in recycled)
    for name in ("jax", "free"):
        n_kf = [int(r["n_kf"]) for r in runs["rec"][name]]
        assert n_kf[FIRST - 1:] == [KMAX] * (N - FIRST + 1), n_kf
        last = runs["rec"][name][-1]
        assert last["kf_valid"].all()
        assert int(last["viba_stage"]) >= 1 and int(last["mode"]) == OK
        assert np.isfinite(last["traj"][2]).all()


def _recycled(runs):
    return {i: a for i, a in runs["rec"]["synced"].items() if i >= FIRST}


@pytest.mark.parametrize("key", INTS)
def test_step_integers_equal(runs, key):
    for i, a in _recycled(runs).items():
        b = runs["rec"]["jax"][i]
        assert a[key].dtype == b[key].dtype, (key, a[key].dtype)
        np.testing.assert_array_equal(a[key], b[key],
                                      err_msg=f"frame {i}: {key}")


@pytest.mark.parametrize("key", FLOATS)
def test_step_floats_close(runs, key):
    for i, a in _recycled(runs).items():
        np.testing.assert_allclose(a[key], runs["rec"]["jax"][i][key],
                                   atol=1e-3, err_msg=f"frame {i}: {key}")


def test_step_world_trajectory(runs):
    """Each recycle here drops old slot 3, on which one frame's trajectory
    entry hangs. The port keeps that entry's world pose across the recycle
    (below 1e-3 m, like every other frame's outside the BA window); the
    reference re-anchors it on slot 2 with its old relative pose, which
    moves it by the offset between the two keyframes. Every other frame
    agrees between the packages to 1e-3."""
    for i, a in _recycled(runs).items():
        b = runs["rec"]["jax"][i]
        t_p, R_p, p_p = a["traj"]
        t_j, R_j, p_j = b["traj"]
        np.testing.assert_array_equal(t_p, t_j)
        _, _, before, ref_before = runs["rec"]["before"][i]
        (hit,) = np.flatnonzero(ref_before == 3)
        others = np.arange(len(t_p)) != hit
        np.testing.assert_allclose(p_p[others], p_j[others], atol=1e-3)
        np.testing.assert_allclose(R_p[others], R_j[others], atol=1e-3)
        # the window BA moves the recent keyframes; the old ones stay put
        assert np.abs(p_p[:hit + 2] - before[:hit + 2]).max() < 1e-3, i
        assert np.linalg.norm(p_j[hit] - before[hit]) > 0.05, i


def test_weld_chain_against_sequential_compose(runs):
    """`weld_chain` on the run's final chain with keyframes 2, 3 and 6
    culled: the entry of each survivor is the composition, written out
    here, of the old entries since the previous survivor."""
    tt = runs["free"]
    step, c = tt._step, tt.carry
    kf_valid = torch.ones(KMAX, dtype=torch.bool)
    kf_valid[[2, 3, 6]] = False
    chain_valid = c.chain_valid.clone()
    assert chain_valid[1:].all()
    chain_valid[9] = False
    new_of_old = torch.clamp(
        torch.cumsum(kf_valid.to(torch.int32), 0, dtype=torch.int32) - 1,
        min=0)
    chain2, valid2 = step.weld_chain(c.chain, chain_valid, kf_valid,
                                     new_of_old)

    def merge(ks):
        acc = tpre.init_preintegrated(torch.zeros(6))
        for k in ks:
            if bool(chain_valid[k]):
                acc = tpre.compose(acc, tpre.rebias(
                    tpre.chain_get(c.chain, k), acc.b))
        return acc

    # new slot -> the old entries it spans
    groups = {0: [0], 1: [1], 2: [2, 3, 4], 3: [5], 4: [6, 7], 5: [8],
              6: [9], 7: [10], 8: [11]}
    for new, ks in groups.items():
        want = merge(ks)
        for name, x, y in zip(want._fields, tpre.chain_get(chain2, new),
                              want):
            torch.testing.assert_close(x, y, atol=1e-6, rtol=0,
                                       msg=f"slot {new}: {name}")
        assert bool(valid2[new]) == all(bool(chain_valid[k]) for k in ks)
    assert float(chain2.dT[2]) == pytest.approx(
        float(c.chain.dT[2:5].sum()), abs=1e-6)
    assert not valid2[9:].any()
    fresh = tpre.chain_allocate(KMAX, device="cpu")
    for x, y in zip(chain2, fresh):
        assert torch.equal(x[9:], y[9:])


def test_convert_round_trip_after_recycle(runs):
    """A recycled map and carry of the reference, carried into the port
    and back: same values, the port's dtypes."""
    d, dc = _state(runs["jax"])
    tm = convert.map_from_numpy(d, device="cpu")
    for name, a, b in zip(tm._fields, runs["free"].map, tm):
        assert a.shape == b.shape and a.dtype == b.dtype, name
    for name, v in convert.map_to_numpy(tm).items():
        np.testing.assert_array_equal(v, d[name], err_msg=name)
    back = convert.carry_to_numpy(convert.carry_from_numpy(dc, device="cpu"))
    for k in ("last_kf_slot", "chain_valid"):
        np.testing.assert_array_equal(back[k], dc[k], err_msg=k)
        assert back[k].dtype == convert._np(
            getattr(runs["free"].carry, k)).dtype
    for k in ("traj", "chain"):
        for kk, v in back[k].items():
            np.testing.assert_array_equal(v, dc[k][kk], err_msg=f"{k}.{kk}")


def test_snapshot_counts_dropped_observations(runs):
    """`snapshot()["obs_dropped"]`: the rows of the whole-map observation
    table beyond `obs_cap`, i.e. what `full_map_observations` leaves out."""
    tt = runs["free"]
    obs, *_ = ttrk.full_map_observations(tt.map, None)
    n_rows = int(obs.valid.sum())
    assert n_rows > 1000
    cfg = tt.cfg
    try:
        for cap in (cfg.obs_cap, 1000, n_rows, n_rows - 1):
            tt.cfg, tt._snap = dataclasses.replace(cfg, obs_cap=cap), None
            capped, *_ = ttrk.full_map_observations(tt.map, cap)
            dropped = int(tt.snapshot()["obs_dropped"])
            assert dropped == max(n_rows - cap, 0)
            assert dropped == n_rows - int(capped.valid.sum())
    finally:
        tt.cfg, tt._snap = cfg, None


def test_run_global_ba(runs):
    """`run_global_ba()` from the reference's final (recycled,
    IMU-initialized) state: the whole-map FullInertialBA, then the live
    pose re-expressed through its reference keyframe. Map integers exact,
    keyframe poses and the live pose 1e-3, chi2 1e-3 relative; the live
    pose keeps its pose relative to that keyframe. `mesh=2` in a one-rank
    world raises ValueError (tests/test_torch_parallel.py holds mesh=1)."""
    jt = runs["jax"]
    m_np, c_np = _state(jt)
    assert int(c_np["viba_stage"]) >= 1
    tt = runs["synced"]
    tt.map = convert.map_from_numpy(m_np, device="cpu")
    tt.carry = convert.carry_from_numpy(c_np, device="cpu")
    tt._snap = None
    own = jt.map, jt.carry, jt._snap
    try:
        chi_j = jt.run_global_ba()
        m_j, c_j = _state(jt)
    finally:
        jt.map, jt.carry, jt._snap = own
    chi_t = tt.run_global_ba()
    assert chi_t.dim() == 0 and torch.isfinite(chi_t)
    assert float(chi_t) == pytest.approx(float(chi_j), rel=1e-3)
    for k in ("n_kf", "n_mp", "kf_valid", "mp_valid", "kf_obs"):
        _assert_same(getattr(tt.map, k), m_j[k], k)
    for k in ("kf_R", "kf_t", "kf_v"):
        np.testing.assert_allclose(convert._np(getattr(tt.map, k)), m_j[k],
                                   atol=1e-3, err_msg=k)
    for k in ("R", "p", "v"):
        np.testing.assert_allclose(convert._np(getattr(tt.carry, k)),
                                   c_j[k], atol=1e-3, err_msg=k)
    # the GBA moved the map, and the live pose with its keyframe
    ref = int(c_np["last_kf_slot"])
    assert np.abs(m_j["kf_t"] - m_np["kf_t"]).max() > 1e-4

    def rel(kR, kt, R, p):
        return kR.T @ R, kR.T @ (p - kt)

    before = rel(m_np["kf_R"][ref], m_np["kf_t"][ref], c_np["R"], c_np["p"])
    after = rel(*(convert._np(x) for x in (
        tt.map.kf_R[ref], tt.map.kf_t[ref], tt.carry.R, tt.carry.p)))
    np.testing.assert_allclose(after[0], before[0], atol=1e-5)
    np.testing.assert_allclose(after[1], before[1], atol=1e-5)
    assert tt.snapshot()["n_kf"] == m_j["n_kf"]
    with pytest.raises(ValueError, match="world of size 1"):
        tt.run_global_ba(mesh=2)
