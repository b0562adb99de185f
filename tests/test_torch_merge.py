"""Parity of the port's multi-map merging with the JAX reference on the
CPU: the cross-map pieces of `loop_closing.py` (`cross_place_scores`,
`_matched_pairs_cross`, `group_projection_score_cross`),
`LoopCloser.detect_merge`, `tracking.welding_ba_step`, the streaming
`make_merge_step` (a weld, a weld that does not fit, an immature map), the
trackers' atlas arms (`_spawn_new_map`, `_remap_after_merge` with the
trajectory and the parked preintegration chains, `get_trajectory` across
maps), and the `secondary_map` checks of `StreamingVITracker`.

Two maps: A is `test_torch_loop_closing.build_revisit()` on a slab padded
to 28 keyframes (so that two copies fit), B is A moved by a world Sim3
(scale 1.12, yaw 0.4, a translation), as tests/test_atlas_merge.py builds
its pair: the same place in another session's world. B is the current
map, A the older one.

The one recorded difference: a weld by a Sim3 of scale s scales every
distance of the welded map, so the port scales t_rel of the welded
session's trajectory entries by s (host trackers and the device ring);
the reference keeps t_rel, and `test_trajectory_scale_after_weld` shows
its gap of |s - 1| |t_rel|.

The reference's RANSAC draws are handed to the port (`LoopCloser
(samples=)`, `sample_idx=`). Tolerances: indices, masks, counts and
scores exact; pairs, Sim3s and transformed poses 1e-5 / 1e-4; maps after
the welding BA 1e-3 (float32 normal equations summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_loop_closer import Draws
from test_torch_loop_closing import (C, F, H, M, W, _pairs_close,
                                     _small_tracker, build_revisit)
from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.geometry import lie as jlie
from openmavis_tpu.imu import preintegration as jpre
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu.pipeline import loop_closing as jlc
from openmavis_tpu.pipeline import multi_tracking as jmt
from openmavis_tpu.pipeline import streaming_lc as jslc
from openmavis_tpu.pipeline import streaming_vi as jsv
from openmavis_tpu.pipeline import tracking as jtrk
from openmavis_tpu.slam_map import atlas as jatlas
from openmavis_tpu.slam_map import bow as jbow
from openmavis_tpu.slam_map import map_state as jms
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.pipeline import loop_closing as tlc
from openmavis_tpu_torch.pipeline import multi_tracking as tmt
from openmavis_tpu_torch.pipeline import streaming_lc as tslc
from openmavis_tpu_torch.pipeline import tracking as ttrk
from openmavis_tpu_torch.slam_map import atlas as tatlas
from openmavis_tpu_torch.slam_map import map_state as tms

K2 = 28                 # two copies of the revisit's 12 keyframes fit
N_KF = 12
SLOT = N_KF - 1         # B's newest keyframe: the query
S_B, YAW_B, T_B = 1.12, 0.4, np.array([2.0, -1.0, 0.5], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _jmap(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _tmap(d):
    return convert.map_from_numpy(d, device="cpu")


def _as_np(m):
    return {k: np.array(v) for k, v in m._asdict().items()}


def _pad(m_np, k2):
    """The map on a slab of k2 keyframes (the extra rows unallocated)."""
    out = {k: np.array(v) for k, v in
           jms.allocate(k2, m_np["kf_obs"].shape[1],
                        m_np["mp_pos"].shape[0])._asdict().items()}
    for k, v in m_np.items():
        if k.startswith("kf_"):
            out[k][:v.shape[0]] = v
        else:
            out[k] = np.array(v)
    return {k: np.asarray(v, m_np[k].dtype) for k, v in out.items()}


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                    np.float32)


class Maps:
    """A (older) and B (current, A moved by the Sim3) in both packages,
    the rig, and the chains of the revisit."""

    def __init__(self):
        m_np, carry_np, rig_np = build_revisit()
        self.a = _pad(m_np, K2)
        self.b = _as_np(jatlas.transform_map(
            _jmap(self.a), jnp.float32(S_B), jnp.asarray(_yaw(YAW_B)),
            jnp.asarray(T_B)))
        self.chain = carry_np["chain"]
        self.rig_np = rig_np
        self.jrig = JRig(rig_np["kind"], *(jnp.asarray(rig_np[k]) for k in
                                           ("params", "R_cb", "t_cb")))
        self.trig = convert.rig_from_numpy(rig_np, device="cpu")

    def jaxes(self):
        return _jmap(self.a), _jmap(self.b)

    def torches(self):
        return _tmap(self.a), _tmap(self.b)


@pytest.fixture(scope="module")
def maps():
    return Maps()


# ---------------------------------------------------------------------------
# the cross-map pieces
# ---------------------------------------------------------------------------

def test_cross_place_scores_exact(maps):
    ja, jb = maps.jaxes()
    ta, tb = maps.torches()
    ref = jlc.cross_place_scores(jb.kf_desc[SLOT], jb.kf_feat_valid[SLOT],
                                 ja)
    for chunk in (3, 8, K2):
        got = tlc.cross_place_scores(tb.kf_desc[SLOT],
                                     tb.kf_feat_valid[SLOT], ta,
                                     kf_chunk=chunk)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(convert._np(got), _np(ref))
    # the query's twins (keyframes 0 and 11 hold the same descriptors)
    # score every one of its 2 x 60 bound features
    assert int(got[0]) == int(got[SLOT]) == 2 * 60


@pytest.mark.parametrize("cand", [0, SLOT])
def test_matched_pairs_cross(maps, cand):
    ja, jb = maps.jaxes()
    ta, tb = maps.torches()
    _pairs_close(tlc._matched_pairs_cross(tb, SLOT, ta, cand),
                 jlc._matched_pairs_cross(jb, jnp.asarray(SLOT), ja,
                                          jnp.asarray(cand)))


def test_group_projection_score_cross(maps):
    """Exact, at the true Sim3 body(slot in B) -> body(cand in A) and at a
    wrong one."""
    ja, jb = maps.jaxes()
    ta, tb = maps.torches()
    cand = 0
    R_a, t_a = maps.a["kf_R"], maps.a["kf_t"]
    s = np.float32(1.0 / S_B)
    R = (R_a[cand].T @ R_a[SLOT]).astype(np.float32)
    t = (R_a[cand].T @ (t_a[SLOT] - t_a[cand])).astype(np.float32)
    jcov = jms.covisibility_matrix(ja)
    tcov = tms.covisibility_matrix(ta)
    scores = []
    for s_, t_ in ((s, t), (s, t + 0.5)):
        ref = jlc.group_projection_score_cross(
            jb, SLOT, ja, cand, jcov[cand], jnp.asarray(s_),
            jnp.asarray(R), jnp.asarray(t_), maps.jrig.kind, C, maps.jrig,
            W, H)
        got = tlc.group_projection_score_cross(
            tb, SLOT, ta, cand, tcov[cand], torch.tensor(s_),
            torch.as_tensor(R), torch.as_tensor(t_), maps.trig.kind, C,
            maps.trig, W, H)
        assert got.dtype == torch.int32
        assert int(got) == int(ref)
        scores.append(int(got))
    assert scores[0] >= 30 > scores[1]


# ---------------------------------------------------------------------------
# LoopCloser.detect_merge and the welding BA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def merges(maps):
    """detect_merge in both packages on atlases [A, B] (B current), the
    port with the reference's RANSAC draws."""
    ja, jb = maps.jaxes()
    ta, tb = maps.torches()
    jat = jatlas.Atlas(maps=[ja, jb], current=1)
    tat = tatlas.Atlas(maps=[ta, tb], current=1, device="cpu")
    jl = jlc.LoopCloser(None, K2, rig=maps.jrig, img_w=W, img_h=H)
    with Draws() as draws:
        jhit = jl.detect_merge(jat, SLOT)
    tl = tlc.LoopCloser(None, K2, rig=maps.trig, img_w=W, img_h=H,
                        device="cpu", samples=draws.idx)
    thit = tl.detect_merge(tat, SLOT)
    return dict(jat=jat, tat=tat, jl=jl, tl=tl, jhit=jhit, thit=thit,
                n_draws=len(draws.idx))


def _maps_close(tm, jm, tol=1e-3):
    for name in ("kf_obs", "kf_valid", "kf_feat_valid", "mp_valid", "n_kf",
                 "n_mp", "loop_i", "loop_j", "loop_valid", "n_loop",
                 "mp_first_kf", "mp_last_kf", "kf_desc", "kf_bow"):
        np.testing.assert_array_equal(convert._np(getattr(tm, name)),
                                      _np(getattr(jm, name)), err_msg=name)
    for name in ("kf_R", "kf_t", "kf_v", "mp_pos", "mp_dmin", "mp_dmax"):
        np.testing.assert_allclose(convert._np(getattr(tm, name)),
                                   _np(getattr(jm, name)), atol=tol, rtol=0,
                                   err_msg=name)


def test_detect_merge(merges, maps):
    """The same hit, the same merged map after the welding BA, the Atlas
    bookkeeping, the merge edge; the weld's scale undoes most of B's."""
    assert merges["jhit"] == merges["thit"] == (0, N_KF, 180)
    assert merges["n_draws"] == 1
    tat, jat, tl = merges["tat"], merges["jat"], merges["tl"]
    assert tat.n_maps() == jat.n_maps() == 1 and tat.current == 0
    assert tl.n_merges == merges["jl"].n_merges == 1 and tl.n_loops == 0
    _maps_close(tat.maps[0], jat.maps[0])
    # the merge edge (cand, slot + kf_off) is in the ring
    m = tat.maps[0]
    edges = [(int(i), int(j)) for i, j, v in zip(m.loop_i, m.loop_j,
                                                 m.loop_valid) if v]
    assert edges == [(0, SLOT + N_KF)]
    # the weld undoes most of B's scale (the Sim3 is solved from one
    # keyframe pair under keypoint noise)
    assert abs(tl.last_weld[0] * S_B - 1.0) < 0.1


def test_welding_ba_step(maps):
    """The welding BA alone on a seam perturbed by 2 cm: keyframes below
    kf_off fixed, the welded-in ones and their landmarks move."""
    ja, jb = maps.jaxes()
    s, R, t = 1.0 / S_B, _yaw(YAW_B).T, -_yaw(YAW_B).T @ T_B / S_B
    merged, ok = jatlas.merge_maps(ja, jb, jnp.float32(s), jnp.asarray(R),
                                   jnp.asarray(t, jnp.float32))
    assert ok
    d = _as_np(merged)
    d["kf_t"][N_KF:2 * N_KF] += np.float32(0.02)
    free = (np.arange(K2) >= N_KF) & d["kf_valid"]
    jm, jchi = jtrk.welding_ba_step(_jmap(d), jnp.asarray(free),
                                    maps.jrig.kind, maps.jrig)
    tm, tchi = ttrk.welding_ba_step(_tmap(d), torch.as_tensor(free),
                                    maps.trig.kind, maps.trig)
    _maps_close(tm, jm)
    np.testing.assert_allclose(float(tchi), float(jchi), rtol=1e-3)
    # the fixed keyframes and the landmarks only they see did not move
    np.testing.assert_array_equal(convert._np(tm.kf_t)[:N_KF],
                                  d["kf_t"][:N_KF])
    assert np.abs(convert._np(tm.kf_t)[N_KF:2 * N_KF]
                  - d["kf_t"][N_KF:2 * N_KF]).max() > 1e-3


# ---------------------------------------------------------------------------
# the streaming merge step
# ---------------------------------------------------------------------------

MERGE_CASES = ("weld", "no_fit", "immature")


def _streaming_state(maps, case):
    """(m, c, lcc, m2) of one case as numpy / reference objects: B the
    current map with a carry at its newest keyframe and a six-entry ring,
    A the secondary map."""
    a, b = dict(maps.a), dict(maps.b)
    if case == "no_fit":
        a["n_mp"] = np.asarray(400, np.int32)     # 400 + 180 > 512
    if case == "immature":
        b["n_kf"] = np.asarray(3, np.int32)       # slot 2 < min_kf - 1
    kw = scene.bench_config_kwargs(16, max_kf=K2, max_mp=M)
    kw.update(img_w=int(W), img_h=int(H), n_cams=C, obs_cap=2048)
    cfg = jsv.VIStreamConfig(orb=jex.OrbConfig(n_features=F, n_levels=3),
                             **kw)
    jc = jsv.init_carry(cfg, seed=5)
    rng = np.random.default_rng(3)
    tr = jc.traj
    n = 6
    tr = tr._replace(
        ref=tr.ref.at[:n].set(jnp.asarray([3, 6, 9, 10, 11, 11])),
        t_rel=tr.t_rel.at[:n].set(jnp.asarray(
            rng.normal(0, 0.2, (n, 3)), jnp.float32)),
        ok=tr.ok.at[:n].set(True), idx=jnp.asarray(n, jnp.int32))
    chain = {k: np.zeros((K2,) + v.shape[1:], np.float32)
             for k, v in maps.chain.items()}
    for k, v in maps.chain.items():
        chain[k][:v.shape[0]] = v
    cvalid = np.zeros(K2, bool)
    cvalid[1:N_KF] = True
    jc = jc._replace(
        R=jnp.asarray(b["kf_R"][SLOT]), p=jnp.asarray(b["kf_t"][SLOT]),
        v=jnp.asarray(b["kf_v"][SLOT]), imu_ok=jnp.asarray(True),
        mode=jnp.asarray(2, jnp.int32),
        last_kf_slot=jnp.asarray(SLOT, jnp.int32), traj=tr,
        chain=jpre.Preintegrated(**{k: jnp.asarray(v)
                                    for k, v in chain.items()}),
        chain_valid=jnp.asarray(cvalid))
    jl = jslc.init_lc_carry()._replace(
        last_slot=jnp.asarray(SLOT - 1, jnp.int32),
        merge_last=jnp.asarray(SLOT - 1, jnp.int32))
    return b, jc, jl, a, cfg


def _port_carry(jc):
    d = {k: (v._asdict() if hasattr(v, "_asdict") else v)
         for k, v in jc._asdict().items()}
    d = {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
             if isinstance(v, dict) else np.asarray(v))
         for k, v in d.items()}
    return convert.carry_from_numpy(d, device="cpu")


def _merge_samples(jc, jm, jm2):
    """The RANSAC samples the reference step draws for slot SLOT against
    its BoW candidate when its carry holds jc.key."""
    sc = jbow.scores(jm2.kf_bow, jm.kf_bow[SLOT])
    sc = jnp.where(jm2.kf_valid & (jnp.arange(K2) < jm2.n_kf), sc, -1)
    cand = jnp.argmax(sc)
    pairs = jlc._matched_pairs_cross(jm, jnp.asarray(SLOT), jm2, cand)
    k1 = jax.random.split(jc.key)[1]
    idx = jax.random.categorical(
        k1, jnp.where(pairs.valid, 0.0, -1e9)[None, None], shape=(128, 3))
    return torch.as_tensor(np.array(idx)).to(torch.int64)


@pytest.fixture(scope="module")
def merge_runs(maps):
    """One call of each package's merge step per case (visual: the scale
    is free, so B's 1.12 is recovered). The reference step is jitted once
    and serves the three cases."""
    out = {}
    jstep = jax.jit(jslc.make_merge_step(
        None, maps.jrig.kind, C, False, W, H))
    tstep = tslc.make_merge_step(None, maps.trig.kind, C, False, W, H)
    for case in MERGE_CASES:
        b, jc, jl, a, _ = _streaming_state(maps, case)
        jm, jm2 = _jmap(b), _jmap(a)
        idx = _merge_samples(jc, jm, jm2)
        tc = _port_carry(jc)
        tl = convert.lc_carry_from_numpy(
            {k: np.asarray(v) for k, v in jl._asdict().items()},
            device="cpu")
        jout = jstep(jm, jc, jl, jm2, maps.jrig)
        tout = tstep(_tmap(b), tc, tl, _tmap(a), maps.trig, sample_idx=idx)
        out[case] = dict(j=jout, t=tout, events=tstep.events, b=b, jc=jc,
                         jl=jl)
    return out


_LC_FIELDS = ("last_slot", "cand", "pend_slot", "count", "n_loops",
              "merged", "merge_last", "n_merges", "kf_off")


@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_step(merge_runs, case):
    """LCCarry's integers exact; the map's bindings, counters and edges
    exact and its poses 1e-3; the carry moved into A's world 1e-3 with its
    slots, ring references and chain shifted exactly; the ring's t_rel
    scaled by the weld's s (the port's repair; the reference keeps it)."""
    r = merge_runs[case]
    jm, jc, jl = r["j"]
    tm, tc, tl = r["t"]
    for k in _LC_FIELDS:
        np.testing.assert_array_equal(convert._np(getattr(tl, k)),
                                      _np(getattr(jl, k)), err_msg=k)
    _maps_close(tm, jm)
    for k in ("R", "p", "v"):
        np.testing.assert_allclose(convert._np(getattr(tc, k)),
                                   _np(getattr(jc, k)), atol=1e-3, rtol=0,
                                   err_msg=k)
    for k in ("last_kf_slot", "chain_valid"):
        np.testing.assert_array_equal(convert._np(getattr(tc, k)),
                                      _np(getattr(jc, k)), err_msg=k)
    for k in ("dR", "dV", "dP", "dT"):
        np.testing.assert_allclose(convert._np(getattr(tc.chain, k)),
                                   _np(getattr(jc.chain, k)), atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(convert._np(tc.traj.ref),
                                  _np(jc.traj.ref))
    welded = case == "weld"
    # the weld's scale, read off the carry's velocity (v -> s_w R_w v)
    s_w = float(np.linalg.norm(_np(jc.v)) / np.linalg.norm(_np(r["jc"].v)))
    if welded:
        assert abs(s_w * S_B - 1.0) < 0.1
    else:
        assert s_w == 1.0
    np.testing.assert_allclose(convert._np(tc.traj.t_rel),
                               s_w * _np(jc.traj.t_rel), atol=1e-4)
    assert r["events"] == {"weld": ("merge_attempt", "weld"),
                           "no_fit": ("merge_attempt", "weld"),
                           "immature": ()}[case]
    assert int(tl.n_merges) == int(welded)
    if welded:
        assert int(tl.kf_off) == N_KF and int(tm.n_kf) == 2 * N_KF
        assert int(tc.last_kf_slot) == SLOT + N_KF
        assert int(tl.merge_last) == int(tl.last_slot) + 1 == SLOT + N_KF
        np.testing.assert_array_equal(convert._np(tc.traj.ref)[:6],
                                      np.array([3, 6, 9, 10, 11, 11]) + N_KF)
    else:
        # nothing moved: the map, the carry and LCCarry as they were, but
        # for the slot merge detection saw
        _maps_close(tm, _jmap(r["b"]), tol=0)
        for k in ("R", "p", "v", "last_kf_slot"):
            np.testing.assert_array_equal(convert._np(getattr(tc, k)),
                                          _np(getattr(r["jc"], k)))
        slot = SLOT if case == "no_fit" else 2
        assert int(tl.merge_last) == slot
        assert bool(tl.merged) is False


# ---------------------------------------------------------------------------
# the trackers' atlas arms
# ---------------------------------------------------------------------------

def _traj(rng, entries):
    """Trajectory list entries (time, map_id, ref, R_rel, t_rel)."""
    out = []
    for n, (mid, ref) in enumerate(entries):
        R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.1, 3),
                                                jnp.float32)))
        out.append((0.05 * n, mid, ref, R,
                    rng.normal(0, 0.3, 3).astype(np.float32)))
    return out


def _pre_list(chain, n):
    """Per-slot numpy Preintegrated dicts [None, 1, ..., n-1]."""
    return [None] + [{k: np.array(v[i]) for k, v in chain.items()}
                     for i in range(1, n)]


def _jpre(d):
    return None if d is None else jpre.Preintegrated(
        **{k: jnp.asarray(v) for k, v in d.items()})


def _tpre(d):
    return None if d is None else convert.pre_from_numpy(d, device="cpu")


def _same_pres(tp, jp):
    assert [p is None for p in tp] == [p is None for p in jp]
    for a, b in zip(tp, jp):
        if b is not None:
            for k in ("dR", "dV", "dP", "dT"):
                np.testing.assert_array_equal(convert._np(getattr(a, k)),
                                              _np(getattr(b, k)))


def _same_traj(tt, jt):
    assert len(tt) == len(jt)
    for a, b in zip(tt, jt):
        assert a[:3] == b[:3]
        np.testing.assert_allclose(a[3], _np(b[3]), atol=1e-6)
        np.testing.assert_allclose(a[4], _np(b[4]), atol=1e-6)


def _multi_trackers(maps):
    """Both packages' MultiTracker on an atlas, with A as map 0 tracked,
    its chain and a trajectory."""
    cfg_kw = dict(img_w=int(W), img_h=int(H), n_cams=C, max_kf=K2,
                  max_mp=M)
    jt = jmt.MultiTracker(maps.jrig, jmt.MultiTrackerConfig(
        orb=jex.OrbConfig(n_features=F, n_levels=3), **cfg_kw),
        atlas=jatlas.Atlas())
    tt = tmt.MultiTracker(maps.trig, tmt.MultiTrackerConfig(
        orb=tex.OrbConfig(n_features=F, n_levels=3), **cfg_kw),
        atlas=tatlas.Atlas(), device="cpu")
    pres = _pre_list(maps.chain, N_KF)
    traj = _traj(np.random.default_rng(4), [(0, k % N_KF)
                                            for k in range(8)])
    jt.map = _jmap(maps.a)
    tt.map = _tmap(maps.a)
    for t, conv in ((jt, _jpre), (tt, _tpre)):
        t._sync_atlas()
        t.kf_pre = [conv(p) for p in pres]
        t.trajectory = list(traj)
        t.n_kf, t.last_kf_slot, t.state = N_KF, SLOT, t.LOST
        t.imu_initialized = False
    return jt, tt


def test_spawn_new_map(maps):
    """Both trackers park the map (and, for MultiTracker, its chain) and
    start tracking into a fresh atlas map, as the reference does."""
    jt, tt = _multi_trackers(maps)
    jt._spawn_new_map()
    tt._spawn_new_map()
    for t in (jt, tt):
        assert (t.map_id, t.atlas.current, t.atlas.n_maps()) == (1, 1, 2)
        assert (t.state, t.n_kf, t.last_kf_slot, t.kf_pre) == (
            t.NOT_INITIALIZED, 0, -1, [])
        assert t.imu_initialized is False and t.last_kf_time is None
        assert list(t._parked_pre) == [0]
    _same_pres(tt._parked_pre[0], jt._parked_pre[0])
    _maps_close(tt.atlas.maps[0], jt.atlas.maps[0], tol=0)
    assert int(tt.map.n_kf) == 0 and tt.map.kf_obs.shape == (K2, C * F)
    # the one-camera Tracker
    cfg_kw = dict(img_w=int(W), img_h=int(H), max_kf=K2, max_mp=M)
    j1 = jtrk.Tracker(maps.jrig, jtrk.TrackerConfig(
        orb=jex.OrbConfig(n_features=C * F, n_levels=3), **cfg_kw),
        atlas=jatlas.Atlas())
    t1 = ttrk.Tracker(maps.trig, ttrk.TrackerConfig(
        orb=tex.OrbConfig(n_features=C * F, n_levels=3), **cfg_kw),
        atlas=tatlas.Atlas(), device="cpu")
    for t, mk in ((j1, _jmap), (t1, _tmap)):
        t.map = mk(maps.a)
        t.n_kf, t.last_kf_slot, t.state = N_KF, SLOT, t.LOST
        t._spawn_new_map()
        assert (t.map_id, t.atlas.n_maps(), t.state, t.n_kf) == (
            1, 2, t.NOT_INITIALIZED, 0)
        assert t._init_feats is None and t.last_kf_slot == -1
    _maps_close(t1.atlas.maps[0], j1.atlas.maps[0], tol=0)


def _welded(maps, package):
    """A and B welded by the exact inverse of B's Sim3 (kf_off 12)."""
    s, R = 1.0 / S_B, _yaw(YAW_B).T
    t = -R @ T_B / S_B
    if package == "jax":
        ja, jb = maps.jaxes()
        return jatlas.merge_maps(ja, jb, jnp.float32(s), jnp.asarray(R),
                                 jnp.asarray(t, jnp.float32))[0]
    ta, tb = maps.torches()
    return tatlas.merge_maps(ta, tb, torch.tensor(s, dtype=torch.float32),
                             torch.as_tensor(R),
                             torch.as_tensor(t.astype(np.float32)))[0]


def test_remap_after_merge_multi(maps):
    """MultiTracker after map 1 (B, current) welded into map 0 (A): the
    trajectory (s = 1 here, the reference's arithmetic), the welded chain
    (map 0's parked chain in [0, kf_off), this map's after, the seam
    interval invalid), and get_trajectory across the maps before and
    after, all equal to the reference's."""
    jt, tt = _multi_trackers(maps)
    for t in (jt, tt):
        t._spawn_new_map()
    b_pres = _pre_list(maps.chain, N_KF)
    traj_b = _traj(np.random.default_rng(5), [(1, k) for k in (2, 7, SLOT)])
    for t, conv, mk in ((jt, _jpre, _jmap), (tt, _tpre, _tmap)):
        t.map = mk(maps.b)
        t._sync_atlas()
        t.kf_pre = [conv(p) for p in b_pres]
        t.trajectory = t.trajectory + traj_b
    _same_traj_world = []
    for t in (jt, tt):
        _same_traj_world.append(t.get_trajectory())
    for a, b in zip(*_same_traj_world):
        np.testing.assert_allclose(a, b, atol=1e-5)
    # the weld, as detect_merge leaves the atlas
    for t, pkg in ((jt, "jax"), (tt, "torch")):
        t.atlas.maps = [_welded(maps, pkg)]
        t.atlas.current = 0
        t.map = t.atlas.current_map
        t._remap_after_merge(1, 0, N_KF)
        t.map_id = 0
    _same_traj(tt.trajectory, jt.trajectory)
    assert [e[:3] for e in tt.trajectory[-3:]] == [
        (e[0], 0, e[2] + N_KF) for e in traj_b]
    _same_pres(tt.kf_pre, jt.kf_pre)
    assert len(tt.kf_pre) == 2 * N_KF and tt.kf_pre[N_KF] is None
    assert tt._parked_pre == {} and jt._parked_pre == {}
    for a, b in zip(tt.get_trajectory(), jt.get_trajectory()):
        np.testing.assert_allclose(a, b, atol=1e-5)
    # with the IMU initialized the weld runs the MergeInertialBA analog
    # over the welded chain: a port-only check that it keeps the map
    tt.imu_initialized = True
    tt._remap_after_merge(5, 0, 0)
    assert bool(torch.isfinite(tt.map.kf_t).all())
    np.testing.assert_array_equal(convert._np(tt.map.kf_valid),
                                  _np(jt.map.kf_valid))


def test_trajectory_scale_after_weld(maps):
    """A session welded by a Sim3 of scale s = 1 / 1.12: the port's
    replayed frames land on the Sim3 image of where they were (1e-5); the
    reference's land |s - 1| |t_rel| off, because it keeps t_rel (3.2 cm
    on average here, 0.107 x |t_rel| for each frame)."""
    s_w, R_w = 1.0 / S_B, _yaw(YAW_B).T
    t_w = -R_w @ T_B / S_B
    rng = np.random.default_rng(6)
    traj_b = _traj(rng, [(1, k) for k in (0, 3, 5, 8, 10, SLOT)])
    out = {}
    for pkg, tracker, atlas, mk in (
            ("jax", jtrk.Tracker, jatlas.Atlas, _jmap),
            ("torch", ttrk.Tracker, tatlas.Atlas, _tmap)):
        if pkg == "jax":
            tr = tracker(maps.jrig, jtrk.TrackerConfig(max_kf=K2),
                         atlas=atlas(maps=[mk(maps.a), mk(maps.b)],
                                     current=1))
        else:
            tr = tracker(maps.trig, ttrk.TrackerConfig(max_kf=K2),
                         atlas=atlas(maps=[mk(maps.a), mk(maps.b)],
                                     current=1, device="cpu"),
                         device="cpu")
        tr.trajectory = list(traj_b)
        before = tr.get_trajectory()[2]
        tr.atlas.maps = [_welded(maps, pkg)]
        tr.atlas.current = 0
        tr.map, tr.map_id = tr.atlas.current_map, 0
        if pkg == "jax":
            tr._remap_after_merge(1, 0, N_KF)
        else:
            tr._remap_after_merge(1, 0, N_KF, s_w)
        out[pkg] = (before, tr.get_trajectory()[2])
    before, after = out["torch"]
    image = s_w * before @ R_w.T + t_w
    np.testing.assert_allclose(after, image, atol=1e-5)
    gap = np.linalg.norm(out["jax"][1] - image, axis=1)
    t_rel = np.linalg.norm(np.stack([e[4] for e in traj_b]), axis=1)
    np.testing.assert_allclose(gap, abs(s_w - 1.0) * t_rel, atol=1e-5)
    assert 0.02 < gap.mean() < 0.05


def test_secondary_map_checks(maps):
    """`secondary_map` needs device loop closing and a MapState of the
    tracker's own capacities (the reference fails at trace time there)."""
    rig_np, tr = _small_tracker(device_lc=True)
    own = tms.allocate(8, tr.map.kf_obs.shape[1], 1024, device="cpu")
    with pytest.raises(ValueError, match="device_lc"):
        _small_tracker(secondary_map=own)
    for bad in (tms.allocate(16, own.kf_obs.shape[1], 1024, device="cpu"),
                tms.allocate(8, own.kf_obs.shape[1], 512, device="cpu")):
        with pytest.raises(ValueError, match="capacities"):
            _small_tracker(device_lc=True, secondary_map=bad)
    _, tr = _small_tracker(device_lc=True, secondary_map=own,
                           merge_kw=dict(min_kf=7))
    assert tr._merge_step.min_kf == 7 and tr.map2.n_kf.shape == ()
    assert "n_merges" in tr.snapshot() and "merge_kf_off" in tr.snapshot()
