"""Parity of the port's host-policy loop closer with the JAX reference on
one-camera scenes, on the CPU: `test_loop_verification.py`'s aliased
scenes through both packages' `LoopCloser` (a false loop the temporal
gate refuses, a true loop, a tilted correction the gravity gate refuses
and a yaw-only one it accepts), and the one-camera trackers' arms:
`Tracker._close_loop` (with its wide window BA) on the first camera of
`test_torch_loop_closing.py`'s staged revisit, and
`StreamingTracker.maybe_close_loop` on the aliased true loop.

The reference's RANSAC draws are handed to the port's closer
(`test_torch_loop_closer.Draws`).

Tolerances: decisions, pending slots and counts, `n_loops` and loop
edges exact; a Sim3 1e-4; rotations 1e-3; positions 1e-2 m on the
aliased scenes' 40 m weld (a Sim3 rotation equal to 1e-4 moves the far
side by up to 4e-3 m) and 1e-3 on the staged revisit, but landmarks 2e-3
after the `Tracker`'s wide window BA; a live pose relative to its
reference keyframe 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_loop_verification as tlv
import test_torch_loop_closing as tlcg
from test_torch_loop_closer import (Draws, _carry_np, _maps_close,
                                    _pending_close, _rel, _snap_pending)
from test_torch_loop_closing import F, H, K, M, SLOT, W, _as_dict, _jmap
from test_torch_tracker import _ref_state as tr_ref_state
from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.geometry import lie as jlie
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu.pipeline import loop_closing as jlc
from openmavis_tpu.pipeline import streaming as jst
from openmavis_tpu.pipeline import tracking as jtrk
from openmavis_tpu_torch import convert
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.pipeline import loop_closing as tlc
from openmavis_tpu_torch.pipeline import streaming as tst
from openmavis_tpu_torch.pipeline import tracking as ttrk


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread is as fast
    as eight, and eight per test worker oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# test_loop_verification.py's scenes through both packages
# ---------------------------------------------------------------------------

_LV_CASES = {
    # name: (second keyframe consistent, a 0.2 rad yaw for scene B (else
    #        the scene's 1.3 rad pitch), inertial, closes on keyframe 11)
    "false_loop": (False, False, False, False),
    "true_loop": (True, False, False, True),
    "tilted_loop": (True, False, True, False),
    "yaw_only": (True, True, True, True),
}


@pytest.mark.parametrize("case", list(_LV_CASES))
def test_loop_verification_cases(case):
    """The aliased two-scene map of `test_loop_verification.py`: keyframe
    10's pair Sim3 is perfect; keyframe 11 continues the alias (a true
    loop) or diverges (a false loop, which the temporal gate refuses);
    on an inertial map a pitch correction is refused and a yaw-only one
    accepted. Both packages take the same decisions at both keyframes
    and correct the map alike: rotations 1e-3, positions 1e-2 m on the
    40 m weld."""
    consistent, yaw, inertial, closes = _LV_CASES[case]
    R_B = jlie.so3_exp(jnp.asarray([0.0, 0.0, 0.2])) if yaw else None
    jm = tlv.build_aliased_map(second_consistent=consistent, R_B=R_B)
    m_np = _as_dict(jm)
    jrig = tlv.mono_rig()
    trig = convert.rig_from_numpy(
        dict(kind=jrig.kind, params=_np(jrig.params), R_cb=_np(jrig.R_cb),
             t_cb=_np(jrig.t_cb)), device="cpu")
    cfg = tlv.CFG
    jres, tres = [], []
    with Draws() as d:
        jl = jlc.LoopCloser(None, tlv.K, cfg, rig=jrig, inertial=inertial,
                            img_w=tlv.W, img_h=tlv.H)
        for slot in (10, 11):
            jm, closed = jl.on_keyframe(jm, slot)
            jres.append((closed, _snap_pending(jl.pending), jl.n_loops))
    tl = tlc.LoopCloser(None, tlv.K, tlc.LoopConfig(**cfg.__dict__),
                        rig=trig, inertial=inertial, img_w=tlv.W,
                        img_h=tlv.H, device="cpu", samples=d.idx)
    tm = convert.map_from_numpy(m_np, device="cpu")
    for slot in (10, 11):
        tm, closed = tl.on_keyframe(tm, slot)
        tres.append((closed, _snap_pending(tl.pending), tl.n_loops))
    assert not tl.samples
    for (tc, tp, tn), (jc, jp, jn) in zip(tres, jres):
        assert tc == jc and tn == jn
        _pending_close(tp, jp)
    assert tres[1][0] == closes and tres[1][2] == int(closes)
    assert tres[1][1] is None
    # the weld spans 40 m: a Sim3 rotation equal to 1e-4 moves the far
    # side by up to 4e-3 m, so positions are held to 1e-2 m there
    _maps_close(tm, jm, floats=("kf_R",))
    _maps_close(tm, jm, ints=(), floats=("kf_t", "mp_pos"), tol=1e-2)


# the one-camera trackers run on test_loop_verification.py's aliased map
# (one pinhole camera, a true loop confirmed on keyframe 11)

def _aliased(n_kf):
    """The true-loop aliased map as numpy with `n_kf` keyframes counted,
    the one-camera rig in both packages."""
    m_np = _as_dict(tlv.build_aliased_map(second_consistent=True))
    m_np["n_kf"] = np.asarray(n_kf, np.int32)
    jrig = tlv.mono_rig()
    trig = convert.rig_from_numpy(
        dict(kind=jrig.kind, params=_np(jrig.params), R_cb=_np(jrig.R_cb),
             t_cb=_np(jrig.t_cb)), device="cpu")
    return m_np, jrig, trig


def test_tracker_loop_closer_arm():
    """`Tracker._close_loop` from the reference `Tracker`'s state
    (`convert.tracker_state_from_numpy`) on the staged revisit's first
    camera: keyframe 11 closes at once (`temporal_consistency=1`; the
    closer's own GBA off) and the wide window BA (`gba_window`) settles
    the map, as the reference's arm does. Poses to 1e-3; landmarks to
    2e-3 (the window's LM moves one camera's landmarks along their rays:
    measured 1.3e-3 on 3 of 512, 1.6e-4 relative)."""
    m_np, _, rig_np = tlcg.build_revisit(n_cams=1)
    jrig = JRig(rig_np["kind"], *(jnp.asarray(rig_np[k]) for k in
                                  ("params", "R_cb", "t_cb")))
    trig = convert.rig_from_numpy(rig_np, device="cpu")
    lc_kw = dict(temporal_consistency=1, run_gba=False)
    cfg_kw = dict(img_w=int(W), img_h=int(H), max_kf=K, max_mp=M)
    with Draws() as d:
        jl = jlc.LoopCloser(None, K, jlc.LoopConfig(**lc_kw), rig=jrig,
                            img_w=W, img_h=H)
        jt = jtrk.Tracker(jrig, jtrk.TrackerConfig(
            orb=jex.OrbConfig(n_features=F, n_levels=3), **cfg_kw),
            loop_closer=jl)
        jt.map = _jmap(m_np)
        jt.n_kf, jt.last_kf_slot, jt.state = SLOT + 1, SLOT, jt.OK
        state = tr_ref_state(jt)
        # the reference Tracker's arm (the end of its _insert_keyframe)
        jt.map, j_closed = jl.on_keyframe(jt.map, SLOT)
        if j_closed:
            jt.map, _ = jtrk.local_ba_step(
                jt.map, jnp.asarray(SLOT), jrig.kind, jrig,
                window=(jt.cfg.gba_window or jt.cfg.ba_window))
    tl = tlc.LoopCloser(None, K, tlc.LoopConfig(**lc_kw), rig=trig,
                        img_w=W, img_h=H, device="cpu", samples=d.idx)
    tt = ttrk.Tracker(trig, ttrk.TrackerConfig(
        orb=tex.OrbConfig(n_features=F, n_levels=3), **cfg_kw),
        loop_closer=tl, device="cpu")
    convert.tracker_state_from_numpy(state, tt)
    assert tt._close_loop(SLOT) is j_closed is True
    assert tl.n_loops == jl.n_loops == 1 and not tl.samples
    _maps_close(tt.map, jt.map, floats=("kf_R", "kf_t"))
    _maps_close(tt.map, jt.map, ints=(), floats=("mp_pos",), tol=2e-3)
    assert int(tt.map.loop_j[0]) == SLOT


def test_streaming_tracker_maybe_close_loop():
    """`StreamingTracker.maybe_close_loop` from the reference tracker's
    map and carry: with keyframe 10 the newest it pends, with keyframe 11
    counted it closes, and the live pose is re-expressed through keyframe
    11 (relative pose kept to 1e-5, equal to the reference's to 1e-5);
    rotations 1e-3, positions 1e-2 m on the 40 m weld."""
    m_np, jrig, trig = _aliased(11)
    cfg_kw = dict(img_w=tlv.W, img_h=tlv.H, max_kf=tlv.K, max_mp=tlv.M,
                  traj_cap=16)
    jc = jst.init_carry(tlv.F, 16, 0)
    jc = jc._replace(R=jnp.asarray(m_np["kf_R"][11]),
                     t=jnp.asarray(m_np["kf_t"][11]) + 0.05,
                     last_kf_slot=jnp.asarray(11, jnp.int32))
    with Draws() as d:
        jl = jlc.LoopCloser(None, tlv.K, tlv.CFG, rig=jrig, img_w=tlv.W,
                            img_h=tlv.H)
        jt = jst.StreamingTracker(jrig, jst.StreamConfig(
            orb=jex.OrbConfig(n_features=tlv.F, n_levels=4), **cfg_kw),
            loop_closer=jl)
        jt.map, jt.carry = _jmap(m_np), jc
        j_out = [jt.maybe_close_loop()]
        jt.map = jt.map._replace(n_kf=jnp.asarray(12, jnp.int32))
        jt._snap = None
        j_out.append(jt.maybe_close_loop())
    tl = tlc.LoopCloser(None, tlv.K, tlc.LoopConfig(**tlv.CFG.__dict__),
                        rig=trig, img_w=tlv.W, img_h=tlv.H, device="cpu",
                        samples=d.idx)
    tt = tst.StreamingTracker(trig, tst.StreamConfig(
        orb=tex.OrbConfig(n_features=tlv.F, n_levels=4), **cfg_kw),
        loop_closer=tl, device="cpu")
    convert.streaming_state_from_numpy(
        dict(map=m_np, carry=_carry_np(jc), _last_lc_slot=-1), tt)
    c0, m0 = tt.carry, tt.map
    t_out = [tt.maybe_close_loop()]
    tt.map = tt.map._replace(n_kf=torch.tensor(12, dtype=torch.int32))
    t_out.append(tt.maybe_close_loop())
    assert t_out == j_out == [False, True] and tl.n_loops == 1
    assert tt._last_lc_slot == jt._last_lc_slot == 11
    _maps_close(tt.map, jt.map, floats=("kf_R",))
    _maps_close(tt.map, jt.map, ints=(), floats=("kf_t", "mp_pos"),
                tol=1e-2)
    rel_before = _rel(convert._np(m0.kf_R), convert._np(m0.kf_t), 11,
                      convert._np(c0.R), convert._np(c0.t))
    rel_t = _rel(convert._np(tt.map.kf_R), convert._np(tt.map.kf_t), 11,
                 convert._np(tt.carry.R), convert._np(tt.carry.t))
    rel_j = _rel(jt.map.kf_R, jt.map.kf_t, 11, jt.carry.R, jt.carry.t)
    for a, b, c in zip(rel_t, rel_before, rel_j):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        np.testing.assert_allclose(a, c, atol=1e-5, rtol=0)
