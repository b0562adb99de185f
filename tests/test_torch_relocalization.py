"""LOST-mode relocalization of the port against the JAX reference on the
CPU.

* `ransac_pnp` with the samples `jax.random.categorical` draws from the
  same key and logits handed over as `sample_idx`: inlier mask and count
  exact, pose 1e-4 (5e-4 for the "cross" rows, which are kept for
  comparison because they are the worse conditioned: their 12 x 12
  eigenproblem passes float32 rounding on at ~2e-4); both formulations,
  with and without the `sigma2` weighting, and with no valid row.
* `descriptor_place_scores`: exact.
* `relocalize_step` on the map of a tracked run (the port's own tracker
  on the flagship rig cut to 320x240, 256 features x 3 levels, a keyframe
  on every frame, 12 frames; the map and the features go to the reference
  as numpy) with camera 0's features of a frame: the keyframe scores, the
  three candidates and the 2D-3D matches exact against the reference's
  formulas, and with the reference's own samples handed over the inlier
  count equal and the pose 5e-3 m (on real landmarks the minimal 6-point
  solves are ill-conditioned in float32 and differ between the packages;
  the refits over all inliers even that out). With the port's own draws `success` is equal and the pose within
  5e-3 m and 0.2 degree. That bound holds where the refit over all inliers
  lands on one inlier set whatever the samples, as at the frame the test
  uses; at other frames of such a run the reference's own pose moves by
  10-24 cm from one key to the next (f = 176 px, a 1.15 degree gate), and
  no bound between two sample streams can be tighter than that.
* The capped local map (`track_map_cap`), on the same map and its last
  frame: `_local_map_compact`'s `inv` and `used` exact; `track_step_multi`
  and `track_step_multi_vi` with a cap below the live landmark count:
  `feat_mp`, `vis`, `keep`, `n_in` exact, pose 1e-4; with a cap >= M equal
  to the uncapped call.

The LOST branch of the step is held in `tests/test_torch_recycle.py`,
which shares its run of both trackers with the recycling frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.frontend import matcher as jmatcher
from openmavis_tpu.imu import preintegration as jpre
from openmavis_tpu.optim import pose_opt as jpo
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu.pipeline import multi_tracking as jmt
from openmavis_tpu.pipeline import tracking as jtrk
from openmavis_tpu.slam_map import map_state as jms
from openmavis_tpu.solvers import pnp as jpnp
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.imu import preintegration as tpre
from openmavis_tpu_torch.optim import pose_opt as tpo
from openmavis_tpu_torch.pipeline import multi_tracking as tmt
from openmavis_tpu_torch.pipeline import streaming_vi as tsv
from openmavis_tpu_torch.pipeline import tracking as ttrk
from openmavis_tpu_torch.solvers import pnp as tpnp


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are tiny: one intra-op thread is as fast as
    eight, and eight per test worker oversubscribe the machine when the
    files of the suite run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# ransac_pnp
# ---------------------------------------------------------------------------

def _pnp_scene(seed, n=160, outliers=0.3, invalid=0.15):
    """World points seen from a known pose over a wide field of view:
    exact bearings for the inliers, random ones for the outliers."""
    rng = np.random.default_rng(seed)
    ang = rng.normal(size=3) * 0.4
    th = np.linalg.norm(ang)
    k = ang / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = rng.normal(size=3)
    p_c = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                    rng.uniform(2, 9, n)], axis=1)
    p_w = (p_c - t) @ R                      # p_c = R p_w + t
    bearing = p_c / np.linalg.norm(p_c, axis=1, keepdims=True)
    out = rng.random(n) < outliers
    rnd = rng.normal(size=(n, 3))
    bearing[out] = (rnd / np.linalg.norm(rnd, axis=1, keepdims=True))[out]
    valid = rng.random(n) >= invalid
    sigma2 = (1.2 ** (2 * rng.integers(0, 8, n))).astype(np.float32)
    return (p_w.astype(np.float32), bearing.astype(np.float32), valid,
            sigma2, R, t, out)


def _jax_samples(key, valid, n_hyp, size=6):
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    return np.asarray(jax.random.categorical(
        key, logits[None, None, :], shape=(n_hyp, size)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("formulation", ["nullspace", "cross"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_pnp(seed, formulation, weighted):
    p_w, bearing, valid, sigma2, R, t, out = _pnp_scene(seed)
    key = jax.random.PRNGKey(seed + 7)
    n_hyp = 128
    s2 = sigma2 if weighted else None
    ref = jpnp.ransac_pnp(
        key, jnp.asarray(p_w), jnp.asarray(bearing), jnp.asarray(valid),
        n_hyp=n_hyp, sigma2=None if s2 is None else jnp.asarray(s2),
        formulation=formulation)
    got = tpnp.ransac_pnp(
        None, _t(p_w), _t(bearing), _t(valid), n_hyp=n_hyp,
        sigma2=None if s2 is None else _t(s2), formulation=formulation,
        sample_idx=_t(_jax_samples(key, valid, n_hyp)))
    assert bool(got.success) and bool(ref.success)
    assert got.n_inliers.dtype == torch.int32
    assert int(got.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))
    atol = 1e-4 if formulation == "nullspace" else 5e-4
    np.testing.assert_allclose(got.R_cw.numpy(), np.asarray(ref.R_cw),
                               atol=atol)
    np.testing.assert_allclose(got.t_cw.numpy(), np.asarray(ref.t_cw),
                               atol=atol)
    # and both found the scene's pose and its inliers
    np.testing.assert_allclose(got.R_cw.numpy(), R, atol=1e-3)
    np.testing.assert_allclose(got.t_cw.numpy(), t, atol=5e-3)
    assert int(got.n_inliers) >= int((valid & ~out).sum())


def test_ransac_pnp_no_valid_row():
    p_w, bearing, valid, *_ = _pnp_scene(3)
    valid[:] = False
    key = jax.random.PRNGKey(1)
    ref = jpnp.ransac_pnp(key, jnp.asarray(p_w), jnp.asarray(bearing),
                          jnp.asarray(valid), n_hyp=32)
    got = tpnp.ransac_pnp(None, _t(p_w), _t(bearing), _t(valid), n_hyp=32,
                          sample_idx=_t(_jax_samples(key, valid, 32)))
    assert not bool(got.success) and not bool(ref.success)
    assert int(got.n_inliers) == int(ref.n_inliers) == 0
    assert not got.inlier.any()
    # the port's own draw: uniform, every hypothesis rejected, no raise
    gen = torch.Generator().manual_seed(0)
    own = tpnp.ransac_pnp(gen, _t(p_w), _t(bearing), _t(valid), n_hyp=32)
    assert not bool(own.success) and int(own.n_inliers) == 0


def test_draw_samples_only_valid_rows():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 17, 30, 31, 44, 45, 49]] = True
    gen = torch.Generator().manual_seed(5)
    idx = tpnp.draw_samples(gen, valid, n_hyp=64, sample_size=6)
    assert idx.shape == (64, 6) and idx.dtype == torch.int64
    assert bool(valid[idx].all())
    assert len(set(idx.reshape(-1).tolist())) == 7


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bearing_nullspace(seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[:8] = [0, 0, 1]
    v[8:16] = [0, 0, -1]
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r, s = tpnp.bearing_nullspace(_t(v))
    jr, js = jpnp.bearing_nullspace(jnp.asarray(v))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6)


# ---------------------------------------------------------------------------
# a tracked run of the port: the map for relocalize_step and the capped
# local map
# ---------------------------------------------------------------------------

W, H = 320, 240
N = 12
RELOC_FRAME = 7
CAP_FRAME = N - 1
ORB = dict(n_features=256, n_levels=3)


def _cfg_kwargs():
    kw = scene.bench_config_kwargs(N, max_kf=16, max_mp=4096)
    kw.update(img_w=W, img_h=H, kf_max_interval_s=0.04, imu_init_kfs=4,
              obs_cap=8192)
    return kw


def _jmap(tm):
    return jms.MapState(**{k: jnp.asarray(v)
                           for k, v in convert.map_to_numpy(tm).items()})


@pytest.fixture(scope="module")
def runs():
    rig_np, frames, _, _, batches = scene.make_sequence(
        N, orbit_frac=0.1, w=W, h=H)
    jrig = JRig(rig_np["kind"], *(jnp.asarray(rig_np[k])
                                  for k in ("params", "R_cb", "t_cb")))
    tt = tsv.StreamingVITracker(
        convert.rig_from_numpy(rig_np, device="cpu"),
        tsv.VIStreamConfig(orb=tex.OrbConfig(**ORB), **_cfg_kwargs()),
        tpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS, device="cpu"),
        seed=0, device="cpu")
    feats, poses = [], []
    extract = tt._step.extract_bank

    def keeping_bank(images):
        feats.append(tex.extract_multicam(images, tt._step.orb))
        return extract(images)

    tt._step.extract_bank = keeping_bank
    for i in range(N):
        t, b = batches[i]
        if i == CAP_FRAME:
            # what the last frame's tracking step starts from
            c = tt.carry
            cap_in = dict(
                imu=tt._imu_arrays(list(b), t), map=tt.map,
                state={k: convert._np(getattr(c, k))
                       for k in ("R", "p", "v", "bg", "ba")},
                min_last=int(c.last_kf_slot) - 10)
        tt.push(frames[i], t, b)
        poses.append((convert._np(tt.carry.R), convert._np(tt.carry.p)))
    assert int(tt.carry.mode) == 2 and bool(tt.carry.imu_ok)
    return dict(port=tt, feats=feats, poses=poses, jrig=jrig, rig_np=rig_np,
                cap_in=cap_in)


def test_descriptor_place_scores(runs):
    tm = runs["port"].map
    jm = _jmap(tm)
    for slot in (0, int(jm.n_kf) - 1):
        got = ttrk.descriptor_place_scores(tm, slot)
        ref = jtrk.descriptor_place_scores(jm, slot)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert int(got[slot]) == int(tm.kf_feat_valid[slot].sum())


@pytest.fixture(scope="module")
def kidnap(runs):
    """The run's final map in both packages and camera 0's features of
    frame 7 (inside the mapped stretch)."""
    tm = runs["port"].map
    ft = tex.Features(*(x[0] for x in runs["feats"][RELOC_FRAME]))
    fj = jex.Features(*(jnp.asarray(x.numpy()) for x in ft))
    return _jmap(tm), tm, fj, ft


def test_relocalization_candidates_and_matches(kidnap):
    jm, tm, fj, ft = kidnap
    Kk, F = jm.kf_obs.shape
    # the reference's formulas (pipeline/tracking.py, relocalize_step)
    dist = jmatcher.hamming_matrix(
        fj.desc, jm.kf_desc.reshape(Kk * F, 256)).reshape(-1, Kk, F)
    t_valid = jm.kf_feat_valid & (jm.kf_obs >= 0) & jm.kf_valid[:, None]
    best = jnp.min(jnp.where(t_valid[None], dist, 1 << 20), axis=2)
    jscores = jnp.sum((best < jmatcher.TH_LOW).astype(jnp.int32)
                      & fj.valid[:, None].astype(jnp.int32), axis=0)
    _, jcand = jax.lax.top_k(jscores, ttrk.N_RELOC_CAND)

    scores, cand = ttrk.relocalization_candidates(tm, ft)
    assert scores.dtype == torch.int32
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(jcand))
    assert int(scores.max()) >= 30

    for kf in np.asarray(jcand).tolist():
        has_mp = (jm.kf_obs[kf] >= 0) & jm.kf_feat_valid[kf]
        jidx, _ = jmatcher.match_nn(fj.desc, fj.valid, jm.kf_desc[kf],
                                    has_mp, max_dist=jmatcher.TH_LOW,
                                    ratio=0.85, mutual=True)
        matched = jidx >= 0
        jmp = jnp.where(matched, jm.kf_obs[kf][jnp.where(matched, jidx, 0)],
                        0)
        jvalid = matched & jm.mp_valid[jmp]
        idx, mp, valid = ttrk.relocalization_matches(tm, ft, kf)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(mp.numpy(), np.asarray(jmp))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert idx.dtype == torch.int32 and mp.dtype == torch.int32


def test_relocalize_step(kidnap, runs):
    jm, tm, fj, ft = kidnap
    rig = convert.rig_from_numpy(runs["rig_np"], device="cpu")
    ok_j, R_j, t_j, n_j = jtrk.relocalize_step(
        jm, fj, jax.random.PRNGKey(3), runs["jrig"].kind, runs["jrig"])
    gen = torch.Generator().manual_seed(3)
    ok_t, R_t, t_t, n_t = ttrk.relocalize_step(tm, ft, gen, rig.kind, rig)
    assert bool(ok_j) and bool(ok_t)
    assert n_t.dtype == torch.int32 and int(n_t) >= 15

    def angle_deg(Ra, Rb):
        dR = np.asarray(Ra, np.float64).T @ np.asarray(Rb) - np.eye(3)
        return np.degrees(np.linalg.norm(dR) / np.sqrt(2.0))

    assert np.abs(t_t.numpy() - np.asarray(t_j)).max() < 5e-3
    assert angle_deg(R_t.numpy(), R_j) < 0.2
    # the pose is that of camera 0's centre with the body's orientation
    # (the bearings are rotated into the body frame, not shifted): the
    # tracker's own for that frame, as far as 116 inliers at this image
    # size pin it down
    R_own, p_own = runs["poses"][RELOC_FRAME]
    c0 = -runs["rig_np"]["R_cb"][0].T @ runs["rig_np"]["t_cb"][0]
    assert np.linalg.norm(t_t.numpy() - (p_own + R_own @ c0)) < 0.15
    assert angle_deg(R_t.numpy(), R_own) < 2.0

    # with the reference's samples the whole step is the reference's
    keys = jax.random.split(jax.random.PRNGKey(3), ttrk.N_RELOC_CAND)
    _, cand = ttrk.relocalization_candidates(tm, ft)
    samples = []
    for kf, k in zip(cand.tolist(), keys):
        _, _, valid = ttrk.relocalization_matches(tm, ft, kf)
        logits = jnp.where(jnp.asarray(valid.numpy()), 0.0, -1e9)
        samples.append(np.asarray(jax.random.categorical(
            k, logits[None, None, :], shape=(512, 6))))
    ok_s, R_s, t_s, n_s = ttrk.relocalize_step(
        tm, ft, None, rig.kind, rig, sample_idx=_t(np.stack(samples)))
    assert bool(ok_s) and int(n_s) == int(n_j)
    # 5e-3 m: on real landmarks 5-15 m out the minimal 6-point solves are
    # ill-conditioned in float32 (the two packages' best hypotheses lie
    # 0.08-0.34 m apart from equal samples, with equal inlier masks); the
    # refits over all inliers bring the winner back to 0.6-2.5 mm
    np.testing.assert_allclose(R_s.numpy(), np.asarray(R_j), atol=1e-3)
    np.testing.assert_allclose(t_s.numpy(), np.asarray(t_j), atol=5e-3)


# ---------------------------------------------------------------------------
# the capped local map
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cap_case(runs):
    """Frame 11's tracking inputs in both packages: the map before it, the
    bank of all four cameras, the last state and the IMU prediction."""
    cin = runs["cap_in"]
    tm = cin["map"]
    jm = _jmap(tm)
    ft = runs["feats"][CAP_FRAME]
    tbank = tmt.concat_bands(ft)
    jbank = jmt.concat_bands(jex.Features(*(jnp.asarray(x.numpy())
                                            for x in ft)))
    w, a, dt = cin["imu"]
    st = cin["state"]
    bias = np.concatenate([st["bg"], st["ba"]])
    jpre_f = jpre.integrate(jnp.asarray(w), jnp.asarray(a), jnp.asarray(dt),
                            jnp.asarray(bias),
                            jpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS))
    tpre_f = tpre.integrate(_t(w), _t(a), _t(dt), _t(bias),
                            tpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS,
                                                      device="cpu"))
    janchor = jpo.InertialState(**{k: jnp.asarray(v) for k, v in st.items()})
    tanchor = tpo.InertialState(**{k: _t(v) for k, v in st.items()})
    jR, jp, jv = jpre.predict_state(janchor.R, janchor.p, janchor.v, jpre_f,
                                    jnp.asarray(bias))
    tR, tp, tv = tpre.predict_state(tanchor.R, tanchor.p, tanchor.v, tpre_f,
                                    _t(bias))
    return dict(
        jm=jm, tm=tm, jbank=jbank, tbank=tbank, jpre=jpre_f, tpre=tpre_f,
        janchor=janchor, tanchor=tanchor,
        jpred=janchor._replace(R=jR, p=jp, v=jv),
        tpred=tanchor._replace(R=tR, p=tp, v=tv),
        min_last=cin["min_last"], jrig=runs["jrig"],
        rig=convert.rig_from_numpy(runs["rig_np"], device="cpu"))


CAP = 300


@pytest.mark.parametrize("min_last", [-1, 4])
def test_local_map_compact(cap_case, min_last):
    jm, tm = cap_case["jm"], cap_case["tm"]
    assert int(tm.mp_valid.sum()) > 2 * CAP
    for cap in (CAP, 64):
        jsub, jinv, jused = jmt._local_map_compact(jm, min_last, cap)
        tsub, tinv, tused = tmt._local_map_compact(tm, min_last, cap)
        np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
        np.testing.assert_array_equal(tused.numpy(), np.asarray(jused))
        for name in jsub._fields:
            a, b = getattr(tsub, name), np.asarray(getattr(jsub, name))
            assert a.numpy().dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def _track(cc, vi: bool, map_cap: int, port_only: bool = False):
    """One tracking step with `map_cap`: the port's outputs, pose first,
    (R, t, feat_mp, n_in, vis, keep), or (reference's, port's)."""
    kw = dict(map_cap=map_cap, po_rounds=2, po_iters=6)
    C, radius = 4, 15.0
    size = (float(W), float(H))
    if vi:
        ts, *trest = tmt.track_step_multi_vi(
            cc["tm"], cc["tbank"], cc["tanchor"], cc["tpred"], cc["tpre"],
            cc["rig"].kind, C, cc["rig"], *size, torch.tensor(radius),
            cc["min_last"], **kw)
        got = (ts.R, ts.p, *trest)
    else:
        got = tmt.track_step_multi(
            cc["tm"], cc["tbank"], cc["tpred"].R, cc["tpred"].p,
            cc["rig"].kind, C, cc["rig"], *size, torch.tensor(radius),
            cc["min_last"], **kw)
    if port_only:
        return got
    if vi:
        js, *jrest = jmt.track_step_multi_vi(
            cc["jm"], cc["jbank"], cc["janchor"], cc["jpred"], cc["jpre"],
            cc["jrig"].kind, C, cc["jrig"], *size, radius, cc["min_last"],
            **kw)
        return (js.R, js.p, *jrest), got
    return jmt.track_step_multi(
        cc["jm"], cc["jbank"], cc["jpred"].R, cc["jpred"].p,
        cc["jrig"].kind, C, cc["jrig"], *size, radius, cc["min_last"],
        **kw), got


@pytest.mark.parametrize("vi", [False, True], ids=["visual", "vi"])
def test_track_step_with_map_cap(cap_case, vi):
    M = cap_case["tm"].mp_pos.shape[0]
    ref, capped = _track(cap_case, vi, CAP)
    for name, g, r in zip(("R", "t", "feat_mp", "n_in", "vis", "keep"),
                          capped, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, name
        if name in ("R", "t"):
            np.testing.assert_allclose(g, r, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)
    # a cap that holds the whole slab is the uncapped call (which
    # `tests/test_torch_slice.py` holds against the reference)
    full, at_m = (_track(cap_case, vi, cap, port_only=True)
                  for cap in (0, M))
    for g, f in zip(at_m, full):
        assert torch.equal(g, f)
    # the cap bites: fewer landmarks matched, all of them among the most
    # recently observed, and still enough to track
    assert 20 <= int(capped[4].sum()) < int(full[4].sum())
    assert int(capped[3]) >= 20
    _, inv, used = tmt._local_map_compact(cap_case["tm"],
                                          cap_case["min_last"], CAP)
    in_cap = torch.zeros(M, dtype=torch.bool)
    in_cap[inv[used]] = True
    assert bool((capped[4] <= in_cap).all())
    fm = capped[2]
    assert bool(in_cap[fm[fm >= 0].to(torch.int64)].all())
