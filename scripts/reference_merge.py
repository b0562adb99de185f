#!/usr/bin/env python3
"""The reference package's multi-map runs (`openmavis_tpu`, JAX) on the
CPU at the configurations of `chip_smoke.py`'s paths 12-14, so that the
port's runs on the GPU have a reference row. Each mode prints one JSON
line: the frame of the weld, its keyframe offset, the maps, the loops and
the ATE.

  device_merge          path 12: two sessions of the flagship rig and
                        scene (4 x KB8 at 640 x 480, 4 x 512 ORB x 8,
                        400 Hz IMU, the bench's 64-keyframe / 16,384-
                        landmark slab, device_lc=dict(score_min=30,
                        temporal=2)). Session A streams frames 0-59;
                        session B, a fresh tracker (seed SEED, 1 2 3 by
                        default), streams frames 60-159 with A's map as
                        `secondary_map` and `make_merge_step`'s defaults
                        (MERGE_KW); one line per seed
  multi_tracker_atlas   path 13: the host-policy MultiTracker with an
                        Atlas and LoopCloser(None, 64, rig, inertial=True)
                        on path 2's orbit, N frames (200) with frames
                        100-122 black
  mono_atlas            path 14: tests/test_atlas_merge.py's scene (512 x
                        384 pinhole, 512 ORB x 4, 32 keyframes, 8,192
                        landmarks, max_lost_frames 3) through Tracker with
                        an Atlas and LoopCloser(None, 32, rig): 24 frames
                        of the orbit, 5 black frames, the 24 again; the
                        line also marks each tracked frame (`tracked`)
  mono_atlas --port     the same through the port's Tracker on the CPU
                        (seed 0, the reference's constants; TORCH_THREADS
                        torch threads, 1 by default; about half a minute)
  mono_atlas --step-port [A-B]
                        every frame A-B (0-52 by default) the port's
                        Tracker from the reference's state of the frame
                        before (attributes, the Atlas with a parked map,
                        the closer's state), fed its features, two-view or
                        PnP draws and Sim3 samples; per frame the fields
                        that part and both closers' decisions
                        (`reference_streaming_vi.HostTrace`; about two
                        minutes)
  mono_atlas --two-view FRAME
                        that frame's two-view attempt from the reference's
                        state in both packages, with each E hypothesis's
                        float32 and float64 scores
                        (`reference_streaming_vi.two_view_compare`; about
                        two minutes)

  fresh_start START [N] [--port]
                        a fresh session (path 12's B without A's map:
                        the flagship rig, scene, slab and device loop
                        closer, seed 1) started on frame START of the
                        flagship scene, N frames (24); what its rig init
                        gets (landmarks, their distance from the rig,
                        the init keyframe's stereo and temporal counts)
                        and the Horn scale and ATE over its first 4, 8,
                        12, 16 and N frames; `--port` runs the port's
                        StreamingVITracker on the CPU instead

Run: JAX_PLATFORMS=cpu python3 scripts/reference_merge.py MODE [ARG ...]
(ARG: B's seeds for device_merge, the frame count N for
multi_tracker_atlas; device_merge about five minutes and two more a seed,
multi_tracker_atlas about six, mono_atlas about one; a few GiB each;
progress on stderr).

Why the split is at frame 60: a fresh session started on frame 64 of
this scene tracks badly in this package (its own ATE 1.2 m by frame 100,
Horn scale 17 over its first frames), while starts on frames 40, 48, 56,
60, 72 and 80 all track to 1-4 cm over 24 frames.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from openmavis_tpu.frontend import extractor  # noqa: E402
from openmavis_tpu.imu import preintegration as pre_mod  # noqa: E402
from openmavis_tpu.io import evaluation  # noqa: E402
from openmavis_tpu.optim.reprojection import RigParams  # noqa: E402
from openmavis_tpu.pipeline import loop_closing  # noqa: E402
from openmavis_tpu.slam_map import atlas as atlas_mod  # noqa: E402
from openmavis_tpu_torch import scene  # noqa: E402

# path 12's split of the flagship's 160 frames, and the merge keywords
SPLIT = 60
MERGE_KW = {}
# path 13: frames and blackout
N_ATLAS = 200
ATLAS_BLACKOUT = range(100, 123)
# path 14: the orbit's frames and the black frames between its two passes
N_MONO_PASS, N_MONO_BLACK = 24, 5
MONO_W, MONO_H = 512, 384


def _log(**kw):
    print(json.dumps(kw), file=sys.stderr, flush=True)


def _ate(t_est, p_est, ok, times, t_gt):
    """ATE after association; `rmse` with Horn scale, `rmse_noscale`
    rigid."""
    return evaluation.ate_rmse(t_est[ok], p_est[ok], times, t_gt)


def _flagship_rig(rig_np):
    return RigParams(rig_np["kind"], *(jnp.asarray(rig_np[k])
                                       for k in ("params", "R_cb", "t_cb")))


def device_merge(seeds) -> list:
    from openmavis_tpu.pipeline import streaming_vi

    n = scene.N_FRAMES
    rig_np, frames, _, t_wb, batches = scene.make_sequence(
        n, orbit_frac=1.25, kind_name="kb8")
    rig = _flagship_rig(rig_np)
    cfg = streaming_vi.VIStreamConfig(
        orb=extractor.OrbConfig(n_features=512, n_levels=8),
        **scene.bench_config_kwargs(n))
    noise = pre_mod.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS)
    lc_kw = dict(score_min=30, temporal=2)

    t0 = time.perf_counter()
    tra = streaming_vi.StreamingVITracker(rig, cfg, noise, seed=0,
                                          device_lc=lc_kw)
    for i in range(SPLIT):
        tra.push(frames[i], *batches[i])
    tra.block()
    _log(session="A", n_kf=int(tra.snapshot()["n_kf"]),
         s=time.perf_counter() - t0)
    return [session_b(tra, seed, frames, t_wb, batches, rig, cfg, noise,
                      lc_kw, t0) for seed in seeds]


def session_b(tra, seed, frames, t_wb, batches, rig, cfg, noise, lc_kw,
              t0) -> dict:
    from openmavis_tpu.pipeline import streaming_vi

    n = len(frames)
    sa = tra.snapshot()
    n_kf_a = int(sa["n_kf"])
    trb = streaming_vi.StreamingVITracker(
        rig, cfg, noise, seed=seed, device_lc=lc_kw,
        secondary_map=tra.map, merge_kw=MERGE_KW)
    weld = []

    def on_frame(i):
        if not weld and int(trb.lc_carry.n_merges) > 0:
            weld.append(i)
            _log(weld_frame=i, s=time.perf_counter() - t0)
        elif (i + 1) % 16 == 0:
            _log(frame=i, n_kf=int(trb.map.n_kf),
                 s=time.perf_counter() - t0)

    for i in range(SPLIT, n):
        trb.push(frames[i], *batches[i])
        on_frame(i)
    trb.block()
    sb = trb.snapshot()
    t_b, _, p_b = trb.get_trajectory()
    ok_b = np.asarray(sb["ok"][:len(t_b)], bool)
    times_b = np.arange(SPLIT, n) / scene.FPS_IN
    res_b = _ate(t_b, p_b, ok_b, times_b, t_wb[SPLIT:])
    # both sessions in A's world, under one rigid alignment
    t_a, _, p_a = tra.get_trajectory()
    ok_a = np.asarray(sa["ok"][:len(t_a)], bool)
    joint = evaluation.ate_rmse(
        np.concatenate([t_a[ok_a], t_b[ok_b]]),
        np.concatenate([p_a[ok_a], p_b[ok_b]]),
        np.arange(n) / scene.FPS_IN, t_wb)
    return {
        "path": "device_merge", "merge_kw": MERGE_KW, "b_seed": seed,
        "a_n_kf": n_kf_a, "a_tracked": int(ok_a.sum()),
        "b_frames": n - SPLIT, "b_tracked": int(ok_b.sum()),
        "weld_frame": weld[0] if weld else None,
        "n_merges": int(sb["n_merges"]),
        "merge_kf_off": int(sb["merge_kf_off"]),
        "merged_n_kf": int(sb["n_kf"]), "n_loops": int(sb["n_loops"]),
        "b_ate_noscale_m": float(res_b["rmse_noscale"]),
        "b_ate_m": float(res_b["rmse"]),
        "joint_ate_noscale_m": float(joint["rmse_noscale"]),
        "run_s": time.perf_counter() - t0}


def fresh_start(start: int, n: int, port: bool) -> dict:
    n_all = scene.N_FRAMES
    rig_np, frames, _, t_wb, batches = scene.make_sequence(
        n_all, orbit_frac=1.25, kind_name="kb8")
    lc_kw = dict(score_min=30, temporal=2)
    orb = dict(n_features=512, n_levels=8)
    if port:
        import torch
        from openmavis_tpu_torch import convert
        from openmavis_tpu_torch.frontend import extractor as tex
        from openmavis_tpu_torch.imu import preintegration as tpre
        from openmavis_tpu_torch.pipeline import streaming_vi as tsv
        torch.set_num_threads(int(os.environ.get("TORCH_THREADS", "1")))
        tr = tsv.StreamingVITracker(
            convert.rig_from_numpy(rig_np, device="cpu"),
            tsv.VIStreamConfig(orb=tex.OrbConfig(**orb),
                               **scene.bench_config_kwargs(n_all)),
            tpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS, device="cpu"),
            seed=1, device="cpu", device_lc=lc_kw)
        to_np = convert._np
    else:
        from openmavis_tpu.pipeline import streaming_vi
        tr = streaming_vi.StreamingVITracker(
            _flagship_rig(rig_np), streaming_vi.VIStreamConfig(
                orb=extractor.OrbConfig(**orb),
                **scene.bench_config_kwargs(n_all)),
            pre_mod.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS), seed=1,
            device_lc=lc_kw)
        to_np = np.asarray
    t0 = time.perf_counter()
    init = None
    for i in range(start, min(start + n, n_all)):
        tr.push(frames[i], *batches[i])
        if init is None:
            m = tr.map
            k = int(to_np(m.n_mp))
            pts = to_np(m.mp_pos)[:k].astype(np.float64)
            d = np.linalg.norm(pts - to_np(m.kf_t)[0], axis=1)
            init = dict(
                frame=i, mode=int(to_np(tr.carry.mode)), landmarks=k,
                distance_m=dict(zip(
                    ("p10", "p50", "p90", "max"),
                    [float(x) for x in np.percentile(d, [10, 50, 90])]
                    + [float(d.max())])),
                beyond_10m=int((d > 10).sum()),
                beyond_20m=int((d > 20).sum()))
    sb = tr.snapshot()
    t_e, _, p_e = tr.get_trajectory()
    ok = np.asarray(sb["ok"][:len(t_e)], bool)
    first = {}
    for k in (4, 8, 12, 16, n):
        sel = ok & (np.arange(len(ok)) < k)
        res = evaluation.ate_rmse(t_e[sel], p_e[sel],
                                  np.arange(n_all) / scene.FPS_IN, t_wb)
        first[str(k)] = dict(horn_scale=float(res["scale"]),
                             ate_m=float(res["rmse"]),
                             ate_noscale_m=float(res["rmse_noscale"]))
    return {"mode": "fresh_start", "start": start, "frames": n,
            "tracked": int(ok.sum()), "n_kf": int(sb["n_kf"]),
            "rig_init": init, "first_frames": first,
            "run_s": time.perf_counter() - t0}


def multi_tracker_atlas(n: int) -> dict:
    from openmavis_tpu.pipeline import multi_tracking

    rig_np, frames, _, t_wb, batches = scene.make_sequence(
        n, orbit_frac=1.25 * (n - 1) / (scene.N_FRAMES - 1),
        kind_name="kb8")
    for i in ATLAS_BLACKOUT:
        frames[i] = 0
    rig = _flagship_rig(rig_np)
    fields = set(multi_tracking.MultiTrackerConfig.__dataclass_fields__)
    kw = {k: v for k, v in scene.bench_config_kwargs().items()
          if k in fields}
    cfg = multi_tracking.MultiTrackerConfig(
        orb=extractor.OrbConfig(n_features=512, n_levels=8), **kw)
    atlas = atlas_mod.Atlas()
    lc = loop_closing.LoopCloser(None, cfg.max_kf, rig=rig, inertial=True,
                                 img_w=cfg.img_w, img_h=cfg.img_h)
    tr = multi_tracking.MultiTracker(
        rig, cfg, pre_mod.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS),
        seed=0, loop_closer=lc, atlas=atlas)
    oks, events = [], []
    last = dict(maps=1, merges=0, imu=False)
    t0 = time.perf_counter()
    for i in range(n):
        t, b = batches[i]
        for w, a, ts in b:
            tr.feed_imu(w, a, ts)
        oks.append(bool(tr.process_frame(
            jnp.asarray(frames[i].astype(np.float32)), t)))
        now = dict(maps=atlas.n_maps(), merges=lc.n_merges,
                   imu=bool(tr.imu_initialized))
        if now != last:
            events.append(dict(frame=i, n_kf=tr.n_kf, map_id=tr.map_id,
                               loops=lc.n_loops, **now))
            _log(**events[-1], s=time.perf_counter() - t0)
        last = now
        if (i + 1) % 20 == 0:
            _log(frame=i, tracked=sum(oks), n_kf=tr.n_kf,
                 s=time.perf_counter() - t0)
    t_est, _, p_est = tr.get_trajectory()
    ok = np.asarray(oks)
    times = np.arange(n) / scene.FPS_IN
    res = _ate(t_est, p_est, ok, times, t_wb)
    return {
        "path": "multi_tracker_atlas", "frames": n,
        "blackout": [ATLAS_BLACKOUT.start, ATLAS_BLACKOUT.stop - 1],
        "frames_tracked": int(ok.sum()), "events": events,
        "n_maps": atlas.n_maps(), "n_merges": lc.n_merges,
        "n_loops": lc.n_loops, "n_kf": tr.n_kf,
        "len_kf_pre": len(tr.kf_pre),
        "imu_initialized": bool(tr.imu_initialized),
        "ate_rmse_m": float(res["rmse"]),
        "ate_rmse_noscale_m": float(res["rmse_noscale"]),
        "horn_scale": float(res["scale"]),
        "run_s": time.perf_counter() - t0}


def mono_atlas_scene() -> dict:
    """Path 14's scene: the pinhole, the frames (24 of the orbit, 5
    black, the 24 again) and the ground truth."""
    from openmavis_tpu_torch.io import synthetic

    pin = np.array([380.0, 380.0, MONO_W / 2, MONO_H / 2, 0, 0, 0, 0],
                   np.float32)
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    R_wc, t_wc = synthetic.orbit_trajectory(N_MONO_PASS, radius=6.0,
                                            frac=0.2)
    orbit = synthetic.render_sequence(world, 0, pin, R_wc, t_wc, MONO_W,
                                      MONO_H)
    seq = (list(orbit) + [np.zeros_like(orbit[0])] * N_MONO_BLACK
           + list(orbit))
    gt = np.concatenate([t_wc, np.zeros((N_MONO_BLACK, 3)), t_wc])
    return dict(pin=pin, seq=seq, gt=gt)


def mono_atlas_trackers(sc: dict, port: bool):
    """Path 14's Tracker with its Atlas and LoopCloser(None, 32, rig) in
    the reference package, or with `port` in the port's on the CPU
    (`TORCH_THREADS` torch threads, 1 by default)."""
    pin = sc["pin"]
    if port:
        import torch
        from openmavis_tpu_torch import convert
        from openmavis_tpu_torch.frontend import extractor as tex
        from openmavis_tpu_torch.pipeline import loop_closing as tlc
        from openmavis_tpu_torch.pipeline import tracking as ttrk
        from openmavis_tpu_torch.slam_map import atlas as tatlas

        torch.set_num_threads(int(os.environ.get("TORCH_THREADS", "1")))
        rig = convert.rig_from_numpy(dict(
            kind=0, params=pin[None], R_cb=np.eye(3, dtype=np.float32)[None],
            t_cb=np.zeros((1, 3), np.float32)), device="cpu")
        cfg = ttrk.TrackerConfig(
            img_w=MONO_W, img_h=MONO_H,
            orb=tex.OrbConfig(n_features=512, n_levels=4), max_kf=32,
            max_mp=8192, max_lost_frames=3)
        atlas = tatlas.Atlas(device="cpu")
        lc = tlc.LoopCloser(None, 32, rig=rig, device="cpu")
        return ttrk.Tracker(rig, cfg, seed=0, loop_closer=lc, atlas=atlas,
                            device="cpu")
    from openmavis_tpu.pipeline import tracking

    rig = RigParams(kind=0, params=jnp.asarray(pin)[None],
                    R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))
    cfg = tracking.TrackerConfig(
        img_w=MONO_W, img_h=MONO_H,
        orb=extractor.OrbConfig(n_features=512, n_levels=4),
        max_kf=32, max_mp=8192, max_lost_frames=3)
    return tracking.Tracker(rig, cfg, seed=0,
                            loop_closer=loop_closing.LoopCloser(
                                None, 32, rig=rig),
                            atlas=atlas_mod.Atlas())


def mono_atlas(port: bool = False) -> dict:
    sc = mono_atlas_scene()
    seq, gt = sc["seq"], sc["gt"]
    tr = mono_atlas_trackers(sc, port)
    atlas, lc = tr.atlas, tr.loop_closer
    oks, events = [], []
    last = dict(maps=1, merges=0)
    t0 = time.perf_counter()
    for i, img in enumerate(seq):
        img = np.asarray(img, np.float32) if port else jnp.asarray(img)
        oks.append(bool(tr.process_frame(img, time=i / 20.0)))
        now = dict(maps=atlas.n_maps(), merges=lc.n_merges)
        if now != last:
            events.append(dict(frame=i, n_kf=int(tr.n_kf), map_id=tr.map_id,
                               state=tr.state, **now))
            _log(**events[-1], s=time.perf_counter() - t0)
        last = now
    t_est, _, p_est = tr.get_trajectory()
    ok = np.asarray(oks)
    res = _ate(t_est, p_est, ok, np.arange(len(seq)) / 20.0, gt)
    return {
        "path": "mono_atlas", "frames": len(seq),
        "frames_tracked": int(ok.sum()),
        "tracked": "".join("x" if o else "." for o in oks),
        "events": events,
        "n_maps": atlas.n_maps(), "n_merges": lc.n_merges,
        "n_loops": lc.n_loops, "n_kf": int(tr.n_kf),
        "trajectory_finite": bool(np.isfinite(p_est).all()),
        "ate_rmse_m": float(res["rmse"]),
        "horn_scale": float(res["scale"]),
        "run_s": time.perf_counter() - t0}


# what --step-port compares: integers exactly, poses and landmarks beyond
# 1e-3 map units
STEP_INTS = ("ok", "state", "n_kf", "map_id", "last_kf_slot",
             "lost_frames", "n_maps", "n_merges", "n_loops", "n_mp",
             "kf_valid", "kf_obs", "mp_valid", "traj_ref")
STEP_FLOATS = ("R", "t", "kf_t", "mp_pos", "traj_t")


def _np_tree(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _ref_state(jt) -> dict:
    """The reference Tracker's attributes laid out as
    `convert.tracker_state_to_numpy` lays out the port's, with its Atlas
    (`convert.atlas_to_numpy`'s layout) and its closer's state."""
    from openmavis_tpu_torch import convert
    import reference_streaming_vi as rsv

    d = {k: getattr(jt, k, None) for k in convert._TR_HOST}
    d.update({k: np.asarray(getattr(jt, k)) for k in convert._TR_TENSORS})
    d["map"] = _np_tree(jt.map)
    d["_init_feats"] = (None if jt._init_feats is None
                        else _np_tree(jt._init_feats))
    d["trajectory"] = list(jt.trajectory)
    d["key"] = np.asarray(jt.key)
    d["atlas"] = dict(maps=[_np_tree(m) for m in jt.atlas.maps],
                      current=int(jt.atlas.current))
    d["closer"] = rsv.reference_closer_state(jt.loop_closer)
    return d


def _step_record(d: dict, ok, lc) -> dict:
    m = d["map"]
    rec = {k: np.asarray(d[k]) for k in ("state", "n_kf", "map_id",
                                         "last_kf_slot", "lost_frames",
                                         "R", "t")}
    rec.update({k: np.asarray(m[k]) for k in ("n_mp", "kf_valid", "kf_obs",
                                              "mp_valid", "kf_t",
                                              "mp_pos")})
    rec.update(ok=np.asarray(bool(ok)), n_maps=len(d["atlas"]["maps"]),
               n_merges=lc.n_merges, n_loops=lc.n_loops)
    traj = d["trajectory"]
    rec["traj_ref"] = np.array([(e[1], e[2]) for e in traj])
    rec["traj_t"] = np.array([np.asarray(e[4]) for e in traj])
    return rec


def _port_record(tt, ok) -> dict:
    from openmavis_tpu_torch import convert
    d = convert.tracker_state_to_numpy(tt)
    d["atlas"] = convert.atlas_to_numpy(tt.atlas)
    return _step_record(d, ok, tt.loop_closer)


def _parts(got: dict, ref: dict) -> dict:
    out = {}
    for k in STEP_INTS:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        if a.shape != b.shape or not np.array_equal(a, b):
            out[k] = (int(np.sum(a != b)) if a.shape == b.shape
                      else "shape %s / %s" % (a.shape, b.shape))
    for k in STEP_FLOATS:
        a = np.asarray(got[k], np.float64)
        b = np.asarray(ref[k], np.float64)
        if a.shape != b.shape:
            out[k] = "shape %s / %s" % (a.shape, b.shape)
            continue
        diff = float(np.max(np.abs(a - b))) if a.size else 0.0
        if diff > 1e-3:
            out[k] = diff
    return out


def _two_view_samples(d, fj):
    """The reference's two-view draws on a frame that attempts the init,
    or None (the key split as `_try_initialize` splits it, then as
    `two_view.reconstruct` draws)."""
    import torch
    from openmavis_tpu.frontend import matcher as jmatcher

    if d["state"] != 0 or d["_init_feats"] is None:
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
    """The reference's PnP draws on a LOST frame (the key split as
    `process_frame` splits it, one subkey per candidate keyframe as
    `relocalize_step` splits it), or None."""
    import torch
    from openmavis_tpu_torch import convert
    from openmavis_tpu_torch.pipeline import tracking as ttrk

    if d["state"] != 2:
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


def mono_atlas_step_port(frames) -> dict:
    """Path 14, every frame of `frames` the port's Tracker from the
    reference's state of the frame before (its attributes, its Atlas
    with the parked map and the closer's state, through `convert`), fed
    the reference's features, its two-view or PnP draws
    (`process_frame(sample_idx=)`) and its Sim3 RANSAC samples
    (`LoopCloser.samples`); the frames before the first run as the
    reference alone. Returns per frame the fields that part and both
    closers' decisions (`reference_streaming_vi.HostTrace`)."""
    import torch
    from openmavis_tpu_torch import convert
    from openmavis_tpu_torch.frontend import extractor as tex
    import reference_streaming_vi as rsv

    sc = mono_atlas_scene()
    seq = sc["seq"]
    jt = mono_atlas_trackers(sc, False)
    tt = mono_atlas_trackers(sc, True)
    jtr = rsv.HostTrace(jt.loop_closer, ref=True, draws=True)
    ttr = rsv.HostTrace(tt.loop_closer, ref=False)
    shared = {}
    tt._ext = lambda img: shared["feats"]
    rows = []
    t0 = time.perf_counter()
    for i, img in enumerate(seq):
        d = _ref_state(jt) if i in frames else None
        img_j = jnp.asarray(img)
        jtr.frame = ttr.frame = i
        jtr.draws.clear()
        n_rows = len(jtr.rows)
        if d is not None:
            fj = jt._ext(img_j)
            shared["feats"] = tex.Features(
                *(torch.as_tensor(np.array(x)) for x in fj))
            samples = _two_view_samples(d, fj)
            if samples is None:
                samples = _reloc_samples(d, shared["feats"])
        ok_j = jt.process_frame(img_j, time=i / 20.0)
        if d is None:
            continue
        ref = _step_record(_ref_state(jt), ok_j, jt.loop_closer)
        tt.atlas = convert.atlas_from_numpy(d["atlas"], device="cpu")
        convert.tracker_state_from_numpy(d, tt)
        convert.loop_closer_state_from_numpy(d["closer"], tt.loop_closer)
        tt.loop_closer.samples.clear()
        tt.loop_closer.samples.extend(jtr.draws)
        t_rows = len(ttr.rows)
        ok_t = tt.process_frame(np.asarray(img, np.float32), time=i / 20.0,
                                sample_idx=samples)
        row = dict(frame=i, ok=bool(ok_j), state=int(ref["state"]),
                   n_kf=int(ref["n_kf"]), map_id=int(ref["map_id"]),
                   n_maps=int(ref["n_maps"]),
                   draws=("two_view" if isinstance(samples, tuple) else
                          "reloc" if samples is not None else None),
                   parts=_parts(_port_record(tt, ok_t), ref))
        if len(jtr.rows) > n_rows or len(ttr.rows) > t_rows:
            row.update(trace=[{k: v for k, v in r.items()
                               if k not in rsv.TRACE_LONG}
                              for r in jtr.rows[n_rows:]],
                       trace_parts=rsv.trace_parts(ttr.rows[t_rows:],
                                                   jtr.rows[n_rows:]))
        rows.append(row)
        _log(**row, s=time.perf_counter() - t0)
    jtr.restore()
    ttr.restore()
    return dict(path="mono_atlas",
                package="port stepped from the reference",
                first_part=next((r["frame"] for r in rows if r["parts"]
                                 or r.get("trace_parts")), None),
                frames=rows, run_s=time.perf_counter() - t0)


def mono_atlas_two_view(frame: int) -> dict:
    """Path 14's two-view attempt of `frame` from the reference Tracker's
    state of the frame before, with its features and samples, in both
    packages (`reference_streaming_vi.two_view_compare`)."""
    from openmavis_tpu.frontend import matcher as jmatcher
    import reference_streaming_vi as rsv

    sc = mono_atlas_scene()
    jt = mono_atlas_trackers(sc, False)
    for i in range(frame):
        jt.process_frame(jnp.asarray(sc["seq"][i]), time=i / 20.0)
    f0 = jt._init_feats
    if jt.state != 0 or f0 is None:
        raise SystemExit("frame %d makes no two-view attempt" % frame)
    feats = jt._ext(jnp.asarray(sc["seq"][frame]))
    idx, _ = jmatcher.match_nn(feats.desc, feats.valid, f0.desc, f0.valid,
                               max_dist=jmatcher.TH_LOW, ratio=0.9,
                               mutual=True)
    idx = np.asarray(idx)
    matched = idx >= 0
    x1 = np.asarray(jt._bearing_z1(f0))[np.where(matched, idx, 0)]
    x2 = np.asarray(jt._bearing_z1(feats))
    out = dict(path="mono_atlas", frame=frame, map_id=jt.map_id,
               package="both, from the reference's state")
    out.update(rsv.two_view_compare(np.asarray(jt.key), x1, x2, matched,
                                    float(sc["pin"][0]), 50))
    return out


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    mode = sys.argv[1]
    if mode == "device_merge":
        for out in device_merge([int(a) for a in sys.argv[2:]]
                                or [1, 2, 3]):
            out["package"] = "openmavis_tpu (JAX, CPU)"
            print(json.dumps(out), flush=True)
        return 0
    elif mode == "fresh_start":
        rest = [a for a in sys.argv[2:] if a != "--port"]
        out = fresh_start(int(rest[0]), int(rest[1]) if len(rest) > 1
                          else 24, "--port" in sys.argv)
        out["package"] = ("openmavis_tpu_torch (CPU)" if "--port" in
                          sys.argv else "openmavis_tpu (JAX, CPU)")
        print(json.dumps(out))
        return 0
    elif mode == "multi_tracker_atlas":
        out = multi_tracker_atlas(int(sys.argv[2]) if len(sys.argv) > 2
                                  else N_ATLAS)
    elif mode == "mono_atlas" and "--two-view" in sys.argv:
        print(json.dumps(mono_atlas_two_view(
            int(sys.argv[sys.argv.index("--two-view") + 1]))))
        return 0
    elif mode == "mono_atlas" and "--step-port" in sys.argv:
        span = next((a for a in sys.argv[2:] if a[:1].isdigit()), "0-52")
        a, _, b = span.partition("-")
        print(json.dumps(mono_atlas_step_port(
            set(range(int(a), int(b or a) + 1)))))
        return 0
    elif mode == "mono_atlas":
        out = mono_atlas(port="--port" in sys.argv)
        if "--port" in sys.argv:
            out["package"] = "openmavis_tpu_torch (CPU)"
            print(json.dumps(out))
            return 0
    else:
        raise SystemExit("MODE: device_merge, multi_tracker_atlas, "
                         "mono_atlas or fresh_start")
    out["package"] = "openmavis_tpu (JAX, CPU)"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
