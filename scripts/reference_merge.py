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
                        of the orbit, 5 black frames, the 24 again

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


def mono_atlas() -> dict:
    from openmavis_tpu.geometry import cameras
    from openmavis_tpu.io import synthetic
    from openmavis_tpu.pipeline import tracking

    W, H = 512, 384
    pin = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
    rig = RigParams(kind=cameras.PINHOLE, params=jnp.asarray(pin)[None],
                    R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    R_wc, t_wc = synthetic.orbit_trajectory(N_MONO_PASS, radius=6.0,
                                            frac=0.2)
    orbit = synthetic.render_sequence(world, cameras.PINHOLE, pin, R_wc,
                                      t_wc, W, H)
    seq = (list(orbit) + [np.zeros_like(orbit[0])] * N_MONO_BLACK
           + list(orbit))
    gt = np.concatenate([t_wc, np.zeros((N_MONO_BLACK, 3)), t_wc])
    cfg = tracking.TrackerConfig(
        img_w=W, img_h=H, orb=extractor.OrbConfig(n_features=512,
                                                  n_levels=4),
        max_kf=32, max_mp=8192, max_lost_frames=3)
    atlas = atlas_mod.Atlas()
    lc = loop_closing.LoopCloser(None, 32, rig=rig)
    tr = tracking.Tracker(rig, cfg, seed=0, loop_closer=lc, atlas=atlas)
    oks, events = [], []
    last = dict(maps=1, merges=0)
    t0 = time.perf_counter()
    for i, img in enumerate(seq):
        oks.append(bool(tr.process_frame(jnp.asarray(img), time=i / 20.0)))
        now = dict(maps=atlas.n_maps(), merges=lc.n_merges)
        if now != last:
            events.append(dict(frame=i, n_kf=tr.n_kf, map_id=tr.map_id,
                               state=tr.state, **now))
            _log(**events[-1], s=time.perf_counter() - t0)
        last = now
    t_est, _, p_est = tr.get_trajectory()
    ok = np.asarray(oks)
    res = _ate(t_est, p_est, ok, np.arange(len(seq)) / 20.0, gt)
    return {
        "path": "mono_atlas", "frames": len(seq),
        "frames_tracked": int(ok.sum()), "events": events,
        "n_maps": atlas.n_maps(), "n_merges": lc.n_merges,
        "n_loops": lc.n_loops, "n_kf": tr.n_kf,
        "trajectory_finite": bool(np.isfinite(p_est).all()),
        "ate_rmse_m": float(res["rmse"]),
        "horn_scale": float(res["scale"]),
        "run_s": time.perf_counter() - t0}


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    mode = sys.argv[1]
    if mode == "device_merge":
        for out in device_merge([int(a) for a in sys.argv[2:]]
                                or [1, 2, 3]):
            out["package"] = "openmavis_tpu (JAX, CPU)"
            print(json.dumps(out), flush=True)
        return 0
    elif mode == "multi_tracker_atlas":
        out = multi_tracker_atlas(int(sys.argv[2]) if len(sys.argv) > 2
                                  else N_ATLAS)
    elif mode == "mono_atlas":
        out = mono_atlas()
    else:
        raise SystemExit("MODE: device_merge, multi_tracker_atlas or "
                         "mono_atlas")
    out["package"] = "openmavis_tpu (JAX, CPU)"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
