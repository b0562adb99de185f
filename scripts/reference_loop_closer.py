#!/usr/bin/env python3
"""The reference package's flagship tracker with its host-policy loop
closer (`openmavis_tpu`'s `StreamingVITracker(loop_closer=LoopCloser(
None, 64, rig=rig, inertial=True, img_w=640, img_h=480))`, JAX) on the
CPU at the configuration of `chip_smoke.py`'s path 10: the flagship rig
(4 x KannalaBrandt8 at 640 x 480, 4 x 512 ORB features x 8 levels, 400 Hz
IMU), the bench's `VIStreamConfig` on the 64-keyframe / 16,384-landmark
slab, device loop closing off, 280 frames of the flagship orbit continued
at the same angular step, and `maybe_close_loop()` after every push (the
flagship example's `--lc-every 1`). Prints one JSON line with what the
port's path 10 gates on: frames tracked, keyframes, the keyframe count at
which the session vocabulary trained, the sparse-database queries after
it, loops closed, ATE and Horn scale, and the closer's trace (each
solve and group score with its frame).

With `mono_tracker_lc` as its only argument it runs instead the
configuration of `chip_smoke.py`'s path 11, `tests/test_loop_closing.py`'s
own orbit through the reference `Tracker` with a `LoopCloser` on spatial
candidates, and prints that run's line (state, loops, ATE).

Run: JAX_PLATFORMS=cpu python3 scripts/reference_loop_closer.py [N [SEED]]
(N frames, 280 by default; SEED the closer's PRNG seed, 100 by default as
the example builds it; about six minutes and a few GiB on the CPU;
progress every 20 frames on stderr), or
JAX_PLATFORMS=cpu python3 scripts/reference_loop_closer.py mono_tracker_lc
(about four minutes).
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
from openmavis_tpu.pipeline import loop_closing, streaming_vi  # noqa: E402
from openmavis_tpu_torch import scene  # noqa: E402

N_FRAMES = 280


def mono_tracker_lc() -> dict:
    """`tests/test_loop_closing.py::_run_orbit(run_gba=True)`'s
    configuration: BlobWorld seed 3 with 3,000 blobs, a 100-frame orbit
    of radius 6 over 1.25 turns, a 512 x 384 pinhole, 512 x 4-level ORB,
    64 keyframes, 8,192 landmarks, local_map_window 6, spatial loop
    candidates within 0.3, the post-loop GBA on."""
    from openmavis_tpu.geometry import cameras
    from openmavis_tpu.io import synthetic
    from openmavis_tpu.pipeline import tracking

    n, w, h = 100, 512, 384
    pin = np.array([380.0, 380.0, w / 2, h / 2, 0, 0, 0, 0], np.float32)
    rig = RigParams(kind=cameras.PINHOLE, params=jnp.asarray(pin)[None],
                    R_cb=jnp.eye(3)[None], t_cb=jnp.zeros((1, 3)))
    world = synthetic.BlobWorld.create(seed=3, n=3000)
    R_wc, t_wc = synthetic.orbit_trajectory(n, radius=6.0, frac=1.25)
    frames = synthetic.render_sequence(world, cameras.PINHOLE, pin, R_wc,
                                       t_wc, w, h)
    cfg = tracking.TrackerConfig(
        img_w=w, img_h=h, orb=extractor.OrbConfig(n_features=512,
                                                  n_levels=4),
        max_kf=64, max_mp=8192, local_map_window=6)
    lc = loop_closing.LoopCloser(
        None, cfg.max_kf, loop_closing.LoopConfig(
            candidate_source="spatial", spatial_radius=0.3, run_gba=True),
        rig=rig, img_w=w, img_h=h)
    tr = tracking.Tracker(rig, cfg, seed=0, loop_closer=lc)
    closed_at = []
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        loops = lc.n_loops
        tr.process_frame(jnp.asarray(img), time=i / 20.0)
        if lc.n_loops > loops:
            closed_at.append(i)
    t_est, _, p_est = tr.get_trajectory()
    res = evaluation.ate_rmse(t_est, p_est, np.arange(n) / 20.0, t_wc,
                              with_scale=True)
    return {"package": "openmavis_tpu (JAX, CPU)",
            "path": "mono_tracker_lc", "frames": n,
            "state_ok_at_end": tr.state == tr.OK, "n_keyframes": tr.n_kf,
            "loop_closures": int(lc.n_loops), "closed_at_frames": closed_at,
            "ate_rmse_m": float(res["rmse"]),
            "horn_scale": float(res["scale"]),
            "run_s": time.perf_counter() - t0}


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1:] == ["mono_tracker_lc"]:
        print(json.dumps(mono_tracker_lc()))
        return 0
    n = int(sys.argv[1]) if len(sys.argv) > 1 else N_FRAMES
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    rig_np, frames, _, t_wb, batches = scene.make_sequence(
        n, orbit_frac=1.25 * (n - 1) / (scene.N_FRAMES - 1),
        kind_name="kb8")
    rig = RigParams(rig_np["kind"], *(jnp.asarray(rig_np[k])
                                      for k in ("params", "R_cb", "t_cb")))
    cfg = streaming_vi.VIStreamConfig(
        orb=extractor.OrbConfig(n_features=512, n_levels=8),
        **scene.bench_config_kwargs(n))
    lc = loop_closing.LoopCloser(None, cfg.max_kf, seed=seed, rig=rig,
                                 inertial=True, img_w=cfg.img_w,
                                 img_h=cfg.img_h)
    # count the retrievals that go to the sparse keyframe database
    queries = {"sparse": 0, "dense": 0}
    candidates = lc._candidates

    def counted(m, slot, cov):
        queries["sparse" if lc.vocab is not None else "dense"] += 1
        return candidates(m, slot, cov)

    lc._candidates = counted
    # what each stage of the closer decided, with the frame it came in
    trace = []
    frame = [None]
    solve, group = lc._solve_pair, lc._group_score

    def traced_solve(m, slot, cand):
        res = solve(m, slot, cand)
        trace.append(dict(frame=frame[0], slot=slot, cand=cand,
                          stage="solve", ok=res is not None,
                          inliers=None if res is None
                          else int(res.n_inliers)))
        return res

    def traced_group(m, slot, cand, cov, s, R, t):
        score = group(m, slot, cand, cov, s, R, t)
        trace.append(dict(frame=frame[0], slot=slot, cand=cand,
                          stage="group", score=int(score)))
        return score

    lc._solve_pair, lc._group_score = traced_solve, traced_group
    tr = streaming_vi.StreamingVITracker(
        rig, cfg, pre_mod.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS), seed=0,
        loop_closer=lc)
    vocab_kf = None
    closed_at = []
    t0 = time.perf_counter()
    for i in range(n):
        t, b = batches[i]
        tr.push(frames[i].astype(np.float32), t, b)
        frame[0] = i
        if tr.maybe_close_loop():
            closed_at.append(i)
        if vocab_kf is None and lc.vocab is not None:
            vocab_kf = tr.n_kf
        if (i + 1) % 20 == 0:
            print(json.dumps(dict(
                frame=i, n_keyframes=tr.n_kf, loops=lc.n_loops,
                vocab_kf=vocab_kf, queries=queries,
                s=round(time.perf_counter() - t0, 1))),
                file=sys.stderr, flush=True)
    snap = tr.snapshot()
    t_est, _, p_est = tr.get_trajectory()
    ok = np.asarray(snap["ok"])[:len(t_est)]
    res = evaluation.ate_rmse(t_est[ok], p_est[ok],
                              np.arange(n) / scene.FPS_IN, t_wb,
                              with_scale=True)
    print(json.dumps({
        "package": "openmavis_tpu (JAX, CPU)", "frames": n, "seed": seed,
        "frames_tracked": int(ok.sum()), "n_keyframes": int(snap["n_kf"]),
        "n_landmarks": int(snap["n_mp"]),
        "imu_initialized": bool(snap["imu_ok"]),
        "vocab_trained_at_n_kf": vocab_kf,
        "sparse_queries": queries["sparse"],
        "dense_queries": queries["dense"],
        "loop_closures": int(lc.n_loops), "closed_at_frames": closed_at,
        "ate_rmse_m": float(res["rmse"]),
        "ate_rmse_noscale_m": float(res["rmse_noscale"]),
        "horn_scale": float(res["scale"]),
        "run_s": time.perf_counter() - t0, "lc_trace": trace}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
