#!/usr/bin/env python3
"""The reference package's one-camera visual trackers (`openmavis_tpu`'s
`tracking.Tracker` and `streaming.StreamingTracker`, JAX) on the CPU at
the configurations of `chip_smoke.py`'s paths 7-9, so that the port's
runs on the GPU have a reference row:

* `mono_tracker`: `Tracker` as `System` builds it for MONOCULAR on the
  EuRoC camera of ORB-SLAM3's Examples/Monocular/EuRoC.yaml (752 x 480,
  radtan, the images rendered distorted, `dist` given), 1,000 ORB x 8
  levels, `TrackerConfig`'s defaults (64 keyframes, 8,192 landmarks),
  100 frames of the single-camera orbit, frames 60-63 black;
* `rgbd_tracker`: `Tracker` with depth maps (RGBD) on the 640 x 480
  pinhole of the RGB-D path, 1,000 x 8, `TrackerConfig`'s defaults, 80
  frames;
* `mono_streaming`: `StreamingTracker` as `examples/mono_euroc.py
  --streaming` builds it: the EuRoC pinhole without distortion (the images
  rendered undistorted), 1,000 x 8, 64 keyframes, 16,384 landmarks, 80
  frames.

Prints one JSON line with what the port's path gates on: the init frame,
frames tracked, LOST frames and the first tracked frame after the
blackout, keyframes, landmarks, and ATE with and without Horn scale over
the tracked frames.

Run: JAX_PLATFORMS=cpu python3 scripts/reference_tracker.py PATH [N [SEED]]
(PATH one of mono_tracker, rgbd_tracker, mono_streaming; N frames, the
path's own count by default; SEED the tracker's PRNG seed, 0 by default,
as the port's paths use; about a minute and a few GiB each).
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
from openmavis_tpu.io import evaluation  # noqa: E402
from openmavis_tpu.optim.reprojection import RigParams  # noqa: E402
from openmavis_tpu.pipeline import streaming, tracking  # noqa: E402
from openmavis_tpu_torch import scene  # noqa: E402

FRAMES = dict(mono_tracker=100, rgbd_tracker=80, mono_streaming=80)
BLACKOUT = range(60, 64)
ORB = dict(n_features=1000, n_levels=8)


def setup(path: str, n: int):
    """(rig, frames [T, h, w] float32, depth maps or None, t_wb, dist)."""
    mono = path != "rgbd_tracker"
    w, h = ((scene.EUROC_W, scene.EUROC_H) if mono
            else (scene.RGBD_W, scene.RGBD_H))
    pin = scene.EUROC_PINHOLE if mono else scene.RGBD_PINHOLE
    dist = scene.EUROC_RADTAN if path == "mono_tracker" else None
    rig_np, frames, _, t_wb, _, depths = scene.make_single_camera_sequence(
        n, 1.25 * (n - 1) / (scene.N_FRAMES - 1), w, h, pin, dist=dist,
        depth=not mono)
    frames = frames[:, 0].astype(np.float32)
    if path == "mono_tracker":
        frames[list(BLACKOUT)] = 0
    rig = RigParams(rig_np["kind"], *(jnp.asarray(rig_np[k])
                                      for k in ("params", "R_cb", "t_cb")))
    return (rig, frames, None if depths is None else depths[:, 0], t_wb,
            None if dist is None else np.asarray(dist, np.float32)[None])


def ate(t_est, p_est, ok, t_wb) -> dict:
    n = len(ok)
    return evaluation.ate_rmse(t_est[ok], p_est[ok],
                               np.arange(n) / scene.FPS_IN, t_wb[:n],
                               with_scale=True)


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    path = sys.argv[1]
    n = int(sys.argv[2]) if len(sys.argv) > 2 else FRAMES[path]
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 0
    rig, frames, depths, t_wb, dist = setup(path, n)
    w, h = frames.shape[2], frames.shape[1]
    orb = extractor.OrbConfig(**ORB)
    oks, n_kf = [], []
    t0 = time.perf_counter()
    if path == "mono_streaming":
        cfg = streaming.StreamConfig(img_w=w, img_h=h, orb=orb, max_kf=64,
                                     max_mp=16384, traj_cap=max(n, 64))
        tr = streaming.StreamingTracker(rig, cfg, seed=seed)
        for i in range(n):
            tr.push(jnp.asarray(frames[i]), i / scene.FPS_IN)
            n_kf.append(tr.n_kf)
        tr.block()
        oks = [bool(x) for x in np.asarray(tr.carry.traj.ok[:n])]
        n_mp = int(tr.map.n_mp)
    else:
        cfg = tracking.TrackerConfig(img_w=w, img_h=h, orb=orb)
        tr = tracking.Tracker(rig, cfg, seed=seed, dist=dist)
        for i in range(n):
            dep = None if depths is None else jnp.asarray(depths[i])
            oks.append(bool(tr.process_frame(jnp.asarray(frames[i]),
                                             i / scene.FPS_IN, depth=dep)))
            n_kf.append(tr.n_kf)
            if (i + 1) % 20 == 0:
                print(json.dumps(dict(frame=i, tracked=sum(oks),
                                      n_keyframes=tr.n_kf)),
                      file=sys.stderr, flush=True)
        n_mp = int(tr.map.n_mp)
    t_est, _, p_est = tr.get_trajectory()
    ok = np.asarray(oks)
    res = ate(t_est, p_est, ok, t_wb)
    lost = [i for i in range(n) if not ok[i] and n_kf[i] > 0]
    back = next((i for i in range(BLACKOUT[-1] + 1, n) if ok[i]), None)
    steps = np.linalg.norm(np.diff(t_wb[:n], axis=0), axis=1)
    print(json.dumps({
        "package": "openmavis_tpu (JAX, CPU)", "path": path, "frames": n,
        "seed": seed,
        "init_frame": int(np.argmax(ok)) if ok.any() else None,
        "frames_tracked": int(ok.sum()),
        "frames_tracked_from_3": int(ok[3:].sum()),
        "lost_frames": lost,
        "first_tracked_after_blackout": (back if path == "mono_tracker"
                                         else None),
        "n_keyframes": int(n_kf[-1]), "n_landmarks": n_mp,
        "ate_rmse_m": float(res["rmse"]),
        "ate_rmse_noscale_m": float(res["rmse_noscale"]),
        "horn_scale": float(res["scale"]),
        "path_length_m": float(steps.sum()),
        "run_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
