"""RGB-D-inertial replay (port of `examples/rgbd_inertial.py`; reference:
Examples/RGB-D-Inertial/rgbd_inertial_realsense_D435i.cc, replayed from
disk).

Usage:
    python -m openmavis_tpu_torch.examples.rgbd_inertial <sequence_dir>
        [--settings cfg.yaml] [--out trajectory_tum.txt]
        [--gt groundtruth.txt] [--max-frames N] [--depth-scale 5000]
        [--device cpu]

<sequence_dir> is a TUM RGB-D layout with an imu.txt
("t wx wy wz ax ay az" lines).
"""

import argparse
import sys
import time

import numpy as np

from .. import resolve_device
from ..io import datasets, evaluation, settings as cfg_mod
from ..pipeline import system
from .common import add_device, add_viewer, system_kwargs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--settings", default=None)
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--depth-scale", type=float, default=5000.0)
    add_viewer(ap)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    seq = datasets.load_tum_rgbd(args.sequence,
                                 depth_scale=args.depth_scale)
    if seq.imu is None:
        print("no imu.txt in sequence dir — use "
              "openmavis_tpu_torch.examples.rgbd_tum for vision-only RGB-D",
              file=sys.stderr)
        sys.exit(2)
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} rgb-d pairs + {len(seq.imu)} imu "
          f"samples; replaying {n}", file=sys.stderr)

    if args.settings:
        cfg = cfg_mod.load_settings(args.settings, device=dev)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=1)
        gray0, _ = seq.frame(0)
        cfg["Camera"]["width"] = gray0.shape[1]
        cfg["Camera"]["height"] = gray0.shape[0]

    slam = system.System(cfg, system.Sensor.IMU_RGBD,
                         **system_kwargs(args, dev))
    if slam.viewer is not None:
        print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
    t_prev = None
    t0 = time.perf_counter()
    for i in range(n):
        gray, depth = seq.frame(i)
        t = float(seq.times[i])
        samples = []
        if t_prev is not None:
            for row in seq.imu_between(t_prev, t):
                samples.append((row[1:4], row[4:7], row[0]))
        slam.track_rgbd(gray, depth, t, imu_samples=samples)
        t_prev = t
    dt = time.perf_counter() - t0
    slam.save_trajectory_tum(args.out)
    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps",
          file=sys.stderr)
    print(f"trajectory -> {args.out}", file=sys.stderr)

    if args.gt:
        traj = np.loadtxt(args.out)
        t_gt, p_gt = evaluation.load_ground_truth(args.gt)
        res = evaluation.ate_rmse(traj[:, 0], traj[:, 1:4], t_gt, p_gt,
                                  with_scale=False)
        print(f"ATE RMSE: {res['rmse']:.4f} m (metric scale)",
              file=sys.stderr)


if __name__ == "__main__":
    main()
