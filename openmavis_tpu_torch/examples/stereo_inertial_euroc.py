"""Stereo-inertial EuRoC replay (port of
`examples/stereo_inertial_euroc.py`; reference:
Examples/Stereo-Inertial/stereo_inertial_euroc.cc).

Usage:
    python -m openmavis_tpu_torch.examples.stereo_inertial_euroc
        <sequence_dir> [--settings cfg.yaml] [--out trajectory_tum.txt]
        [--gt groundtruth.txt] [--max-frames N] [--device cpu]

<sequence_dir> is an EuRoC-format directory (mav0/cam0, cam1, imu0).
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
    add_viewer(ap)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    seq = datasets.load_euroc(args.sequence, cams=("cam0", "cam1"))
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} stereo pairs + {len(seq.imu)} IMU "
          f"samples; replaying {n}", file=sys.stderr)

    if args.settings:
        # keep the RAW dict: System re-parses it
        cfg = cfg_mod.load_settings(args.settings, device=dev)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=2)
        img0 = seq.frame(0)[0]
        cfg["Camera"]["width"] = img0.shape[1]
        cfg["Camera"]["height"] = img0.shape[0]
        cfg["Camera1"].update(fx=458.654, fy=457.296, cx=367.215,
                              cy=248.375)
        cfg["Camera2"].update(fx=457.587, fy=456.134, cx=379.999,
                              cy=255.238)
        T = np.eye(4)
        T[0, 3] = 0.11
        cfg["Camera2"]["T_b_c"] = T.tolist()
        # EuRoC ADIS16448 IMU (reference: Examples/Stereo-Inertial/
        # EuRoC.yaml)
        cfg["IMU"] = {"NoiseGyro": 1.7e-4, "NoiseAcc": 2.0e-3,
                      "GyroWalk": 1.9e-5, "AccWalk": 3.0e-3,
                      "Frequency": 200.0}

    slam = system.System(cfg, system.Sensor.IMU_STEREO,
                         **system_kwargs(args, dev))
    if slam.viewer is not None:
        print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
    t_prev = float(seq.cam_times[0]) - 1e-3
    t0 = time.perf_counter()
    for i in range(n):
        t = float(seq.cam_times[i])
        batch = [(row[1:4], row[4:7], row[0])
                 for row in seq.imu_between(t_prev, t)]
        imgs = seq.frame(i)
        slam.track_stereo(imgs[0], imgs[1], t, imu_samples=batch)
        t_prev = t
    dt = time.perf_counter() - t0
    slam.save_trajectory_tum(args.out)
    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps; "
          f"imu_initialized={slam.tracker.imu_initialized}",
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
