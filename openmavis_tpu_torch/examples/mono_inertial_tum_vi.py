"""Monocular-inertial TUM-VI replay (port of
`examples/mono_inertial_tum_vi.py`; reference:
Examples/Monocular-Inertial/mono_inertial_tum_vi.cc).

Usage:
    python -m openmavis_tpu_torch.examples.mono_inertial_tum_vi
        <sequence_dir> [--settings cfg.yaml] [--out trajectory_tum.txt]
        [--gt groundtruth.txt] [--max-frames N] [--device cpu]

<sequence_dir> is a TUM-VI directory in the EuRoC layout (mav0/cam0 +
mav0/imu0); the default calibration is the 512 px KannalaBrandt8 camera.
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

    seq = datasets.load_tumvi(args.sequence, cams=("cam0",))
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} frames; replaying {n}", file=sys.stderr)

    if args.settings:
        # keep the RAW dict: System re-parses it
        cfg = cfg_mod.load_settings(args.settings, device=dev)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=1)
        img0 = seq.frame(0)[0]
        cfg["Camera"]["width"] = img0.shape[1]
        cfg["Camera"]["height"] = img0.shape[0]
        # TUM-VI 512 fisheye (reference: Examples/Monocular-Inertial/
        # TUM-VI.yaml): KannalaBrandt8
        cfg["Camera"]["type"] = "KannalaBrandt8"
        cfg["Camera1"].update(
            fx=190.978477, fy=190.973307, cx=254.931706, cy=256.897442,
            k1=0.003482389402, k2=0.000715034845,
            k3=-0.002053236141, k4=0.000202936736)
        cfg["IMU"].update(NoiseGyro=0.00016, NoiseAcc=0.0028,
                          GyroWalk=0.000022, AccWalk=0.00086,
                          Frequency=200.0)

    slam = system.System(cfg, system.Sensor.IMU_MONOCULAR,
                         **system_kwargs(args, dev))
    if slam.viewer is not None:
        print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
    t_prev = None
    t0 = time.perf_counter()
    for i in range(n):
        t = float(seq.cam_times[i])
        imu = (seq.imu_between(t_prev, t) if t_prev is not None
               else np.zeros((0, 7)))
        samples = [(r[1:4], r[4:7], r[0]) for r in imu]
        slam.track_monocular(seq.frame(i)[0], t, imu_samples=samples)
        t_prev = t
    dt = time.perf_counter() - t0
    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps "
          f"(imu_init={slam.tracker.imu_initialized})", file=sys.stderr)

    slam.save_trajectory_tum(args.out)
    print(f"trajectory -> {args.out}", file=sys.stderr)

    if args.gt:
        t_gt, p_gt = evaluation.load_ground_truth(args.gt)
        traj = np.loadtxt(args.out)
        res = evaluation.ate_rmse(traj[:, 0], traj[:, 1:4], t_gt, p_gt,
                                  with_scale=True)
        print(f"ATE RMSE: {res['rmse']:.4f} m (scale {res['scale']:.4f})",
              file=sys.stderr)


if __name__ == "__main__":
    main()
