"""RGB-D TUM replay (port of `examples/rgbd_tum.py`; reference:
Examples/RGB-D/rgbd_tum.cc).

Usage:
    python -m openmavis_tpu_torch.examples.rgbd_tum <sequence_dir>
        [--settings cfg.yaml] [--out trajectory_tum.txt]
        [--gt groundtruth.txt] [--max-frames N] [--depth-scale 5000]
        [--device cpu]

<sequence_dir> is a TUM RGB-D sequence (rgb.txt, depth.txt, 16-bit depth
PNGs at --depth-scale units per metre).
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
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} associated rgb-d pairs; replaying {n}",
          file=sys.stderr)

    if args.settings:
        # keep the RAW dict: System re-parses it
        cfg = cfg_mod.load_settings(args.settings, device=dev)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=1)
        gray0, _ = seq.frame(0)
        cfg["Camera"]["width"] = gray0.shape[1]
        cfg["Camera"]["height"] = gray0.shape[0]
        # TUM RGB-D freiburg default intrinsics (reference:
        # Examples/RGB-D/TUM1.yaml)
        cfg["Camera1"].update(fx=517.306408, fy=516.469215,
                              cx=318.643040, cy=255.313989)

    slam = system.System(cfg, system.Sensor.RGBD,
                         **system_kwargs(args, dev))
    if slam.viewer is not None:
        print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
    t0 = time.perf_counter()
    for i in range(n):
        gray, depth = seq.frame(i)
        slam.track_rgbd(gray, depth, float(seq.times[i]))
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
