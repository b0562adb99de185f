"""Monocular TUM replay (port of `examples/mono_tum.py`; reference:
Examples/Monocular/mono_tum.cc).

Usage:
    python -m openmavis_tpu_torch.examples.mono_tum <sequence_dir>
        [--settings cfg.yaml] [--out trajectory_tum.txt]
        [--gt groundtruth.txt] [--max-frames N] [--device cpu]

<sequence_dir> is a TUM RGB-D sequence; only its rgb stream is read
(rgb.txt: "t path" lines).
"""

import argparse
import os
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

    # rgb stream of the TUM layout (rgb.txt: "t path" lines)
    ts, files = [], []
    with open(os.path.join(args.sequence, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, p = line.split()[:2]
            ts.append(float(t))
            files.append(p)
    n = len(ts) if args.max_frames <= 0 else min(args.max_frames,
                                                 len(ts))
    print(f"loaded {len(ts)} frames; replaying {n}", file=sys.stderr)

    if args.settings:
        cfg = cfg_mod.load_settings(args.settings, device=dev)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=1)
        img0 = datasets.load_gray(os.path.join(args.sequence, files[0]))
        cfg["Camera"]["width"] = img0.shape[1]
        cfg["Camera"]["height"] = img0.shape[0]
        # TUM freiburg1 intrinsics (reference: Examples/Monocular/
        # TUM1.yaml)
        cfg["Camera1"].update(fx=517.306408, fy=516.469215,
                              cx=318.643040, cy=255.313989)

    slam = system.System(cfg, system.Sensor.MONOCULAR,
                         **system_kwargs(args, dev))
    if slam.viewer is not None:
        print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
    t0 = time.perf_counter()
    for i in range(n):
        img = datasets.load_gray(os.path.join(args.sequence, files[i]))
        slam.track_monocular(img, ts[i])
    dt = time.perf_counter() - t0
    slam.save_trajectory_tum(args.out)
    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps",
          file=sys.stderr)
    print(f"trajectory -> {args.out}", file=sys.stderr)

    if args.gt:
        traj = np.loadtxt(args.out)
        t_gt, p_gt = evaluation.load_ground_truth(args.gt)
        res = evaluation.ate_rmse(traj[:, 0], traj[:, 1:4], t_gt, p_gt,
                                  with_scale=True)
        print(f"ATE RMSE (scale-aligned): {res['rmse']:.4f} m, "
              f"scale {res['scale']:.4f}", file=sys.stderr)


if __name__ == "__main__":
    main()
