"""Stereo KITTI replay (port of `examples/stereo_kitti.py`; reference:
Examples/Stereo/stereo_kitti.cc).

Usage:
    python -m openmavis_tpu_torch.examples.stereo_kitti <sequence_dir>
        [--settings cfg.yaml] [--out trajectory_kitti.txt]
        [--max-frames N] [--device cpu]

<sequence_dir> is a KITTI odometry sequence (times.txt + image_0/ +
image_1/); the trajectory is written in the KITTI format.
"""

import argparse
import sys
import time

import numpy as np

from .. import resolve_device
from ..io import datasets, settings as cfg_mod
from ..pipeline import system
from .common import add_device, add_viewer, system_kwargs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--settings", default=None)
    ap.add_argument("--out", default="trajectory_kitti.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    add_viewer(ap)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    seq = datasets.load_kitti(args.sequence, cams=("image_0", "image_1"))
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} stereo pairs; replaying {n}",
          file=sys.stderr)

    if args.settings:
        # keep the RAW dict: System re-parses it
        cfg = cfg_mod.load_settings(args.settings, device=dev)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=2)
        img0 = seq.frame(0)[0]
        cfg["Camera"]["width"] = img0.shape[1]
        cfg["Camera"]["height"] = img0.shape[0]
        for c in ("Camera1", "Camera2"):
            cfg[c].update(fx=718.856, fy=718.856, cx=607.1928,
                          cy=185.2157)
        T = np.eye(4)
        T[0, 3] = 0.5372    # KITTI 00-02 stereo baseline (meters)
        cfg["Camera2"]["T_b_c"] = T.tolist()

    slam = system.System(cfg, system.Sensor.STEREO,
                         **system_kwargs(args, dev))
    if slam.viewer is not None:
        print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
    t0 = time.perf_counter()
    for i in range(n):
        imgs = seq.frame(i)
        slam.track_stereo(imgs[0], imgs[1], float(seq.cam_times[i]))
    dt = time.perf_counter() - t0

    # KITTI-format trajectory (reference: System::SaveTrajectoryKITTI,
    # src/System.cc: a 3x4 row-major pose per line, camera frame)
    slam.save_trajectory_kitti(args.out)
    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps",
          file=sys.stderr)
    print(f"trajectory -> {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
