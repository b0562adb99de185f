"""Monocular EuRoC replay (port of `examples/mono_euroc.py`; reference:
Examples/Monocular/mono_euroc.cc).

Usage:
    python -m openmavis_tpu_torch.examples.mono_euroc <sequence_dir>
        [--settings cfg.yaml] [--out trajectory_tum.txt]
        [--gt groundtruth.txt] [--max-frames N] [--streaming]
        [--device cpu]

<sequence_dir> is an EuRoC-format directory (mav0/cam0/data + data.csv).
With --gt (TUM-format `t x y z qx qy qz qw` or EuRoC state estimate csv),
prints the ATE RMSE (the reference's evaluation/evaluate_ate_scale.py
semantics, `io.evaluation`).

--streaming replays through the one-camera streaming tracker
(`pipeline.streaming.StreamingTracker`) instead of the host-policy
System facade.
"""

import argparse
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..frontend import extractor
from ..geometry import cameras
from ..io import datasets, evaluation, settings as cfg_mod, trajectory
from ..optim.reprojection import RigParams
from ..pipeline import streaming, system
from .common import add_device, add_viewer, system_kwargs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--settings", default=None)
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--streaming", action="store_true")
    add_viewer(ap)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    seq = datasets.load_euroc(args.sequence, cams=("cam0",))
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} frames; replaying {n}", file=sys.stderr)

    if args.settings:
        # keep the RAW dict: System re-parses it (and the example
        # indexes raw Camera*/ORBextractor keys)
        cfg = cfg_mod.load_settings(args.settings, device=dev)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=1)
        img0 = seq.frame(0)[0]
        cfg["Camera"]["width"] = img0.shape[1]
        cfg["Camera"]["height"] = img0.shape[0]
        # EuRoC cam0 calibration (reference: Examples/Monocular/EuRoC.yaml)
        cfg["Camera1"].update(fx=458.654, fy=457.296, cx=367.215,
                              cy=248.375)

    if args.streaming:
        c1 = cfg["Camera1"]
        pin = np.array([c1["fx"], c1["fy"], c1["cx"], c1["cy"],
                        0, 0, 0, 0], np.float32)
        rig = RigParams(kind=cameras.PINHOLE,
                        params=torch.as_tensor(pin, device=dev)[None],
                        R_cb=torch.eye(3, device=dev)[None],
                        t_cb=torch.zeros((1, 3), device=dev))
        scfg = streaming.StreamConfig(
            img_w=cfg["Camera"]["width"], img_h=cfg["Camera"]["height"],
            orb=extractor.OrbConfig(
                n_features=cfg["ORBextractor"]["nFeatures"],
                n_levels=cfg["ORBextractor"]["nLevels"]),
            max_kf=64, max_mp=16384, traj_cap=max(n, 64))
        tr = streaming.StreamingTracker(rig, scfg, seed=0, device=dev)
        t0 = time.perf_counter()
        for i in range(n):
            # one host -> device copy of each frame
            tr.push(torch.from_numpy(seq.frame(i)[0]).to(dev),
                    float(seq.cam_times[i]))
        tr.block()
        dt = time.perf_counter() - t0
        t_est, R_est, p_est = tr.get_trajectory()
        trajectory.save_tum(args.out, t_est, R_est, p_est)
    else:
        slam = system.System(cfg, system.Sensor.MONOCULAR,
                             **system_kwargs(args, dev))
        if slam.viewer is not None:
            print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
        t0 = time.perf_counter()
        for i in range(n):
            slam.track_monocular(seq.frame(i)[0], float(seq.cam_times[i]))
        dt = time.perf_counter() - t0
        slam.save_trajectory_tum(args.out)
        traj = np.loadtxt(args.out)
        t_est, p_est = traj[:, 0], traj[:, 1:4]

    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps",
          file=sys.stderr)
    print(f"trajectory -> {args.out}", file=sys.stderr)

    if args.gt:
        t_gt, p_gt = evaluation.load_ground_truth(args.gt)
        res = evaluation.ate_rmse(t_est, p_est, t_gt, p_gt,
                                  with_scale=True)
        print(f"ATE RMSE (scale-aligned): {res['rmse']:.4f} m, "
              f"scale {res['scale']:.4f}", file=sys.stderr)


if __name__ == "__main__":
    main()
