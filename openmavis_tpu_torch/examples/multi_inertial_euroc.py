"""Multi-camera + IMU replay through the streaming VI tracker (port of
`examples/multi_inertial_euroc.py`).

The flagship MAVIS configuration (reference: Examples/Multi-Inertial/
multi_inertial_euroc.cc + HiltiChallenge2022.yaml): C cameras + IMU, one
tracking step per frame on the device, loop closing at a low host
cadence.

Usage:
    python -m openmavis_tpu_torch.examples.multi_inertial_euroc
        <sequence_dir> [--settings cfg.yaml] [--cams cam0,cam1]
        [--out traj.txt] [--gt groundtruth.txt] [--max-frames N]
        [--lc-every 30] [--device cpu]

Works on any EuRoC-layout directory (EuRoC, TUM-VI, Hilti-2022 converted):
mav0/{camN}/data + data.csv, mav0/imu0/data.csv.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..frontend import extractor
from ..geometry import cameras
from ..imu import preintegration as pre_mod
from ..io import datasets, evaluation, settings as cfg_mod, trajectory
from ..optim.reprojection import RigParams
from ..pipeline import loop_closing, streaming_vi
from .common import add_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sequence")
    ap.add_argument("--settings", default=None)
    ap.add_argument("--cams", default="cam0,cam1")
    ap.add_argument("--out", default="trajectory_tum.txt")
    ap.add_argument("--gt", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--lc-every", type=int, default=30,
                    help="host loop-closing cadence in frames (0 = off)")
    ap.add_argument("--max-kf", type=int, default=64,
                    help="keyframe slab capacity")
    ap.add_argument("--max-mp", type=int, default=16384,
                    help="landmark slab capacity")
    ap.add_argument("--depth-dirs", default=None,
                    help="comma-separated per-camera depth-map dirs "
                         "(reference: the Abs_Depth_undistorted dirs of "
                         "multi_inertial_euroc.cc:55-58; 16-bit PNGs, "
                         "--depth-png-scale units/m, same filenames as "
                         "the camera frames)")
    ap.add_argument("--depth-png-scale", type=float, default=256.0)
    ap.add_argument("--depth-pin", default=None,
                    help="fx,fy,cx,cy of the virtual pinhole the depth "
                         "maps live in (fisheye rigs; default: raw "
                         "camera frame)")
    add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cams = tuple(args.cams.split(","))
    seq = datasets.load_euroc(args.sequence, cams=cams)
    n = seq.n_frames if args.max_frames <= 0 else min(
        args.max_frames, seq.n_frames)
    print(f"loaded {seq.n_frames} frames x {len(cams)} cams; "
          f"replaying {n}", file=sys.stderr)

    if args.settings:
        # this example consumes the PARSED fields directly (unlike the
        # System mains, which pass the raw dict through)
        parsed = cfg_mod.load_settings(args.settings, device=dev)
        rig = parsed["rig"]
        noise = parsed["imu_noise"]
        W, H = parsed["camera_width"], parsed["camera_height"]
        orb = parsed["orb"]
        freq = parsed["imu_frequency"]
        lapping = tuple(map(tuple, parsed["lapping"].tolist()))
        if noise is None:
            noise = pre_mod.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5,
                                                 3e-3, 200.0, device=dev)
    else:
        # EuRoC stereo defaults (reference: Examples/Stereo-Inertial/
        # EuRoC.yaml); replace with --settings for other rigs
        img0 = seq.frame(0)
        H, W = img0.shape[1], img0.shape[2]
        pin = np.array([458.654, 457.296, 367.215, 248.375,
                        0, 0, 0, 0], np.float32)
        C = len(cams)
        base = 0.110074  # EuRoC stereo baseline (m)
        centers = np.zeros((C, 3), np.float32)
        if C >= 2:
            centers[1, 0] = base
        R_cb = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        t_cb = -np.einsum("cij,cj->ci", R_cb, centers)
        rig = RigParams(kind=cameras.PINHOLE,
                        params=torch.as_tensor(np.tile(pin, (C, 1)),
                                               device=dev),
                        R_cb=torch.as_tensor(R_cb, device=dev),
                        t_cb=torch.as_tensor(t_cb, device=dev))
        noise = pre_mod.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5,
                                             3e-3, 200.0, device=dev)
        orb = extractor.OrbConfig(n_features=512, n_levels=8)
        freq = 200.0

    C = len(cams)
    depth_dirs = (args.depth_dirs.split(",") if args.depth_dirs
                  else None)
    if depth_dirs is not None and len(depth_dirs) != C:
        sys.exit("--depth-dirs must name one directory per camera")
    depth_pin = ()
    if args.depth_pin:
        pp = tuple(float(x) for x in args.depth_pin.split(","))
        depth_pin = tuple([pp] * C)

    def load_depths(i):
        """[C, H, W] per-camera metric z-depth for frame i (0 = hole;
        missing file = all holes, matching the reference's zeros
        fallback, multi_inertial_euroc.cc:133-140)."""
        from PIL import Image
        out = np.zeros((C, H, W), np.float32)
        for c, d in enumerate(depth_dirs):
            p = os.path.join(d, seq.cam_files[c][i])
            if os.path.exists(p):
                with Image.open(p) as im:
                    out[c] = (np.asarray(im, np.float32)
                              / args.depth_png_scale)
        return out

    vcfg = streaming_vi.VIStreamConfig(
        img_w=W, img_h=H, n_cams=C,
        stereo_pairs=((0, 1),) if C >= 2 else (),
        lapping=lapping if args.settings else (),
        orb=orb, imu_freq=freq,
        imu_per_frame=max(32, int(2 * freq / 20)),
        use_depth=depth_dirs is not None, depth_pin=depth_pin,
        max_kf=args.max_kf, max_mp=args.max_mp, traj_cap=max(n, 128))
    lc = (loop_closing.LoopCloser(
        None, vcfg.max_kf, rig=rig, inertial=True, img_w=W, img_h=H,
        device=dev)
        if args.lc_every > 0 else None)
    tr = streaming_vi.StreamingVITracker(rig, vcfg, noise, seed=0,
                                         loop_closer=lc, device=dev)

    t_prev = None
    t0 = time.perf_counter()
    for i in range(n):
        t = float(seq.cam_times[i])
        imu = (seq.imu_between(t_prev, t) if t_prev is not None
               else np.zeros((0, 7)))
        samples = [(r[1:4], r[4:7], r[0]) for r in imu]
        tr.push(seq.frame(i), t, samples,
                depth=load_depths(i) if depth_dirs else None)
        t_prev = t
        if args.lc_every > 0 and i and i % args.lc_every == 0:
            tr.maybe_close_loop()
    tr.block()
    dt = time.perf_counter() - t0
    print(f"replayed {n} frames in {dt:.1f}s = {n / dt:.1f} fps "
          f"({tr.n_kf} keyframes, imu_init={tr.imu_initialized})",
          file=sys.stderr)

    t_est, R_est, p_est = tr.get_trajectory()
    trajectory.save_tum(args.out, t_est, R_est, p_est)
    print(f"trajectory -> {args.out}", file=sys.stderr)

    if args.gt:
        t_gt, p_gt = evaluation.load_ground_truth(args.gt)
        res = evaluation.ate_rmse(t_est, p_est, t_gt, p_gt,
                                  with_scale=True)
        print(f"ATE RMSE: {res['rmse']:.4f} m (scale-aligned, "
              f"scale {res['scale']:.4f}); "
              f"no-scale {res['rmse_noscale']:.4f} m", file=sys.stderr)


if __name__ == "__main__":
    main()
