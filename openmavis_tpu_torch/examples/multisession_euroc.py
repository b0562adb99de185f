"""Multi-session EuRoC replay: several sequences through one Atlas (port
of `examples/multisession_euroc.py`; reference: ORB-SLAM3's multi-session
experiments, Atlas::CreateNewMap between sessions and LoopClosing's merge
path re-joining them, src/LoopClosing.cc:1381/1956).

Usage:
    python -m openmavis_tpu_torch.examples.multisession_euroc seq1 seq2
        [...] [--settings cfg.yaml] [--out-dir DIR] [--max-frames N]
        [--device cpu]

Each sequence is a session: the active map is reset before each new
sequence and merge detection welds revisited maps during tracking.
Writes one TUM-format trajectory per session (session0.txt, ...) plus the
final keyframe trajectory (keyframes.txt), all in the final merged frame.
"""

import argparse
import os
import sys
import time

import numpy as np

from .. import resolve_device
from ..io import datasets, settings as cfg_mod, trajectory
from ..pipeline import system
from .common import add_device, add_viewer, system_kwargs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("sequences", nargs="+")
    ap.add_argument("--settings", default=None)
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--max-frames", type=int, default=0)
    add_viewer(ap)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.settings:
        cfg = cfg_mod.load_settings(args.settings, device=dev)["raw"]
    else:
        cfg = cfg_mod.example_settings(n_cams=2)

    slam = system.System(cfg, system.Sensor.IMU_STEREO,
                         **system_kwargs(args, dev))
    if slam.viewer is not None:
        print(f"live viewer: {slam.viewer.url}", file=sys.stderr)
    os.makedirs(args.out_dir, exist_ok=True)

    spans = []
    t0 = time.perf_counter()
    for si, seq_dir in enumerate(args.sequences):
        seq = datasets.load_euroc(seq_dir, cams=("cam0", "cam1"))
        n = seq.n_frames if args.max_frames <= 0 else min(
            args.max_frames, seq.n_frames)
        print(f"session {si}: {seq_dir} ({n} frames)", file=sys.stderr)
        if si > 0:
            # new map in the Atlas; merge detection re-joins on revisit
            # (reference: Atlas::CreateNewMap, Atlas.h:57)
            slam.reset_active_map()
        t_prev = None
        t_start = float(seq.cam_times[0])
        for i in range(n):
            t = float(seq.cam_times[i])
            imu = (seq.imu_between(t_prev, t) if t_prev is not None
                   else np.zeros((0, 7)))
            samples = [(r[1:4], r[4:7], r[0]) for r in imu]
            imgs = seq.frame(i)
            slam.track_multi(imgs, t, imu_samples=samples)
            t_prev = t
        spans.append((t_start, float(seq.cam_times[n - 1])))
        print(f"session {si}: done, maps in atlas = "
              f"{slam.tracker.atlas.n_maps()}", file=sys.stderr)

    dt = time.perf_counter() - t0
    times, R, t = slam.tracker.get_trajectory()
    total = sum(1 for _ in times)
    print(f"replayed {total} frames over {len(args.sequences)} sessions "
          f"in {dt:.1f}s; final maps = {slam.tracker.atlas.n_maps()}",
          file=sys.stderr)

    for si, (ta, tb) in enumerate(spans):
        sel = (times >= ta - 1e-6) & (times <= tb + 1e-6)
        out = os.path.join(args.out_dir, f"session{si}.txt")
        trajectory.save_tum(out, times[sel], R[sel], t[sel])
        print(f"session {si} trajectory -> {out} ({sel.sum()} poses)",
              file=sys.stderr)
    slam.save_keyframe_trajectory_tum(
        os.path.join(args.out_dir, "keyframes.txt"))


if __name__ == "__main__":
    main()
