#!/usr/bin/env python3
"""The reference package's host-policy rig tracker (`openmavis_tpu`'s
`MultiTracker`, JAX) on the CPU at the configuration of `chip_smoke.py`'s
path 5: the flagship rig and scene (4 x KannalaBrandt8 at 640 x 480,
4 x 512 ORB features x 8 levels, 400 Hz IMU fed sample by sample, 160
frames) with the bench's values where `MultiTrackerConfig` has the field,
no atlas and no loop closer. Prints one JSON line with the content the
port's path 5 gates on (frames tracked, keyframes, landmarks, IMU init,
ATE, Horn scale), so that the port's run on the GPU has a reference row.

Run: JAX_PLATFORMS=cpu python3 scripts/reference_multi_tracker.py [N]
[field=value ...] [--port]   (N frames, 160 by default; each field=value
sets a `MultiTrackerConfig` field, e.g. kf_min_inliers_abs=60, or one of
the two schedules `MultiTracker` hard-codes: po_rounds=R / po_iters=I
(the pose optimization, 4 x 7; the streaming tracker's bench runs 2 x 6)
and ba_stages=(A,B) (the VI window BA, (4, 6); the bench's (3, 4)), set
by wrapping `multi_tracking.track_step_multi_vi` / `track_step_multi` and
`vi_window_ba_step` with `functools.partial` while the run lasts; about
seven minutes and a few GiB on the CPU). --port runs the port's
`MultiTracker` on the CPU instead (`TORCH_THREADS` torch threads, 4 by
default; about fifteen minutes). The line carries the ATE (Horn scale)
of the trajectory so far every 20 frames (`progress`), frame 79's as
`ate_rmse_m_frame79`.
"""

import ast
import functools

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
from openmavis_tpu.imu import preintegration as pre_mod  # noqa: E402
from openmavis_tpu.io import evaluation  # noqa: E402
from openmavis_tpu.optim.reprojection import RigParams  # noqa: E402
from openmavis_tpu.pipeline import multi_tracking  # noqa: E402
from openmavis_tpu_torch import scene  # noqa: E402

# the schedules MultiTracker hard-codes, set by wrapping its functions
SCHEDULES = ("po_rounds", "po_iters", "ba_stages")


def set_schedules(mod, sched: dict) -> None:
    """Wrap `mod`'s (either package's `multi_tracking`) pose-optimization
    and window-BA steps with the `sched` keywords; the tracker looks them
    up as module globals on each call."""
    po = {k: sched[k] for k in ("po_rounds", "po_iters") if k in sched}
    if po:
        for name in ("track_step_multi_vi", "track_step_multi"):
            setattr(mod, name, functools.partial(getattr(mod, name), **po))
    if "ba_stages" in sched:
        mod.vi_window_ba_step = functools.partial(
            mod.vi_window_ba_step, stages=tuple(sched["ba_stages"]))


def trackers(port: bool, rig_np, kw: dict):
    """The MultiTracker of either package at path 5's configuration."""
    if not port:
        rig = RigParams(rig_np["kind"], *(jnp.asarray(rig_np[k]) for k in
                                          ("params", "R_cb", "t_cb")))
        cfg = multi_tracking.MultiTrackerConfig(
            orb=extractor.OrbConfig(n_features=512, n_levels=8), **kw)
        return multi_tracking, multi_tracking.MultiTracker(
            rig, cfg, pre_mod.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS),
            seed=0)
    import torch
    from openmavis_tpu_torch import convert
    from openmavis_tpu_torch.frontend import extractor as tex
    from openmavis_tpu_torch.imu import preintegration as tpre
    from openmavis_tpu_torch.pipeline import multi_tracking as tmt

    torch.set_num_threads(int(os.environ.get("TORCH_THREADS", "4")))
    cfg = tmt.MultiTrackerConfig(
        orb=tex.OrbConfig(n_features=512, n_levels=8), **kw)
    return tmt, tmt.MultiTracker(
        convert.rig_from_numpy(rig_np, device="cpu"), cfg,
        tpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS, device="cpu"),
        seed=0, device="cpu")


def ate(tr, oks, t_wb) -> dict:
    """ATE (Horn scale) of the frames tracked so far, against the map as
    it stands."""
    t_est, _, p_est = tr.get_trajectory()
    ok = np.asarray(oks)
    return evaluation.ate_rmse(t_est[ok], p_est[ok],
                               np.arange(len(oks)) / scene.FPS_IN,
                               t_wb[:len(oks)], with_scale=True)


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    port = "--port" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--port"]
    n = int(args[0]) if args and "=" not in args[0] else scene.N_FRAMES
    overrides = {k: ast.literal_eval(v) for k, v in
                 (a.split("=", 1) for a in args if "=" in a)}
    sched = {k: overrides.pop(k) for k in SCHEDULES if k in overrides}
    rig_np, frames, _, t_wb, batches = scene.make_sequence(
        n, orbit_frac=1.25 * (n - 1) / (scene.N_FRAMES - 1),
        kind_name="kb8")
    fields = set(multi_tracking.MultiTrackerConfig.__dataclass_fields__)
    kw = {k: v for k, v in scene.bench_config_kwargs(n).items()
          if k in fields}
    kw.update(overrides)
    mod, tr = trackers(port, rig_np, kw)
    set_schedules(mod, sched)
    oks, progress = [], []
    t0 = time.perf_counter()
    for i in range(n):
        t, b = batches[i]
        for w, a, ts in b:
            tr.feed_imu(w, a, ts)
        img = frames[i].astype(np.float32)
        oks.append(bool(tr.process_frame(img if port else jnp.asarray(img),
                                         t)))
        if (i + 1) % 20 == 0:
            res = ate(tr, oks, t_wb)
            progress.append(dict(
                frame=i, tracked=sum(oks), n_keyframes=tr.n_kf,
                viba_stage=tr.viba_stage, ate_rmse_m=float(res["rmse"]),
                horn_scale=float(res["scale"])))
            print(json.dumps(progress[-1]), file=sys.stderr, flush=True)
    res = ate(tr, oks, t_wb)
    ok = np.asarray(oks)
    print(json.dumps({
        "package": ("openmavis_tpu_torch (CPU)" if port
                    else "openmavis_tpu (JAX, CPU)"), "frames": n,
        "overrides": overrides, "schedules": sched,
        "ate_rmse_m_frame79": next((p["ate_rmse_m"] for p in progress
                                    if p["frame"] == 79), None),
        "frames_tracked": int(ok.sum()), "n_keyframes": int(tr.n_kf),
        "n_landmarks": int(tr.map.n_mp),
        "imu_initialized": bool(tr.imu_initialized),
        "viba_stage": int(tr.viba_stage),
        "ate_rmse_m": float(res["rmse"]),
        "ate_rmse_noscale_m": float(res["rmse_noscale"]),
        "horn_scale": float(res["scale"]),
        "run_s": time.perf_counter() - t0, "progress": progress}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
