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
[field=value ...]   (N frames, 160 by default; each field=value sets a
`MultiTrackerConfig` field, e.g. kf_min_inliers_abs=60; about seven
minutes and a few GiB on the CPU).
"""

import ast

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
    n = int(sys.argv[1]) if len(sys.argv) > 1 else scene.N_FRAMES
    overrides = {k: ast.literal_eval(v) for k, v in
                 (a.split("=", 1) for a in sys.argv[2:])}
    rig_np, frames, _, t_wb, batches = scene.make_sequence(
        n, orbit_frac=1.25 * (n - 1) / (scene.N_FRAMES - 1),
        kind_name="kb8")
    rig = RigParams(rig_np["kind"], *(jnp.asarray(rig_np[k])
                                      for k in ("params", "R_cb", "t_cb")))
    fields = set(multi_tracking.MultiTrackerConfig.__dataclass_fields__)
    kw = {k: v for k, v in scene.bench_config_kwargs(n).items()
          if k in fields}
    kw.update(overrides)
    cfg = multi_tracking.MultiTrackerConfig(
        orb=extractor.OrbConfig(n_features=512, n_levels=8), **kw)
    tr = multi_tracking.MultiTracker(
        rig, cfg, pre_mod.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS), seed=0)
    oks, progress = [], []
    t0 = time.perf_counter()
    for i in range(n):
        t, b = batches[i]
        for w, a, ts in b:
            tr.feed_imu(w, a, ts)
        oks.append(bool(tr.process_frame(
            jnp.asarray(frames[i].astype(np.float32)), t)))
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
        "package": "openmavis_tpu (JAX, CPU)", "frames": n,
        "overrides": overrides,
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
