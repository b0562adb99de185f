#!/usr/bin/env python3
"""The reference package's example mains (`examples/*.py`, JAX) on the CPU,
on the scenes the port's mains are held to.

SCENE is one of:
* a name of `openmavis_tpu_torch.examples.scenes.SCENES`: the scene of
  tests/test_examples_e2e.py for the main of that name (320 x 240), run
  with that test's flags; tests/test_torch_examples.py's end-to-end group
  runs the port's main on the same scene;
* `multisession`: `multisession_euroc` on the stereo-inertial scene cut in
  two sessions (frames 0-21 and 22-43), as tests/test_torch_examples.py
  cuts it;
* `flagship`: `chip_smoke.py`'s path 17, the flagship main
  `multi_inertial_euroc` on path 1's scene written to disk (160 frames of
  4 x KannalaBrandt8 at 640 x 480, 512 x 8 ORB, the 400 Hz IMU), with
  `--lc-every 30 --max-kf 64 --max-mp 16384`.

Prints one JSON line: the rows of the trajectory file, keyframes, whether
the IMU initialized, loops closed, and the ATE (Horn scale, its scale,
and without scale) against the rig's positions and against cam0's.
Arguments after SCENE go to the main (e.g. `--max-frames 30`). With
`--port` the port's main runs instead, on the CPU (`--device cpu`).

Run: JAX_PLATFORMS=cpu python3 scripts/reference_examples.py SCENE
[--port] [main flags ...] (the 320 x 240 scenes take one to a few
minutes each, `flagship` about ten).
"""

import contextlib
import importlib
import importlib.util
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from openmavis_tpu_torch.examples import scenes  # noqa: E402
from openmavis_tpu_torch.io import evaluation  # noqa: E402

# tests/test_examples_e2e.py's flags beyond the scene's paths
E2E_FLAGS = {"multi_inertial_euroc": ["--cams", "cam0,cam1", "--lc-every",
                                      "0", "--max-kf", "32", "--max-mp",
                                      "6144"]}
FLAGSHIP_FLAGS = ["--lc-every", "30", "--max-kf", "64", "--max-mp", "16384"]
SESSION_SPLIT = 22


def _load_reference_main(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _capture(pkg):
    """Subclass the trackers and the facade a main builds so that the
    instances stay reachable after the main returns."""
    made = []
    for modname, cls in (("pipeline.system", "System"),
                         ("pipeline.streaming_vi", "StreamingVITracker"),
                         ("pipeline.streaming", "StreamingTracker")):
        mod = importlib.import_module(f"{pkg}.{modname}")
        base = getattr(mod, cls)

        def init(self, *a, _base=base, **kw):
            _base.__init__(self, *a, **kw)
            made.append(self)

        setattr(mod, cls, type(cls, (base,), {"__init__": init}))
    return made


def _write_flagship(root):
    from openmavis_tpu_torch import scene
    rig_np, frames, R_wb, t_wb, batches = scene.make_sequence(
        scene.N_FRAMES, orbit_frac=1.25, kind_name="kb8")
    imu = [s for _, b in batches for s in b]
    d = scenes.write_rig_scene(root, frames, imu, t_wb,
                               scene.system_settings(rig_np, 512),
                               dt=1.0 / scene.FPS_IN)
    argv = [d["sequence"], "--settings", d["settings"], "--cams",
            d["cams"], "--gt", d["gt"]] + FLAGSHIP_FLAGS
    return argv, t_wb, t_wb


def _prepare(scene_name, root, out):
    """(main name, argv, times, rig positions, cam0 positions)."""
    if scene_name == "flagship":
        argv, p_body, p_cam0 = _write_flagship(root)
        n = len(p_body)
        return ("multi_inertial_euroc", argv + ["--out", out],
                np.arange(n) / 20.0, p_body, p_cam0)
    if scene_name == "multisession":
        d = scenes.write_scene("stereo_inertial_euroc",
                               os.path.join(root, "full"))
        n = d["n"]
        seqs = [scenes.write_euroc_slice(d["sequence"],
                                         os.path.join(root, f"s{k}"), lo, hi)
                for k, (lo, hi) in enumerate(((0, SESSION_SPLIT),
                                              (SESSION_SPLIT, n)))]
        return ("multisession_euroc", seqs + ["--settings", d["settings"],
                                              "--out-dir", out],
                d["t_gt"], d["p_body"], d["p_cam0"])
    d = scenes.write_scene(scene_name, root)
    argv = [d["sequence"], "--settings", d["settings"], "--out", out]
    if scene_name != "stereo_kitti":
        argv += ["--gt", d["gt"]]
    return (scene_name, argv + E2E_FLAGS.get(scene_name, []), d["t_gt"],
            d["p_body"], d["p_cam0"])


def _read_trajectory(main, out):
    if main == "multisession_euroc":
        parts = [np.loadtxt(os.path.join(out, f"session{k}.txt"), ndmin=2)
                 for k in range(2)]
        traj = np.concatenate(parts)
        return traj[:, 0], traj[:, 1:4]
    traj = np.loadtxt(out, ndmin=2)
    if traj.shape[1] == 12:               # KITTI: 3x4 pose rows, no times
        return np.arange(len(traj)) * scenes.DT, traj[:, [3, 7, 11]]
    return traj[:, 0], traj[:, 1:4]


def main():
    args = sys.argv[1:]
    if not args:
        sys.exit(__doc__)
    scene_name, rest = args[0], args[1:]
    port = "--port" in rest
    rest = [a for a in rest if a != "--port"]
    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "out")
        if scene_name == "multisession":
            os.makedirs(out)
        else:
            out = os.path.join(root, "traj.txt")
        main_name, argv, t_gt, p_body, p_cam0 = _prepare(
            scene_name, os.path.join(root, "scene"), out)
        argv = argv + rest
        err = io.StringIO()
        t0 = time.perf_counter()
        if port:
            import torch
            torch.set_num_threads(int(os.environ.get("TORCH_THREADS", "1")))
            made = _capture("openmavis_tpu_torch")
            mod = importlib.import_module(
                f"openmavis_tpu_torch.examples.{main_name}")
            with contextlib.redirect_stderr(err):
                mod.main(argv + ["--device", "cpu"])
        else:
            made = _capture("openmavis_tpu")
            mod = _load_reference_main(main_name)
            sys.argv = [f"{main_name}.py"] + argv
            with contextlib.redirect_stderr(err):
                mod.main()
        seconds = time.perf_counter() - t0
        t_est, p_est = _read_trajectory(main_name, out)
    text = err.getvalue()
    obj = made[-1]
    tracker = getattr(obj, "tracker", obj)
    lc = getattr(obj, "loop_closer", None) or getattr(
        tracker, "loop_closer", None)
    res = {"scene": scene_name, "main": main_name,
           "package": "port (CPU)" if port else "reference (JAX, CPU)",
           "argv_extra": rest, "rows": int(len(t_est)),
           "frames": int(len(t_gt)),
           "keyframes": int(tracker.n_kf) if hasattr(tracker, "n_kf")
           else None,
           "imu_init": (True if re.search(r"imu_init\w*=True", text)
                        else False if re.search(r"imu_init\w*=False", text)
                        else None),
           "loops": getattr(lc, "n_loops", None),
           "seconds": round(seconds, 1)}
    for key, p_gt in (("body", p_body), ("cam0", p_cam0)):
        r = evaluation.ate_rmse(t_est, p_est, t_gt, p_gt, with_scale=True)
        res[f"ate_{key}_m"] = float(r["rmse"])
        res[f"scale_{key}"] = float(r["scale"])
        res[f"ate_noscale_{key}_m"] = float(r["rmse_noscale"])
    if main_name == "multisession_euroc":
        # each session on its own against the ground truth (the sessions
        # stay apart when no merge welds them)
        for k, (lo, hi) in enumerate(((0, SESSION_SPLIT),
                                      (SESSION_SPLIT, len(t_gt)))):
            sel = (t_est >= t_gt[lo] - 1e-6) & (t_est <= t_gt[hi - 1] + 1e-6)
            r = evaluation.ate_rmse(t_est[sel], p_est[sel], t_gt[lo:hi],
                                    p_body[lo:hi], with_scale=True)
            res[f"session{k}"] = {"rows": int(sel.sum()),
                                  "ate_m": float(r["rmse"]),
                                  "scale": float(r["scale"])}
        res["final_maps"] = int(tracker.atlas.n_maps())
    res["ate_lines"] = [line for line in text.splitlines()
                        if "ATE RMSE" in line]
    print(json.dumps(res))


if __name__ == "__main__":
    main()
