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
`--perturb K` (K >= 1) moves, in every call of the package's
`optim/ba.py::_schur_solve`, the pose gradient `gp` by one ulp up or down
in a seeded half of its entries (seed K): a parting of the size that a
change of the summation order makes (e.g. torch's thread count in the
port). The package stays as it is: the
function is wrapped at run time, before the main jits it.
`--seed S` sets `System`'s seed (both packages; 0 by default).
`--ref-draws` (with `--port`): each two-view attempt of the port draws its
samples from the reference tracker's key chain for that seed (the k-th
attempt from the key the reference's k-th attempt splits, over the port's
own matches), as the reference draws them: the port free with the
reference's draws. `--two-view` (the reference): after the run, each of
the reference's two-view attempts solved by both packages on the
reference's own inputs and samples, with every E hypothesis's float32
and float64 score (`reference_streaming_vi.two_view_compare`).

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


def _capture(pkg, seed=0):
    """Subclass the trackers and the facade a main builds so that the
    instances stay reachable after the main returns (and `System` gets
    `seed`)."""
    made = []
    for modname, cls in (("pipeline.system", "System"),
                         ("pipeline.streaming_vi", "StreamingVITracker"),
                         ("pipeline.streaming", "StreamingTracker")):
        mod = importlib.import_module(f"{pkg}.{modname}")
        base = getattr(mod, cls)

        def init(self, *a, _base=base, _cls=cls, **kw):
            if _cls == "System":
                kw.setdefault("seed", seed)
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


def _perturb_schur(pkg, k):
    """Wrap `pkg.optim.ba._schur_solve` so that `gp` moves by one ulp in
    a half of its entries drawn with seed k (up or down, drawn too)."""
    ba = importlib.import_module(f"{pkg}.optim.ba")
    solve = ba._schur_solve

    def masks(n):
        rng = np.random.default_rng(k)
        step = rng.integers(0, 2, n) * np.where(rng.random(n) < 0.5, 1, -1)
        return step > 0, step < 0

    if pkg == "openmavis_tpu":
        import jax.numpy as jnp

        def nudge(gp):
            up, down = masks(gp.shape[0])
            return jnp.where(up, jnp.nextafter(gp, jnp.inf),
                             jnp.where(down, jnp.nextafter(gp, -jnp.inf),
                                       gp))
    else:
        import torch

        def nudge(gp):
            up, down = (torch.as_tensor(m, device=gp.device)
                        for m in masks(gp.shape[0]))
            inf = torch.full_like(gp, float("inf"))
            return torch.where(up, torch.nextafter(gp, inf),
                               torch.where(down, torch.nextafter(gp, -inf),
                                           gp))

    def wrapped(Hpp, Hpl, Hll, gp, *rest):
        return solve(Hpp, Hpl, Hll, nudge(gp), *rest)

    ba._schur_solve = wrapped


def _key_chain(seed):
    """The keys the reference tracker (`PRNGKey(seed)`) splits on its
    successive two-view attempts (before the first relocalization)."""
    import jax
    key = jax.random.PRNGKey(seed)
    while True:
        yield np.asarray(key)
        key = jax.random.split(key)[0]


def _port_ref_draws(seed, attempts):
    """Wrap the port's `two_view.reconstruct`: its samples drawn over the
    port's matches from the reference's k-th key on the k-th call."""
    import torch
    from openmavis_tpu_torch.solvers import two_view
    import reference_streaming_vi as rsv
    keys = _key_chain(seed)
    orig = two_view.reconstruct

    def reconstruct(gen, x1, x2, valid, *a, sample_idx=None, **kw):
        matched = valid.cpu().numpy()
        i8, i4 = rsv.draws_from_key(next(keys), matched)
        res = orig(gen, x1, x2, valid, *a, sample_idx=(
            torch.as_tensor(i8, device=valid.device),
            torch.as_tensor(i4, device=valid.device)), **kw)
        attempts.append(dict(matched=int(matched.sum()),
                             success=bool(res.success),
                             good=int(res.is_good.sum())))
        return res

    two_view.reconstruct = reconstruct


def _reference_attempts(attempts):
    """Wrap the reference's `two_view.reconstruct` to keep each attempt's
    inputs (bearings, matches, focal, gate) and its result; returns the
    function that takes the wrapper out again."""
    from openmavis_tpu.solvers import two_view
    orig = two_view.reconstruct

    def reconstruct(key, x1, x2, valid, focal, *a, **kw):
        res = orig(key, x1, x2, valid, focal, *a, **kw)
        attempts.append(dict(
            x1=np.asarray(x1), x2=np.asarray(x2),
            matched=np.asarray(valid), focal=float(focal),
            min_inliers=int(kw.get("min_inliers", 50)),
            success=bool(res.success), good=int(np.sum(res.is_good))))
        return res

    two_view.reconstruct = reconstruct
    return lambda: setattr(two_view, "reconstruct", orig)


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
    opts = {}
    for flag in ("--perturb", "--seed"):
        if flag in rest:
            i = rest.index(flag)
            opts[flag] = int(rest[i + 1])
            rest = rest[:i] + rest[i + 2:]
    perturb, seed = opts.get("--perturb", 0), opts.get("--seed", 0)
    flags = {f: f in rest for f in ("--ref-draws", "--two-view")}
    rest = [a for a in rest if a not in flags]
    attempts = []
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
        if perturb:
            _perturb_schur("openmavis_tpu_torch" if port else
                           "openmavis_tpu", perturb)
        if port and flags["--ref-draws"]:
            _port_ref_draws(seed, attempts)
        unwrap = None
        if not port and flags["--two-view"]:
            unwrap = _reference_attempts(attempts)
        if port:
            import torch
            torch.set_num_threads(int(os.environ.get("TORCH_THREADS", "1")))
            made = _capture("openmavis_tpu_torch", seed)
            mod = importlib.import_module(
                f"openmavis_tpu_torch.examples.{main_name}")
            with contextlib.redirect_stderr(err):
                mod.main(argv + ["--device", "cpu"])
        else:
            made = _capture("openmavis_tpu", seed)
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
           "argv_extra": rest, "perturb": perturb, "seed": seed,
           "rows": int(len(t_est)),
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
    if flags["--ref-draws"]:
        res["two_view_attempts"] = attempts
    if unwrap is not None:
        unwrap()
        import reference_streaming_vi as rsv
        keys = _key_chain(seed)
        res["two_view_attempts"] = [
            dict(success=a["success"], good=a["good"],
                 compare=rsv.two_view_compare(
                     next(keys), a["x1"], a["x2"], a["matched"],
                     a["focal"], a["min_inliers"]))
            for a in attempts]
    print(json.dumps(res))


if __name__ == "__main__":
    main()
