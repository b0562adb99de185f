#!/usr/bin/env python3
"""The reference package's one-camera visual trackers (`openmavis_tpu`'s
`tracking.Tracker` and `streaming.StreamingTracker`, JAX) on the CPU at
the configurations of `chip_smoke.py`'s paths 7-9, so that the port's
runs on the GPU have a reference row:

* `mono_tracker`: `Tracker` as `System` builds it for MONOCULAR on the
  EuRoC camera of ORB-SLAM3's Examples/Monocular/EuRoC.yaml (752 x 480,
  radtan, the images rendered distorted, `dist` given), 1,000 ORB x 8
  levels, `TrackerConfig`'s defaults (64 keyframes, 8,192 landmarks),
  100 frames of the single-camera orbit, frames 60-63 black;
* `rgbd_tracker`: `Tracker` with depth maps (RGBD) on the 640 x 480
  pinhole of the RGB-D path, 1,000 x 8, `TrackerConfig`'s defaults, 80
  frames;
* `mono_streaming`: `StreamingTracker` as `examples/mono_euroc.py
  --streaming` builds it: the EuRoC pinhole without distortion (the images
  rendered undistorted), 1,000 x 8, 64 keyframes, 16,384 landmarks, 80
  frames.

Prints one JSON line with what the port's path gates on: the init frame,
frames tracked, LOST frames and the first tracked frame after the
blackout, keyframes, landmarks, and ATE with and without Horn scale over
the tracked frames.

Run: JAX_PLATFORMS=cpu python3 scripts/reference_tracker.py PATH [N [SEED]]
[--reloc] (PATH one of mono_tracker, rgbd_tracker, mono_streaming; N
frames, the path's own count by default; SEED the tracker's PRNG seed, 0
by default, as the port's paths use; about a minute and a few GiB each).

`--reloc` (mono_tracker): every relocalization attempt of the run taken
apart on the map it ran on, stage by stage, in both packages: the
retrieval's scores and top-3 keyframes (and the rank of the keyframe
nearest the frame's true position, put in the map's frame by the Horn
alignment of the frames tracked before), each candidate's 2D-3D
matches, and the PnP's inliers and success: the reference's with its own
key, the port's `relocalize_step` from the same map and features with
the reference's samples (`sample_idx`); and the same stages on the
nearest keyframe (`nearest`), as if the retrieval had picked it. The
first line is a control: frame 50 (tracked) on the same final map.
"""

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
from openmavis_tpu.io import evaluation  # noqa: E402
from openmavis_tpu.optim.reprojection import RigParams  # noqa: E402
from openmavis_tpu.pipeline import streaming, tracking  # noqa: E402
from openmavis_tpu_torch import scene  # noqa: E402

FRAMES = dict(mono_tracker=100, rgbd_tracker=80, mono_streaming=80)
# `--reloc`'s control: a frame tracked before the blackout
RELOC_CONTROL_FRAME = 50
BLACKOUT = range(60, 64)
ORB = dict(n_features=1000, n_levels=8)


def setup(path: str, n: int):
    """(rig, frames [T, h, w] float32, depth maps or None, t_wb, dist)."""
    mono = path != "rgbd_tracker"
    w, h = ((scene.EUROC_W, scene.EUROC_H) if mono
            else (scene.RGBD_W, scene.RGBD_H))
    pin = scene.EUROC_PINHOLE if mono else scene.RGBD_PINHOLE
    dist = scene.EUROC_RADTAN if path == "mono_tracker" else None
    rig_np, frames, _, t_wb, _, depths = scene.make_single_camera_sequence(
        n, 1.25 * (n - 1) / (scene.N_FRAMES - 1), w, h, pin, dist=dist,
        depth=not mono)
    frames = frames[:, 0].astype(np.float32)
    if path == "mono_tracker":
        frames[list(BLACKOUT)] = 0
    rig = RigParams(rig_np["kind"], *(jnp.asarray(rig_np[k])
                                      for k in ("params", "R_cb", "t_cb")))
    return (rig, frames, None if depths is None else depths[:, 0], t_wb,
            None if dist is None else np.asarray(dist, np.float32)[None])


def ate(t_est, p_est, ok, t_wb) -> dict:
    n = len(ok)
    return evaluation.ate_rmse(t_est[ok], p_est[ok],
                               np.arange(n) / scene.FPS_IN, t_wb[:n],
                               with_scale=True)


def reloc_attempts(calls, tr, t_wb, oks) -> list:
    """Each recorded `relocalize_step` call (frame, map, features, key)
    taken apart in both packages (see the module docstring)."""
    import torch
    from openmavis_tpu.frontend import matcher
    from openmavis_tpu.geometry import cameras
    from openmavis_tpu.solvers import pnp
    from openmavis_tpu_torch import convert
    from openmavis_tpu_torch.frontend import extractor as tex
    from openmavis_tpu_torch.io import evaluation as tev
    from openmavis_tpu_torch.pipeline import tracking as ttrk

    rig = tr.rig
    _, _, p_est = tr.get_trajectory()
    ok = np.asarray(oks)
    first = min(c["frame"] for c in calls)
    sel = ok & (np.arange(len(ok)) < first)
    # truth -> map: map ~ s R truth + t
    s_, R_a, t_a = tev.horn_align(t_wb[:len(ok)][sel], p_est[sel])
    torch_rig = convert.rig_from_numpy(
        {"kind": rig.kind, **{k: np.asarray(getattr(rig, k))
                              for k in ("params", "R_cb", "t_cb")}},
        device="cpu")
    out = []
    for c in calls:
        m, feats, key, f = c["map"], c["feats"], c["key"], c["frame"]
        K, F = m.kf_obs.shape
        dist = matcher.hamming_matrix(
            feats.desc, m.kf_desc.reshape(K * F, 256)).reshape(-1, K, F)
        t_valid = m.kf_feat_valid & (m.kf_obs >= 0) & m.kf_valid[:, None]
        best = jnp.min(jnp.where(t_valid[None], dist, 1 << 20), axis=2)
        scores = np.asarray(jnp.sum(
            (best < matcher.TH_LOW).astype(jnp.int32)
            & feats.valid[:, None].astype(jnp.int32), axis=0))
        _, cand = jax.lax.top_k(jnp.asarray(scores), 3)
        cand = np.asarray(cand)
        # the true position in the map's frame
        p_true = s_ * R_a @ t_wb[f] + t_a
        n_kf = int(m.n_kf)
        kf_t = np.asarray(m.kf_t)[:n_kf]
        near = int(np.argmin(np.linalg.norm(kf_t - p_true, axis=1)))
        rank = int(np.sum(scores[:n_kf] > scores[near]))
        ray = np.asarray(cameras.unproject(rig.kind, rig.params[0],
                                           feats.xy))
        ray_b = ray @ np.asarray(rig.R_cb[0])
        keys = jax.random.split(key, 3)
        draws = []
        per_cand = []
        for j, kf in enumerate(cand.tolist() + [near]):
            k = keys[j] if j < 3 else jax.random.fold_in(key, 3)
            has_mp = (m.kf_obs[kf] >= 0) & m.kf_feat_valid[kf]
            idx, _ = matcher.match_nn(feats.desc, feats.valid,
                                      m.kf_desc[kf], has_mp,
                                      max_dist=matcher.TH_LOW, ratio=0.85,
                                      mutual=True)
            matched = np.asarray(idx) >= 0
            safe = np.where(matched, np.asarray(idx), 0)
            mp = np.where(matched, np.asarray(m.kf_obs[kf])[safe], 0)
            valid = matched & np.asarray(m.mp_valid)[mp]
            p_w = np.asarray(m.mp_pos)[mp]
            res = pnp.ransac_pnp(k, jnp.asarray(p_w),
                                 jnp.asarray(ray_b), jnp.asarray(valid),
                                 min_inliers=15, sigma2=feats.sigma2)
            logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
            draws.append(np.asarray(jax.random.categorical(
                k, logits[None, None, :], shape=(512, 6))))
            per_cand.append(dict(kf=kf, score=int(scores[kf]),
                                 matches=int(matched.sum()),
                                 valid=int(valid.sum()),
                                 pnp_inliers=int(res.n_inliers),
                                 pnp_success=bool(res.success)))
        tm = convert.map_from_numpy(
            {k: np.asarray(v) for k, v in m._asdict().items()}, device="cpu")
        ft = tex.Features(*(torch.as_tensor(np.array(x)) for x in feats))
        ok_t, _, _, n_t = ttrk.relocalize_step(
            tm, ft, None, torch_rig.kind, torch_rig,
            sample_idx=torch.as_tensor(np.stack(draws[:3])))
        out.append(dict(
            frame=f, success=c["success"], n_inliers=c["n_inliers"],
            nearest_kf=near, nearest_kf_score=int(scores[near]),
            nearest_kf_rank=rank, true_dist_to_nearest_kf=float(
                np.linalg.norm(kf_t[near] - p_true)),
            candidates=per_cand[:3], nearest=per_cand[3],
            port=dict(success=bool(ok_t), n_inliers=int(n_t))))
    return out


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    reloc = "--reloc" in sys.argv
    argv = [a for a in sys.argv if a != "--reloc"]
    path = argv[1]
    n = int(argv[2]) if len(argv) > 2 else FRAMES[path]
    seed = int(argv[3]) if len(argv) > 3 else 0
    rig, frames, depths, t_wb, dist = setup(path, n)
    w, h = frames.shape[2], frames.shape[1]
    orb = extractor.OrbConfig(**ORB)
    oks, n_kf = [], []
    t0 = time.perf_counter()
    if path == "mono_streaming":
        cfg = streaming.StreamConfig(img_w=w, img_h=h, orb=orb, max_kf=64,
                                     max_mp=16384, traj_cap=max(n, 64))
        tr = streaming.StreamingTracker(rig, cfg, seed=seed)
        for i in range(n):
            tr.push(jnp.asarray(frames[i]), i / scene.FPS_IN)
            n_kf.append(tr.n_kf)
        tr.block()
        oks = [bool(x) for x in np.asarray(tr.carry.traj.ok[:n])]
        n_mp = int(tr.map.n_mp)
    else:
        cfg = tracking.TrackerConfig(img_w=w, img_h=h, orb=orb)
        tr = tracking.Tracker(rig, cfg, seed=seed, dist=dist)
        calls = []
        if reloc:
            own = tracking.relocalize_step

            def recording(m, feats, key, *a, **k):
                res = own(m, feats, key, *a, **k)
                calls.append(dict(frame=i, map=m, feats=feats, key=key,
                                  success=bool(res[0]),
                                  n_inliers=int(res[3])))
                return res

            tracking.relocalize_step = recording
        for i in range(n):
            dep = None if depths is None else jnp.asarray(depths[i])
            oks.append(bool(tr.process_frame(jnp.asarray(frames[i]),
                                             i / scene.FPS_IN, depth=dep)))
            n_kf.append(tr.n_kf)
            if (i + 1) % 20 == 0:
                print(json.dumps(dict(frame=i, tracked=sum(oks),
                                      n_keyframes=tr.n_kf)),
                      file=sys.stderr, flush=True)
        n_mp = int(tr.map.n_mp)
    t_est, _, p_est = tr.get_trajectory()
    ok = np.asarray(oks)
    res = ate(t_est, p_est, ok, t_wb)
    lost = [i for i in range(n) if not ok[i] and n_kf[i] > 0]
    back = next((i for i in range(BLACKOUT[-1] + 1, n) if ok[i]), None)
    steps = np.linalg.norm(np.diff(t_wb[:n], axis=0), axis=1)
    print(json.dumps({
        "package": "openmavis_tpu (JAX, CPU)", "path": path, "frames": n,
        "seed": seed,
        "init_frame": int(np.argmax(ok)) if ok.any() else None,
        "frames_tracked": int(ok.sum()),
        "frames_tracked_from_3": int(ok[3:].sum()),
        "lost_frames": lost,
        "first_tracked_after_blackout": (back if path == "mono_tracker"
                                         else None),
        "n_keyframes": int(n_kf[-1]), "n_landmarks": n_mp,
        "ate_rmse_m": float(res["rmse"]),
        "ate_rmse_noscale_m": float(res["rmse_noscale"]),
        "horn_scale": float(res["scale"]),
        "path_length_m": float(steps.sum()),
        "run_s": time.perf_counter() - t0}))
    if reloc and path == "mono_tracker":
        tracking.relocalize_step = own
        # a control: a tracked frame before the blackout, on the final map
        ctrl = RELOC_CONTROL_FRAME
        calls.insert(0, dict(frame=ctrl, map=tr.map,
                             feats=tr._ext(jnp.asarray(frames[ctrl])),
                             key=jax.random.PRNGKey(ctrl), success=None,
                             n_inliers=None))
        for row in reloc_attempts(calls, tr, t_wb, oks):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
