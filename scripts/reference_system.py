#!/usr/bin/env python3
"""The reference package's `System` facade (`openmavis_tpu`, JAX) on the
CPU at the configurations of `chip_smoke.py`'s paths 15 and 16.

imu_multi (path 15): `System(settings,
Sensor.IMU_MULTI)` with the settings dict `scene.system_settings` builds
from the flagship rig (4 x KannalaBrandt8 at 640 x 480, 4 x 512 ORB
features x 8 levels, 400 Hz IMU noise; flat dotted keys, no yaml), the
bench's values as tracker overrides, the facade's own LoopCloser and
Atlas, on the flagship scene (160 frames, the IMU given to `track_multi`),
then `run_global_ba()`. Prints one JSON line per seed (the System's
`seed`) with the content path 15 gates on: frames tracked, ATE (Horn
scale) at frame 79 and at the end, loops, maps, and the ATE after the
global BA.

stereo_rectified (path 16): `System(settings, Sensor.STEREO)` without
loop closing on the converging, radtan-distorted pair of
`scene.stereo_pair_settings` (tests/test_rectify.py's pair at 752 x 480,
1,000 x 8 ORB), 60 raw frames (distorted per pixel) through
`track_stereo` (remapped on the fly), and the ideal-input control
(parallel renders, no distortion, no `Stereo.T_c1_c2`); one JSON line
per seed with both runs' frames tracked and ATE: Horn-scaled, as the
gates of tests/test_rectify.py read it (`ate_rmse`'s "rmse"; its
`with_scale=` changes nothing), without scale, and the Horn scale.

The frames are handed over as float32, the reference System's documented
input (README): given the scene's uint8 frames it would extract in uint8
(its pyramid and FAST then give other features), where the port casts
every image to float32 on the device.

stereo_rectified_port: the same through the port's System on the CPU
(given the uint8 frames, which it casts on its device), beside the
reference.

Both stereo modes also print, for each run, the first FIRST_FRAMES
frames' distances from frame 0: the live estimate (the trajectory's
newest entry right after the frame) and the final trajectory's, beside
the truth's (`first_frames`). `--orbit FRAC` sets the fraction of a turn
the 60 frames cover (path 16's STEREO_ORBIT_FRAC by default; 0.4538 is
tests/test_rectify.py's own angular step, 0.3 of a turn over 40 frames).

stereo_step RUN [N] [--free | --swap]: path 16's run RUN (rectified or control,
control by default), its first N frames (FIRST_FRAMES by default), the
port's tracker every frame from the reference MultiTracker's state of the
frame before, fed the reference's features of the images the reference
System handed its tracker; prints per frame both live positions'
distances from frame 0 beside the truth's, the fields that part, and how
the port's own features of those images differ from the reference's
(validity, keypoints beyond 1e-3 px, descriptor bits). With
--free the port's System runs alone on the reference's features; --swap
runs both free, the reference's tracker given the port's landmark
geometry after frame 0 (`run_stereo_step`; two to three minutes for six
frames).

Run: JAX_PLATFORMS=cpu python3 scripts/reference_system.py MODE [SEED ...]
[--orbit FRAC]
(MODE imu_multi, stereo_rectified or stereo_rectified_port, seed 0 by
default; imu_multi takes about ten minutes and a few GiB per seed on the
CPU, the stereo modes a few minutes).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

from openmavis_tpu.io import evaluation  # noqa: E402
from openmavis_tpu.pipeline import multi_tracking  # noqa: E402
from openmavis_tpu.pipeline.system import Sensor, System  # noqa: E402
from openmavis_tpu_torch import scene  # noqa: E402

BAND_FRAME = 79
STEREO_FRAMES = 60
# tests/test_rectify.py's image motion a frame at the EuRoC camera's
# focal length (chip_smoke.py's STEREO_ORBIT_FRAC)
STEREO_ORBIT_FRAC = 0.3 / 39 * (STEREO_FRAMES - 1) * 260.0 / 458.654
FIRST_FRAMES = 5


def ate(tr, oks, t_wb) -> dict:
    t_est, _, p_est = tr.get_trajectory()
    ok = np.asarray(oks)
    return evaluation.ate_rmse(t_est[ok], p_est[ok],
                               np.arange(len(oks)) / scene.FPS_IN,
                               t_wb[:len(oks)], with_scale=True)


def run(seed: int, rig_np, frames, t_wb, batches) -> dict:
    settings = scene.system_settings(rig_np, 512, 8, scene.NOISE_SIGMAS)
    fields = set(multi_tracking.MultiTrackerConfig.__dataclass_fields__)
    own = {"img_w", "img_h", "n_cams", "stereo_pairs", "imu_freq"}
    overrides = {k: v for k, v in scene.bench_config_kwargs().items()
                 if k in fields and k not in own}
    slam = System(settings, Sensor.IMU_MULTI, tracker_overrides=overrides,
                  seed=seed)
    tr, lc = slam.tracker, slam.loop_closer
    oks, progress = [], []
    t0 = time.perf_counter()
    for i in range(len(frames)):
        t, b = batches[i]
        oks.append(bool(slam.track_multi(frames[i].astype(np.float32), t,
                                         imu_samples=b)))
        if (i + 1) % 20 == 0:
            res = ate(tr, oks, t_wb)
            progress.append(dict(
                frame=i, tracked=sum(oks), n_keyframes=tr.n_kf,
                loops=lc.n_loops, maps=len(tr.atlas.maps),
                viba_stage=tr.viba_stage, ate_rmse_m=float(res["rmse"]),
                horn_scale=float(res["scale"])))
            print(json.dumps(progress[-1]), file=sys.stderr, flush=True)
    run_s = time.perf_counter() - t0
    res = ate(tr, oks, t_wb)
    chi = slam.run_global_ba()
    after = ate(tr, oks, t_wb)
    band = next(p for p in progress if p["frame"] == BAND_FRAME)
    return {
        "package": "openmavis_tpu (JAX, CPU)", "seed": seed,
        "frames": len(frames), "frames_tracked": int(sum(oks)),
        "n_keyframes": int(tr.n_kf), "n_landmarks": int(tr.map.n_mp),
        "imu_initialized": bool(tr.imu_initialized),
        "viba_stage": int(tr.viba_stage), "loops": lc.n_loops,
        "maps": len(tr.atlas.maps), "merges": lc.n_merges,
        "ate_rmse_m_frame79": band["ate_rmse_m"],
        "ate_rmse_m": float(res["rmse"]),
        "ate_rmse_noscale_m": float(res["rmse_noscale"]),
        "horn_scale": float(res["scale"]), "gba_chi2": chi,
        "ate_after_gba_m": float(after["rmse"]), "run_s": run_s,
        "progress": progress}


def run_stereo(seed: int, port: bool = False,
               orbit: float = STEREO_ORBIT_FRAC) -> dict:
    out = {"package": "openmavis_tpu_torch (CPU)" if port
           else "openmavis_tpu (JAX, CPU)", "seed": seed,
           "frames": STEREO_FRAMES, "orbit_frac": orbit}
    for name, raw in (("rectified", True), ("control", False)):
        settings = scene.stereo_pair_settings(raw, 1000, 8)
        frames, _, t_wb = scene.stereo_pair_sequence(
            settings, STEREO_FRAMES, orbit)
        if port:
            from openmavis_tpu_torch.pipeline import system as tsys
            slam = tsys.System(settings, tsys.Sensor.STEREO,
                               enable_loop_closing=False, seed=seed,
                               device="cpu")
        else:
            slam = System(settings, Sensor.STEREO,
                          enable_loop_closing=False, seed=seed)
            frames = frames.astype(np.float32)
        oks, live = [], []
        for i in range(STEREO_FRAMES):
            oks.append(bool(slam.track_stereo(frames[i, 0], frames[i, 1],
                                              i * 0.05)))
            if i < FIRST_FRAMES:
                live.append(np.asarray(slam.tracker.get_trajectory()[2][-1]))
        t_est, _, p_est = slam.tracker.get_trajectory()
        ok = np.asarray(oks)
        p_est = np.asarray(p_est)
        first = [dict(frame=i, tracked=oks[i],
                      live_from_0_m=float(np.linalg.norm(live[i] - live[0])),
                      final_from_0_m=float(np.linalg.norm(p_est[i]
                                                          - p_est[0])),
                      truth_from_0_m=float(np.linalg.norm(t_wb[i]
                                                          - t_wb[0])))
                 for i in range(FIRST_FRAMES)]
        res = evaluation.ate_rmse(t_est[ok], p_est[ok],
                                  np.arange(STEREO_FRAMES) * 0.05, t_wb)
        out[name] = {"frames_tracked": int(ok.sum()),
                     "ate_m": float(res["rmse"]),
                     "ate_noscale_m": float(res["rmse_noscale"]),
                     "horn_scale": float(res["scale"]),
                     "n_keyframes": int(slam.tracker.n_kf),
                     "first_frames": first}
        print(json.dumps({name: out[name]}), file=sys.stderr, flush=True)
    return out


def _np_tree(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _ref_state(jt) -> dict:
    """The reference MultiTracker's attributes laid out as
    `convert.multi_tracker_state_to_numpy` lays out the port's."""
    from openmavis_tpu_torch import convert
    d = {k: getattr(jt, k) for k in convert._MT_HOST}
    d.update({k: np.asarray(getattr(jt, k)) for k in convert._MT_TENSORS})
    d["map"] = _np_tree(jt.map)
    d["kf_pre"] = [None if p is None else _np_tree(p) for p in jt.kf_pre]
    d["_imu_frame"] = list(jt._imu_frame)
    d["_imu_kf"] = list(jt._imu_kf)
    d["trajectory"] = list(jt.trajectory)
    d["_init_bank"] = (None if jt._init_bank is None else
                       {k: np.asarray(v) for k, v in jt._init_bank.items()})
    d["key"] = np.asarray(jt.key)
    return d


STEP_INTS = ("ok", "state", "n_kf", "n_mp", "kf_valid", "kf_obs",
             "mp_valid")


def _step_record(d: dict, ok) -> dict:
    m = d["map"]
    rec = {k: np.asarray(m[k]) for k in ("n_mp", "kf_valid", "kf_obs",
                                         "mp_valid", "kf_t", "mp_pos")}
    rec.update(ok=np.asarray(bool(ok)), state=np.asarray(d["state"]),
               n_kf=np.asarray(d["n_kf"]), t=np.asarray(d["t"]))
    return rec


def feature_diff(images, port_ext, ref, orb_cfg) -> dict:
    """How the port's own features of `images` differ from the
    reference's (`ref`): validity, keypoints beyond 1e-3 px, descriptor
    bits, and the largest gap between the two BRIEF samples of a
    differing bit in the port's own sample values (a tie within the two
    packages' resizes, which differ by up to 2e-4 on pyramid levels
    4-7)."""
    from openmavis_tpu_torch.frontend import extractor as tex
    from openmavis_tpu_torch.frontend import orb as torb

    mine = port_ext(images)
    both = (mine.valid & ref.valid).numpy()
    flips = (mine.desc != ref.desc).numpy() & both[..., None]
    d = tex.detect_multicam(images, orb_cfg)
    kp = d["kp"].reshape(-1, 2)
    pb, ox, oy = torb.extract_patches(d["blurred"], d["lv_all"], kp)
    vals = torb.patch_values(pb, kp, ox, oy,
                             mine.angle.reshape(-1)).numpy()
    gap = np.abs(vals[..., 0] - vals[..., 1]).reshape(flips.shape)
    return dict(
        valid_differ=int((mine.valid != ref.valid).sum()),
        xy_differ=int((np.abs((mine.xy - ref.xy).numpy()).max(-1)
                       > 1e-3)[both].sum()),
        desc_bits_differ=int(flips.sum()), desc_bits=int(both.sum()) * 256,
        max_gap_at_differing_bits=float(gap[flips].max()) if flips.any()
        else 0.0)


SWAP_FIELDS = ("mp_pos", "mp_normal", "mp_dmin", "mp_dmax")


def run_stereo_step(seed: int, orbit: float, name: str, n: int,
                    free: bool, swap: bool = False) -> dict:
    """Path 16's System(STEREO) run `name` (rectified or control), first
    `n` frames: every frame the port's tracker from the reference
    MultiTracker's state of the frame before (`convert`), fed the
    reference's features of the images the reference System handed its
    tracker; per frame both poses' distances from frame 0 and the fields
    that part (integers exactly, keyframe and live positions and
    landmarks beyond 1e-3 m). With `free`, instead the port's System runs
    alone on those features (the port's own state throughout); with
    `swap` too, the reference's tracker takes the port's landmark
    geometry after frame 0 (`SWAP_FIELDS`: positions, normals, distance
    ranges) and runs on from there."""
    import jax.numpy as jnp
    import torch
    from openmavis_tpu_torch import convert
    from openmavis_tpu_torch.frontend import extractor as tex
    from openmavis_tpu_torch.pipeline import system as tsys

    settings = scene.stereo_pair_settings(name == "rectified", 1000, 8)
    frames, _, t_wb = scene.stereo_pair_sequence(settings, STEREO_FRAMES,
                                                 orbit)
    sj = System(settings, Sensor.STEREO, enable_loop_closing=False,
                seed=seed)
    st = tsys.System(settings, tsys.Sensor.STEREO,
                     enable_loop_closing=False, seed=seed, device="cpu")
    jt, tt = sj.tracker, st.tracker
    seen = {}
    own = jt.process_frame

    def capture(images, *a, **k):
        seen["images"] = images
        return own(images, *a, **k)

    jt.process_frame = capture
    port_ext = tt._ext
    tt._ext = lambda images: seen["feats"]
    rows, p0 = [], {}
    for i in range(n):
        d = _ref_state(jt)
        ok_j = sj.track_stereo(frames[i, 0].astype(np.float32),
                               frames[i, 1].astype(np.float32), i * 0.05)
        seen["feats"] = tex.Features(*(torch.as_tensor(np.array(x))
                                       for x in jt._ext(seen["images"])))
        feat_diff = feature_diff(torch.as_tensor(np.asarray(
            seen["images"])), port_ext, seen["feats"], tt.cfg.orb)
        if not free:
            convert.multi_tracker_state_from_numpy(d, tt)
        ok_t = tt.process_frame(np.asarray(seen["images"]), i * 0.05)
        ref = _step_record(_ref_state(jt), ok_j)
        got = _step_record(convert.multi_tracker_state_to_numpy(tt), ok_t)
        if swap and i == 0:
            jt.map = jt.map._replace(**{
                k: jnp.asarray(convert._np(getattr(tt.map, k)))
                for k in SWAP_FIELDS})
        pos = {}
        for who, rec in (("reference", ref), ("port", got)):
            p0.setdefault(who, rec["t"])
            pos[who] = float(np.linalg.norm(rec["t"] - p0[who]))
        parts = {}
        for k in STEP_INTS:
            a, b = np.asarray(got[k]), np.asarray(ref[k])
            if a.shape != b.shape or not np.array_equal(a, b):
                parts[k] = int(np.sum(a != b)) if a.shape == b.shape \
                    else "shape"
        for k in ("t", "kf_t", "mp_pos"):
            diff = float(np.max(np.abs(got[k].astype(np.float64)
                                       - ref[k])))
            if diff > 1e-3:
                parts[k] = diff
        rows.append(dict(frame=i, ok=bool(ok_j), n_kf=int(ref["n_kf"]),
                         live_from_0_m=pos, port_own_features=feat_diff,
                         truth_from_0_m=float(np.linalg.norm(
                             t_wb[i] - t_wb[0])),
                         parts=parts))
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return dict(run=name, seed=seed, orbit_frac=orbit,
                package=("port free on the reference's features" if free
                         else "port stepped from the reference")
                + (", the reference on the port's frame-0 landmarks"
                   if swap else ""),
                frames=rows)


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    free, swap = "--free" in sys.argv, "--swap" in sys.argv
    args = [a for a in sys.argv[1:] if a not in ("--free", "--swap")]
    orbit = STEREO_ORBIT_FRAC
    if "--orbit" in args:
        j = args.index("--orbit")
        orbit = float(args[j + 1])
        del args[j:j + 2]
    mode = args[0] if args else "imu_multi"
    if mode == "stereo_step":
        name = args[1] if len(args) > 1 else "control"
        n = int(args[2]) if len(args) > 2 else FIRST_FRAMES
        print(json.dumps(run_stereo_step(0, orbit, name, n, free or swap,
                                         swap)))
        return 0
    seeds = [int(a) for a in args[1:]] or [0]
    if mode in ("stereo_rectified", "stereo_rectified_port"):
        for seed in seeds:
            print(json.dumps(run_stereo(seed, mode.endswith("_port"),
                                        orbit)), flush=True)
        return 0
    rig_np, frames, _, t_wb, batches = scene.make_sequence(
        scene.N_FRAMES, orbit_frac=1.25, kind_name="kb8")
    for seed in seeds:
        print(json.dumps(run(seed, rig_np, frames, t_wb, batches)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
