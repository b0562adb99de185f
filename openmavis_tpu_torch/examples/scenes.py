"""Synthetic sequences on disk, in the dataset layouts the example mains
read: EuRoC / TUM-VI (`mav0/camN/data` + `data.csv`, `mav0/imu0/data.csv`),
TUM RGB-D (`rgb.txt`, `depth.txt`, optional `imu.txt`) and KITTI
(`times.txt`, `image_N/`), with a TUM ground-truth file and a settings
file for each.

`SCENES` holds the scenes of tests/test_examples_e2e.py, one for each
reference main: a BlobWorld (seed 3, 3,000 blobs) seen from an orbit of
radius 6 m at 320 x 240 and 20 fps, a pinhole of focal length 260 px (or
a KannalaBrandt8 of 200 px for the TUM-VI mains), a 0.2 m stereo baseline,
and the IMU at ten samples a frame. `write_scene(name, root)` writes one
and returns the main's arguments and the ground truth.

`write_rig_scene` writes a rig sequence of any width the same way, as
`chip_smoke.py`'s path 17 writes the flagship scene (4 x KannalaBrandt8
at 640 x 480, 400 Hz IMU) for `multi_inertial_euroc`.

PNGs are written with zlib (8-bit gray images, 16-bit depth maps); PyYAML
is imported only to write a settings file.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..geometry import cameras
from ..io import synthetic

W, H = 320, 240
FX = 260.0
PIN = np.array([FX, FX, W / 2, H / 2, 0, 0, 0, 0], np.float32)
KB8 = np.array([200.0, 200.0, W / 2, H / 2, 0.02, -0.004, 0.001, -0.0002],
               np.float32)
DT = 0.05
BASELINE = 0.2
WORLD_SEED = 3
WORLD_BLOBS = 3000
DEPTH_SCALE = 5000.0
IMU_RATE_MULT = 10
ORB = {"nFeatures": 384, "nLevels": 4, "scaleFactor": 1.2,
       "iniThFAST": 15, "minThFAST": 7}
IMU = {"NoiseGyro": 1.7e-4, "NoiseAcc": 2.0e-3, "GyroWalk": 1.9e-5,
       "AccWalk": 3.0e-3, "Frequency": 200.0}

# name -> (layout, frames, orbit fraction, camera model, cameras, imu,
# depth); layout "euroc" | "tum_rgbd" | "tum_rgb" | "kitti"; imu "zeros"
# writes still samples at the frame times, as the visual EuRoC scenes of
# tests/test_examples_e2e.py do
SCENES = {
    "mono_euroc": ("euroc", 30, 0.22, "pinhole", 1, "zeros", False),
    "stereo_euroc": ("euroc", 30, 0.22, "pinhole", 2, "zeros", False),
    "rgbd_tum": ("tum_rgbd", 30, 0.22, "pinhole", 1, None, True),
    "rgbd_inertial": ("tum_rgbd", 40, 0.25, "pinhole", 1, "orbit", True),
    "stereo_inertial_euroc": ("euroc", 44, 0.3, "pinhole", 2, "orbit",
                              False),
    "multi_inertial_euroc": ("euroc", 40, 0.3, "pinhole", 2, "orbit",
                             False),
    "mono_inertial_tum_vi": ("euroc", 44, 0.3, "kb8", 1, "orbit", False),
    "stereo_kitti": ("kitti", 30, 0.22, "pinhole", 2, None, False),
    "mono_kitti": ("kitti", 30, 0.22, "pinhole", 1, None, False),
    "mono_tum": ("tum_rgb", 30, 0.22, "pinhole", 1, None, False),
    "mono_inertial_euroc": ("euroc", 64, 0.4, "pinhole", 1, "orbit", False),
    "stereo_inertial_tum_vi": ("euroc", 44, 0.3, "kb8", 2, "orbit", False),
}
# the scenes whose ground-truth file holds the body's positions; the
# others hold cam0's (the body's where there is one camera)
GT_BODY = ("multi_inertial_euroc",)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """[H, W] uint8 or uint16 gray image -> PNG file (filter type 0 on
    every row, one zlib IDAT chunk; 16-bit samples big-endian)."""
    a = np.asarray(img)
    if a.dtype == np.uint16:
        depth, rows = 16, a.astype(">u2").view(np.uint8)
    elif a.dtype == np.uint8:
        depth, rows = 8, a
    else:
        raise ValueError(f"save_png takes uint8 or uint16, not {a.dtype}")
    h, w = a.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rows.reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                + _chunk(b"IEND", b""))


def write_euroc_cam(mav: str, cam: str, frames, times_ns) -> None:
    d = os.path.join(mav, cam, "data")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(mav, cam, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for ts, img in zip(times_ns, frames):
            name = f"{ts}.png"
            save_png(os.path.join(d, name), img)
            f.write(f"{ts},{name}\n")


def write_euroc_imu(mav: str, rows) -> None:
    """rows: (t_ns, w [3], a [3]) per sample."""
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],wx,wy,wz,ax,ay,az\n")
        for ts, w, a in rows:
            f.write(f"{ts},{w[0]},{w[1]},{w[2]},{a[0]},{a[1]},{a[2]}\n")


def write_gt_tum(path: str, times, p) -> None:
    with open(path, "w") as f:
        for t, q in zip(times, p):
            f.write(f"{t} {q[0]} {q[1]} {q[2]} 0 0 0 1\n")


def write_settings(path: str, cfg: dict) -> None:
    import yaml
    with open(path, "w") as f:
        f.write(yaml.safe_dump(cfg))


def settings(model: str, n_cams: int, imu: bool) -> dict:
    """A scene's settings in the reference's nested form (the dict
    tests/test_examples_e2e.py writes as yaml)."""
    cfg = {"File": {"version": "1.0"},
           "Camera": {"type": ("KannalaBrandt8" if model == "kb8"
                               else "PinHole"),
                      "width": W, "height": H, "fps": 1.0 / DT},
           "ORBextractor": dict(ORB)}
    for c in range(n_cams):
        T = np.eye(4)
        if n_cams == 2:
            T[0, 3] = (-0.5 if c == 0 else 0.5) * BASELINE
        if model == "kb8":
            cam = {"fx": 200.0, "fy": 200.0, "cx": W / 2, "cy": H / 2,
                   "k1": 0.02, "k2": -0.004, "k3": 0.001, "k4": -0.0002}
        else:
            cam = {"fx": FX, "fy": FX, "cx": W / 2, "cy": H / 2}
        cam["T_b_c"] = T.tolist()
        cfg[f"Camera{c + 1}"] = cam
    if imu:
        cfg["IMU"] = dict(IMU)
    return cfg


def camera_centers(n_cams: int) -> np.ndarray:
    if n_cams == 1:
        return np.zeros((1, 3), np.float32)
    return np.array([[-BASELINE / 2, 0, 0], [BASELINE / 2, 0, 0]],
                    np.float32)


def render_frames(name: str):
    """The scene's frames: (R_wb [n,3,3], t_wb [n,3], frames [C,n,H,W]
    uint8, depth [n,H,W] metres or None, imu samples (w, a, t) or None)."""
    layout, n, frac, model, n_cams, imu, depth = SCENES[name]
    world = synthetic.BlobWorld.create(seed=WORLD_SEED, n=WORLD_BLOBS)
    R_wb, t_wb = synthetic.orbit_trajectory(n, radius=6.0, frac=frac)
    kind, params = ((cameras.KB8, KB8) if model == "kb8"
                    else (cameras.PINHOLE, PIN))
    frames = []
    for c in camera_centers(n_cams):
        t_wc = t_wb + np.einsum("tij,j->ti", R_wb, c)
        frames.append(np.clip(synthetic.render_sequence(
            world, kind, params, R_wb, t_wc, W, H), 0, 255).astype(
            np.uint8))
    depths = (synthetic.render_depth_sequence(world, kind, params, R_wb,
                                              t_wb, W, H)
              if depth else None)
    samples = (synthetic.imu_from_trajectory(R_wb, t_wb, DT,
                                             rate_mult=IMU_RATE_MULT)
               if imu == "orbit" else None)
    return R_wb, t_wb, np.stack(frames), depths, samples


def write_scene(name: str, root: str, rendered=None) -> dict:
    """Write scene `name` under `root`; returns dict(sequence, settings,
    gt, n, t_gt [n], p_gt [n, 3]: the positions in the ground-truth file,
    p_body and p_cam0 [n, 3]: the rig's and cam0's, frames [C, n, H, W]
    uint8, depth [n, H, W]
    float32 or None, imu (w, a, t) samples or None)."""
    layout, n, _, model, n_cams, imu, _ = SCENES[name]
    R_wb, t_wb, frames, depths, samples = (rendered if rendered is not None
                                           else render_frames(name))
    seq = os.path.join(root, "seq")
    times = [i * DT for i in range(n)]
    times_ns = [int(t * 1e9) for t in times]
    if layout == "euroc":
        mav = os.path.join(seq, "mav0")
        for c in range(n_cams):
            write_euroc_cam(mav, f"cam{c}", frames[c], times_ns)
        if imu == "zeros":
            write_euroc_imu(mav, [(ts, (0, 0, 0), (0, 0, -9.81))
                                  for ts in times_ns])
        else:
            write_euroc_imu(mav, [(int(t * 1e9), w, a)
                                  for (w, a, t) in samples])
    elif layout in ("tum_rgbd", "tum_rgb"):
        os.makedirs(os.path.join(seq, "rgb"))
        lines = []
        for i, t in enumerate(times):
            save_png(os.path.join(seq, "rgb", f"{t:.6f}.png"), frames[0][i])
            lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        with open(os.path.join(seq, "rgb.txt"), "w") as f:
            f.write("# rgb\n" + "\n".join(lines))
        if layout == "tum_rgbd":
            os.makedirs(os.path.join(seq, "depth"))
            lines = []
            for i, t in enumerate(times):
                d16 = np.clip(depths[i] * DEPTH_SCALE, 0, 65535).astype(
                    np.uint16)
                save_png(os.path.join(seq, "depth", f"{t:.6f}.png"), d16)
                lines.append(f"{t:.6f} depth/{t:.6f}.png")
            with open(os.path.join(seq, "depth.txt"), "w") as f:
                f.write("# depth\n" + "\n".join(lines))
        if imu == "orbit":
            with open(os.path.join(seq, "imu.txt"), "w") as f:
                f.write("# t wx wy wz ax ay az\n")
                for (w, a, t) in samples:
                    f.write(f"{t} {w[0]} {w[1]} {w[2]} "
                            f"{a[0]} {a[1]} {a[2]}\n")
    elif layout == "kitti":
        for c in range(n_cams):
            d = os.path.join(seq, f"image_{c}")
            os.makedirs(d)
            for i in range(n):
                save_png(os.path.join(d, f"{i:06d}.png"), frames[c][i])
        with open(os.path.join(seq, "times.txt"), "w") as f:
            f.write("\n".join(f"{t:.6e}" for t in times) + "\n")
    else:
        raise ValueError(f"unknown layout {layout}")
    p_cam0 = t_wb + np.einsum("tij,j->ti", R_wb, camera_centers(n_cams)[0])
    p_gt = t_wb if name in GT_BODY else p_cam0
    gt = os.path.join(root, "gt.txt")
    write_gt_tum(gt, times, p_gt)
    cfg_path = os.path.join(root, "settings.yaml")
    write_settings(cfg_path, settings(model, n_cams, imu is not None
                                      and imu != "zeros"))
    return dict(sequence=seq, settings=cfg_path, gt=gt, n=n,
                t_gt=np.asarray(times), p_gt=p_gt, p_body=t_wb,
                p_cam0=p_cam0,
                frames=frames,
                depth=depths, imu=samples)


def write_rig_scene(root: str, frames, imu, p_gt, settings_dict: dict,
                    dt: float = DT) -> dict:
    """A rig sequence in the EuRoC layout under `root`: frames [T, C, H,
    W] uint8 as mav0/cam0..camC-1, imu (w, a, t) samples as mav0/imu0,
    frame i at i * dt seconds, the ground truth p_gt [T, 3] as gt.txt and
    `settings_dict` as settings.yaml. Returns dict(sequence, settings, gt,
    cams: the --cams value)."""
    seq = os.path.join(root, "seq")
    mav = os.path.join(seq, "mav0")
    n, n_cams = frames.shape[:2]
    times = [i * dt for i in range(n)]
    times_ns = [int(t * 1e9) for t in times]
    for c in range(n_cams):
        write_euroc_cam(mav, f"cam{c}", frames[:, c], times_ns)
    write_euroc_imu(mav, [(int(round(t * 1e9)), w, a)
                          for (w, a, t) in imu])
    gt = os.path.join(root, "gt.txt")
    write_gt_tum(gt, times, p_gt)
    cfg_path = os.path.join(root, "settings.yaml")
    write_settings(cfg_path, settings_dict)
    return dict(sequence=seq, settings=cfg_path, gt=gt,
                cams=",".join(f"cam{c}" for c in range(n_cams)))


def write_euroc_slice(src: str, dst: str, lo: int, hi: int,
                      cams=("cam0", "cam1")) -> str:
    """An EuRoC directory of frames lo..hi-1 of the EuRoC directory `src`
    (links to its PNGs) with the IMU samples from 50 ms before frame lo to
    frame hi-1: a session of a longer sequence. Returns `dst`."""
    import csv
    for cam in cams:
        os.makedirs(os.path.join(dst, "mav0", cam, "data"))
        with open(os.path.join(src, "mav0", cam, "data.csv")) as f:
            rows = [r for r in csv.reader(f)
                    if r and not r[0].startswith("#")]
        with open(os.path.join(dst, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for ts, name in rows[lo:hi]:
                os.symlink(os.path.join(src, "mav0", cam, "data", name),
                           os.path.join(dst, "mav0", cam, "data", name))
                f.write(f"{ts},{name}\n")
    t0, t1 = int(rows[lo][0]), int(rows[hi - 1][0])
    os.makedirs(os.path.join(dst, "mav0", "imu0"))
    with open(os.path.join(src, "mav0", "imu0", "data.csv")) as f:
        lines = f.readlines()
    with open(os.path.join(dst, "mav0", "imu0", "data.csv"), "w") as f:
        f.write(lines[0])
        for line in lines[1:]:
            if t0 - 50_000_000 < int(line.split(",")[0]) <= t1:
                f.write(line)
    return dst
