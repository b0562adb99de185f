"""The flagship benchmark scene, in numpy: the 4-camera rig, its rendered
sequence, the IMU batching and the tracker configuration of the reference
package's `bench.py` (`build_rig`, `render_rig_sequence`, the per-frame
IMU batches and the `VIStreamConfig` / `ImuNoise` values). Also the two
single-camera inertial scenes: a radtan-distorted EuRoC camera
(IMU_MONOCULAR) and an RGB-D camera with depth maps (IMU_RGBD), both on
the flagship's orbit in the same BlobWorld (`make_single_camera_sequence`,
`single_camera_config_kwargs`).

`chip_smoke.py` and the parity tests render the identical scenes without
importing jax. Sizes are parameters so the tests can cut the scenes down.
"""

from __future__ import annotations

import numpy as np

from .io import synthetic

W, H = 640, 480
FPS_IN = 20.0
N_FRAMES = 160
BASELINE_M = 0.2

PINHOLE, KB8 = 0, 1


def build_rig(kind_name: str = "kb8", w: int = W, h: int = H) -> dict:
    """4-camera rig: front stereo pair + left/right side cameras (the
    Hilti-2022 flagship layout minus the up camera), as numpy arrays:
    dict(kind, params [4,8], R_cb [4,3,3], t_cb [4,3])."""
    if kind_name == "kb8":
        pin = np.array([352.0, 352.0, w / 2, h / 2,
                        -0.0398, 0.0083, -0.0062, 0.0010], np.float32)
        kind = KB8
    else:
        pin = np.array([380.0, 380.0, w / 2, h / 2, 0, 0, 0, 0],
                       np.float32)
        kind = PINHOLE

    def yaw(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)

    R_cb = np.stack([np.eye(3, dtype=np.float32),
                     np.eye(3, dtype=np.float32),
                     yaw(np.pi / 2), yaw(-np.pi / 2)])
    centers = np.array([[-BASELINE_M / 2, 0, 0], [BASELINE_M / 2, 0, 0],
                        [-0.1, 0, 0], [0.1, 0, 0]], np.float32)
    t_cb = -np.einsum("cij,cj->ci", R_cb, centers)
    return dict(kind=kind, params=np.stack([pin] * 4), R_cb=R_cb, t_cb=t_cb)


def render_rig_sequence(rig_np: dict, R_wb, t_wb, w: int = W, h: int = H,
                        world_seed: int = 3, n_points: int = 4000):
    """[T, C, h, w] float32 frames of the BlobWorld seen by every camera."""
    world = synthetic.BlobWorld.create(seed=world_seed, n=n_points)
    frames = []
    for c in range(rig_np["R_cb"].shape[0]):
        R_cb = rig_np["R_cb"][c]
        c_b = -R_cb.T @ rig_np["t_cb"][c]
        R_wc = R_wb @ R_cb.T
        t_wc = t_wb + np.einsum("tij,j->ti", R_wb, c_b)
        frames.append(synthetic.render_sequence(
            world, rig_np["kind"], rig_np["params"][c], R_wc, t_wc, w, h))
    return np.stack(frames, axis=1).astype(np.float32)


def imu_batches(imu, n_frames: int, dt: float = 1.0 / FPS_IN):
    """Group IMU samples (w, a, t) by frame: [(t_frame, [samples...])]."""
    it = iter(imu)
    pending = next(it, None)
    out = []
    for i in range(n_frames):
        t = i * dt
        b = []
        while pending is not None and pending[2] <= t + 1e-9:
            b.append(pending)
            pending = next(it, None)
        out.append((t, b))
    return out


def make_sequence(n_frames: int = N_FRAMES, orbit_frac: float = 1.25,
                  kind_name: str = "kb8", w: int = W, h: int = H,
                  rate_mult: int = 20):
    """The bench scene: (rig_np, uint8 frames [T,C,h,w], R_wb, t_wb,
    per-frame IMU batches). rate_mult=20 is 400 Hz IMU at 20 fps."""
    rig_np = build_rig(kind_name, w, h)
    R_wb, t_wb = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=orbit_frac)
    frames = np.clip(render_rig_sequence(rig_np, R_wb, t_wb, w, h), 0,
                     255).astype(np.uint8)
    imu = synthetic.imu_from_trajectory(R_wb, t_wb, 1.0 / FPS_IN,
                                        rate_mult=rate_mult)
    return rig_np, frames, R_wb, t_wb, imu_batches(imu, n_frames)


# the bench's ImuNoise.from_sigmas arguments (400 Hz IMU)
NOISE_SIGMAS = (1.71e-4, 8.6e-3, 3.1e-6, 2.2e-4, 400.0)


def bench_config_kwargs(n_frames: int = N_FRAMES, max_kf: int = 64,
                        max_mp: int = 16384) -> dict:
    """The bench's VIStreamConfig keyword arguments at their defaults,
    loop closing off (orb is set by the caller: 512 features, 8 levels)."""
    return dict(
        img_w=W, img_h=H, n_cams=4, stereo_pairs=((0, 1),),
        imu_freq=400.0, imu_per_frame=32, max_kf=max_kf, max_mp=max_mp,
        traj_cap=n_frames + 32, ba_window=8, imu_init_kfs=6,
        kf_max_interval_s=0.25, temporal_refs=2, frames_per_dispatch=1,
        track_map_cap=0, po_rounds=2, po_iters=6, ba_stages=(3, 4),
        obs_cap=24576 if max_kf <= 64 else 131072, local_map_window=10)


# ORB-SLAM3's Examples/Monocular-Inertial/EuRoC.yaml: the EuRoC MAV's
# cam0, a radtan-distorted pinhole, and the yaml's IMU noise (gyro, acc,
# gyro walk, acc walk) at 200 Hz
EUROC_W, EUROC_H = 752, 480
EUROC_PINHOLE = (458.654, 457.296, 367.215, 248.375)
EUROC_RADTAN = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
EUROC_NOISE_SIGMAS = (1.7e-4, 2.0e-3, 1.9393e-5, 3.0e-3, 200.0)
# an undistorted RGB-D pinhole of the order of the RealSense D435i in
# ORB-SLAM3's Examples/RGB-D-Inertial
RGBD_W, RGBD_H = 640, 480
RGBD_PINHOLE = (382.6, 382.6, 320.0, 240.0)


def make_single_camera_sequence(n_frames: int, orbit_frac: float, w: int,
                                h: int, pinhole, dist=None,
                                depth: bool = False, rate_mult: int = 10,
                                world_seed: int = 3, n_points: int = 4000):
    """One pinhole camera whose frame is the body frame (R_cb = I,
    t_cb = 0) on the flagship's orbit: (rig_np, uint8 frames
    [T, 1, h, w], R_wb, t_wb, per-frame IMU batches, depth maps
    [T, 1, h, w] float32 z-depth with 0 where nothing is hit, or None).
    `dist`: radtan (k1, k2, p1, p2), the images rendered distorted.
    rate_mult=10 is 200 Hz IMU at 20 fps."""
    params = np.zeros(8, np.float32)
    params[:4] = pinhole
    rig_np = dict(kind=PINHOLE, params=params[None],
                  R_cb=np.eye(3, dtype=np.float32)[None],
                  t_cb=np.zeros((1, 3), np.float32))
    R_wb, t_wb = synthetic.orbit_trajectory(n_frames, radius=6.0,
                                            frac=orbit_frac)
    world = synthetic.BlobWorld.create(seed=world_seed, n=n_points)
    frames = synthetic.render_sequence(world, PINHOLE, params, R_wb, t_wb,
                                       w, h, dist=dist)
    frames = np.clip(frames, 0, 255).astype(np.uint8)[:, None]
    depths = None
    if depth:
        depths = synthetic.render_depth_sequence(
            world, PINHOLE, params, R_wb, t_wb, w, h).astype(
                np.float32)[:, None]
    imu = synthetic.imu_from_trajectory(R_wb, t_wb, 1.0 / FPS_IN,
                                        rate_mult=rate_mult)
    return (rig_np, frames, R_wb, t_wb, imu_batches(imu, n_frames),
            depths)


def single_camera_config_kwargs(n_frames: int, w: int, h: int,
                                max_kf: int = 64,
                                max_mp: int = 16384) -> dict:
    """`bench_config_kwargs` for one camera without a stereo pair at
    200 Hz IMU (the caller sets `orb` and, for RGB-D, `use_depth`)."""
    kw = bench_config_kwargs(n_frames, max_kf=max_kf, max_mp=max_mp)
    kw.update(img_w=w, img_h=h, n_cams=1, stereo_pairs=(), imu_freq=200.0)
    return kw
