"""System facade: the one-object public API of the framework (port of
`openmavis_tpu/pipeline/system.py`).

TPU-native replacement for the reference's System class (reference:
include/System.h:88-204 — ctor(voc, settings, sensor) spawning worker
threads; per-frame TrackMonocular/TrackStereo/TrackMulti; Shutdown;
SaveTrajectory{TUM,EuRoC}; SaveAtlas/LoadAtlas; localization-mode toggles).
The thread trio becomes synchronous pipeline stages; everything else keeps
the same surface.

The facade adds no math. It builds the settings' rig, the tracker, its
`LoopCloser` and its `Atlas` on one device (`device=`, the current CUDA
device when None), moves each frame's images there once (a uint8 image
stays uint8 until the tracker casts it on the device), remaps a
rectified stereo pair on the device (`frontend.rectify.remap_multicam`)
and hands the IMU samples to `feed_imu` in order.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..frontend import rectify as rect_mod
from ..io import serialization, settings as settings_mod, trajectory
from ..parallel import dist_ba
from ..slam_map import atlas as atlas_mod
from ..utils.timing import StageTimer
from . import loop_closing, multi_tracking, tracking


class Sensor(Enum):
    MONOCULAR = 0
    STEREO = 1
    MULTI = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    IMU_MULTI = 5       # the flagship MAVIS mode (reference System.h:65)
    RGBD = 6
    IMU_RGBD = 7        # (reference System.h:64 IMU_RGBD)


class System:
    """Facade owning the tracker, loop closer and map.

    Example:
        cfg = settings dict or yaml path (see io.settings)
        slam = System(cfg, Sensor.IMU_MULTI)          # on the current GPU
        for frame: slam.track_multi(images, t, imu_samples)
        slam.shutdown(); slam.save_trajectory_tum("traj.txt")
    """

    def __init__(self, config, sensor: Sensor,
                 enable_loop_closing: bool = True,
                 tracker_overrides: Optional[dict] = None,
                 seed: int = 0, use_viewer: bool = False,
                 viewer_port: int = 0, device=None):
        self.sensor = sensor
        self.device = dev = resolve_device(device)
        self.timer = StageTimer()
        s = settings_mod.load_settings(config, device=dev)
        self.settings = s
        rig = s["rig"]
        n_cams = rig.params.shape[0]
        inertial = sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO,
                              Sensor.IMU_MULTI, Sensor.IMU_RGBD)
        # stereo undistort-rectify: when the settings produced
        # rectification maps (distorted-pinhole stereo with a
        # Stereo.T_c1_c2 — reference: Settings.cc:683-725), the tracker
        # runs on the RECTIFIED rig (shared ideal pinhole, pure-baseline
        # extrinsics) and every incoming pair is remapped on the device
        # (cv::remap analog, one gather over both cameras)
        self._rect_maps = None
        if (s.get("rect") is not None
                and sensor in (Sensor.STEREO, Sensor.IMU_STEREO)):
            rig = rect_mod.rectified_rig(rig, s["rect"])
            self._rect_maps = torch.as_tensor(s["rect"]["maps"], device=dev)
            s = {**s, "dist": None}
        multi = sensor in (Sensor.STEREO, Sensor.MULTI, Sensor.IMU_STEREO,
                           Sensor.IMU_MULTI)
        # persistent pre-trained vocabulary (reference: the ORBvoc path
        # is System's first ctor arg, System.cc:79; binding by content
        # hash, System.cc:1520-1556). Optional: without one, LoopCloser
        # trains a session vocabulary from the live map.
        vocab = None
        self.vocab_md5 = None
        voc_path = (s["raw"].get("Vocabulary", {}) or {}).get("path")
        if voc_path:
            from ..slam_map import vocabulary as voc_mod
            vocab, self.vocab_md5 = voc_mod.load(voc_path, device=dev)

        overrides = dict(tracker_overrides or {})
        if multi or sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_RGBD):
            # IMU_MONOCULAR rides the inertial tracker as a 1-camera rig
            # with two-view init + scale-from-IMU (reference:
            # Examples/Monocular-Inertial/mono_inertial_tum_vi.cc);
            # IMU_RGBD the same rig with depth priors supplying metric
            # scale (reference: System.h:64 + Frame.cc depth path)
            default_pairs = ((0, 1),) if n_cams >= 2 else ()
            if sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_RGBD):
                default_pairs = ()
            if sensor == Sensor.IMU_RGBD:
                overrides.setdefault("use_depth", True)
            lap = s.get("lapping")
            cfg = multi_tracking.MultiTrackerConfig(
                img_w=s["camera_width"], img_h=s["camera_height"],
                n_cams=n_cams,
                stereo_pairs=tuple(overrides.pop(
                    "stereo_pairs", default_pairs)),
                lapping=(tuple(map(tuple, lap.tolist()))
                         if lap is not None else ()),
                orb=s["orb"], use_imu=inertial,
                imu_freq=s["imu_frequency"],
                **overrides)
            lc = (loop_closing.LoopCloser(vocab, cfg.max_kf, rig=rig,
                                          inertial=inertial,
                                          img_w=s["camera_width"],
                                          img_h=s["camera_height"],
                                          device=dev)
                  if enable_loop_closing else None)
            self.tracker = multi_tracking.MultiTracker(
                rig, cfg, noise=s["imu_noise"], seed=seed, loop_closer=lc,
                atlas=atlas_mod.Atlas(device=dev), dist=s["dist"],
                device=dev)
        elif sensor in (Sensor.MONOCULAR, Sensor.RGBD):
            cfg = tracking.TrackerConfig(
                img_w=s["camera_width"], img_h=s["camera_height"],
                orb=s["orb"], **overrides)
            lc = (loop_closing.LoopCloser(vocab, cfg.max_kf, rig=rig,
                                          img_w=s["camera_width"],
                                          img_h=s["camera_height"],
                                          device=dev)
                  if enable_loop_closing else None)
            self.tracker = tracking.Tracker(rig, cfg, seed=seed,
                                            loop_closer=lc,
                                            atlas=atlas_mod.Atlas(device=dev),
                                            dist=s["dist"], device=dev)
        else:
            raise ValueError(f"unsupported sensor {sensor}")
        self.loop_closer = lc
        self.cfg = cfg
        self._shutdown = False
        # interactive viewer (reference: System ctor's bUseViewer spawns
        # the Pangolin Viewer thread, src/System.cc:79 + Viewer.cc:Run;
        # here an HTTP live-stream server — see viewer.LiveViewer)
        self.viewer = None
        if use_viewer:
            from . import viewer as viewer_mod
            self.viewer = viewer_mod.LiveViewer(port=viewer_port)

    def _dev(self, x) -> torch.Tensor:
        """One host->device copy in the image's own dtype."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return torch.as_tensor(x).to(self.device)

    def _feed(self, imu_samples):
        if imu_samples is not None:
            for (w, a, t) in imu_samples:
                self.tracker.feed_imu(w, a, t)

    # -- per-frame entry points (reference System.h:88-129) ---------------
    def track_monocular(self, image, timestamp: float,
                        imu_samples=None) -> bool:
        """Single image; `imu_samples` iterable of (w, a, t) for
        IMU_MONOCULAR (reference: System::TrackMonocular,
        include/System.h:103)."""
        assert self.sensor in (Sensor.MONOCULAR, Sensor.IMU_MONOCULAR)
        image = self._dev(image)
        if self.sensor == Sensor.IMU_MONOCULAR:
            self._feed(imu_samples)
            image = image[None]
        with self.timer.stage("track"):
            ok = self.tracker.process_frame(image, timestamp)
        self._viewer_tick(timestamp)
        return ok

    def track_rgbd(self, image, depth, timestamp: float,
                   imu_samples=None) -> bool:
        """image [H, W], depth [H, W] metric z-depth, 0 = no measurement
        (reference: System::TrackRGBD, include/System.h:96; with
        `imu_samples` for IMU_RGBD)."""
        assert self.sensor in (Sensor.RGBD, Sensor.IMU_RGBD)
        image, depth = self._dev(image), self._dev(depth)
        if self.sensor == Sensor.IMU_RGBD:
            self._feed(imu_samples)
            image, depth = image[None], depth[None]
        with self.timer.stage("track"):
            ok = self.tracker.process_frame(image, timestamp, depth=depth)
        self._viewer_tick(timestamp)
        return ok

    def track_stereo(self, image_left, image_right,
                     timestamp: float, imu_samples=None) -> bool:
        """Rectified or fisheye stereo pair (reference: System::TrackStereo,
        include/System.h:88 — here stereo is a 2-camera rig; the baseline
        lives in the rig extrinsics and observations are per-camera)."""
        assert self.sensor in (Sensor.STEREO, Sensor.IMU_STEREO)
        images = torch.stack([self._dev(image_left),
                              self._dev(image_right)])
        return self.track_multi(images, timestamp, imu_samples)

    def track_multi(self, images, timestamp: float,
                    imu_samples=None, depth=None) -> bool:
        """images [C, H, W]; imu_samples iterable of (w, a, t); depth
        optional [C, H, W] per-camera z-depth priors (multi+depth rigs,
        reference: Frame.cc:1659-1765)."""
        assert self.sensor in (Sensor.STEREO, Sensor.MULTI,
                               Sensor.IMU_STEREO, Sensor.IMU_MULTI)
        self._feed(imu_samples)
        kw = {}
        if depth is not None:
            kw["depth"] = self._dev(depth)
        images = self._dev(images)
        if self._rect_maps is not None:
            images = rect_mod.remap_multicam(images, self._rect_maps)
        with self.timer.stage("track"):
            ok = self.tracker.process_frame(images, timestamp, **kw)
        self._viewer_tick(timestamp)
        return ok

    def _viewer_tick(self, timestamp: float):
        """Publish one snapshot to the live viewer (the Viewer thread's
        poll, src/Viewer.cc:Run). Gated on an attached stream client
        BEFORE gathering state: rasterize + trajectory walk + the map
        d2h must cost nothing when nobody is watching."""
        v = self.viewer
        if v is None or not v.attached:
            return
        _, _, t = self.tracker.get_trajectory()
        m = self.map
        n_kf, n_mp = torch.stack([m.n_kf, m.n_mp]).tolist()
        state = {
            "t": round(float(timestamp), 3),
            "tracking_state": str(self.tracker.state),
            "n_keyframes": int(n_kf),
            "n_landmarks": int(n_mp),
        }
        v.update(m, trajectory=t, state=state, force=True)

    # -- state -------------------------------------------------------------
    @property
    def map(self):
        return self.tracker.map

    def tracking_state(self):
        return self.tracker.state

    # -- runtime toggles (reference System.h:132-138, System.cc:92-96) ------
    def activate_localization_mode(self):
        """Track against the frozen map; no new keyframes / landmarks
        (reference: System::ActivateLocalizationMode — stops LocalMapping)."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def activate_lc(self):
        self.tracker.loop_closer = self.loop_closer

    def deactivate_lc(self):
        """Disable loop-closing (reference: `loopClosing` yaml kill-switch
        + ActivateLC, src/System.cc:92-96)."""
        self.tracker.loop_closer = None

    def reset(self):
        """Drop all maps and start over on the same device (reference:
        System::Reset)."""
        tr = self.tracker
        if tr.atlas is not None:
            tr.atlas.maps.clear()
        tr.__init__(tr.rig, tr.cfg,
                    **({"noise": tr.noise} if hasattr(tr, "noise") else {}),
                    seed=0, loop_closer=tr.loop_closer, atlas=tr.atlas,
                    dist=None if tr.dist is None else tr.dist.cpu().numpy(),
                    device=tr.device)

    def reset_active_map(self):
        """Abandon the active map, keep the Atlas (reference:
        System::ResetActiveMap -> Tracking::ResetActiveMap)."""
        if self.tracker.atlas is not None:
            self.tracker._spawn_new_map()
        else:
            self.reset()

    def shutdown(self):
        """(reference: System::Shutdown — here: stop the viewer server;
        compute stages are synchronous)."""
        if self.viewer is not None:
            self.viewer.close()
            self.viewer = None
        self._shutdown = True

    def run_global_ba(self, mesh=None):
        """Whole-map GBA over the current map (reference:
        LoopClosing::RunGlobalBundleAdjustment — the background GBA thread
        becomes an explicit call; matrix-free Schur+PCG on the device).
        Runs FullInertialBA (inertial edges from the tracker's
        preintegration chain, reference src/Optimizer.cc:368) once the
        IMU is initialized; visual-only GBA otherwise. `mesh`: None, one
        process's solve; else the landmark-sharded solve over a process
        group (`tracking.distributed_global_ba_step`), every rank of it
        calling: a `parallel.dist_ba.Mesh`, an int n (ranks 0..n-1 of the
        world; 1 with no world initialized is a one-rank group) or a list
        of ranks; ranks beyond the world raise ValueError. Returns the
        final chi2."""
        with self.timer.stage("gba"):
            tr = self.tracker
            inertial = (getattr(tr, "imu_initialized", False)
                        and hasattr(tr, "_kf_pre_batch"))
            pre_b = cvalid = None
            if inertial:
                pre_b, cvalid = tr._kf_pre_batch(tr.cfg.max_kf)
            if mesh is not None:
                m, chi = tracking.distributed_global_ba_step(
                    tr.map, tr.rig.kind, tr.rig,
                    dist_ba.resolve_mesh(mesh, tr.map.kf_t.device),
                    pre_b=pre_b, edge_valid=cvalid)
            elif inertial:
                m, chi = tracking.global_inertial_ba_step(
                    tr.map, pre_b, cvalid, tr.rig.kind, tr.rig)
            else:
                m, chi = tracking.global_ba_step(
                    tr.map, tr.rig.kind, tr.rig)
            tr.map = m
            if getattr(tr, "atlas", None) is not None:
                tr._sync_atlas()
        return float(chi)

    # -- persistence (reference System.h:141-204) --------------------------
    def save_trajectory_tum(self, path: str):
        times, R, t = self.tracker.get_trajectory()
        trajectory.save_tum(path, times, R, t)

    def save_trajectory_euroc(self, path: str):
        times, R, t = self.tracker.get_trajectory()
        trajectory.save_euroc(path, times, R, t)

    def save_trajectory_kitti(self, path: str):
        """(reference: System::SaveTrajectoryKITTI, src/System.cc:1240)"""
        times, R, t = self.tracker.get_trajectory()
        trajectory.save_kitti(path, times, R, t)

    def save_keyframe_trajectory_tum(self, path: str):
        m = self.tracker.map
        n = int(m.n_kf)
        trajectory.save_tum(path, m.kf_time[:n], m.kf_R[:n], m.kf_t[:n])

    def save_atlas(self, path: str):
        """Whole-Atlas checkpoint (every map + current index; reference:
        System::SaveAtlas, src/System.cc:1420-1458)."""
        tr = self.tracker
        if getattr(tr, "atlas", None) is not None:
            tr._sync_atlas()
            serialization.save_atlas(path, tr.atlas,
                                     {"sensor": self.sensor.name})
        else:
            serialization.save_map(path, tr.map,
                                   {"sensor": self.sensor.name})

    def load_atlas(self, path: str):
        """Every map of the checkpoint onto this System's device."""
        tr = self.tracker
        maps, current = serialization.load_atlas(
            path, {"sensor": self.sensor.name}, device=self.device)
        if getattr(tr, "atlas", None) is not None:
            tr.atlas.maps = maps
            tr.atlas.current = current
            tr.map = tr.atlas.current_map
            tr.map_id = current
        else:
            tr.map = maps[current]

    def print_time_stats(self):
        return self.timer.print_stats()
