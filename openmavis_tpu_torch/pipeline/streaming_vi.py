"""Streaming multi-camera visual-inertial tracker — the flagship MAVIS
pipeline, one `push` per frame (port of `openmavis_tpu/pipeline/
streaming_vi.py`).

Per frame: multi-camera extraction, IMU preintegration, prediction
(IMU once initialized, else constant velocity), multi-camera projection
tracking with visual or 15-dof inertial pose optimization, the keyframe
decision; on keyframes the mapper chain (stereo + temporal spawn, bind,
fuse, cull, chain welding, visual or VI window BA) and the staged IMU
initialization (InertialOptimization -> gravity-align -> FullInertialBA on
the VIBA1/VIBA2 schedule). A full keyframe slab is recycled before the
insertion (decimate if culling freed nothing, compact keyframes and
landmarks, weld the preintegration chain, re-base the trajectory ring). A
frame that fails to track puts the tracker in LOST: it coasts on the IMU
and every LOST frame tries `tracking.relocalize_step` for a pose proposal.
With `device_lc` the device loop closer (`streaming_lc.make_lc_step`) runs
after every frame's step, with the amortized post-loop FullInertialBA;
with a `secondary_map` (an earlier session's map) the device cross-map
merge (`streaming_lc.make_merge_step`) runs between the two and welds this
session into that map once it recognizes the place.

Three initializations: a rig with `stereo_pairs` starts metric on its
first frame from the rig baseline; `use_depth` adds depth-prior landmarks
there and at every keyframe (IMU_RGBD); a single camera without depth
(IMU_MONOCULAR) takes a reference frame, matches later frames against it
and initializes from a two-view reconstruction at arbitrary scale, which
the `fix_scale=False` inertial init makes metric. `dist` (radtan) lifts
the keypoints of distorted pinhole images to the ideal pinhole.

The reference package runs the step as one jitted program under
`lax.cond`/`lax.switch`; here each branch is a Python branch on a device
scalar, which reads it back to the host (a sync per decision).

With `loop_closer=` the host-policy `loop_closing.LoopCloser` runs on the
newest keyframe whenever the application calls `maybe_close_loop`.

`run_global_ba(mesh=...)` shards the whole-map solve over the ranks of a
process group (`parallel/`). `frames_per_dispatch > 1` (the reference's
chunking of frames into one dispatch for its transport) is left out and
raises NotImplementedError.

Reference parity map: per-frame flow Tracking::GrabImageMulti
src/Tracking.cc:1410; IMU preintegration :1625; prediction :1723; VI pose
optimization Optimizer::PoseInertialOptimizationLastFrame
src/Optimizer.cc:5580; keyframe pipeline src/LocalMapping.cc:395-786;
staged IMU init LocalMapping.cc:203-265, 1255; KF culling + chain merge
LocalMapping.cc:974 + ImuTypes.cc:241-263; relocalization
Tracking::Relocalization src/Tracking.cc:3543; mono-inertial init
Tracking::MonocularInitialization src/Tracking.cc:2411; depth priors
src/Frame.cc:1659-1765, 1916-1922.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..frontend import depth as depth_mod
from ..frontend import extractor, matcher
from ..geometry import cameras, lie
from ..imu import preintegration as pre_mod
from ..optim import pose_opt
from ..optim.reprojection import RigParams
from ..ops import scatter_max, set_rows
from ..parallel import dist_ba
from ..slam_map import map_state as ms
from ..solvers import two_view
from . import multi_tracking as mt
from . import streaming_lc
from . import tracking as trk
from .streaming import (INIT, LOST, NEED_REF, OK, TrajRing, _masked_median,
                        fetch, ring_append, ring_replay)

__all__ = ["VIStreamConfig", "VIStreamCarry", "StreamingVITracker",
           "init_carry"]


class VIStreamCarry(NamedTuple):
    """Tracker state (the reference package's device-resident carry)."""
    R: torch.Tensor            # [3,3] world-from-body
    p: torch.Tensor            # [3]
    v: torch.Tensor            # [3]
    bg: torch.Tensor           # [3] gyro bias
    ba: torch.Tensor           # [3] accel bias
    vel_R: torch.Tensor        # [3,3] constant-velocity motion model
    vel_t: torch.Tensor        # [3]
    mode: torch.Tensor         # [] i32: NEED_REF/INIT/OK/LOST
    imu_ok: torch.Tensor       # [] bool
    viba_stage: torch.Tensor   # [] i32: 0 none, 1 init, 2 VIBA1, 3 VIBA2
    first_kf_time: torch.Tensor
    last_kf_time: torch.Tensor
    last_time: torch.Tensor
    has_last: torch.Tensor     # [] bool
    last_kf_slot: torch.Tensor  # [] i32
    ref_kf_inliers: torch.Tensor
    lost_frames: torch.Tensor
    boost: torch.Tensor        # [] i32 frames of widened search post-LOST
    gen: torch.Generator       # replaces the reference's PRNG key (the
                               # two-view, PnP and Sim3 RANSAC draws)
    pre_acc: pre_mod.Preintegrated   # since last keyframe
    chain: pre_mod.Preintegrated     # [K] per-KF interval (k-1 -> k)
    chain_valid: torch.Tensor        # [K] bool
    ref_bank: dict             # mono two-view init reference bank
    ref_time: torch.Tensor
    traj: TrajRing


@dataclass(frozen=True)
class VIStreamConfig:
    img_w: int = 640
    img_h: int = 480
    n_cams: int = 4
    stereo_pairs: tuple = ((0, 1),)
    lapping: tuple = ()
    orb: extractor.OrbConfig = None
    use_imu: bool = True
    imu_freq: float = 200.0
    imu_per_frame: int = 32
    max_kf: int = 64
    max_mp: int = 8192
    traj_cap: int = 4096
    match_radius: float = 15.0
    relost_radius: float = 30.0
    local_map_window: int | None = None
    min_inliers_track: int = 20
    kf_min_inlier_frac: float = 0.75
    kf_min_inliers_abs: int = 60
    kf_max_interval_s: float = 0.5
    new_mp_cap: int = 256
    ba_window: int = 8
    ba_stages: tuple = (4, 6)
    temporal_refs: int = 2
    imu_init_kfs: int = 8
    viba1_time: float = 5.0
    viba2_time: float = 15.0
    init_min_matches: int = 80
    init_min_inliers: int = 50
    min_rig_landmarks: int = 40
    ba_every_kf: bool = True
    frames_per_dispatch: int = 1
    po_rounds: int = 4
    po_iters: int = 7
    obs_cap: int = 131072
    track_map_cap: int = 0
    use_depth: bool = False
    depth_cap: int = 256
    depth_max: float = 25.0
    depth_pin: tuple = ()

    @property
    def metric_scale(self) -> bool:
        return len(self.stereo_pairs) > 0 or self.use_depth


def _empty_bank(C: int, F: int, device) -> dict:
    CF = C * F
    return dict(
        xy=torch.zeros((CF, 2), device=device),
        desc=torch.zeros((CF, 256), dtype=torch.int8, device=device),
        level=torch.zeros(CF, dtype=torch.int32, device=device),
        sigma2=torch.ones(CF, device=device),
        cam=torch.arange(C, dtype=torch.int32,
                         device=device).repeat_interleave(F),
        valid=torch.zeros(CF, dtype=torch.bool, device=device))


def init_carry(cfg: VIStreamConfig, seed: int = 0,
               device=None) -> VIStreamCarry:
    device = resolve_device(device)
    F = (cfg.orb or extractor.OrbConfig()).n_features
    K, cap = cfg.max_kf, cfg.traj_cap

    def z(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    eye = torch.eye(3, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return VIStreamCarry(
        R=eye.clone(), p=z(3), v=z(3), bg=z(3), ba=z(3),
        vel_R=eye.clone(), vel_t=z(3),
        mode=i32(NEED_REF), imu_ok=z(dt=torch.bool), viba_stage=i32(0),
        first_kf_time=z(), last_kf_time=z(), last_time=z(),
        has_last=z(dt=torch.bool), last_kf_slot=i32(-1),
        ref_kf_inliers=i32(0), lost_frames=i32(0), boost=i32(0),
        gen=gen,
        pre_acc=pre_mod.init_preintegrated(z(6)),
        chain=pre_mod.chain_allocate(K, device=device),
        chain_valid=z(K, dt=torch.bool),
        ref_bank=_empty_bank(cfg.n_cams, F, device),
        ref_time=z(),
        traj=TrajRing(time=z(cap), ref=z(cap, dt=torch.int32),
                      R_rel=eye.repeat(cap, 1, 1), t_rel=z(cap, 3),
                      ok=z(cap, dt=torch.bool), idx=i32(0)),
    )


def _record(m: ms.MapState, c: VIStreamCarry, time, ok) -> VIStreamCarry:
    """Append the current pose, relative to its reference keyframe."""
    return c._replace(traj=ring_append(m, c.traj, c.last_kf_slot, c.R, c.p,
                                       time, ok))


def _bias(c: VIStreamCarry) -> torch.Tensor:
    return torch.cat([c.bg, c.ba])


class VIStep:
    """The per-frame step for one configuration and rig:
    `step(m, c, images, time, imu_w, imu_a, imu_dt, depth, sample_idx)
    -> (m, c)`. `dist`: optional [C, 4] radtan coefficients on the rig's
    device."""

    def __init__(self, cfg: VIStreamConfig, rig: RigParams,
                 noise: pre_mod.ImuNoise, dist=None):
        if cfg.frames_per_dispatch > 1:
            raise NotImplementedError(
                "frames_per_dispatch > 1 (the reference's chunking of "
                "frames into one dispatch) is left out of the port "
                "(ROADMAP.md)")
        self.cfg = cfg
        self.rig = rig
        self.noise = noise
        self.dist = dist
        # the first frame makes a metric map from the rig (stereo pairs
        # and/or depth priors); a single camera without depth initializes
        # from two views
        self.rig_init_ok = bool(cfg.stereo_pairs) or cfg.use_depth
        self.orb = cfg.orb or extractor.OrbConfig()
        self.F = self.orb.n_features
        self.C = cfg.n_cams
        self.CF = self.C * self.F
        self.W, self.H = float(cfg.img_w), float(cfg.img_h)
        self.Kmax = cfg.max_kf
        # what the last step ran beside plain tracking: "reloc" (began
        # LOST, so `relocalize_step` ran), "reloc_ok" (it found a pose),
        # "lost" (the frame ended without a track), "recycle" (the slab
        # was full) and "decimate" (culling had freed nothing)
        self.events: tuple = ()
        # the last step's recycle: each old keyframe slot's new slot, -1
        # where its keyframe went (None: no recycle)
        self.slot_map = None

    # ---------------- helpers ----------------
    def extract_bank(self, images):
        feats = extractor.extract_multicam(images, self.orb)
        if self.dist is not None:
            feats = extractor.undistort_features(feats, self.rig.params,
                                                 self.dist)
        return mt.concat_bands(feats)

    def band0_feats(self, bank) -> extractor.Features:
        return mt.band0_feats(bank, self.F)

    def min_last_of(self, c) -> int:
        if self.cfg.local_map_window is None:
            return -1
        return int(c.last_kf_slot) - self.cfg.local_map_window

    # ------------- chain welding across keyframe compaction -------------
    def weld_chain(self, chain, chain_valid, kf_valid_old, new_of_old):
        """Re-express the per-keyframe preintegration chain after
        compaction: the interval into each surviving keyframe is the
        composition of every old interval since the previous survivor (the
        closed form of IMU::Preintegrated::MergePrevious,
        src/ImuTypes.cc:241-263), valid when all of them were. The
        reference package scans the slots on the device; here the two
        masks are read once and the loop runs on the host.
        Returns (chain', chain_valid')."""
        K = self.Kmax
        dev = chain_valid.device
        ident = pre_mod.init_preintegrated(torch.zeros(6, device=dev))
        acc, ok_all = ident, True
        slots, entries, oks = [], [], []
        for k, (ev, surv) in enumerate(zip(chain_valid.tolist(),
                                           kf_valid_old.tolist())):
            if ev:
                acc = pre_mod.compose(acc, pre_mod.rebias(
                    pre_mod.chain_get(chain, k), acc.b))
            ok_all = ok_all and ev
            if surv:
                slots.append(k)
                entries.append(acc)
                oks.append(ok_all)
                acc, ok_all = ident, True
        chain2 = pre_mod.chain_allocate(K, device=dev)
        valid2 = torch.zeros(K, dtype=torch.bool, device=dev)
        if slots:
            tgt = new_of_old[torch.tensor(slots, device=dev)].to(torch.int64)
            chain2 = pre_mod.Preintegrated(*(
                set_rows(c2, tgt, torch.stack(xs))
                for c2, xs in zip(chain2, zip(*entries))))
            valid2 = set_rows(valid2, tgt, torch.tensor(oks, device=dev))
        return chain2, valid2

    def recycle(self, m, c):
        """Free keyframe and landmark slots when the slab is full:
        decimate if redundancy culling freed nothing, compact, weld the
        chain, and re-base the trajectory ring and `last_kf_slot`.

        A ring entry whose reference keyframe goes is re-expressed
        relative to the nearest preceding survivor, as
        `tracking.recycle_map_slots` does on the host, so that its world
        pose stays where it was. (The reference package's device recycle
        remaps `traj.ref` alone and leaves such an entry's relative pose
        as it was, which moves the frame by the offset between the two
        keyframes.)

        Sets `slot_map` [K]: each old slot's new slot, -1 where its
        keyframe went (`streaming_lc.remap_slots` moves the loop closer's
        carry with it)."""
        K = self.Kmax
        self.events += ("recycle",)
        if int(torch.sum(m.kf_valid)) >= K:
            m, _ = ms.decimate_keyframes(m, int(m.n_kf) - 1)
            self.events += ("decimate",)
        old = m
        m, _, new_of_old = ms.compact_keyframes(m)
        self.slot_map = torch.where(old.kf_valid, new_of_old, -1)
        chain2, cvalid2 = self.weld_chain(c.chain, c.chain_valid,
                                          old.kf_valid, new_of_old)
        m, _ = ms.compact_landmarks(m)

        tr = c.traj
        ref = torch.clamp(tr.ref, 0, K - 1).to(torch.int64)
        # nearest preceding surviving slot (slot 0 when there is none)
        idx = torch.arange(K, device=ref.device)
        prev = torch.cummax(torch.where(old.kf_valid, idx, 0), 0).values[ref]
        gone = ~old.kf_valid[ref]
        R_w = old.kf_R[ref] @ tr.R_rel
        t_w = old.kf_t[ref] + lie._mv(old.kf_R[ref], tr.t_rel)
        R_p = old.kf_R[prev].transpose(-1, -2)
        tr = tr._replace(
            ref=new_of_old[ref],
            R_rel=torch.where(gone[:, None, None], R_p @ R_w, tr.R_rel),
            t_rel=torch.where(gone[:, None],
                              lie._mv(R_p, t_w - old.kf_t[prev]), tr.t_rel))
        last = torch.clamp(c.last_kf_slot, 0, K - 1).to(torch.int64)
        return m, c._replace(chain=chain2, chain_valid=cvalid2, traj=tr,
                             last_kf_slot=new_of_old[last])

    # ------------------ staged IMU initialization ------------------
    def imu_init_maybe(self, m, c, time):
        """InertialOptimization -> ApplyScaledRotation -> FullInertialBA
        on the VIBA schedule (reference: LocalMapping.cc:203-265, 1255)."""
        cfg, K = self.cfg, self.Kmax
        if not cfg.use_imu:
            return m, c
        n_kf = int(m.n_kf)
        idx = torch.arange(1, K, device=m.kf_valid.device)
        edge_valid = (c.chain_valid[1:] & m.kf_valid[1:] & m.kf_valid[:-1]
                      & (idx < n_kf))
        enough = int(torch.sum(edge_valid.to(torch.int32))) >= n_kf - 2
        tinit = float(time - c.first_kf_time)
        st = int(c.viba_stage)
        # the comparisons run in float32, as in the reference
        tinit32 = np.float32(tinit)
        want = ((st == 0 and n_kf >= cfg.imu_init_kfs)
                or (st == 1 and tinit32 > np.float32(cfg.viba1_time))
                or (st == 2 and tinit32 > np.float32(cfg.viba2_time)))
        if not (want and enough and n_kf >= 3 and st < 3):
            return m, c
        first = st == 0
        metric = cfg.metric_scale
        prior_g = 1e2 if first else (1.0 if st == 1 else 0.0)
        prior_a = (1e5 if metric else 1e10) if first else (
            1e5 if st == 1 else 0.0)
        pre_b = c.chain.map(lambda x: x[1:])
        m2, _, ok = mt.imu_init_step(
            m, pre_b, edge_valid, _bias(c), first, prior_g, prior_a,
            metric, self.rig,
            obs_cap=min(cfg.obs_cap, K * self.C * self.F))
        if not ok:
            return m2, c
        slot = max(int(c.last_kf_slot), 0)
        c = c._replace(R=m2.kf_R[slot], p=m2.kf_t[slot], v=m2.kf_v[slot],
                       bg=m2.kf_bg[slot], ba=m2.kf_ba[slot],
                       imu_ok=torch.ones_like(c.imu_ok),
                       viba_stage=c.viba_stage + 1)
        return m2, c

    # ------------------ window BA (VI) ------------------
    def vi_window_ba(self, m, c, slot: int):
        """VI window BA over the last `ba_window` keyframes with the
        temporal inertial chain (reference: LocalInertialBA,
        src/Optimizer.cc:4763)."""
        Wn = self.cfg.ba_window
        lo = max(slot - Wn + 1, 0)
        dev = m.kf_valid.device
        ids = lo + torch.arange(Wn, device=dev)
        ids_c = torch.clamp(ids, max=self.Kmax - 1)
        kf_in = (ids <= slot) & m.kf_valid[ids_c]
        pre_w = c.chain.map(lambda x: x[ids_c[1:]])
        edge_ok = (c.chain_valid[ids_c[1:]] & kf_in[1:] & kf_in[:-1]
                   & c.imu_ok)
        m, bias_new = mt.vi_window_ba_step(
            m, ids, kf_in, pre_w, edge_ok, slot - lo, self.rig.kind,
            self.rig, stages=self.cfg.ba_stages)
        return m, c._replace(bg=bias_new[:3], ba=bias_new[3:])

    # ------------------ keyframe pipeline ------------------
    def kf_insert(self, m, c, bank, time, feat_mp, n_in, depth=None):
        cfg, rig, K = self.cfg, self.rig, self.Kmax
        if int(m.n_kf) >= K:
            m, c = self.recycle(m, c)
        slot = int(m.n_kf)
        m = ms.insert_keyframe(
            m, slot, c.R, c.p, c.v, c.bg, c.ba, time,
            bank["xy"], bank["desc"], bank["level"], bank["sigma2"],
            bank["cam"], bank["valid"], feat_mp)
        if cfg.use_imu:
            acc_ok = (c.pre_acc.dT > 0) & (c.last_kf_slot >= 0)
            c = c._replace(
                chain=pre_mod.chain_set(c.chain, slot, c.pre_acc),
                chain_valid=set_rows(c.chain_valid, slot, acc_ok),
                pre_acc=pre_mod.init_preintegrated(_bias(c)))

        # depth-prior points first: measured metric depth beats
        # triangulation and needs no parallax (Frame.cc:1916-1922)
        if cfg.use_depth:
            m, _ = self.depth_spawn(m, slot, depth)
        for pair in cfg.stereo_pairs:
            m, _ = mt.stereo_spawn(m, slot, rig.kind, self.C, rig, pair,
                                   cap_new=cfg.new_mp_cap,
                                   lap1=mt._lap(cfg, pair[0]),
                                   lap2=mt._lap(cfg, pair[1]))
        if cfg.temporal_refs > 0:
            refs = [slot - 1 - j for j in range(cfg.temporal_refs)]
            m, _ = mt.temporal_spawn_multi(m, slot, refs, rig.kind, self.C,
                                           rig, cfg.new_mp_cap,
                                           n_refs=cfg.temporal_refs)
        m = mt.bind_landmarks_multi(m, slot, rig.kind, self.C, rig,
                                    self.W, self.H,
                                    min_last_kf=self.min_last_of(c))
        m = trk.fuse_new_landmarks(m, slot, cap=cfg.new_mp_cap)
        m = trk.cull_landmarks(m, slot)
        m, culled = trk.cull_keyframes(m, slot, inertial=cfg.use_imu,
                                       imu_ok=c.imu_ok)
        if cfg.use_imu:
            # weld the temporal chain across each culled keyframe
            # (MergePrevious, src/ImuTypes.cc:241); culls are never
            # adjacent within one pass, so the welds are disjoint
            for ck in culled.tolist():
                if ck < 0 or ck + 1 >= K:
                    continue
                a = pre_mod.chain_get(c.chain, ck)
                b = pre_mod.chain_get(c.chain, ck + 1)
                welded = pre_mod.compose(a, pre_mod.rebias(b, a.b))
                cv = c.chain_valid
                ok_w = cv[ck] & cv[ck + 1]
                cv = set_rows(set_rows(cv, ck + 1, ok_w), ck, False)
                c = c._replace(
                    chain=pre_mod.chain_set(c.chain, ck + 1, welded),
                    chain_valid=cv)

        m = ms.update_mp_geometry(m)
        if cfg.ba_every_kf:
            if cfg.use_imu and bool(c.imu_ok):
                m, c = self.vi_window_ba(m, c, slot)
            else:
                m, _ = trk.local_ba_step(m, slot, rig.kind, rig,
                                         window=cfg.ba_window)

        c = c._replace(
            last_kf_slot=torch.full_like(c.last_kf_slot, slot),
            last_kf_time=time,
            first_kf_time=torch.where(c.last_kf_slot < 0, time,
                                      c.first_kf_time),
            ref_kf_inliers=torch.clamp(n_in, min=1).to(torch.int32),
            R=m.kf_R[slot], p=m.kf_t[slot], v=m.kf_v[slot])
        return self.imu_init_maybe(m, c, time)

    def depth_spawn(self, m, slot: int, depth):
        """Depth-prior landmarks for keyframe `slot` (`use_depth`)."""
        cfg = self.cfg
        return depth_mod.spawn_from_depth_multi(
            m, slot, self.rig.kind, self.C, self.rig, depth,
            pin_params=cfg.depth_pin or None, cap_new=cfg.depth_cap,
            max_spawn_depth=cfg.depth_max)

    # ------------------ rig init ------------------
    def rig_init(self, m, c, bank, time, depth=None):
        """First-frame metric init from the rig baseline (reference:
        Tracking::MultiInitialization, src/Tracking.cc:2339) and/or depth
        priors (StereoInitialization's depth path, src/Tracking.cc:2232)."""
        cfg, rig = self.cfg, self.rig
        dev = c.p.device
        eye, z3 = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        m2 = ms.insert_keyframe(
            m, 0, eye, z3, z3, c.bg, c.ba, time,
            bank["xy"], bank["desc"], bank["level"], bank["sigma2"],
            bank["cam"], bank["valid"],
            torch.full((self.CF,), -1, dtype=torch.int32, device=dev))
        total = 0
        if cfg.use_depth:
            m2, total = self.depth_spawn(m2, 0, depth)
        for pair in cfg.stereo_pairs:
            m2, n = mt.stereo_spawn(m2, 0, rig.kind, self.C, rig, pair,
                                    cap_new=cfg.new_mp_cap,
                                    lap1=mt._lap(cfg, pair[0]),
                                    lap2=mt._lap(cfg, pair[1]))
            total = total + n
        m2 = ms.update_mp_geometry(m2)
        success = bool(total >= cfg.min_rig_landmarks)
        c2 = c._replace(R=eye, p=z3,
                        pre_acc=pre_mod.init_preintegrated(_bias(c)))
        if not success:
            return m, c2
        return m2, c2._replace(
            mode=torch.full_like(c.mode, OK),
            last_kf_slot=torch.zeros_like(c.last_kf_slot),
            last_kf_time=time, first_kf_time=time,
            ref_kf_inliers=torch.as_tensor(total, dtype=torch.int32,
                                           device=dev))

    # ------------------ mono two-view init ------------------
    def mono_need_ref(self, c, bank, time):
        """Take this frame as the two-view reference."""
        return c._replace(ref_bank=bank, ref_time=time,
                          mode=torch.full_like(c.mode, INIT),
                          pre_acc=pre_mod.init_preintegrated(_bias(c)))

    def mono_do_init(self, m, c, bank, time, idx, matched,
                     sample_idx=None):
        """Two-view reconstruction on camera 0's band (reference:
        Tracking::MonocularInitialization, src/Tracking.cc:2411): median
        depth scaled to 1, the triangulated points become landmarks seen
        by keyframes 0 (the reference frame) and 1 (this frame), a
        two-keyframe BA, and the chain entry KF0 -> KF1. The scale stays
        arbitrary until the fix_scale=False inertial init. On failure this
        frame becomes the reference. One host read (`success`)."""
        cfg, rig, F, CF = self.cfg, self.rig, self.F, self.CF
        dev = c.p.device
        b0 = c.ref_bank

        def bearing_z1(b):
            ray = cameras.unproject(rig.kind, rig.params[0], b["xy"][:F])
            z = torch.clamp(ray[:, 2], min=1e-6)
            return ray[:, :2] / z[:, None]

        safe = torch.where(matched, idx, 0).to(torch.int64)
        res = two_view.reconstruct(
            c.gen, bearing_z1(b0)[safe], bearing_z1(bank), matched,
            focal=rig.params[0, 0], min_inliers=cfg.init_min_inliers,
            sample_idx=sample_idx)
        good = res.is_good
        M = m.mp_pos.shape[0]
        order = torch.cumsum(good, 0, dtype=torch.int32) - 1
        write = good & (order < M)
        n_new = torch.sum(write, dtype=torch.int32)
        success_t = res.success & (n_new >= cfg.init_min_inliers)
        success = bool(success_t)
        if cfg.use_imu:
            # KF0 -> KF1 interval = everything accumulated since the ref
            # (written on failure too, and left invalid, as the reference)
            c = c._replace(
                chain=pre_mod.chain_set(c.chain, 1, c.pre_acc),
                chain_valid=set_rows(c.chain_valid, 1,
                                     success_t & (c.pre_acc.dT > 0)))
        if not success:
            return m, c._replace(ref_bank=bank, ref_time=time)

        med = _masked_median(res.points[:, 2], good)
        scale = 1.0 / torch.clamp(med, min=1e-6)
        pts_c0 = res.points * scale
        R01, t01 = res.R, res.t * scale
        R_w1, t_w1 = R01.T, -R01.T @ t01

        slot_mp = torch.where(write, order, M).to(torch.int64)
        obs1 = torch.full((CF,), -1, dtype=torch.int32, device=dev)
        obs1[:F] = torch.where(write, order, -1)
        # keyframe 0's bindings through the matches; the sentinel row
        # CF - 1 takes -1, which a real binding there out-maxes
        hit = write & (idx >= 0)
        obs0 = scatter_max(
            torch.full((CF,), -1, dtype=torch.int32, device=dev),
            torch.where(hit, idx, CF - 1), torch.where(hit, order, -1))
        mp_pos = torch.zeros((M + 1, 3), device=dev)
        mp_pos[slot_mp] = pts_c0
        mp_desc = torch.zeros((M + 1, 256), dtype=torch.int8, device=dev)
        mp_desc[slot_mp] = bank["desc"][:F]
        newly = torch.zeros(M + 1, dtype=torch.bool, device=dev)
        newly[slot_mp] = write
        newly = newly[:M]
        m2 = m._replace(
            mp_pos=torch.where(newly[:, None], mp_pos[:M], m.mp_pos),
            mp_desc=torch.where(newly[:, None], mp_desc[:M], m.mp_desc),
            mp_valid=newly, n_mp=n_new)
        z3 = torch.zeros(3, device=dev)
        m2 = ms.insert_keyframe(
            m2, 0, torch.eye(3, device=dev), z3, z3, c.bg, c.ba, c.ref_time,
            b0["xy"], b0["desc"], b0["level"], b0["sigma2"], b0["cam"],
            b0["valid"], obs0)
        m2 = ms.insert_keyframe(
            m2, 1, R_w1, t_w1, z3, c.bg, c.ba, time,
            bank["xy"], bank["desc"], bank["level"], bank["sigma2"],
            bank["cam"], bank["valid"], obs1)
        m2 = ms.update_mp_geometry(m2)
        m2, _ = trk.local_ba_step(m2, 1, rig.kind, rig, window=2)
        c = c._replace(
            R=R_w1, p=t_w1, mode=torch.full_like(c.mode, OK),
            last_kf_slot=torch.ones_like(c.last_kf_slot),
            last_kf_time=time, first_kf_time=c.ref_time,
            ref_kf_inliers=n_new)
        if cfg.use_imu:
            c = c._replace(pre_acc=pre_mod.init_preintegrated(_bias(c)))
        return m2, c

    def mono_init(self, m, c, bank, time, sample_idx=None):
        """Match camera 0's band against the reference frame's; with
        enough matches attempt the two-view init, else slide the
        reference to this frame."""
        F = self.F
        b0 = c.ref_bank
        idx, _ = matcher.match_nn(
            bank["desc"][:F], bank["valid"][:F], b0["desc"][:F],
            b0["valid"][:F], max_dist=matcher.TH_LOW, ratio=0.9,
            mutual=True)
        matched = idx >= 0
        if int(torch.sum(matched)) >= self.cfg.init_min_matches:
            return self.mono_do_init(m, c, bank, time, idx, matched,
                                     sample_idx)
        return m, c._replace(ref_bank=bank, ref_time=time,
                             pre_acc=pre_mod.init_preintegrated(_bias(c)))

    # ------------------ tracking branch ------------------
    def branch_track(self, m, c, bank, time, pre_f, has_pre: bool,
                     depth=None):
        cfg, rig = self.cfg, self.rig
        lost = int(c.mode) == LOST
        # prediction: IMU when initialized, else constant velocity; when
        # LOST, the relocalization's pose if it finds one (reference:
        # Tracking.cc:1723, 3543)
        use_vi = bool(c.imu_ok) and has_pre and cfg.use_imu
        if use_vi:
            R_pred, t_pred, v_pred = pre_mod.predict_state(
                c.R, c.p, c.v, pre_f, _bias(c))
        else:
            R_pred, t_pred, v_pred = (c.R @ c.vel_R, c.p + c.R @ c.vel_t,
                                      c.v)
        if lost:
            okr, R_r, t_r, _ = trk.relocalize_step(
                m, self.band0_feats(bank), c.gen, rig.kind, rig)
            R_pred = torch.where(okr, R_r, R_pred)
            t_pred = torch.where(okr, t_r, t_pred)
        min_last = self.min_last_of(c)
        # widened search for a few frames after a LOST episode
        # (reference: doubled th when recently relocalized,
        # src/Tracking.cc:2020-2060)
        radius = torch.where(c.boost > 0, cfg.relost_radius,
                             cfg.match_radius).to(torch.float32)
        common = dict(map_cap=cfg.track_map_cap, po_rounds=cfg.po_rounds,
                      po_iters=cfg.po_iters)
        if use_vi:
            anchor = pose_opt.InertialState(R=c.R, p=c.p, v=c.v, bg=c.bg,
                                            ba=c.ba)
            pred = pose_opt.InertialState(R=R_pred, p=t_pred, v=v_pred,
                                          bg=c.bg, ba=c.ba)
            st, feat_mp, n_in, vis, keep = mt.track_step_multi_vi(
                m, bank, anchor, pred, pre_f, rig.kind, self.C, rig,
                self.W, self.H, radius, min_last, **common)
            R2, t2, v2, bg2, ba2 = st
        else:
            R2, t2, feat_mp, n_in, vis, keep = mt.track_step_multi(
                m, bank, R_pred, t_pred, rig.kind, self.C, rig, self.W,
                self.H, radius, min_last, **common)
            v2, bg2, ba2 = v_pred, c.bg, c.ba

        # wide visual retry from the last confirmed pose
        retry = bool(n_in < cfg.min_inliers_track)
        if retry:
            R2, t2, feat_mp, n_in, vis, keep = mt.track_step_multi(
                m, bank, c.R, c.p, rig.kind, self.C, rig, self.W, self.H,
                cfg.relost_radius, min_last, **common)
            v2, bg2, ba2 = v_pred, c.bg, c.ba
        vi_upd = use_vi and not retry

        ok = n_in >= cfg.min_inliers_track
        dt = torch.clamp(time - c.last_time, min=1e-3)
        v_fd = (t2 - c.p) / dt
        coast = ~ok & c.imu_ok & has_pre
        R_new = torch.where(ok, R2, torch.where(coast, R_pred, c.R))
        t_new = torch.where(ok, t2, torch.where(coast, t_pred, c.p))
        v_new = torch.where(ok, v2 if vi_upd else v_fd,
                            torch.where(coast, v_pred, c.v))
        recovered = ok & (lost or retry)
        upd = ok & vi_upd
        c = c._replace(
            R=R_new, p=t_new, v=v_new,
            bg=torch.where(upd, bg2, c.bg), ba=torch.where(upd, ba2, c.ba),
            vel_R=torch.where(ok, c.R.T @ R2, c.vel_R),
            vel_t=torch.where(ok, c.R.T @ (t2 - c.p), c.vel_t),
            mode=torch.where(ok, OK, LOST).to(torch.int32),
            lost_frames=torch.where(ok, 0, c.lost_frames + 1).to(
                torch.int32),
            boost=torch.where(recovered, 5, torch.clamp(
                c.boost - ok.to(torch.int32), min=0)).to(torch.int32))
        m = m._replace(
            mp_visible=m.mp_visible + (vis & ok).to(torch.int32),
            mp_found=m.mp_found + (keep & ok).to(torch.int32))

        kf_cond = ((n_in < cfg.kf_min_inlier_frac
                    * torch.clamp(c.ref_kf_inliers, min=1))
                   | (n_in < cfg.kf_min_inliers_abs)
                   | (cfg.use_imu & (time - c.last_kf_time
                                     > cfg.kf_max_interval_s)))
        # one read decides the keyframe and names the frame's events
        ok_h, kf_h, *reloc_h = torch.stack(
            [ok, kf_cond] + ([okr] if lost else [])).tolist()
        if lost:
            self.events += ("reloc", "reloc_ok") if reloc_h[0] else ("reloc",)
        if not ok_h:
            self.events += ("lost",)
        need_kf = ok_h and kf_h
        if need_kf:
            return self.kf_insert(m, c, bank, time, feat_mp, n_in, depth)
        return m, c

    # ------------------ the step ------------------
    def step(self, m: ms.MapState, c: VIStreamCarry, images, time,
             imu_w, imu_a, imu_dt, depth=None, sample_idx=None):
        """depth: [C, H, W] float32 on the device (`use_depth`);
        sample_idx: optional two-view samples (idx8 [256, 8],
        idx4 [256, 4]) for a frame that attempts the mono init."""
        self.events, self.slot_map = (), None
        images = images.to(torch.float32)
        bank = self.extract_bank(images)
        has_pre = False
        pre_f = pre_mod.init_preintegrated(_bias(c))
        if self.cfg.use_imu:
            pre_f = pre_mod.integrate(imu_w, imu_a, imu_dt, _bias(c),
                                      self.noise)
            has_pre = bool((pre_f.dT > 0) & c.has_last)
            if has_pre:
                c = c._replace(pre_acc=pre_mod.compose(
                    c.pre_acc, pre_mod.rebias(pre_f, c.pre_acc.b)))
        mode = int(c.mode)
        if mode < OK and self.rig_init_ok:
            # rig configs never enter INIT
            m, c = self.rig_init(m, c, bank, time, depth)
        elif mode == NEED_REF:
            c = self.mono_need_ref(c, bank, time)
        elif mode == INIT:
            m, c = self.mono_init(m, c, bank, time, sample_idx)
        else:
            m, c = self.branch_track(m, c, bank, time, pre_f, has_pre,
                                     depth)
        c = _record(m, c, time, c.mode == OK)
        return m, c._replace(last_time=time,
                             has_last=torch.ones_like(c.has_last))


class StreamingVITracker:
    """Host wrapper around the per-frame step.

    Usage:
        tr = StreamingVITracker(rig, cfg, noise)   # on the current GPU
        for imgs, t, samples in stream:
            tr.push(imgs, t, samples)
        times, R, t = tr.get_trajectory()
    """

    def __init__(self, rig: RigParams, cfg: VIStreamConfig,
                 noise: pre_mod.ImuNoise | None = None, seed: int = 0,
                 device=None, dist=None, loop_closer=None,
                 device_lc=False, secondary_map=None, merge_kw=None):
        """dist: optional [C, 4] radtan (k1, k2, p1, p2) per camera of a
        distorted pinhole rig: the images are the raw ones, and the
        keypoints are undistorted before anything uses them."""
        """secondary_map: an earlier session's MapState of this
        configuration's capacities, kept on the device; with `device_lc`
        the merge step (`streaming_lc.make_merge_step(**merge_kw)`) welds
        this session into it (reference: MergeLocal2,
        src/LoopClosing.cc:1956)."""
        if secondary_map is not None and not device_lc:
            raise ValueError("secondary_map requires device_lc")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.noise = (noise or pre_mod.ImuNoise.from_sigmas(
            1.7e-4, 2e-3, 1.9e-5, 3e-3, cfg.imu_freq,
            device=self.device)).to(self.device)
        self.rig = rig.to(self.device)
        self.dist = None if dist is None else torch.as_tensor(
            np.asarray(dist, np.float32)).to(self.device)
        orb_cfg = cfg.orb or extractor.OrbConfig()
        self._step = VIStep(cfg, self.rig, self.noise, self.dist)
        self.map = ms.allocate(cfg.max_kf, cfg.n_cams * orb_cfg.n_features,
                               cfg.max_mp, device=self.device)
        self.carry = init_carry(cfg, seed, device=self.device)
        # device loop closing: the whole detect -> verify -> correct chain
        # after each frame's step (bool, or a dict of make_lc_step keywords)
        self._lc_step = None
        self.lc_carry = None
        # what the loop closer ran on the last push, from "gba_step",
        # "attempt" and "correction" (empty without loop closing)
        self.lc_events: tuple = ()
        # what the tracking step ran on the last push beside plain
        # tracking (`VIStep.events`)
        self.step_events: tuple = ()
        # the device cross-map merge against `map2` ("merge_attempt",
        # "weld" land in lc_events before the loop closer's)
        self._merge_step = None
        self.map2 = None
        if device_lc:
            lc_kw = device_lc if isinstance(device_lc, dict) else {}
            self._lc_step = streaming_lc.make_lc_step(
                cfg, self.rig.kind, cfg.n_cams, cfg.use_imu,
                float(cfg.img_w), float(cfg.img_h), **lc_kw)
            self.lc_carry = streaming_lc.init_lc_carry(device=self.device)
        if secondary_map is not None:
            shapes = (secondary_map.kf_obs.shape,
                      secondary_map.mp_pos.shape) if isinstance(
                secondary_map, ms.MapState) else None
            if shapes != (self.map.kf_obs.shape, self.map.mp_pos.shape):
                raise ValueError(
                    "secondary_map must be a MapState of this tracker's "
                    "capacities (max_kf, n_cams * n_features, max_mp)")
            self.map2 = ms.MapState(*(x.to(self.device)
                                      for x in secondary_map))
            self._merge_step = streaming_lc.make_merge_step(
                cfg, self.rig.kind, cfg.n_cams, cfg.use_imu,
                float(cfg.img_w), float(cfg.img_h), **(merge_kw or {}))
        self._t_prev: float | None = None
        self._snap = None
        # host-policy loop closing (`maybe_close_loop`)
        self.loop_closer = loop_closer
        self._last_lc_slot = -1

    def _imu_arrays(self, samples, t_now: float):
        """Pad host IMU samples into fixed [S,3]/[S,3]/[S] buffers covering
        (t_prev, t_now]."""
        S = self.cfg.imu_per_frame
        w = np.zeros((S, 3), np.float32)
        a = np.zeros((S, 3), np.float32)
        dt = np.zeros((S,), np.float32)
        if samples and self._t_prev is not None:
            prev = self._t_prev
            j = 0
            for (ws, as_, ts) in samples:
                if ts <= prev or j >= S:
                    continue
                step_dt = min(ts, t_now) - prev
                if step_dt <= 0:
                    continue
                w[j], a[j], dt[j] = ws, as_, step_dt
                prev = min(ts, t_now)
                j += 1
            if j and prev < t_now and j < S:
                w[j], a[j] = w[j - 1], a[j - 1]
                dt[j] = t_now - prev
        return w, a, dt

    def push(self, images, time: float, imu_samples=(), depth=None,
             sample_idx=None):
        """images: [C,H,W] (uint8 or float32); imu_samples: iterable of
        (w, a, t); depth: [C,H,W] float32 z-depth maps, 0 = hole
        (`use_depth` configurations only, ignored otherwise); sample_idx:
        optional two-view samples for this frame (`VIStep.step`)."""
        w, a, dt = self._imu_arrays(list(imu_samples), time)
        dev = self.device
        dep = None
        if self.cfg.use_depth:
            if depth is None:
                raise ValueError("cfg.use_depth=True but push() got no "
                                 "depth stack")
            dep = torch.as_tensor(np.asarray(depth, np.float32)).to(dev)
        imgs = torch.as_tensor(np.asarray(images)).to(dev)
        t = torch.tensor(time, dtype=torch.float32, device=dev)
        self.map, self.carry = self._step.step(
            self.map, self.carry, imgs, t, torch.as_tensor(w).to(dev),
            torch.as_tensor(a).to(dev), torch.as_tensor(dt).to(dev), dep,
            sample_idx)
        self.step_events = self._step.events
        if self._lc_step is not None:
            if self._step.slot_map is not None:
                # the closer's slots follow their keyframes through the
                # recycle (the reference keeps the old indices)
                self.lc_carry = streaming_lc.remap_slots(
                    self.lc_carry, self._step.slot_map)
            merge_events = ()
            if self._merge_step is not None:
                self.map, self.carry, self.lc_carry = self._merge_step(
                    self.map, self.carry, self.lc_carry, self.map2,
                    self.rig)
                merge_events = self._merge_step.events
            self.map, self.carry, self.lc_carry = self._lc_step(
                self.map, self.carry, self.lc_carry, self.rig)
            self.lc_events = merge_events + self._lc_step.events
        self._t_prev = time
        self._snap = None

    def block(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _adopt(self, m2: ms.MapState) -> None:
        """Take `m2` (this map's keyframes, moved) as the map, with the
        live pose and velocity re-expressed through the reference keyframe
        so tracking continues in the moved world."""
        c = self.carry
        R, p, dR = trk.rebase_pose(self.map, m2, c.last_kf_slot, c.R, c.p)
        self.carry = c._replace(R=R, p=p, v=dR @ c.v)
        self.map = m2
        self._snap = None

    def maybe_close_loop(self) -> bool:
        """Loop detection and correction on the newest keyframe, once per
        keyframe, with the carry's preintegration chain for the post-loop
        FullInertialBA (reference: streaming_vi.py's `maybe_close_loop`).
        Host policy and synchronizing: the application calls it at its own
        cadence (the flagship example's `--lc-every`). On a correction the
        live pose and velocity are re-expressed through the reference
        keyframe. Returns whether a loop closed."""
        if self.loop_closer is None:
            return False
        slot = int(self.map.n_kf) - 1
        if slot < 1 or slot == self._last_lc_slot:
            return False
        self._last_lc_slot = slot
        self._snap = None
        m2, closed = self.loop_closer.on_keyframe(
            self.map, slot, chain=self.carry.chain,
            chain_valid=self.carry.chain_valid)
        if closed:
            self._adopt(m2)
        else:
            self.map = m2
        return closed

    def run_global_ba(self, mesh=None, stages=(4, 6), cg_iters=16):
        """Whole-map FullInertialBA over the streamed map (reference: the
        background GBA thread, src/LoopClosing.cc:2351; the event form of
        what the amortized in-stream GBA does at keyframe cadence), then
        the live pose and velocity re-expressed through the reference
        keyframe in the refined world. Call at event cadence, not per
        frame. `mesh`: None, one process's solve; else the
        landmark-sharded solve over a process group
        (`tracking.distributed_global_ba_step`), every rank of it calling
        with the same state: a `parallel.dist_ba.Mesh`, an int n (ranks
        0..n-1 of the world; 1 with no world initialized is a one-rank
        group) or a list of ranks; ranks beyond the world raise
        ValueError.
        Returns chi2 as a 0-d tensor."""
        c = self.carry
        pre_b = c.chain.map(lambda x: x[1:])
        if mesh is not None:
            m2, chi = trk.distributed_global_ba_step(
                self.map, self.rig.kind, self.rig,
                dist_ba.resolve_mesh(mesh, self.map.kf_t.device),
                pre_b=pre_b, edge_valid=c.chain_valid[1:], stages=stages,
                cg_iters=cg_iters, obs_cap=self.cfg.obs_cap)
        else:
            m2, chi = trk.global_inertial_ba_step(
                self.map, pre_b, c.chain_valid[1:], self.rig.kind,
                self.rig, stages=stages, cg_iters=cg_iters,
                obs_cap=self.cfg.obs_cap)
        self._adopt(m2)
        return chi

    def snapshot(self) -> dict:
        """Trajectory + counters as numpy, in one transfer (cached until
        the next push)."""
        if self._snap is not None:
            return self._snap
        tr, m, c = self.carry.traj, self.map, self.carry
        bound = (m.kf_obs >= 0) & m.kf_feat_valid & m.kf_valid[:, None]
        n_obs = torch.sum(bound.to(torch.int32))
        # bound observations of live landmarks beyond `obs_cap`: the rows
        # that `full_map_observations` leaves out of a whole-map solve
        n_ba = torch.sum(bound & m.mp_valid[
            torch.clamp(m.kf_obs, min=0).to(torch.int64)], dtype=torch.int32)
        obs_dropped = torch.clamp(n_ba - self.cfg.obs_cap, min=0)
        fields = dict(time=tr.time, ref=tr.ref, R_rel=tr.R_rel,
                      t_rel=tr.t_rel, ok=tr.ok, idx=tr.idx, kf_R=m.kf_R,
                      kf_t=m.kf_t, n_kf=m.n_kf, n_mp=m.n_mp, n_obs=n_obs,
                      obs_dropped=obs_dropped,
                      imu_ok=c.imu_ok.to(torch.int32),
                      viba_stage=c.viba_stage)
        if self.lc_carry is not None:
            fields.update(n_loops=self.lc_carry.n_loops,
                          gba_left=self.lc_carry.gba_left,
                          lc_max_tilt=self.lc_carry.max_tilt,
                          n_merges=self.lc_carry.n_merges,
                          merge_kf_off=self.lc_carry.kf_off,
                          lc_dbg=self.lc_carry.dbg)
        self._snap = fetch(fields)
        return self._snap

    def get_trajectory(self):
        return ring_replay(self.snapshot())

    @property
    def n_kf(self):
        return int(self.snapshot()["n_kf"])

    @property
    def imu_initialized(self):
        return bool(self.snapshot()["imu_ok"])
