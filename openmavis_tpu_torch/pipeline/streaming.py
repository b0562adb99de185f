"""The streaming one-camera visual tracker (port of
`openmavis_tpu/pipeline/streaming.py`): initialization, tracking, LOST
handling with relocalization, the keyframe decision and the mapper chain
(spawn, bind, fuse, cull, window BA) as one per-frame step over a carry,

    step : (MapState, StreamCarry, image, time) -> (MapState, StreamCarry)

with `StreamingTracker` the host wrapper (`push`, `block`, `snapshot`,
`get_trajectory`), as `examples/mono_euroc.py --streaming` runs it. Also
the pieces the VI tracker shares: the mode constants, the relative-pose
trajectory ring `TrajRing` and `_masked_median`.

The reference package runs the step as one jitted program under
`lax.cond` / `lax.switch`; here each branch is a Python branch on device
values read back to the host (`StreamStep` names the reads). With
`loop_closer=` the host-policy `loop_closing.LoopCloser` runs on the
newest keyframe whenever the application calls `maybe_close_loop`.

Reference parity: the Tracking-thread state machine src/Tracking.cc:
1781-2230 and the LocalMapping consumer loop src/LocalMapping.cc:59-283;
mono init Tracking::MonocularInitialization src/Tracking.cc:2411-2619;
relocalization src/Tracking.cc:3543.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..frontend import extractor, matcher
from ..geometry import cameras
from ..ops import scatter_max, set_rows
from ..optim.reprojection import RigParams
from ..slam_map import map_state as ms
from ..solvers import two_view
from . import tracking as trk

NEED_REF = 0      # no init reference yet
INIT = 1          # have a reference frame, trying two-view init
OK = 2
LOST = 3


class TrajRing(NamedTuple):
    """Relative-pose trajectory (reference: Tracking::mlRelativeFramePoses,
    replayed against final keyframe poses, src/System.cc:717-1090)."""
    time: torch.Tensor    # [C] f32
    ref: torch.Tensor     # [C] i32 keyframe slot the pose is relative to
    R_rel: torch.Tensor   # [C,3,3]
    t_rel: torch.Tensor   # [C,3]
    ok: torch.Tensor      # [C] bool — frame was tracked
    idx: torch.Tensor     # [] i32 next write position


def _masked_median(x, mask):
    """Median of x[mask] (sort-based, static shape); 1.0 if mask empty."""
    n = torch.sum(mask.to(torch.int64))
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))))[0]
    med = xs[torch.clamp((n - 1) // 2, min=0)]
    return torch.where(n > 0, med, torch.ones_like(med))


class StreamCarry(NamedTuple):
    R: torch.Tensor              # [3,3] body pose (world-from-body)
    t: torch.Tensor              # [3]
    vel_R: torch.Tensor          # [3,3] motion model T_{k-1}^-1 T_k
    vel_t: torch.Tensor          # [3]
    mode: torch.Tensor           # [] i32
    last_kf_slot: torch.Tensor   # [] i32
    ref_kf_inliers: torch.Tensor  # [] i32
    lost_frames: torch.Tensor    # [] i32
    gen: torch.Generator         # replaces the reference's PRNG key
    ref_feats: extractor.Features  # the init reference frame's features
    ref_time: torch.Tensor       # [] f32
    traj: TrajRing


def _empty_feats(F: int, device) -> extractor.Features:
    def z(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)
    return extractor.Features(
        xy=z(F, 2), response=z(F), angle=z(F), level=z(F, dt=torch.int32),
        sigma2=torch.ones(F, device=device), desc=z(F, 256, dt=torch.int8),
        valid=z(F, dt=torch.bool))


def init_carry(F: int, traj_cap: int, seed: int = 0,
               device=None) -> StreamCarry:
    device = resolve_device(device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    eye = torch.eye(3, device=device)
    z3 = torch.zeros(3, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return StreamCarry(
        R=eye.clone(), t=z3.clone(), vel_R=eye.clone(), vel_t=z3.clone(),
        mode=i32(NEED_REF), last_kf_slot=i32(-1), ref_kf_inliers=i32(0),
        lost_frames=i32(0), gen=gen, ref_feats=_empty_feats(F, device),
        ref_time=torch.zeros((), device=device),
        traj=TrajRing(
            time=torch.zeros(traj_cap, device=device),
            ref=torch.zeros(traj_cap, dtype=torch.int32, device=device),
            R_rel=eye.repeat(traj_cap, 1, 1),
            t_rel=torch.zeros((traj_cap, 3), device=device),
            ok=torch.zeros(traj_cap, dtype=torch.bool, device=device),
            idx=i32(0)))


def ring_append(m: ms.MapState, tr: TrajRing, last_kf_slot, R, t, time,
                ok) -> TrajRing:
    """Append the pose (R, t) relative to keyframe `last_kf_slot`
    (slot 0 before the first). Past the ring's capacity every write lands
    on the last entry (the index is clamped, not wrapped), while `idx`
    keeps counting."""
    ref = torch.clamp(last_kf_slot, min=0)
    R_ref, t_ref = m.kf_R[ref], m.kf_t[ref]
    i = torch.clamp(tr.idx, max=tr.time.shape[0] - 1)
    return tr._replace(
        time=set_rows(tr.time, i, time), ref=set_rows(tr.ref, i, ref),
        R_rel=set_rows(tr.R_rel, i, R_ref.T @ R),
        t_rel=set_rows(tr.t_rel, i, R_ref.T @ (t - t_ref)),
        ok=set_rows(tr.ok, i, ok), idx=tr.idx + 1)


def ring_replay(s: dict):
    """(times, R [T,3,3], t [T,3]) of the ring in a snapshot `s` (numpy:
    time, ref, R_rel, t_rel, idx, kf_R, kf_t) replayed against its
    keyframe poses."""
    n = int(min(s["idx"], s["time"].shape[0]))
    kf_R, kf_t, ref = s["kf_R"], s["kf_t"], s["ref"][:n]
    return (s["time"][:n], kf_R[ref] @ s["R_rel"][:n],
            kf_t[ref] + (kf_R[ref] @ s["t_rel"][:n, :, None])[..., 0])


def _record(m: ms.MapState, c: StreamCarry, time, ok) -> StreamCarry:
    return c._replace(traj=ring_append(m, c.traj, c.last_kf_slot, c.R, c.t,
                                       time, ok))


@dataclass(frozen=True)
class StreamConfig:
    img_w: int = 640
    img_h: int = 480
    orb: extractor.OrbConfig = None  # None: OrbConfig()
    max_kf: int = 64
    max_mp: int = 8192
    traj_cap: int = 4096
    match_radius: float = 15.0
    relost_radius: float = 30.0
    min_inliers_track: int = 20
    kf_min_inlier_frac: float = 0.75
    kf_min_inliers_abs: int = 60
    new_mp_cap: int = 256
    ba_window: int = 8
    init_min_matches: int = 80
    init_min_inliers: int = 50
    # the window BA on every keyframe insert (the reference does;
    # disabling trades accuracy for throughput)
    ba_every_kf: bool = True


class StreamStep:
    """The per-frame step for one configuration and rig:
    `step(m, c, img, time, sample_idx=None) -> (m, c)`.

    Host reads (each one transfer): the mode, on every frame; in INIT the
    match count against the reference frame, and on an attempt the
    two-view success; on a tracked frame the inlier count, the keyframe
    count and the reference keyframe's inliers together (and, when LOST,
    the relocalization's success with them), and the inlier count of the
    wide retry when the first search fails. A plain tracked frame thus
    reads twice."""

    def __init__(self, cfg: StreamConfig, rig: RigParams):
        self.cfg = cfg
        self.rig = rig
        self.orb = cfg.orb or extractor.OrbConfig()
        self.F = self.orb.n_features
        self.W, self.H = float(cfg.img_w), float(cfg.img_h)
        # what the last step ran beside plain tracking: "reloc" (began
        # LOST, so `relocalize_step` ran), "reloc_ok" (it found a pose),
        # "retry" (the wide search ran), "lost" (the frame ended without
        # a track), "keyframe", "init_attempt" and "init"
        self.events: tuple = ()

    def bearing_z1(self, feats):
        rig = self.rig
        ray = cameras.unproject(rig.kind, rig.params[0], feats.xy)
        z = torch.clamp(ray[:, 2], min=1e-6)
        return ray[:, :2] / z[:, None]

    # ---------------- init branches ----------------
    def branch_need_ref(self, m, c, feats, time):
        return m, c._replace(ref_feats=feats, ref_time=time,
                             mode=torch.full_like(c.mode, INIT))

    def do_init(self, m, c, feats, time, idx, matched, sample_idx=None):
        """Two-view reconstruction and map bootstrap (reference:
        Tracking::MonocularInitialization + map creation,
        src/Tracking.cc:2411-2619): median depth scaled to 1, keyframes 0
        (the reference frame) and 1, a two-keyframe BA. On failure this
        frame becomes the reference. One host read (`success`)."""
        cfg, rig, F = self.cfg, self.rig, self.F
        dev = c.t.device
        f0 = c.ref_feats
        self.events += ("init_attempt",)
        safe = torch.where(matched, idx, 0).to(torch.int64)
        res = two_view.reconstruct(
            c.gen, self.bearing_z1(f0)[safe], self.bearing_z1(feats),
            matched, focal=rig.params[0, 0],
            min_inliers=cfg.init_min_inliers, sample_idx=sample_idx)
        good = res.is_good
        M = m.mp_pos.shape[0]
        order = torch.cumsum(good, 0, dtype=torch.int32) - 1
        write = good & (order < M)
        n_new = torch.sum(write, dtype=torch.int32)
        if not bool(res.success & (n_new >= cfg.init_min_inliers)):
            return m, c._replace(ref_feats=feats, ref_time=time)
        self.events += ("init",)

        scale = 1.0 / torch.clamp(_masked_median(res.points[:, 2], good),
                                  min=1e-6)
        pts_c0 = res.points * scale
        R01, t01 = res.R, res.t * scale
        R_w1, t_w1 = R01.T, -R01.T @ t01

        slot_mp = torch.where(write, order, M).to(torch.int64)
        obs1 = torch.where(write, order, -1)
        # the reference frame's bindings through the matches; the sentinel
        # row F - 1 takes -1, which a real binding there out-maxes
        hit = write & (idx >= 0)
        obs0 = scatter_max(
            torch.full((F,), -1, dtype=torch.int32, device=dev),
            torch.where(hit, idx, F - 1), torch.where(hit, order, -1))
        mp_pos = torch.zeros((M + 1, 3), device=dev)
        mp_pos[slot_mp] = pts_c0
        mp_desc = torch.zeros((M + 1, 256), dtype=torch.int8, device=dev)
        mp_desc[slot_mp] = feats.desc
        newly = torch.zeros(M + 1, dtype=torch.bool, device=dev)
        newly[slot_mp] = write
        newly = newly[:M]
        m2 = m._replace(
            mp_pos=torch.where(newly[:, None], mp_pos[:M], m.mp_pos),
            mp_desc=torch.where(newly[:, None], mp_desc[:M], m.mp_desc),
            mp_valid=newly, n_mp=n_new)
        z3 = torch.zeros(3, device=dev)
        zc = torch.zeros(F, dtype=torch.int32, device=dev)
        m2 = ms.insert_keyframe(
            m2, 0, torch.eye(3, device=dev), z3, z3, z3, z3, c.ref_time,
            f0.xy, f0.desc, f0.level, f0.sigma2, zc, f0.valid, obs0)
        m2 = ms.insert_keyframe(
            m2, 1, R_w1, t_w1, z3, z3, z3, time, feats.xy, feats.desc,
            feats.level, feats.sigma2, zc, feats.valid, obs1)
        m2 = ms.update_mp_geometry(m2)
        m2, _ = trk.local_ba_step(m2, 1, rig.kind, rig, window=2)
        return m2, c._replace(
            R=R_w1, t=t_w1, mode=torch.full_like(c.mode, OK),
            last_kf_slot=torch.ones_like(c.last_kf_slot),
            ref_kf_inliers=n_new)

    def branch_init(self, m, c, feats, time, sample_idx=None):
        """Match against the reference frame; with enough matches attempt
        the two-view init, else slide the reference to this frame."""
        f0 = c.ref_feats
        idx, _ = matcher.match_nn(
            feats.desc, feats.valid, f0.desc, f0.valid,
            max_dist=matcher.TH_LOW, ratio=0.9, mutual=True)
        matched = idx >= 0
        if int(torch.sum(matched)) >= self.cfg.init_min_matches:
            return self.do_init(m, c, feats, time, idx, matched, sample_idx)
        return m, c._replace(ref_feats=feats, ref_time=time)

    # ---------------- keyframe pipeline ----------------
    def kf_insert(self, m, c, feats, time, feat_mp, n_in: int, slot: int):
        cfg, rig = self.cfg, self.rig
        dev = c.t.device
        self.events += ("keyframe",)
        z3 = torch.zeros(3, device=dev)
        m = ms.insert_keyframe(
            m, slot, c.R, c.t, z3, z3, z3, time, feats.xy, feats.desc,
            feats.level, feats.sigma2,
            torch.zeros(self.F, dtype=torch.int32, device=dev), feats.valid,
            feat_mp)
        m, _ = trk.spawn_landmarks(m, slot, [slot - 1 - j for j in range(4)],
                                   rig.kind, rig, cfg.new_mp_cap)
        m = trk.bind_landmarks(m, slot, rig.kind, rig, self.W, self.H)
        m = trk.fuse_new_landmarks(m, slot, cap=cfg.new_mp_cap)
        m = trk.cull_landmarks(m, slot)
        m, _ = trk.cull_keyframes(m, slot)
        if cfg.ba_every_kf:
            m, _ = trk.local_ba_step(m, slot, rig.kind, rig,
                                     window=cfg.ba_window)
        return m, c._replace(
            last_kf_slot=torch.full_like(c.last_kf_slot, slot),
            ref_kf_inliers=torch.full_like(c.ref_kf_inliers, max(n_in, 1)),
            R=m.kf_R[slot], t=m.kf_t[slot])

    # ---------------- tracking branch ----------------
    def branch_track(self, m, c, feats, time, lost: bool, sample_idx=None):
        cfg, rig = self.cfg, self.rig
        W, H = self.W, self.H
        # prediction: the motion model, or when LOST the relocalization's
        # pose (the last pose if it finds none) (reference: Tracking.cc
        # mVelocity / Relocalization 3543)
        reads = []
        if lost:
            okr, R_r, t_r, _ = trk.relocalize_step(
                m, feats, c.gen, rig.kind, rig, sample_idx=sample_idx)
            R_pred = torch.where(okr, R_r, c.R)
            t_pred = torch.where(okr, t_r, c.t)
            reads.append(okr.to(torch.int32))
        else:
            R_pred, t_pred = c.R @ c.vel_R, c.t + c.R @ c.vel_t
        R2, t2, feat_mp, n_in, vis, keep = trk.track_step(
            m, feats, R_pred, t_pred, rig.kind, rig, W, H, cfg.match_radius)
        n_in, n_kf, ref_in, *okr_h = torch.stack(
            [n_in, m.n_kf, c.ref_kf_inliers] + reads).tolist()
        if lost:
            self.events += ("reloc", "reloc_ok") if okr_h[0] else ("reloc",)
        if n_in < cfg.min_inliers_track:
            # wide retry from the last confirmed pose (RECENTLY_LOST coast)
            self.events += ("retry",)
            R2, t2, feat_mp, n_in, vis, keep = trk.track_step(
                m, feats, c.R, c.t, rig.kind, rig, W, H, cfg.relost_radius)
            n_in = int(n_in)

        if n_in < cfg.min_inliers_track:
            self.events += ("lost",)
            return m, c._replace(mode=torch.full_like(c.mode, LOST),
                                 lost_frames=c.lost_frames + 1)
        c = c._replace(
            R=R2, t=t2, vel_R=c.R.T @ R2, vel_t=c.R.T @ (t2 - c.t),
            mode=torch.full_like(c.mode, OK),
            lost_frames=torch.zeros_like(c.lost_frames))
        m = m._replace(mp_visible=m.mp_visible + vis.to(torch.int32),
                       mp_found=m.mp_found + keep.to(torch.int32))
        need_kf = ((n_in < cfg.kf_min_inlier_frac * max(ref_in, 1)
                    or n_in < cfg.kf_min_inliers_abs)
                   and n_kf < cfg.max_kf)
        if need_kf:
            return self.kf_insert(m, c, feats, time, feat_mp, n_in, n_kf)
        return m, c

    # ---------------- the step ----------------
    def step(self, m: ms.MapState, c: StreamCarry, img, time,
             sample_idx=None):
        """img: [H, W] on the device (uint8 or float32); time: 0-d float32
        tensor; sample_idx: optional RANSAC samples for this frame, handed
        to whichever solver runs: the two-view init's (idx8 [256, 8],
        idx4 [256, 4]) or the relocalization's ([3, n_hyp, 6])."""
        self.events = ()
        feats = extractor.extract(img.to(torch.float32), self.orb)
        mode = int(c.mode)
        if mode == NEED_REF:
            m, c = self.branch_need_ref(m, c, feats, time)
        elif mode == INIT:
            m, c = self.branch_init(m, c, feats, time, sample_idx)
        else:
            m, c = self.branch_track(m, c, feats, time, mode == LOST,
                                     sample_idx)
        return m, _record(m, c, time, c.mode == OK)


def fetch(fields: dict) -> dict:
    """Tensors to numpy in ONE device-to-host transfer: every field goes
    through float32 (exact for the counters and slots, all < 2^24) and
    comes back in its own dtype and shape."""
    flat = torch.cat([v.reshape(-1).to(torch.float32)
                      for v in fields.values()]).cpu().numpy()
    out, k = {}, 0
    for name, v in fields.items():
        n = v.numel()
        dt = np.dtype(str(v.dtype).replace("torch.", ""))
        out[name] = flat[k:k + n].astype(dt).reshape(tuple(v.shape))
        k += n
    return out


class StreamingTracker:
    """Host wrapper around the per-frame step.

    Usage:
        tr = StreamingTracker(rig, cfg)           # on the current GPU
        for img, t in frames: tr.push(img, t)
        times, R, t = tr.get_trajectory()          # one transfer
    """

    def __init__(self, rig: RigParams, cfg: StreamConfig, seed: int = 0,
                 loop_closer=None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        F = (cfg.orb or extractor.OrbConfig()).n_features
        self.map = ms.allocate(cfg.max_kf, F, cfg.max_mp, device=self.device)
        self.carry = init_carry(F, cfg.traj_cap, seed, device=self.device)
        self.rig = rig.to(self.device)
        self._step = StreamStep(cfg, self.rig)
        # what the step ran on the last push beside plain tracking
        # (`StreamStep.events`)
        self.step_events: tuple = ()
        self._snap = None
        self.loop_closer = loop_closer
        self._last_lc_slot = -1

    def push(self, img, time: float, sample_idx=None):
        """img: [H, W] (uint8 or float32; numpy or a tensor);
        sample_idx: optional RANSAC samples for this frame
        (`StreamStep.step`)."""
        img = torch.as_tensor(img).to(self.device)
        t = torch.tensor(time, dtype=torch.float32, device=self.device)
        self.map, self.carry = self._step.step(self.map, self.carry, img, t,
                                               sample_idx)
        self.step_events = self._step.events
        self._snap = None

    def block(self):
        """Wait for the device to finish, without a device-to-host copy."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def maybe_close_loop(self) -> bool:
        """Loop detection and correction on the newest keyframe, once per
        keyframe (reference: streaming.py's `maybe_close_loop`): host
        policy and synchronizing, so the application calls it at its own
        cadence. On a correction the live pose is re-expressed through
        its reference keyframe. Returns whether a loop closed."""
        if self.loop_closer is None:
            return False
        slot = int(self.map.n_kf) - 1
        if slot < 1 or slot == self._last_lc_slot:
            return False
        self._last_lc_slot = slot
        self._snap = None
        m, c = self.map, self.carry
        m2, closed = self.loop_closer.on_keyframe(m, slot)
        if closed:
            R, t, _ = trk.rebase_pose(m, m2, c.last_kf_slot, c.R, c.t)
            self.carry = c._replace(R=R, t=t)
        self.map = m2
        return closed

    def snapshot(self) -> dict:
        """Trajectory ring, keyframe poses and counters as numpy, in one
        transfer (cached until the next push)."""
        if self._snap is None:
            tr, m = self.carry.traj, self.map
            self._snap = fetch(dict(
                time=tr.time, ref=tr.ref, R_rel=tr.R_rel, t_rel=tr.t_rel,
                ok=tr.ok, idx=tr.idx, kf_R=m.kf_R, kf_t=m.kf_t, n_kf=m.n_kf,
                n_mp=m.n_mp))
        return self._snap

    def get_trajectory(self):
        """Relative poses replayed against the final keyframe poses."""
        return ring_replay(self.snapshot())

    @property
    def n_kf(self):
        return int(self.snapshot()["n_kf"])

