"""Device-side loop closing and cross-map merging for the streaming VI
pipeline (port of `openmavis_tpu/pipeline/streaming_lc.py`: `LCCarry`,
`init_lc_carry`, `_retrieval_scores`, `_covis_edges`, `make_lc_step` and
`make_merge_step`).

The whole acceptance chain — retrieval, Sim3 RANSAC, projection
refinement, covisible-group projection verification, temporal-consistency
bookkeeping, essential-graph (Sim3 or 4DoF) correction, landmark
propagation and the post-loop FullInertialBA — runs on the device, called
once per frame after the tracker's step. The reference package runs it as
one jitted program under `lax.cond`; here each `lax.cond` is a Python
branch on device scalars read back to the host: one read per frame (the
slot and the carry's counters together), and on a fresh keyframe one for
the retrieval's verdict and one for the confirmation.

Reference parity:
* retrieval                 KeyFrameDatabase::DetectNBestCandidates,
                            src/KeyFrameDatabase.cc:581 (LSH bag-of-words
                            signatures, slam_map/bow.py)
* Sim3 RANSAC + refine      LoopClosing.cc:812-935, Sim3Solver.cc,
                            Optimizer::OptimizeSim3 src/Optimizer.cc:2460
* group projection verify   DetectCommonRegionsFromBoW projection gate,
                            src/LoopClosing.cc:944-994
* temporal consistency      mnLoopNumCoincidences, LoopClosing.cc:440-520
* correction                CorrectLoop -> OptimizeEssentialGraph(4DoF),
                            src/LoopClosing.cc:1108-1372
* post-loop GBA             RunGlobalBundleAdjustment / FullInertialBA,
                            src/LoopClosing.cc:2351-2470
* cross-map weld            the merge path of LoopClosing: scale sanity
                            src/LoopClosing.cc:176-204, MergeLocal2
                            1956-2130 (`make_merge_step`)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..geometry import lie
from ..ops import set_rows
from ..optim import pose_graph, sim3_refine
from ..slam_map import atlas as atlas_mod
from ..slam_map import bow
from ..slam_map import map_state as ms
from ..solvers import sim3 as sim3_mod
from . import loop_closing as lc_mod
from . import tracking as trk

__all__ = ["LCCarry", "LCStep", "MergeStep", "init_lc_carry",
           "make_lc_step", "make_merge_step", "remap_slots"]


class LCCarry(NamedTuple):
    """Device-resident loop-closing state."""
    last_slot: torch.Tensor    # [] i32 newest processed keyframe slot
    cand: torch.Tensor         # [] i32 pending candidate (-1 = none)
    pend_slot: torch.Tensor    # [] i32 slot the pending Sim3 refers to
    count: torch.Tensor        # [] i32 consecutive confirmations
    s: torch.Tensor            # [] pending Sim3 body(pend_slot)->body(cand)
    R: torch.Tensor            # [3,3]
    t: torch.Tensor            # [3]
    n_loops: torch.Tensor      # [] i32 total corrections applied
    cooldown: torch.Tensor     # [] i32 keyframes to skip after a loop
    gba_left: torch.Tensor     # [] i32 amortized post-loop GBA steps left
    max_tilt: torch.Tensor     # [] f32 max |roll/pitch| of any verified
    #                               hypothesis (what tilt_max must cover)
    merged: torch.Tensor       # [] bool — cross-map weld already fired
    merge_last: torch.Tensor   # [] i32 newest slot merge detection saw
    n_merges: torch.Tensor     # [] i32 total welds applied
    kf_off: torch.Tensor       # [] i32 slot shift applied by the weld
    # stage telemetry (maxima over the run): [best retrieval score, floor
    # at that time, candidate attempts, matched pairs, RANSAC+refine
    # successes, group projection score]: which gate refused detection
    dbg: torch.Tensor          # [6] f32


def init_lc_carry(device=None) -> LCCarry:
    dev = resolve_device(device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return LCCarry(
        last_slot=i32(-1), cand=i32(-1), pend_slot=i32(-1), count=i32(0),
        s=torch.ones((), device=dev), R=torch.eye(3, device=dev),
        t=torch.zeros(3, device=dev), n_loops=i32(0), cooldown=i32(0),
        gba_left=i32(0), max_tilt=torch.zeros((), device=dev),
        merged=torch.zeros((), dtype=torch.bool, device=dev),
        merge_last=i32(-1), n_merges=i32(0), kf_off=i32(0),
        dbg=torch.zeros(6, device=dev))


def remap_slots(lcc: LCCarry, slot_map) -> LCCarry:
    """The carry after the keyframe slab was compacted: `slot_map` [K]
    gives each old slot's new slot, or -1 where its keyframe went
    (`VIStep.recycle`). `last_slot`, `merge_last`, `cand` and `pend_slot`
    follow their keyframes; a pending hypothesis, a Sim3 between its two
    keyframes, is dropped (`cand` = `pend_slot` = -1) when either went.

    The reference package keeps the old indices (its
    `streaming_vi.py::recycle` touches no LCCarry): when the compaction
    frees one slot, the next keyframe lands on the old `last_slot` and the
    closer never looks at it, and a hypothesis pending at the last slot
    never becomes pending again (`slot > pend_slot` cannot hold)."""
    K = slot_map.shape[0]

    def remap(x):
        new = slot_map[torch.clamp(x, 0, K - 1).to(torch.int64)]
        return torch.where(x >= 0, new, -1).to(x.dtype)

    cand, pend = remap(lcc.cand), remap(lcc.pend_slot)
    gone = (cand < 0) | (pend < 0)
    return lcc._replace(
        last_slot=remap(lcc.last_slot), merge_last=remap(lcc.merge_last),
        cand=torch.where(gone, -1, cand).to(cand.dtype),
        pend_slot=torch.where(gone, -1, pend).to(pend.dtype))


def _retrieval_scores(m: ms.MapState, slot) -> torch.Tensor:
    """[K] BoW min-intersection scores of keyframe `slot` against every
    keyframe (reference: KeyFrameDatabase::DetectLoopCandidates)."""
    return bow.scores(m.kf_bow, m.kf_bow[slot])


def _covis_edges(cov, s0, R_cw, t_cw, n_kf, n_edges: int,
                 threshold: int) -> pose_graph.PoseGraphEdges:
    """Top-`n_edges` covisibility edges (upper triangle, offset >= 2) with
    the relative Sim3 measured from the current poses. Equal scores keep
    their flat order (a stable sort, as `lax.top_k` breaks ties)."""
    K = cov.shape[0]
    idx = torch.arange(K, device=cov.device)
    ii, jj = idx[:, None], idx[None, :]
    ok = (jj >= ii + 2) & (cov >= threshold) & (ii < n_kf) & (jj < n_kf)
    score = torch.where(ok, cov, -1).reshape(-1)
    top, flat = torch.sort(score, descending=True, stable=True)
    top, flat = top[:n_edges], flat[:n_edges]
    ei = flat // K
    ej = flat % K
    se, Re, te = lie.sim3_compose(
        s0[ej], R_cw[ej], t_cw[ej],
        *lie.sim3_inverse(s0[ei], R_cw[ei], t_cw[ei]))
    return pose_graph.PoseGraphEdges(
        i=ei, j=ej, s=se, R=Re, t=te,
        weight=torch.ones(n_edges, dtype=t_cw.dtype, device=cov.device),
        valid=top > 0)


class LCStep:
    """The per-frame loop-closing step for one configuration:
    `step(m, c, lcc, rig) -> (m, c, lcc)`, built by `make_lc_step`.

    `events` names what the last call ran, from "gba_step", "attempt"
    and "correction" (known on the host anyway; reading it costs no
    device sync)."""

    def __init__(self, cfg, rig_kind: int, n_cams: int, inertial: bool,
                 img_w: float, img_h: float,
                 score_min: int = 40, covis_floor: bool = True,
                 min_pairs: int = 20, min_group: int = 25,
                 temporal: int = 2, recent_exclude: int = 8,
                 covis_exclude: int = 15, cov_edge_threshold: int = 30,
                 n_cov_edges: int = 64, cooldown_kf: int = 10,
                 run_gba: bool = False,
                 tilt_max: float = 0.02, yaw_max: float = 0.349,
                 gba_steps: int = 4, gba_cg: int = 8):
        self.rig_kind = rig_kind
        self.n_cams = n_cams
        self.inertial = inertial
        self.img_w, self.img_h = img_w, img_h
        self.obs_cap = int(getattr(cfg, "obs_cap", 131072))
        self.score_min, self.covis_floor = score_min, covis_floor
        self.min_pairs, self.min_group = min_pairs, min_group
        self.temporal, self.recent_exclude = temporal, recent_exclude
        self.covis_exclude = covis_exclude
        self.cov_edge_threshold = cov_edge_threshold
        self.n_cov_edges, self.cooldown_kf = n_cov_edges, cooldown_kf
        self.run_gba = run_gba
        # gravity-direction gate of inertial maps: the reference code gates
        # |phi_xy| < 0.008; verified hypotheses measure 0.002-0.012 rad
        # (LCCarry.max_tilt), so 0.02 covers genuine loops
        self.tilt_max, self.yaw_max = tilt_max, yaw_max
        self.gba_steps, self.gba_cg = gba_steps, gba_cg
        self.events: tuple = ()

    # ---- stages ------------------------------------------------------
    def gba_step(self, m, c, rig, **solver_kw):
        """One whole-map (inertial) BA dispatch over the current map."""
        if self.inertial:
            pre_b = c.chain.map(lambda x: x[1:])
            m2, _ = trk.global_inertial_ba_step(
                m, pre_b, c.chain_valid[1:], self.rig_kind, rig,
                **solver_kw)
        else:
            m2, _ = trk.global_ba_step(m, self.rig_kind, rig, **solver_kw)
        return m2

    def retrieval(self, m, lcc: LCCarry, slot: int, cov):
        """Best BoW candidate of keyframe `slot` and whether it clears
        the floor. Returns (cand_new [] i64, cand_ok [] bool, lcc)."""
        K = m.kf_R.shape[0]
        scores = _retrieval_scores(m, slot)
        idx = torch.arange(K, device=scores.device)
        in_map = m.kf_valid & (idx < m.n_kf)
        linked = cov[slot] >= self.covis_exclude
        exclude = (idx > slot - self.recent_exclude) | linked | ~in_map
        sc = torch.where(exclude, -1, scores)
        cand_new = torch.argmax(sc)
        best = sc[cand_new]
        # self-calibrating score floor (reference: minScore = the worst
        # BoW score among the query's covisibility neighbors,
        # LoopClosing.cc DetectLoop -> DetectLoopCandidates): a candidate
        # must look at least as similar as the weakest currently-connected
        # keyframe, with `score_min` as an absolute lower bound
        floor = torch.full_like(best, self.score_min)
        if self.covis_floor:
            neigh = linked & in_map & (idx != slot)
            min_cov = torch.min(torch.where(neigh, scores, 1 << 24))
            floor = torch.where(neigh.any(),
                                torch.clamp(min_cov, min=self.score_min),
                                floor)
        d = lcc.dbg
        best_f = best.to(torch.float32)
        dbg = torch.cat([
            torch.maximum(d[0], best_f)[None],
            torch.where(best_f > d[0], floor.to(torch.float32), d[1])[None],
            d[2:]])
        return cand_new, best >= floor, lcc._replace(dbg=dbg)

    def solve_candidate(self, m, gen, slot: int, cand: int, rig,
                        sample_idx=None):
        """Matched pairs -> RANSAC -> projection refine. Returns
        (ok, n_pairs, s, R, t) with the Sim3 body(slot)->body(cand).

        Pairs come from two sources concatenated: descriptor NN across
        the keyframes (pose-free: survives arbitrary drift) and
        projection-guided matches through the current poses (dense true
        pairs when drift is small against the search gate)."""
        tables = lc_mod._tables(m)
        pairs_nn = lc_mod._pairs_from_tables(tables, tables, slot, cand)
        pairs_pr = lc_mod.pairs_by_projection(
            m, slot, cand, self.rig_kind, self.n_cams, rig, self.img_w,
            self.img_h)
        pairs = lc_mod.MatchedPairs(*(torch.cat([a, b]) for a, b in
                                      zip(pairs_nn, pairs_pr)))
        n_pairs = torch.sum(pairs.valid, dtype=torch.int32)
        # reprojection-gated RANSAC (Sim3Solver::CheckInliers semantics)
        res = sim3_mod.ransac_sim3_reproj(
            gen, pairs, self.rig_kind, rig, fix_scale=self.inertial,
            min_inliers=self.min_pairs, sample_idx=sample_idx)
        C = rig.params.shape[0]
        cam_a = torch.clamp(pairs.cam_a, 0, C - 1).to(torch.int64)
        cam_b = torch.clamp(pairs.cam_b, 0, C - 1).to(torch.int64)
        ref = sim3_refine.refine_sim3(
            res.s, res.R, res.t, pairs.p_a, pairs.p_b, pairs.uv_a,
            pairs.uv_b, pairs.sigma2_a, pairs.sigma2_b,
            pairs.valid & res.inlier, self.rig_kind,
            rig.params[cam_a], rig.params[cam_b],
            rig.R_cb[cam_a], rig.t_cb[cam_a],
            rig.R_cb[cam_b], rig.t_cb[cam_b], fix_scale=self.inertial)
        ok = (res.success & (n_pairs >= self.min_pairs)
              & (ref.n_inliers >= self.min_pairs)
              & torch.isfinite(ref.s) & (ref.s > 0.1) & (ref.s < 10.0))
        return ok, n_pairs, ref.s, ref.R, ref.t

    def group_score(self, m, slot: int, cand: int, cov_row, s, R, t, rig):
        return lc_mod.group_projection_score(
            m, slot, cand, cov_row, s, R, t, self.rig_kind, self.n_cams,
            rig, self.img_w, self.img_h)

    def correct(self, m, c, slot: int, cand: int, s_m, R_m, t_m, cov, rig):
        """Essential-graph correction + landmark propagation + carry
        re-expression (+ the whole GBA budget at once when `run_gba`)."""
        K = m.kf_R.shape[0]
        dev = m.kf_R.device
        R_cw = m.kf_R.transpose(-1, -2)
        t_cw = -lie._mv(R_cw, m.kf_t)
        s0 = torch.ones(K, dtype=t_cw.dtype, device=dev)
        seq_e = pose_graph.sequential_edges(s0, R_cw, t_cw, m.n_kf, K)
        cov_e = _covis_edges(cov, s0, R_cw, t_cw, m.n_kf, self.n_cov_edges,
                             self.cov_edge_threshold)
        si_r, Ri_r, ti_r = lie.sim3_inverse(s_m, R_m, t_m)
        loop_e = pose_graph.PoseGraphEdges(
            i=torch.tensor([cand], device=dev),
            j=torch.tensor([slot], device=dev),
            s=si_r[None], R=Ri_r[None], t=ti_r[None],
            weight=torch.full((1,), 5.0, dtype=t_cw.dtype, device=dev),
            valid=torch.ones(1, dtype=torch.bool, device=dev))
        # persistent edges from earlier loops: re-measured from the
        # current (already consistent) poses, so each solve keeps every
        # previously closed loop closed (reference: mspLoopEdges in
        # OptimizeEssentialGraph, src/Optimizer.cc:1826)
        li = torch.clamp(m.loop_i, 0, K - 1).to(torch.int64)
        lj = torch.clamp(m.loop_j, 0, K - 1).to(torch.int64)
        lv = (m.loop_valid & (m.loop_i >= 0) & (m.loop_j >= 0)
              & m.kf_valid[li] & m.kf_valid[lj])
        sle, Rle, tle = lie.sim3_compose(
            s0[lj], R_cw[lj], t_cw[lj],
            *lie.sim3_inverse(s0[li], R_cw[li], t_cw[li]))
        stored_e = pose_graph.PoseGraphEdges(
            i=li, j=lj, s=sle, R=Rle, t=tle,
            weight=torch.full(li.shape, 5.0, dtype=t_cw.dtype, device=dev),
            valid=lv)
        edges = pose_graph.PoseGraphEdges(*(
            torch.cat(xs) for xs in zip(seq_e, cov_e, loop_e, stored_e)))
        m = ms.add_loop_edge(m, cand, slot)
        fixed = set_rows(torch.zeros(K, dtype=torch.bool, device=dev),
                         cand, True)
        if self.inertial:
            edges3 = pose_graph.PoseGraphEdgesSE3(
                i=edges.i, j=edges.j, R=edges.R, t=edges.t,
                weight=edges.weight, valid=edges.valid)
            R_o, t_o, _ = pose_graph.optimize_pose_graph_4dof(
                R_cw, t_cw, edges3, fixed, m.kf_valid)
            s_o = s0
        else:
            s_o, R_o, t_o, _ = pose_graph.optimize_pose_graph(
                s0, R_cw, t_cw, edges, fixed, m.kf_valid)

        m_old = m
        m = lc_mod._correct_map(m, s_o, R_o, t_o)
        if self.run_gba:
            m = self.gba_step(m, c, rig)

        # re-express the live tracker pose through its reference keyframe
        R, p, dR = trk.rebase_pose(m_old, m, c.last_kf_slot, c.R, c.p)
        return m, c._replace(R=R, p=p, v=dR @ c.v)

    # ---- the step ----------------------------------------------------
    def __call__(self, m, c, lcc: LCCarry, rig, sample_idx=None):
        return self.step(m, c, lcc, rig, sample_idx)

    def step(self, m, c, lcc: LCCarry, rig, sample_idx=None):
        """`sample_idx` ([n_hyp, 3]) replaces the RANSAC draw of this
        call (for holding the step against the reference package)."""
        slot, last_slot, cooldown, gba_left, pend_cand, pend_slot = \
            torch.stack([m.n_kf - 1, lcc.last_slot, lcc.cooldown,
                         lcc.gba_left, lcc.cand, lcc.pend_slot]).tolist()
        events = []
        new_slot = slot != last_slot
        new_kf = new_slot and slot > 0

        # amortized post-loop GBA: one reduced FullInertialBA iteration
        # per keyframe dispatch while the budget lasts (uses gba_left from
        # EARLIER dispatches; a fresh correction below re-arms it)
        if self.gba_steps > 0 and new_kf and gba_left > 0:
            m = self.gba_step(m, c, rig, stages=(1,),
                              cg_iters=self.gba_cg, obs_cap=self.obs_cap)
            lcc = lcc._replace(gba_left=lcc.gba_left - 1)
            events.append("gba_step")

        fresh_kf = (new_kf and slot >= self.recent_exclude
                    and cooldown <= 0)
        if new_slot:
            lcc = lcc._replace(
                last_slot=torch.full_like(lcc.last_slot, slot),
                cooldown=torch.clamp(lcc.cooldown - 1, min=0))
        if fresh_kf:
            m, c, lcc = self._process(m, c, lcc, rig, slot, pend_cand,
                                      pend_slot, sample_idx, events)
        self.events = tuple(events)
        return m, c, lcc

    def _process(self, m, c, lcc, rig, slot, pend_cand, pend_slot,
                 sample_idx, events):
        cov = ms.covisibility_matrix(m)
        cand_new, cand_ok, lcc = self.retrieval(m, lcc, slot, cov)
        # a pending hypothesis takes priority (temporal consistency)
        has_pending = pend_cand >= 0 and slot > pend_slot
        cand_new_i, cand_ok_b = torch.stack(
            [cand_new, cand_ok.to(cand_new.dtype)]).tolist()
        # keyframes without a plausible candidate skip the whole chain
        # (reference: LoopClosing::NewDetectCommonRegions returns early on
        # empty candidate lists, src/LoopClosing.cc:401-447)
        if not (cand_ok_b or has_pending):
            return m, c, lcc
        events.append("attempt")
        cand = pend_cand if has_pending else cand_new_i

        ok_s, n_pairs, s_n, R_n, t_n = self.solve_candidate(
            m, c.gen, slot, cand, rig, sample_idx)
        d = lcc.dbg
        dbg = [d[0], d[1], d[2] + 1.0,
               torch.maximum(d[3], n_pairs.to(torch.float32)),
               d[4] + ok_s.to(torch.float32)]

        # hypothesis to verify: the recomposed pending Sim3 when pending,
        # else the fresh solve (S'(slot->cand) = S_p o T(pend<-slot))
        if has_pending:
            R_o, t_o = m.kf_R[pend_slot], m.kf_t[pend_slot]
            R_s, t_s = m.kf_R[slot], m.kf_t[slot]
            s_h = lcc.s
            R_h = lcc.R @ R_o.T @ R_s
            t_h = lcc.s * (lcc.R @ (R_o.T @ (t_s - t_o))) + lcc.t
        else:
            s_h, R_h, t_h = s_n, R_n, t_n

        g_score = self.group_score(m, slot, cand, cov[cand], s_h, R_h, t_h,
                                   rig)
        dbg.append(torch.maximum(d[5], g_score.to(torch.float32)))
        # a fresh hypothesis must pass BOTH the retrieval-score gate and
        # the solve; excluded keyframes (the argmax fallback when all
        # scores are -1) can never be verified
        verified = g_score >= self.min_group
        if not has_pending:
            verified = verified & ok_s & bool(cand_ok_b)
        tilt_obs = lcc.max_tilt
        if self.inertial:
            # gravity-direction gate: the implied world correction must
            # not tilt roll/pitch (gravity is observable), and yaw must
            # stay sane (the "BAD LOOP" branch, src/LoopClosing.cc:307-335)
            phi = lie.so3_log(m.kf_R[cand] @ R_h @ m.kf_R[slot].T)
            tilt = torch.maximum(phi[0].abs(), phi[1].abs())
            tilt_obs = torch.where(verified, torch.maximum(tilt_obs, tilt),
                                   tilt_obs)
            verified = (verified & (tilt < self.tilt_max)
                        & (phi[2].abs() < self.yaw_max))

        prev = lcc.count + 1 if has_pending else torch.ones_like(lcc.count)
        count = torch.where(verified, prev, 0)
        # correction Sim3: prefer a fresh solve at the confirming
        # keyframe; fall back to the group-verified recomposed pending
        # hypothesis (the RANSAC hit rate per keyframe is well below 1)
        confirm = verified & (count >= self.temporal)
        fired = bool(confirm)
        if fired:
            events.append("correction")
            m, c = self.correct(
                m, c, slot, cand, torch.where(ok_s, s_n, s_h),
                torch.where(ok_s, R_n, R_h), torch.where(ok_s, t_n, t_h),
                cov, rig)

        def i32(v):
            return torch.full_like(lcc.cand, v)

        keep_h = verified & (not fired)
        lcc = lcc._replace(
            cand=torch.where(keep_h, i32(cand), i32(-1)),
            pend_slot=torch.where(keep_h, i32(slot), i32(-1)),
            count=i32(0) if fired else count,
            n_loops=lcc.n_loops + int(fired),
            # the verified hypothesis rides on to the next keyframe
            s=s_h, R=R_h, t=t_h, max_tilt=tilt_obs, dbg=torch.stack(dbg))
        if fired:
            lcc = lcc._replace(cooldown=i32(self.cooldown_kf),
                               gba_left=i32(self.gba_steps))
        return m, c, lcc


def make_lc_step(cfg, rig_kind: int, n_cams: int, inertial: bool,
                 img_w: float, img_h: float, **kw) -> LCStep:
    """Build the per-frame loop-closing step; the keywords and their
    defaults are `LCStep`'s (`score_min=40 ... gba_cg=8`).

    Returns step(m, c, lcc, rig) -> (m, c, lcc) where `c` is the
    streaming VIStreamCarry (its pose is re-expressed through its
    reference keyframe when a correction fires, and its preintegration
    chain feeds the post-loop FullInertialBA).

    Post-loop GBA (reference: the background RunGlobalBundleAdjustment
    thread, src/LoopClosing.cc:1372): `run_gba=True` runs the full budget
    inside the correction; the default is the AMORTIZED path — after a
    correction, the next `gba_steps` keyframe dispatches each run ONE
    reduced FullInertialBA iteration (cg depth `gba_cg`) over the whole
    map, converging across frames without stalling the stream.
    `gba_steps=0` disables it.
    """
    return LCStep(cfg, rig_kind, n_cams, inertial, img_w, img_h, **kw)


class MergeStep:
    """The per-frame CROSS-MAP merge step for one configuration:
    `step(m, c, lcc, m2, rig) -> (m, c, lcc)`, built by `make_merge_step`.

    `m2` is an OLDER session's map (the weld destination: its keyframes
    anchor the gauge). On a fresh keyframe of `m` it runs BoW retrieval
    against m2, the cross-map pairs, the Sim3 RANSAC and refinement, the
    scale gate and the covisible-group verification; a confirmed
    hypothesis welds `m` into m2 (`atlas.merge_maps_device`) with the
    merge edge, moves the carry into m2's world, shifts its slots, the
    trajectory ring and the preintegration chain by m2's keyframe count
    (kf_off), and runs the welding BA. The merged slab then replaces `m`
    and `lcc.merged` keeps detection from firing again. A weld whose maps
    do not fit m2's capacity leaves m, the carry and `lcc` as they were.

    Each of the reference's `lax.cond`s is a Python branch on a device
    scalar: one read per frame, and on a fresh keyframe one for the
    retrieval's verdict and one for the confirmation. `events` names what
    the last call ran: "merge_attempt", "weld"."""

    def __init__(self, cfg, rig_kind: int, n_cams: int, inertial: bool,
                 img_w: float, img_h: float, score_min: int = 40,
                 min_pairs: int = 20, min_group: int = 30,
                 weld_ba: bool = True, scale_lo: float = 0.9,
                 scale_hi: float = 1.1, min_kf: int = 5):
        self.rig_kind = rig_kind
        self.n_cams = n_cams
        self.inertial = inertial
        self.img_w, self.img_h = img_w, img_h
        self.obs_cap = int(getattr(cfg, "obs_cap", 131072))
        self.score_min, self.min_pairs = score_min, min_pairs
        self.min_group, self.weld_ba = min_group, weld_ba
        # scale sanity: inertial maps hold their scale (the reference's
        # 0.9-1.1 gate, src/LoopClosing.cc:176-204)
        self.scale_lo = scale_lo if inertial else 0.1
        self.scale_hi = scale_hi if inertial else 10.0
        # maturity gate: the current map needs structure (and, for
        # inertial rigs, a few keyframes of gravity and scale settling)
        # before a weld is trustworthy: an immature weld freezes early
        # drift into the seam
        self.min_kf = min_kf
        self.events: tuple = ()

    def __call__(self, m, c, lcc: LCCarry, m2, rig, sample_idx=None):
        return self.step(m, c, lcc, m2, rig, sample_idx)

    def step(self, m, c, lcc: LCCarry, m2, rig, sample_idx=None):
        """`sample_idx` ([n_hyp, 3]) replaces the RANSAC draw of this call
        (for holding the step against the reference package)."""
        slot, merge_last, merged, n_kf2 = torch.stack(
            [m.n_kf - 1, lcc.merge_last, lcc.merged.to(torch.int32),
             m2.n_kf]).tolist()
        self.events = ()
        fresh = (slot != merge_last and slot >= self.min_kf - 1
                 and not merged and n_kf2 >= 2)
        if slot != merge_last:
            lcc = lcc._replace(merge_last=torch.full_like(lcc.merge_last,
                                                          slot))
        if not fresh:
            return m, c, lcc
        cand, cand_ok = self.retrieval(m, m2, slot)
        if not cand_ok:
            return m, c, lcc
        events = ["merge_attempt"]
        ok, s, R, t = self.solve_candidate(m, m2, c.gen, slot, cand, rig,
                                           sample_idx)
        cov2 = ms.covisibility_matrix(m2)
        g = lc_mod.group_projection_score_cross(
            m, slot, m2, cand, cov2[cand], s, R, t, self.rig_kind,
            self.n_cams, rig, self.img_w, self.img_h)
        if bool(ok & (g >= self.min_group)):
            events.append("weld")
            m, c, lcc = self.weld(m, c, lcc, m2, rig, slot, cand, s, R, t)
        self.events = tuple(events)
        return m, c, lcc

    # ---- stages ------------------------------------------------------
    def retrieval(self, m, m2, slot: int):
        """The best BoW candidate of keyframe `slot` among m2's keyframes
        and whether it clears `score_min`. Returns (cand, ok) on the
        host."""
        K2 = m2.kf_R.shape[0]
        scores = bow.scores(m2.kf_bow, m.kf_bow[slot])
        idx2 = torch.arange(K2, device=scores.device)
        sc = torch.where(m2.kf_valid & (idx2 < m2.n_kf), scores, -1)
        cand = torch.argmax(sc)
        cand, best = torch.stack([cand, sc[cand].to(cand.dtype)]).tolist()
        return cand, best >= self.score_min

    def solve_candidate(self, m, m2, gen, slot: int, cand: int, rig,
                        sample_idx=None):
        """Cross-map pairs -> RANSAC -> projection refinement -> the
        scale gate. Returns (ok [] bool, s, R, t): the refined Sim3
        body(slot in m) -> body(cand in m2)."""
        pairs = lc_mod._matched_pairs_cross(m, slot, m2, cand)
        n_pairs = torch.sum(pairs.valid, dtype=torch.int32)
        res = sim3_mod.ransac_sim3_reproj(
            gen, pairs, self.rig_kind, rig, fix_scale=self.inertial,
            min_inliers=self.min_pairs, sample_idx=sample_idx)
        C = rig.params.shape[0]
        cam_a = torch.clamp(pairs.cam_a, 0, C - 1).to(torch.int64)
        cam_b = torch.clamp(pairs.cam_b, 0, C - 1).to(torch.int64)
        ref = sim3_refine.refine_sim3(
            res.s, res.R, res.t, pairs.p_a, pairs.p_b, pairs.uv_a,
            pairs.uv_b, pairs.sigma2_a, pairs.sigma2_b,
            pairs.valid & res.inlier, self.rig_kind,
            rig.params[cam_a], rig.params[cam_b],
            rig.R_cb[cam_a], rig.t_cb[cam_a],
            rig.R_cb[cam_b], rig.t_cb[cam_b], fix_scale=self.inertial)
        ok = (res.success & (n_pairs >= self.min_pairs)
              & (ref.n_inliers >= self.min_pairs) & torch.isfinite(ref.s)
              & (ref.s > self.scale_lo) & (ref.s < self.scale_hi))
        return ok, ref.s, ref.R, ref.t

    def weld(self, m, c, lcc: LCCarry, m2, rig, slot: int, cand: int, s, R,
             t):
        """Weld `m` into m2 through the confirmed Sim3 body(slot) ->
        body(cand), with no read to the host; `fits` selects between the
        welded and the unchanged state."""
        K = m.kf_R.shape[0]
        dev = m.kf_R.device
        # world Sim3 current world -> m2's world:
        # S_w = T_wb2(cand) o S_ba o T_bw(slot)
        one = torch.ones((), dtype=s.dtype, device=dev)
        s1, R1, t1 = lie.sim3_compose(one, m2.kf_R[cand], m2.kf_t[cand],
                                      s, R, t)
        s_w, R_w, t_w = lie.sim3_compose(
            s1, R1, t1, *lie.sim3_inverse(one, m.kf_R[slot], m.kf_t[slot]))
        kf_off = m2.n_kf
        merged, fits = atlas_mod.merge_maps_device(m2, m, s_w, R_w, t_w)
        merged = ms.add_loop_edge(merged, cand, slot + kf_off)
        # the carry in the merged world, its slots shifted by kf_off; every
        # ring entry recorded this session refers to a slot of the
        # pre-merge slab (unwritten entries are overwritten before they are
        # read), and its offset from that keyframe scales by s_w
        ks = torch.arange(K, device=dev)
        tgt = torch.where((ks < m.n_kf) & (ks + kf_off < K), ks + kf_off, K)

        def shift(x):
            ext = torch.zeros((K + 1,) + x.shape[1:], dtype=x.dtype,
                              device=dev)
            ext[tgt] = x
            return ext[:K]

        def sel(a, b):
            return torch.where(fits, a, b)

        tr = c.traj
        c = c._replace(
            R=sel(lie.normalize_rotation(R_w @ c.R), c.R),
            p=sel(s_w * (R_w @ c.p) + t_w, c.p),
            v=sel(s_w * (R_w @ c.v), c.v),
            last_kf_slot=sel(c.last_kf_slot + kf_off, c.last_kf_slot),
            traj=tr._replace(ref=sel(tr.ref + kf_off, tr.ref),
                             t_rel=sel(s_w * tr.t_rel, tr.t_rel)),
            chain=c.chain.map(lambda x: sel(shift(x), x)),
            chain_valid=sel(shift(c.chain_valid), c.chain_valid))
        if self.weld_ba:
            free = (ks >= kf_off) & merged.kf_valid
            merged, _ = trk.welding_ba_step(merged, free, self.rig_kind, rig,
                                            obs_cap=self.obs_cap)

        def i32(v):
            return torch.full_like(lcc.cand, v)

        lcc2 = lcc._replace(
            merged=torch.ones_like(lcc.merged), n_merges=lcc.n_merges + 1,
            kf_off=kf_off.to(torch.int32),
            # the loop closer's bookkeeping shifts with the slots
            last_slot=lcc.last_slot + kf_off,
            merge_last=lcc.merge_last + kf_off,
            cand=i32(-1), pend_slot=i32(-1), count=i32(0))
        return (atlas_mod.tree_where(fits, merged, m), c,
                atlas_mod.tree_where(fits, lcc2, lcc))


def make_merge_step(cfg, rig_kind: int, n_cams: int, inertial: bool,
                    img_w: float, img_h: float, **kw) -> MergeStep:
    """Build the per-frame cross-map merge step; the keywords and their
    defaults are `MergeStep`'s (`score_min=40, min_pairs=20,
    min_group=30, weld_ba=True, scale_lo=0.9, scale_hi=1.1, min_kf=5`).

    Returns step(m, c, lcc, m2, rig) -> (m, c, lcc). Capacity: m2's free
    slots must hold m (`merge_maps_device`'s `fits`), or the weld is
    skipped."""
    return MergeStep(cfg, rig_kind, n_cams, inertial, img_w, img_h, **kw)
