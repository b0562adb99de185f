#!/usr/bin/env python3
"""The reference package's `StreamingVITracker` (`openmavis_tpu`, JAX) on
the CPU at the configurations of `chip_smoke.py`, and the port's beside it:

* `flagship`: path 1, the bench scene (`scene.make_sequence(160, 1.25)`,
  4 x KannalaBrandt8 at 640 x 480, 4 x 512 ORB x 8 levels, 400 Hz IMU, a
  64-keyframe / 16,384-landmark slab) with device loop closing
  (`device_lc=dict(score_min=30, temporal=2)`);
* `mono_inertial_euroc`: path 3, one EuRoC camera (752 x 480, radtan, the
  images rendered distorted, `dist` given), 1,000 ORB x 8 levels, 200 Hz
  IMU, loop closing on; 50 frames by default;
* `long`: the long run of `chip_smoke.py --long` (`scene.make_sequence(800,
  2.2)`, a 256-keyframe / 32,768-landmark slab, `track_map_cap=8192`),
  200 frames of it by default;
* `host_lc`: path 10, the flagship example's combination: path 2's orbit
  (`N_FRAMES_HOST_LC` = 270 frames at the flagship's angular step), the
  bench's slab, device loop closing off, and the host-policy
  `LoopCloser(None, 64, rig=rig, inertial=True, img_w=640, img_h=480,
  seed=SEED)` with `maybe_close_loop()` after every push. The line also
  carries `lc_trace`, one row per `on_keyframe` call (`HostTrace`: frame,
  slot, pending hypothesis in and out, the sparse database's top 3, the
  candidates, each solve's pairs, RANSAC success and inliers, each group
  score, closed). 8-16 minutes for the reference and 24-29 for the port
  at TORCH_THREADS=1, up to eight such runs sharing an 8-core host (at
  two or three torch threads each, several port runs ran 20x slower).

Prints one JSON line: frames tracked, the init frame (the first tracked
frame), the keyframe frames (those whose push inserted a keyframe), the
IMU init events (frame, `viba_stage`, the Horn scale of the trajectory so
far), the loop frames, `lc_dbg` (best retrieval score, its floor,
attempts, matched pairs, RANSAC + refine successes, group score), the
keyframe and landmark counts, and the ATE with and without Horn scale.

Options:
  --frames N     frames pushed (the mode's own count by default);
  --port         run the port (`openmavis_tpu_torch`) on the CPU instead;
  --seed SEED    the host loop closer's seed (host_lc; 100, the example's,
                 by default);
  --trace-full   keep in `lc_trace` each call's dense place scores and
                 the slot's covisibility row (host_lc);
  --hold-confirm FRAME  (host_lc) both packages free up to that frame,
                 then each package's closer, with seeds 100-107, on each
                 package's map of that frame (`hold_confirm`; about ten
                 minutes at frame 174);
  --attempts     also record each loop attempt: frame, slot, candidate,
                 the descriptor and projection pairs, RANSAC success,
                 refined inliers and the group score (the reference's
                 through `jax.debug.callback`s inside its jitted step);
  --dump DIR     write the reference's map at each loop attempt
                 (attempt_map_FRAME.npz; --attempts records its RANSAC
                 key) and, for each frame of --dump-frames A-B, its state
                 after the frame (map, carry, loop carry) with the frame's
                 two-view draws (frame_FRAME.npz), under DIR (a directory
                 under /tmp);
  --step-port    step the port from the reference's state of the frame
                 before, every frame, with the reference's raw features
                 (the port undistorts them) and its two-view samples and
                 loop-closing RANSAC samples, and print for each frame the
                 fields that part: integers exactly, poses beyond 1e-3 m.
                 With host_lc (`step_port_host_lc`, about 27 minutes): the
                 push from the reference's state (map, carry,
                 `_last_lc_slot`, `_t_prev`), then `maybe_close_loop` from
                 the reference's pushed state and its closer's state
                 (vocabulary, database, pending hypothesis, counters, key)
                 with the reference's Sim3 samples through
                 `LoopCloser.samples`; per frame the push's parts and, on
                 a closer call, the decisions that part (`trace_parts`),
                 the closer state's and the map's;
  --port-draws   run the port free, with the reference's two-view samples
                 on its init attempts (drawn from the reference's keys);
  --hold-attempt FRAME  with the --dump DIR of a reference run with
                 --attempts: on the reference's map at that frame's loop
                 attempt, the pairs of both sources and the solve of both
                 packages (`_solve_candidate`, `LCStep.solve_candidate`),
                 the port given the samples of the reference's key;
  --two-view FRAME  the two-view attempt of that frame from the
                 reference's state, features and samples in both packages,
                 with each E hypothesis's float32 and float64 scores.

Run: JAX_PLATFORMS=cpu python3 scripts/reference_streaming_vi.py MODE
[--frames N] [flags] (a few GiB; the reference's first frame compiles its
step, a few minutes at these sizes; then about 1-2 s a frame).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from openmavis_tpu_torch import scene  # noqa: E402
from openmavis_tpu_torch.io import evaluation  # noqa: E402

MODES = ("flagship", "mono_inertial_euroc", "long", "host_lc")
LC_KW = dict(score_min=30, temporal=2)
N_HYP_TWO_VIEW = 256
N_HYP_SIM3 = 128
INTS = ("mode", "n_kf", "n_mp", "kf_valid", "kf_obs", "mp_valid",
        "last_kf_slot", "chain_valid", "viba_stage", "imu_ok", "n_loops",
        "lc_cand", "lc_pend_slot", "lc_last_slot", "lc_dbg")
FLOATS = ("kf_t", "p", "mp_pos")


def setup(mode: str, n: int, lc_seed: int = 100) -> dict:
    """The scene and the configuration of `mode`, `n` frames pushed
    (`lc_seed`: the host loop closer's seed, mode host_lc)."""
    if mode == "mono_inertial_euroc":
        w, h, pin, dist, _ = cs.single_camera_setup(mode)
        rig_np, frames, _, t_wb, batches, _ = \
            scene.make_single_camera_sequence(
                n, 1.25 * (n - 1) / (cs.N_FRAMES - 1), w, h, pin, dist=dist)
        kw = scene.single_camera_config_kwargs(n, w, h)
        return dict(rig_np=rig_np, frames=frames, t_wb=t_wb,
                    batches=batches, cfg_kw=kw,
                    orb=dict(n_features=cs.SINGLE_FEATURES, n_levels=8),
                    sigmas=scene.EUROC_NOISE_SIGMAS,
                    dist=np.asarray(dist, np.float32)[None])
    if mode == "host_lc":
        total = cs.N_FRAMES_HOST_LC
        rig_np, frames, _, t_wb, batches = scene.make_sequence(
            total, orbit_frac=1.25 * (total - 1) / (cs.N_FRAMES - 1),
            kind_name="kb8")
        return dict(rig_np=rig_np, frames=frames[:n], t_wb=t_wb[:n],
                    batches=batches[:n],
                    cfg_kw=scene.bench_config_kwargs(total),
                    orb=dict(n_features=cs.N_FEATURES, n_levels=8),
                    sigmas=scene.NOISE_SIGMAS, dist=None, lc_seed=lc_seed)
    if mode == "long":
        total = cs.LONG["n_frames"]
        rig_np, frames, _, t_wb, batches = scene.make_sequence(
            total, orbit_frac=cs.LONG["orbit_frac"], kind_name="kb8")
        kw = scene.bench_config_kwargs(total, max_kf=cs.LONG["max_kf"],
                                       max_mp=cs.LONG["max_mp"])
        kw.update(track_map_cap=cs.LONG["track_map_cap"])
    else:
        rig_np, frames, _, t_wb, batches = scene.make_sequence(
            cs.N_FRAMES, orbit_frac=1.25, kind_name="kb8")
        kw = scene.bench_config_kwargs(cs.N_FRAMES)
    return dict(rig_np=rig_np, frames=frames[:n], t_wb=t_wb[:n],
                batches=batches[:n], cfg_kw=kw,
                orb=dict(n_features=cs.N_FEATURES, n_levels=8),
                sigmas=scene.NOISE_SIGMAS, dist=None)


# ---------------------------------------------------------------------------
# the two packages' trackers
# ---------------------------------------------------------------------------

def reference_tracker(s: dict):
    import jax.numpy as jnp
    from openmavis_tpu.frontend import extractor
    from openmavis_tpu.imu import preintegration as pre_mod
    from openmavis_tpu.optim.reprojection import RigParams
    from openmavis_tpu.pipeline import loop_closing, streaming_vi

    r = s["rig_np"]
    rig = RigParams(r["kind"], *(jnp.asarray(r[k]) for k in
                                 ("params", "R_cb", "t_cb")))
    cfg = streaming_vi.VIStreamConfig(
        orb=extractor.OrbConfig(**s["orb"]), **s["cfg_kw"])
    if "lc_seed" in s:
        return streaming_vi.StreamingVITracker(
            rig, cfg, pre_mod.ImuNoise.from_sigmas(*s["sigmas"]), seed=0,
            loop_closer=loop_closing.LoopCloser(
                None, cfg.max_kf, seed=s["lc_seed"], rig=rig,
                inertial=True, img_w=cfg.img_w, img_h=cfg.img_h))
    return streaming_vi.StreamingVITracker(
        rig, cfg, pre_mod.ImuNoise.from_sigmas(*s["sigmas"]), seed=0,
        dist=s["dist"], device_lc=LC_KW)


def port_tracker(s: dict):
    import torch
    from openmavis_tpu_torch import convert
    from openmavis_tpu_torch.frontend import extractor
    from openmavis_tpu_torch.imu import preintegration as pre_mod
    from openmavis_tpu_torch.pipeline import loop_closing, streaming_vi

    torch.set_num_threads(int(os.environ.get("TORCH_THREADS", "8")))
    cfg = streaming_vi.VIStreamConfig(
        orb=extractor.OrbConfig(**s["orb"]), **s["cfg_kw"])
    rig = convert.rig_from_numpy(s["rig_np"], device="cpu")
    noise = pre_mod.ImuNoise.from_sigmas(*s["sigmas"], device="cpu")
    if "lc_seed" in s:
        return streaming_vi.StreamingVITracker(
            rig, cfg, noise, seed=0, device="cpu",
            loop_closer=loop_closing.LoopCloser(
                None, cfg.max_kf, seed=s["lc_seed"], rig=rig,
                inertial=True, img_w=cfg.img_w, img_h=cfg.img_h,
                device="cpu"))
    return streaming_vi.StreamingVITracker(
        rig, cfg, noise, seed=0, device="cpu", dist=s["dist"],
        device_lc=LC_KW)


def _np_tree(x):
    if hasattr(x, "_asdict"):
        return {k: _np_tree(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return np.array(x)


def reference_state(tr) -> tuple:
    """The reference tracker's map, carry and loop carry as numpy dicts."""
    return (_np_tree(tr.map), _np_tree(tr.carry), _np_tree(tr.lc_carry))


def record(m, c, lcc, full: bool = False) -> dict:
    """What the summary (and with `full`, the comparisons) read of a map,
    carry and loop carry of either package (`lcc` a dict of the same
    fields for a host closer, `closer_fields`)."""
    g = np.asarray
    if isinstance(lcc, dict):
        lc = lcc
    else:
        lc = dict(n_loops=lcc.n_loops, lc_cand=lcc.cand,
                  lc_pend_slot=lcc.pend_slot, lc_last_slot=lcc.last_slot,
                  lc_dbg=lcc.dbg)
    rec = dict(n_kf=g(m.n_kf), n_mp=g(m.n_mp), mode=g(c.mode),
               last_kf_slot=g(c.last_kf_slot), viba_stage=g(c.viba_stage),
               imu_ok=g(c.imu_ok), last_kf_time=g(c.last_kf_time),
               **{k: g(v) for k, v in lc.items()})
    if full:
        rec.update({k: g(getattr(m, k)) for k in
                    ("kf_valid", "kf_obs", "mp_valid", "kf_t", "mp_pos")})
        rec.update(chain_valid=g(c.chain_valid), p=g(c.p))
    return rec


def tracker_record(tr, full: bool = False) -> dict:
    lcc = tr.lc_carry if tr.lc_carry is not None else closer_fields(tr)
    return record(tr.map, tr.carry, lcc, full)


def closer_fields(tr) -> dict:
    """A host closer's state under the loop carry's names: its loops, the
    pending hypothesis's candidate and slot (-1 without one), the last
    keyframe `maybe_close_loop` handled, and `lc_dbg` the pending
    hypothesis's count (0 without one)."""
    lc, p = tr.loop_closer, tr.loop_closer.pending
    return dict(n_loops=lc.n_loops,
                lc_cand=-1 if p is None else int(p["cand"]),
                lc_pend_slot=-1 if p is None else int(p["slot"]),
                lc_last_slot=tr._last_lc_slot,
                lc_dbg=[0 if p is None else int(p["count"])])


# ---------------------------------------------------------------------------
# loop attempts
# ---------------------------------------------------------------------------

class Attempts:
    """Each loop attempt of a run: `frame` is set by the caller before each
    push; the reference's records arrive through `jax.debug.callback`s
    placed around its `_pairs_from_tables`, `pairs_by_projection`,
    `ransac_sim3_reproj` and `group_projection_score` (module attributes
    that its step looks up when it is traced), the port's through wrappers
    of the same functions. `dump`: a directory for the map and the RANSAC
    key of each attempt."""

    def __init__(self, dump=None):
        self.frame, self.rows, self.dump = -1, [], dump

    def _row(self):
        if not self.rows or self.rows[-1]["frame"] != self.frame:
            self.rows.append({"frame": self.frame})
        return self.rows[-1]

    def pairs(self, source, slot, cand, valid):
        row = self._row()
        row.update(slot=int(slot), cand=int(cand))
        row["pairs_" + source] = int(np.sum(np.asarray(valid)))

    def ransac(self, key, success, n_inliers):
        row = self._row()
        row.update(ransac_success=bool(success), ransac_inliers=int(
            n_inliers))
        if key is not None:
            row["key"] = np.asarray(key).tolist()
            if self.dump:
                with open(os.path.join(self.dump, "attempt_%04d.json"
                                       % self.frame), "w") as f:
                    json.dump(row, f)

    def group(self, slot, cand, score):
        self._row()["group_score"] = int(score)

    def map_at_attempt(self, m):
        if self.dump:
            np.savez_compressed(os.path.join(
                self.dump, "attempt_map_%04d.npz" % self.frame),
                **{k: np.asarray(v) for k, v in m.items()})

    def install_reference(self):
        import jax
        from openmavis_tpu.pipeline import streaming_lc

        lc, sim3 = streaming_lc.lc_mod, streaming_lc.sim3_mod
        att = self

        class Proxy:
            def __init__(self, mod, **over):
                self._mod = mod
                self.__dict__.update(over)

            def __getattr__(self, name):
                return getattr(self._mod, name)

        def pairs_nn(ta, tb, slot, cand):
            p = lc._pairs_from_tables(ta, tb, slot, cand)
            jax.debug.callback(lambda s, c, v: att.pairs("nn", s, c, v),
                               slot, cand, p.valid)
            return p

        def pairs_pr(m, slot, cand, *a, **k):
            p = lc.pairs_by_projection(m, slot, cand, *a, **k)
            jax.debug.callback(lambda s, c, v: att.pairs("pr", s, c, v),
                               slot, cand, p.valid)
            if att.dump:
                jax.debug.callback(
                    lambda mm: att.map_at_attempt(mm), m._asdict())
            return p

        def ransac(key, pairs, *a, **k):
            res = sim3.ransac_sim3_reproj(key, pairs, *a, **k)
            jax.debug.callback(lambda kk, ok, n: att.ransac(kk, ok, n),
                               key, res.success, res.n_inliers)
            return res

        def group(m, slot, cand, *a, **k):
            g = lc.group_projection_score(m, slot, cand, *a, **k)
            jax.debug.callback(lambda s, c, v: att.group(s, c, v), slot,
                               cand, g)
            return g

        streaming_lc.lc_mod = Proxy(lc, _pairs_from_tables=pairs_nn,
                                    pairs_by_projection=pairs_pr,
                                    group_projection_score=group)
        streaming_lc.sim3_mod = Proxy(sim3, ransac_sim3_reproj=ransac)

    def install_port(self, tr):
        from openmavis_tpu_torch.pipeline import streaming_lc
        from openmavis_tpu_torch.solvers import sim3

        lc = streaming_lc.lc_mod
        att = self
        step = tr._lc_step
        solve, group = step.solve_candidate, step.group_score

        def wrapped_solve(m, gen, slot, cand, rig, sample_idx=None):
            tables = lc._tables(m)
            nn = lc._pairs_from_tables(tables, tables, slot, cand)
            pr = lc.pairs_by_projection(m, slot, cand, step.rig_kind,
                                        step.n_cams, rig, step.img_w,
                                        step.img_h)
            att.pairs("nn", slot, cand, nn.valid.numpy())
            att.pairs("pr", slot, cand, pr.valid.numpy())
            ransac = sim3.ransac_sim3_reproj
            out = {}

            def rec(*a, **k):
                res = ransac(*a, **k)
                out["res"] = res
                return res

            sim3.ransac_sim3_reproj = rec
            try:
                ok = solve(m, gen, slot, cand, rig, sample_idx)
            finally:
                sim3.ransac_sim3_reproj = ransac
            res = out["res"]
            att.ransac(None, bool(res.success), int(res.n_inliers))
            return ok

        def wrapped_group(m, slot, cand, cov_row, s, R, t, rig):
            g = group(m, slot, cand, cov_row, s, R, t, rig)
            att.group(slot, cand, int(g))
            return g

        step.solve_candidate = wrapped_solve
        step.group_score = wrapped_group


# ---------------------------------------------------------------------------
# the host-policy loop closer (mode host_lc)
# ---------------------------------------------------------------------------

class HostTrace:
    """What a host `LoopCloser` of either package decided, one row per
    `on_keyframe` call (`kind` "loop") and per `detect_merge` call
    ("merge"): the frame (set by the caller), the slot, the pending
    hypothesis it came with and the one it left ([cand, slot, count] or
    None), the retrieval (the dense place scores of every slot, or the
    sparse database's top 3 with their scores and verdicts; for a merge
    the cross-map scores of each other map), the candidates, each solve
    (the candidate, matched pairs, the RANSAC's success and inliers, and
    for a loop the result's inliers or None where a gate refused it),
    each group score, whether a loop closed, and a merge's hit
    ([map, kf_off, mp_off] or None). It wraps the closer's methods and
    the module functions the closer looks up when it runs. `draws`: also
    keep the sample indices of each of the reference's RANSAC calls,
    drawn from the key its `_next_key()` handed out (as
    `ransac_sim3_reproj` draws them), for the port's
    `LoopCloser.samples`."""

    def __init__(self, lc, ref: bool, draws: bool = False):
        self.lc = lc
        self.frame, self.rows = -1, []
        self.draws = [] if draws else None
        self._undo = []
        self._active = False
        if ref:
            from openmavis_tpu.pipeline import loop_closing as lcm
            from openmavis_tpu.pipeline import tracking as trk
            from openmavis_tpu.slam_map import keyframe_db as kdb
            from openmavis_tpu.solvers import sim3
            pairs_fn = "_matched_pairs_body"
        else:
            from openmavis_tpu_torch.pipeline import loop_closing as lcm
            from openmavis_tpu_torch.pipeline import tracking as trk
            from openmavis_tpu_torch.slam_map import keyframe_db as kdb
            from openmavis_tpu_torch.solvers import sim3
            pairs_fn = "_pairs_from_tables"
        self._entries = (self._on_keyframe, self._detect_merge)
        self._wrap(lc, "on_keyframe", self._on_keyframe)
        self._wrap(lc, "detect_merge", self._detect_merge)
        self._wrap(lc, "_candidates", self._candidates)
        self._wrap(lc, "_solve_pair", self._solve_pair)
        self._wrap(lc, "_group_score", self._group_score)
        self._wrap(lcm, pairs_fn, self._pairs)
        self._wrap(lcm, "_matched_pairs_cross", self._pairs_cross)
        self._wrap(lcm, "cross_place_scores", self._cross_scores)
        self._wrap(sim3, "ransac_sim3_reproj", self._ransac)
        self._wrap(trk, "descriptor_place_scores", self._dense)
        self._wrap(kdb, "query_sparse", self._sparse)

    def _wrap(self, obj, name, fn):
        """Route `obj.name` through `fn`; outside an entry call (the
        tracking step may call the same module functions) the original
        runs alone."""
        orig = getattr(obj, name)
        self._undo.append((obj, name, orig))

        def wrapped(*a, **k):
            if self._active or fn in self._entries:
                return fn(orig, *a, **k)
            return orig(*a, **k)

        setattr(obj, name, wrapped)

    def restore(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo = []

    def _pending(self):
        p = self.lc.pending
        return None if p is None else [int(p["cand"]), int(p["slot"]),
                                       int(p["count"])]

    def _enter(self, kind, orig, *a, **k):
        row = dict(kind=kind, frame=self.frame, slot=int(a[1]),
                   pending_in=self._pending(), solves=[], groups=[])
        self.rows.append(row)
        self._active = True
        try:
            out = orig(*a, **k)
        finally:
            self._active = False
        row.update(pending_out=self._pending(),
                   n_loops=int(self.lc.n_loops),
                   n_merges=int(self.lc.n_merges))
        return row, out

    def _on_keyframe(self, orig, m, slot, **kw):
        row, (m2, closed) = self._enter("loop", orig, m, slot, **kw)
        row["closed"] = bool(closed)
        return m2, closed

    def _detect_merge(self, orig, atlas, slot):
        row, hit = self._enter("merge", orig, atlas, slot)
        row["hit"] = None if hit is None else [int(x) for x in hit]
        return hit

    def _candidates(self, orig, m, slot, cov):
        cands = orig(m, slot, cov)
        self.rows[-1]["candidates"] = [int(c) for c in cands]
        self.rows[-1]["covis"] = np.asarray(cov[slot]).tolist()
        return cands

    def _dense(self, orig, m, slot):
        scores = orig(m, slot)
        self.rows[-1]["dense_scores"] = np.asarray(scores).tolist()
        return scores

    def _cross_scores(self, orig, *a, **k):
        scores = orig(*a, **k)
        self.rows[-1].setdefault("cross_scores", []).append(
            np.asarray(scores).tolist())
        return scores

    def _sparse(self, orig, *a, **k):
        scores, top, ok = orig(*a, **k)
        top_l = np.asarray(top).tolist()
        self.rows[-1]["sparse_top"] = dict(
            slots=top_l, scores=np.asarray(scores)[top_l].tolist(),
            ok=np.asarray(ok).tolist())
        return scores, top, ok

    def _solve_pair(self, orig, m, slot, cand):
        solve = dict(cand=int(cand))
        self.rows[-1]["solves"].append(solve)
        res = orig(m, slot, cand)
        solve.update(ok=res is not None, inliers=None if res is None
                     else int(res.n_inliers))
        return res

    def _pairs(self, orig, *a, **k):
        pairs = orig(*a, **k)
        if self.rows[-1]["solves"]:
            self.rows[-1]["solves"][-1]["pairs"] = int(
                np.asarray(pairs.valid).sum())
        return pairs

    def _pairs_cross(self, orig, m_a, slot_a, m_b, slot_b):
        solve = dict(cand=int(slot_b))
        self.rows[-1]["solves"].append(solve)
        pairs = orig(m_a, slot_a, m_b, slot_b)
        solve["pairs"] = int(np.asarray(pairs.valid).sum())
        return pairs

    def _ransac(self, orig, key, pairs, *a, **k):
        if self.draws is not None:
            import jax
            import jax.numpy as jnp
            import torch
            logits = jnp.where(pairs.valid, 0.0, -1e9)
            self.draws.append(torch.as_tensor(np.asarray(
                jax.random.categorical(key, logits[None, None, :],
                                       shape=(k.get("n_hyp", N_HYP_SIM3),
                                              3)))).to(torch.int64))
        res = orig(key, pairs, *a, **k)
        self.rows[-1]["solves"][-1].update(
            ransac=bool(res.success), ransac_inliers=int(res.n_inliers))
        return res

    def _group_score(self, orig, m, slot, cand, cov, s, R, t):
        score = orig(m, slot, cand, cov, s, R, t)
        self.rows[-1]["groups"].append(dict(cand=int(cand),
                                            score=int(score)))
        return score


def reference_closer_state(lc) -> dict:
    """The reference `LoopCloser`'s state laid out as
    `convert.loop_closer_state_to_numpy` lays out the port's."""
    p, v = lc.pending, lc.vocab
    return dict(
        vocab=None if v is None else dict(
            centers=[np.asarray(c) for c in v.centers],
            idf=np.asarray(v.idf), k=int(v.k)),
        db=None if lc.db is None else _np_tree(lc.db),
        pending=None if p is None else dict(
            cand=int(p["cand"]), slot=int(p["slot"]), count=int(p["count"]),
            s=np.asarray(p["s"]), R=np.asarray(p["R"]),
            t=np.asarray(p["t"])),
        n_loops=int(lc.n_loops), n_merges=int(lc.n_merges),
        key=np.asarray(lc.key))


def host_state(tr) -> dict:
    """The reference streaming tracker's host state and its closer's, as
    `convert.streaming_state_to_numpy` and
    `loop_closer_state_to_numpy` lay them out."""
    return dict(map=_np_tree(tr.map), carry=_np_tree(tr.carry),
                _last_lc_slot=int(tr._last_lc_slot), _t_prev=tr._t_prev,
                closer=reference_closer_state(tr.loop_closer))


def set_port_state(tt, st: dict, closer: dict) -> None:
    from openmavis_tpu_torch import convert
    convert.streaming_state_from_numpy(st, tt)
    convert.loop_closer_state_from_numpy(closer, tt.loop_closer)


def closer_state_parts(got: dict, ref: dict) -> dict:
    """The closer state fields that part: the vocabulary and the
    database's words exactly, their weights beyond 1e-6, the pending
    hypothesis's integers exactly and its Sim3 beyond 1e-4, the
    counters."""
    out = {}
    for k in ("n_loops", "n_merges"):
        if got[k] != ref[k]:
            out[k] = [got[k], ref[k]]
    for k in ("vocab", "db", "pending"):
        a, b = got[k], ref[k]
        if (a is None) != (b is None):
            out[k] = "one is None"
            continue
        if a is None:
            continue
        if k == "vocab":
            same = (len(a["centers"]) == len(b["centers"]) and all(
                np.array_equal(x, y) for x, y in zip(a["centers"],
                                                     b["centers"]))
                    and np.array_equal(a["idf"], b["idf"]))
        elif k == "db":
            same = (np.array_equal(a["word"], b["word"])
                    and np.array_equal(a["valid"], b["valid"])
                    and np.allclose(a["wt"], b["wt"], atol=1e-6))
        else:
            same = (all(a[f] == b[f] for f in ("cand", "slot", "count"))
                    and all(np.allclose(a[f], b[f], atol=1e-4)
                            for f in ("s", "R", "t")))
        if not same:
            out[k] = "differs"
    return out


TRACE_KEYS = ("kind", "slot", "pending_in", "dense_scores", "covis",
              "sparse_top", "cross_scores", "candidates", "solves",
              "groups", "pending_out", "closed", "hit")
# the long rows of a trace, left out of a free run's line without
# --trace-full
TRACE_LONG = ("dense_scores", "covis")


def trace_parts(got: list, ref: list) -> dict:
    """The fields of this frame's closer rows that part (the sparse
    scores beyond 1e-5, the rest exactly), with both values."""
    if len(got) != len(ref):
        return {"calls": [len(got), len(ref)]}
    out = {}
    for a, b in zip(got, ref):
        for k in TRACE_KEYS:
            x, y = a.get(k), b.get(k)
            if k == "sparse_top" and x is not None and y is not None:
                same = (x["slots"] == y["slots"] and x["ok"] == y["ok"]
                        and np.allclose(x["scores"], y["scores"],
                                        atol=1e-5))
            else:
                same = x == y
            if not same:
                out[k] = dict(port=x, reference=y)
    return out


def step_port_host_lc(s, n) -> list:
    """Every frame of mode host_lc, from the reference's state of the
    frame before (the map, the stream carry, `_last_lc_slot`, `_t_prev`
    and the closer's vocabulary, database, pending hypothesis, counters
    and key): (1) the port's push with the reference's raw features,
    held against the reference's state after its push; (2) the port's
    `maybe_close_loop` from the reference's state after that push, with
    the reference's RANSAC samples, its decisions (`HostTrace`), its
    closer state and its map held against the reference's. Returns per
    frame the fields that part in each."""
    import torch
    from openmavis_tpu_torch import convert
    from openmavis_tpu_torch.frontend import extractor as tex
    from openmavis_tpu_torch.pipeline import multi_tracking as tmt

    jt, tt = reference_tracker(s), port_tracker(s)
    jtr = HostTrace(jt.loop_closer, ref=True, draws=True)
    ttr = HostTrace(tt.loop_closer, ref=False)
    step = tt._step

    def shared_bank(images):
        fj = reference_features(s, images.numpy())
        return tmt.concat_bands(tex.Features(*(torch.as_tensor(np.array(x))
                                               for x in fj)))

    step.extract_bank = shared_bank
    rows = []
    for i in range(n):
        t, b = s["batches"][i]
        before = host_state(jt)
        draws = two_view_draws(s, (before["map"], before["carry"], None),
                               s["frames"][i])
        jt.push(s["frames"][i], t, b)
        mid = host_state(jt)
        pushed = tracker_record(jt, full=True)
        jtr.frame = ttr.frame = i
        jtr.draws.clear()
        n_rows = len(jtr.rows)
        jt.maybe_close_loop()
        after = tracker_record(jt, full=True)
        # (1) the push
        set_port_state(tt, before, before["closer"])
        tt.push(s["frames"][i], t, b, sample_idx=None if draws is None
                else tuple(torch.as_tensor(x) for x in draws))
        push_parts = compare(tracker_record(tt, full=True), pushed)
        # (2) the closer, from the reference's pushed state
        set_port_state(tt, mid, before["closer"])
        tt.loop_closer.samples.clear()
        tt.loop_closer.samples.extend(jtr.draws)
        t_rows = len(ttr.rows)
        tt.maybe_close_loop()
        row = dict(frame=i, mode=int(after["mode"]),
                   n_kf=int(after["n_kf"]), push_parts=push_parts,
                   closer_call=len(jtr.rows) > n_rows)
        if row["closer_call"] or len(ttr.rows) > t_rows:
            row.update(
                trace=jtr.rows[n_rows:],
                trace_parts=trace_parts(ttr.rows[t_rows:],
                                        jtr.rows[n_rows:]),
                closer_parts=closer_state_parts(
                    convert.loop_closer_state_to_numpy(tt.loop_closer),
                    reference_closer_state(jt.loop_closer)),
                closed_map_parts=compare(tracker_record(tt, full=True),
                                         after))
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    jtr.restore()
    ttr.restore()
    return rows


def hold_confirm(s, frame: int, seeds) -> dict:
    """Mode host_lc: both packages run free (closer seed `s["lc_seed"]`)
    up to `frame` and push it; then each package's closer, seeded with
    each of `seeds` and given the state of the run whose map it gets
    (its pending hypothesis), decides on each package's map of that
    frame. The correction is skipped (only the decision is read).
    Returns, for each map and closer, the loops closed over the seeds
    and the first solve's pairs and RANSAC inliers of each seed."""
    import jax.numpy as jnp
    from openmavis_tpu.optim.reprojection import RigParams
    from openmavis_tpu.pipeline import loop_closing as jlc
    from openmavis_tpu.slam_map import map_state as jms
    from openmavis_tpu_torch import convert
    from openmavis_tpu_torch.pipeline import loop_closing as tlc

    runs = {}
    for name, tr in (("reference", reference_tracker(s)),
                     ("port", port_tracker(s))):
        for i in range(frame + 1):
            t, b = s["batches"][i]
            tr.push(s["frames"][i], t, b)
            if i < frame:
                tr.maybe_close_loop()
        runs[name] = dict(
            map=(_np_tree(tr.map) if name == "reference"
                 else convert.map_to_numpy(tr.map)),
            closer=(reference_closer_state(tr.loop_closer)
                    if name == "reference"
                    else convert.loop_closer_state_to_numpy(tr.loop_closer)),
            slot=int(np.asarray(tr.map.n_kf)) - 1,
            last=tr._last_lc_slot)
    r = s["rig_np"]
    jrig_args = [jnp.asarray(r[k]) for k in ("params", "R_cb", "t_cb")]
    trig = convert.rig_from_numpy(r, device="cpu")
    out = {}
    for map_name, run in runs.items():
        if run["slot"] == run["last"]:
            raise SystemExit("frame %d inserts no keyframe in the %s run"
                             % (frame, map_name))
        st = run["closer"]
        for closer_name in ("reference", "port"):
            rows = []
            for seed in seeds:
                if closer_name == "reference":
                    lc = jlc.LoopCloser(None, 64, seed=seed,
                                        rig=RigParams(r["kind"], *jrig_args),
                                        inertial=True, img_w=640,
                                        img_h=480)
                    p = st["pending"]
                    lc.pending = None if p is None else dict(
                        p, **{k: jnp.asarray(p[k]) for k in "sRt"})
                    lc.vocab = (None if st["vocab"] is None else
                                jlc.voc.Vocabulary(
                                    tuple(jnp.asarray(c) for c in
                                          st["vocab"]["centers"]),
                                    jnp.asarray(st["vocab"]["idf"]),
                                    st["vocab"]["k"]))
                    lc.db = (None if st["db"] is None else
                             jlc.kdb.SparseKeyframeDB(
                                 **{k: jnp.asarray(v)
                                    for k, v in st["db"].items()}))
                    m = jms.MapState(**{k: jnp.asarray(v)
                                        for k, v in run["map"].items()})
                else:
                    lc = tlc.LoopCloser(None, 64, seed=seed, rig=trig,
                                        inertial=True, img_w=640,
                                        img_h=480, device="cpu")
                    convert.loop_closer_state_from_numpy(
                        {k: v for k, v in st.items() if k != "key"}, lc)
                    m = convert.map_from_numpy(run["map"], device="cpu")
                lc._correct = lambda m, *a: m
                trace = HostTrace(lc, ref=closer_name == "reference")
                try:
                    _, closed = lc.on_keyframe(m, run["slot"])
                finally:
                    trace.restore()
                sol = trace.rows[-1]["solves"]
                rows.append(dict(seed=seed, closed=bool(closed),
                                 first_solve=sol[0] if sol else None))
            key = "%s_map__%s_closer" % (map_name, closer_name)
            out[key] = dict(
                slot=run["slot"], pending=st["pending"] and [
                    st["pending"][k] for k in ("cand", "slot", "count")],
                closed=sum(x["closed"] for x in rows), seeds=rows)
            print(json.dumps({key: out[key]}), file=sys.stderr, flush=True)
    return out


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

def summary(s, n, recs, traj) -> dict:
    """The JSON line's fields from per-frame records and the trajectory."""
    times = np.arange(n) / scene.FPS_IN
    t_est, _, p_est = traj
    ok = np.array([int(r["mode"]) == 2 for r in recs])

    def ate(upto):
        sel = ok[:upto + 1][:len(t_est)]
        if sel.sum() < 4:
            return {}
        return evaluation.ate_rmse(t_est[:upto + 1][sel], p_est[:upto + 1][
            sel], times[:upto + 1], s["t_wb"][:upto + 1], with_scale=True)

    kf_frames = [i for i, r in enumerate(recs)
                 if int(r["mode"]) == 2 and np.float32(r["last_kf_time"])
                 == np.float32(times[i])]
    imu = []
    for i, r in enumerate(recs):
        prev = int(recs[i - 1]["viba_stage"]) if i else 0
        if int(r["viba_stage"]) != prev:
            a = ate(i)
            imu.append(dict(frame=i, viba_stage=int(r["viba_stage"]),
                            horn_scale=float(a.get("scale", np.nan))))
    loops = [i for i, r in enumerate(recs)
             if int(r["n_loops"]) > (int(recs[i - 1]["n_loops"]) if i
                                     else 0)]
    last = recs[-1]
    a = ate(n - 1)
    return dict(
        frames=n, frames_tracked=int(ok.sum()),
        init_frame=int(np.argmax(ok)) if ok.any() else None,
        keyframe_frames=kf_frames, n_keyframes=int(last["n_kf"]),
        n_landmarks=int(last["n_mp"]), imu_init=imu, loop_frames=loops,
        lc_dbg=[float(x) for x in last["lc_dbg"]],
        ate_rmse_m=float(a.get("rmse", np.nan)),
        ate_rmse_noscale_m=float(a.get("rmse_noscale", np.nan)),
        horn_scale=float(a.get("scale", np.nan)))


def run_reference(s, n, attempts=None, dump=None, dump_frames=None,
                  trace=None):
    if attempts is not None:
        attempts.install_reference()
    tr = reference_tracker(s)
    if tr.loop_closer is not None:
        trace.append(HostTrace(tr.loop_closer, ref=True))
    recs, draws = [], {}
    for i in range(n):
        t, b = s["batches"][i]
        if attempts is not None:
            attempts.frame = i
        if dump and dump_frames is not None and i in dump_frames:
            d = two_view_draws(s, reference_state(tr), s["frames"][i])
            if d is not None:
                draws[i] = d
        t0 = time.perf_counter()
        tr.push(s["frames"][i], t, b)
        if tr.loop_closer is not None:
            trace[0].frame = i
            tr.maybe_close_loop()
        recs.append(tracker_record(tr))
        if dump and dump_frames is not None and i in dump_frames:
            save_state(dump, i, reference_state(tr), draws.get(i))
        if i < 3 or (i + 1) % 20 == 0:
            print("reference frame %d: %.1f s, mode %d, n_kf %d"
                  % (i, time.perf_counter() - t0, int(recs[-1]["mode"]),
                     int(recs[-1]["n_kf"])), file=sys.stderr, flush=True)
    return recs, tr.get_trajectory()


def run_port(s, n, attempts=None, draws=None, trace=None):
    tr = port_tracker(s)
    if attempts is not None:
        attempts.install_port(tr)
    if tr.loop_closer is not None:
        trace.append(HostTrace(tr.loop_closer, ref=False))
    recs = []
    for i in range(n):
        t, b = s["batches"][i]
        if attempts is not None:
            attempts.frame = i
        sample_idx = None
        if draws is not None and int(tr.carry.mode) == 1:
            sample_idx = port_two_view_samples(s, tr, s["frames"][i],
                                               draws)
        t0 = time.perf_counter()
        tr.push(s["frames"][i], t, b, sample_idx=sample_idx)
        if tr.loop_closer is not None:
            trace[0].frame = i
            tr.maybe_close_loop()
        recs.append(tracker_record(tr))
        if i < 3 or (i + 1) % 20 == 0:
            print("port frame %d: %.1f s, mode %d, n_kf %d"
                  % (i, time.perf_counter() - t0, int(recs[-1]["mode"]),
                     int(recs[-1]["n_kf"])), file=sys.stderr, flush=True)
    return recs, tr.get_trajectory()


def save_state(dump, i, state, draws):
    m, c, lcc = state
    flat = {"map." + k: v for k, v in m.items()}
    for k, v in c.items():
        if isinstance(v, dict):
            flat.update({"carry.%s.%s" % (k, kk): vv for kk, vv in
                         v.items()})
        else:
            flat["carry." + k] = v
    flat.update({"lc." + k: v for k, v in lcc.items()})
    if draws is not None:
        flat.update(two_view_idx8=draws[0], two_view_idx4=draws[1])
    np.savez_compressed(os.path.join(dump, "frame_%04d.npz" % i), **flat)


# ---------------------------------------------------------------------------
# two-view draws
# ---------------------------------------------------------------------------

_EXTRACT = {}


def reference_features(s, images):
    """The reference's raw features of a frame (jitted once)."""
    import jax
    import jax.numpy as jnp
    from openmavis_tpu.frontend import extractor

    if "fn" not in _EXTRACT:
        cfg = extractor.OrbConfig(**s["orb"])
        _EXTRACT["fn"] = jax.jit(
            lambda im: extractor.extract_multicam(im, cfg))
    return _EXTRACT["fn"](jnp.asarray(np.asarray(images, np.float32)))


def two_view_draws(s, state, images):
    """The samples the reference's `mono_do_init` draws on this frame from
    `state` (the state before the frame), or None when the frame makes no
    two-view attempt: (idx8 [256, 8], idx4 [256, 4])."""
    from openmavis_tpu.frontend import matcher

    _, c, _ = state
    if int(c["mode"]) != 1:
        return None
    F = s["orb"]["n_features"]
    f = reference_features(s, images)
    idx, _ = matcher.match_nn(
        f.desc[0], f.valid[0], c["ref_bank"]["desc"][:F],
        c["ref_bank"]["valid"][:F], max_dist=matcher.TH_LOW, ratio=0.9,
        mutual=True)
    matched = np.asarray(idx) >= 0
    if matched.sum() < init_min_matches(s):
        return None
    return draws_from_key(c["key"], matched)


def init_min_matches(s) -> int:
    from openmavis_tpu_torch.pipeline import streaming_vi
    return streaming_vi.VIStreamConfig(**s["cfg_kw"]).init_min_matches


def init_min_inliers(s) -> int:
    from openmavis_tpu_torch.pipeline import streaming_vi
    return streaming_vi.VIStreamConfig(**s["cfg_kw"]).init_min_inliers


def draws_from_key(key, matched):
    import jax
    import jax.numpy as jnp
    sub = jax.random.split(jnp.asarray(key))[1]
    key_e, key_h = jax.random.split(sub)
    logits = jnp.where(jnp.asarray(matched), 0.0, -1e9)[None, None, :]
    return tuple(np.asarray(jax.random.categorical(
        k, logits, shape=(N_HYP_TWO_VIEW, n))) for k, n in ((key_e, 8),
                                                             (key_h, 4)))


def port_two_view_samples(s, tr, images, draws):
    """Samples for the port's two-view attempt on this frame, drawn as the
    reference draws them over the port's own matches, from the next of
    `draws` (the reference's carry keys on its attempts, in order); None
    when the frame makes no attempt."""
    import torch
    from openmavis_tpu_torch.frontend import matcher

    step = tr._step
    F = step.F
    bank = step.extract_bank(torch.as_tensor(np.asarray(
        images, np.float32)))
    ref = tr.carry.ref_bank
    idx, _ = matcher.match_nn(bank["desc"][:F], bank["valid"][:F],
                              ref["desc"][:F], ref["valid"][:F],
                              max_dist=matcher.TH_LOW, ratio=0.9,
                              mutual=True)
    matched = (idx >= 0).numpy()
    if not draws or matched.sum() < step.cfg.init_min_matches:
        return None
    return tuple(torch.as_tensor(x) for x in draws_from_key(
        draws.pop(0), matched))


# ---------------------------------------------------------------------------
# stepping the port from the reference's state
# ---------------------------------------------------------------------------

def step_port(s, n, attempts: Attempts) -> list:
    """Every frame: the port's push from the reference's state of the frame
    before, with the reference's raw features, two-view samples and loop
    RANSAC samples; returns per frame the fields that part."""
    import jax
    import jax.numpy as jnp
    import torch
    from openmavis_tpu_torch import convert
    from openmavis_tpu_torch.frontend import extractor as tex
    from openmavis_tpu_torch.pipeline import multi_tracking as tmt

    attempts.install_reference()
    jt, tt = reference_tracker(s), port_tracker(s)
    step = tt._step

    def shared_bank(images):
        fj = reference_features(s, images.numpy())
        feats = tex.Features(*(torch.as_tensor(np.array(x)) for x in fj))
        if step.dist is not None:
            feats = tex.undistort_features(feats, step.rig.params,
                                           step.dist)
        return tmt.concat_bands(feats)

    step.extract_bank = shared_bank
    lc = tt._lc_step
    solve = lc.solve_candidate

    def solve_with_reference_draws(m, gen, slot, cand, rig,
                                   sample_idx=None):
        key = attempts.rows[-1].get("key") if attempts.rows and \
            attempts.rows[-1]["frame"] == attempts.frame else None
        if key is not None:
            valid = pair_valid(m, slot, cand, rig)
            logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)[None, None]
            sample_idx = torch.as_tensor(np.asarray(jax.random.categorical(
                jnp.asarray(np.asarray(key, np.uint32)), logits,
                shape=(N_HYP_SIM3, 3)))).to(torch.int64)
        return solve(m, gen, slot, cand, rig, sample_idx)

    def pair_valid(m, slot, cand, rig):
        from openmavis_tpu_torch.pipeline import loop_closing as tlc
        tab = tlc._tables(m)
        nn = tlc._pairs_from_tables(tab, tab, slot, cand)
        pr = tlc.pairs_by_projection(m, slot, cand, lc.rig_kind, lc.n_cams,
                                     rig, lc.img_w, lc.img_h)
        return np.concatenate([nn.valid.numpy(), pr.valid.numpy()])

    lc.solve_candidate = solve_with_reference_draws
    rows = []
    for i in range(n):
        t, b = s["batches"][i]
        before = reference_state(jt)
        draws = two_view_draws(s, before, s["frames"][i])
        attempts.frame = i
        jt.push(s["frames"][i], t, b)
        after = tracker_record(jt, full=True)
        m_np, c_np, l_np = before
        tt.map = convert.map_from_numpy(m_np, device="cpu")
        tt.carry = convert.carry_from_numpy(c_np, device="cpu")
        tt.lc_carry = convert.lc_carry_from_numpy(l_np, device="cpu")
        tt._t_prev = s["batches"][i - 1][0] if i else None
        tt._snap = None
        tt.push(s["frames"][i], t, b, sample_idx=None if draws is None
                else tuple(torch.as_tensor(x) for x in draws))
        got = tracker_record(tt, full=True)
        rows.append(dict(frame=i, mode=int(after["mode"]),
                         n_kf=int(after["n_kf"]), n_mp=int(after["n_mp"]),
                         two_view_attempt=draws is not None,
                         lc_events=list(tt.lc_events),
                         parts=compare(got, after)))
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def compare(got: dict, ref: dict) -> dict:
    """The fields of `got` that part from `ref`: integers and bools
    exactly (the count of differing entries), poses and landmarks beyond
    1e-3 m (the largest difference)."""
    out = {}
    for k in INTS:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        if a.shape != b.shape or not np.array_equal(a, b):
            out[k] = int(np.sum(a != b)) if a.shape == b.shape else "shape"
    for k in FLOATS:
        a, b = np.asarray(got[k], np.float64), np.asarray(ref[k], np.float64)
        d = float(np.max(np.abs(a - b))) if a.size else 0.0
        if d > 1e-3:
            out[k] = d
    return out


def _closure_fn(fn, name):
    """The function `name` that `fn` reaches through its closures (the
    reference's loop step keeps `_solve_candidate` inside `make_lc_step`)."""
    todo, seen = [fn], set()
    while todo:
        f = todo.pop()
        f = getattr(f, "__wrapped__", f)
        if id(f) in seen:
            continue
        seen.add(id(f))
        if getattr(f, "__name__", None) == name:
            return f
        for cell in getattr(f, "__closure__", None) or ():
            if callable(cell.cell_contents):
                todo.append(cell.cell_contents)
    raise LookupError(name)


def hold_attempt(s, dump: str, frame: int) -> dict:
    """The loop attempt of `frame` on the reference's own map (saved by a
    `--dump` run): the reference's `_solve_candidate` against the port's
    `LCStep.solve_candidate`, the pairs of both sources and the RANSAC
    samples drawn from the reference's key."""
    import jax
    import jax.numpy as jnp
    import torch
    from openmavis_tpu.optim.reprojection import RigParams
    from openmavis_tpu.pipeline import loop_closing as jlc
    from openmavis_tpu.pipeline import streaming_lc as jslc
    from openmavis_tpu.slam_map import map_state as jms
    from openmavis_tpu_torch import convert
    from openmavis_tpu_torch.pipeline import loop_closing as tlc

    with open(os.path.join(dump, "attempt_%04d.json" % frame)) as f:
        row = json.load(f)
    slot, cand = row["slot"], row["cand"]
    key = jnp.asarray(np.asarray(row["key"], np.uint32))
    d = dict(np.load(os.path.join(dump, "attempt_map_%04d.npz" % frame)))
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    r = s["rig_np"]
    jrig = RigParams(r["kind"], *(jnp.asarray(r[k]) for k in
                                  ("params", "R_cb", "t_cb")))
    tt = port_tracker(s)
    tm = convert.map_from_numpy(d, device="cpu")
    lc = tt._lc_step
    cfg = reference_tracker(s).cfg
    jstep = jslc.make_lc_step(cfg, r["kind"], cfg.n_cams, True,
                              float(cfg.img_w), float(cfg.img_h), **LC_KW)
    solve = jax.jit(_closure_fn(jstep, "_solve_candidate"),
                    static_argnums=())
    j_ok, j_n, j_s, j_R, j_t = solve(jm, key, slot, cand, jrig)

    def jpairs(m):
        t = jlc._tables(m)
        return (jlc._pairs_from_tables(t, t, slot, cand),
                jlc.pairs_by_projection(m, slot, cand, jrig.kind,
                                        cfg.n_cams, jrig,
                                        float(cfg.img_w), float(cfg.img_h)))

    jnn, jpr = jax.jit(jpairs)(jm)
    tab = tlc._tables(tm)
    tnn = tlc._pairs_from_tables(tab, tab, slot, cand)
    tpr = tlc.pairs_by_projection(tm, slot, cand, lc.rig_kind, lc.n_cams,
                                  tt.rig, lc.img_w, lc.img_h)
    valid = np.concatenate([tnn.valid.numpy(), tpr.valid.numpy()])
    # the key recorded is the one the reference's RANSAC drew from
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)[None, None]
    idx = torch.as_tensor(np.asarray(jax.random.categorical(
        key, logits, shape=(N_HYP_SIM3, 3)))).to(torch.int64)
    t_ok, t_n, t_s, t_R, t_t = lc.solve_candidate(tm, None, slot, cand,
                                                  tt.rig, idx)
    from openmavis_tpu_torch.slam_map import map_state as tms
    t_cand, t_cand_ok, _ = lc.retrieval(tm, tt.lc_carry, slot,
                                        tms.covisibility_matrix(tm))
    out = dict(frame=frame, slot=slot, cand=cand, recorded=row,
               port_retrieval=dict(cand=int(t_cand), ok=bool(t_cand_ok)))
    for name, jp, tp in (("nn", jnn, tnn), ("pr", jpr, tpr)):
        jv, tv = np.asarray(jp.valid), tp.valid.numpy()
        both = jv & tv
        out["pairs_" + name] = dict(
            reference=int(jv.sum()), port=int(tv.sum()),
            valid_differ=int((jv != tv).sum()),
            p_b_max_diff=float(np.abs(np.asarray(jp.p_b)[both]
                                      - tp.p_b.numpy()[both]).max())
            if both.any() else 0.0)
    out["solve"] = dict(
        reference=dict(ok=bool(j_ok), n_pairs=int(j_n), s=float(j_s)),
        port=dict(ok=bool(t_ok), n_pairs=int(t_n), s=float(t_s)),
        R_max_diff=float(np.abs(np.asarray(j_R) - t_R.numpy()).max()),
        t_max_diff=float(np.abs(np.asarray(j_t) - t_t.numpy()).max()))
    return out


def two_view_check(s, frame: int) -> dict:
    """The two-view attempt of `frame` from the reference's state of the
    frame before, with the reference's features and samples: both
    packages' `two_view.reconstruct` (success, good points, model), and
    per E hypothesis the score of each package's float32 8-point solve
    and of the float64 one (the reference's code under x64): the winning
    hypothesis of each, and the singular values of the 8 x 9 system of the
    port's winner (`two_view_compare`)."""
    import jax.numpy as jnp
    from openmavis_tpu.frontend import extractor as jex
    from openmavis_tpu.frontend import matcher
    from openmavis_tpu.geometry import cameras as jcam

    tr = reference_tracker(s)
    for i in range(frame):
        t, b = s["batches"][i]
        tr.push(s["frames"][i], t, b)
    _, c, _ = reference_state(tr)
    F = s["orb"]["n_features"]
    r = s["rig_np"]
    f = reference_features(s, s["frames"][frame])
    xy = f.xy[0]
    if s["dist"] is not None:
        xy = jex.undistort_features(f, jnp.asarray(r["params"]),
                                    jnp.asarray(s["dist"])).xy[0]
    idx, _ = matcher.match_nn(
        f.desc[0], f.valid[0], c["ref_bank"]["desc"][:F],
        c["ref_bank"]["valid"][:F], max_dist=matcher.TH_LOW, ratio=0.9,
        mutual=True)
    idx = np.asarray(idx)
    matched = idx >= 0

    def bearing_z1(p):
        ray = np.asarray(jcam.unproject(r["kind"],
                                        jnp.asarray(r["params"][0]),
                                        jnp.asarray(p)))
        return (ray[:, :2] / np.maximum(ray[:, 2], 1e-6)[:, None]).astype(
            np.float32)

    x1 = bearing_z1(c["ref_bank"]["xy"][:F])[np.where(matched, idx, 0)]
    x2 = bearing_z1(np.asarray(xy))
    out = dict(frame=frame)
    out.update(two_view_compare(
        c["key"], x1, x2, matched, float(r["params"][0, 0]),
        init_min_inliers(s)))
    return out


def two_view_compare(key, x1, x2, matched, focal: float,
                     min_inliers: int) -> dict:
    """One two-view attempt in both packages from the same matches and
    the samples the reference draws from `key` (its carry or tracker key
    before the attempt: split once, then as `two_view.reconstruct`
    draws): each package's `reconstruct` (success, good points, model),
    and per E hypothesis the score of each package's float32 8-point
    solve and of the float64 one (the reference's code under x64): the
    winning hypothesis of each, the singular values of the 8 x 9 system
    of the port's winner, and how many hypotheses score more than 1 off
    their float64 value."""
    import jax
    import jax.numpy as jnp
    import torch
    from openmavis_tpu.solvers import two_view as jtv
    from openmavis_tpu_torch.solvers import two_view as ttv

    i8, i4 = draws_from_key(key, matched)
    sub = jax.random.split(jnp.asarray(key))[1]
    res_j = jtv.reconstruct(sub, jnp.asarray(x1), jnp.asarray(x2),
                            jnp.asarray(matched), focal=focal,
                            min_inliers=min_inliers)
    res_t = ttv.reconstruct(None, torch.as_tensor(x1), torch.as_tensor(x2),
                            torch.as_tensor(matched),
                            focal=torch.tensor(focal),
                            min_inliers=min_inliers,
                            sample_idx=(torch.as_tensor(i8),
                                        torch.as_tensor(i4)))
    bad = (~matched[i8]).any(-1)

    def scores(tv, xp, a, b):
        E = tv.essential_from_8pt(a[xp.asarray(i8)], b[xp.asarray(i8)])
        sc, _ = tv.epipolar_score(E, a, b, focal, 1.0)
        return np.where(bad, -np.inf, np.asarray(sc, np.float64))

    s_ref = scores(jtv, jnp, jnp.asarray(x1), jnp.asarray(x2))
    s_port = scores(ttv, torch, torch.as_tensor(x1), torch.as_tensor(x2))
    with jax.enable_x64(True):
        s_64 = scores(jtv, jnp, jnp.asarray(x1, jnp.float64),
                      jnp.asarray(x2, jnp.float64))
    win = {k: int(np.argmax(v)) for k, v in
           (("reference", s_ref), ("port", s_port), ("float64", s_64))}
    h = win["port"]
    A = np.stack([np.kron(np.r_[x2[j], 1.0], np.r_[x1[j], 1.0])
                  for j in i8[h]])
    repeated = np.array([len(set(row.tolist())) < 8 for row in i8])
    ok = ~bad
    return dict(
        matched=int(matched.sum()),
        reference=dict(success=bool(res_j.success),
                       good=int(res_j.is_good.sum())),
        port=dict(success=bool(res_t.success),
                  good=int(res_t.is_good.sum()),
                  homography=bool(res_t.homography)),
        e_winner=win,
        e_winner_scores={k: dict(reference=float(s_ref[v]),
                                 port=float(s_port[v]),
                                 float64=float(s_64[v]))
                         for k, v in win.items()},
        port_winner_samples=i8[h].tolist(),
        port_winner_singular_values=np.linalg.svd(
            A, compute_uv=False).tolist(),
        hypotheses_off_float64_by_1=dict(
            reference=int((np.abs(s_ref - s_64)[ok] > 1).sum()),
            port=int((np.abs(s_port - s_64)[ok] > 1).sum())),
        hypotheses_with_a_repeated_sample=int(repeated.sum()))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("mode", choices=MODES)
    p.add_argument("--frames", type=int)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--port", action="store_true")
    p.add_argument("--attempts", action="store_true")
    p.add_argument("--dump")
    p.add_argument("--dump-frames")
    p.add_argument("--step-port", action="store_true")
    p.add_argument("--port-draws", action="store_true")
    p.add_argument("--hold-attempt", type=int, metavar="FRAME")
    p.add_argument("--two-view", type=int, metavar="FRAME")
    p.add_argument("--trace-full", action="store_true")
    p.add_argument("--hold-confirm", type=int, metavar="FRAME")
    args = p.parse_args()
    n = args.frames or dict(flagship=cs.N_FRAMES,
                            mono_inertial_euroc=cs.N_FRAMES_MONO,
                            long=200,
                            host_lc=cs.N_FRAMES_HOST_LC)[args.mode]
    t0 = time.perf_counter()
    s = setup(args.mode, n, args.seed)
    host = args.mode == "host_lc"
    dump_frames = None
    if args.dump_frames:
        a, _, b = args.dump_frames.partition("-")
        dump_frames = set(range(int(a), int(b or a) + 1))
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    attempts = (Attempts(args.dump)
                if (args.attempts or args.step_port) and not host else None)
    out = dict(mode=args.mode, package="port" if args.port else "reference")
    if host:
        out["lc_seed"] = args.seed
    trace = []
    if args.two_view is not None:
        out.update(package="both, from the reference's state",
                   **two_view_check(s, args.two_view))
    elif args.hold_attempt is not None:
        out.update(package="both, on the reference's map at the attempt",
                   **hold_attempt(s, args.dump, args.hold_attempt))
    elif args.hold_confirm is not None and host:
        out.update(package="both closers on both maps",
                   frame=args.hold_confirm,
                   **hold_confirm(s, args.hold_confirm, range(100, 108)))
    elif args.step_port and host:
        rows = step_port_host_lc(s, n)
        out.update(package="port stepped from the reference",
                   first_push_part=next((r["frame"] for r in rows
                                         if r["push_parts"]), None),
                   first_closer_part=next(
                       (r["frame"] for r in rows
                        if r.get("trace_parts") or r.get("closer_parts")),
                       None),
                   frames=rows)
    elif args.step_port:
        out.update(package="port stepped from the reference",
                   frames=step_port(s, n, attempts))
    elif args.port_draws:
        recs, traj = run_port(s, n, draws=_attempt_keys(s, n))
        out.update(package="port with the reference's two-view draws",
                   **summary(s, n, recs, traj))
    elif args.port:
        recs, traj = run_port(s, n, attempts, trace=trace)
        out.update(summary(s, n, recs, traj))
    else:
        recs, traj = run_reference(s, n, attempts, args.dump, dump_frames,
                                   trace=trace)
        out.update(summary(s, n, recs, traj))
    if attempts is not None and not args.step_port:
        out["attempts"] = [{k: v for k, v in r.items() if k != "key"}
                           for r in attempts.rows]
    if trace:
        trace[0].restore()
        out["lc_trace"] = [{k: v for k, v in r.items()
                            if args.trace_full or k not in TRACE_LONG}
                           for r in trace[0].rows]
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


def _attempt_keys(s, n):
    """The reference's carry keys on the frames that attempt a two-view
    init, in order."""
    tr = reference_tracker(s)
    keys = []
    for i in range(n):
        t, b = s["batches"][i]
        state = reference_state(tr)
        if two_view_draws(s, state, s["frames"][i]) is not None:
            keys.append(state[1]["key"])
        tr.push(s["frames"][i], t, b)
        if int(tr.carry.mode) == 2 and keys:
            break
    return keys


if __name__ == "__main__":
    sys.exit(main())
