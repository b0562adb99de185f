"""Parity of the port's host-policy loop closer `loop_closing.LoopCloser`
and of the rig trackers' `loop_closer=` arms (`StreamingVITracker.
maybe_close_loop`, `MultiTracker`) with the JAX reference on the CPU; the
one-camera scenes and trackers are in `test_torch_loop_closer_mono.py`.

Scene: `test_torch_loop_closing.py`'s staged revisit (keyframe 11 comes
back to keyframe 0's landmarks under a yaw and translation drift; two
cameras), with keyframe 12 a second drifted revisit where a hypothesis
must be confirmed on a second keyframe.

The reference's RANSAC draws are recorded as it makes them (its
`ransac_sim3_reproj` / `ransac_sim3` are wrapped to replay the same
`jax.random.categorical` on the key they get) and handed to the port's
closer as its `samples` queue, so both run the same hypotheses.

Tolerances: candidate lists, inlier masks, gate decisions, pending
slots and counts, `n_loops`, loop edges, bindings and the covisibility
edge set exact; a Sim3 1e-4; corrected maps after the post-loop BA
1e-3 (float32 normal equations summed in another order); a live pose
relative to its reference keyframe 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_loop_closing as tlcg
from test_torch_loop_closing import (C, CAND, F, H, K, M, SLOT, W, _arrive,
                                     _as_dict, _jmap, second_revisit)
from test_torch_multi_tracker import _ref_state as mt_ref_state
from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.imu import preintegration as jpre
from openmavis_tpu.optim import pose_graph as jpg
from openmavis_tpu.pipeline import loop_closing as jlc
from openmavis_tpu.pipeline import multi_tracking as jmt
from openmavis_tpu.pipeline import streaming_vi as jsv
from openmavis_tpu.slam_map import map_state as jms
from openmavis_tpu.solvers import sim3 as jsim3
from openmavis_tpu_torch import convert
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.frontend import matcher_cuda
from openmavis_tpu_torch.optim import pose_graph as tpg
from openmavis_tpu_torch.pipeline import loop_closing as tlc
from openmavis_tpu_torch.pipeline import multi_tracking as tmt
from openmavis_tpu_torch.pipeline import streaming_vi as tsv
from openmavis_tpu_torch.slam_map import atlas as tatlas
from openmavis_tpu_torch.slam_map import map_state as tms
import test_torch_ref_cache as ref_cache


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread is as fast
    as eight, and eight per test worker oversubscribe the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


class Draws:
    """Records the sample indices of every reference RANSAC call made
    while it is entered, in call order."""

    def __init__(self):
        self.idx = []

    def _draw(self, key, valid, n_hyp):
        logits = jnp.where(valid, 0.0, -1e9)
        idx = jax.random.categorical(key, logits[None, None, :],
                                     shape=(n_hyp, 3))
        self.idx.append(torch.as_tensor(np.array(idx)).to(torch.int64))

    def __enter__(self):
        reproj, plain = jsim3.ransac_sim3_reproj, jsim3.ransac_sim3

        def ransac_sim3_reproj(key, pairs, *a, n_hyp=128, **kw):
            self._draw(key, pairs.valid, n_hyp)
            return reproj(key, pairs, *a, n_hyp=n_hyp, **kw)

        def ransac_sim3(key, p1, p2, valid, *a, n_hyp=128, **kw):
            self._draw(key, valid, n_hyp)
            return plain(key, p1, p2, valid, *a, n_hyp=n_hyp, **kw)

        self._mp = pytest.MonkeyPatch()
        self._mp.setattr(jsim3, "ransac_sim3_reproj", ransac_sim3_reproj)
        self._mp.setattr(jsim3, "ransac_sim3", ransac_sim3)
        return self

    def __exit__(self, *exc):
        self._mp.undo()


@pytest.fixture(scope="module")
def staged():
    return tlcg.Staged()


def _closers(cfg, jrig, trig, inertial, max_kf=K, draws=()):
    jl = jlc.LoopCloser(None, max_kf, cfg, rig=jrig, inertial=inertial,
                        img_w=W, img_h=H)
    tl = tlc.LoopCloser(None, max_kf, cfg, rig=trig, inertial=inertial,
                        img_w=W, img_h=H, device="cpu", samples=draws)
    return jl, tl


def _maps_close(tm, jm, ints=("loop_i", "loop_j", "loop_valid", "n_loop",
                              "kf_obs", "kf_valid", "mp_valid", "n_kf"),
                floats=("kf_R", "kf_t", "kf_v", "mp_pos"), tol=1e-3):
    for name in ints:
        np.testing.assert_array_equal(convert._np(getattr(tm, name)),
                                      _np(getattr(jm, name)), err_msg=name)
    for name in floats:
        np.testing.assert_allclose(convert._np(getattr(tm, name)),
                                   _np(getattr(jm, name)), atol=tol, rtol=0,
                                   err_msg=name)
    assert np.all(np.isfinite(convert._np(tm.mp_pos)))


def _pending_close(tp, jp):
    if jp is None:
        assert tp is None
        return
    assert tp is not None
    for k in ("cand", "slot", "count"):
        assert int(tp[k]) == int(jp[k]), k
    for k in ("s", "R", "t"):
        np.testing.assert_allclose(convert._np(tp[k]), _np(jp[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


def _snap_pending(p):
    return None if p is None else dict(p)


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

SPARSE_CFG = dict(vocab_train_kf=10, vocab_train_samples=1000,
                  vocab_levels=2, bow_top_w=64)


@pytest.mark.parametrize("route", ["dense", "sparse", "spatial"])
def test_candidates(staged, route):
    """`_candidates` on every query slot of the staged map: the candidate
    lists equal exactly. The sparse route trains the session vocabulary
    on both sides first (the same centers, idf and backfilled database),
    and each query writes its keyframe into the database."""
    cfg = {"dense": jlc.LoopConfig(),
           "sparse": jlc.LoopConfig(**SPARSE_CFG),
           "spatial": jlc.LoopConfig(candidate_source="spatial",
                                     spatial_radius=0.3)}[route]
    tcfg = tlc.LoopConfig(**cfg.__dict__)
    jl, _ = _closers(cfg, staged.jrig, staged.trig, True)
    _, tl = _closers(tcfg, staged.jrig, staged.trig, True)
    jm, tm = staged.jm, staged.tm
    jl._maybe_train_vocab(jm)
    tl._maybe_train_vocab(tm)
    if route == "sparse":
        assert jl.vocab is not None and tl.vocab is not None
        for a, b in zip(tl.vocab.centers, jl.vocab.centers):
            np.testing.assert_array_equal(convert._np(a), _np(b))
        np.testing.assert_array_equal(convert._np(tl.vocab.idf),
                                      _np(jl.vocab.idf))
        np.testing.assert_array_equal(convert._np(tl.db.word),
                                      _np(jl.db.word))
        np.testing.assert_allclose(convert._np(tl.db.wt), _np(jl.db.wt),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_array_equal(convert._np(tl.db.valid),
                                      _np(jl.db.valid))
    else:
        assert tl.vocab is None and tl.db is None
    jcov, tcov = jms.covisibility_matrix(jm), tms.covisibility_matrix(tm)
    lists = []
    for slot in (3, 9, 10, SLOT):
        got = tl._candidates(tm, slot, tcov)
        assert got == jl._candidates(jm, slot, jcov), slot
        lists.append(got)
    # the revisit's query finds keyframe 0 first
    assert lists[-1][:1] == [CAND], lists
    if route == "sparse":
        np.testing.assert_array_equal(convert._np(tl.db.word),
                                      _np(jl.db.word))


@pytest.mark.parametrize("scores", ["dense", "sparse"])
def test_top3_ties_resolve_as_lax_top_k(scores):
    """The closers' top 3 among equal scores: `topk_stable` (the port's
    `_candidates` and `detect_merge`) picks the same slots in the same
    order as `jax.lax.top_k` (the reference's), lowest slot first, on
    64-slot rows whose best values repeat: the dense route's integer
    counts with excluded slots at -1, the sparse route's float32 scores
    with excluded slots at -1.0."""
    from openmavis_tpu_torch.frontend.fast import topk_stable

    rng = np.random.default_rng(14)
    for _ in range(50):
        if scores == "dense":
            row = rng.integers(0, 4, 64).astype(np.int32) * 300
        else:
            row = rng.choice(np.float32([0.0, 0.11, 0.125, 0.13]), 64)
        row[rng.random(64) < 0.3] = -1
        j_val, j_idx = jax.lax.top_k(jnp.asarray(row), 3)
        t_val, t_idx = topk_stable(torch.as_tensor(row), 3)
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(t_val.numpy(), np.asarray(j_val))


# ---------------------------------------------------------------------------
# one hypothesis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["inertial", "visual", "gate_refuses",
                                  "too_few_pairs"])
def test_solve_pair(staged, case):
    """`_solve_pair` given the reference's draws: the inlier mask and the
    gate decision exact, s, R, t to 1e-4. `gate_refuses`: a tilt gate no
    correction passes; `too_few_pairs`: keyframes with no shared
    landmarks (no RANSAC at all)."""
    inertial = case != "visual"
    cfg = jlc.LoopConfig(tilt_max=1e-7 if case == "gate_refuses" else 0.08)
    cand = 5 if case == "too_few_pairs" else CAND
    with Draws() as d:
        jl, _ = _closers(cfg, staged.jrig, staged.trig, inertial)
        jr = jl._solve_pair(staged.jm, SLOT, cand)
    _, tl = _closers(tlc.LoopConfig(**cfg.__dict__), staged.jrig,
                     staged.trig, inertial, draws=d.idx)
    tr = tl._solve_pair(staged.tm, SLOT, cand)
    assert len(d.idx) == (0 if case == "too_few_pairs" else 1)
    assert not tl.samples
    assert (tr is None) == (jr is None)
    assert (tr is None) == (case in ("gate_refuses", "too_few_pairs"))
    if tr is None:
        return
    np.testing.assert_array_equal(convert._np(tr.inlier), _np(jr.inlier))
    assert int(tr.n_inliers) == int(jr.n_inliers) >= 20
    for name in ("s", "R", "t"):
        np.testing.assert_allclose(convert._np(getattr(tr, name)),
                                   _np(getattr(jr, name)), atol=1e-4,
                                   rtol=0, err_msg=name)
    if inertial:
        assert float(tr.s) == 1.0


def test_unported_merge_and_default_device(staged, monkeypatch):
    """`detect_merge` (ROADMAP item 6, ported; its parity is in
    test_torch_merge.py) is taken: with no other map, or another map of
    fewer than two keyframes, it welds nothing and leaves the atlas; the
    closer builds on the card unless told the CPU, and raises without
    one."""
    _, tl = _closers(tlc.LoopConfig(), staged.jrig, staged.trig, True)
    atlas = tatlas.Atlas(maps=[staged.tm], current=0, device="cpu")
    assert tl.detect_merge(atlas, SLOT) is None
    atlas.create_map(K, C * F, M)
    atlas.current = 0
    assert tl.detect_merge(atlas, SLOT) is None
    assert atlas.n_maps() == 2 and tl.n_merges == 0 and tl.last_weld is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlc.LoopCloser(None, K)


def test_own_draws_without_samples(staged):
    """Without a samples queue the closer draws from its own generator:
    reproducible from the seed, and the revisit's pair still solves."""
    cfg = tlc.LoopConfig()
    runs = []
    for _ in range(2):
        tl = tlc.LoopCloser(None, K, cfg, seed=7, rig=staged.trig,
                            inertial=True, img_w=W, img_h=H, device="cpu")
        runs.append(tl._solve_pair(staged.tm, SLOT, CAND))
    assert runs[0] is not None
    assert torch.equal(runs[0].inlier, runs[1].inlier)
    assert torch.equal(runs[0].R, runs[1].R)


# ---------------------------------------------------------------------------
# on_keyframe over two keyframes: pending -> confirmed -> corrected
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[True, False],
                ids=["inertial", "visual"])
def two_keyframes(request, staged, tmp_path_factory):
    """Keyframe 11 verifies keyframe 0 and leaves a pending hypothesis;
    keyframe 12 (a second drifted revisit) confirms it, and the closer
    corrects the map (4-DoF graph + FullInertialBA over the chain, or
    Sim3 graph + visual GBA). Both packages from the same map, the port
    with the reference's draws; built once for all test workers
    (`test_torch_ref_cache.shared`)."""
    inertial = request.param
    return ref_cache.shared(
        tmp_path_factory, f"loop_closer_two_keyframes_{inertial}",
        lambda: _two_keyframes(staged, inertial))


def _two_keyframes(staged, inertial):
    m = second_revisit(staged.m_np)
    jkw = dict(chain=staged.jc.chain, chain_valid=staged.jc.chain_valid) \
        if inertial else {}
    tkw = dict(chain=staged.tc.chain, chain_valid=staged.tc.chain_valid) \
        if inertial else {}
    cfg = jlc.LoopConfig()
    out = dict(j=[], t=[])
    with Draws() as d:
        jl, _ = _closers(cfg, staged.jrig, staged.trig, inertial)
        jm = _jmap(m)
        for call, slot in enumerate((SLOT, 12)):
            if call == 1:
                jm = _arrive(np.asarray, jnp.asarray, jm)
            jm, closed = jl.on_keyframe(jm, slot, **jkw)
            out["j"].append((jm, closed, _snap_pending(jl.pending),
                             jl.n_loops))
    _, tl = _closers(tlc.LoopConfig(), staged.jrig, staged.trig, inertial,
                     draws=d.idx)
    tm = convert.map_from_numpy(m, device="cpu")
    launches = matcher_cuda.launch_count()
    for call, slot in enumerate((SLOT, 12)):
        if call == 1:
            tm = _arrive(convert._np, torch.as_tensor, tm)
        tm, closed = tl.on_keyframe(tm, slot, **tkw)
        out["t"].append((tm, closed, _snap_pending(tl.pending), tl.n_loops))
    # CPU tensors: the plain versions, no kernel
    assert matcher_cuda.launch_count() == launches
    out["draws"] = len(d.idx)
    out["left"] = len(tl.samples)
    return out


@pytest.mark.parametrize("call", [0, 1])
def test_on_keyframe_decisions(two_keyframes, call):
    """The pending hypothesis (slots and count exact, Sim3 1e-4), the
    verdict and `n_loops` equal at each keyframe; every draw used."""
    jm, jc, jp, jn = two_keyframes["j"][call]
    tm, tc, tp, tn = two_keyframes["t"][call]
    assert tc == jc and tn == jn
    _pending_close(tp, jp)
    if call == 0:
        assert not tc and tp["cand"] == CAND and tp["slot"] == SLOT \
            and tp["count"] == 1 and tn == 0
    else:
        assert tc and tp is None and tn == 1
    assert two_keyframes["left"] == 0 and two_keyframes["draws"] == 2


@pytest.mark.parametrize("call", [0, 1])
def test_on_keyframe_maps(two_keyframes, staged, call):
    """The map after each keyframe: integers exact, poses and landmarks
    to 1e-3 after the correction and the post-loop BA. The first call
    moves nothing; the second records the loop edge (0, 12) and moves
    keyframe 12 towards its undrifted pose."""
    jm = two_keyframes["j"][call][0]
    tm = two_keyframes["t"][call][0]
    _maps_close(tm, jm)
    if call == 0:
        np.testing.assert_array_equal(convert._np(tm.kf_t),
                                      second_revisit(staged.m_np)["kf_t"])
    else:
        assert int(tm.loop_i[0]) == CAND and int(tm.loop_j[0]) == 12
        true_t = staged.m_np["kf_t"][12]
        before = second_revisit(staged.m_np)["kf_t"][12]
        after = convert._np(tm.kf_t[12])
        assert np.linalg.norm(after - true_t) < np.linalg.norm(
            before - true_t)


def test_loop_closer_state_round_trip(staged):
    """`convert.loop_closer_state_{to,from}_numpy`: a pending hypothesis,
    the counters and the generator's seed carried between closers; a
    closer set from the reference's state confirms the hypothesis as the
    reference does."""
    m = second_revisit(staged.m_np)
    with Draws() as d:
        jl, _ = _closers(jlc.LoopConfig(), staged.jrig, staged.trig, True)
        jm, _ = jl.on_keyframe(_jmap(m), SLOT, chain=staged.jc.chain,
                               chain_valid=staged.jc.chain_valid)
    p = jl.pending
    d_ref = dict(vocab=None, db=None,
                 pending=dict(cand=p["cand"], slot=p["slot"],
                              count=p["count"], s=_np(p["s"]),
                              R=_np(p["R"]), t=_np(p["t"])),
                 n_loops=jl.n_loops, n_merges=jl.n_merges,
                 key=_np(jl.key))
    _, tl = _closers(tlc.LoopConfig(), staged.jrig, staged.trig, True)
    convert.loop_closer_state_from_numpy(d_ref, tl)
    back = convert.loop_closer_state_to_numpy(tl)
    np.testing.assert_array_equal(back["key"], d_ref["key"])
    for k in ("cand", "slot", "count"):
        assert back["pending"][k] == d_ref["pending"][k]
    for k in ("s", "R", "t"):
        np.testing.assert_array_equal(back["pending"][k],
                                      d_ref["pending"][k])
    assert back["n_loops"] == 0 and back["vocab"] is None
    # both confirm on keyframe 12
    with Draws() as d2:
        jm2, jc = jl.on_keyframe(_arrive(np.asarray, jnp.asarray, jm), 12,
                                 chain=staged.jc.chain,
                                 chain_valid=staged.jc.chain_valid)
    tl.samples.extend(d2.idx)
    tm = _arrive(convert._np, torch.as_tensor,
                 convert.map_from_numpy(_as_dict(jm), device="cpu"))
    tm2, tc = tl.on_keyframe(tm, 12, chain=staged.tc.chain,
                             chain_valid=staged.tc.chain_valid)
    assert tc and jc and tl.n_loops == jl.n_loops == 1
    _maps_close(tm2, jm2)


# ---------------------------------------------------------------------------
# the covisibility-edge cap
# ---------------------------------------------------------------------------

def _wide_map(m_np, k2=20):
    """The staged map with 20 keyframe slots, all valid (slots 12-19
    repeat keyframes 4-8 and 4-6), so that its covisibility can exceed
    the 128 edges the correction keeps."""
    big = _as_dict(jms.allocate(k2, C * F, M))
    src = list(range(12)) + [4, 5, 6, 7, 8, 4, 5, 6]
    for f, v in big.items():
        a = m_np[f]
        big[f] = (np.array(a[src]) if v.ndim and v.shape[0] == k2
                  and a.shape[0] == K else np.array(a))
    big["kf_valid"][:] = True
    big["n_kf"] = np.asarray(k2, np.int32)
    return big


class _Solved(Exception):
    """Raised by the spy once it has the edge set: the solve itself is
    held elsewhere."""


def test_correct_caps_covisibility_edges(capsys):
    """`_correct` with 171 covisibility pairs above the threshold, most
    weights tied: both packages hand the 4-DoF solve the same 128 edges
    (the highest, ties in index order) beside the 19 sequential edges and
    the loop edge, and say so alike."""
    m_np = _wide_map(tlcg.build_revisit()[0])
    rng = np.random.default_rng(5)
    cov = np.triu(rng.integers(30, 34, (20, 20)), 1).astype(np.int32)
    cov = cov + cov.T
    seen = {}

    def spy(name):
        def record(R, t, edges, fixed, valid, *a, **kw):
            seen[name] = [np.asarray(x) for x in (
                edges.i, edges.j, edges.valid, edges.weight, fixed)]
            raise _Solved
        return record

    jres = jsim3.Sim3Result(
        success=jnp.asarray(True), s=jnp.asarray(1.0), R=jnp.eye(3),
        t=jnp.asarray([0.01, 0.0, 0.0]), inlier=jnp.zeros(1, bool),
        n_inliers=jnp.asarray(0))
    tres = type("Res", (), dict(s=torch.tensor(1.0), R=torch.eye(3),
                                t=torch.tensor([0.01, 0.0, 0.0])))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpg, "optimize_pose_graph_4dof", spy("j"))
        mp.setattr(tpg, "optimize_pose_graph_4dof", spy("t"))
        jl = jlc.LoopCloser(None, 20, jlc.LoopConfig(run_gba=False),
                            inertial=True)
        with pytest.raises(_Solved):
            jl._correct(_jmap(m_np), 13, 2, jres, jnp.asarray(cov))
        out_j = capsys.readouterr().out
        tl = tlc.LoopCloser(None, 20, tlc.LoopConfig(run_gba=False),
                            inertial=True, device="cpu")
        with pytest.raises(_Solved):
            tl._correct(convert.map_from_numpy(m_np, device="cpu"), 13, 2,
                        tres, torch.as_tensor(cov))
        out_t = capsys.readouterr().out
    assert "kept top 128 of 171 by weight (43 dropped)" in out_j
    assert out_t == out_j
    for a, b in zip(seen["t"], seen["j"]):
        np.testing.assert_array_equal(a.astype(b.dtype), b)
    i, j = seen["t"][:2]
    assert len(i) == 19 + 128 + 1
    # the kept covisibility edges are the 128 heaviest, ties in index order
    ii, jj = np.nonzero(np.triu(cov, 2) >= 30)
    order = np.argsort(-cov[ii, jj], kind="stable")[:128]
    np.testing.assert_array_equal(i[19:147], ii[order])
    np.testing.assert_array_equal(j[19:147], jj[order])


# ---------------------------------------------------------------------------
# the four trackers' arms, stepped from the reference's state
# ---------------------------------------------------------------------------

def _carry_np(jc):
    """A reference VIStreamCarry / StreamCarry as the numpy dict `convert`
    reads."""
    return {k: ({kk: np.array(vv) for kk, vv in v._asdict().items()}
                if hasattr(v, "_asdict") else
                {kk: np.array(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.array(v))
            for k, v in jc._asdict().items()}


def _rel(m_R, m_t, ref, R, p):
    """The pose (R, p) relative to keyframe `ref` of the map's poses."""
    R_ref, t_ref = np.asarray(m_R)[ref], np.asarray(m_t)[ref]
    return R_ref.T @ np.asarray(R), R_ref.T @ (np.asarray(p) - t_ref)


def _arrive_12(tr, to_np, to_arr):
    tr.map = _arrive(to_np, to_arr, tr.map)


def test_streaming_vi_maybe_close_loop(staged):
    """`StreamingVITracker.maybe_close_loop` from the reference tracker's
    map and carry (`convert.streaming_state_from_numpy`): keyframe 11
    leaves a pending hypothesis, a repeated call on the same keyframe does
    nothing, keyframe 12 confirms it; the closer gets the carry's chain
    (FullInertialBA after the correction). The map to 1e-3; the live pose
    and velocity re-expressed through keyframe 11: its pose relative to
    that keyframe kept to 1e-5 and equal to the reference's to 1e-5."""
    m = second_revisit(staged.m_np)
    noise = jpre.ImuNoise.from_sigmas(1.7e-4, 2e-3, 1.9e-5, 3e-3, 400.0)
    with Draws() as d:
        jl = jlc.LoopCloser(None, K, rig=staged.jrig, inertial=True,
                            img_w=W, img_h=H)
        jt = jsv.StreamingVITracker(staged.jrig, staged.jcfg, noise,
                                    loop_closer=jl)
        jt.map, jt.carry = _jmap(m), staged.jc
        j_out = [jt.maybe_close_loop(), jt.maybe_close_loop()]
        j_slot, j_pending = jt._last_lc_slot, _snap_pending(jl.pending)
        _arrive_12(jt, np.asarray, jnp.asarray)
        jt._snap = None
        j_out.append(jt.maybe_close_loop())
    tl = tlc.LoopCloser(None, K, rig=staged.trig, inertial=True, img_w=W,
                        img_h=H, device="cpu", samples=d.idx)
    tt = tsv.StreamingVITracker(
        staged.trig, staged.tcfg, convert.noise_from_numpy(
            {k: np.asarray(v) for k, v in noise._asdict().items()},
            device="cpu"), device="cpu", loop_closer=tl)
    convert.streaming_state_from_numpy(
        dict(map=m, carry=_carry_np(staged.jc), _last_lc_slot=-1,
             _t_prev=None), tt)
    c0, m0 = tt.carry, tt.map
    t_out = [tt.maybe_close_loop(), tt.maybe_close_loop()]
    assert tt._last_lc_slot == j_slot == SLOT
    _pending_close(tl.pending, j_pending)
    _arrive_12(tt, convert._np, torch.as_tensor)
    t_out.append(tt.maybe_close_loop())
    assert t_out == j_out == [False, False, True]
    assert tt._last_lc_slot == jt._last_lc_slot == 12
    assert tl.n_loops == jl.n_loops == 1 and not tl.samples
    _maps_close(tt.map, jt.map)
    for name in ("R", "p", "v"):
        np.testing.assert_allclose(convert._np(getattr(tt.carry, name)),
                                   _np(getattr(jt.carry, name)), atol=1e-3,
                                   rtol=0, err_msg=name)
    rel_before = _rel(convert._np(m0.kf_R), convert._np(m0.kf_t), SLOT,
                      convert._np(c0.R), convert._np(c0.p))
    rel_t = _rel(convert._np(tt.map.kf_R), convert._np(tt.map.kf_t), SLOT,
                 convert._np(tt.carry.R), convert._np(tt.carry.p))
    rel_j = _rel(jt.map.kf_R, jt.map.kf_t, SLOT, jt.carry.R, jt.carry.p)
    for a, b, c in zip(rel_t, rel_before, rel_j):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        np.testing.assert_allclose(a, c, atol=1e-5, rtol=0)
    back = convert.streaming_state_to_numpy(tt)
    assert back["_last_lc_slot"] == 12 and back["_t_prev"] is None


def _jax_multi_arm(jt, slot):
    """The reference `MultiTracker`'s loop-closer arm (the lines of its
    `_insert_keyframe` after the VIBA schedule), on its state."""
    lc_kw = {}
    if jt.imu_initialized:
        pre_b, cvalid = jt._kf_pre_batch(jt.cfg.max_kf)
        ident = jpre.init_preintegrated(jt.bias)
        chain = jax.tree.map(lambda i, p: jnp.concatenate([i[None], p]),
                             ident, pre_b)
        lc_kw = dict(chain=chain, chain_valid=jnp.concatenate(
            [jnp.zeros((1,), bool), cvalid]))
    jt.map, closed = jt.loop_closer.on_keyframe(jt.map, slot, **lc_kw)
    return closed


def test_multi_tracker_loop_closer_arm(staged):
    """`MultiTracker._close_loop` with the IMU initialized, from the
    reference tracker's state (`convert.multi_tracker_state_from_numpy`):
    the closer gets the stored preintegration chain; keyframe 11 pends,
    keyframe 12 closes; the map to 1e-3."""
    m = second_revisit(staged.m_np)
    chain = staged.jc.chain
    kf_pre = [None] + [jax.tree.map(lambda x: x[k], chain)
                       for k in range(1, SLOT + 1)]
    kw = dict(img_w=int(W), img_h=int(H), n_cams=C, max_kf=K, max_mp=M)
    with Draws() as d:
        jl = jlc.LoopCloser(None, K, rig=staged.jrig, inertial=True,
                            img_w=W, img_h=H)
        jt = jmt.MultiTracker(staged.jrig, jmt.MultiTrackerConfig(
            orb=jex.OrbConfig(n_features=F, n_levels=3), **kw),
            loop_closer=jl)
        jt.map, jt.kf_pre, jt.imu_initialized = _jmap(m), kf_pre, True
        jt.n_kf, jt.last_kf_slot, jt.state = SLOT + 1, SLOT, jt.OK
        state = mt_ref_state(jt)
        j_out = [_jax_multi_arm(jt, SLOT)]
        _arrive_12(jt, np.asarray, jnp.asarray)
        j_out.append(_jax_multi_arm(jt, 12))
    tl = tlc.LoopCloser(None, K, rig=staged.trig, inertial=True, img_w=W,
                        img_h=H, device="cpu", samples=d.idx)
    tt = tmt.MultiTracker(staged.trig, tmt.MultiTrackerConfig(
        orb=tex.OrbConfig(n_features=F, n_levels=3), **kw), device="cpu",
        loop_closer=tl)
    convert.multi_tracker_state_from_numpy(state, tt)
    t_out = [tt._close_loop(SLOT)]
    _arrive_12(tt, convert._np, torch.as_tensor)
    t_out.append(tt._close_loop(12))
    assert t_out == j_out == [False, True]
    assert tl.n_loops == jl.n_loops == 1 and not tl.samples
    _maps_close(tt.map, jt.map)
