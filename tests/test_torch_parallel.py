"""Parity of the port's `parallel/` (the sharded bundle adjustments, the
sharded place scores, the multi-process runtime) and of the trackers'
`run_global_ba(mesh=)` with the JAX package on the CPU.

The reference runs on a 2-device sub-mesh of conftest's 8 virtual CPU
devices, the partition of a two-rank group; its outputs are computed once
per test run (`test_torch_ref_cache.shared`). The port runs each call on
the two ranks of an in-process gloo group, one thread per rank, and both
ranks' results must be bit-equal.

The problems: tests/test_dist_ba.py's `make_problem` (keys 0-3) and the
staged revisit of tests/test_torch_loop_closing.py (14 keyframe slots, 2
cameras x 64 features, 512 landmarks; inertial and visual), passed to the
port as numpy.

Tolerances, stated at each test: the observation buckets, inlier masks,
place scores and map bindings exact; the solvers at
test_torch_optim.py's `_ba_compare` (R, t, bg 1e-4; v, ba, points 1e-3;
chi2 rtol 1e-3); the whole-map step at test_global_ba_step's (poses and
points 1e-4, chi2 rtol 1e-3).
"""

import json
import os
import subprocess
import sys
import threading
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from openmavis_tpu.imu import preintegration as jpre
from openmavis_tpu.optim import ba as jba
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu.parallel import dist_ba as jdist
from openmavis_tpu.parallel import dist_place as jplace
from openmavis_tpu.pipeline import tracking as jtrk
from openmavis_tpu.slam_map import map_state as jms
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.imu import preintegration as tpre
from openmavis_tpu_torch.optim import ba as tba
from openmavis_tpu_torch.optim.reprojection import RigParams as TRig
from openmavis_tpu_torch.parallel import dist_ba as tdist
from openmavis_tpu_torch.parallel import dist_place as tplace
from openmavis_tpu_torch.parallel import multihost
from openmavis_tpu_torch.pipeline import streaming_vi as tsv
from openmavis_tpu_torch.pipeline import system as tsystem
from openmavis_tpu_torch.pipeline import tracking as ttrk
from test_dist_ba import make_problem, mono_rig
import test_torch_ref_cache as ref_cache
from test_torch_loop_closing import SLOT, build_revisit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2                       # ranks, and devices of the reference's mesh
STEP_KW = dict(stages=(1,), cg_iters=8, obs_cap=1500)
# name: (make_problem key, K, M, solver, keyword arguments). The window
# BA runs at test_torch_optim.py's depth, stages (3, 4): at the reference
# test's 5 + 10 the plain `bundle_adjust` of the two packages already part
# by up to 2.8e-3 on points of these problems (float32 normal equations
# summed in another order, amplified by the poorly observed depths).
SOLVES = {
    "window_uneven": (1, 5, 101, "window", dict(stages=(3, 4))),
    "global": (0, 6, 200, "global", dict(stages=(4, 6), cg_iters=24)),
    "lsharded": (2, 6, 160, "lsharded", dict(stages=(4, 6), cg_iters=24)),
    "lsharded_uneven": (3, 5, 101, "lsharded", dict(stages=(3,))),
}
J_SOLVERS = {"window": jdist.distributed_bundle_adjust,
             "global": jdist.distributed_global_ba,
             "lsharded": jdist.distributed_global_ba_lsharded}
T_SOLVERS = {"window": tdist.distributed_bundle_adjust,
             "global": tdist.distributed_global_ba,
             "lsharded": tdist.distributed_global_ba_lsharded}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x)


def _problem_np(key, K, M):
    """make_problem's arrays as numpy (jitted: one compile a shape)."""
    state0, obs, fixed, *_ = jax.jit(make_problem, static_argnums=(1, 2))(
        jax.random.PRNGKey(key), K, M)
    return ({k: _np(v) for k, v in state0._asdict().items()},
            {k: _np(v) for k, v in obs._asdict().items()}, _np(fixed))


def _jstate(p):
    s, o, f = p
    return (jba.BAState(**{k: jnp.asarray(v) for k, v in s.items()}),
            jba.BAObservations(**{k: jnp.asarray(v) for k, v in o.items()}),
            jnp.asarray(f))


def _tstate(p):
    s, o, f = p
    return (tba.BAState(**{k: torch.as_tensor(np.array(v))
                           for k, v in s.items()}),
            tba.BAObservations(**{k: torch.as_tensor(np.array(v))
                                  for k, v in o.items()}),
            torch.as_tensor(np.array(f)))


def _trig():
    r = mono_rig()
    return TRig(r.kind, *(torch.as_tensor(np.array(x))
                          for x in (r.params, r.R_cb, r.t_cb)))


def _place_inputs():
    """test_dist_ba.py's place-recognition bank, made with numpy: K=16
    keyframes of 64 random descriptors, the query keyframe 5's with 2% of
    its bits flipped; one keyframe and some features invalid."""
    rng = np.random.default_rng(0)
    K, F = 16, 64
    desc = (rng.random((K, F, 256)) < 0.5).astype(np.int8)
    q = np.abs(desc[5] - (rng.random((F, 256)) < 0.02)).astype(np.int8)
    fv = np.ones((K, F), bool)
    fv[3, 40:] = False
    kv = np.ones(K, bool)
    kv[9] = False
    return dict(kf_desc=desc, kf_feat_valid=fv, kf_valid=kv, q_desc=q,
                q_valid=np.arange(F) % 7 != 3)


def _build_reference():
    """Every JAX reference output, as numpy."""
    jmesh = jdist.make_mesh(jax.devices()[:N])
    out = {"problems": {}, "solves": {}}
    for name, (key, K, M, solver, kw) in SOLVES.items():
        p = _problem_np(key, K, M)
        out["problems"][name] = p
        state, obs, fixed = _jstate(p)
        st, inl, chi = J_SOLVERS[solver](jmesh, state, obs, mono_rig(),
                                         fixed, **kw)
        out["solves"][name] = (tuple(map(_np, st)), _np(inl), _np(chi))
    out["buckets"] = {}
    for name, M in (("even", 160), ("uneven", 102)):
        p = out["problems"]["lsharded" if name == "even"
                            else "lsharded_uneven"]
        obs_b, perm = jdist.shard_observations_by_landmark(
            _jstate(p)[1], M, N)
        out["buckets"][name] = ({k: _np(v) for k, v in
                                 obs_b._asdict().items()}, perm)
    pl = _place_inputs()
    out["place"] = pl
    out["place_scores"] = _np(jplace.sharded_place_scores(
        jdist.make_mesh(jax.devices()[:N], axis="kf"),
        *(jnp.asarray(pl[k]) for k in ("kf_desc", "kf_feat_valid",
                                       "kf_valid", "q_desc", "q_valid"))))
    m_np, carry_np, rig_np = build_revisit()
    out["staged"] = dict(m=m_np, rig=rig_np, **carry_np)
    jm = jms.MapState(**{k: jnp.asarray(v) for k, v in m_np.items()})
    jrig = JRig(rig_np["kind"], *(jnp.asarray(rig_np[k]) for k in
                                  ("params", "R_cb", "t_cb")))
    out["steps"] = {}
    for inertial in (True, False):
        kw = (dict(pre_b=jpre.Preintegrated(**{
                       k: jnp.asarray(v[1:])
                       for k, v in carry_np["chain"].items()}),
                   edge_valid=jnp.asarray(carry_np["chain_valid"][1:]))
              if inertial else {})
        m2, chi = jtrk.distributed_global_ba_step(
            jm, jrig.kind, jrig, jmesh, **kw, **STEP_KW)
        out["steps"][inertial] = ({k: _np(v) for k, v in
                                   m2._asdict().items()}, _np(chi))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return ref_cache.shared(tmp_path_factory, "torch_parallel_ref",
                            _build_reference)


def on_two_ranks(fn):
    """fn(mesh) on both ranks of an in-process gloo group, one thread a
    rank; returns [rank 0's result, rank 1's]."""
    store = dist.HashStore()
    out, errors = [None] * N, []

    def run(rank):
        try:
            group = dist.ProcessGroupGloo(store, rank, N,
                                          timedelta(seconds=60))
            out[rank] = fn(tdist.make_mesh(group))
        except BaseException as e:      # re-raised in the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def _bit_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
        return
    for x, y in zip(a, b):
        _bit_equal(x, y)


def _ba_compare(out_t, out_j):
    st, inl_t, chi_t = out_t
    sj, inl_j, chi_j = out_j
    for name, a, b, tol in zip(tba.BAState._fields, st, sj,
                               (1e-4, 1e-4, 1e-3, 1e-4, 1e-3, 1e-3)):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol,
                                   err_msg=name)
    np.testing.assert_array_equal(inl_t.numpy(), inl_j)
    np.testing.assert_allclose(float(chi_t), float(chi_j), rtol=1e-3)


@pytest.mark.parametrize("name", ["even", "uneven"])
def test_shard_observations_by_landmark(ref, name):
    """The buckets, the owner-local landmark ids and `perm` exactly, with
    M even (160) and padded from 101 to 102."""
    p = ref["problems"]["lsharded" if name == "even" else "lsharded_uneven"]
    obs_b, perm = tdist.shard_observations_by_landmark(
        _tstate(p)[1], 160 if name == "even" else 102, N)
    j_obs, j_perm = ref["buckets"][name]
    np.testing.assert_array_equal(perm, j_perm)
    for k, v in obs_b._asdict().items():
        np.testing.assert_array_equal(v.numpy(), j_obs[k], err_msg=k)
    assert obs_b.kf.dtype == torch.int32 and obs_b.valid.dtype == torch.bool


@pytest.mark.parametrize("name", list(SOLVES))
def test_distributed_solvers(ref, name):
    """The window BA, the replicated and the landmark-sharded whole-map
    BA (O not divisible by the ranks, M padded): `_ba_compare`'s
    tolerances, inliers exact, both ranks bit-equal."""
    key, K, M, solver, kw = SOLVES[name]
    p = ref["problems"][name]

    def run(mesh):
        state, obs, fixed = _tstate(p)
        return T_SOLVERS[solver](mesh, state, obs, _trig(), fixed, **kw)

    r0, r1 = on_two_ranks(run)
    _bit_equal(r0, r1)
    assert r0[0].points.shape[0] == M and r0[1].shape[0] == K * M
    _ba_compare(r0, ref["solves"][name])


def test_sharded_place_scores(ref):
    """Exact integer scores (a keyframe and some features invalid), the
    query's own keyframe the best, both ranks equal."""
    pl = ref["place"]
    r0, r1 = on_two_ranks(lambda mesh: tplace.sharded_place_scores(
        mesh, *(torch.as_tensor(pl[k]) for k in (
            "kf_desc", "kf_feat_valid", "kf_valid", "q_desc", "q_valid"))))
    assert torch.equal(r0, r1) and r0.dtype == torch.int32
    np.testing.assert_array_equal(r0.numpy(), ref["place_scores"])
    assert int(torch.argmax(r0)) == 5 and int(r0[9]) == 0
    with pytest.raises(ValueError, match="multiple of 3"):
        tplace.sharded_place_scores(
            tdist.Mesh(None, 3, 0), *(torch.as_tensor(pl[k]) for k in (
                "kf_desc", "kf_feat_valid", "kf_valid", "q_desc",
                "q_valid")))


def _staged_port(ref):
    """(map, preintegration chain [K] (entry k: keyframe k-1 -> k), its
    validity, rig) of the staged revisit in the port."""
    s = ref["staged"]
    return (convert.map_from_numpy(s["m"], device="cpu"),
            tpre.Preintegrated(**{k: torch.as_tensor(v)
                                  for k, v in s["chain"].items()}),
            torch.as_tensor(s["chain_valid"]),
            convert.rig_from_numpy(s["rig"], device="cpu"))


def _maps_close(tm, jm_np, what):
    for name in ("kf_R", "kf_t", "kf_v", "kf_bg", "kf_ba", "mp_pos"):
        np.testing.assert_allclose(convert._np(getattr(tm, name)),
                                   jm_np[name], atol=1e-4, rtol=0,
                                   err_msg=f"{what} {name}")
    np.testing.assert_array_equal(convert._np(tm.kf_obs), jm_np["kf_obs"])


@pytest.mark.parametrize("inertial", [True, False])
def test_distributed_global_ba_step(ref, inertial):
    """The product path's whole-map step on the staged revisit (one
    reduced iteration, as test_global_ba_step): poses and points 1e-4,
    chi2 rtol 1e-3, the bindings exact, both ranks bit-equal; the solve
    moved the map."""
    tm, chain, chain_valid, trig = _staged_port(ref)
    kw = (dict(pre_b=chain.map(lambda x: x[1:]),
               edge_valid=chain_valid[1:]) if inertial else {})
    r0, r1 = on_two_ranks(lambda mesh: ttrk.distributed_global_ba_step(
        tm, trig.kind, trig, mesh, **kw, **STEP_KW))
    _bit_equal(r0, r1)
    m_j, chi_j = ref["steps"][inertial]
    assert np.isfinite(float(r0[1]))
    np.testing.assert_allclose(float(r0[1]), float(chi_j), rtol=1e-3)
    _maps_close(r0[0], m_j, "step")
    assert np.abs(convert._np(r0[0].kf_t)
                  - ref["staged"]["m"]["kf_t"]).max() > 1e-4


def test_distributed_global_ba_step_starts_from_rank0s_map(ref):
    """Ranks whose maps and chains part (rank 1's keyframes and landmarks
    moved, a binding dropped, its chain's dP shifted) both solve from
    mesh rank 0's: bit-equal results within test_global_ba_step's
    tolerances of the reference's step on the staged map."""
    tm, chain, chain_valid, trig = _staged_port(ref)
    i, j = (int(x[0]) for x in torch.nonzero(tm.kf_obs >= 0)[:1].T)
    bad_obs = tm.kf_obs.clone()
    bad_obs[i, j] = -1
    bad = tm._replace(kf_t=tm.kf_t + 0.05, mp_pos=tm.mp_pos - 0.1,
                      kf_obs=bad_obs)
    bad_chain = chain._replace(dP=chain.dP + 0.01)

    def run(mesh):
        m, c = (tm, chain) if mesh.rank == 0 else (bad, bad_chain)
        return ttrk.distributed_global_ba_step(
            m, trig.kind, trig, mesh, pre_b=c.map(lambda x: x[1:]),
            edge_valid=chain_valid[1:], **STEP_KW)

    r0, r1 = on_two_ranks(run)
    _bit_equal(r0, r1)
    m_j, chi_j = ref["steps"][True]
    np.testing.assert_allclose(float(r0[1]), float(chi_j), rtol=1e-3)
    _maps_close(r0[0], m_j, "rank 0's map")


def _same_solve(a, b, what):
    """mesh=1 against the mesh-less solve from the same state: the same
    solve with the observations in bucket order (sums in another order)."""
    for name in ("kf_R", "kf_t", "kf_v", "kf_bg", "kf_ba", "mp_pos"):
        np.testing.assert_allclose(convert._np(getattr(a, name)),
                                   convert._np(getattr(b, name)), atol=1e-4,
                                   rtol=0, err_msg=f"{what} {name}")
    assert torch.equal(a.kf_obs, b.kf_obs)


def test_streaming_run_global_ba_mesh(ref):
    """`StreamingVITracker.run_global_ba(mesh=1)` (a one-rank gloo group)
    against `run_global_ba()` from the same staged state: the map as
    `_same_solve`, chi2 rtol 1e-3, the live pose and velocity 1e-4; a
    list of ranks is the same mesh; mesh=2 in a one-rank world raises."""
    tm, chain, chain_valid, trig = _staged_port(ref)
    m_np, rig_np = ref["staged"]["m"], ref["staged"]["rig"]
    kw = scene.bench_config_kwargs(16, max_kf=14, max_mp=512)
    kw.update(img_w=320, img_h=240, n_cams=2, obs_cap=2048)
    cfg = tsv.VIStreamConfig(orb=tex.OrbConfig(n_features=64, n_levels=3),
                             **kw)
    tt = tsv.StreamingVITracker(trig, cfg, device="cpu")
    # the tracker after keyframe SLOT, IMU initialized, as the staged
    # revisit of tests/test_torch_loop_closing.py sets it
    tc = tsv.init_carry(cfg, seed=5, device="cpu")._replace(
        R=tm.kf_R[SLOT], p=tm.kf_t[SLOT], v=tm.kf_v[SLOT],
        imu_ok=torch.tensor(True), mode=torch.tensor(2, dtype=torch.int32),
        last_kf_slot=torch.tensor(SLOT, dtype=torch.int32), chain=chain,
        chain_valid=chain_valid)
    assert tt.map.kf_obs.shape == (14, 128) and m_np["kf_obs"].shape == (
        14, 128) and rig_np["params"].shape[0] == 2
    outs = {}
    for mesh in (None, 1, [0]):
        tt.map, tt.carry, tt._snap = tm, tc, None
        chi = tt.run_global_ba(mesh=mesh)
        assert chi.dim() == 0 and torch.isfinite(chi)
        outs[str(mesh)] = (tt.map, tt.carry, float(chi))
    base = outs["None"]
    for key in ("1", "[0]"):
        m, c, chi = outs[key]
        _same_solve(m, base[0], key)
        assert chi == pytest.approx(base[2], rel=1e-3)
        for f in ("R", "p", "v"):
            np.testing.assert_allclose(convert._np(getattr(c, f)),
                                       convert._np(getattr(base[1], f)),
                                       atol=1e-4, rtol=0, err_msg=f)
    _bit_equal(outs["1"][0], outs["[0]"][0])
    assert tdist.resolve_mesh(1, "cpu") is tdist.resolve_mesh([0], "cpu")
    assert np.abs(convert._np(base[0].kf_t) - m_np["kf_t"]).max() > 1e-4
    tt.map, tt.carry = tm, tc
    with pytest.raises(ValueError, match="world of size 1"):
        tt.run_global_ba(mesh=2)
    assert tt.map is tm and tt.carry is tc


def test_system_run_global_ba_mesh(ref):
    """`System(IMU_MULTI).run_global_ba(mesh=1)` with the IMU initialized
    (the `MultiTracker`'s `_kf_pre_batch` chain, FullInertialBA) against
    `run_global_ba()` from the same staged state, the Atlas synced after
    both; mesh=2 in a one-rank world raises."""
    tm, chain, _, trig = _staged_port(ref)
    rig_np = ref["staged"]["rig"]
    settings = scene.system_settings(rig_np, 64, 3, w=320, h=240)
    slam = tsystem.System(settings, tsystem.Sensor.IMU_MULTI, device="cpu",
                          tracker_overrides=dict(max_kf=14, max_mp=512))
    tr = slam.tracker
    assert tr.map.kf_obs.shape == tm.kf_obs.shape
    tr.rig = trig
    tr.imu_initialized = True
    tr.kf_pre = [None] + [chain.map(lambda x, k=k: x[k])
                          for k in range(1, 12)]
    outs = {}
    for mesh in (None, 1):
        tr.map = tm
        outs[mesh] = (slam.run_global_ba(mesh=mesh), tr.map)
        assert tr.atlas.maps[tr.map_id] is tr.map
    assert np.isfinite(outs[1][0])
    assert outs[1][0] == pytest.approx(outs[None][0], rel=1e-3)
    _same_solve(outs[1][1], outs[None][1], "system")
    assert np.abs(convert._np(outs[None][1].kf_v)
                  - ref["staged"]["m"]["kf_v"]).max() > 1e-6
    with pytest.raises(ValueError, match="world of size 1"):
        slam.run_global_ba(mesh=2)


def test_host_local_to_global():
    """Each rank's own rows (3 and 5 of them; float, bool and int64
    fields in a NamedTuple and a dict) become the whole table on both
    ranks, exactly; without a world the counts are one process."""
    rng = np.random.default_rng(4)
    rows = [3, 5]
    data = [dict(uv=rng.normal(size=(n, 2)).astype(np.float32),
                 valid=rng.random(n) < 0.5,
                 kf=rng.integers(-9, 2**31 - 1, n)) for n in rows]

    def run(mesh):
        mine = {k: torch.as_tensor(v) for k, v in data[mesh.rank].items()}
        return (multihost.host_local_to_global(mesh, mine),
                multihost.host_local_to_global(
                    mesh, tba.BAObservations(
                        kf=mine["kf"], mp=mine["kf"], cam=mine["kf"],
                        uv=mine["uv"], sigma2=mine["uv"][:, 0],
                        valid=mine["valid"])))

    r0, r1 = on_two_ranks(run)
    for d in (r0[0], r1[0]):
        for k in ("uv", "valid", "kf"):
            whole = np.concatenate([data[0][k], data[1][k]])
            assert d[k].dtype == torch.as_tensor(whole).dtype
            np.testing.assert_array_equal(d[k].numpy(), whole)
    _bit_equal(r0[1], r1[1])
    assert isinstance(r0[1], tba.BAObservations)
    np.testing.assert_array_equal(r0[1].uv.numpy(), r0[0]["uv"].numpy())
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    with pytest.raises(RuntimeError, match="no process group"):
        multihost.global_mesh()


def test_dryrun_problem_matches_the_reference_script():
    """scripts/dryrun_multihost_torch.py builds scripts/dryrun_multihost.py's
    problem: the same arrays, rebuilt here as that script builds them."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import dryrun_multihost_torch as drt
    finally:
        sys.path.pop(0)
    state, t_gt, obs, rig, fixed = drt.build_problem("dryrun")
    K, M, O = 32, 4096, 8192
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, K, endpoint=False)
    pos = np.stack([6 * np.cos(t), 6 * np.sin(t), np.zeros(K)], -1)
    pts = rng.uniform(-8, 8, (M, 3)).astype(np.float32)
    pts[:, 2] += 12.0
    kf_i = rng.integers(0, K, O)
    mp_i = rng.integers(0, M, O)
    z3 = jnp.zeros((K, 3))
    st = jba.BAState(R=jnp.tile(jnp.eye(3), (K, 1, 1)),
                     t=jnp.asarray(pos, jnp.float32), v=z3, bg=z3, ba=z3,
                     points=jnp.asarray(pts))
    params = jnp.asarray([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0])
    p_c = jnp.einsum("oij,oj->oi", jnp.swapaxes(st.R[kf_i], -1, -2),
                     st.points[mp_i] - st.t[kf_i])
    z = jnp.maximum(p_c[:, 2], 1e-3)
    uv = params[:2] * p_c[:, :2] / z[:, None] + params[2:4]
    uv = uv + 0.2 * jnp.asarray(rng.normal(size=(O, 2)), jnp.float32)
    t_p = st.t + 0.05 * jnp.asarray(rng.normal(size=(K, 3)), jnp.float32)
    pts_p = st.points + 0.05 * jnp.asarray(rng.normal(size=(M, 3)),
                                           jnp.float32)
    for a, b in ((obs["kf"], kf_i), (obs["mp"], mp_i), (obs["uv"], uv),
                 (obs["valid"], z > 0.1), (state["t"], t_p),
                 (state["points"], pts_p), (t_gt, st.t),
                 (rig["params"][0], params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert fixed.sum() == 1 and fixed[0]


def test_dryrun_script_two_processes():
    """The script's two processes join one gloo group on the CPU, assemble
    the table with `host_local_to_global` and solve over both ranks; the
    result agrees with the one-rank solve (as tests/test_multihost.py holds
    the reference's script)."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "dryrun_multihost_torch.py"),
         "--device", "cpu", "--timeout", "240"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads([ln for ln in out.stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert res["processes"] == 2 and res["devices"] == ["cpu", "cpu"]
    assert res["ranks_bit_equal"] and res["assembled_equal"]
    assert res["ok"], res
    assert res["cross_vs_local_t_m"] < 1e-3, res
