"""The device loop closer's carry (`LCCarry`) across a slab recycle, in
both packages on the CPU.

The staged revisit of test_torch_loop_closing.py (`build_revisit`: two
cameras x 64 features, keyframes 0-3 map a set of points, 4-8 another,
9-11 come back to the first under a drift) cut to a full slab of its 12
keyframes. The reference's own loop step on keyframe 11 (`temporal=2`)
verifies keyframe 0 and leaves the hypothesis pending: cand 0, pend_slot
11, count 1, last_slot 11. From there, in each case, both packages'
`recycle` compacts the slab (the reference's closure of its step, called
alone; the port's `VIStep.recycle`), keyframe 12 of `second_revisit` (a
second drifted revisit) is inserted with `map_state.insert_keyframe`, and
one loop step runs:

* "one": decimation frees slot 3 alone, so the new keyframe lands on slot
  11, the old `last_slot`. The reference's step skips it (slot ==
  last_slot) and changes nothing. The port's carry follows the keyframes
  (cand 0, pend_slot 10, last_slot 10) and its step confirms the pending
  hypothesis and corrects.
* "several": keyframes 2, 5 and 7 were culled before; the new keyframe
  lands on slot 9. The reference's stale pend_slot 11 is above every slot
  of a 12-slot slab, so its hypothesis never becomes pending again: it
  solves afresh and leaves a new one pending. The port confirms.
* "cand_gone": keyframes 0, 5 and 7 culled, the pending hypothesis's
  candidate among them: the port drops the hypothesis (cand = pend_slot =
  -1); the reference's stale cand 0 names old keyframe 1. Both solve
  afresh and end alike.
* "cooldown": the carry just after a correction (cooldown 10, one
  amortized GBA step left, nothing pending); decimation frees one slot.
  The reference skips the keyframe: no GBA step, the cooldown not counted
  down. The port runs the GBA step and counts down.

Held on both sides (ROADMAP Queue 3: a fault of the reference, repaired in
the port): the reference's carry keeps its old slot indices; the port's
`streaming_lc.remap_slots` moves `last_slot`, `cand`, `pend_slot` and
`merge_last` through the compaction (-1 where the keyframe went) and leaves
every other field as the reference's. The maps after the recycle and the
insert are exactly equal. The port's step from its carry equals the
reference's step from that same carry: integers, bools and the telemetry
exactly, poses and the Sim3 to 1e-3 (float32 solves summed in another
order), the port given the reference's RANSAC draws.
`StreamingVITracker.push` hands the closer the remapped carry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.optim.reprojection import RigParams as JRig
from openmavis_tpu.pipeline import loop_closing as jlc
from openmavis_tpu.pipeline import streaming_lc as jslc
from openmavis_tpu.pipeline import streaming_vi as jsv
from openmavis_tpu.slam_map import map_state as jms
from openmavis_tpu_torch import convert, scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.imu import preintegration as tpre
from openmavis_tpu_torch.pipeline import streaming_lc as tslc
from openmavis_tpu_torch.pipeline import streaming_vi as tsv
from openmavis_tpu_torch.slam_map import map_state as tms
import test_torch_ref_cache as ref_cache
from test_torch_loop_closing import (C, F, M, H, W, Staged, _as_dict,
                                     build_revisit, second_revisit)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread per test
    worker keeps the files of the suite from oversubscribing the machine
    when they run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = 12                        # the slab: keyframes 0-11 of the revisit
NEW = 12                      # the revisit's keyframe that arrives
LC_KW = dict(score_min=10, temporal=2, recent_exclude=2, gba_steps=1)
# keyframes culled before the recycle (none: the slab is all valid, and
# decimation frees slot 3)
CULLED = dict(one=(), several=(2, 5, 7), cand_gone=(0, 5, 7), cooldown=())
CASES = tuple(CULLED)
SLOT_FIELDS = ("last_slot", "cand", "pend_slot", "merge_last")
LC_INTS = ("last_slot", "cand", "pend_slot", "count", "n_loops", "cooldown",
           "gba_left", "merged", "merge_last", "n_merges", "kf_off")
LC_FLOATS = ("s", "R", "t", "max_tilt", "dbg")


def _full_slab():
    """The revisit's map (14 slots, keyframes 0-11) and chain cut to K
    slots, and keyframe NEW of the second revisit, all numpy."""
    m14, carry, rig_np = build_revisit(C)
    m = {k: np.array(v) for k, v in
         convert.map_to_numpy(tms.allocate(K, C * F, M, device="cpu")).items()}
    for k, v in m14.items():
        m[k] = np.array(v[:K] if k.startswith("kf_") else v, m[k].dtype)
    assert m["kf_valid"].all() and int(m["n_kf"]) == K
    new = {k[3:]: np.array(v[NEW]) for k, v in second_revisit(m14).items()
           if k.startswith("kf_")}
    chain = {k: v[:K] for k, v in carry["chain"].items()}
    return m, dict(chain=chain, chain_valid=carry["chain_valid"][:K]), new, \
        rig_np


def _inner(fn, name):
    """The function `name` that `fn` reaches through its closures (the
    reference's step keeps `recycle` inside `_make_step_inner`)."""
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
            v = cell.cell_contents
            if callable(v):
                todo.append(v)
    raise LookupError(name)


@jax.jit
def _jax_draws(key, jm, slot, cand, jrig):
    nn = jlc._pairs_from_tables(jlc._tables(jm), jlc._tables(jm), slot, cand)
    pr = jlc.pairs_by_projection(jm, slot, cand, jrig.kind, C, jrig, W, H)
    valid = jnp.concatenate([nn.valid, pr.valid])
    k1 = jax.random.split(key)[1]
    return jax.random.categorical(
        k1, jnp.where(valid, 0.0, -1e9)[None, None], shape=(128, 3))


def _jax_samples(key, jm, slot, cand, jrig):
    """The RANSAC samples the reference's step draws for keyframe `slot`
    against `cand` when its carry holds `key`."""
    return torch.as_tensor(np.array(_jax_draws(key, jm, slot, cand,
                                               jrig))).to(torch.int64)


def _jmap(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _j_lcc(tl):
    return jslc.LCCarry(**{k: jnp.asarray(v) for k, v in
                           convert.lc_carry_to_numpy(tl).items()})


def _build():
    m_np, carry_np, new, rig_np = _full_slab()
    jrig = JRig(rig_np["kind"], *(jnp.asarray(rig_np[k]) for k in
                                  ("params", "R_cb", "t_cb")))
    trig = convert.rig_from_numpy(rig_np, device="cpu")
    kw = scene.bench_config_kwargs(16, max_kf=K, max_mp=M)
    kw.update(img_w=int(W), img_h=int(H), n_cams=C, obs_cap=2048)
    jcfg = jsv.VIStreamConfig(orb=jex.OrbConfig(n_features=F, n_levels=3),
                              **kw)
    tcfg = tsv.VIStreamConfig(orb=tex.OrbConfig(n_features=F, n_levels=3),
                              **kw)
    jm0 = _jmap(m_np)
    jc0 = jsv.init_carry(jcfg, seed=5)
    jc0 = jc0._replace(
        R=jm0.kf_R[K - 1], p=jm0.kf_t[K - 1], v=jm0.kf_v[K - 1],
        imu_ok=jnp.asarray(True), mode=jnp.asarray(2, jnp.int32),
        last_kf_slot=jnp.asarray(K - 1, jnp.int32),
        chain=jc0.chain._replace(**{k: jnp.asarray(v) for k, v in
                                    carry_np["chain"].items()}),
        chain_valid=jnp.asarray(carry_np["chain_valid"]))
    jstep = jslc.make_lc_step(jcfg, jrig.kind, C, True, W, H, **LC_KW)
    tstep = tslc.make_lc_step(tcfg, trig.kind, C, True, W, H, **LC_KW)
    # the reference's step on keyframe 11 leaves the hypothesis pending
    _, jc0, pending = jstep(jm0, jc0, jslc.init_lc_carry(), jrig)
    j_recycle = jax.jit(_inner(jsv._make_step_inner(jcfg, rig_np["kind"],
                                                    False), "recycle"))
    vi = tsv.VIStep(tcfg, trig, tpre.ImuNoise.from_sigmas(
        *scene.NOISE_SIGMAS, device="cpu"))
    out = dict(pending=convert.lc_carry_from_numpy(_as_dict(pending),
                                                   device="cpu"))
    for case in CASES:
        lcc0 = pending
        if case == "cooldown":
            lcc0 = pending._replace(
                cand=jnp.asarray(-1, jnp.int32),
                pend_slot=jnp.asarray(-1, jnp.int32),
                count=jnp.asarray(0, jnp.int32),
                n_loops=jnp.asarray(1, jnp.int32),
                cooldown=jnp.asarray(10, jnp.int32),
                gba_left=jnp.asarray(1, jnp.int32))
        d = {k: v.copy() for k, v in m_np.items()}
        d["kf_valid"][list(CULLED[case])] = False
        jm, tm = _jmap(d), convert.map_from_numpy(d, device="cpu")
        tc = Staged.port_carry(jc0)
        # the recycle
        jm, jc = j_recycle(jm, jc0)
        tm, tc = vi.recycle(tm, tc)
        tl = tslc.remap_slots(
            convert.lc_carry_from_numpy(_as_dict(lcc0), device="cpu"),
            vi.slot_map)
        rec = dict(slot_map=vi.slot_map.clone(), recycled=(jm, tm),
                   lcc0=convert.lc_carry_from_numpy(_as_dict(lcc0),
                                                    device="cpu"),
                   remapped=tl, time_before=m_np["kf_time"].copy())
        # the new keyframe
        slot = int(tm.n_kf)
        args = [new[k] for k in ("R", "t", "v", "bg", "ba", "time", "xy",
                                 "desc", "level", "sigma2", "cam",
                                 "feat_valid", "obs")]
        jm = jms.insert_keyframe(jm, slot, *(jnp.asarray(a) for a in args))
        tm = tms.insert_keyframe(tm, slot, *(torch.as_tensor(a)
                                             for a in args))
        jc = jc._replace(last_kf_slot=jnp.asarray(slot, jnp.int32),
                         R=jm.kf_R[slot], p=jm.kf_t[slot], v=jm.kf_v[slot])
        tc = tc._replace(last_kf_slot=torch.tensor(slot, dtype=torch.int32),
                         R=tm.kf_R[slot], p=tm.kf_t[slot], v=tm.kf_v[slot])
        rec["inserted"] = (jm, tm)
        # the loop step: the reference from its own (stale) carry and from
        # the port's; the port from its own with the reference's draws
        rec["stale"] = jstep(jm, jc, lcc0, jrig)
        rec["ref"] = jstep(jm, jc, _j_lcc(tl), jrig)
        solve = tstep.solve_candidate

        def with_draws(m_, gen, slot_, cand, rig, sample_idx=None):
            return solve(m_, gen, slot_, cand, rig, _jax_samples(
                jc.key, jm, slot_, cand, jrig))

        tstep.solve_candidate = with_draws
        try:
            rec["port"] = tstep(tm, tc, tl, trig)
        finally:
            del tstep.solve_candidate
        rec["events"] = tstep.events
        rec["slot"] = slot
        out[case] = rec
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages through each case, built once for all test workers
    (`test_torch_ref_cache.shared`)."""
    return ref_cache.shared(tmp_path_factory, "lc_recycle_runs", _build)


def _ints(lcc):
    return {k: int(np.asarray(convert._np(v) if isinstance(v, torch.Tensor)
                              else v)) for k, v in lcc._asdict().items()
            if k in LC_INTS}


def test_pending_before_the_recycle(runs):
    """The starting carry: keyframe 11 verified keyframe 0 and waits."""
    assert {k: v for k, v in _ints(runs["pending"]).items()
            if k in ("last_slot", "cand", "pend_slot", "count", "n_loops")} \
        == dict(last_slot=K - 1, cand=0, pend_slot=K - 1, count=1,
                n_loops=0)


@pytest.mark.parametrize("case", CASES)
def test_maps_equal_through_recycle_and_insert(runs, case):
    """The two recycles and the insert: every map field exactly equal,
    dtypes included; the slot map drops the culled (or decimated)
    keyframes."""
    rec = runs[case]
    for stage in ("recycled", "inserted"):
        jm, tm = rec[stage]
        for name in jm._fields:
            a, b = convert._np(getattr(tm, name)), np.asarray(getattr(jm,
                                                                      name))
            assert a.dtype == b.dtype, (stage, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{stage}.{name}")
    gone = np.flatnonzero(convert._np(rec["slot_map"]) < 0).tolist()
    assert gone == (sorted(CULLED[case]) or [3])
    assert rec["slot"] == K - len(gone)


@pytest.mark.parametrize("case", CASES)
def test_remap_follows_the_keyframes(runs, case):
    """The port's carry after the recycle: each slot field names the same
    keyframe (by its timestamp) as before, or -1 where it went (a pending
    hypothesis with either keyframe); every other field as it was, that
    is, as the reference's (which keeps every field)."""
    rec = runs[case]
    before, after = _ints(rec["lcc0"]), _ints(rec["remapped"])
    smap = convert._np(rec["slot_map"])
    jm, _ = rec["recycled"]
    t_new, t_old = np.asarray(jm.kf_time), rec["time_before"]
    pair_gone = any(before[k] < 0 or smap[before[k]] < 0
                    for k in ("cand", "pend_slot"))
    for k in SLOT_FIELDS:
        if before[k] < 0 or smap[before[k]] < 0 or (
                pair_gone and k in ("cand", "pend_slot")):
            assert after[k] == -1, k
        else:
            assert t_new[after[k]] == t_old[before[k]], k
    assert pair_gone == (case in ("cand_gone", "cooldown"))
    for k in LC_INTS:
        if k not in SLOT_FIELDS:
            assert after[k] == before[k], k
    for k in LC_FLOATS:
        np.testing.assert_array_equal(convert._np(getattr(rec["remapped"], k)),
                                      convert._np(getattr(rec["lcc0"], k)),
                                      err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_reference_keeps_stale_slots(runs, case):
    """The reference: its carry names the old slots after the recycle.
    Where the compaction freed one slot, the new keyframe sits on the old
    last_slot and its step changes nothing: no attempt, no GBA step, the
    cooldown not counted down, the map as it was. Elsewhere it solves
    afresh, its stale pending hypothesis never pending again."""
    rec = runs[case]
    jm, jc, jl = rec["stale"]
    before, after = _ints(rec["lcc0"]), _ints(jl)
    jm_in, _ = rec["inserted"]
    if case in ("one", "cooldown"):
        assert rec["slot"] == before["last_slot"] == K - 1
        assert after == before
        np.testing.assert_array_equal(np.asarray(jl.dbg),
                                      convert._np(rec["lcc0"].dbg))
        for name in jm._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                          np.asarray(getattr(jm_in, name)),
                                          err_msg=name)
    else:
        # a fresh attempt, verified, left pending on the new slot
        assert after["last_slot"] == rec["slot"] < before["pend_slot"]
        assert float(jl.dbg[2]) == float(rec["lcc0"].dbg[2]) + 1
        assert after["count"] == 1 and after["n_loops"] == 0
        assert after["pend_slot"] == rec["slot"]
    if case == "cand_gone":
        # what the stale cand 0 named: the first survivor, old keyframe 1
        assert float(jm_in.kf_time[0]) == rec["time_before"][1]


def _port_and_ref(rec):
    return rec["port"], rec["ref"]


@pytest.mark.parametrize("case", CASES)
def test_port_step_equals_reference_from_remapped_carry(runs, case):
    """The port's step from its remapped carry against the reference's
    step from the same carry: every integer and bool of LCCarry, the map's
    integers and loop edges and the telemetry exactly."""
    (tm, tc, tl), (jm, jc, jl) = _port_and_ref(runs[case])
    assert _ints(tl) == _ints(jl)
    np.testing.assert_array_equal(convert._np(tl.dbg), np.asarray(jl.dbg))
    for name in ("loop_i", "loop_j", "loop_valid", "n_loop", "kf_obs",
                 "kf_valid", "mp_valid", "n_kf"):
        np.testing.assert_array_equal(convert._np(getattr(tm, name)),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_port_step_poses(runs, case):
    """The same two steps: keyframe poses, landmarks, the live pose and
    the pending Sim3 to 1e-3."""
    (tm, tc, tl), (jm, jc, jl) = _port_and_ref(runs[case])
    for a, b, names in ((tm, jm, ("kf_R", "kf_t", "kf_v", "mp_pos")),
                        (tc, jc, ("R", "p", "v")),
                        (tl, jl, ("s", "R", "t", "max_tilt"))):
        for name in names:
            np.testing.assert_allclose(convert._np(getattr(a, name)),
                                       np.asarray(getattr(b, name)),
                                       atol=1e-3, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_port_processes_the_new_keyframe(runs, case):
    """What the port's closer does with the keyframe after the recycle:
    the pending hypothesis confirmed and corrected ("one", "several"), a
    fresh attempt ("cand_gone"), the GBA step with the cooldown counted
    down ("cooldown")."""
    rec = runs[case]
    _, _, tl = rec["port"]
    got = _ints(tl)
    assert got["last_slot"] == rec["slot"]
    if case in ("one", "several"):
        assert rec["events"] == ("attempt", "correction")
        assert got["n_loops"] == 1 and got["cand"] == got["pend_slot"] == -1
        assert got["cooldown"] == 10 and got["gba_left"] == 1
        tm, _, _ = rec["port"]
        assert int(tm.loop_i[0]) == 0 and int(tm.loop_j[0]) == rec["slot"]
    elif case == "cand_gone":
        assert rec["events"] == ("attempt",)
        assert got["count"] == 1 and got["pend_slot"] == rec["slot"]
        # the same fresh attempt as the reference's from its stale carry
        assert got == _ints(rec["stale"][2])
    else:
        assert rec["events"] == ("gba_step",)
        assert got["cooldown"] == 9 and got["gba_left"] == 0


def test_push_hands_the_closer_the_remapped_carry(monkeypatch):
    """`StreamingVITracker.push`: after a step that recycled, the merge
    and loop steps get the carry moved through the step's `slot_map`;
    after one that did not, the carry as it was."""
    from test_torch_loop_closing import _small_tracker

    _, tr = _small_tracker(device_lc=True)
    seen = []
    lcc = tr.lc_carry._replace(
        last_slot=torch.tensor(7, dtype=torch.int32),
        cand=torch.tensor(2, dtype=torch.int32),
        pend_slot=torch.tensor(7, dtype=torch.int32),
        merge_last=torch.tensor(7, dtype=torch.int32))
    tr.lc_carry = lcc
    slot_map = torch.tensor([0, 1, -1, 2, 3, 4, 5, 6], dtype=torch.int32)

    def step(m, c, *args):
        tr._step.slot_map = slot_map if not seen else None
        return m, c

    def lc_step(m, c, lcc_, rig):
        seen.append(lcc_)
        return m, c, lcc_

    lc_step.events = ()

    monkeypatch.setattr(tr._step, "step", step)
    monkeypatch.setattr(tr, "_lc_step", lc_step)
    images = np.zeros((4, 120, 160), np.float32)
    tr.push(images, 0.0)
    got = {k: int(getattr(seen[0], k)) for k in SLOT_FIELDS}
    assert got == dict(last_slot=6, cand=-1, pend_slot=-1, merge_last=6)
    tr.push(images, 0.05)
    assert seen[1] is seen[0]
