"""Carry state between the JAX reference package and the port.

The JAX side is given as dicts of numpy arrays keyed by field name (for a
NamedTuple `x`: `{k: np.asarray(v) for k, v in x._asdict().items()}`;
nested NamedTuples as nested dicts; the host-policy trackers'
attributes as `multi_tracker_state_to_numpy` and `tracker_state_to_numpy`
lay them out, the streaming trackers' host state as
`streaming_state_to_numpy`, the loop closer's as
`loop_closer_state_to_numpy`, an Atlas as `atlas_to_numpy`).
`*_from_numpy` builds the port's
tensors on a given device (the current CUDA device when none is given)
and `*_to_numpy` goes back. Every field takes
the dtype the port allocates it with: int32 indices, int8 descriptor
planes and bool masks never drift to torch's default int64.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .imu import preintegration as pre_mod
from .optim.reprojection import RigParams
from .frontend import extractor
from .pipeline import loop_closing as lc_mod
from .pipeline import multi_tracking as mt
from .pipeline import streaming as stm
from .pipeline import streaming_lc as slc
from .pipeline import streaming_vi as svi
from .pipeline import tracking as trk
from .pipeline.streaming import TrajRing
from .slam_map import atlas as atlas_mod
from .slam_map import keyframe_db as kdb
from .slam_map import map_state as ms
from .slam_map import vocabulary as voc

_MAP_DTYPES = {f: t.dtype for f, t in
               zip(ms.MapState._fields,
                   ms.allocate(1, 1, 1, device="cpu"))}
_PRE_DTYPES = {f: torch.float32 for f in pre_mod.Preintegrated._fields}
_TRAJ_DTYPES = dict(time=torch.float32, ref=torch.int32,
                    R_rel=torch.float32, t_rel=torch.float32,
                    ok=torch.bool, idx=torch.int32)
_BANK_DTYPES = dict(xy=torch.float32, desc=torch.int8, level=torch.int32,
                    sigma2=torch.float32, cam=torch.int32, valid=torch.bool)
_CARRY_SCALARS = dict(
    R=torch.float32, p=torch.float32, v=torch.float32, bg=torch.float32,
    ba=torch.float32, vel_R=torch.float32, vel_t=torch.float32,
    mode=torch.int32, imu_ok=torch.bool, viba_stage=torch.int32,
    first_kf_time=torch.float32, last_kf_time=torch.float32,
    last_time=torch.float32, has_last=torch.bool,
    last_kf_slot=torch.int32, ref_kf_inliers=torch.int32,
    lost_frames=torch.int32, boost=torch.int32, chain_valid=torch.bool,
    ref_time=torch.float32)


_LC_DTYPES = {f: t.dtype for f, t in
              zip(slc.LCCarry._fields, slc.init_lc_carry(device="cpu"))}


def _t(x, dtype, device) -> torch.Tensor:
    # np.array copies: arrays handed over from jax are read-only
    return torch.as_tensor(np.array(x)).to(device=device, dtype=dtype)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _fields_from(d: dict, dtypes: dict, device) -> dict:
    device = resolve_device(device)
    missing = set(dtypes) - set(d)
    if missing:
        raise KeyError(f"missing fields: {sorted(missing)}")
    return {k: _t(d[k], dt, device) for k, dt in dtypes.items()}


def rig_from_numpy(d: dict, device=None) -> RigParams:
    device = resolve_device(device)
    return RigParams(int(d["kind"]), _t(d["params"], torch.float32, device),
                     _t(d["R_cb"], torch.float32, device),
                     _t(d["t_cb"], torch.float32, device))


def rig_to_numpy(rig: RigParams) -> dict:
    return dict(kind=rig.kind, params=_np(rig.params), R_cb=_np(rig.R_cb),
                t_cb=_np(rig.t_cb))


def dist_from_numpy(dist, device=None) -> torch.Tensor:
    """Radtan coefficients [C, 4] (k1, k2, p1, p2) as float32."""
    return _t(dist, torch.float32, resolve_device(device))


def noise_from_numpy(d: dict, device=None) -> pre_mod.ImuNoise:
    device = resolve_device(device)
    return pre_mod.ImuNoise(_t(d["nga"], torch.float32, device),
                            _t(d["nga_walk"], torch.float32, device))


def noise_to_numpy(noise: pre_mod.ImuNoise) -> dict:
    return dict(nga=_np(noise.nga), nga_walk=_np(noise.nga_walk))


def pre_from_numpy(d: dict, device=None) -> pre_mod.Preintegrated:
    return pre_mod.Preintegrated(**_fields_from(d, _PRE_DTYPES, device))


def pre_to_numpy(pre: pre_mod.Preintegrated) -> dict:
    return {k: _np(v) for k, v in pre._asdict().items()}


def map_from_numpy(d: dict, device=None) -> ms.MapState:
    return ms.MapState(**_fields_from(d, _MAP_DTYPES, device))


def map_to_numpy(m: ms.MapState) -> dict:
    return {k: _np(v) for k, v in m._asdict().items()}


def atlas_to_numpy(atlas: atlas_mod.Atlas) -> dict:
    """maps (a list of map dicts) and current (the tracked map's index)."""
    return dict(maps=[map_to_numpy(m) for m in atlas.maps],
                current=int(atlas.current))


def atlas_from_numpy(d: dict, device=None) -> atlas_mod.Atlas:
    device = resolve_device(device)
    return atlas_mod.Atlas(maps=[map_from_numpy(m, device)
                                 for m in d["maps"]],
                           current=int(d["current"]), device=device)


def _seed_from_key(gen: torch.Generator, key) -> torch.Generator:
    """Seed `gen` from a JAX PRNG key [2] uint32 as (key[0] << 32) |
    key[1] (so PRNGKey(s) seeds s); the two streams differ by
    construction."""
    key = np.asarray(key).astype(np.uint64)
    gen.manual_seed(int((key[0] << np.uint64(32)) | key[1]))
    return gen


def _key_of(gen: torch.Generator) -> np.ndarray:
    seed = gen.initial_seed()
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def carry_from_numpy(d: dict, device=None) -> svi.VIStreamCarry:
    """JAX VIStreamCarry dict -> port carry; the PRNG key seeds the port's
    torch.Generator (`_seed_from_key`)."""
    device = resolve_device(device)
    gen = _seed_from_key(torch.Generator(device=device), d["key"])
    f = _fields_from(d, _CARRY_SCALARS, device)
    return svi.VIStreamCarry(
        gen=gen, pre_acc=pre_from_numpy(d["pre_acc"], device),
        chain=pre_from_numpy(d["chain"], device),
        ref_bank=_fields_from(d["ref_bank"], _BANK_DTYPES, device),
        traj=TrajRing(**_fields_from(d["traj"], _TRAJ_DTYPES, device)),
        **f)


def carry_to_numpy(c: svi.VIStreamCarry) -> dict:
    out = {k: _np(getattr(c, k)) for k in _CARRY_SCALARS}
    out["key"] = _key_of(c.gen)
    out["pre_acc"] = pre_to_numpy(c.pre_acc)
    out["chain"] = pre_to_numpy(c.chain)
    out["ref_bank"] = {k: _np(v) for k, v in c.ref_bank.items()}
    out["traj"] = {k: _np(v) for k, v in c.traj._asdict().items()}
    return out


def lc_carry_from_numpy(d: dict, device=None) -> slc.LCCarry:
    return slc.LCCarry(**_fields_from(d, _LC_DTYPES, device))


def lc_carry_to_numpy(lcc: slc.LCCarry) -> dict:
    return {k: _np(v) for k, v in lcc._asdict().items()}


# MultiTracker attributes carried as host values, and those on the device
_MT_HOST = ("state", "n_kf", "last_kf_slot", "last_kf_time", "last_time",
            "first_kf_time", "ref_kf_inliers", "viba_stage",
            "imu_initialized", "_reentry_boost", "lost_frames",
            "_init_time", "map_id")
_MT_TENSORS = ("R", "t", "v", "bias", "vel_R", "vel_t")


def _pre_list_to_numpy(pres) -> list:
    return [None if p is None else pre_to_numpy(p) for p in pres]


def _pre_list_from_numpy(pres, device) -> list:
    return [None if p is None else pre_from_numpy(p, device) for p in pres]


def _imu_queue(q) -> list:
    return [(np.array(w, np.float32), np.array(a, np.float32), float(t))
            for (w, a, t) in q]


def multi_tracker_state_to_numpy(tr: mt.MultiTracker) -> dict:
    """A port `MultiTracker`'s state as host values: the map as a numpy
    dict, the pose, velocity, bias and motion model as numpy arrays, the
    counters and times as Python values, `kf_pre` as a list of numpy
    dicts or None, `_parked_pre` (the parked maps' chains: a dict by map
    index of such lists), the two IMU queues, the trajectory list, the
    two-view reference bank (numpy dict or None) and `key`, the
    generator's seed as a [2] uint32 PRNG key (see `carry_from_numpy`)."""
    d = {k: getattr(tr, k) for k in _MT_HOST}
    d.update({k: _np(getattr(tr, k)) for k in _MT_TENSORS})
    d["map"] = map_to_numpy(tr.map)
    d["kf_pre"] = _pre_list_to_numpy(tr.kf_pre)
    d["_parked_pre"] = {mid: _pre_list_to_numpy(pres)
                        for mid, pres in tr._parked_pre.items()}
    d["_imu_frame"] = _imu_queue(tr._imu_frame)
    d["_imu_kf"] = _imu_queue(tr._imu_kf)
    d["trajectory"] = [(tm, mid, ref, np.array(R), np.array(t))
                       for (tm, mid, ref, R, t) in tr.trajectory]
    d["_init_bank"] = (None if tr._init_bank is None else
                       {k: _np(v) for k, v in tr._init_bank.items()})
    d["key"] = _key_of(tr.gen)
    return d


def multi_tracker_state_from_numpy(d: dict, tr: mt.MultiTracker) -> None:
    """Set the state `d` (laid out as `multi_tracker_state_to_numpy` does;
    from the reference package: its `MultiTracker`'s attributes of the
    same names as numpy) on the port tracker `tr`, on `tr.device`. The
    PRNG key, where given, seeds `tr.gen` as `carry_from_numpy` does;
    `_parked_pre`, where given, replaces the parked chains. The map
    replaces the atlas's entry `map_id` too when `tr` has an atlas."""
    dev = tr.device
    for k in _MT_HOST:
        setattr(tr, k, d[k])
    for k in _MT_TENSORS:
        setattr(tr, k, _t(d[k], torch.float32, dev))
    tr.map = map_from_numpy(d["map"], dev)
    tr._sync_atlas()
    tr.kf_pre = _pre_list_from_numpy(d["kf_pre"], dev)
    if "_parked_pre" in d:
        tr._parked_pre = {int(mid): _pre_list_from_numpy(pres, dev)
                          for mid, pres in d["_parked_pre"].items()}
    tr._imu_frame = _imu_queue(d["_imu_frame"])
    tr._imu_kf = _imu_queue(d["_imu_kf"])
    tr.trajectory = [(float(tm), int(mid), int(ref),
                      np.array(R, np.float32), np.array(t, np.float32))
                     for (tm, mid, ref, R, t) in d["trajectory"]]
    tr._init_bank = (None if d["_init_bank"] is None else
                     _fields_from(d["_init_bank"], _BANK_DTYPES, dev))
    if "key" in d:
        _seed_from_key(tr.gen, d["key"])


# the streaming one-camera tracker's carry
_STREAM_SCALARS = dict(
    R=torch.float32, t=torch.float32, vel_R=torch.float32,
    vel_t=torch.float32, mode=torch.int32, last_kf_slot=torch.int32,
    ref_kf_inliers=torch.int32, lost_frames=torch.int32,
    ref_time=torch.float32)
_FEAT_DTYPES = dict(xy=torch.float32, response=torch.float32,
                    angle=torch.float32, level=torch.int32,
                    sigma2=torch.float32, desc=torch.int8, valid=torch.bool)


def features_from_numpy(d: dict, device=None) -> extractor.Features:
    return extractor.Features(**_fields_from(d, _FEAT_DTYPES, device))


def features_to_numpy(f: extractor.Features) -> dict:
    return {k: _np(v) for k, v in f._asdict().items()}


def stream_carry_from_numpy(d: dict, device=None) -> stm.StreamCarry:
    """JAX `streaming.StreamCarry` dict -> port carry; the PRNG key seeds
    the port's torch.Generator (`_seed_from_key`)."""
    device = resolve_device(device)
    return stm.StreamCarry(
        gen=_seed_from_key(torch.Generator(device=device), d["key"]),
        ref_feats=features_from_numpy(d["ref_feats"], device),
        traj=TrajRing(**_fields_from(d["traj"], _TRAJ_DTYPES, device)),
        **_fields_from(d, _STREAM_SCALARS, device))


def stream_carry_to_numpy(c: stm.StreamCarry) -> dict:
    out = {k: _np(getattr(c, k)) for k in _STREAM_SCALARS}
    out["key"] = _key_of(c.gen)
    out["ref_feats"] = features_to_numpy(c.ref_feats)
    out["traj"] = {k: _np(v) for k, v in c.traj._asdict().items()}
    return out


# Tracker attributes carried as host values, and those on the device
_TR_HOST = ("state", "n_kf", "last_kf_slot", "ref_kf_inliers",
            "lost_frames", "map_id", "_init_time")
_TR_TENSORS = ("R", "t", "R_prev", "t_prev", "vel_R", "vel_t")


def tracker_state_to_numpy(tr: trk.Tracker) -> dict:
    """A port `Tracker`'s state as host values: the map as a numpy dict,
    the pose, the previous pose and the motion model as numpy arrays, the
    counters as Python values, the init reference frame's features
    (`_init_feats`, a numpy dict or None), the trajectory list and `key`,
    the generator's seed as a [2] uint32 PRNG key."""
    d = {k: getattr(tr, k) for k in _TR_HOST}
    d.update({k: _np(getattr(tr, k)) for k in _TR_TENSORS})
    d["map"] = map_to_numpy(tr.map)
    d["_init_feats"] = (None if tr._init_feats is None
                        else features_to_numpy(tr._init_feats))
    d["trajectory"] = [(tm, mid, ref, np.array(R), np.array(t))
                       for (tm, mid, ref, R, t) in tr.trajectory]
    d["key"] = _key_of(tr.gen)
    return d


def tracker_state_from_numpy(d: dict, tr: trk.Tracker) -> None:
    """Set the state `d` (laid out as `tracker_state_to_numpy` does; from
    the reference package: its `Tracker`'s attributes of the same names as
    numpy) on the port tracker `tr`, on `tr.device`. The PRNG key, where
    given, seeds `tr.gen`. The map replaces the atlas's entry `map_id`
    too when `tr` has an atlas."""
    dev = tr.device
    for k in _TR_HOST:
        setattr(tr, k, d[k])
    for k in _TR_TENSORS:
        setattr(tr, k, _t(d[k], torch.float32, dev))
    tr.map = map_from_numpy(d["map"], dev)
    tr._sync_atlas()
    tr._init_feats = (None if d["_init_feats"] is None
                      else features_from_numpy(d["_init_feats"], dev))
    tr.trajectory = [(float(tm), int(mid), int(ref),
                      np.array(R, np.float32), np.array(t, np.float32))
                     for (tm, mid, ref, R, t) in d["trajectory"]]
    if "key" in d:
        _seed_from_key(tr.gen, d["key"])


# the host-policy loop closer: vocabulary, word-sparse database, the
# pending hypothesis and the counters

def vocabulary_to_numpy(vocab: voc.Vocabulary) -> dict:
    """centers (a list of [k^(l+1), 256] int8), idf [n_words] f32, k."""
    return dict(centers=[_np(c) for c in vocab.centers], idf=_np(vocab.idf),
                k=int(vocab.k))


def vocabulary_from_numpy(d: dict, device=None) -> voc.Vocabulary:
    device = resolve_device(device)
    return voc.Vocabulary(
        centers=tuple(_t(c, torch.int8, device) for c in d["centers"]),
        idf=_t(d["idf"], torch.float32, device), k=int(d["k"]))


_SPARSE_DB_DTYPES = dict(word=torch.int32, wt=torch.float32,
                         valid=torch.bool)


def sparse_kfdb_to_numpy(db: kdb.SparseKeyframeDB) -> dict:
    return {k: _np(v) for k, v in db._asdict().items()}


def sparse_kfdb_from_numpy(d: dict, device=None) -> kdb.SparseKeyframeDB:
    return kdb.SparseKeyframeDB(**_fields_from(d, _SPARSE_DB_DTYPES, device))


def loop_closer_state_to_numpy(lc: lc_mod.LoopCloser) -> dict:
    """A `LoopCloser`'s state as host values: `vocab` and `db` (numpy
    dicts, or None before the session vocabulary is trained), `pending`
    (None, or cand / slot / count as ints and s / R / t as numpy),
    `n_loops`, `n_merges`, and `key`, the generator's seed as a [2]
    uint32 PRNG key (see `carry_from_numpy`)."""
    p = lc.pending
    return dict(
        vocab=None if lc.vocab is None else vocabulary_to_numpy(lc.vocab),
        db=None if lc.db is None else sparse_kfdb_to_numpy(lc.db),
        pending=None if p is None else dict(
            cand=int(p["cand"]), slot=int(p["slot"]), count=int(p["count"]),
            s=_np(p["s"]), R=_np(p["R"]), t=_np(p["t"])),
        n_loops=int(lc.n_loops), n_merges=int(lc.n_merges),
        key=_key_of(lc.gen))


def loop_closer_state_from_numpy(d: dict, lc: lc_mod.LoopCloser) -> None:
    """Set the state `d` (laid out as `loop_closer_state_to_numpy` does;
    from the reference package: its `LoopCloser`'s attributes of the same
    names as numpy, `key` its PRNG key) on the port closer `lc`, on
    `lc.device`."""
    dev = lc.device
    lc.vocab = (None if d["vocab"] is None
                else vocabulary_from_numpy(d["vocab"], dev))
    lc.db = None if d["db"] is None else sparse_kfdb_from_numpy(d["db"], dev)
    p = d["pending"]
    lc.pending = None if p is None else dict(
        cand=int(p["cand"]), slot=int(p["slot"]), count=int(p["count"]),
        **{k: _t(p[k], torch.float32, dev) for k in ("s", "R", "t")})
    lc.n_loops = int(d["n_loops"])
    lc.n_merges = int(d["n_merges"])
    if "key" in d:
        _seed_from_key(lc.gen, d["key"])


def streaming_state_to_numpy(tr) -> dict:
    """A streaming tracker's host-side state (`StreamingVITracker` or
    `streaming.StreamingTracker`): the map, the carry, `_last_lc_slot`
    (the newest keyframe `maybe_close_loop` handled) and, for the VI
    tracker, `_t_prev` (the last frame's time)."""
    vi = isinstance(tr, svi.StreamingVITracker)
    d = dict(map=map_to_numpy(tr.map),
             carry=(carry_to_numpy if vi else stream_carry_to_numpy)(
                 tr.carry),
             _last_lc_slot=int(tr._last_lc_slot))
    if vi:
        d["_t_prev"] = tr._t_prev
    return d


def streaming_state_from_numpy(d: dict, tr) -> None:
    """Set `d` (laid out as `streaming_state_to_numpy` does; from the
    reference package: its tracker's `map`, `carry`, `_last_lc_slot` and
    `_t_prev` as numpy) on the port's streaming tracker `tr`."""
    dev = tr.device
    vi = isinstance(tr, svi.StreamingVITracker)
    tr.map = map_from_numpy(d["map"], dev)
    tr.carry = (carry_from_numpy if vi else stream_carry_from_numpy)(
        d["carry"], dev)
    tr._last_lc_slot = int(d["_last_lc_slot"])
    if vi:
        tr._t_prev = d["_t_prev"]
    tr._snap = None
