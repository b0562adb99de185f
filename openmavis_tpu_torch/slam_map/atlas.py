"""Atlas: the multi-map container, map spawning and merging (port of
`openmavis_tpu/slam_map/atlas.py`; reference: src/Atlas.cc, CreateNewMap
on tracking loss Atlas.h:57, maps re-joined by merge detection
LoopClosing::MergeLocal / MergeLocal2, src/LoopClosing.cc:1381, 1956).

Maps are fixed-capacity `MapState` slabs. A merge moves the younger map
through a verified Sim3 and appends its keyframes and landmarks into the
older map's free slots, with the observation ids re-indexed: one batched
scatter, no pointer surgery. `merge_maps` is the host form (it reads the
counts); `merge_maps_device` reads nothing back to the host, for the
streaming step.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .. import resolve_device
from ..geometry import lie
from . import map_state as ms


@dataclass
class Atlas:
    """The maps of a session and the index of the one being tracked.
    `device`: where `create_map` allocates (the current CUDA device when
    None, resolved at the first allocation)."""
    maps: list = field(default_factory=list)   # list[ms.MapState]
    current: int = -1
    device: object = None

    def create_map(self, max_kf, max_feat, max_mp) -> int:
        """CreateNewMap: a fresh map becomes the current one. Returns its
        index."""
        self.device = resolve_device(self.device)
        self.maps.append(ms.allocate(max_kf, max_feat, max_mp,
                                     device=self.device))
        self.current = len(self.maps) - 1
        return self.current

    @property
    def current_map(self) -> ms.MapState:
        return self.maps[self.current]

    @current_map.setter
    def current_map(self, m):
        self.maps[self.current] = m

    def n_maps(self):
        return len(self.maps)

    def open(self, max_kf, max_feat, max_mp, device):
        """The map a tracker on `device` starts on: the current one, or a
        fresh one when the atlas is empty (allocated on `device` unless the
        atlas names its own). Returns (map, index)."""
        if self.device is None:
            self.device = device
        if not self.maps:
            self.create_map(max_kf, max_feat, max_mp)
        return self.current_map, self.current


def transform_map(m: ms.MapState, s, R, t) -> ms.MapState:
    """Apply a world-frame Sim3 (x -> s R x + t) to every pose, velocity
    and landmark."""
    return m._replace(
        kf_R=lie.normalize_rotation(R @ m.kf_R),
        kf_t=s * (m.kf_t @ R.T) + t,
        kf_v=s * (m.kf_v @ R.T),
        mp_pos=s * (m.mp_pos @ R.T) + t)


# the fields a weld copies row for row from the moved source map (the
# observation table, the landmarks' scale range and keyframe ids are
# re-indexed or scaled on the way)
_KF_FIELDS = ("kf_R", "kf_t", "kf_v", "kf_bg", "kf_ba", "kf_time",
              "kf_valid", "kf_xy", "kf_desc", "kf_level", "kf_sigma2",
              "kf_cam", "kf_feat_valid", "kf_bow")
_MP_FIELDS = ("mp_pos", "mp_desc", "mp_normal", "mp_valid")


def _src_obs(src: ms.MapState, mp_off) -> torch.Tensor:
    """src's observation table re-indexed into the destination's ids."""
    return torch.where(src.kf_obs >= 0, src.kf_obs + mp_off, -1).to(
        torch.int32)


def merge_maps_device(dst: ms.MapState, src: ms.MapState, s, R, t):
    """Weld `src` into `dst` (dst <- s R src + t) with no read to the host
    (MergeLocal2's transform-and-weld, src/LoopClosing.cc:1956-2130):
    the offsets stay 0-d tensors and every append is a scatter into a slab
    extended by one dump row, where out-of-capacity rows land.

    Returns (merged MapState, fits [] bool). When `fits` is False the
    returned map is `dst` unchanged, so the caller selects on it."""
    K = dst.kf_obs.shape[0]
    M = dst.mp_pos.shape[0]
    Ks = src.kf_obs.shape[0]
    Ms = src.mp_pos.shape[0]
    dev = dst.kf_obs.device
    src_t = transform_map(src, s, R, t)
    kf_off, mp_off = dst.n_kf, dst.n_mp
    fits = (dst.n_kf + src.n_kf <= K) & (dst.n_mp + src.n_mp <= M)

    ks = torch.arange(Ks, device=dev)
    kf_tgt = torch.where(fits & (ks < src.n_kf), kf_off + ks, K)
    md = torch.arange(Ms, device=dev)
    mp_tgt = torch.where(fits & (md < src.n_mp), mp_off + md, M)

    def app(d, s_, tgt):
        ext = torch.cat([d, torch.zeros_like(d[:1])], dim=0)
        ext[tgt] = s_.to(d.dtype)
        return ext[:d.shape[0]]

    # unlike the host form, the device form also appends the landmark
    # counters (as the reference's does)
    upd = {f: app(getattr(dst, f), getattr(src_t, f), kf_tgt)
           for f in _KF_FIELDS}
    upd.update({f: app(getattr(dst, f), getattr(src_t, f), mp_tgt)
                for f in _MP_FIELDS + ("mp_visible", "mp_found")})
    out = dst._replace(
        kf_obs=app(dst.kf_obs, _src_obs(src, mp_off), kf_tgt),
        mp_dmin=app(dst.mp_dmin, s * src_t.mp_dmin, mp_tgt),
        mp_dmax=app(dst.mp_dmax, s * src_t.mp_dmax, mp_tgt),
        mp_first_kf=app(dst.mp_first_kf, src_t.mp_first_kf + kf_off,
                        mp_tgt),
        mp_last_kf=app(dst.mp_last_kf, src_t.mp_last_kf + kf_off, mp_tgt),
        n_kf=torch.where(fits, dst.n_kf + src.n_kf, dst.n_kf),
        n_mp=torch.where(fits, dst.n_mp + src.n_mp, dst.n_mp),
        **upd)
    # src's persistent loop edges move into dst's ring, slots shifted by
    # kf_off (the reference's lax.scan over the ring, entry by entry)
    live = (src.loop_valid & (src.loop_i >= 0) & (src.loop_j >= 0)) & fits
    for e in range(src.loop_i.shape[0]):
        added = ms.add_loop_edge(out, src.loop_i[e] + kf_off,
                                 src.loop_j[e] + kf_off)
        out = tree_where(live[e], added, out)
    return out, fits


def tree_where(pred, a, b):
    """Field-wise `torch.where(pred, a, b)` over two NamedTuples of one
    type (the reference's `_tree_where`)."""
    return type(a)(*(torch.where(pred, x, y) for x, y in zip(a, b)))


def merge_maps(dst: ms.MapState, src: ms.MapState, s, R, t):
    """Weld `src` into `dst`: src moved by the Sim3 (dst <- s R src + t),
    its keyframes and landmarks appended into dst's free capacity, its
    loop edges carried over with their slots shifted (LoopClosing::
    MergeLocal migrates keyframes and landmarks between maps,
    src/LoopClosing.cc:1381; here one re-indexed concatenation).

    Reads the counts on the host. Returns (merged MapState, ok): ok False,
    and `dst` unchanged, when the capacity does not hold src."""
    src_t = transform_map(src, s, R, t)
    K = dst.kf_obs.shape[0]
    M = dst.mp_pos.shape[0]
    n_kf_d, n_kf_s, n_mp_d, n_mp_s = torch.stack(
        [dst.n_kf, src.n_kf, dst.n_mp, src.n_mp]).tolist()
    if n_kf_d + n_kf_s > K or n_mp_d + n_mp_s > M:
        return dst, False
    kf = slice(n_kf_d, n_kf_d + n_kf_s)
    mp = slice(n_mp_d, n_mp_d + n_mp_s)

    def put(d, rows, vals):
        y = d.clone()
        y[rows] = vals.to(d.dtype)
        return y

    upd = {f: put(getattr(dst, f), kf, getattr(src_t, f)[:n_kf_s])
           for f in _KF_FIELDS}
    upd.update({f: put(getattr(dst, f), mp, getattr(src_t, f)[:n_mp_s])
                for f in _MP_FIELDS})
    dev = dst.n_kf.device
    out = dst._replace(
        kf_obs=put(dst.kf_obs, kf, _src_obs(src, n_mp_d)[:n_kf_s]),
        mp_dmin=put(dst.mp_dmin, mp, s * src_t.mp_dmin[:n_mp_s]),
        mp_dmax=put(dst.mp_dmax, mp, s * src_t.mp_dmax[:n_mp_s]),
        mp_first_kf=put(dst.mp_first_kf, mp,
                        src_t.mp_first_kf[:n_mp_s] + n_kf_d),
        mp_last_kf=put(dst.mp_last_kf, mp,
                       src_t.mp_last_kf[:n_mp_s] + n_kf_d),
        n_kf=torch.tensor(n_kf_d + n_kf_s, dtype=torch.int32, device=dev),
        n_mp=torch.tensor(n_mp_d + n_mp_s, dtype=torch.int32, device=dev),
        **upd)
    # src's persistent loop edges, slots shifted (the weld's own merge
    # edge is the caller's: mspMergeEdges, KeyFrame.h:216-243)
    edges = torch.stack([src.loop_i, src.loop_j,
                         src.loop_valid.to(torch.int32)]).tolist()
    for li, lj, lv in zip(*edges):
        if lv and li >= 0 and lj >= 0:
            out = ms.add_loop_edge(out, li + n_kf_d, lj + n_kf_d)
    return out, True
