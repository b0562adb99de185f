"""Distributed bundle adjustment over a process group (port of
`openmavis_tpu/parallel/dist_ba.py` on `torch.distributed`).

SPMD, one rank per device: every rank of the group runs the same call on
the same replicated inputs, takes its own contiguous block of the sharded
axis (rank r holds the rows that device r of the reference's mesh holds),
assembles the normal-equation contributions of its block, and sums them
over the group with one `all_reduce` where the reference `psum`s. The
small reduced solve is then the same arithmetic on identical operands on
every rank, so every rank returns the same result.

Sharded outputs (inlier masks, the landmarks of the landmark-sharded
solve) are put back together by an `all_reduce` over a zero-filled buffer
of the full length: gloo on CUDA tensors has `all_reduce` and `broadcast`
only, no `all_gather`. Bool and int64 tensors travel as uint8 and int32.

The solvers take the replicated inputs as every rank passes them and do
not check that the ranks agree; `tracking.distributed_global_ba_step`
broadcasts mesh rank 0's map before it builds them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..optim import ba, global_ba

_WIRE = {torch.bool: torch.uint8, torch.int64: torch.int32}


@dataclass(frozen=True)
class Mesh:
    """A process group as the distributed solvers see it: the group (a
    `ProcessGroup` or a backend object, anything with `allreduce` and
    `broadcast`), its size, and this rank within it."""
    group: object
    size: int
    rank: int


def make_mesh(group=None) -> Mesh:
    """A mesh over `group`, by default the whole initialized world."""
    if group is None:
        if not dist.is_initialized():
            raise RuntimeError(
                "make_mesh: no process group is initialized; call "
                "parallel.multihost.initialize() first, or pass a group")
        group = dist.group.WORLD
    return Mesh(group, group.size(), group.rank())


def one_rank_mesh(device) -> Mesh:
    """A group of this process alone, on a `HashStore`: NCCL for a CUDA
    device, gloo otherwise. It needs no initialized world."""
    store = dist.HashStore()
    if torch.device(device).type == "cuda":
        group = dist.ProcessGroupNCCL(store, 0, 1)
    else:
        group = dist.ProcessGroupGloo(store, 0, 1)
    return Mesh(group, 1, 0)


# resolve_mesh's groups, made once per (ranks, device) and world: a group
# costs a communicator's set-up, too much for every event-cadence solve
_MESHES: dict = {}


def resolve_mesh(mesh, device) -> Mesh:
    """`run_global_ba(mesh=)`'s argument as a Mesh: a Mesh as it is; an
    int n, ranks 0..n-1 of the initialized world; a list of ranks. With
    no world initialized, 1 (or [0]) is a one-rank group on `device`.
    Ranks beyond the world raise ValueError. Every rank of the world
    calls it (a subgroup is made collectively). The group made for a
    given ranks and device is kept and reused while the world lasts."""
    if isinstance(mesh, Mesh):
        return mesh
    ranks = (list(range(mesh)) if isinstance(mesh, int)
             else [int(r) for r in mesh])
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not ranks or len(set(ranks)) != len(ranks) or min(ranks) < 0 \
            or max(ranks) >= world:
        raise ValueError(
            f"mesh={mesh!r}: ranks {ranks} do not fit a world of size "
            f"{world} (initialize more processes with "
            f"parallel.multihost.initialize)")
    key = (tuple(ranks), str(torch.device(device)))
    owner = dist.group.WORLD if dist.is_initialized() else None
    hit = _MESHES.get(key)
    if hit is None or hit[0] is not owner:
        if owner is None:
            out = one_rank_mesh(device)
        elif ranks == list(range(world)):
            out = make_mesh()
        else:       # every rank of the world makes the subgroup
            group = dist.new_group(ranks)
            out = make_mesh(group) if dist.get_rank() in ranks else None
        hit = _MESHES[key] = (owner, out)
    if hit[1] is None:
        raise ValueError(f"mesh={mesh!r}: rank {dist.get_rank()} is not "
                         f"in it")
    return hit[1]


def all_reduce(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the mesh's ranks, on every rank (the
    counterpart of `jax.lax.psum`). May reduce `x` in place."""
    wire = _WIRE.get(x.dtype, x.dtype)
    y = x.contiguous() if wire == x.dtype else x.to(wire)
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    mesh.group.allreduce([y.reshape(-1)], opts).wait()
    return y if wire == x.dtype else y.to(x.dtype)


def broadcast(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Mesh rank 0's `x` on every rank (the same shape and dtype on each);
    `x` itself when the mesh has one rank."""
    if mesh.size == 1:
        return x
    y = (x.to(torch.uint8) if x.dtype == torch.bool else x).clone(
        memory_format=torch.contiguous_format)
    opts = dist.BroadcastOptions()
    opts.rootRank = 0
    mesh.group.broadcast([y.reshape(-1)], opts).wait()
    return y.to(x.dtype)


def _block(mesh: Mesh, x):
    """This rank's contiguous block of the leading axis (divisible by the
    mesh size): the rows the reference's `P(axis)` puts on its device."""
    n = x.shape[0] // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def assemble(mesh: Mesh, part: torch.Tensor, total: int) -> torch.Tensor:
    """The [total, ...] tensor on every rank from each rank's contiguous
    block `part` (an all_reduce over a zero-filled buffer: exact)."""
    n = part.shape[0]
    buf = torch.zeros((total,) + tuple(part.shape[1:]), dtype=part.dtype,
                      device=part.device)
    buf[mesh.rank * n:(mesh.rank + 1) * n] = part
    return all_reduce(mesh, buf)


def _pad_obs(obs: ba.BAObservations, n_dev: int) -> ba.BAObservations:
    pad = (-obs.kf.shape[0]) % n_dev
    if pad == 0:
        return obs

    def padd(x, val=0):
        return F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad), value=val)

    return ba.BAObservations(
        kf=padd(obs.kf), mp=padd(obs.mp), cam=padd(obs.cam),
        uv=padd(obs.uv), sigma2=padd(obs.sigma2, 1),
        valid=padd(obs.valid, False))


def distributed_bundle_adjust(mesh: Mesh, state: ba.BAState,
                              obs: ba.BAObservations, rig, pose_fixed,
                              point_fixed=None, edges=None, prior=None,
                              prior_idx: int = 0, stages=(5, 10)):
    """Window BA with the observations sharded over the mesh and the
    state replicated. Returns (state, obs_inlier (original length), chi)."""
    o_orig = obs.kf.shape[0]
    obs_p = _pad_obs(obs, mesh.size)
    st, inl, chi = ba.bundle_adjust(
        state, ba.BAObservations(*(_block(mesh, x) for x in obs_p)), rig,
        pose_fixed, point_fixed=point_fixed, edges=edges, prior=prior,
        prior_idx=prior_idx, stages=stages, psum=partial(all_reduce, mesh))
    return st, assemble(mesh, inl, obs_p.kf.shape[0])[:o_orig], chi


def shard_observations_by_landmark(obs: ba.BAObservations, M: int,
                                   n_dev: int):
    """Bucket observations by their landmark's owner rank (BLOCK
    partition: landmark m lives on rank m // (M/n_dev)), pad the buckets
    to a common length, and remap mp to OWNER-LOCAL ids.

    Returns (obs_bucketed [n_dev*O_loc] on obs's device, perm
    [n_dev*O_loc] numpy: the original observation index or -1 for
    padding). Host numpy; reads the table once."""
    if M % n_dev:
        raise ValueError(f"M={M} is not a multiple of {n_dev} ranks")
    M_loc = M // n_dev
    host = {k: v.detach().cpu().numpy() for k, v in obs._asdict().items()}
    mp, valid = host["mp"], host["valid"]
    owner = np.clip(mp, 0, M - 1) // M_loc
    owner = np.where(valid, owner, -1)
    buckets = [np.nonzero(owner == d)[0] for d in range(n_dev)]
    # padding rows also carry the leftover (invalid) observations, so no
    # data is dropped; they stay valid=False
    rest = np.nonzero(owner < 0)[0]
    O_loc = max(max(len(b) for b in buckets), 1)
    O_loc = max(O_loc, int(np.ceil(len(rest) / n_dev)))
    idx = np.full((n_dev, O_loc), -1, np.int64)
    for d in range(n_dev):
        idx[d, :len(buckets[d])] = buckets[d]
    # distribute leftover invalid rows round-robin into the padding
    slots = np.nonzero(idx < 0)
    take = min(len(rest), len(slots[0]))
    idx[slots[0][:take], slots[1][:take]] = rest[:take]

    flat = idx.reshape(-1)
    real = flat >= 0
    safe = np.maximum(flat, 0)

    def gather(x, fill=0):
        g = x[safe]
        return np.where(real.reshape((-1,) + (1,) * (g.ndim - 1)), g, fill)

    valid_g = gather(valid, False) & real
    mp_local = np.where(valid_g, gather(mp) % M_loc, 0).astype(mp.dtype)
    dev = obs.kf.device
    obs_b = ba.BAObservations(
        kf=torch.from_numpy(gather(host["kf"])).to(dev),
        mp=torch.from_numpy(mp_local).to(dev),
        cam=torch.from_numpy(gather(host["cam"])).to(dev),
        uv=torch.from_numpy(gather(host["uv"])).to(dev),
        sigma2=torch.from_numpy(gather(host["sigma2"], 1.0).astype(
            host["sigma2"].dtype)).to(dev),
        valid=torch.from_numpy(valid_g).to(dev))
    return obs_b, flat


def distributed_global_ba_lsharded(mesh: Mesh, state: ba.BAState,
                                   obs: ba.BAObservations, rig, pose_fixed,
                                   point_fixed=None, edges=None, prior=None,
                                   prior_idx: int = 0, stages=(5, 10),
                                   cg_iters: int = 24):
    """Landmark-SHARDED whole-map BA: the landmarks, their Hessian blocks
    and the observation table are partitioned over the mesh (landmark m
    on rank m // (M/n)); the poses stay replicated. Per CG matvec one
    [K, D] all_reduce runs. M is padded to a multiple of the mesh size.
    Returns (state, obs_inlier (original length), chi)."""
    n = mesh.size
    o_orig = obs.kf.shape[0]
    M = state.points.shape[0]
    pad_m = (-M) % n
    points = F.pad(state.points, (0, 0, 0, pad_m))
    if point_fixed is not None:
        point_fixed = F.pad(point_fixed, (0, pad_m), value=True)
    Mp = M + pad_m
    obs_b, perm = shard_observations_by_landmark(obs, Mp, n)
    st, inl_b, chi = global_ba.global_bundle_adjust(
        state._replace(points=_block(mesh, points)),
        ba.BAObservations(*(_block(mesh, x) for x in obs_b)), rig,
        pose_fixed,
        point_fixed=None if point_fixed is None else _block(mesh,
                                                            point_fixed),
        edges=edges, prior=prior, prior_idx=prior_idx, stages=stages,
        cg_iters=cg_iters, psum=partial(all_reduce, mesh), points_local=True)
    st = st._replace(points=assemble(mesh, st.points, Mp)[:M])
    inl_all = assemble(mesh, inl_b, len(perm))
    # un-permute the inliers back to the original observation order
    keep = torch.from_numpy(perm >= 0).to(inl_all.device)
    src = torch.from_numpy(np.maximum(perm, 0)).to(inl_all.device)
    inl = torch.zeros(o_orig, dtype=torch.bool, device=inl_all.device)
    inl[src[keep]] = inl_all[keep]
    return st, inl, chi


def distributed_global_ba(mesh: Mesh, state: ba.BAState,
                          obs: ba.BAObservations, rig, pose_fixed,
                          point_fixed=None, edges=None, prior=None,
                          prior_idx: int = 0, stages=(5, 10),
                          cg_iters: int = 24):
    """Whole-map BA with the observations sharded and the state
    replicated: each rank evaluates its block's terms and gather/scatter
    passes; one [K, D] all_reduce per CG matvec (plus the [M] landmark
    reductions). Returns (state, obs_inlier (original length), chi)."""
    o_orig = obs.kf.shape[0]
    obs_p = _pad_obs(obs, mesh.size)
    st, inl, chi = global_ba.global_bundle_adjust(
        state, ba.BAObservations(*(_block(mesh, x) for x in obs_p)), rig,
        pose_fixed, point_fixed=point_fixed, edges=edges, prior=prior,
        prior_idx=prior_idx, stages=stages, cg_iters=cg_iters,
        psum=partial(all_reduce, mesh))
    return st, assemble(mesh, inl, obs_p.kf.shape[0])[:o_orig], chi
