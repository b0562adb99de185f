"""The multi-process runtime for the distributed solvers (port of
`openmavis_tpu/parallel/multihost.py` on `torch.distributed`).

One process per device. `initialize` joins the processes into one world
(NCCL between GPUs, gloo on the CPU or for ranks that share a GPU);
`global_mesh` is the mesh over all of them, and the solvers of `dist_ba`
run unchanged on it. `host_local_to_global` turns each rank's own rows
(its data loader's share) into the whole table on every rank, which is
what the solvers take.

Under torchrun (`env://`):

    torchrun --nproc-per-node 4 app.py
    # in app.py:
    multihost.initialize()            # NCCL, cuda:LOCAL_RANK
    slam.run_global_ba(mesh=multihost.process_count())

By hand: `initialize("host:port", num_processes=2, process_id=r)`.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from .dist_ba import Mesh, all_reduce, make_mesh


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> None:
    """Join (or start) the process group; once per process, a no-op when
    a group is up. `coordinator` "host:port" with `num_processes` and
    this `process_id` rendezvous over TCP; without it the environment
    torchrun sets (`env://`) is read. `backend` None picks NCCL when this
    process has a CUDA device (and then binds it to cuda:LOCAL_RANK, or
    process_id modulo the device count) and gloo otherwise; pass "gloo"
    for ranks that share one GPU (NCCL refuses two ranks on one card)."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and dist.is_nccl_available() else "gloo")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = dict(backend=backend, timeout=timedelta(minutes=10))
    if coordinator is not None:
        kw.update(init_method=f"tcp://{coordinator}",
                  world_size=num_processes, rank=process_id)
    else:
        kw.update(init_method="env://")
    dist.init_process_group(**kw)


def global_mesh() -> Mesh:
    """The mesh over every rank of the world, in rank order."""
    return make_mesh()


def _rows_to_all(mesh: Mesh, x):
    x = torch.as_tensor(x)
    counts = torch.zeros(mesh.size, dtype=torch.int32, device=x.device)
    counts[mesh.rank] = x.shape[0]
    counts = all_reduce(mesh, counts).tolist()
    if x.dtype == torch.int64 and x.numel() and int(x.abs().max()) >= 2**31:
        raise ValueError("host_local_to_global: int64 values beyond int32 "
                         "cannot travel")
    lo = sum(counts[:mesh.rank])
    buf = torch.zeros((sum(counts),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf[lo:lo + x.shape[0]] = x
    return all_reduce(mesh, buf)


def host_local_to_global(mesh: Mesh, local_batches):
    """Each rank's own rows (a tensor, or a NamedTuple, tuple, list or
    dict of them) become the whole table on every rank: the ranks' rows
    along the leading axis in rank order. Every rank calls it with the
    same structure."""
    if isinstance(local_batches, dict):
        return {k: host_local_to_global(mesh, v)
                for k, v in local_batches.items()}
    if isinstance(local_batches, (tuple, list)):
        vals = [host_local_to_global(mesh, v) for v in local_batches]
        if hasattr(local_batches, "_fields"):
            return type(local_batches)(*vals)
        return type(local_batches)(vals)
    return _rows_to_all(mesh, local_batches)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0
