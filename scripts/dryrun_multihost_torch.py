#!/usr/bin/env python
"""Two-rank dryrun of the port's multi-process runtime: two processes join
one `torch.distributed` group (`openmavis_tpu_torch.parallel.multihost`),
each hands in its own half of the observation table, the whole table is
assembled on both with `host_local_to_global`, and the landmark-sharded
whole-map BA (`dist_ba.distributed_global_ba_lsharded`) runs over the two
ranks. The same solve on a one-rank group of one process is the ground
truth: agreement means the collectives changed nothing but the transport.

    python scripts/dryrun_multihost_torch.py    # the current GPU: two
        # ranks share it over gloo (NCCL refuses two ranks on a card)
    python scripts/dryrun_multihost_torch.py --device cpu    # CPU, gloo
    python scripts/dryrun_multihost_torch.py --problem dryrun,atlas

`--problem dryrun` is scripts/dryrun_multihost.py's problem (K=32, M=4096,
O=8192, numpy seed 0, stages (3, 6), 12 CG iterations); `--problem atlas`
the Atlas-scale one of the reference's multi-chip record (K=128,
M=32768, O=65536, stages (2,), 8 CG iterations), made with numpy.
Rank 0 prints one JSON line a problem: processes, devices, each rank's
chi2, the one-rank chi2, `ranks_bit_equal`, `cross_vs_local_t_m` (largest
pose difference against the one-rank solve), the solves' times and `ok`.
"""

import argparse
import json
import math
import os
import socket
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the solver's depth, and the bound on the largest pose error against the
# ground truth that `ok` holds (the reference script's 0.1 m on its
# problem; the Atlas-scale record's two LM iterations are not a converged
# solve, so none there)
PROBLEMS = {"dryrun": (dict(stages=(3, 6), cg_iters=12), 0.1),
            "atlas": (dict(stages=(2,), cg_iters=8), None)}


def build_problem(name: str):
    """The problem as numpy: (state fields, ground-truth t, obs fields,
    rig fields, fixed)."""
    if name == "dryrun":
        return _dryrun_problem()
    return _atlas_problem()


def _dryrun_problem(K=32, M=4096, O=8192):
    # scripts/dryrun_multihost.py's construction, in numpy float32
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * np.pi, K, endpoint=False)
    pos = np.stack([6 * np.cos(t), 6 * np.sin(t), np.zeros(K)],
                   -1).astype(np.float32)
    pts = rng.uniform(-8, 8, (M, 3)).astype(np.float32)
    pts[:, 2] += 12.0
    kf_i = rng.integers(0, K, O)
    mp_i = rng.integers(0, M, O)
    params = np.asarray([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0],
                        np.float32)
    p_c = pts[mp_i] - pos[kf_i]          # R = I
    z = np.maximum(p_c[:, 2], np.float32(1e-3))
    uv = params[:2] * p_c[:, :2] / z[:, None] + params[2:4]
    uv = uv + np.float32(0.2) * rng.normal(size=(O, 2)).astype(np.float32)
    obs = dict(kf=kf_i.astype(np.int32), mp=mp_i.astype(np.int32),
               uv=uv, sigma2=np.ones(O, np.float32),
               cam=np.zeros(O, np.int32), valid=z > 0.1)
    z3 = np.zeros((K, 3), np.float32)
    state = dict(
        R=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
        t=pos + np.float32(0.05) * rng.normal(size=(K, 3)).astype(
            np.float32),
        v=z3, bg=z3, ba=z3,
        points=pts + np.float32(0.05) * rng.normal(size=(M, 3)).astype(
            np.float32))
    rig = dict(params=params[None], R_cb=np.eye(3, dtype=np.float32)[None],
               t_cb=np.zeros((1, 3), np.float32))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return state, pos, obs, rig, fixed


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _exp(w):
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(th) * Kx + (1 - math.cos(th)) * Kx @ Kx


def _atlas_problem(K=128, M=32768, obs_per_kf=512):
    # the construction of the reference's `_ba_problem`, made with numpy
    rng = np.random.default_rng(0)
    f32 = np.float32
    points = np.stack([rng.uniform(-8, 8, M), rng.uniform(-5, 5, M),
                       rng.uniform(5, 20, M)], -1)
    R_gt = np.stack([_rot_y(a) for a in np.linspace(0, 0.5, K)])
    t_gt = np.stack([np.linspace(0, 0.2 * K, K), np.zeros(K), np.zeros(K)],
                    -1)
    kf = np.repeat(np.arange(K), obs_per_kf)
    mp = rng.integers(0, M, K * obs_per_kf)
    p_b = np.einsum("oji,oj->oi", R_gt[kf], points[mp] - t_gt[kf])
    z = np.maximum(p_b[:, 2], 1e-3)
    uv = 380.0 * p_b[:, :2] / z[:, None] + np.array([256.0, 192.0])
    uv = uv + 0.3 * rng.normal(size=uv.shape)
    valid = (p_b[:, 2] > 1.0) & (np.abs(uv[:, 0] - 256) < 256) \
        & (np.abs(uv[:, 1] - 192) < 192)
    O = K * obs_per_kf
    obs = dict(kf=kf.astype(np.int32), mp=mp.astype(np.int32),
               uv=uv.astype(f32), sigma2=np.ones(O, f32),
               cam=np.zeros(O, np.int32), valid=valid)
    dR = np.stack([_exp(w) for w in 0.005 * rng.normal(size=(K, 3))])
    R0 = R_gt @ dR
    R0[:2] = R_gt[:2]
    t0 = t_gt + 0.02 * rng.normal(size=(K, 3))
    t0[:2] = t_gt[:2]
    z3 = np.zeros((K, 3), f32)
    state = dict(R=R0.astype(f32), t=t0.astype(f32), v=z3, bg=z3, ba=z3,
                 points=(points + 0.02 * rng.normal(size=points.shape)
                         ).astype(f32))
    rig = dict(params=np.asarray([[380.0, 380.0, 256.0, 192.0, 0, 0, 0, 0]],
                                 f32),
               R_cb=np.eye(3, dtype=f32)[None], t_cb=np.zeros((1, 3), f32))
    return state, t_gt.astype(f32), obs, rig, np.arange(K) < 2


def worker(rank: int, port: int, args):
    sys.path.insert(0, ROOT)
    if args.backend == "gloo":
        # one host: gloo's transport on the loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch

    from openmavis_tpu_torch.optim import ba
    from openmavis_tpu_torch.optim.reprojection import RigParams
    from openmavis_tpu_torch.parallel import dist_ba, multihost

    torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    multihost.initialize(f"localhost:{port}", num_processes=2,
                         process_id=rank, backend=args.backend)
    assert multihost.process_count() == 2
    assert multihost.process_index() == rank
    mesh = multihost.global_mesh()
    for name in args.problem.split(","):
        _solve_problem(torch, ba, RigParams, dist_ba, multihost, mesh, rank,
                       dev, name, args.backend)
    # keep rank 1 in the group until rank 0 is done
    dist_ba.all_reduce(mesh, torch.zeros(1, device=dev))
    torch.distributed.destroy_process_group()


def _solve_problem(torch, ba, RigParams, dist_ba, multihost, mesh, rank,
                   dev, name, backend):
    state_np, t_gt, obs_np, rig_np, fixed_np = build_problem(name)
    O = obs_np["kf"].shape[0]
    mine = slice(rank * O // 2, (rank + 1) * O // 2)

    def tens(d, sl=slice(None)):
        return {k: torch.from_numpy(np.ascontiguousarray(v[sl])).to(dev)
                for k, v in d.items()}

    whole = ba.BAObservations(**tens(obs_np))
    obs = multihost.host_local_to_global(
        mesh, ba.BAObservations(**tens(obs_np, mine)))
    assembled_equal = all(torch.equal(a, b) for a, b in zip(obs, whole))
    state = ba.BAState(**tens(state_np))
    rig = RigParams(0, *(torch.from_numpy(rig_np[k]).to(dev)
                         for k in ("params", "R_cb", "t_cb")))
    fixed = torch.from_numpy(fixed_np).to(dev)
    kw, gt_tol = PROBLEMS[name]

    def solve(m):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dist_ba.distributed_global_ba_lsharded(
            m, state, obs, rig, fixed, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    if dev.type == "cuda":
        solve(mesh)          # CUDA's lazy init and allocations, untimed
    (st, inl, chi), ms_two = solve(mesh)
    # every rank's result on every rank: [2, n] over a zero-filled buffer
    flat = torch.cat([st.R.reshape(-1), st.t.reshape(-1),
                      st.points.reshape(-1), inl.to(st.t.dtype),
                      chi.reshape(1)])
    both = dist_ba.assemble(mesh, flat[None], 2)
    bit_equal = bool(torch.equal(both[0], both[1]))
    chis = both[:, -1].tolist()

    if rank == 0:
        local = dist_ba.one_rank_mesh(dev)
        if dev.type == "cuda":
            solve(local)
        (st_l, _, chi_l), ms_one = solve(local)
        d_cross = float((st.t - st_l.t).abs().max())
        dt = float((st.t.cpu() - torch.from_numpy(t_gt)).abs().max())
        chi_l = float(chi_l)
        rel = abs(chis[0] - chi_l) / max(abs(chi_l), 1e-12)
        ok = (all(math.isfinite(c) for c in chis) and bit_equal
              and assembled_equal and d_cross < 1e-3 and rel < 1e-3
              and (gt_tol is None or dt < gt_tol))
        devices = [str(dev)] * 2
        print(json.dumps({
            "metric": "multihost_dryrun_torch", "problem": name,
            "processes": 2, "devices": devices, "backend": backend,
            "O": O, "chi2": chis, "chi2_local": chi_l,
            "chi2_rel_diff": rel, "ranks_bit_equal": bit_equal,
            "assembled_equal": assembled_equal,
            "max_abs_t_err_m": dt, "cross_vs_local_t_m": d_cross,
            "ms_two_rank": ms_two, "ms_one_rank": ms_one, "ok": bool(ok),
        }), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="default: the current CUDA device (none: error)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--problem", default="dryrun",
                    help="comma-separated, of: " + ", ".join(PROBLEMS))
    ap.add_argument("--threads", type=int, default=1,
                    help="torch intra-op threads per rank")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    unknown = set(args.problem.split(",")) - set(PROBLEMS)
    if unknown:
        ap.error(f"unknown problems {sorted(unknown)}")
    sys.path.insert(0, ROOT)
    import torch.multiprocessing as mp

    from openmavis_tpu_torch import resolve_device
    args.device = resolve_device(args.device).type

    ctx = mp.start_processes(worker, args=(_free_port(), args), nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + args.timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after "
                                   f"{args.timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


if __name__ == "__main__":
    main()
