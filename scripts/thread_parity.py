#!/usr/bin/env python3
"""Does the port's CPU run depend on torch's intra-op thread count?

MODE is one of:
* `slice`: tests/test_torch_slice.py's shared-features run: the port's
  `StreamingVITracker` on that test's 14-frame scene, fed the reference's
  extracted features (JAX). The parent process runs the reference
  tracker once; each run of the port then
  reports the first frame and map field whose integers differ from the
  reference's and the largest position difference.
* `rgbd_tum`: the port's `rgbd_tum` main on tests/test_examples_e2e.py's
  scene (`scripts/reference_examples.py rgbd_tum --port`), with its rows
  and ATE (Horn scale) against the rig's positions.

With `--fixed-order` the port runs inside this script's
`fixed_order_sums()`: the four sums that part with the thread count (the
window BA's Schur complement and reduced right-hand side in
`optim/ba.py::_schur_solve`, the pose optimization's `H` and `g` in
`optim/pose_opt.py::_normal_eq`) are routed at run time through `gram`
and `matvec`, which sum in float64 in an order independent of the thread
count. The port itself keeps torch.matmul and its einsums there.

Usage:
  JAX_PLATFORMS=cpu python3 scripts/thread_parity.py MODE --threads 1,2,4,8
      one run per thread count, each in its own process (at most two at
      a time); one JSON line per run (its digest: every integer and float
      it reports, hashed; the wall seconds and calls of the local BA
      entry points, `tracking.local_ba_step` and
      `multi_tracking.vi_window_ba_step`) and a last line saying whether
      all are equal.
  JAX_PLATFORMS=cpu python3 scripts/thread_parity.py MODE --threads N
      --ops FILE
      one run at N threads that hashes the outputs of every aten op the
      port runs (`TorchDispatchMode`) into FILE.tN, with the innermost
      frame of the port that called it.
  python3 scripts/thread_parity.py first FILE_A FILE_B [--ints]
      [--skip WHERE,...]
      the first op whose outputs differ between two such files (with
      `--ints`, the first whose integer or bool outputs differ: the gate
      that a float parting crosses); `--skip` leaves out the ops whose
      caller contains one of the strings (to line up two versions of a
      function, e.g. `ba.py:77 ,ba.py:78 ,_schur_products`).
"""

import contextlib
import functools
import hashlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
sys.path.insert(0, os.path.join(REPO, "tests"))

PORT_DIR = os.path.join(REPO, "openmavis_tpu_torch")
# ops whose output is uninitialised memory
_SKIP = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided")
# what the recorder writes: (op, digest, caller, kinds), and ("frame", i)
# before each frame of the slice run
_RECORDS = []
# writes whose duplicate targets (the port's dump rows) keep whichever
# write lands last: `first` passes over them, and a difference they make
# outside a dump row shows in the next op that reads it
_UNORDERED = ("aten.index_put_.default", "aten.index_put.default",
              "aten.scatter_.src", "aten.scatter.src",
              "aten.scatter_.value", "aten.scatter.value",
              "aten.index_copy_.default", "aten.index_copy.default")


def _digest(x):
    import torch
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.device.type == "meta" or t._is_zerotensor():
            return "zero%s" % (tuple(t.shape),)
        if t.is_complex() or t.dtype == torch.bfloat16:
            t = t.to(torch.float64)
        return hashlib.blake2b(t.contiguous().cpu().numpy().tobytes(),
                               digest_size=8).hexdigest()
    if isinstance(x, (list, tuple)):
        return ",".join(_digest(v) for v in x)
    return repr(x)


def _kind(x):
    """'f' for a float output, 'i' for an integer or bool one."""
    import torch
    if isinstance(x, (list, tuple)):
        return "".join(_kind(v) for v in x)
    if isinstance(x, torch.Tensor):
        return "f" if x.is_floating_point() or x.is_complex() else "i"
    return "-"


def _where():
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.startswith(PORT_DIR):
            return "%s:%d %s" % (os.path.relpath(f.f_code.co_filename, REPO),
                                 f.f_lineno, f.f_code.co_name)
        f = f.f_back
    return "?"


def _op_recorder(records):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name not in _SKIP:
                records.append((str(func), _digest(out), _where(),
                                _kind(out)))
            return out

    return Recorder()


# --------------------------------------------------------------------------
# the fixed summation order
# --------------------------------------------------------------------------

# columns per GEMM in `gram`'s chunked form: too few for the CPU BLAS to
# split one product's sums across threads
GRAM_COLS = 48
# at most this many products, `gram` multiplies elementwise
GRAM_ELEMENTWISE = 1 << 20
# the einsums of `pose_opt._normal_eq` that `fixed_order_sums` routes
_NORMAL_EQ_H = "oai,oaj->ij"
_NORMAL_EQ_G = "oai,oa->i"


def gram(X, Z):
    """X @ Z.T for CPU tensors X [p, L] and Z [q, L], summed in float64
    and rounded once to X's dtype: a small product as p * q vectorised
    row sums of a contiguous array (each row on one thread: a reduction
    over a strided axis is split over threads), a larger one as GEMMs of
    GRAM_COLS columns added in column order."""
    import torch
    dtype = X.dtype
    X, Z = X.double().contiguous(), Z.double().contiguous()
    p, L = X.shape
    q = Z.shape[0]
    if p * q * L <= GRAM_ELEMENTWISE:
        return (X[:, None, :] * Z[None, :, :]).sum(-1).to(dtype)
    out = torch.zeros((p, q), dtype=X.dtype)
    for s in range(0, L, GRAM_COLS):
        out.addmm_(X[:, s:s + GRAM_COLS], Z[:, s:s + GRAM_COLS].T)
    return out.to(dtype)


def matvec(X, v):
    """X @ v for CPU tensors X [p, L] and v [L]: one vectorised float64
    row sum per row, rounded once to X's dtype."""
    return (X.double().contiguous() * v.double()).sum(-1).to(X.dtype)


def _fixed_order_mode(routed):
    """A TorchFunctionMode that sends, on CPU tensors, a 2-D @ 2-D product
    to `gram`, a 2-D @ 1-D one to `matvec` and `_normal_eq`'s two einsums
    to both; `routed` counts each site it took."""
    import torch
    from torch.overrides import TorchFunctionMode
    matmul = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)

    class FixedOrder(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in matmul and not kwargs and len(args) == 2:
                a, b = args
                if a.device.type == "cpu" and a.dim() == 2:
                    if b.dim() == 2:
                        routed["gram"] = routed.get("gram", 0) + 1
                        return gram(a, b.T)
                    if b.dim() == 1:
                        routed["matvec"] = routed.get("matvec", 0) + 1
                        return matvec(a, b)
            if (func is torch.einsum and args[0] in (_NORMAL_EQ_H,
                                                     _NORMAL_EQ_G)
                    and args[1].device.type == "cpu"):
                eq, Jw, x = args
                Jw6 = Jw.reshape(-1, Jw.shape[-1]).T
                routed[eq] = routed.get(eq, 0) + 1
                if eq == _NORMAL_EQ_H:
                    return gram(Jw6, x.reshape(-1, x.shape[-1]).T)
                return matvec(Jw6, x.reshape(-1))
            return func(*args, **(kwargs or {}))

    return FixedOrder()


@contextlib.contextmanager
def fixed_order_sums(routed=None):
    """Within the block, the port's `optim.ba._schur_solve` and
    `optim.pose_opt._normal_eq` run under `_fixed_order_mode`: their four
    BLAS sums (the Schur complement `Hpp - Y A^T`, the reduced right-hand
    side `gp - Y gl`, the pose's `H` and `g`) sum in float64 in an order
    that does not depend on torch's thread count. The two functions are
    wrapped at run time and put back on exit; `routed` (a dict) counts
    the sites taken."""
    from openmavis_tpu_torch.optim import ba, pose_opt
    routed = {} if routed is None else routed
    saved = ba._schur_solve, pose_opt._normal_eq

    def wrap(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            with _fixed_order_mode(routed):
                return fn(*a, **kw)
        return run

    ba._schur_solve, pose_opt._normal_eq = map(wrap, saved)
    try:
        yield routed
    finally:
        ba._schur_solve, pose_opt._normal_eq = saved


# --------------------------------------------------------------------------
# the slice test's shared-features run
# --------------------------------------------------------------------------

def _slice_inputs(path):
    """The reference tracker's record of every frame, pickled into
    `path` (JAX)."""
    import jax.numpy as jnp
    from openmavis_tpu.frontend import extractor as jex
    from openmavis_tpu.imu import preintegration as jpre
    from openmavis_tpu.optim.reprojection import RigParams as JRig
    from openmavis_tpu.pipeline import streaming_vi as jsv
    from openmavis_tpu_torch import scene
    import test_torch_slice as ts

    rig_np, frames, R_wb, t_wb, batches = scene.make_sequence(
        ts.N, orbit_frac=0.12, w=ts.W, h=ts.H)
    cfg_j = jex.OrbConfig(**ts.ORB)
    jt = jsv.StreamingVITracker(
        JRig(rig_np["kind"], *(jnp.asarray(rig_np[k])
                               for k in ("params", "R_cb", "t_cb"))),
        jsv.VIStreamConfig(orb=cfg_j, **ts._cfg_kwargs()),
        jpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS), seed=0)
    rec = []
    for i in range(ts.N):
        t, b = batches[i]
        jt.push(frames[i], t, b)
        rec.append(ts._record(jt, np.asarray))
    with open(path, "wb") as f:
        pickle.dump(rec, f)


def _run_slice(inputs):
    import jax
    import jax.numpy as jnp
    import torch
    from openmavis_tpu.frontend import extractor as jex
    from openmavis_tpu_torch import convert, scene
    from openmavis_tpu_torch.frontend import extractor as tex
    from openmavis_tpu_torch.pipeline import multi_tracking as tmt
    import test_torch_slice as ts

    with open(inputs, "rb") as f:
        ref = pickle.load(f)
    rig_np, frames, R_wb, t_wb, batches = scene.make_sequence(
        ts.N, orbit_frac=0.12, w=ts.W, h=ts.H)
    tr = ts._port_tracker(rig_np)
    cfg_j = jex.OrbConfig(**ts.ORB)
    j_extract = jax.jit(lambda im: jex.extract_multicam(im, cfg_j))

    def shared_bank(images):
        # the reference's features, as tests/test_torch_slice.py feeds them
        fj = j_extract(jnp.asarray(images.numpy()))
        return tmt.concat_bands(
            tex.Features(*(torch.as_tensor(np.array(x)) for x in fj)))

    tr._step.extract_bank = shared_bank
    first, dp, rec = None, 0.0, []
    for i in range(ts.N):
        _RECORDS.append(("frame", i))
        t, b = batches[i]
        tr.push(frames[i], t, b)
        r = ts._record(tr, convert._np)
        rec.append(r)
        want = ref[i]
        for name, v in want["ints"].items():
            if first is None and not np.array_equal(r["ints"][name], v):
                d = np.argwhere(np.asarray(r["ints"][name]) != v)
                first = dict(frame=i, field=name, at=d[:3].tolist(),
                             port=np.asarray(r["ints"][name])[
                                 tuple(d[0])].tolist(),
                             reference=np.asarray(v)[tuple(d[0])].tolist())
        dp = max(dp, float(np.abs(r["p"] - want["p"]).max()))
    blob = b"".join(np.ascontiguousarray(v).tobytes() for r in rec
                    for v in [r["R"], r["p"]] + list(r["ints"].values()))
    return dict(digest=hashlib.blake2b(blob, digest_size=8).hexdigest(),
                ints_equal_reference=first is None, first_part=first,
                max_dp_m=dp, n_kf=int(tr.n_kf), n_mp=rec[-1]["n_mp"])


# --------------------------------------------------------------------------
# the rgbd_tum main
# --------------------------------------------------------------------------

def _run_rgbd_tum():
    import importlib
    import io
    import reference_examples as rx
    from openmavis_tpu_torch.io import evaluation

    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "traj.txt")
        name, argv, t_gt, p_body, _ = rx._prepare(
            "rgbd_tum", os.path.join(root, "scene"), out)
        made = rx._capture("openmavis_tpu_torch")
        mod = importlib.import_module(f"openmavis_tpu_torch.examples.{name}")
        with contextlib.redirect_stderr(io.StringIO()):
            mod.main(argv + ["--device", "cpu"])
        t_est, p_est = rx._read_trajectory(name, out)
        raw = open(out, "rb").read()
    r = evaluation.ate_rmse(t_est, p_est, t_gt, p_body, with_scale=True)
    tracker = getattr(made[-1], "tracker", made[-1])
    return dict(digest=hashlib.blake2b(raw, digest_size=8).hexdigest(),
                rows=int(len(t_est)), keyframes=int(tracker.n_kf),
                ate_m=float(r["rmse"]), scale=float(r["scale"]))


def _ba_timer():
    """Wrap the local BA entry points the slice runs: seconds and calls of
    each (wall time, on the CPU)."""
    from openmavis_tpu_torch.pipeline import multi_tracking, tracking
    spent = {}
    for mod, name in ((tracking, "local_ba_step"),
                      (multi_tracking, "vi_window_ba_step")):
        fn = getattr(mod, name)

        def timed(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            s, n = spent.get(_name, (0.0, 0))
            spent[_name] = (s + time.perf_counter() - t0, n + 1)
            return out

        setattr(mod, name, timed)
    return spent


def _child(mode, threads, inputs, ops, fixed):
    import torch
    torch.set_num_threads(threads)
    spent = _ba_timer()
    records = _RECORDS
    t0 = time.perf_counter()
    run = (lambda: _run_slice(inputs)) if mode == "slice" else _run_rgbd_tum
    with fixed_order_sums() if fixed else contextlib.nullcontext():
        if ops:
            with _op_recorder(records):
                res = run()
            with open(ops, "wb") as f:
                pickle.dump(records, f)
            res["ops"] = len(records)
        else:
            res = run()
    res.update(mode=mode, threads=threads, fixed_order=fixed,
               seconds=round(time.perf_counter() - t0, 1),
               ba_seconds={k: [round(v[0], 3), v[1]]
                           for k, v in spent.items()})
    print(json.dumps(res), flush=True)


def _first(path_a, path_b, ints=False, skip=()):
    def load(path):
        with open(path, "rb") as f:
            return [r for r in pickle.load(f) if r[0] == "frame"
                    or not any(k in r[2] for k in skip)]
    a, b = load(path_a), load(path_b)
    frame = None
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] == "frame":
            frame = x[1]
            continue
        if x[0] != y[0]:
            print(json.dumps(dict(op=i, diverged_sequence=True, a=x, b=y)))
            return
        dx, dy = x[1].split(","), y[1].split(",")
        if ints and len(x[3]) == len(dx):
            dx = [d for d, k in zip(dx, x[3]) if k == "i"]
            dy = [d for d, k in zip(dy, y[3]) if k == "i"]
        if dx != dy and x[0] not in _UNORDERED:
            print(json.dumps(dict(op=i, frame=frame, func=x[0], where=x[2],
                                  n_ops=[len(a), len(b)])))
            return
    print(json.dumps(dict(equal=True, n_ops=[len(a), len(b)])))


def main():
    args = sys.argv[1:]
    if not args:
        sys.exit(__doc__)
    if args[0] == "first":
        skip = (args[args.index("--skip") + 1].split(",")
                if "--skip" in args else ())
        return _first(args[1], args[2], "--ints" in args, skip)
    if args[0] == "--child":
        mode, threads, inputs, ops = args[1], int(args[2]), args[3], args[4]
        return _child(mode, threads, inputs or None, ops or None,
                      args[5] == "1")
    mode = args[0]
    if mode not in ("slice", "rgbd_tum"):
        sys.exit(__doc__)
    threads = [int(x) for x in args[args.index("--threads") + 1].split(",")]
    ops = args[args.index("--ops") + 1] if "--ops" in args else ""
    with tempfile.TemporaryDirectory() as tmp:
        inputs = ""
        if mode == "slice":
            inputs = os.path.join(tmp, "slice_inputs.pkl")
            _slice_inputs(inputs)
        env = dict(os.environ, OMP_NUM_THREADS="8")
        cmd = [sys.executable, os.path.abspath(__file__), "--child", mode]
        results, procs = [], []
        for n in threads:
            procs.append(subprocess.Popen(
                cmd + [str(n), inputs, ops and f"{ops}.t{n}",
                       "1" if "--fixed-order" in args else "0"], env=env,
                stdout=subprocess.PIPE, text=True))
            if len(procs) == 2 or n == threads[-1]:
                for p in procs:
                    out = p.communicate()[0].strip().splitlines()
                    if p.returncode or not out:
                        sys.exit("a run failed (exit %d)" % p.returncode)
                    print(out[-1], flush=True)
                    results.append(json.loads(out[-1]))
                procs = []
    print(json.dumps(dict(mode=mode, threads=threads,
                          bit_equal=len({r["digest"] for r in results}) == 1)))


if __name__ == "__main__":
    main()
