"""A fixed summation order makes the port's CPU sums independent of
torch's intra-op thread count (`scripts/thread_parity.py`'s
`fixed_order_sums`).

A CPU BLAS splits the sums of a long GEMM or GEMV over its threads and
adds the parts in another order at each count, so a float32 run of the
port parts in its last bits between one thread and eight. Hashing every
op of two runs (`scripts/thread_parity.py`) found the sites, four:
* `optim/ba.py::_schur_solve`: the Schur complement `Hpp - Y A^T` and
  the reduced right-hand side `gp - Y gl`;
* `optim/pose_opt.py::_normal_eq`: the pose's `H` and `g`.
The port keeps the BLAS's products there (the exact parity tests were
measured on the BLAS's orders, ROADMAP "Recorded differences");
`fixed_order_sums()` wraps the two functions at run time and routes the
four sums through the script's `gram` and `matvec`, which sum in float64
in a fixed order.

Each site runs at 1, 2 and 4 threads on numpy-seeded inputs inside the
block and must be bit-equal to its run on one thread. The forms are
also held to float64 (relative 1e-5 of the largest term), `_schur_solve`
to the JAX reference's on the same inputs (1e-4 of the largest step:
float32 sums in another order), and outside the block the port's own
functions are back, bit for bit.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.optim import ba as jba
from openmavis_tpu_torch.optim import ba as tba
from openmavis_tpu_torch.optim import pose_opt as tpo

_spec = importlib.util.spec_from_file_location(
    "thread_parity", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "thread_parity.py"))
tp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tp)

THREADS = [1, 2, 4]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread per test worker, as in the other test_torch_*
    files; each test sets its own count and puts this one back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _at(threads, fn):
    """fn() on `threads` intra-op threads inside `fixed_order_sums`, then
    back to one. `fn` looks the port's functions up when it runs, so it
    calls the wrapped ones."""
    torch.set_num_threads(threads)
    try:
        with tp.fixed_order_sums():
            return fn()
    finally:
        torch.set_num_threads(1)


def _bits_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


# p, q, L: the elementwise form (p * q * L <= 2^20) and the chunked GEMMs,
# with L not a multiple of the chunk
GRAM_SHAPES = [(6, 6, 4000), (24, 24, 1500), (120, 120, 1501)]


def _gram_inputs(p, q, L):
    rng = np.random.default_rng(p * 1000 + L)
    X = torch.as_tensor(rng.standard_normal((p, L)).astype(np.float32))
    Z = torch.as_tensor(rng.standard_normal((q, L)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal(L).astype(np.float32))
    return X, Z, v


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("shape", GRAM_SHAPES)
def test_gram_matvec(threads, shape):
    X, Z, v = _gram_inputs(*shape)
    # strided views too, as `_normal_eq`'s route passes them
    Xt = X.T.contiguous().T
    one = _at(1, lambda: (tp.gram(X, Z), tp.matvec(X, v)))
    _bits_equal(one, _at(threads, lambda: (tp.gram(Xt, Z),
                                           tp.matvec(Xt, v))))
    X64, Z64, v64 = X.double(), Z.double(), v.double()
    want = (X64 @ Z64.T, X64 @ v64)
    scale = (X64.abs() @ Z64.abs().T).max(), (X64.abs() @ v64.abs()).max()
    for got, w, s in zip(one, want, scale):
        assert float((got.double() - w).abs().max()) <= 1e-5 * float(s)


@functools.lru_cache(maxsize=None)
def _schur_case(K, D, M):
    """The inputs and the JAX reference's solve, once per shape."""
    *arrays, lam, fixed = _schur_inputs(K, D, M)
    ref = jax.jit(jba._schur_solve, static_argnums=7)(
        *(jnp.asarray(a) for a in arrays), jnp.float32(lam),
        jnp.asarray(fixed), D)
    return arrays, lam, fixed, [np.asarray(x) for x in ref]


def _schur_inputs(K, D, M, seed=7):
    """A damped BA system as the window BA builds it: each landmark seen
    by three keyframes, Hll and the reduced camera system positive
    definite."""
    rng = np.random.default_rng(seed)
    Hpl = np.zeros((K, D, M, 3))
    for m in range(M):
        for k in rng.choice(K, 3, replace=False):
            Hpl[k, :, m, :] = rng.standard_normal((D, 3))
    B = rng.standard_normal((M, 3, 3))
    Hll = B @ B.transpose(0, 2, 1) + 3.0 * np.eye(3)
    A = Hpl.reshape(K * D, M * 3)
    Hll_inv = np.zeros((M * 3, M * 3))
    for m in range(M):
        Hll_inv[3 * m:3 * m + 3, 3 * m:3 * m + 3] = np.linalg.inv(Hll[m])
    Hpp = A @ Hll_inv @ A.T + 10.0 * np.eye(K * D)
    gp = rng.standard_normal(K * D)
    gl = rng.standard_normal((M, 3))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return [x.astype(np.float32) if x.dtype != bool else x
            for x in (Hpp, Hpl, Hll, gp, gl)] + [np.float32(1e-2), fixed]


def _schur_args(K, D, M):
    arrays, lam, fixed, ref = _schur_case(K, D, M)
    return [torch.as_tensor(a) for a in arrays] + [
        torch.tensor(lam), torch.as_tensor(fixed), D], ref


# K, D, M: the VI window at the slice test's size and a visual window
SCHUR = [(8, 15, 500), (4, 6, 300)]


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("kdm", SCHUR)
def test_schur_solve(threads, kdm):
    args, ref = _schur_args(*kdm)
    one = _at(1, lambda: tba._schur_solve(*args))
    _bits_equal(one, _at(threads, lambda: tba._schur_solve(*args)))
    for got, want in zip(one, ref):
        tol = 1e-4 * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def _pose_inputs():
    """`_normal_eq` at a frame's size: 2,000 matched observations."""
    rng = np.random.default_rng(3)
    O = 2000
    r = torch.as_tensor(rng.standard_normal((O, 2)).astype(np.float32))
    Jp = torch.as_tensor(100.0 * rng.standard_normal((O, 2, 6))
                         .astype(np.float32))
    w = torch.as_tensor(rng.random(O).astype(np.float32))
    return r, Jp, w


@pytest.mark.parametrize("threads", THREADS)
def test_pose_normal_equations(threads):
    r, Jp, w = _pose_inputs()
    one = _at(1, lambda: tpo._normal_eq(r, Jp, w))
    _bits_equal(one, _at(threads, lambda: tpo._normal_eq(r, Jp, w)))
    Jw = (Jp * w[:, None, None]).double()
    H = torch.einsum("oai,oaj->ij", Jw, Jp.double())
    g = torch.einsum("oai,oa->i", Jw, r.double())
    assert float((one[0].double() - H).abs().max()) <= 1e-5 * float(
        H.abs().max())
    assert float((one[1].double() - g).abs().max()) <= 1e-5 * float(
        torch.einsum("oai,oa->i", Jw.abs(), r.double().abs()).max())


@pytest.mark.parametrize("site", ["schur_8x15x500", "schur_4x6x300",
                                  "normal_eq"])
def test_block_routes_the_sites_and_restores_the_port(site):
    """Inside the block the wrapped function takes each of its sites once
    a call; on exit the port's own function is back and gives the bits it
    gave before the block."""
    if site == "normal_eq":
        args, mod, name = _pose_inputs(), tpo, "_normal_eq"
        want = {tp._NORMAL_EQ_H: 1, tp._NORMAL_EQ_G: 1}
    else:
        kdm = tuple(int(x) for x in site.split("_")[1].split("x"))
        args, mod, name = _schur_args(*kdm)[0], tba, "_schur_solve"
        want = {"gram": 1, "matvec": 1}
    own = getattr(mod, name)
    before = own(*args)
    with tp.fixed_order_sums() as routed:
        assert getattr(mod, name) is not own
        getattr(mod, name)(*args)
    assert routed == want
    assert getattr(mod, name) is own
    _bits_equal(before[:2], own(*args)[:2])
