"""Parity of the port's Atlas (`slam_map/atlas.py`) with the JAX reference
on the CPU: `transform_map`, the host weld `merge_maps` and the device
weld `merge_maps_device` on random numpy maps (a weld that fits, one that
does not, the loop-edge ring carried across and wrapping), the device
form against the host form, the Atlas container and the
`convert.atlas_*` round trip.

Tolerances: integers, indices, masks and counters exact; transformed
floats 1e-5 (float32 rotations and products in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.geometry import lie as jlie
from openmavis_tpu.slam_map import atlas as jatlas
from openmavis_tpu.slam_map import map_state as jms
from openmavis_tpu_torch import convert
from openmavis_tpu_torch.slam_map import atlas as tatlas
from openmavis_tpu_torch.slam_map import map_state as tms

K, F, M = 10, 48, 200


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_map(n_kf, n_mp, seed, edges=(), K=K, F=F, M=M) -> dict:
    """A populated random map as a numpy dict (the reference's dtypes):
    every keyframe and landmark field filled, `edges` (i, j) in the loop
    ring."""
    r = np.random.default_rng(seed)
    m = {k: np.array(v) for k, v in jms.allocate(K, F, M)._asdict().items()}
    R = np.asarray(jlie.so3_exp(jnp.asarray(r.normal(0, 0.5, (K, 3)),
                                            jnp.float32)))
    m.update(
        kf_R=R, kf_t=r.normal(0, 1, (K, 3)), kf_v=r.normal(0, 1, (K, 3)),
        kf_bg=r.normal(0, 0.01, (K, 3)), kf_ba=r.normal(0, 0.1, (K, 3)),
        kf_time=np.arange(K) * 0.25, kf_valid=np.arange(K) < n_kf,
        kf_xy=r.uniform(0, 300, (K, F, 2)),
        kf_desc=r.integers(0, 2, (K, F, 256)),
        kf_level=r.integers(0, 8, (K, F)),
        kf_sigma2=r.uniform(1, 3, (K, F)), kf_cam=r.integers(0, 2, (K, F)),
        kf_feat_valid=r.uniform(size=(K, F)) < 0.8,
        kf_obs=np.where(r.uniform(size=(K, F)) < 0.5,
                        r.integers(0, n_mp, (K, F)), -1),
        kf_bow=r.integers(0, 5, m["kf_bow"].shape),
        mp_pos=r.normal(0, 2, (M, 3)), mp_desc=r.integers(0, 2, (M, 256)),
        mp_normal=r.normal(0, 1, (M, 3)), mp_dmin=r.uniform(0.1, 1, M),
        mp_dmax=r.uniform(2, 10, M), mp_valid=np.arange(M) < n_mp,
        mp_visible=r.integers(0, 9, M), mp_found=r.integers(0, 9, M),
        mp_first_kf=r.integers(0, max(n_kf, 1), M),
        mp_last_kf=r.integers(0, max(n_kf, 1), M),
        n_kf=n_kf, n_mp=n_mp)
    for n, (i, j) in enumerate(edges):
        L = m["loop_i"].shape[0]
        m["loop_i"][n % L], m["loop_j"][n % L] = i, j
        m["loop_valid"][n % L] = True
    m["n_loop"] = len(edges)
    dtypes = {k: np.asarray(v).dtype
              for k, v in jms.allocate(1, 1, 1)._asdict().items()}
    return {k: np.asarray(v, dtypes[k]) for k, v in m.items()}


def _jmap(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _tmap(d):
    return convert.map_from_numpy(d, device="cpu")


def _sim3(seed, s=1.12):
    r = np.random.default_rng(seed)
    R = np.asarray(jlie.so3_exp(jnp.asarray(r.normal(0, 0.4, 3),
                                            jnp.float32)))
    return np.float32(s), R, r.normal(0, 1, 3).astype(np.float32)


def _both(s, R, t):
    return ((jnp.asarray(s), jnp.asarray(R), jnp.asarray(t)),
            (torch.tensor(s), torch.as_tensor(np.array(R)),
             torch.as_tensor(np.array(t))))


def _maps_equal(tm, jm, tol=1e-5, skip=()):
    """Every field: integers and masks exact, floats to `tol`."""
    for name in tms.MapState._fields:
        if name in skip:
            continue
        a, b = convert._np(getattr(tm, name)), np.asarray(getattr(jm, name))
        assert a.dtype == b.dtype, name
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_transform_map():
    d = rand_map(6, 120, 1)
    (js, jR, jt), (ts, tR, tt) = _both(*_sim3(2))
    _maps_equal(tatlas.transform_map(_tmap(d), ts, tR, tt),
                jatlas.transform_map(_jmap(d), js, jR, jt))


# (dst keyframes, dst landmarks, src keyframes, src landmarks, src edges,
# dst edges): a weld that fits, with edges that wrap dst's ring; one whose
# keyframes do not fit; one whose landmarks do not fit
CASES = {
    "fits": (4, 80, 5, 100, [(0, 3), (1, 4), (2, 2)],
             [(0, 1)] * (jms.MAX_LOOP_EDGES - 1)),
    "kf_overflow": (6, 50, 5, 50, [(0, 1)], []),
    "mp_overflow": (3, 120, 4, 100, [], [(0, 2)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_maps_host(case):
    n_kf_d, n_mp_d, n_kf_s, n_mp_s, e_s, e_d = CASES[case]
    dst = rand_map(n_kf_d, n_mp_d, 3, e_d)
    src = rand_map(n_kf_s, n_mp_s, 4, e_s)
    (js, jR, jt), (ts, tR, tt) = _both(*_sim3(5))
    jm, jok = jatlas.merge_maps(_jmap(dst), _jmap(src), js, jR, jt)
    tm, tok = tatlas.merge_maps(_tmap(dst), _tmap(src), ts, tR, tt)
    assert tok is jok is (case == "fits")
    _maps_equal(tm, jm)
    if tok:
        assert int(tm.n_kf) == n_kf_d + n_kf_s
        assert int(tm.n_loop) == len(e_d) + len(e_s)


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_maps_device(case):
    n_kf_d, n_mp_d, n_kf_s, n_mp_s, e_s, e_d = CASES[case]
    dst = rand_map(n_kf_d, n_mp_d, 6, e_d)
    src = rand_map(n_kf_s, n_mp_s, 7, e_s)
    (js, jR, jt), (ts, tR, tt) = _both(*_sim3(8, s=0.93))
    jm, jfits = jatlas.merge_maps_device(_jmap(dst), _jmap(src), js, jR, jt)
    tm, tfits = tatlas.merge_maps_device(_tmap(dst), _tmap(src), ts, tR, tt)
    assert tfits.dtype == torch.bool and tfits.shape == ()
    assert bool(tfits) == bool(jfits) == (case == "fits")
    _maps_equal(tm, jm)
    if not bool(tfits):
        # a weld that does not fit leaves every field of dst as it was
        _maps_equal(tm, _jmap(dst), tol=0)


def test_device_weld_matches_host_weld():
    """The port's device form against its host form on a weld that fits,
    over the fields both write (the device form also appends the
    landmark counters mp_visible and mp_found, as the reference's does)."""
    dst = rand_map(4, 80, 9, [(0, 2)])
    src = rand_map(5, 100, 10, [(1, 3), (0, 4)])
    _, (ts, tR, tt) = _both(*_sim3(11))
    host, ok = tatlas.merge_maps(_tmap(dst), _tmap(src), ts, tR, tt)
    dev, fits = tatlas.merge_maps_device(_tmap(dst), _tmap(src), ts, tR, tt)
    assert ok and bool(fits)
    for name in tms.MapState._fields:
        if name in ("mp_visible", "mp_found"):
            continue
        np.testing.assert_array_equal(convert._np(getattr(dev, name)),
                                      convert._np(getattr(host, name)),
                                      err_msg=name)
    # the appended keyframes' observations point past dst's landmarks
    obs = convert._np(dev.kf_obs)[4:9]
    src_obs = src["kf_obs"][:5]
    np.testing.assert_array_equal(obs, np.where(src_obs >= 0, src_obs + 80,
                                                -1))
    assert [(int(i), int(j)) for i, j, v in zip(dev.loop_i, dev.loop_j,
                                                dev.loop_valid) if v] == \
        [(0, 2), (5, 7), (4, 8)]


def test_atlas_and_round_trip(monkeypatch):
    """create_map allocates on the atlas's device (the card unless told
    the CPU) and makes the new map current; `current_map` reads and writes
    that entry; `convert.atlas_*` carries maps and current both ways with
    every dtype kept."""
    atlas = tatlas.Atlas(device="cpu")
    assert atlas.n_maps() == 0 and atlas.current == -1
    assert atlas.create_map(K, F, M) == 0
    assert atlas.create_map(K, F, M) == 1
    assert atlas.n_maps() == 2 and atlas.current == 1
    assert atlas.current_map.kf_obs.shape == (K, F)
    assert atlas.current_map.kf_obs.device.type == "cpu"
    atlas.current_map = _tmap(rand_map(3, 40, 12))
    assert int(atlas.maps[1].n_kf) == 3 and int(atlas.maps[0].n_kf) == 0
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tatlas.Atlas().create_map(K, F, M)

    d = dict(maps=[rand_map(3, 40, 13), rand_map(5, 90, 14, [(0, 4)])],
             current=0)
    back = convert.atlas_to_numpy(convert.atlas_from_numpy(d, device="cpu"))
    assert back["current"] == 0 and len(back["maps"]) == 2
    for a, b in zip(back["maps"], d["maps"]):
        for k, v in b.items():
            assert a[k].dtype == v.dtype, k
            np.testing.assert_array_equal(a[k], v, err_msg=k)
    # the reference's Atlas laid out the same way
    jat = jatlas.Atlas(maps=[_jmap(m) for m in d["maps"]], current=1)
    tat = convert.atlas_from_numpy(
        dict(maps=[{k: np.asarray(v) for k, v in m._asdict().items()}
                   for m in jat.maps], current=jat.current), device="cpu")
    assert tat.current == 1 and tat.n_maps() == jat.n_maps()
    _maps_equal(tat.current_map, jat.current_map, tol=0)
