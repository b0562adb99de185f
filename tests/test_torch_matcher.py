"""Parity of the port's matcher (openmavis_tpu_torch/frontend/matcher.py and
the kernel module matcher_cuda.py) with the JAX reference on the CPU.

On CPU tensors `matcher_cuda.masked_best2_fused` and
`matcher_cuda.projection_best2` run their plain versions; these must equal
the TPU kernel run in the Pallas interpreter and the XLA `masked_best2`
EXACTLY (integer outputs, tolerance 0). The CUDA kernels themselves are
held against the same plain versions on the card by chip_smoke.py (this
tree's tests import jax, which the GPU machine lacks). The last test holds
the port's rule that the card, not the CPU, is the default device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import matcher as jm
from openmavis_tpu.frontend import matcher_pallas as jmp
from openmavis_tpu_torch.frontend import matcher as tm
from openmavis_tpu_torch.frontend import matcher_cuda as tmc


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread per test
    worker keeps the files of the suite from oversubscribing the machine
    when they run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _desc(rng, n):
    return (rng.rand(n, 256) > 0.5).astype(np.int8)


def _case(name):
    if name == "96x200":
        rng = np.random.RandomState(0)
        return _desc(rng, 96), _desc(rng, 200), rng.rand(96, 200) > 0.3
    if name == "130x517":
        rng = np.random.RandomState(1)
        return _desc(rng, 130), _desc(rng, 517), rng.rand(130, 517) > 0.5
    if name == "all_masked":
        return (np.zeros((64, 256), np.int8), np.ones((64, 256), np.int8),
                np.zeros((64, 64), bool))
    if name == "tie_break":
        rng = np.random.RandomState(2)
        d1 = _desc(rng, 8)
        mask = np.ones((8, 32), bool)
        mask[:, :3] = False
        return d1, np.tile(d1[:1], (32, 1)), mask
    raise KeyError(name)


CASES = ["96x200", "130x517", "all_masked", "tie_break"]


@pytest.mark.parametrize("name", CASES)
def test_masked_best2_fused_exact(name):
    d1, d2, mask = _case(name)
    pen = np.where(mask, 0.0, 2.0 * jmp.INVALID).astype(np.float32)
    ref_k = jmp.masked_best2_fused(jnp.asarray(d1), jnp.asarray(d2),
                                   jnp.asarray(pen), interpret=True)
    ref_x = jm.masked_best2(jm.hamming_matrix(jnp.asarray(d1),
                                              jnp.asarray(d2)),
                            jnp.asarray(mask))
    before = tmc.launch_count()
    got = tmc.masked_best2_fused(torch.as_tensor(d1), torch.as_tensor(d2),
                                 torch.as_tensor(mask))
    assert tmc.launch_count() == before      # CPU tensors never launch
    for g, rk, rx in zip(got, ref_k, ref_x):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(g.numpy(), np.asarray(rx))
    if name == "tie_break":
        assert int(got[0][0]) == 3 and int(got[1][0]) == 0


def test_transposed_mask_strides():
    """The mutual pass hands the kernel module mask.T (a strided view)."""
    d1, d2, mask = _case("130x517")
    m = torch.as_tensor(mask)
    got = tmc.masked_best2_fused(torch.as_tensor(d2), torch.as_tensor(d1),
                                 m.T)
    ref = jm.masked_best2(jm.hamming_matrix(jnp.asarray(d2),
                                            jnp.asarray(d1)),
                          jnp.asarray(mask.T))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_wrapper_rejects_bad_inputs():
    d = torch.zeros((4, 256), dtype=torch.int8)
    with pytest.raises(TypeError):
        tmc.masked_best2_fused(d, d, torch.zeros((4, 4)))
    with pytest.raises(ValueError):
        tmc.masked_best2_fused(d, d, torch.zeros((4, 5), dtype=torch.bool))
    with pytest.raises(ValueError):         # mixed devices
        tmc.masked_best2_fused(d, d, torch.zeros((4, 4), dtype=torch.bool,
                                                 device="meta"))
    # the launch itself takes CUDA tensors only: it raises, never falls back
    words = torch.zeros((4, 8), dtype=torch.int32)
    before = tmc.launch_count()
    with pytest.raises(ValueError):
        tmc.launch_packed(words, words, torch.ones((4, 4), dtype=torch.bool))
    assert tmc.launch_count() == before


def _pair(seed, n, m, flip=0.15):
    """Descriptors with planted near-duplicates so matches exist."""
    rng = np.random.RandomState(seed)
    d2 = _desc(rng, m)
    src = rng.randint(0, m, n)
    noise = rng.rand(n, 256) < flip
    d1 = np.where(noise, 1 - d2[src], d2[src]).astype(np.int8)
    v1 = rng.rand(n) > 0.1
    v2 = rng.rand(m) > 0.1
    return d1, v1, d2, v2


@pytest.mark.parametrize("mutual", [True, False])
def test_match_nn_exact(mutual):
    d1, v1, d2, v2 = _pair(3, 200, 150)
    ref = jm.match_nn(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2),
                      jnp.asarray(v2), max_dist=64, ratio=0.85,
                      mutual=mutual)
    got = tm.match_nn(torch.as_tensor(d1), torch.as_tensor(v1),
                      torch.as_tensor(d2), torch.as_tensor(v2),
                      max_dist=64, ratio=0.85, mutual=mutual)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int((got[0] >= 0).sum()) > 20


def test_match_projection_and_dedup_exact():
    rng = np.random.RandomState(5)
    N, M = 300, 128
    d1, v1, d2, v2 = _pair(6, N, M, flip=0.2)
    feat_xy = (rng.rand(M, 2) * [320, 240]).astype(np.float32)
    proj = (rng.rand(N, 2) * [320, 240]).astype(np.float32)
    # half of the queries project next to the feature they copy
    near = rng.randint(0, M, N // 2)
    proj[:N // 2] = feat_xy[near] + rng.randn(N // 2, 2).astype(
        np.float32) * 3
    flip = rng.rand(N // 2, 256) < 0.15
    d1[:N // 2] = np.where(flip, 1 - d2[near], d2[near])
    lvl_f = rng.randint(0, 8, M).astype(np.int32)
    lvl_q = rng.randint(0, 8, N).astype(np.int32)
    lvl_q[:N // 2] = np.clip(lvl_f[near] + rng.randint(-1, 2, N // 2), 0, 7)
    args_np = (proj, lvl_q, 15.0, d1, v1, feat_xy, lvl_f, d2, v2)
    ref = jm.match_projection(*[jnp.asarray(a) for a in args_np],
                              max_dist=jm.TH_HIGH, ratio=0.9)
    got = tm.match_projection(*[torch.as_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args_np], max_dist=tm.TH_HIGH,
        ratio=0.9)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # window + level masks on their own
    np.testing.assert_array_equal(
        tm.window_mask(torch.as_tensor(proj), torch.as_tensor(feat_xy),
                       torch.as_tensor(np.full(N, 9.0, np.float32))).numpy(),
        np.asarray(jm.window_mask(jnp.asarray(proj), jnp.asarray(feat_xy),
                                  jnp.full((N,), 9.0))))
    dd_ref = jm.dedup_targets(ref[0], ref[1], M)
    dd = tm.dedup_targets(got[0], got[1], M)
    np.testing.assert_array_equal(dd.numpy(), np.asarray(dd_ref))
    assert int((dd >= 0).sum()) > 10


def test_masked_argmin_and_hamming_exact():
    d1, _, d2, _ = _pair(7, 40, 70)
    mask = np.random.RandomState(8).rand(40, 70) > 0.4
    hj = jm.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2))
    ht = tm.hamming_matrix(torch.as_tensor(d1), torch.as_tensor(d2))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    for g, r in zip(tm.masked_argmin(ht, torch.as_tensor(mask)),
                    jm.masked_argmin(hj, jnp.asarray(mask))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_rotation_histogram_filter_exact():
    rng = np.random.RandomState(9)
    n = 300
    a1 = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    # two dominant rotations plus uniform outliers
    rot = np.where(rng.rand(n) < 0.5, 0.3, -1.2).astype(np.float32)
    a2 = a1 - rot + rng.normal(0, 0.02, n).astype(np.float32)
    a2[::5] = rng.uniform(-np.pi, np.pi, len(a2[::5]))
    valid = rng.rand(n) > 0.1
    got = tm.rotation_histogram_filter(torch.as_tensor(a1),
                                       torch.as_tensor(a2),
                                       torch.as_tensor(valid))
    ref = jm.rotation_histogram_filter(jnp.asarray(a1), jnp.asarray(a2),
                                       jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < int(valid.sum())


# ---------------------------------------------------------------------------
# projection_best2: the factor form (window, level and validity tested per
# pair from O(N + M) factors). On the CPU the wrapper takes its plain
# version, which must equal the reference's mask route EXACTLY.
# ---------------------------------------------------------------------------

def _proj_case(name):
    """(proj_xy, pred_level, radius, d_query, valid_query, feat_xy,
    feat_level, feat_desc, feat_valid) as numpy, radius a float or [N]."""
    seeds = dict(scalar_radius=20, per_row_radius=21, window_edge=22,
                 nan_inf=23, all_queries_invalid=24,
                 all_features_invalid=25, n1=26, m_ragged=27)
    rng = np.random.RandomState(seeds[name])
    n, m = {"n1": (1, 64), "m_ragged": (90, 77),
            "window_edge": (64, 64)}.get(name, (150, 96))
    size = np.array([160.0, 120.0], np.float32)
    feat_xy = (rng.rand(m, 2) * size).astype(np.float32)
    proj = (rng.rand(n, 2) * size).astype(np.float32)
    lvl_f = rng.randint(0, 8, m).astype(np.int32)
    lvl_q = rng.randint(0, 8, n).astype(np.int32)
    d2 = _desc(rng, m)
    src = rng.randint(0, m, n)
    d1 = np.where(rng.rand(n, 256) < 0.15, 1 - d2[src], d2[src]).astype(
        np.int8)
    vq = rng.rand(n) > 0.2
    vf = rng.rand(m) > 0.1
    radius = 30.0
    if name == "per_row_radius":
        radius = rng.uniform(5.0, 60.0, n).astype(np.float32)
    elif name == "window_edge":
        # integer coordinates; query i sits exactly `radius` from feature
        # i (rows < 32: not admitted, the compare is strict) or half a
        # pixel inside (admitted); levels 3 apart leave no other candidate
        feat_xy = np.floor(feat_xy)
        proj = feat_xy.copy()
        proj[:32, 0] += 30.0
        proj[32:, 1] -= 29.5
        lvl_f = lvl_q = (np.arange(64) * 3).astype(np.int32)
        vq[:] = True
        vf[:] = True
    elif name == "nan_inf":
        proj[::3, 0] = np.nan
        proj[1::7, 1] = np.inf
        proj[2::11, 0] = -np.inf
    elif name == "all_queries_invalid":
        vq[:] = False
    elif name == "all_features_invalid":
        vf[:] = False
    elif name == "n1":
        vq[:] = True
        proj[0] = feat_xy[5] + 1.0
        lvl_q[0] = lvl_f[5]
    return proj, lvl_q, radius, d1, vq, feat_xy, lvl_f, d2, vf


PROJ_CASES = ["scalar_radius", "per_row_radius", "window_edge", "nan_inf",
              "all_queries_invalid", "all_features_invalid", "n1",
              "m_ragged"]


def _to(args, conv):
    return [conv(a) if isinstance(a, np.ndarray) else a for a in args]


@pytest.mark.parametrize("name", PROJ_CASES)
def test_projection_best2_exact(name):
    args = _proj_case(name)
    proj, lq, radius, d1, vq, feat, lf, d2, vf = _to(args, jnp.asarray)
    mask = (vq[:, None] & vf[None, :] & jm.window_mask(proj, feat, radius)
            & jm.level_mask(lq, lf))
    ref = jm.masked_best2(jm.hamming_matrix(d1, d2), mask)
    before = tmc.launch_count()
    got = tmc.projection_best2(*_to(args, torch.as_tensor))
    assert tmc.launch_count() == before      # CPU tensors never launch
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    hit = np.asarray(ref[1]) < 300
    if name == "window_edge":
        assert not hit[:32].any() and hit[32:].all()
    elif name.startswith("all_"):
        assert not hit.any() and not np.asarray(ref[0]).any()
    else:
        assert hit.any()
    if name == "nan_inf":
        assert not hit[::3].any()


@pytest.mark.parametrize("name", PROJ_CASES)
def test_match_projection_exact(name):
    args = _proj_case(name)
    ref = jm.match_projection(*_to(args, jnp.asarray), max_dist=jm.TH_HIGH,
                              ratio=0.9)
    got = tm.match_projection(*_to(args, torch.as_tensor),
                              max_dist=tm.TH_HIGH, ratio=0.9)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_projection_best2_rejects_bad_inputs():
    """Wrong devices, dtypes and shapes raise before any dispatch: the
    wrapper never falls back to the plain version for them."""
    good = _to(_proj_case("scalar_radius"), torch.as_tensor)
    before = tmc.launch_count()
    tmc.projection_best2(*good)
    for i in (0, 1, 3, 4, 5, 6, 7, 8):          # mixed devices
        bad = list(good)
        bad[i] = bad[i].to("meta")
        with pytest.raises(ValueError):
            tmc.projection_best2(*bad)
    bad = list(good)
    bad[2] = torch.full((good[0].shape[0],), 30.0, device="meta")
    with pytest.raises(ValueError):
        tmc.projection_best2(*bad)
    for i, dtype in ((0, torch.float64), (1, torch.int64), (3, torch.uint8),
                     (4, torch.int32), (5, torch.float16), (6, torch.int16),
                     (7, torch.float32), (8, torch.uint8)):
        bad = list(good)
        bad[i] = bad[i].to(dtype)
        with pytest.raises(TypeError):
            tmc.projection_best2(*bad)
    for i in (0, 1, 3, 4, 5, 6, 7, 8):          # one row short
        bad = list(good)
        bad[i] = bad[i][:-1]
        with pytest.raises(ValueError):
            tmc.projection_best2(*bad)
    bad = list(good)
    bad[2] = torch.full((3,), 30.0)             # radius neither scalar nor [N]
    with pytest.raises(ValueError):
        tmc.projection_best2(*bad)
    with pytest.raises(TypeError):              # mask form: planes are int8
        tmc.masked_best2_fused(good[3].to(torch.uint8), good[7],
                               torch.ones((150, 96), dtype=torch.bool))
    assert tmc.launch_count() == before


# ---------------------------------------------------------------------------
# The card is the default device of every entry point that takes `device`.
# ---------------------------------------------------------------------------

def _device_entry_points():
    from openmavis_tpu_torch import convert, scene
    from openmavis_tpu_torch.frontend import extractor as tex
    from openmavis_tpu_torch.imu import preintegration as tpre
    from openmavis_tpu_torch.pipeline import streaming_vi as tsv
    from openmavis_tpu_torch.slam_map import map_state as tms

    kw = scene.bench_config_kwargs(4, max_kf=4, max_mp=64)
    kw.update(img_w=64, img_h=48, obs_cap=256)
    cfg = tsv.VIStreamConfig(orb=tex.OrbConfig(n_features=16, n_levels=2),
                             **kw)
    rig_np = scene.build_rig("kb8")
    noise = tpre.ImuNoise.from_sigmas(*scene.NOISE_SIGMAS, device="cpu")
    carry = convert.carry_to_numpy(tsv.init_carry(cfg, 0, device="cpu"))
    amap = convert.map_to_numpy(tms.allocate(2, 8, 16, device="cpu"))
    pre = convert.pre_to_numpy(tpre.chain_allocate(2, device="cpu"))

    return {
        "tracker": lambda **k: tsv.StreamingVITracker(
            convert.rig_from_numpy(rig_np, device="cpu"), cfg, noise,
            **k).device,
        "tracker_default_noise": lambda **k: tsv.StreamingVITracker(
            convert.rig_from_numpy(rig_np, device="cpu"), cfg,
            **k).noise.nga.device,
        "init_carry": lambda **k: tsv.init_carry(cfg, 0, **k).p.device,
        "allocate": lambda **k: tms.allocate(2, 8, 16, **k).kf_R.device,
        "chain_allocate": lambda **k: tpre.chain_allocate(3, **k).dR.device,
        "from_sigmas": lambda **k: tpre.ImuNoise.from_sigmas(
            *scene.NOISE_SIGMAS, **k).nga.device,
        "rig_from_numpy": lambda **k: convert.rig_from_numpy(
            rig_np, **k).params.device,
        "noise_from_numpy": lambda **k: convert.noise_from_numpy(
            convert.noise_to_numpy(noise), **k).nga.device,
        "pre_from_numpy": lambda **k: convert.pre_from_numpy(
            pre, **k).dR.device,
        "map_from_numpy": lambda **k: convert.map_from_numpy(
            amap, **k).kf_R.device,
        "carry_from_numpy": lambda **k: convert.carry_from_numpy(
            carry, **k).p.device,
    }


DEVICE_ENTRY_POINTS = ["tracker", "tracker_default_noise", "init_carry",
                       "allocate", "chain_allocate", "from_sigmas",
                       "rig_from_numpy", "noise_from_numpy",
                       "pre_from_numpy", "map_from_numpy",
                       "carry_from_numpy"]


@pytest.mark.parametrize("entry", DEVICE_ENTRY_POINTS)
def test_default_device_is_the_card(entry):
    """With no `device`, an entry point builds its state on the current
    CUDA device, and raises a RuntimeError that names the missing card
    where there is none; it runs on the CPU only when asked to."""
    make = _device_entry_points()[entry]
    assert make(device="cpu").type == "cpu"
    if torch.cuda.is_available():
        assert make().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("name", ["96x200", "sparse_rows", "all_masked"])
def test_cpu_route_equals_the_plain_version(name):
    """On the CPU the wrappers search only the rows that can match; the
    result equals the plain version's over every row, exactly."""
    if name == "sparse_rows":
        rng = np.random.RandomState(3)
        d1, d2 = _desc(rng, 300), _desc(rng, 120)
        mask = rng.rand(300, 120) > 0.7
        mask[rng.rand(300) > 0.1] = False          # most rows empty
    else:
        d1, d2, mask = _case(name)
    d1, d2, mask = (torch.as_tensor(x) for x in (d1, d2, mask))
    for a, b in ((tmc.masked_best2_fused(d1, d2, mask),
                  tmc.masked_best2_plain(d1, d2, mask)),
                 (tmc.masked_best2_fused(d2, d1, mask.T),
                  tmc.masked_best2_plain(d2, d1, mask.T))):
        for g, r in zip(a, b):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), r.numpy())
    for pname in PROJ_CASES:
        args = _to(_proj_case(pname), torch.as_tensor)
        if name == "sparse_rows":
            args[4] = args[4] & (torch.arange(args[4].shape[0]) % 5 == 0)
        for g, r in zip(tmc.projection_best2(*args),
                        tmc.projection_best2_plain(*args)):
            np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_best_per_keyframe_cpu_route():
    """`tracking._best_per_keyframe` on the CPU searches only keyframes
    with an admitted feature; the result equals the dense product's."""
    from openmavis_tpu_torch.pipeline import tracking
    from openmavis_tpu_torch.slam_map import map_state as ms
    g = torch.Generator().manual_seed(0)
    m = ms.allocate(8, 64, 128, device="cpu")
    m = m._replace(kf_desc=(torch.rand(8, 64, 256, generator=g)
                            < 0.5).to(torch.int8))
    desc = (torch.rand(30, 256, generator=g) < 0.5).to(torch.int8)
    for empty in (False, True):
        tv = torch.rand(8, 64, generator=g) < 0.5
        tv[3] = tv[5] = False
        if empty:
            tv[:] = False
        got = tracking._best_per_keyframe(m, desc, tv)
        dense = tm.hamming_matrix(desc, m.kf_desc.reshape(-1, 256))
        ref = torch.where(tv[None], dense.reshape(-1, 8, 64),
                          1 << 20).min(dim=2).values
        assert got.dtype == ref.dtype
        assert torch.equal(got, ref)


def test_nearest_old_cpu_route():
    """`tracking._nearest_old` over the old landmarks only (the CPU route
    of `fuse_new_landmarks`) equals the search over the whole slab where
    a candidate exists, ties included."""
    from openmavis_tpu_torch.pipeline import tracking
    from openmavis_tpu_torch.slam_map import map_state as ms
    g = torch.Generator().manual_seed(1)
    M = 400
    m = ms.allocate(4, 16, M, device="cpu")
    pos = torch.rand(M, 3, generator=g) * 4.0
    pos[200:260] = pos[100:160] + 0.01           # near duplicates
    pos[300] = pos[301] = pos[120] + 0.005       # a tie between two olds
    desc = (torch.rand(M, 256, generator=g) < 0.5).to(torch.int8)
    desc[200:260] = desc[100:160]
    desc[300] = desc[301] = desc[120]
    valid = torch.rand(M, generator=g) < 0.8
    valid[100:160] = valid[300] = valid[301] = True
    first = torch.zeros(M, dtype=torch.int32)
    first[200:260] = 3
    first[120] = 3
    m = m._replace(mp_pos=pos, mp_desc=desc, mp_valid=valid,
                   mp_first_kf=first)
    old_mask = valid & (first != 3)
    new_ids = torch.nonzero(valid & (first == 3))[:, 0]
    for old_ids in (torch.nonzero(old_mask)[:, 0],
                    torch.zeros(0, dtype=torch.int64)):
        mask = old_mask if old_ids.numel() else torch.zeros_like(old_mask)
        bi, bv = tracking._nearest_old(m, new_ids, mask, old_ids, 0.02, 40)
        ri, rv = tracking._nearest_old(m, new_ids, mask, None, 0.02, 40)
        assert bi.dtype == ri.dtype == torch.int32
        assert torch.equal(bv, rv)
        hit = rv < tm._INVALID
        assert torch.equal(bi[hit], ri[hit])
        assert (int(hit.sum()) > 40) == bool(old_ids.numel())
