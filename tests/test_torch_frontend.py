"""Parity of the port's ORB frontend with the JAX reference on the CPU, on
one rendered frame of the flagship scene (4x KannalaBrandt8 at 640x480)
at the flagship OrbConfig (512 features, 8 levels).

Tolerances and why:
* pyramid level 0 is the image itself (exact). Levels 1-3 agree to 1e-4
  intensity (float32 sums in another order). Levels 4-7 agree to 5e-4
  (2e-6 of the 0-255 range): XLA's fused loops round the resize weights'
  sample positions differently in a few columns (with or without a fused
  multiply-add), which moves a few pixels by up to ~2e-4.
* FAST keypoints, levels and validity: exact.
* descriptor bits: a bit may flip only where its two bilinear samples tie
  (flat background, float32 rounding): every flip must have
  |v0 - v1| < 2e-5, a few float32 ulps at the rendered intensities.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.frontend import fast as jfast
from openmavis_tpu.frontend import orb as jorb
from openmavis_tpu.frontend import pyramid as jpy
from openmavis_tpu.slam_map import bow as jbow
from openmavis_tpu_torch import scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.frontend import fast as tfast
from openmavis_tpu_torch.frontend import orb as torb
from openmavis_tpu_torch.frontend import pyramid as tpy
from openmavis_tpu_torch.io import synthetic
from openmavis_tpu_torch.slam_map import bow as tbow


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread per test
    worker keeps the files of the suite from oversubscribing the machine
    when they run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CAMS = (0, 2)          # a front camera and a side camera


@pytest.fixture(scope="module")
def frame():
    rig_np = scene.build_rig("kb8")
    R_wb, t_wb = synthetic.orbit_trajectory(2, radius=6.0, frac=0.01)
    imgs = scene.render_rig_sequence(rig_np, R_wb[:1], t_wb[:1])[0]
    return np.clip(imgs, 0, 255).astype(np.uint8)[list(CAMS)].astype(
        np.float32)


@pytest.fixture(scope="module")
def both(frame):
    cfg_j = jex.OrbConfig(n_features=512, n_levels=8)
    cfg_t = tex.OrbConfig(n_features=512, n_levels=8)
    fj = jax.jit(lambda im: jex.extract_multicam(im, cfg_j))(
        jnp.asarray(frame))
    ft = tex.extract_multicam(torch.as_tensor(frame), cfg_t)
    return fj, ft, cfg_t


def test_pyramid_levels(frame):
    lj = jax.jit(lambda im: jpy.build_pyramid(im, 8, 1.2))(
        jnp.asarray(frame[0]))
    lt = tpy.build_pyramid(torch.as_tensor(frame[0]), 8, 1.2)
    for lv, (a, b) in enumerate(zip(lj, lt)):
        assert tuple(a.shape) == tuple(b.shape)
        err = np.abs(np.asarray(a) - b.numpy()).max()
        assert err <= (0.0 if lv == 0 else 1e-4 if lv <= 3 else 5e-4), \
            (lv, err)


def test_blur_and_fast_score(frame):
    img = frame[0]
    np.testing.assert_allclose(
        tpy.blur(torch.as_tensor(img)).numpy(),
        np.asarray(jpy.blur(jnp.asarray(img))), rtol=0, atol=1e-4)
    s_j = np.asarray(jfast.fast_score_map(jnp.asarray(img), 15.0))
    s_t = tfast.fast_score_map(torch.as_tensor(img), 15.0).numpy()
    # integer image, integer threshold: the score sums are exact
    np.testing.assert_array_equal(s_t, s_j)


@pytest.mark.parametrize("th", [7.0, 15.0, 20.0])
def test_fast_cpu_route_equals_the_dense_form(frame, th):
    """On the CPU `_score_from_diff` packs the arc words plane by plane
    and sums the excess over the corners only; its score equals the
    dense form's (the route CUDA tensors take) exactly: on the rig's
    frame (both cameras as one batch), on a resampled pyramid level and
    on float noise whose pixel count leaves a tail off torch's vector
    width."""
    rng = np.random.default_rng(5)
    level = tpy.build_pyramid(torch.as_tensor(frame[0]), 3, 1.2)[2]
    for img in (torch.as_tensor(frame), level[None],
                torch.as_tensor(rng.random((2, 97, 131)).astype(np.float32)
                                * 255)):
        diff = tfast._ring(img) - img[None]
        inside = tfast._inside_mask(*img.shape[-2:], 16, img.device)
        got = tfast._score_from_diff(diff, th, inside)
        ref = tfast._score_from_diff_dense(diff, th, diff > th, diff < -th,
                                           inside)
        assert int((ref > 0).sum()) > 0
        assert torch.equal(got, ref)


def _sample_dense(patches_blur, sx, sy):
    """Bilinear samples [K, 512] with tent weights over every lane and
    row, one batched product (the form `orb._sample` replaces)."""
    P = patches_blur.shape[1]
    lanes = torch.arange(torb._PW, dtype=sx.dtype)
    rows_ = torch.arange(P, dtype=sy.dtype)
    a = torch.bmm(torb._tent(sx[..., None], lanes),
                  patches_blur.transpose(1, 2))              # [K, 512, P]
    return torch.sum(a * torb._tent(sy[..., None], rows_), dim=-1)


def test_patch_sampling_cpu_route_equals_the_dense_form():
    """`patch_values`' bilinear samples (two live lanes and rows) equal
    the dense form's exactly, with flat patches (ties), sample points on
    integer lanes and rows and at both clamps."""
    rng = np.random.default_rng(6)
    K, P = 300, 2 * torb.PATCH_RADIUS + 1
    pb = torch.as_tensor(rng.random((K, P, torb._PW)).astype(np.float32)
                         * 255)
    pb[:100] = torch.round(pb[:100] / 64) * 64
    sx = torch.as_tensor(rng.uniform(0, torb._PW - 1.001, (K, 512)).astype(
        np.float32))
    sy = torch.as_tensor(rng.uniform(0, P - 1.001, (K, 512)).astype(
        np.float32))
    for s, hi in ((sx, torb._PW - 1.001), (sy, P - 1.001)):
        s[:, :20] = torch.floor(s[:, :20])
        s[:, 20:30] = 0.0
        s[:, 30:40] = hi
    got = torb._sample(pb, sx, sy)
    assert torch.equal(got, _sample_dense(pb, sx, sy))
    assert got.shape == (K, 512)


def test_keypoints_exact(both):
    fj, ft, _ = both
    np.testing.assert_array_equal(ft.xy.numpy(), np.asarray(fj.xy))
    np.testing.assert_array_equal(ft.level.numpy(), np.asarray(fj.level))
    np.testing.assert_array_equal(ft.valid.numpy(), np.asarray(fj.valid))
    np.testing.assert_array_equal(ft.sigma2.numpy(), np.asarray(fj.sigma2))
    assert ft.level.dtype == torch.int32 and ft.desc.dtype == torch.int8
    assert int(ft.valid.sum()) > 800
    # responses and angles: float32 sums in another order
    np.testing.assert_allclose(ft.response.numpy(), np.asarray(fj.response),
                               rtol=1e-5, atol=0.05)
    np.testing.assert_allclose(ft.angle.numpy(), np.asarray(fj.angle),
                               rtol=0, atol=1e-3)


def test_descriptor_bits(frame, both):
    fj, ft, cfg = both
    dj = np.asarray(fj.desc)
    dt = ft.desc.numpy()
    flips = dj != dt
    # the port's own sample values: a flipped bit must be a tie
    d = tex.detect_multicam(torch.as_tensor(frame), cfg)
    kp = d["kp"].reshape(-1, 2)
    patches, _, _ = torb.extract_patches(d["stack"], d["lv_all"], kp)
    angles = torb.patch_angles(patches)
    pb, ox, oy = torb.extract_patches(d["blurred"], d["lv_all"], kp)
    vals = torb.patch_values(pb, kp, ox, oy, angles).numpy()
    gap = np.abs(vals[..., 0] - vals[..., 1]).reshape(dt.shape)
    assert flips.mean() < 0.02, flips.mean()
    if flips.any():
        assert gap[flips].max() < 2e-5, gap[flips].max()
    # level-0 keypoints sample the unresized image: no ties flip there
    lvl0 = ft.level.numpy() == 0
    assert not flips[lvl0].any()


def test_pattern_pack_and_bow_identical(both):
    fj, ft, _ = both
    np.testing.assert_array_equal(torb.make_pattern(), jorb.make_pattern())
    np.testing.assert_array_equal(torb._PATTERN, jorb._PATTERN)
    desc = np.array(fj.desc[0])
    packed_j = np.asarray(jorb.pack_bits(jnp.asarray(desc)))
    packed_t = torb.pack_bits(torch.as_tensor(desc))
    assert packed_t.dtype == torch.int32
    np.testing.assert_array_equal(packed_t.numpy().view(np.uint32),
                                  packed_j)
    np.testing.assert_array_equal(torb.unpack_bits(packed_t).numpy(), desc)
    valid = np.array(fj.valid[0])
    np.testing.assert_array_equal(tbow._POS, jbow._POS)
    np.testing.assert_array_equal(
        tbow.histogram(torch.as_tensor(desc), torch.as_tensor(valid)).numpy(),
        np.asarray(jbow.histogram(jnp.asarray(desc), jnp.asarray(valid))))
