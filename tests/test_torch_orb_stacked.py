"""Parity of the port's stacked ORB sampling path (`OrbConfig(sampling=
"stacked")`) with the JAX reference on the CPU: the nine functions of
`openmavis_tpu/frontend/orb.py` it and its tests use, on
tests/test_frontend.py's own scenes, and `extract_multicam` on a
four-camera stack.

Tolerances and why:
* keypoints, levels, validity: exact (the detector is shared with the
  patch path);
* angles: within 1e-4 rad, except at keypoints whose two moments m10 and
  m01 both lie below 1e-3 of the patch sum, where atan2 of two float32
  sums in another order may turn by more. The count of such keypoints is
  asserted in each test: none on tests/test_frontend.py's scenes, one of
  the 1,024 on the four-camera frame;
* descriptor bits: equal but where the two bilinear samples of a bit tie
  to float32 rounding: every flipped bit has a sample gap below 2e-5, as
  the patch path is held (tests/test_torch_frontend.py);
* the port's own patch and stacked paths agree within the reference's
  own bounds for its two paths (tests/test_frontend.py:230-249: angles
  within 1e-3 rad, under 0.5% of the bits differing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmavis_tpu.frontend import extractor as jex
from openmavis_tpu.frontend import orb as jorb
from openmavis_tpu.frontend import pyramid as jpy
from openmavis_tpu_torch import scene
from openmavis_tpu_torch.frontend import extractor as tex
from openmavis_tpu_torch.frontend import orb as torb
from openmavis_tpu_torch.io import synthetic

ANGLE_TOL = 1e-4
TIE_GAP = 2e-5
FLAT_MOMENT = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread per test worker (the port's CPU ops here are
    small), as in the other test_torch_* files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def random_texture(key, h=192, w=192):
    """tests/test_frontend.py's smooth random texture, as numpy."""
    base = jax.random.uniform(key, (h // 8, w // 8)) * 255.0
    return np.asarray(jax.image.resize(base, (h, w), "bilinear"))


def stacked_fixture():
    """tests/test_frontend.py:216-228 (TestPatchFormulation._fixture)."""
    rng = np.random.default_rng(7)
    L, h, w = 3, 120, 160
    stack = rng.uniform(0, 255, (L, h, w)).astype(np.float32)
    K = 64
    lv = rng.integers(0, L, K).astype(np.int32)
    xy = np.stack([rng.uniform(16, w - 17, K), rng.uniform(16, h - 17, K)],
                  axis=-1).astype(np.float32)
    return stack, lv, np.floor(xy)


def _angle_diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


def _moments_stacked(stack, lv, xy, radius=jorb.PATCH_RADIUS):
    """(m10, m01, patch sum) in float64 over the same run-4 taps as
    keypoint_angles_stacked (numpy, independent of both packages)."""
    L, h, w = stack.shape
    n = 2 * radius + 1
    n4 = -(-n // 4)
    wx, wy = jorb._moment_weights_rows(radius)
    xi = np.clip(xy[:, 0].astype(np.int64), 0, w - 1)
    yi = np.clip(xy[:, 1].astype(np.int64), 0, h - 1)
    rows = np.clip(yi[:, None] + np.arange(-radius, radius + 1), 0, h - 1)
    cols = np.clip(xi[:, None] + (-radius + 4 * np.arange(n4)), 0, w - 4)
    cols = (cols[:, :, None] + np.arange(4)).reshape(len(xy), -1)
    patch = stack[lv[:, None, None], rows[:, :, None],
                  cols[:, None, :]].astype(np.float64)
    return (np.einsum("knc,nc->k", patch, wx),
            np.einsum("knc,nc->k", patch, wy),
            np.abs(patch).sum(axis=(1, 2)))


def _assert_angles(a_t, a_j, m10, m01, psum, n_flat=0):
    flat = ((np.abs(m10) < FLAT_MOMENT * psum)
            & (np.abs(m01) < FLAT_MOMENT * psum))
    assert int(flat.sum()) == n_flat, int(flat.sum())
    d = _angle_diff(a_t, a_j)
    assert d[~flat].max() <= ANGLE_TOL, d[~flat].max()


def _assert_bits(bits_t, bits_j, vals_t, max_share=0.02):
    bits_t, bits_j = np.asarray(bits_t), np.asarray(bits_j)
    assert bits_t.dtype == np.int8 and bits_t.shape == bits_j.shape
    flips = bits_t != bits_j
    assert flips.mean() <= max_share, flips.mean()
    if flips.any():
        gap = np.abs(vals_t[..., 0] - vals_t[..., 1])
        assert gap[flips].max() < TIE_GAP, gap[flips].max()
    return int(flips.sum())


def test_moment_kernels_and_weights_identical():
    np.testing.assert_array_equal(torb.moment_kernels(),
                                  jorb.moment_kernels())
    np.testing.assert_array_equal(torb.moment_kernels(4),
                                  jorb.moment_kernels(4))
    for a, b in zip(torb._moment_weights(15), jorb._moment_weights(15)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(torb._moment_weights_rows(15),
                    jorb._moment_weights_rows(15)):
        np.testing.assert_array_equal(a, b)
    wx, _ = torb._moment_weights_rows(15)
    assert wx.shape == (31, 32)


def test_orientation_maps():
    img = random_texture(jax.random.PRNGKey(0), 96, 128)
    m10_j, m01_j = jorb.orientation_maps(jnp.asarray(img))
    m10_t, m01_t = torb.orientation_maps(_t(img))
    scale = np.abs(np.asarray(m10_j)).max()
    for a, b in ((m10_t, m10_j), (m01_t, m01_j)):
        assert a.shape == (96, 128)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5 * scale)
    # the dense maps read at a keypoint are its patch moments
    xy = np.array([[60.0, 40.0]], np.float32)
    a = torb.keypoint_angles(_t(img), _t(xy))
    m = np.arctan2(m01_t[40, 60].item(), m10_t[40, 60].item())
    assert _angle_diff(a.numpy(), [m]).max() < 1e-5


def test_keypoint_angles_half_bright():
    """tests/test_frontend.py:88-93: orients toward the bright side."""
    img = np.full((64, 64), 50.0, np.float32)
    img[:, 40:] = 200.0
    xy = np.array([[38.0, 32.0], [2.0, 1.0], [63.0, 63.0]], np.float32)
    a_t = torb.keypoint_angles(_t(img), _t(xy)).numpy()
    a_j = np.asarray(jorb.keypoint_angles(jnp.asarray(img),
                                          jnp.asarray(xy)))
    assert abs(a_t[0]) < 0.2
    # border keypoints clip their patch rows and columns, as the reference
    assert _angle_diff(a_t, a_j).max() <= ANGLE_TOL


def _rotate(img, theta, c0=96.0):
    h, w = img.shape
    c, s = np.cos(theta), np.sin(theta)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    xs = c * (xx - c0) + s * (yy - c0) + c0
    ys = -s * (xx - c0) + c * (yy - c0) + c0
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 2)
    fx = np.clip(xs - x0, 0, 1)
    fy = np.clip(ys - y0, 0, 1)
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1])
            + fy * ((1 - fx) * img[y0 + 1, x0]
                    + fx * img[y0 + 1, x0 + 1])).astype(np.float32)


def test_describe_rotation_scene():
    """tests/test_frontend.py:95-118's scene: `keypoint_angles`,
    `_bilinear` and `describe` on the texture and on it turned 30 degrees
    about the keypoint, plus a ring of keypoints near the border (clipped
    samples)."""
    img = random_texture(jax.random.PRNGKey(0))
    rot = _rotate(img, np.deg2rad(30.0))
    xy = np.array([[96.0, 96.0], [20.5, 30.25], [170.0, 100.0],
                   [3.0, 4.0], [191.0, 190.0]], np.float32)
    hams = []
    for im in (img, rot):
        blur_j = jpy.blur(jnp.asarray(im))
        a_j = jorb.keypoint_angles(jnp.asarray(im), jnp.asarray(xy))
        a_t = torb.keypoint_angles(_t(im), _t(xy))
        assert _angle_diff(a_t.numpy(), a_j).max() <= ANGLE_TOL
        # both packages' bits from the reference's blur and angles
        d_j = np.asarray(jorb.describe(blur_j, jnp.asarray(xy), a_j))
        d_t = torb.describe(_t(blur_j), _t(xy), _t(a_j))
        sx, sy = torb._rotated_pattern(_t(xy), _t(a_j))
        vals = torb._bilinear(_t(blur_j), sx.reshape(-1),
                              sy.reshape(-1)).reshape(sx.shape).numpy()
        _assert_bits(d_t.numpy(), d_j, vals)
        hams.append(d_t)
    assert int((hams[0][0] != hams[1][0]).sum()) < 60


def test_bilinear():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    x = rng.uniform(-3, 60, 500).astype(np.float32)
    y = rng.uniform(-3, 44, 500).astype(np.float32)
    x[:4] = [0.0, 55.0, 54.999, 55.5]
    y[:4] = [0.0, 39.0, 38.999, -1.0]
    v_j = np.asarray(jorb._bilinear(jnp.asarray(img), jnp.asarray(x),
                                    jnp.asarray(y)))
    v_t = torb._bilinear(_t(img), _t(x), _t(y)).numpy()
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=1e-4)


def test_keypoint_angles_stacked():
    """tests/test_frontend.py:230-238's stack, plus keypoints at the
    level borders, where the run-4 column clip shifts the patch."""
    stack, lv, xy = stacked_fixture()
    edge = np.array([[0.0, 0.0], [159.0, 119.0], [157.0, 5.0],
                     [2.0, 118.0], [150.5, 60.5]], np.float32)
    lv = np.concatenate([lv, np.array([0, 1, 2, 0, 1], np.int32)])
    xy = np.concatenate([xy, edge])
    a_j = np.asarray(jorb.keypoint_angles_stacked(
        jnp.asarray(stack), jnp.asarray(lv), jnp.asarray(xy)))
    a_t = torb.keypoint_angles_stacked(_t(stack), _t(lv), _t(xy))
    assert a_t.dtype == torch.float32 and a_t.shape == (len(xy),)
    m10, m01, psum = _moments_stacked(stack, lv, xy)
    _assert_angles(a_t.numpy(), a_j, m10, m01, psum)
    np.testing.assert_allclose(np.arctan2(m01, m10), a_t.numpy(), rtol=0,
                               atol=ANGLE_TOL)


def test_describe_stacked():
    """tests/test_frontend.py:240-249's stack: the port's bits against
    the reference's from the same angles."""
    stack, lv, xy = stacked_fixture()
    a_j = jorb.keypoint_angles_stacked(jnp.asarray(stack), jnp.asarray(lv),
                                       jnp.asarray(xy))
    blur = np.asarray(jpy.blur(jnp.asarray(stack)))
    b_j = np.asarray(jorb.describe_stacked(
        jnp.asarray(blur), jnp.asarray(lv), jnp.asarray(xy), a_j))
    b_t = torb.describe_stacked(_t(blur), _t(lv), _t(xy), _t(a_j))
    vals = torb.stacked_values(_t(blur), _t(lv), _t(xy), _t(a_j)).numpy()
    _assert_bits(b_t.numpy(), b_j, vals)
    # on the raw stack too (the reference test's own input)
    b_j = np.asarray(jorb.describe_stacked(
        jnp.asarray(stack), jnp.asarray(lv), jnp.asarray(xy), a_j))
    b_t = torb.describe_stacked(_t(stack), _t(lv), _t(xy), _t(a_j))
    vals = torb.stacked_values(_t(stack), _t(lv), _t(xy), _t(a_j)).numpy()
    _assert_bits(b_t.numpy(), b_j, vals)


def test_patch_and_stacked_agree_in_the_port():
    """The reference's own bounds for its two paths
    (tests/test_frontend.py:230-249), held by the port's two paths."""
    stack, lv, xy = stacked_fixture()
    s, l, p = _t(stack), _t(lv), _t(xy)
    a_old = torb.keypoint_angles_stacked(s, l, p)
    patches, ox, oy = torb.extract_patches(s, l, p)
    a_new = torb.patch_angles(patches)
    assert _angle_diff(a_new.numpy(), a_old.numpy()).max() < 1e-3
    bits_old = torb.describe_stacked(s, l, p, a_old).numpy()
    bits_new = torb.patch_describe(patches, p, ox, oy, a_old).numpy()
    assert (bits_old != bits_new).mean() < 0.005


@pytest.fixture(scope="module")
def rig_frames():
    """Four KannalaBrandt8 cameras of the flagship rig, narrowed to
    320 x 240, one frame."""
    rig_np = scene.build_rig("kb8", w=320, h=240)
    R_wb, t_wb = synthetic.orbit_trajectory(2, radius=6.0, frac=0.01)
    imgs = scene.render_rig_sequence(rig_np, R_wb[:1], t_wb[:1], w=320,
                                     h=240)[0]
    return np.clip(imgs, 0, 255).astype(np.uint8).astype(np.float32)


def test_extract_multicam_stacked(rig_frames):
    cfg_j = jex.OrbConfig(n_features=256, n_levels=4, sampling="stacked")
    cfg_t = tex.OrbConfig(n_features=256, n_levels=4, sampling="stacked")
    fj = jax.jit(lambda im: jex.extract_multicam(im, cfg_j))(
        jnp.asarray(rig_frames))
    ft = tex.extract_multicam(_t(rig_frames), cfg_t)
    assert ft.desc.shape == (4, 256, 256)
    for a, b in ((ft.xy, fj.xy), (ft.level, fj.level),
                 (ft.valid, fj.valid), (ft.sigma2, fj.sigma2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(ft.valid.sum()) > 400
    # angles and bits from the port's own stacks, in the port's own order
    d = tex.detect_multicam(_t(rig_frames), cfg_t)
    kp = d["kp"].reshape(-1, 2)
    stack = d["stack"].numpy()
    lv = d["lv_all"].numpy()
    m10, m01, psum = _moments_stacked(stack, lv, kp.numpy())
    v = ft.valid.numpy().reshape(-1)
    _assert_angles(ft.angle.numpy().reshape(-1)[v],
                   np.asarray(fj.angle).reshape(-1)[v],
                   m10[v], m01[v], psum[v], n_flat=1)
    vals = torb.stacked_values(d["blurred"], d["lv_all"], kp,
                               ft.angle.reshape(-1)).numpy()
    flips = _assert_bits(ft.desc.numpy().reshape(-1, 256),
                         np.asarray(fj.desc).reshape(-1, 256), vals)
    assert flips < 0.02 * ft.desc.numel()
    # the port's two samplings on the same frames: the reference's bounds
    fp = tex.extract_multicam(_t(rig_frames), tex.OrbConfig(
        n_features=256, n_levels=4))
    np.testing.assert_array_equal(fp.xy.numpy(), ft.xy.numpy())
    assert _angle_diff(fp.angle.numpy()[ft.valid.numpy()],
                       ft.angle.numpy()[ft.valid.numpy()]).max() < 1e-3
    assert (fp.desc != ft.desc).float().mean().item() < 0.005
