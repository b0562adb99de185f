"""Oriented BRIEF (port of `openmavis_tpu/frontend/orb.py`; reference:
IC_Angle + computeOrbDescriptor, src/ORBextractor.cc:19-100).

Two formulations, as in the reference package:
* patch (`OrbConfig.sampling="patch"`, the default): each keypoint's 31x32
  patch is gathered once; the intensity-centroid angle is a weight
  contraction over it, and the rotated-BRIEF bilinear taps are separable
  triangle-kernel contractions (exact bilinear interpolation);
* stacked (`sampling="stacked"`): the moment taps and the four bilinear
  taps of every pattern point are gathered one by one from the padded
  pyramid stack (`keypoint_angles_stacked`, `describe_stacked`), with the
  single-image forms `keypoint_angles` and `describe` beside them.
The descriptor pattern is the reference package's seeded Gaussian pattern.
"""

from __future__ import annotations

import numpy as np
import torch

PATCH_RADIUS = 15
PATTERN_RADIUS = 13.0
N_BITS = 256
_PW = 32                     # patch lane width (31 used + 1 pad)


def _circular_mask(radius: int) -> np.ndarray:
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


def moment_kernels(radius: int = PATCH_RADIUS) -> np.ndarray:
    """[2, 1, 2r+1, 2r+1] conv kernels computing (m10, m01) of the patch."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = _circular_mask(radius)
    kx = (x * mask).astype(np.float32)
    ky = (y * mask).astype(np.float32)
    return np.stack([kx[None], ky[None]], axis=0)


def orientation_maps(img: torch.Tensor, radius: int = PATCH_RADIUS):
    """[H, W] -> (m10 [H, W], m01 [H, W]) dense patch moments (a
    correlation with zero padding, as the reference's conv)."""
    k = torch.as_tensor(moment_kernels(radius), device=img.device)
    out = torch.nn.functional.conv2d(img[None, None], k, padding=radius)
    return out[0, 0], out[0, 1]


def _moment_weights(radius: int):
    """Flattened (wx [P], wy [P], offsets dy,dx [P, 2]) of the circular
    patch."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = _circular_mask(radius)
    wx = (x * mask).reshape(-1).astype(np.float32)
    wy = (y * mask).reshape(-1).astype(np.float32)
    off = np.stack([y.reshape(-1), x.reshape(-1)], axis=-1).astype(np.int32)
    return wx, wy, off


def keypoint_angles(img: torch.Tensor, xy: torch.Tensor,
                    radius: int = PATCH_RADIUS) -> torch.Tensor:
    """Intensity-centroid angle (radians) for keypoints [K, 2] (x, y) of
    one [H, W] image: each keypoint's clipped 31x31 patch against the
    moment weights."""
    h, w = img.shape
    wx, wy, off = _moment_weights(radius)
    dev = img.device
    wxy = torch.as_tensor(np.stack([wx, wy], 1), device=dev)     # [P, 2]
    off = torch.as_tensor(off, dtype=torch.int64, device=dev)
    xi = torch.clamp(xy[:, 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(xy[:, 1].to(torch.int64), 0, h - 1)
    py = torch.clamp(yi[:, None] + off[None, :, 0], 0, h - 1)    # [K, P]
    px = torch.clamp(xi[:, None] + off[None, :, 1], 0, w - 1)
    patch = img.reshape(-1)[py * w + px]
    m = patch @ wxy
    return torch.atan2(m[:, 1], m[:, 0])


def make_pattern(seed: int = 1234, n_bits: int = N_BITS,
                 sigma: float = 31.0 / 5.0,
                 max_norm: float = PATTERN_RADIUS) -> np.ndarray:
    """[n_bits, 2, 2] float32 (pairs of (x, y) points), deterministic."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n_bits, 2, 2)).astype(np.float32)
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(norm, max_norm) / np.maximum(norm, 1e-9)
    return pts * scale


_PATTERN = make_pattern()


def _rotated_pattern(xy: torch.Tensor, angles: torch.Tensor):
    """Sample points (sx, sy) [K, 256, 2] of the pattern rotated by each
    keypoint's angle, p' = R(theta) p, about its keypoint."""
    pat = torch.as_tensor(_PATTERN, device=xy.device)       # [256, 2, 2]
    c, s = torch.cos(angles), torch.sin(angles)
    px_, py_ = pat[..., 0], pat[..., 1]
    rx = c[:, None, None] * px_[None] - s[:, None, None] * py_[None]
    ry = s[:, None, None] * px_[None] + c[:, None, None] * py_[None]
    return xy[:, None, None, 0] + rx, xy[:, None, None, 1] + ry


def _bilinear(img: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an [H, W] image at float coords (clamped)."""
    h, w = img.shape
    x = torch.clamp(x, 0.0, w - 1.001)
    y = torch.clamp(y, 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    idx = y0 * w + x0
    v00, v01 = flat[idx], flat[idx + 1]
    v10, v11 = flat[idx + w], flat[idx + w + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def describe(img_blur: torch.Tensor, xy: torch.Tensor,
             angles: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF bits [K, 256] int8 {0, 1} for keypoints xy [K, 2] of
    one blurred [H, W] level image, angles [K] in radians."""
    sx, sy = _rotated_pattern(xy, angles)                   # [K, 256, 2]
    vals = _bilinear(img_blur, sx.reshape(-1), sy.reshape(-1))
    vals = vals.reshape(sx.shape)
    return (vals[..., 0] < vals[..., 1]).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K, 256] {0,1} -> [K, 8] int32 words, bit i of word j = plane
    32*j + i (the reference's uint32 packing, two's-complement int32)."""
    k = bits.shape[0]
    b = bits.reshape(k, 8, 32).to(torch.int64)
    weights = torch.as_tensor(1 << np.arange(32), dtype=torch.int64,
                              device=bits.device)
    words = torch.sum(b * weights, dim=-1)                 # [0, 2^32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """[K, 8] int32 -> [K, 256] int8 in {0, 1}."""
    k = packed.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    words = packed.to(torch.int64) & 0xFFFFFFFF
    return ((words[:, :, None] >> shifts) & 1).reshape(k, 256).to(
        torch.int8)


def extract_patches(stack: torch.Tensor, lv: torch.Tensor,
                    xy: torch.Tensor, radius: int = PATCH_RADIUS):
    """Gather [K, P, 32] patches from a padded pyramid stack [L, h, w];
    lv [K] level ids, xy [K, 2] level-local coords.

    Returns (patches, ox [K], oy [K]) with (ox, oy) the patch origin. The
    reference fetches two 32-wide blocks per row and shifts lanes with a
    one-hot contraction; since ox <= w - 32 that selects exactly the
    columns ox..ox+31, which is the direct gather here."""
    L, h, w = stack.shape
    P = 2 * radius + 1
    xi = torch.floor(xy[:, 0]).to(torch.int64)
    yi = torch.floor(xy[:, 1]).to(torch.int64)
    ox = torch.clamp(xi - radius, 0, w - _PW)
    oy = torch.clamp(yi - radius, 0, h - P)
    rows = oy[:, None] + torch.arange(P, device=xy.device)[None]
    cols = ox[:, None] + torch.arange(_PW, device=xy.device)[None]
    patches = stack[lv.to(torch.int64)[:, None, None], rows[:, :, None],
                    cols[:, None, :]]
    return patches, ox.to(torch.int32), oy.to(torch.int32)


def _patch_moment_weights(radius: int):
    P = 2 * radius + 1
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = _circular_mask(radius)
    wx = np.zeros((P, _PW), np.float32)
    wy = np.zeros((P, _PW), np.float32)
    wx[:, :P] = x * mask
    wy[:, :P] = y * mask
    return wx, wy


def patch_angles(patches: torch.Tensor,
                 radius: int = PATCH_RADIUS) -> torch.Tensor:
    """IC angles from extracted patches [K, P, 32] (keypoint at the patch
    center)."""
    wx, wy = _patch_moment_weights(radius)
    flat = patches.reshape(patches.shape[0], -1)
    w = torch.as_tensor(np.stack([wx.reshape(-1), wy.reshape(-1)], 1),
                        device=patches.device)
    m = flat @ w                                            # [K, 2]
    return torch.atan2(m[:, 1], m[:, 0])


def patch_values(patches_blur: torch.Tensor, xy: torch.Tensor,
                 ox: torch.Tensor, oy: torch.Tensor,
                 angles: torch.Tensor) -> torch.Tensor:
    """Bilinear rotated-BRIEF samples [K, 256, 2] from blurred patches."""
    K, P = patches_blur.shape[:2]
    pat = torch.as_tensor(_PATTERN, device=xy.device)       # [256, 2, 2]
    c, s = torch.cos(angles), torch.sin(angles)
    px_, py_ = pat[..., 0], pat[..., 1]
    rx = (c[:, None, None] * px_[None]
          - s[:, None, None] * py_[None]).reshape(K, -1)    # [K, 512]
    ry = (s[:, None, None] * px_[None]
          + c[:, None, None] * py_[None]).reshape(K, -1)
    sx = torch.clamp(xy[:, 0:1] - ox[:, None].to(xy.dtype) + rx,
                     0.0, _PW - 1.001)
    sy = torch.clamp(xy[:, 1:2] - oy[:, None].to(xy.dtype) + ry,
                     0.0, P - 1.001)
    return _sample(patches_blur, sx, sy).reshape(K, -1, 2)


def _tent(s: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - (s - at).abs(), min=0.0)


def _sample(patches_blur, sx, sy):
    """Bilinear samples [K, 512] at (sx, sy) of patches [K, P, 32]. A tent
    weight is nonzero only at floor(s) and floor(s) + 1: the two lane
    weights are scattered into a [K, 512, 32] operand of one batched
    product, and of each sample's rows only the two live ones are added
    (equal, bit for bit, to tent weights over every lane and row)."""
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wxw = torch.zeros(sx.shape + (_PW,), dtype=sx.dtype,
                      device=sx.device).scatter_(
        -1, torch.stack([x0, x0 + 1], -1).to(torch.int64),
        torch.stack([_tent(sx, x0), _tent(sx, x0 + 1)], -1))
    a = torch.bmm(wxw, patches_blur.transpose(1, 2))         # [K, 512, P]
    rows = torch.stack([y0, y0 + 1], -1)
    live = torch.gather(a, -1, rows.to(torch.int64))
    return (live[..., 0] * _tent(sy, y0) + live[..., 1] * _tent(sy, y0 + 1))


def patch_describe(patches_blur, xy, ox, oy, angles) -> torch.Tensor:
    """Rotated-BRIEF bits [K, 256] int8 {0, 1} from blurred patches."""
    vals = patch_values(patches_blur, xy, ox, oy, angles)
    return (vals[..., 0] < vals[..., 1]).to(torch.int8)


def _moment_weights_rows(radius: int):
    """[2r+1, 4*ceil((2r+1)/4)] (x, y) moment weights of the circular
    patch, zero-padded in the column dim to a multiple of 4 (the run-4
    granularity of keypoint_angles_stacked)."""
    n = 2 * radius + 1
    cols = -(-n // 4) * 4
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    mask = _circular_mask(radius)
    wx = np.zeros((n, cols), np.float32)
    wy = np.zeros((n, cols), np.float32)
    wx[:, :n] = x * mask
    wy[:, :n] = y * mask
    return wx, wy


def keypoint_angles_stacked(stack: torch.Tensor, lv: torch.Tensor,
                            xy: torch.Tensor,
                            radius: int = PATCH_RADIUS) -> torch.Tensor:
    """IC angles for keypoints spread across a padded pyramid stack.

    stack: [L, H0, W0] (each level edge-padded to the level-0 shape);
    lv: [K] level index per keypoint; xy: [K, 2] level-local coords.

    The reference reads each patch row as runs of 4 consecutive pixels
    from a [L*h*w, 4] table of shifted copies of the stack. The run
    starts are clipped to w - 4, so every run lies inside its row and the
    four taps are read here at idx .. idx + 3 directly: the same values,
    with the same right-edge shift of the clipped runs."""
    L, h, w = stack.shape
    n = 2 * radius + 1
    n4 = -(-n // 4)
    dev = stack.device
    wx, wy = _moment_weights_rows(radius)
    wxy = torch.as_tensor(np.stack([wx, wy], -1), device=dev)  # [n, 4n4, 2]
    xi = torch.clamp(xy[:, 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(xy[:, 1].to(torch.int64), 0, h - 1)
    dy = torch.arange(-radius, radius + 1, device=dev)
    dx0 = -radius + 4 * torch.arange(n4, device=dev)
    base = (lv.to(torch.int64) * (h * w))[:, None, None]
    rows = torch.clamp(yi[:, None] + dy[None, :], 0, h - 1)      # [K, n]
    cols = torch.clamp(xi[:, None] + dx0[None, :], 0, w - 4)     # [K, n4]
    idx = base + rows[:, :, None] * w + cols[:, None, :]         # [K, n, n4]
    taps = idx[..., None] + torch.arange(4, device=dev)          # [.., 4]
    patch = stack.reshape(-1)[taps].reshape(xy.shape[0], n, n4 * 4)
    m = torch.einsum("knc,ncj->kj", patch, wxy)
    return torch.atan2(m[:, 1], m[:, 0])


def stacked_values(stack_blur: torch.Tensor, lv: torch.Tensor,
                   xy: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Bilinear rotated-BRIEF samples [K, 256, 2] from a padded blurred
    pyramid stack [L, h, w] (see keypoint_angles_stacked).

    The reference reads the four taps as one row of a [L*h*w, 4] table of
    shifted copies of the stack. The sample points are clipped to
    [0, w - 1.001] x [0, h - 1.001], so idx + 1, idx + w and idx + w + 1
    stay inside the keypoint's level and are read here directly."""
    L, h, w = stack_blur.shape
    sx, sy = _rotated_pattern(xy, angles)
    sx = torch.clamp(sx, 0.0, w - 1.001)
    sy = torch.clamp(sy, 0.0, h - 1.001)
    x0 = torch.floor(sx).to(torch.int64)
    y0 = torch.floor(sy).to(torch.int64)
    fx = sx - x0
    fy = sy - y0
    idx = (lv.to(torch.int64) * (h * w))[:, None, None] + y0 * w + x0
    flat = stack_blur.reshape(-1)
    v00, v01 = flat[idx], flat[idx + 1]
    v10, v11 = flat[idx + w], flat[idx + w + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def describe_stacked(stack_blur: torch.Tensor, lv: torch.Tensor,
                     xy: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF bits [K, 256] int8 {0, 1} over a padded blurred
    pyramid stack, matching `describe`."""
    vals = stacked_values(stack_blur, lv, xy, angles)
    return (vals[..., 0] < vals[..., 1]).to(torch.int8)
