"""ORB feature extraction over an image pyramid — fixed capacity, batched
over cameras (port of `openmavis_tpu/frontend/extractor.py`; reference:
ORBextractor::operator(), src/ORBextractor.cc).

The reference package vmaps `extract` over the camera axis; here every
stage carries the camera axis as a leading batch dimension, so the four
cameras of a rig share each launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import cameras
from . import fast, orb, pyramid


class Features(NamedTuple):
    """Extracted features, fixed capacity K (optionally camera-batched)."""
    xy: torch.Tensor        # [..., K, 2] float32 level-0 pixels (x, y)
    response: torch.Tensor  # [..., K] float32
    angle: torch.Tensor     # [..., K] float32 radians
    level: torch.Tensor     # [..., K] int32 pyramid level
    sigma2: torch.Tensor    # [..., K] float32 = scale^(2*level)
    desc: torch.Tensor      # [..., K, 256] int8 {0,1}
    valid: torch.Tensor     # [..., K] bool


@dataclass(frozen=True)
class OrbConfig:
    n_features: int = 512
    n_levels: int = 8
    scale: float = 1.2
    th_high: float = 15.0
    th_low: float = 7.0
    cell: int = 32
    topk_per_cell: int = 8
    border: int = 16
    # "patch" (the default): one patch gather per keypoint; any other
    # value takes the stacked per-tap gathers, as in the reference
    sampling: str = "patch"

    def per_level_budget(self):
        """Geometric feature split across levels (reference: ORBextractor
        ctor mnFeaturesPerLevel)."""
        inv = 1.0 / self.scale
        raw = np.array([inv ** l for l in range(self.n_levels)])
        raw = raw / raw.sum() * self.n_features
        budget = np.floor(raw).astype(int)
        budget[0] += self.n_features - budget.sum()
        return [int(b) for b in budget]


def _detect_level(img, budget, cfg: OrbConfig):
    """One pyramid level [C, h, w] -> [C, budget] keypoints (level-local
    coords), scores and validity."""
    xy, score, valid = fast.detect(
        img, cfg.th_high, cfg.th_low, cell=cfg.cell,
        topk_per_cell=cfg.topk_per_cell, border=cfg.border)
    masked = torch.where(valid, score, torch.full_like(score, -1.0))
    k_eff = min(budget, masked.shape[-1])
    top_scores, top_idx = fast.topk_stable(masked, k_eff)
    if k_eff < budget:
        pad = budget - k_eff
        top_scores = torch.cat([top_scores, torch.full(
            top_scores.shape[:-1] + (pad,), -1.0, device=img.device)], -1)
        top_idx = torch.cat([top_idx, torch.zeros(
            top_idx.shape[:-1] + (pad,), dtype=top_idx.dtype,
            device=img.device)], -1)
    kp = torch.gather(xy, -2, top_idx[..., None].expand(
        top_idx.shape + (2,)))
    return kp, top_scores, top_scores > 0


def detect_multicam(images: torch.Tensor, cfg: OrbConfig = OrbConfig()):
    """Pyramid + FAST selection for [C, H, W] images.

    Returns dict(kp [C,K,2] level-local coords, response [C,K], lvid [K]
    index into `used`, valid [C,K], s2 [C,K], used [(level, image)], and
    the descriptor inputs of both samplings: the raw and blurred padded stacks
    [C*L, H, W] and the per-keypoint stack index lv_all [C*K])."""
    C, h0, w0 = images.shape
    dev = images.device
    levels = pyramid.build_pyramid(images, cfg.n_levels, cfg.scale)
    budgets = cfg.per_level_budget()

    kp_l, resp_l, lv_l, s2_l, valid_l, used = [], [], [], [], [], []
    for lv, (img_l, budget) in enumerate(zip(levels, budgets)):
        if budget == 0:
            continue
        kp, score, val = _detect_level(img_l, budget, cfg)
        s = cfg.scale ** lv
        kp_l.append(kp)
        resp_l.append(score)
        lv_l.append(torch.full((budget,), len(used), dtype=torch.int64,
                               device=dev))
        s2_l.append(torch.full((C, budget), s * s, dtype=torch.float32,
                               device=dev))
        valid_l.append(val)
        used.append((lv, img_l))

    kp = torch.cat(kp_l, dim=1)                               # [C, K, 2]
    lvid = torch.cat(lv_l, dim=0)                             # [K]
    valid = torch.cat(valid_l, dim=1)

    # padded stack [C, L, h0, w0], edge-replicated like the reference;
    # cameras fold into the level axis so one gather serves the whole rig
    stack = torch.stack([
        torch.nn.functional.pad(im, (0, w0 - im.shape[-1],
                                     0, h0 - im.shape[-2]),
                                mode="replicate")
        for _, im in used], dim=1)
    L = stack.shape[1]
    return dict(
        kp=kp, response=torch.cat(resp_l, dim=1), lvid=lvid, valid=valid,
        s2=torch.cat(s2_l, dim=1), used=used,
        stack=stack.reshape(C * L, h0, w0),
        blurred=pyramid.blur(stack).reshape(C * L, h0, w0),
        lv_all=(torch.arange(C, device=dev)[:, None] * L
                + lvid[None]).reshape(-1))


def extract_multicam(images: torch.Tensor,
                     cfg: OrbConfig = OrbConfig()) -> Features:
    """[C, H, W] float32 images -> camera-batched Features [C, K, ...]."""
    d = detect_multicam(images, cfg)
    kp, lvid, valid, used = d["kp"], d["lvid"], d["valid"], d["used"]
    C, K = valid.shape
    dev = images.device
    kp_all = kp.reshape(C * K, 2)
    if cfg.sampling == "patch":
        patches, _, _ = orb.extract_patches(d["stack"], d["lv_all"], kp_all)
        angles = orb.patch_angles(patches)
        patches_b, oxb, oyb = orb.extract_patches(d["blurred"], d["lv_all"],
                                                  kp_all)
        desc = orb.patch_describe(patches_b, kp_all, oxb, oyb, angles)
    else:
        angles = orb.keypoint_angles_stacked(d["stack"], d["lv_all"], kp_all)
        desc = orb.describe_stacked(d["blurred"], d["lv_all"], kp_all,
                                    angles)
    desc = desc.reshape(C, K, 256) * valid[..., None].to(torch.int8)

    scale_of = torch.tensor([cfg.scale ** lv for lv, _ in used],
                            dtype=torch.float32, device=dev)
    lv_of = torch.tensor([lv for lv, _ in used], dtype=torch.int32,
                         device=dev)
    return Features(
        xy=kp * scale_of[lvid][None, :, None],
        response=d["response"],
        angle=angles.reshape(C, K),
        level=lv_of[lvid].expand(C, K).contiguous(),
        sigma2=d["s2"],
        desc=desc,
        valid=valid,
    )


def extract(img: torch.Tensor, cfg: OrbConfig = OrbConfig()) -> Features:
    """[H, W] float32 image -> Features with capacity cfg.n_features."""
    f = extract_multicam(img[None], cfg)
    return Features(*(x[0] for x in f))


def undistort_features(feats: Features, params: torch.Tensor,
                       dist) -> Features:
    """Replace keypoint pixels with ideal-pinhole pixels.

    For distorted-pinhole rigs (e.g. raw EuRoC images, radtan k1 ~= -0.28)
    the detector runs on the raw image and the keypoints are lifted to the
    ideal pinhole model here, so all downstream projection and matching
    use undistorted coordinates (reference: Frame::UndistortKeyPoints via
    cv::undistortPoints, src/Frame.cc).

    params/dist broadcast over feats.xy's batch dims: single-camera feats
    [K, 2] take params [4+] / dist [4]; camera-batched feats [C, K, 2] take
    params [C, 4+] / dist [C, 4]. `dist` None is a no-op."""
    if dist is None:
        return feats
    p = torch.as_tensor(params, device=feats.xy.device)
    d = torch.as_tensor(dist, dtype=torch.float32, device=feats.xy.device)
    if feats.xy.ndim == 3:      # [C, K, 2]
        p, d = p[:, None, :], d[:, None, :]
    return feats._replace(xy=cameras.undistort_pixels(p, d, feats.xy))
