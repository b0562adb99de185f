"""Offline ORB vocabulary trainer, the DBoW2 ORBvoc equivalent (port of
`scripts/train_vocab.py`).

The reference ships a pre-trained 1M-word vocabulary
(Vocabulary/ORBvoc.txt, k=10 L=6; build.sh:30-33) trained offline on
~10k images. This trains the port's tree (`slam_map.vocabulary.train`:
batched k-means over Hamming space, all nodes of a level at once) from
any EuRoC-layout dataset directory, or from a synthetic world when no
dataset is given, and saves it with an MD5 content hash (System.cc:
1520-1556 binding semantics) that `Vocabulary.path` in a settings file
binds.

Usage:
    python -m openmavis_tpu_torch.examples.train_vocab out.npz
        [--data mav0_dir[,dir2,...]] [--k 10] [--levels 5]
        [--samples 500000] [--frames 200] [--device cpu]
"""

import argparse
import sys

import numpy as np
import torch

from .. import resolve_device
from ..frontend import extractor
from ..geometry import cameras
from ..io import datasets, synthetic
from ..slam_map import vocabulary as voc
from .common import add_device


def _valid_desc(images: np.ndarray, orb, device) -> np.ndarray:
    """[C, H, W] frames -> the first camera's valid descriptors."""
    f = extractor.extract_multicam(
        torch.as_tensor(images, dtype=torch.float32).to(device), orb)
    return f.desc[0][f.valid[0]].cpu().numpy()


def collect_dataset(dirs, n_frames, orb, device=None):
    device = resolve_device(device)
    out = []
    for d in dirs:
        seq = datasets.load_euroc(d, cams=("cam0",))
        step = max(1, seq.n_frames // n_frames)
        for i in range(0, seq.n_frames, step):
            out.append(_valid_desc(seq.frame(i), orb, device))
    return out


def collect_synthetic(n_frames, orb, device=None):
    device = resolve_device(device)
    W, H = 640, 480
    pin = np.array([380.0, 380.0, W / 2, H / 2, 0, 0, 0, 0], np.float32)
    out = []
    for seed in range(max(1, n_frames // 40)):
        world = synthetic.BlobWorld.create(seed=seed, n=4000)
        R, t = synthetic.orbit_trajectory(40, radius=6.0, frac=1.0)
        frames = synthetic.render_sequence(world, cameras.PINHOLE, pin,
                                           R, t, W, H)
        for img in frames:
            out.append(_valid_desc(img[None], orb, device))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--data", default=None)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--levels", type=int, default=5)
    ap.add_argument("--samples", type=int, default=500000)
    ap.add_argument("--frames", type=int, default=200)
    add_device(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    orb = extractor.OrbConfig(n_features=1024, n_levels=8)
    if args.data:
        banks = collect_dataset(args.data.split(","), args.frames, orb,
                                device=dev)
    else:
        banks = collect_synthetic(args.frames, orb, device=dev)
    desc = np.concatenate(banks)
    print(f"collected {len(desc)} descriptors from {len(banks)} frames",
          file=sys.stderr)
    if len(desc) > args.samples:
        sel = np.random.default_rng(0).choice(len(desc), args.samples,
                                              replace=False)
        desc = desc[sel]
    vocab = voc.train(desc, k=args.k, levels=args.levels, device=dev)
    digest = voc.save(args.out, vocab)
    print(f"{vocab.n_words}-word vocabulary (k={args.k}, "
          f"L={args.levels}) -> {args.out} (md5 {digest})",
          file=sys.stderr)


if __name__ == "__main__":
    main()
