"""openmavis_tpu_torch — the PyTorch/CUDA port of openmavis_tpu.

The JAX package `openmavis_tpu` is the reference; this package mirrors its
module layout and public functions on torch tensors and runs on an NVIDIA
H100: every entry point that takes `device` builds its state on the
current CUDA device unless the caller names another (`resolve_device`);
the parity tests pass `device="cpu"`. It never imports jax or
`openmavis_tpu`.

Subpackages
-----------
geometry   Lie groups (SO3/SE3), camera models with radtan undistortion,
           triangulation.
imu        SE2(3) IMU pre-integration.
frontend   Image pyramid, FAST + oriented-BRIEF extraction, Hamming matching
           (the hand-written CUDA best-2 kernel lives in
           frontend/matcher_cuda.py, its source in csrc/), depth priors.
solvers    RANSAC two-view (E/H), PnP and Sim3 solvers.
optim      Levenberg-Marquardt, Schur-complement BA, inertial factors.
slam_map   Fixed-capacity map slabs, the multi-map Atlas with its welds,
           LSH bag-of-words signatures, the binary vocabulary tree and
           the keyframe database (dense and word-sparse).
pipeline   The streaming VI tracker (multi-camera, mono, RGB-D) with its
           device loop closer and cross-map weld; the host-policy rig
           tracker MultiTracker; the one-camera visual trackers
           tracking.Tracker (MONOCULAR, RGB-D) and
           streaming.StreamingTracker; the host-policy
           loop_closing.LoopCloser (with merge detection) all four take
           as `loop_closer=`; the Atlas arms of MultiTracker and Tracker.
io         Synthetic scenes and trajectory evaluation (numpy).
"""

__version__ = "0.1.0"

import torch as _torch

# The reference computes in true float32 (jax_default_matmul_precision =
# "highest"). TF32 keeps ~3 decimal digits, which breaks 3x3 pose algebra
# and normal-equation assembly, so both TF32 switches stay off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> _torch.device:
    """The device an entry point builds its tensors on: the one given,
    else the current CUDA device. The port runs on the card unless the
    caller asks for the CPU; it never falls back to the CPU by itself."""
    if device is not None:
        return _torch.device(device)
    if not _torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found: openmavis_tpu_torch runs on an NVIDIA "
            "GPU by default; pass device=\"cpu\" to run on the CPU")
    return _torch.device("cuda", _torch.cuda.current_device())
