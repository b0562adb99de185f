"""Hamming best-2 search: the two hand-written Hopper kernels and their
plain PyTorch versions.

Counterpart of `openmavis_tpu/frontend/matcher_pallas.py`
(`masked_best2_fused`, the repository's one TPU kernel). The CUDA source is
`openmavis_tpu_torch/csrc/hamming_best2.cu`; it is compiled with `nvcc` for
`sm_90a` into `build/openmavis_tpu_torch/` at first use and bound with
ctypes (plain C entry points, pointers and stream as `c_void_p`).

Entry points (each returns `(best_idx, best, second)`, int32 [N]; a row
with no admissible target gives `(0, 300, 300)`):

* `masked_best2_fused(d1, d2, mask)`: admissibility as a bool mask [N, M]
  with any strides (so the mutual pass hands over `mask.T` without a copy).
  Kernel `hamming_best2`; plain version `masked_best2_plain`. Reached from
  `matcher.match_nn` (stereo and temporal spawn; the loop closer's
  keyframe-to-keyframe pairs, `loop_closing._pairs_from_tables`).
  `launch_packed` is the same kernel for callers that already hold packed
  words.
* `projection_best2(...)`: admissibility from its factors (projection,
  predicted level, radius and validity per query; position, level and
  validity per feature), tested inside the kernel: no [N, M] array is
  built. Kernel `projection_best2`; plain version `projection_best2_plain`.
  Reached from `matcher.match_projection` (`_match_bank`,
  `bind_landmarks_multi`; the loop closer's `pairs_by_projection` and
  `group_projection_score`).

Both kernels pack the {0,1} int8 descriptor planes themselves: no torch op
touches the descriptors between the caller and the launch.

Dispatch: tensors on the CPU take the plain version, over the rows that
can have a match only (a mask row with an admissible column, a valid
query: the others give `(0, 300, 300)` unsearched); CUDA tensors launch
the kernel or raise. There is no other switch.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import matcher

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "hamming_best2.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "openmavis_tpu_torch"
_MAX_COLS = 1 << 20           # the kernel's (dist << 20 | col) key width

# Kernel launches, (kernel, N, M, mask layout) -> count; the layout is
# "rows" for a mask whose rows are contiguous, "T" for the transpose of
# such a mask, "strided" for any other, and "factors" for the factor form.
# A wrapper adds one where it launches its kernel and nowhere else; callers
# that need to show that a run went through the kernels reset the counts
# and read them (`launch_count`).
launches_by_shape: dict = {}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                       "build csrc/hamming_best2.cu")


def build(verbose: bool = False) -> Path:
    """Compile the kernel (once per source content) and return the path
    of the shared library."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _BUILD_DIR / f"libhamming_best2_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp, str(_SRC)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr.strip())
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.hamming_best2_launch.argtypes = [
            ptr, i64, ptr, i64, ptr, i64, i64, i32, i32, ptr, ptr, ptr, ptr]
        lib.hamming_best2_packed_launch.argtypes = [
            ptr, ptr, ptr, i64, i64, i32, i32, ptr, ptr, ptr, ptr]
        lib.projection_best2_launch.argtypes = [
            ptr, ptr, ptr, i64, ctypes.c_float, ptr, i64, ptr, ptr, ptr, ptr,
            i64, ptr, i32, i32, ptr, ptr, ptr, ptr]
        for fn in (lib.hamming_best2_launch, lib.hamming_best2_packed_launch,
                   lib.projection_best2_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def reset_launch_counts() -> None:
    """Empty `launches_by_shape`: every count is 0 again."""
    launches_by_shape.clear()


def launch_count(name: str | None = None, n: int | None = None,
                 m: int | None = None, layout: str | None = None) -> int:
    """Launches since the last reset: of every kernel, or of those that
    agree with each argument given (kernel name, N, M, mask layout)."""
    want = (name, n, m, layout)
    return sum(v for k, v in launches_by_shape.items()
               if all(w is None or w == x for w, x in zip(want, k)))


def _mask_layout(mask: torch.Tensor) -> str:
    if mask.stride(1) == 1:
        return "rows"
    return "T" if mask.stride(0) == 1 else "strided"


def _launched(name: str, err: int, n: int, m: int, layout: str) -> None:
    """Raise on a refused launch, else count it."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    key = (name, n, m, layout)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1


def _outputs(n: int, device):
    """(best_idx, best, second): three rows of one allocation."""
    return torch.empty((3, n), dtype=torch.int32, device=device).unbind(0)


def _one_device(tensors) -> str:
    """"cpu" or "cuda" when every tensor lies there, else raises."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") \
            or any(x.device != dev for x in tensors):
        raise ValueError("tensors on mixed or unsupported devices: "
                         f"{sorted({str(x.device) for x in tensors})}")
    return dev.type


def _current(device):
    """A context in which `device` is the current CUDA device, as a launch
    needs it (free when it already is)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _check_desc(name: str, d: torch.Tensor) -> None:
    if d.ndim != 2 or d.shape[1] != 256:
        raise ValueError(f"{name} must be [n, 256], got {tuple(d.shape)}")
    if d.dtype != torch.int8:
        raise TypeError(f"{name} must be int8 planes, got {d.dtype}")


def _check_cols(m: int) -> None:
    if not 0 < m < _MAX_COLS:
        raise ValueError(f"M={m} outside the kernel's 1..{_MAX_COLS - 1}")


def _row_stride(name: str, d: torch.Tensor) -> int:
    """Row stride in bytes of int8 planes the kernel can read in place."""
    if d.stride(1) != 1:
        raise ValueError(f"{name} must have contiguous rows, got strides "
                         f"{d.stride()}")
    return d.stride(0)


def masked_best2_plain(d1: torch.Tensor, d2: torch.Tensor,
                       mask: torch.Tensor):
    """The plain PyTorch version of the `hamming_best2` kernel."""
    return matcher.masked_best2(matcher.hamming_matrix(d1, d2), mask)


def _on_rows(n: int, rows: torch.Tensor, search):
    """(best_idx, best, second) [n] of a search run on `rows` only; every
    other row has no admissible column and gets (0, 300, 300), as the
    plain version gives it. The CPU route of both wrappers: a slab's
    empty rows then cost nothing (one host read of the row set)."""
    out = (torch.zeros(n, dtype=torch.int32, device=rows.device),
           torch.full((n,), matcher._INVALID, dtype=torch.int32,
                      device=rows.device),
           torch.full((n,), matcher._INVALID, dtype=torch.int32,
                      device=rows.device))
    if rows.numel():
        for o, r in zip(out, search(rows)):
            o[rows] = r
    return out


def _check_mask(n: int, m: int, mask: torch.Tensor) -> None:
    if mask.shape != (n, m):
        raise ValueError(f"mask {tuple(mask.shape)} does not match {n}x{m}")
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")


def masked_best2_fused(d1: torch.Tensor, d2: torch.Tensor,
                       mask: torch.Tensor):
    """Best-2 Hamming search under an admissibility mask.

    d1 [N, 256], d2 [M, 256] {0,1} (int8); mask [N, M] bool, any strides.
    Returns (best_idx, best, second), int32 [N]; rows with no admissible
    target give (0, 300, 300)."""
    _check_desc("d1", d1)
    _check_desc("d2", d2)
    n, m = d1.shape[0], d2.shape[0]
    _check_mask(n, m, mask)
    _check_cols(m)
    if _one_device((d1, d2, mask)) == "cpu":
        return _on_rows(n, torch.nonzero(mask.any(dim=1))[:, 0],
                        lambda r: masked_best2_plain(d1[r], d2, mask[r]))
    s1, s2 = _row_stride("d1", d1), _row_stride("d2", d2)
    out = _outputs(n, d1.device)
    with _current(d1.device):
        err = _load().hamming_best2_launch(
            d1.data_ptr(), s1, d2.data_ptr(), s2, mask.data_ptr(),
            mask.stride(0), mask.stride(1), n, m, out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _launched("hamming_best2", err, n, m, _mask_layout(mask))
    return out


def launch_packed(q: torch.Tensor, t: torch.Tensor, mask: torch.Tensor):
    """The `hamming_best2` kernel on descriptors that are packed already:
    q [N, 8], t [M, 8] int32 words (`orb.pack_bits`) and mask [N, M] bool
    with any strides, all on one CUDA device. Returns (best_idx, best,
    second) int32 [N]."""
    for name, x in (("q", q), ("t", t)):
        if x.dtype != torch.int32 or x.ndim != 2 or x.shape[1] != 8 \
                or not x.is_contiguous() or x.device.type != "cuda" \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             "CUDA int32 [n, 8]")
    n, m = q.shape[0], t.shape[0]
    _check_mask(n, m, mask)
    _check_cols(m)
    if not q.device == t.device == mask.device:
        raise ValueError(f"q, t and mask must all lie on {q.device}")
    out = _outputs(n, q.device)
    with _current(q.device):
        err = _load().hamming_best2_packed_launch(
            q.data_ptr(), t.data_ptr(), mask.data_ptr(), mask.stride(0),
            mask.stride(1), n, m, out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), torch.cuda.current_stream().cuda_stream)
    _launched("hamming_best2", err, n, m, _mask_layout(mask))
    return out


def projection_best2_plain(proj_xy, pred_level, radius, d_query, valid_query,
                           feat_xy, feat_level, feat_desc, feat_valid):
    """The plain PyTorch version of the `projection_best2` kernel: build
    the [N, M] mask from its factors, then the plain masked search."""
    mask = (valid_query[:, None] & feat_valid[None, :]
            & matcher.window_mask(proj_xy, feat_xy, radius)
            & matcher.level_mask(pred_level, feat_level))
    return masked_best2_plain(d_query, feat_desc, mask)


def projection_best2(proj_xy, pred_level, radius, d_query, valid_query,
                     feat_xy, feat_level, feat_desc, feat_valid):
    """Best-2 Hamming search of projected landmarks among frame features.

    Query n may take feature m iff valid_query[n] and feat_valid[m], both
    |proj_xy[n] - feat_xy[m]| components are < radius (strictly, in
    float32; a NaN or inf projection admits nothing) and feat_level[m] is
    within +-1 of pred_level[n].

    proj_xy [N, 2] f32, pred_level [N] i32, radius a number, a 0-dim
    tensor or [N], d_query [N, 256] int8, valid_query [N] bool; feat_xy
    [M, 2] f32, feat_level [M] i32, feat_desc [M, 256] int8, feat_valid
    [M] bool. Returns (best_idx, best, second), int32 [N]."""
    _check_desc("d_query", d_query)
    _check_desc("feat_desc", feat_desc)
    n, m = d_query.shape[0], feat_desc.shape[0]
    _check_cols(m)
    for name, x, shape, dtype in (
            ("proj_xy", proj_xy, (n, 2), torch.float32),
            ("pred_level", pred_level, (n,), torch.int32),
            ("valid_query", valid_query, (n,), torch.bool),
            ("feat_xy", feat_xy, (m, 2), torch.float32),
            ("feat_level", feat_level, (m,), torch.int32),
            ("feat_valid", feat_valid, (m,), torch.bool)):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    tensors = [proj_xy, pred_level, d_query, valid_query, feat_xy,
               feat_level, feat_desc, feat_valid]
    if isinstance(radius, torch.Tensor):
        if radius.ndim > 1 or radius.ndim == 1 and radius.shape[0] != n:
            raise ValueError(f"radius must be a scalar or [{n}], got "
                             f"{tuple(radius.shape)}")
        tensors.append(radius)
    if _one_device(tensors) == "cpu":
        def search(r):
            rad = (radius[r] if isinstance(radius, torch.Tensor)
                   and radius.ndim else radius)
            return projection_best2_plain(
                proj_xy[r], pred_level[r], rad, d_query[r], valid_query[r],
                feat_xy, feat_level, feat_desc, feat_valid)
        return _on_rows(n, torch.nonzero(valid_query)[:, 0], search)
    if isinstance(radius, torch.Tensor):
        r = radius.to(torch.float32)          # no copy when it is f32
        r_ptr, r_all = r.data_ptr(), 0.0
        r_stride = r.stride(0) if r.ndim else 0
    else:
        r_ptr, r_stride, r_all = None, 0, float(radius)
    sq, st = _row_stride("d_query", d_query), _row_stride("feat_desc",
                                                          feat_desc)
    factors = [x.contiguous() for x in (proj_xy, pred_level, valid_query,
                                        feat_xy, feat_level, feat_valid)]
    out = _outputs(n, d_query.device)
    with _current(d_query.device):
        err = _load().projection_best2_launch(
            factors[0].data_ptr(), factors[1].data_ptr(), r_ptr, r_stride,
            r_all, d_query.data_ptr(), sq, factors[2].data_ptr(),
            factors[3].data_ptr(), factors[4].data_ptr(),
            feat_desc.data_ptr(), st, factors[5].data_ptr(), n, m,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _launched("projection_best2", err, n, m, "factors")
    return out
