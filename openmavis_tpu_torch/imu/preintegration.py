"""SE2(3) exact IMU pre-integration on torch tensors.

Port of `openmavis_tpu/imu/preintegration.py` (reference: IMU::Preintegrated,
src/ImuTypes.cc:160-239, include/ImuTypes.h:212-251): closed-form SE2(3)
Gamma-matrix integration (J1 = Jl(w dt) dt, J2 = Gamma2(w dt) dt^2), the
15x15 covariance propagation and the five bias Jacobians.

State-error ordering: [dphi(3), dv(3), dp(3), bg(3), ba(3)]; bias vectors
are ``[bg(3), ba(3)]``. Padded samples use dt = 0, an exact no-op.

Every function broadcasts over leading batch dimensions of the
`Preintegrated` fields, so a chain of K intervals is one `Preintegrated`
whose fields carry a leading [K] axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..geometry import lie

GRAVITY = np.array([0.0, 0.0, -9.81], dtype=np.float32)


def _gravity(like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(GRAVITY, dtype=like.dtype, device=like.device)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


class ImuNoise(NamedTuple):
    """Discrete-time noise covariances: ``nga`` [6,6] measurement noise
    (gyro then acc) = diag(sigma^2 * freq); ``nga_walk`` [6,6] bias random
    walk = diag(sigma_walk^2 / freq) (reference: IMU::Calib::Set)."""
    nga: torch.Tensor
    nga_walk: torch.Tensor

    @staticmethod
    def from_sigmas(sigma_g, sigma_a, walk_g, walk_a, freq, device=None):
        sf = float(freq)
        device = resolve_device(device)
        nga = torch.diag(torch.tensor(
            np.array([sigma_g**2 * sf] * 3 + [sigma_a**2 * sf] * 3,
                     np.float32), device=device))
        walk = torch.diag(torch.tensor(
            np.array([walk_g**2 / sf] * 3 + [walk_a**2 / sf] * 3,
                     np.float32), device=device))
        return ImuNoise(nga=nga, nga_walk=walk)

    def to(self, device):
        return ImuNoise(*(x.to(device) for x in self))


class Preintegrated(NamedTuple):
    """Pre-integrated IMU deltas between two frames/keyframes."""
    dR: torch.Tensor     # [3,3]
    dV: torch.Tensor     # [3]
    dP: torch.Tensor     # [3]
    JRg: torch.Tensor    # [3,3] d(dR)/d(bg)
    JVg: torch.Tensor    # [3,3]
    JVa: torch.Tensor    # [3,3]
    JPg: torch.Tensor    # [3,3]
    JPa: torch.Tensor    # [3,3]
    C: torch.Tensor      # [15,15] covariance [phi, v, p, bg, ba]
    dT: torch.Tensor     # [] total time
    b: torch.Tensor      # [6] bias used for integration [bg, ba]
    avgA: torch.Tensor   # [3]
    avgW: torch.Tensor   # [3]

    def map(self, fn) -> "Preintegrated":
        """Apply `fn` to every field (the pytree map of the reference)."""
        return Preintegrated(*(fn(x) for x in self))


def init_preintegrated(bias: torch.Tensor) -> Preintegrated:
    dtype, dev = bias.dtype, bias.device
    z3 = torch.zeros((3, 3), dtype=dtype, device=dev)
    return Preintegrated(
        dR=torch.eye(3, dtype=dtype, device=dev),
        dV=torch.zeros(3, dtype=dtype, device=dev),
        dP=torch.zeros(3, dtype=dtype, device=dev),
        JRg=z3, JVg=z3.clone(), JVa=z3.clone(), JPg=z3.clone(),
        JPa=z3.clone(),
        C=torch.zeros((15, 15), dtype=dtype, device=dev),
        dT=torch.zeros((), dtype=dtype, device=dev),
        b=bias.clone(),
        avgA=torch.zeros(3, dtype=dtype, device=dev),
        avgW=torch.zeros(3, dtype=dtype, device=dev))


def _step(state: Preintegrated, w, a, dt, noise: ImuNoise) -> Preintegrated:
    """One IMU sample update (reference: src/ImuTypes.cc:160-239); dt == 0
    is an exact no-op."""
    bg, ba = state.b[:3], state.b[3:]
    acc = a - ba
    acc_w = w - bg

    phi = acc_w * dt
    J1 = lie.so3_left_jacobian(phi) * dt
    J2 = lie.so3_gamma2(phi) * (dt * dt)

    dR_old = state.dR
    dP = state.dP + state.dV * dt + dR_old @ (J2 @ acc)
    dV = state.dV + dR_old @ (J1 @ acc)

    tot = state.dT + dt
    denom = torch.where(tot > 0, tot, torch.ones_like(tot))
    avgA = (state.dT * state.avgA + dR_old @ acc * dt) / denom
    avgW = (state.dT * state.avgW + acc_w * dt) / denom

    Wacc = lie.so3_hat(acc)
    dRi = lie.so3_exp(phi)
    Jr_dt = lie.so3_right_jacobian(phi) * dt
    eye3 = torch.eye(3, dtype=dR_old.dtype, device=dR_old.device)
    z3 = torch.zeros_like(eye3)

    A = torch.cat([
        torch.cat([dRi.T, z3, z3, -dt * eye3, z3], dim=1),
        torch.cat([-dR_old @ lie.so3_hat(J1 @ acc), eye3, z3, z3,
                   -dR_old @ J1], dim=1),
        torch.cat([-dR_old @ lie.so3_hat(J2 @ acc), dt * eye3, eye3, z3,
                   -dR_old @ J2], dim=1),
    ], dim=0)                                                # [9, 15]
    B = torch.cat([
        torch.cat([Jr_dt, z3], dim=1),
        torch.cat([z3, dR_old @ J1], dim=1),
        torch.cat([z3, dR_old @ J2], dim=1),
    ], dim=0)                                                # [9, 6]

    # the reference leaves C[0:9, 9:15] at zero (src/ImuTypes.cc:231-232)
    C = state.C
    C_new = torch.zeros_like(C)
    C_new[:9, :9] = A @ C @ A.T + B @ noise.nga @ B.T
    C_new[9:, 9:] = C[9:, 9:] + dt * dt * noise.nga_walk

    JPa = state.JPa + state.JVa * dt - dR_old @ J2
    JPg = state.JPg + state.JVg * dt - dR_old @ J2 @ Wacc @ state.JRg
    JVa = state.JVa - dR_old @ J1
    JVg = state.JVg - dR_old @ J1 @ Wacc @ state.JRg

    dR = lie.normalize_rotation(dR_old @ dRi)
    JRg = dRi.T @ state.JRg - Jr_dt

    return Preintegrated(
        dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        C=C_new, dT=tot, b=state.b, avgA=avgA, avgW=avgW)


def integrate(w: torch.Tensor, a: torch.Tensor, dts: torch.Tensor,
              bias: torch.Tensor, noise: ImuNoise) -> Preintegrated:
    """Integrate a fixed-capacity buffer of IMU samples: w, a [S, 3], dts
    [S] (zero-padded), bias [6]. The reference's `lax.scan` over samples is
    a Python loop over the S padded samples."""
    state = init_preintegrated(bias.to(w.dtype))
    for i in range(w.shape[0]):
        state = _step(state, w[i], a[i], dts[i], noise)
    return state


def integrate_batch(w: torch.Tensor, a: torch.Tensor, dts: torch.Tensor,
                    bias: torch.Tensor, noise: ImuNoise) -> Preintegrated:
    """`integrate` over a batch of intervals: w, a [B, S, 3], dts [B, S],
    bias [B, 6]; one pass over the S samples, each update applied to the
    whole batch on the leading axis (the reference vmaps `integrate`)."""
    B = w.shape[0]
    state = init_preintegrated(bias[0].to(w.dtype)).map(
        lambda x: x.expand((B,) + x.shape).clone())
    state = state._replace(b=bias.to(w.dtype))
    step = torch.vmap(_step, in_dims=(0, 0, 0, 0, None))
    for i in range(w.shape[1]):
        state = step(state, w[:, i], a[:, i], dts[:, i], noise)
    return state


# ---------------------------------------------------------------------------
# Exact composition of consecutive preintegrations (closed form of
# IMU::Preintegrated::MergePrevious, src/ImuTypes.cc:241-263)
# ---------------------------------------------------------------------------

def compose(a: Preintegrated, b: Preintegrated) -> Preintegrated:
    """Compose two consecutive intervals (a then b), both linearized at
    the same bias; `init_preintegrated` is the identity on either side."""
    eye3 = torch.eye(3, dtype=a.dR.dtype, device=a.dR.device)
    z3 = torch.zeros_like(eye3)
    dTb = b.dT

    dR = lie.normalize_rotation(a.dR @ b.dR)
    dV = a.dV + a.dR @ b.dV
    dP = a.dP + a.dV * dTb + a.dR @ b.dP

    hat_dVb = lie.so3_hat(b.dV)
    hat_dPb = lie.so3_hat(b.dP)

    JRg = b.dR.T @ a.JRg + b.JRg
    JVg = a.JVg + a.dR @ b.JVg - a.dR @ hat_dVb @ a.JRg
    JVa = a.JVa + a.dR @ b.JVa
    JPg = a.JPg + a.JVg * dTb + a.dR @ b.JPg - a.dR @ hat_dPb @ a.JRg
    JPa = a.JPa + a.JVa * dTb + a.dR @ b.JPa

    F = torch.cat([
        torch.cat([b.dR.T, z3, z3], dim=1),
        torch.cat([-a.dR @ hat_dVb, eye3, z3], dim=1),
        torch.cat([-a.dR @ hat_dPb, dTb * eye3, eye3], dim=1)], dim=0)
    G = torch.cat([
        torch.cat([eye3, z3, z3], dim=1),
        torch.cat([z3, a.dR, z3], dim=1),
        torch.cat([z3, z3, a.dR], dim=1)], dim=0)
    Hb = torch.cat([
        torch.cat([b.JRg, z3], dim=1),
        torch.cat([b.JVg, b.JVa], dim=1),
        torch.cat([b.JPg, b.JPa], dim=1)], dim=0)            # [9, 6]
    C9a = a.C[:9, :9]
    C9b = b.C[:9, :9]
    Cbb_a = a.C[9:, 9:]
    C = torch.zeros_like(a.C)
    C[:9, :9] = F @ C9a @ F.T + G @ (C9b + Hb @ Cbb_a @ Hb.T) @ G.T
    C[9:, 9:] = Cbb_a + b.C[9:, 9:]

    dT = a.dT + b.dT
    denom = torch.where(dT > 0, dT, torch.ones_like(dT))
    avgA = (a.dT * a.avgA + dTb * (a.dR @ b.avgA)) / denom
    avgW = (a.dT * a.avgW + dTb * b.avgW) / denom
    return Preintegrated(
        dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        C=C, dT=dT, b=a.b, avgA=avgA, avgW=avgW)


def rebias(pre: Preintegrated, new_bias: torch.Tensor) -> Preintegrated:
    """Re-linearize at `new_bias` (first order, via the stored Jacobians;
    stand-in for the reference's Reintegrate, src/ImuTypes.cc:152-158).
    Broadcasts over a leading chain axis of `pre`."""
    return pre._replace(
        dR=delta_rotation(pre, new_bias),
        dV=delta_velocity(pre, new_bias),
        dP=delta_position(pre, new_bias),
        b=new_bias.to(pre.b.dtype).expand(pre.b.shape).clone())


# ---------------------------------------------------------------------------
# Per-keyframe preintegration chain: fields with a leading [K] axis; entry k
# covers keyframe k-1 -> k (reference: KeyFrame::mpImuPreintegrated).
# ---------------------------------------------------------------------------

def chain_allocate(K: int, device=None,
                   dtype=torch.float32) -> Preintegrated:
    one = init_preintegrated(torch.zeros(6, dtype=dtype,
                                         device=resolve_device(device)))
    return one.map(lambda x: x.expand((K,) + x.shape).clone())


def chain_set(chain: Preintegrated, k, pre: Preintegrated) -> Preintegrated:
    """Functional `chain[k] = pre` (returns a new chain)."""
    def put(c, x):
        c = c.clone()
        c[k] = x
        return c
    return Preintegrated(*(put(c, x) for c, x in zip(chain, pre)))


def chain_get(chain: Preintegrated, k) -> Preintegrated:
    return chain.map(lambda c: c[k])


# ---------------------------------------------------------------------------
# Bias-corrected deltas (reference: src/ImuTypes.cc:288-324)
# ---------------------------------------------------------------------------

def delta_rotation(pre: Preintegrated, new_bias: torch.Tensor):
    dbg = new_bias[..., :3] - pre.b[..., :3]
    corr = lie.so3_exp(_mv(pre.JRg, dbg))
    return lie.normalize_rotation(pre.dR @ corr)


def delta_velocity(pre: Preintegrated, new_bias: torch.Tensor):
    dbg = new_bias[..., :3] - pre.b[..., :3]
    dba = new_bias[..., 3:] - pre.b[..., 3:]
    return pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)


def delta_position(pre: Preintegrated, new_bias: torch.Tensor):
    dbg = new_bias[..., :3] - pre.b[..., :3]
    dba = new_bias[..., 3:] - pre.b[..., 3:]
    return pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)


def predict_state(R_wb, p_wb, v_w, pre: Preintegrated, bias: torch.Tensor,
                  gravity=None):
    """Propagate a world-frame IMU state across the interval (reference:
    Tracking::PredictStateIMU, src/Tracking.cc:1723-1779).
    Returns (R2, p2, v2)."""
    g = _gravity(p_wb) if gravity is None else gravity
    t = pre.dT
    dR = delta_rotation(pre, bias)
    dV = delta_velocity(pre, bias)
    dP = delta_position(pre, bias)
    R2 = lie.normalize_rotation(R_wb @ dR)
    v2 = v_w + g * t + R_wb @ dV
    p2 = p_wb + v_w * t + 0.5 * g * t * t + R_wb @ dP
    return R2, p2, v2
