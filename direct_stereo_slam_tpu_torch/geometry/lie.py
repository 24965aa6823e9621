"""Batched SO(3)/SE(3) Lie-group operations in PyTorch.

Port of ``direct_stereo_slam_tpu/geometry/lie.py``. Conventions match
Sophus: the SE(3) tangent is ``[tx, ty, tz, rx, ry, rz]`` (translation
first), ``exp`` uses the V-matrix for the translation part, poses are 4x4
homogeneous matrices with leading batch dims allowed. The f32
small-angle Taylor switch (``_sinc_coeffs``) and the near-pi branch of
``so3_log`` are kept as they are in the reference.

The numpy float64 twins at the bottom (``se3_exp_np``/``se3_log_np``)
serve the per-frame host bookkeeping.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Taylor-series switch on theta^2 (see the reference: (1 - cos t)
# underflows in f32 for t < ~3e-4).
_EPS = 1e-4


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _sinc_coeffs(theta_sq: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with Taylor
    fallbacks below theta^2 = _EPS."""
    small = theta_sq < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_t = torch.sqrt(safe_t2)
    t2 = theta_sq
    A = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                    (1.0 - torch.cos(safe_t)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0,
                    (safe_t - torch.sin(safe_t)) / (safe_t2 * safe_t))
    return A, B, C


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues. w: (..., 3) -> (..., 3, 3)."""
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    return _eye3_like(W) + A[..., None, None] * W + B[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues. R: (..., 3, 3) -> (..., 3). Safe near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = 0.5 * torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_sq = torch.sum(w * w, dim=-1)
    tiny = sin_sq < 1e-12
    sin_theta = torch.sqrt(torch.where(tiny, torch.full_like(sin_sq, 1e-12), sin_sq))
    sin_theta = torch.where(tiny, torch.zeros_like(sin_theta), sin_theta)
    theta = torch.atan2(sin_theta, cos_theta)
    small = theta < 1e-5
    near_pi = theta > math.pi - 1e-2
    sin_safe = torch.where(torch.abs(sin_theta) < 1e-10, torch.ones_like(sin_theta), sin_theta)
    scale = torch.where(small, 1.0 + theta ** 2 / 6.0, theta / sin_safe)
    w_generic = w * scale[..., None]
    one_minus_cos = torch.where(near_pi, torch.clamp(1.0 - cos_theta, min=1e-12),
                                torch.ones_like(cos_theta))
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    ratio = torch.where(
        near_pi[..., None],
        torch.clamp((diag - cos_theta[..., None]) / one_minus_cos[..., None], min=0.0),
        torch.ones_like(diag),
    )
    axis_abs = torch.sqrt(ratio)
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]

    def sgn(s):
        return torch.where(s >= 0, torch.ones_like(s), -torch.ones_like(s))

    ax0, ax1, ax2 = axis_abs[..., 0], axis_abs[..., 1], axis_abs[..., 2]
    anchor0 = torch.stack([ax0, sgn(s01) * ax1, sgn(s02) * ax2], dim=-1)
    anchor1 = torch.stack([sgn(s01) * ax0, ax1, sgn(s12) * ax2], dim=-1)
    anchor2 = torch.stack([sgn(s02) * ax0, sgn(s12) * ax1, ax2], dim=-1)
    k = torch.argmax(axis_abs, dim=-1)[..., None]
    axis = torch.where(k == 0, anchor0, torch.where(k == 1, anchor1, anchor2))
    flip = torch.sum(axis * w, dim=-1) < 0
    axis = torch.where(flip[..., None], -axis, axis)
    w_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    """[..., 1, 4] rows (0, 0, 0, 1), filled on the device (no upload)."""
    lead = top.shape[:-2] + (1,)
    return torch.cat([top.new_zeros(lead + (3,)), top.new_ones(lead + (1,))], dim=-1)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """xi: (..., 6) tangent [t, w] -> (..., 4, 4)."""
    t, w = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, C = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    eye = _eye3_like(W)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    trans = (V @ t[..., None])[..., 0]
    top = torch.cat([R, trans[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """T: (..., 4, 4) -> (..., 6) tangent [t, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta_sq = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta_sq)
    W = hat(w)
    W2 = W @ W
    small = theta_sq < _EPS
    safe_t2 = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_B = torch.where(torch.abs(B) < 1e-12, torch.ones_like(B), B)
    coef = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                       (1.0 - A / (2.0 * safe_B)) / safe_t2)
    Vinv = _eye3_like(W) - 0.5 * W + coef[..., None, None] * W2
    u = (Vinv @ t[..., None])[..., 0]
    return torch.cat([u, w], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    new_t = -(Rt @ t[..., None])[..., 0]
    top = torch.cat([Rt, new_t[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """Adjoint for tangent ordering [t, w]: [[R, hat(t) R], [0, R]]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = hat(t) @ R
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# Host (numpy, float64) variants for the per-frame motion-model bookkeeping.
# ---------------------------------------------------------------------------


def _np_sinc_coeffs(theta_sq: float):
    if theta_sq < 1e-10:
        t2 = theta_sq
        return (1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0)
    t = float(np.sqrt(theta_sq))
    return (np.sin(t) / t, (1.0 - np.cos(t)) / theta_sq,
            (t - np.sin(t)) / (theta_sq * t))


def _np_hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def so3_log_np(R):
    """Inverse Rodrigues, numpy float64, safe near 0 and pi."""
    R = np.asarray(R, np.float64)
    cos_theta = float(np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0))
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin_theta = float(np.linalg.norm(w))
    theta = float(np.arctan2(sin_theta, cos_theta))
    if theta < 1e-7:
        return w
    if theta > np.pi - 1e-3:
        one_minus_cos = max(1.0 - cos_theta, 1e-12)
        axis_abs = np.sqrt(np.maximum((np.diag(R) - cos_theta) / one_minus_cos, 0.0))
        s = np.array([R[0, 1] + R[1, 0], R[0, 2] + R[2, 0], R[1, 2] + R[2, 1]])
        sgn = lambda x: 1.0 if x >= 0 else -1.0
        k = int(np.argmax(axis_abs))
        axis = axis_abs.copy()
        if k == 0:
            axis[1] *= sgn(s[0]); axis[2] *= sgn(s[1])
        elif k == 1:
            axis[0] *= sgn(s[0]); axis[2] *= sgn(s[2])
        else:
            axis[0] *= sgn(s[1]); axis[1] *= sgn(s[2])
        if float(axis @ w) < 0:
            axis = -axis
        return axis / max(float(np.linalg.norm(axis)), 1e-12) * theta
    return w * (theta / sin_theta)


def se3_exp_np(xi):
    """(6,) tangent [t, w] -> (4, 4), numpy float64."""
    xi = np.asarray(xi, np.float64)
    t, w = xi[:3], xi[3:]
    A, B, C = _np_sinc_coeffs(float(w @ w))
    W = _np_hat(w)
    W2 = W @ W
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + A * W + B * W2
    T[:3, 3] = (np.eye(3) + B * W + C * W2) @ t
    return T


def se3_log_np(T):
    """(4, 4) -> (6,) tangent [t, w], numpy float64."""
    T = np.asarray(T, np.float64)
    w = so3_log_np(T[:3, :3])
    theta_sq = float(w @ w)
    A, B, _ = _np_sinc_coeffs(theta_sq)
    W = _np_hat(w)
    W2 = W @ W
    if theta_sq < 1e-10:
        coef = 1.0 / 12.0 + theta_sq / 720.0
    else:
        coef = (1.0 - A / (2.0 * B)) / theta_sq
    Vinv = np.eye(3) - 0.5 * W + coef * W2
    return np.concatenate([Vinv @ T[:3, 3], w])
