"""SE(3) / SO(3) utilities (port of ``miso_tpu/ops/se3.py``).

Rotations are (..., 3, 3) matrices, translations flat (..., 3) vectors.
The 3x3 products are written as elementwise multiply-and-sum, so they run
in full float32 whatever the TF32 settings of the process.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., i, k) @ (..., k, j) in exact float32."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3) for (..., 3) tangent vectors.

    Rodrigues' formula with a second-order Taylor branch near zero.  The
    untaken branch is kept finite (double-where), so gradients at
    theta == 0 are finite.
    """
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]   # (..., 1, 1)
    W = hat(w)
    W2 = _mm(W, W)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta_safe) / theta_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta_safe)) / theta2_safe)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3), returns (..., 3) axis-angle.

    Near theta = 0 the scale is a polynomial of sin^2(theta) (finite
    gradient); near pi the axis comes from the symmetric part.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    small = cos > 1.0 - 1e-6
    cos_safe = torch.where(small, torch.zeros_like(cos), cos)
    theta = torch.where(small, torch.zeros_like(cos), torch.arccos(cos_safe))
    sin = torch.sin(theta)
    sin2 = 0.25 * torch.sum(w_skew ** 2, dim=-1)
    scale = torch.where(small[..., None], 0.5 + sin2[..., None] / 12.0,
                        theta[..., None] / (2.0 * torch.clamp(sin[..., None], min=_EPS)))
    w = w_skew * scale
    near_pi = theta > math.pi - 1e-2

    A = (R + R.transpose(-1, -2)) * 0.5
    diag = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag - cos[..., None])
                        / torch.clamp(1.0 - cos[..., None], min=_EPS), 0.0, 1.0)
    tiny = axis2 < 1e-12
    axis = torch.where(tiny, torch.zeros_like(axis2),
                       torch.sqrt(torch.where(tiny, torch.ones_like(axis2), axis2)))
    sign = torch.where(w_skew >= 0, 1.0, -1.0)
    w_pi = axis * sign * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def apply_pose_correction(R, t, dr, dt):
    """R' = R @ Exp(dr),  t' = t + dt."""
    return _mm(R, so3_exp(dr)), t + dt


def transform_points_to(points, R, t):
    """points (..., N, 3) in src frame -> dst frame: x @ R^T + t."""
    return (points.unsqueeze(-2) * R.unsqueeze(-3)).sum(-1) + t[..., None, :]


def transform_points_from(points, R, t):
    """Inverse of :func:`transform_points_to`: (x - t) @ R."""
    d = points - t[..., None, :]
    return (d.unsqueeze(-2) * R.transpose(-1, -2).unsqueeze(-3)).sum(-1)


def transform_points_by_id(points, ids, R, t):
    """Per-point pose transform ``R[ids] @ p + t[ids]``.

    points: (N, 3), ids: (N,) int frame indices, R: (K, 3, 3), t: (K, 3).
    Summed in the JAX version's order: t, then the three products.
    """
    ids = ids.long()
    Ri = R[ids]
    ti = t[ids]
    cols = []
    for j in range(3):
        acc = ti[:, j]
        for k in range(3):
            acc = acc + Ri[:, j, k] * points[:, k]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def transform_points_by_id2(points, ids_a, ids_b, R, t):
    """Two-level per-point pose transform ``R[a, b] @ p + t[a, b]`` with
    per-point (submap, local keyframe) index pairs.

    points: (N, 3); ids_a, ids_b: (N,) ints; R: (S, K, 3, 3), t: (S, K, 3).
    Summed in the JAX version's order.
    """
    a, b = ids_a.long(), ids_b.long()
    Ri = R[a, b]
    ti = t[a, b]
    cols = []
    for j in range(3):
        acc = ti[:, j]
        for k in range(3):
            acc = acc + Ri[:, j, k] * points[:, k]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def inverse_transform_points_by_id(points, ids, R, t):
    """Per-point inverse transform ``R[ids]^T (points - t[ids])``: world
    points into each point's own frame (the alignment losses' map into the
    destination submap).  Summed in the JAX version's order."""
    ids = ids.long()
    Ri = R[ids]
    ti = t[ids]
    d = [points[:, k] - ti[:, k] for k in range(3)]
    cols = []
    for j in range(3):
        acc = Ri[:, 0, j] * d[0]
        for k in range(1, 3):
            acc = acc + Ri[:, k, j] * d[k]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def coords_in_bound(coords, bound):
    """(N, d) points, (d, 2) bound -> (N, 1) float mask."""
    inside = (coords >= bound[:, 0]) & (coords <= bound[:, 1])
    return torch.all(inside, dim=-1, keepdim=True).to(coords.dtype)


def identity_rotations(n, dtype=torch.float32, device="cuda"):
    return torch.eye(3, dtype=dtype, device=device).expand(n, 3, 3).clone()


def so3_relative_angle(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle (rad) between batches of rotations."""
    R12 = _mm(R1.transpose(-1, -2), R2)
    trace = R12[..., 0, 0] + R12[..., 1, 1] + R12[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def get_pose_correction(R, t, R_new, t_new):
    """Inverse of :func:`apply_pose_correction`: (dr, dt) with
    R_new = R @ Exp(dr), t_new = t + dt."""
    return so3_log(_mm(R.transpose(-1, -2), R_new)), t_new - t


def transform_poses_to(R_frames, t_frames, R, t):
    """Compose world<-frames from world<-src (R (3, 3), t (3,)) and
    src<-frames (R_frames (..., 3, 3), t_frames (..., 3))."""
    R_out = _mm(R.expand(R_frames.shape), R_frames)
    t_out = (R * t_frames.unsqueeze(-2)).sum(-1) + t
    return R_out, t_out


def transform_poses_from(R_frames, t_frames, R, t):
    """src<-frames from world<-frames and world<-src."""
    R_inv = R.T
    t_inv = -(R_inv * t).sum(-1)
    return transform_poses_to(R_frames, t_frames, R_inv, t_inv)


def pose_matrix(R, t):
    """(3, 3), (3,) -> 4x4 homogeneous matrix."""
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t.reshape(3)
    return T


def rotation_rmse_deg(R1, R2):
    """RMSE of the relative angles, in degrees."""
    ang = so3_relative_angle(R1, R2)
    return torch.rad2deg(torch.sqrt(torch.mean(ang ** 2)))


def rotation_mean_error_deg(R1, R2):
    return torch.rad2deg(torch.mean(torch.abs(so3_relative_angle(R1, R2))))


def translation_rmse(t1, t2):
    d = torch.linalg.vector_norm(t1.reshape(-1, 3) - t2.reshape(-1, 3), dim=-1)
    return torch.sqrt(torch.mean(d ** 2))


def translation_mean_error(t1, t2):
    d = torch.linalg.vector_norm(t1.reshape(-1, 3) - t2.reshape(-1, 3), dim=-1)
    return torch.mean(d)


def aabb(points: torch.Tensor, buffer: float = 0.0) -> torch.Tensor:
    """Axis-aligned bounding box (d, 2) of (N, d) points."""
    return torch.stack([points.min(dim=0).values - buffer,
                        points.max(dim=0).values + buffer], dim=1)


# ---------------------------------------------------------------------------
# Random poses for noise injection in synthetic data.  Draws come from a
# ``torch.Generator`` (the default generator when None), on its device, so
# their stream differs from the JAX package's keys.
# ---------------------------------------------------------------------------

def wrapped_gaussian_rotations(n: int, std_rad: float = 0.1,
                               generator: torch.Generator = None, dtype=torch.float32):
    """(n, 3, 3) rotations Exp(w), w ~ N(0, std_rad^2 I)."""
    device = generator.device if generator is not None else "cpu"
    return so3_exp(torch.randn((n, 3), generator=generator, dtype=dtype, device=device)
                   * std_rad)


def gaussian_translations(n: int, std: float, generator: torch.Generator = None,
                          dtype=torch.float32):
    """(n, 3) translations ~ N(0, std^2 I)."""
    device = generator.device if generator is not None else "cpu"
    return torch.randn((n, 3), generator=generator, dtype=dtype, device=device) * std
