"""SO(3) / S2 Lie-group math, batched over leading dimensions.

Port of `sr_livo_tpu/utils/lie.py` (the reference `numType` helpers,
include/utility.h:191-402).  Every function accepts arbitrary leading
batch dimensions and has no data-dependent branching: small-angle cases
are selected with `torch.where` over numerically-safe operands, exactly
as in the JAX package, so both give the same values to f32 round-off.

Quaternions are stored as `[..., 4]` tensors in (w, x, y, z) order.
"""

from __future__ import annotations

import math

import torch

# Small-angle threshold, mirroring THETA_THRESHOLD in utility.h:27.
_THETA_EPS = 1e-4


def _eye3(like: torch.Tensor, batch_shape) -> torch.Tensor:
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    return eye.expand(tuple(batch_shape) + (3, 3))


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric (hat) matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 3]; inverse of `skew` for skew-symmetric input."""
    return torch.stack([m[..., 2, 1] - m[..., 1, 2],
                        m[..., 0, 2] - m[..., 2, 0],
                        m[..., 1, 0] - m[..., 0, 1]], dim=-1) * 0.5


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_identity(batch_shape=(), dtype=torch.float32, device="cpu"
                  ) -> torch.Tensor:
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=1e-20)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q (active rotation, R(q) @ v)."""
    qv = q[..., 1:]
    w = q[..., :1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
        torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], dim=-1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], dim=-1),
    ], dim=-2)


def rot_to_quat(r: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w, x, y, z), branch-free Shepperd method."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]

    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-20)) * 0.5

    c0 = torch.stack([qw[..., 0],
                      (m21 - m12) / (4 * qw[..., 0]),
                      (m02 - m20) / (4 * qw[..., 0]),
                      (m10 - m01) / (4 * qw[..., 0])], dim=-1)
    c1 = torch.stack([(m21 - m12) / (4 * qw[..., 1]),
                      qw[..., 1],
                      (m01 + m10) / (4 * qw[..., 1]),
                      (m02 + m20) / (4 * qw[..., 1])], dim=-1)
    c2 = torch.stack([(m02 - m20) / (4 * qw[..., 2]),
                      (m01 + m10) / (4 * qw[..., 2]),
                      qw[..., 2],
                      (m12 + m21) / (4 * qw[..., 2])], dim=-1)
    c3 = torch.stack([(m10 - m01) / (4 * qw[..., 3]),
                      (m02 + m20) / (4 * qw[..., 3]),
                      (m12 + m21) / (4 * qw[..., 3]),
                      qw[..., 3]], dim=-1)

    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    # Canonical sign: w >= 0.
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# Exponential / logarithm maps
# ---------------------------------------------------------------------------

def _theta_safe(w: torch.Tensor):
    theta = torch.linalg.norm(w, dim=-1)
    small = theta < _THETA_EPS
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    return theta, theta_safe, small


def exp_so3_quat(w: torch.Tensor) -> torch.Tensor:
    """so(3) vector -> unit quaternion (reference so3ToQuat, utility.h:300)."""
    theta, theta_safe, small = _theta_safe(w)
    u = w / theta_safe[..., None]
    half = 0.5 * theta
    big = torch.cat([torch.cos(half)[..., None],
                     u * torch.sin(half)[..., None]], dim=-1)
    small_q = torch.cat([torch.ones_like(theta)[..., None], 0.5 * w], dim=-1)
    return quat_normalize(torch.where(small[..., None], small_q, big))


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """so(3) vector -> rotation matrix (Rodrigues; reference so3ToRotation)."""
    theta, theta_safe, small = _theta_safe(w)
    wx = skew(w)
    wx2 = wx @ wx
    eye = _eye3(w, w.shape[:-1])
    small_r = eye + wx + 0.5 * wx2
    a = (torch.sin(theta_safe) / theta_safe)[..., None, None]
    b = ((1.0 - torch.cos(theta_safe)) / (theta_safe * theta_safe))[..., None, None]
    big_r = eye + a * wx + b * wx2
    return torch.where(small[..., None, None], small_r, big_r)


def log_so3(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> so(3) vector (reference rotationToSo3)."""
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w_raw = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                         r[..., 0, 2] - r[..., 2, 0],
                         r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    small = theta < _THETA_EPS
    sin_theta_safe = torch.where(small, torch.ones_like(theta),
                                 torch.sin(theta))
    # Near theta = pi, sin(theta) -> 0; clamp for safety (rare in tracking).
    sin_theta_safe = torch.where(torch.abs(sin_theta_safe) < 1e-7,
                                 torch.full_like(sin_theta_safe, 1e-7),
                                 sin_theta_safe)
    big = w_raw * (theta / (2.0 * sin_theta_safe))[..., None]
    return torch.where(small[..., None], 0.5 * w_raw, big)


def quat_to_so3(q: torch.Tensor) -> torch.Tensor:
    return log_so3(quat_to_rot(q))


# ---------------------------------------------------------------------------
# Left / right Jacobians of SO(3)
# ---------------------------------------------------------------------------

def _jl_core(w: torch.Tensor, sign: float) -> torch.Tensor:
    theta, theta_safe, small = _theta_safe(w)
    u = w / theta_safe[..., None]
    eye = _eye3(w, w.shape[:-1])
    uut = u[..., :, None] * u[..., None, :]
    s = torch.sin(theta_safe) / theta_safe
    c = (1.0 - torch.cos(theta_safe)) / theta_safe
    big = (s[..., None, None] * eye
           + (1.0 - s)[..., None, None] * uut
           + sign * c[..., None, None] * skew(u))
    small_j = eye + sign * 0.5 * skew(w)
    return torch.where(small[..., None, None], small_j, big)


def jl_so3(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian (reference JleftSo3)."""
    return _jl_core(w, +1.0)


def jr_so3(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian (reference JrightSo3)."""
    return _jl_core(w, -1.0)


def _inv_jl_core(w: torch.Tensor, sign: float) -> torch.Tensor:
    theta, theta_safe, small = _theta_safe(w)
    u = w / theta_safe[..., None]
    eye = _eye3(w, w.shape[:-1])
    uut = u[..., :, None] * u[..., None, :]
    half_cot = 0.5 * theta_safe / torch.tan(0.5 * theta_safe)
    big = (half_cot[..., None, None] * eye
           + (1.0 - half_cot)[..., None, None] * uut
           - sign * 0.5 * skew(w))
    wwt = w[..., :, None] * w[..., None, :]
    small_j = (torch.cos(0.5 * theta)[..., None, None] * eye
               + 0.125 * wwt - sign * 0.5 * skew(w))
    return torch.where(small[..., None, None], small_j, big)


def inv_jl_so3(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian (reference invJleftSo3)."""
    return _inv_jl_core(w, +1.0)


def inv_jr_so3(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian (reference invJrightSo3)."""
    return _inv_jl_core(w, -1.0)


# ---------------------------------------------------------------------------
# S2 (gravity) manifold
# ---------------------------------------------------------------------------

def s2_bx(g: torch.Tensor) -> torch.Tensor:
    """Tangent basis B_x in R^{3x2} of the S2 gravity manifold.

    Mirrors reference derivativeS2 (utility.h:215-233).  Singular at
    g_z == -|g| (gravity exactly antipodal to +z), which does not occur
    for upright IMU mounting conventions used by the reference configs.
    """
    gn = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True), min=1e-20)
    g0, g1, g2 = gn[..., 0], gn[..., 1], gn[..., 2]
    denom = 1.0 + g2
    denom = torch.where(torch.abs(denom) < 1e-8,
                        torch.full_like(denom, 1e-8), denom)
    b00 = 1.0 - g0 * g0 / denom
    b01 = -g0 * g1 / denom
    b11 = 1.0 - g1 * g1 / denom
    row0 = torch.stack([b00, b01], dim=-1)
    row1 = torch.stack([b01, b11], dim=-1)
    row2 = torch.stack([-g0, -g1], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rot_from_v1_to_v2(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Rotation matrix taking unit(v1) to unit(v2) (reference rotFromV1toV2)."""
    a = v1 / torch.clamp(torch.linalg.norm(v1, dim=-1, keepdim=True), min=1e-20)
    b = v2 / torch.clamp(torch.linalg.norm(v2, dim=-1, keepdim=True), min=1e-20)
    cross = torch.linalg.cross(a, b, dim=-1)
    dot = torch.sum(a * b, dim=-1)
    eye = _eye3(v1, a.shape[:-1])
    sk = skew(cross)
    cross_sq = torch.sum(cross * cross, dim=-1)
    denom = torch.where(cross_sq < 1e-20, torch.ones_like(cross_sq), cross_sq)
    big = eye + sk + (sk @ sk) * ((1.0 - dot) / denom)[..., None, None]
    near_id = (torch.abs(1.0 - dot) < 1e-6)[..., None, None]
    return torch.where(near_id, eye, big)


def angular_distance_deg(d_so3: torch.Tensor) -> torch.Tensor:
    """Rotation angle of exp(d_so3) in degrees (reference AngularDistance)."""
    r = exp_so3(d_so3)
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    return torch.arccos(c) * (180.0 / math.pi)


def slerp(q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Batched quaternion slerp with shortest-path sign correction.

    `alpha` broadcasts against the quaternion batch dims.
    """
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    dot = torch.clamp(dot, -1.0, 1.0)
    theta = torch.arccos(dot)
    small = dot > 1.0 - 1e-6
    sin_theta = torch.where(small, torch.ones_like(theta), torch.sin(theta))
    a = torch.as_tensor(alpha, dtype=q0.dtype, device=q0.device)
    if a.ndim < q0.ndim:
        a = a[..., None]
    w0 = torch.where(small, 1.0 - a, torch.sin((1.0 - a) * theta) / sin_theta)
    w1 = torch.where(small, a, torch.sin(a * theta) / sin_theta)
    return quat_normalize(w0 * q0 + w1 * q1)
