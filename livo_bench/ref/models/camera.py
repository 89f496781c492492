# Frozen copy of sr_livo_tpu_torch/models/camera.py at commit f22c487785a4: part of the
# benchmark's plain reference (livo_bench/check.py).  Later changes
# to the port do not change it.
"""Camera-parameter ESIKFs: 11-dof reprojection + 6-dof photometric (port
of `sr_livo_tpu/models/camera.py`).

The vision filters of src/imageProcessing.cpp: `vio_esikf` (vioEsikf,
:220-380) iterates the 11-dim camera error state [td, so3_ic(3),
t_ic(3), fx, fy, cx, cy] on pixel reprojection residuals of tracked map
points; `vio_photometric` (vioPhotometric, :402-552) iterates the 6-dim
extrinsic block on RGB photometric residuals weighted by per-point color
information.  Both are fixed-iteration masked batch programs; the
decision to keep the update is a 0-d bool tensor applied with
`torch.where`, so nothing is read back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from livo_bench.ref.ops import image_ops
from livo_bench.ref.utils import lie

MIN_ITERATION_POINTS = 10      # imageProcessing.cpp:218
NUM_ITERATIONS = 2             # imageProcessing.cpp:20


class CameraState(NamedTuple):
    td: torch.Tensor       # () time offset
    q_ic: torch.Tensor     # (4,) R_imu_camera as quaternion (wxyz)
    t_ic: torch.Tensor     # (3,)
    intr: torch.Tensor     # (4,) fx, fy, cx, cy
    cov: torch.Tensor      # (11, 11)


def init_camera_state(r_ic, t_ic, intr, dtype=torch.float32,
                      device="cpu") -> CameraState:
    """Initial covariance per setInitialCov (imageProcessing.cpp:65-72)."""
    f = dict(dtype=dtype, device=device)
    cov = torch.eye(11, **f)
    cov[0, 0] = 1e-5
    cov[1:7, 1:7] = torch.eye(6, **f) * 1e-3
    cov[7:11, 7:11] = torch.eye(4, **f) * 1e-3
    return CameraState(
        td=torch.zeros((), **f),
        q_ic=lie.rot_to_quat(torch.as_tensor(r_ic, **f)),
        t_ic=torch.as_tensor(t_ic, **f),
        intr=torch.as_tensor(intr, **f),
        cov=cov)


def world_camera_pose(cam: CameraState, q_wi: torch.Tensor,
                      t_wi: torch.Tensor):
    """(q_wc, t_wc, q_cw, t_cw) from the IMU pose and extrinsic."""
    q_wc = lie.quat_normalize(lie.quat_mul(q_wi, cam.q_ic))
    t_wc = lie.quat_rotate(q_wi, cam.t_ic) + t_wi
    q_cw = lie.quat_conj(q_wc)
    t_cw = -lie.quat_rotate(q_cw, t_wc)
    return q_wc, t_wc, q_cw, t_cw


def huber_scale(r: torch.Tensor, thresh: float = 1.0) -> torch.Tensor:
    """getHuberLoss (imageProcessing.cpp:202-216)."""
    r_safe = torch.clamp(r, min=1e-9)
    big = (2.0 * torch.sqrt(r_safe) / math.sqrt(thresh) - 1.0) / r_safe
    return torch.where(r / thresh < 1.0, torch.ones_like(r), big)


def measurement_weight(n_new_visited: torch.Tensor) -> torch.Tensor:
    """cam_measurement_weight (imageProcessing.cpp:272)."""
    nv = torch.clamp(n_new_visited.to(torch.float32), min=1.0)
    return torch.clamp(torch.full_like(nv, 5.0) / nv, 0.001, 0.01)


def _camera_projection_blocks(cam: CameraState, pts_world, q_cw, t_cw):
    """Shared projection + Jacobian pieces: (uv, pc, j_u_pc)."""
    pc = lie.quat_rotate(q_cw, pts_world) + t_cw
    z = torch.clamp(pc[..., 2], min=1e-3)
    fx, fy, cx, cy = cam.intr[0], cam.intr[1], cam.intr[2], cam.intr[3]
    u = pc[..., 0] * fx / z + cx
    v = pc[..., 1] * fy / z + cy
    uv = torch.stack([u, v], dim=-1)
    zeros = torch.zeros_like(z)
    j_u_pc = torch.stack([
        torch.stack([fx / z, zeros, -fx * pc[..., 0] / (z * z)], dim=-1),
        torch.stack([zeros, fy / z, -fy * pc[..., 1] / (z * z)], dim=-1)],
        dim=-2)                                             # (N, 2, 3)
    return uv, pc, j_u_pc


def _j0(d_so3: torch.Tensor, n: int, at: int) -> torch.Tensor:
    """Identity of size n with I - 0.5 [d_so3]x in the rotation block."""
    j = torch.eye(n, dtype=d_so3.dtype, device=d_so3.device)
    j[at:at + 3, at:at + 3] = (torch.eye(3, dtype=d_so3.dtype,
                                         device=d_so3.device)
                               - 0.5 * lie.skew(d_so3))
    return j


def _inv(a: torch.Tensor) -> torch.Tensor:
    # inv_ex: no error check, so no host read on CUDA (JAX never raises).
    return torch.linalg.inv_ex(a)[0]


def _keep_if(ok: torch.Tensor, new: CameraState,
             old: CameraState) -> CameraState:
    return CameraState(*(torch.where(ok, a, b) for a, b in zip(new, old)))


def vio_esikf(cam: CameraState, q_wi: torch.Tensor, t_wi: torch.Tensor,
              pts_world: torch.Tensor, px_match: torch.Tensor,
              img_vel: torch.Tensor, valid: torch.Tensor,
              n_new_visited: torch.Tensor, *, estimate_intrinsic: bool = True,
              estimate_extrinsic: bool = True
              ) -> Tuple[CameraState, torch.Tensor]:
    """11-dof reprojection ESIKF (vioEsikf).  Returns (new_cam, ok)."""
    dtype = cam.cov.dtype
    dev = cam.cov.device
    m = pts_world.shape[0]
    ok = torch.sum(valid) >= MIN_ITERATION_POINTS
    w = measurement_weight(torch.as_tensor(n_new_visited, device=dev))
    eye11 = torch.eye(11, dtype=dtype, device=dev)
    vmask = valid.to(dtype)

    pred = cam  # linearization point for d_x
    c = cam
    for _ in range(NUM_ITERATIONS):
        _, _, q_cw, t_cw = world_camera_pose(c, q_wi, t_wi)
        uv, pc, j_u_pc = _camera_projection_blocks(c, pts_world, q_cw, t_cw)
        proj = uv + c.td * img_vel
        res = proj - px_match                                 # (M, 2)
        h_l = huber_scale(torch.linalg.norm(res, dim=-1))

        h_rows = torch.zeros((m, 2, 11), dtype=dtype, device=dev)
        h_rows[:, :, 0] = img_vel
        if estimate_extrinsic:
            r_ic = lie.quat_to_rot(c.q_ic)
            h_rows[:, :, 1:4] = j_u_pc @ lie.skew(pc)
            h_rows[:, :, 4:7] = -(j_u_pc @ r_ic.T)
        if estimate_intrinsic:
            z = torch.clamp(pc[..., 2], min=1e-3)
            h_rows[:, 0, 7] = pc[..., 0] / z
            h_rows[:, 1, 8] = pc[..., 1] / z
            h_rows[:, 0, 9] = 1.0
            h_rows[:, 1, 10] = 1.0

        scale = h_l * vmask
        h_mat = (h_rows * scale[:, None, None]).reshape(2 * m, 11)
        r_vec = (res * scale[:, None]).reshape(2 * m)

        d_so3 = lie.quat_to_so3(lie.quat_mul(lie.quat_conj(pred.q_ic),
                                             c.q_ic))
        d_x = torch.cat([(c.td - pred.td)[None], d_so3, c.t_ic - pred.t_ic,
                         c.intr - pred.intr])
        j0 = _j0(d_so3, 11, 1)

        hth = h_mat.T @ h_mat
        prior = _inv(j0 @ cam.cov @ j0.T * w)
        kk = _inv(hth + prior)                                 # (11, 11)
        k_h = kk @ (h_mat.T @ r_vec)
        k_hmat = kk @ hth                                      # K H
        sol = -k_h - (eye11 - k_hmat) @ (j0 @ d_x)
        c = _update_camera(c, sol)

    j_k = _j0(sol[1:4], 11, 1)
    cov_new = j_k @ (eye11 - k_hmat) @ cam.cov @ j_k.T
    return _keep_if(ok, c._replace(cov=cov_new), cam), ok


def _update_camera(c: CameraState, d_x: torch.Tensor) -> CameraState:
    """updateCameraParameters 11-dof (imageProcessing.cpp:382-400)."""
    return c._replace(
        td=c.td + d_x[0],
        q_ic=lie.quat_normalize(
            lie.quat_mul(c.q_ic, lie.exp_so3_quat(d_x[1:4]))),
        t_ic=c.t_ic + d_x[4:7],
        intr=c.intr + d_x[7:11])


def color_gradient(image: torch.Tensor, uv: torch.Tensor, ssd: int = 5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Subpixel color + finite-difference gradients
    (cloudFrame::getRgb, lioOptimization.cpp:99-140)."""
    def at(du, dv):
        return image_ops.bilinear_sample(
            image, torch.stack([uv[..., 0] + du, uv[..., 1] + dv], dim=-1))

    c0 = image_ops.bilinear_sample(image, uv)
    dx = torch.zeros_like(c0)
    dy = torch.zeros_like(c0)
    denom = 0.0
    for b in range(1, ssd):
        dx = dx + at(b, 0.0) - at(-b, 0.0)
        dy = dy + at(0.0, b) - at(0.0, -b)
        denom += 2 * b
    return c0, dx / denom, dy / denom


def vio_photometric(cam: CameraState, q_wi: torch.Tensor, t_wi: torch.Tensor,
                    image: torch.Tensor,
                    pts_world: torch.Tensor, pt_rgb: torch.Tensor,
                    pt_rgb_cov: torch.Tensor, pt_n_rgb: torch.Tensor,
                    img_vel: torch.Tensor, valid: torch.Tensor,
                    n_new_visited: torch.Tensor
                    ) -> Tuple[CameraState, torch.Tensor]:
    """6-dof photometric ESIKF (vioPhotometric).  Returns (new_cam, ok)."""
    dtype = cam.cov.dtype
    dev = cam.cov.device
    m = pts_world.shape[0]
    use = valid & (pt_n_rgb >= 3)                  # imageProcessing.cpp:465
    ok = torch.sum(use) >= MIN_ITERATION_POINTS
    w = measurement_weight(torch.as_tensor(n_new_visited, device=dev))
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    vmask = use.to(dtype)
    info = 1.0 / torch.clamp(pt_rgb_cov, min=1e-4)  # (M, 3) diag R^-1
    r_inv = (info * vmask[:, None]).reshape(3 * m)
    cov6 = cam.cov[1:7, 1:7]

    pred = cam
    c = cam
    for _ in range(NUM_ITERATIONS):
        _, _, q_cw, t_cw = world_camera_pose(c, q_wi, t_wi)
        uv, pc, j_u_pc = _camera_projection_blocks(c, pts_world, q_cw, t_cw)
        proj = uv + c.td * img_vel
        obs, g_dx, g_dy = color_gradient(image, proj)
        res = obs - pt_rgb                         # (M, 3)
        h_l = huber_scale(torch.linalg.norm(res, dim=-1))

        j_color_u = torch.stack([g_dx, g_dy], dim=-1)        # (M, 3, 2)
        j_color_pc = j_color_u @ j_u_pc                       # (M, 3, 3)
        r_ic = lie.quat_to_rot(c.q_ic)
        h_rows = torch.cat([j_color_pc @ lie.skew(pc),
                            -(j_color_pc @ r_ic.T)], dim=-1)  # (M, 3, 6)
        scale = h_l * vmask
        h_mat = (h_rows * scale[:, None, None]).reshape(3 * m, 6)
        r_vec = (res * scale[:, None]).reshape(3 * m)

        d_so3 = lie.quat_to_so3(lie.quat_mul(lie.quat_conj(pred.q_ic),
                                             c.q_ic))
        d_x = torch.cat([d_so3, c.t_ic - pred.t_ic])
        j0 = _j0(d_so3, 6, 0)

        ht_rinv = h_mat.T * r_inv[None, :]
        hth = ht_rinv @ h_mat
        prior = _inv(j0 @ cov6 @ j0.T * w)
        kk = _inv(hth + prior)
        k_h = kk @ (ht_rinv @ r_vec)
        k_hmat = kk @ hth
        sol = -k_h - (eye6 - k_hmat) @ (j0 @ d_x)
        c = c._replace(
            q_ic=lie.quat_normalize(
                lie.quat_mul(c.q_ic, lie.exp_so3_quat(sol[0:3]))),
            t_ic=c.t_ic + sol[3:6])

    j_k = _j0(sol[0:3], 6, 0)
    cov = cam.cov.clone()
    cov[1:7, 1:7] = j_k @ (eye6 - k_hmat) @ cov6 @ j_k.T
    return _keep_if(ok, c._replace(cov=cov), cam), ok
