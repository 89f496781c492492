# Frozen copy of sr_livo_tpu_torch/ops/ransac.py at commit f22c487785a4: part of the
# benchmark's plain reference (livo_bench/check.py).  Later changes
# to the port do not change it.
"""Batched RANSAC gates: fundamental-matrix and PnP outlier rejection
(port of `sr_livo_tpu/ops/ransac.py`).

Replacements for cv::findFundamentalMat(FM_RANSAC) at
opticalFlowTracker.cpp:144 and cv::solvePnPRansac at
opticalFlowTracker.cpp:295: all hypotheses are evaluated at once as
batched tensors.  The PnP solver refines from the LIO pose prior with
Gauss-Newton.

The JAX package draws its minimal sets from `jax.random.gumbel` and a
top-k, which torch cannot reproduce bit for bit.  So sampling is split:
`gumbel_noise` draws the (n_hyp, n) noise from a `torch.Generator`, and
the gates take that noise as a tensor, so a test can feed both packages
the same draws.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from livo_bench.ref.utils import lie


def gumbel_noise(generator: torch.Generator, n_hyp: int, n: int,
                 device, dtype=torch.float32) -> torch.Tensor:
    """(n_hyp, n) standard Gumbel draws."""
    u = torch.rand((n_hyp, n), generator=generator, device=device,
                   dtype=dtype)
    u = torch.clamp(u, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def _sample_indices(noise: torch.Tensor, p_valid: torch.Tensor,
                    k: int) -> torch.Tensor:
    """(n_hyp, k) indices biased toward valid entries: the top-k of the
    Gumbel noise with invalid entries at -inf.  A stable descending sort
    puts the lower index first among equal logits, as `lax.top_k` does
    (this decides the picks when fewer than k entries are valid)."""
    logits = torch.where(p_valid[None, :], noise,
                         torch.full_like(noise, -math.inf))
    return torch.sort(logits, dim=1, descending=True, stable=True)[1][:, :k]


def fundamental_ransac(p0: torch.Tensor, p1: torch.Tensor,
                       valid: torch.Tensor, noise: torch.Tensor, *,
                       threshold: float = 1.0) -> torch.Tensor:
    """8-point fundamental-matrix RANSAC over noise.shape[0] hypotheses;
    returns the inlier mask.

    cv::findFundamentalMat(..., FM_RANSAC, 1.0, 0.997) semantics:
    hypotheses from normalized 8-point solves, scored by Sampson distance.
    """
    n = p0.shape[0]
    f = dict(dtype=p0.dtype, device=p0.device)
    nv = torch.clamp(torch.sum(valid), min=1)

    def _norm(p):
        mu = torch.sum(torch.where(valid[:, None], p, torch.zeros_like(p)),
                       dim=0) / nv
        d = torch.where(valid, torch.linalg.norm(p - mu, dim=-1),
                        torch.zeros((), **f))
        s = torch.full((), math.sqrt(2.0), **f) / torch.clamp(
            torch.sum(d) / nv, min=1e-6)
        zero, one = torch.zeros((), **f), torch.ones((), **f)
        t = torch.stack([torch.stack([s, zero, -s * mu[0]]),
                         torch.stack([zero, s, -s * mu[1]]),
                         torch.stack([zero, zero, one])])
        return (p - mu) * s, t

    p0n, t0 = _norm(p0)
    p1n, t1 = _norm(p1)

    idx = _sample_indices(noise, valid, 8)                 # (H, 8)
    a0 = p0n[idx]
    a1 = p1n[idx]
    x0, y0 = a0[..., 0], a0[..., 1]
    x1, y1 = a1[..., 0], a1[..., 1]
    one = torch.ones_like(x0)
    a = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1,
                     x0, y0, one], dim=-1)                 # (H, 8, 9)
    # f33 fixed to 1 and the 8x8 system solved directly (no SVD, no rank-2
    # projection), as in the JAX package.
    lhs = a[..., :8] + 1e-8 * torch.eye(8, **f)
    rhs = -a[..., 8]
    f8 = torch.linalg.solve_ex(lhs, rhs[..., None])[0][..., 0]
    fm = torch.cat([f8, torch.ones(f8.shape[:-1] + (1,), **f)],
                   dim=-1).reshape(-1, 3, 3)
    fs = t1.T @ fm @ t0                                    # (H, 3, 3)

    ones = torch.ones((n, 1), **f)
    h0 = torch.cat([p0, ones], dim=-1)                     # (N, 3)
    h1 = torch.cat([p1, ones], dim=-1)
    fe0 = h0 @ fs.transpose(1, 2)                          # (H, N, 3) = F x0
    fe1 = h1 @ fs                                          # (H, N, 3) = F^T x1
    num = torch.sum(h1 * fe0, dim=-1) ** 2
    den = fe0[..., 0] ** 2 + fe0[..., 1] ** 2 + fe1[..., 0] ** 2 \
        + fe1[..., 1] ** 2
    samp = num / torch.clamp(den, min=1e-12)
    inls = valid & (samp < threshold * threshold)          # (H, N)
    counts = torch.sum(inls, dim=-1)
    # (1,) index, not a 0-d one: indexing with a 0-d tensor reads it back
    # to the host, which a CUDA graph capture refuses
    best = torch.argmax(counts, keepdim=True)
    return torch.where(counts[best][0] >= 8, inls[best][0], valid)


def _project(pts3d, q_cw, t_cw, intr):
    pc = lie.quat_rotate(q_cw, pts3d) + t_cw      # broadcasts q over points
    z = torch.where(pc[..., 2] > 1e-3, pc[..., 2],
                    torch.full_like(pc[..., 2], 1e-3))
    u = pc[..., 0] * intr[0] / z + intr[2]
    v = pc[..., 1] * intr[1] / z + intr[3]
    return torch.stack([u, v], dim=-1), pc


def _gn_pose_refine(pts3d, px, w, q0, t0, intr, iters: int):
    """Gauss-Newton on (so3, t) of the camera-from-world pose, minimizing
    weighted reprojection error; batched over hypotheses: w (H, N),
    q0 (H, 4), t0 (H, 3).  Left perturbation of the camera pose:
    pc' = exp(w) pc + dt, so d pc/dw = -[pc]x and d pc/dt = I."""
    q, t = q0, t0
    eye6 = torch.eye(6, dtype=pts3d.dtype, device=pts3d.device)
    fx, fy = intr[0], intr[1]
    for _ in range(iters):
        uv, pc = _project(pts3d, q[:, None, :], t[:, None, :], intr)
        r = (uv - px) * w[..., None]                       # (H, N, 2)
        z = torch.clamp(pc[..., 2], min=1e-3)
        zeros = torch.zeros_like(z)
        j_u_pc = torch.stack([
            torch.stack([fx / z, zeros, -fx * pc[..., 0] / (z * z)], dim=-1),
            torch.stack([zeros, fy / z, -fy * pc[..., 1] / (z * z)], dim=-1)],
            dim=-2)                                        # (H, N, 2, 3)
        eye3 = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
            pc.shape[:-1] + (3, 3))
        j_pc = torch.cat([-lie.skew(pc), eye3], dim=-1)    # (H, N, 3, 6)
        jac = (j_u_pc @ j_pc) * w[..., None, None]         # (H, N, 2, 6)
        jac = jac.reshape(jac.shape[0], -1, 6)
        jtj = jac.transpose(1, 2) @ jac + 1e-6 * eye6
        jtr = (jac.transpose(1, 2) @ r.reshape(r.shape[0], -1, 1))[..., 0]
        dx = -torch.linalg.solve_ex(jtj, jtr[..., None])[0][..., 0]
        q = lie.quat_normalize(lie.quat_mul(lie.exp_so3_quat(dx[:, :3]), q))
        t = t + dx[:, 3:]
    return q, t


def pnp_ransac(pts3d: torch.Tensor, px: torch.Tensor, valid: torch.Tensor,
               q_prior: torch.Tensor, t_prior: torch.Tensor,
               intr: torch.Tensor, noise: torch.Tensor, *,
               threshold: float = 1.5, iters: int = 5
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prior-seeded RANSAC-PnP outlier gate over noise.shape[0] hypotheses.

    Each hypothesis GN-refines (q_cw, t_cw) from the odometry prior on a
    random 4-point minimal set; the best-consensus pose defines the inlier
    mask (reprojection < threshold px).  Returns (inliers, q_best, t_best).
    """
    n_hyp, n = noise.shape
    idx = _sample_indices(noise, valid, 4)
    w = torch.zeros((n_hyp, n), dtype=pts3d.dtype,
                    device=pts3d.device).scatter_(1, idx, 1.0)
    w = w * valid.to(pts3d.dtype)
    q, t = _gn_pose_refine(pts3d, px, w, q_prior.expand(n_hyp, 4),
                           t_prior.expand(n_hyp, 3), intr, iters)
    uv, pc = _project(pts3d, q[:, None, :], t[:, None, :], intr)
    err = torch.linalg.norm(uv - px, dim=-1)
    inls = valid & (err < threshold) & (pc[..., 2] > 1e-3)
    counts = torch.sum(inls, dim=-1)
    best = torch.argmax(counts, keepdim=True)      # (1,): no host read

    # final refinement on the best consensus set
    w_best = inls[best].to(pts3d.dtype)
    q_f, t_f = _gn_pose_refine(pts3d, px, w_best, q[best], t[best], intr,
                               iters)
    q_f, t_f = q_f[0], t_f[0]
    uv, pc = _project(pts3d, q_f, t_f, intr)
    err = torch.linalg.norm(uv - px, dim=-1)
    inl_f = valid & (err < threshold) & (pc[..., 2] > 1e-3)

    ok = counts[best][0] >= 10
    return (torch.where(ok, inl_f, valid),
            torch.where(ok, q_f, q_prior),
            torch.where(ok, t_f, t_prior))
