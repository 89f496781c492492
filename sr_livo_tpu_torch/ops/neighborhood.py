"""Batched neighborhood PCA: closed-form symmetric 3x3 eigendecomposition.

Port of `sr_livo_tpu/ops/neighborhood.py` (computeNeighborhoodDistribution,
optimize.cpp:316-353): trigonometric eigenvalues and the row-cross-product
eigenvector, vectorized over all keypoints.  `neighborhood_distribution`
is the plain PyTorch version of the association entry of the plane-fit
CUDA kernel (ops/plane_fit.py).
"""

from __future__ import annotations

from typing import Tuple

import torch

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def eigvals_sym3x3(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), descending: [l1 >= l2 >= l3]."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))

    # det(B)/2 with B = (A - qI)/p
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    l2 = 3.0 * q - l1 - l3

    degenerate = p2 < 1e-20
    lq = torch.stack([q, q, q], dim=-1)
    ls = torch.stack([l1, l2, l3], dim=-1)
    return torch.where(degenerate[..., None], lq, ls)


def eigvec_for(a: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric (..., 3, 3) for eigenvalue lam (...,).

    Cross product of rows of (A - lam I), taking the largest-norm of the
    three row pairs (the first on ties); on full degeneracy returns e_z.
    """
    m = a - lam[..., None, None] * torch.eye(3, dtype=a.dtype, device=a.device)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    cands = torch.stack([c01, c02, c12], dim=-2)
    norms = torch.stack([n01, n02, n12], dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    nrm = torch.linalg.norm(v, dim=-1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype,
                            device=a.device).expand(v.shape)
    return torch.where(nrm > 1e-12, v / torch.clamp(nrm, min=1e-30), fallback)


def neighborhood_distribution(neighbors: torch.Tensor, n_valid: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Per-query PCA over masked neighbor sets.

    neighbors: (Q, M, 3) with the first n_valid[q] entries valid.
    Returns (normal (Q, 3), a2D (Q,), barycenter (Q, 3)) where `normal` is
    the smallest-eigenvalue direction and a2D = (s2 - s3)/s1 with
    s_i = sqrt(|l_i|).
    """
    _, m, _ = neighbors.shape
    mask = (torch.arange(m, device=neighbors.device)[None, :]
            < n_valid[:, None]).to(neighbors.dtype)
    cnt = torch.clamp(n_valid.to(neighbors.dtype), min=1.0)
    bary = torch.sum(neighbors * mask[..., None], dim=1) / cnt[:, None]
    centered = (neighbors - bary[:, None, :]) * mask[..., None]
    # Scatter matrix (not normalized by count — matches the reference).
    cov = torch.einsum("qmi,qmj->qij", centered, centered)
    lams = eigvals_sym3x3(cov)
    normal = eigvec_for(cov, lams[..., 2])
    s = torch.sqrt(torch.abs(lams))
    a2d = (s[..., 1] - s[..., 2]) / torch.clamp(s[..., 0], min=1e-12)
    return normal, a2d, bary
