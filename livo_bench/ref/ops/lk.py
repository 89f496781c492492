# Frozen copy of sr_livo_tpu_torch/ops/lk.py at commit f22c487785a4: part of the
# benchmark's plain reference (livo_bench/check.py).  Later changes
# to the port do not change it.
"""Batched pyramidal Lucas-Kanade optical flow (port of
`sr_livo_tpu/ops/lk.py`).

The vendored OpenCV LK kernel (src/lkpyramid.cpp) solved point by point;
here all <= M tracks are solved as one batched tensor program per pyramid
level: bilinear window gathers, 2x2 normal equations and masked
Gauss-Newton iterations.  The previous frame's pyramid and Scharr maps are
reused across frames (the reference's swapImageBuffer trick,
lkpyramid.cpp:744-753) by keeping them in the vision module.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from livo_bench.ref.ops import image_ops


class LkParams(NamedTuple):
    window: int = 21
    levels: int = 3            # pyramid levels above full-res (0..levels)
    iters: int = 10
    eps: float = 0.05
    min_eig_threshold: float = 1e-4
    patch_buffer: int = 6      # in-patch motion margin per level (pixels)


def _track_level(img_prev, img_cur, dx_prev, dy_prev, pts_prev, guess,
                 valid, params: LkParams):
    """One pyramid level: returns (new_guess, ok, min_eig).

    One (W+1+2B)^2 patch of the current image is gathered per point around
    the level-entry guess, and each iteration's bilinear window is taken
    from it with two small selection matmuls (window = S_v @ patch @ S_u^T).
    A point whose iterate drifts more than B pixels inside one level
    samples a clamped window.

    The JAX package loops while any point is live; a dead point never
    moves and `live` only shrinks, so exactly `params.iters` masked
    iterations give the same result with no host read.
    """
    w = params.window
    i_prev = image_ops.sample_windows_bilinear(img_prev, pts_prev, w)
    gx = image_ops.sample_windows_bilinear(dx_prev, pts_prev, w)
    gy = image_ops.sample_windows_bilinear(dy_prev, pts_prev, w)
    m = guess.shape[0]
    i_prev = i_prev.reshape(m, -1)                           # (M, W^2)
    gx = gx.reshape(m, -1)
    gy = gy.reshape(m, -1)

    a11 = torch.sum(gx * gx, dim=-1)
    a12 = torch.sum(gx * gy, dim=-1)
    a22 = torch.sum(gy * gy, dim=-1)
    det = a11 * a22 - a12 * a12
    tr = a11 + a22
    w2 = params.window * params.window
    min_eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) \
        / (2.0 * w2)
    ok_g = (min_eig > params.min_eig_threshold) & (det > 1e-12)
    det_safe = torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))

    h, iw = img_cur.shape
    half = (w - 1) // 2
    buf = params.patch_buffer
    p_sz = w + 1 + 2 * buf

    # One contiguous patch per point around the level-entry guess.
    tl_u = torch.floor(guess[:, 0] - half).to(torch.int64) - buf
    tl_v = torch.floor(guess[:, 1] - half).to(torch.int64) - buf
    tl_u = torch.clamp(tl_u, 0, max(iw - p_sz, 0))
    tl_v = torch.clamp(tl_v, 0, max(h - p_sz, 0))
    patch = image_ops.extract_patches(
        img_cur, torch.stack([tl_v, tl_u], dim=-1), p_sz)   # (M, P, P)

    f = dict(dtype=guess.dtype, device=guess.device)
    win_idx = torch.arange(w, **f)
    p_idx = torch.arange(p_sz, **f)

    def _sel_matrix(off):
        """(M, W, P) bilinear selection rows: S[m, i, p] picks patch
        column/row floor(off)+i with weight (1-f), +1 with weight f."""
        o0 = torch.floor(off)
        fr = (off - o0)[:, None, None]
        pos = o0[:, None, None] + win_idx[None, :, None]     # (M, W, 1)
        d = p_idx[None, None, :] - pos                       # (M, W, P)
        zero = torch.zeros((), **f)
        return (torch.where(d == 0.0, 1.0 - fr, zero)
                + torch.where(d == 1.0, fr, zero))

    max_off = float(np.float32(p_sz - w - 1) - np.float32(1e-3))
    live = ok_g & valid
    tl_uf, tl_vf = tl_u.to(guess.dtype), tl_v.to(guess.dtype)
    for _ in range(params.iters):
        ou = torch.clamp(guess[:, 0] - half - tl_uf, 0.0, max_off)
        ov = torch.clamp(guess[:, 1] - half - tl_vf, 0.0, max_off)
        s_u = _sel_matrix(ou)                                # (M, W, P)
        s_v = _sel_matrix(ov)
        rows = torch.bmm(s_v, patch)                         # (M, W, P)
        i_cur = torch.bmm(rows, s_u.transpose(1, 2))         # (M, W, W)
        diff = i_cur.reshape(m, -1) - i_prev
        b1 = torch.sum(diff * gx, dim=-1)
        b2 = torch.sum(diff * gy, dim=-1)
        du = -(a22 * b1 - a12 * b2) / det_safe
        dv = -(a11 * b2 - a12 * b1) / det_safe
        delta = torch.stack([du, dv], dim=-1)
        guess = torch.where(live[:, None], guess + delta, guess)
        live = live & (torch.sum(delta * delta, dim=-1) >= params.eps ** 2)

    half_f = (params.window - 1) / 2.0
    inb = ((guess[:, 0] > half_f) & (guess[:, 0] < iw - half_f - 1)
           & (guess[:, 1] > half_f) & (guess[:, 1] < h - half_f - 1))
    inb_prev = ((pts_prev[:, 0] > half_f) & (pts_prev[:, 0] < iw - half_f - 1)
                & (pts_prev[:, 1] > half_f)
                & (pts_prev[:, 1] < h - half_f - 1))
    return guess, ok_g & inb & inb_prev, min_eig


def track_pyramidal(prev_pyr: Tuple[torch.Tensor, ...],
                    cur_pyr: Tuple[torch.Tensor, ...],
                    prev_dx: Tuple[torch.Tensor, ...],
                    prev_dy: Tuple[torch.Tensor, ...],
                    pts_prev: torch.Tensor,       # (M, 2) full-res pixels
                    valid: torch.Tensor,          # (M,) bool
                    params: LkParams = LkParams(),
                    init_flow: Optional[torch.Tensor] = None,  # (M, 2) px
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track points from prev -> cur through the pyramid (coarse to fine).

    Returns (pts_cur (M, 2), status (M,) bool).  Derivatives are of the
    *previous* image per level (lkpyramid.cpp:231-334).  `init_flow` seeds
    the coarsest-level iterate at pts_prev + init_flow (OpenCV's
    OPTFLOW_USE_INITIAL_FLOW); a coarse level that fails with the seed
    falls back to the identity guess.
    """
    n_levels = len(prev_pyr)
    scale = 2.0 ** (n_levels - 1)
    guess = (pts_prev if init_flow is None else pts_prev + init_flow) / scale
    status = valid
    for lvl in range(n_levels - 1, -1, -1):
        p_l = pts_prev / (2.0 ** lvl)
        guess, ok, _eig = _track_level(
            prev_pyr[lvl], cur_pyr[lvl], prev_dx[lvl], prev_dy[lvl],
            p_l, guess, valid, params)
        if lvl == 0:
            status = status & ok
        else:
            # keep coarse failures alive but reset their guess to identity
            guess = torch.where(ok[:, None], guess, p_l)
            guess = guess * 2.0
    return guess, status


def precompute_frame(gray: torch.Tensor, levels: int):
    """Build (pyramid, dx, dy) tuples for one frame (reused as `prev`)."""
    pyr = image_ops.build_pyramid(gray, levels)
    dxs, dys = [], []
    for img in pyr:
        dx, dy = image_ops.scharr_derivatives(img)
        dxs.append(dx)
        dys.append(dy)
    return tuple(pyr), tuple(dxs), tuple(dys)
