# Frozen copy of sr_livo_tpu_torch/ops/image_ops.py at commit f22c487785a4: part of the
# benchmark's plain reference (livo_bench/check.py).  Later changes
# to the port do not change it.
"""Image preprocessing ops: undistort-remap, gray, CLAHE, pyramids, Scharr.

Port of `sr_livo_tpu/ops/image_ops.py`: the OpenCV calls of
imageProcessing (src/imageProcessing.cpp:89-200) and the pyramid /
derivative machinery of the vendored LK kernel (src/lkpyramid.cpp).
Images are float32 tensors scaled 0..255 (the reference's uint8
constants); every op is batched and fixed-shape, with no host read.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# BT.601 luma weights (cv::COLOR_RGB2GRAY).
_LUMA = (0.299, 0.587, 0.114)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) -> (H, W) with OpenCV RGB2GRAY weights."""
    return (img[..., 0] * _LUMA[0] + img[..., 1] * _LUMA[1]
            + img[..., 2] * _LUMA[2])


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample img ((H, W) or (H, W, C)) at uv (..., 2) = (u=x=col, v=y=row).

    Matches getSubPixel (lioOptimization.cpp:71-97): bilinear over the four
    neighbours; coordinates are clamped to the valid interior.
    """
    h, w = img.shape[0], img.shape[1]
    u = torch.clamp(uv[..., 0], 0.0, w - 1.001)
    v = torch.clamp(uv[..., 1], 0.0, h - 1.001)
    uf = torch.floor(u)
    vf = torch.floor(v)
    fu = u - uf
    fv = v - vf
    if img.ndim == 3:
        fu, fv = fu[..., None], fv[..., None]
    u0, v0 = uf.to(torch.int64), vf.to(torch.int64)
    u1 = torch.clamp(u0 + 1, 0, w - 1)
    v1 = torch.clamp(v0 + 1, 0, h - 1)
    p00 = img[v0, u0]
    p01 = img[v0, u1]
    p10 = img[v1, u0]
    p11 = img[v1, u1]
    return ((1 - fv) * (1 - fu) * p00 + (1 - fv) * fu * p01
            + fv * (1 - fu) * p10 + fv * fu * p11)


def _window_index(start: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """(M, size) indices of a `size` window whose start is clamped to
    [0, dim - size] (XLA gather CLIP semantics); an axis shorter than the
    window repeats its last index (the JAX package's edge padding)."""
    start = torch.clamp(start.to(torch.int64), 0, max(dim - size, 0))
    off = torch.arange(size, dtype=torch.int64, device=start.device)
    return torch.clamp(start[:, None] + off, max=dim - 1)


def extract_patches(img: torch.Tensor, top_left: torch.Tensor,
                    size: int) -> torch.Tensor:
    """Gather (M, size, size) contiguous patches from a 2-D image.

    top_left: (M, 2) integer (row, col).  Start indices are clamped so the
    window lies in bounds, like the JAX package's CLIP-mode gather, and a
    pyramid level smaller than the window reads its edge pixels."""
    rows = _window_index(top_left[:, 0], size, img.shape[0])
    cols = _window_index(top_left[:, 1], size, img.shape[1])
    return img[rows[:, :, None], cols[:, None, :]]


def sample_windows_bilinear(img: torch.Tensor, centers: torch.Tensor,
                            window: int) -> torch.Tensor:
    """Bilinear (M, window, window) windows centred at fractional pixel
    positions `centers` (M, 2) as (u=x, v=y): one (window+1)^2 patch
    gather per point and a shifted-slice bilinear blend."""
    half = (window - 1) // 2
    u = centers[:, 0] - half
    v = centers[:, 1] - half
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[:, None, None]
    fv = (v - v0)[:, None, None]
    top_left = torch.stack([v0.to(torch.int64), u0.to(torch.int64)], dim=-1)
    p = extract_patches(img, top_left, window + 1)     # (M, W+1, W+1)
    return ((1 - fv) * (1 - fu) * p[:, :window, :window]
            + (1 - fv) * fu * p[:, :window, 1:]
            + fv * (1 - fu) * p[:, 1:, :window]
            + fv * fu * p[:, 1:, 1:])


def make_undistort_map(intrinsic: np.ndarray, dist: np.ndarray,
                       size: Tuple[int, int]) -> np.ndarray:
    """Host-side (H, W, 2) source-pixel map for plumb-bob undistortion.

    Equivalent of cv::initUndistortRectifyMap with new_K == K
    (imageProcessing.cpp:103): for each undistorted pixel, the distorted
    source coordinate (k1, k2, p1, p2, k3 model).
    """
    h, w = size
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    k1, k2, p1, p2, k3 = [float(d) for d in np.asarray(dist).ravel()[:5]]
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    x = (us - cx) / fx
    y = (vs - cy) / fy
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd * fx + cx, yd * fy + cy], axis=-1).astype(np.float32)


def remap(img: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """Apply an (H, W, 2) source map with bilinear sampling (cv::remap)."""
    return bilinear_sample(img, src_map)


def _edge_pad(img: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Pad a 2-D image to (ph, pw) by repeating its last row and column."""
    h, w = img.shape
    rows = torch.clamp(torch.arange(ph, device=img.device), max=h - 1)
    cols = torch.clamp(torch.arange(pw, device=img.device), max=w - 1)
    return img[rows[:, None], cols[None, :]]


def clahe(gray: torch.Tensor, clip_limit: float, n_tiles: int,
          n_bins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization.

    Equivalent of cv::createCLAHE(amp, tiles)->apply (imageEqualize,
    imageProcessing.cpp:166-173): per-tile clipped histogram -> CDF LUTs,
    bilinearly interpolated between the four surrounding tile LUTs.
    The image is padded to a tile multiple with edge replication.
    """
    h, w = gray.shape
    dev, dtype = gray.device, gray.dtype
    th = -(-h // n_tiles)
    tw = -(-w // n_tiles)
    ph, pw = th * n_tiles, tw * n_tiles
    img = _edge_pad(gray, ph, pw) if (ph, pw) != (h, w) else gray

    tiles = img.reshape(n_tiles, th, n_tiles, tw).permute(0, 2, 1, 3)
    tiles = tiles.reshape(n_tiles * n_tiles, th * tw)
    # Bins truncate toward zero, like the JAX package's astype(int32).
    q = torch.clamp(tiles.to(torch.int64), 0, n_bins - 1)
    # Per-tile histogram by one flat index_add_ (adding 1.0 is exact).
    n_t = n_tiles * n_tiles
    flat_bins = (torch.arange(n_t, dtype=torch.int64, device=dev)[:, None]
                 * n_bins + q).reshape(-1)
    hist = torch.zeros((n_t * n_bins,), dtype=dtype, device=dev).index_add_(
        0, flat_bins, torch.ones(flat_bins.shape, dtype=dtype, device=dev))
    hist = hist.reshape(n_t, n_bins)

    # Clip + uniform redistribution (single pass, as OpenCV does).
    tile_px = th * tw
    limit = max(clip_limit * tile_px / n_bins, 1.0)
    clipped = torch.clamp(hist, max=limit)
    excess = torch.sum(hist - clipped, dim=-1, keepdim=True)
    clipped = clipped + excess / n_bins

    cdf = torch.cumsum(clipped, dim=-1)
    # LUT: scale CDF to 0..255 (OpenCV: lutScale = 255 / tile_px).
    lut = cdf * (255.0 / tile_px)                       # (T, bins)
    lut = lut.reshape(n_tiles, n_tiles, n_bins)

    # Per-pixel interpolation between the 4 surrounding tile LUTs: the
    # x-side blend is folded into per-row-tile tables
    # A[r, x, b] = sum_t w_x[x, t] * lut[r, t, b], after which each y-side
    # is one flat gather out0[y, x] = A[ty0[y], x, q[y, x]].
    ys = torch.arange(ph, dtype=dtype, device=dev)
    xs = torch.arange(pw, dtype=dtype, device=dev)
    ty = (ys - th / 2.0 + 0.5) / th
    tx = (xs - tw / 2.0 + 0.5) / tw
    ty0 = torch.clamp(torch.floor(ty).to(torch.int64), 0, n_tiles - 1)
    tx0 = torch.clamp(torch.floor(tx).to(torch.int64), 0, n_tiles - 1)
    ty1 = torch.clamp(ty0 + 1, 0, n_tiles - 1)
    tx1 = torch.clamp(tx0 + 1, 0, n_tiles - 1)
    fy = torch.clamp(ty - ty0, 0.0, 1.0)[:, None]
    fx = torch.clamp(tx - tx0, 0.0, 1.0)

    # x-side blend folded into a dense (pw, T) weight matrix.
    ar = torch.arange(pw, device=dev)
    w_x = torch.zeros((pw, n_tiles), dtype=dtype, device=dev)
    w_x.index_put_((ar, tx0), 1.0 - fx, accumulate=True)
    w_x.index_put_((ar, tx1), fx, accumulate=True)
    a_tab = torch.einsum("xt,rtb->rxb", w_x, lut)       # (T, pw, bins)
    a_flat = a_tab.reshape(-1)
    qimg = torch.clamp(img.to(torch.int64), 0, n_bins - 1)
    base = ar[None, :] * n_bins + qimg
    out0 = a_flat[ty0[:, None] * (pw * n_bins) + base]
    out1 = a_flat[ty1[:, None] * (pw * n_bins) + base]
    out = (1 - fy) * out0 + fy * out1
    return out[:h, :w]


def clahe_tiles_for_width(width: int) -> int:
    """Reference tile-count rule (imageProcessing.cpp:169)."""
    return max(int(width * 32.0 / 640.0), 4)


_RGB2YCRCB = np.array([[0.299, 0.587, 0.114],
                       [0.5, -0.418688, -0.081312],
                       [-0.168736, -0.331264, 0.5]])
_YCRCB2RGB = np.linalg.inv(_RGB2YCRCB)


@functools.lru_cache(maxsize=8)
def _ycrcb_matrices(dtype: torch.dtype, device: torch.device):
    """The two color transforms on a device, built once (a per-call
    upload from numpy is a synchronous copy on CUDA)."""
    f = dict(dtype=dtype, device=device)
    return (torch.as_tensor(_RGB2YCRCB, **f).T.contiguous(),
            torch.as_tensor(_YCRCB2RGB, **f).T.contiguous())


def equalize_color_ycrcb(img: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """CLAHE on the Y channel of YCrCb (equalizeColorImageYcrcb,
    imageProcessing.cpp:185-200), clip limit 1."""
    to_ycc, to_rgb = _ycrcb_matrices(img.dtype, img.device)
    ycc = img @ to_ycc
    y = clahe(ycc[..., 0], 1.0, n_tiles)
    ycc = torch.cat([y[..., None], ycc[..., 1:]], dim=-1)
    out = ycc @ to_rgb
    return torch.clamp(out, 0.0, 255.0)


def _conv_sep(img: torch.Tensor, k, axis: int) -> torch.Tensor:
    """Small odd-length 1-D correlation along `axis` of a 2-D image as
    shifted-slice adds with a zero border; `k` is a sequence of floats."""
    taps = len(k)
    r = taps // 2
    p = F.pad(img, (r, r) if axis == 1 else (0, 0, r, r))
    h, w = img.shape
    out = None
    for i in range(taps):
        sl = p[i:i + h, :] if axis == 0 else p[:, i:i + w]
        term = k[i] * sl
        out = term if out is None else out + term
    return out


_GAUSS5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Gaussian 5x5 blur + 2x decimation (cv::pyrDown equivalent)."""
    x = _conv_sep(img, _GAUSS5, axis=1)
    x = _conv_sep(x, _GAUSS5, axis=0)
    return x[::2, ::2]


def build_pyramid(gray: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """List of `levels + 1` images, level 0 = full resolution."""
    pyr = [gray]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def scharr_derivatives(img: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scharr x/y derivatives with the reference's 1/32 scaling
    (calcSharrDeriv, lkpyramid.cpp:57-150: smooth [3 10 3], diff [-1 0 1])."""
    smooth = (3.0, 10.0, 3.0)
    diff = (-1.0, 0.0, 1.0)

    def sep(kx, ky):
        return _conv_sep(_conv_sep(img, kx, axis=1), ky, axis=0)

    dx = sep(diff, smooth) / 32.0
    dy = sep(smooth, diff) / 32.0
    return dx, dy
