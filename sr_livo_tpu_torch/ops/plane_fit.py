"""Plane-residual rows: the CUDA kernel, its plain PyTorch versions and
the dispatchers the IEKF calls.

The CUDA kernel (`csrc/plane_fit.cu`) replaces the JAX package's one
Pallas TPU kernel, `sr_livo_tpu/ops/pallas/plane_fit.py::
plane_residuals_pallas`.  It has two entries:

  * `plane_rows`  — the full per-keypoint row (neighbourhood PCA, normal
    orientation, planarity weight, point-to-plane distance, Jacobian row
    and mask): what `plane_residuals_pallas` computes, used by the
    `cache_association=False` IEKF once per iteration;
  * `plane_assoc` — the association half (unflipped normal, planarity
    a2d, closest neighbour) that the default cached-association IEKF
    computes once per update and reuses across iterations.

Each dispatcher takes the plain PyTorch version for CPU tensors only; on a
CUDA tensor it launches the kernel or raises (there is no fallback).
`launches` counts kernel launches per entry so a run can show that the
main path went through the kernel.

What bounds the kernel on an H100: `plane_rows` at the main path's
Q = 1024 keypoints and M = 20 neighbours moves ~0.3 MB (~0.1 us at
3.35 TB/s), `plane_assoc` on 512-row slices about half that, and each
does a few hundred float operations per keypoint, so launch latency
bounds it.
The design does nothing about that yet (one warp per keypoint); CUDA
graphs and fusing with the kNN gather are later work.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from sr_livo_tpu_torch import kernels
from sr_livo_tpu_torch.ops import neighborhood as nb_ops

# Kernel launches per entry since the last reset_launches().
launches = {"plane_rows": 0, "plane_assoc": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernel's oracle)
# ---------------------------------------------------------------------------

def plane_rows_from_assoc(normal0, a2d, closest, n_found, world, location,
                          r_world, last_trans, keypts_valid, *, lam_w,
                          lam_nb, power_planarity, max_dist, min_neighbors):
    """Pose-dependent tail of buildPlaneResiduals given a fixed association
    (port of `models/lio.py::_plane_rows_from_assoc`)."""
    enough = n_found >= min_neighbors
    # Orient normal toward the previous sensor position (optimize.cpp:49-51).
    flip = torch.sum(normal0 * (last_trans[None, :] - world), dim=-1) < 0
    normal = torch.where(flip[:, None], -normal0, normal0)

    planarity_w = a2d ** power_planarity
    closest_dist = torch.linalg.norm(closest - world, dim=-1)
    weight = (lam_w * planarity_w
              + lam_nb * torch.exp(-closest_dist / (max_dist * min_neighbors)))

    norm_offset = -torch.sum(normal * closest, dim=-1)
    distance = torch.sum(normal * world, dim=-1) + norm_offset

    good = keypts_valid & enough & (distance < max_dist)
    w = torch.where(good, weight, torch.zeros_like(weight))
    # J_rot = -n^T R [loc]x  (optimize.cpp:101)
    u = normal @ r_world
    j_rot = -torch.linalg.cross(u, location, dim=-1)
    h_x = torch.cat([normal * w[:, None], j_rot * w[:, None]], dim=-1)
    h = torch.where(good, distance * weight, torch.zeros_like(distance))
    return h_x, h, good


def plane_assoc_plain(neighbors: torch.Tensor, n_found: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(normal (Q, 3), a2d (Q,), closest (Q, 3)) of distance-sorted kNN
    rows: the association of `models/lio.py::chunked_assoc`."""
    normal, a2d, _ = nb_ops.neighborhood_distribution(neighbors, n_found)
    return normal, a2d, neighbors[:, 0, :]


def plane_rows_plain(neighbors, n_found, world, location, r_world,
                     last_trans, valid, *, lam_w, lam_nb, power_planarity,
                     max_dist, min_neighbors):
    """Port of `models/lio.py::_plane_rows_jnp`: (h_x (Q, 6), h (Q,),
    good (Q,)); the residual-cap prefix mask is the caller's."""
    normal, a2d, closest = plane_assoc_plain(neighbors, n_found)
    return plane_rows_from_assoc(
        normal, a2d, closest, n_found, world, location, r_world, last_trans,
        valid, lam_w=lam_w, lam_nb=lam_nb, power_planarity=power_planarity,
        max_dist=max_dist, min_neighbors=min_neighbors)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use) with its C signatures."""
    lib = kernels.load("plane_fit")
    lib.plane_rows_launch.restype = ctypes.c_int
    lib.plane_rows_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, _P, _P, _P, _P]
    lib.plane_assoc_launch.restype = ctypes.c_int
    lib.plane_assoc_launch.argtypes = [
        _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P]
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_neighbors(neighbors, n_found):
    if neighbors.dim() != 3 or neighbors.shape[2] != 3 or neighbors.shape[1] < 1:
        raise ValueError(f"neighbors: shape {tuple(neighbors.shape)}, "
                         "expected (Q, M >= 1, 3)")
    q, m, _ = neighbors.shape
    dev = neighbors.device
    if dev.type != "cuda":
        raise ValueError(f"neighbors: on {dev}; the kernel takes CUDA tensors")
    _check("neighbors", neighbors, torch.float32, (q, m, 3), dev)
    _check("n_found", n_found, torch.int32, (q,), dev)
    return q, m, dev


def _raise_on(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def plane_rows_cuda(neighbors, n_found, world, location, r_world, last_trans,
                    valid, *, lam_w, lam_nb, power_planarity, max_dist,
                    min_neighbors):
    """Full-row entry of the CUDA kernel (CUDA tensors only)."""
    q, m, dev = _check_neighbors(neighbors, n_found)
    _check("world", world, torch.float32, (q, 3), dev)
    _check("location", location, torch.float32, (q, 3), dev)
    _check("r_world", r_world, torch.float32, (3, 3), dev)
    _check("last_trans", last_trans, torch.float32, (3,), dev)
    _check("valid", valid, torch.bool, (q,), dev)
    h_x = torch.empty((q, 6), dtype=torch.float32, device=dev)
    h = torch.empty((q,), dtype=torch.float32, device=dev)
    good = torch.empty((q,), dtype=torch.bool, device=dev)
    if q == 0:
        return h_x, h, good
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.plane_rows_launch(
            neighbors.data_ptr(), n_found.data_ptr(), world.data_ptr(),
            location.data_ptr(), r_world.data_ptr(), last_trans.data_ptr(),
            valid.data_ptr(), q, m, float(lam_w), float(lam_nb),
            float(power_planarity), float(max_dist), int(min_neighbors),
            float(max_dist * min_neighbors), h_x.data_ptr(), h.data_ptr(),
            good.data_ptr(), stream)
    _raise_on("plane_rows", err)
    launches["plane_rows"] += 1
    return h_x, h, good


def plane_assoc_cuda(neighbors, n_found):
    """Association entry of the CUDA kernel (CUDA tensors only)."""
    q, m, dev = _check_neighbors(neighbors, n_found)
    normal = torch.empty((q, 3), dtype=torch.float32, device=dev)
    a2d = torch.empty((q,), dtype=torch.float32, device=dev)
    closest = torch.empty((q, 3), dtype=torch.float32, device=dev)
    if q == 0:
        return normal, a2d, closest
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.plane_assoc_launch(
            neighbors.data_ptr(), n_found.data_ptr(), q, m,
            normal.data_ptr(), a2d.data_ptr(), closest.data_ptr(), stream)
    _raise_on("plane_assoc", err)
    launches["plane_assoc"] += 1
    return normal, a2d, closest


# ---------------------------------------------------------------------------
# Dispatchers: plain version for CPU tensors, the kernel for CUDA tensors
# ---------------------------------------------------------------------------

def plane_rows(neighbors, n_found, world, location, r_world, last_trans,
               valid, **kw):
    if neighbors.device.type == "cpu":
        return plane_rows_plain(neighbors, n_found, world, location, r_world,
                                last_trans, valid, **kw)
    if neighbors.device.type == "cuda":
        return plane_rows_cuda(neighbors, n_found, world, location, r_world,
                               last_trans, valid, **kw)
    raise ValueError(f"plane_rows: unsupported device {neighbors.device}")


def plane_assoc(neighbors, n_found):
    if neighbors.device.type == "cpu":
        return plane_assoc_plain(neighbors, n_found)
    if neighbors.device.type == "cuda":
        return plane_assoc_cuda(neighbors, n_found)
    raise ValueError(f"plane_assoc: unsupported device {neighbors.device}")
