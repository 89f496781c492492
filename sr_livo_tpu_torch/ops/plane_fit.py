"""Plane-residual rows: the CUDA kernel, its plain PyTorch versions and
the dispatchers the IEKF calls.

The CUDA kernel (`csrc/plane_fit.cu`) replaces the JAX package's one
Pallas TPU kernel, `sr_livo_tpu/ops/pallas/plane_fit.py::
plane_residuals_pallas`.  Its two fused entries take the voxel map and
the keypoints and do the whole association in one launch (voxel-hash
probe, candidate distances, top-M selection, neighbourhood PCA, tail):

  * `knn_plane_rows`  — the full per-keypoint row (normal orientation,
    planarity weight, point-to-plane distance, Jacobian row, mask): what
    the kNN gather plus `plane_residuals_pallas` compute, used by the
    `cache_association=False` IEKF once per iteration;
  * `knn_plane_assoc` — the association (unflipped normal, planarity a2d,
    closest neighbour, neighbour count) that the default cached-
    association IEKF computes once per update and reuses across
    iterations.  It counts the valid keypoint prefix on the device and
    zeroes the rows beyond it, so the call reads nothing back to the host.

Two earlier entries take finished neighbour rows (`plane_rows`,
`plane_assoc`); they are off the main path and stay as kernels of their
own.

Each dispatcher takes the plain PyTorch version for CPU tensors only; on a
CUDA tensor it launches the kernel or raises (there is no fallback).
`launches` counts kernel launches per entry so a run can show that the
main path went through the kernel.

What bounds the fused entries on an H100, and what the design does about
it, is in the kernel source's head note.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from sr_livo_tpu_torch import kernels
from sr_livo_tpu_torch.ops import neighborhood as nb_ops
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.utils import graphs

# Kernel launches per entry since the last reset_launches().  A launch
# inside a captured program (utils.graphs) counts on each replay.
launches = graphs.register_counter(
    {"plane_rows": 0, "plane_assoc": 0, "knn_plane_assoc": 0,
     "knn_plane_rows": 0})


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
    rows: the association half of `models/lio.py::chunked_assoc`."""
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


def _knn_found(vmap, world, threshold_capacity, *, voxel_size, max_neighbors,
              max_probe, nb_voxels):
    """(neighbors (Q, M, 3), n_found (Q,) int32): the plain kNN."""
    neighbors, nb_ok, _ = vm.knn(
        vmap, world, voxel_size=voxel_size, max_neighbors=max_neighbors,
        max_probe=max_probe, nb_voxels=nb_voxels,
        threshold_capacity=threshold_capacity)
    return neighbors, torch.sum(nb_ok, dim=1, dtype=torch.int32)


def knn_plane_assoc_plain(vmap, world, keypts_valid, threshold_capacity, *,
                          voxel_size, max_neighbors, max_probe, nb_voxels,
                          chunk=0):
    """Plain kNN + association (port of `models/lio.py::chunked_assoc`):
    (normal (Q, 3), a2d (Q,), closest (Q, 3), n_found (Q,) int32).

    With 0 < `chunk` < Q only the valid PREFIX of `world` is associated
    (keypoints are prefix-compacted, frame.voxel_subsample), in `chunk`-row
    slices; a ragged last slice starts early and recomputes a few rows
    with identical results, and rows beyond the processed prefix are zero
    (n_found 0 gates them downstream).  Otherwise every row is."""
    kw = dict(voxel_size=voxel_size, max_neighbors=max_neighbors,
              max_probe=max_probe, nb_voxels=nb_voxels)
    q = world.shape[0]
    if not chunk or chunk >= q:
        neighbors, n_found = _knn_found(vmap, world, threshold_capacity, **kw)
        return (*plane_assoc_plain(neighbors, n_found), n_found)
    n_valid = int(torch.sum(keypts_valid))
    f = dict(dtype=world.dtype, device=world.device)
    nrm = torch.zeros((q, 3), **f)
    a2 = torch.zeros((q,), **f)
    cl = torch.zeros((q, 3), **f)
    nf = torch.zeros((q,), dtype=torch.int32, device=world.device)
    for i in range((n_valid + chunk - 1) // chunk):
        off = min(i * chunk, q - chunk)
        s = slice(off, off + chunk)
        neighbors, nfc = _knn_found(vmap, world[s], threshold_capacity, **kw)
        nrm[s], a2[s], cl[s] = plane_assoc_plain(neighbors, nfc)
        nf[s] = nfc
    return nrm, a2, cl, nf


def knn_plane_rows_plain(vmap, world, location, r_world, last_trans,
                         keypts_valid, threshold_capacity, *, voxel_size,
                         max_neighbors, max_probe, nb_voxels, lam_w, lam_nb,
                         power_planarity, max_dist, min_neighbors):
    """Plain kNN + full plane row (the JAX package's
    `models/lio.py::build_residuals` before its residual cap): (h_x
    (Q, 6), h (Q,), good (Q,))."""
    neighbors, n_found = _knn_found(
        vmap, world, threshold_capacity, voxel_size=voxel_size,
        max_neighbors=max_neighbors, max_probe=max_probe,
        nb_voxels=nb_voxels)
    return plane_rows_plain(
        neighbors, n_found, world, location, r_world, last_trans,
        keypts_valid, lam_w=lam_w, lam_nb=lam_nb,
        power_planarity=power_planarity, max_dist=max_dist,
        min_neighbors=min_neighbors)


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
    # map (keys, sig, counts, points, capacity, K), search (world, valid,
    # threshold, Q, voxel_size, nb_voxels, max_probe, M)
    fused = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
             _P, _P, _P, ctypes.c_int, ctypes.c_float, ctypes.c_int,
             ctypes.c_int, ctypes.c_int]
    lib.knn_plane_assoc_launch.restype = ctypes.c_int
    lib.knn_plane_assoc_launch.argtypes = fused + [_P, _P, _P, _P, _P]
    lib.knn_plane_rows_launch.restype = ctypes.c_int
    lib.knn_plane_rows_launch.argtypes = fused + [
        _P, _P, _P, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, _P, _P, _P, _P]
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


def _check_search(vmap, world, keypts_valid, threshold_capacity,
                  max_neighbors, nb_voxels):
    """Checks of the fused entries' common inputs (the C entry points
    refuse a neighbourhood whose shared-memory slab does not fit); returns
    Q, the device and the map arguments of the C entry points."""
    dev = world.device
    if dev.type != "cuda":
        raise ValueError(f"world: on {dev}; the kernel takes CUDA tensors")
    if world.dim() != 2 or world.shape[1] != 3:
        raise ValueError(f"world: shape {tuple(world.shape)}, expected "
                         "(Q, 3)")
    q = world.shape[0]
    c = vmap.counts.shape[0]
    k = vmap.block_capacity
    _check("world", world, torch.float32, (q, 3), dev)
    _check("keypts_valid", keypts_valid, torch.bool, (q,), dev)
    _check("threshold_capacity", threshold_capacity, torch.int32, (), dev)
    _check("keys", vmap.keys, torch.int32, (c, 3), dev)
    _check("sig", vmap.sig, torch.int32, (c,), dev)
    _check("counts", vmap.counts, torch.int32, (c,), dev)
    _check("points", vmap.points, torch.float32, (c * k, 3), dev)
    if c & (c - 1):
        raise ValueError(f"map capacity {c} is not a power of two")
    if (k * 12) % 16 or vmap.points.data_ptr() % 16:
        raise ValueError("the kernel copies whole voxel blocks in 16-byte "
                         f"units: needs K * 12 % 16 == 0 (K = {k}) and a "
                         "16-byte aligned `points`")
    if not 1 <= max_neighbors <= 32:
        raise ValueError(f"max_neighbors {max_neighbors}: the kernel keeps "
                         "one neighbour per lane, 1..32")
    if nb_voxels < 0:
        raise ValueError(f"nb_voxels {nb_voxels} < 0")
    return q, dev, [vmap.keys.data_ptr(), vmap.sig.data_ptr(),
                    vmap.counts.data_ptr(), vmap.points.data_ptr(), c, k]


def _search_args(world, keypts_valid, threshold_capacity, q, voxel_size,
                 nb_voxels, max_probe, max_neighbors):
    return [world.data_ptr(), keypts_valid.data_ptr(),
            threshold_capacity.data_ptr(), q, float(voxel_size),
            int(nb_voxels), int(max_probe), int(max_neighbors)]


def knn_plane_assoc_cuda(vmap, world, keypts_valid, threshold_capacity, *,
                         voxel_size, max_neighbors, max_probe, nb_voxels,
                         chunk=0):
    """Fused kNN + association entry (CUDA tensors only), one launch over
    all rows; `chunk` is the plain version's and is not used.  Reads
    nothing back to the host."""
    del chunk
    q, dev, map_args = _check_search(vmap, world, keypts_valid,
                                     threshold_capacity, max_neighbors,
                                     nb_voxels)
    f = dict(dtype=torch.float32, device=dev)
    normal = torch.empty((q, 3), **f)
    a2d = torch.empty((q,), **f)
    closest = torch.empty((q, 3), **f)
    n_found = torch.empty((q,), dtype=torch.int32, device=dev)
    if q == 0:
        return normal, a2d, closest, n_found
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knn_plane_assoc_launch(
            *map_args, *_search_args(world, keypts_valid, threshold_capacity,
                                     q, voxel_size, nb_voxels, max_probe,
                                     max_neighbors),
            normal.data_ptr(), a2d.data_ptr(), closest.data_ptr(),
            n_found.data_ptr(), stream)
    _raise_on("knn_plane_assoc", err)
    launches["knn_plane_assoc"] += 1
    return normal, a2d, closest, n_found


def knn_plane_rows_cuda(vmap, world, location, r_world, last_trans,
                        keypts_valid, threshold_capacity, *, voxel_size,
                        max_neighbors, max_probe, nb_voxels, lam_w, lam_nb,
                        power_planarity, max_dist, min_neighbors):
    """Fused kNN + full-row entry (CUDA tensors only); invalid keypoints
    skip the search and come out as zero rows, not good."""
    q, dev, map_args = _check_search(vmap, world, keypts_valid,
                                     threshold_capacity, max_neighbors,
                                     nb_voxels)
    _check("location", location, torch.float32, (q, 3), dev)
    _check("r_world", r_world, torch.float32, (3, 3), dev)
    _check("last_trans", last_trans, torch.float32, (3,), dev)
    h_x = torch.empty((q, 6), dtype=torch.float32, device=dev)
    h = torch.empty((q,), dtype=torch.float32, device=dev)
    good = torch.empty((q,), dtype=torch.bool, device=dev)
    if q == 0:
        return h_x, h, good
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.knn_plane_rows_launch(
            *map_args, *_search_args(world, keypts_valid, threshold_capacity,
                                     q, voxel_size, nb_voxels, max_probe,
                                     max_neighbors),
            location.data_ptr(), r_world.data_ptr(), last_trans.data_ptr(),
            float(lam_w), float(lam_nb), float(power_planarity),
            float(max_dist), int(min_neighbors),
            float(max_dist * min_neighbors), h_x.data_ptr(), h.data_ptr(),
            good.data_ptr(), stream)
    _raise_on("knn_plane_rows", err)
    launches["knn_plane_rows"] += 1
    return h_x, h, good


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


def knn_plane_assoc(vmap, world, keypts_valid, threshold_capacity, **kw):
    """(normal, a2d, closest, n_found) of every keypoint; see
    `knn_plane_assoc_plain` for the keywords."""
    if world.device.type == "cpu":
        return knn_plane_assoc_plain(vmap, world, keypts_valid,
                                     threshold_capacity, **kw)
    if world.device.type == "cuda":
        return knn_plane_assoc_cuda(vmap, world, keypts_valid,
                                    threshold_capacity, **kw)
    raise ValueError(f"knn_plane_assoc: unsupported device {world.device}")


def knn_plane_rows(vmap, world, location, r_world, last_trans, keypts_valid,
                   threshold_capacity, **kw):
    """(h_x, h, good) of every keypoint; see `knn_plane_rows_plain` for
    the keywords."""
    if world.device.type == "cpu":
        return knn_plane_rows_plain(vmap, world, location, r_world,
                                    last_trans, keypts_valid,
                                    threshold_capacity, **kw)
    if world.device.type == "cuda":
        return knn_plane_rows_cuda(vmap, world, location, r_world,
                                   last_trans, keypts_valid,
                                   threshold_capacity, **kw)
    raise ValueError(f"knn_plane_rows: unsupported device {world.device}")
