# Trimmed copy of sr_livo_tpu_torch/ops/plane_fit.py at commit f22c487785a4: part of the
# benchmark's plain reference (livo_bench/check.py).  Later changes
# to the port do not change it.
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

The copy keeps the plain PyTorch versions of the two fused entries, and
its dispatchers call them on every device: the reference launches no
kernel.  The port's two earlier entries (`plane_rows`, `plane_assoc`),
off its main path, are left out.
"""

from __future__ import annotations

from typing import Tuple

import torch

from livo_bench.ref.ops import neighborhood as nb_ops
from livo_bench.ref.ops import voxel_map as vm


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


def knn_plane_rows_plain(vmap, world, location, r_world, last_trans,
                         keypts_valid, threshold_capacity, *, voxel_size,
                         max_neighbors, max_probe, nb_voxels, lam_w, lam_nb,
                         power_planarity, max_dist, min_neighbors):
    """Plain kNN + full plane row (the JAX package's
    `models/lio.py::build_residuals` before its residual cap): (h_x
    (Q, 6), h (Q,), good (Q,)).  With no valid keypoint (a masked IEKF
    round) every row is zero, as the kernel gives it, and no search
    runs."""
    if not bool(keypts_valid.any()):
        return (world.new_zeros((world.shape[0], 6)),
                world.new_zeros((world.shape[0],)),
                torch.zeros_like(keypts_valid))
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
# Dispatchers: the plain versions on every device
# ---------------------------------------------------------------------------

def knn_plane_assoc(vmap, world, keypts_valid, threshold_capacity, **kw):
    """(normal, a2d, closest, n_found) of every keypoint; see
    `knn_plane_assoc_plain` for the keywords."""
    return knn_plane_assoc_plain(vmap, world, keypts_valid,
                                 threshold_capacity, **kw)


def knn_plane_rows(vmap, world, location, r_world, last_trans, keypts_valid,
                   threshold_capacity, **kw):
    """(h_x, h, good) of every keypoint; see `knn_plane_rows_plain` for
    the keywords."""
    return knn_plane_rows_plain(vmap, world, location, r_world,
                                last_trans, keypts_valid,
                                threshold_capacity, **kw)
