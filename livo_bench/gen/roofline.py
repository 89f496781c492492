"""The least time the plane kernel's fused entries could take on their
inputs: the table of peaks and the count of bytes and operations.

Frozen from `chip_smoke.py::fused_bound_ms` and its peaks at commit
f22c487785a4; later changes to the port do not change them.  The voxel
hash arithmetic it needs (`voxel_coords`, the neighbour offsets, the
probe chain and its resolution) is the plain reference's frozen copy of
`ops/voxel_map.py`, so the count follows these inputs, not what a later
kernel does with them.
"""

from __future__ import annotations

import math

import torch

from livo_bench.ref.ops import voxel_map as vm

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s
# and float32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def fused_bound_ms(vmap, world, rows, thr, kw, entry: str):
    """Least time for a fused entry's work on these inputs.  Bytes: each
    distinct 32-byte sector of the signature column that a probe chain
    reads, each distinct found voxel's key row, count and occupied points
    (after the count threshold), once, plus the inputs and outputs; over
    HBM bandwidth.  Operations: about 8 per ranked candidate for its
    distance plus log2(M) for the selection, and a tail of 150
    (association) or 230 (full row) per keypoint searched; over the f32
    peak.  `rows` marks the keypoints the entry searches.  Returns (ms,
    "bytes" or "operations")."""
    k, p, m = vmap.block_capacity, kw["max_probe"], kw["max_neighbors"]
    w = world[rows]
    coords = (vm.voxel_coords(w, kw["voxel_size"])[:, None, :]
              + vm._offsets(kw["nb_voxels"], w.device)[None])
    cand, match_idx, empty_idx = vm._probe_chain(vmap.sig, coords, p)
    slots = vm._resolve(vmap.keys, cand, match_idx, empty_idx, coords, p)
    n_read = torch.clamp(torch.minimum(match_idx, empty_idx), max=p - 1) + 1
    read = torch.arange(p, device=w.device) < n_read[..., None]
    sectors = torch.unique(cand[read] // 8).numel()
    cnt = torch.where(slots >= 0, vmap.counts[slots.clamp(min=0)], 0)
    cnt = torch.where(cnt >= thr, cnt.clamp(max=k), 0)
    found = torch.unique(slots[slots >= 0])
    blk = vmap.counts[found]
    blk = torch.where(blk >= thr, blk.clamp(max=k), 0)
    n_cand = int(cnt.sum())
    q = world.shape[0]
    if entry == "knn_plane_rows":
        io = q * (12 + 12 + 1) + 36 + 12 + 4 + q * (24 + 4 + 1)
        tail = 230
    else:
        io = q * (12 + 1) + 4 + q * (12 + 4 + 12 + 4)
        tail = 150
    nbytes = 32 * sectors + found.numel() * (12 + 4) + 12 * int(blk.sum()) + io
    ops = n_cand * (8 + math.log2(m)) + tail * int(rows.sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")
