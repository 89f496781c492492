"""Static-shape routing primitives of the multi-device engine (port of
`sr_livo_tpu/parallel/routing.py`).

The owner-routed sharded LIO engine (parallel.sharded_lio) packs rows
into fixed per-destination buffers, exchanges them with one all-to-all
and compacts the received rows.  Every shape is static; rows beyond a
buffer's budget are dropped deterministically and counted (callers psum
the count and report it, never silently).

int32 key columns travel through float32 row matrices by bit
reinterpretation (`Tensor.view`), which is lossless; a reinterpreted
column never goes through arithmetic.  The hash mixes are the JAX
package's int32 wraparound arithmetic with logical right shifts,
computed here in int64 on the 32-bit patterns, so owners come out bit
for bit the same.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sr_livo_tpu_torch.parallel.mesh import Mesh

I32_MAX = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF
_MIX = 0x45D9F3B
# Block hash primes of shard_of (independent of the in-table slot hash,
# so block ownership is uncorrelated with slot indices).
_B1, _B2, _B3 = 73856093, 19349669, 83492791


def rup(x: float, m: int = 8) -> int:
    """Round up to a multiple of m (static buffer sizes)."""
    return max(m, int((int(np.ceil(x)) + m - 1) // m * m))


def headroom(mean: float, sigmas: float = 8.0, const: int = 32) -> int:
    """Static budget for a load that is Binomial around `mean` per
    destination (uniform hash routing): mean + `sigmas` standard
    deviations + a constant floor.  The headroom is additive, so its
    overhead fraction shrinks as the load grows."""
    return rup(mean + sigmas * np.sqrt(max(mean, 1.0)) + const)


def pack_cols(*cols: torch.Tensor) -> torch.Tensor:
    """Pack float32/int32 1-D/2-D columns into one (m, d) float32 row
    matrix; int32 columns are reinterpreted bit for bit."""
    out = []
    for c in cols:
        if c.dim() == 1:
            c = c[:, None]
        if c.dtype == torch.int32:
            c = c.contiguous().view(torch.float32)
        out.append(c.to(torch.float32))
    return torch.cat(out, dim=1)


def unpack_col_i32(rows: torch.Tensor, j: int) -> torch.Tensor:
    return rows[:, j].contiguous().view(torch.int32)


def mix_owner(h: torch.Tensor, n: int) -> torch.Tensor:
    """((h ^ (h >>> 16)) * 0x45D9F3B) >>> 8, mod n, on the 32-bit
    pattern of int64 `h` (>>> is the logical shift)."""
    h = h & _MASK32
    m = ((h ^ (h >> 16)) * _MIX) & _MASK32
    return ((m >> 8) % n).to(torch.int32)


def hash_range_owner(h: torch.Tensor, n: int) -> torch.Tensor:
    """Owner rank of a 31-bit non-negative hash.  The voxel key is a
    linear combination of grid coordinates, so a finalizer mix
    decorrelates the owner from the lattice first (raw range/mod
    partitioning is measurably imbalanced); equal keys get equal owners,
    which is all the exact dedups need."""
    if n == 1:
        return torch.zeros_like(h)
    return mix_owner(h.to(torch.int64), n)


def shard_of(coords: torch.Tensor, n_shards: int,
             block_bits: int = 4) -> torch.Tensor:
    """Owning rank of a voxel: a hash of its spatial BLOCK coordinate
    (voxel >> block_bits, an arithmetic shift, i.e. floor division).  All
    voxels of a block share an owner, so a bounded voxel neighbourhood
    touches few owners.  int32 wraparound arithmetic of the JAX package,
    bit for bit."""
    b = (coords >> block_bits).to(torch.int64)
    h = b[..., 0] * _B1 + b[..., 1] * _B2 + b[..., 2] * _B3
    return mix_owner(h, n_shards)


def pack_for_exchange(dest: torch.Tensor, valid: torch.Tensor,
                      rows: torch.Tensor, n: int, budget: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter rows into an (n, budget, d) per-destination send buffer.

    Row order within a destination is the input order (rank = running
    count of earlier rows with the same destination).  Returns (buffer,
    buffer_valid, n_dropped): rows beyond `budget` for their destination
    are dropped and counted (0-d int32)."""
    d = rows.shape[1]
    dev = rows.device
    dest_c = torch.clamp(dest, 0, n - 1).to(torch.int64)
    onehot = ((dest_c[:, None] == torch.arange(n, device=dev)[None, :])
              & valid[:, None])
    cum = torch.cumsum(onehot.to(torch.int32), dim=0)          # inclusive
    rank = torch.gather(cum, 1, dest_c[:, None])[:, 0] - 1
    ok = valid & (rank < budget)
    pos = torch.where(ok, dest_c * budget + rank, n * budget)   # spare row
    buf = torch.zeros((n * budget + 1, d), dtype=rows.dtype, device=dev)
    buf[pos] = rows
    bval = torch.zeros((n * budget + 1,), dtype=torch.bool, device=dev)
    bval.index_fill_(0, pos, True)
    dropped = torch.sum(valid & ~ok, dtype=torch.int32)
    return (buf[:-1].reshape(n, budget, d), bval[:-1].reshape(n, budget),
            dropped)


def exchange(buf: torch.Tensor, bval: torch.Tensor, mesh: Mesh
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE all-to-all: chunk j of my buffer goes to rank j; the received
    chunks concatenate in source-rank order.  The validity mask rides as
    an extra column (launch latency, not bytes, dominates small
    exchanges).  Returns the flat received ((n*budget, d), (n*budget,))
    rows and validity."""
    packed = torch.cat([buf, bval[..., None].to(buf.dtype)], dim=-1)
    rp = mesh.all_to_all(packed).reshape(-1, packed.shape[-1])
    return rp[:, :-1], rp[:, -1] > 0.5


def compact(rows: torch.Tensor, valid: torch.Tensor, out_size: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable compaction of the valid rows to `out_size` slots.
    Returns (rows, valid, n_dropped)."""
    dev = rows.device
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    ok = valid & (rank < out_size)
    dst = torch.where(ok, rank, out_size)                       # spare slot
    out = torch.zeros((out_size + 1,) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=dev)
    out[dst] = rows
    oval = torch.zeros((out_size + 1,), dtype=torch.bool, device=dev)
    oval.index_fill_(0, dst, True)
    dropped = (torch.sum(valid, dtype=torch.int32)
               - torch.sum(ok, dtype=torch.int32))
    return out[:-1], oval[:-1], dropped
