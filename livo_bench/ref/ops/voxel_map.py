# Trimmed copy of sr_livo_tpu_torch/ops/voxel_map.py at commit f22c487785a4: part of the
# benchmark's plain reference (livo_bench/check.py).  Later changes
# to the port do not change it.
"""Device-resident voxel-hash map (port of `sr_livo_tpu/ops/voxel_map.py`).

A fixed-capacity open-addressing hash table laid out as flat tensors:

  * insertion  — a cheap per-row gate, budget compaction, claim rounds
    for new voxels (scatter-min arbitration emulating atomic CAS), a
    stable-argsort within-voxel rank and flat scatters, with the
    semantics of addPointToMap (lioOptimization.cpp:400-446);
  * lookup/kNN — (2nb+1)^3-voxel neighbourhood gather + top-k
    (searchNeighbors, optimize.cpp:365-426).

The port's eviction (`remove_far_voxels`, `compact_map` and their
programs) and its map programs are left out of this copy.

Voxel coordinates truncate toward zero like the reference's C++ cast.  The
3-prime spatial hash and the 31-bit slot signature are the JAX package's
int32 wraparound arithmetic, computed here in int64 and reduced to the
same 32-bit patterns, so `keys`, `sig`, `counts` and `point_ids` come out
bit-identical for the same insert sequence.

Unlike the JAX package (which returns new arrays and donates the old map),
`insert` UPDATES THE MAP IN PLACE and returns it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from livo_bench.ref.utils import graphs

# Sentinel marking an empty hash slot.
EMPTY = 0x7FFFFFFF
SIG_EMPTY = -1

_P1, _P2, _P3 = 73856093, 19349669, 83492791
# Signature primes 2654435761, 2246822519, 3266489917.
_S1, _S2, _S3 = 2654435761, 2246822519, 3266489917
_MASK32 = 0xFFFFFFFF


def _hash64(coords: torch.Tensor, p1: int, p2: int, p3: int) -> torch.Tensor:
    """c0*p1 + c1*p2 + c2*p3 in int64; its low 32 bits are the int32
    wraparound hash of the JAX package."""
    c = coords.to(torch.int64)
    return c[..., 0] * p1 + c[..., 1] * p2 + c[..., 2] * p3


def voxel_sig(coords: torch.Tensor) -> torch.Tensor:
    """31-bit non-negative voxel signature (never equals SIG_EMPTY)."""
    h = _hash64(coords, _S1, _S2, _S3) & _MASK32   # uint32 bit pattern
    h = h ^ (h >> 15)                              # logical shift
    return (h & 0x7FFFFFFF).to(torch.int32)


class VoxelMap(NamedTuple):
    """Open-addressing voxel hash table as flat tensors.

    capacity C must be a power of two; K = points per voxel block.  Block
    c occupies rows [c*K, (c+1)*K) of `points` / `point_ids`.
    """
    keys: torch.Tensor       # (C, 3) int32 voxel coords; EMPTY => free
    sig: torch.Tensor        # (C,) int32 signature; SIG_EMPTY (-1) => free
    points: torch.Tensor     # (C*K, 3) f32 positions
    counts: torch.Tensor     # (C,) int32 number of valid points per block
    point_ids: torch.Tensor  # (C*K,) int32 external payload id (-1 = none)

    @property
    def block_capacity(self) -> int:
        return self.points.shape[0] // self.counts.shape[0]


def gather_blocks(table: torch.Tensor, slots: torch.Tensor, K: int
                  ) -> torch.Tensor:
    """Gather whole K-row blocks from a flat table: (..., K[, d])."""
    C = table.shape[0] // K
    return table.view((C, K) + tuple(table.shape[1:]))[slots]


def make_map(capacity: int, voxel_points: int, dtype=torch.float32,
             device="cpu") -> VoxelMap:
    if capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    i32 = dict(dtype=torch.int32, device=device)
    return VoxelMap(
        keys=torch.full((capacity, 3), EMPTY, **i32),
        sig=torch.full((capacity,), SIG_EMPTY, **i32),
        points=torch.zeros((capacity * voxel_points, 3), dtype=dtype,
                           device=device),
        counts=torch.zeros((capacity,), **i32),
        point_ids=torch.full((capacity * voxel_points,), -1, **i32),
    )


def voxel_coords(pts: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """World points -> int32 voxel coords, truncation toward zero.

    The divisor is a 0-d tensor on the points' device: on CUDA, PyTorch
    divides by a Python scalar as a multiply by its reciprocal, which
    can move a point across a voxel face; tensor division rounds like
    the JAX package (and the CUDA kernel's `__fdiv_rn`)."""
    div = torch.full((), voxel_size, dtype=pts.dtype, device=pts.device)
    return torch.trunc(pts / div).to(torch.int32)


def voxel_hash(coords: torch.Tensor, capacity: int) -> torch.Tensor:
    """3-prime spatial hash (cloudMap.h:173-183) masked to the table size
    (int64 result; the low bits of the int32 wraparound hash)."""
    return _hash64(coords, _P1, _P2, _P3) & (capacity - 1)


def _probe_chain(sig_col: torch.Tensor, coords: torch.Tensor,
                 max_probe: int):
    """All probe positions at once over the signature column: returns
    (cand (..., P), match_idx, empty_idx) where *_idx are the first
    signature-match/empty position along the chain (== P when absent)."""
    capacity = sig_col.shape[0]
    base = voxel_hash(coords, capacity)
    offs = torch.arange(max_probe, dtype=torch.int64, device=coords.device)
    cand = (base[..., None] + offs) & (capacity - 1)       # (..., P)
    s = sig_col[cand]
    want = voxel_sig(coords)
    pos = offs.expand(cand.shape)
    absent = torch.full_like(pos, max_probe)
    match_idx = torch.where(s == want[..., None], pos, absent).amin(-1)
    empty_idx = torch.where(s == SIG_EMPTY, pos, absent).amin(-1)
    return cand, match_idx, empty_idx


def _resolve(vmap_keys, cand, match_idx, empty_idx, coords, max_probe):
    """Slot of the first signature match (before the first empty), exactly
    verified against the keys column; -1 when absent."""
    found = (match_idx < max_probe) & (match_idx < empty_idx)
    take = torch.clamp(match_idx, max=max_probe - 1)
    slot = torch.gather(cand, -1, take[..., None])[..., 0]
    verify = torch.all(vmap_keys[slot] == coords, dim=-1)
    return torch.where(found & verify, slot, torch.full_like(slot, -1))


def lookup(vmap: VoxelMap, coords: torch.Tensor, max_probe: int
           ) -> torch.Tensor:
    """Slot indices (int64) for voxel coords (..., 3); -1 where absent."""
    cand, match_idx, empty_idx = _probe_chain(vmap.sig, coords, max_probe)
    return _resolve(vmap.keys, cand, match_idx, empty_idx, coords, max_probe)


def _insert_gate_phase(vmap: VoxelMap, pts, valid, coords,
                       min_distance: float, max_probe: int):
    """Phases 1-2 of insert(): one batched probe + the per-row candidate
    gate.  Returns (cand_mask, slot (-1 = absent), blk_cnt)."""
    K = vmap.block_capacity
    n = pts.shape[0]
    cand, match_idx, empty_idx = _probe_chain(vmap.sig, coords, max_probe)
    slot = _resolve(vmap.keys, cand, match_idx, empty_idx, coords, max_probe)
    has_slot = slot >= 0
    safe_slot = torch.where(has_slot, slot, torch.zeros_like(slot))

    blk_cnt = torch.where(has_slot, vmap.counts[safe_slot],
                          torch.zeros((), dtype=torch.int32,
                                      device=pts.device))
    if min_distance > 0.0:
        blk_pts = gather_blocks(vmap.points, safe_slot, K)  # (n, K, 3)
        occ = (torch.arange(K, device=pts.device)[None, :]
               < blk_cnt[:, None])
        d2 = torch.sum((blk_pts - pts[:, None, :]) ** 2, dim=-1)
        min_d2 = torch.where(occ, d2, torch.full_like(d2, float("inf"))
                             ).amin(-1)
        far_enough = min_d2 > (min_distance * min_distance)
    else:
        far_enough = torch.ones((n,), dtype=torch.bool, device=pts.device)
    ok_existing = valid & has_slot & far_enough & (blk_cnt < K)
    needs_claim = valid & ~has_slot & (empty_idx < max_probe)
    return ok_existing | needs_claim, slot, blk_cnt


def _insert_gate_phase_chunked(vmap: VoxelMap, pts, valid, coords,
                               min_distance: float, max_probe: int,
                               chunk: int):
    """_insert_gate_phase over only the rows up to the last valid row, in
    `chunk`-row slices (a ragged last slice starts early and re-gates a
    few rows with identical results).  The gate is per-row against the
    pre-insert table, so this is exact for any validity pattern; the
    skipped tail gets (False, -1, 0).

    The JAX package's `fori_loop(0, n_chunks)` (sr_livo_tpu/ops/
    voxel_map.py:249) as masked rounds: slice i is gated on the device
    flag i * chunk < n_rows and written only where it holds; at most
    ceil(n / chunk) slices (`utils.graphs.go_on`)."""
    n = pts.shape[0]
    chunk = min(chunk, n)
    rows = torch.arange(n, device=pts.device) + 1
    n_rows = torch.max(torch.where(valid, rows, torch.zeros_like(rows)))
    cm = torch.zeros((n,), dtype=torch.bool, device=pts.device)
    sl = torch.full((n,), -1, dtype=torch.int64, device=pts.device)
    bc = torch.zeros((n,), dtype=torch.int32, device=pts.device)
    for i in range((n + chunk - 1) // chunk):
        live = n_rows > i * chunk
        if not graphs.go_on(live):
            break
        off = min(i * chunk, n - chunk)
        s = slice(off, off + chunk)
        for buf, new in zip((cm, sl, bc), _insert_gate_phase(
                vmap, pts[s], valid[s], coords[s], min_distance, max_probe)):
            buf[s] = torch.where(live, new, buf[s])
    return cm, sl, bc


def insert_gate(vmap: VoxelMap, pts: torch.Tensor, valid: torch.Tensor,
                voxel_size: float, min_distance: float, max_probe: int,
                gate_chunk: int = 0, with_aux: bool = False):
    """The candidate predicate of insert() alone (its phases 1-2): which
    points of the batch would be insertion candidates against the CURRENT
    table.  The sharded engine uses it to apply the single-chip `budget`
    prefix globally (parallel.sharded_lio).

    With `with_aux=True` it returns (gate, slot, blk_cnt), which insert()
    takes as `pre_gate` so that the probe and the block-distance gather
    (the dominant insert cost) run once."""
    coords = voxel_coords(pts, voxel_size)
    if gate_chunk and gate_chunk < pts.shape[0]:
        gate, slot, cnt = _insert_gate_phase_chunked(
            vmap, pts, valid, coords, min_distance, max_probe, gate_chunk)
    else:
        gate, slot, cnt = _insert_gate_phase(vmap, pts, valid, coords,
                                             min_distance, max_probe)
    return (gate, slot, cnt) if with_aux else gate


def insert(vmap: VoxelMap, pts: torch.Tensor, valid: torch.Tensor,
           voxel_size: float, min_distance: float, max_probe: int,
           point_ids: Optional[torch.Tensor] = None,
           budget: Optional[int] = None,
           gate_chunk: int = 0,
           pre_gate: Optional[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]] = None,
           ) -> Tuple[VoxelMap, torch.Tensor]:
    """Insert a batch of world points with addPointToMap semantics, IN
    PLACE: `vmap`'s tensors are updated and `vmap` is returned.

    Per point: locate (or create) the voxel block; append if the block is
    not full AND the point is farther than `min_distance` from every point
    already in it.  Points of one batch that land in the same voxel are
    not distance-checked against each other; within a voxel they append in
    ascending point index.  `budget` bounds how many gate-passing points go
    through the claim/rank/scatter phases (the rest are dropped for this
    call); `gate_chunk` > 0 gates in chunks up to the last valid row.
    `pre_gate` is insert_gate(..., with_aux=True) run on this table as it
    is now; `valid` may narrow its gate (the sharded engine's global
    insert-budget mask).

    Returns (vmap, accepted) where accepted marks the stored points.
    """
    capacity, K = vmap.counts.shape[0], vmap.block_capacity
    n = pts.shape[0]
    dev = pts.device
    b = n if budget is None else min(budget, n)
    coords = voxel_coords(pts, voxel_size)
    if point_ids is None:
        point_ids = torch.full((n,), -1, dtype=torch.int32, device=dev)

    if pre_gate is None:
        pre_gate = insert_gate(vmap, pts, valid, voxel_size, min_distance,
                               max_probe, gate_chunk, with_aux=True)
    gate, slot, blk_cnt = pre_gate
    cand_mask = gate & valid

    # Phase 3 — compact candidates to the budget, stable by index.
    idx_b = torch.arange(b, dtype=torch.int64, device=dev)
    if b < n:
        rank_n = torch.cumsum(cand_mask.to(torch.int64), 0) - 1
        dst = torch.where(cand_mask & (rank_n < b), rank_n, b)
        ar = torch.arange(n, dtype=torch.int64, device=dev)
        sel = torch.full((b + 1,), n - 1, dtype=torch.int64,
                         device=dev).scatter_(0, dst, ar)[:b]
        live = torch.zeros((b + 1,), dtype=torch.bool,
                           device=dev).scatter_(0, dst, True)[:b]
    else:
        sel = torch.arange(n, dtype=torch.int64, device=dev)
        live = cand_mask
    pts_c = pts[sel]
    coords_c = coords[sel]
    ids_c = point_ids[sel]
    slot_c = torch.where(live, slot[sel], torch.full_like(slot[sel], -1))
    cnt_c = blk_cnt[sel]
    want_c = voxel_sig(coords_c)

    # Phase 4 — claim rounds for new voxels: each pending point targets the
    # first empty slot of its probe chain; scatter-min elects one winner
    # per slot, the winner writes sig+keys, everyone else re-probes (same-
    # voxel losers then match the winner's signature and join its block).
    # At most max_probe + 1 rounds have a pending point: slots only ever
    # fill, so a point's first empty probe index never falls, and a point
    # that loses a round lost its target slot to that round's winner, so
    # its next first empty index is strictly larger.  After k lost rounds
    # it is at least k, so in round max_probe + 1 no empty slot is left
    # on its chain (index max_probe) and it drops out.  Masked rounds up
    # to that bound are the JAX `while_loop` (sr_livo_tpu/ops/
    # voxel_map.py:389): a round with nothing pending changes nothing.
    keys, sig_col = vmap.keys, vmap.sig
    pending = live & (slot_c < 0)
    for _ in range(max_probe + 1):
        if not graphs.go_on(pending.any()):
            break
        cand_c, mi_c, ei_c = _probe_chain(sig_col, coords_c, max_probe)
        resolved = _resolve(keys, cand_c, mi_c, ei_c, coords_c, max_probe)
        joined = pending & (resolved >= 0)
        slot_c = torch.where(joined, resolved, slot_c)
        cnt_c = torch.where(joined, torch.zeros_like(cnt_c), cnt_c)

        unresolved = pending & ~joined & (ei_c < max_probe)
        tgt = torch.gather(cand_c, -1, torch.clamp(
            ei_c, max=max_probe - 1)[..., None])[..., 0]
        claim = torch.full((capacity + 1,), b, dtype=torch.int64,
                           device=dev).scatter_reduce_(
            0, torch.where(unresolved, tgt, capacity), idx_b, "amin")
        winner = unresolved & (claim[tgt] == idx_b)
        # winners hold distinct slots
        masked_set(keys, tgt, coords_c, winner)
        masked_set(sig_col, tgt, want_c, winner)
        slot_c = torch.where(winner, tgt, slot_c)
        cnt_c = torch.where(winner, torch.zeros_like(cnt_c), cnt_c)
        pending = unresolved & ~winner

    ok_c = live & (slot_c >= 0)
    safe_c = torch.where(ok_c, slot_c, torch.zeros_like(slot_c))

    # Phase 5 — within-voxel rank by a stable sort of (slot, index).
    key_sort = torch.where(ok_c, slot_c, torch.full_like(slot_c, capacity))
    ro = torch.argsort(key_sort, stable=True)
    ss = key_sort[ro]
    seg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                     ss[1:] != ss[:-1]])
    start = torch.cummax(torch.where(seg, idx_b, torch.zeros_like(idx_b)),
                         0).values
    rank = torch.zeros(b, dtype=torch.int64, device=dev)
    rank[ro] = idx_b - start

    pos = cnt_c.to(torch.int64) + rank
    accept_c = ok_c & (pos < K)

    # Phase 6 — budget-sized scatters into the flat table (accepted rows
    # have distinct destinations).
    flat_idx = safe_c * K + pos
    masked_set(vmap.points, flat_idx, pts_c, accept_c)
    masked_set(vmap.point_ids, flat_idx, ids_c, accept_c)
    vmap.counts.scatter_add_(0, safe_c, accept_c.to(torch.int32))

    accepted = torch.zeros((n + 1,), dtype=torch.bool, device=dev).scatter_(
        0, torch.where(accept_c, sel, torch.full_like(sel, n)), True)[:n]
    return vmap, accepted


def masked_set(dst: torch.Tensor, idx: torch.Tensor, values: torch.Tensor,
               mask: torch.Tensor) -> None:
    """dst[idx[mask]] = values[mask], in place and with fixed shapes (the
    JAX package's `.at[].set(mode="drop")`; no `nonzero`, so nothing is
    read back to the host).  The targets of the masked rows must be
    distinct.  Every other row repeats the write of the first masked row
    (the same target, the same value), or, when no row is masked,
    rewrites dst[0] with its own value: duplicate targets then carry
    equal values, so the result does not depend on the write order."""
    first = torch.argmax(mask.to(torch.uint8), 0, keepdim=True)   # (1,)
    hit = mask[first]
    fb_idx = torch.where(hit, idx[first], torch.zeros_like(idx[first]))
    vshape = (-1,) + (1,) * (values.dim() - 1)
    fb_val = torch.where(hit.reshape(vshape), values[first], dst[:1])
    dst.index_put_((torch.where(mask, idx, fb_idx),),
                   torch.where(mask.reshape(vshape), values, fb_val))


def _offsets(nb: int, device) -> torch.Tensor:
    rng = torch.arange(-nb, nb + 1, dtype=torch.int32, device=device)
    ox, oy, oz = torch.meshgrid(rng, rng, rng, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)], -1)


def knn(vmap: VoxelMap, queries: torch.Tensor, *, voxel_size: float,
        max_neighbors: int, max_probe: int, nb_voxels: int = 1,
        threshold_capacity=1,
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k-nearest-neighbors over the (2*nb+1)^3 voxel neighbourhood
    (searchNeighbors, optimize.cpp:365-426): blocks with fewer than
    `threshold_capacity` points are skipped; the closest `max_neighbors`
    points are kept.

    Returns (neighbors (Q, M, 3), neighbor_valid (Q, M) bool, dists (Q, M))
    sorted ascending by (distance, flat candidate index v*K + j), the order
    of the JAX package's `lax.top_k`: ties go to the lower index, and rows
    with fewer than M candidates are padded with the lowest-index empty
    entries.  This is also the oracle of the fused kNN + plane kernel
    entries (ops/plane_fit.py), so d2 is summed as (dx*dx + dy*dy) + dz*dz,
    the kernel's order.
    """
    K = vmap.block_capacity
    q_coords = voxel_coords(queries, voxel_size)                  # (Q, 3)
    offs = _offsets(nb_voxels, queries.device)                     # (V, 3)
    coords27 = q_coords[:, None, :] + offs[None, :, :]             # (Q, V, 3)
    slots = lookup(vmap, coords27, max_probe)                      # (Q, V)
    found = slots >= 0
    safe = torch.where(found, slots, torch.zeros_like(slots))

    zero = torch.zeros((), dtype=torch.int32, device=queries.device)
    cnt = torch.where(found, vmap.counts[safe], zero)
    cnt = torch.where(cnt >= threshold_capacity, cnt, zero)
    cand = gather_blocks(vmap.points, safe, K)                     # (Q,V,K,3)
    cand_ok = (torch.arange(K, device=queries.device)[None, None, :]
               < cnt[:, :, None])

    Q, V = slots.shape
    cand = cand.reshape(Q, V * K, 3)
    cand_ok = cand_ok.reshape(Q, V * K)
    d = cand - queries[:, None, :]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    d2 = (dx * dx + dy * dy) + dz * dz
    d2 = torch.where(cand_ok, d2, torch.full_like(d2, float("inf")))

    # A stable sort keeps equal distances in index order (torch.topk
    # guarantees no order among ties).
    top_d2, idx = torch.sort(d2, dim=1, stable=True)
    top_d2, idx = top_d2[:, :max_neighbors], idx[:, :max_neighbors]
    nb_pts = torch.gather(cand, 1, idx[..., None].expand(Q, max_neighbors, 3))
    nb_ok = torch.gather(cand_ok, 1, idx)
    dists = torch.sqrt(torch.clamp(
        torch.where(nb_ok, top_d2, torch.zeros_like(top_d2)), min=0.0))
    return nb_pts, nb_ok, dists
