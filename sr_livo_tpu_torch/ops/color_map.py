"""Colored map: global RGB point registry + 0.1 m color voxel table (port of
`sr_livo_tpu/ops/color_map.py`).

The reference visual map (rgbPoint + color_voxel_map + Hash_map_3d dedup +
rgb_points_vec registry; cloudMap.h/cloudMap.cpp, addPointToColorMap
lioOptimization.cpp:448-518, the rgbMapTracker renderer) as tensors: the
registry is one packed (R, 16) float tensor addressed by integer ids,
voxel blocks store registry ids, and Bayesian color fusion
(cloudMap.cpp:59-100) is one masked row scatter.

A point is stored iff it claims a new dedup cell AND its block accepts
it, so every stored point is registered (the reference also appends
unregistered near-duplicates, which only cost render time).

Updates follow the JAX package's functional form: every scatter with
dropped rows writes into a copy with one spare sink row (index = size)
and returns the copy without it, so a tensor read before an update keeps
its old values.  The one exception is the voxel table `vox`, which
`voxel_map.insert` updates in place.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sr_livo_tpu_torch.ops import image_ops
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.utils import graphs, lie

# Render constants (rgbMapTracker.cpp:176-177 / cloudMap.cpp:56-57).
IMAGE_OBS_COV = 15.0
PROCESS_NOISE_SIGMA = 0.1

# Packed-registry column layout: every per-point field lives in one
# (R, 16) float row, so the render path does one row gather and one row
# scatter instead of one per field.
C_RGB = slice(0, 3)
C_COV = slice(3, 6)
C_POS = slice(6, 9)
C_NRGB = 9            # observation count (exact in f32 below 2^24)
C_DIST = 10
C_TIME = 11
C_VEL = slice(12, 14)
C_OUT = 14            # outlier count
C_VALID = 15          # 0.0 / 1.0
REG_WIDTH = 16


class ColorMap(NamedTuple):
    # packed registry, capacity R
    reg: torch.Tensor            # (R, 16) f32, columns per C_* above
    count: torch.Tensor          # () int32 allocated ids (including holes)
    # color voxel table (point_ids -> registry ids)
    vox: vm.VoxelMap
    vox_last_visit: torch.Tensor  # (C,) f32
    # dedup grid: signature-only open-addressing set at min_distance
    # resolution (a 2^-31 signature collision drops one point)
    dedup_sig: torch.Tensor       # (D,) int32; SIG_EMPTY (-1) = free
    # compacted list of voxel slots touched by the latest insert (-1 pad)
    recent_slots: torch.Tensor    # (V,) int32

    @property
    def pos(self):
        return self.reg[:, C_POS]

    @property
    def rgb(self):
        return self.reg[:, C_RGB]

    @property
    def cov_rgb(self):
        return self.reg[:, C_COV]

    @property
    def n_rgb(self):
        return self.reg[:, C_NRGB].to(torch.int32)

    @property
    def obs_dist(self):
        return self.reg[:, C_DIST]

    @property
    def last_obs_time(self):
        return self.reg[:, C_TIME]

    @property
    def img_vel(self):
        return self.reg[:, C_VEL]

    @property
    def outlier_count(self):
        return self.reg[:, C_OUT].to(torch.int32)

    @property
    def reg_valid(self):
        return self.reg[:, C_VALID] > 0.5


def make_color_map(registry: int, capacity: int, voxel_points: int,
                   recent: int = 2048, dtype=torch.float32,
                   device="cpu") -> ColorMap:
    i32 = dict(dtype=torch.int32, device=device)
    return ColorMap(
        reg=torch.zeros((registry, REG_WIDTH), dtype=dtype, device=device),
        count=torch.zeros((), **i32),
        vox=vm.make_map(capacity, voxel_points, dtype, device),
        vox_last_visit=torch.full((capacity,), -1.0, dtype=dtype,
                                  device=device),
        dedup_sig=torch.full((capacity * 2,), vm.SIG_EMPTY, **i32),
        recent_slots=torch.full((recent,), -1, **i32),
    )


def _set_drop(dst: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """dst.at[idx].set(values, mode="drop") for idx in [0, len(dst)]: a copy
    of dst with one spare sink row takes the writes, and is returned
    without it.  Rows aimed at the sink may collide; every other target
    must be written by one row or with equal values."""
    ext = torch.cat([dst, dst.new_zeros((1,) + dst.shape[1:])])
    ext[idx] = values
    return ext[:-1]


def _compact(mask: torch.Tensor, budget: int):
    """Stable compaction of the True rows of `mask` into `budget` slots:
    (sel (budget,) int64 source row per slot, 0 where empty; live)."""
    n = mask.shape[0]
    dev = mask.device
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    dst = torch.where(mask & (rank < budget), rank, budget)
    sel = torch.zeros((budget + 1,), dtype=torch.int64, device=dev).scatter_(
        0, dst, torch.arange(n, dtype=torch.int64, device=dev))[:budget]
    live = torch.zeros((budget + 1,), dtype=torch.bool,
                       device=dev).scatter_(0, dst, True)[:budget]
    return sel, live


def _claim_dedup(dedup_sig: torch.Tensor, coords: torch.Tensor,
                 valid: torch.Tensor, max_probe: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Claim cells in the signature-only dedup set.  Returns
    (new_sig, is_new): is_new[i] True iff point i claimed a previously
    absent cell (and is the batch winner for it).  Scatter-min arbitration
    elects one winner per cell; a same-cell loser matches the winner's
    signature on its next probe and resolves as a duplicate.  Claim rounds
    run to a fixpoint: a valid non-duplicate point is dropped only when
    its whole probe chain is full.  `dedup_sig` is not modified.

    The JAX `while_loop` (sr_livo_tpu/ops/color_map.py:160) as masked
    rounds, at most max_probe + 1 of them by voxel_map.insert's argument:
    cells only fill, and a point that loses a round lost its first empty
    cell to that round's winner, so its first empty probe index grows by
    at least one a round until none is left and it resolves as dropped
    (`utils.graphs.go_on`)."""
    cap = dedup_sig.shape[0]
    n = coords.shape[0]
    dev = coords.device
    base = vm.voxel_hash(coords, cap)
    want = vm.voxel_sig(coords)
    idx_n = torch.arange(n, dtype=torch.int64, device=dev)
    offs = torch.arange(max_probe, dtype=torch.int64, device=dev)
    cand = (base[:, None] + offs) & (cap - 1)               # (n, P)
    sig = torch.cat([dedup_sig, dedup_sig.new_full((1,), vm.SIG_EMPTY)])
    is_new = torch.zeros((n,), dtype=torch.bool, device=dev)
    resolved = ~valid
    for _ in range(max_probe + 1):
        if not graphs.go_on(~resolved.all()):
            break
        g = sig[cand]
        match = torch.any(g == want[:, None], dim=-1)
        empty = g == vm.SIG_EMPTY
        has_empty = torch.any(empty, dim=-1)
        ei = torch.where(empty, offs, max_probe).amin(-1)   # first empty
        resolved = resolved | match       # duplicate (pre-existing or
        unres = ~resolved & has_empty     # claimed by an earlier winner)
        tgt = torch.gather(cand, 1, torch.clamp(ei, max=max_probe - 1)[:, None]
                           )[:, 0]
        claim = torch.full((cap + 1,), n, dtype=torch.int64,
                           device=dev).scatter_reduce_(
            0, torch.where(unres, tgt, cap), idx_n, "amin")
        winner = unres & (claim[tgt] == idx_n)
        sig[torch.where(winner, tgt, cap)] = want
        is_new = is_new | winner
        # resolved: matched, won, or probe chain exhausted (dropped)
        resolved = resolved | winner | ~has_empty
    return sig[:cap], is_new


def color_insert(cmap: ColorMap, pts: torch.Tensor, valid: torch.Tensor,
                 obs_time: torch.Tensor, *, voxel_size: float,
                 min_distance: float, max_probe: int, budget=None
                 ) -> Tuple[ColorMap, torch.Tensor]:
    """Insert sweep points into the colored map (addPointToColorMap,
    lioOptimization.cpp:448-518) and update the recent-visited voxel
    stamps.  `obs_time` is a 0-d float tensor on the map's device.

    Returns (new_map, n_new_visited) where n_new_visited counts voxels whose
    visit stamp first became `obs_time` in this call
    (number_of_new_visited_voxel, lioOptimization.cpp:509-516).

    The voxel table `cmap.vox` is updated in place; callers rebind
    (`cmap, n = color_insert(cmap, ...)`) and do not reuse the old map.
    Dedup winners are compacted to `budget` before the voxel insert;
    over-budget winners are dropped for this call (their dedup cells stay
    claimed).
    """
    registry = cmap.reg.shape[0]
    n = pts.shape[0]
    dev = pts.device
    b = n if budget is None else min(budget, n)

    # ranges in a program captured with stage events: the dedup claim
    # rounds, then the registry and voxel-table writes
    graphs.mark("claim")
    dd_coords = vm.voxel_coords(pts, min_distance)
    dedup_sig, is_new = _claim_dedup(cmap.dedup_sig, dd_coords, valid,
                                     max_probe)
    graphs.mark("write")

    # Compact dedup winners to the budget (stable by index): registry ids
    # are consecutive in compacted order.
    sel, live = _compact(is_new, b)
    pts_c = pts[sel]
    ids_c = cmap.count + torch.arange(b, dtype=torch.int32, device=dev)
    cand_c = live & (ids_c < registry)

    vox_new, accepted_c = vm.insert(
        cmap.vox, pts_c, cand_c, voxel_size, 0.0, max_probe,
        point_ids=ids_c)

    safe_ids = torch.where(accepted_c, ids_c.to(torch.int64), registry)
    rows = torch.zeros((b, REG_WIDTH), dtype=cmap.reg.dtype, device=dev)
    rows[:, C_POS] = pts_c
    rows[:, C_VALID] = 1.0
    reg = _set_drop(cmap.reg, safe_ids, rows)
    count = cmap.count + torch.sum(cand_c).to(torch.int32)

    # recent-visited tracking: every valid point's voxel slot
    coords = vm.voxel_coords(pts, voxel_size)
    slots = vm.lookup(vox_new, coords, max_probe)
    ok = valid & (slots >= 0)
    cap_v = cmap.vox_last_visit.shape[0]
    now = obs_time.to(cmap.vox_last_visit.dtype)
    visit = _set_drop(cmap.vox_last_visit, torch.where(ok, slots, cap_v), now)
    n_new_visited = torch.sum(
        (visit == now) & (cmap.vox_last_visit != now)).to(torch.int32)

    # compacted unique touched-slot list for the render/select paths
    # (winner-per-slot arbitration by scatter-min, then stable compaction)
    idx_pts = torch.arange(n, dtype=torch.int64, device=dev)
    claim = torch.full((cap_v + 1,), n, dtype=torch.int64,
                       device=dev).scatter_reduce_(
        0, torch.where(ok, slots, cap_v), idx_pts, "amin")
    winner = ok & (claim[torch.clamp(slots, 0, cap_v - 1)] == idx_pts)
    n_recent = cmap.recent_slots.shape[0]
    vsel, vlive = _compact(winner, n_recent)
    recent_slots = torch.where(vlive, slots[vsel].to(torch.int32),
                               torch.full_like(cmap.recent_slots, -1))

    new_map = cmap._replace(reg=reg, count=count, vox=vox_new,
                            vox_last_visit=visit, dedup_sig=dedup_sig,
                            recent_slots=recent_slots)
    return new_map, n_new_visited


def project_points(pts: torch.Tensor, q_cw: torch.Tensor, t_cw: torch.Tensor,
                   intr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """World -> pixel projection (project3dTo2d, lioOptimization.cpp:142).

    intr = [fx, fy, cx, cy].  Returns (uv (N, 2), z_ok (N,), pc (N, 3))."""
    pc = lie.quat_rotate(q_cw, pts) + t_cw
    z = pc[..., 2]
    z_ok = z > 0.001
    z_safe = torch.where(z_ok, z, torch.ones_like(z))
    u = pc[..., 0] * intr[0] / z_safe + intr[2]
    v = pc[..., 1] * intr[1] / z_safe + intr[3]
    return torch.stack([u, v], dim=-1), z_ok, pc


def in_fov(uv: torch.Tensor, cols: int, rows: int,
           margin: float) -> torch.Tensor:
    """if2dPointsAvailable (lioOptimization.cpp:48-60)."""
    u, v = uv[..., 0], uv[..., 1]
    return ((u >= margin * cols + 1) & (u < (1 - margin) * cols - 1)
            & (v >= margin * rows + 1) & (v < (1 - margin) * rows - 1))


def update_rgb(cmap: ColorMap, ids: torch.Tensor, obs_rgb: torch.Tensor,
               obs_dist: torch.Tensor, obs_time, upd_mask: torch.Tensor,
               obs_sigma: float = IMAGE_OBS_COV,
               rows: torch.Tensor = None) -> ColorMap:
    """Vectorized rgbPoint::updateRgb (cloudMap.cpp:59-100) over unique ids.

    One packed row gather + one packed row scatter; `rows` optionally
    passes pre-gathered registry rows (reg[clip(ids)]) from the caller."""
    registry = cmap.reg.shape[0]
    ids = ids.to(torch.int64)
    if rows is None:
        rows = cmap.reg[torch.clamp(ids, 0, registry - 1)]

    cur_rgb = rows[:, C_RGB]
    cur_cov = rows[:, C_COV]
    cur_n = rows[:, C_NRGB]
    cur_dist = rows[:, C_DIST]
    cur_time = rows[:, C_TIME]

    obs_time = torch.as_tensor(obs_time, dtype=cmap.reg.dtype,
                               device=cmap.reg.device)
    # occlusion gate (cloudMap.cpp:61-64)
    gate = (cur_dist == 0) | (obs_dist <= cur_dist * 1.2)
    mask = upd_mask & gate
    first = cur_n == 0

    # first observation
    rgb_first = torch.round(obs_rgb)
    cov_first = torch.full_like(cur_cov, obs_sigma)

    # Bayesian fusion
    cov_pn = cur_cov + PROCESS_NOISE_SIGMA * torch.clamp(
        obs_time - cur_time, min=0.0)[..., None]
    cov_pn = torch.clamp(cov_pn, min=1e-3)
    new_cov = torch.sqrt(1.0 / (1.0 / (cov_pn * cov_pn)
                                + 1.0 / (obs_sigma ** 2)))
    rgb_fused = (new_cov * new_cov
                 * (cur_rgb / (cov_pn * cov_pn) + obs_rgb / (obs_sigma ** 2)))

    rows_new = rows.clone()
    rows_new[:, C_RGB] = torch.where(first[..., None], rgb_first, rgb_fused)
    rows_new[:, C_COV] = torch.where(first[..., None], cov_first, new_cov)
    rows_new[:, C_NRGB] = cur_n + 1
    rows_new[:, C_DIST] = torch.where(first, obs_dist,
                                      torch.minimum(cur_dist, obs_dist))
    rows_new[:, C_TIME] = obs_time

    # valid ids are unique (each registry id lives in one voxel slot)
    reg = _set_drop(cmap.reg, torch.where(mask, ids, registry), rows_new)
    return cmap._replace(reg=reg)


def render_recent(cmap: ColorMap, image: torch.Tensor, q_cw: torch.Tensor,
                  t_cw: torch.Tensor, t_wc_world: torch.Tensor,
                  intr: torch.Tensor, obs_time, *,
                  cols: int, rows: int,
                  max_render_points: int = 8192,
                  fov_margin: float = 0.005) -> ColorMap:
    """Color registry points in recently visited voxels from `image`
    (renderPointsInRecentVoxel, rgbMapTracker.cpp:181-237).

    The recent-voxel set is the compacted `recent_slots` list recorded by
    the latest `color_insert`.  Visibility (projection + FoV) is evaluated
    on the voxel table's own position blocks; only the up to
    `max_render_points` visible winners pay the registry row gather, the
    image sampling and the Bayesian-fusion scatter.  Overflowing points
    are re-rendered on a later visit of their voxel."""
    K = cmap.vox.block_capacity
    slot_ok = cmap.recent_slots >= 0
    slot_idx = torch.clamp(cmap.recent_slots.to(torch.int64), 0,
                           cmap.vox_last_visit.shape[0] - 1)

    ids = vm.gather_blocks(cmap.vox.point_ids, slot_idx, K)  # (V, K)
    pts_blk = vm.gather_blocks(cmap.vox.points, slot_idx, K)  # (V, K, 3)
    cnt = torch.where(slot_ok, cmap.vox.counts[slot_idx],
                      torch.zeros_like(cmap.vox.counts[slot_idx]))
    id_ok = ((torch.arange(K, device=ids.device)[None, :] < cnt[:, None])
             & (ids >= 0))
    ids = ids.reshape(-1)
    id_ok = id_ok.reshape(-1)
    pts_all = pts_blk.reshape(-1, 3)

    uv_all, z_ok, _pc = project_points(pts_all, q_cw, t_cw, intr)
    vis = id_ok & z_ok & in_fov(uv_all, cols, rows, fov_margin)

    # Compact visible winners to the render budget.
    sel, live = _compact(vis, max_render_points)
    registry = cmap.reg.shape[0]
    ids_c = torch.clamp(ids[sel].to(torch.int64), 0, registry - 1)
    reg_rows = cmap.reg[ids_c]                              # (R, 16) gather
    live = live & (reg_rows[:, C_VALID] > 0.5)

    pts = pts_all[sel]
    uv = uv_all[sel]
    color = image_ops.bilinear_sample(image, uv)
    depth = torch.linalg.norm(pts - t_wc_world[None, :], dim=-1)
    return update_rgb(cmap, ids_c, color, depth, obs_time, live,
                      rows=reg_rows)


def select_points_for_projection(cmap: ColorMap, q_cw: torch.Tensor,
                                 t_cw: torch.Tensor, t_wc_world: torch.Tensor,
                                 intr: torch.Tensor, *, max_out: int,
                                 cols: int, rows: int, grid_px: int = 10,
                                 fov_margin: float = 0.005,
                                 min_depth: float = 0.1,
                                 max_depth: float = 200.0,
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Candidate map points for track replenishment
    (selectPointsForProjection, rgbMapTracker.cpp:45-152): one
    representative (the newest) point per recent voxel, deduplicated on a
    `grid_px` image grid keeping the closest-depth point per cell.

    Returns (ids (max_out,) int32, uv (max_out, 2), valid (max_out,))."""
    slot_idx = torch.clamp(cmap.recent_slots.to(torch.int64), 0,
                           cmap.vox_last_visit.shape[0] - 1)
    cnt = cmap.vox.counts[slot_idx]
    slot_ok = (cmap.recent_slots >= 0) & (cnt > 0)
    last = torch.clamp(cnt - 1, min=0)
    ids = cmap.vox.point_ids[slot_idx * cmap.vox.block_capacity + last]
    registry = cmap.reg.shape[0]
    ids_c = torch.clamp(ids, 0, registry - 1)
    reg_rows = cmap.reg[ids_c.to(torch.int64)]
    ok = slot_ok & (ids >= 0) & (reg_rows[:, C_VALID] > 0.5)

    pts = reg_rows[:, C_POS]
    depth = torch.linalg.norm(pts - t_wc_world[None, :], dim=-1)
    uv, z_ok, _ = project_points(pts, q_cw, t_cw, intr)
    ok = (ok & z_ok & in_fov(uv, cols, rows, fov_margin)
          & (depth > min_depth) & (depth < max_depth))

    # occupancy grid: keep closest depth per cell via scatter-min
    gx = torch.round(uv[:, 0] / grid_px)
    gy = torch.round(uv[:, 1] / grid_px)
    ncx = cols // grid_px + 2
    ncy = rows // grid_px + 2
    cell = (torch.clamp(gy, 0, ncy - 1).to(torch.int64) * ncx
            + torch.clamp(gx, 0, ncx - 1).to(torch.int64))
    grid = torch.full((ncx * ncy + 1,), float("inf"), dtype=depth.dtype,
                      device=depth.device).scatter_reduce_(
        0, torch.where(ok, cell, ncx * ncy), depth, "amin")
    winner = ok & (grid[cell] == depth)

    # compact to max_out
    order = torch.argsort((~winner).to(torch.uint8), stable=True)[:max_out]
    return ids_c[order], uv[order], winner[order]
