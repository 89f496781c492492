"""Multi-device LIO: the sweep and spatial map blocks sharded over the
map mesh (port of `sr_livo_tpu/parallel/sharded_lio.py`).

The JAX package runs this step as one `shard_map` program per device;
the port runs it once per rank, one process each, with the collectives of
`parallel.mesh.Mesh` over `torch.distributed`.  The body is the JAX
package's, stage for stage:

  * **Front half sharded, sort-free.**  Each rank de-skews an N/n index
    slice of the raw sweep (per point, no communication).  The voxel-grid
    subsamples (buildFrame:843-848, optimize.cpp:428-431) run as EXACT
    distributed dedups: local winners (bucket_dedup_min claim rounds) go
    to hash-range owners (one all-to-all), each owner re-elects winners
    the same way, and one winner-histogram psum plus an exclusive cumsum
    reproduces the single-device stream-order row ranks bit for bit,
    the max_out truncation and the residual cap's keypoint order
    (optimize.cpp:107) included.
  * **Block-owner map with voxel halos.**  Voxels are grouped into
    (2^map_block_bits)^3 spatial blocks; a block's owner stores it plus
    every voxel within `map_halo_voxels` of its blocks, so a keypoint
    routed to its centre-block owner finds its whole kNN neighbourhood
    (searchNeighbors, optimize.cpp:365-426) in that rank's LOCAL table.
    The association is the plane kernel's `knn_plane_assoc` (or
    `knn_plane_rows` with `cache_association=False`) on the local table.
  * **Owner-insert + accepted-replay.**  Each frame row goes once to its
    primary owner, which runs the gate, the global insert-budget prefix
    and the insert; only the accepted rows are replayed to the other
    corner-block owners, which apply them in frame-rank order and so
    reproduce the owner's per-voxel outcome bit for bit.
  * **One packed psum per IEKF iteration**: [H^T H | H^T h | num] as 43
    float64 partial sums (lio.normal_sums; the JAX package psums float32
    ones).  Rounded once to float32 after the psum, the system is very
    likely, though not certain, to have the single-device bits however
    the rows are split over the ranks; the psum'd bits are the same on
    every rank, and so is the 17x17 solve.

Routing buffers have static shapes with `shard_route_slack` headroom;
overflow is dropped deterministically and counted
(SweepOutput.route_overflow).  Halo copies roughly double map storage;
`map_size()` counts owned voxels only and matches the single-device map.

Every rank calls the same collectives in the same order: the host reads
only replicated values (IEKF convergence, the weak-solve retry) to decide
anything that leads to a collective.  The local map is updated in place,
like the single-device engine's.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from sr_livo_tpu_torch.config import (MOTION_COMP_CONSTANT_VELOCITY,
                                      MOTION_COMP_IMU, LivoConfig)
from sr_livo_tpu_torch.models import eskf as eskf_mod
from sr_livo_tpu_torch.models import lio
from sr_livo_tpu_torch.models.eskf import EskfState, ImuStates
from sr_livo_tpu_torch.models.odometry import (SweepOutput, WireSweep,
                                               pack_record, unpack_wire)
from sr_livo_tpu_torch.ops import frame as frame_ops
from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.parallel import routing
from sr_livo_tpu_torch.parallel.mesh import Mesh
from sr_livo_tpu_torch.parallel.routing import shard_of
from sr_livo_tpu_torch.utils import lie

# The stages `make_profile_step` can stop after, in step order.
PROFILE_STAGES = ("deskew", "frame_sub", "kp_sub", "route_q", "iekf",
                  "ins_route", "ins_gate", "insert", "rep_pack", "rep_sort",
                  "replay", "out")
_AFTER_INSERT = PROFILE_STAGES[PROFILE_STAGES.index("insert"):]
I32_MAX = routing.I32_MAX


def compute_budgets(cfg: LivoConfig, n: int) -> dict:
    """Static routing budgets of an n-rank engine.

    Hash-range stages are Binomially concentrated (uniform 31-bit hash)
    and get additive statistical headroom (routing.headroom).  Block
    stages (query/insert routing) follow spatial density and get the
    multiplicative `shard_route_slack` instead.  Overflow beyond any
    budget is dropped deterministically and counted."""
    head, rup = routing.headroom, routing.rup
    sh = cfg.shapes
    slack = float(sh.shard_route_slack)
    N, F, Q = sh.max_sweep_points, sh.max_frame_points, sh.max_keypoints
    Ns = N // n
    dup = 2.5   # halo-corner duplication bound (distinct corner owners
    #             average ~2.2 at block_bits=4, halo=2)
    # per-rank insert work honours the single-device insert budget
    I = min(F, sh.max_insert_points) if sh.max_insert_points else F
    return dict(
        Ns=Ns,
        B2=min(Ns, head(Ns / n)),                    # frame route / dest
        # segments hold only post-cap survivors (ranks are computed
        # before compaction), Binomial(F, 1/n) per hash-range owner
        F_seg=min(F, head(F / n)),                   # frame segment
        B3=min(F, head(F / n / n)),                  # keypoint route / dest
        K_seg=min(Q, head(Q / n)),                   # keypoint segment
        B4=min(Q, rup(Q / n / n * slack + 32)),      # query route / dest
        # K4 sizes the IEKF's per-rank query batch; the association
        # computes only its valid prefix, so the slack costs memory
        K4=min(Q, rup(Q / n * max(float(sh.shard_query_slack), 1.0) + 32)),
        # owner-insert: each frame row goes once to its primary owner
        B5=min(F, rup(F / n / n * slack + 32)),      # insert route / dest
        W_ins=min(F, rup(F / n * max(slack / 2.7, 1.0) + 64)),
        # replay leg: extra copies of accepted rows (<= insert budget I)
        # beyond the primary owner
        C_rep=min(8 * I, rup((dup - 1.0) * I / n
                             * max(slack / 2.7, 1.0) + 64)),
        B6=min(F, rup((dup - 1.0) * I / n / n * slack + 32)),
        local_capacity=max(2 * sh.map_capacity // n, 1 << 10),
    )


def _scatter_rows(rows: torch.Tensor, valid: torch.Tensor,
                  index: torch.Tensor, size: int):
    """(size, d) table with row `index[i]` = rows[i] where valid (the
    indices of valid rows are distinct), and its (size,) validity."""
    tgt = torch.where(valid, index.to(torch.int64), size)
    tbl = torch.zeros((size + 1, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    tbl[tgt] = rows
    tvl = torch.zeros((size + 1,), dtype=torch.bool, device=rows.device)
    tvl[tgt] = True
    return tbl[:size], tvl[:size]


def _histogram(index: torch.Tensor, on: torch.Tensor, size: int
               ) -> torch.Tensor:
    """(size,) int32 with 1 at index[i] where `on` (distinct indices)."""
    flags = torch.zeros((size + 1,), dtype=torch.int32, device=index.device)
    flags[torch.where(on, index.to(torch.int64), size)] = 1
    return flags[:size]


def _exclusive_prefix(flags: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(flags, 0) - flags


class ShardedLioEngine:
    """Per-sweep LIO step with the sweep and the map sharded over `mesh`
    (one rank's part; every rank of the mesh calls `step` on the same
    replicated state and sweep and on its own local map)."""

    def __init__(self, cfg: LivoConfig, mesh: Mesh, dtype=torch.float32,
                 budget_override: Optional[dict] = None):
        """`budget_override` force-sets any of the static routing budgets
        (Ns, B2, F_seg, B3, K_seg, B4, K4, B5, W_ins, C_rep, B6,
        local_capacity): starved budgets test the overflow accounting,
        and the n-rank budgets on a world of one give the per-rank
        program shapes of an n-rank run."""
        self.cfg = cfg
        self.mesh = mesh
        self.n_shards = n = mesh.size
        self.device = mesh.device
        self.dtype = dtype
        sh = cfg.shapes
        if sh.map_capacity % n or sh.max_sweep_points % n:
            raise ValueError(f"{n} ranks must divide map_capacity "
                             f"{sh.map_capacity} and max_sweep_points "
                             f"{sh.max_sweep_points}")
        self.block_bits = sh.map_block_bits
        self.halo = sh.map_halo_voxels
        if (1 << self.block_bits) < 2 * self.halo + 1:
            raise ValueError("the block side must cover the halo corner "
                             "rule: 2^map_block_bits >= 2*halo + 1")
        if cfg.retry_wider_neighborhood:
            skipped = [ph for ph, nb in
                       (("init", 2), ("steady", cfg.icp.voxel_neighborhood))
                       if nb + 1 > self.halo]
            if skipped:
                warnings.warn(
                    "ShardedLioEngine: retry_wider_neighborhood needs "
                    f"map_halo_voxels >= nb+1; phases {skipped} exceed "
                    f"halo={self.halo} and run WITHOUT the retry "
                    "(raise cfg.shapes.map_halo_voxels to enable)")
        budgets = compute_budgets(cfg, n)
        budgets.update(budget_override or {})
        for k, v in budgets.items():
            setattr(self, k, int(v))
        c = self.local_capacity
        if c & (c - 1):
            raise ValueError(
                f"local_capacity {c} is not a power of two: the voxel "
                "table (and the plane kernel's probe) needs one, so the "
                "number of ranks must be a power of two (1, 2, 4, 8)")

        # The same TF32 policy as LioEngine (process-wide torch flags).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        f = dict(dtype=dtype, device=self.device)
        self.noise = torch.as_tensor(eskf_mod.noise_diag_np(
            cfg.imu_options.acc_cov, cfg.imu_options.gyr_cov,
            cfg.imu_options.b_acc_cov, cfg.imu_options.b_gyr_cov), **f)
        self.r_il = torch.as_tensor(cfg.extrinsics.R_imu_lidar(), **f)
        self.t_il = torch.as_tensor(cfg.extrinsics.t_imu_lidar(), **f)
        h = self.halo
        # the 8 halo corner offsets (+-halo per dim) in voxel units
        self.corner_offs = torch.tensor(
            [[sx, sy, sz] for sx in (-h, h) for sy in (-h, h)
             for sz in (-h, h)], dtype=torch.int32, device=self.device)
        self._earlier = torch.tril(torch.ones(
            (8, 8), dtype=torch.bool, device=self.device), -1)
        # shuffle-equivalent priority order of the frame subsample
        # (frame.subsample_perm), as the single-device engine's
        self.perm = torch.as_tensor(
            frame_ops.subsample_perm(sh.max_sweep_points),
            device=self.device).to(torch.int64)

    def init_state(self) -> EskfState:
        return eskf_mod.init_state(self.cfg.gravity_acc, self.dtype,
                                   self.device)

    def make_map(self) -> vm.VoxelMap:
        """This rank's block-owner sub-table: `local_capacity` slots (2x
        the even split of map_capacity, the halo headroom)."""
        return vm.make_map(self.local_capacity,
                           self.cfg.shapes.map_voxel_points, self.dtype,
                           self.device)

    def map_size(self, vmap: vm.VoxelMap) -> torch.Tensor:
        """Owned-voxel point count over all ranks (halo copies excluded):
        the single-device vm.map_size of the same map."""
        owned = ((vmap.keys[:, 0] != vm.EMPTY)
                 & (shard_of(vmap.keys, self.n_shards, self.block_bits)
                    == self.mesh.rank))
        return self.mesh.psum(torch.sum(torch.where(
            owned, vmap.counts, torch.zeros_like(vmap.counts)),
            dtype=torch.int64))

    def compact(self, vmap: vm.VoxelMap, location
                ) -> Tuple[vm.VoxelMap, torch.Tensor]:
        """Slot-reclaiming far-voxel eviction of the sharded map
        (lioOptimization.cpp:556-572 erase semantics; the counterpart of
        the single-device pipeline's compact_map call).

        Ownership is static, so each rank compacts its local table on its
        own: owned voxels and halo replicas evict by the same distance
        rule against the replicated position, which keeps replicas
        consistent with their owners.  Returns (new local map, dropped-in-
        rehash count psum'd over the ranks).  Drive it every
        `eviction_every_n_frames` when `enable_map_eviction` is set; it is
        off the per-sweep path."""
        loc = torch.as_tensor(location, dtype=self.dtype, device=self.device)
        m2, dropped = vm.compact_map(
            vmap, loc, distance=self.cfg.odometry_options.max_distance,
            max_probe=self.cfg.shapes.map_max_probe)
        return m2, self.mesh.psum(dropped)

    def make_profile_step(self, stop_after: str, phase: str = "steady"):
        """A prefix of the per-sweep step that stops after the named stage
        (one of PROFILE_STAGES) and returns one replicated scalar
        checksum: per-stage cost by prefix differencing.  Prefixes that
        reach the insert run on a copy of the local map, which the step
        would otherwise update in place."""
        if stop_after not in PROFILE_STAGES:
            raise ValueError(f"stop_after {stop_after!r} is not one of "
                             f"{PROFILE_STAGES}")

        def run(state, vmap, sweep):
            if stop_after in _AFTER_INSERT:
                vmap = vm.VoxelMap(*(t.clone() for t in vmap))
            if isinstance(sweep, WireSweep):
                sweep = unpack_wire(sweep)
            return self._sweep_core(state, vmap, sweep, phase=phase,
                                    stop_after=stop_after)
        return run

    def phase(self, frame_id: int, gyr_rate: float = 0.0) -> str:
        if frame_id < self.cfg.odometry_options.init_num_frames:
            return "init"
        if (self.cfg.adaptive_keypoint_density
                and gyr_rate > self.cfg.dense_gyr_threshold):
            return "steady_dense"
        return "steady"

    def step(self, state: EskfState, voxel_map: vm.VoxelMap, sweep,
             frame_id: int, gyr_rate: float = 0.0) -> SweepOutput:
        """One sweep on this rank.  `state` and `sweep` (a SweepInput or
        a WireSweep on the mesh's device) are the same on every rank;
        `voxel_map` is this rank's local table, updated in place."""
        if isinstance(sweep, WireSweep):
            sweep = unpack_wire(sweep)
        return self._sweep_core(state, voxel_map, sweep,
                                phase=self.phase(frame_id, gyr_rate))

    # ------------------------------------------------------------------
    def _sweep_core(self, state: EskfState, local_map: vm.VoxelMap, sweep,
                    *, phase: str, stop_after: Optional[str] = None):
        cfg = self.cfg
        icp = cfg.icp
        odo = cfg.odometry_options
        sh = cfg.shapes
        n = self.n_shards
        mesh = self.mesh
        me = mesh.rank
        dev = self.device
        r_il, t_il = self.r_il, self.t_il
        is_init = phase == "init"
        # steady_dense: motion-adaptive keypoint density, the same
        # semantics as the single-device engine
        sample_voxel = (odo.init_sample_voxel_size if is_init
                        else cfg.dense_sample_voxel_size
                        if phase == "steady_dense"
                        else odo.sample_voxel_size)
        sub_voxel = odo.init_voxel_size if is_init else odo.voxel_size
        nb_voxels = 2 if is_init else icp.voxel_neighborhood
        if nb_voxels > self.halo:
            raise ValueError("map_halo_voxels must cover nb_voxels_visited")
        max_iters = (max(15, icp.num_iters_icp) if is_init
                     else icp.num_iters_icp)
        last_trans = state.p
        i32 = dict(dtype=torch.int32, device=dev)
        overflow = torch.zeros((), **i32)

        def _i32_full(like):
            return torch.full_like(like, I32_MAX, dtype=torch.int32)

        # 1. Replicated IMU scan (sequential, ~50 samples; the only
        #    replicated compute besides the 17x17 solves).
        pre = state
        state_pred, scan_states = eskf_mod.predict_sweep(
            state, self.noise, sweep.imu_t, sweep.imu_dt, sweep.imu_acc,
            sweep.imu_gyr, sweep.imu_valid)

        def _prepend(x0, xs):
            return torch.cat([x0[None], xs], dim=0)
        imu_states = ImuStates(
            t=_prepend(torch.zeros((), dtype=sweep.imu_t.dtype, device=dev),
                       sweep.imu_t),
            un_acc=_prepend(lie.quat_to_rot(pre.q) @ (pre.acc_0 - pre.ba),
                            scan_states.un_acc),
            un_gyr=_prepend(pre.gyr_0 - pre.bg, scan_states.un_gyr),
            p=_prepend(pre.p, scan_states.p),
            q=_prepend(pre.q, scan_states.q),
            v=_prepend(pre.v, scan_states.v),
            valid=_prepend(torch.ones((), dtype=torch.bool, device=dev),
                           scan_states.valid))

        # 2. De-skew on my N/n index slice (per point, no communication).
        Ns = self.Ns
        sl = slice(me * Ns, (me + 1) * Ns)
        raw_s, trel_s, pval_s = (sweep.raw_pts[sl], sweep.t_rel[sl],
                                 sweep.pt_valid[sl])
        gidx_s = me * Ns + torch.arange(Ns, **i32)
        if odo.motion_compensation == MOTION_COMP_IMU:
            imu_pts = frame_ops.undistort_imu(raw_s, trel_s, imu_states,
                                              r_il, t_il)
        elif odo.motion_compensation == MOTION_COMP_CONSTANT_VELOCITY:
            imu_pts = frame_ops.undistort_constant(raw_s, trel_s, imu_states,
                                                   r_il, t_il)
        else:
            imu_pts = lie.quat_rotate(state_pred.q.expand(Ns, 4),
                                      raw_s @ r_il.T + t_il) + state_pred.p
        deskew_s = frame_ops.to_end_frame(imu_pts, imu_states, r_il, t_il)
        if stop_after == "deskew":
            return mesh.psum(torch.sum(deskew_s))

        # 3. Frame voxel subsample: an exact distributed dedup, sort-free.
        #    (a) local pre-dedup on the slice (winner = min stream index)
        fh_s = torch.where(pval_s, frame_ops._voxel_key(deskew_s, sub_voxel),
                           _i32_full(gidx_s))
        win1 = frame_ops.bucket_dedup_min(fh_s, gidx_s, pval_s)
        rows1 = routing.pack_cols(deskew_s, fh_s, gidx_s)
        dest1 = routing.hash_range_owner(fh_s, n)
        #    (b) winners to their hash-range owner
        buf, bval, d = routing.pack_for_exchange(dest1, win1, rows1, n,
                                                 self.B2)
        overflow += d
        rcv, rval = routing.exchange(buf, bval, mesh)
        #    (c) exact dedup within my hash range (winner = min index)
        fh_r = torch.where(rval, routing.unpack_col_i32(rcv, 3),
                           _i32_full(rval))
        gidx_r = routing.unpack_col_i32(rcv, 4)
        win2 = frame_ops.bucket_dedup_min(fh_r, gidx_r, rval)
        #    (d) global stream-order ranks before compaction: ONE
        #    winner-histogram psum over the priority space + an exclusive
        #    cumsum gives the single-device voxel_subsample row ranks, so
        #    the segment holds only the post-cap survivors
        N_tot = sh.max_sweep_points
        F = sh.max_frame_points
        pg_r = self.perm[torch.clamp(gidx_r, 0, N_tot - 1).to(torch.int64)]
        flags_f = mesh.psum(_histogram(pg_r, win2, N_tot))
        pref_f = _exclusive_prefix(flags_f)
        keep2 = win2 & (pref_f[pg_r] < F)                  # global max_out
        seg_rows, seg_val, d = routing.compact(rcv, keep2, self.F_seg)
        overflow += d
        frame_pt_s = seg_rows[:, 0:3]
        gidx_seg = routing.unpack_col_i32(seg_rows, 4)
        r_f = torch.where(
            seg_val,
            pref_f[self.perm[torch.clamp(gidx_seg, 0, N_tot - 1)
                             .to(torch.int64)]].to(torch.int32),
            _i32_full(gidx_seg))
        if stop_after == "frame_sub":
            return mesh.psum(
                torch.sum(torch.where(seg_val[:, None], frame_pt_s, 0.0))
                + torch.sum(torch.where(seg_val, r_f, 0)))

        # 4. Keypoint grid sample: the same machinery at the sample voxel;
        #    winner per cell = min frame rank (stream order).
        kp_h = torch.where(seg_val,
                           frame_ops._voxel_key(frame_pt_s, sample_voxel),
                           _i32_full(r_f))
        rows2 = routing.pack_cols(frame_pt_s, kp_h, r_f)
        dest2 = routing.hash_range_owner(kp_h, n)
        buf, bval, d = routing.pack_for_exchange(dest2, seg_val, rows2, n,
                                                 self.B3)
        overflow += d
        rcv2, rval2 = routing.exchange(buf, bval, mesh)
        kph_r = torch.where(rval2, routing.unpack_col_i32(rcv2, 3),
                            _i32_full(rval2))
        rf_r2 = routing.unpack_col_i32(rcv2, 4)
        win3 = frame_ops.bucket_dedup_min(kph_r, rf_r2, rval2)
        rf_c2 = torch.clamp(rf_r2, 0, F - 1).to(torch.int64)
        flags_k = mesh.psum(_histogram(rf_c2, win3, F))
        pref_k = _exclusive_prefix(flags_k)
        keep3 = win3 & (pref_k[rf_c2] < sh.max_keypoints)
        kseg_rows, kseg_val, d = routing.compact(rcv2, keep3, self.K_seg)
        overflow += d
        kp_rf = routing.unpack_col_i32(kseg_rows, 4)
        r_k = torch.where(
            kseg_val,
            pref_k[torch.clamp(kp_rf, 0, F - 1).to(torch.int64)]
            .to(torch.int32),
            _i32_full(kp_rf))
        key_pt_s = kseg_rows[:, 0:3]      # end-frame LiDAR coords
        if stop_after == "kp_sub":
            return mesh.psum(
                torch.sum(torch.where(kseg_val[:, None], key_pt_s, 0.0))
                + torch.sum(torch.where(kseg_val, r_k, 0)))

        # 5. Keypoints to their centre-block owner (one destination each;
        #    the halo makes the whole neighbourhood local there).
        loc_seg = key_pt_s @ r_il.T + t_il
        world0_seg = lie.quat_rotate(state_pred.q.expand(self.K_seg, 4),
                                     loc_seg) + state_pred.p
        dest3 = shard_of(vm.voxel_coords(world0_seg, icp.size_voxel_map), n,
                         self.block_bits)
        rows3 = routing.pack_cols(key_pt_s, r_k)
        buf, bval, d = routing.pack_for_exchange(dest3, kseg_val, rows3, n,
                                                 self.B4)
        overflow += d
        rcv3, rval3 = routing.exchange(buf, bval, mesh)
        qrows, qval, d = routing.compact(rcv3, rval3, self.K4)
        overflow += d
        key_q = qrows[:, 0:3]
        rank_q = torch.where(qval, routing.unpack_col_i32(qrows, 3),
                             _i32_full(qval))
        if stop_after == "route_q":
            return mesh.psum(
                torch.sum(torch.where(qval[:, None], key_q, 0.0)))

        # 6. Distributed IESKF: local rows, one packed psum per iteration.
        def _run_iekf(nb):
            return self._iekf(state_pred, local_map, key_q, qval, rank_q,
                              last_trans, sweep.threshold_capacity,
                              nb_voxels=nb, max_iters=max_iters)

        state_upd, summary = _run_iekf(nb_voxels)
        if cfg.retry_wider_neighborhood and nb_voxels + 1 <= self.halo:
            # weak-solve retry with the single-device semantics; the
            # summary is replicated, so every rank takes the same branch
            strong = bool(summary.success) and (
                int(summary.num_residuals) >= icp.min_num_residuals)
            if not strong:
                state_upd, summary = _run_iekf(nb_voxels + 1)
        state_new = eskf_mod.map_state(
            lambda a, b: torch.where(sweep.do_optimize, a, b),
            state_upd, state_pred)
        success = torch.where(sweep.do_optimize, summary.success,
                              torch.ones_like(summary.success))
        if stop_after == "iekf":
            return mesh.psum(torch.sum(state_new.p))

        # 7. Owner-insert + accepted-replay.  Each frame row goes once to
        #    its primary (centre-block) owner, which runs the gate, the
        #    global insert-budget prefix and the insert; the rows it
        #    accepts are then replayed to the other corner-block owners
        #    that store the voxel as halo.  Replaying the accepted subset
        #    in frame-rank order reproduces the owner's per-voxel outcome:
        #    insert() ranks gate-passers only, accepted rows pass the same
        #    gate against the (by induction identical) replica table, and
        #    block appends land at identical slots.
        frame_world_s = frame_ops.transform_to_world(
            frame_pt_s, state_new.q, state_new.p, r_il, t_il)
        ins_ok = seg_val & success
        dest5 = shard_of(vm.voxel_coords(frame_world_s, icp.size_voxel_map),
                         n, self.block_bits)
        rows4 = routing.pack_cols(frame_world_s, r_f)
        buf, bval, d = routing.pack_for_exchange(dest5, ins_ok, rows4, n,
                                                 self.B5)
        overflow += d
        rcv4, rval4 = routing.exchange(buf, bval, mesh)
        # deterministic candidate order: received rows go to a dense
        # rank-keyed table (each global frame rank has ONE primary owner),
        # then a stable compact reproduces the single-device batch order
        rank_tbl, rank_tvl = _scatter_rows(
            rcv4, rval4, torch.clamp(routing.unpack_col_i32(rcv4, 3),
                                     0, F - 1), F)
        ins_rows, ins_val, d = routing.compact(rank_tbl, rank_tvl,
                                               self.W_ins)
        overflow += d
        ins_rf = torch.clamp(routing.unpack_col_i32(ins_rows, 3), 0, F - 1
                             ).to(torch.int64)
        ins_pts = ins_rows[:, 0:3].contiguous()
        if stop_after == "ins_route":
            return mesh.psum(
                torch.sum(torch.where(ins_val[:, None], ins_rows, 0.0))
                + torch.sum(state_new.p))
        # the gate runs once (with aux) and feeds both the global budget
        # prefix and the insert itself
        pre_gate = vm.insert_gate(
            local_map, ins_pts, ins_val, icp.size_voxel_map,
            odo.min_distance_points, sh.map_max_probe,
            gate_chunk=sh.query_chunk, with_aux=True)
        gate = pre_gate[0]
        if sh.max_insert_points and sh.max_insert_points < F:
            # exact global insert budget (single-device insert(budget=)
            # keeps the first `budget` gate-passing candidates in frame-
            # rank order): the owners' verdicts go into a rank-indexed
            # histogram, psum'd, and its exclusive prefix orders them
            prefix = _exclusive_prefix(mesh.psum(
                _histogram(ins_rf, gate, F)))
            ins_val = ins_val & (~gate | (prefix[ins_rf]
                                          < sh.max_insert_points))
        if stop_after == "ins_gate":
            return mesh.psum(torch.sum(ins_val.to(self.dtype))
                             + torch.sum(state_new.p))
        # in place: nothing reads the pre-insert table after this
        local_new, accepted = vm.insert(
            local_map, ins_pts, ins_val, icp.size_voxel_map,
            odo.min_distance_points, sh.map_max_probe, pre_gate=pre_gate)
        if stop_after == "insert":
            return mesh.psum(torch.sum(accepted.to(self.dtype))
                             + torch.sum(local_new.counts).to(self.dtype))

        # 7b. Replay the accepted rows to the other storing ranks: the
        #    corner-owner set of a voxel covers exactly the ranks whose
        #    halo-extended blocks contain it (a block side >= 2*halo+1
        #    that meets the [v-h, v+h] cube contains one of its 8
        #    corners).
        acc = ins_val & accepted
        cv = (vm.voxel_coords(ins_pts, icp.size_voxel_map)[:, None, :]
              + self.corner_offs[None])
        owners_a = shard_of(cv, n, self.block_bits)          # (W_ins, 8)
        dupm = torch.any((owners_a[:, :, None] == owners_a[:, None, :])
                         & self._earlier[None], dim=-1)
        rep_ok = acc[:, None] & ~dupm & (owners_a != me)
        # compact the sparse valid copies, then pack
        ok_flat = rep_ok.reshape(-1)
        crank = torch.cumsum(ok_flat.to(torch.int64), 0) - 1
        ok2 = ok_flat & (crank < self.C_rep)
        dsti = torch.where(ok2, crank, self.C_rep)
        sel_row = torch.zeros((self.C_rep + 1,), dtype=torch.int64,
                              device=dev)
        sel_row[dsti] = torch.arange(self.W_ins * 8, device=dev) // 8
        sel_dest = torch.zeros((self.C_rep + 1,), **i32)
        sel_dest[dsti] = owners_a.reshape(-1)
        val_c = torch.zeros((self.C_rep + 1,), dtype=torch.bool, device=dev)
        val_c[dsti] = True
        overflow += (torch.sum(ok_flat) - torch.sum(ok2)).to(torch.int32)
        buf6, bval6, d = routing.pack_for_exchange(
            sel_dest[:-1], val_c[:-1], ins_rows[sel_row[:-1]], n, self.B6)
        overflow += d
        if stop_after == "rep_pack":
            return mesh.psum(torch.sum(buf6)
                             + torch.sum(local_new.counts).to(buf6.dtype))
        rcv6, rval6 = routing.exchange(buf6, bval6, mesh)
        # replay rows ordered by global rank through the same rank-keyed
        # table + stable compact (a rank receives each frame rank at most
        # once: the sender's distinct-corner-owner dedup guarantees it)
        tbl6, tvl6 = _scatter_rows(
            rcv6, rval6, torch.clamp(routing.unpack_col_i32(rcv6, 3),
                                     0, F - 1), F)
        rep_rows, rep_val, d = routing.compact(tbl6, tvl6, self.C_rep)
        overflow += d
        if stop_after == "rep_sort":
            return mesh.psum(
                torch.sum(torch.where(rep_val[:, None], rep_rows, 0.0))
                + torch.sum(local_new.counts).to(rep_rows.dtype))
        # replayed rows were accepted at their primary owner against an
        # identical block, so the min-distance verdict is known to pass:
        # min_distance=0 skips the block-distance gather; probe, claim and
        # append still run and land the rows at identical slots
        local_new, _ = vm.insert(
            local_new, rep_rows[:, 0:3].contiguous(), rep_val,
            icp.size_voxel_map, 0.0, sh.map_max_probe,
            gate_chunk=sh.query_chunk)
        if stop_after == "replay":
            return mesh.psum(torch.sum(local_new.counts).to(self.dtype))

        # 8. The replicated outputs in the single-device layout: scatter
        #    the segments by global rank, then ONE psum for everything
        #    (each row has one non-zero contributor, so the sum is exact).
        #    Frame ranks are dense (0..n_winners-1), so frame validity is
        #    rank < n_winners, from the already psum'd flags_f.
        n_win = torch.sum(flags_f)
        out_pack = torch.zeros((F + 1, 4), dtype=frame_world_s.dtype,
                               device=dev)
        out_pack[torch.where(seg_val, r_f.to(torch.int64), F), 0:3] = \
            frame_world_s
        out_pack[torch.where(ins_val & accepted, ins_rf, F), 3] = 1.0
        out_pack[F] = 0.0
        out_pack[F, 0] = overflow.to(out_pack.dtype)
        out_pack = mesh.psum(out_pack)
        frame_world_g = out_pack[:F, 0:3]
        frame_valid_g = torch.arange(F, device=dev) < n_win
        inserted_g = out_pack[:F, 3] > 0.5
        overflow = out_pack[F, 0].to(torch.int32)
        if stop_after == "out":
            return mesh.psum(torch.sum(frame_world_g)
                             + torch.sum(local_new.counts).to(self.dtype)
                             + torch.sum(state_new.p))

        summary = summary._replace(success=success)
        return SweepOutput(state=state_new, voxel_map=local_new,
                           summary=summary, frame_pts_world=frame_world_g,
                           frame_valid=frame_valid_g, inserted=inserted_g,
                           record=pack_record(state_new, summary),
                           route_overflow=overflow)

    # ------------------------------------------------------------------
    def _iekf(self, state, local_map, key_q, qval, rank_q, last_trans,
              threshold_capacity, *, nb_voxels, max_iters):
        """The IESKF update on this rank's routed keypoints: the
        association on the local table (`knn_plane_assoc` once per update
        with `cache_association`, else `knn_plane_rows` per iteration),
        the global keypoint-order residual cap, and one packed 43-float
        psum of the normal equations per iteration."""
        cfg = self.cfg
        icp = cfg.icp
        sh = cfg.shapes
        mesh = self.mesh
        loc_q = key_q @ self.r_il.T + self.t_il       # IMU frame
        nq = loc_q.shape[0]
        lam_w, lam_nb = lio._lam(icp.weight_alpha, icp.weight_neighborhood)
        cap = icp.max_num_residuals
        q_tot = sh.max_keypoints
        rank_c = torch.clamp(rank_q, 0, q_tot - 1).to(torch.int64)
        search = dict(voxel_size=icp.size_voxel_map,
                      max_neighbors=icp.max_number_neighbors,
                      max_probe=sh.map_max_probe, nb_voxels=nb_voxels)
        tail = dict(lam_w=lam_w, lam_nb=lam_nb,
                    power_planarity=icp.power_planarity,
                    max_dist=icp.max_dist_to_plane_icp,
                    min_neighbors=icp.min_number_neighbors)

        def world_at(s):
            return lie.quat_rotate(s.q.expand(nq, 4), loc_q) + s.p

        if cfg.cache_association:
            # queries are prefix-compacted: only the occupied prefix of
            # the K4 budget is associated
            assoc = lio.chunked_assoc(
                local_map, world_at(state), torch.sum(qval),
                threshold_capacity=threshold_capacity, chunk=sh.query_chunk,
                **search)

            def rows(s):
                return plane_fit.plane_rows_from_assoc(
                    *assoc, world_at(s), loc_q, lie.quat_to_rot(s.q),
                    last_trans, qval, **tail)
        else:
            def rows(s):
                return plane_fit.knn_plane_rows(
                    local_map, world_at(s), loc_q, lie.quat_to_rot(s.q),
                    last_trans, qval, threshold_capacity, **search, **tail)

        def normal_equations(s):
            h_x, h, good = rows(s)
            if cap > 0:
                # exact global keypoint-order prefix (optimize.cpp:107):
                # keypoint ranks are globally unique, so the good flags go
                # into ONE (Q,) rank histogram; a psum and an exclusive
                # cumsum give each row the good rows of lower rank
                prefix = _exclusive_prefix(mesh.psum(
                    _histogram(rank_c, good, q_tot)))[rank_c]
                good = good & (prefix + 1 <= cap)
                h_x = torch.where(good[:, None], h_x, torch.zeros_like(h_x))
                h = torch.where(good, h, torch.zeros_like(h))
            # ONE packed psum: [H^T H (36) | H^T h (6) | num (1)], of
            # float64 partials (see lio.normal_sums)
            hth, hth_h = lio.normal_sums(h_x, h)
            packed = mesh.psum(torch.cat([
                hth.reshape(-1), hth_h,
                torch.sum(good).to(hth.dtype)[None]]))
            return (packed[:36].reshape(6, 6).to(h.dtype),
                    packed[36:42].to(h.dtype), packed[42].to(torch.int32))

        return lio.iekf_iterations(
            state, state, normal_equations,
            min_number_neighbors=icp.min_number_neighbors,
            max_iters=max_iters,
            threshold_translation_norm=icp.threshold_translation_norm,
            threshold_orientation_norm=icp.threshold_orientation_norm,
            laser_point_cov=cfg.laser_point_cov)
