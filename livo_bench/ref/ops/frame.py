# Frozen copy of sr_livo_tpu_torch/ops/frame.py at commit f22c487785a4: part of the
# benchmark's plain reference (livo_bench/check.py).  Later changes
# to the port do not change it.
"""Sweep-frame assembly ops: motion undistortion, voxel-grid subsampling.

Port of `sr_livo_tpu/ops/frame.py` (buildFrame, lioOptimization.cpp:
821-893 + utility.cpp:167-332): fixed-shape masked tensor programs over
padded sweep tensors.  Integer paths (voxel keys, winner masks, output
order) are bit-identical to the JAX package: int32 wraparound arithmetic
is computed in int64 and reduced to the same 32-bit patterns.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from livo_bench.ref.models.eskf import ImuStates
from livo_bench.ref.utils import lie


def make_point_alpha(t_rel: torch.Tensor, duration) -> torch.Tensor:
    """Per-point alpha time in [0, 1) (makePointTimestamp,
    lioOptimization.cpp:786-819).  `t_rel` is seconds from sweep begin."""
    alpha = t_rel / torch.clamp(torch.as_tensor(duration, dtype=t_rel.dtype,
                                                device=t_rel.device),
                                min=1e-9)
    return torch.clamp(alpha, 0.0, 1.0 - 1e-5)


def _last_valid(valid: torch.Tensor) -> torch.Tensor:
    """(1,) index of the last of the valid-prefix rows (0 when none): a
    (1,) index, since a 0-d tensor index reads the host."""
    return torch.clamp(torch.sum(valid.to(torch.int64), 0, keepdim=True) - 1,
                       min=0)


def undistort_constant(raw_pts: torch.Tensor, t_rel: torch.Tensor,
                       imu_states: ImuStates,
                       r_il: torch.Tensor, t_il: torch.Tensor) -> torch.Tensor:
    """Constant-velocity de-skew (distortFrameByConstant, utility.cpp:203-236):
    each point moves to the world frame with the slerp of the sweep's
    begin/end IMU poses at its capture time.  Returns (N, 3)."""
    idx_last = _last_valid(imu_states.valid)
    q0, t0 = imu_states.q[0], imu_states.p[0]
    q1, t1 = imu_states.q[idx_last][0], imu_states.p[idx_last][0]
    t_end = imu_states.t[idx_last][0]
    alpha = torch.clamp(t_rel / torch.clamp(t_end, min=1e-9), 0.0, 1.0)
    n = raw_pts.shape[0]
    q_a = lie.slerp(q0.expand(n, 4), q1.expand(n, 4), alpha)
    t_a = (1.0 - alpha)[:, None] * t0 + alpha[:, None] * t1
    pts_imu = raw_pts @ r_il.T + t_il
    return lie.quat_rotate(q_a, pts_imu) + t_a


def undistort_imu(raw_pts: torch.Tensor, t_rel: torch.Tensor,
                  imu_states: ImuStates,
                  r_il: torch.Tensor, t_il: torch.Tensor) -> torch.Tensor:
    """Full-IMU de-skew (distortFrameByImu, utility.cpp:238-312).

    Point at time t in interval [t_i, t_{i+1}) integrates from state i:
      q(t) = q_i * exp(un_gyr_{i+1} dt),  p(t) = p_i + v_i dt + 0.5 a dt^2.
    """
    ts = torch.where(imu_states.valid, imu_states.t,
                     torch.full_like(imu_states.t, float("inf")))
    # interval index: largest i with ts[i] <= t  (points before ts[0] use 0)
    idx = torch.searchsorted(ts, t_rel, right=True) - 1
    n_valid = torch.sum(imu_states.valid.to(torch.int64))
    idx = torch.minimum(torch.clamp(idx, min=0),
                        torch.clamp(n_valid - 2, min=0))

    q_i = imu_states.q[idx]
    p_i = imu_states.p[idx]
    v_i = imu_states.v[idx]
    un_gyr = imu_states.un_gyr[idx + 1]
    un_acc = imu_states.un_acc[idx + 1]
    dt = torch.clamp(t_rel - imu_states.t[idx], min=0.0)

    q_pt = lie.quat_normalize(
        lie.quat_mul(q_i, lie.exp_so3_quat(un_gyr * dt[:, None])))
    p_pt = p_i + v_i * dt[:, None] + 0.5 * un_acc * (dt * dt)[:, None]
    pts_imu = raw_pts @ r_il.T + t_il
    return lie.quat_rotate(q_pt, pts_imu) + p_pt


def to_end_frame(imu_pts: torch.Tensor, imu_states: ImuStates,
                 r_il: torch.Tensor, t_il: torch.Tensor) -> torch.Tensor:
    """Re-express de-skewed world points in the end-of-sweep LiDAR frame
    (transformAllImuPoint, utility.cpp:320-332)."""
    idx_last = _last_valid(imu_states.valid)
    q_end, p_end = imu_states.q[idx_last][0], imu_states.p[idx_last][0]
    body = lie.quat_rotate(lie.quat_conj(q_end)[None, :], imu_pts - p_end)
    return (body - t_il) @ r_il  # == R_il^T @ (body - t_il), batched


def transform_to_world(raw_pts: torch.Tensor, q: torch.Tensor,
                       t: torch.Tensor, r_il: torch.Tensor,
                       t_il: torch.Tensor) -> torch.Tensor:
    """world = R(q) (R_il raw + t_il) + t (transformPoint, utility.cpp:314)."""
    pts_imu = raw_pts @ r_il.T + t_il
    return lie.quat_rotate(q.expand(raw_pts.shape[0], 4), pts_imu) + t


# int32 voxel-key primes of the JAX package.  Products are formed in
# int64; only their low bits are used.
_SP1, _SP2, _SP3 = 73856093, 19349669, 83492791
_KEY_INVALID = 0x7FFFFFFF


def _voxel_key(pts: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """31-bit voxel key (the int32 wraparound hash masked to 0x7FFFFFFE)."""
    c = torch.trunc(pts / voxel_size).to(torch.int32).to(torch.int64)
    h = c[..., 0] * _SP1 + c[..., 1] * _SP2 + c[..., 2] * _SP3
    return (h & 0x7FFFFFFE).to(torch.int32)


def bucket_dedup_min(h: torch.Tensor, pri: torch.Tensor, valid: torch.Tensor,
                     table_size: int = None) -> torch.Tensor:
    """Winner mask of a key-grouped argmin: for each distinct key `h`
    (non-negative int32) among valid rows, True at the single row with
    the minimum `pri` (non-negative int32, unique per row).

    The JAX package finds it with claim rounds on a scatter-min bucket
    table, a `while_loop` whose round count depends on the data; its
    result, the exact argmin per key, does not depend on the bucket
    layout.  Here one sort gives the same mask with no loop: valid rows
    ordered by the int64 key `h << 32 | pri` (invalid rows last) put each
    key's rows together, its minimum-`pri` row first.  `table_size` is the
    JAX package's bucket-table size; the sort needs none."""
    del table_size
    n = h.shape[0]
    key = torch.where(valid, (h.to(torch.int64) << 32) | pri.to(torch.int64),
                      torch.full((), torch.iinfo(torch.int64).max,
                                 dtype=torch.int64, device=h.device))
    order = torch.sort(key, stable=True).indices
    h_sorted = key[order] >> 32
    first = torch.ones(n, dtype=torch.bool, device=h.device)
    first[1:] = h_sorted[1:] != h_sorted[:-1]
    return torch.zeros(n, dtype=torch.bool, device=h.device).scatter_(
        0, order, first & valid[order])


@functools.lru_cache(maxsize=8)
def subsample_perm(n: int) -> np.ndarray:
    """Deterministic pseudorandom priority permutation for voxel_subsample
    (the reference's std::shuffle of the frame before subSampleFrame,
    buildFrame, lioOptimization.cpp:843): the same numbers as the JAX
    package's `subsample_perm`."""
    return np.random.RandomState(0x5EED).permutation(n).astype(np.int32)


def voxel_subsample(key_pts: torch.Tensor, valid: torch.Tensor,
                    voxel_size: float, max_out: int,
                    payload: Tuple[torch.Tensor, ...] = (),
                    priority: torch.Tensor = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               Tuple[torch.Tensor, ...]]:
    """Keep one point per voxel, compacted to `max_out` slots in PRIORITY
    ORDER (ascending `priority`; input index when None).

    The representative of a voxel is its lowest-input-index point;
    `priority` (a permutation of 0..n-1, e.g. subsample_perm(n)) orders the
    output and thereby decides which winners survive `max_out` and the
    downstream residual cap, like the reference's shuffle.

    Returns (points (max_out, 3), valid (max_out,), gathered payload).
    """
    n = key_pts.shape[0]
    dev = key_pts.device
    h = torch.where(valid, _voxel_key(key_pts, voxel_size),
                    torch.full((n,), _KEY_INVALID, dtype=torch.int32,
                               device=dev))
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    winner = bucket_dedup_min(h, idx, valid)
    if priority is None:
        rank = torch.cumsum(winner.to(torch.int64), 0) - 1
    else:
        pri = priority.to(device=dev, dtype=torch.int64)
        # rank in priority order via one histogram + cumsum
        flags = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_fill_(
            0, torch.where(winner, pri, n), 1)[:n]
        prefix = torch.cumsum(flags, 0) - flags
        rank = prefix[pri]
    ok = winner & (rank < max_out)
    dst = torch.where(ok, rank, max_out)          # shared spare slot
    src = torch.zeros(max_out + 1, dtype=torch.int64,
                      device=dev).scatter_(0, dst, idx)[:max_out]
    out_valid = torch.zeros(max_out + 1, dtype=torch.bool,
                            device=dev).scatter_(0, dst, True)[:max_out]
    out_pts = torch.where(out_valid[:, None], key_pts[src],
                          torch.zeros((), dtype=key_pts.dtype, device=dev))
    out_payload = tuple(
        torch.where(out_valid.reshape((-1,) + (1,) * (p.dim() - 1)), p[src],
                    torch.zeros_like(p[src])) for p in payload)
    return out_pts, out_valid, out_payload
