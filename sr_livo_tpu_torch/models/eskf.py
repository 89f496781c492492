"""Error-State Kalman Filter (17-dim) for the LIO backbone.

Port of `sr_livo_tpu/models/eskf.py` (the reference eskfEstimator,
src/eskfEstimator.cpp).  Error state layout (indices):

    [0:3]   dp      position
    [3:6]   dtheta  SO(3) attitude (right perturbation q <- q*exp(dtheta))
    [6:9]   dv      velocity
    [9:12]  dba     accel bias
    [12:15] dbg     gyro bias
    [15:17] dg      gravity on S2 (2-dim tangent)

The nominal state is a NamedTuple of f32 tensors on one device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from sr_livo_tpu_torch.utils import lie

# IMU static-initialization gates (utility.h:28-31)
MIN_INI_COUNT = 10
MIN_INI_TIME = 3.0
MAX_GYR_VAR = 0.5
MAX_ACC_VAR = 0.6


class EskfState(NamedTuple):
    """Nominal state + covariance + last IMU sample."""
    p: torch.Tensor        # (3,)
    q: torch.Tensor        # (4,) wxyz
    v: torch.Tensor        # (3,)
    ba: torch.Tensor       # (3,)
    bg: torch.Tensor       # (3,)
    g: torch.Tensor        # (3,)
    cov: torch.Tensor      # (17, 17)
    acc_0: torch.Tensor    # (3,) previous accel sample
    gyr_0: torch.Tensor    # (3,) previous gyro sample


class ImuStates(NamedTuple):
    """Per-sample propagated IMU trajectory over one sweep (all (S, ...))."""
    t: torch.Tensor        # (S,) relative time from sweep start
    un_acc: torch.Tensor   # (S, 3) world-frame net acceleration
    un_gyr: torch.Tensor   # (S, 3) bias-corrected body rate
    p: torch.Tensor        # (S, 3)
    q: torch.Tensor        # (S, 4)
    v: torch.Tensor        # (S, 3)
    valid: torch.Tensor    # (S,) bool


def map_state(fn, *states):
    """Apply `fn` field by field over one or more states of one type."""
    return type(states[0])(*(fn(*fields) for fields in zip(*states)))


def init_state(gravity=(0.0, 0.0, 9.81), dtype=torch.float32,
               device="cpu") -> EskfState:
    f = dict(dtype=dtype, device=device)
    return EskfState(
        p=torch.zeros(3, **f),
        q=lie.quat_identity(dtype=dtype, device=device),
        v=torch.zeros(3, **f),
        ba=torch.zeros(3, **f),
        bg=torch.zeros(3, **f),
        g=torch.tensor(gravity, **f),
        cov=torch.eye(17, **f),
        acc_0=torch.tensor(gravity, **f),
        gyr_0=torch.zeros(3, **f),
    )


def noise_diag_np(acc_cov, gyr_cov, b_acc_cov, b_gyr_cov, dtype=np.float32):
    """12-dim process-noise diagonal [na(3), ng(3), nba(3), nbg(3)]."""
    return np.concatenate([
        np.full(3, acc_cov, dtype), np.full(3, gyr_cov, dtype),
        np.full(3, b_acc_cov, dtype), np.full(3, b_gyr_cov, dtype)])


def _s2_block(g: torch.Tensor, b_x: torch.Tensor) -> torch.Tensor:
    g_x = lie.skew(g)
    g_norm_sq = torch.clamp(torch.sum(g * g), min=1e-12)
    return -(b_x.T @ g_x @ g_x @ b_x) / g_norm_sq


def predict(state: EskfState, noise: torch.Tensor, dt, acc_1, gyr_1
            ) -> EskfState:
    """One midpoint-integration step (eskfEstimator.cpp:166-217)."""
    f = dict(dtype=state.p.dtype, device=state.p.device)
    dt = torch.as_tensor(dt, **f)
    acc_1 = torch.as_tensor(acc_1, **f)
    gyr_1 = torch.as_tensor(gyr_1, **f)

    un_gyr = 0.5 * (state.gyr_0 + gyr_1) - state.bg
    un_acc = 0.5 * (state.acc_0 + acc_1) - state.ba

    r_before = lie.quat_to_rot(state.q)
    q_new = lie.quat_normalize(lie.quat_mul(state.q,
                                            lie.exp_so3_quat(un_gyr * dt)))
    p_new = state.p + state.v * dt
    v_new = state.v + r_before @ un_acc * dt - state.g * dt

    gyr_x = lie.skew(un_gyr)
    acc_x = lie.skew(un_acc)
    b_x = lie.s2_bx(state.g)
    g_x = lie.skew(state.g)
    eye3 = torch.eye(3, **f)

    f_x = torch.zeros((17, 17), **f)
    f_x[0:3, 0:3] = eye3
    f_x[0:3, 6:9] = eye3 * dt
    f_x[3:6, 3:6] = eye3 - gyr_x * dt
    f_x[3:6, 12:15] = -eye3 * dt
    f_x[6:9, 3:6] = -r_before @ acc_x * dt
    f_x[6:9, 6:9] = eye3
    f_x[6:9, 9:12] = -r_before * dt
    f_x[6:9, 15:17] = g_x @ b_x * dt
    f_x[9:12, 9:12] = eye3
    f_x[12:15, 12:15] = eye3
    f_x[15:17, 15:17] = _s2_block(state.g, b_x)

    f_w = torch.zeros((17, 12), **f)
    f_w[6:9, 0:3] = -r_before * dt
    f_w[3:6, 3:6] = -eye3 * dt
    f_w[9:12, 6:9] = -eye3 * dt
    f_w[12:15, 9:12] = -eye3 * dt

    cov_new = f_x @ state.cov @ f_x.T + (f_w * noise[None, :]) @ f_w.T
    return state._replace(p=p_new, q=q_new, v=v_new, cov=cov_new,
                          acc_0=acc_1, gyr_0=gyr_1)


def predict_sweep_sequential(state: EskfState, noise: torch.Tensor,
                             t_rel, dts, accs, gyrs, valid
                             ) -> Tuple[EskfState, ImuStates]:
    """Sample-by-sample propagation through a padded per-sweep IMU batch
    (run()'s per-sweep IMU loop, lioOptimization.cpp:1489-1569).  Invalid
    (padding) samples pass the state through unchanged.  Reference for
    `predict_sweep`; kept for cross-checking."""
    s = state
    ps, qs, vs, un_gyrs, un_accs = [], [], [], [], []
    for k in range(dts.shape[0]):
        un_gyr = 0.5 * (s.gyr_0 + gyrs[k]) - s.bg
        un_acc = lie.quat_to_rot(s.q) @ (0.5 * (s.acc_0 + accs[k]) - s.ba)
        s_next = predict(s, noise, dts[k], accs[k], gyrs[k])
        ok = valid[k]
        s = map_state(lambda a, b: torch.where(ok, a, b), s_next, s)
        ps.append(s.p)
        qs.append(s.q)
        vs.append(s.v)
        un_gyrs.append(un_gyr)
        un_accs.append(un_acc)
    imu_states = ImuStates(t=t_rel, un_acc=torch.stack(un_accs),
                           un_gyr=torch.stack(un_gyrs), p=torch.stack(ps),
                           q=torch.stack(qs), v=torch.stack(vs), valid=valid)
    return s, imu_states


def _quat_prefix_products(dq: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products dq_0 * dq_1 * ... * dq_k, (S, 4), by
    log2(S) doubling steps (Hillis-Steele); the product order is kept, so
    it equals the sequential chain up to f32 round-off."""
    out = dq
    step = 1
    while step < out.shape[0]:
        out = torch.cat([out[:step], lie.quat_mul(out[:-step], out[step:])])
        step *= 2
    return out


def predict_sweep(state: EskfState, noise: torch.Tensor,
                  t_rel: torch.Tensor, dts: torch.Tensor, accs: torch.Tensor,
                  gyrs: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[EskfState, ImuStates]:
    """Parallel formulation of `predict_sweep_sequential`.

    * orientation: per-step increments dq_k = exp(un_gyr_k dt_k) depend only
      on the (constant-per-sweep) gyro bias, so the orientation chain is a
      prefix product of quaternions (log2(S) doubling steps);
    * velocity/position: with all rotations known, two cumulative sums;
    * covariance: P_{k+1} = F_k P_k F_k^T + Q_k composes associatively as
      (F2,Q2)o(F1,Q1) = (F2 F1, F2 Q1 F2^T + Q2), reduced as a log2(S) tree
      of batched 17x17 matmuls.

    Padding samples are forced to dt=0 (identity mean step) and
    (F,Q)=(I,0).  Results match the sequential chain to f32 round-off.
    """
    f32 = dict(dtype=state.p.dtype, device=state.p.device)
    S = dts.shape[0]
    dt = torch.where(valid, dts, torch.zeros_like(dts)).to(state.p.dtype)

    acc_prev = torch.cat([state.acc_0[None], accs[:-1]], dim=0)
    gyr_prev = torch.cat([state.gyr_0[None], gyrs[:-1]], dim=0)
    un_gyr = 0.5 * (gyr_prev + gyrs) - state.bg            # (S, 3)
    un_acc_body = 0.5 * (acc_prev + accs) - state.ba       # (S, 3)

    dq = lie.exp_so3_quat(un_gyr * dt[:, None])            # identity when dt=0
    q_prefix = _quat_prefix_products(dq)
    q_post = lie.quat_normalize(lie.quat_mul(state.q.expand(S, 4), q_prefix))
    q_pre = torch.cat([state.q[None], q_post[:-1]], dim=0)
    r_pre = lie.quat_to_rot(q_pre)                         # (S, 3, 3)

    un_acc_world = torch.einsum("sij,sj->si", r_pre, un_acc_body)
    dv = (un_acc_world - state.g[None, :]) * dt[:, None]
    v_post = state.v[None, :] + torch.cumsum(dv, dim=0)
    v_pre = torch.cat([state.v[None], v_post[:-1]], dim=0)
    p_post = state.p[None, :] + torch.cumsum(v_pre * dt[:, None], dim=0)

    gyr_x = lie.skew(un_gyr)
    acc_x = lie.skew(un_acc_body)
    b_x = lie.s2_bx(state.g)
    g_x = lie.skew(state.g)
    eye_s = torch.eye(3, **f32).expand(S, 3, 3)
    dt3 = dt[:, None, None]

    f = torch.zeros((S, 17, 17), **f32)
    f[:, 0:3, 0:3] = eye_s
    f[:, 0:3, 6:9] = eye_s * dt3
    f[:, 3:6, 3:6] = eye_s - gyr_x * dt3
    f[:, 3:6, 12:15] = -eye_s * dt3
    f[:, 6:9, 3:6] = -torch.einsum("sij,sjk->sik", r_pre, acc_x) * dt3
    f[:, 6:9, 6:9] = eye_s
    f[:, 6:9, 9:12] = -r_pre * dt3
    f[:, 6:9, 15:17] = (g_x @ b_x)[None] * dt3
    f[:, 9:12, 9:12] = eye_s
    f[:, 12:15, 12:15] = eye_s
    f[:, 15:17, 15:17] = _s2_block(state.g, b_x)[None]
    # Padding samples: F = I (the S2 block is dt-free, so force the row).
    eye17 = torch.eye(17, **f32)
    f = torch.where(valid[:, None, None], f, eye17)

    fw = torch.zeros((S, 17, 12), **f32)
    fw[:, 6:9, 0:3] = -r_pre * dt3
    fw[:, 3:6, 3:6] = -eye_s * dt3
    fw[:, 9:12, 6:9] = -eye_s * dt3
    fw[:, 12:15, 9:12] = -eye_s * dt3
    q_noise = torch.einsum("sij,j,skj->sik", fw, noise.to(state.p.dtype), fw)
    q_noise = torch.where(valid[:, None, None], q_noise,
                          torch.zeros_like(q_noise))

    # Tree reduction of the (F, Q) composition (pad to a power of two).
    if S & (S - 1):
        pad = (1 << (S - 1).bit_length()) - S
        f = torch.cat([f, eye17.expand(pad, 17, 17)], dim=0)
        q_noise = torch.cat([q_noise, torch.zeros((pad, 17, 17), **f32)])
    while f.shape[0] > 1:
        f1, f2 = f[0::2], f[1::2]
        q1, q2 = q_noise[0::2], q_noise[1::2]
        f = f2 @ f1
        q_noise = f2 @ q1 @ f2.transpose(1, 2) + q2
    f_tot, q_tot = f[0], q_noise[0]
    cov_new = f_tot @ state.cov @ f_tot.T + q_tot

    # Final nominal state + last-sample bookkeeping (suffix padding: the
    # last valid sample's raw IMU values become acc_0/gyr_0).
    n_valid = torch.sum(valid.to(torch.int64))
    any_valid = n_valid > 0
    idx_last = torch.clamp(n_valid - 1, min=0)
    final = state._replace(
        p=torch.where(any_valid, p_post[idx_last], state.p),
        q=torch.where(any_valid, q_post[idx_last], state.q),
        v=torch.where(any_valid, v_post[idx_last], state.v),
        cov=torch.where(any_valid, cov_new, state.cov),
        acc_0=torch.where(any_valid, accs[idx_last], state.acc_0),
        gyr_0=torch.where(any_valid, gyrs[idx_last], state.gyr_0))

    imu_states = ImuStates(t=t_rel, un_acc=un_acc_world, un_gyr=un_gyr,
                           p=p_post, q=q_post, v=v_post, valid=valid)
    return final, imu_states


def observe(state: EskfState, d_x: torch.Tensor) -> EskfState:
    """Inject a 17-dim error-state correction (eskfEstimator.cpp:219-230)."""
    p = state.p + d_x[0:3]
    q = lie.quat_normalize(lie.quat_mul(state.q, lie.exp_so3_quat(d_x[3:6])))
    v = state.v + d_x[6:9]
    ba = state.ba + d_x[9:12]
    bg = state.bg + d_x[12:15]
    b_x = lie.s2_bx(state.g)
    so3_dg = b_x @ d_x[15:17]
    g = lie.exp_so3(so3_dg) @ state.g
    return state._replace(p=p, q=q, v=v, ba=ba, bg=bg, g=g)


class ImuInitializer:
    """Host-side static IMU initialization (eskfEstimator.cpp:43-118).

    An own copy of the JAX package's class.  Accumulates running
    mean/variance of (gyr, acc) while stationary; once >= MIN_INI_COUNT
    samples spanning >= MIN_INI_TIME seconds arrive with acceptable noise
    levels, produces gyro bias + gravity direction and the shrunk initial
    covariance.
    """

    def __init__(self, g_norm: float = 9.81):
        self.g_norm = float(g_norm)
        self.n = 1
        self.first_time = None
        self.last_time = None
        self.mean_gyr = np.zeros(3)
        self.mean_acc = np.array([0.0, 0.0, 9.81])
        self.var_gyr = np.zeros(3)
        self.var_acc = np.zeros(3)
        self.done = False

    def push(self, t: float, acc: np.ndarray, gyr: np.ndarray):
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        if self.first_time is None:
            self.first_time = t
            self.mean_gyr = gyr.copy()
            self.mean_acc = acc.copy()
            self.var_gyr = np.zeros(3)
            self.var_acc = np.zeros(3)
            self.n = 1
        self.last_time = t
        n = self.n
        self.mean_gyr += (gyr - self.mean_gyr) / n
        self.mean_acc += (acc - self.mean_acc) / n
        self.var_gyr = (self.var_gyr * (n - 1.0) / n
                        + (gyr - self.mean_gyr) ** 2 * (n - 1.0) / (n * n))
        self.var_acc = (self.var_acc * (n - 1.0) / n
                        + (acc - self.mean_acc) ** 2 * (n - 1.0) / (n * n))
        self.n += 1

    def ready(self) -> bool:
        if self.first_time is None or self.n <= MIN_INI_COUNT:
            return False
        if (self.last_time - self.first_time) <= MIN_INI_TIME:
            return False
        acc_var = self.var_acc * (self.g_norm / np.linalg.norm(self.mean_acc)) ** 2
        if np.linalg.norm(self.var_gyr) > MAX_GYR_VAR:
            return False
        if np.linalg.norm(acc_var) > MAX_ACC_VAR:
            return False
        return True

    def build_state(self, state: EskfState) -> EskfState:
        """Apply bias/gravity estimates + covariance shrink to `state`."""
        init_bg = self.mean_gyr
        init_g = self.mean_acc / np.linalg.norm(self.mean_acc) * self.g_norm
        cov = np.eye(17, dtype=np.float32)
        cov[9:12, 9:12] *= 0.001
        cov[12:15, 12:15] *= 0.0001
        cov[15:17, 15:17] *= 0.00001
        f = dict(dtype=state.p.dtype, device=state.p.device)
        return state._replace(bg=torch.as_tensor(init_bg, **f),
                              g=torch.as_tensor(init_g, **f),
                              cov=torch.as_tensor(cov, **f))
