"""Parity of the port's camera ESIKFs (sr_livo_tpu_torch.models.camera)
with the JAX package's.

From the same camera state and the same measurements, `vio_esikf` (11
dof: time offset, extrinsic, intrinsics) and `vio_photometric` (6 dof
extrinsic on colors) return the same `ok` and a camera state within 1e-5
relative (each field against its largest magnitude, at least 1), over
chains of filter steps.  With too few points both keep the state.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.models import camera as jcam
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.models import camera as tcam
from sr_livo_tpu_torch.utils import lie as tlie
from tests.torch_threads import one_intraop_thread  # noqa: F401

INTR = np.array([250.0, 250.0, 160.0, 120.0])
RTOL = 1e-5


def _assert_cams_close(tc, jc):
    got = convert.camera_state_to_numpy(tc)
    for name, v in got.items():
        want = np.asarray(getattr(jc, name))
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(v, want, atol=RTOL * scale, rtol=0,
                                   err_msg=name)


def _start(r_ic=np.eye(3)):
    jc = jcam.init_camera_state(r_ic, np.zeros(3), INTR)
    tc = tcam.init_camera_state(r_ic, np.zeros(3), INTR)
    _assert_cams_close(tc, jc)
    return jc, tc


def _imu_pose():
    q = tlie.exp_so3_quat(torch.tensor([0.03, -0.02, 0.05]))
    p = torch.tensor([0.4, -0.2, 0.1])
    return q, p


def _reproj_scene(rng, n=150):
    """Pixels seen by a camera whose extrinsic, intrinsics and time offset
    differ from the filter's start, plus noise and per-point velocity."""
    q_wi, t_wi = _imu_pose()
    pc = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 9, (n, 1))]
    d_true = torch.tensor([0.01, -0.015, 0.008], dtype=torch.float64)
    r_true = tlie.exp_so3(d_true).numpy()
    t_true = np.array([0.03, -0.02, 0.04])
    # world points whose camera-frame positions under the TRUE extrinsic
    # are pc: p_imu = R_true pc + t_true; p_world = R_wi p_imu + t_wi
    r_wi = tlie.quat_to_rot(q_wi.double()).numpy()
    pw = (pc @ r_true.T + t_true) @ r_wi.T + t_wi.double().numpy()
    k = INTR * [1.02, 0.99, 1.0, 1.0] + [0.0, 0.0, 1.5, -1.0]
    vel = rng.uniform(-60, 60, (n, 2))
    px = np.c_[pc[:, 0] * k[0] / pc[:, 2] + k[2],
               pc[:, 1] * k[1] / pc[:, 2] + k[3]] + 0.004 * vel \
        + rng.randn(n, 2) * 0.3
    f32 = np.float32
    return q_wi, t_wi, pw.astype(f32), px.astype(f32), vel.astype(f32)


@pytest.mark.parametrize("flags", [(True, True), (False, True),
                                   (True, False)])
def test_vio_esikf_matches_jax(flags):
    rng = np.random.RandomState(5)
    q_wi, t_wi, pw, px, vel = _reproj_scene(rng)
    valid = rng.rand(len(pw)) < 0.9
    intr_on, extr_on = flags
    jc, tc = _start()
    for n_new in (100, 3, 900):
        jc, jok = jcam.vio_esikf(
            jc, jnp.asarray(q_wi.numpy()), jnp.asarray(t_wi.numpy()),
            jnp.asarray(pw), jnp.asarray(px), jnp.asarray(vel),
            jnp.asarray(valid), n_new, estimate_intrinsic=intr_on,
            estimate_extrinsic=extr_on)
        tc, tok = tcam.vio_esikf(
            tc, q_wi, t_wi, torch.as_tensor(pw), torch.as_tensor(px),
            torch.as_tensor(vel), torch.as_tensor(valid),
            torch.tensor(n_new, dtype=torch.int32),
            estimate_intrinsic=intr_on, estimate_extrinsic=extr_on)
        assert bool(tok) == bool(jok) is True
        _assert_cams_close(tc, jc)


def test_vio_esikf_too_few_points_keeps_state():
    rng = np.random.RandomState(6)
    q_wi, t_wi, pw, px, vel = _reproj_scene(rng, n=20)
    valid = np.zeros(20, bool)
    valid[:5] = True
    jc, tc = _start()
    jc1, jok = jcam.vio_esikf(
        jc, jnp.asarray(q_wi.numpy()), jnp.asarray(t_wi.numpy()),
        jnp.asarray(pw), jnp.asarray(px), jnp.asarray(vel),
        jnp.asarray(valid), 100)
    tc1, tok = tcam.vio_esikf(
        tc, q_wi, t_wi, torch.as_tensor(pw), torch.as_tensor(px),
        torch.as_tensor(vel), torch.as_tensor(valid), 100)
    assert not bool(tok) and not bool(jok)
    for a, b in zip(tc1, tc):
        assert torch.equal(a, b)


def _texture(x, y):
    return np.stack([
        128 + 60 * np.sin(1.5 * x) + 30 * np.cos(2.3 * y),
        128 + 60 * np.sin(1.9 * y + 1) + 30 * np.cos(1.1 * x),
        128 + 60 * np.sin(1.3 * (x + y)),
    ], axis=-1)


@pytest.mark.parametrize("n_min", [3, 6])
def test_vio_photometric_matches_jax(n_min):
    """A textured plane z = 5 seen from a camera offset from the filter's
    start; point colors, covariances and observation counts vary, and
    `n_min` controls how many points pass the n_rgb >= 3 gate."""
    rng = np.random.RandomState(7)
    n = 200
    pts = np.c_[rng.uniform(-1.5, 1.5, (n, 2)), np.full((n, 1), 5.0)]
    colors = (_texture(pts[:, 0], pts[:, 1])
              + rng.randn(n, 3) * 2.0).astype(np.float32)
    t_true = np.array([0.05, -0.03, 0.0])
    us, vs = np.meshgrid(np.arange(320, dtype=np.float64),
                         np.arange(240, dtype=np.float64))
    wx = (us - INTR[2]) / INTR[0] * (5.0 - t_true[2]) + t_true[0]
    wy = (vs - INTR[3]) / INTR[1] * (5.0 - t_true[2]) + t_true[1]
    img = _texture(wx, wy).astype(np.float32)
    cov = rng.uniform(1.0, 20.0, (n, 3)).astype(np.float32)
    n_rgb = rng.randint(0, n_min + 4, n).astype(np.int32)
    vel = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    valid = rng.rand(n) < 0.95
    q_wi = torch.tensor([1.0, 0.0, 0.0, 0.0])
    t_wi = torch.zeros(3)
    jc, tc = _start()
    for _ in range(4):
        jc, jok = jcam.vio_photometric(
            jc, jnp.asarray(q_wi.numpy()), jnp.asarray(t_wi.numpy()),
            jnp.asarray(img), jnp.asarray(pts, jnp.float32),
            jnp.asarray(colors), jnp.asarray(cov), jnp.asarray(n_rgb),
            jnp.asarray(vel), jnp.asarray(valid), 100)
        tc, tok = tcam.vio_photometric(
            tc, q_wi, t_wi, torch.as_tensor(img),
            torch.as_tensor(pts, dtype=torch.float32),
            torch.as_tensor(colors), torch.as_tensor(cov),
            torch.as_tensor(n_rgb), torch.as_tensor(vel),
            torch.as_tensor(valid), 100)
        assert bool(tok) == bool(jok) is True
        _assert_cams_close(tc, jc)


def test_color_gradient_matches_jax():
    rng = np.random.RandomState(8)
    us, vs = np.meshgrid(np.arange(160.0), np.arange(120.0))
    img = _texture(us / 20.0, vs / 20.0).astype(np.float32)
    uv = np.c_[rng.uniform(-2, 162, 300), rng.uniform(-2, 122, 300)].astype(
        np.float32)
    j = jcam.color_gradient(jnp.asarray(img), jnp.asarray(uv))
    t = tcam.color_gradient(torch.as_tensor(img), torch.as_tensor(uv))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
