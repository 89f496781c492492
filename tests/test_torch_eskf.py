"""Parity of the port's 17-dim ESKF (sr_livo_tpu_torch.models.eskf) with
the JAX package's, on the cases of test_eskf.py.

Tolerances are float32 round-off of the quantities compared: 1e-5 on
positions, velocities and covariances (unit scale, a few hundred
operations deep), 1e-6 on unit quaternions after one step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.models import eskf as jeskf
from sr_livo_tpu.utils import lie as jlie
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.models import eskf as teskf

RNG = np.random.RandomState(1)
NOISE = np.array([0.1] * 6 + [1e-4] * 6, np.float32)


def _start_state():
    """A non-trivial JAX state and its port twin (same numpy values)."""
    js = jeskf.init_state()._replace(
        q=jlie.quat_normalize(jnp.asarray([0.9, 0.1, -0.2, 0.3],
                                          jnp.float32)),
        v=jnp.asarray([0.4, -0.2, 0.1], jnp.float32),
        ba=jnp.asarray([0.01, -0.02, 0.005], jnp.float32),
        bg=jnp.asarray([0.002, 0.001, -0.004], jnp.float32),
        acc_0=jnp.asarray([0.1, 0.2, 9.7], jnp.float32),
        gyr_0=jnp.asarray([0.05, -0.02, 0.01], jnp.float32))
    return js, convert.eskf_state_from_numpy(js)


def _assert_state_close(ts, js, atol=1e-5):
    """`js`: a JAX EskfState or a dict of numpy arrays."""
    get = js.__getitem__ if isinstance(js, dict) else js.__getattribute__
    for name in teskf.EskfState._fields:
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(get(name)),
                                   atol=atol, rtol=0, err_msg=name)


def test_init_state_and_noise_match_jax():
    _assert_state_close(teskf.init_state(), jeskf.init_state(), atol=0)
    np.testing.assert_array_equal(
        teskf.noise_diag_np(0.1, 0.2, 1e-4, 2e-4),
        np.asarray(jeskf.noise_diag(0.1, 0.2, 1e-4, 2e-4)))


def test_predict_steps_match_jax():
    js, ts = _start_state()
    noise_t = torch.as_tensor(NOISE)
    for _ in range(50):
        dt = 0.005
        acc = (np.array([0, 0, 9.81]) + RNG.randn(3) * 0.3).astype(np.float32)
        gyr = (RNG.randn(3) * 0.2).astype(np.float32)
        js = jeskf.predict(js, jnp.asarray(NOISE), dt, acc, gyr)
        ts = teskf.predict(ts, noise_t, dt, acc, gyr)
    _assert_state_close(ts, js, atol=2e-5)


@pytest.mark.parametrize("S,n_valid", [(64, 64), (64, 41), (7, 5)])
def test_predict_sweep_matches_jax_parallel_and_sequential(S, n_valid):
    js, ts = _start_state()
    dts = np.full(S, 0.005, np.float32)
    accs = (np.array([0, 0, 9.81]) + RNG.randn(S, 3) * 0.5).astype(
        np.float32)
    gyrs = (RNG.randn(S, 3) * 0.3).astype(np.float32)
    valid = np.arange(S) < n_valid
    t_rel = np.cumsum(dts).astype(np.float32)
    sweep = (t_rel, dts, accs, gyrs, valid)
    j_args = (js, jnp.asarray(NOISE)) + tuple(jnp.asarray(a) for a in sweep)
    t_args = (ts, torch.as_tensor(NOISE)) + tuple(
        torch.as_tensor(a) for a in sweep)

    t_final, t_tr = teskf.predict_sweep(*t_args)
    for j_final, j_tr in (jeskf.predict_sweep(*j_args),
                          jeskf.predict_sweep_sequential(*j_args)):
        _assert_state_close(t_final, j_final)
        for name in ("p", "v", "un_acc"):
            np.testing.assert_allclose(
                getattr(t_tr, name).numpy()[valid],
                np.asarray(getattr(j_tr, name))[valid], atol=1e-5, rtol=0,
                err_msg=name)
        for name in ("q", "un_gyr"):
            np.testing.assert_allclose(
                getattr(t_tr, name).numpy()[valid],
                np.asarray(getattr(j_tr, name))[valid], atol=2e-6, rtol=0,
                err_msg=name)

    # the port's own sequential chain agrees too (padding is identity)
    s_final, s_tr = teskf.predict_sweep_sequential(*t_args)
    _assert_state_close(t_final, convert.eskf_state_to_numpy(s_final))
    np.testing.assert_allclose(t_tr.p.numpy()[valid],
                               s_tr.p.numpy()[valid], atol=1e-5)


def test_observe_matches_jax():
    js, ts = _start_state()
    d_x = (RNG.randn(17) * 0.05).astype(np.float32)
    _assert_state_close(teskf.observe(ts, torch.as_tensor(d_x)),
                        jeskf.observe(js, jnp.asarray(d_x)))
    new = teskf.observe(ts, torch.as_tensor(d_x))
    assert abs(float(torch.linalg.norm(new.g))
               - float(torch.linalg.norm(ts.g))) < 1e-5


def test_imu_initializer_matches_jax():
    samples = [(0.005 * i,
                np.array([0.02, -0.05, 9.80]) + RNG.randn(3) * 0.01,
                np.array([0.002, 0.001, -0.003]) + RNG.randn(3) * 0.001)
               for i in range(900)]
    ji, ti = jeskf.ImuInitializer(9.81), teskf.ImuInitializer(9.81)
    for (t, a, g) in samples:
        ji.push(t, a, g)
        ti.push(t, a, g)
    assert ti.ready() and ji.ready()
    _assert_state_close(ti.build_state(teskf.init_state()),
                        ji.build_state(jeskf.init_state()), atol=0)

    bad_j, bad_t = jeskf.ImuInitializer(9.81), teskf.ImuInitializer(9.81)
    for i in range(900):
        a, g = RNG.randn(3) * 2.0 + [0, 0, 9.8], RNG.randn(3) * 1.5
        bad_j.push(0.005 * i, a, g)
        bad_t.push(0.005 * i, a, g)
    assert not bad_t.ready() and not bad_j.ready()
