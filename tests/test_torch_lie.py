"""Parity of the port's SO(3)/S2 math (sr_livo_tpu_torch.utils.lie) with
the JAX package's on the same numpy inputs (the cases of test_lie.py).

Both packages evaluate the same closed forms in float32, so every
function agrees to float32 round-off: atol 1e-5 on unit-scale outputs
(rotations, quaternions, Jacobians, tangent vectors), 1e-3 on degrees.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.utils import lie as jlie
from sr_livo_tpu_torch.utils import lie as tlie

RNG = np.random.RandomState(0)
ATOL = 1e-5


def rand_w(n=64, scale=2.0):
    v = RNG.randn(n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * RNG.uniform(0, min(scale, 3.0), size=(n, 1))).astype(
        np.float32)


def rand_q(n=64):
    q = RNG.randn(n, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _both(name, *args):
    """(JAX result, port result) of lie.<name> on numpy args."""
    j = getattr(jlie, name)(*(jnp.asarray(a) for a in args))
    t = getattr(tlie, name)(*(torch.as_tensor(np.array(a)) for a in args))
    return np.asarray(j), t.numpy()


# name -> numpy inputs; each case also covers tiny angles where the
# functions switch to their small-angle branch.
CASES = {
    "skew": lambda: (rand_w(),),
    "vee": lambda: (RNG.randn(16, 3, 3).astype(np.float32),),
    "quat_normalize": lambda: (RNG.randn(16, 4).astype(np.float32),),
    "quat_conj": lambda: (rand_q(),),
    "quat_mul": lambda: (rand_q(), rand_q()),
    "quat_rotate": lambda: (rand_q(), RNG.randn(64, 3).astype(np.float32)),
    "quat_to_rot": lambda: (rand_q(),),
    "rot_to_quat": lambda: (np.asarray(jlie.exp_so3(jnp.asarray(
        rand_w(scale=3.0)))),),
    "exp_so3_quat": lambda: (np.concatenate([rand_w(), rand_w(8, 1e-7)]),),
    "exp_so3": lambda: (np.concatenate([rand_w(), rand_w(8, 1e-7)]),),
    "log_so3": lambda: (np.asarray(jlie.exp_so3(jnp.asarray(
        np.concatenate([rand_w(scale=2.5), rand_w(8, 1e-7)])))),),
    "quat_to_so3": lambda: (rand_q(),),
    "jl_so3": lambda: (np.concatenate([rand_w(scale=1.5),
                                       rand_w(8, 1e-7)]),),
    "jr_so3": lambda: (np.concatenate([rand_w(scale=1.5),
                                       rand_w(8, 1e-7)]),),
    "inv_jl_so3": lambda: (np.concatenate([rand_w(scale=1.5),
                                           rand_w(8, 1e-7)]),),
    "inv_jr_so3": lambda: (np.concatenate([rand_w(scale=1.5),
                                           rand_w(8, 1e-7)]),),
    "s2_bx": lambda: ((RNG.randn(32, 3) * 3 + [0, 0, 5.0]).astype(
        np.float32),),
    "rot_from_v1_to_v2": lambda: (RNG.randn(16, 3).astype(np.float32),
                                  RNG.randn(16, 3).astype(np.float32)),
    "slerp": lambda: (rand_q(16), rand_q(16),
                      RNG.uniform(0, 1, 16).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lie_function_matches_jax(name):
    j, t = _both(name, *CASES[name]())
    assert t.dtype == np.float32 and t.shape == j.shape
    np.testing.assert_allclose(t, j, atol=ATOL, rtol=0)


def test_angular_distance_matches_jax():
    w = np.concatenate([rand_w(), [[0.0, 0.0, np.pi / 6]]]).astype(
        np.float32)
    j, t = _both("angular_distance_deg", w)
    np.testing.assert_allclose(t, j, atol=1e-3, rtol=0)
    assert abs(t[-1] - 30.0) < 1e-3


def test_quat_identity_matches_jax():
    np.testing.assert_array_equal(tlie.quat_identity((3,)).numpy(),
                                  np.asarray(jlie.quat_identity((3,))))


def test_exp_log_roundtrip():
    w = rand_w(scale=1.0)
    back = tlie.log_so3(tlie.exp_so3(torch.as_tensor(w))).numpy()
    np.testing.assert_allclose(back, w, atol=2e-4)
