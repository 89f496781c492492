"""The port's loop closure (sr_livo_tpu_torch.parallel.loop_closure)
against the JAX package's, on the scenes of test_distributed_loop.py.

`find_candidates` (an own numpy copy) must give identical pairs.
`verify_closure` gets the same scans and poses in both packages.  Against
the JAX function run op by op (`jax.disable_jit()`): q_meas and t_meas
within 1e-4, the fitness within one inlier, the translation observability
within 1e-4.  Against the compiled JAX function the thresholded decisions
(fitness >= 0.6, t_observability >= 0.15, the backend's defaults) must be
the same and q_meas, t_meas within 1e-3: XLA fuses the point transform
into fused multiply-adds, which moves world points by an ulp; that can
change the 10th-nearest neighbour of a row and so its plane, and a few
rows then cross the 0.2 m inlier gate (on the revisit scene, when this
test was written: fitness 0.985348 against 0.989011 and t_observability
0.406780 against 0.416008, while the port and the op-by-op JAX function
gave the same values to 6 digits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.parallel import loop_closure as jlc
from sr_livo_tpu.utils import lie as jlie
from sr_livo_tpu_torch.parallel import loop_closure as tlc
from tests.torch_threads import one_intraop_thread  # noqa: F401

TOL = 1e-4


@pytest.mark.parametrize("case", ["circle", "line", "lissajous"])
def test_find_candidates_identical(case):
    t = np.linspace(0, 2 * np.pi, 60)
    if case == "circle":
        pos, kw = np.c_[3 * np.cos(t), 3 * np.sin(t), 0 * t], dict(
            radius=1.0, min_gap=20)
    elif case == "line":
        pos, kw = np.c_[np.linspace(0, 50, 60), 0 * t, 0 * t], dict(
            radius=1.0, min_gap=10)
    else:
        rng = np.random.RandomState(3)
        pos = np.c_[2 * np.sin(3 * t), 2 * np.sin(2 * t + 0.6),
                    0.1 * rng.randn(60)]
        kw = dict(radius=2.0, min_gap=20, max_pairs=8)
    got = tlc.find_candidates(pos.astype(np.float32), **kw)
    assert got == jlc.find_candidates(pos.astype(np.float32), **kw)
    if case != "line":
        assert got


def _scan(world, pose_q, pose_t, rng, n=800):
    sel = rng.choice(world.shape[0], n, replace=False)
    r = np.asarray(jlie.quat_to_rot(jnp.asarray(pose_q, jnp.float32)))
    return ((world[sel] - pose_t) @ r).astype(np.float32)


def _revisit(rng):
    """test_distributed_loop.py's true revisit: a floor and two walls, the
    query pose 0.35 m and 4 degrees off."""
    u = rng.uniform(-6, 6, (8000, 2))
    world = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(8000)],
        np.c_[np.full(8000, 6.0), u[:, 0], u[:, 1] * 0.3 + 1.5],
        np.c_[u[:, 0], np.full(8000, 6.0), u[:, 1] * 0.3 + 1.5],
    ]).astype(np.float32)
    q_i = np.asarray(jlie.exp_so3_quat(jnp.asarray([0, 0, 0.3], jnp.float32)))
    t_i = np.array([0.5, -0.3, 1.0], np.float32)
    q_j = np.asarray(jlie.exp_so3_quat(jnp.asarray([0, 0, 0.5], jnp.float32)))
    t_j = np.array([1.0, 0.4, 1.1], np.float32)
    scan_i = _scan(world, q_i, t_i, rng)
    scan_j = _scan(world, q_j, t_j, rng)
    q_j0 = np.asarray(jlie.quat_mul(jnp.asarray(q_j), jlie.exp_so3_quat(
        jnp.asarray([0.02, -0.03, 0.05], jnp.float32))))
    t_j0 = t_j + np.array([0.25, -0.2, 0.1], np.float32)
    valid_j = np.ones(len(scan_j), bool)
    valid_j[700:] = False                 # a padded tail, as in a keyframe
    return (scan_i, np.ones(len(scan_i), bool), scan_j, valid_j,
            q_i, t_i, q_j0, t_j0)


def _wrong_place(rng):
    u = rng.uniform(-6, 6, (6000, 2))
    world = np.c_[u[:, 0], u[:, 1], np.abs(np.sin(u[:, 0]))].astype(np.float32)
    fake = np.c_[u[:, 0], u[:, 1],
                 2.0 + 0.8 * np.sin(3 * u[:, 1])].astype(np.float32)
    q = np.array([1, 0, 0, 0], np.float32)
    t = np.array([0, 0, 1.0], np.float32)
    scan_i = _scan(world, q, t, rng)
    scan_j = _scan(fake, q, t, rng)
    ones = np.ones(len(scan_i), bool)
    return scan_i, ones, scan_j, ones.copy(), q, t, q, t


def _scene(name):
    rng = np.random.RandomState(11 if name == "revisit" else 12)
    return (_revisit if name == "revisit" else _wrong_place)(rng)


def _accepts(res) -> bool:
    return (float(res.fitness) >= 0.6
            and float(res.t_observability) >= 0.15)


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a) - b.numpy()).max())


@pytest.mark.parametrize("scene", ["revisit", "wrong_place"])
def test_verify_closure_matches_jax_op_by_op(scene):
    args = _scene(scene)
    with jax.disable_jit():
        rj = jlc.verify_closure(*(jnp.asarray(a) for a in args))
    rt = tlc.verify_closure(*(torch.as_tensor(np.array(a)) for a in args))
    assert _gap(rj.q_meas, rt.q_meas) < TOL
    assert _gap(rj.t_meas, rt.t_meas) < TOL
    # the fitness denominator is the usable rows (at least 6 neighbours)
    assert abs(float(rj.fitness) - float(rt.fitness)) * len(args[2]) <= 1.0
    assert abs(float(rj.t_observability)
               - float(rt.t_observability)) < TOL
    assert abs(float(rj.mean_residual) - float(rt.mean_residual)) < TOL
    assert _accepts(rj) == _accepts(rt) == (scene == "revisit")


@pytest.mark.parametrize("scene", ["revisit", "wrong_place"])
def test_verify_closure_decisions_match_compiled_jax(scene):
    args = _scene(scene)
    rj = jlc.verify_closure(*(jnp.asarray(a) for a in args))
    rt = tlc.verify_closure(*(torch.as_tensor(np.array(a)) for a in args))
    assert _accepts(rj) == _accepts(rt) == (scene == "revisit")
    if scene == "revisit":
        assert _gap(rj.q_meas, rt.q_meas) < 1e-3
        assert _gap(rj.t_meas, rt.t_meas) < 1e-3
