"""Parity of the port's iterated ESIKF (sr_livo_tpu_torch.models.lio) with
the JAX package's, on the three-plane map of test_pallas_plane.py.

Both packages start from the same filter state and the same map (built by
the JAX package and carried over with `convert`).  The IEKF's integer
outcome (iterations, residual count, success) must be equal; the solved
pose agrees to float32 round-off (1e-5 m on the position, 1e-6 on the
unit quaternion, 1e-5 relative on the covariance, after a few iterations
of 17x17 inverses), and lands within 0.02 m of the true origin.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_livo_tpu.ops.pallas.plane_fit as jpf
from sr_livo_tpu.models import eskf as jeskf
from sr_livo_tpu.models import lio as jlio
from sr_livo_tpu.ops import voxel_map as jvm
from sr_livo_tpu.utils import lie as jlie
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.models import lio as tlio
from sr_livo_tpu_torch.ops import voxel_map as tvm
from sr_livo_tpu_torch.ops import plane_fit

RNG = np.random.RandomState(23)
N_KEY, N_VALID = 400, 350

ICP = dict(size_voxel_map=1.0, nb_voxels_visited=1, max_number_neighbors=20,
           min_number_neighbors=12, power_planarity=2.0,
           max_dist_to_plane=0.3, weight_alpha=0.9, weight_neighborhood=0.1,
           max_num_residuals=600, max_probe=16, max_iters=8,
           threshold_translation_norm=1e-3, threshold_orientation_norm=1e-2,
           laser_point_cov=0.001)


@pytest.fixture(scope="module")
def scene():
    """Floor and two walls in a 1 m-voxel map, keypoints drawn from them
    (valid as a prefix, like voxel_subsample's output), and a start state
    perturbed from the origin."""
    u = RNG.uniform(-6, 6, (4000, 2))
    world = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(4000)],
        np.c_[np.full(4000, 6.0), u[:, 0], u[:, 1] * 0.5 + 3],
        np.c_[u[:, 0], np.full(4000, 6.0), u[:, 1] * 0.5 + 3],
    ]).astype(np.float32)
    m = jvm.make_map(1 << 14, 20)
    for i in range(0, world.shape[0], 4096):
        c = world[i:i + 4096]
        m, _ = jvm.insert(m, jnp.asarray(c), jnp.ones(len(c), bool),
                          1.0, 0.05, 16)
    keypts = world[RNG.choice(len(world), N_KEY, replace=False)]
    valid = np.arange(N_KEY) < N_VALID
    st = jeskf.init_state()._replace(
        p=jnp.asarray([0.15, -0.1, 0.08], jnp.float32),
        q=jlie.exp_so3_quat(jnp.asarray([0.02, -0.02, 0.02], jnp.float32)))
    seed_p = np.array([0.1, -0.05, 0.05], np.float32)
    seed_q = np.array(jlie.exp_so3_quat(
        jnp.asarray([0.01, -0.01, 0.015], jnp.float32)))
    return m, keypts, valid, st, seed_q, seed_p


CASES = {
    "rows_jnp": dict(cache_association=False),
    "rows_pallas_interpret": dict(cache_association=False, use_pallas=True),
    "assoc": dict(cache_association=True),
    "assoc_chunked": dict(cache_association=True, query_chunk=128),
    "assoc_chunked_seeded": dict(cache_association=True, query_chunk=128,
                                 seeded=True),
}


def _run_jax(scene, case, monkeypatch):
    m, keypts, valid, st, seed_q, seed_p = scene
    kw = dict(CASES[case])
    if kw.pop("seeded", False):
        kw.update(seed_q=jnp.asarray(seed_q), seed_p=jnp.asarray(seed_p))
    if kw.get("use_pallas"):
        monkeypatch.setattr(jpf, "plane_residuals_pallas", functools.partial(
            jpf.plane_residuals_pallas, interpret=True))
    return jlio.iekf_update(
        st, m, jnp.asarray(keypts), jnp.asarray(valid),
        jnp.zeros(3, jnp.float32), jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.float32), jnp.int32(1), **ICP, **kw)


def _run_torch(scene, case):
    m, keypts, valid, st, seed_q, seed_p = scene
    kw = dict(CASES[case])
    kw.pop("use_pallas", None)
    if kw.pop("seeded", False):
        kw.update(seed_q=torch.as_tensor(seed_q), seed_p=torch.as_tensor(seed_p))
    return tlio.iekf_update(
        convert.eskf_state_from_numpy(st), convert.voxel_map_from_numpy(m),
        torch.as_tensor(keypts), torch.as_tensor(valid), torch.zeros(3),
        torch.eye(3), torch.zeros(3), torch.tensor(1, dtype=torch.int32),
        **ICP, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_iekf_update_matches_jax(scene, case, monkeypatch):
    j_out, j_sum = _run_jax(scene, case, monkeypatch)
    before = dict(plane_fit.launches)
    t_out, t_sum = _run_torch(scene, case)
    assert plane_fit.launches == before           # CPU: the plain version

    assert bool(t_sum.success) and bool(j_sum.success)
    assert int(t_sum.iterations) == int(j_sum.iterations)
    assert int(t_sum.num_residuals) == int(j_sum.num_residuals) > 100
    np.testing.assert_allclose(t_out.p.numpy(), np.asarray(j_out.p),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_out.q.numpy(), np.asarray(j_out.q),
                               atol=1e-6, rtol=0)
    j_cov = np.asarray(j_out.cov)
    np.testing.assert_allclose(t_out.cov.numpy(), j_cov, rtol=0,
                               atol=1e-5 * np.abs(j_cov).max())
    assert float(torch.linalg.norm(t_out.p)) < 0.02


def test_cap_residuals_prefix_matches_jax():
    good = RNG.rand(700) < 0.8
    h_x = RNG.randn(700, 6).astype(np.float32)
    h = RNG.randn(700).astype(np.float32)
    j = jlio._cap_residuals(jnp.asarray(h_x), jnp.asarray(h),
                            jnp.asarray(good), 300)
    t = tlio._cap_residuals(torch.as_tensor(h_x), torch.as_tensor(h),
                            torch.as_tensor(good), 300)
    for name in tlio.ResidualBatch._fields:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert int(t.num) == 300



@pytest.fixture(scope="module")
def noisy_scene():
    """The scene's floor and walls with 1 cm of noise (exactly planar
    neighbourhoods leave a2d to float32 rounding), in a 2^12-slot map built
    by the port's insert (bit for bit the JAX package's), as numpy."""
    rng = np.random.RandomState(29)
    u = rng.uniform(-6, 6, (3000, 2))
    world = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(3000)],
        np.c_[np.full(3000, 6.0), u[:, 0], u[:, 1] * 0.5 + 3],
        np.c_[u[:, 0], np.full(3000, 6.0), u[:, 1] * 0.5 + 3]])
    world = (world + rng.randn(*world.shape) * 0.01).astype(np.float32)
    m = tvm.make_map(1 << 12, 20)
    tvm.insert(m, torch.as_tensor(world), torch.ones(len(world), dtype=bool),
               1.0, 0.05, 16)
    keypts = (world[rng.choice(len(world), N_KEY, replace=False)]
              + rng.randn(N_KEY, 3) * 0.05).astype(np.float32)
    return convert.voxel_map_to_numpy(m), keypts


@pytest.mark.parametrize("n_valid,chunk,nb_voxels", [
    (N_VALID, 128, 1), (N_VALID, 128, 2), (0, 128, 1), (N_KEY, 64, 1),
    (N_VALID, 4096, 1)])
def test_chunked_assoc_matches_jax(noisy_scene, n_valid, chunk, nb_voxels):
    """The association over the valid prefix only: neighbour counts and
    closest neighbours exactly and zero rows past the chunks, a2d within
    2e-4 and the sign-free normal within 2e-3 on rows with at least 3
    neighbours (the tolerances of tests/test_torch_knn_plane.py)."""
    m, keypts = noisy_scene
    kw = dict(voxel_size=1.0, max_neighbors=20, max_probe=16,
              nb_voxels=nb_voxels, chunk=chunk)
    jn, ja, jc, jf = (np.asarray(a) for a in jlio.chunked_assoc(
        jvm.VoxelMap(**{k: jnp.asarray(v) for k, v in m.items()}),
        jnp.asarray(keypts), jnp.int32(n_valid),
        threshold_capacity=jnp.int32(1), **kw))
    before = dict(plane_fit.launches)
    tn, ta, tc, tf = (a.numpy() for a in tlio.chunked_assoc(
        convert.voxel_map_from_numpy(m), torch.as_tensor(keypts),
        torch.tensor(n_valid), threshold_capacity=torch.tensor(
            1, dtype=torch.int32), **kw))
    assert plane_fit.launches == before           # CPU: the plain version
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(ta, ja, atol=2e-4, rtol=0)
    plane = tf >= 3
    sign = np.where((tn * jn).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose((tn * sign)[plane], jn[plane], atol=2e-3,
                               rtol=0)
    if chunk < N_KEY:    # rows past the last chunk are not searched
        end = -(-n_valid // chunk) * chunk
        assert not tf[end:].any() and not tc[end:].any()
    assert (tf[:n_valid] >= 12).sum() >= 0.8 * n_valid
