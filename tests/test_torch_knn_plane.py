"""Parity of the port's fused kNN + plane dispatchers
(sr_livo_tpu_torch.ops.plane_fit.knn_plane_assoc / knn_plane_rows) on CPU
tensors, where they run the plain kNN and plane fit, with the JAX
package's association (`models/lio.py::chunked_assoc`) and residual
construction (`models/lio.py::build_residuals`, uncapped).

Both packages see the same 2^12-slot map (built by the JAX package's
`insert` from a numpy seed, carried over with `convert`) and the same
keypoints.  The association is compared on the valid prefix: neighbour
counts and closest neighbours exactly, a2d within 2e-4, and the sign-free
normal within 2e-3 on rows with at least 3 neighbours (with two, every
direction across their line is a normal).  The rows are held to the
tolerances of test_pallas_plane.py: `good` agrees on more than 99.5% of
rows and, on rows good in both, h within 2e-4 and h_x within 2e-3.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sr_livo_tpu.ops.pallas.plane_fit as jpf
from sr_livo_tpu.models import lio as jlio
from sr_livo_tpu.ops import voxel_map as jvm
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.utils import lie as tlie

Q = 1024
SEARCH = dict(voxel_size=1.0, max_neighbors=20, max_probe=8)
ATOL_H = 2e-4
ATOL_HX = 2e-3
GOOD_AGREE = 0.995


@pytest.fixture(scope="module")
def scene():
    """A floor and two walls with 1 cm of noise plus scattered points, in
    a 2^12-slot map of 20-point blocks, and keypoints near them."""
    rng = np.random.RandomState(17)
    u = rng.uniform(-7, 7, (3000, 2))
    pts = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(3000)],
        np.c_[np.full(3000, 6.5), u[:, 0], u[:, 1] * 0.4 + 3],
        np.c_[u[:, 0], np.full(3000, -6.5), u[:, 1] * 0.4 + 3]])
    pts = np.concatenate([pts + rng.randn(*pts.shape) * 0.01,
                          rng.uniform(-7, 7, (800, 3))]).astype(np.float32)
    jm = jvm.make_map(1 << 12, 20)
    for i in range(0, len(pts), 4096):
        c = pts[i:i + 4096]
        jm, _ = jvm.insert(jm, jnp.asarray(c), jnp.ones(len(c), bool), 1.0,
                           0.05, 8)
    world = (pts[rng.choice(len(pts), Q)]
             + rng.randn(Q, 3) * 0.05).astype(np.float32)
    return jm, convert.voxel_map_from_numpy(jm), world


@pytest.mark.parametrize("n_valid,nb_voxels,threshold", [
    (300, 1, 1), (700, 1, 1), (Q, 1, 1), (700, 2, 5)])
def test_knn_plane_assoc_matches_chunked_assoc(scene, n_valid, nb_voxels,
                                               threshold):
    jm, tm, world = scene
    kw = dict(SEARCH, nb_voxels=nb_voxels)
    jn, ja, jc, jf = (np.asarray(a) for a in jlio.chunked_assoc(
        jm, jnp.asarray(world), jnp.int32(n_valid),
        threshold_capacity=jnp.int32(threshold), chunk=512, **kw))
    before = dict(plane_fit.launches)
    tn, ta, tc, tf = (a.numpy() for a in plane_fit.knn_plane_assoc(
        tm, torch.as_tensor(world), torch.arange(Q) < n_valid,
        torch.tensor(threshold, dtype=torch.int32), chunk=512, **kw))
    assert plane_fit.launches == before           # CPU: the plain version
    v = slice(0, n_valid)
    np.testing.assert_array_equal(tf[v], jf[v])
    assert tf[v].max() == 20 and tf[v].min() < 20
    np.testing.assert_array_equal(tc[v], jc[v])
    np.testing.assert_allclose(ta[v], ja[v], atol=ATOL_H, rtol=0)
    plane = (np.arange(Q) < n_valid) & (tf >= 3)
    sign = np.where((tn * jn).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose((tn * sign)[plane], jn[plane], atol=ATOL_HX,
                               rtol=0)


@pytest.mark.parametrize("use_pallas,nb_voxels,threshold", [
    (False, 1, 1), (False, 2, 1), (False, 1, 5), (False, 2, 5),
    (True, 1, 1), (True, 2, 5)])
def test_knn_plane_rows_matches_build_residuals(scene, monkeypatch,
                                                use_pallas, nb_voxels,
                                                threshold):
    jm, tm, world = scene
    keypts = world[:600]
    valid = np.arange(600) < 520
    q = tlie.exp_so3_quat(torch.tensor([0.01, -0.02, 0.015]))
    t = torch.tensor([0.05, -0.03, 0.02])
    last_trans = np.array([0.3, -0.2, 1.0], np.float32)
    icp = dict(size_voxel_map=1.0, nb_voxels_visited=nb_voxels,
               max_number_neighbors=20, min_number_neighbors=12,
               power_planarity=2.0, max_dist_to_plane=0.3, weight_alpha=0.9,
               weight_neighborhood=0.1, max_num_residuals=0, max_probe=8)
    if use_pallas:
        monkeypatch.setattr(jpf, "plane_residuals_pallas", functools.partial(
            jpf.plane_residuals_pallas, interpret=True))
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    j = jlio.build_residuals(
        jm, jnp.asarray(keypts), jnp.asarray(valid), jnp.asarray(q.numpy()),
        jnp.asarray(t.numpy()), jnp.asarray(last_trans), jnp.asarray(eye),
        jnp.asarray(zero), threshold_voxel_capacity=jnp.int32(threshold),
        use_pallas=use_pallas, **icp)
    jhx, jh, jgood = (np.asarray(a) for a in (j.h_x, j.h, j.valid))

    location = torch.as_tensor(keypts)
    world_t = tlie.quat_rotate(q.expand(600, 4), location) + t
    thx, th, tgood = (a.numpy() for a in plane_fit.knn_plane_rows(
        tm, world_t, location, tlie.quat_to_rot(q),
        torch.as_tensor(last_trans), torch.as_tensor(valid),
        torch.tensor(threshold, dtype=torch.int32), voxel_size=1.0,
        max_neighbors=20, max_probe=8, nb_voxels=nb_voxels, lam_w=0.9,
        lam_nb=0.1, power_planarity=2.0, max_dist=0.3, min_neighbors=12))
    assert (tgood == jgood).mean() > GOOD_AGREE
    both = tgood & jgood
    assert both.sum() > 150
    np.testing.assert_allclose(th[both], jh[both], atol=ATOL_H, rtol=0)
    np.testing.assert_allclose(thx[both], jhx[both], atol=ATOL_HX, rtol=0)
    assert not tgood[~valid].any()
