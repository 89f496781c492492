"""The port's windowed BA (sr_livo_tpu_torch.parallel.ba) against the JAX
package's, on the three-wall world of test_ba_posegraph.py.

The map is built by the JAX package and converted, the window (4
keyframes of 256 body-frame points, poses perturbed by 8 cm) is the same
numpy input for both.  The refined q and t must agree with the JAX
package's within 1e-4, the per-keyframe normal-equation blocks within
1e-4 of their largest entry (their 256-row sums round differently: the
JAX package's lie farther from a float64 evaluation than the port's),
and the port's BA must
recover the true poses as the JAX test asks (2 cm, 0.5 degrees).  The
association goes through the plane kernel's entry `knn_plane_assoc` (its
plain version here) with an all-true mask: the window's padded rows, zero
points with `pt_valid` False, must not change the result.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.ops import voxel_map as jvm
from sr_livo_tpu.parallel import ba as jba
from sr_livo_tpu.parallel import pose_graph as jpg
from sr_livo_tpu.utils import lie as jlie
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.parallel import ba as tba
from sr_livo_tpu_torch.utils import lie
from tests.torch_threads import one_intraop_thread  # noqa: F401

TOL = 1e-4


def _world_and_map(rng, cap=1 << 14):
    """test_ba_posegraph.py's world: a floor and two walls, 27000 points,
    in a 2^14 x 20 map at 1.0 m voxels."""
    u = rng.uniform(-8, 8, (9000, 2))
    world = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(9000)],
        np.c_[np.full(9000, 8.0), u[:, 0], u[:, 1] * 0.25 + 1.5],
        np.c_[u[:, 0], np.full(9000, 8.0), u[:, 1] * 0.25 + 1.5],
    ]).astype(np.float32)
    m = jvm.make_map(cap, 20)
    for i in range(0, world.shape[0], 4096):
        c = world[i:i + 4096]
        m, _ = jvm.insert(m, jnp.asarray(c), jnp.ones(len(c), bool),
                          1.0, 0.05, 16)
    return world, m


def _window(world, rng, K=4, N=256, perturb=0.08, n_valid=None):
    """K keyframes along a line observing N map points each, poses
    perturbed (keyframe 0 is the gauge); with `n_valid`, each keyframe's
    rows past n_valid[k] are zero padding, as the backend pads them."""
    q_gt, t_gt, pts, valid = [], [], [], []
    for k in range(K):
        t_k = np.array([0.5 * k, 0.2 * k, 1.0])
        w_k = np.array([0.0, 0.0, 0.05 * k], np.float32)
        r_k = np.asarray(jlie.exp_so3(jnp.asarray(w_k)))
        sel = rng.choice(world.shape[0], N, replace=False)
        body = ((world[sel] - t_k) @ r_k).astype(np.float32)
        ok = np.ones(N, bool)
        if n_valid is not None:
            body[n_valid[k]:] = 0.0
            ok[n_valid[k]:] = False
        q_gt.append(np.asarray(jlie.exp_so3_quat(jnp.asarray(w_k))))
        t_gt.append(t_k)
        pts.append(body)
        valid.append(ok)
    q_gt = np.stack(q_gt).astype(np.float32)
    t_gt = np.stack(t_gt).astype(np.float32)
    q_odo, t_odo = [], []
    for k in range(K - 1):
        qr, tr = jpg.edge_from_poses(q_gt[k], t_gt[k], q_gt[k + 1],
                                     t_gt[k + 1])
        q_odo.append(np.asarray(qr))
        t_odo.append(np.asarray(tr))
    q0, t0 = q_gt.copy(), t_gt.copy()
    for k in range(1, K):
        dw = (rng.randn(3) * perturb * 0.3).astype(np.float32)
        q0[k] = np.asarray(jlie.quat_mul(q0[k], jlie.exp_so3_quat(dw)))
        t0[k] = t0[k] + rng.randn(3) * perturb
    window = dict(q=q0, t=t0, points=np.stack(pts), pt_valid=np.stack(valid),
                  kf_valid=np.ones(K, bool))
    return window, np.stack(q_odo), np.stack(t_odo), q_gt, t_gt


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(17)
    world, jmap = _world_and_map(rng)
    return world, jmap, convert.voxel_map_from_numpy(jmap), rng


def _run_both(jmap, tmap, window, q_odo, t_odo, iters):
    kw = dict(voxel_size=1.0, min_neighbors=8, iters=iters)
    jw = jba.KeyframeWindow(**{k: jnp.asarray(v) for k, v in window.items()})
    qj, tj = jba.windowed_ba(jmap, jw, jnp.asarray(q_odo), jnp.asarray(t_odo),
                             **kw)
    plane_fit.reset_launches()
    qt, tt = tba.windowed_ba(tmap, convert.keyframe_window_from_numpy(window),
                             torch.as_tensor(q_odo), torch.as_tensor(t_odo),
                             **kw)
    return np.asarray(qj), np.asarray(tj), qt.numpy(), tt.numpy()


def test_windowed_ba_matches_jax_and_recovers_poses(scene):
    world, jmap, tmap, rng = scene
    window, q_odo, t_odo, q_gt, t_gt = _window(world, rng)
    qj, tj, qt, tt = _run_both(jmap, tmap, window, q_odo, t_odo, iters=4)
    assert np.abs(qj - qt).max() < TOL and np.abs(tj - tt).max() < TOL
    assert np.linalg.norm(tt - t_gt, axis=-1).max() < 0.02
    for k in range(4):
        dq = lie.quat_mul(lie.quat_conj(torch.as_tensor(q_gt[k])),
                          torch.as_tensor(qt[k]))
        assert float(lie.angular_distance_deg(lie.quat_to_so3(dq))) < 0.5


def test_windowed_ba_with_padded_rows_matches_jax(scene):
    """The backend's layout: each keyframe's valid rows are a prefix of its
    own rows, the rest zero padding (2 Gauss-Newton iterations as the
    backend runs them)."""
    world, jmap, tmap, rng = scene
    window, q_odo, t_odo, _, _ = _window(world, rng,
                                         n_valid=[256, 180, 97, 230])
    qj, tj, qt, tt = _run_both(jmap, tmap, window, q_odo, t_odo, iters=2)
    assert np.abs(qj - qt).max() < TOL and np.abs(tj - tt).max() < TOL


def test_residual_blocks_match_jax(scene):
    world, jmap, tmap, rng = scene
    window, _, _, _, _ = _window(world, rng, n_valid=[256, 200, 256, 120])
    tw = convert.keyframe_window_from_numpy(window)
    kw = dict(voxel_size=1.0, max_neighbors=20, min_neighbors=8,
              max_probe=16, max_dist=0.5)
    h_t, b_t, n_t, loss_t = tba._plane_residual_blocks(
        tmap, tw.q, tw.t, tw.points, tw.pt_valid, **kw)
    for k in range(4):
        h, b, n, loss = jba._plane_residual_blocks(
            jmap, jnp.asarray(window["q"][k]), jnp.asarray(window["t"][k]),
            jnp.asarray(window["points"][k]),
            jnp.asarray(window["pt_valid"][k]), **kw)
        assert int(n) == int(n_t[k]) > 50
        scale = float(np.abs(np.asarray(h)).max())
        assert np.abs(np.asarray(h) - h_t[k].numpy()).max() < 1e-4 * scale
        scale = float(np.abs(np.asarray(b)).max())
        assert np.abs(np.asarray(b) - b_t[k].numpy()).max() < 1e-4 * scale
        assert abs(float(loss) - float(loss_t[k])) < 1e-4 * float(loss)
