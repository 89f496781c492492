"""The port's pose graph (sr_livo_tpu_torch.parallel.pose_graph) against
the JAX package's, on the loopy odometry chains of test_ba_posegraph.py.

Both get the same numpy graph; the dense and the PCG solves (6 Gauss-
Newton iterations on a 96-node circle with one loop edge) must agree
with the JAX package's within 1e-4 in q and t (4.8e-07 measured when
this test was written), and the edge residuals and
Jacobians at float32 round-off.
"""
import numpy as np
import pytest
import torch

from sr_livo_tpu.parallel import pose_graph as jpg
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.parallel import pose_graph as tpg
from tests.test_ba_posegraph import _chain_graph
from tests.torch_threads import one_intraop_thread  # noqa: F401

TOL = 1e-4


@pytest.fixture(scope="module")
def graph96():
    return _chain_graph(n=96, drift=0.03, rng=np.random.RandomState(23))[0]


def _max_err(j, t):
    return float(np.abs(np.asarray(j) - t.numpy()).max())


def test_edge_from_poses_and_residuals_match_jax(graph96):
    g = graph96
    tg = convert.pose_graph_from_numpy(g)
    qj, tj = jpg.edge_from_poses(g.q[3], g.t[3], g.q[40], g.t[40])
    qt, tt = tpg.edge_from_poses(tg.q[3], tg.t[3], tg.q[40], tg.t[40])
    assert _max_err(qj, qt) < 1e-6 and _max_err(tj, tt) < 1e-6
    res_t = tpg._edge_residual(tg.q, tg.t, tg.edge_i, tg.edge_j, tg.q_meas,
                               tg.t_meas)
    ji_t, jj_t = tpg._edge_jacobians(tg.q, tg.t, tg.edge_i, tg.edge_j)
    for k in (0, 17, 94, 95):          # 95 is the loop edge
        r = jpg._edge_residual(g.q, g.t, g.edge_i[k], g.edge_j[k],
                               g.q_meas[k], g.t_meas[k])
        ji, jj = jpg._edge_jacobians(g.q, g.t, g.edge_i[k], g.edge_j[k],
                                     g.t_meas[k])
        assert _max_err(r, res_t[k]) < 1e-5
        assert _max_err(ji, ji_t[k]) < 1e-5 and _max_err(jj, jj_t[k]) < 1e-5


@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_solve_matches_jax(graph96, solver):
    jf = getattr(jpg, f"optimize_pose_graph_{solver}")
    tf = getattr(tpg, f"optimize_pose_graph_{solver}")
    qj, tj = jf(graph96, iters=6)
    qt, tt = tf(convert.pose_graph_from_numpy(graph96), iters=6)
    assert _max_err(qj, qt) < TOL and _max_err(tj, tt) < TOL


def test_front_door_routes_and_matches_jax():
    """96 nodes: the front door takes PCG with 144 CG steps; 12 nodes:
    the dense solve.  Both as the JAX package's."""
    for n in (12, 96):
        g = _chain_graph(n=n, drift=0.02, rng=np.random.RandomState(n))[0]
        qj, tj = jpg.optimize_pose_graph(g, iters=4)
        qt, tt = tpg.optimize_pose_graph(convert.pose_graph_from_numpy(g),
                                         iters=4)
        assert _max_err(qj, qt) < TOL and _max_err(tj, tt) < TOL, n


def test_perfect_measurements_stay_fixed():
    g, _, t_gt = _chain_graph(drift=0.0, loop=True,
                              rng=np.random.RandomState(22))
    _, t = tpg.optimize_pose_graph(convert.pose_graph_from_numpy(g), iters=5)
    assert np.allclose(t.numpy(), t_gt, atol=1e-3)


def test_padded_edges_and_nodes_are_inert():
    """Zero-weight (invalid) edges and unconnected identity nodes, as the
    backend pads its graphs, change nothing."""
    g = _chain_graph(n=12, drift=0.02, rng=np.random.RandomState(5))[0]
    base = convert.pose_graph_from_numpy(g)
    n, e = base.q.shape[0], base.edge_i.shape[0]
    pad_n, pad_e = 16, 16
    ident = torch.tensor([[1.0, 0, 0, 0]])
    no_edge = torch.zeros(pad_e - e, dtype=torch.int64)
    padded = tpg.PoseGraph(
        q=torch.cat([base.q, ident.expand(pad_n - n, 4)]),
        t=torch.cat([base.t, torch.zeros(pad_n - n, 3)]),
        edge_i=torch.cat([base.edge_i, no_edge]),
        edge_j=torch.cat([base.edge_j, no_edge]),
        q_meas=torch.cat([base.q_meas, ident.expand(pad_e - e, 4)]),
        t_meas=torch.cat([base.t_meas, torch.zeros(pad_e - e, 3)]),
        rot_w=torch.cat([base.rot_w, torch.zeros(pad_e - e)]),
        t_w=torch.cat([base.t_w, torch.zeros(pad_e - e)]),
        edge_valid=torch.arange(pad_e) < e)
    q0, t0 = tpg.optimize_pose_graph_dense(base, iters=3)
    q1, t1 = tpg.optimize_pose_graph_dense(padded, iters=3)
    assert torch.allclose(t0, t1[:n], atol=1e-5)
    assert torch.allclose(q0, q1[:n], atol=1e-5)
    assert torch.equal(t1[n:], torch.zeros(pad_n - n, 3))
