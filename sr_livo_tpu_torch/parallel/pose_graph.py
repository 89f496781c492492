"""Pose-graph optimization over keyframe poses (port of
`sr_livo_tpu/parallel/pose_graph.py`).

Nodes are SE(3) keyframe poses, edges relative-pose constraints
(sequential odometry and loop closures).  Batched Gauss-Newton: every edge
residual and Jacobian is one batched tensor expression over the edge list;
the normal system is assembled by accumulating index writes and solved
densely (small graphs) or matrix-free by preconditioned CG (large ones).
Node 0 is gauge-fixed.  Solves use `solve_ex` / `inv_ex`, which never read
a status back to the host.  On CUDA the accumulations use atomics, so the
sums are not bitwise repeatable there.  `optimize_pose_graph_program` runs
a solve as one Gauss-Newton iteration's captured program, replayed
`iters` times.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sr_livo_tpu_torch.utils import graphs, lie


class PoseGraph(NamedTuple):
    q: torch.Tensor           # (N, 4) node rotations (world_from_body)
    t: torch.Tensor           # (N, 3)
    edge_i: torch.Tensor      # (E,) int64 source node
    edge_j: torch.Tensor      # (E,) int64 target node
    q_meas: torch.Tensor      # (E, 4) measured q_i^-1 q_j
    t_meas: torch.Tensor      # (E, 3) measured R_i^T (t_j - t_i)
    rot_w: torch.Tensor       # (E,) rotation information weight
    t_w: torch.Tensor         # (E,) translation information weight
    edge_valid: torch.Tensor  # (E,) bool


def edge_from_poses(q_i, t_i, q_j, t_j):
    """The relative measurement (q_meas, t_meas) between two poses."""
    q_rel = lie.quat_normalize(lie.quat_mul(lie.quat_conj(q_i), q_j))
    t_rel = lie.quat_rotate(lie.quat_conj(q_i), t_j - t_i)
    return q_rel, t_rel


def _edge_residual(q, t, e_i, e_j, q_meas, t_meas):
    """r = [log(R_meas^T R_i^T R_j), R_i^T (t_j - t_i) - t_meas]: (..., 6)
    for edge indices of any batch shape."""
    q_i, q_j = q[e_i], q[e_j]
    t_i, t_j = t[e_i], t[e_j]
    r_rel = lie.quat_to_rot(lie.quat_mul(lie.quat_conj(q_i), q_j))
    r_meas = lie.quat_to_rot(q_meas)
    r_rot = lie.log_so3(r_meas.transpose(-1, -2) @ r_rel)
    r_t = lie.quat_rotate(lie.quat_conj(q_i), t_j - t_i) - t_meas
    return torch.cat([r_rot, r_t], dim=-1)


def _edge_jacobians(q, t, e_i, e_j):
    """First-order Jacobians (..., 6, 6) of the edge residual with respect
    to the two nodes' [dtheta, dt] (right perturbations)."""
    q_i, q_j = q[e_i], q[e_j]
    t_i, t_j = t[e_i], t[e_j]
    r_i = lie.quat_to_rot(q_i)
    r_rel = lie.quat_to_rot(lie.quat_mul(lie.quat_conj(q_i), q_j))
    dt_local = lie.quat_rotate(lie.quat_conj(q_i), t_j - t_i)
    shape = r_i.shape[:-2] + (6, 6)
    ji = torch.zeros(shape, dtype=q.dtype, device=q.device)
    jj = torch.zeros(shape, dtype=q.dtype, device=q.device)
    # rotation: d r_rot/d th_j ~ I, d r_rot/d th_i ~ -R_rel^T
    ji[..., 0:3, 0:3] = -r_rel.transpose(-1, -2)
    jj[..., 0:3, 0:3] = torch.eye(3, dtype=q.dtype, device=q.device)
    # translation: d/d t_j = R_i^T, d/d t_i = -R_i^T,
    # d/d th_i = [R_i^T (t_j - t_i)]x
    ji[..., 3:6, 3:6] = -r_i.transpose(-1, -2)
    jj[..., 3:6, 3:6] = r_i.transpose(-1, -2)
    ji[..., 3:6, 0:3] = lie.skew(dt_local)
    return ji, jj


def _edge_weights(graph: PoseGraph) -> torch.Tensor:
    """(E, 6) residual weights, zero on padded edges."""
    w = torch.cat([graph.rot_w[:, None].expand(-1, 3),
                   graph.t_w[:, None].expand(-1, 3)], dim=1)
    return torch.where(graph.edge_valid[:, None], w, torch.zeros_like(w))


def _retract(q, t, dx):
    q_new = lie.quat_normalize(lie.quat_mul(q, lie.exp_so3_quat(dx[:, 0:3])))
    return q_new, t + dx[:, 3:6]


def _linearize(graph: PoseGraph, q, t):
    res = _edge_residual(q, t, graph.edge_i, graph.edge_j, graph.q_meas,
                         graph.t_meas)                             # (E, 6)
    ji, jj = _edge_jacobians(q, t, graph.edge_i, graph.edge_j)    # (E, 6, 6)
    return res, ji, jj, _edge_weights(graph)


def _dense_iteration(graph: PoseGraph, q, t, damping: float):
    """One Gauss-Newton iteration with a dense (6N, 6N) solve (of the
    graph's edges from the poses q, t)."""
    n = q.shape[0]
    dim = 6 * n
    f = dict(dtype=q.dtype, device=q.device)
    e_i, e_j = graph.edge_i, graph.edge_j
    res, ji, jj, w = _linearize(graph, q, t)
    ji_w = ji * w[:, :, None]
    jj_w = jj * w[:, :, None]
    h_ii = torch.einsum("eki,ekj->eij", ji_w, ji)
    h_jj = torch.einsum("eki,ekj->eij", jj_w, jj)
    h_ij = torch.einsum("eki,ekj->eij", ji_w, jj)
    b_i = torch.einsum("eki,ek->ei", ji_w, res)
    b_j = torch.einsum("eki,ek->ei", jj_w, res)

    H = torch.zeros((n, n, 6, 6), **f)
    H.index_put_((e_i, e_i), h_ii, accumulate=True)
    H.index_put_((e_j, e_j), h_jj, accumulate=True)
    H.index_put_((e_i, e_j), h_ij, accumulate=True)
    H.index_put_((e_j, e_i), h_ij.transpose(-1, -2), accumulate=True)
    b = torch.zeros((n, 6), **f)
    graphs.scatter_sum(b, e_i, b_i)
    graphs.scatter_sum(b, e_j, b_j)

    H_full = H.permute(0, 2, 1, 3).reshape(dim, dim)
    # gauge fix node 0 + damping
    gauge = torch.zeros((dim, dim), **f)
    gauge[0:6, 0:6] = torch.eye(6, **f) * 1e8
    H_full = (H_full + gauge) + torch.eye(dim, **f) * damping
    dx = -torch.linalg.solve_ex(H_full, b.reshape(dim)).result
    return _retract(q, t, dx.reshape(n, 6))


def _pcg_iteration(graph: PoseGraph, q, t, damping: float, cg_iters: int):
    """One Gauss-Newton iteration with exactly `cg_iters` steps of a
    matrix-free, block-Jacobi preconditioned CG."""
    n = q.shape[0]
    f = dict(dtype=q.dtype, device=q.device)
    e_i, e_j = graph.edge_i, graph.edge_j
    eye6 = torch.eye(6, **f)
    gauge = torch.zeros((n, 1), **f)
    gauge[0] = 1e8
    res, ji, jj, w = _linearize(graph, q, t)

    def matvec(x):                                       # x (n, 6)
        rx = (torch.einsum("eij,ej->ei", ji, x[e_i])
              + torch.einsum("eij,ej->ei", jj, x[e_j])) * w
        y = torch.zeros((n, 6), **f)
        graphs.scatter_sum(y, e_i, torch.einsum("eij,ei->ej", ji, rx))
        graphs.scatter_sum(y, e_j, torch.einsum("eij,ei->ej", jj, rx))
        y = y + damping * x
        return y + gauge * x                             # gauge fix

    wres = res * w
    b = torch.zeros((n, 6), **f)
    graphs.scatter_sum(b, e_i, torch.einsum("eij,ei->ej", ji, wres))
    graphs.scatter_sum(b, e_j, torch.einsum("eij,ei->ej", jj, wres))

    # block-Jacobi preconditioner from the per-node diagonal blocks
    ji_w = ji * w[:, :, None]
    jj_w = jj * w[:, :, None]
    diag = torch.zeros((n, 6, 6), **f)
    graphs.scatter_sum(diag, e_i, torch.einsum("eki,ekj->eij", ji_w, ji))
    graphs.scatter_sum(diag, e_j, torch.einsum("eki,ekj->eij", jj_w, jj))
    diag = diag + damping * eye6[None]
    diag = diag + gauge[:, :, None] * eye6[None]
    m_inv = torch.linalg.inv_ex(diag).inverse

    def prec(r):
        return torch.einsum("nij,nj->ni", m_inv, r)

    # CG on H dx = -b
    x = torch.zeros((n, 6), **f)
    r = -b
    z = prec(r)
    p = z
    rz = torch.sum(r * z)
    zero = torch.zeros((), **f)
    for _k in range(cg_iters):
        hp = matvec(p)
        denom = torch.sum(p * hp)
        alpha = torch.where(torch.abs(denom) > 1e-30, rz / denom, zero)
        x = x + alpha * p
        r = r - alpha * hp
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(torch.abs(rz) > 1e-30, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
    return _retract(q, t, x)


def optimize_pose_graph_dense(graph: PoseGraph, *, iters: int = 10,
                              damping: float = 1e-4
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton over the graph with a dense (6N, 6N) solve; returns the
    refined (q (N, 4), t (N, 3))."""
    q, t = graph.q, graph.t
    for _ in range(iters):
        q, t = _dense_iteration(graph, q, t, damping)
    return q, t


def optimize_pose_graph_pcg(graph: PoseGraph, *, iters: int = 10,
                            cg_iters: int = 96, damping: float = 1e-4
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Newton with a matrix-free, block-Jacobi preconditioned CG
    inner solve of exactly `cg_iters` steps: H x is evaluated from the edge
    list (two accumulations per edge, O(E) per product), the gauge fix and
    the damping ride as diagonal terms.  About 15 launches per CG step on
    CUDA."""
    q, t = graph.q, graph.t
    for _ in range(iters):
        q, t = _pcg_iteration(graph, q, t, damping, cg_iters)
    return q, t


def _solver(n: int, dense_below: int) -> Tuple[str, int]:
    """The front door's choice for n nodes: ("dense", 0) or ("pcg",
    cg_iters), cg_iters scaling with the node count (a chain's
    long-wavelength mode needs about N CG steps under block-Jacobi)."""
    if n <= dense_below:
        return "dense", 0
    return "pcg", max(96, int(1.5 * n))


def optimize_pose_graph(graph: PoseGraph, *, iters: int = 10,
                        damping: float = 1e-4, dense_below: int = 64
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solver front door: the dense solve for graphs of at most
    `dense_below` nodes, matrix-free PCG beyond (`_solver`)."""
    solver, cg_iters = _solver(graph.q.shape[0], dense_below)
    if solver == "dense":
        return optimize_pose_graph_dense(graph, iters=iters, damping=damping)
    return optimize_pose_graph_pcg(graph, iters=iters, damping=damping,
                                   cg_iters=cg_iters)


def _iteration_fn(solver: str, damping: float, cg_iters: int):
    """The pose-graph program's function, one Gauss-Newton iteration of
    `solver`: fn((q, t), graph without q and t) -> ((q, t), None)."""
    def fn(pose, graph: PoseGraph):
        if solver == "dense":
            return _dense_iteration(graph, *pose, damping), None
        return _pcg_iteration(graph, *pose, damping, cg_iters), None
    return fn


def optimize_pose_graph_program(programs: dict, graph: PoseGraph, *,
                                iters: int = 10, damping: float = 1e-4,
                                dense_below: int = 64
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`optimize_pose_graph` as a captured program kept in `programs`
    (`utils.graphs.call`): one Gauss-Newton iteration, keyed by the
    solver, the node and edge counts and cg_iters, replayed `iters` times
    back to back (the JAX package's jitted `fori_loop`s,
    sr_livo_tpu/parallel/pose_graph.py:74,127).  The same ops as the
    eager function, so the same bits on the CPU.  Returns the program's
    (q, t) buffers, which its next solve overwrites."""
    n, e = graph.q.shape[0], graph.edge_i.shape[0]
    solver, cg_iters = _solver(n, dense_below)
    pose, _ = graphs.call(
        programs, ("pose_graph", solver, n, e, cg_iters, damping),
        _iteration_fn(solver, damping, cg_iters),
        # the program's own pose buffers, not the caller's graph
        (graph.q.clone(), graph.t.clone()), graph._replace(q=None, t=None),
        name=f"pose_graph_{solver}[{n}]", repeat=iters)
    return pose
