"""Whether the pose graph's float sums give the same bits run after run on
the card.  On the GPU machine:

    python3 tests/torch_sum_order_probe.py

On a 30-node chain with one loop edge, padded to 32 nodes and edges as
the mapping backend pads its graph, it repeats the dense Gauss-Newton
iteration's right-hand side summed per node with `index_add_` (an atomic
add on CUDA floats, in no fixed order) and with `graphs.scatter_sum` (an
accumulating `index_put_`, summed in index order), then the whole dense
and PCG iterations (`parallel/pose_graph.py`, which use the latter), and
prints, as the last line, one JSON object with the number of distinct
results of each.  Imports torch and the port only.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sr_livo_tpu_torch.parallel import pose_graph as pg  # noqa: E402
from sr_livo_tpu_torch.utils import graphs  # noqa: E402


def chain(n: int, dev) -> pg.PoseGraph:
    rng = np.random.RandomState(0)
    n_pad = e_pad = 1 << max((n - 1).bit_length(), 3)
    t = np.zeros((n_pad, 3), np.float32)
    t[:n, 0] = np.arange(n) * 0.5 + rng.randn(n) * 0.05
    q = np.tile(np.array([1, 0, 0, 0], np.float32), (n_pad, 1))
    q[:n, 1:] = rng.randn(n, 3) * 0.01
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pad = np.zeros(e_pad - n, int)
    ei = np.r_[np.arange(n - 1), 3, pad]
    ej = np.r_[np.arange(1, n), n - 5, pad]
    tm = np.zeros((e_pad, 3), np.float32)
    tm[:n - 1, 0] = 0.5
    tm[n - 1, 0] = 0.5 * (n - 8)
    w = np.r_[np.full(n, 50.0), np.zeros(e_pad - n)]

    def up(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    return pg.PoseGraph(
        q=up(q), t=up(t), edge_i=up(ei, torch.int64),
        edge_j=up(ej, torch.int64),
        q_meas=up(np.tile(np.array([1, 0, 0, 0], np.float32), (e_pad, 1))),
        t_meas=up(tm), rot_w=up(w, torch.float32), t_w=up(w, torch.float32),
        edge_valid=up(np.arange(e_pad) < n))


def distinct(fn, reps: int) -> int:
    seen = []
    for _ in range(reps):
        x = torch.cat([v.reshape(-1) for v in fn()])
        if not any(torch.equal(x, s) for s in seen):
            seen.append(x)
    return len(seen)


def main() -> int:
    dev = torch.device("cuda")
    g = chain(30, dev)
    res, ji, jj, w = pg._linearize(g, g.q, g.t)
    b_i = torch.einsum("eki,ek->ei", ji * w[:, :, None], res)
    b_j = torch.einsum("eki,ek->ei", jj * w[:, :, None], res)
    zeros = torch.zeros((g.q.shape[0], 6), device=dev)

    def by_index_add():
        b = zeros.clone()
        b.index_add_(0, g.edge_i, b_i)
        return (b.index_add_(0, g.edge_j, b_j),)

    def by_scatter_sum():
        b = graphs.scatter_sum(zeros.clone(), g.edge_i, b_i)
        return (graphs.scatter_sum(b, g.edge_j, b_j),)

    g100 = chain(100, dev)
    out = {
        "rhs_index_add": distinct(by_index_add, 300),
        "rhs_scatter_sum": distinct(by_scatter_sum, 300),
        "dense_iteration[32]": distinct(
            lambda: pg._dense_iteration(g, g.q, g.t, 1e-4), 300),
        "pcg_iteration[128]": distinct(
            lambda: pg._pcg_iteration(g100, g100.q, g100.t, 1e-4, 96), 60)}
    print(json.dumps({"distinct_results": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
