"""The long-run path's captured programs on the card: the pose-graph
solves (dense and PCG), the windowed BA, the loop-closure check,
`compact_map` and the map rebuild's insert as CUDA graph replays.

A CUDA graph exists only on a CUDA device, so these tests skip without
one.  The file imports neither JAX nor the JAX package, so it runs on a
machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_backend_programs_gpu.py

For each program, on two inputs of one shape (the second through the
refilled buffers), the replay against its eager function on the same
inputs: integers bit for bit, floats bit for bit where the function holds
no float atomic, and the pose-graph solves, whose `index_add_` on CUDA
floats is an atomic add in no fixed order, within the spread of five
eager runs (the replay must lie that close to one of them).  A replay
advances the launch counters by what its capture launched (the BA's
`knn_plane_assoc` once per Gauss-Newton iteration, the closure check's 9
times), and a steady call (refills and replays) makes no synchronizing
call.  The CPU's bit-for-bit check of the capture form against the eager
function, and the JAX parity, are tests/test_torch_backend_programs.py.
"""
import numpy as np
import pytest
import torch

from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.parallel import ba
from sr_livo_tpu_torch.parallel import loop_closure as lc
from sr_livo_tpu_torch.parallel import pose_graph as pg
from sr_livo_tpu_torch.utils import graphs, lie

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _quat(yaw: float) -> np.ndarray:
    return lie.exp_so3_quat(torch.tensor([0.0, 0.0, yaw])).numpy()


def _chain(n: int, seed: int, dev) -> pg.PoseGraph:
    """A drifting n-node circle with a loop edge and two more from node 3
    (a node in three edges of one accumulation), padded to 2n edges of
    zero weight as the backend pads."""
    rng = np.random.RandomState(seed)
    a = 2 * np.pi * np.arange(n) / n
    q = np.stack([_quat(x) for x in a]).astype(np.float32)
    t = np.c_[3 * np.cos(a), 3 * np.sin(a), np.zeros(n)].astype(np.float32)
    pairs = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0), (3, n // 2),
                                                  (3, n - 3)]
    qt, tt = torch.as_tensor(q), torch.as_tensor(t)
    qm, tm = pg.edge_from_poses(qt[[i for i, _ in pairs]],
                                tt[[i for i, _ in pairs]],
                                qt[[j for _, j in pairs]],
                                tt[[j for _, j in pairs]])
    tm = tm + torch.as_tensor(rng.randn(len(pairs), 3) * 0.03,
                              dtype=torch.float32)
    e, e_pad = len(pairs), 2 * n
    pad = e_pad - e

    def cat(x, fill):
        return torch.cat([x, fill.expand((pad,) + x.shape[1:])])
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0])
    t0 = tt + torch.as_tensor(rng.randn(n, 3) * 0.1, dtype=torch.float32)
    g = pg.PoseGraph(
        q=qt, t=t0,
        edge_i=cat(torch.tensor([i for i, _ in pairs]), torch.tensor(0)),
        edge_j=cat(torch.tensor([j for _, j in pairs]), torch.tensor(0)),
        q_meas=cat(qm, ident), t_meas=cat(tm, torch.zeros(3)),
        rot_w=cat(torch.full((e,), 50.0), torch.tensor(0.0)),
        t_w=cat(torch.full((e,), 50.0), torch.tensor(0.0)),
        edge_valid=torch.arange(e_pad) < e)
    return graphs.tree_map(lambda x: x.to(dev), g)


def _room(rng, n=4000) -> np.ndarray:
    u = rng.uniform(-6, 6, (n, 2))
    return np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(n)],
        np.c_[np.full(n, 6.0), u[:, 0], u[:, 1] * 0.25 + 1.5],
        np.c_[u[:, 0], np.full(n, 6.0), u[:, 1] * 0.25 + 1.5],
    ]).astype(np.float32)


def _map(world: np.ndarray, dev, voxel=1.0, cap=1 << 14, k=20):
    m = vm.make_map(cap, k, device=dev)
    pts = torch.as_tensor(world, device=dev)
    vm.insert(m, pts, torch.ones(len(pts), dtype=torch.bool, device=dev),
              voxel, 0.05, 16)
    return m


def _window(world, rng, dev, K=4, N=512):
    """K keyframes observing N room points each, poses perturbed by 8 cm,
    with each keyframe's valid rows a prefix of its rows."""
    q, t, pts, valid = [], [], [], []
    for k in range(K):
        qk = _quat(0.05 * k)
        tk = np.array([0.5 * k, 0.2 * k, 1.0], np.float32)
        r = lie.quat_to_rot(torch.as_tensor(qk)).numpy()
        sel = rng.choice(len(world), N, replace=False)
        body = ((world[sel] - tk) @ r).astype(np.float32)
        ok = np.arange(N) < N - 37 * k
        body[~ok] = 0.0
        q.append(qk)
        t.append(tk + (rng.randn(3) * 0.08 if k else 0.0))
        pts.append(body)
        valid.append(ok)
    q = np.stack(q).astype(np.float32)
    t = np.stack(t).astype(np.float32)
    q_odo, t_odo = pg.edge_from_poses(*(torch.as_tensor(x) for x in (
        q[:-1], t[:-1], q[1:], t[1:])))
    up = (lambda x: torch.as_tensor(x, device=dev))
    window = ba.KeyframeWindow(q=up(q), t=up(t), points=up(np.stack(pts)),
                               pt_valid=up(np.stack(valid)),
                               kf_valid=torch.ones(K, dtype=torch.bool,
                                                   device=dev))
    return window, q_odo.to(dev), t_odo.to(dev)


def _closure_args(seed, dev, n=1024):
    """Two scans of the room from poses 0.7 m apart, the query's guess
    0.35 m and 4 degrees off, its tail padded."""
    rng = np.random.RandomState(seed)
    world = _room(rng, 8000)
    q_i, t_i = _quat(0.3), np.array([0.5, -0.3, 1.0], np.float32)
    q_j, t_j = _quat(0.5), np.array([1.0, 0.4, 1.1], np.float32)

    def scan(q, t):
        r = lie.quat_to_rot(torch.as_tensor(q)).numpy()
        sel = rng.choice(len(world), n, replace=False)
        return ((world[sel] - t) @ r).astype(np.float32)
    valid_j = np.arange(n) < n - 100
    args = (scan(q_i, t_i), np.ones(n, bool), scan(q_j, t_j), valid_j,
            q_i, t_i, _quat(0.55), t_j + np.array([0.25, -0.2, 0.1]))
    return [torch.as_tensor(np.asarray(a, dtype=None if a.dtype == bool
                                       else np.float32), device=dev)
            for a in args]


def _bits(t):
    if t.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return t.contiguous().view(ints[t.element_size()])
    return t


def _same(a, b) -> bool:
    la, lb = graphs.tree_leaves(a), graphs.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(_bits(x), _bits(y))
                                      for x, y in zip(la, lb))


def _max_abs(a, b) -> float:
    return max((float((x.double() - y.double()).abs().max())
                for x, y in zip(graphs.tree_leaves(a), graphs.tree_leaves(b))
                if x.numel()), default=0.0)


def _clone(tree):
    return graphs.tree_map(torch.clone, tree)


CASES = ("pose_graph_dense", "pose_graph_pcg", "windowed_ba",
         "verify_closure", "compact_map", "map_insert")


def _case(name, seed, dev):
    """(program call, eager call, launches per call, float atomics): the
    calls take a dict of programs (the eager one ignores it) and return
    the result as a pytree of fresh tensors."""
    rng = np.random.RandomState(seed)
    if name.startswith("pose_graph"):
        g = _chain(24 if name.endswith("dense") else 96, seed, dev)
        return ((lambda p: _clone(pg.optimize_pose_graph_program(
            p, g, iters=6))),
            (lambda p: pg.optimize_pose_graph(g, iters=6)), 0, True)
    if name == "windowed_ba":
        world = _room(np.random.RandomState(5))
        live = _map(world, dev)
        args = _window(world, rng, dev)
        kw = dict(voxel_size=0.6, min_neighbors=8, iters=2)
        return ((lambda p: _clone(ba.windowed_ba_program(p, live, *args,
                                                         **kw))),
                (lambda p: ba.windowed_ba(live, *args, **kw)), 2, False)
    if name == "verify_closure":
        args = _closure_args(seed, dev)
        return ((lambda p: _clone(lc.verify_closure_program(p, *args))),
                (lambda p: lc.verify_closure(*args)), 9, False)
    pts = rng.uniform(-12, 12, (6000, 3)).astype(np.float32)
    pts[:, 2] *= 0.05
    if name == "compact_map":
        old = _map(pts, dev, voxel=0.5, cap=1 << 12, k=8)
        loc = torch.as_tensor(pts[0], device=dev)
        # the program compacts its map in place: each call gets a copy
        return ((lambda p: _clone(vm.compact_map_program(
            p, _clone(old), loc, distance=6.0, max_probe=16))),
            (lambda p: vm.compact_map(old, loc, distance=6.0,
                                      max_probe=16)), 0, False)
    base = _map(pts[:3000], dev, voxel=0.5, cap=1 << 12)
    new = torch.as_tensor(pts[3000:], device=dev)
    ok = torch.as_tensor(rng.rand(3000) < 0.9, device=dev)
    return ((lambda p: _clone(vm.insert_program(p, _clone(base), new, ok,
                                                0.5, 0.05, 16))),
            (lambda p: vm.insert(_clone(base), new, ok, 0.5, 0.05, 16)),
            0, False)


@pytest.mark.parametrize("name", CASES)
def test_replay_matches_eager_function(cuda, name):
    programs = {}
    for seed in (1, 2):
        program, eager, launches, atomics = _case(name, seed, cuda)
        before = dict(plane_fit.launches)
        got = program(programs)
        assert plane_fit.launches["knn_plane_assoc"] - before[
            "knn_plane_assoc"] == launches
        with graphs.counts_kept():
            runs = [eager(None) for _ in range(5 if atomics else 1)]
        torch.cuda.synchronize()
        if not atomics:
            assert _same(got, runs[0]), _max_abs(got, runs[0])
            continue
        spread = max(_max_abs(a, b) for a in runs for b in runs)
        nearest = min(_max_abs(got, r) for r in runs)
        assert nearest <= spread, (nearest, spread)
    (prog,) = programs.values()
    assert prog.captures == 1 and prog.nodes > 1


@pytest.mark.parametrize("name", CASES)
def test_steady_call_makes_no_sync(cuda, name):
    """The second call of each program (refills of device tensors and the
    replays) under `set_sync_debug_mode("error")`."""
    programs = {}
    program, _, _, _ = _case(name, 1, cuda)
    program(programs)
    program, _, _, _ = _case(name, 2, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        program(programs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    (prog,) = programs.values()
    assert prog.captures == 1
