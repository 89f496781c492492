"""The map-sharded engine's use of the plane kernel, on the card.

The kernel has no CPU mode, so these tests skip without a CUDA device.
The file imports neither JAX nor the JAX package, so it runs on a machine
with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_sharded_gpu.py

  * `knn_plane_assoc` against its plain version on one rank's local
    table of a 2-rank layout (block-owner sub-table with voxel halos) at
    the IEKF's K4 x 20 shard shape: the keypoints whose centre block the
    rank owns, compacted to a valid prefix.  Bars of
    tests/test_torch_knn_plane_gpu.py: `n_found` exact, the closest
    neighbour wherever the two nearest distances differ by more than
    1e-6, the sign-free normal within 2e-3 and a2d within 2e-4 on rows
    with at least 8 neighbours.
  * One ShardedLioEngine run as a world of one over NCCL (so the
    collectives really go through NCCL) against LioEngine on the same
    sweeps: positions within 2e-3 m and quaternions within 1e-4
    (tests/test_sharded_lio.py), the same success and owned map size, no
    routing overflow, `knn_plane_assoc` launched once per IEKF update and
    no plain kNN on the card.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.models.odometry import LioEngine, SweepInput
from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.parallel import sharded_lio
from sr_livo_tpu_torch.parallel.mesh import make_mesh
from sr_livo_tpu_torch.parallel.routing import compact
from sr_livo_tpu_torch.runtime import measurements as meas_mod
from sr_livo_tpu_torch.runtime import synthetic

pytestmark = pytest.mark.gpu

ATOL_H = 2e-4
ATOL_HX = 2e-3
MIN_NB = 8
RANKS, HALO, K4 = 2, 2, 1024
SEARCH = dict(voxel_size=1.0, max_neighbors=20, max_probe=8, nb_voxels=1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def local_table():
    """Rank 0's sub-table of a 2-rank layout of a floor and two walls (1 cm
    of noise) and its routed keypoints at K4 rows."""
    dev = _cuda()
    rng = np.random.RandomState(9)
    u = rng.uniform(-30, 30, (40000, 2))
    pts = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(40000)],
        np.c_[np.full(40000, 25.0), u[:, 0], u[:, 1] * 0.1 + 3],
        np.c_[u[:, 0], np.full(40000, -25.0), u[:, 1] * 0.1 + 3]])
    pts = (pts + rng.randn(*pts.shape) * 0.01).astype(np.float32)
    t = torch.as_tensor(pts, device=dev)
    vox = vm.voxel_coords(t, 1.0)
    h = torch.tensor([[sx, sy, sz] for sx in (-HALO, HALO)
                      for sy in (-HALO, HALO) for sz in (-HALO, HALO)],
                     dtype=torch.int32, device=dev)
    stored = (sharded_lio.shard_of(vox[:, None, :] + h[None], RANKS)
              == 0).any(dim=1)
    table = vm.make_map(1 << 15, 20, device=dev)
    vm.insert(table, t, stored, 1.0, 0.05, 8)
    queries = (pts[rng.choice(len(pts), 1000)]
               + rng.randn(1000, 3) * 0.05).astype(np.float32)
    q = torch.as_tensor(queries, device=dev)
    mine = sharded_lio.shard_of(vm.voxel_coords(q, 1.0), RANKS) == 0
    rows, valid, _ = compact(q, mine, K4)
    return table, rows.contiguous(), valid


def test_knn_plane_assoc_on_a_local_table_at_k4(local_table):
    table, world, valid = local_table
    thr = torch.ones((), dtype=torch.int32, device=world.device)
    plane_fit.reset_launches()
    n_k, a_k, c_k, f_k = plane_fit.knn_plane_assoc_cuda(
        table, world, valid, thr, **SEARCH)
    assert plane_fit.launches["knn_plane_assoc"] == 1
    n_p, a_p, c_p, f_p = plane_fit.knn_plane_assoc_plain(
        table, world, valid, thr, **SEARCH)
    _, _, dists = vm.knn(table, world, threshold_capacity=thr,
                         **{k: SEARCH[k] for k in ("voxel_size",
                                                   "max_neighbors",
                                                   "max_probe", "nb_voxels")})
    torch.cuda.synchronize()
    nv = int(valid.sum())
    assert 300 < nv < K4
    v = slice(0, nv)
    assert torch.equal(f_k[v], f_p[v])
    assert not f_k[nv:].any() and not a_k[nv:].any()
    apart = ((dists[:, 1] - dists[:, 0]) > 1e-6)[v] | (f_p[v] <= 1)
    assert torch.equal(c_k[v][apart], c_p[v][apart])
    rows = f_p[v] >= MIN_NB
    assert int(rows.sum()) > nv // 2
    sign = torch.where((n_k[v] * n_p[v]).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    assert float((n_k[v] * sign - n_p[v])[rows].abs().max()) < ATOL_HX
    assert float((a_k[v] - a_p[v])[rows].abs().max()) < ATOL_H


def _cfg() -> LivoConfig:
    """tests/test_sharded_lio.py's configuration, residual cap active."""
    cfg = LivoConfig()
    cfg.odometry_options.voxel_size = 0.2
    cfg.odometry_options.init_voxel_size = 0.2
    cfg.odometry_options.sample_voxel_size = 0.8
    cfg.odometry_options.init_sample_voxel_size = 0.8
    cfg.odometry_options.min_distance_points = 0.05
    cfg.icp.size_voxel_map = 0.6
    cfg.icp.min_number_neighbors = 12
    cfg.icp.max_num_residuals = 220
    cfg.shapes.max_sweep_points = 2048
    cfg.shapes.max_frame_points = 2048
    cfg.shapes.max_keypoints = 512
    cfg.shapes.max_imu_samples = 48
    cfg.shapes.map_capacity = 1 << 15
    return cfg


def _sweeps(cfg, dev, n=8):
    sim = synthetic.simulate(duration=4.0, n_azimuth=64, n_rings=10, seed=4,
                             device="cpu")
    cutter = meas_mod.SweepCutter(0.1)
    for (t, a, g) in sim.imu:
        cutter.push_imu(t, a, g)
    for c in sim.lidar_chunks:
        cutter.push_points(c)
    for (t, img) in sim.images:
        cutter.push_image(t, img)
    out, current = [], None
    while len(out) < n:
        m = cutter.get()
        if m is None:
            break
        if current is None:
            current = m.time_sweep_begin
        p = meas_mod.prepare_sweep(m, current, cfg)
        current = p.new_current_time
        fid = len(out) + 1
        out.append(SweepInput(
            *(torch.as_tensor(np.asarray(getattr(p, f)), device=dev)
              for f in SweepInput._fields[:8]),
            do_optimize=torch.tensor(fid > 1, device=dev),
            threshold_capacity=torch.tensor(1, dtype=torch.int32,
                                            device=dev)))
    return out


@pytest.fixture
def nccl_world_of_one(tmp_path):
    dev = torch.device("cuda", _cuda().index or 0)
    torch.cuda.set_device(dev.index)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1)
    try:
        yield make_mesh(device=dev)
    finally:
        dist.destroy_process_group()


def test_world_of_one_over_nccl_matches_lio_engine(nccl_world_of_one,
                                                    monkeypatch):
    mesh = nccl_world_of_one
    plain_knn = []
    knn = vm.knn

    def spy(vmap, queries, **kw):
        plain_knn.append(queries.is_cuda)
        return knn(vmap, queries, **kw)
    monkeypatch.setattr(vm, "knn", spy)
    assert dist.get_backend(mesh.group) == "nccl"
    cfg = _cfg()
    sweeps = _sweeps(cfg, mesh.device)
    single = LioEngine(cfg, device=mesh.device)
    eng = sharded_lio.ShardedLioEngine(cfg, mesh)
    s1, m1 = single.init_state(), single.make_map()
    s2, m2 = eng.init_state(), eng.make_map()
    updates = []
    orig = eng._iekf

    def counted(*args, **kw):
        updates.append(1)
        return orig(*args, **kw)
    eng._iekf = counted
    for fid, sweep in enumerate(sweeps, start=1):
        o1 = single.step(s1, m1, sweep, fid)
        s1, m1 = o1.state, o1.voxel_map
        plane_fit.reset_launches()
        o2 = eng.step(s2, m2, sweep, fid)
        launches = dict(plane_fit.launches)
        s2, m2 = o2.state, o2.voxel_map
        assert int(o2.route_overflow) == 0, fid
        assert int(eng.map_size(m2)) == int(vm.map_size(m1)), fid
        assert float((s1.p - s2.p).abs().max()) < 2e-3, fid
        assert float((s1.q - s2.q).abs().max()) < 1e-4, fid
        assert bool(o1.summary.success) == bool(o2.summary.success), fid
        assert int(o1.summary.num_residuals) == int(
            o2.summary.num_residuals), fid
        assert launches["knn_plane_assoc"] == 1, (fid, launches)
        assert sum(launches.values()) == 1, (fid, launches)
    assert len(updates) == len(sweeps)
    assert not any(plain_knn), "the plain kNN ran on the card"
