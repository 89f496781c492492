"""The fused kNN + plane entries of the port's CUDA kernel
(sr_livo_tpu_torch/csrc/plane_fit.cu: `knn_plane_assoc`,
`knn_plane_rows`) against their plain PyTorch versions, on the card.

The kernel has no CPU mode, so these tests skip without a CUDA device.
The file imports neither JAX nor the JAX package, so it runs on a machine
with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_knn_plane_gpu.py

Both versions see the same map (built on the card by `voxel_map.insert`
from a numpy seed) and the same keypoints.  Integer results are exact:
`n_found` everywhere, the closest neighbour wherever the two nearest
distances differ by more than 1e-6.  Floats are held to the tolerances of
test_pallas_plane.py: the sign-free normal 2e-3 and a2d 2e-4 on rows with
at least 8 neighbours; for the full row, the `good` masks agree on more
than 99.5% of rows and, on rows good in both, h within 2e-4 and h_x within
2e-3.

The backend's two association shapes run through the same entry with an
all-true mask: the windowed BA's 4 keyframes x 1024 rows (zero-padded
rows past each keyframe's valid prefix) at 0.6 m voxels on a map keyed at
1.0 m, and loop verification's 1024 rows at M = 10 on a temporary
2^14 x 20 map of 0.5 m voxels; every row is associated there.  The BA and
the verification then run end to end on the card and on the CPU with the
same inputs: poses within 1e-4, the fitness within one inlier (the card's
sums use atomics, so they are not bitwise the CPU's).
"""
import numpy as np
import pytest
import torch

from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.utils import lie as tlie

GOOD_AGREE = 0.995
ATOL_H = 2e-4
ATOL_HX = 2e-3
MIN_NB = 8
Q, N_VALID = 1024, 700
SEARCH = dict(voxel_size=1.0, max_neighbors=20, max_probe=8)
ROW_KW = dict(lam_w=0.9, lam_nb=0.1, power_planarity=2.0, max_dist=0.3,
              min_neighbors=12)


@pytest.fixture(scope="module")
def scene():
    """A floor, two walls and scattered points in a 2^14-slot map of
    20-point blocks on the card, and keypoints near the surfaces (a valid
    prefix of N_VALID rows).  The surfaces carry 1 cm of noise, as a
    LiDAR's do: on an exactly flat patch the smallest eigenvalue is
    rounding noise, and its square root in a2d differs between any two
    summation orders by more than the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.RandomState(5)
    u = rng.uniform(-8, 8, (6000, 2))
    pts = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(6000)],
        np.c_[np.full(6000, 7.5), u[:, 0], u[:, 1] * 0.4 + 3],
        np.c_[u[:, 0], np.full(6000, -7.5), u[:, 1] * 0.4 + 3]])
    pts = np.concatenate([pts + rng.randn(*pts.shape) * 0.01,
                          rng.uniform(-8, 8, (1500, 3))]).astype(np.float32)
    dev = torch.device("cuda")
    vmap = vm.make_map(1 << 14, 20, device=dev)
    vmap, _ = vm.insert(vmap, torch.as_tensor(pts, device=dev),
                        torch.ones(len(pts), dtype=torch.bool, device=dev),
                        1.0, 0.05, 8)
    world = (pts[rng.choice(len(pts), Q)]
             + rng.randn(Q, 3) * 0.05).astype(np.float32)
    location = rng.uniform(-5, 5, (Q, 3)).astype(np.float32)
    t = dict(
        world=torch.as_tensor(world, device=dev),
        location=torch.as_tensor(location, device=dev),
        valid=torch.arange(Q, device=dev) < N_VALID,
        r_world=tlie.exp_so3(torch.tensor([0.2, -0.1, 0.4],
                                          device=dev)).contiguous(),
        last_trans=torch.tensor([0.3, -0.2, 1.0], device=dev))
    return vmap, t


def _thr(value):
    return torch.full((), value, dtype=torch.int32, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nb_voxels", [1, 2])
@pytest.mark.parametrize("threshold", [1, 5])
def test_knn_plane_assoc_matches_plain_on_gpu(scene, nb_voxels, threshold):
    vmap, t = scene
    kw = dict(SEARCH, nb_voxels=nb_voxels)
    thr = _thr(threshold)
    plane_fit.reset_launches()
    n_k, a_k, c_k, f_k = plane_fit.knn_plane_assoc(
        vmap, t["world"], t["valid"], thr, chunk=512, **kw)
    assert plane_fit.launches["knn_plane_assoc"] == 1
    n_p, a_p, c_p, f_p = plane_fit.knn_plane_assoc_plain(
        vmap, t["world"], t["valid"], thr, **kw)
    _, _, dists = vm.knn(vmap, t["world"], threshold_capacity=thr, **kw)
    torch.cuda.synchronize()
    v = slice(0, N_VALID)
    torch.testing.assert_close(f_k[v], f_p[v], atol=0, rtol=0)
    assert int(f_k[v].min()) < 20 and int(f_k[v].max()) == 20
    # rows past the valid prefix are not associated
    assert not f_k[N_VALID:].any() and not c_k[N_VALID:].any()
    assert not n_k[N_VALID:].any() and not a_k[N_VALID:].any()
    apart = ((dists[:, 1] - dists[:, 0]) > 1e-6) | (f_p <= 1)
    rows = apart[v]
    assert rows.float().mean() > 0.9
    torch.testing.assert_close(c_k[v][rows], c_p[v][rows], atol=0, rtol=0)
    rows = f_p[v] >= MIN_NB
    assert rows.sum() > 300
    sign = torch.where((n_k * n_p).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    torch.testing.assert_close((n_k * sign)[v][rows], n_p[v][rows],
                               atol=ATOL_HX, rtol=0)
    torch.testing.assert_close(a_k[v][rows], a_p[v][rows], atol=ATOL_H,
                               rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("nb_voxels", [1, 2])
@pytest.mark.parametrize("threshold", [1, 5])
def test_knn_plane_rows_matches_plain_on_gpu(scene, nb_voxels, threshold):
    vmap, t = scene
    kw = dict(SEARCH, nb_voxels=nb_voxels, **ROW_KW)
    args = (vmap, t["world"], t["location"], t["r_world"], t["last_trans"],
            t["valid"], _thr(threshold))
    plane_fit.reset_launches()
    hx_k, h_k, good_k = plane_fit.knn_plane_rows(*args, **kw)
    assert plane_fit.launches["knn_plane_rows"] == 1
    hx_p, h_p, good_p = plane_fit.knn_plane_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    assert float((good_k == good_p).float().mean()) > GOOD_AGREE
    both = good_k & good_p
    assert int(both.sum()) > 200
    torch.testing.assert_close(h_k[both], h_p[both], atol=ATOL_H, rtol=0)
    torch.testing.assert_close(hx_k[both], hx_p[both], atol=ATOL_HX, rtol=0)
    # invalid keypoints skip the search: zero rows, not good
    assert not good_k[N_VALID:].any()
    assert not hx_k[N_VALID:].any() and not h_k[N_VALID:].any()


@pytest.mark.gpu
def test_knn_plane_assoc_reads_nothing_back(scene):
    """The association on the card makes no host sync: the valid prefix
    is counted by the kernel, not read back."""
    vmap, t = scene
    thr = _thr(1)
    kw = dict(SEARCH, nb_voxels=1, chunk=512)
    plane_fit.knn_plane_assoc(vmap, t["world"], t["valid"], thr, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = plane_fit.knn_plane_assoc(vmap, t["world"], t["valid"], thr,
                                        **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out[3].sum()) > 0


def _all_rows(n):
    return torch.ones(n, dtype=torch.bool, device="cuda")


def _check_all_rows(vmap, world, kw, min_nb):
    """Kernel vs plain over every row of `world` (all-true mask)."""
    thr = _thr(1)
    valid = _all_rows(world.shape[0])
    plane_fit.reset_launches()
    n_k, a_k, c_k, f_k = plane_fit.knn_plane_assoc(vmap, world, valid, thr,
                                                   **kw)
    assert plane_fit.launches["knn_plane_assoc"] == 1
    n_p, a_p, c_p, f_p = plane_fit.knn_plane_assoc_plain(vmap, world, valid,
                                                         thr, **kw)
    _, _, dists = vm.knn(vmap, world, threshold_capacity=thr, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(f_k, f_p, atol=0, rtol=0)
    apart = ((dists[:, 1] - dists[:, 0]) > 1e-6) | (f_p <= 1)
    torch.testing.assert_close(c_k[apart], c_p[apart], atol=0, rtol=0)
    rows = f_p >= min_nb
    assert rows.sum() > world.shape[0] // 4
    sign = torch.where((n_k * n_p).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    torch.testing.assert_close((n_k * sign)[rows], n_p[rows], atol=ATOL_HX,
                               rtol=0)
    torch.testing.assert_close(a_k[rows], a_p[rows], atol=ATOL_H, rtol=0)
    assert torch.isfinite(n_k).all() and torch.isfinite(c_k).all()


@pytest.mark.gpu
def test_ba_window_shape_matches_plain_on_gpu(scene):
    """4 x 1024 flattened window rows, each keyframe's rows past its valid
    prefix zero (they map to the origin voxel), at 0.6 m voxels on the
    1.0 m map, M = 20."""
    vmap, t = scene
    rng = np.random.RandomState(7)
    src = t["world"].cpu().numpy()
    rows = []
    for n_valid in (1024, 700, 431, 900):
        w = np.zeros((1024, 3), np.float32)
        w[:n_valid] = (src[rng.randint(0, Q, n_valid)]
                       + rng.randn(n_valid, 3).astype(np.float32) * 0.05)
        rows.append(w)
    world = torch.as_tensor(np.concatenate(rows), device="cuda")
    _check_all_rows(vmap, world, dict(voxel_size=0.6, max_neighbors=20,
                                      max_probe=16, nb_voxels=1), 8)


@pytest.fixture(scope="module")
def loop_scene():
    """Two 1024-point scans of a floor and two walls (1 cm noise) 0.4 m
    apart, the first in a temporary 2^14 x 20 map at 0.5 m voxels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.RandomState(13)
    u = rng.uniform(-6, 6, (8000, 2))
    world = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(8000)],
        np.c_[np.full(8000, 6.0), u[:, 0], u[:, 1] * 0.3 + 1.5],
        np.c_[u[:, 0], np.full(8000, 6.0), u[:, 1] * 0.3 + 1.5]])
    world = (world + rng.randn(*world.shape) * 0.01).astype(np.float32)
    scans = [world[rng.choice(len(world), 1024, replace=False)]
             - np.array(t, np.float32) for t in ([0.5, -0.3, 1.0],
                                                 [0.9, 0.0, 1.1])]
    valid = np.ones((2, 1024), bool)
    valid[1, 900:] = False
    scans[1][900:] = 0.0
    return scans, valid


@pytest.mark.gpu
def test_loop_verification_shape_matches_plain_on_gpu(loop_scene):
    scans, valid = loop_scene
    dev = torch.device("cuda")
    tmp = vm.make_map(1 << 14, 20, device=dev)
    tmp, _ = vm.insert(tmp, torch.as_tensor(scans[0], device=dev),
                       torch.as_tensor(valid[0], device=dev), 0.5, 0.0, 16)
    world = torch.as_tensor(scans[1], device=dev) + torch.tensor(
        [0.02, -0.01, 0.0], device=dev)
    _check_all_rows(tmp, world, dict(voxel_size=0.5, max_neighbors=10,
                                     max_probe=16, nb_voxels=1), 6)


@pytest.mark.gpu
def test_backend_solves_on_gpu_match_cpu(scene, loop_scene):
    """windowed_ba and verify_closure on the card against the same calls
    on the CPU; each association is one kernel launch."""
    from sr_livo_tpu_torch.parallel import ba, loop_closure
    vmap, t = scene
    rng = np.random.RandomState(3)
    k, n = 4, 1024
    pts = np.zeros((k, n, 3), np.float32)
    ok = np.zeros((k, n), bool)
    q = np.tile(np.array([1, 0, 0, 0], np.float32), (k, 1))
    tr = np.stack([[0.3 * i, 0.1 * i, 0.0] for i in range(k)]).astype(
        np.float32)
    src = t["world"].cpu().numpy()
    for i, n_valid in enumerate((1024, 800, 600, 1000)):
        pts[i, :n_valid] = src[rng.randint(0, Q, n_valid)] - tr[i]
        ok[i, :n_valid] = True
    tr[1:] += rng.randn(k - 1, 3).astype(np.float32) * 0.03
    q_odo = np.tile(np.array([1, 0, 0, 0], np.float32), (k - 1, 1))
    t_odo = np.full((k - 1, 3), [0.3, 0.1, 0.0], np.float32)
    cpu_map = vm.VoxelMap(*(a.cpu() for a in vmap))
    out = {}
    for dev, m in (("cuda", vmap), ("cpu", cpu_map)):
        def up(a):
            return torch.as_tensor(a, device=dev)
        window = ba.KeyframeWindow(q=up(q), t=up(tr), points=up(pts),
                                   pt_valid=up(ok),
                                   kf_valid=up(np.ones(k, bool)))
        plane_fit.reset_launches()
        out[dev] = ba.windowed_ba(m, window, up(q_odo), up(t_odo),
                                  voxel_size=0.6, min_neighbors=8, iters=2)
        if dev == "cuda":
            assert plane_fit.launches["knn_plane_assoc"] == 2
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a.cpu() - b).abs().max()) < 1e-4

    scans, valid = loop_scene
    res = {}
    for dev in ("cuda", "cpu"):
        def up(a):
            return torch.as_tensor(np.asarray(a), device=dev)
        q0 = up(np.array([1, 0, 0, 0], np.float32))
        plane_fit.reset_launches()
        res[dev] = loop_closure.verify_closure(
            up(scans[0]), up(valid[0]), up(scans[1]), up(valid[1]),
            q0, up(np.array([0.5, -0.3, 1.0], np.float32)),
            q0, up(np.array([0.95, -0.05, 1.1], np.float32)))
        if dev == "cuda":
            assert plane_fit.launches["knn_plane_assoc"] == 9
    a, b = res["cuda"], res["cpu"]
    assert float((a.q_meas.cpu() - b.q_meas).abs().max()) < 1e-4
    assert float((a.t_meas.cpu() - b.t_meas).abs().max()) < 1e-4
    assert abs(float(a.fitness) - float(b.fitness)) * 900 <= 1.0
    assert float(b.fitness) > 0.6
