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
