"""The port's CUDA plane-residual kernel (sr_livo_tpu_torch/csrc/
plane_fit.cu) against its plain PyTorch version, on the card.

The kernel has no CPU mode, so these tests skip without a CUDA device.
The file imports neither JAX nor the JAX package, so it runs on a machine
with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_plane_fit_gpu.py

Tolerances are those of test_pallas_plane.py: the `good` masks agree on
more than 99.5% of rows, and on rows good in both, h within 2e-4 and h_x
within 2e-3; the association is held to the same bars (a2d like h, the
sign-free normal like h_x) and the closest neighbour exactly.
"""
import numpy as np
import pytest
import torch

from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.utils import lie as tlie

GOOD_AGREE = 0.995
ATOL_H = 2e-4
ATOL_HX = 2e-3

R_WORLD = tlie.exp_so3(torch.tensor([0.2, -0.1, 0.4])).numpy()


def _inputs(q, m, seed, pin_degenerate=False):
    """Planar-ish, distance-sorted neighbourhoods with n_found uniform in
    [0, m] (the recipe of test_pallas_plane.py).  With `pin_degenerate`,
    row 0 holds one point repeated m times: a zero scatter matrix, so
    a2d = 0 exactly and the normal falls back to e_z."""
    rng = np.random.RandomState(seed)
    world = rng.uniform(-5, 5, (q, 3)).astype(np.float32)
    normal = rng.randn(q, 3)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    t1 = np.cross(normal, [0.1, 0.7, 0.2])
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(normal, t1)
    uv = rng.uniform(-0.5, 0.5, (q, m, 2))
    nb = (world[:, None, :] + uv[..., :1] * t1[:, None, :]
          + uv[..., 1:] * t2[:, None, :]
          + rng.randn(q, m, 3) * 0.01
          + normal[:, None, :] * rng.uniform(-0.1, 0.1, (q, 1, 1)))
    d = np.linalg.norm(nb - world[:, None, :], axis=-1)
    order = np.argsort(d, axis=-1)
    nb = np.take_along_axis(nb, order[..., None], axis=1).astype(np.float32)
    n_found = rng.randint(0, m + 1, q).astype(np.int32)
    location = rng.uniform(-5, 5, (q, 3)).astype(np.float32)
    last_trans = np.array([0.3, -0.2, 1.0], np.float32)
    valid = rng.rand(q) < 0.9
    if pin_degenerate:
        nb[0] = world[0] + np.array([0.05, 0.0, 0.0], np.float32)
        n_found[0] = m
        valid[0] = True
    return nb, n_found, world, location, R_WORLD, last_trans, valid


def _kw(power):
    return dict(lam_w=0.9, lam_nb=0.1, power_planarity=power, max_dist=0.3,
                min_neighbors=12 if power == 2.0 else 8)


def _assert_rows_close(got, ref):
    hx_t, h_t, good_t = (np.asarray(a) for a in got)
    hx_r, h_r, good_r = (np.asarray(a) for a in ref)
    assert (good_t == good_r).mean() > GOOD_AGREE, (good_t.sum(),
                                                     good_r.sum())
    both = good_t & good_r
    assert both.sum() > 10
    np.testing.assert_allclose(h_t[both], h_r[both], atol=ATOL_H, rtol=0)
    np.testing.assert_allclose(hx_t[both], hx_r[both], atol=ATOL_HX, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("power", [2.0, 1.5])
def test_kernel_matches_plain_on_gpu(power):
    """The CUDA kernel against its plain version on the card, both
    entries, at the shapes the main path gives them: `plane_rows` on
    Q = 1024 rows, `plane_assoc` on Q = 1024 (unchunked) and on the
    512-row slices of `chunked_assoc`; M = 20."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    kw = _kw(power)
    t = [torch.as_tensor(a, device="cuda")
         for a in _inputs(1024, 20, seed=29, pin_degenerate=True)]
    plane_fit.reset_launches()
    got = plane_fit.plane_rows(*t, **kw)
    ref = plane_fit.plane_rows_plain(*t, **kw)
    _assert_rows_close([a.cpu().numpy() for a in got],
                       [a.cpu().numpy() for a in ref])
    chunk = [torch.as_tensor(a, device="cuda")
             for a in _inputs(512, 20, seed=31, pin_degenerate=True)[:2]]
    for nb, nf in ((t[0], t[1]), chunk):
        n_k, a_k, c_k = plane_fit.plane_assoc(nb, nf)
        n_p, a_p, c_p = plane_fit.plane_assoc_plain(nb, nf)
        torch.testing.assert_close(c_k, c_p, atol=0, rtol=0)
        rows = nf >= kw["min_neighbors"]
        sign = torch.where((n_k * n_p).sum(-1, keepdim=True) < 0, -1.0, 1.0)
        torch.testing.assert_close((n_k * sign)[rows], n_p[rows],
                                   atol=ATOL_HX, rtol=0)
        torch.testing.assert_close(a_k[rows], a_p[rows], atol=ATOL_H, rtol=0)
    assert (plane_fit.launches["plane_rows"],
            plane_fit.launches["plane_assoc"]) == (1, 2)
