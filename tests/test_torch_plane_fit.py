"""The port's plane-residual rows (sr_livo_tpu_torch.ops.plane_fit) against
the JAX package's: the plain full row against `_plane_rows_jnp` and the
Pallas kernel (interpret mode) and the plain association against
`neighborhood_distribution`.  The CUDA kernel against the plain version
is the card's test, in test_torch_plane_fit_gpu.py.

Tolerances are those of test_pallas_plane.py: the `good` masks agree on
more than 99.5% of rows, and on rows good in both, h within 2e-4 and h_x
within 2e-3 (the Pallas kernel's acos polynomial and its exp-log power
are the loosest parts).  The association is held to float32 round-off of
unit-scale PCA (2e-5 on the sign-free normal and on a2d) and the closest
neighbour exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.models.lio import _plane_rows_jnp
from sr_livo_tpu.ops import neighborhood as jnb
from sr_livo_tpu.ops.pallas.plane_fit import plane_residuals_pallas
from sr_livo_tpu_torch.ops import plane_fit
from tests.test_torch_plane_fit_gpu import _assert_rows_close, _inputs, _kw

ATOL_ASSOC = 2e-5


@pytest.mark.parametrize("power", [2.0, 1.5])
@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
def test_plain_rows_match_jax(power, reference):
    args = _inputs(300, 20, seed=23, pin_degenerate=True)
    kw = _kw(power)
    before = dict(plane_fit.launches)
    got = plane_fit.plane_rows(*(torch.as_tensor(a) for a in args), **kw)
    jargs = tuple(jnp.asarray(a) for a in args)
    if reference == "jnp":
        ref = _plane_rows_jnp(*jargs, **kw)
    else:
        ref = plane_residuals_pallas(*jargs, **kw, interpret=True)
    _assert_rows_close([t.numpy() for t in got], ref)
    assert plane_fit.launches == before      # CPU tensors: plain version


@pytest.mark.parametrize("power", [2.0, 1.5])
def test_pinned_zero_planarity_row(power):
    """a2d = 0 gives planarity weight 0 for every power (a2d**p), so the
    weight is the neighbourhood term alone, as in `_plane_rows_jnp`."""
    args = _inputs(16, 20, seed=5, pin_degenerate=True)
    kw = _kw(power)
    t = [torch.as_tensor(a) for a in args]
    normal, a2d, closest = plane_fit.plane_assoc(t[0], t[1])
    assert float(a2d[0]) == 0.0
    assert normal[0].tolist() == [0.0, 0.0, 1.0]
    h_x, h, good = plane_fit.plane_rows(*t, **kw)
    hx_j, h_j, good_j = (np.asarray(a) for a in _plane_rows_jnp(
        *(jnp.asarray(a) for a in args), **kw))
    assert bool(good[0]) == bool(good_j[0])
    np.testing.assert_allclose(h[0].item(), h_j[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(h_x[0].numpy(), hx_j[0], atol=1e-6, rtol=0)
    d_cl = np.linalg.norm(args[0][0, 0] - args[2][0])
    w = kw["lam_nb"] * np.exp(-d_cl / (kw["max_dist"] * kw["min_neighbors"]))
    assert bool(good[0])
    np.testing.assert_allclose(abs(h_x[0, 2].item()), w, rtol=1e-5)


def test_plain_assoc_matches_neighborhood_distribution():
    nb, n_found = _inputs(400, 20, seed=11, pin_degenerate=True)[:2]
    normal, a2d, closest = plane_fit.plane_assoc(torch.as_tensor(nb),
                                                 torch.as_tensor(n_found))
    jn, ja, _ = (np.asarray(a) for a in jnb.neighborhood_distribution(
        jnp.asarray(nb), jnp.asarray(n_found)))
    normal, a2d = normal.numpy(), a2d.numpy()
    # With fewer than 6 points the two smallest eigenvalues of a planar
    # patch are both near 0 and round-off picks the normal; the IEKF uses
    # rows with at least min_number_neighbors (>= 8) points.
    rows = n_found >= 6
    sign = np.where((normal * jn).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    np.testing.assert_allclose((normal * sign)[rows], jn[rows],
                               atol=ATOL_ASSOC, rtol=0)
    np.testing.assert_allclose(a2d[rows], ja[rows], atol=ATOL_ASSOC, rtol=0)
    assert rows.sum() > 250
    np.testing.assert_array_equal(closest.numpy(), nb[:, 0])


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_inputs():
    """The CUDA entries take CUDA tensors only and raise (before any build
    or launch) on what the kernel does not take."""
    t = [torch.as_tensor(a) for a in _inputs(8, 20, seed=3)]
    before = dict(plane_fit.launches)
    with pytest.raises(ValueError, match="CUDA"):
        plane_fit.plane_assoc_cuda(t[0], t[1])
    with pytest.raises(ValueError, match="CUDA"):
        plane_fit.plane_rows_cuda(*t, **_kw(2.0))
    with pytest.raises(ValueError, match="expected"):
        plane_fit.plane_assoc_cuda(t[0][..., :2], t[1])
    with pytest.raises(ValueError, match="unsupported device"):
        plane_fit.plane_assoc(t[0].to("meta"), t[1].to("meta"))
    assert plane_fit.launches == before
