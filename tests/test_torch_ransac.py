"""Parity of the port's RANSAC gates (sr_livo_tpu_torch.ops.ransac) with
the JAX package's.

The JAX package draws hypotheses with `jax.random.gumbel` from a key; the
port takes the Gumbel noise as a tensor.  Both are given the same draws
(the port gets `jax.random.gumbel(key, (n_hyp, n))`), so they sample the
same minimal sets: the sampler's index order equals `lax.top_k`'s even on
ties at -inf, and the PnP pose agrees within 1e-5.  The inlier masks may
differ only on rows whose score is within 1e-4 of the threshold; on these
scenes they are identical, and the tests hold them to that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.ops import ransac as jr
from sr_livo_tpu_torch.ops import ransac as tr
from sr_livo_tpu_torch.utils import lie as tlie
from tests.torch_threads import one_intraop_thread  # noqa: F401

INTR = np.array([250.0, 250.0, 160.0, 120.0])


def _scene(seed, n=150, outliers=25):
    """3-D points in front of a camera, a second view after a small motion,
    and outlier matches."""
    rng = np.random.RandomState(seed)
    pts = np.c_[rng.uniform(-2, 2, (n, 2)), rng.uniform(4, 9, (n, 1))]
    w = np.array([0.02, -0.03, 0.01])
    t = np.array([0.2, -0.1, 0.05])
    r = tlie.exp_so3(torch.as_tensor(w)).numpy()

    def proj(p):
        return np.c_[p[:, 0] * INTR[0] / p[:, 2] + INTR[2],
                     p[:, 1] * INTR[1] / p[:, 2] + INTR[3]]

    p0 = proj(pts) + rng.randn(n, 2) * 0.2
    p1 = proj(pts @ r.T + t) + rng.randn(n, 2) * 0.2
    out = rng.choice(n, outliers, replace=False)
    p1[out] += rng.uniform(8, 40, (outliers, 2)) * np.sign(
        rng.randn(outliers, 2))
    valid = rng.rand(n) < 0.9
    f32 = np.float32
    return (pts.astype(f32), p0.astype(f32), p1.astype(f32), valid, w, t)


def _noise(key, n_hyp, n):
    return np.array(jax.random.gumbel(key, (n_hyp, n)))


def test_sampler_matches_top_k_with_ties():
    """Fewer valid entries than k: the -inf entries tie, and both packages
    fill with the lowest invalid indices, in index order."""
    key = jax.random.PRNGKey(3)
    valid = np.zeros(40, bool)
    valid[[5, 17, 30]] = True
    for k in (4, 8):
        j = np.asarray(jr._sample_indices(key, 64, k, 40, jnp.asarray(valid)))
        t = tr._sample_indices(torch.as_tensor(_noise(key, 64, 40)),
                               torch.as_tensor(valid), k).numpy()
        np.testing.assert_array_equal(t, j)
    valid = np.random.RandomState(0).rand(300) < 0.7
    j = np.asarray(jr._sample_indices(key, 128, 8, 300, jnp.asarray(valid)))
    t = tr._sample_indices(torch.as_tensor(_noise(key, 128, 300)),
                           torch.as_tensor(valid), 8).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [1.0, 2.0])
def test_fundamental_ransac_matches_jax(seed, threshold):
    _, p0, p1, valid, _, _ = _scene(seed)
    key = jax.random.PRNGKey(seed)
    j = np.asarray(jr.fundamental_ransac(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid), key,
        threshold=threshold))
    t = tr.fundamental_ransac(
        torch.as_tensor(p0), torch.as_tensor(p1), torch.as_tensor(valid),
        torch.as_tensor(_noise(key, 128, len(p0))),
        threshold=threshold).numpy()
    np.testing.assert_array_equal(t, j)
    assert (t & valid).sum() >= 0.7 * valid.sum()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_matches_jax(seed):
    pts, _, p1, valid, w, t_true = _scene(seed)
    key = jax.random.PRNGKey(10 + seed)
    q_true = tlie.exp_so3_quat(torch.as_tensor(w, dtype=torch.float32))
    q_prior = tlie.quat_mul(q_true, tlie.exp_so3_quat(
        torch.tensor([0.01, -0.008, 0.012])))
    t_prior = torch.as_tensor(t_true + [0.05, -0.04, 0.06],
                              dtype=torch.float32)
    ji, jq, jt = (np.asarray(a) for a in jr.pnp_ransac(
        jnp.asarray(pts), jnp.asarray(p1), jnp.asarray(valid),
        jnp.asarray(q_prior.numpy()), jnp.asarray(t_prior.numpy()),
        jnp.asarray(INTR, jnp.float32), key))
    ti, tq, tt = (a.numpy() for a in tr.pnp_ransac(
        torch.as_tensor(pts), torch.as_tensor(p1), torch.as_tensor(valid),
        q_prior, t_prior, torch.as_tensor(INTR, dtype=torch.float32),
        torch.as_tensor(_noise(key, 64, len(pts)))))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tq, jq, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt, jt, atol=1e-5, rtol=0)
    assert np.linalg.norm(tt - t_true) < 0.02


def test_pnp_ransac_keeps_prior_without_consensus():
    """Fewer than 10 inliers: the gate keeps the validity mask and prior."""
    pts, _, p1, _, _, _ = _scene(4, n=30)
    valid = np.zeros(30, bool)
    valid[:6] = True
    key = jax.random.PRNGKey(5)
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0])
    t0 = torch.zeros(3)
    ji, jq, jt = (np.asarray(a) for a in jr.pnp_ransac(
        jnp.asarray(pts), jnp.asarray(p1), jnp.asarray(valid),
        jnp.asarray(q0.numpy()), jnp.asarray(t0.numpy()),
        jnp.asarray(INTR, jnp.float32), key))
    ti, tq, tt = (a.numpy() for a in tr.pnp_ransac(
        torch.as_tensor(pts), torch.as_tensor(p1), torch.as_tensor(valid),
        q0, t0, torch.as_tensor(INTR, dtype=torch.float32),
        torch.as_tensor(_noise(key, 64, 30))))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti, valid)
    np.testing.assert_array_equal(tq, q0.numpy())
    np.testing.assert_array_equal(tt, jt)


def test_gumbel_noise_is_seeded():
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = tr.gumbel_noise(g1, 128, 300, "cpu")
    b = tr.gumbel_noise(g2, 128, 300, "cpu")
    assert a.shape == (128, 300) and torch.equal(a, b)
    assert torch.isfinite(a).all()
    # standard Gumbel: mean = Euler-Mascheroni constant
    assert abs(float(a.double().mean()) - 0.5772) < 0.02
