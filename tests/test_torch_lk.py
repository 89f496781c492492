"""Parity of the port's pyramidal LK tracker (sr_livo_tpu_torch.ops.lk)
with the JAX package's.

Both packages track the same points between the same two frames (a
translated texture with flat and border regions, with and without an
initial-flow seed).  Track status agrees on at least 99% of the tracks and
the tracked positions within 1e-3 px where both succeed.  The port runs a
fixed number of masked Gauss-Newton iterations where the JAX package
leaves its loop once no point is live; a level run to convergence gives
the same result either way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.ops import lk as jlk
from sr_livo_tpu_torch.ops import lk as tlk
from tests.test_image_lk import _texture
from tests.torch_threads import one_intraop_thread  # noqa: F401

RNG = np.random.RandomState(17)


def _frames(h=120, w=160, shift=(3.7, -2.4)):
    """prev/cur with a flat band (rank-deficient windows fail the
    eigenvalue gate) and a translated texture."""
    prev, cur = _texture(h, w), _texture(h, w, shift=shift)
    prev[:, :25] = 90.0
    cur[:, :25] = 90.0
    return prev, cur


def _pyramids(prev, cur, levels=3):
    jp = jlk.precompute_frame(jnp.asarray(prev), levels)
    jc = jlk.precompute_frame(jnp.asarray(cur), levels)
    tp = tlk.precompute_frame(torch.as_tensor(prev), levels)
    tc = tlk.precompute_frame(torch.as_tensor(cur), levels)
    return jp, jc, tp, tc


def _points(n, h, w):
    """Interior points, points near every border and in the flat band."""
    pts = np.c_[RNG.uniform(0, w, n), RNG.uniform(0, h, n)]
    pts[:20, 0] = RNG.uniform(-2, 12, 20)
    pts[20:40, 1] = RNG.uniform(h - 12, h + 2, 20)
    return pts.astype(np.float32)


@pytest.mark.parametrize("seeded", [False, True])
def test_track_pyramidal_matches_jax(seeded):
    prev, cur = _frames()
    (jpyr, jdx, jdy), (jcur, _, _), (tpyr, tdx, tdy), (tcur, _, _) = \
        _pyramids(prev, cur)
    pts = _points(300, *prev.shape)
    valid = RNG.rand(300) < 0.9
    flow = (np.array([3.0, -2.0]) + RNG.randn(300, 2)).astype(np.float32) \
        if seeded else None
    jout, jst = jlk.track_pyramidal(
        jpyr, jcur, jdx, jdy, jnp.asarray(pts), jnp.asarray(valid),
        jlk.LkParams(), init_flow=None if flow is None else jnp.asarray(flow))
    tout, tst = tlk.track_pyramidal(
        tpyr, tcur, tdx, tdy, torch.as_tensor(pts), torch.as_tensor(valid),
        tlk.LkParams(),
        init_flow=None if flow is None else torch.as_tensor(flow))
    jout, jst = np.asarray(jout), np.asarray(jst)
    tout, tst = tout.numpy(), tst.numpy()
    assert np.mean(tst == jst) >= 0.99
    both = tst & jst
    assert both.sum() > 120
    np.testing.assert_allclose(tout[both], jout[both], atol=1e-3, rtol=0)
    # and the tracker is right: the texture moved by the shift
    err = np.linalg.norm(tout[both] - (pts[both] + [3.7, -2.4]), axis=-1)
    assert np.median(err) < 0.3


@pytest.mark.parametrize("iters", [10, 40])
def test_fixed_iterations_match_early_exit(iters):
    """One level, points starting 1-2 px off: every point stops moving
    (|delta| < eps) within a few iterations, so the JAX loop exits early
    while the port runs all `iters`; the results agree."""
    prev, cur = _frames(shift=(1.3, 0.8))
    (jpyr, jdx, jdy), (jcur, _, _), (tpyr, tdx, tdy), (tcur, _, _) = \
        _pyramids(prev, cur, levels=0)
    pts = np.c_[RNG.uniform(40, 140, 200), RNG.uniform(20, 100, 200)] \
        .astype(np.float32)
    guess = pts + RNG.uniform(0.5, 2.0, (200, 2)).astype(np.float32)
    valid = np.ones(200, bool)
    params = (jlk.LkParams(iters=iters), tlk.LkParams(iters=iters))
    jg, jok, jeig = jlk._track_level(
        jpyr[0], jcur[0], jdx[0], jdy[0], jnp.asarray(pts),
        jnp.asarray(guess), jnp.asarray(valid), params[0])
    tg, tok, teig = tlk._track_level(
        tpyr[0], tcur[0], tdx[0], tdy[0], torch.as_tensor(pts),
        torch.as_tensor(guess), torch.as_tensor(valid), params[1])
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(teig.numpy(), np.asarray(jeig), rtol=1e-4,
                               atol=1e-6)
    ok = tok.numpy()
    assert ok.sum() > 150
    np.testing.assert_allclose(tg.numpy()[ok], np.asarray(jg)[ok],
                               atol=1e-3, rtol=0)
    if iters == 40:
        # converged: ten iterations already give the same positions
        t10, _, _ = tlk._track_level(
            tpyr[0], tcur[0], tdx[0], tdy[0], torch.as_tensor(pts),
            torch.as_tensor(guess), torch.as_tensor(valid),
            tlk.LkParams(iters=10))
        np.testing.assert_array_equal(t10.numpy()[ok], tg.numpy()[ok])
