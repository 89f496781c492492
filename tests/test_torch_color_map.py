"""Parity of the port's colored map (sr_livo_tpu_torch.ops.color_map) with
the JAX package's.

The same insert sequences go through both packages: clustered and
scattered clouds, repeats (dedup hits), a budget below the dedup winners,
and saturation of the registry, the dedup set and the recent-slot list.
After every insert the dedup signatures, the claimed voxel slots (keys,
signatures, counts, points, registry ids), the registry rows, `count`,
`recent_slots`, the visit stamps and `n_new_visited` are bit-exact.  The
Bayesian color update and the renderer agree within 1e-4 on rgb and
covariance with `n_rgb` exact, and the track-candidate selection returns
the same ids and mask.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.ops import color_map as jcm
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.ops import color_map as tcm
from tests.torch_threads import one_intraop_thread  # noqa: F401

INSERT = dict(voxel_size=0.1, min_distance=0.01, max_probe=16)
INTR = np.array([100.0, 100.0, 80.0, 60.0], np.float32)


def _assert_maps_equal(tmap, jmap):
    got = convert.color_map_to_numpy(tmap)
    for name in ("reg", "count", "vox_last_visit", "dedup_sig",
                 "recent_slots"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jmap,
                                                                    name)),
                                      err_msg=name)
    for name, v in got["vox"].items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jmap.vox, name)),
                                      err_msg=f"vox.{name}")


def _insert_both(jm, tm, pts, valid, t, **kw):
    kw = dict(INSERT, **kw)
    jm, jn = jcm.color_insert(jm, jnp.asarray(pts), jnp.asarray(valid),
                              np.float32(t), **kw)
    tm, tn = tcm.color_insert(tm, torch.as_tensor(pts),
                              torch.as_tensor(valid),
                              torch.tensor(t, dtype=torch.float32), **kw)
    assert int(tn) == int(jn)
    _assert_maps_equal(tm, jm)
    return jm, tm


def _batches(rng):
    """Points on a z = 5 plane in front of the test camera (many per 0.1 m
    voxel), a scattered cloud, a near-repeat of the first batch, and the
    plane again one sweep later."""
    plane = np.c_[rng.uniform(-1.5, 1.5, (600, 2)), np.full(600, 5.0)]
    scatter = np.c_[rng.uniform(-3, 3, (400, 2)), rng.uniform(2, 9, 400)]
    repeat = plane[:300] + 1e-4
    plane2 = np.c_[rng.uniform(-1.5, 1.5, (500, 2)), np.full(500, 5.02)]
    return [b.astype(np.float32) for b in (plane, scatter, repeat, plane2)]


@pytest.fixture(scope="module")
def maps():
    rng = np.random.RandomState(9)
    jm = jcm.make_color_map(4096, 1 << 12, 20, recent=256)
    tm = tcm.make_color_map(4096, 1 << 12, 20, recent=256)
    for i, b in enumerate(_batches(rng)):
        valid = rng.rand(b.shape[0]) < 0.95
        budget = 128 if i == 1 else None
        jm, tm = _insert_both(jm, tm, b, valid, 1.0 + 0.1 * i,
                              budget=budget)
    return jm, tm


def test_insert_sequence_bit_exact(maps):
    jm, tm = maps
    _assert_maps_equal(tm, jm)
    assert int(tm.reg_valid.sum()) > 500
    assert int((tm.recent_slots >= 0).sum()) > 50


@pytest.mark.parametrize("case", ["registry", "dedup", "recent"])
def test_insert_saturation_bit_exact(case):
    """Registry exhaustion (ids beyond capacity), a full dedup set (probe
    chains exhausted) and more touched voxels than recent slots."""
    rng = np.random.RandomState({"registry": 1, "dedup": 2,
                                 "recent": 3}[case])
    if case == "registry":
        shape, kw = (256, 1 << 10, 20), dict(recent=2048)
    elif case == "dedup":
        shape, kw = (64, 1 << 5, 4), dict(recent=2048)
    else:
        shape, kw = (4096, 1 << 12, 8), dict(recent=16)
    jm = jcm.make_color_map(*shape, **kw)
    tm = tcm.make_color_map(*shape, **kw)
    for k in range(5):
        pts = np.c_[rng.uniform(-1.5, 1.5, (128, 2)),
                    rng.uniform(2.0, 8.0, 128)].astype(np.float32)
        extra = (dict(voxel_size=0.5, min_distance=0.05, max_probe=8)
                 if case == "dedup" else {})
        jm, tm = _insert_both(jm, tm, pts, np.ones(128, bool), float(k),
                              **extra)


def _camera():
    q_cw = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    zero = np.zeros(3, np.float32)
    return q_cw, zero, zero


def test_update_rgb_matches_jax(maps):
    jm, tm = maps
    rng = np.random.RandomState(4)
    ids = rng.choice(600, 200, replace=False).astype(np.int32)
    mask = rng.rand(200) < 0.9
    for t in (2.0, 2.5, 3.5):
        obs = rng.uniform(0, 255, (200, 3)).astype(np.float32)
        dist = rng.uniform(3.0, 8.0, 200).astype(np.float32)
        jm = jcm.update_rgb(jm, jnp.asarray(ids), jnp.asarray(obs),
                            jnp.asarray(dist), t, jnp.asarray(mask))
        tm = tcm.update_rgb(tm, torch.as_tensor(ids), torch.as_tensor(obs),
                            torch.as_tensor(dist), t, torch.as_tensor(mask))
        np.testing.assert_array_equal(tm.n_rgb.numpy(), np.asarray(jm.n_rgb))
        np.testing.assert_allclose(tm.reg.numpy(), np.asarray(jm.reg),
                                   atol=1e-4, rtol=0)


ACCESSORS = ("pos", "rgb", "cov_rgb", "n_rgb", "obs_dist", "last_obs_time",
             "img_vel", "outlier_count", "reg_valid")


@pytest.mark.parametrize("name", ACCESSORS)
def test_column_accessors_match_jax(maps, name):
    """Every column view of the registry, values and dtype, on the
    inserted map's registry with each column set: random observation
    distances, times, image velocities and outlier counts."""
    jm, tm = maps
    rng = np.random.RandomState(21)
    reg = np.asarray(jm.reg).copy()
    n = reg.shape[0]
    reg[:, tcm.C_DIST] = rng.uniform(1.0, 9.0, n)
    reg[:, tcm.C_TIME] = rng.uniform(0.0, 60.0, n)
    reg[:, tcm.C_VEL] = rng.uniform(-40.0, 40.0, (n, 2))
    reg[:, tcm.C_OUT] = rng.randint(0, 9, n)
    want = np.asarray(getattr(jm._replace(reg=jnp.asarray(reg)), name))
    got = getattr(tm._replace(reg=torch.as_tensor(reg)), name).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_render_and_select_match_jax(maps):
    jm, tm = maps
    q_cw, t_cw, t_wc = _camera()
    us = np.arange(160, dtype=np.float32)
    img = (np.tile(us[None, :, None], (120, 1, 3))
           + np.arange(120, dtype=np.float32)[:, None, None] * [0, 1, 0.5])
    for t in (3.0, 3.1):
        jm = jcm.render_recent(jm, jnp.asarray(img), jnp.asarray(q_cw),
                               jnp.asarray(t_cw), jnp.asarray(t_wc),
                               jnp.asarray(INTR), t, cols=160, rows=120,
                               max_render_points=512)
        tm = tcm.render_recent(tm, torch.as_tensor(img),
                               torch.as_tensor(q_cw), torch.as_tensor(t_cw),
                               torch.as_tensor(t_wc), torch.as_tensor(INTR),
                               t, cols=160, rows=120, max_render_points=512)
        np.testing.assert_array_equal(tm.n_rgb.numpy(), np.asarray(jm.n_rgb))
        np.testing.assert_allclose(tm.rgb.numpy(), np.asarray(jm.rgb),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(tm.cov_rgb.numpy(), np.asarray(jm.cov_rgb),
                                   atol=1e-4, rtol=0)
    assert int((tm.n_rgb > 0).sum()) > 300

    for grid, max_out in ((10, 256), (4, 300)):
        jids, juv, jok = (np.asarray(a) for a in
                          jcm.select_points_for_projection(
                              jm, jnp.asarray(q_cw), jnp.asarray(t_cw),
                              jnp.asarray(t_wc), jnp.asarray(INTR), 3.1,
                              max_out=max_out, cols=160, rows=120,
                              grid_px=grid))
        tids, tuv, tok = (a.numpy() for a in tcm.select_points_for_projection(
            tm, torch.as_tensor(q_cw), torch.as_tensor(t_cw),
            torch.as_tensor(t_wc), torch.as_tensor(INTR), max_out=max_out,
            cols=160, rows=120, grid_px=grid))
        np.testing.assert_array_equal(tok, jok)
        np.testing.assert_array_equal(tids[tok], jids[jok])
        np.testing.assert_allclose(tuv[tok], juv[jok], atol=1e-4, rtol=0)
        assert tok.sum() > 20


def test_convert_roundtrips_color_map(maps):
    jm, tm = maps
    again = convert.color_map_from_numpy(jm)
    _assert_maps_equal(again, jm)
    back = convert.color_map_from_numpy(convert.color_map_to_numpy(tm))
    for name in ("reg", "count", "dedup_sig", "recent_slots"):
        assert torch.equal(getattr(back, name), getattr(tm, name))
    for a, b in zip(back.vox, tm.vox):
        assert torch.equal(a, b)
