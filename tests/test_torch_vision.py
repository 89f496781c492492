"""The port's full LIVO loop (sr_livo_tpu_torch.models.vision attached to
the port's LivoPipeline) against the JAX package's, end to end on the
synthetic run of test_vision_pipeline.py (7 s, 120 x 160 images).

Both pipelines replay the same streams (rendered by the JAX package's
numpy simulator) with the same configuration, and the port's RANSAC gates
get the JAX key chain's Gumbel draws through the vision module's noise
hook.  Bars against the JAX run: the trajectory within 2 mm at every frame
(the LIO port's bar), per-frame kept tracks within 5%, final intrinsics
within 0.5 px, `td` within 1e-3 s, the colored-point count within 2%; the
port's run also passes the absolute bars of test_vision_pipeline.py.  The
port's renderer (a torch float64 path) matches the JAX package's numpy
renderer.  test_torch_vision_port.py runs the port alone on its own images.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from sr_livo_tpu.models.vision import VisionModule as JVision
from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu.pipeline import run_streams as jrun
from sr_livo_tpu.runtime import synthetic as jsyn
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.config import LivoConfig as TCfg
from sr_livo_tpu_torch.models.vision import VisionModule as TVision
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.pipeline import run_streams as trun
from sr_livo_tpu_torch.runtime import synthetic as tsyn
from sr_livo_tpu_torch.runtime import tum
from sr_livo_tpu_torch.runtime.pcd import load_pcd_xyz, save_color_points
from sr_livo_tpu_torch.utils import lie
from tests.test_torch_pipeline import _copy_cfg
from tests.test_vision_pipeline import CAM, SIZE, _cfg
from tests.torch_threads import one_intraop_thread  # noqa: F401

SIM = dict(duration=7.0, n_azimuth=100, n_rings=12, seed=6,
           image_size=SIZE, camera=CAM)
R_CFG = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], float)


def _port_cfg(jcfg=None):
    jcfg = jcfg or _cfg()
    cfg = _copy_cfg(TCfg(), jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return cfg


class JaxKeyChain:
    """The JAX vision module's RANSAC draws: PRNGKey(7), split three ways
    per vision step (key_next, key_f, key_pnp)."""

    def __init__(self):
        self.key = jax.random.PRNGKey(7)

    def __call__(self, n_f, n_pnp, m):
        self.key, key_f, key_pnp = jax.random.split(self.key, 3)
        return (np.array(jax.random.gumbel(key_f, (n_f, m))),
                np.array(jax.random.gumbel(key_pnp, (n_pnp, m))))


@pytest.fixture(scope="module")
def sim():
    return jsyn.simulate(**SIM)


@pytest.fixture(scope="module")
def runs(sim):
    jv = JVision(_cfg())
    jp = jrun(JPipe(_cfg(), vision=jv), sim)
    cfg = _port_cfg()
    tv = TVision(cfg, device="cpu", noise_hook=JaxKeyChain())
    tp = trun(TPipe(cfg, vision=tv, device="cpu"), sim)
    return jp, jv, tp, tv


def test_trajectory_matches_jax(sim, runs):
    jp, _, tp, _ = runs
    assert tp.initialized
    tt, tpos, tq = tp.trajectory()
    jt, jpos, jq = jp.trajectory()
    np.testing.assert_array_equal(tt, jt)
    gap = np.linalg.norm(tpos - jpos, axis=1).max()
    assert gap <= 2e-3, f"max position gap to JAX {gap:.2e} m"
    assert np.abs(tq - jq).max() < 1e-3
    ate = tum.ate_rmse(tt, tpos, sim.gt_times, sim.gt_pos, align=True)
    assert ate < 0.05, f"LIVO ATE {ate:.3f} m"


def test_tracks_match_jax(runs):
    _, jv, _, tv = runs
    tstats, jstats = tv.stats, jv.stats
    assert [s[0] for s in tstats] == [s[0] for s in jstats]
    assert len(tstats) > 10
    kept_t = np.array([s[1] for s in tstats])
    kept_j = np.array([s[1] for s in jstats])
    assert np.all(np.abs(kept_t - kept_j) <= 0.05 * kept_j), (kept_t, kept_j)
    # the absolute bars of test_vision_pipeline.py
    assert kept_t[5:].mean() > 30, kept_t
    inliers = np.array([s[2] for s in tstats])
    assert inliers[5:].mean() > 20, inliers


def test_camera_matches_jax(runs):
    _, jv, _, tv = runs
    intr = tv.camera.intr.numpy()
    assert np.abs(intr - np.asarray(jv.camera.intr)).max() < 0.5
    assert abs(float(tv.camera.td) - float(jv.camera.td)) < 1e-3
    assert abs(intr[0] - CAM[0]) < 10.0 and abs(intr[1] - CAM[1]) < 10.0
    assert abs(float(tv.camera.td)) < 0.05
    r_ic = lie.quat_to_rot(tv.camera.q_ic).double().numpy()
    ang = np.degrees(np.arccos(np.clip(
        (np.trace(r_ic @ R_CFG.T) - 1) / 2, -1, 1)))
    assert ang < 5.0, ang


def test_colored_map_matches_jax(runs):
    _, jv, _, tv = runs
    t_col = (tv.color_map.reg_valid & (tv.color_map.n_rgb >= 3)).numpy()
    j_col = np.asarray(jv.color_map.reg_valid) & (
        np.asarray(jv.color_map.n_rgb) >= 3)
    assert abs(int(t_col.sum()) - int(j_col.sum())) <= 0.02 * j_col.sum()
    assert t_col.sum() > 500, t_col.sum()
    pos = tv.color_map.pos.numpy()[t_col]
    got = tv.color_map.rgb.numpy()[t_col] / 255.0
    err = np.abs(got - tsyn.SyntheticWorld().color(pos))
    err_c = np.abs(err - np.median(err, axis=0, keepdims=True))
    assert np.median(err_c) < 0.15, np.median(err_c)


def test_colored_pcd_export(runs, tmp_path):
    _, _, _, tv = runs
    path = str(tmp_path / "rgb_map.pcd")
    n = save_color_points(tv.color_map, path, minimum_views=3)
    assert n > 500
    rows = load_pcd_xyz(path)
    assert rows.shape == (n, 4)
    with open(path, "rb") as f:
        head = f.read(200).decode("ascii", errors="ignore")
    assert "POINTS" in head and "rgb" in head


def test_convert_roundtrips_camera_and_tracks(runs):
    _, jv, _, tv = runs
    cam = convert.camera_state_from_numpy(jv.camera)
    for name, v in convert.camera_state_to_numpy(cam).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jv.camera,
                                                            name)))
    tracks = convert.tracks_from_numpy(jv.tracks)
    for name, v in convert.tracks_to_numpy(tracks).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jv.tracks,
                                                            name)))
    back = convert.tracks_from_numpy(convert.tracks_to_numpy(tv.tracks))
    for a, b in zip(back, tv.tracks):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_renderer_matches_numpy():
    """The torch float64 renderer (here on the CPU) against the JAX
    package's numpy renderer, with lens distortion and a camera offset."""
    cam = (52.0, 50.0, 40.0, 30.0)
    dist = [-0.28, 0.07, 8e-4, -2e-4, 0.0]
    kw = dict(r_imu_camera=R_CFG, t_imu_camera=[0.05, 0.047, -0.031],
              dist_coeffs=dist)
    jw, jt = jsyn.SyntheticWorld(), jsyn.Trajectory()
    tw, tt = tsyn.SyntheticWorld(), tsyn.Trajectory()
    for t in (0.3, 6.1):
        j = jsyn.render_image(jw, jt, t, cam, (60, 80), **kw)
        p = tsyn.render_image(tw, tt, t, cam, (60, 80), device="cpu", **kw)
        assert p.dtype == j.dtype and p.shape == j.shape
        np.testing.assert_array_equal(np.any(p != 0, -1), np.any(j != 0, -1))
        np.testing.assert_allclose(p, j, atol=1e-6, rtol=0)
        assert np.any(j != 0, -1).mean() > 0.9
    rng = np.random.RandomState(2)
    o = rng.uniform(-2, 2, (500, 3)) + [0, 0, 1.2]
    d = rng.randn(500, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pj, hj, _ = jw.raycast(o, d)
    pt, ht = tw.raycast_torch(torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(ht.numpy(), hj)
    np.testing.assert_allclose(pt.numpy()[hj], pj[hj], atol=1e-9, rtol=0)


def test_simulated_streams_match_jax():
    kw = dict(duration=1.2, n_azimuth=40, n_rings=8, seed=4,
              image_size=(30, 40), camera=(26.0, 25.0, 20.0, 15.0),
              dist_coeffs=[-0.1, 0.02, 0, 0, 0], cam_time_offset=0.01)
    jsim = jsyn.simulate(**kw)
    tsim = tsyn.simulate(**kw, device="cpu")
    for (tt_, ta, tg), (jt_, ja, jg) in zip(tsim.imu, jsim.imu):
        assert tt_ == jt_ and ta.tobytes() == ja.tobytes() \
            and tg.tobytes() == jg.tobytes()
    for a, b in zip(tsim.lidar_chunks, jsim.lidar_chunks):
        assert a.tobytes() == b.tobytes()
    assert [t for t, _ in tsim.images] == [t for t, _ in jsim.images]
    for (_, a), (_, b) in zip(tsim.images, jsim.images):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_vision_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError):
        TVision(_port_cfg())
    with pytest.raises(RuntimeError):
        tsyn.simulate(duration=0.5, image_size=(8, 8),
                      camera=(8.0, 8.0, 4.0, 4.0))
