"""The port's own copies of the JAX package's host code (sweep cutting,
sweep preparation and wire packing, TUM/ATE tools) and of the
neighbourhood eigen solver give the JAX package's results: the host code
byte for byte, the eigen solver to float32 round-off (2e-5 on unit-scale
eigenvectors; eigenvalues within 1e-5 of their scale)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.config import LivoConfig as JCfg
from sr_livo_tpu.ops import neighborhood as jnb
from sr_livo_tpu.runtime import measurements as jmeas
from sr_livo_tpu.runtime import tum as jtum
from sr_livo_tpu_torch.config import LivoConfig as TCfg
from sr_livo_tpu_torch.ops import neighborhood as tnb
from sr_livo_tpu_torch.runtime import measurements as tmeas
from sr_livo_tpu_torch.runtime import synthetic as tsyn
from sr_livo_tpu_torch.runtime import tum as ttum

RNG = np.random.RandomState(9)


def _cut(mod, sim):
    cutter = mod.SweepCutter(0.1)
    for (t, a, g) in sim.imu:
        cutter.push_imu(t, a, g)
    for c in sim.lidar_chunks:
        cutter.push_points(c)
    for (t, img) in sim.images:
        cutter.push_image(t, img)
    out = []
    while (m := cutter.get()) is not None:
        out.append(m)
    return out


def _cfg(cls):
    cfg = cls()
    cfg.shapes.max_sweep_points = 1024    # small enough to decimate
    cfg.shapes.max_imu_samples = 48
    return cfg


@pytest.fixture(scope="module")
def measurements():
    sim = tsyn.simulate(duration=3.0, n_azimuth=100, n_rings=12, seed=4)
    return _cut(jmeas, sim), _cut(tmeas, sim)


def test_sweep_cutter_matches_jax(measurements):
    jm, tm = measurements
    assert len(tm) == len(jm) > 20
    for a, b in zip(tm, jm):
        assert (a.time_sweep_begin, a.time_image, a.rendering) == (
            b.time_sweep_begin, b.time_image, b.rendering)
        assert a.points.tobytes() == b.points.tobytes()
        assert len(a.imu) == len(b.imu)
        for (ta, aa, ga), (tb, ab, gb) in zip(a.imu, b.imu):
            assert ta == tb and np.array_equal(aa, ab) and np.array_equal(
                ga, gb)


def test_prepare_and_pack_sweep_byte_identical(measurements):
    jm, tm = measurements
    jcfg, tcfg = _cfg(JCfg), _cfg(TCfg)
    cur_j = cur_t = jm[0].time_sweep_begin
    decimated = 0
    for a, b in zip(tm, jm):
        tp = tmeas.prepare_sweep(a, cur_t, tcfg)
        jp = jmeas.prepare_sweep(b, cur_j, jcfg)
        for name in ("raw_pts", "t_rel", "pt_valid", "imu_t", "imu_dt",
                     "imu_acc", "imu_gyr", "imu_valid"):
            x, y = getattr(tp, name), getattr(jp, name)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
        assert (tp.new_current_time, tp.n_points, tp.n_imu) == (
            jp.new_current_time, jp.n_points, jp.n_imu)
        decimated += int(a.points.shape[0] > tcfg.shapes.max_sweep_points)

        # the main path's native pack against the JAX package's, and
        # against the port's plain prepare_sweep + pack_sweep
        t_pack, t_wire, t_time, t_n = tmeas.prepare_sweep_wire(a, cur_t,
                                                               tcfg)
        j_pack, j_wire, j_time, j_n = jmeas.prepare_sweep_wire(b, cur_j,
                                                               jcfg)
        p_wire = tmeas.pack_sweep(tp, a.duration)
        for w in (j_wire, p_wire):
            assert t_wire.pts_q.tobytes() == w.pts_q.tobytes()
            assert (t_wire.scale, t_wire.duration) == (w.scale, w.duration)
        assert t_pack.tobytes() == j_pack.tobytes()
        assert (t_time, t_n) == (j_time, j_n) == (jp.new_current_time,
                                                  jp.n_points)
        np.testing.assert_array_equal(t_pack[:, 0], jp.imu_t)
        cur_t, cur_j = tp.new_current_time, jp.new_current_time
    assert decimated > 0


def test_interpolate_imu_matches_jax(measurements):
    jm, tm = measurements
    cur = jm[0].time_sweep_begin
    for a, b in zip(tm[:10], jm[:10]):
        ts, t_new = tmeas.interpolate_imu(a, cur)
        js, j_new = jmeas.interpolate_imu(b, cur)
        assert t_new == j_new and len(ts) == len(js)
        for x, y in zip(ts, js):
            assert x[:2] == y[:2]
            assert np.array_equal(x[2], y[2]) and np.array_equal(x[3], y[3])
        cur = t_new


def test_tum_tools_match_jax(tmp_path):
    t_gt = np.arange(0.0, 10.0, 0.01)
    p_gt = np.c_[np.sin(t_gt), np.cos(t_gt), 0.1 * t_gt]
    t_est = t_gt[::7] + RNG.uniform(-0.004, 0.004, t_gt[::7].shape)
    yaw = 0.3
    rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                    [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    p_est = (np.c_[np.sin(t_est), np.cos(t_est), 0.1 * t_est] @ rot.T
             + [1.0, -2.0, 0.5] + RNG.randn(len(t_est), 3) * 0.01)
    for align in (True, False):
        assert ttum.ate_rmse(t_est, p_est, t_gt, p_gt, align=align) == \
            jtum.ate_rmse(t_est, p_est, t_gt, p_gt, align=align)
    for x, y in zip(ttum.associate(t_est, t_gt), jtum.associate(t_est, t_gt)):
        np.testing.assert_array_equal(x, y)
    q = RNG.randn(len(t_est), 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ttum.write_tum(str(tmp_path / "t.txt"), t_est, p_est, q)
    jtum.write_tum(str(tmp_path / "j.txt"), t_est, p_est, q)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt"
                                                 ).read_bytes()
    for x, y in zip(ttum.read_tum(str(tmp_path / "t.txt")),
                    jtum.read_tum(str(tmp_path / "t.txt"))):
        np.testing.assert_array_equal(x, y)


def test_eigen_solver_matches_jax():
    """eigvals_sym3x3 / eigvec_for on scatter matrices of planar, linear
    and isotropic point sets, and on exact zeros (the e_z fallback)."""
    pts = RNG.randn(300, 12, 3) * [1.0, 0.6, 0.02]
    pts[100:200] *= [1.0, 0.01, 0.01]
    pts[200:290] = RNG.randn(90, 12, 3)
    pts[290:] = 0.0
    c = pts - pts.mean(1, keepdims=True)
    a = np.einsum("qmi,qmj->qij", c, c).astype(np.float32)
    jl = np.array(jnb.eigvals_sym3x3(jnp.asarray(a)))
    tl = tnb.eigvals_sym3x3(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=1e-5 * np.abs(jl).max())
    jv = np.asarray(jnb.eigvec_for(jnp.asarray(a), jnp.asarray(jl[:, 2])))
    tv = tnb.eigvec_for(torch.as_tensor(a), torch.as_tensor(jl[:, 2])
                        ).numpy()
    sign = np.where((tv * jv).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    planar = slice(0, 100)
    np.testing.assert_allclose((tv * sign)[planar], jv[planar], atol=2e-5,
                               rtol=0)
    np.testing.assert_array_equal(tv[290:], np.tile([0.0, 0.0, 1.0],
                                                    (10, 1)))
    np.testing.assert_array_equal(jv[290:], tv[290:])
