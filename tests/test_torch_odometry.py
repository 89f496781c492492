"""Parity of the port's per-sweep LIO step (sr_livo_tpu_torch.models.
odometry.LioEngine) with the JAX package's, on a short synthetic run.

Each package cuts the streams, initialises its filter from the static
IMU start and then runs its own engine in closed loop on the same sweeps;
the frame ids and a gyro-rate schedule drive the engines through all
three phases: `init`, `steady` and `steady_dense`.  The packed record
rows must agree: success, IEKF iterations and residual counts equal;
position within 5e-5 m, quaternion within 1e-6, velocity within 5e-4
m/s and the biases within 5e-5 (measured on this run: 4.4e-6 m, 1.0e-7,
5.1e-5 m/s, 4.1e-6; float32 round-off carried through 12 closed-loop
sweeps).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.config import LivoConfig as JCfg
from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu.runtime import synthetic as jsyn
from sr_livo_tpu_torch.config import LivoConfig as TCfg
from sr_livo_tpu_torch.models import odometry as todo
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.runtime import synthetic as tsyn

N_FRAMES = 12


def _cfg(cls, cache_association, retry=False):
    cfg = cls()
    o = cfg.odometry_options
    o.voxel_size = o.init_voxel_size = 0.2
    o.sample_voxel_size = o.init_sample_voxel_size = 0.8
    o.min_distance_points = 0.05
    o.init_num_frames = 4
    cfg.icp.init_num_frames = 4
    cfg.icp.size_voxel_map = 0.6
    cfg.icp.min_number_neighbors = 12
    cfg.icp.max_num_residuals = 600
    cfg.icp.num_iters_icp = 5
    cfg.shapes.max_sweep_points = 2048
    cfg.shapes.max_frame_points = 2048
    cfg.shapes.max_keypoints = 512
    cfg.shapes.max_imu_samples = 48
    cfg.shapes.map_capacity = 1 << 15
    cfg.shapes.query_chunk = 256
    cfg.adaptive_keypoint_density = True
    cfg.cache_association = cache_association
    # re-run weak solves (< icp.min_num_residuals = 100 rows) one voxel
    # ring wider: most steady sweeps of this small run are weak
    cfg.retry_wider_neighborhood = retry
    return cfg


def _gyr_rate(cfg, k):
    """Frames 8 and 9 after init run the dense-keypoint variant."""
    return cfg.dense_gyr_threshold + 1.0 if k in (8, 9) else 0.0


def _drive(pipe, sim, n_frames):
    """Cut `sim`, initialise the filter, then step the engine directly on
    `n_frames` sweeps; returns the (19,) record rows and the phases."""
    for (t, a, g) in sim.imu:
        pipe.push_imu(t, a, g)
    for c in sim.lidar_chunks:
        pipe.push_points(c)
    for (t, img) in sim.images:
        pipe.push_image(t, img)
    rows, phases = [], []
    while len(rows) < n_frames:
        meas = pipe.cutter.get()
        assert meas is not None, "stream ended before enough frames"
        if not pipe._init_or_skip(meas):
            continue
        k = pipe.index_frame
        prepared = pipe._host_prepare_measurement(meas, k)
        out = pipe.engine.step(pipe.state, pipe.voxel_map, prepared[2], k,
                               gyr_rate=_gyr_rate(pipe.cfg, k))
        pipe.state, pipe.voxel_map = out.state, out.voxel_map
        pipe.index_frame += 1
        rows.append(np.asarray(out.record, np.float64))
        phases.append(pipe.engine.phase(k, _gyr_rate(pipe.cfg, k))
                      if isinstance(pipe, TPipe) else None)
    return np.stack(rows), phases


@pytest.fixture(scope="module")
def sims():
    kw = dict(duration=4.7, n_azimuth=80, n_rings=10, seed=5)
    return jsyn.simulate(**kw), tsyn.simulate(**kw)


@pytest.mark.parametrize("cache_association,retry", [
    (True, False), (False, False), (True, True)])
def test_lio_engine_records_match_jax(sims, cache_association, retry):
    jsim, tsim = sims
    j_rows, _ = _drive(JPipe(_cfg(JCfg, cache_association, retry)), jsim,
                       N_FRAMES)
    t_rows, phases = _drive(TPipe(_cfg(TCfg, cache_association, retry),
                                  device="cpu"), tsim, N_FRAMES)
    assert set(phases) == {"init", "steady", "steady_dense"}, phases

    # [p(3), q(4), v(3), ba(3), bg(3), success, n_residuals, iters]
    np.testing.assert_array_equal(t_rows[:, 16], j_rows[:, 16])
    assert t_rows[:, 16].all()
    np.testing.assert_array_equal(t_rows[:, 18], j_rows[:, 18])
    np.testing.assert_array_equal(t_rows[:, 17], j_rows[:, 17])
    assert (t_rows[1:, 17] > 50).all()
    np.testing.assert_allclose(t_rows[:, 0:3], j_rows[:, 0:3], atol=5e-5,
                               rtol=0)
    np.testing.assert_allclose(t_rows[:, 3:7], j_rows[:, 3:7], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(t_rows[:, 7:10], j_rows[:, 7:10], atol=5e-4,
                               rtol=0)
    np.testing.assert_allclose(t_rows[:, 10:16], j_rows[:, 10:16],
                               atol=5e-5, rtol=0)


def test_unpack_wire_matches_jax():
    from sr_livo_tpu.models import odometry as jodo
    rng = np.random.RandomState(4)
    pts_q = rng.randint(-32000, 32000, (300, 4)).astype(np.int16)
    pts_q[250:, 3] = -1
    imu = rng.randn(20, 9).astype(np.float32)
    imu[:, 8] = rng.rand(20) < 0.7
    meta = np.array([2e-3, 0.1, 1.0, 3.0], np.float32)
    j = jodo.unpack_wire(jodo.WireSweep(jnp.asarray(pts_q), jnp.asarray(imu),
                                        jnp.asarray(meta)))
    t = todo.unpack_wire(todo.WireSweep(torch.as_tensor(pts_q),
                                        torch.as_tensor(imu),
                                        torch.as_tensor(meta)))
    for name in todo.SweepInput._fields:
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-7,
                                   atol=0, err_msg=name)
