"""The port's map eviction (`voxel_map.remove_far_voxels`, `compact_map`
and the pipeline's eviction hook) against the JAX package's.

On a map the JAX package built (converted to the port): the tombstone
eviction and the slot-reclaiming rebuild give bit-exact keys, sig,
counts, point_ids and n_dropped and exactly equal points, at a radius that
keeps part of the map, at one that keeps all of it, and with a probe
budget so short that voxels are dropped.  End to end, the eviction run of
test_pipeline_lio.py (12 m, every 5 frames) passes that test's bars in the
port, stays within 2e-3 m of the JAX trajectory and stores the JAX
run's number of map points within 0.1%.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.ops import voxel_map as jvm
from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu.pipeline import run_streams as jrun
from sr_livo_tpu.runtime import synthetic as jsyn
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.ops import voxel_map as tvm
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.pipeline import run_streams as trun
from sr_livo_tpu_torch.runtime import tum
from tests.test_pipeline_lio import _small_cfg
from tests.test_torch_pipeline import _port_cfg
from tests.torch_threads import one_intraop_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_map():
    """A 2^12-slot map of 0.5 m voxels over a 24 m box: 3000 voxels, a
    load factor of 0.73, so probe chains are long."""
    rng = np.random.RandomState(8)
    pts = rng.uniform(-12, 12, (6000, 3)).astype(np.float32)
    pts[:, 2] *= 0.05
    m = jvm.make_map(1 << 12, 8)
    m, _ = jvm.insert(m, jnp.asarray(pts), jnp.ones(len(pts), bool),
                      0.5, 0.05, 16)
    return m


def _equal(jm, tm):
    j = convert.voxel_map_to_numpy(convert.voxel_map_from_numpy(jm))
    t = convert.voxel_map_to_numpy(tm)
    for name in ("keys", "sig", "counts", "point_ids", "points"):
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)


def test_remove_far_voxels_matches_jax(jax_map):
    loc = np.array([2.0, -1.0, 0.3], np.float32)
    j = jvm.remove_far_voxels(jax_map, jnp.asarray(loc), 6.0)
    tm = convert.voxel_map_from_numpy(jax_map)
    t = tvm.remove_far_voxels(tm, torch.as_tensor(loc), 6.0)
    _equal(j, t)
    kept = int(t.counts.gt(0).sum())
    assert 0 < kept < int(tm.counts.gt(0).sum())
    assert torch.equal(t.keys, tm.keys)       # tombstones keep their keys


@pytest.mark.parametrize("distance,max_probe", [(6.0, 16), (100.0, 16),
                                                (100.0, 2)])
def test_compact_map_matches_jax(jax_map, distance, max_probe):
    loc = np.array([2.0, -1.0, 0.3], np.float32)
    tm = convert.voxel_map_from_numpy(jax_map)
    before = {k: v.clone() for k, v in tm._asdict().items()}
    t, t_drop = tvm.compact_map(tm, torch.as_tensor(loc), distance=distance,
                                max_probe=max_probe)
    for k, v in tm._asdict().items():         # the old table is untouched
        assert torch.equal(v, before[k]), k
    j, j_drop = jvm.compact_map_impl(jax_map, jnp.asarray(loc),
                                     distance=distance, max_probe=max_probe)
    _equal(j, t)
    assert t_drop.dtype == torch.int32 and int(t_drop) == int(j_drop)
    live = int(t.counts.gt(0).sum())
    if distance < 100:
        assert 0 < live < int(tm.counts.gt(0).sum())
    elif max_probe == 2:
        assert int(t_drop) > 0 and live + int(t_drop) == int(
            tm.counts.gt(0).sum())
    else:
        assert int(t_drop) == 0 and live == int(tm.counts.gt(0).sum())
    # every kept voxel is found again through its probe chain
    keys = t.keys[t.counts > 0]
    assert torch.equal(tvm.lookup(t, keys, max_probe).ge(0),
                       torch.ones(len(keys), dtype=torch.bool))


@pytest.fixture(scope="module")
def eviction_runs():
    sim = jsyn.simulate(duration=10.0, n_azimuth=100, n_rings=12, seed=2)
    runs = []
    for cfg, pipe, run in ((_small_cfg(), JPipe, jrun),
                           (_port_cfg(), TPipe, trun)):
        cfg.enable_map_eviction = True
        cfg.eviction_every_n_frames = 5
        cfg.odometry_options.max_distance = 12.0
        kw = {} if pipe is JPipe else {"device": "cpu"}
        runs.append(run(pipe(cfg, **kw), sim))
    return sim, runs[0], runs[1]


def test_eviction_run_matches_jax(eviction_runs):
    sim, jp, tp = eviction_runs
    assert tp.initialized
    recs = tp.records
    assert sum(r.success for r in recs) > 0.9 * len(recs)
    n_vox = int(tvm.map_size(tp.voxel_map))
    assert 0 < n_vox < (2 * 12.0 / 0.6) ** 3
    # the stored point counts differ by round-off at the insert's distance
    # gate (9 of 22237 when this test was written)
    assert abs(n_vox - int(jvm.map_size(jp.voxel_map))) <= 1e-3 * n_vox
    ts, ps, _ = tp.trajectory()
    ate = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
    assert ate < 0.10, f"eviction-enabled ATE {ate:.3f} m"
    jt, jps, _ = jp.trajectory()
    np.testing.assert_array_equal(ts, jt)
    assert np.linalg.norm(ps - jps, axis=-1).max() < 2e-3
    assert int(tp._evict_dropped) == int(jp._evict_dropped) == 0
