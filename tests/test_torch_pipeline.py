"""The port's LIO-only pipeline (sr_livo_tpu_torch.pipeline) against the
JAX package's, end to end on the synthetic run of test_pipeline_lio.py.

Both pipelines replay the same streams with the same configuration.  The
port must track as the reference does (ATE < 0.05 m, at most 2 failed
registrations) and stay within 2 mm of the JAX trajectory at every frame
(0.27 mm measured when this test was written: float32 round-off carried
through ~70 closed-loop sweeps).  The port's own simulator must produce
the JAX simulator's streams byte for byte, the configuration must load
the same, and `convert` must round-trip filter state.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from sr_livo_tpu import config as jconfig
from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu.pipeline import run_streams as jrun
from sr_livo_tpu.runtime import synthetic as jsyn
from sr_livo_tpu_torch import config as tconfig
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.pipeline import run_streams as trun
from sr_livo_tpu_torch.runtime import synthetic as tsyn
from sr_livo_tpu_torch.runtime import tum
from tests.test_pipeline_lio import _small_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_GAP_M = 2e-3
SIM = dict(duration=10.0, n_azimuth=100, n_rings=12, seed=2)


def _copy_cfg(dst, src):
    for f in dataclasses.fields(src):
        v = getattr(src, f.name)
        if dataclasses.is_dataclass(v):
            _copy_cfg(getattr(dst, f.name), v)
        else:
            setattr(dst, f.name, v)
    return dst


def _port_cfg():
    """The port's twin of test_pipeline_lio's `_small_cfg()`."""
    cfg = _copy_cfg(tconfig.LivoConfig(), _small_cfg())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_small_cfg())
    return cfg


@pytest.fixture(scope="module")
def sims():
    return jsyn.simulate(**SIM), tsyn.simulate(**SIM)


@pytest.fixture(scope="module")
def runs(sims):
    jsim, tsim = sims
    jp = jrun(JPipe(_small_cfg()), jsim)
    tp = trun(TPipe(_port_cfg(), device="cpu"), tsim)
    return jp, tp


def test_simulator_streams_byte_identical(sims):
    jsim, tsim = sims
    assert len(tsim.imu) == len(jsim.imu)
    for (tt, ta, tg), (jt, ja, jg) in zip(tsim.imu, jsim.imu):
        assert tt == jt
        assert ta.tobytes() == ja.tobytes() and tg.tobytes() == jg.tobytes()
    assert len(tsim.lidar_chunks) == len(jsim.lidar_chunks)
    for a, b in zip(tsim.lidar_chunks, jsim.lidar_chunks):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert [t for t, _ in tsim.images] == [t for t, _ in jsim.images]
    for name in ("gt_times", "gt_pos", "gt_quat"):
        assert getattr(tsim, name).tobytes() == getattr(jsim, name).tobytes()


@pytest.mark.parametrize("name", [None, "r3live.yaml",
                                  "r3live_compressed.yaml", "ntu.yaml"])
def test_config_matches_jax(name):
    if name is None:
        t, j = tconfig.LivoConfig(), jconfig.LivoConfig()
    else:
        path = os.path.join(REPO, "configs", name)
        t, j = tconfig.load_config(path), jconfig.load_config(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.icp == t.odometry_options.optimize_options


def test_pipeline_tracks_like_jax(sims, runs):
    jsim, tsim = sims
    jp, tp = runs
    assert tp.initialized and len(tp.records) > 40
    assert sum(1 for r in tp.records if not r.success) <= 2

    tt, tpos, tq = tp.trajectory()
    jt, jpos, jq = jp.trajectory()
    ate = tum.ate_rmse(tt, tpos, tsim.gt_times, tsim.gt_pos, align=True)
    assert ate < 0.05, f"ATE RMSE {ate:.4f} m"

    np.testing.assert_array_equal(tt, jt)
    gap = np.linalg.norm(tpos - jpos, axis=1).max()
    assert gap < MAX_GAP_M, f"max position gap to JAX {gap:.2e} m"
    assert np.abs(tq - jq).max() < 1e-3
    assert [r.iterations for r in tp.records] == [r.iterations
                                                  for r in jp.records]
    assert [r.success for r in tp.records] == [r.success for r in jp.records]


def test_pipelined_host_path_matches_serial(sims):
    """The feeder-thread path reorders host work only: records equal the
    serial path's bit for bit."""
    _, tsim = sims
    cutter_pipe = TPipe(_port_cfg(), device="cpu")
    for (t, a, g) in tsim.imu:
        cutter_pipe.push_imu(t, a, g)
    for c in tsim.lidar_chunks:
        cutter_pipe.push_points(c)
    for (t, img) in tsim.images:
        cutter_pipe.push_image(t, img)
    meas = []
    while len(meas) < 45:
        meas.append(cutter_pipe.cutter.get())
    serial = TPipe(_port_cfg(), device="cpu")
    for m in meas:
        serial._process_measurement(m)
    piped = TPipe(_port_cfg(), device="cpu")
    assert piped.process_measurements(meas) == len(meas)
    rs, rp = serial.records, piped.records
    assert len(rs) == len(rp) > 10
    for a, b in zip(rs, rp):
        np.testing.assert_array_equal(a.position, b.position)
        np.testing.assert_array_equal(a.quat_wxyz, b.quat_wxyz)
        assert a.time == b.time and a.success == b.success


def test_outputs_written(runs, tmp_path):
    _, tp = runs
    tp.write_outputs(str(tmp_path))
    t, p, q = tum.read_tum(str(tmp_path / "pose.txt"))
    assert t.shape[0] == len(tp.records)
    np.testing.assert_allclose(p, tp.trajectory()[1], atol=1e-8)
    assert np.allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-5)


def test_retired_poses_match_unretired_run(sims, runs, tmp_path):
    """Frame retirement (keep 2 live frames after init, append the rest to
    the output files in batches) writes the unretired run's poses."""
    _, tsim = sims
    _, base = runs
    cfg = _port_cfg()
    cfg.output_path = str(tmp_path)
    cfg.retire_frames = True
    cfg.retire_batch = 8
    pipe = trun(TPipe(cfg, device="cpu"), tsim)
    live = len(pipe._pending_records) + len(pipe._records)
    assert live <= 2 + cfg.retire_batch
    assert pipe.n_retired == len(base.records) - live > 30
    pipe.write_outputs()
    ts, ps, _ = tum.read_tum(str(tmp_path / "pose.txt"))
    tsb, psb, _ = base.trajectory()
    np.testing.assert_allclose(ts, tsb, atol=1e-9, rtol=0)
    np.testing.assert_allclose(ps, psb, atol=1e-6, rtol=0)
    for name in ("velocity.txt", "bias.txt"):
        with open(tmp_path / name) as f:
            assert len(f.read().splitlines()) == len(tsb)


def test_convert_roundtrips_state(runs):
    jp, tp = runs
    back = convert.eskf_state_to_numpy(convert.eskf_state_from_numpy(
        jp.state))
    for name in back:
        np.testing.assert_array_equal(back[name],
                                      np.asarray(getattr(jp.state, name)))
    again = convert.eskf_state_from_numpy(convert.eskf_state_to_numpy(
        tp.state))
    for name, v in again._asdict().items():
        assert torch.equal(v, getattr(tp.state, name))


def test_unported_options_raise():
    for field in ("enable_map_eviction", "debug_output"):
        cfg = _port_cfg()
        setattr(cfg, field, True)
        with pytest.raises(NotImplementedError):
            TPipe(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        TPipe(_port_cfg(), device="cpu").save_checkpoint("unused")
