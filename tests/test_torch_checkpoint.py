"""The port's checkpoints (sr_livo_tpu_torch.runtime.checkpoint behind
LivoPipeline.save_checkpoint / load_checkpoint).

- LIO only, on the 8 s run of test_checkpoint.py: a run checkpointed at
  5 s and resumed in a fresh pipeline has the uninterrupted run's frame
  times and positions within 5e-3 m (that test's bar), and the map and
  filter state survive the round trip exactly.
- The file layout is the JAX package's: a checkpoint the JAX pipeline
  wrote at 5 s, loaded by the port and run to the end, stays within 2e-3 m
  of the JAX uninterrupted run; the JAX pipeline loads the port's
  checkpoint into the same state and map.
- LIVO (the vision module of test_vision_pipeline.py) on a 6.5 s run:
  resumed within 5e-3 m, with the colored map, the camera state, the
  tracks and the previous pyramid restored exactly.
"""
import numpy as np
import pytest
import torch

from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu.pipeline import run_streams as jrun
from sr_livo_tpu.runtime import synthetic as jsyn
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.models.vision import VisionModule as TVision
from sr_livo_tpu_torch.ops import voxel_map as tvm
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.pipeline import run_streams as trun
from tests.test_checkpoint import _cfg, _feed
from tests.test_torch_pipeline import _copy_cfg
from tests.test_torch_vision import CAM, SIZE
from tests.test_torch_vision import _port_cfg as _port_livo_cfg
from tests.torch_threads import one_intraop_thread  # noqa: F401


def _port_cfg():
    from sr_livo_tpu_torch.config import LivoConfig
    return _copy_cfg(LivoConfig(), _cfg())


@pytest.fixture(scope="module")
def sim():
    return jsyn.simulate(duration=8.0, n_azimuth=80, n_rings=10, seed=12)


@pytest.fixture(scope="module")
def lio_runs(sim, tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    base = trun(TPipe(_port_cfg(), device="cpu"), sim)
    first = TPipe(_port_cfg(), device="cpu")
    _feed(first, sim, 0.0, 5.0)
    path = str(d / "port.npz")
    first.save_checkpoint(path)
    return base, first, path


def test_lio_resume_matches_uninterrupted(sim, lio_runs):
    base, first, path = lio_runs
    resumed = TPipe(_port_cfg(), device="cpu")
    resumed.load_checkpoint(path)
    assert resumed.initialized == first.initialized
    assert resumed.index_frame == first.index_frame
    assert len(resumed.records) == len(first.records) > 5
    _feed(resumed, sim, 5.0, 99.0)
    tsr, psr, _ = resumed.trajectory()
    tsb, psb, _ = base.trajectory()
    np.testing.assert_array_equal(tsr, tsb)
    assert np.linalg.norm(psr - psb, axis=-1).max() < 5e-3


def test_checkpoint_preserves_state_and_map(lio_runs):
    _, first, path = lio_runs
    fresh = TPipe(_port_cfg(), device="cpu")
    fresh.load_checkpoint(path)
    assert int(tvm.map_size(fresh.voxel_map)) == int(
        tvm.map_size(first.voxel_map)) > 1000
    for a, b in zip(fresh.voxel_map, first.voxel_map):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(fresh.state, first.state):
        assert torch.equal(a, b)
    assert fresh.current_time == first.current_time
    assert fresh.cutter.points.size == first.cutter.points.size


def test_jax_checkpoint_resumes_in_the_port(sim, tmp_path):
    base = jrun(JPipe(_cfg()), sim)
    first = JPipe(_cfg())
    _feed(first, sim, 0.0, 5.0)
    path = str(tmp_path / "jax.npz")
    first.save_checkpoint(path)
    resumed = TPipe(_port_cfg(), device="cpu")
    resumed.load_checkpoint(path)
    assert resumed.index_frame == first.index_frame
    _feed(resumed, sim, 5.0, 99.0)
    tsr, psr, _ = resumed.trajectory()
    tsb, psb, _ = base.trajectory()
    np.testing.assert_array_equal(tsr, tsb)
    assert np.linalg.norm(psr - psb, axis=-1).max() < 2e-3


def test_jax_loads_the_port_checkpoint(lio_runs):
    _, first, path = lio_runs
    jp = JPipe(_cfg())
    jp.load_checkpoint(path)
    assert jp.index_frame == first.index_frame
    back = convert.eskf_state_from_numpy(jp.state)
    for a, b in zip(back, first.state):
        assert torch.equal(a, b)
    jm = convert.voxel_map_from_numpy(jp.voxel_map)
    for a, b in zip(jm, first.voxel_map):
        assert torch.equal(a, b)


def test_livo_resume_matches_uninterrupted(tmp_path):
    sim = jsyn.simulate(duration=6.5, n_azimuth=100, n_rings=12, seed=6,
                        image_size=SIZE, camera=CAM)
    cfg = _port_livo_cfg()

    def pipe():
        return TPipe(cfg, vision=TVision(cfg, device="cpu"), device="cpu")

    base = trun(pipe(), sim)
    first = pipe()
    _feed(first, sim, 0.0, 5.0)
    assert first.vision.prev_pyr is not None
    path = str(tmp_path / "livo.npz")
    first.save_checkpoint(path)
    resumed = pipe()
    resumed.load_checkpoint(path)
    v0, v1 = first.vision, resumed.vision
    for name in ("camera", "color_map", "tracks", "prev_pyr"):
        fa = _flat(getattr(v0, name))
        fb = _flat(getattr(v1, name))
        assert len(fa) == len(fb)
        for x, y in zip(fa, fb):
            assert x.dtype == y.dtype and torch.equal(x, y), name
    assert (v1.first_data, v1.prev_time) == (v0.first_data, v0.prev_time)
    _feed(resumed, sim, 5.0, 99.0)
    tsr, psr, _ = resumed.trajectory()
    tsb, psb, _ = base.trajectory()
    np.testing.assert_array_equal(tsr, tsb)
    assert np.linalg.norm(psr - psb, axis=-1).max() < 5e-3


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _flat(sub)]
