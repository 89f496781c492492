"""The port's mapping backend (sr_livo_tpu_torch.parallel.backend) and
`eskf.observe_pose` against the JAX package's.

- `observe_pose` on the same state and pose: within 1e-6.
- `MappingBackend` attached to both LIO pipelines on the 9 s run of
  test_backend.py: equal keyframe, edge, BA and closure counts, the
  optimized trajectory within 2e-3 m of the JAX package's and passing
  test_backend.py's bars.
- Loop feedback with the map rebuild on the fixture of
  test_backend.py::test_feedback_rebuilds_map_at_optimized_poses: the
  corrected keyframe poses and the re-anchored filter state within 1e-4,
  the rebuilt map's integer state bit-exact.
- `optimized_trajectory` of a 70-keyframe chain, padded to 128 nodes (the
  PCG path): within 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.models import eskf as jeskf
from sr_livo_tpu.ops import voxel_map as jvm
from sr_livo_tpu.parallel import backend as jbe
from sr_livo_tpu.parallel import pose_graph as jpg
from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu.pipeline import run_streams as jrun
from sr_livo_tpu.runtime import synthetic as jsyn
from sr_livo_tpu.utils import lie as jlie
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.models import eskf as teskf
from sr_livo_tpu_torch.ops import voxel_map as tvm
from sr_livo_tpu_torch.parallel import backend as tbe
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.pipeline import run_streams as trun
from sr_livo_tpu_torch.runtime import tum
from tests.test_backend import _cfg
from tests.test_torch_pipeline import _copy_cfg
from tests.torch_threads import one_intraop_thread  # noqa: F401

BACKEND = dict(keyframe_interval=0.4, window_size=4, ba_every_n_keyframes=4,
               max_keyframe_points=512, loop_min_gap=100)


def _port_cfg(jcfg):
    from sr_livo_tpu_torch.config import LivoConfig
    return _copy_cfg(LivoConfig(), jcfg)


class _Pipe:
    """The attributes of a pipeline that apply_pose_correction reads."""


def test_observe_pose_matches_jax():
    rng = np.random.RandomState(4)
    st = jeskf.init_state()
    a = rng.randn(17, 17) * 0.1
    cov = (np.eye(17) * 0.5 + a @ a.T).astype(np.float32)
    q = np.asarray(jlie.exp_so3_quat(jnp.asarray([0.1, -0.2, 0.3],
                                                 jnp.float32)))
    st = st._replace(p=jnp.asarray([1.0, 2.0, 0.5]), q=jnp.asarray(q),
                     v=jnp.asarray([0.3, 0.0, -0.1]), cov=jnp.asarray(cov))
    q_meas = np.asarray(jlie.quat_mul(jnp.asarray(q), jlie.exp_so3_quat(
        jnp.asarray([0.02, 0.01, -0.03], jnp.float32))))
    t_meas = np.array([1.05, 1.9, 0.52], np.float32)
    for noise in (1e-3, 1e-6):
        jn = jeskf.observe_pose(st, jnp.asarray(t_meas), jnp.asarray(q_meas),
                                trans_noise=noise, ang_noise=noise)
        tn = teskf.observe_pose(convert.eskf_state_from_numpy(st),
                                torch.as_tensor(t_meas),
                                torch.as_tensor(q_meas),
                                trans_noise=noise, ang_noise=noise)
        for name in jn._fields:
            err = np.abs(np.asarray(getattr(jn, name))
                         - getattr(tn, name).numpy()).max()
            assert err < 1e-6 * max(1.0, float(np.abs(cov).max())), name


@pytest.fixture(scope="module")
def backend_runs():
    jcfg = _cfg()
    sim = jsyn.simulate(duration=9.0, n_azimuth=80, n_rings=10, seed=14)
    jb = jbe.MappingBackend(jbe.BackendConfig(**BACKEND))
    jp = jrun(JPipe(jcfg, backend=jb), sim)
    tb = tbe.MappingBackend(tbe.BackendConfig(**BACKEND), device="cpu")
    tp = trun(TPipe(_port_cfg(jcfg), backend=tb, device="cpu"), sim)
    return sim, jp, jb, tp, tb


def test_backend_run_matches_jax(backend_runs):
    sim, jp, jb, tp, tb = backend_runs
    assert len(tb.keyframes) == len(jb.keyframes) >= 8
    assert len(tb.edges) == len(jb.edges) >= len(tb.keyframes) - 1
    assert tb.ba_runs == jb.ba_runs >= 1
    assert tb.n_loop_closures == jb.n_loop_closures
    assert [f.time for f in tb.keyframes] == [f.time for f in jb.keyframes]
    tt, t_opt, q_opt = tb.optimized_trajectory()
    jt, jt_opt, jq_opt = jb.optimized_trajectory()
    np.testing.assert_array_equal(tt, jt)
    assert np.linalg.norm(t_opt - jt_opt, axis=-1).max() < 2e-3
    assert np.abs(q_opt - jq_opt).max() < 2e-3
    # test_backend.py's bars on the port's own run
    ate_opt = tum.ate_rmse(tt, t_opt, sim.gt_times, sim.gt_pos, align=True)
    ts, ps, _ = tp.trajectory()
    ate_odo = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
    assert ate_opt < 0.08 and ate_opt < max(2.5 * ate_odo, 0.05), (
        ate_opt, ate_odo)


def _drifted_backends(n_kf=6, n_pts=256):
    """test_feedback_rebuilds_map_at_optimized_poses's fixture in both
    packages: keyframes on a line, drifted +0.5 m in x from keyframe 2 on,
    odometry edges from the drifted chain and a strong true loop edge."""
    rng = np.random.RandomState(5)
    t_gt = np.stack([[0.5 * k, 0.0, 1.0] for k in range(n_kf)]).astype(
        np.float32)
    drift = np.zeros_like(t_gt)
    drift[2:, 0] = 0.5
    q_id = np.array([1, 0, 0, 0], np.float32)
    pts = rng.uniform(-2, 2, (n_kf, n_pts, 3)).astype(np.float32)
    jb = jbe.MappingBackend(jbe.BackendConfig(feedback_to_filter=True))
    for k in range(n_kf):
        jb.keyframes.append(jbe.Keyframe(
            time=float(k), q=q_id.copy(), t=t_gt[k] + drift[k],
            points=pts[k], valid=np.ones(n_pts, bool)))
        if k:
            qr, tr = jpg.edge_from_poses(
                jnp.asarray(q_id), jnp.asarray(t_gt[k - 1] + drift[k - 1]),
                jnp.asarray(q_id), jnp.asarray(t_gt[k] + drift[k]))
            jb.edges.append(dict(i=k - 1, j=k, q=np.asarray(qr),
                                 t=np.asarray(tr), rot_w=50.0, t_w=50.0))
    qr, tr = jpg.edge_from_poses(jnp.asarray(q_id), jnp.asarray(t_gt[0]),
                                 jnp.asarray(q_id), jnp.asarray(t_gt[5]))
    jb.edges.append(dict(i=0, j=5, q=np.asarray(qr), t=np.asarray(tr),
                         rot_w=500.0, t_w=500.0))
    tb = tbe.MappingBackend(tbe.BackendConfig(feedback_to_filter=True),
                            device="cpu")
    tb.keyframes = convert.keyframes_from_numpy(jb.keyframes)
    tb.edges = convert.edges_from_numpy(jb.edges)
    return jb, tb, t_gt


def test_feedback_rebuilds_map_like_jax():
    jcfg = _cfg()
    jb, tb, t_gt = _drifted_backends()
    jpipe, tpipe = _Pipe(), _Pipe()
    jpipe.cfg, jpipe.state = jcfg, jeskf.init_state()
    jpipe.voxel_map = jvm.make_map(jcfg.shapes.map_capacity, 20)
    tpipe.cfg, tpipe.device = _port_cfg(jcfg), torch.device("cpu")
    tpipe.state = teskf.init_state()
    tpipe.voxel_map = tvm.make_map(jcfg.shapes.map_capacity, 20)
    assert jb.apply_pose_correction(jpipe) and tb.apply_pose_correction(tpipe)
    assert tb.n_map_rebuilds == jb.n_map_rebuilds == 1
    assert tb.n_feedback_applied == 1
    for fj, ft in zip(jb.keyframes, tb.keyframes):
        assert np.abs(fj.t - ft.t).max() < 1e-4
        assert np.abs(fj.q - ft.q).max() < 1e-4
    assert abs(tb.keyframes[5].t[0] - t_gt[5, 0]) < 0.15
    jm = convert.voxel_map_to_numpy(convert.voxel_map_from_numpy(
        jpipe.voxel_map))
    tm = convert.voxel_map_to_numpy(tpipe.voxel_map)
    assert int(tm["counts"].sum()) > 1000
    for name in ("keys", "sig", "counts", "point_ids"):
        np.testing.assert_array_equal(tm[name], jm[name], err_msg=name)
    assert np.abs(tm["points"] - jm["points"]).max() < 1e-4
    for name in jpipe.state._fields:
        assert np.abs(np.asarray(getattr(jpipe.state, name))
                      - getattr(tpipe.state, name).numpy()).max() < 1e-4


def test_optimized_trajectory_pcg_bucket_matches_jax():
    """70 keyframes pad to 128 nodes: past dense_below, so the PCG path
    with 192 CG steps, as in the JAX package."""
    rng = np.random.RandomState(9)
    jb = jbe.MappingBackend(jbe.BackendConfig())
    for k in range(70):
        jb.keyframes.append(jbe.Keyframe(
            time=float(k), q=np.array([1, 0, 0, 0], np.float32),
            t=np.array([k * 0.1, 0.02 * np.sin(k), 0], np.float32),
            points=np.zeros((4, 3), np.float32), valid=np.ones(4, bool)))
        if k:
            jb.edges.append(dict(
                i=k - 1, j=k, q=np.array([1, 0, 0, 0], np.float32),
                t=(np.array([0.1, 0, 0]) + rng.randn(3) * 0.01).astype(
                    np.float32), rot_w=10.0, t_w=10.0))
    jb.edges.append(dict(i=3, j=66, q=np.array([1, 0, 0, 0], np.float32),
                         t=np.array([6.3, 0.0, 0.0], np.float32),
                         rot_w=100.0, t_w=100.0))
    tb = tbe.MappingBackend(tbe.BackendConfig(), device="cpu")
    tb.keyframes = convert.keyframes_from_numpy(jb.keyframes)
    tb.edges = convert.edges_from_numpy(jb.edges)
    jt, jt_opt, jq_opt = jb.optimized_trajectory(iters=3)
    tt, t_opt, q_opt = tb.optimized_trajectory(iters=3)
    np.testing.assert_array_equal(tt, jt)
    assert t_opt.shape == (70, 3) and q_opt.shape == (70, 4)
    assert np.abs(t_opt - jt_opt).max() < 1e-4
    assert np.abs(q_opt - jq_opt).max() < 1e-4


def test_backend_on_another_device_is_refused():
    class _OnMeta:
        device = torch.device("meta")
    with pytest.raises(ValueError):
        TPipe(_port_cfg(_cfg()), backend=_OnMeta(), device="cpu")
