"""Parity of the port's map-sharded LIO engine (sr_livo_tpu_torch.parallel.
sharded_lio) with the JAX package's, at the same number of ranks.

Four gloo ranks on the CPU (tests/torch_shard_worker.py, started once for
the module) run the engine against JAX's ShardedLioEngine on a 4-device
mesh of the virtual CPU devices, with the configuration of
tests/test_sharded_lio.py and 6 sweeps:

  * in lockstep (JAX's state and sharded map before each step given to
    the ranks through `convert`, as tests/lockstep.py does for the
    single-device step): success, residual count and iterations equal,
    `frame_valid` and `inserted` bit for bit, `route_overflow` and
    `map_size` equal, positions at float32 round-off;
  * closed loop against the port's single-device LioEngine within the
    bars of tests/test_sharded_lio.py, with and without the residual cap;
  * starved budgets (`budget_override`): the overflow counts equal JAX's;
  * every rank's replicated outputs are the same bits.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.models.odometry import SweepInput as JaxSweep
from sr_livo_tpu.parallel import mesh as jmesh
from sr_livo_tpu.parallel import sharded_lio as jsl
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.models.odometry import LioEngine, SweepInput
from sr_livo_tpu_torch.ops import voxel_map as tvm
from sr_livo_tpu_torch.parallel import sharded_lio as tsl
from sr_livo_tpu_torch.parallel.mesh import make_mesh
from tests.test_sharded_lio import _cfg as _jax_cfg
from tests.test_sharded_lio import _sweeps
from tests.torch_shard_worker import run_ranks
from tests.torch_threads import one_intraop_thread  # noqa: F401

N = 4
N_SWEEPS = 6
# the starved budgets of tests/test_sharded_lio.py's overflow test
STARVED = dict(B2=16, B3=16, B4=16, K4=64, B5=16, W_ins=64)
# float32 round-off of the IEKF's sums in another order (XLA's dots and
# psum against torch's matmul and gloo's all-reduce).  Measured over the 6
# sweeps: positions 6.6e-07 m, quaternions 1.1e-08, frame points 1.9e-06 m.
POS_TOL = 1e-5
CAP = 220


def _port_cfg(cap: int = -1) -> LivoConfig:
    """tests/test_sharded_lio.py::_cfg in the port's config."""
    cfg = LivoConfig()
    cfg.odometry_options.voxel_size = 0.2
    cfg.odometry_options.init_voxel_size = 0.2
    cfg.odometry_options.sample_voxel_size = 0.8
    cfg.odometry_options.init_sample_voxel_size = 0.8
    cfg.odometry_options.min_distance_points = 0.05
    cfg.icp.size_voxel_map = 0.6
    cfg.icp.min_number_neighbors = 12
    cfg.icp.max_num_residuals = cap
    cfg.shapes.max_sweep_points = 2048
    cfg.shapes.max_frame_points = 2048
    cfg.shapes.max_keypoints = 512
    cfg.shapes.max_imu_samples = 48
    cfg.shapes.map_capacity = 1 << 15
    return cfg


def _sweep_arrays(prep, fid) -> dict:
    return dict(raw_pts=prep.raw_pts, t_rel=prep.t_rel,
                pt_valid=prep.pt_valid, imu_t=prep.imu_t,
                imu_dt=prep.imu_dt, imu_acc=prep.imu_acc,
                imu_gyr=prep.imu_gyr, imu_valid=prep.imu_valid,
                do_optimize=np.asarray(fid > 1),
                threshold_capacity=np.int32(1))


def _port_sweep(arrays) -> SweepInput:
    dt = {"pt_valid": torch.bool, "imu_valid": torch.bool,
          "do_optimize": torch.bool, "threshold_capacity": torch.int32}
    return SweepInput(**{k: torch.tensor(np.asarray(v),
                                         dtype=dt.get(k, torch.float32))
                         for k, v in arrays.items()})


def _jax_run(sweeps, override=None):
    """JAX's 4-device engine over the sweeps: its state and sharded map
    before each step (numpy copies: the step donates the map) and each
    step's outputs."""
    eng = jsl.ShardedLioEngine(_jax_cfg(), jmesh.make_mesh(N),
                               budget_override=override)
    s, m = eng.init_state(), eng.make_map()
    states, maps, outs = [], [], []
    for fid, sw in enumerate(sweeps, start=1):
        states.append({k: np.array(v) for k, v in s._asdict().items()})
        maps.append({k: np.array(v) for k, v in m._asdict().items()})
        o = eng.step(s, m, JaxSweep(**{k: jnp.asarray(v)
                                       for k, v in sw.items()}), fid)
        s, m = o.state, o.voxel_map
        outs.append(dict(
            p=np.array(s.p), q=np.array(s.q),
            success=bool(o.summary.success),
            num_residuals=int(o.summary.num_residuals),
            iterations=int(o.summary.iterations),
            frame_valid=np.array(o.frame_valid),
            inserted=np.array(o.inserted),
            frame_pts_world=np.array(o.frame_pts_world),
            route_overflow=int(o.route_overflow),
            map_size=int(eng.map_size(m))))
    return states, maps, outs


def _lockstep_run(name, cfg, sweeps, states, maps, rank, override=None):
    return dict(name=name, cfg=cfg, lockstep=True, budget_override=override,
                sweeps=sweeps, frame_ids=list(range(1, len(sweeps) + 1)),
                states=states,
                maps=[convert.voxel_map_to_numpy(
                    convert.sharded_map_from_numpy(m, rank, N))
                    for m in maps])


def _single_chip(cfg, sweeps):
    eng = LioEngine(cfg, device="cpu")
    s, m = eng.init_state(), eng.make_map()
    out = []
    for fid, sw in enumerate(sweeps, start=1):
        o = eng.step(s, m, _port_sweep(sw), fid)
        s, m = o.state, o.voxel_map
        out.append(dict(p=s.p.numpy(), q=s.q.numpy(),
                        success=bool(o.summary.success),
                        num_residuals=int(o.summary.num_residuals),
                        map_size=int(tvm.map_size(m))))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    preps = _sweeps(_jax_cfg(), n=N_SWEEPS)
    assert len(preps) == N_SWEEPS
    sweeps = [_sweep_arrays(p, fid) for fid, p in enumerate(preps, start=1)]
    starved = dict(jsl.compute_budgets(_jax_cfg(), N), **STARVED)
    jax_lock = _jax_run(sweeps)
    jax_starved = _jax_run(sweeps[:5], starved)
    inputs = [dict(runs=[
        _lockstep_run("lockstep", _port_cfg(), sweeps, *jax_lock[:2], r),
        _lockstep_run("starved", _port_cfg(), sweeps[:5], *jax_starved[:2],
                      r, override=starved),
        dict(name="closed", cfg=_port_cfg(), lockstep=False, sweeps=sweeps,
             frame_ids=list(range(1, N_SWEEPS + 1))),
        dict(name="closed_cap", cfg=_port_cfg(CAP), lockstep=False,
             sweeps=sweeps, frame_ids=list(range(1, N_SWEEPS + 1)))])
        for r in range(N)]
    ranks = run_ranks("engine", N, tmp_path_factory.mktemp("sharded"), inputs)
    return dict(
        sweeps=sweeps, ranks=ranks, jax=jax_lock[2], jax_starved=jax_starved[2],
        single={"closed": _single_chip(_port_cfg(), sweeps),
                "closed_cap": _single_chip(_port_cfg(CAP), sweeps)})


@pytest.mark.parametrize("frame", range(N_SWEEPS))
def test_lockstep_step_matches_jax(runs, frame):
    port, ref = runs["ranks"][0]["lockstep"][frame], runs["jax"][frame]
    for k in ("success", "num_residuals", "iterations", "route_overflow",
              "map_size"):
        assert port[k] == ref[k], (frame, k, port[k], ref[k])
    assert port["route_overflow"] == 0
    np.testing.assert_array_equal(port["frame_valid"], ref["frame_valid"])
    np.testing.assert_array_equal(port["inserted"], ref["inserted"])
    gap = np.abs(port["state"]["p"] - ref["p"]).max()
    assert gap < POS_TOL, (frame, gap)
    assert np.abs(port["state"]["q"] - ref["q"]).max() < POS_TOL
    v = ref["frame_valid"]
    assert np.abs(port["frame_pts_world"][v]
                  - ref["frame_pts_world"][v]).max() < POS_TOL


@pytest.mark.parametrize("name", ["lockstep", "starved", "closed",
                                  "closed_cap"])
def test_replicated_outputs_bit_identical_on_every_rank(runs, name):
    first = runs["ranks"][0][name]
    for rank in range(1, N):
        for frame, (a, b) in enumerate(zip(first, runs["ranks"][rank][name])):
            for k in ("record", "frame_pts_world", "frame_valid", "inserted"):
                np.testing.assert_array_equal(a[k], b[k],
                                              err_msg=f"{rank} {frame} {k}")
            for k, v in a["state"].items():
                np.testing.assert_array_equal(v, b["state"][k],
                                              err_msg=f"{rank} {frame} {k}")
            assert a["route_overflow"] == b["route_overflow"]
            assert a["map_size"] == b["map_size"]


@pytest.mark.parametrize("name", ["closed", "closed_cap"])
def test_closed_loop_matches_single_chip(runs, name):
    """tests/test_sharded_lio.py's bars: positions within 2e-3 m,
    quaternions within 1e-4, the same success and owned map size, no
    overflow; with the cap active the residual counts agree exactly."""
    capped = 0
    for fid, (a, b) in enumerate(zip(runs["ranks"][0][name],
                                     runs["single"][name]), start=1):
        assert a["route_overflow"] == 0, fid
        assert a["map_size"] == b["map_size"], fid
        assert np.abs(a["state"]["p"] - b["p"]).max() < 2e-3, fid
        assert np.abs(a["state"]["q"] - b["q"]).max() < 1e-4, fid
        assert a["success"] == b["success"], fid
        if name == "closed_cap":
            assert a["num_residuals"] == b["num_residuals"], fid
            capped += fid > 1 and b["num_residuals"] >= CAP
        else:
            assert abs(a["num_residuals"] - b["num_residuals"]) <= 5, fid
    if name == "closed_cap":
        assert capped >= 2, "the cap never engaged"


def test_starved_budgets_overflow_matches_jax(runs):
    port = runs["ranks"][0]["starved"]
    ovf = [s["route_overflow"] for s in port]
    assert ovf == [s["route_overflow"] for s in runs["jax_starved"]]
    assert sum(ovf) > 0, "budgets this small must overflow"
    for s in port:
        assert np.all(np.isfinite(s["state"]["p"]))
        assert np.all(np.isfinite(s["state"]["cov"]))
        assert s["map_size"] > 0


def test_world_of_one_matches_single_chip(runs):
    """Without a process group the mesh is a world of one (identity
    collectives): the engine matches the single-device one."""
    eng = tsl.ShardedLioEngine(_port_cfg(CAP), make_mesh(device="cpu"))
    assert eng.mesh.size == 1 and eng.mesh.group is None
    s, m = eng.init_state(), eng.make_map()
    for fid, (sw, ref) in enumerate(zip(runs["sweeps"],
                                        runs["single"]["closed_cap"]),
                                    start=1):
        o = eng.step(s, m, _port_sweep(sw), fid)
        s, m = o.state, o.voxel_map
        assert int(o.summary.num_residuals) == ref["num_residuals"]
        assert int(eng.map_size(m)) == ref["map_size"]
        assert np.abs(s.p.numpy() - ref["p"]).max() < 1e-5


@pytest.mark.parametrize("stop_after", tsl.PROFILE_STAGES)
def test_profile_step_prefixes(runs, stop_after):
    """Every stage prefix runs and returns one finite scalar; prefixes
    past the insert leave the map as it was."""
    eng = tsl.ShardedLioEngine(_port_cfg(), make_mesh(device="cpu"))
    s, m = eng.init_state(), eng.make_map()
    o = eng.step(s, m, _port_sweep(runs["sweeps"][0]), 1)
    s, m = o.state, o.voxel_map
    before = int(eng.map_size(m))
    out = eng.make_profile_step(stop_after, phase="init")(
        s, m, _port_sweep(runs["sweeps"][1]))
    assert out.dim() == 0 and bool(torch.isfinite(out))
    assert int(eng.map_size(m)) == before


def test_engine_checks_its_configuration():
    cfg = _port_cfg()
    with pytest.raises(ValueError, match="power of two"):
        tsl.ShardedLioEngine(cfg, make_mesh(device="cpu"),
                             budget_override=dict(local_capacity=3000))
    cfg.retry_wider_neighborhood = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tsl.ShardedLioEngine(cfg, make_mesh(device="cpu"))
    assert any("retry_wider_neighborhood" in str(w.message) for w in caught)
