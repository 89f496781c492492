"""The map-sharded engine's captured programs (sr_livo_tpu_torch.parallel.
sharded_lio, parallel.ba) on the CPU, against their eager functions and
the JAX package.

On a capturable mesh (`Mesh.capturable`: a world of one, or NCCL on the
card) `ShardedLioEngine.step`, `map_size`, `compact`, the profile
prefixes and `sharded_windowed_ba_program` are `utils.graphs` programs,
the counterpart of the JAX package's jitted `shard_map` programs; on the
CPU each runs its function directly, and within `graphs.capture_form()`
as a CUDA graph of it records it (every masked IEKF round, both branches
of the weak-solve retry).  A world of one on the CPU, with
tests/test_sharded_lio.py's configuration and sweeps:

  * `Mesh.capturable` on both sides: a world of one builds programs, a
    gloo group (one rank, a FileStore) builds none and runs eagerly;
  * the step with the weak-solve retry taken on every steady frame
    (`min_num_residuals` above any count), in both association modes:
    capture form = eager form bit for bit on every frame (init and
    steady phases), and both within tests/test_sharded_lio.py's bars of
    the single-device LioEngine with the same retry;
  * no host read: each program's function in capture form (the init and
    steady steps with the retry, `map_size`, `compact`, a post-insert
    profile prefix, the sharded BA) under tests/test_torch_graphs.py's
    `NoHostReads`, which fails on what a CUDA graph capture refuses;
  * `compact` as a program writes the compacted table into the engine's
    map in place, the bits of `voxel_map.compact_map` and of JAX's
    1-device engine;
  * the sharded BA as a program on test_torch_sharded_ba.py's world, a
    1-rank layout: its eager function's bits in both forms, within that
    file's TOL of JAX's sharded BA on a 1-device mesh.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sr_livo_tpu.ops import voxel_map as jvm
from sr_livo_tpu.parallel import ba as jba
from sr_livo_tpu.parallel import mesh as jmesh
from sr_livo_tpu.parallel import sharded_lio as jsl
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.models import lio as tlio
from sr_livo_tpu_torch.models.odometry import LioEngine
from sr_livo_tpu_torch.ops import voxel_map as tvm
from sr_livo_tpu_torch.parallel import ba as tba
from sr_livo_tpu_torch.parallel import sharded_lio as tsl
from sr_livo_tpu_torch.parallel.mesh import make_mesh
from sr_livo_tpu_torch.utils import graphs
from tests.test_sharded_lio import _cfg as _jax_cfg
from tests.test_sharded_lio import _sweeps
from tests.test_torch_ba import _window
from tests.test_torch_graphs import _no_host_reads
from tests.test_torch_sharded_ba import (BA_KW, K, TOL, _resharded,
                                         _world_and_map)
from tests.test_torch_sharded_lio import (CAP, _port_cfg, _port_sweep,
                                          _sweep_arrays)
from tests.torch_threads import one_intraop_thread  # noqa: F401

# init frames, then steady ones (init_num_frames is 20)
FRAME_IDS = (1, 2, 3, 21, 22, 23)
# tests/test_sharded_lio.py:104-107, the sharded engine against the
# single-device one
POS, QUAT = 2e-3, 1e-4
STATE_KEYS = ("p", "q", "v", "ba", "bg", "g", "cov")


def _retry_cfg(cache: bool):
    """The residual cap on, the retry on and taken on every frame (no
    count reaches min_num_residuals), the halo wide enough for the init
    phase's widened neighbourhood (3 voxels)."""
    cfg = _port_cfg(CAP)
    cfg.cache_association = cache
    cfg.retry_wider_neighborhood = True
    cfg.icp.min_num_residuals = 10 ** 6
    cfg.shapes.map_halo_voxels = 3
    return cfg


def _record(o) -> dict:
    # copies: the state is the step program's buffers
    rec = {k: getattr(o.state, k).clone() for k in STATE_KEYS}
    rec.update(record=o.record, frame_pts_world=o.frame_pts_world,
               frame_valid=o.frame_valid, inserted=o.inserted,
               route_overflow=o.route_overflow)
    return rec


def _run(cfg, sweeps, capture: bool):
    """The engine over the sweeps, each step eagerly or in capture form;
    per step its record, owned map size and IEKF updates (the retry's
    second one counts where it runs)."""
    eng = tsl.ShardedLioEngine(cfg, make_mesh(device="cpu"))
    s, m = eng.init_state(), eng.make_map()
    recs = []
    for sw, fid in zip(sweeps, FRAME_IDS):
        before = tlio.counts["updates"]
        if capture:
            with graphs.capture_form():
                o = eng.step(s, m, sw, fid)
        else:
            o = eng.step(s, m, sw, fid)
        s, m = o.state, o.voxel_map
        recs.append(dict(_record(o), map_size=int(eng.map_size(m)),
                         updates=tlio.counts["updates"] - before))
    return eng, recs


def _single(cfg, sweeps):
    eng = LioEngine(cfg, device="cpu")
    s, m = eng.init_state(), eng.make_map()
    out = []
    for sw, fid in zip(sweeps, FRAME_IDS):
        o = eng.step(s, m, sw, fid)
        s, m = o.state, o.voxel_map
        out.append(dict(p=s.p.clone(), q=s.q.clone(),
                        success=bool(o.summary.success),
                        map_size=int(tvm.map_size(m))))
    return out


@pytest.fixture(scope="module")
def sweeps():
    preps = _sweeps(_jax_cfg(), n=len(FRAME_IDS))
    return [_port_sweep(_sweep_arrays(p, fid))
            for p, fid in zip(preps, FRAME_IDS)]


@pytest.fixture(scope="module", params=[True, False],
                ids=["assoc", "search"])
def world(request, sweeps):
    cfg = _retry_cfg(request.param)
    eng, eager = _run(cfg, sweeps, capture=False)
    _, captured = _run(cfg, sweeps, capture=True)
    return dict(cfg=cfg, engine=eng, eager=eager, captured=captured,
                single=_single(cfg, sweeps))


def test_mesh_capturable_on_both_sides(sweeps, tmp_path):
    """A world of one is capturable and builds programs; a gloo group is
    not, and its engine runs the step eagerly."""
    mesh = make_mesh(device="cpu")
    assert mesh.capturable
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1)
    try:
        gloo = make_mesh(device="cpu", group=dist.group.WORLD)
        assert gloo.group is not None and not gloo.capturable
        eng = tsl.ShardedLioEngine(_port_cfg(), gloo)
        o = eng.step(eng.init_state(), eng.make_map(), sweeps[0], 1)
        eng.map_size(o.voxel_map)
        assert eng.programs == {}
    finally:
        dist.destroy_process_group()
    eng = tsl.ShardedLioEngine(_port_cfg(), mesh)
    o = eng.step(eng.init_state(), eng.make_map(), sweeps[0], 1)
    eng.map_size(o.voxel_map)
    assert sorted(p.name for p in eng.programs.values()) == [
        "sharded_lio_step[init]", "sharded_map_size"]


@pytest.mark.parametrize("frame", range(len(FRAME_IDS)))
def test_step_capture_form_gives_the_eager_bits(world, frame):
    a, b = world["eager"][frame], world["captured"][frame]
    for k, v in a.items():
        if torch.is_tensor(v):
            assert torch.equal(v, b[k]), (frame, k)
        else:
            assert v == b[k], (frame, k)


def test_step_retry_matches_the_single_device(world):
    """The retry ran on every frame (two IEKF updates, eagerly as in
    capture form), and the sharded step stays within the single-device
    engine's bars (the same success and owned map size, no overflow)."""
    for fid, a, b, c in zip(FRAME_IDS, world["eager"], world["single"],
                            world["captured"]):
        assert a["updates"] == c["updates"] == 2, fid
        assert int(a["route_overflow"]) == 0, fid
        assert a["map_size"] == b["map_size"], fid
        assert float((a["p"] - b["p"]).abs().max()) < POS, fid
        assert float((a["q"] - b["q"]).abs().max()) < QUAT, fid
        assert bool(a["record"][16] > 0.5) == b["success"], fid


def _programs_by_name(world, sweeps):
    """The world's programs after a compact, a post-insert profile prefix
    and a sharded BA on its final map."""
    eng = world["engine"]
    prog = eng.programs
    steady = next(p for p in prog.values()
                  if p.name == "sharded_lio_step[steady]")
    s, m = steady.state
    if not any(p.name == "sharded_compact" for p in prog.values()):
        eng.make_profile_step("insert")(s, m, sweeps[-1])
        rng = np.random.RandomState(3)
        frame = world["eager"][-1]
        pts = frame["frame_pts_world"][frame["frame_valid"]]
        body = pts[torch.as_tensor(rng.choice(len(pts), 4 * 64))].reshape(
            4, 64, 3) - s.p
        window = tba.KeyframeWindow(
            q=s.q.expand(4, 4).clone(), t=s.p.expand(4, 3).clone(),
            points=body.contiguous(),
            pt_valid=torch.ones((4, 64), dtype=torch.bool),
            kf_valid=torch.ones((4,), dtype=torch.bool))
        q_odo = torch.tensor([[1.0, 0, 0, 0]]).repeat(3, 1)
        tba.sharded_windowed_ba_program(
            prog, eng.mesh, m, window, q_odo, torch.zeros((3, 3)),
            voxel_size=world["cfg"].icp.size_voxel_map, iters=2)
        eng.compact(m, s.p)
    return {p.name: p for p in prog.values()}


@pytest.mark.parametrize("name", [
    "sharded_lio_step[init]", "sharded_lio_step[steady]",
    "sharded_map_size", "sharded_compact", "sharded_profile[insert]",
    "sharded_windowed_ba[4x64]"])
def test_program_reads_nothing_back(world, sweeps, name, monkeypatch):
    _no_host_reads(_programs_by_name(world, sweeps)[name], monkeypatch)


def test_compact_program_is_in_place_and_matches_jax(world):
    """`compact` on the final map at a radius that evicts: the program
    writes the new table into the engine's map (the step program's
    buffers), the bits of `compact_map` and of JAX's 1-device engine."""
    eng = world["engine"]
    steady = next(p for p in eng.programs.values()
                  if p.name == "sharded_lio_step[steady]")
    s, m = steady.state
    before = tvm.VoxelMap(*(t.clone() for t in m))
    size_before = int(eng.map_size(m))
    loc = s.p + torch.tensor([3.0, 0.0, 0.0])
    distance = eng.cfg.odometry_options.max_distance
    eng.cfg.odometry_options.max_distance = 4.0
    try:
        ref, ref_dropped = tvm.compact_map(
            tvm.VoxelMap(*(t.clone() for t in before)), loc, distance=4.0,
            max_probe=eng.cfg.shapes.map_max_probe)
        with graphs.capture_form():
            m2, dropped = eng.compact(m, loc)
        in_place = graphs.same_leaves(m2, m)
        m2 = tvm.VoxelMap(*(t.clone() for t in m2))
        jcfg = _jax_cfg()
        jcfg.odometry_options.max_distance = 4.0
        jeng = jsl.ShardedLioEngine(jcfg, jmesh.make_mesh(1))
        jm, jdropped = jeng.compact(jvm.VoxelMap(**{
            k: jnp.asarray(v) for k, v in
            convert.voxel_map_to_numpy(before).items()}), loc.numpy())
    finally:
        eng.cfg.odometry_options.max_distance = distance
        graphs.refill(m, before)        # the world's map as it was
    assert in_place
    assert int(dropped) == int(ref_dropped) == int(jdropped)
    assert 0 < int(tvm.map_size(ref)) < size_before
    for name, a, b in zip(tvm.VoxelMap._fields, m2, ref):
        assert torch.equal(a, b), name
    for name, a in zip(tvm.VoxelMap._fields, m2):
        np.testing.assert_array_equal(a.numpy(), np.asarray(
            getattr(jm, name)), err_msg=name)


@pytest.fixture(scope="module")
def ba_world():
    rng = np.random.RandomState(17)
    world, flat = _world_and_map(rng)
    window, q_odo, t_odo, _, _ = _window(world, rng, K=K)
    layout = _resharded(flat, 1)
    jmap = jvm.VoxelMap(**{f: jnp.asarray(a) for f, a in layout.items()})
    jw = jba.KeyframeWindow(**{k: jnp.asarray(v) for k, v in window.items()})
    ref = [jax.tree_util.tree_map(np.asarray, jba.make_sharded_windowed_ba(
        jmesh.make_mesh(1), K, **kw)(jmap, jw, jnp.asarray(q_odo),
                                     jnp.asarray(t_odo))) for kw in BA_KW]
    return dict(map=convert.voxel_map_from_numpy(layout),
                window=convert.keyframe_window_from_numpy(window),
                q_odo=torch.as_tensor(q_odo), t_odo=torch.as_tensor(t_odo),
                ref=ref)


@pytest.mark.parametrize("case", range(len(BA_KW)), ids=["normal", "starved"])
def test_sharded_ba_program_matches_eager_and_jax(ba_world, case):
    """Twice in each form (the second call replays on the card), the
    program gives the eager function's bits, within TOL of JAX, with the
    live map adopted, not copied."""
    kw = BA_KW[case]
    mesh = make_mesh(device="cpu")
    args = (ba_world["map"], ba_world["window"], ba_world["q_odo"],
            ba_world["t_odo"])
    eager = tba.make_sharded_windowed_ba(mesh, K, **kw)(*args)
    programs = {}
    for form in (graphs.capture_form, graphs.capture_form, None, None):
        if form is None:
            got = tba.sharded_windowed_ba_program(programs, mesh, *args, **kw)
        else:
            with form():
                got = tba.sharded_windowed_ba_program(programs, mesh, *args,
                                                      **kw)
        for a, b in zip(got, eager):
            assert torch.equal(a, b)
    (prog,) = programs.values()
    assert graphs.same_leaves(prog.state, ba_world["map"])
    q, t, ovf = (x.numpy() for x in got)
    ref_q, ref_t, ref_ovf = ba_world["ref"][case]
    assert int(ovf) == int(ref_ovf)
    assert np.abs(q - ref_q).max() < TOL
    assert np.abs(t - ref_t).max() < TOL
