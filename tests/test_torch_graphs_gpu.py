"""The port's captured programs (sr_livo_tpu_torch.utils.graphs) on the card:
the vision frame program and the IEKF iteration program as CUDA graph
replays.

A CUDA graph exists only on a CUDA device, so these tests skip without
one.  The file imports neither JAX nor the JAX package, so it runs on a
machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_graphs_gpu.py

  * a LIVO run at a small configuration (test_vision_pipeline.py's rig,
    120 x 160 images rendered by the port's simulator on the card) in
    each association mode: every call of each program is replayed, then
    its function run eagerly on clones of the buffers it had; the outputs
    and the state written back are the same bits (no program holds a
    float atomic whose order could differ);
  * the launch counters advance on every replay: `knn_plane_rows`, inside
    the search-mode IEKF program, once per iteration;
  * a capture that meets a host read raises, and nothing runs eagerly in
    its place: the state is as it was;
  * a state tensor replaced by eager code is copied into the program's
    buffer before the next replay, and a new map in the search mode is
    taken by capturing again.
"""
import numpy as np
import pytest
import torch

from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.models import lio
from sr_livo_tpu_torch.models.vision import VisionModule
from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.pipeline import LivoPipeline, run_streams
from sr_livo_tpu_torch.runtime import synthetic
from sr_livo_tpu_torch.utils import graphs

pytestmark = pytest.mark.gpu

CAM = (130.0, 130.0, 80.0, 60.0)
SIZE = (120, 160)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def small_cfg(cache_association: bool) -> LivoConfig:
    """test_vision_pipeline.py's configuration."""
    cfg = LivoConfig()
    cfg.odometry_options.voxel_size = 0.2
    cfg.odometry_options.init_voxel_size = 0.2
    cfg.odometry_options.sample_voxel_size = 0.8
    cfg.odometry_options.init_sample_voxel_size = 0.8
    cfg.odometry_options.min_distance_points = 0.05
    cfg.icp.size_voxel_map = 0.6
    cfg.icp.min_number_neighbors = 12
    cfg.shapes.max_sweep_points = 4096
    cfg.shapes.max_frame_points = 4096
    cfg.shapes.max_keypoints = 768
    cfg.shapes.max_imu_samples = 48
    cfg.shapes.map_capacity = 1 << 16
    cfg.shapes.color_capacity = 1 << 16
    cfg.shapes.color_registry = 1 << 17
    cfg.shapes.max_render_points = 1 << 13
    cfg.camera_options.image_width = SIZE[1]
    cfg.camera_options.image_height = SIZE[0]
    cfg.camera_options.image_scale = 1.0
    cfg.camera_options.camera_intrinsic = [
        CAM[0], 0, CAM[2], 0, CAM[1], CAM[3], 0, 0, 1]
    cfg.camera_options.camera_dist_coeffs = [0, 0, 0, 0, 0]
    cfg.map_options.add_point_step = 1
    cfg.extrinsics.extrinsic_R_imu_camera = [0, 0, 1, -1, 0, 0, 0, -1, 0]
    cfg.extrinsics.extrinsic_t_imu_camera = [0.0, 0.0, 0.0]
    cfg.cache_association = cache_association
    return cfg


def _bits(t):
    if t.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return t.contiguous().view(ints[t.element_size()])
    return t


class EveryCall:
    """Within the block, every program call on the card is replayed and
    then its function run eagerly on clones of the buffers it had; the
    calls whose outputs or state differ in any bit go to `differ`."""

    def __init__(self):
        self.calls, self.differ, self.names = 0, [], set()

    def __enter__(self):
        self.orig = graphs.Program.__call__
        check = self

        def call(prog):
            state = graphs.tree_map(torch.clone, prog.state)
            inputs = graphs.tree_map(torch.clone, prog.inputs)
            out = check.orig(prog)
            before = dict(plane_fit.launches)
            new_state, eager_out = prog.fn(state, inputs)
            graphs.refill(state, new_state)
            plane_fit.launches.update(before)
            pairs = zip(graphs.tree_leaves((prog.state, out)),
                        graphs.tree_leaves((state, eager_out)))
            if not all(torch.equal(_bits(a), _bits(b)) for a, b in pairs):
                check.differ.append((prog.name, check.calls))
            check.calls += 1
            check.names.add(prog.name)
            return out
        graphs.Program.__call__ = call
        return self

    def __exit__(self, *exc):
        graphs.Program.__call__ = self.orig


@pytest.fixture(scope="module")
def sim(cuda):
    return synthetic.simulate(duration=6.0, n_azimuth=100, n_rings=12,
                              seed=6, image_size=SIZE, camera=CAM,
                              device="cuda")


@pytest.mark.parametrize("cache", [True, False], ids=["assoc", "search"])
def test_replay_matches_eager_function(cuda, sim, cache):
    cfg = small_cfg(cache)
    vision = VisionModule(cfg, device=cuda)
    plane_fit.reset_launches()
    it0 = lio.counts["iterations"]
    with EveryCall() as check:
        pipe = run_streams(LivoPipeline(cfg, vision=vision, device=cuda),
                           sim)
        torch.cuda.synchronize()
    assert any(n.startswith("vision_frame") for n in check.names)
    assert any(n.startswith("iekf") for n in check.names)
    assert check.calls > 20 and not check.differ, check.differ
    iterations = lio.counts["iterations"] - it0
    want = ({"knn_plane_assoc": len(pipe.records)} if cache
            else {"knn_plane_rows": iterations})
    assert {k: v for k, v in plane_fit.launches.items() if v} == want
    ts, ps, _ = pipe.trajectory()
    assert np.isfinite(ps).all() and len(vision.stats) > 10


def _scene(cuda, n_key=400):
    """Floor and two walls in a 1 m-voxel map; keypoints drawn from
    them, valid as a prefix."""
    rng = np.random.RandomState(23)
    u = rng.uniform(-6, 6, (4000, 2))
    world = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(4000)],
        np.c_[np.full(4000, 6.0), u[:, 0], u[:, 1] * 0.5 + 3],
        np.c_[u[:, 0], np.full(4000, 6.0), u[:, 1] * 0.5 + 3],
    ]).astype(np.float32)
    m = vm.make_map(1 << 14, 20, device=cuda)
    pts = torch.as_tensor(world, device=cuda)
    m, _ = vm.insert(m, pts, torch.ones(len(world), dtype=torch.bool,
                                        device=cuda), 1.0, 0.05, 16)
    keypts = pts[torch.as_tensor(rng.choice(len(world), n_key,
                                            replace=False), device=cuda)]
    valid = torch.arange(n_key, device=cuda) < 350
    return m, keypts, valid


ICP = dict(size_voxel_map=1.0, nb_voxels_visited=1, max_number_neighbors=20,
           min_number_neighbors=12, power_planarity=2.0,
           max_dist_to_plane=0.3, weight_alpha=0.9, weight_neighborhood=0.1,
           max_num_residuals=600, max_probe=16, max_iters=8,
           threshold_translation_norm=1e-3, threshold_orientation_norm=1e-2,
           laser_point_cov=0.001)


def _update(cuda, vmap, keypts, valid, programs, offset):
    from sr_livo_tpu_torch.models import eskf
    st = eskf.init_state(device=cuda)
    st = st._replace(p=torch.tensor(offset, device=cuda),
                     cov=torch.eye(17, device=cuda) * 1e-2)
    f = dict(device=cuda)
    return lio.iekf_update(
        st, vmap, keypts, valid, torch.zeros(3, **f), torch.eye(3, **f),
        torch.zeros(3, **f), torch.tensor(1, dtype=torch.int32, **f),
        cache_association=False, programs=programs, **ICP)


def test_launch_counters_advance_per_replay(cuda):
    vmap, keypts, valid = _scene(cuda)
    programs = {}
    for offset in ([0.1, -0.05, 0.05], [-0.08, 0.06, 0.0]):
        before = plane_fit.launches["knn_plane_rows"]
        _, summary = _update(cuda, vmap, keypts, valid, programs, offset)
        assert bool(summary.success)
        assert (plane_fit.launches["knn_plane_rows"] - before
                == int(summary.iterations) > 1)
    (prog,) = programs.values()
    assert prog.captures == 1 and prog.nodes > 1
    one = plane_fit.launches["knn_plane_rows"]
    prog()
    assert plane_fit.launches["knn_plane_rows"] == one + 1


def test_new_map_captures_again(cuda):
    """The search mode reads the map where it lies: a map that is not the
    program's is taken by capturing again, not by a copy."""
    vmap, keypts, valid = _scene(cuda)
    programs = {}
    _update(cuda, vmap, keypts, valid, programs, [0.1, -0.05, 0.05])
    (prog,) = programs.values()
    moved = vm.VoxelMap(*(t.clone() for t in vmap))
    out_a, sum_a = _update(cuda, moved, keypts, valid, programs,
                           [0.1, -0.05, 0.05])
    assert prog.captures == 2
    assert prog.inputs.rows.voxel_map.points is moved.points
    out_b, sum_b = _update(cuda, vmap, keypts, valid, {},
                           [0.1, -0.05, 0.05])
    assert torch.equal(out_a.p, out_b.p)
    assert int(sum_a.iterations) == int(sum_b.iterations)


def test_failed_capture_raises_without_eager_fallback(cuda):
    def fn(state, inputs):
        if bool(state.sum() > 0):            # a host read: not capturable
            return state + inputs, state
        return state - inputs, state
    x = torch.ones(4, device=cuda)
    prog = graphs.Program(fn, x, torch.ones(4, device=cuda), name="bad")
    with pytest.raises(RuntimeError):
        prog()
    torch.cuda.synchronize()
    assert prog.graph is None and prog.replays == 0
    assert x.tolist() == [1.0] * 4          # nothing ran in its place
    # the stream is out of capture mode: the card still works
    assert (x * 2).sum().item() == 8.0


def test_replaced_state_is_copied_before_the_replay(cuda):
    """An eager replacement of a state tensor (the colored-map insert, a
    checkpoint load) is copied into the buffer; the graph keeps its
    addresses and replays on the new values."""
    def fn(state, inputs):
        return state * 2 + inputs, state.sum()
    buf = torch.ones(3, device=cuda)
    prog = graphs.Program(fn, buf, torch.zeros(3, device=cuda), name="t")
    prog()
    assert buf.tolist() == [2.0] * 3
    replaced = torch.full((3,), 5.0, device=cuda)   # eager code's new tensor
    assert graphs.refill(prog.state, replaced) == 1
    out = prog()
    assert prog.state is buf and prog.captures == 1 and prog.replays == 2
    assert buf.tolist() == [10.0] * 3 and out.item() == 15.0
