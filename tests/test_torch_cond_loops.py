"""`utils.graphs.while_loop` and `graphs.cond` on the CPU.

Inside a `Program`'s capture on the card the IEKF's rounds become the body
of a WHILE node and the weak-solve retry an IF node (csrc/graph_cond.cu);
the card-only tests hold those bits (tests/test_torch_graphs_gpu.py).
Here, without a card:

  * outside a capture both keep today's semantics: an eager loop stops
    where its flag drops and `cond` calls `true_fn(None)` only when its
    predicate holds; in capture form every round runs masked and `cond`
    runs its branch with `active=pred` and selects; `masked=True` changes
    neither;
  * the IEKF's device counts: every round it runs is launched
    (`lio.launched_rounds`) and counted against the bound
    (`lio.active_rounds.added()`);
  * the node form's Python side, over a stand-in for the native glue:
    each body is captured once, nested bodies close in order, no `mark`
    lands in a body, a body that raises is closed, a loop stops at its
    bound whatever its flag, the launch counters count each body by the
    runs the device counted (`graphs.settle_counts`), and the IEKF's
    round count (`lio.active_rounds.added()`) counts a loop's body as the
    masked rounds up to its bound;
  * the sharded engine keeps masked rounds exactly when its mesh has a
    process group, and hands that choice to its loops and its retry.
"""
import contextlib
import ctypes

import numpy as np
import pytest
import torch

from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.models import eskf, lio
from sr_livo_tpu_torch.models.odometry import SweepInput
from sr_livo_tpu_torch.ops import voxel_map as vm
from sr_livo_tpu_torch.parallel import sharded_lio
from sr_livo_tpu_torch.parallel.mesh import Mesh
from sr_livo_tpu_torch.utils import graphs
from tests.torch_threads import one_intraop_thread  # noqa: F401

# launches of the nested bodies below
BODY_LAUNCHES = graphs.register_counter({"branch": 0, "round": 0})


def _count_to(limit: int, bound: int, log: list, masked: bool = False):
    """A loop adding 1 while the count is under `limit`, at most `bound`
    rounds; `log` gets one entry a round run."""
    def body(carry):
        n, go = carry
        log.append(1)
        n = n + go.to(n.dtype)
        return n, go & (n < limit)
    n0 = torch.zeros((), dtype=torch.int32)
    return graphs.while_loop(lambda c: c[1], body, (n0, n0 < limit), bound,
                             masked=masked)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("limit", [0, 1, 3, 5])
def test_while_loop_eagerly_stops_where_the_flag_drops(limit, masked):
    log = []
    n, go = _count_to(limit, 5, log, masked)
    assert int(n) == limit and len(log) == limit and not bool(go)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("limit", [0, 2, 5])
def test_while_loop_in_capture_form_runs_every_round(limit, masked):
    log = []
    with graphs.capture_form():
        n, go = _count_to(limit, 5, log, masked)
    assert int(n) == limit and len(log) == 5 and not bool(go)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pred", [False, True])
def test_cond_calls_its_branch_only_when_the_predicate_holds(pred, masked):
    seen = []

    def true_fn(active):
        seen.append(active)
        return (torch.tensor(2.0), torch.tensor(7))
    out = graphs.cond(torch.tensor(pred), true_fn,
                      (torch.tensor(1.0), torch.tensor(3)), masked=masked)
    assert seen == ([None] if pred else [])
    assert out[0].item() == (2.0 if pred else 1.0)
    assert out[1].item() == (7 if pred else 3)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pred", [False, True])
def test_cond_in_capture_form_masks_and_selects(pred, masked):
    p, seen = torch.tensor(pred), []

    def true_fn(active):
        seen.append(active)
        return (torch.tensor(2.0),)
    with graphs.capture_form():
        out = graphs.cond(p, true_fn, (torch.tensor(1.0),), masked=masked)
    assert len(seen) == 1 and seen[0] is p
    assert out[0].item() == (2.0 if pred else 1.0)


ICP = dict(size_voxel_map=1.0, nb_voxels_visited=1, max_number_neighbors=20,
           min_number_neighbors=12, power_planarity=2.0,
           max_dist_to_plane=0.3, weight_alpha=0.9, weight_neighborhood=0.1,
           max_num_residuals=600, max_probe=16, max_iters=6,
           threshold_translation_norm=1e-3, threshold_orientation_norm=1e-2,
           laser_point_cov=0.001)


@pytest.fixture(scope="module")
def scene():
    """A floor and two walls in a 1 m-voxel map, 200 keypoints on them,
    and a prior 10 cm off."""
    rng = np.random.RandomState(5)
    u = rng.uniform(-6, 6, (1500, 2))
    world = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(1500)],
        np.c_[np.full(1500, 6.0), u[:, 0], u[:, 1] * 0.5 + 3],
        np.c_[u[:, 0], np.full(1500, 6.0), u[:, 1] * 0.5 + 3],
    ]).astype(np.float32)
    pts = torch.as_tensor(world)
    vmap, _ = vm.insert(vm.make_map(1 << 12, 20), pts,
                        torch.ones(len(world), dtype=torch.bool), 1.0, 0.05,
                        16)
    keypts = pts[torch.as_tensor(rng.choice(len(world), 200, replace=False))]
    prior = eskf.init_state()._replace(p=torch.tensor([0.1, -0.05, 0.05]),
                                       cov=torch.eye(17) * 1e-2)
    return prior, vmap, keypts


def _update(scene, cache=True):
    prior, vmap, keypts = scene
    return lio.iekf_update(
        prior, vmap, keypts, torch.ones(len(keypts), dtype=torch.bool),
        torch.zeros(3), torch.eye(3), torch.zeros(3),
        torch.tensor(1, dtype=torch.int32), cache_association=cache, **ICP)


def _counts():
    return (lio.counts["iterations"], lio.launched_rounds.read(),
            lio.active_rounds.read(), lio.active_rounds.added(),
            lio.launched_rounds.added())


@pytest.mark.parametrize("form", ["eager", "capture"])
def test_iekf_counts_the_rounds_it_launches(scene, form):
    before = _counts()
    with graphs.counting(), (graphs.capture_form() if form == "capture"
                             else contextlib.nullcontext()):
        _, summary = _update(scene)
    run, launched, active, added, l_added = (
        a - b for a, b in zip(_counts(), before))
    assert bool(summary.success)
    assert active == int(summary.iterations) and 1 < active
    if form == "eager":       # the loop stops where the flag drops
        assert run == launched == added == l_added == active
    else:                     # every round up to the bound, masked
        assert run == launched == added == l_added == ICP["max_iters"] + 1
        assert active < added


class FakeGlue:
    """Stands in for csrc/graph_cond.cu: logs each node's opening and
    closing and captures nothing, so a body runs once, eagerly."""

    def __init__(self):
        self.log = []
        self.end_flags = []       # the condition a WHILE body's end sets

    def cond_begin(self, stream, loop, flag, *out):
        self.log.append(("begin", loop))
        return 0

    def cond_end(self, stream, loop, handle, flag, parent, node):
        self.log.append(("end", loop))
        if loop:
            self.end_flags.append(ctypes.c_bool.from_address(flag).value)
        return 0

    def cond_abort(self, stream, parent, node):
        self.log.append(("abort",))
        return 0

    def cond_error(self, err):
        return b"fake"


@pytest.fixture
def node_form(monkeypatch):
    """Code within runs as a `Program`'s capture on the card records it
    with conditional nodes, over `FakeGlue`; stage events record into a
    list (nothing may land there from a body)."""
    glue = FakeGlue()
    monkeypatch.setattr(graphs, "_cond_lib", lambda: glue)
    monkeypatch.setattr(graphs, "_route_to_pool", lambda cap: None)
    monkeypatch.setattr(graphs, "_stream_handle", lambda device: 0)
    monkeypatch.setattr(graphs, "_builds_nodes",
                        lambda flag: graphs._capture() is not None)
    marks = []
    graphs._FORM.capture = {"bodies": [], "routed": True, "tallies": [],
                            "runs": torch.zeros(16, dtype=torch.int64)}
    graphs._MARKS["into"] = marks
    try:
        with graphs.capture_form():
            yield glue, marks
    finally:
        graphs._FORM.capture = None
        graphs._MARKS["into"] = None


def test_node_form_captures_each_body_once(node_form, monkeypatch):
    glue, marks = node_form
    monkeypatch.setattr(graphs, "mark", lambda name: marks.append(name)
                        if graphs._MARKS["into"] is not None else None)
    log = []

    def retry(active):
        assert active is None          # the IF body runs only when taken
        graphs.mark("in_body")
        n, _ = _count_to(3, 5, log)
        return (n.to(torch.float32),)
    out = graphs.cond(torch.tensor(True), retry, (torch.tensor(-1.0),))
    assert glue.log == [("begin", 0), ("begin", 1), ("end", 1), ("end", 0)]
    # the loop's round captured once; its buffers written back in place
    assert log == [1] and out[0].item() == 1.0
    assert marks == [] and graphs._MARKS["into"] is marks
    assert len(graphs._capture()["bodies"]) == 2


def test_node_form_closes_a_body_that_raises(node_form):
    glue, marks = node_form

    def broken(carry):
        raise ValueError("host read")
    with pytest.raises(ValueError):
        graphs.while_loop(lambda c: c[0], broken,
                          (torch.tensor(True),), 4)
    assert glue.log == [("begin", 1), ("abort",)]
    assert graphs._MARKS["into"] is marks


def test_node_form_counts_a_loop_body_as_its_bound(node_form, scene):
    """The round count that `iekf.useful_round_pct` divides by counts the
    body as the bound's rounds; the launch counters wait for the device's
    count of the body's runs (here one, the stand-in runs it once)."""
    glue, _ = node_form
    before = _counts()
    with graphs.counting():
        _update(scene)
    run, launched, _, added, l_added = (a - b for a, b in
                                        zip(_counts(), before))
    assert glue.log == [("begin", 1), ("end", 1)]
    assert added == l_added == ICP["max_iters"] + 1
    assert run == 0 and launched == 1
    cap = graphs._capture()
    graphs._fold(cap["runs"], cap["tallies"])
    assert lio.counts["iterations"] - before[0] == 1


@pytest.mark.parametrize("bound", [1, 2, 4])
def test_node_form_stops_a_loop_at_its_bound(node_form, bound):
    """A round whose body keeps the flag up sets the condition from the
    flag and the node's own round count: down after `bound` rounds."""
    glue, _ = node_form
    graphs.while_loop(lambda c: c[0], lambda c: c, (torch.tensor(True),),
                      bound)
    graphs.while_loop(lambda c: c[0], lambda c: (~c[0],),
                      (torch.tensor(True),), bound)
    assert glue.end_flags == [bound > 1, False]


def test_node_form_counts_each_body_by_its_runs(node_form):
    """A body's launches leave the host counters at capture and come back
    times the runs of its slot: an IF body taken 3 times whose WHILE body
    ran 7 rounds in all, nested."""
    def round_(carry):
        BODY_LAUNCHES["round"] += 1
        return carry[0] + 1, carry[1]

    def branch(active):
        BODY_LAUNCHES["branch"] += 1
        n, _ = graphs.while_loop(lambda c: c[1], round_,
                                 (torch.tensor(0), torch.tensor(True)), 6)
        return (n,)
    before = dict(BODY_LAUNCHES)
    graphs.cond(torch.tensor(True), branch, (torch.tensor(-1),))
    assert BODY_LAUNCHES == before
    cap = graphs._capture()
    assert [list(inc for _, inc in t) for t in cap["tallies"]] == [
        [{"branch": 1}], [{"round": 1}]]
    cap["runs"][:2] = torch.tensor([3, 7])
    graphs._fold(cap["runs"], cap["tallies"])
    assert (BODY_LAUNCHES["branch"] - before["branch"],
            BODY_LAUNCHES["round"] - before["round"]) == (3, 7)
    assert int(cap["runs"].abs().sum()) == 0


def _sharded_cfg() -> LivoConfig:
    cfg = LivoConfig()
    cfg.retry_wider_neighborhood = True
    cfg.shapes.max_sweep_points = 1024
    cfg.shapes.max_frame_points = 1024
    cfg.shapes.max_keypoints = 128
    cfg.shapes.max_imu_samples = 8
    cfg.shapes.map_capacity = 1 << 12
    cfg.shapes.map_halo_voxels = 3
    return cfg


@pytest.mark.parametrize("group", [None, "a process group"])
def test_sharded_engine_keeps_masked_rounds_over_a_group(group,
                                                         monkeypatch):
    """The choice follows the mesh: over a process group (NCCL's psums in
    every round) masked rounds and both retry branches, else nodes; the
    engine's IEKF loops and retry get it.  A world of one runs a steady
    step here, its group stood in for by the choice alone."""
    cfg = _sharded_cfg()
    mesh = Mesh(0, 1, "cpu", group=None if group is None else object())
    assert sharded_lio.ShardedLioEngine(cfg, mesh).masked_loops == (
        group is not None)
    eng = sharded_lio.ShardedLioEngine(cfg, Mesh(0, 1, "cpu"))
    eng.masked_loops = group is not None
    seen = []
    for name in ("while_loop", "cond"):
        orig = getattr(graphs, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen.append((_name, k.get("masked")))
            return _orig(*a, **k)
        monkeypatch.setattr(graphs, name, spy)
    rng = np.random.RandomState(2)
    n, s = cfg.shapes.max_sweep_points, cfg.shapes.max_imu_samples
    sweep = SweepInput(
        raw_pts=torch.as_tensor(rng.uniform(-8, 8, (n, 3)),
                                dtype=torch.float32),
        t_rel=torch.zeros(n), pt_valid=torch.ones(n, dtype=torch.bool),
        imu_t=torch.linspace(0.0, 0.1, s), imu_dt=torch.full((s,), 0.1 / s),
        imu_acc=torch.tensor([0.0, 0.0, 9.81]).expand(s, 3).clone(),
        imu_gyr=torch.zeros(s, 3), imu_valid=torch.ones(s, dtype=torch.bool),
        do_optimize=torch.tensor(True),
        threshold_capacity=torch.tensor(1, dtype=torch.int32))
    with graphs.capture_form():
        eng.step(eng.init_state(), eng.make_map(), sweep,
                 frame_id=cfg.odometry_options.init_num_frames + 1)
    assert {name for name, _ in seen} == {"while_loop", "cond"}
    assert all(m == (group is not None) for _, m in seen)
