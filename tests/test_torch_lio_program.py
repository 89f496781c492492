"""The LIO step program and the colored-map insert program of the port
(sr_livo_tpu_torch.models.odometry.LioEngine.step and
models.vision.VisionModule._gated_insert) on the CPU, against the JAX
package's jitted `LioEngine.step` and `color_insert`.

On the card each is one CUDA graph replay whose loops run masked rounds
up to proven bounds, or in the step's IEKF and retry conditional nodes
(utils/graphs.py; tests/test_torch_graphs_gpu.py holds those against
the masked form); on the CPU the same function runs directly and stops
each loop where the JAX `while_loop` does.  These tests hold both forms:
the eager one, and the capture form (`graphs.capture_form()`), which
runs every round as the masked graph does.

  * step parity, in lockstep: every sweep of a short run (the rig and
    tolerances of test_torch_odometry.py: phases `init`, `steady` and
    `steady_dense`, both association modes, the weak-solve retry on and
    off) goes from the JAX engine's own state, map and sweep through the
    JAX step and through the port's step in both forms.  Map keys,
    signatures, counts and point ids, the inserted and frame masks and
    the record's success, residual count and iterations are the same
    bits; the pose, velocity and biases are within that file's bars; the
    two port forms agree bit for bit on every output;
  * colored-map insert parity: the port's insert program in both forms
    against the JAX package's `insert_sweep_points` over clustered,
    repeated and gated sweeps, every field bit for bit;
  * `bucket_dedup_min` (a sort, where JAX runs claim rounds) against the
    JAX function, bit for bit, under hypothesis: all-equal keys, heavy
    collisions, sparse validity;
  * the claim-round bounds: crowded tables, where one probe chain is
    fought over, run at most `max_probe + 1` rounds of the eager loop,
    and the masked form stops changing anything after them;
  * the subsample priority, an upload, is cached before the step's
    program exists.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sr_livo_tpu.config import LivoConfig as JCfg
from sr_livo_tpu.models.vision import VisionModule as JVision
from sr_livo_tpu.ops import color_map as jcm
from sr_livo_tpu.ops import frame as jframe
from sr_livo_tpu.ops import voxel_map as jvm
from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.config import LivoConfig as TCfg
from sr_livo_tpu_torch.models import odometry as todo
from sr_livo_tpu_torch.models.vision import VisionModule as TVision
from sr_livo_tpu_torch.ops import color_map as tcm
from sr_livo_tpu_torch.ops import frame as tframe
from sr_livo_tpu_torch.ops import voxel_map as tvm
from sr_livo_tpu_torch.utils import graphs
from tests.test_torch_odometry import _cfg, _gyr_rate, sims  # noqa: F401
from tests.test_torch_vision import _port_cfg
from tests.test_vision_pipeline import _cfg as _vision_cfg
from tests.torch_threads import one_intraop_thread  # noqa: F401

N_FRAMES = 10


def _tensor(x):
    return torch.from_numpy(np.array(x))


def _same_bits(a, b, what):
    la, lb = graphs.tree_leaves(a), graphs.tree_leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, what
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0))), what


def _lockstep(jsim, cache, retry):
    """Per sweep of the JAX run: (JAX output, port eager output, port
    capture-form output, phase), each port step starting from the JAX
    engine's state and map."""
    jpipe = JPipe(_cfg(JCfg, cache, retry))
    eager = todo.LioEngine(_cfg(TCfg, cache, retry), device="cpu")
    captured = todo.LioEngine(_cfg(TCfg, cache, retry), device="cpu")
    for (t, a, g) in jsim.imu:
        jpipe.push_imu(t, a, g)
    for c in jsim.lidar_chunks:
        jpipe.push_points(c)
    for (t, img) in jsim.images:
        jpipe.push_image(t, img)
    steps = []
    while len(steps) < N_FRAMES:
        meas = jpipe.cutter.get()
        assert meas is not None, "stream ended before enough frames"
        if not jpipe._init_or_skip(meas):
            continue
        k = jpipe.index_frame
        sweep = jpipe._host_prepare_measurement(meas, k)[2]
        gyr = _gyr_rate(jpipe.cfg, k)
        ports = []
        for engine, form in ((eager, None), (captured, graphs.capture_form)):
            # copies first: the JAX step donates the map
            args = (convert.eskf_state_from_numpy(jpipe.state),
                    convert.voxel_map_from_numpy(jpipe.voxel_map),
                    todo.WireSweep(*(_tensor(x) for x in sweep))
                    if hasattr(sweep, "pts_q") else todo.SweepInput(
                        *(_tensor(x) for x in sweep)))
            if form is None:
                out = engine.step(*args, k, gyr_rate=gyr)
            else:
                with form():
                    out = engine.step(*args, k, gyr_rate=gyr)
            # copies: the program's buffers are the next step's
            ports.append(graphs.tree_map(torch.clone, out))
        jout = jpipe.engine.step(jpipe.state, jpipe.voxel_map, sweep, k,
                                 gyr_rate=gyr)
        jpipe.state, jpipe.voxel_map = jout.state, jout.voxel_map
        jpipe.index_frame += 1
        # host copies: the next JAX step donates this map
        jrec = dict({k: np.asarray(v)
                     for k, v in jout.voxel_map._asdict().items()},
                    inserted=np.asarray(jout.inserted),
                    frame_valid=np.asarray(jout.frame_valid),
                    record=np.asarray(jout.record, np.float64))
        steps.append((jrec, *ports, eager.phase(k, gyr)))
    return steps, eager


@pytest.mark.parametrize("cache,retry", [
    (True, False), (False, False), (True, True), (False, True)],
    ids=["assoc", "search", "assoc-retry", "search-retry"])
def test_step_program_matches_jax(sims, cache, retry):  # noqa: F811
    jsim, _ = sims
    steps, engine = _lockstep(jsim, cache, retry)
    phases = [s[3] for s in steps]
    assert set(phases) == {"init", "steady", "steady_dense"}, phases
    # one program per phase
    assert sorted(k[0] for k in engine.programs) == sorted(set(phases))
    for i, (jrec, eager, captured, _) in enumerate(steps):
        _same_bits(eager, captured, f"sweep {i}: eager vs capture form")
        tmap = convert.voxel_map_to_numpy(eager.voxel_map)
        for name in ("keys", "sig", "counts", "point_ids"):
            np.testing.assert_array_equal(tmap[name], jrec[name],
                                          err_msg=f"sweep {i}: map {name}")
        for name in ("inserted", "frame_valid"):
            np.testing.assert_array_equal(getattr(eager, name).numpy(),
                                          jrec[name],
                                          err_msg=f"sweep {i}: {name}")
        t_row = eager.record.double().numpy()
        j_row = jrec["record"]
        # [p(3), q(4), v(3), ba(3), bg(3), success, n_residuals, iters]
        np.testing.assert_array_equal(t_row[16:], j_row[16:],
                                      err_msg=f"sweep {i}")
        np.testing.assert_allclose(t_row[0:3], j_row[0:3], atol=5e-5, rtol=0)
        np.testing.assert_allclose(t_row[3:7], j_row[3:7], atol=1e-6, rtol=0)
        np.testing.assert_allclose(t_row[7:10], j_row[7:10], atol=5e-4,
                                   rtol=0)
        np.testing.assert_allclose(t_row[10:16], j_row[10:16], atol=5e-5,
                                   rtol=0)
        np.testing.assert_allclose(tmap["points"], jrec["points"],
                                   atol=1e-4, rtol=0)
    assert all(s[1].record[16] > 0.5 for s in steps)


def _insert_sweeps(seed=3):
    """Sweeps of clustered points on a floor and a wall, each sweep
    overlapping the last (dedup hits, new and known voxels), one of them
    with a failed solve (gated away)."""
    rng = np.random.RandomState(seed)
    sweeps = []
    for k in range(6):
        u = rng.uniform(-3, 3, (2048, 2)) + 0.4 * k
        pts = np.concatenate([
            np.c_[u[:1024, 0], u[:1024, 1], np.zeros(1024)],
            np.c_[np.full(1024, 3.0), u[1024:, 0], u[1024:, 1]]])
        pts[1::7] = pts[:-1:7]                # exact repeats
        valid = rng.rand(2048) < 0.9
        sweeps.append((pts.astype(np.float32), valid, k != 3,
                       np.float32(0.1 * k)))
    return sweeps


def test_color_insert_program_matches_jax():
    jcfg = _vision_cfg()
    jcfg.map_options.add_point_step = 2
    tcfg = _port_cfg(jcfg)
    jv = JVision(jcfg)
    tv = {form: TVision(tcfg, device="cpu") for form in ("eager", "capture")}
    for pts, valid, ok, t in _insert_sweeps():
        jv.insert_sweep_points(jnp.asarray(pts), jnp.asarray(valid),
                               jnp.asarray(ok), float(t))
        for form, v in tv.items():
            args = (torch.as_tensor(pts), torch.as_tensor(valid),
                    torch.tensor(ok), float(t))
            if form == "eager":
                v.insert_sweep_points(*args)
            else:
                with graphs.capture_form():
                    v.insert_sweep_points(*args)
        got = {f: convert.color_map_to_numpy(v.color_map)
               for f, v in tv.items()}
        for form in tv:
            for name in ("reg", "count", "vox_last_visit", "dedup_sig",
                         "recent_slots"):
                np.testing.assert_array_equal(
                    got[form][name], np.asarray(getattr(jv.color_map, name)),
                    err_msg=f"{form}: {name}")
            for name, x in got[form]["vox"].items():
                np.testing.assert_array_equal(
                    x, np.asarray(getattr(jv.color_map.vox, name)),
                    err_msg=f"{form}: vox.{name}")
            assert int(tv[form].n_new_visited) == int(jv.n_new_visited)
    assert int(jv.color_map.count) > 1000
    # one program, its state the module's colored map
    for v in tv.values():
        (prog,) = v.insert_programs.values()
        assert graphs.same_leaves(prog.state, v.color_map)


@st.composite
def _dedup_case(draw):
    n = draw(st.integers(1, 400))
    kind = draw(st.sampled_from(["equal", "few", "spread", "wide"]))
    rng = np.random.RandomState(draw(st.integers(0, 2 ** 31 - 1)))
    if kind == "equal":
        h = np.full(n, draw(st.integers(0, 2 ** 31 - 1)), np.int64)
    elif kind == "few":
        h = rng.choice(rng.randint(0, 2 ** 31, 3), n)
    elif kind == "spread":
        h = rng.randint(0, max(n // 4, 1), n) * 2 ** 20
    else:
        h = rng.randint(0, 2 ** 31, n)
    pri = rng.permutation(n) * draw(st.sampled_from([1, 7919]))
    valid = rng.rand(n) < draw(st.sampled_from([0.0, 0.3, 1.0]))
    return h.astype(np.int32), pri.astype(np.int32), valid


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_dedup_case())
def test_bucket_dedup_min_matches_jax(case):
    h, pri, valid = case
    want = np.asarray(jframe.bucket_dedup_min(
        jnp.asarray(h), jnp.asarray(pri), jnp.asarray(valid)))
    got = tframe.bucket_dedup_min(torch.as_tensor(h), torch.as_tensor(pri),
                                  torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(got, want)


def _crowded_points(capacity, n_voxels, voxel_size=1.0):
    """Points of `n_voxels` distinct voxels whose hashes all land on one
    slot of a `capacity`-slot table (x steps by `capacity` voxels)."""
    x = (np.arange(n_voxels) * capacity + 0.5) * voxel_size
    pts = np.c_[x, np.full(n_voxels, 0.5 * voxel_size),
                np.full(n_voxels, 0.5 * voxel_size)].astype(np.float32)
    return np.repeat(pts, 2, axis=0)            # two points per voxel


class _Rounds:
    """Counts the rounds an eager loop runs (`graphs.go_on` calls that
    let a round run) within the block."""

    def __enter__(self):
        self.n, self.orig = 0, graphs.go_on

        def counted(flag):
            go = self.orig(flag)
            self.n += go
            return go
        graphs.go_on = counted
        return self

    def __exit__(self, *exc):
        graphs.go_on = self.orig


@pytest.mark.parametrize("max_probe", [4, 8])
def test_insert_claim_rounds_bounded(max_probe):
    """A table where one probe chain is fought over by more voxels than it
    has slots: the eager claim loop runs exactly max_probe + 1 rounds
    (one winner a round, then the chain is full and the rest drop), and
    the masked form, the JAX insert and the eager one agree."""
    cap = 64
    pts = _crowded_points(cap, max_probe + 4)
    valid = np.ones(len(pts), bool)
    kw = dict(voxel_size=1.0, min_distance=0.0, max_probe=max_probe)
    jmap, jacc = jvm.insert(jvm.make_map(cap, 4), jnp.asarray(pts),
                            jnp.asarray(valid), **kw)
    outs = {}
    for form in ("eager", "capture"):
        tmap = tvm.make_map(cap, 4)
        with _Rounds() as rounds:
            if form == "eager":
                outs[form] = tvm.insert(tmap, torch.as_tensor(pts),
                                        torch.as_tensor(valid), **kw)
            else:
                with graphs.capture_form():
                    outs[form] = tvm.insert(tmap, torch.as_tensor(pts),
                                            torch.as_tensor(valid), **kw)
        if form == "eager":
            assert rounds.n == max_probe + 1
    _same_bits(outs["eager"], outs["capture"], "eager vs capture form")
    tmap, tacc = outs["eager"]
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    got = convert.voxel_map_to_numpy(tmap)
    for name in ("keys", "sig", "counts", "point_ids", "points"):
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(jmap, name)))
    # max_probe voxels placed, two points each; the rest dropped
    assert int(tacc.sum()) == 2 * max_probe


@pytest.mark.parametrize("max_probe", [4, 8])
def test_color_dedup_claim_rounds_bounded(max_probe):
    """The colored map's dedup claims on a crowded set: at most
    max_probe + 1 eager rounds, and both forms give the JAX result."""
    cap = 32
    coords = torch.as_tensor(_crowded_points(cap, max_probe + 3)
                             ).to(torch.int32)
    valid = torch.ones(coords.shape[0], dtype=torch.bool)
    sig0 = torch.full((cap,), tvm.SIG_EMPTY, dtype=torch.int32)
    j_sig, j_new = jcm._claim_dedup(jnp.asarray(sig0.numpy()),
                                    jnp.asarray(coords.numpy()),
                                    jnp.asarray(valid.numpy()), max_probe)
    with _Rounds() as rounds:
        e_sig, e_new = tcm._claim_dedup(sig0, coords, valid, max_probe)
    assert rounds.n == max_probe + 1
    with graphs.capture_form():
        c_sig, c_new = tcm._claim_dedup(sig0, coords, valid, max_probe)
    for sig, new in ((e_sig, e_new), (c_sig, c_new)):
        np.testing.assert_array_equal(sig.numpy(), np.asarray(j_sig))
        np.testing.assert_array_equal(new.numpy(), np.asarray(j_new))
    assert int(e_new.sum()) == max_probe


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 40),
       st.sampled_from([2, 4, 8]))
def test_claim_rounds_never_exceed_the_bound(seed, n_voxels, max_probe):
    """Random crowded inserts into a part-filled small table: the eager
    loop never needs more than max_probe + 1 rounds, and the masked form
    agrees with it bit for bit."""
    rng = np.random.RandomState(seed)
    cap = 32
    base = (rng.randint(-3, 3, (n_voxels, 3)) * [cap, 1, 1]
            + rng.randint(0, 2, (n_voxels, 3)) + 0.5).astype(np.float32)
    pts = np.repeat(base, 2, axis=0)
    valid = rng.rand(len(pts)) < 0.8
    kw = dict(voxel_size=1.0, min_distance=0.0, max_probe=max_probe)
    prefill = tvm.make_map(cap, 4)
    tvm.insert(prefill, torch.as_tensor(pts[::5] + np.float32(2.0)),
               torch.ones(len(pts[::5]), dtype=torch.bool), **kw)
    outs = []
    for form in (None, graphs.capture_form):
        tmap = tvm.VoxelMap(*(t.clone() for t in prefill))
        with _Rounds() as rounds:
            if form is None:
                outs.append(tvm.insert(tmap, torch.as_tensor(pts),
                                       torch.as_tensor(valid), **kw))
                assert rounds.n <= max_probe + 1
            else:
                with form():
                    outs.append(tvm.insert(tmap, torch.as_tensor(pts),
                                           torch.as_tensor(valid), **kw))
    _same_bits(outs[0], outs[1], "eager vs capture form")


def test_priority_uploaded_before_the_program(monkeypatch):
    """The subsample priority, an upload from the host, is on the device
    before the step program exists (a capture could not upload it)."""
    todo._subsample_priority.cache_clear()
    cached = []
    init = graphs.Program.__init__

    def recorded(self, *args, **kw):
        cached.append(todo._subsample_priority.cache_info().currsize)
        init(self, *args, **kw)
    monkeypatch.setattr(graphs.Program, "__init__", recorded)
    engine = todo.LioEngine(_cfg(TCfg, True), device="cpu")
    rng = np.random.RandomState(8)
    n, s = 256, 8
    sweep = todo.SweepInput(
        raw_pts=torch.as_tensor(rng.uniform(-5, 5, (n, 3)),
                                dtype=torch.float32),
        t_rel=torch.linspace(0, 0.1, n),
        pt_valid=torch.ones(n, dtype=torch.bool),
        imu_t=torch.linspace(0, 0.1, s), imu_dt=torch.full((s,), 0.0125),
        imu_acc=torch.tensor([[0.0, 0.0, 9.81]]).repeat(s, 1),
        imu_gyr=torch.zeros(s, 3), imu_valid=torch.ones(s, dtype=torch.bool),
        do_optimize=torch.tensor(False),
        threshold_capacity=torch.tensor(1, dtype=torch.int32))
    out = engine.step(engine.init_state(), engine.make_map(), sweep, 1)
    assert cached == [1] and bool(out.frame_valid.any())
