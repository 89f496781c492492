"""The port's captured programs (sr_livo_tpu_torch.utils.graphs) on the CPU,
against the JAX package.

Two programs run the main path's fixed-shape bodies: the vision frame
program (`VisionModule._fused_frame_core`, the counterpart of the JAX
package's jitted `VisionModule._fused_frame_core`) and the IEKF iteration
program (`lio.iteration_fn`, one round of the IEKF `while_loop` inside the
JAX package's jitted `LioEngine._raw_step`).  On the card each is a CUDA
graph replay; on the CPU the same function runs directly over the same
buffers, refilled in place between calls, which is what these tests hold:

  * parity: one LIO-only run of the port records what the pipeline hands
    the vision module for each sweep of a 5 s run (test_vision_pipeline
    .py's rig, 120 x 160 images); the JAX package's `process_frame` (the
    jitted `_fused_frame_core`) and the port's program then see the same
    sweeps, the port's RANSAC getting the JAX key chain's Gumbel draws.
    Bars of test_torch_vision.py: kept tracks within 5% on every frame,
    intrinsics within 0.5 px, `td` within 1e-3 s, colored points within
    2%.  The IEKF program runs three updates in a row in each association
    mode on test_torch_lio.py's scene against `iekf_update` of the JAX
    package, with that file's bars;
  * the refill contract: a program whose buffers held call A and were
    refilled with call B gives a fresh program's result on B, bit for bit
    (a value of call A baked into the program would show here);
  * aliasing: the stats and records the pipeline keeps are its own
    copies, not the programs' outputs, and hold what each call gave;
  * no host read: each program's function, run under a dispatch mode
    that fails on a host read (`item`, a 0-d or boolean-mask index,
    `nonzero`) or on a host value uploaded into an op (other than a
    fill), which a CUDA graph capture refuses;
  * the helper's pytree and refill rules.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from sr_livo_tpu.models import lio as jlio
from sr_livo_tpu.models.vision import VisionModule as JVision
from sr_livo_tpu.runtime import synthetic as jsyn
from sr_livo_tpu.utils.profiling import StageTimers as JTimers
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.models import lio as tlio
from sr_livo_tpu_torch.models.vision import VisionModule as TVision
from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.pipeline import run_streams as trun
from sr_livo_tpu_torch.utils import graphs
from sr_livo_tpu_torch.utils.profiling import StageTimers as TTimers
from tests.test_torch_lio import ICP, scene  # noqa: F401
from tests.test_torch_vision import SIM, JaxKeyChain, _port_cfg
from tests.test_vision_pipeline import _cfg
from tests.torch_threads import one_intraop_thread  # noqa: F401


class Recorder:
    """Stands in for the vision module of a LIO-only port run and records,
    as numpy, what the pipeline hands it per sweep."""

    device = torch.device("cpu")

    def __init__(self):
        self.sweeps = []

    @staticmethod
    def _host_prepare(image):
        return image, False

    def _record(self, rendered, t, image, out):
        self.sweeps.append(dict(
            rendered=rendered, time_image=t, image=image,
            q=out.state.q.numpy().copy(), p=out.state.p.numpy().copy(),
            pts=out.frame_pts_world.numpy().copy(),
            valid=out.frame_valid.numpy().copy(),
            success=out.summary.success.numpy().copy()))

    def process_frame(self, pipeline, meas, out, host_img=None):
        self._record(True, meas.time_image, meas.image, out)

    def insert_sweep_points(self, pts, valid, success, obs_time):
        raise AssertionError("every sweep of this run is image-aligned")


def _sweep(rec, xp):
    state = types.SimpleNamespace(q=xp(rec["q"]), p=xp(rec["p"]))
    return types.SimpleNamespace(
        state=state, frame_pts_world=xp(rec["pts"]),
        frame_valid=xp(rec["valid"]),
        summary=types.SimpleNamespace(success=xp(rec["success"])))


@pytest.fixture(scope="module")
def sweeps():
    sim = jsyn.simulate(**dict(SIM, duration=5.0))
    rec = Recorder()
    trun(TPipe(_port_cfg(), vision=rec, device="cpu"), sim)
    assert len(rec.sweeps) >= 15
    return rec.sweeps


class CallLog:
    """Within the block, every call of a program whose name starts with
    `prefix`: clones of its state and inputs before the call and of its
    state and outputs after it."""

    def __init__(self, prefix):
        self.prefix, self.calls = prefix, []

    def __enter__(self):
        self.orig = graphs.Program.__call__
        log = self

        def call(prog):
            if not prog.name.startswith(log.prefix):
                return log.orig(prog)
            entry = dict(prog=prog,
                         state=graphs.tree_map(torch.clone, prog.state),
                         inputs=graphs.tree_map(torch.clone, prog.inputs),
                         buffers=[t.data_ptr() for t in
                                  graphs.tree_leaves(prog.state)])
            out = log.orig(prog)
            entry.update(after=graphs.tree_map(torch.clone, prog.state),
                         out=graphs.tree_map(torch.clone, out),
                         out_ptrs=[t.data_ptr()
                                   for t in graphs.tree_leaves(out)])
            log.calls.append(entry)
            return out
        graphs.Program.__call__ = call
        return self

    def __exit__(self, *exc):
        graphs.Program.__call__ = self.orig


@pytest.fixture(scope="module")
def vision_runs(sweeps):
    """The JAX and the port vision modules over the recorded sweeps."""
    jv = JVision(_cfg())
    tv = TVision(_port_cfg(), device="cpu", noise_hook=JaxKeyChain())
    jpipe = types.SimpleNamespace(timers=JTimers())
    tpipe = types.SimpleNamespace(timers=TTimers(device="cpu"))
    with CallLog("vision_frame") as log:
        for rec in sweeps:
            meas = types.SimpleNamespace(time_image=rec["time_image"],
                                         image=rec["image"])
            jv.process_frame(jpipe, meas, _sweep(rec, jnp.asarray))
            tv.process_frame(tpipe, meas, _sweep(rec, torch.as_tensor))
    pending = list(tv._stats_pending)
    return jv, tv, log, pending


def test_vision_program_matches_jax(vision_runs):
    jv, tv, log, _ = vision_runs
    assert list(tv.programs) == [False]
    prog = tv.programs[False]
    # the first frame seeds the tracks eagerly (no stats row); every later
    # one is one call of the program, over the same buffers, refilled in
    # place
    assert len(log.calls) == len(tv.stats) >= 10
    assert all(c["prog"] is prog for c in log.calls)
    assert all(c["buffers"] == log.calls[0]["buffers"] for c in log.calls)
    assert all(a is b for a, b in zip(
        graphs.tree_leaves(prog.state),
        graphs.tree_leaves((tv.camera, tv.color_map, tv.tracks,
                            tv.prev_pyr))))

    tstats, jstats = tv.stats, jv.stats
    assert [s[0] for s in tstats] == [s[0] for s in jstats]
    kept_t = np.array([s[1] for s in tstats])
    kept_j = np.array([s[1] for s in jstats])
    assert kept_j[3:].min() > 30
    assert np.all(np.abs(kept_t - kept_j) <= 0.05 * kept_j), (kept_t, kept_j)
    intr = tv.camera.intr.numpy()
    assert np.abs(intr - np.asarray(jv.camera.intr)).max() < 0.5
    assert abs(float(tv.camera.td) - float(jv.camera.td)) < 1e-3
    n_t = int(((tv.color_map.reg_valid) & (tv.color_map.n_rgb >= 1)).sum())
    j_cm = jv.color_map
    n_j = int(np.sum(np.asarray(j_cm.reg_valid)
                     & (np.asarray(j_cm.n_rgb) >= 1)))
    assert n_j > 500 and abs(n_t - n_j) <= 0.02 * n_j


def _assert_same_bits(a, b):
    la, lb = graphs.tree_leaves(a), graphs.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0)))


def _contract(call_a, call_b):
    """A program that ran call A, refilled with call B, against a fresh
    program on call B."""
    fn = call_a["prog"].fn
    clone = (lambda t: graphs.tree_map(torch.clone, t))
    used = graphs.Program(fn, clone(call_a["state"]), clone(call_a["inputs"]))
    used()
    assert graphs.refill(used.state, call_b["state"]) > 0
    assert graphs.refill(used.inputs, call_b["inputs"]) > 0
    out_used = used()
    fresh = graphs.Program(fn, clone(call_b["state"]),
                           clone(call_b["inputs"]))
    out_fresh = fresh()
    _assert_same_bits(out_used, out_fresh)
    _assert_same_bits(used.state, fresh.state)
    # and the run's own call B
    _assert_same_bits(out_fresh, call_b["out"])
    _assert_same_bits(fresh.state, call_b["after"])


def test_vision_program_refill_contract(vision_runs):
    _, _, log, _ = vision_runs
    _contract(log.calls[2], log.calls[6])


def test_vision_stats_are_copies(vision_runs):
    """The stats kept per frame are the module's own copies: distinct
    tensors, none of them the program's output, each holding what its
    call gave."""
    _, tv, log, pending = vision_runs
    kept = [v for (_, v) in pending]
    assert len(kept) == len(log.calls) >= 3
    ptrs = [v.data_ptr() for v in kept]
    assert len(set(ptrs)) == len(ptrs)
    outs = {p for c in log.calls for p in c["out_ptrs"]}
    assert not outs & set(ptrs)
    for v, call in zip(kept, log.calls):
        assert torch.equal(v, call["out"])


@functools.lru_cache(maxsize=2)
def _jax_iekf(cache):
    """The JAX package's `iekf_update`, jitted once per mode (as its
    engine runs it)."""
    def update(st, m, keypts, valid, seed_p):
        return jlio.iekf_update(
            st, m, keypts, valid, jnp.zeros(3, jnp.float32),
            jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
            jnp.int32(1), seed_q=st.q, seed_p=seed_p,
            cache_association=cache, **ICP)
    return jax.jit(update)


def _jax_update(st, m, keypts, valid, seed_p, cache):
    return _jax_iekf(cache)(st, m, jnp.asarray(keypts), jnp.asarray(valid),
                            jnp.asarray(seed_p))


def _port_update(st, m, keypts, valid, seed_p, cache, programs):
    t_st = convert.eskf_state_from_numpy(st)
    return tlio.iekf_update(
        t_st, m, torch.as_tensor(keypts), torch.as_tensor(valid),
        torch.zeros(3), torch.eye(3), torch.zeros(3),
        torch.tensor(1, dtype=torch.int32), seed_q=t_st.q,
        seed_p=torch.as_tensor(seed_p), cache_association=cache,
        programs=programs, **ICP)


SEEDS = ([0.1, -0.05, 0.05], [-0.08, 0.06, 0.0], [0.03, 0.1, -0.04])


@pytest.fixture(scope="module")
def iekf_runs(scene):  # noqa: F811
    m, keypts, valid, st, _, _ = scene
    runs = {}
    for cache in (True, False):
        t_map = convert.voxel_map_from_numpy(m)
        programs, rows = {}, []
        with CallLog("iekf") as log:
            for seed_p in SEEDS:
                seed_p = np.asarray(seed_p, np.float32)
                j = _jax_update(st, m, keypts, valid, seed_p, cache)
                t = _port_update(st, t_map, keypts, valid, seed_p, cache,
                                 programs)
                rows.append((j, t))
        runs[cache] = (programs, rows, log)
    return runs


@pytest.mark.parametrize("cache", [True, False], ids=["assoc", "search"])
def test_iekf_program_matches_jax(iekf_runs, cache):
    programs, rows, log = iekf_runs[cache]
    assert len(programs) == 1
    prog = next(iter(programs.values()))
    assert all(c["prog"] is prog for c in log.calls)
    assert all(c["buffers"] == log.calls[0]["buffers"] for c in log.calls)
    per_update = []
    for (j_out, j_sum), (t_out, t_sum) in rows:
        assert bool(t_sum.success) and bool(j_sum.success)
        assert int(t_sum.iterations) == int(j_sum.iterations) > 1
        assert int(t_sum.num_residuals) == int(j_sum.num_residuals) > 100
        np.testing.assert_allclose(t_out.p.numpy(), np.asarray(j_out.p),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(t_out.q.numpy(), np.asarray(j_out.q),
                                   atol=1e-6, rtol=0)
        j_cov = np.asarray(j_out.cov)
        np.testing.assert_allclose(t_out.cov.numpy(), j_cov, rtol=0,
                                   atol=1e-5 * np.abs(j_cov).max())
        per_update.append(int(t_sum.iterations))
    assert len(log.calls) == sum(per_update)
    # the three updates started from three poses
    assert len({tuple(r[1][0].p.numpy().round(6)) for r in rows}) >= 1
    assert len({tuple(c["state"].x.numpy()[:3]) for c in log.calls}) \
        == len(log.calls)


@pytest.mark.parametrize("cache", [True, False], ids=["assoc", "search"])
def test_iekf_program_refill_contract(iekf_runs, cache):
    _, _, log = iekf_runs[cache]
    first_of_second = next(i for i, c in enumerate(log.calls)
                           if not torch.equal(c["inputs"].pred_x,
                                              log.calls[0]["inputs"].pred_x)
                           or not torch.equal(c["state"].x,
                                              log.calls[0]["after"].x))
    _contract(log.calls[0], log.calls[first_of_second])


@pytest.mark.parametrize("cache", [True, False], ids=["assoc", "search"])
def test_iekf_results_are_copies(iekf_runs, cache):
    """What an update returns is not the program's buffers: the next
    update leaves it as it was."""
    programs, rows, _ = iekf_runs[cache]
    prog = next(iter(programs.values()))
    buffers = {t.data_ptr() for t in graphs.tree_leaves(prog.state)}
    buffers |= {t.data_ptr() for t in graphs.tree_leaves(prog.inputs)}
    for (j_out, _), (t_out, t_sum) in rows:
        for t in list(t_out) + list(t_sum):
            assert t.data_ptr() not in buffers
        np.testing.assert_allclose(t_out.p.numpy(), np.asarray(j_out.p),
                                   atol=1e-5, rtol=0)


def test_pipeline_records_are_copies(sweeps):
    """Over a LIO run, the records kept per frame are not the IEKF
    program's buffers or outputs, and hold each frame's state."""
    sim = jsyn.simulate(**dict(SIM, duration=4.0))
    pipe = TPipe(_port_cfg(), device="cpu")
    seen = []
    step = pipe.engine.step

    def recorded(*args, **kw):
        out = step(*args, **kw)
        seen.append(out.record.clone())
        return out
    pipe.engine.step = recorded
    trun(pipe, sim)
    kept = [r for (_, _, r) in pipe._pending_records]
    assert len(kept) == len(seen) >= 3
    assert len({r.data_ptr() for r in kept}) == len(kept)
    progs = pipe.engine.iekf_programs.values()
    owned = {t.data_ptr() for p in progs for t in graphs.tree_leaves(
        (p.state, p.inputs, p.outputs))}
    assert not owned & {r.data_ptr() for r in kept}
    for r, s in zip(kept, seen):
        assert torch.equal(r, s)


class NoHostReads(TorchDispatchMode):
    """Fails the ops a CUDA graph capture refuses: a read back to the host
    (`item`, `bool()`, a 0-d tensor index), a data-dependent shape
    (`nonzero`, `masked_select`, a boolean-mask index), and a tensor made
    from host data (`torch.tensor`, a Python value set by an advanced
    index) used by any op but a fill, which passes it as an argument."""

    def __init__(self):
        super().__init__()
        self.fresh = {}        # id -> tensor, kept alive for the block
        self.bad = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if name.startswith(("aten._local_scalar_dense", "aten.nonzero",
                            "aten.masked_select")):
            self.bad.append(name)
        if name.startswith("aten.index.Tensor") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            self.bad.append(name + " with a boolean mask")
        if not name.startswith("aten.fill_"):
            for a in list(args) + list(kwargs.values()):
                for t in (a if isinstance(a, (list, tuple)) else [a]):
                    if (isinstance(t, torch.Tensor)
                            and self.fresh.get(id(t)) is t):
                        self.bad.append(name + " of a host value")
        out = func(*args, **kwargs)
        if name.startswith("aten.lift_fresh"):
            self.fresh[id(out)] = out
        return out


def _no_host_reads(prog, monkeypatch):
    """Runs the program's function under NoHostReads; the plain kNN that
    stands in for the kernel on the CPU runs outside it (the card runs the
    kernel, held by chip_smoke.py's phase graphs)."""
    for name in ("knn_plane_rows", "knn_plane_assoc"):
        def outside(*a, _orig=getattr(plane_fit, name), **k):
            with _disable_current_modes():
                return _orig(*a, **k)
        monkeypatch.setattr(plane_fit, name, outside)
    prog.fn(prog.state, prog.inputs)           # warm caches, as the card
    with NoHostReads() as mode:
        prog.fn(prog.state, prog.inputs)
    assert not mode.bad, mode.bad


def test_vision_program_reads_nothing_back(vision_runs, monkeypatch):
    _, tv, _, _ = vision_runs
    _no_host_reads(tv.programs[False], monkeypatch)


@pytest.mark.parametrize("cache", [True, False], ids=["assoc", "search"])
def test_iekf_program_reads_nothing_back(iekf_runs, cache, monkeypatch):
    programs, _, _ = iekf_runs[cache]
    _no_host_reads(next(iter(programs.values())), monkeypatch)


def test_no_host_reads_catches_the_refused_ops():
    x = torch.randn(5, 3)
    occ = torch.zeros(8, dtype=torch.bool)
    cases = (lambda: x[torch.argmax(x[:, 0])],
             lambda: bool(x.sum() > 0),
             lambda: x[x > 0],
             lambda: torch.nonzero(occ),
             lambda: occ.__setitem__(torch.tensor([1, 2]), True),
             lambda: x + torch.tensor([1.0, 2.0, 3.0]))
    for case in cases:
        with NoHostReads() as mode:
            case()
        assert mode.bad
    with NoHostReads() as mode:          # what the programs do instead
        x[torch.argmax(x[:, 0], keepdim=True)][0]
        occ.index_fill_(0, torch.arange(2), True)
        x[:, 0] = 1.0
    assert not mode.bad


def test_refill_copies_only_what_differs():
    buf = (torch.zeros(3), (torch.zeros(2, dtype=torch.int32), None))
    same = (buf[0], (torch.ones(2, dtype=torch.int32), None))
    assert graphs.refill(buf, same) == 1
    assert buf[1][0].tolist() == [1, 1]
    assert graphs.refill(buf, buf) == 0
    with pytest.raises(ValueError):
        graphs.refill(buf, (torch.zeros(4), (torch.zeros(2), None)))
    assert graphs.same_leaves(buf, buf)
    assert not graphs.same_leaves(buf, same)


def test_program_on_the_cpu_writes_its_state_back():
    """On the CPU a call runs the function and the write-back; a leaf the
    function returns unchanged stays the buffer itself; `rebind` adopts
    other tensors."""
    def fn(state, inputs):
        return (state[0] + inputs, state[1]), state[0] * 2
    keep = torch.arange(3)
    prog = graphs.Program(fn, (torch.zeros(2), keep), torch.ones(2),
                          name="t")
    first = prog.state[0]
    out = prog()
    assert prog.state[0] is first and prog.state[1] is keep
    assert first.tolist() == [1.0, 1.0] and out.tolist() == [0.0, 0.0]
    prog()
    assert first.tolist() == [2.0, 2.0]
    prog.rebind(inputs=torch.full((2,), 5.0))
    prog()
    assert first.tolist() == [7.0, 7.0]
    assert prog.captures == 0 and prog.graph is None
