"""The port's scaling bench (sr_livo_tpu_torch.runtime.scaling_bench)
against the JAX package's script (scripts/scaling_bench.py) on the CPU.

- `base_cfg` field by field at scales 1, 2, 8 and 64; the n-rank budgets
  and their received-size overrides bit for bit; `build_sweeps` (2
  sweeps at the tiles 1, 2 and 8 of the script's weak points) every
  array bit for bit.
- `comm_model` given the same bandwidth and latency equals the JAX
  model plus the port's departures (one more collective, the insert-gate
  histogram psum; the IEKF psum's float64 partial sums), to float
  round-off; the collectives one steady sweep's program calls, counted
  on the engine's mesh in capture form (every masked IEKF round), are
  `collectives_per_sweep`'s at the counted rounds.
- The efficiency formulas are the script's (`:404-411`, `:400`).
- `replicated_remainder` against the script's `repl_only` (a closure in
  its `main`), written out here with the JAX package's modules: p and cov
  within 1e-5 relative; its program (`replicated_program`) the same
  bits.
- The per-shard proxies ShardedLioEngine(world of one, budget_override)
  in lockstep with JAX's on a 1-device mesh over the same 4 sweeps, at
  strong n = 8 and weak n = 2: integer outputs bit-exact, positions
  within POS_TOL.
- The rank walls and the real-mesh overflow check on 1 and 2 gloo ranks
  of the CPU, the stage profile, and the launch counts each carries.

The JAX script is loaded with importlib (it sets XLA_FLAGS on import,
restored here); its `main` is never called (it writes into the
repository's root).
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.models import eskf as jeskf
from sr_livo_tpu.models.odometry import LioEngine as JLioEngine
from sr_livo_tpu.parallel import mesh as jmesh
from sr_livo_tpu.parallel import sharded_lio as jsl
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.models.odometry import LioEngine, SweepInput
from sr_livo_tpu_torch.parallel.mesh import make_mesh
from sr_livo_tpu_torch.parallel.sharded_lio import (PROFILE_STAGES,
                                                    ShardedLioEngine)
from sr_livo_tpu_torch.runtime import scaling_bench as sb
from sr_livo_tpu_torch.utils import graphs
from tests.torch_threads import one_intraop_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH_PATH = os.path.join(REPO, "scripts", "scaling_bench.py")
# float32 round-off of the IEKF's sums in another order (the bar of
# tests/test_torch_sharded_lio.py's lockstep)
POS_TOL = 1e-5
# replicated_remainder: p and cov relative to the array's largest entry
REPL_RTOL = 1e-5
# (scale, n) of every budget the script computes
BUDGET_CASES = [(1, 1), (1, 2), (1, 4), (1, 8), (2, 2), (4, 4), (8, 8),
                (64, 8)]
N_LOCKSTEP = 4


@pytest.fixture(scope="module")
def jbench():
    saved = os.environ.get("XLA_FLAGS")
    try:
        spec = importlib.util.spec_from_file_location("jax_scaling_bench",
                                                      JAX_BENCH_PATH)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _jax_override(jbench, cfg, n):
    """The script's inline `B2..B6 x n` override (:226-229)."""
    b = jbench.pershard_budgets(cfg, n)
    ov = dict(b)
    for k in ("B2", "B3", "B4", "B5", "B6"):
        ov[k] = b[k] * n
    return ov


def _port_sweep(js) -> SweepInput:
    return SweepInput(*(torch.tensor(np.asarray(v)) for v in js))


@pytest.mark.parametrize("scale", [1, 2, 8, 64])
def test_base_cfg_matches_jax(jbench, scale):
    assert (dataclasses.asdict(sb.base_cfg(scale))
            == dataclasses.asdict(jbench.base_cfg(scale)))


@pytest.mark.parametrize("scale,n", BUDGET_CASES)
def test_budgets_and_overrides_match_jax(jbench, scale, n):
    pcfg, jcfg = sb.base_cfg(scale), jbench.base_cfg(scale)
    assert sb.pershard_budgets(pcfg, n) == jbench.pershard_budgets(jcfg, n)
    assert sb.pershard_override(pcfg, n) == _jax_override(jbench, jcfg, n)


@pytest.mark.parametrize("tile", [1, 2, 8])
def test_build_sweeps_match_jax(jbench, tile):
    """The script builds a weak point's sweeps as build_sweeps(base_cfg(
    scale=n), tile=n)."""
    ref = jbench.build_sweeps(jbench.base_cfg(tile), n=2, tile=tile)
    port = sb.build_sweeps(sb.base_cfg(tile), n=2, device="cpu")
    assert len(port) == len(ref) == 2
    for p, j in zip(port, ref):
        for k in SweepInput._fields:
            a, b = getattr(p, k).numpy(), np.asarray(getattr(j, k))
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    # the payload really is tiled to the scaled budget
    assert int(port[0].pt_valid.sum()) == 8192 * tile


@pytest.mark.parametrize("scale,n", [(1, 2), (1, 8), (2, 2), (8, 8),
                                     (64, 8)])
@pytest.mark.parametrize("iters,cap", [(6, False), (6, True), (3, True)])
def test_comm_model_is_jax_plus_the_port_departures(jbench, monkeypatch,
                                                    scale, n, iters, cap):
    bw, lat = 478.116e9, 7.5e-6
    monkeypatch.setattr(jbench, "ICI_BW", bw)
    monkeypatch.setattr(jbench, "COLL_LAT", lat)
    b = sb.pershard_budgets(sb.base_cfg(scale), n)
    departure = (iters * 43 * 4 * 2            # float64 packed psum
                 + b["F_seg"] * n * 4 * 2) / bw + lat   # insert-gate psum
    port = sb.comm_model(b, n, iters, cap, link_bw=bw, latency=lat)
    assert port == pytest.approx(jbench.comm_model(b, n, iters, cap)
                                 + departure, rel=1e-12, abs=0)


@pytest.mark.parametrize("t_single,t_p,comm,n", [
    (0.05, 0.02, 1e-4, 2), (0.05, 0.011, 2.5e-4, 8), (0.3, 0.7, 0.0, 4)])
def test_efficiency_formulas(t_single, t_p, comm, n):
    # scripts/scaling_bench.py:406-407 and :411 (:400 for the saturating
    # point, the weak formula)
    assert sb.efficiency_strong(t_single, t_p, comm, n) == \
        t_single / (n * (t_p + comm))
    assert sb.efficiency_weak(t_single, t_p, comm) == \
        t_single / (t_p + comm)


def replicated_pair(jbench):
    """((p, cov) of the port's replicated_remainder, (p, cov) of the
    script's `repl_only`) on base_cfg's first sweep from init_state."""
    jcfg = jbench.base_cfg()
    js = jbench.build_sweeps(jcfg, n=1)[0]
    eng1 = JLioEngine(jcfg)

    @jax.jit
    def repl_only(state, sweep):          # scripts/scaling_bench.py:283-301
        st, _ = jeskf.predict_sweep(
            state, eng1.noise, sweep.imu_t, sweep.imu_dt, sweep.imu_acc,
            sweep.imu_gyr, sweep.imu_valid)
        hth = jnp.eye(6) * 10.0
        hth_h = jnp.ones(6)

        def body(i, carry):
            cov, acc = carry
            temp = jnp.linalg.inv(cov / 0.001)
            temp = temp.at[0:6, 0:6].add(hth)
            temp_inv = jnp.linalg.inv(temp)
            k_h = temp_inv[:, 0:6] @ hth_h
            return cov + 1e-9 * jnp.outer(k_h, k_h), acc + k_h[0]

        cov, acc = jax.lax.fori_loop(0, 6, body, (st.cov, 0.0))
        return st.p + acc, cov

    ref = tuple(np.asarray(x) for x in repl_only(eng1.init_state(), js))
    peng = LioEngine(sb.base_cfg(), device="cpu")
    port = tuple(x.numpy() for x in sb.replicated_remainder(
        peng, peng.init_state(), _port_sweep(js)))
    return port, ref


def test_replicated_remainder_matches_jax(jbench):
    port, ref = replicated_pair(jbench)
    for name, a, b in zip(("p", "cov"), port, ref):
        gap = np.abs(a - b).max() / np.abs(b).max()
        assert gap < REPL_RTOL, (name, gap)


def test_replicated_program_matches_jax(jbench):
    """The remainder's program (what `time_replicated` replays), called
    twice, in capture form, gives the function's bits and so stays within
    REPL_RTOL of the script's `repl_only`."""
    port, ref = replicated_pair(jbench)
    js = jbench.build_sweeps(jbench.base_cfg(), n=1)[0]
    peng = LioEngine(sb.base_cfg(), device="cpu")
    programs = {}
    with graphs.capture_form():
        for _ in range(2):
            got = sb.replicated_program(programs, peng, peng.init_state(),
                                        _port_sweep(js))
    (prog,) = programs.values()
    assert prog.name == "replicated_remainder"
    for name, a, b, c in zip(("p", "cov"), got, port, ref):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        assert np.abs(b - c).max() / np.abs(c).max() < REPL_RTOL, name


# ---------------------------------------------------------------------------
# the per-shard proxies in lockstep
# ---------------------------------------------------------------------------

PROXIES = {"strong8": (1, 8), "weak2": (2, 2)}      # name: (scale, n)


def _jax_proxy(jbench, scale, n, sweeps):
    eng = jsl.ShardedLioEngine(jbench.base_cfg(scale), jmesh.make_mesh(1),
                               budget_override=_jax_override(
                                   jbench, jbench.base_cfg(scale), n))
    s, m = eng.init_state(), eng.make_map()
    states, maps, outs = [], [], []
    for fid, sw in enumerate(sweeps, start=1):
        states.append({k: np.array(v) for k, v in s._asdict().items()})
        maps.append({k: np.array(v) for k, v in m._asdict().items()})
        o = eng.step(s, m, sw, fid)
        s, m = o.state, o.voxel_map
        outs.append(dict(
            p=np.array(s.p), success=bool(o.summary.success),
            num_residuals=int(o.summary.num_residuals),
            iterations=int(o.summary.iterations),
            frame_valid=np.array(o.frame_valid),
            inserted=np.array(o.inserted),
            route_overflow=int(o.route_overflow),
            map_size=int(eng.map_size(m))))
    return states, maps, outs


@pytest.fixture(scope="module")
def proxies(jbench):
    out = {}
    for name, (scale, n) in PROXIES.items():
        jsweeps = jbench.build_sweeps(jbench.base_cfg(scale), n=N_LOCKSTEP,
                                      tile=scale)
        states, maps, ref = _jax_proxy(jbench, scale, n, jsweeps)
        cfg = sb.base_cfg(scale)
        eng = ShardedLioEngine(cfg, make_mesh(1, device="cpu"),
                               budget_override=sb.pershard_override(cfg, n))
        steps = []
        for fid, (js, st, mp) in enumerate(zip(jsweeps, states, maps),
                                           start=1):
            o = eng.step(convert.eskf_state_from_numpy(st),
                         convert.voxel_map_from_numpy(mp), _port_sweep(js),
                         fid)
            # a copy: the state is the step program's buffers, which
            # the next step overwrites
            steps.append(dict(
                p=o.state.p.numpy().copy(), success=bool(o.summary.success),
                num_residuals=int(o.summary.num_residuals),
                iterations=int(o.summary.iterations),
                frame_valid=o.frame_valid.numpy(),
                inserted=o.inserted.numpy(),
                route_overflow=int(o.route_overflow),
                map_size=int(eng.map_size(o.voxel_map))))
        out[name] = dict(ref=ref, port=steps, engine=eng, state=o.state,
                         map=o.voxel_map, sweep=_port_sweep(jsweeps[-1]))
    return out


@pytest.mark.parametrize("name", sorted(PROXIES))
@pytest.mark.parametrize("frame", range(N_LOCKSTEP))
def test_pershard_proxy_lockstep_matches_jax(proxies, name, frame):
    port = proxies[name]["port"][frame]
    ref = proxies[name]["ref"][frame]
    for k in ("success", "num_residuals", "iterations", "route_overflow",
              "map_size"):
        assert port[k] == ref[k], (name, frame, k, port[k], ref[k])
    np.testing.assert_array_equal(port["frame_valid"], ref["frame_valid"])
    np.testing.assert_array_equal(port["inserted"], ref["inserted"])
    assert np.abs(port["p"] - ref["p"]).max() < POS_TOL


def test_proxies_do_real_work(proxies):
    """The proxies solve with residuals, and their slice overflows the
    routing budgets (the proxy artifact the real-mesh check exists for)
    in at least one of them."""
    for name in PROXIES:
        steps = proxies[name]["port"]
        assert all(s["success"] for s in steps)
        assert max(s["num_residuals"] for s in steps) > 100, name
        assert steps[-1]["map_size"] > 0


@pytest.mark.parametrize("name", sorted(PROXIES))
def test_collectives_counted_equal_the_model(proxies, name):
    """One steady sweep (frame id past the init frames) of the step
    program, counted in capture form, calls the collectives `comm_model`
    counts at the counted IEKF rounds (every masked round: max_iters + 1),
    with the residual cap of base_cfg; the iterations it took are fewer."""
    px = proxies[name]
    eng = px["engine"]
    counted = sb.count_collectives(
        eng, px["state"], px["map"], px["sweep"],
        eng.cfg.odometry_options.init_num_frames)
    rounds = counted.pop("psum_rounds")
    iters = counted.pop("iekf_iterations")
    assert rounds == eng.cfg.icp.num_iters_icp + 1
    assert 1 <= iters <= rounds
    assert counted == sb.collectives_per_sweep(
        rounds, eng.cfg.icp.max_num_residuals > 0)
    assert "psum" not in vars(eng.mesh)            # the counters are gone


def test_collectives_without_the_residual_cap(proxies):
    px = proxies["strong8"]
    cfg = sb.base_cfg()
    cfg.icp.max_num_residuals = -1
    eng = ShardedLioEngine(cfg, make_mesh(1, device="cpu"),
                           budget_override=sb.pershard_override(cfg, 8))
    counted = sb.count_collectives(eng, px["state"], px["map"], px["sweep"],
                                   cfg.odometry_options.init_num_frames)
    assert counted.pop("psum") == 4 + counted.pop("psum_rounds")
    assert counted.pop("iekf_iterations") >= 1
    assert counted == {"all_to_all": 5, "all_gather": 0}


# ---------------------------------------------------------------------------
# ranks, stage profile, entry point
# ---------------------------------------------------------------------------

def _small_cfg(scale=1):
    """tests/test_sharded_lio.py's shapes, with base_cfg's caps."""
    cfg = sb.base_cfg(scale)
    cfg.shapes.max_sweep_points = 2048 * scale
    cfg.shapes.max_frame_points = 2048 * scale
    cfg.shapes.max_keypoints = 512 * scale
    cfg.shapes.max_insert_points = 1024 * scale
    cfg.shapes.map_capacity = (1 << 15) * scale
    return cfg


def test_rank_walls_and_real_mesh_overflow(tmp_path):
    cfg, cfg2 = _small_cfg(), _small_cfg(2)
    sweeps = sb.build_sweeps(cfg, n=2, device="cpu")
    sweeps2 = sb.build_sweeps(cfg2, n=2, device="cpu")
    walls, overflow, counts = sb.rank_walls(cfg, sweeps, cfg2, sweeps2,
                                            "cpu", walls=(1, 2),
                                            overflow_n=2)
    assert sorted(walls) == [1, 2]
    assert all(np.isfinite(t) and t > 0 for t in walls.values())
    assert overflow == [0, 0]
    assert sorted(counts) == ["overflow2", "wall1", "wall2"]
    # warm-up + 2 timed passes of 2 sweeps; one IEKF update a step; the
    # CPU runs the plain association (no kernel launch)
    for key, ranks, steps in (("wall1", 1, 6), ("wall2", 2, 6),
                              ("overflow2", 2, 2)):
        assert len(counts[key]) == ranks
        for c in counts[key]:
            assert c["iekf_updates"] == steps, (key, c)
            assert c["knn_plane_assoc"] == 0


def test_stage_profile_counts_every_prefix():
    cfg = _small_cfg()
    sweeps = sb.build_sweeps(cfg, n=2, device="cpu")
    times, counts = sb.stage_profile(cfg, sb.pershard_override(cfg, 2),
                                     sweeps, "cpu")
    assert list(times) == list(PROFILE_STAGES) + ["prefix_total_ms"]
    assert all(np.isfinite(v) for v in times.values())
    assert times["prefix_total_ms"] > 0
    with_iekf = len(PROFILE_STAGES) - PROFILE_STAGES.index("iekf")
    assert counts["iekf_updates"] == len(sweeps) + 6 * with_iekf


def test_time_engine_counts_its_steps():
    cfg = _small_cfg()
    sweeps = sb.build_sweeps(cfg, n=2, device="cpu")
    best, run = sb.time_engine(lambda: LioEngine(cfg, device="cpu"), sweeps,
                               repeats=2)
    assert best > 0 and run.counts["iekf_updates"] == 6
    assert len(run.positions) == 6 and len(run.overflow) == 6


def test_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sb.main(["--device", "cuda"])


def test_link_bandwidth_is_required_without_nvlink():
    """Without a reported NVLink (the CPU) the model needs --link-gbs;
    nothing else is measured before that check."""
    with pytest.raises(ValueError, match="--link-gbs"):
        sb.run_bench("cpu")


def test_chip_smoke_holds_every_jax_key():
    """chip_smoke.py's phase `scaling` requires the keys of the JAX
    script's record (its committed card run, SCALING_r05_tpu.json), with
    `ici_bw_gbs` renamed `link_bw_gbs`."""
    import json

    import chip_smoke
    with open(os.path.join(REPO, "SCALING_r05_tpu.json")) as f:
        ref = json.load(f)
    rename = {"ici_bw_gbs": "link_bw_gbs"}
    want = {None: ref}
    want.update({k: v for k, v in ref.items()
                 if k in ("comm_model", "saturating_weak_8")})
    for sec, rec in want.items():
        assert (sorted(chip_smoke.SCALING_KEYS[sec])
                == sorted(rename.get(k, k) for k in rec)), sec
