"""Sharded-engine scaling measurement, on the port.

    python -m sr_livo_tpu_torch.runtime.scaling_bench [--device cuda|cpu]
        [--link-gbs G] [--coll-latency-us U]

The port's counterpart of `scripts/scaling_bench.py`, name for name.  The
map-sharded engine (parallel.sharded_lio) shards the whole sweep front
half and owner-routes kNN to rank-local tables, so the only replicated
compute left is the IMU scan and the 17x17 solves.  The scaling story is
built on ONE device from direct measurements plus an analytic collective
model:

  1. `t_single` — the single-device LioEngine step (the baseline).
  2. `t_pershard(n)` — the exact per-rank program of an n-rank run,
     executed as a world of one through ShardedLioEngine(budget_override):
     every static shape (the N/n slice, the exchange buffers at their
     received size n*B, the local query batch and table) takes its n-rank
     value, and every collective is the identity.  What remains is the
     compute one card of an n-card run does.  A world of one is
     capturable (`Mesh.capturable`), so each proxy's step replays its
     captured program, as the single-device baseline's does: the JAX
     script compares jitted programs too.
  3. `t_replicated` — the replicated remainder alone
     (`replicated_remainder`: predict_sweep's IMU scan plus six rounds of
     the 17x17 gain solves), replayed as a program (`replicated_program`,
     the script's jitted `repl_only`).
  4. The collectives (`comm_model`), from the engine's exact buffer sizes
     and the collectives its program calls (`count_collectives`: the
     step's function in capture form, so every masked IEKF round counts,
     as every one calls the packed psum in a replay; the JAX model counts
     the iterations run): bytes / link_bw + n_collectives * latency.
     `link_bw` is the card's NVLink rate per direction as
     `nvidia-smi nvlink -s` reports it (links x per-link speed), or
     `--link-gbs` where no link is reported; the latency is the median of
     a small all-reduce on a world of one (NCCL on the card, gloo on the
     CPU), a lower bound on a card-to-card latency, or `--coll-latency-us`.
  5. Walls of n real ranks (1, 2 and 8) over torch.distributed gloo, all
     on the one device (n ranks sharing one card, or n CPU processes):
     the collectives are staged through host memory and the ranks share
     the card and the host's cores, so the walls are floors, not
     estimates.  Gloo's collectives cannot be captured, so the walls run
     the step eagerly, the 1-rank wall too (its mesh is the gloo group).
     The 8-rank run also carries the routing-overflow check at the
     weak-8 workload: the 1-device proxies report overflow because
     their slice skips the hash-range spreading (a proxy artifact), so
     only a real 8-rank run's counter says whether the budgets hold.  The
     parent builds the plane kernel before it starts the ranks.
  6. Per-stage per-rank times (`stage_profile`) by differencing the
     step's prefixes (ShardedLioEngine.make_profile_step), each replayed
     as its program.  Nothing of a prefix is dead-code eliminated as XLA
     does in the JAX script: every prefix from `insert` on runs the
     full-table insert and includes the copy of the local map that
     make_profile_step makes (the step updates the map in place).

Strong scaling: efficiency_strong_n = t_single / (n * (t_pershard(n) +
comm(n))), the same workload split n ways.  Weak scaling:
efficiency_weak_n = t_single / (t_pershard_weak(n) + comm_weak(n)), n x
the workload (sweep points, frame and keypoint budgets, map) on n ranks,
the deployment regime map sharding exists for.  The saturating weak point
splits 64x the base workload over 8 ranks (8x per rank) against the
single device at 8x.  replicated_fraction = t_replicated / t_single.

Everything runs on `--device` (default cuda, which raises without a GPU;
cpu runs the plain PyTorch path).  Writes output/SCALING_torch.json with
the JAX script's keys (`link_bw_gbs` in place of its `ici_bw_gbs`), plus
the device, each timed engine's plane-kernel launches and IEKF updates
(`launches`), the strong-1 proxy's gap to the single-device trajectory on
the same sweeps (`strong1_vs_single_max_gap_m`) and the collectives one
steady sweep of the strong-8 proxy's program calls, counted on its mesh,
with the IEKF rounds they span (`psum_rounds`, the `iters` the model is
given) and the iterations the step took.  Each run's programs are
dropped, and the allocator's cache emptied, before the next run.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.models import eskf as eskf_mod
from sr_livo_tpu_torch.models import lio
from sr_livo_tpu_torch.models.odometry import (LioEngine, StepInputs,
                                               SweepInput)
from sr_livo_tpu_torch.ops import plane_fit
from sr_livo_tpu_torch.parallel.mesh import make_mesh
from sr_livo_tpu_torch.parallel.sharded_lio import (PROFILE_STAGES,
                                                    ShardedLioEngine,
                                                    compute_budgets)
from sr_livo_tpu_torch.utils import graphs
from sr_livo_tpu_torch.utils.device import (device_record, resolve_device,
                                            synchronize)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "output", "SCALING_torch.json")

STRONG_N = (1, 2, 4, 8)
WEAK_N = (2, 4, 8)
WALL_N = (1, 2, 8)
OVERFLOW_N = 8
# the exchange buffers whose received size on n ranks is n x the budget
RECEIVED = ("B2", "B3", "B4", "B5", "B6")
COLLECTIVES = ("psum", "all_to_all", "all_gather")


def base_cfg(scale: int = 1) -> LivoConfig:
    cfg = LivoConfig()
    cfg.odometry_options.voxel_size = 0.2
    cfg.odometry_options.init_voxel_size = 0.2
    cfg.odometry_options.sample_voxel_size = 0.8
    cfg.odometry_options.init_sample_voxel_size = 0.8
    cfg.odometry_options.min_distance_points = 0.05
    cfg.icp.size_voxel_map = 0.6
    cfg.icp.min_number_neighbors = 12
    # the residual budget must scale with the workload too, or the IEKF's
    # actual work is pinned at 600 rows regardless of scale
    cfg.icp.max_num_residuals = 600 * scale
    cfg.shapes.max_sweep_points = 8192 * scale
    cfg.shapes.max_frame_points = 4096 * scale
    cfg.shapes.max_keypoints = 1024 * scale
    cfg.shapes.max_imu_samples = 48
    cfg.shapes.map_capacity = (1 << 16) * scale
    cfg.shapes.max_insert_points = 2048 * scale
    return cfg


def build_sweeps(cfg: LivoConfig, n: int = 8, device="cuda") -> list:
    """`n` padded SweepInputs on `device` from the synthetic world; the
    point payload is replicated at disjoint spatial EXTENTS (64 m grid
    offsets) until it fills max_sweep_points, so base_cfg(scale) gets
    scale x the work.

    Extent-tiling, not density-tiling: jittered same-extent copies
    saturate at the world's surface-voxel count, so the subsample caps
    bind and the "n x workload" stops creating n x keypoints/map voxels.
    Disjoint extents give genuinely n x voxels, keypoints, inserts and
    map occupancy, and spread the block-ownership load the way a larger
    mapped area does.  Tiles come from the VALID payload only (the
    prepared sweep is already padded to N).  The JAX script's `tile`
    argument is not taken: its body tiles up to max_sweep_points
    whatever `tile` says."""
    from sr_livo_tpu_torch.runtime import measurements as meas_mod
    from sr_livo_tpu_torch.runtime import synthetic
    dev = resolve_device(device)
    sim = synthetic.simulate(duration=6.0, n_azimuth=160, n_rings=16, seed=4,
                             device=dev)
    cutter = meas_mod.SweepCutter(0.1)
    for (t, a, g) in sim.imu:
        cutter.push_imu(t, a, g)
    for c in sim.lidar_chunks:
        cutter.push_points(c)
    for (t, img) in sim.images:
        cutter.push_image(t, img)
    preps = []
    current = None
    while len(preps) < n:
        m = cutter.get()
        if m is None:
            break
        if current is None:
            current = m.time_sweep_begin
        prep = meas_mod.prepare_sweep(m, current, cfg)
        current = prep.new_current_time
        preps.append(prep)
    out = []
    N = cfg.shapes.max_sweep_points

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    for fid, prep in enumerate(preps, start=1):
        nv = prep.n_points
        pts, trel, val = (prep.raw_pts[:nv], prep.t_rel[:nv],
                          prep.pt_valid[:nv])
        if pts.shape[0] != N:
            reps = int(np.ceil(N / pts.shape[0]))
            pcs = [pts]
            for r in range(1, reps):
                off = np.array([(r % 8) * 64.0, ((r // 8) % 8) * 64.0,
                                (r // 64) * 64.0], np.float32)
                pcs.append(pts + off)
            pts = np.concatenate(pcs)[:N]
            trel = np.concatenate([trel] * reps)[:N]
            val = np.concatenate([val] * reps)[:N]
        out.append(SweepInput(
            raw_pts=f32(pts), t_rel=f32(trel),
            pt_valid=torch.as_tensor(val, device=dev),
            imu_t=f32(prep.imu_t), imu_dt=f32(prep.imu_dt),
            imu_acc=f32(prep.imu_acc), imu_gyr=f32(prep.imu_gyr),
            imu_valid=torch.as_tensor(prep.imu_valid, device=dev),
            do_optimize=torch.tensor(fid > 1, device=dev),
            threshold_capacity=torch.tensor(1, dtype=torch.int32,
                                            device=dev)))
    return out


def pershard_budgets(cfg: LivoConfig, n: int) -> dict:
    """Budgets an n-rank engine computes."""
    return compute_budgets(cfg, n)


def pershard_override(cfg: LivoConfig, n: int) -> dict:
    """The n-rank budgets with each exchange's RECEIVED size: on a world
    of one a received buffer is 1 x its budget, on n ranks n x."""
    b = pershard_budgets(cfg, n)
    return dict(b, **{k: b[k] * n for k in RECEIVED})


def _counters() -> dict:
    graphs.settle_counts()
    return dict(plane_fit.launches, iekf_updates=lio.counts["updates"])


class Run:
    """One engine carried over passes of its sweeps: its state and map,
    its per-step positions and routing overflow, and the plane-kernel
    launches and IEKF updates of all its steps (`counts`)."""

    def __init__(self, engine, sweeps):
        self.engine, self.sweeps = engine, sweeps
        self.state, self.vmap = engine.init_state(), engine.make_map()
        self.positions, self.overflow = [], []
        self.counts = dict.fromkeys(_counters(), 0)

    def sweep_pass(self, first_fid: int = 1) -> float:
        """One pass over the sweeps (frame ids from `first_fid`), ended by
        a device synchronize; seconds per sweep."""
        before = _counters()
        dev = self.engine.device
        synchronize(dev)
        t0 = time.perf_counter()
        for fid, s in enumerate(self.sweeps, start=first_fid):
            o = self.engine.step(self.state, self.vmap, s, fid)
            self.state, self.vmap = o.state, o.voxel_map
            # copies: the single-device step's outputs are its program's,
            # which the next step overwrites
            self.positions.append(o.state.p.clone())
            self.overflow.append(o.route_overflow.clone())
        synchronize(dev)
        seconds = (time.perf_counter() - t0) / len(self.sweeps)
        for k, v in _counters().items():
            self.counts[k] += v - before[k]
        return seconds


def warm_run(make_engine, sweeps) -> Run:
    """The engine and its first pass (frame ids 1..n), untimed."""
    run = Run(make_engine(), sweeps)
    run.sweep_pass(1)
    return run


def time_engine(make_engine, sweeps, repeats: int = 3):
    """Best seconds per sweep over `repeats` passes after a warm-up pass
    (the first CUDA linear-algebra call initialises cuSOLVER there).
    Returns (seconds, the Run)."""
    run = warm_run(make_engine, sweeps)
    best = min(run.sweep_pass(len(sweeps) + 1) for _ in range(repeats))
    return best, run


def _drop(*runs: Run) -> None:
    """Drops the runs' programs: an engine and its programs' functions
    refer to each other, so without this their graphs' pools would stay
    allocated until the garbage collector runs."""
    for run in runs:
        run.engine.programs.clear()


def _free(device) -> None:
    """Returns the memory of dropped programs' pools to the device."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def collectives_per_sweep(iters: int = 6, cap: bool = False) -> dict:
    """The collectives one sweep of the port's ShardedLioEngine calls
    (without the weak-solve retry): 5 all_to_alls (validity packed into
    the row matrices; the 5th is the owner-insert accepted-replay leg),
    the 2 rank-histogram psums of the frame and keypoint subsamples, the
    insert-gate histogram psum (base_cfg caps inserts globally:
    max_insert_points < max_frame_points), one packed psum per IEKF
    round (+1 keypoint-rank histogram psum per round with the residual
    cap) and one fused output psum.  `iters` is the rounds: the
    iterations run eagerly, all `max_iters + 1` in a program."""
    return {"all_to_all": 5, "psum": 2 + 1 + iters * (2 if cap else 1) + 1,
            "all_gather": 0}


def comm_model(b: dict, n: int, iters: int = 6, cap: bool = False, *,
               link_bw: float, latency: float) -> float:
    """Per-sweep collective seconds from the buffer sizes: bytes over
    `link_bw` (bytes/s per direction) plus `latency` per collective
    (`collectives_per_sweep`).  Bytes are the JAX model's: the
    all_to_alls' rows (24 or 20 bytes with the validity column), the
    int32 histograms sized by their budgets, twice each (reduce and
    broadcast), and the packed IEKF psum, here of 43 float64 partial
    sums (lio.normal_sums) where the JAX engine sums float32; plus the
    insert-gate histogram, which the JAX model leaves out.  The output
    psum's bytes are not counted: it overlaps the next sweep's host
    work, as in the JAX model."""
    a2a_bytes = n * (b["B2"] * 24 + b["B3"] * 24 + b["B4"] * 20
                     + b["B5"] * 20 + b["B6"] * 20)
    N_tot = b["Ns"] * n
    hist_bytes = (N_tot + 2 * b["F_seg"] * n) * 4 * 2 \
        + (b["K4"] * 4 * 2 * iters if cap else 0)
    psum_bytes = iters * 43 * 8 * 2
    n_coll = sum(collectives_per_sweep(iters, cap).values())
    return (a2a_bytes + hist_bytes + psum_bytes) / link_bw + n_coll * latency


def count_collectives(engine: ShardedLioEngine, state, vmap, sweep,
                      frame_id: int) -> dict:
    """The collectives the engine's step program calls on its mesh: the
    step's function run once in capture form (`graphs.capture_form()`,
    every masked IEKF round and both branches of a retry, as a capture
    records them) on copies of `state` and `vmap`, the mesh's
    collectives wrapped and counted; the counters it advances are set
    back.  Also the IEKF rounds the step spans (`psum_rounds`, each
    calls the packed psum) and the iterations it took
    (`iekf_iterations`, its summary's)."""
    mesh = engine.mesh
    calls = dict.fromkeys(COLLECTIVES, 0)

    def counted(name):
        fn = getattr(mesh, name)

        def call(t):
            calls[name] += 1
            return fn(t)
        return call

    for name in COLLECTIVES:
        setattr(mesh, name, counted(name))
    try:
        with graphs.capture_form(), graphs.counts_kept():
            before = lio.counts["iterations"]
            _, out = engine.step_fn(engine.phase(frame_id))(
                graphs.tree_map(torch.clone, (state, vmap)),
                StepInputs(sweep, None))
            calls["psum_rounds"] = lio.counts["iterations"] - before
        calls["iekf_iterations"] = int(out.summary.iterations)
    finally:
        for name in COLLECTIVES:
            delattr(mesh, name)
    return calls


def replicated_remainder(engine, state, sweep):
    """The replicated compute of a sharded step alone: predict_sweep's IMU
    scan, then six rounds of the IEKF's two 17x17 inverses and its gain
    (the JAX script's `repl_only`).  Returns (p, cov)."""
    st, _ = eskf_mod.predict_sweep(
        state, engine.noise, sweep.imu_t, sweep.imu_dt, sweep.imu_acc,
        sweep.imu_gyr, sweep.imu_valid)
    f = dict(dtype=st.cov.dtype, device=st.cov.device)
    hth = torch.eye(6, **f) * 10.0
    hth_h = torch.ones(6, **f)
    cov, acc = st.cov, torch.zeros((), **f)
    for _ in range(6):
        # inv_ex: no error check, so no host read (a program captures it)
        temp = torch.linalg.inv_ex(cov / 0.001)[0]
        temp[0:6, 0:6] += hth
        temp_inv = torch.linalg.inv_ex(temp)[0]
        k_h = temp_inv[:, 0:6] @ hth_h
        cov = cov + 1e-9 * torch.outer(k_h, k_h)
        acc = acc + k_h[0]
    return st.p + acc, cov


def replicated_program(programs: dict, engine, state, sweep):
    """`replicated_remainder` as one captured program kept in `programs`
    (the JAX script's jitted `repl_only`, scripts/scaling_bench.py:283): a
    pure function over the copied `state` and `sweep`.  Returns the
    program's (p, cov), which its next call overwrites."""
    def fn(_, inputs):
        return None, replicated_remainder(engine, *inputs)
    key = ("replicated_remainder", tuple(
        tuple(t.shape) for t in graphs.tree_leaves((state, sweep))))
    return graphs.call(programs, key, fn, None, (state, sweep),
                       name="replicated_remainder")[1]


def time_replicated(engine, sweep, reps: int = 20) -> float:
    """Mean seconds of `reps` replays of `replicated_program` after its
    first call."""
    programs = {}
    replicated_program(programs, engine, engine.init_state(), sweep)
    (prog,) = programs.values()
    synchronize(engine.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        prog()
    synchronize(engine.device)
    return (time.perf_counter() - t0) / reps


def stage_profile(cfgp: LivoConfig, ov: dict, sweeps_p: list, device
                  ) -> tuple:
    """Per-stage ms of the per-rank steady step: the best of 5 calls of
    each prefix's program (make_profile_step; the first call, its
    capture, untimed) on the state and map after one pass over the
    sweeps, minus the previous prefix's.  Returns (times, the launches
    and IEKF updates of the warm-up pass and the prefixes)."""
    eng = ShardedLioEngine(cfgp, make_mesh(1, device=device),
                           budget_override=ov)
    run = warm_run(lambda: eng, sweeps_p)
    before = _counters()
    sw = sweeps_p[-1]
    times, prev = {}, 0.0
    for stg in PROFILE_STAGES:
        f = eng.make_profile_step(stg)
        f(run.state, run.vmap, sw)
        synchronize(eng.device)
        best = np.inf
        for _ in range(5):
            t0 = time.perf_counter()
            f(run.state, run.vmap, sw)
            synchronize(eng.device)
            best = min(best, time.perf_counter() - t0)
        times[stg] = (best - prev) * 1e3
        prev = best
    times["prefix_total_ms"] = prev * 1e3
    counts = {k: run.counts[k] + v - before[k]
              for k, v in _counters().items()}
    _drop(run)
    return times, counts


def efficiency_strong(t_single: float, t_pershard: float, comm: float,
                      n: int) -> float:
    return t_single / (n * (t_pershard + comm))


def efficiency_weak(t_single: float, t_weak: float, comm: float) -> float:
    return t_single / (t_weak + comm)


# ---------------------------------------------------------------------------
# the card's link and collective latency
# ---------------------------------------------------------------------------

def nvlink_bw(index: int = 0):
    """(bytes/s per direction, description) of card `index`'s NVLinks as
    `nvidia-smi nvlink -s` reports them (the sum of the links' speeds), or
    None where it reports no link or cannot run."""
    try:
        out = subprocess.run(["nvidia-smi", "nvlink", "-s", "-i", str(index)],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    speeds = [float(s) for s in
              re.findall(r"Link \d+: ([0-9.]+) GB/s", out.stdout)]
    if out.returncode != 0 or not speeds or sum(speeds) <= 0:
        return None
    return sum(speeds) * 1e9, (f"nvidia-smi nvlink -s: {len(speeds)} links, "
                               f"{sum(speeds)} GB/s per direction")


def collective_latency(device, reps: int = 50) -> tuple:
    """Median seconds of an all-reduce of 43 float64 (the packed IEKF
    psum) on a world of one, each call synchronized: NCCL on the card,
    gloo on the CPU.  Returns (seconds, description)."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    x = torch.zeros(43, dtype=torch.float64, device=dev)
    times = []
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            for i in range(reps + 5):
                synchronize(dev)
                t0 = time.perf_counter()
                dist.all_reduce(x)
                synchronize(dev)
                if i >= 5:
                    times.append(time.perf_counter() - t0)
        finally:
            dist.destroy_process_group()
    return float(np.median(times)), (
        f"median of {reps} synchronized {backend} all-reduces of 43 float64 "
        "on a world of one: a lower bound on a card-to-card latency")


# ---------------------------------------------------------------------------
# ranks: the walls and the real-mesh overflow check
# ---------------------------------------------------------------------------

def _cpu_sweeps(sweeps) -> list:
    return [tuple(t.cpu() for t in s) for s in sweeps]


def rank_walls(cfg: LivoConfig, sweeps: list, cfg_o: LivoConfig,
               sweeps_o: list, device, walls=WALL_N,
               overflow_n: int = OVERFLOW_N, timeout: float = 900.0
               ) -> tuple:
    """The n-rank walls (`cfg` over `sweeps`, 2 timed passes after one)
    for n in `walls`, and the routing overflow of `overflow_n` real ranks
    over `sweeps_o` at `cfg_o`; every rank a process of this module on
    `device` in one gloo group.  Returns ({n: wall seconds per sweep, the
    slowest rank's}, [overflow per sweep], {"wall<n>" / "overflow<n>":
    each rank's launches and IEKF updates})."""
    dev = resolve_device(device)
    tasks = {}
    for n in walls:
        tasks.setdefault(n, []).append("wall")
    tasks.setdefault(overflow_n, []).append("overflow")
    t_virtual, overflow, counts = {}, None, {}
    with tempfile.TemporaryDirectory() as d:
        torch.save({"cfg": cfg, "sweeps": _cpu_sweeps(sweeps),
                    "cfg_o": cfg_o, "sweeps_o": _cpu_sweeps(sweeps_o),
                    "tasks": tasks}, os.path.join(d, "inputs.pt"))
        for n in sorted(tasks):
            cmd = [sys.executable, "-m", "sr_livo_tpu_torch.runtime."
                   "scaling_bench", "--device", str(dev), "--workdir", d,
                   "--world", str(n), "--rank"]
            procs = [subprocess.Popen(cmd + [str(r)], cwd=ROOT,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT)
                     for r in range(n)]
            logs = []
            try:
                for p in procs:
                    logs.append(p.communicate(timeout=timeout)[0].decode(
                        errors="replace"))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            for r, (p, log) in enumerate(zip(procs, logs)):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} of {n} exited "
                                       f"{p.returncode}:\n{log[-4000:]}")
            outs = []
            for r in range(n):
                with open(os.path.join(d, f"rank{n}_{r}.json")) as f:
                    outs.append(json.load(f))
            if "wall" in tasks[n]:
                t_virtual[n] = max(o["wall_s"] for o in outs)
                counts[f"wall{n}"] = [o["wall_counts"] for o in outs]
            if "overflow" in tasks[n]:
                overflow = outs[0]["overflow"]
                if any(o["overflow"] != overflow for o in outs):
                    raise RuntimeError("the ranks' route_overflow differ: "
                                       f"{[o['overflow'] for o in outs]}")
                counts[f"overflow{n}"] = [o["overflow_counts"] for o in outs]
    return t_virtual, overflow, counts


def rank_main(rank: int, world: int, workdir: str, device) -> int:
    """One rank of `rank_walls`, in a process of its own."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(workdir, f"store{world}"), world), rank=rank,
        world_size=world)
    try:
        inp = torch.load(os.path.join(workdir, "inputs.pt"),
                         map_location=dev, weights_only=False)
        # the gloo group even for one rank: the walls run eagerly
        mesh = make_mesh(device=dev, group=dist.group.WORLD)
        out = {}
        if "wall" in inp["tasks"][world]:
            sweeps = [SweepInput(*s) for s in inp["sweeps"]]
            out["wall_s"], run = time_engine(
                lambda: ShardedLioEngine(inp["cfg"], mesh), sweeps,
                repeats=2)
            out["wall_counts"] = run.counts
        if "overflow" in inp["tasks"][world]:
            run = Run(ShardedLioEngine(inp["cfg_o"], mesh),
                      [SweepInput(*s) for s in inp["sweeps_o"]])
            run.sweep_pass(1)
            out["overflow"] = [int(o) for o in run.overflow]
            out["overflow_counts"] = run.counts
        with open(os.path.join(workdir, f"rank{world}_{rank}.json"),
                  "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the measurement
# ---------------------------------------------------------------------------

def _positions(run: Run) -> np.ndarray:
    return torch.stack(run.positions).cpu().numpy()


def _programs_built(run: Run) -> list:
    """The programs a run's engine built: name, graph nodes (none on the
    CPU), capture seconds and replays."""
    return [{"name": p.name, "nodes": p.nodes, "capture_s": p.capture_s,
             "replays": p.replays} for p in run.engine.programs.values()]


def run_bench(device="cuda", link_gbs=None, coll_latency_us=None,
              runner=None) -> dict:
    """The whole measurement; returns the record.  `runner(name, fn)`
    runs `fn()` for each engine's untimed first pass ("single",
    "strong<n>", "weak<n>") and for the saturating point's timed engines
    ("single8x", "weak64"), so a caller can wrap them (default: calls
    `fn()`)."""
    dev = resolve_device(device)
    runner = runner or (lambda name, fn: fn())
    link = nvlink_bw(dev.index or 0) if dev.type == "cuda" else None
    if link_gbs is not None:
        link = (link_gbs * 1e9, "--link-gbs" + (
            "" if link else " (no NVLink reported)"))
    if link is None:
        raise ValueError("no NVLink reported for the device: pass "
                         "--link-gbs (bytes per direction, GB/s)")
    link_bw, link_src = link
    if dev.type == "cuda":
        from sr_livo_tpu_torch import kernels
        kernels.build("plane_fit")     # once, before any rank starts

    cfg = base_cfg()
    cap = cfg.icp.max_num_residuals > 0
    sweeps = build_sweeps(cfg, device=dev)
    mesh1 = make_mesh(1, device=dev)

    # 1+2+4. single-device baseline, strong and weak per-shard proxies,
    # measured ROUND-ROBIN (3 passes, per-config min), so every config
    # goes through the same host and device weather.
    runs = {"single": (lambda: LioEngine(cfg, device=dev), sweeps)}
    for n in STRONG_N:
        runs[f"strong{n}"] = (lambda ov=pershard_override(cfg, n):
                              ShardedLioEngine(cfg, mesh1,
                                               budget_override=ov), sweeps)
    weak_cfgs = {n: base_cfg(scale=n) for n in WEAK_N}
    for n, cfgw in weak_cfgs.items():
        runs[f"weak{n}"] = (
            lambda cfgw=cfgw, n=n: ShardedLioEngine(
                cfgw, mesh1, budget_override=pershard_override(cfgw, n)),
            build_sweeps(cfgw, device=dev))
    live = {name: runner(name, lambda mk=mk, sw=sw: warm_run(mk, sw))
            for name, (mk, sw) in runs.items()}
    best = {name: np.inf for name in runs}
    for _pass in range(3):
        for name, run in live.items():
            best[name] = min(best[name],
                             run.sweep_pass(len(run.sweeps) + 1))
    gap = float(np.abs(_positions(live["strong1"])
                       - _positions(live["single"])).max())
    strong8 = live["strong8"]
    counted = count_collectives(
        strong8.engine, strong8.state, strong8.vmap, sweeps[-1],
        cfg.odometry_options.init_num_frames)
    rounds = counted["psum_rounds"]
    launches = {name: run.counts for name, run in live.items()}
    built = {name: _programs_built(run) for name, run in live.items()}
    _drop(*live.values())
    del live, runs, strong8
    _free(dev)
    t_single = best["single"]
    t_pershard = {n: best[f"strong{n}"] for n in STRONG_N}
    t_weak = {n: best[f"weak{n}"] for n in WEAK_N}
    print(f"[scaling] round-robin minima: single {t_single*1e3:.2f} ms; "
          + "; ".join(f"strong{n} {t*1e3:.2f}" for n, t in t_pershard.items())
          + "; " + "; ".join(f"weak{n} {t*1e3:.2f}" for n, t in t_weak.items()),
          file=sys.stderr)

    # 3. the replicated remainder: IMU scan + 17x17 solve rounds
    t_repl = time_replicated(LioEngine(cfg, device=dev), sweeps[0])
    _free(dev)

    # 5. walls of real ranks on the device + the real-mesh overflow check
    cfg8 = base_cfg(scale=8)
    sweeps8 = build_sweeps(cfg8, device=dev)
    t_virtual, overflow_real_mesh, rank_counts = rank_walls(
        cfg, sweeps, cfg8, sweeps8, dev)
    launches.update(rank_counts)
    for n, t in t_virtual.items():
        print(f"[scaling] {n}-rank wall: {t*1e3:.2f} ms", file=sys.stderr)
    print(f"[scaling] {OVERFLOW_N}-rank weak-8 route_overflow/sweep: "
          f"{overflow_real_mesh}", file=sys.stderr)

    # 3b. per-stage per-rank times of the weak-8 and strong-8 steps
    stage_weak8, launches["stage_weak8"] = stage_profile(
        cfg8, pershard_override(cfg8, 8), sweeps8, dev)
    _free(dev)
    stage_strong8, launches["stage_strong8"] = stage_profile(
        cfg, pershard_override(cfg, 8), sweeps, dev)
    _free(dev)
    print(f"[scaling] weak-8 stage profile: {stage_weak8}", file=sys.stderr)
    print(f"[scaling] strong-8 stage profile: {stage_strong8}",
          file=sys.stderr)

    # 4b. the SATURATING weak point: 8x base per rank, 64x over 8 ranks
    t_single8, run8 = runner("single8x", lambda: time_engine(
        lambda: LioEngine(cfg8, device=dev), sweeps8))
    launches["single8x"] = run8.counts
    built["single8x"] = _programs_built(run8)
    _drop(run8)
    del run8
    _free(dev)
    print(f"[scaling] single device at 8x workload: {t_single8*1e3:.2f} ms",
          file=sys.stderr)
    cfg64 = base_cfg(scale=64)
    sweeps64 = build_sweeps(cfg64, n=4, device=dev)
    t_weak64, run64 = runner("weak64", lambda: time_engine(
        lambda: ShardedLioEngine(cfg64, mesh1,
                                 budget_override=pershard_override(cfg64, 8)),
        sweeps64, repeats=2))
    launches["weak64"] = run64.counts
    built["weak64"] = _programs_built(run64)
    _drop(run64)
    del run64, sweeps64
    _free(dev)
    print(f"[scaling] weak per-shard (n=8, 64x global = 8x per rank): "
          f"{t_weak64*1e3:.2f} ms", file=sys.stderr)

    if coll_latency_us is not None:
        latency, lat_src = coll_latency_us * 1e-6, "--coll-latency-us"
    else:
        latency, lat_src = collective_latency(dev)

    def comm(c, n):
        return comm_model(pershard_budgets(c, n), n, rounds, cap,
                          link_bw=link_bw, latency=latency)

    comm64 = comm(cfg64, 8)
    eff_weak_sat = efficiency_weak(t_single8, t_weak64, comm64)
    eff_strong = {n: efficiency_strong(t_single, t_pershard[n], comm(cfg, n),
                                       n) for n in (2, 4, 8)}
    eff_weak = {n: efficiency_weak(t_single, t_weak[n],
                                   comm(weak_cfgs[n], n)) for n in WEAK_N}
    device_rec = device_record(dev)
    return {
        "backend": f"{device_rec.get('name', 'cpu')} (1-device-mesh "
                   "per-shard programs; collectives modeled analytically)",
        "device": device_rec,
        "physical_cores": os.cpu_count(),
        "step_ms_single_chip": t_single * 1e3,
        "step_ms_pershard": {n: t * 1e3 for n, t in t_pershard.items()},
        "step_ms_pershard_weak": {n: t * 1e3 for n, t in t_weak.items()},
        "step_ms_virtual_wall": {n: t * 1e3 for n, t in t_virtual.items()},
        "route_overflow_real_mesh_weak8": overflow_real_mesh,
        "replicated_ms": t_repl * 1e3,
        "replicated_fraction": t_repl / t_single,
        "comm_model": {
            "link_bw_gbs": link_bw / 1e9, "link_bw_source": link_src,
            "latency_per_collective_us": latency * 1e6,
            "latency_source": lat_src,
            "residual_cap": cap,
            "comm_ms_strong_8": comm(cfg, 8) * 1e3,
            "collectives_counted_strong8_steady": counted,
            "collectives_modeled": collectives_per_sweep(rounds, cap)},
        "efficiency_strong": eff_strong,
        "efficiency_weak": eff_weak,
        "stage_profile_weak8_ms": stage_weak8,
        "stage_profile_strong8_ms": stage_strong8,
        "saturating_weak_8": {
            "per_chip_workload": "8x base (global 64x over 8 ranks)",
            "step_ms_single_chip_8x": t_single8 * 1e3,
            "step_ms_pershard": t_weak64 * 1e3,
            "comm_ms": comm64 * 1e3,
            "efficiency": eff_weak_sat},
        "strong1_vs_single_max_gap_m": gap,
        "launches": launches,
        "programs_built": built,
        "timed_as": {
            "programs": "step_ms_single_chip, step_ms_pershard, "
                        "step_ms_pershard_weak, replicated_ms, "
                        "stage_profile_*, saturating_weak_8: captured "
                        "programs replayed",
            "eager": "step_ms_virtual_wall: n ranks over gloo, whose "
                     "collectives cannot be captured"},
        "note": "t_pershard(n) is the exact per-rank program of an n-rank "
                "run (budget_override on a world of one, where collectives "
                "are identities): real compute, no emulation.  Strong = "
                "the same workload split n ways (static-shape slack bounds "
                "it); weak = n x the workload (sweep density, frame and "
                "keypoint budgets, map capacity all x n) at constant "
                "per-rank budgets.  The walls run n ranks on the one "
                "device over gloo (collectives staged through the host, "
                "the ranks sharing the device and the host's cores): "
                "floors, not estimates.",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default: the kernels on the GPU) or cpu "
                         "(the plain PyTorch path)")
    ap.add_argument("--link-gbs", type=float, default=None,
                    help="link bandwidth per direction, GB/s, for the "
                         "collective model (default: the card's NVLink as "
                         "nvidia-smi reports it)")
    ap.add_argument("--coll-latency-us", type=float, default=None,
                    help="latency per collective, us (default: measured)")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args.rank, args.world, args.workdir, args.device)
    resolve_device(args.device)
    out = run_bench(args.device, link_gbs=args.link_gbs,
                    coll_latency_us=args.coll_latency_us)
    os.makedirs(os.path.dirname(DEFAULT_OUT), exist_ok=True)
    with open(DEFAULT_OUT, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
