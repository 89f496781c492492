#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sr_livo_tpu_torch`) on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only profile   # device + profile phases only
    python3 chip_smoke.py --only livo      # device + livo phases only
    python3 chip_smoke.py --only longrun   # device + longrun (+ its shapes)
    python3 chip_smoke.py --only resume    # device + resume phases only
    python3 chip_smoke.py --only replay    # device + replay + demo phases
    python3 chip_smoke.py --only sharded   # device + sharded phase

Phases, each printing one JSON line:

  1. device  — requires `torch.cuda.is_available()` (exits 2 otherwise)
     and prints the card's name and power limit as nvidia-smi reports
     them;
  2. build   — compiles sr_livo_tpu_torch/csrc/plane_fit.cu with nvcc;
  3. kernels_vs_plain — holds the kernel's two row entries (`plane_rows`,
     `plane_assoc`, off the main path) against their plain PyTorch
     versions at the shapes the main path gave them (Q = max_keypoints =
     1024 and Q = query_chunk = 512 rows, M = 20) and times both;
  4. slice   — drives the LIO pipeline (LivoPipeline -> LioEngine.step) on
     a 20 s synthetic run at bench.py's LIO shapes, once per IEKF
     association mode, with the launch counters set to 0 just before
     each run and read just after; checks ATE < 0.05 m, at most 2 failed
     registrations, `knn_plane_assoc` launched once per sweep (default
     mode) or `knn_plane_rows` once per IEKF iteration
     (`cache_association=False`), and no launch of the row entries and
     no plain kNN on the card.  Each run records the map and one sweep's
     keypoints at the end of its warm-up;
  5. fused_vs_plain — holds the fused entries (`knn_plane_assoc`,
     `knn_plane_rows`) against their plain versions on those real maps
     and keypoints at nb_voxels 1 and 2, and times them at 1 (the steady
     state);
  6. profile — torch.profiler over 20 sweeps of the default mode after a
     warm-up: the 10 device ops that took most time and the device's
     busy share of the window;
  6b. sharded — the map-sharded engine (parallel.sharded_lio) on the
     slice's run: the single-device pipeline's sweeps, each as
     `LioEngine.step` got it, replayed into `ShardedLioEngine` (a) as a
     world of one over NCCL (the bars of tests/test_sharded_lio.py
     against the single-device records, success on every frame, the
     owned map size, no routing overflow, ATE < 0.05 m,
     `knn_plane_assoc` once per IEKF update and no plain kNN on the
     card), then `compact` and one sharded windowed-BA solve (8
     keyframes x 512 points of the run, 3 iterations: no overflow, one
     launch per iteration); (b) as two ranks sharing the card over gloo,
     in two processes of this script (the same checks, and every rank's
     replicated outputs the same bits); (c) `knn_plane_assoc` against
     its plain version and timed at the two shard shapes: the IEKF's
     K4 x 20 on rank 0's local table (captured in (b)) and the BA's
     W x 20 (captured in (a); a2d there on rows not flat to rounding);
  7. livo    — the full LIVO loop (LivoPipeline with a VisionModule) at
     bench.py's configuration (512 x 640 images rendered on the card, 300
     tracks, the default colored-map shapes) on a 20 s run: warm-up as in
     bench.py, then the timed rest with synchronizing stage timers
     (sweeps+images/s, stage times, peak device memory), then a
     torch.profiler window of 20 frames.  It checks the bars of
     tests/test_vision_pipeline.py (ATE, kept tracks and inliers, the
     camera intrinsics, time offset and extrinsic, the colored map),
     `knn_plane_assoc` launched once per sweep and no plain kNN call on
     the card;
  8. longrun — the same run with the long-run parts on: the mapping
     backend (loop feedback into the filter with map rebuild, otherwise
     BackendConfig's defaults), far-voxel eviction every 20 frames and a
     StreamPublisher into a temporary directory.  It prints the backend's
     counts (keyframes, BA runs, verified candidates, closures, feedback
     events, map rebuilds), eviction calls and dropped voxels, stream
     lines and chunks, the `backend` stage's mean and longest time, the
     final pose-graph solve and a PCG solve of a 100-node chain, and
     checks test_backend.py's ATE bars on the optimized trajectory, the
     vision bars, one stream line per frame, the backend's own
     `knn_plane_assoc` launches (counted around its keyframe hook, where
     all its associations run) equal to 2 per BA run plus 9 per verified
     loop candidate, the rest once per sweep, no other entry and no plain
     kNN on the card.  `compact_map` of the final map at 6 m on the card
     must equal the CPU's.  Then `fused_vs_plain` holds `knn_plane_assoc`
     against its plain version at the backend's two shapes captured in
     the run (BA: 4096 x 20 at 0.6 m on the live map; loop verification:
     1024 x 10 on the 2^14-slot temporary map), a2d only on rows that are
     not flat to rounding (`FLAT_FLOOR`), and times them;
  9. resume  — the first 10 s of the run without the backend, straight
     through and again checkpointed at 5 s and resumed in a fresh
     pipeline: the same frames, positions within 5e-3 m, the same colored
     points after the load; checkpoint bytes, save and load seconds.
  10. replay — the real-data entry point: a 20 s bag of the r3live profile
     of scripts/accuracy_gate.py (its world and `standard` trajectory, a
     Livox cone at 10 Hz, IMU at 200 Hz, distorted 512 x 640 images
     rendered on the card with the published calibration), written with
     tests/rosbag_writer.py and replayed through `drivers.replay_bag`
     into LivoPipeline with a VisionModule configured by
     configs/r3live.yaml and the gate's overrides.  It prints the gate's
     record, the replay's wall time, sweeps+images/s and host ms per
     message class (bag read, parsers, driver, native wire pack, native
     remap), and checks the gate's bars (ATE < 0.08 m, registered share
     >= 0.95, mean tracks >= 60), `knn_plane_assoc` launched once per
     IEKF update (once per frame, twice for a frame whose weak solve
     `retry_wider_neighborhood` re-runs) and no plain kNN call on the
     card;
  11. demo    — `python -m sr_livo_tpu_torch.runtime.demo --device cuda
     --duration 10 --vision` in a subprocess: exit 0 and pose.txt.

Each entry's times: device ms per launch from CUDA-graph replay (`ms`),
one eager call of the kernel (`call_ms`) and of the plain version
(`plain_ms`) as the path makes them, and the least time the card could
take for the same work (`bound_ms`, by bytes or operations, counted from
this run's inputs; `launches`, `launches_livo`, `launches_backend`,
`launches_replay`: the launches in the slice and livo runs, the
backend's own in the longrun run, and those of the bag replay;
`launches_sharded` and `sharded_shapes`: phase `sharded`'s).  Then it
prints the `{"kernels": [...]}` summary, the nvidia-smi line and, last,
`{"ok": true, "device": {...}}`.  Any failed phase raises and the script
exits non-zero without that last line.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sr_livo_tpu_torch import kernels  # noqa: E402
from sr_livo_tpu_torch.config import LivoConfig, load_config  # noqa: E402
from sr_livo_tpu_torch.models import eskf as eskf_mod  # noqa: E402
from sr_livo_tpu_torch.models import lio  # noqa: E402
from sr_livo_tpu_torch.models.vision import VisionModule  # noqa: E402
from sr_livo_tpu_torch.ops import plane_fit  # noqa: E402
from sr_livo_tpu_torch.ops import voxel_map as vm  # noqa: E402
from sr_livo_tpu_torch.parallel import ba as pba  # noqa: E402
from sr_livo_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from sr_livo_tpu_torch.parallel import pose_graph, sharded_lio  # noqa: E402
from sr_livo_tpu_torch.pipeline import LivoPipeline  # noqa: E402
from sr_livo_tpu_torch.runtime import drivers, native  # noqa: E402
from sr_livo_tpu_torch.runtime import synthetic, tum  # noqa: E402
from sr_livo_tpu_torch.utils import lie  # noqa: E402
from sr_livo_tpu_torch.utils.profiling import StageTimers  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s
# and float32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# Kernel-vs-plain tolerances (tests/test_pallas_plane.py): rows where the
# `good` masks agree > 99.5%; on rows good in both, h within 2e-4 and h_x
# within 2e-3.  The association entries are held to the same bars: a2d
# like h, the (sign-free) normal like h_x on rows the IEKF can use, the
# neighbour count exactly and the closest neighbour exactly (for the fused
# entry, wherever the two nearest distances differ by more than 1e-6).
GOOD_AGREE = 0.995
ATOL_H = 2e-4
ATOL_HX = 2e-3

KERNEL_SOURCE = "sr_livo_tpu_torch/csrc/plane_fit.cu"
REPLACES = "sr_livo_tpu/ops/pallas/plane_fit.py:229"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: the row entries vs plain
# ---------------------------------------------------------------------------

def plane_inputs(q: int, m: int, seed: int):
    """Planar-ish, distance-sorted neighbourhoods with n_found uniform in
    [0, m] (the input recipe of tests/test_pallas_plane.py)."""
    rng = np.random.RandomState(seed)
    world = rng.uniform(-5, 5, (q, 3)).astype(np.float32)
    normal = rng.randn(q, 3)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    t1 = np.cross(normal, [0.1, 0.7, 0.2])
    t1 /= np.linalg.norm(t1, axis=-1, keepdims=True)
    t2 = np.cross(normal, t1)
    uv = rng.uniform(-0.5, 0.5, (q, m, 2))
    nb = (world[:, None, :] + uv[..., :1] * t1[:, None, :]
          + uv[..., 1:] * t2[:, None, :]
          + rng.randn(q, m, 3) * 0.01
          + normal[:, None, :] * rng.uniform(-0.1, 0.1, (q, 1, 1)))
    d = np.linalg.norm(nb - world[:, None, :], axis=-1)
    order = np.argsort(d, axis=-1)
    nb = np.take_along_axis(nb, order[..., None], axis=1).astype(np.float32)
    n_found = rng.randint(0, m + 1, q).astype(np.int32)
    location = rng.uniform(-5, 5, (q, 3)).astype(np.float32)
    last_trans = np.array([0.3, -0.2, 1.0], np.float32)
    valid = rng.rand(q) < 0.9
    dev = torch.device("cuda")
    r_world = lie.exp_so3(torch.tensor([0.2, -0.1, 0.4], device=dev))
    return (torch.as_tensor(nb, device=dev),
            torch.as_tensor(n_found, device=dev),
            torch.as_tensor(world, device=dev),
            torch.as_tensor(location, device=dev), r_world.contiguous(),
            torch.as_tensor(last_trans, device=dev),
            torch.as_tensor(valid, device=dev))


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time of one eager call, by CUDA events over `iters` calls back
    to back (inputs stay in L2, as they do after the kNN gather).  Where
    the host enqueues more slowly than the device runs, this is the host's
    launch cost, which is what the main path pays per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Mean device time of one kernel launch without the host's launch
    cost: `iters` calls captured in one CUDA graph, replayed `reps` times
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (iters * reps)


def bound_ms(n_found: torch.Tensor, m: int, entry: str):
    """Least time for the entry's work on these inputs: each byte it must
    move once (only the first max(n_found, 1) neighbours of a row are
    read) over HBM bandwidth, against its float operations over the f32
    peak (about 18 per used neighbour plus a scalar tail of about 230
    for the full row, 150 for the association, transcendentals counted
    as one).  Returns (ms, "bytes" or "operations")."""
    used = torch.clamp(n_found, 1, m).sum().item()
    q = n_found.shape[0]
    nb_bytes = 12 * used
    if entry == "plane_rows":
        io = nb_bytes + q * (4 + 12 + 12 + 1) + 36 + 12 + q * (24 + 4 + 1)
        ops = 18 * used + 230 * q
    else:
        io = nb_bytes + q * 4 + q * (12 + 4 + 12)
        ops = 18 * used + 150 * q
    t_bytes, t_ops = io / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def check_rows(args, kw) -> float:
    hx_k, h_k, good_k = plane_fit.plane_rows_cuda(*args, **kw)
    hx_p, h_p, good_p = plane_fit.plane_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    agree = float((good_k == good_p).float().mean())
    both = good_k & good_p
    err_h = _max_abs(h_k[both], h_p[both])
    err_hx = _max_abs(hx_k[both], hx_p[both])
    if agree <= GOOD_AGREE or err_h > ATOL_H or err_hx > ATOL_HX:
        raise AssertionError(f"plane_rows disagrees with its plain version "
                             f"({kw}): good agreement {agree}, h err "
                             f"{err_h}, h_x err {err_hx}")
    return max(err_h, err_hx)


def check_assoc(neighbors, n_found, min_neighbors: int) -> float:
    n_k, a_k, c_k = plane_fit.plane_assoc_cuda(neighbors, n_found)
    n_p, a_p, c_p = plane_fit.plane_assoc_plain(neighbors, n_found)
    torch.cuda.synchronize()
    if not torch.equal(c_k, c_p):
        raise AssertionError("plane_assoc: closest neighbour differs")
    rows = n_found >= min_neighbors       # the rows the IEKF can use
    sign = torch.where((n_k * n_p).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    err_a = _max_abs(a_k[rows], a_p[rows])
    err_n = _max_abs((n_k * sign)[rows], n_p[rows])
    if err_a > ATOL_H or err_n > ATOL_HX:
        raise AssertionError(f"plane_assoc disagrees with its plain version:"
                             f" a2d err {err_a}, normal err {err_n}")
    return max(err_a, err_n)


def kernel_shapes(cfg: LivoConfig) -> dict:
    """(Q, M) that the main path gives each entry: `plane_rows` takes all
    `max_keypoints` rows per IEKF iteration; `plane_assoc` takes
    `query_chunk`-row slices when the chunk is below `max_keypoints`
    (models/lio.py::chunked_assoc), else all rows."""
    sh, m = cfg.shapes, cfg.icp.max_number_neighbors
    chunked = 0 < sh.query_chunk < sh.max_keypoints
    return {"plane_rows": (sh.max_keypoints, m),
            "plane_assoc": (sh.query_chunk if chunked else sh.max_keypoints,
                            m)}


def kernel_phase(cfg: LivoConfig) -> dict:
    shapes = kernel_shapes(cfg)
    results = {name: {"q": q, "m": m, "max_abs_err": 0.0}
               for name, (q, m) in shapes.items()}
    for seed, (power, min_nb) in enumerate(((2.0, 12), (1.5, 8))):
        kw = dict(lam_w=0.9, lam_nb=0.1, power_planarity=power,
                  max_dist=0.3, min_neighbors=min_nb)
        r, a = results["plane_rows"], results["plane_assoc"]
        rows_args = plane_inputs(*shapes["plane_rows"], seed=23 + seed)
        nb, nf = plane_inputs(*shapes["plane_assoc"], seed=43 + seed)[:2]
        r["max_abs_err"] = max(r["max_abs_err"], check_rows(rows_args, kw))
        a["max_abs_err"] = max(a["max_abs_err"], check_assoc(nb, nf, min_nb))
        if power == 2.0:    # time at the main path's setting
            entries = (
                (r, "plane_rows", rows_args[1],
                 lambda: plane_fit.plane_rows_cuda(*rows_args, **kw),
                 lambda: plane_fit.plane_rows_plain(*rows_args, **kw)),
                (a, "plane_assoc", nf,
                 lambda: plane_fit.plane_assoc_cuda(nb, nf),
                 lambda: plane_fit.plane_assoc_plain(nb, nf)))
            for res, name, n_found, kernel, plain in entries:
                res["ms"] = graph_ms(kernel)
                res["call_ms"] = time_ms(kernel)
                res["plain_ms"] = time_ms(plain)
                res["bound_ms"], res["bound_by"] = bound_ms(
                    n_found, res["m"], name)
    return results


# ---------------------------------------------------------------------------
# Phase 4: the slice end to end
# ---------------------------------------------------------------------------

def bench_lio_cfg(cache_association: bool) -> LivoConfig:
    """bench.py's LIO shapes and reference-scale budgets (bench.py:32-48):
    1.0 m map voxels, <= 600 residuals, 5 ICP iterations, 16384 sweep /
    8192 frame points, 1024 keypoints, 64 IMU samples, 2^18 map slots of
    20 points."""
    cfg = LivoConfig()
    cfg.odometry_options.voxel_size = 0.25
    cfg.odometry_options.sample_voxel_size = 1.0
    cfg.odometry_options.min_distance_points = 0.1
    cfg.icp.size_voxel_map = 1.0
    cfg.icp.min_number_neighbors = 12
    cfg.icp.max_num_residuals = 600
    cfg.icp.num_iters_icp = 5
    cfg.shapes.max_sweep_points = 16384
    cfg.shapes.max_frame_points = 8192
    cfg.shapes.max_keypoints = 1024
    cfg.shapes.max_imu_samples = 64
    cfg.shapes.map_capacity = 1 << 18
    cfg.cache_association = cache_association
    return cfg


def cut_all(pipe: LivoPipeline, sim) -> list:
    for (t, a, g) in sim.imu:
        pipe.push_imu(t, a, g)
    for c in sim.lidar_chunks:
        pipe.push_points(c)
    for (t, img) in sim.images:
        pipe.push_image(t, img)
    meas = []
    while True:
        m = pipe.cutter.get()
        if m is None:
            return meas
        meas.append(m)


def _to(device, x):
    return x.to(device, copy=True) if torch.is_tensor(x) else x


class Capture:
    """Within the block, records the arguments of the first call of a
    `plane_fit` entry (for which `want(args, kw)` holds, if given): a copy
    of the map and of the tensors, taken before the call, kept in host
    memory so that it does not count in the run's peak device memory.
    Every call is passed on.  `args_on(device)` returns the record on a
    device."""

    def __init__(self, name: str, want=None):
        self.name, self.args = name, None
        self.want = want or (lambda args, kw: True)

    def __enter__(self):
        self.orig = getattr(plane_fit, self.name)   # Captures may nest

        def spy(vmap, *args, **kw):
            if self.args is None and self.want(args, kw):
                self.args = (vm.VoxelMap(*(_to("cpu", t) for t in vmap)),
                             tuple(_to("cpu", a) for a in args), dict(kw))
            return self.orig(vmap, *args, **kw)
        setattr(plane_fit, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(plane_fit, self.name, self.orig)

    def args_on(self, device):
        vmap, args, kw = self.args
        return (vm.VoxelMap(*(_to(device, t) for t in vmap)),
                tuple(_to(device, a) for a in args), kw)


class Spy:
    """Within the block, wraps module or class attributes and passes every
    call on.  Each target `(owner, name, key[, when])` adds the calls of
    `owner.name` for which `when(*args, **kw)` holds (every call, without
    `when`) to `calls[key]` and their host milliseconds to `ms[key]`; `n`
    is the calls of all targets."""

    def __init__(self, *targets):
        self.targets, self.ms, self.calls, self.undo = targets, {}, {}, []

    @property
    def n(self) -> int:
        return sum(self.calls.values())

    def add(self, key, seconds):
        self.ms[key] = self.ms.get(key, 0.0) + 1e3 * seconds
        self.calls[key] = self.calls.get(key, 0) + 1

    def patch(self, owner, name, value):
        self.undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def _wrap(self, orig, key, when=None):
        def spy(*args, **kw):
            if when is not None and not when(*args, **kw):
                return orig(*args, **kw)
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                self.add(key, time.perf_counter() - t0)
        return spy

    def __enter__(self):
        for owner, name, key, *when in self.targets:
            self.patch(owner, name, self._wrap(getattr(owner, name), key,
                                               *when))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self.undo):
            setattr(owner, name, orig)


def cuda_knn_calls() -> Spy:
    """Counts calls of the plain kNN (`voxel_map.knn`) on CUDA tensors."""
    return Spy((vm, "knn", "knn",
                lambda vmap, queries, **kw: queries.is_cuda))


def slice_phase(sim, cache_association: bool, n_warm: int = 60):
    """One pipeline run; the first `n_warm` measurements (IMU static init
    and the first frames) warm the allocator and are not timed, and the
    last of them is captured for the fused kernels' check.  Returns the
    phase's record and the Capture."""
    entry = "knn_plane_assoc" if cache_association else "knn_plane_rows"
    cfg = bench_lio_cfg(cache_association)
    plane_fit.reset_launches()
    with cuda_knn_calls() as knn_calls:
        pipe = LivoPipeline(cfg, device="cuda")
        meas = cut_all(pipe, sim)
        pipe.process_measurements(meas[:n_warm - 1])
        with Capture(entry) as cap:
            pipe.process_measurements(meas[n_warm - 1:n_warm])
        torch.cuda.synchronize()
        pipe.timers = StageTimers(sync=True, device=pipe.device)
        torch.cuda.reset_peak_memory_stats()
        n0 = pipe.index_frame
        t0 = time.perf_counter()
        pipe.process_measurements(meas[n_warm:])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = dict(plane_fit.launches)

    recs = pipe.records
    n_fail = sum(1 for r in recs if not r.success)
    iterations = sum(r.iterations for r in recs)
    ts, ps, _ = pipe.trajectory()
    ate = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
    out = {"phase": "slice", "cache_association": cache_association,
           "measurements": len(meas), "frames": len(recs),
           "iekf_iterations": iterations,
           "timed_frames": pipe.index_frame - n0,
           "timed_seconds": seconds,
           "sweeps_per_s": (pipe.index_frame - n0) / seconds,
           "ate_m": ate, "failed_registrations": n_fail,
           "launches": launches, "plain_knn_calls_on_cuda": knn_calls.n,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "stages_ms": {k: v["mean_ms"]
                         for k, v in pipe.timers.report().items()}}
    emit(out)
    if not pipe.initialized or len(recs) < 100:
        raise AssertionError(f"too few frames processed: {len(recs)}")
    want = len(recs) if cache_association else iterations
    if launches[entry] != want:
        raise AssertionError(f"{entry} launched {launches[entry]} times, "
                             f"expected {want}")
    others = {k: v for k, v in launches.items() if k != entry and v}
    if others or knn_calls.n:
        raise AssertionError(f"the main path launched {others} and called "
                             f"the plain kNN {knn_calls.n} times on CUDA")
    if n_fail > 2:
        raise AssertionError(f"{n_fail} failed registrations")
    if not ate < 0.05:
        raise AssertionError(f"ATE RMSE {ate} m")
    if cap.args is None:
        raise AssertionError(f"no call of {entry} was captured")
    return out, cap


# ---------------------------------------------------------------------------
# Phase 5: the fused entries against their plain versions on a real map
# ---------------------------------------------------------------------------

def fused_bound_ms(vmap, world, rows, thr, kw, entry: str):
    """Least time for a fused entry's work on these inputs.  Bytes: each
    distinct 32-byte sector of the signature column that a probe chain
    reads, each distinct found voxel's key row, count and occupied points
    (after the count threshold), once, plus the inputs and outputs; over
    HBM bandwidth.  Operations: about 8 per ranked candidate for its
    distance plus log2(M) for the selection, and a tail of 150
    (association) or 230 (full row) per keypoint searched; over the f32
    peak.  `rows` marks the keypoints the entry searches."""
    k, p, m = vmap.block_capacity, kw["max_probe"], kw["max_neighbors"]
    w = world[rows]
    coords = (vm.voxel_coords(w, kw["voxel_size"])[:, None, :]
              + vm._offsets(kw["nb_voxels"], w.device)[None])
    cand, match_idx, empty_idx = vm._probe_chain(vmap.sig, coords, p)
    slots = vm._resolve(vmap.keys, cand, match_idx, empty_idx, coords, p)
    n_read = torch.clamp(torch.minimum(match_idx, empty_idx), max=p - 1) + 1
    read = torch.arange(p, device=w.device) < n_read[..., None]
    sectors = torch.unique(cand[read] // 8).numel()
    cnt = torch.where(slots >= 0, vmap.counts[slots.clamp(min=0)], 0)
    cnt = torch.where(cnt >= thr, cnt.clamp(max=k), 0)
    found = torch.unique(slots[slots >= 0])
    blk = vmap.counts[found]
    blk = torch.where(blk >= thr, blk.clamp(max=k), 0)
    n_cand = int(cnt.sum())
    q = world.shape[0]
    if entry == "knn_plane_rows":
        io = q * (12 + 12 + 1) + 36 + 12 + 4 + q * (24 + 4 + 1)
        tail = 230
    else:
        io = q * (12 + 1) + 4 + q * (12 + 4 + 12 + 4)
        tail = 150
    nbytes = 32 * sectors + found.numel() * (12 + 4) + 12 * int(blk.sum()) + io
    ops = n_cand * (8 + math.log2(m)) + tail * int(rows.sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _search_kw(kw) -> dict:
    return {a: kw[a] for a in ("voxel_size", "max_neighbors", "max_probe",
                               "nb_voxels")}


def fused_assoc_pair(vmap, world, valid, thr, kw) -> tuple:
    """`knn_plane_assoc` on the card and its plain version on the same
    inputs.  The exact parts must agree: the neighbour counts, the rows
    past the valid prefix left zero, and the closest neighbour wherever the
    two nearest distances differ by more than 1e-6.  Returns (normal, a2d)
    of each and the plain neighbour counts, over the valid prefix."""
    n_k, a_k, c_k, f_k = plane_fit.knn_plane_assoc_cuda(
        vmap, world, valid, thr, **kw)
    n_p, a_p, c_p, f_p = plane_fit.knn_plane_assoc_plain(
        vmap, world, valid, thr, **dict(kw, chunk=0))
    _, _, dists = vm.knn(vmap, world, threshold_capacity=thr,
                         **_search_kw(kw))
    torch.cuda.synchronize()
    nv = int(valid.sum())
    v = slice(0, nv)
    if not torch.equal(f_k[v], f_p[v]):
        raise AssertionError(f"knn_plane_assoc {kw}: neighbour counts differ")
    if f_k[nv:].any() or c_k[nv:].any() or n_k[nv:].any() or a_k[nv:].any():
        raise AssertionError("knn_plane_assoc: rows past the prefix written")
    apart = (((dists[:, 1] - dists[:, 0]) > 1e-6) | (f_p <= 1))[v]
    if not torch.equal(c_k[v][apart], c_p[v][apart]):
        raise AssertionError(f"knn_plane_assoc {kw}: closest differs")
    return n_k[v], a_k[v], n_p[v], a_p[v], f_p[v]


def hold_assoc(kw, pair, rows, rows_a2d, min_rows: int) -> float:
    """The sign-free normal within ATOL_HX on `rows` and a2d within ATOL_H
    on `rows_a2d`; at least `min_rows` rows held."""
    n_k, a_k, n_p, a_p, _ = pair
    sign = torch.where((n_k * n_p).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    err_a = _max_abs(a_k[rows_a2d], a_p[rows_a2d])
    err_n = _max_abs((n_k * sign)[rows], n_p[rows])
    if (err_a > ATOL_H or err_n > ATOL_HX
            or int(rows.sum()) < max(1, min_rows)):
        raise AssertionError(
            f"knn_plane_assoc {kw} disagrees with its plain version: normal "
            f"err {err_n} on {int(rows.sum())} rows, a2d err {err_a} on "
            f"{int(rows_a2d.sum())} rows (at least {min_rows} rows wanted)")
    return max(err_a, err_n)


def check_fused_assoc(vmap, world, valid, thr, kw, min_neighbors) -> float:
    pair = fused_assoc_pair(vmap, world, valid, thr, kw)
    rows = pair[4] >= min_neighbors
    return hold_assoc(kw, pair, rows, rows, rows.shape[0] // 2)


def check_fused_rows(vmap, args, kw) -> float:
    hx_k, h_k, good_k = plane_fit.knn_plane_rows_cuda(vmap, *args, **kw)
    hx_p, h_p, good_p = plane_fit.knn_plane_rows_plain(vmap, *args, **kw)
    torch.cuda.synchronize()
    agree = float((good_k == good_p).float().mean())
    both = good_k & good_p
    err_h = _max_abs(h_k[both], h_p[both])
    err_hx = _max_abs(hx_k[both], hx_p[both])
    if (agree <= GOOD_AGREE or err_h > ATOL_H or err_hx > ATOL_HX
            or int(both.sum()) < 100):
        raise AssertionError(f"knn_plane_rows {kw} disagrees with its plain "
                             f"version: good agreement {agree} "
                             f"({int(both.sum())} good in both), h err "
                             f"{err_h}, h_x err {err_hx}")
    return max(err_h, err_hx)


def fused_phase(captures: dict, min_neighbors: int) -> dict:
    """The fused entries on the slice's map and one sweep's keypoints
    (captured at the end of each mode's warm-up), at nb_voxels 1 and 2;
    timed at the captured (steady-state) setting."""
    results = {}
    cuda = torch.device("cuda")
    vmap, (world, valid, thr), kw = captures["knn_plane_assoc"].args_on(cuda)
    res = results["knn_plane_assoc"] = {
        "q": world.shape[0], "m": kw["max_neighbors"],
        "n_valid": int(valid.sum()), "max_abs_err": 0.0}
    for nb in (1, 2):
        res["max_abs_err"] = max(res["max_abs_err"], check_fused_assoc(
            vmap, world, valid, thr, dict(kw, nb_voxels=nb), min_neighbors))
    res["ms"] = graph_ms(lambda: plane_fit.knn_plane_assoc_cuda(
        vmap, world, valid, thr, **kw))
    res["call_ms"] = time_ms(lambda: plane_fit.knn_plane_assoc_cuda(
        vmap, world, valid, thr, **kw))
    res["plain_ms"] = time_ms(lambda: plane_fit.knn_plane_assoc_plain(
        vmap, world, valid, thr, **kw), iters=30, warmup=3)
    prefix = torch.arange(world.shape[0], device=world.device) < res["n_valid"]
    res["bound_ms"], res["bound_by"] = fused_bound_ms(
        vmap, world, prefix, thr, kw, "knn_plane_assoc")

    vmap, args, kw = captures["knn_plane_rows"].args_on(cuda)
    world, valid, thr = args[0], args[4], args[5]
    res = results["knn_plane_rows"] = {
        "q": world.shape[0], "m": kw["max_neighbors"],
        "n_valid": int(valid.sum()), "max_abs_err": 0.0}
    for nb in (1, 2):
        res["max_abs_err"] = max(res["max_abs_err"], check_fused_rows(
            vmap, args, dict(kw, nb_voxels=nb)))
    res["ms"] = graph_ms(lambda: plane_fit.knn_plane_rows_cuda(
        vmap, *args, **kw))
    res["call_ms"] = time_ms(lambda: plane_fit.knn_plane_rows_cuda(
        vmap, *args, **kw))
    res["plain_ms"] = time_ms(lambda: plane_fit.knn_plane_rows_plain(
        vmap, *args, **kw), iters=30, warmup=3)
    res["bound_ms"], res["bound_by"] = fused_bound_ms(
        vmap, world, valid, thr, kw, "knn_plane_rows")
    return results


# ---------------------------------------------------------------------------
# Phase 6: device profile of the step
# ---------------------------------------------------------------------------

KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx")


def device_profile(run, ranges: str = "") -> dict:
    """torch.profiler around `run()` (which ends in a synchronize): the
    window's host wall time, the device events in it, the union of their
    time (the device's busy time and share of the window), and the 10
    device ops with the most device time.  With `ranges`, also each
    profiler range (`record_function`) whose name starts with it: calls,
    host ms, device ms of the kernels it launched, and its kernel
    launches, summed over the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        window_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # the ranges also appear on the device timeline as annotations that
    # span idle gaps; they are not device work
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CUDA
                  and not (ranges and e.name.startswith(ranges))),
                 key=lambda x: x[0])
    busy, end = 0.0, -math.inf
    by_name = {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        tot = by_name.setdefault(name, [0.0, 0])
        tot[0] += b - a
        tot[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    out = {"window_ms": window_us / 1e3, "device_events": len(dev),
           "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / window_us if dev else None,
           "top_device_ops": [{"name": name[:160], "ms": t / 1e3,
                               "calls": n} for name, (t, n) in top]}
    if ranges:
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        launches = sorted(e.time_range.start for e in cpu
                          if e.name in KERNEL_LAUNCHES)
        agg = {}
        for e in cpu:
            if not e.name.startswith(ranges):
                continue
            r = agg.setdefault(e.name, {"calls": 0, "host_ms": 0.0,
                                        "device_ms": 0.0, "launches": 0})
            r["calls"] += 1
            r["host_ms"] += e.time_range.elapsed_us() / 1e3
            r["device_ms"] += e.device_time_total / 1e3
            r["launches"] += (bisect.bisect_right(launches, e.time_range.end)
                              - bisect.bisect_left(launches,
                                                   e.time_range.start))
        out["ranges"] = agg
    return out


def profile_phase(sim, n_warm: int = 60, n_sweeps: int = 20) -> dict:
    """torch.profiler over `n_sweeps` measurements of the default mode
    after `n_warm` warm-up ones."""
    pipe = LivoPipeline(bench_lio_cfg(cache_association=True), device="cuda")
    meas = cut_all(pipe, sim)
    pipe.process_measurements(meas[:n_warm])
    torch.cuda.synchronize()
    n0 = pipe.index_frame

    def run():
        pipe.process_measurements(meas[n_warm:n_warm + n_sweeps])
        torch.cuda.synchronize()

    out = {"phase": "profile", "cache_association": True,
           **device_profile(run), "sweeps": pipe.index_frame - n0}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 7: the full LIVO loop
# ---------------------------------------------------------------------------

CAM = (420.0, 420.0, 320.0, 256.0)
IMAGE_SIZE = (512, 640)     # rows, cols
R_IMU_CAMERA = [0, 0, 1, -1, 0, 0, 0, -1, 0]


def bench_livo_cfg() -> LivoConfig:
    """bench.py's full LIVO configuration (bench.py:32-57): the LIO shapes
    of the slice phase, 512 x 640 images, camera (420, 420, 320, 256)
    without distortion, the forward camera mount, and the default color
    map (2^19 x 20 voxel points, a 2^20 registry, 8192 render points,
    2048 render voxels), 300 tracks, a 4-level pyramid, a 21 px window."""
    cfg = bench_lio_cfg(cache_association=True)
    co = cfg.camera_options
    co.image_width, co.image_height = IMAGE_SIZE[1], IMAGE_SIZE[0]
    co.image_scale = 1.0
    co.camera_intrinsic = [CAM[0], 0, CAM[2], 0, CAM[1], CAM[3], 0, 0, 1]
    co.camera_dist_coeffs = [0, 0, 0, 0, 0]
    cfg.extrinsics.extrinsic_R_imu_camera = list(R_IMU_CAMERA)
    cfg.extrinsics.extrinsic_t_imu_camera = [0.0, 0.0, 0.0]
    return cfg


def livo_sim():
    """The 20 s run with images rendered on the card, handed over as uint8
    like a camera feed (bench.py:80-82).  Returns (sim, ms to render one
    image and copy it to the host)."""
    sim = synthetic.simulate(duration=20.0, n_azimuth=256, n_rings=32,
                             imu_rate=200.0, seed=3, image_size=IMAGE_SIZE,
                             camera=CAM, device="cuda")
    sim.images = [(t, np.clip(np.round(im * 255.0), 0, 255).astype(np.uint8))
                  for (t, im) in sim.images]
    world, traj = synthetic.SyntheticWorld(), synthetic.Trajectory()
    dirs = synthetic._camera_ray_table(CAM, IMAGE_SIZE)
    t0 = time.perf_counter()
    for k in range(10):
        synthetic.render_image(world, traj, 5.0 + 0.1 * k, CAM, IMAGE_SIZE,
                               _dirs_cam=dirs, device="cuda")
    return sim, (time.perf_counter() - t0) * 100.0


def livo_checks(pipe, vision, sim) -> dict:
    """The bars of tests/test_vision_pipeline.py:59-108 on a run."""
    ts, ps, _ = pipe.trajectory()
    stats = np.array([s[1:] for s in vision.stats], np.float64)
    cam = vision.camera
    intr = cam.intr.double().cpu().numpy()
    r_ic = lie.quat_to_rot(cam.q_ic).double().cpu().numpy()
    r_cfg = np.asarray(R_IMU_CAMERA, np.float64).reshape(3, 3)
    ang = math.degrees(math.acos(float(np.clip(
        (np.trace(r_ic @ r_cfg.T) - 1) / 2, -1, 1))))
    cmap = vision.color_map
    colored = (cmap.reg_valid & (cmap.n_rgb >= 3)).cpu().numpy()
    err = np.abs(cmap.rgb.cpu().numpy()[colored] / 255.0
                 - synthetic.SyntheticWorld().color(
                     cmap.pos.cpu().double().numpy()[colored]))
    err_c = np.abs(err - np.median(err, axis=0, keepdims=True))
    return {"ate_m": tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos,
                                  align=True),
            "rendered_frames": len(stats),
            "mean_kept_tracks": float(stats[5:, 0].mean()),
            "mean_inliers": float(stats[5:, 1].mean()),
            "intrinsics": intr.tolist(), "td_s": float(cam.td),
            "extrinsic_rotation_deg": ang,
            "colored_points": int(colored.sum()),
            "median_color_err": float(np.median(err_c))}


def livo_phase(sim, render_ms: float, cfg: LivoConfig,
               n_profile: int = 20) -> dict:
    """The full LIVO loop on `sim`.  Warm-up as bench.py:133-148
    (init_num_frames + 2 frames after filter init and at least 3 rendered
    frames), then the timed rest but the last `n_profile` frames with
    synchronizing stage timers, then those frames under torch.profiler.
    The launch counters are set to 0 just before the run and read just
    after it."""
    plane_fit.reset_launches()
    with cuda_knn_calls() as knn_calls:
        vision = VisionModule(cfg, device="cuda")
        pipe = LivoPipeline(cfg, vision=vision, device="cuda")
        meas = cut_all(pipe, sim)
        n_steady = cfg.odometry_options.init_num_frames + 2
        n_warm = frames = rendered = 0
        for m in meas:
            pipe._process_measurement(m)
            n_warm += 1
            if pipe.initialized:
                frames += 1
                rendered += int(m.rendering and m.image is not None)
                if frames >= n_steady and rendered >= 3:
                    break
        timed = meas[n_warm:len(meas) - n_profile]
        if not timed or rendered < 3:
            raise AssertionError("the warm-up consumed the run")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pipe.timers = StageTimers(sync=True, device=pipe.device)
        n0 = pipe.index_frame
        t0 = time.perf_counter()
        pipe.process_measurements(timed)
        pipe.timers.synchronize()
        seconds = time.perf_counter() - t0
        n_timed = pipe.index_frame - n0
        peak = torch.cuda.max_memory_allocated()
        stages = {k: v["mean_ms"] for k, v in pipe.timers.report().items()}
        # printed even when it did not run: with every sweep cut at an
        # image, the colored-map insert runs inside `vis_insert` instead
        stages.setdefault("color_insert", None)
        rest = meas[len(meas) - n_profile:]
        n_rendered = sum(1 for m in rest if m.rendering
                         and m.image is not None)
        pipe.timers = StageTimers(sync=False, device=pipe.device)

        def run():
            pipe.process_measurements(rest)
            torch.cuda.synchronize()

        prof = device_profile(run, ranges="vision.")
    launches = dict(plane_fit.launches)
    prof["device_ops_per_rendered_frame"] = (
        prof["device_events"] / max(n_rendered, 1))
    checks = livo_checks(pipe, vision, sim)
    out = {"phase": "livo", "measurements": len(meas),
           "frames": len(pipe.records), "timed_frames": n_timed,
           "timed_seconds": seconds,
           "sweeps_images_per_s": n_timed / seconds,
           "stages_ms": stages, "peak_memory_bytes": peak,
           "render_ms_per_image": render_ms, **checks,
           "launches": launches, "plain_knn_calls_on_cuda": knn_calls.n,
           "profile": {"frames": len(rest), "rendered_frames": n_rendered,
                       **prof}}
    emit(out)
    bad = vision_bar_failures(checks)
    if launches["knn_plane_assoc"] != len(pipe.records):
        bad.append(f"knn_plane_assoc launched {launches['knn_plane_assoc']} "
                   f"times in {len(pipe.records)} frames")
    others = {k: v for k, v in launches.items()
              if k != "knn_plane_assoc" and v}
    if others or knn_calls.n:
        bad.append(f"the LIVO path launched {others} and called the plain "
                   f"kNN {knn_calls.n} times on CUDA")
    if bad:
        raise AssertionError("livo phase: " + "; ".join(bad))
    return out


def vision_bar_failures(checks: dict) -> list:
    """The bars of tests/test_vision_pipeline.py that `checks` fails."""
    bad = []
    if not checks["ate_m"] < 0.05:
        bad.append(f"ATE {checks['ate_m']} m")
    if not (checks["mean_kept_tracks"] > 30 and checks["mean_inliers"] > 20):
        bad.append("too few tracks or inliers")
    fx, fy = checks["intrinsics"][:2]
    if not (abs(fx - CAM[0]) < 10 and abs(fy - CAM[1]) < 10):
        bad.append(f"intrinsics drifted to {checks['intrinsics']}")
    if not abs(checks["td_s"]) < 0.05:
        bad.append(f"td {checks['td_s']} s")
    if not checks["extrinsic_rotation_deg"] < 5.0:
        bad.append(f"extrinsic off by {checks['extrinsic_rotation_deg']} deg")
    if not (checks["colored_points"] > 500
            and checks["median_color_err"] < 0.15):
        bad.append(f"{checks['colored_points']} colored points, median "
                   f"error {checks['median_color_err']}")
    return bad


# ---------------------------------------------------------------------------
# Phase 8: the long-run path (backend, eviction, streaming)
# ---------------------------------------------------------------------------

def _is_ba(args, kw) -> bool:
    return args[0].shape[0] > 1024 and kw["max_neighbors"] == 20


def _is_loop(args, kw) -> bool:
    return kw["max_neighbors"] == 10


def compact_cpu_vs_card(vmap: vm.VoxelMap, location: torch.Tensor,
                        distance: float, max_probe: int) -> dict:
    """`compact_map` of a copy of `vmap` on the card and on the CPU at a
    radius that drops voxels: every field and n_dropped must be equal."""
    card, drop_card = vm.compact_map(vm.VoxelMap(*(t.clone() for t in vmap)),
                                     location, distance=distance,
                                     max_probe=max_probe)
    cpu, drop_cpu = vm.compact_map(vm.VoxelMap(*(t.cpu() for t in vmap)),
                                   location.cpu(), distance=distance,
                                   max_probe=max_probe)
    same = {name: torch.equal(a.cpu(), b)
            for name, a, b in zip(vm.VoxelMap._fields, card, cpu)}
    out = {"distance_m": distance, "voxels_before": int(vmap.counts.gt(0)
                                                        .sum()),
           "voxels_after": int(card.counts.gt(0).sum()),
           "n_dropped": int(drop_card), "equal": same,
           "n_dropped_equal": int(drop_card) == int(drop_cpu)}
    if not all(same.values()) or not out["n_dropped_equal"]:
        raise AssertionError(f"compact_map differs on the card: {out}")
    if not 0 < out["voxels_after"] < out["voxels_before"]:
        raise AssertionError(f"compact_map at {distance} m evicted nothing")
    return out


def pcg_solve_ms(n: int = 100, iters: int = 10) -> dict:
    """Device time of the pose graph's PCG path: a drifting n-node chain
    with one loop edge, padded as the backend pads it."""
    from sr_livo_tpu_torch.parallel import pose_graph as pg
    n_pad = 1 << max((n - 1).bit_length(), 3)
    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    t = np.zeros((n_pad, 3), np.float32)
    t[:n, 0] = np.arange(n) * 0.1 + rng.randn(n) * 0.01
    q = np.tile(np.array([1, 0, 0, 0], np.float32), (n_pad, 1))
    ei = np.r_[np.arange(n - 1), 3]
    ej = np.r_[np.arange(1, n), n - 4]
    tm = np.zeros((n, 3), np.float32)
    tm[:, 0] = 0.1
    tm[-1, 0] = 0.1 * (n - 7)
    e_pad = 1 << max((n - 1).bit_length(), 3)
    pad = e_pad - n

    def up(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    graph = pg.PoseGraph(
        q=up(q), t=up(t), edge_i=up(np.r_[ei, np.zeros(pad, int)],
                                    torch.int64),
        edge_j=up(np.r_[ej, np.zeros(pad, int)], torch.int64),
        q_meas=up(np.tile(np.array([1, 0, 0, 0], np.float32), (e_pad, 1))),
        t_meas=up(np.r_[tm, np.zeros((pad, 3), np.float32)]),
        rot_w=up(np.r_[np.full(n, 50.0), np.zeros(pad)], torch.float32),
        t_w=up(np.r_[np.full(n, 50.0), np.zeros(pad)], torch.float32),
        edge_valid=up(np.arange(e_pad) < n))
    pg.optimize_pose_graph(graph, iters=1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    q_out, t_out = pg.optimize_pose_graph(graph, iters=iters)
    stop.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(t_out).all()):
        raise AssertionError("PCG pose-graph solve is not finite")
    return {"nodes": n, "padded_nodes": n_pad, "gn_iterations": iters,
            "cg_steps": max(96, int(1.5 * n_pad)),
            "ms": start.elapsed_time(stop)}


def longrun_phase(sim, cfg: LivoConfig, n_warm_frames: int = 20) -> tuple:
    """bench.py's LIVO configuration with the mapping backend (loop
    feedback on, defaults otherwise), far-voxel eviction and a
    StreamPublisher, on the 20 s run.  The first `n_warm_frames` frames
    after filter init run serially, the rest through the feeder thread
    and are timed; stage timers synchronize throughout.  The launch
    counters are set to 0 just before the run and read just after it.
    Returns the phase's record and the Captures of the backend's two
    association shapes."""
    import tempfile

    from sr_livo_tpu_torch.parallel.backend import (BackendConfig,
                                                    MappingBackend)
    from sr_livo_tpu_torch.runtime.streaming import (StreamPublisher,
                                                     read_live_trajectory)
    cfg.enable_map_eviction = True
    with tempfile.TemporaryDirectory() as out_dir:
        plane_fit.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with cuda_knn_calls() as knn_calls, \
                Capture("knn_plane_assoc", _is_ba) as cap_ba, \
                Capture("knn_plane_assoc", _is_loop) as cap_loop:
            backend = MappingBackend(BackendConfig(feedback_to_filter=True),
                                     device="cuda")
            backend_launches = dict.fromkeys(plane_fit.launches, 0)
            add_keyframe = backend.maybe_add_keyframe

            def counted_add_keyframe(*args):
                # every association of the backend runs in this call
                before = dict(plane_fit.launches)
                add_keyframe(*args)
                for k in backend_launches:
                    backend_launches[k] += plane_fit.launches[k] - before[k]
            backend.maybe_add_keyframe = counted_add_keyframe
            stream = StreamPublisher(out_dir)
            vision = VisionModule(cfg, device="cuda")
            pipe = LivoPipeline(cfg, vision=vision, backend=backend,
                                stream=stream, device="cuda")
            pipe.timers = StageTimers(sync=True, device=pipe.device)
            meas = cut_all(pipe, sim)
            i = 0
            while i < len(meas) and (not pipe.initialized
                                     or pipe.index_frame <= n_warm_frames):
                pipe._process_measurement(meas[i])
                i += 1
            n0 = pipe.index_frame
            t0 = time.perf_counter()
            pipe.process_measurements(meas[i:])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            n_timed = pipe.index_frame - n0
            stream.close()
            t1 = time.perf_counter()
            times, t_opt, _ = backend.optimized_trajectory()
            solve_ms = (time.perf_counter() - t1) * 1e3
        launches = dict(plane_fit.launches)
        peak = torch.cuda.max_memory_allocated()
        frames = len(pipe.records)
        lines = read_live_trajectory(out_dir)
        n_chunks = len(os.listdir(os.path.join(out_dir, "color_chunks")))
        with open(os.path.join(out_dir, "path_live.txt")) as f:
            n_path = len(f.read().splitlines())
    checks = livo_checks(pipe, vision, sim)
    ate_opt = tum.ate_rmse(times, t_opt, sim.gt_times, sim.gt_pos, align=True)
    expected_backend = 2 * backend.ba_runs + 9 * backend.n_verified
    stages = pipe.timers.report()
    compact = compact_cpu_vs_card(pipe.voxel_map, pipe.state.p, 6.0,
                                  cfg.shapes.map_max_probe)
    out = {"phase": "longrun", "measurements": len(meas), "frames": frames,
           "timed_frames": n_timed, "timed_seconds": seconds,
           "sweeps_images_per_s": n_timed / seconds,
           "keyframes": len(backend.keyframes), "edges": len(backend.edges),
           "ba_runs": backend.ba_runs,
           "verified_candidates": backend.n_verified,
           "loop_closures": backend.n_loop_closures,
           "feedback_events": backend.n_feedback_applied,
           "map_rebuilds": backend.n_map_rebuilds,
           "eviction_calls": stages["evict"]["count"],
           "eviction_dropped_voxels": (int(pipe._evict_dropped)
                                       if pipe._evict_dropped is not None
                                       else None),
           "stream_lines": len(lines[0]), "stream_path_lines": n_path,
           "stream_chunks": n_chunks, "stream_error": repr(stream.last_error),
           "backend_ms": {k: stages["backend"][k]
                          for k in ("mean_ms", "max_ms", "count")},
           "stages_ms": {k: v["mean_ms"] for k, v in stages.items()},
           "pose_graph_solve_ms": solve_ms,
           "pose_graph_pcg": pcg_solve_ms(),
           "peak_memory_bytes": peak,
           "ate_optimized_m": ate_opt, **checks,
           "launches": launches, "launches_backend": backend_launches,
           "plain_knn_calls_on_cuda": knn_calls.n,
           "compact_map_card_vs_cpu": compact}
    emit(out)
    bad = vision_bar_failures(checks)
    if not (ate_opt < 0.08 and ate_opt < max(2.5 * checks["ate_m"], 0.05)):
        bad.append(f"optimized ATE {ate_opt} m (odometry {checks['ate_m']})")
    if backend.ba_runs < 1 or len(backend.edges) < len(backend.keyframes) - 1:
        bad.append(f"{backend.ba_runs} BA runs, {len(backend.edges)} edges "
                   f"for {len(backend.keyframes)} keyframes")
    if len(lines[0]) != frames or stream.last_error is not None:
        bad.append(f"odometry_live.txt has {len(lines[0])} lines for "
                   f"{frames} frames ({stream.last_error!r})")
    n_backend = backend_launches["knn_plane_assoc"]
    if n_backend != expected_backend:
        bad.append(f"the backend launched knn_plane_assoc {n_backend} times,"
                   f" expected 2 x {backend.ba_runs} BA runs + 9 x "
                   f"{backend.n_verified} verified = {expected_backend}")
    if launches["knn_plane_assoc"] - n_backend != frames:
        bad.append(f"the frontend launched knn_plane_assoc "
                   f"{launches['knn_plane_assoc'] - n_backend} times in "
                   f"{frames} frames")
    others = {k: v for k, v in launches.items()
              if k != "knn_plane_assoc" and v}
    if others or knn_calls.n:
        bad.append(f"the long-run path launched {others} and called the "
                   f"plain kNN {knn_calls.n} times on CUDA")
    if cap_ba.args is None or (backend.n_verified and cap_loop.args is None):
        bad.append("a backend association shape was not captured")
    if bad:
        raise AssertionError("longrun phase: " + "; ".join(bad))
    return out, {"ba": cap_ba, "loop": cap_loop}


# The backend's two association shapes: the neighbour gate of the caller
# (parallel/ba.py, parallel/loop_closure.py), the least share of the rows
# that must pass it and the least number of rows on which a2d is held
# (below).  The BA probes a 1.0 m-keyed map at 0.6 m, so few of its rows
# find 8 neighbours.
BACKEND_SHAPES = {"ba": dict(min_neighbors=8, min_share=0.1,
                             min_a2d_rows=100),
                  "loop": dict(min_neighbors=6, min_share=0.25,
                               min_a2d_rows=100)}

# a2d = (s2 - s3) / s1 with s_i the square roots of the scatter's
# eigenvalues.  Where the smallest eigenvalue l3 nears float32 rounding
# (a thin or collinear neighbourhood), s3 and so a2d differ between any
# two float32 summation orders by about c / sqrt(l3 / l1): at the BA
# shape on an H100, up to 1.6e-3 where l3 / l1 < 1e-5, 2.6e-4 below
# 1e-4, 1.2e-4 below 1e-3 and 3.2e-5 below 1e-2.  So a2d is held only on
# rows with l3 >= FLAT_FLOOR * l1 (in float64; a patch at least 3% as
# thick as it is wide), the normal on all.  `a2d_by_floor` prints the
# difference at each floor.
FLAT_FLOOR = 1e-3


def flatness(vmap, world, thr, kw) -> torch.Tensor:
    """(Q,) smallest over largest eigenvalue of each row's neighbour
    scatter, in float64 on the CPU, from the plain kNN's neighbours."""
    nbr, ok, _ = vm.knn(vmap, world, threshold_capacity=thr,
                        **_search_kw(kw))
    m = ok.double().cpu()[..., None]
    x = nbr.double().cpu()
    bary = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    c = (x - bary[:, None]) * m
    lam = torch.linalg.eigvalsh(torch.einsum("qmi,qmj->qij", c, c))
    return (lam[:, 0] / lam[:, 2].clamp(min=1e-300)).to(world.device)


def backend_fused_phase(captures: dict) -> dict:
    """`knn_plane_assoc` against its plain version at the backend's two
    association shapes captured in the longrun run (every row associated),
    timed like the frontend's."""
    cuda = torch.device("cuda")
    results = {}
    for name, bars in BACKEND_SHAPES.items():
        if captures[name].args is None:
            continue
        vmap, (world, valid, thr), kw = captures[name].args_on(cuda)
        pair = fused_assoc_pair(vmap, world, valid, thr, kw)
        rows = pair[4] >= bars["min_neighbors"]
        flat = flatness(vmap, world, thr, kw)[:rows.shape[0]]
        firm = rows & (flat >= FLAT_FLOOR)
        res = results[name] = {
            "q": world.shape[0], "m": kw["max_neighbors"],
            "voxel_size": kw["voxel_size"],
            "map_capacity": vmap.counts.shape[0],
            "rows_with_enough_neighbours": int(rows.sum()),
            "rows_a2d_held": int(firm.sum()),
            # rows and a2d difference at and above each floor
            "a2d_by_floor": {
                f: [int((rows & (flat >= f)).sum()),
                    _max_abs(pair[1][rows & (flat >= f)],
                             pair[3][rows & (flat >= f)])]
                for f in (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2)}}
        res["max_abs_err"] = hold_assoc(
            kw, pair, rows, firm,
            math.ceil(bars["min_share"] * rows.shape[0]))
        if res["rows_a2d_held"] < bars["min_a2d_rows"]:
            raise AssertionError(f"knn_plane_assoc {kw}: a2d held on only "
                                 f"{res['rows_a2d_held']} rows")
        res["ms"] = graph_ms(lambda: plane_fit.knn_plane_assoc_cuda(
            vmap, world, valid, thr, **kw))
        res["call_ms"] = time_ms(lambda: plane_fit.knn_plane_assoc_cuda(
            vmap, world, valid, thr, **kw))
        res["plain_ms"] = time_ms(lambda: plane_fit.knn_plane_assoc_plain(
            vmap, world, valid, thr, **kw), iters=30, warmup=3)
        res["bound_ms"], res["bound_by"] = fused_bound_ms(
            vmap, world, valid, thr, kw, "knn_plane_assoc")
    return results


# ---------------------------------------------------------------------------
# Phase 9: checkpoint and resume
# ---------------------------------------------------------------------------

def feed_window(pipe: LivoPipeline, sim, t_lo: float, t_hi: float) -> None:
    """Push the sensor events stamped in [t_lo, t_hi) in time order and
    process what the cutter can cut (tests/test_checkpoint.py::_feed)."""
    events = [(t, "imu", (t, a, g)) for (t, a, g) in sim.imu]
    events += [(c[-1, 3], "pts", c) for c in sim.lidar_chunks if c.shape[0]]
    events += [(t, "img", (t, im)) for (t, im) in sim.images]
    events.sort(key=lambda e: (e[0], e[1]))
    for (t, kind, payload) in events:
        if not t_lo <= t < t_hi:
            continue
        if kind == "imu":
            pipe.push_imu(*payload)
        elif kind == "pts":
            pipe.push_points(payload)
        else:
            pipe.push_image(*payload)
    pipe.process_available()


def resume_phase(sim, cfg: LivoConfig, t_ckpt: float = 5.0,
                 t_end: float = 10.0) -> dict:
    """bench.py's LIVO configuration on the first `t_end` s of the run,
    uninterrupted, then checkpointed at `t_ckpt` and resumed in a fresh
    pipeline.  Bars: the same frames, positions within 5e-3 m
    (tests/test_checkpoint.py:82), and the resumed colored map holding
    the checkpointed one's colored points."""
    import tempfile

    def pipeline():
        return LivoPipeline(cfg, vision=VisionModule(cfg, device="cuda"),
                            device="cuda")

    def colored(p):
        cmap = p.vision.color_map
        return int((cmap.reg_valid & (cmap.n_rgb >= 3)).sum())

    base = pipeline()
    feed_window(base, sim, 0.0, t_end)
    first = pipeline()
    feed_window(first, sim, 0.0, t_ckpt)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first.save_checkpoint(path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        resumed = pipeline()
        t0 = time.perf_counter()
        resumed.load_checkpoint(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    col_first, col_resumed = colored(first), colored(resumed)
    feed_window(resumed, sim, t_ckpt, t_end)
    tb, pb, _ = base.trajectory()
    tr, pr, _ = resumed.trajectory()
    gap = (float(np.linalg.norm(pr - pb, axis=-1).max())
           if len(tr) == len(tb) else None)
    out = {"phase": "resume", "frames": len(tb), "resumed_frames": len(tr),
           "frames_at_checkpoint": len(first.records),
           "max_position_gap_m": gap, "checkpoint_bytes": nbytes,
           "save_s": save_s, "load_s": load_s,
           "colored_points_at_checkpoint": col_first,
           "colored_points_resumed": col_resumed}
    emit(out)
    if (len(tr) != len(tb) or not np.array_equal(tr, tb) or not gap < 5e-3
            or col_first != col_resumed or len(first.records) < 10):
        raise AssertionError(f"resume phase: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 10: a recorded bag replayed through the real-data entry point
# ---------------------------------------------------------------------------

# The r3live profile of scripts/accuracy_gate.py (:111-119, own copy): the
# published calibration of the R3Live sequences (configs/r3live.yaml),
# images at image_scale 0.5 (1024 x 1280 -> 512 x 640) with the lens
# distortion, the camera-IMU extrinsic and a 6 ms camera time offset.
R3_TOPICS = ("/livox/lidar", "/livox/imu", "/camera/image_color")
R3_INTR_FULL = (863.4241, 863.4171, 640.6808, 518.3392)
R3_DIST = [-0.1080, 0.1050, -1.2872e-04, 5.7923e-05, -0.0222]
R3_R_IC = [-0.00113207, -0.0158688, 0.999873,
           -0.9999999, -0.000486594, -0.00113994,
           0.000504622, -0.999874, -0.0158682]
R3_T_IC = [0.050166, 0.0474116, -0.0312415]
R3_SIZE = (512, 640)
R3_TIME_OFFSET = 0.006
# The gate's per-seed ATE bound, registration share and --quick track bar
# (accuracy_gate.py:454-509).
REPLAY_MAX_ATE = 0.08
REPLAY_MIN_REGISTERED = 0.95
REPLAY_MIN_TRACKS = 60.0


class DeviceWorld(synthetic.SyntheticWorld):
    """A world whose LiDAR rays are cast on `device` in float64
    (`raycast_torch`), as the gate casts them on the accelerator when it
    prebuilds its bags (accuracy_gate.py:66-77): the numpy raycast takes
    about 0.2 s per 17600-ray sweep over this world's 142 rectangles."""

    def __init__(self, rects, device):
        super().__init__(rects)
        self.device = device

    def raycast(self, origins, dirs):
        f = dict(dtype=torch.float64, device=self.device)
        pts, hit = self.raycast_torch(torch.as_tensor(origins, **f),
                                      torch.as_tensor(dirs, **f))
        return pts.cpu().numpy(), hit.cpu().numpy(), None


def r3live_bag(path: str, duration: float, seed: int, device="cuda",
               images: bool = True):
    """The gate's r3live bag (accuracy_gate.py:132-206): its world, the
    `standard` trajectory, a Livox cone of 160 x 110 directions at 10 Hz,
    IMU at 200 Hz and distorted 512 x 640 RGB8 images at 10 Hz, rays cast
    on `device`, written uncompressed with tests/rosbag_writer.py.  With
    `images=False` the images are 8 x 8 and black: they carry only their
    stamps, which cut the sweeps.  Returns (sim, seconds to simulate,
    seconds to write, message counts)."""
    from tests import rosbag_writer as rbw

    world = DeviceWorld(synthetic.make_room(
        half=12.0, height=4.0, boxes=20, seed=7, clear_radius=3.6,
        panels=36), device)
    traj = synthetic.Trajectory(amp=(1.6, 1.6, 0.2), freq=(0.22, 0.15, 0.35),
                                yaw_amp=0.7, yaw_freq=0.25, rp_amp=0.06,
                                start_still=4.5)
    t0 = time.perf_counter()
    sim = synthetic.simulate(
        duration=duration, sweep_rate=10.0, image_rate=10.0,
        image_size=R3_SIZE if images else (0, 0),
        camera=tuple(np.asarray(R3_INTR_FULL) * 0.5),
        dist_coeffs=R3_DIST, r_ic=np.asarray(R3_R_IC).reshape(3, 3),
        t_ic=np.asarray(R3_T_IC), cam_time_offset=R3_TIME_OFFSET, seed=seed,
        traj=traj, world=world,
        dirs_phase=synthetic.lidar_directions_livox(160, 110), device=device)
    simulate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w = rbw.BagWriter(path)
    for (t, acc, gyr) in sim.imu:
        w.write_message(R3_TOPICS[1], "sensor_msgs/Imu", t,
                        rbw.ser_imu(t, acc, gyr))
    n_lidar = 0
    for chunk in sim.lidar_chunks:
        if chunk.shape[0] == 0:
            continue
        stamp = float(chunk[0, 3])
        off_ns = np.round((chunk[:, 3] - stamp) * 1e9).astype(np.uint32)
        n = chunk.shape[0]
        w.write_message(R3_TOPICS[0], "livox_ros_driver/CustomMsg", stamp,
                        rbw.ser_livox_custom(
                            stamp, chunk[:, :3].astype(np.float32),
                            np.zeros(n, np.uint8),
                            (np.arange(n) % 6).astype(np.uint8), off_ns))
        n_lidar += 1
    for (t, img) in sim.images:
        u8 = (np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
              if images else np.zeros((8, 8, 3), np.uint8))
        w.write_message(R3_TOPICS[2], "sensor_msgs/Image", t,
                        rbw.ser_image_rgb8(t, u8))
    w.close()
    counts = {"imu": len(sim.imu), "lidar": n_lidar,
              "image": len(sim.images)}
    return sim, simulate_s, time.perf_counter() - t0, counts


def r3live_cfg() -> LivoConfig:
    """configs/r3live.yaml (read as data) with the gate's shape overrides
    (accuracy_gate.py:260-277) and retry_wider_neighborhood (:294)."""
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "configs", "r3live.yaml"))
    sh = cfg.shapes
    sh.max_sweep_points = 8192
    sh.max_frame_points = 4096
    sh.max_keypoints = 1024
    sh.max_imu_samples = 48
    sh.map_capacity = 1 << 17
    sh.color_capacity = 1 << 17
    sh.color_registry = 1 << 18
    sh.max_render_points = 1 << 13
    cfg.adaptive_keypoint_density = True
    cfg.cache_association = True
    cfg.wire_quantization = True
    cfg.retry_wider_neighborhood = True
    return cfg


class HostTimes(Spy):
    """Within the block, host milliseconds and calls per message class of
    a bag replay: the bag read (each message pulled from the native
    reader), the parsers, the Livox driver, the native wire pack and the
    native host remap.  Each is timed by wrapping the module attribute the
    replay calls; every call is passed on."""

    def __init__(self):
        super().__init__(
            (drivers, "parse_imu", "parse_imu"),
            (drivers, "parse_livox_custom", "parse_livox"),
            (drivers, "parse_image", "parse_image"),
            (drivers.CloudProcessing, "process_livox", "driver_livox"),
            (native, "prepare_pack", "prepare_pack"),
            (native, "remap_u8", "remap"))

    def __enter__(self):
        super().__enter__()
        times, base = self, native.BagReader

        class TimedReader(base):
            def __iter__(self):
                it = base.__iter__(self)
                while True:
                    t0 = time.perf_counter()
                    msg = next(it, None)
                    times.add("bag_read", time.perf_counter() - t0)
                    if msg is None:
                        return
                    yield msg
        self.patch(native, "BagReader", TimedReader)
        return self


def replay_phase(duration: float = 20.0, seed: int = 11,
                 device="cuda") -> dict:
    """The r3live-profile bag (`r3live_bag`) replayed through
    `drivers.replay_bag` into LivoPipeline with a VisionModule on
    `device`, with the launch counters set to 0 just before the replay and
    read just after.  Prints the gate's record (frames, registered share,
    rendered and gap-fill frames, ATE, mean LK-surviving tracks and the
    30-track gate share after the 5th rendered frame), the replay's wall
    time and sweeps+images/s, and the host ms per message class.  Fails
    at an ATE of 0.08 m or more, a registered share below 0.95, mean
    tracks below 60, `knn_plane_assoc` launches other than the IEKF
    updates (one per frame, and one more for each frame whose weak solve
    `retry_wider_neighborhood` re-runs over the widened neighbourhood),
    any other entry or a plain kNN call on CUDA."""
    import tempfile

    cfg = r3live_cfg()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "r3live.bag")
        sim, simulate_s, write_s, counts = r3live_bag(path, duration, seed,
                                                      device)
        bag_bytes = os.path.getsize(path)
        vision = VisionModule(cfg, device=device)
        pipe = LivoPipeline(cfg, vision=vision, device=device)
        on_cuda = pipe.device.type == "cuda"
        if on_cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        plane_fit.reset_launches()
        with cuda_knn_calls() as knn_calls, HostTimes() as host, \
                Spy((lio, "iekf_update", "iekf_update")) as updates:
            t0 = time.perf_counter()
            drivers.replay_bag(pipe, path, cfg, *R3_TOPICS,
                               image_type=drivers.IMAGE_TYPE_RGB8)
            if on_cuda:
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        launches = dict(plane_fit.launches)

    recs = pipe.records
    ts, ps, _ = pipe.trajectory()
    ate = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
    n_ok = sum(r.success for r in recs)
    eng = [s[1] for s in vision.stats[5:]]
    out = {"phase": "replay", "profile": "r3live", "duration_s": duration,
           "seed": seed, "bag_messages": counts, "bag_bytes": bag_bytes,
           "simulate_s": simulate_s, "bag_write_s": write_s,
           "frames": len(recs), "registered": n_ok,
           "registered_share": n_ok / max(len(recs), 1),
           "rendered_frames": sum(r.rendering for r in recs),
           "gap_fill_frames": sum(not r.rendering for r in recs),
           "ate_m": ate,
           "mean_tracks": float(np.mean(eng)) if eng else 0.0,
           "track_gate_share": (float(np.mean([e >= 30 for e in eng]))
                                if eng else 0.0),
           "replay_wall_s": wall_s,
           "sweeps_images_per_s": len(recs) / wall_s,
           "host_ms": host.ms, "host_calls": host.calls,
           "host_ms_per_call": {k: host.ms[k] / max(host.calls[k], 1)
                                for k in host.ms},
           "iekf_updates": updates.n,
           "retried_frames": updates.n - len(recs),
           "launches": launches, "plain_knn_calls_on_cuda": knn_calls.n,
           "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                 if on_cuda else None)}
    emit(out)
    bad = []
    if not ate < REPLAY_MAX_ATE:
        bad.append(f"ATE {ate} m")
    if not out["registered_share"] >= REPLAY_MIN_REGISTERED:
        bad.append(f"registered share {out['registered_share']}")
    if not out["mean_tracks"] >= REPLAY_MIN_TRACKS:
        bad.append(f"mean tracks {out['mean_tracks']}")
    if not pipe.initialized or len(recs) < 5 * duration:
        bad.append(f"{len(recs)} frames")
    if not len(recs) <= updates.n <= 2 * len(recs):
        bad.append(f"{updates.n} IEKF updates in {len(recs)} frames")
    if on_cuda:
        if launches["knn_plane_assoc"] != updates.n:
            bad.append(f"knn_plane_assoc launched "
                       f"{launches['knn_plane_assoc']} times in "
                       f"{updates.n} IEKF updates")
        others = {k: v for k, v in launches.items()
                  if k != "knn_plane_assoc" and v}
        if others or knn_calls.n:
            bad.append(f"the replay launched {others} and called the plain "
                       f"kNN {knn_calls.n} times on CUDA")
    if bad:
        raise AssertionError("replay phase: " + "; ".join(bad))
    return out


def demo_phase(device: str = "cuda", duration: float = 10.0) -> dict:
    """`python -m sr_livo_tpu_torch.runtime.demo --vision` in a
    subprocess: exit 0 and pose.txt written."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "sr_livo_tpu_torch.runtime.demo",
               "--device", device, "--duration", f"{duration:g}",
               "--vision", "--out", d]
        t0 = time.perf_counter()
        proc = subprocess.run(
            cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        pose = os.path.join(d, "pose.txt")
        pose_lines = (len(open(pose).read().splitlines())
                      if os.path.exists(pose) else 0)
    out = {"phase": "demo", "command": " ".join(cmd[1:]),
           "returncode": proc.returncode, "seconds": seconds,
           "pose_lines": pose_lines,
           "report": [ln for ln in proc.stdout.splitlines()
                      if ln.startswith("[demo]")]}
    emit(out)
    if proc.returncode != 0 or pose_lines == 0:
        raise AssertionError(f"demo phase: exit {proc.returncode}, "
                             f"{pose_lines} pose lines\n"
                             f"{proc.stderr[-3000:]}")
    return out


# ---------------------------------------------------------------------------
# Phase 6b: the map-sharded engine
# ---------------------------------------------------------------------------

SHARDED_RANKS = 2
BA_KEYFRAMES, BA_POINTS, BA_ITERS, BA_STRIDE = 8, 512, 3, 10
# tests/test_sharded_lio.py:104-107: the sharded engine against the
# single-device one
SHARDED_POS = 2e-3
SHARDED_QUAT = 1e-4


def record_single_run(sim, cfg: LivoConfig) -> tuple:
    """The single-device LIO pipeline over the run, recording what each
    `LioEngine.step` got (the first state, every sweep with its frame id
    and gyro rate) and its host seconds, synchronised on both sides.
    Returns (pipeline, log)."""
    pipe = LivoPipeline(cfg, device="cuda")
    meas = cut_all(pipe, sim)
    log = {"first_state": None, "sweeps": [], "frame_ids": [], "gyr": [],
           "seconds": []}
    orig = pipe.engine.step

    def step(state, vmap, sweep, frame_id, prev_poses=None, gyr_rate=0.0,
             timers=None):
        if log["first_state"] is None:
            log["first_state"] = eskf_mod.map_state(torch.clone, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(state, vmap, sweep, frame_id, prev_poses=prev_poses,
                   gyr_rate=gyr_rate, timers=timers)
        torch.cuda.synchronize()
        log["seconds"].append(time.perf_counter() - t0)
        log["sweeps"].append(sweep)
        log["frame_ids"].append(frame_id)
        log["gyr"].append(gyr_rate)
        return out
    pipe.engine.step = step
    pipe.process_measurements(meas)
    return pipe, log


def run_sharded(eng, log, capture_at=None, keep=()) -> dict:
    """`eng.step` over the logged sweeps from the logged first state, with
    the launch counters set to 0 just before and read just after; the
    `knn_plane_assoc` call of step `capture_at` is captured and the
    registered frames of the steps in `keep` are kept."""
    state, vmap = log["first_state"], eng.make_map()
    recs, overflow, seconds, kept = [], [], [], {}
    digest = hashlib.sha1()
    cap = Capture("knn_plane_assoc")
    plane_fit.reset_launches()
    with cuda_knn_calls() as knn_calls, \
            Spy((sharded_lio.ShardedLioEngine, "_iekf", "updates")) as upd:
        for i, (sweep, fid, gyr) in enumerate(zip(
                log["sweeps"], log["frame_ids"], log["gyr"])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == capture_at:
                with cap:
                    out = eng.step(state, vmap, sweep, fid, gyr)
            else:
                out = eng.step(state, vmap, sweep, fid, gyr)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            state, vmap = out.state, out.voxel_map
            recs.append(out.record)
            overflow.append(out.route_overflow)
            for t in (out.frame_pts_world, out.frame_valid, out.inserted):
                digest.update(t.cpu().numpy().tobytes())
            if i in keep:
                kept[i] = (out.frame_pts_world, out.frame_valid,
                           out.state.q, out.state.p)
    return {"records": torch.stack(recs).cpu().numpy(),
            "overflow": torch.stack(overflow).cpu().numpy(),
            "seconds": np.array(seconds), "state": state, "map": vmap,
            "map_size": int(eng.map_size(vmap)),
            "launches": dict(plane_fit.launches),
            "plain_knn_calls_on_cuda": knn_calls.n,
            "iekf_updates": upd.calls.get("updates", 0),
            "frames_digest": digest.hexdigest(), "kept": kept,
            "capture": cap.args}


def sweeps_per_s(seconds, n_warm: int) -> float:
    return (len(seconds) - n_warm) / float(np.sum(seconds[n_warm:]))


def check_sharded(name: str, run: dict, ref: np.ndarray,
                  single_size: int) -> dict:
    """The sharded run against the single-device records `ref` (rows of
    pack_record): positions and quaternions within the bars of
    tests/test_sharded_lio.py, success on every frame, the owned map
    size, no routing overflow, `knn_plane_assoc` once per IEKF update and
    no other entry or plain kNN on the card."""
    rec = run["records"]
    gap_p = float(np.abs(rec[:, 0:3] - ref[:, 0:3]).max())
    gap_q = float(np.abs(rec[:, 3:7] - ref[:, 3:7]).max())
    same_success = bool(np.array_equal(rec[:, 16] > 0.5, ref[:, 16] > 0.5))
    launches = run["launches"]
    others = {k: v for k, v in launches.items()
              if k != "knn_plane_assoc" and v}
    updates = run["iekf_updates"]
    out = {"frames": len(rec), "position_gap_m": gap_p,
           "quaternion_gap": gap_q, "success_equal": same_success,
           "map_size": run["map_size"], "single_map_size": single_size,
           "route_overflow": int(run["overflow"].sum()),
           "iekf_updates": updates, "launches": launches,
           "plain_knn_calls_on_cuda": run["plain_knn_calls_on_cuda"]}
    fails = []
    if gap_p > SHARDED_POS or gap_q > SHARDED_QUAT:
        fails.append(f"trajectory gap {gap_p} m / {gap_q}")
    if not same_success:
        fails.append("success differs")
    if run["map_size"] != single_size:
        fails.append(f"map_size {run['map_size']} != {single_size}")
    if out["route_overflow"]:
        fails.append(f"route_overflow {out['route_overflow']}")
    if launches["knn_plane_assoc"] != updates or updates < len(rec):
        fails.append(f"knn_plane_assoc launched {launches['knn_plane_assoc']}"
                     f" times for {updates} IEKF updates")
    if others or run["plain_knn_calls_on_cuda"]:
        fails.append(f"launched {others}, plain kNN "
                     f"{run['plain_knn_calls_on_cuda']} times on the card")
    if fails:
        raise AssertionError(f"sharded {name}: " + "; ".join(fails))
    return out


def ba_window(kept: dict):
    """8 keyframes of 512 registered points each (a seeded choice of the
    frame's valid points), in the body frame of the keyframe's pose, with
    the odometry between consecutive keyframes from the same poses."""
    if len(kept) != BA_KEYFRAMES:
        raise AssertionError(f"{len(kept)} keyframes kept, want "
                             f"{BA_KEYFRAMES}: the run is too short")
    rng = np.random.RandomState(7)
    qs, ts, pts = [], [], []
    for i in sorted(kept):
        world, valid, q, p = kept[i]
        idx = np.sort(rng.choice(np.nonzero(valid.cpu().numpy())[0],
                                 BA_POINTS, replace=False))
        w = world[torch.as_tensor(idx, device=world.device)]
        pts.append((w - p) @ lie.quat_to_rot(q))     # R^T (w - p)
        qs.append(q)
        ts.append(p)
    q, t = torch.stack(qs), torch.stack(ts)
    dev = q.device
    q_odo, t_odo = zip(*(pose_graph.edge_from_poses(q[k], t[k], q[k + 1],
                                                    t[k + 1])
                         for k in range(len(qs) - 1)))
    window = pba.KeyframeWindow(
        q=q, t=t, points=torch.stack(pts).contiguous(),
        pt_valid=torch.ones((len(qs), BA_POINTS), dtype=torch.bool,
                            device=dev),
        kf_valid=torch.ones((len(qs),), dtype=torch.bool, device=dev))
    return window, torch.stack(q_odo), torch.stack(t_odo)


def world_of_one(log, cfg, ref, single_map, single_p, n_warm,
                 workdir) -> tuple:
    """(a) The sharded engine as a world of one over NCCL (so the
    collectives really run through NCCL), then `compact` and one sharded
    windowed-BA solve on its final map."""
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(workdir, "store1"), 1),
        rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(device="cuda")
        eng = sharded_lio.ShardedLioEngine(cfg, mesh)
        n = len(log["sweeps"])
        keep = range(n - 1 - (BA_KEYFRAMES - 1) * BA_STRIDE, n, BA_STRIDE)
        run = run_sharded(eng, log, keep=set(keep))
        out = check_sharded("world of one", run, ref,
                            int(vm.map_size(single_map)))
        out.update(backend=dist.get_backend(), ranks=1,
                   sweeps_per_s=sweeps_per_s(run["seconds"], n_warm))
        # compact at max_distance from the single-device final position
        m2, dropped = eng.compact(run["map"], single_p)
        single_compact = int(vm.map_size(vm.compact_map(
            single_map, single_p,
            distance=cfg.odometry_options.max_distance,
            max_probe=cfg.shapes.map_max_probe)[0]))
        out["compact"] = {"dropped": int(dropped),
                          "map_size": int(eng.map_size(m2)),
                          "single_map_size": single_compact}
        del m2
        if out["compact"]["dropped"] or (out["compact"]["map_size"]
                                         != single_compact):
            raise AssertionError(f"sharded compact: {out['compact']}")
        # one sharded windowed-BA solve on the final map
        window, q_odo, t_odo = ba_window(run["kept"])
        fn = pba.make_sharded_windowed_ba(
            mesh, BA_KEYFRAMES, voxel_size=cfg.icp.size_voxel_map,
            max_probe=cfg.shapes.map_max_probe, iters=BA_ITERS,
            block_bits=cfg.shapes.map_block_bits)
        plane_fit.reset_launches()
        cap = Capture("knn_plane_assoc")
        with cap:
            q_ba, t_ba, ovf = fn(run["map"], window, q_odo, t_odo)
        torch.cuda.synchronize()
        ba = {"keyframes": BA_KEYFRAMES, "points": BA_POINTS,
              "iters": BA_ITERS, "route_overflow": int(ovf),
              "launches": plane_fit.launches["knn_plane_assoc"],
              "max_shift_m": float((t_ba - window.t).norm(dim=-1).max()),
              "finite": bool(torch.isfinite(q_ba).all()
                             and torch.isfinite(t_ba).all())}
        out["ba"] = ba
        if ba["route_overflow"] or not ba["finite"] or (
                ba["launches"] != BA_ITERS):
            raise AssertionError(f"sharded BA: {ba}")
        return out, run, cap
    finally:
        dist.destroy_process_group()


def save_log(log, cfg: LivoConfig, path: str, n_warm: int) -> None:
    torch.save({"cfg": cfg, "first_state": log["first_state"]._asdict(),
                "sweeps": [(type(s).__name__, tuple(s))
                           for s in log["sweeps"]],
                "frame_ids": log["frame_ids"], "gyr": log["gyr"],
                "n_warm": n_warm}, path)


def sharded_rank_main(rank: int, workdir: str) -> int:
    """One rank of (b), in a process of its own: two ranks share one card
    over gloo (NCCL refuses two ranks on one card)."""
    from sr_livo_tpu_torch.models.eskf import EskfState
    from sr_livo_tpu_torch.models.odometry import SweepInput, WireSweep

    device = torch.device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store2"),
                                     SHARDED_RANKS),
        rank=rank, world_size=SHARDED_RANKS)
    try:
        inp = torch.load(os.path.join(workdir, "sweeps.pt"),
                         map_location=device, weights_only=False)
        kinds = {"WireSweep": WireSweep, "SweepInput": SweepInput}
        log = {"first_state": EskfState(**inp["first_state"]),
               "sweeps": [kinds[k](*f) for k, f in inp["sweeps"]],
               "frame_ids": inp["frame_ids"], "gyr": inp["gyr"]}
        eng = sharded_lio.ShardedLioEngine(inp["cfg"],
                                           pmesh.make_mesh(device=device))
        run = run_sharded(eng, log,
                          capture_at=inp["n_warm"] if rank == 0 else None)
        keys = ("records", "overflow", "seconds", "map_size", "launches",
                "plain_knn_calls_on_cuda", "iekf_updates", "frames_digest",
                "capture")
        res = {k: run[k] for k in keys}
        res["state"] = {k: v.cpu() for k, v in run["state"]._asdict().items()}
        res["backend"] = dist.get_backend()
        torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def two_ranks(log, cfg, ref, single_size: int, n_warm: int,
              workdir: str) -> tuple:
    """(b) Two ranks on one card over gloo, in two processes of this
    script: every rank's replicated outputs the same bits, and the run
    against the single-device one as in (a)."""
    save_log(log, cfg, os.path.join(workdir, "sweeps.pt"), n_warm)
    cmd = [sys.executable, os.path.abspath(__file__), "--sharded-dir",
           workdir, "--sharded-rank"]
    procs = [subprocess.Popen(cmd + [str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(SHARDED_RANKS)]
    t0 = time.perf_counter()
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"sharded rank {r} exited {p.returncode}:"
                                 f"\n{text[-4000:]}")
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(SHARDED_RANKS)]
    first = ranks[0]
    identical = all(
        np.array_equal(first["records"], r["records"])
        and np.array_equal(first["overflow"], r["overflow"])
        and first["frames_digest"] == r["frames_digest"]
        and first["map_size"] == r["map_size"]
        and all(torch.equal(v, r["state"][k])
                for k, v in first["state"].items())
        for r in ranks[1:])
    out = check_sharded("two ranks", first, ref, single_size)
    for r in ranks[1:]:
        check_sharded("two ranks", r, ref, single_size)
    out.update(backend=first["backend"], ranks=SHARDED_RANKS,
               replicated_bit_identical=identical, wall_seconds=wall,
               launches_per_rank=[r["launches"]["knn_plane_assoc"]
                                  for r in ranks],
               iekf_updates_per_rank=[r["iekf_updates"] for r in ranks],
               sweeps_per_s=sweeps_per_s(first["seconds"], n_warm))
    if not identical:
        raise AssertionError("the ranks' replicated outputs differ")
    return out, first["capture"]


def shard_shape(name: str, cap: "Capture", min_neighbors: int,
                flat_floor: bool) -> dict:
    """(c) `knn_plane_assoc` against its plain version at a shard shape
    (a captured map and rows), timed as the other shapes are; a2d held on
    the rows not flat to rounding (`FLAT_FLOOR`) where `flat_floor`."""
    vmap, (world, valid, thr), kw = cap.args_on(torch.device("cuda"))
    pair = fused_assoc_pair(vmap, world, valid, thr, kw)
    rows = pair[4] >= min_neighbors
    firm = rows & (flatness(vmap, world, thr, kw)[:rows.shape[0]]
                   >= FLAT_FLOOR) if flat_floor else rows
    res = {"shape": name, "q": world.shape[0], "m": kw["max_neighbors"],
           "n_valid": int(valid.sum()), "map_capacity": vmap.counts.shape[0],
           "rows_held": int(rows.sum()), "rows_a2d_held": int(firm.sum())}
    res["max_abs_err"] = hold_assoc(kw, pair, rows, firm,
                                    math.ceil(0.1 * rows.shape[0]))
    res["ms"] = graph_ms(lambda: plane_fit.knn_plane_assoc_cuda(
        vmap, world, valid, thr, **kw))
    res["call_ms"] = time_ms(lambda: plane_fit.knn_plane_assoc_cuda(
        vmap, world, valid, thr, **kw))
    res["plain_ms"] = time_ms(lambda: plane_fit.knn_plane_assoc_plain(
        vmap, world, valid, thr, **kw), iters=30, warmup=3)
    res["bound_ms"], res["bound_by"] = fused_bound_ms(
        vmap, world, valid, thr, kw, "knn_plane_assoc")
    return res


def sharded_phase(sim, cfg: LivoConfig, n_warm: int = 60) -> dict:
    """The map-sharded engine at bench.py's LIO shapes on the slice's run:
    (a) a world of one over NCCL against the single-device engine on the
    same sweeps, with `compact` and a sharded BA solve; (b) two ranks on
    the one card over gloo; (c) the kernel against its plain version at
    the two shard shapes (the IEKF's K4 x 20 on a rank's local table,
    captured in (b); the BA's W x 20, captured in (a))."""
    import tempfile

    pipe, log = record_single_run(sim, cfg)
    ts, _, _ = pipe.trajectory()
    ref = np.stack([np.concatenate([
        r.position, r.quat_wxyz, r.velocity, r.ba, r.bg,
        [float(r.success), r.num_residuals, r.iterations]])
        for r in pipe.records])
    single_rate = sweeps_per_s(np.array(log["seconds"]), n_warm)
    with tempfile.TemporaryDirectory() as d:
        a, run, ba_cap = world_of_one(
            log, cfg, ref, pipe.voxel_map, pipe.state.p, n_warm, d)
        a["single_sweeps_per_s"] = single_rate
        a["ate_m"] = tum.ate_rmse(ts, run["records"][:, 0:3], sim.gt_times,
                                  sim.gt_pos, align=True)
        emit({"phase": "sharded", "part": "a", **a})
        if not a["ate_m"] < 0.05:
            raise AssertionError(f"sharded ATE RMSE {a['ate_m']} m")
        del run
        b, k4_args = two_ranks(log, cfg, ref,
                               int(vm.map_size(pipe.voxel_map)), n_warm, d)
        b["single_sweeps_per_s"] = single_rate
        emit({"phase": "sharded", "part": "b", **b})
    del pipe, log
    k4_cap = Capture("knn_plane_assoc")
    k4_cap.args = k4_args
    if k4_cap.args is None or ba_cap.args is None:
        raise AssertionError("no shard-shape association was captured")
    shapes = {"k4": shard_shape("iekf_k4", k4_cap,
                                cfg.icp.min_number_neighbors, False),
              "ba": shard_shape("ba_w", ba_cap, 8, True)}
    emit({"phase": "fused_vs_plain", "sharded": shapes})
    return {"a": a, "b": b, "shapes": shapes}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=["profile", "livo", "longrun",
                                           "resume", "replay", "sharded"],
                        help="run only the device and this phase")
    parser.add_argument("--sharded-rank", type=int,
                        help=argparse.SUPPRESS)   # a rank of phase sharded
    parser.add_argument("--sharded-dir", help=argparse.SUPPRESS)
    args = parser.parse_args()
    only = args.only
    if args.sharded_rank is not None:
        return sharded_rank_main(args.sharded_rank, args.sharded_dir)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if only == "replay":
        replay_phase()
        demo_phase()
        print(smi, flush=True)
        return 0
    if only in ("livo", "longrun", "resume"):
        lsim, render_ms = livo_sim()
        if only == "livo":
            livo_phase(lsim, render_ms, bench_livo_cfg())
        elif only == "longrun":
            caps = longrun_phase(lsim, bench_livo_cfg())[1]
            emit({"phase": "fused_vs_plain",
                  "backend": backend_fused_phase(caps)})
        else:
            resume_phase(lsim, bench_livo_cfg())
        print(smi, flush=True)
        return 0
    sim = synthetic.simulate(duration=20.0, n_azimuth=256, n_rings=32,
                             imu_rate=200.0, seed=3)
    if only == "profile":
        profile_phase(sim)
        print(smi, flush=True)
        return 0
    if only == "sharded":
        kernels.build("plane_fit")
        sharded_phase(sim, bench_lio_cfg(cache_association=True))
        print(smi, flush=True)
        return 0

    t0 = time.perf_counter()
    log = kernels.build("plane_fit")
    emit({"phase": "build", "source": KERNEL_SOURCE,
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    cfg = bench_lio_cfg(cache_association=True)
    results = kernel_phase(cfg)
    emit({"phase": "kernels_vs_plain", **results})

    runs, captures = {}, {}
    for cache in (False, True):
        runs[cache], cap = slice_phase(sim, cache)
        captures["knn_plane_assoc" if cache else "knn_plane_rows"] = cap
    results.update(fused_phase(captures, cfg.icp.min_number_neighbors))
    captures.clear()
    emit({"phase": "fused_vs_plain",
          **{k: results[k] for k in ("knn_plane_assoc", "knn_plane_rows")}})
    profile_phase(sim)
    sharded = sharded_phase(sim, bench_lio_cfg(cache_association=True))
    lsim, render_ms = livo_sim()
    livo = livo_phase(lsim, render_ms, bench_livo_cfg())
    longrun, caps = longrun_phase(lsim, bench_livo_cfg())
    backend = backend_fused_phase(caps)
    caps.clear()
    emit({"phase": "fused_vs_plain", "backend": backend})
    resume_phase(lsim, bench_livo_cfg())
    replay = replay_phase()
    demo_phase()

    summary = []
    for name, cache in (("knn_plane_assoc", True), ("knn_plane_rows", False),
                        ("plane_assoc", True), ("plane_rows", False)):
        r = results[name]
        summary.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES, "q": r["q"], "m": r["m"],
            "launches": runs[cache]["launches"][name],
            "launches_livo": livo["launches"][name],
            "launches_backend": longrun["launches_backend"][name],
            "launches_replay": replay["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    summary[0]["backend_shapes"] = backend
    summary[0]["launches_sharded"] = {
        "world_of_one_nccl": sharded["a"]["launches"]["knn_plane_assoc"],
        "two_ranks_gloo": sharded["b"]["launches_per_rank"],
        "ba": sharded["a"]["ba"]["launches"]}
    summary[0]["sharded_shapes"] = sharded["shapes"]
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
