#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sr_livo_tpu_torch`) on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only profile   # device + profile phases only

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
     busy share of the window.

Each entry's times: device ms per launch from CUDA-graph replay (`ms`),
one eager call of the kernel (`call_ms`) and of the plain version
(`plain_ms`) as the path makes them, and the least time the card could
take for the same work (`bound_ms`, by bytes or operations, counted from
this run's inputs).  Then it prints the `{"kernels": [...]}` summary, the
nvidia-smi line and, last, `{"ok": true, "device": {...}}`.  Any failed
phase raises and the script exits non-zero without that last line.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sr_livo_tpu_torch import kernels  # noqa: E402
from sr_livo_tpu_torch.config import LivoConfig  # noqa: E402
from sr_livo_tpu_torch.ops import plane_fit  # noqa: E402
from sr_livo_tpu_torch.ops import voxel_map as vm  # noqa: E402
from sr_livo_tpu_torch.pipeline import LivoPipeline  # noqa: E402
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
    `plane_fit` entry (a copy of the map and of the tensors, taken before
    the call, kept in host memory so that it does not count in the run's
    peak device memory) and passes every call on.  `args_on(device)`
    returns the record on a device."""

    def __init__(self, name: str):
        self.name, self.orig, self.args = name, getattr(plane_fit, name), None

    def __enter__(self):
        def spy(vmap, *args, **kw):
            if self.args is None:
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


class CudaKnnCalls:
    """Within the block, counts calls of the plain kNN
    (`voxel_map.knn`) on CUDA tensors."""

    def __init__(self):
        self.orig, self.n = vm.knn, 0

    def __enter__(self):
        def spy(vmap, queries, **kw):
            self.n += int(queries.is_cuda)
            return self.orig(vmap, queries, **kw)
        vm.knn = spy
        return self

    def __exit__(self, *exc):
        vm.knn = self.orig


def slice_phase(sim, cache_association: bool, n_warm: int = 60):
    """One pipeline run; the first `n_warm` measurements (IMU static init
    and the first frames) warm the allocator and are not timed, and the
    last of them is captured for the fused kernels' check.  Returns the
    phase's record and the Capture."""
    entry = "knn_plane_assoc" if cache_association else "knn_plane_rows"
    cfg = bench_lio_cfg(cache_association)
    plane_fit.reset_launches()
    with CudaKnnCalls() as knn_calls:
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


def check_fused_assoc(vmap, world, valid, thr, kw, min_neighbors) -> float:
    n_k, a_k, c_k, f_k = plane_fit.knn_plane_assoc_cuda(
        vmap, world, valid, thr, **kw)
    n_p, a_p, c_p, f_p = plane_fit.knn_plane_assoc_plain(
        vmap, world, valid, thr, **dict(kw, chunk=0))
    _, _, dists = vm.knn(vmap, world, threshold_capacity=thr,
                         **{a: kw[a] for a in ("voxel_size", "max_neighbors",
                                               "max_probe", "nb_voxels")})
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
    rows = f_p[v] >= min_neighbors
    sign = torch.where((n_k * n_p).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    err_a = _max_abs(a_k[v][rows], a_p[v][rows])
    err_n = _max_abs((n_k * sign)[v][rows], n_p[v][rows])
    if err_a > ATOL_H or err_n > ATOL_HX or int(rows.sum()) < nv // 2:
        raise AssertionError(f"knn_plane_assoc {kw} disagrees with its plain "
                             f"version on {int(rows.sum())} of {nv} rows: "
                             f"a2d err {err_a}, normal err {err_n}")
    return max(err_a, err_n)


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

def profile_phase(sim, n_warm: int = 60, n_sweeps: int = 20) -> dict:
    """torch.profiler over `n_sweeps` measurements of the default mode
    after `n_warm` warm-up ones: the 10 device ops with the most device
    time, and the union of the device's activity over the window's host
    wall time (its busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe = LivoPipeline(bench_lio_cfg(cache_association=True), device="cuda")
    meas = cut_all(pipe, sim)
    pipe.process_measurements(meas[:n_warm])
    torch.cuda.synchronize()
    n0 = pipe.index_frame
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.process_measurements(meas[n_warm:n_warm + n_sweeps])
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA),
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
    out = {"phase": "profile", "cache_association": True,
           "sweeps": pipe.index_frame - n0, "window_ms": window_us / 1e3,
           "device_events": len(dev), "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / window_us if dev else None,
           "top_device_ops": [{"name": name[:160], "ms": t / 1e3, "calls": n}
                              for name, (t, n) in top]}
    emit(out)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=["profile"],
                        help="run only the device and this phase")
    only = parser.parse_args().only
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    sim = synthetic.simulate(duration=20.0, n_azimuth=256, n_rings=32,
                             imu_rate=200.0, seed=3)
    if only == "profile":
        profile_phase(sim)
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

    summary = []
    for name, cache in (("knn_plane_assoc", True), ("knn_plane_rows", False),
                        ("plane_assoc", True), ("plane_rows", False)):
        r = results[name]
        summary.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES, "q": r["q"], "m": r["m"],
            "launches": runs[cache]["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "kernel_ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
