#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sr_livo_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device  — requires `torch.cuda.is_available()` (exits 2 otherwise)
     and prints the card's name and power limit as nvidia-smi reports
     them;
  2. build   — compiles sr_livo_tpu_torch/csrc/plane_fit.cu with nvcc;
  3. kernels — holds each kernel entry against its plain PyTorch version
     on the card at the shapes the main path gives it (`plane_rows`:
     Q = max_keypoints = 1024 rows; `plane_assoc`: Q = query_chunk = 512
     rows; M = 20 neighbours) and times both with CUDA events: the kernel's device
     time from CUDA-graph replay (`ms`), and one eager call of the kernel
     (`call_ms`) and of the plain version (`plain_ms`) as the path makes
     them;
  4. slice   — drives the LIO pipeline (LivoPipeline ->
     LioEngine.step) on a 20 s synthetic run at bench.py's LIO shapes,
     once per IEKF association mode, with the launch counters set to 0
     just before each run and read just after; checks ATE < 0.05 m and
     at most 2 failed registrations.

Then it prints the `{"kernels": [...]}` summary, the nvidia-smi line and,
last, `{"ok": true, "device": {...}}`.  Any failed phase raises and the
script exits non-zero without that last line.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
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
# within 2e-3.  The association entry is held to the same bars: a2d like
# h, the (sign-free) normal like h_x, the closest neighbour exactly.
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
# Phase 3: kernel vs plain
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


def slice_phase(sim, cache_association: bool, n_warm: int = 60) -> dict:
    """One pipeline run; the first `n_warm` measurements (IMU static init
    and the first frames) warm the allocator and are not timed."""
    entry = "plane_assoc" if cache_association else "plane_rows"
    cfg = bench_lio_cfg(cache_association)
    plane_fit.reset_launches()
    pipe = LivoPipeline(cfg, device="cuda")
    meas = cut_all(pipe, sim)
    pipe.process_measurements(meas[:n_warm])
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
    ts, ps, _ = pipe.trajectory()
    ate = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
    out = {"phase": "slice", "cache_association": cache_association,
           "measurements": len(meas), "frames": len(recs),
           "timed_frames": pipe.index_frame - n0,
           "timed_seconds": seconds,
           "sweeps_per_s": (pipe.index_frame - n0) / seconds,
           "ate_m": ate, "failed_registrations": n_fail,
           "launches": launches,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "stages_ms": {k: v["mean_ms"]
                         for k, v in pipe.timers.report().items()}}
    emit(out)
    if not pipe.initialized or len(recs) < 100:
        raise AssertionError(f"too few frames processed: {len(recs)}")
    if launches[entry] <= 0:
        raise AssertionError(f"the main path never launched {entry}")
    if n_fail > 2:
        raise AssertionError(f"{n_fail} failed registrations")
    if not ate < 0.05:
        raise AssertionError(f"ATE RMSE {ate} m")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a machine with an NVIDIA GPU", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    log = kernels.build("plane_fit")
    emit({"phase": "build", "source": KERNEL_SOURCE,
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    results = kernel_phase(bench_lio_cfg(cache_association=True))
    emit({"phase": "kernels_vs_plain", **results})

    sim = synthetic.simulate(duration=20.0, n_azimuth=256, n_rings=32,
                             imu_rate=200.0, seed=3)
    runs = {cache: slice_phase(sim, cache) for cache in (False, True)}

    summary = []
    for name, cache in (("plane_rows", False), ("plane_assoc", True)):
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
