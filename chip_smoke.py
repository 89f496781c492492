#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sr_livo_tpu_torch`) on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only profile   # device + profile phases only
    python3 chip_smoke.py --only livo      # device + livo phases only
    python3 chip_smoke.py --only longrun   # device + longrun (+ its shapes)
    python3 chip_smoke.py --only resume    # device + resume phases only
    python3 chip_smoke.py --only replay    # device + replay + demo phases
    python3 chip_smoke.py --only sharded   # device + sharded phase
    python3 chip_smoke.py --only scaling   # device + scaling (+ its shapes)
    python3 chip_smoke.py --only bench     # device + bench (+ its shape)
    python3 chip_smoke.py --only gate      # device + gate (+ its shapes)
    python3 chip_smoke.py --only graphs    # device + graphs phases only

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
     mode) or `knn_plane_rows` once per round of the IEKF's masked
     loop (`cache_association=False`), and no launch of the row entries and
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
  6c. scaling — the port's scaling bench (`runtime/scaling_bench.py`, the
     port of scripts/scaling_bench.py) on `cuda`, its record on one line
     and in output/SCALING_torch.json: the single-device step and the
     per-rank programs of 1 to 8 ranks (strong, and weak up to 8x) as
     worlds of one with the n-rank budgets, round-robin; the replicated
     remainder; walls of 1, 2 and 8 ranks sharing the card over gloo and
     the weak-8 routing overflow over 8 of them; the stage profiles; the
     saturating weak point (8x on one device, 64x split over 8 ranks);
     the collective model on the card's NVLink and a measured NCCL
     latency.  It checks every key of the JAX script's record, every
     time finite and positive, no overflow over the 8 ranks, the strong-1
     proxy within 2e-3 m of the single-device trajectory on the same
     sweeps, `knn_plane_assoc` once per IEKF update in every engine (the
     ranks' too) and no other entry, and the collectives of a steady
     sweep as modeled.  Then `knn_plane_assoc` against its plain version,
     timed and bounded, at the three new shapes (`SCALING_SHAPES`: the
     single device's 8192 keypoints on 2^19 slots, the weak-8 per-rank
     K4 ~2.1K, the saturating per-rank K4 ~16.4K on 2^20 slots);
  6d. bench — the port's throughput bench (`runtime/bench.py`, the port
     of bench.py) on `cuda`: bench.py's 40 s simulation (seed 3, 256 x 32
     rays, 512 x 640 images rendered on the card into a temporary cache)
     through `bench.run_bench` with its warm-up, the host-mode calibration
     on 6 interleaved bursts and the median of 4 disjoint chunks (stage
     timers without synchronize).  One line: the bench's record, its
     seconds, the simulation's seconds, the ATE of the whole run, the
     launches and the stage host times.  It fails unless the ATE is
     below 0.05 m with at most 2 failed registrations, `knn_plane_assoc`
     launched once per frame, no other entry and no plain kNN on the
     card, 4 chunk rates all positive, and the host mode the
     calibration's winner.  Then `knn_plane_assoc` against its plain
     version, timed and bounded, at the last timed sweep's association
     (captured on the card, `LastCapture`; a2d on rows not flat to
     rounding);
  7. livo    — the full LIVO loop (LivoPipeline with a VisionModule) at
     bench.py's configuration (512 x 640 images rendered on the card, 300
     tracks, the default colored-map shapes) on a 20 s run: warm-up as in
     bench.py, then the timed rest with synchronizing stage timers
     (sweeps+images/s, stage times, peak device memory), then a
     torch.profiler window of 20 frames.  It checks the bars of
     tests/test_vision_pipeline.py (ATE, kept tracks and inliers, the
     camera intrinsics, time offset and extrinsic, the colored map),
     `knn_plane_assoc` launched once per sweep and no plain kNN call on
     the card; its profile also counts the host's launches (kernels,
     graph replays, copies, fills) on the dispatching thread, and it
     prints each captured program's graph nodes, captures, replays and
     capture seconds, and the peak reserved memory beside the allocated;
  7b. graphs — the captured programs (`utils/graphs.py`: the LIO step,
     the colored-map insert and the vision frame, CUDA graph replays on
     the card; their loops masked rounds, `LOOP_ROUTES`): (a) the LIO
     step in both association modes on the slice's simulation, on an
     8 s r3live-profile bag with `retry_wider_neighborhood` on, and the
     three programs on the 20 s LIVO run at `bench.make_cfg()`: every
     10th program call is replayed and the program's function then run
     eagerly on clones of its buffers; outputs and state, integers and
     floats, must be the same bits; (b) `knn_plane_rows` at the
     arguments of one search-mode step against its plain version
     (GOOD_AGREE, ATOL_H, ATOL_HX); (c) graph nodes, captures and capture
     seconds per program, peak memory, and over the LIVO run's last 20
     frames host launches on the dispatching thread and device ops per
     rendered frame and the busy share; (d) the device ms of each
     program's replay and the step's stages (`graphs.mark` events in
     the graph) over 20 frames before those, and the r3live step with
     the retry against the same step without it; (e) a steady sweep's
     step and colored-map insert under
     `torch.cuda.set_sync_debug_mode("error")`; (f) the long-run
     path's programs (`LONG_RUN_PROGRAMS`: the windowed BA, the loop
     check, the pose-graph solves' Gauss-Newton iteration, `compact_map`
     and the map rebuild's insert) on the slice's simulation with the
     mapping backend (feedback and rebuild on) and eviction every 20
     frames: the first and every 10th call of each checked as in (a),
     the pose-graph iterations (float atomics) within the spread of 5
     eager runs.  The launch counts hold as the code calls for (a replay
     adds what its capture launched: a masked round launches its kernel
     too), and the LIVO run passes the vision bars;
  8. longrun — the same run with the long-run parts on: the mapping
     backend (loop feedback into the filter with map rebuild, otherwise
     BackendConfig's defaults), far-voxel eviction every 20 frames and a
     StreamPublisher into a temporary directory.  It prints the backend's
     counts (keyframes, BA runs, verified candidates, closures, feedback
     events, map rebuilds), eviction calls and dropped voxels, stream
     lines and chunks, the `backend` stage's mean and longest time, the
     final pose-graph solve and a PCG solve of a 100-node chain (eager,
     and as the backend's program: capture seconds, nodes, the replayed
     solve's device ms, its iterations checked against the eager
     function), per captured program its nodes, captures, capture
     seconds, replays and device ms per replay (`ReplayTimes`), and per
     long-run program the host launches of a steady call against its
     function run eagerly (`steady_calls`), and checks test_backend.py's
     ATE bars on the optimized trajectory, the vision bars, one stream
     line per frame, the backend's own `knn_plane_assoc` launches
     (counted around its keyframe hook, where all its associations run,
     from the replays' counters) equal to 2 per BA run plus 9 per
     verified loop candidate, the rest once per sweep, no other entry and
     no plain kNN on the card, and no synchronizing call in a steady call
     of any long-run program.  `compact_map` of the final map at 6 m on
     the card must equal the CPU's.  Then `fused_vs_plain` holds
     `knn_plane_assoc` against its plain version at the backend's two
     shapes taken from inside their programs after the run (BA: the last
     window, 4096 x 20 at 0.6 m, on the final live map; loop
     verification: the last candidate, 1024 x 10 on the 2^14-slot
     temporary map), a2d only on rows that are not flat to rounding
     (`FLAT_FLOOR`), and times them;
  9. resume  — the first 10 s of the run without the backend, straight
     through and again checkpointed at 5 s and resumed in a fresh
     pipeline: the same frames, positions within 5e-3 m, the same colored
     points after the load; checkpoint bytes, save and load seconds.
  10. replay — the real-data entry point: a 20 s bag of the r3live profile
     of the accuracy gate (runtime/accuracy_gate.py: its world and
     `standard` trajectory, a Livox cone at 10 Hz, IMU at 200 Hz,
     distorted 512 x 640 images rendered on the card with the published
     calibration), written with runtime/bag_writer.py and replayed
     through `drivers.replay_bag`
     into LivoPipeline with a VisionModule configured by
     configs/r3live.yaml and the gate's overrides.  It prints the gate's
     record, the replay's wall time, sweeps+images/s and host ms per
     message class (bag read, parsers, driver, native wire pack, native
     remap), and checks the gate's bars (ATE < 0.08 m, registered share
     >= 0.95, mean tracks >= 60), `knn_plane_assoc` launched once per
     IEKF update of the step program (twice a frame: the re-run over the
     widened neighbourhood of `retry_wider_neighborhood` is in the
     program, masked where the first solve is strong) and no plain kNN
     call on the card;
  11. demo    — `python -m sr_livo_tpu_torch.runtime.demo --device cuda
     --duration 10 --vision` in a subprocess: exit 0 and pose.txt.
  12. gate    — the port's accuracy gate (`python -m
     sr_livo_tpu_torch.runtime.accuracy_gate --quick`, the port of
     scripts/accuracy_gate.py) on `cuda`: every profile of the quick gate
     (r3live with its wire and cache ablations, ntu's Ouster-16 at 20 Hz
     re-cut at the 10 Hz image stamps, aggressive motion on the dense
     keypoint grid, revisit with MappingBackend feedback, an image dropout
     window, JPEG images; 12 s, one seed), its bags rendered on the card
     into a temporary directory.  One line per profile (the gate's record,
     the backend's launches, dense-grid steps, the expected launches),
     then the checks.  It fails when a quick check fails, when a
     profile's launches differ from what the code calls for
     (`gate_expected`: `knn_plane_assoc` once per IEKF update plus the
     backend's, or `knn_plane_rows` once per IEKF round in
     `r3live_nocache`, no other entry), when the backend's differ from 2
     per BA run plus 9 per verified loop candidate, or on a plain kNN call
     on CUDA.  Then `fused_vs_plain` holds the fused entries at the gate's
     new shapes (`GATE_SHAPES`: the ntu keypoints, the aggressive
     profile's dense grid, `knn_plane_rows` in the widened retry) against
     their plain versions and times them.

Each entry's times: device ms per launch from CUDA-graph replay (`ms`),
one eager call of the kernel (`call_ms`) and of the plain version
(`plain_ms`) as the path makes them, and the least time the card could
take for the same work (`bound_ms`, by bytes or operations, counted from
this run's inputs; `launches`, `launches_livo`, `launches_backend`,
`launches_replay`, `launches_gate`: the launches in the slice and livo
runs, the backend's own in the longrun run, those of the bag replay and
of the gate's profiles; `gate_shapes`: phase `gate`'s;
`launches_sharded` and `sharded_shapes`: phase `sharded`'s;
`launches_scaling` and `scaling_shapes`: phase `scaling`'s;
`launches_bench` and `bench_shape`: phase `bench`'s; `launches_graphs`:
phase `graphs`' runs in the entry's association mode, `rows_in_program`:
its (b); `captured`: where the entry runs on the main path, inside a
captured program or eagerly).  Then it
prints the `{"kernels": [...]}` summary, the nvidia-smi line and, last,
`{"ok": true, "device": {...}}`.  Any failed phase raises and the script
exits non-zero without that last line.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
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
from sr_livo_tpu_torch.config import LivoConfig  # noqa: E402
from sr_livo_tpu_torch.models import eskf as eskf_mod  # noqa: E402
from sr_livo_tpu_torch.models import lio  # noqa: E402
from sr_livo_tpu_torch.models.vision import VisionModule  # noqa: E402
from sr_livo_tpu_torch.ops import plane_fit  # noqa: E402
from sr_livo_tpu_torch.ops import voxel_map as vm  # noqa: E402
from sr_livo_tpu_torch.parallel import ba as pba  # noqa: E402
from sr_livo_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from sr_livo_tpu_torch.parallel import pose_graph, sharded_lio  # noqa: E402
from sr_livo_tpu_torch.pipeline import LivoPipeline  # noqa: E402
from sr_livo_tpu_torch.runtime import accuracy_gate as gate  # noqa: E402
from sr_livo_tpu_torch.runtime import bench  # noqa: E402
from sr_livo_tpu_torch.runtime import drivers, native  # noqa: E402
from sr_livo_tpu_torch.runtime import scaling_bench  # noqa: E402
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
# where each entry runs on the main path: inside a captured program (a
# CUDA graph node, replayed) or launched eagerly
CAPTURED = {
    "knn_plane_rows": "captured: inside the LIO step program "
                      "(cache_association=False), one node per round of "
                      "the IEKF's masked loop",
    "knn_plane_assoc": "captured: inside the LIO step program, one node "
                       "per IEKF update; inside the windowed-BA program, "
                       "one per Gauss-Newton iteration; inside the "
                       "loop-check program, 9",
    "plane_assoc": "off the main path", "plane_rows": "off the main path"}
# How each data-dependent loop of the JAX programs runs in the port's
# captured programs (utils/graphs.py): this PyTorch build exposes no CUDA
# graph conditional nodes (tests/torch_cond_probe.py), so every loop with
# rounds is masked rounds up to its proven bound.
LOOP_ROUTES = {
    "ops/frame.py::bucket_dedup_min": "no loop: one stable sort",
    "ops/voxel_map.py::_insert_gate_phase_chunked":
        "masked rounds, ceil(n / chunk)",
    "ops/voxel_map.py::insert claim rounds": "masked rounds, max_probe + 1",
    "ops/color_map.py::_claim_dedup": "masked rounds, max_probe + 1",
    "models/lio.py::iekf_update": "masked rounds, max_iters + 1",
    "models/odometry.py::_sweep_core retry": "both branches, select "
                                             "(graphs.cond)",
    "ops/voxel_map.py::compact_map claim rounds":
        "masked rounds, max_probe + 1",
    "parallel/pose_graph.py Gauss-Newton fori_loop":
        "one iteration's program replayed iters times",
    "parallel/pose_graph.py CG fori_loop": "unrolled, cg_iters steps",
    "parallel/ba.py::windowed_ba fori_loop": "unrolled, iters",
    "parallel/loop_closure.py::verify_closure fori_loop": "unrolled, iters"}


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
    """The bench's configuration (`bench.make_cfg`, bench.py:32-57) in an
    IEKF association mode.  The LIO path reads its shapes and budgets:
    1.0 m map voxels, <= 600 residuals, 5 ICP iterations, 16384 sweep /
    8192 frame points, 1024 keypoints, 64 IMU samples, 2^18 map slots of
    20 points."""
    cfg = bench.make_cfg()
    cfg.cache_association = cache_association
    return cfg


def _to(device, x):
    return x.to(device, copy=True) if torch.is_tensor(x) else x


def _programs():
    """The port's captured-program module (`utils/graphs.py`), imported
    where it is used, so that phases `livo` and `bench` also run in a
    checkout from before it (to compare the two trees in one call)."""
    from sr_livo_tpu_torch.utils import graphs
    return graphs


def in_capture() -> bool:
    """Whether a program is being warmed up or captured (its function's
    calls are not the path's own; a host copy would break the capture)."""
    return getattr(_programs(), "in_capture_form", lambda: False)()


def eager_fn(prog, state=None, inputs=None):
    """`fn` of a captured program run eagerly on a copy of its state (the
    LIO step inserts into its map in place) and on its inputs, or on the
    given ones; the counters it advances are set back."""
    graphs = _programs()
    with graphs.counts_kept():
        return prog.fn(graphs.tree_map(torch.clone, prog.state)
                       if state is None else state,
                       prog.inputs if inputs is None else inputs)


class Capture:
    """Within the block, records the arguments of the first call of a
    `plane_fit` entry (for which `want(args, kw)` holds, if given): a copy
    of the map and of the tensors, taken before the call, kept in host
    memory so that it does not count in the run's peak device memory.
    Every call is passed on; the calls a program's warm-up and capture
    make are not recorded.  A call inside a captured program makes no
    Python call when the graph replays, so for the programs whose names
    start with `programs` (by default those of the main path that call
    the entry, `IN_PROGRAMS`), before each call of such a program on the
    card, until a call is recorded, the program's function runs once
    eagerly on a copy of its state (`eager_fn`) for the record.
    `args_on(device)` returns the record on a device."""

    # entry -> the name prefixes of the main path's captured programs that
    # call it
    IN_PROGRAMS = {"knn_plane_rows": ("lio_step",),
                   "knn_plane_assoc": ("lio_step",)}

    def __init__(self, name: str, want=None, programs=None):
        self.name, self.args = name, None
        self.programs = (self.IN_PROGRAMS.get(name, ()) if programs is None
                         else programs)
        self.want = want or (lambda args, kw: True)

    def __enter__(self):
        self.orig = getattr(plane_fit, self.name)   # Captures may nest

        def spy(vmap, *args, **kw):
            if (self.args is None and not in_capture()
                    and self.want(args, kw)):
                self.args = (vm.VoxelMap(*(_to("cpu", t) for t in vmap)),
                             tuple(_to("cpu", a) for a in args), dict(kw))
            return self.orig(vmap, *args, **kw)
        setattr(plane_fit, self.name, spy)
        program = _programs().Program
        self.orig_call = program.__call__

        def call(prog):
            if (self.args is None and prog.device.type == "cuda"
                    and self.programs
                    and prog.name.startswith(self.programs)):
                eager_fn(prog)
            return self.orig_call(prog)
        program.__call__ = call
        return self

    def __exit__(self, *exc):
        setattr(plane_fit, self.name, self.orig)
        _programs().Program.__call__ = self.orig_call

    def args_on(self, device):
        vmap, args, kw = self.args
        return (vm.VoxelMap(*(_to(device, t) for t in vmap)),
                tuple(_to(device, a) for a in args), kw)


def _clone(x):
    return x.clone() if torch.is_tensor(x) else x


class LastCapture(Capture):
    """A Capture of the last call within the block: each call's map and
    tensors are cloned on their device (a device-to-device copy, no host
    transfer), replacing the previous call's record.  For an entry that a
    program calls, the buffers of each call of such a program are cloned
    instead, and at the end the program's function runs once eagerly on
    the last call's clones for the record."""

    def __enter__(self):
        self.orig = getattr(plane_fit, self.name)
        self.last = None

        def spy(vmap, *args, **kw):
            if not in_capture():
                self.args = (vm.VoxelMap(*(_clone(t) for t in vmap)),
                             tuple(_clone(a) for a in args), dict(kw))
            return self.orig(vmap, *args, **kw)
        setattr(plane_fit, self.name, spy)
        graphs = _programs()
        self.orig_call = graphs.Program.__call__

        def call(prog):
            if (prog.device.type == "cuda"
                    and prog.name.startswith(self.programs)):
                self.last = (prog, graphs.tree_map(_clone, prog.state),
                             graphs.tree_map(_clone, prog.inputs))
            return self.orig_call(prog)
        graphs.Program.__call__ = call
        return self

    def __exit__(self, *exc):
        _programs().Program.__call__ = self.orig_call
        if self.last is not None:
            eager_fn(*self.last)
        self.last = None
        setattr(plane_fit, self.name, self.orig)


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


class BackendLaunches(Spy):
    """Within the block, the kernel launches per entry made inside
    `MappingBackend.maybe_add_keyframe` (every association of the backend
    runs there): `launches`; `backend` is the last backend seen."""

    def __enter__(self):
        from sr_livo_tpu_torch.parallel.backend import MappingBackend
        super().__enter__()
        self.launches = dict.fromkeys(plane_fit.launches, 0)
        self.backend = None
        add_keyframe = MappingBackend.maybe_add_keyframe

        def counted(backend, *args, **kw):
            self.backend = backend
            before = dict(plane_fit.launches)
            try:
                return add_keyframe(backend, *args, **kw)
            finally:
                for k in self.launches:
                    self.launches[k] += plane_fit.launches[k] - before[k]
        self.patch(MappingBackend, "maybe_add_keyframe", counted)
        return self


class StepWatch(Spy):
    """Within the block, where the LIO path is: `frame`, the frame id of
    the running `LioEngine.step`; `dense`, whether that step runs the
    dense keypoint grid (`adaptive_keypoint_density`); `update`, 1 in the
    step's first IEKF update and 2 in the re-run over the widened
    neighbourhood (`retry_wider_neighborhood`), read from `lio.counts`.
    `dense_steps` counts the steps on the dense grid."""

    @property
    def update(self) -> int:
        return lio.counts["updates"] - self.updates_before_step

    def __enter__(self):
        from sr_livo_tpu_torch.models import odometry
        super().__enter__()
        self.frame, self.dense, self.dense_steps = -1, False, 0
        self.updates_before_step = lio.counts["updates"]
        step = odometry.LioEngine.step

        def watched_step(engine, state, vmap, sweep, frame_id, *args,
                         gyr_rate=0.0, **kw):
            self.frame = frame_id
            self.updates_before_step = lio.counts["updates"]
            self.dense = engine.phase(frame_id, gyr_rate) == "steady_dense"
            self.dense_steps += self.dense
            return step(engine, state, vmap, sweep, frame_id, *args,
                        gyr_rate=gyr_rate, **kw)
        self.patch(odometry.LioEngine, "step", watched_step)
        return self


def slice_phase(sim, cache_association: bool, n_warm: int = 60):
    """One pipeline run; the first `n_warm` measurements (IMU static init
    and the first frames) warm the allocator and are not timed, and the
    last of them is captured for the fused kernels' check.  Returns the
    phase's record and the Capture."""
    entry = "knn_plane_assoc" if cache_association else "knn_plane_rows"
    cfg = bench_lio_cfg(cache_association)
    plane_fit.reset_launches()
    rounds0 = lio.counts["iterations"]
    with cuda_knn_calls() as knn_calls:
        pipe = LivoPipeline(cfg, device="cuda")
        meas = bench.cut_all(pipe, sim)
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
    rounds = lio.counts["iterations"] - rounds0

    recs = pipe.records
    n_fail = sum(1 for r in recs if not r.success)
    iterations = sum(r.iterations for r in recs)
    ts, ps, _ = pipe.trajectory()
    ate = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
    out = {"phase": "slice", "cache_association": cache_association,
           "measurements": len(meas), "frames": len(recs),
           "iekf_iterations": iterations, "iekf_rounds": rounds,
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
    # with a program, every round of the masked IEKF loop launches
    want = len(recs) if cache_association else rounds
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
    return hold_rows(kw, plane_fit.knn_plane_rows_cuda(vmap, *args, **kw),
                     plane_fit.knn_plane_rows_plain(vmap, *args, **kw))


def hold_rows(kw, kernel_rows, plain_rows) -> float:
    """The kernel's (h_x, h, good) against the plain version's: `good`
    agreeing on more than GOOD_AGREE of the rows, at least 100 rows good
    in both, h within ATOL_H and h_x within ATOL_HX on them."""
    hx_k, h_k, good_k = kernel_rows
    hx_p, h_p, good_p = plain_rows
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


def time_fused(res: dict, entry: str, vmap, args, kw) -> dict:
    """Into `res`: a fused entry's device ms per launch (graph replay),
    eager call ms and plain ms on these inputs, and its bound (the
    searched keypoints are the valid ones, `args[-2]` of either entry)."""
    kernel = getattr(plane_fit, entry + "_cuda")
    plain = getattr(plane_fit, entry + "_plain")
    res["ms"] = graph_ms(lambda: kernel(vmap, *args, **kw))
    res["call_ms"] = time_ms(lambda: kernel(vmap, *args, **kw))
    res["plain_ms"] = time_ms(lambda: plain(vmap, *args, **kw), iters=30,
                              warmup=3)
    res["bound_ms"], res["bound_by"] = fused_bound_ms(
        vmap, args[0], args[-2], args[-1], kw, entry)
    return res


def fused_phase(captures: dict, min_neighbors: int) -> dict:
    """The fused entries on the slice's map and one sweep's keypoints
    (captured at the end of each mode's warm-up), at nb_voxels 1 and 2;
    timed at the captured (steady-state) setting."""
    results = {}
    cuda = torch.device("cuda")
    vmap, args, kw = captures["knn_plane_assoc"].args_on(cuda)
    world, valid, thr = args
    res = results["knn_plane_assoc"] = {
        "q": world.shape[0], "m": kw["max_neighbors"],
        "n_valid": int(valid.sum()), "max_abs_err": 0.0}
    for nb in (1, 2):
        res["max_abs_err"] = max(res["max_abs_err"], check_fused_assoc(
            vmap, world, valid, thr, dict(kw, nb_voxels=nb), min_neighbors))
    time_fused(res, "knn_plane_assoc", vmap, args, kw)

    vmap, args, kw = captures["knn_plane_rows"].args_on(cuda)
    world, valid = args[0], args[4]
    res = results["knn_plane_rows"] = {
        "q": world.shape[0], "m": kw["max_neighbors"],
        "n_valid": int(valid.sum()), "max_abs_err": 0.0}
    for nb in (1, 2):
        res["max_abs_err"] = max(res["max_abs_err"], check_fused_rows(
            vmap, args, dict(kw, nb_voxels=nb)))
    time_fused(res, "knn_plane_rows", vmap, args, kw)
    return results


# ---------------------------------------------------------------------------
# Phase 6: device profile of the step
# ---------------------------------------------------------------------------

KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx")
# what a host thread hands the device: kernels, graph replays, copies and
# fills
HOST_LAUNCHES = KERNEL_LAUNCHES + ("cudaGraphLaunch", "cuGraphLaunch",
                                   "cudaMemcpyAsync", "cudaMemsetAsync")


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
    per_thread = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in HOST_LAUNCHES:
            per_thread[e.thread] = per_thread.get(e.thread, 0) + 1
    out = {"window_ms": window_us / 1e3, "device_events": len(dev),
           "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / window_us if dev else None,
           # the dispatching thread is the one that launches the most
           # (the feeder thread only uploads)
           "host_launches": max(per_thread.values(), default=0),
           "host_launches_per_thread": sorted(per_thread.values()),
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
    meas = bench.cut_all(pipe, sim)
    pipe.process_measurements(meas[:n_warm])
    torch.cuda.synchronize()
    n0 = pipe.index_frame

    def run():
        pipe.process_measurements(meas[n_warm:n_warm + n_sweeps])
        torch.cuda.synchronize()

    prof = device_profile(run)
    n = max(pipe.index_frame - n0, 1)
    out = {"phase": "profile", "cache_association": True, **prof,
           "sweeps": pipe.index_frame - n0,
           "host_launches_per_sweep": prof["host_launches"] / n,
           "device_ops_per_sweep": prof["device_events"] / n}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 7: the full LIVO loop
# ---------------------------------------------------------------------------

def livo_sim():
    """The bench's simulation cut to 20 s (`bench.load_sim`: images
    rendered on the card, handed over as uint8 like a camera feed, cached
    in a temporary directory).  Returns (sim, ms to render one image and
    copy it to the host)."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        sim = bench.load_sim(duration=20.0, cache_dir=d, device="cuda")
    world, traj = synthetic.SyntheticWorld(), synthetic.Trajectory()
    dirs = synthetic._camera_ray_table(bench.CAM, bench.SIZE)
    t0 = time.perf_counter()
    for k in range(10):
        synthetic.render_image(world, traj, 5.0 + 0.1 * k, bench.CAM,
                               bench.SIZE, _dirs_cam=dirs, device="cuda")
    return sim, (time.perf_counter() - t0) * 100.0


def livo_checks(pipe, vision, sim) -> dict:
    """The bars of tests/test_vision_pipeline.py:59-108 on a run."""
    ts, ps, _ = pipe.trajectory()
    stats = np.array([s[1:] for s in vision.stats], np.float64)
    cam = vision.camera
    intr = cam.intr.double().cpu().numpy()
    r_ic = lie.quat_to_rot(cam.q_ic).double().cpu().numpy()
    r_cfg = np.asarray(bench.R_IMU_CAMERA, np.float64).reshape(3, 3)
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
        meas = bench.cut_all(pipe, sim)
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
        peak_reserved = torch.cuda.max_memory_reserved()
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
    prof["host_launches_per_rendered_frame"] = (
        prof["host_launches"] / max(n_rendered, 1))
    checks = livo_checks(pipe, vision, sim)
    out = {"phase": "livo", "measurements": len(meas),
           "frames": len(pipe.records), "timed_frames": n_timed,
           "timed_seconds": seconds,
           "sweeps_images_per_s": n_timed / seconds,
           "stages_ms": stages, "peak_memory_bytes": peak,
           "peak_reserved_bytes": peak_reserved,
           "programs": program_record(vision, pipe.engine),
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
    if not (abs(fx - bench.CAM[0]) < 10
            and abs(fy - bench.CAM[1]) < 10):
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
# Phase 7b: the captured programs against their eager functions
# ---------------------------------------------------------------------------

def program_record(vision, engine, *owners) -> list:
    """Per captured program of a run: its graph's nodes, captures, replays
    and the host seconds of its last capture (none in a checkout from
    before the programs); `owners` (the backend, the pipeline) hold more
    in `programs`."""
    progs = list(getattr(vision, "programs", {}).values())
    progs += list(getattr(vision, "insert_programs", {}).values())
    progs += list(getattr(engine, "programs", {}).values())
    progs += list(getattr(engine, "iekf_programs", {}).values())
    for owner in owners:
        progs += list(getattr(owner, "programs", {}).values())
    return [{"name": p.name, "nodes": p.nodes, "captures": p.captures,
             "replays": p.replays, "capture_s": p.capture_s}
            for p in progs]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, comparable with torch.equal (NaN included)."""
    if t.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return t.contiguous().view(ints[t.element_size()])
    return t


def compare_leaves(graphs, replayed, eager) -> dict:
    """Leaf by leaf, whether two pytrees hold the same bits; the largest
    difference of the float leaves that do not."""
    la, lb = graphs.tree_leaves(replayed), graphs.tree_leaves(eager)
    out = {"leaves": len(la), "int_differ": 0, "float_differ": 0,
           "float_max_abs": 0.0}
    for a, b in zip(la, lb):
        if torch.equal(_bits(a), _bits(b)):
            continue
        if a.is_floating_point():
            out["float_differ"] += 1
            out["float_max_abs"] = max(out["float_max_abs"],
                                       _max_abs(a.double(), b.double()))
        else:
            out["int_differ"] += 1
    return out


# Programs that hold float atomics (`index_add_` on CUDA floats: the
# pose-graph solves), whose eager runs part from each other: a checked
# replay is held to the spread of ATOMIC_RUNS eager runs on its inputs.
ATOMIC_PROGRAMS = ("pose_graph",)
ATOMIC_RUNS = 5


class ProgramCheck:
    """Within the block, the first and every `every`-th call after it of
    each captured program whose name starts with `prefix` (a string or a
    tuple of them) is checked: its buffers are cloned, the graph
    replayed, then the program's function run eagerly on the clones and
    its state written back into them (the counters it advances set
    back); the outputs and the state must be the same bits.  A program
    with float atomics (`ATOMIC_PROGRAMS`) runs eagerly ATOMIC_RUNS times:
    its integers must be the same bits and its floats lie within the
    spread of those runs of one of them (`spread`, `nearest`)."""

    def __init__(self, prefix, every: int = 10):
        self.prefix, self.every = prefix, every
        self.calls, self.checks, self.per_name = 0, [], {}

    def __enter__(self):
        graphs = self.graphs = _programs()
        self.orig_call = graphs.Program.__call__

        def call(prog):
            if (not prog.name.startswith(self.prefix)
                    or prog.device.type != "cuda"):
                return self.orig_call(prog)
            self.calls += 1
            k = self.per_name[prog.name] = self.per_name.get(prog.name, 0) + 1
            if (k - 1) % self.every:
                return self.orig_call(prog)
            state = graphs.tree_map(torch.clone, prog.state)
            inputs = graphs.tree_map(torch.clone, prog.inputs)
            out = self.orig_call(prog)
            replayed = (graphs.tree_map(torch.clone, prog.state),
                        graphs.tree_map(torch.clone, out))
            runs = (ATOMIC_RUNS if prog.name.startswith(ATOMIC_PROGRAMS)
                    else 1)
            eager = []
            with graphs.counts_kept():
                for _ in range(runs):
                    st = graphs.tree_map(torch.clone, state)
                    new_state, eager_out = prog.fn(
                        st, graphs.tree_map(torch.clone, inputs))
                    graphs.refill(st, new_state)
                    eager.append((st, eager_out))
            rec = {"program": prog.name, "call": k,
                   **compare_leaves(graphs, replayed, eager[0])}
            if runs > 1:
                rec.update(atomic_check(graphs, replayed, eager))
            self.checks.append(rec)
            return out
        graphs.Program.__call__ = call
        return self

    def __exit__(self, *exc):
        self.graphs.Program.__call__ = self.orig_call

    def summary(self) -> dict:
        c = self.checks
        bad = [x for x in c if x["int_differ"]
               or (x["float_differ"] and not x.get("within_spread"))]
        return {"calls": self.calls, "checked": len(c),
                "programs_checked": sorted({x["program"] for x in c}),
                "int_differ": sum(x["int_differ"] for x in c),
                "float_differ": sum(x["float_differ"] for x in c),
                "float_max_abs": max((x["float_max_abs"] for x in c),
                                     default=0.0),
                "atomic_spread": max((x["spread"] for x in c
                                      if "spread" in x), default=None),
                "failing": len(bad), "differing": bad[:5]}


def atomic_check(graphs, replayed, eager) -> dict:
    """A replay against several eager runs of a program with float
    atomics: the largest difference between two eager runs (`spread`),
    the replay's difference from the nearest run (`nearest`), and whether
    that is within the spread, the integers equal to the first run's."""
    def dist(a, b):
        return max((_max_abs(x.double(), y.double()) for x, y in zip(
            graphs.tree_leaves(a), graphs.tree_leaves(b))
            if x.is_floating_point() and x.numel()), default=0.0)
    spread = max(dist(a, b) for a in eager for b in eager)
    nearest = min(dist(replayed, e) for e in eager)
    return {"spread": spread, "nearest": nearest,
            "within_spread": nearest <= spread}


class ReplayTimes:
    """Within the block, the device ms of each captured program's call on
    the card, from CUDA events recorded on the stream just before and
    after it (outside its graph), and with `stages`, after each call of a
    program captured with stage events, its stages' device ms
    (`Program.stage_ms`, which waits for the call).  `summary()` waits
    for the last call and gives, per program name, the calls and the
    mean and median device ms, and the mean ms per stage."""

    def __init__(self, stages: bool = False):
        self.stages, self.events, self.split = stages, [], {}

    def __enter__(self):
        graphs = self.graphs = _programs()
        self.orig = graphs.Program.__call__

        def call(prog):
            if prog.device.type != "cuda":
                return self.orig(prog)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self.orig(prog)
            ev[1].record()
            self.events.append((prog.name, *ev))
            if self.stages and prog.marks:
                for k, v in prog.stage_ms().items():
                    self.split.setdefault(prog.name, {}).setdefault(
                        k, []).append(v)
            return out
        graphs.Program.__call__ = call
        return self

    def __exit__(self, *exc):
        self.graphs.Program.__call__ = self.orig

    def summary(self) -> dict:
        torch.cuda.synchronize()
        by = {}
        for name, a, b in self.events:
            by.setdefault(name, []).append(a.elapsed_time(b))
        out = {name: {"calls": len(v), "mean_ms": float(np.mean(v)),
                      "median_ms": float(np.median(v))}
               for name, v in by.items()}
        for name, st in self.split.items():
            out[name]["stages_ms"] = {k: float(np.mean(v))
                                      for k, v in st.items()}
        return out


def replay_ms(prog, state0, n: int = 20) -> float:
    """Median device ms of `n` replays of a captured program, each from
    the state `state0` (copied in first, outside the timed events)."""
    graphs = _programs()
    ms = []
    for _ in range(n):
        graphs.refill(prog.state, state0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        prog()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return float(np.median(ms))


def steady_program(engine):
    """The engine's step program past init with the most replays (the
    `steady` or, on the dense grid, the `steady_dense` one)."""
    return max((p for k, p in engine.programs.items() if k[0] != "init"),
               key=lambda p: p.replays)


def retry_cost(pipe, cfg) -> dict:
    """The r3live steady step with `retry_wider_neighborhood` (both
    branches run, `graphs.cond`) against the same step without it, on
    the run's last steady sweep and state: device ms of a replay each."""
    import dataclasses
    graphs = _programs()
    prog = steady_program(pipe.engine)
    state0 = graphs.tree_map(torch.clone, prog.state)
    off_cfg = dataclasses.replace(cfg, retry_wider_neighborhood=False)
    off = LivoPipeline(off_cfg, device="cuda").engine
    inp = prog.inputs
    off.step(*graphs.tree_map(torch.clone, state0), inp.sweep,
             pipe.index_frame, prev_poses=inp.prev_poses)
    with graphs.counts_kept():
        on_ms = replay_ms(prog, state0)
        off_ms = replay_ms(steady_program(off), state0)
    graphs.refill(prog.state, state0)
    return {"step_ms_with_retry": on_ms, "step_ms_without_retry": off_ms,
            "retry_ms": on_ms - off_ms}


def no_sync_step(pipe, vision) -> str:
    """A steady sweep's `LioEngine.step` and colored-map insert (both
    captured already) under `set_sync_debug_mode("error")`: "" or what
    raised."""
    graphs = _programs()
    prog = steady_program(pipe.engine)
    sweep = graphs.tree_map(torch.clone, prog.inputs.sweep)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pipe.engine.step(pipe.state, pipe.voxel_map, sweep,
                               pipe.index_frame)
        vision.insert_sweep_points(out.frame_pts_world, out.frame_valid,
                                   out.summary.success, 1e3)
        return ""
    except RuntimeError as e:
        return repr(e)[:400]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def graphs_phase(sim, lsim, n_profile: int = 20, n_split: int = 20) -> dict:
    """The captured programs (`utils/graphs.py`) on the card, their loops
    masked rounds (`LOOP_ROUTES`).  (a) The LIO step program in both
    association modes on phase slice's simulation, on an 8 s
    r3live-profile bag (no images) with `retry_wider_neighborhood`, and
    the step, colored-map insert and vision frame programs on the 20 s
    LIVO run at `bench.make_cfg()`: every 10th call is replayed and its
    function run eagerly on clones of its buffers; integers and floats
    must be the same bits (no body holds a float atomic whose order could
    differ: the CLAHE histogram adds exact 1.0s, and the tile-weight
    accumulate has no repeated index).  (b) `knn_plane_rows` at the
    arguments of a search-mode step (its 200th call in the eager runs)
    against its plain version, to the bars of phase fused_vs_plain.
    (c) Graph nodes, captures, replays and capture seconds per program,
    the peak device memory, and over the LIVO run's last `n_profile`
    frames (unchecked) host launches on the dispatching thread and device
    ops per rendered frame, and the device's busy share.  (d) Over the
    `n_split` frames before those, each program's replay in device ms and
    the step's stages (in-graph events), and the r3live step's device ms
    with and without the retry.  (e) No synchronizing call in a steady
    sweep's step and colored-map insert.  Launches: one `knn_plane_assoc`
    per IEKF update and one `knn_plane_rows` per IEKF round as
    `lio.counts` counts them (a replay adds its capture's)."""
    import tempfile
    graphs = _programs()
    out = {"phase": "graphs", "loop_routes": LOOP_ROUTES,
           "if_node_api": hasattr(torch.cuda.CUDAGraph,
                                  "begin_capture_to_if_node")}
    bad = []

    def launch_check(tag, launches, c0, frames, retry=False):
        upd = lio.counts["updates"] - c0["updates"]
        rounds = lio.counts["iterations"] - c0["iterations"]
        want = dict.fromkeys(launches, 0)
        if launches["knn_plane_rows"]:
            want["knn_plane_rows"] = rounds
        else:
            want["knn_plane_assoc"] = upd
        if launches != want or upd != (2 if retry else 1) * frames:
            bad.append(f"{tag}: launches {launches} in {frames} frames, "
                       f"{upd} updates and {rounds} rounds")
        return {"iekf_updates": upd, "iekf_rounds": rounds}

    def check_failures(tag, chk):
        if chk["failing"]:
            bad.append(f"{tag}: replay differs from the eager function: "
                       f"{chk['differing']}")
        if not chk["checked"]:
            bad.append(f"{tag}: nothing checked")

    for cache in (True, False):
        cfg = bench_lio_cfg(cache)
        plane_fit.reset_launches()
        c0 = dict(lio.counts)
        with ProgramCheck("lio_step") as chk, \
                contextlib.ExitStack() as stack:
            cap = (None if cache else stack.enter_context(
                Capture("knn_plane_rows", nth_call(200))))
            pipe = LivoPipeline(cfg, device="cuda")
            pipe.process_measurements(bench.cut_all(pipe, sim))
            torch.cuda.synchronize()
        launches = dict(plane_fit.launches)
        rec = {"checks": chk.summary(), "frames": len(pipe.records),
               "iekf_iterations": sum(r.iterations for r in pipe.records),
               "launches": launches,
               **launch_check(f"lio step ({cache=})", launches, c0,
                              len(pipe.records)),
               "programs": program_record(None, pipe.engine)}
        if not cache:
            if cap.args is None:
                bad.append("no knn_plane_rows call held in a step")
            else:
                vmap, args, kw = cap.args_on(torch.device("cuda"))
                rec["rows_in_program"] = {
                    "q": args[0].shape[0], "nb_voxels": kw["nb_voxels"],
                    "n_valid": int(args[4].sum()),
                    "max_abs_err": hold_rows(
                        kw, plane_fit.knn_plane_rows(vmap, *args, **kw),
                        plane_fit.knn_plane_rows_plain(vmap, *args, **kw))}
        out["lio_" + ("assoc" if cache else "search")] = rec
        check_failures(f"lio step ({cache=})", rec["checks"])

    cfg = r3live_cfg()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "r3live.bag")
        r3live_bag(path, 8.0, 11, "cuda", images=False)
        plane_fit.reset_launches()
        c0 = dict(lio.counts)
        with ProgramCheck("lio_step") as chk:
            pipe = LivoPipeline(cfg, device="cuda")
            drivers.replay_bag(pipe, path, cfg, *R3_TOPICS,
                               image_type=drivers.IMAGE_TYPE_RGB8)
            torch.cuda.synchronize()
    launches = dict(plane_fit.launches)
    rec = {"checks": chk.summary(), "frames": len(pipe.records),
           "registered": sum(r.success for r in pipe.records),
           "launches": launches,
           **launch_check("r3live retry", launches, c0, len(pipe.records),
                          retry=True),
           "programs": program_record(None, pipe.engine),
           **retry_cost(pipe, cfg)}
    out["lio_r3live_retry"] = rec
    check_failures("r3live retry", rec["checks"])
    del pipe

    cfg = bench.make_cfg()
    plane_fit.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    c0 = dict(lio.counts)
    graphs.stage_events(True)
    try:
        with ProgramCheck(("vision_frame", "lio_step",
                           "color_insert")) as chk:
            vision = VisionModule(cfg, device="cuda")
            pipe = LivoPipeline(cfg, vision=vision, device="cuda")
            meas = bench.cut_all(pipe, lsim)
            pipe.process_measurements(meas[:len(meas) - n_profile - n_split])
            torch.cuda.synchronize()
    finally:
        graphs.stage_events(False)
    split = meas[len(meas) - n_profile - n_split:len(meas) - n_profile]
    with ReplayTimes(stages=True) as times:
        pipe.process_measurements(split)
    replays = times.summary()
    rest = meas[len(meas) - n_profile:]
    n_rendered = sum(1 for m in rest if m.rendering and m.image is not None)

    def run():
        pipe.process_measurements(rest)
        torch.cuda.synchronize()

    prof = device_profile(run)
    launches = dict(plane_fit.launches)
    rec = {"checks": chk.summary(), "frames": len(pipe.records),
           "rendered_frames": len(vision.stats), "launches": launches,
           **launch_check("livo", launches, c0, len(pipe.records)),
           "programs": program_record(vision, pipe.engine),
           "replay_device_ms": replays,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "profile": {"frames": len(rest), "rendered_frames": n_rendered,
                       "host_launches_per_rendered_frame":
                           prof["host_launches"] / max(n_rendered, 1),
                       "device_ops_per_rendered_frame":
                           prof["device_events"] / max(n_rendered, 1),
                       **prof}}
    bad += vision_bar_failures(livo_checks(pipe, vision, lsim))
    rec["no_sync_error"] = no_sync_step(pipe, vision)
    out["livo"] = rec
    check_failures("livo programs", rec["checks"])
    names = {c["program"].split("[")[0] for c in chk.checks}
    if names != {"vision_frame", "lio_step", "color_insert"}:
        bad.append(f"livo: checked only {sorted(names)}")
    if rec["no_sync_error"]:
        bad.append(f"a steady sweep synchronized: {rec['no_sync_error']}")
    if not replays.get("lio_step[steady]", {}).get("stages_ms"):
        bad.append("no stage split of the steady step")
    del pipe, vision
    out["long_run"] = rec = long_run_programs_check(sim)
    check_failures("long-run programs", rec["checks"])
    want = {"windowed_ba", "pose_graph_dense", "compact_map"}
    if rec["verified_candidates"]:
        want.add("verify_closure")
    if rec["map_rebuilds"]:
        want.add("map_insert")
    checked = {n.split("[")[0] for n in rec["checks"]["programs_checked"]}
    if not want <= checked:
        bad.append(f"long run: checked only {sorted(checked)}")
    emit(out)
    if bad:
        raise AssertionError("graphs phase: " + "; ".join(bad))
    return out


# the long-run path's programs (parallel/backend.py, pipeline.py's
# eviction), by name prefix
LONG_RUN_PROGRAMS = ("windowed_ba", "verify_closure", "pose_graph",
                     "compact_map", "map_insert")


def long_run_programs_check(sim) -> dict:
    """Phase graphs' (f): the LIO path at bench.py's LIO shapes on phase
    slice's simulation with the mapping backend (loop feedback and map
    rebuild on, BackendConfig's defaults otherwise) and eviction every
    20 frames, then the final pose-graph solve: the first and every 10th
    call of each long-run program checked against its eager function
    (`ProgramCheck`; the pose-graph solves within the spread of their
    eager runs)."""
    from sr_livo_tpu_torch.parallel.backend import (BackendConfig,
                                                    MappingBackend)
    cfg = bench_lio_cfg(cache_association=True)
    cfg.enable_map_eviction = True
    with ProgramCheck(LONG_RUN_PROGRAMS) as chk, \
            BackendLaunches() as launched:
        backend = MappingBackend(BackendConfig(feedback_to_filter=True),
                                 device="cuda")
        pipe = LivoPipeline(cfg, backend=backend, device="cuda")
        pipe.process_measurements(bench.cut_all(pipe, sim))
        backend.optimized_trajectory()
        torch.cuda.synchronize()
    return {"frames": len(pipe.records), "keyframes": len(backend.keyframes),
            "ba_runs": backend.ba_runs,
            "verified_candidates": backend.n_verified,
            "loop_closures": backend.n_loop_closures,
            "map_rebuilds": backend.n_map_rebuilds,
            "launches_backend": launched.launches,
            "checks": chk.summary(),
            "programs": program_record(None, None, backend, pipe)}


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
    with one loop edge, padded as the backend pads it, solved eagerly
    (`optimize_pose_graph`) and as the backend's program (one Gauss-Newton
    iteration replayed `iters` times, `optimize_pose_graph_program`),
    each timed after a first call; the program's iterations checked
    against the eager function (`ProgramCheck`)."""
    from sr_livo_tpu_torch.parallel import pose_graph as pg
    graphs = _programs()
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

    def timed(solve):
        solve()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        q_out, t_out = solve()
        ev[1].record()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(t_out).all()):
            raise AssertionError("PCG pose-graph solve is not finite")
        return ev[0].elapsed_time(ev[1]), t_out.clone()

    eager_ms, t_eager = timed(lambda: pg.optimize_pose_graph(graph,
                                                             iters=iters))
    programs = {}
    with ProgramCheck("pose_graph") as chk:
        program_ms, t_prog = timed(lambda: pg.optimize_pose_graph_program(
            programs, graph, iters=iters))
    (prog,) = programs.values()
    check = chk.summary()
    if check["failing"] or not check["checked"]:
        raise AssertionError(f"PCG program differs from eager: {check}")
    return {"nodes": n, "padded_nodes": n_pad, "gn_iterations": iters,
            "cg_steps": max(96, int(1.5 * n_pad)), "ms": eager_ms,
            "program_ms": program_ms, "program_nodes": prog.nodes,
            "program_capture_s": prog.capture_s,
            "program_vs_eager_t_max_abs": _max_abs(t_prog, t_eager),
            "checks": check}


def program_args(prog, want) -> "Capture":
    """The `knn_plane_assoc` call (for which `want` holds) of a captured
    program's function, run once eagerly on a copy of its state and on
    its last inputs: the entry's arguments inside the program."""
    with Capture("knn_plane_assoc", want, programs=()) as cap:
        eager_fn(prog)
    return cap


def steady_calls(programs: dict, solve_iters: int = 10) -> dict:
    """Per long-run program (the one of each kind with the most replays):
    host launches of one steady call (its inputs refilled from device
    copies of its last ones, then `solve_iters` replays for a pose-graph
    iteration, one otherwise) and of its function run eagerly on the same
    inputs as many times (torch.profiler, the calling thread), the median
    device ms of 5 steady calls (CUDA events around each), and what a
    steady call raised under `set_sync_debug_mode("error")` ("" if
    nothing).  The calls run on the run's final state: an eviction's
    compacts the pipeline's map again, a rebuild group's inserts again."""
    graphs = _programs()
    out = {}
    for kind in LONG_RUN_PROGRAMS:
        mine = [p for p in programs.values() if p.name.startswith(kind)]
        if not mine:
            continue
        prog = max(mine, key=lambda p: p.replays)
        reps = solve_iters if kind == "pose_graph" else 1
        inputs = graphs.tree_map(torch.clone, prog.inputs)

        def call(prog=prog, inputs=inputs, reps=reps):
            graphs.call({0: prog}, 0, prog.fn, prog.state, inputs,
                        repeat=reps)

        state = graphs.tree_map(torch.clone, prog.state)

        def eager(prog=prog, inputs=inputs, reps=reps, state=state):
            with graphs.counts_kept():
                st = state
                for _ in range(reps):
                    st = prog.fn(st, inputs)[0]

        rec = out[prog.name] = {"replays_per_call": reps}
        for key, fn in (("host_launches", call),
                        ("eager_host_launches", eager)):
            rec[key] = device_profile(
                lambda fn=fn: (fn(), torch.cuda.synchronize())
            )["host_launches"]
        ms = []
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            call()
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        rec["device_ms"] = float(np.median(ms))
        torch.cuda.set_sync_debug_mode("error")
        try:
            call()
            rec["sync_error"] = ""
        except RuntimeError as e:
            rec["sync_error"] = repr(e)[:300]
        finally:
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    return out


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
                BackendLaunches() as backend_calls, \
                ReplayTimes() as times:
            backend = MappingBackend(BackendConfig(feedback_to_filter=True),
                                     device="cuda")
            backend_launches = backend_calls.launches
            stream = StreamPublisher(out_dir)
            vision = VisionModule(cfg, device="cuda")
            pipe = LivoPipeline(cfg, vision=vision, backend=backend,
                                stream=stream, device="cuda")
            pipe.timers = StageTimers(sync=True, device=pipe.device)
            meas = bench.cut_all(pipe, sim)
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
            kf_times, t_opt, _ = backend.optimized_trajectory()
            solve_ms = (time.perf_counter() - t1) * 1e3
        launches = dict(plane_fit.launches)
        peak = torch.cuda.max_memory_allocated()
        frames = len(pipe.records)
        lines = read_live_trajectory(out_dir)
        n_chunks = len(os.listdir(os.path.join(out_dir, "color_chunks")))
        with open(os.path.join(out_dir, "path_live.txt")) as f:
            n_path = len(f.read().splitlines())
    replays = times.summary()
    checks = livo_checks(pipe, vision, sim)
    ate_opt = tum.ate_rmse(kf_times, t_opt, sim.gt_times, sim.gt_pos,
                           align=True)
    expected_backend = 2 * backend.ba_runs + 9 * backend.n_verified
    stages = pipe.timers.report()
    compact = compact_cpu_vs_card(pipe.voxel_map, pipe.state.p, 6.0,
                                  cfg.shapes.map_max_probe)
    # the backend's two association shapes, inside their programs: the
    # last BA window on the final map, the last verified candidate
    progs = {**backend.programs, **pipe.programs}
    by_kind = {k: [p for p in progs.values() if p.name.startswith(k)]
               for k in ("windowed_ba", "verify_closure")}
    cap_ba = (program_args(by_kind["windowed_ba"][-1], _is_ba)
              if by_kind["windowed_ba"] else None)
    cap_loop = (program_args(by_kind["verify_closure"][-1], _is_loop)
                if by_kind["verify_closure"] else None)
    steady = steady_calls(progs)
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
           "stages_max_ms": {k: v["max_ms"] for k, v in stages.items()},
           "programs": program_record(vision, pipe.engine, backend, pipe),
           "replay_device_ms": replays,
           "steady_calls": steady,
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
    if cap_ba is None or cap_ba.args is None or (
            backend.n_verified and (cap_loop is None
                                    or cap_loop.args is None)):
        bad.append("a backend association shape was not captured")
    synced = {k: v["sync_error"] for k, v in steady.items()
              if v["sync_error"]}
    if synced:
        bad.append(f"a steady long-run program call synchronized: {synced}")
    kinds = {n.split("[")[0] for n in steady}
    if not {"windowed_ba", "compact_map"} <= kinds or (
            backend.n_verified and "verify_closure" not in kinds) or (
            backend.n_feedback_applied and not {
                "pose_graph_dense", "map_insert"} <= kinds):
        bad.append(f"long-run programs that ran: {sorted(kinds)}")
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
        if captures[name] is None or captures[name].args is None:
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
        time_fused(res, "knn_plane_assoc", vmap, (world, valid, thr), kw)
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

# The r3live profile of the accuracy gate (runtime/accuracy_gate.py, the
# port of scripts/accuracy_gate.py): the published calibration of the
# R3Live sequences (configs/r3live.yaml), images at image_scale 0.5 (1024
# x 1280 -> 512 x 640) with the lens distortion, the camera-IMU extrinsic
# and a 6 ms camera time offset.
R3_TOPICS = gate.R3_TOPICS
# The gate's per-seed ATE bound, registration share and --quick track bar
# (accuracy_gate.py:454-509).
REPLAY_MAX_ATE = 0.08
REPLAY_MIN_REGISTERED = 0.95
REPLAY_MIN_TRACKS = 60.0


def r3live_bag(path: str, duration: float, seed: int, device="cuda",
               images: bool = True):
    """The gate's r3live bag (`accuracy_gate.simulate_profile` and
    `write_bag`): its world, the `standard` trajectory, a Livox cone of
    160 x 110 directions at 10 Hz, IMU at 200 Hz and distorted 512 x 640
    RGB8 images at 10 Hz, rays cast on `device`, written uncompressed.
    With `images=False` the images are 8 x 8 and black: they carry only
    their stamps, which cut the sweeps.  Returns (sim, seconds to
    simulate, seconds to write, message counts)."""
    t0 = time.perf_counter()
    sim = gate.simulate_profile(
        duration=duration, image_rate=10.0, traj_kind="standard",
        sensor="livox", calib=gate.R3_CALIB, seed=seed, device=device,
        images=images)
    simulate_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = gate.write_bag(path, sim, "livox")
    return sim, simulate_s, time.perf_counter() - t0, counts


def r3live_cfg() -> LivoConfig:
    """configs/r3live.yaml (read as data) with the gate's shape overrides,
    cache_association and wire_quantization on and
    retry_wider_neighborhood (`accuracy_gate.profile_config`)."""
    return gate.profile_config(gate.R3_YAML)


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
    updates (`lio.counts`: on the card two a frame, the step program
    holding the re-run over the widened neighbourhood of
    `retry_wider_neighborhood`, masked where the first solve is strong),
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
        updates0 = lio.counts["updates"]
        with cuda_knn_calls() as knn_calls, HostTimes() as host:
            t0 = time.perf_counter()
            drivers.replay_bag(pipe, path, cfg, *R3_TOPICS,
                               image_type=drivers.IMAGE_TYPE_RGB8)
            if on_cuda:
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        launches = dict(plane_fit.launches)
        n_updates = lio.counts["updates"] - updates0

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
           "iekf_updates": n_updates,
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
    if not len(recs) <= n_updates <= 2 * len(recs):
        bad.append(f"{n_updates} IEKF updates in {len(recs)} frames")
    if on_cuda:
        if launches["knn_plane_assoc"] != n_updates:
            bad.append(f"knn_plane_assoc launched "
                       f"{launches['knn_plane_assoc']} times in "
                       f"{n_updates} IEKF updates")
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
# Phase 12: the accuracy gate
# ---------------------------------------------------------------------------

# The gate's new kernel shapes, each captured once in its profile: the
# first IEKF update of a step (update 1) or the re-run of a weak solve
# over the widened neighbourhood (update 2), from the given frame on, on
# the dense keypoint grid or not (`dense`; None: either).  Frame ids count
# from the first frame after the IMU's static init, about 3 s into a
# profile; the motion starts at 4.5 s.  The frames chosen are about 8 s
# in, two thirds through the 12 s quick profiles; the retry is the first
# after the init frames (from 4.5 s on, weak solves re-run on most
# frames; before it the still platform sees over 500 residuals).
GATE_SHAPES = {
    # the Ouster-16's keypoints on the ntu profile's map (20 Hz sweeps)
    "ntu": dict(profile="ntu", entry="knn_plane_assoc", update=1,
                frame=100, dense=None),
    # the dense keypoint grid of adaptive_keypoint_density under hard
    # motion
    "dense": dict(profile="aggressive", entry="knn_plane_assoc", update=1,
                  frame=50, dense=True),
    # knn_plane_rows in the widened retry of the reference's
    # re-associate-every-iteration mode
    "rows_retry": dict(profile="r3live_nocache", entry="knn_plane_rows",
                       update=2, frame=0, dense=None),
}


def gate_expected(rec: dict, cache_association: bool, backend: dict,
                  n_verified: int) -> tuple:
    """The launches per entry that the code calls for in one gate profile
    (models/lio.py::iekf_update, as `lio.counts` counts it): with
    `cache_association`, one `knn_plane_assoc` per IEKF update (a frame's
    first, and in the step program the re-run over the widened
    neighbourhood, masked where the first solve is strong) plus the
    backend's own (`backend`); without, one `knn_plane_rows` per round of
    the IEKF's masked loop, the re-run's included.  The backend's
    are 2 per BA run plus 9 per verified loop candidate.  Returns (the
    expected launches, the backend's expected knn_plane_assoc)."""
    want = dict.fromkeys(plane_fit.launches, 0)
    if cache_association:
        want["knn_plane_assoc"] = (rec["iekf_updates"]
                                   + backend["knn_plane_assoc"])
    else:
        want["knn_plane_rows"] = rec["iekf_iterations"]
    return want, 2 * rec.get("ba_runs", 0) + 9 * n_verified


def rows_shape(name: str, cap: "Capture") -> dict:
    """`knn_plane_rows` against its plain version at a captured shape, as
    phase `fused_vs_plain` holds it, and timed."""
    vmap, args, kw = cap.args_on(torch.device("cuda"))
    res = {"shape": name, "q": args[0].shape[0], "m": kw["max_neighbors"],
           "nb_voxels": kw["nb_voxels"], "n_valid": int(args[4].sum()),
           "map_capacity": vmap.counts.shape[0],
           "max_abs_err": check_fused_rows(vmap, args, kw)}
    return time_fused(res, "knn_plane_rows", vmap, args, kw)


def gate_phase(device="cuda") -> dict:
    """The port's accuracy gate (runtime/accuracy_gate.py) in --quick
    mode: every profile, 12 s, one seed, bags rendered on `device` into a
    temporary directory and replayed there, with the launch counters set
    to 0 just before and read just after.  Prints one line per profile
    (the gate's record, the backend's launches, the dense-grid steps, the
    expected launches) and one with the checks.  Fails when a quick check
    fails, a profile's launches differ from `gate_expected` (any entry),
    the backend's differ from its expected count, or a plain kNN runs on
    CUDA.  Then holds each fused entry at the gate's new shapes
    (`GATE_SHAPES`) against its plain version and times it."""
    import tempfile

    caps, min_neighbors, lines, bad = {}, {}, {}, []

    def runner(name, kw):
        cfg = gate.profile_config(kw["yaml_path"], kw["cache_association"],
                                  kw["wire_quantization"])
        init = cfg.odometry_options.init_num_frames
        with StepWatch() as watch, cuda_knn_calls() as knn_calls, \
                BackendLaunches() as backend, \
                contextlib.ExitStack() as stack:
            for shape, want in GATE_SHAPES.items():
                if want["profile"] == name:
                    min_neighbors[shape] = cfg.icp.min_number_neighbors
                    caps[shape] = stack.enter_context(Capture(
                        want["entry"], lambda a, k, w=want: (
                            watch.update == w["update"]
                            and watch.frame >= max(w["frame"], init)
                            and w["dense"] in (None, watch.dense))))
            rec = gate.run_profile(**kw)
        n_verified = (backend.backend.n_verified
                      if backend.backend is not None else 0)
        want, want_backend = gate_expected(rec, kw["cache_association"],
                                           backend.launches, n_verified)
        line = {"phase": "gate", "profile": name, **rec,
                "backend_launches": backend.launches,
                "verified_candidates": n_verified,
                "dense_steps": watch.dense_steps,
                "expected_launches": want,
                "plain_knn_calls_on_cuda": knn_calls.n}
        emit(line)
        lines[name] = line
        if rec["launches"] != want:
            bad.append(f"{name}: launches {rec['launches']}, expected {want}")
        if backend.launches["knn_plane_assoc"] != want_backend:
            bad.append(f"{name}: the backend launched knn_plane_assoc "
                       f"{backend.launches['knn_plane_assoc']} times, "
                       f"expected {want_backend}")
        if knn_calls.n:
            bad.append(f"{name}: {knn_calls.n} plain kNN calls on CUDA")
        if not rec["frames"] <= rec["iekf_updates"] <= 2 * rec["frames"]:
            bad.append(f"{name}: {rec['iekf_updates']} IEKF updates in "
                       f"{rec['frames']} frames")
        return rec

    plane_fit.reset_launches()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        report = gate.run_gate(quick=True, cache=d, device=device,
                               runner=runner)
        seconds = time.perf_counter() - t0
    launches = dict(plane_fit.launches)
    checks = report["checks"]
    out = {"phase": "gate", "checks": checks, "all_pass": report["all_pass"],
           "seconds": seconds,
           "replay_seconds": sum(v.get("wall_s", 0.0)
                                 for v in report["profiles"].values()),
           "launches": launches}
    emit(out)
    failed = [k for k, v in checks.items() if not v]
    if failed:
        bad.append(f"quick checks failed: {failed}")
    missing = [k for k in GATE_SHAPES if caps.get(k) is None
               or caps[k].args is None]
    if missing:
        bad.append(f"no call captured at the shapes {missing}")
    if bad:
        raise AssertionError("gate phase: " + "; ".join(bad))
    shapes = {}
    for name, want in GATE_SHAPES.items():
        if want["entry"] == "knn_plane_rows":
            res = rows_shape(name, caps[name])
        else:
            res = assoc_shape(name, caps[name], min_neighbors[name], True)
        res["profile"] = want["profile"]
        res["launches"] = lines[want["profile"]]["launches"][want["entry"]]
        shapes[name] = res
    caps.clear()
    emit({"phase": "fused_vs_plain", "gate": shapes})
    return {"profiles": lines, "launches": launches, "shapes": shapes,
            "report": report}


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
    meas = bench.cut_all(pipe, sim)
    log = {"first_state": None, "sweeps": [], "frame_ids": [], "gyr": [],
           "seconds": []}
    orig = pipe.engine.step

    def step(state, vmap, sweep, frame_id, prev_poses=None, gyr_rate=0.0):
        if log["first_state"] is None:
            log["first_state"] = eskf_mod.map_state(torch.clone, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(state, vmap, sweep, frame_id, prev_poses=prev_poses,
                   gyr_rate=gyr_rate)
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


def assoc_shape(name: str, cap: "Capture", min_neighbors: int,
                flat_floor: bool) -> dict:
    """`knn_plane_assoc` against its plain version at a captured shape (a
    captured map and rows), timed as the other shapes are; the normal
    held on the rows with `min_neighbors` neighbours (at least a tenth of
    all rows), a2d on those not flat to rounding (`FLAT_FLOOR`) where
    `flat_floor`."""
    vmap, (world, valid, thr), kw = cap.args_on(torch.device("cuda"))
    pair = fused_assoc_pair(vmap, world, valid, thr, kw)
    rows = pair[4] >= min_neighbors
    firm = rows & (flatness(vmap, world, thr, kw)[:rows.shape[0]]
                   >= FLAT_FLOOR) if flat_floor else rows
    res = {"shape": name, "q": world.shape[0], "m": kw["max_neighbors"],
           "nb_voxels": kw["nb_voxels"], "n_valid": int(valid.sum()),
           "map_capacity": vmap.counts.shape[0],
           "rows_held": int(rows.sum()), "rows_a2d_held": int(firm.sum())}
    res["max_abs_err"] = hold_assoc(kw, pair, rows, firm,
                                    math.ceil(0.1 * rows.shape[0]))
    return time_fused(res, "knn_plane_assoc", vmap, (world, valid, thr), kw)


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
    shapes = {"k4": assoc_shape("iekf_k4", k4_cap,
                                cfg.icp.min_number_neighbors, False),
              "ba": assoc_shape("ba_w", ba_cap, 8, True)}
    emit({"phase": "fused_vs_plain", "sharded": shapes})
    return {"a": a, "b": b, "shapes": shapes}


# ---------------------------------------------------------------------------
# Phase scaling: the port's scaling bench on the card
# ---------------------------------------------------------------------------

# The JAX script's record keys (scripts/scaling_bench.py:413-451, its
# `ici_bw_gbs` renamed `link_bw_gbs`), which the port's record must carry.
SCALING_KEYS = {
    None: ("backend", "physical_cores", "step_ms_single_chip",
           "step_ms_pershard", "step_ms_pershard_weak",
           "step_ms_virtual_wall", "route_overflow_real_mesh_weak8",
           "replicated_ms", "replicated_fraction", "comm_model",
           "efficiency_strong", "efficiency_weak", "stage_profile_weak8_ms",
           "stage_profile_strong8_ms", "saturating_weak_8", "note"),
    "comm_model": ("link_bw_gbs", "latency_per_collective_us",
                   "comm_ms_strong_8"),
    "saturating_weak_8": ("per_chip_workload", "step_ms_single_chip_8x",
                          "step_ms_pershard", "comm_ms", "efficiency"),
}
# The kernel's new shapes: the run (a `run_bench` runner name) whose
# `knn_plane_assoc` call is captured, and which call: the last step of the
# run's untimed first pass (one association a step; 8 sweeps, 4 in the
# saturating per-rank run).
SCALING_SHAPES = {
    "single_8x": dict(run="single8x", call=7),        # Q 8192, 2^19 slots
    "pershard_weak8": dict(run="weak8", call=7),      # K4 ~ 2.1K
    "pershard_saturating": dict(run="weak64", call=3),  # K4 ~ 16.4K, 2^20
}


def nth_call(k: int):
    """A Capture `want` that takes the k-th call (0-based)."""
    seen = [0]

    def want(args, kw):
        seen[0] += 1
        return seen[0] == k + 1
    return want


def _engine_counts(launches: dict):
    """(name, counts) of every engine of the record's `launches` (a rank
    run is a list, one counts dict per rank)."""
    for name, c in launches.items():
        for i, one in enumerate(c if isinstance(c, list) else [c]):
            yield (f"{name}[{i}]" if isinstance(c, list) else name), one


def scaling_checks(rec: dict, launched: dict) -> list:
    """The phase's bars: every JAX key; every time finite and positive
    (a stage difference finite: noise can put a prefix below the one
    before it); no routing overflow over 8 real ranks; the strong-1 proxy
    on the single-device trajectory within SHARDED_POS; in every engine
    `knn_plane_assoc` once per IEKF update and no other entry; the
    parent's launches the sum of its engines'; the collectives of a
    steady sweep as modeled."""
    fails = [f"missing {k!r} in {sec or 'the record'}"
             for sec, keys in SCALING_KEYS.items()
             for k in keys if k not in (rec[sec] if sec else rec)]
    sat = rec["saturating_weak_8"]
    times = ([rec["step_ms_single_chip"], rec["replicated_ms"],
              rec["comm_model"]["comm_ms_strong_8"],
              rec["comm_model"]["latency_per_collective_us"],
              sat["step_ms_single_chip_8x"], sat["step_ms_pershard"],
              sat["comm_ms"]]
             + [t for k in ("step_ms_pershard", "step_ms_pershard_weak",
                            "step_ms_virtual_wall")
                for t in rec[k].values()]
             + [rec[k]["prefix_total_ms"] for k in (
                 "stage_profile_weak8_ms", "stage_profile_strong8_ms")])
    if not all(math.isfinite(t) and t > 0 for t in times):
        fails.append(f"a time is not finite and positive: {times}")
    stages = [v for k in ("stage_profile_weak8_ms", "stage_profile_strong8_ms")
              for v in rec[k].values()]
    if not all(math.isfinite(t) for t in stages):
        fails.append("a stage time is not finite")
    if sorted(rec["step_ms_virtual_wall"]) != sorted(scaling_bench.WALL_N):
        fails.append(f"walls at {sorted(rec['step_ms_virtual_wall'])}")
    ovf = rec["route_overflow_real_mesh_weak8"]
    if not ovf or any(ovf) or len(rec["launches"]["overflow8"]) != 8:
        fails.append(f"route_overflow over 8 real ranks: {ovf}")
    if not rec["strong1_vs_single_max_gap_m"] <= SHARDED_POS:
        fails.append(f"strong1 proxy {rec['strong1_vs_single_max_gap_m']} m "
                     "from the single-device trajectory")
    parent = dict.fromkeys(launched, 0)
    for name, c in _engine_counts(rec["launches"]):
        others = {k: v for k, v in c.items()
                  if k not in ("knn_plane_assoc", "iekf_updates") and v}
        if (c["knn_plane_assoc"] != c["iekf_updates"]
                or not c["iekf_updates"] or others):
            fails.append(f"{name}: {c}")
        if not (name.startswith("wall") or name.startswith("overflow")):
            for k in parent:
                parent[k] += c[k]
    if parent != launched:
        fails.append(f"the run launched {launched}, its engines {parent}")
    counted = dict(rec["comm_model"]["collectives_counted_strong8_steady"])
    counted.pop("iekf_iterations")
    if counted != rec["comm_model"]["collectives_modeled"]:
        fails.append(f"collectives counted {counted}, modeled "
                     f"{rec['comm_model']['collectives_modeled']}")
    return fails


def scaling_phase() -> dict:
    """The port's scaling bench on the card (scaling_bench.run_bench, its
    record written to output/SCALING_torch.json), with the launch counters
    set to 0 just before and read just after and each new shape's
    `knn_plane_assoc` call captured; then the kernel against its plain
    version, timed and bounded, at those shapes."""
    caps = {name: Capture("knn_plane_assoc", nth_call(s["call"]))
            for name, s in SCALING_SHAPES.items()}
    by_run = {s["run"]: caps[name] for name, s in SCALING_SHAPES.items()}

    def runner(name, fn):
        if name not in by_run:
            return fn()
        with by_run[name]:
            return fn()

    t0 = time.perf_counter()
    plane_fit.reset_launches()
    updates0 = lio.counts["updates"]
    with cuda_knn_calls() as knn_calls:
        rec = scaling_bench.run_bench("cuda", runner=runner)
    launched = dict(plane_fit.launches,
                    iekf_updates=lio.counts["updates"] - updates0)
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(scaling_bench.DEFAULT_OUT), exist_ok=True)
    with open(scaling_bench.DEFAULT_OUT, "w") as f:
        json.dump(rec, f, indent=2)
    emit({"phase": "scaling", "seconds": seconds, "launched": launched,
          "plain_knn_calls_on_cuda": knn_calls.n, **rec})
    fails = scaling_checks(rec, launched)
    if knn_calls.n:
        fails.append(f"plain kNN called {knn_calls.n} times on the card")
    missing = [name for name, cap in caps.items() if cap.args is None]
    if missing:
        fails.append(f"no call captured at the shapes {missing}")
    if fails:
        raise AssertionError("scaling: " + "; ".join(fails))
    # a2d on the rows not flat to rounding (FLAT_FLOOR), as at the BA
    # shape: among the 8K-16K rows of these shapes some patches are thin
    # enough that a2d differs between float32 summation orders
    min_nb = scaling_bench.base_cfg().icp.min_number_neighbors
    shapes = {name: assoc_shape(name, cap, min_nb, True)
              for name, cap in caps.items()}
    for name, cap in caps.items():
        # the launch with no valid row: what is left is every block's
        # count of the valid prefix over all Q rows (plane_fit.cu's
        # knn_plane_assoc_kernel) and the zeroed outputs
        vmap, (world, valid, thr), kw = cap.args_on(torch.device("cuda"))
        none = torch.zeros_like(valid)
        shapes[name]["prefix_only_ms"] = graph_ms(
            lambda: plane_fit.knn_plane_assoc_cuda(vmap, world, none, thr,
                                                   **kw))
        del vmap
    caps.clear()
    torch.cuda.empty_cache()
    emit({"phase": "fused_vs_plain", "scaling": shapes})
    return {"record": rec, "launched": launched, "shapes": shapes}


# ---------------------------------------------------------------------------
# Phase bench: the port's throughput bench on the card
# ---------------------------------------------------------------------------

def bench_phase() -> dict:
    """The port's throughput bench (`bench.run_bench`, the port of
    bench.py) on `cuda` with the host-mode calibration, on bench.py's 40 s
    simulation (rendered on the card into a temporary cache), with the
    launch counters set to 0 just before and read just after and the
    plain-kNN spy on.  The last `knn_plane_assoc` call of the timed
    chunks (the last timed sweep's association) is captured and the
    kernel held against its plain version there."""
    import tempfile
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        sim = bench.load_sim(cache_dir=d, device="cuda")
    sim_seconds = time.perf_counter() - t_phase
    cap = LastCapture("knn_plane_assoc")

    def runner(name, fn):
        if not name.startswith("chunk"):
            return fn()
        with cap:
            return fn()

    plane_fit.reset_launches()
    with cuda_knn_calls() as knn_calls:
        t0 = time.perf_counter()
        rec, pipe = bench.run_bench(bench.make_cfg(), sim, "cuda",
                                    runner=runner)
        seconds = time.perf_counter() - t0
    launches = dict(plane_fit.launches)
    recs = pipe.records
    n_fail = sum(1 for r in recs if not r.success)
    ts, ps, _ = pipe.trajectory()
    ate = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
    cal = rec["calibration_rates"] or {}
    out = {"phase": "bench", "record": rec, "bench_seconds": seconds,
           "sim_seconds": sim_seconds, "images": len(sim.images),
           "frames": len(recs), "ate_m": ate, "failed_registrations": n_fail,
           "launches": launches, "plain_knn_calls_on_cuda": knn_calls.n,
           "stages_host_ms": {k: v["mean_ms"]
                              for k, v in pipe.timers.report().items()}}
    bad = []
    if not ate < 0.05 or n_fail > 2:
        bad.append(f"ATE {ate} m, {n_fail} failed registrations")
    if launches["knn_plane_assoc"] != len(recs):
        bad.append(f"knn_plane_assoc launched {launches['knn_plane_assoc']} "
                   f"times in {len(recs)} frames")
    others = {k: v for k, v in launches.items()
              if k != "knn_plane_assoc" and v}
    if others or knn_calls.n:
        bad.append(f"the bench launched {others} and called the plain kNN "
                   f"{knn_calls.n} times on CUDA")
    rates = rec["chunk_rates"]
    if len(rates) != bench.N_CHUNKS or not all(r > 0 for r in rates):
        bad.append(f"chunk rates {rates}")
    if set(cal) != set(bench.HOST_MODES) or (
            rec["host_mode"] != max(cal, key=cal.get)):
        bad.append(f"host mode {rec['host_mode']} from calibration {cal}")
    if cap.args is None:
        bad.append("no knn_plane_assoc call captured in the timed chunks")
    out["phase_seconds"] = time.perf_counter() - t_phase
    emit(out)
    if bad:
        raise AssertionError("bench phase: " + "; ".join(bad))
    del pipe
    # a2d on the rows not flat to rounding (FLAT_FLOOR), as at the gate's
    # and the scaling bench's shapes
    out["shape"] = assoc_shape("bench_last_sweep", cap,
                               bench.make_cfg().icp.min_number_neighbors,
                               True)
    cap.args = None
    torch.cuda.empty_cache()
    emit({"phase": "fused_vs_plain", "bench": out["shape"]})
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=["profile", "livo", "longrun",
                                           "resume", "replay", "sharded",
                                           "scaling", "bench", "gate",
                                           "graphs"],
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
    if only == "gate":
        kernels.build("plane_fit")
        gate_phase()
        print(smi, flush=True)
        return 0
    if only == "scaling":
        kernels.build("plane_fit")
        scaling_phase()
        print(smi, flush=True)
        return 0
    if only == "bench":
        kernels.build("plane_fit")
        bench_phase()
        print(smi, flush=True)
        return 0
    if only in ("livo", "longrun", "resume", "graphs"):
        lsim, render_ms = livo_sim()
        if only == "graphs":
            kernels.build("plane_fit")
            graphs_phase(synthetic.simulate(
                duration=20.0, n_azimuth=256, n_rings=32, imu_rate=200.0,
                seed=3), lsim)
        elif only == "livo":
            livo_phase(lsim, render_ms, bench.make_cfg())
        elif only == "longrun":
            caps = longrun_phase(lsim, bench.make_cfg())[1]
            emit({"phase": "fused_vs_plain",
                  "backend": backend_fused_phase(caps)})
        else:
            resume_phase(lsim, bench.make_cfg())
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
    scaling = scaling_phase()
    benched = bench_phase()
    lsim, render_ms = livo_sim()
    livo = livo_phase(lsim, render_ms, bench.make_cfg())
    graphed = graphs_phase(sim, lsim)
    longrun, caps = longrun_phase(lsim, bench.make_cfg())
    backend = backend_fused_phase(caps)
    caps.clear()
    emit({"phase": "fused_vs_plain", "backend": backend})
    resume_phase(lsim, bench.make_cfg())
    replay = replay_phase()
    demo_phase()
    gated = gate_phase()

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
            "launches_gate": gated["launches"][name],
            "launches_bench": benched["launches"][name],
            "launches_graphs": graphed["lio_assoc" if cache
                                       else "lio_search"]["launches"][name],
            "captured": CAPTURED[name],
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
    summary[0]["launches_scaling"] = scaling["launched"]["knn_plane_assoc"]
    summary[0]["scaling_shapes"] = scaling["shapes"]
    summary[0]["bench_shape"] = benched["shape"]
    summary[1]["rows_in_program"] = graphed["lio_search"]["rows_in_program"]
    for entry in summary[:2]:
        entry["gate_shapes"] = {
            k: v for k, v in gated["shapes"].items()
            if GATE_SHAPES[k]["entry"] == entry["name"]}
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
