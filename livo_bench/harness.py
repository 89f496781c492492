"""One run of one cell: set-up, the measured window, the traced numbers
and the check.

A cell (`BENCHMARK.json` `workloads`) names a configuration
(`configs/<name>.json`: the YAML profile and every override of the
deployment) and a traffic mix (`traffic/<name>.json`).  The run

  1. makes the traffic from the seed (`gen/traffic.py`) and frees what
     making it took from the card, then resets the card's peak memory;
  2. builds the program (`LivoPipeline` with its `VisionModule`) and
     warms it up through the entry the window drives, closed loop: past
     the IMU's static initialization,
     `init_num_frames + 2` initialized frames with at least 3 rendered,
     `after_init_s` seconds of stream after the initialization (both
     keypoint variants of the LIO step run by then) and `laps` laps;
  3. measures for `seconds`: one frame in flight.  A frame's messages are
     handed over (`push_imu`, `push_points`, `push_image`), the frames
     that can be cut are processed (`process_available`), and the frame's
     poses are read to the host (`records`) before the next frame is
     handed over.  Where the LiDAR runs faster than the camera, a frame
     yields several sweeps (gap-fill sweeps without an image before the
     image-aligned one), and each sweep's pose counts.  A frame's time
     runs from its hand-over to its last pose on the host;
  4. reads the peak memory, and with `trace` the per-layer numbers;
  5. frees the program and checks segments of the window's frames
     against the plain reference, and the window's poses against the
     ground truth (`check.py`).

`setup_s` runs from process start to the first timed hand-over.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from livo_bench import check, snapshot
from livo_bench.gen import traffic as traffic_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "sr_livo_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: str = ROOT) -> tuple:
    """(workload entry, configuration, mix, limits) of a cell, found by
    the names in BENCHMARK.json."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(os.path.join(root, conf["file"]))
    mix = load_json(os.path.join(BENCH_DIR, "traffic",
                                 wl["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH_DIR, "limits", workload + ".json"))
    return wl, config, mix, limits


def metric_names(workload: str, kind: str, root: str = ROOT) -> list:
    """The `end_to_end` or `per_layer` metrics BENCHMARK.json gives the
    cell (a metric with a `workloads` list only in those)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def make_config(spec: dict, load_config):
    """The deployment's LivoConfig through `load_config` (the port's or
    the reference's): the YAML profile, then each override."""
    cfg = load_config(spec["yaml"])
    for path, value in spec["overrides"].items():
        target = cfg
        parts = path.split(".")
        for p in parts[:-1]:
            target = getattr(target, p)
        if not hasattr(target, parts[-1]):
            raise KeyError(f"no configuration key {path}")
        setattr(target, parts[-1], value)
    return cfg


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


class RecordingTimers:
    """A drop-in for the pipeline's `StageTimers` with `sync` on that also
    keeps each call: (frame, stage, seconds)."""

    def __init__(self, base_cls, device):
        self.base = base_cls(sync=True, device=device)
        self.calls: list = []
        self.frame = -1

    def __getattr__(self, name):
        return getattr(self.base, name)

    @contextlib.contextmanager
    def stage(self, name: str):
        # a profiler range too, which names the device's idle gaps
        t0 = time.perf_counter()
        with torch.autograd.profiler.record_function(
                "livo_bench.stage." + name), self.base.stage(name):
            yield
        self.calls.append((self.frame, name, time.perf_counter() - t0))


@dataclass
class Traced:
    """What the traced run hands the per-layer metric readers."""
    timer_calls: list = field(default_factory=list)  # (frame, stage, s)
    step_stages: list = field(default_factory=list)  # {stage: device ms}
    roofline: list = field(default_factory=list)     # (bound_ms, kernel_ms)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


def all_programs(pipe) -> list:
    """Every captured program the pipeline holds."""
    out = []
    for owner in (pipe, pipe.engine, pipe.vision):
        for name in ("programs", "insert_programs"):
            d = getattr(owner, name, None) if owner is not None else None
            if isinstance(d, dict):
                out.extend(d.values())
    return out


def n_captures(pipe) -> int:
    return sum(getattr(p, "captures", 0) for p in all_programs(pipe))


def frame_class(dense: bool, rendered: bool) -> str:
    """The costliest thing a frame did: the dense keypoint variant, a
    rendered image or neither."""
    if dense:
        return "dense"
    return "rendered" if rendered else "plain"


STEP_RANGE = "livo_bench.stage.lio_step"


class Roofline:
    """The plane kernel's launches in sampled frames, taken as
    `chip_smoke.py::LastCapture` takes them (at f22c487785a4): before each
    LIO step program's call in a sampled frame, its state and inputs are
    cloned on the card (a copy on the card costs the traced frame far less
    than one to the host); after the window its function runs once on the
    clones in capture form (each loop round and both branches) with the
    kernel's entries spied, and each launch's inputs are counted by
    `gen/roofline.py` in order.  A graph with conditional nodes launches
    only the rounds and branches that ran, so `pair_roofline` matches each
    call's spied launches with the kernels the trace shows for it, by
    entry."""

    ENTRIES = ("knn_plane_assoc", "knn_plane_rows")

    def __init__(self):
        self.samples: list = []     # (frame, program, state, inputs)
        self.frame = None           # the sampled frame, or None
        self._orig = None

    def __enter__(self):
        from sr_livo_tpu_torch.utils import graphs
        orig = self._orig = graphs.Program.__call__

        def call(prog):
            if self.frame is not None and prog.name.startswith("lio_step"):
                self.samples.append((self.frame, prog, graphs.tree_map(
                    torch.clone, prog.state), graphs.tree_map(
                        torch.clone, prog.inputs)))
            return orig(prog)
        graphs.Program.__call__ = call
        return self

    def __exit__(self, *exc):
        from sr_livo_tpu_torch.utils import graphs
        graphs.Program.__call__ = self._orig

    def bounds(self) -> List[tuple]:
        """Per sampled call, in order: (frame, [(entry, bound ms) of each
        launch in order])."""
        from livo_bench.gen.roofline import fused_bound_ms
        from sr_livo_tpu_torch.ops import plane_fit
        from sr_livo_tpu_torch.utils import graphs

        out = []
        for frame, prog, state, inputs in self.samples:
            seen: list = []
            origs = {e: getattr(plane_fit, e) for e in self.ENTRIES}

            def spy(entry):
                def f(vmap, *args, **kw):
                    seen.append((entry, fused_bound_ms(
                        vmap, args[0], args[-2], args[-1], kw, entry)[0]))
                    return origs[entry](vmap, *args, **kw)
                return f
            try:
                for e in self.ENTRIES:
                    setattr(plane_fit, e, spy(e))
                with graphs.counts_kept(), graphs.capture_form():
                    prog.fn(state, inputs)
            finally:
                for e, f in origs.items():
                    setattr(plane_fit, e, f)
            out.append((frame, seen))
        return out


def read_profile(prof, roof: "Roofline", traced: Traced) -> None:
    """Into `traced`: the device's busy and window seconds and the
    breakdown of the profiled frames, and the sampled calls' plane kernel
    launches paired with their bounds."""
    from livo_bench.gen import profile as gp

    dev_ev, host_ev = gp.split(prof.events())
    lo, hi = next((a, b) for a, b, n in host_ev if n == "livo_bench.window")
    busy_us, gaps = gp.busy(dev_ev, lo, hi)
    traced.busy_s, traced.window_s = busy_us / 1e6, (hi - lo) / 1e6
    traced.breakdown = {"device_ops": gp.top_ops(dev_ev, lo, hi),
                        "idle_gaps": gp.idle_gaps(host_ev, gaps)}
    traced.roofline.extend(pair_roofline(roof.bounds(), dev_ev, host_ev))


def pair_roofline(calls: List[tuple], dev_ev: list, host_ev: list
                  ) -> List[tuple]:
    """(bound ms, kernel ms) of each sampled launch that the trace shows.
    `calls` are `Roofline.bounds()`: (frame, [(entry, bound ms)]) of each
    sampled LIO step call, in order.  The i-th sampled call of frame f is
    the i-th range of stage `lio_step` inside the range of frame f: the
    synchronizing timers close the stage after the step's kernels end, so
    they start inside it.  Of an entry whose kernels the trace shows n
    times in a call, the first n spied launches pair with them in order
    (a conditional node launches the rounds and the branch that ran, which
    the masked form runs first).  A frame or a call that does not match is
    left out, with a note on standard error."""
    frames = {int(n.rsplit(".", 1)[1]): (a, b) for a, b, n in host_ev
              if n.startswith("livo_bench.frame.")}
    steps = [(a, b) for a, b, n in host_ev if n == STEP_RANGE]
    kernels = [(ka, (kb - ka) / 1e3, e) for ka, kb, n in dev_ev
               for e in Roofline.ENTRIES if e + "_kernel" in n]
    by_frame: Dict[int, list] = defaultdict(list)
    for frame, launches in calls:
        by_frame[frame].append(launches)
    out = []
    for frame, frame_calls in sorted(by_frame.items()):
        fa, fb = frames.get(frame, (0.0, -1.0))
        ranges = [(a, b) for a, b in steps if fa <= a and b <= fb]
        if len(ranges) != len(frame_calls):
            log(f"roofline: frame {frame}: {len(frame_calls)} step calls "
                f"sampled, {len(ranges)} traced; not paired")
            continue
        for k, ((a, b), launches) in enumerate(zip(ranges, frame_calls)):
            spied = {e: [bound for name, bound in launches if name == e]
                     for e in Roofline.ENTRIES}
            seen = {e: [t for ka, t, name in kernels if name == e
                        and a <= ka <= b] for e in Roofline.ENTRIES}
            if any(len(seen[e]) > len(spied[e]) for e in Roofline.ENTRIES):
                log(f"roofline: frame {frame}, call {k}: launches counted "
                    f"{ {e: len(v) for e, v in spied.items()} }, traced "
                    f"{ {e: len(v) for e, v in seen.items()} }; not paired")
                continue
            for e in Roofline.ENTRIES:
                out.extend(zip(spied[e], seen[e]))
    return out


def load_readers(names: List[str]) -> Dict[str, object]:
    """The per-layer metric readers, `metrics/<name>.py`, by name."""
    out = {}
    for name in names:
        path = os.path.join(BENCH_DIR, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "livo_bench_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: Optional[float] = None, root: str = ROOT,
        control: bool = False, spec=None, fault=None) -> dict:
    """One run of `workload`; returns the result object (see run.py).
    `control` also runs the reference at TF32 in the program's place and
    returns its numbers (a measurement, never the benchmark's own runs).
    `spec` overrides the cell found by name (the tests' tiny cells);
    `fault(pipe)` breaks the program under test (the tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    from sr_livo_tpu_torch.config import load_config
    from sr_livo_tpu_torch.models.vision import VisionModule
    from sr_livo_tpu_torch.pipeline import LivoPipeline
    from sr_livo_tpu_torch.utils import graphs
    from sr_livo_tpu_torch.utils.profiling import StageTimers

    wl, config, mix, limits = spec or cell_spec(workload, root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(traffic_mod.noise_seed(seed))
    cfg = make_config(config, load_config)

    # 1. traffic, from the seed; what making it took leaves the card
    t0 = time.perf_counter()
    tr = traffic_mod.build(mix, cfg.lidar_options, seed, device=dev)
    log(f"traffic: {len(tr.prefix)} prefix + {len(tr.lap)} lap frames "
        f"({tr.lap_s:g} s lap) in {time.perf_counter() - t0:.2f} s, "
        f"rendering {tr.render_s:.2f} s")
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # 2. the program, warmed up through the window's entry
    if trace:
        graphs.stage_events(True)
    vision = VisionModule(cfg, device=dev)
    pipe = LivoPipeline(cfg, vision=vision, device=dev)
    timers = None
    if trace:
        timers = pipe.timers = RecordingTimers(StageTimers, dev)
    if fault is not None:
        fault(pipe)

    frames = tr.frames()
    wu = mix["warm_up"]
    n_init_frames = cfg.odometry_options.init_num_frames + 2
    warm = warm_init = warm_rendered = 0
    t_init = None
    while True:
        f = next(frames)
        n_rec = len(pipe.records)
        check.feed(pipe, f)
        warm += 1
        if len(pipe.records) > n_rec:
            warm_init += 1
            t_init = f.time_image if t_init is None else t_init
            warm_rendered += int(f.rendered)
        if (pipe.initialized and warm_init >= n_init_frames
                and warm_rendered >= wu["min_rendered"]
                and f.time_image - t_init >= wu["after_init_s"]
                and warm >= len(tr.prefix) + wu["laps"] * len(tr.lap)):
            break
        if warm > len(tr.prefix) + (wu["laps"] + 2) * len(tr.lap):
            raise RuntimeError("warm-up did not reach its end")
    if cuda:
        torch.cuda.synchronize()
    # what set-up made stays: later collections scan only the window's
    gc.collect()
    gc.freeze()
    captures_warm = n_captures(pipe)
    log(f"warm-up: {warm} frames, {warm_init} posed, {warm_rendered} "
        f"rendered, {captures_warm} programs captured")

    # 3. the window
    chk = mix["check"]
    segments = check.plan(rng, chk["segments"], chk["segment_frames"],
                          chk["span_frames"])
    seg_at = {s.start: s for s in segments}
    trc = mix["trace"]
    # the profiled frames follow the checked segments
    prof_lo = max(s.start + s.length for s in segments) + trc["after_check"]
    prof_hi = prof_lo + trc["frames"]
    roof_frames = set(int(x) for x in rng.choice(
        np.arange(prof_lo, prof_hi), size=trc["roofline_frames"],
        replace=False)) if trace else set()
    traced = Traced()
    prof = prof_done = None
    roof = Roofline() if trace else None
    lat: List[float] = []
    classes: List[str] = []
    attempted = completed = failed = 0
    n_registered_fail = 0
    poses: List[int] = []        # each frame's poses
    # every pose of the window in order; a frame that yields none, None
    window_records: List[object] = []
    open_seg: List[check.Segment] = []
    paused = 0.0                 # seconds the check's copies took
    # the step programs' replays before the window (the timers synchronize,
    # so every earlier replay is logged by now)
    log_start = len(graphs.stage_log()) if trace else 0
    if roof is not None:
        roof.__enter__()
    setup_s = time.perf_counter() - t_start
    t_w0 = time.perf_counter()
    t_end = t_w0 + seconds
    i = 0
    try:
        while True:
            now = time.perf_counter()
            if now >= t_end:
                break
            f = next(frames)
            if i in seg_at:
                # the check's copy, with the window's clock stopped
                t_p = time.perf_counter()
                seg = seg_at[i]
                seg.pre = snapshot.snap(pipe)
                open_seg.append(seg)
                dt = time.perf_counter() - t_p
                paused += dt
                t_end += dt
            if trace and i == prof_lo:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                win_range = torch.autograd.profiler.record_function(
                    "livo_bench.window")
                win_range.__enter__()
            if timers is not None:
                timers.frame = i
            if roof is not None:
                roof.frame = i if i in roof_frames else None
            dense0 = getattr(pipe, "n_dense_sweeps", 0)
            n_rec = len(pipe.records)
            ctx = (torch.autograd.profiler.record_function(
                f"livo_bench.frame.{i}") if prof is not None
                else contextlib.nullcontext())
            t_due = time.perf_counter()
            with ctx:
                check.feed(pipe, f)
                recs = pipe.records       # the poses, on the host
            t_done = time.perf_counter()
            attempted += 1
            lat.append(t_done - t_due)
            new = recs[n_rec:]
            poses.append(len(new))
            if new:
                if t_done <= t_end:
                    completed += len(new)
                n_registered_fail += sum(not r.success for r in new)
            else:
                failed += 1
            frame_records = new or [None]
            window_records.extend(frame_records)
            if open_seg:
                t_p = time.perf_counter()
                for seg in list(open_seg):
                    seg.frames.append(f)
                    seg.records.extend(frame_records)
                    if len(seg.frames) == seg.length:
                        seg.post = snapshot.snap(pipe)
                        open_seg.remove(seg)
                dt = time.perf_counter() - t_p
                paused += dt
                t_end += dt
            classes.append(frame_class(
                getattr(pipe, "n_dense_sweeps", 0) > dense0, f.rendered))
            if prof is not None and i == prof_hi - 1:
                win_range.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                prof_done, prof = prof, None
            i += 1
    finally:
        if roof is not None:
            roof.__exit__(None, None, None)
        if prof is not None:         # the window closed first
            win_range.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            prof_done, prof = prof, None
        if trace:
            graphs.stage_events(False)
    window_s = time.perf_counter() - t_w0 - paused
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    if trace:
        # every LIO step replay of the window, each sweep's
        traced.step_stages = [d for name, d in graphs.stage_log()[log_start:]
                              if name.startswith("lio_step")]
    captures_window = n_captures(pipe) - captures_warm
    found = forbidden_modules()

    # 4. the frames and the traced numbers
    counts = defaultdict(int)
    for c in classes:
        counts[c] += 1
    p99 = percentile(lat, 99.0) if lat else math.nan
    beyond = [c for c, t in zip(classes, lat) if t > p99]
    tail = defaultdict(int)
    for c in beyond:
        tail[c] += 1
    log(f"checked segments start at window frames "
        f"{[s.start for s in segments]}; their copies stopped the window's "
        f"clock for {paused:.3f} s")
    log(f"window: {attempted} frames handed over, {completed} poses within "
        f"{seconds:g} s, {failed} frames never posed, {n_registered_fail} "
        f"flagged failed registrations, {captures_window} programs captured "
        f"in the window; frames by their poses: "
        f"{dict(sorted(Counter(poses).items()))}")
    log(f"frame classes: {dict(counts)}; p99 {1e3 * p99:.2f} ms, frames "
        f"beyond it: {dict(tail)}; median {1e3 * percentile(lat, 50):.2f} ms")
    if trace:
        traced.timer_calls = list(timers.calls)
        if prof_done is not None:
            read_profile(prof_done, roof, traced)

    # 5. the check, with the program freed
    gc.unfreeze()
    del pipe, vision, frames
    if roof is not None:
        roof.samples.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_chk = time.perf_counter()
    result = check_run(segments, window_records, tr, config, dev,
                       control=control)
    numbers = result["numbers"]
    log(f"check: {result['segments']} segments of {chk['segment_frames']} "
        f"frames in {time.perf_counter() - t_chk:.1f} s")
    correct = check.judge(numbers, limits) and failed == 0 and not found
    if found:
        log(f"forbidden modules loaded: {found}")
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "setup_s": setup_s, "window_s": window_s, "completed": completed,
            "latencies": lat, "poses": poses, "peak_reserved": peak,
            "traced": traced,
            "numbers": numbers, "limits": limits, "forbidden": found,
            "control": result.get("control"),
            "per_segment": result["per_segment"]}


def check_run(segments, window_records: list, tr, config: dict, dev,
              control: bool = False) -> dict:
    """The numbers of `check.py`: the reference over each finished
    segment, the largest over them, and the window's ATE; with `control`
    the control's numbers, the reference at TF32 in the program's place."""
    from livo_bench.ref.config import load_config as ref_load_config

    ref_cfg = make_config(config, ref_load_config)
    configs = {"LivoConfig": ref_cfg}
    cell = ref_cfg.map_options.min_distance_points
    per, ctl = [], []
    done = [s for s in segments if s.post is not None]
    for seg in done:
        ref = check.run_reference(seg, dev, configs)
        per.append(check.compare((seg.records, check.view(seg.post)), ref,
                                 cell))
        if control:
            ctl.append(check.compare(check.run_reference(
                seg, dev, configs, tf32=True), ref, cell))
        seg.pre = seg.post = None
    numbers = check.worst(per) if done else {}
    numbers["ate_m"] = check.ate(window_records, tr.truth)
    out = {"numbers": numbers, "segments": len(done), "per_segment": per}
    if control:
        # the control has no window of its own: the program's ATE
        out["control"] = dict(check.worst(ctl), ate_m=numbers["ate_m"])
    return out
