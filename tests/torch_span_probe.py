"""The port's spans on the benchmark's cell, for PERF.md: the benchmark's
own closed-loop window (`livo_bench/harness.py::run`, untraced), run with
the pipeline's timers as they are and with spans on, in turns on one
seed and in one process.

    python3 tests/torch_span_probe.py [--rounds 2] [--seconds 51]
        [--seed N] [--out FILE.json] [--tiny]

Each round runs the window twice: `untimed` (the benchmark's
`--trace 0` run) and `spans`, the same run with the pipeline's timers
replaced by `StageTimers(spans=True)` before its warm-up (no
synchronize, no profiler).  Of each: frames a second and the median
frame.  Of a spans run, over the window's frames (the last root `frame`
spans, one a window frame): the mean host ms of span `frame` and of span
`records` (the host waiting for the device), the device's idle share (1
- the union of the spans' device intervals over the window's time,
`StageTimers.busy`), the longest idle gaps named by the host span over
them (`StageTimers.idle_gaps`), and the mean host, wait and device ms
(`StageTimers.per_frame`) of the frames slower and faster than the
window's median.  `--tiny` runs the benchmark tests' tiny cell on the
CPU (a rehearsal: no device number).

Once the harness runs a span phase of its own, this probe goes.
"""

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from livo_bench import harness  # noqa: E402

CELL = "r3live_odom.livo"


def window(out: dict, seconds: float) -> dict:
    lat = out["latencies"]
    return {"frames_per_s": out["completed"] / seconds,
            "median_ms": 1e3 * statistics.median(lat),
            "p99_ms": 1e3 * harness.percentile(lat, 99.0),
            "correct": out["correct"]}


def read_spans(timers, out: dict) -> dict:
    """The spans of the window's frames: the last as many root `frame`
    spans as the window handed frames over (each one posed frame)."""
    spans = timers.read_spans()
    roots = [s for s in spans if s.name == "frame"][-out["attempted"]:]
    lo = roots[0].start
    hi = max(s.end for s in spans if s.end is not None)
    per = timers.per_frame()
    rows = [per[s.frame] for s in roots]
    lat = out["latencies"]
    med = statistics.median(lat)

    def means(keep):
        ps = [p for p, t in zip(rows, lat) if keep(t)]
        return {k: statistics.fmean(p[k] for p in ps) if ps else None
                for k in ("host_ms", "wait_ms", "device_ms")}
    busy_ns, _ = timers.busy(lo, hi)
    return {
        "frame_host_ms": statistics.fmean(p["host_ms"] for p in rows),
        "host_wait_ms": statistics.fmean(p["wait_ms"] for p in rows),
        "device_ms": statistics.fmean(p["device_ms"] for p in rows),
        # the window's time leaves out the check's copies, which no span
        # covers
        "device_idle_pct": 100.0 * (1.0 - busy_ns / 1e9 / out["window_s"]),
        "gaps": timers.idle_gaps(lo, hi),
        "slower_than_median": means(lambda t: t > med),
        "faster_than_median": means(lambda t: t <= med)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seed", type=int, default=3000001701)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from livo_bench import run as bench_run
    bench_run.environment()
    torch.set_num_threads(1)

    from sr_livo_tpu_torch.utils.profiling import StageTimers

    spec, dev = None, "cuda"
    record = {"seed": args.seed, "seconds": args.seconds, "runs": []}
    if args.tiny:
        from livo_bench.tests import tiny
        spec, dev = tiny.spec(), "cpu"
    else:
        import subprocess
        record["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    for r in range(args.rounds):
        for phase in (("untimed", "spans") if r % 2 == 0
                      else ("spans", "untimed")):
            held = []

            def spans_on(pipe):
                pipe.timers = StageTimers(device=pipe.device, spans=True)
                held.append(pipe.timers)
            out = harness.run(CELL, args.seed, args.seconds, False,
                              device=dev, spec=spec,
                              fault=spans_on if phase == "spans" else None)
            row = {"phase": f"{phase}.{r}", **window(out, args.seconds)}
            if held:
                row.update(read_spans(held[0], out))
            record["runs"].append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
