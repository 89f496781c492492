"""The port's benchmark: one run of one cell on the card.

    python3 -m livo_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

runs the cell named in BENCHMARK.json once (livo_bench/harness.py) and
prints its counts and the check's numbers on standard error, and as the
last line of standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1`
`breakdown`, and last `check`, each compared number with its limit.

Exits 2 without a result where CUDA is missing or the card count is short
of the cell's, and 3 where jax, flax or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def environment(root: str = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its own libraries under build/ already), and one
    intra-op CPU thread: the host side of a frame is one thread's work,
    and idle worker threads spinning beside it make runs spread."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(root, "build", sub)
    os.environ["OMP_NUM_THREADS"] = "1"


def metrics(names: list, values: dict) -> dict:
    """The metrics object: each named metric that has a value."""
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in names if values.get(m["name"]) is not None}


def result_line(workload: str, trace: bool, seconds: float, out: dict,
                card: str) -> dict:
    """The last line's object from a run's outcome (`harness.run`)."""
    from livo_bench import harness

    dev = {"platform": "gpu", "kind": card, "count": 1,
           "memory_peak_bytes": int(out["peak_reserved"])}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"]}
    traced = out["traced"]
    if trace:
        names = harness.metric_names(workload, "per_layer")
        readers = harness.load_readers([m["name"] for m in names])
        result["metrics"] = metrics(
            names, {n: r.read(traced) for n, r in readers.items()})
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["device"] = dev
        if traced.breakdown is not None:
            result["breakdown"] = traced.breakdown
    else:
        values = {
            "meas_per_s": out["completed"] / seconds,
            "frame_ms_p99": 1e3 * harness.percentile(out["latencies"], 99.0),
            "peak_mem_mib": out["peak_reserved"] / 2 ** 20,
            "setup_s": out["setup_s"]}
        result["metrics"] = metrics(
            harness.metric_names(workload, "end_to_end"), values)
        result["device"] = dev
    checked = {k: {"value": _finite(out["numbers"].get(k)), "limit": lim}
               for k, lim in out["limits"].items()}
    checked["never_posed"] = {"value": out["failed"], "limit": 0}
    result["check"] = checked
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()

    import torch

    torch.set_num_threads(1)

    from livo_bench import harness

    wl = harness.cell_spec(args.workload)[0]
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < wl["chips"]:
        print(f"{wl['chips']} cards needed, {torch.cuda.device_count()} "
              "present", file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    found = out["forbidden"] or harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3

    result = result_line(args.workload, bool(args.trace), args.seconds,
                         out, torch.cuda.get_device_name(0))
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
