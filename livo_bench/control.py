"""The readings that the check's limits are set from, on the card.

    python3 -m livo_bench.control --workload <cell> --seeds 1,2,3
        --seconds <s> [--control 1] [--out FILE]

For each seed, one run of the cell (`harness.run`, one process, so the
set-up after the first is short), printing one JSON line: the compared
numbers of the program against the plain reference and, with
`--control 1`, those of the control, the reference at TF32 in the
program's place (`check.py`), and `control_correct`, the control judged
by the cell's limits as a run is, which has to be false.  The
benchmark's own runs never run the control.  With `--out` the lines are
also appended to FILE.
"""

import argparse
import json
import math
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from livo_bench.run import environment

    environment()

    import torch

    from livo_bench import check, harness

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2

    def clean(d):
        return None if d is None else {
            k: (v if math.isfinite(v) else None) for k, v in d.items()}

    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run(args.workload, seed, args.seconds, False,
                          control=bool(args.control))
        line = json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"],
            "meas_per_s": out["completed"] / args.seconds,
            "numbers": clean(out["numbers"]),
            "per_segment": [clean(d) for d in out["per_segment"]],
            "control": clean(out["control"]),
            "control_correct": (None if out["control"] is None else
                                check.judge(out["control"], out["limits"])),
            "card": torch.cuda.get_device_name(0)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
