"""Which torch.distributed collectives take CUDA tensors, and what they
cost: two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
card), then a world of one over NCCL.  Run on a machine with a GPU:

    python3 tests/torch_gloo_probe.py

Each rank prints one JSON line: per collective "ok" with its host ms
(synchronised) or "refused" with the error; the all-reduce of 1024
int32 and the all-to-all of (ranks, 800, 5) float32 (the sharded
engine's sizes) are timed over 50 calls after 5.  Imports torch only.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist


def _timed(fn, reps=1, warmup=0):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps * 1e3


def probe(tag: str) -> dict:
    dev = torch.device("cuda", 0)
    r, n = dist.get_rank(), dist.get_world_size()

    def all_reduce(dtype):
        x = torch.arange(8, device=dev, dtype=dtype) + r
        dist.all_reduce(x)
        return x.tolist()

    def all_to_all():
        x = (torch.arange(n * 3, device=dev, dtype=torch.float32)
             + 100 * r).reshape(n, 3)
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return y.tolist()

    def all_gather_list():
        out = torch.empty((n, 2), device=dev)
        dist.all_gather(list(out.unbind(0)), torch.full((2,), float(r),
                                                        device=dev))
        return out.tolist()

    def all_gather_into_tensor():
        out = torch.empty((n, 2), device=dev)
        dist.all_gather_into_tensor(out, torch.full((2,), float(r),
                                                    device=dev))
        return out.tolist()

    big_i = torch.zeros(1024, dtype=torch.int32, device=dev)
    big_x = torch.zeros((n, 800, 5), device=dev)
    big_y = torch.empty_like(big_x)
    cases = {
        "all_reduce_f32": lambda: all_reduce(torch.float32),
        "all_reduce_i32": lambda: all_reduce(torch.int32),
        "all_reduce_i64": lambda: all_reduce(torch.int64),
        "all_to_all_single": all_to_all,
        "all_gather_list": all_gather_list,
        "all_gather_into_tensor": all_gather_into_tensor,
    }
    out = {"tag": tag, "rank": r, "ranks": n}
    for name, fn in cases.items():
        try:
            value, ms = _timed(fn)
            out[name] = ["ok", value, ms]
        except (RuntimeError, ValueError) as e:
            out[name] = ["refused", repr(e)[:300]]
    out["all_reduce_1024_i32_ms"] = _timed(
        lambda: dist.all_reduce(big_i), 50, 5)[1]
    out["all_to_all_800x5_f32_ms"] = _timed(
        lambda: dist.all_to_all_single(big_y, big_x), 50, 5)[1]
    return out


def main() -> int:
    if len(sys.argv) > 1:                      # one gloo rank
        rank, workdir = int(sys.argv[1]), sys.argv[2]
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(workdir, "store2"), 2), rank=rank, world_size=2)
        print(json.dumps(probe("gloo, 2 ranks on cuda:0")), flush=True)
        dist.destroy_process_group()
        return 0
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   str(r), d]) for r in range(2)]
        rcs = [p.wait(timeout=300) for p in procs]
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store1"), 1), rank=0, world_size=1)
        print(json.dumps(probe("nccl, world of one")), flush=True)
        dist.destroy_process_group()
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
