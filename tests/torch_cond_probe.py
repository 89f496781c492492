"""Probe of CUDA graph conditional nodes as the port builds them by hand.

Run on a CUDA machine: `python3 tests/torch_cond_probe.py`.  Prints one
JSON object:

  * the PyTorch and CUDA runtime versions, and whether
    `torch.cuda.CUDAGraph` has PyTorch's own if-node API (PyTorch 2.11, the
    build the port is measured with, has none);
  * whether `csrc/graph_cond.cu` builds (`kernels.load`) and the allocator
    hooks its pool routing uses exist;
  * whether a `graphs.Program` whose function runs a bounded loop of the
    LIO step's op kinds (stable sorts, scatter-min, cumsum/cummax, index
    writes, `inv_ex`, selects, a nested `graphs.cond`) through
    `graphs.while_loop` captures with WHILE and IF nodes, and replays to
    the function's eager bits and to the masked program's at several trip
    counts; the node types of its bodies (no host, event or allocation
    node); the pool's growth against the masked program's;
  * the device ms of a replay at 0, 3 and all rounds taken, in the
    conditional and the masked form: what a skipped and a taken round
    cost;
  * the plane kernel's fused association inside an IF node, against its
    eager result;
  * whether timing events recorded inside a graph
    (`torch.cuda.Event(external=True)`, what `utils.graphs.mark` records)
    time a replay.

`python3 tests/torch_cond_probe.py --step [--seed N] [--seconds S]`
instead runs the benchmark's cell (`livo_bench/harness.py::run`, traced,
so the step program records its ranges and device counts) and prints its
steady step program: the graph's nodes, each conditional body's, and the
mean device ms of each range over the window's replays.  A checkout from
before the conditional nodes prints no bodies.

Exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sr_livo_tpu_torch import kernels                      # noqa: E402
from sr_livo_tpu_torch.utils import graphs                 # noqa: E402

API = ("get_currently_capturing_graph", "begin_capture_to_if_node",
       "end_capture_to_conditional_node")
POOL_HOOKS = ("_cuda_beginAllocateCurrentThreadToPool",
              "_cuda_endAllocateToPool", "_cuda_releasePool")
R = 9            # the loop's bound
N = 8192         # rows a round sorts
TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
         5: "empty", 6: "event_wait", 7: "event_record", 10: "mem_alloc",
         11: "mem_free", 13: "conditional"}


def round_ops(carry, masked=False):
    """One round over (h, pri, mat, acc, rounds, nested, target, go): every
    op kind of the LIO step, its results kept where `go` holds."""
    h, pri, mat, acc, rounds, nested, target, go = carry
    dev = h.device
    h64 = h.to(torch.int64)
    order = torch.sort((h64 << 32) | pri.to(torch.int64), stable=True).indices
    tbl = torch.full((1025,), 0x7FFFFFFF, dtype=torch.int32, device=dev)
    tbl.scatter_reduce_(0, h64 & 1023, h, "amin")
    cm = torch.cummax(torch.cumsum(h64 & 7, 0), 0).values
    sink = torch.zeros(N + 1, dtype=torch.int64, device=dev)
    sink.index_put_((order,), cm)
    m = torch.linalg.inv_ex(mat + torch.eye(17, device=dev))[0]
    mat = torch.where(go, m * 0.5, mat)
    acc = torch.where(go, acc + sink[:N] + tbl[h64 & 1023].to(torch.int64),
                      acc)
    rounds = rounds + go.to(torch.int64)
    nested = graphs.cond(go & (rounds > 2), lambda _active: nested + 1,
                         nested, masked=masked)
    go = go & (rounds < target)
    return h, pri, mat, acc, rounds, nested, target, go


def loop_fn(masked):
    def fn(state, inputs):
        (target,) = inputs
        rounds = torch.zeros((), dtype=torch.int64, device=target.device)
        carry = (*state, rounds, torch.zeros_like(rounds), target,
                 rounds < target)
        out = graphs.while_loop(
            lambda c: c[-1], lambda c: round_ops(c, masked), carry, R,
            masked=masked)
        return state, out[2:6]
    return fn


def fresh(dev):
    g = torch.Generator().manual_seed(0)
    return (torch.randint(0, 1 << 30, (N,), generator=g,
                          dtype=torch.int32).to(dev),
            torch.randperm(N, generator=g).to(torch.int32).to(dev),
            torch.rand((17, 17), generator=g).to(dev),
            torch.zeros(N, dtype=torch.int64, device=dev))


def build_report():
    rec = {}
    try:
        rec["build_log_tail"] = kernels.build("graph_cond")[-600:]
        graphs._cond_lib()
        rec["built"] = True
    except Exception as e:                              # noqa: BLE001
        rec["built"] = False
        rec["build_error"] = repr(e)[-2000:]
    return rec


def device_ms(prog, reps=30):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    prog()
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        prog()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def loop_report(dev):
    rec = {}
    progs = {}
    for form, masked in (("conditional", False), ("masked", True)):
        st = fresh(dev)
        target = torch.full((), R, dtype=torch.int64, device=dev)
        prog = graphs.Program(loop_fn(masked), st, (target,), name=form)
        r0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        prog()
        torch.cuda.synchronize()
        rec[form] = {"capture_s": time.perf_counter() - t0,
                     "nodes": prog.nodes,
                     "body_nodes": [graphs.graph_nodes(b)
                                    for b in prog.bodies],
                     "reserved_growth_mib":
                         (torch.cuda.memory_reserved() - r0) / 2**20}
        progs[form] = prog
    cond = progs["conditional"]
    kinds = {}
    for b in cond.bodies:
        for t in graphs.node_types(b):
            kinds[TYPES.get(t, str(t))] = kinds.get(TYPES.get(t, str(t)),
                                                   0) + 1
    rec["body_node_types"] = kinds
    checks = {}
    for target in (0, 1, 3, R):
        got = {}
        for form, prog in progs.items():
            prog.inputs[0].fill_(target)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = prog()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got[form] = graphs.tree_map(torch.clone, out)
        torch.cuda.synchronize()
        eager = loop_fn(False)(cond.state, cond.inputs)[1]
        checks[target] = {
            "rounds": int(got["conditional"][2]),
            "nested": int(got["conditional"][3]),
            "eager_rounds": int(eager[2]),
            "bit_equal_eager": all(torch.equal(a, b) for a, b in
                                   zip(got["conditional"], eager)),
            "bit_equal_masked": all(torch.equal(a, b) for a, b in
                                    zip(got["conditional"],
                                        got["masked"]))}
    rec["checks"] = checks
    ms = {}
    for target in (0, 3, R):
        for form, prog in progs.items():
            prog.inputs[0].fill_(target)
            ms[f"{form}_{target}"] = device_ms(prog)
    rec["replay_ms"] = ms
    rec["taken_round_us"] = (ms[f"conditional_{R}"]
                             - ms["conditional_0"]) * 1e3 / R
    rec["masked_dead_round_us"] = (ms["masked_0"]
                                   - ms["conditional_0"]) * 1e3 / R
    return rec


def kernel_in_if_node(dev):
    from sr_livo_tpu_torch.ops import plane_fit
    from sr_livo_tpu_torch.ops import voxel_map as vm
    g = torch.Generator().manual_seed(1)
    vmap = vm.make_map(1 << 12, 20, device=dev)
    pts = torch.rand((4000, 3), generator=g).to(dev) * 4.0
    vm.insert(vmap, pts, torch.ones(4000, dtype=torch.bool, device=dev),
              0.5, 0.0, 8)
    q = torch.rand((256, 3), generator=g).to(dev) * 4.0
    valid = torch.ones(256, dtype=torch.bool, device=dev)
    thr = torch.ones((), dtype=torch.int32, device=dev)
    kw = dict(voxel_size=0.5, max_neighbors=20, max_probe=8, nb_voxels=1)
    want = [t.clone() for t in plane_fit.knn_plane_assoc(vmap, q, valid, thr,
                                                         **kw)]

    def fn(state, inputs):
        (pred,) = inputs
        zeros = tuple(torch.zeros_like(t) for t in want)
        return state, graphs.cond(
            pred, lambda _a: tuple(plane_fit.knn_plane_assoc(
                vmap, q, valid, thr, **kw)), zeros)
    pred = torch.ones((), dtype=torch.bool, device=dev)
    prog = graphs.Program(fn, None, (pred,), name="assoc_if")
    out = [t.clone() for t in prog()]
    pred.fill_(False)
    off = prog()
    torch.cuda.synchronize()
    return {"taken_equal": all(torch.equal(a, b) for a, b in zip(out, want)),
            "skipped_zero": all(not bool(t.any()) for t in off),
            "bodies": len(prog.bodies)}


def events_in_graph():
    """Device ms between two external timing events captured around a
    matmul, on a replay (an error string where that fails)."""
    try:
        x = torch.randn(2048, 2048, device="cuda")
        ev = [torch.cuda.Event(enable_timing=True, external=True)
              for _ in range(2)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            y = x @ x
            g.capture_begin()
            ev[0].record()
            y = x @ x
            ev[1].record()
            g.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        g.replay()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1])
    except Exception as e:                              # noqa: BLE001
        return repr(e)[:400]


def step_report(seed: int, seconds: float) -> dict:
    from livo_bench import harness
    from livo_bench import run as bench_run
    from sr_livo_tpu_torch.models import lio
    bench_run.environment()
    torch.set_num_threads(1)
    held = []
    out = harness.run("r3live_odom.livo", seed, seconds, True,
                      fault=held.append)
    pipe = held[0]
    rec = {"correct": out["correct"], "frames": out["completed"]}
    for key, prog in pipe.engine.programs.items():
        bodies = getattr(prog, "bodies", [])
        rec[prog.name] = {
            "nodes": prog.nodes, "replays": prog.replays,
            "body_nodes": [graphs.graph_nodes(b) for b in bodies],
            "body_node_types": [sorted(set(graphs.node_types(b)))
                                for b in bodies]}
    log = [d for name, d in graphs.stage_log()
           if name == "lio_step[steady]"][-out["completed"]:]
    if log:
        rec["steady_ranges_ms"] = {k: sum(d[k] for d in log) / len(log)
                                   for k in log[0]}
        rec["steady_replays_read"] = len(log)
    launched = getattr(lio, "launched_rounds", None)
    rec["rounds"] = {"active": lio.active_rounds.read(),
                     "bound": lio.active_rounds.added(),
                     "launched": None if launched is None
                     else launched.read()}
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if "--step" in sys.argv:
        args = sys.argv[sys.argv.index("--step") + 1:]
        kw = dict(zip(args[::2], args[1::2]))
        print(json.dumps(step_report(int(kw.get("--seed", 3000001901)),
                                     float(kw.get("--seconds", 20)))))
        return 0
    dev = torch.device("cuda")
    rec = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "torch_if_node_api": {a: hasattr(torch.cuda.CUDAGraph, a)
                                 for a in API},
           "pool_hooks": {h: hasattr(torch._C, h) for h in POOL_HOOKS}}
    rec["events_in_graph"] = events_in_graph()
    rec.update(build_report())
    if not rec["built"]:
        print(json.dumps(rec))
        return 2
    for name, part in (("loop", loop_report), ("kernel_in_if_node",
                                               kernel_in_if_node)):
        try:
            rec[name] = part(dev)
        except Exception as e:                          # noqa: BLE001
            rec[name] = {"error": repr(e)[-2000:]}
    print(json.dumps(rec))
    ok = (all(c["bit_equal_eager"] and c["bit_equal_masked"]
              for c in rec["loop"].get("checks", {0: {}}).values()
              if c) and rec["kernel_in_if_node"].get("taken_equal"))
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())
