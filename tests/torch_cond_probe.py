"""Probe of CUDA graph conditional nodes (if-nodes) in this PyTorch build.

Run on a CUDA machine: `python3 tests/torch_cond_probe.py`.  Prints one
JSON object: the PyTorch and CUDA versions, whether
`torch.cuda.CUDAGraph` has `get_currently_capturing_graph`,
`begin_capture_to_if_node` and `end_capture_to_conditional_node`, and,
where it has them, whether a bounded loop of if-nodes holding the ops the
LIO step runs (stable sorts, scatter-min, cumsum/cummax, index writes,
`inv_ex`, copies, a nested if-node, the plane kernel's fused association)
captures and replays to the eager result, what a skipped and a taken
round cost on the device, and whether the replay makes a synchronizing
call.  Also, with or without them: whether timing events recorded inside
a graph (`torch.cuda.Event(external=True)`, what `utils.graphs.mark`
records) time a replay.  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

API = ("get_currently_capturing_graph", "begin_capture_to_if_node",
       "end_capture_to_conditional_node")


def run_if(pred, fn):
    """`fn()` under an if-node on `pred` while capturing, else where
    `pred` holds (a host read)."""
    if not torch.cuda.is_current_stream_capturing():
        if bool(pred):
            fn()
        return
    g = torch.cuda.CUDAGraph.get_currently_capturing_graph()
    g.begin_capture_to_if_node(pred)
    try:
        fn()
    finally:
        g.end_capture_to_conditional_node()


def body_ops(st, dev):
    """One round: every op kind of the LIO step, updating `st` in place."""
    n = st["h"].shape[0]
    h64 = st["h"].to(torch.int64)
    key = (h64 << 32) | st["pri"].to(torch.int64)
    order = torch.sort(key, stable=True).indices
    tbl = torch.full((1025,), 0x7FFFFFFF, dtype=torch.int32, device=dev)
    tbl.scatter_reduce_(0, (h64 & 1023), st["h"], "amin")
    cs = torch.cumsum(st["h"].to(torch.int64) & 7, 0)
    cm = torch.cummax(cs, 0).values
    sink = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    sink.index_put_((order,), cm)
    m = torch.linalg.inv_ex(st["mat"] + torch.eye(17, device=dev))[0]
    st["mat"].copy_(m * 0.5)
    st["acc"].add_(sink[:n] + tbl[:n].to(torch.int64))
    st["rounds"].add_(1)
    nested = st["rounds"] > 2
    run_if(nested, lambda: st["nested"].add_(1))


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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rec = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": torch.cuda.get_device_name(0),
           "api": {a: hasattr(torch.cuda.CUDAGraph, a) for a in API}}
    rec["events_in_graph"] = events_in_graph()
    if not all(rec["api"].values()):
        print(json.dumps(rec))
        return 0
    g0 = torch.Generator().manual_seed(0)

    def fresh():
        return {"h": torch.randint(0, 1 << 30, (8192,), generator=g0,
                                   dtype=torch.int32).to(dev),
                "pri": torch.randperm(8192, generator=g0).to(
                    torch.int32).to(dev),
                "mat": torch.rand((17, 17), generator=g0).to(dev),
                "acc": torch.zeros(8192, dtype=torch.int64, device=dev),
                "rounds": torch.zeros((), dtype=torch.int64, device=dev),
                "nested": torch.zeros((), dtype=torch.int64, device=dev),
                "target": torch.zeros((), dtype=torch.int64, device=dev)}

    R = 9
    st = fresh()
    ref = {k: v.clone() for k, v in st.items()}

    def loop():
        for _ in range(R):
            run_if(st["rounds"] < st["target"], lambda: body_ops(st, dev))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    ev = [torch.cuda.Event(enable_timing=True, external=True)
          for _ in range(2)]
    t0 = time.perf_counter()
    try:
        with torch.cuda.stream(side):
            body_ops({k: v.clone() for k, v in st.items()}, dev)   # warm-up
            graph.capture_begin(capture_error_mode="thread_local")
            ev[0].record()
            loop()
            ev[1].record()
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        graph.instantiate()
        rec["capture_s"] = time.perf_counter() - t0
        rec["captured"] = True
    except Exception as e:                              # noqa: BLE001
        rec["captured"] = False
        rec["capture_error"] = repr(e)[:800]
        print(json.dumps(rec))
        return 0

    def eager(target):
        e = {k: v.clone() for k, v in ref.items()}
        e["target"].fill_(target)
        for _ in range(R):
            run_if(e["rounds"] < e["target"], lambda: body_ops(e, dev))
        return e

    checks = {}
    for target in (0, 3, R):
        for k, v in ref.items():
            st[k].copy_(v)
        st["target"].fill_(target)
        torch.cuda.set_sync_debug_mode("error")
        try:
            graph.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        e = eager(target)
        checks[target] = {
            "rounds": int(st["rounds"]), "nested": int(st["nested"]),
            "bit_equal": all(torch.equal(st[k], e[k]) for k in st)}
    rec["checks"] = checks

    def dev_ms(target, reps=50):
        st["target"].fill_(target)
        ms = []
        for _ in range(reps):
            st["rounds"].zero_()
            graph.replay()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        ms.sort()
        return ms[len(ms) // 2]

    try:
        rec["graph_ms_all_skipped"] = dev_ms(0)
        rec["graph_ms_all_taken"] = dev_ms(R)
        rec["skipped_round_us"] = rec["graph_ms_all_skipped"] * 1e3 / R
    except Exception as e:                              # noqa: BLE001
        rec["graph_events"] = repr(e)[:800]

    # the plane kernel's fused association inside an if-node
    from sr_livo_tpu_torch.ops import plane_fit
    from sr_livo_tpu_torch.ops import voxel_map as vm
    vmap = vm.make_map(1 << 12, 20, device=dev)
    pts = torch.rand((4000, 3), generator=g0).to(dev) * 4.0
    vm.insert(vmap, pts, torch.ones(4000, dtype=torch.bool, device=dev),
              0.5, 0.0, 8)
    q = (torch.rand((256, 3), generator=g0).to(dev) * 4.0)
    valid = torch.ones(256, dtype=torch.bool, device=dev)
    thr = torch.ones((), dtype=torch.int32, device=dev)
    kw = dict(voxel_size=0.5, max_neighbors=20, max_probe=8, nb_voxels=1)
    want = plane_fit.knn_plane_assoc(vmap, q, valid, thr, **kw)
    out = [torch.zeros_like(t) for t in want]
    go = torch.ones((), dtype=torch.bool, device=dev)

    def assoc():
        for o, t in zip(out, plane_fit.knn_plane_assoc(vmap, q, valid, thr,
                                                       **kw)):
            o.copy_(t)

    g2 = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            g2.capture_begin(capture_error_mode="thread_local")
            run_if(go, assoc)
            g2.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        g2.replay()
        torch.cuda.synchronize()
        rec["kernel_in_if_node"] = all(torch.equal(a, b)
                                       for a, b in zip(out, want))
    except Exception as e:                              # noqa: BLE001
        rec["kernel_in_if_node"] = repr(e)[:800]
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
