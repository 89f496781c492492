"""Probe of the linear-algebra calls the long-run programs capture.

Run on a CUDA machine: `python3 tests/torch_solve_probe.py`.  For each
call (the dense pose-graph solve, one 384 x 384 `linalg.solve_ex`; the
windowed BA's 24 x 24 one; the loop check's 6 x 6 one; the PCG's batched
6 x 6 `linalg.inv_ex` at 128 nodes; a batched 6 x 6 `solve_ex` as the
vision graph already captures): whether it captures into a CUDA graph,
whether the replay on new values in the captured buffers equals an eager
call on them bit for bit (and the largest difference), and whether the
replay or the eager call makes a synchronizing call
(`set_sync_debug_mode("error")`).  Prints one JSON object; exits
non-zero without a card.
"""

from __future__ import annotations

import json
import sys

import torch

CASES = {
    "solve_ex 384x384 (dense pose graph)": ("solve", (384, 384), (384,)),
    "solve_ex 24x24 (windowed BA)": ("solve", (24, 24), (24,)),
    "solve_ex 6x6 (loop check)": ("solve", (6, 6), (6,)),
    "solve_ex 64x6x6 (batched)": ("solve", (64, 6, 6), (64, 6)),
    "inv_ex 128x6x6 (PCG preconditioner)": ("inv", (128, 6, 6), None),
}


def _spd(shape, gen, dev):
    a = torch.randn(shape, generator=gen, device=dev)
    eye = torch.eye(shape[-1], device=dev)
    return a @ a.transpose(-1, -2) + shape[-1] * eye


def _call(kind, a, b):
    if kind == "solve":
        return torch.linalg.solve_ex(a, b).result
    return torch.linalg.inv_ex(a).inverse


def probe(name, kind, a_shape, b_shape, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    a = _spd(a_shape, gen, dev)
    b = torch.randn(b_shape, generator=gen, device=dev) if b_shape else None
    out = {"call": name}
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            _call(kind, a, b)
            out["eager_sync"] = False
        except RuntimeError:
            out["eager_sync"] = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _call(kind, a, b)                     # warm-up
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            res = _call(kind, a, b)
        out["captures"] = True
    except RuntimeError as e:
        out.update(captures=False, error=repr(e)[:300])
        return out
    a.copy_(_spd(a_shape, gen, dev))
    if b is not None:
        b.copy_(torch.randn(b_shape, generator=gen, device=dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
        out["replay_sync"] = False
    except RuntimeError:
        out["replay_sync"] = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = _call(kind, a, b)
    torch.cuda.synchronize()
    out["replay_equals_eager"] = bool(torch.equal(res, want))
    out["max_abs_diff"] = float((res - want).abs().max())
    out["finite"] = bool(torch.isfinite(res).all())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_solve_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows = [probe(name, *case, dev) for name, case in CASES.items()]
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "calls": rows}))
    return 0 if all(r.get("replay_equals_eager") for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
