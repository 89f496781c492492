"""Captured device programs: the port's counterpart of `jax.jit` with
`donate_argnums`.

The JAX package runs each per-frame body as one compiled XLA program whose
state arguments are donated (`VisionModule._fused_frame_core`, the IEKF
loop inside `LioEngine._raw_step`).  PyTorch runs eagerly, one host launch
per op, so a body of a few thousand small ops is bound by the host's
launch rate.  A `Program` captures such a body once as a CUDA graph and
replays it.

A program is a pure function `fn(state, inputs) -> (new_state, outputs)`
over pytrees (tuples and NamedTuples; None leaves stay None) of
tensors that keep their shapes from call to call:

  * `state` holds the persistent buffers, the arguments JAX donates.  The
    program copies `new_state` back into them (`refill`), inside the
    graph on the card, so after a call `prog.state` holds the result.  A
    leaf that `fn` returns unchanged (the same tensor) is not copied.
    The port updates these buffers IN PLACE where the JAX package returns
    new arrays.
  * `inputs` holds the per-call values; `refill` copies a caller's
    tensors into them before a call.

Both start as the caller's own tensors (adopted, not copied).  A caller
that replaces a state or input tensor eagerly (an insert that returns a
new tensor, a map rebuild, a checkpoint load) hands the new tensor to
`refill`, which copies it into the buffer when the buffer is not that
tensor already: a host-side `data_ptr` comparison, which costs no
synchronize.

On a CUDA device the first call captures: `fn` runs once on a side stream
(a warm-up, its results dropped: `fn` writes nothing it was given), then
`fn` and the write-back are captured into a CUDA graph with a private
memory pool, and every call replays it.  A failed capture raises; there
is no eager fallback on the card.  On the CPU the same `fn` and write-back
run directly: that is the plain path and the oracle of the tests.

`outputs` are the graph's own tensors, which the next replay overwrites:
a caller clones what it keeps.

Launch counters: a kernel wrapper adds one to a host dict where it
launches (`plane_fit.launches`), and a replay runs no Python.  So the
increments of every registered counter during capture are recorded,
taken back (a capture launches nothing) and added again on each replay.
The warm-up's launches are taken back too: they are not the path's.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Any, Callable, Dict, List

import torch

# Host launch counters (dicts of int) that replays advance; kernel modules
# register theirs when they are imported.
_COUNTERS: List[Dict[str, int]] = []


def register_counter(counter: Dict[str, int]) -> Dict[str, int]:
    _COUNTERS.append(counter)
    return counter


def _snapshot() -> List[Dict[str, int]]:
    return [dict(c) for c in _COUNTERS]


def _restore(snap: List[Dict[str, int]]) -> None:
    for c, s in zip(_COUNTERS, snap):
        c.update(s)


def tree_leaves(tree) -> list:
    """The tensor leaves of a pytree, in order (None leaves skipped)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    raise TypeError(f"not a pytree of tensors: {type(tree).__name__}")


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the tensor leaves of one or more pytrees of one
    structure; None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    raise TypeError(f"not a pytree of tensors: {type(tree).__name__}")


def _same_buffer(buf: torch.Tensor, new: torch.Tensor) -> bool:
    return new is buf or (new.data_ptr() == buf.data_ptr()
                          and new.shape == buf.shape
                          and new.stride() == buf.stride())


def refill(buffers, values) -> int:
    """Copy each leaf of `values` into the matching leaf of `buffers` unless
    it is that buffer already; returns the number of copies.  Shapes and
    types must match."""
    bufs, vals = tree_leaves(buffers), tree_leaves(values)
    if len(bufs) != len(vals):
        raise ValueError(f"refill: {len(vals)} values for {len(bufs)} "
                         "buffers")
    n = 0
    for buf, new in zip(bufs, vals):
        if _same_buffer(buf, new):
            continue
        if new.shape != buf.shape or new.dtype != buf.dtype:
            raise ValueError(f"refill: {tuple(new.shape)} {new.dtype} into "
                             f"a {tuple(buf.shape)} {buf.dtype} buffer")
        buf.copy_(new)
        n += 1
    return n


def same_leaves(a, b) -> bool:
    """Whether two pytrees hold the same buffers, leaf for leaf."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(_same_buffer(x, y)
                                      for x, y in zip(la, lb))


@functools.cache
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    return lib


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """Nodes of a captured graph (`cuGraphGetNodes` of libcuda)."""
    count = ctypes.c_size_t(0)
    err = _libcuda().cuGraphGetNodes(graph.raw_cuda_graph(), None,
                                     ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return count.value


class Program:
    """`fn` over adopted `state` and `inputs` buffers: captured once and
    replayed on a CUDA device, run directly on the CPU (module
    docstring).  `name` labels it in measurements."""

    def __init__(self, fn: Callable, state, inputs, name: str = ""):
        leaves = tree_leaves(state) + tree_leaves(inputs)
        if not leaves:
            raise ValueError("a program needs at least one tensor")
        self.fn, self.state, self.inputs, self.name = fn, state, inputs, name
        self.device = leaves[0].device
        self.graph = None
        self.outputs: Any = None
        self._delta: List[Dict[str, int]] = []
        self.captures = 0          # captures so far (a rebind re-captures)
        self.replays = 0
        self.capture_s = 0.0       # host seconds of the last capture
        self.nodes = 0             # nodes of the captured graph

    def body(self):
        """What the graph holds: `fn`, then the write-back of its state."""
        new_state, outputs = self.fn(self.state, self.inputs)
        refill(self.state, new_state)          # the write-back
        return outputs

    def rebind(self, inputs) -> None:
        """Adopt other input tensors as the buffers; the graph, captured
        on the old addresses, and its memory pool are dropped, and the
        next call captures again.  For an input replaced wholesale where
        a copy would cost more than a capture (a new voxel map)."""
        if self.graph is not None:
            # the pool goes back to the allocator: let the last replay end
            torch.cuda.current_stream(self.device).synchronize()
        self.inputs = inputs
        self.graph, self.outputs, self._delta = None, None, []

    def __call__(self):
        if self.device.type != "cuda":
            return self.body()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for counter, delta in zip(_COUNTERS, self._delta):
            for k, v in delta.items():
                counter[k] = counter.get(k, 0) + v
        self.replays += 1
        return self.outputs

    def _capture(self) -> None:
        t0 = time.perf_counter()
        before = _snapshot()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with torch.cuda.stream(side):
                self.fn(self.state, self.inputs)   # warm-up, results dropped
                _restore(before)
                # "thread_local": the pipeline's feeder thread may upload
                # the next frame meanwhile; a private pool (pool=None)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outputs = self.body()
                except BaseException:
                    _end_failed_capture(graph)
                    raise
                graph.capture_end()
            after = _snapshot()
        finally:
            _restore(before)
            cur.wait_stream(side)
        graph.instantiate()
        self._delta = [{k: a[k] - b.get(k, 0) for k in a
                        if a[k] != b.get(k, 0)}
                       for a, b in zip(after, before)]
        self.graph, self.outputs = graph, outputs
        self.nodes = graph_nodes(graph)
        self.captures += 1
        self.capture_s = time.perf_counter() - t0


def _end_failed_capture(graph: "torch.cuda.CUDAGraph") -> None:
    """End a capture whose body raised, so the stream leaves capture mode;
    the body's error is the one to report, so the invalidated capture's
    own error is not."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
