"""Captured device programs: the port's counterpart of `jax.jit` with
`donate_argnums`.

The JAX package runs each per-frame body as one compiled XLA program whose
state arguments are donated (`VisionModule._fused_frame_core`,
`LioEngine._raw_step`, `color_insert`).  PyTorch runs eagerly, one host
launch per op, so a body of a few thousand small ops is bound by the
host's launch rate.  A `Program` captures such a body once as a CUDA
graph and replays it.

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
over a copy of the state (a warm-up, its results dropped: `fn` may update
state buffers in place, as the LIO step inserts into its voxel map), then
`fn` and the write-back are captured into a CUDA graph with a private
memory pool, and every call replays it.  A failed capture raises; there
is no eager fallback on the card.  On the CPU the same `fn` and write-back
run directly: that is the plain path and the oracle of the tests.

Data-dependent control flow.  The JAX programs hold `lax.while_loop`s and
`lax.cond`s; a CUDA graph holds a fixed sequence of kernels.  CUDA's
conditional nodes would skip a dead round on the device, but PyTorch
2.11 (CUDA 12.8), the build the port is measured with, does not expose
them (`tests/torch_cond_probe.py`), so every such loop is written as MASKED
ROUNDS up to a proven bound: each round is a no-op once the loop's
device flag is down.  The function asks `go_on(flag)` before a round:
in capture form (the warm-up and the capture of a `Program`, or a
`capture_form()` block) it is True and every round runs; in an eager run
(the CPU, or the card outside a program) it reads the flag back and the
loop stops where JAX's would.  Both forms give the same bits: a masked
round changes nothing.  `cond(pred, true_fn, false_value)` is `lax.cond`
with an identity false branch: in capture form both run and a select
keeps one, eagerly the host picks.  A program therefore reads nothing
back to the host, and an eager run does no dead work.

`outputs` are the graph's own tensors, which the next replay overwrites:
a caller clones what it keeps.  A pure function is a program with state
None: what it allocates (a scratch table, a temporary map) lives in the
graph's private memory pool, which the program holds, and is made anew
in the graph on each replay.  `call` keeps a caller's programs in a dict
by key and replays one `repeat` times back to back (an iteration
program).

Launch counters: a kernel wrapper adds one to a host dict where it
launches (`plane_fit.launches`), and a replay runs no Python.  So the
increments of every registered counter during capture are recorded,
taken back (a capture launches nothing) and added again on each replay.
The warm-up's launches are taken back too: they are not the path's.
A count that depends on device values (the IEKF rounds that did work)
is a `DeviceCount`, added to on the device with no host read, in
programs captured with stage events on only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Tuple

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


@contextlib.contextmanager
def counts_kept():
    """Within the block, the registered counters do not move: for a check
    that runs a program's function eagerly beside its replay."""
    snap = _snapshot()
    try:
        yield
    finally:
        _restore(snap)


_FORM = threading.local()


def in_capture_form() -> bool:
    """Whether the code runs as a capture records it (module docstring)."""
    return getattr(_FORM, "depth", 0) > 0


@contextlib.contextmanager
def capture_form():
    """Within the block, bounded loops run every round and `cond` runs both
    branches, as a `Program`'s capture records them; nothing is read back
    to the host."""
    _FORM.depth = getattr(_FORM, "depth", 0) + 1
    try:
        yield
    finally:
        _FORM.depth -= 1


def go_on(flag: torch.Tensor) -> bool:
    """Whether a bounded loop runs its next round, whose work `flag` (a
    device bool) masks: always in capture form (a round after the flag
    went down is a no-op), else the flag read back to the host, so an
    eager loop stops where the JAX `while_loop` does.  Only for loops
    whose flag, once down, stays down."""
    return True if in_capture_form() else bool(flag)


def cond(pred: torch.Tensor, true_fn: Callable, false_value):
    """`lax.cond(pred, true_fn, identity)`: `true_fn(active)` returns a
    pytree shaped like `false_value`.  In capture form it runs with
    `active=pred`, which it may use to mask its own work, and a select
    keeps its result where `pred` holds; otherwise the host reads `pred`
    and calls `true_fn(None)` only when it holds."""
    if in_capture_form():
        return tree_map(lambda a, b: torch.where(pred, a, b),
                        true_fn(pred), false_value)
    return true_fn(None) if bool(pred) else false_value


# In-graph stage events: with `stage_events(True)` when a program is
# captured, each `mark(name)` in its function records a timing event in
# the graph, and `Program.stage_ms()` reads the device time between them
# in its last replay (with a wait), `stage_log()` in every replay (none);
# each `DeviceCount.add` in it adds to a count on the device, again on
# every replay.  "count" is whether `add` counts here.
_MARKS = {"on": False, "into": None, "count": False}
_DEVICE_COUNTS: List["DeviceCount"] = []


# (program name, {stage: device ms}) of each replay of a program captured
# with stage events, in replay order, once its events completed; and the
# replays not read yet, (name, marks), oldest first.
_STAGE_LOG: List[Tuple[str, Dict[str, float]]] = []
_UNREAD: List[tuple] = []


def _elapsed(marks: list) -> Dict[str, float]:
    return {name: a.elapsed_time(b) for (name, a), (_, b)
            in zip(marks[:-1], marks[1:])}


def _read_replays() -> None:
    """Log the unread replays whose events have completed (`query()`:
    never waits).  The stream runs them in order, so the first one still
    running ends the read."""
    while _UNREAD and _UNREAD[0][1][-1][1].query():
        name, marks = _UNREAD.pop(0)
        _STAGE_LOG.append((name, _elapsed(marks)))


def stage_log() -> List[Tuple[str, Dict[str, float]]]:
    """(program name, device ms of each marked stage) of every replay so
    far of a program captured with stage events, oldest first, up to the
    last whose work has completed: each replay is read at its program's
    next call or here, never with a wait.  A replay still running when its
    program is called again is left out (its events are recorded anew)."""
    _read_replays()
    return _STAGE_LOG


def stage_events(on: bool) -> None:
    """Whether programs captured from now on record their `mark`s and
    device counts (and whether a program's call on the CPU counts)."""
    _MARKS["on"] = bool(on)


@contextlib.contextmanager
def counting(on: bool = True):
    """Within the block, `DeviceCount.add` counts (as in the capture of a
    program with stage events on: for eager runs and tests), or with
    `on=False` does not (work a count leaves out)."""
    before = _MARKS["count"]
    _MARKS["count"] = on
    try:
        yield
    finally:
        _MARKS["count"] = before


class DeviceCount:
    """An int32 count on each device that code adds device values to,
    with no host read: `add` counts only where `counting` holds (the
    capture of a program with stage events on, whose replays then add
    again; a program's call on the CPU with them on; a `counting()`
    block), so an untraced program's graph holds no add.  `added()` is
    the number of adds that counted, a launch counter (a replay adds its
    capture's).  The buffers are made outside any capture: a `Program`
    makes its device's before it captures (`register_device_count`)."""

    def __init__(self):
        self._bufs: Dict[torch.device, torch.Tensor] = {}
        self._added = register_counter({"adds": 0})

    def buffer(self, device: torch.device) -> torch.Tensor:
        buf = self._bufs.get(device)
        if buf is None:
            buf = self._bufs[device] = torch.zeros(1, dtype=torch.int32,
                                                   device=device)
        return buf

    def add(self, value: torch.Tensor) -> None:
        """Add `value` (a 0-d bool or integer tensor) where it counts."""
        if _MARKS["count"]:
            self.buffer(value.device).add_(value.reshape(1))
            self._added["adds"] += 1

    def read(self) -> int:
        """The count over every device (waits for each)."""
        return sum(int(b.item()) for b in self._bufs.values())

    def added(self) -> int:
        """How many adds counted (on the host; no wait)."""
        return self._added["adds"]


def register_device_count(count: DeviceCount) -> DeviceCount:
    _DEVICE_COUNTS.append(count)
    return count


def mark(name: str) -> None:
    """Stage `name` of the program being captured starts here (nothing
    outside such a capture, or with stage events off)."""
    into = _MARKS["into"]
    if into is not None:
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        into.append((name, ev))


def scatter_sum(dst: torch.Tensor, index: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """dst[index[k]] += src[k] for every k, in place, each target's terms
    summed in the order of k on either device.  On CUDA, `index_add_`
    adds floats atomically in no fixed order, so two runs of a function,
    or a replay and its eager run, can part in the last bits; the
    accumulating `index_put_` sorts the index (stably) and sums in that
    order, as the CPU does."""
    return dst.index_put_((index,), src, accumulate=True)


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
        self.captures = 0          # captures so far
        self.replays = 0
        self.capture_s = 0.0       # host seconds of the last capture
        self.nodes = 0             # nodes of the captured graph
        self.marks: list = []      # (stage, event) recorded in the graph

    def body(self):
        """What the graph holds: `fn`, then the write-back of its state."""
        new_state, outputs = self.fn(self.state, self.inputs)
        refill(self.state, new_state)          # the write-back
        return outputs

    def __call__(self):
        if self.device.type != "cuda":
            if not _MARKS["on"]:
                return self.body()
            with counting():
                return self.body()
        if self.graph is None:
            self._capture()
        elif self.marks:
            _read_replays()
            _UNREAD[:] = [u for u in _UNREAD if u[1] is not self.marks]
        self.graph.replay()
        if self.marks:
            _UNREAD.append((self.name, self.marks))
        for counter, delta in zip(_COUNTERS, self._delta):
            for k, v in delta.items():
                counter[k] = counter.get(k, 0) + v
        self.replays += 1
        return self.outputs

    def stage_ms(self) -> Dict[str, float]:
        """Device ms of each stage marked in the graph (`mark`) in the last
        replay; waits for it.  Empty when it was captured without stage
        events."""
        if not self.marks:
            return {}
        self.marks[-1][1].synchronize()
        return _elapsed(self.marks)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        before = _snapshot()
        if _MARKS["on"]:
            for count in _DEVICE_COUNTS:
                count.buffer(self.device)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        marks = []
        counted = _MARKS["count"]
        try:
            with torch.cuda.stream(side), capture_form():
                # warm-up on a copy of the state, results dropped (and not
                # counted)
                _MARKS["count"] = False
                self.fn(tree_map(torch.clone, self.state), self.inputs)
                _restore(before)
                # "thread_local": the pipeline's feeder thread may upload
                # the next frame meanwhile; a private pool (pool=None)
                graph.capture_begin(capture_error_mode="thread_local")
                _MARKS["into"] = marks if _MARKS["on"] else None
                _MARKS["count"] = _MARKS["on"]
                try:
                    outputs = self.body()
                    mark("end")
                except BaseException:
                    _end_failed_capture(graph)
                    raise
                finally:
                    _MARKS["into"] = None
                graph.capture_end()
            after = _snapshot()
        finally:
            _MARKS["count"] = counted
            _restore(before)
            cur.wait_stream(side)
        graph.instantiate()
        self._delta = [{k: a[k] - b.get(k, 0) for k in a
                        if a[k] != b.get(k, 0)}
                       for a, b in zip(after, before)]
        self.graph, self.outputs, self.marks = graph, outputs, marks
        self.nodes = graph_nodes(graph)
        self.captures += 1
        self.capture_s = time.perf_counter() - t0


def call(programs: Dict[Any, Program], key, fn: Callable, state, inputs,
         name: str = "", repeat: int = 1):
    """Calls the program `programs[key]` over `fn` `repeat` times back to
    back, with no host read between the calls (a Gauss-Newton iteration
    replayed `iters` times), and returns its (state, outputs) after the
    last.  The first use of `key` makes the program: `state` is adopted
    (its buffers are the caller's, updated in place; None for a pure
    function) and `inputs` are copied, since refills write into them.
    Later uses refill both first.  `key` must name everything `fn` holds
    besides its arguments: the program keeps the first `fn`."""
    prog = programs.get(key)
    if prog is None:
        prog = programs[key] = Program(fn, state, tree_map(torch.clone,
                                                           inputs), name)
    else:
        refill(prog.state, state)
        refill(prog.inputs, inputs)
    outputs = None
    for _ in range(repeat):
        outputs = prog()
    return prog.state, outputs


def _end_failed_capture(graph: "torch.cuda.CUDAGraph") -> None:
    """End a capture whose body raised, so the stream leaves capture mode;
    the body's error is the one to report, so the invalidated capture's
    own error is not."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
