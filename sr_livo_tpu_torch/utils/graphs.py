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
`lax.cond`s; a CUDA graph holds a fixed sequence of nodes.  PyTorch 2.11
(CUDA 12.8), the build the port is measured with, exposes no conditional
node (`tests/torch_cond_probe.py`), so there are two forms:

  * MASKED ROUNDS up to a proven bound: each round is a no-op once the
    loop's device flag is down.  The function asks `go_on(flag)` before a
    round: in capture form (the warm-up and the capture of a `Program`,
    or a `capture_form()` block) it is True and every round runs; in an
    eager run (the CPU, or the card outside a program) it reads the flag
    back and the loop stops where JAX's would.  `cond(pred, true_fn,
    false_value)` is `lax.cond` with an identity false branch: in capture
    form both run and a select keeps one, eagerly the host picks.
  * CONDITIONAL NODES, built by hand (`csrc/graph_cond.cu`): inside a
    `Program`'s capture on the card, `while_loop` puts its round into the
    body of a WHILE node and `cond` its branch into an IF node, so a round
    or branch that the flag rules out is never launched.  Their values
    live in buffers made before the node, which the body writes back in
    place, and the body's allocations come from the program's pool.  The
    warm-up, an eager run and the CPU take the forms above.  A caller
    whose rounds hold a collective that every rank must call passes
    `masked=True` and keeps masked rounds.

Every form gives the same bits: a masked round changes nothing, and a
node's body holds the round's kernels in their order.  A program
therefore reads nothing back to the host, and an eager run does no dead
work.

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
The warm-up's launches are taken back too: they are not the path's.  A
conditional node's body runs as often as the device decides, so its
increments are taken back as well and counted on the device instead:
each body adds one to its own slot of the program's run counts when it
runs, and `settle_counts()` (a wait) adds each body's increments times
its runs to the counters.  A reader of a launch counter settles first.
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
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch

# Host launch counters (dicts of int) that replays advance; kernel modules
# register theirs when they are imported.
_COUNTERS: List[Dict[str, int]] = []
# Whether each counts launches (a conditional body's runs on the device)
# or, as a `DeviceCount`'s adds, what the capture stands for
_PER_RUN: List[bool] = []


def register_counter(counter: Dict[str, int],
                     per_run: bool = True) -> Dict[str, int]:
    _COUNTERS.append(counter)
    _PER_RUN.append(per_run)
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


def while_loop(flag: Callable, body: Callable, carry, bound: int,
               masked: bool = False):
    """`lax.while_loop(flag, body, carry)` for a loop of at most `bound`
    rounds: `flag(carry)` is the carry's device bool, which `body` keeps
    down once it went down, and `body(carry)` returns the next carry.
    Inside a `Program`'s capture on the card the round is the body of a
    WHILE node over buffers cloned from `carry`, which also counts its
    rounds and stops at the bound, unless `masked`; elsewhere masked
    rounds (`go_on`).  In the node a `DeviceCount` add in the round
    counts as `bound` adds (`DeviceCount.added`), as over the masked
    rounds.  Returns the last carry."""
    if masked or bound < 1 or not _builds_nodes(flag(carry)):
        for _ in range(bound):
            if not go_on(flag(carry)):
                break
            carry = body(carry)
        return carry
    bufs = tree_map(torch.clone, carry)
    rounds = torch.zeros((), dtype=torch.int32, device=flag(carry).device)

    def round_():
        refill(bufs, body(bufs))
        rounds.add_(1)
        return flag(bufs) & (rounds < bound)
    slots = getattr(_FORM, "slots", 1)
    _FORM.slots = slots * bound
    try:
        _capture_node(True, flag(bufs), round_)
    finally:
        _FORM.slots = slots
    return bufs


def cond(pred: torch.Tensor, true_fn: Callable, false_value,
         masked: bool = False):
    """`lax.cond(pred, true_fn, identity)`: `true_fn(active)` returns a
    pytree shaped like `false_value`.  Inside a `Program`'s capture on the
    card it runs with `active=None` in the body of an IF node on `pred`,
    which writes its result over buffers cloned from `false_value`, unless
    `masked`; elsewhere in capture form it runs with `active=pred`, which
    it may use to mask its own work, and a select keeps its result where
    `pred` holds; otherwise the host reads `pred` and calls
    `true_fn(None)` only when it holds."""
    if not in_capture_form():
        return true_fn(None) if bool(pred) else false_value
    if masked or not _builds_nodes(pred):
        return tree_map(lambda a, b: torch.where(pred, a, b),
                        true_fn(pred), false_value)
    out = tree_map(torch.clone, false_value)

    def branch():
        refill(out, true_fn(None))
    _capture_node(False, pred, branch)
    return out


# The capture of the `Program` under way on this thread: its device index,
# memory pool, whether its allocations are routed to the pool by thread
# (`_route_to_pool`), the body graphs of its conditional nodes, and each
# body's slot of run counts (`runs`, on the device) with the launch
# counters' increments of one run (`tallies`, see `settle_counts`).
def _capture() -> Dict[str, Any]:
    return getattr(_FORM, "capture", None)


def _builds_nodes(flag: torch.Tensor) -> bool:
    """Whether a loop or branch on `flag` becomes a conditional node: in a
    `Program`'s capture on the card."""
    return (_capture() is not None and flag.is_cuda
            and torch.cuda.is_current_stream_capturing())


@functools.cache
def _cond_lib() -> ctypes.CDLL:
    from sr_livo_tpu_torch import kernels
    lib = kernels.load("graph_cond")
    p, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    lib.cond_begin.restype = ctypes.c_int
    lib.cond_begin.argtypes = [p, ctypes.c_int, p,
                               ctypes.POINTER(ctypes.c_ulonglong), pp, pp, pp]
    lib.cond_end.restype = ctypes.c_int
    lib.cond_end.argtypes = [p, ctypes.c_int, ctypes.c_ulonglong, p, p, p]
    lib.cond_abort.restype = ctypes.c_int
    lib.cond_abort.argtypes = [p, p, p]
    lib.cond_error.restype = ctypes.c_char_p
    lib.cond_error.argtypes = [ctypes.c_int]
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.cond_error(err).decode()} "
                           f"(cudaError {err})")


def _route_to_pool(cap: Dict[str, Any]) -> None:
    """Route this thread's allocations to the program's pool from now to
    the capture's end.  PyTorch routes a capture's allocations by its
    capture id, which changes when a node's body is captured
    (`csrc/graph_cond.cu`); the capture's end removes the routing."""
    if cap["routed"]:
        return
    dev, pool = cap["device"], cap["pool"]
    torch._C._cuda_endAllocateToPool(dev, pool)
    torch._C._cuda_beginAllocateCurrentThreadToPool(dev, pool)
    torch._C._cuda_releasePool(dev, pool)    # the capture holds its own use
    cap["routed"] = True


def _stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _capture_node(loop: bool, flag: torch.Tensor, run: Callable) -> None:
    """A WHILE (`loop`) or IF node on the device bool `flag` in the graph
    being captured, whose body `run()` captures; for a loop, `run` returns
    the flag its round wrote.  The body first adds one to its slot of
    run counts; the launch counters' increments of its capture are taken
    back and kept with the slot.  No `mark` lands in a body: a node's body
    may hold no event."""
    cap = _capture()
    slot = len(cap["tallies"])
    if slot >= len(cap["runs"]):
        raise RuntimeError(f"a program holds at most {len(cap['runs'])} "
                           "conditional nodes")
    cap["tallies"].append([])            # the slot, before nested bodies'
    _route_to_pool(cap)
    lib = _cond_lib()
    stream = ctypes.c_void_p(_stream_handle(flag.device))
    handle = ctypes.c_ulonglong()
    parent, node, body = ctypes.c_void_p(), ctypes.c_void_p(), \
        ctypes.c_void_p()
    _check(lib, lib.cond_begin(stream, int(loop), flag.data_ptr(),
                               ctypes.byref(handle), ctypes.byref(parent),
                               ctypes.byref(node), ctypes.byref(body)),
           "a conditional node")
    cap["bodies"].append(body.value)
    into, _MARKS["into"] = _MARKS["into"], None
    before = _snapshot()
    try:
        cap["runs"][slot].add_(1)
        end_flag = run()
    except BaseException:
        lib.cond_abort(stream, parent, node)
        raise
    finally:
        _MARKS["into"] = into
        cap["tallies"][slot] = _take_back(before)
    _check(lib, lib.cond_end(stream, int(loop), handle,
                             end_flag.data_ptr() if loop else None,
                             parent, node), "a conditional node's body")


def _take_back(before: List[Dict[str, int]]) -> list:
    """Restores the launch counters to `before`; returns what they had
    gained, [(counter, {key: increment})]."""
    gained = []
    for counter, was, per_run in zip(_COUNTERS, before, _PER_RUN):
        inc = {k: v - was.get(k, 0) for k, v in counter.items()
               if per_run and v != was.get(k, 0)}
        if inc:
            gained.append((counter, inc))
            counter.update(was)
    return gained


def _fold(runs: torch.Tensor, tallies: list) -> None:
    """Adds each body's increments times its runs so far to the launch
    counters and zeroes the runs (reads them: a wait)."""
    if not tallies:
        return
    n = runs[:len(tallies)].tolist()
    runs.zero_()
    for times, tally in zip(n, tallies):
        for counter, inc in tally:
            for k, v in inc.items():
                counter[k] = counter.get(k, 0) + v * int(times)


_PROGRAMS: "weakref.WeakSet[Program]" = weakref.WeakSet()
_MAX_BODIES = 16      # conditional nodes a program may hold


def settle_counts() -> None:
    """Brings the launch counters up to date with the runs of every live
    program's conditional bodies so far (waits for those programs'
    devices); nothing to do where no program holds such a node."""
    for prog in list(_PROGRAMS):
        prog.settle()


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
    the number of adds that counted, not a launch count: an add in a
    WHILE node's body counts as the node's bound, as over the masked
    rounds the node replaces, and a replay adds its capture's.  The
    buffers are made outside any capture: a `Program`
    makes its device's before it captures (`register_device_count`)."""

    def __init__(self):
        self._bufs: Dict[torch.device, torch.Tensor] = {}
        self._added = register_counter({"adds": 0}, per_run=False)

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
            self._added["adds"] += getattr(_FORM, "slots", 1)

    def add_one(self, device: torch.device) -> None:
        """Add 1 on `device` where it counts."""
        if _MARKS["count"]:
            self.buffer(device).add_(1)
            self._added["adds"] += getattr(_FORM, "slots", 1)

    def read(self) -> int:
        """The count over every device (waits for each)."""
        return sum(int(b.item()) for b in self._bufs.values())

    def added(self) -> int:
        """How many adds counted, as the class says (on the host; no
        wait)."""
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
    lib.cuGraphNodeGetType.restype = ctypes.c_int
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    return lib


def _nodes(raw: int, array=None) -> int:
    count = ctypes.c_size_t(0 if array is None else len(array))
    err = _libcuda().cuGraphGetNodes(raw, array, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return count.value


def graph_nodes(graph) -> int:
    """Nodes of a captured graph (a `torch.cuda.CUDAGraph`, or the raw
    handle of a conditional node's body), a conditional node counting
    one (`cuGraphGetNodes` of libcuda)."""
    raw = graph if isinstance(graph, int) else graph.raw_cuda_graph()
    return _nodes(raw)


def node_types(raw: int) -> List[int]:
    """The CUgraphNodeType of each node of the graph with raw handle `raw`
    (0 kernel, 1 memcpy, 2 memset, 3 host, 5 empty, 6 event wait, 7 event
    record, 10 memory allocation, 11 free, 13 conditional)."""
    array = (ctypes.c_void_p * _nodes(raw))()
    _nodes(raw, array)
    out = []
    for node in array:
        kind = ctypes.c_int()
        err = _libcuda().cuGraphNodeGetType(node, ctypes.byref(kind))
        if err != 0:
            raise RuntimeError(f"cuGraphNodeGetType failed: CUresult {err}")
        out.append(kind.value)
    return out


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
        self.bodies: list = []     # raw handles of its conditional bodies
        self._runs = None          # runs of each body (device int64)
        self._tallies: list = []   # launch counts of one run of each body
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

    def settle(self) -> None:
        """Adds its conditional bodies' launches since the last settle to
        the launch counters (`settle_counts`); waits for its device."""
        if self._tallies:
            torch.cuda.synchronize(self.device)
            _fold(self._runs, self._tallies)

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
        if self._runs is None:
            self._runs = torch.zeros(_MAX_BODIES, dtype=torch.int64,
                                     device=self.device)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        pool = torch.cuda.graph_pool_handle()
        marks, bodies, tallies = [], [], []
        counted = _MARKS["count"]
        try:
            with torch.cuda.stream(side), capture_form():
                # warm-up on a copy of the state, results dropped (and not
                # counted)
                _MARKS["count"] = False
                self.fn(tree_map(torch.clone, self.state), self.inputs)
                _restore(before)
                # "thread_local": the pipeline's feeder thread may upload
                # the next frame meanwhile; a private pool, whose handle a
                # conditional node's body allocates from (`_route_to_pool`)
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                cap = _FORM.capture = {"device": self.device.index,
                                       "pool": pool, "routed": False,
                                       "bodies": bodies, "runs": self._runs,
                                       "tallies": tallies}
                _MARKS["into"] = marks if _MARKS["on"] else None
                _MARKS["count"] = _MARKS["on"]
                try:
                    outputs = self.body()
                    mark("end")
                except BaseException:
                    _end_failed_capture(graph, cap)
                    raise
                finally:
                    _MARKS["into"] = None
                    _FORM.capture = None
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
        self.nodes, self.bodies = graph_nodes(graph), bodies
        self._tallies = tallies
        if tallies:
            _PROGRAMS.add(self)
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


def _end_failed_capture(graph: "torch.cuda.CUDAGraph",
                        cap: Dict[str, Any]) -> None:
    """End a capture whose body raised, so the stream leaves capture mode;
    the body's error is the one to report, so the invalidated capture's
    own error is not.  An invalidated capture's end raises before it
    removes the routing of allocations to its pool, which, routed by
    thread, would take this thread's later allocations."""
    try:
        graph.capture_end()
    except RuntimeError:
        if cap["routed"]:
            torch._C._cuda_endAllocateToPool(cap["device"], cap["pool"])
