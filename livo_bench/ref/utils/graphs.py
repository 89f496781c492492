# Trimmed copy of sr_livo_tpu_torch/utils/graphs.py at commit f22c487785a4:
# part of the benchmark's plain reference (livo_bench/check.py).  Later
# changes to the port do not change it.
"""The plain path of the port's captured programs: every program runs its
function directly, as the port runs one on the CPU.

A program is a pure function `fn(state, inputs) -> (new_state, outputs)`
over pytrees of tensors; `call` runs it and copies `new_state` back into
the adopted `state` buffers (`refill`), which the callers rely on.  The
port's bounded loops are masked rounds; here `go_on` reads the round's
flag, so a loop stops where the JAX `while_loop` does, and `cond` runs
the branch the host picks.  The capture machinery, the in-graph stage
events and the launch-count bookkeeping of the port are left out: the
reference captures nothing.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

_COUNTERS: List[Dict[str, int]] = []


def register_counter(counter: Dict[str, int]) -> Dict[str, int]:
    _COUNTERS.append(counter)
    return counter


def go_on(flag: torch.Tensor) -> bool:
    """Whether a bounded loop runs its next round: the flag read back."""
    return bool(flag)


def cond(pred: torch.Tensor, true_fn: Callable, false_value):
    """`lax.cond(pred, true_fn, identity)`, the host picking the branch."""
    return true_fn(None) if bool(pred) else false_value


def mark(name: str) -> None:
    """A stage boundary of the port's programs: nothing here."""


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


class Program:
    """`fn` over adopted `state` and copied `inputs` buffers, run
    directly."""

    def __init__(self, fn: Callable, state, inputs, name: str = ""):
        self.fn, self.state, self.inputs, self.name = fn, state, inputs, name

    def __call__(self):
        new_state, outputs = self.fn(self.state, self.inputs)
        refill(self.state, new_state)          # the write-back
        return outputs


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
