"""Copies of the program's state in host memory, and their restoration
into the plain reference's classes.

The check follows the program frame by frame from the program's own state
(`check.py`): before a checked segment of frames, `snap(pipeline)` copies
every tensor the pipeline, its LIO engine, vision module and mapping
backend hold to host memory, with the host-side state (the sweep cutter's
buffers, the IMU initializer, the keyframes, the RANSAC generator's
state), walking the objects by their attributes.  `restore` rebuilds the
same object graph from the reference's classes (`livo_bench/ref`, whose
modules mirror the port's names), on a device, with the reference's own
configuration objects in place of the program's.

What is not state is left out: captured programs, timers, the output
publisher, the trajectory records and logs (`SKIP`).
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import types
from typing import Any, Dict

import numpy as np
import torch

PORT, REF = "sr_livo_tpu_torch", "livo_bench.ref"

# attributes that are not estimation state -> what the copy starts with
# (made on the copy's device)
def _timers(dev):
    from livo_bench.ref.pipeline import NoTimers
    return NoTimers()


SKIP = {"programs": lambda dev: {}, "insert_programs": lambda dev: {},
        "timers": _timers, "stream": lambda dev: None,
        "_records": lambda dev: [], "_pending_records": lambda dev: [],
        "_trigger_log": lambda dev: [], "_stats": lambda dev: [],
        "_stats_full": lambda dev: [], "_stats_pending": lambda dev: [],
        "noise_hook": lambda dev: None}
CONFIGS = ("cfg",)


@dataclasses.dataclass
class Obj:
    """An object of the program's package: its class and attributes."""
    module: str
    name: str
    attrs: Dict[str, Any]
    skipped: list


@dataclasses.dataclass
class Tup:
    """A NamedTuple of the program's package."""
    module: str
    name: str
    fields: list


@dataclasses.dataclass
class Gen:
    device: str
    state: torch.Tensor


class _Cfg:
    """Marks a configuration object: the reference brings its own."""

    def __init__(self, name: str):
        self.name = name


def _ours(x) -> bool:
    return type(x).__module__.split(".")[0] == PORT


def snap(x):
    """A host copy of `x` (see the module docstring)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, torch.Generator):
        return Gen(str(x.device), x.get_state())
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, (int, float, bool, str, type(None), torch.device,
                      torch.dtype, np.generic)):
        return x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        if _ours(x):
            return Tup(type(x).__module__, type(x).__name__,
                       [snap(v) for v in x])
        return type(x)(*(snap(v) for v in x))
    if isinstance(x, collections.deque):
        return collections.deque(snap(v) for v in x)
    if isinstance(x, (list, tuple)):
        return type(x)(snap(v) for v in x)
    if isinstance(x, dict):
        return {k: snap(v) for k, v in x.items()}
    if _ours(x) and hasattr(x, "__dict__"):
        attrs, skipped = {}, []
        for k, v in vars(x).items():
            if k in SKIP:
                skipped.append(k)
                continue
            if isinstance(v, (types.FunctionType, types.MethodType)):
                continue      # code set on the object, not state
            attrs[k] = (_Cfg(type(v).__name__) if k in CONFIGS
                        else snap(v))
        return Obj(type(x).__module__, type(x).__name__, attrs, skipped)
    raise TypeError(f"cannot copy a {type(x).__module__}."
                    f"{type(x).__name__} of the program's state")


def _ref_class(module: str, name: str):
    if module.split(".")[0] != PORT:
        raise TypeError(f"{module}.{name} is not the program's")
    return getattr(importlib.import_module(REF + module[len(PORT):]), name)


def restore(s, device, configs: Dict[str, Any]):
    """`snap`'s copy rebuilt from the reference's classes on `device`;
    `configs` maps a configuration class name to the reference's object."""
    dev = torch.device(device)
    if isinstance(s, torch.Tensor):
        return s.to(dev, copy=True)
    if isinstance(s, Gen):
        g = torch.Generator(device=dev if s.device != "cpu" else "cpu")
        g.set_state(s.state)
        return g
    if isinstance(s, np.ndarray):
        return s.copy()
    if isinstance(s, torch.device):
        return dev if s.type != "cpu" or dev.type == "cpu" else s
    if isinstance(s, Tup):
        return _ref_class(s.module, s.name)(
            *(restore(v, device, configs) for v in s.fields))
    if isinstance(s, Obj):
        cls = _ref_class(s.module, s.name)
        obj = cls.__new__(cls)
        for k, v in s.attrs.items():
            setattr(obj, k, configs[v.name] if isinstance(v, _Cfg)
                    else restore(v, device, configs))
        for k in s.skipped:
            setattr(obj, k, SKIP[k](dev))
        return obj
    if isinstance(s, tuple) and hasattr(s, "_fields"):
        return type(s)(*(restore(v, device, configs) for v in s))
    if isinstance(s, collections.deque):
        return collections.deque(restore(v, device, configs) for v in s)
    if isinstance(s, (list, tuple)):
        return type(s)(restore(v, device, configs) for v in s)
    if isinstance(s, dict):
        return {k: restore(v, device, configs) for k, v in s.items()}
    return s
