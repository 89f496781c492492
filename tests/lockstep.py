"""The port's LIO step run in lockstep with the JAX pipeline's.

Two closed-loop runs, one per package, part at float32 round-off, and the
loop carries it on: the IEKF's sums run in another order (XLA's against
PyTorch's), its weakly observed velocity comes out a little apart, a map
point then lands in another voxel, and from there on a convergence test
at its threshold may go either way.  Lockstep takes that out: within the
block, every call of the JAX `LioEngine.step` first runs the port's
`LioEngine.step` on copies of the same state, map, sweep and pose seed,
and records both steps' outcomes side by side.  The JAX run goes on from its own step.

Each frame also records each IEKF update the two steps ran, as
(nb_voxels_visited, success, residual count): the JAX ones through a
`jax.debug.callback` traced into its program, so pipelines built within
the block carry it.  `port_updates` records the same of a port run on
its own.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Tuple

import jax
import numpy as np
import torch

from sr_livo_tpu.models import lio as jlio
from sr_livo_tpu.models import odometry as jodo
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.models import lio as tlio
from sr_livo_tpu_torch.models import odometry as todo

# one IEKF update: (nb_voxels_visited, success, residual count)
Update = Tuple[int, bool, int]


class Frame(NamedTuple):
    jax: Tuple[bool, int, int]      # success, residual count, iterations
    port: Tuple[bool, int, int]
    position_gap: float             # m, largest coordinate difference
    velocity_gap: float             # m/s, largest coordinate difference
    jax_updates: List[Update]
    port_updates: List[Update]


def _summary(out) -> Tuple[bool, int, int]:
    s = out.summary
    return bool(s.success), int(s.num_residuals), int(s.iterations)


def _update(kw, summary) -> Update:
    return (kw["nb_voxels_visited"], bool(summary.success),
            int(summary.num_residuals))


def _tensor(x):
    return torch.from_numpy(np.array(x))


@contextlib.contextmanager
def port_updates():
    """Within the block, the port's IEKF updates, one list per LIO step
    (`LioEngine.step`), each update as an `Update`."""
    steps: List[List[Update]] = []
    step, iekf = todo.LioEngine.step, tlio.iekf_update

    def frame(*args, **kw):
        steps.append([])
        return step(*args, **kw)

    def update(*args, **kw):
        state, summary = iekf(*args, **kw)
        steps[-1].append(_update(kw, summary))
        return state, summary
    todo.LioEngine.step, tlio.iekf_update = frame, update
    try:
        yield steps
    finally:
        todo.LioEngine.step, tlio.iekf_update = step, iekf


class Lockstep:
    """`with Lockstep(port_cfg) as ls:` run a JAX pipeline; `ls.frames`
    then holds one `Frame` per JAX LIO step."""

    def __init__(self, port_cfg):
        self.engine = todo.LioEngine(port_cfg, device="cpu")
        self.frames: List[Frame] = []
        self._jax_updates: List[Update] = []
        self._port_updates: List[Update] = []

    def _patch(self, owner, name, value):
        self._undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def __enter__(self):
        self._undo = []
        jax_step, port_iekf, jax_iekf = (jodo.LioEngine.step,
                                         tlio.iekf_update, jlio.iekf_update)
        ls = self

        def port_update(*args, **kw):
            state, summary = port_iekf(*args, **kw)
            ls._port_updates.append(_update(kw, summary))
            return state, summary

        def jax_update(*args, **kw):
            state, summary = jax_iekf(*args, **kw)

            def record(ok, n, nb=kw["nb_voxels_visited"]):
                ls._jax_updates.append((nb, bool(ok), int(n)))
            jax.debug.callback(record, summary.success,
                               summary.num_residuals)
            return state, summary

        def step(engine, state, vmap, sweep, frame_id, prev_poses=None,
                 gyr_rate=0.0):
            # copies first: the JAX step donates the map
            sweep_cls = (todo.WireSweep if isinstance(sweep, jodo.WireSweep)
                         else todo.SweepInput)
            port_args = (
                convert.eskf_state_from_numpy(state),
                convert.voxel_map_from_numpy(vmap),
                sweep_cls(**{f: _tensor(getattr(sweep, f))
                             for f in sweep._fields}),
                frame_id,
                None if prev_poses is None else tuple(
                    tuple(_tensor(v) for v in pose) for pose in prev_poses),
                gyr_rate)
            del ls._port_updates[:], ls._jax_updates[:]
            port_out = ls.engine.step(*port_args)
            out = jax_step(engine, state, vmap, sweep, frame_id, prev_poses,
                           gyr_rate)
            jax.effects_barrier()
            gap = [float(np.abs(np.asarray(getattr(out.state, f))
                                - getattr(port_out.state, f).numpy()).max())
                   for f in ("p", "v")]
            ls.frames.append(Frame(
                _summary(out), _summary(port_out), *gap,
                sorted(ls._jax_updates), list(ls._port_updates)))
            return out

        self._patch(jodo.LioEngine, "step", step)
        self._patch(tlio, "iekf_update", port_update)
        self._patch(jlio, "iekf_update", jax_update)
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self._undo):
            setattr(owner, name, value)
