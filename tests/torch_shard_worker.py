"""Ranks of the port's multi-device tests, one process each.

The port's mesh runs one process per rank (parallel.mesh).  A test runs
`run_ranks(task, world, workdir, inputs)`: it writes each rank's inputs,
starts `world` copies of this file as subprocesses that meet through a
`torch.distributed.FileStore` in `workdir` (no TCP port, so parallel test
workers do not collide), and returns each rank's outputs.  Each rank
joins a gloo process group, runs `TASKS[task]` on one intra-op thread on
the CPU and writes its outputs.  This file imports torch, numpy and the
port only (never JAX): a started process imports nothing else.

    python tests/torch_shard_worker.py TASK RANK WORLD WORKDIR
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from typing import Callable, Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(task: str, world: int, workdir, inputs: List[dict],
              env: Dict[str, str] = None, timeout: float = 600.0
              ) -> List[dict]:
    """Run `task` on `world` ranks; `inputs[r]` is rank r's input.
    Returns the ranks' outputs in rank order."""
    workdir = str(workdir)
    for r in range(world):
        with open(os.path.join(workdir, f"in_{r}.pkl"), "wb") as f:
            pickle.dump(inputs[r], f)
    penv = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    penv.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), task, str(r), str(world),
         workdir], cwd=REPO, env=penv, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of task {task} exited "
                               f"{p.returncode}:\n{log[-6000:]}")
    outs = []
    for r in range(world):
        with open(os.path.join(workdir, f"out_{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


# ---------------------------------------------------------------------------
# tasks: fn(inputs, rank, world) -> outputs, inside the process group
# ---------------------------------------------------------------------------

def _np(t):
    # a copy: a step's state may be its program's buffers
    return t.detach().cpu().numpy().copy()


class _Counted:
    """Within the block, counts each collective `mesh` calls."""

    NAMES = ("psum", "all_to_all", "all_gather")

    def __init__(self, mesh):
        self.mesh, self.calls = mesh, dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        for name in self.NAMES:
            def call(t, _fn=getattr(self.mesh, name), _name=name):
                self.calls[_name] += 1
                return _fn(t)
            setattr(self.mesh, name, call)
        return self

    def __exit__(self, *exc):
        for name in self.NAMES:
            delattr(self.mesh, name)


def _sweep(d):
    from sr_livo_tpu_torch.models.odometry import SweepInput
    dt = {"pt_valid": torch.bool, "imu_valid": torch.bool,
          "do_optimize": torch.bool, "threshold_capacity": torch.int32}
    return SweepInput(**{k: torch.tensor(np.asarray(d[k]),
                                         dtype=dt.get(k, torch.float32))
                         for k in SweepInput._fields})


def _step_record(eng, out) -> dict:
    s = out.summary
    return dict(
        state={k: _np(v) for k, v in out.state._asdict().items()},
        success=bool(s.success), num_residuals=int(s.num_residuals),
        iterations=int(s.iterations), frame_valid=_np(out.frame_valid),
        inserted=_np(out.inserted), frame_pts_world=_np(out.frame_pts_world),
        record=_np(out.record), route_overflow=int(out.route_overflow),
        map_size=int(eng.map_size(out.voxel_map)))


def task_engine(inputs, rank, world) -> dict:
    """ShardedLioEngine runs.  Each run is lockstep (the given per-step
    state and this rank's map slice before every step) or closed loop
    (from init_state and an empty map); with `capture_form` every step
    runs as a program's capture records it (`graphs.capture_form()`).
    Each step's record holds the collectives the step called; each run
    records the programs its engine built (`programs`: none over gloo)."""
    import contextlib

    from sr_livo_tpu_torch import convert
    from sr_livo_tpu_torch.parallel.mesh import make_mesh
    from sr_livo_tpu_torch.parallel.sharded_lio import ShardedLioEngine
    from sr_livo_tpu_torch.utils import graphs
    mesh = make_mesh(world, device="cpu")
    out = {}
    for run in inputs["runs"]:
        eng = ShardedLioEngine(run["cfg"], mesh,
                               budget_override=run.get("budget_override"))
        form = (graphs.capture_form if run.get("capture_form")
                else contextlib.nullcontext)
        steps = []
        state, vmap = eng.init_state(), eng.make_map()
        for i, (sw, fid) in enumerate(zip(run["sweeps"], run["frame_ids"])):
            if run["lockstep"]:
                state = convert.eskf_state_from_numpy(run["states"][i])
                vmap = convert.voxel_map_from_numpy(run["maps"][i])
            with _Counted(mesh) as counted, form():
                o = eng.step(state, vmap, _sweep(sw), fid)
            steps.append(dict(_step_record(eng, o),
                              collectives=dict(counted.calls)))
            state, vmap = o.state, o.voxel_map
        out[run["name"]] = steps
        out[run["name"] + ":programs"] = len(eng.programs)
    return out


def task_ba(inputs, rank, world) -> dict:
    """make_sharded_windowed_ba on this rank's map slice for each set of
    keywords, eagerly and (`ba_capture`) as `sharded_windowed_ba_program`
    in capture form with its collectives counted, then
    ShardedLioEngine.compact of the same map."""
    from sr_livo_tpu_torch import convert
    from sr_livo_tpu_torch.parallel import ba
    from sr_livo_tpu_torch.parallel.mesh import make_mesh
    from sr_livo_tpu_torch.parallel.sharded_lio import ShardedLioEngine
    from sr_livo_tpu_torch.utils import graphs
    mesh = make_mesh(world, device="cpu")
    window = convert.keyframe_window_from_numpy(inputs["window"])
    q_odo = torch.as_tensor(inputs["q_odo"])
    t_odo = torch.as_tensor(inputs["t_odo"])
    out = {"ba": [], "ba_capture": []}
    programs = {}
    for kw in inputs["ba_kwargs"]:
        fn = ba.make_sharded_windowed_ba(mesh, window.q.shape[0], **kw)
        q, t, ovf = fn(convert.voxel_map_from_numpy(inputs["map"]), window,
                       q_odo, t_odo)
        out["ba"].append(dict(q=_np(q), t=_np(t), overflow=int(ovf)))
        with _Counted(mesh) as counted, graphs.capture_form():
            q, t, ovf = ba.sharded_windowed_ba_program(
                programs, mesh, convert.voxel_map_from_numpy(inputs["map"]),
                window, q_odo, t_odo, **kw)
        out["ba_capture"].append(dict(q=_np(q), t=_np(t),
                                      overflow=int(ovf),
                                      collectives=dict(counted.calls)))
    out["ba_programs"] = len(programs)
    eng = ShardedLioEngine(inputs["cfg"], mesh)
    vmap = convert.voxel_map_from_numpy(inputs["map"])
    before = int(eng.map_size(vmap))
    m2, dropped = eng.compact(vmap, inputs["location"])
    out["compact"] = dict(dropped=int(dropped), map_size=int(eng.map_size(m2)),
                          map=convert.voxel_map_to_numpy(m2),
                          map_size_before=before)
    return out


def task_routing(inputs, rank, world) -> dict:
    """pack_for_exchange + exchange of tagged rows to random owners."""
    from sr_livo_tpu_torch.parallel import routing
    from sr_livo_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(world, device="cpu")
    dest = torch.as_tensor(inputs["dest"])
    valid = torch.as_tensor(inputs["valid"])
    m = dest.shape[0]
    payload = rank * 1000 + torch.arange(m, dtype=torch.int32)
    buf, bval, dropped = routing.pack_for_exchange(
        dest, valid, routing.pack_cols(payload), world, inputs["budget"])
    rcv, rval = routing.exchange(buf, bval, mesh)
    got = torch.where(rval, routing.unpack_col_i32(rcv, 0),
                      torch.full_like(rval, -1, dtype=torch.int32))
    return dict(got=_np(got), dropped=int(mesh.psum(dropped)))


def task_distributed(inputs, rank, world) -> dict:
    """The mesh's collectives on the world mesh, and the (host, map)
    mesh (LOCAL_WORLD_SIZE set by the caller)."""
    from sr_livo_tpu_torch.parallel import distributed
    from sr_livo_tpu_torch.parallel.mesh import MAP_AXIS, make_mesh
    mesh = make_mesh(device="cpu")
    x = torch.as_tensor(inputs["x"])                 # (world, 3, 2) f32
    i = torch.as_tensor(inputs["i"])                 # (world, 5) int32
    out = dict(rank=mesh.rank, size=mesh.size,
               psum_f32=_np(mesh.psum(x[rank])), psum_i32=_np(mesh.psum(i[rank])),
               all_gather=_np(mesh.all_gather(x[rank])),
               all_to_all=_np(mesh.all_to_all(x[rank].repeat(world, 1, 1)[
                   :, :1, :] + 10 * torch.arange(world)[:, None, None])))
    hm = distributed.make_host_map_mesh(device="cpu")
    one = torch.tensor([float(rank)])
    out.update(shape=dict(hm.shape), host_index=hm.host_index,
               map_rank=hm.axis(MAP_AXIS).rank,
               map_sum=float(hm.axis(MAP_AXIS).psum(one)),
               host_sum=float(hm.axis(distributed.HOST_AXIS).psum(one)),
               keyframes=distributed.shard_keyframes_by_host(
                   inputs["n_keyframes"], hm))
    return out


TASKS: Dict[str, Callable] = {"engine": task_engine, "ba": task_ba,
                              "routing": task_routing,
                              "distributed": task_distributed}


def main() -> int:
    task, rank, world, workdir = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
        rank=rank, world_size=world)
    try:
        with open(os.path.join(workdir, f"in_{rank}.pkl"), "rb") as f:
            inputs = pickle.load(f)
        out = TASKS[task](inputs, rank, world)
        with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
