"""Multi-host start-up and the (host, map) mesh (port of
`sr_livo_tpu/parallel/distributed.py`).

Keyframe and map-block partitioning over N >= 2 hosts.  The port runs
one process per device: the `map` axis is the ranks of one node (the
card-to-card links, NVLink on an H100 host), the `host` axis one rank per
node across nodes, so the frequent collectives (the per-sweep routing
and normal-equation psums of a host's map group) stay inside a node and
only the windowed-BA block exchange and pose-graph synchronisation
cross nodes.  Ranks are laid out node-major: rank = host * L + local,
with L = LOCAL_WORLD_SIZE.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch.distributed as dist

from sr_livo_tpu_torch.parallel.mesh import MAP_AXIS, Mesh

HOST_AXIS = "host"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "nccl") -> None:
    """`torch.distributed.init_process_group` (a no-op for one process).

    Without arguments it reads the standard variables: WORLD_SIZE and
    RANK, and MASTER_ADDR / MASTER_PORT through the `env://` rendezvous.
    `coordinator_address` is an init method such as
    "tcp://host:port" or "file:///path".  `backend` is explicit: "nccl"
    for CUDA tensors across cards, "gloo" for CPU tensors."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=coordinator_address or
                            "env://", world_size=num_processes,
                            rank=process_id)


class HostMapMesh:
    """This rank's place in the 2-D (host, map) mesh: `shape` maps each
    axis name to its size, `axis(name)` is the 1-D Mesh of this rank's
    group along that axis, and `host_index` is this rank's node."""

    def __init__(self, host: Mesh, map_: Mesh):
        self._axes = {HOST_AXIS: host, MAP_AXIS: map_}
        self.shape = {HOST_AXIS: host.size, MAP_AXIS: map_.size}
        self.host_index = host.rank
        self.device = map_.device

    def axis(self, name: str) -> Mesh:
        return self._axes[name]


def make_host_map_mesh(map_parallelism: Optional[int] = None, *,
                       device="cuda") -> Optional[HostMapMesh]:
    """The (host, map) mesh over the default process group: `host` spans
    nodes, `map` the local ranks of a node (at most `map_parallelism` of
    them).  Every rank must call it (the axis groups are made
    collectively).  A rank left out of the mesh by `map_parallelism` gets
    None.  With one process this is (1, 1), the world of one."""
    if not dist.is_initialized():
        one = Mesh(0, 1, device, None, HOST_AXIS)
        return HostMapMesh(one, Mesh(0, 1, device, None, MAP_AXIS))
    world, rank = dist.get_world_size(), dist.get_rank()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE {local} does not divide the "
                         f"world of {world}")
    n_hosts = world // local
    per_host = local if map_parallelism is None else min(local,
                                                         map_parallelism)
    grid = [[h * local + j for j in range(per_host)] for h in range(n_hosts)]
    host, mine = None, None
    # new_group is collective: every rank creates every group, in order
    for h in range(n_hosts):
        g = dist.new_group(grid[h])
        if rank in grid[h]:
            mine = Mesh(grid[h].index(rank), per_host, device, g, MAP_AXIS)
    for j in range(per_host):
        ranks = [grid[h][j] for h in range(n_hosts)]
        g = dist.new_group(ranks)
        if rank in ranks:
            host = Mesh(ranks.index(rank), n_hosts, device, g, HOST_AXIS)
    if mine is None:
        return None
    return HostMapMesh(host, mine)


def shard_keyframes_by_host(n_keyframes: int, mesh: HostMapMesh
                            ) -> Tuple[int, int]:
    """Contiguous keyframe range [lo, hi) owned by this rank's host
    (keyframe partitioning for distributed windowed BA)."""
    n_hosts = mesh.shape[HOST_AXIS]
    me = mesh.host_index
    per = -(-n_keyframes // n_hosts)
    lo = min(me * per, n_keyframes)
    hi = min(lo + per, n_keyframes)
    return lo, hi
