"""The map mesh of the multi-device engine (port of
`sr_livo_tpu/parallel/mesh.py`).

JAX runs a `shard_map` body once per device of a `Mesh`, and the body
reduces and exchanges through `psum`, `all_to_all` and `all_gather` over
a named axis.  The port runs one process per rank: every rank runs the
same body on its own tensors, and the `Mesh` below carries the rank, the
group size, the rank's device, the process group and those three
collectives over `torch.distributed`.  The backend is the process
group's, chosen where the group is made (`torch.distributed.
init_process_group` or `parallel.distributed.initialize_distributed`):
NCCL for CUDA tensors across cards, gloo for CPU tensors (and for CUDA
tensors of ranks that share a card, which NCCL refuses; gloo stages
them through host memory).  A mesh without a process group is a world
of one: rank 0 of 1, and every collective is the identity, as on JAX's
1-device mesh.  A mesh made over a process group calls its collectives
whatever the group's size, so a world of one over NCCL runs NCCL.

`map_sharding` and `replicated` have no counterpart.  A sharded tensor is
each rank's own local part (the voxel map: every rank holds its own
sub-table), and a replicated tensor is the same tensor on every rank.
Every rank must call the same collectives in the same order, so only
replicated values may decide on the host whether one is called.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from sr_livo_tpu_torch.utils.device import resolve_device

MAP_AXIS = "map"


class Mesh:
    """One rank's view of a 1-D device mesh over `axis`."""

    def __init__(self, rank: int, size: int, device, group=None,
                 axis: str = MAP_AXIS):
        if group is None and size != 1:
            raise ValueError(f"a mesh of {size} ranks needs a process group")
        self.rank, self.size, self.axis = rank, size, axis
        self.device = resolve_device(device)
        self.group = group

    def __repr__(self):
        backend = (dist.get_backend(self.group) if self.group is not None
                   else "none")
        return (f"Mesh({self.axis}: rank {self.rank} of {self.size} on "
                f"{self.device}, backend {backend})")

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks (`jax.lax.psum`); every rank gets the same
        bits.  Takes float and integer tensors, not bool (neither NCCL
        nor gloo sums bool)."""
        if t.dtype == torch.bool:
            raise TypeError("psum of a bool tensor: cast it to int32 first")
        if self.group is None:
            return t
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """`jax.lax.all_to_all(t, axis, 0, 0)`: chunk j of the leading
        dimension (of size `self.size`) goes to rank j, and the received
        chunks stack in source-rank order."""
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all: leading dim {t.shape[0]}, "
                             f"expected {self.size}")
        if self.group is None:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """`jax.lax.all_gather(t, axis)`: (size, *t.shape), rank order."""
        if self.group is None:
            return t[None]
        out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather(list(out.unbind(0)), t.contiguous(),
                        group=self.group)
        return out


def make_mesh(n_devices: Optional[int] = None, axis: str = MAP_AXIS, *,
              device="cuda", group=None) -> Mesh:
    """This rank's mesh over `group` (the default process group when
    None).  `n_devices=1`, or no initialized process group, gives a world
    of one on `device`, as JAX's `make_mesh(1)` gives a 1-device mesh;
    any other `n_devices` must be the group's size."""
    if n_devices == 1 or (group is None and not dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}): no process group "
                             "is initialized")
        return Mesh(0, 1, device, None, axis)
    group = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(group)
    if n_devices not in (None, size):
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{size} ranks")
    return Mesh(dist.get_rank(group), size, device, group, axis)
