"""Carry filter state and voxel maps between numpy and the port's tensors.

The JAX package's `EskfState` and `VoxelMap` have the same field names
and layouts as the port's, so a state or map taken out of either package
as numpy arrays (a dict, or a NamedTuple whose fields convert with
`np.asarray`) can be fed to the other; the parity tests do that to give
both packages the same filter state and the same map.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sr_livo_tpu_torch.models.eskf import EskfState
from sr_livo_tpu_torch.ops.voxel_map import VoxelMap


def _fields(obj, names) -> Dict[str, np.ndarray]:
    get = obj.__getitem__ if isinstance(obj, dict) else (
        lambda k: getattr(obj, k))
    return {k: np.asarray(get(k)) for k in names}


def _to_torch(cls, obj, device, dtypes):
    arrays = _fields(obj, cls._fields)
    return cls(**{k: torch.tensor(a, dtype=dtypes[k], device=device)
                  for k, a in arrays.items()})


def _to_numpy(tup) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in tup._asdict().items()}


def eskf_state_from_numpy(obj, device="cpu") -> EskfState:
    return _to_torch(EskfState, obj, device,
                     {k: torch.float32 for k in EskfState._fields})


def eskf_state_to_numpy(state: EskfState) -> Dict[str, np.ndarray]:
    return _to_numpy(state)


_MAP_DTYPES = {"keys": torch.int32, "sig": torch.int32,
               "points": torch.float32, "counts": torch.int32,
               "point_ids": torch.int32}


def voxel_map_from_numpy(obj, device="cpu") -> VoxelMap:
    return _to_torch(VoxelMap, obj, device, _MAP_DTYPES)


def voxel_map_to_numpy(vmap: VoxelMap) -> Dict[str, np.ndarray]:
    return _to_numpy(vmap)
