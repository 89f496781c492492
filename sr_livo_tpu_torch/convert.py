"""Carry filter state, maps and tracks between numpy and the port's tensors.

The JAX package's `EskfState`, `VoxelMap`, `CameraState`, `ColorMap` and
`TrackState` have the same field names and layouts as the port's, so a
state or map taken out of either package as numpy arrays (a dict, or a
NamedTuple whose fields convert with `np.asarray`) can be fed to the
other; the parity tests do that to give both packages the same filter
state, the same maps and the same tracks.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sr_livo_tpu_torch.models.camera import CameraState
from sr_livo_tpu_torch.models.eskf import EskfState
from sr_livo_tpu_torch.models.vision import TrackState
from sr_livo_tpu_torch.ops.color_map import ColorMap
from sr_livo_tpu_torch.ops.voxel_map import VoxelMap


def _get(obj, k):
    return obj[k] if isinstance(obj, dict) else getattr(obj, k)


def _fields(obj, names) -> Dict[str, np.ndarray]:
    return {k: np.asarray(_get(obj, k)) for k in names}


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


def camera_state_from_numpy(obj, device="cpu") -> CameraState:
    return _to_torch(CameraState, obj, device,
                     {k: torch.float32 for k in CameraState._fields})


def camera_state_to_numpy(cam: CameraState) -> Dict[str, np.ndarray]:
    return _to_numpy(cam)


_COLOR_DTYPES = {"reg": torch.float32, "count": torch.int32,
                 "vox_last_visit": torch.float32, "dedup_sig": torch.int32,
                 "recent_slots": torch.int32}


def color_map_from_numpy(obj, device="cpu") -> ColorMap:
    """A ColorMap from numpy arrays; the nested voxel table `vox` is a
    VoxelMap-like object or dict."""
    arrays = _fields(obj, _COLOR_DTYPES)
    return ColorMap(vox=voxel_map_from_numpy(_get(obj, "vox"), device),
                    **{k: torch.tensor(a, dtype=_COLOR_DTYPES[k],
                                       device=device)
                       for k, a in arrays.items()})


def color_map_to_numpy(cmap: ColorMap) -> Dict[str, object]:
    out = {k: getattr(cmap, k).detach().cpu().numpy() for k in _COLOR_DTYPES}
    out["vox"] = voxel_map_to_numpy(cmap.vox)
    return out


_TRACK_DTYPES = {"reg_id": torch.int32, "px": torch.float32,
                 "active": torch.bool}


def tracks_from_numpy(obj, device="cpu") -> TrackState:
    return _to_torch(TrackState, obj, device, _TRACK_DTYPES)


def tracks_to_numpy(tracks: TrackState) -> Dict[str, np.ndarray]:
    return _to_numpy(tracks)
