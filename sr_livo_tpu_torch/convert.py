"""Carry filter state, maps, tracks and backend inputs between numpy and
the port's tensors.

The JAX package's `EskfState`, `VoxelMap`, `CameraState`, `ColorMap`,
`TrackState`, `PoseGraph` and `KeyframeWindow` have the same field names
and layouts as the port's, so a state or map taken out of either package
as numpy arrays (a dict, or a NamedTuple whose fields convert with
`np.asarray`) can be fed to the other; the parity tests do that to give
both packages the same inputs.  Backend keyframes and pose-graph edges
are host records (dataclass / dict of numpy arrays) in both packages.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from sr_livo_tpu_torch.models.camera import CameraState
from sr_livo_tpu_torch.models.eskf import EskfState
from sr_livo_tpu_torch.models.vision import TrackState
from sr_livo_tpu_torch.ops.color_map import ColorMap
from sr_livo_tpu_torch.ops.voxel_map import VoxelMap
from sr_livo_tpu_torch.parallel.ba import KeyframeWindow
from sr_livo_tpu_torch.parallel.backend import Keyframe
from sr_livo_tpu_torch.parallel.pose_graph import PoseGraph


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


_GRAPH_DTYPES = {"q": torch.float32, "t": torch.float32,
                 "edge_i": torch.int64, "edge_j": torch.int64,
                 "q_meas": torch.float32, "t_meas": torch.float32,
                 "rot_w": torch.float32, "t_w": torch.float32,
                 "edge_valid": torch.bool}


def pose_graph_from_numpy(obj, device="cpu") -> PoseGraph:
    """A PoseGraph (edge indices as int64, the index type of torch)."""
    return _to_torch(PoseGraph, obj, device, _GRAPH_DTYPES)


_WINDOW_DTYPES = {"q": torch.float32, "t": torch.float32,
                  "points": torch.float32, "pt_valid": torch.bool,
                  "kf_valid": torch.bool}


def keyframe_window_from_numpy(obj, device="cpu") -> KeyframeWindow:
    return _to_torch(KeyframeWindow, obj, device, _WINDOW_DTYPES)


def keyframes_from_numpy(keyframes) -> List[Keyframe]:
    """Backend keyframes from objects (or dicts) with time, q, t, points
    and valid, copied into host arrays."""
    return [Keyframe(time=float(_get(k, "time")),
                     q=np.array(_get(k, "q"), np.float32),
                     t=np.array(_get(k, "t"), np.float32),
                     points=np.array(_get(k, "points"), np.float32),
                     valid=np.array(_get(k, "valid"), bool))
            for k in keyframes]


def edges_from_numpy(edges) -> List[dict]:
    """Backend pose-graph edges (dicts of i, j, q, t, rot_w, t_w), copied."""
    return [dict(i=int(e["i"]), j=int(e["j"]),
                 q=np.array(e["q"], np.float32),
                 t=np.array(e["t"], np.float32),
                 rot_w=float(e["rot_w"]), t_w=float(e["t_w"]))
            for e in edges]
