"""Checkpoint / resume: full-state snapshots of a running pipeline (port of
`sr_livo_tpu/runtime/checkpoint.py`, same file layout).

The estimation state (ESKF, geometry voxel map, and with a vision module
the camera filter, colored map, track table and previous pyramid), the
host-side cutter buffers, the IMU initializer and the trajectory records
go into one .npz.  Each state tuple is stored as `<prefix>__<i>` leaves in
the field order of its NamedTuples (nested tuples flattened depth first)
plus a `meta` JSON with the JAX package's keys, so a checkpoint written by
either package loads into the other.  Host-side pipeline state the JAX
package does not save (the constant-velocity pose history, the dense-
keypoint hold, the initialization time) is not saved here either.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch


def _leaves(tree) -> List[torch.Tensor]:
    """Tensors of nested tuples in depth-first field order (the JAX
    package's pytree leaf order for NamedTuples and tuples)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub)]


def _rebuild(template, leaves):
    """`template`'s structure filled from the iterator `leaves`."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    subs = [_rebuild(sub, leaves) for sub in template]
    return type(template)(*subs) if hasattr(template, "_fields") \
        else type(template)(subs)


def _structure(tree) -> str:
    if isinstance(tree, torch.Tensor):
        return "*"
    inner = ", ".join(_structure(sub) for sub in tree)
    return f"{type(tree).__name__}({inner})"


def _flatten(prefix: str, tree, out: Dict[str, np.ndarray]):
    out[f"{prefix}__treedef"] = np.frombuffer(
        _structure(tree).encode(), dtype=np.uint8)
    for i, leaf in enumerate(_leaves(tree)):
        out[f"{prefix}__{i}"] = leaf.detach().cpu().numpy()


def _unflatten(prefix: str, template, data, device):
    """`template`'s structure with the saved leaves, in the template's
    dtypes, on `device`."""
    leaves = [torch.as_tensor(data[f"{prefix}__{i}"], dtype=leaf.dtype,
                              device=device)
              for i, leaf in enumerate(_leaves(template))]
    return _rebuild(template, iter(leaves))


def save_pipeline(pipeline, path: str):
    """Snapshot a LivoPipeline (and its VisionModule) to `path`."""
    out: Dict[str, np.ndarray] = {}
    _flatten("eskf", pipeline.state, out)
    _flatten("map", pipeline.voxel_map, out)
    ini = pipeline.initializer
    cutter = pipeline.cutter
    meta = {
        "initialized": pipeline.initialized,
        "current_time": pipeline.current_time,
        "index_frame": pipeline.index_frame,
        "cutter_last_get": cutter.last_get_measurement,
        "cutter_last_imu": cutter.last_time_imu,
        "cutter_last_lidar": cutter.last_time_lidar,
        "cutter_last_img": cutter.last_time_img,
        "has_vision": pipeline.vision is not None,
        "records": [
            {"time": r.time, "position": r.position.tolist(),
             "quat_wxyz": r.quat_wxyz.tolist(),
             "velocity": r.velocity.tolist(), "ba": r.ba.tolist(),
             "bg": r.bg.tolist(), "success": r.success,
             "num_residuals": r.num_residuals, "iterations": r.iterations,
             "rendering": r.rendering}
            for r in pipeline.records],
        "initializer": {
            "n": ini.n, "first_time": ini.first_time,
            "last_time": ini.last_time, "mean_gyr": ini.mean_gyr.tolist(),
            "mean_acc": ini.mean_acc.tolist(),
            "var_gyr": ini.var_gyr.tolist(), "var_acc": ini.var_acc.tolist(),
        },
    }

    # host-side cutter buffers (pending sensor data)
    pb = cutter.points
    pend_pts = [chunk[pb._offset if i == 0 else 0:]
                for i, chunk in enumerate(pb._chunks)]
    out["cutter_points"] = (np.concatenate(pend_pts)
                            if pend_pts else np.zeros((0, 4)))
    imu = list(cutter.imu)
    out["cutter_imu"] = (np.array([[t, *a, *g] for (t, a, g) in imu])
                         if imu else np.zeros((0, 7)))

    if pipeline.vision is not None:
        v = pipeline.vision
        _flatten("camera", v.camera, out)
        _flatten("colormap", v.color_map, out)
        _flatten("tracks", v.tracks, out)
        meta["vision"] = {"first_data": v.first_data,
                          "prev_time": v.prev_time}
        if v.prev_pyr is not None:
            _flatten("prev_pyr", v.prev_pyr, out)

    out["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **out)


def load_pipeline(pipeline, path: str):
    """Restore a snapshot into a freshly constructed LivoPipeline with the
    same configuration (and VisionModule attachment) as the saved one; the
    tensors go to `pipeline.device`."""
    from sr_livo_tpu_torch.ops import lk
    from sr_livo_tpu_torch.pipeline import FrameRecord

    dev = pipeline.device
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["meta"]).decode())

    pipeline.state = _unflatten("eskf", pipeline.state, data, dev)
    pipeline.voxel_map = _unflatten("map", pipeline.voxel_map, data, dev)
    pipeline.initialized = meta["initialized"]
    pipeline.current_time = meta["current_time"]
    pipeline.index_frame = meta["index_frame"]
    cutter = pipeline.cutter
    cutter.last_get_measurement = meta["cutter_last_get"]
    cutter.last_time_imu = meta["cutter_last_imu"]
    cutter.last_time_lidar = meta["cutter_last_lidar"]
    cutter.last_time_img = meta["cutter_last_img"]

    pipeline.records = [
        FrameRecord(time=r["time"], position=np.array(r["position"]),
                    quat_wxyz=np.array(r["quat_wxyz"]),
                    velocity=np.array(r["velocity"]), ba=np.array(r["ba"]),
                    bg=np.array(r["bg"]), success=r["success"],
                    num_residuals=r["num_residuals"],
                    iterations=r["iterations"], rendering=r["rendering"])
        for r in meta["records"]]

    ini, saved = pipeline.initializer, meta["initializer"]
    ini.n = saved["n"]
    ini.first_time = saved["first_time"]
    ini.last_time = saved["last_time"]
    ini.mean_gyr = np.array(saved["mean_gyr"])
    ini.mean_acc = np.array(saved["mean_acc"])
    ini.var_gyr = np.array(saved["var_gyr"])
    ini.var_acc = np.array(saved["var_acc"])

    pts = data["cutter_points"]
    if pts.shape[0]:
        cutter.points.push(pts)
    for row in data["cutter_imu"]:
        cutter.imu.append((float(row[0]), row[1:4], row[4:7]))

    if meta.get("has_vision") and pipeline.vision is not None:
        v = pipeline.vision
        v.camera = _unflatten("camera", v.camera, data, dev)
        v.color_map = _unflatten("colormap", v.color_map, data, dev)
        v.tracks = _unflatten("tracks", v.tracks, data, dev)
        saved = meta["vision"]
        v.first_data = saved["first_data"]
        v.prev_time = saved["prev_time"]
        if "prev_pyr__treedef" in data and v.prev_time is not None:
            # a template pyramid of the image shape to restore into
            gray = torch.zeros((v.rows, v.cols), dtype=torch.float32,
                               device=dev)
            template = lk.precompute_frame(gray, v.lk_params.levels)
            v.prev_pyr = _unflatten("prev_pyr", template, data, dev)
    return pipeline
