"""Whether the timed path's frames are right.

1. Lockstep with the plain reference (`livo_bench/ref`: the port's plain
   path, frozen).  Float32 closed loops part over time, so the reference
   cannot run beside the program from the first message and agree to
   float32 round-off (PERF.md, section 2: from the first message it parts
   by millimetres, as far as the TF32 control does).  Instead, segments
   of consecutive window frames drawn from the seed are followed in
   lockstep: before a segment's first frame is handed over, the program's
   whole state is copied to host memory (`snapshot.snap`, with the
   window's clock stopped); after its last pose is on the host, the state
   again.  Once the window has closed and the program is freed, the
   reference is rebuilt from the first copy, takes the segment's raw
   messages through the same entry (`push_*`, `process_available`), and
   the numbers below compare what it gives with what the program gave,
   the largest over the segments:

     pose_m       widest gap of a published position (the LIO step), m,
                  over every sweep's pose: gap-fill sweeps without an
                  image too
     rot_rad      widest gap of its orientation, rad
     map_rows     share of voxel-map rows held by one side only, after the
                  segment's inserts
     map_m        widest gap of a voxel-map point held by both
     color_rows   share of colored-map registry rows held by one side only
     color_m      widest gap of a registry position held by both
     track_px     widest gap of a track's pixel, tracks live on both sides
                  in one slot on one map point (the vision frame: LK,
                  RANSAC, the track upkeep)

   A frame posed on one side only, or with another number of poses,
   reads as infinite.

2. Against the generator's ground truth, which no code of the port
   computes:

     ate_m        RMSE of the window's published positions against the
                  true ones, after the best rigid alignment (the accuracy
                  gate's ATE), m

The limits are in `livo_bench/limits/<workload>.json`; `correct` holds
when every number named there is finite and within its limit.  With
`tf32=True` the reference runs with TF32 matrix products, one precision
below the configuration's float32 with TF32 off: the control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from livo_bench import snapshot
from livo_bench.gen.ate import ate_rmse


@dataclass
class Segment:
    start: int                       # window frame offset of its first
    length: int
    frames: list = field(default_factory=list)      # traffic.Frame
    pre: object = None               # snapshot before the first frame
    post: object = None              # snapshot after the last pose
    # the program's FrameRecords: every pose of its frames, None for a
    # frame that yields none
    records: list = field(default_factory=list)


def plan(rng: np.random.Generator, n_segments: int, length: int,
         span: int) -> List[Segment]:
    """`n_segments` non-overlapping segments of `length` frames with
    first frames drawn from the seed within the window's first `span`."""
    slots = span // length
    if slots < n_segments:
        raise ValueError(f"{n_segments} segments of {length} frames do not "
                         f"fit in {span}")
    picks = sorted(rng.choice(slots, size=n_segments, replace=False))
    return [Segment(int(p) * length, length) for p in picks]


def feed(pipe, frame) -> int:
    """Hand one frame's messages over and process what can be cut;
    returns the frames processed."""
    for kind, payload in frame.events:
        if kind == "imu":
            pipe.push_imu(*payload)
        elif kind == "pts":
            pipe.push_points(payload)
        else:
            pipe.push_image(*payload)
    return pipe.process_available()


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _field(obj, name):
    """Attribute of a live object or of a snapshot copy (None if absent)."""
    if obj is None:
        return None
    if isinstance(obj, snapshot.Obj):
        return obj.attrs.get(name)
    return getattr(obj, name, None)


def _tup(obj, i):
    if isinstance(obj, snapshot.Tup):
        return obj.fields[i]
    return obj[i]


def view(pipe) -> Dict[str, object]:
    """The compared state of a pipeline (a live reference pipeline or a
    program snapshot), as CPU tensors."""
    out = {}
    vmap = _field(pipe, "voxel_map")
    if vmap is not None:
        # VoxelMap(keys, sig, points, counts, point_ids)
        out["map"] = tuple(_t(_tup(vmap, i)).cpu() for i in range(4))
    vision = _field(pipe, "vision")
    if vision is not None:
        cmap = _field(vision, "color_map")
        # ColorMap(reg, count, ...)
        out["color"] = (_t(_tup(cmap, 0)).cpu(), int(_t(_tup(cmap, 1))))
        tracks = _field(vision, "tracks")
        # TrackState(reg_id, px, active)
        out["tracks"] = tuple(_t(_tup(tracks, i)).cpu() for i in range(3))
    return out


def _map_numbers(a, b) -> Dict[str, float]:
    keys_a, sig_a, pts_a, cnt_a = a
    keys_b, sig_b, pts_b, cnt_b = b
    k = pts_a.shape[0] // cnt_a.shape[0]
    same = (sig_a == sig_b) & (keys_a == keys_b).all(-1) & (sig_a >= 0)
    ca = torch.where(sig_a >= 0, cnt_a.clamp(0, k), 0).long()
    cb = torch.where(sig_b >= 0, cnt_b.clamp(0, k), 0).long()
    both = torch.where(same, torch.minimum(ca, cb), 0)
    held = int(ca.sum() + cb.sum())
    one_side = held - 2 * int(both.sum())
    rows = torch.arange(k)[None, :] < both[:, None]
    gap = (pts_a.view(-1, k, 3) - pts_b.view(-1, k, 3)).abs().amax(-1)
    gap = float(gap[rows].max()) if bool(rows.any()) else 0.0
    return {"map_rows": one_side / max(held, 1), "map_m": gap}


def _cell_keys(pos: torch.Tensor, cell: float) -> np.ndarray:
    """One int64 key per registry row: its cell of the colored map's dedup
    grid (coordinates truncated at `cell`, as `voxel_coords` does)."""
    c = torch.trunc(pos.double() / cell).long() + (1 << 20)
    return ((c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]).numpy()


def _color_numbers(a, b, cell: float) -> Dict[str, float]:
    """The registries hold at most one point per dedup cell; the order in
    which an insert hands out row ids is its own, so rows are matched by
    their cell.  A row whose cell the other side does not hold (a point
    inserted on one side only, or one that round-off moved across a cell
    face) counts as held by one side."""
    (reg_a, n_a), (reg_b, n_b) = a, b
    ra, rb = reg_a[:n_a], reg_b[:n_b]
    # registry columns (ops/color_map.py): position 6:9, valid 15
    ra, rb = ra[ra[:, 15] > 0.5], rb[rb[:, 15] > 0.5]
    ka, kb = _cell_keys(ra[:, 6:9], cell), _cell_keys(rb[:, 6:9], cell)
    _, ia, ib = np.intersect1d(ka, kb, assume_unique=False,
                               return_indices=True)
    held = ra.shape[0] + rb.shape[0]
    out = {"color_rows": (held - 2 * len(ia)) / max(held, 1),
           "color_m": 0.0}
    if len(ia):
        ia, ib = torch.as_tensor(ia), torch.as_tensor(ib)
        out["color_m"] = float((ra[ia, 6:9] - rb[ib, 6:9]).abs().max())
    return out


def _track_numbers(a, b, reg_a, reg_b, cell: float) -> Dict[str, float]:
    """A track is held by both sides where it is live in the same slot on
    the same map point.  A track names its point by a registry row id, and
    row ids are each side's own: an insert hands them out in order, so a
    row that one side holds and the other does not (`color_rows`) shifts
    every later id by one.  The point is named by its dedup cell, as
    `_color_numbers` matches rows."""
    (id_a, px_a, on_a), (id_b, px_b, on_b) = a, b

    def points(reg, ids):
        rows = ids.long().clamp(0, reg.shape[0] - 1)
        return torch.from_numpy(_cell_keys(reg[rows, 6:9], cell))

    live = on_a & on_b & (points(reg_a, id_a) == points(reg_b, id_b))
    gap = (px_a - px_b).abs().amax(-1)
    return {"track_px": float(gap[live].max()) if bool(live.any()) else 0.0}


def _quat_angle(qa: np.ndarray, qb: np.ndarray) -> float:
    """The rotation angle between two orientations, from the chord between
    the unit quaternions (exact for small angles, where acos is not)."""
    qa, qb = qa / np.linalg.norm(qa), qb / np.linalg.norm(qb)
    chord = min(np.linalg.norm(qa - qb), np.linalg.norm(qa + qb))
    return 4.0 * math.asin(min(chord / 2.0, 1.0))


def pose_numbers(judged: List[Optional[object]],
                 ref: List[Optional[object]]) -> Dict[str, float]:
    """`pose_m` and `rot_rad` of the judged side's records against the
    reference's, pose by pose.  Two poses of one sweep carry the same
    time: records out of step read as infinite."""
    if len(judged) != len(ref) or not judged:
        return {"pose_m": math.inf, "rot_rad": math.inf}
    pose = rot = 0.0
    for a, b in zip(judged, ref):
        if (a is None) != (b is None) or (a is not None
                                          and a.time != b.time):
            return {"pose_m": math.inf, "rot_rad": math.inf}
        if a is None:
            continue
        pose = max(pose, float(np.abs(np.asarray(a.position)
                                      - np.asarray(b.position)).max()))
        rot = max(rot, _quat_angle(np.asarray(a.quat_wxyz),
                                   np.asarray(b.quat_wxyz)))
    return {"pose_m": pose, "rot_rad": rot}


def compare(seg_a: tuple, seg_b: tuple, cell: float) -> Dict[str, float]:
    """The numbers of one segment: side a (judged) against b (reference),
    each (records, `view` at the end); `cell` is the colored map's dedup
    spacing."""
    (rec_a, view_a), (rec_b, view_b) = seg_a, seg_b
    out = pose_numbers(rec_a, rec_b)
    if "map" in view_a and "map" in view_b:
        out.update(_map_numbers(view_a["map"], view_b["map"]))
    if "color" in view_a and "color" in view_b:
        out.update(_color_numbers(view_a["color"], view_b["color"], cell))
    if "tracks" in view_a and "tracks" in view_b:
        out.update(_track_numbers(view_a["tracks"], view_b["tracks"],
                                  view_a["color"][0], view_b["color"][0],
                                  cell))
    return out


def run_reference(seg: Segment, device, configs: dict, tf32: bool = False):
    """The reference over a segment from its first copy: (records, view
    at the end).  The records are every pose of the segment's frames in
    order, a frame that yields none as one None, as the harness keeps the
    program's."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    pipe = snapshot.restore(seg.pre, device, configs)
    try:
        # the reference's constructors would set it off; set it after
        torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
        torch.backends.cudnn.allow_tf32 = bool(tf32)
        records = []
        for f in seg.frames:
            k = len(pipe.records)
            feed(pipe, f)
            records.extend(pipe.records[k:] or [None])
        return records, view(pipe)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def ate(records: List[Optional[object]], truth) -> float:
    """`ate_m` of the posed records; `truth(times)` gives the true
    positions."""
    posed = [r for r in records if r is not None]
    if len(posed) < 3:
        return math.inf
    times = np.array([r.time for r in posed], np.float64)
    est = np.stack([np.asarray(r.position, np.float64) for r in posed])
    return ate_rmse(est, truth(times))


def worst(per_segment: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for d in per_segment:
        for k, v in d.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """`correct`: every limited number present, finite and within its
    limit."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= lim for k, lim in limits.items())
