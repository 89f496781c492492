"""Streaming output layer: live pose, path and colored-map files (port of
`sr_livo_tpu/runtime/streaming.py`, same file formats).

The reference streams `/Odometry_after_opt` + `/path` per frame from the
odometry thread and chunked `/color_global_map_N` topics from a second
thread (publish_odometry/publish_path lioOptimization.cpp:1186-1241,
threadPubColorPoints :1243-1344, TF :1357-1384).  Here a background
publisher thread drains a queue the pipeline pushes to and writes growing
files while the run is in flight:

  out_dir/odometry_live.txt   one line per frame: t p(3) q(4) v(3)
  out_dir/path_live.txt       every path_stride-th pose, TUM format
  out_dir/color_chunks/chunk_%05d.pcd
                              colored-map chunks: registry rows new since
                              the previous tick (and rows that matured
                              since), filtered by pub_point_minimum_views

Tensors are queued as references and read back on the publisher thread,
so the odometry thread never blocks on a device-to-host read.  On CUDA
each queued frame carries an event recorded on the producer's stream
after the registry snapshot; the publisher waits on it before reading, so
its reads are ordered after the snapshot whatever stream it runs on, and
the queued references keep the allocations alive until then.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np
import torch

from sr_livo_tpu_torch.ops.color_map import C_NRGB, C_POS, C_RGB, C_VALID
from sr_livo_tpu_torch.runtime.pcd import save_color_rows


class StreamPublisher:
    """Background file publisher for a LivoPipeline.

    Usage:
        pub = StreamPublisher(out_dir)
        pipe = LivoPipeline(cfg, vision=vision, stream=pub, device=...)
        ... feed ...
        pub.close()
    """

    def __init__(self, out_dir: str, path_stride: int = 10,
                 map_every_n_frames: int = 10,
                 pub_point_minimum_views: int = 3,
                 pending_max_ticks: int = 200,
                 max_pending_rows: int = 1 << 20):
        self.out_dir = out_dir
        self.path_stride = int(path_stride)
        self.map_every_n_frames = int(map_every_n_frames)
        self.min_views = int(pub_point_minimum_views)
        # Bound the carried not-yet-publishable set: rows pending more than
        # `pending_max_ticks` map ticks are dropped (n_pending_dropped), and
        # the set is capped at `max_pending_rows` (oldest dropped first).
        self.pending_max_ticks = int(pending_max_ticks)
        self.max_pending_rows = int(max_pending_rows)
        self.n_pending_dropped = 0
        os.makedirs(out_dir, exist_ok=True)
        os.makedirs(os.path.join(out_dir, "color_chunks"), exist_ok=True)
        self._odo_path = os.path.join(out_dir, "odometry_live.txt")
        self._path_path = os.path.join(out_dir, "path_live.txt")
        # truncate any previous run's files
        open(self._odo_path, "w").close()
        open(self._path_path, "w").close()
        self._q: queue.Queue = queue.Queue(maxsize=256)
        self._frame_idx = 0
        self._chunk_idx = 0
        self._published_ids = 0      # registry rows already scanned
        # Rows scanned but not yet publishable (n_rgb below min_views at
        # the scan): re-checked against the next snapshot, as the
        # reference re-scans the registry every tick (:1305-1334).
        self._pending_rows = np.zeros((0,), np.int64)
        self._pending_tick = np.zeros((0,), np.int64)  # tick each row joined
        self._tick = 0
        self._n_lines = 0
        self.last_error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # ---- producer side (odometry thread; never blocks on D2H) ----------
    def publish_frame(self, time_s: float, rec_vec: torch.Tensor,
                      color_map=None):
        """Queue one frame: `rec_vec` is the pipeline's packed (19,)
        record.  Every `map_every_n_frames`-th frame also queues a copy of
        the registry and its count, taken on the device now (the pipeline
        updates the live registry in later frames)."""
        self._frame_idx += 1
        cmap = None
        if (color_map is not None
                and self._frame_idx % self.map_every_n_frames == 0):
            cmap = (color_map.reg.clone(), color_map.count.clone())
        ready = None
        if rec_vec.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(rec_vec.device))
        try:
            self._q.put_nowait(("frame", time_s, rec_vec, cmap, ready))
        except queue.Full:
            pass                      # drop frames rather than stall odometry

    def flush(self):
        """Block until everything queued so far is on disk."""
        self._q.join()

    def close(self):
        self.flush()
        self._q.put(("stop",))
        self._thread.join(timeout=30)

    # ---- consumer side (publisher thread) -------------------------------
    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item[0] == "stop":
                    return
                try:
                    self._handle(item)
                except Exception as e:   # never die: a dead consumer
                    self.last_error = e  # would deadlock flush()
            finally:
                self._q.task_done()

    def _handle(self, item):
        _, t, rec_vec, cmap, ready = item
        if ready is not None:
            ready.synchronize()
        row = rec_vec.double().cpu().numpy()
        p, q, v = row[0:3], row[3:7], row[7:10]
        with open(self._odo_path, "a") as f:
            f.write(f"{t:.9f} " + " ".join(f"{x:.9f}" for x in p)
                    + " " + " ".join(f"{x:.9f}" for x in q)
                    + " " + " ".join(f"{x:.9f}" for x in v) + "\n")
        self._n_lines += 1
        if (self._n_lines - 1) % self.path_stride == 0:
            with open(self._path_path, "a") as f:
                # TUM: t x y z qx qy qz qw
                f.write(f"{t:.9f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                        f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} "
                        f"{q[0]:.9f}\n")
        if cmap is not None:
            self._write_chunk(cmap)

    def _write_chunk(self, cmap):
        """One map tick on a (registry, count) snapshot (tensors on any
        device)."""
        reg, count = cmap
        count = int(count)
        lo = self._published_ids
        self._tick += 1
        # candidate rows: every previously unpublishable row plus new ones
        new = np.arange(lo, max(lo, count))
        idx = np.concatenate([self._pending_rows, new])
        tick0 = np.concatenate(
            [self._pending_tick, np.full(new.shape, self._tick, np.int64)])
        self._published_ids = max(lo, count)
        if idx.size == 0:
            return
        rows = reg[torch.as_tensor(idx, device=reg.device)].cpu().numpy()
        ok = (rows[:, C_VALID] > 0.5) & (rows[:, C_NRGB] >= self.min_views)
        # Invalid rows stay pending too (a claimed slot may be filled by a
        # later insert), up to pending_max_ticks / max_pending_rows.
        keep = ~ok & (self._tick - tick0 < self.pending_max_ticks)
        self.n_pending_dropped += int(np.sum(~ok) - np.sum(keep))
        self._pending_rows = idx[keep]
        self._pending_tick = tick0[keep]
        if self._pending_rows.size > self.max_pending_rows:
            cut = self._pending_rows.size - self.max_pending_rows
            self.n_pending_dropped += cut
            self._pending_rows = self._pending_rows[cut:]
            self._pending_tick = self._pending_tick[cut:]
        if not ok.any():
            return
        path = os.path.join(self.out_dir, "color_chunks",
                            f"chunk_{self._chunk_idx:05d}.pcd")
        self._chunk_idx += 1
        save_color_rows(rows[:, C_POS], rows[:, C_RGB], ok, path)


def read_live_trajectory(out_dir: str):
    """Parse odometry_live.txt -> (times, positions, quats, velocities)."""
    path = os.path.join(out_dir, "odometry_live.txt")
    rows = np.loadtxt(path, ndmin=2)
    if rows.size == 0:
        z = np.zeros((0,))
        return z, z.reshape(0, 3), z.reshape(0, 4), z.reshape(0, 3)
    return rows[:, 0], rows[:, 1:4], rows[:, 4:8], rows[:, 8:11]
