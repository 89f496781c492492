"""Vision module: the per-rendering-frame imaging pipeline (port of
`sr_livo_tpu/models/vision.py`).

imageProcessing::process (src/imageProcessing.cpp:89-164) with the track
management of opticalFlowTracker (src/opticalFlowTracker.cpp) and the
renderer of rgbMapTracker: image preprocess -> pyramidal LK ->
F-matrix RANSAC -> PnP RANSAC -> 11-dof reprojection ESIKF -> 6-dof
photometric ESIKF -> Bayesian map rendering -> track replenishment.
The track table is a fixed-capacity tensor (maximum_tracked_points = 300,
imageProcessing.cpp:14).
"""

from __future__ import annotations

import functools
import weakref
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torch.profiler import record_function

from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.models import camera as cam_mod
from sr_livo_tpu_torch.ops import color_map as cm
from sr_livo_tpu_torch.ops import image_ops, lk, ransac
from sr_livo_tpu_torch.runtime import native
from sr_livo_tpu_torch.utils import graphs
from sr_livo_tpu_torch.utils.device import resolve_device

# Hypotheses per frame of the two RANSAC gates (the JAX package's
# fundamental_ransac / pnp_ransac defaults).
F_HYPOTHESES = 128
PNP_HYPOTHESES = 64


class TrackState(NamedTuple):
    reg_id: torch.Tensor    # (M,) int32 registry id, -1 = free
    px: torch.Tensor        # (M, 2) pixel in last processed image
    active: torch.Tensor    # (M,) bool


def make_tracks(m: int, device="cpu") -> TrackState:
    return TrackState(
        reg_id=torch.full((m,), -1, dtype=torch.int32, device=device),
        px=torch.zeros((m, 2), dtype=torch.float32, device=device),
        active=torch.zeros((m,), dtype=torch.bool, device=device))


NoiseHook = Callable[[int, int, int], Tuple[np.ndarray, np.ndarray]]


class FrameState(NamedTuple):
    """The frame program's state (the buffers it updates in place; the
    arguments the JAX package's fused frame program donates)."""
    camera: cam_mod.CameraState
    color_map: cm.ColorMap
    tracks: TrackState
    prev_pyr: tuple                 # (pyramid, dx, dy) of the last frame


class FrameInputs(NamedTuple):
    """The frame program's per-frame inputs."""
    img_u8: torch.Tensor            # (rows, cols, 3) uint8
    q_wi: torch.Tensor              # (4,) IMU pose at the image instant
    t_wi: torch.Tensor              # (3,)
    dt: torch.Tensor                # () f32 seconds since the last frame
    obs_time: torch.Tensor          # () f32 image time
    n_new_visited: torch.Tensor     # () int32 from this sweep's insert
    noise_f: torch.Tensor           # (F_HYPOTHESES, M) Gumbel draws
    noise_pnp: torch.Tensor         # (PNP_HYPOTHESES, M)


class InsertInputs(NamedTuple):
    """The colored-map insert program's per-sweep inputs."""
    pts_world: torch.Tensor         # (F, 3) registered world points
    frame_valid: torch.Tensor       # (F,) bool
    success: torch.Tensor           # () bool
    obs_time: torch.Tensor          # () f32


class VisionModule:
    """Owns the camera state, the colored map, the tracks and the previous
    frame's pyramid, on one device (default "cuda").

    RANSAC hypotheses are drawn from a `torch.Generator` seeded with 7 (the
    JAX package's PRNGKey(7)).  `noise_hook(n_hyp_f, n_hyp_pnp, m)`, when
    given, returns the Gumbel noise of a frame's F and PnP gates instead
    ((n_hyp, m) arrays); the parity tests feed the JAX package's key-chain
    draws through it.

    After the first rendered frame, a frame's preprocess, pyramid and
    vision step run as one program (`utils.graphs.Program` over
    `_fused_frame_core`): one CUDA graph replay on the card, keyed by
    whether the host remap ran, as the JAX package keys its fused jit.
    The program's state buffers are the module's camera, colored map,
    tracks and previous pyramid, which it updates IN PLACE.  Every sweep's
    colored-map insert is a program of its own over the same colored map
    (`_gated_insert`).  A tensor that eager code replaces (a checkpoint
    load) is copied into its buffer before the next call.
    """

    def __init__(self, cfg: LivoConfig, device="cuda",
                 noise_hook: Optional[NoiseHook] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # Same float32 policy as LioEngine: CLAHE's blend, the color
        # transforms and the camera filters' products stay in full float32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        co = cfg.camera_options
        scale = co.image_scale
        self.cols = int(co.image_width * scale)
        self.rows = int(co.image_height * scale)
        intr_mat = np.asarray(co.camera_intrinsic, np.float64).reshape(3, 3)
        self.intr0 = np.array([intr_mat[0, 0] * scale, intr_mat[1, 1] * scale,
                               intr_mat[0, 2] * scale, intr_mat[1, 2] * scale])
        dist = np.asarray(co.camera_dist_coeffs, np.float64)
        k = np.array([[self.intr0[0], 0, self.intr0[2]],
                      [0, self.intr0[1], self.intr0[3]], [0, 0, 1]])
        self.orig_rows, self.orig_cols = int(co.image_height), int(co.image_width)
        if np.any(np.abs(dist) > 1e-12):
            ud = image_ops.make_undistort_map(k, dist, (self.rows, self.cols))
            # device map for images already at the processed size
            self.ud_map = torch.as_tensor(ud, device=self.device)
            # Composed resize+undistort map in ORIGINAL-image pixels for
            # the host remap path (OpenCV pixel-center convention).
            self.host_map = np.empty_like(ud)
            self.host_map[..., 0] = ((ud[..., 0] + 0.5)
                                     * (self.orig_cols / self.cols) - 0.5)
            self.host_map[..., 1] = ((ud[..., 1] + 0.5)
                                     * (self.orig_rows / self.rows) - 0.5)
        else:
            self.ud_map = None
            self.host_map = None
        self.n_tiles = min(image_ops.clahe_tiles_for_width(self.cols), 32)

        self.camera = cam_mod.init_camera_state(
            cfg.extrinsics.R_imu_camera(), cfg.extrinsics.t_imu_camera(),
            self.intr0, device=self.device)
        sh = cfg.shapes
        self.color_map = cm.make_color_map(
            sh.color_registry, sh.color_capacity, sh.color_voxel_points,
            recent=sh.max_render_voxels, device=self.device)
        self.tracks = make_tracks(co.max_tracked_points, self.device)
        # The reference's 40 px spacing assumes ~1280 px images
        # (track_windows_size / image_scale_factor, imageProcessing.cpp:131);
        # scale it with the actual processed width.
        self.track_grid = max(
            int(round(co.track_windows_size * self.cols / 1280.0)), 4)
        self.lk_params = lk.LkParams(window=sh.lk_window,
                                     levels=sh.lk_pyramid_levels - 1,
                                     iters=sh.lk_iterations)
        self.prev_pyr = None
        self.prev_time = None
        self.first_data = True
        self.n_new_visited = torch.ones((), dtype=torch.int32,
                                        device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(7)
        self.noise_hook = noise_hook
        self.programs: dict = {}         # remapped -> the frame program
        self.insert_programs: dict = {}  # point count -> the insert program
        # (t, n_tracked, n_inlier) per rendering frame; the per-frame counts
        # stay one device vector each until first read (one batched copy).
        self._stats: list = []
        self._stats_full: list = []      # (t, *per-stage counts) rows
        self._stats_pending: list = []

    def _scalar(self, value: float) -> torch.Tensor:
        """A float32 0-d tensor on the device, made by a fill (an upload
        from the host would synchronize the stream)."""
        return torch.full((), value, dtype=torch.float32, device=self.device)

    # -- called by the pipeline on every sweep (addPointsToMap color leg) --
    def insert_sweep_points(self, pts_world: torch.Tensor,
                            frame_valid: torch.Tensor, success: torch.Tensor,
                            obs_time: float):
        """The success gate, the add_point_step stride and the insert."""
        self._gated_insert(pts_world, frame_valid, success, obs_time)

    def _gated_insert(self, pts_world, frame_valid, success, obs_time: float):
        """The colored-map insert as one program (`insert_fn`), the
        counterpart of the JAX package's jitted `color_insert` with the map
        donated: its state is the module's colored map, updated IN PLACE,
        its inputs the sweep's points, mask, success flag and time.  Sets
        `n_new_visited`, the program's output (the next insert overwrites
        it; the frame program copies it in before then)."""
        inputs = InsertInputs(pts_world, frame_valid, success,
                              self._scalar(obs_time))
        self.color_map, self.n_new_visited = graphs.call(
            self.insert_programs, tuple(pts_world.shape), self.insert_fn(),
            self.color_map, inputs, name="color_insert")

    def insert_fn(self):
        """The colored-map insert program's function: fn(ColorMap,
        InsertInputs) -> (ColorMap, n_new_visited)."""
        mo, sh = self.cfg.map_options, self.cfg.shapes
        kw = dict(step=mo.add_point_step, voxel_size=mo.size_voxel_map,
                  min_distance=mo.min_distance_points,
                  max_probe=sh.map_max_probe, budget=sh.max_insert_points)

        def fn(cmap, inputs: InsertInputs):
            return gated_color_insert(cmap, *inputs, **kw)
        return fn

    # -- preprocessing --------------------------------------------------
    def _preprocess_dev(self, img_u8: torch.Tensor, remapped: bool):
        """uint8 image at the processed size on the device -> (rgb f32
        0..255 equalized, gray CLAHE); undistorts on the device unless the
        host remap already ran."""
        img = img_u8.to(torch.float32)
        if self.ud_map is not None and not remapped:
            img = image_ops.remap(img, self.ud_map)
        gray = image_ops.rgb_to_gray(img)
        gray = image_ops.clahe(gray, 3.0, self.n_tiles)
        rgb = image_ops.equalize_color_ycrcb(img, self.n_tiles)
        return rgb, gray

    def _upload(self, host_img):
        img_u8, remapped = host_img
        return torch.as_tensor(img_u8, device=self.device), remapped

    def preprocess(self, image: np.ndarray
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """uint8/float image -> (rgb f32 0..255 equalized, gray CLAHE).

        The host handles dtype, scale and resize (and the undistort remap
        of a full-resolution frame); the image crosses to the device as
        uint8."""
        return self._preprocess_dev(*self._upload(self._host_prepare(image)))

    def preprocess_with_pyramid(self, image: np.ndarray, host_img=None):
        """preprocess + LK pyramid/Scharr precompute: (rgb, gray,
        (pyr, dx, dy)).  `host_img` = (img_u8, remapped) when
        _host_prepare already ran on the pipeline's feeder thread."""
        img_u8, remapped = self._upload(
            host_img if host_img is not None else self._host_prepare(image))
        rgb, gray = self._preprocess_dev(img_u8, remapped)
        return rgb, gray, lk.precompute_frame(gray, self.lk_params.levels)

    def _host_prepare(self, image: np.ndarray):
        """Host-side dtype/scale/resize (+ undistort remap when a
        distortion model is set and the frame is full size); returns
        (uint8 image at processed size, whether the host remap ran)."""
        img_in = np.asarray(image)
        if img_in.ndim == 2:
            img_in = np.repeat(img_in[..., None], 3, axis=-1)
        if img_in.dtype != np.uint8:
            img = img_in.astype(np.float32)
            mx = img.max(initial=0.0)
            if mx <= 1.5:
                img = img * 255.0
            elif mx > 255.0:
                # >8-bit sources: normalize by the dtype max (integer
                # inputs) or the observed max (float) instead of saturating.
                if np.issubdtype(img_in.dtype, np.integer):
                    full = float(np.iinfo(img_in.dtype).max)
                else:
                    full = mx
                img = img * (255.0 / full)
            img_in = np.clip(np.round(img), 0, 255).astype(np.uint8)
        if (self.host_map is not None
                and img_in.shape[:2] == (self.orig_rows, self.orig_cols)):
            return native.remap_u8(img_in, self.host_map), True
        if img_in.shape[:2] != (self.rows, self.cols):
            ys = np.clip(np.round(np.linspace(0, img_in.shape[0] - 1,
                                              self.rows))
                         .astype(int), 0, img_in.shape[0] - 1)
            xs = np.clip(np.round(np.linspace(0, img_in.shape[1] - 1,
                                              self.cols))
                         .astype(int), 0, img_in.shape[1] - 1)
            img_in = img_in[np.ix_(ys, xs)]
        return img_in, False

    def _noise(self) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self.tracks.reg_id.shape[0]
        if self.noise_hook is not None:
            nf, npnp = self.noise_hook(F_HYPOTHESES, PNP_HYPOTHESES, m)
            return (torch.tensor(nf, device=self.device),
                    torch.tensor(npnp, device=self.device))
        return (ransac.gumbel_noise(self.generator, F_HYPOTHESES, m,
                                    self.device),
                ransac.gumbel_noise(self.generator, PNP_HYPOTHESES, m,
                                    self.device))

    # -- main per-rendering-frame entry ----------------------------------
    def process_frame(self, pipeline, meas, sweep_out, host_img=None):
        """One rendered frame: the colored-map insert of this sweep, the
        image preprocess and pyramid, and the vision step.  The first
        rendered frame only seeds the tracks."""
        state = sweep_out.state
        q_wi, t_wi = state.q, state.p
        obs_time = meas.time_image
        timers = pipeline.timers
        if host_img is None:
            host_img = self._host_prepare(meas.image)

        if self.first_data:
            self.insert_sweep_points(
                sweep_out.frame_pts_world, sweep_out.frame_valid,
                sweep_out.summary.success, obs_time)
            _rgb, _gray, cur_pyr = self.preprocess_with_pyramid(
                None, host_img=host_img)
            self._init_tracks(q_wi, t_wi)
            self.prev_pyr = cur_pyr
            self.prev_time = obs_time
            self.first_data = False
            return

        dt = obs_time - self.prev_time
        # vis_step = vis_insert + vis_track (each stage waits for its
        # device work when the timers synchronize)
        with timers.stage("vis_step"):
            with timers.stage("vis_insert"):
                self._gated_insert(sweep_out.frame_pts_world,
                                   sweep_out.frame_valid,
                                   sweep_out.summary.success, obs_time)
                timers.synchronize()
            with timers.stage("vis_track"):
                # preprocess + pyramid + vision step: one program
                stats_vec = self._run_frame_program(
                    host_img, q_wi, t_wi, dt, obs_time)
                timers.synchronize()
        # a copy: the program's output is overwritten by its next call
        self._stats_pending.append((float(obs_time), stats_vec.clone()))
        self.prev_time = obs_time

    def _run_frame_program(self, host_img, q_wi, t_wi, dt: float,
                           obs_time: float) -> torch.Tensor:
        """The frame program over this frame's inputs; returns its stats
        output.  The inputs are copied (or, for the two times, filled)
        into the program's buffers, the RANSAC noise drawn outside it, so
        that the generator's stream is the eager one's and no host value
        is baked into the graph."""
        img_u8, remapped = self._upload(host_img)
        noise_f, noise_pnp = self._noise()
        state = FrameState(self.camera, self.color_map, self.tracks,
                           self.prev_pyr)
        prog = self.programs.get(remapped)
        if prog is None:
            inputs = FrameInputs(
                img_u8, q_wi, t_wi, self._scalar(dt), self._scalar(obs_time),
                self.n_new_visited, noise_f, noise_pnp)
            # the state is adopted (the module owns it); the inputs are
            # the program's own copies, since refills write into them.  The
            # function holds the module weakly: the module owns its
            # programs, and without a reference cycle their graphs' memory
            # goes as soon as the module does.
            prog = self.programs[remapped] = graphs.Program(
                functools.partial(VisionModule._fused_frame_core,
                                  weakref.proxy(self), remapped=remapped),
                state, graphs.tree_map(torch.clone, inputs),
                name=f"vision_frame[remapped={remapped}]")
        else:
            graphs.refill(prog.state, state)
            inp = prog.inputs
            inp.dt.fill_(dt)
            inp.obs_time.fill_(obs_time)
            graphs.refill(inp, FrameInputs(
                img_u8, q_wi, t_wi, inp.dt, inp.obs_time,
                self.n_new_visited, noise_f, noise_pnp))
        stats_vec = prog()
        self.camera, self.color_map, self.tracks, self.prev_pyr = prog.state
        return stats_vec

    def _fused_frame_core(self, state: FrameState, inputs: FrameInputs, *,
                          remapped: bool):
        """The frame program's function: the counterpart of the JAX
        package's `VisionModule._fused_frame_core`
        (sr_livo_tpu/models/vision.py:288-314).  Preprocess (the JAX
        package's `_preprocess_from_u8` when the host remap ran, else
        with the device undistort), the LK pyramid of the frame and the
        vision step (`_vision_step_core`).  The colored-map insert that
        opens the JAX program is a program of its own here
        (`_gated_insert`); its `n_new_visited` comes in `inputs`.  Returns
        (FrameState, stats (8,) int64); reads nothing back to the host."""
        rgb, gray = self._preprocess_dev(inputs.img_u8, remapped)
        cur_pyr = lk.precompute_frame(gray, self.lk_params.levels)
        camera, color_map, tracks, stats = vision_step(
            state.camera, state.color_map, state.tracks, state.prev_pyr,
            cur_pyr, rgb, inputs.q_wi, inputs.t_wi, inputs.dt,
            inputs.obs_time, inputs.n_new_visited, inputs.noise_f,
            inputs.noise_pnp, lk_params=self.lk_params, cols=self.cols,
            rows=self.rows, track_grid=self.track_grid,
            max_render_points=self.cfg.shapes.max_render_points,
            fm_px=self.cfg.camera_options.fm_ransac_px,
            pnp_px=self.cfg.camera_options.pnp_ransac_px)
        return FrameState(camera, color_map, tracks, cur_pyr), stats

    @property
    def stats(self):
        if self._stats_pending:
            arr = torch.stack([d for (_, d) in self._stats_pending]
                              ).cpu().numpy()
            self._stats.extend(
                (t, int(a[0]), int(a[1]))
                for (t, _), a in zip(self._stats_pending, arr))
            self._stats_full.extend(
                (t,) + tuple(int(v) for v in a)
                for (t, _), a in zip(self._stats_pending, arr))
            self._stats_pending = []
        return self._stats

    def _init_tracks(self, q_wi, t_wi):
        """First-frame track seeding (imageProcessing.cpp:127-135)."""
        _, t_wc, q_cw, t_cw = cam_mod.world_camera_pose(
            self.camera, q_wi, t_wi)
        m = self.tracks.reg_id.shape[0]
        ids, uv, ok = cm.select_points_for_projection(
            self.color_map, q_cw, t_cw, t_wc, self.camera.intr,
            max_out=m, cols=self.cols, rows=self.rows,
            grid_px=self.track_grid)
        self.tracks = TrackState(
            reg_id=torch.where(ok, ids, torch.full_like(ids, -1)),
            px=torch.where(ok[:, None], uv, torch.zeros_like(uv)),
            active=ok)


def gated_color_insert(cmap, pts_world, frame_valid, success, obs_time, *,
                       step, voxel_size, min_distance, max_probe, budget):
    """success gate + add_point_step stride + color_insert."""
    valid = frame_valid & success
    if step > 1:
        pts_world = pts_world[::step]
        valid = valid[::step]
    return cm.color_insert(cmap, pts_world, valid, obs_time,
                           voxel_size=voxel_size, min_distance=min_distance,
                           max_probe=max_probe, budget=budget)


def _grid_cell(px: torch.Tensor, grid: int, ncx: int, ncy: int
               ) -> torch.Tensor:
    """Flat occupancy-grid cell of pixels (rounded to the nearest cell)."""
    cy = torch.clamp(torch.round(px[:, 1] / grid), 0, ncy - 1)
    cx = torch.clamp(torch.round(px[:, 0] / grid), 0, ncx - 1)
    return cy.to(torch.int64) * ncx + cx.to(torch.int64)


def vision_step(camera, color_map, tracks, prev_pyr, cur_pyr, rgb_img,
                q_wi, t_wi, dt, obs_time, n_new_visited, noise_f, noise_pnp,
                *, lk_params, cols, rows, track_grid, max_render_points,
                fm_px, pnp_px):
    """The vision frame (the JAX package's `_vision_step_core`): LK,
    the RANSAC gates, both camera ESIKFs, rendering and track upkeep.
    `dt`, `obs_time` are 0-d float tensors; `noise_f` (128, M) and
    `noise_pnp` (64, M) are the gates' Gumbel draws.  Returns
    (camera, color_map, tracks, stats (8,) int64)."""
    registry = color_map.reg.shape[0]
    prev_imgs, prev_dx, prev_dy = prev_pyr
    cur_imgs, _, _ = cur_pyr

    # ---- 1. LK tracking (trackImage, opticalFlowTracker.cpp:111-186) ----
    n_active = torch.sum(tracks.active)
    track_ok_gate = n_active >= 30
    ids_c = torch.clamp(tracks.reg_id.to(torch.int64), 0, registry - 1)
    # one packed-row gather (a copy) serves the whole step
    reg_rows = color_map.reg[ids_c]                         # (M, 16)
    # Geometric LK seed: every track is a map point with a known world
    # position, and the LIO state at the image instant is solved before
    # vision runs (sweep reconstruction), so the point's projection
    # predicts its pixel; falls back to the stored per-track image
    # velocity, then to a zero seed.
    _, _, q_cw0, t_cw0 = cam_mod.world_camera_pose(camera, q_wi, t_wi)
    pts_world = reg_rows[:, cm.C_POS]
    proj0, z_ok0, _ = cm.project_points(pts_world, q_cw0, t_cw0, camera.intr)
    seed_geo = proj0 - tracks.px
    geo_ok = z_ok0 & cm.in_fov(proj0, cols, rows, 0.02)
    seed_vel = reg_rows[:, cm.C_VEL] * dt
    vel_ok = ((torch.abs(seed_vel[:, 0]) < cols / 8.0)
              & (torch.abs(seed_vel[:, 1]) < rows / 8.0))
    seed = torch.where(geo_ok[:, None], seed_geo,
                       torch.where(vel_ok[:, None], seed_vel,
                                   torch.zeros_like(seed_vel)))
    with record_function("vision.lk"):
        cur_px, status = lk.track_pyramidal(
            prev_imgs, cur_imgs, prev_dx, prev_dy, tracks.px, tracks.active,
            lk_params, init_flow=seed)
    status = status & tracks.active & track_ok_gate
    lk_ok = status

    # ---- 2. fundamental RANSAC gate (:144) ----
    with record_function("vision.f_ransac"):
        f_inl = ransac.fundamental_ransac(tracks.px, cur_px, status,
                                          noise_f, threshold=fm_px)
    status = status & f_inl
    fr_ok = status

    # ---- 3. FoV gate + image velocity (:155-171) ----
    status = status & cm.in_fov(cur_px, cols, rows, 0.05)
    fov_ok = status
    vel = (cur_px - tracks.px) / torch.clamp(dt, min=1e-5)
    vel = torch.where(dt < 1e-5, torch.full_like(vel, 1e-3), vel)
    reg_rows[:, cm.C_VEL] = torch.where(status[:, None], vel,
                                        reg_rows[:, cm.C_VEL])
    color_map = color_map._replace(reg=cm._set_drop(
        color_map.reg, torch.where(status, ids_c, registry), reg_rows))

    # ---- 4. PnP RANSAC outlier gate (removeOutlierUsingRansacPnp) ----
    with record_function("vision.pnp_ransac"):
        pnp_inl, _q, _t = ransac.pnp_ransac(
            pts_world, cur_px, status, q_cw0, t_cw0, camera.intr, noise_pnp,
            threshold=pnp_px)
    status = status & pnp_inl
    enough = torch.sum(status) >= cam_mod.MIN_ITERATION_POINTS

    # ---- 5. 11-dof reprojection ESIKF ----
    img_vel_pts = reg_rows[:, cm.C_VEL]
    with record_function("vision.vio_esikf"):
        camera, _ok1 = cam_mod.vio_esikf(
            camera, q_wi, t_wi, pts_world, cur_px, img_vel_pts,
            status & enough, n_new_visited)

    # ---- 6. 6-dof photometric ESIKF ----
    with record_function("vision.vio_photometric"):
        camera, _ok2 = cam_mod.vio_photometric(
            camera, q_wi, t_wi, rgb_img, pts_world,
            reg_rows[:, cm.C_RGB], reg_rows[:, cm.C_COV],
            reg_rows[:, cm.C_NRGB], img_vel_pts, status & enough,
            n_new_visited)

    # ---- 7. render recent voxels with the refined pose ----
    _, t_wc, q_cw, t_cw = cam_mod.world_camera_pose(camera, q_wi, t_wi)
    with record_function("vision.render"):
        color_map = cm.render_recent(
            color_map, rgb_img, q_cw, t_cw, t_wc, camera.intr, obs_time,
            cols=cols, rows=rows, max_render_points=max_render_points)

    # ---- 8. track maintenance (updateAndAppendTrackPoints, :13-102) ----
    with record_function("vision.tracks"):
        color_map, tracks_new, keep, use_cand = _maintain_tracks(
            color_map, tracks, camera, status, reg_rows, ids_c, pts_world,
            cur_px, q_cw, t_cw, t_wc, cols=cols, rows=rows,
            track_grid=track_grid)

    # per-frame stats: [0] LK+gates survivors, [1] kept tracks; [2:]
    # per-stage survivor counts (active-in, post-LK, post-F-RANSAC,
    # post-FoV, post-PnP, appended).
    stats = torch.stack([torch.sum(status), torch.sum(keep), n_active,
                         torch.sum(lk_ok), torch.sum(fr_ok),
                         torch.sum(fov_ok), torch.sum(status),
                         torch.sum(use_cand)])
    return camera, color_map, tracks_new, stats


def _maintain_tracks(color_map, tracks, camera, status, reg_rows, ids_c,
                     pts_world, cur_px, q_cw, t_cw, t_wc, *, cols, rows,
                     track_grid):
    """Step 8 of the vision frame (updateAndAppendTrackPoints,
    opticalFlowTracker.cpp:13-102): outlier counts of the tracked map
    points, dropping bad tracks, and refilling free slots with map points
    of the recent voxels on an occupancy grid.  Returns (color_map,
    tracks, keep, use_cand)."""
    m = tracks.reg_id.shape[0]
    dev = tracks.px.device
    registry = color_map.reg.shape[0]
    proj_uv, _z_ok, _pc = cm.project_points(pts_world, q_cw, t_cw,
                                            camera.intr)
    reproj_err = torch.linalg.norm(proj_uv - cur_px, dim=-1)
    max_err = 2.0 * cols / 320.0
    oc = reg_rows[:, cm.C_OUT]                # unchanged by steps 3-7
    bad = status & (reproj_err > max_err)
    drop = bad & ((oc > 0) | (reproj_err > 2 * max_err))
    oc_new = torch.where(bad & ~drop, oc + 1,
                         torch.where(status, torch.zeros_like(oc), oc))
    # re-gather post-render rows so the outlier-column write does not
    # clobber the renderer's rgb/cov updates for tracked ids
    rows_post = color_map.reg[ids_c]
    rows_post[:, cm.C_OUT] = oc_new
    color_map = color_map._replace(reg=cm._set_drop(
        color_map.reg, torch.where(tracks.active, ids_c, registry),
        rows_post))
    keep = status & ~drop

    # occupancy grid of surviving tracks
    ncx, ncy = cols // track_grid + 2, rows // track_grid + 2
    cell = _grid_cell(cur_px, track_grid, ncx, ncy)
    # index_fill_ takes its value as a kernel argument (a setitem of a
    # Python bool would upload it, which a graph capture refuses)
    occ = torch.zeros((ncx * ncy + 1,), dtype=torch.bool,
                      device=dev).index_fill_(
        0, torch.where(keep, cell, ncx * ncy), True)

    # candidates from the map (selectPointsForProjection via refresh)
    cand_ids, cand_uv, cand_ok = cm.select_points_for_projection(
        color_map, q_cw, t_cw, t_wc, camera.intr,
        max_out=m, cols=cols, rows=rows, grid_px=track_grid)
    # exclude already-tracked ids and occupied cells
    tracked_ids = torch.where(keep, tracks.reg_id,
                              torch.full_like(tracks.reg_id, -2))
    already = torch.any(cand_ids[:, None] == tracked_ids[None, :], dim=1)
    c_cell = _grid_cell(cand_uv, track_grid, ncx, ncy)
    cand_ok = cand_ok & ~already & ~occ[c_cell]
    # within-batch cell dedup (keep lowest-index candidate per cell)
    idx_m = torch.arange(m, dtype=torch.int64, device=dev)
    cell_min = torch.full((ncx * ncy + 1,), m, dtype=torch.int64,
                          device=dev).scatter_reduce_(
        0, torch.where(cand_ok, c_cell, ncx * ncy), idx_m, "amin")
    cand_ok = cand_ok & (cell_min[c_cell] == idx_m)

    # fill free slots with candidates, in index order
    free_rank = torch.cumsum((~keep).to(torch.int64), 0) - 1
    cand_order = torch.argsort((~cand_ok).to(torch.uint8), stable=True)
    n_cand = torch.sum(cand_ok)
    take = torch.clamp(free_rank, 0, m - 1)
    use_cand = (~keep) & (free_rank < n_cand)
    new_ids = torch.where(use_cand, cand_ids[cand_order][take],
                          torch.full_like(cand_ids, -1))
    new_px = torch.where(use_cand[:, None], cand_uv[cand_order][take],
                         torch.zeros_like(cand_uv))

    tracks_new = TrackState(
        reg_id=torch.where(keep, tracks.reg_id, new_ids),
        px=torch.where(keep[:, None], cur_px, new_px),
        active=keep | use_cand)
    return color_map, tracks_new, keep, use_cand
