"""Print the port's parity table: each ported function against its JAX
counterpart on the inputs of the `test_torch_*` files, with the largest
absolute difference and whether the outputs are bit-exact.

    JAX_PLATFORMS=cpu python -m tests.torch_parity_report [section ...]

Runs on the CPU (the port's plain path) in about eight minutes; the tests
hold the bounds, this script reports the measured values for PERF.md.
Sections (all by default): lie, eskf, frame, voxel_map, host, plane,
knn_plane, lio, odometry, pipeline, image, ransac, color_map, camera,
vision, long_run, backend_programs (the long-run path's captured
programs against their eager functions and JAX), ingest, retry, sharded
(the multi-device slice: 4 gloo
ranks against JAX's 4-device mesh, about a minute), gate (the accuracy
gate's bags and configurations against scripts/accuracy_gate.py and an
8 s ntu-profile bag through both packages, about a minute), scaling (the
scaling bench and the live viewer against scripts/scaling_bench.py and
scripts/live_viewer.py, the per-rank proxies in lockstep, about a
minute).
"""
import tests.conftest  # noqa: F401  (JAX on the CPU before anything runs)

import jax.numpy as jnp
import numpy as np
import torch

from sr_livo_tpu_torch import convert

from tests import test_torch_accuracy_gate as AG
from tests import test_torch_ba as BA
from tests import test_torch_backend as BE
from tests import test_torch_backend_programs as BP
from tests import test_torch_camera as C
from tests import test_torch_checkpoint as CK
from tests import test_torch_color_map as CM
from tests import test_torch_drivers as DR
from tests import test_torch_eskf as E
from tests import test_torch_eviction as EV
from tests import test_torch_frame as F
from tests import test_torch_knn_plane as K
from tests import test_torch_live_viewer as LV
from tests import test_torch_lie as L
from tests import test_torch_lio as I
from tests import test_torch_loop_closure as LC
from tests import test_torch_measurements as M
from tests import test_torch_native as N
from tests import test_torch_odometry as O
from tests import test_torch_pipeline as P
from tests import test_torch_plane_fit as PF
from tests import test_torch_pose_graph as PG
from tests import test_torch_ransac as R
from tests import test_torch_replay as RP
from tests import test_torch_replay_r3live as RR
from tests import test_torch_routing as RT
from tests import test_torch_scaling_bench as SC
from tests import test_torch_sharded_ba as SB
from tests import test_torch_sharded_lio as SL
from tests import test_torch_streaming as ST
from tests import test_torch_vision as VI
from tests import test_torch_voxel_map as V

ROWS = []
REPLAY_S = 20.0     # the length of chip_smoke.py's phase `replay`


def row(name, pairs):
    """pairs: (port array, JAX array) tuples of one function's outputs."""
    err, exact = 0.0, True
    for t, j in pairs:
        t, j = np.asarray(t), np.asarray(j)
        exact &= t.shape == j.shape and np.array_equal(t, j)
        if t.size:
            err = max(err, float(np.max(np.abs(t.astype(np.float64)
                                               - j.astype(np.float64)))))
    ROWS.append((name, err, exact))


def state_pairs(ts, js):
    get = js.__getitem__ if isinstance(js, dict) else js.__getattribute__
    return [(getattr(ts, k).numpy(), get(k)) for k in ts._fields]


def lie_rows():
    for name in sorted(L.CASES):
        j, t = L._both(name, *L.CASES[name]())
        row(f"lie.{name}", [(t, j)])


def eskf_rows():
    from sr_livo_tpu.models import eskf as jeskf
    from sr_livo_tpu_torch.models import eskf as teskf
    js, ts = E._start_state()
    for _ in range(50):
        acc = (np.array([0, 0, 9.81]) + E.RNG.randn(3) * 0.3).astype(
            np.float32)
        gyr = (E.RNG.randn(3) * 0.2).astype(np.float32)
        js = jeskf.predict(js, jnp.asarray(E.NOISE), 0.005, acc, gyr)
        ts = teskf.predict(ts, torch.as_tensor(E.NOISE), 0.005, acc, gyr)
    row("eskf.predict (50 steps)", state_pairs(ts, js))

    js, ts = E._start_state()
    S = 64
    dts = np.full(S, 0.005, np.float32)
    accs = (np.array([0, 0, 9.81]) + E.RNG.randn(S, 3) * 0.5).astype(
        np.float32)
    gyrs = (E.RNG.randn(S, 3) * 0.3).astype(np.float32)
    sweep = (np.cumsum(dts).astype(np.float32), dts, accs, gyrs,
             np.arange(S) < 41)
    t_final, _ = teskf.predict_sweep(ts, torch.as_tensor(E.NOISE),
                                     *(torch.as_tensor(a) for a in sweep))
    j_args = (js, jnp.asarray(E.NOISE)) + tuple(jnp.asarray(a) for a in sweep)
    row("eskf.predict_sweep vs predict_sweep",
        state_pairs(t_final, jeskf.predict_sweep(*j_args)[0]))
    row("eskf.predict_sweep vs predict_sweep_sequential",
        state_pairs(t_final, jeskf.predict_sweep_sequential(*j_args)[0]))

    js, ts = E._start_state()
    d_x = (E.RNG.randn(17) * 0.05).astype(np.float32)
    row("eskf.observe", state_pairs(teskf.observe(ts, torch.as_tensor(d_x)),
                                    jeskf.observe(js, jnp.asarray(d_x))))


def frame_rows():
    from sr_livo_tpu.ops import frame as jframe
    from sr_livo_tpu_torch.ops import frame as tframe
    pts = F._far_cloud()
    row("frame._voxel_key (int32-overflowing)",
        [(tframe._voxel_key(torch.as_tensor(pts), 0.2).numpy(),
          jframe._voxel_key(jnp.asarray(pts), 0.2))])
    h = F.RNG.randint(0, 300, 4000).astype(np.int32)
    pri = F.RNG.permutation(4000).astype(np.int32)
    valid = F.RNG.rand(4000) < 0.8
    row("frame.bucket_dedup_min",
        [(tframe.bucket_dedup_min(*(torch.as_tensor(a)
                                    for a in (h, pri, valid))).numpy(),
          jframe.bucket_dedup_min(*(jnp.asarray(a) for a in (h, pri, valid))))])
    row("frame.subsample_perm", [(tframe.subsample_perm(16384),
                                  jframe.subsample_perm(16384))])
    for cloud, prio in (("near", True), ("far", False)):
        pts = F._cloud() if cloud == "near" else F._far_cloud()
        valid = F.RNG.rand(pts.shape[0]) < 0.9
        p = tframe.subsample_perm(pts.shape[0]) if prio else None
        jp, jv, _ = jframe.voxel_subsample(jnp.asarray(pts),
                                           jnp.asarray(valid), 0.5, 300,
                                           priority=p)
        tp, tv, _ = tframe.voxel_subsample(
            torch.as_tensor(pts), torch.as_tensor(valid), 0.5, 300,
            priority=None if p is None else torch.as_tensor(p))
        row(f"frame.voxel_subsample ({cloud}, priority={prio})",
            [(tp.numpy(), jp), (tv.numpy(), jv)])
    j_states, t_states = F._imu_states()
    r_il, t_il = F._extrinsics()
    raw = F._cloud(2000, spread=8.0)
    t_rel = F.RNG.uniform(0.0, 0.1, 2000).astype(np.float32)
    for fn in ("undistort_imu", "undistort_constant"):
        jw = getattr(jframe, fn)(jnp.asarray(raw), jnp.asarray(t_rel),
                                 j_states, jnp.asarray(r_il),
                                 jnp.asarray(t_il))
        tw = getattr(tframe, fn)(torch.as_tensor(raw), torch.as_tensor(t_rel),
                                 t_states, torch.as_tensor(r_il),
                                 torch.as_tensor(t_il))
        row(f"frame.{fn}", [(tw.numpy(), jw)])
    je = jframe.to_end_frame(jw, j_states, jnp.asarray(r_il),
                             jnp.asarray(t_il))
    te = tframe.to_end_frame(tw, t_states, torch.as_tensor(r_il),
                             torch.as_tensor(t_il))
    row("frame.to_end_frame", [(te.numpy(), je)])
    q = np.array([0.9, 0.1, -0.2, 0.3], np.float32)
    q /= np.linalg.norm(q)
    p = np.array([1.0, -2.0, 0.5], np.float32)
    row("frame.transform_to_world",
        [(tframe.transform_to_world(*(torch.as_tensor(a) for a in
                                      (raw, q, p, r_il, t_il))).numpy(),
          jframe.transform_to_world(*(jnp.asarray(a) for a in
                                      (raw, q, p, r_il, t_il))))])


def voxel_map_rows():
    from sr_livo_tpu.ops import voxel_map as jvm
    from sr_livo_tpu_torch.ops import voxel_map as tvm
    coords = V.RNG.randint(-2 ** 31, 2 ** 31 - 1, (4000, 3)).astype(np.int32)
    row("voxel_map.voxel_hash (int32-overflowing)",
        [(tvm.voxel_hash(torch.as_tensor(coords), 1 << 18).numpy(),
          jvm.voxel_hash(jnp.asarray(coords), 1 << 18))])
    row("voxel_map.voxel_sig (int32-overflowing)",
        [(tvm.voxel_sig(torch.as_tensor(coords)).numpy(),
          jvm.voxel_sig(jnp.asarray(coords)))])
    pts = V.RNG.uniform(-50, 50, (3000, 3)).astype(np.float32)
    row("voxel_map.voxel_coords",
        [(tvm.voxel_coords(torch.as_tensor(pts), 0.6).numpy(),
          jvm.voxel_coords(jnp.asarray(pts), 0.6))])
    jm, tm, accepted = V.maps.__wrapped__()
    got = convert.voxel_map_to_numpy(tm)
    row("voxel_map.insert (map fields + accepted masks)",
        [(got[k], getattr(jm, k)) for k in tvm.VoxelMap._fields]
        + [(ta, ja) for ja, ta in accepted])
    keys = np.asarray(jm.keys)
    used = keys[keys[:, 0] != jvm.EMPTY][:500].astype(np.int32)
    row("voxel_map.lookup", [(tvm.lookup(tm, torch.as_tensor(used), 8).numpy(),
                              jvm.lookup(jm, jnp.asarray(used), 8))])
    q = V.RNG.uniform(-6, 6, (300, 3)).astype(np.float32)
    kw = dict(voxel_size=1.0, max_neighbors=20, max_probe=8, nb_voxels=1,
              threshold_capacity=1)
    jn, jok, jd = (np.asarray(a) for a in jvm.knn(jm, jnp.asarray(q), **kw))
    tn, tok, td = (a.numpy() for a in tvm.knn(tm, torch.as_tensor(q), **kw))
    row("voxel_map.knn (counts, sorted distances)",
        [(tok.sum(1), jok.sum(1)),
         (np.sort(np.where(tok, td, 1e9), 1), np.sort(np.where(jok, jd, 1e9),
                                                       1))])
    row("voxel_map.knn (neighbour points in order, masks)",
        [(tn, jn), (tok, jok)])


def knn_plane_rows():
    import functools
    from sr_livo_tpu.models import lio as jlio
    import sr_livo_tpu.ops.pallas.plane_fit as jpf
    from sr_livo_tpu_torch.ops import plane_fit
    from sr_livo_tpu_torch.utils import lie as tlie
    jm, tm, world = K.scene.__wrapped__()
    n_valid = 700
    kw = dict(K.SEARCH, nb_voxels=1)
    jn, ja, jc, jf = (np.asarray(a)[:n_valid] for a in jlio.chunked_assoc(
        jm, jnp.asarray(world), jnp.int32(n_valid),
        threshold_capacity=jnp.int32(1), chunk=512, **kw))
    tn, ta, tc, tf = (a.numpy()[:n_valid] for a in plane_fit.knn_plane_assoc(
        tm, torch.as_tensor(world), torch.arange(K.Q) < n_valid,
        torch.tensor(1, dtype=torch.int32), chunk=512, **kw))
    plane = tf >= 3
    sign = np.where((tn * jn).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    row("plane_fit.knn_plane_assoc vs chunked_assoc, 700 of 1024 rows "
        "(n_found, closest, a2d; normal on rows with >= 3 neighbours)",
        [(tf, jf), (tc, jc), (ta, ja), ((tn * sign)[plane], jn[plane])])
    keypts, valid = world[:600], np.arange(600) < 520
    q = tlie.exp_so3_quat(torch.tensor([0.01, -0.02, 0.015]))
    t = torch.tensor([0.05, -0.03, 0.02])
    last = np.array([0.3, -0.2, 1.0], np.float32)
    loc = torch.as_tensor(keypts)
    thx, th, tgood = (a.numpy() for a in plane_fit.knn_plane_rows(
        tm, tlie.quat_rotate(q.expand(600, 4), loc) + t, loc,
        tlie.quat_to_rot(q), torch.as_tensor(last), torch.as_tensor(valid),
        torch.tensor(1, dtype=torch.int32), voxel_size=1.0, max_neighbors=20,
        max_probe=8, nb_voxels=1, lam_w=0.9, lam_nb=0.1,
        power_planarity=2.0, max_dist=0.3, min_neighbors=12))
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    for use_pallas in (False, True):
        patch = _Patch()
        if use_pallas:
            patch.setattr(jpf, "plane_residuals_pallas", functools.partial(
                jpf.plane_residuals_pallas, interpret=True))
        j = jlio.build_residuals(
            jm, jnp.asarray(keypts), jnp.asarray(valid),
            jnp.asarray(q.numpy()), jnp.asarray(t.numpy()), jnp.asarray(last),
            jnp.asarray(eye), jnp.asarray(zero),
            threshold_voxel_capacity=jnp.int32(1), use_pallas=use_pallas,
            size_voxel_map=1.0, nb_voxels_visited=1, max_number_neighbors=20,
            min_number_neighbors=12, power_planarity=2.0,
            max_dist_to_plane=0.3, weight_alpha=0.9, weight_neighborhood=0.1,
            max_num_residuals=0, max_probe=8)
        patch.restore()
        jhx, jh, jgood = (np.asarray(a) for a in (j.h_x, j.h, j.valid))
        both = tgood & jgood
        ref = "plane_residuals_pallas (interpret)" if use_pallas else "jnp"
        row(f"plane_fit.knn_plane_rows vs build_residuals [{ref}], uncapped "
            f"(rows good in both; good agree {(tgood == jgood).mean():.4f})",
            [(thx[both], jhx[both]), (th[both], jh[both])])


def plane_rows():
    from sr_livo_tpu.models.lio import _plane_rows_jnp
    from sr_livo_tpu.ops import neighborhood as jnb
    from sr_livo_tpu.ops.pallas.plane_fit import plane_residuals_pallas
    from sr_livo_tpu_torch.ops import plane_fit
    for power in (2.0, 1.5):
        args = PF._inputs(300, 20, seed=23, pin_degenerate=True)
        kw = PF._kw(power)
        hx, h, good = (a.numpy() for a in plane_fit.plane_rows_plain(
            *(torch.as_tensor(a) for a in args), **kw))
        jargs = tuple(jnp.asarray(a) for a in args)
        for ref, fn in (("_plane_rows_jnp", _plane_rows_jnp),
                        ("plane_residuals_pallas (interpret)",
                         lambda *a, **k: plane_residuals_pallas(
                             *a, **k, interpret=True))):
            jhx, jh, jgood = (np.asarray(a) for a in fn(*jargs, **kw))
            both = good & jgood
            row(f"plane_fit.plane_rows_plain vs {ref}, p={power} "
                f"(rows good in both; good agree "
                f"{(good == jgood).mean():.4f})",
                [(hx[both], jhx[both]), (h[both], jh[both])])
    nb, n_found = PF._inputs(400, 20, seed=11, pin_degenerate=True)[:2]
    n, a2d, cl = (a.numpy() for a in plane_fit.plane_assoc_plain(
        torch.as_tensor(nb), torch.as_tensor(n_found)))
    jn, ja, _ = (np.asarray(a) for a in jnb.neighborhood_distribution(
        jnp.asarray(nb), jnp.asarray(n_found)))
    rows = n_found >= 6
    sign = np.where((n * jn).sum(-1, keepdims=True) < 0, -1.0, 1.0)
    row("plane_fit.plane_assoc_plain vs neighborhood_distribution "
        "(n_found >= 6)", [((n * sign)[rows], jn[rows]),
                           (a2d[rows], ja[rows]), (cl, nb[:, 0])])


class _Patch:
    """Stands in for pytest's monkeypatch outside pytest."""

    def __init__(self):
        self.undo = []

    def setattr(self, obj, name, value):
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore(self):
        for obj, name, value in reversed(self.undo):
            setattr(obj, name, value)


def host_rows():
    from sr_livo_tpu.runtime import measurements as jmeas
    from sr_livo_tpu_torch.runtime import measurements as tmeas
    jm, tm = M.measurements.__wrapped__()
    row(f"measurements.SweepCutter ({len(tm)} sweeps, points)",
        [(a.points, b.points) for a, b in zip(tm, jm)])
    jcfg, tcfg = M._cfg(M.JCfg), M._cfg(M.TCfg)
    cur = jm[0].time_sweep_begin
    prep, wire = [], []
    for a, b in zip(tm, jm):
        tp = tmeas.prepare_sweep(a, cur, tcfg)
        jp = jmeas.prepare_sweep(b, cur, jcfg)
        prep += [(tp.raw_pts, jp.raw_pts), (tp.t_rel, jp.t_rel),
                 (tp.imu_acc, jp.imu_acc), (tp.imu_dt, jp.imu_dt)]
        tw = tmeas.prepare_sweep_wire(a, cur, tcfg)[1]
        jw = jmeas.prepare_sweep_wire(b, cur, jcfg)[1]
        wire += [(tw.pts_q, jw.pts_q), (tw.scale, jw.scale)]
        cur = tp.new_current_time
    row("measurements.prepare_sweep", prep)
    row("measurements.prepare_sweep_wire (native pack vs JAX native pack; "
        "int16 wire, scale)", wire)
    pts = M.RNG.randn(300, 12, 3) * [1.0, 0.6, 0.02]
    c = pts - pts.mean(1, keepdims=True)
    a = np.einsum("qmi,qmj->qij", c, c).astype(np.float32)
    from sr_livo_tpu.ops import neighborhood as jnb
    from sr_livo_tpu_torch.ops import neighborhood as tnb
    jl = np.array(jnb.eigvals_sym3x3(jnp.asarray(a)))
    row("neighborhood.eigvals_sym3x3 (planar scatter matrices)",
        [(tnb.eigvals_sym3x3(torch.as_tensor(a)).numpy(), jl)])


def lio_rows():
    scene = I.scene.__wrapped__()
    for case in I.CASES:
        patch = _Patch()
        j_out, j_sum = I._run_jax(scene, case, patch)
        patch.restore()
        t_out, t_sum = I._run_torch(scene, case)
        row(f"lio.iekf_update [{case}] (p, q; iterations "
            f"{int(t_sum.iterations)}/{int(j_sum.iterations)}, residuals "
            f"{int(t_sum.num_residuals)}/{int(j_sum.num_residuals)})",
            [(t_out.p.numpy(), j_out.p), (t_out.q.numpy(), j_out.q)])


def odometry_rows():
    kw = dict(duration=4.7, n_azimuth=80, n_rings=10, seed=5)
    jsim, tsim = O.jsyn.simulate(**kw), O.tsyn.simulate(**kw)
    for cache in (True, False):
        j, _ = O._drive(O.JPipe(O._cfg(O.JCfg, cache)), jsim, O.N_FRAMES)
        t, _ = O._drive(O.TPipe(O._cfg(O.TCfg, cache), device="cpu"), tsim,
                        O.N_FRAMES)
        row(f"odometry.LioEngine.step, {O.N_FRAMES} sweeps, cache_"
            f"association={cache} (record rows)", [(t, j)])


def pipeline_rows():
    jsim, tsim = P.jsyn.simulate(**P.SIM), P.tsyn.simulate(**P.SIM)
    row("synthetic.simulate (IMU, LiDAR chunks, ground truth)",
        [(a, b) for a, b in zip(tsim.lidar_chunks, jsim.lidar_chunks)]
        + [(np.stack([a for _, a, _ in tsim.imu]),
            np.stack([a for _, a, _ in jsim.imu])),
           (tsim.gt_pos, jsim.gt_pos)])
    jp, tp, frames = P.lockstep_runs.__wrapped__((jsim, tsim))
    tt, tpos, _ = tp.trajectory()
    jt, jpos, _ = jp.trajectory()
    ate_t = P.tum.ate_rmse(tt, tpos, tsim.gt_times, tsim.gt_pos, align=True)
    ate_j = P.tum.ate_rmse(jt, jpos, jsim.gt_times, jsim.gt_pos, align=True)
    gap = np.linalg.norm(tpos - jpos, axis=1).max()
    n_res = sum(a.num_residuals != b.num_residuals
                for a, b in zip(tp.records, jp.records))
    n_it = sum(a.iterations != b.iterations
               for a, b in zip(tp.records, jp.records))
    gaps = np.abs(tpos - jpos).max(axis=1)
    first = int(np.argmax(gaps > 1e-6))
    row(f"pipeline.LivoPipeline trajectory, {len(tt)} frames (max position "
        f"gap {gap:.3e} m, first over 1e-6 m at frame {first}: "
        f"{gaps[first]:.1e} m; ATE port {ate_t:.6f} m, JAX {ate_j:.6f} m; "
        f"residual counts differ on {n_res} frames, iterations on {n_it})",
        [(tpos, jpos)])
    lockstep_row("pipeline", frames)


def lockstep_row(name, frames):
    """The port's step on the JAX run's inputs at every frame
    (tests/lockstep.py): positions against the JAX step's."""
    same = sum(f.port == f.jax and f.port_updates == f.jax_updates
               for f in frames)
    row(f"odometry.LioEngine.step in lockstep with the JAX {name} run "
        f"(success, residual count, iterations and IEKF updates equal on "
        f"{same} of {len(frames)} frames; velocities within "
        f"{max(f.velocity_gap for f in frames):.1e} m/s; positions)",
        [([f.position_gap for f in frames], np.zeros(len(frames)))])


def retry_rows():
    """The r3live profile's bag without images (test_torch_replay_r3live),
    at the length of chip_smoke.py's phase `replay`: which frames each
    package re-runs over the widened neighbourhood."""
    d = _TmpDirs().mktemp("r3live")
    sim, jp, tp, frames, steps = RR.replay_both(str(d / "r3live.bag"),
                                                REPLAY_S)
    lockstep_row(f"{REPLAY_S:g} s r3live replay", frames)
    tt, tpos, _ = tp.trajectory()
    jt, jpos, _ = jp.trajectory()
    ate = [RP.tum.ate_rmse(t, p, sim.gt_times, sim.gt_pos, align=True)
           for t, p in ((tt, tpos), (jt, jpos))]
    retried = (sum(len(u) == 2 for u in steps),
               sum(len(f.jax_updates) == 2 for f in frames))
    same = sum(len(u) == len(f.jax_updates) for u, f in zip(steps, frames))
    n_res = [r.num_residuals for r in tp.records]
    n_diff = sum(a != b.num_residuals for a, b in zip(n_res, jp.records))
    worst = int(np.argmax(np.linalg.norm(tpos - jpos, axis=1)))
    row(f"drivers.replay_bag, {REPLAY_S:g} s r3live-profile Livox bag, "
        f"retry_wider_neighborhood ({len(tt)} / {len(jt)} frames, "
        f"{sum(r.success for r in tp.records)} / "
        f"{sum(r.success for r in jp.records)} registered, {retried[0]} / "
        f"{retried[1]} re-run, the same on {same} frames; residual counts "
        f"differ on {n_diff} frames; largest gap at frame {worst}, "
        f"{tt[worst]:.2f} s, on {n_res[worst]} residuals; ATE port "
        f"{ate[0]:.6f} m, JAX "
        f"{ate[1]:.6f} m; positions)", [(tpos, jpos)])


def gate_rows():
    """The accuracy gate: bag bytes and configurations against the JAX
    script and the test fixture, and the ntu profile's Ouster bag through
    both packages (test_torch_accuracy_gate)."""
    import dataclasses

    from sr_livo_tpu import config as jconfig

    def as_array(data: bytes):
        return np.frombuffer(data, np.uint8)
    jgate = AG.jgate.__wrapped__()
    rng = np.random.RandomState(3)
    pairs = []
    for name in ("ser_header", "ser_imu", "ser_livox_custom",
                 "ser_pointcloud2_ouster", "ser_image_rgb8",
                 "ser_compressed_image"):
        args = AG._serializer_args(name, rng)
        pairs.append((as_array(getattr(AG.tbw, name)(*args)),
                      as_array(getattr(AG.jbw, name)(*args))))
    row("bag_writer serializers (Imu, Livox, Ouster PointCloud2, rgb8, "
        "JPEG) vs tests/rosbag_writer.py; bytes", pairs)
    src = AG.source_bag.__wrapped__(_TmpDirs())
    pairs = []
    for build in (lambda m, b: m.build_dropout_bag(b, AG.tgate.R3_TOPICS[2],
                                                   (1.05, 1.95)),
                  lambda m, b: m.build_compressed_bag(b,
                                                      AG.tgate.R3_TOPICS[2])):
        pairs.append((as_array(open(build(AG.tgate, src[1]), "rb").read()),
                      as_array(open(build(jgate, src[0]), "rb").read())))
    row("accuracy_gate.build_dropout_bag, build_compressed_bag vs "
        "scripts/accuracy_gate.py; bytes", pairs)
    same = []
    for yaml_path in (AG.tgate.R3_YAML, AG.tgate.NTU_YAML):
        for cache, wire in ((True, True), (True, False), (False, True)):
            jcfg = jconfig.load_config(yaml_path)
            jgate._shape_overrides(jcfg)
            jcfg.cache_association, jcfg.wire_quantization = cache, wire
            jcfg.retry_wider_neighborhood = True
            same.append(dataclasses.asdict(jcfg) == dataclasses.asdict(
                AG.tgate.profile_config(yaml_path, cache, wire)))
    row(f"accuracy_gate.profile_config (r3live, ntu x 3 ablations: "
        f"{sum(same)} of {len(same)} equal)",
        [(np.array(same), np.ones(len(same), bool))])
    sim, jp, tp, frames, _steps, _path = AG.ntu_replays.__wrapped__(
        _TmpDirs())
    lockstep_row(f"{AG.NTU_DURATION:g} s ntu replay", frames)
    jr, tr = jp.records, tp.records
    n_fill = sum(not r.rendering for r in tr)
    row(f"drivers.replay_bag, {AG.NTU_DURATION:g} s ntu-profile Ouster bag "
        f"at 20 Hz ({len(tr)} / {len(jr)} frames, {n_fill} gap-fill): "
        f"frame stamps, rendering flags, success",
        [(np.array([r.time for r in tr]), np.array([r.time for r in jr])),
         (np.array([r.rendering for r in tr]),
          np.array([r.rendering for r in jr])),
         (np.array([r.success for r in tr]),
          np.array([r.success for r in jr]))])
    tt, tpos, _ = tp.trajectory()
    jt, jpos, _ = jp.trajectory()
    ate = [RP.tum.ate_rmse(t, p, sim.gt_times, sim.gt_pos, align=True)
           for t, p in ((tt, tpos), (jt, jpos))]
    row(f"drivers.replay_bag, the ntu bag closed loop (ATE port "
        f"{ate[0]:.6f} m, JAX {ate[1]:.6f} m; positions)", [(tpos, jpos)])


def image_rows():
    from sr_livo_tpu.ops import image_ops as jio
    from sr_livo_tpu.ops import lk as jlk
    from sr_livo_tpu.runtime import native
    from sr_livo_tpu_torch.ops import image_ops as tio
    from sr_livo_tpu_torch.ops import lk as tlk
    from sr_livo_tpu_torch.runtime.remap import remap_u8
    from tests import test_torch_image_ops as IO
    from tests import test_torch_lk as LK
    rgb = IO._image(512, 640)
    g = tio.rgb_to_gray(torch.as_tensor(rgb)).numpy()
    row("image_ops.rgb_to_gray (512 x 640)",
        [(g, jio.rgb_to_gray(jnp.asarray(rgb)))])
    jp, tp = jio.build_pyramid(jnp.asarray(g), 3), tio.build_pyramid(
        torch.as_tensor(g), 3)
    row("image_ops.build_pyramid (4 levels)",
        [(t.numpy(), j) for t, j in zip(tp, jp)])
    row("image_ops.scharr_derivatives (4 levels)",
        [(a.numpy(), b) for t, j in zip(tp, jp)
         for a, b in zip(tio.scharr_derivatives(t),
                         jio.scharr_derivatives(j))])
    uv = np.c_[IO.RNG.uniform(-3, 643, 4000),
               IO.RNG.uniform(-3, 515, 4000)].astype(np.float32)
    row("image_ops.bilinear_sample (RGB, clamped)",
        [(tio.bilinear_sample(torch.as_tensor(rgb), torch.as_tensor(uv)),
          jio.bilinear_sample(jnp.asarray(rgb), jnp.asarray(uv)))])
    tl = np.c_[IO.RNG.randint(-40, 100, 300),
               IO.RNG.randint(-40, 100, 300)].astype(np.int32)
    small = g[:15, :20]
    row("image_ops.extract_patches (clamped, level < window)",
        [(tio.extract_patches(torch.as_tensor(a), torch.as_tensor(tl),
                              34).numpy(),
          jio.extract_patches(jnp.asarray(a), jnp.asarray(tl), 34))
         for a in (g, small)])
    low = g * 0.4 + 60.0
    tc = tio.clahe(torch.as_tensor(low), 3.0, 32).numpy()
    jc = np.asarray(jio.clahe(jnp.asarray(low), 3.0, 32))
    row(f"image_ops.clahe (512 x 640, 32 tiles; share within 1e-3: "
        f"{IO._close_share(tc, jc, 1e-3):.6f})", [(tc, jc)])
    te = tio.equalize_color_ycrcb(torch.as_tensor(rgb), 32).numpy()
    je = np.asarray(jio.equalize_color_ycrcb(jnp.asarray(rgb), 32))
    row(f"image_ops.equalize_color_ycrcb (share within 1e-3: "
        f"{IO._close_share(te, je, 1e-3):.6f})", [(te, je)])
    img = IO.RNG.randint(0, 255, (48, 64, 3)).astype(np.uint8)
    m = np.stack(np.meshgrid(np.arange(64.0) * 0.97 + 0.6,
                             np.arange(48.0) * 0.95 + 0.4), -1).astype(
        np.float32)
    from sr_livo_tpu_torch.runtime import native as tnative
    row("native.remap_u8 vs JAX native.remap_u8 and vs runtime.remap."
        "remap_u8 (grey levels)",
        [(tnative.remap_u8(img, m), native.remap_u8(img, m)),
         (tnative.remap_u8(img, m), remap_u8(img, m))])
    prev, cur = LK._frames()
    (jpyr, jdx, jdy), (jcur, _, _), (tpyr, tdx, tdy), (tcur, _, _) = \
        LK._pyramids(prev, cur)
    pts = LK._points(300, *prev.shape)
    valid = np.ones(300, bool)
    jo, js = (np.asarray(a) for a in jlk.track_pyramidal(
        jpyr, jcur, jdx, jdy, jnp.asarray(pts), jnp.asarray(valid)))
    to, ts = (a.numpy() for a in tlk.track_pyramidal(
        tpyr, tcur, tdx, tdy, torch.as_tensor(pts), torch.as_tensor(valid)))
    both = ts & js
    row(f"lk.track_pyramidal (status agree {(ts == js).mean():.4f}; "
        f"positions where both ok)", [(to[both], jo[both])])


def ransac_rows():
    import jax
    from sr_livo_tpu.ops import ransac as jr
    from sr_livo_tpu_torch.ops import ransac as tr
    key = jax.random.PRNGKey(3)
    valid = np.zeros(40, bool)
    valid[[5, 17, 30]] = True
    row("ransac._sample_indices (3 of 40 valid, ties at -inf)",
        [(tr._sample_indices(torch.as_tensor(R._noise(key, 64, 40)),
                             torch.as_tensor(valid), 8).numpy(),
          jr._sample_indices(key, 64, 8, 40, jnp.asarray(valid)))])
    f_pairs, p_pairs = [], []
    for seed in (0, 1, 2):
        pts, p0, p1, valid, w, t_true = R._scene(seed)
        key = jax.random.PRNGKey(seed)
        f_pairs.append((tr.fundamental_ransac(
            torch.as_tensor(p0), torch.as_tensor(p1), torch.as_tensor(valid),
            torch.as_tensor(R._noise(key, 128, len(p0)))).numpy(),
            jr.fundamental_ransac(jnp.asarray(p0), jnp.asarray(p1),
                                  jnp.asarray(valid), key)))
        q0 = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        t0 = (t_true + [0.05, -0.04, 0.06]).astype(np.float32)
        intr = R.INTR.astype(np.float32)
        tout = tr.pnp_ransac(torch.as_tensor(pts), torch.as_tensor(p1),
                             torch.as_tensor(valid), torch.as_tensor(q0),
                             torch.as_tensor(t0), torch.as_tensor(intr),
                             torch.as_tensor(R._noise(key, 64, len(pts))))
        jout = jr.pnp_ransac(jnp.asarray(pts), jnp.asarray(p1),
                             jnp.asarray(valid), jnp.asarray(q0),
                             jnp.asarray(t0), jnp.asarray(intr), key)
        p_pairs += [(a.numpy(), b) for a, b in zip(tout, jout)]
    row("ransac.fundamental_ransac (inlier masks, 3 scenes)", f_pairs)
    row("ransac.pnp_ransac (inlier masks, q, t; 3 scenes)", p_pairs)


def color_map_rows():
    jm, tm = CM.maps.__wrapped__()
    got = convert.color_map_to_numpy(tm)
    row("color_map.color_insert, 4 inserts (reg, count, visit stamps, "
        "dedup_sig, recent_slots, voxel table)",
        [(got[k], getattr(jm, k)) for k in ("reg", "count", "vox_last_visit",
                                            "dedup_sig", "recent_slots")]
        + [(v, getattr(jm.vox, k)) for k, v in got["vox"].items()])
    q_cw, t_cw, t_wc = CM._camera()
    img = np.tile(np.arange(160, dtype=np.float32)[None, :, None],
                  (120, 1, 3))
    jm = CM.jcm.render_recent(jm, jnp.asarray(img), jnp.asarray(q_cw),
                              jnp.asarray(t_cw), jnp.asarray(t_wc),
                              jnp.asarray(CM.INTR), 3.0, cols=160, rows=120,
                              max_render_points=512)
    tm = CM.tcm.render_recent(tm, torch.as_tensor(img),
                              torch.as_tensor(q_cw), torch.as_tensor(t_cw),
                              torch.as_tensor(t_wc), torch.as_tensor(CM.INTR),
                              3.0, cols=160, rows=120, max_render_points=512)
    row("color_map.render_recent (rgb, cov)",
        [(tm.rgb.numpy(), jm.rgb), (tm.cov_rgb.numpy(), jm.cov_rgb)])
    row("color_map.render_recent (n_rgb)", [(tm.n_rgb.numpy(), jm.n_rgb)])
    j = CM.jcm.select_points_for_projection(
        jm, jnp.asarray(q_cw), jnp.asarray(t_cw), jnp.asarray(t_wc),
        jnp.asarray(CM.INTR), 3.0, max_out=256, cols=160, rows=120,
        grid_px=10)
    t = CM.tcm.select_points_for_projection(
        tm, torch.as_tensor(q_cw), torch.as_tensor(t_cw),
        torch.as_tensor(t_wc), torch.as_tensor(CM.INTR), max_out=256,
        cols=160, rows=120, grid_px=10)
    ok = t[2].numpy()
    row("color_map.select_points_for_projection (ids, mask)",
        [(t[0].numpy()[ok], np.asarray(j[0])[ok]), (ok, j[2])])


def camera_rows():
    from sr_livo_tpu.models import camera as jcam
    from sr_livo_tpu_torch.models import camera as tcam
    rng = np.random.RandomState(5)
    q_wi, t_wi, pw, px, vel = C._reproj_scene(rng)
    valid = rng.rand(len(pw)) < 0.9
    jc, tc = C._start()
    for n_new in (100, 3, 900):
        jc, _ = jcam.vio_esikf(
            jc, jnp.asarray(q_wi.numpy()), jnp.asarray(t_wi.numpy()),
            jnp.asarray(pw), jnp.asarray(px), jnp.asarray(vel),
            jnp.asarray(valid), n_new)
        tc, _ = tcam.vio_esikf(
            tc, q_wi, t_wi, torch.as_tensor(pw), torch.as_tensor(px),
            torch.as_tensor(vel), torch.as_tensor(valid), n_new)
    row("camera.vio_esikf, 3 steps (td, q_ic, t_ic, intr, cov)",
        state_pairs(tc, jc))


def vision_rows():
    sim = VI.jsyn.simulate(**VI.SIM)
    jp, jv, tp, tv = VI.runs.__wrapped__(sim)
    tt, tpos, _ = tp.trajectory()
    _, jpos, _ = jp.trajectory()
    kept_t = np.array([s[1] for s in tv.stats])
    kept_j = np.array([s[1] for s in jv.stats])
    col_t = int((tv.color_map.reg_valid & (tv.color_map.n_rgb >= 3)).sum())
    col_j = int((np.asarray(jv.color_map.reg_valid)
                 & (np.asarray(jv.color_map.n_rgb) >= 3)).sum())
    ate = VI.tum.ate_rmse(tt, tpos, sim.gt_times, sim.gt_pos, align=True)
    row(f"vision LIVO run, {len(tt)} frames, {len(kept_t)} vision steps "
        f"(max position gap {np.linalg.norm(tpos - jpos, axis=1).max():.3e}"
        f" m; ATE port {ate:.6f} m; kept tracks differ on "
        f"{int((kept_t != kept_j).sum())} frames by at most "
        f"{int(np.abs(kept_t - kept_j).max())}; colored points {col_t} / "
        f"{col_j}; td {float(tv.camera.td):.3e} / {float(jv.camera.td):.3e}"
        f"; intrinsics)", [(tv.camera.intr.numpy(), jv.camera.intr)])
    cam = (52.0, 50.0, 40.0, 30.0)
    kw = dict(r_imu_camera=VI.R_CFG, dist_coeffs=[-0.28, 0.07, 8e-4, -2e-4,
                                                  0.0])
    row("synthetic.render_image (torch float64 on the CPU vs numpy, "
        "60 x 80, distorted)",
        [(VI.tsyn.render_image(VI.tsyn.SyntheticWorld(), VI.tsyn.Trajectory(),
                               t, cam, (60, 80), device="cpu", **kw),
          VI.jsyn.render_image(VI.jsyn.SyntheticWorld(), VI.jsyn.Trajectory(),
                               t, cam, (60, 80), **kw))
         for t in (0.3, 6.1)])


def ingest_rows():
    """The native ingest entries against the JAX package's native ones and
    against the port's plain versions, on the test_torch_native inputs;
    the vendor goldens; the 6 s bag replay against the JAX replay."""
    from sr_livo_tpu.runtime import native as jn
    from sr_livo_tpu_torch.runtime import native as tn
    from sr_livo_tpu_torch.runtime.remap import remap_u8

    def both(name, fn, args, kw=None):
        kw = kw or {}
        t = fn(*args, **kw)
        pairs = [(t, getattr(jn, name)(*args, **kw)),
                 (t, getattr(tn, f"{name}_numpy")(*args, **kw))]
        return [(a, b) for x, y in pairs
                for a, b in (zip(x, y) if isinstance(x, tuple) else [(x, y)])]

    pairs = []
    for case, (t_dtype, t_values, scale, t_base) in sorted(
            N.DECODE_CASES.items()):
        rng = np.random.RandomState(1 + t_dtype)
        args = (N._cloud(rng, 500, 24, t_dtype, t_values), 500, 24, 0, 4, 8,
                12, t_dtype, scale)
        pairs += both("decode_xyzt", tn.decode_xyzt, args,
                      {"t_base": t_base})
    row("native.decode_xyzt (no time, f32 s and ms, f64 Robosense epoch "
        "stamps, u32 ns; vs JAX native and plain)", pairs)
    data = N._cloud(np.random.RandomState(7), 300, 24, 0, None)
    row("native.decode_ring (u8, u16; vs JAX native and plain)",
        both("decode_ring", tn.decode_ring, (data, 300, 24, 21, 1))
        + both("decode_ring", tn.decode_ring, (data, 300, 24, 22, 2)))
    pairs = []
    for given in (True, False):
        for fnum in (1, 3):
            xyzt, ring = N._spinning_input(np.random.RandomState(11 + fnum),
                                           given)
            for header, last in ((100.0, -1.0), (100.05, 100.098)):
                pairs += both("process_spinning", tn.process_spinning,
                              (xyzt, ring, 16, 10, fnum, 1.0, header, given,
                               last))
    row("native.process_spinning (given time and yaw synthesis, filter 1 "
        "and 3, gated; vs JAX native and plain)", pairs)
    pairs = []
    for fnum in (1, 2):
        pairs += both("process_livox", tn.process_livox, N._livox_args(fnum))
    row("native.process_livox (filter 1 and 2; vs JAX native and plain)",
        pairs)
    img, m = N._remap_args(3)
    t = tn.remap_u8(img, m)
    row("native.remap_u8 (96 x 128 -> 60 x 80, RGB; vs JAX native and "
        "plain)", [(t, jn.remap_u8(img, m)), (t, remap_u8(img, m))])
    pairs = []
    for n, max_points in N.PACK_CASES.values():
        pts, plain = N._pack_case(n, max_points)
        got = tn.prepare_pack(pts, 0.0, 0.1, 0.1, max_points)
        pairs += list(zip(got, jn.prepare_pack(pts, 0.0, 0.1, 0.1,
                                               max_points)))
        pairs += list(zip(got, plain))
    row("native.prepare_pack (empty, normal, overflow, one slot; int16 "
        "wire, scale, count; vs JAX native and prepare_sweep + pack_sweep)",
        pairs)
    gold = np.load(DR.FIX)
    pairs = []
    for vendor in sorted(DR.GOLDEN_CFGS):
        cp = DR.drivers.CloudProcessing(DR.GOLDEN_CFGS[vendor]())
        payload = gold[f"{vendor}_payload"].tobytes()
        out = (cp.process_livox(DR.drivers.parse_livox_custom(payload))
               if vendor == "livox" else
               cp.process_cloud(DR.drivers.parse_pointcloud2(payload)))
        pairs += [(out, gold[f"{vendor}_expected"]),
                  (cp.last_end_time, gold[f"{vendor}_last_end"])]
    row("drivers.CloudProcessing vs the frozen vendor goldens (Livox, "
        "Ouster, Velodyne, Robosense; points, last_end_time)", pairs)
    sim, jp, tp = RP.replays.__wrapped__(_TmpDirs())
    tt, tpos, _ = tp.trajectory()
    jt, jpos, _ = jp.trajectory()
    ate = RP.tum.ate_rmse(tt, tpos, sim.gt_times, sim.gt_pos,
                          align=True)
    row(f"drivers.replay_bag, 6 s Velodyne bag ({len(tt)} / {len(jt)} "
        f"frames, {sum(r.success for r in tp.records)} / "
        f"{sum(r.success for r in jp.records)} registered, ATE port "
        f"{ate:.6f} m; positions)", [(tpos, jpos)])


class _TmpDirs:
    """Stands in for pytest's tmp_path_factory."""

    def mktemp(self, name):
        import pathlib
        import tempfile
        return pathlib.Path(tempfile.mkdtemp(prefix=name))


def long_run_rows():
    import jax
    from sr_livo_tpu.models import eskf as jeskf
    from sr_livo_tpu.ops import voxel_map as jvm
    from sr_livo_tpu.parallel import loop_closure as jlc
    from sr_livo_tpu.parallel import pose_graph as jpg
    from sr_livo_tpu_torch.models import eskf as teskf
    from sr_livo_tpu_torch.ops import voxel_map as tvm
    from sr_livo_tpu_torch.parallel import loop_closure as tlc
    from sr_livo_tpu_torch.parallel import pose_graph as tpg

    st = jeskf.init_state()._replace(p=jnp.asarray([1.0, 2.0, 0.5]))
    q = np.array([0.99, 0.1, 0.0, 0.0], np.float32)
    q /= np.linalg.norm(q)
    t = np.array([1.05, 1.9, 0.52], np.float32)
    row("eskf.observe_pose (all state fields)", state_pairs(
        teskf.observe_pose(convert.eskf_state_from_numpy(st),
                           torch.as_tensor(t), torch.as_tensor(q)),
        jeskf.observe_pose(st, jnp.asarray(t), jnp.asarray(q))))

    jm = EV.jax_map.__wrapped__()
    loc = np.array([2.0, -1.0, 0.3], np.float32)
    row("voxel_map.remove_far_voxels (all map fields)", state_pairs(
        tvm.remove_far_voxels(convert.voxel_map_from_numpy(jm),
                              torch.as_tensor(loc), 6.0),
        jvm.remove_far_voxels(jm, jnp.asarray(loc), 6.0)))
    for dist, probe in ((6.0, 16), (100.0, 2)):
        tmap, tdrop = tvm.compact_map(convert.voxel_map_from_numpy(jm),
                                      torch.as_tensor(loc), distance=dist,
                                      max_probe=probe)
        jmap, jdrop = jvm.compact_map_impl(jm, jnp.asarray(loc),
                                           distance=dist, max_probe=probe)
        row(f"voxel_map.compact_map, {dist} m, max_probe {probe} (all map "
            f"fields, n_dropped {int(tdrop)} / {int(jdrop)})",
            state_pairs(tmap, jmap) + [(tdrop.numpy(), jdrop)])

    g = PG.graph96.__wrapped__()
    for name in ("dense", "pcg"):
        qt, tt = getattr(tpg, f"optimize_pose_graph_{name}")(
            convert.pose_graph_from_numpy(g), iters=6)
        qj, tj = getattr(jpg, f"optimize_pose_graph_{name}")(g, iters=6)
        row(f"pose_graph.optimize_pose_graph_{name} (96 nodes, 6 iterations;"
            " q, t)", [(qt.numpy(), qj), (tt.numpy(), tj)])

    world, jmap, tmap, rng = BA.scene.__wrapped__()
    for n_valid, iters in ((None, 4), ([256, 180, 97, 230], 2)):
        window, q_odo, t_odo, _, _ = BA._window(world, rng, n_valid=n_valid)
        qj, tj, qt, tt = BA._run_both(jmap, tmap, window, q_odo, t_odo, iters)
        row(f"ba.windowed_ba (4 x 256 rows{', padded' if n_valid else ''}, "
            f"{iters} iterations; q, t)", [(qt, qj), (tt, tj)])

    for case in ("circle", "lissajous"):
        LC.test_find_candidates_identical(case)
    row("loop_closure.find_candidates (circle, Lissajous; identical "
        "pairs)", [])
    args = LC._scene("revisit")
    rt = tlc.verify_closure(*(torch.as_tensor(np.array(a)) for a in args))
    with jax.disable_jit():
        rj = jlc.verify_closure(*(jnp.asarray(a) for a in args))
    rc = jlc.verify_closure(*(jnp.asarray(a) for a in args))
    for name, r in (("op by op", rj), ("compiled", rc)):
        row(f"loop_closure.verify_closure vs JAX {name} (revisit; fitness "
            f"{float(rt.fitness):.6f} / {float(r.fitness):.6f}, t_obs "
            f"{float(rt.t_observability):.6f} / "
            f"{float(r.t_observability):.6f}; q_meas, t_meas)",
            [(rt.q_meas.numpy(), r.q_meas), (rt.t_meas.numpy(), r.t_meas)])

    sim, _, jb, _, tb = BE.backend_runs.__wrapped__()
    _, t_opt, _ = tb.optimized_trajectory()
    _, jt_opt, _ = jb.optimized_trajectory()
    row(f"MappingBackend, 9 s run ({len(tb.keyframes)} keyframes, "
        f"{len(tb.edges)} edges, {tb.ba_runs} BA runs; optimized "
        "trajectory)", [(t_opt, jt_opt)])
    jb2, tb2, _ = BE._drifted_backends()
    cfg = BE._cfg()
    jp, tp = BE._Pipe(), BE._Pipe()
    jp.cfg, jp.state = cfg, jeskf.init_state()
    jp.voxel_map = jvm.make_map(cfg.shapes.map_capacity, 20)
    tp.cfg, tp.device = BE._port_cfg(cfg), torch.device("cpu")
    tp.state = teskf.init_state()
    tp.voxel_map = tvm.make_map(cfg.shapes.map_capacity, 20)
    jb2.apply_pose_correction(jp)
    tb2.apply_pose_correction(tp)
    tm = convert.voxel_map_to_numpy(tp.voxel_map)
    row("MappingBackend.apply_pose_correction + _rebuild_map (map keys, "
        "sig, counts, point_ids)",
        [(tm[k], np.asarray(getattr(jp.voxel_map, k)))
         for k in ("keys", "sig", "counts", "point_ids")])

    _, jpe, tpe = EV.eviction_runs.__wrapped__()
    row(f"eviction run, 12 m every 5 frames (map points "
        f"{int(tvm.map_size(tpe.voxel_map))} / "
        f"{int(jvm.map_size(jpe.voxel_map))}; positions)",
        [(tpe.trajectory()[1], jpe.trajectory()[1])])

    (jdir, _), (tdir, _, _), _ = ST.streams.__wrapped__(_TmpDirs())
    row("StreamPublisher, 7 s LIVO run (odometry_live.txt rows)",
        [(np.loadtxt(f"{tdir}/odometry_live.txt"),
          np.loadtxt(f"{jdir}/odometry_live.txt"))])

    sim = CK.sim.__wrapped__()
    base = CK.jrun(CK.JPipe(CK._cfg()), sim)
    first = CK.JPipe(CK._cfg())
    CK._feed(first, sim, 0.0, 5.0)
    path = str(_TmpDirs().mktemp("ckpt") / "jax.npz")
    first.save_checkpoint(path)
    resumed = CK.TPipe(CK._port_cfg(), device="cpu")
    resumed.load_checkpoint(path)
    CK._feed(resumed, sim, 5.0, 99.0)
    row("checkpoint: JAX checkpoint at 5 s resumed by the port (positions "
        "vs the JAX uninterrupted run)",
        [(resumed.trajectory()[1], base.trajectory()[1])])


def backend_programs_rows():
    """The long-run path's captured programs (test_torch_backend_programs)
    in capture form: each against its eager function and against the
    JAX function."""
    import jax
    from sr_livo_tpu.ops import voxel_map as jvm
    from sr_livo_tpu.parallel import ba as jba
    from sr_livo_tpu.parallel import loop_closure as jlc
    from sr_livo_tpu.parallel import pose_graph as jpg
    from sr_livo_tpu_torch.ops import voxel_map as tvm
    from sr_livo_tpu_torch.parallel import ba as tba
    from sr_livo_tpu_torch.parallel import loop_closure as tlc
    from sr_livo_tpu_torch.parallel import pose_graph as tpg
    from sr_livo_tpu_torch.utils import graphs

    def flat(tree):
        return [t.numpy() for t in graphs.tree_leaves(tree)]

    for solver, n in BP.SOLVER_NODES.items():
        g = BP._chain_graph(n=n, drift=0.03,
                            rng=np.random.RandomState(23))[0]
        tg = convert.pose_graph_from_numpy(g)
        with graphs.capture_form():
            got = tpg.optimize_pose_graph_program({}, tg, iters=4)
        name = f"pose_graph program, {solver} ({n} nodes, 4 iterations; q, t)"
        row(f"{name} vs eager", list(zip(flat(got), flat(
            tpg.optimize_pose_graph(tg, iters=4)))))
        row(f"{name} vs JAX", list(zip(flat(got), jpg.optimize_pose_graph(
            g, iters=4))))

    world, jmap = BP._world_and_map(np.random.RandomState(17))
    tmap = convert.voxel_map_from_numpy(jmap)
    window, q_odo, t_odo, _, _ = BP._window(world, np.random.RandomState(3),
                                            n_valid=[256, 180, 97, 230])
    args = (convert.keyframe_window_from_numpy(window),
            torch.as_tensor(q_odo), torch.as_tensor(t_odo))
    kw = dict(voxel_size=1.0, min_neighbors=8, iters=2)
    with graphs.capture_form():
        got = tba.windowed_ba_program({}, tmap, *args, **kw)
    name = "windowed_ba program (4 x 256 rows, padded, 2 iterations; q, t)"
    row(f"{name} vs eager", list(zip(flat(got), flat(
        tba.windowed_ba(tmap, *args, **kw)))))
    row(f"{name} vs JAX", list(zip(flat(got), jba.windowed_ba(
        jmap, jba.KeyframeWindow(**{k: jnp.asarray(v)
                                    for k, v in window.items()}),
        jnp.asarray(q_odo), jnp.asarray(t_odo), **kw))))

    args = BP._scene("revisit")
    targs = [torch.as_tensor(np.array(a)) for a in args]
    with graphs.capture_form():
        got = tlc.verify_closure_program({}, *targs)
    with jax.disable_jit():
        rj = jlc.verify_closure(*(jnp.asarray(a) for a in args))
    name = "verify_closure program (revisit; all fields)"
    row(f"{name} vs eager", list(zip(flat(got), flat(
        tlc.verify_closure(*targs)))))
    row(f"{name} vs JAX op by op", list(zip(flat(got), rj)))

    jm = BP.jax_map.__wrapped__()
    loc = np.array([2.0, -1.0, 0.3], np.float32)
    for dist, probe in ((6.0, 16), (100.0, 2)):
        tm = convert.voxel_map_from_numpy(jm)
        eager = tvm.compact_map(tm, torch.as_tensor(loc), distance=dist,
                                max_probe=probe)
        with graphs.capture_form():
            got = tvm.compact_map_program({}, tm, torch.as_tensor(loc),
                                          distance=dist, max_probe=probe)
        jmap2, jdrop = jvm.compact_map_impl(jm, jnp.asarray(loc),
                                            distance=dist, max_probe=probe)
        name = (f"compact_map program, {dist} m, max_probe {probe} (all map "
                "fields, n_dropped)")
        row(f"{name} vs eager", list(zip(flat(got), flat(eager))))
        row(f"{name} vs JAX", state_pairs(got[0], jmap2)
            + [(got[1].numpy(), jdrop)])

    rng = np.random.RandomState(6)
    world = rng.uniform(-6, 6, (16 * 256, 3)).astype(np.float32)
    valid = rng.rand(16 * 256) < 0.9
    targs = (torch.as_tensor(world), torch.as_tensor(valid), 0.5, 0.05, 16)
    with graphs.capture_form():
        got = tvm.insert_program({}, tvm.make_map(1 << 12, 20), *targs)
    eager = tvm.insert(tvm.make_map(1 << 12, 20), *targs)
    jgot, jacc = jvm.insert(jvm.make_map(1 << 12, 20), jnp.asarray(world),
                            jnp.asarray(valid), 0.5, 0.05, 16)
    name = "insert program, the rebuild's group (16 x 256 rows; map, accepted)"
    row(f"{name} vs eager", list(zip(flat(got), flat(eager))))
    row(f"{name} vs JAX", state_pairs(got[0], jgot)
        + [(got[1].numpy(), jacc)])

    (b0, p0), (b1, p1) = BP.backend_pair.__wrapped__()
    row(f"MappingBackend in capture form vs plain (synthetic revisit: "
        f"{len(b0.keyframes)} keyframes, {b0.n_loop_closures} closures, "
        f"{b0.ba_runs} BA runs; optimized t, rebuilt map)",
        [(a, b) for a, b in zip(b1.optimized_trajectory()[1:],
                                b0.optimized_trajectory()[1:])]
        + list(zip(flat(p1.voxel_map), flat(p0.voxel_map))))


def sharded_rows():
    rng = np.random.RandomState(3)
    h = rng.randint(-2 ** 31, 2 ** 31 - 1, 4000, dtype=np.int64
                    ).astype(np.int32)
    c = rng.randint(-3000, 3000, (4000, 3)).astype(np.int32)
    row("routing.hash_range_owner, 4000 int32 hashes, n = 4",
        [(RT.tr.hash_range_owner(torch.as_tensor(h), 4).numpy(),
          RT.jr.hash_range_owner(jnp.asarray(h), 4))])
    row("sharded_lio.shard_of, 4000 voxels, n = 4",
        [(RT.tsl.shard_of(torch.as_tensor(c), 4).numpy(),
          RT.jsl.shard_of(jnp.asarray(c), 4))])
    dest = rng.randint(0, 4, 300).astype(np.int32)
    valid = rng.rand(300) < 0.8
    rows = RT.tr.pack_cols(torch.as_tensor(rng.randn(300, 3)
                                           .astype(np.float32)),
                           torch.arange(300, dtype=torch.int32))
    for budget in (64, 5):
        t = RT.tr.pack_for_exchange(torch.as_tensor(dest),
                                    torch.as_tensor(valid), rows, 4, budget)
        j = RT.jr.pack_for_exchange(jnp.asarray(dest), jnp.asarray(valid),
                                    jnp.asarray(rows.numpy()), 4, budget)
        row(f"routing.pack_for_exchange, 300 rows, budget {budget} "
            f"({int(t[2])} dropped)",
            [(t[0].numpy().view(np.int32), np.asarray(j[0]).view(np.int32)),
             (t[1].numpy(), j[1]), (int(t[2]), int(j[2]))])
    outs, got, dropped = RT.exchanged.__wrapped__(_TmpDirs())
    row("routing.exchange, 4 gloo ranks vs shard_map on 4 devices",
        [(np.stack([o["got"] for o in outs]), got)])

    runs = SL.runs.__wrapped__(_TmpDirs())
    port, ref = runs["ranks"][0]["lockstep"], runs["jax"]
    row(f"ShardedLioEngine.step, 4 ranks in lockstep, {len(ref)} sweeps: "
        "positions", [(p["state"]["p"], r["p"]) for p, r in zip(port, ref)])
    row("  ... success, residual count, iterations, overflow, map_size",
        [(np.array([p[k] for k in ("success", "num_residuals", "iterations",
                                   "route_overflow", "map_size")]),
          np.array([r[k] for k in ("success", "num_residuals", "iterations",
                                   "route_overflow", "map_size")]))
         for p, r in zip(port, ref)])
    row("  ... frame_valid, inserted",
        [(p[k], r[k]) for p, r in zip(port, ref)
         for k in ("frame_valid", "inserted")])
    row("  ... in capture form (every masked round; the step program's "
        "function): positions", [(p["state"]["p"], r["p"]) for p, r in zip(
            runs["ranks"][0]["lockstep_capture"], ref)])
    row("  ... starved budgets: route_overflow per sweep",
        [(np.array([p["route_overflow"] for p in runs["ranks"][0]["starved"]]),
          np.array([r["route_overflow"] for r in runs["jax_starved"]]))])
    for name in ("closed", "closed_cap"):
        row(f"ShardedLioEngine (4 ranks) vs the port's LioEngine, closed "
            f"loop, {'cap 220' if name == 'closed_cap' else 'no cap'}: "
            "positions",
            [(p["state"]["p"], s["p"]) for p, s in
             zip(runs["ranks"][0][name], runs["single"][name])])

    solved = SB.solved.__wrapped__(_TmpDirs())
    for case, label in enumerate(("normal", "starved")):
        p, r = solved["ranks"][0]["ba"][case], solved["ref"][case]
        row(f"ba.make_sharded_windowed_ba, 4 ranks, {label} budgets "
            f"(overflow {p['overflow']} / {r['overflow']}): q, t",
            [(p["q"], r["q"]), (p["t"], r["t"])])
        c = solved["ranks"][0]["ba_capture"][case]
        row("  ... sharded_windowed_ba_program in capture form: q, t",
            [(c["q"], r["q"]), (c["t"], r["t"])])
    got = convert.sharded_map_to_numpy([r["compact"]["map"]
                                        for r in solved["ranks"]])
    row("ShardedLioEngine.compact, 4 ranks: tables",
        [(got[f], a) for f, a in solved["compact"]["map"].items()])


def scaling_rows():
    import dataclasses

    from sr_livo_tpu_torch.runtime import live_viewer
    from sr_livo_tpu_torch.runtime import scaling_bench as sb

    jb = SC.jbench.__wrapped__()
    row("scaling_bench.base_cfg (scales 1, 2, 8, 64): numeric fields",
        [(np.array([v for v in _leaves(dataclasses.asdict(sb.base_cfg(k)))]),
          np.array([v for v in _leaves(dataclasses.asdict(jb.base_cfg(k)))]))
         for k in (1, 2, 8, 64)])
    row("scaling_bench.pershard_budgets and pershard_override (8 cases)",
        [(np.array(list(f(sb.base_cfg(k), n).values())),
          np.array(list(g(jb.base_cfg(k), n).values())))
         for k, n in SC.BUDGET_CASES
         for f, g in ((sb.pershard_budgets, jb.pershard_budgets),
                      (sb.pershard_override,
                       lambda c, n: SC._jax_override(jb, c, n)))])
    for tile in (1, 2, 8):
        ps = sb.build_sweeps(sb.base_cfg(tile), n=2, device="cpu")
        js = jb.build_sweeps(jb.base_cfg(tile), n=2, tile=tile)
        row(f"scaling_bench.build_sweeps(n=2), tile {tile}: every array",
            [(getattr(p, k).numpy(), np.asarray(getattr(j, k)))
             for p, j in zip(ps, js) for k in p._fields])
    bw, lat = 478.116e9, 41e-6
    jb.ICI_BW, jb.COLL_LAT = bw, lat
    pairs = []
    for k, n in ((1, 8), (8, 8), (64, 8)):
        b = sb.pershard_budgets(sb.base_cfg(k), n)
        pairs.append((np.array(sb.comm_model(b, n, 6, True, link_bw=bw,
                                             latency=lat)),
                      np.array(jb.comm_model(b, n, 6, True)
                               + (6 * 43 * 4 * 2 + b["F_seg"] * n * 8) / bw
                               + lat)))
    row("scaling_bench.comm_model vs the JAX model + the port's departures "
        "(s)", pairs)
    port, ref = SC.replicated_pair(jb)
    row("scaling_bench.replicated_remainder vs the script's repl_only: p, "
        "cov", list(zip(port, ref)))
    px = SC.proxies.__wrapped__(jb)
    for name in sorted(SC.PROXIES):
        port, ref = px[name]["port"], px[name]["ref"]
        row(f"ShardedLioEngine per-rank proxy {name} (world of one, n-rank "
            "budgets) in lockstep with JAX's, 4 sweeps: positions",
            [(p["p"], r["p"]) for p, r in zip(port, ref)])
        keys = ("success", "num_residuals", "iterations", "route_overflow",
                "map_size")
        row("  ... success, residual count, iterations, overflow, map_size, "
            "frame_valid, inserted",
            [(np.array([p[k] for k in keys]), np.array([r[k] for k in keys]))
             for p, r in zip(port, ref)]
            + [(p[k], r[k]) for p, r in zip(port, ref)
               for k in ("frame_valid", "inserted")])
    jv = LV.jviewer.__wrapped__()
    dirs = LV.stream_dirs.__wrapped__(_TmpDirs())
    row("live_viewer.load_state on a port stream (full, thinned, empty)",
        [(a, b) for case, mp in (("full", 400_000), ("full", 100),
                                 ("empty", 10))
         for a, b in zip(live_viewer.load_state(dirs[case], mp)[:4],
                         jv.load_state(dirs[case], mp)[:4])])


def _leaves(d):
    for v in d.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif isinstance(v, (bool, int, float)):
            yield float(v)


SECTIONS = (lie_rows, eskf_rows, frame_rows, voxel_map_rows, host_rows,
            plane_rows, knn_plane_rows, lio_rows, odometry_rows,
            pipeline_rows, image_rows, ransac_rows, color_map_rows,
            camera_rows, vision_rows, long_run_rows, backend_programs_rows,
            ingest_rows,
            retry_rows, sharded_rows, gate_rows, scaling_rows)


def main(argv):
    """Every section, or those named on the command line (`ingest`,
    `pipeline`, ...: the function names without `_rows`)."""
    names = {fn.__name__[:-len("_rows")]: fn for fn in SECTIONS}
    for name in argv or names:
        names[name]()
    print("| function | max abs error | bit-exact |")
    print("| --- | --- | --- |")
    for name, err, exact in ROWS:
        print(f"| {name} | {err:.3e} | {'yes' if exact else 'no'} |")


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
