"""Print the port's parity table: each ported function against its JAX
counterpart on the inputs of the `test_torch_*` files, with the largest
absolute difference and whether the outputs are bit-exact.

    JAX_PLATFORMS=cpu python -m tests.torch_parity_report

Runs on the CPU (the port's plain path) in about two minutes; the tests
hold the bounds, this script reports the measured values for PERF.md.
"""
import tests.conftest  # noqa: F401  (JAX on the CPU before anything runs)

import jax.numpy as jnp
import numpy as np
import torch

from tests import test_torch_eskf as E
from tests import test_torch_frame as F
from tests import test_torch_knn_plane as K
from tests import test_torch_lie as L
from tests import test_torch_lio as I
from tests import test_torch_measurements as M
from tests import test_torch_odometry as O
from tests import test_torch_pipeline as P
from tests import test_torch_plane_fit as PF
from tests import test_torch_voxel_map as V

ROWS = []


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
    from sr_livo_tpu_torch import convert
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
        wire.append((tmeas.prepare_sweep_wire(a, cur, tcfg)[1].pts_q,
                     jmeas.pack_sweep(jp, b.duration).pts_q))
        cur = tp.new_current_time
    row("measurements.prepare_sweep", prep)
    row("measurements.prepare_sweep_wire (int16 wire)", wire)
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
    jp = P.jrun(P.JPipe(P._small_cfg()), jsim)
    tp = P.trun(P.TPipe(P._port_cfg(), device="cpu"), tsim)
    tt, tpos, _ = tp.trajectory()
    jt, jpos, _ = jp.trajectory()
    ate_t = P.tum.ate_rmse(tt, tpos, tsim.gt_times, tsim.gt_pos, align=True)
    ate_j = P.tum.ate_rmse(jt, jpos, jsim.gt_times, jsim.gt_pos, align=True)
    gap = np.linalg.norm(tpos - jpos, axis=1).max()
    n_res = sum(a.num_residuals != b.num_residuals
                for a, b in zip(tp.records, jp.records))
    row(f"pipeline.LivoPipeline trajectory, {len(tt)} frames (max position "
        f"gap {gap:.3e} m; ATE port {ate_t:.6f} m, JAX {ate_j:.6f} m; "
        f"residual counts differ on {n_res} frames)", [(tpos, jpos)])


def main():
    for fn in (lie_rows, eskf_rows, frame_rows, voxel_map_rows, host_rows,
               plane_rows, knn_plane_rows, lio_rows, odometry_rows,
               pipeline_rows):
        fn()
    print("| function | max abs error | bit-exact |")
    print("| --- | --- | --- |")
    for name, err, exact in ROWS:
        print(f"| {name} | {err:.3e} | {'yes' if exact else 'no'} |")


if __name__ == "__main__":
    main()
