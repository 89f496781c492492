"""Parity of the port's sharded windowed BA (sr_livo_tpu_torch.parallel.ba.
make_sharded_windowed_ba) and of ShardedLioEngine.compact with the JAX
package's, on 4 gloo ranks (tests/torch_shard_worker.py) against JAX's
4-device mesh.

The map is test_ba_posegraph.py's three-wall world resharded into the
ShardedLioEngine layout (block-owner sub-tables with voxel halos, as that
file's `_reshard_map_with_halos` does for 8 devices); both packages get
the same numpy tables (built with the port's insert, which
tests/test_torch_voxel_map.py holds bit for bit to the JAX package's),
the ranks through `convert`.  The window is 8 keyframes of 256 points.
The refined poses agree with JAX's to float32 round-off (the 6x6 blocks
are sums over the routed rows in another order), the overflow counts
agree in the normal and the starved case, and `compact` gives the same
tables, dropped count and map size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from sr_livo_tpu.config import LivoConfig as JaxConfig
from sr_livo_tpu.ops import voxel_map as jvm
from sr_livo_tpu.parallel import ba as jba
from sr_livo_tpu.parallel import mesh as jmesh
from sr_livo_tpu.parallel import sharded_lio as jsl
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.ops import voxel_map as tvm
from tests.test_torch_ba import _window
from tests.torch_shard_worker import run_ranks
from tests.torch_threads import one_intraop_thread  # noqa: F401

N = 4
K = 8
HALO = 2
# measured: q within 6.0e-08, t within 1.2e-07
TOL = 1e-5
BA_KW = [dict(voxel_size=1.0, min_neighbors=8, iters=3),
         dict(voxel_size=1.0, min_neighbors=8, iters=3, route_slack=0.02)]
LOCATION = np.array([2.0, 1.0, 1.0], np.float32)
MAX_DISTANCE = 6.0


def _world_and_map(rng, cap=1 << 14):
    """test_torch_ba.py's world (the same draws from `rng`): a floor and
    two walls, 27000 points, in a 2^14 x 20 map at 1.0 m voxels."""
    u = rng.uniform(-8, 8, (9000, 2))
    world = np.concatenate([
        np.c_[u[:, 0], u[:, 1], np.zeros(9000)],
        np.c_[np.full(9000, 8.0), u[:, 0], u[:, 1] * 0.25 + 1.5],
        np.c_[u[:, 0], np.full(9000, 8.0), u[:, 1] * 0.25 + 1.5],
    ]).astype(np.float32)
    m = tvm.make_map(cap, 20)
    for i in range(0, world.shape[0], 4096):
        c = torch.as_tensor(world[i:i + 4096])
        tvm.insert(m, c, torch.ones(len(c), dtype=torch.bool), 1.0, 0.05, 16)
    return world, m


def _resharded(m, n):
    """The flat map as n block-owner sub-tables of capacity/n slots with
    voxel halos: a voxel goes to every rank owning one of its 8 halo
    corners' blocks (the engine's replica rule, owners by the JAX
    package's shard_of), one batched insert per rank.  Returns the
    concatenated numpy layout."""
    cap, k = m.keys.shape[0], m.block_capacity
    pts = m.points.numpy().reshape(-1, k, 3)
    counts, keys = m.counts.numpy(), m.keys.numpy()
    occupied = np.nonzero(counts > 0)[0]
    corners = np.array([[sx, sy, sz] for sx in (-HALO, HALO)
                        for sy in (-HALO, HALO) for sz in (-HALO, HALO)],
                       np.int32)
    owners = np.asarray(jsl.shard_of(
        jnp.asarray(keys[occupied][:, None, :] + corners[None]), n))
    slot_ok = np.arange(k)[None, :] < counts[occupied][:, None]
    subs = []
    for r in range(n):
        sel = np.any(owners == r, axis=1)
        sub = tvm.make_map(cap // n, k)
        tvm.insert(sub, torch.as_tensor(pts[occupied[sel]].reshape(-1, 3)),
                   torch.as_tensor(slot_ok[sel].reshape(-1)), 1.0, 0.0, 16)
        subs.append(convert.voxel_map_to_numpy(sub))
    return {f: np.concatenate([s[f] for s in subs]) for f in subs[0]}


def _cfgs():
    out = []
    for cls in (LivoConfig, JaxConfig):
        cfg = cls()
        cfg.shapes.map_capacity = (1 << 14) // 2    # local capacity 2^12
        cfg.odometry_options.max_distance = MAX_DISTANCE
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    rng = np.random.RandomState(17)
    world, flat = _world_and_map(rng)
    window, q_odo, t_odo, q_gt, t_gt = _window(world, rng, K=K)
    layout = _resharded(flat, N)
    mesh = jmesh.make_mesh(N)
    jmap = jvm.VoxelMap(**{f: jax.device_put(
        a, NamedSharding(mesh, P("map"))) for f, a in layout.items()})
    jw = jba.KeyframeWindow(**{k: jnp.asarray(v) for k, v in window.items()})
    ref = []
    for kw in BA_KW:
        fn = jba.make_sharded_windowed_ba(mesh, K, **kw)
        q, t, ovf = fn(jmap, jw, jnp.asarray(q_odo), jnp.asarray(t_odo))
        ref.append(dict(q=np.asarray(q), t=np.asarray(t), overflow=int(ovf)))
    port_cfg, jax_cfg = _cfgs()
    eng = jsl.ShardedLioEngine(jax_cfg, mesh)
    size_before = int(eng.map_size(jmap))
    m2, dropped = eng.compact(jmap, LOCATION)
    compact = dict(dropped=int(dropped), map_size=int(eng.map_size(m2)),
                   map={f: np.asarray(v) for f, v in m2._asdict().items()},
                   map_size_before=size_before)
    inputs = [dict(map=convert.voxel_map_to_numpy(
        convert.sharded_map_from_numpy(layout, r, N)), window=window,
        q_odo=q_odo, t_odo=t_odo, ba_kwargs=BA_KW, cfg=port_cfg,
        location=LOCATION) for r in range(N)]
    ranks = run_ranks("ba", N, tmp_path_factory.mktemp("ba"), inputs)
    return dict(ranks=ranks, ref=ref, compact=compact, t_gt=t_gt,
                window=window)


@pytest.mark.parametrize("case", range(len(BA_KW)), ids=["normal", "starved"])
def test_sharded_ba_matches_jax(solved, case):
    port, ref = solved["ranks"][0]["ba"][case], solved["ref"][case]
    assert port["overflow"] == ref["overflow"]
    assert np.abs(port["q"] - ref["q"]).max() < TOL
    assert np.abs(port["t"] - ref["t"]).max() < TOL
    assert np.all(np.isfinite(port["t"])) and np.all(np.isfinite(port["q"]))
    err = np.linalg.norm(port["t"] - solved["t_gt"], axis=-1).max()
    if case == 0:
        assert port["overflow"] == 0
        assert err < 0.03            # test_ba_posegraph.py's bar
    else:
        assert port["overflow"] > 0, "budgets this small must overflow"
        err0 = np.linalg.norm(solved["window"]["t"] - solved["t_gt"],
                              axis=-1).max()
        assert err < err0 * 1.5 + 0.05


@pytest.mark.parametrize("case", range(len(BA_KW)), ids=["normal", "starved"])
def test_sharded_ba_replicated_on_every_rank(solved, case):
    first = solved["ranks"][0]["ba"][case]
    for rank in range(1, N):
        other = solved["ranks"][rank]["ba"][case]
        np.testing.assert_array_equal(first["q"], other["q"])
        np.testing.assert_array_equal(first["t"], other["t"])
        assert first["overflow"] == other["overflow"]


def test_engine_compact_matches_jax(solved):
    ref = solved["compact"]
    for r in solved["ranks"]:
        c = r["compact"]
        assert c["dropped"] == ref["dropped"]
        assert c["map_size"] == ref["map_size"]
        assert c["map_size_before"] == ref["map_size_before"]
    # it evicted something and kept something
    assert 0 < ref["map_size"] < ref["map_size_before"]
    got = convert.sharded_map_to_numpy([r["compact"]["map"]
                                        for r in solved["ranks"]])
    for f, a in ref["map"].items():
        np.testing.assert_array_equal(got[f], a, err_msg=f)
