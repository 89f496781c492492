"""Parity of the port's voxel-hash map (sr_livo_tpu_torch.ops.voxel_map)
with the JAX package's: the same insert sequence leaves `keys`, `sig`,
`counts`, `point_ids` and `points` identical bit for bit, the hashes are
bit-exact on coordinates that overflow int32, and kNN returns the same
neighbour sets, counts and distances, and on exact ties the same
neighbours in the same order as `lax.top_k` (lower index first)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.ops import voxel_map as jvm
from sr_livo_tpu_torch import convert
from sr_livo_tpu_torch.ops import voxel_map as tvm

RNG = np.random.RandomState(7)


def _assert_maps_equal(tmap, jmap):
    got = convert.voxel_map_to_numpy(tmap)
    for name in tvm.VoxelMap._fields:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jmap,
                                                                    name)),
                                      err_msg=name)


def _batches():
    """Planes (many points per voxel: capacity and min-distance bite),
    scattered points with negative coordinates, a repeat of an earlier
    batch, and far points whose hashes overflow int32."""
    u = RNG.uniform(-6, 6, (3000, 2))
    floor = np.c_[u[:, 0], u[:, 1], np.zeros(3000)]
    wall = np.c_[np.full(3000, -4.0), u[:, 0], u[:, 1] * 0.5 + 1]
    scatter = RNG.uniform(-9, 9, (1500, 3))
    far = RNG.uniform(-3e4, 3e4, (400, 3))
    return [b.astype(np.float32) for b in (floor, wall, scatter, floor[:800],
                                           far)]


@pytest.fixture(scope="module")
def maps():
    """Both packages' maps after the same insert sequence (small table so
    probe chains collide), with the accepted masks of every batch."""
    kw = dict(voxel_size=1.0, min_distance=0.05, max_probe=8)
    jm = jvm.make_map(1 << 12, 20)
    tm = tvm.make_map(1 << 12, 20)
    accepted = []
    next_id = 0
    for i, b in enumerate(_batches()):
        valid = RNG.rand(b.shape[0]) < 0.95
        ids = np.arange(next_id, next_id + b.shape[0], dtype=np.int32)
        next_id += b.shape[0]
        extra = dict(budget=1024) if i == 2 else dict(gate_chunk=512)
        jm, ja = jvm.insert(jm, jnp.asarray(b), jnp.asarray(valid),
                            point_ids=jnp.asarray(ids), **kw, **extra)
        tm, ta = tvm.insert(tm, torch.as_tensor(b), torch.as_tensor(valid),
                            point_ids=torch.as_tensor(ids), **kw, **extra)
        accepted.append((np.asarray(ja), ta.numpy()))
    return jm, tm, accepted


def test_insert_sequence_bit_exact(maps):
    jm, tm, accepted = maps
    _assert_maps_equal(tm, jm)
    for ja, ta in accepted:
        np.testing.assert_array_equal(ta, ja)
    assert int(tvm.map_size(tm)) == int(jvm.map_size(jm)) > 1000


@pytest.mark.parametrize("fn", ["voxel_hash", "voxel_sig"])
def test_hashes_bit_exact_on_overflowing_coords(fn):
    coords = np.concatenate([
        RNG.randint(-2 ** 31, 2 ** 31 - 1, (2000, 3)),
        RNG.randint(-40000, 40000, (2000, 3)),
        [[2 ** 31 - 1, -2 ** 31, 0], [-1, -1, -1]]]).astype(np.int32)
    args = (1 << 18,) if fn == "voxel_hash" else ()
    j = np.asarray(getattr(jvm, fn)(jnp.asarray(coords), *args))
    t = getattr(tvm, fn)(torch.as_tensor(coords), *args).numpy()
    np.testing.assert_array_equal(t.astype(np.int64), j.astype(np.int64))
    if fn == "voxel_sig":
        assert t.dtype == np.int32 and t.min() >= 0


def test_voxel_coords_truncate_like_jax():
    pts = RNG.uniform(-50, 50, (3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tvm.voxel_coords(torch.as_tensor(pts), 0.6).numpy(),
        np.asarray(jvm.voxel_coords(jnp.asarray(pts), 0.6)))


def test_lookup_matches_jax(maps):
    jm, tm, _ = maps
    keys = np.asarray(jm.keys)
    used = keys[keys[:, 0] != jvm.EMPTY]
    coords = np.concatenate([used[:500], used[:200] + 1,
                             RNG.randint(-20, 20, (300, 3))]).astype(np.int32)
    j = np.asarray(jvm.lookup(jm, jnp.asarray(coords), 8))
    t = tvm.lookup(tm, torch.as_tensor(coords), 8).numpy()
    np.testing.assert_array_equal(t, j)
    assert (t[:500] >= 0).all()


@pytest.mark.parametrize("nb_voxels,threshold", [(1, 1), (2, 1), (1, 5)])
def test_knn_matches_jax(maps, nb_voxels, threshold):
    jm, tm, _ = maps
    q = np.concatenate([RNG.uniform(-6, 6, (300, 3)),
                        RNG.uniform(-30, 30, (50, 3))]).astype(np.float32)
    kw = dict(voxel_size=1.0, max_neighbors=20, max_probe=8,
              nb_voxels=nb_voxels)
    jn, jok, jd = jvm.knn(jm, jnp.asarray(q), threshold_capacity=threshold,
                          **kw)
    tn, tok, td = tvm.knn(tm, torch.as_tensor(q),
                          threshold_capacity=threshold, **kw)
    jn, jok, jd = np.asarray(jn), np.asarray(jok), np.asarray(jd)
    tn, tok, td = tn.numpy(), tok.numpy(), td.numpy()
    np.testing.assert_array_equal(tok.sum(1), jok.sum(1))
    assert tok.sum() > 1000
    np.testing.assert_allclose(np.sort(np.where(tok, td, np.inf), 1),
                               np.sort(np.where(jok, jd, np.inf), 1),
                               atol=1e-6, rtol=0)
    for i in range(q.shape[0]):
        a = {tuple(p) for p in tn[i][tok[i]]}
        b = {tuple(p) for p in jn[i][jok[i]]}
        if a != b:
            # only a tie at the k-th distance may swap a neighbour
            kth = np.sort(jd[i][jok[i]])[-1]
            diff = np.array(sorted(a ^ b), np.float32)
            dd = np.linalg.norm(diff - q[i], axis=1)
            np.testing.assert_allclose(dd, kth, atol=1e-6)


def test_knn_tie_order_matches_jax():
    """Points on a quarter lattice, queries on lattice and voxel-centre
    points: every squared distance is exact in float32, so many
    candidates tie at the nearest and at the M-th distance.  The port's
    kNN must return the JAX package's neighbours in the same order
    (`lax.top_k` puts the lower flat index v*K + j first among equal
    distances), with the same counts."""
    rng = np.random.RandomState(11)
    g = np.arange(-8, 12) * 0.25                       # [-2, 2.75]
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    pts = lattice[rng.permutation(len(lattice))].astype(np.float32)
    kw = dict(voxel_size=1.0, min_distance=0.0, max_probe=8)
    jm = jvm.make_map(1 << 12, 20)
    tm = tvm.make_map(1 << 12, 20)
    ones = np.ones(len(pts), bool)
    jm, _ = jvm.insert(jm, jnp.asarray(pts), jnp.asarray(ones), **kw)
    tm, _ = tvm.insert(tm, torch.as_tensor(pts), torch.as_tensor(ones), **kw)
    _assert_maps_equal(tm, jm)
    q = np.concatenate([lattice[rng.choice(len(lattice), 60)],
                        [[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                         [-0.5, 0.5, 1.5], [0.125, 0.125, 0.125],
                         [9.0, 9.0, 9.0]]]).astype(np.float32)
    for nb_voxels, m in ((1, 20), (2, 20), (1, 7)):
        knn_kw = dict(voxel_size=1.0, max_probe=8, nb_voxels=nb_voxels,
                      threshold_capacity=1)
        jn, jok, jd = (np.asarray(a) for a in jvm.knn(
            jm, jnp.asarray(q), max_neighbors=m, **knn_kw))
        tn, tok, td = (a.numpy() for a in tvm.knn(
            tm, torch.as_tensor(q), max_neighbors=m, **knn_kw))
        np.testing.assert_array_equal(tok.sum(1), jok.sum(1))
        np.testing.assert_array_equal(tok, jok)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(td, jd)
        # the ties are there: at the nearest distance and across the M-th
        wide = np.asarray(jvm.knn(jm, jnp.asarray(q), max_neighbors=m + 8,
                                  **knn_kw)[2])
        assert (jd[:, 0] == jd[:, 1]).sum() > 15
        assert (wide[:, m - 1] == wide[:, m]).sum() > 15


def test_convert_roundtrip(maps):
    jm, tm, _ = maps
    back = convert.voxel_map_from_numpy(jm)
    _assert_maps_equal(back, jm)
    again = convert.voxel_map_from_numpy(convert.voxel_map_to_numpy(tm))
    _assert_maps_equal(again, jm)


def _gate_batch(jm):
    """Points on and off the map's surfaces, near-duplicates of stored
    points (the min-distance gate), new voxels, and validity with holes."""
    keys = np.asarray(jm.keys)
    used = keys[keys[:, 0] != jvm.EMPTY][:300].astype(np.float32)
    pts = np.concatenate([
        used + RNG.uniform(0.0, 1.0, used.shape),
        np.asarray(jm.points)[:400:2] + 0.01,
        RNG.uniform(-12, 12, (500, 3))]).astype(np.float32)
    valid = RNG.rand(len(pts)) < 0.85
    valid[-40:] = False
    return pts, valid


@pytest.mark.parametrize("gate_chunk", [0, 128, 4096])
def test_insert_gate_bit_exact(maps, gate_chunk):
    """Candidate masks, resolved slots and block counts, chunked (a
    validity pattern with holes) and whole."""
    jm, tm, _ = maps
    pts, valid = _gate_batch(jm)
    kw = dict(voxel_size=1.0, min_distance=0.05, max_probe=8,
              gate_chunk=gate_chunk)
    jg = jvm.insert_gate(jm, jnp.asarray(pts), jnp.asarray(valid), **kw,
                         with_aux=True)
    tg = tvm.insert_gate(tm, torch.as_tensor(pts), torch.as_tensor(valid),
                         **kw, with_aux=True)
    for name, t, j in zip(("gate", "slot", "blk_cnt"), tg, jg):
        np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                      np.asarray(j).astype(np.int64),
                                      err_msg=name)
    gate = tg[0].numpy()
    assert 0 < gate.sum() < valid.sum()
    mask = tvm.insert_gate(tm, torch.as_tensor(pts), torch.as_tensor(valid),
                           **kw)
    np.testing.assert_array_equal(mask.numpy(), gate)


def test_insert_with_pre_gate_bit_exact(maps):
    """insert(pre_gate=insert_gate(..., with_aux=True)) with `valid`
    narrowed (the sharded engine's insert-budget mask): the same tables
    and accepted mask as the JAX package's, and as a plain insert of the
    narrowed batch."""
    jm, tm, _ = maps
    pts, valid = _gate_batch(jm)
    kw = dict(voxel_size=1.0, min_distance=0.05, max_probe=8)
    narrowed = valid & (RNG.rand(len(pts)) < 0.7)
    jpre = jvm.insert_gate(jm, jnp.asarray(pts), jnp.asarray(valid), **kw,
                           gate_chunk=128, with_aux=True)
    jm2, ja = jvm.insert(jm, jnp.asarray(pts), jnp.asarray(narrowed), **kw,
                         pre_gate=jpre)
    tm2 = convert.voxel_map_from_numpy(convert.voxel_map_to_numpy(tm))
    tpre = tvm.insert_gate(tm2, torch.as_tensor(pts), torch.as_tensor(valid),
                           **kw, gate_chunk=128, with_aux=True)
    tm2, ta = tvm.insert(tm2, torch.as_tensor(pts),
                         torch.as_tensor(narrowed), **kw, pre_gate=tpre)
    _assert_maps_equal(tm2, jm2)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.numpy().sum() > 100
    tm3 = convert.voxel_map_from_numpy(convert.voxel_map_to_numpy(tm))
    tm3, ta3 = tvm.insert(tm3, torch.as_tensor(pts),
                          torch.as_tensor(narrowed), **kw)
    _assert_maps_equal(tm3, jm2)
    np.testing.assert_array_equal(ta3.numpy(), ta.numpy())
