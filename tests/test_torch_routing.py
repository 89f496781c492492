"""Parity of the port's routing primitives (sr_livo_tpu_torch.parallel.
routing, `shard_of` and `compute_budgets`) with the JAX package's, bit for
bit: the budgets, the int32 bit-reinterpreted columns, the owner hashes
(int32 wraparound and logical shifts, on negative and extreme inputs),
the per-destination send buffers with their drop counts (normal and
starved budgets), the stable compaction, and one all-to-all exchange
over 4 gloo ranks against JAX's shard_map on 4 devices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sr_livo_tpu.config import LivoConfig as JaxConfig
from sr_livo_tpu.parallel import mesh as jmesh
from sr_livo_tpu.parallel import routing as jr
from sr_livo_tpu.parallel import sharded_lio as jsl
from sr_livo_tpu_torch.config import LivoConfig
from sr_livo_tpu_torch.parallel import routing as tr
from sr_livo_tpu_torch.parallel import sharded_lio as tsl
from tests.torch_shard_worker import run_ranks

RNG = np.random.RandomState(11)
I32 = np.iinfo(np.int32)


def _eq(port, jax_out):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(jax_out))


@pytest.mark.parametrize("x", [0, 1, 7.2, 8, 9, 100.5, 4095, 1e5])
@pytest.mark.parametrize("m", [8, 32])
def test_rup_and_headroom(x, m):
    assert tr.rup(x, m) == jr.rup(x, m)
    assert tr.headroom(x) == jr.headroom(x)
    assert tr.headroom(x, 4.0, 16) == jr.headroom(x, 4.0, 16)


def test_pack_cols_roundtrip_bit_exact():
    pts = RNG.randn(64, 3).astype(np.float32)
    h = RNG.randint(I32.min, I32.max, 64, dtype=np.int64).astype(np.int32)
    h[:4] = [I32.min, I32.max, -1, 0]      # -0.0 and NaN bit patterns
    idx = np.arange(64, dtype=np.int32)
    port = tr.pack_cols(torch.as_tensor(pts), torch.as_tensor(h),
                        torch.as_tensor(idx))
    ref = jr.pack_cols(jnp.asarray(pts), jnp.asarray(h), jnp.asarray(idx))
    np.testing.assert_array_equal(port.numpy().view(np.int32),
                                  np.asarray(ref).view(np.int32))
    for j, col in ((3, h), (4, idx)):
        _eq(tr.unpack_col_i32(port, j), col)
        _eq(tr.unpack_col_i32(port, j), jr.unpack_col_i32(ref, j))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_hash_range_owner_bit_exact(n):
    h = RNG.randint(I32.min, I32.max, 4000, dtype=np.int64).astype(np.int32)
    h[:6] = [I32.min, I32.max, -1, 0, 1, 1 << 16]
    _eq(tr.hash_range_owner(torch.as_tensor(h), n),
        jr.hash_range_owner(jnp.asarray(h), n))


@pytest.mark.parametrize("n,bits", [(1, 4), (2, 4), (4, 4), (8, 4), (4, 2)])
def test_shard_of_bit_exact(n, bits):
    c = RNG.randint(-3000, 3000, (2000, 3)).astype(np.int32)
    big = RNG.randint(I32.min, I32.max, (500, 3), dtype=np.int64)
    coords = np.concatenate([c, big.astype(np.int32),
                             np.array([[I32.min] * 3, [I32.max] * 3,
                                       [-1, -1, -1]], np.int32)])
    _eq(tsl.shard_of(torch.as_tensor(coords), n, bits),
        jsl.shard_of(jnp.asarray(coords), n, bits))
    # the 8-corner layout of the engine's replay leg
    cv = coords[:100, None, :] + np.array([[2, -2, 2]], np.int32)
    _eq(tsl.shard_of(torch.as_tensor(cv), n, bits),
        jsl.shard_of(jnp.asarray(cv), n, bits))


@pytest.mark.parametrize("n,budget", [(4, 64), (4, 5), (8, 16), (1, 300)])
def test_pack_for_exchange_bit_exact(n, budget):
    """Normal and starved budgets: buffer, validity and dropped count."""
    m = 300
    dest = RNG.randint(-1, n + 1, m).astype(np.int32)      # clipped ends
    valid = RNG.rand(m) < 0.8
    rows = tr.pack_cols(torch.as_tensor(RNG.randn(m, 3).astype(np.float32)),
                        torch.arange(m, dtype=torch.int32))
    port = tr.pack_for_exchange(torch.as_tensor(dest), torch.as_tensor(valid),
                                rows, n, budget)
    ref = jr.pack_for_exchange(jnp.asarray(dest), jnp.asarray(valid),
                               jnp.asarray(rows.numpy()), n, budget)
    np.testing.assert_array_equal(port[0].numpy().view(np.int32),
                                  np.asarray(ref[0]).view(np.int32))
    _eq(port[1], ref[1])
    assert int(port[2]) == int(ref[2])
    if budget < m // n // 2:
        assert int(port[2]) > 0


@pytest.mark.parametrize("out_size", [10, 150, 400])
def test_compact_bit_exact(out_size):
    rows = RNG.randn(300, 4).astype(np.float32)
    valid = RNG.rand(300) < 0.6
    port = tr.compact(torch.as_tensor(rows), torch.as_tensor(valid), out_size)
    ref = jr.compact(jnp.asarray(rows), jnp.asarray(valid), out_size)
    for a, b in zip(port, ref):
        _eq(a, b)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("bench", [False, True])
def test_compute_budgets_match_jax(n, bench):
    """The test configuration of tests/test_sharded_lio.py and bench.py's
    LIO shapes (1024 keypoints, 8192 frame points, 2^18 slots)."""
    cfgs = []
    for cls in (LivoConfig, JaxConfig):
        cfg = cls()
        sh = cfg.shapes
        if bench:
            sh.max_sweep_points, sh.max_frame_points = 16384, 8192
            sh.max_keypoints, sh.map_capacity = 1024, 1 << 18
        else:
            sh.max_sweep_points, sh.max_frame_points = 2048, 2048
            sh.max_keypoints, sh.map_capacity = 512, 1 << 15
        cfgs.append(cfg)
    assert tsl.compute_budgets(cfgs[0], n) == jsl.compute_budgets(cfgs[1], n)


@pytest.fixture(scope="module")
def exchanged(tmp_path_factory):
    """Rows tagged (source rank, index) sent to random owners with a
    budget that drops some, on 4 gloo ranks and on JAX's 4-device mesh."""
    n, m, budget = 4, 64, 16
    dest = RNG.randint(0, n, (n, m)).astype(np.int32)
    valid = RNG.rand(n, m) < 0.9
    outs = run_ranks("routing", n, tmp_path_factory.mktemp("routing"),
                     [dict(dest=dest[r], valid=valid[r], budget=budget)
                      for r in range(n)])

    def body(d, v):
        d, v = d[0], v[0]
        me = jax.lax.axis_index("map")
        payload = me * np.int32(1000) + jnp.arange(m, dtype=jnp.int32)
        buf, bval, dropped = jr.pack_for_exchange(
            d, v, jr.pack_cols(payload), n, budget)
        rcv, rval = jr.exchange(buf, bval, "map")
        got = jnp.where(rval, jr.unpack_col_i32(rcv, 0), -1)
        return got[None], jax.lax.psum(dropped, "map")[None]

    fn = jax.jit(shard_map(body, mesh=jmesh.make_mesh(n),
                           in_specs=(P("map"), P("map")),
                           out_specs=(P("map"), P("map")), check_vma=False))
    got, dropped = fn(jnp.asarray(dest), jnp.asarray(valid))
    return outs, np.asarray(got), np.asarray(dropped)


@pytest.mark.parametrize("rank", range(4))
def test_exchange_matches_jax_shard_map(exchanged, rank):
    outs, got, dropped = exchanged
    np.testing.assert_array_equal(outs[rank]["got"], got[rank])
    assert outs[rank]["dropped"] == int(dropped[rank]) > 0
