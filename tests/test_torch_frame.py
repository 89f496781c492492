"""Parity of the port's frame ops (sr_livo_tpu_torch.ops.frame) with the
JAX package's: integer paths (voxel keys, winner masks, output order)
bit for bit, de-skew transforms to float32 round-off (atol 1e-4 m on
points within 10 m, a few ulps of their magnitude)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_livo_tpu.models import eskf as jeskf
from sr_livo_tpu.ops import frame as jframe
from sr_livo_tpu.utils import lie as jlie
from sr_livo_tpu_torch.models.eskf import ImuStates
from sr_livo_tpu_torch.ops import frame as tframe

RNG = np.random.RandomState(5)


def _cloud(n=3000, spread=4.0, offset=(0.0, 0.0, 0.0)):
    """Points around the origin (negative coordinates included), dense
    enough that most voxels hold several points."""
    return (RNG.uniform(-spread, spread, (n, 3)) + offset).astype(np.float32)


def _far_cloud(n=2000):
    """Coordinates whose voxel hash overflows int32 many times over."""
    base = RNG.uniform(-2.0e4, 2.0e4, (n // 4, 3))
    return (np.repeat(base, 4, axis=0)
            + RNG.uniform(-0.3, 0.3, (n, 3))).astype(np.float32)


@pytest.mark.parametrize("cloud", ["near", "far"])
def test_voxel_key_bit_exact(cloud):
    pts = _cloud() if cloud == "near" else _far_cloud()
    j = np.asarray(jframe._voxel_key(jnp.asarray(pts), 0.2))
    t = tframe._voxel_key(torch.as_tensor(pts), 0.2).numpy()
    assert t.dtype == np.int32
    np.testing.assert_array_equal(t, j)


def test_bucket_dedup_min_bit_exact():
    h = RNG.randint(0, 300, 4000).astype(np.int32)
    pri = RNG.permutation(4000).astype(np.int32)
    valid = RNG.rand(4000) < 0.8
    j = np.asarray(jframe.bucket_dedup_min(jnp.asarray(h), jnp.asarray(pri),
                                           jnp.asarray(valid)))
    t = tframe.bucket_dedup_min(torch.as_tensor(h), torch.as_tensor(pri),
                                torch.as_tensor(valid)).numpy()
    np.testing.assert_array_equal(t, j)
    # exactly one winner per distinct valid key, at its minimum priority
    for key in np.unique(h[valid])[:50]:
        rows = np.nonzero(valid & (h == key))[0]
        assert t[rows].sum() == 1 and pri[rows][t[rows]][0] == pri[rows].min()


def test_subsample_perm_matches_jax():
    np.testing.assert_array_equal(tframe.subsample_perm(1000),
                                  jframe.subsample_perm(1000))


@pytest.mark.parametrize("cloud,priority,max_out", [
    ("near", False, 4096), ("near", True, 4096), ("near", True, 300),
    ("far", False, 4096), ("far", True, 256)])
def test_voxel_subsample_bit_exact(cloud, priority, max_out):
    pts = _cloud() if cloud == "near" else _far_cloud()
    n = pts.shape[0]
    valid = RNG.rand(n) < 0.9
    payload = np.arange(n, dtype=np.int32)
    pri = tframe.subsample_perm(n) if priority else None
    jp, jv, (jpay,) = jframe.voxel_subsample(
        jnp.asarray(pts), jnp.asarray(valid), 0.5, max_out,
        payload=(jnp.asarray(payload),), priority=pri)
    tp, tv, (tpay,) = tframe.voxel_subsample(
        torch.as_tensor(pts), torch.as_tensor(valid), 0.5, max_out,
        payload=(torch.as_tensor(payload),),
        priority=None if pri is None else torch.as_tensor(pri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tpay.numpy(), np.asarray(jpay))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert 0 < tv.sum() <= max_out


def _imu_states():
    """A JAX sweep trajectory (predict_sweep over 20 samples, 4 padding)
    with the pre-sweep state prepended, and its port twin."""
    st = jeskf.init_state()._replace(
        v=jnp.asarray([1.0, -0.4, 0.1], jnp.float32),
        q=jlie.exp_so3_quat(jnp.asarray([0.1, -0.2, 0.3], jnp.float32)))
    S = 24
    dts = np.full(S, 0.005, np.float32)
    accs = (np.array([0.3, -0.2, 9.81]) + RNG.randn(S, 3) * 0.3).astype(
        np.float32)
    gyrs = (np.array([0.2, -0.1, 0.8]) + RNG.randn(S, 3) * 0.05).astype(
        np.float32)
    valid = np.arange(S) < 20
    _, tr = jeskf.predict_sweep(
        st, jnp.ones(12, jnp.float32) * 0.1, jnp.asarray(np.cumsum(dts)),
        jnp.asarray(dts), jnp.asarray(accs), jnp.asarray(gyrs),
        jnp.asarray(valid))
    pre = lambda x0, xs: np.concatenate([np.asarray(x0)[None],
                                         np.asarray(xs)])
    arrays = dict(t=pre(0.0, tr.t).astype(np.float32),
                  un_acc=pre(np.zeros(3, np.float32), tr.un_acc),
                  un_gyr=pre(np.zeros(3, np.float32), tr.un_gyr),
                  p=pre(st.p, tr.p), q=pre(st.q, tr.q), v=pre(st.v, tr.v),
                  valid=pre(True, tr.valid))
    j = jeskf.ImuStates(**{k: jnp.asarray(v) for k, v in arrays.items()})
    t = ImuStates(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    return j, t


def _extrinsics():
    r_il = np.array(jlie.exp_so3(jnp.asarray([0.05, -0.1, 0.2],
                                               jnp.float32)))
    return r_il, np.array([0.1, 0.05, -0.08], np.float32)


@pytest.mark.parametrize("fn", ["undistort_imu", "undistort_constant"])
def test_undistort_and_end_frame_match_jax(fn):
    j_states, t_states = _imu_states()
    r_il, t_il = _extrinsics()
    raw = _cloud(2000, spread=8.0)
    t_rel = RNG.uniform(0.0, 0.1, 2000).astype(np.float32)
    jw = getattr(jframe, fn)(jnp.asarray(raw), jnp.asarray(t_rel), j_states,
                             jnp.asarray(r_il), jnp.asarray(t_il))
    tw = getattr(tframe, fn)(torch.as_tensor(raw), torch.as_tensor(t_rel),
                             t_states, torch.as_tensor(r_il),
                             torch.as_tensor(t_il))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-4, rtol=0)
    je = jframe.to_end_frame(jw, j_states, jnp.asarray(r_il),
                             jnp.asarray(t_il))
    te = tframe.to_end_frame(tw, t_states, torch.as_tensor(r_il),
                             torch.as_tensor(t_il))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-4, rtol=0)


def test_transform_to_world_matches_jax():
    r_il, t_il = _extrinsics()
    raw = _cloud(1000, spread=8.0)
    q = np.array(jlie.exp_so3_quat(jnp.asarray([0.3, 0.2, -0.5],
                                                 jnp.float32)))
    p = np.array([1.0, -2.0, 0.5], np.float32)
    j = jframe.transform_to_world(jnp.asarray(raw), jnp.asarray(q),
                                  jnp.asarray(p), jnp.asarray(r_il),
                                  jnp.asarray(t_il))
    t = tframe.transform_to_world(*(torch.as_tensor(a)
                                    for a in (raw, q, p, r_il, t_il)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=0)
