"""The port's mesh collectives (sr_livo_tpu_torch.parallel.mesh) and
multi-host helpers (parallel.distributed) on 4 gloo ranks of the CPU
(tests/torch_shard_worker.py), laid out as 2 hosts of 2 local ranks
(LOCAL_WORLD_SIZE=2): psum, all_gather and all_to_all against numpy, the
(host, map) mesh and its axis groups, and the keyframe split of each host
against the JAX package's `shard_keyframes_by_host`.  A world of one needs
no process group."""
import types

import numpy as np
import pytest
import torch

from sr_livo_tpu.parallel import distributed as jdist
from sr_livo_tpu_torch.parallel import distributed as tdist
from sr_livo_tpu_torch.parallel.mesh import MAP_AXIS, Mesh, make_mesh
from tests.torch_shard_worker import run_ranks

N = 4
LOCAL = 2
N_KEYFRAMES = 11
RNG = np.random.RandomState(5)
X = RNG.randn(N, 3, 2).astype(np.float32)
I = RNG.randint(-1000, 1000, (N, 5)).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("distributed", N, tmp_path_factory.mktemp("dist"),
                     [dict(x=X, i=I, n_keyframes=N_KEYFRAMES)] * N,
                     env={"LOCAL_WORLD_SIZE": str(LOCAL)})


@pytest.mark.parametrize("rank", range(N))
def test_psum_and_all_gather(ranks, rank):
    out = ranks[rank]
    assert (out["rank"], out["size"]) == (rank, N)
    np.testing.assert_allclose(out["psum_f32"], X.sum(0), rtol=1e-6)
    np.testing.assert_array_equal(out["psum_i32"], I.sum(0))
    np.testing.assert_array_equal(out["all_gather"], X)


def test_psum_is_the_same_bits_on_every_rank(ranks):
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["psum_f32"], ranks[0]["psum_f32"])


@pytest.mark.parametrize("rank", range(N))
def test_all_to_all_sends_chunk_j_to_rank_j(ranks, rank):
    """Rank s sends chunk j = X[s][:1] + 10 j to rank j; rank r receives
    X[s][:1] + 10 r from every s, in source order."""
    want = X[:, :1, :] + 10.0 * rank
    np.testing.assert_array_equal(ranks[rank]["all_to_all"], want)


@pytest.mark.parametrize("rank", range(N))
def test_host_map_mesh(ranks, rank):
    out = ranks[rank]
    host, local = divmod(rank, LOCAL)
    assert out["shape"] == {"host": N // LOCAL, "map": LOCAL}
    assert out["host_index"] == host and out["map_rank"] == local
    # psum over the map axis sums the ranks of my host, over the host
    # axis the ranks with my local index
    assert out["map_sum"] == sum(host * LOCAL + j for j in range(LOCAL))
    assert out["host_sum"] == sum(h * LOCAL + local
                                  for h in range(N // LOCAL))


@pytest.mark.parametrize("rank", range(N))
def test_shard_keyframes_by_host_matches_jax(ranks, rank, monkeypatch):
    host = rank // LOCAL
    monkeypatch.setattr(jdist.jax, "process_index", lambda: host)
    fake = types.SimpleNamespace(shape={"host": N // LOCAL, "map": LOCAL})
    assert tuple(ranks[rank]["keyframes"]) == jdist.shard_keyframes_by_host(
        N_KEYFRAMES, fake)


@pytest.mark.parametrize("n_keyframes,n_hosts", [(10, 2), (7, 3), (2, 4),
                                                 (0, 2)])
def test_keyframe_split_covers_the_window(n_keyframes, n_hosts, monkeypatch):
    spans = []
    for h in range(n_hosts):
        one = Mesh(0, 1, "cpu")
        mesh = tdist.HostMapMesh(Mesh(h, 1, "cpu"), one)
        mesh.shape = {"host": n_hosts, "map": 1}
        spans.append(tdist.shard_keyframes_by_host(n_keyframes, mesh))
        monkeypatch.setattr(jdist.jax, "process_index", lambda h=h: h)
        assert spans[-1] == jdist.shard_keyframes_by_host(
            n_keyframes, types.SimpleNamespace(shape={"host": n_hosts}))
    covered = [k for lo, hi in spans for k in range(lo, hi)]
    assert covered == list(range(n_keyframes))


def test_world_of_one_needs_no_process_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    assert mesh.axis == MAP_AXIS
    x = torch.arange(6.0).reshape(1, 2, 3)
    assert mesh.psum(x) is x and mesh.all_to_all(x) is x
    assert torch.equal(mesh.all_gather(x[0]), x)
    with pytest.raises(TypeError):
        mesh.psum(torch.ones(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        make_mesh(4, device="cpu")
    with pytest.raises(ValueError):
        mesh.all_to_all(torch.zeros(2, 3))
    hm = tdist.make_host_map_mesh(device="cpu")
    assert hm.shape == {"host": 1, "map": 1}
    assert tdist.shard_keyframes_by_host(5, hm) == (0, 5)
    tdist.initialize_distributed(num_processes=1)     # a no-op
    assert not torch.distributed.is_initialized()
