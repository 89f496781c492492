"""The r3live profile's bag replayed through both packages' replay_bag
with `retry_wider_neighborhood` on: chip_smoke.py's phase `replay` (its
world, trajectory, Livox cone and configuration) on the CPU, cut to 7 s
(the 4.5 s still start and 2.5 s of motion) and with 8 x 8 black images
that carry only their stamps.

The profile re-runs a weak IEKF solve (a failed one, or one on fewer than
`min_num_residuals` rows) over the widened neighbourhood.  On every frame
of the JAX replay the port's step, given the same state, map and sweep
(tests/lockstep.py), must run the same updates: the same neighbourhood,
success flag and residual count for the first solve and for the re-run.
The two closed-loop replays must register and re-run the same frames and
stay below the gate's ATE bound of 0.08 m.
"""
import dataclasses

import numpy as np
import pytest

import chip_smoke
from sr_livo_tpu import config as jconfig
from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu.runtime import drivers as jdrivers
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.runtime import drivers, tum
from tests.lockstep import Lockstep, port_updates
from tests.test_torch_pipeline import _copy_cfg
from tests.torch_threads import one_intraop_thread  # noqa: F401

DURATION, SEED = 7.0, 11


def replay_both(path: str, duration: float):
    """Writes the bag to `path` and replays it through both packages.
    Returns (sim, JAX pipeline, port pipeline, the lockstep frames of the
    JAX replay, the port replay's updates per step)."""
    sim = chip_smoke.r3live_bag(path, duration, SEED, device="cpu",
                                images=False)[0]
    tcfg = chip_smoke.r3live_cfg()
    jcfg = _copy_cfg(jconfig.LivoConfig(), tcfg)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    with Lockstep(tcfg) as lockstep:
        jp = JPipe(jcfg)
        jdrivers.replay_bag(jp, path, jcfg, *chip_smoke.R3_TOPICS,
                            image_type="RGB8")
    with port_updates() as steps:
        tp = TPipe(tcfg, device="cpu")
        drivers.replay_bag(tp, path, tcfg, *chip_smoke.R3_TOPICS,
                           image_type=drivers.IMAGE_TYPE_RGB8)
    return sim, jp, tp, lockstep.frames, steps


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    return replay_both(str(tmp_path_factory.mktemp("bag") / "r3live.bag"),
                       DURATION)


def test_r3live_steps_retry_like_jax(replays):
    _sim, jp, _tp, frames, _steps = replays
    assert len(frames) == len(jp.records) > 30
    assert [f.port_updates for f in frames] == [f.jax_updates
                                                for f in frames]
    assert [f.port for f in frames] == [f.jax for f in frames]
    assert max(f.position_gap for f in frames) < 1e-6
    assert sum(len(f.jax_updates) == 2 for f in frames) >= 10


def test_r3live_replay_retries_like_jax(replays):
    sim, jp, tp, frames, steps = replays
    assert len(tp.records) == len(jp.records) == len(steps)
    assert [r.success for r in tp.records] == [r.success for r in jp.records]
    assert [len(u) for u in steps] == [len(f.jax_updates) for f in frames]
    for pipe in (tp, jp):
        ts, ps, _ = pipe.trajectory()
        ate = tum.ate_rmse(ts, ps, sim.gt_times, sim.gt_pos, align=True)
        assert ate < chip_smoke.REPLAY_MAX_ATE, f"ATE {ate:.4f} m"
    assert np.all(np.isfinite(tp.trajectory()[1]))
