"""The check on the CPU at the tiny cell's size: a sound run of the
program comes out correct, and each fault the cell can have, planted
under the timed path, comes out not correct.  The harness's look for a
card is skipped (`harness.run` on device "cpu"); the rest of a run is
driven as on the card.  On the card the TF32 control (`gpu`) must fail
the check too.  Besides, the check's arithmetic on hand-made records.

    python -m pytest -q livo_bench/tests
"""

import math

import numpy as np
import pytest
import torch

from livo_bench import check, harness
from livo_bench.gen.ate import ate_rmse
from livo_bench.tests import tiny


def run_tiny(fault=None, device="cpu", control=False, seed=12345):
    torch.set_num_threads(4)
    return harness.run("r3live_odom.livo", seed, 6.0, False, device=device,
                       spec=tiny.spec(), fault=fault, control=control)


def state_unchanged(pipe):
    """A step that returns its state unchanged (and poses it so)."""
    from sr_livo_tpu_torch.models import odometry
    step = pipe.engine.step

    def broken(state, voxel_map, sweep, *a, **kw):
        before = state._replace(**{k: v.clone() for k, v in
                                   state._asdict().items()})
        out = step(state, voxel_map, sweep, *a, **kw)
        for buf, old in zip(out.state, before):
            buf.copy_(old)
        return out._replace(record=odometry.pack_record(out.state,
                                                        out.summary))
    pipe.engine.step = broken


def half_batch(pipe):
    """Half of each sweep's points left out before the step."""
    prepare = pipe._host_prepare_measurement

    def broken(meas, frame_index, *a, **kw):
        meas.points = meas.points[::2]
        return prepare(meas, frame_index, *a, **kw)
    pipe._host_prepare_measurement = broken


def pose_altered(pipe):
    """The answer altered where it is produced: the step's pose record
    moved by 1 cm."""
    step = pipe.engine.step

    def broken(*a, **kw):
        out = step(*a, **kw)
        rec = out.record.clone()
        rec[0] += 0.01
        return out._replace(record=rec)
    pipe.engine.step = broken


def test_sound_run_is_correct():
    out = run_tiny()
    assert out["correct"], out["numbers"]
    assert out["failed"] == 0 and out["attempted"] > 5
    assert set(out["numbers"]) == {
        "pose_m", "rot_rad", "map_rows", "map_m", "color_rows", "color_m",
        "track_px", "ate_m"}
    assert len(out["per_segment"]) == 2


def tracks_altered(pipe):
    """The vision frame's answer altered where it is produced: every
    track's pixel moved by 1 px after the frame."""
    process = pipe.vision.process_frame

    def broken(*a, **kw):
        out = process(*a, **kw)
        v = pipe.vision
        v.tracks = v.tracks._replace(px=v.tracks.px + 1.0)
        return out
    pipe.vision.process_frame = broken


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, pose_altered,
                                   tracks_altered],
                         ids=lambda f: f.__name__)
def test_fault_is_caught(fault):
    out = run_tiny(fault)
    assert not out["correct"], out["numbers"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (TF32 exists only there)")
    return "cuda"


@pytest.mark.gpu
def test_tf32_control_is_caught(card):
    out = run_tiny(device=card, control=True)
    assert out["correct"], out["numbers"]
    assert not check.judge(out["control"], out["limits"]), out["control"]


class _Rec:
    def __init__(self, t, p, q=(1.0, 0.0, 0.0, 0.0)):
        self.time, self.position, self.quat_wxyz = t, np.array(p), np.array(q)


def test_pose_numbers_by_hand():
    a = [None, _Rec(0.1, [0, 0, 0]), _Rec(0.2, [1, 2, 3])]
    c = math.cos(0.001 / 2), math.sin(0.001 / 2)
    b = [None, _Rec(0.1, [0, 0, 3e-4]), _Rec(0.2, [1, 2, 3],
                                             (c[0], 0.0, 0.0, c[1]))]
    n = check.pose_numbers(a, b)
    assert n["pose_m"] == pytest.approx(3e-4)
    assert n["rot_rad"] == pytest.approx(0.001, rel=1e-6)
    # posed on one side only, or a record short: infinite
    assert check.pose_numbers(a, [None, None, b[2]])["pose_m"] == math.inf
    assert check.pose_numbers(a, b[:2])["pose_m"] == math.inf
    lim = {"pose_m": 1e-3, "rot_rad": 1e-2}
    assert check.judge(n, lim) and not check.judge({"pose_m": 0.0}, lim)


def test_track_numbers_name_points_by_cell():
    """Tracks pair by slot and by the map point their registry row holds:
    a row held by one side only shifts the other's later ids, and the same
    id on another point is not the same track."""
    pts = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [7.0, 8.0, 9.0],
                        [2.0, 9.0, 4.0]])
    extra = torch.tensor([[5.0, 5.0, 5.0]])

    def registry(p):
        reg = torch.zeros((8, 16))
        reg[:len(p), 6:9] = p
        reg[:len(p), 15] = 1.0
        return reg, len(p)

    # side a holds one row more, after its first: later ids shift by one
    color_a = registry(torch.cat([pts[:1], extra, pts[1:]]))
    color_b = registry(pts)
    px_a = torch.tensor([[10.0, 10.0], [20.0, 20.0], [30.0, 30.0],
                         [40.0, 40.0]])
    px_b = px_a + torch.tensor([[0.01, 0.0], [0.0, 0.02], [300.0, 0.0],
                                [0.0, 0.0]])
    # slot 0: point 0 on both (ids 0, 0); slot 1: point 1 (ids 2, 1);
    # slot 2: id 3 on both, point 2 on a and point 3 on b; slot 3: live on
    # a alone
    tracks_a = (torch.tensor([0, 2, 3, 4], dtype=torch.int32), px_a,
                torch.tensor([True, True, True, True]))
    tracks_b = (torch.tensor([0, 1, 3, 2], dtype=torch.int32), px_b,
                torch.tensor([True, True, True, False]))
    va = {"color": color_a, "tracks": tracks_a}
    vb = {"color": color_b, "tracks": tracks_b}
    n = check.compare(([], va), ([], vb), 0.05)
    assert n["track_px"] == pytest.approx(0.02, abs=1e-5)
    # one slot's pixel moved on the same point: read
    moved = (tracks_b[0], px_b + torch.tensor([0.0, 1.0]), tracks_b[2])
    n = check.compare(([], va), ([], dict(vb, tracks=moved)), 0.05)
    assert n["track_px"] == pytest.approx(1.02, abs=1e-5)


def test_ate_by_hand():
    rng = np.random.default_rng(3)
    truth = rng.normal(size=(50, 3))
    ang = 0.7
    r = np.array([[math.cos(ang), -math.sin(ang), 0],
                  [math.sin(ang), math.cos(ang), 0], [0, 0, 1]])
    est = truth @ r.T + [1.0, -2.0, 0.5]
    # a rigid motion of the truth reads 0 after the alignment
    assert ate_rmse(est, truth) == pytest.approx(0.0, abs=1e-9)
    # an offset of 0.01 on alternate points: a shift alone leaves 0.005
    # (their spread around the mean); the best rigid motion leaves no more
    off = est.copy()
    off[::2, 0] += 0.01
    assert 0.004 < ate_rmse(off, truth) <= 0.005 + 1e-12
    recs = [_Rec(0.1 * i, p) for i, p in enumerate(est)] + [None]
    assert check.ate(recs, lambda t: truth[np.round(t / 0.1).astype(int)]) \
        == pytest.approx(0.0, abs=1e-9)
