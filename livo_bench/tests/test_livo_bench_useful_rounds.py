"""CPU tests of the readers of the port's own device counts and ranges,
`iekf.useful_round_pct` and `vision.lk_ms`: their arithmetic on a
hand-made program state, nothing where the program has no such count or
log or no traced window ran, and a tiny traced run of the harness, whose
eager CPU loop stops at the flag, so every round it runs does work, and
whose CPU programs hold no ranges.

    python -m pytest -q livo_bench/tests
"""

import math
import sys
import types

import pytest
import torch

from livo_bench import harness, run
from livo_bench.tests import tiny

NAME = "iekf.useful_round_pct"
LK = "vision.lk_ms"
LIO = "sr_livo_tpu_torch.models.lio"
GRAPHS = "sr_livo_tpu_torch.utils.graphs"


def reader(name=NAME):
    return harness.load_readers([name])[name]


def traced():
    return harness.Traced(timer_calls=[(0, "lio_step", 0.01)])


def count(active, added):
    return types.SimpleNamespace(read=lambda: active, added=lambda: added)


def test_reader_arithmetic(monkeypatch):
    monkeypatch.setitem(sys.modules, LIO, types.SimpleNamespace(
        counts={"updates": 5, "iterations": 60}, active_rounds=count(10, 40)))
    assert reader().read(traced()) == pytest.approx(25.0)
    # no traced window in this process: nothing to read
    assert reader().read(harness.Traced()) is None


@pytest.mark.parametrize("lio", [
    None,                                                   # not loaded
    types.SimpleNamespace(counts={"iterations": 40}),       # no count
    types.SimpleNamespace(counts={"iterations": 40},        # no round
                          active_rounds=count(0, 0))])
def test_reader_finds_nothing(monkeypatch, lio):
    if lio is None:
        monkeypatch.delitem(sys.modules, LIO, raising=False)
    else:
        monkeypatch.setitem(sys.modules, LIO, lio)
    assert reader().read(traced()) is None


def lk_log():
    """Two warm-up replays, then the window's three, with a step program's
    replays between them."""
    step = ("lio_step[steady]", {"predict": 0.5, "iekf": 9.0})
    return [("vision_frame[remapped=True]", {"preprocess": 1.0, "lk": 9.0}),
            ("vision_frame[remapped=True]", {"preprocess": 1.0, "lk": 8.0}),
            step,
            ("vision_frame[remapped=True]", {"preprocess": 1.0, "lk": 4.0}),
            step,
            ("vision_frame[remapped=False]", {"preprocess": 0.7, "lk": 5.0}),
            ("vision_frame[remapped=True]", {"preprocess": 1.0, "lk": 3.0})]


def window_calls(n_replays):
    calls = [(-1, "replay", 0.01), (-1, "replay", 0.01)]   # warm-up
    for i in range(n_replays):
        calls += [(i, "lio_step", 0.01), (i, "noise", 0.001),
                  (i, "replay", 0.01)]
    return calls


def test_lk_reader_takes_the_window_replays(monkeypatch):
    monkeypatch.setitem(sys.modules, GRAPHS, types.SimpleNamespace(
        stage_log=lambda: lk_log()))
    got = reader(LK).read(harness.Traced(timer_calls=window_calls(3)))
    assert got == pytest.approx((4.0 + 5.0 + 3.0) / 3)
    # a window longer than the log: every replay logged
    got = reader(LK).read(harness.Traced(timer_calls=window_calls(9)))
    assert got == pytest.approx((9.0 + 8.0 + 4.0 + 5.0 + 3.0) / 5)


@pytest.mark.parametrize("graphs,calls", [
    (None, window_calls(3)),                                  # not loaded
    (types.SimpleNamespace(), window_calls(3)),               # no log
    (types.SimpleNamespace(stage_log=lambda: []), window_calls(3)),  # CPU
    (types.SimpleNamespace(stage_log=lk_log), []),            # untraced
    (types.SimpleNamespace(stage_log=lk_log),                 # no replay
     [(0, "lio_step", 0.01), (0, "vision_frame", 0.01)])])
def test_lk_reader_finds_nothing(monkeypatch, graphs, calls):
    if graphs is None:
        monkeypatch.delitem(sys.modules, GRAPHS, raising=False)
    else:
        monkeypatch.setitem(sys.modules, GRAPHS, graphs)
    assert reader(LK).read(harness.Traced(timer_calls=calls)) is None


def test_tiny_traced_run_reads_every_round_useful(monkeypatch):
    # the count from zero, as in a benchmark process of its own
    from sr_livo_tpu_torch.models import lio
    from sr_livo_tpu_torch.utils import graphs
    monkeypatch.setattr(lio, "active_rounds", graphs.DeviceCount())
    torch.set_num_threads(4)
    out = harness.run("r3live_odom.livo", 2 ** 31 + 5, 6.0, True,
                      device="cpu", spec=tiny.spec())
    line = run.result_line("r3live_odom.livo", True, 6.0, out, "cpu")
    value = line["metrics"][NAME]["value"]
    assert math.isfinite(value) and value == pytest.approx(100.0)
    assert lio.active_rounds.added() > 0
    # the CPU's programs run directly and hold no device ranges
    assert LK not in line["metrics"]
    assert line["correct"]
