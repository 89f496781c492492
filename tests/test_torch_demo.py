"""The port's demo CLI (python -m sr_livo_tpu_torch.runtime.demo), its
parameter dump (`LivoPipeline.record_parameters`, the JAX package's text)
and its profiling helpers (`trace_if_enabled` writes a trace only when
LIVO_TRACE_DIR is set, with the spans of the timers it is given;
`StageTimers.time_stage`)."""
import json
import os
import types

import pytest
import torch

from sr_livo_tpu import config as jconfig
from sr_livo_tpu.pipeline import LivoPipeline as JPipe
from sr_livo_tpu_torch import config as tconfig
from sr_livo_tpu_torch.pipeline import LivoPipeline as TPipe
from sr_livo_tpu_torch.runtime import demo
from sr_livo_tpu_torch.utils.profiling import StageTimers, trace_if_enabled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_FILES = ("pose.txt", "velocity.txt", "bias.txt")


def test_demo_runs_on_the_cpu_and_writes_poses(tmp_path, capsys):
    out = tmp_path / "out"
    assert demo.main(["--device", "cpu", "--duration", "6", "--out",
                      str(out)]) == 0
    for name in POSE_FILES:
        lines = (out / name).read_text().splitlines()
        assert len(lines) > 20
    report = capsys.readouterr().out
    assert "[demo] ATE RMSE =" in report and "registered=" in report


def test_demo_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        demo.main(["--device", "cuda", "--duration", "1"])


@pytest.mark.parametrize("profile", [None, "r3live.yaml", "ntu.yaml"])
def test_record_parameters_matches_jax(tmp_path, profile):
    if profile is None:
        jcfg, tcfg = jconfig.LivoConfig(), tconfig.LivoConfig()
    else:
        path = os.path.join(REPO, "configs", profile)
        jcfg, tcfg = jconfig.load_config(path), tconfig.load_config(path)
    JPipe.record_parameters(types.SimpleNamespace(cfg=jcfg),
                            str(tmp_path / "jax"))
    TPipe(tcfg, device="cpu").record_parameters(str(tmp_path / "port"))
    want = (tmp_path / "jax" / "parameter_list.txt").read_text()
    got = (tmp_path / "port" / "parameter_list.txt").read_text()
    assert got == want
    assert got.startswith("[odometry_options]\n") and "[shapes]\n" in got


def _traced(tag, timers=None):
    with trace_if_enabled(tag, timers=timers):
        with (timers or StageTimers()).frame_span(1):
            x = torch.arange(64.0).reshape(8, 8)
            return float((x @ x).sum())


def test_trace_if_enabled_writes_only_when_set(tmp_path, monkeypatch):
    monkeypatch.delenv("LIVO_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    off = StageTimers()
    assert _traced("off", off) == _traced("off")
    assert list(tmp_path.iterdir()) == [] and off.spans is None
    monkeypatch.setenv("LIVO_TRACE_DIR", str(tmp_path / "traces"))
    _traced("on")
    files = list((tmp_path / "traces" / "on").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "traceEvents" in files[0].read_text()
    # with the pipeline's timers, their spans beside the profiler's trace,
    # and spans off again after the region (unless they were on before)
    timers, on = StageTimers(), StageTimers(spans=True)
    _traced("spans", timers)
    _traced("kept", on)
    assert timers.spans is None and [s.name for s in on.spans] == ["frame"]
    files = sorted((tmp_path / "traces" / "spans").iterdir())
    assert [f.name.split("-")[0] for f in files] == ["spans", "trace"]
    assert files[0].name[5:] == files[1].name[5:]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert [(e["name"], e["tid"], e["args"]["frame"]) for e in events
            if e["ph"] == "X"] == [("frame", 0, 1)]


def test_time_stage_times_and_returns():
    timers = StageTimers()
    assert timers.time_stage("add", lambda a, b=0: a + b, 2, b=3) == 5
    timers.time_stage("add", lambda: None)
    r = timers.report()["add"]
    assert r["count"] == 2 and r["total_s"] >= 0.0
