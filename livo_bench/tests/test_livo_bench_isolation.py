"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port.  Top-level module names are compared
whole: the port's name, sr_livo_tpu_torch, begins with the JAX package's.
Each case imports in a fresh interpreter."""

import json
import os
import subprocess
import sys

import pytest

from livo_bench import harness

FORBIDDEN = ["jax", "jaxlib", "flax", "sr_livo_tpu"]

HARNESS = ["livo_bench.run", "livo_bench.harness", "livo_bench.control",
           "livo_bench.gen.traffic", "livo_bench.gen.synthetic",
           "livo_bench.gen.roofline", "livo_bench.gen.profile",
           "livo_bench.gen.ate", "livo_bench.check", "livo_bench.snapshot",
           "sr_livo_tpu_torch.pipeline", "sr_livo_tpu_torch.models.vision"]
REFERENCE = ["livo_bench.ref." + m for m in (
    "pipeline", "models.vision", "ops.plane_fit",
    "runtime.measurements")] + ["livo_bench.check", "livo_bench.snapshot",
                                "livo_bench.gen.ate",
                                "livo_bench.gen.roofline"]


def top_levels(modules):
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    assert not top_levels(HARNESS) & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    names = top_levels(REFERENCE)
    assert not names & set(FORBIDDEN + ["sr_livo_tpu_torch"])


@pytest.mark.parametrize("name,bad", [("sr_livo_tpu_torch.ops", False),
                                      ("sr_livo_tpu.ops", True),
                                      ("jaxlib", True), ("jax_utils", False)])
def test_forbidden_check_compares_whole_names(name, bad, monkeypatch):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in harness.forbidden_modules()) == bad
