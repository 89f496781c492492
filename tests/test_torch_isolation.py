"""The port stands alone: `sr_livo_tpu_torch` and `chip_smoke.py` import
neither JAX nor anything of the JAX package, nor use the JAX package's
native library or build anything under `native/`, and `chip_smoke.py`
fails (printing no result) where there is no GPU or no port beside it.
The rank worker of the multi-device tests (tests/torch_shard_worker.py),
the card's collectives probe (tests/torch_gloo_probe.py) and the
card-only test files import no JAX either: they run in processes and on
machines without it."""
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest

import sr_livo_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.join(REPO, "sr_livo_tpu_torch")

FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+jax(lib)?\b", re.M),
    re.compile(r"^\s*from\s+sr_livo_tpu[\s.]", re.M),
    re.compile(r"^\s*import\s+sr_livo_tpu(\s|\.|$|,)", re.M),
    re.compile(r"^\s*from\s+\.\.*\s+import\s+.*\bjax\b", re.M),
]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        sr_livo_tpu_torch.__path__, "sr_livo_tpu_torch."))


# torch-only test helpers and the card-only test files
TORCH_ONLY_TESTS = sorted(
    [os.path.join(REPO, "tests", f) for f in ("torch_shard_worker.py",
                                              "torch_gloo_probe.py")]
    + [os.path.join(REPO, "tests", f)
       for f in os.listdir(os.path.join(REPO, "tests"))
       if f.startswith("test_torch_") and f.endswith("_gpu.py")])


def _sources(suffixes=(".py",)):
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG_DIR):
        out += [os.path.join(root, f) for f in files if f.endswith(suffixes)]
    return sorted(out)


# The JAX package's native library: its source and the library its loader
# builds beside it (`native/liblivo_native.so`), named as a path or joined.
NATIVE_DIR_USE = [
    re.compile(r"(?<![\w/])native[/\\]+(lib)?livo_native"),
    re.compile(r"[\"']native[\"']\s*[,/]\s*[\"'](lib)?livo_native"),
]


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert "sr_livo_tpu_torch.pipeline" in mods and len(mods) >= 20
    code = "\n".join([
        "import sys, importlib",
        "sys.modules['jax'] = None",
        "sys.modules['jaxlib'] = None",
        "sys.modules['sr_livo_tpu'] = None",
        f"sys.path.insert(0, {REPO!r})",
        f"for m in {mods!r} + ['chip_smoke', 'tests.torch_shard_worker',",
        "               'tests.torch_gloo_probe']:",
        "    importlib.import_module(m)",
        "assert not any(k == 'jax' or k.startswith(('jax.', 'sr_livo_tpu.'))",
        "               for k, v in sys.modules.items() if v is not None)",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _sources() + TORCH_ONLY_TESTS,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_has_no_jax_import(path):
    with open(path) as f:
        src = f.read()
    for pat in FORBIDDEN:
        hit = pat.search(src)
        assert hit is None, f"{path}: {hit.group(0).strip()!r}"


@pytest.mark.parametrize("path", _sources((".py", ".cpp", ".cu", ".cuh")),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_does_not_use_the_jax_native_library(path):
    """No port source names `native/livo_native` or a path under the
    repository's `native/`; the port builds its own copy into
    `build/native/`."""
    with open(path) as f:
        src = f.read()
    for pat in NATIVE_DIR_USE:
        hit = pat.search(src)
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_native_build_dir_is_under_build():
    from sr_livo_tpu_torch import kernels
    for d in (kernels.BUILD_DIR, kernels.NATIVE_DIR):
        assert os.path.relpath(d, REPO).split(os.sep)[0] == "build"
    assert kernels.NATIVE_DIR.name == "native"


def test_chip_smoke_fails_without_a_gpu():
    """On a machine without CUDA the script exits non-zero and prints no
    result line."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory without the port, the script fails."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
