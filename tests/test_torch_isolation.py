"""The port stands alone: `sr_livo_tpu_torch` and `chip_smoke.py` import
neither JAX nor anything of the JAX package, and `chip_smoke.py` fails
(printing no result) where there is no GPU or no port beside it."""
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


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG_DIR):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert "sr_livo_tpu_torch.pipeline" in mods and len(mods) >= 20
    code = "\n".join([
        "import sys, importlib",
        "sys.modules['jax'] = None",
        "sys.modules['jaxlib'] = None",
        "sys.modules['sr_livo_tpu'] = None",
        f"sys.path.insert(0, {REPO!r})",
        f"for m in {mods!r} + ['chip_smoke']:",
        "    importlib.import_module(m)",
        "assert not any(k == 'jax' or k.startswith(('jax.', 'sr_livo_tpu.'))",
        "               for k, v in sys.modules.items() if v is not None)",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_has_no_jax_import(path):
    with open(path) as f:
        src = f.read()
    for pat in FORBIDDEN:
        hit = pat.search(src)
        assert hit is None, f"{path}: {hit.group(0).strip()!r}"


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
