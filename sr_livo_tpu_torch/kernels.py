"""Build and load the port's native libraries.

A CUDA source `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into a
shared library with a plain C interface, in `build/kernels/`; a host C++
source `csrc/<name>.cpp` (the ingest library) by `g++`, in
`build/native/`.  Both are loaded with ctypes.  The build runs at first
use, from the sources in the checkout, under `build/` at the repository
root (listed in .gitignore); the library name carries a digest of the
source and flags, so an edited source is rebuilt.  Nothing is built or
imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
BUILD_DIR = BUILD_ROOT / "kernels"
NATIVE_DIR = BUILD_ROOT / "native"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _source(name: str) -> Tuple[Path, Path, List[str]]:
    """(source, build directory, flags) of `csrc/<name>.cu` or `.cpp`."""
    cu, cpp = CSRC / f"{name}.cu", CSRC / f"{name}.cpp"
    if cu.exists():
        return cu, BUILD_DIR, NVCC_FLAGS
    if cpp.exists():
        return cpp, NATIVE_DIR, GXX_FLAGS
    raise FileNotFoundError(f"no source csrc/{name}.cu or csrc/{name}.cpp")


def library_path(name: str) -> Path:
    src, out_dir, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return out_dir / f"lib{name}-{digest}.so"


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` (nvcc) or `csrc/<name>.cpp` (g++) unless it
    is built already; return the compiler's log ("" when nothing was
    built).  Raises with the log if the compiler fails."""
    out = library_path(name)
    if out.exists():
        return ""
    src, out_dir, flags = _source(name)
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if src.suffix == ".cu":
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
    else:
        cmd = ["g++", *flags, "-o", str(tmp), str(src), "-ldl"]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"library build failed: {cmd[0]} exited "
                           f"{proc.returncode} on {src.name}\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` or `.cpp`, built at first
    use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
