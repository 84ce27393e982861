"""Build and load the package's CUDA sources at first use.

Each `csrc/<name>.cu` has a plain C interface. It is compiled by `nvcc` for
Hopper (`sm_90a`) into a shared library under `quickwit_tpu_torch/_build/`
and loaded with `ctypes`. The library's file name carries a hash of the
source and flags, so an edited source is rebuilt and a built one is reused.
`-Xptxas -v` makes ptxas report each kernel's registers, shared memory and
spills; that report is kept beside the library (`ptxas_report`). Nothing
here runs when a module is imported. A source that cannot be built, and a
kernel that fails to launch, raise `KernelError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()                    # guards the two dicts below
_NAME_LOCKS: dict[str, threading.Lock] = {}  # one build at a time per source
_LOADED: dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 when reused)
BUILD_SECONDS: dict[str, float] = {}


class KernelError(RuntimeError):
    """A kernel of this package could not be built, loaded or launched: a
    fault of the device path, which no caller may answer by rerunning the
    work another way."""


def nvcc_path() -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, else the one on PATH, else
    the one under the CUDA toolkit's default install prefix (as PyTorch's
    own extension builder assumes)."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _report_path(library: Path) -> Path:
    return library.with_suffix(".ptxas.txt")


def ptxas_report(name: str) -> str:
    """What nvcc and ptxas printed when `csrc/<name>.cu` was built: per
    kernel, its registers, shared memory, stack frame and spills."""
    return _report_path(library_path(name)).read_text()


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless this source is already built."""
    target = library_path(name)
    if target.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    _report_path(target).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, target)   # atomic: concurrent builders never see half
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return target


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use.
    Different sources build concurrently when called from several threads."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            with _LOCK:
                _LOADED[name] = lib
        return lib
