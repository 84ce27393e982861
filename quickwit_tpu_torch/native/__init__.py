"""Native extensions: compiled on first use, with pure-Python fallbacks.

Counterpart of the JAX package's `native/`; both C++ sources are copies
of its own. The reference implements its entire indexing hot path
natively (Rust/tantivy); here the tokenize+postings-accumulation loop and
the k-way term merge are a C++ CPython extension (`fastindex.cpp`)
compiled on demand with the host's g++ into `quickwit_tpu_torch/_build/
native/`. `load_fastindex()` returns the module or None — callers must
degrade to the Python path, so a missing toolchain never breaks indexing,
only slows it. `QW_DISABLE_NATIVE=1` forces the Python path.

`load_leafbench()` builds `leafbench.cpp`, the single-threaded native CPU
leaf comparator (ctypes ABI, no Python API).

Each build compiles to a file named for its process and then renames it
into place, so processes that build at once (test workers, a node and a
script) each load a whole library.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sysconfig
import threading
from typing import Any, Optional

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_cached: Any = "unset"


def _build_dir() -> str:
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(package, "_build", "native")


def _compile(src_basename: str = "fastindex.cpp",
             extra_flags: "tuple[str, ...]" = (),
             needs_python_include: bool = True) -> Optional[str]:
    """Mtime-cached on-demand g++ build shared by every native piece."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       src_basename)
    build_dir = _build_dir()
    os.makedirs(build_dir, exist_ok=True)
    so_path = os.path.join(
        build_dir, os.path.splitext(src_basename)[0] + ".so")
    if (os.path.exists(so_path)
            and os.path.getmtime(so_path) >= os.path.getmtime(src)):
        return so_path
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           *extra_flags]
    if needs_python_include:
        cmd.append(f"-I{sysconfig.get_paths()['include']}")
    # this process's own output file: a build racing another never
    # renames, or loads, a file the other is still writing
    tmp_path = f"{so_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd += [src, "-o", tmp_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp_path, so_path)
        return so_path
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as exc:
        stderr = getattr(exc, "stderr", b"") or b""
        logger.warning("%s compilation failed, using Python fallback: %s %s",
                       src_basename, exc, stderr.decode()[:500])
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        return None


def load_fastindex():
    """The compiled fastindex module, or None (Python fallback)."""
    global _cached
    if _cached != "unset":
        return _cached
    with _lock:
        if _cached != "unset":
            return _cached
        if os.environ.get("QW_DISABLE_NATIVE") == "1":
            _cached = None
            return None
        so_path = _compile()
        if so_path is None:
            _cached = None
            return None
        import importlib.util
        spec = importlib.util.spec_from_file_location("fastindex", so_path)
        try:
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)  # type: ignore[union-attr]
            _cached = module
        except Exception as exc:  # noqa: BLE001 - load failure → fallback
            logger.warning("fastindex load failed: %s", exc)
            _cached = None
    return _cached


_leafbench_cached: Any = "unset"


def load_leafbench():
    """The compiled leafbench ctypes library (the native CPU comparator,
    see leafbench.cpp), or None when g++ is unavailable or native code is
    disabled."""
    global _leafbench_cached
    if _leafbench_cached != "unset":
        return _leafbench_cached
    with _lock:
        if _leafbench_cached != "unset":
            return _leafbench_cached
        if os.environ.get("QW_DISABLE_NATIVE") == "1":
            _leafbench_cached = None
            return None
        so_path = _compile("leafbench.cpp", extra_flags=("-march=native",),
                           needs_python_include=False)
        if so_path is None:
            _leafbench_cached = None
            return None
        import ctypes
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as exc:
            logger.warning("leafbench load failed: %s", exc)
            _leafbench_cached = None
            return None
        lib.leaf_term_aggs.restype = None
        lib.leaf_bool_range.restype = None
        _leafbench_cached = lib
        return lib
