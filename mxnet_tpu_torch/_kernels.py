"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``_build/<name>-<hash>.so`` (the
directory is git-ignored), and loaded with ``ctypes``.  The hash covers the
sources and the flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing is built when the module is imported: :func:`load` builds
at first use, and :func:`build_all` builds every stale source in turn.

A missing ``nvcc`` or a failed build raises :class:`MXNetError`; there is
no other route to a kernel.
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

from .base import MXNetError

__all__ = ["load", "build_all", "sources", "build_log"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# ctypes signatures of each library's exported C functions
_SIGNATURES = {
    "flash_attn_fwd": {
        "mxt_flash_attn_fwd": (
            ctypes.c_int,
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int,
               ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]),
        "mxt_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

_lock = threading.Lock()
_loaded: dict = {}


def sources():
    """Kernel names, one per ``csrc/*.cu``."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise MXNetError("nvcc not found (on PATH or under CUDA_HOME); the "
                     "port's CUDA kernels cannot be built")


def _target(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return _BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name):
    """The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``, or None when it was not built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def _build(name):
    """Compile one source unless its library is current.  The output goes
    to a temporary name and is renamed into place, so a failed or
    concurrent build never leaves a partial library under the target."""
    so = _target(name)
    if so.exists():
        return
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError(f"nvcc failed to build csrc/{name}.cu "
                         f"(exit {proc.returncode}):\n{proc.stdout}")
    so.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, so)


def _open(name):
    lib = ctypes.CDLL(str(_target(name)))
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib


def build_all():
    """Build every stale ``csrc/*.cu`` and load them all.  Returns the wall
    seconds spent (next to none when every library is current)."""
    t0 = time.perf_counter()
    with _lock:
        for name in sources():
            if name not in _loaded:
                _build(name)
                _loaded[name] = _open(name)
    return time.perf_counter() - t0


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build_all()
    if name not in _loaded:
        raise MXNetError(f"no kernel source csrc/{name}.cu")
    return _loaded[name]
