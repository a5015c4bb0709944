"""Build and load the port's hand-written CUDA kernels and its native host
libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``_build/<name>-<hash>.so`` (the
directory is git-ignored), and loaded with ``ctypes``.  The hash covers the
sources and the flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing is built when the module is imported: :func:`load` builds
at first use, and :func:`build_all` builds every stale source, one
compiler process per source, all at once.

A ``csrc/<name>.cc`` is host code (the data path's RecordIO reader): the
host compiler builds it the same way, with ``HOST_FLAGS``, when
:func:`load_host` first asks for it.  It is no kernel: :func:`sources` and
:func:`build_all` leave it out.

A missing compiler or a failed build raises :class:`MXNetError`; there is
no other route to a kernel or a reader.
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

__all__ = ["load", "load_host", "build_all", "sources", "build_log"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

# ctypes signatures of each library's exported C functions
_SIGNATURES = {
    "flash_attn_fwd": {
        "mxt_flash_attn_fwd": (
            ctypes.c_int,
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_int,
               ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p]),
        "mxt_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "recordio_reader": {
        "mxtpu_reader_create": (
            ctypes.c_void_p,
            [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_uint64, ctypes.c_int]),
        "mxtpu_reader_free": (None, [ctypes.c_void_p]),
        "mxtpu_reader_num_records": (ctypes.c_int64, [ctypes.c_void_p]),
        "mxtpu_reader_reset": (None, [ctypes.c_void_p, ctypes.c_uint64]),
        "mxtpu_reader_next_batch": (
            ctypes.c_int,
            [ctypes.c_void_p,
             ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
             ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
             ctypes.POINTER(ctypes.c_uint64),
             ctypes.POINTER(ctypes.c_uint64)]),
        "mxtpu_reader_read_errors": (ctypes.c_int64, [ctypes.c_void_p]),
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


def _gxx():
    for cand in (os.environ.get("CXX"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return cand
    raise MXNetError("g++ not found (on PATH or as CXX); the port's native "
                     "host libraries cannot be built")


def _host(name):
    return (_CSRC / f"{name}.cc").exists()


def _target(name):
    if _host(name):
        h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
        deps = [_CSRC / f"{name}.cc"]
    else:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        deps = sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]
    for path in deps:
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
    if _host(name):
        src = f"{name}.cc"
        cmd = [_gxx(), *HOST_FLAGS, str(_CSRC / src), "-o", str(tmp)]
    else:
        src = f"{name}.cu"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError(f"{os.path.basename(cmd[0])} failed to build "
                         f"csrc/{src} (exit {proc.returncode}):\n"
                         f"{proc.stdout}")
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
    """Build every stale ``csrc/*.cu``, one ``nvcc`` per source, all started
    together, and load them all.  Returns the wall seconds spent (next to
    none when every library is current)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with _lock:
        todo = [name for name in sources() if name not in _loaded]
        if todo:
            with ThreadPoolExecutor(max_workers=len(todo)) as pool:
                for fut in [pool.submit(_build, name) for name in todo]:
                    fut.result()
            for name in todo:
                _loaded[name] = _open(name)
    return time.perf_counter() - t0


def load_host(name):
    """The ctypes library of the host source ``csrc/<name>.cc``, built
    with the host compiler first if needed."""
    if not _host(name):
        raise MXNetError(f"no host source csrc/{name}.cc")
    with _lock:
        if name not in _loaded:
            _build(name)
            _loaded[name] = _open(name)
    return _loaded[name]


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build_all()
    if name not in _loaded:
        raise MXNetError(f"no kernel source csrc/{name}.cu")
    return _loaded[name]


# kernel name -> the wrapper whose ``launches`` counts its launches: a
# cached CUDA graph (``HybridBlock.hybridize``) reads what its capture
# recorded and adds it again at every replay, so a count is the kernel's
# runs whether the wrapper or a graph launched it
_COUNTERS = {}


def count_launches(name, wrapper):
    """Register ``wrapper.launches`` as the launch count of kernel
    ``name``."""
    _COUNTERS[name] = wrapper


def launch_counts():
    """{kernel name: launches so far}."""
    return {name: w.launches for name, w in _COUNTERS.items()}


def add_launches(counts):
    """Add {kernel name: n} to the counts (a graph's replay, or minus a
    capture, which records the launches without running them)."""
    for name, n in counts.items():
        _COUNTERS[name].launches += n
