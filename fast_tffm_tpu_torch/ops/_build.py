"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface,
``_build/libfm_kernels.so``, loaded with :mod:`ctypes`.  The sources
compile in parallel (one ``nvcc`` per source, all started together) and
link once.  The build runs at first use and again whenever a source (or
a ``csrc/*.cuh`` header) is newer than the library, so a fresh checkout
builds on its first kernel call; nothing is built when the module is
imported.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

from fast_tffm_tpu_torch.obs.resource import note_build

__all__ = ["BUILD_DIR", "LIB_PATH", "build", "load"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libfm_kernels.so")
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict = {}  # "lib" -> the loaded ctypes.CDLL


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
        "and PATH): the CUDA kernels are built from source on the "
        "machine with the GPU"
    )


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _stale(srcs: list) -> bool:
    """True when the library is missing or older than a source or one of
    the headers the sources include (``csrc/*.cuh``)."""
    if not os.path.isfile(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in srcs + headers)


def _run_all(cmds: list) -> str:
    """Run the commands concurrently; return their joined output.
    Raises RuntimeError naming the first that failed; every process
    started here has ended when this returns or raises."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outs = []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            outs.append(out)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"CUDA build step failed ({proc.returncode}): "
                    f"{' '.join(cmd)}\n{out}"
                )
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return "".join(outs)


def build(force: bool = False) -> str:
    """Compile ``csrc/*.cu`` into :data:`LIB_PATH` unless it is up to
    date.  Returns the compiler's output (register and shared-memory
    use per kernel, from ``-Xptxas -v``), empty when nothing was
    built."""
    srcs = _sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    if not force and not _stale(srcs):
        return ""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Per-process file names: two processes building at once never
    # write each other's objects, and the rename below is atomic.
    tag = f".{os.getpid()}"
    objs = [
        os.path.join(BUILD_DIR, os.path.basename(s) + tag + ".o")
        for s in srcs
    ]
    tmp = LIB_PATH + tag + ".tmp"
    t0 = time.perf_counter()
    try:
        log = _run_all([
            [nvcc, _ARCH, *_CFLAGS, "-c", src, "-o", obj]
            for src, obj in zip(srcs, objs)
        ])
        log += _run_all([[nvcc, _ARCH, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, LIB_PATH)
    finally:
        for path in (*objs, tmp):
            if os.path.exists(path):
                os.remove(path)
    note_build("nvcc", LIB_PATH, time.perf_counter() - t0)
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process,
    with every entry point's argument and result types declared."""
    with _lock:
        lib = _loaded.get("lib")
        if lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.fm_scores_fwd.argtypes = [ptr, ptr, ptr, ptr,
                                          i32, i32, i32, ptr]
            lib.fm_scores_fwd.restype = i32
            lib.fm_scores_fwd_bf16.argtypes = lib.fm_scores_fwd.argtypes
            lib.fm_scores_fwd_bf16.restype = i32
            lib.fm_grad_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr,
                                        i32, i32, i32, ptr]
            lib.fm_grad_bwd.restype = i32
            lib.fm_grad_bwd_bf16.argtypes = lib.fm_grad_bwd.argtypes
            lib.fm_grad_bwd_bf16.restype = i32
            lib.k1_dedup.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                     i32, i32, ptr]
            lib.k1_dedup.restype = i32
            lib.k1_merge.argtypes = lib.k1_dedup.argtypes
            lib.k1_merge.restype = i32
            i64 = ctypes.c_longlong
            lib.kplace.argtypes = [ptr, ptr, i32, i64, i64, i32, ptr, ptr]
            lib.kplace.restype = i32
            f32 = ctypes.c_float
            lib.k2_apply.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                     f32, f32, f32, f32, ptr]
            lib.k2_apply.restype = i32
            lib.k2t_apply.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i64,
                                      f32, f32, ptr]
            lib.k2t_apply.restype = i32
            lib.k2p_apply.argtypes = [ptr, ptr, ptr, ptr, i32, i32, f32, f32,
                                      ptr]
            lib.k2p_apply.restype = i32
            lib.fm_kernels_error_string.argtypes = [i32]
            lib.fm_kernels_error_string.restype = ctypes.c_char_p
            _loaded["lib"] = lib
        return lib

