"""Builds the JAX package's C++ parser once, before any test runs.

The reference's native module (``fast_tffm_tpu/data/native.py``) builds
``libfm_parser.so`` on first use under a thread lock and through one
shared ``libfm_parser.so.tmp``.  Two processes that build it at once (the
pytest-xdist workers of a fresh checkout, where the library is not built
yet) can move each other's half-written file into place: one then fails
with "No such file or directory" on the move, or loads "file too short",
and the reference's pipeline quietly falls back to its Python parser.

This module builds it when it is imported, through the reference's own
``_load()``, under an ``fcntl`` lock on a file in
``tempfile.gettempdir()``: the first process to import it builds, the
others wait and find the library built.  Every xdist worker collects
every module before it runs a test, so no test of a fresh checkout races
the build.  It writes nothing into the JAX package but the library the
build always writes.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import tempfile
import textwrap

from fast_tffm_tpu.data import libsvm as reference_libsvm
from fast_tffm_tpu.data import native as reference_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lock_path(target: str) -> str:
    """The lock file of a build that writes ``target``: one per target
    path, in the temporary directory."""
    tag = hashlib.sha1(os.path.abspath(target).encode()).hexdigest()[:16]
    return os.path.join(tempfile.gettempdir(), f"tffm_build_{tag}.lock")


def build_under_lock(build, target: str):
    """``build()`` while holding an exclusive ``flock`` on
    :func:`lock_path` of ``target``: other processes wait until it has
    returned (or raised)."""
    with open(lock_path(target), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            return build()
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


BUILD_ERROR = None
try:
    build_under_lock(reference_native._load, reference_native._LIB)
except Exception as e:  # noqa: BLE001 - reported by the test below
    BUILD_ERROR = e


def test_reference_parser_library_loads():
    assert BUILD_ERROR is None, f"reference parser build failed: {BUILD_ERROR}"
    lib = reference_native._load()
    assert os.path.getmtime(reference_native._LIB) >= os.path.getmtime(
        reference_native._SRC)
    assert lib is reference_native._load()
    assert reference_native.murmur64_native(b"abc") == \
        reference_libsvm.murmur64(b"abc")
    assert not os.path.exists(reference_native._LIB + ".tmp")


# The reference's build, step for step, on a scratch source: built when
# missing or older than the source, through one shared ``.tmp`` path.
_WORKER = textwrap.dedent("""
    import ctypes, importlib.util, os, subprocess, sys, time
    spec = importlib.util.spec_from_file_location("helper", sys.argv[1])
    helper = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(helper)
    src, lib, log = sys.argv[2:5]

    def build():
        t0 = time.time()
        built = not (os.path.exists(lib)
                     and os.path.getmtime(lib) >= os.path.getmtime(src))
        if built:
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", src, "-o",
                            lib + ".tmp"], check=True, capture_output=True)
            os.replace(lib + ".tmp", lib)
        with open(log, "a") as f:
            f.write(f"{t0} {time.time()} {int(built)}\\n")
        return ctypes.CDLL(lib).answer()

    print(helper.build_under_lock(build, lib))
""")

# Enough code that g++ takes a visible time: a race would have room.
_SOURCE = "\n".join(
    [f"double f{i}(double x) {{ double s = 0; for (int k = 0; k < {i + 3}; "
     f"++k) s += x * k / (k + {i + 1}.0); return s; }}" for i in range(300)]
    + ['extern "C" int answer(void) { return 42; }'])


def test_build_lock_serialises_processes(tmp_path):
    """Six processes build one library at once under the lock: their
    builds never overlap, exactly one compiles, and every one loads the
    whole library."""
    src = tmp_path / "answer.cc"
    src.write_text(_SOURCE)
    lib, log = str(tmp_path / "libanswer.so"), str(tmp_path / "build.log")
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), os.path.abspath(__file__), str(src),
         lib, log], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "42"
    spans = sorted(tuple(map(float, line.split()))
                   for line in open(log).read().splitlines())
    assert len(spans) == 6
    assert sum(int(built) for _, _, built in spans) == 1
    assert spans[0][2] == 1  # the first holder compiled
    for (_, end, _), (start, _, _) in zip(spans, spans[1:]):
        assert start >= end  # one holder at a time
    assert not os.path.exists(lib + ".tmp")
    assert ctypes.CDLL(lib).answer() == 42
    assert os.path.exists(lock_path(lib))


def test_lock_path_is_per_target(tmp_path):
    a, b = str(tmp_path / "a.so"), str(tmp_path / "b.so")
    assert lock_path(a) != lock_path(b)
    assert lock_path(a) == lock_path(os.path.relpath(a))
    assert os.path.dirname(lock_path(a)) == tempfile.gettempdir()
    assert build_under_lock(lambda: 7, a) == 7
    # A build that raises lets go of the lock.
    try:
        build_under_lock(lambda: 1 / 0, a)
    except ZeroDivisionError:
        pass
    with open(lock_path(a), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
        fcntl.flock(f, fcntl.LOCK_UN)
