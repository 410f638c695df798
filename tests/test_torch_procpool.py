"""The port's process pool (``parse_processes``, with its shared-memory
ring ``ring_slots``) vs its threads and the JAX package's pipeline.

Mirrors the reference's ``tests/test_ingest_matrix.py`` and the process
cases of ``tests/test_epoch_persistent.py``: two spawned workers deliver
batches element-wise equal to the parse threads' and to the reference's
``BatchPipeline(ordered=True)`` on the raw-window and the line stream,
with the epoch cache off, on and prestacked, from resume positions and
shards; the ring's work messages are descriptors only; a window larger
than a slot goes through the queue; a killed worker raises with its exit
code and an early close leaves no segment of the pipeline's tag in
``/dev/shm``; the workers' truncation and batch counts come back; a
spawned worker maps no torch library, even under a ``__main__`` that
imports torch.  Each test spawns at most two workers and ends its pool
before it returns.
"""

import multiprocessing as mp
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import libsvm, pipeline as pipeline_mod
from fast_tffm_tpu_torch.data import procpool
from fast_tffm_tpu_torch.data.pipeline import BatchPipeline
from fast_tffm_tpu_torch.train.loop import Trainer

from test_torch_epoch_cache import (
    _assert_same, _batches, _cfg, _jax_items, _port_items, _state,
    _write_data,
)
from test_torch_pipeline import STREAM, _write_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ours():
    """This process's segments in ``/dev/shm`` (xdist runs other test
    processes beside it, each with its own tags)."""
    mine = f"tffm{os.getpid()}p"
    return {n for n in os.listdir(procpool.SHM_DIR) if n.startswith(mine)}


@pytest.fixture(autouse=True)
def no_segment_left():
    before = _ours()
    yield
    assert _ours() - before == set()


_MODES = {"stream": (False, 0), "cache": (True, 0), "prestack": (True, 3)}


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("fast_ingest", [True, False], ids=["raw", "line"])
def test_process_stream_matches_threads_and_reference(tmp_path, fast_ingest,
                                                      mode):
    """Two workers (the ring on for the raw stream) give the threads'
    batches and the reference's, element-wise, with the same markers,
    for each cache storage; their parsers parsed exactly the batches of
    every parsed epoch."""
    files, _ = _write_files(tmp_path)
    cache, k = _MODES[mode]
    kw = dict(fast_ingest=fast_ingest, **STREAM)
    common = dict(epochs=3, shuffle=True, cache_epochs=cache, prestack_k=k)
    threads, _ = _port_items(files, FmConfig(thread_num=2, **kw), **common)
    before = BatchPipeline.worker_batches
    procs, pipe = _port_items(files, FmConfig(parse_processes=2, **kw),
                              **common)
    parsed = BatchPipeline.worker_batches - before
    want, jpipe = _jax_items(files, JaxFmConfig(**kw), **common)
    _assert_same(procs, want)
    _assert_same(threads, want)
    assert pipe.truncated_features == jpipe.truncated_features > 0
    per_epoch = len(_batches(procs)) // 3
    assert parsed == (per_epoch if cache else 3 * per_epoch)
    if fast_ingest:
        assert pipe.ring_windows > 0 and pipe.ring_fallback_windows == 0


@pytest.mark.parametrize("fast_ingest, start_epoch, skip, shard", [
    (True, 1, 5, (0, 1)),
    (True, 0, 3, (1, 2)),
    (False, 1, 2, (0, 2)),
])
def test_process_stream_resumes_and_shards_as_the_threads(
        tmp_path, fast_ingest, start_epoch, skip, shard):
    files, _ = _write_files(tmp_path)
    kw = dict(fast_ingest=fast_ingest, **STREAM)
    common = dict(epochs=2, shuffle=True, start_epoch=start_epoch,
                  skip_batches=skip, shard=shard)
    procs, _ = _port_items(files, FmConfig(parse_processes=2, **kw),
                           **common)
    threads, _ = _port_items(files, FmConfig(thread_num=2, **kw), **common)
    want, _ = _jax_items(files, JaxFmConfig(**kw), **common)
    _assert_same(procs, want)
    _assert_same(threads, want)


def _big_file(tmp_path, lines=2000):
    rng = np.random.default_rng(7)
    path = tmp_path / "big.libsvm"
    path.write_text("".join(
        f"{rng.integers(0, 2)} " + " ".join(
            f"{rng.integers(0, 99)}:{rng.uniform(0, 2):.4f}"
            for _ in range(rng.integers(1, 5))) + "\n"
        for _ in range(lines)))
    return [str(path)]


def _small_cfg(**kw):
    base = dict(vocabulary_size=100, batch_size=64, max_features=4,
                queue_size=4, shuffle_buffer=256, seed=11)
    base.update(kw)
    return FmConfig(**base)


def test_ring_work_messages_are_descriptor_only(tmp_path):
    """With the ring, the window text never crosses the work queue: every
    window goes through a slot and the messages (a descriptor a batch)
    total a small fraction of the text; without it the same stream
    crosses pickled."""
    files = _big_file(tmp_path)
    ringed, p_on = _port_items(files, _small_cfg(parse_processes=2,
                                                 ring_slots=3), epochs=2)
    assert p_on.ring_windows >= 4 and p_on.ring_fallback_windows == 0
    text = p_on.ring_window_bytes
    assert 0 < p_on.work_msg_bytes < 0.05 * text, (p_on.work_msg_bytes, text)
    plain, p_off = _port_items(files, _small_cfg(parse_processes=2,
                                                 ring_slots=0), epochs=2)
    assert p_off.ring_windows == 0 and p_off.ring_fallback_windows >= 4
    assert p_off.work_msg_bytes > text
    threads, _ = _port_items(files, _small_cfg(thread_num=2), epochs=2)
    for a, b, c in zip(_batches(ringed), _batches(plain), _batches(threads)):
        for name in ("labels", "ids", "vals", "weights"):
            np.testing.assert_array_equal(getattr(a, name), getattr(c, name))
            np.testing.assert_array_equal(getattr(b, name), getattr(c, name))
    assert len(_batches(ringed)) == len(_batches(threads)) > 50


def test_one_slot_recycled_under_a_short_switch_interval(tmp_path):
    """Stress the slot bookkeeping the reader and the consumer share: one
    ring slot, a window a file (24 small files), four workers, and the
    interpreter switching threads every microsecond; the stream stays the
    threads'."""
    files = []
    for i in range(24):
        sub = tmp_path / f"f{i:02d}"
        sub.mkdir()
        files += _big_file(sub, lines=100 + i)
    cfg = _small_cfg(parse_processes=4, ring_slots=1, queue_size=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, p = _port_items(files, cfg, epochs=2, shuffle=False)
    finally:
        sys.setswitchinterval(old)
    threads, _ = _port_items(files, _small_cfg(thread_num=2), epochs=2,
                             shuffle=False)
    assert p.ring_windows >= 2 * 20 and len(_batches(got)) > 40
    assert [b.ids.tobytes() for b in _batches(got)] == [
        b.ids.tobytes() for b in _batches(threads)]


def test_oversized_window_takes_the_queue_path(tmp_path, monkeypatch):
    """Slots too small for any window: every window crosses pickled,
    counted, and the stream is the threads'."""
    files = _big_file(tmp_path, lines=600)
    monkeypatch.setattr(pipeline_mod, "ring_slot_bytes", lambda *a: 32)
    got, p = _port_items(files, _small_cfg(parse_processes=2, ring_slots=2),
                         epochs=2)
    assert p.ring_windows == 0 and p.ring_fallback_windows >= 2
    threads, _ = _port_items(files, _small_cfg(thread_num=2), epochs=2)
    assert [b.ids.tobytes() for b in _batches(got)] == [
        b.ids.tobytes() for b in _batches(threads)]


def test_killed_worker_raises_and_leaves_no_segment(tmp_path):
    """A worker killed mid-run surfaces in the consumer as an error
    naming its exit code, not a hang, and the teardown leaves none of
    the pipeline's segments (the ring's included)."""
    files = _big_file(tmp_path, lines=600)
    cfg = _small_cfg(parse_processes=2, ring_slots=2, queue_size=2)
    existing = set(mp.active_children())
    with BatchPipeline(files, cfg, epochs=50, shuffle=True) as pipe:
        it = iter(pipe)
        next(it)
        workers = [p for p in mp.active_children() if p not in existing]
        assert len(workers) == 2
        assert any(n.startswith(pipe.shm_tag) for n in _ours())
        for w in workers:
            w.kill()
        with pytest.raises(RuntimeError, match=r"died \(exitcode -9\)"):
            for _ in it:
                pass
        assert not any(n.startswith(pipe.shm_tag) for n in _ours())
    for w in workers:
        w.join(timeout=10)
        assert not w.is_alive()


@pytest.mark.parametrize("how", ["consumer", "other_thread"])
def test_early_close_leaves_no_segment(tmp_path, how):
    """Closing mid-stream, from the consumer or from another thread
    while the consumer iterates (the transfer stage's case), stops the
    workers and leaves no segment behind."""
    files = _big_file(tmp_path, lines=600)
    cfg = _small_cfg(parse_processes=2, ring_slots=2, queue_size=2)
    existing = set(mp.active_children())
    pipe = BatchPipeline(files, cfg, epochs=50, shuffle=True,
                         host_meta=True)
    try:
        it = iter(pipe)
        next(it)
        workers = [p for p in mp.active_children() if p not in existing]
        if how == "consumer":
            pipe.close()
        else:
            seen = []

            def consume():
                seen.extend(1 for _ in it)

            t = threading.Thread(target=consume)
            t.start()
            pipe.close()
            t.join(timeout=30)
            assert not t.is_alive()
        assert not any(n.startswith(pipe.shm_tag) for n in _ours())
    finally:
        pipe.close()
    for w in workers:
        w.join(timeout=10)
        assert not w.is_alive()


def test_truncation_and_batches_counted_from_the_workers(tmp_path):
    """The workers parse in children: their cut-off features come back
    with their batches, and their parsers' batch counts and their seconds
    waiting, parsing and shipping at their end."""
    path = tmp_path / "t.libsvm"
    path.write_text("".join(
        f"{i % 2} " + " ".join(f"{(i + j) % 64}:1.0" for j in range(6))
        + "\n" for i in range(64)))
    cfg = FmConfig(vocabulary_size=64, max_features=4, batch_size=32,
                   parse_processes=1, seed=3)
    before = BatchPipeline.worker_batches
    with BatchPipeline([str(path)], cfg, shuffle=False) as pipe:
        assert sum(1 for _ in pipe) == 2
    assert pipe.truncated_features == 128
    assert BatchPipeline.worker_batches - before == 2
    assert set(pipe.worker_seconds) == {"idle", "parse", "ship"}
    assert pipe.worker_seconds["parse"] > 0


@pytest.mark.parametrize("fast_ingest", [True, False])
def test_malformed_line_is_named_by_a_worker(tmp_path, fast_ingest):
    """A worker names a malformed line's file and line as the threads do,
    from the window's marks in its ring slot or from the line records."""
    files, _ = _write_files(tmp_path)
    with open(files[1], "a") as f:
        f.write("\n1 7:1\n0 4:zz\n")
    cfg = FmConfig(fast_ingest=fast_ingest, parse_processes=2, **STREAM)
    with pytest.raises(ValueError, match="part-1.libsvm:59:"):
        _port_items(files, cfg, epochs=1, shuffle=True)


_NO_TORCH_SCRIPT = """
import multiprocessing as mp
import sys
import torch  # the parent's __main__ imports torch, as the CLI's does
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.pipeline import BatchPipeline

if __name__ == "__main__":
    cfg = FmConfig(vocabulary_size=100, batch_size=8, max_features=4,
                   parse_processes=1, seed=3)
    pipe = BatchPipeline([sys.argv[1]], cfg, epochs=1000)
    it = iter(pipe)
    next(it)
    for p in mp.active_children():
        maps = open(f"/proc/{p.pid}/maps").read()
        print("numpy", "_multiarray_umath" in maps)
        print("torch", "libtorch" in maps or "/torch/" in maps)
    pipe.close()
"""


def test_a_spawned_worker_imports_no_torch(tmp_path):
    """Under a ``__main__`` script that imports torch, a worker spawns
    with the parent's ``__main__`` hidden: it maps numpy (the data
    layer) and no torch library."""
    files = _big_file(tmp_path, lines=100)
    script = tmp_path / "main_with_torch.py"
    script.write_text(_NO_TORCH_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, str(script), files[0]], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["numpy", "True", "torch", "False"], \
        out.stdout + out.stderr


def test_a_ring_that_cannot_reserve_raises_with_its_size():
    """A ring larger than ``/dev/shm`` raises at creation, naming the
    bytes it asked for, and leaves no segment."""
    free = os.statvfs(procpool.SHM_DIR)
    too_big = free.f_blocks * free.f_frsize + (1 << 30)
    tag = procpool.make_shm_tag()
    with pytest.raises(RuntimeError, match=f"reserve {too_big} bytes"):
        procpool.ShmRing.create(tag, 1, too_big)
    assert not any(n.startswith(tag) for n in _ours())


def test_a_worker_whose_parser_fails_raises_into_the_consumer():
    """A worker that cannot build its parser sends the error back (and
    nothing falls back to the Python parser)."""
    ctx = mp.get_context("spawn")
    work, out, stop = ctx.Queue(), ctx.Queue(), ctx.Event()
    spec = procpool.WorkerSpec(
        vocabulary_size=1 << 62, max_features=4, hash_feature_id=False,
        field_num=0, batch_size=8, host_meta=False,
        shm_tag=procpool.make_shm_tag())
    (p,) = procpool.start_workers(ctx, 1, spec, work, out, stop)
    try:
        kind, exc = out.get(timeout=120)
        assert kind == "err" and isinstance(exc, ValueError)
        assert "vocabulary_size" in str(exc)
    finally:
        stop.set()
        p.join(timeout=30)
        work.close()
        out.close()
    assert not p.is_alive()


def test_ship_and_attach_a_batch_through_a_segment():
    """A shipped batch (its sort meta's ``seg_start`` of U + 1 entries
    included) comes back equal, its name unlinked at attach, its pages
    kept by the views."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 50, (8, 4)).astype(np.int32)
    batch = libsvm.Batch(
        rng.integers(0, 2, 8).astype(np.float32), ids,
        rng.uniform(size=(8, 4)).astype(np.float32),
        np.zeros((8, 4), np.int32), np.ones(8, np.float32),
        libsvm.host_sort_meta(ids))
    spec = procpool.WorkerSpec(50, 4, False, 0, 8, True,
                               procpool.make_shm_tag())
    name, meta_len = procpool.ship_batch(spec, batch)
    assert meta_len == len(batch.sort_meta.seg_start) < ids.size + 1
    got = procpool.attach_batch(spec, name, meta_len)
    assert name not in os.listdir(procpool.SHM_DIR)
    for a, b in zip(got[:5] + tuple(got.sort_meta),
                    batch[:5] + tuple(batch.sort_meta)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    got.ids[0, 0] = 7  # the views are writable, as a parsed batch's


def test_tags_are_unique_and_the_sweep_takes_only_its_own():
    a, b = procpool.make_shm_tag(), procpool.make_shm_tag()
    assert a != b and a.endswith("_") and b.endswith("_")
    paths = [os.path.join(procpool.SHM_DIR, f"{t}x") for t in (a, b)]
    for path in paths:
        open(path, "wb").close()
    try:
        assert procpool.sweep_segments(a) == 1
        assert not os.path.exists(paths[0]) and os.path.exists(paths[1])
    finally:
        procpool.sweep_segments(b)


def test_trainer_on_processes_is_bitwise_the_threads(tmp_path):
    """``parse_processes = 1``: the same parameters and metrics, bitwise,
    as the threads (the reference's ``test_trainer_parse_processes_
    bitwise``)."""
    _write_data(tmp_path / "train.libsvm", np.random.default_rng(0))
    tt = Trainer(_cfg(tmp_path, model_file=str(tmp_path / "t"), epoch_num=2),
                 device="cpu")
    rt = tt.train()["train"]
    tp = Trainer(_cfg(tmp_path, model_file=str(tmp_path / "p"), epoch_num=2,
                      parse_processes=1), device="cpu")
    rp = tp.train()["train"]
    for a, b in zip(_state(tt), _state(tp)):
        np.testing.assert_array_equal(a, b)
    for key in ("logloss", "auc", "examples", "weight_sum", "steps"):
        assert rt[key] == rp[key], key
    for a, b in zip(tt.metrics, tp.metrics):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x.numpy(), y.numpy())
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
