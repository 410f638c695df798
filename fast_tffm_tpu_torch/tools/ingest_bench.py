"""The ingest path measured: parse rates alone and training end to end.

    python -m fast_tffm_tpu_torch.tools.ingest_bench \\
        [--cfg examples/criteo_kaggle.cfg] [--files 2] [--lines 32768] \\
        [--epochs 4] [--threads 8 ...] [--procs 0 N ...] \\
        [--cache off|on|prestacked ...] [--k 1 ...] [--repeat 1] \\
        [--device cuda|cpu]

Writes seeded synthetic Criteo-shaped labelled lines (13 ``I<j>_<bucket>``
and 26 ``C<j>_<hex>`` tokens, hashed by the parser) into a temporary
directory, then prints one JSON line per configuration (the grid
``--repeat`` times, in turns, after a warm-up run of one epoch):

- ``drain``: ``BatchPipeline`` drained alone (host sort meta on) with
  the Python parser on one thread over one epoch, the native parser on
  each ``--threads`` and each ``--procs`` N > 0 spawned workers (the
  shared-memory ring on) over ``--epochs``: lines/s, with and without
  the first batch, the first batch's latency, the workers' seconds
  waiting, parsing and shipping, and whether the streams are bitwise
  equal;
- ``train``: for each ``--cache`` mode (``off``, ``on``: the epoch
  cache, ``prestacked``: its packed groups) x each parser (each
  ``--threads`` for ``--procs 0``, else N workers) x ``--k``,
  ``Trainer.train()`` for ``--epochs`` from a fresh seeded model, three
  times: as it runs
  (examples/s end to end, with and without the first dispatch, which
  captures the CUDA graph of the K steps, ``ingest_wait_frac``, the
  graphed and eager dispatches), under
  ``torch.profiler`` with no checkpoint write (the device's idle share,
  host-to-device copies per super-batch, host time per step by op, the
  allocator's ``cudaMalloc`` count), and with every dispatch
  synchronised (its time over its K steps: the step's p50 during the
  run).

``chip_smoke.py`` runs :func:`drain` and :func:`train_runs` on its own
files for its ``ingest`` record, in each of its modes.  The profiler and
the synchronised run need the GPU; on the CPU only the plain run and the
drains run.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.data import native
from fast_tffm_tpu_torch.data.pipeline import BatchPipeline
from fast_tffm_tpu_torch.train.loop import Trainer

__all__ = ["CACHE_MODES", "cache_mode", "drain", "profile_run",
           "train_runs", "with_mode", "write_files"]

INT_BUCKETS = 50


def write_files(directory: str, n_files: int, lines: int,
                seed: int) -> list:
    """``n_files`` files of ``lines`` labelled Criteo-shaped lines; the
    label is planted on the 13 integer features' buckets."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0.0, 0.6, (13, INT_BUCKETS))
    paths = []
    for i in range(n_files):
        ints = rng.integers(0, INT_BUCKETS, (lines, 13))
        ivals = rng.uniform(0.5, 1.5, (lines, 13))
        cats = rng.integers(0, 1 << 32, (lines, 26))
        score = w_true[np.arange(13), ints].sum(axis=1)
        labels = rng.uniform(size=lines) < 1.0 / (1.0 + np.exp(-score))
        path = os.path.join(directory, f"train_{i}.libsvm")
        with open(path, "w") as f:
            for r in range(lines):
                toks = [f"I{j + 1}_{ints[r, j]}:{ivals[r, j]:.4f}"
                        for j in range(13)]
                toks += [f"C{j + 1}_{cats[r, j]:08x}:1" for j in range(26)]
                f.write(f"{int(labels[r])} {' '.join(toks)}\n")
        paths.append(path)
    return paths


def _lines(files) -> int:
    n = 0
    for path in files:
        with open(path, "rb") as f:
            n += sum(chunk.count(b"\n") for chunk in iter(
                lambda: f.read(1 << 22), b""))
    return n


def drain(files, cfg: FmConfig, threads: int, use_native: bool,
          epochs: int, procs: int = 0) -> dict:
    """``BatchPipeline`` drained alone (on ``procs`` spawned workers when
    > 0): lines/s, the first batch's latency, and a digest of the first
    epoch's batches."""
    cfg = dataclasses.replace(cfg, thread_num=threads,
                              parse_processes=procs)
    h = hashlib.sha256()
    per_epoch = None
    t0 = time.perf_counter()
    first = None
    n = 0
    with BatchPipeline(files, cfg, epochs=epochs, shuffle=True,
                       host_meta=True, native=use_native,
                       epoch_marks=True) as pipe:
        for item in pipe:
            if first is None:
                first = time.perf_counter() - t0
            if not hasattr(item, "ids"):  # an EpochEnd
                per_epoch = per_epoch or n
                continue
            n += 1
            if per_epoch is None:
                for a in item[:5] + tuple(item.sort_meta):
                    h.update(np.ascontiguousarray(a).tobytes())
    wall = time.perf_counter() - t0
    lines = epochs * _lines(files)
    return {"threads": threads, "procs": procs, "native": use_native,
            "epochs": epochs, "batches": n, "lines_per_s": lines / wall,
            "first_batch_s": first,
            # The rest of the drain's rate (a pool's start left out).
            "lines_per_s_after_first_batch":
                lines * (n - 1) / n / (wall - first) if n > 1 else None,
            "worker_seconds": pipe.worker_seconds,
            "digest": h.hexdigest()}


def profile_run(fn) -> dict:
    """``fn()`` under ``torch.profiler`` (every thread's work): device ms
    by op, wall ms, host self ms by op, host-to-device copies by kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host, h2d = {}, {}, {}
    for ev in prof.key_averages():
        cpu_us = getattr(ev, "self_cpu_time_total", 0.0)
        if cpu_us > 0:
            host[ev.key[:60]] = cpu_us / 1e3
        if ev.device_type == DeviceType.CPU or "Activity Buffer" in ev.key:
            continue
        if "HtoD" in ev.key:
            h2d[ev.key] = h2d.get(ev.key, 0) + ev.count
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and dev_us > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].strip()[:60]
            dev[name] = dev.get(name, 0.0) + dev_us / 1e3
    return {"device_ms": dev, "wall_ms": wall * 1e3, "host_ms": host,
            "h2d_copies": h2d}


def _top(d: dict, steps: int, n: int) -> dict:
    return {k: v / steps for k, v in sorted(d.items(),
                                            key=lambda kv: -kv[1])[:n]}


def train_runs(cfg: FmConfig, device, trainer_cls=Trainer, on_start=None,
               on_end=None, profiled: bool = True) -> dict:
    """``Trainer.train()`` on ``cfg`` three times from fresh models (see
    the module docstring; the profiled run only with ``profiled``);
    ``on_start()`` runs just before each ``train()``, ``on_end(run,
    train_result, trainer)`` just after.  Returns the ``train``
    record."""
    cuda = torch.device(device).type == "cuda"

    class NoSaveTrainer(trainer_cls):
        """Writes no checkpoint: the profiled window holds training only
        (a save moves the tables to the host)."""

        def save(self, stepno):
            return None

    class SyncTrainer(trainer_cls):
        """Each dispatch synchronised and timed on the host clock; its
        time over its steps is each step's (a graph replays K at once)."""

        def __init__(self, *args, **kwargs):
            self.step_s = []
            super().__init__(*args, **kwargs)

        def dispatch(self, sb, pause=None):
            t0 = time.perf_counter()
            losses = super().dispatch(sb, pause)
            torch.cuda.synchronize()
            self.step_s.append((time.perf_counter() - t0) / sb.n)
            return losses

    runs = [("plain", trainer_cls)]
    if cuda and profiled:
        runs.append(("profiled", NoSaveTrainer))
    if cuda:
        runs.append(("synced", SyncTrainer))
    out = {}
    tmp = tempfile.mkdtemp(prefix="ingest_bench_")
    try:
        for run, cls in runs:
            rcfg = dataclasses.replace(
                cfg, model_file=os.path.join(tmp, run), validation_files=[],
                log_steps=0, save_steps=0)
            trainer = cls(rcfg, device=device)
            if cuda:
                torch.cuda.synchronize()
            if on_start is not None:
                on_start()
            if run == "profiled":
                got = {}
                allocs = torch.cuda.memory_stats().get("num_device_alloc", 0)
                prof = profile_run(lambda: got.update(trainer.train()))
                allocs = torch.cuda.memory_stats().get(
                    "num_device_alloc", 0) - allocs
                result = got
            else:
                result = trainer.train()
            if cuda:
                torch.cuda.synchronize()
            if on_end is not None:
                on_end(run, result, trainer)
            tr = result["train"]
            if run == "plain":
                k, steps = cfg.steps_per_dispatch, tr["steps"]
                out.update({
                    "steps": steps, "dispatches": tr["dispatches"],
                    "examples_per_sec_end_to_end": tr["examples_per_sec"],
                    # The first dispatch's K batches left out (full
                    # batches: the examples spread evenly over steps).
                    "examples_per_sec_after_first_dispatch":
                        tr["examples"] * (steps - k) / steps
                        / (tr["wall_s"] - tr["first_dispatch_s"])
                        if steps > k else None,
                    "first_dispatch_s": tr["first_dispatch_s"],
                    "graph_dispatches": tr["graph_dispatches"],
                    "eager_dispatches": tr["eager_dispatches"],
                    "wall_s": tr["wall_s"],
                    "ingest_wait_frac": tr["ingest_wait_frac"],
                    "ingest_cache": tr["ingest_cache"],
                })
            elif run == "profiled":
                steps = tr["steps"]
                busy = sum(prof["device_ms"].values())
                out["profiled"] = {
                    "wall_ms": prof["wall_ms"], "device_busy_ms": busy,
                    "device_idle_frac":
                        max(0.0, 1.0 - busy / prof["wall_ms"]),
                    "examples_per_sec_end_to_end": tr["examples_per_sec"],
                    "ingest_wait_frac": tr["ingest_wait_frac"],
                    "h2d_copies": prof["h2d_copies"],
                    "h2d_copies_per_super_batch":
                        sum(prof["h2d_copies"].values()) / tr["dispatches"],
                    "memcpy_async_host_ms_per_step":
                        prof["host_ms"].get("cudaMemcpyAsync", 0.0) / steps,
                    "launch_kernel_host_ms_per_step":
                        prof["host_ms"].get("cudaLaunchKernel", 0.0) / steps,
                    "graph_launch_host_ms_per_step":
                        prof["host_ms"].get("cudaGraphLaunch", 0.0) / steps,
                    "device_allocs": allocs,
                    "device_ms_by_op_per_step":
                        _top(prof["device_ms"], steps, 12),
                    "host_self_ms_per_step_top10":
                        _top(prof["host_ms"], steps, 10),
                }
            else:
                # The first two dispatches left out: the first runs
                # eagerly and captures the graph, the second replays it
                # for the first time.
                step_s = sorted(trainer.step_s[2:])
                out["step_p50_ms_in_train"] = (
                    step_s[(len(step_s) - 1) // 2] * 1e3)
                out["synced_examples_per_sec"] = tr["examples_per_sec"]
                out["synced_ingest_wait_frac"] = tr["ingest_wait_frac"]
            del trainer
    finally:
        for run, _ in runs:
            for name in ("params.npz", "data_state.json"):
                path = os.path.join(tmp, run, name)
                if os.path.exists(path):
                    os.remove(path)
            if os.path.isdir(os.path.join(tmp, run)):
                os.rmdir(os.path.join(tmp, run))
        os.rmdir(tmp)
    out.update({"thread_num": cfg.thread_num,
                "parse_processes": cfg.parse_processes,
                "ring_slots": cfg.ring_slots,
                "cache": cache_mode(cfg),
                "steps_per_dispatch": cfg.steps_per_dispatch})
    return out


CACHE_MODES = {"off": dict(cache_epochs=False, cache_prestacked=False),
               "on": dict(cache_epochs=True, cache_prestacked=False),
               "prestacked": dict(cache_epochs=True, cache_prestacked=True)}


def cache_mode(cfg: FmConfig) -> str:
    """``off``, ``on`` or ``prestacked``: ``cfg``'s epoch cache."""
    if not cfg.cache_epochs:
        return "off"
    return "prestacked" if cfg.cache_prestacked else "on"


def with_mode(cfg: FmConfig, cache: str, threads: int, procs: int,
              k: int) -> FmConfig:
    """``cfg`` with one cell of the grid's settings."""
    return dataclasses.replace(cfg, thread_num=threads, parse_processes=procs,
                               steps_per_dispatch=k, **CACHE_MODES[cache])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "examples",
        "criteo_kaggle.cfg"))
    ap.add_argument("--files", type=int, default=2)
    ap.add_argument("--lines", type=int, default=32768)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--threads", type=int, nargs="+", default=[8])
    ap.add_argument("--procs", type=int, nargs="+", default=[0],
                    help="0: the --threads; N > 0: N spawned workers")
    ap.add_argument("--cache", nargs="+", default=["off"],
                    choices=sorted(CACHE_MODES))
    ap.add_argument("--k", type=int, nargs="+", default=[1])
    ap.add_argument("--repeat", type=int, default=1,
                    help="passes over the grid, in turns")
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args(argv)
    device = args.device or "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("ingest_bench: no CUDA GPU; pass --device cpu", file=sys.stderr)
        return 2
    card = (torch.cuda.get_device_name(0) if torch.device(device).type
            == "cuda" else "cpu")
    native.load()
    if torch.device(device).type == "cuda":
        from fast_tffm_tpu_torch.ops import _build

        _build.load()  # the kernels' build stays out of every run
    with tempfile.TemporaryDirectory(prefix="ingest_bench_data_") as tmp:
        files = write_files(tmp, args.files, args.lines, args.seed)
        cfg = load_config(args.cfg, {"train_files": files,
                                     "epoch_num": args.epochs,
                                     "seed": args.seed})
        drains = [drain(files, cfg, 1, False, 1)]
        drains += [drain(files, cfg, t, True, args.epochs)
                   for t in args.threads]
        drains += [drain(files, cfg, cfg.thread_num, True, args.epochs, p)
                   for p in args.procs if p > 0]
        print(json.dumps({"drain": drains, "device": card,
                          "cpu_count": os.cpu_count(),
                          "streams_bitwise_equal": len(
                              {d["digest"] for d in drains}) == 1}),
              flush=True)
        # A warm-up run (one epoch, not reported): the CUDA context and
        # the first launches stay out of the grid.
        Trainer(dataclasses.replace(
            cfg, epoch_num=1, validation_files=[], save_steps=0,
            model_file=os.path.join(tmp, "warmup")), device=device).train()
        parsers = [(t, 0) for t in args.threads if 0 in args.procs]
        parsers += [(cfg.thread_num, p) for p in args.procs if p > 0]
        for rep in range(args.repeat):
            for cache in args.cache:
                for t, p in parsers:
                    for k in args.k:
                        rec = train_runs(with_mode(cfg, cache, t, p, k),
                                         device)
                        print(json.dumps({"train": rec, "pass": rep,
                                          "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
