"""One run of one cell of the benchmark of ``fast_tffm_tpu_torch``:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the GPUs the cell asks
for (none: it exits 2 and prints no result; it never falls back to the
CPU).  ``BENCHMARK.json`` names the cell's configuration
(``configs/<config>.json``: the frozen cfg, its field schema, where it
comes from) and traffic (``traffic/<mix>.json``: how the lines are drawn
and how they reach the trainer), and the metrics, each read by
``metrics/<name>.py``.

The run, in one process:

1. **Set-up** (``setup_s``, from this module's first line): imports, the
   cell's lines drawn from ``--seed`` (``gen.py``) into a file under the
   temporary directory, a ``Trainer`` of the cell's cfg (the port's
   defaults on: health carry, telemetry, quality plane, blackbox, compile
   sentinel; no checkpoint, no validation), then ``Trainer.train()``:
   epoch 0 parsed by the native parser into the prestacked epoch cache
   and trained (its first dispatch eager, then captured as a CUDA graph),
   and the first ``REPLAY`` dispatches of epoch 1 replayed from the
   cache; the check's readings are taken at those dispatch boundaries.
   Then ``WARM`` more dispatches.
2. **The window**: from a synchronised dispatch boundary, the same
   ``train()`` replays the cache epoch after epoch (one packed copy and
   one graph replay a super-batch) until the first dispatch boundary
   past ``--seconds``, where the device is synchronised before the clock
   stops.  The end-to-end metrics are read over it.
3. With ``--trace 1``, a traced slice of ``TRACE_DISPATCHES`` more
   dispatches under ``torch.profiler``, with the port's ``Tracer``
   switched on for the slice alone, from and to a synchronised boundary:
   the device's busy time, idle gaps and kernel times.  The host's
   timers and the wall time a dispatch are read from the untraced window
   before it, the device's work from the slice: the profiler slows the
   host, not the device.
4. ``train()`` is stopped at that boundary by :class:`WindowClosed`, the
   program's state is freed, and the plain reference
   (``reference/fm.py``) follows the compared dispatches from the seed;
   ``check.py`` decides ``correct``.

The last line of standard output is the result's JSON; the numbers
compared, each beside its limit, are the last lines of standard error
and the result's last key.  The run exits 1, printing no result, if a
module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``fast_tffm_tpu`` was loaded.  ``--compute-dtype bfloat16`` runs the
control: the port's own bf16 compute path, which the check must find not
correct.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import configparser  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fast_tffm_tpu"})
REPLAY = 3  # dispatches of epoch 1 the check follows
WARM = 2  # dispatches between the check's last reading and the window
TRACE_DISPATCHES = 256
EPOCHS = 1_000_000  # more than any window replays; the run is stopped
OPEN_MARK, CLOSE_MARK = "portbench.slice_open", "portbench.slice_close"


class WindowClosed(KeyboardInterrupt):
    """Ends ``Trainer.train()`` at a dispatch boundary once the run has
    measured what it needs, as an interrupt would: the port's blackbox
    writes no incident bundle for it."""


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``: its entry, its
    configuration and traffic files, and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def cfg_sections(*layers) -> dict:
    """The cfg's ``{section: {key: value}}``, later layers over earlier."""
    out: dict = {}
    for layer in layers:
        for section, keys in (layer or {}).items():
            out.setdefault(section, {}).update(keys)
    return out


def read_metrics(specs: list, ctx: dict) -> dict:
    """Each metric of ``specs`` by its reader, left out where the reader
    finds nothing."""
    out = {}
    for spec in specs:
        reader = importlib.import_module(f"portbench.metrics.{spec['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


def _bench_trainer(Trainer, torch):
    """A ``Trainer`` of the port that takes the check's readings, opens
    and closes the window and the traced slice, and ends ``train()``, all
    at dispatch boundaries; it writes no checkpoint.  Nothing of the
    port's step is changed."""
    from portbench import counts, trace

    class BenchTrainer(Trainer):
        def __init__(self, cfg, device, plan: dict):
            super().__init__(cfg, device=device)
            self.plan = plan
            self.n = 0
            self.mode = "setup"
            self.close_at = None
            self.readings: dict = {"losses": []}
            self.window = self.slice = None
            self._prof = None

        def save(self, stepno):
            return None

        def _sync(self):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def _timers(self):
            tel = self.telemetry
            return (tel.timer("train.wait_input").total_s,
                    tel.timer("train.dispatch").total_s)

        def dispatch(self, sb, pause=None):
            plan = self.plan
            if self.mode == "window" and time.perf_counter() >= self.close_at:
                self._sync()
                t1 = time.perf_counter()
                wait, disp = self._timers()
                w = self.window
                w.update(s=t1 - w["t0"], wait_s=wait - w["wait0"],
                         dispatch_s=disp - w["disp0"],
                         examples=w["steps"] * plan["batch_size"])
                if not plan["trace"]:
                    raise WindowClosed
                self._open_slice()
            if self.mode == "slice" and self.slice["left"] == 0:
                self._close_slice()
                raise WindowClosed
            if self.n == plan["open_at"]:
                self._sync()
                wait, disp = self._timers()
                self.window = {"steps": 0, "dispatches": 0, "wait0": wait,
                               "disp0": disp, "t0": time.perf_counter()}
                self.close_at = self.window["t0"] + plan["seconds"]
                self.mode = "window"
            losses = super().dispatch(sb, pause)
            if self.n < plan["compared"]:
                self._read(losses)
            if self.mode == "window":
                self.window["steps"] += sb.n
                self.window["dispatches"] += 1
            elif self.mode == "slice":
                self.slice["steps"] += sb.n
                self.slice["left"] -= 1
            self.n += 1
            return losses

        def _read(self, losses):
            """The check's readings of the program: each step's loss, the
            parameters after the first dispatch and at the last compared
            one (host copies: the device's peak is not raised)."""
            r = self.readings
            r["losses"].append(losses.detach().clone())
            if self.n == 0:
                self._sync()
                r["table_first"] = self.model.table.detach().to(
                    "cpu", copy=True)
                r["w0_first"] = float(self.model.w0.detach())
            if self.n == self.plan["compared"] - 1:
                self._sync()
                r["losses"] = torch.cat(r["losses"]).tolist()
                r["table_end"] = self.model.table.detach().to(
                    "cpu", copy=True)
                r["w0_end"] = float(self.model.w0.detach())

        def _open_slice(self):
            from torch.profiler import ProfilerActivity, profile, \
                record_function

            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._sync()
            with record_function(OPEN_MARK):
                self.slice = {"steps": 0, "left": TRACE_DISPATCHES,
                              "open_us": time.perf_counter() * 1e6}
            self.tracer.enabled = True
            self.mode = "slice"

        def _close_slice(self):
            from torch.profiler import record_function

            self._sync()
            with record_function(CLOSE_MARK):
                pass
            spans = self.tracer.tail(1 << 21)
            self.tracer.enabled = False
            self._prof.__exit__(None, None, None)
            path = os.path.join(self.plan["tmp"], "profile.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            events = trace.load(path)
            os.remove(path)
            red = trace.reduce_slice(events, OPEN_MARK, CLOSE_MARK,
                                     self.slice["open_us"], spans)
            red["kernel_s"] = trace.kernel_seconds(
                events, counts.KERNELS, red["lo"], red["hi"])
            red["steps"] = self.slice["steps"]
            red["dispatches"] = TRACE_DISPATCHES
            self.slice = red

    return BenchTrainer


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict = None,
             compute_dtype: str = None) -> tuple:
    """One run of the cell ``spec`` (:func:`load_cell`) on ``device``:
    ``(result, checks)``, the result line without its device block
    and ``{name: (reading, limit)}``.  ``overrides`` (``{section: {key:
    value}}``, and ``epoch_lines``) shrink a cell for the tests."""
    import torch
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.train.loop import Trainer

    from portbench import check, gen

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    overrides = dict(overrides or {})
    epoch_lines = int(overrides.pop("epoch_lines",
                                    spec["config"]["epoch_lines"]))
    sections = cfg_sections(spec["config"]["cfg"], spec["traffic"].get("cfg"),
                            overrides)
    flat = {k.lower(): v for keys in sections.values()
            for k, v in keys.items()}
    bs, k = int(flat["batch_size"]), int(flat["steps_per_dispatch"])
    n_batches = epoch_lines // bs
    if epoch_lines % (bs * k):
        raise ValueError(f"epoch 0's {epoch_lines} lines are not a whole "
                         f"number of super-batches of {k} x {bs}")
    tmp = tempfile.mkdtemp(prefix="portbench_")
    try:
        lines = gen.make_lines(spec["config"]["schema"], spec["traffic"],
                               n_batches * bs, seed)
        data = os.path.join(tmp, "train.libsvm")
        lines.write(data)
        parser = configparser.ConfigParser()
        parser.read_dict(sections)
        cfg_path = os.path.join(tmp, "cell.cfg")
        with open(cfg_path, "w") as f:
            parser.write(f)
        over = {"train_files": [data], "validation_files": [],
                "model_file": os.path.join(tmp, "model"), "seed": seed,
                "epoch_num": EPOCHS, "save_steps": 0}
        if compute_dtype:
            over["compute_dtype"] = compute_dtype
        cfg = load_config(cfg_path, over)
        plan = {"compared": n_batches // k + REPLAY,
                "open_at": n_batches // k + REPLAY + WARM,
                "seconds": seconds, "trace": trace, "tmp": tmp,
                "batch_size": bs}
        trainer = _bench_trainer(Trainer, torch)(cfg, device, plan)
        try:
            trainer.train()
        except WindowClosed:
            pass
        else:
            raise RuntimeError("train() ended before the window closed")
        cuda = trainer.device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(trainer.device) if cuda \
            else None
        failed = int(trainer.health.nonfinite_steps)
        program, window, sliced = trainer.readings, trainer.window, \
            trainer.slice
        del trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        ref = check.reference_run(lines, flat, seed, k, REPLAY, device)
        for name, when in (("grad", "first"), ("change", "end")):
            program[name] = {
                "w0": abs(program.pop(f"w0_{when}")),
                "table": check.diff_norm(program.pop(f"table_{when}"),
                                         ref["table_start"])}
        checks = check.compare(program, ref)
        del ref["table_start"]
        ctx = {"setup_s": window["t0"] - T_START, "peak_bytes": peak,
               "window": window, "trace": sliced,
               "shape": {"b": bs, "f": int(flat["max_features"]),
                         "d": 1 + int(flat["factor_num"]),
                         "u_mean": sum(ref["uniques"]) / len(ref["uniques"])}}
        metrics = read_metrics(spec["per_layer" if trace else "end_to_end"],
                               ctx)
        result = {"correct": all(v <= lim for v, lim in checks.values()),
                  "attempted": window["steps"], "failed": failed,
                  "metrics": metrics, "peak_bytes": peak}
        if trace:
            result["breakdown"] = {"device_ops": sliced["device_ops"],
                                   "idle_gaps": sliced["idle_gaps"]}
            result["busy_s"], result["window_s"] = (sliced["busy_s"],
                                                    sliced["window_s"])
            result["ms_per_dispatch"] = {
                "window": 1e3 * window["s"] / window["dispatches"],
                "traced_slice": 1e3 * sliced["window_s"]
                / sliced["dispatches"]}
        return result, checks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                    help="the control: the port's own bf16 compute path")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    import torch

    import fast_tffm_tpu_torch  # noqa: F401  (no port: no run)

    spec = load_cell(args.workload)
    chips = spec["cell"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: the cell needs {chips} CUDA GPU(s), found "
              f"{found}", file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    result, checks = run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), "cuda",
                              compute_dtype=args.compute_dtype)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules the port must not load were loaded: "
              f"{bad}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": result.pop("peak_bytes")}
    if args.trace:
        device["busy_s"] = result.pop("busy_s")
        device["window_s"] = result.pop("window_s")
    result["device"] = device
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
