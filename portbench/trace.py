"""The reduction from a traced slice to numbers: the profiler's Chrome
trace (``torch.profiler`` ``export_chrome_trace``) and the port's own
``Tracer`` spans, cut to the slice between two markers the harness
records with ``record_function``.

- device busy time is the length of the UNION of the device's intervals
  (kernels, copies, memsets on every stream), so the copy stream's work
  under the compute stream's counts once;
- the idle gaps are the holes in that union inside the slice, each
  labelled by what the training thread was doing at its midpoint: the
  innermost of the port's ``Tracer`` spans (``train.wait_input``,
  ``train.dispatch``, ...; ``between spans`` outside them), placed on the
  profiler's clock by the marker's own ``perf_counter`` reading, and of
  the profiler's host events of that thread (CUDA runtime calls, ATen
  ops; ``python`` where none runs: the interpreter's own work, numpy);
- a kernel's time is the summed duration of its events, found by its
  CUDA name.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["DEVICE_CATS", "kernel_seconds", "load", "reduce_slice",
           "union"]

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
_HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}


def load(path: str) -> list:
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def union(starts: np.ndarray, ends: np.ndarray, lo: float,
          hi: float) -> tuple:
    """``(covered length, [(gap start, gap end), ...])`` of the intervals
    clipped to ``[lo, hi]``."""
    s = np.clip(np.asarray(starts, float), lo, hi)
    e = np.clip(np.asarray(ends, float), lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    order = np.argsort(s, kind="stable")
    covered, gaps, cur = 0.0, [], lo
    run_s = run_e = None
    for a, b in zip(s[order].tolist(), e[order].tolist()):
        if run_e is not None and a <= run_e:
            run_e = max(run_e, b)
            continue
        if run_e is not None:
            covered += run_e - run_s
            cur = run_e
        if a > cur:
            gaps.append((cur, a))
        run_s, run_e = a, b
    if run_e is not None:
        covered += run_e - run_s
        cur = run_e
    if hi > cur:
        gaps.append((cur, hi))
    return covered, gaps


def kernel_seconds(events: list, names, lo: float, hi: float) -> dict:
    """Summed seconds of the kernel events inside ``[lo, hi]`` whose name
    holds each of ``names``."""
    out = {name: 0.0 for name in names}
    for ev in events:
        if ev.get("cat", "").lower() != "kernel":
            continue
        if not lo <= ev["ts"] <= hi:
            continue
        for name in names:
            if name in ev["name"]:
                out[name] += ev.get("dur", 0.0) * 1e-6
    return out


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].strip()[:60]


def _labels(mids: list, spans: list, none: str) -> list:
    """For each of the ascending ``mids``, the name of the innermost of
    ``spans`` (``(start, end, name)``, nested as one thread's are) that
    holds it, or ``none``: one sweep with a stack of open spans."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, j = [], [], 0
    for m in mids:
        while j < len(spans) and spans[j][0] <= m:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        out.append(stack[-1][2] if stack else none)
    return out


def reduce_slice(events: list, open_name: str, close_name: str,
                 open_perf_us: float, tracer_events: list) -> dict:
    """The slice between the ``open_name`` and ``close_name`` markers:
    ``window_s``, ``busy_s``, the top device ops and the idle gaps by
    label (each at most 10, ``[name, seconds]``), and the kernel events.
    ``open_perf_us`` is ``perf_counter`` (µs) read inside the open
    marker, which places ``tracer_events`` on the profiler's clock."""
    marks = {ev["name"]: ev for ev in events
             if ev.get("cat") == "user_annotation"
             and ev["name"] in (open_name, close_name)}
    lo, hi = marks[open_name]["ts"], marks[close_name]["ts"]
    tid = marks[open_name].get("tid")
    dev = [ev for ev in events
           if ev.get("cat", "").lower() in DEVICE_CATS and "dur" in ev
           and ev["ts"] < hi and ev["ts"] + ev["dur"] > lo]
    starts = np.array([ev["ts"] for ev in dev], float)
    ends = starts + np.array([ev["dur"] for ev in dev], float)
    busy, gaps = union(starts, ends, lo, hi)
    by_op: dict = {}
    for ev in dev:
        name = _short(ev["name"])
        by_op[name] = by_op.get(name, 0.0) + ev["dur"] * 1e-6
    offset = lo - open_perf_us
    loop = [(ev["ts"] + offset, ev["ts"] + offset + ev.get("dur", 0),
             ev["name"]) for ev in tracer_events
            if ev.get("ph") == "X" and ev["name"].startswith("train.")]
    host = [(ev["ts"], ev["ts"] + ev.get("dur", 0), _short(ev["name"]))
            for ev in events
            if ev.get("cat") in _HOST_CATS and ev.get("tid") == tid
            and "dur" in ev and ev["ts"] < hi and ev["ts"] + ev["dur"] > lo
            and ev["name"] not in (open_name, close_name)]
    mids = [0.5 * (a + b) for a, b in gaps]
    by_gap: dict = {}
    for (a, b), outer, inner in zip(
            gaps, _labels(mids, loop, "between spans"),
            _labels(mids, host, "python")):
        label = f"{outer} / {inner}"
        by_gap[label] = by_gap.get(label, 0.0) + (b - a) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle],
            "lo": lo, "hi": hi}
