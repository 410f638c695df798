#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fast_tffm_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check ends the run with a non-zero exit:

1. Print the card's name and power limit (``nvidia-smi``).
2. Build every CUDA kernel from ``fast_tffm_tpu_torch/ops/csrc`` with
   ``nvcc`` for ``sm_90a`` and time the build.
3. Kernel phase: hold ``fm_scores_cuda`` against ``fm_scores_plain`` on
   the card at B in {1, 64, 1000, 1024}, F=39, D=9, and time both at the
   largest serving rung.
4. Serve phase (the main path): write random Criteo-Kaggle-width weights
   (``examples/criteo_kaggle.cfg``: V=2^22, F=39, D=9, logistic loss,
   ladder 64/256/1024) to ``params.npz``, start ``serve()`` on port 0,
   send ``/score`` (libsvm text) and ``/score_bin`` (binary frame)
   requests covering every rung plus one larger than the largest rung,
   and check that the two transports agree bitwise, that the scores
   match the plain PyTorch path computed on the card, that out-of-range
   ids are reduced like the text path reduces them, and that the kernel
   ran.  Time request latency and per-rung dispatch.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without a CUDA GPU or without the package
beside this script.
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CFG_PATH = os.path.join(REPO, "examples", "criteo_kaggle.cfg")
SEED = 20261016
# NVIDIA H100 SXM data sheet peaks (at the full 700 W power limit):
# HBM3 bandwidth and the non-tensor-core float32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Kernel vs plain: both accumulate in f32 and differ only in summation
# order and FMA contraction; at these inputs (|rows| ~ 0.3, 39 features)
# that is a few f32 ulps of |s1^2| and |s2| (~3), i.e. below 1e-5.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# Served scores vs the plain path on the card: the repo's FmScorer
# tolerance (tests/test_pallas_ops.py); the sigmoid only shrinks errors.
SERVE_TOL = dict(rtol=1e-5, atol=1e-6)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0].strip()


def p50(xs) -> float:
    xs = sorted(xs)
    return xs[(len(xs) - 1) // 2]


def graph_ms(torch, fn, calls: int = 100, reps: int = 7) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    the graph replayed between CUDA events, the median of ``reps``
    replays over ``calls``.  The replay issues the launches itself, so
    the Python host cost of a call is out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return p50(times)


def time_per_call_ms(torch, fn, iters: int = 200, warm: int = 20) -> float:
    """CUDA-event time per call over a loop of eager calls (device
    timeline, so it includes whatever host issue time the loop cannot
    hide)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_times_ms(torch, fn, iters: int = 50):
    """Per-call device time by op from torch.profiler over ``iters``
    calls, plus the host wall per call: ``({name: ms}, wall_ms)``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {}
    for ev in prof.key_averages():
        # Device-side activities only (kernels, copies): the aten::
        # host ops report their kernels' time again as their own.
        if ev.key.startswith("aten::") or "Activity Buffer" in ev.key:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and dev_us > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0].strip()[:60]
            out[name] = out.get(name, 0.0) + dev_us / 1e3 / iters
    return out, wall * 1e3 / iters


def fm_bound_ms(b: int, f: int, d: int):
    """Least time for the FmScorer forward on these shapes: every input
    byte read once and every output byte written once over HBM
    bandwidth, vs its f32 operations over the f32 rate."""
    k = d - 1
    nbytes = 4 * (b * f * d + b * f + b + b * k)
    ops = b * (f * (2 + 4 * k) + 3 * k + 2)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def criteo_body(rng, n: int) -> str:
    """``n`` label-less libsvm lines shaped like hashed Criteo-Kaggle
    rows: 13 integer features ``I<j>_<bucket>:<value>`` and 26
    categorical ``C<j>_<hex>:1`` tokens (39 features per line)."""
    lines = []
    for _ in range(n):
        ints = rng.integers(0, 50, 13)
        ivals = rng.uniform(0.0, 3.0, 13)
        cats = rng.integers(0, 1 << 32, 26)
        toks = [f"I{j + 1}_{ints[j]}:{ivals[j]:.4f}" for j in range(13)]
        toks += [f"C{j + 1}_{cats[j]:08x}:1" for j in range(26)]
        lines.append(" ".join(toks))
    return "\n".join(lines) + "\n"


def post(conn, path: str, body: bytes) -> bytes:
    conn.request("POST", path, body=body,
                 headers={"Content-Length": str(len(body))})
    resp = conn.getresponse()
    data = resp.read()
    check(resp.status == 200, f"{path} answered {resp.status}: {data[:200]!r}")
    return data


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible to PyTorch; this smoke "
              "runs only on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.ops import _build
    from fast_tffm_tpu_torch.ops.fm_kernels import (
        fm_scores_cuda, fm_scores_plain,
    )
    from fast_tffm_tpu_torch.serve import wire
    from fast_tffm_tpu_torch.serve.server import serve
    from fast_tffm_tpu_torch.serve.textparse import parse_request
    from fast_tffm_tpu_torch.train import checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # -- build ---------------------------------------------------------
    t0 = time.perf_counter()
    log = _build.build(force=True)
    build_s = time.perf_counter() - t0
    _build.load()
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"ptxas: {line.strip()}")
    print(f"build: {build_s:.3f} s ({card})", flush=True)

    # -- kernel phase --------------------------------------------------
    cfg = load_config(CFG_PATH, {"serve_poll_secs": 0.0, "serve_port": 0})
    F, D = cfg.max_features, cfg.embedding_dim
    check((cfg.vocabulary_size, F, D) == (1 << 22, 39, 9),
          f"unexpected Criteo-Kaggle shape {cfg.vocabulary_size, F, D}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    # The ladder's rungs (the shapes the main path gives the kernel),
    # one example, and a size that is no multiple of the block's four.
    checked = (1, 64, 256, 1000, 1024)
    for b in checked:
        rows = torch.randn((b, F, D), generator=gen, device=dev) * 0.3
        vals = torch.rand((b, F), generator=gen, device=dev)
        # Padded tails of random length, like real requests.
        lens = torch.randint(1, F + 1, (b, 1), generator=gen, device=dev)
        vals = vals * (torch.arange(F, device=dev)[None, :] < lens)
        s_k, s1_k = fm_scores_cuda(rows, vals)
        s_p, s1_p = fm_scores_plain(rows, vals)
        torch.cuda.synchronize()
        torch.testing.assert_close(s_k, s_p, **KERNEL_TOL)
        torch.testing.assert_close(s1_k, s1_p, **KERNEL_TOL)
        max_err = max(max_err, float((s_k - s_p).abs().max()),
                      float((s1_k - s1_p).abs().max()))
    print(f"kernel check: fm_scores_cuda == fm_scores_plain at B in "
          f"{checked}, max_abs_err={max_err:.3e}", flush=True)

    # Timing at the largest rung, in turns (plain, kernel, kernel, plain).
    b_main = max(cfg.serve_ladder)
    rows = torch.randn((b_main, F, D), generator=gen, device=dev) * 0.3
    vals = torch.rand((b_main, F), generator=gen, device=dev)
    kern = lambda: fm_scores_cuda(rows, vals)  # noqa: E731
    plain = lambda: fm_scores_plain(rows, vals)  # noqa: E731
    plain_a, kern_a, kern_b, plain_b = (graph_ms(torch, fn) for fn in
                                        (plain, kern, kern, plain))
    kern_ms, plain_ms = min(kern_a, kern_b), min(plain_a, plain_b)
    kern_dev, _ = device_times_ms(torch, kern)
    kern_dev_ms = sum(v for k, v in kern_dev.items() if "fm_scores" in k)
    bound_ms, bound_by = fm_bound_ms(b_main, F, D)
    per_rung = {}
    for b in cfg.serve_ladder:
        r_b, v_b = rows[:b].contiguous(), vals[:b].contiguous()
        per_rung[b] = {
            "graph_ms": graph_ms(torch, lambda: fm_scores_cuda(r_b, v_b)),
            "eager_call_ms": time_per_call_ms(
                torch, lambda: fm_scores_cuda(r_b, v_b)
            ),
            "bound_ms": fm_bound_ms(b, F, D)[0],
        }
    print(json.dumps({"kernel_timing": {
        "card": card, "B": b_main, "graph_ms": [kern_a, kern_b],
        "plain_graph_ms": [plain_a, plain_b],
        "profiler_device_ms": kern_dev_ms, "bound_ms": bound_ms,
        "eager_call_ms": time_per_call_ms(torch, kern),
        "plain_eager_call_ms": time_per_call_ms(torch, plain),
        "per_rung": per_rung,
    }}), flush=True)

    # -- serve phase (main path) ---------------------------------------
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg = load_config(CFG_PATH, {
            "serve_poll_secs": 0.0, "serve_port": 0, "model_file": tmp,
        })
        model = fm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev
        )
        checkpoint.save_params(tmp, model, step=1)
        del model
        _, ref = checkpoint.restore_params(tmp, device=dev)

        fm_scores_cuda.launches = 0  # count the main path only
        handle = serve(cfg, port=0)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                              timeout=120)
            # Request sizes: one per rung (64, 256, 1024) and one larger
            # than the largest rung, which the scorer splits.
            sizes = (1, 37, 200, 1000, 1500)
            served = []
            for n in sizes:
                body = criteo_body(rng, n)
                text = post(conn, "/score", body.encode()).decode()
                ids, vals_np, _, got_n, trunc = parse_request(body, cfg)
                check(got_n == n and trunc == 0, f"parse of {n} lines")
                frame = wire.encode_bin_request(ids, vals_np)
                bin_scores = wire.decode_bin_response(
                    post(conn, "/score_bin", frame)
                )
                check(bin_scores.shape == (n,), f"{n} binary scores")
                check(text == "".join(f"{s:.6f}\n" for s in bin_scores),
                      f"/score and /score_bin disagree at n={n}")
                served.append((ids, vals_np, bin_scores))
            # Unreduced ids (>= V and negative) reduce modulo V exactly
            # like the text path; on the card an unreduced id would be
            # a device-side assert.
            ids, vals_np, want = served[2]
            wild = ids.astype(np.int64)
            wild[::2] += 3 * cfg.vocabulary_size
            wild[1::2] -= cfg.vocabulary_size
            got = wire.decode_bin_response(post(
                conn, "/score_bin",
                wire.encode_bin_request(wild.astype(np.int32), vals_np),
            ))
            check(np.array_equal(got, want),
                  "out-of-range ids did not reduce modulo the vocabulary")

            # Request latency on the card, keep-alive, one client.
            latency = {}
            for n in (1, 1024):
                body = criteo_body(rng, n).encode()
                ids, vals_np, _, _, _ = parse_request(body.decode(), cfg)
                frame = wire.encode_bin_request(ids, vals_np)
                for path, payload in (("/score", body),
                                      ("/score_bin", frame)):
                    times = []
                    for _ in range(20):
                        t0 = time.perf_counter()
                        post(conn, path, payload)
                        times.append(time.perf_counter() - t0)
                    latency[f"{path}_n{n}_p50_ms"] = p50(times) * 1e3
            conn.close()
            # The main path ends here; the launches below only time it.
            launches = fm_scores_cuda.launches

            # Dispatch time per rung, straight through the scorer.
            scorer = handle.scorer
            ids_all, vals_all, _ = served[-1]
            dispatch = {}
            for b in scorer.ladder:
                times = []
                for _ in range(50):
                    t0 = time.perf_counter()
                    scorer.score_rung(ids_all[:b], vals_all[:b], None, b)
                    times.append(time.perf_counter() - t0)
                dispatch[b] = p50(times) * 1e3
            ids_b, vals_b = ids_all[:b_main], vals_all[:b_main]
            breakdown, wall_ms = device_times_ms(
                torch,
                lambda: scorer.score_rung(ids_b, vals_b, None, b_main),
            )
        finally:
            handle.close()

        check(launches > 0, "the serve path never launched the kernel")
        # Served scores vs the plain path on the card, same weights.
        with torch.inference_mode():
            for ids, vals_np, got in served:
                ids_t = torch.from_numpy(ids).to(dev).long()
                rows_t = ref.table[ids_t]
                s, _ = fm_scores_plain(rows_t, torch.from_numpy(vals_np)
                                       .to(dev))
                want_t = torch.sigmoid(ref.w0 + s).cpu()
                torch.testing.assert_close(torch.from_numpy(got), want_t,
                                           **SERVE_TOL)
                check(bool(np.isfinite(got).all()), "non-finite score")
    busy = sum(breakdown.values())
    print(json.dumps({"serve": {
        "card": card, "requests": sizes, "kernel_launches": launches,
        "dispatch_p50_ms": dispatch, "latency_p50_ms": latency,
        "rung_1024_device_ms": breakdown, "rung_1024_wall_ms": wall_ms,
        "rung_1024_device_idle_frac": max(0.0, 1.0 - busy / wall_ms),
    }}), flush=True)
    print("serve check: transports agree bitwise, scores match the plain "
          "path on the card, out-of-range ids reduce", flush=True)

    print(json.dumps({"kernels": [{
        "name": "fm_scores",
        "route": "cuda",
        "source": "fast_tffm_tpu_torch/ops/csrc/fm_scorer.cu",
        "replaces": "fast_tffm_tpu/ops/fm_pallas.py:110",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
