"""Kernel autotuner: measured promotion of the interaction hot path — the
counterpart of ``fast_tffm_tpu/ops/autotune.py``, under its names.

The port carries the reference's three formulations of the FM
interaction scores and grads (``ops/interaction.py``): ``reference``
(its ``"jnp"`` math, the kernels' plain versions), ``pallas`` (the
hand-written FmScorer / FmGrad CUDA kernels) and ``packed`` (the flat
``[B, F*D]`` layout with one-hot products), plus the int8 gather
forward (``models.fm.fm_scores_dequant``).  Which one is fastest
depends on the run's shapes (batch, F, D), the device and the table
dtype.  This module is the selection mechanism:

- ``resolve(cfg, context=..., device=...)`` maps the
  ``interaction_impl`` knob to a concrete implementation.  Pins
  (``reference`` / ``pallas`` / ``packed``) and the legacy
  ``interaction`` / ``use_pallas`` surface (``""``) never measure;
  ``auto`` benchmarks the candidate set at the run's shapes, keeps only
  candidates that pass an element-wise parity gate against
  ``reference`` (scores AND grads in the train context), and picks the
  fastest survivor.  Off the card a candidate that raises is excluded
  with a parity error of ``inf``, as in the reference.
- Decisions persist in a per-device/shape JSON cache
  (``autotune_cache.json``, the reference's format: version 1,
  ``{"version", "entries"}``) keyed on (context, device type, batch, F,
  D, field_num, table dtype, compute dtype, torch version).  Any drift
  in the key re-measures; a hit skips measurement, so a replica fleet
  and restarts pay nothing.  A save keeps every entry it read, so the
  reference's ``jax…`` entries survive in a cache file the two packages
  share beside a model, and the reference reads the port's file.
- Every decision is observable: a ``record: autotune`` JSONL entry with
  the reference's keys (:func:`write_record`), and ``kernel_impl`` in
  the trainer's run header and the server's record block.

Where the port differs from the reference:

- **Devices are explicit.**  :func:`default_candidates` gives
  ``("reference",)`` for FFM and on the CPU (reference wins there at
  zero measurement cost, as off a TPU in the reference), and all three
  on a CUDA device: the card takes the TPU's place.
- **A candidate is timed the way its path runs it.**  On the card the
  train context is timed as the replay of a CUDA graph of one forward
  and backward (the host-sort training path is graphed,
  ``train/dispatch.py``); its eager times are kept beside
  (``Decision.eager_ms``).  The serve context is timed eagerly, as the
  scorer's rungs run.  The CPU is never measured unless a caller forces
  a candidate set (tests, ``tools/autotune.py --check``).
- **A hand-written kernel is never dropped on the card.**  On a CUDA
  device with ``pallas`` among the candidates, a candidate that raises
  in its run or its timing, or a ``pallas`` that fails the parity gate,
  makes the measurement raise with the candidate's name: ``auto`` never
  trains or serves on a plain version, or caches one, because a kernel
  failed.  Only where no hand-written kernel is a candidate (the CPU, a
  forced ``("reference", "packed")`` set) is a failed candidate
  excluded as in the reference; a ``packed`` that fails the gate is
  excluded everywhere, as the gate is there for.

Offline: ``python -m fast_tffm_tpu_torch.tools.autotune <cfg>``
pre-populates the cache; ``--check`` validates the invariants.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

log = logging.getLogger(__name__)

__all__ = [
    "Decision", "resolve", "write_record", "default_candidates",
    "cache_key", "default_cache_path", "load_cache", "save_cache",
    "measurement_count", "PARITY_TOL", "INTERNAL", "USER",
]

# User-facing impl name -> ops.interaction dispatch name.  "packed" is
# the flat [B, F*D] one-hot-product layout (ops.interaction.scores_flat).
INTERNAL = {"reference": "jnp", "pallas": "pallas", "packed": "flat"}
USER = {v: k for k, v in INTERNAL.items()}

# Element-wise parity gate: a candidate whose scores or grads drift
# beyond TOL * max(1, |reference|_max) from reference is rejected no
# matter how fast it measured (the reference's value).
PARITY_TOL = 2e-3

# The candidates that are hand-written kernels (FmScorer / FmGrad).
_KERNEL_IMPLS = ("pallas",)

# Bumped once per candidate actually benchmarked: tests pin cache hits,
# pins and single-candidate resolutions to "skips measurement".
_MEASUREMENTS = 0

_CACHE_VERSION = 1
_MEM_CACHE: dict = {}  # in-process cache (works with cache_path="")


def measurement_count() -> int:
    """How many candidate benchmarks ran in this process."""
    return _MEASUREMENTS


@dataclasses.dataclass
class Decision:
    """One interaction-impl selection, however it was reached."""

    impl: str  # user-facing: reference | pallas | packed
    interaction: str  # ops.interaction dispatch name: jnp | pallas | flat
    source: str  # pinned | legacy | single_candidate | cache | measured
    context: str  # train | serve
    key: str  # the cache key (empty for pins/legacy)
    candidates: tuple = ()
    times_ms: dict = dataclasses.field(default_factory=dict)
    parity_err: dict = dataclasses.field(default_factory=dict)
    cache_file: str = ""
    # The port's own: a measured train context's eager times beside its
    # graphed ``times_ms`` on the card, and the measurement's seconds.
    eager_ms: dict = dataclasses.field(default_factory=dict)
    measure_s: float = 0.0


# ---------------------------------------------------------------- keys


def cache_key(context: str, backend: str, batch: int, features: int,
              dim: int, field_num: int, table_dtype: str,
              compute_dtype: str, torch_version: str | None = None) -> str:
    """The persistent-cache key: every axis that can change the winner.
    A drift in ANY component (shape, dtype, device type, torch version)
    is a miss.  The reference's last part is ``jax<version>``, so the
    two packages' entries never collide in a shared file."""
    if torch_version is None:
        import torch

        torch_version = torch.__version__
    return "|".join((
        context, backend, f"b{int(batch)}", f"f{int(features)}",
        f"d{int(dim)}", f"p{int(field_num)}", table_dtype,
        compute_dtype, f"torch{torch_version}",
    ))


def default_cache_path(cfg) -> str:
    """Where the persistent cache lives for this run: the
    ``FAST_TFFM_AUTOTUNE_CACHE`` env override (empty string = memory
    only), else beside ``compile_cache_dir``, else next to the model
    checkpoint (the serve fleet reads the same file)."""
    env = os.environ.get("FAST_TFFM_AUTOTUNE_CACHE")
    if env is not None:
        return env
    if getattr(cfg, "compile_cache_dir", ""):
        return os.path.join(cfg.compile_cache_dir, "autotune_cache.json")
    if getattr(cfg, "model_file", ""):
        d = os.path.dirname(os.path.abspath(cfg.model_file))
        return os.path.join(d, "autotune_cache.json")
    return ""


def load_cache(path: str) -> dict:
    """Read a cache file; corruption or absence is an empty cache (the
    autotuner re-measures, never crashes)."""
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("version") != _CACHE_VERSION:
            return {}
        entries = doc.get("entries")
        return entries if isinstance(entries, dict) else {}
    except (OSError, ValueError) as e:
        log.warning("autotune cache %s unreadable (%s); re-measuring",
                    path, e)
        return {}


def save_cache(path: str, entries: dict) -> None:
    """Atomic write (tmp + rename): a killed run never leaves a torn
    cache behind."""
    if not path:
        return
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": _CACHE_VERSION, "entries": entries},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError as e:  # persistence is an optimization, not a need
        log.warning("autotune cache write to %s failed: %s", path, e)


# ---------------------------------------------------------- candidates


def default_candidates(field_num: int, device) -> tuple:
    """The candidate set on ``device``.  FFM (``field_num > 0``) always
    runs its closed-form op, so reference is its only candidate; so it is
    on the CPU, where reference wins at zero measurement.  On a CUDA
    device every selectable impl enters measurement."""
    import torch

    if field_num or torch.device(device).type != "cuda":
        return ("reference",)
    return ("reference", "pallas", "packed")


def _candidate_fns(cfg, context: str, batch: int, table_dtype: str,
                   device):
    """``(make_fn, args)``: ``make_fn(user_impl)`` returns a callable of
    ``args`` (tensors on ``device``) whose outputs are element-wise
    comparable across impls.  The inputs are the reference's draw: the
    same generator, order, shapes and dtypes.

    Train context: the scores and the rows' gradient of their sum
    through ``ops.interaction.FmInteraction`` (forward and closed-form
    backward), the step's hot pair.  Serve context: gather and score
    over a ``min(V, 2^14)``-row table in fp32, bf16, or int8 through
    ``models.fm.fm_scores_dequant``, what a rung runs."""
    import numpy as np
    import torch

    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.ops import interaction

    b, feat, dim = int(batch), cfg.max_features, cfg.embedding_dim
    rng = np.random.default_rng(0xA070)
    vals_np = rng.uniform(0.1, 1.0, (b, feat)).astype(np.float32)
    vals = torch.from_numpy(vals_np).to(device)

    if context == "train":
        rows = torch.from_numpy(
            rng.uniform(-0.1, 0.1, (b, feat, dim)).astype(np.float32)
        ).to(device)

        def make(user_impl):
            impl = INTERNAL[user_impl]

            def f(r, v):
                leaf = r.detach().requires_grad_()
                with torch.enable_grad():
                    scores = interaction.fm_interaction(leaf, v, impl)
                    (grads,) = torch.autograd.grad(scores.sum(), leaf)
                return scores.detach(), grads

            return f

        return make, (rows, vals)

    # serve: gather + score over a representative table slice (capped:
    # the gather's cost scales with the batch, not the vocabulary).
    vocab = min(cfg.vocabulary_size, 1 << 14)
    table = rng.uniform(-0.1, 0.1, (vocab, dim)).astype(np.float32)
    ids = torch.from_numpy(
        rng.integers(0, vocab, (b, feat)).astype(np.int32)).to(device)
    w0 = torch.zeros((), dtype=torch.float32, device=device)

    if table_dtype == "int8":
        from fast_tffm_tpu_torch.ops import quant

        qt = quant.quantize_table(table, "int8", cfg.quant_chunk)
        codes = torch.from_numpy(qt.codes).to(device)
        scales = torch.from_numpy(
            np.asarray(qt.scales, np.float32)).to(device)
        chunk = int(qt.chunk)

        def make(user_impl):
            impl = INTERNAL[user_impl]

            def f(i, v):
                return fm.fm_scores_dequant(
                    w0, codes, scales, chunk, i, v, None,
                    factor_num=cfg.factor_num, field_num=0, impl=impl)

            return f

        return make, (ids, vals)

    tbl = torch.from_numpy(table).to(device)
    if table_dtype == "bf16":
        tbl = tbl.to(torch.bfloat16)

    def make(user_impl):
        impl = INTERNAL[user_impl]

        def f(i, v):
            # The scorer's gather: compact rows, widened to f32 before
            # the interaction (serve/scorer.py::FixedShapeScorer).
            rows = tbl.index_select(0, i.reshape(-1)).view(b, feat, dim)
            return fm.scores_from_rows(w0, rows, v, None,
                                       factor_num=cfg.factor_num,
                                       field_num=0, impl=impl)

        return f

    return make, (ids, vals)


def _flat_outputs(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _parity_error(out, ref_out) -> float:
    """Max element-wise |candidate - reference| over every output,
    relative to max(1, |reference|_max), in float64."""
    import numpy as np

    worst = 0.0
    for a, b in zip(_flat_outputs(out), _flat_outputs(ref_out)):
        a = np.asarray(_host(a), np.float64)
        b = np.asarray(_host(b), np.float64)
        scale = max(1.0, float(np.max(np.abs(b))) if b.size else 1.0)
        worst = max(worst, float(np.max(np.abs(a - b))) / scale)
    return worst


def _host(t):
    import torch

    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else t


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _graphed(fn, args):
    """``fn(*args)`` captured as one CUDA graph (``ops/launches.py``):
    returns a callable that replays it and counts its launches."""
    import torch

    from fast_tffm_tpu_torch.ops import launches

    # Warm on a side stream first, as a capture wants its lazy set-up
    # (the cuBLAS workspace of the flat products among it) done outside.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph, _, counted = launches.capture(lambda: fn(*args))

    def replay(*_):
        graph.replay()
        launches.add_counts(counted)

    return replay


def _must_run(names, device) -> bool:
    """True when a failed candidate raises instead of being excluded: on
    a CUDA device with a hand-written kernel among ``names``."""
    import torch

    return torch.device(device).type == "cuda" and any(
        n in _KERNEL_IMPLS for n in names)


def _time_ms(fn, args, device, reps: int = 3, inner: int = 5) -> float:
    """Best-of-``reps`` mean wall time per call (ms), after a warm call,
    synchronised with the device."""
    best = float("inf")
    fn(*args)
    _sync(device)
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn(*args)
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / inner)
    return best * 1000.0


def _measure(cfg, context: str, batch: int, table_dtype: str,
             candidates, device, candidate_fns=None):
    """Benchmark every candidate at the run's shapes; returns
    ``(winner, times_ms, parity_err, eager_ms)``.  Reference is always
    the parity oracle and always survives the gate.  On a CUDA device
    the train context's ``times_ms`` are graph replays and ``eager_ms``
    its eager calls; elsewhere ``eager_ms`` is empty.  Where
    :func:`_must_run`, a candidate that raises, or a hand-written one
    that fails the gate, raises ``RuntimeError`` naming it."""
    global _MEASUREMENTS
    import torch

    if candidate_fns is None:
        make, args = _candidate_fns(cfg, context, batch, table_dtype,
                                    device)
    else:
        make, args = candidate_fns
    graphed = context == "train" and torch.device(device).type == "cuda"
    names = list(candidates)
    if "reference" not in names:
        names.insert(0, "reference")
    strict = _must_run(names, device)
    ref_fn = make("reference")
    ref_out = ref_fn(*args)
    _sync(device)
    times_ms: dict = {}
    eager_ms: dict = {}
    parity: dict = {}
    survivors = []
    for name in names:
        fn = ref_fn if name == "reference" else make(name)
        try:
            out = fn(*args)
            _sync(device)
        except Exception as e:  # noqa: BLE001 - a broken candidate loses
            if strict:
                raise RuntimeError(
                    f"autotune candidate {name} failed to run on {device} "
                    f"({type(e).__name__}: {e}); a hand-written kernel is "
                    f"a candidate, so none is excluded") from e
            log.warning("autotune candidate %s failed to run (%s: %s); "
                        "excluded", name, type(e).__name__, e)
            parity[name] = float("inf")
            continue
        _MEASUREMENTS += 1
        err = 0.0 if name == "reference" else _parity_error(out, ref_out)
        parity[name] = round(err, 9)
        if err > PARITY_TOL:
            if strict and name in _KERNEL_IMPLS:
                raise RuntimeError(
                    f"autotune candidate {name} failed the parity gate on "
                    f"{device} (err {err:.3g} > {PARITY_TOL:.3g}): the "
                    f"hand-written kernel disagrees with its plain version")
            log.warning(
                "autotune candidate %s FAILED the parity gate "
                "(err %.3g > %.3g) and is excluded from selection",
                name, err, PARITY_TOL,
            )
            continue
        try:
            if graphed:
                eager_ms[name] = round(_time_ms(fn, args, device), 4)
                times_ms[name] = round(
                    _time_ms(_graphed(fn, args), args, device), 4)
            else:
                times_ms[name] = round(_time_ms(fn, args, device), 4)
        except Exception as e:  # noqa: BLE001 - a broken candidate loses
            if strict:
                raise RuntimeError(
                    f"autotune candidate {name} failed to time on {device} "
                    f"({type(e).__name__}: {e}); a hand-written kernel is "
                    f"a candidate, so none is excluded") from e
            log.warning("autotune candidate %s failed to time (%s: %s); "
                        "excluded", name, type(e).__name__, e)
            parity[name] = float("inf")
            times_ms.pop(name, None)
            eager_ms.pop(name, None)
            continue
        survivors.append(name)
    winner = min(survivors, key=lambda n: times_ms[n])
    return winner, times_ms, parity, eager_ms


# ------------------------------------------------------------- resolve


def resolve(cfg, *, context: str = "train", batch: int | None = None,
            writer=None, cache_path: str | None = None,
            candidates=None, table_dtype: str | None = None,
            torch_version: str | None = None,
            candidate_fns=None, device=None) -> Decision:
    """Map ``cfg.interaction_impl`` to a concrete implementation on
    ``device`` (None: the GPU, as every entry point).

    Pins and the legacy surface never measure.  ``auto`` measures only
    when the candidate set has more than one entry AND the persistent
    cache has no valid entry for this exact key.  ``writer`` (a JSONL
    writer) gets one ``record: autotune`` entry per decision.

    ``candidates`` / ``candidate_fns`` / ``torch_version`` exist for
    tests and the offline tool: forcing a multi-candidate measurement on
    the CPU, injecting a deliberately wrong candidate at the parity gate,
    and exercising key drift without a torch upgrade.
    """
    from fast_tffm_tpu_torch.platform import resolve_device

    device = resolve_device(device)
    knob = cfg.interaction_impl
    if batch is None:
        batch = cfg.batch_size
    if table_dtype is None:
        table_dtype = (
            cfg.serve_table_dtype if context == "serve" else "fp32"
        )
    if knob in ("reference", "pallas", "packed"):
        d = Decision(impl=knob, interaction=INTERNAL[knob],
                     source="pinned", context=context, key="")
    elif knob != "auto":  # "" — the legacy interaction/use_pallas surface
        internal = cfg.interaction_resolved
        d = Decision(impl=USER.get(internal, "reference"),
                     interaction=internal, source="legacy",
                     context=context, key="")
    else:
        cands = tuple(
            candidates if candidates is not None
            else default_candidates(cfg.field_num, device)
        )
        key = cache_key(
            context, device.type, batch, cfg.max_features,
            cfg.embedding_dim, cfg.field_num, table_dtype,
            cfg.compute_dtype, torch_version,
        )
        if cache_path is None:
            cache_path = default_cache_path(cfg)
        if len(cands) == 1:
            d = Decision(impl=cands[0], interaction=INTERNAL[cands[0]],
                         source="single_candidate", context=context,
                         key=key, candidates=cands,
                         cache_file=cache_path)
        else:
            entries = dict(_MEM_CACHE)
            entries.update(load_cache(cache_path))
            hit = entries.get(key)
            if (
                isinstance(hit, dict)
                and hit.get("impl") in INTERNAL
                and tuple(hit.get("candidates", ())) == cands
            ):
                d = Decision(
                    impl=hit["impl"], interaction=INTERNAL[hit["impl"]],
                    source="cache", context=context, key=key,
                    candidates=cands,
                    times_ms=dict(hit.get("times_ms") or {}),
                    parity_err=dict(hit.get("parity_err") or {}),
                    cache_file=cache_path,
                )
            else:
                t0 = time.perf_counter()
                winner, times_ms, parity, eager_ms = _measure(
                    cfg, context, batch, table_dtype, cands, device,
                    candidate_fns=candidate_fns,
                )
                d = Decision(
                    impl=winner, interaction=INTERNAL[winner],
                    source="measured", context=context, key=key,
                    candidates=cands, times_ms=times_ms,
                    parity_err=parity, cache_file=cache_path,
                    eager_ms=eager_ms,
                    measure_s=time.perf_counter() - t0,
                )
                entry = {
                    "impl": winner, "candidates": list(cands),
                    "times_ms": times_ms, "parity_err": parity,
                    "written": time.time(),
                }
                _MEM_CACHE[key] = entry
                entries[key] = entry
                save_cache(cache_path, entries)
    log.info(
        "autotune[%s]: interaction_impl=%s -> %s (%s)%s",
        context, knob or "<legacy>", d.impl, d.source,
        (f" times_ms={d.times_ms} in {d.measure_s:.3f}s"
         if d.source == "measured" else ""),
    )
    if writer is not None:
        write_record(writer, d)
    return d


def write_record(writer, d: Decision) -> None:
    """One ``record: autotune`` JSONL entry per decision, with the
    reference's keys."""
    try:
        writer.write({
            "record": "autotune",
            "time": time.time(),
            "impl": d.impl,
            "source": d.source,
            "context": d.context,
            "key": d.key,
            "candidates": list(d.candidates),
            "times_ms": d.times_ms,
            "parity_err": d.parity_err,
        })
    except Exception as e:  # noqa: BLE001 - never kill a run over a record
        log.warning("autotune record write failed: %s", e)
