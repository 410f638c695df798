"""Fixed-shape scorers: the serving path's device half.

The counterpart of ``fast_tffm_tpu/serve/scorer.py``.  Online traffic
arrives at arbitrary sizes; a scorer pins a small LADDER of microbatch
shapes (``{64, 256, 1024}`` examples x ``max_features`` by default,
``serve_batch_sizes``) and pads every request or chunk up to the
smallest rung that holds it, so every dispatch runs at one of a few
fixed shapes.  Each rung keeps its own staging buffers: pinned host
``ids``/``vals`` (and ``fields`` for field-aware FM) the caller's arrays
are copied into, their device twins, and a pinned host output.  A
dispatch is: non-blocking host-to-device copies, a gather of the rows,
the FmScorer kernel (``ops.interaction.forward``) or, with ``field_num >
0``, the FFM einsums (``models.fm.ffm_scores_from_rows``), ``+ w0``,
``sigmoid`` for logistic loss, a non-blocking device-to-host copy, then
a wait on that copy: the score goes back to a client, so the copy back
is part of the dispatch.

Two variants share the plumbing:

- :class:`FixedShapeScorer` scores a device-resident table, stored as
  ``serve_table_dtype`` says: ``fp32``; ``bf16`` (half the bytes,
  gathered as bf16 and widened to f32 before the f32 FmScorer, whose
  ``vals`` stay f32 as the reference's do); or ``int8`` codes with one
  f32 scale per ``quant_chunk`` rows (``models.fm.fm_scores_dequant``:
  gather codes and scales, widen, score).  An fp32 model is quantized
  on the host at placement; a ``quant.npz`` table is placed as it is.
- :class:`OverlayScorer` scores a ``tiered.npz`` sparse overlay straight
  from its host cold store: per dispatch the rung's unique ids gather
  their rows on the host (``ColdStore.gather``), a compact table padded
  to a power-of-two bucket is copied to the device in one pinned copy,
  and the ids are remapped to its rows, so no ``[V, D]`` table is ever
  allocated.

The parameters are a REFERENCE swapped under a lock
(:meth:`FixedShapeScorer.swap`): a dispatch reads it once, so it scores
against exactly one table (old or new, never torn).
:meth:`_LadderScorer.warmup` runs each rung once, so first-request costs
(the kernel library's load, the first launch, allocator growth) land at
startup.

Not in the port yet: the reference's autotune hook, and its rollback,
``keep_prev`` and overlay swaps, which serve the checkpoint watcher
(ROADMAP.md, port queue item 4); the Orbax dense checkpoint reader
(item 2).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models.fm import (
    FmModel, fm_scores_dequant, scores_from_rows,
)
from fast_tffm_tpu_torch.obs.telemetry import NULL
from fast_tffm_tpu_torch.ops import quant
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.train import checkpoint
from fast_tffm_tpu_torch.train import tiered as tiered_lib

log = logging.getLogger(__name__)

__all__ = ["FixedShapeScorer", "OverlayScorer", "load_model",
           "make_scorer"]

CONVERT_TOOL = "python -m fast_tffm_tpu_torch.tools.convert_checkpoint"


class _Rung:
    """One rung's staging buffers (``b`` examples x ``F`` features);
    ``fields`` only ``with_fields`` (field-aware FM), else None."""

    def __init__(self, b: int, feat: int, device: torch.device,
                 with_fields: bool = False):
        pin = device.type == "cuda"
        self.b = b

        def host(dtype, shape):
            return torch.zeros(shape, dtype=dtype, pin_memory=pin)

        self.ids_host = host(torch.int32, (b, feat))
        self.vals_host = host(torch.float32, (b, feat))
        self.fields_host = (host(torch.int32, (b, feat)) if with_fields
                            else None)
        self.out_host = host(torch.float32, (b,))
        # numpy views of the pinned buffers: filling them IS the staging.
        self.ids = self.ids_host.numpy()
        self.vals = self.vals_host.numpy()
        self.fields = None if self.fields_host is None else (
            self.fields_host.numpy())
        self.out = self.out_host.numpy()
        if pin:
            def twin(t):
                return None if t is None else torch.zeros_like(
                    t, device=device)

            self.ids_dev = twin(self.ids_host)
            self.vals_dev = twin(self.vals_host)
            self.fields_dev = twin(self.fields_host)
            self.done = torch.cuda.Event()
        else:
            self.ids_dev, self.vals_dev, self.fields_dev, self.done = (
                self.ids_host, self.vals_host, self.fields_host, None
            )

    def stage(self, c: int, ids, vals, fields) -> None:
        """Copy ``c`` examples into the rung's first rows and zero the
        rest (``vals == 0`` rows are inert; their outputs are dropped).
        Without ``fields`` a field-aware rung stages field 0, as the
        reference's scorer does."""
        if c:
            self.ids[:c] = ids[:c]
            self.vals[:c] = vals[:c]
        self.ids[c:] = 0
        self.vals[c:] = 0.0
        if self.fields is not None:
            self.fields[:c] = 0 if fields is None else fields[:c]
            self.fields[c:] = 0


class _LadderScorer:
    """Shared rung, staging and dispatch plumbing of the two scorers.

    Thread contract: :meth:`score` / :meth:`score_rung` serialize on one
    lock (the batcher dispatches from a single thread anyway; the lock
    makes direct callers safe too).  ``swap`` may run on any thread.
    Subclasses set ``self._model`` and implement :meth:`_scores`.
    """

    def __init__(self, cfg: FmConfig,
                 device: Optional[Union[str, torch.device]] = None,
                 telemetry=None, step: int = 0, extra_rungs=()):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ladder = tuple(sorted(set(cfg.serve_ladder)
                                   | {int(b) for b in extra_rungs}))
        self.max_rung = self.ladder[-1]
        self._feat = cfg.max_features
        self._field_num = cfg.field_num
        self._factor_num = cfg.factor_num
        self._logistic = cfg.loss_type == "logistic"
        self._tel = telemetry if telemetry is not None else NULL
        self._t_dispatch = self._tel.timer("serve.dispatch")
        self._c_swaps = self._tel.counter("serve.swaps")
        self._lock = threading.Lock()  # serializes dispatch + staging
        self._swap_lock = threading.Lock()
        self._rungs: dict = {}
        self.step = int(step)
        self.warmup_wall_s = 0.0

    # -- rung helpers --------------------------------------------------

    def rung_for(self, n: int) -> int:
        """Smallest ladder rung holding ``n`` examples (the max rung for
        anything larger — callers chunk)."""
        for b in self.ladder:
            if n <= b:
                return b
        return self.max_rung

    def slots_for(self, n: int) -> int:
        """Total padded slots :meth:`score` dispatches for ``n``
        examples (the chunk policy's accounting twin)."""
        slots = 0
        pos = 0
        while pos < n:
            c = min(n - pos, self.max_rung)
            slots += self.rung_for(c)
            pos += c
        return slots

    def _rung(self, b: int) -> _Rung:
        rung = self._rungs.get(b)
        if rung is None:
            rung = _Rung(b, self._feat, self.device,
                         with_fields=self._field_num > 0)
            self._rungs[b] = rung
        return rung

    def staging_bytes(self) -> int:
        """Bytes of the device staging this scorer holds: the rungs'
        input twins (none on the CPU, where the host buffers serve)."""
        return sum(
            t.numel() * t.element_size() for r in self._rungs.values()
            if r.done is not None
            for t in (r.ids_dev, r.vals_dev, r.fields_dev) if t is not None)

    # -- scoring -------------------------------------------------------

    def warmup(self) -> int:
        """Run every ladder rung once on all-padding input; returns the
        number of rungs warmed."""
        t0 = time.perf_counter()
        with self._lock:
            for b in self.ladder:
                rung = self._rung(b)
                rung.stage(0, None, None, None)
                self._dispatch(rung)
        self.warmup_wall_s = time.perf_counter() - t0
        return len(self.ladder)

    def score(self, ids: np.ndarray, vals: np.ndarray,
              fields: Optional[np.ndarray] = None) -> np.ndarray:
        """Scores for ``n`` examples (``[n, max_features]`` arrays), any
        ``n``: chunks at the max rung, pads the tail chunk up to its
        rung with zero rows (``vals == 0`` rows are mathematically inert
        and their outputs are discarded).  ``fields`` (``[n,
        max_features]``) is read only for field-aware FM; None there
        means field 0 everywhere."""
        n = len(ids)
        out = np.empty((n,), np.float32)
        pos = 0
        with self._lock:
            while pos < n:
                c = min(n - pos, self.max_rung)
                rung = self._rung(self.rung_for(c))
                rung.stage(c, ids[pos:pos + c], vals[pos:pos + c],
                           None if fields is None else fields[pos:pos + c])
                out[pos:pos + c] = self._dispatch(rung)[:c]
                pos += c
        return out

    def score_rung(self, ids: np.ndarray, vals: np.ndarray,
                   fields: Optional[np.ndarray], b: int) -> np.ndarray:
        """One dispatch of exactly-rung-shaped arrays (the batcher's
        entry: it fills its own pooled buffers, copied here into the
        rung's pinned staging)."""
        with self._lock:
            rung = self._rung(b)
            rung.stage(b, ids, vals, fields)
            return self._dispatch(rung)

    def _dispatch(self, rung: _Rung) -> np.ndarray:
        vocab = self.cfg.vocabulary_size
        if rung.ids.min() < 0 or rung.ids.max() >= vocab:
            # The request decoders reduce ids modulo the vocabulary; an
            # id outside it here would be a device-side assert on the
            # GPU, so it is refused on the host instead.
            raise ValueError(f"feature ids must lie in [0, {vocab})")
        with self._t_dispatch.time():
            with self._swap_lock:
                model = self._model
            with torch.inference_mode():
                scores = self._scores(model, rung)
                if self._logistic:
                    scores = torch.sigmoid(scores)
                rung.out_host.copy_(scores, non_blocking=True)
                if rung.done is not None:
                    rung.done.record()
                    rung.done.synchronize()
            return rung.out.copy()

    def _copy_inputs(self, rung: _Rung) -> None:
        """Non-blocking copies of the rung's staged inputs to the
        device (nothing to copy on the CPU)."""
        if rung.done is not None:
            rung.ids_dev.copy_(rung.ids_host, non_blocking=True)
            rung.vals_dev.copy_(rung.vals_host, non_blocking=True)
            if rung.fields_dev is not None:
                rung.fields_dev.copy_(rung.fields_host, non_blocking=True)

    def _score_rows(self, w0: torch.Tensor, rows: torch.Tensor,
                    rung: _Rung) -> torch.Tensor:
        """Scores without the sigmoid from the rung's gathered f32 rows
        ``[b * F, D]``."""
        return scores_from_rows(
            w0, rows.view(rung.b, self._feat, -1), rung.vals_dev,
            rung.fields_dev, factor_num=self._factor_num,
            field_num=self._field_num)

    def _scores(self, model, rung: _Rung) -> torch.Tensor:
        raise NotImplementedError


class FixedShapeScorer(_LadderScorer):
    """Dense-table scorer: the table device-resident in
    ``cfg.serve_table_dtype``, hot-swappable.

    ``model`` is an :class:`FmModel` (fp32; quantized at placement when
    ``serve_table_dtype`` is bf16 or int8) or, from a ``quant.npz``, a
    ``(w0, quant.QuantTable)`` pair whose dtype (and int8 chunk) must be
    the config's.  Gauges: ``serve.table_bytes`` (the placed table's
    bytes) and ``serve.quant_error_max`` (0 for fp32, -1 for a
    pre-quantized table, else the max |score_fp32 - score_quant| of
    :meth:`_probe_quant_error` at placement).
    """

    def __init__(self, cfg: FmConfig, model,
                 device: Optional[Union[str, torch.device]] = None,
                 telemetry=None, step: int = 0, extra_rungs=()):
        super().__init__(cfg, device=device, telemetry=telemetry,
                         step=step, extra_rungs=extra_rungs)
        self.table_dtype = quant.validate_dtype(
            cfg.serve_table_dtype, "serve_table_dtype")
        self._chunk = cfg.quant_chunk
        self._g_table_bytes = self._tel.gauge("serve.table_bytes")
        self._g_quant_err = self._tel.gauge("serve.quant_error_max")
        self.place_wall_s = 0.0
        self._model = self._place(model)

    # -- placement and hot swap ----------------------------------------

    def _probe_quant_error(self, w0, table_f32: np.ndarray,
                           qt: quant.QuantTable) -> float:
        """max |served_fp32 - served_quant| on the reference's
        deterministic probe batch, scored on the host (torch on the CPU,
        so no rung runs) from only the probe's rows of either table."""
        cfg = self.cfg
        rng = np.random.default_rng(0xC0FFEE)
        n = min(256, cfg.vocabulary_size)
        ids = rng.integers(
            0, cfg.vocabulary_size, (n, cfg.max_features)
        ).astype(np.int64)
        vals = torch.from_numpy(
            rng.uniform(0.1, 1.0, ids.shape).astype(np.float32))
        fields = (
            torch.from_numpy(rng.integers(0, cfg.field_num, ids.shape)
                             .astype(np.int32))
            if cfg.field_num else None
        )
        w0_t = torch.tensor(float(w0), dtype=torch.float32)

        def score(rows: np.ndarray) -> torch.Tensor:
            s = scores_from_rows(
                w0_t, torch.from_numpy(rows), vals, fields,
                factor_num=cfg.factor_num, field_num=cfg.field_num)
            return torch.sigmoid(s) if self._logistic else s

        return float((score(table_f32[ids])
                      - score(quant.dequantize_rows(qt, ids))).abs().max())

    def _place(self, model):
        """The model on the device in ``serve_table_dtype``: ``(w0,
        table)`` (f32 or bf16 table) or a ``quant.QuantParams``."""
        t0 = time.perf_counter()
        dtype = self.table_dtype
        if isinstance(model, FmModel):
            qt = None
            shape = tuple(model.table.shape)
        else:
            try:
                w0_in, qt = model
                shape = tuple(qt.codes.shape)
            except (TypeError, ValueError, AttributeError):
                raise ValueError(
                    "FixedShapeScorer params must be an FmModel or a "
                    f"(w0, QuantTable) pair, got {type(model).__name__}"
                ) from None
        want = (self.cfg.vocabulary_size, self.cfg.embedding_dim)
        if shape != want:
            raise ValueError(
                f"model table is {shape} but the config wants {want}")
        dev = self.device
        if dtype == "fp32":
            if qt is not None:
                raise ValueError(
                    "a quantized (quant.npz) table cannot serve with "
                    "serve_table_dtype=fp32 — set serve_table_dtype to "
                    f"the checkpoint's dtype ({qt.dtype}) or convert "
                    f"it back ({CONVERT_TOOL} <dir> --to fp32)"
                )
            with torch.no_grad():
                placed = (
                    model.w0.detach().to(dev, torch.float32),
                    model.table.detach().to(dev, torch.float32).contiguous(),
                )
            table_bytes = want[0] * want[1] * 4
            err = 0.0  # fp32 serving is the reference
        else:
            if qt is None:
                # Quantize the fp32 model on the host, off the dispatch
                # lock (construction or hot-swap staging).
                with torch.no_grad():
                    w0_in = np.float32(model.w0.detach().cpu())
                    table = np.ascontiguousarray(
                        model.table.detach().cpu().numpy(), np.float32)
                qt = quant.quantize_table(table, dtype, self._chunk)
                err = self._probe_quant_error(w0_in, table, qt)
                del table
            else:
                if qt.dtype != dtype:
                    raise ValueError(
                        f"quantized checkpoint is {qt.dtype} but "
                        f"serve_table_dtype={dtype}; they must match "
                        "(or convert the checkpoint)"
                    )
                if dtype == "int8" and int(qt.chunk) != int(self._chunk):
                    raise ValueError(
                        f"quantized checkpoint uses quant_chunk="
                        f"{qt.chunk} but the server is configured "
                        f"with quant_chunk={self._chunk}; they must "
                        "match (scale indexing is chunk-derived)"
                    )
                # No fp32 table in hand: -1 marks the error unknown.
                err = -1.0
            w0_d = torch.tensor(float(w0_in), dtype=torch.float32,
                                device=dev)
            if dtype == "bf16":
                placed = (w0_d, quant.bf16_bits_to_torch(qt.codes).to(dev))
            else:
                placed = quant.QuantParams(
                    w0_d, _to_device(qt.codes, dev),
                    _to_device(np.asarray(qt.scales, np.float32), dev))
            table_bytes = qt.nbytes
        self._g_table_bytes.set(int(table_bytes))
        self._g_quant_err.set(float(err))
        self.place_wall_s = time.perf_counter() - t0
        return placed

    def swap(self, model, step: int = 0) -> None:
        """Warm hot-swap: place the new params (off the dispatch lock —
        traffic keeps scoring the old table; a quantized scorer
        quantizes an incoming fp32 model here), then swap the reference
        atomically between dispatches."""
        placed = self._place(model)
        with self._swap_lock:
            self._model = placed
            self.step = int(step)
        self._c_swaps.add()
        log.info("serving params hot-swapped to step %d", step)

    def _scores(self, model, rung: _Rung) -> torch.Tensor:
        self._copy_inputs(rung)
        ids = rung.ids_dev.view(-1)
        if isinstance(model, quant.QuantParams):
            return fm_scores_dequant(
                model.w0, model.codes, model.scales, self._chunk,
                rung.ids_dev, rung.vals_dev, rung.fields_dev,
                factor_num=self._factor_num, field_num=self._field_num)
        w0, table = model
        # A bf16 table is gathered compact and widened before the f32
        # FmScorer (a no-op for f32).
        return self._score_rows(w0, table.index_select(0, ids).float(),
                                rung)


class OverlayScorer(_LadderScorer):
    """Huge-V scorer over a ``tiered.npz`` sparse overlay.

    Per dispatch, on the host: the rung's unique ids (``np.unique``), their
    current rows from the cold ``store`` (written value, else the hash
    init; ``serve.overlay_gather`` times it), a compact table padded with
    zero rows to ``tiered._bucket`` rows, and the ids remapped to its
    rows.  Then one pinned host-to-device copy of the compact table
    beside the inputs', and the scores as the dense scorer's.  Staging
    buffers are kept per (rung, bucket), so steady traffic allocates no
    new ones.  Registers neither table gauge, as the reference's does
    not: its error against an fp32 table was never measured.
    """

    def __init__(self, cfg: FmConfig, w0: float, store,
                 device: Optional[Union[str, torch.device]] = None,
                 telemetry=None, step: int = 0, extra_rungs=()):
        super().__init__(cfg, device=device, telemetry=telemetry,
                         step=step, extra_rungs=extra_rungs)
        self._dim = cfg.embedding_dim
        self._t_gather = self._tel.timer("serve.overlay_gather")
        self._staging: dict = {}  # (rung, bucket) -> (host, numpy, device)
        self._model = (torch.tensor(float(w0), dtype=torch.float32,
                                    device=self.device), store)

    def staging_bytes(self) -> int:
        """The rungs' input twins and the compact tables' device
        staging (the host buffers themselves on the CPU)."""
        return super().staging_bytes() + sum(
            dev.numel() * 4 for _, _, dev in self._staging.values())

    def _table_staging(self, b: int, rows: int) -> tuple:
        st = self._staging.get((b, rows))
        if st is None:
            pin = self.device.type == "cuda"
            host = torch.zeros((rows, self._dim), dtype=torch.float32,
                               pin_memory=pin)
            dev = (torch.zeros_like(host, device=self.device) if pin
                   else host)
            st = (host, host.numpy(), dev)
            self._staging[(b, rows)] = st
        return st

    def _scores(self, model, rung: _Rung) -> torch.Tensor:
        w0, store = model
        with self._t_gather.time():
            u, inv = np.unique(rung.ids.reshape(-1), return_inverse=True)
            host, mini, dev = self._table_staging(
                rung.b, tiered_lib._bucket(max(1, len(u))))
            mini[:len(u)] = store.gather(u)
            mini[len(u):] = 0.0
            rung.ids[...] = inv.reshape(rung.ids.shape)
        self._copy_inputs(rung)
        if rung.done is not None:
            dev.copy_(host, non_blocking=True)
        return self._score_rows(
            w0, dev.index_select(0, rung.ids_dev.view(-1)), rung)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        arr if arr.flags.writeable else arr.copy()).to(device)


# ----------------------------------------------------------------------
# checkpoint loading
# ----------------------------------------------------------------------


def load_model(cfg: FmConfig):
    """The servable model under ``cfg.model_file``, on the host, as
    ``(fmt, step, model)``: ``("tiered", step, (w0, ColdStore))`` from a
    ``tiered.npz`` overlay, else ``("quant", step, (w0, QuantTable))``
    from ``quant.npz``, else ``("dense", step, FmModel)`` from
    ``params.npz`` (the reference's precedence; the saves keep the
    formats exclusive).  An overlay written under another init or cold
    dtype, and a quantized table of another shape or dtype than the
    config's, raise ValueError.  Without any of the three raises
    NotImplementedError: the reference's Orbax dense checkpoint is not
    read yet (ROADMAP.md, port queue item 2)."""
    model_file = cfg.model_file
    if checkpoint.exists_tiered(model_file):
        step, scalars, stores = checkpoint.restore_tiered(model_file)
        payload = stores["table"]
        want = tiered_lib._virtual_descriptor(cfg, "table")
        got = payload.get("descriptor")
        if got is not None and got != want:
            raise ValueError(
                f"tiered checkpoint store 'table' was written under a "
                f"different init ({got} != {want}); seed/"
                "init_value_range must match the run that saved it"
            )
        store = tiered_lib._virtual_store(cfg, "table")
        store.import_overlay(payload)
        return "tiered", step, (float(scalars["w0"]), store)
    got = checkpoint.restore_quant(model_file)
    if got is not None:
        step, w0, qt = got
        desc = qt.descriptor()
        if (
            desc["vocab"] != cfg.vocabulary_size
            or desc["dim"] != cfg.embedding_dim
        ):
            raise ValueError(
                f"quantized checkpoint table is [{desc['vocab']}, "
                f"{desc['dim']}] but the config wants "
                f"[{cfg.vocabulary_size}, {cfg.embedding_dim}]"
            )
        if qt.dtype != cfg.serve_table_dtype:
            raise ValueError(
                f"quantized checkpoint at {model_file} is "
                f"{qt.dtype} but serve_table_dtype="
                f"{cfg.serve_table_dtype}; set the knob to the "
                "checkpoint's dtype or convert it "
                f"({CONVERT_TOOL})"
            )
        return "quant", step, (np.float32(w0), qt)
    if checkpoint.exists(model_file):
        step, model = checkpoint.restore_params(model_file, device="cpu")
        return "dense", step, model
    raise NotImplementedError(
        f"no params.npz, quant.npz or tiered.npz under {model_file}: the "
        "PyTorch port reads only these numpy checkpoints; the reference's "
        "Orbax dense checkpoint is ROADMAP.md port queue item 2"
    )


def make_scorer(cfg: FmConfig,
                device: Optional[Union[str, torch.device]] = None,
                telemetry=None, extra_rungs=()):
    """Build the scorer for whatever ``cfg.model_file`` holds: an
    :class:`OverlayScorer` for a tiered overlay, else a
    :class:`FixedShapeScorer`.  ``extra_rungs`` adds example counts to
    the ladder (offline predict adds its ``batch_size``)."""
    dev = resolve_device(device)
    fmt, step, model = load_model(cfg)
    if fmt == "tiered":
        w0, store = model
        return OverlayScorer(cfg, w0, store, device=dev,
                             telemetry=telemetry, step=step,
                             extra_rungs=extra_rungs)
    return FixedShapeScorer(cfg, model, device=dev, telemetry=telemetry,
                            step=step, extra_rungs=extra_rungs)
