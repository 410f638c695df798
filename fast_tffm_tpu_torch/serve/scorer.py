"""Fixed-shape scorer: the serving path's device half.

The counterpart of ``fast_tffm_tpu/serve/scorer.py::FixedShapeScorer``.
Online traffic arrives at arbitrary sizes; the scorer pins a small
LADDER of microbatch shapes (``{64, 256, 1024}`` examples x
``max_features`` by default, ``serve_batch_sizes``) and pads every
request or chunk up to the smallest rung that holds it, so every
dispatch runs at one of a few fixed shapes:

- the table lives on the device, as float32;
- each rung keeps its own staging buffers: pinned host ``ids``/``vals``
  (and ``fields`` for field-aware FM) the caller's arrays are copied
  into, their device twins, and a pinned host output.  A dispatch is:
  non-blocking host-to-device copy, gather ``table.index_select`` (a
  plain gather, left outside the kernel as in the JAX package), the
  FmScorer kernel (``ops.interaction.forward``) or, with ``field_num >
  0``, the FFM einsums (``models.fm.ffm_scores_from_rows``, the
  reference's FFM ``score_fn``), ``+ w0``, ``sigmoid`` for logistic
  loss, a non-blocking device-to-host copy, then a wait on that copy —
  the score goes back to a client, so the copy back is part of the
  dispatch;
- the parameters are a REFERENCE swapped under a lock (:meth:`swap`):
  a dispatch reads it once, so it scores against exactly one table (old
  or new, never torn).

:meth:`warmup` runs each rung once, so first-request costs (the kernel
library's load, the first launch, allocator growth) land at startup.

The reference's ``OverlayScorer``, its tiered and quantized checkpoint
loading (``serve_table_dtype`` other than ``fp32``, for FM and FFM
alike) and its autotune hook are not in the port yet (ROADMAP.md, port
queue item 2).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models.fm import FmModel, ffm_scores_from_rows
from fast_tffm_tpu_torch.obs.telemetry import NULL
from fast_tffm_tpu_torch.ops import interaction
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.train import checkpoint

log = logging.getLogger(__name__)

__all__ = ["FixedShapeScorer", "load_model", "make_scorer"]


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


class FixedShapeScorer:
    """Dense-table scorer: params device-resident, hot-swappable.

    Thread contract: :meth:`score` / :meth:`score_rung` serialize on one
    lock (the batcher dispatches from a single thread anyway; the lock
    makes direct callers safe too).  :meth:`swap` may run on any thread.
    """

    def __init__(self, cfg: FmConfig, model: FmModel,
                 device: Optional[Union[str, torch.device]] = None,
                 telemetry=None, step: int = 0, extra_rungs=()):
        if cfg.serve_table_dtype != "fp32":
            raise NotImplementedError(
                f"serve_table_dtype={cfg.serve_table_dtype} is not in the "
                "PyTorch port yet (ROADMAP.md, port queue item 2); "
                "serve fp32"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.ladder = tuple(sorted(set(cfg.serve_ladder)
                                   | {int(b) for b in extra_rungs}))
        self.max_rung = self.ladder[-1]
        self._feat = cfg.max_features
        self._field_num = cfg.field_num
        self._factor_num = cfg.factor_num
        self._logistic = cfg.loss_type == "logistic"
        tel = telemetry if telemetry is not None else NULL
        self._t_dispatch = tel.timer("serve.dispatch")
        self._c_swaps = tel.counter("serve.swaps")
        self._g_table_bytes = tel.gauge("serve.table_bytes")
        self._lock = threading.Lock()  # serializes dispatch + staging
        self._swap_lock = threading.Lock()
        self._rungs: dict = {}
        self.step = int(step)
        self.warmup_wall_s = 0.0
        self._model = self._place(model)

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

    # -- placement and hot swap ----------------------------------------

    def _place(self, model: FmModel):
        """``(w0, table)`` as f32 device tensors, checked against the
        config's shape."""
        want = (self.cfg.vocabulary_size, self.cfg.embedding_dim)
        if tuple(model.table.shape) != want:
            raise ValueError(
                f"model table is {tuple(model.table.shape)} but the "
                f"config wants {want}"
            )
        with torch.no_grad():
            w0 = model.w0.detach().to(self.device, torch.float32)
            table = model.table.detach().to(
                self.device, torch.float32
            ).contiguous()
        self._g_table_bytes.set(table.numel() * 4)
        return w0, table

    def swap(self, model: FmModel, step: int = 0) -> None:
        """Warm hot-swap: place the new params (off the dispatch lock —
        traffic keeps scoring the old table), then swap the reference
        atomically between dispatches."""
        placed = self._place(model)
        with self._swap_lock:
            self._model = placed
            self.step = int(step)
        self._c_swaps.add()
        log.info("serving params hot-swapped to step %d", step)

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
                w0, table = self._model
            with torch.inference_mode():
                if rung.done is not None:
                    rung.ids_dev.copy_(rung.ids_host, non_blocking=True)
                    rung.vals_dev.copy_(rung.vals_host, non_blocking=True)
                    if rung.fields_dev is not None:
                        rung.fields_dev.copy_(rung.fields_host,
                                              non_blocking=True)
                rows = table.index_select(0, rung.ids_dev.view(-1)).view(
                    rung.b, self._feat, -1)
                if self._field_num:
                    scores = ffm_scores_from_rows(
                        w0, rows, rung.vals_dev, rung.fields_dev,
                        self._factor_num, self._field_num)
                else:
                    scores, _ = interaction.forward(rows, rung.vals_dev)
                    scores = w0 + scores
                if self._logistic:
                    scores = torch.sigmoid(scores)
                rung.out_host.copy_(scores, non_blocking=True)
                if rung.done is not None:
                    rung.done.record()
                    rung.done.synchronize()
            return rung.out.copy()


def load_model(cfg: FmConfig,
               device: Optional[Union[str, torch.device]] = None):
    """``(step, FmModel)`` from ``cfg.model_file``'s ``params.npz``.
    Other checkpoint formats raise NotImplementedError."""
    if not checkpoint.exists(cfg.model_file):
        raise NotImplementedError(
            f"no params.npz under {cfg.model_file}: the PyTorch port "
            "reads only its plain-numpy dense checkpoint so far; Orbax, "
            "quant.npz and tiered.npz checkpoints are ROADMAP.md port "
            "queue item 2"
        )
    return checkpoint.restore_params(cfg.model_file, device=device)


def make_scorer(cfg: FmConfig,
                device: Optional[Union[str, torch.device]] = None,
                telemetry=None, extra_rungs=()) -> FixedShapeScorer:
    """Build the scorer for whatever ``cfg.model_file`` holds.
    ``extra_rungs`` adds example counts to the ladder (offline predict
    adds its ``batch_size``)."""
    dev = resolve_device(device)
    step, model = load_model(cfg, device=dev)
    return FixedShapeScorer(cfg, model, device=dev, telemetry=telemetry,
                            step=step, extra_rungs=extra_rungs)
