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
  f32 scale per ``quant_chunk`` rows (``models.fm.gather_dequant``:
  gather codes and scales, widen, then score as f32 rows).  An fp32 model is quantized
  on the host at placement; a ``quant.npz`` table is placed as it is.
- :class:`OverlayScorer` scores a ``tiered.npz`` sparse overlay (or a
  rank-sharded set of ``tiered.shard{s}of{S}.npz``) straight
  from its host cold store: per dispatch the rung's unique ids gather
  their rows on the host (``ColdStore.gather``), a compact table padded
  to a power-of-two bucket is copied to the device in one pinned copy,
  and the ids are remapped to its rows, so no ``[V, D]`` table is ever
  allocated.

The parameters are a REFERENCE swapped under a lock
(:meth:`FixedShapeScorer.swap`, :meth:`OverlayScorer.swap`): the new
table is placed first, off the lock, and a dispatch reads the reference
once, so it scores against exactly one table (old or new, never torn).
A swap with ``keep_prev`` keeps the replaced table (on the card, beside
the new one) until :meth:`_LadderScorer.promote` drops it or
:meth:`_LadderScorer.rollback` restores it; a window already open stays
anchored to the last table that was not on trial, as the reference's.
:meth:`_LadderScorer.warmup` runs each rung once, so first-request costs
(the kernel library's load, the first launch, allocator growth) land at
startup.  :func:`load_model` reads every checkpoint format, the JAX
package's Orbax directories included.

Both score over a ``data x model`` grid of the process's devices
(``parallel/mesh.py::DeviceGrid``, the reference's ``make_mesh``): the
config's ``mesh_data x mesh_model``, or every device on ``data`` when it
asks for 1 x 1 (so one visible GPU is a 1 x 1 grid, and serving there is
one device's path).  Every rung is rounded up to a multiple of ``data``
and split into that many equal blocks of examples; data row ``i``
scores block ``i`` on its first device, each block with its own device
twins and event.  A dispatch issues every block's copies and scores
before it waits on any, and writes the scores back in example order.
The dense table's rows are split over ``model`` and copied over
``data``: device ``(i, j)`` holds shard ``j`` (f32, bf16 or int8 codes;
the int8 scales whole on every device), each shard gathers the ids in
its range, and the rows meet on the block's device, where each id keeps
its own shard's row.  The overlay's compact table is copied to every
block's device.  The FmScorer kernel runs once per block.

The interaction each rung runs is the reference's autotune hook: with
``interaction_impl`` set, the scorer resolves it at the max rung and the
table's dtype (``ops/autotune.py``, ``context="serve"``; ``auto``
measures on the scorer's device or reads the shared cache) and routes
the fixed-shape, quantized and overlay scores through the decision.
With ``interaction_impl = ""`` the port keeps its FmScorer kernel
(``kernel_impl = "pallas"``), where the reference's default is its
``jnp`` math.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models.fm import (
    FmModel, gather_dequant, scores_from_rows,
)
from fast_tffm_tpu_torch.obs.telemetry import NULL
from fast_tffm_tpu_torch.ops import autotune as autotune_lib
from fast_tffm_tpu_torch.ops import quant
from fast_tffm_tpu_torch.parallel.mesh import DeviceGrid
from fast_tffm_tpu_torch.train import checkpoint
from fast_tffm_tpu_torch.train import tiered as tiered_lib

log = logging.getLogger(__name__)

__all__ = ["FixedShapeScorer", "OverlayScorer", "load_model",
           "make_scorer"]

CONVERT_TOOL = "python -m fast_tffm_tpu_torch.tools.convert_checkpoint"

Devices = Optional[Union[str, torch.device,
                         Sequence[Union[str, torch.device]]]]


def _grid_devices(device: Devices, devices: Devices) -> Devices:
    """The one of ``device`` / ``devices`` that was given (None: every
    visible GPU)."""
    if device is not None and devices is not None:
        raise ValueError("give device or devices, not both")
    return devices if devices is not None else device


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid``, on the CPU one element at a time: there its
    vectorized body and its scalar tail round ``exp`` differently in the
    last place, so a score would depend on where its rung or block puts
    it; a strided output keeps every element on the scalar path.  On the
    GPU every element runs the same code already."""
    if x.device.type != "cpu":
        return torch.sigmoid(x)
    return torch.sigmoid(x, out=torch.empty((x.numel(), 2),
                                            dtype=x.dtype)[:, 0])


def _on(dev: torch.device):
    """``dev`` as the current CUDA device (nothing on the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class _Block:
    """One data block of a rung: its examples ``[lo, hi)``, scored on
    ``dev``, the first device of its data row.  The host tensors are
    slices of the rung's pinned staging; ``ids_dev[j]`` is the ids' twin
    on the row's device ``j`` (model shard ``j`` gathers there), the
    values (and fields) have one twin on ``dev``, and ``done`` is an
    event of ``dev``.  On the CPU the twins are the host slices and
    ``done`` is None."""

    def __init__(self, rung: "_Rung", lo: int, hi: int, row, pin: bool):
        self.lo, self.hi, self.b = lo, hi, hi - lo
        self.dev = row[0]

        def part(t):
            return None if t is None else t[lo:hi]

        self.ids_host = part(rung.ids_host)
        self.vals_host = part(rung.vals_host)
        self.fields_host = part(rung.fields_host)
        self.out_host = part(rung.out_host)
        if pin:
            def twin(t, dev):
                return None if t is None else torch.zeros_like(t, device=dev)

            self.ids_dev = [twin(self.ids_host, dev) for dev in row]
            self.vals_dev = twin(self.vals_host, self.dev)
            self.fields_dev = twin(self.fields_host, self.dev)
            # An event belongs to the device current when it is made.
            with torch.cuda.device(self.dev):
                self.done = torch.cuda.Event()
        else:
            self.ids_dev = [self.ids_host] * len(row)
            self.vals_dev, self.fields_dev, self.done = (
                self.vals_host, self.fields_host, None)

    def device_tensors(self) -> list:
        """The block's device twins (none on the CPU)."""
        if self.done is None:
            return []
        return [t for t in (*self.ids_dev, self.vals_dev, self.fields_dev)
                if t is not None]


class _Rung:
    """One rung's staging buffers (``b`` examples x ``F`` features):
    pinned host ``ids``/``vals`` (``fields`` only ``with_fields``,
    field-aware FM, else None) and output, split into one
    :class:`_Block` per data row of ``grid``."""

    def __init__(self, b: int, feat: int, grid: DeviceGrid,
                 with_fields: bool = False):
        pin = grid.first.type == "cuda"
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
        step = b // grid.data
        self.blocks = [_Block(self, i * step, (i + 1) * step, row, pin)
                       for i, row in enumerate(grid.devices)]

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

    ``device`` or ``devices`` (a device, ``"cuda"`` / ``"cpu"``, or a
    list, repeats allowed; None: every visible GPU) make the scorer's
    :class:`DeviceGrid`; ``self.device`` is its first device.  The
    ladder is the config's rungs and ``extra_rungs``, each rounded up
    to a multiple of the grid's ``data`` size, as the reference's.
    """

    def __init__(self, cfg: FmConfig, device: Devices = None,
                 telemetry=None, step: int = 0, extra_rungs=(),
                 writer=None, devices: Devices = None):
        self.cfg = cfg
        self.grid = DeviceGrid(cfg, _grid_devices(device, devices))
        self.device = self.grid.first
        data = self.grid.data
        self.ladder = tuple(sorted({
            -(-int(b) // data) * data
            for b in tuple(cfg.serve_ladder) + tuple(extra_rungs)
            if int(b) > 0}))
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
        # (model, step) a keep_prev swap replaced: the rollback window,
        # open until promote() or rollback().
        self._prev = None
        # The interaction every rung runs (ops/autotune.py): with
        # interaction_impl set, resolved at the max rung's shape and the
        # table's dtype (a `record: autotune` to `writer`); unset, the
        # FmScorer kernel.
        self._impl = "pallas"
        self.kernel_impl = "pallas"
        if cfg.interaction_impl:
            d = autotune_lib.resolve(cfg, context="serve",
                                     batch=self.max_rung, writer=writer,
                                     device=self.device)
            self.kernel_impl = d.impl
            self._impl = d.interaction

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
            rung = _Rung(b, self._feat, self.grid,
                         with_fields=self._field_num > 0)
            self._rungs[b] = rung
        return rung

    def staging_bytes(self) -> int:
        """Bytes of the device staging this scorer holds: the rungs'
        input twins on every device of the grid (none on the CPU, where
        the host buffers serve)."""
        return sum(t.numel() * t.element_size()
                   for r in self._rungs.values() for blk in r.blocks
                   for t in blk.device_tensors())

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
                prep = self._prepare(model, rung)
                # Every block is issued before any is waited on.
                for i, blk in enumerate(rung.blocks):
                    with _on(blk.dev):
                        scores = self._scores(model, i, blk, prep)
                        if self._logistic:
                            scores = _sigmoid(scores)
                        blk.out_host.copy_(scores, non_blocking=True)
                        if blk.done is not None:
                            blk.done.record()
                for blk in rung.blocks:
                    if blk.done is not None:
                        blk.done.synchronize()
            return rung.out.copy()

    def _prepare(self, model, rung: _Rung):
        """Per-rung work before the blocks (the overlay's host gather);
        its result reaches every block's :meth:`_scores`."""
        return None

    def _copy_inputs(self, blk: _Block) -> None:
        """Non-blocking copies of the block's staged inputs to its
        devices (nothing to copy on the CPU)."""
        if blk.done is not None:
            for t in blk.ids_dev:
                t.copy_(blk.ids_host, non_blocking=True)
            blk.vals_dev.copy_(blk.vals_host, non_blocking=True)
            if blk.fields_dev is not None:
                blk.fields_dev.copy_(blk.fields_host, non_blocking=True)

    def _score_rows(self, w0: torch.Tensor, rows: torch.Tensor,
                    blk: _Block) -> torch.Tensor:
        """Scores without the sigmoid from the block's gathered f32 rows
        ``[b * F, D]``."""
        return scores_from_rows(
            w0, rows.view(blk.b, self._feat, -1), blk.vals_dev,
            blk.fields_dev, factor_num=self._factor_num,
            field_num=self._field_num, impl=self._impl)

    def _scores(self, model, i: int, blk: _Block, prep) -> torch.Tensor:
        """Scores without the sigmoid of data block ``i``, on its device
        (the current one)."""
        raise NotImplementedError

    # -- hot swap ------------------------------------------------------

    def _install(self, placed, step: int, keep_prev: bool) -> None:
        """Swap the model reference between dispatches.  ``keep_prev``
        keeps the replaced model for :meth:`rollback`, unless a window is
        already open: then the table kept stays the one that was there
        before the window opened (a retried trial must not make a later
        rollback restore the table on trial)."""
        with self._swap_lock:
            if not keep_prev:
                self._prev = None
            elif self._prev is None:
                self._prev = (self._model, self.step)
            self._model = placed
            self.step = int(step)
        self._c_swaps.add()
        log.info("serving params hot-swapped to step %d", step)

    def promote(self) -> None:
        """Close the rollback window: drop the model a ``keep_prev`` swap
        kept (and free its memory)."""
        with self._swap_lock:
            self._prev = None

    def rollback(self) -> bool:
        """Restore the model a ``keep_prev`` swap replaced, between
        dispatches as a swap.  Returns False when no window is open."""
        with self._swap_lock:
            if self._prev is None:
                return False
            self._model, step = self._prev
            self._prev = None
            self.step = int(step)
        self._c_swaps.add()
        log.info("serving params rolled back to step %d", step)
        return True


class _Placed(NamedTuple):
    """A dense table placed on a grid: ``w0[i]`` f32 on data row ``i``'s
    first device; ``shards[i][j]`` model shard ``j``'s rows on device
    ``(i, j)`` (f32 or bf16 rows, or int8 codes); ``scales[i][j]`` the
    whole int8 scale vector on every device (None for f32 and bf16)."""

    w0: tuple
    shards: tuple
    scales: Optional[tuple]


class FixedShapeScorer(_LadderScorer):
    """Dense-table scorer: the table device-resident in
    ``cfg.serve_table_dtype``, hot-swappable.

    ``model`` is an :class:`FmModel` (fp32; quantized at placement when
    ``serve_table_dtype`` is bf16 or int8) or, from a ``quant.npz``, a
    ``(w0, quant.QuantTable)`` pair whose dtype (and int8 chunk) must be
    the config's.  Gauges: ``serve.table_bytes`` (the placed table's
    bytes) and ``serve.quant_error_max`` (0 for fp32, -1 for a
    pre-quantized table, else the max |score_fp32 - score_quant| of
    :meth:`_probe_quant_error` at placement).  On a grid the table's
    rows split over ``model`` (:meth:`DeviceGrid.row_ranges`: a
    vocabulary ``model`` does not divide raises) and the gauge is still
    the whole table's bytes, as the reference's.
    """

    def __init__(self, cfg: FmConfig, model, device: Devices = None,
                 telemetry=None, step: int = 0, extra_rungs=(),
                 writer=None, devices: Devices = None):
        super().__init__(cfg, device=device, telemetry=telemetry,
                         step=step, extra_rungs=extra_rungs, writer=writer,
                         devices=devices)
        self._ranges = self.grid.row_ranges(cfg.vocabulary_size)
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

    def _place(self, model) -> "_Placed":
        """The model on the grid in ``serve_table_dtype``
        (:class:`_Placed`): model shard ``j``'s rows on every device of
        column ``j``, ``w0`` on every data row's first device, and the
        int8 scales whole on every device."""
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
        grid = self.grid
        scales = None
        if dtype == "fp32":
            if qt is not None:
                raise ValueError(
                    "a quantized (quant.npz) table cannot serve with "
                    "serve_table_dtype=fp32 — set serve_table_dtype to "
                    f"the checkpoint's dtype ({qt.dtype}) or convert "
                    f"it back ({CONVERT_TOOL} <dir> --to fp32)"
                )
            with torch.no_grad():
                w0_src = model.w0.detach()
                table = model.table.detach()
                w0 = tuple(w0_src.to(row[0], torch.float32)
                           for row in grid.devices)
                shards = tuple(
                    tuple(table[lo:hi].to(dev, torch.float32).contiguous()
                          for dev, (lo, hi) in zip(row, self._ranges))
                    for row in grid.devices)
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
            w0 = tuple(torch.tensor(float(w0_in), dtype=torch.float32,
                                    device=row[0]) for row in grid.devices)
            if dtype == "bf16":
                bits = quant.bf16_bits_to_torch(qt.codes)
                shards = tuple(
                    tuple(bits[lo:hi].to(dev)
                          for dev, (lo, hi) in zip(row, self._ranges))
                    for row in grid.devices)
            else:
                shards = tuple(
                    tuple(_to_device(qt.codes[lo:hi], dev)
                          for dev, (lo, hi) in zip(row, self._ranges))
                    for row in grid.devices)
                host_scales = np.asarray(qt.scales, np.float32)
                scales = tuple(tuple(_to_device(host_scales, dev)
                                     for dev in row)
                               for row in grid.devices)
            table_bytes = qt.nbytes
        self._g_table_bytes.set(int(table_bytes))
        self._g_quant_err.set(float(err))
        self.place_wall_s = time.perf_counter() - t0
        return _Placed(w0, shards, scales)

    def swap(self, model, step: int = 0, keep_prev: bool = False) -> None:
        """Warm hot-swap: place the new params (off the dispatch lock —
        traffic keeps scoring the old table; a quantized scorer
        quantizes an incoming fp32 model here), then swap the reference
        atomically between dispatches.  ``keep_prev`` keeps the replaced
        table on the device for :meth:`rollback` until :meth:`promote`."""
        self._install(self._place(model), step, keep_prev)

    def _gather(self, blk: _Block, gather) -> torch.Tensor:
        """The block's rows ``[b * F, D]`` on its device, read from the
        model shards of its data row: ``gather(j, local_ids,
        global_ids)`` reads shard ``j``'s rows on device ``(i, j)``.
        One shard reads every id.  Several read the ids clamped into
        their own range (a masked gather: an id outside it reads a row
        that is dropped), their rows move to the block's device, and each
        id keeps the row of the one shard that holds it, so the rows are
        the 1 x 1 gather's bit for bit."""
        ids = blk.ids_dev[0].view(-1)
        if len(self._ranges) == 1:
            return gather(0, ids, ids)
        rows = None
        for j, (lo, hi) in enumerate(self._ranges):
            local = (blk.ids_dev[j].view(-1) - lo).clamp_(0, hi - lo - 1)
            part = gather(j, local, local + lo).to(blk.dev,
                                                   non_blocking=True)
            if rows is None:
                rows = part
            else:
                inside = ((ids >= lo) & (ids < hi)).unsqueeze(1)
                rows = torch.where(inside, part, rows)
        return rows

    def _scores(self, model, i: int, blk: _Block, prep) -> torch.Tensor:
        self._copy_inputs(blk)
        shards = model.shards[i]
        if model.scales is not None:
            scales = model.scales[i]
            rows = self._gather(blk, lambda j, local, glob: gather_dequant(
                shards[j], scales[j], self._chunk, local, glob))
            return self._score_rows(model.w0[i], rows, blk)
        # A bf16 table is gathered compact and widened before the f32
        # FmScorer (a no-op for f32).
        rows = self._gather(
            blk, lambda j, local, _: shards[j].index_select(0, local))
        return self._score_rows(model.w0[i], rows.float(), blk)


class OverlayScorer(_LadderScorer):
    """Huge-V scorer over a ``tiered.npz`` sparse overlay.

    Per dispatch, once for the whole rung, on the host: the rung's
    unique ids (``np.unique``), their current rows from the cold
    ``store`` (written value, else the hash init; ``serve.overlay_gather``
    times it), a compact table padded with zero rows to
    ``tiered._bucket`` rows, and the ids remapped to its rows.  Then the
    compact table goes to every data block's device in one pinned copy
    each (the reference's replicated table), and each block scores its
    slice of the remapped ids as the dense scorer does.  Staging buffers
    are kept per (rung, bucket), so steady traffic allocates no new
    ones.  Registers neither table gauge, as the reference's does not:
    its error against an fp32 table was never measured.
    """

    def __init__(self, cfg: FmConfig, w0: float, store,
                 device: Devices = None, telemetry=None, step: int = 0,
                 extra_rungs=(), writer=None, devices: Devices = None):
        super().__init__(cfg, device=device, telemetry=telemetry,
                         step=step, extra_rungs=extra_rungs, writer=writer,
                         devices=devices)
        self._dim = cfg.embedding_dim
        self._t_gather = self._tel.timer("serve.overlay_gather")
        # (rung, bucket) -> (host, numpy view, one twin per data block)
        self._staging: dict = {}
        self._model = self._overlay(w0, store)

    def _overlay(self, w0: float, store) -> tuple:
        return (tuple(torch.tensor(float(w0), dtype=torch.float32,
                                   device=row[0])
                      for row in self.grid.devices), store)

    def swap(self, w0: float, store, step: int = 0,
             keep_prev: bool = False) -> None:
        """Hot-swap to a restored overlay (its w0 and cold store): one
        reference swap between dispatches, so a dispatch gathers its
        compact table from exactly one store.  ``keep_prev`` keeps the
        replaced overlay for :meth:`rollback` until :meth:`promote`."""
        self._install(self._overlay(w0, store), step, keep_prev)

    def staging_bytes(self) -> int:
        """The rungs' input twins and the compact tables' device
        staging (the host buffers themselves on the CPU)."""
        held = {t.data_ptr(): t.numel() * 4
                for _, _, devs in self._staging.values() for t in devs}
        return super().staging_bytes() + sum(held.values())

    def _table_staging(self, b: int, rows: int) -> tuple:
        st = self._staging.get((b, rows))
        if st is None:
            pin = self.device.type == "cuda"
            host = torch.zeros((rows, self._dim), dtype=torch.float32,
                               pin_memory=pin)
            devs = [torch.zeros_like(host, device=row[0]) if pin else host
                    for row in self.grid.devices]
            st = (host, host.numpy(), devs)
            self._staging[(b, rows)] = st
        return st

    def _prepare(self, model, rung: _Rung):
        _, store = model
        with self._t_gather.time():
            u, inv = np.unique(rung.ids.reshape(-1), return_inverse=True)
            host, mini, devs = self._table_staging(
                rung.b, tiered_lib._bucket(max(1, len(u))))
            mini[:len(u)] = store.gather(u)
            mini[len(u):] = 0.0
            rung.ids[...] = inv.reshape(rung.ids.shape)
        return host, devs

    def _scores(self, model, i: int, blk: _Block, prep) -> torch.Tensor:
        host, devs = prep
        self._copy_inputs(blk)
        if blk.done is not None:
            devs[i].copy_(host, non_blocking=True)
        return self._score_rows(
            model[0][i], devs[i].index_select(0, blk.ids_dev[0].view(-1)),
            blk)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        arr if arr.flags.writeable else arr.copy()).to(device)


# ----------------------------------------------------------------------
# checkpoint loading
# ----------------------------------------------------------------------


def _dense_overlay_store(cfg: FmConfig, payload: dict):
    """A dense-backed ``ColdStore`` of a ``kind = "dense"`` overlay's
    packed rows, placed by id; ValueError when their format is not the
    config's cold dtype or the ids are not every row once."""
    codec = quant.cold_codec(cfg)
    fmt = {k: v for k, v in payload["descriptor"].items() if k != "kind"}
    if fmt != codec.descriptor():
        raise ValueError(
            f"tiered checkpoint store 'table' was packed as {fmt} but this "
            f"run's cold_dtype expects {codec.descriptor()}"
        )
    ids = np.asarray(payload["ids"], np.int64)
    vocab, dim = cfg.vocabulary_size, cfg.embedding_dim
    if len(ids) != vocab or not np.array_equal(np.sort(ids),
                                               np.arange(vocab)):
        raise ValueError(
            f"a dense tiered checkpoint holds every row once; this one "
            f"holds {len(ids)} ids for vocabulary_size={vocab}"
        )
    packed = codec.empty(vocab)
    packed[ids] = np.asarray(payload["rows"], codec.storage_dtype)
    return tiered_lib.ColdStore(vocab, dim, payload["descriptor"],
                                dense=packed, codec=codec)


def load_model(cfg: FmConfig):
    """The servable model under ``cfg.model_file``, on the host, as
    ``(fmt, step, model)``: ``("tiered", step, (w0, ColdStore))`` from a
    ``tiered.npz`` overlay, else ``("quant", step, (w0, QuantTable))``
    from ``quant.npz``, else ``("dense", step, FmModel)`` from the dense
    checkpoint (the reference's precedence; the saves keep the
    formats exclusive; a dense checkpoint is ``params.npz`` or the JAX
    package's Orbax ``params/``).  An overlay written under another init
    or cold dtype, and a quantized table of another shape or dtype than
    the config's, raise ValueError, and so does a directory with no
    servable checkpoint, as the reference's.  An overlay of
    ``kind = "dense"`` (every row of an exact cold store: the fleet's
    shard sets) is served from a dense-backed store of its packed rows,
    which must cover the whole vocabulary in the config's cold dtype
    (the reference's reader refuses it as another init)."""
    model_file = cfg.model_file
    if checkpoint.exists_tiered(model_file):
        step, scalars, stores = checkpoint.restore_tiered(model_file)
        payload = stores["table"]
        want = tiered_lib._virtual_descriptor(cfg, "table")
        got = payload.get("descriptor")
        if got is not None and got.get("kind") == "dense":
            return "tiered", step, (float(scalars["w0"]),
                                    _dense_overlay_store(cfg, payload))
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
    raise ValueError(
        f"no servable checkpoint at {model_file} (neither params.npz nor "
        "the dense params/opt dirs, quant.npz or a tiered.npz overlay)"
    )


def make_scorer(cfg: FmConfig, device: Devices = None, telemetry=None,
                extra_rungs=(), writer=None, devices: Devices = None):
    """Build the scorer for whatever ``cfg.model_file`` holds: an
    :class:`OverlayScorer` for a tiered overlay, else a
    :class:`FixedShapeScorer`, on the grid of ``device`` / ``devices``
    (None: every visible GPU) that ``mesh_data x mesh_model`` asks for.
    A checkpoint is read on the host, so one saved from any mesh, or by
    the other package, serves on any grid its shape allows.
    ``extra_rungs`` adds example counts to the ladder (offline predict
    adds its ``batch_size``); ``writer`` gets the interaction decision's
    ``record: autotune``."""
    grid_devices = _grid_devices(device, devices)
    fmt, step, model = load_model(cfg)
    if fmt == "tiered":
        w0, store = model
        return OverlayScorer(cfg, w0, store, devices=grid_devices,
                             telemetry=telemetry, step=step,
                             extra_rungs=extra_rungs, writer=writer)
    return FixedShapeScorer(cfg, model, devices=grid_devices,
                            telemetry=telemetry, step=step,
                            extra_rungs=extra_rungs, writer=writer)
