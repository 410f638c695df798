"""Training loop and offline predict — the counterpart of
``fast_tffm_tpu/train/loop.py``: the sparse and the dense path, on one
device or on a rank mesh.

:class:`Trainer` initialises the model (or warm-starts it, optimizer
state included, from ``<model_file>/params.npz`` or from the JAX
package's Orbax ``params/`` and ``opt/``, read without jax; a sparse FTRL
warm start normalizes a table off ``w == ftrl_solve(z, n)``, as the
reference's ``_check_ftrl_invariant`` does).  :meth:`Trainer.train`
reads one :class:`~fast_tffm_tpu_torch.data.pipeline.BatchPipeline` over
the run's epochs (``thread_num`` parse threads on the C++ parser, or
``parse_processes`` spawned workers with ``ring_slots``; host sort meta
attached when ``host_sort``; with ``cache_epochs`` epoch 0's batches
replayed in later epochs, and with ``cache_prestacked`` its packed
groups of K, reported as ``ingest_cache``), ships it through a
:class:`~fast_tffm_tpu_torch.data.prefetch.DevicePrefetcher` (super-batches
of ``steps_per_dispatch = K`` batches, one pinned copy each, up to
``prefetch_super_batches`` ahead) and runs :func:`train.sparse.
sparse_step` on each of a super-batch's K views: on the GPU the
FmScorer forward, FmGrad backward, K1 dedup and K2 apply kernels
(FmScorer and FmGrad in their bf16-input mode with ``compute_dtype =
bfloat16``; validation scores in f32, as the reference's
``make_eval_step``).  Field-aware FM (``field_num > 0``)
ships each batch's fields too and replaces FmScorer and FmGrad with the
FFM op's einsums and closed-form backward; K1 and K2 run as for FM, at
the FFM row width.  :meth:`Trainer.dispatch` trains one super-batch:
on one GPU with the host sort meta, every full super-batch after the
first is one replay of a CUDA graph of the K steps
(``train/dispatch.py``, the port's ``make_scan_train_step``); the first,
an epoch's tail, the sharded step, the device sort and the CPU run the
same steps eagerly, and ``train()`` reports the split
(``graph_dispatches``, ``eager_dispatches``).  The logging, validation
and save cadences are checked after each super-batch, and an epoch's
tail ships as a short one.  Streaming logloss/AUC accumulate on the
device, in place, and are read back only at those cadences.

The sparse/dense choice is the reference's (``Trainer.sparse``):
``sparse_update = true`` with a row-local optimizer and L2 runs the
sparse step; ``sparse_update = false``, ``optimizer = adam`` or
``l2_mode = full`` with a lambda runs :func:`train.dense.dense_step`
(the whole table's gradient and optimizer update every step, optax's
equations in ``train/optimizers.py``), after a log line when
``sparse_update = true`` asked otherwise.  It is dispatched, graphed,
saved (with its optimizer state) and restored like the sparse step.

Every save writes ``data_state.json`` beside ``params.npz``: the epoch
and the batches of it that trained (always a super-batch boundary), and
the input stream's fingerprint.  A warm start from a checkpoint of a
trained step (step > 0) continues the stream from there (the
reference's rules: a position saved under another fingerprint is
ignored with a warning; a completed run's position means ``epoch_num``
fresh epochs).

On a rank mesh (``mesh_data x mesh_model > 1``, after
``train.dist.initialize``) every rank builds the same seeded full table
and keeps its model shard, parses its data block's strided share of
the input at the local batch size ``batch_size / mesh_data``, steps
through ``train.shardmap_step.sparse_step_shardmap`` (both ``lookup``
values: PyTorch has no GSPMD) or, on the dense path,
``train.dense.dense_step_sharded`` (the reference's GSPMD step, which
reads no ``lookup``: the optimizer state row-sharded beside the table),
FM or field-aware FM, f32 or bf16 compute, and evaluates through the
same sharded forward in f32; metrics are summed over the ``data`` axis,
so every rank reports the global ones, and rank 0 writes the one
``params.npz`` (the optimizer state gathered with the table).

:meth:`Trainer.train_step` (one host batch, copied with
``train.sparse.to_device``) and :meth:`Trainer.evaluate` keep the plain
route to the device.  :func:`predict` scores ``predict_files`` through
the serving path's scorer for whatever the checkpoint holds
(``serve.scorer.make_scorer``: ``params.npz``, an Orbax directory or
``quant.npz`` at ``serve_table_dtype``, or a ``tiered.npz`` overlay),
with ``batch_size`` added as a rung, and writes one score per line in
input order.  A trainer refuses to warm-start over a ``quant.npz``, and
a dense one over a ``tiered.npz``.

With ``table_tiering = on`` (one device) the device tables are a hot
table of ``min(hot_rows, vocabulary_size)`` rows (``self.dcfg``) over
a host :class:`~fast_tffm_tpu_torch.train.tiered.TieredTable`: the
transfer stage's ``plan_hook`` (:meth:`Trainer._plan_group`) remaps
each super-batch's ids to hot slots and ships the migration plan in the
batch's copy, :meth:`Trainer.dispatch` applies it
(:meth:`Trainer._apply_migration`) before the steps, which sort the
remapped ids on the device and run eagerly; evaluation scores the
merged logical table, and a save writes the logical table
(``params.npz`` when it fits the dense format, else ``tiered.npz``).

Every dispatch of ``train()`` also advances the health carry
(:class:`HealthState`: the last and summed squared gradient norms, the
non-finite steps and the first of them, the touched rows and
occurrences), on the device and inside the CUDA graph; the host reads
its scalars one dispatch late, through a pinned slot and an event, and
applies ``nan_policy`` (``warn``, or ``halt`` with
:class:`NonFiniteGradError` and no checkpoint written).  The run
reports through the reference's planes: the ``telemetry`` registry
(``obs/telemetry.py``; the pipeline's and transfer stage's instruments,
``train.wait_input``, ``train.dispatch``, ``train.migrate``), the
``metrics_file`` stream (a ``.rankN`` file a rank), ``heartbeat_secs``,
the ``status_port`` endpoint and ``alert_rules``; the results carry the
exact ``health`` summary.  ``Trainer.device_step`` and ``train_step``
carry no health, as the reference's ``_train_step``.

The reference's other planes run too, each one only observing (a run
with every plane on trains bitwise the run with them off):

- **quality** (on by default): the parse threads or workers sketch each
  parsed batch (``obs/quality.py::StreamSketch``); each step of a
  ``train()`` dispatch copies its scores into a ``[K, B]`` device buffer
  the trainer owns (inside the CUDA graph too), which is copied
  non-blocking into one of two pinned host slots after the dispatch,
  with an event, and fed to the ``QualityMonitor`` one dispatch late
  with the labels and weights of the batch's host copy (never read from
  the device); the ``quality`` block rides the records and results, and
  every save publishes the sketches in ``serve_manifest.json``;
- **trace** (``trace_file``): ``train.wait_input``, ``train.migrate``,
  ``train.dispatch`` (a host span: the CUDA work it enqueues runs
  asynchronously) and ``train.compile`` (a graph capture), joined by
  super-batch id to the pipeline's and transfer stage's spans;
- **blackbox** (on by default): the record and alert rings, and a bundle
  on a crash (``nan_policy = halt`` included), on an alert and on ``POST
  /incident``;
- the **compile sentinel** (``resource_metrics``): each graph capture is
  a ``record: compile`` (its K and wall seconds), and the ``resource``
  block carries the sentinel's counts and the process's kernel and parser
  builds;
- the **profiler** (``profile_dir``, and ``/profile?secs=N``): a
  ``torch.profiler`` window (``obs/profiler.py``);
- the **training fleet** (``train_fleet_scrape``): rank 0 scrapes every
  rank's ``/status`` into the ``fleet`` block, and each rank times one
  small all-reduce after each dispatch as ``train.exchange``.

The interaction choice is the reference's (``ops/autotune.py``):
``interaction_impl`` pins ``reference``, ``pallas`` or ``packed``, or
with ``auto`` is measured at the run's shapes on the trainer's device
before any graph is captured (a ``record: autotune`` in the
``metrics_file`` stream); ``""`` keeps the legacy ``interaction`` /
``use_pallas`` derivation (the kernels by default).  Every one-device
step, the graphed ones included, and the validation scores run the
resolved impl (``kernel_impl`` in the run header).  On a rank mesh the
sharded step is the closed form of the reference's
``train/shardmap_step.py``, which reads no impl; the trainer still
resolves and records the decision, as the reference does on every
process.  ``compile_cache_dir`` (the reference's XLA cache) only places
the autotuner's ``autotune_cache.json`` (``ops/autotune.py::
default_cache_path``) and is otherwise logged as inert: it changes no
parameter.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.libsvm import Batch
from fast_tffm_tpu_torch.data.pipeline import BatchPipeline, EpochEnd
from fast_tffm_tpu_torch.data.prefetch import (
    DevicePrefetcher, Packer, SuperBatch,
)
from fast_tffm_tpu_torch.models import fm
from fast_tffm_tpu_torch.obs.alerts import AlertEngine, halt_error, parse_rules
from fast_tffm_tpu_torch.obs.heartbeat import (
    Heartbeat, JsonlWriter, rank_suffix_path,
)
from fast_tffm_tpu_torch.obs.blackbox import Blackbox
from fast_tffm_tpu_torch.obs.fleet import TrainFleet
from fast_tffm_tpu_torch.obs.profiler import ProfileWindow
from fast_tffm_tpu_torch.obs.quality import QualityMonitor, StreamSketch
from fast_tffm_tpu_torch.obs.resource import (
    CompileSentinel, basic_block, build_block,
)
from fast_tffm_tpu_torch.obs.status import StatusServer, render_prometheus
from fast_tffm_tpu_torch.obs.telemetry import Telemetry
from fast_tffm_tpu_torch.obs.trace import Tracer
from fast_tffm_tpu_torch.ops import autotune as autotune_lib
from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.parallel.mesh import (
    DATA_AXIS, Mesh, barrier, data_partition, make_mesh, psum,
)
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.train import checkpoint, metrics as metrics_lib
from fast_tffm_tpu_torch.train import tiered as tiered_lib
from fast_tffm_tpu_torch.train import tiered_fleet
from fast_tffm_tpu_torch.train.dense import dense_step, dense_step_sharded
from fast_tffm_tpu_torch.train.dispatch import GraphedSteps
from fast_tffm_tpu_torch.train.optimizers import init_dense_opt_state
from fast_tffm_tpu_torch.train.shardmap_step import (
    entries_prefetch, exchange_mode, local_scores, overlap_active,
    sparse_step_shardmap, supports_tiles,
)
from fast_tffm_tpu_torch.train.sparse import (
    SparseFtrlState, init_sparse_opt_state, sparse_step, supports_sparse,
    to_device,
)

log = logging.getLogger(__name__)

__all__ = ["HealthState", "MetricState", "NonFiniteGradError", "Trainer",
           "config_fingerprint", "predict"]

# (setting, description) pairs of the reference's planes the port's
# trainer accepts but does not act on: the XLA compile cache has no
# counterpart (the kernels build once into ops/_build/); its directory
# only places the interaction autotuner's cache file.
_INERT_PLANES = (
    ("compile_cache_dir",
     "compile cache (it only places the autotuner's autotune_cache.json)"),
)


def _multi_rank(cfg: FmConfig) -> bool:
    """True when the run has more than one rank: the config's mesh asks
    for several, or several joined the process group."""
    dist = torch.distributed
    return cfg.mesh_data * cfg.mesh_model > 1 or (
        dist.is_available() and dist.is_initialized()
        and dist.get_world_size() > 1
    )


def _sparse(cfg: FmConfig) -> bool:
    """The reference's choice: the sparse step when asked for and the
    optimizer and L2 are row-local, else the dense optax path."""
    return bool(cfg.sparse_update) and supports_sparse(cfg)


def _log_inert(cfg: FmConfig) -> None:
    """Log the settings the port accepts but does not act on."""
    inert = [desc for key, desc in _INERT_PLANES if getattr(cfg, key)]
    if inert:
        log.info(
            "the PyTorch port's trainer does not act on these settings "
            "(parameters are unaffected): %s", ", ".join(inert),
        )


class _Fleet(NamedTuple):
    """``tiered_partition = shards``: the tier shard count (the mesh's
    model columns) and the shards this rank owns."""

    num_shards: int
    owned: tuple


def _rank_grid() -> tuple:
    """``(world, rank)`` of the process group, ``(1, 0)`` without one."""
    d = torch.distributed
    if d.is_available() and d.is_initialized():
        return d.get_world_size(), d.get_rank()
    return 1, 0


def _tiered_device_config(cfg: FmConfig) -> tuple:
    """``(dcfg, fleet)`` of a ``table_tiering = on`` run: the
    configuration its device side is built from (``vocabulary_size`` the
    hot table's rows; ingest keeps the logical vocabulary) and its
    :class:`_Fleet` under ``tiered_partition = shards`` (None: the
    host-global table), after the reference's choice and refusals
    (``fast_tffm_tpu/train/loop.py``, ``Trainer.__init__``).  ``auto``
    is ``shards`` when there is more than one rank.  The fleet's mesh is
    the config's grid of ranks, one process each, so only a ``1 x R``
    mesh has columns of one process (``tiered_fleet.column_owners``)."""
    if not _sparse(cfg):
        raise ValueError(
            "table_tiering=on requires the sparse update path "
            "(optimizer in adagrad/ftrl/sgd with batch-mode L2): "
            "a dense optimizer rewrites every row every step, so "
            "there is no cold set to keep off-device"
        )
    part = cfg.tiered_partition
    if part == "auto":
        part = "shards" if _multi_rank(cfg) else "global"
    if part == "global" and _multi_rank(cfg):
        raise ValueError(
            "tiered_partition=global is single-process (the "
            "hot-slot map is host-global); multi-process tiered "
            "training needs tiered_partition=shards (or auto)"
        )
    if cfg.lookup == "shardmap":
        raise ValueError(
            "table_tiering=on does not compose with "
            "lookup=shardmap yet; use lookup=auto"
        )
    hot = min(cfg.hot_rows, cfg.vocabulary_size)
    fleet = None
    if part == "shards":
        # Shard == model column: the rank holding a column's device rows
        # is the one allowed to hold its cold store.  column_owners
        # refuses a data axis of several ranks, so every rank parses
        # the whole global batch, as the lockstep mirrors need.
        world, rank = _rank_grid()
        d, m = cfg.mesh_data, cfg.mesh_model
        if d * m == 1 and world > 1:
            d, m = world, 1  # make_mesh's all-data mesh
        owners = tiered_fleet.column_owners(Mesh(d, m))
        if cfg.vocabulary_size % m or hot % m:
            raise ValueError(
                f"tiered_partition=shards needs vocabulary_size "
                f"({cfg.vocabulary_size}) and effective hot_rows "
                f"({hot}) divisible by the mesh model size ({m})"
            )
        fleet = _Fleet(m, tuple(s for s, o in enumerate(owners)
                                if o == rank))
        if cfg.validation_files and len(fleet.owned) != m:
            raise ValueError(
                "validation_files with fleet-sharded tiering: "
                "evaluation needs every shard's cold store, but "
                f"this rank owns {len(fleet.owned)} of "
                f"{m} shards.  Evaluate from the saved "
                "checkpoint instead (it merges all shards)."
            )
    if cfg.hot_rows >= cfg.vocabulary_size:
        log.info(
            "table_tiering=on with hot_rows >= vocabulary_size: "
            "every row fits the hot table (tiering is a no-op "
            "beyond the remap)"
        )
    return dataclasses.replace(cfg, vocabulary_size=hot), fleet


def _check_mesh(cfg: FmConfig, dcfg: FmConfig, mesh: Mesh,
                sparse: bool) -> bool:
    """Refusals and notices of the rank mesh, as the reference's, for a
    step built from ``dcfg`` (the hot table's under tiering).  Returns
    whether the entries exchange's id plane overlaps the previous step
    (``sparse_exchange_overlap``, resolved as the reference's
    ``Trainer.__init__``: ``lookup = shardmap`` on a mesh and the dense
    step block it, ``on`` then raises)."""
    if mesh.size > 1:
        if not supports_tiles(dcfg, mesh):
            if dcfg is not cfg:
                # The reference's GSPMD step takes any hot_rows the
                # shard count divides (ROADMAP.md Queue 3, by design).
                raise ValueError(
                    "table_tiering=on on a rank mesh runs the hand-sharded "
                    f"step over the hot table: hot_rows "
                    f"({dcfg.vocabulary_size}) / mesh_model ({mesh.model}) "
                    f"must be a whole number of {sparse_apply.TILE}-row "
                    f"tiles (hot_rows divisible by mesh_model*"
                    f"{sparse_apply.TILE})"
                )
            # The port's steps on a mesh work in whole tiles of a model
            # shard (ROADMAP.md Queue 3, by design).
            raise ValueError(
                f"a rank mesh splits the table into model shards of whole "
                f"{sparse_apply.TILE}-row tiles: vocabulary_size "
                f"({cfg.vocabulary_size}) must be divisible by mesh_model "
                f"({mesh.model}) * {sparse_apply.TILE}"
            )
        if cfg.batch_size % mesh.data:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by {mesh.data} "
                f"data blocks"
            )
        if sparse:
            b_local = cfg.batch_size // mesh.data
            exchange = exchange_mode(dcfg, mesh, b_local * cfg.max_features)
            log.info(
                "rank %d of a %dx%d (data x model) mesh, backend %s: "
                "lookup=%s runs the hand-sharded step (PyTorch has no "
                "GSPMD), sparse_exchange=%s resolved to %s", mesh.rank,
                mesh.data, mesh.model, mesh.backend, cfg.lookup,
                cfg.sparse_exchange, exchange,
            )
        else:
            # The reference's dense step never reads lookup: GSPMD
            # partitions it whatever lookup says.
            log.info(
                "rank %d of a %dx%d (data x model) mesh, backend %s: the "
                "dense optax path (optimizer=%s, l2_mode=%s) runs row-"
                "sharded over model with its optimizer state, the "
                "gradient summed over data (the reference's GSPMD step, "
                "which does not read lookup=%s)", mesh.rank, mesh.data,
                mesh.model, mesh.backend, cfg.optimizer, cfg.l2_mode,
                cfg.lookup,
            )
    if cfg.sparse_exchange_overlap == "off":
        return False
    if not sparse or (cfg.lookup == "shardmap" and mesh.size > 1):
        if cfg.sparse_exchange_overlap == "on":
            raise ValueError(
                "sparse_exchange_overlap=on requires the sparse "
                "gather/apply step (optimizer in adagrad/ftrl/"
                "sgd, lookup != shardmap); this run resolved to "
                + ("the dense step" if not sparse else "lookup=shardmap")
            )
        return False
    overlap = overlap_active(dcfg, mesh)
    if overlap:
        log.info(
            "sparse exchange overlap active: entries streams "
            "prefetch one step ahead of the rank-local apply"
        )
    return overlap


class MetricState(NamedTuple):
    """Streaming training/eval metrics, device tensors."""

    loss_sum: torch.Tensor  # weighted sum of per-example data losses
    weight_sum: torch.Tensor
    count: torch.Tensor  # UNWEIGHTED number of real (weight > 0) examples
    auc: metrics_lib.AucState

    @staticmethod
    def zeros(device) -> "MetricState":
        def z():
            return torch.zeros((), dtype=torch.float32, device=device)

        return MetricState(z(), z(), z(), metrics_lib.auc_init(device=device))

    def add_(self, scores, batch: Batch, loss_type: str):
        """Fold a batch into this state in place (a CUDA graph of the
        train step holds the same tensors); returns the batch's
        ``(weighted loss sum, weight sum)``."""
        lsum, wsum = metrics_lib.weighted_loss(
            scores, batch.labels, batch.weights, loss_type
        )
        self.loss_sum.add_(lsum)
        self.weight_sum.add_(wsum)
        self.count.add_(torch.sum((batch.weights > 0).float()))
        metrics_lib.auc_add_(self.auc, scores, batch.labels, batch.weights)
        return lsum, wsum

    def psum_data(self, mesh: Mesh) -> "MetricState":
        """This state summed over the mesh's ``data`` axis (every rank
        then holds the global metrics; the AUC bins add up)."""
        if mesh.data == 1:
            return self
        flat = torch.cat([
            self.loss_sum.reshape(1), self.weight_sum.reshape(1),
            self.count.reshape(1), self.auc.pos, self.auc.neg,
        ])
        flat = psum(flat, DATA_AXIS, mesh)
        bins = self.auc.pos.numel()
        return MetricState(flat[0], flat[1], flat[2], metrics_lib.AucState(
            flat[3:3 + bins], flat[3 + bins:]))

    def finalize(self, loss_type: str = "logistic") -> dict:
        """Streaming means (reads the device).  The loss key is
        ``logloss`` for logistic training and ``mse`` for mse (plus the
        ``loss`` alias)."""
        wsum = max(float(self.weight_sum), 1e-12)
        loss = float(self.loss_sum) / wsum
        out = {
            "loss": loss,
            "auc": float(metrics_lib.auc_finalize(self.auc)),
            "examples": float(self.count),
            "weight_sum": float(self.weight_sum),
        }
        out["mse" if loss_type == "mse" else "logloss"] = loss
        return out


class NonFiniteGradError(RuntimeError):
    """Raised by ``nan_policy = halt`` when a dispatch produced a
    non-finite (NaN/inf) gradient.  Training stops WITHOUT overwriting
    the checkpoint with poisoned parameters (periodic saves from before
    the event survive); the metrics stream's final record carries the
    exception type and the health counters."""


class HealthState(NamedTuple):
    """The training-health carry (``fast_tffm_tpu/train/loop.py::
    HealthState``), device tensors updated IN PLACE once per step of a
    ``train()`` dispatch, inside a CUDA graph's replay too: every tensor
    keeps its address for the trainer's life, and ``step`` (the run's
    steps so far) is advanced on the device, so a replay stamps
    ``first_nonfinite_step`` with the step it trained.  The host reads
    the carry only at dispatch boundaries, one dispatch late."""

    grad_sq_last: torch.Tensor  # f32: the last step's squared grad norm
    grad_sq_sum: torch.Tensor  # f32: summed over the run (RMS)
    nonfinite_steps: torch.Tensor  # i32: steps with a non-finite grad
    first_nonfinite_step: torch.Tensor  # i32: the run's step, -1 never
    # f32 as the reference's: exact to 2^24 occurrences.
    touch_events: torch.Tensor  # f32: real (val != 0) occurrences
    # bool [V + 1]: rows touched this run; the last entry takes the
    # padded occurrences, which count nowhere.
    rows_seen: torch.Tensor
    step: torch.Tensor  # i32: steps of this run so far

    @staticmethod
    def zeros(vocab: int, device) -> "HealthState":
        def z(dtype):
            return torch.zeros((), dtype=dtype, device=device)

        return HealthState(
            z(torch.float32), z(torch.float32), z(torch.int32),
            torch.full((), -1, dtype=torch.int32, device=device),
            z(torch.float32),
            torch.zeros((vocab + 1,), dtype=torch.bool, device=device),
            z(torch.int32))

    @property
    def rows_touched(self) -> torch.Tensor:
        return self.rows_seen[:-1]

    def reset_(self) -> None:
        """Back to a fresh run, in place (a captured graph holds these
        tensors)."""
        for t in (self.grad_sq_last, self.grad_sq_sum, self.nonfinite_steps,
                  self.touch_events, self.rows_seen, self.step):
            t.zero_()
        self.first_nonfinite_step.fill_(-1)

    def update_(self, grad_sq: torch.Tensor, nonfinite: torch.Tensor,
                batch: Batch) -> None:
        """Fold one step's ``(grad_sq, nonfinite)`` pair and its batch's
        real ids into the carry, on the device (the reference's
        ``make_health_update``)."""
        vocab = self.rows_seen.numel() - 1
        bad = nonfinite > 0
        real = batch.vals.reshape(-1) != 0
        ids = torch.where(real, batch.ids.reshape(-1).long(), vocab)
        self.grad_sq_last.copy_(grad_sq)
        self.grad_sq_sum.add_(grad_sq)
        self.nonfinite_steps.add_(bad.to(torch.int32))
        self.first_nonfinite_step.copy_(torch.where(
            bad & (self.first_nonfinite_step < 0), self.step,
            self.first_nonfinite_step))
        self.touch_events.add_(torch.count_nonzero(batch.vals))
        self.rows_seen.index_fill_(0, ids, True)
        self.step.add_(1)


def config_fingerprint(cfg: FmConfig) -> str:
    """Short stable hash of the FULL config, the run header's identity:
    the reference's ``_config_fingerprint`` over the same ``FmConfig``
    fields, so both packages give one config the same hash."""
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class _RunClock:
    """The wall-clock split of a run, written by the loop's thread and
    read by the heartbeat and HTTP threads (plain floats: no device
    read): time waiting for input, in dispatches, and the steps so
    far."""

    def __init__(self) -> None:
        self.t0 = time.time()
        self.wait_s = self.dispatch_s = 0.0
        self.steps = 0


class _ExchangeProbe:
    """``train.exchange``: one small all-reduce of the process group
    enqueued after each dispatch (the reference's exchange probe).  With
    the exchange overlap on it is waited on one dispatch later, so at
    parity the wait is ~0 and a straggler shows as its lag; without, it
    is waited on at once, and the wait holds the synchronous window the
    overlap exists to remove.  Under NCCL the all-reduce runs on the
    card and the host waits on an event recorded after it; under gloo
    it runs on a CPU tensor and the host waits on the work itself."""

    def __init__(self, mesh: Mesh, device: torch.device, timer,
                 overlap: bool):
        self._nccl = mesh.backend == "nccl"
        self._device = device if self._nccl else torch.device("cpu")
        self._timer = timer
        self._overlap = overlap
        self._pending = None

    def _wait(self, done) -> None:
        with self._timer.time():
            if self._nccl:
                done.synchronize()
            else:
                done.wait()

    def __call__(self) -> None:
        t = torch.ones(1, device=self._device)
        work = torch.distributed.all_reduce(t, async_op=True)
        done = work
        if self._nccl:
            work.wait()  # the current stream waits for the collective
            done = torch.cuda.Event()
            done.record()
        if not self._overlap:
            self._wait(done)
            return
        if self._pending is not None:
            self._wait(self._pending)
        self._pending = done

    def close(self) -> None:
        if self._pending is not None:
            self._wait(self._pending)
            self._pending = None


class Trainer:
    """Drives sparse or dense training per an :class:`FmConfig`, on
    ``device`` (the GPU unless asked otherwise): on one device, or as
    this rank of the config's mesh once ``train.dist.initialize`` has
    run."""

    def __init__(self, cfg: FmConfig,
                 device: Optional[Union[str, torch.device]] = None):
        # With tiering on, the device tables are the hot table's
        # (``dcfg``); the logical vocabulary stays the input's.  The tier
        # manager is host-global, or rank-sharded (``fleet``).
        self.tiered: Optional[Union[tiered_lib.TieredTable,
                                    tiered_fleet.ShardedTiering]] = None
        self.dcfg, self.fleet = (_tiered_device_config(cfg)
                                 if cfg.table_tiering == "on"
                                 else (cfg, None))
        _log_inert(cfg)
        self.cfg = cfg
        self.sparse = _sparse(cfg)
        if cfg.sparse_update and not self.sparse:
            log.info(
                "sparse_update unsupported for optimizer=%s l2_mode=%s; "
                "using dense optax path", cfg.optimizer, cfg.l2_mode,
            )
        self.device = resolve_device(device)
        self.mesh = make_mesh(cfg)
        self.overlap = _check_mesh(cfg, self.dcfg, self.mesh, self.sparse)
        self.sharded = self.mesh.size > 1
        # The interaction (ops/autotune.py): interaction_impl=auto
        # measures the candidates at this run's shapes on this device and
        # promotes the fastest that passes the parity gate, before any
        # graph is captured; pins and the legacy knobs resolve with no
        # measurement.  `interaction` is the dispatch name every step and
        # the validation scores run, `kernel_impl` its user-facing name.
        self._autotune: Optional[autotune_lib.Decision] = None
        self.interaction = self.dcfg.interaction_resolved
        if self.interaction == "auto":
            self._autotune = autotune_lib.resolve(
                self.dcfg, context="train", device=self.device)
            self.interaction = self._autotune.interaction
        self.kernel_impl = autotune_lib.USER[self.interaction]
        log.info(
            "step build: sparse=%s interaction=%s (kernel_impl=%s) "
            "device=%s mesh=%s%s", self.sparse, self.interaction,
            self.kernel_impl, self.device,
            {"data": self.mesh.data, "model": self.mesh.model},
            ("; the sharded step runs its own closed form "
             "(train/shardmap_step.py) and reads no impl"
             if self.sharded else ""),
        )
        self.model, self.opt_state, self._restored_step = (
            self._init_or_restore_tiered() if cfg.table_tiering == "on"
            else self._init_or_restore()
        )
        # Updated in place, as the model and optimizer tensors are: a
        # captured graph holds all of them.
        self.metrics = MetricState.zeros(self.device)
        # The health carry train()'s dispatches advance, and the two host
        # slots its one-dispatch-late readback alternates between (pinned
        # on the card, so the copy into them is asynchronous).
        self.health = HealthState.zeros(self.dcfg.vocabulary_size,
                                        self.device)
        pin = self.device.type == "cuda"
        self._health_slots = [torch.zeros(3, pin_memory=pin)
                              for _ in range(2)]
        self._health_host: dict = {}
        self.telemetry = Telemetry(enabled=cfg.telemetry)
        # The causal trace (obs/trace.py): rank 0 owns the configured
        # path, ranks > 0 suffix theirs; off, every span is a no-op.
        _, rank = _rank_grid()
        self._trace_path = cfg.trace_file
        if cfg.trace_file and rank > 0:
            self._trace_path = f"{cfg.trace_file}.rank{rank}"
        self.tracer = Tracer(
            enabled=bool(cfg.trace_file),
            process_name=f"trainer rank{rank}",
            rotate_events=cfg.trace_rotate_events,
            rotate_path=self._trace_path,
        )
        # The compile sentinel: the graph captures are the port's
        # compiles (resource_metrics off: no sentinel, no block).
        self._sentinel = (CompileSentinel(
            telemetry=self.telemetry,
            expected_k=max(1, cfg.steps_per_dispatch))
            if cfg.resource_metrics else None)
        # The quality plane, per run (train() makes them): the drift
        # sketches and the windowed online eval.  The scores buffer
        # [K, B] is the trainer's own (a captured graph writes it), read
        # back through two pinned host slots.
        self._quality: Optional[QualityMonitor] = None
        self._quality_sketch: Optional[StreamSketch] = None
        self._scores_dev: Optional[torch.Tensor] = None
        self._score_slots: list = []
        self._profile = ProfileWindow(self.device.type == "cuda")
        self._profile_capture_dir = "."
        self._metrics_writer = None
        self._run = _RunClock()
        self._sb_id = 0  # the super-batch train() dispatches (trace id)
        self.status_port = 0  # the status endpoint's bound port
        # The input position a save records: the epoch, and the batches
        # of it that trained.
        self._epoch = self._batches_done = 0
        self.eager_reason = self._eager_reason()
        self.graph = (None if self.eager_reason else GraphedSteps(
            max(1, cfg.steps_per_dispatch)))
        self.graph_dispatches = self.eager_dispatches = 0

    def _eager_reason(self) -> Optional[str]:
        """Why this trainer's dispatches run eagerly (None: graphed).  The
        device sort is static (``ops/sparse_apply.py::sort_meta``), so
        ``host_sort = false`` on one card is graphed."""
        if self.device.type != "cuda":
            return f"the {self.device.type} device has no CUDA graphs"
        if self.tiered is not None:
            return ("table_tiering=on migrates rows between dispatches "
                    "through plan buffers sized by each super-batch, which "
                    "a graph cannot hold at fixed addresses (ROADMAP.md "
                    "port queue item 7a)")
        if self.sharded and self.mesh.backend != "nccl":
            return (f"the {self.mesh.backend} mesh stages every collective "
                    "through pinned host memory, which a CUDA graph cannot "
                    "capture (ROADMAP.md port queue item 7a)")
        if self.sharded:
            return ("the sharded step's NCCL collectives are not graphed: "
                    "after a graphed run the process group's teardown "
                    "hangs (ROADMAP.md port queue item 7a)")
        return None

    def _init_or_restore(self):
        """The model and optimizer state (this rank's model shard on a
        mesh), from the checkpoint or freshly initialised: the full
        table from the seeded generator, then cut, so every mesh starts
        from the single-device run's weights."""
        cfg = self.cfg
        row_lo, vocab_local = self.mesh.row_range(cfg.vocabulary_size)
        rows = slice(row_lo, row_lo + vocab_local) if self.sharded else None
        if checkpoint.exists_tiered(cfg.model_file):
            # Refuse rather than cold-start over (or prefer a stale dense
            # file beside) an overlay holding a table too large for the
            # dense format.
            raise ValueError(
                f"{cfg.model_file} holds a tiered overlay checkpoint "
                "(written by table_tiering=on at a vocabulary too large "
                "for the dense format); resume it with table_tiering=on, "
                "or point model_file somewhere fresh to train dense"
            )
        if checkpoint.exists_quant(cfg.model_file):
            # Training wants full-precision params, and the quantized
            # table carries no optimizer state.
            raise ValueError(
                f"{cfg.model_file} holds a quantized serving checkpoint "
                "(quant.npz); training cannot warm-start from it — "
                "convert it back to the dense format first "
                "(python -m fast_tffm_tpu_torch.tools.convert_checkpoint "
                "<dir> --to fp32), or point model_file somewhere fresh"
            )
        init_opt = (init_sparse_opt_state if self.sparse
                    else init_dense_opt_state)
        if checkpoint.exists(cfg.model_file):
            log.info("warm-starting from %s", cfg.model_file)
            step, model = checkpoint.restore_params(
                cfg.model_file, device=self.device, rows=rows,
                shape=(cfg.vocabulary_size, cfg.embedding_dim),
            )
            opt = checkpoint.restore_opt_state(
                cfg.model_file, cfg.optimizer, device=self.device, rows=rows,
                sparse=self.sparse,
            )
            if opt is None:
                log.info("checkpoint holds no %s state; initialising it",
                         cfg.optimizer)
                opt = init_opt(cfg, model)
            elif self.sparse and cfg.optimizer == "ftrl":
                with torch.no_grad():
                    model = fm.FmModel(*self._ftrl_normalize(
                        model.w0, model.table, opt,
                        "so the compact-K2 apply stays sweep-independent"))
            return model, opt, step
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        model = fm.init_params(cfg, gen, device=self.device)
        if rows is not None:
            model = fm.FmModel(model.w0.detach(),
                               model.table.detach()[rows].clone())
        return model, init_opt(cfg, model), 0

    def _init_or_restore_tiered(self):
        """The HOT device state and the host :class:`tiered_lib.
        TieredTable` (``fast_tffm_tpu/train/loop.py::
        _init_or_restore_tiered``).  The hot tables' initial values are
        placeholders (a slot counts only once a migration load has
        written its cold row), drawn from the seeded generator at
        ``hot_rows`` rows.  The checkpoint of record is the LOGICAL
        table: a ``tiered.npz`` overlay when present, else a dense
        checkpoint (``params.npz`` or Orbax) read to host numpy (never at
        ``[V, D]`` on the card) to seed the cold stores, so a tiered run
        resumes from a dense run's checkpoint, and the other way round,
        at any ``hot_rows``."""
        cfg, dcfg, dev = self.cfg, self.dcfg, self.device
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        model = fm.init_params(dcfg, gen, device=dev)
        if self.sharded:  # this rank's hot slots
            lo, n = self.mesh.row_range(dcfg.vocabulary_size)
            model = fm.FmModel(model.w0.detach(),
                               model.table.detach()[lo:lo + n].clone())

        def put(x):
            return torch.tensor(float(np.float32(x)), dtype=torch.float32,
                                device=dev)

        def with_w0(w0):
            return fm.FmModel(put(w0), model.table.detach())

        if checkpoint.exists_quant(cfg.model_file):
            raise ValueError(
                f"{cfg.model_file} holds a quantized serving checkpoint "
                "(quant.npz); a tiered trainer cannot warm-start from "
                "it — convert it back to the dense format first "
                "(python -m fast_tffm_tpu_torch.tools.convert_checkpoint "
                "<dir> --to fp32)"
            )
        overlay = checkpoint.restore_tiered(cfg.model_file)
        if overlay is not None:
            step, scalars, stores = overlay
            log.info("warm-starting tiered table from overlay checkpoint "
                     "%s (step %d)", cfg.model_file, step)
            self.tiered = self._make_tier_manager(overlay=stores)
            model = with_w0(scalars["w0"])
            opt = tiered_lib.set_opt_scalars(
                cfg.optimizer, init_sparse_opt_state(dcfg, model), scalars,
                put)
            return model, opt, step
        if checkpoint.exists(cfg.model_file):
            log.info("warm-starting tiered table from dense checkpoint %s",
                     cfg.model_file)
            step, w0, table, opt_np = checkpoint.restore_host(
                cfg.model_file, cfg.optimizer)
            shape = (cfg.vocabulary_size, cfg.embedding_dim)
            if table.shape != shape:
                raise ValueError(
                    f"checkpoint table is {table.shape} but the config "
                    f"wants {shape}"
                )
            if opt_np is not None and cfg.optimizer == "ftrl":
                w0, table = self._ftrl_normalize_np(w0, table, opt_np)
            dense_tables = {"table": table}
            # The w0 optimizer slots: restored when present, else from
            # the restored w0, as the dense trainer's init on restored
            # parameters gives them.
            model = with_w0(w0)
            opt = init_sparse_opt_state(dcfg, model)
            if opt_np is not None:
                dense_tables.update(zip(
                    tiered_lib.opt_table_names(cfg.optimizer),
                    tiered_lib.get_opt_tables(cfg.optimizer, opt_np)))
                opt = tiered_lib.set_opt_scalars(
                    cfg.optimizer, opt,
                    tiered_lib.get_opt_scalars(cfg.optimizer, opt_np), put)
            self.tiered = self._make_tier_manager(dense_tables=dense_tables)
            return model, opt, step
        self.tiered = self._make_tier_manager()
        return model, init_sparse_opt_state(dcfg, model), 0

    def _make_tier_manager(self, dense_tables=None, overlay=None):
        """The host-global :class:`tiered_lib.TieredTable`, or under
        ``tiered_partition = shards`` the rank-sharded
        :class:`tiered_fleet.ShardedTiering`; restore payloads are global
        either way (the fleet cuts them per shard: elastic checkpoints)."""
        if self.fleet is not None:
            return tiered_fleet.ShardedTiering(
                self.cfg, self.fleet.num_shards, self.fleet.owned,
                dense_tables=dense_tables, overlay=overlay,
                device=self.device)
        return tiered_lib.TieredTable(self.cfg, dense_tables=dense_tables,
                                      overlay=overlay, device=self.device)

    def _ftrl_normalize(self, w0, table, opt, why: str) -> tuple:
        """The sparse FTRL applies rely on ``w == ftrl_solve(z, n)``: a
        restored ``(w0, table)`` off it by more than 1e-6 (edited outside
        training) is replaced, with a warning, by the closed form
        (``fast_tffm_tpu/train/loop.py::_check_ftrl_invariant``).  Torch
        tensors on any device; the restored bits are kept when the
        invariant holds."""
        cfg = self.cfg

        def solve(z, n):
            return sparse_apply.ftrl_solve(
                z, n, cfg.learning_rate, cfg.ftrl_l1, cfg.ftrl_l2,
                cfg.ftrl_beta)

        want_w0 = solve(opt.z_w0, opt.n_w0)
        want_table = solve(opt.z_table, opt.n_table)
        dev = max(float((want_w0 - w0).abs().max()),
                  float((want_table - table).abs().max()))
        if dev <= 1e-6:
            return w0, table
        log.warning(
            "warm-started FTRL params violate w == ftrl_solve(z, n) "
            "(max |dev| %.3g) — the table was edited outside "
            "train.sparse.  Normalizing w = ftrl_solve(z, n) %s.", dev, why,
        )
        return want_w0, want_table

    def _ftrl_normalize_np(self, w0, table, opt_np) -> tuple:
        """:meth:`_ftrl_normalize` on host numpy, before the restored
        table seeds the tiered cold store."""
        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32))

        w0_t, table_t = self._ftrl_normalize(
            t(w0), t(table), SparseFtrlState(*(t(a) for a in opt_np)),
            "before seeding the tiered cold store, matching the dense "
            "restore path")
        return np.float32(w0_t.numpy()), table_t.numpy()

    def _plan_group(self, group: list) -> tuple:
        """The transfer stage's ``plan_hook`` under tiering: the group's
        logical ids remapped to hot slots through one plan of the
        super-batch (``fast_tffm_tpu/train/loop.py::_put_super``); the
        fleet ships only this rank's column blocks of it."""
        new_ids, plan = self.tiered.plan(np.stack([b.ids for b in group]))
        if self.fleet is not None:
            plan = self.tiered.local_plan(plan)
        return [b._replace(ids=new_ids[i], sort_meta=None)
                for i, b in enumerate(group)], plan

    def _hot_tables(self) -> tuple:
        """The device hot tables, params first, in the stores' order."""
        return (self.model.table,) + tiered_lib.get_opt_tables(
            self.cfg.optimizer, self.opt_state)

    def _hot_host_tables(self) -> list:
        """Host copies of the device hot tables (waits for the device)."""
        return [t.detach().cpu().numpy() for t in self._hot_tables()]

    def _tier_host_tables(self):
        """The host tables the tier manager takes: :meth:`_hot_host_tables`,
        or for the fleet ``{shard: that column's rows of each}`` for the
        owned shards, in the order the rank's hot table holds them."""
        host = self._hot_host_tables()
        if self.fleet is None:
            return host
        hs = self.tiered.hs
        return {s: [t[k * hs:(k + 1) * hs] for t in host]
                for k, s in enumerate(sorted(self.tiered.owned))}

    @staticmethod
    def _evicted_rows(tables: list, slots: torch.Tensor) -> tuple:
        """``(rows, event)``: the tables' rows at ``slots``, for a
        write-back ledger.  On the card one non-blocking copy into a
        pinned host buffer and a CUDA event after it (the ledger reads
        the buffer once the event has completed); on the CPU the rows
        themselves and no event."""
        rows = torch.stack([t.index_select(0, slots) for t in tables])
        event = None
        if rows.is_cuda:
            host = torch.empty(rows.shape, dtype=rows.dtype,
                               pin_memory=True)
            host.copy_(rows, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            rows = host
        return tuple(rows.unbind(0)), event

    def _apply_migration(self, shipment: tiered_lib.Shipment) -> SuperBatch:
        """Apply a super-batch's migration plan to the hot tables between
        dispatches (``fast_tffm_tpu/train/loop.py::_apply_migration``);
        the plan's device halves arrived with the batch, after the
        stream's wait on their copy.  The evicted slots are gathered
        first, stream order putting the gather after the previous
        dispatch and before the loads: one non-blocking copy into a
        pinned host buffer and an event after it go to the write-back
        ledger, which reads the buffer only once the event has
        completed.  Then the loaded rows overwrite their slots.  Only
        the first ``n_load`` / ``n_evict`` entries are used: the padding
        is never written.  Returns the super-batch to dispatch."""
        man, sh = self.tiered, shipment
        tables = [t.detach() for t in self._hot_tables()]
        with torch.no_grad():
            if sh.n_evict:
                man.push_writeback(sh.plan_id, *self._evicted_rows(
                    tables, sh.evict_slots[:sh.n_evict]))
            if sh.n_load:
                slots = sh.load_slots[:sh.n_load].long()
                for t, r in zip(tables, sh.load_rows):
                    t.index_copy_(0, slots, r[:sh.n_load])
                man.note_applied(sh)
        return sh.batch

    def _apply_migration_fleet(self, shipment: tiered_fleet.FleetShipment):
        """The fleet half of :meth:`_apply_migration`
        (``fast_tffm_tpu/train/loop.py::_apply_migration_fleet``): each
        owned column's block of the plan, its slots column-local, is
        applied to that column's rows of the rank's hot tables.  The
        evicted rows go to the owned shard's write-back ledger, the loads
        are ``index_copy_`` of the rank's own rows: no collective, no
        other rank's rows."""
        man, plan = self.tiered, shipment.plan
        tables = [t.detach() for t in self._hot_tables()]
        owned = list(enumerate(sorted(man.owned)))  # (block, shard)
        with torch.no_grad():
            for k, s in owned:
                n = plan.shard_plans[s].n_evict
                if n:
                    lo = k * plan.cap_evict
                    slots = shipment.evict_slots[lo:lo + n] + k * man.hs
                    man.push_writeback(s, plan.plan_id,
                                       *self._evicted_rows(tables, slots))
            for k, s in owned:
                n = plan.shard_plans[s].n_load
                if n:
                    lo = k * plan.cap_load
                    slots = (shipment.load_slots[lo:lo + n]
                             + k * man.hs).long()
                    for t, r in zip(tables, shipment.load_rows):
                        t.index_copy_(0, slots, r[lo:lo + n])
            man.note_applied(plan)
        return shipment.batch

    def _input_plan(self):
        """``(pipeline config, shard)``: each data block parses its
        strided share of the input at the local batch size."""
        if not self.sharded:
            return self.cfg, (0, 1)
        block, blocks = data_partition(self.mesh)
        return dataclasses.replace(
            self.cfg, batch_size=self.cfg.batch_size // blocks
        ), (block, blocks)

    def global_metrics(self, ms: "MetricState") -> dict:
        """``ms`` summed over the mesh's data axis and finalised: the
        same numbers on every rank (a collective on a mesh)."""
        return ms.psum_data(self.mesh).finalize(self.cfg.loss_type)

    def _put(self, batch: Batch) -> Batch:
        """The plain route to the device: a host batch, range-checked and
        copied leaf by leaf (``train_step``, ``evaluate``)."""
        vocab = self.cfg.vocabulary_size
        if batch.ids.size and (batch.ids.min() < 0
                               or batch.ids.max() >= vocab):
            # The parser reduces ids modulo the vocabulary; an id outside
            # it would be a device-side assert on the GPU.
            raise ValueError(f"feature ids must lie in [0, {vocab})")
        return to_device(batch, self.device)

    def device_step(self, dev_batch: Batch,
                    rows_all: Optional[torch.Tensor] = None,
                    health: bool = False,
                    scores_out: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """One step on a device :class:`Batch` (this rank's data block on
        a mesh, and with the overlap its gathered id plane ``rows_all``);
        returns the batch's mean weighted data loss as a device scalar.
        With ``health`` the step's gradient-health pair is folded into
        :attr:`health` (what ``train()``'s dispatches run); ``scores_out``
        (a ``[B]`` row of the quality plane's buffer) gets the step's
        scores."""
        if self.sharded and self.sparse:
            out = sparse_step_shardmap(self.dcfg, self.model,
                                       self.opt_state, dev_batch,
                                       self.mesh, rows_all, health=health)
        elif self.sharded:
            out = dense_step_sharded(self.cfg, self.model, self.opt_state,
                                     dev_batch, self.mesh, health=health)
        else:
            step = sparse_step if self.sparse else dense_step
            out = step(self.cfg, self.model, self.opt_state, dev_batch,
                       health=health, impl=self.interaction)
        scores = out
        if health:
            scores, pair = out
            with torch.no_grad():
                self.health.update_(*pair, dev_batch)
        if scores_out is not None:
            with torch.no_grad():
                scores_out.copy_(scores.detach())
        lsum, wsum = self.metrics.add_(scores, dev_batch, self.cfg.loss_type)
        return lsum / torch.clamp(wsum, min=1e-12)

    def _run_steps(self, sb: SuperBatch) -> torch.Tensor:
        """The ``sb.n`` steps of a super-batch on its views (the whole
        ``seg_start`` slot, so no shape depends on a batch's unique
        count), what the graph captures; returns their losses ``[n]``.
        With the overlap, step ``i + 1``'s id plane is gathered while step
        ``i`` runs (the reference's ``make_scan_train_step`` prefetch; the
        first step's is gathered before it).  Each step advances the
        health carry, and with the quality plane writes its scores into
        row ``i`` of :meth:`_score_rows`."""
        rows = self._score_rows(sb)

        def out(i):
            return None if rows is None else rows[i]

        if not self.overlap:
            return torch.stack([self.device_step(sb.step(i), health=True,
                                                 scores_out=out(i))
                                for i in range(sb.n)])
        pending = entries_prefetch(self.dcfg, sb.step(0).ids, self.mesh)
        losses = []
        for i in range(sb.n):
            rows_all = pending.wait()
            if i + 1 < sb.n:
                pending = entries_prefetch(self.dcfg, sb.step(i + 1).ids,
                                           self.mesh)
            losses.append(self.device_step(sb.step(i), rows_all,
                                           health=True, scores_out=out(i)))
        return torch.stack(losses)

    def _score_rows(self, sb: SuperBatch) -> Optional[torch.Tensor]:
        """The quality plane's ``[K, B]`` device scores buffer (None with
        the plane off), made at the first dispatch and kept, so a
        captured graph and its replays write the same rows."""
        if self._quality is None:
            return None
        b = sb.batch.labels.shape[1]
        k = max(1, self.cfg.steps_per_dispatch, sb.n)
        buf = self._scores_dev
        if buf is None or buf.shape[1] != b or buf.shape[0] < k:
            buf = self._scores_dev = torch.zeros(
                (k, b), dtype=torch.float32, device=self.device)
            pin = self.device.type == "cuda"
            self._score_slots = [torch.zeros((k, b), pin_memory=pin)
                                 for _ in range(2)]
        return buf

    def _scores_readback(self, item, slot: int) -> Optional[tuple]:
        """Start the non-blocking copy of the dispatch's scores into host
        slot ``slot``, with an event after it on the card; returns the
        pending feed (with the batch's host labels and weights) that
        :meth:`_feed_quality` consumes one dispatch later."""
        sb = item.batch if isinstance(
            item, (tiered_lib.Shipment, tiered_fleet.FleetShipment)) else item
        if self._scores_dev is None or sb.host is None:
            return None
        host = self._score_slots[slot][:sb.n]
        with torch.no_grad():
            host.copy_(self._scores_dev[:sb.n], non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return host, event, sb.host[0], sb.host[1]

    def _feed_quality(self, pending) -> None:
        """Feed one delayed scores readback to the quality monitor."""
        if pending is None or self._quality is None:
            return
        host, event, labels, weights = pending
        if event is not None:
            event.synchronize()
        self._quality.observe(host.numpy(), labels, weights)

    def dispatch(self, sb, pause=None) -> torch.Tensor:
        """Train one shipped super-batch: one replay of the CUDA graph of
        its K steps when it is full and the graph is captured, else the
        same steps eagerly (the first full one is then captured, inside
        ``pause``: the transfer stage's ``paused()``).  Under tiering
        ``sb`` is a :class:`tiered_lib.Shipment`, whose migration is
        applied first (always eager; timed as ``train.migrate``).  Each
        step advances the health carry (:attr:`health`).  Returns the
        steps' losses ``[n]`` (a device tensor; a replay's is the graph's
        own, overwritten by the next one).  The loop's hook per
        dispatch."""
        if isinstance(sb, (tiered_lib.Shipment, tiered_fleet.FleetShipment)):
            with self.telemetry.timer("train.migrate").time(), \
                    self.tracer.span("train.migrate",
                                     args={"sb": self._sb_id}):
                sb = (self._apply_migration(sb)
                      if isinstance(sb, tiered_lib.Shipment)
                      else self._apply_migration_fleet(sb))
        graph = self.graph
        if graph is not None and graph.captured and sb.n == graph.k:
            self.graph_dispatches += 1
            return graph.replay(sb)
        losses = self._run_steps(sb)
        self.eager_dispatches += 1
        if graph is not None and not graph.captured and sb.n == graph.k:
            t0 = time.perf_counter()
            with self.tracer.span("train.compile", args={"k": graph.k}):
                graph.capture(sb, self._run_steps, pause)
            if self._sentinel is not None:
                # A capture at the configured K is the one a graphed run
                # expects; the step stamped is the run's so far.
                self._sentinel.record(
                    time.perf_counter() - t0, graph.k,
                    graph.k == max(1, self.cfg.steps_per_dispatch),
                    step=self._run.steps)
        return losses

    def train_step(self, batch: Batch) -> torch.Tensor:
        """One step on a host :class:`Batch`, copied to the device by the
        plain route (:meth:`device_step` on it).  A tiered trainer's
        batches take the transfer stage's plan: it trains through
        :meth:`train`."""
        if self.tiered is not None:
            raise ValueError(
                "train_step takes logical ids onto a dense table; with "
                "table_tiering=on the batches are planned and migrated by "
                "train()"
            )
        return self.device_step(self._put(batch))

    def _data_fingerprint(self) -> dict:
        """What defines the training stream; a saved position holds only
        for the same (``fast_tffm_tpu/train/loop.py::
        Trainer._data_fingerprint``).  The cache replays batches where
        streaming reshuffles lines, and the prestacked cache permutes
        whole groups of ``steps_per_dispatch``: each redefines every
        epoch after the first.  ``cache_prestacked`` is stamped only when
        on, as the reference does."""
        cfg = self.cfg
        fp = {
            "seed": cfg.seed, "batch_size": cfg.batch_size,
            "train_files": list(cfg.train_files),
            "shuffle_buffer": cfg.shuffle_buffer,
            "fast_ingest": cfg.fast_ingest, "cache_epochs": cfg.cache_epochs,
        }
        if cfg.cache_prestacked:
            fp["cache_prestacked"] = True
            fp["steps_per_dispatch"] = cfg.steps_per_dispatch
        return fp

    def _resume_position(self) -> tuple:
        """``(epoch, batches to skip)`` from the checkpoint's
        ``data_state.json``, by the reference's rules
        (``fast_tffm_tpu/train/loop.py``, ``Trainer.train``)."""
        cfg = self.cfg
        # Only a checkpoint of a trained step carries a position: a stale
        # data_state.json beside parameters saved at step 0 (imported
        # weights) must not make their first run skip data.
        ds = (checkpoint.restore_data_state(cfg.model_file)
              if self._restored_step else None)
        if ds is None:
            return 0, 0
        fp = ds.get("fingerprint")
        if fp is not None and fp != self._data_fingerprint():
            log.warning(
                "checkpoint data position was saved under a different "
                "input config (seed/batch_size/files changed); ignoring it "
                "and reading the epoch from the start"
            )
            return 0, 0
        if not 0 <= ds.get("epoch", -1) < cfg.epoch_num:
            return 0, 0  # a completed run: epoch_num fresh epochs
        epoch, skip = int(ds["epoch"]), int(ds.get("batches_done", 0))
        if epoch or skip:
            log.info("resuming data stream at epoch %d, skipping %d batches",
                     epoch, skip)
        return epoch, skip

    # -- the health carry --------------------------------------------------

    def _reset_health(self) -> None:
        """A fresh per-run carry (in place: a captured graph holds it)
        and host cache.  Reporting is per run: the device step counter
        restarts at 0, so ``first_nonfinite_step`` is the run's step."""
        with torch.no_grad():
            self.health.reset_()
        self._health_host = {}

    def _health_readback(self, stepno: int, slot: int) -> tuple:
        """Start the asynchronous copy of the carry's three scalars
        (non-finite steps, last and summed squared norms) into host slot
        ``slot``, with an event after it on the card; returns the pending
        readback :meth:`_check_health` consumes."""
        h = self.health
        host = self._health_slots[slot]
        with torch.no_grad():
            host.copy_(torch.stack([h.nonfinite_steps.float(),
                                    h.grad_sq_last, h.grad_sq_sum]),
                       non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return host, event, stepno

    def _check_health(self, pending, warned: list) -> None:
        """Consume one delayed readback (the reference's ``check_health``):
        refresh the host-cached grad norm, its RMS and the non-finite
        count, and apply ``nan_policy``: ``warn`` logs once and trains
        on, ``halt`` raises :class:`NonFiniteGradError`."""
        host, event, at_step = pending
        if event is not None:
            event.synchronize()
        nf, gs, ss = host.tolist()
        nf = int(nf)
        self._health_host["grad_norm"] = round(
            float(np.sqrt(gs)) if np.isfinite(gs) else gs, 6)
        rms = ss / max(1, at_step)
        self._health_host["grad_norm_rms"] = round(
            float(np.sqrt(rms)) if np.isfinite(rms) else rms, 6)
        self._health_host["nonfinite_steps"] = nf
        if nf <= 0:
            return
        if not warned:
            warned.append(True)
            log.warning(
                "non-finite (NaN/inf) gradient detected by step %d (%d bad "
                "step(s) so far; nan_policy=%s)", at_step, nf,
                self.cfg.nan_policy)
        if self.cfg.nan_policy == "halt":
            raise NonFiniteGradError(
                f"non-finite gradient within the first {at_step} step(s) "
                f"({nf} bad step(s)); halting per nan_policy=halt — the "
                "checkpoint was NOT overwritten with poisoned params")

    def _health_summary(self, exact: bool = False,
                        collective: bool = True) -> dict:
        """Host-side view of the carry for records and results.
        ``exact=False`` (the heartbeat and HTTP threads) serves the cached
        scalars the loop read back, never the device; ``exact=True`` (the
        loop's thread: log cadence and the final record) reads the carry
        and counts the touched rows.  On a mesh the rows and touches of
        the data blocks are summed over ``data`` (a collective every rank
        makes at the same step), unless ``collective`` is off (a crash's
        final record, where the other ranks may not come)."""
        out = dict(self._health_host)
        if not exact:
            return out
        try:
            h = self.health
            steps = max(1, self._run.steps)
            seen, touches = h.rows_touched, h.touch_events.reshape(1)
            if self.sharded and self.mesh.data > 1 and collective:
                seen = psum(seen.to(torch.uint8), DATA_AXIS, self.mesh)
                touches = psum(touches.clone(), DATA_AXIS, self.mesh)
            rows = int(torch.count_nonzero(seen))
            vocab = self.dcfg.vocabulary_size
            out.update({
                "grad_norm": round(float(torch.sqrt(h.grad_sq_last)), 6),
                "grad_norm_rms": round(
                    float(torch.sqrt(h.grad_sq_sum / steps)), 6),
                "nonfinite_steps": int(h.nonfinite_steps),
                "first_nonfinite_step": int(h.first_nonfinite_step),
                "emb_rows_touched": rows,
                "emb_row_occupancy": round(rows / vocab, 6),
                "emb_touch_events": float(touches[0]),
            })
            if self.tiered is not None:
                # The carry counts hot slots under tiering; the manager
                # sees every logical id and gives the logical occupancy.
                out.update(self.tiered.health_view())
            self._health_host = dict(out)
        except Exception:  # a failed device: serve what was cached
            pass
        return out

    # -- the run's self-reports --------------------------------------------

    def _run_header(self, rank: int, resume: tuple) -> dict:
        """The metrics stream's first record: the run's identity (the
        reference's ``run_header``, with the PyTorch version and the
        device in place of JAX's)."""
        cfg = self.cfg
        world, _ = _rank_grid()
        return {
            "record": "run_header",
            "time": self._run.t0,
            "rank": rank,
            "config_fingerprint": config_fingerprint(cfg),
            "steps_per_dispatch": max(1, cfg.steps_per_dispatch),
            "ingest_mode": "procs" if cfg.parse_processes > 0 else "threads",
            "fast_ingest": cfg.fast_ingest,
            "cache_epochs": cfg.cache_epochs,
            "cache_prestacked": cfg.cache_prestacked,
            "ring_slots": cfg.ring_slots,
            "table_tiering": cfg.table_tiering,
            "hot_rows": cfg.hot_rows if cfg.table_tiering == "on" else 0,
            "tiered_partition": cfg.tiered_partition,
            "tiered_shards": (self.fleet.num_shards
                              if self.fleet is not None else 0),
            "sparse_exchange_overlap": cfg.sparse_exchange_overlap,
            "exchange_overlap_active": self.overlap,
            "cold_dtype": cfg.cold_dtype,
            "batch_size": cfg.batch_size,
            "epoch_num": cfg.epoch_num,
            "optimizer": cfg.optimizer,
            "telemetry": cfg.telemetry,
            "heartbeat_secs": cfg.heartbeat_secs,
            "trace_file": cfg.trace_file,
            "trace_rotate_events": cfg.trace_rotate_events,
            "nan_policy": cfg.nan_policy,
            "status_port": cfg.status_port,
            "alert_rules": cfg.alert_rules,
            "resource_metrics": cfg.resource_metrics,
            "quality": cfg.quality,
            "quality_window": cfg.quality_window,
            "torch_version": torch.__version__,
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            "backend": self.device.type,
            "mesh": {"data": self.mesh.data, "model": self.mesh.model},
            "n_processes": world,
            "resume_step": self._restored_step,
            "resume_epoch": resume[0],
            "resume_skip": resume[1],
            "interaction_impl": cfg.interaction_impl,
            "kernel_impl": self.kernel_impl,
            "compile_cache_dir": cfg.compile_cache_dir,
        }

    def _record(self, kind: str, rank: int, pipeline, alerts=None,
                collective: bool = True, fleet=None) -> Optional[dict]:
        """One self-report (``heartbeat``, ``status`` or ``final``; the
        reference's ``telemetry_record``), built from host-side values
        only, except the final record's exact health.  A heartbeat
        before the first dispatch is skipped (its wait would be start-up,
        not starvation); ``/status`` then answers ``warming_up`` without
        the wall-clock split."""
        run = self._run
        if kind == "heartbeat" and run.steps == 0:
            return None
        now = time.time()
        wall = max(now - run.t0, 1e-9)
        wait_s, disp_s = run.wait_s, run.dispatch_s
        rec = {
            "record": kind,
            "time": now,
            "rank": rank,
            "step": run.steps,
            "epoch": self._epoch,
            "elapsed": round(wall, 3),
            "examples_in": self.telemetry.counter("ingest.examples").value,
            "wait_input_s": round(wait_s, 3),
            "dispatch_s": round(disp_s, 3),
            "other_s": round(max(0.0, wall - wait_s - disp_s), 3),
            "ingest_wait_frac": round(wait_s / wall, 4),
            **pipeline.stats(),
            "health": self._health_summary(exact=(kind == "final"),
                                           collective=collective),
            "stages": self.telemetry.snapshot(),
        }
        if self._sentinel is not None:
            # The process block, the trace buffer, the sentinel's
            # captures and the process's kernel and parser builds.
            rec["resource"] = {
                **basic_block(run.t0),
                "trace_buffer_bytes": int(self.tracer.buffer_bytes),
                **self._sentinel.snapshot(), **build_block()}
        if kind == "status":
            rec["build_info"] = self._build_info(rank)
            if run.steps == 0:
                for key in ("wait_input_s", "dispatch_s", "other_s",
                            "ingest_wait_frac"):
                    del rec[key]
                rec["warming_up"] = True
        if self.tiered is not None:
            rec["tiered"] = self.tiered.snapshot()
        if self._quality is not None:
            # Memoized in the monitor; the final record's is exact.
            rec["quality"] = self._quality.block(force=(kind == "final"))
        if self.tracer.enabled:
            rec["trace_dropped_events"] = self.tracer.dropped_events
            if self.cfg.trace_rotate_events:
                rec["trace_windows"] = self.tracer.windows_written
        if fleet is not None:
            rec["fleet"] = fleet.block(now)
        if alerts is not None:
            rec["alerts"] = alerts.active_snapshot()
        return rec

    def _build_info(self, rank: int) -> dict:
        """The run's identity labels (``tffm_build_info``, the blackbox's
        ``run_header.json``)."""
        return {
            "torch_version": torch.__version__,
            "backend": self.device.type,
            "mesh": f"data{self.mesh.data}xmodel{self.mesh.model}",
            "steps_per_dispatch": str(max(1, self.cfg.steps_per_dispatch)),
            "rank": str(rank),
            "config_fingerprint": config_fingerprint(self.cfg),
        }

    def _ondemand_profile(self, secs: float) -> str:
        """The ``/profile`` route: one profiler window of ``secs`` into
        the run's capture directory; a clash with an open window (the
        ``profile_dir`` one) raises, which the route answers 500."""
        window = ProfileWindow(self.device.type == "cuda")
        window.start()
        path = os.path.join(self._profile_capture_dir,
                            f"trace_{time.time_ns()}.json")
        try:
            time.sleep(secs)
        finally:
            window.stop(path)
        log.info("on-demand profiler capture (%.1fs) written to %s", secs,
                 path)
        writer = self._metrics_writer
        if writer is not None:
            writer.write({"record": "profile", "time": time.time(),
                          "secs": float(secs),
                          "profile_dir": self._profile_capture_dir})
        return self._profile_capture_dir

    def train(self) -> dict:
        """Train ``epoch_num`` epochs of ``train_files``, then save and
        validate.  The run's observability follows the reference's
        ``Trainer.train``: the health carry read back one dispatch late
        (``nan_policy``; the pending readback is consumed before a
        periodic save and at the stream's end, so poisoned parameters
        are never saved), a ``metrics_file`` stream per rank (a
        ``run_header``, ``train`` and ``validation`` records at their
        cadences, ``heartbeat`` records every ``heartbeat_secs``, alerts,
        and one ``final`` record written whatever ends the run), the
        ``status_port`` endpoint, and an :class:`AlertEngine` on the
        heartbeat whose ``halt`` stops the run at the next dispatch
        boundary with no checkpoint written."""
        cfg = self.cfg
        if not cfg.train_files:
            raise ValueError("no train_files configured")
        self._epoch, self._batches_done = self._resume_position()
        resume = (self._epoch, self._batches_done)
        if self.tiered is not None:
            self.tiered.reopen()  # re-arm after a cancelled earlier run
        world, rank = _rank_grid()
        metrics_out = (JsonlWriter(rank_suffix_path(cfg.metrics_file, rank))
                       if cfg.metrics_file else None)
        self._run = run = _RunClock()
        t0 = run.t0
        if metrics_out is not None:
            metrics_out.write(self._run_header(rank, resume))
            if self._autotune is not None:
                autotune_lib.write_record(metrics_out, self._autotune)
        last_log_t = t0
        last_log_ex = self.global_metrics(self.metrics)["examples"]
        stepno = last_log_step = last_val_step = last_save_step = 0
        dispatches = 0
        self.graph_dispatches = self.eager_dispatches = 0
        if self.eager_reason:
            log.info("every dispatch runs eagerly: %s", self.eager_reason)
        first_s = 0.0
        # Per-run accounting, reset in place: a second train() must not
        # report the first run's totals against its own wall clock.
        self.telemetry.reset()
        self.tracer.reset()
        self._reset_health()
        if self._sentinel is not None:
            self._sentinel.reset()
            self._sentinel.set_writer(metrics_out)
        # /profile captures land beside the metrics stream (or in the
        # model directory: never the working directory), and each is a
        # `record: profile` entry.
        self._profile_capture_dir = os.path.join(
            os.path.dirname(cfg.metrics_file) or cfg.model_file,
            "tffm_profile_ondemand")
        self._metrics_writer = metrics_out
        # The quality plane, per run: the drift sketches the parse side
        # feeds and the windowed eval the loop feeds one dispatch late.
        self._quality_sketch = (StreamSketch(cfg.quality_window)
                                if cfg.quality else None)
        self._quality = (QualityMonitor(
            loss_type=cfg.loss_type, window=cfg.quality_window,
            sketch=self._quality_sketch) if cfg.quality else None)
        t_wait = self.telemetry.timer("train.wait_input")
        t_disp = self.telemetry.timer("train.dispatch")
        pipe_cfg, shard = self._input_plan()
        k = max(1, cfg.steps_per_dispatch)
        # One packer for the transfer stage and the prestacked cache,
        # which packs epoch 0's groups of K once.
        packer = Packer(self.device, cfg.vocabulary_size,
                        with_fields=cfg.field_num > 0)
        # The sharded step sorts its local ids on the device, and so does
        # the tiered one: the host meta would key on ids before the remap.
        pipeline = BatchPipeline(
            cfg.train_files, pipe_cfg, epochs=cfg.epoch_num, shuffle=True,
            host_meta=(cfg.host_sort and not self.sharded
                       and self.tiered is None),
            weight_files=cfg.weight_files, shard=shard,
            start_epoch=self._epoch, skip_batches=self._batches_done,
            epoch_marks=True, cache_epochs=cfg.cache_epochs,
            cache_max_bytes=cfg.cache_max_bytes,
            prestack=(k, packer.pack) if cfg.cache_prestacked else None,
            telemetry=self.telemetry, tracer=self.tracer,
            quality=self._quality_sketch,
        )
        prefetcher = DevicePrefetcher(
            pipeline, k, self.device, cfg.vocabulary_size,
            depth=cfg.prefetch_super_batches, packer=packer,
            plan_hook=self._plan_group if self.tiered is not None else None,
            telemetry=self.telemetry, tracer=self.tracer,
            host_targets=self._quality is not None,
        )
        cache_logged = not cfg.cache_epochs
        # The training fleet: rank 0 scrapes every rank's /status on the
        # heartbeat cadence into the merged `fleet` block.
        fleet = None
        if cfg.train_fleet_scrape and rank == 0:
            fleet = TrainFleet(cfg.train_fleet_scrape.split(","),
                               interval_s=cfg.heartbeat_secs,
                               telemetry=self.telemetry)

        def record(kind, collective=True):
            return self._record(kind, rank, pipeline, alerts,
                                collective=collective, fleet=fleet)

        # The flight recorder: rings of the recent records and alerts; a
        # bundle on a crash, an alert or POST /incident.
        blackbox = None
        if cfg.blackbox:
            blackbox = Blackbox(
                cfg.incident_dir or os.path.join(cfg.model_file,
                                                 "incidents"),
                suffix=f"rank{rank}", run_header=self._build_info(rank),
                metrics_render=lambda: render_prometheus(record("status")),
                trace_tail_fn=(self.tracer.tail if self.tracer.enabled
                               else None),
                writer=metrics_out, telemetry=self.telemetry)
        # Alert watchdog: rules evaluated on the heartbeat thread; a halt
        # arms engine.halted, which the loop raises at the next boundary.
        alerts = (AlertEngine(
            parse_rules(cfg.alert_rules), writer=metrics_out,
            on_alert=blackbox.on_alert if blackbox is not None else None)
            if cfg.alert_rules else None)

        def heartbeat_build():
            rec = record("heartbeat")
            if rec is not None:
                # Ringed before the rules see it: an alert's bundle holds
                # the record that tripped it.
                if blackbox is not None:
                    blackbox.observe_record(rec)
                if alerts is not None:
                    alerts.observe(rec)
            return rec

        heartbeat = (Heartbeat(cfg.heartbeat_secs, heartbeat_build,
                               writer=metrics_out)
                     if cfg.heartbeat_secs > 0 else None)
        status_server = None
        if cfg.status_port:
            try:
                status_server = StatusServer(
                    cfg.status_port, lambda: record("status"),
                    telemetry=self.telemetry, host=cfg.status_host,
                    profile=self._ondemand_profile,
                    incident=(blackbox.incident if blackbox is not None
                              else None),
                    metrics_extra=(fleet.metrics_lines if fleet is not None
                                   else None))
                self.status_port = status_server.port
                log.info("status endpoint listening on %s:%d (/metrics, "
                         "/status, /healthz, /debug/threadz, /profile, "
                         "POST /incident)", cfg.status_host,
                         status_server.port)
            except OSError as e:
                # An observability convenience never kills the run.
                log.warning("status endpoint failed to bind port %d: %s",
                            cfg.status_port, e)
        probe = None
        if cfg.train_fleet_scrape and self.mesh.size > 1:
            probe = _ExchangeProbe(self.mesh, self.device,
                                   self.telemetry.timer("train.exchange"),
                                   self.overlap)
        pending = None  # the previous dispatch's health readback
        pending_q = None  # and its scores, for the quality monitor
        warned: list = []
        run_exc: Optional[BaseException] = None
        final: dict = {}
        profile_started, profile_stop_at = False, 0
        tracer = self.tracer
        try:
            try:
                tracer.name_thread("train-loop")
                source = iter(prefetcher)
                while True:
                    t_w = time.perf_counter()
                    with tracer.span("train.wait_input"):
                        item = next(source, None)
                    t_run = time.perf_counter()
                    t_wait.observe(t_run - t_w)
                    run.wait_s += t_run - t_w
                    if item is None:
                        break
                    if isinstance(item, EpochEnd):
                        self._epoch, self._batches_done = item.epoch + 1, 0
                        if not cache_logged:
                            # Known once epoch 0 has parsed; logged once.
                            cache_logged = True
                            log.info("ingest cache after epoch %d: %s",
                                     item.epoch, pipeline.cache_result)
                        continue
                    if (cfg.profile_dir and not profile_started
                            and stepno >= cfg.profile_start_step):
                        try:
                            self._profile.start()
                            profile_started = True
                            profile_stop_at = stepno + cfg.profile_steps
                        except RuntimeError:
                            pass  # a /profile capture: at a later dispatch
                    self._sb_id = dispatches
                    with tracer.span(
                            "train.dispatch",
                            args={"sb": dispatches, "k": item.n,
                                  "step0": stepno},
                            flow=("f", f"sb{dispatches}")):
                        self.dispatch(item, prefetcher.paused())
                    dt = time.perf_counter() - t_run
                    t_disp.observe(dt)
                    run.dispatch_s += dt
                    if not dispatches:
                        first_s = time.time() - t0
                    stepno += item.n
                    self._batches_done += item.n
                    run.steps = stepno
                    # Health, one dispatch late: start this dispatch's
                    # copy, then consume the previous one's, long done.
                    started = self._health_readback(stepno, dispatches % 2)
                    started_q = (self._scores_readback(item, dispatches % 2)
                                 if self._quality is not None else None)
                    dispatches += 1
                    if probe is not None:
                        probe()
                    if pending is not None:
                        self._check_health(pending, warned)
                    pending = started
                    # The scores, one dispatch late, as the health.
                    self._feed_quality(pending_q)
                    pending_q = started_q
                    if self._profile.open and stepno >= profile_stop_at:
                        path = self._profile.stop(os.path.join(
                            cfg.profile_dir, f"trace_rank{rank}.json"))
                        log.info("profiler trace written to %s", path)
                    if alerts is not None and alerts.halted is not None:
                        raise halt_error(alerts.halted)
                    if (cfg.log_steps
                            and stepno - last_log_step >= cfg.log_steps):
                        last_log_step = stepno
                        m = self.global_metrics(self.metrics)
                        now = time.time()
                        rate = (m["examples"] - last_log_ex) / max(
                            now - last_log_t, 1e-9
                        )
                        last_log_t, last_log_ex = now, m["examples"]
                        # The log's read synced the device already: the
                        # exact health refresh rides it.
                        self._health_summary(exact=True)
                        log.info(
                            "step %d examples %d loss %.6f auc %.4f ex/s "
                            "%.0f", stepno, int(m["examples"]), m["loss"],
                            m["auc"], rate,
                        )
                        if metrics_out is not None:
                            metrics_out.write({
                                "record": "train", "step": stepno,
                                "examples": m["examples"],
                                "loss": m["loss"], "auc": m["auc"],
                                "examples_per_sec": rate,
                                "elapsed": now - t0,
                            })
                    if (cfg.validation_steps and cfg.validation_files
                            and stepno - last_val_step
                            >= cfg.validation_steps):
                        last_val_step = stepno
                        vm = self.evaluate(cfg.validation_files)
                        log.info("step %d validation loss %.6f auc %.4f",
                                 stepno, vm["loss"], vm["auc"])
                        if metrics_out is not None:
                            metrics_out.write({
                                "record": "validation", "step": stepno,
                                "examples": vm["examples"],
                                "loss": vm["loss"], "auc": vm["auc"],
                                "validation_loss": vm["loss"],
                                "validation_auc": vm["auc"],
                                "elapsed": time.time() - t0,
                            })
                    if (cfg.save_steps
                            and stepno - last_save_step >= cfg.save_steps):
                        # This dispatch's health first: a poisoned
                        # dispatch must not be saved.
                        self._check_health(pending, warned)
                        pending = None
                        last_save_step = stepno
                        self.save(stepno)
                # The last dispatch's health, before the end-of-run save,
                # and its scores, so the final record covers every step.
                if pending is not None:
                    self._check_health(pending, warned)
                    pending = None
                self._feed_quality(pending_q)
                pending_q = None
                if probe is not None:
                    probe.close()
            finally:
                if heartbeat is not None:
                    heartbeat.close()
                if status_server is not None:
                    status_server.close()
                if fleet is not None:
                    fleet.close()  # its last merged view stays readable
                if self.tiered is not None:
                    # Wake a transfer thread blocked on a write-back fill
                    # that will never come, or close() would join it
                    # forever.
                    self.tiered.cancel_waits()
                prefetcher.close()
        except BaseException as e:
            run_exc = e
            raise
        finally:
            if self._profile.open:  # a run that ended inside the window
                self._profile.stop(os.path.join(
                    cfg.profile_dir, f"trace_rank{rank}.json"))
            # Whatever ends the run, the stream closes with one final
            # record naming the exception (exact health, but no
            # collective after a crash: the other ranks may not come).
            final = record("final", collective=run_exc is None)
            if run_exc is not None:
                final["exception"] = type(run_exc).__name__
                final["exception_msg"] = str(run_exc)[:300]
            if blackbox is not None:
                blackbox.observe_record(final)
                if run_exc is not None and not isinstance(
                        run_exc, KeyboardInterrupt):
                    # Dumped before the writer closes, so the incident's
                    # manifest reaches the metrics stream too.
                    blackbox.incident("crash_" + type(run_exc).__name__)
            if metrics_out is not None:
                try:
                    metrics_out.write(final)
                except Exception as e:  # a full volume must not mask
                    log.warning("final record write failed: %s", e)
                metrics_out.close()
            self._metrics_writer = None
            if self.tracer.enabled:
                try:
                    n_ev = self.tracer.dump(self._trace_path)
                    log.info("wrote %d trace events to %s (%d window(s))",
                             n_ev, self._trace_path,
                             self.tracer.windows_written)
                except OSError as e:
                    log.warning("trace dump failed: %s", e)
                self.tracer.close()
        truncated = pipeline.truncated_features
        self._epoch, self._batches_done = cfg.epoch_num, 0
        wall = max(time.time() - t0, 1e-9)
        train_metrics = self.global_metrics(self.metrics)
        train_metrics["examples_per_sec"] = train_metrics["examples"] / wall
        train_metrics["steps"] = stepno
        train_metrics["dispatches"] = dispatches
        train_metrics["graph_dispatches"] = self.graph_dispatches
        train_metrics["eager_dispatches"] = self.eager_dispatches
        train_metrics["first_dispatch_s"] = first_s
        train_metrics["wall_s"] = wall
        train_metrics["ingest_cache"] = pipeline.cache_result
        train_metrics["truncated_features"] = int(truncated)
        train_metrics["out_of_range_batches"] = 0
        train_metrics["ingest_wait_frac"] = final["ingest_wait_frac"]
        train_metrics["wait_input_s"] = final["wait_input_s"]
        train_metrics["dispatch_s"] = final["dispatch_s"]
        train_metrics["health"] = dict(final["health"])
        for key in ("resource", "quality", "fleet"):
            if key in final:
                train_metrics[key] = dict(final[key])
        if self.tiered is not None:
            train_metrics["tiered"] = self.tiered.snapshot()
        self.save(stepno)
        result = {"train": train_metrics}
        if cfg.validation_files:
            result["validation"] = self.evaluate(cfg.validation_files)
            log.info("validation loss %.6f auc %.4f",
                     result["validation"]["loss"],
                     result["validation"]["auc"])
        return result

    def evaluate(self, files) -> dict:
        """Streaming metrics of the current model over ``files`` (on a
        mesh, over each data block's strided share, globally summed).  A
        tiered trainer scores the MERGED logical table, cold rows
        included: moved to the device once when it fits the dense format,
        else each batch against a compact table of its unique rows
        (``fast_tffm_tpu/train/loop.py::_evaluate_tiered_virtual``)."""
        ms = MetricState.zeros(self.device)
        pipe_cfg, shard = self._input_plan()
        model, compact = self.model, False
        if self.tiered is not None:
            if self.fleet is not None and (
                    len(self.tiered.owned) != self.tiered.num_shards):
                raise RuntimeError(
                    "evaluate with fleet-sharded tiering needs every "
                    "shard's cold store; this rank owns "
                    f"{sorted(self.tiered.owned)} of "
                    f"{self.tiered.num_shards}.  Evaluate from the "
                    "saved checkpoint instead (it merges all shards)."
                )
            if self.tiered.dense_save_ok:
                merged = self.tiered.merged_dense(self._tier_host_tables())
                model = fm.FmModel(self.model.w0.detach(),
                                   torch.from_numpy(merged[0]).to(
                                       self.device))
                del merged
            else:
                self.tiered.sync_from_device(self._tier_host_tables())
                compact = True
        with BatchPipeline(files, pipe_cfg, epochs=1, shuffle=False,
                           shard=shard) as p:
            for batch in p:
                if compact:
                    model, batch = self._compact_batch(batch)
                dev_batch = self._put(batch)
                with torch.no_grad():
                    if self.sharded:
                        scores = local_scores(self.cfg, model, dev_batch,
                                              self.mesh)
                    else:
                        scores = fm.fm_scores(
                            model, dev_batch.ids, dev_batch.vals,
                            dev_batch.fields, factor_num=self.cfg.factor_num,
                            field_num=self.cfg.field_num,
                            impl=self.interaction)
                ms.add_(scores, dev_batch, self.cfg.loss_type)
        return self.global_metrics(ms)

    def _compact_batch(self, batch: Batch) -> tuple:
        """``(model, batch)``: ``batch``'s unique logical rows gathered
        from the (synced) cold store into a ``_bucket``-padded table on
        the device, and the batch with its ids remapped to their indices
        in it.  The same rows as a full-table gather, with no ``[V, D]``
        table anywhere."""
        vocab = self.cfg.vocabulary_size
        flat = batch.ids.reshape(-1)
        safe = np.where((flat >= 0) & (flat < vocab), flat, 0)
        u, inv = np.unique(safe, return_inverse=True)
        mini = np.zeros((tiered_lib._bucket(len(u)), self.cfg.embedding_dim),
                        np.float32)
        mini[:len(u)] = self.tiered.gather_logical(u)
        model = fm.FmModel(self.model.w0.detach(),
                           torch.from_numpy(mini).to(self.device))
        return model, batch._replace(
            ids=inv.astype(np.int32).reshape(batch.ids.shape))

    def save(self, stepno: int) -> str:
        """Write ``params.npz`` and ``data_state.json`` (on a mesh every
        rank calls this; rank 0 writes).  A tiered trainer writes its
        LOGICAL table: merged into ``params.npz`` (with its optimizer
        tables) when it fits the dense format, which any dense or tiered
        run resumes at any ``hot_rows``, else the sparse overlay
        ``tiered.npz``; a fleet of several ranks writes one
        ``tiered.shard{s}of{S}.npz`` for each shard a rank owns
        (:func:`checkpoint.save_tiered_shards`).  Returns the path of the
        params file, the overlay or the model directory."""
        data_state = {"epoch": self._epoch,
                      "batches_done": self._batches_done,
                      "fingerprint": self._data_fingerprint()}
        step = self._restored_step + stepno
        extra = self._manifest_quality()
        if self.tiered is None:
            return checkpoint.save_sharded(
                self.cfg.model_file, self.model, self.mesh, step=step,
                opt_state_l=self.opt_state, data_state=data_state,
                manifest_extra=extra,
            )
        cfg, man = self.cfg, self.tiered
        host_tables = self._tier_host_tables()
        w0 = self.model.w0.detach().cpu()
        if man.dense_save_ok:
            merged = [torch.from_numpy(m)
                      for m in man.merged_dense(host_tables)]
            opt = tiered_lib.set_opt_tables(cfg.optimizer, self.opt_state,
                                            tuple(merged[1:]))
            return checkpoint.save_params(
                cfg.model_file, fm.FmModel(w0, merged[0]), step=step,
                opt_state=opt, data_state=data_state, manifest_extra=extra)
        scalars = {"w0": w0.numpy(),
                   **tiered_lib.get_opt_scalars(cfg.optimizer,
                                                self.opt_state)}
        if self.fleet is not None:
            return checkpoint.save_tiered_shards(
                cfg.model_file, step, scalars,
                man.export_shard_overlays(host_tables),
                num_shards=man.num_shards, data_state=data_state,
                primary=self.mesh.rank == 0,
                barrier=lambda: barrier(self.mesh), manifest_extra=extra)
        return checkpoint.save_tiered(
            cfg.model_file, step, scalars, man.export_overlay(host_tables),
            data_state=data_state, manifest_extra=extra)

    def _manifest_quality(self) -> Optional[dict]:
        """The training-to-serving skew reference: the run's cumulative
        feature and score sketches for ``serve_manifest.json`` (the
        reference's ``_manifest_quality``).  None (no key at all) with
        quality off or before the first sketched batch."""
        sk = self._quality_sketch
        if sk is None:
            return None
        payload = sk.export()
        if payload is None:
            return None
        return {"quality": {"examples": sk.examples, "sketches": payload}}


def predict(cfg: FmConfig,
            device: Optional[Union[str, torch.device]] = None,
            devices=None) -> int:
    """Score ``predict_files`` into ``score_path``, one score per line in
    input order: sigmoid probabilities for logistic loss, raw scores for
    mse.  Scores through ``serve.scorer.make_scorer``, so every format
    the server takes is predicted the same way: ``params.npz`` or the
    reference's Orbax directories (at any ``serve_table_dtype``),
    ``quant.npz`` and ``tiered.npz``, on the same ``mesh_data x
    mesh_model`` grid of ``device`` / ``devices`` (None: every visible
    GPU), with ``batch_size`` a rung rounded as the ladder's.  Returns
    the number of scores written."""
    if not cfg.predict_files:
        raise ValueError("no predict_files configured")
    from fast_tffm_tpu_torch.serve import scorer as serve_scorer

    scorer = serve_scorer.make_scorer(cfg, device=device, devices=devices,
                                      extra_rungs=(cfg.batch_size,))
    n = 0
    with BatchPipeline(cfg.predict_files, cfg, epochs=1,
                       shuffle=False) as pipeline, \
            open(cfg.score_path, "w") as out:
        for batch in pipeline:
            scores = scorer.score(batch.ids, batch.vals, batch.fields)
            for s in scores[batch.weights > 0]:
                out.write(f"{s:.6f}\n")
                n += 1
    log.info("wrote %d scores to %s (checkpoint step %d)", n,
             cfg.score_path, scorer.step)
    return n
