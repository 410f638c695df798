"""Training loop and offline predict — the counterpart of
``fast_tffm_tpu/train/loop.py``: the sparse path on one device or on a
rank mesh, and the dense path on one device.

:class:`Trainer` initialises the model (or warm-starts it, optimizer
state included, from ``<model_file>/params.npz``).  :meth:`Trainer.train`
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
bfloat16``, on one device; validation scores in f32, as the reference's
``make_eval_step``).  Field-aware FM (``field_num > 0``, one device)
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
saved (with its optimizer state) and restored like the sparse step, on
one device.

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
values: PyTorch has no GSPMD) and evaluates through the same sharded
forward; metrics are summed over the ``data`` axis, so every rank
reports the global ones, and rank 0 writes the one ``params.npz``.

:meth:`Trainer.train_step` (one host batch, copied with
``train.sparse.to_device``) and :meth:`Trainer.evaluate` keep the plain
route to the device.  :func:`predict` scores ``predict_files`` through
the serving path's scorer for whatever the checkpoint holds
(``serve.scorer.make_scorer``: ``params.npz`` or ``quant.npz`` at
``serve_table_dtype``, or a ``tiered.npz`` overlay), with ``batch_size``
added as a rung, and writes one score per line in input order.  A
trainer refuses to warm-start over a ``quant.npz``, and a dense one over
a ``tiered.npz``.

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

Settings that would change the result and need a later slice raise
NotImplementedError naming the ROADMAP.md port-queue item; settings that
never change a parameter are accepted and logged as inert.
"""

from __future__ import annotations

import dataclasses
import logging
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
from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.parallel.mesh import (
    DATA_AXIS, Mesh, data_partition, make_mesh, psum,
)
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.train import checkpoint, metrics as metrics_lib
from fast_tffm_tpu_torch.train import tiered as tiered_lib
from fast_tffm_tpu_torch.train.dense import dense_step
from fast_tffm_tpu_torch.train.dispatch import GraphedSteps
from fast_tffm_tpu_torch.train.optimizers import init_dense_opt_state
from fast_tffm_tpu_torch.train.shardmap_step import (
    exchange_mode, local_scores, sparse_step_shardmap, supports_shardmap,
)
from fast_tffm_tpu_torch.train.sparse import (
    init_sparse_opt_state, sparse_step, supports_sparse, to_device,
)

log = logging.getLogger(__name__)

__all__ = ["MetricState", "Trainer", "predict"]

# (setting, description) pairs of observability planes the port's
# trainer accepts but does not run yet (ROADMAP.md port queue item 4);
# none of them changes a parameter.
_INERT_PLANES = (
    ("nan_policy", "health monitors and nan_policy"),
    ("quality", "quality plane"),
    ("trace_file", "trace"),
    ("heartbeat_secs", "heartbeat"),
    ("blackbox", "blackbox"),
    ("metrics_file", "metrics stream"),
    ("status_port", "status endpoint"),
    ("alert_rules", "alerts"),
    ("profile_dir", "profiler"),
)
# Interaction choices of the reference (its autotune, ROADMAP.md port
# queue item 4): the port always runs its kernels, so none changes a
# parameter.
_INERT_INTERACTION = ("interaction", "interaction_impl", "use_pallas")


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


def _check_supported(cfg: FmConfig) -> None:
    unported = []
    if not _sparse(cfg) and _multi_rank(cfg):
        # The reference's dense step on a mesh is GSPMD's partitioning.
        unported.append((
            f"the dense optax path on a rank mesh (sparse_update="
            f"{cfg.sparse_update}, optimizer={cfg.optimizer}, l2_mode="
            f"{cfg.l2_mode}; the reference's GSPMD step)", 3,
        ))
    if cfg.field_num > 0 and _multi_rank(cfg):
        # The reference's sharded step has its own FFM closed form
        # (train/shardmap_step.py::_ffm_fwd_bwd).
        unported.append((
            "field_num > 0 on a rank mesh (the sharded step's field-aware "
            "FM)", 3,
        ))
    if cfg.compute_dtype != "float32" and _multi_rank(cfg):
        # The reference's sharded step rounds its xv products to bf16 in
        # its own closed form, with no Pallas kernel: another path.
        unported.append((
            f"compute_dtype={cfg.compute_dtype} on a rank mesh (the "
            f"sharded step's bf16 closed form)", 3,
        ))
    if cfg.table_tiering == "on" and (cfg.tiered_partition == "shards"
                                      or _multi_rank(cfg)):
        unported.append((
            "table_tiering=on with tiered_partition=shards or on a rank "
            "mesh (the rank-sharded tiered table, tiered_fleet)", 3,
        ))
    if cfg.sparse_exchange_overlap == "on" and cfg.lookup != "shardmap":
        unported.append((
            "sparse_exchange_overlap=on (the entries exchange's id-plane "
            "prefetch, make_entries_prefetch)", 3,
        ))
    if unported:
        what = "; ".join(
            f"{name} is ROADMAP.md port queue item {item}"
            for name, item in unported
        )
        raise NotImplementedError(f"not in the PyTorch port yet: {what}")
    # Health, quality and blackbox are on by default in the reference;
    # the rest count when set.
    inert = [desc for key, desc in _INERT_PLANES if getattr(cfg, key)]
    if inert:
        log.info(
            "the PyTorch port's trainer does not run these planes yet "
            "(ROADMAP.md port queue item 4; parameters are unaffected): %s",
            ", ".join(inert),
        )
    defaults = FmConfig()
    knobs = [k for k in _INERT_INTERACTION
             if getattr(cfg, k) != getattr(defaults, k)]
    if knobs:
        log.info(
            "the PyTorch port's trainer always runs its kernels and does "
            "not act on %s (ROADMAP.md port queue item 4; parameters are "
            "unaffected)", ", ".join(knobs),
        )


def _tiered_device_config(cfg: FmConfig) -> FmConfig:
    """The configuration the device side of a ``table_tiering = on`` run
    is built from: ``vocabulary_size`` the hot table's rows (ingest keeps
    the logical vocabulary), after the reference's refusals
    (``fast_tffm_tpu/train/loop.py``, ``Trainer.__init__``)."""
    if not _sparse(cfg):
        raise ValueError(
            "table_tiering=on requires the sparse update path "
            "(optimizer in adagrad/ftrl/sgd with batch-mode L2): "
            "a dense optimizer rewrites every row every step, so "
            "there is no cold set to keep off-device"
        )
    if cfg.tiered_partition == "global" and _multi_rank(cfg):
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
    if cfg.hot_rows >= cfg.vocabulary_size:
        log.info(
            "table_tiering=on with hot_rows >= vocabulary_size: "
            "every row fits the hot table (tiering is a no-op "
            "beyond the remap)"
        )
    return dataclasses.replace(
        cfg, vocabulary_size=min(cfg.hot_rows, cfg.vocabulary_size))


def _check_mesh(cfg: FmConfig, mesh: Mesh) -> None:
    """Refusals and notices of the rank mesh, as the reference's."""
    if cfg.sparse_exchange_overlap == "on":  # lookup=shardmap here
        raise ValueError(
            "sparse_exchange_overlap=on requires the sparse gather/apply "
            "step (lookup != shardmap); this run resolved to "
            "lookup=shardmap"
        )
    if mesh.size == 1:
        return
    if not supports_shardmap(cfg, mesh):
        raise ValueError(
            "lookup=shardmap needs optimizer in adagrad/ftrl/sgd, "
            "batch-mode L2, and a vocabulary divisible by "
            f"model_shards*{sparse_apply.TILE}"
        )
    if cfg.batch_size % mesh.data:
        raise ValueError(
            f"batch_size {cfg.batch_size} not divisible by {mesh.data} "
            f"data blocks"
        )
    b_local = cfg.batch_size // mesh.data
    exchange = exchange_mode(cfg, mesh, b_local * cfg.max_features)
    log.info(
        "rank %d of a %dx%d (data x model) mesh, backend %s: lookup=%s "
        "runs the hand-sharded step (PyTorch has no GSPMD), "
        "sparse_exchange=%s resolved to %s", mesh.rank, mesh.data,
        mesh.model, mesh.backend, cfg.lookup, cfg.sparse_exchange, exchange,
    )
    if (cfg.sparse_exchange_overlap == "auto" and cfg.lookup != "shardmap"
            and exchange == "entries" and mesh.data > 1):
        log.info(
            "sparse_exchange_overlap=auto: the reference would overlap the "
            "entries exchange's id plane here; the port runs without it "
            "(bitwise the same result; ROADMAP.md port queue item 3)"
        )


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


class Trainer:
    """Drives sparse or dense training per an :class:`FmConfig`, on
    ``device`` (the GPU unless asked otherwise): on one device, or (the
    sparse step) as this rank of the config's mesh once
    ``train.dist.initialize`` has run."""

    def __init__(self, cfg: FmConfig,
                 device: Optional[Union[str, torch.device]] = None):
        # With tiering on, the device tables are the hot table's
        # (``dcfg``); the logical vocabulary stays the input's.
        self.tiered: Optional[tiered_lib.TieredTable] = None
        self.dcfg = (_tiered_device_config(cfg)
                     if cfg.table_tiering == "on" else cfg)
        _check_supported(cfg)
        self.cfg = cfg
        self.sparse = _sparse(cfg)
        if cfg.sparse_update and not self.sparse:
            log.info(
                "sparse_update unsupported for optimizer=%s l2_mode=%s; "
                "using dense optax path", cfg.optimizer, cfg.l2_mode,
            )
        self.device = resolve_device(device)
        self.mesh = make_mesh(cfg)
        _check_mesh(cfg, self.mesh)
        self.sharded = self.mesh.size > 1
        self.model, self.opt_state, self._restored_step = (
            self._init_or_restore_tiered() if cfg.table_tiering == "on"
            else self._init_or_restore()
        )
        # Updated in place, as the model and optimizer tensors are: a
        # captured graph holds all of them.
        self.metrics = MetricState.zeros(self.device)
        # The input position a save records: the epoch, and the batches
        # of it that trained.
        self._epoch = self._batches_done = 0
        self.eager_reason = self._eager_reason()
        self.graph = (None if self.eager_reason else GraphedSteps(
            max(1, cfg.steps_per_dispatch)))
        self.graph_dispatches = self.eager_dispatches = 0

    def _eager_reason(self) -> Optional[str]:
        """Why this trainer's dispatches run eagerly (None: graphed)."""
        if self.device.type != "cuda":
            return f"the {self.device.type} device has no CUDA graphs"
        if self.sharded:
            return ("the sharded step's collectives and device sort are "
                    "not captured (ROADMAP.md port queue item 3)")
        if self.tiered is not None:
            return ("table_tiering=on migrates rows between dispatches and "
                    "sorts the remapped ids on the device, which reads the "
                    "unique count on the host (ROADMAP.md port queue item "
                    "7a)")
        if not self.cfg.host_sort:
            return ("host_sort = false sorts on the device, which reads "
                    "the unique count on the host (ROADMAP.md port queue "
                    "item 7a)")
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
                cfg.model_file, cfg.optimizer, device=self.device, rows=rows
            )
            if opt is None:
                log.info("checkpoint holds no %s state; initialising it",
                         cfg.optimizer)
                opt = init_opt(cfg, model)
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
        ``params.npz`` read to host numpy (never at ``[V, D]`` on the
        card) to seed the cold stores, so a tiered run resumes from a
        dense run's checkpoint, and the other way round, at any
        ``hot_rows``."""
        cfg, dcfg, dev = self.cfg, self.dcfg, self.device
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        model = fm.init_params(dcfg, gen, device=dev)

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
            self.tiered = tiered_lib.TieredTable(cfg, overlay=stores,
                                                 device=dev)
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
            self.tiered = tiered_lib.TieredTable(
                cfg, dense_tables=dense_tables, device=dev)
            return model, opt, step
        self.tiered = tiered_lib.TieredTable(cfg, device=dev)
        return model, init_sparse_opt_state(dcfg, model), 0

    def _ftrl_normalize_np(self, w0, table, opt_np) -> tuple:
        """The sparse FTRL applies rely on ``w == ftrl_solve(z, n)``: a
        restored ``(w0, table)`` off it (edited outside training) is
        replaced, with a warning, by the closed form before it seeds the
        cold store (``fast_tffm_tpu/train/loop.py::_ftrl_normalize_np``)."""
        cfg = self.cfg

        def solve(z, n):
            return sparse_apply.ftrl_solve(
                torch.from_numpy(np.asarray(z, np.float32)),
                torch.from_numpy(np.asarray(n, np.float32)),
                cfg.learning_rate, cfg.ftrl_l1, cfg.ftrl_l2, cfg.ftrl_beta,
            ).numpy()

        want_w0 = solve(opt_np.z_w0, opt_np.n_w0)
        want_table = solve(opt_np.z_table, opt_np.n_table)
        dev = max(float(np.max(np.abs(want_w0 - w0))),
                  float(np.max(np.abs(want_table - table))))
        if dev <= 1e-6:
            return w0, table
        log.warning(
            "warm-started FTRL params violate w == ftrl_solve(z, n) "
            "(max |dev| %.3g) — the table was edited outside "
            "train.sparse.  Normalizing before seeding the tiered cold "
            "store, matching the dense restore path.", dev,
        )
        return np.float32(want_w0), want_table

    def _plan_group(self, group: list) -> tuple:
        """The transfer stage's ``plan_hook`` under tiering: the group's
        logical ids remapped to hot slots through one plan of the
        super-batch (``fast_tffm_tpu/train/loop.py::_put_super``)."""
        new_ids, plan = self.tiered.plan(np.stack([b.ids for b in group]))
        return [b._replace(ids=new_ids[i], sort_meta=None)
                for i, b in enumerate(group)], plan

    def _hot_tables(self) -> tuple:
        """The device hot tables, params first, in the stores' order."""
        return (self.model.table,) + tiered_lib.get_opt_tables(
            self.cfg.optimizer, self.opt_state)

    def _hot_host_tables(self) -> list:
        """Host copies of the device hot tables (waits for the device)."""
        return [t.detach().cpu().numpy() for t in self._hot_tables()]

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
                slots = sh.evict_slots[:sh.n_evict]
                rows = torch.stack([t.index_select(0, slots)
                                    for t in tables])
                event = None
                if rows.is_cuda:
                    host = torch.empty(rows.shape, dtype=rows.dtype,
                                       pin_memory=True)
                    host.copy_(rows, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    rows = host
                man.push_writeback(sh.plan_id, tuple(rows.unbind(0)), event)
            if sh.n_load:
                slots = sh.load_slots[:sh.n_load].long()
                for t, r in zip(tables, sh.load_rows):
                    t.index_copy_(0, slots, r[:sh.n_load])
                man.note_applied(sh)
        return sh.batch

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

    def device_step(self, dev_batch: Batch) -> torch.Tensor:
        """One step on a device :class:`Batch` (this rank's data block on
        a mesh); returns the batch's mean weighted data loss as a device
        scalar."""
        if self.sharded:
            scores = sparse_step_shardmap(self.cfg, self.model,
                                          self.opt_state, dev_batch,
                                          self.mesh)
        else:
            step = sparse_step if self.sparse else dense_step
            scores = step(self.cfg, self.model, self.opt_state, dev_batch)
        lsum, wsum = self.metrics.add_(scores, dev_batch, self.cfg.loss_type)
        return lsum / torch.clamp(wsum, min=1e-12)

    def _run_steps(self, sb: SuperBatch) -> torch.Tensor:
        """The ``sb.n`` steps of a super-batch on its views (the whole
        ``seg_start`` slot, so no shape depends on a batch's unique
        count), what the graph captures; returns their losses ``[n]``."""
        return torch.stack([self.device_step(sb.step(i))
                            for i in range(sb.n)])

    def dispatch(self, sb, pause=None) -> torch.Tensor:
        """Train one shipped super-batch: one replay of the CUDA graph of
        its K steps when it is full and the graph is captured, else the
        same steps eagerly (the first full one is then captured, inside
        ``pause``: the transfer stage's ``paused()``).  Under tiering
        ``sb`` is a :class:`tiered_lib.Shipment`, whose migration is
        applied first (always eager).  Returns the steps' losses ``[n]``
        (a device tensor; a replay's is the graph's own, overwritten by
        the next one).  The loop's hook per dispatch."""
        if isinstance(sb, tiered_lib.Shipment):
            sb = self._apply_migration(sb)
        graph = self.graph
        if graph is not None and graph.captured and sb.n == graph.k:
            self.graph_dispatches += 1
            return graph.replay(sb)
        losses = self._run_steps(sb)
        self.eager_dispatches += 1
        if graph is not None and not graph.captured and sb.n == graph.k:
            graph.capture(sb, self._run_steps, pause)
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

    def train(self) -> dict:
        cfg = self.cfg
        if not cfg.train_files:
            raise ValueError("no train_files configured")
        self._epoch, self._batches_done = self._resume_position()
        if self.tiered is not None:
            self.tiered.reopen()  # re-arm after a cancelled earlier run
        t0 = time.time()
        last_log_t = t0
        last_log_ex = self.global_metrics(self.metrics)["examples"]
        stepno = last_log_step = last_val_step = last_save_step = 0
        dispatches = 0
        self.graph_dispatches = self.eager_dispatches = 0
        if self.eager_reason:
            log.info("every dispatch runs eagerly: %s", self.eager_reason)
        wait_s = dispatch_s = first_s = 0.0
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
        )
        prefetcher = DevicePrefetcher(
            pipeline, k, self.device, cfg.vocabulary_size,
            depth=cfg.prefetch_super_batches, packer=packer,
            plan_hook=self._plan_group if self.tiered is not None else None,
        )
        cache_logged = not cfg.cache_epochs
        try:
            source = iter(prefetcher)
            while True:
                t_wait = time.perf_counter()
                item = next(source, None)
                t_run = time.perf_counter()
                wait_s += t_run - t_wait
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
                self.dispatch(item, prefetcher.paused())
                dispatch_s += time.perf_counter() - t_run
                if not dispatches:
                    first_s = time.time() - t0
                dispatches += 1
                stepno += item.n
                self._batches_done += item.n
                if cfg.log_steps and stepno - last_log_step >= cfg.log_steps:
                    last_log_step = stepno
                    m = self.global_metrics(self.metrics)
                    now = time.time()
                    rate = (m["examples"] - last_log_ex) / max(
                        now - last_log_t, 1e-9
                    )
                    last_log_t, last_log_ex = now, m["examples"]
                    log.info(
                        "step %d examples %d loss %.6f auc %.4f ex/s %.0f",
                        stepno, int(m["examples"]), m["loss"], m["auc"],
                        rate,
                    )
                if (cfg.validation_steps and cfg.validation_files
                        and stepno - last_val_step >= cfg.validation_steps):
                    last_val_step = stepno
                    vm = self.evaluate(cfg.validation_files)
                    log.info("step %d validation loss %.6f auc %.4f",
                             stepno, vm["loss"], vm["auc"])
                if cfg.save_steps and stepno - last_save_step >= cfg.save_steps:
                    last_save_step = stepno
                    self.save(stepno)
        finally:
            if self.tiered is not None:
                # Wake a transfer thread blocked on a write-back fill
                # that will never come, or close() would join it forever.
                self.tiered.cancel_waits()
            prefetcher.close()
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
        train_metrics["ingest_wait_frac"] = wait_s / wall
        train_metrics["wait_input_s"] = wait_s
        train_metrics["dispatch_s"] = dispatch_s
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
            if self.tiered.dense_save_ok:
                merged = self.tiered.merged_dense(self._hot_host_tables())
                model = fm.FmModel(self.model.w0.detach(),
                                   torch.from_numpy(merged[0]).to(
                                       self.device))
                del merged
            else:
                self.tiered.sync_from_device(self._hot_host_tables())
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
                            field_num=self.cfg.field_num)
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
        ``tiered.npz``.  Returns the written file's path."""
        data_state = {"epoch": self._epoch,
                      "batches_done": self._batches_done,
                      "fingerprint": self._data_fingerprint()}
        step = self._restored_step + stepno
        if self.tiered is None:
            return checkpoint.save_sharded(
                self.cfg.model_file, self.model, self.mesh, step=step,
                opt_state_l=self.opt_state, data_state=data_state,
            )
        cfg, man = self.cfg, self.tiered
        host_tables = self._hot_host_tables()
        w0 = self.model.w0.detach().cpu()
        if man.dense_save_ok:
            merged = [torch.from_numpy(m)
                      for m in man.merged_dense(host_tables)]
            opt = tiered_lib.set_opt_tables(cfg.optimizer, self.opt_state,
                                            tuple(merged[1:]))
            return checkpoint.save_params(
                cfg.model_file, fm.FmModel(w0, merged[0]), step=step,
                opt_state=opt, data_state=data_state)
        scalars = {"w0": w0.numpy(),
                   **tiered_lib.get_opt_scalars(cfg.optimizer,
                                                self.opt_state)}
        return checkpoint.save_tiered(
            cfg.model_file, step, scalars, man.export_overlay(host_tables),
            data_state=data_state)


def predict(cfg: FmConfig,
            device: Optional[Union[str, torch.device]] = None) -> int:
    """Score ``predict_files`` into ``score_path``, one score per line in
    input order: sigmoid probabilities for logistic loss, raw scores for
    mse.  Scores through ``serve.scorer.make_scorer``, so every format
    the server takes is predicted the same way: ``params.npz`` (at any
    ``serve_table_dtype``), ``quant.npz`` and ``tiered.npz``.  Returns
    the number of scores written."""
    if not cfg.predict_files:
        raise ValueError("no predict_files configured")
    from fast_tffm_tpu_torch.serve import scorer as serve_scorer

    scorer = serve_scorer.make_scorer(cfg, device=device,
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
