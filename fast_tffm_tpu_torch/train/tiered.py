"""Two-tier embedding table: hot rows on the device over a host cold store.

The counterpart of ``fast_tffm_tpu/train/tiered.py``.  A vocabulary
whose ``[V, D]`` table and optimizer tables do not fit the card trains
with ``table_tiering = on``: the device holds a compact HOT table of
``hot_rows`` (H) rows, with its optimizer tables beside it, and the
full logical table lives on the host as a :class:`ColdStore` per table.

Division of labour:

- :class:`TieredTable` (host) owns the logical-id -> hot-slot map, the
  LRU migration plan, the cold stores and the delayed write-back
  ledger.  :meth:`TieredTable.plan` runs on the transfer thread
  (``data/prefetch.py``'s ``plan_hook``): each super-batch's ids are
  remapped to hot slots, missed rows are fetched from the cold store,
  and the plan's arrays ride the batch's one pinned copy to the device;
- the ordinary sparse step (``train/sparse.py``: FmScorer, FmGrad, K1,
  K2) runs unchanged on the hot tables: a remapped batch is a batch of
  a small vocabulary;
- the dispatch loop (``train/loop.py::Trainer._apply_migration``)
  applies a plan between dispatches: it gathers the evicted slots into
  a pinned host buffer (one non-blocking copy and a CUDA event, handed
  to :meth:`TieredTable.push_writeback`), then overwrites the loaded
  slots.  The cold store absorbs the evicted rows once the event has
  completed (``_entry_host`` waits on it), never stalling the loop.

Consistency: plans are made in emission order (one transfer thread) and
applied in the same order (one dispatch loop), so the planning view of
the slot map may run ahead of the device while ``id_of_slot_applied``
tracks what the device tables hold; an evicted row is pending from its
plan until its copy lands, and a re-fetch of a pending id waits for the
fill (the loop never waits on the planner, so this cannot deadlock); a
checkpoint or evaluation syncs through the applied view.

Cold-store modes:

- exact (logical tables of at most :data:`EXACT_BYTES_MAX` bytes): the
  whole table is drawn once with the port's own init on the trainer's
  device (``models/fm.py::init_params``, the dense trainer's draw), so a
  tiered run is element for element the dense run from the same seed,
  and checkpoints are the ordinary ``params.npz``;
- virtual (larger): rows materialise on demand, a deterministic
  per-row hash init (:func:`_hash_uniform`, splitmix64, bitwise the
  reference's) plus a sorted overlay of every row written back, so host
  memory scales with the rows touched, not with V.  Checkpoints are the
  sparse-overlay ``tiered.npz`` (``train/checkpoint.py::save_tiered``),
  which ``serve/scorer.py::OverlayScorer`` serves.

Rows are stored packed through an :class:`ops.quant.RowCodec`
(``cold_dtype``): fp32 is the identity, bf16 and int8 store compact rows
encoded on every write and decoded on every read.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models import fm
from fast_tffm_tpu_torch.obs.telemetry import NULL
from fast_tffm_tpu_torch.ops import quant
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.train.sparse import init_sparse_opt_state

__all__ = [
    "ColdStore", "EXACT_BYTES_MAX", "Plan", "ShardSpec", "Shipment",
    "TieredTable", "get_opt_scalars", "get_opt_tables", "opt_table_names",
    "set_opt_scalars", "set_opt_tables",
]

# Cold arrays at or below this byte size are materialized exactly with
# the dense trainer's init; larger stores use the virtual row-hash init
# with a sparse written-row overlay.  A dense table of more bytes is
# refused by ColdStore.to_dense.  A module attribute, so tests can force
# the virtual mode at tiny vocabularies.
EXACT_BYTES_MAX = 1 << 28

# slot_of states: >= 0 resident at that hot slot.
_NEVER = -1  # never touched this run/restore: cold value is the row init
_EVICTED = -2  # was resident; latest value lives in (or is bound for) cold


def _bucket(n: int, lo: int = 8) -> int:
    """Round up to a power of two >= lo: migration arrays and the
    compact tables of the overlay scorer and the virtual evaluation are
    padded to these lengths, so they take O(log) shapes."""
    b = lo
    while b < n:
        b <<= 1
    return b


# ----------------------------------------------------------------------
# Optimizer slots: which [V, D] tables ride beside the params table, and
# the port's sparse optimizer states rebuilt around new ones.
# ----------------------------------------------------------------------


def opt_table_names(optimizer: str) -> tuple:
    """Names of the table-shaped optimizer slots, in K2's order."""
    return {"adagrad": ("acc",), "ftrl": ("z", "n"), "sgd": ()}[optimizer]


def get_opt_tables(optimizer: str, opt_state) -> tuple:
    if optimizer == "adagrad":
        return (opt_state.acc_table,)
    if optimizer == "ftrl":
        return (opt_state.z_table, opt_state.n_table)
    return ()


def set_opt_tables(optimizer: str, opt_state, tables: tuple):
    if optimizer == "adagrad":
        return opt_state._replace(acc_table=tables[0])
    if optimizer == "ftrl":
        return opt_state._replace(z_table=tables[0], n_table=tables[1])
    return opt_state


def get_opt_scalars(optimizer: str, opt_state) -> dict:
    """The non-table (w0) optimizer slots as host scalars, under the
    keys ``tiered.npz`` stores them by."""
    def host(t):
        if torch.is_tensor(t):
            t = t.detach().cpu().numpy()
        return np.asarray(t, np.float32)

    if optimizer == "adagrad":
        return {"acc_w0": host(opt_state.acc_w0)}
    if optimizer == "ftrl":
        return {"z_w0": host(opt_state.z_w0), "n_w0": host(opt_state.n_w0)}
    return {}


def set_opt_scalars(optimizer: str, opt_state, scalars: dict, put):
    if optimizer == "adagrad":
        return opt_state._replace(acc_w0=put(scalars["acc_w0"]))
    if optimizer == "ftrl":
        return opt_state._replace(z_w0=put(scalars["z_w0"]),
                                  n_w0=put(scalars["n_w0"]))
    return opt_state


# ----------------------------------------------------------------------
# Cold store: one logical [V, D] f32 array in host RAM
# ----------------------------------------------------------------------


def _hash_uniform(ids: np.ndarray, dim: int, seed: int,
                  scale: float) -> np.ndarray:
    """Deterministic per-row uniform(-scale, scale) init, vectorized:
    splitmix64 over (id * dim + column) xor a seed constant, so any row
    of the virtual table is computable without any other."""
    with np.errstate(over="ignore"):
        x = ids.astype(np.uint64)[:, None] * np.uint64(dim) + np.arange(
            dim, dtype=np.uint64
        )[None, :]
        x ^= np.uint64((seed * 0x9E3779B97F4A7C15 + 1) & 0xFFFFFFFFFFFFFFFF)
        x += np.uint64(0x9E3779B97F4A7C15)
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    u = (x >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
    return ((u * 2.0 - 1.0) * scale).astype(np.float32)


class ColdStore:
    """Host-RAM backing for one logical ``[vocab, dim]`` f32 table,
    dense-backed (``dense``) or virtual (``init_rows(ids) -> [n, dim]``
    plus the sorted overlay of written rows), its rows packed through
    ``codec`` (fp32 when None)."""

    def __init__(self, vocab: int, dim: int, descriptor: dict,
                 init_rows=None, dense: Optional[np.ndarray] = None,
                 codec: Optional[quant.RowCodec] = None):
        self.vocab = vocab
        self.dim = dim
        self.descriptor = dict(descriptor)
        self._init_rows = init_rows
        self._codec = codec if codec is not None else quant.RowCodec(
            "fp32", dim
        )
        self._dense = dense
        # Sorted overlay (virtual mode): _ids ascending, _rows[i] the
        # packed value of row _ids[i].  Writes land in a TAIL of (sorted
        # ids, rows) batches and merge into the main arrays only when
        # the tail outgrows a fraction of them.
        self._ids = np.empty((0,), np.int64)
        self._rows = self._codec.empty(0)
        self._tail: list = []  # [(sorted unique ids, rows), ...] newest last
        self._tail_n = 0

    @property
    def cold_dtype(self) -> str:
        return self._codec.dtype

    @classmethod
    def from_dense(cls, arr: np.ndarray, descriptor: dict,
                   codec: Optional[quant.RowCodec] = None) -> "ColdStore":
        vocab, dim = arr.shape
        if codec is not None and codec.dtype != "fp32":
            return cls(vocab, dim, descriptor, dense=codec.encode(arr),
                       codec=codec)
        arr = np.ascontiguousarray(arr, dtype=np.float32)
        if not arr.flags.writeable:
            arr = arr.copy()
        return cls(vocab, dim, descriptor, dense=arr, codec=codec)

    @property
    def dense_backed(self) -> bool:
        return self._dense is not None

    @property
    def nbytes(self) -> int:
        if self._dense is not None:
            return self._dense.nbytes
        return (
            self._ids.nbytes + self._rows.nbytes
            + sum(i.nbytes + r.nbytes for i, r in self._tail)
        )

    @property
    def written_rows(self) -> int:
        if self._dense is not None:
            return self.vocab
        self._compact()
        return len(self._ids)

    def _overlay(self, out, ids, o_ids, o_rows) -> None:
        """out[k] = decode(o_rows[j]) wherever ids[k] == o_ids[j]
        (o_ids sorted; ``out`` is f32)."""
        if not len(o_ids):
            return
        pos = np.searchsorted(o_ids, ids)
        pos_c = np.minimum(pos, len(o_ids) - 1)
        hit = o_ids[pos_c] == ids
        if hit.any():
            out[hit] = self._codec.decode(o_rows[pos_c[hit]])

    def gather(self, ids: np.ndarray) -> np.ndarray:
        """Current f32 value of each logical row: the written value,
        else the init (quantized stores decode on the way out)."""
        ids = ids.astype(np.int64, copy=False)
        if self._dense is not None:
            return self._codec.decode(self._dense[ids])
        out = self._init_rows(ids)
        self._overlay(out, ids, self._ids, self._rows)
        for t_ids, t_rows in self._tail:  # newest last = newest wins
            self._overlay(out, ids, t_ids, t_rows)
        return out

    def scatter(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Write f32 rows (ids unique) into the store (quantized stores
        encode on the way in)."""
        if not len(ids):
            return
        ids = ids.astype(np.int64, copy=False)
        if self._dense is not None and self._codec.dtype == "fp32":
            self._dense[ids] = rows
            return
        self._store_packed(
            ids, self._codec.encode(np.asarray(rows, np.float32))
        )

    def _store_packed(self, ids: np.ndarray, packed: np.ndarray) -> None:
        """Write already-packed rows (the overlay restore: no decode and
        re-encode, so a checkpointed row restores bit-exactly)."""
        if packed.shape[1:] != (self._codec.width,):
            raise ValueError(
                f"packed rows have width {packed.shape[1:]} but this "
                f"{self._codec.dtype} store expects "
                f"[{self._codec.width}]"
            )
        if self._dense is not None:
            self._dense[ids] = packed
            return
        order = np.argsort(ids, kind="stable")
        self._tail.append((
            ids[order].copy(),
            np.ascontiguousarray(packed[order]),
        ))
        self._tail_n += len(ids)
        if self._tail_n > max(4096, len(self._ids) // 2):
            self._compact()

    def _compact(self) -> None:
        """Merge the write tail into the sorted main overlay (newest
        write wins per id)."""
        if not self._tail:
            return
        all_ids = np.concatenate([self._ids] + [i for i, _ in self._tail])
        all_rows = np.concatenate(
            [self._rows] + [r for _, r in self._tail]
        )
        # Keep the LAST occurrence of each id: unique() keeps the first,
        # so dedupe over the reversed arrays.
        rev_ids = all_ids[::-1]
        u, first = np.unique(rev_ids, return_index=True)
        self._ids = u
        self._rows = np.ascontiguousarray(all_rows[::-1][first])
        self._tail = []
        self._tail_n = 0

    def to_dense(self) -> np.ndarray:
        """The full logical array as f32; only for dense-backed stores or
        virtual ones of at most :data:`EXACT_BYTES_MAX` bytes."""
        if self._dense is None:
            if self.vocab * self.dim * 4 > EXACT_BYTES_MAX:
                raise ValueError(
                    f"cold store [{self.vocab}, {self.dim}] is too large "
                    "to materialize densely; use the tiered overlay "
                    "checkpoint format"
                )
            self._compact()
            dense = self._init_rows(np.arange(self.vocab, dtype=np.int64))
            if len(self._ids):
                dense[self._ids] = self._codec.decode(self._rows)
            self._dense = (
                dense if self._codec.dtype == "fp32"
                else self._codec.encode(dense)
            )
            self._ids = np.empty((0,), np.int64)
            self._rows = self._codec.empty(0)
        return self._codec.decode(self._dense)

    def export(self) -> dict:
        """Sparse overlay payload for ``tiered.npz``: ``ids`` and the
        PACKED ``rows`` (a dense-backed store exports every row)."""
        if self._dense is not None:
            return {
                "ids": np.arange(self.vocab, dtype=np.int64),
                "rows": self._dense.copy(),
            }
        self._compact()
        return {"ids": self._ids.copy(), "rows": self._rows.copy()}

    def import_overlay(self, payload: dict) -> None:
        ids = payload["ids"].astype(np.int64, copy=False)
        if len(ids):
            self._store_packed(
                ids,
                np.asarray(payload["rows"], self._codec.storage_dtype),
            )


def _virtual_descriptor(cfg: FmConfig, name: str) -> dict:
    """The init identity a store's overlay is written against (and a
    restore must match), with the cold dtype's format identity."""
    if name == "table":
        desc = {"kind": "uniform", "seed": cfg.seed,
                "range": cfg.init_value_range}
    elif name in ("acc", "n"):
        desc = {"kind": "const", "value": cfg.adagrad_initial_accumulator}
    elif name == "z":
        denom0 = float(
            (cfg.ftrl_beta + np.sqrt(cfg.adagrad_initial_accumulator))
            / cfg.learning_rate + cfg.ftrl_l2
        )
        desc = {"kind": "ftrl_z", "seed": cfg.seed,
                "range": cfg.init_value_range, "denom0": denom0,
                "l1": cfg.ftrl_l1}
    else:
        raise ValueError(f"unknown store {name!r}")
    desc.update(quant.cold_codec(cfg).descriptor())
    return desc


def _virtual_store(cfg: FmConfig, name: str, *, vocab: Optional[int] = None,
                   id_offset: int = 0) -> ColdStore:
    """Virtual cold store over ``vocab`` rows; ``id_offset`` keys the
    hash init in global id space (a rank shard's local row i initializes
    as global row ``id_offset + i``)."""
    vocab = cfg.vocabulary_size if vocab is None else vocab
    dim = cfg.embedding_dim
    off = np.int64(id_offset)
    desc = _virtual_descriptor(cfg, name)
    if desc["kind"] == "uniform":
        seed, r = desc["seed"], desc["range"]

        def init_rows(ids):
            return _hash_uniform(ids + off, dim, seed, r)
    elif desc["kind"] == "const":
        v = desc["value"]

        def init_rows(ids):
            return np.full((len(ids), dim), v, np.float32)
    else:  # ftrl_z, derived from the params row init
        seed, r = desc["seed"], desc["range"]
        denom0, l1 = np.float32(desc["denom0"]), np.float32(desc["l1"])

        def init_rows(ids):
            p = _hash_uniform(ids + off, dim, seed, r)
            return -p * denom0 - np.sign(p) * l1
    return ColdStore(vocab, dim, desc, init_rows=init_rows,
                     codec=quant.cold_codec(cfg))


def _exact_stores(cfg: FmConfig, names: tuple,
                  params_table: Optional[np.ndarray],
                  device: Union[str, torch.device, None] = None,
                  row_range: Optional[tuple] = None) -> dict:
    """Dense-backed stores drawn as the dense trainer draws its tables:
    ``fm.init_params`` from ``torch.Generator(device).manual_seed(seed)``
    on the trainer's ``device`` (a CPU draw is not the card's), then the
    optimizer init beside it, copied to host numpy.  A given
    ``params_table`` (a restored dense table, in the caller's space) is
    taken instead of the draw; the optimizer init is elementwise and runs
    on ``device`` too.  ``row_range=(lo, hi)`` cuts the global draw to a
    rank shard's id span."""
    dev = resolve_device(device)
    if params_table is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        model = fm.init_params(cfg, gen, device=dev)
        if row_range is not None:
            model = fm.FmModel(model.w0.detach(), model.table.detach()[
                row_range[0]:row_range[1]].clone())
    else:
        model = fm.FmModel(torch.zeros((), device=dev),
                           torch.from_numpy(np.ascontiguousarray(
                               params_table, np.float32)).to(dev))
    codec = quant.cold_codec(cfg)
    desc = {"kind": "exact", **codec.descriptor()}
    with torch.no_grad():
        tables = {"table": model.table.detach()}
        opt_names = tuple(n for n in names if n != "table")
        if opt_names:
            opt = init_sparse_opt_state(cfg, model)
            tables.update(zip(opt_names, get_opt_tables(cfg.optimizer, opt)))
        return {name: ColdStore.from_dense(t.cpu().numpy(), desc, codec)
                for name, t in tables.items()}


# ----------------------------------------------------------------------
# Migration plan + manager
# ----------------------------------------------------------------------


class ShardSpec(NamedTuple):
    """Which slice of the logical table a :class:`TieredTable` manages
    under rank-sharded tiering (``tiered_fleet``, not ported yet: a
    trainer builds only ``ShardSpec()``).  ``index``/``count`` carve the
    id space into ``count`` contiguous ranges, in whose LOCAL
    coordinates the instance then works; with ``rows_enabled=False`` it
    is a metadata mirror that tracks the slot map and LRU but builds no
    cold stores, fetches no rows and keeps no write-back ledger."""

    index: int = 0
    count: int = 1
    rows_enabled: bool = True


class Plan(NamedTuple):
    """Host-side migration plan for one super-batch (before shipping)."""

    plan_id: int
    load_slots: np.ndarray  # [Mp] i32, padded with hot_rows
    load_ids: np.ndarray  # [n_load] i64 logical ids (applied-view update)
    load_rows: tuple  # per-store [Mp, D] f32 (pad rows are zeros)
    evict_slots: np.ndarray  # [Ep] i32, padded with 0
    n_load: int
    n_evict: int

    def leaves(self) -> list:
        """``[(name, array), ...]``: what the transfer stage packs into
        the super-batch's staging buffer beside the batch."""
        return ([("load_slots", self.load_slots)]
                + [(f"load_rows{i}", r) for i, r in enumerate(self.load_rows)]
                + [("evict_slots", self.evict_slots)])

    def ship(self, batch, views: dict) -> "Shipment":
        """The :class:`Shipment` of this plan: ``batch`` (the shipped
        super-batch) and the device ``views`` of :meth:`leaves`."""
        return Shipment(
            batch=batch, load_slots=views["load_slots"],
            load_rows=tuple(views[f"load_rows{i}"]
                            for i in range(len(self.load_rows))),
            evict_slots=views["evict_slots"],
            load_slots_h=self.load_slots, load_ids=self.load_ids,
            plan_id=self.plan_id, n_load=self.n_load, n_evict=self.n_evict,
        )


class Shipment(NamedTuple):
    """What the transfer stage hands the dispatch loop per super-batch
    when tiering is on: the remapped super-batch and the device halves of
    its migration plan (views of the same device buffer), with the host
    halves the applied view needs."""

    batch: object  # data.prefetch.SuperBatch (remapped ids)
    load_slots: object  # device [Mp] i32
    load_rows: tuple  # device per-store [Mp, D] f32
    evict_slots: object  # device [Ep] i32
    load_slots_h: np.ndarray  # host copy for the applied-view update
    load_ids: np.ndarray
    plan_id: int
    n_load: int
    n_evict: int

    @property
    def n(self) -> int:
        return self.batch.n


class TieredTable:
    """Host-side manager of the two-tier table (module docstring).

    Thread contract: ``plan`` runs on the transfer thread;
    ``push_writeback``/``note_applied``/``sync_from_device`` run in the
    dispatch loop; ``snapshot`` may run anywhere.  One condition variable
    guards all state; only the transfer thread ever WAITS on it (for a
    pending write-back fill), and the fill comes from the dispatch loop,
    which never blocks on the planner, so the wait always resolves (or
    :meth:`cancel_waits` releases it when the loop exits).
    """

    # Keep this many newest write-back entries unflushed: their copies
    # may still be in flight, and forcing them would stall the transfer
    # thread on the device.
    FLUSH_KEEP = 2

    def __init__(self, cfg: FmConfig, telemetry=None,
                 dense_tables: Optional[dict] = None,
                 overlay: Optional[dict] = None,
                 shard: Optional[ShardSpec] = None,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.device = device
        self.shard = shard if shard is not None else ShardSpec()
        v_global = cfg.vocabulary_size
        h_global = min(cfg.hot_rows, cfg.vocabulary_size)
        if v_global % self.shard.count or h_global % self.shard.count:
            raise ValueError(
                f"vocabulary_size={v_global} and hot_rows={h_global} must "
                f"both divide by the tier shard count "
                f"{self.shard.count} (contiguous id-range ownership)"
            )
        self.vocab = v_global // self.shard.count
        self.hot_rows = h_global // self.shard.count
        self.id_offset = self.shard.index * self.vocab
        self.rows_enabled = bool(self.shard.rows_enabled)
        self.dim = cfg.embedding_dim
        self.codec = quant.cold_codec(cfg)
        self.names = ("table",) + opt_table_names(cfg.optimizer)
        self._cv = threading.Condition(threading.RLock())
        self.slot_of = np.full(self.vocab, _NEVER, np.int32)
        self.id_of_slot = np.full(self.hot_rows, -1, np.int64)
        # What the DEVICE tables hold now (advanced by note_applied as
        # the dispatch loop applies plans); the planning view above runs
        # ahead by the in-flight plan depth.
        self.id_of_slot_applied = np.full(self.hot_rows, -1, np.int64)
        self.last_used = np.zeros(self.hot_rows, np.int64)
        self._free_ptr = 0
        self._tick = 0
        self._plan_seq = 0
        # Write-back ledger: plan_id -> entry; an entry fills when the
        # dispatch loop hands over the gathered rows.
        self._entries: dict = {}
        self._entry_q: deque = deque()
        self._pending: dict = {}  # logical id -> (entry, row index)
        # Set by cancel_waits() when the dispatch loop goes away: a
        # transfer thread blocked on a write-back fill must be released
        # (the fill will never come) or shutdown joins forever.
        self._cancelled = False
        self._hit_occ = 0
        self._miss_occ = 0
        self._oor_occ = 0
        self._rows_loaded = 0
        self._rows_evicted = 0
        self._rows_written_back = 0
        self._seen_rows = 0  # distinct logical ids ever resident
        if not self.rows_enabled:
            telemetry = None
        tel = telemetry if telemetry is not None else NULL
        self._c_hit = tel.counter("tiered.hit_occurrences")
        self._c_miss = tel.counter("tiered.miss_occurrences")
        self._c_load = tel.counter("tiered.rows_loaded")
        self._c_evict = tel.counter("tiered.rows_evicted")
        self._c_wb = tel.counter("tiered.writeback_rows")
        self.stores = self._build_stores(dense_tables, overlay)

    # ------------------------------------------------------------------
    # construction / restore
    # ------------------------------------------------------------------

    def _build_stores(self, dense_tables, overlay) -> tuple:
        cfg = self.cfg
        if not self.rows_enabled:
            return ()
        codec = quant.cold_codec(cfg)
        # Exact or virtual is decided on the GLOBAL table bytes, never a
        # shard's, so every shard count of a config picks the same mode.
        exact = cfg.vocabulary_size * self.dim * 4 <= EXACT_BYTES_MAX
        if dense_tables is not None:
            # Warm start from a dense checkpoint (already in this
            # instance's id space).  A missing optimizer store starts
            # from the RESTORED params, as the dense trainer's optimizer
            # init on restored params does.
            stores = {
                name: ColdStore.from_dense(arr, {"kind": "restored"}, codec)
                for name, arr in dense_tables.items()
            }
            missing = [n for n in self.names if n not in stores]
            if missing:
                fresh = _exact_stores(cfg, self.names, dense_tables["table"],
                                      self.device)
                for n in missing:
                    stores[n] = fresh[n]
            return tuple(stores[n] for n in self.names)
        if exact:
            row_range = (
                None if self.shard.count == 1
                else (self.id_offset, self.id_offset + self.vocab)
            )
            built = _exact_stores(cfg, self.names, None, self.device,
                                  row_range)
        else:
            built = {
                n: _virtual_store(cfg, n, vocab=self.vocab,
                                  id_offset=self.id_offset)
                for n in self.names
            }
        if overlay is not None:
            for name in self.names:
                payload = overlay[name]
                want = built[name].descriptor
                got = payload.get("descriptor")
                # kind="dense" overlays carry EVERY row's value, so they
                # restore onto any store of the same storage format.
                if got is not None and got.get("kind") == "dense":
                    fmt = {k: v for k, v in got.items() if k != "kind"}
                    want_fmt = codec.descriptor()
                    if fmt != want_fmt:
                        raise ValueError(
                            f"tiered checkpoint store {name!r} was packed "
                            f"as {fmt} but this run's cold_dtype expects "
                            f"{want_fmt}"
                        )
                elif got is not None and got != want:
                    raise ValueError(
                        f"tiered checkpoint store {name!r} was written "
                        f"under a different init ({got} != {want}); "
                        "seed/init_value_range/optimizer hyperparams must "
                        "match the run that saved it"
                    )
                built[name].import_overlay(payload)
        return tuple(built[n] for n in self.names)

    @property
    def dense_save_ok(self) -> bool:
        """Whether the merged logical table fits the ordinary dense
        checkpoint format."""
        return all(
            s.dense_backed or s.vocab * s.dim * 4 <= EXACT_BYTES_MAX
            for s in self.stores
        )

    # ------------------------------------------------------------------
    # transfer-thread side: remap + migration planning
    # ------------------------------------------------------------------

    def plan(self, ids: np.ndarray) -> tuple:
        """Remap a super-batch's logical ids to hot-slot indices,
        allocating slots for misses (LRU eviction once the never-used
        pool is spent).  Returns ``(remapped ids, Plan)``.  Runs on the
        transfer thread, so its ``np.unique`` and cold gathers overlap
        the previous super-batch's dispatch."""
        H, V = self.hot_rows, self.vocab
        flat = ids.reshape(-1)
        oor = (flat < 0) | (flat >= V)
        any_oor = bool(oor.any())
        src = flat[~oor] if any_oor else flat
        u = np.unique(src)
        with self._cv:
            self._flush_entries()
            self._tick += 1
            t = self._tick
            self._plan_seq += 1
            pid = self._plan_seq
            slots_u = self.slot_of[u]
            miss = slots_u < 0
            miss_ids = u[miss].astype(np.int64)
            n_miss = int(miss_ids.size)
            # One fetch serves every occurrence of a missed id in this
            # super-batch: a miss counts once per unique id.
            self._hit_occ += int(src.size) - n_miss
            self._miss_occ += n_miss
            self._oor_occ += int(flat.size - src.size)
            self._c_hit.add(int(src.size) - n_miss)
            self._c_miss.add(n_miss)
            evict_slots = np.empty((0,), np.int32)
            rows: tuple = ()
            if n_miss:
                if n_miss > H:
                    raise RuntimeError(
                        f"hot_rows={H} is smaller than one super-batch's "
                        f"unique id count ({n_miss}); raise hot_rows or "
                        "shrink steps_per_dispatch*batch_size*max_features"
                    )
                res_slots = slots_u[~miss]
                self.last_used[res_slots] = t
                n_fresh = min(n_miss, H - self._free_ptr)
                new_slots = np.empty(n_miss, np.int32)
                if n_fresh:
                    new_slots[:n_fresh] = np.arange(
                        self._free_ptr, self._free_ptr + n_fresh,
                        dtype=np.int32,
                    )
                    self._free_ptr += n_fresh
                    # Stamp fresh slots now: the eviction scan below must
                    # not take a slot this very plan allocated.
                    self.last_used[new_slots[:n_fresh]] = t
                n_evict = n_miss - n_fresh
                if n_evict:
                    cand = np.argpartition(
                        self.last_used, n_evict - 1
                    )[:n_evict].astype(np.int32)
                    if (
                        int(self.last_used[cand].max()) >= t
                        or int(self.id_of_slot[cand].min()) < 0
                    ):
                        raise RuntimeError(
                            f"hot_rows={H} cannot hold this super-batch's "
                            "working set: every eviction candidate is in "
                            "use by the current super-batch"
                        )
                    evict_ids = self.id_of_slot[cand].copy()
                    self.slot_of[evict_ids] = _EVICTED
                    if self.rows_enabled:
                        entry = {"ids": evict_ids, "dev": None,
                                 "event": None, "host": None, "skip": set()}
                        self._entries[pid] = entry
                        self._entry_q.append(pid)
                        for j, i in enumerate(evict_ids):
                            self._pending[int(i)] = (entry, j)
                    new_slots[n_fresh:] = cand
                    evict_slots = cand
                    self._rows_evicted += n_evict
                    self._c_evict.add(n_evict)
                self._seen_rows += int(
                    np.count_nonzero(self.slot_of[miss_ids] == _NEVER)
                )
                self.slot_of[miss_ids] = new_slots
                self.id_of_slot[new_slots] = miss_ids
                self.last_used[new_slots] = t
                if self.rows_enabled:
                    rows = self._fetch(miss_ids)
                self._rows_loaded += n_miss
                self._c_load.add(n_miss)
            else:
                self.last_used[slots_u] = t
            # Remap: every present id is resident now; an out-of-range
            # occurrence maps to H (the trainer's transfer stage refuses
            # those before it plans).
            if any_oor:
                safe = np.where(oor, 0, flat)
                new_flat = np.where(oor, np.int32(H), self.slot_of[safe])
            else:
                new_flat = self.slot_of[flat]
            new_ids = new_flat.astype(np.int32).reshape(ids.shape)
            # Bucket-pad the migration arrays (O(log) shapes).
            mp = _bucket(max(1, n_miss))
            load_slots = np.full(mp, H, np.int32)
            pad_rows = []
            if n_miss:
                load_slots[:n_miss] = self.slot_of[miss_ids]
                for r in rows:
                    pr = np.zeros((mp, r.shape[1]), np.float32)
                    pr[:n_miss] = r
                    pad_rows.append(pr)
            elif self.rows_enabled:
                pad_rows = [
                    np.zeros((mp, self.dim), np.float32) for _ in self.names
                ]
            ep = _bucket(max(1, len(evict_slots)))
            evict_pad = np.zeros(ep, np.int32)
            evict_pad[:len(evict_slots)] = evict_slots
            return new_ids, Plan(
                plan_id=pid,
                load_slots=load_slots,
                load_ids=miss_ids,
                load_rows=tuple(pad_rows),
                evict_slots=evict_pad,
                n_load=n_miss,
                n_evict=int(len(evict_slots)),
            )

    def _fetch(self, miss_ids: np.ndarray) -> tuple:
        """Cold-store rows for ``miss_ids``, serving ids with an
        in-flight write-back from the pending ledger (waiting for the
        fill when it has not landed yet).  Called under the lock."""
        n = len(miss_ids)
        pend_mask = None
        if self._pending:
            pids = np.fromiter(self._pending.keys(), np.int64,
                               len(self._pending))
            pend_mask = np.isin(miss_ids, pids)
            if not pend_mask.any():
                pend_mask = None
        if pend_mask is None:
            return tuple(s.gather(miss_ids) for s in self.stores)
        cold_ids = miss_ids[~pend_mask]
        outs = [np.empty((n, s.dim), np.float32) for s in self.stores]
        if len(cold_ids):
            for out, s in zip(outs, self.stores):
                out[~pend_mask] = s.gather(cold_ids)
        for k in np.nonzero(pend_mask)[0]:
            i = int(miss_ids[k])
            pe = self._pending.pop(i, None)
            if pe is None:
                # A sync from the dispatch loop absorbed this entry into
                # the cold store while we waited on another fill: the
                # cold value IS the written-back one now.
                row_id = miss_ids[k:k + 1]
                for out, s in zip(outs, self.stores):
                    out[k] = s.gather(row_id)[0]
                continue
            entry, j = pe
            host = self._entry_host(entry)
            for out, hr in zip(outs, host):
                out[k] = hr[j]
            entry["skip"].add(j)
        return tuple(outs)

    def cancel_waits(self) -> None:
        """Release any transfer-thread wait on a write-back fill: the
        dispatch loop is exiting and the fill will never come.  The woken
        wait raises, which surfaces through the transfer stage's error
        channel and lets shutdown join.  ``reopen()`` re-arms the manager
        for a later ``train()``."""
        with self._cv:
            self._cancelled = True
            self._cv.notify_all()

    def reopen(self) -> None:
        with self._cv:
            self._cancelled = False

    def _entry_host(self, entry) -> list:
        """Host rows of an entry, waiting for the dispatch loop's fill if
        needed, then for the fill's copy (its CUDA event) to land: the
        pinned buffer holds stale bytes until then.  Called under the
        lock; the wait releases it, so push_writeback can land."""
        while entry["dev"] is None and not self._cancelled:
            self._cv.wait()
        if entry["dev"] is None:
            raise RuntimeError(
                "tiered write-back wait cancelled: the dispatch loop "
                "exited before filling this plan's eviction rows"
            )
        if entry["host"] is None:
            if entry["event"] is not None:
                entry["event"].synchronize()
            n = len(entry["ids"])
            entry["host"] = [np.asarray(a)[:n] for a in entry["dev"]]
            entry["dev"] = ()  # drop the buffers' other references
            entry["event"] = None
        return entry["host"]

    def _flush_entries(self, force: bool = False) -> None:
        """Absorb settled write-back entries into the cold stores.  The
        newest FLUSH_KEEP stay buffered unless forced (their copies may
        be in flight); an unfilled entry (a plan not applied yet) stops
        the flush: the applied-view sweep covers it."""
        keep = 0 if force else self.FLUSH_KEEP
        while len(self._entry_q) > keep:
            pid = self._entry_q[0]
            entry = self._entries[pid]
            if entry["dev"] is None and entry["host"] is None:
                break  # not yet applied by the dispatch loop
            self._entry_q.popleft()
            del self._entries[pid]
            host = self._entry_host(entry)
            ids = entry["ids"]
            live = np.array(
                [j for j in range(len(ids)) if j not in entry["skip"]],
                np.int64,
            )
            for i in ids[live]:
                pe = self._pending.get(int(i))
                if pe is not None and pe[0] is entry:
                    del self._pending[int(i)]
            if len(live):
                self._rows_written_back += len(live)
                self._c_wb.add(len(live))
                for s, hr in zip(self.stores, host):
                    s.scatter(ids[live], hr[live])

    # ------------------------------------------------------------------
    # dispatch-loop side
    # ------------------------------------------------------------------

    def push_writeback(self, plan_id: int, rows: tuple,
                       event=None) -> None:
        """Hand over the rows gathered at a plan's evict slots: host
        arrays (per store, ``[>= n_evict, D]``), with the CUDA ``event``
        recorded after their non-blocking copy from the device (None when
        they are already in place).  Does not block."""
        with self._cv:
            entry = self._entries.get(plan_id)
            if entry is not None:
                entry["dev"] = rows
                entry["event"] = event
                self._cv.notify_all()

    def note_applied(self, shipment: Shipment) -> None:
        """Advance the applied view once a plan's loads hit the device."""
        if shipment.n_load == 0:
            return
        with self._cv:
            self.id_of_slot_applied[
                shipment.load_slots_h[:shipment.n_load]
            ] = shipment.load_ids

    def sync_from_device(self, host_tables: list) -> None:
        """Write every device-resident row back into the cold stores (the
        checkpoint and evaluation path).  ``host_tables`` are host copies
        of the CURRENT device hot tables, ordered like ``self.names``.
        Uses the applied view, so plans still in flight (whose evicted
        rows are still on the device) are swept correctly."""
        if not self.rows_enabled:
            raise RuntimeError(
                "sync_from_device on a mirror tier shard: only the owning "
                "rank holds this shard's cold stores"
            )
        with self._cv:
            self._flush_entries(force=True)
            slots = np.nonzero(self.id_of_slot_applied >= 0)[0]
            if len(slots):
                ids = self.id_of_slot_applied[slots]
                for s, t in zip(self.stores, host_tables):
                    s.scatter(ids, t[slots])

    def gather_logical(self, ids: np.ndarray) -> np.ndarray:
        """Current PARAMS rows for logical ids, from the cold store
        (callers sync the hot rows back first: the evaluation path)."""
        if not self.rows_enabled:
            raise RuntimeError(
                "gather_logical on a mirror tier shard: only the owning "
                "rank holds this shard's cold stores"
            )
        with self._cv:
            return self.stores[0].gather(ids)

    def merged_dense(self, host_tables: list) -> list:
        """Full logical arrays (params table first), cold and hot merged:
        copies taken under the lock, since the live cold backing keeps
        absorbing write-backs from the transfer thread."""
        self.sync_from_device(host_tables)
        with self._cv:
            return [s.to_dense().copy() for s in self.stores]

    def export_overlay(self, host_tables: list) -> dict:
        """Sparse-overlay checkpoint payload: virtual stores export their
        written rows under their init descriptor, dense-backed ones EVERY
        row under ``kind="dense"``."""
        self.sync_from_device(host_tables)
        with self._cv:
            out = {}
            for name, s in zip(self.names, self.stores):
                payload = s.export()
                if s.dense_backed:
                    payload["descriptor"] = {
                        "kind": "dense", **self.codec.descriptor()
                    }
                else:
                    payload["descriptor"] = s.descriptor
                out[name] = payload
            return out

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """Host-only counters for the run's result (no device access)."""
        with self._cv:
            total = self._hit_occ + self._miss_occ
            return {
                "hot_rows": self.hot_rows,
                "vocab": self.vocab,
                "resident_rows": int(self._free_ptr),
                "rows_seen": int(self._seen_rows),
                "hit_occurrences": int(self._hit_occ),
                "miss_occurrences": int(self._miss_occ),
                "hot_hit_frac": (
                    round(self._hit_occ / total, 6) if total else 0.0
                ),
                "rows_loaded": int(self._rows_loaded),
                "rows_evicted": int(self._rows_evicted),
                "writeback_rows": int(self._rows_written_back),
                "oor_occurrences": int(self._oor_occ),
                "cold_store_bytes": int(
                    sum(s.nbytes for s in self.stores)
                ),
                "cold_written_rows": int(
                    0 if not self.stores or self.stores[0].dense_backed
                    else self.stores[0].written_rows
                ),
                "cold_dtype": self.codec.dtype,
                "cold_bytes_per_row": int(self.codec.bytes_per_row),
            }

    def health_view(self) -> dict:
        """Logical-row occupancy (the device's row counts are hot
        slots)."""
        with self._cv:
            return {
                "emb_rows_touched": int(self._seen_rows),
                "emb_row_occupancy": round(self._seen_rows / self.vocab, 9),
                "hot_slots_resident": int(self._free_ptr),
            }
