"""Rank-sharded tiered table — the counterpart of
``fast_tffm_tpu/train/tiered_fleet.py``.

``train.tiered.TieredTable`` is host-global: one process plans,
migrates and checkpoints the whole logical table.  Here the work is
partitioned by id range, so a fleet of ranks trains a table no single
host holds (the upstream system's parameter-server role):

- the logical id space splits into ``S = mesh_model`` contiguous ranges,
  one per model column of the rank mesh.  Shard ``s`` owns ids
  ``[s*V/S, (s+1)*V/S)`` and hot slots ``[s*H/S, (s+1)*H/S)``: exactly
  the hot-table rows rank ``s`` holds in the hand-sharded step
  (``train/shardmap_step.py``, built with ``vocabulary_size = H``).
  Each rank of the port is one process with one device, so a column
  belongs to one process only on a ``1 x R`` mesh (:func:`column_owners`
  refuses the rest);
- every rank runs a :class:`~fast_tffm_tpu_torch.train.tiered.TieredTable`
  for every shard over the same global batches (every rank parses the
  whole batch), so slot maps and LRU state advance in lockstep with no
  traffic between ranks.  Only the owned shards are full instances
  (cold stores, write-back ledger, row fetch); the others are metadata
  mirrors (``ShardSpec(rows_enabled=False)``);
- the trainer's migration (``train/loop.py::Trainer._apply_migration``)
  copies only the rank's own column blocks (:meth:`ShardedTiering.
  local_load_blocks`, :meth:`ShardedTiering.local_evict_slots`, shipped
  in the batch's one pinned copy by :class:`LocalPlan`) and uses no
  collective.

Checkpoints: each rank exports only its owned shards, ids made global,
one ``tiered.shard{s}of{S}.npz`` each (``train/checkpoint.py::
save_tiered_shards``).  Rows are keyed by global id and the init
descriptors do not depend on the offset, so a restore re-partitions the
union of the files across any shard count (:func:`filter_overlay_for_shard`,
:func:`slice_dense_for_shard`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.train.tiered import (
    Plan, ShardSpec, TieredTable, _bucket, opt_table_names,
)

__all__ = [
    "FleetPlan", "FleetShipment", "LocalPlan", "ShardedTiering",
    "column_owners", "filter_overlay_for_shard", "slice_dense_for_shard",
]


def column_owners(mesh) -> list:
    """The owning rank of each model column of the port's rank ``mesh``
    (``parallel/mesh.py::Mesh``: rank ``r`` at ``(r // model, r %
    model)``, one process each).  A column of more than one data row
    spans processes, so its hot rows would be replicated across ranks
    and no single rank could own its cold store: refused with the
    reference's ValueError."""
    if mesh.data > 1:
        procs = [i * mesh.model for i in range(mesh.data)]
        raise ValueError(
            f"fleet tiering: mesh model column 0 spans processes "
            f"{procs} — its hot rows would be replicated "
            "across ranks.  Use a mesh whose MODEL axis does not "
            "share columns across processes (canonically "
            "mesh_data=1, mesh_model=<process count>)."
        )
    return list(range(mesh.model))


def filter_overlay_for_shard(overlay: dict, index: int, count: int,
                             vocab: int) -> dict:
    """A global-id overlay (the union of a checkpoint's shard files, or
    one ``tiered.npz``) cut to one shard's id range, ids made local: the
    restore half of elastic re-sharding."""
    vs = vocab // count
    lo, hi = index * vs, (index + 1) * vs
    out = {}
    for name, payload in overlay.items():
        ids = np.asarray(payload["ids"], np.int64)
        m = (ids >= lo) & (ids < hi)
        out[name] = {
            "ids": ids[m] - lo,
            "rows": np.asarray(payload["rows"])[m],
            "descriptor": payload.get("descriptor"),
        }
    return out


def slice_dense_for_shard(dense_tables: dict, index: int, count: int) -> dict:
    """Global dense warm-start arrays cut to one shard's contiguous rows."""
    out = {}
    for name, arr in dense_tables.items():
        vs = arr.shape[0] // count
        out[name] = np.ascontiguousarray(arr[index * vs:(index + 1) * vs])
    return out


class FleetPlan(NamedTuple):
    """One super-batch's migration plan across all shards:
    ``shard_plans[s]`` is shard ``s``'s local-coordinate
    :class:`~fast_tffm_tpu_torch.train.tiered.Plan`; ``cap_load`` and
    ``cap_evict`` are the bucketed per-column capacities (largest over
    the shards) that every rank computes alike from its mirrors."""

    plan_id: int
    shard_plans: tuple
    cap_load: int
    cap_evict: int
    n_load_max: int
    n_evict_max: int


class FleetShipment(NamedTuple):
    """What the transfer stage hands the dispatch loop per super-batch
    under fleet tiering: the remapped super-batch and the device views
    of this rank's column blocks of the plan (column-local slots)."""

    batch: object  # data.prefetch.SuperBatch (remapped ids)
    load_slots: object  # device [n_owned * cap_load] i32, pad hs
    load_rows: tuple  # device per-store [n_owned * cap_load, D] f32
    evict_slots: object  # device [n_owned * cap_evict] i32, pad 0
    plan: FleetPlan

    @property
    def n(self) -> int:
        return self.batch.n


class LocalPlan(NamedTuple):
    """A :class:`FleetPlan` with this rank's column blocks, in the shape
    the transfer stage packs (``data/prefetch.py``'s ``plan_hook``):
    :meth:`leaves` ride the batch's pinned copy and :meth:`ship` wraps
    their device views."""

    plan: FleetPlan
    load_slots: np.ndarray
    load_rows: tuple
    evict_slots: np.ndarray

    def leaves(self) -> list:
        return ([("load_slots", self.load_slots)]
                + [(f"load_rows{i}", r) for i, r in enumerate(self.load_rows)]
                + [("evict_slots", self.evict_slots)])

    def ship(self, batch, views: dict) -> FleetShipment:
        return FleetShipment(
            batch=batch, load_slots=views["load_slots"],
            load_rows=tuple(views[f"load_rows{i}"]
                            for i in range(len(self.load_rows))),
            evict_slots=views["evict_slots"], plan=self.plan,
        )


class ShardedTiering:
    """Coordinator over ``num_shards`` shard-local :class:`TieredTable`
    instances, the ``owned`` ones full and the rest mirrors (module
    docstring), with the transfer-thread, dispatch-loop and checkpoint
    surface of the host-global manager.  ``device`` is where exact cold
    stores draw the dense trainer's seeded table."""

    def __init__(self, cfg: FmConfig, num_shards: int, owned,
                 telemetry=None, dense_tables: dict = None,
                 overlay: dict = None, device=None):
        if num_shards < 1:
            raise ValueError(f"num_shards={num_shards} must be >= 1")
        self.cfg = cfg
        self.num_shards = num_shards
        self.owned = frozenset(int(s) for s in owned)
        bad = [s for s in self.owned if not 0 <= s < num_shards]
        if bad:
            raise ValueError(
                f"owned shards {bad} outside [0, {num_shards})"
            )
        self.vocab = cfg.vocabulary_size
        self.hot_rows = min(cfg.hot_rows, cfg.vocabulary_size)
        if self.vocab % num_shards or self.hot_rows % num_shards:
            raise ValueError(
                f"vocabulary_size={self.vocab} and effective "
                f"hot_rows={self.hot_rows} must both divide by the tier "
                f"shard count {num_shards}"
            )
        self.vs = self.vocab // num_shards  # per-shard id span
        self.hs = self.hot_rows // num_shards  # per-shard hot slots
        self.dim = cfg.embedding_dim
        self.names = ("table",) + opt_table_names(cfg.optimizer)
        self._oor_occ = 0
        self.tables = []
        for s in range(num_shards):
            mine = s in self.owned
            self.tables.append(TieredTable(
                cfg,
                telemetry=telemetry if mine else None,
                dense_tables=(
                    slice_dense_for_shard(dense_tables, s, num_shards)
                    if mine and dense_tables is not None else None
                ),
                overlay=(
                    filter_overlay_for_shard(overlay, s, num_shards,
                                             self.vocab)
                    if mine and overlay is not None else None
                ),
                shard=ShardSpec(s, num_shards, rows_enabled=mine),
                device=device,
            ))
        self.codec = self.tables[0].codec

    # ------------------------------------------------------------------
    # transfer-thread side
    # ------------------------------------------------------------------

    def plan(self, ids: np.ndarray) -> tuple:
        """``(remapped ids, FleetPlan)``: a global super-batch's ids
        remapped to global hot slots through every shard's plan.  Every
        shard, owned or mirror, plans every super-batch (over zero ids
        too): the lockstep that keeps mirrors equal to their owners."""
        H = self.hot_rows
        flat = ids.reshape(-1).astype(np.int64)
        oor = (flat < 0) | (flat >= self.vocab)
        any_oor = bool(oor.any())
        if any_oor:
            self._oor_occ += int(oor.sum())
        owner = np.where(oor, 0, flat // self.vs)
        new_flat = np.empty(flat.shape, np.int32)
        if any_oor:
            new_flat[oor] = np.int32(H)  # the scatter-drop index
        plans = []
        n_load_max = n_evict_max = 0
        for s, t in enumerate(self.tables):
            m = (owner == s) & ~oor if any_oor else owner == s
            new_local, plan_s = t.plan(flat[m] - s * self.vs)
            new_flat[m] = new_local + np.int32(s * self.hs)
            plans.append(plan_s)
            n_load_max = max(n_load_max, plan_s.n_load)
            n_evict_max = max(n_evict_max, plan_s.n_evict)
        return new_flat.reshape(ids.shape), FleetPlan(
            plan_id=plans[0].plan_id,
            shard_plans=tuple(plans),
            cap_load=_bucket(max(1, n_load_max)),
            cap_evict=_bucket(max(1, n_evict_max)),
            n_load_max=n_load_max,
            n_evict_max=n_evict_max,
        )

    def local_load_blocks(self, plan: FleetPlan) -> tuple:
        """``(slots, rows)``: this rank's owned columns' load blocks in
        column order, ``cap_load`` entries each; slots column-local with
        the pad ``hs`` (the column's scatter-drop index), rows
        zero-padded."""
        cap = plan.cap_load
        slots = []
        rows = [[] for _ in self.names]
        for s in sorted(self.owned):
            p: Plan = plan.shard_plans[s]
            sl = np.full(cap, self.hs, np.int32)
            sl[:p.n_load] = p.load_slots[:p.n_load]
            slots.append(sl)
            for k, r in enumerate(p.load_rows):
                pr = np.zeros((cap, self.dim), np.float32)
                pr[:p.n_load] = r[:p.n_load]
                rows[k].append(pr)
        return (np.concatenate(slots),
                tuple(np.concatenate(rs) for rs in rows))

    def local_evict_slots(self, plan: FleetPlan) -> np.ndarray:
        """This rank's owned columns' evict-slot blocks, ``cap_evict``
        column-local entries each (pad 0: only the first ``n_evict`` of
        a block are read)."""
        cap = plan.cap_evict
        blocks = []
        for s in sorted(self.owned):
            p: Plan = plan.shard_plans[s]
            ev = np.zeros(cap, np.int32)
            ev[:p.n_evict] = p.evict_slots[:p.n_evict]
            blocks.append(ev)
        return np.concatenate(blocks)

    def local_plan(self, plan: FleetPlan) -> LocalPlan:
        """``plan`` with this rank's blocks, ready for the transfer
        stage."""
        slots, rows = self.local_load_blocks(plan)
        return LocalPlan(plan, slots, rows, self.local_evict_slots(plan))

    def cancel_waits(self) -> None:
        for t in self.tables:
            t.cancel_waits()

    def reopen(self) -> None:
        for t in self.tables:
            t.reopen()

    # ------------------------------------------------------------------
    # dispatch-loop side
    # ------------------------------------------------------------------

    def push_writeback(self, shard: int, plan_id: int, rows: tuple,
                       event=None) -> None:
        """Hand shard ``shard``'s evicted rows to its write-back ledger
        (see :meth:`TieredTable.push_writeback`)."""
        self.tables[shard].push_writeback(plan_id, rows, event)

    def note_applied(self, plan: FleetPlan) -> None:
        """Advance the owned shards' applied views once the plan's loads
        hit the device; mirrors keep none (no rank reads their rows)."""
        for s in self.owned:
            p: Plan = plan.shard_plans[s]
            if p.n_load:
                t = self.tables[s]
                with t._cv:
                    t.id_of_slot_applied[p.load_slots[:p.n_load]] = p.load_ids

    def sync_from_device(self, host_tables_by_shard: dict) -> None:
        """``host_tables_by_shard[s]``: host copies of shard ``s``'s
        device hot rows (this rank's columns), ordered like
        ``self.names``."""
        for s in sorted(self.owned):
            self.tables[s].sync_from_device(host_tables_by_shard[s])

    # ------------------------------------------------------------------
    # checkpoint / evaluation
    # ------------------------------------------------------------------

    def export_shard_overlays(self, host_tables_by_shard: dict) -> dict:
        """``{shard: overlay payload}`` for the owned shards, ids made
        global: one ``tiered.shard{s}of{S}.npz`` each."""
        out = {}
        for s in sorted(self.owned):
            ov = self.tables[s].export_overlay(host_tables_by_shard[s])
            for payload in ov.values():
                payload["ids"] = payload["ids"] + np.int64(s * self.vs)
            out[s] = ov
        return out

    def gather_logical(self, ids: np.ndarray) -> np.ndarray:
        """Current params rows of global ids; every shard they touch must
        be owned (fleet evaluation reads a checkpoint instead)."""
        flat = np.asarray(ids, np.int64)
        owner = flat // self.vs
        missing = sorted(set(np.unique(owner).tolist()) - set(self.owned))
        if missing:
            raise RuntimeError(
                f"gather_logical needs shards {missing} which live on "
                "other ranks; fleet-tiered evaluation reads a checkpoint, "
                "not live remote state"
            )
        out = np.empty((len(flat), self.dim), np.float32)
        for s in self.owned:
            m = owner == s
            if m.any():
                out[m] = self.tables[s].gather_logical(flat[m] - s * self.vs)
        return out

    def merged_dense(self, host_tables_by_shard: dict) -> list:
        """The full logical arrays (params table first); needs every
        shard owned."""
        if len(self.owned) != self.num_shards:
            raise RuntimeError(
                "merged_dense needs every shard's cold store; this rank "
                f"owns {sorted(self.owned)} of {self.num_shards}"
            )
        self.sync_from_device(host_tables_by_shard)
        parts = []
        for t in self.tables:
            with t._cv:
                parts.append([s.to_dense().copy() for s in t.stores])
        return [np.concatenate([p[k] for p in parts])
                for k in range(len(self.names))]

    @property
    def dense_save_ok(self) -> bool:
        """Only a rank owning every shard can write the merged dense
        checkpoint, and only when the stores allow it."""
        return len(self.owned) == self.num_shards and all(
            t.dense_save_ok for t in self.tables
        )

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    @property
    def stores(self) -> tuple:
        """Every cold store this rank holds (owned shards, in order)."""
        return tuple(
            s for sh in sorted(self.owned) for s in self.tables[sh].stores
        )

    def snapshot(self) -> dict:
        """This rank's tiered counters (its owned shards summed), in the
        host-global snapshot's keys plus ``num_shards`` and
        ``owned_shards``; ``hot_rows`` and ``vocab`` are the owned
        capacity and span."""
        snaps = [self.tables[s].snapshot() for s in sorted(self.owned)]
        hit = sum(s["hit_occurrences"] for s in snaps)
        miss = sum(s["miss_occurrences"] for s in snaps)
        total = hit + miss
        return {
            "hot_rows": self.hs * len(self.owned),
            "vocab": self.vs * len(self.owned),
            "resident_rows": sum(s["resident_rows"] for s in snaps),
            "rows_seen": sum(s["rows_seen"] for s in snaps),
            "hit_occurrences": hit,
            "miss_occurrences": miss,
            "hot_hit_frac": round(hit / total, 6) if total else 0.0,
            "rows_loaded": sum(s["rows_loaded"] for s in snaps),
            "rows_evicted": sum(s["rows_evicted"] for s in snaps),
            "writeback_rows": sum(s["writeback_rows"] for s in snaps),
            "oor_occurrences": int(self._oor_occ),
            "cold_store_bytes": sum(s["cold_store_bytes"] for s in snaps),
            "cold_written_rows": sum(s["cold_written_rows"] for s in snaps),
            "cold_dtype": self.codec.dtype,
            "cold_bytes_per_row": int(self.codec.bytes_per_row),
            "num_shards": self.num_shards,
            "owned_shards": len(self.owned),
        }

    def health_view(self) -> dict:
        views = [self.tables[s].health_view() for s in sorted(self.owned)]
        seen = sum(v["emb_rows_touched"] for v in views)
        vocab = self.vs * max(1, len(self.owned))
        return {
            "emb_rows_touched": int(seen),
            "emb_row_occupancy": round(seen / vocab, 9),
            "hot_slots_resident": sum(
                v["hot_slots_resident"] for v in views
            ),
        }
