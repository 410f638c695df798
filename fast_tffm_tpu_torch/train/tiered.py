"""The tiered table's host cold store: the serving subset.

The counterpart of the serving half of ``fast_tffm_tpu/train/tiered.py``:
what a ``tiered.npz`` sparse-overlay checkpoint needs to be read and
scored (``serve/scorer.py::OverlayScorer``).  The full logical
``[vocab, dim]`` table of a tiered run lives on the host as a
:class:`ColdStore`:

- dense-backed: one real array; gather/scatter are fancy indexing;
- virtual (vocabularies too large to hold densely): every row not
  written is computed on demand from a deterministic per-row hash init
  (:func:`_hash_uniform`, splitmix64 in numpy ``uint64``, bitwise the
  reference's), and a sorted overlay holds every row ever written, so
  host memory scales with the rows written, not with V.

Rows are stored packed through an :class:`ops.quant.RowCodec`
(``cold_dtype``): fp32 is the identity, bf16 and int8 store compact rows
encoded on every write and decoded on every read.

The tiered trainer (``TieredTable``: its plan, fetch, migration and
write-back, and ``_exact_stores``, which draws the reference's JAX init)
is not here yet (ROADMAP.md, port queue item 2).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.ops import quant

__all__ = ["ColdStore", "EXACT_BYTES_MAX"]

# Cold arrays at or below this byte size are materialized exactly (the
# reference draws them with the dense path's JAX init); larger stores use
# the virtual row-hash init with a sparse written-row overlay.  A dense
# table of more bytes is refused by ColdStore.to_dense.
EXACT_BYTES_MAX = 1 << 28


def _bucket(n: int, lo: int = 8) -> int:
    """Round up to a power of two >= lo: the overlay scorer pads its
    compact table to these row counts, so it stages O(log) shapes."""
    b = lo
    while b < n:
        b <<= 1
    return b


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
