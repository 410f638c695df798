"""Sparse optimizer apply over the rows a batch touched — the counterpart
of ``fast_tffm_tpu/ops/sparse_apply.py``.

Three steps per train step on one device:

1. **Prep** (:func:`sort_meta`, or the pipeline's host twin
   ``data.libsvm.host_sort_meta``): a stable sort of the flat ids gives
   ``perm`` (occurrence index per sorted position) and ``seg_start``
   (first sorted position of each unique id, then ``n``).  Both give the
   same arrays, so host and device prep give bitwise-equal updates.  The
   reference's ``tile_start``, ``lrow`` and CHUNK padding exist for its
   TPU kernels and have no counterpart here.
2. **K1** (:func:`k1_dedup_cuda`, replacing ``_k1_kernel``): per unique
   id, the sums of its occurrences' gradients and of their squares,
   ``sums [U, 2D]``, and the id itself, ``urows [U]`` (ascending).
3. **K2** (:func:`k2_apply_cuda`, replacing ``_k2_group_kernel`` /
   ``_k2_group_kernel_compact``): the optimizer formula applied in place
   to the table and its optimizer tables at those rows only.

K1 and K2 take ``seg_start`` cut to ``[U + 1]`` (the device sort's) or
the whole slot of ``n + 1`` entries the transfer stage ships, its tail
past the batch's U unique ids padded with ``n`` — the counterpart of the
reference's static ``_k1_dedup(..., n_out)``.  On the whole slot K1
writes ``n`` rows: the first U as on the cut slot, then row id ``-1``
(their sums left unwritten by the kernel, zero in the plain version),
and K2 skips a row ``-1``.  Every shape and grid then depends on ``n``
alone and no host value of U is read, which a CUDA graph of the train
step needs (``train/dispatch.py``).

The dense step (``train/dense.py``) builds its ``[V, D]`` table gradient
with :func:`dense_grad`: K1's merge mode over the batch's sort meta (the
whole slot too: K-place takes its trailing rows -1 as absent), then
K-place.

The sharded step (``train/shardmap_step.py``) exchanges those sums over
the data axis one of two ways (:func:`resolve_exchange`):

- **dense**: :func:`dense_delta` (K1, then **K-place**,
  :func:`kplace_cuda`, replacing ``_kplace_kernel``) expands the stream
  into a ``[vocab_local, 2D]`` delta that is summed over the data axis
  and applied to the whole shard by the elementwise
  :func:`adagrad_update` / :func:`ftrl_update` / :func:`sgd_update`;
- **entries**: :func:`unique_entries` pads each rank's stream to a
  static ``cap`` (:func:`entries_cap`), the streams are gathered, and
  :func:`merge_entries` sums them with K1's **merge mode**
  (:func:`k1_merge_cuda`) before K2.  The stream's rows (its id plane)
  depend on the ids alone: :func:`entries_rows` gives them from the
  sort, with no K1 launch, so the overlapped exchange gathers them a
  step ahead.

Semantics are the reference's (``train/sparse.py``): Adagrad adds every
occurrence's g² to the accumulator and shares the post-update
denominator between duplicates; FTRL applies one ``-sigma*w`` per row;
SGD is plain.  The kernels live in ``csrc/sparse_apply.cu``.  Each
wrapper checks its inputs on every device, launches its kernel on a
CUDA tensor (or raises) and takes its plain version on a CPU tensor;
``.launches`` counts kernel launches.  The plain versions
(:func:`k1_dedup_plain` / :func:`k1_merge_plain`: ``index_add_`` over
the segment index; :func:`k2_apply_plain`: gather, update,
``index_copy_``; :func:`kplace_plain`: zeros and ``index_copy_``) run
on any device, with no host sync; on the card only the tests and
``chip_smoke.py`` call them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fast_tffm_tpu_torch.data.libsvm import SortMeta
from fast_tffm_tpu_torch.ops import _build

__all__ = [
    "CHUNK", "K1_SHORT", "OPTIMIZERS", "TILE", "Hyper", "adagrad_update",
    "apply", "dedup_entries", "dense_delta", "dense_grad", "entries_cap",
    "entries_rows", "ftrl_solve",
    "ftrl_update", "k1_dedup_cuda", "k1_dedup_plain", "k1_error_bound",
    "k1_merge_cuda", "k1_merge_plain", "k2_apply_cuda", "k2_apply_plain",
    "kplace_cuda", "kplace_plain", "merge_entries", "resolve_exchange",
    "sgd_update", "sort_meta", "unique_entries",
]

# optimizer -> (code in csrc/sparse_apply.cu, number of tables updated)
_OPT = {"sgd": (0, 1), "adagrad": (1, 2), "ftrl": (2, 3)}
OPTIMIZERS = tuple(_OPT)
_INT32_MAX = 2**31 - 1
# The reference's block sizes (its defaults).  No kernel here tiles by
# them; they enter the port only through the reference's shape rules:
# the entries stream's capacity (entries_cap, hence which exchange
# "auto" picks) and the sharded step's vocabulary divisibility.
CHUNK = 512
TILE = 256
# The longest segment K1 sums with one thread; a longer one takes a
# warp (csrc/sparse_apply.cu::kShort, which must agree).
K1_SHORT = 16
# Widest row K-place takes: a tile of rows lives in 48 KB of shared
# memory (csrc/sparse_apply.cu::kplace).
_KPLACE_MAX_WIDTH = (48 * 1024 - 64) // 4


class Hyper(NamedTuple):
    """Optimizer constants: ``eps`` is Adagrad's, ``l1``/``l2``/``beta``
    FTRL's."""

    lr: float
    eps: float = 1e-7
    l1: float = 0.0
    l2: float = 0.0
    beta: float = 1.0


def sort_meta(ids: torch.Tensor, drop_from: Optional[int] = None) -> SortMeta:
    """Device prep: ``SortMeta(perm [n] i32, seg_start [U+1] i32)`` from
    a stable sort of the flat ids, on their device.  Reading the unique
    count synchronises with the device.

    ``drop_from``: the segment of the largest id is left out when that
    id is ``>= drop_from`` — the sharded step's sentinel row, whose
    occurrences (every off-shard one) no exchange applies.  K1 then
    never walks them: one warp would sum that segment alone."""
    flat = ids.reshape(-1)
    n = flat.numel()
    sidx, perm = torch.sort(flat, stable=True)
    cuts = torch.nonzero(sidx[1:] != sidx[:-1]).reshape(-1) + 1
    ends = torch.tensor([0, n] if n else [0], dtype=cuts.dtype,
                        device=flat.device)
    seg_start = torch.cat([ends[:1], cuts, ends[1:]])
    if drop_from is not None and n and int(sidx[-1]) >= drop_from:
        seg_start = seg_start[:-1]
    return SortMeta(perm.to(torch.int32), seg_start.to(torch.int32))


def ftrl_solve(z, n, lr, l1, l2, beta):
    """FTRL-proximal closed form (``fast_tffm_tpu/ops/sparse_apply.py::
    ftrl_solve``): the weight that ``(z, n)`` stand for."""
    denom = (beta + torch.sqrt(n)) / lr + l2
    return torch.where(
        torch.abs(z) <= l1, torch.zeros_like(z),
        -(z - torch.sign(z) * l1) / denom,
    )


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(
            f"{name} launch failed: "
            + _build.load().fm_kernels_error_string(err).decode()
        )


# ---------------------------------------------------------------- K1: dedup


def _check_k1(g_rows, ids, perm, seg_start, name="k1_dedup") -> None:
    if g_rows.dtype != torch.float32:
        raise TypeError(f"{name} takes a float32 payload, got {g_rows.dtype}")
    if any(t.dtype != torch.int32 for t in (ids, perm, seg_start)):
        raise TypeError(
            f"{name} takes int32 ids, perm and seg_start, got "
            f"{ids.dtype}, {perm.dtype} and {seg_start.dtype}"
        )
    n = ids.numel()
    if (g_rows.dim() != 2 or g_rows.shape[0] != n or g_rows.shape[1] < 1
            or ids.dim() != 1 or tuple(perm.shape) != (n,)
            or seg_start.dim() != 1 or not 1 <= seg_start.numel() <= n + 1
            or g_rows.numel() > _INT32_MAX):
        raise ValueError(
            f"{name} takes a payload [n, D], ids [n], perm [n] and "
            f"seg_start [U+1] with U <= n, got {tuple(g_rows.shape)}, "
            f"{tuple(ids.shape)}, {tuple(perm.shape)} and "
            f"{tuple(seg_start.shape)}"
        )
    dev = g_rows.device
    if dev.type not in ("cuda", "cpu") or any(
        t.device != dev for t in (ids, perm, seg_start)
    ):
        raise ValueError(
            f"{name} takes CUDA (or CPU) tensors on one device, got "
            f"{[str(t.device) for t in (g_rows, ids, perm, seg_start)]}"
        )
    if not all(t.is_contiguous() for t in (g_rows, ids, perm, seg_start)):
        raise ValueError(f"{name} takes contiguous tensors")


def _segment_sums(payload_sorted, ids, perm, seg_start):
    """``(urows [U] i32, sums [U, P])``: ``index_add_`` of a sorted
    payload ``[n, P]`` over each sorted occurrence's segment index.  The
    occurrences past ``seg_start[U]`` (a left-out sentinel segment) sum
    into a spare row, dropped after; an empty segment (on the whole
    slot, each one past the batch's unique ids) gets row -1 and zero
    sums.  No host sync, so a CUDA graph can hold it."""
    n, p = payload_sorted.shape
    u = seg_start.numel() - 1
    bounds = torch.cat([seg_start.long(), seg_start.new_full((1,), n).long()])
    seg = torch.repeat_interleave(
        torch.arange(u + 1, device=payload_sorted.device),
        bounds[1:] - bounds[:-1], output_size=n,
    )
    sums = torch.zeros((u + 1, p), dtype=payload_sorted.dtype,
                       device=payload_sorted.device)
    sums.index_add_(0, seg, payload_sorted)
    first = bounds[:-2].clamp(max=max(n - 1, 0))
    urows = torch.where(bounds[1:-1] > bounds[:-2],
                        ids.index_select(0, perm.long().index_select(0, first)),
                        -1)
    return urows.to(torch.int32), sums[:u]


def k1_dedup_plain(g_rows, ids, perm, seg_start):
    """Plain K1 (any device): ``(urows [U] i32, sums [U, 2D])`` by
    ``index_add_`` of the sorted ``[g | g²]`` payload over each sorted
    occurrence's segment index; ``sums`` in ``g_rows``' dtype (the
    kernel's checks run it in float64 as their reference).  On the whole
    ``[n + 1]`` slot: ``[n]`` rows, row -1 and zero sums past U."""
    g_sorted = g_rows.index_select(0, perm.long())
    return _segment_sums(torch.cat([g_sorted, g_sorted * g_sorted], dim=1),
                         ids, perm, seg_start)


def k1_merge_plain(payload, ids, perm, seg_start):
    """Plain K1 merge mode (any device): :func:`k1_dedup_plain` without
    the square, ``(urows [U] i32, sums [U, P])`` of a ``[n, P]``
    payload taken as it is."""
    return _segment_sums(payload.index_select(0, perm.long()), ids, perm,
                         seg_start)


def k1_error_bound(seg_start, mass):
    """Largest ``|K1 - exact|`` the kernel's order of summation allows
    for each segment, each rounding off by at most ``2^-24`` of the
    segment's mass (the sum of the absolute terms, ``[U, 2D]``, e.g.
    :func:`k1_dedup_plain` of ``|g|`` in float64); 1.01 covers the
    second-order terms.  A segment of at most :data:`K1_SHORT`
    occurrences is summed by one thread in sorted order: ``count - 1``
    roundings of the sum and one of ``g*g``.  A longer one is summed by
    a warp: a lane adds its ``ceil(count / 32)`` terms in turn, five
    shuffle levels join the lanes and ``g*g`` is rounded once."""
    counts = (seg_start[1:] - seg_start[:-1]).double()[:, None]
    roundings = torch.where(counts <= K1_SHORT, counts,
                            torch.ceil(counts / 32) + 6)
    return roundings * 2.0**-24 * 1.01 * mass


def _k1_launch(entry: str, width: int, payload, ids, perm, seg_start):
    u = seg_start.numel() - 1  # n on the whole slot
    p = payload.shape[1]
    urows = torch.empty((u,), dtype=torch.int32, device=payload.device)
    sums = torch.empty((u, width * p), dtype=torch.float32,
                       device=payload.device)
    if u == 0:
        return urows, sums, False
    lib = _build.load()
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream(payload.device).cuda_stream
        _launch(entry, getattr(lib, entry), payload.data_ptr(),
                ids.data_ptr(), perm.data_ptr(), seg_start.data_ptr(),
                urows.data_ptr(), sums.data_ptr(), u, p, stream)
    return urows, sums, True


def k1_dedup_cuda(g_rows, ids, perm, seg_start):
    """K1 through the CUDA kernel (a thread per short segment, a warp
    per long one, no float atomics), on the current stream; CPU tensors
    take :func:`k1_dedup_plain`.  Returns ``(urows [U] i32, sums [U,
    2D])``, U being ``seg_start.numel() - 1`` (``n`` on the whole slot:
    rows past the batch's unique ids are -1, their sums unwritten)."""
    _check_k1(g_rows, ids, perm, seg_start)
    if g_rows.device.type == "cpu":
        return k1_dedup_plain(g_rows, ids, perm, seg_start)
    urows, sums, launched = _k1_launch("k1_dedup", 2, g_rows, ids, perm,
                                       seg_start)
    k1_dedup_cuda.launches += launched
    return urows, sums


k1_dedup_cuda.launches = 0


def k1_merge_cuda(payload, ids, perm, seg_start):
    """K1's merge mode through the CUDA kernel: the segment sums of a
    ``[n, P]`` payload taken as it is (the entries exchange's gathered
    ``[sum g | sum g²]`` streams), on the current stream; CPU tensors
    take :func:`k1_merge_plain`.  Returns ``(urows [U] i32, sums [U, P])``."""
    _check_k1(payload, ids, perm, seg_start, "k1_merge")
    if payload.device.type == "cpu":
        return k1_merge_plain(payload, ids, perm, seg_start)
    urows, sums, launched = _k1_launch("k1_merge", 1, payload, ids, perm,
                                       seg_start)
    k1_merge_cuda.launches += launched
    return urows, sums


k1_merge_cuda.launches = 0


# ---------------------------------------------------------------- K2: apply


def _check_k2(optimizer, urows, sums, tables) -> None:
    if optimizer not in _OPT:
        raise ValueError(
            f"k2_apply takes optimizer in {OPTIMIZERS}, got {optimizer!r}"
        )
    want = _OPT[optimizer][1]
    if len(tables) != want:
        raise ValueError(
            f"k2_apply with {optimizer} updates {want} table(s), got "
            f"{len(tables)}"
        )
    if urows.dtype != torch.int32 or sums.dtype != torch.float32 or any(
        t.dtype != torch.float32 for t in tables
    ):
        raise TypeError(
            "k2_apply takes int32 urows and float32 sums and tables, got "
            f"{urows.dtype}, {sums.dtype} and {[t.dtype for t in tables]}"
        )
    v, d = tables[0].shape if tables[0].dim() == 2 else (0, 0)
    u = urows.numel()
    if (d < 1 or urows.dim() != 1 or tuple(sums.shape) != (u, 2 * d)
            or any(tuple(t.shape) != (v, d) for t in tables)):
        raise ValueError(
            f"k2_apply takes urows [U], sums [U, 2D] and tables [V, D], "
            f"got {tuple(urows.shape)}, {tuple(sums.shape)} and "
            f"{[tuple(t.shape) for t in tables]}"
        )
    dev = tables[0].device
    if dev.type not in ("cuda", "cpu") or any(
        t.device != dev for t in (urows, sums, *tables)
    ):
        raise ValueError(
            "k2_apply takes CUDA (or CPU) tensors on one device, got "
            f"{[str(t.device) for t in (urows, sums, *tables)]}"
        )
    if not all(t.is_contiguous() for t in (urows, sums, *tables)):
        raise ValueError("k2_apply takes contiguous tensors")


def k2_apply_plain(optimizer: str, urows, sums, tables, hyper: Hyper) -> None:
    """Plain K2 (any device): gather the touched rows, apply the
    optimizer formula, ``index_copy_`` them back into ``tables`` (the
    table first, then Adagrad's accumulator or FTRL's ``z`` and ``n``).
    A row ``-1`` (the whole slot's, past the unique ids) stands in for a
    copy of the stream's first entry, so ``index_copy_`` writes that
    row's one new value again and no other row, with no host sync."""
    src = torch.where(urows >= 0,
                      torch.arange(urows.numel(), device=urows.device), 0)
    idx = urows.long().index_select(0, src)
    sums = sums.index_select(0, src)
    d = tables[0].shape[1]
    g1, g2 = sums[:, :d], sums[:, d:]
    w = tables[0].index_select(0, idx)
    lr = hyper.lr
    if optimizer == "sgd":
        new = (w - lr * g1,)
    elif optimizer == "adagrad":
        acc = tables[1].index_select(0, idx) + g2
        new = (w - lr * g1 * torch.rsqrt(acc + hyper.eps), acc)
    else:
        z = tables[1].index_select(0, idx)
        n = tables[2].index_select(0, idx)
        n_new = n + g2
        sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
        z_new = z + g1 - sigma * w
        new = (ftrl_solve(z_new, n_new, lr, hyper.l1, hyper.l2, hyper.beta),
               z_new, n_new)
    for table, rows in zip(tables, new):
        table.index_copy_(0, idx, rows)


def k2_apply_cuda(optimizer: str, urows, sums, tables, hyper: Hyper) -> None:
    """K2 through the CUDA kernel (a group of lanes per touched row, in
    place; a row ``-1`` skipped), on the current stream; CPU tensors
    take :func:`k2_apply_plain`."""
    tables = tuple(tables)
    _check_k2(optimizer, urows, sums, tables)
    if tables[0].device.type == "cpu":
        k2_apply_plain(optimizer, urows, sums, tables, hyper)
        return
    u = urows.numel()
    if u == 0:
        return
    code = _OPT[optimizer][0]
    state = [t.data_ptr() for t in tables[1:]] + [None] * (3 - len(tables))
    if optimizer == "adagrad":
        params = (hyper.eps, 0.0, 0.0)
    else:
        params = (hyper.l1, hyper.l2, hyper.beta)
    lib = _build.load()
    dev = tables[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("k2_apply", lib.k2_apply, code, urows.data_ptr(),
                sums.data_ptr(), tables[0].data_ptr(), state[0], state[1],
                u, tables[0].shape[1], hyper.lr, *params, stream)
    k2_apply_cuda.launches += 1


k2_apply_cuda.launches = 0


# ----------------------------------------------- K-place: dense expansion


def _check_kplace(urows, sums, row_lo, vocab_local) -> None:
    if urows.dtype != torch.int32 or sums.dtype != torch.float32:
        raise TypeError(
            f"kplace takes int32 urows and float32 sums, got {urows.dtype} "
            f"and {sums.dtype}"
        )
    u = urows.numel()
    if (urows.dim() != 1 or sums.dim() != 2 or sums.shape[0] != u
            or not 1 <= sums.shape[1] <= _KPLACE_MAX_WIDTH):
        raise ValueError(
            f"kplace takes urows [U] and sums [U, W] with 1 <= W <= "
            f"{_KPLACE_MAX_WIDTH}, got {tuple(urows.shape)} and "
            f"{tuple(sums.shape)}"
        )
    if row_lo < 0 or vocab_local < 1 or row_lo + vocab_local > 2**31:
        raise ValueError(
            f"kplace takes 0 <= row_lo, 1 <= vocab_local and row_lo + "
            f"vocab_local <= 2^31, got {row_lo} and {vocab_local}"
        )
    dev = sums.device
    if dev.type not in ("cuda", "cpu") or urows.device != dev:
        raise ValueError(
            f"kplace takes CUDA (or CPU) tensors on one device, got "
            f"{urows.device} and {sums.device}"
        )
    if not (urows.is_contiguous() and sums.is_contiguous()):
        raise ValueError("kplace takes contiguous tensors")


def kplace_plain(urows, sums, row_lo: int, vocab_local: int):
    """Plain K-place (any device): ``delta [vocab_local, W]``, zeros
    with ``sums[u]`` copied to row ``urows[u] - row_lo`` for every entry
    in ``[row_lo, row_lo + vocab_local)`` (a row -1 never is)."""
    # Entries outside the shard go to a spare last row, dropped after:
    # no boolean indexing, so no host sync (a CUDA graph can hold it).
    idx = urows.long() - row_lo
    idx = torch.where((idx >= 0) & (idx < vocab_local), idx, vocab_local)
    delta = torch.zeros((vocab_local + 1, sums.shape[1]), dtype=sums.dtype,
                        device=sums.device)
    delta.index_copy_(0, idx, sums)
    return delta[:vocab_local]


def kplace_cuda(urows, sums, row_lo: int, vocab_local: int):
    """K-place through the CUDA kernel (a block per tile of output rows,
    entries found by binary search in the ascending ``urows``, each
    output byte written once), on the current stream; CPU tensors take
    :func:`kplace_plain`.  ``urows`` must be ascending and unique, as K1
    emits them, but for a trailing run of rows -1 (K1's on the whole
    slot, past the batch's unique ids), which are absent: their sums are
    never read.  Returns ``delta [vocab_local, W]`` f32."""
    _check_kplace(urows, sums, row_lo, vocab_local)
    if sums.device.type == "cpu":
        return kplace_plain(urows, sums, row_lo, vocab_local)
    w = sums.shape[1]
    delta = torch.empty((vocab_local, w), dtype=torch.float32,
                        device=sums.device)
    lib = _build.load()
    with torch.cuda.device(sums.device):
        stream = torch.cuda.current_stream(sums.device).cuda_stream
        _launch("kplace", lib.kplace, urows.data_ptr(), sums.data_ptr(),
                urows.numel(), row_lo, vocab_local, w, delta.data_ptr(),
                stream)
    kplace_cuda.launches += 1
    return delta


kplace_cuda.launches = 0


# ------------------------------------------ elementwise updates (dense)


def adagrad_update(g1, g2, table, acc, *, lr, eps) -> None:
    """Adagrad from dense per-row sums, in place over the whole shard:
    ``acc += g2; table -= lr * g1 * rsqrt(acc + eps)`` (the reference's
    ``adagrad_update``, which returns new arrays instead)."""
    acc.add_(g2)
    table.sub_(lr * g1 * torch.rsqrt(acc + eps))


def ftrl_update(g1, g2, table, z, n, *, lr, l1, l2, beta) -> None:
    """FTRL-proximal from dense per-row sums, in place (the reference's
    ``ftrl_update``): untouched rows are recomputed as
    ``ftrl_solve(z, n)``, which the stored weight already is."""
    n_new = n + g2
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z.add_(g1).sub_(sigma * table)
    n.copy_(n_new)
    table.copy_(ftrl_solve(z, n, lr, l1, l2, beta))


def sgd_update(g1, g2, table, *, lr) -> None:
    """SGD from dense per-row sums, in place: ``table -= lr * g1``."""
    del g2
    table.sub_(lr * g1)


# ------------------------------------------- exchanges (the sharded step)


def resolve_exchange(mode: str, *, n_local_occ: int, vocab_local: int,
                     d: int, data_shards: int) -> str:
    """Resolve a ``sparse_exchange`` value for static shapes, as the
    reference does: "auto" picks whichever moves fewer words per rank
    over a ring — the entries all-gather, ``data_shards * cap * (2D+1)``,
    or the dense all-reduce at twice its buffer, ``2 * vocab_local *
    2D`` — and "entries" when there is one data shard (nothing to
    exchange; the plain K1 + K2 apply is the least work)."""
    if mode != "auto":
        return mode
    if data_shards == 1:
        return "entries"
    cap = entries_cap(n_local_occ, vocab_local)
    entries_words = data_shards * cap * (2 * d + 1)
    dense_words = 2 * vocab_local * 2 * d
    return "entries" if entries_words < dense_words else "dense"


def entries_cap(n_occurrences: int, vocab: int) -> int:
    """Static per-rank entry-stream capacity: the touched rows cannot
    outnumber the occurrences or the vocabulary, each rounded up to the
    reference's CHUNK so the port resolves the same exchange."""
    n_pad = -(-n_occurrences // CHUNK) * CHUNK
    return min(n_pad, -(-vocab // CHUNK) * CHUNK)


def dedup_entries(ids, g_rows, *, vocab: int):
    """``(urows [U] i32, sums [U, 2D])``: K1 over local ids ``[n]`` and
    their row gradients ``[n, D]``, the sentinel ``vocab`` (every
    off-shard occurrence) left out."""
    ids = ids.reshape(-1).to(torch.int32).contiguous()
    meta = sort_meta(ids, drop_from=vocab)
    return k1_dedup_cuda(g_rows.contiguous(), ids, meta.perm, meta.seg_start)


def unique_entries(ids, g_rows, *, vocab: int, cap: int):
    """Deduped touched-row stream of local ids ``[n]`` (off-shard
    occurrences carry the sentinel ``vocab``) and their row gradients
    ``[n, D]``: ``(rows [cap] i32, pay [cap, 2D] f32, count)``, rows
    ascending, padded with ``row = vocab`` and a zero payload, ``count``
    the real rows (a device scalar)."""
    n, d = g_rows.shape
    n_pad = -(-n // CHUNK) * CHUNK
    if cap > n_pad:
        raise ValueError(f"cap={cap} exceeds padded occurrences {n_pad}")
    urows, sums = dedup_entries(ids, g_rows, vocab=vocab)
    u = urows.numel()  # at most cap (entries_cap): the sentinel is out
    rows = torch.full((cap,), vocab, dtype=torch.int32, device=ids.device)
    rows[:u] = urows
    pay = torch.zeros((cap, 2 * d), dtype=torch.float32, device=ids.device)
    pay[:u] = sums
    return rows, pay, torch.tensor(u, device=ids.device)


def entries_rows(ids, *, vocab: int, cap: int):
    """The id plane of :func:`unique_entries`: its ``rows [cap]`` i32
    (the unique local ids ascending, the sentinel ``vocab`` left out,
    padded with ``vocab``), taken from the sort meta with no payload and
    no K1 launch: each unique id is the id at its segment's first sorted
    position, the row K1 writes (the reference's
    ``make_entries_prefetch`` runs ``unique_entries`` on zero payloads
    for the same rows)."""
    ids = ids.reshape(-1).to(torch.int32).contiguous()
    n_pad = -(-ids.numel() // CHUNK) * CHUNK
    if cap > n_pad:
        raise ValueError(f"cap={cap} exceeds padded occurrences {n_pad}")
    meta = sort_meta(ids, drop_from=vocab)
    u = meta.seg_start.numel() - 1
    first = meta.perm.long().index_select(0, meta.seg_start[:u].long())
    rows = torch.full((cap,), vocab, dtype=torch.int32, device=ids.device)
    rows[:u] = ids.index_select(0, first)
    return rows


def merge_entries(rows, pay, *, vocab: int):
    """Merge gathered entry streams (each deduped, so a row appears at
    most once per rank) into one K2-ready stream ``(urows [U] i32, sums
    [U, 2D])``: a stable sort of the rows, the sentinel row's padding
    left out, K1's merge mode over the payloads (already ``[sum g |
    sum g²]``).  The totals are the dense exchange's."""
    rows = rows.reshape(-1).to(torch.int32).contiguous()
    meta = sort_meta(rows, drop_from=vocab)
    return k1_merge_cuda(pay.contiguous(), rows, meta.perm, meta.seg_start)


def dense_delta(ids, g_rows, *, vocab_local: int, row_lo: int):
    """Per-shard dense ``(sum g, sum g²)`` delta ``[vocab_local, 2D]``
    of ids ``[n]`` and their row gradients ``[n, D]``: K1, then K-place.
    Only ids in ``[row_lo, row_lo + vocab_local)`` contribute."""
    ids = ids.reshape(-1).to(torch.int32).contiguous()
    meta = sort_meta(ids, drop_from=row_lo + vocab_local)
    urows, sums = k1_dedup_cuda(g_rows.contiguous(), ids, meta.perm,
                                meta.seg_start)
    return kplace_cuda(urows, sums, row_lo, vocab_local)


def dense_grad(ids, g_rows, vocab: int, meta: Optional[SortMeta] = None,
               plain: bool = False):
    """The dense gradient ``[vocab, D]`` of per-occurrence row gradients
    ``g_rows [n, D]`` at the flat ids ``ids [n]`` (the transpose of the
    gather): K1's merge mode sums each id's occurrences in sorted order,
    then K-place writes the sums into rows of zeros.  ``meta`` is the
    host prep for these ids (its ``seg_start`` cut or the whole slot);
    None sorts on the device.  No float atomics, so the result is
    deterministic.  ``plain=True`` runs the plain versions on any
    device."""
    ids = ids.reshape(-1).to(torch.int32).contiguous()
    if meta is None:
        meta = sort_meta(ids)
    k1 = k1_merge_plain if plain else k1_merge_cuda
    place = kplace_plain if plain else kplace_cuda
    urows, sums = k1(g_rows.contiguous(), ids, meta.perm, meta.seg_start)
    return place(urows, sums, 0, vocab)


# ------------------------------------------------------------ orchestration


def apply(optimizer: str, tables, ids: torch.Tensor, g_rows: torch.Tensor,
          hyper: Hyper, meta: Optional[SortMeta] = None,
          plain: bool = False) -> None:
    """Sparse update of ``tables`` (see :func:`k2_apply_plain` for their
    order) from per-occurrence row gradients ``g_rows [n, D]`` of the
    flat ids ``ids [n]``, in place.  ``meta`` is the host prep for these
    ids (moved to their device), its ``seg_start`` cut or the whole
    slot; None sorts on the device.  ``plain=True`` runs the plain
    versions on any device."""
    ids = ids.reshape(-1).to(torch.int32).contiguous()
    if meta is None:
        meta = sort_meta(ids)
    k1 = k1_dedup_plain if plain else k1_dedup_cuda
    k2 = k2_apply_plain if plain else k2_apply_cuda
    urows, sums = k1(g_rows.contiguous(), ids, meta.perm, meta.seg_start)
    k2(optimizer, urows, sums, tuple(tables), hyper)
