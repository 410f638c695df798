"""The table-layout probe — the counterpart of ``tools/micro_probe.py``.

    python -m fast_tffm_tpu_torch.tools.micro_probe                # the GPU
    python -m fast_tffm_tpu_torch.tools.micro_probe --device cpu   # small

The reference asks which layout the table's gather and sparse apply
should use: ``[V, 9]``, transposed ``[9, V]`` or packed ``[V/8, 128]``
(8 rows of 16 slots).  Its question was a TPU one: there a ``[V, 9]``
f32 buffer pads to 128 lanes.  This probe asks it of the GPU, section by
section at the reference's shapes (V = 2^22, N = 16384 * 39 uniform ids,
B = 16384, F = 39; on the CPU the small shapes the reference runs in
interpret mode, V = 4096 and N = 2048): the device bytes of each layout,
the gather's rate by row width and index order, the packed and column
gathers, the layouts of the elementwise field sum, the ``[B, F, 9] ->
[B, 351]`` reshape, three forwards, the scatter-add, the two K2 layouts
against the production K2, the cumsum variants and the sort's scaling.
Every time is :func:`timing.bench`'s host clock, drained.  A failed launch
or a K2 parity error over the reference's bounds raises.

Kernels (``ops/csrc/layout_probe.cu``), each with the reference's
arguments (the two tables, ids ``[N]`` i32 in ``[0, V)``, per-occurrence
gradients ``[N, D]`` f32):

- :func:`k2t_apply` (replacing ``tools/micro_probe.py::_k2t_kernel``):
  sparse Adagrad on a transposed ``[D, V]`` table and accumulator;
- :func:`k2p_apply` (replacing ``_k2p_kernel``): the same on packed
  ``[V/8, 128]`` ones (:func:`pack_table`), ``D <= 16``, each starting
  on a 16-byte boundary.

Each runs K1 (``ops/sparse_apply``: ``sort_meta``, ``k1_dedup_cuda``)
and then its kernel on K1's stream (:func:`k2t_entries` /
:func:`k2p_entries`, the step alone).  It updates the two tables in
place and returns them, where the reference returns new arrays through
``input_output_aliases``.  It checks its inputs on every device, launches
its kernel on a CUDA tensor (or raises) and takes its plain version on a
CPU tensor; ``.launches`` counts kernel launches.  The plain versions
(:func:`k2t_apply_plain`, :func:`k2p_apply_plain`; ``plain=True`` on the
entries functions) run K1's plain version, then a gather, the update and
``index_copy_`` on the ``[V, D]`` view of the transposed or packed table,
on any device.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from fast_tffm_tpu_torch.ops import _build, fm_kernels, sparse_apply
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.tools.timing import bench

__all__ = [
    "k2p_apply", "k2p_apply_plain", "k2p_entries", "k2t_apply",
    "k2t_apply_plain", "k2t_entries", "main", "pack_table", "scores_flat",
    "unpack_table",
]

_INT32_MAX = 2**31 - 1
# The packed layout: 8 rows of 16 slots per 128-float line.
PACK_ROWS, PACK_SLOTS = 8, 16
PACK_LANES = PACK_ROWS * PACK_SLOTS
# The widest row K2T takes: a 32-entry tile's stage of 2D + 1 floats an
# entry must fit a block's 227 KB of shared memory.
K2T_MAX_D = 907
# The reference's K2 sections: Adagrad constants and its tile-vs-scatter
# bounds (tests/test_sparse_apply.py), which the layouts are held to.
LR, EPS = 0.05, 1e-7
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
ACC_TOL = dict(rtol=1e-4, atol=1e-4)
# (V, N, B, F): the reference's shapes on the card; on the CPU the small
# ones it runs in interpret mode, the forward's batch cut to match.
CARD_SHAPES = (1 << 22, 16384 * 39, 16384, 39)
CPU_SHAPES = (4096, 2048, 64, 39)
GATHER_WIDTHS = (9, 16, 32, 64, 128)
SCATTER_WIDTHS = (9, 128)


# ------------------------------------------------------------ table layouts


def pack_table(t: torch.Tensor, d: int) -> torch.Tensor:
    """``[V, d]`` -> packed ``[V/8, 128]`` (8 rows of 16 slots, zero
    pad); ``V % 8 == 0`` and ``d <= 16``."""
    v = t.shape[0]
    if t.dim() != 2 or t.shape[1] != d or not 1 <= d <= PACK_SLOTS \
            or v % PACK_ROWS:
        raise ValueError(
            f"pack_table takes [V, d] with V % {PACK_ROWS} == 0 and "
            f"1 <= d <= {PACK_SLOTS}, got {tuple(t.shape)} and d={d}"
        )
    pad = torch.zeros((v, PACK_SLOTS - d), dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], dim=1).reshape(v // PACK_ROWS, PACK_LANES)


def unpack_table(tp: torch.Tensor, d: int) -> torch.Tensor:
    """Packed ``[V/8, 128]`` -> its ``[V, d]`` rows (a view)."""
    return tp.reshape(tp.shape[0] * PACK_ROWS, PACK_SLOTS)[:, :d]


def _rows_view(layout: str, table: torch.Tensor, d: int) -> torch.Tensor:
    """The ``[V, D]`` view of a transposed or packed table."""
    return table.t() if layout == "k2t" else unpack_table(table, d)


# ------------------------------------------------------------------ checks


def _check_tables(name: str, table, acc, d: int) -> int:
    """Checks the two tables of ``name`` for rows of width ``d``; returns V."""
    if table.dtype != torch.float32 or acc.dtype != torch.float32:
        raise TypeError(
            f"{name} takes float32 tables, got {table.dtype} and {acc.dtype}"
        )
    if name == "k2t_apply":
        if table.dim() != 2 or table.shape[0] != d or table.shape[1] < 1:
            raise ValueError(
                f"{name} takes transposed tables [D, V] with D = {d}, got "
                f"{tuple(table.shape)}"
            )
        vocab = table.shape[1]
    else:
        if not 1 <= d <= PACK_SLOTS:
            raise ValueError(f"{name} takes D <= {PACK_SLOTS}, got D = {d}")
        if table.dim() != 2 or table.shape[1] != PACK_LANES \
                or table.shape[0] < 1:
            raise ValueError(
                f"{name} takes packed tables [V/8, {PACK_LANES}] (so V % "
                f"{PACK_ROWS} == 0), got {tuple(table.shape)}"
            )
        vocab = table.shape[0] * PACK_ROWS
    if acc.shape != table.shape:
        raise ValueError(
            f"{name} takes an accumulator shaped as its table, got "
            f"{tuple(acc.shape)} and {tuple(table.shape)}"
        )
    if vocab > _INT32_MAX + 1:
        raise ValueError(f"{name}: V = {vocab} exceeds int32 row ids")
    if name == "k2p_apply":
        _check_aligned(name, table=table, acc=acc)
    return vocab


def _check_aligned(name: str, **tensors) -> None:
    """K2P moves 16-byte chunks of its tables and its stream: each must
    start on a 16-byte boundary (a fresh tensor does; a view at an odd
    offset may not).  Checked on every device, before any launch."""
    for what, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(
                f"{name}: its {what} must start on a 16-byte boundary, got "
                f"address {t.data_ptr():#x}"
            )


def _check_same_device(name: str, tensors) -> None:
    dev = tensors[0].device
    if dev.type not in ("cuda", "cpu") or any(t.device != dev
                                              for t in tensors):
        raise ValueError(
            f"{name} takes CUDA (or CPU) tensors on one device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")


def _check_entries(name: str, urows, sums, table, acc) -> int:
    if urows.dtype != torch.int32 or sums.dtype != torch.float32:
        raise TypeError(
            f"{name} takes int32 urows and float32 sums, got {urows.dtype} "
            f"and {sums.dtype}"
        )
    u = urows.numel()
    if urows.dim() != 1 or sums.dim() != 2 or sums.shape[0] != u \
            or sums.shape[1] < 2 or sums.shape[1] % 2:
        raise ValueError(
            f"{name} takes urows [U] and sums [U, 2D], got "
            f"{tuple(urows.shape)} and {tuple(sums.shape)}"
        )
    d = sums.shape[1] // 2
    _check_tables(name, table, acc, d)
    if name == "k2p_apply":
        _check_aligned(name, sums=sums)
    _check_same_device(name, (urows, sums, table, acc))
    return d


def _check_apply(name: str, table, acc, ids, g_rows) -> None:
    if g_rows.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(
            f"{name} takes int32 ids and float32 g_rows, got {ids.dtype} "
            f"and {g_rows.dtype}"
        )
    if ids.dim() != 1 or g_rows.dim() != 2 \
            or g_rows.shape[0] != ids.numel() or g_rows.shape[1] < 1 \
            or g_rows.numel() > _INT32_MAX:
        raise ValueError(
            f"{name} takes ids [N] and g_rows [N, D], got "
            f"{tuple(ids.shape)} and {tuple(g_rows.shape)}"
        )
    vocab = _check_tables(name, table, acc, g_rows.shape[1])
    _check_same_device(name, (table, acc, ids, g_rows))
    if ids.numel():
        lo, hi = (int(x) for x in torch.aminmax(ids))
        if lo < 0 or hi >= vocab:
            raise ValueError(
                f"{name} takes ids in [0, {vocab}), got [{lo}, {hi}]"
            )


# ----------------------------------------------------------------- kernels


def _entries(layout: str, urows, sums, table, acc, lr: float, eps: float,
             plain: bool) -> None:
    name = f"{layout}_apply"
    d = _check_entries(name, urows, sums, table, acc)
    if plain or table.device.type == "cpu":
        sparse_apply.k2_apply_plain(
            "adagrad", urows, sums,
            (_rows_view(layout, table, d), _rows_view(layout, acc, d)),
            sparse_apply.Hyper(lr=lr, eps=eps),
        )
        return
    u = urows.numel()
    if u == 0:
        return
    if layout == "k2t" and d > K2T_MAX_D:
        raise ValueError(
            f"{name}'s kernel takes D <= {K2T_MAX_D} (its shared-memory "
            f"stage of the stream), got D = {d}"
        )
    lib = _build.load()
    extra = (table.shape[1],) if layout == "k2t" else ()  # K2T's V
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        sparse_apply._launch(
            name, getattr(lib, name), urows.data_ptr(), sums.data_ptr(),
            table.data_ptr(), acc.data_ptr(), u, d, *extra, lr, eps, stream,
        )
    _WRAPPERS[layout].launches += 1


def k2t_entries(urows, sums, table_t, acc_t, *, lr: float, eps: float,
                plain: bool = False) -> None:
    """K2T alone: Adagrad of K1's stream (``urows [U]`` i32, ascending,
    unique and in ``[0, V)``; ``sums [U, 2D]``) on a transposed table
    and accumulator ``[D, V]``, in place, on the current stream.  A CUDA
    tensor launches the kernel (counted in ``k2t_apply.launches``), for
    ``D <= K2T_MAX_D`` (907; a wider D raises); a CPU tensor, or
    ``plain=True``, takes the plain version at any D."""
    _entries("k2t", urows, sums, table_t, acc_t, lr, eps, plain)


def k2p_entries(urows, sums, table_p, acc_p, *, lr: float, eps: float,
                plain: bool = False) -> None:
    """K2P alone: as :func:`k2t_entries` on packed ``[V/8, 128]``
    tables (``D <= 16``; the pad slots keep their bits), counted in
    ``k2p_apply.launches``.  The kernel moves 16-byte chunks: the
    tables and ``sums`` must start on 16-byte boundaries, on any device
    (a misaligned one raises before any launch)."""
    _entries("k2p", urows, sums, table_p, acc_p, lr, eps, plain)


def _apply(layout: str, table, acc, ids, g_rows, lr: float, eps: float,
           plain: bool):
    _check_apply(f"{layout}_apply", table, acc, ids, g_rows)
    meta = sparse_apply.sort_meta(ids)
    k1 = sparse_apply.k1_dedup_plain if plain else sparse_apply.k1_dedup_cuda
    urows, sums = k1(g_rows, ids, meta.perm, meta.seg_start)
    _entries(layout, urows, sums, table, acc, lr, eps, plain)
    return table, acc


def k2t_apply(table_t, acc_t, ids, g_rows, *, lr: float, eps: float):
    """Sparse Adagrad on a transposed table ``table_t`` and accumulator
    ``acc_t`` ``[D, V]`` f32 from ids ``[N]`` i32 and their gradients
    ``[N, D]`` f32: K1, then K2T, whose kernel takes ``D <= K2T_MAX_D``
    (907).  Updates both in place and returns them (the reference returns
    new arrays)."""
    return _apply("k2t", table_t, acc_t, ids, g_rows, lr, eps, plain=False)


def k2p_apply(table_p, acc_p, ids, g_rows, *, lr: float, eps: float):
    """:func:`k2t_apply` on packed tables ``[V/8, 128]`` f32 (8 rows of
    16 slots, :func:`pack_table`), ``D <= 16``: K1, then K2P."""
    return _apply("k2p", table_p, acc_p, ids, g_rows, lr, eps, plain=False)


def k2t_apply_plain(table_t, acc_t, ids, g_rows, *, lr: float, eps: float):
    """Plain :func:`k2t_apply` (any device)."""
    return _apply("k2t", table_t, acc_t, ids, g_rows, lr, eps, plain=True)


def k2p_apply_plain(table_p, acc_p, ids, g_rows, *, lr: float, eps: float):
    """Plain :func:`k2p_apply` (any device)."""
    return _apply("k2p", table_p, acc_p, ids, g_rows, lr, eps, plain=True)


k2t_apply.launches = 0
k2p_apply.launches = 0
_WRAPPERS = {"k2t": k2t_apply, "k2p": k2p_apply}


# ----------------------------------------------------------------- forward


def scores_flat(rows: torch.Tensor, vals: torch.Tensor):
    """The flat-layout forward in plain PyTorch (the copy of
    ``fast_tffm_tpu/ops/interaction.py::_scores_flat``): ``[B, F*D]``
    elementwise, the per-slot field sums as one matmul with
    ``M[c, c % D] = 1``.  Returns ``(scores [B], s1 [B, D-1])``; full
    float32 when TF32 matmuls are off."""
    b, f, d = rows.shape
    rows2 = rows.reshape(b, f * d).float()
    y = rows2 * vals.float().repeat_interleave(d, dim=1)
    c = torch.arange(f * d, device=rows.device)
    m = (c[:, None] % d == torch.arange(d, device=rows.device)[None, :])
    m = m.float()
    s = y @ m
    s2 = (y * y) @ m
    s1 = s[:, 1:]
    return s[:, 0] + 0.5 * (s1 * s1 - s2[:, 1:]).sum(dim=-1), s1


# ------------------------------------------------------------------- probe


def _parity(name: str, table, acc, t_ref, a_ref):
    """``(table err, acc err)`` against the scatter reference; raises
    past the reference's bounds."""
    errs = (float((table - t_ref).abs().max()),
            float((acc - a_ref).abs().max()))
    torch.testing.assert_close(table, t_ref, **TABLE_TOL,
                               msg=f"{name} table vs index_add_ reference")
    torch.testing.assert_close(acc, a_ref, **ACC_TOL,
                               msg=f"{name} accumulator vs index_add_ "
                                   f"reference")
    return errs


def _device_bytes(dev, v: int) -> None:
    if dev.type != "cuda":
        print("  device bytes: not measured on the cpu", flush=True)
        return
    logical = v * 9 * 4
    for shape in ((v, 9), (9, v), (v // PACK_ROWS, PACK_LANES)):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        t = torch.zeros(shape, device=dev)
        used = torch.cuda.memory_allocated(dev) - base
        print(f"  {list(shape)} f32 table: {used} device bytes for "
              f"{logical} logical ([V,9]) bytes ({used / logical:.4f}x)",
              flush=True)
        del t


def _probe(dev, seed: int, v: int, n: int, b: int, f: int) -> None:
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    # ---- device bytes of each layout ---------------------------------
    _device_bytes(dev, v)

    # ---- gather: row width x index order ------------------------------
    ids_np = rng.integers(0, v, (n,)).astype(np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    ids_sorted = torch.from_numpy(np.sort(ids_np)).to(dev)

    def gather(tb, i):
        return tb.index_select(0, i)

    for d in GATHER_WIDTHS:
        tb = uniform((v, d), -1, 1)
        ms_r = bench(gather, tb, ids)
        ms_s = bench(gather, tb, ids_sorted)
        rate = n / (ms_r * 1e-3) / 1e6
        gbs = 2 * n * d * 4 / (ms_r * 1e-3) / 1e9  # rows read and written
        print(f"  gather [{v},{d:3d}] x {n}: random {ms_r:.4f} ms "
              f"({rate:.1f}M rows/s, {gbs:.1f} GB/s)  sorted {ms_s:.4f} ms",
              flush=True)
        del tb

    # Packed gather: 512-byte super-rows, then the 16-slot select, as
    # the reference; and the same table read as the [V, 16] rows it is.
    packed = uniform((v // PACK_ROWS, PACK_LANES), -1, 1)

    def packed_gather(tb, i):
        sup = tb.index_select(0, i >> 3).view(-1, PACK_ROWS, PACK_SLOTS)
        slot = (i & 7).long().view(-1, 1, 1).expand(-1, 1, PACK_SLOTS)
        return sup.gather(1, slot).view(-1, PACK_SLOTS)

    def packed_rows(tb, i):
        return tb.view(-1, PACK_SLOTS).index_select(0, i)

    ms_r, ms_s = bench(packed_gather, packed, ids), bench(packed_gather,
                                                          packed, ids_sorted)
    ms_rows = bench(packed_rows, packed, ids)
    print(f"  packed-gather [V/8,128]+select: random {ms_r:.4f} ms  sorted "
          f"{ms_s:.4f} ms  (as [V,16] rows: random {ms_rows:.4f} ms)",
          flush=True)
    del packed

    tb_t = uniform((9, v), -1, 1)
    ms_r = bench(lambda tb, i: tb.index_select(1, i), tb_t, ids)
    ms_s = bench(lambda tb, i: tb.index_select(1, i), tb_t, ids_sorted)
    print(f"  column-gather [9,V] x {n}: random {ms_r:.4f} ms  sorted "
          f"{ms_s:.4f} ms", flush=True)
    del tb_t

    # ---- layouts of the elementwise field sum --------------------------
    r3 = uniform((b, f, 9), -1, 1)
    vals2 = uniform((b, f), 0.1, 1.0)
    t_bfd = bench(lambda r, x: (r * x[..., None]).sum(dim=1), r3, vals2)
    rflat = uniform((b, f * 9), -1, 1)
    t_flat = bench(lambda r, x: (r * x.repeat_interleave(9, dim=1))
                   .view(-1, f, 9).sum(dim=1), rflat, vals2)
    t_flat_nosum = bench(lambda r, x: r * x.repeat_interleave(9, dim=1),
                         rflat, vals2)
    print(f"  elementwise+field-sum: [B,F,9] {t_bfd:.4f} ms   "
          f"[B,F*9]->view-sum {t_flat:.4f} ms   [B,F*9] mult-only "
          f"{t_flat_nosum:.4f} ms", flush=True)
    del rflat

    # ---- the reshape, and three forwards -------------------------------
    is_view = r3.reshape(b, f * 9).data_ptr() == r3.data_ptr()
    t_resh = bench(lambda r: r.reshape(b, f * 9) + 1.0, r3)
    t_noop = bench(lambda r: r + 1.0, r3)
    print(f"  reshape [B,F,9]->[B,{f * 9}] (+1): {t_resh:.4f} ms   (+1 alone "
          f"in 3-D: {t_noop:.4f} ms; the reshape is a view: {is_view})",
          flush=True)
    t_plain = bench(fm_kernels.fm_scores_plain, r3, vals2)
    t_flatf = bench(scores_flat, r3, vals2)
    s_ref, _ = fm_kernels.fm_scores_plain(r3, vals2)
    s_flat, _ = scores_flat(r3, vals2)
    err = float((s_ref - s_flat).abs().max())
    if dev.type == "cuda":
        t_kern = bench(fm_kernels.fm_scores_cuda, r3, vals2)
        s_kern, _ = fm_kernels.fm_scores_cuda(r3, vals2)
        err_k = float((s_ref - s_kern).abs().max())
    else:
        t_kern = err_k = float("nan")  # the kernel needs the card
    print(f"  fwd: plain {t_plain:.4f} ms   kernel {t_kern:.4f} ms (err "
          f"{err_k:.1e})   flat {t_flatf:.4f} ms (err {err:.1e})", flush=True)
    del r3, vals2

    # ---- scatter-add ----------------------------------------------------
    for d in SCATTER_WIDTHS:
        tb = torch.zeros((v, d), device=dev)
        g = uniform((n, d), -1, 1)
        ms_r = bench(lambda t, i, x: t.index_add_(0, i, x), tb, ids, g)
        ms_s = bench(lambda t, i, x: t.index_add_(0, i, x), tb, ids_sorted, g)
        print(f"  scatter-add (index_add_) [{v},{d:3d}]: random {ms_r:.4f} ms "
              f" sorted {ms_s:.4f} ms", flush=True)
        del tb, g

    # ---- K2 on three layouts --------------------------------------------
    _k2_section(dev, uniform, ids, v, n)

    # ---- cumsum variants ------------------------------------------------
    flags = torch.from_numpy(rng.integers(0, 2, (n,)).astype(np.int32)).to(dev)
    tri = torch.triu(torch.ones((128, 128), device=dev))

    def cumsum_blocked(x):
        # [N] -> [N/128, 128]: the prefix inside a row by a triangular
        # matmul (tri[k, c] = k <= c), the row offsets by a short cumsum.
        within = x.view(-1, 128).float() @ tri
        row_tot = within[:, -1]
        offs = torch.cumsum(row_tot, dim=0) - row_tot
        return (within + offs[:, None]).view(-1).to(torch.int32)

    t_cs = bench(lambda x: torch.cumsum(x, dim=0), flags)
    t_block = bench(cumsum_blocked, flags)
    exact = torch.equal(torch.cumsum(flags, dim=0).to(torch.int32),
                        cumsum_blocked(flags))
    print(f"  cumsum[{n}]: plain {t_cs:.4f} ms  blocked-matmul (f32, TF32 "
          f"off) {t_block:.4f} ms (exact={exact})", flush=True)

    # ---- sort scaling ---------------------------------------------------
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    for m in (n // 8, n // 2, n):
        sub = ids[:m]
        t_kv = bench(lambda i: torch.sort(i, stable=True), sub)
        packed64 = (sub.long() << 20) | iota[:m]
        t_pk = bench(torch.msort, packed64)
        t_1 = bench(torch.msort, sub)
        print(f"  sort n={m:7d}: stable (i32 key, index) {t_kv:.4f} ms   "
              f"packed-i64 keys {t_pk:.4f} ms   i32 keys only {t_1:.4f} ms",
              flush=True)


def _k2_section(dev, uniform, ids, v: int, n: int) -> None:
    """K2T and K2P against the production K2 (``sparse_apply.apply``),
    each held to the ``index_add_`` scatter update within the reference's
    bounds, then timed (K1 included, as the reference times them)."""
    d = 9
    gk = uniform((n, d), -1e-2, 1e-2)
    tbl = uniform((v, d), -0.1, 0.1)
    accv = torch.full((v, d), 0.1, device=dev)
    idl = ids.long()
    a_ref = accv.index_add(0, idl, gk * gk)
    t_ref = tbl.index_add(
        0, idl, -LR * gk * torch.rsqrt(a_ref.index_select(0, idl) + EPS))
    hyper = sparse_apply.Hyper(lr=LR, eps=EPS)

    def production(t, a, i, g):
        sparse_apply.apply("adagrad", (t, a), i, g, hyper)
        return t, a

    tk, ak = production(tbl.clone(), accv.clone(), ids, gk)
    err_k2 = _parity("K2", tk, ak, t_ref, a_ref)
    tt, at = k2t_apply(tbl.t().contiguous(), accv.t().contiguous(), ids, gk,
                       lr=LR, eps=EPS)
    err_t = _parity("K2T", tt.t(), at.t(), t_ref, a_ref)
    tp, ap = k2p_apply(pack_table(tbl, d), pack_table(accv, d), ids, gk,
                       lr=LR, eps=EPS)
    err_p = _parity("K2P", unpack_table(tp, d), unpack_table(ap, d), t_ref,
                    a_ref)
    pads = [int(torch.count_nonzero(x.view(-1, PACK_SLOTS)[:, d:]))
            for x in (tp, ap)]
    if any(pads):
        raise RuntimeError(f"K2P wrote {pads} pad slots (table, acc)")
    del t_ref, a_ref, idl
    ms_k2 = bench(production, tk, ak, ids, gk)
    ms_t = bench(functools.partial(k2t_apply, lr=LR, eps=EPS), tt, at, ids,
                 gk)
    ms_p = bench(functools.partial(k2p_apply, lr=LR, eps=EPS), tp, ap, ids,
                 gk)
    ms_k2b = bench(production, tk, ak, ids, gk)
    print(f"  K2 (K1 included) transposed [9,V]: {ms_t:.4f} ms (parity err "
          f"table {err_t[0]:.2e}, acc {err_t[1]:.2e})   packed [V/8,128]: "
          f"{ms_p:.4f} ms (err {err_p[0]:.2e}, {err_p[1]:.2e})   production "
          f"[V,9]: {ms_k2:.4f} / {ms_k2b:.4f} ms (err {err_k2[0]:.2e}, "
          f"{err_k2[1]:.2e}); V={v} n={n}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fast_tffm_tpu_torch.tools.micro_probe",
        description="Table-layout probe: gather, scatter, K2 layouts, "
                    "cumsum and sort on the GPU (or, small, the CPU).")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (small shapes)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    v, n, b, f = CARD_SHAPES if dev.type == "cuda" else CPU_SHAPES
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"micro_probe on {name} ({dev}): V={v} N={n} B={b} F={f}",
          flush=True)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _probe(dev, args.seed, v, n, b, f)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
