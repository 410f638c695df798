"""Sparse optimizer apply over the rows a batch touched — the counterpart
of ``fast_tffm_tpu/ops/sparse_apply.py`` (single device).

Three steps per train step:

1. **Prep** (:func:`sort_meta`, or the pipeline's host twin
   ``data.libsvm.host_sort_meta``): a stable sort of the flat ids gives
   ``perm`` (occurrence index per sorted position) and ``seg_start``
   (first sorted position of each unique id, then ``n``).  Both give the
   same arrays, so host and device prep give bitwise-equal updates.  The
   reference's ``tile_start``, ``lrow`` and CHUNK padding exist for its
   TPU kernels and have no counterpart here.
2. **K1** (:func:`k1_dedup_cuda`, replacing ``_k1_kernel``): per unique
   id, the sums of its occurrences' gradients and of their squares,
   ``sums [U, 2D]``, and the id itself, ``urows [U]``.
3. **K2** (:func:`k2_apply_cuda`, replacing ``_k2_group_kernel`` /
   ``_k2_group_kernel_compact``): the optimizer formula applied in place
   to the table and its optimizer tables at those rows only.

Semantics are the reference's (``train/sparse.py``): Adagrad adds every
occurrence's g² to the accumulator and shares the post-update
denominator between duplicates; FTRL applies one ``-sigma*w`` per row;
SGD is plain.  The kernels live in ``csrc/sparse_apply.cu``.  Each
wrapper checks its inputs on every device, launches its kernel on a
CUDA tensor (or raises) and takes its plain version on a CPU tensor;
``.launches`` counts kernel launches.  The plain versions
(:func:`k1_dedup_plain`: ``index_add_`` over the segment index;
:func:`k2_apply_plain`: gather, update, ``index_copy_``) run on any
device; on the card only the tests and ``chip_smoke.py`` call them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fast_tffm_tpu_torch.data.libsvm import SortMeta
from fast_tffm_tpu_torch.ops import _build

__all__ = [
    "OPTIMIZERS", "Hyper", "apply", "ftrl_solve", "k1_dedup_cuda",
    "k1_dedup_plain", "k1_error_bound", "k2_apply_cuda", "k2_apply_plain",
    "sort_meta",
]

# optimizer -> (code in csrc/sparse_apply.cu, number of tables updated)
_OPT = {"sgd": (0, 1), "adagrad": (1, 2), "ftrl": (2, 3)}
OPTIMIZERS = tuple(_OPT)
_INT32_MAX = 2**31 - 1


class Hyper(NamedTuple):
    """Optimizer constants: ``eps`` is Adagrad's, ``l1``/``l2``/``beta``
    FTRL's."""

    lr: float
    eps: float = 1e-7
    l1: float = 0.0
    l2: float = 0.0
    beta: float = 1.0


def sort_meta(ids: torch.Tensor) -> SortMeta:
    """Device prep: ``SortMeta(perm [n] i32, seg_start [U+1] i32)`` from
    a stable sort of the flat ids, on their device.  Reading the unique
    count synchronises with the device."""
    flat = ids.reshape(-1)
    n = flat.numel()
    sidx, perm = torch.sort(flat, stable=True)
    cuts = torch.nonzero(sidx[1:] != sidx[:-1]).reshape(-1) + 1
    ends = torch.tensor([0, n] if n else [0], dtype=cuts.dtype,
                        device=flat.device)
    seg_start = torch.cat([ends[:1], cuts, ends[1:]])
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


def _check_k1(g_rows, ids, perm, seg_start) -> None:
    if g_rows.dtype != torch.float32:
        raise TypeError(f"k1_dedup takes float32 g_rows, got {g_rows.dtype}")
    if any(t.dtype != torch.int32 for t in (ids, perm, seg_start)):
        raise TypeError(
            f"k1_dedup takes int32 ids, perm and seg_start, got "
            f"{ids.dtype}, {perm.dtype} and {seg_start.dtype}"
        )
    n = ids.numel()
    if (g_rows.dim() != 2 or g_rows.shape[0] != n or g_rows.shape[1] < 1
            or ids.dim() != 1 or tuple(perm.shape) != (n,)
            or seg_start.dim() != 1 or not 1 <= seg_start.numel() <= n + 1
            or g_rows.numel() > _INT32_MAX):
        raise ValueError(
            f"k1_dedup takes g_rows [n, D], ids [n], perm [n] and "
            f"seg_start [U+1] with U <= n, got {tuple(g_rows.shape)}, "
            f"{tuple(ids.shape)}, {tuple(perm.shape)} and "
            f"{tuple(seg_start.shape)}"
        )
    dev = g_rows.device
    if dev.type not in ("cuda", "cpu") or any(
        t.device != dev for t in (ids, perm, seg_start)
    ):
        raise ValueError(
            f"k1_dedup takes CUDA (or CPU) tensors on one device, got "
            f"{[str(t.device) for t in (g_rows, ids, perm, seg_start)]}"
        )
    if not all(t.is_contiguous() for t in (g_rows, ids, perm, seg_start)):
        raise ValueError("k1_dedup takes contiguous tensors")


def k1_dedup_plain(g_rows, ids, perm, seg_start):
    """Plain K1 (any device): ``(urows [U] i32, sums [U, 2D])`` by
    ``index_add_`` of the sorted ``[g | g²]`` payload over each sorted
    occurrence's segment index; ``sums`` in ``g_rows``' dtype (the
    kernel's checks run it in float64 as their reference)."""
    n, d = g_rows.shape
    u = seg_start.numel() - 1
    perm = perm.long()
    g_sorted = g_rows.index_select(0, perm)
    counts = (seg_start[1:] - seg_start[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(u, device=g_rows.device), counts, output_size=n
    )
    payload = torch.cat([g_sorted, g_sorted * g_sorted], dim=1)
    sums = torch.zeros((u, 2 * d), dtype=g_rows.dtype, device=g_rows.device)
    sums.index_add_(0, seg, payload)
    urows = ids.index_select(0, perm.index_select(0, seg_start[:-1].long()))
    return urows.to(torch.int32), sums


def k1_error_bound(seg_start, mass):
    """Largest ``|K1 - exact|`` the kernel's order of summation allows
    for each segment: a lane adds its ``ceil(count / 32)`` terms in turn,
    five shuffle levels join the lanes and ``g*g`` is rounded once, each
    rounding off by at most ``2^-24`` of the segment's mass (the sum of
    the absolute terms, ``[U, 2D]``, e.g. :func:`k1_dedup_plain` of
    ``|g|`` in float64); 1.01 covers the second-order terms."""
    counts = (seg_start[1:] - seg_start[:-1]).double()[:, None]
    return (torch.ceil(counts / 32) + 6) * 2.0**-24 * 1.01 * mass


def k1_dedup_cuda(g_rows, ids, perm, seg_start):
    """K1 through the CUDA kernel (one warp per unique id, no float
    atomics), on the current stream; CPU tensors take
    :func:`k1_dedup_plain`.  Returns ``(urows [U] i32, sums [U, 2D])``."""
    _check_k1(g_rows, ids, perm, seg_start)
    if g_rows.device.type == "cpu":
        return k1_dedup_plain(g_rows, ids, perm, seg_start)
    u = seg_start.numel() - 1
    d = g_rows.shape[1]
    urows = torch.empty((u,), dtype=torch.int32, device=g_rows.device)
    sums = torch.empty((u, 2 * d), dtype=torch.float32, device=g_rows.device)
    if u == 0:
        return urows, sums
    lib = _build.load()
    with torch.cuda.device(g_rows.device):
        stream = torch.cuda.current_stream(g_rows.device).cuda_stream
        _launch("k1_dedup", lib.k1_dedup, g_rows.data_ptr(), ids.data_ptr(),
                perm.data_ptr(), seg_start.data_ptr(), urows.data_ptr(),
                sums.data_ptr(), u, d, stream)
    k1_dedup_cuda.launches += 1
    return urows, sums


k1_dedup_cuda.launches = 0


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
    table first, then Adagrad's accumulator or FTRL's ``z`` and ``n``)."""
    idx = urows.long()
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
    """K2 through the CUDA kernel (one thread per touched row and
    column, in place), on the current stream; CPU tensors take
    :func:`k2_apply_plain`."""
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


# ------------------------------------------------------------ orchestration


def apply(optimizer: str, tables, ids: torch.Tensor, g_rows: torch.Tensor,
          hyper: Hyper, meta: Optional[SortMeta] = None,
          plain: bool = False) -> None:
    """Sparse update of ``tables`` (see :func:`k2_apply_plain` for their
    order) from per-occurrence row gradients ``g_rows [n, D]`` of the
    flat ids ``ids [n]``, in place.  ``meta`` is the host prep for these
    ids (moved to their device); None sorts on the device.
    ``plain=True`` runs the plain versions on any device."""
    ids = ids.reshape(-1).to(torch.int32).contiguous()
    if meta is None:
        meta = sort_meta(ids)
    k1 = k1_dedup_plain if plain else k1_dedup_cuda
    k2 = k2_apply_plain if plain else k2_apply_cuda
    urows, sums = k1(g_rows.contiguous(), ids, meta.perm, meta.seg_start)
    k2(optimizer, urows, sums, tuple(tables), hyper)
