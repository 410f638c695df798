"""The plain reference of a training cell: what the program derives from
the generated lines and the seed, worked out again, and the sparse FM
step in plain PyTorch (float32, TF32 off).

Frozen copies, each of the port's code named beside it (the reference
imports nothing of the port, of JAX or of the JAX package):

- :func:`murmur64a`: MurmurHash64A with seed 0 over each token's id part,
  taken modulo the vocabulary (``data/libsvm.py::murmur64``, the C++
  parser's ``fm_parser_murmur64``), vectorised over equal-length keys;
- :func:`raw_windows` and :func:`epoch_batches`: the raw-window stream
  (``data/pipeline.py::_iter_raw_windows`` and ``_raw_groups``: 4 MiB
  reads, windows of about ``max(shuffle_buffer, batch_size)`` lines by a
  running bytes-per-line estimate, a whole number of batches mid-stream,
  each window permuted by ``numpy.random.default_rng(r.getrandbits(63))``
  with ``r = random.Random(seed + epoch)``), and the epoch cache's replay
  order (``_replay_order``: ``random.Random(seed + epoch).shuffle`` of
  epoch 0's batches, or of its groups of K when prestacked);
- :meth:`FmReference.init`: the table drawn uniform in
  ``±init_value_range`` by one ``uniform_`` from a
  ``torch.Generator(device).manual_seed(seed)`` (``models/fm.py::
  init_params``), ``w0 = 0``, Adagrad's accumulators at their initial
  value (``train/sparse.py::init_sparse_opt_state``);
- :meth:`FmReference.step`: the FM score, the weighted logistic loss and
  the batch L2 differentiated by autograd with respect to ``w0`` and the
  gathered rows; the row gradients summed per unique id with their
  squares (per-occurrence accumulator semantics; one fixed order of
  addition on every run), then Adagrad on the
  unique rows and on ``w0`` (``eps = 1e-7``).
"""

from __future__ import annotations

import random

import numpy as np
import torch

__all__ = ["FmReference", "murmur64a", "raw_windows", "epoch_batches",
           "dispatch_batches"]

_M = np.uint64(0xC6A4A7935BD1E995)
_R = np.uint64(47)
_CHUNK_BYTES = 4 << 20
ADAGRAD_EPS = 1e-7


def murmur64a(keys: np.ndarray) -> np.ndarray:
    """MurmurHash64A (seed 0) of each row of ``keys [n, L]`` uint8."""
    n, length = keys.shape
    with np.errstate(over="ignore"):
        h = np.full(n, np.uint64((length * int(_M)) % (1 << 64)), np.uint64)
        nb = length // 8
        if nb:
            blocks = np.ascontiguousarray(keys[:, :nb * 8]).view("<u8")
            for i in range(nb):
                k = blocks[:, i] * _M
                k ^= k >> _R
                k *= _M
                h ^= k
                h *= _M
        tail = keys[:, nb * 8:].astype(np.uint64)
        if tail.shape[1]:
            t = np.zeros(n, np.uint64)
            for i in range(tail.shape[1]):
                t |= tail[:, i] << np.uint64(8 * i)
            h ^= t
            h *= _M
        h ^= h >> _R
        h *= _M
        h ^= h >> _R
    return h


def raw_windows(line_bytes: np.ndarray, batch_size: int, window_lines: int,
                chunk_bytes: int = _CHUNK_BYTES) -> list:
    """``(first line, lines)`` of each window of one file whose lines
    (``\\n`` included) have ``line_bytes`` bytes: the raw-window stream's
    cut, followed over byte offsets instead of the bytes themselves."""
    ends = np.cumsum(np.asarray(line_bytes, np.int64))
    starts = ends - line_bytes
    total = int(ends[-1]) if ends.size else 0
    chunk_ends = list(range(chunk_bytes, total, chunk_bytes)) + [total]
    window_lines = max(window_lines, batch_size)
    pend = pos = ci = 0  # pending bytes from pend; bytes read up to pos
    est_bpl = 80.0
    at_eof = False
    out = []
    while not at_eof:
        target = int(window_lines * est_bpl) + 1
        first = True
        while pos - pend < target or first:
            first = False
            if ci == len(chunk_ends) or total == 0:
                at_eof = True
                break
            pos = chunk_ends[ci]
            ci += 1
        if pos == pend:
            continue
        if at_eof:
            buf_end = pos
        else:
            j = int(np.searchsorted(ends, pos, side="right"))
            buf_end = max(pend, int(ends[j - 1]) if j else 0)
        if buf_end == pend:
            est_bpl *= 2.0
            continue
        i0 = int(np.searchsorted(starts, pend, side="left"))
        i1 = int(np.searchsorted(starts, buf_end, side="left"))
        n = i1 - i0
        est_bpl = (buf_end - pend) / n
        if at_eof:
            keep = n
        else:
            keep = (n // batch_size) * batch_size
            if keep == 0:
                continue
            pend = int(starts[i0 + keep]) if keep < n else buf_end
        out.append((i0, keep))
    return out


def epoch_batches(windows: list, batch_size: int, seed: int,
                  epoch: int) -> list:
    """The line indices of each batch of one streamed epoch: each window
    permuted (``seed + epoch``), cut into batches of at most
    ``batch_size``."""
    rng = random.Random(seed + epoch)
    out = []
    for i0, n in windows:
        idx = np.arange(i0, i0 + n)
        if n > 1:
            idx = idx[np.random.default_rng(rng.getrandbits(63))
                      .permutation(n)]
        out += [idx[i:i + batch_size] for i in range(0, n, batch_size)]
    return out


def dispatch_batches(epoch0: list, k: int, seed: int, epochs: int,
                     prestacked: bool) -> list:
    """The batches of each dispatch of the first ``epochs`` epochs of an
    epoch-cache run: epoch 0 as streamed, each later one replayed in
    ``random.Random(seed + epoch).shuffle`` order of epoch 0's batches
    (of its groups of ``k`` when ``prestacked``); a dispatch never spans
    two epochs."""
    groups0 = [epoch0[i:i + k] for i in range(0, len(epoch0), k)]
    out = list(groups0)
    for epoch in range(1, epochs):
        units = groups0 if prestacked else epoch0
        order = list(range(len(units)))
        random.Random(seed + epoch).shuffle(order)
        if prestacked:
            out += [groups0[i] for i in order]
        else:
            seq = [epoch0[i] for i in order]
            out += [seq[i:i + k] for i in range(0, len(seq), k)]
    return out


def _segment_sums(inv: torch.Tensor, g: torch.Tensor, n: int) -> tuple:
    """``(sums of g, sums of g * g)`` of each of ``n`` unique ids, the
    occurrences of one id added in one fixed order on every run (the
    deterministic ``index_add_``; the default on a GPU adds them by
    atomics in whatever order they land)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        g1 = torch.zeros((n, g.shape[1]), device=g.device).index_add_(
            0, inv, g)
        g2 = torch.zeros_like(g1).index_add_(0, inv, g * g)
    finally:
        torch.use_deterministic_algorithms(was)
    return g1, g2


class FmReference:
    """The sparse FM trainer in plain PyTorch: a ``[V, 1 + k]`` table and
    Adagrad's accumulators, updated one batch at a time."""

    def __init__(self, cfg: dict, device):
        self.vocab = int(cfg["vocabulary_size"])
        self.dim = 1 + int(cfg["factor_num"])
        self.lr = float(cfg["learning_rate"])
        self.acc0 = float(cfg["adagrad.initial_accumulator"])
        self.init_range = float(cfg["init_value_range"])
        self.lam_f = float(cfg["factor_lambda"])
        self.lam_b = float(cfg["bias_lambda"])
        self.device = torch.device(device)
        self.table = self.acc = self.w0 = self.acc_w0 = None

    def init(self, seed: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        table = torch.empty((self.vocab, self.dim), dtype=torch.float32,
                            device=self.device)
        table.uniform_(-self.init_range, self.init_range, generator=gen)
        self.table = table
        self.acc = torch.full_like(self.table, self.acc0)
        self.w0 = torch.zeros((), dtype=torch.float32, device=self.device)
        self.acc_w0 = torch.full_like(self.w0, self.acc0)

    def step(self, ids: torch.Tensor, vals: torch.Tensor,
             labels: torch.Tensor, weights: torch.Tensor) -> float:
        """One step on a batch (``ids [B, F]`` long, ``vals [B, F]``,
        ``labels [B]``, ``weights [B]``); returns its weighted mean data
        loss on the scores before the update."""
        b, f = ids.shape
        d = self.dim
        x, y, wt = vals.float(), labels.float(), weights.float()
        rows = self.table.index_select(0, ids.reshape(-1)).view(b, f, d)
        rows.requires_grad_()
        w0 = self.w0.clone().requires_grad_()
        with torch.enable_grad():
            xv = rows[..., 1:] * x[..., None]
            s1 = xv.sum(dim=1)
            s = (w0 + (rows[..., 0] * x).sum(dim=1)
                 + 0.5 * (s1 * s1 - (xv * xv).sum(dim=1)).sum(dim=1))
            per = torch.logaddexp(s, torch.zeros_like(s)) - y * s
            data = (per * wt).sum() / torch.clamp(wt.sum(), min=1e-12)
            mask = (x != 0).float()[..., None]
            l2 = (self.lam_f * ((rows[..., 1:] * mask) ** 2).sum()
                  + self.lam_b * (((rows[..., :1] * mask) ** 2).sum()
                                  + w0 ** 2)) / b
            dw0, drows = torch.autograd.grad(data + l2, (w0, rows))
        with torch.no_grad():
            uniq, inv = torch.unique(ids.reshape(-1), return_inverse=True)
            g = drows.reshape(-1, d)
            g1, g2 = _segment_sums(inv, g, uniq.numel())
            acc = self.acc.index_select(0, uniq) + g2
            new = (self.table.index_select(0, uniq)
                   - self.lr * g1 * torch.rsqrt(acc + ADAGRAD_EPS))
            self.table.index_copy_(0, uniq, new)
            self.acc.index_copy_(0, uniq, acc)
            self.acc_w0 = self.acc_w0 + dw0 * dw0
            self.w0 = self.w0 - self.lr * dw0 * torch.rsqrt(
                self.acc_w0 + ADAGRAD_EPS)
        return float(data.detach())
