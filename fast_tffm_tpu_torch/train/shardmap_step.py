"""Hand-sharded train step — the counterpart of
``fast_tffm_tpu/train/shardmap_step.py``, FM and field-aware FM, f32
and bf16 compute.

Each rank holds one model shard of the table (rows ``[row_lo, row_lo +
vocab_local)``, with the optimizer tables beside it) and one data block
of the global batch.  FM's algebra keeps the row exchange away:

* the per-example terms ``(linear, s1, s2)`` are sums of per-feature
  contributions, each depending only on the row its id owns, so every
  rank computes partial terms from its own rows and one ``[b, 2k+1]``
  sum over the ``model`` axis completes them;
* the backward is the closed-form FmGrad ``dV = g·x·(s1 - v·x)``
  (``ops.fm_kernels.fm_grad_cuda``), which needs only the completed
  ``s1`` and the rank's own rows: each rank computes the gradients of
  the occurrences it owns;
* field-aware FM (``field_num = P > 0``, ``D = 1 + P·k``) is the same
  inversion: the field-grouped sums ``S[b, p, q, :] = sum_{i: f_i = p}
  v_i^q x_i``, ``linear`` and the self term ``sum_i |v_i^{f_i}|² x_i²``
  are sums of per-feature contributions, so one ``[b, 2 + P·P·k]`` sum
  over ``model`` completes them, and the closed form ``dv_i^q = g x_i
  (S[q, f_i] - [q = f_i] v_i^{f_i} x_i)`` needs only the completed ``S``
  and the rank's own rows.  ``S`` is one batched product; ``S[q, f_i]``
  and ``v_i^{f_i}`` are gathered at each occurrence's field (exact, as
  the reference's one-hot products are), not two more one-hot products;
* :func:`shard_row_grads` returns the scores, ``g = dL/dscore`` and the
  masked per-occurrence row gradients of the rank's shard; two updates
  consume them.  The sparse one (:func:`sparse_step_shardmap`) sums
  per-row ``(sum g, sum g²)`` over the ``data`` axis by one of two
  exchanges (``ops.sparse_apply.resolve_exchange``): ``dense`` (K1,
  K-place, a sum of the ``[vocab_local, 2D]`` delta, the optimizer
  applied elementwise to the whole shard) or ``entries`` (K1, an
  all-gather of the padded touched-row streams, K1's merge mode, K2 in
  place at the touched rows).  The dense optax one is
  ``train/dense.py::dense_step_sharded``.

bf16 compute (``compute_dtype = bfloat16``) follows the reference's
rule (``fast_tffm_tpu/train/shardmap_step.py::_fm_fwd_bwd``): the
rows and values are rounded to bf16, ``xv = v·x``, ``w·x`` and ``xv·xv``
are bf16 products, the partial terms are summed in f32, and the sum
over ``model``, the backward and the optimizer stay f32.  The backward
is the f32 FmGrad kernel on the bf16-rounded rows with the f32 values:
its ``g·x`` is the reference's ``gx`` exactly, and its ``v·x`` is not
rounded to bf16 again, one bf16 rounding of ``xv`` away from the
reference's ``gx·(s1 - xv)`` (inside ``tests/test_bf16.py``'s gradient
bound).  The bf16 FmGrad kernel is not used: it returns bf16 ``drows``,
a rounding of the gradient itself, which the reference's sharded step
does not make.  Field-aware FM in bf16 rounds its operands as the
reference's TPU program does (the port's rule for FFM on every
device), its contractions f32.  Evaluation (:func:`local_scores`)
scores in f32, as the reference's eval step.

The entries exchange can overlap its id plane (``sparse_exchange_overlap``,
resolved by :func:`overlap_active` as the reference's
``train/sparse.py::overlap_active``): the stream's rows depend on the
batch's ids alone, so :func:`entries_prefetch` computes them and starts
their all-gather over the ``data`` axis as an asynchronous collective
(the reference's ``ops/sparse_apply.py::make_entries_prefetch``) while
the previous step runs; the step then takes them as ``rows_all`` and
gathers only its payload (the reference's ``entries_exchange(...,
rows_all=)``).  The rows handed over are the ones the step would have
gathered, so the parameters are bitwise the same.

``g``, ``dw0`` and the scores are the same on every rank of a model
row, so only the ``data`` axis sums them.  The model and optimizer
tensors are updated in place.  No step reads a device value on the
host (the static device sort, the entries stream's device count,
fixed-size collectives); a mesh still dispatches eagerly
(``train/loop.py::Trainer._eager_reason``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.libsvm import Batch
from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.ops import fm_kernels, interaction, sparse_apply
from fast_tffm_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, PendingGather, all_gather, all_gather_async,
    psum,
)
from fast_tffm_tpu_torch.train.sparse import (
    ADAGRAD_EPS, apply_w0, hyper, opt_tables, supports_sparse,
)

__all__ = ["ShardGrads", "entries_prefetch", "exchange_mode",
           "health_pair", "health_terms", "local_scores", "overlap_active",
           "shard_row_grads",
           "sparse_step_shardmap", "supports_shardmap", "supports_tiles",
           "w0_grad"]


def supports_tiles(cfg: FmConfig, mesh: Mesh) -> bool:
    """Whether the vocabulary splits into model shards of whole
    ``TILE`` s, as every step on a rank mesh needs."""
    m = mesh.model
    return (cfg.vocabulary_size % (m * sparse_apply.TILE) == 0
            and cfg.vocabulary_size // m >= sparse_apply.TILE)


def supports_shardmap(cfg: FmConfig, mesh: Mesh) -> bool:
    """The reference's gate: a row-local optimizer, batch (or no) L2 and
    a vocabulary that splits into model shards of whole ``TILE`` s."""
    return supports_sparse(cfg) and supports_tiles(cfg, mesh)


def exchange_mode(cfg: FmConfig, mesh: Mesh, n_local_occ: int) -> str:
    """``cfg.sparse_exchange`` resolved for these static shapes."""
    return sparse_apply.resolve_exchange(
        cfg.sparse_exchange, n_local_occ=n_local_occ,
        vocab_local=cfg.vocabulary_size // mesh.model,
        d=cfg.embedding_dim, data_shards=mesh.data,
    )


def overlap_active(cfg: FmConfig, mesh: Mesh) -> bool:
    """``cfg.sparse_exchange_overlap`` resolved against the path taken,
    as the reference's ``train/sparse.py::overlap_active``: the id plane
    overlaps only on the sharded apply with the exchange resolved to
    ``entries`` over more than one data shard.  ``auto`` overlaps
    exactly then, ``on`` raises the reference's ValueError elsewhere,
    ``off`` never overlaps.  The reference's apply is ``sharded`` where
    its kernels run and the vocabulary splits into model shards of whole
    tiles, unless ``sparse_apply = scatter``; the port runs its kernels
    on every device, so only the last two rules apply.  ``cfg`` is the
    one the step runs with (the hot table's under tiering)."""
    if cfg.sparse_exchange_overlap == "off":
        return False
    ok = mesh is not None and mesh.data > 1
    if ok:
        ok = (cfg.sparse_apply != "scatter"
              and supports_shardmap(cfg, mesh))
    if ok:
        ok = sparse_apply.resolve_exchange(
            cfg.sparse_exchange,
            n_local_occ=cfg.batch_size * cfg.max_features // mesh.data,
            vocab_local=cfg.vocabulary_size // mesh.model,
            d=cfg.embedding_dim, data_shards=mesh.data,
        ) == "entries"
    if cfg.sparse_exchange_overlap == "on" and not ok:
        raise ValueError(
            "sparse_exchange_overlap=on requires the sharded sparse apply "
            "with resolved exchange 'entries' over >1 data shard (got "
            f"mesh={None if mesh is None else dict(mesh.shape)}, "
            f"sparse_exchange={cfg.sparse_exchange!r}); use 'auto' to "
            "overlap opportunistically"
        )
    return ok


def _local_ids(cfg: FmConfig, ids: torch.Tensor, mesh: Mesh):
    """``(lids [b*F] i32, vocab_local)``: the occurrences in the rank's
    shard coordinates, every off-shard one at the sentinel row
    ``vocab_local``, which no exchange applies."""
    row_lo, vocab_local = mesh.row_range(cfg.vocabulary_size)
    local = (ids >= row_lo) & (ids < row_lo + vocab_local)
    lids = torch.where(local, ids - row_lo, vocab_local)
    return lids.reshape(-1).to(torch.int32), vocab_local


def entries_prefetch(cfg: FmConfig, ids: torch.Tensor,
                     mesh: Mesh) -> PendingGather:
    """Start the id-plane gather of a batch's entries exchange: the
    rank's rows of :func:`ops.sparse_apply.entries_rows` for the data
    block ``ids [b, F]``, all-gathered over the ``data`` axis
    asynchronously.  Its ``wait()`` is the ``rows_all`` operand of
    :func:`sparse_step_shardmap` for that batch."""
    lids, vocab_local = _local_ids(cfg, ids, mesh)
    cap = sparse_apply.entries_cap(lids.numel(), vocab_local)
    rows_e = sparse_apply.entries_rows(lids, vocab=vocab_local, cap=cap)
    return all_gather_async(rows_e, DATA_AXIS, mesh)


def _local_rows(cfg: FmConfig, table_l: torch.Tensor, ids: torch.Tensor,
                mesh: Mesh):
    """``(rows [b, F, D], mask [b, F], vocab_local)``: the
    rank's own rows of each occurrence, zero where another shard owns
    the id (which reads row 0, masked)."""
    row_lo, vocab_local = mesh.row_range(cfg.vocabulary_size)
    local = (ids >= row_lo) & (ids < row_lo + vocab_local)
    lids = torch.where(local, ids - row_lo, 0).long()
    maskf = local.to(torch.float32)
    b, f = ids.shape
    rows = table_l.index_select(0, lids.reshape(-1)).view(b, f, -1)
    return rows * maskf[..., None], maskf, vocab_local


def _fm_terms(w0, rows, vals, mesh: Mesh, cd=torch.float32):
    """``(scores [b], s1 [b, k])``: partial terms from the rank's rows,
    summed over the model axis.  In bf16 (``cd``) the rows and values
    are rounded and ``w·x``, ``xv`` and ``xv·xv`` are bf16 products,
    summed in f32 (the reference's ``_fm_fwd_bwd``)."""
    k = rows.shape[-1] - 1
    if cd == torch.float32:
        xv = rows[..., 1:] * vals[..., None]
        parts = [
            torch.sum(rows[..., 0] * vals, dim=-1, keepdim=True),  # linear
            torch.sum(xv, dim=1),  # s1 [b, k]
            torch.sum(xv * xv, dim=1),  # s2 [b, k]
        ]
    else:
        rows_c, vals_c = rows.to(cd), vals.to(cd)
        xv = rows_c[..., 1:] * vals_c[..., None]
        parts = [
            torch.sum((rows_c[..., 0] * vals_c).float(), dim=-1,
                      keepdim=True),
            torch.sum(xv.float(), dim=1),
            torch.sum((xv * xv).float(), dim=1),
        ]
    terms = psum(torch.cat(parts, dim=-1).contiguous(), MODEL_AXIS, mesh)
    linear, s1, s2 = terms[:, 0], terms[:, 1:1 + k], terms[:, 1 + k:]
    return w0 + linear + 0.5 * torch.sum(s1 * s1 - s2, dim=-1), s1


def _field_index(fields, field_num: int):
    """``(index, valid)``: each occurrence's field as a long index (0
    where it lies outside ``[0, P)``) and the f32 mask of those inside
    (the reference's one-hot products give a zero row outside)."""
    valid = (fields >= 0) & (fields < field_num)
    return torch.where(valid, fields, 0).long(), valid.float()


def _own_field(v, fields, field_num: int):
    """``v_i^{f_i} [b, F, k]`` of ``v [b, F, P, k]``: each occurrence's
    factors at its own field."""
    idx, valid = _field_index(fields, field_num)
    idx = idx[..., None, None].expand(v.shape[:2] + (1, v.shape[3]))
    return torch.gather(v, 2, idx).squeeze(2) * valid[..., None]


def _ffm_terms(cfg: FmConfig, w0, rows, vals, fields, mesh: Mesh,
               cd=torch.float32):
    """``(scores [b], S [b, P, P, k], v_own [b, F, k])`` of field-aware
    FM: partial ``linear``, self term and ``S`` from the rank's rows, one
    sum over the model axis (the reference's ``_ffm_fwd_bwd``), and the
    rank's own ``v_i^{f_i}`` for the backward."""
    p, k = cfg.field_num, cfg.factor_num
    b, f = vals.shape
    rows_c, vals_c, v, x_c, oh = interaction._ffm_operands(
        rows, vals, fields, k, p, cd)
    linear = (rows_c[..., 0] * vals_c).float().sum(dim=-1)
    s = torch.einsum("bfp,bfqk->bpqk", oh * x_c[..., None], v)
    v_own = _own_field(v, fields, p)  # v_i^{f_i}, zero off-shard
    self_t = ((v_own * v_own).sum(dim=-1) * (vals * vals)).sum(dim=-1)
    terms = torch.cat([linear[:, None], self_t[:, None],
                       s.reshape(b, p * p * k)], dim=-1).contiguous()
    terms = psum(terms, MODEL_AXIS, mesh)
    s = terms[:, 2:].reshape(b, p, p, k)
    cross = torch.einsum("bpqk,bqpk->b", s, s)
    return w0 + terms[:, 0] + 0.5 * (cross - terms[:, 1]), s, v_own


def _ffm_drows(cfg: FmConfig, s, v_own, vals, fields, g):
    """The closed-form FFM row gradients ``[b, F, 1 + P·k]``: ``dw_i =
    g x_i``, ``dv_i^q = g x_i (S[q, f_i] - [q = f_i] v_i^{f_i} x_i)``,
    with ``S[q, f_i]`` gathered at each occurrence's field."""
    p = cfg.field_num
    b, f = vals.shape
    gx = g[:, None] * vals  # [b, F]
    # T[b, f, q, :] = S[b, q, f_i, :]: S's second field axis taken at
    # each occurrence's own field.
    idx, valid = _field_index(fields, p)
    batch = torch.arange(b, device=s.device)[:, None]
    t = s.transpose(1, 2)[batch, idx] * valid[..., None, None]
    oh = interaction._one_hot(fields, p)
    dv = gx[..., None, None] * (
        t - oh[..., None] * v_own[:, :, None, :] * vals[..., None, None])
    return torch.cat([gx[..., None], dv.reshape(b, f, -1)], dim=-1)


def local_scores(cfg: FmConfig, model_l: FmModel, batch_l: Batch,
                 mesh: Mesh) -> torch.Tensor:
    """Raw f32 scores ``[b]`` of the rank's data block (the sharded
    forward: evaluation, in f32 whatever the compute dtype)."""
    with torch.no_grad():
        rows = _local_rows(cfg, model_l.table, batch_l.ids, mesh)[0]
        vals = batch_l.vals.float()
        if cfg.field_num:
            return _ffm_terms(cfg, model_l.w0, rows, vals, batch_l.fields,
                              mesh)[0]
        return _fm_terms(model_l.w0, rows, vals, mesh)[0]


def _dscore(scores, labels, loss_type: str):
    if loss_type == "logistic":
        return torch.sigmoid(scores) - labels
    return 2.0 * (scores - labels)  # mse


def _apply_delta(cfg: FmConfig, g1, g2, tables) -> None:
    lr = cfg.learning_rate
    if cfg.optimizer == "adagrad":
        sparse_apply.adagrad_update(g1, g2, *tables, lr=lr, eps=ADAGRAD_EPS)
    elif cfg.optimizer == "ftrl":
        sparse_apply.ftrl_update(g1, g2, *tables, lr=lr, l1=cfg.ftrl_l1,
                                 l2=cfg.ftrl_l2, beta=cfg.ftrl_beta)
    else:
        sparse_apply.sgd_update(g1, g2, *tables, lr=lr)


class ShardGrads(NamedTuple):
    """What :func:`shard_row_grads` gives the updates."""

    scores: torch.Tensor  # [b] raw scores of the rank's data block
    g: torch.Tensor  # [b] dL/dscore, the global weighted mean's
    drows: torch.Tensor  # [b*F, D] masked per-occurrence row gradients
    lids: torch.Tensor  # [b*F] i32 local ids, off-shard at vocab_local
    vocab_local: int


def shard_row_grads(cfg: FmConfig, model_l: FmModel, batch_l: Batch,
                    mesh: Mesh) -> ShardGrads:
    """The forward and the closed-form backward on this rank's shard:
    the scores of its data block, ``g`` and the row gradient of every
    occurrence it owns (zero for the others), with ``l2_mode = batch``'s
    term ``2·lambda·row / B`` added per occurrence (``B`` the global
    batch).  Every rank of the mesh calls it in lockstep (one sum over
    ``model``, one over ``data``)."""
    table_l = model_l.table
    d = table_l.shape[1]
    ids, vals = batch_l.ids, batch_l.vals.float()
    b, f = ids.shape
    cd = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    with torch.no_grad():
        w0 = model_l.w0.detach()
        rows, maskf, vocab_local = _local_rows(cfg, table_l, ids, mesh)
        if cfg.field_num:
            scores, s, v_own = _ffm_terms(cfg, w0, rows, vals,
                                          batch_l.fields, mesh, cd)
        else:
            scores, s1 = _fm_terms(w0, rows, vals, mesh, cd)
        # Global weighted-mean loss: the normaliser spans the data axis.
        wsum = psum(torch.sum(batch_l.weights).reshape(1), DATA_AXIS, mesh)
        g = batch_l.weights * _dscore(scores, batch_l.labels, cfg.loss_type)
        g = g / torch.clamp(wsum, min=1e-12)
        # Only occurrences this shard owns update its rows.
        if cfg.field_num:
            drows = _ffm_drows(cfg, s, v_own, vals, batch_l.fields, g)
        else:
            rows_c = rows if cd == torch.float32 else rows.to(cd).float()
            drows = fm_kernels.fm_grad_cuda(
                rows_c.contiguous(), vals.contiguous(), s1.contiguous(),
                g.contiguous(),
            )
        drows = drows * maskf[..., None]
        if cfg.l2_mode == "batch" and (cfg.factor_lambda or cfg.bias_lambda):
            # d/drow of l2_penalty_batch: 2*lambda*row/B per occurrence.
            lam = torch.full((d,), cfg.factor_lambda, dtype=torch.float32,
                             device=rows.device)
            lam[0] = cfg.bias_lambda
            occ = ((vals != 0).to(torch.float32) * maskf)[..., None]
            drows = drows + (2.0 / (b * mesh.data)) * lam * rows * occ
        lids = _local_ids(cfg, ids, mesh)[0]
    return ShardGrads(scores, g, drows.reshape(b * f, d), lids, vocab_local)


def w0_grad(cfg: FmConfig, w0: torch.Tensor, g: torch.Tensor,
            mesh: Mesh, extra: Optional[torch.Tensor] = None):
    """``dw0``: ``g`` summed over the data axis, plus ``l2_mode =
    batch``'s ``2·bias_lambda·w0 / B``.  ``extra`` (f32 ``[n]``) rides
    the same sum over ``data``, and then ``(dw0, extra summed)`` is
    returned."""
    head = torch.sum(g).reshape(1)
    if extra is not None:
        head = torch.cat([head, extra])
    summed = psum(head, DATA_AXIS, mesh)
    dw0 = summed[0]
    if cfg.l2_mode == "batch" and cfg.bias_lambda:
        # l2_penalty_batch's bias_lambda*w0^2/B has its w0 gradient.
        dw0 = dw0 + 2.0 * cfg.bias_lambda * w0 / float(g.numel() * mesh.data)
    return dw0 if extra is None else (dw0, summed[1:])


def health_terms(g: torch.Tensor) -> torch.Tensor:
    """``[sum of squares, non-finite count]`` of a shard's gradient, f32,
    to be summed over the ranks that hold its parts (the reductions of
    ``train/sparse.py::grad_health``)."""
    g = g.reshape(-1).float()
    return torch.stack([torch.linalg.vector_norm(g).square(),
                        torch.count_nonzero(g - g).float()])


def health_pair(terms: torch.Tensor, dw0: torch.Tensor) -> tuple:
    """The global ``(grad_sq, nonfinite)`` pair (f32, i32) from the
    summed :func:`health_terms` and the global ``dw0``."""
    d = dw0.float()
    return (terms[0] + d * d,
            (terms[1] + torch.count_nonzero(d - d)).to(torch.int32))


def sparse_step_shardmap(cfg: FmConfig, model_l: FmModel, opt_state_l,
                         batch_l: Batch, mesh: Mesh,
                         rows_all: Optional[torch.Tensor] = None,
                         health: bool = False):
    """One hand-sharded sparse step on this rank: ``model_l`` holds the
    rank's table shard (``w0`` replicated), ``opt_state_l`` its optimizer
    shard, ``batch_l`` its data block on the rank's device.  Updates both
    in place and returns the block's raw scores ``[b]``, and with
    ``health`` the global ``(grad_sq, nonfinite)`` pair
    (``train/sparse.py::grad_health``; the reference's
    ``shardmap_step.py:289-308``).  Every rank of the mesh calls it with
    the same shapes, in lockstep.  ``rows_all``: the batch's gathered id
    plane (:func:`entries_prefetch`), which the entries exchange over
    several data shards then does not gather."""
    table_l = model_l.table
    d = table_l.shape[1]
    b, f = batch_l.ids.shape
    exchange = exchange_mode(cfg, mesh, b * f)
    grads = shard_row_grads(cfg, model_l, batch_l, mesh)
    lids, g_flat, vocab_local = grads.lids, grads.drows, grads.vocab_local
    with torch.no_grad():
        tables = (table_l,) + opt_tables(opt_state_l)
        if exchange == "entries":
            if mesh.data == 1:  # nothing to gather
                urows, sums = sparse_apply.dedup_entries(
                    lids, g_flat, vocab=vocab_local
                )
            else:
                cap = sparse_apply.entries_cap(b * f, vocab_local)
                rows_e, pay_e, _ = sparse_apply.unique_entries(
                    lids, g_flat, vocab=vocab_local, cap=cap
                )
                if rows_all is None:
                    # One gather of [row | payload]: the int32 rows
                    # travel as float32 bit patterns, untouched by an
                    # all-gather.
                    packed = torch.cat(
                        [rows_e.view(torch.float32)[:, None], pay_e], dim=1
                    )
                    packed = all_gather(packed, DATA_AXIS, mesh)
                    rows_all = packed[:, 0].contiguous().view(torch.int32)
                    pay_all = packed[:, 1:]
                else:  # the id plane came ahead: the payload alone
                    pay_all = all_gather(pay_e, DATA_AXIS, mesh)
                urows, sums = sparse_apply.merge_entries(
                    rows_all, pay_all, vocab=vocab_local,
                )
            sparse_apply.k2_apply_cuda(cfg.optimizer, urows, sums.contiguous(),
                                       tables, hyper(cfg))
        else:
            delta = sparse_apply.dense_delta(
                lids, g_flat, vocab_local=vocab_local, row_lo=0
            )
            delta = psum(delta, DATA_AXIS, mesh)
            _apply_delta(cfg, delta[:, :d], delta[:, d:], tables)
        w0 = model_l.w0.detach()
        if not health:
            apply_w0(cfg, model_l, opt_state_l,
                     w0_grad(cfg, w0, grads.g, mesh))
            return grads.scores
        # Each occurrence's gradient lives on exactly one model shard
        # (the others' are masked to zero), so the local squares summed
        # over both axes are the global norm, nothing counted twice: the
        # sum over data rides w0's, then one sum of two numbers over
        # model.  dw0 is global already.
        dw0, local = w0_grad(cfg, w0, grads.g, mesh,
                             extra=health_terms(g_flat))
        pair = health_pair(psum(local.contiguous(), MODEL_AXIS, mesh), dw0)
        apply_w0(cfg, model_l, opt_state_l, dw0)
    return grads.scores, pair
