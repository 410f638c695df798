"""Hand-sharded sparse train step — the counterpart of
``fast_tffm_tpu/train/shardmap_step.py`` for plain FM.

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
* the update sums per-row ``(sum g, sum g²)`` over the ``data`` axis,
  by one of two exchanges (``ops.sparse_apply.resolve_exchange``):
  ``dense`` (K1, K-place, a sum of the ``[vocab_local, 2D]`` delta, the
  optimizer applied elementwise to the whole shard) or ``entries`` (K1,
  an all-gather of the padded touched-row streams, K1's merge mode, K2
  in place at the touched rows).

``g``, ``dw0`` and the scores are the same on every rank of a model
row, so only the ``data`` axis sums them.  The model and optimizer
tensors are updated in place.  Field-aware FM (``field_num > 0``) is
not ported yet (ROADMAP.md, port queue item 2).
"""

from __future__ import annotations

import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.libsvm import Batch
from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.ops import fm_kernels, sparse_apply
from fast_tffm_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, all_gather, psum,
)
from fast_tffm_tpu_torch.train.sparse import (
    ADAGRAD_EPS, apply_w0, hyper, opt_tables, supports_sparse,
)

__all__ = ["exchange_mode", "local_scores", "sparse_step_shardmap",
           "supports_shardmap"]


def supports_shardmap(cfg: FmConfig, mesh: Mesh) -> bool:
    """The reference's gate: a row-local optimizer, batch (or no) L2 and
    a vocabulary that splits into model shards of whole ``TILE`` s."""
    if not supports_sparse(cfg):
        return False
    m = mesh.model
    return (cfg.vocabulary_size % (m * sparse_apply.TILE) == 0
            and cfg.vocabulary_size // m >= sparse_apply.TILE)


def exchange_mode(cfg: FmConfig, mesh: Mesh, n_local_occ: int) -> str:
    """``cfg.sparse_exchange`` resolved for these static shapes."""
    return sparse_apply.resolve_exchange(
        cfg.sparse_exchange, n_local_occ=n_local_occ,
        vocab_local=cfg.vocabulary_size // mesh.model,
        d=cfg.embedding_dim, data_shards=mesh.data,
    )


def _local_rows(cfg: FmConfig, table_l: torch.Tensor, ids: torch.Tensor,
                mesh: Mesh):
    """``(rows [b, F, D], mask [b, F], row_lo, vocab_local)``: the
    rank's own rows of each occurrence, zero where another shard owns
    the id (which reads row 0, masked)."""
    row_lo, vocab_local = mesh.row_range(cfg.vocabulary_size)
    local = (ids >= row_lo) & (ids < row_lo + vocab_local)
    lids = torch.where(local, ids - row_lo, 0).long()
    maskf = local.to(torch.float32)
    b, f = ids.shape
    rows = table_l.index_select(0, lids.reshape(-1)).view(b, f, -1)
    return rows * maskf[..., None], maskf, local, row_lo, vocab_local


def _terms(w0, rows, vals, mesh: Mesh):
    """``(scores [b], s1 [b, k])``: partial terms from the rank's rows,
    summed over the model axis."""
    k = rows.shape[-1] - 1
    xv = rows[..., 1:] * vals[..., None]
    terms = torch.cat([
        torch.sum(rows[..., 0] * vals, dim=-1, keepdim=True),  # linear
        torch.sum(xv, dim=1),  # s1 [b, k]
        torch.sum(xv * xv, dim=1),  # s2 [b, k]
    ], dim=-1).contiguous()
    terms = psum(terms, MODEL_AXIS, mesh)
    linear, s1, s2 = terms[:, 0], terms[:, 1:1 + k], terms[:, 1 + k:]
    return w0 + linear + 0.5 * torch.sum(s1 * s1 - s2, dim=-1), s1


def local_scores(cfg: FmConfig, model_l: FmModel, batch_l: Batch,
                 mesh: Mesh) -> torch.Tensor:
    """Raw scores ``[b]`` of the rank's data block (the sharded forward:
    evaluation)."""
    with torch.no_grad():
        rows, _, _, _, _ = _local_rows(cfg, model_l.table, batch_l.ids, mesh)
        scores, _ = _terms(model_l.w0, rows, batch_l.vals.float(), mesh)
    return scores


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


def sparse_step_shardmap(cfg: FmConfig, model_l: FmModel, opt_state_l,
                         batch_l: Batch, mesh: Mesh) -> torch.Tensor:
    """One hand-sharded sparse step on this rank: ``model_l`` holds the
    rank's table shard (``w0`` replicated), ``opt_state_l`` its optimizer
    shard, ``batch_l`` its data block on the rank's device.  Updates both
    in place and returns the block's raw scores ``[b]``.  Every rank of
    the mesh calls it with the same shapes, in lockstep."""
    if cfg.field_num:
        raise NotImplementedError(
            "field_num > 0 on the sharded step is ROADMAP.md port queue "
            "item 3"
        )
    table_l = model_l.table
    d = table_l.shape[1]
    ids, vals = batch_l.ids, batch_l.vals.float()
    b, f = ids.shape
    exchange = exchange_mode(cfg, mesh, b * f)
    with torch.no_grad():
        w0 = model_l.w0.detach()
        rows, maskf, local, row_lo, vocab_local = _local_rows(
            cfg, table_l, ids, mesh
        )
        scores, s1 = _terms(w0, rows, vals, mesh)
        # Global weighted-mean loss: the normaliser spans the data axis.
        wsum = psum(torch.sum(batch_l.weights).reshape(1), DATA_AXIS, mesh)
        g = batch_l.weights * _dscore(scores, batch_l.labels, cfg.loss_type)
        g = g / torch.clamp(wsum, min=1e-12)
        # Only occurrences this shard owns update its rows.
        drows = fm_kernels.fm_grad_cuda(
            rows.contiguous(), vals.contiguous(), s1.contiguous(),
            g.contiguous(),
        ) * maskf[..., None]
        # The global batch size: every block holds b examples.
        bsz = float(b * mesh.data)
        if cfg.factor_lambda or cfg.bias_lambda:
            # d/drow of l2_penalty_batch: 2*lambda*row/B per occurrence.
            lam = torch.full((d,), cfg.factor_lambda, dtype=torch.float32,
                             device=rows.device)
            lam[0] = cfg.bias_lambda
            occ = ((vals != 0).to(torch.float32) * maskf)[..., None]
            drows = drows + (2.0 / bsz) * lam * rows * occ
        # Local-coordinate occurrences; off-shard ones go to the
        # sentinel row vocab_local, which no exchange applies.
        lids = torch.where(local, ids - row_lo, vocab_local)
        lids = lids.reshape(b * f).to(torch.int32)
        g_flat = drows.reshape(b * f, d)
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
                # One gather of [row | payload]: the int32 rows travel as
                # float32 bit patterns, untouched by an all-gather.
                packed = torch.cat(
                    [rows_e.view(torch.float32)[:, None], pay_e], dim=1
                )
                packed = all_gather(packed, DATA_AXIS, mesh)
                urows, sums = sparse_apply.merge_entries(
                    packed[:, 0].contiguous().view(torch.int32),
                    packed[:, 1:], vocab=vocab_local,
                )
            sparse_apply.k2_apply_cuda(cfg.optimizer, urows, sums.contiguous(),
                                       tables, hyper(cfg))
        else:
            delta = sparse_apply.dense_delta(
                lids, g_flat, vocab_local=vocab_local, row_lo=0
            )
            delta = psum(delta, DATA_AXIS, mesh)
            _apply_delta(cfg, delta[:, :d], delta[:, d:], tables)
        dw0 = psum(torch.sum(g).reshape(1), DATA_AXIS, mesh)[0]
        if cfg.bias_lambda:
            # l2_penalty_batch's bias_lambda*w0^2/B has its w0 gradient.
            dw0 = dw0 + 2.0 * cfg.bias_lambda * w0 / bsz
        apply_w0(cfg, model_l, opt_state_l, dw0)
    return scores

