"""Sparse row-update training step — the counterpart of
``fast_tffm_tpu/train/sparse.py`` (single device).

Per step the optimizer touches only the rows the batch gathered:

1. gather once: ``rows = table[ids]``, held as a DETACHED leaf.  The
   loss is differentiated with respect to ``(w0, rows)``, never the
   table: autograd through the gather would build a dense ``[V, D]``
   table gradient every step, which is what this path exists to avoid;
2. the FM interaction's backward is the closed-form FmGrad
   (``ops.interaction.FmInteraction``), giving per-occurrence row
   gradients ``[B, F, D]``; with ``compute_dtype = bfloat16`` the
   interaction runs the kernels' bf16-input mode on rows and values
   rounded to bf16, and its bf16 gradient is widened back to f32.
   Field-aware FM (``field_num > 0``, ``D = 1 + P*k``) takes the
   closed-form FFM op (``ops.interaction.FfmInteraction``) instead, on
   the f32 rows;
3. ``ops.sparse_apply.apply`` sorts (or takes the pipeline's host sort
   meta), K1 sums the occurrences per unique row, and K2 applies Adagrad,
   FTRL or SGD in place at those rows.  ``w0`` is updated as a dense
   scalar.

Duplicate ids follow per-occurrence accumulator semantics (each
occurrence adds its own g², duplicates share the post-update
denominator), the reference's and TF's ``SparseApplyAdagrad``'s.  The
model and optimizer tensors are updated in place: the port keeps one
copy of each table where the JAX package's functional update returns a
new one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.libsvm import Batch, SortMeta
from fast_tffm_tpu_torch.models import fm
from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.ops import interaction, sparse_apply

__all__ = [
    "ADAGRAD_EPS", "SparseAdagradState", "SparseFtrlState", "apply_w0",
    "grad_health", "hyper", "init_sparse_opt_state", "opt_tables",
    "row_grads",
    "rows_loss", "sparse_step", "supports_sparse", "to_device",
]

ADAGRAD_EPS = 1e-7  # matches optax.adagrad's default eps


class SparseAdagradState(NamedTuple):
    acc_w0: torch.Tensor  # [] squared-gradient accumulator of w0
    acc_table: torch.Tensor  # [V, D] per-weight accumulators


class SparseFtrlState(NamedTuple):
    z_w0: torch.Tensor
    z_table: torch.Tensor
    n_w0: torch.Tensor
    n_table: torch.Tensor


def supports_sparse(cfg: FmConfig) -> bool:
    """Sparse updates need a row-local optimizer and row-local (batch) L2
    (or no L2 at all — l2_mode is irrelevant when both lambdas are 0)."""
    if cfg.optimizer not in sparse_apply.OPTIMIZERS:
        return False
    return cfg.l2_mode == "batch" or not (cfg.factor_lambda or cfg.bias_lambda)


def init_sparse_opt_state(cfg: FmConfig, model: FmModel):
    """Fresh optimizer state beside ``model``'s tensors, on their device:
    Adagrad accumulators at ``adagrad_initial_accumulator``; FTRL's ``z``
    set so the closed form reproduces the incoming weights (a warm start
    keeps them) and ``n`` at the initial accumulator; ``()`` for SGD."""
    with torch.no_grad():
        w0, table = model.w0.detach(), model.table.detach()
        init = cfg.adagrad_initial_accumulator
        if cfg.optimizer == "adagrad":
            return SparseAdagradState(torch.full_like(w0, init),
                                      torch.full_like(table, init))
        if cfg.optimizer == "ftrl":
            # f32 like the reference's jnp arithmetic on these constants.
            root = torch.sqrt(torch.tensor(init, dtype=torch.float32))
            denom0 = ((cfg.ftrl_beta + root) / cfg.learning_rate
                      + cfg.ftrl_l2).to(table.device)

            def z_of(p):
                return -p * denom0 - torch.sign(p) * cfg.ftrl_l1

            return SparseFtrlState(z_of(w0), z_of(table),
                                   torch.full_like(w0, init),
                                   torch.full_like(table, init))
        if cfg.optimizer == "sgd":
            return ()
    raise ValueError(f"no sparse path for optimizer {cfg.optimizer!r}")


def opt_tables(opt_state) -> tuple:
    """The optimizer's ``[V, D]`` tables in the order K2 updates them
    after the weight table: Adagrad's accumulator; FTRL's ``z``, ``n``."""
    if isinstance(opt_state, SparseAdagradState):
        return (opt_state.acc_table,)
    if isinstance(opt_state, SparseFtrlState):
        return (opt_state.z_table, opt_state.n_table)
    return ()


def hyper(cfg: FmConfig) -> sparse_apply.Hyper:
    return sparse_apply.Hyper(
        lr=cfg.learning_rate, eps=ADAGRAD_EPS, l1=cfg.ftrl_l1,
        l2=cfg.ftrl_l2, beta=cfg.ftrl_beta,
    )


def to_device(batch: Batch, device) -> Batch:
    """A numpy :class:`Batch` as tensors on ``device`` (its sort meta
    too, when the pipeline attached one)."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    meta = batch.sort_meta
    if meta is not None:
        meta = SortMeta(put(meta.perm), put(meta.seg_start))
    return Batch(put(batch.labels), put(batch.ids), put(batch.vals),
                 put(batch.fields), put(batch.weights), meta)


def rows_loss(cfg: FmConfig, w0: torch.Tensor, rows: torch.Tensor,
              batch: Batch, plain: bool = False):
    """``(loss, scores)`` over gathered f32 rows: the weighted data loss
    plus the batch L2 (``fast_tffm_tpu/train/sparse.py::_rows_loss_fn``;
    ``l2_mode = full`` is the dense step's, ``train/dense.py``).
    With ``compute_dtype = bfloat16`` the interaction sees the rows and
    values rounded to bf16; the casts are inside autograd, so the bf16
    row gradient comes back f32 through the cast's backward, and the
    batch L2 sees the f32 rows.  With ``field_num > 0`` the interaction
    is field-aware FM (``ops.interaction.ffm_interaction``, einsums and
    a closed-form backward; ``plain`` does not apply to it).  Scores and
    loss are f32 either way."""
    cd = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    if cfg.field_num:
        # The rows enter uncast: the FFM op rounds its operands inside,
        # so its row gradient is f32 (the reference's FFM branch).
        scores = w0 + interaction.ffm_interaction(
            rows, batch.vals, batch.fields, cfg.factor_num, cfg.field_num,
            cd)
    else:
        # fm_interaction gives the values the rows' type.
        scores = w0 + interaction.fm_interaction(rows.to(cd), batch.vals,
                                                 plain)
    per_ex = fm.example_losses(scores, batch.labels, cfg.loss_type)
    wsum = torch.clamp(torch.sum(batch.weights), min=1e-12)
    loss = torch.sum(per_ex * batch.weights) / wsum
    if cfg.l2_mode == "batch" and (cfg.factor_lambda or cfg.bias_lambda):
        loss = loss + fm.l2_penalty_batch(
            w0, rows, batch.vals, cfg.factor_lambda, cfg.bias_lambda
        )
    return loss, scores


def apply_w0(cfg: FmConfig, model: FmModel, opt_state,
             dw0: torch.Tensor) -> None:
    """Dense scalar update of ``w0`` (and its optimizer scalars)."""
    lr = cfg.learning_rate
    w0 = model.w0
    if cfg.optimizer == "adagrad":
        acc = opt_state.acc_w0 + dw0 * dw0
        opt_state.acc_w0.copy_(acc)
        w0.copy_(w0 - lr * dw0 * torch.rsqrt(acc + ADAGRAD_EPS))
    elif cfg.optimizer == "ftrl":
        n_old = opt_state.n_w0
        n_new = n_old + dw0 * dw0
        sigma = (torch.sqrt(n_new) - torch.sqrt(n_old)) / lr
        z = opt_state.z_w0 + dw0 - sigma * w0
        w0.copy_(sparse_apply.ftrl_solve(z, n_new, lr, cfg.ftrl_l1,
                                         cfg.ftrl_l2, cfg.ftrl_beta))
        opt_state.z_w0.copy_(z)
        opt_state.n_w0.copy_(n_new)
    else:
        w0.copy_(w0 - lr * dw0)


def row_grads(cfg: FmConfig, model: FmModel, batch: Batch,
              plain: bool = False) -> tuple:
    """``(scores [B], dw0 [], drows [B*F, D])``: the batch's rows gathered
    once as a detached leaf and :func:`rows_loss` differentiated with
    respect to ``w0`` and them (never the table), per occurrence."""
    table = model.table
    b, f = batch.ids.shape
    d = table.shape[1]
    with torch.no_grad():
        rows = table.index_select(0, batch.ids.reshape(-1)).view(b, f, d)
    rows.requires_grad_()
    w0 = model.w0.detach().clone().requires_grad_()
    with torch.enable_grad():
        loss, scores = rows_loss(cfg, w0, rows, batch, plain)
        dw0, drows = torch.autograd.grad(loss, (w0, rows))
    return scores.detach(), dw0, drows.reshape(b * f, d)


def grad_health(g_rows: torch.Tensor, dw0: torch.Tensor) -> tuple:
    """``(grad_sq, nonfinite)`` of a step's gradients, device scalars
    (f32, i32): the training-health pair the trainer's carry accumulates
    (``fast_tffm_tpu/train/sparse.py::grad_health``).  ``grad_sq`` is the
    squared norm at OCCURRENCE granularity (a duplicated id contributes
    per occurrence, as the per-occurrence optimizers see it); ``nonfinite``
    counts the non-finite elements.  Reduced in f32, on the device, in
    one read of the gradient for each: ``x - x`` is 0 for a finite ``x``
    and NaN otherwise, which ``count_nonzero`` counts.  The dense path
    passes its whole table gradient (the reference's
    ``_tree_grad_health``)."""
    g = g_rows.reshape(-1).float()
    d = dw0.float()
    grad_sq = torch.linalg.vector_norm(g).square() + d * d
    nonfinite = (torch.count_nonzero(g - g)
                 + torch.count_nonzero(d - d)).to(torch.int32)
    return grad_sq, nonfinite


def sparse_step(cfg: FmConfig, model: FmModel, opt_state, batch: Batch,
                plain: bool = False, health: bool = False):
    """One sparse train step on a device :class:`Batch` (see
    :func:`to_device`): updates ``model`` and ``opt_state`` in place and
    returns the step's raw scores ``[B]``, and with ``health`` also its
    :func:`grad_health` pair, from the row gradients the step already
    holds.  The batch's ``sort_meta`` is used when present, else the ids
    are sorted on the device.  ``plain=True`` runs the kernels' plain
    versions on any device."""
    scores, dw0, drows = row_grads(cfg, model, batch, plain)
    with torch.no_grad():
        pair = grad_health(drows, dw0) if health else None
        sparse_apply.apply(
            cfg.optimizer, (model.table,) + opt_tables(opt_state), batch.ids,
            drows, hyper(cfg), meta=batch.sort_meta, plain=plain,
        )
        apply_w0(cfg, model, opt_state, dw0)
    return (scores, pair) if health else scores
