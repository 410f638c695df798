"""FM model core — the counterpart of ``fast_tffm_tpu/models/fm.py``.

Numeric spec (reference ``FmScorer``):

    score_e = w0 + sum_i w[i]*x_i
                 + 0.5 * sum_f [ (sum_i V[i,f]*x_i)^2 - sum_i V[i,f]^2*x_i^2 ]

The parameters are one table ``[vocab, D]`` whose column 0 is the linear
weight and columns 1: the factor vector, plus the global bias ``w0`` —
held by :class:`FmModel`.  For field-aware FM (``field_num = P > 0``)
a row is ``1 + P*k`` wide, the factor vector of each field in turn, and
the interaction uses per-field factors ``<v_{i,f_j}, v_{j,f_i}> x_i x_j``
(:func:`ffm_scores_from_rows`).  Padded feature slots carry ``val == 0``
and contribute nothing.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.ops import interaction, quant
from fast_tffm_tpu_torch.platform import resolve_device

__all__ = [
    "FmModel", "example_losses", "ffm_scores_from_rows", "fm_scores",
    "fm_scores_dequant", "gather_dequant", "init_params",
    "interaction_terms", "l2_penalty_batch", "l2_penalty_full",
    "scores_from_rows",
    "scores_from_terms",
]


class FmModel(nn.Module):
    """``w0 []`` global bias and ``table [vocab, D]`` rows, float32."""

    def __init__(self, w0: torch.Tensor, table: torch.Tensor):
        super().__init__()
        if w0.dim() != 0 or table.dim() != 2:
            raise ValueError(
                f"FmModel wants w0 [] and table [vocab, D], got "
                f"{tuple(w0.shape)} and {tuple(table.shape)}"
            )
        self.w0 = nn.Parameter(w0.to(torch.float32))
        self.table = nn.Parameter(table.to(torch.float32))

    def forward(self, ids: torch.Tensor, vals: torch.Tensor,
                fields: Optional[torch.Tensor] = None, *,
                factor_num: int = 0, field_num: int = 0) -> torch.Tensor:
        return fm_scores(self, ids, vals, fields, factor_num=factor_num,
                         field_num=field_num)


def init_params(
    cfg: FmConfig,
    generator: torch.Generator,
    device: Optional[Union[str, torch.device]] = None,
) -> FmModel:
    """Uniform table init in ±``init_value_range``, ``w0 = 0`` (the
    reference's init; the numbers differ from JAX's threefry draw).
    ``generator`` must live on the resolved device."""
    dev = resolve_device(device)
    r = cfg.init_value_range
    table = torch.empty(
        (cfg.vocabulary_size, cfg.embedding_dim), dtype=torch.float32,
        device=dev,
    )
    table.uniform_(-r, r, generator=generator)
    return FmModel(torch.zeros((), dtype=torch.float32, device=dev), table)


def interaction_terms(rows: torch.Tensor, vals: torch.Tensor):
    """Per-example ``(linear [B], s1 [B, k], s2 [B, k])`` partial sums,
    f32 — linear in per-feature contributions, so they can be summed
    over row shards before :func:`scores_from_terms` squares them."""
    rows = rows.float()
    vals = vals.float()
    xv = rows[..., 1:] * vals[..., None]
    linear = (rows[..., 0] * vals).sum(dim=-1)
    return linear, xv.sum(dim=1), (xv * xv).sum(dim=1)


def scores_from_terms(w0, linear, s1, s2) -> torch.Tensor:
    return w0 + linear + 0.5 * (s1 * s1 - s2).sum(dim=-1)


def ffm_scores_from_rows(w0: torch.Tensor, rows: torch.Tensor,
                         vals: torch.Tensor, fields: torch.Tensor,
                         factor_num: int, field_num: int,
                         compute_dtype=torch.float32) -> torch.Tensor:
    """Field-aware FM scores ``[B]`` f32 from gathered rows
    ``[B, F, 1 + P*k]``: ``w0 + sum_i w_i x_i + sum_{i<j} <v_i^{f_j},
    v_j^{f_i}> x_i x_j`` in the field-grouped form (two einsums over
    ``[B, P, P, k]``, ``ops.interaction.ffm_forward``), differentiable
    by autograd (the closed form is ``ops.interaction.FfmInteraction``)."""
    return w0.float() + interaction.ffm_forward(
        rows, vals, fields, factor_num, field_num, compute_dtype)


def scores_from_rows(w0: torch.Tensor, rows: torch.Tensor,
                     vals: torch.Tensor,
                     fields: Optional[torch.Tensor] = None, *,
                     factor_num: int = 0,
                     field_num: int = 0, impl: str = "pallas") -> torch.Tensor:
    """Scores ``[B]`` f32 from gathered rows ``[B, F, D]``: the FM
    interaction through the formulation ``impl`` names
    (``ops.interaction.forward``: ``"pallas"``, the FmScorer kernel on the
    GPU; ``"jnp"``, its plain version; ``"flat"``) plus ``w0``, or with
    ``field_num > 0`` :func:`ffm_scores_from_rows` on ``fields``, which
    ignores ``impl`` (the reference's)."""
    if field_num:
        if fields is None:
            raise ValueError("field-aware FM scores need fields")
        return ffm_scores_from_rows(w0, rows.float(), vals.float(), fields,
                                    factor_num, field_num)
    scores, _ = interaction.forward(rows.float().contiguous(),
                                    vals.float().contiguous(), impl)
    return w0.float() + scores


def fm_scores(model: FmModel, ids: torch.Tensor, vals: torch.Tensor,
              fields: Optional[torch.Tensor] = None, *,
              factor_num: int = 0, field_num: int = 0,
              impl: str = "pallas") -> torch.Tensor:
    """Gather + score: ``ids [B, F]`` int, ``vals [B, F]`` (and
    ``fields [B, F]`` with ``field_num > 0``) -> ``[B]``, the interaction
    through ``impl`` (:func:`scores_from_rows`).  Ids must lie in ``[0,
    vocab)`` (on the GPU an id outside it is a device-side assert, not a
    clamp)."""
    d = model.table.shape[1]
    rows = model.table.index_select(0, ids.reshape(-1))
    return scores_from_rows(model.w0, rows.view(*ids.shape, d), vals,
                            fields, factor_num=factor_num,
                            field_num=field_num, impl=impl)


def gather_dequant(codes: torch.Tensor, scales: torch.Tensor, chunk: int,
                   ids: torch.Tensor,
                   global_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 rows ``[N, D]`` of an int8 table at the flat ``ids``: the codes
    ``codes[ids]`` widened by their scales ``scales[global_ids // chunk]``
    (``scales[global_ids]`` for ``chunk <= 1``).  ``global_ids`` (default
    ``ids``) are the rows' ids in the whole table where ``codes`` holds
    one model shard of it: the scales are indexed by the global row,
    never the shard's local one."""
    g = ids if global_ids is None else global_ids
    code_rows = codes.index_select(0, ids)
    scale_rows = scales.index_select(0, g // chunk if chunk > 1 else g)
    return quant.dequant_gathered(code_rows, scale_rows)


def fm_scores_dequant(w0: torch.Tensor, codes: torch.Tensor,
                      scales: torch.Tensor, chunk: int, ids: torch.Tensor,
                      vals: torch.Tensor,
                      fields: Optional[torch.Tensor] = None, *,
                      factor_num: int = 0,
                      field_num: int = 0,
                      impl: str = "pallas") -> torch.Tensor:
    """Scores over an int8-quantized table (``codes`` int8 ``[V, D]``,
    ``scales`` f32 ``[ceil(V / chunk)]``): gather the codes and each
    row's scale (``scales[ids // chunk]``, or ``scales[ids]`` for
    ``chunk <= 1``), widen them (``quant.dequant_gathered``), then
    :func:`scores_from_rows` through ``impl`` (the FmScorer kernel on the
    GPU by default, or FFM's einsums).  The same math as
    :func:`fm_scores` on the dequantized table."""
    rows = gather_dequant(codes, scales, chunk, ids.reshape(-1))
    return scores_from_rows(w0, rows.view(*ids.shape, codes.shape[1]),
                            vals, fields, factor_num=factor_num,
                            field_num=field_num, impl=impl)


def example_losses(scores: torch.Tensor, labels: torch.Tensor,
                   loss_type: str) -> torch.Tensor:
    """Per-example loss: logistic (stable BCE with logits, labels in
    {0, 1}: ``softplus(s) - y*s``) or squared error."""
    if loss_type == "logistic":
        return torch.logaddexp(scores, torch.zeros_like(scores)) \
            - labels * scores
    if loss_type == "mse":
        d = scores - labels
        return d * d
    raise ValueError(f"unknown loss_type {loss_type!r}")


def l2_penalty_batch(w0: torch.Tensor, rows: torch.Tensor,
                     vals: torch.Tensor, factor_lambda: float,
                     bias_lambda: float) -> torch.Tensor:
    """Sparse-friendly L2 (``l2_mode = batch``): only the rows the batch
    touched (``vals != 0``), per occurrence, normalised by batch size."""
    mask = (vals != 0).to(rows.dtype)[..., None]  # [B, F, 1]
    b = vals.shape[0]
    w_sq = torch.sum((rows[..., :1] * mask) ** 2)
    v_sq = torch.sum((rows[..., 1:] * mask) ** 2)
    return (factor_lambda * v_sq + bias_lambda * (w_sq + w0 ** 2)) / b


def l2_penalty_full(w0: torch.Tensor, table: torch.Tensor,
                    factor_lambda: float, bias_lambda: float) -> torch.Tensor:
    """The exact dense L2 (``l2_mode = full``, the upstream fast_tffm's
    ``tf.nn.l2_loss`` over the whole table): ``factor_lambda * sum v^2 +
    bias_lambda * (sum w^2 + w0^2)`` over every row, not divided by the
    batch size.  The dense step adds its gradient in closed form
    (``train/dense.py``)."""
    w_sq = torch.sum(table[:, 0] ** 2)
    v_sq = torch.sum(table[:, 1:] ** 2)
    return factor_lambda * v_sq + bias_lambda * (w_sq + w0 ** 2)
