"""Evaluation metrics: logloss and streaming AUC — the counterpart of
``fast_tffm_tpu/train/metrics.py``.

AUC uses a fixed-bin histogram over sigmoid scores (``DEFAULT_AUC_BINS``
bins, ``clip(int(sigmoid * bins))``), accumulated on the device across
batches without a host round trip (:func:`auc_add_`, in place, so that a
CUDA graph of the train step can hold it) and finalised by the
trapezoid rule.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from fast_tffm_tpu_torch.models.fm import example_losses

__all__ = [
    "DEFAULT_AUC_BINS", "AucState", "auc_add_", "auc_finalize", "auc_init",
    "weighted_loss",
]

DEFAULT_AUC_BINS = 1024


class AucState(NamedTuple):
    pos: torch.Tensor  # [bins] weighted positive counts per score bin
    neg: torch.Tensor  # [bins] weighted negative counts per score bin


def auc_init(bins: int = DEFAULT_AUC_BINS,
             device: Optional[Union[str, torch.device]] = None) -> AucState:
    return AucState(torch.zeros((bins,), dtype=torch.float32, device=device),
                    torch.zeros((bins,), dtype=torch.float32, device=device))


def auc_add_(state: AucState, scores: torch.Tensor, labels: torch.Tensor,
             weights: torch.Tensor) -> None:
    """Fold raw (pre-sigmoid) ``scores [B]`` with labels in {0, 1} and
    weights (0 = padded example) into the histogram, in place.  On the
    card ``index_add_`` sums with float atomics: exact for 0/1 weights,
    in any order; other weights may differ in the last bits between
    runs."""
    bins = state.pos.shape[0]
    p = torch.sigmoid(scores.float())
    idx = torch.clamp((p * bins).to(torch.int32), 0, bins - 1).long()
    wl = weights * labels
    state.pos.index_add_(0, idx, wl)
    state.neg.index_add_(0, idx, weights - wl)


def auc_finalize(state: AucState) -> torch.Tensor:
    """Trapezoidal AUC from the accumulated histogram (a 0-d tensor)."""
    pos_rev = torch.cumsum(state.pos.flip(0), 0)
    neg_rev = torch.cumsum(state.neg.flip(0), 0)
    zero = torch.zeros((1,), dtype=pos_rev.dtype, device=pos_rev.device)
    tp = torch.cat([zero, pos_rev])
    fp = torch.cat([zero, neg_rev])
    tpr = tp / torch.clamp(pos_rev[-1], min=1e-12)
    fpr = fp / torch.clamp(neg_rev[-1], min=1e-12)
    return torch.sum((fpr[1:] - fpr[:-1]) * 0.5 * (tpr[1:] + tpr[:-1]))


def weighted_loss(scores: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor, loss_type: str = "logistic"):
    """``(sum of weighted per-example losses, sum of weights)``: logloss
    on raw scores for logistic, squared error for mse — what training
    minimises (``cfg.loss_type``)."""
    per_ex = example_losses(scores, labels, loss_type)
    return torch.sum(per_ex * weights), torch.sum(weights)
