"""FM interaction op with a closed-form backward (the counterpart of
``fast_tffm_tpu/ops/interaction.py``: ``_forward`` and the
``jax.custom_vjp`` of ``fm_interaction``).

The port has no implementation choice on the main path: a CUDA tensor
always goes to the hand-written kernels (which raise on anything they do
not take), a CPU tensor to the plain PyTorch versions, both through the
kernels' wrappers.  ``plain=True`` runs the plain versions on any
device; only the tests and ``chip_smoke.py`` ask for it, to hold the
kernels against them on the card.
"""

from __future__ import annotations

import torch

from fast_tffm_tpu_torch.ops import fm_kernels

__all__ = ["FmInteraction", "fm_interaction", "forward"]


def forward(rows: torch.Tensor, vals: torch.Tensor):
    """``(scores [B], s1 [B, D-1])`` f32 from gathered rows
    ``[B, F, D]`` and values ``[B, F]`` (scores without w0)."""
    return fm_kernels.fm_scores_cuda(rows, vals)


class FmInteraction(torch.autograd.Function):
    """Scores ``[B]`` (without w0), differentiable with respect to
    ``rows`` only: feature values are data.  The forward saves
    ``(rows, vals, s1)``; the backward is the closed-form FmGrad, whose
    ``drows`` has the rows' type (bf16 in the bf16-input mode, as the
    reference's cotangent matches its primal)."""

    @staticmethod
    def forward(ctx, rows, vals, plain=False):
        if plain:
            scores, s1 = fm_kernels.fm_scores_plain(rows, vals)
        else:
            scores, s1 = fm_kernels.fm_scores_cuda(rows, vals)
        ctx.save_for_backward(rows, vals, s1)
        ctx.plain = plain
        return scores

    @staticmethod
    def backward(ctx, dscores):
        rows, vals, s1 = ctx.saved_tensors
        grad = fm_kernels.fm_grad_plain if ctx.plain else fm_kernels.fm_grad_cuda
        return grad(rows, vals, s1, dscores.contiguous()), None, None


def fm_interaction(rows: torch.Tensor, vals: torch.Tensor,
                   plain: bool = False) -> torch.Tensor:
    """Per-example f32 FM scores (without w0) from gathered rows
    ``[B, F, D]`` and values ``[B, F]``, through :class:`FmInteraction`.
    The values take the rows' type: float32 rows run the kernels' f32
    mode, bfloat16 rows (``compute_dtype = bfloat16``) their bf16-input
    mode."""
    return FmInteraction.apply(rows.contiguous(),
                               vals.to(rows.dtype).contiguous(), plain)
