"""FM interaction forward dispatch (the counterpart of
``fast_tffm_tpu/ops/interaction.py::_forward``).

The port has no implementation choice: a CUDA tensor always goes to
the hand-written kernel (which raises on anything it does not take), a
CPU tensor to the plain PyTorch version, both through the kernel's
wrapper.  The closed-form backward (FmGrad) comes with training.
"""

from __future__ import annotations

import torch

from fast_tffm_tpu_torch.ops import fm_kernels

__all__ = ["forward"]


def forward(rows: torch.Tensor, vals: torch.Tensor):
    """``(scores [B], s1 [B, D-1])`` f32 from gathered rows
    ``[B, F, D]`` and values ``[B, F]`` (scores without w0)."""
    return fm_kernels.fm_scores_cuda(rows, vals)
