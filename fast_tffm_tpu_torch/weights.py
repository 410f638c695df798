"""Hand parameters between the JAX package and the port as numpy arrays.

``from_jax`` takes what ``np.asarray`` gives for a JAX ``FmParams``'
``w0`` and ``table`` and builds an :class:`FmModel`; ``to_numpy`` is
the reverse.  Neither package imports the other: the arrays are the
whole interface.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.platform import resolve_device

__all__ = ["from_jax", "to_numpy"]


def from_jax(w0, table,
             device: Optional[Union[str, torch.device]] = None) -> FmModel:
    """``w0`` (a scalar) and ``table [vocab, D]`` -> an f32
    :class:`FmModel` on ``device`` (the GPU unless asked otherwise)."""
    dev = resolve_device(device)
    w0_t = torch.tensor(float(np.asarray(w0, np.float32)),
                        dtype=torch.float32)
    table_t = torch.from_numpy(np.array(table, np.float32, copy=True))
    if table_t.dim() != 2:
        raise ValueError(f"table must be [vocab, D], got {table_t.shape}")
    return FmModel(w0_t.to(dev), table_t.to(dev))


def to_numpy(model: FmModel):
    """``(w0, table)``: a 0-d float32 array and a ``[vocab, D]`` float32
    array on the host."""
    with torch.no_grad():
        w0 = np.asarray(model.w0.detach().cpu().numpy(), np.float32)
        table = np.ascontiguousarray(
            model.table.detach().cpu().numpy(), np.float32
        )
    return w0, table
