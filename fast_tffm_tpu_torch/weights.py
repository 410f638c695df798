"""Hand parameters between the JAX package and the port as numpy arrays.

``from_jax`` takes what ``np.asarray`` gives for a JAX ``FmParams``'
``w0`` and ``table`` and builds an :class:`FmModel`; ``to_numpy`` is
the reverse.  ``opt_state_from_jax`` carries the JAX sparse optimizer
state (``SparseAdagradState`` / ``SparseFtrlState``, or their leaves
as numpy arrays) into the port's.  ``quant_from_jax`` carries a JAX
``QuantTable`` over through its npz arrays.  ``shard_rows`` cuts a table (numpy
or torch) to one rank's model shard and ``unshard_rows`` joins the
shards again.  Neither package imports the other: the arrays are the
whole interface.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.ops import quant
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.train.sparse import SparseAdagradState, SparseFtrlState

__all__ = ["from_jax", "opt_state_from_jax", "quant_from_jax", "shard_rows",
           "to_numpy", "unshard_rows"]


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


def opt_state_from_jax(optimizer: str, state,
                       device: Optional[Union[str, torch.device]] = None):
    """The port's sparse optimizer state from the JAX package's: any
    object with the attribute layout of its ``SparseAdagradState``
    (``.acc.w0``, ``.acc.table``) or ``SparseFtrlState`` (``.z.*``,
    ``.n.*``) whose leaves ``np.asarray`` turns into float32 arrays;
    ``()`` for SGD."""
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.array(a, np.float32, copy=True)).to(dev)

    if optimizer == "adagrad":
        return SparseAdagradState(put(state.acc.w0), put(state.acc.table))
    if optimizer == "ftrl":
        return SparseFtrlState(put(state.z.w0), put(state.z.table),
                               put(state.n.w0), put(state.n.table))
    if optimizer == "sgd":
        return ()
    raise ValueError(f"no sparse optimizer state for {optimizer!r}")


def quant_from_jax(qt) -> quant.QuantTable:
    """The port's :class:`~fast_tffm_tpu_torch.ops.quant.QuantTable` from
    the JAX package's (``dtype``, ``chunk``, ``codes``, ``scales`` and
    ``descriptor()``), through the arrays its ``table_to_arrays`` writes
    to ``quant.npz``: bf16 codes travel as their uint16 bits."""
    codes = np.asarray(qt.codes)
    arrays = {"codes": codes.view(np.uint16) if qt.dtype == "bf16"
              else codes}
    if qt.scales is not None:
        arrays["scales"] = np.asarray(qt.scales, np.float32)
    return quant.table_from_arrays(qt.descriptor(), arrays)


def shard_rows(table, mesh, rank: int):
    """The rows of ``table [vocab, ...]`` that ``rank`` holds on
    ``mesh`` (a :class:`~fast_tffm_tpu_torch.parallel.mesh.Mesh`):
    model shard ``rank % mesh.model``, ``vocab // mesh.model`` rows."""
    local = table.shape[0] // mesh.model
    lo = (rank % mesh.model) * local
    return table[lo:lo + local]


def unshard_rows(shards):
    """The full table from its model shards, in model-axis order (numpy
    arrays or tensors)."""
    shards = list(shards)
    if isinstance(shards[0], torch.Tensor):
        return torch.cat(shards, dim=0)
    return np.concatenate(shards, axis=0)
