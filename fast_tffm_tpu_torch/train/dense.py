"""Dense training step — the counterpart of ``fast_tffm_tpu/train/loop.py::
make_train_step`` (single device): the path of ``sparse_update = false``,
and of an optimizer or L2 the sparse step cannot apply row by row
(``optimizer = adam``, ``l2_mode = full`` with a lambda), where the
trainer sends the run as the reference does.

Per step:

1. the loss is differentiated with respect to ``w0`` and the gathered
   rows, as the sparse step does (``train/sparse.py::row_grads``: the
   FmScorer forward and FmGrad backward through ``FmInteraction``, in
   their bf16-input mode with ``compute_dtype = bfloat16``, or the FFM
   op), giving per-occurrence row gradients;
2. the dense table gradient ``[V, D]`` is their transpose of the gather
   (``ops/sparse_apply.py::dense_grad``: K1's merge mode over the batch's
   sort meta, then K-place), deterministic;
3. with ``l2_mode = full`` the gradient of ``models/fm.py::
   l2_penalty_full`` is added in closed form: ``2 bias_lambda w0`` to
   ``dw0``, ``2 lambda table`` to the table's (column 0 under
   ``bias_lambda``, the factors under ``factor_lambda``); its value,
   which no output reads, is not computed.  ``l2_mode = batch`` is in the
   loss as on the sparse path;
4. ``train/optimizers.py::apply_dense`` updates ``w0``, every row of the
   table and the optimizer state in place.

The reference's dense step scores through ``jnp``
(``fast_tffm_tpu/models/fm.py::loss_and_metrics``) and reaches no Pallas
kernel; the port runs its kernels here as on every path, held to the
same math.  Nothing in the step reads the device from the host, so with
the host sort meta a CUDA graph captures it as it does the sparse step
(``train/dispatch.py``).
"""

from __future__ import annotations

import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.libsvm import Batch
from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.train.optimizers import apply_dense
from fast_tffm_tpu_torch.train.sparse import row_grads

__all__ = ["dense_step"]


def dense_step(cfg: FmConfig, model: FmModel, opt_state, batch: Batch,
               plain: bool = False) -> torch.Tensor:
    """One dense train step on a device :class:`Batch`: updates ``model``
    and ``opt_state`` in place and returns the step's raw scores
    ``[B]``.  The batch's ``sort_meta`` is used when present, else the
    ids are sorted on the device.  ``plain=True`` runs the kernels'
    plain versions on any device."""
    table = model.table
    scores, dw0, drows = row_grads(cfg, model, batch, plain)
    with torch.no_grad():
        dtable = sparse_apply.dense_grad(batch.ids, drows, table.shape[0],
                                         meta=batch.sort_meta, plain=plain)
        if cfg.l2_mode == "full" and (cfg.factor_lambda or cfg.bias_lambda):
            # Filled on the device, not copied from the host: a CUDA
            # graph of the step holds no host-to-device copy.
            lam = torch.full((table.shape[1],), 2 * cfg.factor_lambda,
                             device=table.device)
            lam[:1].fill_(2 * cfg.bias_lambda)
            dtable.addcmul_(table, lam)
            dw0 = dw0 + 2 * cfg.bias_lambda * model.w0
        apply_dense(cfg, model, opt_state, dw0, dtable)
    return scores
