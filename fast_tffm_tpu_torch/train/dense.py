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
kernel; the port runs the trainer's interaction here as on every path
(``interaction_impl``: its kernels by default), held to the same math.  Nothing in the step reads the device from the host, so with
the host sort meta a CUDA graph captures it as it does the sparse step
(``train/dispatch.py``).

On a rank mesh, :func:`dense_step_sharded` is the counterpart of the
reference's GSPMD partition of the same step (``fast_tffm_tpu/parallel/
mesh.py::param_sharding``: the table and its optimizer state row-sharded
over ``model``, replicated over ``data``; the batch split over
``data``).  Each rank takes the sharded step's row gradients
(``train/shardmap_step.py::shard_row_grads``: partial terms, one sum
over ``model``, the closed-form backward at its own rows), places them
into its shard's ``[vocab_local, D]`` gradient (K1's merge mode and
K-place over the shard's local ids, the off-shard sentinel left out),
sums that over ``data``, adds ``l2_mode = full``'s term on its shard
and applies the optimizer to it.  ``w0``'s gradient is summed over
``data`` and applied on every rank, and so is Adam's step count: each
rank advances it once a step, so the bias corrections stay replicated.
It runs eagerly, as the sharded sparse step does.

With ``compute_dtype = bfloat16`` the mesh's dense step rounds as the
sharded step does, which is how the reference's dense ``jnp`` forward
rounds the products (``fast_tffm_tpu/models/fm.py::interaction_terms``),
with one difference: ``w0`` stays f32, as in the port's one-device
dense step, where the reference adds ``w0`` rounded to bf16
(``scores_from_rows``), so each score differs from the reference's by
that rounding (``|w0|·2^-9`` at most).  The backward is the f32
closed form on the bf16-rounded rows, where the reference
differentiates its bf16 forward (its ``dw0`` and row gradients come
back rounded to bf16): within ``tests/test_bf16.py``'s gradient bound
(``tests/test_torch_mesh_modes.py`` holds both, step by step).
"""

from __future__ import annotations

import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.libsvm import Batch
from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, psum,
)
from fast_tffm_tpu_torch.train.optimizers import apply_dense
from fast_tffm_tpu_torch.train.shardmap_step import (
    health_pair, health_terms, shard_row_grads, w0_grad,
)
from fast_tffm_tpu_torch.train.sparse import grad_health, row_grads

__all__ = ["dense_step", "dense_step_sharded"]


def _add_full_l2(cfg: FmConfig, w0, table, dw0, dtable):
    """``l2_mode = full``'s gradient in closed form: ``2 lambda`` times
    the table added to ``dtable`` in place (column 0 under
    ``bias_lambda``, the factors under ``factor_lambda``), and ``2
    bias_lambda w0`` to ``dw0``, which is returned."""
    if cfg.l2_mode != "full" or not (cfg.factor_lambda or cfg.bias_lambda):
        return dw0
    # Filled on the device, not copied from the host: a CUDA graph of
    # the step holds no host-to-device copy.
    lam = torch.full((table.shape[1],), 2 * cfg.factor_lambda,
                     device=table.device)
    lam[:1].fill_(2 * cfg.bias_lambda)
    dtable.addcmul_(table, lam)
    return dw0 + 2 * cfg.bias_lambda * w0


def dense_step(cfg: FmConfig, model: FmModel, opt_state, batch: Batch,
               plain: bool = False, health: bool = False,
               impl: str = "pallas"):
    """One dense train step on a device :class:`Batch`: updates ``model``
    and ``opt_state`` in place and returns the step's raw scores
    ``[B]``, and with ``health`` also the ``train/sparse.py::
    grad_health`` pair of the whole gradient it applied (the reference's
    ``_tree_grad_health``: more passes over the ``[V, D]`` gradient).
    The batch's ``sort_meta`` is used when present, else the ids are
    sorted on the device.  ``impl`` is the interaction's formulation
    (``train/sparse.py::rows_loss``), its one selector; ``plain=True``
    runs the dense gradient's plain versions (K1's merge mode and
    K-place) on any device."""
    table = model.table
    scores, dw0, drows = row_grads(cfg, model, batch, impl)
    with torch.no_grad():
        dtable = sparse_apply.dense_grad(batch.ids, drows, table.shape[0],
                                         meta=batch.sort_meta, plain=plain)
        dw0 = _add_full_l2(cfg, model.w0, table, dw0, dtable)
        pair = grad_health(dtable, dw0) if health else None
        apply_dense(cfg, model, opt_state, dw0, dtable)
    return (scores, pair) if health else scores


def dense_step_sharded(cfg: FmConfig, model_l: FmModel, opt_state_l,
                       batch_l: Batch, mesh: Mesh, health: bool = False):
    """One dense step on this rank of ``mesh``: ``model_l`` and
    ``opt_state_l`` hold the rank's model shard (``w0``, its optimizer
    scalars and Adam's count replicated), ``batch_l`` its data block on
    the rank's device.  Updates both in place and returns the block's
    raw scores ``[b]``, and with ``health`` the global ``grad_health``
    pair of the whole gradient: the shard's gradient is already summed
    over ``data``, so its squares and non-finite count are summed over
    ``model`` (one sum of two numbers), and ``dw0`` is global.
    Every rank calls it in lockstep."""
    grads = shard_row_grads(cfg, model_l, batch_l, mesh)
    table_l = model_l.table
    with torch.no_grad():
        w0 = model_l.w0.detach()
        meta = sparse_apply.sort_meta(grads.lids,
                                      drop_from=grads.vocab_local)
        dtable = sparse_apply.dense_grad(grads.lids, grads.drows,
                                         grads.vocab_local, meta=meta)
        dtable = psum(dtable, DATA_AXIS, mesh)
        dw0 = _add_full_l2(cfg, w0, table_l, w0_grad(cfg, w0, grads.g, mesh),
                           dtable)
        pair = (health_pair(psum(health_terms(dtable), MODEL_AXIS, mesh),
                            dw0) if health else None)
        apply_dense(cfg, model_l, opt_state_l, dw0, dtable)
    return (grads.scores, pair) if health else grads.scores
