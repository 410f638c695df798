"""Dense optimizers — the counterpart of ``fast_tffm_tpu/train/optimizers.py``
(``make_optimizer``): the update the dense step (``train/dense.py``)
applies to ``(w0, table)``, every row of the table, each step.

The reference runs optax 0.2.6 and its own FTRL transformation; each
update here follows that code equation by equation (``g`` the gradient,
``p`` the parameter, ``lr`` the learning rate):

- **adagrad** (``optax.adagrad``: ``scale_by_rss``, then ``-lr``):
  ``acc += g*g``; ``u = g * where(acc > 0, rsqrt(acc + 1e-7), 0)``;
  ``p += -lr * u``.  ``acc`` starts at ``adagrad.initial_accumulator``;
  the ``where`` is optax's, so a zero accumulator gives a zero update.
- **ftrl** (the reference's ``ftrl``): ``n += g*g``, ``z += g - sigma *
  w``, ``w = ftrl_solve(z, n)`` on every row, touched or not
  (``ops.sparse_apply.ftrl_update``).
- **sgd** (``optax.sgd``): ``p += -lr * g``.
- **adam** (``optax.adam(lr)``: ``b1 = 0.9``, ``b2 = 0.999``, ``eps =
  1e-8``, ``eps_root = 0``, no nesterov): ``mu = (1-b1) g + b1 mu``,
  ``nu = (1-b2) g*g + b2 nu``, ``count += 1`` (saturating at the int32
  maximum), ``u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) +
  eps)``, ``p += -lr * u``.  ``w0`` has moments of its own; the count is
  shared.

Adagrad's and FTRL's state are the sparse step's types
(``train/sparse.py``): optax's ``sum_of_squares`` is the same
per-weight accumulator, FTRL's ``z`` and ``n`` the same recursion, so
either trainer warm-starts from the other's checkpoint.  SGD has none.
Adam's count is an int32 tensor on the parameters' device, and both bias
corrections are computed from it there: a CUDA graph of the step
replays them with each replay's count, where a Python count would be
frozen at the captured step's value.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.train.sparse import ADAGRAD_EPS, init_sparse_opt_state

__all__ = ["ADAM_B1", "ADAM_B2", "ADAM_EPS", "AdamState", "apply_dense",
           "init_dense_opt_state"]

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
_COUNT_MAX = torch.iinfo(torch.int32).max


class AdamState(NamedTuple):
    mu_w0: torch.Tensor  # [] first moment of w0
    mu_table: torch.Tensor  # [V, D]
    nu_w0: torch.Tensor  # [] second moment of w0
    nu_table: torch.Tensor  # [V, D]
    count: torch.Tensor  # [] int32 steps taken


def init_dense_opt_state(cfg: FmConfig, model: FmModel):
    """Fresh dense optimizer state beside ``model``'s tensors, on their
    device: Adam's zero moments and count, else the sparse step's state
    (optax's Adagrad and the reference's FTRL start the same way)."""
    if cfg.optimizer != "adam":
        return init_sparse_opt_state(cfg, model)
    with torch.no_grad():
        w0, table = model.w0.detach(), model.table.detach()
        return AdamState(torch.zeros_like(w0), torch.zeros_like(table),
                         torch.zeros_like(w0), torch.zeros_like(table),
                         torch.zeros((), dtype=torch.int32,
                                     device=table.device))


def _adagrad(p, g, acc, lr: float) -> None:
    acc.addcmul_(g, g)
    inv = torch.where(acc > 0, torch.rsqrt(acc + ADAGRAD_EPS), 0.0)
    p.addcmul_(g, inv, value=-lr)


def _adam(p, g, mu, nu, bc1, bc2, lr: float) -> None:
    mu.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
    nu.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
    den = (nu / bc2).sqrt_().add_(ADAM_EPS)
    p.addcdiv_(mu / bc1, den, value=-lr)


def apply_dense(cfg: FmConfig, model: FmModel, opt_state,
                dw0: torch.Tensor, dtable: torch.Tensor) -> None:
    """One update of ``model`` (``w0`` and every row of ``table``) and
    ``opt_state`` from the gradients ``dw0 []`` and ``dtable [V, D]``, in
    place (the reference's ``optimizer.update`` and ``p + u``)."""
    lr = cfg.learning_rate
    with torch.no_grad():
        leaves = ((model.w0, dw0), (model.table, dtable))
        if cfg.optimizer == "adagrad":
            for (p, g), acc in zip(leaves, opt_state):
                _adagrad(p, g, acc, lr)
        elif cfg.optimizer == "ftrl":
            z_n = ((opt_state.z_w0, opt_state.n_w0),
                   (opt_state.z_table, opt_state.n_table))
            for (p, g), (z, n) in zip(leaves, z_n):
                sparse_apply.ftrl_update(g, g * g, p, z, n, lr=lr,
                                         l1=cfg.ftrl_l1, l2=cfg.ftrl_l2,
                                         beta=cfg.ftrl_beta)
        elif cfg.optimizer == "sgd":
            for p, g in leaves:
                p.add_(g, alpha=-lr)
        elif cfg.optimizer == "adam":
            count = opt_state.count
            count.copy_(torch.where(count < _COUNT_MAX, count + 1, count))
            t = count.float()
            bc1, bc2 = 1 - ADAM_B1 ** t, 1 - ADAM_B2 ** t
            moments = ((opt_state.mu_w0, opt_state.nu_w0),
                       (opt_state.mu_table, opt_state.nu_table))
            for (p, g), (mu, nu) in zip(leaves, moments):
                _adam(p, g, mu, nu, bc1, bc2, lr)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
