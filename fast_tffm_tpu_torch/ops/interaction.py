"""FM and field-aware FM interaction ops with closed-form backwards (the
counterpart of ``fast_tffm_tpu/ops/interaction.py``: ``_forward``, the
three formulations it dispatches to and the ``jax.custom_vjp`` of
``fm_interaction``; ``_ffm_parts`` and the ``jax.custom_vjp`` of
``ffm_interaction``).

The FM interaction has the reference's three dispatch names
(:func:`impl_name`; ``ops/autotune.py`` chooses among them, and so do
the ``interaction`` / ``use_pallas`` knobs):

- ``"pallas"``: the hand-written FmScorer / FmGrad kernels through their
  wrappers (``ops/fm_kernels.py``).  A CUDA tensor always launches the
  kernel (which raises on anything it does not take), a CPU tensor takes
  the kernel's plain version.
- ``"jnp"``: the reference's ``_scores_jnp`` / ``_grads_jnp``, which are
  the kernels' plain versions (``fm_kernels.fm_scores_plain`` /
  ``fm_grad_plain``), on any device.  The tests and ``chip_smoke.py``
  hold the kernels against it.
- ``"flat"``: the reference's ``_scores_flat`` / ``_grads_flat``
  (:func:`scores_flat`, :func:`grads_flat`): the rows as ``[B, F*D]``,
  the feature sums two f32 products with a one-hot ``[F*D, D]`` matrix
  (``torch.matmul``; the reference computes them with ``jax.lax.dot``
  at ``Precision.HIGHEST`` outside any Pallas kernel).  They need TF32
  off, PyTorch's default for a matrix product, which the port never
  turns on.

All three backwards are the closed forms, not autograd through the
forward; bf16 rows are widened to f32 in all three, and ``drows`` comes
back in the rows' type.

Field-aware FM has no kernel of its own: the reference computes it with
einsums outside any Pallas kernel, and so does the port, with
``torch.einsum`` in float32 (TF32 off, PyTorch's default for a matrix
product).  In bf16 compute the reference's TPU program rounds the rows
and values to bf16, rounds the products ``w * x`` and ``x * x``, and
contracts the rounded operands with f32 accumulation; the port rounds
the same operands and products and contracts them widened to f32
(a product of two bf16 values is exact in f32), on every device.
"""

from __future__ import annotations

import torch

from fast_tffm_tpu_torch.ops import fm_kernels

__all__ = ["FfmInteraction", "FmInteraction", "ffm_forward",
           "ffm_interaction", "fm_interaction", "forward", "grads_flat",
           "impl_name", "scores_flat"]

def impl_name(impl) -> str:
    """The dispatch name of ``impl``: ``True`` is ``"pallas"`` and
    ``False`` ``"jnp"`` (the legacy ``use_pallas`` surface), a name is
    itself; anything else raises (the reference's ``_impl_name``)."""
    if impl is True:
        return "pallas"
    if impl is False:
        return "jnp"
    if impl in _FORWARD:
        return impl
    raise ValueError(f"unknown interaction impl {impl!r}")


def _m_matrix(fd: int, d: int, device) -> torch.Tensor:
    """``M[c, c % d] = 1``, f32 ``[fd, d]``: sums row slot ``j`` across
    the features in one product."""
    c = torch.arange(fd, device=device)
    j = torch.arange(d, device=device)
    return (c[:, None] % d == j[None, :]).float()


def scores_flat(rows: torch.Tensor, vals: torch.Tensor):
    """The flat formulation's ``(scores [B], s1 [B, D-1])``, f32: the
    reference's ``_scores_flat`` (``xe`` repeats each value over its
    row's ``D`` slots; ``s`` and ``s2`` are the feature sums of ``y`` and
    ``y * y`` as products with :func:`_m_matrix`)."""
    b, f, d = rows.shape
    rows2 = rows.reshape(b, f * d).float()
    xe = vals.float().repeat_interleave(d, dim=1)  # xe[b, f*d+j] = x_f
    y = rows2 * xe
    m = _m_matrix(f * d, d, rows.device)
    s = torch.matmul(y, m)
    s2 = torch.matmul(y * y, m)
    s1 = s[:, 1:]
    inter = 0.5 * (s1 * s1 - s2[:, 1:]).sum(dim=-1)
    return s[:, 0] + inter, s1.contiguous()


def grads_flat(rows: torch.Tensor, vals: torch.Tensor, s1: torch.Tensor,
               dscores: torch.Tensor) -> torch.Tensor:
    """The flat formulation's closed-form ``drows [B, F, D]`` in the
    rows' type: the reference's ``_grads_flat``, ``g·xe·(s1e - y·maskv)``
    with ``s1e`` the row ``[1, s1]`` tiled over the features and
    ``maskv`` zero on the linear weight's slot."""
    in_dtype = rows.dtype
    b, f, d = rows.shape
    rows2 = rows.reshape(b, f * d).float()
    xe = vals.float().repeat_interleave(d, dim=1)
    y = rows2 * xe
    ones = torch.ones((b, 1), dtype=torch.float32, device=rows.device)
    s1e = torch.cat([ones, s1], dim=1).repeat(1, f)
    c = torch.arange(f * d, device=rows.device)
    maskv = (c % d != 0).float()  # kills the w column in y
    drows2 = (dscores[:, None] * xe) * (s1e - y * maskv)
    return drows2.reshape(b, f, d).to(in_dtype)


_FORWARD = {"pallas": fm_kernels.fm_scores_cuda,
            "jnp": fm_kernels.fm_scores_plain, "flat": scores_flat}
_BACKWARD = {"pallas": fm_kernels.fm_grad_cuda,
             "jnp": fm_kernels.fm_grad_plain, "flat": grads_flat}


def forward(rows: torch.Tensor, vals: torch.Tensor, impl="pallas"):
    """``(scores [B], s1 [B, D-1])`` f32 from gathered rows
    ``[B, F, D]`` and values ``[B, F]`` (scores without w0), through
    the formulation ``impl`` names (:func:`impl_name`)."""
    return _FORWARD[impl_name(impl)](rows, vals)


class FmInteraction(torch.autograd.Function):
    """Scores ``[B]`` (without w0), differentiable with respect to
    ``rows`` only: feature values are data.  The forward saves
    ``(rows, vals, s1)``; the backward is the closed form of the same
    ``impl`` (FmGrad for ``"pallas"``), whose ``drows`` has the rows'
    type (bf16 in the bf16-input mode, as the reference's cotangent
    matches its primal)."""

    @staticmethod
    def forward(ctx, rows, vals, impl="pallas"):
        impl = impl_name(impl)
        scores, s1 = _FORWARD[impl](rows, vals)
        ctx.save_for_backward(rows, vals, s1)
        ctx.impl = impl
        return scores

    @staticmethod
    def backward(ctx, dscores):
        rows, vals, s1 = ctx.saved_tensors
        return (_BACKWARD[ctx.impl](rows, vals, s1, dscores.contiguous()),
                None, None)


def fm_interaction(rows: torch.Tensor, vals: torch.Tensor,
                   impl="pallas") -> torch.Tensor:
    """Per-example f32 FM scores (without w0) from gathered rows
    ``[B, F, D]`` and values ``[B, F]``, through :class:`FmInteraction`.
    The values take the rows' type: float32 rows run the kernels' f32
    mode, bfloat16 rows (``compute_dtype = bfloat16``) their bf16-input
    mode."""
    return FmInteraction.apply(rows.contiguous(),
                               vals.to(rows.dtype).contiguous(), impl)


# ---------------------------------------------------- field-aware FM (FFM)
#
# With S[b, p, q, :] = sum_{i: f_i = p} v_i^q x_i (a batched one-hot
# product), the pairwise term is
#
#     sum_{i<j} <v_i^{f_j}, v_j^{f_i}> x_i x_j
#         = 0.5 (sum_{p,q} <S[p, q], S[q, p]> - sum_i |v_i^{f_i}|^2 x_i^2)
#
# and its closed-form row gradient reuses the saved S:
#
#     dv_i^q = g x_i (S[q, f_i] - [q = f_i] v_i^{f_i} x_i),  dw_i = g x_i.


def _one_hot(fields: torch.Tensor, field_num: int) -> torch.Tensor:
    """``[B, F, P]`` f32 one-hot of each occurrence's field.  A field
    outside ``[0, P)`` gets a zero row, as in the reference: no gather,
    so no device-side index."""
    p = torch.arange(field_num, dtype=fields.dtype, device=fields.device)
    return (fields[..., None] == p).float()


def _ffm_operands(rows, vals, fields, factor_num, field_num, compute_dtype):
    """``(rows_c, vals_c, v [B, F, P, k] f32, x [B, F] f32, one-hot)``:
    the rows and values rounded to ``compute_dtype`` and widened."""
    b, f = vals.shape
    rows_c = rows.to(compute_dtype)
    vals_c = vals.to(compute_dtype)
    v = rows_c[..., 1:].float().reshape(b, f, field_num, factor_num)
    return rows_c, vals_c, v, vals_c.float(), _one_hot(fields, field_num)


def _ffm_parts(rows, vals, fields, factor_num, field_num, compute_dtype):
    """``(linear [B], S [B, P, P, k], self term [B])``, f32: the
    reference's ``_ffm_parts`` operand for operand.  ``w * x`` and
    ``x * x`` are products in ``compute_dtype`` (rounded in bf16), the
    contractions f32."""
    rows_c, vals_c, v, x, oh = _ffm_operands(
        rows, vals, fields, factor_num, field_num, compute_dtype)
    linear = (rows_c[..., 0] * vals_c).float().sum(dim=-1)
    s = torch.einsum("bfp,bfqk->bpqk", oh * x[..., None], v)
    v_own = torch.einsum("bfq,bfqk->bfk", oh, v)  # v_i^{f_i}
    self_term = ((v_own * v_own).sum(dim=-1)
                 * (vals_c * vals_c).float()).sum(dim=-1)
    return linear, s, self_term


def _ffm_score(linear, s, self_term) -> torch.Tensor:
    cross = torch.einsum("bpqk,bqpk->b", s, s)
    return linear + 0.5 * (cross - self_term)


def _check_ffm(rows, vals, fields, factor_num, field_num) -> None:
    b, f = vals.shape
    want = (b, f, 1 + field_num * factor_num)
    if field_num < 1 or factor_num < 1 or tuple(rows.shape) != want:
        raise ValueError(
            f"field-aware FM wants rows {want} (1 + field_num * "
            f"factor_num columns), got {tuple(rows.shape)} with "
            f"field_num={field_num}, factor_num={factor_num}")
    if tuple(fields.shape) != (b, f):
        raise ValueError(f"fields {tuple(fields.shape)} != vals {(b, f)}")


def ffm_forward(rows: torch.Tensor, vals: torch.Tensor,
                fields: torch.Tensor, factor_num: int, field_num: int,
                compute_dtype=torch.float32) -> torch.Tensor:
    """Per-example f32 FFM scores (without w0) from gathered rows
    ``[B, F, 1 + P*k]``, values and fields ``[B, F]``, as plain
    differentiable tensor code (autograd derives its backward): the
    counterpart of the reference's ``models/fm.py::ffm_scores_from_rows``
    and the oracle of :class:`FfmInteraction`."""
    _check_ffm(rows, vals, fields, factor_num, field_num)
    return _ffm_score(*_ffm_parts(rows, vals, fields, factor_num, field_num,
                                  compute_dtype))


class FfmInteraction(torch.autograd.Function):
    """FFM scores ``[B]`` (without w0), differentiable with respect to
    ``rows`` only.  The forward saves ``(rows, vals, fields, S)``; the
    backward is the reference's closed form (``_ffm_bwd``), its operands
    rounded as the forward's, and gives ``drows`` in the rows' type (f32
    in training: the rows enter uncast, the casts are inside)."""

    @staticmethod
    def forward(ctx, rows, vals, fields, factor_num, field_num,
                compute_dtype):
        linear, s, self_term = _ffm_parts(rows, vals, fields, factor_num,
                                          field_num, compute_dtype)
        ctx.save_for_backward(rows, vals, fields, s)
        ctx.ffm = (factor_num, field_num, compute_dtype)
        return _ffm_score(linear, s, self_term)

    @staticmethod
    def backward(ctx, g):
        rows, vals, fields, s = ctx.saved_tensors
        factor_num, field_num, compute_dtype = ctx.ffm
        b, f = vals.shape
        _, _, v, x, oh = _ffm_operands(rows, vals, fields, factor_num,
                                       field_num, compute_dtype)
        v_own = torch.einsum("bfq,bfqk->bfk", oh, v)
        gx = g[:, None] * x  # [B, F]
        # T[b, f, q, :] = S[b, q, f_i, :]: S's second field axis taken at
        # each occurrence's own field, as a one-hot product.
        t = torch.einsum("bqpk,bfp->bfqk", s, oh)
        dv = gx[..., None, None] * (
            t - oh[..., None] * v_own[:, :, None, :] * x[..., None, None])
        drows = torch.cat([gx[..., None], dv.reshape(b, f, -1)], dim=-1)
        return drows.to(rows.dtype), None, None, None, None, None


def ffm_interaction(rows: torch.Tensor, vals: torch.Tensor,
                    fields: torch.Tensor, factor_num: int, field_num: int,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """Per-example f32 FFM scores (without w0) through
    :class:`FfmInteraction`.  ``compute_dtype = torch.bfloat16`` rounds
    the operands as the reference's TPU program does; accumulation and
    scores stay f32."""
    _check_ffm(rows, vals, fields, factor_num, field_num)
    return FfmInteraction.apply(rows, vals, fields, factor_num, field_num,
                                compute_dtype)
