"""FmScorer forward and FmGrad backward on the GPU — the counterpart of
``ops/fm_pallas.py``, in both of its modes.

- :func:`fm_scores_cuda` is the wrapper of the hand-written CUDA kernel
  in ``csrc/fm_scorer.cu`` (which replaces the Pallas kernel
  ``fast_tffm_tpu/ops/fm_pallas.py::_fwd_kernel``).  It checks its
  inputs the same way on every device and raises on anything the kernel
  does not take.  A CUDA tensor always launches the kernel; only a
  tensor that lies on the CPU takes the plain version.
  ``fm_scores_cuda.launches`` counts the f32 mode's kernel launches,
  ``fm_scores_cuda.launches_bf16`` the bf16 mode's.
- :func:`fm_scores_plain` is the same function in plain PyTorch,
  written from ``fast_tffm_tpu/ops/interaction.py::_scores_jnp``: the
  CPU path, and the reference the kernel is held to on the card.
- :func:`fm_grad_cuda` / :func:`fm_grad_plain` are the same pair for the
  closed-form backward (``csrc/fm_grad.cu``, replacing ``_bwd_kernel``).

The forward takes gathered rows ``[B, F, D]`` (column 0 the linear
weight) and values ``[B, F]`` and returns ``(scores [B], s1 [B, D-1])``;
the backward takes those plus ``dscores [B]`` and returns
``drows [B, F, D]``.  Rows and values are both float32 or both bfloat16
(the reference's bf16-input mode, ``compute_dtype = bfloat16``): the
kernels widen bf16 to f32 as they load it and compute in f32, scores,
``s1`` and ``dscores`` are f32 in both modes, and ``drows`` comes back in
the rows' type.
"""

from __future__ import annotations

import torch

from fast_tffm_tpu_torch.ops import _build

__all__ = ["fm_grad_cuda", "fm_grad_plain", "fm_scores_cuda",
           "fm_scores_plain"]

_INT32_MAX = 2**31 - 1
_DTYPES = (torch.float32, torch.bfloat16)


def fm_scores_plain(rows: torch.Tensor, vals: torch.Tensor):
    """Plain PyTorch FmScorer forward (any device, f32 accumulation; bf16
    inputs are widened first)."""
    rows = rows.float()
    vals = vals.float()
    w = rows[..., 0]
    v = rows[..., 1:]
    xv = v * vals[..., None]
    s1 = xv.sum(dim=1)
    s2 = (xv * xv).sum(dim=1)
    linear = (w * vals).sum(dim=-1)
    return linear + 0.5 * (s1 * s1 - s2).sum(dim=-1), s1


def _check(rows: torch.Tensor, vals: torch.Tensor,
           name: str = "fm_scores_cuda") -> None:
    if rows.dtype not in _DTYPES or vals.dtype != rows.dtype:
        raise TypeError(
            f"{name} takes rows and vals both float32 or both bfloat16, "
            f"got {rows.dtype} and {vals.dtype}"
        )
    if rows.dim() != 3 or vals.dim() != 2 or rows.shape[:2] != vals.shape:
        raise ValueError(
            f"{name} takes rows [B, F, D] and vals [B, F], got "
            f"{tuple(rows.shape)} and {tuple(vals.shape)}"
        )
    if rows.shape[2] < 1 or rows.numel() > _INT32_MAX:
        raise ValueError(
            f"{name} needs D >= 1 and fewer than 2^31 row "
            f"elements, got rows {tuple(rows.shape)}"
        )
    if rows.device.type not in ("cuda", "cpu") or vals.device != rows.device:
        raise ValueError(
            f"{name} takes CUDA (or CPU) tensors on one device, "
            f"got {rows.device} and {vals.device}"
        )
    if not (rows.is_contiguous() and vals.is_contiguous()):
        raise ValueError(f"{name} takes contiguous rows and vals")


def _raise_on(err: int, lib, entry: str) -> None:
    if err:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.fm_kernels_error_string(err).decode())


def fm_scores_cuda(rows: torch.Tensor, vals: torch.Tensor):
    """FmScorer forward through the CUDA kernel of the inputs' type, on
    the current stream (does not synchronise); CPU tensors take
    :func:`fm_scores_plain`."""
    _check(rows, vals)
    if rows.device.type == "cpu":
        return fm_scores_plain(rows, vals)
    b, f, d = rows.shape
    scores = torch.empty((b,), dtype=torch.float32, device=rows.device)
    s1 = torch.empty((b, d - 1), dtype=torch.float32, device=rows.device)
    if b == 0:
        return scores, s1
    bf16 = rows.dtype == torch.bfloat16
    entry = "fm_scores_fwd_bf16" if bf16 else "fm_scores_fwd"
    lib = _build.load()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = getattr(lib, entry)(
            rows.data_ptr(), vals.data_ptr(), scores.data_ptr(),
            s1.data_ptr(), b, f, d, stream,
        )
    _raise_on(err, lib, entry)
    if bf16:
        fm_scores_cuda.launches_bf16 += 1
    else:
        fm_scores_cuda.launches += 1
    return scores, s1


fm_scores_cuda.launches = 0
fm_scores_cuda.launches_bf16 = 0


def fm_grad_plain(rows: torch.Tensor, vals: torch.Tensor, s1: torch.Tensor,
                  dscores: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch FmGrad backward (any device), written from
    ``fast_tffm_tpu/ops/interaction.py::_grads_jnp``: ``drows [B, F, D]``
    with ``dw = g·x`` and ``dv_k = g·x·(s1_k − v_k·x)``, computed in f32
    and returned in the rows' type."""
    in_dtype = rows.dtype
    rows = rows.float()
    vals = vals.float()
    gx = (dscores[:, None] * vals)[..., None]  # [B, F, 1]
    dv = gx * (s1[:, None, :] - rows[..., 1:] * vals[..., None])
    return torch.cat([gx, dv], dim=-1).to(in_dtype)


def _check_grad(rows, vals, s1, dscores) -> None:
    _check(rows, vals, "fm_grad_cuda")
    b, _, d = rows.shape
    if s1.dtype != torch.float32 or dscores.dtype != torch.float32:
        raise TypeError(
            f"fm_grad_cuda takes float32 s1 and dscores, got {s1.dtype} "
            f"and {dscores.dtype}"
        )
    if tuple(s1.shape) != (b, d - 1) or tuple(dscores.shape) != (b,):
        raise ValueError(
            f"fm_grad_cuda takes s1 [B, D-1] and dscores [B] for rows "
            f"{tuple(rows.shape)}, got {tuple(s1.shape)} and "
            f"{tuple(dscores.shape)}"
        )
    if s1.device != rows.device or dscores.device != rows.device:
        raise ValueError(
            f"fm_grad_cuda takes all tensors on one device, got rows on "
            f"{rows.device}, s1 on {s1.device}, dscores on {dscores.device}"
        )
    if not (s1.is_contiguous() and dscores.is_contiguous()):
        raise ValueError("fm_grad_cuda takes contiguous s1 and dscores")


def fm_grad_cuda(rows: torch.Tensor, vals: torch.Tensor, s1: torch.Tensor,
                 dscores: torch.Tensor) -> torch.Tensor:
    """FmGrad backward through the CUDA kernel of the inputs' type in
    ``csrc/fm_grad.cu`` (replaces ``fast_tffm_tpu/ops/fm_pallas.py::
    _bwd_kernel``), on the current stream; CPU tensors take
    :func:`fm_grad_plain`.  ``fm_grad_cuda.launches`` and
    ``fm_grad_cuda.launches_bf16`` count each mode's kernel launches."""
    _check_grad(rows, vals, s1, dscores)
    if rows.device.type == "cpu":
        return fm_grad_plain(rows, vals, s1, dscores)
    b, f, d = rows.shape
    drows = torch.empty_like(rows)
    if drows.numel() == 0:
        return drows
    bf16 = rows.dtype == torch.bfloat16
    entry = "fm_grad_bwd_bf16" if bf16 else "fm_grad_bwd"
    lib = _build.load()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = getattr(lib, entry)(
            rows.data_ptr(), vals.data_ptr(), s1.data_ptr(),
            dscores.data_ptr(), drows.data_ptr(), b, f, d, stream,
        )
    _raise_on(err, lib, entry)
    if bf16:
        fm_grad_cuda.launches_bf16 += 1
    else:
        fm_grad_cuda.launches += 1
    return drows


fm_grad_cuda.launches = 0
fm_grad_cuda.launches_bf16 = 0
