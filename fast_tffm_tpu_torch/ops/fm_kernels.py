"""FmScorer forward on the GPU — the counterpart of ``ops/fm_pallas.py``.

- :func:`fm_scores_cuda` is the wrapper of the hand-written CUDA kernel
  in ``csrc/fm_scorer.cu`` (which replaces the Pallas kernel
  ``fast_tffm_tpu/ops/fm_pallas.py::_fwd_kernel``).  It checks its
  inputs the same way on every device and raises on anything the kernel
  does not take.  A CUDA tensor always launches the kernel; only a
  tensor that lies on the CPU takes the plain version.
  ``fm_scores_cuda.launches`` counts kernel launches.
- :func:`fm_scores_plain` is the same function in plain PyTorch,
  written from ``fast_tffm_tpu/ops/interaction.py::_scores_jnp``: the
  CPU path, and the reference the kernel is held to on the card.

Both take gathered rows ``[B, F, D]`` (column 0 the linear weight) and
values ``[B, F]`` and return ``(scores [B], s1 [B, D-1])`` in float32.
"""

from __future__ import annotations

import torch

from fast_tffm_tpu_torch.ops import _build

__all__ = ["fm_scores_cuda", "fm_scores_plain"]

_INT32_MAX = 2**31 - 1


def fm_scores_plain(rows: torch.Tensor, vals: torch.Tensor):
    """Plain PyTorch FmScorer forward (any device, f32 accumulation)."""
    rows = rows.float()
    vals = vals.float()
    w = rows[..., 0]
    v = rows[..., 1:]
    xv = v * vals[..., None]
    s1 = xv.sum(dim=1)
    s2 = (xv * xv).sum(dim=1)
    linear = (w * vals).sum(dim=-1)
    return linear + 0.5 * (s1 * s1 - s2).sum(dim=-1), s1


def _check(rows: torch.Tensor, vals: torch.Tensor) -> None:
    if rows.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(
            f"fm_scores_cuda takes float32 rows and vals, got "
            f"{rows.dtype} and {vals.dtype}"
        )
    if rows.dim() != 3 or vals.dim() != 2 or rows.shape[:2] != vals.shape:
        raise ValueError(
            f"fm_scores_cuda takes rows [B, F, D] and vals [B, F], got "
            f"{tuple(rows.shape)} and {tuple(vals.shape)}"
        )
    if rows.shape[2] < 1 or rows.numel() > _INT32_MAX:
        raise ValueError(
            f"fm_scores_cuda needs D >= 1 and fewer than 2^31 row "
            f"elements, got rows {tuple(rows.shape)}"
        )
    if rows.device.type not in ("cuda", "cpu") or vals.device != rows.device:
        raise ValueError(
            f"fm_scores_cuda takes CUDA (or CPU) tensors on one device, "
            f"got {rows.device} and {vals.device}"
        )
    if not (rows.is_contiguous() and vals.is_contiguous()):
        raise ValueError("fm_scores_cuda takes contiguous rows and vals")


def fm_scores_cuda(rows: torch.Tensor, vals: torch.Tensor):
    """FmScorer forward through the CUDA kernel, on the current stream
    (does not synchronise); CPU tensors take :func:`fm_scores_plain`."""
    _check(rows, vals)
    if rows.device.type == "cpu":
        return fm_scores_plain(rows, vals)
    b, f, d = rows.shape
    scores = torch.empty((b,), dtype=torch.float32, device=rows.device)
    s1 = torch.empty((b, d - 1), dtype=torch.float32, device=rows.device)
    if b == 0:
        return scores, s1
    lib = _build.load()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.fm_scores_fwd(
            rows.data_ptr(), vals.data_ptr(), scores.data_ptr(),
            s1.data_ptr(), b, f, d, stream,
        )
    if err:
        raise RuntimeError(
            "fm_scores_fwd launch failed: "
            + lib.fm_kernels_error_string(err).decode()
        )
    fm_scores_cuda.launches += 1
    return scores, s1


fm_scores_cuda.launches = 0
