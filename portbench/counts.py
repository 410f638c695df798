"""The yardstick's arithmetic: the card's published peaks, a bound from
bytes and operations, and the work a training step and its four kernels
must do, counted from the shapes.

The peaks and :func:`bound` are a frozen copy of
``fast_tffm_tpu_torch/tools/bench_common.py`` (NVIDIA H100 SXM data
sheet, at the full 700 W power limit): HBM3 at 3.35 TB/s, float32
outside the tensor cores at 67 TFLOP/s.

A step of batch ``b`` with ``f`` feature slots (``n = b * f``
occurrences), rows of ``d = 1 + k`` floats and ``u`` unique ids:

- :func:`kernel_work`, the four kernels of the step together (FmScorer,
  FmGrad, K1, K2).  Each byte is counted once, at the first of the four
  to read it from HBM or the last to write it there: the values
  (FmScorer), the sort permutation, the ``u + 1`` segment starts and the
  ``u`` ids at them (K1), and the ``u`` rows of the table and of the
  accumulator, read and written (K2).  What an earlier op of the step
  has already brought through the 50 MB L2 is left out: the gathered
  rows, the scores and their gradient, FmGrad's row gradients, K1's
  sums and unique rows (a few MB at these sizes).
- :func:`step_work`, the whole step's required work: the batch's ids,
  values, labels, weights and sort meta read once, and the ``u`` rows of
  the table and of the accumulator read once and written once.

Operations are the float32 arithmetic the algorithm needs: FmScorer
``4k + 2`` an occurrence and ``3k + 2`` an example, FmGrad ``3k + 2`` an
occurrence, K1 ``3d`` an occurrence (``g``, ``g * g``, two adds), K2
Adagrad 6 a unique element; the whole step adds the loss and its
gradient (8 an example), the batch L2 (``2d`` an occurrence) and the
scalar ``w0`` update.
"""

from __future__ import annotations

__all__ = ["KERNELS", "PEAK_BYTES_PER_S", "PEAK_F32_FLOPS", "bound",
           "kernel_work", "step_work"]

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# The four kernels' CUDA names (``ops/csrc/fm_scorer.cu``, ``fm_grad.cu``,
# ``sparse_apply.cu``), as the profiler's kernel events carry them.
KERNELS = ("fm_scores_fwd_kernel", "fm_grad_bwd_kernel", "k1_kernel",
           "k2_kernel")


def bound(nbytes: float, ops: float) -> tuple:
    """``(seconds, "bytes" | "operations")``: the larger of the bytes over
    HBM bandwidth and the operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_ops(b: int, f: int, d: int, u: float) -> float:
    n, k = b * f, d - 1
    return (n * (4 * k + 2) + b * (3 * k + 2)  # FmScorer
            + n * (3 * k + 2)                  # FmGrad
            + 3 * n * d                        # K1
            + 6 * u * d)                       # K2


def kernel_work(b: int, f: int, d: int, u: float) -> tuple:
    """``(bytes, operations)`` of FmScorer, FmGrad, K1 and K2 in one
    step."""
    n = b * f
    nbytes = 4 * (n + n + (u + 1) + u) + 4 * 4 * u * d
    return nbytes, _kernel_ops(b, f, d, u)


def step_work(b: int, f: int, d: int, u: float) -> tuple:
    """``(bytes, operations)`` a training step requires."""
    n = b * f
    nbytes = 4 * (n + n + b + b + n + (u + 1)) + 4 * 4 * u * d
    ops = _kernel_ops(b, f, d, u) + 8 * b + 2 * n * d + 8
    return nbytes, ops
