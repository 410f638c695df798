"""The port's FmScorer forward (fast_tffm_tpu_torch.ops) vs the JAX
package's: the plain PyTorch version against the Pallas kernel in
interpret mode and against the jnp oracle, on the same numpy inputs.

Tolerance ``rtol=1e-5, atol=1e-6``, the same as tests/test_pallas_ops.py:
all three accumulate in f32 and differ only in summation order.  The
CUDA kernel itself runs only on the GPU, where it is held to the plain
version (tests/test_torch_gpu.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fast_tffm_tpu.ops import fm_pallas
from fast_tffm_tpu.ops import interaction as jax_interaction
from fast_tffm_tpu_torch.ops import fm_kernels, interaction

TOL = dict(rtol=1e-5, atol=1e-6)


def _problem(b, f=13, k=8, seed=0):
    """Gathered rows [b, f, 1+k] and vals [b, f] with padded tails of
    random length (``vals == 0``), like real batches."""
    rng = np.random.default_rng(seed + b)
    rows = (rng.normal(size=(b, f, 1 + k)) * 0.3).astype(np.float32)
    vals = rng.normal(size=(b, f)).astype(np.float32)
    lens = rng.integers(1, f + 1, size=(b, 1))
    vals[np.arange(f)[None, :] >= lens] = 0.0
    vals[:, -2:] = 0.0
    return rows, vals


def _plain(rows, vals):
    scores, s1 = fm_kernels.fm_scores_plain(
        torch.from_numpy(rows), torch.from_numpy(vals)
    )
    return scores.numpy(), s1.numpy()


@pytest.mark.parametrize("b", [1, 37, 64])
def test_plain_matches_pallas_interpret(b):
    rows, vals = _problem(b)
    want_s, want_s1 = fm_pallas.fm_scores_pallas(
        jnp.asarray(rows), jnp.asarray(vals), interpret=True
    )
    got_s, got_s1 = _plain(rows, vals)
    np.testing.assert_allclose(got_s, np.asarray(want_s), **TOL)
    np.testing.assert_allclose(got_s1, np.asarray(want_s1), **TOL)


@pytest.mark.parametrize("b", [1, 37, 64])
def test_plain_matches_jnp_oracle(b):
    rows, vals = _problem(b, f=39, k=8)
    want_s, want_s1 = jax_interaction._scores_jnp(
        jnp.asarray(rows), jnp.asarray(vals)
    )
    got_s, got_s1 = _plain(rows, vals)
    np.testing.assert_allclose(got_s, np.asarray(want_s), **TOL)
    np.testing.assert_allclose(got_s1, np.asarray(want_s1), **TOL)


def test_padded_slots_are_inert():
    """Slots with ``vals == 0`` contribute nothing, whatever their rows
    hold — the property the scorer's rung padding relies on."""
    rows, vals = _problem(16)
    noisy = rows.copy()
    noisy[vals == 0] = 123.0
    np.testing.assert_array_equal(_plain(rows, vals)[0],
                                  _plain(noisy, vals)[0])


def test_cpu_dispatch_takes_plain_version_without_counting():
    rows, vals = _problem(8)
    before = fm_kernels.fm_scores_cuda.launches
    got_s, got_s1 = interaction.forward(
        torch.from_numpy(rows), torch.from_numpy(vals)
    )
    want_s, want_s1 = _plain(rows, vals)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_s1.numpy(), want_s1)
    assert fm_kernels.fm_scores_cuda.launches == before
