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

import jax
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


@pytest.mark.parametrize("f", [1, 100])
@pytest.mark.parametrize("d", [1, 2, 17, 33])
def test_plain_matches_the_reference_at_the_kernels_widths(d, f):
    """The plain version, which the card holds the CUDA kernel to, against
    the reference at the widths where the kernel's lane mapping branches
    (D = 1: no factor and 32 features a pass; D = 2; D = 17: one feature
    a pass; D = 33: two column passes) and at F = 1 and 100:
    ``fm_scores_pallas`` in interpret mode, and at D = 1, where the
    Pallas call's zero-width ``s1`` block does not run in interpret mode,
    the jnp path the reference takes without Pallas."""
    rows, vals = _problem(5, f=f, k=d - 1)
    if d == 1:
        want_s, want_s1 = jax_interaction._scores_jnp(
            jnp.asarray(rows), jnp.asarray(vals))
    else:
        want_s, want_s1 = fm_pallas.fm_scores_pallas(
            jnp.asarray(rows), jnp.asarray(vals), interpret=True)
    got_s, got_s1 = _plain(rows, vals)
    assert got_s1.shape == (5, d - 1)
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


# -- bf16-input mode ------------------------------------------------------
#
# The reference's bf16 tolerances (tests/test_bf16.py:71, :85): scores
# rtol=2e-3, atol=1e-4 (f32 accumulation of bf16 operands in two
# summation orders); drows rtol=0.05, atol=0.02 (bf16 outputs, whose
# f32 inputs s1 and dscores differ in their last bits).
BF16_SCORE_TOL = dict(rtol=2e-3, atol=1e-4)
BF16_GRAD_TOL = dict(rtol=0.05, atol=0.02)


def _bf16_exact(a):
    """``a`` rounded to bf16 (nearest even), as float32: the same values
    reach both packages exactly."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _bf16_ulps(a, b):
    """Distance in bf16 steps between float32 arrays of bf16 values."""
    def ordered(x):
        bits = (x.view(np.int32) >> 16).astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)

    return np.abs(ordered(a) - ordered(b))


def _bf16_problem(b, f=13, k=8, seed=3):
    rows, vals = _problem(b, f, k, seed)
    g = np.random.default_rng(seed).normal(size=b).astype(np.float32)
    return _bf16_exact(rows * 0.3), _bf16_exact(vals), g


def _port_fwd_bwd(rows, vals, g):
    """The port's plain bf16 forward and backward: scores and drows as
    float32 numpy (drows' values are bf16)."""
    r = torch.from_numpy(rows).to(torch.bfloat16).requires_grad_()
    v = torch.from_numpy(vals).to(torch.bfloat16)
    scores = interaction.fm_interaction(r, v, plain=True)
    (drows,) = torch.autograd.grad(scores, r, torch.from_numpy(g))
    assert scores.dtype == torch.float32 and drows.dtype == torch.bfloat16
    return scores.detach().numpy(), drows.float().numpy()


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("b", [37, 128])
def test_bf16_fwd_bwd_match_the_reference(b, use_pallas):
    """The port's plain bf16 interaction against the reference's
    ``fm_interaction`` on the same bf16 inputs, the Pallas kernels in
    interpret mode (``use_pallas=True``) and the jnp oracle."""
    rows, vals, g = _bf16_problem(b)
    r = jnp.asarray(rows).astype(jnp.bfloat16)
    v = jnp.asarray(vals).astype(jnp.bfloat16)
    want_s, vjp = jax.vjp(
        lambda x: jax_interaction.fm_interaction(x, v, use_pallas), r)
    (want_d,) = vjp(jnp.asarray(g))
    assert want_s.dtype == jnp.float32 and want_d.dtype == jnp.bfloat16
    want_d = np.asarray(want_d.astype(jnp.float32))
    got_s, got_d = _port_fwd_bwd(rows, vals, g)
    np.testing.assert_allclose(got_s, np.asarray(want_s), **BF16_SCORE_TOL)
    np.testing.assert_allclose(got_d, want_d, **BF16_GRAD_TOL)
    # How far the two drows are apart in bf16 steps: the closed form is
    # the same, so only a product or difference that s1's last f32 bits
    # carry across a bf16 rounding boundary differs, by one step.
    ulps = _bf16_ulps(got_d, want_d)
    assert ulps.max() <= 1, (int((ulps > 0).sum()), int(ulps.max()))
    assert (ulps > 0).mean() < 0.01, int((ulps > 0).sum())


def test_bf16_plain_versions_compute_in_f32_and_round_once():
    """bf16 inputs: the forward equals the f32 forward of the widened
    inputs, and the backward is the f32 backward rounded once to bf16
    (nearest even), the contract the bf16 kernels are held to bitwise."""
    rows, vals, g = _bf16_problem(16)
    r32, v32 = torch.from_numpy(rows), torch.from_numpy(vals)
    r16, v16 = r32.to(torch.bfloat16), v32.to(torch.bfloat16)
    for got, want in zip(fm_kernels.fm_scores_plain(r16, v16),
                         fm_kernels.fm_scores_plain(r32, v32)):
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
    _, s1 = fm_kernels.fm_scores_plain(r32, v32)
    gt = torch.from_numpy(g)
    got = fm_kernels.fm_grad_plain(r16, v16, s1, gt)
    assert got.dtype == torch.bfloat16
    want = fm_kernels.fm_grad_plain(r32, v32, s1, gt).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_bf16_cpu_dispatch_takes_plain_version_without_counting():
    rows, vals, g = _bf16_problem(8)
    r = torch.from_numpy(rows).to(torch.bfloat16)
    v = torch.from_numpy(vals).to(torch.bfloat16)
    counts = (fm_kernels.fm_scores_cuda.launches_bf16,
              fm_kernels.fm_grad_cuda.launches_bf16)
    scores, s1 = fm_kernels.fm_scores_cuda(r, v)
    want_s, want_s1 = fm_kernels.fm_scores_plain(r, v)
    assert torch.equal(scores, want_s) and torch.equal(s1, want_s1)
    drows = fm_kernels.fm_grad_cuda(r, v, s1, torch.from_numpy(g))
    assert drows.dtype == torch.bfloat16
    assert (fm_kernels.fm_scores_cuda.launches_bf16,
            fm_kernels.fm_grad_cuda.launches_bf16) == counts


@pytest.mark.parametrize("rows_dtype, vals_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16), (torch.float64, torch.float64),
])
def test_wrappers_refuse_mixed_or_other_types(rows_dtype, vals_dtype):
    rows, vals = _problem(4)
    r = torch.from_numpy(rows).to(rows_dtype)
    v = torch.from_numpy(vals).to(vals_dtype)
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        fm_kernels.fm_scores_cuda(r, v)
    s1 = torch.zeros((4, rows.shape[2] - 1))
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        fm_kernels.fm_grad_cuda(r, v, s1, torch.zeros(4))


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_fm_widths_inputs_and_cpu_refusal(mode):
    """``tools/fm_widths`` times seeded inputs of the mode's type with each
    example's tail of features padded (value 0), FmGrad's ``s1`` and
    ``dscores`` in f32 beside them, digests bf16 outputs by their bits,
    and refuses to run without a CUDA device."""
    from fast_tffm_tpu_torch.tools import fm_widths

    dtype = fm_widths.MODES[mode]
    cpu = torch.device("cpu")
    rows, vals, s1, dscores = fm_widths.inputs(64, 33, dtype, cpu)
    again = fm_widths.inputs(64, 33, dtype, cpu)
    assert rows.shape == (64, fm_widths.F, 33) and vals.shape == (64, 39)
    assert rows.dtype == vals.dtype == dtype
    assert s1.shape == (64, 32) and dscores.shape == (64,)
    assert s1.dtype == dscores.dtype == torch.float32
    for got, want in zip((rows, vals, s1, dscores), again):
        assert torch.equal(got, want)
    # Adding FmGrad's inputs left the FmScorer's (drawn first) as they were.
    rng = np.random.default_rng(1000 * 33 + 64)
    want_rows = (rng.normal(size=(64, fm_widths.F, 33)) * 0.3).astype(
        np.float32)
    assert torch.equal(rows, torch.from_numpy(want_rows).to(dtype))
    drows = fm_kernels.fm_grad_plain(rows, vals, s1, dscores)
    assert drows.dtype == dtype and bool(torch.isfinite(drows.float()).all())
    assert fm_widths.digest(drows) == fm_widths.digest(drows.clone())
    if mode == "bf16":
        flipped = drows.clone()
        flipped.view(torch.int16)[0, 0, 0] ^= 1
        assert fm_widths.digest(flipped) != fm_widths.digest(drows)
    live = vals != 0
    # Padding is a tail: no live feature after a padded one.
    assert torch.equal(live, live.cummin(dim=1).values)
    assert bool(live[:, 0].all())
    if not torch.cuda.is_available():
        assert fm_widths.main() == 1
