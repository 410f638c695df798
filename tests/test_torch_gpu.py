"""The port on the GPU: the CUDA FmScorer kernel against its plain
PyTorch version, and the scorer's GPU path against its CPU path.

Every test here needs an NVIDIA GPU with ``nvcc`` (marker ``gpu``) and
skips without one.  The file imports neither jax nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Kernel vs plain: both accumulate in f32 and differ only in summation
order and FMA contraction, hence ``rtol=1e-5, atol=1e-5`` at inputs of
magnitude ~0.3 over 39 features.
"""

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.ops import fm_kernels
from fast_tffm_tpu_torch.serve.scorer import FixedShapeScorer

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _problem(b, f=39, k=8, seed=0):
    rng = np.random.default_rng(seed + b)
    rows = (rng.normal(size=(b, f, 1 + k)) * 0.3).astype(np.float32)
    vals = rng.uniform(0.0, 1.0, size=(b, f)).astype(np.float32)
    lens = rng.integers(1, f + 1, size=(b, 1))
    vals[np.arange(f)[None, :] >= lens] = 0.0
    return rows, vals


@pytest.mark.gpu
@pytest.mark.parametrize("b, f, k", [
    (1, 39, 8), (64, 39, 8), (1000, 39, 8), (1024, 39, 8),
    (5, 3, 40), (7, 1, 256), (2, 2, 1),
])
def test_cuda_kernel_matches_plain(gpu, b, f, k):
    rows, vals = _problem(b, f, k)
    rows_d = torch.from_numpy(rows).to(gpu)
    vals_d = torch.from_numpy(vals).to(gpu)
    before = fm_kernels.fm_scores_cuda.launches
    got_s, got_s1 = fm_kernels.fm_scores_cuda(rows_d, vals_d)
    want_s, want_s1 = fm_kernels.fm_scores_plain(rows_d, vals_d)
    torch.cuda.synchronize()
    assert fm_kernels.fm_scores_cuda.launches == before + 1
    assert got_s.shape == (b,) and got_s1.shape == (b, k)
    torch.testing.assert_close(got_s, want_s, **TOL)
    torch.testing.assert_close(got_s1, want_s1, **TOL)


@pytest.mark.gpu
def test_cuda_kernel_refuses_what_it_does_not_take(gpu):
    rows = torch.zeros((4, 3, 5), device=gpu)
    vals = torch.zeros((4, 3), device=gpu)
    with pytest.raises(ValueError, match="contiguous"):
        fm_kernels.fm_scores_cuda(rows.transpose(0, 1).contiguous()
                                  .transpose(0, 1), vals)
    with pytest.raises(TypeError):
        fm_kernels.fm_scores_cuda(rows.half(), vals)
    with pytest.raises(ValueError):
        fm_kernels.fm_scores_cuda(rows, vals.cpu())


@pytest.mark.gpu
def test_gpu_scorer_matches_cpu_scorer(gpu):
    cfg = FmConfig(vocabulary_size=301, factor_num=8, max_features=39,
                   serve_batch_sizes="8,32")
    rng = np.random.default_rng(3)
    table = rng.uniform(-0.3, 0.3, (301, 9)).astype(np.float32)
    ids = rng.integers(0, 301, (70, 39)).astype(np.int32)
    vals = rng.uniform(0.0, 1.0, (70, 39)).astype(np.float32)
    on_gpu = FixedShapeScorer(cfg, weights.from_jax(0.1, table, device=gpu),
                              device=gpu)
    on_cpu = FixedShapeScorer(cfg, weights.from_jax(0.1, table,
                                                    device="cpu"),
                              device="cpu")
    before = fm_kernels.fm_scores_cuda.launches
    on_gpu.warmup()
    got = on_gpu.score(ids, vals)
    # 2 warmup rungs + chunks of 32, 32 and 6 -> 5 launches.
    assert fm_kernels.fm_scores_cuda.launches == before + 5
    np.testing.assert_allclose(got, on_cpu.score(ids, vals),
                               rtol=1e-5, atol=1e-6)
