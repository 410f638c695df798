"""The port on the GPU: the CUDA kernels (FmScorer forward and FmGrad
backward in their f32 and bf16-input modes, K1 dedup and its merge mode,
K2 apply, K-place, and the table-layout probe's K2T and K2P) against
their plain PyTorch versions, the scorers' (fp32, bf16 and int8 tables,
and the tiered overlay) and the sparse step's GPU paths against their
CPU paths, two ranks' collectives on one GPU, the rank-sharded tiered
trainer against the dense mesh and the overlapped entries exchange
against the inline one on ranks sharing the card, field-aware FM's op,
graphed dispatch and kernel step at the FFM row width, the JAX
package's Orbax checkpoints (``tests/data/orbax/``) served on the card,
with a hot swap under traffic, the training-health carry of a
graphed dispatch (bitwise the eager one; a poisoned replay halts), and
the observability planes: the quality plane's scores copy in a graphed
dispatch (bitwise its eager twin, the same scores fed to the monitor)
and every plane on against every plane off, graphed and eager; and the
interaction autotuner (every candidate measured and parity-gated, a
graphed step of each pinned interaction bitwise its eager step).

Every test here needs an NVIDIA GPU with ``nvcc`` (marker ``gpu``) and
skips without one.  The file imports neither jax nor the JAX package,
so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Kernel vs plain: both accumulate in f32 and differ only in summation
order and FMA contraction, hence ``rtol=1e-5, atol=1e-5`` at inputs of
magnitude ~0.3 over 39 features.  K1's segment sums are held to the
plain version run in float64, within the error its own order of
summation allows (``sparse_apply.k1_error_bound``): the float32 plain
version sums
with atomics in an order that changes from run to run, and on a hot id
of thousands of occurrences its own error is the larger one.  The
apply is held to the reference's
tile-vs-scatter bounds (``rtol=1e-4, atol=1e-6`` table, ``atol=1e-4``
optimizer tables).  FmGrad computes in f32 with the plain version's
roundings (and in bf16 rounds once): it is held to it bitwise in both
modes.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.libsvm import Batch, SortMeta, host_sort_meta
from fast_tffm_tpu_torch.ops import fm_kernels, sparse_apply
from fast_tffm_tpu_torch.serve.scorer import FixedShapeScorer
from fast_tffm_tpu_torch.tools import micro_probe
from fast_tffm_tpu_torch.train import sparse

TOL = dict(rtol=1e-5, atol=1e-5)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-4, atol=1e-4)


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


# The FmScorer's shapes: B = 1 and 3 (a warp's examples partly past the
# batch), 64, 1024 and 4096; F = 1, 39 (two 32-feature batches) and 100;
# D = 1 and 2 (eight lanes an example, most idle), 9 (four examples a
# warp), 17 (two) and 33 (one, every lane a factor).
FM_WIDTHS = [(b, f, d) for b in (1, 3, 64, 1024, 4096) for f in (1, 39, 100)
             for d in (1, 2, 9, 17, 33)]


@pytest.mark.gpu
@pytest.mark.parametrize("b, f, k", [
    (1, 39, 8), (64, 39, 8), (1000, 39, 8), (1024, 39, 8), (4096, 39, 8),
    (5, 3, 40), (7, 1, 256), (2, 2, 1),
] + [(b, f, d - 1) for b, f, d in FM_WIDTHS if (f, d) != (39, 9)])
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


# FmGrad's edges: B*F*D not a multiple of a 16-byte chunk (4 f32, 8 bf16
# elements) and shorter than one; D = 1 (no s1), 2 and 33; B = 1.
FM_GRAD_EDGES = [(3, 5, 7), (5, 3, 1), (2, 1, 1), (1, 1, 3), (7, 39, 2),
                 (1, 39, 33), (65, 39, 33), (1023, 39, 9)]


def _on_gpu(a, gpu, dtype=torch.float32, offset=0):
    """``a`` as a contiguous ``dtype`` tensor on the card that starts
    ``offset`` elements into its storage (not 16-byte aligned for 1)."""
    buf = torch.zeros(a.size + offset, dtype=dtype, device=gpu)
    view = buf[offset:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    assert view.is_contiguous()
    assert (view.data_ptr() % 16 == 0) == (offset == 0)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("b, f, d", [
    (1, 39, 9), (1000, 39, 9), (4096, 39, 9), (5, 3, 41), (7, 4, 2),
    (3, 2, 1),
] + FM_GRAD_EDGES)
def test_fm_grad_kernel_matches_plain(gpu, b, f, d, offset):
    """The f32 FmGrad, also at ragged sizes and on rows and vals that start
    ``offset`` elements into their storage: bitwise its plain version."""
    rows, vals = _problem(b, f, d - 1)
    rng = np.random.default_rng(b)
    rows_d = _on_gpu(rows, gpu, offset=offset)
    vals_d = _on_gpu(vals, gpu, offset=offset)
    _, s1 = fm_kernels.fm_scores_plain(rows_d, vals_d)
    g = torch.from_numpy(rng.normal(size=(b,)).astype(np.float32)).to(gpu)
    before = fm_kernels.fm_grad_cuda.launches
    got = fm_kernels.fm_grad_cuda(rows_d, vals_d, s1, g)
    want = fm_kernels.fm_grad_plain(rows_d, vals_d, s1, g)
    torch.cuda.synchronize()
    assert fm_kernels.fm_grad_cuda.launches == before + 1
    assert got.shape == (b, f, d)
    assert torch.equal(got, want)


def _bf16_inputs(gpu, b, f, d, offset=0):
    rows, vals = _problem(b, f, d - 1)
    return (_on_gpu(rows, gpu, torch.bfloat16, offset),
            _on_gpu(vals, gpu, torch.bfloat16, offset))


@pytest.mark.gpu
@pytest.mark.parametrize("b, f, d", [
    (1, 39, 9), (64, 39, 9), (1023, 39, 9), (4096, 39, 9), (5, 3, 41),
    (7, 1, 257), (2, 2, 2), (6, 5, 1),
] + [w for w in FM_WIDTHS if w not in ((1, 39, 9), (64, 39, 9),
                                       (4096, 39, 9))])
def test_bf16_fm_scores_kernel_matches_plain(gpu, b, f, d):
    """The bf16-input FmScorer (B not a multiple of a warp's examples,
    D = 1 with no factors, every width of ``FM_WIDTHS``) against its
    plain version: both widen the same bf16 values and accumulate in
    f32."""
    rows, vals = _bf16_inputs(gpu, b, f, d)
    before = (fm_kernels.fm_scores_cuda.launches,
              fm_kernels.fm_scores_cuda.launches_bf16)
    got_s, got_s1 = fm_kernels.fm_scores_cuda(rows, vals)
    want_s, want_s1 = fm_kernels.fm_scores_plain(rows, vals)
    torch.cuda.synchronize()
    assert (fm_kernels.fm_scores_cuda.launches,
            fm_kernels.fm_scores_cuda.launches_bf16) == (before[0],
                                                         before[1] + 1)
    assert got_s.dtype == got_s1.dtype == torch.float32
    assert got_s.shape == (b,) and got_s1.shape == (b, d - 1)
    torch.testing.assert_close(got_s, want_s, **TOL)
    torch.testing.assert_close(got_s1, want_s1, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, f, d", [(64, 39, 9), (4096, 39, 9),
                                     (3, 100, 33), (1024, 1, 1)])
def test_fm_scores_kernel_is_deterministic(gpu, dtype, b, f, d):
    """Two runs on the same inputs give bitwise-equal scores and ``s1``:
    the order of summation is fixed."""
    rows, vals = _problem(b, f, d - 1)
    rows_d = torch.from_numpy(rows).to(gpu).to(dtype)
    vals_d = torch.from_numpy(vals).to(gpu).to(dtype)
    first = fm_kernels.fm_scores_cuda(rows_d, vals_d)
    second = fm_kernels.fm_scores_cuda(rows_d, vals_d)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("b, f, d", [
    (1, 39, 9), (1000, 39, 9), (4096, 39, 9), (5, 3, 41), (3, 2, 1),
] + FM_GRAD_EDGES)
def test_bf16_fm_grad_kernel_matches_plain_bitwise(gpu, b, f, d, offset):
    """The bf16 FmGrad computes in f32 with the plain version's
    roundings and rounds once to bf16: equal bit for bit, also at ragged
    sizes and on rows and vals that start ``offset`` elements into their
    storage."""
    rows, vals = _bf16_inputs(gpu, b, f, d, offset)
    _, s1 = fm_kernels.fm_scores_plain(rows, vals)
    g = torch.randn((b,), generator=torch.Generator(device=gpu)
                    .manual_seed(b), device=gpu)
    before = (fm_kernels.fm_grad_cuda.launches,
              fm_kernels.fm_grad_cuda.launches_bf16)
    got = fm_kernels.fm_grad_cuda(rows, vals, s1, g)
    want = fm_kernels.fm_grad_plain(rows, vals, s1, g)
    torch.cuda.synchronize()
    assert (fm_kernels.fm_grad_cuda.launches,
            fm_kernels.fm_grad_cuda.launches_bf16) == (before[0],
                                                       before[1] + 1)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
def test_bf16_kernels_refuse_mixed_types(gpu):
    rows, vals = _bf16_inputs(gpu, 4, 3, 5)
    s1 = torch.zeros((4, 4), device=gpu)
    g = torch.zeros((4,), device=gpu)
    for r, v in ((rows, vals.float()), (rows.float(), vals)):
        with pytest.raises(TypeError, match="both float32 or both"):
            fm_kernels.fm_scores_cuda(r, v)
        with pytest.raises(TypeError, match="both float32 or both"):
            fm_kernels.fm_grad_cuda(r, v, s1, g)
    with pytest.raises(TypeError, match="float32 s1"):
        fm_kernels.fm_grad_cuda(rows, vals, s1.bfloat16(), g)


@pytest.mark.gpu
def test_bf16_sparse_step_matches_the_plain_step(gpu):
    """One ``compute_dtype = bfloat16`` step through the kernels (bf16
    FmScorer and FmGrad, K1, K2) against the same step through their
    plain versions on the card."""
    vocab, b, f = 4096, 256, 39
    cfg = FmConfig(vocabulary_size=vocab, factor_num=8, max_features=f,
                   batch_size=b, learning_rate=0.05, factor_lambda=1e-3,
                   bias_lambda=1e-3, compute_dtype="bfloat16")
    rng = np.random.default_rng(12)
    table = rng.uniform(-0.05, 0.05, (vocab, 9)).astype(np.float32)
    ids = rng.integers(0, vocab, (b, f)).astype(np.int32)
    batch = sparse.to_device(Batch(
        rng.integers(0, 2, b).astype(np.float32), ids,
        rng.uniform(0, 1, (b, f)).astype(np.float32),
        np.zeros((b, f), np.int32), np.ones(b, np.float32),
        host_sort_meta(ids)), gpu)
    out = {}
    before = (fm_kernels.fm_scores_cuda.launches_bf16,
              fm_kernels.fm_grad_cuda.launches_bf16)
    for plain in (False, True):
        model = weights.from_jax(0.0, table, device=gpu)
        opt = sparse.init_sparse_opt_state(cfg, model)
        scores = sparse.sparse_step(cfg, model, opt, batch, plain=plain,
                                    impl="jnp" if plain else "pallas")
        out[plain] = (scores, model, opt)
    torch.cuda.synchronize()
    assert (fm_kernels.fm_scores_cuda.launches_bf16,
            fm_kernels.fm_grad_cuda.launches_bf16) == (before[0] + 1,
                                                       before[1] + 1)
    (s_k, m_k, o_k), (s_p, m_p, o_p) = out[False], out[True]
    torch.testing.assert_close(s_k, s_p, **TOL)
    assert m_k.table.dtype == torch.float32
    torch.testing.assert_close(m_k.table, m_p.table, **TABLE_TOL)
    torch.testing.assert_close(m_k.w0, m_p.w0, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(o_k.acc_table, o_p.acc_table, **OPT_TOL)


def _sparse_problem(gpu, n, d, hot, seed=0, vocab=4096):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, n).astype(np.int32)
    if hot:
        ids[rng.permutation(n)[:hot]] = 77
    g = rng.normal(size=(n, d)).astype(np.float32)
    meta = host_sort_meta(ids)
    put = lambda a: torch.from_numpy(a).to(gpu)  # noqa: E731
    return put(ids), put(g), put(meta.perm), put(meta.seg_start), rng


def _k1_run(mode, pay, ids, meta):
    """Two kernel calls and the float64 plain version with its mass:
    ``(urows, sums, urows2, sums2, want_rows, want64, bound)``."""
    kern = getattr(sparse_apply, f"k1_{mode}_cuda")
    plain = getattr(sparse_apply, f"k1_{mode}_plain")
    before = kern.launches
    urows, sums = kern(pay, ids, meta.perm, meta.seg_start)
    urows2, sums2 = kern(pay, ids, meta.perm, meta.seg_start)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    want_rows, want64 = plain(pay.double(), ids, meta.perm, meta.seg_start)
    _, mass = plain(pay.abs().double(), ids, meta.perm, meta.seg_start)
    bound = sparse_apply.k1_error_bound(meta.seg_start, mass)
    return urows, sums, urows2, sums2, want_rows, want64, bound


@pytest.mark.gpu
@pytest.mark.parametrize("n, d, hot", [
    (159744, 9, 0), (159744, 9, 6000), (2000, 41, 700), (3000, 2, 1300),
    (1, 9, 0),
])
def test_k1_kernel_matches_plain_and_is_deterministic(gpu, n, d, hot):
    ids, g, perm, seg, _ = _sparse_problem(gpu, n, d, hot)
    # The plain version in float64 is the reference: its own rounding is
    # some 1e-9 of the kernel's bound.
    urows, sums, urows2, sums2, want_rows, want64, bound = _k1_run(
        "dedup", g, ids, SortMeta(perm, seg))
    assert torch.equal(urows, want_rows)
    err = (sums.double() - want64).abs()
    assert bool(torch.all(err <= bound)), err.max()
    assert torch.equal(sums, sums2) and torch.equal(urows, urows2)


def _k2_stream(gpu, d, hot, vocab, n=20000, unique=3001, seed=0):
    """K1's stream of ``n`` ids over ``unique`` distinct rows (odd, so not
    a multiple of any block's rows), the table's last row among them, one
    id of ``hot`` occurrences: ``(urows, sums, rng)`` on the card."""
    rng = np.random.default_rng(seed + d)
    rows = np.append(rng.choice(vocab - 1, unique - 1, replace=False),
                     vocab - 1)
    ids = np.concatenate([rows, rng.choice(rows, n - unique)])
    ids[unique:unique + hot] = rows[7]
    ids = rng.permutation(ids).astype(np.int32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    meta = host_sort_meta(ids)
    put = lambda a: torch.from_numpy(a).to(gpu)  # noqa: E731
    urows, sums = sparse_apply.k1_dedup_plain(put(g), put(ids),
                                              put(meta.perm),
                                              put(meta.seg_start))
    assert urows.numel() == unique and int(urows[-1]) == vocab - 1
    return urows, sums, rng


K2_HYPER = sparse_apply.Hyper(lr=0.05, eps=1e-7, l1=0.01, l2=0.1, beta=1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl", "sgd"])
@pytest.mark.parametrize("d, hot", [(9, 5000), (41, 0), (2, 300), (1, 20),
                                    (16, 700), (17, 0)])
def test_k2_kernel_matches_plain(gpu, optimizer, d, hot):
    """K2 against its plain version at the reference's bounds, at D = 1
    to 41 (one and several column passes), U not a multiple of a block's
    rows, the table's last row and a hot id in the stream; untouched rows
    stay as they were.  For Adagrad the layout probe's K2T and, at
    D <= 16, K2P give K2's tables bitwise."""
    vocab = 4096
    urows, sums, rng = _k2_stream(gpu, d, hot, vocab)
    hyper = K2_HYPER
    n_tables = {"sgd": 1, "adagrad": 2, "ftrl": 3}[optimizer]
    base = [rng.uniform(-0.1, 0.1, (vocab, d)).astype(np.float32)]
    base += [rng.uniform(0.1, 1.0, (vocab, d)).astype(np.float32)
             for _ in range(n_tables - 1)]
    kern = tuple(torch.from_numpy(t).to(gpu) for t in base)
    plain = tuple(t.clone() for t in kern)
    start = tuple(t.clone() for t in kern)
    before = sparse_apply.k2_apply_cuda.launches
    sparse_apply.k2_apply_cuda(optimizer, urows, sums, kern, hyper)
    sparse_apply.k2_apply_plain(optimizer, urows, sums, plain, hyper)
    torch.cuda.synchronize()
    assert sparse_apply.k2_apply_cuda.launches == before + 1
    torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
    for a, b in zip(kern[1:], plain[1:]):
        torch.testing.assert_close(a, b, **OPT_TOL)
    # Untouched rows are untouched.
    untouched = torch.ones(vocab, dtype=torch.bool, device=gpu)
    untouched[urows.long()] = False
    for t, orig in zip(kern, base):
        assert torch.equal(t[untouched].cpu(),
                           torch.from_numpy(orig)[untouched.cpu()])
    if optimizer != "adagrad":
        return
    layouts = ["k2t"] + (["k2p"] if d <= micro_probe.PACK_SLOTS else [])
    for layout in layouts:
        tabs, rows = _layout(layout, start[0], start[1], d)
        tabs = tuple(t.clone() for t in tabs)
        getattr(micro_probe, f"{layout}_entries")(urows, sums, *tabs,
                                                  lr=hyper.lr, eps=hyper.eps)
        torch.cuda.synchronize()
        for got, want in zip(tabs, kern):
            assert torch.equal(rows(got), want), layout


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl", "sgd"])
def test_k2_kernel_is_deterministic(gpu, optimizer):
    """Two K2 runs from equal tables on the same stream give bitwise-equal
    tables."""
    vocab, d = 1 << 16, 9
    urows, sums, rng = _k2_stream(gpu, d, 5000, vocab, n=60000,
                                  unique=30001)
    n_tables = {"sgd": 1, "adagrad": 2, "ftrl": 3}[optimizer]
    start = [torch.from_numpy(rng.uniform(0.1, 1.0, (vocab, d))
                              .astype(np.float32)).to(gpu)
             for _ in range(n_tables)]
    runs = []
    for _ in range(2):
        tabs = tuple(t.clone() for t in start)
        sparse_apply.k2_apply_cuda(optimizer, urows, sums, tabs, K2_HYPER)
        runs.append(tabs)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_sparse_wrappers_refuse_what_the_kernels_do_not_take(gpu):
    rows = torch.zeros((4, 3, 5), device=gpu)
    vals = torch.zeros((4, 3), device=gpu)
    s1 = torch.zeros((4, 4), device=gpu)
    g = torch.zeros((4,), device=gpu)
    with pytest.raises(TypeError):
        fm_kernels.fm_grad_cuda(rows, vals, s1.double(), g)
    with pytest.raises(ValueError):
        fm_kernels.fm_grad_cuda(rows, vals, s1[:, :3], g)
    with pytest.raises(ValueError):
        fm_kernels.fm_grad_cuda(rows, vals, s1, g.cpu())
    ids, gr, perm, seg, _ = _sparse_problem(gpu, 64, 5, 0)
    with pytest.raises(TypeError):
        sparse_apply.k1_dedup_cuda(gr, ids.long(), perm, seg)
    with pytest.raises(ValueError):
        sparse_apply.k1_dedup_cuda(gr[:10], ids, perm, seg)
    with pytest.raises(ValueError):
        sparse_apply.k1_dedup_cuda(gr, ids, perm.cpu(), seg)
    urows, sums = sparse_apply.k1_dedup_cuda(gr, ids, perm, seg)
    table = torch.zeros((4096, 5), device=gpu)
    hyper = sparse_apply.Hyper(lr=0.1)
    with pytest.raises(TypeError):
        sparse_apply.k2_apply_cuda("sgd", urows, sums, (table.double(),),
                                   hyper)
    with pytest.raises(ValueError):
        sparse_apply.k2_apply_cuda("adagrad", urows, sums, (table,), hyper)
    with pytest.raises(ValueError):
        sparse_apply.k2_apply_cuda("sgd", urows, sums, (table.cpu(),), hyper)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl"])
def test_sparse_step_on_the_gpu_matches_the_cpu(gpu, optimizer):
    vocab, b, f = 4096, 256, 39
    cfg = FmConfig(vocabulary_size=vocab, factor_num=8, max_features=f,
                   batch_size=b, optimizer=optimizer, learning_rate=0.05,
                   factor_lambda=1e-3, bias_lambda=1e-3)
    rng = np.random.default_rng(11)
    table = rng.uniform(-0.05, 0.05, (vocab, 9)).astype(np.float32)
    models = {dev: weights.from_jax(0.0, table, device=dev)
              for dev in ("cpu", gpu)}
    opts = {dev: sparse.init_sparse_opt_state(cfg, m)
            for dev, m in models.items()}
    before = (fm_kernels.fm_grad_cuda.launches,
              sparse_apply.k1_dedup_cuda.launches,
              sparse_apply.k2_apply_cuda.launches)
    for step in range(2):
        ids = rng.integers(0, vocab, (b, f)).astype(np.int32)
        ids[:, :3] = rng.integers(0, 5, (b, 3))  # hot ids
        batch = Batch(rng.integers(0, 2, b).astype(np.float32), ids,
                      rng.uniform(0, 1, (b, f)).astype(np.float32),
                      np.zeros((b, f), np.int32), np.ones(b, np.float32),
                      host_sort_meta(ids) if step else None)
        for dev in models:
            sparse.sparse_step(cfg, models[dev], opts[dev],
                               sparse.to_device(batch, dev))
    torch.cuda.synchronize()
    after = (fm_kernels.fm_grad_cuda.launches,
             sparse_apply.k1_dedup_cuda.launches,
             sparse_apply.k2_apply_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2]
    cpu_m, gpu_m = models["cpu"], models[gpu]
    torch.testing.assert_close(gpu_m.table.detach().cpu(),
                               cpu_m.table.detach(), **TABLE_TOL)
    torch.testing.assert_close(gpu_m.w0.detach().cpu(), cpu_m.w0.detach(),
                               rtol=1e-5, atol=1e-7)
    for a, b in zip(sparse.opt_tables(opts[gpu]),
                    sparse.opt_tables(opts["cpu"])):
        torch.testing.assert_close(a.cpu(), b, **OPT_TOL)


def _kplace_problem(gpu, vocab, n, d, hot):
    """K1's stream of ``n`` occurrences over ``[0, vocab]`` (``vocab``
    is the sentinel) with a hot id, on the card."""
    rng = np.random.default_rng(n + d)
    ids = rng.integers(0, vocab, n).astype(np.int32)
    ids[:hot] = 11
    ids[rng.permutation(n)[:n // 10]] = vocab  # sentinels
    g = rng.normal(size=(n, d)).astype(np.float32)
    meta = host_sort_meta(ids)
    put = lambda a: torch.from_numpy(a).to(gpu)  # noqa: E731
    return sparse_apply.k1_dedup_plain(put(g), put(ids), put(meta.perm),
                                       put(meta.seg_start))


@pytest.mark.gpu
@pytest.mark.parametrize("vocab, vocab_local, row_lo, n, d", [
    (1 << 16, 1 << 15, 1 << 15, 20000, 9),  # upper shard, sentinels
    (1 << 16, 1 << 15, 0, 20000, 9),  # lower shard
    (4096, 4096, 0, 3000, 41),  # whole table, wide rows
    (1000, 999, 1, 50, 2),  # ragged last tile
    (1 << 12, 1 << 12, 0, 0, 4),  # no entries: all zeros
])
def test_kplace_kernel_matches_plain(gpu, vocab, vocab_local, row_lo, n, d):
    """K-place is a placement: it equals its plain version bit for bit."""
    urows, sums = _kplace_problem(gpu, vocab, n, d, hot=min(n, 500))
    before = sparse_apply.kplace_cuda.launches
    got = sparse_apply.kplace_cuda(urows, sums, row_lo, vocab_local)
    want = sparse_apply.kplace_plain(urows, sums, row_lo, vocab_local)
    torch.cuda.synchronize()
    assert sparse_apply.kplace_cuda.launches == before + 1
    assert got.shape == (vocab_local, 2 * d)
    assert torch.equal(got, want)


def _kplace_stream(gpu, rows, w, absent, seed):
    """``urows``: ``rows`` ascending and unique, then ``absent`` rows -1
    (a whole slot's tail); ``sums [U, w]`` normal, from a seed."""
    rng = np.random.default_rng(seed)
    urows = np.concatenate([np.unique(np.asarray(rows, np.int64)),
                            np.full(absent, -1)]).astype(np.int32)
    sums = rng.normal(size=(urows.size, w)).astype(np.float32)
    return torch.from_numpy(urows).to(gpu), torch.from_numpy(sums).to(gpu)


@pytest.mark.gpu
@pytest.mark.parametrize("w, vocab_local, row_lo", [
    (9, 300_001, 12_345), (33, 300_001, 12_345), (66, 300_001, 12_345),
    (9, 1_003, 7), (66, 1_003, 7), (12_289, 1_003, 7), (3, 5, 0), (1, 3, 2),
])
def test_kplace_edges_are_bitwise_plain(gpu, w, vocab_local, row_lo):
    """Odd widths over shards whose size is no multiple of 4 or of a
    block's run and whose first row is odd: the 16-byte stores meet
    ragged block edges (a row split between two blocks) and the ragged
    last floats.  Rows below and above the shard, its first and last
    rows, and a tail of rows -1; W = 12,289 is past the widest row the
    kernel's shared-memory tile used to hold."""
    rng = np.random.default_rng(w * vocab_local)
    inside = rng.choice(vocab_local, min(vocab_local // 3, 20_000),
                        replace=False)
    rows = np.concatenate([
        rng.choice(row_lo, min(row_lo, 50), replace=False),
        row_lo + inside, [row_lo, row_lo + vocab_local - 1],
        row_lo + vocab_local + rng.choice(1000, 20, replace=False)])
    urows, sums = _kplace_stream(gpu, rows, w, 37, seed=w)
    before = sparse_apply.kplace_cuda.launches
    got = sparse_apply.kplace_cuda(urows, sums, row_lo, vocab_local)
    want = sparse_apply.kplace_plain(urows, sums, row_lo, vocab_local)
    torch.cuda.synchronize()
    assert sparse_apply.kplace_cuda.launches == before + 1
    assert got.shape == (vocab_local, w)
    assert torch.equal(got, want)
    assert torch.equal(got[0], sums[np.searchsorted(np.unique(rows), row_lo)])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["no_entries", "only_rows_minus_1",
                                  "all_off_the_shard"])
def test_kplace_with_nothing_to_place_writes_zeros(gpu, case):
    """U = 0, a stream of rows -1 alone, and entries all below or above
    the shard: the delta is all zeros, as the plain version's."""
    vocab_local, row_lo, w = 70_001, 5_003, 9
    rows = {"no_entries": [], "only_rows_minus_1": [],
            "all_off_the_shard": np.r_[0:row_lo:97,
                                       row_lo + vocab_local:90_000:13]}[case]
    absent = 4096 if case == "only_rows_minus_1" else 0
    urows, sums = _kplace_stream(gpu, rows, w, absent, seed=3)
    got = sparse_apply.kplace_cuda(urows, sums, row_lo, vocab_local)
    want = sparse_apply.kplace_plain(urows, sums, row_lo, vocab_local)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not bool(got.any())


@pytest.mark.gpu
def test_kplace_at_the_widest_width(gpu):
    """W = the widest the kernel takes (an int's largest, 8.6 GB a row):
    one row placed over a one-row shard, split between all the grid's
    blocks, is bitwise the plain version's."""
    w = sparse_apply._KPLACE_MAX_WIDTH
    urows = torch.tensor([3], dtype=torch.int32, device=gpu)
    sums = torch.randn((1, w), generator=torch.Generator(
        device=gpu).manual_seed(5), device=gpu)
    got = sparse_apply.kplace_cuda(urows, sums, 3, 1)
    torch.cuda.synchronize()
    assert torch.equal(got, sparse_apply.kplace_plain(urows, sums, 3, 1))
    del got, sums
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_kplace_replayed_from_a_cuda_graph(gpu):
    """K-place captured once on a whole slot's buffers and replayed on
    new entries (a different count each time, rows -1 after them) gives
    the plain version's delta of those entries."""
    n, w, vocab_local, row_lo = 5000, 18, 100_003, 501
    urows = torch.full((n,), -1, dtype=torch.int32, device=gpu)
    sums = torch.zeros((n, w), device=gpu)

    def fill(seed):
        rng = np.random.default_rng(seed)
        rows = np.sort(rng.choice(row_lo + vocab_local + 100,
                                  int(rng.integers(1, n)), replace=False))
        urows.fill_(-1)
        urows[:rows.size] = torch.from_numpy(rows.astype(np.int32)).to(gpu)
        sums.copy_(torch.from_numpy(
            rng.normal(size=(n, w)).astype(np.float32)))

    fill(0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sparse_apply.kplace_cuda(urows, sums, row_lo, vocab_local)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sparse_apply.kplace_cuda(urows, sums, row_lo, vocab_local)
    for seed in (1, 2, 3):
        fill(seed)
        graph.replay()
        want = sparse_apply.kplace_plain(urows, sums, row_lo, vocab_local)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n, p, hot", [(79872, 18, 0), (40000, 18, 4000),
                                       (3000, 82, 100), (1, 4, 0)])
def test_k1_merge_kernel_matches_plain(gpu, n, p, hot):
    """Merge mode sums the payload as it is: held to the plain version
    in float64 within the kernel's order-of-summation bound."""
    ids, pay, perm, seg, _ = _sparse_problem(gpu, n, p, hot)
    before = sparse_apply.k1_merge_cuda.launches
    urows, sums = sparse_apply.k1_merge_cuda(pay, ids, perm, seg)
    torch.cuda.synchronize()
    assert sparse_apply.k1_merge_cuda.launches == before + 1
    want_rows, want64 = sparse_apply.k1_merge_plain(pay.double(), ids, perm,
                                                    seg)
    _, mass = sparse_apply.k1_merge_plain(pay.abs().double(), ids, perm, seg)
    assert torch.equal(urows, want_rows) and sums.shape == want64.shape
    # k1_error_bound counts a square's rounding too: a bound for this.
    bound = sparse_apply.k1_error_bound(seg, mass)
    assert bool(torch.all((sums.double() - want64).abs() <= bound))


@pytest.mark.gpu
def test_two_ranks_on_one_gpu_over_gloo(gpu, tmp_path):
    """Two ranks share cuda:0, so the backend rule picks gloo and the
    collectives stage through pinned host memory: psum, all_gather and
    gather over each mesh axis equal the sums and concatenations made
    locally."""
    from _torch_sharded_worker import run_ranks

    run_ranks("collectives", 2, tmp_path)
    assert all((tmp_path / f"collectives_{r}.ok").exists() for r in (0, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dedup", "merge"])
def test_k1_kernel_leaves_the_sentinel_segment_out(gpu, mode):
    """The sharded step's prep drops the sentinel's segment (every
    off-shard occurrence): K1 then sums the real rows only, as its
    plain version does.  The sentinel's occurrences carry NaN payloads,
    so a read past seg_start[U] would show in the sums."""
    vocab = 4096
    ids, g, _, _, rng = _sparse_problem(gpu, 60000, 9, 3000, vocab=vocab)
    off = torch.from_numpy(rng.permutation(60000)[:30000]).to(gpu)
    ids[off] = vocab
    g[off] = float("nan")
    meta = sparse_apply.sort_meta(ids, drop_from=vocab)
    urows, sums, _, sums2, want_rows, want64, bound = _k1_run(mode, g, ids,
                                                              meta)
    assert torch.equal(urows, want_rows) and int(urows.max()) < vocab
    assert urows.numel() == torch.unique(ids[ids < vocab]).numel()
    assert bool(torch.isfinite(sums).all()) and torch.equal(sums, sums2)
    assert bool(torch.all((sums.double() - want64).abs() <= bound))


def _layout(layout, table, acc, d):
    """The two ``[V, d]`` tables in the probe's transposed or packed
    layout, and the function giving a layout's ``[V, d]`` view back."""
    if layout == "k2t":
        return (table.t().contiguous(), acc.t().contiguous()), torch.t
    return ((micro_probe.pack_table(table, d),
             micro_probe.pack_table(acc, d)),
            lambda t: micro_probe.unpack_table(t, d))


@pytest.mark.gpu
@pytest.mark.parametrize("layout, vocab, n, d, hot", [
    ("k2t", 1 << 16, 20000, 9, 5000), ("k2t", 4096, 3000, 41, 300),
    ("k2t", 4096, 1, 1, 0),
    ("k2p", 1 << 16, 20000, 9, 5000), ("k2p", 4096, 3000, 16, 300),
    ("k2p", 4096, 1, 1, 0),
])
def test_layout_probe_kernels_match_plain_and_k2(gpu, layout, vocab, n, d,
                                                 hot):
    """K2T and K2P against their plain versions at the reference's K2
    bounds, and bitwise against the row-major K2 kernel on the same
    stream (one Adagrad rounding for the three layouts); untouched
    elements and the packed pad slots stay as they were."""
    ids, g, perm, seg, rng = _sparse_problem(gpu, n, d, hot, vocab=vocab)
    urows, sums = sparse_apply.k1_dedup_plain(g, ids, perm, seg)
    table, acc = (torch.from_numpy(rng.uniform(lo, hi, (vocab, d))
                                   .astype(np.float32)).to(gpu)
                  for lo, hi in ((-0.1, 0.1), (0.1, 1.0)))
    # A layout may alias its [V, d] source (at d = 1 the transpose is
    # contiguous already): every updated table is a clone.
    start, rows = _layout(layout, table, acc, d)
    kern = tuple(t.clone() for t in start)
    plain = tuple(t.clone() for t in start)
    row_major = (table.clone(), acc.clone())
    entries = getattr(micro_probe, f"{layout}_entries")
    wrapper = getattr(micro_probe, f"{layout}_apply")
    before = wrapper.launches
    entries(urows, sums, *kern, lr=0.05, eps=1e-7)
    entries(urows, sums, *plain, lr=0.05, eps=1e-7, plain=True)
    sparse_apply.k2_apply_cuda("adagrad", urows, sums, row_major,
                               sparse_apply.Hyper(lr=0.05, eps=1e-7))
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
    torch.testing.assert_close(kern[1], plain[1], **OPT_TOL)
    for got, want in zip(kern, row_major):
        assert torch.equal(rows(got), want)
    if layout == "k2p":
        for got, was in zip(kern, start):
            assert torch.equal(got.view(-1, 16)[:, d:],
                               was.view(-1, 16)[:, d:])


@pytest.mark.gpu
@pytest.mark.parametrize("u, d", [
    (1, 9), (257, 9), (256, 9), (513, 1), (300, 41), (40, 200), (5000, 16),
    (33, micro_probe.K2T_MAX_D),
])
def test_k2t_kernel_edges_are_bitwise_k2(gpu, u, d):
    """K2T on streams of U unique ids (one entry, one past a 256-entry
    tile, D = 1, a 128-entry tile at D = 41, a 32-entry tile whose stage
    passes 48 KB at D = 200, the widest D), always with the id V - 1:
    bitwise K2's
    elements, within the reference's bounds of the plain version, and
    every untouched element as it was."""
    vocab = 8192
    rng = np.random.default_rng(u + d)
    ids = np.sort(rng.choice(vocab - 1, size=u - 1, replace=False))
    urows = torch.from_numpy(
        np.append(ids, vocab - 1).astype(np.int32)).to(gpu)
    g1 = rng.normal(size=(u, d)) * 0.1
    g2 = g1 * g1 + rng.uniform(0.0, 0.01, size=(u, d))
    sums = torch.from_numpy(
        np.concatenate([g1, g2], axis=1).astype(np.float32)).to(gpu)
    table, acc = (torch.from_numpy(rng.uniform(lo, hi, (vocab, d))
                                   .astype(np.float32)).to(gpu)
                  for lo, hi in ((-0.1, 0.1), (0.1, 1.0)))
    start = (table.t().contiguous(), acc.t().contiguous())
    kern = tuple(t.clone() for t in start)
    plain = tuple(t.clone() for t in start)
    row_major = (table.clone(), acc.clone())
    before = micro_probe.k2t_apply.launches
    micro_probe.k2t_entries(urows, sums, *kern, lr=0.05, eps=1e-7)
    micro_probe.k2t_entries(urows, sums, *plain, lr=0.05, eps=1e-7,
                            plain=True)
    sparse_apply.k2_apply_cuda("adagrad", urows, sums, row_major,
                               sparse_apply.Hyper(lr=0.05, eps=1e-7))
    torch.cuda.synchronize()
    assert micro_probe.k2t_apply.launches == before + 1
    torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
    torch.testing.assert_close(kern[1], plain[1], **OPT_TOL)
    untouched = torch.ones(vocab, dtype=torch.bool, device=gpu)
    untouched[urows.long()] = False
    for got, was, want in zip(kern, start, row_major):
        assert torch.equal(got.t(), want)
        assert torch.equal(got[:, untouched], was[:, untouched])
        assert not torch.equal(got[:, -1], was[:, -1])


def _k2p_tile(d):
    """Rows of a K2P block at width ``d``: 256 threads, one lane a
    16-byte chunk of the row, the lanes rounded up to a power of two."""
    chunks = -(-d // 4)
    return 256 // (1 << (chunks - 1).bit_length())


K2P_EDGES = [(u, d) for d in (1, 4, 5, 8, 9, 12, 13, 16)
             for u in sorted({1, _k2p_tile(d) - 1, _k2p_tile(d),
                              _k2p_tile(d) + 1, 5000, 5001, 100001})]


@pytest.mark.gpu
@pytest.mark.parametrize("u, d", K2P_EDGES)
def test_k2p_kernel_edges_are_bitwise_k2(gpu, u, d):
    """K2P on streams of U unique ids (one entry, one under a block's
    tile, a tile, one past it, an odd U, whose last tile's sums end off
    a 16-byte boundary at odd D, and a stream long enough that a block
    walks several tiles), always with the id V - 1, on tables whose pad
    slots hold values: bitwise K2's elements, within the reference's
    bounds of the plain version, every untouched row and every pad slot
    as it was."""
    vocab = 1 << 18 if u > 8192 else 8192
    rng = np.random.default_rng(u + 100 * d)
    ids = np.sort(rng.choice(vocab - 1, size=u - 1, replace=False))
    urows = torch.from_numpy(
        np.append(ids, vocab - 1).astype(np.int32)).to(gpu)
    g1 = rng.normal(size=(u, d)) * 0.1
    g2 = g1 * g1 + rng.uniform(0.0, 0.01, size=(u, d))
    sums = torch.from_numpy(
        np.concatenate([g1, g2], axis=1).astype(np.float32)).to(gpu)
    start = tuple(torch.from_numpy(
        rng.uniform(lo, hi, (vocab // 8, 128)).astype(np.float32)).to(gpu)
        for lo, hi in ((-0.1, 0.1), (0.1, 1.0)))
    rows = lambda t: micro_probe.unpack_table(t, d)  # noqa: E731
    kern = tuple(t.clone() for t in start)
    plain = tuple(t.clone() for t in start)
    # At D = 16 the [V, d] view is the packed table itself: K2 takes a copy.
    row_major = tuple(rows(t).clone(memory_format=torch.contiguous_format)
                      for t in start)
    before = micro_probe.k2p_apply.launches
    micro_probe.k2p_entries(urows, sums, *kern, lr=0.05, eps=1e-7)
    micro_probe.k2p_entries(urows, sums, *plain, lr=0.05, eps=1e-7,
                            plain=True)
    sparse_apply.k2_apply_cuda("adagrad", urows, sums, row_major,
                               sparse_apply.Hyper(lr=0.05, eps=1e-7))
    torch.cuda.synchronize()
    assert micro_probe.k2p_apply.launches == before + 1
    torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
    torch.testing.assert_close(kern[1], plain[1], **OPT_TOL)
    untouched = torch.ones(vocab, dtype=torch.bool, device=gpu)
    untouched[urows.long()] = False
    for got, was, want in zip(kern, start, row_major):
        assert torch.equal(rows(got), want)
        got16, was16 = got.view(-1, 16), was.view(-1, 16)
        assert torch.equal(got16[untouched], was16[untouched])
        assert torch.equal(got16[:, d:], was16[:, d:])
        assert not torch.equal(got16[-1, :d], was16[-1, :d])


@pytest.mark.gpu
def test_k2p_refuses_a_misaligned_table_on_the_gpu(gpu):
    """A packed table 4 bytes off a 16-byte boundary: the wrapper raises
    before it launches, and the C entry refuses the pointer
    (cudaErrorInvalidValue) without touching the table."""
    from fast_tffm_tpu_torch.ops import _build

    table = torch.zeros(4 * 128 + 1, device=gpu)[1:].view(4, 128)
    acc = torch.ones((4, 128), device=gpu)
    urows = torch.tensor([0, 3], dtype=torch.int32, device=gpu)
    sums = torch.ones((2, 18), device=gpu)
    before = micro_probe.k2p_apply.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        micro_probe.k2p_entries(urows, sums, table, acc, lr=0.05, eps=1e-7)
    assert micro_probe.k2p_apply.launches == before
    stream = torch.cuda.current_stream(gpu).cuda_stream
    rc = _build.load().k2p_apply(urows.data_ptr(), sums.data_ptr(),
                                 table.data_ptr(), acc.data_ptr(), 2, 9,
                                 0.05, 1e-7, stream)
    torch.cuda.synchronize()
    assert rc != 0
    assert not bool(table.any()) and bool((acc == 1).all())


@pytest.mark.gpu
def test_k2t_kernel_refuses_a_row_past_its_stage(gpu):
    """Past ``K2T_MAX_D`` a 32-entry tile's stage passes the SM's shared
    memory: the wrapper raises before it launches."""
    d = micro_probe.K2T_MAX_D + 1
    urows = torch.zeros(1, dtype=torch.int32, device=gpu)
    sums = torch.zeros((1, 2 * d), device=gpu)
    table = torch.zeros((d, 8), device=gpu)
    before = micro_probe.k2t_apply.launches
    with pytest.raises(ValueError, match=f"D <= {d - 1}"):
        micro_probe.k2t_entries(urows, sums, table, table.clone(), lr=0.05,
                                eps=1e-7)
    assert micro_probe.k2t_apply.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["k2t", "k2p"])
def test_layout_probe_wrappers_on_the_gpu(gpu, layout):
    """The reference's entry points (K1, then K2T or K2P) on the card
    against their plain versions; what the kernels do not take raises
    and launches nothing."""
    vocab, d = 1 << 14, 9
    ids, g, _, _, rng = _sparse_problem(gpu, 30000, d, 2000, vocab=vocab)
    table = torch.from_numpy(
        rng.uniform(-0.1, 0.1, (vocab, d)).astype(np.float32)).to(gpu)
    kern, _ = _layout(layout, table, torch.full_like(table, 0.1), d)
    plain = tuple(t.clone() for t in kern)
    wrapper = getattr(micro_probe, f"{layout}_apply")
    before = wrapper.launches
    out = wrapper(*kern, ids, g, lr=0.05, eps=1e-7)
    getattr(micro_probe, f"{layout}_apply_plain")(*plain, ids, g, lr=0.05,
                                                  eps=1e-7)
    torch.cuda.synchronize()
    assert out[0] is kern[0] and out[1] is kern[1]
    assert wrapper.launches == before + 1
    torch.testing.assert_close(kern[0], plain[0], **TABLE_TOL)
    torch.testing.assert_close(kern[1], plain[1], **OPT_TOL)
    for bad in ((kern[0], kern[1].cpu(), ids, g),
                (kern[0], kern[1], ids.clone().fill_(vocab), g),
                (kern[0], kern[1], ids, g.double())):
        with pytest.raises((TypeError, ValueError)):
            wrapper(*bad, lr=0.05, eps=1e-7)
    assert wrapper.launches == before + 1


def _segments(counts, seed=0):
    """Ids whose sorted segments have ``counts`` occurrences, in id
    order (segment ``u`` is id ``3u + 1``), shuffled: ``(ids, rng)``."""
    rng = np.random.default_rng(seed)
    ids = np.repeat(np.arange(len(counts), dtype=np.int32) * 3 + 1, counts)
    return ids[rng.permutation(ids.size)], rng


def _split_counts():
    """300 segments (not a multiple of a block's 128): counts cycling
    around the thread / warp split K1_SHORT, and long segments as the
    last of a warp (u = 31), of a block (u = 127) and of all (u = 299)."""
    t = sparse_apply.K1_SHORT
    counts = np.resize([t - 1, t, t + 1, 1, 2, 1, 40, 1, 3], 300)
    counts[[31, 127, 299]] = (100, 70, 2 * t + 5)
    return counts


@pytest.mark.gpu
@pytest.mark.parametrize("mode, width", [
    ("dedup", 1), ("dedup", 9), ("dedup", 16), ("dedup", 17),
    ("dedup", 50),  # [128, 100] sums do not fit 48 KB: written directly
    ("merge", 7), ("merge", 18), ("merge", 33), ("merge", 97),
])
def test_k1_thread_and_warp_segments(gpu, mode, width):
    """Segments on both sides of the thread / warp split, long ones at a
    warp's and a block's last lane, a ragged last block, every width
    the wrappers take (one or two column passes, staged or not): within
    the bound of the kernel's order, bitwise equal over two calls."""
    ids, rng = _segments(_split_counts(), seed=width)
    pay = rng.normal(size=(ids.size, width)).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(gpu)  # noqa: E731
    meta = sparse_apply.sort_meta(put(ids))
    urows, sums, urows2, sums2, want_rows, want64, bound = _k1_run(
        mode, put(pay), put(ids), meta)
    assert torch.equal(urows, want_rows) and urows.numel() == 300
    assert bool(torch.all((sums.double() - want64).abs() <= bound))
    assert torch.equal(urows, urows2) and torch.equal(sums, sums2)


@pytest.mark.gpu
def test_k1_merge_of_a_four_block_mesh(gpu):
    """K1's merge mode on the entries exchange of a 4 x 1 mesh: four
    data blocks' deduped streams, up to four entries per row, merged as
    merge_entries does, against the dense sums of all the occurrences
    (the plain version in float64) within the kernel's bound."""
    vocab, d, n_blk = 1 << 12, 9, 8000
    cap = sparse_apply.entries_cap(n_blk, vocab)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, vocab, 4 * n_blk).astype(np.int32)
    g = rng.normal(size=(4 * n_blk, d)).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(gpu)  # noqa: E731
    streams = [sparse_apply.unique_entries(put(ids[b::4]), put(g[b::4]),
                                           vocab=vocab, cap=cap)
               for b in range(4)]
    rows = torch.cat([r for r, _, _ in streams])
    pay = torch.cat([p for _, p, _ in streams])
    meta = sparse_apply.sort_meta(rows, drop_from=vocab)
    counts = meta.seg_start[1:] - meta.seg_start[:-1]
    assert int(counts.max()) == 4
    urows, sums, urows2, sums2, want_rows, want64, bound = _k1_run(
        "merge", pay, rows, meta)
    assert torch.equal(urows, want_rows)
    assert torch.equal(urows, urows2) and torch.equal(sums, sums2)
    assert bool(torch.all((sums.double() - want64).abs() <= bound))
    # The merged stream is the dense one: K1 over every occurrence.
    dense_rows, dense = sparse_apply.k1_dedup_plain(
        put(g).double(), put(ids), *sparse_apply.sort_meta(put(ids)))
    assert torch.equal(urows, dense_rows)
    torch.testing.assert_close(sums.double(), dense, rtol=1e-5, atol=1e-5)


def _host_batches(n, b=512, f=39, vocab=1 << 16, seed=9):
    """``n`` host batches with their native sort meta."""
    from fast_tffm_tpu_torch.data import native

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, f)).astype(np.int32)
        ids[:64, 0] = 7  # a hot id
        out.append(Batch(
            (rng.random(b) < 0.4).astype(np.float32), ids,
            rng.uniform(0.1, 1.0, (b, f)).astype(np.float32),
            np.zeros((b, f), np.int32), np.ones((b,), np.float32),
            native.sort_meta(ids, vocab)))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("k, depth", [(1, 1), (3, 2)])
def test_prefetcher_views_match_stack_batches_on_the_gpu(gpu, k, depth):
    """The transfer stage on the card: one pinned copy a super-batch
    (an epoch tail of K' = 1 included), its device views equal to
    ``stack_batches`` of the same group, the staging buffers pinned and
    recycled only behind their copies."""
    from fast_tffm_tpu_torch.data.prefetch import (
        DevicePrefetcher, stack_batches,
    )

    host = _host_batches(7)
    pre = DevicePrefetcher(host, k, gpu, 1 << 16, depth=depth)
    got = list(pre)
    assert [sb.n for sb in got] == [len(host[i:i + k])
                                    for i in range(0, 7, k)]
    for j, sb in enumerate(got):
        plain = stack_batches(host[j * k:j * k + sb.n], with_fields=False)
        for i in range(sb.n):
            step, want = sb.step(i), plain.step(i)
            assert step.ids.device.type == "cuda" and step.fields is None
            for a, b in zip(step[:5], want[:5]):
                if b is not None:
                    assert np.array_equal(a.cpu().numpy(), b)
            for a, b in zip(step.sort_meta, want.sort_meta):
                assert np.array_equal(a.cpu().numpy(), b)
    for bufs in pre._free.values():
        assert all(b.is_pinned() for b in bufs)


@pytest.mark.gpu
def test_steps_on_shipped_views_equal_steps_on_copied_batches(gpu):
    """Three sparse steps on the transfer stage's views train the same
    table, bitwise, as on ``to_device`` copies of the same batches."""
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
    from fast_tffm_tpu_torch.models import fm

    vocab = 1 << 16
    cfg = FmConfig(vocabulary_size=vocab, factor_num=8, max_features=39,
                   batch_size=512)
    host = _host_batches(3, vocab=vocab)
    init = fm.init_params(cfg, torch.Generator(device=gpu).manual_seed(1),
                          device=gpu)
    models = []
    for shipped in (True, False):
        model = fm.FmModel(init.w0.detach().clone(),
                           init.table.detach().clone())
        opt = sparse.init_sparse_opt_state(cfg, model)
        if shipped:
            batches = [sb.step(i) for sb in
                       DevicePrefetcher(host, 3, gpu, vocab)
                       for i in range(sb.n)]
        else:
            batches = [sparse.to_device(b, gpu) for b in host]
        for b in batches:
            sparse.sparse_step(cfg, model, opt, b)
        models.append((model, opt))
    (m1, o1), (m2, o2) = models
    assert torch.equal(m1.table, m2.table) and torch.equal(m1.w0, m2.w0)
    assert torch.equal(o1.acc_table, o2.acc_table)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl", "sgd"])
@pytest.mark.parametrize("n, unique, hot", [(20000, 3001, 5000),
                                            (4096, 4096, 0), (3, 2, 0)])
def test_static_k1_k2_kernels_match_plain_and_the_dynamic_kernels(
        gpu, optimizer, n, unique, hot):
    """K1 and K2 on the whole ``[n + 1]`` slot: bitwise the same kernels
    on the cut slot ``[U + 1]`` on the first U rows (row -1 after, no
    other table row written), and the plain versions on the whole slot
    within the kernels' bounds."""
    rng = np.random.default_rng(n)
    d, vocab = 9, 1 << 16
    if unique == n:
        ids = rng.choice(vocab, n, replace=False).astype(np.int32)
    else:
        pool = rng.choice(vocab, unique, replace=False)
        ids = pool[rng.integers(0, unique, n)].astype(np.int32)
    ids[:hot] = 77
    meta = host_sort_meta(ids)
    u = meta.seg_start.shape[0] - 1
    full = np.full((n + 1,), n, np.int32)
    full[:u + 1] = meta.seg_start
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(gpu)
    g = put(rng.normal(0.0, 0.1, (n, d)).astype(np.float32))
    ids_d, perm, seg, slot = put(ids), put(meta.perm), put(meta.seg_start), \
        put(full)
    before = sparse_apply.k1_dedup_cuda.launches
    s_rows, s_sums = sparse_apply.k1_dedup_cuda(g, ids_d, perm, slot)
    assert sparse_apply.k1_dedup_cuda.launches == before + 1
    urows, sums = sparse_apply.k1_dedup_cuda(g, ids_d, perm, seg)
    p_rows, p_sums = sparse_apply.k1_dedup_plain(g, ids_d, perm, slot)
    torch.cuda.synchronize()
    assert s_rows.shape == (n,) and s_sums.shape == (n, 2 * d)
    assert torch.equal(s_rows[:u], urows) and torch.equal(s_sums[:u], sums)
    assert bool((s_rows[u:] == -1).all())
    assert torch.equal(s_rows, p_rows)
    torch.testing.assert_close(s_sums[:u], p_sums[:u], rtol=1e-5, atol=1e-5)
    count = {"sgd": 1, "adagrad": 2, "ftrl": 3}[optimizer]
    start = [put(rng.uniform(0.1, 1.0, (vocab, d)).astype(np.float32))
             for _ in range(count)]
    dyn, stat, plain = ([t.clone() for t in start] for _ in range(3))
    hyper = sparse_apply.Hyper(lr=0.05, l1=0.01, l2=0.1)
    sparse_apply.k2_apply_cuda(optimizer, urows, sums, dyn, hyper)
    before = sparse_apply.k2_apply_cuda.launches
    sparse_apply.k2_apply_cuda(optimizer, s_rows, s_sums, stat, hyper)
    assert sparse_apply.k2_apply_cuda.launches == before + 1
    sparse_apply.k2_apply_plain(optimizer, s_rows, s_sums, plain, hyper)
    torch.cuda.synchronize()
    untouched = torch.ones(vocab, dtype=torch.bool, device=gpu)
    untouched[urows.long()] = False
    for i, (a, b, c, t0) in enumerate(zip(dyn, stat, plain, start)):
        assert torch.equal(a, b)
        assert torch.equal(b[untouched], t0[untouched])
        torch.testing.assert_close(b, c, **(OPT_TOL if i else TABLE_TOL))


def _dispatch_cfg(tmp_path, optimizer, dtype, k):
    return FmConfig(vocabulary_size=1 << 16, factor_num=8, max_features=39,
                    batch_size=512, optimizer=optimizer, compute_dtype=dtype,
                    learning_rate=0.05, ftrl_l1=0.01, ftrl_l2=0.1,
                    factor_lambda=1e-3, bias_lambda=1e-3, seed=5,
                    model_file=str(tmp_path / "none"),
                    steps_per_dispatch=k)


def _trainer(cfg, gpu, graphs: bool):
    """A trainer on ``gpu``; ``graphs=False``: every dispatch eager (its
    ``graph`` set to None)."""
    from fast_tffm_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device=gpu)
    if not graphs:
        trainer.graph = None
    return trainer


def _trained_state(trainer):
    """Tables, optimizer state, w0, the streaming metrics and the health
    carry (its tensors advance inside the graph's replays too)."""
    m = trainer.metrics
    return ([trainer.model.table, trainer.model.w0,
             *sparse.opt_tables(trainer.opt_state)]
            + [t for t in trainer.opt_state if t.dim() == 0]
            + [m.loss_sum, m.weight_sum, m.count, m.auc.pos, m.auc.neg]
            + list(trainer.health))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl", "sgd"])
@pytest.mark.parametrize("k", [1, 4])
def test_graphed_dispatch_is_bitwise_the_eager_one(gpu, tmp_path, k,
                                                   optimizer, dtype):
    """Nine batches through ``Trainer.dispatch``: the first full
    super-batch eager and captured, every later full one a replay of the
    CUDA graph, the tail (K = 4: one batch) eager; tables, optimizer
    state, w0, step losses and metrics bitwise those of the same
    dispatches run eagerly, and the kernels' launch counts the same."""
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
    from fast_tffm_tpu_torch.train.dispatch import COUNTERS

    cfg = _dispatch_cfg(tmp_path, optimizer, dtype, k)
    host = _host_batches(9, vocab=cfg.vocabulary_size)
    runs = []
    for graphs in (True, False):
        trainer = _trainer(cfg, gpu, graphs)
        counts = [getattr(fn, attr) for fn, attr in COUNTERS]
        losses = [trainer.dispatch(sb).clone() for sb in DevicePrefetcher(
            host, k, gpu, cfg.vocabulary_size)]
        torch.cuda.synchronize()
        launched = [getattr(fn, attr) - c
                    for (fn, attr), c in zip(COUNTERS, counts)]
        runs.append((trainer, torch.cat(losses), launched))
    (graphed, g_loss, g_launched), (eager, e_loss, e_launched) = runs
    full = 9 // k
    assert graphed.graph_dispatches == full - 1 > 0
    assert graphed.eager_dispatches == 1 + (9 % k > 0)
    assert eager.graph is None and eager.graph_dispatches == 0
    assert g_launched == e_launched and sum(g_launched) >= 4 * 9
    assert torch.equal(g_loss, e_loss)
    for a, b in zip(_trained_state(graphed), _trained_state(eager)):
        assert torch.equal(a, b)
    assert graphed.graph.pool_bytes() > 0


@pytest.mark.gpu
def test_autotune_measures_three_candidates_on_the_gpu(gpu, monkeypatch):
    """``interaction_impl = auto`` on the card: reference, pallas and
    packed all run and pass the parity gate in the train context (graph
    replays timed, eager times beside) and in the serve context at every
    table dtype; a second resolve is a cache hit."""
    from fast_tffm_tpu_torch.ops import autotune

    monkeypatch.setattr(autotune, "_MEM_CACHE", {})
    every = ("reference", "pallas", "packed")
    for context, dtype in (("train", "fp32"), ("serve", "fp32"),
                           ("serve", "bf16"), ("serve", "int8")):
        cfg = FmConfig(vocabulary_size=1 << 16, factor_num=8,
                       max_features=39, batch_size=1024,
                       interaction_impl="auto", serve_table_dtype=dtype)
        d = autotune.resolve(cfg, context=context, cache_path="",
                             device=gpu)
        assert d.source == "measured" and tuple(d.candidates) == every
        assert set(d.times_ms) == set(every)
        assert set(d.eager_ms) == (set(every) if context == "train"
                                   else set())
        for name in every:
            assert np.isfinite(d.parity_err[name])
            assert d.parity_err[name] <= autotune.PARITY_TOL
        n = autotune.measurement_count()
        again = autotune.resolve(cfg, context=context, cache_path="",
                                 device=gpu)
        assert again.source == "cache" and again.impl == d.impl
        assert autotune.measurement_count() == n


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["raises", "wrong"])
def test_autotune_raises_on_a_failed_kernel_candidate(gpu, monkeypatch,
                                                      how):
    """On the card a ``pallas`` candidate that raises, or that fails the
    parity gate, makes ``resolve`` raise with its name: ``auto`` never
    falls back to the plain version, and caches nothing."""
    from fast_tffm_tpu_torch.ops import autotune

    monkeypatch.setattr(autotune, "_MEM_CACHE", {})
    cfg = FmConfig(vocabulary_size=1 << 16, factor_num=8, max_features=39,
                   batch_size=1024, interaction_impl="auto")
    make, args = autotune._candidate_fns(cfg, "train", 1024, "fp32", gpu)

    def broken(user_impl):
        fn = make(user_impl)
        if user_impl != "pallas":
            return fn
        if how == "wrong":
            return lambda *a: tuple(2.0 * t for t in fn(*a))

        def f(*a):
            raise RuntimeError("injected launch failure")
        return f

    with pytest.raises(RuntimeError, match="candidate pallas"):
        autotune.resolve(cfg, cache_path="", device=gpu,
                         candidate_fns=(broken, args))
    assert autotune._MEM_CACHE == {}


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["reference", "pallas", "packed"])
def test_graphed_step_of_each_interaction_is_bitwise_eager(gpu, tmp_path,
                                                           impl):
    """A pinned interaction through ``Trainer.dispatch``: the replays of
    the CUDA graph (the packed steps' products among them) bitwise the
    eager steps, FmScorer and FmGrad launched only under ``pallas``."""
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
    from fast_tffm_tpu_torch.train.dispatch import COUNTERS

    cfg = dataclasses.replace(_dispatch_cfg(tmp_path, "adagrad", "float32",
                                            1), interaction_impl=impl)
    host = _host_batches(5, vocab=cfg.vocabulary_size)
    runs = []
    for graphs in (True, False):
        trainer = _trainer(cfg, gpu, graphs)
        assert trainer.kernel_impl == impl
        counts = [getattr(fn, attr) for fn, attr in COUNTERS]
        losses = [trainer.dispatch(sb).clone() for sb in DevicePrefetcher(
            host, 1, gpu, cfg.vocabulary_size)]
        torch.cuda.synchronize()
        launched = [getattr(fn, attr) - c
                    for (fn, attr), c in zip(COUNTERS, counts)]
        runs.append((trainer, torch.cat(losses), launched))
    (graphed, g_loss, g_launched), (eager, e_loss, e_launched) = runs
    assert graphed.graph_dispatches == 4
    assert g_launched == e_launched
    fm_launches = g_launched[0] + g_launched[2]  # FmScorer, FmGrad (f32)
    assert fm_launches == (10 if impl == "pallas" else 0)
    assert torch.equal(g_loss, e_loss)
    for a, b in zip(_trained_state(graphed), _trained_state(eager)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_capture_while_the_transfer_thread_ships(gpu, tmp_path):
    """``Trainer.train()`` captures its graph while the transfer thread
    keeps shipping (two parse threads, two super-batches in flight), over
    two epochs of eleven batches at K = 2 (a tail of one an epoch): the
    run trains, bitwise, what the same run trains eagerly."""
    rng = np.random.default_rng(4)
    path = tmp_path / "train.libsvm"
    with open(path, "w") as f:
        for _ in range(512 * 11):
            ids = rng.integers(0, 1 << 20, 30)
            f.write(f"{int(rng.random() < 0.3)} "
                    + " ".join(f"{i}:{rng.uniform(0.1, 1):.3f}" for i in ids)
                    + "\n")
    cfg = dataclasses.replace(
        _dispatch_cfg(tmp_path, "adagrad", "float32", 2),
        train_files=[str(path)], epoch_num=2, thread_num=2,
        prefetch_super_batches=2, log_steps=0, save_steps=0)
    results = []
    for graphs in (True, False):
        trainer = _trainer(dataclasses.replace(
            cfg, model_file=str(tmp_path / f"m{graphs}")), gpu, graphs)
        results.append((trainer, trainer.train()["train"]))
    (graphed, g_tr), (eager, e_tr) = results
    assert g_tr["steps"] == e_tr["steps"] == 22
    assert g_tr["graph_dispatches"] == 9 and g_tr["eager_dispatches"] == 3
    assert e_tr["eager_dispatches"] == e_tr["dispatches"] == 12
    for a, b in zip(_trained_state(graphed), _trained_state(eager)):
        assert torch.equal(a, b)


def _health_file(tmp_path, batches: int) -> str:
    rng = np.random.default_rng(8)
    path = tmp_path / "health.libsvm"
    with open(path, "w") as f:
        for _ in range(512 * batches):
            ids = rng.integers(0, 1 << 16, 20)
            f.write(f"{int(rng.random() < 0.3)} "
                    + " ".join(f"{i}:{rng.uniform(0.1, 1):.3f}" for i in ids)
                    + "\n")
    return str(path)


@pytest.mark.gpu
def test_health_carry_of_a_graphed_dispatch_is_bitwise_eager(gpu, tmp_path):
    """``Trainer.train()`` at K = 4 over 13 batches (a capture, two
    replays, a tail of one): the health carry (grad norms, non-finite
    count, the device step counter, touched rows and occurrences) and the
    exact summary are bitwise those of the same run eager; the summary's
    occurrence count is the batches' real values."""
    path = _health_file(tmp_path, 13)
    cfg = dataclasses.replace(
        _dispatch_cfg(tmp_path, "adagrad", "float32", 4),
        train_files=[path], epoch_num=1, log_steps=0, save_steps=0)
    runs = []
    for graphs in (True, False):
        trainer = _trainer(dataclasses.replace(
            cfg, model_file=str(tmp_path / f"m{graphs}")), gpu, graphs)
        runs.append((trainer, trainer.train()["train"]))
    (graphed, g_tr), (eager, e_tr) = runs
    assert g_tr["graph_dispatches"] == 2 and e_tr["graph_dispatches"] == 0
    for a, b in zip(graphed.health, eager.health):
        assert torch.equal(a, b)
    assert g_tr["health"] == e_tr["health"]
    assert int(graphed.health.step) == 13
    assert g_tr["health"]["emb_touch_events"] == 13 * 512 * 20
    assert g_tr["health"]["nonfinite_steps"] == 0


@pytest.mark.gpu
def test_poisoned_replay_halts_within_one_dispatch(gpu, tmp_path):
    """``w0`` filled with NaN in place after the graph is captured: the
    next replay trains the poison, ``nan_policy = halt`` raises within
    one dispatch of it, and the last checkpoint is the clean save
    before it (``save_steps = K``)."""
    from fast_tffm_tpu_torch.train import checkpoint
    from fast_tffm_tpu_torch.train.loop import NonFiniteGradError

    k = 4
    cfg = dataclasses.replace(
        _dispatch_cfg(tmp_path, "adagrad", "float32", k),
        train_files=[_health_file(tmp_path, 24)], epoch_num=1,
        log_steps=0, save_steps=k, nan_policy="halt",
        model_file=str(tmp_path / "m"))
    trainer = _trainer(cfg, gpu, True)
    real = trainer.dispatch
    seen = []

    def poison_after_capture(sb, pause=None):
        if trainer.graph.captured and len(seen) == 2:
            with torch.no_grad():
                trainer.model.w0.detach().fill_(float("nan"))
        seen.append(trainer.graph.captured)
        return real(sb, pause)

    trainer.dispatch = poison_after_capture
    with pytest.raises(NonFiniteGradError):
        trainer.train()
    # Dispatch 2 (a replay) trained the poison; the save boundary after
    # it reads its health first and halts.
    assert seen == [False, True, True]
    assert trainer.graph_dispatches == 2
    assert int(trainer.health.first_nonfinite_step) == 2 * k
    step, _ = checkpoint.restore_params(cfg.model_file, device="cpu")
    assert step == 2 * k


@pytest.mark.gpu
def test_packed_groups_are_pinned_and_shipped_with_no_fill(gpu):
    """The prestacked cache's packer on the card: each group packed once
    into a pinned buffer, shipped as it is (views equal to
    ``stack_batches``), a prestack hit with no fill, and the buffer
    never taken into the stage's free pool nor written again while plain
    groups cycle through it."""
    from fast_tffm_tpu_torch.data.prefetch import (
        DevicePrefetcher, Packer, stack_batches,
    )

    host = _host_batches(6)
    packer = Packer(gpu, 1 << 16)
    packed = packer.pack(host[:2])
    assert packed.buffer.is_pinned()
    snapshot = packed.buffer.clone()
    hits, fills = DevicePrefetcher.prestack_hits, DevicePrefetcher.fills
    src = [packed, host[2], host[3], packed, host[4], host[5], packed]
    pre = DevicePrefetcher(src, 2, gpu, 1 << 16, depth=1, packer=packer)
    got = list(pre)
    assert [sb.n for sb in got] == [2] * 5
    assert DevicePrefetcher.prestack_hits - hits == 3
    assert DevicePrefetcher.fills - fills == 2
    plain = stack_batches(host[:2], with_fields=False)
    for sb in got[::2]:
        for i in range(2):
            for a, b in zip(sb.step(i).sort_meta, plain.step(i).sort_meta):
                assert np.array_equal(a.cpu().numpy(), b)
            assert np.array_equal(sb.step(i).ids.cpu().numpy(),
                                  plain.step(i).ids)
    assert torch.equal(packed.buffer, snapshot)
    for bufs in pre._free.values():
        assert all(b is not packed.buffer and b.is_pinned() for b in bufs)


@pytest.mark.gpu
@pytest.mark.parametrize("cache, procs", [("prestacked", 0), ("on", 2)])
def test_cached_and_pooled_runs_are_graphed_as_any_other(gpu, tmp_path,
                                                         cache, procs):
    """Three cached epochs of five batches at K = 2 (a tail of one an
    epoch), prestacked on threads and plain on two workers: every full
    super-batch after the first replays the graph, the tails run eagerly,
    and the run trains, bitwise, what the same run trains eagerly."""
    rng = np.random.default_rng(6)
    path = tmp_path / "train.libsvm"
    with open(path, "w") as f:
        for _ in range(512 * 5):
            ids = rng.integers(0, 1 << 20, 30)
            f.write(f"{int(rng.random() < 0.3)} "
                    + " ".join(f"{i}:{rng.uniform(0.1, 1):.3f}" for i in ids)
                    + "\n")
    cfg = dataclasses.replace(
        _dispatch_cfg(tmp_path, "adagrad", "float32", 2),
        train_files=[str(path)], epoch_num=3, thread_num=2, log_steps=0,
        save_steps=0, cache_epochs=True,
        cache_prestacked=cache == "prestacked", parse_processes=procs)
    results = []
    for graphs in (True, False):
        trainer = _trainer(dataclasses.replace(
            cfg, model_file=str(tmp_path / f"m{graphs}")), gpu, graphs)
        results.append((trainer, trainer.train()["train"]))
    (graphed, g_tr), (eager, e_tr) = results
    assert g_tr["steps"] == e_tr["steps"] == 15
    assert g_tr["ingest_cache"] == e_tr["ingest_cache"] == "cached"
    assert g_tr["graph_dispatches"] == 5 and g_tr["eager_dispatches"] == 4
    for a, b in zip(_trained_state(graphed), _trained_state(eager)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 4])
def test_ffm_graphed_dispatch_matches_eager_and_plain(gpu, tmp_path, k,
                                                      dtype):
    """Field-aware FM (P = 4, k = 8: D = 33, the FFM-Criteo width) on the
    card.  The op's forward and closed-form backward against autograd
    through ``ffm_scores_from_rows`` (f32 ``rtol=1e-5, atol=1e-6``; bf16
    against f32 ``rtol=2e-2, atol=2e-2``).  Nine batches with fields
    through ``Trainer.dispatch``, graphed and eager: bitwise equal, K1
    and K2 launched every step, no FmScorer or FmGrad.  Then three steps
    through the kernels against three through the plain path."""
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.ops import interaction
    from fast_tffm_tpu_torch.train.dispatch import COUNTERS

    p, kf = 4, 8
    cd = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rng = np.random.default_rng(11)
    rows = torch.from_numpy(rng.uniform(-0.3, 0.3, (512, 39, 1 + p * kf))
                            .astype(np.float32)).to(gpu)
    vals = torch.from_numpy(rng.uniform(0.1, 1.0, (512, 39))
                            .astype(np.float32)).to(gpu)
    fields = torch.from_numpy((np.arange(39) % p).astype(np.int32)).to(
        gpu).expand(512, 39).contiguous()
    g = torch.from_numpy(rng.uniform(-1, 1, 512).astype(np.float32)).to(gpu)

    def fwd_bwd(fn, compute):
        r = rows.clone().requires_grad_()
        s = fn(r, vals, fields, kf, p, compute)
        d, = torch.autograd.grad((s * g).sum(), r)
        return s.detach(), d

    def oracle(r, v, f, kk, pp, compute):
        return fm.ffm_scores_from_rows(torch.zeros((), device=gpu), r, v, f,
                                       kk, pp, compute)

    s_op, d_op = fwd_bwd(interaction.ffm_interaction, cd)
    s_or, d_or = fwd_bwd(oracle, torch.float32)
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(s_op, s_or, **tol)
    torch.testing.assert_close(d_op, d_or, **tol)

    cfg = dataclasses.replace(_dispatch_cfg(tmp_path, "adagrad", dtype, k),
                              field_num=p)
    host = [b._replace(fields=np.tile((np.arange(39) + i) % p, (512, 1))
                       .astype(np.int32))
            for i, b in enumerate(_host_batches(9, vocab=cfg.vocabulary_size))]
    runs = []
    for graphs in (True, False):
        trainer = _trainer(cfg, gpu, graphs)
        counts = [getattr(fn, attr) for fn, attr in COUNTERS]
        losses = [trainer.dispatch(sb).clone() for sb in DevicePrefetcher(
            host, k, gpu, cfg.vocabulary_size, with_fields=True)]
        torch.cuda.synchronize()
        launched = {f"{fn.__name__}.{attr}": getattr(fn, attr) - c
                    for (fn, attr), c in zip(COUNTERS, counts)}
        runs.append((trainer, torch.cat(losses), launched))
    (graphed, g_loss, g_launched), (eager, e_loss, e_launched) = runs
    assert graphed.graph_dispatches == 9 // k - 1 > 0
    assert g_launched == e_launched
    assert g_launched["k1_dedup_cuda.launches"] == 9
    assert g_launched["k2_apply_cuda.launches"] == 9
    assert sum(n for name, n in g_launched.items()
               if name.startswith("fm_")) == 0
    assert torch.equal(g_loss, e_loss)
    for a, b in zip(_trained_state(graphed), _trained_state(eager)):
        assert torch.equal(a, b)

    init = fm.init_params(cfg, torch.Generator(device=gpu).manual_seed(3),
                          device=gpu)
    models = [fm.FmModel(init.w0.detach().clone(), init.table.detach().clone())
              for _ in range(2)]
    opts = [sparse.init_sparse_opt_state(cfg, m) for m in models]
    for b in host[:3]:
        dev_b = sparse.to_device(b, gpu)
        s_k = sparse.sparse_step(cfg, models[0], opts[0], dev_b)
        s_p = sparse.sparse_step(cfg, models[1], opts[1], dev_b, plain=True,
                                 impl="jnp")
        torch.testing.assert_close(s_k, s_p, **TOL)
    torch.testing.assert_close(models[0].table, models[1].table, **TABLE_TOL)
    torch.testing.assert_close(opts[0].acc_table, opts[1].acc_table,
                               **OPT_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("field_num", [0, 3])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantized_gpu_scorer_matches_cpu_scorer(gpu, dtype, field_num):
    """A bf16 or int8 table placed on the card scores as on the CPU (the
    FmScorer kernel against its plain version; FFM's einsums alike), and
    the placed tensors hold exactly the gauge's bytes."""
    from fast_tffm_tpu_torch.obs.telemetry import Telemetry

    k = 4
    dim = 1 + (field_num or 1) * k
    cfg = FmConfig(vocabulary_size=301, factor_num=k, max_features=39,
                   field_num=field_num, serve_batch_sizes="8,32",
                   serve_table_dtype=dtype, quant_chunk=16)
    rng = np.random.default_rng(5)
    table = rng.uniform(-0.3, 0.3, (301, dim)).astype(np.float32)
    ids = rng.integers(0, 301, (70, 39)).astype(np.int32)
    vals = rng.uniform(0.0, 1.0, (70, 39)).astype(np.float32)
    fields = (rng.integers(0, field_num, (70, 39)).astype(np.int32)
              if field_num else None)
    tel = Telemetry()
    on_gpu = FixedShapeScorer(cfg, weights.from_jax(0.1, table, device=gpu),
                              device=gpu, telemetry=tel)
    on_cpu = FixedShapeScorer(cfg, weights.from_jax(0.1, table,
                                                    device="cpu"),
                              device="cpu")
    before = fm_kernels.fm_scores_cuda.launches
    on_gpu.warmup()
    got = on_gpu.score(ids, vals, fields)
    if not field_num:
        assert fm_kernels.fm_scores_cuda.launches == before + 5
    np.testing.assert_allclose(got, on_cpu.score(ids, vals, fields),
                               rtol=1e-5, atol=1e-6)
    placed = on_gpu._model
    held = sum(t.numel() * t.element_size() for t in placed[1:])
    assert held == tel.snapshot()["gauges"]["serve.table_bytes"]


@pytest.mark.gpu
@pytest.mark.parametrize("cold_dtype", ["fp32", "int8"])
def test_overlay_gpu_scorer_matches_cpu_scorer(gpu, cold_dtype):
    """The overlay scorer's compact table copied to the card scores as
    on the CPU, through the FmScorer kernel."""
    from fast_tffm_tpu_torch.serve.scorer import OverlayScorer
    from fast_tffm_tpu_torch.train import tiered

    cfg = FmConfig(vocabulary_size=1 << 26, factor_num=8, max_features=39,
                   serve_batch_sizes="8,32", table_tiering="on",
                   cold_dtype=cold_dtype)
    rng = np.random.default_rng(6)
    store = tiered._virtual_store(cfg, "table")
    written = rng.choice(1 << 26, 5000, replace=False)
    store.scatter(written, rng.normal(0, 0.2, (5000, 9)).astype(np.float32))
    ids = np.where(rng.random((70, 39)) < 0.5,
                   written[rng.integers(0, 5000, (70, 39))],
                   rng.integers(0, 1 << 26, (70, 39))).astype(np.int32)
    vals = rng.uniform(0.0, 1.0, (70, 39)).astype(np.float32)
    held = torch.cuda.memory_allocated(gpu)
    on_gpu = OverlayScorer(cfg, 0.1, store, device=gpu)
    on_cpu = OverlayScorer(cfg, 0.1, store, device="cpu")
    before = fm_kernels.fm_scores_cuda.launches
    on_gpu.warmup()
    got = on_gpu.score(ids, vals)
    assert fm_kernels.fm_scores_cuda.launches == before + 5
    np.testing.assert_allclose(got, on_cpu.score(ids, vals),
                               rtol=1e-5, atol=1e-6)
    # No [V, D] table: the card holds the staging and the rungs only.
    added = torch.cuda.memory_allocated(gpu) - held
    assert 0 < on_gpu.staging_bytes() <= added < (1 << 20)


@pytest.mark.gpu
def test_tiered_writeback_reads_the_rows_at_gather_time(gpu):
    """The migration's write-back: the evicted slots are gathered, copied
    into a pinned host buffer without blocking, and read by the cold
    store only after the copy's event.  With a long kernel queued first
    (so the copy is still pending when the plan is made) and the slots
    overwritten again right after, the re-fetched rows are the ones the
    table held when the gather ran."""
    from fast_tffm_tpu_torch.train.loop import Trainer

    cfg = FmConfig(vocabulary_size=64, factor_num=2, max_features=2,
                   batch_size=1, table_tiering="on", hot_rows=8, seed=1)
    t = Trainer(cfg, device=gpu)
    man = t.tiered

    def ship(ids):
        _, plan = man.plan(np.asarray(ids, np.int32).reshape(1, -1))
        views = {name: torch.from_numpy(a).to(gpu)
                 for name, a in plan.leaves()}
        return plan.ship(None, views)

    t._apply_migration(ship(range(6)))
    with torch.no_grad():  # what six rows' training left there
        t.model.table.copy_(torch.arange(
            t.model.table.numel(), dtype=torch.float32,
            device=gpu).view_as(t.model.table))
    held = t.model.table.detach().cpu().numpy().copy()
    big = torch.randn((4096, 4096), device=gpu)
    for _ in range(20):  # keep the stream busy past the plan below
        big = big @ big * 1e-3
    sh = ship(range(6, 10))
    assert sh.n_evict == 2
    evicted = man.id_of_slot_applied[sh.evict_slots[:2].cpu().numpy()]
    t._apply_migration(sh)
    with torch.no_grad():
        t.model.table.index_fill_(0, sh.evict_slots[:2].long(), -1.0)
    _, p3 = man.plan(np.array([[int(evicted[0]), 6]], np.int32))
    assert p3.n_load == 1
    want = held[int(sh.evict_slots[0])]
    np.testing.assert_array_equal(p3.load_rows[0][0], want)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl"])
def test_tiered_run_matches_the_dense_run_on_the_gpu(gpu, tmp_path,
                                                     optimizer):
    """On the card, the tiered trainer (eager, device sort, K1 and K2 on
    the cut slot, migrations at hot_rows = 160) ends bitwise where the
    graphed dense trainer (host sort meta) ends from the same seed."""
    from fast_tffm_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    path = tmp_path / "train.libsvm"
    with open(path, "w") as f:
        for i in range(256):
            f.write(f"{i % 2} {rng.integers(0, 256)}:1 "
                    f"{rng.integers(0, 256)}:0.5 {rng.integers(0, 256)}:0.25\n")
    common = dict(vocabulary_size=256, factor_num=4, max_features=4,
                  batch_size=32, train_files=[str(path)], epoch_num=2,
                  log_steps=0, thread_num=1, seed=3, steps_per_dispatch=2,
                  optimizer=optimizer)
    d = Trainer(FmConfig(model_file=str(tmp_path / "d"), **common),
                device=gpu)
    rd = d.train()
    t = Trainer(FmConfig(model_file=str(tmp_path / "t"), table_tiering="on",
                         hot_rows=160, **common), device=gpu)
    before = sparse_apply.k2_apply_cuda.launches
    rt = t.train()
    assert sparse_apply.k2_apply_cuda.launches - before == 16
    assert rd["train"]["graph_dispatches"] > 0
    assert rt["train"]["graph_dispatches"] == 0
    assert rt["train"]["tiered"]["rows_evicted"] > 0
    assert rt["train"]["loss"] == rd["train"]["loss"]
    merged = t.tiered.merged_dense(t._hot_host_tables())
    dense = [d.model.table, *sparse.opt_tables(d.opt_state)]
    for a, b in zip(merged, dense):
        np.testing.assert_array_equal(a, b.detach().cpu().numpy())
    assert float(t.model.w0.detach()) == float(d.model.w0.detach())


@pytest.mark.gpu
@pytest.mark.parametrize("n, unique, hot", [(20000, 3001, 5000),
                                            (4096, 4096, 0), (3, 2, 0)])
def test_kplace_takes_a_whole_slot_k1_stream(gpu, n, unique, hot):
    """K1's merge mode on the whole ``[n + 1]`` slot ends its rows in a
    run of -1 (their sums unwritten); K-place takes those rows as absent:
    its delta is bitwise the cut slot's and the plain version's, on the
    whole table and on a shard that starts past row 0."""
    rng = np.random.default_rng(n + 1)
    d, vocab = 9, 1 << 14
    pool = rng.choice(vocab, unique, replace=False)
    ids = pool[rng.integers(0, unique, n)].astype(np.int32)
    ids[:hot] = 77
    meta = host_sort_meta(ids)
    u = meta.seg_start.shape[0] - 1
    full = np.full((n + 1,), n, np.int32)
    full[:u + 1] = meta.seg_start
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(gpu)  # noqa: E731
    g = put(rng.normal(0.0, 0.1, (n, d)).astype(np.float32))
    ids_d, perm = put(ids), put(meta.perm)
    w_rows, w_sums = sparse_apply.k1_merge_cuda(g, ids_d, perm, put(full))
    c_rows, c_sums = sparse_apply.k1_merge_cuda(g, ids_d, perm,
                                                put(meta.seg_start))
    torch.cuda.synchronize()
    assert w_rows.shape == (n,) and bool((w_rows[u:] == -1).all())
    assert torch.equal(w_rows[:u], c_rows)
    for row_lo, local in ((0, vocab), (40, vocab - 40)):
        whole = sparse_apply.kplace_cuda(w_rows, w_sums, row_lo, local)
        cut = sparse_apply.kplace_cuda(c_rows, c_sums, row_lo, local)
        plain = sparse_apply.kplace_plain(w_rows, w_sums, row_lo, local)
        torch.cuda.synchronize()
        assert torch.equal(whole, cut) and torch.equal(whole, plain)


def _dense_cfg(tmp_path, optimizer, dtype, k, l2_mode="full"):
    return dataclasses.replace(
        _dispatch_cfg(tmp_path, optimizer, dtype, k), sparse_update=False,
        l2_mode=l2_mode)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer, dtype", [
    ("adam", "float32"), ("adam", "bfloat16"), ("adagrad", "float32"),
    ("ftrl", "float32"), ("sgd", "float32")])
def test_dense_graphed_dispatch_is_bitwise_the_eager_one(gpu, tmp_path,
                                                         optimizer, dtype):
    """The dense step (full L2) over nine batches at K = 4: two full
    super-batches (the first eager and captured, the second a replay)
    and a tail; tables, every optimizer leaf (Adam's count and bias
    corrections on the device, so each replay uses its own count), w0,
    losses and metrics bitwise the all-eager run's.  Each step launches
    FmScorer, FmGrad, K1's merge mode and K-place once, K1 dedup and K2
    never."""
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
    from fast_tffm_tpu_torch.train.dispatch import COUNTERS

    cfg = _dense_cfg(tmp_path, optimizer, dtype, 4)
    host = _host_batches(9, vocab=cfg.vocabulary_size)
    runs = []
    for graphs in (True, False):
        trainer = _trainer(cfg, gpu, graphs)
        assert not trainer.sparse
        counts = [getattr(fn, attr) for fn, attr in COUNTERS]
        losses = [trainer.dispatch(sb).clone() for sb in DevicePrefetcher(
            host, 4, gpu, cfg.vocabulary_size)]
        torch.cuda.synchronize()
        launched = {f"{fn.__name__}.{attr}": getattr(fn, attr) - c
                    for (fn, attr), c in zip(COUNTERS, counts)}
        runs.append((trainer, torch.cat(losses), launched))
    (graphed, g_loss, g_launched), (eager, e_loss, e_launched) = runs
    assert graphed.graph_dispatches == 1 and graphed.eager_dispatches == 2
    assert g_launched == e_launched
    mode = "launches_bf16" if dtype == "bfloat16" else "launches"
    for name in (f"fm_scores_cuda.{mode}", f"fm_grad_cuda.{mode}",
                 "k1_merge_cuda.launches", "kplace_cuda.launches"):
        assert g_launched[name] == 9, name
    assert g_launched["k1_dedup_cuda.launches"] == 0
    assert g_launched["k2_apply_cuda.launches"] == 0
    assert torch.equal(g_loss, e_loss)
    m_g, m_e = graphed.metrics, eager.metrics
    for a, b in zip(
            [graphed.model.table, graphed.model.w0, *graphed.opt_state,
             m_g.loss_sum, m_g.weight_sum, m_g.count, m_g.auc.pos],
            [eager.model.table, eager.model.w0, *eager.opt_state,
             m_e.loss_sum, m_e.weight_sum, m_e.count, m_e.auc.pos]):
        assert torch.equal(a, b)
    if optimizer == "adam":
        assert int(graphed.opt_state.count) == 9


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adam", "adagrad"])
@pytest.mark.parametrize("l2_mode", ["batch", "full"])
def test_dense_step_on_the_gpu_matches_the_plain_step(gpu, tmp_path,
                                                      monkeypatch, optimizer,
                                                      l2_mode):
    """Three dense steps through the kernels (FmScorer, FmGrad, K1's
    merge mode, K-place) against three through their plain versions, on
    the card, from one table: each step's scores at the kernels' bound
    and the gradient it applies at the tile-vs-scatter table bound.
    Adagrad runs free: its table at that bound and its state at
    ``atol=1e-4`` after the steps.  Adam (at a learning rate of 1e-3)
    restarts each plain step from the kernel run's state, so a step's
    difference is its own: its moments at ``atol=1e-4``, its count equal
    and its table at the table bound wherever the step's two gradients
    agree to ``rtol=1e-4``.  Adam's update ``mu / sqrt(nu)`` is
    scale-free, so an element whose gradient nearly cancels passes its
    whole relative rounding on; those are at most a hundredth of the
    table."""
    from fast_tffm_tpu_torch.models import fm
    from fast_tffm_tpu_torch.train import dense, optimizers

    cfg = _dense_cfg(tmp_path, optimizer, "float32", 1, l2_mode)
    if optimizer == "adam":
        cfg = dataclasses.replace(cfg, learning_rate=1e-3)
    applied = []
    apply_dense = dense.apply_dense

    def spy(cfg, model, opt_state, dw0, dtable):
        applied.append((dw0.clone(), dtable.clone()))
        apply_dense(cfg, model, opt_state, dw0, dtable)

    monkeypatch.setattr(dense, "apply_dense", spy)
    init = fm.init_params(cfg, torch.Generator(device=gpu).manual_seed(3),
                          device=gpu)
    models = [fm.FmModel(init.w0.detach().clone(), init.table.detach().clone())
              for _ in range(2)]
    opts = [optimizers.init_dense_opt_state(cfg, m) for m in models]
    leaves = [[m.table, m.w0, *o] for m, o in zip(models, opts)]
    before = sparse_apply.kplace_cuda.launches
    for b in _host_batches(3, vocab=cfg.vocabulary_size):
        if optimizer == "adam":
            with torch.no_grad():
                for a, c in zip(*leaves):
                    c.copy_(a)
        dev_b = sparse.to_device(b, gpu)
        s_k = dense.dense_step(cfg, models[0], opts[0], dev_b)
        s_p = dense.dense_step(cfg, models[1], opts[1], dev_b, plain=True,
                               impl="jnp")
        (gw_k, g_k), (gw_p, g_p) = applied[-2:]
        torch.testing.assert_close(s_k, s_p, **TOL)
        torch.testing.assert_close(g_k, g_p, **TABLE_TOL)
        torch.testing.assert_close(gw_k, gw_p, **TABLE_TOL)
        if optimizer == "adam":
            ok = (g_k - g_p).abs() <= 1e-4 * g_p.abs()
            assert int((~ok).sum()) <= ok.numel() // 100
            t_k, t_p = models[0].table.detach(), models[1].table.detach()
            torch.testing.assert_close(t_k[ok], t_p[ok], **TABLE_TOL)
            for a, c in zip(opts[0][:4], opts[1][:4]):
                torch.testing.assert_close(a, c, **OPT_TOL)
            assert torch.equal(opts[0].count, opts[1].count)
    torch.cuda.synchronize()
    assert sparse_apply.kplace_cuda.launches == before + 3
    if optimizer == "adagrad":
        torch.testing.assert_close(models[0].table, models[1].table,
                                   **TABLE_TOL)
        torch.testing.assert_close(models[0].w0, models[1].w0, **TABLE_TOL)
        for a, c in zip(opts[0], opts[1]):
            torch.testing.assert_close(a, c, **OPT_TOL)


ORBAX_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "data", "orbax")


def _orbax_fixture(name, **kw):
    with open(os.path.join(ORBAX_FIXTURES, "fixtures.json")) as f:
        spec = json.load(f)[name]
    cfg = FmConfig(model_file=os.path.join(ORBAX_FIXTURES, name),
                   **{**spec["cfg"], **kw})
    req = np.load(os.path.join(ORBAX_FIXTURES, f"{name}.npz"))
    return cfg, spec, req


@pytest.mark.gpu
@pytest.mark.parametrize("name, dtype", [
    ("fm_adagrad", "fp32"), ("fm_adagrad", "int8"), ("fm_sharded", "fp32"),
    ("ffm_ftrl", "fp32"), ("fm_adam", "fp32"),
])
def test_orbax_fixture_served_on_the_gpu(gpu, name, dtype):
    """A table the JAX package wrote (the committed Orbax fixtures, read
    without jax) served on the card: FM through the FmScorer kernel, its
    scores within the reference scorer's stored ones and the CPU
    scorer's (the plain version)."""
    from fast_tffm_tpu_torch.serve.scorer import make_scorer

    cfg, spec, req = _orbax_fixture(name, serve_table_dtype=dtype,
                                    quant_chunk=16)
    fields = req["fields"] if cfg.field_num else None
    on_gpu = make_scorer(cfg, device=gpu)
    on_cpu = make_scorer(cfg, device="cpu")
    assert on_gpu.step == spec["step"]
    before = fm_kernels.fm_scores_cuda.launches
    got = on_gpu.score(req["ids"], req["vals"], fields)
    if not cfg.field_num and dtype == "fp32":
        assert fm_kernels.fm_scores_cuda.launches > before
    np.testing.assert_allclose(got, on_cpu.score(req["ids"], req["vals"],
                                                 fields),
                               rtol=1e-5, atol=1e-6)
    if dtype == "fp32":
        np.testing.assert_allclose(got, req["scores"], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.gpu
def test_swap_under_traffic_on_the_gpu(gpu):
    """Dispatches on one thread while another swaps tables on the card
    (placement off the lock, keep_prev, rollback): every dispatch's
    scores are one table's, bitwise, and the rollback restores the
    first."""
    import threading

    cfg, _, req = _orbax_fixture("fm_adagrad")
    rng = np.random.default_rng(8)
    tables = [rng.uniform(-0.3, 0.3, (cfg.vocabulary_size,
                                      cfg.embedding_dim)).astype(np.float32)
              for _ in range(2)]
    models = [weights.from_jax(0.05 * i, t, device="cpu")
              for i, t in enumerate(tables)]
    scorer = FixedShapeScorer(cfg, models[0], device=gpu)
    ids, vals = req["ids"][:16], req["vals"][:16]
    want = []
    for m in models:
        scorer.swap(m, step=len(want))
        want.append(scorer.score(ids, vals))
    scorer.swap(models[0], step=0)
    seen, stop = [], threading.Event()

    def traffic():
        while not stop.is_set():
            seen.append(scorer.score(ids, vals))

    t = threading.Thread(target=traffic)
    t.start()
    try:
        for _ in range(10):
            scorer.swap(models[1], step=1, keep_prev=True)
            assert scorer.rollback() and scorer.step == 0
    finally:
        stop.set()
        t.join()
    assert seen
    for s in seen:
        assert np.array_equal(s, want[0]) or np.array_equal(s, want[1])
    np.testing.assert_array_equal(scorer.score(ids, vals), want[0])


def _fleet_lines(path, lines=512, vocab=2048, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(lines):
            f.write(f"{i % 2} {rng.integers(0, vocab)}:1 "
                    f"{rng.integers(0, vocab)}:0.5 "
                    f"{rng.integers(0, vocab)}:0.25\n")


def _ranks_train(tmp_path, runs, world):
    from _torch_sharded_worker import run_ranks

    (tmp_path / "train.json").write_text(json.dumps(runs))
    run_ranks("train_cuda", world, tmp_path)
    return [[json.loads((tmp_path / f"train{i}_{r}.json").read_text())
             for r in range(world)] for i in range(len(runs))]


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl"])
def test_fleet_on_two_ranks_matches_the_dense_mesh_on_the_gpu(
        gpu, tmp_path, optimizer):
    """Two ranks share the card over gloo: the 1 x 2 fleet
    (``table_tiering = on``, ``hot_rows = 512``, evicting) and the dense
    1 x 2 mesh end bitwise alike: loss, AUC, and the table, optimizer
    tables and w0 merged from the two shard files against the dense
    ``params.npz``."""
    from fast_tffm_tpu_torch.train import checkpoint

    _fleet_lines(tmp_path / "train.libsvm")
    common = dict(vocabulary_size=2048, factor_num=4, max_features=4,
                  batch_size=32, train_files=[str(tmp_path / "train.libsvm")],
                  epoch_num=2, log_steps=0, thread_num=1, seed=3,
                  steps_per_dispatch=2, optimizer=optimizer, mesh_model=2)
    res = _ranks_train(tmp_path, [
        dict(common, model_file=str(tmp_path / "dense")),
        dict(common, model_file=str(tmp_path / "fleet"), table_tiering="on",
             hot_rows=512),
    ], world=2)
    for r in range(2):
        for m in ("loss", "auc", "examples"):
            assert res[1][r]["train"][m] == res[0][r]["train"][m], (r, m)
    assert sum(res[1][r]["train"]["tiered"]["rows_evicted"]
               for r in range(2)) > 0
    _, scalars, stores = checkpoint.restore_tiered(str(tmp_path / "fleet"))
    keys = {"table": "params/table", "acc": "opt/acc_table",
            "z": "opt/z_table", "n": "opt/n_table"}
    with np.load(checkpoint.params_path(str(tmp_path / "dense"))) as z:
        for name, payload in stores.items():
            have = np.empty_like(z[keys[name]])
            have[payload["ids"]] = payload["rows"]
            np.testing.assert_array_equal(have, z[keys[name]], err_msg=name)
        for name, val in scalars.items():
            np.testing.assert_array_equal(val, z[f"scalar/{name}"]
                                          if name == "w0"
                                          else z[f"opt/{name}"])


@pytest.mark.gpu
def test_fleet_overlap_on_and_off_are_equal_on_the_gpu(gpu, tmp_path):
    """Four ranks of a 2 x 2 mesh share the card: the entries exchange
    with its id plane gathered a step ahead (``sparse_exchange_overlap =
    on``) and inline (``off``) give equal parameters."""
    from fast_tffm_tpu_torch.train import checkpoint

    _fleet_lines(tmp_path / "train.libsvm", lines=480, vocab=1024)
    common = dict(vocabulary_size=1024, factor_num=4, max_features=4,
                  batch_size=32, train_files=[str(tmp_path / "train.libsvm")],
                  epoch_num=2, log_steps=0, thread_num=1, seed=3,
                  steps_per_dispatch=2, mesh_data=2, mesh_model=2,
                  sparse_exchange="entries")
    res = _ranks_train(tmp_path, [
        dict(common, model_file=str(tmp_path / m),
             sparse_exchange_overlap=m) for m in ("off", "on")], world=4)
    for r in range(4):
        assert res[1][r]["train"]["loss"] == res[0][r]["train"]["loss"]
    with np.load(checkpoint.params_path(str(tmp_path / "on"))) as a, \
            np.load(checkpoint.params_path(str(tmp_path / "off"))) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _mesh_mode_cases(tmp_path, shape):
    """Path 12's settings at a small size for two ranks: FFM (both
    exchanges), bf16 FM (both exchanges) and the dense optax path (Adam
    and Adagrad with the full L2), their inputs written for the worker's
    ``step`` modes."""
    rng = np.random.default_rng(12)
    v, f, b = 1024, 8, 64
    cases = []
    for ex in ("dense", "entries"):
        cases.append(dict(field_num=2, factor_num=4, sparse_exchange=ex))
        cases.append(dict(factor_num=8, compute_dtype="bfloat16",
                          sparse_exchange=ex))
    cases += [dict(factor_num=8, optimizer=o, sparse_update=False,
                   l2_mode="full", learning_rate=1e-3 if o == "adam"
                   else 0.05) for o in ("adam", "adagrad")]
    out = []
    for i, kw in enumerate(cases):
        cfg = dict(dict(vocabulary_size=v, max_features=f, batch_size=b,
                        optimizer="adagrad", learning_rate=0.05,
                        factor_lambda=1e-3, bias_lambda=1e-3, lookup=
                        "shardmap", mesh_data=shape[0],
                        mesh_model=shape[1]), **kw)
        d = 1 + kw["factor_num"] * kw.get("field_num", 1)
        arrays = {"w0": np.float32(0.1),
                  "table": rng.uniform(-0.1, 0.1, (v, d)).astype(np.float32),
                  "acc_w0": np.float32(0.1),
                  "acc_table": np.full((v, d), 0.1, np.float32)}
        for s in range(2):
            ids = rng.integers(0, v, (b, f)).astype(np.int32)
            ids[:8, 0] = 5
            arrays.update({
                f"b{s}_labels": rng.integers(0, 2, b).astype(np.float32),
                f"b{s}_ids": ids,
                f"b{s}_vals": rng.uniform(0.1, 1.0, (b, f)).astype(
                    np.float32),
                f"b{s}_fields": rng.integers(0, max(kw.get("field_num", 0),
                                                    1), (b, f)).astype(
                    np.int32),
                f"b{s}_weights": np.ones(b, np.float32)})
        for sub in ("cpu", "cuda"):
            os.makedirs(tmp_path / sub, exist_ok=True)
            np.savez(tmp_path / sub / f"case{i}.npz", **arrays)
        out.append({"cfg": cfg, "steps": 2})
    for sub in ("cpu", "cuda"):
        (tmp_path / sub / "cases.json").write_text(json.dumps(out))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_mesh_modes_on_two_ranks_match_the_plain_versions(gpu, tmp_path,
                                                          shape):
    """Two ranks share the card over gloo and run the sharded FFM step,
    the bf16 FM sharded step and the dense mesh step (FmGrad, K1, K1's
    merge mode, K2, K-place) two steps each; the same ranks on the CPU
    run the kernels' plain versions: scores within the kernels'
    tolerance, tables and optimizer state within the tile-vs-scatter
    bounds, model-row peers bitwise alike."""
    from _torch_sharded_worker import run_ranks

    cases = _mesh_mode_cases(tmp_path, shape)
    run_ranks("step", 2, tmp_path / "cpu")
    run_ranks("step_cuda", 2, tmp_path / "cuda")
    for i, case in enumerate(cases):
        for r in range(2):
            got = np.load(tmp_path / "cuda" / f"out{i}_{r}.npz")
            want = np.load(tmp_path / "cpu" / f"out{i}_{r}.npz")
            assert set(got.files) == set(want.files)
            for k in got.files:
                tol = (TOL if k == "scores" else TABLE_TOL if k == "table"
                       else OPT_TOL)
                if got[k].dtype.kind in "iu":
                    assert got[k] == want[k], (case, k)
                else:
                    np.testing.assert_allclose(got[k], want[k], **tol,
                                               err_msg=f"{case} {k}")


@pytest.mark.gpu
def test_fleet_serve_on_the_gpu_is_bitwise_the_single_process_server(
        gpu, tmp_path):
    """Two replica processes on the card behind the router: scores over
    both transports bitwise the single-process server's on the card (the
    same FmScorer kernel), and each replica's kernel launches above 0."""
    import urllib.request

    from fast_tffm_tpu_torch.config import load_config
    from fast_tffm_tpu_torch.serve import wire
    from fast_tffm_tpu_torch.serve.router import start_fleet
    from fast_tffm_tpu_torch.serve.server import serve
    from fast_tffm_tpu_torch.train import checkpoint

    vocab, k, f = 4096, 8, 39
    rng = np.random.default_rng(13)
    model = str(tmp_path / "model")
    checkpoint.save_params(model, weights.from_jax(
        -0.2, rng.uniform(-0.3, 0.3, (vocab, 1 + k)).astype(np.float32),
        device="cpu"), step=5)
    cfg_path = tmp_path / "fleet.cfg"
    cfg_path.write_text(
        f"[General]\nvocabulary_size = {vocab}\nfactor_num = {k}\n"
        f"model_file = {model}\n[Predict]\nserve_batch_sizes = 64,256\n"
        f"serve_poll_secs = 0\n[Tpu]\nmax_features = {f}\n")
    cfg = load_config(str(cfg_path), {"serve_replicas": 2})
    frames = []
    for n in (1, 37, 200, 300):
        ids = rng.integers(0, vocab, (n, f)).astype(np.int32)
        vals = rng.uniform(0, 1, (n, f)).astype(np.float32)
        frames.append(wire.encode_bin_request(ids, vals))

    def post(port, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/score_bin", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.read()

    single = serve(cfg, port=0)
    try:
        want = [post(single.port, fr) for fr in frames]
    finally:
        single.close()
    handle = start_fleet(cfg, str(cfg_path), port=0)
    pids = [r.pid for r in handle.replicas]
    try:
        for _ in range(3):
            for fr, w in zip(frames, want):
                assert post(handle.port, fr) == w
        for rep in handle.replicas:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{rep.port}/status",
                    timeout=30) as resp:
                blk = json.loads(resp.read())["serve"]
            assert blk["kernel_launches"] > 0 and blk["requests"] > 0
    finally:
        handle.close()
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


# -- the observability planes (quality, trace, blackbox, profiler) ------


class _Observed:
    """Each quality feed a trainer's monitor took, in order."""

    def __init__(self, trainer):
        self.feeds = []
        real = trainer._feed_quality

        def feed(pending):
            if pending is not None:
                host, event, labels, weights = pending
                if event is not None:
                    event.synchronize()
                self.feeds.append((host.numpy().copy(), labels.copy(),
                                   weights.copy()))
            real(pending)

        trainer._feed_quality = feed


@pytest.mark.gpu
def test_graphed_scores_copy_is_bitwise_its_eager_twin(gpu, tmp_path):
    """``Trainer.train()`` at K = 4 over 13 batches with the quality
    plane on: the graphed run (its captured steps write the scores into
    the trainer's buffer, copied to a pinned slot after each replay) is
    bitwise the eager run, the scores fed to the monitor are the same
    arrays, the monitor's block is the same and counts every example."""
    path = _health_file(tmp_path, 13)
    cfg = dataclasses.replace(
        _dispatch_cfg(tmp_path, "adagrad", "float32", 4),
        train_files=[path], epoch_num=1, log_steps=0, save_steps=0,
        quality=True)
    runs = []
    for graphs in (True, False):
        trainer = _trainer(dataclasses.replace(
            cfg, model_file=str(tmp_path / f"m{graphs}")), gpu, graphs)
        seen = _Observed(trainer)
        runs.append((trainer, trainer.train()["train"], seen.feeds))
    (graphed, g_tr, g_feeds), (eager, e_tr, e_feeds) = runs
    assert g_tr["graph_dispatches"] == 2 and e_tr["graph_dispatches"] == 0
    for a, b in zip(_trained_state(graphed), _trained_state(eager)):
        assert torch.equal(a, b)
    assert len(g_feeds) == len(e_feeds) == 4
    for (gs, gl, gw), (es, el, ew) in zip(g_feeds, e_feeds):
        np.testing.assert_array_equal(gs.view(np.uint32), es.view(np.uint32))
        np.testing.assert_array_equal(gl, el)
        np.testing.assert_array_equal(gw, ew)
    assert g_tr["quality"] == e_tr["quality"]
    assert g_tr["quality"]["examples"] == 13 * 512


@pytest.mark.gpu
@pytest.mark.parametrize("graphs", [True, False])
def test_every_plane_on_is_bitwise_every_plane_off(gpu, tmp_path, graphs):
    """Quality, trace, blackbox, a ``profile_dir`` window, a status
    endpoint and the compile sentinel on, against every plane off:
    tables, accumulator, w0, metrics and the carry bitwise the same,
    graphed and eager; the profile names the path's kernels."""
    import socket

    path = _health_file(tmp_path, 13)
    base = dataclasses.replace(
        _dispatch_cfg(tmp_path, "adagrad", "float32", 4),
        train_files=[path], epoch_num=1, log_steps=0, save_steps=0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    on = dataclasses.replace(
        base, model_file=str(tmp_path / "on"), quality=True, blackbox=True,
        trace_file=str(tmp_path / "trace.json"),
        profile_dir=str(tmp_path / "prof"), profile_start_step=4,
        profile_steps=4, status_port=port, heartbeat_secs=0.05,
        metrics_file=str(tmp_path / "m.jsonl"))
    off = dataclasses.replace(base, model_file=str(tmp_path / "off"),
                              quality=False, blackbox=False,
                              resource_metrics=False)
    a = _trainer(on, gpu, graphs)
    a_tr = a.train()["train"]
    b = _trainer(off, gpu, graphs)
    b.train()
    for x, y in zip(_trained_state(a), _trained_state(b)):
        assert torch.equal(x, y)
    assert a_tr["resource"]["compiles"] == (1 if graphs else 0)
    text = open(tmp_path / "prof" / "trace_rank0.json").read()
    for sym in ("fm_scores_fwd_kernel", "fm_grad_bwd_kernel", "k1_kernel",
                "k2_kernel"):
        assert sym in text, sym
