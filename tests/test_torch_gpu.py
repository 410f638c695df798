"""The port on the GPU: the CUDA kernels (FmScorer forward and FmGrad
backward in their f32 and bf16-input modes, K1 dedup and its merge mode, K2 apply, K-place, and the
table-layout probe's K2T and K2P) against their plain PyTorch versions,
the scorer's and the sparse step's GPU paths against their CPU paths,
and two ranks' collectives on one GPU.

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
optimizer tables).  The bf16 FmGrad computes in f32 with the plain
version's roundings and rounds once: it is held to it bitwise.
"""

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


@pytest.mark.gpu
@pytest.mark.parametrize("b, f, d", [
    (1, 39, 9), (1000, 39, 9), (4096, 39, 9), (5, 3, 41), (7, 4, 2),
    (3, 2, 1),
])
def test_fm_grad_kernel_matches_plain(gpu, b, f, d):
    rows, vals = _problem(b, f, d - 1)
    rng = np.random.default_rng(b)
    rows_d = torch.from_numpy(rows).to(gpu)
    vals_d = torch.from_numpy(vals).to(gpu)
    _, s1 = fm_kernels.fm_scores_plain(rows_d, vals_d)
    g = torch.from_numpy(rng.normal(size=(b,)).astype(np.float32)).to(gpu)
    before = fm_kernels.fm_grad_cuda.launches
    got = fm_kernels.fm_grad_cuda(rows_d, vals_d, s1, g)
    want = fm_kernels.fm_grad_plain(rows_d, vals_d, s1, g)
    torch.cuda.synchronize()
    assert fm_kernels.fm_grad_cuda.launches == before + 1
    assert got.shape == (b, f, d)
    torch.testing.assert_close(got, want, **TOL)


def _bf16_inputs(gpu, b, f, d):
    rows, vals = _problem(b, f, d - 1)
    return (torch.from_numpy(rows).to(gpu).to(torch.bfloat16),
            torch.from_numpy(vals).to(gpu).to(torch.bfloat16))


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
@pytest.mark.parametrize("b, f, d", [
    (1, 39, 9), (1000, 39, 9), (4096, 39, 9), (5, 3, 41), (3, 2, 1),
])
def test_bf16_fm_grad_kernel_matches_plain_bitwise(gpu, b, f, d):
    """The bf16 FmGrad computes in f32 with the plain version's
    roundings and rounds once to bf16: equal bit for bit."""
    rows, vals = _bf16_inputs(gpu, b, f, d)
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
        scores = sparse.sparse_step(cfg, model, opt, batch, plain=plain)
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
