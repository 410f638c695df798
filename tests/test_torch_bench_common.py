"""The helpers the smoke and the kernel benchmarks share
(``fast_tffm_tpu_torch/tools/bench_common.py``), on the CPU: K1's
``index_add_`` yardstick computes K1's function, and K1's bound counts
what the kernel must move."""

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.tools import bench_common


def _stream(slot: str, mode: str):
    """A seeded stream with a few hot ids; ``sentinel`` adds occurrences
    at an id past the vocabulary, left out of the cut slot."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 50, 700).astype(np.int32)
    ids[:300] = 3
    drop = None
    if slot == "sentinel":
        drop = 64
        ids[rng.permutation(ids.size)[:90]] = drop
    width = 5 if mode == "dedup" else 6
    pay = torch.from_numpy(rng.normal(size=(ids.size, width))
                           .astype(np.float32))
    ids = torch.from_numpy(ids)
    meta = sparse_apply.sort_meta(ids, drop_from=drop)
    if slot != "whole":
        meta = sparse_apply.cut_slot(meta)
    return pay, ids, meta


@pytest.mark.parametrize("slot", ["whole", "cut", "sentinel"])
@pytest.mark.parametrize("mode", ["dedup", "merge"])
def test_k1_library_computes_k1(mode, slot):
    pay, ids, meta = _stream(slot, mode)
    call = bench_common.k1_library(pay, meta.perm, meta.seg_start,
                                   square=mode == "dedup")
    got = call()
    plain = getattr(sparse_apply, f"k1_{mode}_plain")
    _, want = plain(pay.double(), ids, meta.perm, meta.seg_start)
    u = int((meta.seg_start[1:] > meta.seg_start[:-1]).sum())
    np.testing.assert_allclose(got[:u].double().numpy(),
                               want[:u].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("square", [True, False])
def test_k1_bound_counts_the_kernels_bytes(square):
    n, u, d = 159_744, 105_739, 9
    ms, by = bench_common.k1_bound_ms(n, u, d, slot=n, square=square)
    w = (2 if square else 1) * d
    nbytes = 4 * (n * d + n + u + (n + 1) + n + w * u)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / bench_common.PEAK_BYTES_PER_S * 1e3)
    cut, _ = bench_common.k1_bound_ms(n, u, d, square=square)
    assert cut < ms  # the cut slot's U segments, not n


def test_l2_copies_pass_twice_the_l2():
    one = 2 * bench_common.L2_BYTES / bench_common.PEAK_BYTES_PER_S * 1e3
    assert bench_common.l2_copies(one) == 1
    assert bench_common.l2_copies(one / 3) == 3
    calls = []
    call = bench_common.in_turn(lambda *a: calls.append(a), [(1, 2), (3,)])
    for _ in range(3):
        call()
    assert calls == [(1, 2), (3,), (1, 2)]
