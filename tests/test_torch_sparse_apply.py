"""The port's FmGrad backward and sparse apply (prep, K1, K2) vs the JAX
package on the CPU, where the port's kernel wrappers take their plain
versions.  Inputs are made with numpy from a seed and handed to both.

Tolerances are the reference's own: FmGrad ``rtol=1e-5, atol=1e-6``
(tests/test_pallas_ops.py: f32 accumulation in another order); sparse
apply ``rtol=1e-4, atol=1e-6`` on the table and ``atol=1e-4`` on the
accumulator (tests/test_sparse_apply.py: the sums of duplicate
occurrences are taken in another order than the reference's tile or
scatter path).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fast_tffm_tpu.ops import fm_pallas, sparse_apply as jax_sa
from fast_tffm_tpu.ops.interaction import fm_interaction as jax_fm_interaction
from fast_tffm_tpu_torch.data.libsvm import host_sort_meta
from fast_tffm_tpu_torch.ops import fm_kernels, interaction, sparse_apply

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
ACC_TOL = dict(rtol=1e-4, atol=1e-4)
V, D = 2048, 9
LR, EPS = 0.05, 1e-7
FTRL = dict(lr=0.05, l1=0.01, l2=0.1, beta=1.0)


def _fm_problem(b, f=39, d=9, seed=0):
    rng = np.random.default_rng(seed + b)
    rows = (rng.normal(size=(b, f, d)) * 0.3).astype(np.float32)
    vals = rng.uniform(0.0, 1.0, (b, f)).astype(np.float32)
    vals[:, -3:] = 0.0  # padded slots
    g = rng.normal(size=(b,)).astype(np.float32)
    return rows, vals, g


@pytest.mark.parametrize("b", [1, 13])
def test_fm_grad_plain_matches_pallas_kernel(b):
    rows, vals, g = _fm_problem(b)
    _, s1 = fm_pallas.fm_scores_pallas(jnp.asarray(rows), jnp.asarray(vals),
                                       interpret=True)
    want = fm_pallas.fm_grad_pallas(jnp.asarray(rows), jnp.asarray(vals), s1,
                                    jnp.asarray(g), interpret=True)
    got = fm_kernels.fm_grad_cuda(torch.from_numpy(rows),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(np.array(s1)),
                                  torch.from_numpy(g))
    assert got.shape == (b, 39, 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    np.testing.assert_array_equal(
        got.numpy(),
        fm_kernels.fm_grad_plain(torch.from_numpy(rows),
                                 torch.from_numpy(vals),
                                 torch.from_numpy(np.array(s1)),
                                 torch.from_numpy(g)).numpy(),
    )


def test_fm_interaction_grads_match_jax_grad():
    rows, vals, g = _fm_problem(7, f=11, d=5)

    def jax_obj(r):
        return jnp.sum(jax_fm_interaction(r, jnp.asarray(vals), True)
                       * jnp.asarray(g))

    want_s = jax_fm_interaction(jnp.asarray(rows), jnp.asarray(vals), True)
    want = jax.grad(jax_obj)(jnp.asarray(rows))
    rows_t = torch.from_numpy(rows).requires_grad_()
    vals_t = torch.from_numpy(vals).requires_grad_()
    got_s = interaction.fm_interaction(rows_t, vals_t)
    (got,) = torch.autograd.grad(torch.sum(got_s * torch.from_numpy(g)),
                                 rows_t)
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s),
                               **GRAD_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    # No gradient flows to the feature values (they are data).
    assert vals_t.grad is None


def _ids_grads(seed, n, hot=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, size=n).astype(np.int32)
    if hot:
        ids[:hot] = 77  # one id with `hot` duplicate occurrences
    g = rng.uniform(-1, 1, size=(n, D)).astype(np.float32)
    return ids, g


def _table(seed, lo=-0.1, hi=0.1):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (V, D)).astype(np.float32)


def _port_apply(optimizer, tables, ids, g, hyper, meta=None):
    tabs = tuple(torch.from_numpy(t.copy()) for t in tables)
    if meta is not None:
        meta = type(meta)(*(torch.from_numpy(a) for a in meta))
    sparse_apply.apply(optimizer, tabs, torch.from_numpy(ids),
                       torch.from_numpy(g), hyper, meta=meta)
    return [t.numpy() for t in tabs]


@pytest.mark.parametrize("hot", [0, 700, 1300])
def test_adagrad_matches_tile_kernel_and_scatter(hot):
    ids, g = _ids_grads(0, 1200, hot)
    table = _table(1)
    acc = np.full((V, D), 0.1, np.float32)
    t_tile, a_tile = jax_sa.adagrad_apply(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids),
        jnp.asarray(g), lr=LR, eps=EPS,
    )
    a_ref = jnp.asarray(acc).at[ids].add(g * g)
    t_ref = jnp.asarray(table).at[ids].add(
        -LR * g * jax.lax.rsqrt(a_ref[ids] + EPS)
    )
    t, a = _port_apply("adagrad", (table, acc), ids, g,
                       sparse_apply.Hyper(lr=LR, eps=EPS))
    for want_t, want_a in ((t_tile, a_tile), (t_ref, a_ref)):
        np.testing.assert_allclose(t, np.asarray(want_t), **TABLE_TOL)
        np.testing.assert_allclose(a, np.asarray(want_a), **ACC_TOL)


def test_ftrl_matches_tile_kernel():
    ids, g = _ids_grads(4, 1024, hot=300)
    n = np.full((V, D), 0.1, np.float32)
    z = _table(5, -1.0, 1.0)
    # A table consistent with (z, n), as the trainer keeps it.
    table = np.asarray(jax_sa.ftrl_solve(
        jnp.asarray(z), jnp.asarray(n), FTRL["lr"], FTRL["l1"],
        FTRL["l2"], FTRL["beta"],
    ))
    want = jax_sa.ftrl_apply(jnp.asarray(table), jnp.asarray(z),
                             jnp.asarray(n), jnp.asarray(ids),
                             jnp.asarray(g), **FTRL)
    got = _port_apply("ftrl", (table, z, n), ids, g,
                      sparse_apply.Hyper(**FTRL))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TABLE_TOL)
    for got_s, want_s in zip(got[1:], want[1:]):
        np.testing.assert_allclose(got_s, np.asarray(want_s), **ACC_TOL)


def test_sgd_matches_tile_kernel_and_scatter():
    ids, g = _ids_grads(2, 1024, hot=200)
    table = _table(3)
    want_tile = jax_sa.sgd_apply(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(g), lr=0.1)
    want_ref = jnp.asarray(table).at[ids].add(-0.1 * g)
    (got,) = _port_apply("sgd", (table,), ids, g,
                         sparse_apply.Hyper(lr=0.1))
    np.testing.assert_allclose(got, np.asarray(want_tile), **TABLE_TOL)
    np.testing.assert_allclose(got, np.asarray(want_ref), **TABLE_TOL)


@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl", "sgd"])
@pytest.mark.parametrize("d", [1, 16, 17])
def test_k2_plain_matches_tile_apply_at_the_kernels_widths(d, optimizer):
    """K1's and K2's plain versions, which the card holds the kernels to,
    against the reference's tile apply at the widths where K2's lane
    mapping branches: D = 1, D = 16 (one column pass) and D = 17 (two);
    one id of 300 occurrences and the table's last row among the ids."""
    rng = np.random.default_rng(100 + d)
    ids = rng.integers(0, V, 1024).astype(np.int32)
    ids[:300] = 77
    ids[300] = V - 1
    g = rng.uniform(-1, 1, (1024, d)).astype(np.float32)
    table = rng.uniform(-0.1, 0.1, (V, d)).astype(np.float32)
    state = np.full((V, d), 0.1, np.float32)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    if optimizer == "adagrad":
        tables = (table, state)
        want = jax_sa.adagrad_apply(j(table), j(state), j(ids), j(g), lr=LR,
                                    eps=EPS)
        hyper = sparse_apply.Hyper(lr=LR, eps=EPS)
    elif optimizer == "ftrl":
        z = rng.uniform(-1.0, 1.0, (V, d)).astype(np.float32)
        table = np.asarray(jax_sa.ftrl_solve(
            j(z), j(state), FTRL["lr"], FTRL["l1"], FTRL["l2"],
            FTRL["beta"]))
        tables = (table, z, state)
        want = jax_sa.ftrl_apply(j(table), j(z), j(state), j(ids), j(g),
                                 **FTRL)
        hyper = sparse_apply.Hyper(**FTRL)
    else:
        tables = (table,)
        want = (jax_sa.sgd_apply(j(table), j(ids), j(g), lr=0.1),)
        hyper = sparse_apply.Hyper(lr=0.1)
    meta = host_sort_meta(ids)
    urows, sums = sparse_apply.k1_dedup_plain(
        torch.from_numpy(g), torch.from_numpy(ids),
        torch.from_numpy(meta.perm), torch.from_numpy(meta.seg_start))
    got = tuple(torch.from_numpy(t.copy()) for t in tables)
    sparse_apply.k2_apply_plain(optimizer, urows, sums, got, hyper)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **TABLE_TOL)
    for got_s, want_s in zip(got[1:], want[1:]):
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   **ACC_TOL)


@pytest.mark.parametrize("hot", [0, 700])
def test_host_meta_equals_device_meta_bitwise(hot):
    ids, g = _ids_grads(6, 1200, hot)
    host = host_sort_meta(ids)
    dev = sparse_apply.sort_meta(torch.from_numpy(ids))
    np.testing.assert_array_equal(host.perm, dev.perm.numpy())
    # The device slot is the transfer stage's: the host's U + 1 entries,
    # then n.
    u1 = host.seg_start.size
    np.testing.assert_array_equal(host.seg_start, dev.seg_start[:u1].numpy())
    assert dev.seg_start.numel() == ids.size + 1
    assert bool((dev.seg_start[u1:] == ids.size).all())
    tables = (_table(7), np.full((V, D), 0.1, np.float32))
    hyper = sparse_apply.Hyper(lr=LR, eps=EPS)
    with_host = _port_apply("adagrad", tables, ids, g, hyper, meta=host)
    with_dev = _port_apply("adagrad", tables, ids, g, hyper)
    for a, b in zip(with_host, with_dev):
        np.testing.assert_array_equal(a, b)


def test_k1_plain_sums_each_unique_row():
    ids, g = _ids_grads(8, 500, hot=120)
    meta = host_sort_meta(ids)
    urows, sums = sparse_apply.k1_dedup_cuda(
        torch.from_numpy(g), torch.from_numpy(ids),
        torch.from_numpy(meta.perm), torch.from_numpy(meta.seg_start),
    )
    uniq = np.unique(ids)
    np.testing.assert_array_equal(urows.numpy(), uniq)
    want = np.zeros((len(uniq), 2 * D), np.float64)
    np.add.at(want, np.searchsorted(uniq, ids),
              np.concatenate([g, g * g], axis=1))
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-5, atol=1e-5)


def _k1_args():
    ids = torch.tensor([3, 1, 3], dtype=torch.int32)
    meta = host_sort_meta(ids.numpy())
    return [torch.zeros((3, 4)), ids, torch.from_numpy(meta.perm),
            torch.from_numpy(meta.seg_start)]


@pytest.mark.parametrize("which, bad, err", [
    (0, torch.zeros((3, 4), dtype=torch.float64), TypeError),
    (1, torch.tensor([3, 1, 3]), TypeError),  # int64 ids
    (0, torch.zeros((2, 4)), ValueError),
    (2, torch.zeros((4,), dtype=torch.int32), ValueError),
    (0, torch.zeros((4, 3)).t(), ValueError),  # not contiguous
    (3, torch.tensor([0, 1, 3, 3, 3], dtype=torch.int32),
     ValueError),  # a seg_start past the whole slot [n + 1]
])
def test_k1_wrapper_refuses_what_the_kernel_does_not_take(which, bad, err):
    args = _k1_args()
    args[which] = bad
    before = sparse_apply.k1_dedup_cuda.launches
    with pytest.raises(err):
        sparse_apply.k1_dedup_cuda(*args)
    assert sparse_apply.k1_dedup_cuda.launches == before


@pytest.mark.parametrize("optimizer, n_tables, err", [
    ("adam", 2, ValueError),
    ("adagrad", 1, ValueError),
    ("ftrl", 2, ValueError),
    ("sgd", 1, TypeError),  # float64 table below
])
def test_k2_wrapper_refuses_what_the_kernel_does_not_take(optimizer,
                                                          n_tables, err):
    dtype = torch.float64 if err is TypeError else torch.float32
    tables = tuple(torch.zeros((8, 3), dtype=dtype) for _ in range(n_tables))
    urows = torch.tensor([1, 5], dtype=torch.int32)
    sums = torch.ones((2, 6))
    before = sparse_apply.k2_apply_cuda.launches
    with pytest.raises(err):
        sparse_apply.k2_apply_cuda(optimizer, urows, sums, tables,
                                   sparse_apply.Hyper(lr=0.1))
    assert sparse_apply.k2_apply_cuda.launches == before


_KPLACE_ARGS = (torch.tensor([1, 5], dtype=torch.int32), torch.ones((2, 3)),
                0, 8)


@pytest.mark.parametrize("change, err", [
    ({0: torch.tensor([1, 5])}, TypeError),  # int64 rows
    ({1: torch.ones((2, 3), dtype=torch.float64)}, TypeError),
    ({0: torch.tensor([[1, 5]], dtype=torch.int32)}, ValueError),  # not [U]
    ({1: torch.ones(6)}, ValueError),  # sums not [U, W]
    ({1: torch.ones((3, 3))}, ValueError),  # sums of another U
    ({1: torch.ones((2, 0))}, ValueError),  # W = 0
    ({0: torch.zeros(0, dtype=torch.int32),
      1: torch.zeros((0, sparse_apply._KPLACE_MAX_WIDTH + 1))},
     ValueError),  # past the widest row
    ({2: -1}, ValueError),  # row_lo < 0
    ({3: 0}, ValueError),  # no rows
    ({2: 2**31 - 4}, ValueError),  # row_lo + vocab_local past 2^31
    ({1: torch.ones((3, 2)).t()}, ValueError),  # not contiguous
    ({0: torch.tensor([1, 3, 5], dtype=torch.int32)[::2]}, ValueError),
    ({0: torch.tensor([1, 5], dtype=torch.int32, device="meta")},
     ValueError),  # neither CUDA nor the CPU, nor the sums' device
])
def test_kplace_wrapper_refuses_what_the_kernel_does_not_take(change, err):
    args = [change.get(i, a) for i, a in enumerate(_KPLACE_ARGS)]
    before = sparse_apply.kplace_cuda.launches
    with pytest.raises(err):
        sparse_apply.kplace_cuda(*args)
    assert sparse_apply.kplace_cuda.launches == before
    # The same call with the good arguments places the rows.
    delta = sparse_apply.kplace_cuda(*_KPLACE_ARGS)
    assert torch.equal(delta[[1, 5]], _KPLACE_ARGS[1])


def _k1_warp_f32(x):
    """float32 sum of rows ``x [m, W]`` in a K1 warp's order: lane ``l``
    adds rows ``l, l + 32, ...`` in turn and an xor-shuffle tree
    (offsets 16, 8, 4, 2, 1) joins the 32 lanes."""
    lanes = np.zeros((32, x.shape[1]), np.float32)
    for k in range(0, len(x), 32):
        step = x[k:k + 32]
        lanes[:len(step)] = lanes[:len(step)] + step
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[np.arange(32) ^ off]
    return lanes[0]


def _k1_order_f32(x, short, piece=sparse_apply.K1_PIECE):
    """float32 sum of one segment's payload ``x [count, W]`` in the K1
    kernel's order: one thread adds the rows in turn when ``count <=
    short``; otherwise the rows are cut into pieces of ``piece`` from
    the first, each summed in a warp's order (:func:`_k1_warp_f32`), and
    the pieces added in turn, the first one first."""
    x = x.astype(np.float32)
    if len(x) <= short:
        acc = np.zeros(x.shape[1], np.float32)
        for row in x:
            acc = acc + row
        return acc
    acc = _k1_warp_f32(x[:piece])
    for j in range(piece, len(x), piece):
        acc = acc + _k1_warp_f32(x[j:j + piece])
    return acc


def _cancelling_payload(count, seed):
    """``[g | g*g]`` of ``count`` float32 rows built to cancel (each
    term's negative appears too, perturbed, at magnitudes spread over
    2^+-12), ``g*g`` rounded once, with its exact sums and its mass."""
    rng = np.random.default_rng(seed)
    half = (count + 1) // 2
    big = rng.normal(size=(half, D)) * 2.0 ** rng.uniform(-12, 12, (half, 1))
    g = np.concatenate([big, -big * (1 + 1e-3 * rng.normal(size=big.shape))])
    g = g[rng.permutation(2 * half)[:count]].astype(np.float32)
    payload = np.concatenate([g, g * g], axis=1)
    exact = np.concatenate([g.astype(np.float64),
                            g.astype(np.float64) ** 2], axis=1).sum(0)
    mass = np.abs(payload.astype(np.float64)).sum(0)
    return payload, exact, mass


_PIECE = sparse_apply.K1_PIECE


@pytest.mark.parametrize("count", [
    sparse_apply.K1_SHORT - 1, sparse_apply.K1_SHORT,
    sparse_apply.K1_SHORT + 1, 82, 5000,
    _PIECE - 1, _PIECE, _PIECE + 1, 2 * _PIECE, 3 * _PIECE + 17,
    7 * _PIECE + 1,
])
def test_k1_error_bound_covers_the_kernels_order_of_summation(count):
    """The kernel's order of summation, emulated in float32, stays
    within k1_error_bound of the exact sums, on payloads built to cancel
    (each term's negative appears too, perturbed, at magnitudes spread
    over 2^+-12): the bound's derivation, held where there is no card.
    Counts on both sides of the thread / warp split and of one, two and
    several pieces."""
    payload, exact, mass = _cancelling_payload(count, count)
    got = _k1_order_f32(payload, sparse_apply.K1_SHORT)
    bound = sparse_apply.k1_error_bound(
        torch.tensor([0, count], dtype=torch.int32),
        torch.from_numpy(mass[None, :]),
    )[0].numpy()
    err = np.abs(got.astype(np.float64) - exact)
    assert err.max() > 0  # the float32 order did round
    assert np.all(err <= bound), (err / bound).max()


@pytest.mark.parametrize("piece, count, start", [
    (64, 64 * 5 + 3, 37), (64, 65, 63), (256, 256 * 9 - 1, 255),
    (_PIECE, 2 * _PIECE + 5, 1), (_PIECE, 4 * _PIECE, _PIECE - 1),
])
def test_k1_error_bound_counts_pieces_from_the_segment_start(piece, count,
                                                            start):
    """A segment that starts mid-chunk, beside short ones: its pieces
    are counted from its own first position, so the order and the bound
    depend on its count alone; every segment of the slot stays within
    k1_error_bound at the given piece length, and more pieces allow
    more error (the join's roundings)."""
    rng = np.random.default_rng(piece + count)
    counts = np.diff(np.unique(np.concatenate(
        [[0, start], rng.integers(1, start + 1, 5)])))
    counts = np.append(counts, [count, 3, sparse_apply.K1_SHORT + 2])
    seg_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    assert seg_start[-4] == start
    masses, errs = [], []
    for i, c in enumerate(counts):
        payload, exact, mass = _cancelling_payload(int(c), 7 * i + c)
        got = _k1_order_f32(payload, sparse_apply.K1_SHORT, piece)
        masses.append(mass)
        errs.append(np.abs(got.astype(np.float64) - exact))
    bound = sparse_apply.k1_error_bound(
        torch.from_numpy(seg_start), torch.from_numpy(np.stack(masses)),
        piece=piece).numpy()
    assert np.all(np.stack(errs) <= bound), (np.stack(errs) / bound).max()
    ones = torch.ones((1, 2 * D), dtype=torch.float64)
    per_mass = [float(sparse_apply.k1_error_bound(
        torch.tensor([0, c], dtype=torch.int32), ones, piece=piece)[0, 0])
        for c in (piece, piece + 1, 3 * piece, 3 * piece + 1)]
    assert per_mass == sorted(per_mass) and per_mass[0] < per_mass[1]


def _k1_chunk_pieces(seg_start, n, piece):
    """The pieces the kernel's chunk warps take, as ``{chunk: (segment,
    first position)}``, by the kernel's rule: chunk ``k >= 1`` with
    ``p0 = k * piece`` below ``seg_start[U]`` finds the last segment
    ``v`` with ``seg_start[v] <= p0`` and takes the piece of ``v`` that
    starts in the chunk, if ``v`` started before it and has one there."""
    u = len(seg_start) - 1
    taken = {}
    for k in range(1, -(-n // piece)):
        p0 = k * piece
        if p0 >= seg_start[u]:
            continue
        v = int(np.searchsorted(seg_start, p0, side="right")) - 1
        assert v < u
        s0, s1 = int(seg_start[v]), int(seg_start[v + 1])
        p = s0 + -(-(p0 - s0) // piece) * piece
        if s0 < p0 and p < s1:
            assert p0 <= p < p0 + piece
            taken[k] = (v, p)
    return taken


@pytest.mark.parametrize("slot", ["cut", "whole", "sentinel"])
@pytest.mark.parametrize("piece", [64, _PIECE])
def test_k1_chunk_warps_take_every_piece_once(slot, piece):
    """The partition the kernel relies on, on the slots it is given (the
    cut slot, the whole slot padded with n, and a cut slot whose
    sentinel tail is left out): every piece j >= 1 of every segment
    longer than a piece is taken by exactly one chunk warp, the one its
    workspace row and its join read (chunk floor(s0 / piece) + j, so a
    segment's rows are consecutive from its counter's slot
    floor(s0 / piece) + 1), and no chunk takes anything else."""
    rng = np.random.default_rng(piece)
    ids = np.concatenate([
        np.full(3 * piece + 7, 5), rng.integers(10, 4000, 6000),
        np.full(piece + 1, 4001), np.full(piece, 4002),
        np.full(5 * piece - 3, 4003), rng.integers(4004, 9000, 3000),
        np.full(2 * piece + 1, 9001)]).astype(np.int32)
    if slot == "sentinel":
        ids = np.concatenate([ids, np.full(4 * piece + 9, 9999, np.int32)])
    ids = ids[rng.permutation(ids.size)]
    meta = sparse_apply.sort_meta(
        torch.from_numpy(ids), drop_from=9999 if slot == "sentinel" else None)
    if slot != "whole":
        meta = sparse_apply.cut_slot(meta)
    seg_start = meta.seg_start.numpy()
    n = ids.size
    want = {}
    for v in range(len(seg_start) - 1):
        s0, s1 = int(seg_start[v]), int(seg_start[v + 1])
        for j in range(1, -(-(s1 - s0) // piece)):
            want[s0 // piece + j] = (v, s0 + j * piece)
    assert len(want) >= 8
    assert _k1_chunk_pieces(seg_start, n, piece) == want
    # A split segment's counter slot lies inside the workspace, and the
    # counters of two segments differ.
    slots = [int(seg_start[v]) // piece + 1
             for v in range(len(seg_start) - 1)
             if seg_start[v + 1] - seg_start[v] > piece]
    assert len(set(slots)) == len(slots) and max(slots) < -(-n // piece)


def test_k1_thread_segment_limit_is_the_kernels():
    """The error bound's split between a thread's segment and a warp's
    is the kernel's own (csrc/sparse_apply.cu::kShort)."""
    import os
    import re

    src = os.path.join(os.path.dirname(sparse_apply.__file__), "csrc",
                       "sparse_apply.cu")
    with open(src) as f:
        found = re.findall(r"constexpr int kShort = (\d+);", f.read())
    assert found == [str(sparse_apply.K1_SHORT)]


def test_k1_piece_is_the_kernels():
    """The error bound's piece length and the wrapper's workspace rows
    are the kernel's own (csrc/sparse_apply.cu::kPiece)."""
    import os
    import re

    src = os.path.join(os.path.dirname(sparse_apply.__file__), "csrc",
                       "sparse_apply.cu")
    with open(src) as f:
        found = re.findall(r"constexpr int kPiece = (\d+);", f.read())
    assert found == [str(sparse_apply.K1_PIECE)]


def test_k1_join_counters_are_one_zeroed_set_per_stream():
    """The wrapper's join counters: zeroed, rounded up to a power of two
    slots, the same set for every launch on one stream and size class,
    another for another stream (so launches that may run at once never
    share a counter)."""
    dev = torch.device("cpu")
    made = []
    try:
        a = sparse_apply._k1_joins(dev, 11, 5)
        made.append((dev.index, 11, 8))
        assert a.shape == (8,) and a.dtype == torch.int32
        assert not bool(a.any())
        assert sparse_apply._k1_joins(dev, 11, 8) is a
        b = sparse_apply._k1_joins(dev, 12, 5)
        made.append((dev.index, 12, 8))
        assert b is not a
        c = sparse_apply._k1_joins(dev, 11, 9)
        made.append((dev.index, 11, 16))
        assert c.shape == (16,) and sparse_apply._k1_joins(dev, 11, 7) is a
        assert sparse_apply.k1_joins_pending() == 0
        a[3] = 1
        assert sparse_apply.k1_joins_pending() == 1
    finally:
        for key in made:
            sparse_apply._K1_JOINS.pop(key, None)
