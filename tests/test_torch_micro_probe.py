"""The port's table-layout probe (``fast_tffm_tpu_torch/tools/
micro_probe.py``) vs the JAX reference's (``tools/micro_probe.py``) on
the CPU, where the port's K2T and K2P wrappers take their plain versions
and the reference runs its Pallas kernels in interpret mode.  Inputs are
made with numpy from a seed and handed to both.

Tolerances are the reference's K2 bounds (tests/test_sparse_apply.py):
``rtol=1e-4, atol=1e-6`` on the table and ``atol=1e-4`` on the
accumulator; the reference places its sums through bf16 hi/lo one-hot
matmuls, the port sums duplicates in another order.
"""

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fast_tffm_tpu.ops import interaction as jax_interaction
from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.tools import micro_probe, timing

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import micro_probe as ref  # noqa: E402  (the reference: tools/micro_probe.py)

TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
ACC_TOL = dict(rtol=1e-4, atol=1e-4)
V, N, D = 4096, 2048, 9
LR, EPS = 0.05, 1e-7
HOT_ID = 77


def _problem(seed, hot, d=D):
    """Uniform ids over [0, V) (about a third of the rows untouched), the
    first ``hot`` of them one hot id, their gradients, a table and an
    accumulator ``[V, d]``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, N).astype(np.int32)
    ids[:hot] = HOT_ID
    g = rng.uniform(-1.0, 1.0, (N, d)).astype(np.float32)
    table = rng.uniform(-0.1, 0.1, (V, d)).astype(np.float32)
    acc = rng.uniform(0.1, 1.0, (V, d)).astype(np.float32)
    return ids, g, table, acc


def _untouched(ids):
    mask = np.ones(V, bool)
    mask[ids] = False
    assert 0 < mask.sum() < V
    return mask


@pytest.mark.parametrize("hot", [0, 400])
def test_k2t_matches_reference_kernel(hot):
    ids, g, table, acc = _problem(1, hot)
    want_t, want_a = ref.k2t_apply(jnp.asarray(table.T), jnp.asarray(acc.T),
                                   jnp.asarray(ids), jnp.asarray(g), lr=LR,
                                   eps=EPS)
    before = micro_probe.k2t_apply.launches
    tt = torch.from_numpy(np.ascontiguousarray(table.T))
    at = torch.from_numpy(np.ascontiguousarray(acc.T))
    got_t, got_a = micro_probe.k2t_apply(tt, at, torch.from_numpy(ids),
                                         torch.from_numpy(g), lr=LR, eps=EPS)
    assert got_t is tt and got_a is at  # updated in place
    assert micro_probe.k2t_apply.launches == before  # the CPU: no kernel
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TABLE_TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **ACC_TOL)
    mask = _untouched(ids)
    np.testing.assert_array_equal(got_t.numpy()[:, mask], table.T[:, mask])
    np.testing.assert_array_equal(got_a.numpy()[:, mask], acc.T[:, mask])


@pytest.mark.parametrize("hot", [0, 400])
def test_k2p_matches_reference_kernel(hot):
    ids, g, table, acc = _problem(2, hot)
    want_t, want_a = ref.k2p_apply(
        ref.pack_table(jnp.asarray(table), D),
        ref.pack_table(jnp.asarray(acc), D),
        jnp.asarray(ids), jnp.asarray(g), lr=LR, eps=EPS)
    before = micro_probe.k2p_apply.launches
    tp = micro_probe.pack_table(torch.from_numpy(table), D)
    ap = micro_probe.pack_table(torch.from_numpy(acc), D)
    got_t, got_a = micro_probe.k2p_apply(tp, ap, torch.from_numpy(ids),
                                         torch.from_numpy(g), lr=LR, eps=EPS)
    assert got_t is tp and got_a is ap
    assert micro_probe.k2p_apply.launches == before
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TABLE_TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **ACC_TOL)
    mask = _untouched(ids)
    rows = micro_probe.unpack_table(got_t, D).numpy()
    np.testing.assert_array_equal(rows[mask], table[mask])


@pytest.mark.parametrize("d", [1, 5, 16])
def test_packed_pad_slots_stay_zero(d):
    ids, g, table, acc = _problem(3, 300, d)
    tp = micro_probe.pack_table(torch.from_numpy(table), d)
    ap = micro_probe.pack_table(torch.from_numpy(acc), d)
    micro_probe.k2p_apply(tp, ap, torch.from_numpy(ids), torch.from_numpy(g),
                          lr=LR, eps=EPS)
    for packed in (tp, ap):
        assert torch.count_nonzero(packed.view(V, 16)[:, d:]) == 0
    # The update itself is the scatter reference's (float64 here).
    idx = ids.astype(np.int64)
    a_ref = acc.astype(np.float64)
    np.add.at(a_ref, idx, g.astype(np.float64) ** 2)
    t_ref = table.astype(np.float64)
    np.add.at(t_ref, idx, -LR * g / np.sqrt(a_ref[idx] + EPS))
    np.testing.assert_allclose(micro_probe.unpack_table(tp, d).numpy(),
                               t_ref, **TABLE_TOL)
    np.testing.assert_allclose(micro_probe.unpack_table(ap, d).numpy(),
                               a_ref, **ACC_TOL)


@pytest.mark.parametrize("d", [1, 9, 16])
def test_pack_and_unpack_equal_the_reference_bitwise(d):
    table = np.random.default_rng(d).normal(size=(64, d)).astype(np.float32)
    want = np.asarray(ref.pack_table(jnp.asarray(table), d))
    got = micro_probe.pack_table(torch.from_numpy(table), d)
    assert got.shape == (8, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        micro_probe.unpack_table(got, d).numpy(),
        np.asarray(ref.unpack_table(jnp.asarray(want), d)))
    np.testing.assert_array_equal(micro_probe.unpack_table(got, d).numpy(),
                                  table)


@pytest.mark.parametrize("b, f, d", [(1, 39, 9), (37, 39, 9), (5, 3, 17)])
def test_scores_flat_matches_the_reference(b, f, d):
    rng = np.random.default_rng(b + f)
    rows = (rng.normal(size=(b, f, d)) * 0.3).astype(np.float32)
    vals = rng.uniform(0.0, 1.0, (b, f)).astype(np.float32)
    want_s, want_s1 = jax_interaction._scores_flat(jnp.asarray(rows),
                                                   jnp.asarray(vals))
    got_s, got_s1 = micro_probe.scores_flat(torch.from_numpy(rows),
                                            torch.from_numpy(vals))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_s1.numpy(), np.asarray(want_s1),
                               rtol=1e-5, atol=1e-6)


def _args(layout):
    ids, g, table, acc = _problem(4, 0)
    if layout == "k2t":
        tabs = [torch.from_numpy(np.ascontiguousarray(t.T))
                for t in (table, acc)]
    else:
        tabs = [micro_probe.pack_table(torch.from_numpy(t), D)
                for t in (table, acc)]
    return tabs + [torch.from_numpy(ids), torch.from_numpy(g)]


_BAD = [
    ("dtype table", 0, lambda a: a.double(), TypeError),
    ("dtype ids", 2, lambda a: a.long(), TypeError),
    ("dtype g_rows", 3, lambda a: a.double(), TypeError),
    ("shape acc", 1, lambda a: a[:-1].contiguous(), ValueError),
    ("shape g_rows", 3, lambda a: a[:-1].contiguous(), ValueError),
    ("shape ids", 2, lambda a: a.view(2, -1), ValueError),
    ("device", 1, lambda a: torch.empty(a.shape, device="meta"), ValueError),
    ("contiguity", 3, lambda a: a.t().contiguous().t(), ValueError),
    ("id range", 2, lambda a: a.clone().fill_(V), ValueError),
    ("negative id", 2, lambda a: a.clone().fill_(-1), ValueError),
]


@pytest.mark.parametrize("layout", ["k2t", "k2p"])
@pytest.mark.parametrize("what, which, spoil, err", _BAD,
                         ids=[b[0] for b in _BAD])
def test_wrappers_refuse_what_the_kernels_do_not_take(layout, what, which,
                                                      spoil, err):
    args = _args(layout)
    args[which] = spoil(args[which])
    fn = getattr(micro_probe, f"{layout}_apply")
    before = fn.launches
    with pytest.raises(err):
        fn(*args, lr=LR, eps=EPS)
    assert fn.launches == before


@pytest.mark.parametrize("tables, d", [
    ((torch.zeros((12, 16)), torch.zeros((12, 16))), 9),  # V % 8 != 0
    ((torch.zeros((4, 128)), torch.zeros((4, 128))), 17),  # D > 16
    ((torch.zeros((4, 128)), torch.zeros((4, 64))), 9),
])
def test_k2p_refuses_what_the_packed_layout_cannot_hold(tables, d):
    ids = torch.tensor([0, 3, 3], dtype=torch.int32)
    g = torch.ones((3, d))
    before = micro_probe.k2p_apply.launches
    with pytest.raises(ValueError):
        micro_probe.k2p_apply(*tables, ids, g, lr=LR, eps=EPS)
    urows = torch.tensor([0, 3], dtype=torch.int32)
    with pytest.raises(ValueError):
        micro_probe.k2p_entries(urows, torch.ones((2, 2 * d)), *tables,
                                lr=LR, eps=EPS)
    assert micro_probe.k2p_apply.launches == before
    with pytest.raises(ValueError):  # V % 8 != 0 cannot be packed either
        micro_probe.pack_table(torch.zeros((12, 9)), 9)
    with pytest.raises(ValueError):
        micro_probe.pack_table(torch.zeros((16, 17)), 17)


def _misaligned(t):
    """``t``'s values in a view that starts 4 bytes past a 16-byte
    boundary: contiguous, of the same shape, off K2P's chunk grid."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)  # 64-byte aligned
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("which", ["table", "acc", "sums"])
def test_k2p_refuses_a_view_off_its_16_byte_grid(which):
    """K2P moves 16-byte chunks: a packed table, accumulator or stream
    that does not start on a 16-byte boundary raises from
    ``k2p_entries`` (and, for the tables, ``k2p_apply``) on every
    device, before any launch."""
    tp, ap, ids, g = _args("k2p")
    urows, sums = sparse_apply.k1_dedup_plain(g, ids,
                                              *sparse_apply.sort_meta(ids))
    tabs = {"table": tp, "acc": ap, "sums": sums}
    tabs[which] = _misaligned(tabs[which])
    before = micro_probe.k2p_apply.launches
    with pytest.raises(ValueError, match=f"its {which} must start on a "
                                         f"16-byte boundary"):
        micro_probe.k2p_entries(urows, tabs["sums"], tabs["table"],
                                tabs["acc"], lr=LR, eps=EPS)
    if which != "sums":
        with pytest.raises(ValueError, match="16-byte boundary"):
            micro_probe.k2p_apply(tabs["table"], tabs["acc"], ids, g, lr=LR,
                                  eps=EPS)
    assert micro_probe.k2p_apply.launches == before


def test_k2t_entries_refuses_a_mismatched_stream():
    tt, at, _, _ = _args("k2t")
    urows = torch.tensor([1, 5], dtype=torch.int32)
    with pytest.raises(ValueError):
        micro_probe.k2t_entries(urows, torch.ones((2, 2 * D + 2)), tt, at,
                                lr=LR, eps=EPS)
    with pytest.raises(TypeError):
        micro_probe.k2t_entries(urows.long(), torch.ones((2, 2 * D)), tt, at,
                                lr=LR, eps=EPS)


def test_bench_makes_two_warm_calls_then_steps():
    calls = []

    def fn(x):
        calls.append(1)
        return (x + 1, [x * 2])

    ms = timing.bench(fn, torch.ones(4), steps=5)
    assert len(calls) == 7 and ms > 0
    timing.drain((torch.ones(1), [torch.zeros(2), None]))


def test_probe_main_runs_to_its_end_on_the_cpu(capsys):
    assert micro_probe.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for section in ("gather [4096,  9]", "packed-gather", "column-gather",
                    "elementwise+field-sum", "the reshape is a view: True",
                    "fwd: plain", "scatter-add", "K2 (K1 included)",
                    "exact=True", "sort n=   2048"):
        assert section in out, section
