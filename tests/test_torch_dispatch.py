"""The port's train dispatch on the CPU: K1 and K2 on the whole
``seg_start`` slot (the plain versions the CPU takes) against the cut
slot, the graph-ready step (whole-slot views, metrics updated in place)
against the per-batch ``device_step`` loop, a K = 4 run through an epoch
tail against the reference's ``Trainer``, and the transfer stage's
pause, which a capture holds.

The whole slot and the graph-ready step must be bitwise the cut slot's
path: the same sums in the same order, on the first U rows.  Against the
reference's scatter path (host sort meta) the tolerances are its own
tile-vs-scatter bounds (``tests/test_sparse_apply.py``): ``rtol=1e-4,
atol=1e-6`` on the table, ``atol=1e-4`` on optimizer tables,
``rtol=1e-5, atol=1e-7`` on w0.  The CUDA graph itself needs a card:
``tests/test_torch_gpu.py`` holds it against these eager steps.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import libsvm
from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher
from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.train import checkpoint, sparse
from fast_tffm_tpu_torch.train.loop import Trainer

TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-4, atol=1e-4)
W0_TOL = dict(rtol=1e-5, atol=1e-7)
OPTIMIZERS = ("adagrad", "ftrl", "sgd")
HYPER = sparse_apply.Hyper(lr=0.05, l1=0.01, l2=0.1)


def _full_slot(seg_start: np.ndarray, n: int) -> np.ndarray:
    """``seg_start [U + 1]`` padded with ``n`` to the shipped ``[n + 1]``
    slot."""
    out = np.full((n + 1,), n, np.int32)
    out[:seg_start.shape[0]] = seg_start
    return out


def _stream(case: str, d: int = 5, seed: int = 0):
    """``(g_rows [n, d], ids [n], perm, seg_start [U + 1])`` tensors."""
    rng = np.random.default_rng(seed)
    n = {"batch": 300, "hot": 300, "unique": 64, "empty": 0}[case]
    if case == "unique":
        ids = rng.permutation(1000)[:n]
    else:
        ids = rng.integers(0, 200, n)
    if case == "hot":
        ids[::3] = 17  # one id of 100 occurrences
    ids = ids.astype(np.int32)
    meta = libsvm.host_sort_meta(ids)
    g = rng.normal(0.0, 0.1, (n, d)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (g, ids, meta.perm,
                                               meta.seg_start))


def _tables(optimizer: str, vocab: int = 1000, d: int = 5, seed: int = 1):
    rng = np.random.default_rng(seed)
    count = {"sgd": 1, "adagrad": 2, "ftrl": 3}[optimizer]
    return tuple(torch.from_numpy(rng.uniform(
        0.1 if i else -0.1, 1.0 if i else 0.1, (vocab, d)).astype(np.float32))
        for i in range(count))


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("case", ["batch", "hot", "unique", "empty"])
def test_static_k1_k2_match_the_dynamic_modes_bitwise(case, optimizer):
    """K1 and K2 on the whole slot, as the CPU runs them (their plain
    versions): K1 gives the cut slot's rows and sums bitwise on the first
    U rows and row -1 with zero sums after; K2 on that stream writes the
    cut slot's tables bitwise and no other row (U = 0 is the empty batch,
    U = n a batch of unique ids, and one hot id)."""
    g, ids, perm, seg = _stream(case)
    n, u = ids.numel(), seg.numel() - 1
    full = torch.from_numpy(_full_slot(seg.numpy(), n))
    urows, sums = sparse_apply.k1_dedup_cuda(g, ids, perm, seg)
    s_rows, s_sums = sparse_apply.k1_dedup_cuda(g, ids, perm, full)
    assert s_rows.shape == (n,) and s_sums.shape == (n, 2 * g.shape[1])
    assert torch.equal(s_rows[:u], urows) and torch.equal(s_sums[:u], sums)
    assert bool((s_rows[u:] == -1).all()) and not s_sums[u:].any()
    dyn, stat, start = (_tables(optimizer), _tables(optimizer),
                        _tables(optimizer))
    sparse_apply.k2_apply_cuda(optimizer, urows, sums, dyn, HYPER)
    sparse_apply.k2_apply_cuda(optimizer, s_rows, s_sums, stat, HYPER)
    untouched = torch.ones(start[0].shape[0], dtype=torch.bool)
    untouched[urows.long()] = False
    for a, b, t0 in zip(dyn, stat, start):
        assert torch.equal(a, b)
        assert torch.equal(b[untouched], t0[untouched])
    # apply() on the whole slot: the same tables.
    routed = _tables(optimizer)
    sparse_apply.apply(optimizer, routed, ids, g, HYPER,
                       meta=libsvm.SortMeta(perm, full))
    for a, b in zip(dyn, routed):
        assert torch.equal(a, b)


def test_k2_plain_skips_row_minus_one():
    """``k2_apply_plain`` on a stream with rows -1 writes what it writes
    without them, and nothing at the table's last row (where an index -1
    would land)."""
    g, ids, perm, seg = _stream("batch")
    urows, sums = sparse_apply.k1_dedup_plain(g, ids, perm, seg)
    pad = torch.full((7,), -1, dtype=torch.int32)
    noise = torch.full((7, sums.shape[1]), 5.0)
    for optimizer in OPTIMIZERS:
        cut, whole, start = (_tables(optimizer), _tables(optimizer),
                             _tables(optimizer))
        sparse_apply.k2_apply_plain(optimizer, urows, sums, cut, HYPER)
        sparse_apply.k2_apply_plain(optimizer, torch.cat([urows, pad]),
                                    torch.cat([sums, noise]), whole, HYPER)
        for a, b, t0 in zip(cut, whole, start):
            assert torch.equal(a, b)
            assert torch.equal(b[-1], t0[-1])


def test_paused_holds_the_transfer_stage():
    """While ``DevicePrefetcher.paused()`` is held, the stage ships
    nothing; after, every batch arrives."""
    import threading
    import time

    go = threading.Event()
    host = _host_batches(4)

    def source():
        go.wait(10.0)
        yield from host

    pf = DevicePrefetcher(source(), 2, "cpu", V)
    shipped = DevicePrefetcher.ships
    with pf.paused():
        go.set()
        time.sleep(0.3)
        assert DevicePrefetcher.ships == shipped
    got = [sb for sb in pf]
    assert [sb.n for sb in got] == [2, 2]
    assert DevicePrefetcher.ships == shipped + 2


V, F, B = 512, 8, 32


def _host_batches(n: int, seed: int = 3):
    """Host batches with the pipeline's host sort meta (a duplicated id,
    padded features and two padded examples each)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, V, (B, F)).astype(np.int32)
        ids[:6, 0] = 5
        vals = rng.uniform(0.1, 1.0, (B, F)).astype(np.float32)
        vals[:, -2:] = 0.0
        ids[:, -2:] = 0
        out.append(libsvm.Batch(
            labels=rng.integers(0, 2, B).astype(np.float32), ids=ids,
            vals=vals, fields=np.zeros((B, F), np.int32),
            weights=np.where(np.arange(B) < B - 2, 1.0, 0.0)
            .astype(np.float32),
            sort_meta=libsvm.host_sort_meta(ids)))
    return out


def _state(trainer):
    m = trainer.metrics
    return ([trainer.model.table, trainer.model.w0,
             *sparse.opt_tables(trainer.opt_state)]
            + [t for t in trainer.opt_state if t.dim() == 0]
            + [m.loss_sum, m.weight_sum, m.count, m.auc.pos, m.auc.neg])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("k", [1, 4])
def test_graph_ready_step_matches_the_device_step_loop(tmp_path, k,
                                                       optimizer, dtype):
    """Seven batches (K = 4: a full super-batch and a tail of three)
    through ``Trainer.dispatch`` on the transfer stage's super-batches
    (static views, in-place metrics) train, bitwise, what
    ``device_step`` trains on each batch copied with its cut sort meta:
    tables, optimizer state, w0, the step losses and every metric."""
    cfg = FmConfig(vocabulary_size=V, factor_num=4, max_features=F,
                   batch_size=B, optimizer=optimizer, compute_dtype=dtype,
                   learning_rate=0.05, ftrl_l1=0.01, ftrl_l2=0.1,
                   factor_lambda=1e-3, bias_lambda=1e-3,
                   model_file=str(tmp_path / "none"), seed=11,
                   steps_per_dispatch=k)
    host = _host_batches(7)
    graph_ready, loop = Trainer(cfg, device="cpu"), Trainer(cfg, device="cpu")
    assert graph_ready.graph is None and "cpu" in graph_ready.eager_reason
    got = torch.cat([graph_ready.dispatch(sb) for sb in
                     DevicePrefetcher(host, k, "cpu", V)])
    want = torch.stack([loop.device_step(sparse.to_device(b, "cpu"))
                        for b in host])
    assert graph_ready.eager_dispatches == -(-7 // k)
    assert graph_ready.graph_dispatches == 0
    assert torch.equal(got, want)
    for a, b in zip(_state(graph_ready), _state(loop)):
        assert torch.equal(a, b)


def _lines(path, n, rng, w, v, n_feat=10):
    """Planted-structure libsvm lines (``examples/gen_sample_data.py``)."""
    with open(path, "w") as f:
        for _ in range(n):
            ids = rng.choice(len(w), size=n_feat, replace=False)
            vals = np.round(rng.uniform(0.2, 1.0, size=n_feat), 3)
            xv = v[ids] * vals[:, None]
            score = w[ids] @ vals + 0.5 * (xv.sum(0) @ xv.sum(0)
                                           - (xv ** 2).sum())
            label = int(rng.uniform() < 1.0 / (1.0 + np.exp(-2.5 * score)))
            f.write(f"{label} " + " ".join(
                f"{i}:{x}" for i, x in zip(ids, vals)) + "\n")


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_k4_run_through_an_epoch_tail_matches_the_reference(tmp_path,
                                                            optimizer):
    """Two epochs of ten batches at K = 4 (two super-batches and a tail
    of two an epoch), host sort meta: the port's ``Trainer.train()``
    against the reference's on its scatter path, from the reference's
    initial table, within the tile-vs-scatter bounds; every dispatch of
    the CPU run eager."""
    rng = np.random.default_rng(5)
    vocab = 300
    path = str(tmp_path / "train.libsvm")
    _lines(path, 1280, rng, rng.normal(0, 0.5, vocab),
           rng.normal(0, 0.3, (vocab, 4)))
    common = dict(
        vocabulary_size=vocab, factor_num=4, max_features=12,
        batch_size=128, epoch_num=2, learning_rate=0.3, optimizer=optimizer,
        adagrad_initial_accumulator=0.01, ftrl_l1=0.01, ftrl_l2=0.1,
        factor_lambda=1e-4, bias_lambda=1e-4, init_value_range=0.05,
        shuffle_buffer=400, seed=7, train_files=[path], log_steps=0,
        save_steps=0, steps_per_dispatch=4, host_sort=True,
    )
    jt = JaxTrainer(JaxFmConfig(model_file=str(tmp_path / "jax_model"),
                                sparse_apply="scatter", **common))
    init = jax.tree.map(np.asarray, jt.state.params)
    jres = jt.train()
    port_dir = str(tmp_path / "port_model")
    checkpoint.save_params(port_dir, weights.from_jax(init.w0, init.table,
                                                      device="cpu"))
    trainer = Trainer(FmConfig(model_file=port_dir, **common), device="cpu")
    tr = trainer.train()["train"]
    assert tr["steps"] == jres["train"]["steps"] == 20
    assert tr["dispatches"] == tr["eager_dispatches"] == 6
    assert tr["graph_dispatches"] == 0
    assert tr["examples"] == jres["train"]["examples"]
    params, opt = jt.state.params, jt.state.opt_state
    np.testing.assert_allclose(trainer.model.table.detach().numpy(),
                               np.asarray(params.table), **TABLE_TOL)
    np.testing.assert_allclose(float(trainer.model.w0.detach()),
                               float(params.w0), **W0_TOL)
    want = {"adagrad": lambda: [opt.acc.table],
            "ftrl": lambda: [opt.z.table, opt.n.table],
            "sgd": lambda: []}[optimizer]()
    assert len(want) == len(sparse.opt_tables(trainer.opt_state))
    for got, ref in zip(sparse.opt_tables(trainer.opt_state), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **OPT_TOL)
    np.testing.assert_allclose(tr["logloss"], jres["train"]["logloss"],
                               rtol=1e-4)


class _StandIn:
    """``GraphedSteps``' interface on the CPU, where there is no CUDA
    graph: a "replay" runs the steps eagerly."""

    def __init__(self, k):
        self.k = k
        self._steps = self.captured_from = self.pause = None

    @property
    def captured(self):
        return self.captured_from is not None

    def capture(self, sb, steps, pause=None):
        self._steps, self.captured_from, self.pause = steps, sb.n, pause

    def replay(self, sb):
        return self._steps(sb)


def test_train_splits_graph_and_eager_dispatches(tmp_path):
    """Two epochs of five batches at K = 2: the first full super-batch
    runs eagerly and is captured, the other full ones replay, each
    epoch's tail of one runs eagerly; ``train()`` reports the split and
    trains what an all-eager run trains."""
    rng = np.random.default_rng(2)
    path = str(tmp_path / "train.libsvm")
    _lines(path, 640, rng, rng.normal(0, 0.5, 100),
           rng.normal(0, 0.3, (100, 4)))
    cfg = FmConfig(vocabulary_size=100, factor_num=4, max_features=12,
                   batch_size=128, epoch_num=2, steps_per_dispatch=2,
                   train_files=[path], log_steps=0, save_steps=0, seed=3,
                   model_file=str(tmp_path / "a"))
    split = Trainer(cfg, device="cpu")
    split.graph = _StandIn(2)
    split.eager_reason = None
    tr = split.train()["train"]
    assert split.graph.captured_from == 2
    # The capture held the transfer stage (its paused() lock).
    assert split.graph.pause is not None and hasattr(split.graph.pause,
                                                     "acquire")
    assert (tr["dispatches"], tr["graph_dispatches"],
            tr["eager_dispatches"]) == (6, 3, 3)
    eager = Trainer(dataclasses.replace(cfg, model_file=str(tmp_path / "b")),
                    device="cpu")
    assert eager.train()["train"]["eager_dispatches"] == 6
    for a, b in zip(_state(split), _state(eager)):
        assert torch.equal(a, b)
