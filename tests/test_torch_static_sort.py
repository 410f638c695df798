"""The static device sort meta on the CPU (``ops/sparse_apply.py::
sort_meta``) and what it opens: the slot against the host meta the
transfer stage ships, the entries exchange's helpers against the
reference's (``fast_tffm_tpu/ops/sparse_apply.py``: ``unique_entries``,
``merge_entries``, ``dense_delta``), the helpers and one sparse and one
dense step under a guard that makes every host read of a tensor raise
(the CPU's stand-in for "a CUDA graph can capture it"), a ``host_sort =
false`` ``Trainer`` against the reference's and bitwise against the
port's own ``host_sort = true`` run, and ``Trainer._eager_reason``'s
rules.

Tolerances are the reference's own: the entry payloads and the dense
delta, sums of up to 40 occurrences that the reference's tile K1 takes
through bf16 hi/lo products, ``rtol=1e-4`` (its tile-vs-scatter bound)
with the entries' ``atol=1e-5`` (``tests/test_sparse_apply.py``); the
trainer's tile-vs-scatter bounds (``tests/test_sparse_apply.py``):
``rtol=1e-4, atol=1e-6`` on the table, ``atol=1e-4`` on optimizer
tables, ``rtol=1e-5, atol=1e-7`` on w0; the dense path's table and w0
``rtol=1e-4, atol=1e-6`` (``tests/test_torch_dense.py``).  Everything
the port runs on one device with the host meta and with the device's
is compared bitwise.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.ops import sparse_apply as jax_sa
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import libsvm
from fast_tffm_tpu_torch.data.prefetch import stack_batches
from fast_tffm_tpu_torch.ops import sparse_apply
from fast_tffm_tpu_torch.train import checkpoint, sparse
from fast_tffm_tpu_torch.train.loop import Trainer

ENTRY_TOL = dict(rtol=1e-4, atol=1e-5)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-4, atol=1e-4)
W0_TOL = dict(rtol=1e-5, atol=1e-7)
D = 9


def _ids(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "empty":
        return np.zeros((0,), np.int32)
    if case == "one_id":
        return np.full((50,), 7, np.int32)
    if case == "distinct":
        return rng.permutation(1000)[:64].astype(np.int32)
    ids = rng.integers(0, 200, 300)
    if case == "hot":
        ids[::3] = 17  # one id of 100 occurrences
    return ids.astype(np.int32)


def _shipped(ids: np.ndarray) -> libsvm.SortMeta:
    """The host meta of ``ids`` as the transfer stage ships it: a
    one-batch super-batch's step, ``seg_start`` in its ``[n + 1]`` slot."""
    n = ids.shape[0]
    batch = libsvm.Batch(
        np.zeros((1,), np.float32), ids.reshape(1, n),
        np.zeros((1, n), np.float32), None, np.zeros((1,), np.float32),
        libsvm.host_sort_meta(ids))
    return stack_batches([batch], with_fields=False).step(0).sort_meta


@pytest.mark.parametrize("case", ["empty", "one_id", "distinct", "random",
                                  "hot"])
def test_sort_meta_is_the_shipped_host_slot(case):
    ids = _ids(case)
    want = _shipped(ids)
    got = sparse_apply.sort_meta(torch.from_numpy(ids))
    assert got.perm.dtype == got.seg_start.dtype == torch.int32
    assert got.seg_start.shape == (ids.shape[0] + 1,)
    np.testing.assert_array_equal(got.perm.numpy(), want.perm)
    np.testing.assert_array_equal(got.seg_start.numpy(), want.seg_start)
    # Cut to its non-empty segments, the slot is the host meta.
    cut = sparse_apply.cut_slot(got)
    np.testing.assert_array_equal(cut.seg_start.numpy(),
                                  libsvm.host_sort_meta(ids).seg_start)


@pytest.mark.parametrize("case", ["present", "absent", "only", "empty"])
def test_sort_meta_leaves_the_sentinel_out_in_the_whole_slot(case):
    """``drop_from``: the largest id's segment is left out when it is at
    or past the bound.  The slot from that segment on holds its first
    sorted position (every later segment empty); K1's plain version
    gives, on the whole slot, the cut slot's rows and sums, then row -1
    and zero sums, and never sums the sentinel's occurrences."""
    vocab = 300
    ids = _ids("hot" if case in ("present", "absent") else "empty")
    if case == "present":
        ids = ids.copy()
        ids[5::7] = vocab
    elif case == "only":
        ids = np.full((40,), vocab, np.int32)
    n = ids.shape[0]
    host = libsvm.host_sort_meta(ids)
    if n and ids.max() >= vocab:
        u = host.seg_start.shape[0] - 2  # the segments below the sentinel
        want = np.full((n + 1,), host.seg_start[u], np.int32)
    else:
        u = host.seg_start.shape[0] - 1
        want = np.full((n + 1,), n, np.int32)
    want[:u] = host.seg_start[:u]
    got = sparse_apply.sort_meta(torch.from_numpy(ids), drop_from=vocab)
    np.testing.assert_array_equal(got.perm.numpy(), host.perm)
    np.testing.assert_array_equal(got.seg_start.numpy(), want)
    cut = sparse_apply.cut_slot(got)
    np.testing.assert_array_equal(cut.seg_start.numpy(), want[:u + 1])
    g = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (n, D)).astype(np.float32))
    g[torch.from_numpy(ids) >= vocab] = float("nan")  # must never be read
    t_ids = torch.from_numpy(ids)
    rows_w, sums_w = sparse_apply.k1_dedup_cuda(g, t_ids, got.perm,
                                                got.seg_start)
    rows_c, sums_c = sparse_apply.k1_dedup_cuda(g, t_ids, cut.perm,
                                                cut.seg_start)
    assert rows_w.shape == (n,) and sums_w.shape == (n, 2 * D)
    assert torch.equal(rows_w[:u], rows_c) and torch.equal(sums_w[:u], sums_c)
    assert bool((rows_w[u:] == -1).all()) and not sums_w[u:].any()
    assert bool(torch.isfinite(sums_w).all())


def _shard_streams(seed: int, vocab: int, n: int = 600, shards: int = 4):
    """Each data shard's local ids (a hot id of 20 occurrences, 40
    off-shard occurrences at the sentinel ``vocab``) and row gradients
    (zero at the sentinel)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(shards):
        ids = rng.integers(0, vocab, n).astype(np.int32)
        ids[:20] = 77
        ids[100:140] = vocab
        g = rng.uniform(-1, 1, (n, D)).astype(np.float32)
        g[100:140] = 0.0
        out.append((ids, g))
    return out


@pytest.mark.parametrize("seed, vocab", [(4, 2048), (9, 512)])
def test_entries_helpers_match_the_reference(seed, vocab):
    """``unique_entries`` (rows, payloads, count), ``entries_rows``,
    ``merge_entries`` over four shards' streams and ``dense_delta`` on
    the static slot, against the reference's functions on the same
    inputs."""
    n = 600
    cap = sparse_apply.entries_cap(n, vocab)
    assert cap == jax_sa.entries_cap(n, vocab)
    rows_all, pay_all, dense_sum = [], [], np.zeros((vocab, 2 * D))
    for ids, g in _shard_streams(seed, vocab, n):
        t_ids, t_g = torch.from_numpy(ids), torch.from_numpy(g)
        rows, pay, count = sparse_apply.unique_entries(t_ids, t_g,
                                                       vocab=vocab, cap=cap)
        j_rows, j_pay, j_count = jax_sa.unique_entries(
            jnp.asarray(ids), jnp.asarray(g), vocab=vocab, cap=cap)
        assert count.dim() == 0 and int(count) == int(j_count)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
        np.testing.assert_allclose(pay.numpy(), np.asarray(j_pay),
                                   **ENTRY_TOL)
        assert not pay[int(count):].any()
        np.testing.assert_array_equal(
            sparse_apply.entries_rows(t_ids, vocab=vocab, cap=cap).numpy(),
            np.asarray(j_rows))
        delta = sparse_apply.dense_delta(t_ids, t_g, vocab_local=vocab,
                                         row_lo=0)
        np.testing.assert_allclose(
            delta.numpy(), np.asarray(jax_sa.dense_delta(
                jnp.asarray(ids), jnp.asarray(g), vocab=vocab,
                vocab_local=vocab, row_lo=0)), **ENTRY_TOL)
        dense_sum += delta.numpy()
        rows_all.append(rows)
        pay_all.append(pay)
    rows_m, pay_m = torch.cat(rows_all), torch.cat(pay_all)
    urows, sums = sparse_apply.merge_entries(rows_m, pay_m, vocab=vocab)
    real = np.unique(rows_m.numpy()[rows_m.numpy() < vocab])
    u = real.shape[0]
    assert urows.shape == (rows_m.numel(),)
    np.testing.assert_array_equal(urows[:u].numpy(), real)
    assert bool((urows[u:] == -1).all()) and not sums[u:].any()
    j_u, _ = jax_sa.merge_entries(jnp.asarray(rows_m.numpy()),
                                  jnp.asarray(pay_m.numpy()), vocab=vocab)
    np.testing.assert_allclose(sums[:u].numpy(),
                               np.asarray(j_u)[:u, :2 * D], **ENTRY_TOL)
    np.testing.assert_allclose(sums[:u].numpy(), dense_sum[real],
                               **ENTRY_TOL)


@pytest.mark.parametrize("optimizer", sparse_apply.OPTIMIZERS)
def test_k2_plain_on_rows_minus_one_alone_changes_nothing(optimizer):
    """A shard's whole slot with no row touched (every row -1): K2's
    plain version writes every table back bitwise, as the kernel skips
    every row."""
    rng = np.random.default_rng(3)
    n_tables = {"sgd": 1, "adagrad": 2, "ftrl": 3}[optimizer]
    tables = tuple(torch.from_numpy(rng.uniform(0.1, 1.0, (64, D))
                                    .astype(np.float32))
                   for _ in range(n_tables))
    before = [t.clone() for t in tables]
    urows = torch.full((5,), -1, dtype=torch.int32)
    sums = torch.full((5, 2 * D), float("nan"))  # never read
    sparse_apply.k2_apply_cuda(optimizer, urows, sums, tables,
                               sparse_apply.Hyper(lr=0.1, l1=0.01, l2=0.1))
    for a, b in zip(tables, before):
        assert torch.equal(a, b)


class _HostRead(AssertionError):
    pass


def _guarded(monkeypatch):
    """Make every host read of a tensor's value raise: ``.item()``,
    ``int()``, ``float()``, ``bool()``, ``.tolist()`` and
    ``nonzero``."""
    def refuse(name):
        def read(*args, **kwargs):
            raise _HostRead(f"{name} reads a tensor on the host")
        return read

    for name in ("item", "__int__", "__float__", "__bool__", "tolist",
                 "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    monkeypatch.setattr(torch, "nonzero", refuse("torch.nonzero"))


def _batch(seed: int, vocab: int, b: int = 32, f: int = 8) -> libsvm.Batch:
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, f)).astype(np.int32)
    ids[:6, 0] = 5
    vals = rng.uniform(0.1, 1.0, (b, f)).astype(np.float32)
    return libsvm.Batch(rng.integers(0, 2, b).astype(np.float32), ids, vals,
                        np.zeros((b, f), np.int32),
                        np.ones((b,), np.float32))


def test_the_guard_catches_a_host_read(monkeypatch):
    t = torch.arange(4)
    with monkeypatch.context() as m:
        _guarded(m)
        for read in (lambda: t.sum().item(), lambda: int(t[0]),
                     lambda: bool(t[1]), lambda: torch.nonzero(t),
                     lambda: t.nonzero(), lambda: t.tolist()):
            with pytest.raises(_HostRead):
                read()
    assert int(t[1]) == 1  # restored


@pytest.mark.parametrize("sparse_update", [True, False])
def test_device_sort_paths_read_nothing_on_the_host(monkeypatch,
                                                    sparse_update):
    """Under the guard: ``sort_meta`` (with and without ``drop_from``),
    the entries exchange's helpers, ``dense_delta``, ``dense_grad`` and
    ``apply`` on the device sort, and a ``host_sort = false`` train step
    (the sparse one, or the dense optax one with Adam and the full L2)
    with the health carry and the metrics."""
    vocab = 512
    ids, g = _shard_streams(5, vocab, 300, shards=1)[0]
    t_ids, t_g = torch.from_numpy(ids), torch.from_numpy(g)
    cfg = FmConfig(vocabulary_size=vocab, factor_num=D - 1, max_features=8,
                   batch_size=32, learning_rate=0.05, host_sort=False,
                   sparse_update=sparse_update,
                   optimizer="adagrad" if sparse_update else "adam",
                   l2_mode="batch" if sparse_update else "full",
                   factor_lambda=1e-3, bias_lambda=1e-3, seed=3,
                   model_file="/nonexistent/static_sort_model")
    trainer = Trainer(cfg, device="cpu")
    batch = sparse.to_device(_batch(2, vocab), "cpu")
    tables = (torch.zeros((vocab + 1, D)), torch.full((vocab + 1, D), 0.1))
    with monkeypatch.context() as m:
        _guarded(m)
        metas = (sparse_apply.sort_meta(t_ids),
                 sparse_apply.sort_meta(t_ids, drop_from=vocab))
        cap = sparse_apply.entries_cap(t_ids.numel(), vocab)
        rows, pay, count = sparse_apply.unique_entries(t_ids, t_g,
                                                       vocab=vocab, cap=cap)
        plane = sparse_apply.entries_rows(t_ids, vocab=vocab, cap=cap)
        merged = sparse_apply.merge_entries(torch.cat([rows, rows]),
                                            torch.cat([pay, pay]),
                                            vocab=vocab)
        deduped = sparse_apply.dedup_entries(t_ids, t_g, vocab=vocab)
        delta = sparse_apply.dense_delta(t_ids, t_g, vocab_local=vocab,
                                         row_lo=0)
        grad = sparse_apply.dense_grad(t_ids, t_g, vocab + 1)
        sparse_apply.apply("adagrad", tables, t_ids, t_g,
                           sparse_apply.Hyper(lr=0.1))
        loss = trainer.device_step(batch, health=True)
    assert all(m.seg_start.shape == (t_ids.numel() + 1,) for m in metas)
    assert torch.equal(plane, rows) and int(count) == int((rows < vocab).sum())
    assert merged[0].shape == (2 * cap,) and deduped[0].shape == (300,)
    assert delta.shape == (vocab, 2 * D) and grad.shape == (vocab + 1, D)
    assert bool(torch.isfinite(loss)) and int(trainer.health.step) == 1


def _lines(path, n, rng, vocab, n_feat=10):
    w = rng.normal(0, 0.5, vocab)
    with open(path, "w") as f:
        for _ in range(n):
            ids = rng.choice(vocab, size=n_feat, replace=False)
            vals = np.round(rng.uniform(0.2, 1.0, size=n_feat), 3)
            label = int(rng.uniform() < 1.0 / (1.0 + np.exp(-w[ids] @ vals)))
            f.write(f"{label} " + " ".join(
                f"{i}:{x}" for i, x in zip(ids, vals)) + "\n")


@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl", "sgd", "adam"])
def test_device_sort_trainer_matches_the_reference_and_the_host_sort(
        tmp_path, optimizer):
    """Two epochs of ten batches at K = 4 (an epoch tail of two): the
    port's ``host_sort = false`` ``Trainer.train()`` against the
    reference's ``host_sort = false`` run from its initial table (its
    scatter apply; with Adam the dense optax path), within the
    tile-vs-scatter (dense: sparse-vs-dense) bounds, and bitwise the
    port's own ``host_sort = true`` run: the device slot is the host's."""
    rng = np.random.default_rng(6)
    vocab = 300
    path = str(tmp_path / "train.libsvm")
    _lines(path, 1280, rng, vocab)
    common = dict(
        vocabulary_size=vocab, factor_num=4, max_features=12,
        batch_size=128, epoch_num=2, learning_rate=0.1, optimizer=optimizer,
        adagrad_initial_accumulator=0.01, ftrl_l1=0.01, ftrl_l2=0.1,
        factor_lambda=1e-4, bias_lambda=1e-4, init_value_range=0.05,
        shuffle_buffer=400, seed=7, train_files=[path], log_steps=0,
        save_steps=0, steps_per_dispatch=4,
    )
    if optimizer == "adam":
        common.update(sparse_update=False, l2_mode="full",
                      learning_rate=0.01)
    jt = JaxTrainer(JaxFmConfig(model_file=str(tmp_path / "jax_model"),
                                sparse_apply="scatter", host_sort=False,
                                **common))
    init = jax.tree.map(np.asarray, jt.state.params)
    jres = jt.train()
    port = {}
    for host_sort in (False, True):
        port_dir = str(tmp_path / f"port_{host_sort}")
        checkpoint.save_params(port_dir, weights.from_jax(
            init.w0, init.table, device="cpu"))
        trainer = Trainer(FmConfig(model_file=port_dir, host_sort=host_sort,
                                   **common), device="cpu")
        assert "cpu" in trainer.eager_reason and trainer.graph is None
        port[host_sort] = (trainer, trainer.train()["train"])
    trainer, tr = port[False]
    assert tr["steps"] == jres["train"]["steps"] == 20
    assert tr["dispatches"] == tr["eager_dispatches"] == 6
    params = jt.state.params
    np.testing.assert_allclose(trainer.model.table.detach().numpy(),
                               np.asarray(params.table), **TABLE_TOL)
    np.testing.assert_allclose(float(trainer.model.w0.detach()),
                               float(params.w0),
                               **(TABLE_TOL if optimizer == "adam"
                                  else W0_TOL))
    if optimizer != "adam":
        opt = jt.state.opt_state
        want = {"adagrad": lambda: [opt.acc.table],
                "ftrl": lambda: [opt.z.table, opt.n.table],
                "sgd": lambda: []}[optimizer]()
        for got, ref in zip(sparse.opt_tables(trainer.opt_state), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       **OPT_TOL)
    host_trainer, host_tr = port[True]
    assert host_tr["logloss"] == tr["logloss"]
    for a, b in zip([trainer.model.table, trainer.model.w0,
                     *trainer.opt_state, *trainer.metrics[:3]],
                    [host_trainer.model.table, host_trainer.model.w0,
                     *host_trainer.opt_state, *host_trainer.metrics[:3]]):
        assert torch.equal(a, b)


def _fake(device="cuda", tiered=None, sharded=False, backend=None):
    return types.SimpleNamespace(
        device=torch.device(device), tiered=tiered, sharded=sharded,
        mesh=types.SimpleNamespace(backend=backend))


@pytest.mark.parametrize("fake, words", [
    (_fake(), None),  # one card, host or device sort alike
    (_fake(sharded=True, backend="nccl"), ("NCCL", "teardown", "7a")),
    (_fake(sharded=True, backend="gloo"), ("gloo", "pinned host", "7a")),
    (_fake(tiered=object()), ("table_tiering=on", "plan buffers", "7a")),
    (_fake(tiered=object(), sharded=True, backend="nccl"),
     ("table_tiering=on", "plan buffers", "7a")),
    (_fake(device="cpu", sharded=True, backend="gloo"), ("cpu",)),
])
def test_eager_reason_rules(fake, words):
    reason = Trainer._eager_reason(fake)
    if words is None:
        assert reason is None
    else:
        assert reason is not None and all(w in reason for w in words)


def test_a_device_sort_trainer_on_the_cpu_states_why_it_is_eager(tmp_path):
    trainer = Trainer(FmConfig(vocabulary_size=256, factor_num=4,
                               max_features=8, batch_size=16,
                               host_sort=False,
                               model_file=str(tmp_path / "m")),
                      device="cpu")
    assert trainer.graph is None
    assert trainer.eager_reason == "the cpu device has no CUDA graphs"

