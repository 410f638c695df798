"""The port's epoch cache vs the JAX package's on the CPU.

``cache_epochs``: epoch 0 streams and is kept, later epochs replay it in
a seeded order; ``cache_prestacked``: epoch 0's groups of K are packed
once (``data/prefetch.py::Packer``) and replayed whole.  The port's
``BatchPipeline`` is held bitwise against ``fast_tffm_tpu.data.pipeline.
BatchPipeline(ordered=True)`` on the same files, config and seed (labels,
ids, vals, fields, weights; the port's host sort meta against
``host_sort_meta`` of the reference's ids: ``perm`` and the first U + 1
entries of ``seg_start``), over 3 epochs, through overflow and through
resumes, including a resume inside a packed group.  The budgets are far
under one batch (1 byte) or far above the run (the 1 GiB default), where
both packages' byte counts agree on whether the cache overflows.  Then
the transfer stage's prestacked ship and ``Trainer.train`` with the
cache: every batch trained, ``ingest_cache`` reported, a resume mid-epoch
bitwise the uninterrupted run, the fingerprint, and the whole path
against the reference's trainer from the same initial table
(tile-vs-scatter bounds, as ``tests/test_torch_pipeline.py``).
"""

import logging

import numpy as np
import pytest

import jax

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from fast_tffm_tpu.data.pipeline import EpochEnd as JaxEpochEnd
from fast_tffm_tpu.data.pipeline import SuperBatch as JaxSuperBatch
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch import cli, weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import libsvm
from fast_tffm_tpu_torch.data.pipeline import BatchPipeline, EpochEnd
from fast_tffm_tpu_torch.data.prefetch import (
    DevicePrefetcher, PackedGroup, Packer, stack_batches,
)
from fast_tffm_tpu_torch.train import checkpoint
from fast_tffm_tpu_torch.train.loop import Trainer

from test_torch_pipeline import (
    OPT_TOL, STREAM, TABLE_TOL, W0_TOL, _gen_sample, _write_files,
)

EPOCHS = 3


def _port_items(files, cfg, prestack_k=0, **kw):
    """The port's delivered items, packed groups unpacked into their
    batches (each tagged ``"packed"``), and the pipeline."""
    prestack = None
    if prestack_k:
        packer = Packer("cpu", cfg.vocabulary_size, with_fields=True)
        prestack = (prestack_k, packer.pack)
    out = []
    with BatchPipeline(files, cfg, host_meta=True, epoch_marks=True,
                       prestack=prestack, **kw) as p:
        for item in p:
            if isinstance(item, PackedGroup):
                out.append(("packed", item.n))
                out.extend(item.batches())
            else:
                out.append(item)
    return out, p


def _jax_items(files, cfg, prestack_k=0, **kw):
    out = []
    p = JaxBatchPipeline(files, cfg, ordered=True, epoch_marks=True,
                         prestack_k=prestack_k, **kw)
    for item in p:
        if isinstance(item, JaxSuperBatch):
            out.append(("packed", item.n))
            sb = item.batch
            out.extend(libsvm.Batch(sb.labels[i], sb.ids[i], sb.vals[i],
                                    sb.fields[i], sb.weights[i])
                       for i in range(item.n))
        else:
            out.append(item)
    return out, p


def _assert_same(got, want, packed_tags=True):
    """Item by item: markers alike, batches bitwise, the port's sort meta
    the reference ids' ``host_sort_meta`` (a packed batch's ``seg_start``
    slot padded with n past U + 1)."""
    if not packed_tags:
        got = [g for g in got if type(g) is not tuple]
        want = [w for w in want if type(w) is not tuple]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, JaxEpochEnd):
            assert g == EpochEnd(w.epoch)
            continue
        if type(w) is tuple:  # ("packed", n)
            assert g == w
            continue
        for name in ("labels", "ids", "vals", "fields", "weights"):
            a, b = getattr(g, name), np.asarray(getattr(w, name))
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        meta = libsvm.host_sort_meta(np.asarray(w.ids))
        np.testing.assert_array_equal(g.sort_meta.perm, meta.perm)
        u1 = len(meta.seg_start)
        np.testing.assert_array_equal(g.sort_meta.seg_start[:u1],
                                      meta.seg_start)
        assert (g.sort_meta.seg_start[u1:] == g.ids.size).all()


def _batches(items):
    return [i for i in items if isinstance(i, libsvm.Batch)]


@pytest.mark.parametrize("fast_ingest", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_cached_stream_matches_the_reference_bitwise(tmp_path, fast_ingest,
                                                     shuffle):
    """Three epochs with the cache: epoch 0 the uncached stream, epochs
    1-2 its batches in the reference's seeded order, bitwise; the
    replays parse nothing and count; truncation counted per replay."""
    files, _ = _write_files(tmp_path)
    kw = dict(fast_ingest=fast_ingest, thread_num=3, **STREAM)
    common = dict(epochs=EPOCHS, shuffle=shuffle, cache_epochs=True)
    before = BatchPipeline.replays
    got, pipe = _port_items(files, FmConfig(**kw), **common)
    replays = BatchPipeline.replays - before
    want, jpipe = _jax_items(files, JaxFmConfig(**kw), **common)
    _assert_same(got, want)
    assert pipe.cache_result == jpipe.cache_result == "cached"
    assert pipe.truncated_features == jpipe.truncated_features > 0
    per_epoch = len(_batches(got)) // EPOCHS
    assert replays == (EPOCHS - 1) * per_epoch > 0
    epoch0 = [b.ids.tobytes() for b in _batches(got)[:per_epoch]]
    epoch1 = [b.ids.tobytes() for b in _batches(got)[per_epoch:
                                                     2 * per_epoch]]
    assert sorted(epoch0) == sorted(epoch1)
    assert (epoch0 == epoch1) == (not shuffle)


@pytest.mark.parametrize("fast_ingest, start_epoch, skip, budget", [
    (True, 0, 0, 1),      # overflow at once: the uncached stream
    (True, 1, 3, 1),      # a resume whose rebuild overflows
    (True, 1, 3, None),   # a resume in epoch 1: rebuild, then replay
    (True, 0, 5, None),   # a resume in epoch 0
    (True, 2, 7, None),
    (False, 1, 4, None),
    (False, 1, 2, 1),
])
def test_cached_resume_and_overflow_match_the_reference(
        tmp_path, fast_ingest, start_epoch, skip, budget):
    """From a resume position and through an overflow, the port delivers
    the reference's stream, which is the uninterrupted run's from that
    position (the port's own full run)."""
    files, _ = _write_files(tmp_path)
    kw = dict(fast_ingest=fast_ingest, thread_num=2, **STREAM)
    common = dict(epochs=EPOCHS, shuffle=True, cache_epochs=True)
    if budget is not None:
        common["cache_max_bytes"] = budget
    got, pipe = _port_items(files, FmConfig(**kw), start_epoch=start_epoch,
                            skip_batches=skip, **common)
    want, jpipe = _jax_items(files, JaxFmConfig(**kw),
                             start_epoch=start_epoch, skip_batches=skip,
                             **common)
    _assert_same(got, want)
    assert pipe.cache_result == jpipe.cache_result == (
        "cached" if budget is None else "overflow")
    full, _ = _port_items(files, FmConfig(**kw), **common)
    at = 0
    if start_epoch:
        at = 1 + next(i for i, x in enumerate(full) if isinstance(
            x, EpochEnd) and x.epoch == start_epoch - 1)
    suffix = full[at:]
    # The resumed run's first epoch starts `skip` batches in.
    suffix = _batches(suffix)[skip:]
    assert [b.ids.tobytes() for b in _batches(got)] == [
        b.ids.tobytes() for b in suffix]
    if budget is not None:  # the overflow run is the uncached stream
        plain, _ = _port_items(files, FmConfig(**kw), epochs=EPOCHS,
                               shuffle=True)
        assert [b.ids.tobytes() for b in _batches(full)] == [
            b.ids.tobytes() for b in _batches(plain)]


@pytest.mark.parametrize("epochs, shard", [(1, (0, 1)), (2, (1, 2))])
def test_cache_engages_only_for_several_epochs_unsharded(tmp_path, epochs,
                                                         shard):
    """The reference's rule: one epoch, or a sharded pipeline, streams as
    if the cache were off."""
    files, _ = _write_files(tmp_path)
    cfg = FmConfig(thread_num=2, **STREAM)
    common = dict(epochs=epochs, shuffle=True, shard=shard)
    got, pipe = _port_items(files, cfg, cache_epochs=True, **common)
    off, _ = _port_items(files, cfg, **common)
    assert pipe.cache_result == "off"
    assert [b.ids.tobytes() for b in _batches(got)] == [
        b.ids.tobytes() for b in _batches(off)]


@pytest.mark.parametrize("prestack_k", [0, 2])
def test_truncation_accumulates_across_cached_replays(tmp_path, prestack_k):
    """Every replayed epoch adds epoch 0's cut-off features, as a
    re-parse would: 2 of 6 features a line, 64 lines, 3 epochs."""
    path = tmp_path / "t.libsvm"
    path.write_text("".join(
        f"{i % 2} " + " ".join(f"{(i + j) % 64}:1.0" for j in range(6))
        + "\n" for i in range(64)))
    kw = dict(vocabulary_size=64, max_features=4, batch_size=32,
              thread_num=1, seed=3)
    common = dict(epochs=3, shuffle=True, cache_epochs=True)
    got, pipe = _port_items([str(path)], FmConfig(**kw),
                            prestack_k=prestack_k, **common)
    want, jpipe = _jax_items([str(path)], JaxFmConfig(**kw),
                             prestack_k=prestack_k, **common)
    _assert_same(got, want)
    assert len(_batches(got)) == 6
    assert pipe.truncated_features == jpipe.truncated_features == 3 * 128


@pytest.mark.parametrize("fast_ingest, k", [(True, 2), (True, 3),
                                            (False, 3)])
def test_prestacked_stream_matches_the_reference(tmp_path, fast_ingest, k):
    """The same groups (epoch tails at their leftover) in the same
    order, the replays permuting whole groups: each of the port's packed
    groups where the reference delivers a stacked one, bitwise."""
    files, _ = _write_files(tmp_path)
    kw = dict(fast_ingest=fast_ingest, thread_num=3, **STREAM)
    common = dict(epochs=EPOCHS, shuffle=True, cache_epochs=True)
    got, pipe = _port_items(files, FmConfig(**kw), prestack_k=k, **common)
    want, jpipe = _jax_items(files, JaxFmConfig(**kw), prestack_k=k,
                             **common)
    _assert_same(got, want)
    assert pipe.cache_result == jpipe.cache_result == "cached"
    sizes = [g[1] for g in got if type(g) is tuple]
    assert sizes.count(k) >= 3 * 10 and set(sizes) <= set(range(1, k + 1))


@pytest.mark.parametrize("start_epoch, skip, budget", [
    (0, 4, None),  # a group boundary in epoch 0
    (0, 5, None),  # inside a group: its tail as plain batches
    (1, 4, None),
    (1, 5, None),
    (2, 9, None),
    (1, 5, 1),     # the rebuild overflows: the epoch streams
])
def test_prestacked_resume_matches_the_reference(tmp_path, start_epoch,
                                                 skip, budget):
    """A resume re-packs epoch 0 (delivering none of it when past it)
    and continues with the reference's groups; a position inside a group
    delivers the group's tail first, as plain batches (the reference's
    sliced super-batch), then whole packed groups."""
    files, _ = _write_files(tmp_path)
    k = 2
    kw = dict(thread_num=2, **STREAM)
    common = dict(epochs=EPOCHS, shuffle=True, cache_epochs=True,
                  start_epoch=start_epoch, skip_batches=skip)
    if budget is not None:
        common["cache_max_bytes"] = budget
    got, pipe = _port_items(files, FmConfig(**kw), prestack_k=k, **common)
    want, jpipe = _jax_items(files, JaxFmConfig(**kw), prestack_k=k,
                             **common)
    assert pipe.cache_result == jpipe.cache_result
    _assert_same(got, want, packed_tags=False)
    if budget is None:
        first = got[0]
        # The reference slices its group; the port delivers the tail.
        assert isinstance(first, libsvm.Batch) == (skip % k != 0)
        assert not isinstance(got[skip % k], libsvm.Batch)


def _batch(rng, b=8, f=4, vocab=64, meta=True):
    ids = rng.integers(0, vocab, (b, f)).astype(np.int32)
    return libsvm.Batch(
        rng.integers(0, 2, b).astype(np.float32), ids,
        rng.uniform(0.1, 1.0, (b, f)).astype(np.float32),
        np.zeros((b, f), np.int32), np.ones((b,), np.float32),
        libsvm.host_sort_meta(ids) if meta else None)


def test_prefetcher_ships_a_packed_group_with_no_fill():
    """A packed group ships as it is (on the CPU the super-batch views its
    very buffer), counted as a prestack hit and with no fill; a pending
    group of plain batches ships before it; the plain batches around it
    are filled as before."""
    rng = np.random.default_rng(0)
    bs = [_batch(rng) for _ in range(5)]
    packer = Packer("cpu", 64)
    DevicePrefetcher.ships = DevicePrefetcher.fills = 0
    DevicePrefetcher.prestack_hits = 0
    packed = packer.pack(bs[:2])
    assert packed.n == 2 and packed.nbytes == packed.buffer.numel()
    src = [bs[4], packed, EpochEnd(0), bs[2], bs[3], EpochEnd(1)]
    got = list(DevicePrefetcher(src, 2, "cpu", 64, depth=4, packer=packer))
    assert [x.epoch if isinstance(x, EpochEnd) else x.n for x in got] == [
        1, 2, 0, 2, 1]
    assert got[1].buffer is packed.buffer
    assert DevicePrefetcher.fills == 2  # bs[4], then bs[2:4]
    assert DevicePrefetcher.prestack_hits == 1
    assert DevicePrefetcher.ships == 3
    want = stack_batches(bs[:2], with_fields=False)
    for name in ("labels", "ids", "vals", "weights"):
        np.testing.assert_array_equal(getattr(got[1].batch, name).numpy(),
                                      getattr(want.batch, name))
    for a, b in zip(got[1].batch.sort_meta, want.batch.sort_meta):
        np.testing.assert_array_equal(a.numpy(), b)
    # Its batches, as a resume's tail takes them: the whole slot each.
    tail = packed.batches(1)
    assert len(tail) == 1
    np.testing.assert_array_equal(tail[0].ids, bs[1].ids)
    assert tail[0].sort_meta.seg_start.shape == (bs[1].ids.size + 1,)


def test_a_packed_buffer_is_never_recycled_or_refilled():
    """The stage recycles only its own staging buffers: behind their
    copies, a packed group's buffer is held and then let go, never put
    back in the free pool, so no later fill writes into the cache."""
    rng = np.random.default_rng(1)
    packer = Packer("cpu", 64)
    pf = DevicePrefetcher([], 2, "cpu", 64, depth=1, packer=packer)
    list(pf)
    packed = packer.pack([_batch(rng), _batch(rng)])
    snapshot = packed.buffer.clone()

    class Done:
        def synchronize(self):
            pass

    staging = [packer.alloc(packed.nbytes) for _ in range(3)]
    for own in staging:
        pf._retire(Done(), packed.buffer, recycle=False)
        pf._retire(Done(), own, recycle=True)
    free = pf._free[packed.nbytes]
    assert len(free) == 2 and all(b is not packed.buffer for b in free)
    assert all(b is s for b, s in zip(free, staging))
    # A fill of a recycled buffer leaves the packed one as it was.
    buf = pf._staging(packed.nbytes)
    assert buf is not packed.buffer
    packer.fill([_batch(rng), _batch(rng)], buf, packed.spec)
    assert bool((packed.buffer == snapshot).all())


def _write_data(path, rng, lines=320, vocab=64):
    path.write_text("".join(
        f"{i % 2} {rng.integers(0, vocab)}:1 {rng.integers(0, vocab)}:0.5\n"
        for i in range(lines)))


def _cfg(tmp_path, **kw):
    base = dict(vocabulary_size=64, factor_num=4, max_features=4,
                batch_size=32, train_files=[str(tmp_path / "train.libsvm")],
                model_file=str(tmp_path / "model"), epoch_num=1, log_steps=0,
                thread_num=1, seed=3)
    base.update(kw)
    return FmConfig(**base)


def _state(t):
    return (t.model.table.detach().numpy().copy(),
            t.opt_state.acc_table.numpy().copy(),
            float(t.model.w0.detach()))


@pytest.mark.parametrize("prestacked", [False, True])
def test_trainer_cache_trains_every_batch_and_reports(tmp_path, caplog,
                                                      prestacked):
    """Three cached epochs of 10 batches at K = 2: every batch trains,
    the outcome is logged once and reported, 20 batches are replayed;
    the prestacked run ships all fifteen dispatches as packed groups
    (epoch 0's five, packed once, then their replays) with no fill."""
    _write_data(tmp_path / "train.libsvm", np.random.default_rng(0))
    cfg = _cfg(tmp_path, epoch_num=3, cache_epochs=True, steps_per_dispatch=2,
               cache_prestacked=prestacked)
    DevicePrefetcher.ships = DevicePrefetcher.fills = 0
    DevicePrefetcher.prestack_hits = 0
    replays = BatchPipeline.replays
    with caplog.at_level(logging.INFO):
        r = Trainer(cfg, device="cpu").train()["train"]
    assert r["steps"] == 30 and r["dispatches"] == 15
    assert r["examples"] == 3 * 320.0
    assert r["ingest_cache"] == "cached"
    assert caplog.text.count("ingest cache after epoch 0: cached") == 1
    assert DevicePrefetcher.ships == 15
    assert BatchPipeline.replays - replays == 20
    assert DevicePrefetcher.fills == (0 if prestacked else 15)
    assert DevicePrefetcher.prestack_hits == (15 if prestacked else 0)


def test_trainer_reports_an_overflow_and_trains_the_uncached_stream(
        tmp_path):
    """Past its budget the cache streams every epoch under its own seed:
    the parameters are bitwise the uncached run's."""
    _write_data(tmp_path / "train.libsvm", np.random.default_rng(0))
    plain = Trainer(_cfg(tmp_path, epoch_num=3,
                         model_file=str(tmp_path / "p")), device="cpu")
    rp = plain.train()["train"]
    over = Trainer(_cfg(tmp_path, epoch_num=3, cache_epochs=True,
                        cache_max_bytes=1, model_file=str(tmp_path / "o")),
                   device="cpu")
    ro = over.train()["train"]
    assert rp["ingest_cache"] == "off" and ro["ingest_cache"] == "overflow"
    for a, b in zip(_state(plain), _state(over)):
        np.testing.assert_array_equal(a, b)


def _interrupt_after(trainer, n):
    """``trainer.train()`` raises after ``n`` dispatches."""
    real = trainer.dispatch
    count = [0]

    def dispatch(sb, pause=None):
        if count[0] >= n:
            raise KeyboardInterrupt("simulated preemption")
        count[0] += 1
        return real(sb, pause)

    trainer.dispatch = dispatch


@pytest.mark.parametrize("prestacked", [False, True])
def test_trainer_cached_resume_mid_epoch_is_bitwise(tmp_path, prestacked):
    """A checkpoint saved mid-epoch 1 of a cached 3-epoch run at K = 2
    (the reference's ``test_trainer_cached_midepoch_resume_bitwise``):
    the resumed run trains exactly the rest and ends bitwise where the
    uninterrupted run did."""
    _write_data(tmp_path / "train.libsvm", np.random.default_rng(0))
    kw = dict(epoch_num=3, cache_epochs=True, steps_per_dispatch=2,
              cache_prestacked=prestacked)
    full = Trainer(_cfg(tmp_path, model_file=str(tmp_path / "full"), **kw),
                   device="cpu")
    assert full.train()["train"]["steps"] == 30
    cfg = _cfg(tmp_path, model_file=str(tmp_path / "int"), save_steps=2,
               **kw)
    t = Trainer(cfg, device="cpu")
    _interrupt_after(t, 7)  # 14 batches: mid-epoch 1
    with pytest.raises(KeyboardInterrupt):
        t.train()
    ds = checkpoint.restore_data_state(cfg.model_file)
    assert (ds["epoch"], ds["batches_done"]) == (1, 4)
    assert ds["fingerprint"].get("cache_prestacked", False) == prestacked
    resumed = Trainer(cfg, device="cpu")
    r = resumed.train()["train"]
    assert r["steps"] == 16 and r["ingest_cache"] == "cached"
    for a, b in zip(_state(resumed), _state(full)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("first, second", [
    (dict(cache_epochs=True), dict()),
    (dict(cache_epochs=True, cache_prestacked=True),
     dict(cache_epochs=True)),
])
def test_fingerprint_rejects_a_cache_toggle(tmp_path, caplog, first, second):
    """Toggling the cache, or its prestacked storage, redefines every
    epoch after the first: a position saved under the other setting is
    ignored and the run trains from the start."""
    import json

    _write_data(tmp_path / "train.libsvm", np.random.default_rng(0))
    cfg = _cfg(tmp_path, epoch_num=2, **first)
    Trainer(cfg, device="cpu").train()
    path = checkpoint.data_state_path(cfg.model_file)
    with open(path) as f:
        ds = json.load(f)
    ds.update(epoch=1, batches_done=3)
    with open(path, "w") as f:
        json.dump(ds, f)
    assert Trainer(cfg, device="cpu")._resume_position() == (1, 3)
    with caplog.at_level(logging.WARNING):
        r = Trainer(_cfg(tmp_path, epoch_num=2, **second),
                    device="cpu").train()["train"]
    assert r["steps"] == 20 and "different input config" in caplog.text


@pytest.mark.parametrize("fast_ingest, prestacked, k", [
    (True, False, 1), (False, False, 3), (True, True, 3),
])
def test_trainer_with_the_cache_matches_the_reference_trainer(
        tmp_path, fast_ingest, prestacked, k):
    """Three cached epochs (plain and prestacked) through ``Trainer.train``
    in both packages, from the reference's initial table: the same
    replayed stream gives the same parameters."""
    path, vocab, factor = _gen_sample(tmp_path)
    common = dict(
        vocabulary_size=vocab, factor_num=factor, max_features=16,
        batch_size=128, epoch_num=3, learning_rate=0.5,
        adagrad_initial_accumulator=0.01, optimizer="adagrad",
        factor_lambda=1e-4, bias_lambda=1e-4, init_value_range=0.05,
        shuffle_buffer=400, seed=7, train_files=[path], log_steps=0,
        steps_per_dispatch=k, fast_ingest=fast_ingest, thread_num=2,
        cache_epochs=True, cache_prestacked=prestacked,
    )
    jt = JaxTrainer(JaxFmConfig(model_file=str(tmp_path / "jax_model"),
                                sparse_apply="scatter", **common))
    init = jax.tree.map(np.asarray, jt.state.params)
    jres = jt.train()
    port_dir = str(tmp_path / "port_model")
    checkpoint.save_params(port_dir, weights.from_jax(init.w0, init.table,
                                                      device="cpu"))
    pt = Trainer(FmConfig(model_file=port_dir, **common), device="cpu")
    pres = pt.train()
    assert pres["train"]["steps"] == 3 * 12
    assert pres["train"]["ingest_cache"] == jres["train"]["ingest_cache"] \
        == "cached"
    assert pres["train"]["examples"] == jres["train"]["examples"]
    params = jt.state.params
    np.testing.assert_allclose(pt.model.table.detach().numpy(),
                               np.asarray(params.table), **TABLE_TOL)
    np.testing.assert_allclose(float(pt.model.w0.detach()), float(params.w0),
                               **W0_TOL)
    np.testing.assert_allclose(pt.opt_state.acc_table.numpy(),
                               np.asarray(jt.state.opt_state.acc.table),
                               **OPT_TOL)
    np.testing.assert_allclose(pres["train"]["logloss"],
                               jres["train"]["logloss"], rtol=1e-4)


@pytest.mark.parametrize("prestacked", ["false", "true"])
def test_cli_trains_with_the_cache(tmp_path, capsys, prestacked):
    """``cache_epochs`` (and ``cache_prestacked``) through the CLI on the
    CPU: accepted, every epoch trained, the outcome reported."""
    _write_data(tmp_path / "train.libsvm", np.random.default_rng(2))
    cfg_path = tmp_path / "run.cfg"
    cfg_path.write_text(f"""
[General]
vocabulary_size = 64
factor_num = 4
model_file = {tmp_path}/model
[Train]
train_files = {tmp_path}/train.libsvm
epoch_num = 3
batch_size = 32
steps_per_dispatch = 2
cache_epochs = true
cache_prestacked = {prestacked}
log_steps = 0
[Tpu]
max_features = 4
""")
    assert cli.main(["train", str(cfg_path), "--device", "cpu"]) == 0
    with np.load(checkpoint.params_path(str(tmp_path / "model"))) as z:
        assert int(z["scalar/step"]) == 30
    ds = checkpoint.restore_data_state(str(tmp_path / "model"))
    assert ds["fingerprint"]["cache_epochs"] is True
    assert ds["fingerprint"].get("cache_prestacked", False) == (
        prestacked == "true")
