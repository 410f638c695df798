"""The port's input stream vs the JAX package's on the CPU: the port's
``BatchPipeline`` batches against ``fast_tffm_tpu.data.pipeline.
BatchPipeline``'s on the same files, config and seed, bitwise (labels,
ids, vals, fields, weights; the truncation count), on both of the
reference's streams; and the port's ``Trainer.train`` against the
reference's trainer on ``examples/gen_sample_data.py`` data.

The raw-window cases are sized so a window spans a file boundary and
holds several batches: file 1's chunk ends with lines short of a whole
batch, which the window that file 2's chunk completes carries over (a
chunk never spans two files).  Blank, whitespace and ``#`` lines stay
in the raw stream as weight-0 rows and leave the line stream; the last
file lacks its trailing newline.
"""

import importlib.util
import os

import numpy as np
import pytest

import jax

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.data.pipeline import BatchPipeline as JaxBatchPipeline
from fast_tffm_tpu.data.pipeline import EpochEnd as JaxEpochEnd
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data import libsvm
from fast_tffm_tpu_torch.data.pipeline import BatchPipeline, EpochEnd
from fast_tffm_tpu_torch.train import checkpoint
from fast_tffm_tpu_torch.train.loop import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Tile-vs-scatter bounds (tests/test_sparse_apply.py): the port's K1/K2
# against the reference's scatter apply on the CPU.
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-4, atol=1e-4)
W0_TOL = dict(rtol=1e-5, atol=1e-7)
STREAM = dict(vocabulary_size=97, batch_size=4, max_features=5,
              shuffle_buffer=10, seed=11, queue_size=3)


def _line(rng, i):
    n = int(rng.integers(1, 8))  # up to 7 features: some are truncated
    feats = " ".join(f"{int(rng.integers(0, 500))}:{rng.uniform(0.1, 2):.3f}"
                     for _ in range(n))
    return f"{i % 2} {feats}"


def _write_files(tmp_path):
    """Two files: 203 lines with blank, whitespace and ``#`` lines among
    them, then 57 lines with no newline after the last."""
    rng = np.random.default_rng(5)
    a = [_line(rng, i) for i in range(203)]
    for pos, text in ((7, ""), (40, "# a comment"), (41, "   "),
                      (120, "  # indented comment"), (202, "")):
        a[pos] = text
    b = [_line(rng, i) for i in range(57)]
    b[30] = "#"
    paths = [str(tmp_path / "part-0.libsvm"), str(tmp_path / "part-1.libsvm")]
    with open(paths[0], "w") as f:
        f.write("\n".join(a) + "\n")
    with open(paths[1], "w") as f:
        f.write("\n".join(b))
    wpaths = [p + ".w" for p in paths]
    for p, lines in zip(wpaths, (a, b)):
        with open(p, "w") as f:
            f.write("\n".join(
                "" if not t.strip() or t.lstrip().startswith("#")
                else f"{(k % 7) / 4:.2f}" for k, t in enumerate(lines)))
    return paths, wpaths


def _port_batches(files, cfg, **kw):
    with BatchPipeline(files, cfg, **kw) as p:
        return list(p), p.truncated_features, p.raw


def _jax_batches(files, cfg, weight_files=None, **kw):
    p = JaxBatchPipeline(files, cfg, weight_files=weight_files, ordered=True,
                         **kw)
    return list(p), p.truncated_features, p._raw


@pytest.mark.parametrize("fast_ingest, with_weights, shuffle, epochs, shard", [
    (True, False, True, 1, (0, 1)),
    (True, False, False, 1, (0, 1)),
    (True, False, True, 2, (0, 1)),
    (True, False, True, 2, (1, 2)),
    (False, False, True, 2, (0, 1)),
    (False, False, False, 1, (0, 1)),
    (False, False, True, 1, (0, 2)),
    (True, True, True, 2, (0, 1)),
    (True, True, False, 1, (1, 2)),
])
def test_batches_match_the_reference_bitwise(tmp_path, fast_ingest,
                                             with_weights, shuffle, epochs,
                                             shard):
    files, wfiles = _write_files(tmp_path)
    wfiles = wfiles if with_weights else None
    common = dict(epochs=epochs, shuffle=shuffle, shard=shard)
    got, got_trunc, raw = _port_batches(
        files, FmConfig(fast_ingest=fast_ingest, **STREAM),
        weight_files=wfiles, host_meta=True, **common)
    want, want_trunc, jax_raw = _jax_batches(
        files, JaxFmConfig(fast_ingest=fast_ingest, **STREAM),
        weight_files=wfiles, **common)
    # The raw-window stream runs exactly when the reference takes it.
    assert raw == jax_raw == (fast_ingest and not with_weights)
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        for name in ("labels", "ids", "vals", "fields", "weights"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        meta = libsvm.host_sort_meta(w.ids)
        np.testing.assert_array_equal(g.sort_meta.perm, meta.perm)
        np.testing.assert_array_equal(g.sort_meta.seg_start, meta.seg_start)
    assert got_trunc == want_trunc > 0
    weights_seen = np.concatenate([g.weights for g in got])
    if raw and shard == (0, 1):
        # Each epoch: 2 x 203 + 57 rows padded to whole batches, six
        # blank or comment lines among them at weight 0.
        assert weights_seen.size == epochs * 4 * -(-(203 + 57) // 4)
        assert int((weights_seen > 0).sum()) == epochs * (260 - 6)


@pytest.mark.parametrize(
    "fast_ingest, shuffle, shard, threads, start_epoch, skip", [
        (True, True, (0, 1), 1, 0, 0),
        (True, True, (0, 1), 4, 0, 0),
        (True, False, (1, 2), 4, 0, 3),
        (True, True, (0, 1), 4, 1, 5),
        (False, True, (0, 1), 1, 0, 7),
        (False, True, (1, 2), 4, 1, 2),
        (False, False, (0, 1), 4, 0, 0),
    ])
def test_threaded_stream_matches_the_reference_bitwise(
        tmp_path, fast_ingest, shuffle, shard, threads, start_epoch, skip):
    """``thread_num`` parse workers, reordered to reader order: two
    epochs with their :class:`EpochEnd` markers, from a resume position,
    bitwise the reference's ``BatchPipeline(ordered=True)``; the Python
    parser (asked for by name) gives the same batches."""
    files, _ = _write_files(tmp_path)
    common = dict(epochs=2, shuffle=shuffle, shard=shard,
                  start_epoch=start_epoch, skip_batches=skip,
                  epoch_marks=True)
    kw = dict(fast_ingest=fast_ingest, thread_num=threads, **STREAM)
    got, got_trunc, _ = _port_batches(files, FmConfig(**kw), host_meta=True,
                                      **common)
    plain, plain_trunc, _ = _port_batches(files, FmConfig(**kw),
                                          host_meta=True, native=False,
                                          **common)
    want, want_trunc, _ = _jax_batches(files, JaxFmConfig(**kw), **common)
    marks = [i for i, b in enumerate(want) if isinstance(b, JaxEpochEnd)]
    assert len(marks) == 2 - start_epoch and len(want) > 8
    assert got_trunc == plain_trunc == want_trunc > 0
    assert len(got) == len(plain) == len(want)
    for g, p, w in zip(got, plain, want):
        if isinstance(w, JaxEpochEnd):
            assert g == p == EpochEnd(w.epoch)
            continue
        for name in ("labels", "ids", "vals", "fields", "weights"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name),
                                          err_msg=name)
            np.testing.assert_array_equal(getattr(p, name), getattr(w, name),
                                          err_msg=name)
        meta = libsvm.host_sort_meta(w.ids)
        for a, b, c in zip(g.sort_meta, p.sort_meta, meta):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, c)


def test_raw_window_spans_the_file_boundary(tmp_path):
    """The shapes the bitwise cases rely on: a window that holds file 1's
    last lines and file 2's first, and more than one batch."""
    from fast_tffm_tpu_torch.data.native import find_line_offsets
    from fast_tffm_tpu_torch.data.pipeline import _iter_raw_windows

    files, _ = _write_files(tmp_path)
    wins = list(_iter_raw_windows(files, 4, 10))
    # The C++ line scan (the native path's) cuts the same windows.
    for a, b in zip(wins, _iter_raw_windows(files, 4, 10,
                                            line_starts=find_line_offsets)):
        assert a.buf == b.buf and a.marks == b.marks
        np.testing.assert_array_equal(a.starts, b.starts)
        np.testing.assert_array_equal(a.ends, b.ends)
    assert sum(len(w.starts) for w in wins) == 260
    spanning = [w for w in wins if {m[1] for m in w.marks} == set(files)]
    assert spanning and all(len(w.starts) >= 8 for w in spanning)
    last = wins[-1]
    assert last.locate(int(last.starts[-1])) == (files[1], 57)


def test_malformed_line_names_file_and_line_on_both_streams(tmp_path):
    files, _ = _write_files(tmp_path)
    with open(files[1], "a") as f:
        f.write("\n1 7:1\n0 4:zz\n")
    for fast_ingest in (True, False):
        cfg = FmConfig(fast_ingest=fast_ingest, **STREAM)
        with pytest.raises(ValueError, match="part-1.libsvm:59:"):
            _port_batches(files, cfg, shuffle=True)


def _gen_sample(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "gen_sample_data", os.path.join(REPO, "examples",
                                        "gen_sample_data.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    rng = np.random.default_rng(42)
    vocab, factor = 300, 4
    w = rng.normal(0, 0.5, size=vocab)
    v = rng.normal(0, 0.3, size=(vocab, factor))
    path = str(tmp_path / "train.libsvm")
    gen.gen(path, 1500, rng, vocab, 13, w, v)
    return path, vocab, factor


@pytest.mark.parametrize("fast_ingest, k", [
    (True, 1), (False, 1), (True, 3), (False, 3),
])
def test_trainer_params_match_the_reference_trainer(tmp_path, fast_ingest,
                                                    k):
    """Shuffled sparse Adagrad through ``Trainer.train`` in both
    packages, from the reference's initial table, four parse threads:
    the same batches in the same order give the same parameters, with K
    = 1 and with super-batches of K = 3 (the epochs' 12 batches in four
    dispatches)."""
    path, vocab, factor = _gen_sample(tmp_path)
    common = dict(
        vocabulary_size=vocab, factor_num=factor, max_features=16,
        batch_size=128, epoch_num=2, learning_rate=0.5,
        adagrad_initial_accumulator=0.01, optimizer="adagrad",
        factor_lambda=1e-4, bias_lambda=1e-4, init_value_range=0.05,
        shuffle_buffer=400, seed=7, train_files=[path], log_steps=0,
        steps_per_dispatch=k, fast_ingest=fast_ingest, thread_num=4,
    )
    jcfg = JaxFmConfig(model_file=str(tmp_path / "jax_model"),
                       sparse_apply="scatter", **common)
    jt = JaxTrainer(jcfg)
    init = jax.tree.map(np.asarray, jt.state.params)
    jres = jt.train()
    port_dir = str(tmp_path / "port_model")
    checkpoint.save_params(port_dir, weights.from_jax(init.w0, init.table,
                                                      device="cpu"))
    pt = Trainer(FmConfig(model_file=port_dir, **common), device="cpu")
    pres = pt.train()
    assert pres["train"]["steps"] == 2 * -(-1500 // 128)
    assert pres["train"]["dispatches"] == 2 * -(-12 // k)
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
