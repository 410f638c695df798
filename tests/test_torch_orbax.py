"""The port's reader of the JAX package's Orbax dense checkpoints
(``fast_tffm_tpu_torch/train/orbax_read.py``) against the JAX package,
on the CPU, and everything that now reads them.

- The reader's layers: zstd through the system library; the OCDBT store
  against tensorstore's own OCDBT driver (every key and every raw value,
  deep trees and several versions included); zarr v2 arrays (edge
  chunks, absent chunks, ``rows=``) against tensorstore's zarr driver;
  params and every optimizer's ``opt`` tree bitwise against the
  reference's ``checkpoint.restore_params`` and ``restore_opt`` (which
  trees give None is found by running the reference), one-chunk and
  row-sharded tables (1 x 8, 2 x 4, 8 x 1 meshes), at ``sample.cfg``,
  ``ffm_sample.cfg`` and Criteo-Kaggle width; the refusals.
- The port's consumers against the reference: a trainer warm-started from
  the reference's mid-epoch checkpoint (every optimizer, and tiered)
  ends within the tile-vs-scatter bounds of the reference's
  uninterrupted run, and four ranks warm-started from its checkpoint
  end where one process does; the FTRL warm-start repair; predict; the formats'
  exclusion and the manifest of every port save.
- The committed fixtures of ``tests/data/orbax/`` (written by
  ``tests/make_orbax_fixtures.py``) against the reference's own restore
  and scorer.

Tolerances are the reference's: scores ``rtol=1e-5, atol=1e-6``; tables
after training ``rtol=1e-4, atol=1e-6``, accumulators ``atol=1e-4``
(``tests/test_sparse_apply.py``); restored arrays bitwise.
"""

import json
import logging
import os
import shutil
import struct
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tensorstore as ts
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax.sharding import SingleDeviceSharding

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.serve.scorer import FixedShapeScorer as JaxScorer
from fast_tffm_tpu.train import checkpoint as jax_checkpoint
from fast_tffm_tpu.train import sparse as jax_sparse
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu.train.loop import predict as jax_predict
from fast_tffm_tpu.train.manifest import read_manifest as jax_read_manifest
from fast_tffm_tpu.train.optimizers import make_optimizer
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.ops import quant
from fast_tffm_tpu_torch.serve.scorer import load_model, make_scorer
from fast_tffm_tpu_torch.tools import convert_checkpoint
from fast_tffm_tpu_torch.train import checkpoint, orbax_read
from fast_tffm_tpu_torch.train.loop import Trainer, predict
from fast_tffm_tpu_torch.train.sparse import SparseFtrlState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "orbax")
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-4, atol=1e-4)
W0_TOL = dict(rtol=1e-5, atol=1e-7)


# ----------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------


def _ts_items(directory: str) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://" + directory}).result()
    return {k.decode(): kv.read(k).result().value
            for k in kv.list().result()}


def _assert_store_is_tensorstores(directory: str) -> None:
    store = orbax_read.OcdbtStore(directory)
    want = _ts_items(directory)
    assert store.keys() == sorted(want)
    for key, value in want.items():
        assert store.read(key).tobytes() == value, key


def _sds(x, sharding=None):
    return jax.ShapeDtypeStruct(
        x.shape, x.dtype,
        sharding=sharding or SingleDeviceSharding(jax.devices()[0]))


def _jax_params(model_file, vocab, dim):
    template = jax_fm.FmParams(
        w0=_sds(jax.ShapeDtypeStruct((), jnp.float32)),
        table=_sds(jax.ShapeDtypeStruct((vocab, dim), jnp.float32)))
    params, step = jax_checkpoint.restore_params(model_file, template)
    return step, np.asarray(params.w0), np.asarray(params.table)


def _random_params(rng, vocab, dim):
    return jax_fm.FmParams(
        w0=jnp.float32(rng.uniform(-0.5, 0.5)),
        table=jnp.asarray(rng.standard_normal((vocab, dim)).astype(
            np.float32)))


def _assert_params_match(model_file, vocab, dim, rows=None):
    step, w0, table = _jax_params(model_file, vocab, dim)
    got_step, got_w0, got_table, shape = orbax_read.read_params(
        model_file, rows=rows)
    assert (got_step, shape) == (step, (vocab, dim))
    assert got_w0.tobytes() == w0.tobytes()
    want = table if rows is None else table[rows]
    assert got_table.dtype == np.float32
    np.testing.assert_array_equal(got_table, want)


# The optimizer trees a reference save can hold: the trainer's
# optimizer, and whether its sparse step (True) or optax's (False)
# initialised the state.
TREES = [("adagrad", True), ("ftrl", True), ("sgd", True),
         ("adagrad", False), ("ftrl", False), ("sgd", False),
         ("adam", False)]
_FIELDS = {
    "adagrad": ("acc_w0", "acc_table"),
    "ftrl": ("z_w0", "z_table", "n_w0", "n_table"),
    "sgd": (),
    "adam": ("mu_w0", "mu_table", "nu_w0", "nu_table", "count"),
}


def _jax_opt_init(optimizer, sparse):
    cfg = JaxFmConfig(optimizer=optimizer, vocabulary_size=8,
                      factor_num=2)
    if sparse:
        return lambda p: jax_sparse.init_sparse_opt_state(cfg, p)
    return make_optimizer(cfg).init


def _jax_leaves(optimizer, sparse, state):
    """The reference's state leaves in the port's field order."""
    if optimizer == "sgd":
        return []
    if optimizer == "adagrad":
        acc = state.acc if sparse else state[0].sum_of_squares
        return [acc.w0, acc.table]
    if optimizer == "ftrl":
        return [state.z.w0, state.z.table, state.n.w0, state.n.table]
    a = state[0]
    return [a.mu.w0, a.mu.table, a.nu.w0, a.nu.table, a.count]


def _moved(state, rng):
    """Each float leaf moved by a seeded draw (an int leaf set to 7)."""
    def move(x):
        x = np.asarray(x)
        if x.dtype.kind != "f":
            return jnp.asarray(np.array(7, x.dtype))
        return jnp.asarray((x + rng.uniform(0, 1, x.shape)).astype(
            np.float32))
    return jax.tree.map(move, state)


# ----------------------------------------------------------------------
# layer 1: zstd
# ----------------------------------------------------------------------


def test_zstd_decompresses_with_and_without_a_content_size():
    import zstandard

    data = np.random.default_rng(0).standard_normal(5000).astype(
        np.float32)
    framed = zstandard.ZstdCompressor(level=3).compress(data.tobytes())
    got = orbax_read.zstd_decompress(framed)
    assert got.tobytes() == data.tobytes()
    # A streamed frame carries no content size: sized by the caller.
    co = zstandard.ZstdCompressor(write_content_size=False).compressobj()
    streamed = co.compress(data.tobytes()) + co.flush()
    out = np.empty_like(data)
    orbax_read.zstd_decompress(streamed, out=out)
    np.testing.assert_array_equal(out, data)
    assert orbax_read.zstd_decompress(
        streamed, capacity=1 << 20).tobytes() == data.tobytes()
    with pytest.raises(ValueError, match="no content size"):
        orbax_read.zstd_decompress(streamed)
    with pytest.raises(ValueError):
        orbax_read.zstd_decompress(streamed, out=np.empty(4999, np.float32))
    with pytest.raises(ValueError, match="not a zstd frame"):
        orbax_read.zstd_decompress(b"not zstd at all")


def test_a_missing_zstd_library_is_named(monkeypatch):
    monkeypatch.setattr(orbax_read, "_ZSTD", None)
    monkeypatch.setattr(orbax_read, "ZSTD_LIBRARY", "libzstd_absent.so.9")
    with pytest.raises(OSError, match="libzstd_absent.so.9"):
        orbax_read.zstd_decompress(b"\x28\xb5\x2f\xfd")


# ----------------------------------------------------------------------
# layer 2: OCDBT against tensorstore's driver
# ----------------------------------------------------------------------


@pytest.mark.parametrize("compression", [None, {"id": "zstd"}])
def test_ocdbt_deep_trees_and_versions_match_tensorstore(tmp_path,
                                                        compression):
    """Small nodes (interior nodes four levels deep, prefix-compressed
    keys, each child's keys relative to its subtree's common prefix),
    inline and indirect values, one version per write, overwritten and
    deleted keys: the latest version's keys and bytes, as tensorstore
    lists and reads them."""
    d = str(tmp_path / "db")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + d,
                          "config": {"max_decoded_node_bytes": 256,
                                     "max_inline_value_bytes": 16,
                                     "compression": compression}}).result()
    rng = np.random.default_rng(1)
    for i in range(70):
        kv.write(f"key{i:03d}/x", rng.bytes(int(rng.integers(1, 60)))
                 ).result()
    kv.write("key005/x", b"again").result()
    kv.delete_range(ts.KvStore.KeyRange("key010", "key013")).result()
    store = orbax_read.OcdbtStore(d)
    assert store.generation > 70
    assert "key011/x" not in store and store.read("key011/x") is None
    _assert_store_is_tensorstores(d)


def test_zarr_edge_and_absent_chunks_match_tensorstore(tmp_path):
    d = str(tmp_path / "db")
    arr = np.random.default_rng(2).standard_normal((10, 7)).astype(
        np.float32)
    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt", "base": "file://" + d},
            "path": "a", "metadata": {"shape": [10, 7], "chunks": [4, 3],
                                      "dtype": "<f4", "fill_value": 0.5,
                                      "compressor": {"id": "zstd"}}}
    t = ts.open(spec, create=True).result()
    t[...] = arr
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://" + d}).result()
    kv.delete_range(ts.KvStore.KeyRange("a/1.1", "a/1.1\0")).result()
    want = ts.open({**spec, "metadata": {}}, open=True).result().read(
    ).result()
    assert np.all(want[4:8, 3:6] == 0.5)  # the absent chunk's fill
    store = orbax_read.OcdbtStore(d)
    np.testing.assert_array_equal(orbax_read.read_array(store, "a"), want)
    for rows in (slice(0, 4), slice(3, 9), slice(9, 10), slice(5, 5)):
        np.testing.assert_array_equal(
            orbax_read.read_array(store, "a", rows=rows), want[rows])


# ----------------------------------------------------------------------
# layers 3-4: params and optimizer state against the reference
# ----------------------------------------------------------------------


@pytest.mark.parametrize("cfg_name", ["sample.cfg", "ffm_sample.cfg"])
def test_params_match_the_reference_bitwise(tmp_path, cfg_name):
    cfg = load_config(os.path.join(REPO, "examples", cfg_name))
    vocab, dim = cfg.vocabulary_size, cfg.embedding_dim
    model_file = str(tmp_path / "m")
    jax_checkpoint.save(model_file, 123, _random_params(
        np.random.default_rng(3), vocab, dim))
    _assert_store_is_tensorstores(orbax_read.params_dir(model_file))
    _assert_params_match(model_file, vocab, dim)
    _assert_params_match(model_file, vocab, dim,
                         rows=slice(vocab // 3, vocab // 2))
    assert orbax_read.read_opt(model_file, "adagrad") is None  # no opt/


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (8, 1)])
def test_row_sharded_tables_match_the_reference_bitwise(tmp_path,
                                                       mesh_shape):
    """A table sharded P('model', None) is saved as several chunks (8
    from 2 x 4: not the mesh's shard count); ``rows=`` cuts read only
    the chunks that cover them."""
    vocab, dim = 96, 5
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(mesh_shape),
                ("data", "model"))
    sharding = NamedSharding(mesh, P("model", None))
    params = _random_params(np.random.default_rng(4), vocab, dim)
    params = params._replace(table=jax.device_put(params.table, sharding))
    acc = jax_sparse.SparseAdagradState(acc=jax_fm.FmParams(
        w0=jnp.float32(0.3), table=jax.device_put(
            jnp.full((vocab, dim), 0.25, jnp.float32), sharding)))
    model_file = str(tmp_path / "m")
    jax_checkpoint.save(model_file, 5, params, acc)
    store = orbax_read.OcdbtStore(orbax_read.params_dir(model_file))
    chunks = [k for k in store.keys() if k.startswith("params.table/")
              and not k.endswith(".zarray")]
    assert len(chunks) >= 1
    _assert_store_is_tensorstores(orbax_read.params_dir(model_file))
    _assert_store_is_tensorstores(orbax_read.opt_dir(model_file))
    for rows in (None, slice(0, 12), slice(10, 37), slice(90, 96)):
        _assert_params_match(model_file, vocab, dim, rows=rows)
    got = orbax_read.read_opt(model_file, "adagrad", rows=slice(10, 37))
    np.testing.assert_array_equal(got["acc_table"],
                                  np.full((27, dim), 0.25, np.float32))
    assert got["acc_w0"] == np.float32(0.3)


@pytest.mark.parametrize("saved", TREES, ids=lambda t: f"{t[0]}-"
                         f"{'sparse' if t[1] else 'dense'}")
def test_opt_trees_match_the_reference(tmp_path, saved):
    """The ``opt`` tree of each optimizer, saved by the reference and read
    for every trainer the port has: None exactly where the reference's
    ``restore_opt`` gives None, else every leaf bitwise (Adam's count
    int32)."""
    rng = np.random.default_rng(5)
    vocab, dim = 24, 3
    params = _random_params(rng, vocab, dim)
    state = _moved(_jax_opt_init(*saved)(params), rng)
    model_file = str(tmp_path / "m")
    jax_checkpoint.save(model_file, 9, params, state)
    shardings = SingleDeviceSharding(jax.devices()[0])
    for optimizer, sparse in TREES:
        template = jax.tree.map(
            lambda s: _sds(s, shardings),
            jax.eval_shape(_jax_opt_init(optimizer, sparse), params))
        want = jax_checkpoint.restore_opt(model_file, template)
        got = orbax_read.read_opt(model_file, optimizer, sparse=sparse)
        assert (got is None) == (want is None), (optimizer, sparse)
        if got is None:
            continue
        want_leaves = _jax_leaves(optimizer, sparse, want)
        assert list(got) == list(_FIELDS[optimizer])
        for field, w in zip(_FIELDS[optimizer], want_leaves):
            w = np.asarray(w)
            assert got[field].dtype == w.dtype, field
            np.testing.assert_array_equal(got[field], w)
        if optimizer == "adam":
            assert got["count"].dtype == np.int32 and got["count"] == 7
    # The port's state types, on the device asked for.
    for optimizer, sparse in TREES:
        st = checkpoint.restore_opt_state(model_file, optimizer,
                                          device="cpu", sparse=sparse)
        if (optimizer, sparse) == saved:
            assert st is not None and len(st) == len(_FIELDS[optimizer])


def test_criteo_kaggle_width_reads_bitwise(tmp_path, capsys):
    """V = 2^22, D = 9: the table and Adagrad's accumulator (151 MB each,
    one chunk, decompressed straight into the result)."""
    vocab, dim = 1 << 22, 9
    rng = np.random.default_rng(6)
    table = rng.standard_normal((vocab, dim), dtype=np.float32)
    params = jax_fm.FmParams(w0=jnp.float32(0.125), table=jnp.asarray(table))
    acc = jax_sparse.SparseAdagradState(acc=jax_fm.FmParams(
        w0=jnp.float32(2.0),
        table=jnp.asarray(rng.uniform(0.1, 2, (vocab, dim)).astype(
            np.float32))))
    model_file = str(tmp_path / "m")
    jax_checkpoint.save(model_file, 31, params, acc)
    want_acc = np.asarray(acc.acc.table)
    del params, acc
    t0 = time.perf_counter()
    step, w0, got, shape = orbax_read.read_params(model_file)
    params_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got_acc = orbax_read.read_opt(model_file, "adagrad")
    opt_s = time.perf_counter() - t0
    assert (step, shape, w0) == (31, (vocab, dim), np.float32(0.125))
    np.testing.assert_array_equal(got, table)
    np.testing.assert_array_equal(got_acc["acc_table"], want_acc)
    del got, got_acc
    _, _, cut, _ = orbax_read.read_params(model_file,
                                          rows=slice(1 << 21, 3 << 20))
    np.testing.assert_array_equal(cut, table[1 << 21:3 << 20])
    _, _, ref_table = _jax_params(model_file, vocab, dim)
    np.testing.assert_array_equal(ref_table, table)
    with capsys.disabled():
        print(f"\nCriteo-Kaggle width Orbax read (CPU): params "
              f"{params_s:.2f} s, Adagrad state {opt_s:.2f} s")


def _zarray_copy(tmp_path, edit):
    """A reference checkpoint copied, with ``edit`` applied to its table's
    ``.zarray`` (written into the copy's OCDBT store as a new version)."""
    src = str(tmp_path / "src")
    jax_checkpoint.save(src, 1, _random_params(np.random.default_rng(7),
                                               16, 3))
    dst = str(tmp_path / "dst")
    shutil.copytree(src, dst)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://"
                          + orbax_read.params_dir(dst)}).result()
    meta = json.loads(kv.read("params.table/.zarray").result().value)
    edit(meta)
    kv.write("params.table/.zarray", json.dumps(meta).encode()).result()
    return dst


def _envelope_copy(tmp_path, version=0, compression=1):
    """A reference checkpoint whose manifest envelope claims another
    format version or compression (its CRC recomputed)."""
    d = str(tmp_path / "m")
    jax_checkpoint.save(d, 1, _random_params(np.random.default_rng(8),
                                             16, 3))
    path = os.path.join(orbax_read.params_dir(d), "manifest.ocdbt")
    data = bytearray(open(path, "rb").read())
    data[12], data[13] = version, compression
    data[-4:] = struct.pack("<I", orbax_read._crc32c(bytes(data[:-4])))
    open(path, "wb").write(bytes(data))
    return d


@pytest.mark.parametrize("case, match", [
    ("compressor", "unsupported compressor 'blosc'"),
    ("filters", "unsupported filters"),
    ("order", "unsupported order 'F'"),
    ("dtype", "unsupported dtype '<f8'"),
    ("params_path", r"unknown tree paths \[\('params', 'bias'\)\]"),
    ("opt_path", r"unknown tree paths \[\('opt_state', 'mystery'\)\]"),
    ("version", "unknown OCDBT manifest format version 1"),
    ("compression", "unknown OCDBT manifest compression 7"),
    ("crc", "CRC-32C mismatch"),
])
def test_refusals(tmp_path, case, match):
    edits = {
        "compressor": lambda m: m.update(compressor={"id": "blosc"}),
        "filters": lambda m: m.update(filters=[{"id": "delta"}]),
        "order": lambda m: m.update(order="F"),
        "dtype": lambda m: m.update(dtype="<f8"),
    }
    if case in edits:
        d = _zarray_copy(tmp_path, edits[case])
    elif case in ("version", "compression"):
        d = _envelope_copy(tmp_path, **{case: {"version": 1,
                                               "compression": 7}[case]})
    else:
        d = str(tmp_path / "m")
        params = _random_params(np.random.default_rng(9), 16, 3)
        jax_checkpoint.save(d, 1, params, jax_sparse.SparseAdagradState(
            acc=params))
        which = "opt" if case == "opt_path" else "params"
        path = os.path.join(d, which, "_METADATA" if case != "crc"
                            else "manifest.ocdbt")
        if case == "crc":
            data = bytearray(open(path, "rb").read())
            data[20] ^= 0xFF
            open(path, "wb").write(bytes(data))
        else:
            meta = json.load(open(path))
            key = "mystery" if which == "opt" else "bias"
            top = "opt_state" if which == "opt" else "params"
            meta["tree_metadata"][f"('{top}', '{key}')"] = {
                "key_metadata": [{"key": top, "key_type": 2},
                                 {"key": key, "key_type": 2}],
                "value_metadata": {"value_type": "jax.Array",
                                   "skip_deserialize": False}}
            json.dump(meta, open(path, "w"))
    with pytest.raises(ValueError, match=match):
        if case == "opt_path":
            orbax_read.read_opt(d, "adagrad")
        else:
            orbax_read.read_params(d)


# ----------------------------------------------------------------------
# the port's consumers against the reference
# ----------------------------------------------------------------------


def _write_lines(path, n, vocab, rng, n_feat=10):
    w = rng.normal(0, 0.5, vocab)
    rows = []
    for _ in range(n):
        ids = rng.choice(vocab, size=n_feat, replace=False)
        vals = np.round(rng.uniform(0.2, 1.0, size=n_feat), 3)
        label = int(rng.uniform() < 1 / (1 + np.exp(-w[ids] @ vals)))
        rows.append(f"{label} " + " ".join(
            f"{i}:{x}" for i, x in zip(ids, vals)) + "\n")
    with open(path, "w") as f:
        f.writelines(rows)


def _snapshot_first_save(trainer_cls, monkeypatch, snap):
    """Copy the model directory right after the trainer's first save, as
    a run interrupted there would leave it."""
    orig = trainer_cls.save
    done = []

    def save(self, stepno):
        out = orig(self, stepno)
        if not done:
            shutil.copytree(self.cfg.model_file, snap)
            done.append(stepno)
        return out

    monkeypatch.setattr(trainer_cls, "save", save)


V_TRAIN = 300
TRAIN_KW = dict(
    vocabulary_size=V_TRAIN, factor_num=4, max_features=12, batch_size=64,
    epoch_num=1, learning_rate=0.1, adagrad_initial_accumulator=0.1,
    ftrl_l1=0.01, ftrl_l2=0.1, factor_lambda=1e-4, bias_lambda=1e-4,
    init_value_range=0.05, seed=7, log_steps=0, save_steps=2,
    thread_num=2,
)


@pytest.mark.parametrize("optimizer, tiered", [
    ("adagrad", False), ("ftrl", False), ("sgd", False), ("adam", False),
    ("adagrad", True), ("ftrl", True),
])
def test_warm_start_from_the_references_mid_epoch_checkpoint(
        tmp_path, monkeypatch, optimizer, tiered):
    """The reference trains 4 steps, saving after 2 (mid-epoch: its
    Orbax dirs and ``data_state.json``); the port warm-starts from that
    snapshot, with or without tiering, continues the stream at batch 2
    and trains the last 2 steps.  Its final checkpoint is within the
    tile-vs-scatter bounds of the reference's 4-step run; the port's save
    replaced the Orbax dirs by ``params.npz`` and published a manifest
    the reference reads."""
    path = str(tmp_path / "train.libsvm")
    _write_lines(path, 256, V_TRAIN, np.random.default_rng(10))
    kw = dict(TRAIN_KW, optimizer=optimizer, train_files=[path])
    snap = str(tmp_path / "snap")
    _snapshot_first_save(JaxTrainer, monkeypatch, snap)
    jt = JaxTrainer(JaxFmConfig(model_file=str(tmp_path / "jax"), **kw))
    jres = jt.train()
    monkeypatch.undo()
    assert jres["train"]["steps"] == 4
    assert orbax_read.exists(snap)
    assert checkpoint.restore_data_state(snap)["batches_done"] == 2
    port_kw = dict(kw, table_tiering="on", hot_rows=V_TRAIN) if tiered \
        else kw
    pt = Trainer(FmConfig(model_file=snap, **port_kw), device="cpu")
    assert pt._restored_step == 2
    pres = pt.train()
    assert pres["train"]["steps"] == 2
    assert pres["train"]["examples"] == 128
    assert not os.path.exists(orbax_read.params_dir(snap))
    assert not os.path.exists(orbax_read.opt_dir(snap))
    man = jax_read_manifest(snap)
    assert (man["step"], man["format"]) == (4, "dense")
    assert checkpoint.restore_data_state(snap)["epoch"] == 1
    step, w0, table, opt = checkpoint.restore_host(snap, optimizer) if \
        optimizer != "adam" else (*checkpoint.restore_arrays(snap), None)
    assert step == 4
    params = jt.state.params
    np.testing.assert_allclose(table, np.asarray(params.table), **TABLE_TOL)
    np.testing.assert_allclose(w0, np.asarray(params.w0), **W0_TOL)
    sparse = optimizer != "adam"
    if optimizer == "adam":
        opt = checkpoint.restore_opt_state(snap, "adam", device="cpu")
        opt = [t.numpy() for t in opt]
    want = _jax_leaves(optimizer, sparse, jt.state.opt_state)
    assert len(opt) == len(want)
    for got_leaf, want_leaf in zip(opt, want):
        want_leaf = np.asarray(want_leaf)
        if want_leaf.dtype.kind == "i":
            assert got_leaf.dtype == np.int32 and got_leaf == want_leaf == 4
        else:
            np.testing.assert_allclose(got_leaf, want_leaf, **OPT_TOL)


def test_ranks_warm_start_from_the_references_checkpoint(tmp_path):
    """Four ranks of a 2 x 2 mesh (``lookup = shardmap``; each rank reads
    its model shard's rows, ``rows=``) warm-start from the reference's
    Orbax checkpoint and ``data_state.json`` (epoch 1 of 2) and end where
    one process warm-started from the same files ends."""
    from _torch_sharded_worker import run_ranks

    path = str(tmp_path / "train.libsvm")
    _write_lines(path, 512, 512, np.random.default_rng(15))
    base = dict(TRAIN_KW, vocabulary_size=512, train_files=[path],
                epoch_num=2, save_steps=0)
    ref = str(tmp_path / "ref")
    JaxTrainer(JaxFmConfig(model_file=ref, **dict(base, epoch_num=1))
               ).train()
    assert orbax_read.exists(ref)
    mesh_dir, single_dir = str(tmp_path / "mesh"), str(tmp_path / "single")
    shutil.copytree(ref, mesh_dir)
    shutil.copytree(ref, single_dir)
    (tmp_path / "train.json").write_text(json.dumps([dict(
        base, mesh_data=2, mesh_model=2, lookup="shardmap",
        model_file=mesh_dir)]))
    run_ranks("train", 4, tmp_path)
    got = json.loads((tmp_path / "train0_0.json").read_text())
    want = Trainer(FmConfig(**dict(base, model_file=single_dir)),
                   device="cpu").train()
    assert got["train"]["steps"] == want["train"]["steps"] == 8
    with np.load(checkpoint.params_path(mesh_dir)) as a, \
            np.load(checkpoint.params_path(single_dir)) as b:
        assert set(a.files) == set(b.files)
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("fmt", ["orbax", "npz"])
def test_ftrl_warm_start_normalizes_an_edited_table(tmp_path, caplog, fmt):
    """A sparse FTRL checkpoint whose table breaks ``w ==
    ftrl_solve(z, n)`` (rows edited outside training) warm-starts as the
    reference's ``Trainer._check_ftrl_invariant`` leaves it: the table
    replaced by the closed form, with a warning."""
    rng = np.random.default_rng(11)
    vocab = 64
    kw = dict(vocabulary_size=vocab, factor_num=4, optimizer="ftrl",
              learning_rate=0.1, ftrl_l1=0.01, ftrl_l2=0.1, log_steps=0)
    jcfg = JaxFmConfig(**kw)
    params = _random_params(rng, vocab, 5)
    state = jax_sparse.init_sparse_opt_state(jcfg, params)
    state = state._replace(n=jax.tree.map(
        lambda x: x + jnp.asarray(rng.uniform(0, 1, x.shape), jnp.float32),
        state.n))
    table = np.asarray(params.table).copy()
    table[5:9] += 0.02  # off the invariant by 0.02
    edited = params._replace(table=jnp.asarray(table))
    model_file = str(tmp_path / "m")
    if fmt == "orbax":
        jax_checkpoint.save(model_file, 3, edited, state)
        ref_dir = str(tmp_path / "ref")
        shutil.copytree(model_file, ref_dir)
        jt = JaxTrainer(JaxFmConfig(model_file=ref_dir, **kw))
        want = np.asarray(jt.state.params.table)
    else:
        leaves = [np.asarray(x) for x in (state.z.w0, state.z.table,
                                          state.n.w0, state.n.table)]
        checkpoint.save_params(
            model_file, weights.from_jax(np.asarray(edited.w0), table,
                                         device="cpu"), step=3,
            opt_state=SparseFtrlState(*(
                torch.from_numpy(np.array(x)) for x in leaves)))
        want = np.asarray(jax_sparse.sparse_apply.ftrl_solve(
            state.z.table, state.n.table, lr=0.1, l1=0.01, l2=0.1,
            beta=jcfg.ftrl_beta))
    caplog.set_level(logging.WARNING)
    pt = Trainer(FmConfig(model_file=model_file, **kw), device="cpu")
    got = pt.model.table.detach().numpy()
    assert "violate w == ftrl_solve(z, n)" in caplog.text
    np.testing.assert_allclose(got, want, **TABLE_TOL)
    assert np.abs(got[5:9] - table[5:9]).max() > 1e-2


def test_predict_from_an_orbax_checkpoint_matches_the_reference(tmp_path):
    rng = np.random.default_rng(12)
    vocab = 200
    model_file = str(tmp_path / "m")
    jax_checkpoint.save(model_file, 8, jax_fm.FmParams(
        w0=jnp.float32(-0.2), table=jnp.asarray(
            rng.uniform(-0.4, 0.4, (vocab, 5)).astype(np.float32))))
    data = str(tmp_path / "p.libsvm")
    _write_lines(data, 150, vocab, rng)
    kw = dict(vocabulary_size=vocab, factor_num=4, max_features=12,
              batch_size=32, model_file=model_file, predict_files=[data])
    assert predict(FmConfig(**kw, score_path=str(tmp_path / "port.txt")),
                   device="cpu") == 150
    jax_predict(JaxFmConfig(**kw, score_path=str(tmp_path / "ref.txt")))
    got = np.loadtxt(tmp_path / "port.txt")
    want = np.loadtxt(tmp_path / "ref.txt")
    assert got.shape == want.shape == (150,)
    np.testing.assert_allclose(got, want, **SCORE_TOL)


# ----------------------------------------------------------------------
# the formats: exclusion and the serving manifest
# ----------------------------------------------------------------------


def test_both_dense_formats_present_raise(tmp_path):
    model_file = str(tmp_path / "m")
    params = _random_params(np.random.default_rng(13), 32, 5)
    checkpoint.save_params(model_file, weights.from_jax(
        np.asarray(params.w0), np.asarray(params.table), device="cpu"))
    jax_checkpoint.save(model_file, 2, params)  # a JAX save beside it
    cfg = FmConfig(vocabulary_size=32, factor_num=4, model_file=model_file)
    for call in (lambda: checkpoint.exists(model_file),
                 lambda: checkpoint.restore_params(model_file, device="cpu"),
                 lambda: load_model(cfg),
                 lambda: Trainer(cfg, device="cpu")):
        with pytest.raises(ValueError, match="both a params.npz and an "
                                             "Orbax params/"):
            call()


@pytest.mark.parametrize("save", ["save_params", "save_quant",
                                  "save_tiered", "convert_tool"])
def test_port_saves_replace_the_orbax_dirs_and_publish(tmp_path, save):
    """Each port save into a directory holding a JAX-written Orbax
    checkpoint removes its ``params/`` and ``opt/`` and publishes
    ``serve_manifest.json`` with the reference's keys, which the
    reference's ``read_manifest`` reads."""
    rng = np.random.default_rng(14)
    vocab = 64
    params = _random_params(rng, vocab, 5)
    model_file = str(tmp_path / "m")
    jax_checkpoint.save(model_file, 2, params,
                        jax_sparse.SparseAdagradState(acc=params))
    w0, table = np.asarray(params.w0), np.asarray(params.table)
    if save == "save_params":
        checkpoint.save_params(model_file, weights.from_jax(
            w0, table, device="cpu"), step=6)
        want = (6, "dense")
    elif save == "save_quant":
        checkpoint.save_quant(model_file, 6, w0,
                              quant.quantize_table(table, "int8", 16))
        want = (6, "quant")
    elif save == "save_tiered":
        checkpoint.save_tiered(model_file, 6, {"w0": w0}, {"table": {
            "ids": np.arange(3, dtype=np.int64), "rows": table[:3],
            "descriptor": {}}})
        want = (6, "tiered")
    else:
        assert convert_checkpoint.main([model_file, "--to", "bf16",
                                        "--force"]) == 0
        want = (2, "quant")
    assert not os.path.exists(orbax_read.params_dir(model_file))
    assert not os.path.exists(orbax_read.opt_dir(model_file))
    man = jax_read_manifest(model_file)
    assert set(man) == {"step", "format", "published"}
    assert (man["step"], man["format"]) == want
    assert man["published"] <= time.time()


# ----------------------------------------------------------------------
# the committed fixtures
# ----------------------------------------------------------------------


def _fixtures() -> dict:
    with open(os.path.join(FIXTURES, "fixtures.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_fixtures()))
def test_committed_fixtures_match_the_references_restore(name):
    """Each fixture's params and optimizer state are bitwise the
    reference's restore of the same files, the stored scores are the
    reference scorer's, and the port's scorer (plain versions on the
    CPU) is within the scores' tolerance of them."""
    spec = _fixtures()[name]
    kw = spec["cfg"]
    model_file = os.path.join(FIXTURES, name)
    jcfg = JaxFmConfig(model_file=model_file, **kw)
    vocab, dim = jcfg.vocabulary_size, jcfg.embedding_dim
    _assert_params_match(model_file, vocab, dim)
    _assert_params_match(model_file, vocab, dim, rows=slice(7, vocab // 2))
    step, w0, table = _jax_params(model_file, vocab, dim)
    assert step == spec["step"]
    sparse = kw["sparse_update"]
    if name != "fm_sharded":
        params = jax_fm.FmParams(w0=jnp.asarray(w0), table=jnp.asarray(table))
        template = jax.tree.map(_sds, jax.eval_shape(
            _jax_opt_init(kw["optimizer"], sparse), params))
        want = _jax_leaves(kw["optimizer"], sparse,
                           jax_checkpoint.restore_opt(model_file, template))
        got = orbax_read.read_opt(model_file, kw["optimizer"], sparse=sparse)
        assert len(got) == len(want) > 0
        for g, w in zip(got.values(), want):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))
    req = np.load(os.path.join(FIXTURES, f"{name}.npz"))
    fields = req["fields"] if jcfg.field_num else None
    ref = JaxScorer(jcfg, jax_fm.FmParams(w0=w0, table=table))
    np.testing.assert_array_equal(
        np.asarray(ref.score(req["ids"], req["vals"], fields)),
        req["scores"])
    port = make_scorer(FmConfig(model_file=model_file, **kw), device="cpu")
    assert port.step == spec["step"]
    np.testing.assert_allclose(port.score(req["ids"], req["vals"], fields),
                               req["scores"], **SCORE_TOL)
