"""The port's tiered trainer (``table_tiering = on``) on the CPU, against
the port's dense trainer and against the reference's tiered trainer, at
the reference's test size (V = 256, F = 4, B = 32, K = 2, 2 epochs:
``tests/test_tiered_table.py``).  The port's kernels take their plain
versions here.

- parity: the tiered run's merged logical table, optimizer tables, w0,
  loss, AUC and validation are bitwise the dense run's from the same
  seed (Adagrad, FTRL, SGD; ``hot_rows = V`` and 160, which evicts;
  K = 1; bf16 compute; FFM; mid-run saves), as the reference pins its
  own tiered run to its dense one;
- the reference: from the reference's initial table, the port's merged
  table and loss track the reference's tiered trainer within the
  tile-vs-scatter bounds (``rtol=1e-4, atol=1e-6``; accumulator
  ``atol=1e-4``, ``tests/test_sparse_apply.py``);
- mechanics: ``plan``'s remap and out-of-range contract, LRU never
  evicting the current super-batch, ``cancel_waits``, the refusals;
- resume across tier layouts (dense, tiered at two ``hot_rows``, dense
  again), mid-epoch too;
- the virtual cold store (``EXACT_BYTES_MAX`` forced to 0): ``tiered.npz``
  round-trips, restores across packages both ways, refuses another
  init, and virtual validation equals scoring by hand.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.train import tiered as jax_tiered
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch import cli, weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.data.pipeline import BatchPipeline
from fast_tffm_tpu_torch.models import fm
from fast_tffm_tpu_torch.train import checkpoint, sparse, tiered
from fast_tffm_tpu_torch.train.loop import MetricState, Trainer

V = 256
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
OPT_TOL = dict(rtol=1e-4, atol=1e-4)


def _write_data(path, rng, lines=256, vocab=V, field_num=0):
    def tok(j):
        f = f"{j % field_num}:" if field_num else ""
        return f"{f}{rng.integers(0, vocab)}"

    with open(path, "w") as f:
        for i in range(lines):
            f.write(f"{i % 2} {tok(0)}:1 {tok(1)}:0.5 {tok(2)}:0.25\n")


def _kw(tmp_path, model, **kw):
    out = dict(
        vocabulary_size=V, factor_num=4, max_features=4, batch_size=32,
        train_files=[str(tmp_path / "train.libsvm")],
        model_file=str(tmp_path / model),
        epoch_num=2, log_steps=0, thread_num=1, seed=3,
        steps_per_dispatch=2,
    )
    out.update(kw)
    return out


def _cfg(tmp_path, model, **kw):
    return FmConfig(**_kw(tmp_path, model, **kw))


def _tier(hot_rows, **kw):
    return dict(table_tiering="on", hot_rows=hot_rows, **kw)


def _run(cfg):
    t = Trainer(cfg, device="cpu")
    return t, t.train()


def _merged(t):
    return t.tiered.merged_dense(t._hot_host_tables())


def _dense_state(t):
    return [t.model.table.detach().numpy(),
            *[x.numpy() for x in sparse.opt_tables(t.opt_state)]]


def _w0s(t):
    return [t.model.w0.detach().numpy()] + [
        x.numpy() for x in t.opt_state if x.dim() == 0]


def _bitwise(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32))


# ------------------------------------------------------------- parity


@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl", "sgd"])
@pytest.mark.parametrize("hot_rows", [V, 160])
def test_tiered_matches_dense_bitwise(tmp_path, rng, optimizer, hot_rows):
    """Tiered == dense from the same seed: the merged logical table and
    optimizer tables, w0 and its optimizer slots, loss and AUC, bitwise,
    with (hot_rows < V evicts) and without evictions."""
    _write_data(tmp_path / "train.libsvm", rng)
    d, rd = _run(_cfg(tmp_path, "dense", optimizer=optimizer))
    t, rt = _run(_cfg(tmp_path, "tiered", optimizer=optimizer,
                      **_tier(hot_rows)))
    assert rt["train"]["loss"] == rd["train"]["loss"]
    assert rt["train"]["auc"] == rd["train"]["auc"]
    for a, b in zip(_merged(t), _dense_state(d)):
        _bitwise(a, b)
    for a, b in zip(_w0s(t), _w0s(d)):
        _bitwise(a, b)
    snap = rt["train"]["tiered"]
    if hot_rows < V:
        assert snap["rows_evicted"] > 0 and snap["writeback_rows"] > 0
    else:
        assert snap["rows_evicted"] == 0
    assert snap["hit_occurrences"] + snap["miss_occurrences"] == 2 * 256 * 4
    assert 0.0 < snap["hot_hit_frac"] < 1.0
    assert rt["train"]["eager_dispatches"] == rt["train"]["dispatches"]
    # The save is the merged dense params.npz, equal to the dense run's.
    assert checkpoint.exists(t.cfg.model_file)
    assert not checkpoint.exists_tiered(t.cfg.model_file)
    with np.load(checkpoint.params_path(t.cfg.model_file)) as a, \
            np.load(checkpoint.params_path(d.cfg.model_file)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            _bitwise(a[k].astype(np.float32), b[k].astype(np.float32))


@pytest.mark.parametrize("case", [
    dict(steps_per_dispatch=1),
    dict(compute_dtype="bfloat16"),
    dict(field_num=2, optimizer="ftrl"),
    dict(save_steps=4),
])
def test_tiered_matches_dense_bitwise_across_modes(tmp_path, rng, case):
    """K = 1, bf16 compute, field-aware FM and mid-run saves (a merge
    while plans are in flight) at hot_rows = 160, with validation: the
    merged tables, w0, loss, AUC and validation metrics bitwise the
    dense run's."""
    field_num = case.get("field_num", 0)
    _write_data(tmp_path / "train.libsvm", rng, field_num=field_num)
    _write_data(tmp_path / "valid.libsvm", np.random.default_rng(9),
                lines=64, field_num=field_num)
    kw = dict(case, validation_files=[str(tmp_path / "valid.libsvm")])
    d, rd = _run(_cfg(tmp_path, "dense", **kw))
    t, rt = _run(_cfg(tmp_path, "tiered", **_tier(160), **kw))
    for key in ("loss", "auc"):
        assert rt["train"][key] == rd["train"][key], key
        assert rt["validation"][key] == rd["validation"][key], key
    for a, b in zip(_merged(t), _dense_state(d)):
        _bitwise(a, b)
    for a, b in zip(_w0s(t), _w0s(d)):
        _bitwise(a, b)
    assert rt["train"]["tiered"]["rows_evicted"] > 0


def test_prestacked_cache_is_remapped_through_the_fill(tmp_path, rng):
    """With ``cache_prestacked`` a tiered run takes each packed group's
    batches through the plan and the ordinary fill (the cache's buffers
    hold logical ids and are never written): every dispatch is a fill,
    none a prestack hit, and the result is bitwise the dense prestacked
    run's, whose dispatches after epoch 0 are all prestack hits."""
    from fast_tffm_tpu_torch.data.prefetch import DevicePrefetcher

    _write_data(tmp_path / "train.libsvm", rng)
    kw = dict(epoch_num=3, cache_epochs=True, cache_prestacked=True)
    counts = {}
    runs = {}
    for name, extra in (("dense", {}), ("tiered", _tier(160))):
        DevicePrefetcher.fills = DevicePrefetcher.prestack_hits = 0
        runs[name] = _run(_cfg(tmp_path, name, **kw, **extra))
        counts[name] = (DevicePrefetcher.fills,
                        DevicePrefetcher.prestack_hits)
    (d, rd), (t, rt) = runs["dense"], runs["tiered"]
    assert rd["train"]["ingest_cache"] == rt["train"]["ingest_cache"] == (
        "cached")
    assert counts["tiered"] == (rt["train"]["dispatches"], 0)
    assert counts["dense"][1] == rd["train"]["dispatches"] > 0
    assert rt["train"]["loss"] == rd["train"]["loss"]
    for a, b in zip(_merged(t), _dense_state(d)):
        _bitwise(a, b)


# ------------------------------------------------------- the reference


@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl"])
def test_tiered_tracks_the_reference_tiered_trainer(tmp_path, rng,
                                                    optimizer):
    """The reference's tiered trainer runs fresh; the port's warm-starts
    from a params.npz of the reference's initial logical table.  At
    hot_rows = 160 (evictions in both) the merged tables and the loss
    agree within the tile-vs-scatter bounds, the counters exactly."""
    _write_data(tmp_path / "train.libsvm", rng)
    kw = _kw(tmp_path, "jax", optimizer=optimizer, **_tier(160))
    jt = JaxTrainer(JaxFmConfig(sparse_apply="scatter", **kw))
    init = jt.tiered.stores[0].to_dense().copy()
    jres = jt.train()
    port_dir = str(tmp_path / "port")
    checkpoint.save_params(port_dir, weights.from_jax(0.0, init,
                                                      device="cpu"))
    t, pres = _run(FmConfig(**dict(kw, model_file=port_dir)))
    assert pres["train"]["steps"] == jres["train"]["steps"] == 16
    np.testing.assert_allclose(pres["train"]["loss"], jres["train"]["loss"],
                               **TABLE_TOL)
    for key in ("hit_occurrences", "miss_occurrences", "rows_loaded",
                "rows_evicted", "writeback_rows", "resident_rows"):
        assert pres["train"]["tiered"][key] == jres["train"]["tiered"][key]
    want = jt.tiered.merged_dense(jt._hot_host_tables())
    got = _merged(t)
    np.testing.assert_allclose(got[0], want[0], **TABLE_TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **OPT_TOL)
    np.testing.assert_allclose(float(t.model.w0.detach()),
                               float(jt.state.params.w0), **TABLE_TOL)


# ------------------------------------------------------------- mechanics


def _manager(**kw):
    return tiered.TieredTable(FmConfig(**dict(
        dict(vocabulary_size=64, factor_num=2, max_features=4,
             table_tiering="on", hot_rows=32), **kw)), device="cpu")


def test_plan_remap_and_oor_contract():
    """``plan``: the remap is a bijection on present ids (id 0 too), an
    out-of-range id given straight to ``plan`` maps to hot_rows, and the
    plan and counters agree with the reference's on the same ids."""
    ids = np.array([[0, 5, 9, 5], [70, 9, 0, 63]], np.int32)  # 70 OOR
    man = _manager()
    new_ids, plan = man.plan(ids)
    ref = jax_tiered.TieredTable(JaxFmConfig(
        vocabulary_size=64, factor_num=2, max_features=4,
        table_tiering="on", hot_rows=32))
    ref_ids, ref_plan = ref.plan(ids)
    np.testing.assert_array_equal(new_ids, ref_ids)
    assert new_ids[1, 0] == 32
    m = {}
    for lg, sl in zip(ids.reshape(-1), new_ids.reshape(-1)):
        if lg < 64:
            assert m.setdefault(int(lg), int(sl)) == int(sl)
    assert len(set(m.values())) == len(m) == plan.n_load
    np.testing.assert_array_equal(plan.load_slots, ref_plan.load_slots)
    np.testing.assert_array_equal(plan.load_ids, ref_plan.load_ids)
    assert (plan.n_load, plan.n_evict) == (ref_plan.n_load, ref_plan.n_evict)
    assert man.snapshot()["oor_occurrences"] == 1
    assert man.snapshot()["resident_rows"] == len(m)
    assert man.health_view()["emb_rows_touched"] == len(m)


def test_plan_lru_never_evicts_current_superbatch():
    """Eviction takes least-recently-used slots, never one the current
    super-batch (or this plan's fresh loads) holds; a re-fetch of an
    evicted id is served from the write-back ledger once the rows are
    handed over."""
    man = _manager(max_features=2, hot_rows=8)
    dim = man.dim
    _, p1 = man.plan(np.arange(0, 6, dtype=np.int32).reshape(1, -1))
    assert p1.n_evict == 0
    _, p2 = man.plan(np.arange(6, 10, dtype=np.int32).reshape(1, -1))
    assert p2.n_load == 4 and p2.n_evict == 2
    resident = {int(i) for i in man.id_of_slot if i >= 0}
    assert {6, 7, 8, 9} <= resident and len(resident) == 8
    evicted = {0, 1, 2, 3, 4, 5} - resident
    assert len(evicted) == 2
    rows = tuple(torch.full((tiered._bucket(p2.n_evict), dim), 7.5)
                 for _ in man.names)
    man.push_writeback(p2.plan_id, rows)
    _, p3 = man.plan(np.array([[sorted(evicted)[0], 6]], np.int32))
    assert p3.n_load == 1
    np.testing.assert_array_equal(p3.load_rows[0][0],
                                  np.full(dim, 7.5, np.float32))


def test_cancel_waits_releases_blocked_writeback_wait():
    """A transfer thread blocked on a write-back fill that will never
    come is released by ``cancel_waits`` with the reference's error;
    ``reopen`` re-arms the manager."""
    man = _manager(max_features=2, hot_rows=8)
    man.plan(np.arange(0, 6, dtype=np.int32).reshape(1, -1))
    _, p2 = man.plan(np.arange(6, 10, dtype=np.int32).reshape(1, -1))
    assert p2.n_evict == 2
    evicted = sorted({0, 1, 2, 3, 4, 5}
                     - {int(i) for i in man.id_of_slot if i >= 0})
    outcome = []

    def refetch():
        try:
            man.plan(np.array([[evicted[0], 6]], np.int32))
            outcome.append("returned")
        except RuntimeError as e:
            outcome.append(str(e))

    worker = threading.Thread(target=refetch, daemon=True)
    worker.start()
    time.sleep(0.2)
    assert worker.is_alive()
    man.cancel_waits()
    worker.join(timeout=5)
    assert not worker.is_alive()
    assert outcome and "wait cancelled" in outcome[0]
    man.reopen()
    assert man._cancelled is False


def test_hot_rows_too_small_raises(tmp_path, rng):
    """A super-batch whose unique ids outgrow the hot table fails with
    the reference's error, through the transfer stage."""
    _write_data(tmp_path / "train.libsvm", rng)
    t = Trainer(_cfg(tmp_path, "m", **_tier(16)), device="cpu")
    with pytest.raises(RuntimeError, match="is smaller than one "
                       "super-batch's unique id count"):
        t.train()


@pytest.mark.parametrize("kw, err, match", [
    (dict(optimizer="adam"), ValueError, "sparse update path"),
    (dict(sparse_update=False), ValueError, "sparse update path"),
    (dict(lookup="shardmap"), ValueError, "does not compose with "
     "lookup=shardmap"),
    (dict(tiered_partition="shards"), NotImplementedError, "item 3"),
    (dict(mesh_data=2), NotImplementedError, "item 3"),
])
def test_tiering_refusals(tmp_path, kw, err, match):
    with pytest.raises(err, match=match):
        Trainer(_cfg(tmp_path, "m", **_tier(160), **kw), device="cpu")


def test_tiered_trainer_refuses_a_quant_checkpoint_and_train_step(
        tmp_path, rng):
    _write_data(tmp_path / "train.libsvm", rng)
    t, _ = _run(_cfg(tmp_path, "m", epoch_num=1, **_tier(160)))
    with pytest.raises(ValueError, match="planned and migrated"):
        t.train_step(None)
    from fast_tffm_tpu_torch.tools import convert_checkpoint

    convert_checkpoint.main([t.cfg.model_file, "--to", "int8", "--force"])
    with pytest.raises(ValueError, match="convert_checkpoint"):
        Trainer(_cfg(tmp_path, "m", **_tier(160)), device="cpu")


def test_cli_trains_tiered_on_the_cpu(tmp_path, rng, capsys):
    """``cli train <cfg> --device cpu --table_tiering on --hot_rows 160``
    trains and writes the params.npz the dense CLI run writes."""
    _write_data(tmp_path / "train.libsvm", rng)
    paths = {}
    for name, extra in (("dense", []),
                        ("tiered", ["--table_tiering", "on",
                                    "--hot_rows", "160"])):
        cfg_path = tmp_path / f"{name}.cfg"
        cfg_path.write_text(
            "[General]\nvocabulary_size = 256\nfactor_num = 4\n"
            "max_features = 4\nbatch_size = 32\n"
            f"model_file = {tmp_path / name}\n"
            "[Train]\n"
            f"train_files = {tmp_path / 'train.libsvm'}\n"
            "epoch_num = 2\nlog_steps = 0\nthread_num = 1\nseed = 3\n")
        assert cli.main(["train", str(cfg_path), "--device", "cpu"]
                        + extra) == 0
        paths[name] = checkpoint.params_path(str(tmp_path / name))
    assert "train logloss=" in capsys.readouterr().out
    with np.load(paths["dense"]) as a, np.load(paths["tiered"]) as b:
        _bitwise(a["params/table"], b["params/table"])
        _bitwise(a["opt/acc_table"], b["opt/acc_table"])


# ------------------------------------------------------------- resume


@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl"])
def test_resume_across_tier_layout_change(tmp_path, rng, optimizer):
    """Checkpoints are tier-layout-independent: dense -> tiered(192) ->
    tiered(160) -> tiered(V) -> dense warm starts land on the all-dense
    chain's params bitwise (each run on a completed checkpoint trains
    ``epoch_num`` fresh epochs)."""
    _write_data(tmp_path / "train.libsvm", rng)

    def chain(model, layouts):
        for layout in layouts:
            kw = dict(optimizer=optimizer, epoch_num=1)
            if layout is not None:
                kw.update(_tier(layout))
            t, _ = _run(_cfg(tmp_path, model, **kw))
        return t

    d = chain("all_dense", [None] * 5)
    t = chain("mixed", [None, 192, 160, V, None])
    assert t.tiered is None
    for model in ("all_dense", "mixed"):
        step, _ = checkpoint.restore_params(str(tmp_path / model),
                                            device="cpu")
        assert step == 40  # 5 chained 1-epoch runs, 8 steps each
    for a, b in zip(_dense_state(t), _dense_state(d)):
        _bitwise(a, b)
    for a, b in zip(_w0s(t), _w0s(d)):
        _bitwise(a, b)


def test_tiered_mid_epoch_resume_matches_dense(tmp_path, rng):
    """A mid-epoch position resumed under another tier layout retrains
    the same remaining batches as the dense resume."""
    _write_data(tmp_path / "train.libsvm", rng)
    out = {}
    for model, kw1, kw2 in (("dense", {}, {}),
                            ("tiered", _tier(192), _tier(160))):
        cfg1 = _cfg(tmp_path, model, epoch_num=1, **kw1)
        _run(cfg1)
        ds = checkpoint.restore_data_state(cfg1.model_file)
        ds.update(epoch=0, batches_done=4)
        with open(checkpoint.data_state_path(cfg1.model_file), "w") as f:
            json.dump(ds, f)
        t2 = Trainer(_cfg(tmp_path, model, epoch_num=1, **kw2),
                     device="cpu")
        assert t2._restored_step == 8
        assert t2.train()["train"]["steps"] == 4
        out[model] = np.load(checkpoint.params_path(cfg1.model_file))
    assert int(out["tiered"]["scalar/step"]) == 12
    for k in out["dense"].files:
        _bitwise(out["tiered"][k].astype(np.float32),
                 out["dense"][k].astype(np.float32))


# ------------------------------------------------------------- virtual


@pytest.fixture
def virtual(monkeypatch):
    """Both packages' cold stores forced virtual at a tiny vocabulary."""
    monkeypatch.setattr(tiered, "EXACT_BYTES_MAX", 0)
    monkeypatch.setattr(jax_tiered, "EXACT_BYTES_MAX", 0)


@pytest.mark.parametrize("cold_dtype", ["fp32", "int8"])
def test_overlay_checkpoint_roundtrip(tmp_path, rng, virtual, cold_dtype):
    """A virtual run saves ``tiered.npz`` (removing any params.npz) with
    ``data_state.json``; a resume at another hot_rows continues from it,
    and the two-run chain replays bitwise."""
    _write_data(tmp_path / "train.libsvm", rng)
    tier = dict(cold_dtype=cold_dtype)
    for model in ("m", "m2"):
        cfg1 = _cfg(tmp_path, model, epoch_num=1, **_tier(192, **tier))
        _run(cfg1)
        assert checkpoint.exists_tiered(cfg1.model_file)
        assert not checkpoint.exists(cfg1.model_file)
        step, scalars, stores = checkpoint.restore_tiered(cfg1.model_file)
        assert step == 8 and "w0" in scalars and "acc_w0" in scalars
        assert len(stores["table"]["ids"]) > 0
        assert checkpoint.restore_data_state(cfg1.model_file)["epoch"] == 1
        t2 = Trainer(_cfg(tmp_path, model, epoch_num=1,
                          **_tier(160, **tier)), device="cpu")
        assert t2._restored_step == 8
        assert t2.train()["train"]["steps"] == 8
    a = checkpoint.restore_tiered(str(tmp_path / "m"))
    b = checkpoint.restore_tiered(str(tmp_path / "m2"))
    for name in ("table", "acc"):
        np.testing.assert_array_equal(a[2][name]["ids"], b[2][name]["ids"])
        np.testing.assert_array_equal(a[2][name]["rows"],
                                      b[2][name]["rows"])


@pytest.mark.parametrize("optimizer", ["adagrad", "ftrl"])
def test_overlay_restores_across_packages(tmp_path, rng, virtual,
                                          optimizer):
    """The port's tiered.npz restores in the reference's trainer and the
    reference's in the port's: every logical row of every store and w0
    bitwise what the writer's trainer held when it saved."""
    _write_data(tmp_path / "train.libsvm", rng)
    kw = dict(optimizer=optimizer, epoch_num=1, **_tier(192))
    port_w, _ = _run(_cfg(tmp_path, "port", **kw))
    jax_w = JaxTrainer(JaxFmConfig(sparse_apply="scatter",
                                   **_kw(tmp_path, "jax", **kw)))
    jax_w.train()
    every = np.arange(V, dtype=np.int64)
    port_r = Trainer(_cfg(tmp_path, "jax", **kw), device="cpu")
    jax_r = JaxTrainer(JaxFmConfig(sparse_apply="scatter",
                                   **_kw(tmp_path, "port", **kw)))
    assert port_r._restored_step == jax_r._restored_step == 8
    for writer, reader in ((port_w, jax_r), (jax_w, port_r)):
        assert writer.tiered.names == reader.tiered.names
        for ws, rs in zip(writer.tiered.stores, reader.tiered.stores):
            _bitwise(rs.gather(every), ws.gather(every))
    _bitwise(port_w.model.w0.detach().numpy(),
             np.asarray(jax_r.state.params.w0))
    _bitwise(np.asarray(jax_w.state.params.w0),
             port_r.model.w0.detach().numpy())


def test_overlay_descriptor_mismatch_raises(tmp_path, rng, virtual):
    """An overlay saved under another seed refuses to load: its rows
    never written would regenerate differently."""
    _write_data(tmp_path / "train.libsvm", rng)
    _run(_cfg(tmp_path, "m", epoch_num=1, **_tier(192)))
    with pytest.raises(ValueError, match="different init"):
        Trainer(_cfg(tmp_path, "m", epoch_num=1, seed=99, **_tier(192)),
                device="cpu")
    with pytest.raises(ValueError, match="tiered overlay"):
        Trainer(_cfg(tmp_path, "m", epoch_num=1), device="cpu")


def test_virtual_validation_matches_manual_scoring(tmp_path, rng, virtual):
    """Virtual evaluation scores each batch against a compact table of
    its unique rows: the result equals scoring the stream against the
    whole logical table rebuilt from the synced cold store."""
    _write_data(tmp_path / "train.libsvm", rng)
    _write_data(tmp_path / "valid.libsvm", np.random.default_rng(9),
                lines=64)
    cfg = _cfg(tmp_path, "m", validation_files=[
        str(tmp_path / "valid.libsvm")], **_tier(192))
    t, r = _run(cfg)
    assert not t.tiered.dense_save_ok
    t.tiered.sync_from_device(t._hot_host_tables())
    table = t.tiered.gather_logical(np.arange(V, dtype=np.int64))
    model = fm.FmModel(t.model.w0.detach(), torch.from_numpy(table))
    ms = MetricState.zeros("cpu")
    with BatchPipeline(cfg.validation_files, cfg, epochs=1,
                       shuffle=False) as p:
        for batch in p:
            b = sparse.to_device(batch, "cpu")
            ms.add_(fm.fm_scores(model, b.ids, b.vals, b.fields,
                                 factor_num=cfg.factor_num), b,
                    cfg.loss_type)
    want = ms.finalize(cfg.loss_type)
    assert r["validation"]["loss"] == want["loss"]
    assert r["validation"]["auc"] == want["auc"]
