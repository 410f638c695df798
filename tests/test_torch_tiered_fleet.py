"""The port's rank-sharded tiered table (``train/tiered_fleet.py``,
``tiered_partition = shards``) and the overlapped entries exchange
(``sparse_exchange_overlap``) on the CPU, against the port's dense
trainer and against the JAX package.

The port's ranks are spawned gloo processes (``tests/_torch_sharded_
worker.py``, each with its deadline); the reference runs in this process
on the conftest's 8 virtual CPU devices.

- host-only parity: the port's ``ShardedTiering`` and the reference's on
  one id stream (S = 2 and 4, every shard owned or one owned, eviction
  churn, virtual stores on both sides): remapped ids, each shard's load
  and evict slots and load ids, the capacities, ``gather_logical`` and
  ``export_shard_overlays`` bitwise; ``column_owners``,
  ``filter_overlay_for_shard`` and ``slice_dense_for_shard`` against the
  reference's functions;
- the parity matrix (the reference's ``tests/test_tiered_fleet.py``):
  a ``1 x 2`` fleet run bitwise the port's dense ``1 x 2`` run (loss,
  AUC, w0 and its slots, the merged table and optimizer tables);
- the reference: the ``1 x 2`` fleet against the reference's
  single-device ``tiered_partition = global`` trainer and its own
  ``1 x 2`` ``shards`` run (virtual stores; the sharded-step bounds of
  ``tests/test_torch_sharded.py``);
- checkpoints: shard sets read across packages bitwise, elastic resume
  S = 1 -> 2 -> 1, a partial set refused, a ``kind = "dense"`` set
  served;
- the overlap: ``on`` and ``off`` bitwise on a ``2 x 2`` mesh, and its
  resolution against the reference's ``overlap_active``.
"""

import json
import os
import shutil
import types

import numpy as np
import pytest

import jax
from jax.sharding import Mesh as JaxMesh

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.parallel import mesh as jax_mesh
from fast_tffm_tpu.train import checkpoint as jax_checkpoint
from fast_tffm_tpu.train import sparse as jax_sparse
from fast_tffm_tpu.train import tiered as jax_tiered
from fast_tffm_tpu.train import tiered_fleet as jax_fleet
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.parallel import mesh as mesh_lib
from fast_tffm_tpu_torch.serve import scorer as serve_scorer
from fast_tffm_tpu_torch.train import checkpoint, loop, tiered, tiered_fleet
from fast_tffm_tpu_torch.train.loop import Trainer

from _torch_sharded_worker import run_ranks

V = 2048
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)
ACC_TOL = dict(rtol=1e-4, atol=1e-5)
_STORES = {"adagrad": ("table", "acc"), "ftrl": ("table", "z", "n"),
           "sgd": ("table",)}
_SLOTS = {"adagrad": ("acc_w0",), "ftrl": ("z_w0", "n_w0"), "sgd": ()}


def _write_data(path, rng, lines=512, vocab=V):
    with open(path, "w") as f:
        for i in range(lines):
            f.write(f"{i % 2} {rng.integers(0, vocab)}:1 "
                    f"{rng.integers(0, vocab)}:0.5 "
                    f"{rng.integers(0, vocab)}:0.25\n")


def _kw(tmp_path, model, **kw):
    out = dict(
        vocabulary_size=V, factor_num=4, max_features=4, batch_size=32,
        train_files=[str(tmp_path / "train.libsvm")],
        model_file=str(tmp_path / model), epoch_num=2, log_steps=0,
        thread_num=1, seed=3, steps_per_dispatch=2,
    )
    out.update(kw)
    return out


def _fleet(hot_rows, **kw):
    return dict(table_tiering="on", hot_rows=hot_rows, mesh_model=2, **kw)


def _bitwise(a, b, what=""):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                  err_msg=what)


def _train_ranks(tmp_path, runs, world=2):
    """Train ``runs`` (kwargs dicts) on ``world`` gloo ranks; returns
    ``results[i][rank]``."""
    (tmp_path / "train.json").write_text(json.dumps(runs))
    run_ranks("train", world, tmp_path)
    return [[json.loads((tmp_path / f"train{i}_{r}.json").read_text())
             for r in range(world)] for i in range(len(runs))]


def _logical(model_dir, optimizer, **cfg_kw):
    """``(step, scalars, {store: [V, D]})`` of a checkpoint: params.npz
    as it is, an overlay (either package's file or shard set) gathered
    over every row of its stores."""
    model_dir = str(model_dir)
    if checkpoint.exists(model_dir):
        with np.load(checkpoint.params_path(model_dir)) as z:
            keys = {"table": "params/table", "acc": "opt/acc_table",
                    "z": "opt/z_table", "n": "opt/n_table"}
            return (int(z["scalar/step"]),
                    {k: z[f"opt/{k}"] for k in _SLOTS[optimizer]}
                    | {"w0": z["scalar/w0"]},
                    {n: z[keys[n]] for n in _STORES[optimizer]})
    step, scalars, stores = checkpoint.restore_tiered(model_dir)
    cfg = FmConfig(vocabulary_size=V, factor_num=4, optimizer=optimizer,
                   seed=3, **cfg_kw)
    out = {}
    for name in _STORES[optimizer]:
        if stores[name]["descriptor"]["kind"] == "dense":
            arr = np.empty((V, cfg.embedding_dim), np.float32)
            arr[stores[name]["ids"]] = stores[name]["rows"]
        else:
            store = tiered._virtual_store(cfg, name)
            store.import_overlay(stores[name])
            arr = store.gather(np.arange(V, dtype=np.int64))
        out[name] = arr
    return step, scalars, out


# --------------------------------------------------- host-only parity


def _host_cfgs(s, optimizer="adagrad"):
    kw = dict(vocabulary_size=1024, factor_num=4, optimizer=optimizer,
              table_tiering="on", hot_rows=256, seed=7)
    return FmConfig(**kw), JaxFmConfig(**kw)


def _simulate(fleet, plan, hot, push, step):
    """One dispatch of a shard set's plan on host "device" tables
    ``hot[s]`` (owned shards): the evicted rows to the ledger, the loads
    written, then a step that changes every resident row."""
    for s in sorted(fleet.owned):
        p = plan.shard_plans[s]
        if p.n_evict:
            push(fleet, s, plan.plan_id,
                 tuple(t[p.evict_slots[:p.n_evict]].copy() for t in hot[s]))
    for s in sorted(fleet.owned):
        p = plan.shard_plans[s]
        for t, r in zip(hot[s], p.load_rows):
            t[p.load_slots[:p.n_load]] = r[:p.n_load]
    fleet.note_applied(plan)
    for s in hot:
        for k, t in enumerate(hot[s]):
            t += np.float32(0.001 * (step + 1) * (k + 1))


@pytest.mark.parametrize("shards, owned", [
    (2, (0, 1)), (2, (1,)), (4, (0, 1, 2, 3)), (4, (2,)),
])
def test_sharded_tiering_matches_the_reference_host_only(monkeypatch,
                                                         shards, owned):
    monkeypatch.setattr(tiered, "EXACT_BYTES_MAX", 0)
    monkeypatch.setattr(jax_tiered, "EXACT_BYTES_MAX", 0)
    cfg, jcfg = _host_cfgs(shards)
    port = tiered_fleet.ShardedTiering(cfg, shards, owned, device="cpu")
    ref = jax_fleet.ShardedTiering(jcfg, shards, owned)
    hs, dim = 256 // shards, cfg.embedding_dim
    hot = {side: {s: [np.zeros((hs, dim), np.float32) for _ in port.names]
                  for s in owned} for side in ("port", "ref")}
    rng = np.random.default_rng(shards * 10 + len(owned))
    churn = 0
    for step in range(8):
        ids = rng.integers(0, 1024, (2, 32, 3)).astype(np.int32)
        ids[0, 0, 0] = 1024 + 5  # out of range: the scatter-drop slot
        got_ids, got = port.plan(ids)
        want_ids, want = ref.plan(ids)
        np.testing.assert_array_equal(got_ids, want_ids)
        assert (got.cap_load, got.cap_evict, got.n_load_max,
                got.n_evict_max, got.plan_id) == (
            want.cap_load, want.cap_evict, want.n_load_max,
            want.n_evict_max, want.plan_id)
        for s in range(shards):
            a, b = got.shard_plans[s], want.shard_plans[s]
            assert (a.n_load, a.n_evict) == (b.n_load, b.n_evict)
            np.testing.assert_array_equal(a.load_slots, b.load_slots)
            np.testing.assert_array_equal(a.evict_slots, b.evict_slots)
            np.testing.assert_array_equal(a.load_ids, b.load_ids)
            for ra, rb in zip(a.load_rows, b.load_rows):
                _bitwise(ra, rb, f"load rows of shard {s}")
            churn += a.n_evict
        for ra, rb in zip(port.local_load_blocks(got),
                          ref.local_load_blocks(want)):
            if isinstance(ra, tuple):
                for x, y in zip(ra, rb):
                    _bitwise(x, y, "local load rows")
            else:
                np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(port.local_evict_slots(got),
                                      ref.local_evict_slots(want))
        _simulate(port, got, hot["port"],
                  lambda f, s, pid, rows: f.push_writeback(s, pid, rows),
                  step)
        _simulate(ref, want, hot["ref"],
                  lambda f, s, pid, rows: f.push_writeback(s, pid, rows),
                  step)
    assert churn > 0
    assert port.snapshot() == ref.snapshot()
    exported = {side: f.export_shard_overlays(hot[side])
                for side, f in (("port", port), ("ref", ref))}
    assert sorted(exported["port"]) == sorted(owned)
    for s in owned:
        for name in port.names:
            a, b = exported["port"][s][name], exported["ref"][s][name]
            np.testing.assert_array_equal(a["ids"], b["ids"])
            _bitwise(a["rows"], b["rows"], f"export {s} {name}")
            assert a["descriptor"] == b["descriptor"]
    mine = np.concatenate([np.arange(s * 1024 // shards,
                                     (s + 1) * 1024 // shards)
                           for s in owned])
    _bitwise(port.gather_logical(mine), ref.gather_logical(mine))
    if len(owned) < shards:
        with pytest.raises(RuntimeError, match="live on other ranks"):
            port.gather_logical(np.arange(1024))
        assert not port.dense_save_ok


@pytest.mark.parametrize("data, model", [(1, 1), (1, 2), (1, 4), (2, 1),
                                         (2, 2), (4, 2)])
def test_column_owners_matches_the_reference(data, model):
    """One process per rank, rank r at (r // model, r % model): the
    reference's owners, or its ValueError word for word."""
    procs = np.array([types.SimpleNamespace(process_index=r)
                      for r in range(data * model)]).reshape(data, model)
    try:
        want = jax_fleet.column_owners(types.SimpleNamespace(devices=procs))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tiered_fleet.column_owners(mesh_lib.Mesh(data, model))
        assert str(got.value) == str(e)
        return
    assert tiered_fleet.column_owners(mesh_lib.Mesh(data, model)) == want


@pytest.mark.parametrize("count", [1, 2, 4])
def test_overlay_and_dense_slicing_match_the_reference(count):
    rng = np.random.default_rng(count)
    overlay = {name: {"ids": rng.choice(V, 300, replace=False),
                      "rows": rng.normal(size=(300, 5)).astype(np.float32),
                      "descriptor": {"kind": "uniform", "seed": 3}}
               for name in ("table", "acc")}
    dense = {"table": rng.normal(size=(V, 5)).astype(np.float32)}
    for s in range(count):
        got = tiered_fleet.filter_overlay_for_shard(overlay, s, count, V)
        want = jax_fleet.filter_overlay_for_shard(overlay, s, count, V)
        for name in overlay:
            np.testing.assert_array_equal(got[name]["ids"],
                                          want[name]["ids"])
            _bitwise(got[name]["rows"], want[name]["rows"])
            assert got[name]["descriptor"] == want[name]["descriptor"]
        _bitwise(tiered_fleet.slice_dense_for_shard(dense, s, count)["table"],
                 jax_fleet.slice_dense_for_shard(dense, s, count)["table"])


# ------------------------------------------------------ parity matrix


@pytest.mark.parametrize("optimizer, hot_rows, k", [
    ("adagrad", 512, 2),   # eviction churn
    ("adagrad", V, 2),     # no churn
    ("ftrl", 1024, 2),
    ("adagrad", 512, 1),   # K = 1
    ("ftrl", V, 4),        # K = 4
])
def test_fleet_matches_the_dense_mesh_bitwise(tmp_path, rng, optimizer,
                                              hot_rows, k):
    """Two ranks: the 1 x 2 fleet run and the dense 1 x 2 run from the
    same seed give the same loss, AUC, w0 and slots, and merged tables
    and optimizer tables, bit for bit; each rank wrote its own shard."""
    _write_data(tmp_path / "train.libsvm", rng)
    common = dict(optimizer=optimizer, steps_per_dispatch=k)
    res = _train_ranks(tmp_path, [
        _kw(tmp_path, "dense", mesh_model=2, **common),
        dict(_kw(tmp_path, "fleet", **_fleet(hot_rows), **common),
             _evaluate=[str(tmp_path / "train.libsvm")]),
    ])
    for r in range(2):  # a rank owning one shard of two cannot evaluate
        assert "this rank owns [%d] of 2" % r in res[1][r]["evaluate_error"]
    for r in range(2):
        for m in ("loss", "auc", "examples", "steps"):
            assert res[1][r]["train"][m] == res[0][r]["train"][m], (r, m)
    snaps = [res[1][r]["train"]["tiered"] for r in range(2)]
    assert all(s["num_shards"] == 2 and s["owned_shards"] == 1
               for s in snaps)
    churn = sum(s["rows_evicted"] for s in snaps)
    assert churn > 0 if hot_rows < V else churn == 0
    assert sorted(os.listdir(tmp_path / "fleet")) == [
        "data_state.json", "serve_manifest.json", "tiered.shard0of2.npz",
        "tiered.shard1of2.npz"]
    d_step, d_sc, d_st = _logical(tmp_path / "dense", optimizer)
    f_step, f_sc, f_st = _logical(tmp_path / "fleet", optimizer)
    assert d_step == f_step == res[0][0]["train"]["steps"]
    for name in ("w0",) + _SLOTS[optimizer]:
        _bitwise(f_sc[name], d_sc[name], name)
    for name in _STORES[optimizer]:
        _bitwise(f_st[name], d_st[name], name)
    ds = checkpoint.restore_data_state(str(tmp_path / "fleet"))
    assert ds["epoch"] == 2 and ds["batches_done"] == 0


def test_fleet_warm_starts_from_a_dense_checkpoint(tmp_path, rng):
    """A one-device dense run's params.npz (with its accumulators)
    warm-starts the 1 x 2 fleet and the dense 1 x 2 mesh alike: each
    rank's cold store is its slice of the restored table, and the two
    runs continue bitwise equal."""
    _write_data(tmp_path / "train.libsvm", rng)
    Trainer(FmConfig(**_kw(tmp_path, "seed", epoch_num=1)),
            device="cpu").train()
    for model in ("dense", "fleet"):
        shutil.copytree(tmp_path / "seed", tmp_path / model)
    res = _train_ranks(tmp_path, [
        _kw(tmp_path, "dense", mesh_model=2, epoch_num=3),
        _kw(tmp_path, "fleet", **_fleet(512), epoch_num=3),
    ])
    # The seed run's position (epoch 1, same stream) resumes: epochs 1-2.
    assert res[1][0]["train"]["steps"] == 32
    assert res[1][0]["train"]["loss"] == res[0][0]["train"]["loss"]
    d_step, d_sc, d_st = _logical(tmp_path / "dense", "adagrad")
    f_step, f_sc, f_st = _logical(tmp_path / "fleet", "adagrad")
    assert d_step == f_step == 16 + 32
    for name in ("w0", "acc_w0"):
        _bitwise(f_sc[name], d_sc[name], name)
    for name in ("table", "acc"):
        _bitwise(f_st[name], d_st[name], name)


@pytest.mark.parametrize("kw, match", [
    (dict(hot_rows=768), "whole number of 256-row tiles"),
    (dict(hot_rows=81), "divisible by the mesh model size"),
    (dict(hot_rows=512, mesh_data=2), "column 0 spans processes"),
    (dict(hot_rows=512, tiered_partition="global"), "single-process"),
    (dict(hot_rows=512, validation_files=["v"]), "owns 1 of 2 shards"),
])
def test_fleet_geometry_refusals(kw, match):
    """The fleet's refusals, as this rank of two would meet them: the
    reference's ValueErrors and the port's own tile limit on H / R."""
    cfg = FmConfig(**dict(dict(vocabulary_size=V, factor_num=4,
                               table_tiering="on", mesh_model=2), **kw))
    with pytest.raises(ValueError, match=match):
        dcfg, _ = loop._tiered_device_config(cfg)
        loop._check_mesh(cfg, dcfg, mesh_lib.Mesh(cfg.mesh_data, 2),
                         True)


# ------------------------------------------------------ the reference


def test_fleet_against_the_reference_global_and_shards(tmp_path, rng,
                                                       monkeypatch):
    """Virtual cold stores on both sides (the same hash init): the
    port's 1 x 2 fleet and the reference's single-device global tiered
    run train the same logical table within the sharded step's bounds;
    the reference's own 1 x 2 shards run trains as many steps; the
    port's shard set and the reference's read bitwise in either package.

    The reference's shards run is not a fixed point to hold the port
    to: run after run on the same input it ends in one of two tables
    (13 and 11 of 24 runs under the full suite's load), one within
    1e-8 of the port's and of its own global run, the other up to
    1.5e-3 away in a tenth of the table.  The port's fleet and the
    reference's global run were bitwise the same in all 24."""
    monkeypatch.setattr(jax_tiered, "EXACT_BYTES_MAX", 0)
    _write_data(tmp_path / "train.libsvm", rng)
    res = _train_ranks(tmp_path, [dict(
        _kw(tmp_path, "fleet", **_fleet(512)), _exact_bytes_max=0)])
    ref = {}
    for name, extra in (("global", dict(tiered_partition="global")),
                        ("shards", dict(tiered_partition="shards",
                                        mesh_model=2))):
        kw = _kw(tmp_path, f"ref_{name}", table_tiering="on", hot_rows=512,
                 **extra)
        ref[name] = JaxTrainer(JaxFmConfig(**kw)).train()
    assert os.path.exists(tmp_path / "ref_shards" / "tiered.shard1of2.npz")
    got = _logical(tmp_path / "fleet", "adagrad")
    want = _logical(tmp_path / "ref_global", "adagrad")
    assert got[0] == want[0]
    np.testing.assert_allclose(res[0][0]["train"]["loss"],
                               ref["global"]["train"]["loss"], **SCORE_TOL)
    np.testing.assert_allclose(got[2]["table"], want[2]["table"],
                               **TABLE_TOL)
    np.testing.assert_allclose(got[2]["acc"], want[2]["acc"], **ACC_TOL)
    np.testing.assert_allclose(got[1]["w0"], want[1]["w0"], **SCORE_TOL)
    assert got[0] == _logical(tmp_path / "ref_shards", "adagrad")[0]
    # Shard sets across packages, bit for bit.
    for model in ("fleet", "ref_shards"):
        a = checkpoint.restore_tiered(str(tmp_path / model))
        b = jax_checkpoint.restore_tiered(str(tmp_path / model))
        assert a[0] == b[0] and sorted(a[1]) == sorted(b[1])
        for k in a[1]:
            _bitwise(a[1][k], b[1][k], k)
        for name in a[2]:
            np.testing.assert_array_equal(a[2][name]["ids"],
                                          b[2][name]["ids"])
            _bitwise(a[2][name]["rows"], b[2][name]["rows"], name)
            assert a[2][name]["descriptor"] == b[2][name]["descriptor"]


# ------------------------------------------------------ checkpoints


def test_elastic_resume_reshards_bitwise(tmp_path, rng, monkeypatch):
    """S = 1 -> 2 -> 1 (virtual stores): a one-device shard save restores
    as two shards with every saved row bitwise and trains on two ranks,
    whose two files restore as one shard with their rows bitwise; a
    partial set is refused."""
    monkeypatch.setattr(tiered, "EXACT_BYTES_MAX", 0)
    _write_data(tmp_path / "train.libsvm", rng)
    kw = _kw(tmp_path, "m", table_tiering="on", hot_rows=512,
             tiered_partition="shards", epoch_num=1)
    t1 = Trainer(FmConfig(**kw), device="cpu")
    assert isinstance(t1.tiered, tiered_fleet.ShardedTiering)
    assert t1.fleet == loop._Fleet(1, (0,))
    t1.train()
    assert os.listdir(tmp_path / "m").count("tiered.shard0of1.npz") == 1
    step1, sc1, stores1 = checkpoint.restore_tiered(str(tmp_path / "m"))
    ids, rows = stores1["table"]["ids"], stores1["table"]["rows"]
    assert step1 == 16 and len(ids)  # 512 lines in batches of 32
    # Each rank of S = 2 cuts the overlay to its own shard.
    cfg2 = FmConfig(**dict(kw, mesh_model=2))
    for s in (0, 1):
        fleet = tiered_fleet.ShardedTiering(cfg2, 2, (s,), overlay=stores1,
                                            device="cpu")
        mine = ids // (V // 2) == s
        _bitwise(fleet.gather_logical(ids[mine]), rows[mine])
    res = _train_ranks(tmp_path, [dict(kw, mesh_model=2,
                                       _exact_bytes_max=0)])
    assert res[0][0]["train"]["steps"] == 16
    assert np.isfinite(res[0][0]["train"]["loss"])
    step2, _, stores2 = checkpoint.restore_tiered(str(tmp_path / "m"))
    assert step2 == 32
    assert not os.path.exists(tmp_path / "m" / "tiered.shard0of1.npz")
    t3 = Trainer(FmConfig(**kw), device="cpu")
    assert t3._restored_step == 32
    _bitwise(t3.tiered.gather_logical(stores2["table"]["ids"]),
             stores2["table"]["rows"])
    assert t3.train()["train"]["steps"] == 16
    # A torn set: the shard file of another count is a mixed set, a
    # missing shard a partial one.
    shutil.copy(tmp_path / "m" / "tiered.shard0of1.npz",
                tmp_path / "m" / "tiered.shard0of2.npz")
    with pytest.raises(ValueError, match="mixes shard counts"):
        Trainer(FmConfig(**kw), device="cpu")
    os.remove(tmp_path / "m" / "tiered.shard0of1.npz")
    with pytest.raises(ValueError, match="missing shards"):
        Trainer(FmConfig(**kw), device="cpu")


def test_dense_shard_set_is_served_and_predicted(tmp_path, rng):
    """An exact (``kind = "dense"``) shard set of a 1 x 2 fleet scores
    as the dense 1 x 2 run's params.npz does, through ``make_scorer``
    and ``predict``; a set missing rows is refused."""
    _write_data(tmp_path / "train.libsvm", rng)
    _train_ranks(tmp_path, [_kw(tmp_path, "dense", mesh_model=2),
                            _kw(tmp_path, "fleet", **_fleet(512))])
    _, _, stores = checkpoint.restore_tiered(str(tmp_path / "fleet"))
    assert stores["table"]["descriptor"]["kind"] == "dense"
    ids = rng.integers(0, V, (64, 4)).astype(np.int32)
    vals = rng.uniform(0.1, 1, (64, 4)).astype(np.float32)
    scores, files = {}, {}
    for model in ("dense", "fleet"):
        cfg = FmConfig(**_kw(tmp_path, model, predict_files=[
            str(tmp_path / "train.libsvm")],
            score_path=str(tmp_path / f"{model}.txt")))
        sc = serve_scorer.make_scorer(cfg, device="cpu")
        assert isinstance(sc, serve_scorer.OverlayScorer) == (
            model == "fleet")
        scores[model] = sc.score(ids, vals)
        assert loop.predict(cfg, device="cpu") == 512
        files[model] = np.loadtxt(cfg.score_path)
    np.testing.assert_allclose(scores["fleet"], scores["dense"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(files["fleet"], files["dense"], rtol=1e-5,
                               atol=1e-6)
    partial = dict(stores["table"], ids=stores["table"]["ids"][1:],
                   rows=stores["table"]["rows"][1:])
    with pytest.raises(ValueError, match="every row once"):
        serve_scorer._dense_overlay_store(FmConfig(vocabulary_size=V,
                                                   factor_num=4), partial)


# ------------------------------------------------------ the overlap


def test_overlap_on_and_off_are_bitwise_equal(tmp_path, rng):
    """A 2 x 2 mesh with the entries exchange: the id plane gathered a
    step ahead gives the parameters and metrics of the inline gather,
    bit for bit (FTRL, K = 2 and an epoch tail)."""
    _write_data(tmp_path / "train.libsvm", rng, lines=480, vocab=1024)
    common = dict(vocabulary_size=1024, mesh_data=2, mesh_model=2,
                  sparse_exchange="entries", optimizer="ftrl",
                  steps_per_dispatch=2)
    res = _train_ranks(tmp_path, [
        _kw(tmp_path, "off", sparse_exchange_overlap="off", **common),
        _kw(tmp_path, "on", sparse_exchange_overlap="on", **common),
    ], world=4)
    for r in range(4):
        for m in ("loss", "auc", "examples", "weight_sum", "steps"):
            assert res[1][r]["train"][m] == res[0][r]["train"][m], (r, m)
    with np.load(checkpoint.params_path(str(tmp_path / "on"))) as a, \
            np.load(checkpoint.params_path(str(tmp_path / "off"))) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# (data, model, sparse_exchange, lookup, optimizer, sparse_apply)
_OVERLAP_CASES = [
    (2, 2, "entries", "auto", "adagrad", "auto"),
    (2, 2, "auto", "auto", "ftrl", "auto"),
    (2, 2, "dense", "auto", "adagrad", "auto"),
    (4, 1, "auto", "auto", "sgd", "auto"),
    (1, 4, "entries", "auto", "adagrad", "auto"),
    (1, 1, "auto", "auto", "adagrad", "auto"),
    (2, 2, "entries", "auto", "adagrad", "scatter"),
    (2, 2, "entries", "shardmap", "adagrad", "auto"),
    (1, 1, "auto", "shardmap", "adagrad", "auto"),
    (1, 1, "auto", "auto", "adam", "auto"),
]


def _jax_mesh(data, model):
    devs = np.array(jax.devices()[:data * model]).reshape(data, model)
    return JaxMesh(devs, (jax_mesh.DATA_AXIS, jax_mesh.MODEL_AXIS))


def _reference_overlap(jcfg, data, model, monkeypatch):
    """The reference's resolution (``Trainer.__init__`` then
    ``sparse.overlap_active``) where its kernels run, as the port's
    always do."""
    import fast_tffm_tpu.platform as jax_platform

    monkeypatch.setattr(jax_platform, "is_tpu_backend", lambda: True)
    mesh = _jax_mesh(data, model)
    sparse = jcfg.sparse_update and jax_sparse.supports_sparse(jcfg)
    if jcfg.sparse_exchange_overlap == "off":
        return False
    if not sparse or (jcfg.lookup == "shardmap" and mesh.size > 1):
        if jcfg.sparse_exchange_overlap == "on":
            raise ValueError("requires the sparse gather/apply step")
        return False
    return jax_sparse.overlap_active(jcfg, mesh)


@pytest.mark.parametrize("overlap", ["auto", "on", "off"])
@pytest.mark.parametrize("case", _OVERLAP_CASES)
def test_overlap_resolves_as_the_reference(case, overlap, monkeypatch):
    data, model, exchange, lookup, optimizer, apply = case
    if overlap == "on" and exchange == "dense":
        return  # the config itself refuses it, in both packages
    kw = dict(vocabulary_size=2048, batch_size=256, max_features=8,
              mesh_data=data, mesh_model=model, sparse_exchange=exchange,
              lookup=lookup, optimizer=optimizer, sparse_apply=apply,
              sparse_exchange_overlap=overlap)
    cfg, jcfg = FmConfig(**kw), JaxFmConfig(**kw)
    port_sparse = loop._sparse(cfg)
    mesh = mesh_lib.Mesh(data, model)
    try:
        want = _reference_overlap(jcfg, data, model, monkeypatch)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            loop._check_mesh(cfg, cfg, mesh, port_sparse)
        assert str(e).split(" (got")[0] in str(got.value)
        return
    assert loop._check_mesh(cfg, cfg, mesh, port_sparse) == want
