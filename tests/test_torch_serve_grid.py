"""The port's scorer grid vs the JAX package's mesh scorer on the CPU.

The reference scores over ``make_mesh(cfg)``: ``mesh_data x mesh_model``
devices, the table's rows split over ``model`` and copied over
``data``, the int8 scales copied whole, the overlay's compact table
copied to every device, the batch split over ``data`` and every rung
rounded up to a multiple of the ``data`` size.  Here it runs on the
conftest's virtual CPU devices; the port runs the same grid over the CPU
repeated (``devices=["cpu"] * n``), on the same tables and the same
seeded requests.

Tolerances: against the reference, the scorer's ``rtol=1e-5,
atol=1e-6`` (``tests/test_pallas_ops.py``); bf16 and int8 tables
against fp32 within ``tests/test_quant.py``'s bounds; every port grid
against the port's one-device scorer bitwise.
"""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from fast_tffm_tpu import obs as jax_obs
from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.ops import quant as jax_quant
from fast_tffm_tpu.parallel import mesh as jax_mesh
from fast_tffm_tpu.serve import scorer as jax_scorer_lib
from fast_tffm_tpu.train import checkpoint as jax_checkpoint
from fast_tffm_tpu.train import tiered as jax_tiered
from fast_tffm_tpu.train.loop import predict as jax_predict
from fast_tffm_tpu_torch import cli, weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models import fm
from fast_tffm_tpu_torch.obs.telemetry import Telemetry
from fast_tffm_tpu_torch.parallel.mesh import DeviceGrid
from fast_tffm_tpu_torch.platform import resolve_devices
from fast_tffm_tpu_torch.serve import scorer as scorer_lib
from fast_tffm_tpu_torch.serve import wire
from fast_tffm_tpu_torch.serve.batcher import ServeBatcher
from fast_tffm_tpu_torch.serve.server import serve
from fast_tffm_tpu_torch.train.loop import predict

SERVE_TOL = dict(rtol=1e-5, atol=1e-6)
SERVE_BOUND = {"bf16": 5e-3, "int8": 2e-2}
V, F, K, P = 256, 4, 4, 3
CHUNK = 24  # divides no shard's rows (256, 128, 64 or 32 of them)
LADDER = "6,20,64"  # 6 and 20 round up on 4- and 8-row grids
GRIDS = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (8, 1)]


def _kw(field_num=0, grid=(1, 1), **kw):
    out = dict(vocabulary_size=V, factor_num=K, max_features=F,
               field_num=field_num, serve_batch_sizes=LADDER,
               quant_chunk=CHUNK, serve_poll_secs=0.0,
               max_batch_wait_ms=1.0, mesh_data=grid[0], mesh_model=grid[1])
    out.update(kw)
    return out


def _cpus(grid):
    return ["cpu"] * (grid[0] * grid[1])


def _mesh(grid, cfg):
    """The reference's mesh of exactly ``grid``'s devices."""
    return jax_mesh.make_mesh(cfg, jax.devices()[:grid[0] * grid[1]])


def _table(seed=0, dim=1 + K):
    """An f32 table at the reference tolerance test's magnitudes, with
    rows ten times larger in one chunk (a chunk's scale matters)."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.5, 0.5, (V, dim)).astype(np.float32)
    table[100:130] *= 10.0
    return table


def _examples(n, seed=1, field_num=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (n, F)).astype(np.int32)
    vals = rng.uniform(0.1, 1.5, (n, F)).astype(np.float32)
    vals[::3, -1] = 0.0
    fields = (rng.integers(0, field_num, (n, F)).astype(np.int32)
              if field_num else None)
    return ids, vals, fields


def _bitwise(a, b):
    return a.dtype == b.dtype and np.array_equal(
        np.asarray(a).view(np.uint32), np.asarray(b).view(np.uint32))


SIZES = (1, 5, 19, 64, 150)  # every rung, and a request the ladder splits


# ----------------------------------------------------------------- the grid


@pytest.mark.parametrize("want, n", [
    ((1, 1), 1), ((1, 1), 4), ((2, 2), 4), ((2, 2), 8), ((3, 1), 8),
    ((1, 4), 4), ((4, 4), 8), ((1, 2), 1), ((2, 1), 1),
])
def test_device_grid_follows_make_mesh(want, n):
    """The shape (1 x 1 with several devices: all on ``data``) and the
    refusal of a grid larger than the devices, word for word."""
    kw = dict(mesh_data=want[0], mesh_model=want[1])
    try:
        ref = jax_mesh.make_mesh(JaxFmConfig(**kw), jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            DeviceGrid(FmConfig(**kw), ["cpu"] * n)
        assert str(got.value) == str(e)
        return
    grid = DeviceGrid(FmConfig(**kw), ["cpu"] * n)
    assert (grid.data, grid.model) == tuple(ref.devices.shape)
    assert {"data": grid.data, "model": grid.model} == dict(ref.shape)
    assert len(grid.flat()) == grid.size == ref.devices.size


@pytest.mark.parametrize("grid", [(2, 2), (1, 4), (8, 1), (1, 8)])
def test_row_ranges_are_the_reference_shards(grid):
    """Model shard ``j``'s rows are the rows the reference's
    ``param_sharding`` gives the devices of column ``j``."""
    mesh = _mesh(grid, JaxFmConfig(mesh_data=grid[0], mesh_model=grid[1]))
    index = NamedSharding(mesh, PartitionSpec(jax_mesh.MODEL_AXIS, None)
                          ).devices_indices_map((V, 1 + K))
    ranges = DeviceGrid(FmConfig(mesh_data=grid[0], mesh_model=grid[1]),
                        _cpus(grid)).row_ranges(V)
    for i in range(grid[0]):
        for j in range(grid[1]):
            rows = index[mesh.devices[i, j]][0]
            assert (rows.start or 0, rows.stop or V) == ranges[j]


def test_a_vocabulary_the_model_axis_does_not_divide_is_refused():
    kw = _kw(grid=(1, 4), vocabulary_size=30)
    table = np.zeros((30, 1 + K), np.float32)
    with pytest.raises(ValueError, match="divisible by 4"):
        jax_scorer_lib.FixedShapeScorer(
            JaxFmConfig(**kw), jax_fm.FmParams(w0=np.float32(0), table=table),
            mesh=_mesh((1, 4), JaxFmConfig(**kw)))
    with pytest.raises(ValueError, match="divisible by 4"):
        scorer_lib.FixedShapeScorer(
            FmConfig(**kw), weights.from_jax(0.0, table, device="cpu"),
            devices=_cpus((1, 4)))


def test_devices_resolve_as_asked_and_never_fall_back():
    assert resolve_devices("cpu") == [torch.device("cpu")]
    assert resolve_devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    grid = DeviceGrid(FmConfig(), "cpu")
    assert grid.size == 1 and grid.first.type == "cpu"
    assert grid.describe() == "cpu"
    if not torch.cuda.is_available():
        for asked in (None, "cuda", "cuda:0", ["cuda:0", "cuda:0"]):
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                resolve_devices(asked)
    with pytest.raises(ValueError, match="give device or devices"):
        scorer_lib._grid_devices("cpu", ["cpu"])


@pytest.mark.parametrize("entry", ["scorer", "make_scorer", "predict",
                                   "serve", "cli"])
def test_a_grid_larger_than_the_devices_raises(tmp_path, entry):
    """``--device cpu`` is one device: a 2 x 1 config cannot become a
    grid there, and no entry point falls back to a smaller one."""
    model_file = str(tmp_path / "m")
    weights_model = weights.from_jax(0.0, _table(), device="cpu")
    from fast_tffm_tpu_torch.train import checkpoint

    checkpoint.save_params(model_file, weights_model)
    (tmp_path / "p.libsvm").write_text("1 3:1 4:0.5\n0 7:1\n")
    kw = _kw(grid=(2, 1), model_file=model_file,
             predict_files=[str(tmp_path / "p.libsvm")],
             score_path=str(tmp_path / "s.txt"))
    cfg = FmConfig(**kw)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        if entry == "scorer":
            scorer_lib.FixedShapeScorer(cfg, weights_model, device="cpu")
        elif entry == "make_scorer":
            scorer_lib.make_scorer(cfg, device="cpu")
        elif entry == "predict":
            predict(cfg, device="cpu")
        elif entry == "serve":
            serve(cfg, device="cpu", port=0)
        else:
            (tmp_path / "c.cfg").write_text(
                f"[General]\nvocabulary_size = {V}\nfactor_num = {K}\n"
                f"model_file = {model_file}\n[Predict]\npredict_files = "
                f"{tmp_path}/p.libsvm\nscore_path = {tmp_path}/s.txt\n"
                f"[Tpu]\nmax_features = {F}\nmesh_data = 2\n")
            cli.main(["predict", str(tmp_path / "c.cfg"), "--device", "cpu"])
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 3"):
        DeviceGrid(FmConfig(mesh_data=2, mesh_model=2), ["cpu"] * 3)


# ------------------------------------------------------------- the ladder


@pytest.mark.parametrize("data", [1, 2, 3, 4, 8])
def test_ladder_rounds_up_as_the_reference(data):
    """Rungs (and predict's extra rung) round up to a multiple of the
    ``data`` size; ``rung_for`` and ``slots_for`` follow, and so does
    the batcher's grouping."""
    kw = _kw(grid=(data, 1))
    table = _table()
    port = scorer_lib.FixedShapeScorer(
        FmConfig(**kw), weights.from_jax(0.0, table, device="cpu"),
        devices=["cpu"] * data, extra_rungs=(50,))
    ref = jax_scorer_lib.FixedShapeScorer(
        JaxFmConfig(**kw), jax_fm.FmParams(w0=np.float32(0), table=table),
        mesh=_mesh((data, 1), JaxFmConfig(**kw)), extra_rungs=(50,))
    assert port.ladder == ref.ladder
    assert all(b % data == 0 for b in port.ladder)
    for n in range(1, 200, 7):
        assert port.rung_for(n) == ref.rung_for(n)
        assert port.slots_for(n) == ref.slots_for(n)
    batcher = ServeBatcher(port, max_batch_wait_ms=1.0)
    try:
        ids, vals, _ = _examples(23)
        np.testing.assert_array_equal(batcher.score(ids, vals),
                                      port.score(ids, vals))
    finally:
        batcher.close()


# ------------------------------------------------------------- dense tables


def _scorers(grid, dtype, table, field_num=0, pre_quantized=False,
             telemetry=None, jax_telemetry=None):
    """The port's scorer on ``grid`` of repeated CPUs, the port's one-CPU
    scorer and the reference's on the same mesh, on one table."""
    kw = _kw(field_num, grid, serve_table_dtype=dtype)
    w0 = np.float32(-0.1)
    if pre_quantized:
        ref_qt = jax_quant.quantize_table(table, dtype, CHUNK)
        port_model = (w0, weights.quant_from_jax(ref_qt))
        ref_model = (w0, ref_qt)
    else:
        port_model = weights.from_jax(w0, table, device="cpu")
        ref_model = jax_fm.FmParams(w0=jnp.asarray(w0),
                                    table=jnp.asarray(table))
    port = scorer_lib.FixedShapeScorer(FmConfig(**kw), port_model,
                                       devices=_cpus(grid),
                                       telemetry=telemetry)
    one = scorer_lib.FixedShapeScorer(FmConfig(**_kw(
        field_num, serve_table_dtype=dtype)), port_model, device="cpu")
    ref = jax_scorer_lib.FixedShapeScorer(
        JaxFmConfig(**kw), ref_model, mesh=_mesh(grid, JaxFmConfig(**kw)),
        telemetry=jax_telemetry)
    return port, one, ref


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_scores_bitwise_one_device_and_as_the_reference(grid, dtype):
    table = _table(2)
    tel, jax_tel = Telemetry(), jax_obs.Telemetry()
    port, one, ref = _scorers(grid, dtype, table, telemetry=tel,
                              jax_telemetry=jax_tel)
    assert (port.grid.data, port.grid.model) == grid
    assert port.warmup() == len(port.ladder)
    fp32 = None if dtype == "fp32" else _scorers((1, 1), "fp32", table)[1]
    for n in SIZES:
        ids, vals, _ = _examples(n, seed=n)
        got = port.score(ids, vals)
        assert _bitwise(got, one.score(ids, vals)), n
        np.testing.assert_allclose(got, ref.score(ids, vals), **SERVE_TOL)
        if fp32 is not None:
            assert np.abs(got - fp32.score(ids, vals)).max() <= \
                SERVE_BOUND[dtype]
    g, jg = tel.snapshot()["gauges"], jax_tel.snapshot()["gauges"]
    # The whole table's bytes, whatever the grid.
    assert g["serve.table_bytes"] == jg["serve.table_bytes"]
    placed = port._model
    assert len(placed.w0) == len(placed.shards) == grid[0]
    for row in placed.shards:
        assert [t.shape[0] for t in row] == [V // grid[1]] * grid[1]
    if dtype == "int8":
        assert all(s.shape[0] == -(-V // CHUNK)
                   for row in placed.scales for s in row)
    else:
        assert placed.scales is None


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
@pytest.mark.parametrize("grid", [(2, 2), (1, 4)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_ffm_grid_scores_bitwise_one_device_and_as_the_reference(grid,
                                                                  dtype):
    table = _table(3, dim=1 + P * K)
    port, one, ref = _scorers(grid, dtype, table, field_num=P)
    for n in (7, 150):
        ids, vals, fields = _examples(n, seed=n, field_num=P)
        got = port.score(ids, vals, fields)
        assert _bitwise(got, one.score(ids, vals, fields))
        np.testing.assert_allclose(got, ref.score(ids, vals, fields),
                                   **SERVE_TOL)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quant_npz_serves_on_a_grid(tmp_path, dtype):
    """A ``quant.npz`` through ``make_scorer`` on a 2 x 2 grid: bitwise
    the one-device scorer, within tolerance of the reference's
    ``make_scorer`` on its 2 x 2 mesh."""
    table = _table(4)
    model_file = str(tmp_path / "q")
    jax_checkpoint.save_quant(model_file, 5, np.float32(0.2),
                              jax_quant.quantize_table(table, dtype, CHUNK))
    kw = _kw(grid=(2, 2), model_file=model_file, serve_table_dtype=dtype)
    port = scorer_lib.make_scorer(FmConfig(**kw), devices=_cpus((2, 2)))
    one = scorer_lib.make_scorer(FmConfig(**dict(kw, mesh_data=1,
                                                 mesh_model=1)),
                                 device="cpu")
    ref = jax_scorer_lib.make_scorer(JaxFmConfig(**kw), mesh=_mesh(
        (2, 2), JaxFmConfig(**kw)))
    assert port.step == one.step == ref.step == 5
    for n in (3, 100):
        ids, vals, _ = _examples(n, seed=40 + n)
        got = port.score(ids, vals)
        assert _bitwise(got, one.score(ids, vals))
        np.testing.assert_allclose(got, ref.score(ids, vals), **SERVE_TOL)


def test_gather_dequant_reads_scales_by_the_global_row():
    """On a shard holding rows ``[lo, hi)``, the codes are indexed by the
    local row and the scales by the global one."""
    table = _table(5)
    qt = jax_quant.quantize_table(table, "int8", CHUNK)
    codes = torch.from_numpy(np.asarray(qt.codes))
    scales = torch.from_numpy(np.asarray(qt.scales, np.float32))
    ids = torch.tensor([130, 191, 128, 160], dtype=torch.int32)
    whole = fm.gather_dequant(codes, scales, CHUNK, ids)
    local = fm.gather_dequant(codes[128:192], scales, CHUNK, ids - 128, ids)
    assert torch.equal(whole, local)
    np.testing.assert_array_equal(
        whole.numpy(), jax_quant.dequantize_rows(qt, ids.numpy()))


# ---------------------------------------------------------------- the overlay


def _overlay(model_file, kw, shards=None):
    """A reference-written ``tiered.npz`` (or, with ``shards``, a set of
    that many ``tiered.shard{s}of{S}.npz``) of written rows over the
    hash init."""
    cfg = JaxFmConfig(**kw)
    rng = np.random.default_rng(8)
    payloads = []
    for s in range(shards or 1):
        store = jax_tiered._virtual_store(cfg, "table")
        ids = rng.choice(V, 60, replace=False)
        store.scatter(ids, rng.normal(0, 0.3, (60, cfg.embedding_dim))
                      .astype(np.float32))
        payloads.append({"table": {**store.export(),
                                   "descriptor": store.descriptor}})
    if shards is None:
        jax_checkpoint.save_tiered(model_file, 6, {"w0": np.float32(-0.2)},
                                   payloads[0])
        return
    for s, payload in enumerate(payloads):
        jax_checkpoint.save_tiered_shards(
            model_file, 6, {"w0": np.float32(-0.2)}, {s: payload}, shards,
            primary=False)


@pytest.mark.parametrize("shards", [None, 2], ids=["tiered", "shard_set"])
@pytest.mark.parametrize("grid", [(2, 1), (2, 2), (8, 1)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_overlay_scores_on_a_grid(tmp_path, grid, shards):
    kw = _kw(grid=grid, model_file=str(tmp_path / "m"), table_tiering="on",
             cold_dtype="bf16", seed=3)
    _overlay(kw["model_file"], kw, shards)
    port = scorer_lib.make_scorer(FmConfig(**kw), devices=_cpus(grid))
    one = scorer_lib.make_scorer(FmConfig(**dict(kw, mesh_data=1,
                                                 mesh_model=1)),
                                 device="cpu")
    ref = jax_scorer_lib.make_scorer(JaxFmConfig(**kw),
                                     mesh=_mesh(grid, JaxFmConfig(**kw)))
    assert isinstance(port, scorer_lib.OverlayScorer)
    assert port.ladder == ref.ladder
    for n in SIZES:
        ids, vals, _ = _examples(n, seed=60 + n)
        got = port.score(ids, vals)
        assert _bitwise(got, one.score(ids, vals))
        np.testing.assert_allclose(got, ref.score(ids, vals), **SERVE_TOL)
    # One compact table a data block, the same host buffer on the CPU.
    for host, _, devs in port._staging.values():
        assert len(devs) == grid[0] and all(d is host for d in devs)


# ------------------------------------------------- hot swap, predict, serve


def test_keep_prev_swap_rollback_and_promote_on_a_grid():
    """``keep_prev`` keeps the whole grid's old tables: the swapped,
    rolled-back and promoted scores are each bitwise a one-device
    scorer's of the table served."""
    grid = (2, 2)
    t1, t2, t3 = _table(6), _table(7), _table(8)
    kw = _kw(grid=grid, serve_table_dtype="int8")
    port = scorer_lib.FixedShapeScorer(
        FmConfig(**kw), weights.from_jax(0.1, t1, device="cpu"),
        devices=_cpus(grid), step=1)

    def one(table):
        return scorer_lib.FixedShapeScorer(
            FmConfig(**dict(kw, mesh_data=1, mesh_model=1)),
            weights.from_jax(0.1, table, device="cpu"), device="cpu")

    ids, vals, _ = _examples(90, seed=9)
    want = {n: one(t).score(ids, vals) for n, t in ((1, t1), (2, t2),
                                                     (3, t3))}
    assert _bitwise(port.score(ids, vals), want[1])
    port.swap(weights.from_jax(0.1, t2, device="cpu"), step=2,
              keep_prev=True)
    assert port.step == 2 and _bitwise(port.score(ids, vals), want[2])
    assert port.rollback() and port.step == 1
    assert _bitwise(port.score(ids, vals), want[1])
    assert not port.rollback()
    port.swap(weights.from_jax(0.1, t3, device="cpu"), step=3,
              keep_prev=True)
    port.promote()
    assert not port.rollback() and port.step == 3
    assert _bitwise(port.score(ids, vals), want[3])


def _reference_dense(model_file, table, w0=0.125, step=9):
    jax_checkpoint.save(model_file, step, jax_fm.FmParams(
        w0=jnp.asarray(np.float32(w0)), table=jnp.asarray(table)))


def _write_libsvm(path, n, seed=3):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            feats = " ".join(f"{rng.integers(0, V)}:{rng.uniform(0.1, 1):.3f}"
                             for _ in range(3))
            f.write(f"{i % 2} {feats}\n")


@pytest.mark.parametrize("grid", [(2, 2), (1, 4), (8, 1)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_predict_on_a_grid(tmp_path, grid):
    """The predict file on a grid is the one-device file byte for byte,
    and the reference predict's on its mesh; ``batch_size`` 30 is a rung
    rounded as the ladder's."""
    model_file = str(tmp_path / "m")
    _reference_dense(model_file, _table(10))
    _write_libsvm(tmp_path / "p.libsvm", 150, seed=21)
    kw = _kw(grid=grid, model_file=model_file, batch_size=30,
             predict_files=[str(tmp_path / "p.libsvm")])
    assert predict(FmConfig(**kw, score_path=str(tmp_path / "grid.txt")),
                   devices=_cpus(grid)) == 150
    assert predict(FmConfig(**dict(kw, mesh_data=1, mesh_model=1),
                            score_path=str(tmp_path / "one.txt")),
                   device="cpu") == 150
    jcfg = JaxFmConfig(**kw, score_path=str(tmp_path / "ref.txt"))
    jax_predict(jcfg, mesh=_mesh(grid, jcfg))
    assert (tmp_path / "grid.txt").read_bytes() == \
        (tmp_path / "one.txt").read_bytes()
    np.testing.assert_allclose(np.loadtxt(tmp_path / "grid.txt"),
                               np.loadtxt(tmp_path / "ref.txt"), atol=2e-6)


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read()


def test_http_serve_on_a_2x2_grid(tmp_path):
    """``serve()`` on a 2 x 2 grid answers ``/score_bin`` bitwise the
    one-device scorer and within tolerance of the reference's mesh
    scorer; ``/status`` names every device and keeps the whole table's
    bytes; a ``keep_prev`` reload and ``/rollback`` restore the old
    scores bitwise."""
    from fast_tffm_tpu_torch.train import checkpoint

    grid = (2, 2)
    model_file = str(tmp_path / "m")
    t1, t2 = _table(11), _table(12)
    checkpoint.save_params(model_file, weights.from_jax(0.1, t1,
                                                        device="cpu"),
                           step=3)
    kw = _kw(grid=grid, model_file=model_file)
    cfg = FmConfig(**kw)
    ref = jax_scorer_lib.FixedShapeScorer(
        JaxFmConfig(**kw), jax_fm.FmParams(w0=np.float32(0.1), table=t1),
        mesh=_mesh(grid, JaxFmConfig(**kw)))
    one = scorer_lib.make_scorer(FmConfig(**dict(kw, mesh_data=1,
                                                 mesh_model=1)),
                                 device="cpu")
    handle = serve(cfg, devices=_cpus(grid), port=0)
    try:
        assert (handle.scorer.grid.data, handle.scorer.grid.model) == grid
        ids, vals, _ = _examples(77, seed=12)
        got = wire.decode_bin_response(_post(
            handle.port, "/score_bin", wire.encode_bin_request(ids, vals)))
        assert _bitwise(got, one.score(ids, vals))
        np.testing.assert_allclose(got, ref.score(ids, vals), **SERVE_TOL)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{handle.port}/status", timeout=30) as r:
            status = json.loads(r.read())["serve"]
        assert status["device"] == "2x2: " + ", ".join(["cpu (cpu)"] * 4)
        assert status["table_mb"] == round(V * (1 + K) * 4 / (1 << 20), 3)
        checkpoint.save_params(model_file, weights.from_jax(0.1, t2,
                                                            device="cpu"),
                               step=8)
        assert json.loads(_post(handle.port, "/reload?keep_prev=1",
                                b""))["step"] == 8
        new = wire.decode_bin_response(_post(
            handle.port, "/score_bin", wire.encode_bin_request(ids, vals)))
        assert not np.array_equal(new, got)
        assert json.loads(_post(handle.port, "/rollback", b""))["step"] == 3
        back = wire.decode_bin_response(_post(
            handle.port, "/score_bin", wire.encode_bin_request(ids, vals)))
        assert _bitwise(back, got)
    finally:
        handle.close()
