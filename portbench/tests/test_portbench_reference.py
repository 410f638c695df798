"""The plain reference against the port on the CPU: the batches it works
out from the lines and the seed, and one training step."""

import dataclasses

import numpy as np
import pytest
import torch

from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.data.libsvm import Batch
from fast_tffm_tpu_torch.data.pipeline import BatchPipeline
from fast_tffm_tpu_torch.models import fm
from fast_tffm_tpu_torch.train import sparse
from portbench import check, gen, run
from portbench.reference import fm as ref_fm


def _cell_cfg(tmp_path, cell, sections, n_lines, seed):
    spec = run.load_cell(cell)
    lines = gen.make_lines(spec["config"]["schema"], spec["traffic"],
                           n_lines, seed)
    data = str(tmp_path / "train.libsvm")
    lines.write(data)
    secs = run.cfg_sections(spec["config"]["cfg"], spec["traffic"]["cfg"],
                            sections)
    path = tmp_path / "cell.cfg"
    import configparser
    parser = configparser.ConfigParser()
    parser.read_dict(secs)
    with open(path, "w") as f:
        parser.write(f)
    flat = {k.lower(): v for keys in secs.values() for k, v in keys.items()}
    cfg = load_config(str(path), {"train_files": [data], "seed": seed})
    return lines, flat, cfg, data


@pytest.mark.parametrize("cell", ["criteo_kaggle.cached_zipf",
                                  "avazu.cached_zipf"])
def test_batches_are_the_pipelines(tmp_path, cell):
    """Several 4 MiB reads and windows: the reference's epochs (0
    streamed, 1 replayed from the cache in its shuffled order) are the
    port's pipeline's batches, id for id."""
    seed = 2**31 + 41
    lines, flat, cfg, data = _cell_cfg(
        tmp_path, cell, {"General": {"vocabulary_size": "65536"},
                         "Train": {"batch_size": "512",
                                   "shuffle_buffer": "2000",
                                   "thread_num": "2"}}, 24 * 512, seed)
    assert lines.text.nbytes > 4 << 20
    bs, mf = 512, int(flat["max_features"])
    ids = np.stack([(ref_fm.murmur64a(k) % np.uint64(65536)).astype(np.int64)
                    for k in lines.keys], axis=1)
    windows = ref_fm.raw_windows(
        np.full(len(lines.labels), lines.text.shape[1]), bs, 2000)
    assert len(windows) >= 2
    epoch0 = ref_fm.epoch_batches(windows, bs, seed, 0)
    want = ref_fm.dispatch_batches(epoch0, 1, seed, 2, False)
    cfg = dataclasses.replace(cfg, cache_epochs=True, cache_prestacked=False)
    with BatchPipeline([data], cfg, epochs=2, shuffle=True,
                       cache_epochs=True) as pipe:
        got = [b for b in pipe]
    assert len(got) == len(want) == 48
    for batch, (idx,) in zip(got, want):
        exp = np.zeros((bs, mf), np.int64)
        exp[:, :ids.shape[1]] = ids[idx]
        assert np.array_equal(batch.ids, exp)
        assert np.array_equal(batch.labels, lines.labels[idx])


@pytest.mark.parametrize("cell", ["criteo_kaggle.cached_zipf",
                                  "avazu.cached_zipf"])
def test_reference_step_is_the_ports_cpu_step(tmp_path, cell):
    """Three steps of the port's sparse step (its plain versions, on the
    CPU) from the seeded table, against the reference's, on batches with
    repeated ids, padding slots and a weight-0 row."""
    seed = 2**31 + 3
    lines, flat, cfg, _ = _cell_cfg(
        tmp_path, cell, {"General": {"vocabulary_size": "512"},
                         "Train": {"batch_size": "32"}}, 96, seed)
    bs, mf = 32, int(flat["max_features"])
    ids = np.stack([(ref_fm.murmur64a(k) % np.uint64(512)).astype(np.int64)
                    for k in lines.keys], axis=1)
    vals = np.stack(lines.vals, axis=1)
    ref = ref_fm.FmReference(flat, "cpu")
    ref.init(seed)
    gen_t = torch.Generator(device="cpu").manual_seed(seed)
    model = fm.init_params(cfg, gen_t, device="cpu")
    opt = sparse.init_sparse_opt_state(cfg, model)
    assert torch.equal(model.table, ref.table)
    for step in range(3):
        idx = np.arange(step * bs, (step + 1) * bs)[: bs - (step == 2)]
        b_ids, b_vals, b_labels, b_w = check.batches_of(
            ids, vals, lines.labels, [idx], bs, mf, "cpu")[0]
        batch = Batch(b_labels, b_ids.int(), b_vals,
                      torch.zeros_like(b_ids, dtype=torch.int32), b_w)
        scores = sparse.sparse_step(cfg, model, opt, batch, plain=True,
                                    impl="jnp")
        per = fm.example_losses(scores, b_labels, "logistic")
        loss = float((per * b_w).sum() / b_w.sum())
        assert loss == pytest.approx(ref.step(b_ids, b_vals, b_labels, b_w),
                                     rel=1e-6)
        torch.testing.assert_close(model.table, ref.table, rtol=1e-5,
                                   atol=1e-7)
        torch.testing.assert_close(opt.acc_table, ref.acc, rtol=1e-5,
                                   atol=1e-9)
        torch.testing.assert_close(model.w0, ref.w0, rtol=1e-5, atol=1e-8)
