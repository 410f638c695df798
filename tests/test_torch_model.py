"""The port's model core, weight hand-over and params.npz checkpoint vs
the JAX package, on the CPU at small sizes.  Parameters cross packages
as numpy arrays (``weights.from_jax``); tolerance ``rtol=1e-5,
atol=1e-6`` as in tests/test_pallas_ops.py (f32 accumulation, another
summation order)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig
from fast_tffm_tpu_torch.models import fm
from fast_tffm_tpu_torch.train import checkpoint

TOL = dict(rtol=1e-5, atol=1e-6)
V, F, K = 97, 6, 4


def _params(seed=0):
    rng = np.random.default_rng(seed)
    w0 = np.float32(0.25)
    table = (rng.uniform(-0.5, 0.5, (V, 1 + K))).astype(np.float32)
    return w0, table


def _batch(b, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (b, F)).astype(np.int32)
    vals = rng.uniform(0.1, 2.0, (b, F)).astype(np.float32)
    vals[:, -2:] = 0.0
    ids[:, -2:] = 0
    return ids, vals


@pytest.mark.parametrize("b", [1, 13])
def test_fm_scores_match_jax(b):
    w0, table = _params()
    ids, vals = _batch(b)
    want = jax_fm.fm_scores(
        jax_fm.FmParams(w0=jnp.asarray(w0), table=jnp.asarray(table)),
        jnp.asarray(ids), jnp.asarray(vals), factor_num=K,
    )
    model = weights.from_jax(w0, table, device="cpu")
    got = fm.fm_scores(model, torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    fwd = model(torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_array_equal(fwd.detach().numpy(), got.detach().numpy())


def test_interaction_terms_match_jax():
    w0, table = _params()
    ids, vals = _batch(9)
    rows = table[ids]
    want = jax_fm.interaction_terms(jnp.asarray(rows), jnp.asarray(vals))
    got = fm.interaction_terms(torch.from_numpy(rows),
                               torch.from_numpy(vals))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    want_s = jax_fm.scores_from_terms(jnp.float32(w0), *want)
    got_s = fm.scores_from_terms(torch.tensor(w0), *got)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    via_rows = fm.scores_from_rows(torch.tensor(w0), torch.from_numpy(rows),
                                   torch.from_numpy(vals))
    np.testing.assert_allclose(via_rows.numpy(), np.asarray(want_s), **TOL)


def test_init_params_range_and_seed():
    cfg = FmConfig(vocabulary_size=V, factor_num=K, init_value_range=0.05)
    a = fm.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    b = fm.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    c = fm.init_params(cfg, torch.Generator().manual_seed(8), device="cpu")
    assert tuple(a.table.shape) == (V, cfg.embedding_dim)
    assert a.table.dtype == torch.float32 and float(a.w0.detach()) == 0.0
    assert float(a.table.detach().abs().max()) <= 0.05
    assert torch.equal(a.table, b.table)
    assert not torch.equal(a.table, c.table)


def test_weights_round_trip_bitwise():
    w0, table = _params(3)
    back_w0, back_table = weights.to_numpy(
        weights.from_jax(w0, table, device="cpu")
    )
    assert back_w0.dtype == np.float32 and back_w0 == w0
    np.testing.assert_array_equal(back_table, table)


def test_params_npz_round_trip(tmp_path):
    w0, table = _params(5)
    model = weights.from_jax(w0, table, device="cpu")
    path = checkpoint.save_params(str(tmp_path / "m"), model, step=42)
    assert checkpoint.exists(str(tmp_path / "m"))
    with np.load(path) as z:
        assert sorted(z.files) == ["params/table", "scalar/step",
                                   "scalar/w0"]
        assert z["params/table"].dtype == np.float32
    step, back = checkpoint.restore_params(str(tmp_path / "m"),
                                           device="cpu")
    assert step == 42
    got_w0, got_table = weights.to_numpy(back)
    assert got_w0 == w0
    np.testing.assert_array_equal(got_table, table)
    assert not checkpoint.exists(str(tmp_path / "absent"))


def test_embedding_dim_matches_jax_config():
    for kw in ({}, {"factor_num": 3}, {"factor_num": 2, "field_num": 4}):
        assert FmConfig(**kw).embedding_dim == JaxFmConfig(**kw).embedding_dim
