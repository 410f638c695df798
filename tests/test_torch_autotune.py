"""The port's kernel autotuner (``fast_tffm_tpu_torch/ops/autotune.py``),
its flat formulation (``ops/interaction.py``), the trainer's and the
scorer's interaction choice and ``tools/autotune.py``, against the JAX
package on the CPU (``fast_tffm_tpu/ops/autotune.py``, ``ops/
interaction.py``, its ``Trainer`` and ``FixedShapeScorer``), which run as
``tests/test_autotune.py`` runs them.

- ``resolve``: the same ``impl``, ``interaction``, ``source`` and
  ``candidates`` from both packages for ``auto`` on the CPU, each pin,
  the legacy ``interaction`` / ``use_pallas`` surface and FFM, with no
  measurement in any of them.
- The parity gate rejects an injected wrong candidate in both packages
  alike; a forced ``("reference", "packed")`` measurement passes it in
  the train context and in the serve context at fp32, bf16 and int8.
- The cache: a hit (in memory and from disk) skips measurement, drift in
  batch, F, D, table dtype or torch version re-measures, a corrupt file
  re-measures, ``write_record`` has the reference's keys, and one
  ``autotune_cache.json`` holds both packages' entries.
- The ``jnp`` and ``flat`` formulations against the reference's, f32
  (``tests/test_pallas_ops.py``'s ``rtol=1e-5, atol=1e-6``) and bf16
  (``tests/test_bf16.py``'s bounds); ``_candidate_fns``' inputs are
  bitwise the reference's.
- The trainer (``auto`` bitwise ``reference`` on the CPU; ``packed`` and
  ``interaction = jnp`` within the tile-vs-scatter bounds of the
  reference's trainer pinned the same way; ``kernel_impl`` and the
  record in the stream, which both report tools print), the scorer at
  every table dtype against the reference's pinned the same way (the
  FmScorer tolerance), the server's record, and ``tools.autotune``.

Every test empties both packages' in-process caches and points
``FAST_TFFM_AUTOTUNE_CACHE`` at memory, so no ``autotune_cache.json`` is
left beside a model.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fast_tffm_tpu import obs as jax_obs
from fast_tffm_tpu.config import FmConfig as JaxFmConfig
from fast_tffm_tpu.models import fm as jax_fm
from fast_tffm_tpu.ops import autotune as jax_autotune
from fast_tffm_tpu.ops import interaction as jax_interaction
from fast_tffm_tpu.serve.scorer import FixedShapeScorer as JaxScorer
from fast_tffm_tpu.train.loop import Trainer as JaxTrainer
from fast_tffm_tpu_torch import weights
from fast_tffm_tpu_torch.config import FmConfig, load_config
from fast_tffm_tpu_torch.obs.heartbeat import JsonlWriter
from fast_tffm_tpu_torch.ops import autotune, interaction
from fast_tffm_tpu_torch.serve.scorer import FixedShapeScorer, make_scorer
from fast_tffm_tpu_torch.serve.server import serve
from fast_tffm_tpu_torch.tools import autotune as autotune_tool
from fast_tffm_tpu_torch.tools import report
from fast_tffm_tpu_torch.train import checkpoint
from fast_tffm_tpu_torch.train.loop import Trainer
from tools import report as jax_report

TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_pallas_ops.py
BF16_SCORE_TOL = dict(rtol=2e-3, atol=1e-4)  # tests/test_bf16.py:71
BF16_GRAD_TOL = dict(rtol=0.05, atol=0.02)  # tests/test_bf16.py:85
TABLE_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_sparse_apply.py
W0_TOL = dict(rtol=1e-5, atol=1e-7)
V, F = 64, 4
CANDS = ("reference", "packed")
RECORD_KEYS = {"record", "time", "impl", "source", "context", "key",
               "candidates", "times_ms", "parity_err"}


@pytest.fixture(autouse=True)
def _isolated_autotune(monkeypatch):
    """Both packages' in-process caches empty, and no default cache file
    (a test passes ``cache_path`` to use one)."""
    monkeypatch.setattr(autotune, "_MEM_CACHE", {})
    monkeypatch.setattr(jax_autotune, "_MEM_CACHE", {})
    monkeypatch.setenv("FAST_TFFM_AUTOTUNE_CACHE", "")


def _kw(**kw):
    out = dict(vocabulary_size=V, factor_num=4, max_features=F,
               batch_size=32)
    out.update(kw)
    return out


def _both(**kw):
    return FmConfig(**_kw(**kw)), JaxFmConfig(**_kw(**kw))


def _summary(d) -> tuple:
    return d.impl, d.interaction, d.source, tuple(d.candidates)


# ------------------------------------------------------------- resolve


@pytest.mark.parametrize("knobs, want", [
    (dict(interaction_impl="auto"),
     ("reference", "jnp", "single_candidate", ("reference",))),
    (dict(interaction_impl="reference"), ("reference", "jnp", "pinned", ())),
    (dict(interaction_impl="pallas"), ("pallas", "pallas", "pinned", ())),
    (dict(interaction_impl="packed"), ("packed", "flat", "pinned", ())),
    (dict(interaction="flat"), ("packed", "flat", "legacy", ())),
    (dict(interaction="jnp"), ("reference", "jnp", "legacy", ())),
    (dict(use_pallas=False), ("reference", "jnp", "legacy", ())),
    (dict(), ("pallas", "pallas", "legacy", ())),
    (dict(interaction_impl="auto", field_num=3),
     ("reference", "jnp", "single_candidate", ("reference",))),
], ids=["auto-cpu", "pin-reference", "pin-pallas", "pin-packed",
        "legacy-flat", "legacy-jnp", "legacy-use_pallas-false",
        "legacy-default", "ffm"])
@pytest.mark.parametrize("context", ["train", "serve"])
def test_resolve_matches_the_reference(tmp_path, knobs, want, context):
    cfg, jcfg = _both(**knobs)
    cache = str(tmp_path / "autotune_cache.json")
    n, jn = autotune.measurement_count(), jax_autotune.measurement_count()
    got = autotune.resolve(cfg, context=context, cache_path=cache,
                           device="cpu")
    ref = jax_autotune.resolve(jcfg, context=context, cache_path=cache)
    assert _summary(got) == _summary(ref) == want
    assert cfg.interaction_resolved == jcfg.interaction_resolved
    assert autotune.measurement_count() == n
    assert jax_autotune.measurement_count() == jn
    assert not os.path.exists(cache)


def test_default_candidates_take_the_card_for_the_tpu():
    assert autotune.default_candidates(0, "cpu") == ("reference",)
    assert autotune.default_candidates(3, "cuda") == ("reference",)
    assert autotune.default_candidates(0, "cuda") == (
        "reference", "pallas", "packed")
    assert jax_autotune.default_candidates(0) == ("reference",)


# ---------------------------------------------------------- parity gate


def _wrong_packed(pkg):
    """``(make, args)`` whose ``packed`` doubles the scores, for either
    package, on the same inputs."""
    rng = np.random.default_rng(0)
    rows = rng.uniform(-0.1, 0.1, (32, F, 5)).astype(np.float32)
    vals = rng.uniform(0.1, 1.0, (32, F)).astype(np.float32)
    if pkg == "jax":
        def make(user_impl):
            scale = 2.0 if user_impl == "packed" else 1.0
            return jax.jit(lambda r, v: jax_interaction.fm_interaction(
                r, v, "jnp") * scale)

        return make, (jnp.asarray(rows), jnp.asarray(vals))

    def make(user_impl):
        scale = 2.0 if user_impl == "packed" else 1.0
        return lambda r, v: interaction.fm_interaction(r, v, "jnp") * scale

    return make, (torch.from_numpy(rows), torch.from_numpy(vals))


def test_parity_gate_rejects_wrong_candidate():
    cfg, jcfg = _both(interaction_impl="auto")
    got = autotune.resolve(cfg, candidates=CANDS, device="cpu",
                           candidate_fns=_wrong_packed("torch"))
    ref = jax_autotune.resolve(jcfg, candidates=CANDS,
                               candidate_fns=_wrong_packed("jax"))
    for d in (got, ref):
        assert d.source == "measured" and d.impl == "reference"
        assert d.parity_err["packed"] > autotune.PARITY_TOL
        assert "packed" not in d.times_ms  # gated out before timing
    np.testing.assert_allclose(got.parity_err["packed"],
                               ref.parity_err["packed"], rtol=1e-5)


def _broken(how, victim):
    """``(make, args)`` of ``_wrong_packed("torch")`` whose ``victim``
    raises (``how == "raises"``) or doubles the scores (``"wrong"``)."""
    make, args = _wrong_packed("torch")

    def broken(user_impl):
        if user_impl != victim:
            return make("reference")
        if how == "wrong":
            fn = make("reference")
            return lambda *a: fn(*a) * 2.0

        def f(*a):
            raise RuntimeError("kernel did not build")
        return f

    return broken, args


@pytest.mark.parametrize("cands", [("reference", "pallas"), CANDS],
                         ids=["pallas-on-the-cpu", "forced-packed"])
def test_a_candidate_that_raises_is_excluded_with_inf(cands):
    """Where no hand-written kernel must run (the CPU, a forced
    ``("reference", "packed")`` set), a candidate that raises is
    excluded with parity ``inf``, as in the reference."""
    cfg = FmConfig(**_kw(interaction_impl="auto"))
    victim = cands[1]
    assert not autotune._must_run(cands, "cpu")
    d = autotune.resolve(cfg, candidates=cands, device="cpu",
                         candidate_fns=_broken("raises", victim))
    assert d.impl == "reference"
    assert d.parity_err[victim] == float("inf")
    assert victim not in d.times_ms


def test_a_hand_written_kernel_must_run_on_the_card():
    """The rule of ``_must_run``: a CUDA device with ``pallas`` among the
    candidates (the card's default set), and nowhere else."""
    every = ("reference", "pallas", "packed")
    assert autotune.default_candidates(0, "cuda") == every
    assert autotune._must_run(every, "cuda")
    assert autotune._must_run(("reference", "pallas"), torch.device("cuda"))
    assert not autotune._must_run(CANDS, "cuda")
    assert not autotune._must_run(("reference",), "cuda")
    assert not autotune._must_run(every, "cpu")


@pytest.mark.parametrize("how", ["raises", "wrong"])
def test_a_failed_kernel_candidate_raises_where_it_must_run(monkeypatch,
                                                            how):
    """Where a hand-written kernel must run, a ``pallas`` that raises or
    fails the parity gate makes ``resolve`` raise with its name: nothing
    is measured into the cache and no plain version takes its place.  A
    ``packed`` that fails the gate is still excluded."""
    monkeypatch.setattr(autotune, "_must_run", lambda names, device: True)
    cfg = FmConfig(**_kw(interaction_impl="auto"))
    with pytest.raises(RuntimeError, match="candidate pallas"):
        autotune.resolve(cfg, candidates=("reference", "pallas"),
                         device="cpu", candidate_fns=_broken(how, "pallas"))
    assert autotune._MEM_CACHE == {}
    d = autotune.resolve(cfg, candidates=CANDS, device="cpu",
                         candidate_fns=_broken("wrong", "packed"))
    assert d.impl == "reference"
    assert d.parity_err["packed"] > autotune.PARITY_TOL
    if how == "raises":  # a packed that raises where a kernel must run
        with pytest.raises(RuntimeError, match="candidate packed"):
            autotune.resolve(
                cfg, candidates=("reference", "pallas", "packed"),
                device="cpu", candidate_fns=_broken(how, "packed"),
                cache_path="")


@pytest.mark.parametrize("context, dtype", [
    ("train", "fp32"), ("serve", "fp32"), ("serve", "bf16"),
    ("serve", "int8"),
])
def test_forced_packed_measurement_passes_the_gate(context, dtype):
    cfg = FmConfig(**_kw(interaction_impl="auto", serve_table_dtype=dtype))
    n = autotune.measurement_count()
    d = autotune.resolve(cfg, context=context, batch=32, candidates=CANDS,
                         table_dtype=dtype, device="cpu")
    assert d.source == "measured" and d.impl in CANDS
    assert autotune.measurement_count() == n + 2
    assert set(d.times_ms) == set(CANDS)
    assert d.parity_err["reference"] == 0.0
    assert 0.0 <= d.parity_err["packed"] <= autotune.PARITY_TOL
    assert d.eager_ms == {}  # graphed timing is the card's
    assert d.measure_s > 0


# --------------------------------------------------------------- cache


def test_cache_hit_skips_measurement(tmp_path):
    cfg = FmConfig(**_kw(interaction_impl="auto"))
    cache = str(tmp_path / "autotune_cache.json")
    d1 = autotune.resolve(cfg, candidates=CANDS, cache_path=cache,
                          device="cpu")
    n1 = autotune.measurement_count()
    d2 = autotune.resolve(cfg, candidates=CANDS, cache_path=cache,
                          device="cpu")
    assert (d1.source, d2.source) == ("measured", "cache")
    assert d2.impl == d1.impl and d2.times_ms == d1.times_ms
    assert autotune.measurement_count() == n1


def test_cache_hit_from_disk_with_an_empty_memory(tmp_path, monkeypatch):
    """A fresh process (an empty ``_MEM_CACHE``) reads the file: the
    replica fleet's and a restart's contract."""
    cfg = FmConfig(**_kw(interaction_impl="auto"))
    cache = str(tmp_path / "autotune_cache.json")
    autotune.resolve(cfg, candidates=CANDS, cache_path=cache, device="cpu")
    assert os.path.exists(cache)
    monkeypatch.setattr(autotune, "_MEM_CACHE", {})
    n1 = autotune.measurement_count()
    d = autotune.resolve(cfg, candidates=CANDS, cache_path=cache,
                         device="cpu")
    assert d.source == "cache" and autotune.measurement_count() == n1


@pytest.mark.parametrize("drift", ["batch", "features", "dim",
                                   "table_dtype", "torch_version"])
def test_key_drift_re_measures(tmp_path, drift):
    cfg = FmConfig(**_kw(interaction_impl="auto"))
    cache = str(tmp_path / "autotune_cache.json")
    kw = dict(candidates=CANDS, cache_path=cache, batch=32, device="cpu")
    first = autotune.resolve(cfg, **kw)
    n1 = autotune.measurement_count()
    if drift == "batch":
        kw["batch"] = 64
    elif drift == "features":
        cfg = FmConfig(**_kw(interaction_impl="auto", max_features=F + 1))
    elif drift == "dim":
        cfg = FmConfig(**_kw(interaction_impl="auto", factor_num=6))
    elif drift == "table_dtype":
        kw["table_dtype"] = "bf16"
    else:
        kw["torch_version"] = "999.0.0"
    d = autotune.resolve(cfg, **kw)
    assert d.source == "measured" and d.key != first.key
    assert autotune.measurement_count() > n1
    assert set(autotune.load_cache(cache)) == {first.key, d.key}


def test_corrupt_cache_file_re_measures(tmp_path):
    cfg = FmConfig(**_kw(interaction_impl="auto"))
    cache = str(tmp_path / "autotune_cache.json")
    with open(cache, "w") as f:
        f.write("{not json")
    d = autotune.resolve(cfg, candidates=CANDS, cache_path=cache,
                         device="cpu")
    assert d.source == "measured"
    entries = autotune.load_cache(cache)  # repaired in place
    assert list(entries) == [d.key]
    assert entries[d.key]["impl"] in autotune.INTERNAL


def test_record_has_the_reference_keys(tmp_path):
    cfg, jcfg = _both(interaction_impl="auto")
    paths = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    w, jw = JsonlWriter(str(paths[0])), jax_obs.JsonlWriter(str(paths[1]))
    d = autotune.resolve(cfg, writer=w, device="cpu")
    autotune.resolve(cfg, candidates=CANDS, writer=w, device="cpu")
    jax_autotune.resolve(jcfg, writer=jw)
    jax_autotune.resolve(jcfg, candidates=CANDS, writer=jw)
    w.close()
    jw.close()
    got = [json.loads(line) for line in open(paths[0])]
    want = [json.loads(line) for line in open(paths[1])]
    assert len(got) == len(want) == 2
    for g, r in zip(got, want):
        assert set(g) == set(r) == RECORD_KEYS
        for key in ("record", "source", "context", "candidates"):
            assert g[key] == r[key], key
        assert set(g["times_ms"]) == set(r["times_ms"])
        assert set(g["parity_err"]) == set(r["parity_err"])
    assert got[0]["impl"] == want[0]["impl"] == "reference"
    assert got[1]["impl"] in CANDS  # the faster on this host
    assert got[0]["key"] == d.key and d.key.endswith(
        f"torch{torch.__version__}")


def test_one_cache_file_holds_both_packages_entries(tmp_path):
    """The reference's ``jax…`` entries survive the port's save, and the
    reference reads the file the port wrote (and still hits its own)."""
    cfg, jcfg = _both(interaction_impl="auto")
    cache = str(tmp_path / "autotune_cache.json")
    ref = jax_autotune.resolve(jcfg, candidates=CANDS, cache_path=cache)
    got = autotune.resolve(cfg, candidates=CANDS, cache_path=cache,
                           device="cpu")
    assert (ref.source, got.source) == ("measured", "measured")
    assert ref.key.split("|")[-1].startswith("jax")
    assert got.key.split("|")[-1].startswith("torch")
    with open(cache) as f:
        doc = json.load(f)
    assert doc["version"] == 1 and set(doc["entries"]) == {ref.key, got.key}
    assert set(jax_autotune.load_cache(cache)) == {ref.key, got.key}
    jn = jax_autotune.measurement_count()
    again = jax_autotune.resolve(jcfg, candidates=CANDS, cache_path=cache)
    assert again.source == "cache" and again.impl == ref.impl
    assert jax_autotune.measurement_count() == jn


# -------------------------------------------------------- formulations


def _problem(dtype, b=37, f=13, k=8, seed=3):
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(b, f, 1 + k)) * 0.3).astype(np.float32)
    vals = rng.uniform(0.0, 1.0, (b, f)).astype(np.float32)
    vals[::4, -3:] = 0.0
    g = rng.normal(size=b).astype(np.float32)
    if dtype == "bfloat16":  # exactly representable in bf16
        rows = np.asarray(jnp.asarray(rows).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        vals = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16)
                          .astype(jnp.float32))
    return rows, vals, g


_REF = {"jnp": (jax_interaction._scores_jnp, jax_interaction._grads_jnp),
        "flat": (jax_interaction._scores_flat, jax_interaction._grads_flat)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["jnp", "flat"])
def test_formulation_matches_the_reference(impl, dtype):
    """Scores, ``s1`` and ``drows`` (from the same ``s1`` and ``g``) of
    the port's formulation against the reference's, and the autograd
    function's scores and row gradient against the reference's
    ``fm_interaction`` and its VJP."""
    rows, vals, g = _problem(dtype)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
              else (jnp.float32, torch.float32))
    score_tol, grad_tol = ((BF16_SCORE_TOL, BF16_GRAD_TOL)
                           if dtype == "bfloat16" else (TOL, TOL))
    jr, jv = jnp.asarray(rows).astype(jd), jnp.asarray(vals).astype(jd)
    r = torch.tensor(rows).to(td)
    v = torch.tensor(vals).to(td)
    want_s, want_s1 = _REF[impl][0](jr, jv)
    got_s, got_s1 = interaction.forward(r, v, impl)
    assert got_s.dtype == got_s1.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               **score_tol)
    np.testing.assert_allclose(got_s1.numpy(), np.asarray(want_s1),
                               **score_tol)
    want_d = _REF[impl][1](jr, jv, want_s1, jnp.asarray(g))
    got_d = {"jnp": interaction._BACKWARD["jnp"],
             "flat": interaction.grads_flat}[impl](
        r, v, torch.tensor(np.asarray(want_s1)), torch.from_numpy(g))
    assert got_d.dtype == td
    np.testing.assert_allclose(got_d.float().numpy(),
                               np.asarray(want_d.astype(jnp.float32)),
                               **grad_tol)
    # Through the autograd function and the reference's custom VJP.
    want_s, vjp = jax.vjp(
        lambda x: jax_interaction.fm_interaction(x, jv, impl), jr)
    (want_d,) = vjp(jnp.asarray(g))
    leaf = r.clone().requires_grad_()
    scores = interaction.fm_interaction(leaf, v, impl)
    (drows,) = torch.autograd.grad(scores, leaf, torch.from_numpy(g))
    assert drows.dtype == td
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(want_s),
                               **score_tol)
    np.testing.assert_allclose(drows.float().numpy(),
                               np.asarray(want_d.astype(jnp.float32)),
                               **grad_tol)


def test_flat_needs_no_tf32():
    """At Criteo's F = 39 and D = 9 the flat scores and ``s1`` are within
    f32 summation-order error of the plain version's (relative to their
    largest, as the parity gate measures: TF32's 10-bit mantissa would
    put them ~1e-3 away), and TF32 is off."""
    rows, vals, _ = _problem("float32", b=256, f=39, k=8)
    r, v = torch.from_numpy(rows), torch.from_numpy(vals)
    err = autotune._parity_error(interaction.forward(r, v, "flat"),
                                 interaction.forward(r, v, "jnp"))
    assert 0.0 < err < 1e-5
    assert not torch.backends.cuda.matmul.allow_tf32


def test_unknown_impl_raises():
    r, v = torch.zeros(2, 3, 5), torch.zeros(2, 3)
    with pytest.raises(ValueError, match="unknown interaction impl"):
        interaction.forward(r, v, "mosaic")
    assert interaction.impl_name(True) == "pallas"
    assert interaction.impl_name(False) == "jnp"


@pytest.mark.parametrize("context, dtype", [
    ("train", "fp32"), ("serve", "fp32"), ("serve", "bf16"),
    ("serve", "int8"),
])
def test_candidate_inputs_and_outputs_match_the_reference(context, dtype):
    """``_candidate_fns`` draws the reference's inputs bit for bit, and
    each candidate's outputs agree with the reference's."""
    cfg, jcfg = _both(quant_chunk=16)
    make, args = autotune._candidate_fns(cfg, context, 32, dtype, "cpu")
    jmake, jargs = jax_autotune._candidate_fns(jcfg, context, 32, dtype)
    assert len(args) == len(jargs) == 2
    for a, b in zip(args, jargs):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.numpy().tobytes() == (
            b.tobytes())
    for user in CANDS:
        got = autotune._flat_outputs(make(user)(*args))
        want = jax.tree_util.tree_leaves(jmake(user)(*jargs))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       **TOL)


# ------------------------------------------------------------- trainer


def _write_lines(path, n, seed=11, vocab=V):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            ids = rng.choice(vocab, size=3, replace=False)
            f.write(f"{i % 2} " + " ".join(
                f"{j}:{x:.3f}" for j, x in zip(
                    ids, rng.uniform(0.2, 1.0, 3))) + "\n")


def _train_kw(tmp_path, model, **kw):
    return _kw(train_files=[str(tmp_path / "train.libsvm")],
               model_file=str(tmp_path / model), epoch_num=1, log_steps=0,
               save_steps=0, thread_num=1, seed=3, learning_rate=0.1,
               shuffle_buffer=0, **kw)


def test_train_auto_bitwise_identical_to_pinned_reference(tmp_path):
    """The counterpart of the reference's test of the same name: on the
    CPU ``auto`` resolves to ``reference`` with no measurement, and its
    run is bitwise the run pinned to it."""
    _write_lines(tmp_path / "train.libsvm", 160)
    init = Trainer(FmConfig(**_train_kw(tmp_path, "init")), device="cpu")
    runs = []
    for impl in ("auto", "reference"):
        model = str(tmp_path / f"m_{impl}")
        checkpoint.save_params(model, init.model)
        t = Trainer(FmConfig(**_train_kw(tmp_path, f"m_{impl}",
                                         interaction_impl=impl)),
                    device="cpu")
        runs.append((t, t.train()))
    (t_auto, r_auto), (t_ref, r_ref) = runs
    assert t_auto.kernel_impl == t_ref.kernel_impl == "reference"
    assert t_auto._autotune.source == "single_candidate"
    assert t_ref._autotune is None
    assert r_auto["train"]["steps"] == r_ref["train"]["steps"] == 5
    assert torch.equal(t_auto.model.table, t_ref.model.table)
    assert torch.equal(t_auto.model.w0, t_ref.model.w0)


@pytest.mark.parametrize("knobs", [dict(interaction_impl="packed"),
                                   dict(interaction="jnp")],
                         ids=["packed", "interaction-jnp"])
def test_trainer_matches_the_reference_trainer_pinned_the_same_way(
        tmp_path, knobs):
    """Three sparse steps from the reference's initial table, both
    trainers pinned the same way (the reference's scatter apply): the
    tables and w0 within the tile-vs-scatter bounds, the train loss
    within the scores' tolerance."""
    _write_lines(tmp_path / "train.libsvm", 96)
    jt = JaxTrainer(JaxFmConfig(**_train_kw(tmp_path, "jax_model",
                                            sparse_apply="scatter",
                                            **knobs)))
    assert jt.kernel_impl == ("packed" if "interaction_impl" in knobs
                              else "reference")
    init = jax.tree.map(np.asarray, jt.state.params)
    jres = jt.train()
    port_dir = str(tmp_path / "port_model")
    checkpoint.save_params(port_dir, weights.from_jax(init.w0, init.table,
                                                      device="cpu"))
    cfg = FmConfig(**_train_kw(tmp_path, "port_model", **knobs))
    t = Trainer(cfg, device="cpu")
    assert t.kernel_impl == jt.kernel_impl
    assert t.interaction == cfg.interaction_resolved
    pres = t.train()
    assert pres["train"]["steps"] == jres["train"]["steps"] == 3
    np.testing.assert_allclose(pres["train"]["logloss"],
                               jres["train"]["logloss"], rtol=1e-5)
    params = jax.tree.map(np.asarray, jt.state.params)
    np.testing.assert_allclose(t.model.table.detach().numpy(), params.table,
                               **TABLE_TOL)
    np.testing.assert_allclose(float(t.model.w0.detach()),
                               float(params.w0), **W0_TOL)


def test_stream_carries_kernel_impl_and_the_record(tmp_path, capsys):
    """The run header's ``kernel_impl``, one ``record: autotune`` after it
    in the ``metrics_file`` stream, and both report tools printing it."""
    _write_lines(tmp_path / "train.libsvm", 64)
    stream = str(tmp_path / "m.jsonl")
    Trainer(FmConfig(**_train_kw(tmp_path, "m", interaction_impl="auto",
                                 metrics_file=stream)),
            device="cpu").train()
    recs = [json.loads(line) for line in open(stream)]
    assert recs[0]["record"] == "run_header"
    assert recs[0]["kernel_impl"] == "reference"
    assert recs[0]["interaction_impl"] == "auto"
    assert recs[1]["record"] == "autotune"
    assert set(recs[1]) == RECORD_KEYS
    assert (recs[1]["impl"], recs[1]["source"], recs[1]["context"]) == (
        "reference", "single_candidate", "train")
    for tool in (report, jax_report):
        capsys.readouterr()
        assert tool.main([stream]) == 0
        out = capsys.readouterr().out
        assert "autotune (interaction-impl decisions, 1):" in out
        assert "reference" in out.split("autotune (")[1]


def test_pinned_trainer_writes_no_record(tmp_path):
    _write_lines(tmp_path / "train.libsvm", 64)
    stream = str(tmp_path / "m.jsonl")
    t = Trainer(FmConfig(**_train_kw(tmp_path, "m",
                                     interaction_impl="packed",
                                     metrics_file=stream)), device="cpu")
    t.train()
    recs = [json.loads(line) for line in open(stream)]
    assert recs[0]["kernel_impl"] == "packed"
    assert not [r for r in recs if r["record"] == "autotune"]


# -------------------------------------------------------------- scorer


def _serve_kw(**kw):
    return _kw(vocabulary_size=256, serve_batch_sizes="16,64",
               quant_chunk=32, serve_poll_secs=0.0, max_batch_wait_ms=1.0,
               **kw)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("impl", ["packed", "reference"])
def test_scorer_matches_the_reference_pinned_the_same_way(impl, dtype):
    rng = np.random.default_rng(5)
    table = (rng.uniform(-0.01, 0.01, (256, 5)) * 50).astype(np.float32)
    w0 = np.float32(-0.1)
    ids = rng.integers(0, 256, (100, F)).astype(np.int32)
    vals = rng.uniform(0.1, 1.5, (100, F)).astype(np.float32)
    kw = _serve_kw(serve_table_dtype=dtype, interaction_impl=impl)
    port = FixedShapeScorer(FmConfig(**kw),
                            weights.from_jax(w0, table, device="cpu"),
                            device="cpu")
    ref = JaxScorer(JaxFmConfig(**kw), jax_fm.FmParams(
        w0=jnp.asarray(w0), table=jnp.asarray(table)))
    assert port.kernel_impl == ref.kernel_impl == impl
    assert port._impl == autotune.INTERNAL[impl]
    port.warmup()
    np.testing.assert_allclose(port.score(ids, vals, None),
                               ref.score(ids, vals, None), **TOL)


def test_scorer_without_interaction_impl_keeps_the_fmscorer():
    port = FixedShapeScorer(
        FmConfig(**_serve_kw()),
        weights.from_jax(np.float32(0), np.zeros((256, 5), np.float32),
                         device="cpu"), device="cpu")
    assert (port.kernel_impl, port._impl) == ("pallas", "pallas")


def _save_model(path, seed=2):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-0.3, 0.3, (256, 5)).astype(np.float32)
    checkpoint.save_params(path, weights.from_jax(np.float32(0.05), table,
                                                  device="cpu"))


def test_server_record_names_the_kernel_impl(tmp_path):
    model = str(tmp_path / "model")
    _save_model(model)
    stream = str(tmp_path / "serve.jsonl")
    cfg = FmConfig(**_serve_kw(model_file=model, metrics_file=stream,
                               interaction_impl="packed"))
    handle = serve(cfg, device="cpu", port=0)
    try:
        assert handle.scorer.kernel_impl == "packed"
    finally:
        handle.close()
    recs = [json.loads(line) for line in open(stream)]
    at = [r for r in recs if r["record"] == "autotune"]
    assert len(at) == 1 and at[0]["context"] == "serve"
    assert (at[0]["impl"], at[0]["source"]) == ("packed", "pinned")
    final = [r for r in recs if r["record"] == "final"][-1]
    assert final["serve"]["kernel_impl"] == "packed"


# --------------------------------------------------------------- tool


def test_tool_check_exits_zero_on_the_cpu(capsys):
    assert autotune_tool.main(["--check", "--device", "cpu"]) == 0
    assert "autotune check OK (device: cpu)" in capsys.readouterr().out
    assert os.environ["FAST_TFFM_AUTOTUNE_CACHE"] == ""


def test_tool_fills_both_contexts_and_a_scorer_starts_from_them(
        tmp_path, monkeypatch, capsys):
    """With a forced multi-candidate set (on the CPU it is reference
    alone): the tool writes the train entry at ``batch_size`` and the
    serve entry at the max rung into the cache beside the model, the
    scorer of an ``auto`` config starts from it with no measurement, and
    ``--check`` reads the file back."""
    monkeypatch.delenv("FAST_TFFM_AUTOTUNE_CACHE")
    cpu_candidates = autotune.default_candidates
    monkeypatch.setattr(autotune, "default_candidates",
                        lambda field_num, device: CANDS)
    model = str(tmp_path / "model")
    _save_model(model)
    cfg_path = str(tmp_path / "m.cfg")
    with open(cfg_path, "w") as f:
        f.write(f"[General]\nvocabulary_size = 256\nfactor_num = 4\n"
                f"model_file = {model}\n[Train]\nbatch_size = 32\n"
                f"max_features = {F}\nserve_batch_sizes = 16,64\n")
    assert autotune_tool.main([cfg_path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "train: " in out and "serve: " in out and "(measured;" in out
    cache = str(tmp_path / "autotune_cache.json")
    entries = autotune.load_cache(cache)
    assert sorted(k.split("|")[:3] for k in entries) == [
        ["serve", "cpu", "b64"], ["train", "cpu", "b32"]]
    monkeypatch.setattr(autotune, "_MEM_CACHE", {})
    n = autotune.measurement_count()
    cfg = load_config(cfg_path, {"interaction_impl": "auto"})
    scorer = make_scorer(cfg, device="cpu")
    assert autotune.measurement_count() == n
    assert scorer.kernel_impl == entries[
        next(k for k in entries if k.startswith("serve"))]["impl"]
    monkeypatch.setattr(autotune, "default_candidates", cpu_candidates)
    assert autotune_tool.main([cfg_path, "--check", "--device",
                               "cpu"]) == 0
    assert "2 entrie(s) OK" in capsys.readouterr().out
