"""Write the small Orbax checkpoints of ``tests/data/orbax/`` with the JAX
package, as ``fast_tffm_tpu.train.checkpoint.save`` writes them, and
beside each a request set with the reference scorer's scores:

    JAX_PLATFORMS=cpu python tests/make_orbax_fixtures.py

- ``fm_adagrad/``: FM (V = 512, D = 9), step 40, the sparse Adagrad
  state (``SparseAdagradState(acc)``);
- ``fm_sharded/``: FM (V = 256, D = 9), step 11, the table row-sharded
  over a 2 x 4 mesh of virtual CPU devices (saved as 8 chunks);
- ``ffm_ftrl/``: field-aware FM (V = 256, two fields, k = 4, D = 9),
  step 17, the sparse FTRL state;
- ``fm_adam/``: FM (V = 256, D = 5), step 7, optax's Adam state with
  its int32 count.

``fixtures.json`` holds each one's config and step; ``<name>.npz`` its
requests (``ids``, ``vals``, ``fields``) and the reference
``FixedShapeScorer``'s sigmoid ``scores``.  The weights are seeded
numpy draws.  The port reads these files without jax (its tier-1 tests
hold them to the reference's own restore, and ``chip_smoke.py`` serves
and warm-starts them on the card); it never imports this script.
"""

import json
import os
import shutil
import sys

if "jax" not in sys.modules:
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fast_tffm_tpu.config import FmConfig  # noqa: E402
from fast_tffm_tpu.models import fm  # noqa: E402
from fast_tffm_tpu.serve.scorer import FixedShapeScorer  # noqa: E402
from fast_tffm_tpu.train import checkpoint, sparse  # noqa: E402
from fast_tffm_tpu.train.optimizers import make_optimizer  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "orbax")
SEED = 1717
N_REQUESTS = 48
F = 12

FIXTURES = {
    "fm_adagrad": dict(vocabulary_size=512, factor_num=8, field_num=0,
                       optimizer="adagrad", sparse_update=True, step=40),
    "fm_sharded": dict(vocabulary_size=256, factor_num=8, field_num=0,
                       optimizer="adagrad", sparse_update=True, step=11),
    "ffm_ftrl": dict(vocabulary_size=256, factor_num=4, field_num=2,
                     optimizer="ftrl", sparse_update=True, step=17),
    "fm_adam": dict(vocabulary_size=256, factor_num=4, field_num=0,
                    optimizer="adam", sparse_update=False, step=7),
}


def fixture_cfg(spec: dict) -> dict:
    """The FmConfig keywords of a fixture (both packages take them)."""
    return {k: v for k, v in spec.items() if k != "step"} | dict(
        max_features=F, serve_batch_sizes="16,64", learning_rate=0.05,
        adagrad_initial_accumulator=0.1, ftrl_l1=0.01, ftrl_l2=0.1)


def _params(cfg: FmConfig, rng) -> fm.FmParams:
    d = cfg.embedding_dim
    table = rng.uniform(-0.3, 0.3, (cfg.vocabulary_size, d)).astype(
        np.float32)
    return fm.FmParams(w0=jnp.float32(rng.uniform(-0.2, 0.2)),
                       table=jnp.asarray(table))


def _opt_state(name: str, cfg: FmConfig, params: fm.FmParams, rng):
    """A trained-looking optimizer state: the init, then each float leaf
    moved by a seeded draw (accumulators kept positive)."""
    if cfg.sparse_update:
        state = sparse.init_sparse_opt_state(cfg, params)
    else:
        state = make_optimizer(cfg).init(params)

    def move(x):
        x = np.asarray(x)
        if x.dtype.kind != "f":
            return jnp.asarray(np.array(FIXTURES[name]["step"], x.dtype))
        return jnp.asarray(
            (x + rng.uniform(0.0, 0.5, x.shape)).astype(np.float32))

    return jax.tree.map(move, state)


def main() -> int:
    rng = np.random.default_rng(SEED)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    for name, spec in FIXTURES.items():
        cfg = FmConfig(**fixture_cfg(spec))
        params = _params(cfg, rng)
        opt = None
        if name == "fm_sharded":
            mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                        ("data", "model"))
            params = params._replace(table=jax.device_put(
                params.table, NamedSharding(mesh, P("model", None))))
        else:
            opt = _opt_state(name, cfg, params, rng)
        checkpoint.save(os.path.join(OUT, name), spec["step"], params, opt)
        ids = rng.integers(0, cfg.vocabulary_size,
                           (N_REQUESTS, F)).astype(np.int32)
        vals = rng.uniform(0.1, 1.0, (N_REQUESTS, F)).astype(np.float32)
        vals[::4, -3:] = 0.0
        fields = (rng.integers(0, cfg.field_num, (N_REQUESTS, F))
                  if cfg.field_num else np.zeros((N_REQUESTS, F))
                  ).astype(np.int32)
        scorer = FixedShapeScorer(cfg, jax.tree.map(np.asarray, params))
        scores = scorer.score(ids, vals, fields if cfg.field_num else None)
        np.savez(os.path.join(OUT, f"{name}.npz"), ids=ids, vals=vals,
                 fields=fields, scores=np.asarray(scores, np.float32))
    with open(os.path.join(OUT, "fixtures.json"), "w") as f:
        json.dump({name: {"cfg": fixture_cfg(spec), "step": spec["step"]}
                   for name, spec in FIXTURES.items()}, f, indent=1,
                  sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(d, x))
                for d, _, files in os.walk(OUT) for x in files)
    print(f"wrote {len(FIXTURES)} fixtures to {OUT}: {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
