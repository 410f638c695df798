"""BASELINE config 3 on the port: the Adagrad-vs-FTRL optimizer and
L2-regularization sweep of ``examples/sweep_optimizers.py``.

Trains the same data under a grid of (optimizer, lambda) settings and
prints one JSON row a cell (the cell's overrides, validation ``logloss``
to 6 places and ``auc`` to 4; the training metrics where the config has
no validation files), then ``best:`` and the row of the lowest logloss.
Each cell trains from scratch into its own model dir,
``<model_root>/fast_tffm_tpu_torch_sweep_<i>`` (the temp directory by
default), which is deleted first.  Runs on the GPU unless ``--device``
says otherwise; a host without one raises.

Usage::

    python examples/gen_sample_data.py
    python -m fast_tffm_tpu_torch.tools.sweep_optimizers [base.cfg]
    python -m fast_tffm_tpu_torch.tools.sweep_optimizers --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from typing import Optional

from fast_tffm_tpu_torch.config import load_config
from fast_tffm_tpu_torch.train.loop import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_BASE = os.path.join(REPO, "examples", "sample.cfg")

# The example's grid, cell for cell.  The FTRL cells share the base
# config's learning rate (sample.cfg: 1.0).
GRID = [
    {"optimizer": "adagrad", "factor_lambda": 0.0, "bias_lambda": 0.0},
    {"optimizer": "adagrad", "factor_lambda": 1e-4, "bias_lambda": 1e-4},
    {"optimizer": "adagrad", "factor_lambda": 1e-3, "bias_lambda": 1e-3},
    {"optimizer": "ftrl", "ftrl_l1": 0.0, "ftrl_l2": 0.0},
    {"optimizer": "ftrl", "ftrl_l1": 1e-3, "ftrl_l2": 1e-3},
    {"optimizer": "ftrl", "ftrl_l1": 1e-2, "ftrl_l2": 1e-2},
]


def model_dir(root: str, i: int) -> str:
    """Cell ``i``'s model dir under ``root``."""
    return os.path.join(root, f"fast_tffm_tpu_torch_sweep_{i}")


def run_cell(base: str, overrides: dict, model_file: str,
             device: Optional[str] = None) -> dict:
    """Train one cell of the grid into ``model_file`` (kept as it is: a
    checkpoint there is warm-started from) and return its row."""
    cfg = load_config(base, overrides={**overrides, "model_file": model_file,
                                       "log_steps": 0})
    result = Trainer(cfg, device=device).train()
    m = result.get("validation", result["train"])
    return {**overrides, "logloss": round(m["loss"], 6),
            "auc": round(m["auc"], 4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("base", nargs="?", default=DEFAULT_BASE,
                    help="base .cfg (default: examples/sample.cfg)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no fall-back")
    ap.add_argument("--model_root", default=tempfile.gettempdir(),
                    help="where the cells' model dirs go")
    args = ap.parse_args(argv)
    results = []
    for i, overrides in enumerate(GRID):
        path = model_dir(args.model_root, i)
        shutil.rmtree(path, ignore_errors=True)
        row = run_cell(args.base, overrides, path, device=args.device)
        results.append(row)
        print(json.dumps(row), flush=True)
    best = min(results, key=lambda r: r["logloss"])
    print("best:", json.dumps(best), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
