"""Plain-numpy dense checkpoint: ``<model_file>/params.npz``.

The one checkpoint format this slice of the port reads and writes.  Its
keys follow the conventions of the reference's ``quant.npz``
(``fast_tffm_tpu/train/checkpoint.py::save_quant``):

    scalar/step   int64   training step the parameters belong to
    scalar/w0     float32 global bias (0-d)
    params/table  float32 [vocab, D] table

The reference's Orbax dense checkpoints, ``quant.npz`` and
``tiered.npz`` are not read here yet (ROADMAP.md, port queue item 2).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.weights import from_jax, to_numpy

__all__ = ["exists", "params_path", "restore_params", "save_params"]


def params_path(model_file: str) -> str:
    return os.path.join(os.path.abspath(model_file), "params.npz")


def exists(model_file: str) -> bool:
    return os.path.isfile(params_path(model_file))


def save_params(model_file: str, model: FmModel, step: int = 0) -> str:
    """Write ``params.npz`` atomically (temp file + rename); returns its
    path."""
    path = params_path(model_file)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    w0, table = to_numpy(model)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **{
            "scalar/step": np.int64(step),
            "scalar/w0": np.asarray(w0, np.float32),
            "params/table": table,
        })
    os.replace(tmp, path)
    return path


def restore_params(
    model_file: str,
    device: Optional[Union[str, torch.device]] = None,
):
    """``(step, FmModel)`` from ``params.npz`` on ``device`` (the GPU
    unless asked otherwise).  Raises FileNotFoundError when absent."""
    with np.load(params_path(model_file), allow_pickle=False) as z:
        step = int(z["scalar/step"])
        w0 = np.float32(z["scalar/w0"])
        table = z["params/table"]
    return step, from_jax(w0, table, device=device)
