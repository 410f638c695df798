"""Plain-numpy dense checkpoint: ``<model_file>/params.npz``.

The one checkpoint format the port reads and writes.  Its keys follow
the conventions of the reference's ``quant.npz``
(``fast_tffm_tpu/train/checkpoint.py::save_quant``):

    scalar/step   int64   training step the parameters belong to
    scalar/w0     float32 global bias (0-d)
    params/table  float32 [vocab, D] table

A trainer's save adds its sparse optimizer state, so a warm start
resumes exactly (serving reads only the keys above):

    opt/acc_w0, opt/acc_table                 Adagrad
    opt/z_w0, opt/z_table, opt/n_w0, opt/n_table   FTRL
    (none)                                    SGD

The reference's Orbax dense checkpoints, ``quant.npz`` and
``tiered.npz`` are not read here yet (ROADMAP.md, port queue item 2).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.train.sparse import SparseAdagradState, SparseFtrlState
from fast_tffm_tpu_torch.weights import from_jax, to_numpy

__all__ = ["exists", "params_path", "restore_opt_state", "restore_params",
           "save_params"]

# optimizer -> (state type, its checkpoint keys in field order)
_OPT_KEYS = {
    "adagrad": (SparseAdagradState, ("opt/acc_w0", "opt/acc_table")),
    "ftrl": (SparseFtrlState,
             ("opt/z_w0", "opt/z_table", "opt/n_w0", "opt/n_table")),
}


def params_path(model_file: str) -> str:
    return os.path.join(os.path.abspath(model_file), "params.npz")


def exists(model_file: str) -> bool:
    return os.path.isfile(params_path(model_file))


def save_params(model_file: str, model: FmModel, step: int = 0,
                opt_state=None) -> str:
    """Write ``params.npz`` atomically (temp file + rename), with the
    sparse optimizer state when given; returns its path."""
    path = params_path(model_file)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    w0, table = to_numpy(model)
    arrays = {
        "scalar/step": np.int64(step),
        "scalar/w0": np.asarray(w0, np.float32),
        "params/table": table,
    }
    for kind, keys in _OPT_KEYS.values():
        if isinstance(opt_state, kind):
            for key, t in zip(keys, opt_state):
                arrays[key] = np.asarray(t.detach().cpu().numpy(),
                                         np.float32)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
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


def restore_opt_state(
    model_file: str, optimizer: str,
    device: Optional[Union[str, torch.device]] = None,
):
    """The ``optimizer``'s sparse state from ``params.npz`` on
    ``device``, ``()`` for SGD, or None when the file holds none for
    this optimizer (a serving-only checkpoint, or another optimizer's)."""
    if optimizer == "sgd":
        return ()
    kind, keys = _OPT_KEYS[optimizer]
    dev = resolve_device(device)
    with np.load(params_path(model_file), allow_pickle=False) as z:
        if not all(k in z.files for k in keys):
            return None
        return kind(*(torch.from_numpy(np.array(z[k], np.float32)).to(dev)
                      for k in keys))
