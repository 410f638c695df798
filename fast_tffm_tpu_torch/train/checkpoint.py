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

Beside it a trainer writes ``data_state.json``, the input position of
the saved step (the reference's keys: ``epoch``, ``batches_done`` and
the stream's ``fingerprint``), so a warm start continues the stream
where the saved run stopped (:func:`restore_data_state`).

A multi-rank trainer writes the same file (:func:`save_sharded`: rank
0 gathers the model shards over the ``model`` axis) and each rank reads
its own rows of it (``rows=``), so a checkpoint moves freely between
one rank and many, and ``predict`` and ``serve`` read it unchanged.

The reference's Orbax dense checkpoints, ``quant.npz`` and
``tiered.npz`` are not read here yet (ROADMAP.md, port queue item 2).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.parallel.mesh import (
    MODEL_AXIS, Mesh, barrier, gather,
)
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.train.sparse import SparseAdagradState, SparseFtrlState
from fast_tffm_tpu_torch.weights import from_jax, to_numpy

__all__ = ["data_state_path", "exists", "params_path", "restore_data_state",
           "restore_opt_state", "restore_params", "save_params",
           "save_sharded"]

# optimizer -> (state type, its checkpoint keys in field order)
_OPT_KEYS = {
    "adagrad": (SparseAdagradState, ("opt/acc_w0", "opt/acc_table")),
    "ftrl": (SparseFtrlState,
             ("opt/z_w0", "opt/z_table", "opt/n_w0", "opt/n_table")),
}


def params_path(model_file: str) -> str:
    return os.path.join(os.path.abspath(model_file), "params.npz")


def data_state_path(model_file: str) -> str:
    return os.path.join(os.path.abspath(model_file), "data_state.json")


def restore_data_state(model_file: str) -> Optional[dict]:
    """The saved input position, or None when there is none."""
    try:
        with open(data_state_path(model_file)) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def exists(model_file: str) -> bool:
    return os.path.isfile(params_path(model_file))


def save_params(model_file: str, model: FmModel, step: int = 0,
                opt_state=None, data_state: Optional[dict] = None) -> str:
    """Write ``params.npz`` atomically (temp file + rename), with the
    sparse optimizer state when given, then ``data_state.json`` when
    given; returns the params' path."""
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
    if data_state is not None:
        tmp = data_state_path(model_file) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data_state, f)
        os.replace(tmp, data_state_path(model_file))
    return path


def save_sharded(model_file: str, model_l: FmModel, mesh: Mesh,
                 step: int = 0, opt_state_l=None,
                 data_state: Optional[dict] = None) -> str:
    """Every rank calls this: the ranks of data row 0 send their model
    shards (table and optimizer tables) over the ``model`` axis to rank
    0, which alone assembles the full tables and writes ``params.npz``
    with :func:`save_params`; a barrier holds every rank until the file
    is in place.  On one rank it is :func:`save_params`.  Returns the
    file's path."""
    if mesh.coords[0] == 0:
        def full(t):
            t = t.detach()
            return gather(t, MODEL_AXIS, mesh) if t.dim() == 2 else t

        table = full(model_l.table)
        opt = (type(opt_state_l)(*(full(t) for t in opt_state_l))
               if opt_state_l else opt_state_l)
        if mesh.rank == 0:
            save_params(model_file, FmModel(model_l.w0.detach(), table),
                        step=step, opt_state=opt, data_state=data_state)
    barrier(mesh)
    return params_path(model_file)


def restore_params(
    model_file: str,
    device: Optional[Union[str, torch.device]] = None,
    rows: Optional[slice] = None,
    shape: Optional[tuple] = None,
):
    """``(step, FmModel)`` from ``params.npz`` on ``device`` (the GPU
    unless asked otherwise), the table cut to ``rows`` when given (a
    rank's model shard).  ``shape`` is the full table's shape the caller
    expects; another raises ValueError.  Raises FileNotFoundError when
    the file is absent."""
    with np.load(params_path(model_file), allow_pickle=False) as z:
        step = int(z["scalar/step"])
        w0 = np.float32(z["scalar/w0"])
        table = z["params/table"]
    if shape is not None and tuple(table.shape) != tuple(shape):
        raise ValueError(
            f"checkpoint table is {tuple(table.shape)} but the config "
            f"wants {tuple(shape)}"
        )
    if rows is not None:
        table = table[rows]
    return step, from_jax(w0, table, device=device)


def restore_opt_state(
    model_file: str, optimizer: str,
    device: Optional[Union[str, torch.device]] = None,
    rows: Optional[slice] = None,
):
    """The ``optimizer``'s sparse state from ``params.npz`` on
    ``device``, its tables cut to ``rows`` when given, ``()`` for SGD,
    or None when the file holds none for this optimizer (a serving-only
    checkpoint, or another optimizer's)."""
    if optimizer == "sgd":
        return ()
    kind, keys = _OPT_KEYS[optimizer]
    dev = resolve_device(device)
    with np.load(params_path(model_file), allow_pickle=False) as z:
        if not all(k in z.files for k in keys):
            return None
        arrays = [z[k] for k in keys]
    if rows is not None:
        arrays = [a[rows] if a.ndim == 2 else a for a in arrays]
    return kind(*(torch.from_numpy(np.array(a, np.float32)).to(dev)
                  for a in arrays))
