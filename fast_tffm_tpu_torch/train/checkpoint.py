"""Plain-numpy checkpoints under ``<model_file>``: ``params.npz``,
``quant.npz`` and ``tiered.npz``.

``params.npz`` is the port's dense checkpoint.  Its keys follow the
conventions of the reference's ``quant.npz``
(``fast_tffm_tpu/train/checkpoint.py::save_quant``):

    scalar/step   int64   training step the parameters belong to
    scalar/w0     float32 global bias (0-d)
    params/table  float32 [vocab, D] table

A trainer's save adds its optimizer state, so a warm start resumes
exactly (serving reads only the keys above).  The sparse and the dense
step (``train/optimizers.py``) keep Adagrad's and FTRL's state with one
meaning, so either warm-starts from the other's file:

    opt/acc_w0, opt/acc_table                 Adagrad (optax's
                                              sum_of_squares when dense)
    opt/z_w0, opt/z_table, opt/n_w0, opt/n_table   FTRL
    (none)                                    SGD
    opt/mu_w0, opt/mu_table, opt/nu_w0, opt/nu_table   Adam (dense only)
    opt/count                        int32    Adam's step count

Beside it a trainer writes ``data_state.json``, the input position of
the saved step (the reference's keys: ``epoch``, ``batches_done`` and
the stream's ``fingerprint``), so a warm start continues the stream
where the saved run stopped (:func:`restore_data_state`).

A multi-rank trainer writes the same file (:func:`save_sharded`: rank
0 gathers the model shards over the ``model`` axis) and each rank reads
its own rows of it (``rows=``), so a checkpoint moves freely between
one rank and many, and ``predict`` and ``serve`` read it unchanged.

The two numpy formats of the reference, read and written with the
reference's keys, so either package reads what the other wrote:

- ``quant.npz``, the quantized dense serving table (bf16, or int8 with
  per-chunk scales; ``ops/quant.py``): ``scalar/step``, ``scalar/w0``,
  ``quant/codes`` (int8, or the bf16 bits as uint16), ``quant/scales``
  (int8 only) and ``quant/descriptor`` (sorted-key JSON: dtype, vocab,
  dim, chunk);
- ``tiered.npz`` (or a complete ``tiered.shard{s}of{S}.npz`` set), the
  sparse overlay of a tiered table too large for the dense format
  (``train/tiered.py``): ``scalar/step``, ``scalar/<name>``,
  ``meta/stores`` and per store ``<store>/ids``, ``<store>/rows`` (packed
  by the cold dtype) and ``<store>/descriptor`` (JSON).

The three formats are mutually exclusive: each save removes the other
two, so a stale file never shadows a newer one (the readers check
``tiered.npz``, then ``quant.npz``, then ``params.npz``).  The
reference's saves also publish a hot-swap manifest; that belongs to the
checkpoint watcher (ROADMAP.md, port queue item 4) and is not written
here.  The tiered trainer saves through :func:`save_params` (a logical
table small enough for the dense format) or :func:`save_tiered`, both
with ``data_state.json``, and warm-starts from a dense checkpoint
through :func:`restore_host` (host numpy, never at ``[V, D]`` on the
card).  Still missing (port queue item 2): the reader of the
reference's Orbax dense checkpoint.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional, Union

import numpy as np
import torch

from fast_tffm_tpu_torch.models.fm import FmModel
from fast_tffm_tpu_torch.ops import quant
from fast_tffm_tpu_torch.parallel.mesh import (
    MODEL_AXIS, Mesh, barrier, gather,
)
from fast_tffm_tpu_torch.platform import resolve_device
from fast_tffm_tpu_torch.train.optimizers import AdamState
from fast_tffm_tpu_torch.train.sparse import SparseAdagradState, SparseFtrlState
from fast_tffm_tpu_torch.weights import from_jax, to_numpy

__all__ = ["clear_quant", "clear_tiered", "data_state_path", "exists",
           "exists_quant", "exists_tiered", "params_path", "quant_path",
           "restore_data_state", "restore_host", "restore_opt_state",
           "restore_params",
           "restore_quant", "restore_tiered", "save_params", "save_quant",
           "save_sharded", "save_tiered", "tiered_path"]

# optimizer -> (state type, its checkpoint keys in field order)
_OPT_KEYS = {
    "adagrad": (SparseAdagradState, ("opt/acc_w0", "opt/acc_table")),
    "ftrl": (SparseFtrlState,
             ("opt/z_w0", "opt/z_table", "opt/n_w0", "opt/n_table")),
    "adam": (AdamState, ("opt/mu_w0", "opt/mu_table", "opt/nu_w0",
                         "opt/nu_table", "opt/count")),
}


def _host(a) -> np.ndarray:
    """An optimizer leaf as saved: float32, or int32 for Adam's count."""
    a = np.asarray(a)
    return np.array(a, np.int32 if a.dtype.kind in "iu" else np.float32)


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
    optimizer state when given, removes a stale ``quant.npz`` and
    ``tiered.npz``, then writes ``data_state.json`` when given; returns
    the params' path."""
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
                arrays[key] = _host(t.detach().cpu().numpy())
    _write_npz(path, arrays)
    # params.npz is the checkpoint now: a stale overlay or quantized
    # table must not shadow it (the readers check those first).
    clear_tiered(model_file)
    clear_quant(model_file)
    _write_data_state(model_file, data_state)
    return path


def _write_data_state(model_file: str, data_state: Optional[dict]) -> None:
    """``data_state.json`` written atomically, when given."""
    if data_state is not None:
        tmp = data_state_path(model_file) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data_state, f)
        os.replace(tmp, data_state_path(model_file))


def _write_npz(path: str, arrays: dict) -> None:
    """``np.savez`` to a temp file, then rename over ``path``."""
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _clear_params(model_file: str) -> None:
    try:
        os.remove(params_path(model_file))
    except FileNotFoundError:
        pass


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


def restore_host(model_file: str, optimizer: str) -> tuple:
    """``(step, w0, table, opt)`` from ``params.npz`` as host numpy, never
    on a device (the tiered trainer's warm start): ``opt`` is the
    ``optimizer``'s state over numpy arrays, ``()`` for SGD, or None
    when the file holds none for it."""
    with np.load(params_path(model_file), allow_pickle=False) as z:
        step = int(z["scalar/step"])
        w0 = np.float32(z["scalar/w0"])
        table = np.array(z["params/table"], np.float32)
        opt = None
        if optimizer == "sgd":
            opt = ()
        else:
            kind, keys = _OPT_KEYS[optimizer]
            if all(k in z.files for k in keys):
                opt = kind(*(_host(z[k]) for k in keys))
    return step, w0, table, opt


def restore_opt_state(
    model_file: str, optimizer: str,
    device: Optional[Union[str, torch.device]] = None,
    rows: Optional[slice] = None,
):
    """The ``optimizer``'s state from ``params.npz`` on ``device``, its
    tables cut to ``rows`` when given, ``()`` for SGD, or None when the
    file holds none for this optimizer (a serving-only checkpoint, or
    another optimizer's)."""
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
    return kind(*(torch.from_numpy(_host(a)).to(dev) for a in arrays))


# ----------------------------------------------------------------------
# Dense QUANTIZED checkpoint (quant.npz): bf16 / int8-with-scales table
# ----------------------------------------------------------------------


def quant_path(model_file: str) -> str:
    return os.path.join(os.path.abspath(model_file), "quant.npz")


def exists_quant(model_file: str) -> bool:
    return os.path.isfile(quant_path(model_file))


def save_quant(model_file: str, step: int, w0,
               qt: "quant.QuantTable") -> str:
    """Write ``quant.npz`` (the compact serving format the convert tool
    writes and the serving ladder places as its device table) and remove
    ``params.npz`` and any tiered overlay.  Returns its path."""
    path = quant_path(model_file)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "scalar/step": np.int64(step),
        "scalar/w0": np.asarray(w0, np.float32),
        "quant/descriptor": np.array(
            json.dumps(qt.descriptor(), sort_keys=True)
        ),
    }
    for name, arr in quant.table_to_arrays(qt).items():
        payload[f"quant/{name}"] = arr
    _write_npz(path, payload)
    _clear_params(model_file)
    clear_tiered(model_file)
    return path


def restore_quant(model_file: str) -> Optional[tuple]:
    """``(step, w0, QuantTable)`` from ``quant.npz``, or None."""
    path = quant_path(model_file)
    if not os.path.isfile(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        step = int(z["scalar/step"])
        w0 = float(z["scalar/w0"])
        descriptor = json.loads(str(z["quant/descriptor"]))
        arrays = {
            k.split("/", 1)[1]: z[k]
            for k in z.files
            if k.startswith("quant/") and k != "quant/descriptor"
        }
    return step, w0, quant.table_from_arrays(descriptor, arrays)


def clear_quant(model_file: str) -> None:
    """Remove a stale ``quant.npz`` after a dense or tiered save."""
    try:
        os.remove(quant_path(model_file))
    except FileNotFoundError:
        pass


# ----------------------------------------------------------------------
# Sparse-overlay checkpoint (tiered.npz, or a rank-sharded set)
# ----------------------------------------------------------------------


def tiered_path(model_file: str) -> str:
    return os.path.join(os.path.abspath(model_file), "tiered.npz")


def _tiered_shard_files(model_file: str) -> list:
    """[(index, count, path)] of every per-shard overlay file present."""
    out = []
    pat = re.compile(r"tiered\.shard(\d+)of(\d+)\.npz$")
    for p in sorted(glob.glob(
        os.path.join(os.path.abspath(model_file), "tiered.shard*.npz")
    )):
        m = pat.search(p)
        if m:
            out.append((int(m.group(1)), int(m.group(2)), p))
    return out


def exists_tiered(model_file: str) -> bool:
    return os.path.isfile(tiered_path(model_file)) or bool(
        _tiered_shard_files(model_file)
    )


def save_tiered(model_file: str, step: int, scalars: dict,
                stores: dict, data_state: Optional[dict] = None) -> str:
    """Write ``tiered.npz``: ``scalars`` (``w0`` and the optimizer's w0
    slots) as ``scalar/<name>``, and for each store of ``stores`` (name
    -> ``{"ids", "rows", "descriptor"}``, a ``ColdStore.export()`` plus
    its descriptor) the ids and packed rows of every written row and
    the init descriptor that regenerates the rest.  Removes
    ``params.npz`` and ``quant.npz``, then writes ``data_state.json``
    when given.  Returns the file's path."""
    path = tiered_path(model_file)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload: dict = {
        "scalar/step": np.int64(step),
        "meta/stores": np.array(json.dumps(sorted(stores))),
    }
    for name, val in scalars.items():
        payload[f"scalar/{name}"] = np.asarray(val)
    for name, store in stores.items():
        payload[f"{name}/ids"] = store["ids"]
        payload[f"{name}/rows"] = store["rows"]
        payload[f"{name}/descriptor"] = np.array(
            json.dumps(store.get("descriptor", {}), sort_keys=True)
        )
    _write_npz(path, payload)
    _clear_params(model_file)
    clear_quant(model_file)
    _write_data_state(model_file, data_state)
    return path


def _read_tiered_file(path: str) -> tuple:
    with np.load(path, allow_pickle=False) as z:
        names = json.loads(str(z["meta/stores"]))
        step = int(z["scalar/step"])
        scalars = {
            k.split("/", 1)[1]: z[k]
            for k in z.files
            if k.startswith("scalar/") and k != "scalar/step"
        }
        stores = {}
        for name in names:
            stores[name] = {
                "ids": z[f"{name}/ids"],
                "rows": z[f"{name}/rows"],
                "descriptor": json.loads(str(z[f"{name}/descriptor"])),
            }
    return step, scalars, stores


def restore_tiered(model_file: str) -> Optional[tuple]:
    """``(step, scalars, stores)`` from ``tiered.npz`` or a complete
    shard set (its per-store payloads concatenated into one global-id
    overlay), or None.  A shard set that mixes shard counts, misses a
    shard, or disagrees on the step or a descriptor raises ValueError."""
    path = tiered_path(model_file)
    if os.path.isfile(path):
        return _read_tiered_file(path)
    shard_files = _tiered_shard_files(model_file)
    if not shard_files:
        return None
    counts = {c for _, c, _ in shard_files}
    if len(counts) != 1:
        raise ValueError(
            f"tiered shard checkpoint in {model_file} mixes shard counts "
            f"{sorted(counts)}; remove the stale set"
        )
    count = counts.pop()
    have = {s for s, _, _ in shard_files}
    missing = sorted(set(range(count)) - have)
    if missing:
        raise ValueError(
            f"tiered shard checkpoint in {model_file} is missing shards "
            f"{missing} of {count}; refusing a partial-table restore"
        )
    step = scalars = None
    merged: dict = {}
    for s, _, p in sorted(shard_files):
        f_step, f_scalars, f_stores = _read_tiered_file(p)
        if step is None:
            step, scalars = f_step, f_scalars
        elif f_step != step:
            raise ValueError(
                f"tiered shard files in {model_file} disagree on step "
                f"({f_step} != {step}); the save was torn"
            )
        for name, payload in f_stores.items():
            acc = merged.setdefault(
                name, {"ids": [], "rows": [],
                       "descriptor": payload["descriptor"]}
            )
            if payload["descriptor"] != acc["descriptor"]:
                raise ValueError(
                    f"tiered shard files disagree on store {name!r} "
                    "descriptor; the save mixed configs"
                )
            acc["ids"].append(payload["ids"])
            acc["rows"].append(payload["rows"])
    stores = {
        name: {
            "ids": np.concatenate(acc["ids"]),
            "rows": np.concatenate(acc["rows"]),
            "descriptor": acc["descriptor"],
        }
        for name, acc in merged.items()
    }
    return step, scalars, stores


def clear_tiered(model_file: str) -> None:
    """Remove a stale overlay (single file and shard set) after a dense
    or quantized save."""
    paths = [tiered_path(model_file)] + [
        p for _, _, p in _tiered_shard_files(model_file)]
    for p in paths:
        try:
            os.remove(p)
        except FileNotFoundError:
            pass
