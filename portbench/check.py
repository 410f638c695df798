"""The comparison that decides ``correct`` for a training cell.

The program's trainer is driven from the seed through epoch 0 and the
first ``replay`` dispatches of epoch 1 during set-up, by the same
``Trainer.train()`` and dispatch the window then runs.  The plain
reference (``reference/fm.py``) follows the same dispatches from the same
seed and lines, and three numbers are compared, each the worst of its
kind:

- ``loss``: each step's weighted mean data loss, as ``dispatch`` returns
  it, against the reference's: ``|program - reference| / reference``;
- ``grad``: the first dispatch's gradients as Adagrad applied them, worked
  out from the parameters after that dispatch: their change from the
  reference's initial values, as a norm per leaf (``w0`` and the table).
  Adagrad's accumulators would give the gradients more directly, but
  after one dispatch their growth is ~1e-3 of their 0.1 start, float32
  keeps too few of its digits, and a one-ulp difference in a large row
  reads up to ~2e-5 in a sound run;
- ``change``: the parameters' change at the end of the compared
  dispatches from the reference's initial values, as a norm per leaf.

A leaf's gap is ``|program norm - reference norm|`` over the larger of
the reference's norm of that leaf and of the median leaf.  A leaf whose
first change in the reference is under a thousandth of the median
leaf's moves by rounding alone and is left out of both (the rule, not a
name).
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from portbench.reference import fm as ref_fm

__all__ = ["LIMITS", "compare", "diff_norm", "leaf_gap", "reference_run"]

# Each limit lies between the program's largest reading over sound runs
# of every cell and the bf16 control's smallest, with more room above the
# former (PERF.md gives the readings: NVIDIA H100, 21 seeds a cell, 4
# controls).
LIMITS = {"loss": 2e-6, "grad": 4e-6, "change": 2e-6}


def diff_norm(a: torch.Tensor, b: torch.Tensor, rows: int = 1 << 20
              ) -> float:
    """``||a - b||`` in float64, ``rows`` rows at a time, each block of
    ``a`` moved to ``b``'s device (``a`` may be a host copy)."""
    total = 0.0
    for i in range(0, a.shape[0], rows):
        d = a[i:i + rows].to(b.device).double() - b[i:i + rows].double()
        total += float((d * d).sum())
    return math.sqrt(total)


def leaf_gap(program: dict, reference: dict, leaves=None) -> float:
    """The worst leaf's ``|program - reference|`` over the larger of the
    reference's leaf norm and its median leaf norm."""
    med = statistics.median(reference.values())
    keys = reference if leaves is None else leaves
    gaps = [abs(program[k] - reference[k]) / max(reference[k], med, 1e-30)
            for k in keys]
    return max(gaps) if gaps else 0.0


def batches_of(ids: np.ndarray, vals: np.ndarray, labels: np.ndarray,
               idx_list, batch_size: int, max_features: int, device) -> list:
    """Device ``(ids, vals, labels, weights)`` of each batch of lines
    (``idx_list``: their indices; a short batch padded with weight-0
    rows, unused slots id 0 value 0)."""
    nf = ids.shape[1]
    out = []
    for idx in idx_list:
        b_ids = np.zeros((batch_size, max_features), np.int64)
        b_vals = np.zeros((batch_size, max_features), np.float32)
        b_labels = np.zeros(batch_size, np.float32)
        weights = np.zeros(batch_size, np.float32)
        n = len(idx)
        b_ids[:n, :nf] = ids[idx]
        b_vals[:n, :nf] = vals[idx]
        b_labels[:n] = labels[idx]
        weights[:n] = 1.0
        out.append(tuple(torch.from_numpy(a).to(device)
                         for a in (b_ids, b_vals, b_labels, weights)))
    return out


def reference_run(lines, cfg: dict, seed: int, k: int, replay: int,
                  device) -> dict:
    """The reference's readings over the dispatches the program was
    compared on (epoch 0 and ``replay`` more, from the epoch cache or
    streamed, as ``cfg`` says): each step's loss, the first dispatch's
    change leaves, the change leaves at the end, each epoch-0 batch's
    unique ids, and the initial table."""
    vocab = int(cfg["vocabulary_size"])
    bs, mf = int(cfg["batch_size"]), int(cfg["max_features"])
    cached = cfg.get("cache_epochs", "false") == "true"
    prestacked = cached and cfg.get("cache_prestacked", "false") == "true"
    ids = np.stack([(ref_fm.murmur64a(key) % np.uint64(vocab)).astype(
        np.int64) for key in lines.keys], axis=1)
    vals = np.stack(lines.vals, axis=1)
    line_bytes = np.full(lines.text.shape[0], lines.text.shape[1], np.int64)
    windows = ref_fm.raw_windows(line_bytes, bs,
                                 max(int(cfg["shuffle_buffer"]), bs))
    epoch0 = ref_fm.epoch_batches(windows, bs, seed, 0)
    if cached:
        plan = ref_fm.dispatch_batches(epoch0, k, seed, 1 + replay,
                                       prestacked)
    else:
        plan = []
        for epoch in range(1 + replay):
            batches = ref_fm.epoch_batches(windows, bs, seed, epoch)
            plan += [batches[i:i + k] for i in range(0, len(batches), k)]
    plan = plan[:-(-len(epoch0) // k) + replay]
    uniques = []
    for idx in epoch0:
        b = np.zeros((bs, mf), np.int64)
        b[:len(idx), :ids.shape[1]] = ids[idx]
        uniques.append(int(np.unique(b).size))
    ref = ref_fm.FmReference(cfg, device)
    ref.init(seed)
    t0 = ref.table.clone()
    losses, grad = [], None
    for i, group in enumerate(plan):
        for batch in batches_of(ids, vals, lines.labels, group, bs, mf,
                                device):
            losses.append(ref.step(*batch))
        if i == 0:
            grad = {"w0": abs(float(ref.w0)),
                    "table": diff_norm(ref.table, t0)}
    change = {"w0": abs(float(ref.w0)), "table": diff_norm(ref.table, t0)}
    return {"losses": losses, "grad": grad, "change": change,
            "uniques": uniques, "table_start": t0}


def compare(program: dict, reference: dict) -> dict:
    """``{name: (reading, limit)}`` of the three numbers."""
    rl, pl = reference["losses"], program["losses"]
    if len(pl) != len(rl):
        loss = math.inf
    else:
        loss = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(pl, rl))
    grad_ref = reference["grad"]
    med = statistics.median(grad_ref.values())
    moved = [k for k, v in grad_ref.items() if v >= 1e-3 * med]
    readings = {
        "loss": loss,
        "grad": leaf_gap(program["grad"], grad_ref, moved),
        "change": leaf_gap(program["change"], reference["change"], moved),
    }
    return {k: (v, LIMITS[k]) for k, v in readings.items()}
