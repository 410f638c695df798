"""Checkpoint dtype converter: dense fp32 <-> quantized (bf16 / int8).

The counterpart of the reference's ``tools/convert_checkpoint.py``, on
the port's checkpoints:

    python -m fast_tffm_tpu_torch.tools.convert_checkpoint ./fm_model \\
        --to int8 --out ./m8
    python -m fast_tffm_tpu_torch.tools.convert_checkpoint ./m8 \\
        --to fp32 --out ./m32

Reads ``<dir>/params.npz`` or ``<dir>/quant.npz`` (either package's) and
writes the requested format through ``train/checkpoint.py``'s saves, so
the directory holds one format (a ``quant.npz`` save removes
``params.npz`` and the other way round).  fp32 -> bf16/int8 is lossy;
int8 shares one fp32 scale per ``--chunk`` consecutive rows (a server
must set the same ``quant_chunk``).  The tool prints the max |dequant -
fp32| element error and the table bytes before and after.  bf16/int8 ->
fp32 writes a ``params.npz`` of the dequantized table, which a trainer
can warm-start from (it refuses a ``quant.npz``).  The optimizer state
is dropped, as the reference's tool drops it.

A LOSSY in-place conversion (``--to bf16/int8`` without ``--out``)
deletes the fp32 params and optimizer state, so it refuses unless
``--force``.  A ``tiered.npz`` overlay is refused: its rows are deltas
over a deterministic init bound to the training config.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _load_fp32(model_file: str):
    """(step, w0 f32, table f32 [V, D], source dtype) from params.npz or
    quant.npz."""
    from fast_tffm_tpu_torch.ops import quant
    from fast_tffm_tpu_torch.train import checkpoint

    if checkpoint.exists_tiered(model_file):
        raise SystemExit(
            f"{model_file} holds a tiered overlay (tiered.npz): overlay "
            "rows are bound to the training config's deterministic init "
            "and cannot be dtype-converted standalone — retrain with "
            "the desired cold_dtype, or merge to dense first"
        )
    got = checkpoint.restore_quant(model_file)
    if got is not None:
        step, w0, qt = got
        return step, np.float32(w0), quant.dequantize_table(qt), qt.dtype
    if not checkpoint.exists(model_file):
        raise SystemExit(
            f"no convertible checkpoint at {model_file} (neither "
            "params.npz nor quant.npz)"
        )
    with np.load(checkpoint.params_path(model_file),
                 allow_pickle=False) as z:
        step = int(z["scalar/step"])
        w0 = np.float32(z["scalar/w0"])
        table = np.ascontiguousarray(z["params/table"], np.float32)
    return step, w0, table, "fp32"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fast_tffm_tpu_torch.tools.convert_checkpoint",
        description="convert a checkpoint between fp32 and the "
                    "quantized (bf16/int8) dense formats",
    )
    ap.add_argument("model_file", help="checkpoint directory")
    ap.add_argument("--to", required=True,
                    choices=["fp32", "bf16", "int8"], dest="to_dtype",
                    help="target table dtype")
    ap.add_argument("--out", default=None,
                    help="output checkpoint directory (default: convert "
                         "in place)")
    ap.add_argument("--chunk", type=int, default=64,
                    help="int8 scale chunk: this many consecutive rows "
                         "share one fp32 scale (0 = per-row; must match "
                         "the server's quant_chunk)")
    ap.add_argument("--force", action="store_true",
                    help="allow a LOSSY conversion to overwrite its "
                         "own source (in-place --to bf16/int8 deletes "
                         "the fp32 params and optimizer state)")
    args = ap.parse_args(argv)

    in_place = args.out is None or (
        os.path.abspath(args.out) == os.path.abspath(args.model_file)
    )
    if args.to_dtype != "fp32" and in_place and not args.force:
        raise SystemExit(
            "refusing to quantize IN PLACE: this deletes the fp32 "
            "params and optimizer state (only dequantized values "
            "would remain).  Write to a new directory with --out, or "
            "pass --force if you really mean to overwrite"
        )

    from fast_tffm_tpu_torch.ops import quant
    from fast_tffm_tpu_torch.train import checkpoint
    from fast_tffm_tpu_torch.weights import from_jax

    step, w0, table, src_dtype = _load_fp32(args.model_file)
    out = args.out if args.out is not None else args.model_file
    print(
        f"loaded {src_dtype} checkpoint step={step} "
        f"table=[{table.shape[0]}, {table.shape[1]}] from "
        f"{args.model_file}"
    )
    if args.to_dtype == "fp32":
        checkpoint.save_params(out, from_jax(w0, table, device="cpu"),
                               step=step)
        print(
            f"wrote dense fp32 checkpoint ({table.nbytes >> 20} MiB "
            f"table) to {out}"
        )
        if src_dtype != "fp32":
            print(
                "note: a trainer warm-starting from this table resumes "
                "the DEQUANTIZED values (optimizer state reinitializes)"
            )
        return 0
    qt = quant.quantize_table(table, args.to_dtype, args.chunk)
    # Max element error in row blocks: dequantizing the whole table to
    # print one number would double the peak host memory.
    err, block = 0.0, 1 << 20
    for i in range(0, len(table), block):
        ids = np.arange(i, min(i + block, len(table)))
        err = max(err, float(np.abs(
            quant.dequantize_rows(qt, ids) - table[ids]
        ).max()))
    checkpoint.save_quant(out, step, w0, qt)
    ratio = table.nbytes / max(1, qt.nbytes)
    print(
        f"wrote {args.to_dtype} quant.npz to {out}: table "
        f"{table.nbytes} -> {qt.nbytes} bytes ({ratio:.2f}x smaller), "
        f"max |dequant - fp32| element error {err:.3e}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
