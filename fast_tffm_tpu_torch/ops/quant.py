"""Quantized embedding-row storage: bf16 / int8-with-fp32-scales.

The counterpart of ``fast_tffm_tpu/ops/quant.py``: the one place the
row formats live; the tiered cold store (``train/tiered.py``), the
``quant.npz`` checkpoint (``train/checkpoint.py``), the serving ladder
(``serve/scorer.py``) and the convert tool compose these primitives.

- ``bf16``: rows stored as bfloat16 (half the bytes), no scales.  The
  host keeps bf16 as its raw ``uint16`` bits (numpy has no bfloat16):
  :func:`f32_to_bf16_bits` rounds to nearest even exactly as
  ``ml_dtypes.bfloat16`` does (NaN becomes the sign's quiet NaN), and
  :func:`bf16_bits_to_f32` widens exactly.  On the device the same bits
  are a ``torch.bfloat16`` tensor.
- ``int8``: symmetric linear quantization with float32 scales, scale =
  max|x| / 127 over a scale group, codes = round(x / scale) in
  [-127, 127]; an all-zero group stores scale 0 and reproduces exactly.
  DENSE tables (the serving table, ``quant.npz``) share one scale per
  chunk of ``quant_chunk`` consecutive rows (:class:`QuantTable`; chunk
  0 or 1 = one scale per row): 9 + 4/64 B/row at D = 9 and chunk 64.
  The tiered COLD store keeps one scale per row (rows migrate one at a
  time): D + 4 B/row.

Two representations: UNPACKED ``(codes, scales)`` arrays for compute,
and PACKED uint8 ``[n, bytes_per_row]`` rows for row-granular storage
(:class:`RowCodec`); fp32 is the identity codec.

Quantization is host-side numpy, as in the reference, so codes, scales
and bf16 bits are bitwise the reference's.  :func:`dequant_gathered`
widens gathered rows on the device (the reference's XLA cast and
multiply after the gather; no Pallas kernel there, so none here).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "DTYPES", "QuantTable", "RowCodec", "bf16_bits_to_f32",
    "bf16_bits_to_torch", "cold_codec", "dequant_gathered",
    "dequantize_int8", "dequantize_rows", "dequantize_table",
    "f32_to_bf16_bits", "quantize_int8", "quantize_table",
    "table_from_arrays", "table_to_arrays", "validate_dtype",
]

DTYPES = ("fp32", "bf16", "int8")


def validate_dtype(dtype: str, what: str = "dtype") -> str:
    if dtype not in DTYPES:
        raise ValueError(f"unknown {what} {dtype!r} (one of {DTYPES})")
    return dtype


def f32_to_bf16_bits(x) -> np.ndarray:
    """f32 array -> its bfloat16 bits (uint16, same shape), rounded to
    nearest even; a NaN becomes 0x7FC0 or 0xFFC0 by its sign."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    bias = ((u >> np.uint32(16)) & np.uint32(1)) + np.uint32(0x7FFF)
    bits = ((u + bias) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        bits[nan] = np.where(np.signbit(x[nan]), 0xFFC0, 0x7FC0)
    return bits


def bf16_bits_to_f32(bits) -> np.ndarray:
    """bfloat16 bits (uint16) -> f32, exactly."""
    bits = np.ascontiguousarray(bits, np.uint16)
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def bf16_bits_to_torch(bits: np.ndarray) -> torch.Tensor:
    """bfloat16 bits (uint16) -> a ``torch.bfloat16`` CPU tensor sharing
    no memory with ``bits``."""
    return torch.from_numpy(
        np.array(bits, np.uint16).view(np.int16)).view(torch.bfloat16)


def _group_of(n: int, chunk: int) -> np.ndarray:
    """[n] i64: which scale group each row belongs to."""
    if chunk <= 1:
        return np.arange(n, dtype=np.int64)
    return np.arange(n, dtype=np.int64) // chunk


def quantize_int8(rows: np.ndarray, chunk: int = 0) -> tuple:
    """f32 [n, dim] -> (codes int8 [n, dim], scales f32 [G]).

    ``chunk`` consecutive rows share a scale (G = ceil(n/chunk));
    chunk <= 1 = one scale per row (G = n).  Symmetric: the largest
    |element| of a group maps to ±127.
    """
    rows = np.asarray(rows, np.float32)
    n = len(rows)
    per_row = np.abs(rows).max(axis=1) if rows.size else np.zeros(
        (0,), np.float32
    )
    if chunk <= 1:
        amax = per_row
    elif n == 0:
        amax = np.zeros(0, np.float32)
    else:
        # Group max over the rows padded to a chunk multiple (zeros
        # never win a max of absolutes).
        g = -(-n // chunk)
        pad = g * chunk - n
        padded = np.pad(per_row, (0, pad)) if pad else per_row
        amax = padded.reshape(g, chunk).max(axis=1)
    scales = amax / np.float32(127.0)
    safe = np.where(scales > 0, scales, np.float32(1.0))
    codes = np.clip(
        np.rint(rows / safe[_group_of(n, chunk), None]), -127, 127
    ).astype(np.int8)
    return codes, scales.astype(np.float32)


def dequantize_int8(codes: np.ndarray, scales: np.ndarray,
                    chunk: int = 0) -> np.ndarray:
    return codes.astype(np.float32) * scales[
        _group_of(len(codes), chunk), None
    ]


def dequant_gathered(codes_rows: torch.Tensor,
                     scale_rows: torch.Tensor) -> torch.Tensor:
    """Widen gathered int8 rows: ``codes_rows`` int8 ``[..., dim]`` (from
    ``codes[ids]``), ``scale_rows`` f32 ``[...]`` (from ``scales[ids //
    chunk]``) -> f32 ``[..., dim]``, one cast and one multiply."""
    return codes_rows.float() * scale_rows.unsqueeze(-1)


# ----------------------------------------------------------------------
# Dense quantized tables (serving ladder + quant.npz checkpoint)
# ----------------------------------------------------------------------


class QuantTable(NamedTuple):
    """One host-side quantized dense table.

    ``codes``: int8 [V, dim] (int8) or the bfloat16 bits as uint16
    [V, dim] (bf16); ``scales``: f32 [ceil(V/chunk)] for int8, None for
    bf16."""

    dtype: str
    chunk: int
    codes: np.ndarray
    scales: Optional[np.ndarray]

    @property
    def nbytes(self) -> int:
        return int(self.codes.nbytes) + (
            int(self.scales.nbytes) if self.scales is not None else 0
        )

    def descriptor(self) -> dict:
        d = {
            "dtype": self.dtype,
            "vocab": int(self.codes.shape[0]),
            "dim": int(self.codes.shape[1]),
        }
        if self.dtype == "int8":
            d["chunk"] = int(self.chunk)
        return d


def quantize_table(table: np.ndarray, dtype: str,
                   chunk: int = 0) -> QuantTable:
    """f32 [V, dim] -> :class:`QuantTable` (``dtype`` bf16 or int8)."""
    validate_dtype(dtype)
    if dtype == "fp32":
        raise ValueError("fp32 tables are not quantized; use the array")
    table = np.ascontiguousarray(table, np.float32)
    if dtype == "bf16":
        return QuantTable("bf16", 0, f32_to_bf16_bits(table), None)
    codes, scales = quantize_int8(table, chunk)
    return QuantTable("int8", chunk, codes, scales)


def dequantize_table(qt: QuantTable) -> np.ndarray:
    if qt.dtype == "bf16":
        return bf16_bits_to_f32(qt.codes)
    return dequantize_int8(qt.codes, qt.scales, qt.chunk)


def dequantize_rows(qt: QuantTable, ids: np.ndarray) -> np.ndarray:
    """f32 rows for ``ids`` (any shape) without dequantizing the whole
    table: O(len(ids)) work and memory."""
    codes = qt.codes[ids]
    if qt.dtype == "bf16":
        return bf16_bits_to_f32(codes)
    scales = qt.scales[ids // qt.chunk if qt.chunk > 1 else ids]
    return codes.astype(np.float32) * scales[..., None]


def table_to_arrays(qt: QuantTable) -> dict:
    """npz-safe arrays (bf16 codes as their uint16 bits)."""
    out = {"codes": qt.codes}
    if qt.scales is not None:
        out["scales"] = qt.scales
    return out


def table_from_arrays(descriptor: dict, arrays: dict) -> QuantTable:
    dtype = descriptor["dtype"]
    codes = arrays["codes"]
    if dtype == "bf16":
        codes = codes.view(np.uint16)
    return QuantTable(
        dtype, int(descriptor.get("chunk", 0)), codes,
        arrays.get("scales"),
    )


# ----------------------------------------------------------------------
# Row-granular packed storage (the tiered cold store)
# ----------------------------------------------------------------------


class RowCodec:
    """Encode/decode one row-block format (see module docstring).

    int8 rows pack a PER-ROW fp32 scale after the codes, so one packed
    row is ``dim + 4`` bytes; bf16 rows are ``2 * dim`` bytes; fp32 rows
    pass through as float32.
    """

    def __init__(self, dtype: str, dim: int):
        validate_dtype(dtype)
        self.dtype = dtype
        self.dim = dim
        if dtype == "fp32":
            self.bytes_per_row = 4 * dim
            self.width = dim
            self.storage_dtype = np.dtype(np.float32)
        elif dtype == "bf16":
            self.bytes_per_row = 2 * dim
            self.width = self.bytes_per_row
            self.storage_dtype = np.dtype(np.uint8)
        else:  # int8 + one f32 scale
            self.bytes_per_row = dim + 4
            self.width = self.bytes_per_row
            self.storage_dtype = np.dtype(np.uint8)

    def empty(self, n: int) -> np.ndarray:
        return np.empty((n, self.width), self.storage_dtype)

    def encode(self, rows: np.ndarray) -> np.ndarray:
        """f32 [n, dim] -> packed [n, width] (always a fresh array)."""
        rows = np.ascontiguousarray(rows, np.float32)
        if self.dtype == "fp32":
            return rows.copy()
        if self.dtype == "bf16":
            return f32_to_bf16_bits(rows).view(np.uint8).reshape(
                len(rows), self.width)
        codes, scales = quantize_int8(rows, 0)
        packed = np.empty((len(rows), self.width), np.uint8)
        packed[:, :self.dim] = codes.view(np.uint8)
        packed[:, self.dim:] = np.ascontiguousarray(
            scales
        ).view(np.uint8).reshape(len(rows), 4)
        return packed

    def decode(self, packed: np.ndarray) -> np.ndarray:
        """packed [n, width] -> f32 [n, dim].  fp32 is the identity (no
        copy: dense-path callers rely on fancy indexing having copied
        already)."""
        if self.dtype == "fp32":
            return packed
        if self.dtype == "bf16":
            return bf16_bits_to_f32(
                np.ascontiguousarray(packed).view(np.uint16))
        packed = np.ascontiguousarray(packed)
        codes = packed[:, :self.dim].view(np.int8)
        scales = np.ascontiguousarray(packed[:, self.dim:]).view(
            np.float32
        ).reshape(len(packed))
        return codes.astype(np.float32) * scales[:, None]

    def descriptor(self) -> dict:
        """The format identity an overlay checkpoint carries and a
        restore must match: {} for fp32, else ``{"dtype": ...}``."""
        return {} if self.dtype == "fp32" else {"dtype": self.dtype}

    def __repr__(self) -> str:
        return f"RowCodec({self.dtype}, dim={self.dim})"


def cold_codec(cfg) -> RowCodec:
    """The cold-store row codec an FmConfig implies."""
    return RowCodec(cfg.cold_dtype, cfg.embedding_dim)
