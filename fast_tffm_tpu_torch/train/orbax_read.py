"""Reader of the JAX package's Orbax dense checkpoints, without jax.

``fast_tffm_tpu/train/checkpoint.py::save`` writes ``<model_file>/params``
(the model and its step) and ``<model_file>/opt`` (the optimizer state)
as Orbax checkpoints.  This module reads both with numpy, ``ctypes``,
``json``, ``struct`` and the system's ``libzstd.so.1`` alone: it is the
counterpart of the reference's ``checkpoint.exists``, ``restore_params``
and ``restore_opt``.  It is built in four layers, each usable alone:

1. **zstd** (:func:`zstd_decompress`): one-shot decompression through
   ``libzstd.so.1`` into a preallocated numpy buffer, sized from the
   frame header or, for a streamed frame that carries no content size,
   by the caller (a zarr chunk's shape times its item size).  A missing
   library raises OSError naming it; nothing falls back.
2. **OCDBT** (:class:`OcdbtStore`), tensorstore's key-value store
   format: the manifest at the directory's root names the versions of a
   b-tree; the latest version's root node is followed down through the
   interior nodes (their keys prefix-compressed, each child's keys
   relative to its subtree's common prefix) to the leaves, whose values
   are inline bytes or a (data file, offset, length) slice.  Every
   manifest and node file is an envelope (magic, length, format version,
   compression, a CRC-32C at its end) that is checked; a data file is
   named by a base path and a relative path, the base composed with that
   of the node that names it, so a root under ``d/`` reaches the nodes
   Orbax wrote under ``ocdbt.process_<N>/d/``.  An unknown version,
   compression or manifest kind raises ValueError naming it.
3. **zarr v2** (:func:`read_array`): ``.zarray`` (``<f4``, ``<i4`` or
   ``<i8``, C order, the ``zstd`` compressor or none, no filters) and its
   chunks ``i.j`` (``0`` for a 0-d array), each chunk's own zstd frame
   inside the OCDBT value, edge chunks clipped and an absent chunk taking
   ``fill_value``.  ``rows=`` reads only the chunks that cover those
   rows; a chunk that is the whole array decompresses straight into the
   result.
4. **The pytree** (:func:`read_params`, :func:`read_opt`): ``_METADATA``'s
   ``tree_metadata`` paths mapped to the port's fields.  ``params`` holds
   ``step``, ``params.w0`` and ``params.table``; ``opt`` holds the state
   of whichever optimizer saved it (the sparse step's
   ``SparseAdagradState(acc)`` or ``SparseFtrlState(z, n)``, optax's
   Adagrad, the reference's ``FtrlState``, Adam's ``(count, mu, nu)``
   with an int32 count, or SGD's empty state).  As the reference's
   ``restore_opt`` returns None for a tree that is not the trainer's
   (another optimizer's, or the sparse step's where the dense one is
   wanted), :func:`read_opt` does; a path no optimizer writes raises
   ValueError.

The OCDBT format is tensorstore's, as its documentation describes it.
"""

from __future__ import annotations

import ctypes
import json
import mmap
import os
import struct
from typing import Optional

import numpy as np

__all__ = ["OcdbtStore", "exists", "opt_dir", "params_dir", "read_array",
           "read_opt", "read_params", "zstd_decompress"]

ZSTD_LIBRARY = "libzstd.so.1"


def params_dir(model_file: str) -> str:
    return os.path.join(os.path.abspath(model_file), "params")


def opt_dir(model_file: str) -> str:
    return os.path.join(os.path.abspath(model_file), "opt")


def exists(model_file: str) -> bool:
    """An Orbax ``params`` directory that holds anything (the
    reference's ``checkpoint.exists``)."""
    d = params_dir(model_file)
    return os.path.isdir(d) and bool(os.listdir(d))


# ----------------------------------------------------------------------
# 1. zstd through the system library
# ----------------------------------------------------------------------

_ZSTD = None
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2


def _zstd():
    global _ZSTD
    if _ZSTD is None:
        try:
            lib = ctypes.CDLL(ZSTD_LIBRARY)
        except OSError as e:
            raise OSError(
                f"reading an Orbax checkpoint needs the system zstd "
                f"library {ZSTD_LIBRARY}, which could not be loaded: {e}"
            ) from None
        size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ptr, size_t]
        lib.ZSTD_decompress.restype = size_t
        lib.ZSTD_decompress.argtypes = [ptr, size_t, ptr, size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [size_t]
        _ZSTD = lib
    return _ZSTD


def zstd_decompress(src, out: Optional[np.ndarray] = None,
                    capacity: Optional[int] = None) -> np.ndarray:
    """Decompress the zstd frame ``src`` (bytes or a uint8 array) in one
    call.  Into ``out`` (a C-contiguous array whose bytes must be exactly
    the content) when given; else into a new uint8 array of the frame's
    content size or, for a frame that does not carry it, of at most
    ``capacity`` bytes (the result is cut to what was written)."""
    lib = _zstd()
    src = np.frombuffer(src, np.uint8) if not isinstance(
        src, np.ndarray) else src
    size = lib.ZSTD_getFrameContentSize(src.ctypes.data, src.nbytes)
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("not a zstd frame")
    exact = size != _CONTENTSIZE_UNKNOWN
    if out is not None:
        if not out.flags.c_contiguous:
            raise ValueError("zstd output buffer must be C-contiguous")
        dst = out.reshape(-1).view(np.uint8)
        if exact and size != dst.nbytes:
            raise ValueError(
                f"zstd frame holds {size} bytes, the buffer {dst.nbytes}")
        exact = True
    elif exact:
        dst = np.empty(size, np.uint8)
    elif capacity is None:
        raise ValueError("zstd frame carries no content size; give one")
    else:
        # Untouched pages of a large empty array cost no memory.
        dst = np.empty(capacity, np.uint8)
    got = lib.ZSTD_decompress(dst.ctypes.data, dst.nbytes, src.ctypes.data,
                              src.nbytes)
    if lib.ZSTD_isError(got):
        raise ValueError(
            f"zstd: {lib.ZSTD_getErrorName(got).decode()}")
    if exact and got != dst.nbytes:
        raise ValueError(
            f"zstd frame held {got} bytes, {dst.nbytes} expected")
    return out if out is not None else (dst if exact else dst[:got].copy())


# ----------------------------------------------------------------------
# 2. the OCDBT key-value store
# ----------------------------------------------------------------------

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_MANIFEST_CAPACITY = 1 << 26  # a manifest is a few KB; a generous cap
_EMPTY = (1 << 64) - 1  # the root reference of an empty tree


def _crc32c_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of a manifest or node envelope (a few KB)."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Cursor:
    """Little-endian varints, bytes and fixed-width integers out of one
    decoded envelope body; any read past its end raises ValueError."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise ValueError(f"OCDBT {self.what} is truncated")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"OCDBT {self.what} holds an overlong varint")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def fixed(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _envelope(data: bytes, magic: int, what: str, capacity: int) -> bytes:
    """The body of a manifest or node envelope: magic (big-endian u32),
    total length (u64), format version and compression (varints), the
    body, a CRC-32C of everything before it (u32)."""
    if len(data) < 18:
        raise ValueError(f"OCDBT {what} is truncated ({len(data)} bytes)")
    got_magic, length = struct.unpack(">I", data[:4])[0], struct.unpack(
        "<Q", data[4:12])[0]
    if got_magic != magic:
        raise ValueError(
            f"OCDBT {what}: magic {got_magic:#010x}, want {magic:#010x}")
    if length != len(data):
        raise ValueError(
            f"OCDBT {what}: header says {length} bytes, found {len(data)}")
    if struct.unpack("<I", data[-4:])[0] != _crc32c(data[:-4]):
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    head = _Cursor(data[12:-4], what)
    version = head.varint()
    if version != 0:
        raise ValueError(f"unknown OCDBT {what} format version {version}")
    compression = head.varint()
    body = data[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body, capacity=capacity).tobytes()
    raise ValueError(f"unknown OCDBT {what} compression {compression}")


def _data_file_table(c: _Cursor) -> list:
    """[(base_path, relative_path)], the paths prefix-compressed against
    the previous one."""
    n = c.varint()
    prefix = [0] + c.varints(max(0, n - 1))
    suffix = c.varints(n)
    base = c.varints(n)
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {c.what}: bad data file path prefix")
        path = prev[:prefix[i]] + c.take(suffix[i])
        if base[i] > len(path):
            raise ValueError(f"OCDBT {c.what}: bad data file base path")
        out.append((path[:base[i]].decode(), path[base[i]:].decode()))
        prev = path
    return out


def _keys(c: _Cursor, n: int, interior: bool) -> tuple:
    """Node-local keys (prefix-compressed against the previous one) and,
    for an interior node, each child's subtree common prefix length."""
    prefix = [0] + c.varints(max(0, n - 1))
    suffix = c.varints(n)
    common = c.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {c.what}: bad key prefix")
        prev = prev[:prefix[i]] + c.take(suffix[i])
        keys.append(prev)
    return keys, common


class OcdbtStore:
    """The keys and values of an OCDBT database at ``root`` (one Orbax
    checkpoint directory), as of its latest version."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._values: dict = {}
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            data = f.read()
        c = _Cursor(_envelope(data, _MANIFEST_MAGIC, "manifest",
                              _MANIFEST_CAPACITY), "manifest")
        c.take(16)  # the database's uuid
        kind = c.varint()
        if kind != 0:
            raise ValueError(
                f"unknown OCDBT manifest kind {kind} in {path} (only the "
                "single-file manifest Orbax writes is read)")
        c.varint()  # max_inline_value_bytes
        self._node_capacity = c.varint()  # max_decoded_node_bytes
        c.byte()  # version_tree_arity_log2
        method = c.varint()
        if method == 1:
            c.fixed("<i")  # the zstd level
        elif method != 0:
            raise ValueError(f"unknown OCDBT compression method {method}")
        files = _data_file_table(c)
        n = c.varint()
        if n == 0:
            raise ValueError(f"OCDBT manifest {path} names no version")
        gens = c.varints(n)
        heights = [c.byte() for _ in range(n)]
        file_ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
        num_keys = c.varints(n)
        # The older versions' subtrees are not read: only the latest.
        latest = max(range(n), key=gens.__getitem__)
        self.generation = gens[latest]
        if lengths[latest] != _EMPTY:
            self._walk(files, "", file_ids[latest], offsets[latest],
                       lengths[latest], heights[latest], b"")
        if len(self._values) != num_keys[latest]:
            raise ValueError(
                f"OCDBT {path}: the latest version counts "
                f"{num_keys[latest]} keys, its tree holds "
                f"{len(self._values)}")

    def _file(self, files: list, base: str, file_id: int) -> tuple:
        """(path on disk, the base its own references compose with)."""
        if file_id >= len(files):
            raise ValueError(f"OCDBT data file id {file_id} out of range")
        file_base, rel = files[file_id]
        return os.path.join(self.root, base + file_base + rel), (
            base + file_base)

    def _walk(self, files, base, file_id, offset, length, height,
              prefix: bytes) -> None:
        path, node_base = self._file(files, base, file_id)
        with open(path, "rb") as f:
            data = os.pread(f.fileno(), length, offset)
        if len(data) != length:
            raise ValueError(f"OCDBT node {path} is truncated")
        c = _Cursor(_envelope(data, _NODE_MAGIC, "b-tree node",
                              self._node_capacity), "b-tree node")
        got_height = c.byte()
        if got_height != height:
            raise ValueError(
                f"OCDBT node {path}: height {got_height}, {height} expected")
        node_files = _data_file_table(c)
        n = c.varint()
        keys, common = _keys(c, n, interior=height > 0)
        if height > 0:
            ids, offs, lens = c.varints(n), c.varints(n), c.varints(n)
            for i in range(n):
                self._walk(node_files, node_base, ids[i], offs[i], lens[i],
                           height - 1, prefix + keys[i][:common[i]])
            return
        lens = c.varints(n)
        kinds = c.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"OCDBT node {path}: unknown value kind")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ids = c.varints(len(indirect))
        offs = c.varints(len(indirect))
        refs = dict(zip(indirect, zip(ids, offs)))
        for i in range(n):
            if i in refs:
                fid, off = refs[i]
                value = self._file(node_files, node_base, fid)[0], off, lens[i]
            else:
                value = c.take(lens[i])
            self._values[(prefix + keys[i]).decode()] = value
        if c.pos != len(c.buf):
            raise ValueError(f"OCDBT node {path}: trailing bytes")

    def keys(self) -> list:
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def read(self, key: str) -> Optional[np.ndarray]:
        """The value of ``key`` as a uint8 array (a read-only view of the
        data file's pages for an indirect value), or None when absent."""
        value = self._values.get(key)
        if value is None:
            return None
        if isinstance(value, bytes):
            return np.frombuffer(value, np.uint8)
        path, offset, length = value
        with open(path, "rb") as f:
            if offset + length > os.fstat(f.fileno()).st_size:
                raise ValueError(
                    f"OCDBT value {key!r} lies past the end of {path}")
            if length == 0:
                return np.empty(0, np.uint8)
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        return np.frombuffer(mm, np.uint8, count=length, offset=offset)


# ----------------------------------------------------------------------
# 3. zarr v2 arrays
# ----------------------------------------------------------------------

_DTYPES = {"<f4": np.float32, "<i4": np.int32, "<i8": np.int64}


def _zarray(store: OcdbtStore, name: str) -> dict:
    raw = store.read(name + "/.zarray")
    if raw is None:
        raise ValueError(f"{store.root} holds no array {name!r}")
    meta = json.loads(raw.tobytes())
    if meta.get("zarr_format") != 2:
        raise ValueError(
            f"{name}: zarr_format {meta.get('zarr_format')} (only 2 is read)")
    if meta.get("dtype") not in _DTYPES:
        raise ValueError(f"{name}: unsupported dtype {meta.get('dtype')!r}")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: unsupported order {meta['order']!r}")
    if meta.get("filters") is not None:
        raise ValueError(f"{name}: unsupported filters {meta['filters']!r}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: unsupported compressor {comp.get('id')!r}")
    if meta.get("dimension_separator", ".") not in (".", "/"):
        raise ValueError(
            f"{name}: unsupported dimension_separator "
            f"{meta['dimension_separator']!r}")
    if len(meta["chunks"]) != len(meta["shape"]):
        raise ValueError(f"{name}: chunks and shape differ in rank")
    return meta


def read_array(store: OcdbtStore, name: str,
               rows: Optional[slice] = None) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``, or only its ``rows``
    (a unit-step slice of the first axis) when given."""
    meta = _zarray(store, name)
    dtype = np.dtype(_DTYPES[meta["dtype"]])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    zstd = meta.get("compressor") is not None
    fill = meta.get("fill_value")
    lo, hi = 0, shape[0] if shape else 0
    if rows is not None:
        if not shape:
            raise ValueError(f"{name}: rows= of a 0-d array")
        lo, hi, step = rows.indices(shape[0])
        if step != 1:
            raise ValueError("rows= must be a unit-step slice")
        hi = max(lo, hi)
    out_shape = ((hi - lo,) + shape[1:]) if shape else ()
    out = np.full(out_shape, 0 if fill is None else fill, dtype)
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    if not shape:
        grid = [()]
    else:
        axes = [range(lo // chunks[0], -(-hi // chunks[0]))] + [
            range(-(-s // c)) for s, c in zip(shape[1:], chunks[1:])]
        grid = [()]
        for ax in axes:
            grid = [g + (i,) for g in grid for i in ax]
    for idx in grid:
        raw = store.read(f"{name}/{sep.join(map(str, idx)) or '0'}")
        if raw is None:
            continue  # an absent chunk is all fill_value
        start = [i * c for i, c in zip(idx, chunks)]
        whole = (out.shape == chunks and lo == 0
                 and all(s == 0 for s in start))
        dst = out if whole else np.empty(chunks, dtype)
        if zstd:
            zstd_decompress(raw, out=dst)
        elif raw.nbytes != chunk_bytes:
            raise ValueError(
                f"{name}: chunk {idx} holds {raw.nbytes} bytes, "
                f"{chunk_bytes} expected")
        else:
            dst.reshape(-1).view(np.uint8)[:] = raw
        if whole:
            continue
        # The chunk's part inside the array (edge chunks are padded)
        # and inside the selected rows.
        src, sink = [], []
        for ax, (s, c, n) in enumerate(zip(start, chunks, shape)):
            a, b = s, min(s + c, n)
            if ax == 0:
                a, b = max(a, lo), min(b, hi)
                sink.append(slice(a - lo, b - lo))
            else:
                sink.append(slice(a, b))
            src.append(slice(a - s, b - s))
        out[tuple(sink)] = dst[tuple(src)]
    return out


# ----------------------------------------------------------------------
# 4. the pytree
# ----------------------------------------------------------------------

_PARAMS_TREE = {
    ("params", "w0"): "w0", ("params", "table"): "table", ("step",): "step",
}
_S = "opt_state"
# (optimizer, sparse step) -> {tree path: the port state's field (in
# the state's field order), or None for a structural leaf that holds no
# array (optax's EmptyState, the sparse SGD's empty tuple)}.  FTRL's
# sparse and dense states share their paths, so either restores the
# other, as in the reference.
_FTRL_TREE = {(_S, t, leaf): f"{t}_{leaf}"
              for t in ("z", "n") for leaf in ("w0", "table")}
_OPT_TREES = {
    ("adagrad", True): {(_S, "acc", leaf): f"acc_{leaf}"
                        for leaf in ("w0", "table")},
    ("adagrad", False): {
        **{(_S, "0", "sum_of_squares", leaf): f"acc_{leaf}"
           for leaf in ("w0", "table")},
        (_S, "1"): None,
    },
    ("ftrl", True): _FTRL_TREE,
    ("ftrl", False): _FTRL_TREE,
    ("sgd", True): {(_S,): None},
    ("sgd", False): {(_S, "0"): None, (_S, "1"): None},
    ("adam", False): {
        **{(_S, "0", m, leaf): f"{m}_{leaf}"
           for m in ("mu", "nu") for leaf in ("w0", "table")},
        (_S, "0", "count"): "count",
        (_S, "1"): None,
    },
}
_KNOWN_OPT_PATHS = frozenset().union(*_OPT_TREES.values())


def _tree(directory: str) -> dict:
    """``{path tuple: value_metadata}`` of an Orbax checkpoint's
    ``_METADATA``; an OCDBT-less or zarr3 layout raises ValueError."""
    path = os.path.join(directory, "_METADATA")
    with open(path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: use_zarr3 checkpoints are not read")
    if not meta.get("use_ocdbt"):
        raise ValueError(f"{path}: only OCDBT (use_ocdbt) checkpoints are "
                         "read")
    return {
        tuple(k["key"] for k in leaf["key_metadata"]): leaf["value_metadata"]
        for leaf in meta["tree_metadata"].values()
    }


def _array_name(path: tuple) -> str:
    return ".".join(path)


def read_params(model_file: str, rows: Optional[slice] = None) -> tuple:
    """``(step, w0, table, full table shape)`` from ``<model_file>/params``
    as host numpy, the table cut to ``rows`` when given (only the chunks
    that cover them are read)."""
    directory = params_dir(model_file)
    tree = _tree(directory)
    unknown = sorted(set(tree) - set(_PARAMS_TREE))
    if unknown:
        raise ValueError(f"{directory}: unknown tree paths {unknown}")
    missing = sorted(set(_PARAMS_TREE) - set(tree))
    if missing:
        raise ValueError(f"{directory}: missing tree paths {missing}")
    store = OcdbtStore(directory)
    step = int(read_array(store, "step"))
    w0 = np.float32(read_array(store, _array_name(("params", "w0"))))
    table_name = _array_name(("params", "table"))
    shape = tuple(_zarray(store, table_name)["shape"])
    table = read_array(store, table_name, rows=rows)
    if table.dtype != np.float32 or table.ndim != 2:
        raise ValueError(f"{directory}: params.table is {table.dtype} "
                         f"{table.shape}, want float32 [V, D]")
    return step, w0, table, shape


def read_opt(model_file: str, optimizer: str, sparse: bool = True,
             rows: Optional[slice] = None) -> Optional[dict]:
    """The ``optimizer``'s state from ``<model_file>/opt`` as ``{field:
    host array}`` (the port's state fields, tables cut to ``rows``; ``{}``
    for SGD), or None when there is no ``opt`` directory or its tree is
    not the one ``optimizer`` on the sparse (``sparse``) or the dense
    step keeps, as the reference's ``restore_opt`` gives None.  A tree
    path no optimizer writes raises ValueError."""
    directory = opt_dir(model_file)
    if not (os.path.isdir(directory) and os.listdir(directory)):
        return None
    tree = _tree(directory)
    unknown = sorted(set(tree) - _KNOWN_OPT_PATHS)
    if unknown:
        raise ValueError(f"{directory}: unknown tree paths {unknown}")
    want = _OPT_TREES.get((optimizer, bool(sparse)))
    if want is None or set(tree) != set(want):
        return None
    out = {}
    store = None
    for path, field in want.items():
        if field is None:
            continue
        store = store or OcdbtStore(directory)
        a = read_array(store, _array_name(path),
                       rows=rows if path[-1] == "table" else None)
        if field == "count":
            if a.dtype != np.int32:
                raise ValueError(f"{directory}: Adam's count is {a.dtype}")
        elif a.dtype != np.float32:
            raise ValueError(f"{directory}: {_array_name(path)} is {a.dtype}")
        out[field] = a
    return out
