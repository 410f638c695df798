"""Rank mesh — the counterpart of ``fast_tffm_tpu/parallel/mesh.py``.

The reference lays its devices out as a 2-D ``(data, model)`` mesh:
``data`` splits the batch (synchronous data parallelism), ``model``
splits the table's rows.  Here every rank is one process with one
device, and the mesh is the same row-major grid of ranks: rank ``r``
sits at ``(r // mesh_model, r % mesh_model)``.  Its collectives are
``torch.distributed`` calls over one process group per data row (the
model axis) and one per model column (the data axis).

:func:`psum` and :func:`all_gather` take a tensor on the rank's device.
With the ``gloo`` backend a CUDA tensor is staged explicitly through a
pinned host buffer (gloo's own CUDA support is partial); ``nccl`` takes
it as it is; a CPU tensor goes to gloo directly.  :func:`gather` brings
the tensors to the axis's first rank only (a checkpoint's save).
:func:`all_gather_async` starts an all-gather and returns at once; its
``wait()`` gives the result (the overlapped entries exchange's id
plane).

:class:`DeviceGrid` is the other half of the reference's module for ONE
process: its ``make_mesh`` over the devices the process sees, and
``param_sharding``'s table rows split over ``model``.  The scorer
(``serve/scorer.py``) serves and predicts over it; the trainer's rank
:class:`Mesh` above is untouched by it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from fast_tffm_tpu_torch.platform import resolve_devices

__all__ = ["DATA_AXIS", "MODEL_AXIS", "DeviceGrid", "Mesh", "PendingGather",
           "all_gather", "all_gather_async", "barrier", "data_partition",
           "gather", "make_mesh", "mesh_shape", "psum"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This rank's view of the ``data x model`` grid: its coordinates,
    the process group of each axis it belongs to (None for an axis of
    size 1, where a collective is the identity) and the backend."""

    def __init__(self, data: int, model: int, rank: int = 0,
                 groups: Optional[Dict[str, object]] = None,
                 backend: Optional[str] = None):
        if not 0 <= rank < data * model:
            raise ValueError(f"rank {rank} is not on a {data}x{model} mesh")
        self.data, self.model, self.rank = data, model, rank
        self.groups = dict(groups or {})
        self.backend = backend
        self._staging: Dict[tuple, torch.Tensor] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def coords(self) -> Tuple[int, int]:
        """``(data row, model column)`` of this rank."""
        return divmod(self.rank, self.model)

    def row_range(self, vocab: int) -> Tuple[int, int]:
        """``(row_lo, vocab_local)``: the table rows this rank's model
        shard holds (``vocab`` divides by ``model``)."""
        local = vocab // self.model
        return self.coords[1] * local, local

    def _host(self, key: tuple, like: torch.Tensor, numel: int):
        """A pinned host buffer of ``numel`` elements of ``like``'s dtype,
        kept for reuse (each collective below is synchronous, so no two
        calls hold one buffer at a time)."""
        key = key + (like.dtype,)
        buf = self._staging.get(key)
        if buf is None or buf.numel() < numel:
            buf = torch.empty((numel,), dtype=like.dtype, pin_memory=True)
            self._staging[key] = buf
        return buf[:numel]

    def _staged(self, t: torch.Tensor) -> bool:
        return t.device.type == "cuda" and self.backend == "gloo"


class DeviceGrid:
    """One process's ``data x model`` grid of devices, the reference's
    ``make_mesh(cfg, devices)``: ``mesh_data x mesh_model`` from the
    config, or every device on ``data`` when the config asks for 1 x 1
    and several devices are given; a grid larger than the devices
    raises with the reference's words, and surplus devices are left
    out, as there.  ``devices`` goes through
    :func:`~fast_tffm_tpu_torch.platform.resolve_devices` (None: every
    visible GPU) and may repeat a device (``["cpu"] * 4``, ``["cuda:0"]
    * 4``), the counterpart of the reference's virtual CPU devices.

    ``devices[i][j]`` is the device at data row ``i``, model column
    ``j`` (row-major, as the reference's grid).  Data row ``i`` scores
    the ``i``-th block of every batch on its first device; device ``(i,
    j)`` holds model shard ``j``'s rows (:meth:`row_ranges`)."""

    def __init__(self, cfg, devices=None):
        devs = resolve_devices(devices)
        n = len(devs)
        d, m = cfg.mesh_data, cfg.mesh_model
        if d * m == 1 and n > 1:
            d, m = n, 1
        if d * m > n:
            raise ValueError(f"mesh {d}x{m} needs {d * m} devices, have {n}")
        if len({dev.type for dev in devs}) > 1:
            raise ValueError(
                f"a grid's devices are all GPUs or all the CPU, got {devs}")
        self.data, self.model = d, m
        self.devices: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(devs[i * m:(i + 1) * m]) for i in range(d))

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def first(self) -> torch.device:
        """The device at ``(0, 0)``."""
        return self.devices[0][0]

    def flat(self) -> List[torch.device]:
        """Every device of the grid, row-major."""
        return [dev for row in self.devices for dev in row]

    def row_ranges(self, vocab: int) -> List[Tuple[int, int]]:
        """``[lo_j, hi_j)`` of model shard ``j``: ``vocab / model`` rows
        each, in order.  A vocabulary that ``model`` does not divide
        raises ValueError, as the reference's row sharding does."""
        if vocab % self.model:
            raise ValueError(
                f"the table's {vocab} rows do not split over a model axis "
                f"of {self.model}: its dimension 0 should be divisible by "
                f"{self.model}, but it is equal to {vocab}")
        local = vocab // self.model
        return [(j * local, (j + 1) * local) for j in range(self.model)]

    def describe(self) -> str:
        """The grid's devices by name: a single device as
        ``torch.cuda.get_device_name`` gives it (or ``cpu``), a larger
        grid as ``"DxM: cuda:0 (name), ..."``, every device named."""
        def name(dev):
            return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu")

        if self.size == 1:
            return name(self.first)
        return f"{self.data}x{self.model}: " + ", ".join(
            f"{dev} ({name(dev)})" for dev in self.flat())


def mesh_shape(mesh_data: int, mesh_model: int, world: int) -> Tuple[int, int]:
    """The ``(data, model)`` shape for ``world`` ranks: the config's,
    or all data when the config asks for 1 x 1 and there are several
    ranks.  Every rank must sit on the mesh: a mesh larger (or smaller)
    than the world raises, where the reference leaves surplus devices
    out; a surplus rank would have nothing to compute."""
    d, m = mesh_data, mesh_model
    if d * m == 1 and world > 1:
        d, m = world, 1
    if d * m > world:
        raise ValueError(f"mesh {d}x{m} needs {d * m} ranks, have {world}")
    if d * m < world:
        raise ValueError(
            f"mesh {d}x{m} holds {d * m} ranks but {world} joined: every "
            f"rank must sit on the mesh"
        )
    return d, m


def make_mesh(cfg) -> Mesh:
    """This rank's :class:`Mesh` for ``cfg.mesh_data x cfg.mesh_model``.
    Without an initialised process group the world is this one process.
    Builds the axis groups with ``torch.distributed.new_group``, which
    every rank calls for every group in the same order."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    d, m = mesh_shape(cfg.mesh_data, cfg.mesh_model, world)
    groups: Dict[str, object] = {}
    if world > 1:
        row, col = divmod(rank, m)
        if m > 1:
            for i in range(d):
                g = dist.new_group([i * m + j for j in range(m)])
                if i == row:
                    groups[MODEL_AXIS] = g
        if d > 1:
            for j in range(m):
                g = dist.new_group([i * m + j for i in range(d)])
                if j == col:
                    groups[DATA_AXIS] = g
    backend = dist.get_backend() if initialised else None
    return Mesh(d, m, rank, groups, backend)


def data_partition(mesh: Mesh) -> Tuple[int, int]:
    """``(block, num_blocks)`` of this rank's input: its data row among
    ``mesh.data`` rows.  Model-column peers share a block and must read
    identical batches in identical order."""
    return mesh.coords[0], mesh.data


def psum(t: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """Sum of ``t`` over the ranks of ``mesh``'s ``axis``, written into
    ``t`` (contiguous) and returned."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    if mesh._staged(t):
        host = mesh._host(("sum",), t, t.numel()).view(t.shape)
        host.copy_(t)
        dist.all_reduce(host, group=group)
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, axis: str, mesh: Mesh) -> torch.Tensor:
    """The ``t`` of every rank of ``mesh``'s ``axis`` concatenated along
    dimension 0, in the order of their coordinate on that axis."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    t = t.contiguous()
    n = mesh.shape[axis]
    out_shape = (n * t.shape[0],) + tuple(t.shape[1:])
    if mesh._staged(t):
        src = mesh._host(("gather_in",), t, t.numel()).view(t.shape)
        src.copy_(t)
        dst = mesh._host(("gather_out",), t, n * t.numel())
        dist.all_gather(list(dst.view(out_shape).chunk(n)), src, group=group)
        return dst.view(out_shape).to(t.device)
    out = torch.empty(out_shape, dtype=t.dtype, device=t.device)
    if t.device.type == "cuda":
        dist.all_gather_into_tensor(out, t, group=group)
    else:
        dist.all_gather(list(out.chunk(n)), t, group=group)
    return out


class PendingGather:
    """An all-gather in flight (:func:`all_gather_async`): :meth:`wait`
    blocks until it has landed and returns the gathered tensor on the
    input's device.  It holds its buffers until then."""

    def __init__(self, work, out: torch.Tensor, device: torch.device,
                 keep: Optional[torch.Tensor] = None):
        self._work, self._out, self._device = work, out, device
        self._keep = keep  # the input, alive until the gather lands

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = self._keep = None
        return self._out.to(self._device)


def all_gather_async(t: torch.Tensor, axis: str,
                     mesh: Mesh) -> PendingGather:
    """:func:`all_gather` started as an asynchronous collective: returns
    at once, and the result's ``wait()`` gives what :func:`all_gather`
    would.  Under gloo a CUDA tensor is copied to a fresh host buffer
    first (that copy waits for the device) and the result back after the
    wait; under nccl the gather runs on the backend's stream and the
    wait orders the current stream after it.  Each call owns its
    buffers, so several may be in flight beside the synchronous
    collectives."""
    group = mesh.groups.get(axis)
    if group is None:
        return PendingGather(None, t, t.device)
    t = t.contiguous()
    n = mesh.shape[axis]
    out_shape = (n * t.shape[0],) + tuple(t.shape[1:])
    if mesh._staged(t):
        src = t.cpu()
        out = torch.empty(out_shape, dtype=t.dtype)
        work = dist.all_gather(list(out.chunk(n)), src, group=group,
                               async_op=True)
        return PendingGather(work, out, t.device, keep=src)
    out = torch.empty(out_shape, dtype=t.dtype, device=t.device)
    if t.device.type == "cuda":
        work = dist.all_gather_into_tensor(out, t, group=group,
                                           async_op=True)
    else:
        work = dist.all_gather(list(out.chunk(n)), t, group=group,
                               async_op=True)
    return PendingGather(work, out, t.device, keep=t)


def gather(t: torch.Tensor, axis: str,
           mesh: Mesh) -> Optional[torch.Tensor]:
    """The ``t`` of every rank of ``mesh``'s ``axis`` concatenated along
    dimension 0 on the axis's first rank (coordinate 0), on ``t``'s
    device; None on the others, which hold nothing beyond their own
    ``t``.  Under gloo a CUDA tensor crosses as a host copy."""
    group = mesh.groups.get(axis)
    if group is None:
        return t
    t = t.contiguous()
    src = t.cpu() if mesh._staged(t) else t
    first = dist.get_rank(group) == 0
    parts = ([torch.empty_like(src) for _ in range(mesh.shape[axis])]
             if first else None)
    dist.gather(src, parts, dst=dist.get_global_rank(group, 0), group=group)
    return torch.cat(parts).to(t.device) if first else None


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (no-op on one rank)."""
    if mesh.size > 1:
        dist.barrier()
