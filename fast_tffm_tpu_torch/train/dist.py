"""Multi-rank start-up — the counterpart of ``fast_tffm_tpu/train/dist.py``.

Every rank runs the same training command after :func:`initialize`:
one process per rank, the table row-sharded over the ``model`` axis of
the rank mesh (``parallel.mesh``), each data block parsing its strided
share of the input (``BatchPipeline(shard=...)``).  There are no
parameter servers; the CLI maps the legacy ``--ps_hosts/--worker_hosts/
--job_name/--task_index`` flags onto this (``cli.py``).

Before the process group starts, the ranks meet in its rendezvous store
and exchange their host names, then the GPU each one took.  A rank's
local rank is the number of lower ranks on its host, and the backend
follows one rule, logged at start-up:

- ``nccl`` when every rank runs on a GPU and no two ranks share one;
- ``gloo`` on the CPU, or when ranks share a GPU (NCCL refuses two ranks
  on one device); CUDA tensors then cross through pinned host memory.

It is a rule, not a fallback: a failed initialisation raises.
"""

from __future__ import annotations

import logging
import socket
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from fast_tffm_tpu_torch.platform import resolve_device

log = logging.getLogger(__name__)

__all__ = ["backend_for", "initialize", "local_rank"]

_KEY = "fast_tffm_tpu_torch/{}/{}"


def local_rank(hosts: Sequence[str], rank: int) -> int:
    """The number of ranks below ``rank`` on its host (``hosts``: every
    rank's host name, by rank)."""
    return sum(h == hosts[rank] for h in hosts[:rank])


def backend_for(placements: Sequence[str]) -> str:
    """``nccl`` when no rank's placement is ``"cpu"`` and no two are
    equal, else ``gloo``.  ``placements``: every rank's device, ``"cpu"``
    or one GPU's identity (its host and UUID)."""
    if "cpu" in placements or len(set(placements)) < len(placements):
        return "gloo"
    return "nccl"


def _exchange(store, name: str, rank: int, world: int,
              value: str) -> List[str]:
    """Every rank's ``value``, by rank (each rank blocks until all have
    set theirs)."""
    store.set(_KEY.format(name, rank), value)
    return [store.get(_KEY.format(name, r)).decode() for r in range(world)]


def initialize(coordinator: str, num_processes: int, process_id: int,
               device: Optional[Union[str, torch.device]] = None
               ) -> torch.device:
    """Join the ``num_processes``-rank group as rank ``process_id`` and
    return this rank's device.  ``coordinator`` is ``host:port`` (a
    ``tcp://`` rendezvous) or a URL such as ``file:///path``.  The
    device is the GPU unless ``device="cpu"``: ``cuda:(local rank %
    device count)``, the local rank counted from the host names the
    ranks exchange."""
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} outside [0, {num_processes})"
        )
    dev = resolve_device(device)
    init_method = (coordinator if "://" in coordinator
                   else f"tcp://{coordinator}")
    store, _, _ = next(dist.rendezvous(init_method, process_id,
                                       num_processes))
    host = socket.gethostname()
    hosts = _exchange(store, "host", process_id, num_processes, host)
    lrank = local_rank(hosts, process_id)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", lrank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        mine = f"{host}/{torch.cuda.get_device_properties(dev).uuid}"
    else:
        mine = "cpu"
    placements = _exchange(store, "device", process_id, num_processes, mine)
    backend = backend_for(placements)
    log.info(
        "initializing torch.distributed: %s (%d ranks, this is %d, local "
        "rank %d of %d on %s) on %s; backend %s (nccl when every rank has "
        "a GPU of its own, else gloo)", init_method, num_processes,
        process_id, lrank, hosts.count(host), host, dev, backend,
    )
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)
    return dev
