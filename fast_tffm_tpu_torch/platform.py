"""Device resolution: the port runs on the GPU unless told otherwise."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

__all__ = ["resolve_device", "resolve_devices"]

DeviceLike = Union[str, torch.device]


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU (``cuda``); a host without one raises rather
    than falling back to the CPU, so a run never measures or serves on
    the CPU by accident.  ``"cpu"`` (or any ``cpu``/``cuda`` device) is
    taken as asked, and ``cuda`` on a host without a GPU raises too.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(
            f"unsupported device {dev} (the port runs on cuda or cpu)"
        )
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA GPU is visible to PyTorch; the port runs on the GPU "
            "by default — pass device='cpu' (CLI: --device cpu) to run "
            "on the CPU"
        )
    return dev


def resolve_devices(
    devices: Optional[Union[DeviceLike, Sequence[DeviceLike]]] = None,
) -> List[torch.device]:
    """The devices an entry point of several devices (the scorer's grid)
    runs on, under :func:`resolve_device`'s rules: ``None`` or ``"cuda"``
    means every visible GPU (and raises on a host without one), ``"cpu"``
    is the CPU, one indexed device (``"cuda:1"``) is that device alone,
    and a list is taken as it is, repeats included (``["cpu"] * 4`` is a
    grid of four on the CPU).  A CUDA device without an index in a list
    is the current one.  Nothing falls back to another device."""
    if devices is None or isinstance(devices, (str, torch.device)):
        dev = resolve_device(devices)
        if dev.type == "cuda" and dev.index is None:
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        out = [dev]
    else:
        out = [resolve_device(d) for d in devices]
        if not out:
            raise ValueError("an empty device list")
        out = [torch.device("cuda", torch.cuda.current_device())
               if d.type == "cuda" and d.index is None else d for d in out]
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in out:
        if d.type == "cuda" and d.index >= count:
            raise RuntimeError(
                f"{d} is not visible to PyTorch ({count} GPU(s) visible)")
    return out
