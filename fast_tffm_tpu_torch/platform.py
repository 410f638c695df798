"""Device resolution: the port runs on the GPU unless told otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
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
