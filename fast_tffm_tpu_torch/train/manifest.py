"""The serving manifest: the hot-swap handshake file, stdlib only.

The port's copy of ``fast_tffm_tpu/train/manifest.py``.  Every save in
``train/checkpoint.py`` publishes ``<model_file>/serve_manifest.json``
AFTER the checkpoint files land (temp file + atomic rename), so a reader
that sees a new manifest knows the checkpoint it names is complete; the
server's ``CheckpointWatcher`` polls it.  The document carries the
reference's keys ``step``, ``format`` (``dense``, ``quant`` or
``tiered``) and ``published`` (the wall time, which tells re-saves at
one step apart), so either package's watcher reads either package's
manifest.  The reference's trainer also merges a ``quality`` sketch
payload into it (the training-to-serving skew reference); that belongs
to the observability planes the port has not ported (ROADMAP.md, port
queue item 4), so the port writes no ``quality`` key.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["manifest_path", "publish_manifest", "read_manifest"]


def manifest_path(model_file: str) -> str:
    return os.path.join(os.path.abspath(model_file), "serve_manifest.json")


def publish_manifest(model_file: str, step: int, fmt: str) -> None:
    """Publish the serving manifest; call it after the checkpoint's
    files are in place."""
    doc = {"step": int(step), "format": fmt, "published": time.time()}
    tmp = manifest_path(model_file) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, manifest_path(model_file))


def read_manifest(model_file: str) -> Optional[dict]:
    """The published serving manifest, or None (absent or mid-write)."""
    try:
        with open(manifest_path(model_file)) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None
