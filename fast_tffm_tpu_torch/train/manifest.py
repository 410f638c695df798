"""The serving manifest: the hot-swap handshake file, stdlib only.

The port's copy of ``fast_tffm_tpu/train/manifest.py``.  Every save in
``train/checkpoint.py`` publishes ``<model_file>/serve_manifest.json``
AFTER the checkpoint files land (temp file + atomic rename), so a reader
that sees a new manifest knows the checkpoint it names is complete; the
server's ``CheckpointWatcher`` polls it.  The document carries the
reference's keys ``step``, ``format`` (``dense``, ``quant`` or
``tiered``) and ``published`` (the wall time, which tells re-saves at
one step apart), so either package's watcher reads either package's
manifest.  ``extra`` merges more top-level keys into the document: the
trainer's ``quality`` payload (``{"examples", "sketches"}``, the
training-to-serving skew reference a replica's ``ServeSkewMonitor``
compares live traffic against), absent with ``quality = false``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["manifest_path", "publish_manifest", "read_manifest"]


def manifest_path(model_file: str) -> str:
    return os.path.join(os.path.abspath(model_file), "serve_manifest.json")


def publish_manifest(model_file: str, step: int, fmt: str,
                     extra: Optional[dict] = None) -> None:
    """Publish the serving manifest; call it after the checkpoint's
    files are in place.  ``extra``'s keys are merged into the
    document."""
    doc = {"step": int(step), "format": fmt, "published": time.time()}
    if extra:
        doc.update(extra)
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
