"""Offline kernel-autotune tool for the interaction hot path — the
port's counterpart of the repo's ``tools/autotune.py``.

Two modes:

- **Pre-populate** (default, needs a config): resolve the interaction
  impl for the config's train and serve shapes exactly as a run with
  ``interaction_impl = auto`` would on ``--device`` (the GPU unless
  asked otherwise), and persist the decisions to the autotune cache, so
  that the run (or a replica fleet sharing the cache file) starts with
  zero measurement::

      python -m fast_tffm_tpu_torch.tools.autotune model.cfg
      python -m fast_tffm_tpu_torch.tools.autotune model.cfg \\
          --cache /shared/autotune_cache.json

- **--check** (no config needed): validate the autotuner's invariants on
  the device:

  1. on the CPU, ``auto`` must resolve to ``reference`` WITHOUT a single
     measurement (on the card all three candidates enter measurement,
     so this one is skipped there);
  2. a forced ``("reference", "packed")`` measurement must pick a
     parity-gated winner, and a second resolve must hit the cache (no
     further measurement);
  3. an existing cache file (``--cache``, or the config's default
     location) must be self-consistent: readable, versioned, every
     entry's impl a known name.

  Exit 0 = all hold; nonzero with a message otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def _build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("cfg", nargs="?", default=None,
                   help="config file to pre-populate the cache for "
                        "(omit with --check)")
    p.add_argument("--cache", default=None, metavar="PATH",
                   help="autotune cache file (default: the config's "
                        "default_cache_path; with --check and no cfg, "
                        "no file check unless given)")
    p.add_argument("--check", action="store_true",
                   help="validate autotuner invariants + cache "
                        "self-consistency instead of pre-populating")
    p.add_argument("--context", choices=["train", "serve", "both"],
                   default="both",
                   help="which shapes to pre-populate (default both)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def _load_cfg(path: str):
    from fast_tffm_tpu_torch.config import load_config

    cfg = load_config(path)
    if cfg.interaction_impl not in ("", "auto"):
        print(f"note: config pins interaction_impl="
              f"{cfg.interaction_impl}; the run will not consult the "
              "cache, but pre-populating anyway for auto consumers")
    # Pre-population measures what `auto` WOULD choose regardless of
    # what the file pins.
    return dataclasses.replace(cfg, interaction_impl="auto",
                               interaction="")


def _prepopulate(args) -> int:
    from fast_tffm_tpu_torch.ops import autotune

    cfg = _load_cfg(args.cfg)
    cache = (
        args.cache if args.cache is not None
        else autotune.default_cache_path(cfg)
    )
    if not cache:
        print("no cache path resolvable (set --cache, compile_cache_dir "
              "or model_file); decisions would not persist", file=sys.stderr)
        return 2
    contexts = (
        ("train", "serve") if args.context == "both" else (args.context,)
    )
    for context in contexts:
        # The serve context at the max rung, as the scorer resolves it.
        batch = max(cfg.serve_ladder) if context == "serve" else None
        d = autotune.resolve(cfg, context=context, batch=batch,
                             cache_path=cache, device=args.device)
        times = (
            " ".join(f"{k}={v}ms" for k, v in sorted(d.times_ms.items()))
            or "no measurement needed"
        )
        print(f"{context}: {d.impl} ({d.source}; {times})")
    print(f"cache: {cache}")
    return 0


def _check(args) -> int:
    from fast_tffm_tpu_torch.config import FmConfig, load_config
    from fast_tffm_tpu_torch.ops import autotune
    from fast_tffm_tpu_torch.platform import resolve_device

    device = resolve_device(args.device)
    failures = []

    # (1) + (2) run against a small synthetic config and a throwaway
    # in-memory cache, so --check never touches a real cache file.
    saved_env = os.environ.get("FAST_TFFM_AUTOTUNE_CACHE")
    os.environ["FAST_TFFM_AUTOTUNE_CACHE"] = ""
    cfg = FmConfig(vocabulary_size=512, factor_num=4, max_features=8,
                   batch_size=64, interaction_impl="auto")
    n_before = autotune.measurement_count()
    d = autotune.resolve(cfg, context="train", device=device)
    n0 = autotune.measurement_count()
    if device.type == "cpu":
        if d.impl != "reference":
            failures.append(
                f"CPU auto resolved to {d.impl!r}, expected reference")
        if d.source != "single_candidate":
            failures.append(
                f"CPU auto source {d.source!r}, expected "
                "single_candidate (zero measurement)")
        if n0 != n_before:
            failures.append(
                f"CPU auto ran {n0 - n_before} measurement(s), expected 0")
    # (2) forced multi-candidate measurement + cache hit.  "packed" runs
    # on every device (plain torch), so this exercises the whole
    # measure -> parity gate -> persist -> hit loop on the CPU too.
    cands = ("reference", "packed")
    d1 = autotune.resolve(cfg, context="train", candidates=cands,
                          device=device)
    n1 = autotune.measurement_count()
    if d1.source != "measured" or n1 <= n0:
        failures.append(
            f"forced measurement did not measure (source={d1.source}, "
            f"count {n0}->{n1})")
    if d1.impl not in cands:
        failures.append(f"measured winner {d1.impl!r} not a candidate")
    bad = [k for k, v in d1.parity_err.items()
           if v > autotune.PARITY_TOL and k in d1.times_ms]
    if bad:
        failures.append(f"parity-gate leak: {bad} timed despite err>tol")
    d2 = autotune.resolve(cfg, context="train", candidates=cands,
                          device=device)
    if d2.source != "cache" or autotune.measurement_count() != n1:
        failures.append(
            f"second resolve missed the cache (source={d2.source})")
    if d2.impl != d1.impl:
        failures.append(
            f"cache returned {d2.impl!r} but measurement chose {d1.impl!r}")
    if saved_env is None:
        del os.environ["FAST_TFFM_AUTOTUNE_CACHE"]
    else:
        os.environ["FAST_TFFM_AUTOTUNE_CACHE"] = saved_env

    # (3) optional cache-file self-consistency.
    cache = args.cache
    if cache is None and args.cfg:
        cache = autotune.default_cache_path(load_config(args.cfg))
    if cache and os.path.exists(cache):
        entries = autotune.load_cache(cache)
        if not entries:
            failures.append(
                f"cache file {cache} exists but holds no valid entries "
                "(corrupt or version drift)")
        for key, e in (entries or {}).items():
            if not isinstance(e, dict) or e.get("impl") not in autotune.INTERNAL:
                failures.append(f"cache entry {key!r} invalid: {e!r}")
        if not failures:
            print(f"cache {cache}: {len(entries)} entrie(s) OK")

    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(f"autotune check OK (device: {device.type})")
    return 0


def main(argv=None) -> int:
    args = _build_argparser().parse_args(argv)
    if args.check:
        return _check(args)
    if not args.cfg:
        print("a config file is required unless --check", file=sys.stderr)
        return 2
    return _prepopulate(args)


if __name__ == "__main__":
    sys.exit(main())
