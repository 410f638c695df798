"""Fleet aggregation: the merge and render core the serving router uses
over its replicas' scraped ``/status`` blocks.

:class:`MergeSpec` + :func:`merge_blocks` fold per-member blocks into
one fleet view (sums for monotonic counters and rates, weighted means
for centers, MAX for tails: a merged p99 cannot be computed from
per-member percentiles, so the max is the honest conservative bound,
and the scrape-staleness age), and :func:`labeled_lines` renders
per-member labeled Prometheus series.

The PyTorch port's copy of the serving half of
``fast_tffm_tpu/obs/fleet.py``, the same semantics and spellings; the
training-fleet plane (``TrainFleet``, ``train_fleet_scrape``) is not in
the port yet.  Stdlib-only: the router imports it and imports no torch.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

__all__ = ["MergeSpec", "merge_blocks", "labeled_lines"]


@dataclasses.dataclass(frozen=True)
class MergeSpec:
    """How a set of scraped per-member blocks folds into one fleet
    view.  Key groups (each names keys of the member blocks):

    - ``sums`` — monotonic counters and additive rates; summed,
      emitted as ``{prefix}{key}`` rounded to 2 (counter precision).
    - ``weighted`` — center statistics (p50, wait fractions); mean
      weighted by each member's ``weight_key`` value (min weight 1 so
      an idle member still counts), emitted ``{prefix}{key}`` @ 4.
    - ``tails`` — upper quantiles/maxima; MAX-merged (the honest
      conservative bound), emitted ``{prefix}{key}`` @ 4.
    - ``means`` — plain unweighted means (fill fractions), @ 6.
    - ``max_same`` — MAX-merged under the SAME key name (distribution
      distances like PSI, where the fleet's worst member is the
      aggregate and a mean would dilute it N-fold), @ 6.
    - ``sum_same_int`` — integer sums under the same key name (mass
      counters that ride next to ``max_same`` keys).

    ``count_key`` carries how many members contributed (0 on an empty
    scrape — the only key then); ``age_key`` carries the oldest
    member's scrape age in seconds @ 3 (the staleness alert signal).
    """

    sums: Tuple[str, ...] = ()
    weighted: Tuple[str, ...] = ()
    weight_key: str = ""
    tails: Tuple[str, ...] = ()
    means: Tuple[str, ...] = ()
    max_same: Tuple[str, ...] = ()
    sum_same_int: Tuple[str, ...] = ()
    prefix: str = "fleet_"
    count_key: str = "replicas_scraped"
    age_key: str = "fleet_scrape_age_max_s"


def _vals(blocks: List[Tuple[float, dict]], key: str) -> list:
    return [
        b.get(key) for _t, b in blocks
        if isinstance(b.get(key), (int, float))
    ]


def merge_blocks(spec: MergeSpec,
                 blocks: List[Tuple[float, dict]],
                 now: float) -> dict:
    """Fold ``blocks`` (``(scrape_time, member_block)`` pairs) into one
    fleet dict per ``spec``.  A key absent (or non-numeric) in a member
    simply doesn't contribute; a group with no contributors emits no
    key at all (no lying zeros)."""
    if not blocks:
        return {spec.count_key: 0}
    out: dict = {spec.count_key: len(blocks)}
    for key in spec.sums:
        vals = _vals(blocks, key)
        if vals:
            out[f"{spec.prefix}{key}"] = round(sum(vals), 2)
    if spec.weighted:
        weights = [
            max(1, int(b[spec.weight_key]))
            if isinstance(b.get(spec.weight_key), (int, float))
            else 1
            for _t, b in blocks
        ]
        for key in spec.weighted:
            pairs = [
                (b.get(key), w)
                for (_t, b), w in zip(blocks, weights)
                if isinstance(b.get(key), (int, float))
            ]
            if pairs:
                out[f"{spec.prefix}{key}"] = round(
                    sum(v * w for v, w in pairs)
                    / sum(w for _v, w in pairs),
                    4,
                )
    for key in spec.tails:
        vals = _vals(blocks, key)
        if vals:
            out[f"{spec.prefix}{key}"] = round(max(vals), 4)
    for key in spec.means:
        vals = _vals(blocks, key)
        if vals:
            out[f"{spec.prefix}{key}"] = round(sum(vals) / len(vals), 6)
    for key in spec.max_same:
        vals = _vals(blocks, key)
        if vals:
            out[key] = round(max(vals), 6)
    for key in spec.sum_same_int:
        vals = _vals(blocks, key)
        if vals:
            out[key] = int(sum(vals))
    out[spec.age_key] = round(max(now - t for t, _b in blocks), 3)
    return out


def _label_escape(value) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"')


def labeled_lines(name: str, mtype: str,
                  samples: Iterable[Tuple[dict, object]]) -> List[str]:
    """One labeled Prometheus series: a ``# TYPE`` header plus one
    ``name{k="v",...} value`` line per sample.  Empty samples render
    nothing (no headless TYPE lines) — the skip-when-absent contract
    both fleet renderers share."""
    samples = list(samples)
    if not samples:
        return []
    lines = [f"# TYPE {name} {mtype}"]
    for labels, value in samples:
        lab = ",".join(
            f'{k}="{_label_escape(v)}"' for k, v in labels.items()
        )
        lines.append(f"{name}{{{lab}}} {value}")
    return lines
