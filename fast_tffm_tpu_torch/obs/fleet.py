"""Fleet aggregation: the shared merge/render core + the live
training-fleet plane.

Two planes scrape a fleet of ``/status`` endpoints and publish one
merged view: the serving router (serve/router.py, PR 13) over its
replicas, and — this module — rank 0 of a multi-process training run
over every rank.  The MERGE SEMANTICS are identical by construction:
:class:`MergeSpec` + :func:`merge_blocks` hold the one implementation
(sums for monotonic counters and rates, weighted means for centers,
MAX for tails — a merged p99 cannot be computed from per-member
percentiles, so the max is the honest conservative bound — and the
scrape-staleness age the alert plane watches), and
:func:`labeled_lines` is the one renderer for per-member labeled
Prometheus series.  The router consumes both, so the two planes cannot
drift.

:class:`TrainFleet` is the training side: rank 0 scrapes every rank's
``/status`` on the heartbeat cadence (the ``train_fleet_scrape``
config knob lists the targets), keeps the latest record per rank (a
failed scrape keeps the previous one and lets its staleness age), and
exposes:

- ``block()`` — the ``fleet`` dict merged onto rank 0's
  heartbeat/status/final records: summed ``examples_in``,
  examples-weighted ``ingest_wait_frac``, MAX-merged dispatch/wait/
  exchange p99 tails, ``scrape_age_max_s``, plus live straggler
  attribution: ``straggler_ratio`` (slowest rank's mean dispatch wall
  over the fleet mean — 1.0 at parity), ``slowest_rank`` + its
  ``slowest_rank_share`` of the fleet's total dispatch wall,
  ``dispatch_skew_ms`` / ``wait_skew_ms`` (max-min of the per-rank
  means), step-count desync ``rank_step_skew``, and the worst
  per-rank ``exchange_frac`` (fraction of a rank's wall spent blocked
  on the cross-rank collective — see train/sparse.py's probe).
- ``metrics_lines()`` — per-rank ``tffm_train_rank_*`` labeled series
  appended to rank 0's ``/metrics`` (StatusServer ``metrics_extra``).

All of it is alertable through the usual rules grammar
(``straggler_ratio > 1.5 for 3 : warn``); config refuses fleet-plane
rules when ``train_fleet_scrape`` is unset — the established
inert-rule discipline.

The PyTorch port's copy of ``fast_tffm_tpu/obs/fleet.py``, the same
semantics and spellings, so the port's merged ``fleet`` block and its
series equal the reference's on the same scraped records.  The port's
``train.exchange`` probe is one small all-reduce of the process group
(gloo or NCCL) after each dispatch, waited on one dispatch later with
the exchange overlap on (``train/loop.py``).  Stdlib-only: the router
imports it and imports no torch.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "MergeSpec", "merge_blocks", "labeled_lines",
    "TrainFleet", "TRAIN_MERGE_SPEC", "RANK_SERIES",
]

log = logging.getLogger(__name__)


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


# The training fleet's merge over the per-rank rows _rank_row extracts
# from scraped /status records.  prefix="" — the keys live inside the
# record's `fleet` block, which already names the plane (Prometheus
# renders them tffm_fleet_<key>).
TRAIN_MERGE_SPEC = MergeSpec(
    sums=("examples_in",),
    weighted=("ingest_wait_frac",),
    weight_key="examples_in",
    tails=("dispatch_p99_ms", "wait_p99_ms", "exchange_p99_ms"),
    prefix="",
    count_key="ranks_scraped",
    age_key="scrape_age_max_s",
)

# Per-rank labeled series on rank 0's /metrics: (row key, series name,
# Prometheus type).  Documented in OBSERVABILITY.md "Fleet training".
RANK_SERIES = (
    ("step", "tffm_train_rank_step", "gauge"),
    ("examples_in", "tffm_train_rank_examples_total", "counter"),
    ("ingest_wait_frac", "tffm_train_rank_ingest_wait_frac", "gauge"),
    ("dispatch_mean_ms", "tffm_train_rank_dispatch_mean_ms", "gauge"),
    ("dispatch_p99_ms", "tffm_train_rank_dispatch_p99_ms", "gauge"),
    ("wait_mean_ms", "tffm_train_rank_wait_mean_ms", "gauge"),
    ("wait_p99_ms", "tffm_train_rank_wait_p99_ms", "gauge"),
    ("exchange_frac", "tffm_train_rank_exchange_frac", "gauge"),
    ("scrape_age_s", "tffm_train_rank_scrape_age_s", "gauge"),
    # Rank-sharded tiering (ISSUE 19): each rank's share of the tier
    # partition — its cold-store bytes and how many shards it owns
    # (fleet-wide the owned counts must sum to num_shards; a hole
    # means some id range has no owner writing it back).
    ("tiered_cold_store_bytes", "tffm_train_rank_tiered_cold_bytes",
     "gauge"),
    ("tiered_owned_shards", "tffm_train_rank_tiered_owned_shards",
     "gauge"),
)

_TIMER_ROWS = (
    ("dispatch", "train.dispatch"),
    ("wait", "train.wait_input"),
    ("exchange", "train.exchange"),
)


def _rank_row(target: str, index: int, t: float, rec: dict,
              now: float) -> dict:
    """Flatten one scraped train /status record into the per-rank row
    the merge spec and labeled series consume."""
    row = {
        "rank": rec.get("rank", index),
        "target": target,
        "scrape_age_s": round(now - t, 3),
    }
    for key in ("step", "examples_in", "ingest_wait_frac"):
        val = rec.get(key)
        if isinstance(val, (int, float)):
            row[key] = val
    tiered = rec.get("tiered")
    if isinstance(tiered, dict):
        # Rank-sharded tiering: the per-rank partition share (sharded
        # snapshots carry num_shards/owned_shards; host-global tiered
        # ranks only the byte/row figures).
        for key in ("cold_store_bytes", "resident_rows",
                    "num_shards", "owned_shards"):
            val = tiered.get(key)
            if isinstance(val, (int, float)):
                row[f"tiered_{key}"] = val
    timers = (rec.get("stages") or {}).get("timers") or {}
    for short, name in _TIMER_ROWS:
        snap = timers.get(name) or {}
        if not snap.get("count"):
            continue
        row[f"{short}_count"] = snap["count"]
        row[f"{short}_total_s"] = snap.get("total_s", 0.0)
        for pkey in ("mean_ms", "p99_ms"):
            if isinstance(snap.get(pkey), (int, float)):
                row[f"{short}_{pkey}"] = snap[pkey]
    elapsed = rec.get("elapsed")
    if (
        isinstance(elapsed, (int, float)) and elapsed > 0
        and "exchange_total_s" in row
    ):
        # Fraction of this rank's run wall spent blocked at the
        # cross-rank collective barrier (the train.exchange probe) —
        # ~0 at parity, grows by exactly the straggler-induced wait.
        row["exchange_frac"] = round(
            row["exchange_total_s"] / elapsed, 6
        )
    return row


class TrainFleet:
    """Rank 0's live training-fleet aggregator.

    Scrapes each target's ``/status`` every ``interval_s`` seconds on
    its own daemon thread (``interval_s <= 0`` or ``start=False``
    skips the thread — tests drive :meth:`scrape_once` directly).  A
    failed scrape keeps the target's previous record and bumps the
    ``train.fleet_scrape_errors`` counter; the record's age then grows
    until ``scrape_age_max_s`` trips a staleness rule — a dead rank
    degrades to staleness, never to a crash.  ``fetch`` (tests) maps a
    target to its decoded /status record in place of HTTP.
    """

    def __init__(self, targets: Iterable[str], interval_s: float = 0.0,
                 telemetry=None, timeout: float = 2.0,
                 fetch: Optional[Callable[[str], dict]] = None,
                 start: bool = True):
        self.targets = [t.strip() for t in targets if t.strip()]
        self._timeout = timeout
        self._fetch = fetch if fetch is not None else self._http_fetch
        self._lock = threading.Lock()
        self._latest: Dict[str, Tuple[float, dict]] = {}
        self._t_scrape = (
            telemetry.timer("train.fleet_scrape")
            if telemetry is not None else None
        )
        self._c_errors = (
            telemetry.counter("train.fleet_scrape_errors")
            if telemetry is not None else None
        )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start and interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, args=(interval_s,),
                name="tffm-fleet-scrape", daemon=True,
            )
            self._thread.start()

    # -- scrape side ---------------------------------------------------

    def _http_fetch(self, target: str) -> dict:
        with urllib.request.urlopen(
            f"http://{target}/status", timeout=self._timeout
        ) as resp:
            return json.loads(resp.read())

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.scrape_once()
            except Exception as e:  # noqa: BLE001 - keep scraping
                log.warning("fleet scrape pass failed: %s", e)

    def scrape_once(self) -> int:
        """One pass over every target; returns how many answered."""
        if self._t_scrape is not None:
            with self._t_scrape.time():
                return self._scrape_pass()
        return self._scrape_pass()

    def _scrape_pass(self) -> int:
        ok = 0
        for target in self.targets:
            if self._stop.is_set():
                break
            try:
                rec = self._fetch(target)
            except (urllib.error.URLError, OSError, ValueError) as e:
                if self._c_errors is not None:
                    self._c_errors.add()
                log.debug("fleet scrape %s failed: %s", target, e)
                continue
            if isinstance(rec, dict):
                ok += 1
                with self._lock:
                    self._latest[target] = (time.time(), rec)
        return ok

    # -- aggregate side ------------------------------------------------

    def rank_rows(self, now: Optional[float] = None) -> List[dict]:
        now = time.time() if now is None else now
        with self._lock:
            latest = dict(self._latest)
        return [
            _rank_row(target, i, *latest[target], now)
            for i, target in enumerate(self.targets)
            if target in latest
        ]

    def block(self, now: Optional[float] = None) -> dict:
        """The ``fleet`` record block: the shared merge plus live
        straggler attribution."""
        now = time.time() if now is None else now
        with self._lock:
            latest = dict(self._latest)
        rows = [
            _rank_row(target, i, *latest[target], now)
            for i, target in enumerate(self.targets)
            if target in latest
        ]
        out = merge_blocks(
            TRAIN_MERGE_SPEC,
            [(latest[r["target"]][0], r) for r in rows],
            now,
        )
        # Straggler attribution from the per-rank dispatch/wait means.
        disp = [
            r for r in rows
            if isinstance(r.get("dispatch_mean_ms"), (int, float))
        ]
        if disp:
            fleet_mean = (
                sum(r["dispatch_mean_ms"] for r in disp) / len(disp)
            )
            slowest = max(disp, key=lambda r: r["dispatch_mean_ms"])
            if fleet_mean > 0:
                out["straggler_ratio"] = round(
                    slowest["dispatch_mean_ms"] / fleet_mean, 4
                )
            out["slowest_rank"] = slowest["rank"]
            walls = [
                r.get("dispatch_total_s") for r in disp
                if isinstance(r.get("dispatch_total_s"), (int, float))
            ]
            total_wall = sum(walls) if walls else 0.0
            if total_wall > 0 and isinstance(
                slowest.get("dispatch_total_s"), (int, float)
            ):
                out["slowest_rank_share"] = round(
                    slowest["dispatch_total_s"] / total_wall, 4
                )
            means = [r["dispatch_mean_ms"] for r in disp]
            out["dispatch_skew_ms"] = round(max(means) - min(means), 4)
        waits = [
            r["wait_mean_ms"] for r in rows
            if isinstance(r.get("wait_mean_ms"), (int, float))
        ]
        if waits:
            out["wait_skew_ms"] = round(max(waits) - min(waits), 4)
        steps = [
            r["step"] for r in rows
            if isinstance(r.get("step"), (int, float))
        ]
        if steps:
            out["rank_step_skew"] = int(max(steps) - min(steps))
        fracs = [
            r["exchange_frac"] for r in rows
            if isinstance(r.get("exchange_frac"), (int, float))
        ]
        if fracs:
            # The fleet's worst rank IS the aggregate (same reasoning
            # as the skew PSI max-merge): one rank stuck at the
            # barrier is the signal, and a mean would dilute it.
            out["exchange_frac"] = round(max(fracs), 6)
        cold = [
            r["tiered_cold_store_bytes"] for r in rows
            if isinstance(r.get("tiered_cold_store_bytes"), (int, float))
        ]
        if cold:
            # Rank-sharded tiering: the fleet's logical cold store is
            # the SUM of the rank shards (each id range lives on
            # exactly one rank); owned summed against num_shards is
            # the partition-coverage check — fewer means an id range
            # has no owner flushing its write-backs.
            out["tiered_cold_store_bytes"] = int(sum(cold))
            owned = [
                r["tiered_owned_shards"] for r in rows
                if isinstance(r.get("tiered_owned_shards"), (int, float))
            ]
            shards = [
                r["tiered_num_shards"] for r in rows
                if isinstance(r.get("tiered_num_shards"), (int, float))
            ]
            if owned and shards:
                out["tiered_owned_shards"] = int(sum(owned))
                out["tiered_num_shards"] = int(max(shards))
        return out

    def metrics_lines(self, now: Optional[float] = None) -> str:
        """Per-rank ``tffm_train_rank_*`` labeled series (the
        StatusServer ``metrics_extra`` payload)."""
        rows = self.rank_rows(now)
        lines: List[str] = []
        for key, name, mtype in RANK_SERIES:
            lines.extend(labeled_lines(name, mtype, [
                ({"rank": r["rank"]}, r[key])
                for r in rows
                if isinstance(r.get(key), (int, float))
            ]))
        return "\n".join(lines) + "\n" if lines else ""

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
