"""K1 (dedup and merge modes) at the shapes the main paths launch it at,
beside an earlier tree's K1, its plain version, its ``index_add_``
yardstick and its byte bound.

    python -m fast_tffm_tpu_torch.tools.k1_bench [--parent TREE]
        [--shapes NAME ...] [--turns 2]

Needs a CUDA device and ``nvcc``.  Each shape's ids are made from a seed
with the statistics of the stream the smoke's record times there (see
``SHAPES``): Criteo-Kaggle's parsed batch (13 integer features of 50
buckets, 26 uniform categorical ids a line), Avazu's (22 Zipf-valued
fields and two padding slots of id 0 a line), config 4's batch at
uniform categorical ids, Zipf(1.1) streams, the probe's uniform stream
with one hot id, and path 12's shard shapes (a 2 x 2 mesh's data block on
model shard 1, the off-shard occurrences at the sentinel, left out).
Per shape, in one process on one card:

- ``kernel``: ``ops.sparse_apply.k1_dedup_cuda`` / ``k1_merge_cuda``;
- ``parent`` (``--parent TREE``): the ``k1_dedup`` / ``k1_merge`` entry
  points of ``TREE/fast_tffm_tpu_torch/ops/csrc/sparse_apply.cu`` (an
  unpacked earlier commit whose K1 takes no workspace), built here with
  ``nvcc`` alone;
- ``plain``: ``k1_dedup_plain`` / ``k1_merge_plain``;
- ``library``: one ``index_add_`` of the real occurrences' payload
  (``[g | g^2]`` in dedup mode) over their segments.

Every kernel's rows are checked against the plain version's and its
sums, over the batch's U rows, against the plain version in float64
within ``k1_error_bound`` of its order (the parent's: one piece, its
one-warp order); each kernel is bitwise over two calls, and the join
counters are back at zero after every call.  ``bitwise_parent`` says
whether this tree's sums equal the parent's; they must where no segment
is longer than ``K1_PIECE``, and a shape where they do not fails the
run.  Each variant is timed in CUDA graphs
on as many copies of its inputs, taken in turn, as pass twice the 50 MB
L2, so its reads come from HBM (the median of 5 replays), the list in
order and reversed in turn (``--turns``); ``ms`` is the least.  Prints
the card's name and power limit, then one JSON line a shape and one for
all, and the registers and spills ``ptxas`` gives each build's K1.  The
builds go to ``ops/_build/k1_bench/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from fast_tffm_tpu_torch.tools.bench_common import (
    build_lib, in_turn, k1_bound_ms, k1_library, l2_copies,
)

LINES = 4096  # Criteo-Kaggle's batch (examples/criteo_kaggle.cfg)
SHARD_LO = 1 << 21  # model shard 1 of a 2 x 2 mesh at V = 2^22
HOT = 5000  # the smoke's HOT_OCCURRENCES
# Avazu's 22 feature columns and their cardinalities (chip_smoke.py's
# AVAZU_FIELDS).
AVAZU_CARDS = (240, 7, 7, 4737, 7745, 26, 8552, 559, 36, 2686408, 6729486,
               8251, 5, 4, 2626, 8, 9, 435, 4, 68, 172, 60)
# name: (what the smoke times there, its record).
SHAPES = {
    "criteo_whole": "the train step's K1 on the whole [n + 1] slot, "
                    "kernel_timing's k1_dedup",
    "criteo_cut": "the same batch on its cut [U + 1] slot (cut_slot)",
    "criteo_hot": "the batch with one id of 5000 occurrences, "
                  "k1_dedup's streams.hot",
    "probe": "the probe's uniform stream with one hot id, "
             "k1_dedup's streams.probe",
    "d33": "FFM-Criteo's D = 33 on the whole slot, k1_dedup_d33",
    "merge": "two data blocks' entry streams, kernel_timing's k1_merge",
    "merge_dense": "the dense gradient's merge mode at W = 9 on the whole "
                   "slot (path 9)",
    "d33_shard": "D = 33 on a shard, the sentinel left out, "
                 "k1_dedup_d33_shard (path 12)",
    "merge_w66": "two blocks' FFM entry streams, k1_merge_w66 (path 12)",
    "merge_w9": "a block's row gradients on a shard, k1_merge_w9 (path 12)",
    "avazu": "config 2's batch on the whole slot, k1_dedup_avazu",
    "c1tb": "config 4's batch at uniform ids on the whole slot, "
            "k1_dedup_c1tb",
    "zipf_c1tb": "a Zipf(1.1) stream of config 4's n, k1_zipf_stream",
    "zipf_criteo": "a Zipf(1.1) stream of Criteo-Kaggle's n over 2^22, "
                   "k1_zipf_stream_criteo_kaggle",
}


def k1_registers(log: str) -> dict:
    """``{"<mode><columns>": "<N> registers, <S> bytes spill stores"}``
    from ``ptxas -v``'s lines on the K1 kernels (``k1_kernelILb1ELi16``
    is dedup mode, 16 columns a pass)."""
    out, mode = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mode = None
            if "k1_kernelILb" in line:
                flag, cols = line.split("k1_kernelILb")[1].split("ELi")[:2]
                mode = ("dedup" if flag.startswith("1") else "merge") + \
                    cols.split("E")[0]
        elif mode and "spill stores" in line:
            out[mode] = line.split(",")[1].strip()
        elif mode and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split("registers")[0].strip()
            out[mode] = f"{regs} registers, {out.get(mode, '')}"
            mode = None
    return out


def criteo_ids(rng, lines: int, vocab: int) -> np.ndarray:
    """``[lines, 39]`` ids shaped like a parsed Criteo-Kaggle batch: 13
    integer features of 50 buckets (650 ids of ~lines / 50 occurrences)
    and 26 categorical ids uniform over ``vocab``."""
    ints = rng.integers(0, 50, (lines, 13)) + 50 * np.arange(13)
    int_ids = (ints * 2654435761) % vocab
    cats = rng.integers(0, vocab, (lines, 26))
    return np.concatenate([int_ids, cats], axis=1).astype(np.int32)


def avazu_ids(rng, lines: int, vocab: int) -> np.ndarray:
    """``[lines, 24]`` ids shaped like a parsed Avazu batch: 22 fields,
    each value's rank Zipf(1.1) over its cardinality (as the smoke's
    ``write_avazu``), hashed into ``[1, vocab)``, then two padding slots
    of id 0."""
    cols = []
    for j, card in enumerate(AVAZU_CARDS):
        u = rng.uniform(size=lines)
        r = (1.0 - u * (1.0 - (card + 1.0) ** -0.1)) ** -10.0
        rank = np.minimum(r.astype(np.int64) - 1, card - 1)
        cols.append((rank * 2654435761 + j * 40503) % (vocab - 1) + 1)
    cols += [np.zeros(lines, np.int64)] * 2
    return np.stack(cols, axis=1).astype(np.int32)


def zipf_ids(rng, n: int, vocab: int) -> np.ndarray:
    """``n`` Zipf(1.1) ranks spread over ``vocab`` rows by an odd
    multiplier (the smoke's ``k1_zipf_timing``)."""
    ranks = np.minimum(rng.zipf(1.1, n), 1 << 31)
    return ((ranks * 2654435761) % vocab).astype(np.int32)


class Case:
    """One timed K1 call: mode, payload, ids, the sort meta's perm and
    the slot timed, the cut slot (the batch's U rows, the bound's and
    the library's)."""

    def __init__(self, mode, pay, ids, perm, slot, cut):
        self.mode, self.pay, self.ids = mode, pay, ids
        self.perm, self.slot, self.cut = perm, slot, cut
        self.n = pay.shape[0]
        self.u = cut.numel() - 1
        self.n_real = int(cut[-1])
        self.width = pay.shape[1] * (2 if mode == "dedup" else 1)
        counts = cut[1:] - cut[:-1]
        self.longest = int(counts.max()) if self.u else 0

    def args(self):
        return self.pay, self.ids, self.perm, self.slot

    def clone(self):
        return Case(self.mode, *(t.clone() for t in self.args()), self.cut)


def make_case(name: str, dev) -> Case:
    """The shape's K1 call, its ids and payload from a seed."""
    from fast_tffm_tpu_torch.ops import sparse_apply as sa

    rng = np.random.default_rng(sum(map(ord, name)))
    gen = torch.Generator(device=dev).manual_seed(len(name))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def normal(n, d):
        return torch.randn((n, d), generator=gen, device=dev) * 0.1

    def dedup(ids, d, whole=True, drop_from=None, g=None):
        ids = ids.reshape(-1)
        meta = sa.sort_meta(ids, drop_from=drop_from)
        cut = sa.cut_slot(meta).seg_start
        g = normal(ids.numel(), d) if g is None else g
        return Case("dedup", g, ids, meta.perm,
                    meta.seg_start if whole else cut, cut)

    def merge(rows, pay, whole=True, drop_from=None):
        meta = sa.sort_meta(rows, drop_from=drop_from)
        cut = sa.cut_slot(meta).seg_start
        return Case("merge", pay, rows, meta.perm,
                    meta.seg_start if whole else cut, cut)

    def shard_block(block: int, lines: int):
        """A data block of a 2 x 2 mesh's Criteo-Kaggle batch on model
        shard 1: its local ids (off-shard at the sentinel) and mask."""
        ids = put(criteo_ids(np.random.default_rng(block), lines, 1 << 22)
                  ).reshape(-1)
        own = ids >= SHARD_LO
        return (torch.where(own, ids - SHARD_LO, SHARD_LO)
                .to(torch.int32).contiguous(), own)

    def entries(lines: int, d: int):
        """Two blocks' deduped entry streams on shard 1, concatenated as
        the entries exchange gathers them."""
        streams = []
        for block in (0, 1):
            lids, own = shard_block(block, lines)
            g = normal(lids.numel(), d) * own[:, None]
            cap = sa.entries_cap(lids.numel(), SHARD_LO)
            streams.append(sa.unique_entries(lids, g, vocab=SHARD_LO,
                                             cap=cap))
        return (torch.cat([r for r, _, _ in streams]),
                torch.cat([p for _, p, _ in streams]))

    criteo = put(criteo_ids(rng, LINES, 1 << 22))
    if name in ("criteo_whole", "criteo_cut"):
        return dedup(criteo, 9, whole=name == "criteo_whole")
    if name == "criteo_hot":
        hot = criteo.reshape(-1).clone()
        hot[:HOT] = 12345
        return dedup(hot, 9, whole=False)
    if name == "probe":
        ids = put(rng.integers(0, 1 << 22, 16384 * 39).astype(np.int32))
        ids[:HOT] = 54321
        return dedup(ids, 9, whole=False)
    if name == "d33":
        return dedup(criteo, 33)
    if name == "merge":
        rows, pay = entries(LINES // 2, 9)
        return merge(rows, pay, whole=False, drop_from=SHARD_LO)
    if name == "merge_dense":
        ids = criteo.reshape(-1)
        return merge(ids, normal(ids.numel(), 9))
    if name == "d33_shard":
        lids, own = shard_block(0, LINES // 2)
        g = normal(lids.numel(), 33) * own[:, None]
        return dedup(lids, 33, whole=False, drop_from=SHARD_LO, g=g)
    if name == "merge_w66":
        rows, pay = entries(LINES // 2, 33)
        return merge(rows, pay, whole=False, drop_from=SHARD_LO)
    if name == "merge_w9":
        lids, own = shard_block(0, LINES // 2)
        return merge(lids, normal(lids.numel(), 9) * own[:, None],
                     whole=False, drop_from=SHARD_LO)
    if name == "avazu":
        return dedup(put(avazu_ids(rng, 8192, 1 << 24)), 9)
    if name == "c1tb":
        return dedup(put(criteo_ids(rng, 262144, 1 << 26)), 9)
    if name == "zipf_c1tb":
        return dedup(put(zipf_ids(rng, 262144 * 39, 1 << 26)), 9,
                     whole=False)
    if name == "zipf_criteo":
        return dedup(put(zipf_ids(rng, LINES * 39, 1 << 22)), 9,
                     whole=False)
    raise ValueError(f"unknown shape {name!r}")


def bound(case: Case):
    """``(ms, "bytes" | "operations")``: K1's bound over the real
    occurrences and the timed slot."""
    return k1_bound_ms(case.n_real, case.u, case.pay.shape[1],
                       slot=case.slot.numel() - 1,
                       square=case.mode == "dedup")


def native(lib, case: Case):
    """A call of an earlier tree's K1 entry point for the case's mode
    (no workspace, no join counters)."""
    fn = getattr(lib, f"k1_{case.mode}")

    def call(pay, ids, perm, slot):
        u = slot.numel() - 1
        dev = pay.device
        urows = torch.empty((u,), dtype=torch.int32, device=dev)
        sums = torch.empty((u, case.width), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[t.data_ptr() for t in (pay, ids, perm, slot, urows, sums)],
                 u, pay.shape[1], stream)
        if err:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
        return urows, sums
    return call


def check(case: Case, fn, piece: int, pending) -> dict:
    """Rows exact, sums within the bound of ``piece``'s order of the
    float64 plain version, bitwise over two calls, the join counters at
    zero after: ``{"ok": ..., "max_err": ..., "sums": ...}``."""
    from fast_tffm_tpu_torch.ops import sparse_apply as sa

    plain = getattr(sa, f"k1_{case.mode}_plain")
    rows, sums = fn(*case.args())
    rows2, sums2 = fn(*case.args())
    torch.cuda.synchronize()
    u = case.u
    want_rows, want = plain(case.pay.double(), *case.args()[1:])
    _, mass = plain(case.pay.abs().double(), *case.args()[1:])
    err = (sums[:u].double() - want[:u]).abs()
    ok = bool(torch.equal(rows, want_rows) and torch.equal(rows, rows2)
              and torch.equal(sums[:u], sums2[:u])
              and torch.all(err <= sa.k1_error_bound(case.cut, mass[:u],
                                                     piece=piece)))
    if pending is not None:
        ok = ok and pending() == 0
    out = {"ok": ok, "max_err": float(err.max()) if u else 0.0,
           "sums": sums[:u].clone()}
    del want, mass, err, sums2
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier tree of this repo whose "
                    "sparse_apply.cu K1 to time beside the kernel")
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--turns", type=int, default=2,
                    help="times each variant is timed, the list in order "
                    "and reversed in turn (default 2)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_bench: needs a CUDA device", file=sys.stderr)
        return 1
    from fast_tffm_tpu_torch.ops import _build
    from fast_tffm_tpu_torch.ops import sparse_apply as sa
    from fast_tffm_tpu_torch.tools.fm_widths import graph_ms

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(card, flush=True)
    parent = None
    registers = {}
    if args.parent:
        csrc = os.path.join(os.path.abspath(args.parent),
                            "fast_tffm_tpu_torch", "ops", "csrc")
        parent, log = build_lib(os.path.join(_build.BUILD_DIR, "k1_bench"),
                                "parent", os.path.join(csrc, "sparse_apply.cu"),
                                csrc)
        registers["parent"] = k1_registers(log)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for entry in ("k1_dedup", "k1_merge"):
            getattr(parent, entry).argtypes = [ptr] * 6 + [i32, i32, ptr]
            getattr(parent, entry).restype = i32
    registers["kernel"] = k1_registers(_build.build(force=True))
    print(json.dumps({"registers": registers}), flush=True)
    record = {}
    for name in args.shapes:
        case = make_case(name, dev)
        b_ms, b_by = bound(case)
        copies = [case] + [case.clone() for _ in range(l2_copies(b_ms) - 1)]
        calls = 10 if b_ms > 0.1 else max(20, 3 * len(copies))
        kern = getattr(sa, f"k1_{case.mode}_cuda")
        plain = getattr(sa, f"k1_{case.mode}_plain")
        fns = {"kernel": (kern, sa.K1_PIECE, sa.k1_joins_pending)}
        if parent is not None:
            fns["parent"] = (native(parent, case), max(case.longest, 1), None)
        rec = {"what": SHAPES[name], "mode": case.mode, "occurrences": case.n,
               "real_occurrences": case.n_real, "unique_rows": case.u,
               "slot": case.slot.numel() - 1, "width": case.width,
               "longest_segment": case.longest,
               "pieces_of_longest": -(-case.longest // sa.K1_PIECE),
               "bound_ms": b_ms, "bound_by": b_by,
               "input_copies": len(copies), "calls": calls,
               "checks": {}, "max_err": {}}
        sums = {}
        for vname, (fn, piece, pending) in fns.items():
            got = check(case, fn, piece, pending)
            rec["checks"][vname] = got["ok"]
            rec["max_err"][vname] = got["max_err"]
            sums[vname] = got["sums"]
        if "parent" in sums:
            rec["bitwise_parent"] = bool(torch.equal(sums["kernel"],
                                                     sums["parent"]))
            if case.longest <= sa.K1_PIECE:
                # No segment is split: the sums must be the parent's.
                rec["checks"]["bitwise_parent"] = rec["bitwise_parent"]
        del sums
        in_args = [c.args() for c in copies]
        timed = {"plain": in_turn(plain, in_args),
                 "library": in_turn(lambda f: f(), [
                     (k1_library(c.pay, c.perm, c.cut,
                                 square=c.mode == "dedup"),)
                     for c in copies])}
        timed.update({v: in_turn(f, in_args) for v, (f, _, _) in fns.items()})
        rec["graph_ms"] = {v: [] for v in timed}
        order = list(timed)
        for turn in range(args.turns):
            for vname in order[::-1 if turn % 2 else 1]:
                rec["graph_ms"][vname].append(
                    graph_ms(timed[vname], calls=calls, reps=5))
        rec["ms"] = {v: min(t) for v, t in rec["graph_ms"].items()}
        if "parent" in rec["ms"]:
            rec["kernel_over_parent"] = rec["ms"]["kernel"] / rec["ms"][
                "parent"]
        record[name] = rec
        print(json.dumps({name: rec["ms"], "checks": rec["checks"],
                          "bitwise_parent": rec.get("bitwise_parent"),
                          "longest_segment": case.longest,
                          "bound_ms": b_ms}), flush=True)
        del copies, case, fns, timed, in_args
        torch.cuda.empty_cache()
    print(json.dumps({"k1_bench": record, "registers": registers,
                      "card": card}), flush=True)
    ok = all(all(r["checks"].values()) for r in record.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
