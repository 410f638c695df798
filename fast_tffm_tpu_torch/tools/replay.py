"""Re-drive a TFC1 traffic capture against a live scoring endpoint and
judge bitwise score parity.

A serving process with ``serve_capture_sample``/``serve_capture_file``
set records sampled request/response frame pairs (the binary TFB1 wire
frames, verbatim) into a rotating capture file — see SERVING.md
"Capture & replay"; a fleet writes one file per replica,
``<path>.replicaN``.  This tool closes the loop: every captured request
is POSTed to a live ``/score_bin`` and the response bytes are compared
against the recorded ones BIT FOR BIT.

Bitwise is the honest bar, and it is achievable: capture happens after
decode (ids reduced mod vocabulary_size, arrays padded to the feature
cap), so a captured frame is in canonical form and re-decoding it is
idempotent — the same checkpoint must produce the same float32 scores.
A mismatch therefore means something REAL changed: a different
checkpoint step, a different kernel/dtype, a quantization change, or a
scoring regression.

Usage:
    python -m fast_tffm_tpu_torch.tools.replay CAPTURE \
        --endpoint http://127.0.0.1:8300
    python -m fast_tffm_tpu_torch.tools.replay CAPTURE --endpoint ... \
        --limit 100

Exit codes: 0 = every replayed response matched bitwise; 2 = at least
one mismatch (first few diffs reported with max |delta|); 1 = could
not replay at all (no records, endpoint unreachable).

The PyTorch port's copy of the repo's ``tools/replay.py``, reading the
capture with the port's ``serve/wire.py``; the same output lines and
exit codes.  It imports no torch.
"""

from __future__ import annotations

import argparse
import sys
import urllib.error
import urllib.request

from fast_tffm_tpu_torch.serve import wire

__all__ = ["main", "replay"]


def _post(url: str, body: bytes, timeout: float) -> bytes:
    req = urllib.request.Request(
        url, data=body,
        headers={"Content-Type": "application/octet-stream"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def replay(capture: str, endpoint: str, limit: int = 0,
           timeout: float = 30.0, out=sys.stdout) -> int:
    """Replay ``capture`` against ``endpoint``; returns the exit code."""
    # Materialize the record list BEFORE the first POST: replaying
    # against an endpoint that is itself capturing (sample 1.0) appends
    # to a file we might otherwise still be reading.
    try:
        records = list(wire.read_capture(capture))
    except (OSError, ValueError) as e:
        print(f"replay: cannot read capture {capture!r}: {e}", file=out)
        return 1
    if limit > 0:
        records = records[:limit]
    if not records:
        print(f"replay: {capture!r} holds no records", file=out)
        return 1
    url = endpoint.rstrip("/") + "/score_bin"
    matched = 0
    mismatches = []
    for i, (_t, req_frame, resp_frame) in enumerate(records):
        try:
            got = _post(url, req_frame, timeout)
        except (urllib.error.URLError, OSError) as e:
            print(f"replay: request {i} failed against {url}: {e}",
                  file=out)
            return 1
        if got == resp_frame:
            matched += 1
            continue
        # Decode both sides for the report: bitwise already failed,
        # the float delta says whether this is noise-sized (kernel /
        # dtype change) or a different model entirely.
        detail = "undecodable"
        try:
            want_scores = wire.decode_bin_response(resp_frame)
            got_scores = wire.decode_bin_response(got)
            if want_scores.shape == got_scores.shape:
                delta = float(
                    abs(want_scores - got_scores).max()
                ) if want_scores.size else 0.0
                detail = f"max |delta| {delta:.3e}"
            else:
                detail = (
                    f"shape {want_scores.shape} -> {got_scores.shape}"
                )
        except Exception:
            pass
        mismatches.append((i, detail))
    print(
        f"replay: {matched}/{len(records)} responses bitwise-identical "
        f"({capture} -> {url})", file=out,
    )
    if mismatches:
        for i, detail in mismatches[:5]:
            print(f"  MISMATCH request {i}: {detail}", file=out)
        if len(mismatches) > 5:
            print(f"  ... and {len(mismatches) - 5} more", file=out)
        return 2
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fast_tffm_tpu_torch.tools.replay",
        description="Replay a TFC1 serve traffic capture against a "
                    "live endpoint, judging bitwise score parity."
    )
    ap.add_argument("capture", help="TFC1 capture file path")
    ap.add_argument(
        "--endpoint", required=True,
        help="live server base URL, e.g. http://127.0.0.1:8300",
    )
    ap.add_argument(
        "--limit", type=int, default=0,
        help="replay at most N records (0 = all)",
    )
    ap.add_argument(
        "--timeout", type=float, default=30.0,
        help="per-request timeout in seconds",
    )
    args = ap.parse_args(argv)
    return replay(
        args.capture, args.endpoint, limit=args.limit,
        timeout=args.timeout,
    )


if __name__ == "__main__":
    sys.exit(main())
