"""Aggregate device op times from a torch.profiler Chrome trace (the
counterpart of scripts/parse_trace.py, which reads a jax.profiler
``*.trace.json.gz``).

    python -m ugrt_torch.micro.parse_trace [trace_dir_or_file] [top_n]

Reads ``*.pt.trace.json`` (or ``.json.gz``), or the newest one under a
directory (default: the current one).  Keeps the events on the card's
tracks, the kernel, memcpy and memset categories, never a host thread's,
as ugrt keeps only the device processes (parse_trace.py:29-37).  Groups
them by name with ugrt's two substitutions (:47-48), so that kernels
differing only in template numbers or suffixes share a group, and
prints ugrt's two outputs: the total device op time, and ms, count and
group per line in descending order of ms.  Then one line more: the
device span from the first device event's start to the last one's end,
and the busy share, summed device time over that span.

It reads a file and needs no card.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import sys
from collections import defaultdict
from glob import glob
from typing import NamedTuple

# torch.profiler's categories of work on the card's tracks (older
# versions spell them "Kernel", "Memcpy", "Memset").
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy",
                     "memset")


class Summary(NamedTuple):
    """Device time of a trace: total ms, (group, ms, count) rows in
    descending order of ms, the span from the first device event to the
    last in ms, and total / span."""

    total_ms: float
    rows: list
    span_ms: float
    busy: float


def newest_trace(path: str) -> str:
    """``path`` if it names a trace file, else the newest trace under
    the directory ``path``."""
    if path.endswith((".json", ".json.gz")):
        return path
    cands = (glob(os.path.join(path, "**", "*.pt.trace.json"), recursive=True)
             + glob(os.path.join(path, "**", "*.pt.trace.json.gz"),
                    recursive=True))
    if not cands:
        raise FileNotFoundError(f"no *.pt.trace.json under {path}")
    return max(cands, key=os.path.getmtime)


def load(path: str) -> dict:
    """The trace at ``path`` (a file, or the newest one under a
    directory), as its JSON object."""
    path = newest_trace(path)
    print(f"# {path}", file=sys.stderr)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def device_events(trace: dict) -> list:
    """The complete events ("ph" X) of the card's tracks."""
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"
            and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]


def group_key(name: str) -> str:
    """ugrt's grouping: a numeric suffix dropped, then every run of
    digits replaced by '#'."""
    return re.sub(r"\d+", "#", re.sub(r"\.\d+$", "", name))


def aggregate(events, top_n: int | None = None) -> Summary:
    """Sum ``events`` (durations in us) by ``group_key``; the rows are
    the ``top_n`` groups of most ms (all when None)."""
    agg = defaultdict(float)
    cnt = defaultdict(int)
    total = 0.0
    for e in events:
        dur = e.get("dur", 0) / 1000.0  # us -> ms
        key = group_key(e.get("name", ""))
        agg[key] += dur
        cnt[key] += 1
        total += dur
    rows = [(k, v, cnt[k]) for k, v in
            sorted(agg.items(), key=lambda kv: -kv[1])][:top_n]
    span = 0.0
    if events:
        span = (max(e["ts"] + e.get("dur", 0) for e in events)
                - min(e["ts"] for e in events)) / 1000.0
    return Summary(total, rows, span, total / span if span > 0 else 0.0)


def print_summary(s: Summary) -> None:
    """ugrt's printout of a summary, then the span and busy share."""
    print(f"total device op time: {s.total_ms:.1f} ms (all traced steps)")
    for k, v, c in s.rows:
        print(f"{v:9.2f} ms  x{c:<5d} {k[:110]}")
    print(f"device span: {s.span_ms:.3f} ms; busy {100 * s.busy:.1f}% "
          f"(device op time / span)")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "."
    top_n = int(argv[1]) if len(argv) > 1 else 40
    print_summary(aggregate(device_events(load(path)), top_n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
