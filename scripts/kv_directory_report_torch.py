#!/usr/bin/env python3
"""Dump the fleet-wide KV directory from a live cache server.

The port's copy of ``scripts/kv_directory_report.py``, over the port's
``kvoffload/protocol.py``: for the same directory its ``--json`` output is
the original's.

Debugging surface for fleet-warm tests and production triage
(docs/kv-directory.md): prints per-engine residency (resident vs shared
chunk counts, generation, liveness), the resident chain-depth histogram,
and the staleness/expiry accounting — the numbers that tell you whether
KV-aware routing v2 is seeing the fleet you think it is.

Usage:
    python scripts/kv_directory_report_torch.py --url 127.0.0.1:8200
    python scripts/kv_directory_report_torch.py --url 127.0.0.1:8200 --json
"""

from __future__ import annotations

import argparse
import json
import sys

sys.path.insert(0, ".")  # runnable as a plain script from the repo root

from production_stack_tpu_torch.kvoffload.protocol import BlockingClient, parse_hostport  # noqa: E402


def fetch(url: str, timeout: float = 10.0) -> dict:
    """One round trip each for the dump + raw stats (blob-map counters)."""
    host, port = parse_hostport(url, default_port=8200)
    client = BlockingClient(host, port, timeout=timeout)
    try:
        dump, _ = client.request({"op": "dir_dump"})
        stats, _ = client.request({"op": "stats"})
    finally:
        client.close()
    if not dump.get("ok"):
        raise RuntimeError(f"dir_dump failed: {dump.get('error')}")
    dump.pop("ok", None)
    dump["cache_server"] = {
        k: stats.get(k)
        for k in ("entries", "used_bytes", "max_bytes", "hits", "gets", "corrupt")
    }
    return dump


def _bar(n: int, scale: int, width: int = 40) -> str:
    return "#" * max(1 if n else 0, round(width * n / max(scale, 1)))


def render(dump: dict) -> str:
    lines = ["=== fleet-wide KV directory ==="]
    lines.append(
        f"entries={dump.get('kv_directory_entries', 0)} "
        f"chunks={dump.get('kv_directory_chunks', 0)} "
        f"engines={dump.get('kv_directory_engines', 0)}"
    )
    lines.append(
        f"publishes={dump.get('kv_directory_publishes_total', 0)} "
        f"withdrawals={dump.get('kv_directory_withdrawals_total', 0)} "
        f"stale_hits={dump.get('kv_directory_stale_hits_total', 0)} "
        f"expired={dump.get('kv_directory_expired_entries_total', 0)} "
        f"lookups={dump.get('kv_directory_lookups_total', 0)}"
    )
    cs = dump.get("cache_server") or {}
    lines.append(
        f"blob tier: {cs.get('entries', 0)} blobs, "
        f"{(cs.get('used_bytes') or 0) / 1e6:.1f} MB used, "
        f"{cs.get('corrupt', 0)} quarantined"
    )
    lines.append("")
    lines.append("--- per-engine residency ---")
    engines = dump.get("engines") or {}
    if not engines:
        lines.append("(no engines registered)")
    for url in sorted(engines):
        e = engines[url]
        lines.append(
            f"{url}: resident={e.get('resident_chunks', 0)} "
            f"shared={e.get('shared_chunks', 0)} "
            f"page_size={e.get('page_size', 0)} "
            f"generation={e.get('generation', 0)} "
            f"{'ALIVE' if e.get('alive') else 'EXPIRED (resident claims dropped)'}"
        )
    lines.append("")
    lines.append("--- resident chain-depth histogram ---")
    hist = dump.get("depth_histogram") or {}
    if not hist:
        lines.append("(no resident chunks)")
    else:
        peak = max(hist.values())
        for depth in sorted(hist, key=int):
            n = hist[depth]
            lines.append(f"depth {int(depth):4d}: {n:6d} {_bar(n, peak)}")
    return "\n".join(lines)


def main() -> int:
    p = argparse.ArgumentParser("kv-directory-report")
    p.add_argument("--url", default="127.0.0.1:8200",
                   help="cache server address hosting the directory")
    p.add_argument("--json", action="store_true",
                   help="raw JSON dump instead of the rendered report")
    args = p.parse_args()
    try:
        dump = fetch(args.url)
    except Exception as e:  # noqa: BLE001 - CLI surface
        print(f"kv_directory_report: cannot reach {args.url}: {e}")
        return 1
    if args.json:
        print(json.dumps(dump, indent=2, sort_keys=True))
    else:
        print(render(dump))
    return 0


if __name__ == "__main__":
    sys.exit(main())
