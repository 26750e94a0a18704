#!/usr/bin/env python3
"""The spread of a replay experiment's ratios over several calls: reads
the --json records of separate calls of one tools/torch_exp_*.py tool
and, for each variant, takes each call's median rate over its reps,
divides it by the same call's median of the first variant (the tool's
default), and reports the quartiles of those ratios over the calls, and
of the share of the default's ms a scan that the variant removes
(1 - 1/ratio). A ranking of two variants holds where their interquartile
ranges do not overlap.

    python tools/torch_exp_spread.py run1.json run2.json ... [--json out.json]

Prints ONE JSON line. Needs no card and imports neither torch nor JAX.
"""
import argparse
import json

import _torch_tool
import numpy as np


def rows(record: dict) -> dict:
    """{variant: row} of one tool's record, in the tool's order: its `rows`
    where it has them, else its top-level rows (those with `rates`)."""
    return record.get("rows") or {k: v for k, v in record.items() if isinstance(v, dict) and "rates" in v}


def spread(records: list) -> dict:
    cards = {(r["device"], r["power_limit_w"]) for r in records}
    if len(cards) != 1:
        raise SystemExit(f"the calls ran on different cards or limits: {sorted(map(str, cards))}")
    tables = [rows(r) for r in records]
    names = list(tables[0])
    if any(list(t) != names for t in tables):
        raise SystemExit("the calls report different variants")
    base = names[0]
    out = {}
    for name in names:
        ratios = np.array([np.median(t[name]["rates"]) / np.median(t[base]["rates"]) for t in tables])
        out[name] = {
            "ratios": ratios.tolist(),
            "ratio_quartiles": np.percentile(ratios, [25, 50, 75]).tolist(),
            "share_quartiles": np.percentile(1.0 - 1.0 / ratios, [25, 50, 75]).tolist(),
        }
    device, power = cards.pop()
    return {"calls": len(records), "base": base, "variants": out, "device": device, "power_limit_w": power}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("records", nargs="+", help="--json records of separate calls of one experiment")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    records = []
    for path in args.records:
        with open(path) as f:
            records.append(json.load(f))
    result = spread(records)
    print(json.dumps(result), flush=True)
    _torch_tool.write_json(args.json, result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
