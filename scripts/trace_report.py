#!/usr/bin/env python
"""Summarize a jax.profiler Chrome trace (*.trace.json.gz): total GPU
device time per kernel, sorted, summed over the device's streams.

  python scripts/trace_report.py PROFILE_DIR_OR_TRACE [n_top]

A Pallas kernel appears under the `name` its pallas_call gives it (for
example `social_attention`); XLA's fusions under their fusion names.
"""

import collections
import glob
import gzip
import json
import sys


def load(path):
    if not path.endswith(".json.gz"):
        hits = sorted(glob.glob(path + "/**/*.trace.json.gz", recursive=True))
        assert hits, f"no trace under {path}"
        path = hits[-1]
    with gzip.open(path) as f:
        return json.load(f)["traceEvents"], path


def main():
    ev, path = load(sys.argv[1])
    n_top = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    pids, tids = {}, {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e["pid"]] = e["args"].get("name", "")
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tids[(e["pid"], e["tid"])] = e["args"].get("name", "")
    dev = [p for p, name in pids.items() if "/device:GPU" in (name or "")]
    if not dev:
        raise SystemExit(f"no GPU device process in {path}: {pids}")
    cnt, dur = collections.Counter(), collections.Counter()
    for e in ev:
        if e.get("ph") == "X" and e.get("pid") in dev:
            key = (tids.get((e["pid"], e["tid"]), ""), e.get("name"))
            cnt[key] += 1
            dur[key] += e.get("dur", 0)
    print(f"# {path}")
    mod_total = sum(d for (tn, _), d in dur.items() if "Modules" in tn)
    for (tn, name), d in dur.most_common(n_top):
        frac = f" {d / mod_total:5.1%}" if "Ops" in tn and mod_total else ""
        print(f"{d / 1e3:10.2f} ms  n={cnt[(tn, name)]:6d}{frac}  "
              f"[{tn}] {name[:80]}")


if __name__ == "__main__":
    main()
