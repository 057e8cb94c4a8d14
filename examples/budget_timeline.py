"""Reconstruct a survey run's wall-clock accounting from its per-chunk
budget records, so that every second of wall-clock lands in a named
bucket.

Reads <outDir>/diagnostics/chunk_budgets.jsonl (+ timings.json when
present) and prints, per stage:

* bucket sums (upload / step / device tail / download / host),
* wall_s vs cpu_s per chunk - ``wall_s - cpu_s`` is time the MAIN
  PROCESS spent off-CPU, i.e. waiting on the device or disk (exactly so
  when one core runs the process), while ``cpu_s`` beyond
  the timed buckets is host work (consume-pass assembly + GIL
  contention from the staging/writer threads),
* inter-chunk gaps (staging loop, flush deferral, stage transitions),
* a stall list: chunks or gaps whose unattributed time exceeds a
  threshold, with timestamps and an off-CPU/on-CPU classification, and
  the spacing between consecutive stalls.

Usage: python examples/budget_timeline.py <workDir> [stallThreshold_s]
"""

import json
import os
import sys


def main():
    workDir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/dr5scale"
    thresh = float(sys.argv[2]) if len(sys.argv) > 2 else 10.0
    diagDir = os.path.join(workDir, "out", "diagnostics")
    path = os.path.join(diagDir, "chunk_budgets.jsonl")
    recs = [json.loads(line) for line in open(path) if line.strip()]
    for r in recs:
        r.setdefault("stage", "filter")

    timings = {}
    tPath = os.path.join(diagDir, "timings.json")
    if os.path.exists(tPath):
        timings = json.load(open(tPath))

    stages = {}
    for r in recs:
        stages.setdefault(r["stage"], []).append(r)

    print("# Wall-clock accounting (chunk_budgets.jsonl: %d records)"
          % len(recs))
    allStalls = []
    for stage, rows in stages.items():
        rows.sort(key=lambda r: r.get("t_wall", 0))
        wall = sum(r.get("wall_s", 0) for r in rows)
        cpu = sum(r.get("cpu_s", 0) for r in rows)
        buckets = {}
        for r in rows:
            for k in ("upload", "step", "device", "download"):
                if k in r:
                    buckets[k] = buckets.get(k, 0) + r[k]
        # inter-chunk gaps (previous record end -> this record start)
        gaps = []
        for i in range(1, len(rows)):
            a, b = rows[i - 1], rows[i]
            if "t_wall" in a and "t_wall" in b and "wall_s" in b:
                g = b["t_wall"] - b["wall_s"] - a["t_wall"]
                gaps.append((g, a["t_wall"], b))
        gapSum = sum(max(g, 0) for g, _, _ in gaps)
        span = (rows[-1]["t_wall"] - rows[0]["t_wall"]
                + rows[0].get("wall_s", 0)) if len(rows) > 1 else wall
        print("\n## stage: %s  (%d chunks)" % (stage, len(rows)))
        print("  span (first->last record) : %9.1f s" % span)
        print("  sum in-chunk wall_s       : %9.1f s%s" % (
            wall, "  (OVERLAPPING deferred records - each wall_s is a"
                  " dispatch->consume latency; use the span as the"
                  " stage wall)" if wall > 1.2 * span else ""))
        print("  sum inter-chunk gaps      : %9.1f s  "
              "(staging loop / flush deferral)" % gapSum)
        print("  sum process cpu_s         : %9.1f s" % cpu)
        for k, v in sorted(buckets.items()):
            print("    bucket %-10s         : %9.1f s" % (k, v))
        inBuck = sum(v for k, v in buckets.items() if k != "upload")
        print("  in-chunk unattributed     : %9.1f s  "
              "(wall_s - step/device/download; host work + waits)"
              % (wall - inBuck))
        offCpu = wall - cpu
        print("  in-chunk off-CPU          : %9.1f s  "
              "(wall_s - cpu_s; link/disk waits incl. timed buckets)"
              % offCpu)
        if stage in ("filter",) and "filter" in timings:
            print("  timings.json stage wall   : %9.1f s -> "
                  "%5.1f%% accounted by span"
                  % (timings["filter"], 100.0 * span
                     / max(timings["filter"], 1e-9)))

        # stall candidates: big in-chunk slack or big gaps
        for r in rows:
            slack = r.get("wall_s", 0) - sum(
                r.get(k, 0) for k in ("step", "device", "download"))
            if slack > thresh:
                kind = ("on-CPU (host work)"
                        if r.get("cpu_s", 0) > 0.6 * r.get("wall_s", 1)
                        else "off-CPU (link/disk wait)")
                allStalls.append((r["t_wall"] - r.get("wall_s", 0),
                                  slack, stage,
                                  "chunk %s slack" % r.get("chunk", "?"),
                                  kind))
        for g, t, b in gaps:
            if g > thresh:
                allStalls.append((t, g, stage,
                                  "gap before chunk %s"
                                  % b.get("chunk", "?"), "inter-chunk"))

    if allStalls:
        allStalls.sort()
        t0 = allStalls[0][0]
        print("\n## stalls > %.0f s (%d), spacing between consecutive:"
              % (thresh, len(allStalls)))
        prev = None
        for t, dur, stage, what, kind in allStalls:
            spacing = "" if prev is None else "  (+%.1f s after prev)" \
                % (t - prev)
            print("  t=+%8.1f s  %6.1f s  [%s] %s  %s%s"
                  % (t - t0, dur, stage, what, kind, spacing))
            prev = t
    else:
        print("\n## no stalls > %.0f s" % thresh)


if __name__ == "__main__":
    main()
