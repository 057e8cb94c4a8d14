"""Summarise a completed DR5-scale benchmark run (examples/
dr5_scale_benchmark.py): stage timings, catalog recovery against the
injected input catalog, and the wall-clock comparison against the
reference's ACT DR5 production row
(Nemo's examples/ACT-DR5-clusters/DR5ClusterSearch.slurm:1-9:
< 4 h 59 m on ~300 MPI ranks).

Usage: python examples/dr5_results_summary.py <workDir> [logFile]
Prints a markdown results block and writes
<workDir>/out/diagnostics/results_summary.json.
"""

import json
import os
import re
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    workDir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/dr5scale"
    logFile = sys.argv[2] if len(sys.argv) > 2 else None
    outDir = os.path.join(workDir, "out")
    diagDir = os.path.join(outDir, "diagnostics")

    from nemo_tpu.utils import fits as nfits
    from nemo_tpu.utils.tables import Table

    with open(os.path.join(diagDir, "timings.json")) as f:
        timings = json.load(f)

    cat = Table.read(os.path.join(outDir, "out_optimalCatalog.fits"))
    inp = Table.read(os.path.join(workDir, "inputCatalog.fits"))

    # cross-match recovered vs injected (1.4 arcmin, the optimal-catalog
    # match radius) - the pipeline's unique nearest-neighbour spherical
    # matcher (proper RA wraparound; no many-to-one double counting)
    from nemo_tpu import catalogs

    ra_i = np.asarray(inp["RADeg"])
    ra_c = np.asarray(cat["RADeg"])
    sn_c = np.asarray(cat["SNR"])
    if len(cat) > 0:
        mI, mC, sepArcmin = catalogs.crossMatch(inp, cat,
                                                radiusArcmin=1.4)
        matched = len(mI)
        seps = np.asarray(sepArcmin, dtype=float) * 60.0
    else:
        matched = 0
        seps = np.array([])

    total = None
    if logFile and os.path.exists(logFile):
        m = re.findall(r"=== nemo end-to-end: ([0-9.]+) s ===",
                       open(logFile, errors="ignore").read())
        if m:
            total = float(m[-1])
    if total is None:
        total = sum(v for v in timings.values()
                    if isinstance(v, (int, float)))

    # tile count for the matched-workload accounting flag bench.py keys
    # its record selection on (~280 tiles = the reference DR5 run's own
    # tiling of the AdvACT S18 mask)
    import glob
    nTiles = len(glob.glob(os.path.join(outDir, "selFn",
                                        "[0-9]*_*"))) or None

    refSeconds = (4 * 60 + 59) * 60.0
    summary = {
        "end_to_end_s": total,
        "stages_s": timings,
        "n_tiles": nTiles,
        "tiles_match_reference": bool(nTiles and 250 <= nTiles <= 310),
        "n_input": int(len(ra_i)),
        "n_detected": int(len(ra_c)),
        "n_matched": int(matched),
        "recovery_pct": 100.0 * matched / len(ra_i),
        "median_sep_arcsec": float(np.median(seps)) if len(seps) else None,
        "snr_median": float(np.median(sn_c)) if len(sn_c) else None,
        "reference_wallclock_s": refSeconds,
        "reference_ranks": 300,
        "speedup_wallclock": refSeconds / total,
    }
    with open(os.path.join(diagDir, "results_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)

    print("## DR5-scale end-to-end result\n")
    print("| quantity | value |")
    print("|---|---|")
    print("| end-to-end wall-clock | %.1f s (%.1f min) |"
          % (total, total / 60))
    for k, v in sorted(timings.items(), key=lambda kv: -kv[1]
                       if isinstance(kv[1], (int, float)) else 0):
        if isinstance(v, (int, float)):
            print("| stage: %s | %.1f s |" % (k, v))
    print("| clusters injected / detected / matched | %d / %d / %d |"
          % (summary["n_input"], summary["n_detected"],
             summary["n_matched"]))
    print("| recovery | %.1f%% |" % summary["recovery_pct"])
    if summary["median_sep_arcsec"] is not None:
        print("| median position offset | %.2f arcsec |"
              % summary["median_sep_arcsec"])
    print("| reference (ACT DR5, ~300 CPU ranks) | < %d s (4h59m) |"
          % int(refSeconds))
    print("| wall-clock ratio vs reference | %.1fx faster, 1 chip vs "
          "~300 ranks |" % summary["speedup_wallclock"])


if __name__ == "__main__":
    main()
