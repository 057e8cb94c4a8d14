"""Contamination estimate for the DR5-scale benchmark: run the finder on sign-inverted maps with the record run's cached
filters (`maps.estimateContaminationFromInvertedMaps`, the reference's
`nemo/maps.py:1589-1619` diagnostic) and commit the contamination
fraction vs S/N next to the benchmark.

Noise is sign-symmetric, clusters are not: everything detected in the
inverted maps at a given S/N estimates the spurious-candidate rate at
that S/N in the real run.

Usage (after examples/dr5_scale_benchmark.py has completed in the same
workDir, leaving its cached filters + catalog):

    python examples/dr5_contamination.py <workDir> [outJson] [everyNth]

``everyNth`` > 1 runs the inverted pass on every Nth tile (spread
across the survey's declination bands) and compares against the real
catalog restricted to the same tiles: the contamination FRACTION is a
per-area statistic, so a spread subsample estimates it with ~1/sqrt(n)
counting error at a fraction of the wall-clock (the full inverted pass
is a second full filtering stage).
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def catalogsCrossAll(catA, catB, radiusArcmin):
    """Indices of ALL catA rows within radius of ANY catB row (the
    unique nearest-neighbour crossMatch would drop co-located rows)."""
    from nemo_tpu.utils.wcs import calcAngSepDeg

    raA = np.asarray(catA["RADeg"], dtype=float)
    decA = np.asarray(catA["decDeg"], dtype=float)
    raB = np.asarray(catB["RADeg"], dtype=float)
    decB = np.asarray(catB["decDeg"], dtype=float)
    r = radiusArcmin / 60.0
    hits = [i for i in range(len(raA))
            if np.min(calcAngSepDeg(raA[i], decA[i], raB, decB)) < r]
    return np.array(hits, dtype=int), None, None


def main():
    workDir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/dr5scale"
    outJson = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        workDir, "out", "diagnostics", "contamination.json")
    everyNth = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    configPath = os.path.join(workDir, "dr5scale.yml")

    import time
    from nemo_tpu import maps, startup
    from nemo_tpu.utils.tables import Table

    t0 = time.time()
    config = startup.NemoConfig(configPath, writeTileInfo=False)
    tileSubset = None
    if everyNth > 1:
        tileSubset = set(config.tileNames[::everyNth])
        config.tileNames = sorted(tileSubset)
        print("... inverted pass on %d / %d tiles (every %dth)"
              % (len(config.tileNames), len(config.allTileNames),
                 everyNth), flush=True)
    invertedCatalog = maps.estimateContaminationFromInvertedMaps(config)
    elapsed = time.time() - t0
    if len(invertedCatalog):
        from nemo_tpu import catalogs as cat_mod
        cat_mod.writeCatalog(invertedCatalog, os.path.join(
            workDir, "out", "invertedCatalog.fits"))

    realCat = Table.read(os.path.join(workDir, "out",
                                      "out_optimalCatalog.fits"))
    if tileSubset is not None:
        keep = np.array([t in tileSubset
                         for t in np.asarray(realCat["tileName"])])
        realCat = realCat[keep]
    snInv = np.asarray(invertedCatalog["SNR"], dtype=float) \
        if len(invertedCatalog) else np.array([])
    snReal = np.asarray(realCat["SNR"], dtype=float)

    # Split the inverted detections by proximity to STRONG real
    # objects: a positive peak in the inverted map next to a bright
    # real cluster is the cluster's negative matched-filter sidelobe
    # ring (the hazard the reference's removeRings option exists for,
    # nemo/pipelines.py), not noise - the reference's contamination
    # diagnostic carries the same systematic.  The far-from-source
    # subset estimates the TRUE noise/false-positive rate.
    ringArcmin = 10.0
    nearRing = np.zeros(len(snInv), dtype=bool)
    if len(snInv):
        strong = realCat[np.asarray(realCat["SNR"]) >= 10.0]
        if len(strong):
            mI, mC, _ = catalogsCrossAll(invertedCatalog, strong,
                                         ringArcmin)
            nearRing[mI] = True

    rows = []
    for cut in (4.0, 4.5, 5.0, 5.5, 6.0, 7.0, 8.0, 10.0):
        selInv = snInv >= cut
        nInv = int(selInv.sum())
        nInvFar = int((selInv & ~nearRing).sum())
        nReal = int((snReal >= cut).sum())
        rows.append({"SNRCut": cut, "invertedN": nInv,
                     "invertedN_awayFromSources": nInvFar,
                     "realN": nReal,
                     "contaminationFraction":
                         (nInv / nReal) if nReal else None,
                     "noiseContaminationFraction":
                         (nInvFar / nReal) if nReal else None})

    artifact = {"method": "invertedMaps (cached filters)",
                "wallclock_s": round(elapsed, 1),
                "tiles": len(config.tileNames),
                "tiles_total": len(config.allTileNames),
                "ringExclusionArcmin": ringArcmin,
                "rows": rows}
    os.makedirs(os.path.dirname(outJson), exist_ok=True)
    with open(outJson, "w") as f:
        json.dump(artifact, f, indent=1)

    print("## DR5-scale contamination (inverted maps, %.0f s)\n"
          % elapsed)
    print("| S/N cut | inverted detections (all / away from sources) | "
          "real detections | contamination (all / noise-only) |")
    print("|---|---|---|---|")
    for r in rows:
        def pct(v):
            return "n/a" if v is None else "%.2f%%" % (100 * v)
        print("| %.1f | %d / %d | %d | %s / %s |"
              % (r["SNRCut"], r["invertedN"],
                 r["invertedN_awayFromSources"], r["realN"],
                 pct(r["contaminationFraction"]),
                 pct(r["noiseContaminationFraction"])))
    print("\nartifact: %s" % outJson)


if __name__ == "__main__":
    main()
