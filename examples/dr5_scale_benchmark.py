"""ACT DR5-scale end-to-end run of the nemo cluster search.

Reproduces the reference's headline workload shape
(``examples/ACT-DR5-clusters/DR5ClusterSearch.yml`` in Nemo):
~250 tiles of 10 x 5 deg (1 deg overlap) at 0.5 arcmin, 2 frequencies,
16 Arnaud filter scales, detection + optimal catalog + Q fit + RMS
tables + completeness - the run the reference does in < 4 h 59 m on
~300 MPI ranks (``DR5ClusterSearch.slurm``; BASELINE.md).

The run needs no ACT maps: step 1 paints a survey-scale simulation
(84 x 240 deg at 0.5', 1,000 clusters + CMB + white noise) with the
framework's own sim tools; step 2
runs the full `nemo` CLI on it with device batching. Stage timings land
in <outDir>/diagnostics/timings.json.

Usage: python examples/dr5_scale_benchmark.py <workDir>
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from nemo_tpu.utils import yamlio  # noqa: E402


SHAPE = (10080, 28800)         # 84 x 240 deg at 0.5' (dec -62..+22)
PIX_ARCMIN = 0.5
BANDS = (("f150", 149.6, 1.4, 18.0), ("f090", 97.8, 2.1, 25.0))
N_CLUSTERS = 1000

FILTER_SCALES = [(M, z) for z in (0.2, 0.4, 0.8, 1.2)
                 for M in (1e14, 2e14, 4e14, 8e14)]


def _raggedSurveyMask(shape, w, marginPix=0):
    """DR5-like ragged footprint: dec-dependent RA extent with slow and
    fast undulations, a drifting centre line, and 14 bright-star holes
    (1-3 deg radius).  The reference's DR5 run tiles the ragged AdvACT
    S18 mask into ~280 (10 x 5 deg, 1 deg overlap) tiles
    (`DR5ClusterSearch.yml` tileDefinitions; bench.py's reference
    accounting is ~280 x 16 = 4480 tile-scale steps); this mask
    autotiles to 282 so the benchmark's step count matches the
    reference's.  True sky area 14,434 deg^2 (the DR5 cluster-search area
    is 13,168 deg^2 of a larger observed mask).

    ``marginPix > 0`` returns the same footprint morphologically
    DILATED by that many pixels (L-inf ball): the DATA-coverage mask.
    Real survey maps have observed (nonzero) pixels extending well
    past the cluster-search mask - the DR5 search area is 13,168 deg^2
    of an ~18,000 deg^2 observed S18 map - so the hard data edge (and
    the reference's 3 x noise-grid edge trim that engages at it,
    nemo/filters.py:727-744 in the reference) sits outside the searched
    region.  Coverage == search mask is the one pathological
    configuration: the FFT sees the hard edge right AT the search
    boundary and filter ringing leaks into the searched area."""
    from scipy.ndimage import maximum_filter1d, minimum_filter1d

    ny, nx = shape
    rows = np.arange(ny, dtype=float)
    cx = nx // 2
    decs = np.asarray(w.pix2wcs(np.full(ny, float(cx)), rows))[:, 1]
    frac = 0.84 + 0.13 * np.sin(np.radians(decs) * 5.0) \
        + 0.06 * np.sin(np.radians(decs) * 13.0 + 1.0)
    frac = np.clip(frac, 0.35, 1.0)
    drift = 0.06 * nx * np.sin(np.radians(decs) * 3.0 + 0.5)
    width = (frac * nx).astype(int)
    x0 = np.clip(((nx - width) // 2 + drift).astype(int), 0, nx - 1)
    x1 = np.clip(x0 + width, 0, nx)
    if marginPix > 0:
        # dilation of a one-interval-per-row set: per-row running
        # min/max over +-margin rows, then widen each interval
        size = 2 * int(marginPix) + 1
        x0 = np.clip(minimum_filter1d(x0, size) - int(marginPix), 0, nx)
        x1 = np.clip(maximum_filter1d(x1, size) + int(marginPix), 0, nx)
    mask = np.zeros(shape, dtype=np.uint8)
    for i in range(ny):
        mask[i, x0[i]:x1[i]] = 1
    rng = np.random.default_rng(11)
    yy = rng.uniform(0.1 * ny, 0.9 * ny, 14).astype(int)
    xx = rng.uniform(0.15 * nx, 0.85 * nx, 14).astype(int)
    rr = rng.uniform(1.0, 3.0, 14) / (PIX_ARCMIN / 60.0)
    for y0h, x0h, rh in zip(yy, xx, rr):
        rh = rh - marginPix          # dilation shrinks the holes
        if rh <= 0:
            continue
        ys = slice(max(0, int(y0h - rh)), min(ny, int(y0h + rh) + 1))
        sub = mask[ys]
        Ys, Xs = np.mgrid[ys, 0:nx]
        sub[((Ys - y0h) ** 2 + (Xs - x0h) ** 2) < rh * rh] = 0
    return mask


def makeSurvey(workDir, shape=SHAPE, nClusters=N_CLUSTERS,
               centreRADeg=115.0, centreDecDeg=-20.0):
    """Write the two band maps, beams, survey mask and input catalog of a
    simulated survey of ``shape`` pixels into ``workDir``.  Returns
    (mapEntries, maskPath)."""
    import jax
    import jax.numpy as jnp

    from nemo_tpu import maps
    from nemo_tpu.models import beams
    from nemo_tpu.ops import grf
    from nemo_tpu.utils import fits as nfits
    from nemo_tpu.utils import wcs as nwcs
    from nemo_tpu.utils.tables import Table

    os.makedirs(workDir, exist_ok=True)
    w = nwcs.makeWCS(shape, PIX_ARCMIN / 60.0, centreRADeg=centreRADeg,
                     centreDecDeg=centreDecDeg)
    mask = _raggedSurveyMask(shape, w)
    # Data coverage extends 2.5 deg past the search mask, as real survey
    # products' do (see _raggedSurveyMask docstring): the reference's
    # coverage-edge trim band (3 x 40' noise grid = 2 deg) then falls
    # OUTSIDE the searched area, exactly as in the real DR5 run.
    coverage = _raggedSurveyMask(shape, w,
                                 marginPix=int(2.5 * 60 / PIX_ARCMIN))

    rng = np.random.default_rng(2026)
    margin = 200
    # rejection-sample cluster positions INSIDE the ragged footprint
    xs = np.empty(0)
    ys = np.empty(0)
    while len(xs) < nClusters:
        xc = rng.uniform(margin, shape[1] - margin, 4 * nClusters)
        yc = rng.uniform(margin, shape[0] - margin, 4 * nClusters)
        ok = mask[yc.astype(int), xc.astype(int)] > 0
        xs = np.concatenate([xs, xc[ok]])
        ys = np.concatenate([ys, yc[ok]])
    xs, ys = xs[:nClusters], ys[:nClusters]
    coords = w.pix2wcs(xs, ys)
    inputTab = Table({
        "name": np.array(["sim%04d" % i for i in range(nClusters)]),
        "RADeg": coords[:, 0], "decDeg": coords[:, 1],
        "y_c": rng.uniform(0.5, 8.0, nClusters),
        "template": np.array(["Arnaud_M2e14_z0p4"] * nClusters)})
    inputTab.write(os.path.join(workDir, "inputCatalog.fits"))

    mapEntries = []
    for i, (band, freq, fwhm, noise) in enumerate(BANDS):
        t0 = time.time()
        beamFile = os.path.join(workDir, "beam_%s.txt" % band)
        beams.makeGaussianBeamFile(beamFile, fwhm)
        model = maps.makeModelImage(
            shape, w, inputTab, beamFile, obsFreqGHz=freq,
            override={"redshift": 0.4, "M500": 2e14}, asDevice=True)
        beam = beams.BeamProfile(beamFileName=beamFile)
        pix = maps.pixScalesRad(w, shape)
        # Sum model + CMB + noise on the device and download once
        sky = grf.sim_cmb_map(
            jax.random.PRNGKey(77 + i), shape, pix, beamBell=beam.Bell,
            beamEll=beam.ell, noiseLevel=noise) + model
        # zero the unobserved region, as real survey products are
        sky = sky * jnp.asarray(coverage)
        simPath = os.path.join(workDir, "sim_%s.fits" % band)
        nfits.write_image(simPath, np.asarray(sky).astype(np.float32),
                          w.header)
        del sky, model
        mapEntries.append({"mapFileName": simPath, "obsFreqGHz": freq,
                           "units": "uK", "beamFileName": beamFile})
        print("... %s simulated in %.1f s" % (band, time.time() - t0),
              flush=True)

    maskPath = os.path.join(workDir, "surveyMask.fits")
    nfits.write_image(maskPath, mask, w.header, compressionType="RICE_1")
    return mapEntries, maskPath


def makeConfig(workDir, mapEntries, maskPath):
    mapFilters = []
    for M, z in FILTER_SCALES:
        label = "Arnaud_M%s_z%s" % (
            ("%.0e" % M).replace("e+", "e").replace("0e14", "e14"),
            str(z).replace(".", "p"))
        mapFilters.append({"label": label,
                           "params": {"M500MSun": float(M), "z": float(z)}})
    configDict = {
        "unfilteredMaps": mapEntries,
        "surveyMask": maskPath,
        "thresholdSigma": 4.0, "minObjPix": 1, "findCenterOfMass": True,
        "useInterpolator": True, "rejectBorder": 0, "objIdent": "ACT-CL",
        "longNames": False, "removeRings": False,
        "allFilters": {
            "class": "ArnaudModelMatchedFilter",
            "params": {"noiseParams": {"method": "dataMap",
                                       "noiseGridArcmin": 40.0},
                       "saveFilteredMaps": False, "saveRMSMap": False,
                       "savePlots": False, "saveDS9Regions": False,
                       "outputUnits": "yc", "edgeTrimArcmin": 0.0}},
        "mapFilters": mapFilters,
        "photFilter": "Arnaud_M2e14_z0p4",
        "fitQ": True,
        "calcSelFn": True,
        # massLimitMaps + numIterations match the reference DR5 config
        # (DR5ClusterSearch.yml selFnOptions); its stitchTiles: True is a
        # no-op there because saveFilteredMaps is False for every filter
        # (reference maps.py stitchTiles loops only saveFilteredMaps
        # filters), so stitchTiles: False here is workload-equivalent.
        "selFnOptions": {"fixedSNRCut": 5.0, "method": "fast",
                         "numIterations": 1000,
                         "massLimitMaps": [{"z": 0.5}]},
        "massOptions": {"tenToA0": 4.95e-05, "B0": 0.08,
                        "Mpivot": 3.0e+14, "sigma_int": 0.2,
                        "H0": 70.0, "Om0": 0.30, "Ob0": 0.05,
                        "sigma8": 0.80, "ns": 0.95,
                        "delta": 500, "rhoType": "critical"},
        "useTiling": True, "stitchTiles": False,
        "tileOverlapDeg": 1.0,
        "tileDefinitions": {"mask": maskPath,
                            "targetTileWidthDeg": 10.0,
                            "targetTileHeightDeg": 5.0},
        "useDeviceBatching": True,
        "deviceBatchSize": 16,
        "outputDir": os.path.join(workDir, "out"),
    }
    return configDict


def writeConfig(workDir, configDict, name="dr5scale.yml"):
    configPath = os.path.join(workDir, name)
    with open(configPath, "w") as f:
        f.write(yamlio.dump(configDict))
    return configPath


def main():
    workDir = sys.argv[1] if len(sys.argv) > 1 else "dr5scale"
    simReady = all(os.path.exists(os.path.join(workDir, p)) for p in
                   ["surveyMask.fits"]
                   + ["sim_%s.fits" % band for band, _, _, _ in BANDS])
    if not simReady:
        t0 = time.time()
        mapEntries, maskPath = makeSurvey(workDir)
        print("=== survey simulation: %.1f s ===" % (time.time() - t0),
              flush=True)
    else:
        from nemo_tpu.utils import wcs  # noqa: F401 (env sanity)
        maskPath = os.path.join(workDir, "surveyMask.fits")
        mapEntries = []
        for band, freq, fwhm, noise in BANDS:
            mapEntries.append({
                "mapFileName": os.path.join(workDir, "sim_%s.fits" % band),
                "obsFreqGHz": freq, "units": "uK",
                "beamFileName": os.path.join(workDir,
                                             "beam_%s.txt" % band)})
    configPath = writeConfig(workDir, makeConfig(workDir, mapEntries,
                                                 maskPath))

    from nemo_tpu.cli.nemo_main import main as nemo_main
    t0 = time.time()
    sys.argv = ["nemo", configPath]
    nemo_main()
    print("=== nemo end-to-end: %.1f s ===" % (time.time() - t0),
          flush=True)


if __name__ == "__main__":
    main()
