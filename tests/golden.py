"""Golden-catalog regression fixture (the reference's external-truth
check, ``tests/quick.robot:3-8`` + ``tests/lib/NemoTests.py:286-335``).

The reference's headline regression cross-matches recovered ``fixed_y_c``
against the *released* DR5 catalog and requires a mean ratio of 0.94
within 3 sigma (bootstrap).  This environment has no network, so the
anchor is a catalog committed to the repository
(``tests/data/golden_fixed_y_c.csv``), generated ONCE by
``python -m tests.golden`` and never regenerated during a test run: if
the pipeline's calibration drifts, the test fails against numbers the
run did not produce.

Everything here is deterministic: hard-coded cluster positions and
amplitudes, seeded CMB + noise realisations, float64 CPU execution (the
test conftest pins both).
"""

import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_PATH = os.path.join(DATA_DIR, "golden_fixed_y_c.csv")

SHAPE = (900, 900)          # 7.5 x 7.5 deg at 0.5'
PIX_ARCMIN = 0.5
BANDS = (("f150", 149.6, 1.4, 25.0), ("f090", 97.8, 2.1, 35.0))

# Fixed input clusters (y_c in 1e-4 Compton-y)
INPUT_NAME = ["g%02d" % i for i in range(12)]
INPUT_RA = [28.6, 29.1, 29.7, 30.3, 30.9, 31.4, 28.8, 29.5,
            30.1, 30.7, 31.2, 30.0]
INPUT_DEC = [-2.6, -1.3, -2.1, -0.6, -1.8, -2.4, 0.9, 1.7,
             0.4, 2.2, 1.1, 2.6]
INPUT_YC = [3.0, 4.5, 2.5, 5.0, 3.5, 2.8, 4.0, 3.2, 5.5, 2.6, 3.8, 4.2]


def input_table():
    from nemo_tpu.utils.tables import Table

    return Table({"name": np.array(INPUT_NAME),
                  "RADeg": np.array(INPUT_RA),
                  "decDeg": np.array(INPUT_DEC),
                  "y_c": np.array(INPUT_YC),
                  "template": np.array(["Arnaud_M2e14_z0p4"] * 12)})


def write_inputs(workDir):
    """Simulate the sky (fixed seeds) and write maps, beams and the
    config into ``workDir``.  The CMB draw depends on the dtype, so the
    golden sky is the float64 one.  Returns the config path."""
    import jax

    from nemo_tpu import maps
    from nemo_tpu.models import beams
    from nemo_tpu.ops import grf
    from nemo_tpu.utils import fits as nfits
    from nemo_tpu.utils import wcs as nwcs
    from nemo_tpu.utils import yamlio

    os.makedirs(workDir, exist_ok=True)
    w = nwcs.makeWCS(SHAPE, PIX_ARCMIN / 60.0, centreRADeg=30.0,
                     centreDecDeg=0.0)
    inputTab = input_table()

    mapEntries = []
    for i, (band, freq, fwhm, noise) in enumerate(BANDS):
        beamFile = os.path.join(workDir, "beam_%s.txt" % band)
        beams.makeGaussianBeamFile(beamFile, fwhm)
        model = maps.makeModelImage(SHAPE, w, inputTab, beamFile,
                                    obsFreqGHz=freq)
        beam = beams.BeamProfile(beamFileName=beamFile)
        pix = maps.pixScalesRad(w, SHAPE)
        cmb = np.asarray(grf.sim_cmb_map(
            jax.random.PRNGKey(1234 + i), SHAPE, pix, beamBell=beam.Bell,
            beamEll=beam.ell, noiseLevel=noise))
        simPath = os.path.join(workDir, "sim_%s.fits" % band)
        nfits.write_image(simPath, (cmb + model).astype(np.float64),
                          w.header)
        mapEntries.append({"mapFileName": simPath, "obsFreqGHz": freq,
                           "units": "uK", "beamFileName": beamFile})

    configDict = {
        "unfilteredMaps": mapEntries,
        "allFilters": {
            "class": "ArnaudModelMatchedFilter",
            "params": {"noiseParams": {"method": "dataMap",
                                       "noiseGridArcmin": 40.0},
                       "outputUnits": "yc"}},
        "mapFilters": [
            {"label": "Arnaud_M2e14_z0p4",
             "params": {"M500MSun": 2.0e+14, "z": 0.4}}],
        "photFilter": "Arnaud_M2e14_z0p4",
        "thresholdSigma": 4.0, "minObjPix": 1,
        "findCenterOfMass": True, "useInterpolator": True,
        "rejectBorder": 0, "removeRings": False,
        "outputDir": os.path.join(workDir, "out"),
    }
    configPath = os.path.join(workDir, "golden.yml")
    with open(configPath, "w") as f:
        f.write(yamlio.dump(configDict))
    return configPath


def run_pipeline(workDir):
    """Simulate (fixed seed) -> filter -> detect -> optimal catalog.
    Returns (inputTab, recovered catalog)."""
    from nemo_tpu import pipelines, startup

    config = startup.NemoConfig(write_inputs(workDir))
    catalog = pipelines.filterMapsAndMakeCatalogs(config)
    return input_table(), catalog


def make_golden(workDir):
    """Generate tests/data/golden_fixed_y_c.csv (run once; committed)."""
    from nemo_tpu import catalogs

    inputTab, catalog = run_pipeline(workDir)
    refM, outM, _ = catalogs.crossMatch(inputTab, catalog, radiusArcmin=1.5)
    assert len(refM) == len(INPUT_NAME), "golden run must recover all inputs"
    lines = ["name,RADeg,decDeg,input_y_c,fixed_y_c,fixed_err_y_c,SNR"]
    for i in range(len(refM)):
        lines.append("%s,%.6f,%.6f,%.4f,%.8f,%.8f,%.4f" % (
            refM["name"][i], refM["RADeg"][i], refM["decDeg"][i],
            refM["y_c"][i], outM["fixed_y_c"][i], outM["fixed_err_y_c"][i],
            outM["SNR"][i]))
    os.makedirs(DATA_DIR, exist_ok=True)
    with open(GOLDEN_PATH, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("wrote %s (%d rows)" % (GOLDEN_PATH, len(refM)))


def load_golden():
    rows = np.genfromtxt(GOLDEN_PATH, delimiter=",", names=True,
                         dtype=None, encoding="utf-8")
    return rows


if __name__ == "__main__":
    import tempfile
    make_golden(tempfile.mkdtemp(prefix="golden_"))
