"""Boltzmann-vs-EH98 transfer anchor artifact.

Quantifies, with committed numbers, what the native linear Boltzmann
solver (``models/boltzmann.py`` - the from-scratch counterpart of the
reference's CCL ``boltzmann_camb`` transfer, default since round 5)
changes relative to the EH98 analytic transfer across every quantity
the production selFn/mass path consumes:

* T(k) on the splice grid,
* sigma(M, z=0) over M = 1e13..1e16 MSun,
* the Tinker08 HMF dn/dlnM at z = 0, 0.5, 1,
* the SelFn completeness grid (fast method, synthetic two-cell RMSTab
  at DR5-like depths) and its 90%-completeness mass limit,
* inferred M500c from fixed y0~ SZ observables (the nemoMass path).

No external Boltzmann tabulation exists in this offline image (no
camb/classy/pyccl), so the committed anchor is this full-pipeline
delta table plus the solver's physics-invariant test suite
(tests/test_boltzmann.py); EH98 itself is an independently published
fit, so percent-level shape agreement with a known tilt is the
meaningful cross-check.

Usage: python examples/boltzmann_anchor.py [outDir]
Writes <outDir>/anchor.json and prints a markdown summary.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

H0, OM0, OB0, SIGMA8, NS = 70.0, 0.30, 0.05, 0.80, 0.95


def main():
    outDir = sys.argv[1] if len(sys.argv) > 1 else \
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "docs", "benchmarks",
            "boltzmann_r5")
    os.makedirs(outDir, exist_ok=True)

    from nemo_tpu.models import cosmology
    from nemo_tpu.mock import MockSurvey
    from nemo_tpu.models import scaling
    from nemo_tpu.utils.tables import Table
    from nemo_tpu import completeness

    t0 = time.time()
    cB = cosmology.FlatLCDM(H0, OM0, OB0, SIGMA8, NS,
                            transferFunction="boltzmann")
    kb = cosmology._BOLTZ_KGRID
    TB = cB._boltzmann_transfer(kb)
    solve_s = time.time() - t0
    cE = cosmology.FlatLCDM(H0, OM0, OB0, SIGMA8, NS,
                            transferFunction="eh98")
    TE = cE._eh98_transfer(kb)
    # Normalise the comparison at k = 0.05 Mpc^-1: solidly sub-horizon
    # (clean solver convention), above the equality turnover, below the
    # BAO damping tail - the same anchoring role sigma8 plays in the
    # production spectrum.
    iA = int(np.argmin(np.abs(kb - 0.05)))
    TB = TB / TB[iA]
    TE = TE / TE[iA]

    M = np.logspace(13, 16, 31)
    sB = np.array([cB.sigmaM(m) for m in M])
    sE = np.array([cE.sigmaM(m) for m in M])

    hmf = {}
    Mg = np.logspace(13.0, 15.8, 200)
    pick = [np.argmin(np.abs(Mg - m)) for m in (1e14, 3e14, 1e15)]
    for z in (0.0, 0.5, 1.0):
        nB = cB.dndlnM(Mg, z)
        nE = cE.dndlnM(Mg, z)
        hmf["z%.1f" % z] = (nB[pick] / nE[pick]).tolist()

    # SelFn completeness (fast method) both ways on a DR5-like synthetic
    # RMS table - the calcCompleteness core the production SelFn uses
    sr = {"tenToA0": 4.95e-5, "B0": 0.08, "Mpivot": 3e14,
          "sigma_int": 0.2, "relativisticCorrection": True}
    RMSTab = Table({"areaDeg2": np.array([7000.0, 7000.0]),
                    "y0RMS": np.array([1.5e-5, 3.0e-5])})

    class FlatQ:
        def getQ(self, theta500s, z=None, tileName=None):
            return np.ones_like(np.asarray(theta500s, dtype=float))

    comps, limits = {}, {}
    for name, tf in (("boltzmann", "boltzmann_camb"),
                     ("eh98", "eisenstein_hu")):
        ms = MockSurvey(5e13, 14000.0, 0.0, 2.0, H0, OM0, OB0, SIGMA8,
                        NS, zStep=0.1, transferFunction=tf)
        comp = completeness.calcCompleteness(RMSTab, 5.0, "anchor", ms,
                                             sr, FlatQ(), method="fast")
        comps[name] = comp
        # 90% completeness mass limit per z
        lim = []
        for zi in range(len(ms.z)):
            ci = comp[zi]
            sel = np.where(ci >= 0.9)[0]
            lim.append(float(ms.log10M[sel[0]]) if len(sel) else None)
        limits[name] = (ms.z.tolist(), lim)

    dComp = np.abs(comps["boltzmann"] - comps["eh98"])
    mid = (comps["boltzmann"] > 0.05) & (comps["boltzmann"] < 0.95)
    limB = np.array([v for v in limits["boltzmann"][1] if v is not None])
    limE = np.array([v for v in limits["eh98"][1] if v is not None])
    n = min(len(limB), len(limE))
    dLimitPct = (10 ** (limB[:n] - limE[:n]) - 1) * 100

    # Mass inference both ways (the nemoMass path): fixed y0~, z grid
    msB = MockSurvey(5e13, 14000.0, 0.0, 2.0, H0, OM0, OB0, SIGMA8, NS,
                     zStep=0.1, transferFunction="boltzmann_camb")
    msE = MockSurvey(5e13, 14000.0, 0.0, 2.0, H0, OM0, OB0, SIGMA8, NS,
                     zStep=0.1, transferFunction="eisenstein_hu")

    # Expected cluster counts over the survey - where the transfer bites
    # hardest (the HMF exponential tail integrates sigma(M) differences)
    countRows = {}
    for mlim in (2e14, 5e14):
        nB = float(msB.calcNumClustersExpected(MLimit=mlim))
        nE = float(msE.calcNumClustersExpected(MLimit=mlim))
        countRows["M_gt_%.0e" % mlim] = {
            "boltzmann": nB, "eh98": nE, "delta_pct": 100 * (nB / nE - 1)}

    dMassPct = []
    massRows = []
    for z in (0.2, 0.5, 1.0):
        for y0 in (5e-5, 2e-4):
            kwargs = dict(tenToA0=sr["tenToA0"], B0=sr["B0"],
                          Mpivot=sr["Mpivot"],
                          sigma_int=sr["sigma_int"],
                          applyRelativisticCorrection=True,
                          fRelWeightsDict={148.0: 1.0})
            mB = scaling.calcMass(y0, y0 * 0.1, z, 0.0, FlatQ(), msB,
                                  **kwargs)["M500c"]
            mE = scaling.calcMass(y0, y0 * 0.1, z, 0.0, FlatQ(), msE,
                                  **kwargs)["M500c"]
            dMassPct.append(100 * (mB / mE - 1))
            massRows.append({"z": z, "y0": y0, "M500c_boltz_1e14": mB,
                             "M500c_eh98_1e14": mE,
                             "delta_pct": 100 * (mB / mE - 1)})

    artifact = {
        "cosmology": {"H0": H0, "Om0": OM0, "Ob0": OB0,
                      "sigma8": SIGMA8, "ns": NS},
        "solver_seconds_1core": round(solve_s, 1),
        "k_Mpc": kb.tolist(),
        "T_ratio_boltzmann_over_eh98": (TB / TE).tolist(),
        "M_MSun": M.tolist(),
        "sigmaM_boltzmann": sB.tolist(),
        "sigmaM_eh98": sE.tolist(),
        "sigmaM_ratio": (sB / sE).tolist(),
        "hmf_ratio_boltzmann_over_eh98_at_1e14_3e14_1e15": hmf,
        "completeness_grid_abs_delta_max": float(dComp.max()),
        "completeness_grid_abs_delta_max_transition": float(
            dComp[mid].max()) if mid.any() else None,
        "mass_limit_90pct_delta_pct_minmax": [
            float(dLimitPct.min()), float(dLimitPct.max())],
        "mass_inference_delta_pct_minmax": [
            float(np.min(dMassPct)), float(np.max(dMassPct))],
        "mass_rows": massRows,
        "expected_counts": countRows,
        "notes": [
            "The completeness grid is structurally transfer-independent"
            " (it is P(detect | M, z): scaling relation + noise +"
            " background geometry + Q only), so its delta is exactly 0"
            " - the transfer enters through the HMF: expected counts,"
            " mock catalogs, and the mass-function debias prior in"
            " mass inference.",
            "No external Boltzmann tabulation exists in this offline"
            " image; the committed anchors are this delta table, the"
            " solver's convergence (T shape stable to 0.2% from nGrid"
            " 24576 to 49152) and the physics-invariant test suite"
            " (tests/test_boltzmann.py)."],
    }
    with open(os.path.join(outDir, "anchor.json"), "w") as f:
        json.dump(artifact, f, indent=1)

    print("## Boltzmann vs EH98: end-to-end deltas (committed anchor)\n")
    print("| quantity | value |")
    print("|---|---|")
    print("| solver wall (1 CPU core, float64, cached per cosmology) "
          "| %.1f s |" % solve_s)
    print("| sigma(M) ratio range (1e13..1e16 MSun) | %.4f .. %.4f |"
          % ((sB / sE).min(), (sB / sE).max()))
    print("| T(k) ratio range (k %.0e..%.0f Mpc^-1, anchored at "
          "k=0.05; extremes sit in the damping tail) | %.4f .. %.4f |"
          % (kb[0], kb[-1], (TB / TE).min(), (TB / TE).max()))
    for z, r in hmf.items():
        print("| HMF ratio %s (1e14/3e14/1e15 MSun) | %s |"
              % (z, "/".join("%.3f" % v for v in r)))
    print("| completeness grid max |delta| | %.4f (structurally 0: "
          "P(detect|M,z) has no HMF term) |" % dComp.max())
    print("| 90%% mass-limit shift | %.3f%% .. %.3f%% |"
          % (dLimitPct.min(), dLimitPct.max()))
    print("| inferred M500c shift (y0~ fixed, incl. HMF debias prior) "
          "| %.3f%% .. %.3f%% |"
          % (np.min(dMassPct), np.max(dMassPct)))
    for key, row in countRows.items():
        print("| expected counts %s | %.0f vs %.0f (%+.1f%%) |"
              % (key, row["boltzmann"], row["eh98"], row["delta_pct"]))
    print("\nartifact: %s" % os.path.join(outDir, "anchor.json"))


if __name__ == "__main__":
    main()
