#!/usr/bin/env python
"""nemo driver: filter maps and find clusters / sources.

JAX rebuild of the reference CLI (``bin/nemo``): same flags and the
same output layout; -M is accepted for compatibility (tiles shard over the
JAX device mesh rather than MPI ranks).
"""

import argparse
import os
import sys
import time



def makeParser():
    parser = argparse.ArgumentParser("nemo")
    parser.add_argument("configFileName", help="A .yml configuration file.")
    parser.add_argument("-S", "--calc-selection-function", dest="calcSelFn",
                        action="store_true", default=False,
                        help="Calculate completeness in terms of cluster "
                             "mass; output under selFn/.")
    parser.add_argument("-I", "--run-source-injection-test",
                        dest="sourceInjectionTest", action="store_true",
                        default=False,
                        help="Run a source injection test.")
    parser.add_argument("-f", "--forced-photometry-catalog",
                        dest="forcedCatalogFileName", default=None,
                        help="Perform forced photometry at positions in "
                             "this catalog instead of detecting objects.")
    parser.add_argument("-M", "--mpi", dest="MPIEnabled",
                        action="store_true", default=False,
                        help="Accepted for compatibility; parallelism runs "
                             "over the JAX device mesh.")
    parser.add_argument("-T", "--tiling-check", dest="tilingCheck",
                        action="store_true", default=False,
                        help="Stop after the tiling stage.")
    parser.add_argument("-n", "--no-strict-errors",
                        dest="noStrictMPIExceptions", action="store_true",
                        default=False, help="Compatibility no-op.")
    parser.add_argument("-x", "--x64", dest="x64", action="store_true",
                        default=False,
                        help="Use float64 (CPU backend parity runs).")
    parser.add_argument("--profile-dir", dest="profileDir", default=None,
                        help="Capture a jax.profiler trace of the filtering "
                             "stage into this directory.")
    parser.add_argument("--profile", dest="profileChunk",
                        action="store_true", default=False,
                        help="Capture ONE warm tile-chunk's device trace "
                             "into diagnostics/profile/ (per-chunk link "
                             "budgets land in diagnostics/"
                             "chunk_budgets.jsonl regardless).")
    return parser


def main():
    args = makeParser().parse_args()
    from nemo_tpu.utils.timing import GLOBAL_TIMER, profile_trace
    GLOBAL_TIMER.reset()
    if args.x64:
        import jax
        jax.config.update("jax_enable_x64", True)

    # Multi-host runtime: no-op unless NEMO_TPU_MULTIHOST=1
    # (parallel/multihost.py documents the launch contract); must run
    # before first device use.
    from nemo_tpu.parallel import multihost
    multihost.initialize_from_env()

    from nemo_tpu import (catalogs, completeness, maps, pipelines,
                          startup)
    from nemo_tpu.models import qfit

    config = startup.NemoConfig(args.configFileName,
                                calcSelFn=args.calcSelFn,
                                sourceInjectionTest=args.sourceInjectionTest,
                                MPIEnabled=args.MPIEnabled,
                                writeTileInfo=True)
    if args.tilingCheck:
        print(">>> Tiling check: this config has %d tiles."
              % len(config.allTileNames))
        sys.exit()

    config.parDict["forcedPhotometryCatalog"] = args.forcedCatalogFileName
    if config.parDict["forcedPhotometryCatalog"] is not None:
        label = os.path.splitext(
            os.path.basename(config.parDict["forcedPhotometryCatalog"]))[0]
        label = label + "_" + os.path.basename(config.rootOutDir) \
            + "_forcedCatalog"
        optimalCatalogFileName = label + ".csv"
    else:
        optimalCatalogFileName = os.path.join(
            config.rootOutDir, "%s_optimalCatalog.csv"
            % os.path.split(config.rootOutDir)[-1])

    if args.profileChunk:
        from nemo_tpu.parallel import engine as batch_engine
        batch_engine.PROFILE_CHUNK_DIR = os.path.join(
            config.diagnosticsDir, "profile")
    if not os.path.exists(optimalCatalogFileName):
        with profile_trace(args.profileDir):
            optimalCatalog = pipelines.filterMapsAndMakeCatalogs(
                config, writeAreaMask=True, writeFlagMask=True)
        if len(optimalCatalog) > 0:
            optimalCatalog = catalogs.flagTileBoundarySplits(optimalCatalog)
            optimalCatalog.sort("name")
        catalogs.writeCatalog(optimalCatalog, optimalCatalogFileName)
        catalogs.writeCatalog(optimalCatalog,
                              optimalCatalogFileName.replace(".csv",
                                                             ".fits"))
        catalogs.catalog2DS9(optimalCatalog,
                             optimalCatalogFileName.replace(".csv", ".reg"),
                             addInfo=[{"key": "SNR", "fmt": "%.1f"}])
    else:
        print("... already made catalog %s" % optimalCatalogFileName)

    if config.parDict.get("photFilter") and config.parDict.get("fitQ"):
        if not os.path.exists(os.path.join(config.selFnDir, "QFit.fits")):
            with GLOBAL_TIMER.stage("fitQ"):
                qfit.fitQ(config)

    with GLOBAL_TIMER.stage("makeRMSTables"):
        pipelines.makeRMSTables(config)

    sourceInjTable = None
    sourceInjPath = os.path.join(config.selFnDir,
                                 "sourceInjectionData.fits")
    if not os.path.exists(sourceInjPath):
        if config.parDict.get("sourceInjectionTest"):
            sourceInjTable = maps.sourceInjectionTest(config)
    else:
        print("... already made source injection data %s" % sourceInjPath)

    print("... stitching maps and tidying up [%.1f sec]"
          % (time.time() - config._timeStarted))
    if sourceInjTable is not None:
        sourceInjTable.write(sourceInjPath)
    if sourceInjTable is not None and len(sourceInjTable) == 0:
        # e.g. a cluster config run with -I but without
        # sourceInjectionModels: nothing recovered.  Don't crash the
        # epilogue of a long run on an empty table.
        print("... WARNING: source injection test recovered no objects "
              "(cluster configs need sourceInjectionModels) - skipping "
              "position recovery analysis")
    elif sourceInjTable is not None:
        maps.positionRecoveryAnalysis(
            sourceInjTable,
            os.path.join(config.diagnosticsDir, "positionRecovery.pdf"),
            percentiles=[50, 95, 99.7], plotRawData=True,
            pickleFileName=os.path.join(config.diagnosticsDir,
                                        "positionRecovery.pkl"),
            selFnDir=config.selFnDir)

    if config.parDict.get("stitchTiles") and len(config.tileNames) > 1:
        maps.stitchTiles(config)
    if config.parDict.get("makeQuickLookMaps"):
        maps.makeQuickLookMaps(config)

    with GLOBAL_TIMER.stage("tidyUp"):
        completeness.getFRelWeights(config)
        completeness.tidyUp(config)

    if config.parDict.get("calcSelFn"):
        import shutil
        selFnConfigPath = os.path.join(config.selFnDir, "config.yml")
        if not os.path.exists(selFnConfigPath):
            shutil.copy(args.configFileName, selFnConfigPath)
        with GLOBAL_TIMER.stage("completeness"):
            completeness.completenessByFootprint(config)
            selFnOptions = config.parDict.get("selFnOptions", {})
            if selFnOptions.get("massLimitMaps"):
                completeness.makeMassLimitMapsAndPlots(config)

    print(GLOBAL_TIMER.report())
    with open(os.path.join(config.diagnosticsDir, "timings.json"),
              "w") as f:
        f.write(GLOBAL_TIMER.to_json() + "\n")


if __name__ == "__main__":
    main()
