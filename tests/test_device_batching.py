"""Device-batched production filtering (useDeviceBatching): the sharded
multi-tile engine must reproduce the per-tile host engine's catalog on the
same tiled sim - this is the device replacement for the reference's MPI tile
distribution running through the REAL pipeline, not just the benchmark
step."""

import os

import numpy as np

from nemo_tpu import catalogs, pipelines
from nemo_tpu.parallel import engine
from tests.test_tiled_e2e import tiled_run  # noqa: F401  (fixture)


def test_eligibility_rules():
    ok = {"class": "BeamMatchedFilter",
          "params": {"noiseParams": {"method": "dataMap",
                                     "noiseGridArcmin": 40.0},
                     "outputUnits": "uK"}}
    assert engine.eligibleForBatch(ok, {})
    # real-space filters batch too (kernel builds on host, conv + RMS on
    # device) as long as the RMS grid is device-expressible
    rs = {"class": "BeamRealSpaceMatchedFilter", "params": ok["params"]}
    assert engine.eligibleForBatch(rs, {})
    rs_bad = {"class": "BeamRealSpaceMatchedFilter",
              "params": {"noiseParams": {"method": "dataMap",
                                         "noiseGridArcmin": "smart"},
                         "outputUnits": "uK"}}
    assert not engine.eligibleForBatch(rs_bad, {})
    ok_model = {"class": "BeamMatchedFilter",
                "params": {"noiseParams": {"method": "model",
                                           "noiseGridArcmin": 40.0},
                           "outputUnits": "uK"}}
    assert engine.eligibleForBatch(ok_model, {})
    ok_max = {"class": "BeamMatchedFilter",
              "params": {"noiseParams": {"method": "max(dataMap,CMB)",
                                         "noiseGridArcmin": 40.0},
                         "outputUnits": "uK"}}
    assert engine.eligibleForBatch(ok_max, {})
    bad = {"class": "BeamMatchedFilter",
           "params": {"noiseParams": {"method": "dataMap",
                                      "noiseGridArcmin": "smart"},
                      "outputUnits": "uK"}}
    assert not engine.eligibleForBatch(bad, {})
    # saveFilter batches too now (the step returns the built filter and
    # the runner writes the host-format cache); savePlots stays host-only
    okFilt = {"class": "BeamMatchedFilter",
              "params": {"saveFilter": True,
                         "noiseParams": {"method": "dataMap",
                                         "noiseGridArcmin": 40.0},
                         "outputUnits": "uK"}}
    assert engine.eligibleForBatch(okFilt, {})
    bad = {"class": "BeamMatchedFilter",
           "params": {"savePlots": True,
                      "noiseParams": {"method": "dataMap",
                                      "noiseGridArcmin": 40.0},
                      "outputUnits": "uK"}}
    assert not engine.eligibleForBatch(bad, {})


def test_batched_pipeline_matches_host_engine(tiled_run,  # noqa: F811
                                              tmp_path):
    inputTab, hostCatalog, config, w = tiled_run
    assert len(config.tileNames) >= 4

    config.parDict["useDeviceBatching"] = True
    try:
        batchedCatalog = pipelines._filterMapsAndMakeCatalogs(
            config, rootOutDir=str(tmp_path / "batched"), verbose=False)
    finally:
        config.parDict["useDeviceBatching"] = False

    # Same number of solid detections, deduplicated the same way
    hostSNR = np.asarray(hostCatalog["SNR"])
    batchSNR = np.asarray(batchedCatalog["SNR"])
    strongHost = (hostSNR > 6).sum()
    strongBatch = (batchSNR > 6).sum()
    assert abs(strongHost - strongBatch) <= 1, (strongHost, strongBatch)

    # Cross-match: every strong host detection recovered by the batched
    # run at the same position, amplitude and S/N to FLOAT tolerance:
    # the signal maps agree bitwise-close (full-grid-exact covariance
    # smoothing) and the RMS grid now uses each tile's TRUE-shape cell
    # geometry (ops/noise.cell_meta), so nothing in the batched step
    # depends on the padded shape.  Measured 2026-08-18: max |amp ratio
    # - 1| = 2.0e-12, max separation 0.0 arcsec.
    hostM, batchM, seps = catalogs.crossMatch(hostCatalog, batchedCatalog,
                                              radiusArcmin=0.5)
    sel = np.asarray(hostM["SNR"]) > 6
    assert sel.sum() >= min(strongHost, 10)
    ampRatio = (np.asarray(batchM["deltaT_c"])[sel]
                / np.asarray(hostM["deltaT_c"])[sel])
    snrRatio = (np.asarray(batchM["SNR"])[sel]
                / np.asarray(hostM["SNR"])[sel])
    assert np.max(np.abs(ampRatio - 1)) < 1e-9, ampRatio
    assert np.max(np.abs(snrRatio - 1)) < 1e-9, snrRatio
    assert float(np.max(np.asarray(seps)[sel])) * 3600 < 1e-3

    # RMS maps were written for the photometry filter (saveRMSMap: True)
    anyTile = config.tileNames[0]
    assert os.path.exists(os.path.join(
        config.selFnDir, anyTile, "RMSMap_Beam_f090#%s.fits" % anyTile))


def test_chunked_device_batches(tiled_run):  # noqa: F811
    """deviceBatchSize splits the tile set into several device rounds and
    the results are identical to the one-shot batch."""
    from nemo_tpu.parallel.mesh import get_mesh
    inputTab, hostCatalog, config, w = tiled_run
    f = config.parDict["mapFilters"][0]
    mesh = get_mesh(n_devices=2)
    one = engine.batchFilterTiles(config, f, mesh=mesh, verbose=False)
    chunked = engine.batchFilterTiles(config, f, mesh=mesh, verbose=False,
                                      deviceBatchSize=2)
    assert set(one.keys()) == set(chunked.keys())
    assert len(one) >= 4
    for t in one:
        np.testing.assert_allclose(chunked[t]["SNMap"], one[t]["SNMap"],
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(chunked[t]["data"], one[t]["data"],
                                   rtol=1e-8, atol=1e-12)


def test_batched_model_noise_matches_host(tiled_run):  # noqa: F811
    """noiseParams method 'model' (CMB + white noise from the weights) also
    goes through the batched engine and matches the host engine."""
    from nemo_tpu import filters
    inputTab, hostCatalog, config, w = tiled_run
    import copy
    f = copy.deepcopy(config.parDict["mapFilters"][0])
    f["label"] = "Beam_model"
    f["params"]["noiseParams"]["method"] = "model"
    f["params"]["saveRMSMap"] = False
    assert engine.eligibleForBatch(f, config.parDict)
    tile = config.tileNames[0]
    host = filters.filterMaps(config.unfilteredMapsDictList, f, tile,
                              diagnosticsDir=config.diagnosticsDir,
                              selFnDir=config.selFnDir, verbose=False)
    bat = engine.batchFilterTiles(config, f, tileNames=[tile],
                                  verbose=False)[tile]
    h, b = np.asarray(host["SNMap"]), np.asarray(bat["SNMap"])
    sel = (h != 0) & (b != 0)
    assert sel.sum() > 1e5
    # identical noise sims (same fixed seeds) + identical filter math +
    # true-shape RMS cells: float tolerance, not statistical agreement
    ratio = b[np.abs(h) > 3] / h[np.abs(h) > 3]
    assert np.max(np.abs(ratio - 1)) < 1e-6, np.max(np.abs(ratio - 1))


def test_batched_max_datamap_cmb_matches_host(tiled_run):  # noqa: F811
    """noiseParams method 'max(dataMap,CMB)' through the batched engine
    matches the host engine."""
    from nemo_tpu import filters
    import copy
    inputTab, hostCatalog, config, w = tiled_run
    f = copy.deepcopy(config.parDict["mapFilters"][0])
    f["label"] = "Beam_maxcmb"
    f["params"]["noiseParams"]["method"] = "max(dataMap,CMB)"
    f["params"]["saveRMSMap"] = False
    assert engine.eligibleForBatch(f, config.parDict)
    tile = config.tileNames[0]
    host = filters.filterMaps(config.unfilteredMapsDictList, f, tile,
                              diagnosticsDir=config.diagnosticsDir,
                              selFnDir=config.selFnDir, verbose=False)
    bat = engine.batchFilterTiles(config, f, tileNames=[tile],
                                  verbose=False)[tile]
    h, b = np.asarray(host["SNMap"]), np.asarray(bat["SNMap"])
    sel = np.abs(h) > 3
    assert sel.sum() > 100
    ratio = b[sel] / h[sel]
    assert np.max(np.abs(ratio - 1)) < 1e-6, np.max(np.abs(ratio - 1))


def test_batched_multi_scale_templates_distinct(tiled_run,  # noqa: F811
                                                tmp_path):
    """Regression: the template cache must key on the filter's model
    parameters (M500MSun, z), not just geometry - an aliased key made
    every scale in a batched multi-scale run reuse the first scale's
    template.  Two well-separated Arnaud scales through ONE
    batchFilterTilesMulti call must each match their host-engine
    filterMaps output."""
    from nemo_tpu import filters as filters_mod

    inputTab, hostCatalog, config, w = tiled_run
    fSmall = {"label": "Arnaud_M1e14_z1p2",
              "class": "ArnaudModelMatchedFilter",
              "params": {"M500MSun": 1e14, "z": 1.2,
                         "noiseParams": {"method": "dataMap",
                                         "noiseGridArcmin": 40.0},
                         "outputUnits": "yc", "edgeTrimArcmin": 10.0}}
    fBig = {"label": "Arnaud_M8e14_z0p2",
            "class": "ArnaudModelMatchedFilter",
            "params": {"M500MSun": 8e14, "z": 0.2,
                       "noiseParams": {"method": "dataMap",
                                       "noiseGridArcmin": 40.0},
                       "outputUnits": "yc", "edgeTrimArcmin": 10.0}}
    tileName = config.tileNames[0]
    batched = engine.batchFilterTilesMulti(config, [fSmall, fBig],
                                           tileNames=[tileName],
                                           verbose=False)
    # The two scales must produce genuinely different filtered maps
    mapA = batched[fSmall["label"]][tileName]["data"]
    mapB = batched[fBig["label"]][tileName]["data"]
    assert not np.allclose(mapA, mapB, rtol=0.1)

    # ... and each must match its host-engine equivalent
    for f in (fSmall, fBig):
        for m in config.unfilteredMapsDictList:
            m.preprocess(tileName=tileName,
                         diagnosticsDir=config.diagnosticsDir)
        host = filters_mod.filterMaps(
            config.unfilteredMapsDictList, f, tileName,
            diagnosticsDir=config.diagnosticsDir,
            selFnDir=config.selFnDir, verbose=False)
        hostMap = np.asarray(host["data"])
        devMap = np.asarray(batched[f["label"]][tileName]["data"])
        core = np.s_[100:-100, 100:-100]
        h, d = hostMap[core], devMap[core]
        sel = np.abs(h) > np.percentile(np.abs(h), 99)
        ratio = d[sel] / h[sel]
        assert np.max(np.abs(ratio - 1)) < 1e-6, (f["label"],
                                                  np.max(np.abs(ratio - 1)))


def test_device_detection_matches_host(tiled_run, tmp_path):  # noqa: F811
    """Full on-device detection (segmentation + stats + cutouts on the
    device, catalog assembled from O(K) downloads) must reproduce the
    host pipeline's catalog: identical objects, near-identical positions
    and S/N, fluxes to the documented in-step pixel-window tolerance."""
    inputTab, hostCatalog, config, w = tiled_run
    # Reference: the SAME batched engine with host-side detection, so the
    # comparison isolates the device detection/cutout path (batched vs
    # host-engine differences are covered by
    # test_batched_pipeline_matches_host_engine).
    # saveFilteredMaps forces the lean (host-detection) path, so switch it
    # off for this test - otherwise BOTH runs take the lean path and the
    # comparison is vacuous.
    fParams = config.parDict["mapFilters"][0]["params"]
    config.parDict["useDeviceBatching"] = True
    fParams["saveFilteredMaps"] = False
    try:
        config.parDict["useDeviceDetection"] = False
        refCatalog = pipelines._filterMapsAndMakeCatalogs(
            config, rootOutDir=str(tmp_path / "ref"), verbose=False)
        config.parDict["useDeviceDetection"] = True
        from nemo_tpu.parallel import engine as eng
        spyCalls = []
        # _consume_detect_results serves BOTH detect routes (the
        # pipelined path - now taken with edge trim too - and the sync
        # _emit_detect_results helper)
        origConsume = eng._consume_detect_results

        def spy(*a, **k):
            spyCalls.append(1)
            return origConsume(*a, **k)

        eng._consume_detect_results = spy
        try:
            devCatalog = pipelines._filterMapsAndMakeCatalogs(
                config, rootOutDir=str(tmp_path / "devdet"), verbose=False)
        finally:
            eng._consume_detect_results = origConsume
        assert spyCalls, "device-detection path did not engage"
    finally:
        config.parDict["useDeviceDetection"] = False
        config.parDict["useDeviceBatching"] = False
        fParams["saveFilteredMaps"] = True

    refSNR = np.asarray(refCatalog["SNR"])
    devSNR = np.asarray(devCatalog["SNR"])
    assert (refSNR > 6).sum() == (devSNR > 6).sum()

    refM, devM, seps = catalogs.crossMatch(refCatalog, devCatalog,
                                           radiusArcmin=0.5)
    sel = np.asarray(refM["SNR"]) > 6
    assert sel.sum() >= 5
    # positions: identical segmentation + centroid math
    assert np.max(np.asarray(seps)[sel]) * 3600 < 0.1
    # S/N: same masked ratio computed either side of the link
    snrRatio = np.asarray(devM["SNR"])[sel] / np.asarray(refM["SNR"])[sel]
    assert np.max(np.abs(snrRatio - 1)) < 1e-6, snrRatio
    # fluxes: in-step pixel-window undo runs at the padded shape (the
    # reference path undoes at tile shape) - sub-percent interior effect
    ampRatio = (np.asarray(devM["deltaT_c"])[sel]
                / np.asarray(refM["deltaT_c"])[sel])
    assert np.max(np.abs(ampRatio - 1)) < 0.01, ampRatio


def test_device_detection_overflow_falls_back_to_host(tiled_run,  # noqa: F811
                                                      tmp_path):
    """A tile with more segments than the device object budget must fall
    back to host detection (VERDICT r2 #2) - the catalog must be
    IDENTICAL to the host-detection run, never silently truncated.
    Forced here by shrinking deviceDetectionMaxObjects below the per-tile
    object count."""
    inputTab, hostCatalog, config, w = tiled_run
    fParams = config.parDict["mapFilters"][0]["params"]
    config.parDict["useDeviceBatching"] = True
    fParams["saveFilteredMaps"] = False
    try:
        config.parDict["useDeviceDetection"] = False
        refCatalog = pipelines._filterMapsAndMakeCatalogs(
            config, rootOutDir=str(tmp_path / "ref"), verbose=False)
        config.parDict["useDeviceDetection"] = True
        config.parDict["deviceDetectionMaxObjects"] = 2  # force overflow
        devCatalog = pipelines._filterMapsAndMakeCatalogs(
            config, rootOutDir=str(tmp_path / "ovf"), verbose=False)
    finally:
        config.parDict["useDeviceDetection"] = False
        config.parDict["useDeviceBatching"] = False
        config.parDict.pop("deviceDetectionMaxObjects", None)
        fParams["saveFilteredMaps"] = True

    # nothing truncated: same object count as the host-detection run
    assert len(devCatalog) == len(refCatalog), \
        (len(devCatalog), len(refCatalog))
    refM, devM, seps = catalogs.crossMatch(refCatalog, devCatalog,
                                           radiusArcmin=0.5)
    assert len(refM) == len(refCatalog)
    # the overflow tiles went through the host detector: positions and
    # amplitudes must agree exactly with the host-detection reference
    assert np.max(np.asarray(seps)) * 3600 < 0.1
    ampRatio = (np.asarray(devM["deltaT_c"])
                / np.asarray(refM["deltaT_c"]))
    np.testing.assert_allclose(ampRatio, 1.0, rtol=1e-6)


def test_mixed_bank_streams_and_matches(tiled_run, tmp_path):  # noqa: F811
    """A mixed filter bank (one batchable filter + one host-only filter,
    the host-only one being the PHOTOMETRY filter) must still stream:
    every batched result is consumed as it lands (nothing accumulates in
    the engine's return dict - VERDICT r2 #6) and the catalog matches the
    pure host run, fixed_ columns included."""
    import copy

    inputTab, hostCatalog, config, w = tiled_run
    f2 = copy.deepcopy(config.parDict["mapFilters"][0])
    f2["label"] = "Beam_plots"
    f2["params"]["savePlots"] = True            # -> host-only
    f2["params"]["saveRMSMap"] = False
    f2["params"]["saveFilteredMaps"] = False
    origFilters = config.parDict["mapFilters"]
    origPhot = config.parDict["photFilter"]
    config.parDict["mapFilters"] = [origFilters[0], f2]
    config.parDict["photFilter"] = "Beam_plots"
    from nemo_tpu.parallel import engine as eng
    assert not eng.eligibleForBatch(f2, config.parDict)
    captured = {}
    orig = eng.batchFilterTilesMulti

    def wrap(*a, **k):
        out = orig(*a, **k)
        captured.update(out)
        return out

    try:
        ref = pipelines._filterMapsAndMakeCatalogs(
            config, rootOutDir=str(tmp_path / "ref"), verbose=False)
        config.parDict["useDeviceBatching"] = True
        eng.batchFilterTilesMulti = wrap
        dev = pipelines._filterMapsAndMakeCatalogs(
            config, rootOutDir=str(tmp_path / "mix"), verbose=False)
    finally:
        eng.batchFilterTilesMulti = orig
        config.parDict["useDeviceBatching"] = False
        config.parDict["mapFilters"] = origFilters
        config.parDict["photFilter"] = origPhot

    # streaming engaged: every batched result was consumed on landing
    assert captured, "batched engine did not run"
    assert all(len(v) == 0 for v in captured.values()), \
        {k: len(v) for k, v in captured.items()}

    # catalog parity with the pure host run, incl. fixed_ columns from
    # the host-only photometry filter
    assert "fixed_deltaT_c" in dev.keys()
    assert abs(len(dev) - len(ref)) <= 1
    refM, devM, seps = catalogs.crossMatch(ref, dev, radiusArcmin=0.5)
    sel = np.asarray(refM["SNR"]) > 6
    ampRatio = (np.asarray(devM["deltaT_c"])[sel]
                / np.asarray(refM["deltaT_c"])[sel])
    np.testing.assert_allclose(ampRatio, 1.0, rtol=0.01)
    fixRatio = (np.asarray(devM["fixed_deltaT_c"])[sel]
                / np.asarray(refM["fixed_deltaT_c"])[sel])
    np.testing.assert_allclose(fixRatio, 1.0, rtol=0.01)


def test_batched_filter_cache_feeds_loadFilter(tiled_run, tmp_path):  # noqa: F811
    """saveFilter through the batched engine writes the host-format cache
    (SIGNORM + RW headers): loadFilter must read it back and the filter
    must match a host-built one closely (calibration peak read differs
    sub-percent: integer-pixel vs spline)."""
    from nemo_tpu import filters as filters_mod

    inputTab, hostCatalog, config, w = tiled_run
    f = {"label": "BeamSaveF", "class": "BeamMatchedFilter",
         "params": {"noiseParams": {"method": "dataMap",
                                    "noiseGridArcmin": 40.0},
                    "outputUnits": "uK", "edgeTrimArcmin": 10.0,
                    "saveFilter": True}}
    tileName = config.tileNames[0]
    engine.batchFilterTilesMulti(config, [f], tileNames=[tileName],
                                 verbose=False)

    loader = filters_mod.getFilterClass(f["class"])(
        f["label"], config.unfilteredMapsDictList, f["params"],
        tileName=tileName, diagnosticsDir=config.diagnosticsDir)
    assert os.path.exists(loader.filterFileName)
    loader.loadFilter()
    assert loader.filt.ndim == 3 and np.isfinite(loader.filt).all()
    assert np.isfinite(loader.signalNorm) and loader.signalNorm != 1.0
    assert len(loader.fRelWeights) == 1   # single-frequency sim
    assert abs(sum(loader.fRelWeights.values()) - 1.0) < 1e-6

    # Host-built filter for the same tile: same filter to float tolerance,
    # same calibration normalisation to sub-percent
    import shutil
    shutil.rmtree(os.path.dirname(loader.filterFileName))
    host = filters_mod.getFilterClass(f["class"])(
        f["label"], config.unfilteredMapsDictList, f["params"],
        tileName=tileName, diagnosticsDir=config.diagnosticsDir)
    host.buildAndApply()
    hostFilt = np.asarray(host.filt)
    assert hostFilt.shape == loader.filt.shape
    denom = np.abs(hostFilt).max()
    assert np.abs(hostFilt - loader.filt).max() / denom < 1e-6
    assert abs(host.signalNorm / loader.signalNorm - 1) < 0.01


def test_calibration_batch_size_invariance(tiled_run, tmp_path):  # noqa: F811
    """Cached SIGNORM / RW headers must not depend on how many tiles
    share the device chunk.  Pins the XLA-miscompile class fixed in
    distribute.py one_tile (a vmapped rank-3 gather combined with the
    RMS-cell reduction corrupted every calib read at batch >= 8: the
    DR5 run cached signal norms 4/3 too large and fitQ's Q[0]/y0 gate
    tripped).  The step now ships per-plane crops via dynamic_slice and
    the host cross-checks the crop peak against the in-graph read."""
    from nemo_tpu import filters as filters_mod

    inputTab, hostCatalog, config, w = tiled_run
    f = {"label": "BeamBatchInv", "class": "BeamMatchedFilter",
         "params": {"noiseParams": {"method": "dataMap",
                                    "noiseGridArcmin": 40.0},
                    "outputUnits": "uK", "edgeTrimArcmin": 10.0,
                    "saveFilter": True}}
    tiles = list(config.tileNames)
    assert len(tiles) >= 4

    def norms(tag, tileNames, perTile):
        import copy
        ff = copy.deepcopy(f)
        ff["label"] = "BeamBatchInv%s" % tag
        if perTile:
            for t in tileNames:
                engine.batchFilterTilesMulti(config, [ff], tileNames=[t],
                                             verbose=False)
        else:
            engine.batchFilterTilesMulti(config, [ff],
                                         tileNames=tileNames,
                                         verbose=False)
        out = {}
        for t in tileNames:
            loader = filters_mod.getFilterClass(ff["class"])(
                ff["label"], config.unfilteredMapsDictList, ff["params"],
                tileName=t, diagnosticsDir=config.diagnosticsDir)
            loader.loadFilter()
            out[t] = (loader.signalNorm, dict(loader.fRelWeights))
        return out

    single = norms("S", tiles, perTile=True)
    batched = norms("B", tiles, perTile=False)
    for t in tiles:
        assert abs(batched[t][0] / single[t][0] - 1) < 1e-6, t
        for k in single[t][1]:
            assert abs(batched[t][1][k] - single[t][1][k]) < 1e-6, (t, k)


def test_device_filter_cache_and_background_writer(tiled_run):  # noqa: F811
    """The photometry filter's built filters stay device-resident between
    filtering and fitQ-style reloads (no link round trip), while the FITS
    cache lands via the background writer with identical contents."""
    import copy

    import jax.numpy as jnp

    from nemo_tpu import filters as filters_mod
    from nemo_tpu.parallel import filtercache
    from nemo_tpu.utils import fits as nfits

    inputTab, hostCatalog, config, w = tiled_run
    f = copy.deepcopy(config.parDict["mapFilters"][0])
    f["label"] = "BeamDevCache"
    f["params"]["saveFilter"] = True
    f["params"]["saveRMSMap"] = False
    oldPhot = config.parDict.get("photFilter")
    config.parDict["photFilter"] = f["label"]
    try:
        engine.batchFilterTiles(config, f, verbose=False)
    finally:
        config.parDict["photFilter"] = oldPhot

    tile = config.tileNames[0]
    fileName = os.path.join(config.diagnosticsDir, tile,
                            "filter_%s#%s.fits" % (f["label"], tile))
    ent = filtercache.DEVICE_CACHE.get(fileName)
    assert ent is not None, "photFilter filter not device-cached"

    # Device-resident reload: no host filt array, applyFilter works
    loader = filters_mod.getFilterClass(f["class"])(
        f["label"], config.unfilteredMapsDictList, f["params"],
        tileName=tile, diagnosticsDir=config.diagnosticsDir,
        geometryOnly=True)
    loader.loadFilter()
    assert loader.filt is None
    rng = np.random.default_rng(3)
    stack = rng.normal(size=(1,) + tuple(loader.shape))
    outDev = np.asarray(loader.applyFilter(jnp.asarray(stack)))

    # Device-cached filters DEFER their cache-FITS write (no eager
    # ~10 MB/tile downloads competing with survey chunks); the exit
    # flush / ensure_written materialises identical contents + headers
    assert not os.path.exists(fileName), \
        "device-cached filter FITS written eagerly (should be deferred)"
    assert filtercache.deferred_count() > 0
    filtercache.flush(materialize_deferred=True)
    assert os.path.exists(fileName)
    data, header = nfits.read_image(fileName)
    np.testing.assert_allclose(np.asarray(data, dtype=np.float64),
                               np.asarray(ent["filt"], dtype=np.float64),
                               rtol=0, atol=0)
    assert abs(header["SIGNORM"] - ent["signalNorm"]) < 1e-12

    # Disk-based reload produces the same filtered map
    filtercache.DEVICE_CACHE.clear()
    loader2 = filters_mod.getFilterClass(f["class"])(
        f["label"], config.unfilteredMapsDictList, f["params"],
        tileName=tile, diagnosticsDir=config.diagnosticsDir,
        geometryOnly=True)
    loader2.loadFilter()
    assert loader2.filt is not None
    outDisk = np.asarray(loader2.applyFilter(jnp.asarray(stack)))
    np.testing.assert_allclose(outDev, outDisk, rtol=1e-10, atol=1e-12)


def test_cached_filter_rerun_reloads_not_rebuilds(tiled_run,  # noqa: F811
                                                  tmp_path, monkeypatch):
    """useCachedFilters reruns (injection/contamination tests) must RELOAD
    the saved photometry filter, as the reference does (filters.py:536) -
    not rebuild it from the (possibly injected) data.  The batched
    engine applies the device-resident cached filter via its
    given-filter step; building a filter for that label in the rerun is
    an error."""
    import copy

    from nemo_tpu import filters as filters_mod

    inputTab, hostCatalog, config, w = tiled_run
    f = copy.deepcopy(config.parDict["mapFilters"][0])
    f["label"] = "BeamCachedRerun"
    f["params"]["saveFilter"] = True
    f["params"]["saveRMSMap"] = True
    oldFilters = config.parDict["mapFilters"]
    oldPhot = config.parDict.get("photFilter")
    config.parDict["mapFilters"] = [f]
    config.parDict["photFilter"] = f["label"]
    config.parDict["useDeviceBatching"] = True
    try:
        first = pipelines._filterMapsAndMakeCatalogs(
            config, rootOutDir=str(tmp_path / "run"), verbose=False)

        calls = []
        origBuild = filters_mod.MatchedFilter._buildFilter

        def guard(self, dataStack, apodM):
            calls.append(self.label)
            return origBuild(self, dataStack, apodM)

        monkeypatch.setattr(filters_mod.MatchedFilter, "_buildFilter",
                            guard)
        second = pipelines._filterMapsAndMakeCatalogs(
            config, rootOutDir=str(tmp_path / "run"),
            useCachedFilters=True, useCachedRMSMap=True, verbose=False)
    finally:
        config.parDict["mapFilters"] = oldFilters
        config.parDict["photFilter"] = oldPhot
        config.parDict["useDeviceBatching"] = False

    assert calls == [], "cached-filter rerun rebuilt: %s" % calls
    # The rerun recovers every first-run object at matching S/N.  (It
    # may ALSO contain spurious apod-border entries: the cached-RMS S/N
    # recompute leaves raw map values where RMS == 0, exactly as the
    # reference's "messy" insertion-sim mode does on a borderless mask,
    # reference pipelines.py:216-232 - its consumers cross-match.)
    m1, m2, _ = catalogs.crossMatch(first, second, radiusArcmin=0.5)
    assert len(m1) == len(first)
    snrRatio = np.asarray(m2["SNR"]) / np.asarray(m1["SNR"])
    assert abs(np.median(snrRatio) - 1) < 0.01, snrRatio
    assert np.percentile(np.abs(snrRatio - 1), 90) < 0.05, snrRatio


def test_bank_painting_matches_per_template(tiled_run,  # noqa: F811
                                            tmp_path):
    """bankPaintBatch paints the whole bank's templates in chunked
    batched dispatches on a padShape canvas; the stacks must be BITWISE
    identical to the per-template legacy path (the crop argument: every
    pixel is interp(r(y - cy, x - cx)), independent of canvas size)."""
    inputTab, hostCatalog, config, w = tiled_run
    tileName = config.tileNames[0]
    fList = [f for f in config.parDict["mapFilters"]
             if f["class"] not in engine._REALSPACE_CLASSES]
    assert fList
    mapsList = engine._preprocessTileOnce(config, tileName, None)
    common = engine._stage_tile_common_from_maps(mapsList)

    config.parDict["bankPaintBatch"] = True
    try:
        bankCache = {}
        bankStacks = {}
        for f in fList:
            _, stacks = engine._prepare_tile(
                config, f, tileName, templateCache=bankCache,
                mapsList=mapsList, common=common, bank=fList)
            bankStacks[f["label"]] = stacks
    finally:
        config.parDict.pop("bankPaintBatch", None)

    legacyCache = {}
    for f in fList:
        _, stacks = engine._prepare_tile(
            config, f, tileName, templateCache=legacyCache,
            mapsList=mapsList, common=common, bank=None)
        b = bankStacks[f["label"]]
        assert np.array_equal(np.asarray(b["template"]),
                              np.asarray(stacks["template"])), f["label"]
        assert np.array_equal(np.asarray(b["calib"]),
                              np.asarray(stacks["calib"])), f["label"]
        assert b["unitsScale"] == stacks["unitsScale"]
