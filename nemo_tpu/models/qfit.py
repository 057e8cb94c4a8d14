"""The filter mismatch function Q (Hasselfield et al. 2013).

Rebuild of the reference's ``QFit`` class and ``fitQ`` routine
(``nemo/signals.py:140-347, 864-1129``): Q(theta500[, z]) is measured per
tile by pushing a grid of model clusters through the tile's reference
filter and recording the peak response ratio; it is then interpolated when
converting between y0~ and mass.
"""

import functools
import os

import numpy as np
from scipy import interpolate

from .. import platform
from ..utils import fits as nfits
from ..utils.tables import Table
from . import cosmology as cosmo_mod
from . import sz


_CROP_JIT = None


def _crop_stack(a, y0, x0, h, w):
    """Jitted centre crop of the trailing two axes: compacts the slice on
    device so only (h, w) windows are copied to the host."""
    global _CROP_JIT
    if _CROP_JIT is None:
        import jax

        @functools.partial(jax.jit, static_argnames=("h", "w"))
        def crop(a, y0, x0, h, w):
            starts = (0,) * (a.ndim - 2) + (y0, x0)
            sizes = a.shape[:-2] + (h, w)
            return jax.lax.dynamic_slice(a, starts, sizes)

        _CROP_JIT = crop
    return _CROP_JIT(a, y0, x0, h=h, w=w)


class QFit:
    """Interpolated Q(theta500 [, z]) per tile (``signals.py:140-347``)."""

    def __init__(self, QSource="fit", selFnDir=None, QFitFileName=None,
                 tileNames=None):
        self._zGrid = np.array([0.05, 0.1, 0.2, 0.3, 0.4, 0.6, 0.8, 1.0,
                                1.2, 1.6, 2.0])
        self._theta500ArcminGrid = np.logspace(np.log10(0.1), np.log10(55),
                                               10)
        self.zMin = self._zGrid.min()
        self.zMax = self._zGrid.max()
        self.zDependent = None
        self.zDepThetaMax = None
        self.selFnDir = selFnDir
        self.fitDict = {}
        self.QSource = QSource
        if QSource not in ("fit", "injection", "hybrid"):
            raise ValueError("QSource must be 'fit', 'injection' or "
                             "'hybrid'")
        if QSource in ("fit", "hybrid"):
            if QFitFileName is None and selFnDir is not None:
                QFitFileName = os.path.join(selFnDir, "QFit.fits")
            if QFitFileName is not None:
                self.loadQ(QFitFileName, tileNames=tileNames)
        elif QSource == "injection":
            theta500s, thetaQ = self._loadInjectionData()
            self.fitDict[None] = interpolate.InterpolatedUnivariateSpline(
                theta500s, thetaQ, ext=1)
            self.zDependent = False

    def _loadInjectionData(self):
        from .. import completeness
        if self.selFnDir is None:
            raise ValueError("selFnDir required for injection QSource")
        injTab = Table.read(os.path.join(self.selFnDir,
                                         "sourceInjectionData.fits"))
        inputTab = Table.read(os.path.join(
            self.selFnDir, "sourceInjectionInputCatalog.fits"))
        theta500s, binCentres, compThetaGrid, thetaQ = \
            completeness._parseSourceInjectionData(injTab, inputTab, 5.0)
        return theta500s, thetaQ

    def loadQ(self, QFitFileName, tileNames=None):
        """Load per-tile Q tables from a MEF (``signals.py:204-267``)."""
        hdus = nfits.read(QFitFileName)
        available = [h.name for h in hdus if h.is_table]
        if tileNames is None:
            tileNames = available

        if self.QSource == "hybrid":
            injThetas, injQs = self._loadInjectionData()
            refTheta = None

        QStack, thetaStack = [], []
        lastTab = None
        for tileName in tileNames:
            if tileName not in available:
                continue
            cols, header = nfits.read_table(QFitFileName, ext=tileName)
            QTab = Table(cols)
            QTab.meta["ZDEPQ"] = header.get("ZDEPQ", 0)
            self.zMin = min(self.zMin, np.min(QTab["z"])) \
                if "z" in QTab.keys() else self.zMin
            self.zMax = max(self.zMax, np.max(QTab["z"])) \
                if "z" in QTab.keys() else self.zMax
            if self.QSource == "hybrid":
                if refTheta is None:
                    refTheta = np.min(np.asarray(QTab["theta500Arcmin"])[
                        np.asarray(QTab["Q"]) > 1])
                sel = np.asarray(QTab["theta500Arcmin"]) <= refTheta
                hyb = Table({
                    "theta500Arcmin": np.concatenate(
                        [np.asarray(QTab["theta500Arcmin"])[sel],
                         injThetas[injThetas > refTheta]]),
                    "Q": np.concatenate([np.asarray(QTab["Q"])[sel],
                                         injQs[injThetas > refTheta]])})
                hyb.meta = QTab.meta
                QTab = hyb
            QStack.append(np.asarray(QTab["Q"]))
            thetaStack.append(np.asarray(QTab["theta500Arcmin"]))
            self.fitDict[tileName] = self._makeInterpolator(QTab)
            lastTab = QTab
        if lastTab is not None:
            medQTab = Table({"Q": np.median(np.array(QStack), axis=0),
                             "theta500Arcmin":
                                 np.asarray(lastTab["theta500Arcmin"])})
            if "z" in lastTab.keys():
                medQTab["z"] = np.asarray(lastTab["z"])
            medQTab.meta = lastTab.meta
            self.fitDict[None] = self._makeInterpolator(medQTab)

    def _makeInterpolator(self, QTab):
        """1-d or 2-d spline per ZDEPQ (``signals.py:270-298``)."""
        if QTab.meta.get("ZDEPQ", 0) == 0:
            QTab.sort("theta500Arcmin")
            spline = interpolate.InterpolatedUnivariateSpline(
                QTab["theta500Arcmin"], QTab["Q"], ext=1)
            if self.zDependent:
                raise ValueError("Mixed z-dependent and z-independent Q")
            self.zDependent = False
            self.zDepThetaMax = None
        else:
            import warnings
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                spline = interpolate.LSQBivariateSpline(
                    np.asarray(QTab["z"]),
                    np.asarray(QTab["theta500Arcmin"]),
                    np.asarray(QTab["Q"]), self._zGrid,
                    self._theta500ArcminGrid)
            zs = np.unique(np.asarray(QTab["z"]))
            thetaMaxs = [np.max(np.asarray(QTab["theta500Arcmin"])[
                np.asarray(QTab["z"]) == z]) for z in zs]
            self.zDepThetaMax = interpolate.InterpolatedUnivariateSpline(
                zs, thetaMaxs)
            if self.zDependent is False:
                raise ValueError("Mixed z-dependent and z-independent Q")
            self.zDependent = True
        return spline

    def getQ(self, theta500Arcmin, z=None, tileName=None):
        """Interpolated Q values (``signals.py:301-347``)."""
        if tileName not in self.fitDict:
            tileName = None
        if self.zDependent:
            Qs = self.fitDict[tileName](z, theta500Arcmin)[0]
            Qs = np.asarray(Qs)
            Qs[np.asarray(theta500Arcmin) > self.zDepThetaMax(z)] = 0.0
            if z < self.zMin or z > self.zMax:
                Qs = np.zeros_like(Qs)
        else:
            Qs = self.fitDict[tileName](theta500Arcmin)
        Qs = np.asarray(Qs)
        Qs[Qs < 0] = 0
        if Qs.ndim == 0 or (np.isscalar(theta500Arcmin)):
            return float(Qs) if Qs.ndim == 0 else float(np.ravel(Qs)[0])
        return Qs


def fitQ(config):
    """Measure Q(theta500[, z]) per tile using the cached reference filter
    (``signals.py:864-1129``); writes selFn/QFit.fits as a MEF of tables."""
    import time as time_mod

    from .. import filters as filters_mod
    from ..ops import fourier
    from ..ops import paint as paint_ops
    from ..ops.interp import subpixel_value
    import jax.numpy as jnp

    cosmoModel = cosmo_mod.fiducialCosmoModel()
    photFilterLabel = config.parDict["photFilter"]
    ref = next(f for f in config.parDict["mapFilters"]
               if f["label"] == photFilterLabel)

    if "Arnaud" in ref["class"]:
        from .profiles import makeArnaudModelSignalMap as makeSignalModelMap
        from .profiles import makeArnaudModelProfile as makeModelProfile
        zDepQ = 0
    elif "Battaglia" in ref["class"]:
        from .profiles import makeBattagliaModelSignalMap \
            as makeSignalModelMap
        from .profiles import makeBattagliaModelProfile as makeModelProfile
        zDepQ = 1
    else:
        raise ValueError("Q calculation requires Arnaud or Battaglia model")

    # (M, z) grids spanning theta500 ~ 0.1 .. 50+ arcmin (signals.py:902-963)
    if zDepQ == 0:
        MRange = [ref["params"]["M500MSun"]]
        zRange = [ref["params"]["z"]]
        theta500Arcmin_wanted = 10 ** np.arange(np.log10(0.1), np.log10(50),
                                                0.05055349)
        zRange_wanted = np.array([2.0] * 10 + [1.0] * 10 + [0.6] * 10
                                 + [0.3] * 10 + [0.1] * 10 + [0.07] * 4)
        zRange_wanted = zRange_wanted[:len(theta500Arcmin_wanted)]
        for theta, z in zip(theta500Arcmin_wanted, zRange_wanted):
            MRange.append(cosmo_mod.M500cFromTheta500(theta, z, cosmoModel))
            zRange.append(z)
    else:
        MRange = [ref["params"]["M500MSun"]]
        zRange = [ref["params"]["z"]]
        zGrid = [0.05, 0.1, 0.2, 0.3, 0.4, 0.6, 0.8, 1.0, 1.2, 1.6, 2.0]
        theta500Arcmin_wanted = np.logspace(np.log10(0.1), np.log10(100), 24)
        for z in zGrid:
            for theta in theta500Arcmin_wanted:
                MRange.append(cosmo_mod.M500cFromTheta500(theta, z,
                                                          cosmoModel))
                zRange.append(z)

    models = list(zip(zRange, MRange))

    QTabDict = {}
    # Painted (and pixel-windowed) model stacks are geometry-dependent
    # but FILTER-independent: tiles in the same declination band reuse
    # them, so each band pays the ~55 model paints once instead of per
    # tile.  Only the current geometry stays resident (~0.6 GB of
    # device memory).
    paintCache = {}
    # Beam-convolved model profile TABLES are geometry-independent: one
    # (gnfw integral + harmonic beam convolution) per (model, freq) for
    # the whole run, painted per geometry in batched dispatches.
    modelTables = None

    from .beams import BeamProfile
    beamsDict = {m["obsFreqGHz"]: BeamProfile(
                     beamFileName=m["beamFileName"])
                 for m in config.parDict["unfilteredMaps"]}
    y0 = 2e-4

    def _buildModelTables():
        return _qfitModelTables(models, beamsDict, config,
                                makeModelProfile, y0)

    # Tile-batched route: group tiles by geometry,
    # paint each geometry's model stack ONCE, apply every tile's cached
    # filter to it in multi-tile device chunks, ship one scalar per
    # (tile, model).  The serial per-tile loop below remains for
    # real-space filters, the CPU decision row and ``qfitTileBatch:
    # false``.
    firstFilterClass = filters_mod.getFilterClass(ref["class"])
    refIsRealSpace = issubclass(firstFilterClass,
                                filters_mod.RealSpaceMatchedFilter)
    useTileBatch = config.parDict.get("qfitTileBatch", None)
    if useTileBatch is None:
        useTileBatch = (not refIsRealSpace
                        and platform.choices().qfit_tile_batch)
    if useTileBatch and not refIsRealSpace:
        return _fitQTileBatched(config, ref, models, _buildModelTables,
                                cosmoModel, zDepQ, y0)

    for tileName in config.tileNames:
        print("... fitting Q in tile %s" % tileName)
        tTile0 = time_mod.time()
        tPhase = {}  # per-phase wall-clock, printed for slow tiles
        filt = next(f for f in config.parDict["mapFilters"]
                    if f["label"] == photFilterLabel)
        filterClass = filters_mod.getFilterClass(filt["class"])
        filterObj = filterClass(filt["label"], config.unfilteredMapsDictList,
                                filt["params"], tileName=tileName,
                                diagnosticsDir=config.diagnosticsDir,
                                geometryOnly=True)
        tPhase["construct"] = time_mod.time() - tTile0
        t0 = time_mod.time()
        filterObj.loadFilter()
        tPhase["loadFilter"] = time_mod.time() - t0
        realSpace = issubclass(filterObj.__class__,
                               filters_mod.RealSpaceMatchedFilter)

        # Fourier filters: paint and apply at the filter's PADDED (FFT
        # bucket) shape, not the tile's true shape.  The cached filter
        # already lives on the padShape grid, so the apply needs no
        # per-true-shape reshapes - and, critically, every compiled
        # program (paint, fft+apod, crop) is then keyed on the handful
        # of survey-wide shape buckets instead of each tile's unique
        # true shape: at DR5 scale, 72 distinct true shapes cost ~30 s
        # of XLA compiles each (~2,400 s of the 2,489 s fitQ stage).
        # Value difference vs true-shape painting (centre pixel phase +
        # the painted far-field annulus), measured through a beam-
        # convolved paint -> pixel window -> l<5000 lowpass -> spline
        # peak read on a 797x811 vs 800x864 canvas: 1.1e-3 at
        # theta500 = 0.1', 1.5e-4 at 4.4', 9e-6 at 50' - below Q's own
        # method systematics (reference fit-vs-injection Q differ at
        # the percent level), and partially cancelled by the Q[0]
        # ratio.  Real-space filters convolve at the true shape.
        shape = filterObj.shape if realSpace else filterObj.padShape
        pix = filterObj.pixScalesRad
        cy, cx = shape[0] / 2.0, shape[1] / 2.0

        # Only the central window is needed for the peak read; pull a
        # small crop instead of the full filtered map
        half = 48
        y0i = max(int(cy) - half, 0)
        x0i = max(int(cx) - half, 0)

        def _paint(z, M500MSun, device=False):
            maps_f = []
            for obsFreqGHz in beamsDict:
                amplitude = sz.convertToDeltaT(y0, obsFreqGHz) \
                    if obsFreqGHz is not None else y0
                m = makeSignalModelMap(
                    z, M500MSun, shape, pix, beam=beamsDict[obsFreqGHz],
                    amplitude=amplitude, convolveWithBeam=True,
                    GNFWParams=config.parDict["GNFWParams"],
                    returnDevice=device)
                maps_f.append(m if device else np.asarray(m))
            return jnp.stack(maps_f) if device else np.stack(maps_f)

        # The ~55 model paints + filter applications batch over a model
        # axis in fixed-size chunks (one compiled program serves every
        # chunk; the last chunk is padded by repeats), with the painted
        # templates staying resident on the device.  On CPU the serial
        # path avoids a large one-off XLA compile, and the real-space
        # filter applies per frequency on host, so both keep batchSize
        # 1.  Override with config key ``qfitBatchSize``.
        batchSize = config.parDict.get("qfitBatchSize")
        if batchSize is None:
            batchSize = 1 if realSpace else \
                platform.choices().qfit_model_batch
        batchSize = 1 if realSpace else max(1, int(batchSize))

        peaks = []
        tPaint = None
        if batchSize > 1:
            geomKey = (tuple(shape), tuple(np.round(pix, 12)), batchSize)
            if geomKey not in paintCache:
                t0 = time_mod.time()
                if modelTables is None:
                    modelTables = _buildModelTables()
                nF = len(beamsDict)
                chunks = []
                for c0 in range(0, len(models), batchSize):
                    chunk = modelTables[c0:c0 + batchSize]
                    nChunk = len(chunk)
                    chunk = chunk + [chunk[-1]] * (batchSize - nChunk)
                    # one painting dispatch per chunk, not per template
                    dev = paint_ops.paint_templates_centered_batch(
                        shape, pix, [t for per in chunk for t in per])
                    dev = fourier.apply_pixel_window(
                        dev.reshape((batchSize, nF) + tuple(shape)),
                        pow=1.0)
                    chunks.append((dev, nChunk))
                paintCache[geomKey] = chunks
                # LRU of 2 geometries: survey tile order ALTERNATES
                # between the dec band's shape buckets, so keeping only
                # one geometry thrashed the cache (a repaint per tile at
                # DR5 scale); two covers the alternation while bounding
                # device memory at ~2 model stacks.
                while len(paintCache) > 2:
                    paintCache.pop(next(iter(paintCache)))
                tPaint = time_mod.time() - t0
            else:
                # LRU touch: mark this geometry most-recently-used
                paintCache[geomKey] = paintCache.pop(geomKey)
            # Q per (tile, model) is ONE scalar: evaluate the sub-pixel
            # peak read ON DEVICE (the same scipy-parity not-a-knot
            # bicubic spline the detection path uses,
            # ops/detect.spline_values) and ship ~55 floats per tile
            # instead of crop stacks, so only one scalar per model
            # leaves the device.  window=24 reproduces
            # the host path's anchor formula (interp._WINDOW) exactly,
            # so Q matches the former crop+host-spline read to ~1e-12
            # in float64 (see test_q_fit_batched_matches_serial).
            # ``qfitDevicePeaks: false`` restores the crop downloads.
            useDevicePeaks = config.parDict.get("qfitDevicePeaks", True)
            pending = []
            t0 = time_mod.time()
            from ..ops import detect as detect_ops
            from ..utils.transfer import start_host_copy
            ysC = jnp.full((1,), cy)
            xsC = jnp.full((1,), cx)
            # clamp to the tile: dynamic_slice (unlike a plain slice)
            # requires sizes <= operand dims, and irregular masks can
            # produce boundary tiles smaller than the crop window
            hCrop = min(int(cy) + half, shape[0]) - y0i
            wCrop = min(int(cx) + half, shape[1]) - x0i
            for dev, nChunk in paintCache[geomKey]:
                filteredDev = filterObj.applyFilter(dev, returnDevice=True)
                if useDevicePeaks:
                    sp, _ = detect_ops.spline_values(filteredDev, ysC, xsC,
                                                     window=24)
                    pending.append((start_host_copy(sp), nChunk))
                else:
                    # compact the crop in a jitted slice before
                    # downloading, so only the crop crosses to the host;
                    # the async copy starts every chunk's crop streaming
                    # while later chunks run
                    pending.append((start_host_copy(
                        _crop_stack(filteredDev, y0i, x0i, hCrop, wCrop)),
                        nChunk))
                del filteredDev
            tPhase["dispatch"] = time_mod.time() - t0
            t0 = time_mod.time()
            for devArr, nChunk in pending:
                vals = np.asarray(devArr)
                if useDevicePeaks:
                    peaks.extend(float(v) for v in vals[0, :nChunk])
                else:
                    for j in range(nChunk):
                        peaks.append(subpixel_value(vals[j], cy - y0i,
                                                    cx - x0i))
            tPhase["download"] = time_mod.time() - t0
        else:
            t0 = time_mod.time()
            for z, M500MSun in models:
                signalMaps = np.asarray(fourier.apply_pixel_window(
                    jnp.asarray(_paint(z, M500MSun)), pow=1.0))
                if realSpace:
                    filteredSignal = filterObj.applyFilter(signalMaps)
                    crop = np.asarray(filteredSignal)[y0i:int(cy) + half,
                                                      x0i:int(cx) + half]
                else:
                    filteredDev = filterObj.applyFilter(signalMaps,
                                                        returnDevice=True)
                    crop = np.asarray(filteredDev[y0i:int(cy) + half,
                                                  x0i:int(cx) + half])
                peaks.append(subpixel_value(crop, cy - y0i, cx - x0i))
            tPhase["serialLoop"] = time_mod.time() - t0

        QTabDict[tileName] = _assembleQTab(peaks, models, cosmoModel,
                                           zDepQ, tileName, y0)
        # fitQ is the last in-process consumer of this tile's resident
        # reference filter: retire it (background FITS write + free)
        if filterObj.filterFileName is not None:
            from ..parallel import filtercache
            filtercache.release(filterObj.filterFileName)
        tTile = time_mod.time() - tTile0
        extra = "" if tPaint is None \
            else ", incl. %.1f s painting the band's model stack" % tPaint
        if tTile > 5:
            # slow-tile diagnosis: where did the time actually go?
            extra += "; " + ", ".join("%s %.1fs" % kv
                                      for kv in sorted(tPhase.items()))
        print("    [%.1f s%s]" % (tTile, extra))

    _writeQTabs(config, QTabDict, zDepQ)
    return QTabDict


def _qfitModelTables(models, beamsDict, config, makeModelProfile, y0):
    """Per (model, freq): radial table of the FINAL painted values -
    ``paintSignalMap``'s amplitude semantics folded in (painted map =
    (rconv[0] * amplitude) * |rconv / rconv[0]|, profiles.py:120-133),
    so the batched painter needs no extra scaling pass."""
    from .profiles import convolveProfileWithBeam

    tabs = []
    for z, M500MSun in models:
        d = makeModelProfile(z, M500MSun,
                             GNFWParams=config.parDict["GNFWParams"])
        per = []
        for obsFreqGHz in beamsDict:
            amplitude = sz.convertToDeltaT(y0, obsFreqGHz) \
                if obsFreqGHz is not None else y0
            r, rconv = convolveProfileWithBeam(d["rDeg"], d["prof"],
                                               beamsDict[obsFreqGHz])
            per.append((r, (rconv[0] * amplitude)
                        * np.abs(rconv / rconv[0])))
        tabs.append(per)
    return tabs


def _assembleQTab(peaks, models, cosmoModel, zDepQ, tileName, y0):
    """Shared tail of both fitQ routes: peak list -> normalised QTab."""
    Q, QTheta500Arcmin, Qz = [], [], []
    for peak, (z, M500MSun) in zip(peaks, models):
        if peak not in Q:
            Q.append(peak)
            QTheta500Arcmin.append(
                cosmo_mod.calcTheta500Arcmin(z, M500MSun, cosmoModel))
            Qz.append(z)
    Q = np.array(Q)
    if abs(1 - Q[0] / y0) > 1e-2:
        raise ValueError("Q[0]/y0 = %.4f outside tolerance - filter "
                         "normalisation is off (tile %s)"
                         % (Q[0] / y0, tileName))
    Q = Q / Q[0]
    QTab = Table({"Q": Q, "theta500Arcmin": np.array(QTheta500Arcmin),
                  "z": np.array(Qz)})
    QTab.sort("theta500Arcmin")
    QTab.meta["ZDEPQ"] = zDepQ
    QTab.meta["TILENAME"] = tileName
    return QTab


def _writeQTabs(config, QTabDict, zDepQ):
    outFileName = os.path.join(config.selFnDir, "QFit.fits")
    hdus = [nfits.HDU(data=None, header=None)]
    for tileName in config.allTileNames:
        if tileName in QTabDict:
            hdr = nfits.Header()
            hdr["ZDEPQ"] = zDepQ
            hdu = nfits.HDU(data=QTabDict[tileName].as_dict(), header=hdr,
                            name=tileName)
            hdu.is_table = True
            hdus.append(hdu)
    nfits.write(outFileName, hdus)


def _fitQTileBatched(config, ref, models, buildModelTables, cosmoModel,
                     zDepQ, y0):
    """Tile-batched Q fit.

    The serial route pays per tile: a filter load, ~4 apply dispatches,
    a spline dispatch and a download round trip - ~0.7-1.2 s/tile of
    almost pure link latency at DR5 scale, plus a model-stack repaint
    whenever the tile geometry changes (survey order alternates between
    a dec band's shape buckets).  Here tiles are GROUPED BY GEOMETRY
    (padShape, pixel scales): each geometry's model stack is painted and
    FFT'd once, every tile's cached reference filter is applied to the
    resident spectra in multi-tile chunks
    (``sum_f irfft2(filt_t x fModel_b)``), and the centre peak is read
    on device with the same windowed not-a-knot spline as the serial
    route - one (T x B) scalar download per (tile chunk, model chunk).

    Q values match the serial route exactly: same painted stacks, same
    apodisation, same filter arrays, same spline read (see
    test_qfit_tile_batched).  Reference: ``nemo/signals.py:864-1129``.
    """
    import time as time_mod

    import jax
    import jax.numpy as jnp

    from .. import filters as filters_mod
    from ..ops import detect as detect_ops
    from ..ops import fourier, paint as paint_ops
    from ..parallel import filtercache
    from ..utils.transfer import start_host_copy

    filterClass = filters_mod.getFilterClass(ref["class"])
    tileChunk = int(config.parDict.get("qfitTileBatchSize", 4))
    modelChunk = int(config.parDict.get("qfitBatchSize", 16) or 16)

    tBudget = {"construct": 0.0, "loadFilter": 0.0, "paint": 0.0,
               "dispatch": 0.0, "download": 0.0}
    t0 = time_mod.time()
    groups = {}          # (padShape, pix) -> list of (tileName, filterObj)
    for tileName in config.tileNames:
        filterObj = filterClass(ref["label"],
                                config.unfilteredMapsDictList,
                                ref["params"], tileName=tileName,
                                diagnosticsDir=config.diagnosticsDir,
                                geometryOnly=True)
        key = (tuple(filterObj.padShape),
               tuple(np.round(filterObj.pixScalesRad, 12)))
        groups.setdefault(key, []).append((tileName, filterObj))
    tBudget["construct"] = time_mod.time() - t0
    print("... fitting Q: %d tiles in %d geometry group(s), "
          "%d models, tile chunks of %d"
          % (sum(len(v) for v in groups.values()), len(groups),
             len(models), tileChunk), flush=True)

    modelTables = buildModelTables()
    nF = len(config.parDict["unfilteredMaps"])

    @functools.partial(jax.jit, static_argnames=("padShape",))
    def _applyPeaks(filts, fModels, padShape):
        # filts (T, nf, h, wh) real; fModels (B, nf, h, wh) complex
        prod = filts[:, None] * fModels[None]
        filtered = jnp.sum(jnp.fft.irfft2(prod, s=padShape), axis=2)
        flat = filtered.reshape((-1,) + filtered.shape[-2:])
        cy, cx = padShape[0] / 2.0, padShape[1] / 2.0
        sp, _ = detect_ops.spline_values(
            flat, jnp.full((1,), cy), jnp.full((1,), cx), window=24)
        return sp[0].reshape(filts.shape[0], fModels.shape[0])

    QTabDict = {}
    for (padShape, pix), tiles in groups.items():
        # paint + FFT this geometry's model stacks once (same painter,
        # pixel window and apodisation as the serial route / applyFilter)
        t0 = time_mod.time()
        fModelChunks = []
        apodDev = fourier.apod_mask(padShape, tiles[0][1].apodPix)
        for c0 in range(0, len(models), modelChunk):
            chunk = modelTables[c0:c0 + modelChunk]
            nChunk = len(chunk)
            chunk = chunk + [chunk[-1]] * (modelChunk - nChunk)
            dev = paint_ops.paint_templates_centered_batch(
                padShape, pix, [t for per in chunk for t in per])
            dev = fourier.apply_pixel_window(
                dev.reshape((modelChunk, nF) + tuple(padShape)), pow=1.0)
            fdev = fourier.rfft2(dev * apodDev[None, None])
            fModelChunks.append((fdev, nChunk))
            del dev
        tBudget["paint"] += time_mod.time() - t0

        def _consumePending(rec):
            """Blocking read + QTab assembly for one dispatched tile
            chunk.  ONE coalesced (T, sum B) read per chunk instead of
            one per model chunk."""
            t0 = time_mod.time()
            vals = np.asarray(rec["copy"])
            tBudget["download"] += time_mod.time() - t0
            cols = []
            c0 = 0
            for _, nChunk in fModelChunks:
                cols.append(slice(c0, c0 + nChunk))
                c0 += modelChunk
            for ti, (tileName, filterObj) in enumerate(rec["tiles"]):
                peaks = [float(v) * rec["norms"][ti]
                         for sl in cols for v in vals[ti, sl]]
                QTabDict[tileName] = _assembleQTab(
                    peaks, models, cosmoModel, zDepQ, tileName, y0)
                if filterObj.filterFileName is not None:
                    filtercache.release(filterObj.filterFileName)
            _qfitBudgetRecord(config, rec["tiles"], rec["tWall"],
                              tBudget, rec["cpuIn"])

        # Deep read-deferral: each pending chunk pins only its tiny
        # (T, sum B) peak array - enqueued _applyPeaks executions
        # allocate just those outputs up front - so MANY chunks can be
        # dispatched ahead of the blocking reads, keeping the device fed
        # instead of idling at a per-chunk sync point.
        readDepth = int(config.parDict.get("qfitReadDepth", 12))
        pendingChunks = []
        for t0idx in range(0, len(tiles), tileChunk):
            tChunkWall = time_mod.time()
            cpuChunkIn = time_mod.process_time()
            chunkTiles = tiles[t0idx:t0idx + tileChunk]
            t0 = time_mod.time()
            filtDevs, norms = [], []
            for tileName, filterObj in chunkTiles:
                filterObj.loadFilter()
                filtDevs.append(filterObj._deviceFilt())
                norms.append(float(filterObj.signalNorm))
            filts = jnp.stack(filtDevs)
            tBudget["loadFilter"] += time_mod.time() - t0

            t0 = time_mod.time()
            sps = [_applyPeaks(filts, fdev, tuple(padShape))
                   for fdev, _ in fModelChunks]
            copy = start_host_copy(jnp.concatenate(sps, axis=1))
            tBudget["dispatch"] += time_mod.time() - t0

            pendingChunks.append(
                {"copy": copy, "tiles": chunkTiles, "norms": norms,
                 "tWall": tChunkWall, "cpuIn": cpuChunkIn})
            while len(pendingChunks) > readDepth:
                _consumePending(pendingChunks.pop(0))
        while pendingChunks:
            _consumePending(pendingChunks.pop(0))
    print("... fitQ budgets: " + ", ".join(
        "%s %.1fs" % kv for kv in sorted(tBudget.items())), flush=True)

    _writeQTabs(config, QTabDict, zDepQ)
    return QTabDict


def _qfitBudgetRecord(config, chunkTiles, tChunkWall, tBudget,
                      cpuChunkIn):
    """Append a fitQ chunk record to diagnostics/chunk_budgets.jsonl so
    the stage's wall-clock decomposes bucket by bucket, as the filtering
    stage's does.  ``cpu_s`` is process CPU over the chunk (all
    threads): wall_s - cpu_s ~= link/device waits when one core runs
    the process."""
    import json as _json
    import time as time_mod

    try:
        if config.diagnosticsDir:
            rec = {"stage": "fitQ",
                   "t_wall": round(time_mod.time(), 2),
                   "wall_s": round(time_mod.time() - tChunkWall, 3),
                   "cpu_s": round(
                       time_mod.process_time() - cpuChunkIn, 3),
                   "nTiles": len(chunkTiles),
                   "cum": {k: round(v, 2) for k, v in tBudget.items()}}
            os.makedirs(config.diagnosticsDir, exist_ok=True)
            with open(os.path.join(config.diagnosticsDir,
                                   "chunk_budgets.jsonl"), "a") as f:
                f.write(_json.dumps(rec) + "\n")
    except Exception:
        pass
