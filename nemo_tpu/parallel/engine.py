"""Device-batched production filtering: many tiles, one sharded call.

The per-tile host engine (``nemo_tpu/filters.py``) processes one tile at a
time - the faithful equivalent of the reference's one-tile-per-MPI-rank
loop (``nemo/pipelines.py:179``).  This module is the device scaling
path: it stages the preprocessed tiles of a whole survey as a batch,
shards the batch over the device mesh ("tiles" axis), and runs filter
build + apply + calibration + RMS + S/N for every tile in a single jitted
call (:func:`..parallel.distribute.make_sharded_matched_filter_step`).
Host code then feeds each tile's maps to the unchanged photometry/catalog
stage.

Enabled with ``useDeviceBatching: true`` in the config.  Filters that need
host-only features fall back to the per-tile engine automatically (see
:func:`eligibleForBatch`).  Numerics: catalogs match the host engine to
float tolerance (measured max |amplitude ratio - 1| = 2e-12 on the tiled
sim, positions identical) - both engines share the half-grid formulation
with full-grid-exact covariance smoothing and the same windowed-spline
calibration read, and the RMS grid is laid out on each tile's TRUE shape
even inside the shared padded-shape jit: the per-tile cell geometry
ships as data (:func:`..ops.noise.cell_meta`), so one compiled step per
shape bucket serves every true tile shape with host-exact noise cells.
"""

import functools
import os

import numpy as np

import jax
import jax.numpy as jnp

from .. import filters as filters_mod
from .. import platform
from ..models import sz
from ..ops import fourier
from ..ops import noise as noise_ops
from ..ops import paint as paint_ops
from ..utils.transfer import start_host_copy
from .distribute import (make_sharded_matched_filter_step,
                         make_sharded_realspace_step)
from .mesh import get_mesh, tile_sharding

_BATCHABLE_CLASSES = ("BeamMatchedFilter", "ArnaudModelMatchedFilter",
                      "BattagliaModelMatchedFilter")
_REALSPACE_CLASSES = ("BeamRealSpaceMatchedFilter",
                      "ArnaudModelRealSpaceMatchedFilter",
                      "BattagliaModelRealSpaceMatchedFilter")


@jax.jit
def _packbits_jit(mask):
    """Bit-pack a binary uint8 mask batch along the last axis on device
    (8x smaller downloads)."""
    return jnp.packbits(mask, axis=-1)


class _CopyBatch:
    """Coalesce a chunk's many tiny device->host reads into ONE transfer
    per (shape, dtype) group.

    Labels' results share shapes, so stacking each group on DEVICE and
    reading one array per group ships the same bytes in a handful of
    transfers instead of ~100 small ones per 16-label chunk."""

    def __init__(self):
        self._groups = {}       # (shape, dtype) -> [device array, ...]
        self._stacked = None    # (shape, dtype) -> stacked device array
        self._host = {}         # (shape, dtype) -> fetched numpy stack
        self.nRequests = 0      # blocking link reads issued
        self.nBytes = 0         # bytes fetched by those reads

    def add(self, a):
        """Register a device array; returns a handle for :meth:`get`."""
        key = (tuple(a.shape), str(a.dtype))
        lst = self._groups.setdefault(key, [])
        lst.append(a)
        return (key, len(lst) - 1)

    def dispatch(self):
        """Stack every group on device and start its single host copy."""
        self._stacked = {k: start_host_copy(jnp.stack(v))
                         for k, v in self._groups.items()}
        self._groups = {}

    def block_until_ready(self):
        """Wait for every stacked group's DEVICE computation (no
        transfer): lets the caller attribute chunk wall-clock to device
        compute vs link time - the stacked groups depend on every
        label's step outputs, so readiness here means the chunk's device
        work is done."""
        if self._stacked is None:
            self.dispatch()
        for a in self._stacked.values():
            try:
                a.block_until_ready()
            except AttributeError:
                pass

    def get(self, handle):
        """Fetch one registered array (reads its whole group once)."""
        if self._stacked is None:
            self.dispatch()
        key, idx = handle
        if key not in self._host:
            self._host[key] = np.asarray(self._stacked[key])
            self.nRequests += 1
            self.nBytes += self._host[key].nbytes
        return self._host[key][idx]


def _rmsGridBatchable(noiseParams):
    """The apply-side RMS grid must be device-expressible."""
    if noiseParams.get("RMSEstimator", "default") != "default":
        return False
    grid = noiseParams.get("noiseGridArcmin")
    return grid is not None and grid != "smart" \
        and noiseParams.get("numNoiseBins", 1) <= 1


def eligibleForBatch(f, parDict):
    """A filter spec can go through the batched device path when it uses
    the Fourier matched filter with the dataMap or model noise method and
    none of the host-only extras (cached-filter writing, weight-binned
    noise cells, noise-model catalogs), or a real-space matched filter
    (whose kernel builds on host; the full-tile convolution, RMS and S/N
    batch on the devices)."""
    params = f["params"]
    noiseParams = params.get("noiseParams", {})
    if f["class"] in _REALSPACE_CLASSES:
        # Kernel construction (the sub-region Fourier MF) runs host-side
        # either way, so its noise-method options need no restriction;
        # bckSub is applied host-side during staging.
        if not _rmsGridBatchable(noiseParams):
            return False
        if params.get("outputUnits") not in ("yc", "uK"):
            return False
        return True
    if f["class"] not in _BATCHABLE_CLASSES:
        return False
    # saveFilter/saveFreqWeightMap are supported: the sharded step
    # returns the built filter + fRel peak shares and the runner writes
    # the same cache FITS the host engine would (fitQ / getFRelWeights
    # consume it); savePlots stays host-only.
    if params.get("savePlots"):
        return False
    if noiseParams.get("method") not in ("dataMap", "model",
                                         "max(dataMap,CMB)"):
        return False
    if not _rmsGridBatchable(noiseParams):
        return False
    # noiseModelCatalog lives in the filter params (startup.py:70,476), and
    # the host filter reads it from self.params (filters.py:547) - a
    # noiseModelCatalogFromSets multipass config must fall back to the host
    # engine so the catalog objects are actually subtracted from the noise
    # model.
    if params.get("noiseModelCatalog") \
            or noiseParams.get("noiseModelCatalog"):
        return False
    if params.get("bckSub"):
        return False
    if params.get("outputUnits") not in ("yc", "uK"):
        return False
    return True


def _preprocessTileOnce(config, tileName, diagnosticsDir=None):
    """Preprocess each frequency's maps for one tile ONCE, returning
    MapDict copies carrying the preprocessed state.  MapFilter copies
    inherit it (MapDict.preprocess is a no-op when ``_preprocessedTile``
    matches), so staging N filters costs one preprocessing pass per tile
    instead of N - the preprocessing chain is filter-independent
    (``maps.py:175-475``).  Scoped to one batch call: injection runs and
    multipass passes mutate the original map dicts, and a fresh copy
    picks those up."""
    out = []
    for mapDict in config.unfilteredMapsDictList:
        newDict = mapDict.copy() if hasattr(mapDict, "copy") \
            else dict(mapDict)
        if hasattr(newDict, "preprocess"):
            newDict.preprocess(tileName=tileName,
                               diagnosticsDir=diagnosticsDir
                               or config.diagnosticsDir)
        out.append(newDict)
    return out


@functools.lru_cache(maxsize=64)
def _apod_np(shape, width):
    """Host copy of the cosine apodisation window, cached so that
    same-shape tiles share one ndarray object (the bucket runner dedups
    device uploads by identity).  Built with numpy outer products - the
    jnp path would bounce an 11 MB array through the device link."""
    ny, nx = shape[-2], shape[-1]
    wy = fourier._apod_profile(ny, int(width))
    wx = fourier._apod_profile(nx, int(width))
    return wy[:, None] * wx[None, :]


def _stage_tile_common(filterObj):
    """Label-independent big arrays for one tile (shared by every filter
    in a multi-filter batch: one host stack + one device upload instead of
    one per filter).

    Tiles with ragged data coverage (observed region not filling the
    tile rectangle) get the coverage-edge taper folded into their
    apodisation window and the coverage-edge trim folded into their
    survey mask (``filters.raggedEdgeArrays``): the trim width comes
    from the representative ``filterObj`` - filter banks share one trim
    in practice (it derives from the noise grid, which the engine also
    assumes bank-wide).  Fully-covered tiles keep the SHARED per-shape
    apod ndarray, preserving the bucket runner's upload dedup."""
    from ..filters import raggedEdgeArrays

    dataStack = np.stack([np.asarray(m["data"], dtype=np.float64)
                          for m in filterObj.unfilteredMapsDictList])
    apodM = _apod_np(filterObj.shape, filterObj.apodPix)
    surveyMask = np.asarray(
        filterObj.unfilteredMapsDictList[0]["surveyMask"], dtype=np.float64)
    psMask = np.asarray(
        filterObj.unfilteredMapsDictList[0]["pointSourceMask"],
        dtype=np.float64)
    validHost = (dataStack != 0).all(axis=0)
    if not validHost.all():
        taper, keep = raggedEdgeArrays(validHost, filterObj.apodPix,
                                       filterObj._trimSizePix(),
                                       gridPix=filterObj._noiseGridPix())
        apodM = apodM * taper
        surveyMask = surveyMask * keep
    return {"data": dataStack, "apodM": apodM, "surveyMask": surveyMask,
            "psMask": psMask, "shape": filterObj.shape,
            "padShape": filterObj.padShape}


def _templateTable(f, beamFileName, amplitude, cache):
    """Radial (r, vAbs, scale) painting table for one (filter model,
    beam, amplitude) - geometry-INDEPENDENT, so one gnfw integral +
    harmonic beam convolution serves every declination band of a survey.
    Host arrays, a few KB each; cached without eviction."""
    params = f["params"]
    key = ("table", f["class"], params.get("M500MSun"), params.get("z"),
           repr(params.get("GNFWParams", "default")), beamFileName,
           None if amplitude is None else float(amplitude))
    if cache is not None and key in cache:
        return cache[key]
    from ..models import profiles
    if f["class"].startswith("Beam"):
        tab = profiles.beamTemplateTable(beamFileName, amplitude)
    else:
        mk = profiles.makeBattagliaModelProfile \
            if f["class"].startswith("Battaglia") \
            else profiles.makeArnaudModelProfile
        d = mk(params["z"], params["M500MSun"],
               GNFWParams=params.get("GNFWParams", "default"))
        tab = profiles.signalTemplateTable(d["rDeg"], d["prof"],
                                           beam=beamFileName,
                                           amplitude=amplitude)
    if cache is not None:
        cache[key] = tab
    return tab


def _trimBankCache(cache, keep=3):
    """FIFO-evict painted bank stacks beyond ``keep`` geometries
    (~330 MB of f32 device planes each at DR5 tile sizes; survey tiles
    alternate between at most 2-3 shape variants within a declination
    band, so 3 covers the alternation)."""
    bankKeys = [k for k in cache
                if isinstance(k, tuple) and k and k[0] == "bank"]
    while len(bankKeys) > keep:
        cache.pop(bankKeys.pop(0))


def _bankTemplateStacks(cache, filterObj, bank, label):
    """Device (templates, calibStack) for EVERY Fourier-MF filter of the
    bank at this tile's geometry, painted in ONE batched dispatch.

    Template painting was the staging bottleneck at survey scale: tile
    TRUE shapes vary by +-1 pixel within a declination band (the
    autotiler's RA stretch), so exact-shape cache keys missed on nearly
    every tile and rebuilt the bank's ~64 templates one dispatch at a
    time (~7 s/tile of the ~60 s/chunk staging wall).  Painting the whole
    bank from cached radial tables costs one batched dispatch plus one
    batched pixel-window FFT per geometry variant."""
    mapsList = filterObj.unfilteredMapsDictList
    geomKey = (tuple(filterObj.shape),
               tuple(np.round(filterObj.pixScalesRad, 12)),
               tuple(m["beamFileName"] for m in mapsList),
               tuple((m.get("units"), m.get("obsFreqGHz"))
                     for m in mapsList))
    bankKey = ("bank", geomKey, tuple(f["label"] for f in bank))
    if bankKey in cache:
        ent = cache.pop(bankKey)
        cache[bankKey] = ent            # LRU touch
        return ent[label]
    y0 = 2e-4
    tables, scales = [], []
    for f in bank:
        for m in mapsList:
            r, v, s = _templateTable(f, m["beamFileName"], None, cache)
            tables.append((r, v))
            scales.append(s)
        if f["params"]["outputUnits"] == "yc":
            for m in mapsList:
                amplitude = y0 if m.get("units") == "yc" \
                    else sz.convertToDeltaT(y0, m["obsFreqGHz"])
                r, v, s = _templateTable(f, m["beamFileName"], amplitude,
                                         cache)
                tables.append((r, v))
                scales.append(s)
    ny, nx = filterObj.shape
    # Paint on the padShape-bucket canvas with the TRUE-shape centre and
    # crop: each pixel's value is interp(r(y - cy, x - cx)), so the crop
    # is bitwise identical to painting at the true shape (measured: max
    # diff 0.0 vs per-template paints) - while the painter's compiled
    # program keys on the handful of survey-wide FFT buckets instead of
    # every +-1-pixel tile-shape variant (a fresh XLA compile per
    # variant otherwise dominates the rebuild).  Fixed 16-plane chunks
    # (tail padded by repeats) reuse one compiled program per canvas.
    canvas = (int(filterObj.padShape[0]), int(filterObj.padShape[1]))
    CH = 16
    parts = []
    for c0 in range(0, len(tables), CH):
        chunk = tables[c0:c0 + CH]
        nReal = len(chunk)
        chunk = chunk + [chunk[-1]] * (CH - nReal)
        p = paint_ops.paint_templates_centered_batch(
            canvas, filterObj.pixScalesRad, chunk,
            center=(ny / 2.0, nx / 2.0))[:nReal, :ny, :nx]
        parts.append(p)
    planes = parts[0] if len(parts) == 1 else jnp.concatenate(parts, 0)
    planes = planes * jnp.asarray(
        np.asarray(scales, dtype=np.float64))[:, None, None]
    nf = len(mapsList)
    ent, i = {}, 0
    calibPlanes, calibLabels = [], []
    for f in bank:
        tmpl = planes[i:i + nf]
        i += nf
        if f["params"]["outputUnits"] == "yc":
            calibLabels.append(f["label"])
            calibPlanes.append(planes[i:i + nf])
            i += nf
            ent[f["label"]] = [tmpl, None]
        else:
            # non-yc output calibrates against the unnormalised template
            ent[f["label"]] = [tmpl, tmpl]
    if calibPlanes:
        # window application stays on device, ONE batched FFT for the
        # whole bank's calibration stacks
        calibAll = fourier.apply_pixel_window(jnp.stack(calibPlanes),
                                              pow=1.0)
        for j, lab in enumerate(calibLabels):
            ent[lab][1] = calibAll[j]
    ent = {k: tuple(v) for k, v in ent.items()}
    cache[bankKey] = ent
    _trimBankCache(cache)
    return ent[label]


def _prepare_tile(config, f, tileName, templateCache=None, mapsList=None,
                  diagnosticsDir=None,
                  common=None, useCachedFilter=False, bank=None):
    """Host-side staging for one tile: preprocessing, templates, masks.
    Returns (filterObj, stacks dict) - everything still at tile shape.

    ``templateCache`` reuses signal/calibration templates across tiles
    with identical geometry (same shape, pixel scales, beams) - tiles in
    the same declination band share templates, so a wide survey builds
    each template once per band instead of once per tile.

    ``common`` is a :func:`_stage_tile_common` dict shared across filters;
    when given (and the filter does not subset maps via ``mapToUse``) the
    big label-independent arrays are referenced, not rebuilt."""
    filterClass = filters_mod.getFilterClass(f["class"])
    filterObj = filterClass(f["label"],
                            mapsList or config.unfilteredMapsDictList,
                            f["params"], tileName=tileName,
                            diagnosticsDir=diagnosticsDir
                            or config.diagnosticsDir,
                            selFnDir=config.selFnDir)
    params = filterObj.params
    if common is None or params.get("mapToUse"):
        common = _stage_tile_common(filterObj)

    # Everything the signal template depends on besides geometry/beam:
    # the filter class plus its model-shape parameters (M500MSun, z,
    # GNFWParams for the cluster filters; none for beam filters).  A key
    # WITHOUT these would alias different filter scales to one template.
    modelKey = (type(filterObj).__name__,
                params.get("M500MSun"), params.get("z"),
                repr(params.get("GNFWParams", "default")))

    def _template(beamFileName, amplitude=None):
        # Templates are built AND cached on device (returnDevice): a host
        # copy would only be re-uploaded by the bucket runner.
        if templateCache is None:
            return filterObj.makeSignalTemplateMap(
                beamFileName, amplitude=amplitude, returnDevice=True)
        key = (filterObj.shape,
               tuple(np.round(filterObj.pixScalesRad, 12)),
               beamFileName, amplitude, modelKey)
        if key not in templateCache:
            templateCache[key] = filterObj.makeSignalTemplateMap(
                beamFileName, amplitude=amplitude, returnDevice=True)
            _trimCache(templateCache)
        return templateCache[key]

    dataStack = common["data"]
    method = params["noiseParams"]["method"]
    if method in ("dataMap", "max(dataMap,CMB)"):
        noiseStack = dataStack
    else:
        noiseStack = np.asarray(filterObj._noiseStack(dataStack),
                                dtype=np.float64)

    # The STACKED template/calib arrays are cached (not just the
    # individual templates) so tiles with identical geometry return the
    # very same ndarray object - the bucket runner dedups uploads by
    # object identity and ships each distinct stack once per chunk.
    beamFiles = tuple(m["beamFileName"]
                      for m in filterObj.unfilteredMapsDictList)
    geomKey = (filterObj.shape,
               tuple(np.round(filterObj.pixScalesRad, 12)), beamFiles,
               modelKey)

    def _cachedStack(key, build):
        if templateCache is None:
            return build()
        if key not in templateCache:
            templateCache[key] = build()
            _trimCache(templateCache)
        return templateCache[key]

    y0 = 2e-4
    useBank = bank is not None and templateCache is not None \
        and not params.get("mapToUse")
    if useBank:
        # Whole-bank batched painting: a few dispatches per geometry
        # variant instead of one per template.  On CPU (tests, small
        # maps) the vmapped painter is slower than the plain one and
        # pays a large one-off compile, so the backend's decision row
        # turns it off there; results are bitwise identical either way
        # (bankPaintBatch: true/false/auto).
        mode = config.parDict.get("bankPaintBatch", "auto")
        useBank = (mode is True) or (mode == "auto"
                                     and platform.choices().bank_paint)
    if useBank:
        templates, calibStack = _bankTemplateStacks(
            templateCache, filterObj, bank, f["label"])
    else:
        templates = _cachedStack(
            ("stack",) + geomKey,
            lambda: jnp.stack([_template(m["beamFileName"])
                               for m in filterObj.unfilteredMapsDictList]))
        # Known-amplitude calibration stack (filters.py:635-690 in the
        # reference; mirrors MatchedFilter._calibrateSignalNorm here).
        if params["outputUnits"] == "yc":
            def _buildCalib():
                calib = []
                for m in filterObj.unfilteredMapsDictList:
                    if m.get("units") == "yc":
                        s = _template(m["beamFileName"], amplitude=y0)
                    else:
                        deltaT0 = sz.convertToDeltaT(y0, m["obsFreqGHz"])
                        s = _template(m["beamFileName"],
                                      amplitude=deltaT0)
                    # window application stays on device - no host bounce
                    calib.append(fourier.apply_pixel_window(
                        jnp.asarray(s), pow=1.0))
                return jnp.stack(calib)

            unitsKey = tuple((m.get("units"), m.get("obsFreqGHz"))
                             for m in filterObj.unfilteredMapsDictList)
            calibStack = _cachedStack(("calib", unitsKey) + geomKey,
                                      _buildCalib)
        else:
            calibStack = templates
    unitsScale = y0 if params["outputUnits"] == "yc" else 1.0
    w = filters_mod._freq_weights(filterObj.unfilteredMapsDictList, params)

    # Cached-filter reruns (injection/contamination tests) must RELOAD
    # the saved filter and only apply it, as the reference does
    # (filters.py:536).  The device cache serves the reference filter
    # with no link traffic; other labels read their cache FITS if one
    # exists.  Falls back to a fresh build when no (shape-compatible)
    # cache is found.
    cachedFilt = cachedNorm = None
    if useCachedFilter and filterObj.filterFileName is not None:
        from . import filtercache
        nf = len(filterObj.unfilteredMapsDictList)
        halfShape = (nf, filterObj.padShape[0],
                     filterObj.padShape[1] // 2 + 1)
        ent = filtercache.DEVICE_CACHE.get(filterObj.filterFileName)
        if ent is not None and tuple(ent["filt"].shape) == halfShape:
            cachedFilt = ent["filt"]
            cachedNorm = float(ent["signalNorm"])
        else:
            filtercache.ensure_written(filterObj.filterFileName)
            if os.path.exists(filterObj.filterFileName):
                from ..utils import fits as nfits
                fdata, fheader = nfits.read_image(filterObj.filterFileName)
                fdata = np.asarray(fdata, dtype=np.float64)
                if tuple(fdata.shape) == halfShape:
                    cachedFilt = fdata
                    cachedNorm = float(fheader["SIGNORM"])

    gridSize = int(round(
        (params["noiseParams"]["noiseGridArcmin"] / 60.0)
        / filterObj.wcs.getPixelSizeDeg()))
    if method == "max(dataMap,CMB)":
        fgPower = np.asarray(filterObj._foregroundsPower(),
                             dtype=np.float64)
    else:
        fgPower = None
    trimPix = filterObj._trimSizePix()
    if common.get("coverEdt") is not None and \
            not common.get("_keepApplied"):
        # ragged coverage: fold the coverage-edge trim into the COMMON
        # survey mask (filters.raggedEdgeArrays semantics) - the bucket
        # runner uploads common["surveyMask"], so the fold must land
        # there, once per tile.  The first label's trim width decides
        # (filter banks share one trim in practice: it derives from the
        # noise grid, which the engine also assumes bank-wide).
        erodePix = filters_mod.coverageErodePix(filterObj.apodPix,
                                                trimPix, gridSize)
        common["surveyMask"] = common["surveyMask"] * (
            common["coverEdt"] > erodePix)
        common["_keepApplied"] = True
    surveyMask = common["surveyMask"]
    return filterObj, {"common": common, "data": dataStack,
                       "noise": noiseStack,
                       "cachedFilt": cachedFilt, "cachedNorm": cachedNorm,
                       "fgPower": fgPower, "template": templates,
                       "calib": calibStack, "w": w,
                       "apodM": common["apodM"],
                       "surveyMask": surveyMask,
                       "psMask": common["psMask"],
                       "gridSize": gridSize,
                       "trimPix": filterObj._trimSizePix(),
                       "unitsScale": unitsScale,
                       "padShape": filterObj.padShape,
                       "shape": filterObj.shape}


def _prepare_tile_realspace(config, f, tileName, mapsList=None,
                            diagnosticsDir=None):
    """Host-side staging for one real-space-filter tile: preprocessing,
    kernel build (sub-region Fourier MF + truncation + signal-norm
    calibration, ``RealSpaceMatchedFilter.buildKernel``), background
    subtraction.  Returns (filterObj, stacks dict) at true tile shape."""
    filterClass = filters_mod.getFilterClass(f["class"])
    filterObj = filterClass(f["label"],
                            mapsList or config.unfilteredMapsDictList,
                            f["params"], tileName=tileName,
                            diagnosticsDir=diagnosticsDir
                            or config.diagnosticsDir,
                            selFnDir=config.selFnDir)
    params = filterObj.params
    filterObj.buildKernel(filterObj._resolveRADecSection())

    dataStack = np.stack([np.asarray(m["data"], dtype=np.float64)
                          for m in filterObj.unfilteredMapsDictList])
    if params.get("bckSub") and filterObj.bckSubScaleArcmin > 0:
        from .. import maps as maps_mod
        dataStack = np.stack([
            maps_mod.subtractBackground(
                dataStack[i], filterObj.wcs,
                smoothScaleDeg=filterObj.bckSubScaleArcmin / 60.0)
            for i in range(dataStack.shape[0])])

    apodM = _apod_np(filterObj.shape, filterObj.apodPix)
    surveyMask = np.asarray(
        filterObj.unfilteredMapsDictList[0]["surveyMask"], dtype=np.float64)
    psMask = np.asarray(
        filterObj.unfilteredMapsDictList[0]["pointSourceMask"],
        dtype=np.float64)
    validHost = (dataStack != 0).all(axis=0)
    if not validHost.all():
        # ragged coverage: engage the coverage-edge trim (erosion only -
        # the compact conv kernel needs no taper; see host
        # RealSpaceMatchedFilter.buildAndApply)
        _, keep = filters_mod.raggedEdgeArrays(
            validHost, filterObj.apodPix, filterObj._trimSizePix(),
            gridPix=filterObj._noiseGridPix())
        surveyMask = surveyMask * keep
    gridSize = int(round(
        (params["noiseParams"]["noiseGridArcmin"] / 60.0)
        / filterObj.wcs.getPixelSizeDeg()))
    return filterObj, {"data": dataStack,
                       "kern": np.asarray(filterObj.kern2d,
                                          dtype=np.float64),
                       "signalNorm": float(filterObj.signalNorm),
                       "apodM": apodM, "surveyMask": surveyMask,
                       "psMask": psMask, "gridSize": gridSize,
                       "trimPix": filterObj._trimSizePix(),
                       "shape": filterObj.shape}


_TEMPLATE_CACHE_MAX = 96    # ~0.6 GB of f32 tile templates on device
                            # (device memory also holds the resident data
                            # batch, the step workspace and - in detect
                            # mode - the reference filter's maps)


def _trimCache(cache):
    """FIFO-evict the oldest template-cache entries (survey tiles march
    through declination bands in order, so old bands never recur)."""
    while len(cache) > _TEMPLATE_CACHE_MAX:
        cache.pop(next(iter(cache)))


def _asBinaryMask(m):
    """uint8 view of a strictly-binary mask (8x less upload volume);
    non-binary masks pass through unchanged."""
    m = np.asarray(m)
    if m.dtype == np.uint8:
        return m
    if np.all((m == 0) | (m == 1)):
        return m.astype(np.uint8)
    return m


def _pad2(a, padShape):
    """Zero-pad the last two axes to padShape (host-side: staging must not
    bounce arrays through the device just to pad them)."""
    a = np.asarray(a)
    ny, nx = a.shape[-2], a.shape[-1]
    py, px = padShape
    if (py, px) == (ny, nx):
        return a
    pad = [(0, 0)] * (a.ndim - 2) + [(0, py - ny), (0, px - nx)]
    return np.pad(a, pad)


def _padKernels(kern, kShape):
    """Zero-pad (nf, ky, kx) kernels symmetrically to the bucket's common
    odd kernel shape - exact for the reflect convolution (zero taps
    contribute nothing and pad parity keeps the centre tap centred)."""
    ky, kx = kern.shape[-2:]
    dy, dx = kShape[0] - ky, kShape[1] - kx
    assert dy % 2 == 0 and dx % 2 == 0
    return np.pad(kern, ((0, 0), (dy // 2, dy // 2), (dx // 2, dx // 2)))


def batchFilterTiles(config, f, tileNames=None, mesh=None, rms_impl="auto",
                     undoPixelWindow=True, verbose=True,
                     deviceBatchSize=None):
    """Filter every tile with one sharded device call per shape bucket.

    Returns {tileName: filteredMapDict} with the same contract as
    ``filters.filterMaps`` (data/SNMap/surveyMask/flagMask/units/...), so
    the result drops into the existing catalog pipeline.
    """
    return batchFilterTilesMulti(
        config, [f], tileNames=tileNames, mesh=mesh, rms_impl=rms_impl,
        undoPixelWindow=undoPixelWindow, verbose=verbose,
        deviceBatchSize=deviceBatchSize)[f["label"]]


def batchFilterTilesMulti(config, fList, tileNames=None, mesh=None,
                          rms_impl="auto", undoPixelWindow=True,
                          verbose=True, deviceBatchSize=None,
                          consume=None, detectParams=None,
                          diagnosticsDir=None, useCachedFilters=False):
    """Batched filtering of every (tile, filter) combination.

    ``consume(label, tileName, filteredMapDict) -> bool``: optional
    streaming sink invoked as each result lands on host.  Returning True
    transfers ownership - the engine drops its reference, so peak memory
    is one chunk of maps, not the whole survey (214 DR5 tiles x 16
    scales x ~22 MB of float64 maps is ~75 GB if accumulated).

    Staging runs tile-outer so each tile's maps are loaded and
    preprocessed ONCE for the whole filter bank (the reference preprocesses
    per filter inside its per-tile loop, ``pipelines.py:154-184``; at DR5
    scale that is a 16x host-side repeat), and the big label-independent
    arrays (data, masks, apodisation) are uploaded to the devices ONCE per
    tile chunk with every filter scale run against the resident copies -
    only the (small relative to a survey) signal/calibration templates move
    per filter.  Buckets flush as soon as ``deviceBatchSize`` tiles are
    staged, so peak host memory is bounded by the chunk, not the survey.

    Returns {filterLabel: {tileName: filteredMapDict}}.

    ``deviceBatchSize`` bounds how many tiles are resident on the devices
    at once (default: 2 per device; config key ``deviceBatchSize``) - the
    same compiled step is reused chunk after chunk.
    """
    tileNames = tileNames if tileNames is not None else config.tileNames
    mesh = mesh or get_mesh(n_devices=config.parDict.get("meshDevices"))
    nDev = mesh.devices.size
    if deviceBatchSize is None:
        deviceBatchSize = int(config.parDict.get("deviceBatchSize",
                                                 2 * nDev))
    deviceBatchSize = max(nDev, (deviceBatchSize // nDev) * nDev)

    templateCache = {}
    # Fourier-MF labels sharing the full map list paint their templates
    # as ONE batched dispatch per tile geometry (_bankTemplateStacks)
    mfBank = [f for f in fList if f["class"] not in _REALSPACE_CLASSES
              and not f["params"].get("mapToUse")] or None
    results = {f["label"]: {} for f in fList}
    staged = {f["label"]: {} for f in fList}
    rsBuckets = {}      # (label, key) -> [names]   (real-space: per label)
    mfBuckets = {}      # key -> {"names": [...], "labels": set()}

    def _flush_rs(f, key, names):
        label = f["label"]
        padShape, nf, gridSize, trimPix = key
        _run_bucket_realspace(config, staged[label], names, gridSize,
                              trimPix, mesh, nDev, rms_impl,
                              undoPixelWindow, verbose, results[label],
                              label=label, consume=consume,
                              padTo=deviceBatchSize)
        for n in names:
            del staged[label][n]

    pendingMF = []      # staged chunks whose uploads are still streaming

    def _drain_mf(depth=0):
        while len(pendingMF) > depth:
            ctx, gs, tp = pendingMF.pop(0)
            _process_bucket_shared(config, ctx, gs, tp, mesh, nDev,
                                   rms_impl, undoPixelWindow, verbose,
                                   results, consume=consume,
                                   detectParams=detectParams)

    def _flush_mf(key, bucket):
        padShape, nf, gridSize, trimPix = key
        names = bucket["names"]
        # group labels by the subset of these names they actually staged
        # under this key (labels can hop buckets across dec bands)
        groups = {}
        for label in sorted(bucket["labels"]):
            sub = tuple(n for n in names if n in staged[label])
            if sub:
                groups.setdefault(sub, []).append(label)
        photLabel = config.parDict.get("photFilter")
        groupList = sorted(groups.items(),
                           key=lambda kv: photLabel not in kv[1])
        for sub, labels in groupList:
            if photLabel in labels:  # phot first: its maps stay resident
                labels = [photLabel] + [l for l in labels
                                        if l != photLabel]
            # Dispatch this chunk's uploads NOW (async), then process
            # whatever was staged before it: the one-chunk deferral
            # overlaps each chunk's upload stream with the previous
            # chunk's compute + downloads.
            ctx = _stage_bucket_uploads(staged, labels, list(sub),
                                        padShape, mesh, nDev,
                                        padTo=deviceBatchSize,
                                        gridSize=gridSize)
            for label in labels:
                for n in sub:
                    staged[label].pop(n, None)
            pendingMF.append((ctx, gridSize, trimPix))
            # Drain INSIDE the group loop: with several label groups per
            # bucket (labels hopping buckets across dec bands) draining
            # only afterwards would leave group-count + 1 chunks of
            # device buffers resident, breaking the ~two-chunk memory
            # bound.  ``chunkPipelineDepth`` > 1 keeps more chunks'
            # uploads in flight (a stalled transfer then overlaps the
            # next chunk's device work) at the cost of proportionally
            # more resident device buffers - raise it only with device
            # memory headroom.
            _drain_mf(depth=int(config.parDict.get("chunkPipelineDepth",
                                                   1)))

    import time as _time
    phaseT = {"stageWait": 0.0}
    tBatch0 = _time.time()

    # Stage whole tiles (preprocess + every label's _prepare_tile, incl.
    # the bank template painting dispatches) on a worker thread: round 3
    # ran this serially BETWEEN chunk flushes, putting ~15 s/chunk of
    # host staging (~400 s at DR5 scale, run.log "templates+stage") on
    # the critical path while the devices sat idle.  One worker + a
    # bounded look-ahead preserves the template/bank cache access order
    # (tiles staged strictly in survey order) and keeps peak host memory
    # at ~one extra chunk of staged tiles; the main thread only files
    # the staged entries into shape buckets and flushes chunks.
    from concurrent.futures import ThreadPoolExecutor
    tileNames = list(tileNames)
    prefetcher = ThreadPoolExecutor(max_workers=1)
    lookahead = max(2, min(int(deviceBatchSize), 16))
    prefetched = {}

    def _stageTileWorker(tileName):
        mapsList = _preprocessTileOnce(config, tileName, diagnosticsDir)
        common = _stage_tile_common_from_maps(mapsList)
        entries = []
        for f in fList:
            if f["class"] in _REALSPACE_CLASSES:
                filterObj, stacks = _prepare_tile_realspace(
                    config, f, tileName, mapsList=mapsList,
                    diagnosticsDir=diagnosticsDir)
            else:
                filterObj, stacks = _prepare_tile(
                    config, f, tileName, templateCache=templateCache,
                    mapsList=mapsList, common=common,
                    diagnosticsDir=diagnosticsDir,
                    useCachedFilter=useCachedFilters, bank=mfBank)
            entries.append((f, filterObj, stacks))
        return entries

    def _submitPrefetch(i):
        if 0 <= i < len(tileNames) and i not in prefetched:
            prefetched[i] = prefetcher.submit(_stageTileWorker,
                                              tileNames[i])

    for i in range(min(lookahead, len(tileNames))):
        _submitPrefetch(i)

    try:
        for tileIdx, tileName in enumerate(tileNames):
            t0 = _time.time()
            entries = prefetched.pop(tileIdx).result()
            _submitPrefetch(tileIdx + lookahead)
            phaseT["stageWait"] += _time.time() - t0
            for f, filterObj, stacks in entries:
                label = f["label"]
                if f["class"] in _REALSPACE_CLASSES:
                    # true tile shape: the conv boundary must reflect at
                    # the genuine tile edge, so no zero padding of maps
                    key = (stacks["shape"], stacks["data"].shape[0],
                           stacks["gridSize"], stacks["trimPix"])
                    staged[label][tileName] = (filterObj, stacks)
                    names = rsBuckets.setdefault((label, key), [])
                    names.append(tileName)
                else:
                    key = (stacks["padShape"], stacks["data"].shape[0],
                           stacks["gridSize"], stacks["trimPix"])
                    staged[label][tileName] = (filterObj, stacks)
                    bucket = mfBuckets.setdefault(key, {"names": [],
                                                        "labels": set()})
                    bucket["labels"].add(label)
                    if tileName not in bucket["names"]:
                        bucket["names"].append(tileName)
            # Flush only at tile boundaries so every filter of the bank
            # is staged for every tile in the chunk - a mid-tile flush
            # would split the bank into a 1-filter call plus a
            # stragglers call, re-uploading the shared data stack for
            # each group.
            for (label, key), names in list(rsBuckets.items()):
                if len(names) >= deviceBatchSize:
                    fdict = next(f for f in fList if f["label"] == label)
                    _flush_rs(fdict, key, names)
                    rsBuckets[(label, key)] = []
            for key, bucket in list(mfBuckets.items()):
                if len(bucket["names"]) >= deviceBatchSize:
                    _flush_mf(key, bucket)
                    mfBuckets[key] = {"names": [], "labels": set()}
                    if verbose:
                        print("    [staging so far: %.1fs waiting on "
                              "the staging worker]"
                              % phaseT["stageWait"], flush=True)
    finally:
        prefetcher.shutdown(wait=False, cancel_futures=True)

    for f in fList:
        if f["class"] in _REALSPACE_CLASSES:
            for (label, key), names in rsBuckets.items():
                if label == f["label"] and names:
                    _flush_rs(f, key, names)
                    rsBuckets[(label, key)] = []
    for key, bucket in mfBuckets.items():
        if bucket["names"]:
            _flush_mf(key, bucket)
    _drain_mf(depth=0)
    if verbose:
        # Stage-exit accounting: the per-chunk budget lines cover only
        # the upload/step/device/download phases; whatever wall-clock a
        # survey run spends OUTSIDE them (consume-pass host assembly,
        # tail-bucket compiles, writer backpressure) shows up here as
        # the residual vs this total.
        print("    [batch total %.1fs; staging-worker wait %.1fs]"
              % (_time.time() - tBatch0, phaseT["stageWait"]),
              flush=True)
    return results


def _stage_tile_common_from_maps(mapsList):
    """Label-independent big arrays for one tile, straight from the
    preprocessed map dicts (no filter object needed: the apodisation width
    is the fixed MapFilter.apodPix = 20 and padShape is shape-derived).

    Ragged-coverage tiles (nonzero-data region not filling the
    rectangle) get the coverage-edge taper folded into their apod
    window here and carry the coverage distance transform
    (``coverEdt``) so :func:`_prepare_tile` can fold the per-label
    coverage-edge trim into the survey mask
    (``filters.raggedEdgeArrays``)."""
    dataStack = np.stack([np.asarray(m["data"], dtype=np.float64)
                          for m in mapsList])
    shape = dataStack.shape[-2:]
    padShape = (fourier.good_fft_size(shape[0]),
                fourier.good_fft_size(shape[1]))
    apodM = _apod_np(shape, 20)
    surveyMask = np.asarray(mapsList[0]["surveyMask"], dtype=np.float64)
    psMask = np.asarray(mapsList[0]["pointSourceMask"], dtype=np.float64)
    coverEdt = None
    validHost = (dataStack != 0).all(axis=0)
    if not validHost.all():
        from scipy.ndimage import distance_transform_edt
        coverEdt = distance_transform_edt(validHost).astype(np.float32)
        w = 20.0
        apodM = apodM * (0.5 - 0.5 * np.cos(
            np.pi * np.minimum(coverEdt / w, 1.0)))
    return {"data": dataStack, "apodM": apodM, "surveyMask": surveyMask,
            "psMask": psMask, "shape": shape, "padShape": padShape,
            "coverEdt": coverEdt}


def _emit_result(config, filterObj, tileName, dataMap, SNMap, RMSMap,
                 tileMask, undoPixelWindow, results):
    """Shared per-tile result assembly: RMS-map save and output-units
    metadata - the tail of the host engines' buildAndApply.  The
    pixel-window undo runs with HOST numpy FFTs on the map the host
    already holds, instead of a device round trip per (tile, filter)."""
    if undoPixelWindow:
        zeroMask = dataMap == 0
        ny, nx = dataMap.shape
        wy, wx = fourier._window_half_1d(ny, nx, -1.0)
        fm = np.fft.rfft2(dataMap)
        dataMap = np.fft.irfft2(fm * (wy[:, None] * wx[None, :]),
                                s=(ny, nx))
        dataMap[zeroMask] = 0
    params = filterObj.params
    if params.get("saveRMSMap") and RMSMap is not None:
        import os
        from ..utils import fits as nfits
        RMSFileName = os.path.join(
            config.selFnDir, tileName,
            "RMSMap_%s#%s.fits" % (filterObj.label, tileName))
        os.makedirs(os.path.dirname(RMSFileName), exist_ok=True)
        nfits.write_image(RMSFileName, RMSMap, filterObj.wcs.header,
                          compressionType="RICE_1")
    if params["outputUnits"] == "yc":
        mapUnits, obsFreqGHz, solidAngle = "yc", "yc", 0.0
    else:
        obsFreqGHz = float(list(filterObj.beamSolidAnglesDict)[0])
        mapUnits = "uK"
        solidAngle = filterObj.beamSolidAnglesDict[obsFreqGHz]
    results[tileName] = {
        "data": dataMap, "wcs": filterObj.wcs,
        "obsFreqGHz": obsFreqGHz, "SNMap": SNMap,
        "RMSMap": RMSMap, "surveyMask": tileMask,
        "flagMask": filterObj.flagMask, "mapUnits": mapUnits,
        "beamSolidAngle_nsr": solidAngle, "label": filterObj.label,
        "tileName": tileName}


def _run_bucket_realspace(config, staged, names, gridSize, trimPix, mesh,
                          nDev, rms_impl, undoPixelWindow, verbose,
                          results, label=None, consume=None, padTo=None):
    """One device call for a chunk of same-shaped real-space-filter tiles."""
    if verbose:
        print("... device batch (real-space): %d tile(s) at %s"
              % (len(names), str(staged[names[0]][1]["shape"])))
    step = make_sharded_realspace_step(mesh, gridSize, trimPix,
                                       rms_impl=rms_impl,
                                       undo_pixel_window=undoPixelWindow)
    kShape = (max(staged[n][1]["kern"].shape[-2] for n in names),
              max(staged[n][1]["kern"].shape[-1] for n in names))
    data = np.stack([staged[n][1]["data"] for n in names])
    kern = np.stack([_padKernels(staged[n][1]["kern"], kShape)
                     for n in names])
    signalNorm = np.array([staged[n][1]["signalNorm"] for n in names])
    apodM = np.stack([staged[n][1]["apodM"] for n in names])
    surveyMask = np.stack([staged[n][1]["surveyMask"] for n in names])
    psMask = np.stack([staged[n][1]["psMask"] for n in names])

    nT = len(names)
    # pad partial chunks to the full chunk size so the tail chunk reuses
    # the compiled step (see _stage_bucket_uploads)
    pad = padTo - nT if padTo and padTo > nT else (-nT) % nDev
    if pad:
        rep = ([1] * (nT - 1)) + [1 + pad]
        (data, kern, signalNorm, apodM, surveyMask, psMask) = [
            np.repeat(a, rep, axis=0) for a in
            (data, kern, signalNorm, apodM, surveyMask, psMask)]

    sh = tile_sharding(mesh)
    # real-space tiles run at TRUE shape (no padding), so the per-tile
    # cell geometry is the batch shape itself for every tile
    shape = data.shape[-2:]
    meta = noise_ops.cell_meta_batch([shape] * data.shape[0], shape,
                                     gridSize)
    metaDev = {k: jax.device_put(jnp.asarray(v), sh)
               for k, v in meta.items()}
    out = step(jax.device_put(jnp.asarray(data), sh),
               jax.device_put(jnp.asarray(kern), sh),
               jax.device_put(jnp.asarray(signalNorm), sh),
               jax.device_put(jnp.asarray(apodM), sh),
               jax.device_put(jnp.asarray(psMask), sh),
               jax.device_put(jnp.asarray(surveyMask), sh),
               metaDev)
    filtered = np.asarray(out["filtered"][:nT])
    SNMaps = np.asarray(out["SNMap"][:nT])
    saveRMS = staged[names[0]][0].params.get("saveRMSMap")
    RMSMaps = np.asarray(out["RMSMap"][:nT]) if saveRMS else None
    outMask = np.asarray(out["surveyMask"][:nT]).astype(float)

    for i, tileName in enumerate(names):
        filterObj, stacks = staged[tileName]
        _emit_result(config, filterObj, tileName, filtered[i], SNMaps[i],
                     RMSMaps[i] if RMSMaps is not None else None,
                     outMask[i], False, results)  # undo ran in-step
        if consume is not None and label is not None:
            if consume(label, tileName, results[tileName]):
                results.pop(tileName, None)


def _calibNormsFromCrops(out, st, names, nT, padShape, tPhase):
    """Per-tile signal normalisation (1 / sub-pixel calibration peak)
    and fRel weights from the step's per-plane 33x33 filtered-calibration
    crops - the same windowed spline read as the host engine
    (filters.py:660-662).  The step's own integer-pixel read misses the
    peak for odd tile dimensions (template centres sit between pixels).

    Tripwire: the crop's integer peak pixel must reproduce the step's
    own in-graph peak read (1 / out["signalNorm"]).  The two reads go
    through different XLA lowerings of the same intermediate; a past
    XLA miscompile (see distribute.py one_tile) silently returned a
    corrupted crop, which this check now turns into a hard error.

    Returns (norms (nT,), fRelW (nT, nf))."""
    return _calibNormsConsume(_calibNormsDispatch(out, nT), st, names,
                              nT, padShape, tPhase)


def _calibNormsDispatch(out, nT, co=None):
    """Slice the calibration crops / in-graph norms off the step output
    and start their host copies (via the chunk's :class:`_CopyBatch`
    when given, else :func:`start_host_copy`)."""
    send = co.add if co is not None else start_host_copy
    return {"crops": send(out["calibCrop"][:nT]),
            "norm": send(out["signalNorm"][:nT])}


def _calibNormsConsume(devs, st, names, nT, padShape, tPhase, co=None):
    import time as _time
    from scipy import interpolate as sinterp

    read = co.get if co is not None else np.asarray
    t0 = _time.time()
    crops = np.asarray(read(devs["crops"]), dtype=np.float64)
    stepPeaks = 1.0 / np.asarray(read(devs["norm"]), dtype=np.float64)
    tPhase["download"] += _time.time() - t0
    tPhase["downBytes"] = tPhase.get("downBytes", 0) + crops.nbytes
    py, px = padShape
    nf = crops.shape[1]
    norms = np.empty(nT)
    fRelW = np.empty((nT, nf))
    for i, tileName in enumerate(names):
        shape = st[tileName][1]["shape"]
        y0c = int(np.clip(shape[0] // 2 - 16, 0, py - 33))
        x0c = int(np.clip(shape[1] // 2 - 16, 0, px - 33))
        summed = crops[i].sum(axis=0)
        cropPeak = summed[shape[0] // 2 - y0c, shape[1] // 2 - x0c]
        if not np.isclose(cropPeak, stepPeaks[i], rtol=1e-3):
            raise RuntimeError(
                "calibration crop is inconsistent with the step's "
                "in-graph peak read for tile %s (%.6e vs %.6e): the "
                "compiled step returned a corrupted intermediate - "
                "see the XLA-miscompile note in distribute.py one_tile"
                % (tileName, cropPeak, stepPeaks[i]))
        ys = np.arange(y0c, y0c + 33)
        xs = np.arange(x0c, x0c + 33)
        cy, cx = shape[0] / 2.0, shape[1] / 2.0
        spl = sinterp.RectBivariateSpline(ys, xs, summed, kx=3, ky=3)
        peak = float(spl(cy, cx)[0][0])
        norms[i] = 1.0 / peak
        for f in range(nf):
            fspl = sinterp.RectBivariateSpline(ys, xs, crops[i][f],
                                               kx=3, ky=3)
            fRelW[i, f] = float(fspl(cy, cx)[0][0]) / peak
    return norms, fRelW


def _saveFilterCaches(st, names, nT, out, tPhase, hostNorms, fRelW,
                      deviceCache=False):
    """Write the filter cache FITS (host ``MapFilter.saveFilter`` format:
    SIGNORM + RW fRel-weight headers) from the sharded step's
    ``return_filter`` outputs - fitQ and getFRelWeights read these.
    ``fRelW`` comes from the host's sub-pixel per-plane crop reads
    (:func:`_calibNormsFromCrops`).

    The FITS writes go through the background writer (the ~10 MB/tile
    downloads overlap later chunks' compute instead of blocking the
    link), and with ``deviceCache=True`` (the reference/photometry
    filter) the device-side filter arrays are parked in the
    DEVICE_CACHE so fitQ's per-tile reloads never touch the link."""
    import time as _time
    from . import filtercache
    from ..utils import fits as nfits

    t0 = _time.time()
    for i, tileName in enumerate(names):
        filterObj, stacks = st[tileName]
        header = nfits.Header()
        # host convention: signalNorm includes the output-units scale
        signalNorm = float(hostNorms[i] * stacks["unitsScale"])
        header["SIGNORM"] = signalNorm
        fRelWeights = {}
        for count, m in enumerate(filterObj.unfilteredMapsDictList,
                                  start=1):
            header["RW%d_GHZ" % count] = m["obsFreqGHz"]
            header["RW%d" % count] = float(fRelW[i, count - 1])
            fRelWeights[m["obsFreqGHz"]] = float(fRelW[i, count - 1])
        # jnp slice: the per-tile filter becomes its own device buffer,
        # so the chunk's full stacked output can be freed
        filtDev = out["filt"][i]
        cached = False
        if deviceCache:
            cached = filtercache.DEVICE_CACHE.put(filterObj.filterFileName,
                                                  filtDev, signalNorm,
                                                  fRelWeights)
        if cached:
            # Device-resident: defer the ~10 MB cache-FITS download to
            # on-demand / exit (filtercache._DEFERRED) - the eager
            # background writes were ~2.5 GB of link traffic competing
            # with the survey's own chunks at DR5 scale.
            filtercache.register_deferred(filterObj.filterFileName,
                                          filtDev, header)
        else:
            filtercache.WRITER.enqueue(filterObj.filterFileName, filtDev,
                                       header)
    tPhase["download"] += _time.time() - t0


def _emit_overflow_fallback(config, out, i, filterObj, shape, scale,
                            tileMask, cellsI, padShape, gridSize, saveRMS,
                            photRes, label, photLabel, tPhase):
    """Host-style result for a tile whose segment count exceeded the
    device detection budget: the calibrated signal and S/N maps come off
    the device (they are resident step outputs in detect mode, pixel
    window already undone in-step) and the pipeline's host ``findObjects``
    - which has no object cap - takes over for this tile.  The reference
    filter's maps ride along for the fixed_ photometry columns."""
    import time as _time
    from ..utils import fits as nfits

    t0 = _time.time()
    fullF = np.asarray(out["filtered"][i])[:shape[0], :shape[1]]
    fullSN = np.asarray(out["SNMap"][i])[:shape[0], :shape[1]]
    tPhase["download"] += _time.time() - t0
    # The cell grid is laid out on the tile's TRUE shape (cell_meta);
    # slice off the unused padded slots and expand at the true shape.
    nCyT = noise_ops.n_cells(shape[0], gridSize)
    nCxT = noise_ops.n_cells(shape[1], gridSize)
    rms = noise_ops.assemble_rms_host(cellsI[:nCyT, :nCxT], shape[0],
                                      shape[1], gridSize) \
        * tileMask * scale
    if filterObj.params["outputUnits"] == "yc":
        unitsMeta = {"mapUnits": "yc", "obsFreqGHz": "yc",
                     "beamSolidAngle_nsr": 0.0}
    else:
        obsFreqGHz = float(list(filterObj.beamSolidAnglesDict)[0])
        unitsMeta = {"mapUnits": "uK", "obsFreqGHz": obsFreqGHz,
                     "beamSolidAngle_nsr":
                         filterObj.beamSolidAnglesDict[obsFreqGHz]}
    res = dict({"data": fullF * scale, "SNMap": fullSN,
                "RMSMap": rms if saveRMS else None,
                "surveyMask": tileMask, "flagMask": filterObj.flagMask,
                "wcs": filterObj.wcs, "label": filterObj.label,
                "tileName": filterObj.tileName}, **unitsMeta)
    if photRes is not None and label != photLabel:
        # fixed_ columns need the reference filter's maps on host too
        t0 = _time.time()
        pSN = np.asarray(photRes["SNMap"][i])[:shape[0], :shape[1]]
        pD = np.asarray(photRes["filtered"][i])[:shape[0], :shape[1]] \
            * photRes["scale"][i]
        tPhase["download"] += _time.time() - t0
        res["photMapsDict"] = {"SNMap": pSN, "data": pD}
    elif photRes is None and photLabel is not None \
            and label != photLabel:
        # The reference filter landed in a DIFFERENT shape bucket (its
        # noiseGridArcmin/edgeTrimArcmin differ), so its device maps are
        # not resident here.  Without them the fixed_ photometry columns
        # for this tile's objects cannot be measured from this result -
        # downstream fills them with the sentinel.  Shout: silent -99
        # fixed_y_c rows get dropped by nemoMass.
        print("... WARNING: overflow tile %s#%s has no reference-filter "
              "maps in its device bucket (photFilter uses different "
              "noise-grid/trim parameters); fixed_ columns for its "
              "objects will be missing" % (label, filterObj.tileName))
    if saveRMS:
        RMSFileName = os.path.join(
            config.selFnDir, filterObj.tileName,
            "RMSMap_%s#%s.fits" % (filterObj.label, filterObj.tileName))
        os.makedirs(os.path.dirname(RMSFileName), exist_ok=True)
        nfits.write_image(RMSFileName, rms, filterObj.wcs.header,
                          compressionType="RICE_1")
    return res


def _emit_detect_results(config, st, names, nT, out, padShape, gridSize,
                         detectParams, label, photLabel, photRes,
                         seenTiles, tPhase, results, consume, hostNorms,
                         trimPix=0):
    """Assemble per-tile results in device-detection mode: only O(K)
    statistics, the per-object sub-pixel spline/nearest reads (scalars,
    computed on-device by ops/detect.spline_values) and the tiny RMS
    cell grid cross the link; the full maps stay resident on the
    devices."""
    _consume_detect_results(
        config, st, names, nT,
        _dispatch_detect_downloads(out, photRes, label, photLabel,
                                   detectParams, nT),
        padShape, gridSize, detectParams, label, photLabel, photRes,
        seenTiles, tPhase, results, consume, hostNorms,
        trimPix=trimPix, out=out)


_DET_KEYS = ("valid", "numPix", "comY", "comX", "peak", "peakY", "peakX")


def _dispatch_detect_downloads(out, photRes, label, photLabel,
                               detectParams, nT, co=None,
                               wantMask=False):
    """Pack one label's detect-mode results into a few small device
    arrays and START their host copies.  Per-request latency adds up:
    packing ships the
    per-object statistics in ONE request each, and registering them in
    the chunk's :class:`_CopyBatch` (``co``) coalesces ALL labels'
    results into one transfer per array kind.

    ``wantMask`` additionally registers the label's bit-packed output
    survey mask: with edge trim active the mask is a data-dependent
    step output, and shipping it with the chunk's coalesced batch is
    what lets edge-trimmed banks (trimPix != 0 - the reference's
    DEFAULT, 3 x the noise grid) ride the pipelined path instead of
    the ~100-blocking-round-trips-per-chunk sync path (the r3d DR5
    record lost ~25 s/chunk to exactly that)."""
    from .distribute import subpixel_read_batch

    threshold, maxObjects, nIter, useCom, cutWindow = detectParams
    det = out["det"]
    ysDev = det["comY"] if useCom else det["peakY"]
    xsDev = det["comX"] if useCom else det["peakX"]
    photSub = None
    if photRes is not None and label != photLabel:
        photSub = subpixel_read_batch(photRes["SNMap"],
                                      photRes["filtered"],
                                      ysDev, xsDev, window=cutWindow)
    # Sub-pixel (S/N, value) reads in the map dtype: [ownSpline(2),
    # ownNearest(2)[, photSpline(2), photNearest(2)]]
    valParts = [out["subSpline"], out["subNearest"]]
    if photSub is not None:
        valParts += [photSub[0], photSub[1]]
    send = co.add if co is not None else start_host_copy
    nObjectsDev = det["nObjects"][:nT]
    down = {
        "packed": send(jnp.stack(
            [det[k].astype(jnp.float32) for k in _DET_KEYS],
            axis=-1)[:nT]),
        "nObjects": send(nObjectsDev),
        "vals": send(jnp.concatenate(valParts, axis=-1)[:nT]),
        "cells": send(out["RMSCells"][:nT]),
        "hasPhotSub": photSub is not None,
        # raw device handle for enqueue-depth bounding (block_until_ready)
        "lagArr": nObjectsDev,
    }
    if wantMask:
        down["maskPacked"] = send(_packbits_jit(out["surveyMask"])[:nT])
    return down


def _consume_detect_results(config, st, names, nT, down, padShape,
                            gridSize, detectParams, label, photLabel,
                            photRes, seenTiles, tPhase, results, consume,
                            hostNorms, trimPix=0, out=None, rerun=None,
                            co=None):
    """Host side of detect-mode emission: read the (already streaming)
    packed downloads and assemble per-tile results.  ``out`` carries the
    resident step outputs when the caller still holds them (sync path /
    edge-trim masks); a freed-output pipelined label passes ``rerun``
    instead, which re-executes the step only if a tile overflows the
    device object budget."""
    import time as _time

    threshold, maxObjects, nIter, useCom, cutWindow = detectParams
    t0 = _time.time()
    read = co.get if co is not None else np.asarray
    packed = np.asarray(read(down["packed"]))
    detNp = {k: packed[..., j] for j, k in enumerate(_DET_KEYS)}
    detNp["nObjects"] = np.asarray(read(down["nObjects"]))
    vals = np.asarray(read(down["vals"]))
    cells = np.asarray(read(down["cells"]))
    photSub = down["hasPhotSub"] or None
    # With edge trim active the output mask is data-dependent; download
    # every needed tile's mask in ONE request instead of per tile -
    # bit-packed on device (masks are binary), 8x fewer bytes than the
    # uint8 layout
    maskAll = None
    maskBytes = 0
    if trimPix != 0:
        needMask = [i for i, n in enumerate(names)
                    if int(detNp["nObjects"][i]) > maxObjects
                    or n not in seenTiles
                    or st[names[0]][0].params.get("saveRMSMap")]
        if needMask:
            t1 = _time.time()
            px = padShape[1]
            if "maskPacked" in down:
                # pipelined: the bit-packed mask rode the chunk's
                # coalesced batch
                maskPacked = np.asarray(read(down["maskPacked"]))
            else:
                if out is None:
                    out = rerun()
                maskPacked = np.asarray(
                    _packbits_jit(out["surveyMask"])[:nT])
            maskAll = np.unpackbits(maskPacked, axis=-1, count=px)
            maskBytes = maskPacked.nbytes
            tPhase["download"] += _time.time() - t1
    tPhase["download"] += _time.time() - t0
    tPhase["downBytes"] = tPhase.get("downBytes", 0) + packed.nbytes \
        + vals.nbytes + cells.nbytes + maskBytes

    saveRMS = st[names[0]][0].params.get("saveRMSMap")
    for i, tileName in enumerate(names):
        filterObj, stacks = st[tileName]
        shape = stacks["shape"]
        scale = stacks["unitsScale"] * hostNorms[i]
        nObj = int(detNp["nObjects"][i])
        overflow = nObj > maxObjects
        tileMask = None
        if overflow or tileName not in seenTiles or saveRMS:
            # One mask per tile (first label wins, as in the accumulate
            # path's areaMask writes); also needed to zero the excluded
            # area in a saved RMS map (getRMSTab reads zeros as "outside
            # the survey").  With no edge trim the step's output mask is
            # surveyMask * psMask * (apodM == 1) of arrays the host
            # already staged - rebuild it for free instead of pulling
            # ~10 MB/tile from the device (distribute.py: edgeCheck
            # is all-ones when trimPix == 0).
            if trimPix == 0:
                common = stacks["common"]
                tileMask = (np.asarray(common["surveyMask"])
                            * np.asarray(common["psMask"])
                            * (np.asarray(common["apodM"]) == 1)
                            ).astype(float)
            else:
                tileMask = maskAll[i][:shape[0],
                                      :shape[1]].astype(float)
            seenTiles.add(tileName)
        if overflow:
            # Crowded tile: more segments than the device object budget.
            # Fall back to HOST detection for this tile (reference
            # findObjects has no object cap, nemo/photometry.py:25-190):
            # download its maps and emit a host-style result - never a
            # silently truncated catalog.  The sync path still holds the
            # step outputs (``out``); a pipelined label freed them and
            # re-executes its step once (compile is cached) via ``rerun``.
            print("... %d objects in %s#%s exceed the device detection "
                  "budget (%d): falling back to host detection for this "
                  "tile" % (nObj, label, tileName, maxObjects))
            if out is None:
                out = rerun()
            res = _emit_overflow_fallback(
                config, out, i, filterObj, shape, scale, tileMask,
                cells[i], padShape, gridSize, saveRMS, photRes, label,
                photLabel, tPhase)
            results[label][tileName] = res
            if consume is not None:
                if consume(label, tileName, res):
                    results[label].pop(tileName, None)
            continue
        # Sub-pixel reads to output units: the spline/nearest reads are
        # linear in the map, so the host-side units scale commutes with
        # the on-device evaluation.  Columns: (S/N, value).
        subVals = {"spline": np.array(vals[i, :, 0:2], dtype=np.float64),
                   "nearest": np.array(vals[i, :, 2:4], dtype=np.float64)}
        subVals["spline"][:, 1] *= scale
        subVals["nearest"][:, 1] *= scale
        res = {
            "deviceDetections": {k: detNp[k][i] for k in
                                 ("valid", "numPix", "comY", "comX",
                                  "peak", "peakY", "peakX")},
            "subVals": subVals,
            "wcs": filterObj.wcs, "label": filterObj.label,
            "tileName": tileName, "flagMask": filterObj.flagMask,
            "surveyMask": tileMask,
            "signalNorm": float(hostNorms[i]),
        }
        if photSub is not None:
            pv = {"spline": np.array(vals[i, :, 4:6], dtype=np.float64),
                  "nearest": np.array(vals[i, :, 6:8], dtype=np.float64)}
            pv["spline"][:, 1] *= photRes["scale"][i]
            pv["nearest"][:, 1] *= photRes["scale"][i]
            res["photSubVals"] = pv
        elif label == photLabel:
            # the phot filter reads fixed_ values from its own maps
            res["photSubVals"] = subVals
        if filterObj.params["outputUnits"] == "yc":
            res["mapUnits"], res["obsFreqGHz"] = "yc", "yc"
            res["beamSolidAngle_nsr"] = 0.0
        else:
            obsFreqGHz = float(list(filterObj.beamSolidAnglesDict)[0])
            res["mapUnits"] = "uK"
            res["obsFreqGHz"] = obsFreqGHz
            res["beamSolidAngle_nsr"] = \
                filterObj.beamSolidAnglesDict[obsFreqGHz]
        if saveRMS:
            nCyT = noise_ops.n_cells(shape[0], gridSize)
            nCxT = noise_ops.n_cells(shape[1], gridSize)
            rms = noise_ops.assemble_rms_host(
                cells[i][:nCyT, :nCxT], shape[0], shape[1], gridSize) \
                * tileMask * scale
            import os
            from ..utils import fits as nfits
            RMSFileName = os.path.join(
                config.selFnDir, tileName,
                "RMSMap_%s#%s.fits" % (filterObj.label, tileName))
            os.makedirs(os.path.dirname(RMSFileName), exist_ok=True)
            nfits.write_image(RMSFileName, rms, filterObj.wcs.header,
                              compressionType="RICE_1")
        results[label][tileName] = res
        if consume is not None:
            if consume(label, tileName, res):
                results[label].pop(tileName, None)


def _stage_bucket_uploads(staged, labels, names, padShape, mesh, nDev,
                          padTo=None, gridSize=None):
    """Snapshot one tile chunk's staged state and DISPATCH its big device
    uploads (data, masks, apodisation) without blocking on them.

    ``jax.device_put`` is asynchronous: the transfers stream over the
    (slow) host-device link while the PREVIOUS chunk is still being
    processed - the caller defers processing by one chunk
    (``batchFilterTilesMulti._flush_mf``), hiding most of the per-chunk
    upload wall-clock behind the previous chunk's compute + downloads.
    The snapshot owns the chunk's (filterObj, stacks) references, so the
    caller can drop them from the live staging dict immediately and keep
    peak host memory at ~two chunks.

    ``padTo`` pads partial chunks up to the full chunk size by
    replicating the last tile (every step output is sliced back to the
    true tile count): the tail chunk of each shape bucket then reuses
    the step already compiled for the full chunks instead of paying a
    fresh 30-90 s XLA compile for its one-off batch size.
    """
    import time as _time

    t0 = _time.time()
    nT = len(names)
    pad = padTo - nT if padTo and padTo > nT else (-nT) % nDev
    rep = ([1] * (nT - 1)) + [1 + pad] if pad else None

    # Without x64 the compute dtype is float32 regardless, so ship float32
    # to the device instead of letting the runtime truncate float64 bytes
    # on arrival - halves upload volume.  With x64 (the CPU parity runs)
    # keep float64: the batched-vs-host parity there is exact.
    upDtype = None if jax.config.jax_enable_x64 else np.float32

    def _stackPad(arrs):
        out = np.stack([_pad2(a, padShape) for a in arrs])
        if upDtype is not None and out.dtype == np.float64:
            out = out.astype(upDtype)
        return np.repeat(out, rep, axis=0) if rep else out

    sh = tile_sharding(mesh)

    def _put(arrs):
        return jax.device_put(jnp.asarray(_stackPad(arrs)), sh)

    def _putDedup(arrs):
        """Upload only the distinct arrays of a tile-stacked input (by
        object identity - the staging caches return shared ndarrays for
        same-geometry tiles), then gather the full stack on device.
        Survey tiles repeat templates across declination bands, so this
        ships each distinct template once per chunk instead of once per
        tile.  Device-resident inputs (the template caches) never touch
        the link at all: they are padded/stacked/gathered in place."""
        seen, idx = {}, []
        for a in arrs:
            k = id(a)
            if k not in seen:
                seen[k] = len(seen)
            idx.append(seen[k])
        uniq = [None] * len(seen)
        for a in arrs:
            uniq[seen[id(a)]] = a
        onDevice = any(isinstance(a, jax.Array) for a in uniq)
        if not onDevice and len(seen) == len(arrs):
            return _put(arrs)
        if onDevice:
            padded = [jnp.pad(jnp.asarray(a),
                              [(0, 0)] * (a.ndim - 2)
                              + [(0, padShape[0] - a.shape[-2]),
                                 (0, padShape[1] - a.shape[-1])])
                      if a.shape[-2:] != tuple(padShape) else jnp.asarray(a)
                      for a in uniq]
            uniqDev = jnp.stack(padded)
            if upDtype is not None and uniqDev.dtype == jnp.float64:
                uniqDev = uniqDev.astype(upDtype)
        else:
            uniqStack = np.stack([_pad2(a, padShape) for a in uniq])
            if upDtype is not None and uniqStack.dtype == np.float64:
                uniqStack = uniqStack.astype(upDtype)
            uniqDev = jax.device_put(jnp.asarray(uniqStack))
        idxA = np.asarray(idx, dtype=np.int32)
        if rep:
            idxA = np.repeat(idxA, rep, axis=0)
        full = jnp.take(uniqDev, jnp.asarray(idxA), axis=0)
        return jax.device_put(full, sh)

    def _putRaw(arrs):
        """Stack same-shape per-tile arrays (no padding - e.g. cached
        half-grid filters already live at the bucket padShape) with
        identity dedup, cast to the device compute dtype, and shard."""
        computeDtype = jnp.zeros((), dtype=float).dtype
        seen, idx = {}, []
        for a in arrs:
            k = id(a)
            if k not in seen:
                seen[k] = len(seen)
            idx.append(seen[k])
        uniq = [None] * len(seen)
        for a in arrs:
            uniq[seen[id(a)]] = a
        uniqDev = jnp.stack([jnp.asarray(a, dtype=computeDtype)
                             for a in uniq])
        idxA = np.asarray(idx, dtype=np.int32)
        if rep:
            idxA = np.repeat(idxA, rep, axis=0)
        return jax.device_put(jnp.take(uniqDev, jnp.asarray(idxA),
                                       axis=0), sh)

    def _putMask(arrs, shapes):
        """Binary-mask upload; an all-ones mask (no point-source mask is
        configured in many runs) is SYNTHESISED on device - ones over
        the true tile shape, zeros in the bucket padding - instead of
        shipping ~10 MB/chunk of ones."""
        arrs = [_asBinaryMask(a) for a in arrs]
        if not all(a.dtype == np.uint8 and a.min() == 1 for a in arrs):
            return _put(arrs)
        sy = np.array([sh_[0] for sh_ in shapes], dtype=np.int32)
        sx = np.array([sh_[1] for sh_ in shapes], dtype=np.int32)
        if rep:
            sy = np.repeat(sy, rep, axis=0)
            sx = np.repeat(sx, rep, axis=0)
        yy = jnp.arange(padShape[0], dtype=jnp.int32)
        xx = jnp.arange(padShape[1], dtype=jnp.int32)
        m = ((yy[None, :, None] < jnp.asarray(sy)[:, None, None])
             & (xx[None, None, :] < jnp.asarray(sx)[:, None, None]))
        return jax.device_put(m.astype(jnp.uint8), sh)

    snapshot = {label: {n: staged[label][n] for n in names
                        if n in staged[label]} for label in labels}
    common = [snapshot[labels[0]][n][1]["common"] for n in names]
    ctx = {"labels": labels, "names": names, "padShape": padShape,
           "snapshot": snapshot, "rep": rep, "pad": pad, "nT": nT,
           "put": _put, "putDedup": _putDedup, "putRaw": _putRaw,
           "dataDev": _put([c["data"] for c in common]),
           "apodDev": _putDedup([c["apodM"] for c in common]),
           "psDev": _putMask([c["psMask"] for c in common],
                             [c["shape"] for c in common]),
           "surveyDev": _putMask([c["surveyMask"] for c in common],
                                 [c["shape"] for c in common])}
    peakYX = np.array([[c["shape"][0] // 2, c["shape"][1] // 2]
                       for c in common], dtype=np.int32)
    if rep:
        peakYX = np.repeat(peakYX, rep, axis=0)
    ctx["peakDev"] = jax.device_put(jnp.asarray(peakYX), sh)
    if gridSize is not None:
        # Per-tile TRUE-shape noise-cell geometry (noise_ops.cell_meta):
        # the step's RMS estimation then matches the host engine exactly
        # instead of laying the grid out on the padded shape.  Tiny int
        # arrays - a few KB per chunk.
        meta = noise_ops.cell_meta_batch([c["shape"] for c in common],
                                         padShape, gridSize)
        metaDev = {}
        for k, arr in meta.items():
            if rep:
                arr = np.repeat(arr, rep, axis=0)
            metaDev[k] = jax.device_put(jnp.asarray(arr), sh)
        ctx["metaDev"] = metaDev
    ctx["sh"] = sh
    ctx["upDtype"] = upDtype
    ctx["stageDispatch"] = _time.time() - t0
    return ctx


def _finish_label(config, st, names, nT, out, padShape, gridSize,
                  trimPix, detectParams, label, photLabel, photRes,
                  seenTiles, tPhase, results, consume, hostNorms,
                  useDetect, saveRMS, undoPixelWindow):
    """Post-step per-label emission, shared by the build and
    cached-filter (given_filter) paths: device detection results or the
    lean filtered/cells/mask downloads + host SN assembly."""
    import time as _time

    if useDetect:
        tPhase["detectLabels"] += 1
        _emit_detect_results(
            config, st, names, nT, out, padShape, gridSize,
            detectParams, label, photLabel, photRes, seenTiles,
            tPhase, results, consume, hostNorms, trimPix=trimPix)
        return

    t0 = _time.time()
    # slice on device first: chunk padding (padTo) must not inflate the
    # full-map downloads
    filtered = np.asarray(out["filtered"][:nT])
    cells = np.asarray(out["RMSCells"][:nT])
    outMask = np.asarray(out["surveyMask"][:nT])
    tPhase["download"] += _time.time() - t0
    tPhase["downBytes"] = tPhase.get("downBytes", 0) + filtered.nbytes + cells.nbytes + outMask.nbytes

    for i, tileName in enumerate(names):
        filterObj, stacks = st[tileName]
        shape = stacks["shape"]
        scale = stacks["unitsScale"] * hostNorms[i]
        # Expand the cell grid at the tile's TRUE shape - the layout the
        # device estimated it on (cell_meta) and the host engine's own
        # geometry (filters.py:417-422).
        nCyT = noise_ops.n_cells(shape[0], gridSize)
        nCxT = noise_ops.n_cells(shape[1], gridSize)
        rms = noise_ops.assemble_rms_host(
            cells[i][:nCyT, :nCxT], shape[0], shape[1], gridSize)
        tileMask = outMask[i][:shape[0], :shape[1]].astype(float)
        filt = filtered[i][:shape[0], :shape[1]]
        with np.errstate(divide="ignore", invalid="ignore"):
            SNMap = np.where(rms > 0,
                             filt / np.maximum(rms, 1e-30), 0.0) \
                * tileMask
        dataMap = filt * scale
        RMSMap = rms * tileMask * scale if saveRMS else None
        _emit_result(config, filterObj, tileName, dataMap, SNMap,
                     RMSMap, tileMask, undoPixelWindow,
                     results[label])
        if consume is not None:
            if consume(label, tileName, results[label][tileName]):
                results[label].pop(tileName, None)


# Trace-once observability: the CLI's --profile
# sets PROFILE_CHUNK_DIR; the first WARM chunk's device trace is then
# captured there (chunk 0 is compile-dominated and uninformative).
# Per-chunk link/device budgets append to diagnostics/chunk_budgets.jsonl
# on every survey run regardless, so perf regressions surface with
# evidence in the committed benchmark artifacts.
PROFILE_CHUNK_DIR = None
_PROFILE_CHUNK_INDEX = 1
_chunkCounter = [0]


def _process_bucket_shared(config, ctx, gridSize, trimPix, mesh, nDev,
                           rms_impl, undoPixelWindow, verbose, results,
                           consume=None, detectParams=None):
    idx = _chunkCounter[0]
    _chunkCounter[0] += 1
    if PROFILE_CHUNK_DIR and idx == _PROFILE_CHUNK_INDEX:
        from ..utils.timing import profile_trace
        with profile_trace(PROFILE_CHUNK_DIR):
            return _process_bucket_impl(
                config, ctx, gridSize, trimPix, mesh, nDev, rms_impl,
                undoPixelWindow, verbose, results, consume=consume,
                detectParams=detectParams, chunkIdx=idx)
    return _process_bucket_impl(
        config, ctx, gridSize, trimPix, mesh, nDev, rms_impl,
        undoPixelWindow, verbose, results, consume=consume,
        detectParams=detectParams, chunkIdx=idx)


def _process_bucket_impl(config, ctx, gridSize, trimPix, mesh, nDev,
                         rms_impl, undoPixelWindow, verbose, results,
                         consume=None, detectParams=None, chunkIdx=0):
    """Run one staged tile chunk through every filter scale.

    The big arrays were dispatched by :func:`_stage_bucket_uploads`
    (possibly a whole chunk ago); each filter scale runs against the
    resident device copies with only its signal/calibration templates
    crossing the wire.  At DR5 scale (16 scales) this cuts staged upload
    volume ~5x, and the one-chunk staging deferral overlaps the upload
    stream with the previous chunk's compute and downloads.
    """
    import time as _time
    _tChunkIn = _time.time()
    _cpuChunkIn = _time.process_time()

    labels = ctx["labels"]
    names = ctx["names"]
    padShape = ctx["padShape"]
    snapshot = ctx["snapshot"]
    nT = ctx["nT"]
    pad = ctx["pad"]
    rep = ctx["rep"]
    _put = ctx["put"]
    _putDedup = ctx["putDedup"]
    dataDev = ctx["dataDev"]
    apodDev = ctx["apodDev"]
    psDev = ctx["psDev"]
    surveyDev = ctx["surveyDev"]
    peakDev = ctx["peakDev"]
    sh = ctx["sh"]
    upDtype = ctx["upDtype"]
    if verbose:
        print("... device batch: %d tile(s) x %d filter(s) at %s"
              % (len(names), len(labels), str(padShape)), flush=True)
    tPhase = {"upload": ctx["stageDispatch"], "step": 0.0,
              "download": 0.0, "downBytes": 0.0, "detectLabels": 0}
    halfShape = (padShape[0], padShape[1] // 2 + 1)
    fgZerosDev = None

    photLabel = config.parDict.get("photFilter")
    photRes = None          # resident phot maps for fixed_ cutout gathers
    seenTiles = set()       # maskSN downloaded once per tile, not per label

    def _buildNoiseFg(stacksList):
        nonlocal fgZerosDev
        # noise stack: for dataMap/max(dataMap,CMB) it IS the data - reuse
        # the resident upload; 'model' noise uploads per filter
        if all(sk["noise"] is sk["data"] for sk in stacksList):
            noiseDev = dataDev
        else:
            noiseDev = _put([sk["noise"] for sk in stacksList])
        if all(sk["fgPower"] is None for sk in stacksList):
            # -inf, NOT 0: the step's maximum(prods, fg) must be an exact
            # no-op for dataMap/model noise - ~half the off-diagonal
            # covariance values are NEGATIVE (cross-band noise), and a
            # zero floor silently clipped them, skewing every 2-freq
            # filter by ~0.2% at peaks (reference applies the CMB floor
            # only for max(dataMap,CMB), nemo/filters.py:575-580).
            if fgZerosDev is None:
                nTot = nT + pad
                fgZerosDev = jax.device_put(
                    jnp.full((nTot,) + halfShape, -jnp.inf), sh)
            fgDev = fgZerosDev
        else:
            # fgPower already lives on the padded half grid - stack only
            fg = np.stack([sk["fgPower"] if sk["fgPower"] is not None
                           else np.full(halfShape, -np.inf)
                           for sk in stacksList])
            if upDtype is not None:
                fg = fg.astype(upDtype)
            if rep:
                fg = np.repeat(fg, rep, axis=0)
            fgDev = jax.device_put(jnp.asarray(fg), sh)
        return noiseDev, fgDev

    def _invokeStep(stepFn, stacksList, given):
        """Dispatch one label's step against the resident chunk uploads.
        Shared by the main label loop and the overflow ``rerun`` path
        (which rebuilds the per-label inputs from the host snapshot)."""
        if given:
            # Cached-filter rerun: APPLY the staged (device-resident or
            # disk-loaded) filters with the given-filter step - no
            # rebuild from (possibly injected) data, no calibration;
            # signalNorm comes from the cache headers.
            return stepFn(dataDev,
                          ctx["putRaw"]([sk["cachedFilt"]
                                         for sk in stacksList]),
                          apodDev, psDev, surveyDev, ctx["metaDev"])
        noiseDev, fgDev = _buildNoiseFg(stacksList)
        return stepFn(dataDev, noiseDev,
                      _putDedup([sk["template"] for sk in stacksList]),
                      _putDedup([sk["calib"] for sk in stacksList]),
                      jnp.asarray(stacksList[0]["w"]),
                      apodDev, psDev, surveyDev, fgDev, peakDev,
                      ctx["metaDev"])

    # Two passes over the labels.  Pass 1 dispatches every label's step
    # and registers its small detect-mode results in the chunk's
    # _CopyBatch; pass 2 stacks each result kind across labels on device
    # and consumes them through a handful of coalesced transfers.  The
    # per-request latencies are then paid once per array KIND instead of
    # once per label x array (~100 requests -> ~7).
    co = _CopyBatch()
    records = []
    maskDispatched = False      # masks are per-tile (first label wins)
    for label in labels:
        st = snapshot[label]
        stacksList = [st[n][1] for n in names]
        useDetect = detectParams is not None \
            and not st[names[0]][0].params.get("saveFilteredMaps")
        wantFilter = bool(st[names[0]][0].params.get("saveFilter"))
        cachedAll = all(sk.get("cachedFilt") is not None
                        for sk in stacksList)
        saveRMS = st[names[0]][0].params.get("saveRMSMap")
        # Every detect-mode label pipelines; with edge trim active
        # (trimPix != 0, the reference's DEFAULT) the data-dependent
        # output mask rides the coalesced batch bit-packed - the r3d
        # DR5 record ran its whole bank on the sync path because of
        # this condition (then `useDetect and trimPix == 0`), paying
        # ~25 s/chunk in per-label blocking round trips.
        pipelined = useDetect
        stepFn = make_sharded_matched_filter_step(
            mesh, gridSize, trimPix, rms_impl=rms_impl,
            lean_outputs=not useDetect,
            detect_params=detectParams if useDetect else None,
            given_filter=cachedAll,
            return_filter=wantFilter and not cachedAll)
        t0 = _time.time()
        out = _invokeStep(stepFn, stacksList, cachedAll)
        tPhase["step"] += _time.time() - t0
        hostNorms = fRelW = None
        if cachedAll:
            hostNorms = np.array([sk["cachedNorm"] / sk["unitsScale"]
                                  for sk in stacksList])
        if not pipelined:
            if hostNorms is None:
                hostNorms, fRelW = _calibNormsFromCrops(
                    out, st, names, nT, padShape, tPhase)
                if wantFilter:
                    _saveFilterCaches(st, names, nT, out, tPhase,
                                      hostNorms, fRelW,
                                      deviceCache=(label == photLabel))
            _finish_label(config, st, names, nT, out, padShape, gridSize,
                          trimPix, detectParams, label, photLabel,
                          photRes, seenTiles, tPhase, results, consume,
                          hostNorms, useDetect, saveRMS,
                          undoPixelWindow)
            if useDetect and label == photLabel:
                photRes = {"SNMap": out["SNMap"],
                           "filtered": out["filtered"],
                           "scale": stacksList[0]["unitsScale"]
                           * hostNorms}
            del out     # free this label's device outputs
            continue
        rec = {"label": label, "st": st, "stacksList": stacksList,
               "given": cachedAll, "wantFilter": wantFilter,
               "stepFn": stepFn, "hostNorms": hostNorms}
        if not cachedAll:
            rec["calib"] = _calibNormsDispatch(out, nT, co=co)
            if wantFilter:
                rec["filtDev"] = out["filt"]
        if label == photLabel:
            # resident phot maps for the other labels' fixed_ cutout
            # gathers; the units scale lands in the consume pass once
            # the calibration crops have arrived
            photRes = {"SNMap": out["SNMap"],
                       "filtered": out["filtered"], "scale": None}
            rec["isPhot"] = True
        wantMask = trimPix != 0 and (not maskDispatched or saveRMS)
        rec["down"] = _dispatch_detect_downloads(
            out, photRes, label, photLabel, detectParams, nT, co=co,
            wantMask=wantMask)
        maskDispatched = maskDispatched or wantMask
        del out     # big outputs free once the dispatched reductions run
        records.append(rec)
        lagDepth = int(config.parDict.get("detectLagDepth", 4))
        if len(records) >= lagDepth:
            # Bound enqueued-but-unexecuted device work (PJRT allocates
            # computation outputs at enqueue time): wait for the
            # lagDepth-back label's tiny nObjects result before
            # dispatching further.  Each in-flight label pins ~160 MB
            # of step outputs at DR5 chunk shapes; deeper lag keeps
            # more steps enqueued at the cost of lagDepth x that device
            # memory.  Timed as its own bucket: this wait absorbs the
            # chunk's REAL per-label device execution.
            t0 = _time.time()
            records[-lagDepth]["down"]["lagArr"].block_until_ready()
            tPhase["lagWait"] = tPhase.get("lagWait", 0.0) \
                + (_time.time() - t0)

    co.dispatch()
    # Attribution: wait for the chunk's DEVICE work here (readiness of
    # the stacked groups, no transfer) so the consume loop's blocking
    # reads measure pure transfer time, not the device's share.
    t0 = _time.time()
    co.block_until_ready()
    tPhase["device"] = _time.time() - t0
    for rec in records:
        label = rec["label"]
        st = rec["st"]
        stacksList = rec["stacksList"]
        hostNorms, fRelW = rec["hostNorms"], None
        if hostNorms is None:
            hostNorms, fRelW = _calibNormsConsume(
                rec["calib"], st, names, nT, padShape, tPhase, co=co)
            if rec["wantFilter"]:
                _saveFilterCaches(st, names, nT,
                                  {"filt": rec["filtDev"]}, tPhase,
                                  hostNorms, fRelW,
                                  deviceCache=(label == photLabel))
        if rec.get("isPhot"):
            photRes["scale"] = stacksList[0]["unitsScale"] * hostNorms

        def _rerun(stepFn=rec["stepFn"], sl=stacksList,
                   given=rec["given"]):
            return _invokeStep(stepFn, sl, given)

        tPhase["detectLabels"] += 1
        _consume_detect_results(
            config, st, names, nT, rec["down"], padShape, gridSize,
            detectParams, label, photLabel, photRes, seenTiles, tPhase,
            results, consume, hostNorms, trimPix=trimPix, rerun=_rerun,
            co=co)
    if verbose:
        print("    [chunk: upload %.1fs, dispatch+device %.1fs, "
              "device tail %.1fs, download %.1fs (%d req, %.0f MB), "
              "detect %d/%d labels]"
              % (tPhase["upload"], tPhase["step"],
                 tPhase.get("device", 0.0), tPhase["download"],
                 co.nRequests, tPhase["downBytes"] / 1e6,
                 tPhase["detectLabels"], len(labels)), flush=True)
    # Always-on per-chunk budget record (requests, bytes, seconds).
    try:
        if config.diagnosticsDir:
            import json as _json
            rec = {k: (round(v, 3) if isinstance(v, float) else v)
                   for k, v in tPhase.items()}
            # wall_s: this chunk's total processing wall; cpu_s: the
            # PROCESS CPU consumed meanwhile (all threads), so
            # wall_s - cpu_s - (upload+step+download idle) shows
            # whether unattributed time is host work (GIL contention
            # from the staging/writer threads) or waiting.
            rec.update({"t_wall": round(_time.time(), 2),
                        "wall_s": round(_time.time() - _tChunkIn, 3),
                        "cpu_s": round(
                            _time.process_time() - _cpuChunkIn, 3),
                        "chunk": chunkIdx, "nTiles": len(names),
                        "nLabels": len(labels),
                        "padShape": list(padShape),
                        "requests": co.nRequests,
                        "requestBytes": int(co.nBytes)})
            os.makedirs(config.diagnosticsDir, exist_ok=True)
            with open(os.path.join(config.diagnosticsDir,
                                   "chunk_budgets.jsonl"), "a") as f:
                f.write(_json.dumps(rec) + "\n")
    except Exception:
        pass
