"""Object detection and photometry.

Rebuild of ``nemo/photometry.py``.  Detection operates on the
signal-to-noise maps produced by the filter engine; segmentation and
centre-of-mass run on the host (the thresholded maps are sparse - the
device produces the SN maps, detection cost is negligible), with flux /
SNR reads via the same cubic-spline sub-pixel interpolation as the
reference (``photometry.py:76-79``).
"""

import numpy as np
from scipy import ndimage

from . import catalogs
from .models import sz
from .ops import interp


def getObjectPositions(mapData, threshold, findCenterOfMass=True):
    """Segment a map above ``threshold`` (``photometry.py:193-222``).

    Returns (objIDs, objPositions, objNumPix, segmentationMap).
    """
    if threshold < 0:
        raise ValueError("Detection threshold cannot be negative unless in "
                         "forced photometry mode.")
    sigPix = (mapData > threshold).astype(int)
    segmentationMap, numObjects = ndimage.label(sigPix)
    objIDs = np.unique(segmentationMap)
    if findCenterOfMass:
        objPositions = ndimage.center_of_mass(mapData,
                                              labels=segmentationMap,
                                              index=objIDs)
    else:
        objPositions = ndimage.maximum_position(mapData,
                                                labels=segmentationMap,
                                                index=objIDs)
    objNumPix = ndimage.sum(sigPix > 0, labels=segmentationMap, index=objIDs)
    return objIDs, objPositions, objNumPix, segmentationMap


def findObjects(filteredMapDict, threshold=3.0, minObjPix=3, rejectBorder=10,
                findCenterOfMass=True, removeRings=True, ringThresholdSigma=0,
                invertMap=False, objIdent="ACT-CL", longNames=False,
                verbose=True, useInterpolator=True, measureShapes=False,
                DS9RegionsPath=None):
    """Find objects in a filtered map's SN map (``photometry.py:25-190``).

    Returns a catalog Table (possibly empty list).
    """
    if rejectBorder is None:
        rejectBorder = 0
    data = filteredMapDict["SNMap"]
    areaMask = filteredMapDict["surveyMask"]
    wcs = filteredMapDict["wcs"]
    flagMask = filteredMapDict["flagMask"]

    if invertMap:
        data = data * -1

    objIDs, objPositions, objNumPix, segMap = getObjectPositions(
        data, threshold, findCenterOfMass=findCenterOfMass)

    # Ring detection around very bright sources (photometry.py:60-73)
    ringMask = None
    if removeRings:
        minRingPix = 30
        ringIDs, ringPositions, ringNumPix, ringSegMap = getObjectPositions(
            data, ringThresholdSigma, findCenterOfMass=True)
        ringSegMap = np.array(ringSegMap)
        for i in range(len(ringIDs)):
            if not np.isscalar(ringNumPix) and ringNumPix[i] > minRingPix:
                y, x = ringPositions[i]
                if ringSegMap[int(y), int(x)] != ringIDs[i]:
                    sel = ringSegMap == ringIDs[i]
                    ringSegMap[sel] = -ringSegMap[sel]
        ringMask = (ringSegMap < 0).astype(int)

    # Border rejection box (photometry.py:82-95)
    areaMask = np.asarray(areaMask)
    if areaMask.sum() > 0:
        ys, xs = np.where(areaMask > 0)
        minX, maxX = xs.min(), xs.max()
        minY, maxY = ys.min(), ys.max()
    else:
        minY, maxY = 0, segMap.shape[0] - 1
        minX, maxX = 0, segMap.shape[1] - 1
    minX += rejectBorder
    maxX -= rejectBorder
    minY += rejectBorder
    maxY -= rejectBorder

    catalog = []
    idNumCount = 1
    # Batched sub-pixel SNR reads
    keepIdx = [i for i in range(len(objIDs))
               if not np.isscalar(objNumPix) and objNumPix[i] > minObjPix]
    ys_ = np.array([objPositions[i][0] for i in keepIdx])
    xs_ = np.array([objPositions[i][1] for i in keepIdx])
    if useInterpolator and len(keepIdx) > 0:
        snrs = interp.subpixel_values(data, ys_, xs_)
    else:
        snrs = np.array([data[int(round(y)), int(round(x))]
                         for y, x in zip(ys_, xs_)])

    for j, i in enumerate(keepIdx):
        objDict = {}
        objDict["id"] = idNumCount
        objDict["x"] = objPositions[i][1]
        objDict["y"] = objPositions[i][0]
        idNumCount += 1
        if ringMask is not None and \
                ringMask[int(objDict["y"]), int(objDict["x"])] > 0:
            continue
        ra, dec = wcs.pix2wcs(objDict["x"], objDict["y"])
        if ra < 0:
            ra = 360 + ra
        objDict["RADeg"], objDict["decDeg"] = ra, dec
        objDict["galacticLatDeg"] = catalogs.galacticLatDeg(ra, dec)
        if longNames:
            objDict["name"] = catalogs.makeLongName(ra, dec, prefix=objIdent)
        else:
            objDict["name"] = catalogs.makeName(ra, dec, prefix=objIdent)
        objDict["numSigPix"] = objNumPix[i]
        objDict["template"] = filteredMapDict["label"]
        objDict["tileName"] = filteredMapDict["tileName"]
        objDict["SNR"] = snrs[j]
        objDict["flags"] = int(flagMask[int(round(objDict["y"])),
                                        int(round(objDict["x"]))])
        if measureShapes:
            objDict.update(_measureShape(data, segMap, objIDs[i],
                                         objNumPix[i]))
        if objDict["SNR"] > threshold:
            catalog.append(objDict)

    if len(catalog) > 0:
        catalog = catalogs.catalogListToTab(catalog)
        if DS9RegionsPath is not None:
            catalogs.catalog2DS9(catalog, DS9RegionsPath)
    return catalog


def _measureShape(data, segMap, objID, numSigPix):
    """SExtractor-style moment shapes (``photometry.py:127-178``)."""
    out = {k: -99.0 for k in ("ellipse_PA", "ellipse_A", "ellipse_B",
                              "ellipse_x0", "ellipse_y0", "ellipse_e")}
    if numSigPix <= 9:
        return out
    mask = segMap == objID
    ys, xs = np.where(mask)
    yMin, xMin = ys.min(), xs.min()
    xs_ = xs - xMin
    ys_ = ys - yMin
    w = data[mask]
    tot = w.sum()
    cx2 = (xs_ * w).sum() / tot
    cy2 = (ys_ * w).sum() / tot
    x2 = ((xs_ ** 2) * w).sum() / tot - cx2 ** 2
    y2 = ((ys_ ** 2) * w).sum() / tot - cy2 ** 2
    xy = ((xs_ * ys_) * w).sum() / tot - cx2 * cy2
    if x2 == y2:
        return out
    theta = np.degrees(np.arctan(2 * (xy / (x2 - y2))) / 2.0)
    if xy > 0 and theta < 0:
        theta += 90
    elif xy < 0 and theta > 0:
        theta -= 90
    ok = (theta > 0 and xy > 0) or (theta < 0 and xy < 0)
    if not ok:
        return out
    disc = np.sqrt(((x2 - y2) / 2) ** 2 + xy ** 2)
    A = np.sqrt(max((x2 + y2) / 2.0 + disc, 0))
    B = np.sqrt(max((x2 + y2) / 2.0 - disc, 0))
    if A == 0 or B == 0:
        return out
    segArea = float(np.count_nonzero(mask))
    scale = np.sqrt(segArea / (A * B * np.pi))
    A *= scale
    B *= scale
    out.update({"ellipse_PA": theta, "ellipse_A": A, "ellipse_B": B,
                "ellipse_x0": cx2 + xMin, "ellipse_y0": cy2 + yMin,
                "ellipse_e": np.sqrt(1 - B ** 2 / A ** 2)})
    return out


def _cutoutSpline(cutout, y0, x0, y, x, useInterpolator):
    """Value at float (y, x) from a spline-window cutout anchored at
    (y0, x0) - bit-identical to ``interp.subpixel_values`` on the full
    map when the anchors agree (ops/detect.py gather_cutouts)."""
    if not useInterpolator:
        P = cutout.shape[-1]
        return float(cutout[int(np.clip(round(y) - y0, 0, P - 1)),
                            int(np.clip(round(x) - x0, 0, P - 1))])
    from scipy import interpolate as sinterp
    P = cutout.shape[-1]
    spl = sinterp.RectBivariateSpline(
        np.arange(y0, y0 + P), np.arange(x0, x0 + P), cutout, kx=3, ky=3)
    return float(spl(y, x)[0][0])


def catalogFromDeviceDetections(filteredMapDict, threshold=3.0, minObjPix=3,
                                findCenterOfMass=True, objIdent="ACT-CL",
                                longNames=False, useInterpolator=True,
                                ycObsFreqGHz=148.0, DS9RegionsPath=None):
    """Build the detection + flux catalog from on-device detection
    products (``ops/detect.py`` via the batched engine's device-detect
    mode) - the device equivalent of ``findObjects`` +
    ``measureFluxes``, with only per-object statistics and spline-window
    cutouts ever leaving the device.

    ``filteredMapDict`` carries: deviceDetections (valid/numPix/com/peak
    arrays), subVals {"spline", "nearest"} (K, 2) on-device sub-pixel
    (S/N, value-in-output-units) reads (ops/detect.spline_values),
    optional photSubVals of the reference filter's maps at the same
    positions, wcs/label/tileName/flagMask and unit metadata.  Legacy
    cutout payloads (cutouts/photCutouts + anchors) are still accepted
    and spline-read on the host.
    """
    det = filteredMapDict["deviceDetections"]
    subVals = filteredMapDict.get("subVals")
    photSubVals = filteredMapDict.get("photSubVals")
    cut = filteredMapDict.get("cutouts")
    cutY0 = filteredMapDict.get("cutY0")
    cutX0 = filteredMapDict.get("cutX0")
    wcs = filteredMapDict["wcs"]
    flagMask = np.asarray(filteredMapDict["flagMask"])
    mapUnits = filteredMapDict["mapUnits"]
    obsFreqGHz = filteredMapDict.get("obsFreqGHz")
    beamSolidAngle_nsr = filteredMapDict.get("beamSolidAngle_nsr", 0)
    photCut = filteredMapDict.get("photCutouts")
    readKey = "spline" if useInterpolator else "nearest"
    reportJyFluxes = (mapUnits == "uK" and beamSolidAngle_nsr
                      and obsFreqGHz not in (None, "yc"))

    catalog = []
    idNumCount = 1
    K = len(det["valid"])
    for k in range(K):
        if not det["valid"][k] or det["numPix"][k] <= minObjPix:
            continue
        y = float(det["comY"][k] if findCenterOfMass else det["peakY"][k])
        x = float(det["comX"][k] if findCenterOfMass else det["peakX"][k])
        objDict = {"id": idNumCount, "x": x, "y": y}
        idNumCount += 1
        ra, dec = wcs.pix2wcs(x, y)
        if ra < 0:
            ra = 360 + ra
        objDict["RADeg"], objDict["decDeg"] = ra, dec
        objDict["galacticLatDeg"] = catalogs.galacticLatDeg(ra, dec)
        if longNames:
            objDict["name"] = catalogs.makeLongName(ra, dec,
                                                    prefix=objIdent)
        else:
            objDict["name"] = catalogs.makeName(ra, dec, prefix=objIdent)
        objDict["numSigPix"] = float(det["numPix"][k])
        objDict["template"] = filteredMapDict["label"]
        objDict["tileName"] = filteredMapDict["tileName"]
        if subVals is not None:
            snr = float(subVals[readKey][k, 0])
        else:
            snr = _cutoutSpline(cut[k, 0], int(cutY0[k]), int(cutX0[k]),
                                y, x, useInterpolator)
        objDict["SNR"] = snr
        yi = int(np.clip(round(y), 0, flagMask.shape[0] - 1))
        xi = int(np.clip(round(x), 0, flagMask.shape[1] - 1))
        objDict["flags"] = int(flagMask[yi, xi])
        if snr <= threshold:
            continue

        # Flux columns (measureFluxes semantics, photometry.py:258-351)
        if subVals is not None:
            mapValue = float(subVals[readKey][k, 1])
        else:
            mapValue = _cutoutSpline(cut[k, 1], int(cutY0[k]),
                                     int(cutX0[k]), y, x, useInterpolator)
        readers = [("", snr, mapValue)]
        if photSubVals is not None:
            fixedSNR = float(photSubVals[readKey][k, 0])
            fixedVal = float(photSubVals[readKey][k, 1])
            objDict["fixed_SNR"] = fixedSNR
            readers.append(("fixed_", fixedSNR, fixedVal))
        elif photCut is not None:
            pY0 = int(filteredMapDict["photCutY0"][k])
            pX0 = int(filteredMapDict["photCutX0"][k])
            fixedSNR = _cutoutSpline(photCut[k, 0], pY0, pX0, y, x,
                                     useInterpolator)
            fixedVal = _cutoutSpline(photCut[k, 1], pY0, pX0, y, x,
                                     useInterpolator)
            objDict["fixed_SNR"] = fixedSNR
            readers.append(("fixed_", fixedSNR, fixedVal))
        for prefix, snrV, val in readers:
            snr_safe = snrV if snrV != 0 else 1e-9
            if mapUnits == "yc":
                objDict[prefix + "y_c"] = val / 1e-4
                objDict[prefix + "err_y_c"] = \
                    objDict[prefix + "y_c"] / snr_safe
                deltaTc = sz.convertToDeltaT(val,
                                             obsFrequencyGHz=ycObsFreqGHz)
                objDict[prefix + "deltaT_c"] = deltaTc
                objDict[prefix + "err_deltaT_c"] = abs(deltaTc / snr_safe)
            else:
                objDict[prefix + "deltaT_c"] = val
                objDict[prefix + "err_deltaT_c"] = val / snr_safe
                if reportJyFluxes:
                    objDict[prefix + "fluxJy"] = sz.deltaTToJyPerSr(
                        val, obsFreqGHz) * beamSolidAngle_nsr * 1e-9
                    objDict[prefix + "err_fluxJy"] = sz.deltaTToJyPerSr(
                        objDict[prefix + "err_deltaT_c"],
                        obsFreqGHz) * beamSolidAngle_nsr * 1e-9
        catalog.append(objDict)

    if len(catalog) > 0:
        catalog = catalogs.catalogListToTab(catalog)
        if DS9RegionsPath is not None:
            catalogs.catalog2DS9(catalog, DS9RegionsPath)
    return catalog


def getSNRValues(catalog, SNMap, wcs, useInterpolator=True, invertMap=False,
                 prefix=""):
    """Measure SNR at catalog positions (``photometry.py:225-255``)."""
    if invertMap:
        SNMap = SNMap * -1
    if len(catalog) == 0:
        return
    coords = wcs.wcs2pix(np.asarray(catalog["RADeg"]),
                         np.asarray(catalog["decDeg"]))
    xs, ys = coords[:, 0], coords[:, 1]
    vals = np.zeros(len(catalog))
    inMap = (xs.astype(int) > 0) & (xs.astype(int) < SNMap.shape[1]) & \
            (ys.astype(int) > 0) & (ys.astype(int) < SNMap.shape[0])
    if useInterpolator:
        vals[inMap] = interp.subpixel_values(SNMap, ys[inMap], xs[inMap])
    else:
        vals[inMap] = SNMap[np.round(ys[inMap]).astype(int),
                            np.round(xs[inMap]).astype(int)]
    catalog[prefix + "SNR"] = vals


def measureFluxes(catalog, filteredMapDict, diagnosticsDir=None,
                  photFilteredMapDict=None, useInterpolator=True,
                  ycObsFreqGHz=148.0):
    """Add flux columns to the catalog (``photometry.py:258-351``)."""
    if len(catalog) == 0:
        return
    mapData = filteredMapDict["data"]
    wcs = filteredMapDict["wcs"]
    mapUnits = filteredMapDict["mapUnits"]

    if photFilteredMapDict is not None:
        getSNRValues(catalog, photFilteredMapDict["SNMap"], wcs,
                     prefix="fixed_", useInterpolator=useInterpolator)

    beamSolidAngle_nsr = filteredMapDict.get("beamSolidAngle_nsr", 0)
    obsFreqGHz = filteredMapDict.get("obsFreqGHz", None)
    reportJyFluxes = (mapUnits == "uK" and beamSolidAngle_nsr
                      and obsFreqGHz not in (None, "yc"))

    mapDataList = [mapData]
    prefixList = [""]
    if photFilteredMapDict is not None:
        mapDataList.append(photFilteredMapDict["data"])
        prefixList.append("fixed_")

    coords = wcs.wcs2pix(np.asarray(catalog["RADeg"]),
                         np.asarray(catalog["decDeg"]))
    xs, ys = coords[:, 0], coords[:, 1]

    for data, prefix in zip(mapDataList, prefixList):
        if useInterpolator:
            mapValues = interp.subpixel_values(data, ys, xs)
        else:
            mapValues = data[np.round(ys).astype(int),
                             np.round(xs).astype(int)]
        snr = np.asarray(catalog[prefix + "SNR"]) if \
            (prefix + "SNR") in catalog else np.asarray(catalog["SNR"])
        snr_safe = np.where(snr != 0, snr, 1e-9)
        if mapUnits == "yc":
            yc = mapValues
            catalog[prefix + "y_c"] = yc / 1e-4
            catalog[prefix + "err_y_c"] = np.asarray(
                catalog[prefix + "y_c"]) / snr_safe
            deltaTc = sz.convertToDeltaT(yc, obsFrequencyGHz=ycObsFreqGHz)
            catalog[prefix + "deltaT_c"] = deltaTc
            catalog[prefix + "err_deltaT_c"] = np.abs(deltaTc / snr_safe)
        elif mapUnits == "uK":
            deltaTc = mapValues
            catalog[prefix + "deltaT_c"] = deltaTc
            catalog[prefix + "err_deltaT_c"] = deltaTc / snr_safe
            if reportJyFluxes:
                catalog[prefix + "fluxJy"] = sz.deltaTToJyPerSr(
                    deltaTc, obsFreqGHz) * beamSolidAngle_nsr * 1e-9
                catalog[prefix + "err_fluxJy"] = sz.deltaTToJyPerSr(
                    np.asarray(catalog[prefix + "err_deltaT_c"]),
                    obsFreqGHz) * beamSolidAngle_nsr * 1e-9


def makeForcedPhotometryCatalog(filteredMapDict, inputCatalog,
                                useInterpolator=True, DS9RegionsPath=None):
    """Forced photometry positions from an external catalog
    (``photometry.py:354-416``)."""
    from .utils.tables import Table
    if isinstance(inputCatalog, str):
        forcedTab = Table.read(inputCatalog)
    else:
        forcedTab = inputCatalog
    RAKey, decKey = catalogs.getTableRADecKeys(forcedTab)
    ra = np.array(forcedTab[RAKey], dtype=float)
    ra[ra < 0] = 360 - np.abs(ra[ra < 0])
    forcedTab[RAKey] = ra
    forcedTab.rename_column(RAKey, "RADeg")
    forcedTab.rename_column(decKey, "decDeg")
    if "name" not in forcedTab.keys():
        forcedTab["name"] = (np.arange(len(forcedTab)) + 1).astype(str)

    wcs = filteredMapDict["wcs"]
    data = filteredMapDict["SNMap"]
    forcedTab = catalogs.getCatalogWithinImage(forcedTab, data.shape, wcs)

    catalog = []
    idNumCount = 1
    for row in forcedTab:
        x, y = wcs.wcs2pix(float(row["RADeg"]), float(row["decDeg"]))
        x, y = int(round(x)), int(round(y))
        if data[y, x] == 0:
            continue
        objDict = {
            "id": idNumCount, "x": x, "y": y,
            "RADeg": row["RADeg"], "decDeg": row["decDeg"],
            "galacticLatDeg": catalogs.galacticLatDeg(row["RADeg"],
                                                      row["decDeg"]),
            "name": row["name"], "numSigPix": 1,
            "template": filteredMapDict["label"],
            "tileName": filteredMapDict["tileName"],
        }
        if useInterpolator:
            objDict["SNR"] = interp.subpixel_value(data, y, x)
        else:
            objDict["SNR"] = data[y, x]
        catalog.append(objDict)
        idNumCount += 1
    if len(catalog) > 0:
        catalog = catalogs.catalogListToTab(catalog)
        if DS9RegionsPath is not None:
            catalogs.catalog2DS9(catalog, DS9RegionsPath)
    return catalog


# ----------------------------------------------------------------------------
# Unit conversions and small geometry helpers kept at module level for
# reference API parity (``nemo/photometry.py:460-553``).  deltaT <-> Jy/sr
# delegate to the shared SZ spectral module.

def deltaTToJyPerSr(temp, obsFreqGHz):
    """Convert delta T (uK) to Jy/sr (``photometry.py:460``)."""
    return sz.deltaTToJyPerSr(temp, obsFreqGHz)


def JyPerSrToDeltaT(JySr, obsFreqGHz):
    """Convert Jy/sr to delta T (uK) (``photometry.py:477``)."""
    return sz.JyPerSrToDeltaT(JySr, obsFreqGHz)


def getRadialDistanceMap(objDict, data, wcs):
    """Radial distance (degrees on the sky) from the object at
    ``objDict['x'], objDict['y']`` for every pixel (``photometry.py:496``)."""
    from .utils.wcs import calcAngSepDeg

    x0, y0 = objDict["x"], objDict["y"]
    ra1, dec1 = wcs.pix2wcs(x0 + 1, y0 + 1)
    xPixScale = calcAngSepDeg(objDict["RADeg"], objDict["decDeg"], ra1,
                              objDict["decDeg"])
    yPixScale = calcAngSepDeg(objDict["RADeg"], objDict["decDeg"],
                              objDict["RADeg"], dec1)
    xR = (np.arange(data.shape[1]) - x0)[None, :] * xPixScale
    yR = (np.arange(data.shape[0]) - y0)[:, None] * yPixScale
    return np.sqrt(xR ** 2 + yR ** 2)


def getPixelsDistanceMap(objDict, data):
    """Radial distance (pixels) from the object at ``objDict['x'],
    objDict['y']`` for every pixel (``photometry.py:516``)."""
    x0, y0 = objDict["x"], objDict["y"]
    xR = (np.arange(data.shape[1]) - x0)[None, :]
    yR = (np.arange(data.shape[0]) - y0)[:, None]
    return np.sqrt(xR ** 2 + yR ** 2)


def makeAnnulus(innerScalePix, outerScalePix):
    """Annulus footprint for rank filtering (``photometry.py:533``)."""
    inner = int(round(innerScalePix))
    outer = int(round(outerScalePix))
    xR = np.arange(2 * outer)[None, :] - outer
    yR = np.arange(2 * outer)[:, None] - outer
    r = np.sqrt(xR ** 2 + yR ** 2)
    return ((r > inner) & (r < outer)).astype(np.int64)
