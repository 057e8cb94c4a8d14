"""The batched, sharded matched-filter step.

This is the device replacement for the reference's outer MPI loop
(``nemo/pipelines.py:179``: one tile per rank at a time).  A batch of
same-shaped tiles ``(n_tiles, n_freq, ny, nx)`` is sharded over the device
mesh; one jitted step builds the per-tile matched filter (noise covariance
-> closed-form N^-1 w|s| solve), applies it, estimates the local-noise RMS
map, forms the S/N map, trims edges, extracts the top-K S/N peaks per tile
on device, and reduces survey-level statistics (candidate counts, noise
histograms) with ``psum`` collectives.

Design notes:

* real-input transforms use rfft2/irfft2 (half the FFT work and half the
  Fourier-grid arithmetic of the reference's complex-FFT formulation);
* the grid sigma-clip RMS estimator takes the backend's decision row
  (on the GPU a fused Pallas Triton kernel, ``ops/noise.py``);
* the edge trim's huge (~240 px) minimum filter uses the separable
  van Herk algorithm - O(1) per pixel instead of O(window).

Only the tiny top-K candidate lists and histograms leave the device, not
the filtered maps - detection's catalog work stays host-side and cheap.
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from .. import platform
from ..ops import fourier, imageops
from ..ops import detect as detect_ops
from ..ops import noise as noise_ops
from ..ops import solve as solve_ops
from .mesh import TILE_AXIS, get_mesh, tile_sharding


def _mesh_choices(mesh, rms_impl):
    """(RMS implementation, segment statistics) for the backend the mesh's
    devices belong to - which need not be JAX's default backend."""
    row = platform.choices(mesh.devices.flat[0].platform)
    return (row.rms_impl if rms_impl == "auto" else rms_impl,
            row.segment_stats)


def _build_and_apply_filter(data, noise, template, w, apodM):
    """Matched-filter build + apply for ONE tile on the rfft grid.

    Args:
        data, noise: (nf, ny, nx) real maps.
        template: (nf, ny, nx) unit-normalised signal template maps.
        w: (nf,) spectral weights. apodM: (ny, nx).
    Returns:
        filtered (ny, nx): normalised so the filtered template peaks at 1.
    """
    nf, ny, nx = data.shape
    fNoise = jnp.fft.rfft2(noise * apodM[None])
    prods = jnp.real(fNoise[:, None] * jnp.conj(fNoise[None, :]))
    # 3-pixel Gaussian smoothing of the covariance, Hermitian-extended so
    # it EXACTLY reproduces the reference's full-grid smoothing (and the
    # host engine's) from the half grid.
    prods = imageops.gaussian_filter_rfft_fullgrid(
        prods.reshape((-1,) + prods.shape[-2:]), (3, 3), nx)
    N = prods.reshape(nf, nf, *prods.shape[-2:])
    fSignalAbs = jnp.abs(jnp.fft.rfft2(template))
    A = jnp.moveaxis(N, (0, 1), (-2, -1))
    b = jnp.moveaxis(fSignalAbs, 0, -1) * w
    filt = jnp.moveaxis(solve_ops.solve_small(A, b), -1, 0)

    filteredTemplate = jnp.sum(
        jnp.fft.irfft2(fSignalAbs * filt, s=(ny, nx)), axis=0)
    norm = 1.0 / jnp.maximum(jnp.max(filteredTemplate), 1e-30)
    fMaps = jnp.fft.rfft2(data * apodM[None])
    filtered = jnp.sum(jnp.fft.irfft2(fMaps * filt, s=(ny, nx)),
                       axis=0) * norm
    return filtered


@functools.lru_cache(maxsize=32)
def make_sharded_tile_step(mesh, gridSize, trimPix, topK=256, threshold=4.0,
                           with_survey_stats=True, rms_impl="auto"):
    """Build the jitted multi-device tile-batch step.

    Returns a function of (data, noise, template, w, apodM, psMask,
    surveyMask) with a leading tile axis on the array args, sharded over
    the mesh.  Survey-level statistics ride collectives.
    """
    from jax import shard_map

    spec_tiles = PartitionSpec(TILE_AXIS)
    spec_rep = PartitionSpec()
    rms_impl, _ = _mesh_choices(mesh, rms_impl)

    def per_shard(data, noise, template, w, apodM, psMask, surveyMask):
        filtered = jax.vmap(
            lambda d, n, t: _build_and_apply_filter(d, n, t, w, apodM))(
            data, noise, template)
        filtered = filtered * psMask

        RMSMap = noise_ops.grid_rms_map_batch(filtered, gridSize,
                                              impl=rms_impl)
        SNMap = jnp.where(RMSMap > 0,
                          filtered / jnp.maximum(RMSMap, 1e-30), 0.0)

        if trimPix > 0:
            edge = imageops.minimum_filter(
                jnp.abs(filtered + (1 - psMask)), trimPix)
            edgeCheck = (edge > 0).astype(filtered.dtype)
        else:
            edgeCheck = jnp.ones_like(filtered)
        mask = edgeCheck * surveyMask * psMask * (apodM == 1)[None]
        SNMap = SNMap * mask
        RMSMap = RMSMap * mask
        filtered = filtered * mask

        # On-device top-K local S/N maxima (candidate extraction)
        localMax = imageops.maximum_filter(SNMap, 3)
        isPeak = jnp.logical_and(SNMap >= localMax, SNMap > threshold)
        peakVals = jnp.where(isPeak, SNMap, 0.0).reshape(SNMap.shape[0], -1)
        vals, flatIdx = jax.lax.top_k(peakVals, topK)
        ys = flatIdx // SNMap.shape[-1]
        xs = flatIdx % SNMap.shape[-1]
        out = {"filtered": filtered, "SNMap": SNMap, "RMSMap": RMSMap,
               "peakVals": vals, "peakYs": ys, "peakXs": xs}
        if with_survey_stats:
            # Survey-wide reductions (the reference's MPI gathers):
            # candidate count and a global noise histogram. Globally
            # consistent bins need the survey-wide max noise level: a pmax
            # collective, then the per-shard histogram, then a psum.
            nCand = jnp.sum(vals > threshold)
            valid = RMSMap > 0
            globalMax = jax.lax.pmax(jnp.max(RMSMap), TILE_AXIS)
            edges = jnp.linspace(0.0, globalMax * 1.0001 + 1e-30, 33)
            hist = jnp.histogram(
                jnp.where(valid, RMSMap, -1.0).reshape(-1), bins=edges,
                weights=valid.reshape(-1) * 1.0)[0]
            out["surveyCandidateCount"] = jax.lax.psum(nCand, TILE_AXIS)
            out["surveyRMSHist"] = jax.lax.psum(hist, TILE_AXIS)
        return out

    sharded = shard_map(
        per_shard, mesh=mesh,
        in_specs=(spec_tiles, spec_tiles, spec_tiles, spec_rep, spec_rep,
                  spec_tiles, spec_tiles),
        out_specs={"filtered": spec_tiles, "SNMap": spec_tiles,
                   "RMSMap": spec_tiles, "peakVals": spec_tiles,
                   "peakYs": spec_tiles, "peakXs": spec_tiles,
                   **({"surveyCandidateCount": spec_rep,
                       "surveyRMSHist": spec_rep}
                      if with_survey_stats else {})},
        check_vma=False)
    return jax.jit(sharded)


def run_tile_batch(dataBatch, noiseBatch, templateBatch, w, apodM, psMask,
                   surveyMask, gridSize, trimPix, mesh=None, topK=256,
                   threshold=4.0, rms_impl="auto"):
    """Convenience host API: place a tile batch on the mesh and run."""
    mesh = mesh or get_mesh()
    step = make_sharded_tile_step(mesh, gridSize, trimPix, topK=topK,
                                  threshold=threshold, rms_impl=rms_impl)
    sh = tile_sharding(mesh)
    dataBatch = jax.device_put(jnp.asarray(dataBatch), sh)
    noiseBatch = jax.device_put(jnp.asarray(noiseBatch), sh)
    templateBatch = jax.device_put(jnp.asarray(templateBatch), sh)
    psMask = jax.device_put(jnp.asarray(psMask), sh)
    surveyMask = jax.device_put(jnp.asarray(surveyMask), sh)
    return step(dataBatch, noiseBatch, templateBatch, jnp.asarray(w),
                jnp.asarray(apodM), psMask, surveyMask)


# Backwards-compatible alias used by __graft_entry__.entry()
def _single_tile_step(data, noise, template, w, apodM, psMask, surveyMask,
                      gridSize, trimPix, topK, threshold):
    """Single-tile forward step (unsharded), for compile checks."""
    filtered = _build_and_apply_filter(data, noise, template, w, apodM)
    filtered = filtered * psMask
    RMSMap = noise_ops.grid_rms_map(filtered, gridSize)
    SNMap = jnp.where(RMSMap > 0, filtered / jnp.maximum(RMSMap, 1e-30),
                      0.0)
    if trimPix > 0:
        edge = imageops.minimum_filter(jnp.abs(filtered + (1 - psMask)),
                                       trimPix)
        edgeCheck = (edge > 0).astype(filtered.dtype)
    else:
        edgeCheck = jnp.ones_like(filtered)
    mask = edgeCheck * surveyMask * psMask * (apodM == 1)
    SNMap = SNMap * mask
    RMSMap = RMSMap * mask
    filtered = filtered * mask
    localMax = imageops.maximum_filter(SNMap, 3)
    isPeak = jnp.logical_and(SNMap >= localMax, SNMap > threshold)
    peakVals = jnp.where(isPeak, SNMap, 0.0).reshape(-1)
    vals, flatIdx = jax.lax.top_k(peakVals, topK)
    ys = flatIdx // SNMap.shape[-1]
    xs = flatIdx % SNMap.shape[-1]
    return {"filtered": filtered, "SNMap": SNMap, "RMSMap": RMSMap,
            "peakVals": vals, "peakYs": ys, "peakXs": xs}


def _undo_pixel_window_masked(filtered, mask):
    """Deconvolve the map pixel window in-graph (reference
    ``enmap.apply_window(pow=-1)``, ``nemo/filters.py:101-104``), keeping
    masked pixels at exactly zero.  Separable window formed from 1-d
    vectors so no O(ny*nx) constant is baked into the program."""
    ny, nx = filtered.shape[-2], filtered.shape[-1]
    wy, wx = fourier._window_half_1d(ny, nx, -1.0)
    w2d = jnp.asarray(wy)[:, None] * jnp.asarray(wx)[None, :]
    fm = jnp.fft.rfft2(filtered)
    out = jnp.fft.irfft2(fm * w2d.astype(fm.dtype), s=(ny, nx))
    return jnp.where(mask != 0, out, 0.0)


@functools.lru_cache(maxsize=32)
def make_sharded_realspace_step(mesh, gridSize, trimPix, rms_impl="auto",
                                undo_pixel_window=False):
    """Production batched real-space matched filter: the host engine's
    apply stage (``nemo_tpu/filters.py:RealSpaceMatchedFilter``, reference
    ``nemo/filters.py:1172-1218``) for a tile batch sharded over the mesh.

    The truncated kernels are built per tile on host (they come from a
    Fourier MF on a small sub-region, with the signal-norm calibration
    folded into ``signalNorm``); the device step is the full-tile work:
    grouped kernel convolution (frequencies ride the conv input-channel
    contraction), RMS estimation, S/N, edge trim and masking.

    Args of the returned function (leading tile axis sharded over the
    mesh unless noted):
        data:       (T, nf, ny, nx) preprocessed maps at TRUE tile shape
                    (no zero padding - the conv boundary is 'reflect' at
                    the genuine tile edge, matching the host path).
        kern:       (T, nf, ky, kx) truncated real-space kernels, odd
                    dims, zero-padded to the bucket's max kernel size
                    (exact: zero taps contribute nothing).
        signalNorm: (T,) per-tile calibration from the host kernel build.
        apodM:      (T, ny, nx) cosine apodisation (only its == 1 core is
                    used, as a border cut).
        psMask, surveyMask: (T, ny, nx) masks.
    Returns dict with "filtered" (signal units), "SNMap", "RMSMap",
    "surveyMask".
    """
    from jax import shard_map

    spec_tiles = PartitionSpec(TILE_AXIS)
    rms_impl, _ = _mesh_choices(mesh, rms_impl)

    def per_shard(data, kern, signalNorm, apodM, psMask, surveyMask,
                  meta):
        filtered = jax.vmap(imageops.convolve2d_reflect_sum)(data, kern)
        filtered = filtered * signalNorm[:, None, None]
        filtered = filtered * psMask

        RMSMap = noise_ops.grid_rms_map_batch(filtered, gridSize,
                                              impl=rms_impl, meta=meta)
        SNMap = jnp.where(RMSMap > 0,
                          filtered / jnp.maximum(RMSMap, 1e-30), 0.0)

        if trimPix > 0:
            edge = imageops.minimum_filter(
                jnp.abs(filtered + (1 - psMask)), trimPix)
            edgeCheck = (edge > 0).astype(filtered.dtype)
        else:
            edgeCheck = jnp.ones_like(filtered)
        # Host-engine masking semantics (RealSpaceMatchedFilter
        # .buildAndApply): the signal map keeps the apodisation border;
        # SN/RMS do not.
        maskData = edgeCheck * surveyMask * psMask
        maskSN = maskData * (apodM == 1)
        outMap = filtered * maskData
        if undo_pixel_window:
            outMap = jax.vmap(_undo_pixel_window_masked)(outMap, maskData)
        return {"filtered": outMap, "SNMap": SNMap * maskSN,
                "RMSMap": RMSMap * maskSN,
                "surveyMask": maskSN.astype(jnp.uint8)}

    metaSpec = {k: spec_tiles for k in
                ("startsY", "startsX", "lensY", "lensX",
                 "c0y", "c1y", "c0x", "c1x")}
    sharded = shard_map(
        per_shard, mesh=mesh,
        in_specs=(spec_tiles,) * 6 + (metaSpec,),
        out_specs={"filtered": spec_tiles, "SNMap": spec_tiles,
                   "RMSMap": spec_tiles, "surveyMask": spec_tiles},
        check_vma=False)
    return jax.jit(sharded)


@functools.partial(jax.jit, static_argnames=("window",))
def gather_cutouts_batch(snBatch, fmBatch, ys, xs, window=16):
    """Per-tile spline-window cutouts from a RESIDENT (S/N, signal) map
    pair at externally-supplied positions - the cross-filter (fixed_)
    photometry read against the reference filter's maps, without those
    maps ever leaving the device."""

    def one(sn, fm, yy, xx):
        return detect_ops.gather_cutouts(jnp.stack([sn, fm]), yy, xx,
                                         window=window)

    return jax.vmap(one)(snBatch, fmBatch, ys, xs)


@functools.partial(jax.jit, static_argnames=("window",))
def subpixel_read_batch(snBatch, fmBatch, ys, xs, window=16):
    """Per-tile sub-pixel (spline, nearest) S/N + flux reads from a
    RESIDENT (S/N, signal) map pair at externally-supplied positions -
    the cross-filter (fixed_) photometry read against the reference
    filter's maps.  Only O(K) scalars cross the link, not cutouts.

    Returns (spline, nearest), each (T, K, 2)."""

    def one(sn, fm, yy, xx):
        return detect_ops.spline_values(jnp.stack([sn, fm]), yy, xx,
                                        window=window)

    return jax.vmap(one)(snBatch, fmBatch, ys, xs)


@functools.lru_cache(maxsize=32)
def make_sharded_matched_filter_step(mesh, gridSize, trimPix,
                                     rms_impl="auto",
                                     undo_pixel_window=False,
                                     lean_outputs=False,
                                     detect_params=None,
                                     return_filter=False,
                                     given_filter=False):
    """Production batched matched filter: the host engine's math
    (``nemo_tpu/filters.py:MatchedFilter.buildAndApply``) for a tile batch
    sharded over the device mesh.

    Differences from :func:`make_sharded_tile_step` (the benchmark step):
    takes unit-normalised signal templates plus a separate known-amplitude
    calibration stack and returns maps in calibrated signal units (the
    host engine's signalNorm convention, ``filters.py:635-690`` in the
    reference), so the output feeds the host photometry/catalog stage
    directly.

    Args of the returned function (leading tile axis sharded over the mesh
    unless noted):
        data:      (T, nf, py, px) apodisable preprocessed maps (padded).
        template:  (T, nf, py, px) unit-amplitude signal templates (padded).
        calib:     (T, nf, py, px) known-amplitude templates for the
                   signal-norm calibration (padded; pixel window applied
                   by the caller where required).
        w:         (nf,) spectral weights (replicated).
        apodM:     (T, py, px) cosine apodisation, zero in the padding.
        psMask, surveyMask: (T, py, px) masks (padded with zeros).
    Returns dict with "filtered" (signal units), "SNMap", "RMSMap",
    "signalNorm" (T,) - all cropped back to tile shape by the caller.
    """
    from jax import shard_map

    spec_tiles = PartitionSpec(TILE_AXIS)
    spec_rep = PartitionSpec()
    rms_impl, segment_stats = _mesh_choices(mesh, rms_impl)

    def one_tile(d, n, t, c, w, apod, fg, peakYX):
        nf, ny, nx = d.shape
        fMaps = jnp.fft.rfft2(d * apod[None])
        # With the dataMap noise method the noise stack IS the data and
        # XLA's CSE collapses the two transforms into one.
        fNoise = jnp.fft.rfft2(n * apod[None])
        prods = jnp.real(fNoise[:, None] * jnp.conj(fNoise[None, :]))
        # max(dataMap,CMB): floor the covariance with a model CMB power
        # (host engine parity, filters.py max(dataMap,CMB) branch).  For
        # plain dataMap/model methods the caller MUST pass fg = -inf so
        # this is an exact no-op: ~half the off-diagonal covariance
        # values are negative, so a zero floor would clip them (the
        # reference applies no floor outside max(dataMap,CMB),
        # nemo/filters.py:575-580).
        prods = jnp.maximum(prods, fg[None, None])
        # full-grid-exact covariance smoothing (host-engine parity)
        prods = imageops.gaussian_filter_rfft_fullgrid(
            prods.reshape((-1,) + prods.shape[-2:]), (3, 3), nx)
        N = prods.reshape(nf, nf, *prods.shape[-2:])
        fSignalAbs = jnp.abs(jnp.fft.rfft2(t))
        A = jnp.moveaxis(N, (0, 1), (-2, -1))
        b = jnp.moveaxis(fSignalAbs, 0, -1) * w
        filt = jnp.moveaxis(solve_ops.solve_small(A, b), -1, 0)

        # Signal-norm calibration: push the known-amplitude template
        # through the same filter.  The template centre is the TILE
        # centre (shape/2.0) which for odd tile dimensions sits BETWEEN
        # pixels, so an integer-pixel read misses the peak by up to a
        # few percent - instead a 33x33 crop of the filtered template
        # ships to host, where the same windowed-spline sub-pixel read
        # as the host engine (filters.py:660-662) fixes the exact
        # normalisation.  The filtered map returned here is therefore
        # UNNORMALISED; S/N is a ratio and unaffected, and the host
        # scales signal values once per tile.
        # The per-plane 33x33 crops are evaluated DIRECTLY from the
        # half-grid spectra as a windowed inverse DFT (two small complex
        # matmuls, fourier.windowed_irfft2) - never materialising the
        # full filtered-calibration planes.  History: XLA has twice
        # miscompiled reads of that full-map intermediate when fused
        # with the rest of this program - first a vmapped rank-3 gather
        # (calib reads ~25-33 percent low at batch >= 8; worked around
        # with dynamic_slice), then the dynamic_slice variant itself at
        # the (768, 1440) DR5 tail bucket (signal norm 1.35x high,
        # caught by fitQ's Q[0]/y0 gate).  The
        # windowed DFT shares no layout with the filtered-map irfft2, so
        # there is no big fused intermediate to corrupt - and it is
        # cheaper than nf full inverse FFTs.  The crop also gives the
        # host a sub-pixel fRel-weight read for free (host engine reads
        # integer pixels, filters.py:671-674 in the reference).
        y0c = jnp.clip(peakYX[0] - 16, 0, ny - 33)
        x0c = jnp.clip(peakYX[1] - 16, 0, nx - 33)
        crop = fourier.windowed_irfft2(jnp.fft.rfft2(c) * filt,
                                       y0c, x0c, ny, nx, 33)
        # integer-pixel estimate from the SAME crop; the host-side
        # tripwire (engine._calibNormsFromCrops) cross-checks the crop's
        # peak pixel against 1/signalNorm, so the two reads go through
        # different lowerings of the crop value.
        peak = jax.lax.dynamic_slice(
            jnp.sum(crop, axis=0),
            (peakYX[0] - y0c, peakYX[1] - x0c), (1, 1))[0, 0]
        signalNorm = 1.0 / peak

        filtered = jnp.sum(jnp.fft.irfft2(fMaps * filt, s=(ny, nx)),
                           axis=0)
        return filtered, signalNorm, filt, crop

    def _tail(filtered, norms, filterOut, apodM, psMask, surveyMask,
              meta):
        filtered = filtered * psMask

        if trimPix > 0:
            edge = imageops.minimum_filter(
                jnp.abs(filtered + (1 - psMask)), trimPix)
            edgeCheck = (edge > 0).astype(filtered.dtype)
        else:
            edgeCheck = jnp.ones_like(filtered)
        # Host-engine masking semantics (filters.py buildAndApply): the
        # signal map keeps the apodisation border; SN/RMS do not.
        maskData = edgeCheck * surveyMask * psMask
        maskSN = maskData * (apodM == 1)

        if detect_params is not None:
            # Fully device-side detection (ops/detect.py): segmentation,
            # per-object statistics and the sub-pixel spline/nearest S/N
            # + flux reads all happen here; only O(K) scalars cross the
            # link.  The full maps stay resident as jit outputs for the
            # caller's cross-filter (fixed_) sub-pixel reads.
            threshold, maxObjects, nIter, useCom, cutWindow = detect_params
            cells = noise_ops.grid_rms_map_batch(filtered, gridSize,
                                                 impl=rms_impl,
                                                 return_cells=True,
                                                 meta=meta)
            RMSMap = jax.vmap(noise_ops._assemble_rms_meta)(
                cells, meta["c0y"], meta["c1y"], meta["c0x"], meta["c1x"])
            SNMap = jnp.where(RMSMap > 0,
                              filtered / jnp.maximum(RMSMap, 1e-30),
                              0.0) * maskSN
            det = detect_ops.detect_objects_batch(SNMap, threshold,
                                                  max_objects=maxObjects,
                                                  n_iter=nIter,
                                                  impl=segment_stats)
            outMap = jax.vmap(_undo_pixel_window_masked)(
                filtered * maskData, maskData)
            ys = det["comY"] if useCom else det["peakY"]
            xs = det["comX"] if useCom else det["peakX"]

            def valsOne(sn, fm, yy, xx):
                return detect_ops.spline_values(
                    jnp.stack([sn, fm]), yy, xx, window=cutWindow)

            subSpline, subNearest = jax.vmap(valsOne)(SNMap, outMap,
                                                      ys, xs)
            return dict({"filtered": outMap, "SNMap": SNMap,
                         "RMSCells": cells,
                         "surveyMask": maskSN.astype(jnp.uint8),
                         "signalNorm": norms, "det": det,
                         "subSpline": subSpline,
                         "subNearest": subNearest},
                        **filterOut)

        if lean_outputs:
            # Slow-link mode: ship the per-cell RMS grid (KBs) instead of
            # the full RMS and S/N maps; the host expands the grid
            # (noise_ops.assemble_rms_host) and rebuilds
            # SN = filtered * maskSN / RMS exactly (all masks binary).
            cells = noise_ops.grid_rms_map_batch(filtered, gridSize,
                                                 impl=rms_impl,
                                                 return_cells=True,
                                                 meta=meta)
            return dict({"filtered": filtered * maskData,
                         "RMSCells": cells,
                         "surveyMask": maskSN.astype(jnp.uint8),
                         "signalNorm": norms}, **filterOut)

        RMSMap = noise_ops.grid_rms_map_batch(filtered, gridSize,
                                              impl=rms_impl, meta=meta)
        SNMap = jnp.where(RMSMap > 0,
                          filtered / jnp.maximum(RMSMap, 1e-30), 0.0)
        outMap = filtered * maskData
        if undo_pixel_window:
            # In-step deconvolution at the padded shape: saves one
            # host round trip per (tile, filter) (the host engine
            # equivalent crops first, nemo_tpu/filters.py:66; interior
            # values agree to float tolerance).
            outMap = jax.vmap(_undo_pixel_window_masked)(outMap, maskData)
        return dict({"filtered": outMap, "SNMap": SNMap * maskSN,
                     "RMSMap": RMSMap * maskSN,
                     "surveyMask": maskSN.astype(jnp.uint8),
                     "signalNorm": norms}, **filterOut)

    def per_shard(data, noise, template, calib, w, apodM, psMask,
                  surveyMask, fgPower, peakYX, meta):
        filtered, norms, filts, crops = jax.vmap(
            lambda d, n, t, c, a, g, p: one_tile(d, n, t, c, w, a, g, p))(
            data, noise, template, calib, apodM, fgPower, peakYX)
        filterOut = {"filt": filts} if return_filter else {}
        filterOut["calibCrop"] = crops
        return _tail(filtered, norms, filterOut, apodM, psMask,
                     surveyMask, meta)

    def per_shard_given(data, filt, apodM, psMask, surveyMask, meta):
        """Apply a PRE-BUILT filter (cached-filter reruns: injection /
        contamination tests reload the saved reference filter rather
        than rebuilding from the injected data, as the host engine and
        the reference do, filters.py:536).  The caller supplies the
        host-known signalNorm, so no calibration runs here."""

        def one_given(d, flt, apod):
            nf, ny, nx = d.shape
            fMaps = jnp.fft.rfft2(d * apod[None])
            return jnp.sum(jnp.fft.irfft2(fMaps * flt, s=(ny, nx)),
                           axis=0)

        filtered = jax.vmap(one_given)(data, filt, apodM)
        norms = jnp.ones(filtered.shape[0], dtype=filtered.dtype)
        return _tail(filtered, norms, {}, apodM, psMask, surveyMask,
                     meta)

    if detect_params is not None:
        out_specs = {"filtered": spec_tiles, "SNMap": spec_tiles,
                     "RMSCells": spec_tiles, "surveyMask": spec_tiles,
                     "signalNorm": spec_tiles,
                     "det": {k: spec_tiles for k in
                             ("valid", "numPix", "comY", "comX", "peak",
                              "peakY", "peakX", "nObjects")},
                     "subSpline": spec_tiles, "subNearest": spec_tiles}
    elif lean_outputs:
        out_specs = {"filtered": spec_tiles, "RMSCells": spec_tiles,
                     "surveyMask": spec_tiles, "signalNorm": spec_tiles}
    else:
        out_specs = {"filtered": spec_tiles, "SNMap": spec_tiles,
                     "RMSMap": spec_tiles, "surveyMask": spec_tiles,
                     "signalNorm": spec_tiles}
    metaSpec = {k: spec_tiles for k in
                ("startsY", "startsX", "lensY", "lensX",
                 "c0y", "c1y", "c0x", "c1x")}
    if given_filter:
        sharded = shard_map(
            per_shard_given, mesh=mesh,
            in_specs=(spec_tiles,) * 5 + (metaSpec,),
            out_specs=out_specs,
            check_vma=False)
        return jax.jit(sharded)
    out_specs["calibCrop"] = spec_tiles
    if return_filter:
        out_specs["filt"] = spec_tiles
    sharded = shard_map(
        per_shard, mesh=mesh,
        in_specs=(spec_tiles, spec_tiles, spec_tiles, spec_tiles, spec_rep,
                  spec_tiles, spec_tiles, spec_tiles, spec_tiles,
                  spec_tiles, metaSpec),
        out_specs=out_specs,
        check_vma=False)
    return jax.jit(sharded)
