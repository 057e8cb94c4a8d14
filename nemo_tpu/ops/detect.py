"""On-device object detection: connected components + segment statistics.

Device replacement for the host detection stage (scipy
``ndimage.label`` / ``center_of_mass`` / ``maximum_position`` in
``nemo/photometry.py:193-222``): S/N-map segmentation runs on the device
and only O(K) per-object statistics and small per-object cutouts go to
the host, instead of the full filtered + S/N maps for every (tile,
scale); detections are ~30 KB.

Algorithm:

1. ``sigPix = SNMap > threshold`` (the reference's segmentation input).
2. Connected components by iterative 4-neighbour label minimisation:
   every significant pixel starts with its own flat index as its label
   and repeatedly takes the minimum of its neighbours' labels.  The
   iteration count bounds the component *diameter* resolvable - SZ
   cluster/point-source segments span tens of pixels, so the default
   128 iterations has a wide margin (a component split by an undersized
   budget would surface as duplicate detections, removed by the optimal
   catalog's position dedup, not silent corruption).
3. Every component's root (minimum flat index) marks one object.  Up to
   ``max_objects`` roots are kept in pixel order.  Each pixel's object
   bucket is the ORDINAL of its component's root among all roots in
   flat order: ``ord = exclusive_cumsum(isRoot)`` makes the bucket a
   single gather ``ord[label]`` (the label IS the root's flat index) -
   no top_k and no searchsorted.
4. Per-component count, value-weighted centroid (= scipy
   ``center_of_mass`` with the map as weights), peak value and
   first-maximum position (= scipy ``maximum_position``) come from
   segment reductions.  The backend's decision row (``platform.py``)
   picks the formulation: on the GPU a COMPACTED fixed-size buffer of
   the significant pixels (``jnp.nonzero`` with a static size; one
   one-hot matmul, f32-exact via Precision.HIGHEST) - a 4-sigma
   threshold keeps ~0.003% of pixels, so the gather replaces a scan
   over the full map.  Blowing the pixel budget forces the caller's
   host-fallback path.  On the CPU the plain ``segment_sum`` scatter
   path is used; the blocked matmul scan is kept as a third
   implementation for cross-checks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import platform


_BIG = np.int32(2 ** 30)


@functools.partial(jax.jit, static_argnames=("n_iter",))
def label_components(mask, n_iter=128):
    """4-connected component labels (flat-index minima) for a 2-d mask.

    Returns int32 labels: for mask pixels, the minimum flat index of the
    connected component; _BIG elsewhere.
    """
    ny, nx = mask.shape
    flat = jnp.arange(ny * nx, dtype=jnp.int32).reshape(ny, nx)
    labels = jnp.where(mask, flat, _BIG)

    def body(_, lab):
        up = jnp.pad(lab[1:], ((0, 1), (0, 0)), constant_values=_BIG)
        down = jnp.pad(lab[:-1], ((1, 0), (0, 0)), constant_values=_BIG)
        left = jnp.pad(lab[:, 1:], ((0, 0), (0, 1)), constant_values=_BIG)
        right = jnp.pad(lab[:, :-1], ((0, 0), (1, 0)), constant_values=_BIG)
        best = jnp.minimum(jnp.minimum(up, down),
                           jnp.minimum(left, right))
        return jnp.where(mask, jnp.minimum(lab, best), _BIG)

    return jax.lax.fori_loop(0, n_iter, body, labels)


_INT32_MAX = np.int32(np.iinfo(np.int32).max)
_BLOCK = 8192


def _segment_stats_scatter(snFlat, seg, b, inBucket, max_objects, nx):
    """Reference formulation: XLA scatter-based segment reductions."""
    K1 = max_objects + 1
    n = snFlat.shape[0]
    yy = (jnp.arange(n, dtype=snFlat.dtype) // nx)
    xx = (jnp.arange(n, dtype=snFlat.dtype) % nx)
    data4 = jnp.stack([jnp.ones_like(snFlat), snFlat, snFlat * yy,
                       snFlat * xx], axis=-1)
    sums = jax.ops.segment_sum(data4, seg, num_segments=K1)[:-1]
    peak = jax.ops.segment_max(jnp.where(inBucket, snFlat, -jnp.inf), seg,
                               num_segments=K1)[:-1]
    # First maximum (scipy maximum_position scan order): min flat index
    # among pixels at the segment max.
    atPeak = jnp.logical_and(inBucket, snFlat == peak[b])
    peakIdx = jax.ops.segment_min(
        jnp.where(atPeak, jnp.arange(n, dtype=jnp.int32), _INT32_MAX),
        seg, num_segments=K1)[:-1]
    return sums, peak, peakIdx


_MAXPIX = 65536     # compact-impl per-map significant-pixel budget


def _segment_stats_compact(snFlat, seg, inBucket, maskFlat, max_objects,
                           nx, max_pix):
    """Compacted formulation: significant pixels are a tiny fraction of
    the map (a 4-sigma threshold keeps ~0.003% of noise pixels plus the
    objects), so gather them into a fixed (max_pix,) buffer first
    (``jnp.nonzero`` with a static size) and reduce the per-segment
    statistics with ONE one-hot matmul + masked reductions - no scan
    over the full map.  Measured at the DR5 chunk shape this replaces
    the 0.17 s blocked scan with ~0.01 s of gathers.  Returns an extra
    ``nSigPix`` so the caller can detect budget overflow (stats would
    silently drop pixels beyond it)."""
    K1 = max_objects + 1
    n = snFlat.shape[0]
    nSigPix = jnp.sum(maskFlat.astype(jnp.int32))
    idx = jnp.nonzero(maskFlat, size=max_pix, fill_value=n)[0]
    pad = idx >= n
    idxc = jnp.minimum(idx, n - 1).astype(jnp.int32)
    v = jnp.where(pad, 0.0, snFlat[idxc])
    segc = jnp.where(pad, max_objects, seg[idxc])
    inb = jnp.logical_and(jnp.logical_not(pad), inBucket[idxc])
    yy = (idxc // nx).astype(v.dtype)
    xx = (idxc % nx).astype(v.dtype)
    kk = jnp.arange(K1, dtype=segc.dtype)
    oh = segc[:, None] == kk[None, :]
    ones = jnp.where(pad, 0.0, 1.0).astype(v.dtype)
    data4 = jnp.stack([ones, v, v * yy, v * xx], axis=1)
    sums = jnp.einsum("nk,nc->kc", oh.astype(v.dtype), data4,
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=v.dtype)
    ohv = jnp.logical_and(oh, inb[:, None])
    peak = jnp.where(ohv, v[:, None], -jnp.inf).max(axis=0)
    peakIdx = jnp.where(
        jnp.logical_and(ohv, v[:, None] == peak[None, :]),
        idxc[:, None], _INT32_MAX).min(axis=0)
    return sums[:-1], peak[:-1], peakIdx[:-1], nSigPix


def _segment_stats_blocked(snFlat, seg, inBucket, max_objects, nx):
    """Blocked formulation: scan over fixed pixel blocks; the four
    weighted sums are one (block x K+1) one-hot matmul per block
    (Precision.HIGHEST so f32 operands are not rounded), the
    peak / first-maximum reductions are masked block reductions combined
    across blocks with exact scipy scan-order tie-breaking."""
    K1 = max_objects + 1
    n = snFlat.shape[0]
    nB = -(-n // _BLOCK)
    padN = nB * _BLOCK - n
    segB = jnp.pad(seg, (0, padN),
                   constant_values=max_objects).reshape(nB, _BLOCK)
    vB = jnp.pad(snFlat, (0, padN)).reshape(nB, _BLOCK)
    idxB = jnp.pad(jnp.arange(n, dtype=jnp.int32), (0, padN),
                   constant_values=_INT32_MAX).reshape(nB, _BLOCK)
    yyB = (idxB // nx).astype(snFlat.dtype)
    xxB = (idxB % nx).astype(snFlat.dtype)
    inB = jnp.pad(inBucket, (0, padN)).reshape(nB, _BLOCK)
    kk = jnp.arange(K1, dtype=seg.dtype)

    def body(carry, blk):
        sums, peak, peakIdx = carry
        segb, vb, yb, xb, ib, inb = blk
        oh = segb[:, None] == kk[None, :]
        data4 = jnp.stack([jnp.ones_like(vb), vb, vb * yb, vb * xb], 1)
        sums = sums + jnp.einsum("nk,nc->kc", oh.astype(vb.dtype), data4,
                                 precision=jax.lax.Precision.HIGHEST,
                                 preferred_element_type=vb.dtype)
        ohv = jnp.logical_and(oh, inb[:, None])
        bPeak = jnp.where(ohv, vb[:, None], -jnp.inf).max(axis=0)
        bIdx = jnp.where(
            jnp.logical_and(ohv, vb[:, None] == bPeak[None, :]),
            ib[:, None], _INT32_MAX).min(axis=0)
        better = bPeak > peak
        tie = bPeak == peak
        peakIdx = jnp.where(better, bIdx,
                            jnp.where(tie, jnp.minimum(peakIdx, bIdx),
                                      peakIdx))
        peak = jnp.maximum(peak, bPeak)
        return (sums, peak, peakIdx), None

    init = (jnp.zeros((K1, 4), snFlat.dtype),
            jnp.full((K1,), -jnp.inf, snFlat.dtype),
            jnp.full((K1,), _INT32_MAX, jnp.int32))
    (sums, peak, peakIdx), _ = jax.lax.scan(
        body, init, (segB, vB, yyB, xxB, idxB, inB))
    return sums[:-1], peak[:-1], peakIdx[:-1]


@functools.partial(jax.jit, static_argnames=("max_objects", "n_iter",
                                             "impl", "max_pix"))
def detect_objects(SNMap, threshold, max_objects=128, n_iter=128,
                   impl="auto", max_pix=None):
    """Segment a (masked) S/N map and reduce per-object statistics.

    Args:
        SNMap: 2-d S/N map (already masked: zero outside the valid area).
        threshold: detection threshold (sigPix = SNMap > threshold).
        max_objects: per-map object budget K (roots beyond it dropped -
            ``nObjects`` reports the true count so callers can detect
            overflow and fall back).
        impl: segment-reduction formulation - "compact" (fixed-budget
            significant-pixel gather + one-hot matmul),
            "blocked" (one-hot matmul scan over the full map),
            "scatter" (``segment_sum``), or "auto" (the backend's
            decision row).  Outputs are identical; position entries of
            INVALID buckets are unspecified in all.  The compact impl
            budgets ``_MAXPIX`` significant pixels per map; beyond it
            the returned ``nObjects`` is forced above ``max_objects``
            so callers take the same host-fallback path as an
            object-count overflow (stats past the budget would
            silently drop pixels).
    Returns dict of (K,) arrays:
        valid (bool), numPix, comY, comX (value-weighted centroid),
        peak (max S/N value in segment), peakY, peakX (first maximum,
        scan order), plus scalar nObjects.
    """
    if impl == "auto":
        impl = platform.choices().segment_stats
    ny, nx = SNMap.shape
    mask = SNMap > threshold
    labels = label_components(mask, n_iter=n_iter)
    flat = jnp.arange(ny * nx, dtype=jnp.int32).reshape(ny, nx)
    isRoot = jnp.logical_and(mask, labels == flat)
    nObjects = jnp.sum(isRoot.astype(jnp.int32))

    # Bucket of each significant pixel = ordinal of its component's root
    # among all roots in flat order (exclusive cumsum of the root
    # indicator, gathered at the pixel's label - the label IS the root's
    # flat index).  Roots beyond the budget go to overflow bucket K.
    rootFlat = isRoot.reshape(-1)
    ordFlat = jnp.cumsum(rootFlat.astype(jnp.int32)) - rootFlat
    labFlat = labels.reshape(-1)
    snFlat = SNMap.reshape(-1)
    maskFlat = mask.reshape(-1)
    bRaw = ordFlat[jnp.where(maskFlat, labFlat, 0)]
    inBucket = jnp.logical_and(maskFlat, bRaw < max_objects)
    seg = jnp.where(inBucket, bRaw, max_objects)  # overflow bucket K

    if impl == "compact":
        if max_pix is None:
            max_pix = _MAXPIX
        sums, peak, peakIdx, nSigPix = _segment_stats_compact(
            snFlat, seg, inBucket, maskFlat, max_objects, nx, max_pix)
        nObjects = jnp.where(nSigPix > max_pix,
                             jnp.maximum(nObjects,
                                         np.int32(max_objects + 1)),
                             nObjects)
    elif impl == "blocked":
        sums, peak, peakIdx = _segment_stats_blocked(
            snFlat, seg, inBucket, max_objects, nx)
    else:
        b = jnp.clip(bRaw, 0, max_objects - 1)
        sums, peak, peakIdx = _segment_stats_scatter(
            snFlat, seg, b, inBucket, max_objects, nx)
    count, sumV, sumVY, sumVX = (sums[:, 0], sums[:, 1], sums[:, 2],
                                 sums[:, 3])
    valid = count > 0
    safe = jnp.maximum(sumV, 1e-30)
    return {"valid": valid, "numPix": count,
            "comY": sumVY / safe, "comX": sumVX / safe,
            "peak": peak,
            "peakY": (peakIdx // nx).astype(jnp.float32),
            "peakX": (peakIdx % nx).astype(jnp.float32),
            "nObjects": nObjects}


def detect_objects_batch(SNBatch, threshold, max_objects=128, n_iter=128,
                         impl="auto", max_pix=None):
    """vmap of :func:`detect_objects` over a tile batch."""
    return jax.vmap(lambda m: detect_objects(m, threshold,
                                             max_objects=max_objects,
                                             n_iter=n_iter,
                                             impl=impl,
                                             max_pix=max_pix))(SNBatch)


@functools.partial(jax.jit, static_argnames=("window",))
def gather_cutouts(maps3d, ys, xs, window=16):
    """Fixed-size windows around float (y, x) positions from a stack of
    maps.

    Anchoring replicates ``interp.subpixel_values``:
    ``y0 = clip(floor(y) - window, 0, max(ny - 2*window, 0))`` - so a
    host-side windowed spline over the cutout reproduces the full-map
    windowed spline bit-for-bit when the anchor formula agrees.

    Args:
        maps3d: (nMaps, ny, nx) stack (e.g. S/N + signal maps).
        ys, xs: (K,) float positions.
        window: half-width; cutouts are (2*window + 1) square.
    Returns:
        (K, nMaps, 2*window+1, 2*window+1) values and (K,) y0, x0 anchors.
    """
    nMaps, ny, nx = maps3d.shape
    P = 2 * window + 1
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32) - window, 0,
                  max(ny - P, 0))
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32) - window, 0,
                  max(nx - P, 0))

    def one(yy, xx):
        zero = jnp.zeros((), dtype=yy.dtype)
        return jax.lax.dynamic_slice(maps3d, (zero, yy, xx), (nMaps, P, P))

    cut = jax.vmap(one)(y0, x0)
    return cut, y0, x0


def _bspline_basis4(t, u, nCoef):
    """The 4 non-zero cubic B-spline basis values at each point.

    Cox-de Boor (The NURBS Book A2.2, degree 3, unrolled) against the
    fixed knot vector ``t`` ((nCoef + 4,)) - the same basis FITPACK's
    ``fpbspl`` evaluates, so values agree with scipy to rounding error.

    Args:
        t: knots, e.g. from ``interp.notaknot_spline_setup``.
        u: (K,) evaluation points (clipped to the spline domain).
        nCoef: number of B-spline coefficients (= P for not-a-knot).
    Returns:
        N (K, 4) basis values for coefficients ``span-3..span`` and
        span (K,) int32 knot-span indices.
    """
    u = jnp.clip(u, t[3], t[nCoef])
    span = jnp.clip(jnp.searchsorted(t, u, side="right") - 1, 3,
                    nCoef - 1).astype(jnp.int32)
    left = [None] * 4
    right = [None] * 4
    for j in (1, 2, 3):
        left[j] = u - jnp.take(t, span + 1 - j)
        right[j] = jnp.take(t, span + j) - u
    N = [jnp.ones_like(u), None, None, None]
    for j in (1, 2, 3):
        saved = jnp.zeros_like(u)
        for r in range(j):
            denom = right[r + 1] + left[j - r]
            temp = N[r] / jnp.where(denom == 0, 1.0, denom)
            N[r] = saved + right[r + 1] * temp
            saved = left[j - r] * temp
        N[j] = saved
    return jnp.stack(N, axis=-1), span


def spline_values_from_cutouts(cut, y0, x0, ys, xs):
    """Not-a-knot bicubic spline values at float positions from
    ``gather_cutouts`` windows - the on-device equivalent of the host's
    windowed ``scipy.interpolate.RectBivariateSpline`` read
    (``photometry._cutoutSpline`` / ``interp.subpixel_values``; reference
    sub-pixel S/N + flux reads at ``nemo/photometry.py:121-124``).

    The value->coefficient matrix is derived from scipy on the host
    (``interp.notaknot_spline_setup``), so in float64 the values match a
    host windowed-spline read at the same anchors to ~1e-12.

    Args:
        cut, y0, x0: outputs of :func:`gather_cutouts` (cutouts must be
            square, (K, nMaps, P, P)).
        ys, xs: (K,) float positions (absolute map coordinates).
    Returns:
        (K, nMaps) spline values.
    """
    from . import interp as interp_ops

    K, nMaps, P, _ = cut.shape
    t_np, M_np = interp_ops.notaknot_spline_setup(P)
    dt = cut.dtype
    t = jnp.asarray(t_np, dt)
    M = jnp.asarray(M_np, dt)
    hi = jax.lax.Precision.HIGHEST
    C = jnp.einsum("ip,kmpq,jq->kmij", M, cut, M, precision=hi)
    Ny, iy = _bspline_basis4(t, ys.astype(dt) - y0.astype(dt), P)
    Nx, ix = _bspline_basis4(t, xs.astype(dt) - x0.astype(dt), P)

    def pick(Ck, ny, nx, iy0, ix0):
        blk = jax.lax.dynamic_slice(Ck, (jnp.int32(0), iy0, ix0),
                                    (nMaps, 4, 4))
        return jnp.einsum("a,mab,b->m", ny, blk, nx, precision=hi)

    return jax.vmap(pick)(C, Ny, Nx, iy - 3, ix - 3)


def nearest_values(maps3d, ys, xs):
    """Rounded-pixel map reads at float positions, (K, nMaps) - the
    ``useInterpolator=False`` read (reference ``photometry.py:119``);
    round-half-even matches the host's ``round``."""
    ny, nx = maps3d.shape[-2:]
    yi = jnp.clip(jnp.round(ys).astype(jnp.int32), 0, ny - 1)
    xi = jnp.clip(jnp.round(xs).astype(jnp.int32), 0, nx - 1)
    return maps3d[:, yi, xi].T


@functools.partial(jax.jit, static_argnames=("window",))
def spline_values(maps3d, ys, xs, window=16):
    """Sub-pixel reads of a map stack at float positions, fully on
    device: (spline (K, nMaps), nearest (K, nMaps)).  Ships O(K) scalars
    to the host instead of O(K x P x P) cutouts."""
    cut, y0, x0 = gather_cutouts(maps3d, ys, xs, window=window)
    sp = spline_values_from_cutouts(cut, y0, x0, ys, xs)
    return sp, nearest_values(maps3d, ys, xs)
