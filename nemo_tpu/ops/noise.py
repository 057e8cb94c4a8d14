"""Local noise (RMS) map estimation on the device.

Replaces ``MapFilter.makeNoiseMap`` (``nemo/filters.py:345-483``), the
grid-cell sigma-clipped RMS estimator.  The reference loops over map cells in
python, re-measuring a 3-sigma-clipped standard deviation (or biweight /
percentile estimate) per cell, with half-cell overlapping windows whose
writes overlap so later cells overwrite earlier ones.

Device formulation: all cell windows are gathered as one fixed-shape
(nCells, Wy, Wx) tensor (zero padding outside the map is self-masking,
because validity is defined by pixel != 0), the clipping loop is a fixed
10-iteration masked reduction over cells (exactly the reference's
``for c in range(10)``), and the overwrite-order semantics are reproduced
with a host-precomputed candidate-cell priority table.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import platform

_HIGHEST = jax.lax.Precision.HIGHEST


def cell_edges(n, gridSize):
    """Cell edges replicating the reference's chunking
    (``filters.py:417-422``): numChunks = n / gridSize (float),
    edges = linspace(0, n, int(numChunks + 1)) as ints."""
    numChunks = n / gridSize
    return np.linspace(0, n, int(numChunks + 1), dtype=int)


@functools.partial(jax.jit, static_argnames=("window", "n_iter", "estimator"))
def _cell_stats(windows, valid, window, n_iter, estimator):
    """Per-cell RMS from (nCells, Wy*Wx) values + validity masks."""
    v = windows
    good = valid

    def masked_mean_std(vals, mask):
        n = jnp.sum(mask, axis=1)
        safe_n = jnp.maximum(n, 1)
        mean = jnp.sum(vals * mask, axis=1) / safe_n
        var = jnp.sum(mask * (vals - mean[:, None]) ** 2, axis=1) / safe_n
        return mean, jnp.sqrt(var), n

    if estimator == "percentile":
        # 68.3rd percentile of |values| over the valid set, matching
        # np.percentile's linear interpolation between order statistics.
        absv = jnp.where(good, jnp.abs(v), jnp.inf)
        svals = jnp.sort(absv, axis=1)
        ngood = jnp.sum(good, axis=1)
        pos = 0.683 * (ngood - 1)
        lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, v.shape[1] - 1)
        hi = jnp.clip(lo + 1, 0, v.shape[1] - 1)
        whi = pos - lo
        vlo = jnp.take_along_axis(svals, lo[:, None], axis=1)[:, 0]
        vhi = jnp.take_along_axis(svals, hi[:, None], axis=1)[:, 0]
        rms = vlo * (1 - whi) + vhi * whi
        rms = jnp.where(ngood > 0, rms, 0.0)
        return jnp.where(jnp.isfinite(rms), rms, 0.0)

    # Default: 3-sigma clipped std (filters.py:468-477). The reference seeds
    # mean/std from the *good* values, then iterates 10 times clipping on
    # |v| < |mean + 3 std| over the good set.
    mean, rms, n0 = masked_mean_std(v, good)

    def body(_, carry):
        mean, rms = carry
        clip = jnp.abs(v) < jnp.abs(mean + 3.0 * rms)[:, None]
        m = jnp.logical_and(good, clip)
        nm = jnp.sum(m, axis=1)
        new_mean, new_rms, _ = masked_mean_std(v, m)
        keep = nm > 0
        return (jnp.where(keep, new_mean, mean), jnp.where(keep, new_rms, rms))

    mean, rms = jax.lax.fori_loop(0, n_iter, body, (mean, rms))
    return jnp.where(n0 > 0, rms, 0.0)



def _expansion_plan(edges, n, npix, ov):
    """Static per-pixel candidate cells as run-length repeat plans.

    Returns (repeats0, valid0, repeats1, valid1): for the highest-priority
    (latest-written) covering cell c0 and the runner-up c1, the number of
    pixels mapped to each cell index (in order) plus validity masks -
    candidate maps are monotone step functions of pixel index, so
    nearest-cell upsampling is a gather-free jnp.repeat.
    """
    pix = np.arange(npix)
    c0 = np.full(npix, -1)
    c1 = np.full(npix, -1)
    for i in range(n):
        cover = (pix >= edges[i] - ov) & (pix < edges[i + 1] + ov)
        c1[cover] = c0[cover]
        c0[cover] = i

    def plan(c):
        valid = c >= 0
        cc = np.clip(c, 0, n - 1)
        repeats = np.bincount(cc, minlength=n)
        return repeats, valid

    r0, v0 = plan(c0)
    r1, v1 = plan(c1)
    return (r0, v0, r1, v1)


def _assemble_rms(cellRMS, plan_y, plan_x, ny, nx):
    """Reference overwrite-order semantics via repeat expansion: priority
    (r0,c0) > (r0,c1) > (r1,c0) > (r1,c1); a zero cell RMS exposes the next
    candidate (filters.py:480-481)."""
    ry0, vy0, ry1, vy1 = plan_y
    rx0, vx0, rx1, vx1 = plan_x

    def expand(reps_y, reps_x):
        up = jnp.repeat(cellRMS, jnp.asarray(reps_y), axis=0,
                        total_repeat_length=ny)
        return jnp.repeat(up, jnp.asarray(reps_x), axis=1,
                          total_repeat_length=nx)

    out = jnp.zeros((ny, nx), dtype=cellRMS.dtype)
    for reps_y, vy, reps_x, vx in ((ry1, vy1, rx1, vx1),
                                   (ry1, vy1, rx0, vx0),
                                   (ry0, vy0, rx1, vx1),
                                   (ry0, vy0, rx0, vx0)):
        v = expand(reps_y, reps_x)
        ok = jnp.asarray(vy)[:, None] & jnp.asarray(vx)[None, :] & (v > 0)
        out = jnp.where(ok, v, out)
    return out


def grid_rms_map(mapData, gridSize_pix, overlap_pix=None, estimator="default",
                 n_iter=10, return_cells=False):
    """Estimate the noise map over grid cells (numNoiseBins = 1 path).

    Args:
        mapData: 2-d filtered map (nonzero pixels define valid area).
        gridSize_pix: cell size in pixels (from noiseGridArcmin).
        overlap_pix: window overlap; defaults to gridSize // 2 as the
            reference (``filters.py:418``).
        estimator: 'default' (3-sigma clip) or 'percentile'.
        return_cells: return the (nCy, nCx) per-cell RMS grid instead of
            the full-resolution map (see :func:`assemble_rms_host` - the
            grid is ~4 orders of magnitude smaller to download).

    Returns:
        RMS map, same shape (or the cell grid with ``return_cells``).
    """
    mapData = jnp.asarray(mapData)
    ny, nx = mapData.shape
    gridSize = int(gridSize_pix)
    ov = int(gridSize // 2) if overlap_pix is None else int(overlap_pix)
    ye = cell_edges(ny, gridSize)
    xe = cell_edges(nx, gridSize)
    nCy, nCx = len(ye) - 1, len(xe) - 1

    # Fixed window size covering the largest cell + overlap.
    Wy = int((np.diff(ye)).max() + 2 * ov)
    Wx = int((np.diff(xe)).max() + 2 * ov)

    # Pad map with zeros so fixed windows anchored at (y0-ov, x0-ov) always
    # fit; zero pixels are invalid by definition so padding self-masks.
    padded = jnp.pad(mapData, ((ov, Wy), (ov, Wx)))
    starts_y = np.repeat(ye[:-1], nCx)          # (nCells,) in write order
    starts_x = np.tile(xe[:-1], nCy)

    def gather(sy, sx):
        return jax.lax.dynamic_slice(padded, (sy, sx), (Wy, Wx))

    windows = jax.vmap(gather)(jnp.asarray(starts_y), jnp.asarray(starts_x))
    # Mask out the part of each fixed window beyond its true cell extent
    # (cells can be up to 1 pixel larger/smaller due to integer edges).
    lens_y = np.repeat(np.diff(ye), nCx) + 2 * ov
    lens_x = np.tile(np.diff(xe), nCy) + 2 * ov
    iy = jnp.arange(Wy)[None, :, None]
    ix = jnp.arange(Wx)[None, None, :]
    in_cell = (iy < jnp.asarray(lens_y)[:, None, None]) & \
              (ix < jnp.asarray(lens_x)[:, None, None])
    flat = windows.reshape(windows.shape[0], -1)
    valid = (jnp.logical_and(windows != 0, in_cell)).reshape(
        windows.shape[0], -1)
    cellRMS = _cell_stats(flat, valid, (Wy, Wx), n_iter, estimator)
    cellRMS = cellRMS.reshape(nCy, nCx)

    if return_cells:
        return cellRMS
    return _assemble_rms(cellRMS, _expansion_plan(ye, nCy, ny, ov),
                         _expansion_plan(xe, nCx, nx, ov), ny, nx)


def whole_map_rms(mapData, estimator="default", n_iter=10):
    """Single-cell variant (noiseGridArcmin = None path, filters.py:411-415)."""
    flat = jnp.asarray(mapData).reshape(1, -1)
    valid = flat != 0
    rms = _cell_stats(flat, valid, mapData.shape, n_iter, estimator)[0]
    # The reference fills the whole map with the single-cell RMS, including
    # zero (masked) pixels (filters.py:411-415); masks are re-applied later.
    return rms * jnp.ones_like(jnp.asarray(mapData))


# -----------------------------------------------------------------------------
# Pallas (Triton) kernel: fused per-cell sigma-clip.
#
# The XLA path gathers all (overlapping) cell windows into a
# (nT, nCells, Wy, Wx) tensor and runs the 10 masked-reduction iterations
# over it.  The kernel instead runs one program per (tile, cell) that
# reads its window straight from the padded map, a block of rows at a
# time, for each of the clip loop's 22 masked sums - the window
# (240 x 240 float32 at gridSize 80) is larger than a block's shared
# memory, so it streams through L2 instead of being materialised.

_ROWS = 8       # window rows per load


def _rms_cell_kernel(sy_ref, sx_ref, ly_ref, lx_ref, map_ref, out_ref, *,
                     n_row_blocks, width, n_iter):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    t = pl.program_id(0)
    c = pl.program_id(1)
    sy, sx = sy_ref[t, c], sx_ref[t, c]
    ly, lx = ly_ref[t, c], lx_ref[t, c]
    rows = jnp.arange(_ROWS)
    colOk = (jnp.arange(width) < lx)[None, :]
    dt = out_ref.dtype

    def load(b):
        inWin = ((b * _ROWS + rows) < ly)[:, None] & colOk
        v = plgpu.load(map_ref.at[t, pl.ds(sy + b * _ROWS, _ROWS),
                                  pl.ds(sx, width)],
                       mask=inWin, other=0.0)
        return v, inWin & (v != 0)

    def sums(thr):
        """(count, sum) over the good pixels with |v| < thr."""
        def body(b, acc):
            v, good = load(b)
            m = (good & (jnp.abs(v) < thr)).astype(dt)
            return acc[0] + m, acc[1] + v * m
        z = jnp.zeros((_ROWS, width), dt)
        n, sv = jax.lax.fori_loop(0, n_row_blocks, body, (z, z))
        return jnp.sum(n), jnp.sum(sv)

    def sqdev(thr, mean):
        def body(b, acc):
            v, good = load(b)
            m = (good & (jnp.abs(v) < thr)).astype(dt)
            return acc + m * (v - mean) ** 2
        acc = jax.lax.fori_loop(0, n_row_blocks, body,
                                jnp.zeros((_ROWS, width), dt))
        return jnp.sum(acc)

    inf = jnp.asarray(jnp.inf, dt)
    n0, s0 = sums(inf)
    safe0 = jnp.maximum(n0, 1.0)
    mean = s0 / safe0
    rms = jnp.sqrt(sqdev(inf, mean) / safe0)

    def clip(_, carry):
        mean, rms = carry
        thr = jnp.abs(mean + 3.0 * rms)
        nm, sm = sums(thr)
        safe = jnp.maximum(nm, 1.0)
        newMean = sm / safe
        newRms = jnp.sqrt(sqdev(thr, newMean) / safe)
        keep = nm > 0
        return (jnp.where(keep, newMean, mean), jnp.where(keep, newRms, rms))

    mean, rms = jax.lax.fori_loop(0, n_iter, clip, (mean, rms))
    out_ref[t, c] = jnp.where(n0 > 0, rms, 0.0).astype(dt)


def _grid_rms_cells_triton(mapBatch, meta, window, ov, n_iter=10,
                           interpret=False):
    """Per-cell clipped RMS of the per-tile-geometry estimator through the
    Pallas Triton kernel; same contract as :func:`_grid_rms_cells_xla_meta`.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    Wy, Wx = window
    nT = mapBatch.shape[0]
    nCells = meta["startsY"].shape[-1]
    width = int(pl.next_power_of_2(Wx))
    nRowBlocks = -(-Wy // _ROWS)
    # Pad so every row block and every full-width load stays inside the
    # array (masked lanes are never read on the card, but interpret mode
    # clamps out-of-range slices).
    padded = jnp.pad(mapBatch, ((0, 0), (ov, nRowBlocks * _ROWS),
                                (ov, width)))
    effY = jnp.where(meta["lensY"] > 0, meta["lensY"] + 2 * ov, 0)
    effX = jnp.where(meta["lensX"] > 0, meta["lensX"] + 2 * ov, 0)
    kernel = functools.partial(_rms_cell_kernel, n_row_blocks=nRowBlocks,
                               width=width, n_iter=n_iter)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((nT, nCells), mapBatch.dtype),
        grid=(nT, nCells),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="rms_cells",
    )(*(jnp.asarray(a, jnp.int32) for a in
        (meta["startsY"], meta["startsX"], effY, effX)), padded)


def assemble_rms_host(cellRMS, ny, nx, gridSize_pix, overlap_pix=None):
    """Host (numpy) expansion of a per-cell RMS grid to full resolution,
    numerically identical to the device ``_assemble_rms`` path.  Used by
    the batched engine: downloading the cell grid and expanding here is
    ~4 orders of magnitude less transfer than downloading the full map.
    """
    cellRMS = np.asarray(cellRMS)
    nCy, nCx = cellRMS.shape
    gridSize = int(gridSize_pix)
    ov = int(gridSize // 2) if overlap_pix is None else int(overlap_pix)
    ye = cell_edges(ny, gridSize)
    xe = cell_edges(nx, gridSize)
    ry0, vy0, ry1, vy1 = _expansion_plan(ye, nCy, ny, ov)
    rx0, vx0, rx1, vx1 = _expansion_plan(xe, nCx, nx, ov)

    def expand(reps_y, reps_x):
        up = np.repeat(cellRMS, reps_y, axis=0)
        return np.repeat(up, reps_x, axis=1)

    out = np.zeros((ny, nx), dtype=cellRMS.dtype)
    for reps_y, vy, reps_x, vx in ((ry1, vy1, rx1, vx1),
                                   (ry1, vy1, rx0, vx0),
                                   (ry0, vy0, rx1, vx1),
                                   (ry0, vy0, rx0, vx0)):
        v = expand(reps_y, reps_x)
        ok = vy[:, None] & vx[None, :] & (v > 0)
        out[ok] = v[ok]
    return out


def n_cells(n, gridSize):
    """Cell count along one axis of an n-pixel tile (cell_edges' chunking;
    a tile smaller than one grid cell degenerates to a single cell)."""
    return max(len(cell_edges(int(n), int(gridSize))) - 1, 1)


def meta_window(gridSize_pix, padShape, overlap_pix=None):
    """Static (Wy, Wx, ov) window bounds for the per-tile (meta)
    estimator.

    linspace integer cell edges over any n <= padN give max cell size
    <= min(padN, 2g) (for n >= 2g the bound is n*g/(n-g) <= 2g,
    decreasing in n; below 2g the single cell spans n itself), so one
    compiled window size covers every true tile shape a padShape bucket
    can hold."""
    g = int(gridSize_pix)
    ov = g // 2 if overlap_pix is None else int(overlap_pix)
    wy = min(int(padShape[0]), 2 * g) + 2 * ov
    wx = min(int(padShape[1]), 2 * g) + 2 * ov
    return wy, wx, ov


def cell_meta(shape, padShape, gridSize_pix, overlap_pix=None):
    """Per-tile noise-cell geometry at the tile's TRUE shape, padded to
    the static bounds implied by ``padShape``.

    The batched engine estimates noise inside a step compiled once per
    padded shape, but the reference (and the host engine) lay the grid
    out on the true tile shape - cell edges are linspace fractions of the
    tile dims (``filters.py:417-422``), so padded-shape edges disagree
    with host edges by ~1% in RMS everywhere.  Shipping each tile's
    true-shape geometry as DATA keeps one compile per padShape while
    making the batched noise maps EXACTLY the host engine's.

    Returns a dict of numpy arrays (stack over tiles, pass as ``meta`` to
    :func:`grid_rms_map_batch` / feed :func:`_assemble_rms_meta`):
      startsY/startsX/lensY/lensX: (nCellMax,) int32 flattened write-order
          cell anchors/extents (0-length = unused slot);
      c0y/c1y: (padNy,) int32 per-pixel highest/runner-up candidate cell
          row (-1 = none, incl. all padding rows); c0x/c1x likewise.
    """
    g = int(gridSize_pix)
    Wy, Wx, ov = meta_window(g, padShape, overlap_pix)
    ny, nx = int(shape[0]), int(shape[1])
    pNy, pNx = int(padShape[0]), int(padShape[1])
    nCyM, nCxM = n_cells(pNy, g), n_cells(pNx, g)

    def axis(n, npad, nCM, W):
        e = cell_edges(n, g)
        if len(e) < 2:
            e = np.array([0, n], dtype=int)
        nC = len(e) - 1
        if nC > nCM or (np.diff(e).max() + 2 * ov) > W:
            raise ValueError(
                "tile shape %r incompatible with the cell bounds of "
                "padShape %r (gridSize %d)" % (tuple(shape),
                                               tuple(padShape), g))
        starts = np.zeros(nCM, np.int32)
        lens = np.zeros(nCM, np.int32)
        starts[:nC] = e[:-1]
        lens[:nC] = np.diff(e)
        pix = np.arange(n)
        c0 = np.full(n, -1)
        c1 = np.full(n, -1)
        for i in range(nC):
            cover = (pix >= e[i] - ov) & (pix < e[i + 1] + ov)
            c1[cover] = c0[cover]
            c0[cover] = i
        c0p = np.full(npad, -1, np.int32)
        c1p = np.full(npad, -1, np.int32)
        c0p[:n] = c0
        c1p[:n] = c1
        return starts, lens, c0p, c1p

    sy, ly, c0y, c1y = axis(ny, pNy, nCyM, Wy)
    sx, lx, c0x, c1x = axis(nx, pNx, nCxM, Wx)
    startsY = np.repeat(sy, nCxM)
    startsX = np.tile(sx, nCyM)
    lensY = np.repeat(ly, nCxM)
    lensX = np.tile(lx, nCyM)
    unused = (lensY == 0) | (lensX == 0)
    lensY[unused] = 0
    lensX[unused] = 0
    return {"startsY": startsY.astype(np.int32),
            "startsX": startsX.astype(np.int32),
            "lensY": lensY.astype(np.int32),
            "lensX": lensX.astype(np.int32),
            "c0y": c0y, "c1y": c1y, "c0x": c0x, "c1x": c1x}


def cell_meta_batch(shapes, padShape, gridSize_pix, overlap_pix=None):
    """Stacked :func:`cell_meta` for a tile batch.

    Args:
        shapes: sequence of per-tile TRUE (ny, nx) shapes.
        padShape: the common padded shape of the device batch.
    Returns:
        dict of (nT, ...) numpy arrays, ready to pass as ``meta``.
    """
    cache = {}
    metas = []
    for s in shapes:
        key = (int(s[0]), int(s[1]))
        if key not in cache:
            cache[key] = cell_meta(key, padShape, gridSize_pix,
                                   overlap_pix)
        metas.append(cache[key])
    return {k: np.stack([m[k] for m in metas]) for k in metas[0]}


def _assemble_rms_meta(cells, c0y, c1y, c0x, c1x):
    """Expand one tile's (nCy, nCx) cell grid to the padded pixel grid
    with traced per-pixel candidate indices, reproducing _assemble_rms'
    overwrite priority ((r0,c0) > (r0,c1) > (r1,c0) > (r1,c1); a zero
    cell exposes the next candidate).  One-hot matmuls instead of
    gathers, exact because each row sums one product v*1 - at HIGHEST
    precision, since a TF32 product would round v to 10 mantissa bits."""
    nCy, nCx = cells.shape

    def onehot(c, nC):
        # -1 (no candidate / padding pixel) gives an all-zero row
        return (c[:, None] == jnp.arange(nC, dtype=c.dtype)[None, :]
                ).astype(cells.dtype)

    Ry0, Ry1 = onehot(c0y, nCy), onehot(c1y, nCy)
    Cx0, Cx1 = onehot(c0x, nCx), onehot(c1x, nCx)
    out = jnp.zeros((c0y.shape[0], c0x.shape[0]), cells.dtype)
    for Ry, Cx in ((Ry1, Cx1), (Ry1, Cx0), (Ry0, Cx1), (Ry0, Cx0)):
        v = jnp.matmul(jnp.matmul(Ry, cells, precision=_HIGHEST), Cx.T,
                       precision=_HIGHEST)
        ok = (v > 0)
        out = jnp.where(ok, v, out)
    return out


def _grid_rms_cells_xla_meta(mapBatch, meta, window, ov, n_iter=10,
                             estimator="default"):
    """XLA path of the per-tile-geometry estimator: vmapped
    dynamic_slice window gathers with traced per-tile anchors."""
    Wy, Wx = window

    def one(m, sy, sx, ly, lx):
        padded = jnp.pad(m, ((ov, Wy), (ov, Wx)))

        def gather(s_y, s_x):
            return jax.lax.dynamic_slice(padded, (s_y, s_x), (Wy, Wx))

        windows = jax.vmap(gather)(sy, sx)
        iy = jnp.arange(Wy)[None, :, None]
        ix = jnp.arange(Wx)[None, None, :]
        # unused cell slots (len 0) must mask out entirely, not keep the
        # 2*ov overlap margin
        eff_y = jnp.where(ly > 0, ly + 2 * ov, 0)
        eff_x = jnp.where(lx > 0, lx + 2 * ov, 0)
        in_cell = (iy < eff_y[:, None, None]) & (ix < eff_x[:, None, None])
        flat = windows.reshape(windows.shape[0], -1)
        valid = jnp.logical_and(windows != 0, in_cell).reshape(
            windows.shape[0], -1)
        return _cell_stats(flat, valid, (Wy, Wx), n_iter, estimator)

    return jax.vmap(one)(mapBatch, meta["startsY"], meta["startsX"],
                         meta["lensY"], meta["lensX"])


def grid_rms_map_batch(mapBatch, gridSize_pix, overlap_pix=None,
                       impl="auto", interpret=False, return_cells=False,
                       meta=None):
    """Batched noise-map estimation (nT, ny, nx) -> (nT, ny, nx), through
    XLA's gathers ('xla') or the fused Pallas Triton kernel ('triton');
    'auto' takes the backend's decision row.
    With ``return_cells`` the (nT, nCy, nCx) per-cell grid is returned
    instead (expand with :func:`assemble_rms_host`).

    ``meta`` (dict of stacked (nT, ...) arrays from :func:`cell_meta`)
    switches the cell geometry to each tile's TRUE shape (host-engine
    exact) while the compiled program stays a function of the padded
    shape only; without it the grid is laid out on ``mapBatch``'s own
    (padded) shape."""
    mapBatch = jnp.asarray(mapBatch)
    if mapBatch.ndim == 2:
        mapBatch = mapBatch[None]
    nT, ny, nx = mapBatch.shape
    gridSize = int(gridSize_pix)
    if impl == "auto":
        impl = platform.choices().rms_impl
    if impl not in ("xla", "triton"):
        raise ValueError("unknown RMS implementation %r" % (impl,))

    if meta is None and impl == "xla":
        return jax.vmap(lambda m: grid_rms_map(m, gridSize_pix,
                                               overlap_pix=overlap_pix,
                                               return_cells=return_cells))(
            mapBatch)
    if meta is None:
        meta = {k: jnp.asarray(v) for k, v in cell_meta_batch(
            [(ny, nx)] * nT, (ny, nx), gridSize, overlap_pix).items()}

    Wy, Wx, ov = meta_window(gridSize, (ny, nx), overlap_pix)
    nCy, nCx = n_cells(ny, gridSize), n_cells(nx, gridSize)
    if impl == "xla":
        cellRMS = _grid_rms_cells_xla_meta(mapBatch, meta, (Wy, Wx), ov)
    else:
        cellRMS = _grid_rms_cells_triton(mapBatch, meta, (Wy, Wx), ov,
                                         interpret=interpret)
    cellRMS = cellRMS.reshape(nT, nCy, nCx)
    if return_cells:
        return cellRMS
    return jax.vmap(_assemble_rms_meta)(cellRMS, meta["c0y"], meta["c1y"],
                                        meta["c0x"], meta["c1x"])
