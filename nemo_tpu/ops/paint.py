"""Radial-profile object painting on the device.

Replaces pixell ``pointsrcs.sim_objects`` (used via
``nemo/signals.py:_paintSignalMap``, ``signals.py:622-672``): objects with a
common 1-d radial profile are splatted at sub-pixel positions by evaluating
the profile on the exact angular distance grid of a bounded window around
each object, then scatter-added into the canvas.

Design notes: the window size is static (derived from ``rmax``), so the
per-object work is a fixed-shape distance map + 1-d table lookup
(jnp.interp) + dynamic_update_slice accumulation inside ``lax.scan``. The
canvas is padded by one window so slice starts never clamp.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("shape",))
def _paint_centered_jit(shape, scales, center, rp, vp):
    ny, nx = shape
    dtype = rp.dtype
    yy = (jnp.arange(ny, dtype=dtype) - center[0]) * scales[0]
    xx = (jnp.arange(nx, dtype=dtype) - center[1]) * scales[1]
    r = jnp.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
    return jnp.interp(r, rp, vp, left=vp[0], right=0.0)


def _pad_table(rp, vp, dtype, size=None):
    """Pad a radial table to a bucketed length so the jitted painter
    compiles once per (shape, table-bucket), not once per table length.
    Padding appends strictly-increasing radii far beyond any map with
    zero values - jnp.interp then returns 0 there, identical to the
    unpadded right=0 behaviour."""
    n = len(rp)
    if size is None:
        size = _table_bucket(n)
    rpad = np.empty(size, dtype=dtype)
    vpad = np.zeros(size, dtype=dtype)
    rpad[:n] = rp
    vpad[:n] = vp
    # First pad point sits immediately after the table end so the
    # interpolation drops to zero within a negligible radius step,
    # matching the unpadded right=0 cutoff; the rest march upward to
    # keep the radii strictly increasing.
    relStep = 1e-6 if dtype == np.float32 else 1e-9
    eps = abs(rp[-1]) * relStep + 1e-30
    rpad[n:] = rp[-1] + eps * np.arange(1, size - n + 1)
    return rpad, vpad


def _table_bucket(n):
    """Power-of-two bucket size with >= 1 pad slot (the zero landing)."""
    size = 256
    while size < n + 1:
        size *= 2
    return size


@functools.partial(jax.jit, static_argnames=("shape",))
def _paint_centered_batch_jit(shape, scales, center, rps, vps):
    ny, nx = shape
    dtype = rps.dtype
    yy = (jnp.arange(ny, dtype=dtype) - center[0]) * scales[0]
    xx = (jnp.arange(nx, dtype=dtype) - center[1]) * scales[1]
    r = jnp.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)
    return jax.vmap(lambda rp, vp: jnp.interp(r, rp, vp, left=vp[0],
                                              right=0.0))(rps, vps)


def paint_templates_centered_batch(shape, pix_scales_rad, tables,
                                   center=None, dtype=jnp.float64):
    """Paint a batch of centred radial profiles in ONE device dispatch.

    fitQ paints ~55 model templates x n_freq per tile geometry
    (reference ``signals.py:969-1060``); one dispatch per chunk instead
    of one per template.  All
    tables are padded to a common power-of-two bucket, so one compiled
    program serves every chunk; the shared distance grid is computed
    once per call.

    Args:
        shape: (ny, nx).
        pix_scales_rad: (dy, dx) radians/pixel at tile centre.
        tables: sequence of (r_prof, v_prof) pairs (radians -> amplitude;
            zero outside the table, splev ext=1 semantics).
        center: optional float (cy, cx); default (ny/2, nx/2).

    Returns:
        (len(tables), ny, nx) device array.
    """
    ny, nx = shape
    if center is None:
        center = (ny / 2.0, nx / 2.0)
    npDtype = np.dtype(jax.dtypes.canonicalize_dtype(dtype))
    size = _table_bucket(max(len(r) for r, _ in tables))
    padded = [_pad_table(np.asarray(r), np.asarray(v), npDtype, size=size)
              for r, v in tables]
    rps = np.stack([p[0] for p in padded])
    vps = np.stack([p[1] for p in padded])
    return _paint_centered_batch_jit(
        (int(ny), int(nx)),
        jnp.asarray(np.asarray(pix_scales_rad, dtype=npDtype)),
        jnp.asarray(np.asarray(center, dtype=npDtype)),
        jnp.asarray(rps), jnp.asarray(vps))


def paint_template_centered(shape, pix_scales_rad, r_prof, v_prof,
                            center=None, dtype=jnp.float64):
    """Paint one unit-amplitude radial profile centred on the map.

    Used for building filter signal templates (the reference centres these
    at the map centre coords, ``nemo/filters.py:1244``).  One fused jitted
    dispatch with the pixel scales, centre and profile table as dynamic
    arguments: survey tiles at different declinations (different pixel
    scales) reuse the same compiled program instead of recompiling per
    declination band.

    Args:
        shape: (ny, nx).
        pix_scales_rad: (dy, dx) radians/pixel at tile centre.
        r_prof, v_prof: radial profile table (radians -> amplitude); values
            outside the table are zero (splev ext=1 semantics).
        center: optional float (cy, cx) pixel coords; default (ny/2, nx/2).
    """
    ny, nx = shape
    if center is None:
        center = (ny / 2.0, nx / 2.0)
    npDtype = np.dtype(jax.dtypes.canonicalize_dtype(dtype))
    rp, vp = _pad_table(np.asarray(r_prof), np.asarray(v_prof), npDtype)
    return _paint_centered_jit(
        (int(ny), int(nx)),
        jnp.asarray(np.asarray(pix_scales_rad, dtype=npDtype)),
        jnp.asarray(np.asarray(center, dtype=npDtype)),
        jnp.asarray(rp), jnp.asarray(vp))


@functools.partial(jax.jit, static_argnames=("shape", "window_pix"))
def _paint_scan(shape, window_pix, ys, xs, amps, rp, vp, dy, dx_pad):
    ny, nx = shape
    wy, wx = window_pix
    dtype = rp.dtype
    canvas = jnp.zeros((ny + 2 * wy + 2, nx + 2 * wx + 2), dtype=dtype)

    iy_off = jnp.arange(2 * wy + 1, dtype=dtype)
    ix_off = jnp.arange(2 * wx + 1, dtype=dtype)

    def body(canvas, obj):
        y, x, amp = obj
        y0 = jnp.floor(y).astype(jnp.int32) - wy
        x0 = jnp.floor(x).astype(jnp.int32) - wx
        yy = (y0.astype(dtype) + iy_off - y) * dy
        # per-ROW x scale (cos(dec) on CAR): gather the window's rows -
        # the same dec-correct angular distances the reference gets from
        # astCoords.calcAngSepDeg painting (nemo/maps.py:1884-1892)
        dxw = jax.lax.dynamic_slice(dx_pad, (y0 + wy + 1,),
                                    (2 * wy + 1,))
        xx = (x0.astype(dtype) + ix_off - x)
        r = jnp.sqrt(yy[:, None] ** 2
                     + (dxw[:, None] * xx[None, :]) ** 2)
        vals = amp * jnp.interp(r, rp, vp, left=vp[0], right=0.0)
        sl = jax.lax.dynamic_slice(
            canvas, (y0 + wy + 1, x0 + wx + 1), (2 * wy + 1, 2 * wx + 1))
        canvas = jax.lax.dynamic_update_slice(
            canvas, sl + vals, (y0 + wy + 1, x0 + wx + 1))
        return canvas, None

    objs = jnp.stack([ys.astype(dtype), xs.astype(dtype),
                      amps.astype(dtype)], axis=-1)
    canvas, _ = jax.lax.scan(body, canvas, objs)
    return canvas[wy + 1:wy + 1 + ny, wx + 1:wx + 1 + nx]


def paint_objects(shape, pix_scales_rad, ys, xs, amps, r_prof, v_prof,
                  rmax_rad, dtype=np.float64, dx_rows=None):
    """Paint many objects sharing a radial profile into a (ny, nx) canvas.

    Args:
        ys, xs: float 0-based pixel coords of object centres (must lie
            within the map; callers pre-filter, as the reference does via
            ``catalogs.getCatalogWithinImage``).
        amps: per-object peak amplitudes.
        r_prof, v_prof: shared radial profile table (unit peak, radians).
        rmax_rad: truncation radius; sets the static window size.
        dx_rows: optional (ny,) per-row x pixel scales in radians
            (``maps.pixScaleXRadPerRow``) - dec-aware painting on CAR
            grids, where dx varies as cos(dec) across the map.  Without
            it the scalar ``pix_scales_rad[1]`` is used for every row
            (exact only near the tile centre's declination).
    Returns:
        (ny, nx) jnp array.
    """
    ny, nx = shape
    dy, dx = pix_scales_rad
    npDtype = np.dtype(jax.dtypes.canonicalize_dtype(dtype))
    if dx_rows is None:
        dxr = np.full(ny, dx, dtype=npDtype)
    else:
        dxr = np.asarray(dx_rows, dtype=npDtype)
        if dxr.shape != (ny,):
            raise ValueError("dx_rows must have shape (ny,)")
    wy = int(np.ceil(rmax_rad / dy))
    wx = int(np.ceil(rmax_rad / float(dxr.min())))
    # Cap the window at the canvas size (a window larger than the map just
    # wastes compute - contributions outside the map are cropped anyway).
    wy = min(wy, ny)
    wx = min(wx, nx)
    # dx per padded-canvas row, edge rows replicated (objects are inside
    # the map; only their window borders reach the padding)
    dx_pad = np.empty(ny + 2 * wy + 2, dtype=npDtype)
    dx_pad[wy + 1:wy + 1 + ny] = dxr
    dx_pad[:wy + 1] = dxr[0]
    dx_pad[wy + 1 + ny:] = dxr[-1]
    ys = jnp.atleast_1d(jnp.asarray(np.asarray(ys, dtype=npDtype)))
    xs = jnp.atleast_1d(jnp.asarray(np.asarray(xs, dtype=npDtype)))
    amps = jnp.broadcast_to(
        jnp.atleast_1d(jnp.asarray(np.asarray(amps, dtype=npDtype))),
        ys.shape)
    # Zero the profile beyond rmax (splev ext=1 semantics via right=0 covers
    # beyond-table; enforce rmax inside the table too).
    r_prof = np.asarray(r_prof, dtype=npDtype)
    v_prof = np.where(r_prof <= rmax_rad,
                      np.asarray(v_prof, dtype=npDtype), 0.0)
    return _paint_scan((ny, nx), (wy, wx), ys, xs, amps,
                       jnp.asarray(r_prof), jnp.asarray(v_prof),
                       jnp.asarray(npDtype.type(dy)),
                       jnp.asarray(dx_pad))
