"""Flat-sky Fourier primitives (JAX).

These replace the pixell calls the reference leans on for its hot path:
``enmap.fft/ifft`` (``nemo/filters.py:526-529,851``), ``enmap.apod``
(``filters.py:528``), ``enmap.apply_window`` (``filters.py:103,647``),
``enmap.modlmap``/``laxes`` (``filters.py:275,810``).

Conventions:

* ``fft2``/``ifft2`` are plain unnormalised transforms over the last two
  axes (forward = jnp.fft.fft2).  The matched-filter normalisation is fixed
  by an explicit signal-calibration step (as in the reference,
  ``filters.py:635-690``), so only internal consistency matters.
* The pixel window is the separable sinc in cycles-per-pixel units,
  matching pixell's ``enmap.calc_window`` exactly.
* ``apod`` is the cosine taper of ``enmap.apod``: the first/last ``width``
  pixels of each axis ramp smoothly from 0 at the edge to 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np


# NOTE: all transforms are jitted rather than eager, and the pipeline uses
# REAL transforms exclusively: every map in this problem is real, and
# rfft2 does half the work of fft2.
@jax.jit
def fft2(m):
    """Unnormalised 2-d FFT over the last two axes (complex output, full
    grid).  Prefer rfft2 for real maps; kept for generic callers/tests."""
    return jnp.fft.fft2(m)


@jax.jit
def ifft2(fm):
    """Inverse of :func:`fft2` (numpy normalisation: ifft(fft(x)) == x)."""
    return jnp.fft.ifft2(fm)


@jax.jit
def rfft2(m):
    """Real-input 2-d FFT over the last two axes (half grid)."""
    return jnp.fft.rfft2(m)


@functools.partial(jax.jit, static_argnames=("s",))
def irfft2(fm, s):
    """Inverse of :func:`rfft2` back to a real (s[0], s[1]) map."""
    return jnp.fft.irfft2(fm, s=s)


@functools.lru_cache(maxsize=64)
def _apod_profile(n, width):
    prof = np.ones(n)
    if width > 0:
        ramp = (1 - np.cos(np.linspace(0, np.pi, width))) / 2
        prof[:width] = ramp
        prof[-width:] = ramp[::-1]
    return prof


def apod_mask(shape, width):
    """2-d cosine apodisation window for a map of the given (ny, nx) shape."""
    ny, nx = shape[-2], shape[-1]
    wy = _apod_profile(ny, int(width))
    wx = _apod_profile(nx, int(width))
    return jnp.asarray(wy[:, None] * wx[None, :])


def apod(m, width):
    """Apply the cosine edge taper (pixell ``enmap.apod`` equivalent)."""
    return m * apod_mask(m.shape, width).astype(m.dtype)


@functools.lru_cache(maxsize=64)
def _window_1d(n):
    return np.sinc(np.fft.fftfreq(n))


def pixel_window(shape, pow=1.0):
    """2-d separable pixel window W(ly, lx)^pow on the full FFT grid.

    Matches pixell ``enmap.calc_window``: sinc in cycles/pixel.
    """
    ny, nx = shape[-2], shape[-1]
    wy = _window_1d(ny) ** pow
    wx = _window_1d(nx) ** pow
    return jnp.asarray(wy[:, None] * wx[None, :])


@functools.lru_cache(maxsize=64)
def _window_half_1d(ny, nx, pow):
    wy = _window_1d(ny) ** pow
    wx = np.sinc(np.fft.rfftfreq(nx)) ** pow
    return wy, wx


def _window_half_2d(ny, nx, pow):
    wy, wx = _window_half_1d(ny, nx, pow)
    return wy[:, None] * wx[None, :]


@functools.partial(jax.jit, static_argnames=("pow",))
def apply_pixel_window(m, pow=1.0):
    """Multiply/divide out the map pixel window in Fourier space
    (pixell ``enmap.apply_window`` equivalent, ``nemo/filters.py:103``).
    Real transforms on the half grid.  The separable window is formed
    in-graph from two 1-d vectors so the compiled program embeds O(n)
    constants, not an O(ny*nx) 2-d table (survey-scale maps would bake a
    GB-sized constant into the program)."""
    ny, nx = m.shape[-2], m.shape[-1]
    fm = jnp.fft.rfft2(m)
    wy, wx = _window_half_1d(ny, nx, pow)
    w2d = jnp.asarray(wy)[:, None] * jnp.asarray(wx)[None, :]
    fm = fm * w2d.astype(fm.dtype)
    return jnp.fft.irfft2(fm, s=(ny, nx))


def windowed_irfft2(G, y0, x0, ny, nx, wlen):
    """Evaluate ``irfft2(G, s=(ny, nx))`` on a ``wlen x wlen`` window
    anchored at traced integer offsets ``(y0, x0)`` - WITHOUT the full
    inverse transform.

    The window is computed as two small complex matmuls against DFT
    basis vectors (backward normalisation, matching ``jnp.fft.irfft2``),
    with the Hermitian half-grid's interior-column double-count weight.
    Used for the matched-filter calibration read: the tiny window is all
    the host needs, the matmuls are small, and the formulation avoids
    a full-map irfft2 intermediate that XLA has twice been caught
    miscompiling when fused with the rest of the step (see the
    signal-norm notes in ``parallel/distribute.py one_tile``).

    Args:
        G: (..., ny, nx//2+1) complex half-grid spectra.
        y0, x0: window origin (traced scalars OK).
        ny, nx: full-grid shape (static).
        wlen: window size (static).

    Returns:
        (..., wlen, wlen) real window values.
    """
    nxh = G.shape[-1]
    cdtype = G.dtype
    rdtype = jnp.finfo(jnp.zeros((), dtype=float).dtype).dtype
    ky = jnp.arange(ny, dtype=rdtype)
    kx = jnp.arange(nxh, dtype=rdtype)
    # interior half-grid columns appear twice in the full spectrum
    wx = jnp.where((kx == 0) | ((nx % 2 == 0) & (kx == nx // 2)),
                   1.0, 2.0).astype(rdtype)
    xs = x0 + jnp.arange(wlen, dtype=y0.dtype if hasattr(y0, "dtype")
                         else jnp.int32)
    ys = y0 + jnp.arange(wlen, dtype=x0.dtype if hasattr(x0, "dtype")
                         else jnp.int32)
    ex = jnp.exp((2j * jnp.pi / nx)
                 * kx[:, None] * xs[None, :].astype(rdtype)) \
        * wx[:, None]
    ey = jnp.exp((2j * jnp.pi / ny)
                 * ky[:, None] * ys[None, :].astype(rdtype))
    hi = jax.lax.Precision.HIGHEST
    M1 = jnp.einsum("...yk,kw->...yw", G, ex.astype(cdtype), precision=hi)
    out = jnp.einsum("yv,...yw->...vw", ey.astype(cdtype), M1, precision=hi)
    return jnp.real(out) / (ny * nx)


def rmodlmap_graph(shape, pix_scales_rad):
    """|l| on the rfft half grid, computed in-graph from 1-d axes (use
    inside jitted code instead of :func:`rmodlmap` to avoid baking a 2-d
    constant into the executable)."""
    ly, lx = rlaxes(shape, pix_scales_rad)
    return jnp.sqrt(jnp.asarray(ly)[:, None] ** 2
                    + jnp.asarray(lx)[None, :] ** 2)


@functools.lru_cache(maxsize=64)
def rlaxes(shape, pix_scales_rad):
    """(ly, lx) for the rfft half grid: ly in fftfreq order, lx ascending."""
    ny, nx = shape[-2], shape[-1]
    dy, dx = pix_scales_rad
    ly = 2 * np.pi * np.fft.fftfreq(ny, d=dy)
    lx = 2 * np.pi * np.fft.rfftfreq(nx, d=dx)
    return ly, lx


@functools.lru_cache(maxsize=64)
def rmodlmap(shape, pix_scales_rad):
    """|l| on the rfft half grid."""
    ly, lx = rlaxes(shape, pix_scales_rad)
    return np.sqrt(ly[:, None] ** 2 + lx[None, :] ** 2)


@functools.lru_cache(maxsize=64)
def laxes(shape, pix_scales_rad):
    """Angular wavenumber axes (ly, lx) for a tile.

    Args:
        shape: (ny, nx).
        pix_scales_rad: (dy, dx) pixel scales in radians (evaluated at the
            tile centre, as the reference does in ``MapFilter.makeRadiansMap``).
    Returns:
        (ly, lx) numpy arrays in fftfreq ordering.
    """
    ny, nx = shape[-2], shape[-1]
    dy, dx = pix_scales_rad
    ly = 2 * np.pi * np.fft.fftfreq(ny, d=dy)
    lx = 2 * np.pi * np.fft.fftfreq(nx, d=dx)
    return ly, lx


@functools.lru_cache(maxsize=64)
def modlmap(shape, pix_scales_rad):
    """|l| on the 2-d FFT grid (pixell ``enmap.modlmap`` equivalent)."""
    ly, lx = laxes(shape, pix_scales_rad)
    return np.sqrt(ly[:, None] ** 2 + lx[None, :] ** 2)


def fourier_shift_phase(shape, pix_scales_rad, dy_pix, dx_pix):
    """exp(-i (ly*dy + lx*dx)) phase ramp implementing a continuous shift by
    (dy_pix, dx_pix) pixels; used to centre analytic templates."""
    ny, nx = shape[-2], shape[-1]
    fy = jnp.fft.fftfreq(ny)
    fx = jnp.fft.fftfreq(nx)
    phase = jnp.exp(-2j * jnp.pi * (fy[:, None] * dy_pix + fx[None, :] * dx_pix))
    return phase


def radial_distance_map(shape, pix_scales_rad, center=None):
    """Map of angular distance (radians) from a reference point.

    Replicates ``MapFilter.makeRadiansMap`` (``nemo/filters.py:214-239``):
    flat-sky distances with x/y pixel scales fixed at the map centre, centre
    pixel at (floor coords of) shape/2.
    """
    ny, nx = shape[-2], shape[-1]
    dy, dx = pix_scales_rad
    if center is None:
        cy, cx = ny // 2, nx // 2
    else:
        cy, cx = center
    yy = (np.arange(ny) - cy) * dy
    xx = (np.arange(nx) - cx) * dx
    return np.sqrt(yy[:, None] ** 2 + xx[None, :] ** 2)


@functools.lru_cache(maxsize=512)
def good_fft_size(n):
    """Smallest 5-smooth (2^a 3^b 5^c) integer >= n.

    FFTs of sizes with large prime factors are slow (Bluestein's
    algorithm or worse); survey tiles have arbitrary sizes
    (e.g. the quickstart tile is 1031 x 1032, and 1031 is prime), so maps
    are zero-padded to smooth sizes before transforming.  Padding also
    buckets ragged autotiler tiles onto far fewer distinct shapes, slashing
    recompilation.
    """
    best = None
    p2 = 1
    while p2 < 2 * n:
        p23 = p2
        while p23 < 2 * n:
            p235 = p23
            while p235 < n:
                p235 *= 5
            if best is None or p235 < best:
                best = p235
            p23 *= 3
        p2 *= 2
    return int(best)


def pad_to(m, shape):
    """Zero-pad the last two axes up to `shape` (at the high ends, so pixel
    coordinates of existing content are unchanged)."""
    ny, nx = m.shape[-2], m.shape[-1]
    py, px = shape
    if (py, px) == (ny, nx):
        return m
    pad = [(0, 0)] * (m.ndim - 2) + [(0, py - ny), (0, px - nx)]
    return jnp.pad(m, pad)


def crop_to(m, shape):
    """Crop the last two axes down to `shape` (inverse of pad_to)."""
    return m[..., :shape[0], :shape[1]]
