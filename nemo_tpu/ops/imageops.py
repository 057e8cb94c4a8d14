"""Image-space operators with scipy.ndimage-parity semantics, in JAX.

The reference uses scipy.ndimage for noise-covariance smoothing
(``gaussian_filter``, ``nemo/filters.py:583``), edge trimming
(``rank_filter`` rank 0 == minimum filter, ``filters.py:737``), real-space
kernel convolution (``ndimage.convolve``, ``filters.py:1201``) and mask
dilation (``mahotas.dilate``, ``nemo/maps.py:256``).  These run on the
device here, vectorised over batched tiles; each is tested for numerical
parity against scipy on the CPU backend.  Convolutions ask for HIGHEST
precision so that float32 inputs are not rounded to TF32 on the GPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=32)
def _gaussian_weights(sigma, truncate=4.0):
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    w /= w.sum()
    return w, radius


def _correlate1d_reflect(m, weights, radius, axis):
    """1-d correlation along ``axis`` with scipy's 'reflect' boundary
    (numpy 'symmetric')."""
    pad = [(0, 0)] * m.ndim
    pad[axis] = (radius, radius)
    padded = jnp.pad(m, pad, mode="symmetric")
    w = jnp.asarray(weights, dtype=m.dtype)
    # Move target axis last, flatten the rest, use conv over one spatial dim
    moved = jnp.moveaxis(padded, axis, -1)
    lead_shape = moved.shape[:-1]
    flat = moved.reshape((-1, 1, moved.shape[-1]))
    kern = w[::-1].reshape((1, 1, -1))  # correlation via flipped convolution
    out = jax.lax.conv_general_dilated(
        flat, kern, window_strides=(1,), padding="VALID", precision=_HIGHEST)
    out = out.reshape(lead_shape + (out.shape[-1],))
    return jnp.moveaxis(out, -1, axis)


def gaussian_filter(m, sigma, truncate=4.0):
    """scipy.ndimage.gaussian_filter parity (mode='reflect').

    ``sigma`` may be a scalar or per-axis (sy, sx) for the last two axes.
    """
    if np.isscalar(sigma):
        sigma = (sigma, sigma)
    sy, sx = sigma
    out = m
    if sy > 0:
        wy, ry = _gaussian_weights(float(sy), truncate)
        out = _correlate1d_reflect(out, wy, ry, axis=out.ndim - 2)
    if sx > 0:
        wx, rx = _gaussian_weights(float(sx), truncate)
        out = _correlate1d_reflect(out, wx, rx, axis=out.ndim - 1)
    return out


def hermitian_extend(half, nxFull):
    """Reconstruct the FULL (unshifted-layout) Fourier grid of a real
    map's power/covariance from its rfft half grid.

    For real input, F(-k) = conj(F(k)), so any product Re(F_i conj F_j)
    satisfies full[ky, nx - j] = full[(-ky) % ny, j].  The missing columns
    j = ncol..nx-1 are therefore the ky-flipped mirror of columns
    nx-ncol..1.  Exact for covariances of real maps and for any
    |l|-symmetric power (e.g. a CMB C_l floor).
    """
    ncol = half.shape[-1]
    src = half[..., :, 1:nxFull - ncol + 1]          # columns 1..nx-ncol
    # ky-flip: out[ky] = in[(-ky) % ny] == roll(reverse(in), 1)
    mirror = jnp.roll(src[..., ::-1, :], 1, axis=-2)[..., :, ::-1]
    return jnp.concatenate([half, mirror], axis=-1)


def gaussian_filter_rfft_fullgrid(half, sigma, nxFull, truncate=4.0):
    """Smooth an rfft-half-grid covariance EXACTLY as the reference smooths
    the full complex grid (``ndimage.gaussian_filter`` on the unshifted
    full layout, ``nemo/filters.py:583``): Hermitian-extend to the full
    grid, smooth with 'reflect' boundaries there, crop back.

    The naive alternative - reflect padding on the half grid itself -
    differs near the Nyquist column (an array edge on the half grid but
    interior on the full grid, where its neighbours are ky-flipped
    mirror columns).
    """
    ncol = half.shape[-1]
    full = hermitian_extend(half, nxFull)
    sm = gaussian_filter(full, sigma, truncate)
    return sm[..., :ncol]


def _sliding_extremum_1d(m, size, init, cummin_fn, axis):
    """van Herk / Gil-Werman sliding min (or max) along one axis: O(1) work
    per pixel independent of window size, via per-block prefix and suffix
    running extrema.  Out-of-bounds treated as ``init`` (equivalent to
    scipy 'reflect' for extremum filters)."""
    size = int(size)
    lo = size // 2
    n = m.shape[axis]
    m = jnp.moveaxis(m, axis, -1)
    lead = m.shape[:-1]
    # We need out[i] = extremum over padded[i .. i+size-1] where padded has
    # ``lo`` pad at the front. Pad the back so windows fit and the length
    # is a multiple of size.
    total = n + lo + size  # enough slack for the last window
    nblocks = -(-total // size)
    padded_len = nblocks * size
    pad_front = lo
    pad_back = padded_len - n - pad_front
    init_arr = jnp.array(init, dtype=m.dtype)
    x = jnp.pad(m, [(0, 0)] * (m.ndim - 1) + [(pad_front, pad_back)],
                constant_values=init)
    blocks = x.reshape(lead + (nblocks, size))
    last = blocks.ndim - 1
    prefix = cummin_fn(blocks, axis=last)
    suffix = cummin_fn(blocks[..., ::-1], axis=last)[..., ::-1]
    prefix = prefix.reshape(lead + (padded_len,))
    suffix = suffix.reshape(lead + (padded_len,))
    idx = jnp.arange(n)
    # window for out[i] in padded coords: [i, i + size - 1]
    out = jnp.minimum(suffix[..., idx], prefix[..., idx + size - 1]) \
        if cummin_fn is jax.lax.cummin else \
        jnp.maximum(suffix[..., idx], prefix[..., idx + size - 1])
    return jnp.moveaxis(out, -1, axis)


def _separable_rank_filter(m, size, op, init):
    """Rectangular min/max filters are separable (rows then columns); each
    1-d pass uses the van Herk algorithm, so total cost is O(1) per pixel
    regardless of window size.  This matters for the DR5 edge trim, whose
    windows are ~240 pixels (``nemo/filters.py:732-737``)."""
    cummin_fn = jax.lax.cummin if op is jax.lax.min else jax.lax.cummax
    out = _sliding_extremum_1d(m, size, init, cummin_fn, m.ndim - 2)
    out = _sliding_extremum_1d(out, size, init, cummin_fn, m.ndim - 1)
    return out


def minimum_filter(m, size):
    """scipy.ndimage.rank_filter(m, 0, size=(size, size)) parity.

    With 'reflect' boundaries a minimum filter is equivalent to ignoring
    out-of-bounds pixels, which reduce_window achieves by padding with +inf.
    Window centring matches scipy (origin 0): spans [i - size//2,
    i + size - 1 - size//2].
    """
    return _separable_rank_filter(m, size, jax.lax.min, jnp.inf)


def maximum_filter(m, size):
    """Max filter with the same centring conventions as minimum_filter."""
    return _separable_rank_filter(m, size, jax.lax.max, -jnp.inf)


def binary_dilate_cross(mask, iterations=1):
    """Binary dilation with a 3x3 cross (4-connectivity), like
    ``mahotas.dilate`` with its default structuring element
    (``nemo/maps.py:256``).  Runs as an unrolled 5-point max."""
    m = mask.astype(jnp.float32)

    def step(m, _):
        up = jnp.roll(m, -1, axis=-2).at[..., -1, :].set(0)
        down = jnp.roll(m, 1, axis=-2).at[..., 0, :].set(0)
        left = jnp.roll(m, -1, axis=-1).at[..., :, -1].set(0)
        right = jnp.roll(m, 1, axis=-1).at[..., :, 0].set(0)
        out = jnp.maximum(m, jnp.maximum(jnp.maximum(up, down),
                                         jnp.maximum(left, right)))
        return out, None

    m, _ = jax.lax.scan(step, m, None, length=iterations)
    return m > 0


def convolve2d_reflect(m, kernel):
    """scipy.ndimage.convolve parity (mode='reflect') for an odd-sized 2-d
    kernel.  Used by the real-space matched filter (``nemo/filters.py:1201``,
    whose kernels are forced to odd dimensions at ``filters.py:973-976``).

    For odd k, ndimage.convolve(input, W)[i] = sum_m W[m] input[i + k//2 - m],
    i.e. cross-correlation with the flipped kernel over a centred window.
    XLA's conv primitive computes cross-correlation, so we flip once.
    """
    ky, kx = kernel.shape
    if ky % 2 == 0 or kx % 2 == 0:
        raise ValueError("convolve2d_reflect requires odd-sized kernels")
    pad = [(0, 0)] * (m.ndim - 2) + [(ky // 2, ky // 2), (kx // 2, kx // 2)]
    padded = jnp.pad(m, pad, mode="symmetric")
    flat = padded.reshape((-1, 1) + padded.shape[-2:])
    kern = jnp.asarray(kernel, dtype=m.dtype)[::-1, ::-1][None, None]
    out = jax.lax.conv_general_dilated(flat, kern, window_strides=(1, 1),
                                       padding="VALID", precision=_HIGHEST)
    return out.reshape(m.shape[:-2] + out.shape[-2:])


def convolve2d_reflect_sum(m, kernels):
    """Multi-frequency real-space filter application: for maps ``m`` of
    shape (nf, ny, nx) and per-frequency kernels (nf, ky, kx), returns
    ``sum_f ndimage.convolve(m[f], kernels[f], mode='reflect')`` as one
    XLA conv (frequencies become input channels of a single-output-channel
    convolution, so the frequency sum fuses into the contraction).

    Exactly equals summing :func:`convolve2d_reflect` per frequency.
    """
    ky, kx = kernels.shape[-2:]
    if ky % 2 == 0 or kx % 2 == 0:
        raise ValueError("convolve2d_reflect_sum requires odd-sized kernels")
    pad = [(0, 0)] * (m.ndim - 2) + [(ky // 2, ky // 2), (kx // 2, kx // 2)]
    padded = jnp.pad(m, pad, mode="symmetric")
    lhs = padded[None]                                     # (1, nf, Y, X)
    rhs = jnp.asarray(kernels, dtype=m.dtype)[:, ::-1, ::-1][None]
    out = jax.lax.conv_general_dilated(lhs, rhs, window_strides=(1, 1),
                                       padding="VALID", precision=_HIGHEST)
    return out[0, 0]


def median_filter_host(m, size):
    """Host-side median filter (scipy), used only in per-tile preprocessing
    for hole filling (``nemo/maps.py:365``); not on the device hot path."""
    from scipy import ndimage
    return ndimage.median_filter(np.asarray(m), int(size))
