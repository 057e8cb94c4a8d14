"""Spherical-harmonic transforms on CAR iso-latitude rings, on the device.

The reference simulates full-survey skies with libsharp-backed curved-sky
transforms (``nemo/maps.py:1257`` ``curvedsky.rand_map``; the 1/f noise
path round-trips ``map2alm``/``alm2map`` at lmax 6000,
``nemo/maps.py:1326-1341``).  A CAR grid is a stack of iso-latitude rings
with uniform azimuth spacing, so the transform factorises the same way
libsharp's does:

    T(theta_r, phi_j) = Re sum_m (2 - delta_m0) F_m(theta_r) e^{i m phi_j}
    F_m(theta_r)      = sum_l a_lm lambda_lm(theta_r)

an FFT over m per ring plus an associated-Legendre contraction over l.
The Legendre part is evaluated by the standard three-term recurrence in l,
vectorised over (m, ring) - elementwise work that XLA fuses into a few
kernels per scan step.

Normalisation: orthonormal (healpy default) spherical harmonics with the
Condon-Shortley phase,

    lambda_mm   = -sqrt((2m+1)/(2m)) sin(theta) lambda_{m-1,m-1}
    lambda_l m  = a_lm (cos(theta) lambda_{l-1,m} - b_lm lambda_{l-2,m})
    a_lm = sqrt((4l^2-1)/(l^2-m^2)),  b_lm = sqrt(((l-1)^2-m^2)/(4(l-1)^2-1))

The diagonal seed lambda_mm = c_m sin^m(theta) underflows float64 beyond
m ~ 900 at survey colatitudes (sin(theta) >= 0.47 for dec -62..+22), so
the recurrence runs in scaled form: each (m, ring) lane carries a value
in [2^-64, 2^64] plus a power-of-two exponent, seeded exactly from
log2|lambda_mm| = lgc_m + m log2 sin(theta) and renormalised in 2^128
hops as the recurrence grows back toward O(1).  Contributions while the
exponent is still far below zero flush to zero - exactly the magnitude
of the terms they represent.
"""

import functools

import jax
import numpy as np

__all__ = ["alm2map_car", "map2alm_car", "rand_alm", "sim_cmb_map_curved",
           "sim_noise_map_curved", "legendre_rings", "ring_weights",
           "car_ring_geometry"]


# ---------------------------------------------------------------------------
# Host-side coefficient tables


def _lgc_table(mmax):
    """log2 of the diagonal amplitude c_m, where
    lambda_mm = (-1)^m c_m sin^m(theta):
    c_m = sqrt(1/4pi) * prod_{k=1..m} sqrt((2k+1)/(2k))."""
    k = np.arange(1, mmax + 1, dtype=np.float64)
    steps = 0.5 * np.log2((2 * k + 1) / (2 * k))
    lgc = np.empty(mmax + 1)
    lgc[0] = 0.5 * np.log2(1.0 / (4 * np.pi))
    lgc[1:] = lgc[0] + np.cumsum(steps)
    return lgc


# ---------------------------------------------------------------------------
# Core contraction: F_m(ring) = sum_l a_lm lambda_lm(theta_ring)


@functools.partial(
    __import__("jax").jit,
    static_argnames=("lmax", "mmax", "adjoint", "dtype"))
def _legendre_contract(thetas, alm_re, alm_im, lmax, mmax, adjoint=False,
                       weights=None, dtype=np.float32):
    """Scaled-recurrence Legendre contraction, scanned over l.

    Synthesis (``adjoint=False``): ``alm_*`` are (lmax+1, mmax+1) and the
    result is F (2, mmax+1, nrings) = sum_l alm[l] * lambda_lm(theta).

    Analysis (``adjoint=True``): ``alm_*`` are G (mmax+1, nrings) ring
    coefficients, ``weights`` the per-ring quadrature weights, and the
    result is alm (2, lmax+1, mmax+1) = sum_r w_r G[:, r] lambda_lm.
    """
    import jax
    import jax.numpy as jnp

    thetas = jnp.asarray(thetas, dtype=dtype)
    R = thetas.shape[0]
    M1 = mmax + 1
    ct = jnp.cos(thetas)[None, :]                      # (1, R)
    # clamp away sin(theta) = 0 at exact poles: lambda_mm there is 0 for
    # m > 0 (the clamped seed exponent is ~ -100 m, flushed to zero) and
    # the m = 0 seed must not see 0 * log2(0) = nan
    lg2sin = jnp.log2(jnp.maximum(jnp.sin(thetas), 1e-30))[None, :]
    mv = jnp.arange(M1, dtype=dtype)[:, None]          # (M1, 1)
    lgc = jnp.asarray(_lgc_table(mmax), dtype=dtype)[:, None]
    msign = jnp.where(jnp.arange(M1)[:, None] % 2 == 0, 1.0, -1.0)
    msign = msign.astype(dtype)

    # Rescale bounds chosen to stay inside float32's NORMAL range
    # (accelerators may flush denormals): lanes live in (-2^48, 2^48), hops are <= 96
    # so a rescale factor 2^-96 and post-hop values ~2^-48 are all normal.
    BIG = dtype(2.0) ** 48
    HOP = 96.0

    alm_re = jnp.asarray(alm_re, dtype=dtype)
    alm_im = jnp.asarray(alm_im, dtype=dtype)
    if adjoint:
        Gre = alm_re * jnp.asarray(weights, dtype=dtype)[None, :]
        Gim = alm_im * jnp.asarray(weights, dtype=dtype)[None, :]

    def step(state, l):
        P, Pp, S, Fre, Fim = state
        lf = l.astype(dtype)
        active = mv < lf
        den = jnp.where(active, lf * lf - mv * mv, 1.0)
        a = jnp.sqrt((4.0 * lf * lf - 1.0) / den)
        lm1 = lf - 1.0
        b = jnp.sqrt(jnp.where(active, ((lm1 * lm1 - mv * mv)
                                        / (4.0 * lm1 * lm1 - 1.0)), 0.0))
        Pnew = jnp.where(active, a * (ct * P - b * Pp), 0.0)
        # seed the diagonal lane m == l
        lg = lgc + mv * lg2sin
        Sseed = jnp.round(lg)
        seed = mv == lf
        Pnew = jnp.where(seed, msign * jnp.exp2(lg - Sseed), Pnew)
        S = jnp.where(seed, Sseed, S)
        # renormalise lanes that grew past 2^48 (P and Pp share S).  The
        # hop is clamped so S never crosses 0: once S reaches 0 the lane
        # holds the true lambda (bounded by ~sqrt((2l+1)/4pi)) and needs
        # no further rescaling.
        grew = jnp.abs(Pnew) > BIG
        hop = jnp.where(grew, jnp.minimum(HOP, -S), 0.0)
        fac = jnp.exp2(-hop)
        Pnew = Pnew * fac
        Pkeep = P * fac
        S = S + hop
        lam = Pnew * jnp.exp2(S)
        if adjoint:
            rowRe = jnp.sum(lam * Gre, axis=1)
            rowIm = jnp.sum(lam * Gim, axis=1)
            return (Pnew, Pkeep, S, Fre, Fim), (rowRe, rowIm)
        Fre = Fre + alm_re[l][:, None] * lam
        Fim = Fim + alm_im[l][:, None] * lam
        return (Pnew, Pkeep, S, Fre, Fim), None

    z = jnp.zeros((M1, R), dtype=dtype)
    state = (z, z, z, z, z)
    ls = jnp.arange(lmax + 1)
    state, rows = jax.lax.scan(step, state, ls)
    if adjoint:
        return jnp.stack([rows[0], rows[1]])
    return jnp.stack([state[3], state[4]])


def legendre_rings(thetas, lmax, mmax=None, dtype=np.float64):
    """lambda_lm(theta) for every (l, m, ring) - test/analysis helper.

    Returns (lmax+1, mmax+1, nrings); computed by synthesising with
    one-hot alm per l.  Small problems only (materialises the full
    triangle)."""
    import jax.numpy as jnp

    if mmax is None:
        mmax = lmax
    out = np.zeros((lmax + 1, mmax + 1, len(thetas)))
    for l in range(lmax + 1):
        are = np.zeros((lmax + 1, mmax + 1))
        are[l, :] = 1.0
        F = _legendre_contract(jnp.asarray(thetas), are,
                               np.zeros_like(are), lmax, mmax,
                               dtype=dtype)
        out[l] = np.asarray(F[0])
    return out


# ---------------------------------------------------------------------------
# CAR ring geometry


def car_ring_geometry(shape, wcs):
    """(thetas, nphi_full, phi0, dphi_sign) for a CAR map.

    ``thetas`` are the colatitudes of the map rows; ``nphi_full`` the
    number of samples a full 2pi ring would hold at the map's azimuth
    spacing (the FFT length); ``phi0`` the azimuth of column 0 in
    radians; ``dphi_sign`` -1 when RA decreases with x (the astronomical
    convention), +1 otherwise."""
    ny, nx = shape
    cx = shape[1] // 2
    out = wcs.pix2wcs(np.full(ny, float(cx)), np.arange(ny, dtype=float))
    decs = np.asarray(out)[:, 1]
    thetas = np.radians(90.0 - decs)
    ra0, _ = np.asarray(wcs.pix2wcs(0.0, float(ny // 2))).ravel()
    ra1, _ = np.asarray(wcs.pix2wcs(1.0, float(ny // 2))).ravel()
    dra = ra1 - ra0
    if dra > 180:
        dra -= 360.0
    if dra < -180:
        dra += 360.0
    # CAR: the cdelt1 azimuth step is constant in RA
    dphi = np.radians(abs(dra))
    nphi_full = int(round(2 * np.pi / dphi))
    phi0 = np.radians(ra0 % 360.0)
    return thetas, nphi_full, phi0, (-1.0 if dra < 0 else 1.0)


def ring_weights(thetas, dphi):
    """Quadrature weights for map2alm on iso-latitude rings.

    Midpoint rule in colatitude: w_r = sin(theta_r) dtheta dphi.  Exact
    Clenshaw-Curtis weights need pole-anchored full-sphere grids; survey
    cutouts are not, and the reference's own partial-sky ``map2alm`` is
    approximate there too (quadrature over the stored rows only)."""
    thetas = np.asarray(thetas)
    if len(thetas) > 1:
        dtheta = abs(float(thetas[1] - thetas[0]))
    else:
        dtheta = dphi
    return np.sin(thetas) * dtheta * dphi


# ---------------------------------------------------------------------------
# Public transforms


def alm2map_car(alm, shape, wcs, lmax=None, dtype=np.float32):
    """Synthesise a real CAR map from (lmax+1, mmax+1) complex alm.

    The curved-sky equivalent of the reference's
    ``curvedsky.alm2map`` (spin 0) restricted to the map's rows."""
    import jax.numpy as jnp

    alm = np.asarray(alm)
    if lmax is None:
        lmax = alm.shape[0] - 1
    mmax = alm.shape[1] - 1
    thetas, nphi, phi0, sgn = car_ring_geometry(shape, wcs)
    F = _legendre_contract(thetas, alm.real, alm.imag, lmax, mmax,
                           dtype=dtype)
    Fc = np.asarray(F[0]) + 1j * np.asarray(F[1])      # (M1, R)
    # Ring FFT: T_j = Re sum_m (2-delta_m0) F_m e^{i m phi_j},
    # phi_j = phi0 + sgn * j * 2pi/nphi.  With sgn=-1 the rfft convention
    # e^{+2pi i m j/N} needs the conjugate coefficients.
    M1 = mmax + 1
    nb = nphi // 2 + 1
    c = np.zeros((len(thetas), nb), dtype=np.complex128)
    phase = np.exp(1j * np.arange(M1) * phi0)
    ring = Fc.T * phase[None, :]
    if sgn < 0:
        ring = np.conj(ring)
    c[:, :min(M1, nb)] = ring[:, :min(M1, nb)]
    # irfft contributes (2/n) Re(X_k e^{2pi i k j/n}) per k>0 and X_0/n,
    # so X_0 = n F_0 and X_k = n F_k reproduce (2 - delta_m0) Re(F_m ...)
    c *= nphi
    full = np.fft.irfft(c, n=nphi, axis=1)
    return full[:, :shape[1]]


def map2alm_car(m, shape, wcs, lmax, dtype=np.float32):
    """Ring-quadrature analysis of a real CAR map to complex alm
    (lmax+1, lmax+1); adjoint of :func:`alm2map_car` with midpoint ring
    weights (see :func:`ring_weights`)."""
    thetas, nphi, phi0, sgn = car_ring_geometry(shape, wcs)
    dphi = 2 * np.pi / nphi
    M1 = lmax + 1
    padded = np.zeros((shape[0], nphi))
    padded[:, :shape[1]] = np.asarray(m)
    cb = np.fft.rfft(padded, axis=1)                   # (R, nphi//2+1)
    c = np.zeros((shape[0], M1), dtype=complex)        # m beyond the ring
    nm = min(M1, cb.shape[1])                          # Nyquist: unsampled
    c[:, :nm] = cb[:, :nm]
    if sgn < 0:
        c = np.conj(c)
    phase = np.exp(-1j * np.arange(M1) * phi0)
    G = (c * phase[None, :]).T * dphi                  # (M1, R)
    w = ring_weights(thetas, 1.0)                      # dphi folded into G
    out = _legendre_contract(thetas, np.ascontiguousarray(G.real),
                             np.ascontiguousarray(G.imag), lmax, lmax,
                             adjoint=True, weights=w, dtype=dtype)
    alm = np.asarray(out[0]) + 1j * np.asarray(out[1])
    # alm = sum_r w_r lambda_lm(theta_r) * [dphi sum_j T_j e^{-im phi_j}]
    # approximates the integral T Y*_lm dOmega for every m (the conjugate
    # -m term of the real map integrates to zero against e^{-im phi}), so
    # no (2 - delta_m0) correction belongs here.
    tri = np.tril(np.ones((lmax + 1, lmax + 1), dtype=bool))
    return np.where(tri, alm, 0.0)


def rand_alm(key, Cl, lmax=None, dtype=np.float32):
    """Gaussian random alm from C_l (healpy ``synalm`` semantics):
    a_l0 ~ N(0, C_l); Re/Im a_lm ~ N(0, C_l/2) for m > 0."""
    import jax
    import jax.numpy as jnp

    Cl = np.asarray(Cl, dtype=np.float64)
    if lmax is None:
        lmax = len(Cl) - 1
    L1 = lmax + 1
    amp = np.sqrt(Cl[:L1])
    k1, k2 = jax.random.split(jax.random.PRNGKey(0) if key is None else key)
    re = np.asarray(jax.random.normal(k1, (L1, L1), dtype=jnp.float32),
                    dtype=np.float64)
    im = np.asarray(jax.random.normal(k2, (L1, L1), dtype=jnp.float32),
                    dtype=np.float64)
    ls = np.arange(L1)
    tri = ls[None, :] <= ls[:, None]
    alm = (re + 1j * im) * (amp[:, None] / np.sqrt(2.0))
    alm[:, 0] = re[:, 0] * amp
    return np.where(tri, alm, 0.0)


def sim_cmb_map_curved(key, shape, wcs, beamBell=None, beamEll=None,
                       noiseLevel=None, ClTT=None, lmax=None,
                       dtype=np.float32):
    """Curved-sky CMB realisation on a CAR footprint - the SHT-exact
    counterpart of ``ops.grf.sim_cmb_map`` and the parity partner of the
    reference's ``simCMBMap`` (``nemo/maps.py:1223-1264``).

    The beam is applied to C_l as amplitude (matching the reference's
    ``ps *= lbeam``).  ``lmax`` defaults to the smaller of the spectrum
    extent and the map's row Nyquist scale pi / dtheta; pass a lower
    ``lmax`` to trade damping-tail power (tiny next to any realistic
    noise level beyond l ~ 4000) for Legendre time, which scales as
    lmax^2 x nrings.
    """
    import jax

    from . import grf

    if ClTT is None:
        Cl = np.asarray(grf.lensedClTT())
    else:
        Cl = np.asarray(ClTT)
    ell = np.arange(len(Cl), dtype=float)
    if beamBell is not None:
        lbeam = np.interp(ell, np.asarray(beamEll), np.asarray(beamBell))
        Cl = Cl * lbeam
    if lmax is None:
        thetas, _, _, _ = car_ring_geometry(shape, wcs)
        dtheta = abs(float(thetas[1] - thetas[0])) if len(thetas) > 1 \
            else 1e-3
        lmax = int(np.pi / dtheta)
    lmax = int(min(lmax, len(Cl) - 1))
    k1, k2 = jax.random.split(key)
    alm = rand_alm(k1, Cl, lmax=lmax)
    m = alm2map_car(alm, shape, wcs, dtype=dtype)
    if noiseLevel is not None:
        m = m + np.asarray(grf.sim_noise_map(k2, shape, noiseLevel))
    return m


def sim_noise_map_curved(key, shape, wcs, noiseLevel, lKnee, alpha=-3.0,
                         lmax=6000, dtype=np.float32):
    """1/f ('atmospheric') noise through the curved-sky transform - the
    parity partner of the reference's alm round trip
    (``nemo/maps.py:1326-1341``: white map -> ``map2alm`` at lmax 6000,
    shape the alm by sqrt((lKnee/l)^-alpha + 1), ``alm2map``, and ADD
    BACK the above-band-limit residual of the white map: the reference
    does ``map1 -= alm2map(map2alm(map1)); map1 += alm2map(shaped
    alm)``, so white power above lmax is preserved - at production
    0.5-arcmin pixels the Nyquist l is ~21,600, far above lmax 6000,
    and dropping the residual would zero essentially all small-scale
    noise)."""
    import jax

    thetas, _, _, _ = car_ring_geometry(shape, wcs)
    if len(thetas) > 1:
        lmax = int(min(lmax, np.pi / abs(float(thetas[1] - thetas[0]))))
    white = np.asarray(jax.random.normal(key, shape), dtype=np.float64)
    alm = map2alm_car(white, shape, wcs, lmax, dtype=dtype)
    band = np.asarray(alm2map_car(alm, shape, wcs, dtype=dtype),
                      dtype=np.float64)
    ls = np.maximum(np.arange(lmax + 1, dtype=np.float64), 1e-9)
    Nl = (lKnee / ls) ** -alpha + 1.0
    Nl[0] = 0.0
    alm = alm * np.sqrt(Nl)[:, None]
    shaped = (white - band) + np.asarray(
        alm2map_car(alm, shape, wcs, dtype=dtype), dtype=np.float64)
    noiseLevel = np.asarray(noiseLevel)
    if noiseLevel.ndim == 0:
        return shaped * float(noiseLevel)
    return np.where(noiseLevel > 0, shaped * noiseLevel, 0.0)
