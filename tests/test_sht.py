"""Curved-sky spherical-harmonic transforms (``nemo_tpu/ops/sht.py``):
the JAX counterpart of the reference's libsharp-backed
``curvedsky.rand_map`` / ``map2alm`` / ``alm2map``
(``/root/reference/nemo/maps.py:1257,1326-1341``)."""

import numpy as np
import pytest

from nemo_tpu import maps
from nemo_tpu.ops import sht
from nemo_tpu.utils import wcs as nwcs


def _random_alm(rng, lmax, amp=None):
    alm = np.zeros((lmax + 1, lmax + 1), dtype=complex)
    for l in range(lmax + 1):
        a = 1.0 if amp is None else amp[l]
        alm[l, 0] = rng.normal() * a
        alm[l, 1:l + 1] = (rng.normal(size=l)
                           + 1j * rng.normal(size=l)) * a / np.sqrt(2)
    return alm


def test_legendre_matches_scipy():
    from scipy.special import sph_harm_y

    thetas = np.array([0.3, 0.9, np.pi / 2, 2.2, 2.8])
    lmax = 12
    lam = sht.legendre_rings(thetas, lmax, dtype=np.float64)
    for l in range(lmax + 1):
        for m in range(l + 1):
            ref = np.real(sph_harm_y(l, m, thetas, 0.0))
            assert np.allclose(lam[l, m], ref, atol=1e-13), (l, m)


def test_alm2map_matches_brute_force():
    from scipy.special import sph_harm_y

    shape = (10, 14)
    w = nwcs.makeWCS(shape, 0.5, centreRADeg=30.0, centreDecDeg=-50.0)
    lmax = 16
    rng = np.random.default_rng(3)
    alm = _random_alm(rng, lmax)
    m = sht.alm2map_car(alm, shape, w, dtype=np.float64)

    xx, yy = np.meshgrid(np.arange(shape[1], dtype=float),
                         np.arange(shape[0], dtype=float))
    out = np.asarray(w.pix2wcs(xx.ravel(), yy.ravel()))
    thetas = np.radians(90.0 - out[:, 1])
    phis = np.radians(out[:, 0] % 360.0)
    ref = np.zeros(len(thetas))
    for l in range(lmax + 1):
        for mm in range(l + 1):
            Y = sph_harm_y(l, mm, thetas, phis)
            fac = 1.0 if mm == 0 else 2.0
            ref += fac * np.real(alm[l, mm] * Y)
    ref = ref.reshape(shape)
    assert np.max(np.abs(m - ref)) < 1e-10 * max(1.0, np.abs(ref).max())


def test_round_trip_full_sphere():
    ny, nx = 181, 360
    w = nwcs.makeWCS((ny, nx), 1.0, centreRADeg=180.0, centreDecDeg=0.0)
    lmax = 40
    rng = np.random.default_rng(7)
    alm = _random_alm(rng, lmax)
    m = sht.alm2map_car(alm, (ny, nx), w, dtype=np.float64)
    alm2 = sht.map2alm_car(m, (ny, nx), w, lmax, dtype=np.float64)
    # midpoint ring quadrature: exact to its order away from the band
    # edge; compare well inside the band limit
    sel = np.arange(lmax + 1) <= 2 * lmax // 3
    err = np.abs(alm2 - alm)[sel].max() / np.abs(alm).max()
    assert err < 5e-3


def test_float32_matches_float64():
    """The scaled recurrence must stay accurate in float32 (device compute
    dtype): the float64 run is the reference."""
    shape = (64, 128)
    w = nwcs.makeWCS(shape, 0.5 / 60.0, centreRADeg=30.0,
                     centreDecDeg=-55.0)
    lmax = 400
    rng = np.random.default_rng(11)
    amp = 1.0 / np.maximum(np.arange(lmax + 1), 1.0)
    alm = _random_alm(rng, lmax, amp)
    m64 = sht.alm2map_car(alm, shape, w, dtype=np.float64)
    m32 = sht.alm2map_car(alm, shape, w, dtype=np.float32)
    assert np.std(m32 - m64) / np.std(m64) < 1e-4


def test_rand_alm_spectrum():
    import jax

    lmax = 300
    Cl = 1.0 / np.maximum(np.arange(lmax + 1.0), 1.0) ** 2
    alm = sht.rand_alm(jax.random.PRNGKey(0), Cl, lmax=lmax)
    ls = np.arange(lmax + 1)
    tri = ls[None, :] <= ls[:, None]
    # hat(C_l) = (|a_l0|^2 + 2 sum_m |a_lm|^2) / (2l + 1)
    power = (np.abs(alm) ** 2 * np.where(tri, 2.0, 0.0))
    power[:, 0] *= 0.5
    hatCl = power.sum(axis=1) / (2 * ls + 1)
    band = slice(50, 301)
    ratio = hatCl[band].mean() / Cl[band].mean()
    assert abs(ratio - 1) < 0.1


def test_sim_cmb_map_curved_variance():
    """Realised map variance matches sum (2l+1)/(4pi) C_l within sample
    scatter on a band-limited low-l sim."""
    import jax

    from nemo_tpu.ops import grf

    shape = (40, 720)
    w = nwcs.makeWCS(shape, 0.5, centreRADeg=0.0, centreDecDeg=-40.0)
    lmax = 180
    Cl = np.asarray(grf.lensedClTT())[:lmax + 1]
    m = sht.sim_cmb_map_curved(jax.random.PRNGKey(4), shape, w,
                               ClTT=Cl, lmax=lmax)
    expected = np.sum((2 * np.arange(lmax + 1) + 1) * Cl) / (4 * np.pi)
    assert 0.5 < m.var() / expected < 2.0


def test_maps_simCMBMap_curved_dispatch():
    shape = (24, 48)
    w = nwcs.makeWCS(shape, 0.5, centreRADeg=0.0, centreDecDeg=-30.0)
    m = maps.simCMBMap(shape, w, seed=1, method="curved", lmax=120)
    assert m.shape == shape and np.isfinite(m).all() and m.std() > 0
    with pytest.raises(ValueError):
        maps.simCMBMap(shape, w, seed=1, method="nope")


def test_sim_noise_map_curved():
    """Curved 1/f noise: band-limited, red-tilted vs white at low l, and
    scaled by the per-pixel level (reference alm round trip,
    maps.py:1326-1341)."""
    shape = (40, 720)
    w = nwcs.makeWCS(shape, 0.5, centreRADeg=0.0, centreDecDeg=-30.0)
    m = maps.simNoiseMap(shape, 10.0, wcs=w, lKnee=300, alpha=-3,
                         seed=5, method="curved")
    assert m.shape == shape and np.isfinite(m).all()
    # 1/f boosts variance well above the white-map level
    white = maps.simNoiseMap(shape, 10.0, wcs=w, seed=5)
    assert m.std() > 2 * white.std()
    with pytest.raises(ValueError):
        maps.simNoiseMap(shape, 10.0, wcs=w, seed=5, method="curved")


def test_curved_noise_preserves_white_above_band_limit():
    """The 1/f alm round trip must ADD BACK the above-lmax residual of
    the white map (reference maps.py:1326-1341: map1 -= alm2map(alm);
    map1 += alm2map(shaped alm)).  At survey pixel scales the Nyquist
    multipole is far above lmax, so dropping the residual would delete
    essentially all small-scale noise power - the output would have
    std << noiseLevel."""
    import jax

    from nemo_tpu.ops import sht
    from nemo_tpu.utils import wcs as nwcs

    shape = (128, 128)
    w = nwcs.makeWCS(shape, 0.5 / 60.0, centreRADeg=30.0,
                     centreDecDeg=-10.0)     # 0.5': Nyquist l ~ 21600
    noiseLevel = 10.0
    out = np.asarray(sht.sim_noise_map_curved(
        jax.random.PRNGKey(3), shape, w, noiseLevel, lKnee=300.0,
        lmax=200))
    ratio = np.std(out) / noiseLevel
    # white floor preserved (≈1, slightly above from the shaped low-l
    # part); a band-limited-only map at lmax 200 would give ~0.01
    assert 0.9 < ratio < 1.5, ratio
