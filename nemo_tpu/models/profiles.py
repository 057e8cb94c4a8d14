"""Cluster / source signal-map construction (signal templates and painting).

Native equivalents of the reference's ``nemo/signals.py:448-812``:
``makeArnaudModelProfile``, ``makeBattagliaModelProfile``,
``makeBeamModelSignalMap``, ``_paintSignalMap`` and the
``makeArnaud/BattagliaModelSignalMap`` wrappers.

The construction path mirrors the reference exactly:
1-d GNFW line-of-sight profile -> beam convolution in harmonic space
(FFTLog Hankel transform instead of pixell's RadialFourierTransform) ->
radial real-space painting at sub-pixel positions (device scatter-add
instead of pixell ``pointsrcs.sim_objects``).
"""

import jax.numpy as jnp
import numpy as np

from ..ops import paint as paint_ops
from ..ops.hankel import RadialFourierTransform
from . import cosmology as cosmo_mod
from . import gnfw
from .beams import BeamProfile


def makeArnaudModelProfile(z, M500, GNFWParams="default", cosmoModel=None):
    """Unit-peak cylindrical A10 profile for a cluster of (z, M500c).

    Returns dict with 'rDeg' (angular radii), 'prof' (values) and
    'theta500Arcmin' (parity with ``signals.py:448-502``, but returning a
    plain table instead of spline knots - device code interpolates tables).
    """
    cosmoModel = cosmoModel or cosmo_mod.fiducialCosmoModel()
    params = None if GNFWParams == "default" else GNFWParams
    b, prof = gnfw.cylindrical_profile(params)
    theta500Arcmin = cosmo_mod.calcTheta500Arcmin(z, M500, cosmoModel)
    rDeg = b * (theta500Arcmin / 60.0)
    return {"rDeg": rDeg, "prof": prof, "theta500Arcmin": theta500Arcmin}


def makeBattagliaModelProfile(z, M500c, GNFWParams="default", cosmoModel=None):
    """Battaglia et al. (2012) profile with mass/z-evolving shape
    (``signals.py:505-583``); GNFW parameters expressed in A10 conventions.
    """
    cosmoModel = cosmoModel or cosmo_mod.fiducialCosmoModel()
    if GNFWParams == "default":
        GNFWParams = dict(gnfw.BATTAGLIA12_PARAMS)
    p = dict(GNFWParams)

    # B12 fit the evolution of P0, x_c, beta with M200c and z (their Table 1);
    # convert between B12 beta convention (beta_B12 = beta_A10 - 0.3) and x_c
    # = 1/c500.
    P0 = p["P0"]
    xc = 1.0 / p["c500"]
    beta = p["beta"] - 0.3
    M200c = cosmoModel.convertMassDef(M500c, z, 500, "critical",
                                      200, "critical")
    P0z = P0 * (M200c / 1e14) ** 0.226 * (1 + z) ** -0.957
    xcz = xc * (M200c / 1e14) ** -0.0833 * (1 + z) ** 0.853
    betaz = beta * (M200c / 1e14) ** 0.0480 * (1 + z) ** 0.615

    params = {"P0": P0z, "c500": 1.0 / xcz, "gamma": 0.3, "alpha": 1.0,
              "beta": betaz + 0.3}
    b, prof = gnfw.cylindrical_profile(params)
    theta500Arcmin = cosmo_mod.calcTheta500Arcmin(z, M500c, cosmoModel)
    rDeg = b * (theta500Arcmin / 60.0)
    return {"rDeg": rDeg, "prof": prof, "theta500Arcmin": theta500Arcmin}


def convolveProfileWithBeam(rDeg, prof, beam):
    """Beam-convolve a radial profile in harmonic space.

    Mirrors ``_paintSignalMap``'s use of pixell's RadialFourierTransform
    (``signals.py:642-648``): rprof -> harmonic -> x B_ell -> real space.

    Returns (r_rad, prof_conv) on the transform's (unpadded) radial grid.
    """
    if isinstance(beam, str):
        beam = BeamProfile(beamFileName=beam)
    rft = RadialFourierTransform()
    rprof = np.interp(rft.r, np.radians(np.asarray(rDeg)), np.asarray(prof),
                      left=prof[0], right=0.0)
    lprof = rft.real2harm(rprof)
    # Zero beyond the tabulated B_ell range (end-clamping would alias a
    # high-l plateau into a spike at r=0 on the log grid)
    lbeam = np.interp(rft.l, beam.ell, beam.Bell, right=0.0)
    rconv = rft.harm2real(lprof * lbeam)
    r, rconv = rft.unpad(rft.r, rconv)
    return r, rconv


def paintSignalMap(shape, pix_scales_rad, rDeg, prof, beam=None,
                   ys=None, xs=None, amplitude=None, maxSizeDeg=10.0,
                   convolveWithBeam=True, returnDevice=False,
                   dx_rows=None):
    """Paint object(s) with a shared radial profile into a map.

    Args:
        shape: (ny, nx).
        pix_scales_rad: (dy, dx) at tile centre.
        rDeg, prof: unit-peak radial profile table.
        beam: BeamProfile or beam file path (required if convolveWithBeam).
        ys, xs: float pixel coords; default = map centre (template mode).
        amplitude: peak amplitude(s) *before* beam convolution (reference
            semantics, ``signals.py:653-655``); None = unnormalised template.
        maxSizeDeg: truncation radius for painting.
        returnDevice: keep the painted map on device (no host copy), so
            batch consumers (fitQ) keep everything resident.

    Returns:
        (ny, nx) map - numpy, or jnp when ``returnDevice``.
    """
    r, vAbs, scale = signalTemplateTable(
        rDeg, prof, beam=beam, amplitude=amplitude, maxSizeDeg=maxSizeDeg,
        convolveWithBeam=convolveWithBeam)
    ny, nx = shape
    if ys is None:
        out = paint_ops.paint_template_centered(
            shape, pix_scales_rad, r, vAbs,
            center=(ny / 2.0, nx / 2.0))
        if returnDevice:
            return scale * out
        return np.asarray(scale) * np.asarray(out)
    # per-object amplitudes: the (exact) sign negation folds into the
    # per-object scale, so the painted contributions sum identically
    out = paint_ops.paint_objects(shape, pix_scales_rad,
                                  np.atleast_1d(ys), np.atleast_1d(xs),
                                  np.atleast_1d(scale), r, vAbs,
                                  np.radians(maxSizeDeg), dx_rows=dx_rows)
    return out if returnDevice else np.asarray(out)


def signalTemplateTable(rDeg, prof, beam=None, amplitude=None,
                        maxSizeDeg=10.0, convolveWithBeam=True):
    """Radial table of the final painted template: ``(r, vAbs, scale)``
    such that the painted map is ``scale * paint(interp(vAbs))`` - the
    exact factorisation :func:`paintSignalMap` uses internally.  Batch
    painters (``parallel/engine._bankTemplateStacks``, fitQ) consume the
    tables directly so a whole filter bank paints in one dispatch."""
    if convolveWithBeam:
        if beam is None:
            raise ValueError("No beam supplied")
        r, rprof = convolveProfileWithBeam(rDeg, prof, beam)
    else:
        r = np.radians(np.logspace(np.log10(1e-6), np.log10(maxSizeDeg), 5000))
        rprof = np.interp(r, np.radians(rDeg), prof, left=prof[0], right=0.0)

    amp = 1.0
    if amplitude is not None:
        # rprof[0] is the post-convolution peak of the unit-peak profile;
        # amplitude scales the *unconvolved* peak (signals.py:653-655).
        amp = rprof[0] * np.asarray(amplitude)
        rprof = rprof / rprof[0]

    sign = 1.0
    if rprof[0] < 0:
        sign = -1.0
    return r, np.abs(rprof), sign * amp


def beamTemplateTable(beam, amplitude=None):
    """``(r, v, scale)`` table for the beam (point-source) template -
    the factorisation :func:`makeBeamModelSignalMap` paints from."""
    if isinstance(beam, str):
        beam = BeamProfile(beamFileName=beam)
    amp = 1.0 if amplitude is None else amplitude
    return np.radians(beam.rDeg), beam.profile1d, amp


def makeBeamModelSignalMap(shape, pix_scales_rad, beam, ys=None, xs=None,
                           amplitude=None, maxSizeDeg=None,
                           returnDevice=False, dx_rows=None):
    """Signal map containing the beam itself (point-source template),
    parity with ``signals.py:587-619``."""
    if isinstance(beam, str):
        beam = BeamProfile(beamFileName=beam)
    amp = 1.0 if amplitude is None else amplitude
    r = np.radians(beam.rDeg)
    prof = beam.profile1d
    ny, nx = shape
    if ys is None:
        out = paint_ops.paint_template_centered(
            shape, pix_scales_rad, r, prof, center=(ny / 2.0, nx / 2.0))
        if returnDevice:
            return jnp.asarray(amp) * out
        return np.asarray(amp) * np.asarray(out)
    rmax = maxSizeDeg if maxSizeDeg is not None else beam.rDeg[-1]
    return np.asarray(paint_ops.paint_objects(
        shape, pix_scales_rad, np.atleast_1d(ys), np.atleast_1d(xs),
        np.atleast_1d(amp), r, prof, np.radians(rmax), dx_rows=dx_rows))


def makeArnaudModelSignalMap(z, M500, shape, pix_scales_rad, beam=None,
                             ys=None, xs=None, GNFWParams="default",
                             amplitude=None, maxSizeDeg=15.0,
                             convolveWithBeam=True, cosmoModel=None,
                             returnDevice=False, dx_rows=None):
    """A10 cluster signal map (parity with ``signals.py:675-743``)."""
    d = makeArnaudModelProfile(z, M500, GNFWParams=GNFWParams,
                               cosmoModel=cosmoModel)
    return paintSignalMap(shape, pix_scales_rad, d["rDeg"], d["prof"],
                          beam=beam, ys=ys, xs=xs, amplitude=amplitude,
                          maxSizeDeg=maxSizeDeg,
                          convolveWithBeam=convolveWithBeam,
                          returnDevice=returnDevice, dx_rows=dx_rows)


def makeBattagliaModelSignalMap(z, M500, shape, pix_scales_rad, beam=None,
                                ys=None, xs=None, GNFWParams="default",
                                amplitude=None, maxSizeDeg=15.0,
                                convolveWithBeam=True, cosmoModel=None,
                                returnDevice=False, dx_rows=None):
    """B12 cluster signal map (parity with ``signals.py:746-812``)."""
    d = makeBattagliaModelProfile(z, M500, GNFWParams=GNFWParams,
                                  cosmoModel=cosmoModel)
    return paintSignalMap(shape, pix_scales_rad, d["rDeg"], d["prof"],
                          beam=beam, ys=ys, xs=xs, amplitude=amplitude,
                          maxSizeDeg=maxSizeDeg,
                          convolveWithBeam=convolveWithBeam,
                          returnDevice=returnDevice, dx_rows=dx_rows)
