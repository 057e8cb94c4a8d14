"""Linear Boltzmann solver: CAMB-grade matter transfer functions in JAX.

The reference computes its halo-mass-function power spectra with CCL's
Boltzmann-calibrated transfer function (``nemo/MockSurvey.py:159-307``,
``transfer_function='boltzmann_camb'``); this framework's default has
been Eisenstein & Hu (1998), whose sigma(M) SHAPE differs from a
Boltzmann calculation at the 1-2% level (PARITY.md).  No Boltzmann code
exists in this environment, so this module implements one natively:

* **Background**: flat LCDM + photons + N_eff massless neutrinos
  (matching the reference's CCL call, which leaves ``m_nu = 0``).
* **Recombination** (host, setup time): Saha for He III/II/I and H,
  switching to a Peebles effective three-level atom for the hydrogen
  tail, with the RECFAST fudge factor F = 1.14 on the case-B
  coefficient.
* **Perturbations** (JAX, vmapped over k, fixed-step RK4 in ln a via
  ``lax.scan``): conformal-Newtonian-gauge equations of Ma &
  Bertschinger (1995, MB95) - CDM + baryons + photon intensity and
  polarization hierarchies (l <= 8) + massless-neutrino hierarchy
  (l <= 12), with three regimes blended per (k, time) by smooth masks
  (shapes stay static under jit):

  - **Tight coupling** while kappa' >> max(k, aH): first-order slip
    (derived from the exact theta_gamma/theta_b system), quadrupole
    pinned to its polarization-corrected equilibrium
    F2 = (8/15)(k/kappa') F1 (the classic sigma_gamma =
    16 theta_gamma / (45 kappa') with polarization).
  - **Full hierarchies** through recombination.
  - **Radiation streaming** (k tau >> 1, optically thin): monopoles
    pinned to their sub-horizon quasi-static values (delta = -4 psi),
    higher multipoles relaxed to zero - the CLASS-style RSA that frees
    the fixed-step integrator from resolving k*tau ~ 1e5 oscillations
    that no longer affect the matter growth.

  Outside TCA, every kappa'-stiff scattering/drag term is applied by
  an EXACT per-step exponential relaxation (operator splitting): the
  baryon-photon drag pair decays onto its momentum-conserving average
  at kappa'(1 + 1/R_b), the (F2, G0, G2) trio follows its closed-form
  matrix exponential (Pi decays at 0.3 kappa'), and the remaining
  multipoles decay as exp(-kappa' h) - unconditionally stable at any
  kappa' h, with no stability caps distorting the Silk damping.

* **Normalization**: initial conditions are adiabatic (MB95 eq. 98);
  the transfer function is measured as delta_m(k, a=1) / R_init with
  R_init the comoving curvature of the initial data, so small
  decaying-mode contamination in the ICs cancels and sigma_8 (an INPUT,
  as in the reference's CCL usage) fixes the amplitude.

Verification without CAMB in this environment (tests/test_boltzmann.py):
superhorizon curvature conservation, step/lmax/k-grid convergence, the
EH98 cross-check (agreement at its documented 1-2% level, BAO wiggle
phase consistent with the EH98 analytic sound horizon), and the
sub-horizon growing-mode limit.
"""

import functools

import numpy as np

# -- constants (SI where dimensional) ----------------------------------------
C_M_S = 2.99792458e8
MPC_M = 3.0856775814913673e22
SIGMA_T = 6.6524587321e-29          # m^2
M_H = 1.6735575e-27                 # kg (hydrogen atom)
K_B = 1.380649e-23
HBAR = 1.054571817e-34
M_E = 9.1093837015e-31
EPS0_EV = 13.605693122994           # H ionisation energy, eV
EV = 1.602176634e-19
XI_HE1_EV = 24.587387936
XI_HE2_EV = 54.417760440
G_SI = 6.67430e-11
TCMB0 = 2.7255
YP = 0.245                          # helium mass fraction
NEFF = 3.046

LG = 8      # photon intensity / polarization hierarchy extent
LN = 12     # massless neutrino hierarchy extent
NV = 5 + (LG + 1) * 2 + (LN + 1)

# regime thresholds
TCA_FAC = 40.0       # tight coupling while kappa' > TCA_FAC * max(k, aH)
RSA_KTAU = 240.0     # radiation streaming beyond k*tau > RSA_KTAU
RSA_KAPPA = 0.2      # ... and kappa' < RSA_KAPPA * k


class Background:
    """Flat LCDM + radiation background and recombination tables."""

    def __init__(self, H0=70.0, Om0=0.3, Ob0=0.05, lnaMin=-19.5,
                 nGrid=24576):
        self.H0 = float(H0)
        self.h = self.H0 / 100.0
        self.Om0 = float(Om0)
        self.Ob0 = float(Ob0)
        self.Oc0 = self.Om0 - self.Ob0
        og_h2 = 2.47282e-5 * (TCMB0 / 2.7255) ** 4
        self.Og0 = og_h2 / self.h ** 2
        self.On0 = self.Og0 * (7.0 / 8.0) * (4.0 / 11.0) ** (4. / 3.) * NEFF
        self.Or0 = self.Og0 + self.On0
        self.Ol0 = 1.0 - self.Om0 - self.Or0
        # H0 in Mpc^-1 (units c = 1): H0[km/s/Mpc] / c[km/s]
        self.H0_mpc = self.H0 / 2.99792458e5

        self.lna = np.linspace(lnaMin, 0.0, nGrid)
        a = np.exp(self.lna)
        self.a = a
        # conformal Hubble aH in Mpc^-1
        self.Hc = self.H0_mpc * np.sqrt(self.Om0 / a + self.Or0 / a ** 2
                                        + self.Ol0 * a ** 2)
        # conformal time tau(a) in Mpc: dtau = da / (a^2 H) = dlna / (aH);
        # seed with the RD closed form tau = a / (H0 sqrt(Or)) at lnaMin
        dlna = self.lna[1] - self.lna[0]
        integrand = 1.0 / self.Hc
        tau0 = a[0] / (self.H0_mpc * np.sqrt(self.Or0))
        self.tau = tau0 + np.concatenate(
            [[0.0], np.cumsum((integrand[1:] + integrand[:-1]) / 2 * dlna)])
        self._recombination()

    # -- recombination --------------------------------------------------------
    def _recombination(self):
        """x_e(a) via Saha (He III/II/I + H) -> Peebles for the H tail;
        opacity kappa'(a) = n_e sigma_T a in Mpc^-1."""
        a = self.a
        Tg = TCMB0 / a                                   # K
        rho_crit0 = 3 * (self.H0 * 1e3 / MPC_M) ** 2 / (8 * np.pi * G_SI)
        nH0 = (1 - YP) * self.Ob0 * rho_crit0 / M_H      # m^-3 today
        fHe = YP / (4 * (1 - YP))
        nH = nH0 / a ** 3

        def saha_rhs(T, chi_eV):
            # (me kB T / 2 pi hbar^2)^(3/2) e^(-chi/kT) / nH  [dimensionless]
            return ((M_E * K_B * T / (2 * np.pi * HBAR ** 2)) ** 1.5
                    * np.exp(-chi_eV * EV / (K_B * T)))

        xe = np.zeros_like(a)
        # Saha chain per grid point (vectorised where possible)
        for i, (T, nHi) in enumerate(zip(Tg, nH)):
            # HeIII <-> HeII
            S3 = saha_rhs(T, XI_HE2_EV) / nHi
            # HeII <-> HeI
            S2 = 4 * saha_rhs(T, XI_HE1_EV) / nHi
            # H
            S1 = saha_rhs(T, EPS0_EV) / nHi
            # iterate x_e = xHII + fHe*(xHeII + 2 xHeIII) self-consistently
            # (Saha: xHII * x_e / (1 - xHII) = S1/nH, etc.)
            x = 1.0 + 2 * fHe
            for _ in range(80):
                xH = S1 / (x + S1)                           # linear in xHII
                r2 = S2 / x
                r3 = S3 / x
                D = 1 + r2 + r2 * r3
                xHeII_frac = r2 / D                          # of total He
                xHeIII_frac = r2 * r3 / D
                xNew = xH + fHe * (xHeII_frac + 2 * xHeIII_frac)
                if abs(xNew - x) < 1e-12:
                    x = xNew
                    break
                x = 0.5 * (x + xNew)
            xe[i] = x

        # Peebles takeover for the H tail once total x_e < 0.985 (He is
        # fully recombined well before hydrogen becomes relevant, so xe
        # below the switch is purely hydrogen)
        switch = np.argmax(xe < 0.985)
        if switch == 0:
            switch = len(a) - 1
        lam_2s1s = 8.227                                 # s^-1

        def peebles_dxdlna(lna_i, xH, Ti, nHi, Hi_s):
            # case-B recombination coefficient: Pequignot et al. fit as
            # used by RECFAST, with its fudge factor F = 1.14
            T4 = Ti / 1e4
            alpha2 = 1.14 * 1e-19 * 4.309 * T4 ** -0.6166 \
                / (1 + 0.6703 * T4 ** 0.5300)              # m^3/s
            beta = alpha2 * (M_E * K_B * Ti
                             / (2 * np.pi * HBAR ** 2)) ** 1.5 \
                * np.exp(-EPS0_EV * EV / (K_B * Ti))
            # 2s->1s + Lyman-alpha escape vs reionisation from n=2
            beta2 = alpha2 * (M_E * K_B * Ti
                              / (2 * np.pi * HBAR ** 2)) ** 1.5 \
                * np.exp(-EPS0_EV * EV / (4 * K_B * Ti))
            n1s = (1 - xH) * nHi
            lam_alpha = Hi_s * (3 * EPS0_EV * EV
                                / (HBAR * C_M_S)) ** 3 \
                / (8 * np.pi) ** 2 / np.maximum(n1s, 1e-30)
            C = (lam_2s1s + lam_alpha) \
                / (lam_2s1s + lam_alpha + beta2)
            dxdt = C * (beta * (1 - xH) - nHi * alpha2 * xH * xH)
            return dxdt / Hi_s

        # proper H(a) in s^-1
        H_s = self.Hc / self.a * (C_M_S / MPC_M)
        dlna = self.lna[1] - self.lna[0]
        xH = min(xe[switch], 1.0)
        for i in range(switch, len(a)):
            if i > switch:
                # RK2 midpoint in lna (the tail is smooth at this grid)
                k1 = peebles_dxdlna(self.lna[i - 1], xH, Tg[i - 1],
                                    nH[i - 1], H_s[i - 1])
                xm = xH + 0.5 * dlna * k1
                Tm = TCMB0 / np.exp(self.lna[i - 1] + 0.5 * dlna)
                nHm = nH0 / np.exp(3 * (self.lna[i - 1] + 0.5 * dlna))
                Hm = np.interp(self.lna[i - 1] + 0.5 * dlna, self.lna, H_s)
                k2 = peebles_dxdlna(0.0, xm, Tm, nHm, Hm)
                xH = xH + dlna * k2
                xH = float(np.clip(xH, 1e-6, 1.0))
            xe[i] = xH          # He fully recombined by now
        self.xe = xe

        # kappa' = n_e sigma_T a  in Mpc^-1   (dkappa/dtau, comoving)
        ne = xe * nH                                   # m^-3 proper
        self.kappa_dot = ne * SIGMA_T * a * MPC_M

        # Silk damping scale k_D(a): 1/k_D^2 = int dtau/(6 kappa') x
        # [R^2 + 16(1+R)/15] / (1+R)^2  (photon diffusion; R = 3rho_b/
        # 4rho_g).  Modes with k >> k_D are physically erased while
        # still semi-optically-thick - the streaming regime must engage
        # for them (their k*tau oscillations are unresolvable by a
        # fixed-step integrator AND carry no surviving amplitude).
        R = 0.75 * self.Ob0 * a / self.Og0
        damp_int = (R ** 2 + 16.0 * (1 + R) / 15.0)             / (6.0 * self.kappa_dot * (1 + R) ** 2)
        dtau = np.gradient(self.tau)
        inv_kD2 = np.cumsum(damp_int * dtau)
        self.kD = 1.0 / np.sqrt(np.maximum(inv_kD2, 1e-30))

        # baryon temperature: tight to T_gamma until Compton decoupling
        # (z ~ 150), then Tb ~ a^-2; sound speed cs^2 = kB Tb/(mu mH c^2)
        # x (1 - dlnTb/dlna / 3)
        a_dec = 1.0 / 151.0
        Tb = np.where(a < a_dec, Tg, TCMB0 / a_dec * (a_dec / a) ** 2)
        mu = 1.0 / (1 - YP * (1 - 1.0 / 4.0))   # mean molecular weight-ish
        dlnTb = np.where(a < a_dec, -1.0, -2.0)
        self.cs2_b = K_B * Tb / (mu * M_H * C_M_S ** 2) * (1 - dlnTb / 3.0)


@functools.lru_cache(maxsize=4)
def _solver_tables(H0, Om0, Ob0, nGrid):
    return Background(H0=H0, Om0=Om0, Ob0=Ob0, nGrid=nGrid)


def _make_system(bg, dtype=np.float64):
    """Closures (derivs / initial_state / comoving_curvature / rk4_step)
    over one Background - shared by :func:`transfer_function` and the
    debug trajectory driver."""
    import jax
    import jax.numpy as jnp

    lna = jnp.asarray(bg.lna, dtype)
    Hc_t = jnp.asarray(bg.Hc, dtype)
    tau_t = jnp.asarray(bg.tau, dtype)
    kap_t = jnp.asarray(bg.kappa_dot, dtype)
    cs2_t = jnp.asarray(bg.cs2_b, dtype)
    kD_t = jnp.asarray(bg.kD, dtype)
    dlna = float(bg.lna[1] - bg.lna[0])

    H0m = bg.H0_mpc
    Og0, On0, Ob0_, Oc0, = bg.Og0, bg.On0, bg.Ob0, bg.Oc0
    Rnu = On0 / (Og0 + On0)

    # state indices
    I_PHI, I_DC, I_TC, I_DB, I_TB = 0, 1, 2, 3, 4
    I_F = 5                   # F_0..F_LG
    I_G = I_F + LG + 1        # G_0..G_LG
    I_N = I_G + LG + 1        # N_0..N_LN

    def interp(x, tab):
        return jnp.interp(x, lna, tab)

    def derivs(x, y, kk, h_tau):
        """dy/dlna at lna = x for one k (y: (NV,))."""
        a = jnp.exp(x)
        Hc = interp(x, Hc_t)
        tau = interp(x, tau_t)
        kap = interp(x, kap_t)
        cs2 = interp(x, cs2_t)

        phi = y[I_PHI]
        dc, tc, db, tb = y[I_DC], y[I_TC], y[I_DB], y[I_TB]
        F = y[I_F:I_F + LG + 1]
        G = y[I_G:I_G + LG + 1]
        N = y[I_N:I_N + LN + 1]

        # densities x a^2 x (8 pi G / 3 H0^2): Omega_i a^{-1 or -2}
        w_c = Oc0 / a
        w_b = Ob0_ / a
        w_g = Og0 / a ** 2
        w_n = On0 / a ** 2

        th_g = 0.75 * kk * F[1]
        th_n = 0.75 * kk * N[1]
        sig_g = F[2] / 2.0
        sig_n = N[2] / 2.0

        # anisotropic stress: k^2(phi - psi) = 12 pi G a^2 (rho+p) sigma
        psi = phi - (6.0 * H0m ** 2 / kk ** 2) \
            * (w_g * sig_g + w_n * sig_n)

        # momentum constraint: k^2 (phi' + Hc psi) = 4 pi G a^2(rho+p)th
        mom = (w_c * tc + w_b * tb
               + (4. / 3.) * (w_g * th_g + w_n * th_n))
        src = (1.5 * H0m ** 2) * mom
        phi_dot = (-Hc * psi + src / kk ** 2)      # conformal d/dtau
        dphi = phi_dot / Hc

        Rb = 0.75 * (w_b / w_g)                    # 3 rho_b / 4 rho_g
        # regimes: streaming engages when optically thin OR when the
        # mode is Silk-erased (k >> k_D) while still semi-thick - in
        # that window the oscillations are both unresolvable and
        # physically irrelevant
        kD = interp(x, kD_t)
        tca = kap > TCA_FAC * jnp.maximum(kk, Hc)
        rsa = jnp.logical_or(
            jnp.logical_and(kk * tau > RSA_KTAU, kap < RSA_KAPPA * kk),
            jnp.logical_and(kk * tau > 100.0, kk > 3.0 * kD))
        tca = jnp.logical_and(tca, jnp.logical_not(rsa))
        rsa_n = kk * tau > RSA_KTAU
        relax = 0.5 / h_tau                        # RK4-stable rate cap

        # In the streaming regime the phi ODE (momentum constraint)
        # degenerates: with the radiation dipoles pinned, phi' -> -Hc
        # psi decays only as 1/tau instead of tracking the Poisson
        # value - measured as a +50% T(k) excess at k ~ 14/Mpc.  Pin
        # phi to the exact energy+momentum constraint combination,
        #   k^2 phi = -4 pi G a^2 sum_i rho_i [delta_i
        #             + 3 Hc (1 + w_i) theta_i / k^2],
        # (sub-horizon: the comoving Poisson equation).  The ODE stays
        # in charge outside streaming, where the dynamics preserve the
        # constraints and the superhorizon ICs are exact.
        dens = (w_c * dc + w_b * db + w_g * F[0] + w_n * N[0])
        momD = (w_c * tc + w_b * tb
                + (4. / 3.) * (w_g * th_g + w_n * th_n))
        phi_alg = -(1.5 * H0m ** 2 / kk ** 2) * (dens + 3.0 * Hc * momD
                                                 / kk ** 2)
        # In the FULL regime every kappa'-scattering/drag term is
        # applied EXACTLY by the exponential relaxation substep
        # (relax_step) - the explicit derivatives here carry only the
        # non-stiff transport/gravity terms, so the integrator is
        # unconditionally stable at any kappa' h.  (An earlier version
        # capped the explicit rates at the RK4 stability limit; the cap
        # bound hard through the Silk-damping window at high k and
        # under-damped the tail by tens of percent.)
        kapEff = 0.0

        # --- matter ---------------------------------------------------------
        d_dc = (-tc) / Hc + 3 * dphi
        d_tc = (-Hc * tc + kk ** 2 * psi) / Hc

        # baryons: full vs TCA combined equation
        slip = (kk ** 2 * (F[0] / 4.0 - sig_g) - cs2 * kk ** 2 * db
                + Hc * tb) / (kap * (1.0 + 1.0 / jnp.maximum(Rb, 1e-30)))
        tb_full = (-Hc * tb + cs2 * kk ** 2 * db + kk ** 2 * psi)
        tb_tca = (-Hc * tb + cs2 * kk ** 2 * db + kk ** 2 * psi) \
            + (kk ** 2 * (F[0] / 4.0 - sig_g) - cs2 * kk ** 2 * db
               + Hc * tb) / (1.0 + Rb)
        d_tb = jnp.where(tca, tb_tca, tb_full) / Hc
        d_db = (-tb) / Hc + 3 * dphi

        # --- photons (conformal-time rates; /Hc at the end) -------------------
        relRate = jnp.minimum(kap, relax)       # stable pin-to-target rate
        Pi = F[2] + G[0] + G[2]
        F2_tca = (8.0 / 15.0) * (kk / jnp.maximum(kap, 1e-30)) * F[1]

        # full-hierarchy rates
        dF_full = [None] * (LG + 1)
        dF_full[0] = -kk * F[1] + 4 * phi_dot
        dF_full[1] = (kk / 3.0) * (F[0] - 2 * F[2]) \
            + (4 * kk / 3.0) * psi + kapEff * (4.0 * tb / (3 * kk) - F[1])
        dF_full[2] = (kk / 5.0) * (2 * F[1] - 3 * F[3]) \
            - kapEff * (F[2] - Pi / 10.0)
        for l in range(3, LG):
            dF_full[l] = (kk / (2 * l + 1.0)) \
                * (l * F[l - 1] - (l + 1) * F[l + 1]) - kapEff * F[l]
        dF_full[LG] = kk * F[LG - 1] \
            - ((LG + 1) / jnp.maximum(tau, 1e-30)) * F[LG] - kapEff * F[LG]
        dF_full = jnp.stack(dF_full)

        dG_full = [None] * (LG + 1)
        dG_full[0] = -kk * G[1] - kapEff * (G[0] - Pi / 2.0)
        dG_full[1] = (kk / 3.0) * (G[0] - 2 * G[2]) - kapEff * G[1]
        dG_full[2] = (kk / 5.0) * (2 * G[1] - 3 * G[3]) \
            - kapEff * (G[2] - Pi / 10.0)
        for l in range(3, LG):
            dG_full[l] = (kk / (2 * l + 1.0)) \
                * (l * G[l - 1] - (l + 1) * G[l + 1]) - kapEff * G[l]
        dG_full[LG] = kk * G[LG - 1] \
            - ((LG + 1) / jnp.maximum(tau, 1e-30)) * G[LG] - kapEff * G[LG]
        dG_full = jnp.stack(dG_full)

        # TCA rates: F0 evolves; F1 tracks theta_b + slip; the quadrupole
        # and polarization pin to their scattering-equilibrium values
        # (Pi = (5/2) F2 -> G0 = (5/4) F2, G2 = (1/4) F2, rest 0)
        tcaTgtF = jnp.zeros(LG + 1, y.dtype).at[1].set(
            (4.0 / (3 * kk)) * (tb + slip)).at[2].set(F2_tca)
        dF_tca = relRate * (tcaTgtF - F)
        dF_tca = dF_tca.at[0].set(-kk * F[1] + 4 * phi_dot)
        dF_tca = dF_tca.at[1].add((4.0 / (3 * kk)) * tb_tca)
        tcaTgtG = jnp.zeros(LG + 1, y.dtype).at[0].set(
            1.25 * F2_tca).at[2].set(0.25 * F2_tca)
        dG_tca = relRate * (tcaTgtG - G)

        # RSA rates: monopole pinned to -4 psi, dipole to 4 phi'/k, the
        # rest relaxed to zero (CLASS-style radiation streaming)
        rsaRate = jnp.minimum(kk, relax)
        rsaTgt = jnp.zeros(LG + 1, y.dtype).at[0].set(-4.0 * psi).at[1].set(
            (4.0 / kk) * phi_dot)
        dF_rsa = rsaRate * (rsaTgt - F)
        dG_rsa = -rsaRate * G

        dF = jnp.where(rsa, dF_rsa, jnp.where(tca, dF_tca, dF_full)) / Hc
        dG = jnp.where(rsa, dG_rsa, jnp.where(tca, dG_tca, dG_full)) / Hc

        # --- neutrinos --------------------------------------------------------
        dN_full = [None] * (LN + 1)
        dN_full[0] = -kk * N[1] + 4 * phi_dot
        dN_full[1] = (kk / 3.0) * (N[0] - 2 * N[2]) + (4 * kk / 3.0) * psi
        for l in range(2, LN):
            dN_full[l] = (kk / (2 * l + 1.0)) \
                * (l * N[l - 1] - (l + 1) * N[l + 1])
        dN_full[LN] = kk * N[LN - 1] \
            - ((LN + 1) / jnp.maximum(tau, 1e-30)) * N[LN]
        dN_full = jnp.stack(dN_full)
        rsaTgtN = jnp.zeros(LN + 1, y.dtype).at[0].set(
            -4.0 * psi).at[1].set((4.0 / kk) * phi_dot)
        dN = jnp.where(rsa_n, rsaRate * (rsaTgtN - N), dN_full) / Hc

        rsaRateP = jnp.minimum(kk, relax)
        dphi = jnp.where(rsa, rsaRateP * (phi_alg - phi) / Hc, dphi)

        dy = jnp.zeros(NV, y.dtype)
        dy = dy.at[I_PHI].set(dphi)
        dy = dy.at[I_DC].set(d_dc)
        dy = dy.at[I_TC].set(d_tc)
        dy = dy.at[I_DB].set(d_db)
        dy = dy.at[I_TB].set(d_tb)
        dy = dy.at[I_F:I_F + LG + 1].set(dF)
        dy = dy.at[I_G:I_G + LG + 1].set(dG)
        dy = dy.at[I_N:I_N + LN + 1].set(dN)
        return dy

    def initial_state(kk):
        """Adiabatic superhorizon RD ICs, unit psi scale.

        Derived from the full system at O(k tau) (and re-derivable from
        it; see tests/test_boltzmann.py::test_superhorizon_curvature):
        with delta = -2 psi, theta_i = (k^2 tau / 2) psi for EVERY
        species, sigma_nu = (1/15) psi (k tau)^2, both Einstein
        constraints are satisfied with phi' = 0 and
        phi = (1 + 2 R_nu / 5) psi."""
        tau0 = float(bg.tau[0])
        psi0 = 1.0
        phi0 = (1.0 + 2.0 * Rnu / 5.0) * psi0
        dg = -2.0 * psi0
        th = (kk ** 2 * tau0 / 2.0) * psi0
        y = jnp.zeros(NV, dtype)
        y = y.at[I_PHI].set(phi0)
        y = y.at[I_DC].set(0.75 * dg)
        y = y.at[I_DB].set(0.75 * dg)
        y = y.at[I_TC].set(th)
        y = y.at[I_TB].set(th)
        y = y.at[I_F + 0].set(dg)
        y = y.at[I_F + 1].set(4.0 * th / (3.0 * kk))
        y = y.at[I_N + 0].set(dg)
        y = y.at[I_N + 1].set(4.0 * th / (3.0 * kk))
        y = y.at[I_N + 2].set((2.0 / 15.0) * (kk * tau0) ** 2 * psi0)
        return y

    def comoving_curvature(y, kk, x):
        """R = phi + Hc (phi'/Hc + psi) x 2/(3(1+w)) with total w."""
        a = jnp.exp(x)
        Hc = interp(x, Hc_t)
        w_tot = ((Og0 + On0) / a ** 2 / 3.0) \
            / ((Oc0 + Ob0_) / a + (Og0 + On0) / a ** 2 + bg.Ol0 * a ** 2)
        # superhorizon: phi' ~ 0; use the state phi
        phi = y[I_PHI]
        sig_g = y[I_F + 2] / 2.0
        sig_n = y[I_N + 2] / 2.0
        w_g = Og0 / a ** 2
        w_n = On0 / a ** 2
        psi = phi - (6.0 * H0m ** 2 / kk ** 2) * (w_g * sig_g
                                                  + w_n * sig_n)
        return phi + (2.0 / (3.0 * (1.0 + w_tot))) * psi

    def relax_step(y, x, kk, h_tau):
        """Exact Thomson-scattering relaxation over one step (operator
        splitting): the drag pair (theta_gamma, theta_b) relaxes to its
        momentum-conserving average at rate kappa'(1 + 1/R_b); the
        coupled quadrupole/polarization trio (F2, G0, G2) follows its
        closed-form matrix exponential (Pi decays at 0.3 kappa', the
        orthogonal combinations at kappa'); every other multipole decays
        as exp(-kappa' h).  Unconditionally stable and exact for the
        linear scattering operator, so no stability caps are needed.
        Skipped inside TCA (the algebraic pins already encode the
        equilibrium including the first-order slip)."""
        a = jnp.exp(x)
        Hc = interp(x, Hc_t)
        kap = interp(x, kap_t)
        Rb = 0.75 * (Ob0_ / a) / (Og0 / a ** 2)
        tca = kap > TCA_FAC * jnp.maximum(kk, Hc)

        F = y[I_F:I_F + LG + 1]
        G = y[I_G:I_G + LG + 1]
        tb = y[I_TB]
        th_g = 0.75 * kk * F[1]

        kh = kap * h_tau
        E1 = jnp.exp(-kh)

        # drag pair: conserved theta_bar, slip decays at kap(1 + 1/Rb)
        Ed = jnp.exp(-kh * (1.0 + 1.0 / jnp.maximum(Rb, 1e-30)))
        thBar = (th_g + Rb * tb) / (1.0 + Rb)
        S = (th_g - tb) * Ed
        th_gN = thBar + (Rb / (1.0 + Rb)) * S
        tbN = thBar - (1.0 / (1.0 + Rb)) * S

        # trio (F2, G0, G2): u(h) = u0 E1 + c Pi0 (E03 - E1) / 0.7
        E03 = jnp.exp(-0.3 * kh)
        Pi0 = F[2] + G[0] + G[2]
        fac = Pi0 * (E03 - E1) / 0.7
        F2N = F[2] * E1 + 0.1 * fac
        G0N = G[0] * E1 + 0.5 * fac
        G2N = G[2] * E1 + 0.1 * fac

        FN = F * E1
        FN = FN.at[0].set(F[0])
        FN = FN.at[1].set(4.0 * th_gN / (3.0 * kk))
        FN = FN.at[2].set(F2N)
        GN = G * E1
        GN = GN.at[0].set(G0N)
        GN = GN.at[2].set(G2N)

        yN = y
        yN = yN.at[I_TB].set(tbN)
        yN = yN.at[I_F:I_F + LG + 1].set(FN)
        yN = yN.at[I_G:I_G + LG + 1].set(GN)
        return jnp.where(tca, y, yN)

    def rk4_step(y, x, kk):
        Hc = interp(x, Hc_t)
        h = dlna
        h_tau = h / Hc
        k1 = derivs(x, y, kk, h_tau)
        k2 = derivs(x + h / 2, y + h / 2 * k1, kk, h_tau)
        k3 = derivs(x + h / 2, y + h / 2 * k2, kk, h_tau)
        k4 = derivs(x + h, y + h * k3, kk, h_tau)
        yN = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        return relax_step(yN, x + h, kk, h_tau)

    return {"derivs": derivs, "initial_state": initial_state,
            "comoving_curvature": comoving_curvature,
            "rk4_step": rk4_step, "lna": lna,
            "I_DC": I_DC, "I_DB": I_DB, "Oc0": Oc0, "Ob0": Ob0_}


def transfer_function(kMpc, H0=70.0, Om0=0.3, Ob0=0.05, nGrid=24576,
                      dtype=np.float64):
    """Linear matter transfer function delta_m(k, z=0) / R_init.

    Args:
        kMpc: 1-d array of comoving wavenumbers in Mpc^-1 (<= ~60; the
            integrator's step budget is tuned for the sigma(M) range).
    Returns:
        (T, diag): T same shape as kMpc (arbitrary overall scale -
        callers normalise to sigma8, as the reference does through
        CCL); diag dict with the initial comoving curvature, for the
        test suite.
    """
    import jax
    import jax.numpy as jnp

    # The stiff pre-recombination system needs float64: in a production
    # session (x64 off) jnp would silently truncate every table to
    # float32.  Pin the whole solve to the host CPU backend under a
    # thread-local x64 context instead - the solver is a one-off per
    # cosmology.
    with jax.enable_x64(True), \
            jax.default_device(jax.devices("cpu")[0]):
        bg = _solver_tables(float(H0), float(Om0), float(Ob0), int(nGrid))
        k = np.asarray(kMpc, dtype=np.float64)
        sysd = _make_system(bg, dtype)
        lna = sysd["lna"]
        I_DC, I_DB = sysd["I_DC"], sysd["I_DB"]
        Oc0, Ob0_ = sysd["Oc0"], sysd["Ob0"]

        def solve_one(kk):
            y0 = sysd["initial_state"](kk)
            R0 = sysd["comoving_curvature"](y0, kk, lna[0])

            def step(carry, x):
                return sysd["rk4_step"](carry, x, kk), None

            yF, _ = jax.lax.scan(step, y0, lna[:-1])
            dm = (Oc0 * yF[I_DC] + Ob0_ * yF[I_DB]) / (Oc0 + Ob0_)
            return dm / R0, R0

        Tk, R0 = jax.vmap(solve_one)(jnp.asarray(k, dtype))
        return np.asarray(Tk), {"R0": np.asarray(R0)}


def debug_trajectory(kk, H0=70.0, Om0=0.3, Ob0=0.05, nGrid=8192,
                     dtype=np.float64, every=8):
    """Per-step state snapshots for one k (diagnostics / tests).

    Returns (lna_snap, ys (nSnap, NV), R (nSnap,)) with R the comoving
    curvature at each snapshot - superhorizon R must stay constant.
    """
    import jax
    import jax.numpy as jnp

    bg = _solver_tables(float(H0), float(Om0), float(Ob0), int(nGrid))
    sysd = _make_system(bg, dtype)
    lna = sysd["lna"]
    kkA = jnp.asarray(float(kk), dtype)
    y0 = sysd["initial_state"](kkA)

    def step(carry, x):
        yN = sysd["rk4_step"](carry, x, kkA)
        return yN, yN

    yF, ys = jax.lax.scan(step, y0, lna[:-1])
    ys = np.asarray(ys)[::every]
    lnas = np.asarray(lna[1:])[::every]
    R = np.array([np.asarray(sysd["comoving_curvature"](
        jnp.asarray(y), kkA, x)) for y, x in zip(ys, lnas)])
    return lnas, ys, R
