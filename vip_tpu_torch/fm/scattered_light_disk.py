"""Synthetic scattered-light disk model (port of
``vip_tpu.fm.scattered_light_disk``, GRaTeR-style [AUG99]).

Same classes and parameters as vip_tpu: ``ScatteredLightDisk``,
``Dust_distribution``, ``DustEllipticalDistribution2PowerLaws``,
``Phase_function`` and the HG, double-HG and interpolated phase
functions. The line-of-sight integration (vip_tpu
scattered_light_disk.py:33-84) is one tensor program over the
(nbSlices, ny, nx) grid with a validity mask, on the default device (the
card unless the caller asked for the CPU), in float64 unless
``compute_scattered_light(dtype=...)`` asks otherwise. The analytic phase
functions (HG, double HG, Rayleigh polarisation) evaluate on the device;
the interpolated SPF and the polynomial polarisation evaluate on the host
through scipy and numpy, as in vip_tpu (:254-256), from the device's
scattering angles. The image geometry (maps of x, y, the slices) is built
on the host in float64, as vip_tpu builds it.
"""

import numpy as np
import torch
from scipy.interpolate import PchipInterpolator, interp1d

from ..config.device import get_device
from ..var.coords import frame_center

__all__ = ["ScatteredLightDisk", "Dust_distribution",
           "DustEllipticalDistribution2PowerLaws", "Phase_function"]


def _hg(g, cos_phi):
    """Single Henyey-Greenstein (vip_tpu scattered_light_disk.py:27):
    numpy or tensor ``cos_phi``."""
    return 1.0 / (4 * np.pi) * (1 - g**2) / (1 + g**2 - 2 * g * cos_phi)**1.5


def _los_geometry(x_map, y_map, lz0_map, dl_map, ll, cosi, sini):
    """The line-of-sight samples of every pixel, (nbSlices, ny, nx) each:
    disk-frame coordinates (xd, yd, zd), the squared distance to the star
    and the cosine of the scattering angle."""
    l_ = lz0_map[None] + ll[:, None, None] * dl_map[None]
    xd = x_map[None].expand_as(l_)
    yd = cosi * y_map[None] + sini * l_
    zd = -sini * y_map[None] + cosi * l_
    d2star = xd**2 + yd**2 + zd**2
    dstar = torch.sqrt(d2star)
    rstar = torch.sqrt(xd**2 + yd**2)
    thetastar = torch.atan2(yd, xd)
    cosphi = (rstar * sini * torch.sin(thetastar) + zd * cosi) / dstar
    return xd, yd, zd, d2star, cosphi


def _trapezoid(image, ll, dl_map, valid, pxInAU):
    """Trapezoidal integral over the slices (vip_tpu
    scattered_light_disk.py:80-84)."""
    dll = (ll[1:] - ll[:-1])[:, None, None]
    smap = torch.sum(dll * (image[:-1] + image[1:]), dim=0)
    return torch.where(valid, smap * (dl_map / 2.0 * pxInAU**2), 0.0)


def _scattered_light_core(x_map, y_map, lz0_map, dl_map, valid, ll, cosi,
                          sini, xdo, ydo, omega_rad, ecc, ain, aout, p, pmin,
                          dens_at_r0, ksi0, gamma, beta, pxInAU, spf_kind,
                          g1, g2, weight, polar):
    """The whole line-of-sight integral for an HG ('hg') or double-HG
    ('dhg') phase function, on the tensors' device (vip_tpu
    scattered_light_disk.py:33): the un-normalized image (ny, nx).
    ``polar`` applies the Rayleigh polarised fraction
    (1 - cos²φ)/(1 + cos²φ)."""
    xd, yd, zd, d2star, cosphi = _los_geometry(x_map, y_map, lz0_map,
                                               dl_map, ll, cosi, sini)
    r = torch.sqrt((xd - xdo)**2 + (yd - ydo)**2)
    theta = torch.atan2(yd - ydo, xd - xdo)
    costheta = torch.cos(theta - omega_rad)

    # radial 2-power-law and vertical profile
    radial_ratio = r / (p / (1.0 - ecc * costheta))
    rr = torch.clamp(radial_ratio, min=1e-300)
    den = rr**(-2 * ain) + rr**(-2 * aout)
    radial_term = torch.sqrt(2.0 / den) * dens_at_r0
    if pmin > 0:
        radial_term = torch.where(r / (pmin / (1.0 - ecc * costheta)) <= 1.0,
                                  0.0, radial_term)
    den2 = ksi0 * rr**beta
    rho = radial_term * torch.exp(-(torch.abs(zd) / den2)**gamma)

    if spf_kind == "hg":
        phf = _hg(g1, cosphi)
    else:
        phf = weight * _hg(g1, cosphi) + (1 - weight) * _hg(g2, cosphi)
    if polar:
        phf = phf * (1 - cosphi**2) / (1 + cosphi**2)
    image = torch.where(valid[None], rho * phf / d2star, 0.0)
    return _trapezoid(image, ll, dl_map, valid, pxInAU)


def _print_block(title, rows):
    """Underlined section header followed by one line per row."""
    bar = "-" * len(title)
    print(bar)
    print(title)
    print(bar)
    for row in rows:
        print(row)


class ScatteredLightDisk:
    """Synthetic scattered-light disk image generator (vip_tpu
    scattered_light_disk.py:97; GRaTeR-style model [AUG99]). The
    line-of-sight integration runs as one tensor program on the device."""

    def __init__(self, nx=200, ny=200, distance=50., itilt=60., omega=0.,
                 pxInArcsec=0.01225, pa=0., flux_max=None,
                 density_dico={'name': '2PowerLaws', 'ain': 5, 'aout': -5,
                               'a': 40, 'e': 0, 'ksi0': 1., 'gamma': 2.,
                               'beta': 1., 'dens_at_r0': 1.},
                 spf_dico={'name': 'HG', 'g': 0., 'polar': False}, xdo=0.,
                 ydo=0., xs=None, ys=None):
        self.nx, self.ny = nx, ny
        self.distance = distance
        self.set_inclination(itilt)
        self.set_omega(omega)
        self.set_flux_max(flux_max)
        self.pxInArcsec = pxInArcsec
        self.pxInAU = pxInArcsec * distance
        self.xdo, self.ydo = xdo, ydo
        self.rmin = np.hypot(xdo, ydo) + self.pxInAU
        self.dust_density = Dust_distribution(density_dico)
        if xs is None or ys is None:
            self.yc, self.xc = frame_center((ny, nx))
        else:
            self.yc, self.xc = ys, xs
        self.x_vector = (np.arange(nx) - self.xc) * self.pxInAU
        self.y_vector = (np.arange(ny) - self.yc) * self.pxInAU
        self.x_map_0PA, self.y_map_0PA = np.meshgrid(
            self.x_vector, self.y_vector)
        self.set_pa(pa)
        self.phase_function = Phase_function(spf_dico=spf_dico)
        self.scattered_light_map = np.zeros((ny, nx))

    def set_inclination(self, itilt):
        """Set disk inclination in degrees (0 pole-on, 90 edge-on)."""
        self.itilt = float(itilt)
        self.cosi = np.cos(np.deg2rad(self.itilt))
        self.sini = np.sin(np.deg2rad(self.itilt))

    def set_pa(self, pa):
        """Set disk position angle in degrees."""
        self.pa = pa
        self.cospa = np.cos(np.deg2rad(self.pa))
        self.sinpa = np.sin(np.deg2rad(self.pa))
        self.y_map = self.cospa * self.x_map_0PA + self.sinpa * self.y_map_0PA
        self.x_map = -self.sinpa * self.x_map_0PA + self.cospa * self.y_map_0PA

    def set_omega(self, omega):
        """Set argument of pericenter in degrees."""
        self.omega = float(omega)

    def set_flux_max(self, flux_max):
        """Set the maximum flux of the disk (None = no normalization)."""
        self.flux_max = flux_max

    def set_density_distribution(self, density_dico):
        """Update the dust density distribution parameters."""
        self.dust_density.set_density_distribution(density_dico)

    def set_phase_function(self, spf_dico):
        """Update the scattering phase function."""
        self.phase_function = Phase_function(spf_dico=spf_dico)

    def print_info(self):
        """Print disk and image parameters."""
        rows = [
            f"Image size: {self.nx:d} px by {self.ny:d} px",
            f"Pixel size: {self.pxInArcsec:.4f} arcsec/px or "
            f"{self.pxInAU:.2f} au/px",
            f"Distance of the star {self.distance:.1f} pc",
            f"From {self.x_vector[0]:.1f} au to "
            f"{self.x_vector[-1]:.1f} au in X",
            f"From {self.y_vector[0]:.1f} au to "
            f"{self.y_vector[self.nx - 1]:.1f} au in Y",
            f"Position angle of the disc: {self.pa:.2f} degrees",
            f"Inclination {self.itilt:.2f} degrees",
            f"Argument of pericenter {self.omega:.2f} degrees",
        ]
        if self.flux_max is not None:
            rows.append(f"Maximum flux of the disk {self.flux_max:.2f}")
        _print_block("Geometrical properties of the image", rows)
        self.dust_density.print_info()
        self.phase_function.print_info()

    def check_inclination(self):
        """Clamp near-edge-on inclinations to the numerical threshold
        (vip_tpu scattered_light_disk.py:185)."""
        calc = self.dust_density.dust_distribution_calc
        if np.abs(np.mod(self.itilt, 180) - 90) < np.abs(
                np.mod(calc.itiltthreshold, 180) - 90):
            print('Warning the disk is too close to edge-on')
            print('The inclination was changed from {0:.2f} to {1:.2f}'
                  .format(self.itilt, calc.itiltthreshold))
            self.set_inclination(calc.itiltthreshold)

    def _los_arrays(self, halfNbSlices):
        """Host geometry of the integration (vip_tpu
        scattered_light_disk.py:196): lz0, dl, the validity mask and the
        slice positions, float64 numpy."""
        calc = self.dust_density.dust_distribution_calc
        lz0_map = self.y_map * np.tan(np.deg2rad(self.itilt))
        lzp_map = calc.zmax / self.cosi + lz0_map
        lzm_map = -calc.zmax / self.cosi + lz0_map
        dl_map = np.absolute(lzp_map - lzm_map)
        lmax2 = calc.rmax**2 - (self.x_map**2 + self.y_map**2)
        lmin2 = (self.x_map**2 + self.y_map**2) - self.rmin**2
        valid = (lmax2 > 0.) & (lmin2 > 0.)
        lwidth = 100.
        tmp = (np.exp(np.arange(halfNbSlices) * np.log(lwidth + 1.) /
                      (halfNbSlices - 1.)) - 1.) / lwidth
        ll = np.concatenate((-tmp[:0:-1], tmp))
        return lz0_map, dl_map, valid, ll

    def compute_scattered_light(self, halfNbSlices=25, *, device=None,
                                dtype=torch.float64):
        """The scattered-light image (vip_tpu scattered_light_disk.py:212),
        a (ny, nx) tensor on ``device`` (default: the port's device) in
        ``dtype``, also kept as ``scattered_light_map``. HG and double HG
        (with the Rayleigh polarised fraction) run wholly on the device;
        the interpolated SPF and the polynomial polarisation take the
        scattering angles to the host for the phase function."""
        self.check_inclination()
        calc = self.dust_density.dust_distribution_calc
        lz0_map, dl_map, valid, ll = self._los_arrays(halfNbSlices)
        dev = get_device() if device is None else torch.device(device)

        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=dev)

        x_map, y_map, lz0, dl, lls = (t(self.x_map), t(self.y_map),
                                      t(lz0_map), t(dl_map), t(ll))
        valid_t = torch.as_tensor(valid, device=dev)
        pf = self.phase_function
        if pf.type in ('HG', 'DoubleHG') and not pf.polar_polynom:
            if pf.type == 'HG':
                spf_kind, g1, g2, weight = 'hg', pf.phase_function_calc.g, \
                    0.0, 1.0
            else:
                c = pf.phase_function_calc
                spf_kind, g1, g2, weight = 'dhg', c.g[0], c.g[1], c.weight
            smap = _scattered_light_core(
                x_map, y_map, lz0, dl, valid_t, lls, self.cosi, self.sini,
                self.xdo, self.ydo, np.deg2rad(self.omega), calc.e, calc.ain,
                calc.aout, calc.p, calc.pmin, calc.dens_at_r0, calc.ksi0,
                calc.gamma, calc.beta, self.pxInAU, spf_kind, float(g1),
                float(g2), float(weight), pf.polar)
        else:
            smap = self._compute_host_spf(x_map, y_map, lz0, dl, valid_t,
                                          lls)
        if self.flux_max is not None:
            peak = torch.where(torch.isnan(smap), -torch.inf, smap).max()
            smap = smap * (self.flux_max / peak)
        self.scattered_light_map = smap
        return smap

    def _compute_host_spf(self, x_map, y_map, lz0, dl, valid, ll):
        """The integral for the phase functions that need scipy or a
        polarisation polynomial (vip_tpu scattered_light_disk.py:254):
        the geometry and density on the device, the phase function of the
        clipped cos φ on the host."""
        xd, yd, zd, d2star, cosphi = _los_geometry(x_map, y_map, lz0, dl, ll,
                                                   self.cosi, self.sini)
        r = torch.sqrt((xd - self.xdo)**2 + (yd - self.ydo)**2)
        theta = torch.atan2(yd - self.ydo, xd - self.xdo)
        costheta = torch.cos(theta - np.deg2rad(self.omega))
        rho = self.dust_density.density_cylindrical(r, costheta, zd)
        host = torch.clamp(cosphi, -1.0, 1.0).cpu().numpy()
        phf = torch.as_tensor(
            self.phase_function.compute_phase_function_from_cosphi(host),
            dtype=cosphi.dtype, device=cosphi.device)
        image = torch.where(valid[None], rho * phf / d2star, 0.0)
        return _trapezoid(image, ll, dl, valid, self.pxInAU)

    def get_scattering_angle(self):
        """Image of the midplane scattering angle in degrees, host numpy
        (vip_tpu scattered_light_disk.py:279)."""
        lz0_map = self.y_map * np.tan(np.deg2rad(self.itilt))
        xd = self.x_map
        yd = self.cosi * self.y_map + self.sini * lz0_map
        zd = -self.sini * self.y_map + self.cosi * lz0_map
        d2star = xd**2 + yd**2 + zd**2
        dstar = np.sqrt(d2star)
        rstar = np.sqrt(xd**2 + yd**2)
        thetastar = np.arctan2(yd, xd)
        cosphi = (rstar * self.sini * np.sin(thetastar) +
                  zd * self.cosi) / dstar
        return np.rad2deg(np.arccos(cosphi))


class Dust_distribution:
    """Dust density distribution (vip_tpu scattered_light_disk.py:295)."""

    def __init__(self, density_dico={'name': '2PowerLaws', 'ain': 5,
                                     'aout': -5, 'a': 60, 'e': 0, 'ksi0': 1.,
                                     'gamma': 2., 'beta': 1., 'amin': 0.,
                                     'dens_at_r0': 1.}):
        self.accuracy = 5.e-3
        if not isinstance(density_dico, dict):
            raise TypeError('The dust density distribution parameters '
                            'must come as a Python dict')
        if 'name' not in density_dico:
            raise TypeError('The dust density distribution dict requires '
                            'the key "name"')
        self.type = density_dico['name']
        if self.type != '2PowerLaws':
            raise TypeError('The only dust distribution implemented so '
                            'far is the "2PowerLaws"')
        self.dust_distribution_calc = DustEllipticalDistribution2PowerLaws(
            self.accuracy, density_dico)

    def set_density_distribution(self, density_dico):
        """Update the parameters of the density distribution."""
        self.dust_distribution_calc.set_density_distribution(density_dico)

    def density_cylindrical(self, r, costheta, z):
        """Particle volume density at (r, theta, z)."""
        return self.dust_distribution_calc.density_cylindrical(r, costheta, z)

    def density_cartesian(self, x, y, z):
        """Particle volume density at (x, y, z) incl. disk offset."""
        return self.dust_distribution_calc.density_cartesian(x, y, z)

    def print_info(self, pxInAu=None):
        """Print the dust distribution parameters."""
        _print_block("Dust distribution parameters", [])
        self.dust_distribution_calc.print_info(pxInAu)


class DustEllipticalDistribution2PowerLaws:
    """Elliptical 2-power-law dust distribution
    (reference scattered_light_disk.py:466-745)."""

    def __init__(self, accuracy=5.e-3,
                 density_dico={'ain': 5, 'aout': -5, 'a': 60, 'e': 0,
                               'ksi0': 1., 'gamma': 2., 'beta': 1.,
                               'amin': 0., 'dens_at_r0': 1.}):
        self.accuracy = accuracy
        self.set_density_distribution(density_dico)

    def set_density_distribution(self, density_dico):
        """Set all distribution parameters with reference defaults."""
        ksi0 = density_dico.get('ksi0', 1.)
        beta = density_dico.get('beta', 1.)
        gamma = density_dico.get('gamma', 1.)
        aout = density_dico.get('aout', -5.)
        ain = density_dico.get('ain', 5.)
        e = density_dico.get('e', 0.)
        a = density_dico.get('a', 60.)
        amin = density_dico.get('amin', 0.)
        dens_at_r0 = density_dico.get('dens_at_r0', 1.)
        self.set_vertical_density(ksi0=ksi0, gamma=gamma, beta=beta)
        self.set_radial_density(ain=ain, aout=aout, a=a, e=e, amin=amin,
                                dens_at_r0=dens_at_r0)

    @staticmethod
    def _sanitize(name, value, lo=None, hi=None, lo_sub=None, hi_sub=None):
        """Clamp an out-of-range disk parameter to its nearest safe value,
        warning like the reference does (scattered_light_disk.py:544-604)."""
        if lo is not None and value < lo:
            print(f"Warning: {name}={value:.2f} is below {lo}; "
                  f"using {lo_sub}")
            return lo_sub
        if hi is not None and value > hi:
            print(f"Warning: {name}={value:.2f} is above {hi}; "
                  f"using {hi_sub}")
            return hi_sub
        return value

    def set_vertical_density(self, ksi0=1., gamma=2., beta=1.):
        """Set the vertical profile: scale height ``ksi0``, shape exponent
        ``gamma`` and flaring index ``beta`` (all clamped to >= 0)."""
        self.gamma = float(self._sanitize("gamma", gamma, lo=0., lo_sub=0.1))
        self.ksi0 = float(self._sanitize("ksi0", ksi0, lo=0., lo_sub=0.1))
        self.beta = float(self._sanitize("beta", beta, lo=0., lo_sub=0.))
        self.zmax = self.ksi0 * (-np.log(self.accuracy)) ** (1. / self.gamma)

    def set_radial_density(self, ain=5., aout=-5., a=60., e=0., amin=0.,
                           dens_at_r0=1.):
        """Set the two-power-law radial profile: slopes ``ain``/``aout``,
        reference radius ``a``, eccentricity ``e``, inner cutoff ``amin``."""
        for name, value in (("a", a), ("amin", amin),
                            ("dens_at_r0", dens_at_r0)):
            if value < 0:
                raise ValueError(f"disk parameter {name} must be >= 0, "
                                 f"got {value}")
        self.ain = float(self._sanitize("ain", ain, lo=0.1, lo_sub=0.1))
        self.aout = float(self._sanitize("aout", aout, hi=-0.1, hi_sub=-0.1))
        self.e = float(self._sanitize("e", self._sanitize(
            "e", e, lo=0., lo_sub=0.), hi=0.99, hi_sub=0.99))
        self.a = float(a)
        self.p = self.a * (1 - self.e ** 2)
        self.amin = float(amin)
        self.pmin = self.amin * (1 - self.e ** 2)
        self.dens_at_r0 = float(dens_at_r0)
        self.rmax = self.a * self.accuracy ** (1 / self.aout)
        if self.ain != self.aout:
            self.apeak = self.a * np.power(
                -self.ain / self.aout, 1. / (2. * (self.ain - self.aout)))
            Gamma_in = self.ain + self.beta
            Gamma_out = self.aout + self.beta
            self.apeak_surface_density = self.a * np.power(
                -Gamma_in / Gamma_out, 1. / (2. * (Gamma_in - Gamma_out)))
        else:
            self.apeak = self.a
            self.apeak_surface_density = self.a
        self.itiltthreshold = np.rad2deg(np.arctan(self.rmax / self.zmax))

    def density_cylindrical(self, r, costheta, z):
        """Particle volume density at (r, theta, z) of numpy arrays or
        tensors (reference scattered_light_disk.py:746-757)."""
        xp = torch if isinstance(r, torch.Tensor) else np
        radial_ratio = r / (self.p / (1 - self.e * costheta))
        den = (radial_ratio ** (-2 * self.ain) +
               radial_ratio ** (-2 * self.aout))
        radial_density_term = xp.sqrt(2. / den) * self.dens_at_r0
        if self.pmin > 0:
            radial_density_term[
                r / (self.pmin / (1 - self.e * costheta)) <= 1] = 0
        den2 = self.ksi0 * radial_ratio ** self.beta
        vertical_density_term = xp.exp(-(xp.abs(z) / den2) ** self.gamma)
        return radial_density_term * vertical_density_term

    def density_cartesian(self, x, y, z):
        """Particle volume density at (x, y, z) incl. the disk offset."""
        r = np.sqrt(x**2 + y**2)
        if np.isscalar(r):
            costheta = 0 if r == 0 else x / r
        else:
            costheta = np.where(r == 0, 0.0, x / np.where(r == 0, 1.0, r))
        return self.density_cylindrical(r, costheta, z)

    def print_info(self, pxInAu=None):
        """Print the radial distribution parameters."""
        from scipy.optimize import newton

        def rad_density(r):
            return np.sqrt(2 / (np.power(r / self.a, -2 * self.ain) +
                                np.power(r / self.a, -2 * self.aout)))

        def half_max_density(r):
            return rad_density(r) / rad_density(self.apeak) - 1. / 2.

        try:
            start = self.apeak * (1.04 if self.aout < -3 else 1.1)
            a_plus_hwhm = newton(half_max_density, start)
        except RuntimeError:
            a_plus_hwhm = np.nan
        try:
            start = self.apeak * (0.5 if self.ain < 2 else 0.95)
            a_minus_hwhm = newton(half_max_density, start)
        except RuntimeError:
            a_minus_hwhm = np.nan
        vert_fwhm = 2. * self.ksi0 * np.power(np.log10(2.), 1. / self.gamma)
        if pxInAu is not None:
            rows = [
                f"Reference semi-major axis: {self.a:.1f}au or "
                f"{self.a / pxInAu:.1f}px",
                "Semi-major axis at maximum dust density in plane z=0: "
                f"{self.apeak:.1f}au or {self.apeak / pxInAu:.1f}px "
                "(same as ref sma if ain=-aout)",
            ]
        else:
            rows = [
                f"Reference semi-major axis: {self.a:.1f}au",
                "Semi-major axis at maximum dust density in plane z=0: "
                f"{self.apeak:.1f}au (same as ref sma if ain=-aout)",
                "Semi-major axis at half max dust density: "
                f"{a_minus_hwhm:.1f}au / {a_plus_hwhm:.1f}au for the "
                f"inner/outer edge, or a FWHM of "
                f"{a_plus_hwhm - a_minus_hwhm:.1f}au",
            ]
        rows += [
            f"Ellipticity: {self.e:.3f}",
            f"Inner slope: {self.ain:.2f}",
            f"Outer slope: {self.aout:.2f}",
            f"Density at the reference semi-major axis: "
            f"{self.dens_at_r0:4.3e}(arbitrary unit)",
        ]
        if self.amin > 0:
            rows.append(f"Minimum radius (sma): {self.amin:.2f}au")
        rows += [
            f"Scale height: {self.ksi0:.2f} au at {self.a:.2f}",
            f"Vertical profile index: {self.gamma:.2f}",
            f"Disc vertical FWHM: {vert_fwhm:.2f} at {self.a:.2f}",
            f"Flaring coefficient: {self.beta:.2f}",
        ]
        for row in rows:
            print(row)
        _print_block("Properties for numerical integration", [
            f"Requested accuracy {self.accuracy:.2e}",
            f"Maximum radius for integration: {self.rmax:.2f} au",
            f"Maximum height for integration: {self.zmax:.2f} au",
            f"Inclination threshold: {self.itiltthreshold:.2f} degrees",
        ])


class Phase_function:
    """Scattering phase function dispatcher
    (reference scattered_light_disk.py:769-900)."""

    def __init__(self, spf_dico={'name': 'HG', 'g': 0., 'polar': False}):
        if not isinstance(spf_dico, dict):
            raise TypeError('The parameters describing the phase function '
                            'must be a Python dictionnary')
        if 'name' not in spf_dico.keys():
            raise TypeError('The dictionnary describing the phase function '
                            'must contain the key "name"')
        self.type = spf_dico['name']
        self.polar = spf_dico.get('polar', False)
        if not isinstance(self.polar, bool):
            raise TypeError('The dictionnary describing the polarisation '
                            'must be a boolean')
        coeffs = spf_dico.get('polar_polynom_coeff') if self.polar else None
        self.polar_polynom = coeffs is not None
        if self.polar_polynom:
            if not isinstance(coeffs, (tuple, list, np.ndarray)):
                raise TypeError('The dictionnary describing the '
                                'polarisation polynomial function must '
                                'be an array.')
            self.polar_polynom_coeff = coeffs
        backends = {'HG': HenyeyGreenstein_SPF,
                    'DoubleHG': DoubleHenyeyGreenstein_SPF,
                    'interpolated': Interpolated_SPF}
        if self.type not in backends:
            raise TypeError('Type of phase function not understood: '
                            '{0:s}'.format(self.type))
        self.phase_function_calc = backends[self.type](spf_dico)

    def compute_phase_function_from_cosphi(self, cos_phi):
        """Phase function value(s) at cos(phi)."""
        phf = self.phase_function_calc.compute_phase_function_from_cosphi(
            cos_phi)
        if self.polar:
            if getattr(self, 'polar_polynom', False):
                phi = np.rad2deg(np.arccos(cos_phi))
                return np.polyval(self.polar_polynom_coeff, phi) * phf
            return (1 - cos_phi**2) / (1 + cos_phi**2) * phf
        return phf

    def print_info(self):
        """Print the phase function type and parameters."""
        _print_block("Phase function parameters",
                     [f"Type of phase function: {self.type}",
                      f"Linear polarisation: {self.polar!r}"])
        self.phase_function_calc.print_info()

    def plot_phase_function(self):
        """Plot the SPF (matplotlib import gated for headless envs).

        Note: like the reference (scattered_light_disk.py:869-890), the
        polar modulation ends up applied twice in this plot."""
        import matplotlib.pyplot as plt

        phi = np.arange(0, 180, 1)
        spf = self.compute_phase_function_from_cosphi(
            np.cos(np.deg2rad(phi)))
        if self.polar:
            if getattr(self, 'polar_polynom', False):
                spf = np.polyval(self.polar_polynom_coeff, phi) * spf
            else:
                cos2 = np.cos(np.deg2rad(phi)) ** 2
                spf = (1 - cos2) / (1 + cos2) * spf
        plt.close(0)
        plt.figure(0)
        plt.plot(phi, spf)
        plt.xlabel("Scattering phase angle [deg]")
        plt.ylabel("Scattering phase function")
        plt.xlim(0, 180)
        plt.grid()
        plt.show()


class HenyeyGreenstein_SPF:
    """Single Henyey-Greenstein phase function
    (reference scattered_light_disk.py:902-956)."""

    def __init__(self, spf_dico={'g': 0.}):
        if 'g' not in spf_dico:
            raise TypeError('A Henyey-Greenstein phase-function dict '
                            'requires the key "g"')
        if not isinstance(spf_dico['g'], (float, int)):
            raise TypeError('"g" of a Henyey-Greenstein phase-function '
                            'dict must be a float or an integer')
        self.set_phase_function(spf_dico['g'])

    def set_phase_function(self, g):
        """Set g, clamping to (-1, 1) as the reference does."""
        if not -1 < g < 1:
            side = 0.99 if g >= 1 else -0.99
            print(f"Warning the Henyey Greenstein parameter is "
                  f"{'greater' if g >= 1 else 'smaller'} than or equal "
                  f"to {1 if g >= 1 else -1}")
            print(f"The value was changed from {g:6.2f} to {side}")
            g = side
        self.g = float(g)

    def compute_phase_function_from_cosphi(self, cos_phi):
        """HG phase function at cos(phi)."""
        return _hg(self.g, cos_phi)

    def print_info(self):
        """Print g."""
        print('Heynyey Greenstein coefficient: {0:.2f}'.format(self.g))


class DoubleHenyeyGreenstein_SPF:
    """Double Henyey-Greenstein phase function
    (reference scattered_light_disk.py:959-1035)."""

    def __init__(self, spf_dico={'g': [0.5, -0.3], 'weight': 0.7}):
        if 'g' not in spf_dico:
            raise TypeError('A double Henyey-Greenstein phase-function '
                            'dict requires the key "g"')
        if not isinstance(spf_dico['g'], (list, tuple, np.ndarray)):
            raise TypeError('"g" of a double Henyey-Greenstein '
                            'phase-function dict must be a list of floats')
        if 'weight' not in spf_dico:
            raise TypeError('A double Henyey-Greenstein phase-function '
                            'dict requires the key "weight"')
        weight = spf_dico['weight']
        if not isinstance(weight, (float, int)):
            raise TypeError('"weight" of a double Henyey-Greenstein '
                            'phase-function dict must be a float (weight '
                            'of the first HG coefficient, within [0, 1])')
        if not 0 <= weight <= 1:
            raise ValueError('"weight" of a double Henyey-Greenstein '
                             'phase-function dict is the weight of the '
                             'first HG coefficient: it must lie in [0, 1]')
        if len(spf_dico['g']) != 2:
            raise TypeError('The keys "weight" and "g" must contain the '
                            'same number of elements')
        self.g = spf_dico['g']
        self.weight = weight

    def print_info(self):
        """Print the two HG coefficients and the weight."""
        print('Heynyey Greenstein first component : coeff {0:.2f} , '
              'weight {1:.1f}%'.format(self.g[0], self.weight * 100))
        print('Heynyey Greenstein second component: coeff {0:.2f} , '
              'weight {1:.1f}%'.format(self.g[1], (1 - self.weight) * 100.))

    def compute_singleHG_from_cosphi(self, g, cos_phi):
        """Single HG component at cos(phi)."""
        return _hg(g, cos_phi)

    def compute_phase_function_from_cosphi(self, cos_phi):
        """Weighted double HG at cos(phi)."""
        return (self.weight * _hg(self.g[0], cos_phi) +
                (1 - self.weight) * _hg(self.g[1], cos_phi))


class Interpolated_SPF:
    """Interpolated custom phase function
    (reference scattered_light_disk.py:1036-1133)."""

    def __init__(self, spf_dico={'phi': np.array([0, 18, 36, 54, 72, 90, 108,
                                                  126, 144, 162]),
                                 'spf': np.array([3.580, 0.703, 0.141, 0.0489,
                                                  0.0233, 0.0136, 0.0091,
                                                  0.0069, 0.0056, 0.005])}):
        for key in ('phi', 'spf'):
            if key not in spf_dico:
                raise TypeError(f'An "interpolated" phase-function dict '
                                f'requires the key "{key}"')
            if not isinstance(spf_dico[key], (list, tuple, np.ndarray)):
                raise TypeError(f'"{key}" of an "interpolated" '
                                'phase-function dict must be a list, '
                                'numpy array or tuple')
        if len(spf_dico['phi']) != len(spf_dico['spf']):
            raise TypeError('The keys "phi" and "spf" must contain the '
                            'same number of elements')
        self.interpolate_phase_function(spf_dico)

    def print_info(self):
        """Print a sampling of the interpolated SPF."""
        phi = np.linspace(0, 180, 19)
        spf = self.compute_phase_function_from_cosphi(
            np.cos(np.deg2rad(phi)))
        print("Scattering angle: ", phi)
        print("Interpolated scattering phase function: ", spf)

    def interpolate_phase_function(self, spf_dico):
        """Build the interpolator (pchip by default, as the reference)."""
        if 'kind' in spf_dico.keys():
            kind = spf_dico['kind']
            if not isinstance(kind, int) and kind not in [
                    'linear', 'nearest', 'zero', 'slinear', 'quadratic',
                    'cubic', 'previous', 'next']:
                raise TypeError('The key "{0:s}" must be an integer or a '
                                'string ("linear", "nearest", "zero", '
                                '"slinear", "quadratic", "cubic", '
                                '"previous", "next" or "pchip")'.format(
                                    str(kind)))
        else:
            kind = 'pchip'
        if kind == 'pchip':
            interp_func = PchipInterpolator(spf_dico['phi'], spf_dico['spf'])
        else:
            interp_func = interp1d(spf_dico['phi'], spf_dico['spf'],
                                   kind=kind, bounds_error=False,
                                   fill_value=np.nan)
        self.interpolation_function = interp_func

    def compute_phase_function_from_cosphi(self, cos_phi):
        """Interpolated SPF at cos(phi) (argument converted to degrees)."""
        return self.interpolation_function(np.rad2deg(np.arccos(cos_phi)))
