"""Parallactic and derotation angles (port of
``vip_tpu.preproc.parangles``): host code on FITS headers, read with the
port's own ``vip_tpu_torch.fits``, and the normalization of angle
vectors."""

import math
import os

import numpy as np
import torch

__all__ = ["compute_paral_angles", "compute_derot_angles_pa",
           "compute_derot_angles_cd", "check_pa_vector"]


def _parse_angle(value, hourangle=False):
    """A header angle in degrees: a number, or a sexagesimal string
    ('HH:MM:SS' / 'DD:MM:SS', also space-separated), hours with
    ``hourangle``."""
    if isinstance(value, (int, float, np.floating)):
        ang = float(value)
    else:
        parts = str(value).replace(":", " ").split()
        sign = -1.0 if parts[0].strip().startswith("-") else 1.0
        vals = [abs(float(p)) for p in parts]
        ang = vals[0]
        if len(vals) > 1:
            ang += vals[1] / 60
        if len(vals) > 2:
            ang += vals[2] / 3600
        ang *= sign
    if hourangle:
        ang *= 15.0
    return ang


def _julian_date(date_iso):
    """Julian date of an ISO 'YYYY-MM-DD[THH:MM:SS[.sss]]' UTC string."""
    date_iso = str(date_iso).strip()
    if "T" in date_iso:
        datep, timep = date_iso.split("T")
    elif " " in date_iso:
        datep, timep = date_iso.split(" ", 1)
    else:
        datep, timep = date_iso, "0:0:0"
    yy, mm, dd = [int(v) for v in datep.split("-")]
    tp = timep.replace(":", " ").split()
    frac = (float(tp[0]) + float(tp[1]) / 60 + float(tp[2]) / 3600) / 24 \
        if len(tp) >= 3 else 0.0
    if mm <= 2:
        yy -= 1
        mm += 12
    A = yy // 100
    B = 2 - A + A // 4
    jd = (math.floor(365.25 * (yy + 4716)) + math.floor(30.6001 * (mm + 1))
          + dd + B - 1524.5)
    return jd + frac


def _precess_fk5(ra_deg, dec_deg, jd):
    """FK5 J2000 coordinates precessed to the epoch of ``jd`` by Meeus's
    rigorous formulas (1998, ch. 21), in place of astropy's transform:
    they agree far below the arcsecond, far below what matters for
    ADI."""
    T = (jd - 2451545.0) / 36525.0
    arcsec = 1 / 3600.0
    zeta = (2306.2181 * T + 0.30188 * T**2 + 0.017998 * T**3) * arcsec
    z = (2306.2181 * T + 1.09468 * T**2 + 0.018203 * T**3) * arcsec
    theta = (2004.3109 * T - 0.42665 * T**2 - 0.041833 * T**3) * arcsec

    a0 = np.deg2rad(ra_deg + zeta)
    d0 = np.deg2rad(dec_deg)
    th = np.deg2rad(theta)
    A = np.cos(d0) * np.sin(a0)
    B = np.cos(th) * np.cos(d0) * np.cos(a0) - np.sin(th) * np.sin(d0)
    C = np.sin(th) * np.cos(d0) * np.cos(a0) + np.cos(th) * np.sin(d0)
    ra = np.rad2deg(np.arctan2(A, B)) + z
    dec = np.rad2deg(np.arcsin(C))
    return ra % 360.0, dec


def compute_paral_angles(header, latitude, ra_key, dec_key, lst_key,
                         acqtime_key, date_key="DATE-OBS"):
    """Parallactic angle (degrees) of one frame from its header: an
    alt-az telescope with its rotator off, [MEE98] spherical trigonometry
    at the middle of the exposure (vip_tpu parangles.py:82)."""
    jd = _julian_date(header[date_key])
    ra0 = _parse_angle(header[ra_key], hourangle=True)
    dec0 = _parse_angle(header[dec_key])
    ra_curr, dec_curr = _precess_fk5(ra0, dec0, jd)

    lst_split = str(header[lst_key]).split(":")
    lst = float(lst_split[0]) + float(lst_split[1]) / 60 \
        + float(lst_split[2]) / 3600
    exp_delay = (header[acqtime_key] * 0.5) / 3600
    exp_delay = exp_delay * 1.0027  # sidereal rate

    hour_angle = (lst + exp_delay) * 15 - ra_curr
    hour_angle = np.deg2rad(hour_angle)
    lat = np.deg2rad(latitude)
    dec_r = np.deg2rad(dec_curr)

    pa = -np.rad2deg(np.arctan2(
        -np.sin(hour_angle),
        np.cos(dec_r) * np.tan(lat) - np.sin(dec_r) * np.cos(hour_angle)))
    return float(pa)


def _iter_headers(objname_tmp_A, digit_format, objname_tmp_B, inpath,
                  list_obj):
    """(digit, header) of each cube file ``inpath`` + A + digits + B +
    '.fits' (of the digits in ``list_obj``, else of every such file that
    exists), read with the port's own FITS reader."""
    from ..fits import open_fits

    def _fitsfile(ii):
        return "{}{}{:0{}d}{}.fits".format(inpath, objname_tmp_A, ii,
                                           digit_format, objname_tmp_B)

    if list_obj is None:
        list_obj = [ii for ii in range(10**digit_format)
                    if os.path.exists(_fitsfile(ii))]
    out = []
    for ii in list_obj:
        _, header = open_fits(_fitsfile(ii), verbose=False, header=True)
        out.append((ii, header))
    return out


def compute_derot_angles_pa(objname_tmp_A, digit_format=3, objname_tmp_B="",
                            inpath="./", writing=False, outpath="./",
                            list_obj=None,
                            PosAng_st_key="HIERARCH ESO ADA POSANG",
                            PosAng_nd_key="HIERARCH ESO ADA POSANG END",
                            verbose=False):
    """Derotation angles of a sequence of cube files from the start and
    end position-angle keywords of their headers (vip_tpu
    parangles.py:129), normalized by :func:`check_pa_vector`; ``writing``
    also writes them to ``outpath`` + 'Parallactic_angles.txt'."""
    entries = _iter_headers(objname_tmp_A, digit_format, objname_tmp_B,
                            inpath, list_obj)
    rot = np.zeros(len(entries))
    for i, (_, header) in enumerate(entries):
        rot[i] = -(header[PosAng_st_key] + header[PosAng_nd_key]) / 2
    rot = check_pa_vector(rot, "deg")
    if verbose:
        print("This is the list of angles to be applied: ")
        for i in range(len(entries)):
            print(i, " -> ", rot[i])
    if writing:
        if outpath == "" or outpath is None:
            outpath = inpath
        with open(outpath + "Parallactic_angles.txt", "w") as f:
            for i in range(len(entries)):
                print(rot[i], file=f)
    return rot


def compute_derot_angles_cd(objname_tmp_A, digit_format=3, objname_tmp_B="",
                            inpath="./", skew=False, writing=False,
                            outpath="./", list_obj=None, cd11_key="CD1_1",
                            cd12_key="CD1_2", cd21_key="CD2_1",
                            cd22_key="CD2_2", verbose=False):
    """Derotation angles of a sequence of cube files from the WCS CD matrix
    of their headers (vip_tpu parangles.py:156), with the x-axis angles
    too when ``skew`` (else a skew of more than a degree raises),
    normalized by :func:`check_pa_vector`; ``writing`` also writes them
    to ``outpath`` + 'Parallactic_angles.txt'."""
    entries = _iter_headers(objname_tmp_A, digit_format, objname_tmp_B,
                            inpath, list_obj)
    cd1_1 = [h[cd11_key] for _, h in entries]
    cd1_2 = [h[cd12_key] for _, h in entries]
    cd2_1 = [h[cd21_key] for _, h in entries]
    cd2_2 = [h[cd22_key] for _, h in entries]

    det = cd1_1[0] * cd2_2[0] - cd1_2[0] * cd2_1[0]
    sgn = -1 if det < 0 else 1

    rot = np.zeros(len(entries))
    rot2 = np.zeros(len(entries))
    for ii in range(len(cd1_1)):
        if cd2_1[ii] == 0 and cd1_2[ii] == 0:
            rot[ii] = 0
            rot2[ii] = 0
        else:
            rot[ii] = -np.arctan2(sgn * cd1_2[ii], sgn * cd1_1[ii])
            rot2[ii] = -np.arctan2(-cd2_1[ii], cd2_2[ii])
            if rot2[ii] < 0:
                rot2[ii] = 2 * math.pi + rot2[ii]
        if np.floor(rot[ii]) != np.floor(rot2[ii]) and not skew:
            raise ValueError("There is more than 1deg skewness between y "
                             "and x! Please re-run the function with "
                             "argument skew=True")

    rot = check_pa_vector(rot, "rad")
    if skew:
        rot2 = check_pa_vector(rot2, "rad")
    if verbose:
        print("This is the list of angles to be applied: ")
        for ii in range(len(cd1_1)):
            print(ii, " -> ", rot[ii])
            if skew:
                print("rot2: ", ii, " -> ", rot2[ii])
    if writing:
        if outpath == "" or outpath is None:
            outpath = inpath
        with open(outpath + "Parallactic_angles.txt", "w") as f:
            for ii in range(len(cd1_1)):
                if skew:
                    print(rot[ii], rot2[ii], file=f)
                else:
                    print(rot[ii], file=f)
    if skew:
        return rot, rot2
    return rot


def check_pa_vector(angle_list, unit="deg"):
    """Normalize a derotation-angle vector: degrees, positive, no >180 deg
    jumps (vip_tpu parangles.py:212). Angles are host control data: the
    result is a float64 numpy array."""
    if isinstance(angle_list, torch.Tensor):
        angle_list = angle_list.detach().cpu().numpy()
    angle_list = np.asarray(angle_list, dtype=float).copy()
    if unit not in ("rad", "deg"):
        raise ValueError("The input unit should either be 'deg' or 'rad'")
    if unit == "rad":
        angle_list = np.rad2deg(angle_list)
    angle_list = np.where(angle_list < 0, 360 + angle_list, angle_list)
    if np.any(np.abs(np.diff(angle_list)) > 180):
        angle_list = np.where(angle_list < 180, 360 + angle_list,
                              angle_list)
    return angle_list
