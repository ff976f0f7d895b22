"""Smoke run of the vip_tpu_torch port on one CUDA card (an H100).

    python3 chip_smoke.py

Drives the port's paths on the card through the entry points a user
calls, at bench.py's full size: a 1000x512x512 float32 cube of seeded
random frames. Full-frame PCA-ADI (``ops.pipeline.pca_adi_pipeline`` with
the exact and the fft-small rotation, and the public ``psfsub.pca``),
annular PCA (the public ``psfsub.pca_annular``, bench.py's annular leg:
ncomp 10, fwhm 4, asize 4, 'vip-fft-small') and the companion search
(a companion planted in the cube, then ``psfsub.median_sub``, the
``psfsub.pca_grid`` over ncomp 1..10, ``metrics.snrmap``/``snrmap_fast``
and ``metrics.detection``), the streamed ``psfsub.pca_incremental`` and
the injection → contrast curve → completeness path (``metrics``), the
goldens in float32, slice 4 (NMF, LLSG, LOCI, frame differencing,
roll subtraction, the greedy loops), slice 5 (NEGFC: the first guess
and the MCMC of the planted companion) and slice 6 (ANDROMEDA, FMMF,
PACO). Phases, one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ``vip_tpu_torch/csrc``, one nvcc per
   source, all started together;
3. H1 (radix-select median: 8-bit digit histograms up to 1650 frames,
   bisection above) against its plain version, bit for bit, and against
   numpy's nanmedian/median within 1 ulp, at 1000 and 999 frames (digit
   body) and at 1800 (bisection body);
4. H2 (exact FFT-shear rotation) against its plain version at float32 and
   at float64 on the card, on 512² frames (N = 2048) and on 160² frames
   (the mixed-radix canvas N = 640);
5. H3 (fft-small FFT-shear rotation) against its plain version at float32
   and at float64, on 125 FoV-masked 512² frames on the 640 canvas;
6. H4 (the three shears in one cooperative launch on H2's and H3's line
   engine), exact and small, on the inputs of phases 4 and 5, against the
   plain versions and bit for bit against H2/H3;
7. main path, exact rotation: both full-frame entry points, with the
   kernels' launch counts, against the same steps through the plain
   versions on the card;
8. main path, fft-small: ``pca_adi_pipeline`` (chunk 125, with H3 and
   with H4 under ``VIP_SMALL_SHEAR=fused3``) and ``pca_annular``, each
   with its launch counts, against the plain derotation and plain median
   of its own residual cube;
9. small inputs through the kernels against the float64 CPU parity mode:
   full-frame PCA, and the device-resident annular PCA with both
   rotations;
10. the companion search at full width through each ``VIP_EXACT_SHEAR``
    route (fused3 → H4, auto → H2, pruned → plain), with launch counts;
    H4 and H2 against the plain route, the same S/N-optimal ncomp,
    detection within 3 px of the planted companion; the annular
    ``median_sub`` once; a small search against the CPU float64 mode;
11. the streamed PCA (``psfsub.pca_incremental``) of the cube written to
    a FITS file, 10 batches of 100 frames, with the kernels (H2, H1) and
    through the plain versions, the card's block cache off, a bfloat16
    wire, and the pass-1 merge in float64;
12. the contrast curve of the port's ``pca`` (3 patterns of injected
    companions and the reduction without, injected and reduced on the
    card) through its pandas-free ``metrics.contrcurve._contrast_curve``,
    against the plain route; then ``completeness_curve`` at two radii from
    its Student contrast; ``normalized_stim_map`` of the PCA residuals of
    the cube with the planted companion (its maximum at the companion);
13. F2: the goldens' configurations (pca_adi, medsub_adi, pca_ann_adi,
    pca_incr_adi) on the committed NACO replica in float32, on the card
    and on the CPU: each card frame within 10x the CPU's error against
    VIP's float64 frame (floor 1e-4), and the 3-px detection oracle; the
    golden injection's PSF normalization and injection;
14. timings, kernel beside plain, warm median of 3 (with the spread of
    the three runs where a default route is decided from them); H2's
    three launches and its set-up timed apart with CUDA events; H4's
    three stages timed apart by the kernel's own %globaltimer stamps,
    with its default group (a whole chunk) and with a group that fits
    the L2 cache; the registers, spills, blocks an SM and grid of H4 and
    H1; H1's bisection body at 1800 frames; the cuFFT yardstick
    (``torch.fft.fft`` then ``ifft`` over the line batches one H2 chunk
    and one H3 chunk shear); torch.profiler tables of one ``pca_annular``
    run and one ``median_sub`` (H2 route, so that the x- and y-shear
    kernels show apart);
15. slice 4 on the cube with the planted companion (run before the
    timings of 14, printed with them): ``psfsub.nmf``, ``nmf_annular``,
    ``llsg``, ``frame_diff`` (two configurations), ``xloci``,
    ``roll_sub`` and ``greedy.ipca``, ``inmf``, ``iroll``, each through
    the kernels with its H1/H2 launches, against the plain route, timed,
    and the companion detected on the full-width frames (the cuts are
    printed);
16. slice 5, NEGFC, on every 5th frame of the cube with the planted
    companion (200 x 512²; run before the timings of 14): ``firstguess``
    (a 12-value flux grid, then the simplex) and ``mcmc_negfc_sampling``
    (100 walkers, Gelman-Rubin test, 5 to 10 iterations) with their H1/H2
    launches, held to the companion's (r, theta, flux); ``confidence`` of
    the chain's second half; 8 walkers of the batched likelihood through
    the kernels against the plain route and the host ``lnprob``; a
    half-step of 50 walkers timed; the likelihood of 16
    walkers at full depth (1000 frames) and at bench.py's NEGFC shape;
17. slice 6, the inverse problems (run before the timings of 14): the
    goldens' ANDROMEDA (lsq, l1), FMMF (KLIP, LOCI over r 26-34) and
    FastPACO on the NACO replica through float64 CUDA tensors (held to
    VIP's golden maps at 1e-5) and in float32 (each map's companions found
    by ``detection``, FastPACO within 1e-3 of its float64 map); the three
    at full width (every 10th frame of the cube with the planted
    companion, its central 256²: each finds the companion, FMMF through
    H2); FMMF through H2 against the plain route; bench.py's three invprob
    legs and FMMF's serial and batched forms timed.

``python3 chip_smoke.py --f2`` instead bisects F2 on the card and the CPU
(the golden PCA step by step, the card's SVD routines, the four frames
under gesvd and gesvdj, the lapack PCA at full size under each), and
``--svd`` times the dense factorizations the slice-4 and NEGFC paths
call.
``python3 chip_smoke.py --negfc`` runs phase 16 alone (with the build),
with a torch.profiler table of one half-step; ``--invprob`` runs phase 17
alone, with a torch.profiler table of one FMMF annulus.
``python3 chip_smoke.py --digests ROOT`` instead prints a JSON line of
SHA-256 digests of the H1, H2 and H3 outputs on the inputs of phases 3-5,
computed with the port of the checkout at ROOT, which must be this
checkout or a tree unpacked under its git-ignored ``chip_archive/``: run
once per tree, it holds two trees' kernels to the same bits.

Prints a JSON line of the kernels (launches on the main paths, errors,
times, the roofline bound from this run's shapes, the time of one PyTorch
call computing the same function where there is one), the card's name
and power limit, then as its last line ``{"ok": true, "device": {...}}``.
Any failed phase raises, and the script exits non-zero without that line;
so does a host with no CUDA card.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FRAMES, SIZE, NCOMP, CHUNK = 1000, 512, 10, 50   # bench.py's workload
# A frame count that H1 takes with its bisection body (1651..3600)
BISECT_FRAMES = 1800
DEVICE = "cuda"
# H2 against its plain version: the bound of tests/test_pallas_shear.py:39
ROT_TOL = 3e-5
# Main path against the plain path on the card, relative to max(|ref|, 1):
# both run float32 through the same SVD and differ only by the kernels'
# rounding (FFT sums in another order, the phase evaluated differently),
# then a median. Started at 1e-4; measured 7.7e-7 on the H100 (PERF.md).
PIPE_TOL = 1e-5
# A small cube through the kernels at float32 against the CPU float64
# path: the float32 SVD and projections dominate (measured 5.3e-5).
SMALL_TOL = 1e-4
# The fft-small leg: bench.py's chunk for pca_adi_pipeline, and the
# annular leg's parameters (bench.py:553-567)
SMALL_CHUNK = 125
ANN = dict(ncomp=NCOMP, fwhm=4, asize=4, delta_rot=(0.1, 1), n_segments=1)
# The resident annular path on a small cube, CUDA float32 against CPU
# float64: float32 Gram matrices over the segment pixels and a float32
# eigh of each frame's (L, L) library Gram, then a median. Measured
# 4.9e-5 on the H100 with either rotation (PERF.md); 4x margin.
SMALL_ANN_TOL = 2e-4
# The companion search: one Gaussian companion of FWHM 4 px at 60 px,
# peak 2 (the frames' noise sigma is 1), moving with the parallactic
# angles; the S/N grid over ncomp 1..10
COMP_FWHM, COMP_SEP, COMP_PEAK, GRID_PCS = 4.0, 60.0, 2.0, (1, 10)
# The exact-rotation routes of VIP_EXACT_SHEAR: H4, H2, the plain torch.fft
EXACT_ROUTES = (("fused3", "H4"), ("auto", "H2"), ("pruned", "plain"))
# S/N maps of a small frame, CUDA float32 against CPU float64, relative to
# max(|ref|, 1): the maps divide by ring standard deviations of a few
# apertures, which amplify the frames' float32 rounding (~1e-6)
SNR_TOL = 1e-3
# H4's groups whose scratch fits the H100's 50 MB L2 (40 MiB): 4 frames of
# 512² (N = 2048) and 12 of 640² canvases; the default is a whole chunk
L2_GROUPS = (4, 12)
# The streamed PCA: batches of 100 frames from a FITS file (10 batches)
INC_BATCH = 100
# The contrast curve and the completeness probes: the port's pca with the
# main path's parameters, a Gaussian PSF of FWHM COMP_FWHM, NACO's plate
# scale, and a star flux that keeps the 5-sigma contrast of the noise
# frames below 1 (VIP clips contrasts to 1)
CC_ALGO = dict(ncomp=NCOMP, svd_mode="eigen", collapse="median")
CC_PXSCALE, CC_STARPHOT = 0.02719, 100.0
# completeness at two radii only, to stay within the time limit
COMPL_RADII, COMPL_NFC = (20, 40), 20
# The goldens of F2 (tests/gen_golden.py:psfsub_configs), besides fwhm and
# verbose
F2_CONFIGS = (("pca_adi", "pca", dict(svd_mode="lapack")),
              ("medsub_adi", "median_sub",
               dict(mode="fullfr", imlib="vip-fft", interpolation=None)),
              ("pca_ann_adi", "pca_annular", dict(n_segments="auto")),
              ("pca_incr_adi", "pca", dict(batch=30)))
# Slice 4 (phase 15): the goldens' parameters (tests/gen_golden.py) on the cube with the planted companion.
# NMF, the roll subtractions and the greedy loops at full size; the
# annulus-by-annulus methods on the central SLICE4_CROP² (annuli to 60 px:
# the same radii, a smaller canvas), annular NMF and LLSG on every
# SLICE4_EVERY-th frame and LOCI on every LOCI_EVERY-th: their cost is one
# cuSOLVER call a frame and segment (eigh of a 200² Gram: 4.0 ms) or an
# SVD a segment and iteration (gesvd of (200, 3200): 20.3 ms; both on an
# H100 80GB HBM3 at 700 W, ``--svd``); the roll
# angles are the cube's angles split at their mean into two rolls
SLICE4_CROP, SLICE4_EVERY, LOCI_EVERY = 120, 5, 10
# The greedy loops against their plain route, after their first pass: a
# change of 1e-7 in the frame fed back (the derotations differ by that)
# redraws the float32 rounding of the next PCA's residuals (~1e-5 of the
# frame at 200x128² on a CPU, 1.9e-3 at 1000x512² on an H100 80GB HBM3
# at 700 W, PERF.md), and can flip a pixel of a STIM mask thresholded at 0
GREEDY_TOL = 1e-2
# NEGFC (phase 16): firstguess and the MCMC on every NEGFC_EVERY-th frame
# of the cube with the planted companion (200 x 512²): each walker's
# likelihood takes one cuSOLVER gesvd of its (200, ~3000) annulus matrix
# (19-20 ms at (200, 3200), ``--svd``, an H100 80GB HBM3 at 700 W) beside
# the derotation of its 200 frames (H2); the likelihood once at full depth
# (1000 frames) for NEGFC_FULL_WALKERS walkers; bench.py's NEGFC leg shape (50x64x64, 16
# walkers, ncomp 5, bench.py:289-312). The acceptance bounds (px, degrees,
# relative flux) of the first guess and of the posterior median
NEGFC_EVERY, NEGFC_FULL_WALKERS = 5, 16
NEGFC_MCMC = dict(nwalkers=100, conv_test="gb", niteration_min=5,
                  niteration_limit=10)
NEGFC_FG_TOL, NEGFC_MCMC_TOL = (0.5, 2.0, 0.2), (1.0, 3.0, 0.3)
# the batched likelihood against the host lnprob, both float32 on the
# card: vip_tpu's own device-against-host bound (tests/test_fm_negfc.py:83)
NEGFC_HOST_RTOL = 1e-4
# Slice 6 (phase 17): the inverse problems. The goldens' configurations
# (tests/gen_golden.py:169-192) on the NACO replica (61x101², odd frames:
# every rotation takes the plain route there), in float64 against VIP's
# maps at FRAME_TOL (tests/test_golden.py:28) and in float32; FMMF over
# the golden window r 26-34, which holds the injected companion (r 30) and
# not the planet (r 16.6); NACO's plate scale, L' and the VLT's diameter
# give ANDROMEDA's oversampling
INV_GOLDEN_TOL = 1e-5
INV_WINDOW, INV_BENCH_WINDOW = (26, 34), (26, 30)
NACO_PLSC, NACO_LBDA, VLT_DIAM = 0.02719, 3.8e-6, 8.2
# FastPACO's float32 S/N map against its float64 run on the card, relative
# to max|snr| on the finite pixels
PACO_F32_TOL = 1e-3
# Full width: every INV_EVERY-th frame of the cube with the planted
# companion, its central INV_SIZE² (PACO's statistics hold n·H·W·A
# values), a 20² Gaussian PSF of FWHM COMP_FWHM (ANDROMEDA needs an even
# PSF); FMMF over INV_FW_WINDOW around the companion's 60 px
INV_EVERY, INV_SIZE, INV_FW_WINDOW = 10, 256, (58, 62)
INV_FMMF_PARAM = {"ncomp": 10, "tolerance": 0.005, "delta_rot": 0.5}
NMF4 = dict(ncomp=14, handle_neg="subtr_min")
NMF_ANN4 = dict(ncomp=9, radius_int=20, asize=4, handle_neg="subtr_min")
LLSG4 = dict(rank=5, thresh=1, max_iter=20, random_seed=10, fwhm=4)
FD4 = dict(fwhm=4, metric="l1", dist_threshold=90, delta_rot=0.5,
           radius_int=4, asize=4)
LOCI4 = dict(fwhm=4, asize=4, n_segments="auto", metric="correlation",
             radius_int=20, dist_threshold=90, delta_rot=0.5,
             optim_scale_fact=3, solver="lstsq", tol=0.01)
# F2's gate: each golden frame in float32 on the card within F2_RATIO
# times the same call's error in float32 on the CPU, floored at F2_FLOOR
F2_RATIO, F2_FLOOR = 10.0, 1e-4
# Roofline of one H100 SXM at 700 W (NVIDIA's data sheet): float32
# outside the tensor cores, and HBM3
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _bound(nbytes, flop):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the float32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flop / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _shear_flop(lines, N):
    """Float32 operations of ``lines`` FFT line shears on an N canvas: a
    forward and an inverse complex FFT (5·N·log2 N each) and the phase
    product (6·N)."""
    return lines * (2 * 5 * N * np.log2(N) + 6 * N)


@contextlib.contextmanager
def _env(name, value):
    """Set the environment variable ``name`` to ``value`` for a block."""
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            del os.environ[name]
        else:
            os.environ[name] = before


def _reset_counts():
    from vip_tpu_torch.ops import median, shear

    median.launches = shear.launches = shear.small_launches = 0
    shear.fused3_launches = 0


def _counts():
    from vip_tpu_torch.ops import median, shear

    return {"H1": median.launches, "H2": shear.launches,
            "H3": shear.small_launches, "H4": shear.fused3_launches}


def _sync_times(fn, reps=3):
    """``reps`` warm timed calls, synchronized, in seconds."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def _sync_time(fn, reps=3):
    """Warm median of ``reps`` timed calls, synchronized, in seconds."""
    return float(np.median(_sync_times(fn, reps)))


def _spread(times):
    """'median [min, max]' of timed runs."""
    t = np.asarray(times)
    return f"{np.median(t):.4f} [{t.min():.4f}, {t.max():.4f}]"


def _rel_err(got, ref):
    got, ref = got.double(), ref.double()
    scale = max(float(ref.abs().max()), 1.0)
    return float((got - ref).abs().max()), scale


def phase_device():
    import vip_tpu_torch

    _require(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    vip_tpu_torch.set_device(DEVICE)
    return smi


def phase_build():
    from vip_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)


def _with_nans(cube, seed):
    """A copy of ``cube`` with 3000 NaNs at random, an all-NaN, a half-NaN
    and an all -0.0 pixel."""
    rng = np.random.default_rng(seed)
    cube = cube.clone()
    flat = cube.view(-1)
    nan_at = torch.as_tensor(rng.choice(flat.numel(), 3000, replace=False),
                             device=cube.device)
    flat[nan_at] = torch.nan
    cube[:, 0, 0] = torch.nan              # all-NaN pixel
    cube[::2, 0, 1] = torch.nan            # half-NaN pixel
    cube[:, 0, 2] = -0.0
    return cube


def phase_median(cube):
    """H1 on the main path's shape, with NaNs, even and odd frame counts,
    both propagate modes: the digit body at 1000 and 999 frames, the
    bisection body at BISECT_FRAMES. Returns (largest error, the
    BISECT_FRAMES cube without NaNs, for the timings)."""
    from vip_tpu_torch.ops.median import (median_body, nanmedian_axis0,
                                          nanmedian_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    big = torch.randn((BISECT_FRAMES, SIZE, SIZE), generator=gen,
                      device=DEVICE)
    cube, nan_big = _with_nans(cube, 1), _with_nans(big, 4)
    cases = ((cube[:N_FRAMES], "digits"), (cube[:N_FRAMES - 1], "digits"),
             (nan_big, "bisection"))
    max_err = 0.0
    for sub, body in cases:
        n = sub.shape[0]
        _require(median_body(n) == body,
                 f"H1 takes {n} frames with the {median_body(n)} body")
        sub = sub.contiguous()
        host = sub[:, :16].double().cpu().numpy()
        for propagate in (False, True):
            got = nanmedian_axis0(sub, propagate=propagate)
            ref = nanmedian_plain(sub, 0, propagate)
            torch.cuda.synchronize()
            same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
            _require(same, f"H1 differs bitwise from its plain version "
                           f"(n={n}, propagate={propagate})")
            npref = (np.median if propagate else np.nanmedian)(host, axis=0)
            g = got[:16].double().cpu().numpy()
            _require(np.array_equal(np.isnan(g), np.isnan(npref)),
                     "H1 NaN pattern differs from numpy")
            ok = ~np.isnan(npref)
            ulp = np.spacing(np.abs(npref[ok]).astype(np.float32))
            _require(np.all(np.abs(g[ok] - npref[ok]) <= ulp),
                     f"H1 beyond 1 ulp of numpy (n={n}, "
                     f"propagate={propagate})")
            max_err = max(max_err, float(
                (got - ref).nan_to_num().abs().max()))
    print(f"H1 nanmedian_axis0 vs plain: bit-equal with the digit body at "
          f"n={N_FRAMES} and {N_FRAMES - 1} and with the bisection body at "
          f"n={BISECT_FRAMES}, both propagate modes; within 1 ulp of numpy "
          f"on 16 rows", flush=True)
    return max_err, big


def phase_rotation():
    """H2 on 50 frames of 512^2 and on 125 frames of 160^2, with angles in
    all four quadrants, including 45 and 90 degrees exactly."""
    from vip_tpu_torch.ops.fft import rotate_fft_exact_pruned
    from vip_tpu_torch.ops.shear import rotate_fft_exact_fused
    from vip_tpu_torch.preproc.derotation import _fft_rotate_geometry

    rng = np.random.default_rng(2)
    frames = torch.as_tensor(
        rng.standard_normal((CHUNK, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    angles = _angles(CHUNK)
    pad_y, _, py0, px0, cy0, cy1, cx0, cx1 = _fft_rotate_geometry(SIZE, SIZE)
    geom = (pad_y, py0, px0, cy0, cy1, cx0, cx1)

    err = _check_rotation("H2 rotate_fft_exact_fused", frames, angles,
                          lambda f, a: rotate_fft_exact_fused(f, a, *geom),
                          lambda f, a: rotate_fft_exact_pruned(f, a, *geom))

    # the mixed-radix canvas N = 640 = 5 x 128 (160^2 frames)
    frames160 = torch.as_tensor(
        rng.standard_normal((SMALL_CHUNK, 160, 160)).astype(np.float32),
        device=DEVICE)
    angles160 = _angles(SMALL_CHUNK)
    g160 = _fft_rotate_geometry(160, 160)
    geom160 = (g160[0],) + g160[2:]
    _require(geom160[0] == 640, f"canvas of 160^2 is {geom160[0]}")
    err160 = _check_rotation(
        "H2 rotate_fft_exact_fused 160^2 (N=640)", frames160, angles160,
        lambda f, a: rotate_fft_exact_fused(f, a, *geom160),
        lambda f, a: rotate_fft_exact_pruned(f, a, *geom160))
    return (frames, angles, geom, frames160, angles160, geom160,
            max(err, err160))


def _angles(n):
    """Angles over all four quadrants, with 0, 45, 90, ... exactly."""
    angles = np.linspace(-190.0, 350.0, n)
    angles[:8] = [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0, -45.0]
    return torch.as_tensor(angles.astype(np.float32), device=DEVICE)


def _check_rotation(name, frames, angles, kernel, plain, twin=None):
    """A rotation kernel against its plain version at float32 and at
    float64, at ROT_TOL of max(|ref|, 1), and bit for bit against
    ``twin`` (a (name, kernel) pair of the same arithmetic) if given.
    Returns the largest error."""
    got = kernel(frames, angles)
    ref32 = plain(frames, angles)
    ref64 = plain(frames.double(), angles.double())
    torch.cuda.synchronize()
    err32, s32 = _rel_err(got, ref32)
    err64, s64 = _rel_err(got, ref64)
    plain_err, _ = _rel_err(ref32, ref64)
    twin_note, twin_err = "", 0.0
    if twin is not None:
        other = twin[1](frames, angles)
        torch.cuda.synchronize()
        twin_err, _ = _rel_err(got, other)
        twin_note = (f"; vs {twin[0]} {twin_err:.3e} (bit-equal "
                     f"{torch.equal(got, other)})")
    print(f"{name} vs plain: max abs err {err32:.3e} (f32 plain), "
          f"{err64:.3e} (f64 plain); plain f32 vs f64 {plain_err:.3e}"
          f"{twin_note}; bound {ROT_TOL:.0e} x {s64:.3f}", flush=True)
    _require(err32 <= ROT_TOL * s32, f"{name} disagrees with f32 plain")
    _require(err64 <= ROT_TOL * s64, f"{name} disagrees with f64 plain")
    _require(twin is None or torch.equal(got, other),
             f"{name} differs bitwise from {twin and twin[0]}")
    return max(err32, err64, twin_err)


def _small_canvas(frames):
    """FoV-mask and pad (n, sz, sz) frames onto the fft-small kernel's
    canvas, as ``ops.pipeline._derotate_frames`` does. Returns (canvas,
    margin)."""
    sz = frames.shape[-1]
    pad_to = -(-int(sz * 1.25) // 128) * 128
    m0 = (pad_to - sz) // 2
    qq = torch.arange(sz, device=frames.device) - sz / 2
    fov = (qq[:, None] ** 2 + qq[None, :] ** 2) < (sz / 2) ** 2
    padded = torch.nn.functional.pad(torch.where(fov, frames, 0.0),
                                     (m0, pad_to - sz - m0, m0,
                                      pad_to - sz - m0))
    return padded, m0


def _plain_small_derotate(cube, angles, chunk):
    """The fft-small derotation through the plain version of H3, chunk by
    chunk, on the kernel's canvas."""
    from vip_tpu_torch.ops.fft import rotate_fft_small_plain

    n, sz = cube.shape[0], cube.shape[-1]
    out = torch.empty_like(cube)
    for s in range(0, n, chunk):
        padded, m0 = _small_canvas(cube[s:s + chunk])
        rot = rotate_fft_small_plain(padded, -angles[s:s + chunk])
        out[s:s + chunk] = rot[:, m0:m0 + sz, m0:m0 + sz]
    return out


def phase_small_rotation():
    """H3 on 125 FoV-masked 512^2 frames on the 640 canvas, angles in all
    four quadrants."""
    from vip_tpu_torch.ops.fft import rotate_fft_small_plain
    from vip_tpu_torch.ops.shear import rotate_fft_small_fused

    rng = np.random.default_rng(4)
    frames = torch.as_tensor(
        rng.standard_normal((SMALL_CHUNK, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    canvas, _ = _small_canvas(frames)
    _require(canvas.shape[-1] == 640, f"fft-small canvas {canvas.shape}")
    angles = _angles(SMALL_CHUNK)
    err = _check_rotation("H3 rotate_fft_small_fused (N=640)", canvas,
                          angles, rotate_fft_small_fused,
                          rotate_fft_small_plain)
    return canvas, angles, err


def phase_fused3(frames, angles, geom, frames160, angles160, geom160,
                 canvas, small_angles):
    """H4 (the three shears in one cooperative launch) on the inputs of
    phases 4 and 5: exact on 50 frames of 512² (N = 2048) and 125 of 160²
    (N = 640), small on the 125 FoV-masked frames on the 640² canvas;
    against the plain versions and bit for bit against H2/H3 (the same
    line engine, tables and coefficients), one launch a call. Returns the
    largest error of each variant."""
    from vip_tpu_torch.ops import shear
    from vip_tpu_torch.ops.fft import (rotate_fft_exact_pruned,
                                       rotate_fft_small_plain)

    errs = {}
    for name, f, a, g in (("512^2 (N=2048)", frames, angles, geom),
                          ("160^2 (N=640)", frames160, angles160, geom160)):
        before = shear.fused3_launches
        errs[name] = _check_rotation(
            f"H4 rotate_fft_exact_fused3 {name}", f, a,
            lambda f_, a_, g=g: shear.rotate_fft_exact_fused3(f_, a_, *g),
            lambda f_, a_, g=g: rotate_fft_exact_pruned(f_, a_, *g),
            twin=("H2", lambda f_, a_, g=g: shear.rotate_fft_exact_fused(
                f_, a_, *g)))
        _require(shear.fused3_launches == before + 1,
                 f"H4 exact {name}: {shear.fused3_launches - before} "
                 f"launches, not 1")
    before = shear.fused3_launches
    err_small = _check_rotation(
        "H4 rotate_fft_small_fused3 (N=640)", canvas, small_angles,
        shear.rotate_fft_small_fused3, rotate_fft_small_plain,
        twin=("H3", shear.rotate_fft_small_fused))
    _require(shear.fused3_launches == before + 1,
             f"H4 small: {shear.fused3_launches - before} launches, not 1")
    return max(errs.values()), err_small


def _plain_pipeline(cube, angles):
    """The main path's steps through the plain versions on the card."""
    from vip_tpu_torch.ops.linalg import svd_top
    from vip_tpu_torch.ops.median import nanmedian_plain
    from vip_tpu_torch.preproc.derotation import rotate_fft_pruned_batch

    n = cube.shape[0]
    M = cube.reshape(n, -1)
    V = svd_top(M, NCOMP, method="eigen")
    resid = (M - (M @ V.T) @ V).reshape(cube.shape)
    der = torch.empty_like(resid)
    for s in range(0, n, CHUNK):
        der[s:s + CHUNK] = rotate_fft_pruned_batch(resid[s:s + CHUNK],
                                                   -angles[s:s + CHUNK])
    return nanmedian_plain(der, 0)


def phase_main_path(cube, angles_np):
    from vip_tpu_torch.ops import median, shear
    from vip_tpu_torch.ops.pipeline import pca_adi_pipeline
    from vip_tpu_torch.psfsub import pca

    angles = torch.as_tensor(angles_np, device=DEVICE)

    def run():
        return pca_adi_pipeline(cube, angles, ncomp=NCOMP, method="eigen",
                                collapse="median", rot_mode="fft",
                                chunk=CHUNK)

    median.launches = shear.launches = 0
    frame = run()
    torch.cuda.synchronize()
    counts = {"H1": median.launches, "H2": shear.launches}
    _require(counts["H2"] == 3 * -(-N_FRAMES // CHUNK),
             f"H2 launches {counts['H2']} != 3 x {-(-N_FRAMES // CHUNK)}")
    _require(counts["H1"] >= 1, "H1 was not launched on the main path")

    median.launches = shear.launches = 0
    frame_pca = pca(cube, angles_np, ncomp=NCOMP, svd_mode="eigen",
                    imlib="vip-fft", verbose=False)
    torch.cuda.synchronize()
    pca_counts = {"H1": median.launches, "H2": shear.launches}
    _require(pca_counts["H1"] >= 1 and pca_counts["H2"] >= 3,
             f"pca did not launch both kernels: {pca_counts}")

    ref = _plain_pipeline(cube, angles)
    torch.cuda.synchronize()
    for name, fr in (("pca_adi_pipeline", frame), ("psfsub.pca", frame_pca)):
        _require(tuple(fr.shape) == (SIZE, SIZE)
                 and bool(torch.isfinite(fr).all()),
                 f"{name}: not a finite {SIZE}x{SIZE} frame")
    err, scale = _rel_err(frame, ref)
    err_pca, _ = _rel_err(frame_pca, ref)
    print(f"main path {N_FRAMES}x{SIZE}x{SIZE}: launches {counts} "
          f"(pca: {pca_counts}); max abs err vs plain path "
          f"{err:.3e} (pipeline), {err_pca:.3e} (pca); bound "
          f"{PIPE_TOL:.0e} x {scale:.3f}", flush=True)
    _require(err <= PIPE_TOL * scale, "pipeline disagrees with plain path")
    _require(err_pca <= PIPE_TOL * scale, "pca disagrees with plain path")
    return counts, run, lambda: _plain_pipeline(cube, angles)


def phase_small_pipeline(cube, angles_np):
    """``pca_adi_pipeline`` with the fft-small rotation in chunks of 125:
    H3 three times a chunk, H1 once, against the same steps through the
    plain versions."""
    from vip_tpu_torch.ops import median, shear
    from vip_tpu_torch.ops.linalg import svd_top
    from vip_tpu_torch.ops.median import nanmedian_plain
    from vip_tpu_torch.ops.pipeline import pca_adi_pipeline

    angles = torch.as_tensor(angles_np, device=DEVICE)

    def run():
        return pca_adi_pipeline(cube, angles, ncomp=NCOMP, method="eigen",
                                collapse="median", rot_mode="fft-small",
                                chunk=SMALL_CHUNK)

    median.launches = shear.launches = shear.small_launches = 0
    frame = run()
    torch.cuda.synchronize()
    counts = {"H1": median.launches, "H2": shear.launches,
              "H3": shear.small_launches}
    nch = -(-N_FRAMES // SMALL_CHUNK)
    _require(counts["H3"] == 3 * nch,
             f"H3 launches {counts['H3']} != 3 x {nch}")
    _require(counts["H1"] >= 1, "H1 was not launched on the fft-small path")

    n = cube.shape[0]
    M = cube.reshape(n, -1)
    V = svd_top(M, NCOMP, method="eigen")
    resid = (M - (M @ V.T) @ V).reshape(cube.shape)
    ref = nanmedian_plain(_plain_small_derotate(resid, angles, SMALL_CHUNK),
                          0)
    torch.cuda.synchronize()
    _require(tuple(frame.shape) == (SIZE, SIZE)
             and bool(torch.isfinite(frame).all()),
             "fft-small pipeline: not a finite frame")
    err, scale = _rel_err(frame, ref)
    print(f"fft-small pca_adi_pipeline {N_FRAMES}x{SIZE}x{SIZE} chunk "
          f"{SMALL_CHUNK}: launches {counts}; max abs err vs plain steps "
          f"{err:.3e}; bound {PIPE_TOL:.0e} x {scale:.3f}", flush=True)
    _require(err <= PIPE_TOL * scale, "fft-small pipeline disagrees with "
             "its plain steps")
    return run


def phase_annular(cube, angles_np):
    """Annular PCA through the public ``pca_annular`` (device-resident
    branch, fft-small derotation): H3 for every derotation chunk and H1
    for the collapse; the frame against the plain derotation and plain
    median of its own residual cube."""
    from vip_tpu_torch.ops import median, shear
    from vip_tpu_torch.ops.median import nanmedian_plain
    from vip_tpu_torch.psfsub import pca_annular
    from vip_tpu_torch.psfsub.pca_local import _resident_chunk

    def run(full_output=False):
        return pca_annular(cube, angles_np, imlib="vip-fft-small",
                           full_output=full_output, verbose=False, **ANN)

    median.launches = shear.launches = shear.small_launches = 0
    t0 = time.perf_counter()
    cube_out, cube_der, frame = run(full_output=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"H1": median.launches, "H2": shear.launches,
              "H3": shear.small_launches}
    chunk = _resident_chunk(N_FRAMES, SIZE, "fft-small")
    nch = -(-N_FRAMES // chunk)
    _require(counts["H3"] == 3 * nch,
             f"pca_annular: H3 launches {counts['H3']} != 3 x {nch}")
    _require(counts["H1"] == 1, f"pca_annular: H1 launches {counts['H1']}")
    _require(counts["H2"] == 0, "pca_annular fft-small launched H2")
    for name, arr, shape in (("frame", frame, (SIZE, SIZE)),
                             ("cube_out", cube_out, tuple(cube.shape)),
                             ("cube_der", cube_der, tuple(cube.shape))):
        _require(tuple(arr.shape) == shape and arr.is_cuda
                 and bool(torch.isfinite(arr).all()),
                 f"pca_annular {name}: not a finite {shape} CUDA tensor")

    angles = torch.as_tensor(angles_np, device=DEVICE)
    der_plain = _plain_small_derotate(cube_out, angles, chunk)
    ref = nanmedian_plain(der_plain, 0)
    torch.cuda.synchronize()
    err, scale = _rel_err(frame, ref)
    err_der, _ = _rel_err(cube_der, der_plain)
    print(f"pca_annular {N_FRAMES}x{SIZE}x{SIZE} vip-fft-small: launches "
          f"{counts} (derotation chunk {chunk}); first call {wall:.4f} s; "
          f"frame vs plain derotation + plain median of its cube_out: max "
          f"abs err {err:.3e} (derotated cube {err_der:.3e}); bound "
          f"{PIPE_TOL:.0e} x {scale:.3f}", flush=True)
    _require(err <= PIPE_TOL * scale, "pca_annular frame disagrees with its "
             "plain steps")
    del cube_out, cube_der, der_plain
    return counts, run


def phase_small_pipeline_fused3(run_small):
    """The fft-small ``pca_adi_pipeline`` with ``VIP_SMALL_SHEAR=fused3``:
    H4's small variant once a chunk instead of H3 three times; the H3
    route's frame within PIPE_TOL (another line body, the same
    function)."""
    ref = run_small()

    def run():
        with _env("VIP_SMALL_SHEAR", "fused3"):
            return run_small()

    _reset_counts()
    frame = run()
    torch.cuda.synchronize()
    counts = _counts()
    nch = -(-N_FRAMES // SMALL_CHUNK)
    _require(counts["H4"] == nch and counts["H3"] == 0 and counts["H1"] >= 1,
             f"fft-small pipeline under VIP_SMALL_SHEAR=fused3: launches "
             f"{counts}, want H4 = {nch}, H3 = 0, H1 >= 1")
    err, scale = _rel_err(frame, ref)
    print(f"fft-small pca_adi_pipeline {N_FRAMES}x{SIZE}x{SIZE} chunk "
          f"{SMALL_CHUNK}, VIP_SMALL_SHEAR=fused3: launches {counts}; max abs "
          f"err vs the H3 route {err:.3e} (bit-equal "
          f"{torch.equal(frame, ref)}); bound {PIPE_TOL:.0e} x {scale:.3f}",
          flush=True)
    _require(err <= PIPE_TOL * scale, "H4-small pipeline disagrees with H3")
    return counts, run


def _plant_companion(cube, angles_np):
    """A copy of ``cube`` with one Gaussian companion (COMP_FWHM, peak
    COMP_PEAK) at COMP_SEP px east of the center once derotated: in frame
    i at angle a_i it sits at (y, x) = (c − sep·sin a_i, c + sep·cos a_i).
    The Gaussian is separable, so its rows and columns are numpy
    profiles whose outer product is added on the card. Returns the cube
    and the companion's derotated (x, y)."""
    n, size = cube.shape[0], cube.shape[-1]
    c = size // 2
    a = np.deg2rad(angles_np.astype(np.float64))
    two_sig2 = 2 * (COMP_FWHM / (2 * np.sqrt(2 * np.log(2)))) ** 2
    q = np.arange(size, dtype=np.float64)
    gy = np.exp(-(q[None, :] - (c - COMP_SEP * np.sin(a))[:, None]) ** 2
                / two_sig2)
    gx = np.exp(-(q[None, :] - (c + COMP_SEP * np.cos(a))[:, None]) ** 2
                / two_sig2)
    gy = torch.as_tensor(COMP_PEAK * gy, dtype=cube.dtype, device=DEVICE)
    gx = torch.as_tensor(gx, dtype=cube.dtype, device=DEVICE)
    out = cube.clone()
    for s in range(0, n, 100):
        out[s:s + 100] += gy[s:s + 100, :, None] * gx[s:s + 100, None, :]
    return out, (c + COMP_SEP, float(c))


def _near(ys, xs, src, tol=3.0):
    """Whether a detection (ys, xs) lies within ``tol`` px of src = (x, y)."""
    return any(np.hypot(y - src[1], x - src[0]) <= tol
               for y, x in zip(np.atleast_1d(ys), np.atleast_1d(xs)))


def _optimal_ncomp(frames, src):
    """The S/N-optimal ncomp of a grid, by ``pca_grid``'s figure of merit
    'mean' (the mean S/N over the pixels of the disk of diameter fwhm
    around the source) through the public ``metrics.snr_multi``;
    ``pca_grid`` with ``source_xy`` also returns a pandas table, and
    ``pca(ncomp=tuple, source_xy=...)`` plots with matplotlib, and the
    card's machine has neither."""
    from vip_tpu_torch.metrics import snr_multi
    from vip_tpu_torch.var.shapes import disk_coords

    yy, xx = disk_coords((src[1], src[0]), COMP_FWHM / 2.0, (SIZE, SIZE))
    snrs = [float(np.mean(snr_multi(f, xx, yy, COMP_FWHM)[0]))
            for f in frames]
    return GRID_PCS[0] + int(np.argmax(snrs)), max(snrs)


def phase_companion_search(pcube, angles_np, src):
    """Find the planted companion at full width: ``median_sub`` (full
    frame) and the ``pca_grid`` over ncomp 1..10 (device branch) through
    each exact-rotation route of ``VIP_EXACT_SHEAR`` (H4, H2, plain), each
    route's launches counted; H4 and H2 against the plain route, and the
    same S/N-optimal ncomp; then ``snrmap``, ``snrmap_fast`` and
    ``detection`` of the H4 frame. Returns (counts under fused3, runs by
    route, the H4 median-ADI frame)."""
    from vip_tpu_torch.metrics import detection, snrmap, snrmap_fast
    from vip_tpu_torch.psfsub import median_sub, pca_grid

    def medsub():
        return median_sub(pcube, angles_np, mode="fullfr", imlib="vip-fft",
                          verbose=False)

    def grid():
        return pca_grid(pcube, angles_np, range_pcs=GRID_PCS, fwhm=COMP_FWHM,
                        plot=False, full_output=True, verbose=False)[0]

    out, runs, fused3_counts = {}, {}, None
    for mode, route in EXACT_ROUTES:
        with _env("VIP_EXACT_SHEAR", mode):
            _reset_counts()
            frame = medsub()
            torch.cuda.synchronize()
            c_ms = _counts()
            _reset_counts()
            frames = grid()
            torch.cuda.synchronize()
            c_grid = _counts()
        for what, c in (("median_sub", c_ms), ("pca_grid", c_grid)):
            want_h4, want_h2 = route == "H4", route == "H2"
            _require(c["H1"] >= 1 and (c["H4"] > 0) == want_h4
                     and (c["H2"] > 0) == want_h2 and c["H3"] == 0,
                     f"{what} under VIP_EXACT_SHEAR={mode}: launches {c}")
        if route == "H4":
            fused3_counts = {k: c_ms[k] + c_grid[k] for k in c_ms}
        for name, fr in (("median_sub", frame), ("pca_grid", frames)):
            _require(bool(torch.isfinite(fr).all()) and fr.is_cuda,
                     f"{name} ({route}): not finite CUDA frames")
        opt, opt_snr = _optimal_ncomp(frames, src)
        out[route] = (frame, frames, opt)
        print(f"companion search {N_FRAMES}x{SIZE}x{SIZE}, "
              f"VIP_EXACT_SHEAR={mode} ({route}): launches median_sub "
              f"{c_ms}, pca_grid {c_grid}; S/N-optimal ncomp {opt} (mean "
              f"S/N {opt_snr:.3f})", flush=True)
        runs[route] = (medsub, grid, mode)

    ref_ms, ref_grid, opt = out["plain"]
    for route in ("H4", "H2"):
        frame, frames, opt_r = out[route]
        err_ms, s_ms = _rel_err(frame, ref_ms)
        err_grid, s_grid = _rel_err(frames, ref_grid)
        print(f"companion search {route} vs plain route: median_sub max abs "
              f"err {err_ms:.3e} (bound {PIPE_TOL:.0e} x {s_ms:.3f}), "
              f"pca_grid {err_grid:.3e} (bound {PIPE_TOL:.0e} x "
              f"{s_grid:.3f}); optimal ncomp {opt_r} vs {opt}", flush=True)
        _require(err_ms <= PIPE_TOL * s_ms, f"median_sub {route} disagrees")
        _require(err_grid <= PIPE_TOL * s_grid, f"pca_grid {route} disagrees")
        _require(opt_r == opt, f"optimal ncomp {route} {opt_r} != {opt}")

    frame = out["H4"][0]
    smap = snrmap(frame, COMP_FWHM, verbose=False)
    fmap = snrmap_fast(frame, COMP_FWHM)
    torch.cuda.synchronize()
    for name, m in (("snrmap", smap), ("snrmap_fast", fmap)):
        _require(tuple(m.shape) == (SIZE, SIZE) and m.is_cuda
                 and bool(torch.isfinite(m).all()),
                 f"{name}: not a finite {SIZE}x{SIZE} CUDA map")
    cy, cx = int(src[1]), int(src[0])
    peak = np.unravel_index(int(smap.argmax()), smap.shape)
    ys, xs = detection(frame, fwhm=COMP_FWHM, mode="lpeaks", bkg_sigma=5,
                       snr_thresh=5, full_output=False, plot=False,
                       verbose=False)
    print(f"companion search: snrmap peak {float(smap.max()):.3f} at (y, x) "
          f"{tuple(int(v) for v in peak)}, S/N at the companion "
          f"{float(smap[cy, cx]):.3f} (snrmap_fast {float(fmap[cy, cx]):.3f})"
          f"; detection (y, x) {list(zip(np.atleast_1d(ys).tolist(), np.atleast_1d(xs).tolist()))}"
          f", planted at {(src[1], src[0])}", flush=True)
    _require(_near(ys, xs, src), "detection missed the planted companion")
    return fused3_counts, runs, frame


def phase_annular_median(pcube, angles_np, src):
    """``median_sub(mode="annular")`` once at full width (default exact
    route, H2; H1 for each annulus's library medians and the collapse).
    Returns its wall time in seconds."""
    from vip_tpu_torch.metrics import detection
    from vip_tpu_torch.psfsub import median_sub

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = median_sub(pcube, angles_np, mode="annular", imlib="vip-fft",
                       verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    _require(tuple(frame.shape) == (SIZE, SIZE) and frame.is_cuda
             and bool(torch.isfinite(frame).all()),
             "annular median_sub: not a finite CUDA frame")
    _require(counts["H1"] >= 2 and counts["H2"] > 0,
             f"annular median_sub launches {counts}")
    ys, xs = detection(frame, fwhm=COMP_FWHM, mode="lpeaks", bkg_sigma=5,
                       snr_thresh=5, full_output=False, plot=False,
                       verbose=False)
    print(f"median_sub annular {N_FRAMES}x{SIZE}x{SIZE}: launches {counts}; "
          f"{wall:.4f} s (first and only call); companion detected "
          f"{_near(ys, xs, src)}", flush=True)
    _require(_near(ys, xs, src), "annular median_sub: companion missed")
    return wall


def phase_small_companion_reference():
    """The companion search on a small cube through the kernels (CUDA,
    float32, H4 and H1) against the float64 CPU parity mode, which the
    tests hold against vip_tpu: median_sub in both modes, snrmap,
    detection."""
    from vip_tpu_torch.metrics import detection, snrmap
    from vip_tpu_torch.psfsub import median_sub

    rng = np.random.default_rng(6)
    n, size, sep = 40, 64, 14.0
    angles = np.linspace(0.0, 60.0, n)
    yy, xx = np.mgrid[:size, :size]
    cube = 0.5 * rng.standard_normal((n, size, size))
    c = size // 2
    for i, a in enumerate(np.deg2rad(angles)):
        cube[i] += 2.0 * np.exp(-((yy - c + sep * np.sin(a)) ** 2
                                  + (xx - c - sep * np.cos(a)) ** 2) / 5.77)
    with _env("VIP_EXACT_SHEAR", "fused3"):
        for mode in ("fullfr", "annular"):
            _reset_counts()
            got = median_sub(torch.as_tensor(cube, dtype=torch.float32,
                                             device=DEVICE), angles,
                             mode=mode, verbose=False)
            torch.cuda.synchronize()
            counts = _counts()
            _require(counts["H4"] > 0 and counts["H1"] >= 2,
                     f"small median_sub {mode}: launches {counts}")
            ref = median_sub(torch.as_tensor(cube), angles, mode=mode,
                             verbose=False)
            err, scale = _rel_err(got.cpu(), ref)
            print(f"small {n}x{size}x{size} median_sub {mode}: launches "
                  f"{counts}; CUDA f32 kernels vs CPU f64 plain: max abs err "
                  f"{err:.3e} (bound {SMALL_TOL:.0e} x {scale:.3f})",
                  flush=True)
            _require(err <= SMALL_TOL * scale,
                     f"small median_sub {mode} disagrees with CPU f64")
            if mode == "fullfr":
                smap = snrmap(got, COMP_FWHM, verbose=False)
                smap_ref = snrmap(ref, COMP_FWHM, verbose=False)
                serr, sscale = _rel_err(smap.cpu(), smap_ref)
                det = detection(got, COMP_FWHM, mode="lpeaks", bkg_sigma=3,
                                snr_thresh=3, plot=False, verbose=False)
                det_ref = detection(ref, COMP_FWHM, mode="lpeaks",
                                    bkg_sigma=3, snr_thresh=3, plot=False,
                                    verbose=False)
                # positions are 2-d Gaussian fits on the host: the same
                # sources, to a small fraction of a pixel
                same = all(np.shape(a) == np.shape(b) and np.allclose(
                    np.atleast_1d(a), np.atleast_1d(b), atol=0.05)
                    for a, b in zip(det, det_ref))
                print(f"small snrmap CUDA f32 vs CPU f64: max abs err "
                      f"{serr:.3e} (bound {SNR_TOL:.0e} x {sscale:.3f}); "
                      f"detection {det} (CPU f64: same {same})", flush=True)
                _require(serr <= SNR_TOL * sscale, "small snrmap disagrees")
                _require(same, "small detection differs from CPU f64")
                _require(_near(det[0], det[1], (c + sep, c)),
                         "small detection missed the companion")


def phase_small_annular_reference():
    """The device-resident annular path (>= 128 frames) on a small cube,
    through the kernels (CUDA, float32), against the float64 CPU parity
    mode, which the tests hold against vip_tpu; 'vip-fft' must launch H2,
    'vip-fft-small' H3, both H1."""
    from vip_tpu_torch.ops import median, shear
    from vip_tpu_torch.ops.median import nanmedian_plain
    from vip_tpu_torch.psfsub import pca_annular

    rng = np.random.default_rng(5)
    n, y = 128, 64
    yy, xx = np.mgrid[:y, :y] - y / 2
    halo = 20 * np.exp(-(yy ** 2 + xx ** 2) / (2 * 10.0 ** 2))
    speckle = rng.standard_normal((3, y, y))
    weights = rng.standard_normal((n, 3)) * np.array([3.0, 1.5, 0.7])
    cube = halo + np.einsum("nk,kyx->nyx", weights, speckle) \
        + 0.3 * rng.standard_normal((n, y, y))
    angles = np.linspace(0.0, 60.0, n)
    kw = dict(ncomp=3, fwhm=4, asize=4, n_segments=1, verbose=False)
    worst = 0.0
    for imlib, kernel in (("vip-fft", "H2"), ("vip-fft-small", "H3")):
        median.launches = shear.launches = shear.small_launches = 0
        got = pca_annular(torch.as_tensor(cube, dtype=torch.float32,
                                          device=DEVICE), angles,
                          imlib=imlib, **kw)
        torch.cuda.synchronize()
        counts = {"H1": median.launches, "H2": shear.launches,
                  "H3": shear.small_launches}
        _require(counts["H1"] == 1 and counts[kernel] >= 3,
                 f"pca_annular {imlib}: launches {counts}")
        if imlib == "vip-fft":
            ref = pca_annular(torch.as_tensor(cube), angles, imlib=imlib,
                              **kw)
        else:
            # the CPU's fft-small route is vip_tpu's packed path, another
            # function: derotate the CPU residual cube through H3's plain
            # version on H3's canvas instead
            res64 = pca_annular(torch.as_tensor(cube), angles, imlib=imlib,
                                full_output=True, **kw)[0]
            ref = nanmedian_plain(_plain_small_derotate(
                res64, torch.as_tensor(angles), n), 0)
        err, scale = _rel_err(got.cpu(), ref)
        worst = max(worst, err / scale)
        print(f"small annular {n}x{y}x{y} {imlib}: launches {counts}; CUDA "
              f"f32 kernels vs CPU f64 plain: max abs err {err:.3e} (bound "
              f"{SMALL_ANN_TOL:.0e} x {scale:.3f})", flush=True)
        _require(err <= SMALL_ANN_TOL * scale,
                 f"small annular {imlib} disagrees with CPU f64")
    return worst


def phase_small_reference():
    """A small cube through the kernels (CUDA, float32) against the
    float64 CPU parity mode, which the tests hold against vip_tpu. The
    SVD is 'lapack' (QR, then the SVD of the small factor): the float32
    Gram-eigh trick alone moved this frame by 4e-4 on the H100."""
    from vip_tpu_torch.ops.pipeline import pca_adi_pipeline

    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[:64, :64] - 32.0
    halo = 5 * np.exp(-(yy ** 2 + xx ** 2) / (2 * 12.0 ** 2))
    cube = halo + rng.standard_normal((30, 64, 64))
    angles = np.linspace(0.0, 40.0, 30)
    got = pca_adi_pipeline(torch.as_tensor(cube, dtype=torch.float32,
                                           device=DEVICE),
                           torch.as_tensor(angles, device=DEVICE), ncomp=5,
                           method="lapack")
    ref = pca_adi_pipeline(torch.as_tensor(cube), torch.as_tensor(angles),
                           ncomp=5, method="lapack")
    err, scale = _rel_err(got.cpu(), ref)
    print(f"small 30x64x64: CUDA f32 kernels vs CPU f64 plain: max abs err "
          f"{err:.3e} (bound {SMALL_TOL:.0e} x {scale:.3f})", flush=True)
    _require(err <= SMALL_TOL * scale, "small cube disagrees with CPU f64")


@contextlib.contextmanager
def _plain_route():
    """Route the exact derotation (``VIP_EXACT_SHEAR=pruned``) and the
    median collapse through their plain PyTorch versions on the card, for
    a block; the kernels' counts must not move inside it."""
    from vip_tpu_torch.preproc import subsampling

    supported = subsampling.nanmedian_supported
    subsampling.nanmedian_supported = lambda arr, ax=0: False
    try:
        with _env("VIP_EXACT_SHEAR", "pruned"):
            before = _counts()
            yield
            _require(_counts() == before,
                     f"the plain route launched kernels: {before} -> "
                     f"{_counts()}")
    finally:
        subsampling.nanmedian_supported = supported


def phase_incremental(cube, angles_np, tmpdir):
    """``pca_incremental`` of the cube written to a FITS file (10 batches
    of 100 frames, ncomp 10, the card's block cache on): H1 once and H2
    three times a 50-frame chunk per batch, against the same call through
    the plain versions; then the pass-1 merge in float64 on the card.
    Returns (counts, runs by variant, the float32 frame)."""
    from vip_tpu_torch.fits import write_fits
    from vip_tpu_torch.psfsub import utils_pca
    from vip_tpu_torch.psfsub.utils_pca import pca_incremental

    path = os.path.join(tmpdir, "cube.fits")
    t0 = time.perf_counter()
    write_fits(path, cube.cpu().numpy(), verbose=False)
    t_write = time.perf_counter() - t0
    size_gb = os.path.getsize(path) / 1e9

    def run(**kw):
        return pca_incremental(path, angles_np, batch=INC_BATCH,
                               ncomp=NCOMP, verbose=False, **kw)

    def run_nocache():
        keep = utils_pca._CACHE_FRACTION
        utils_pca._CACHE_FRACTION = 0.0
        try:
            return run()
        finally:
            utils_pca._CACHE_FRACTION = keep

    _reset_counts()
    frame = run()
    torch.cuda.synchronize()
    counts = _counts()
    nb = -(-N_FRAMES // INC_BATCH)
    want_h2 = 3 * nb * -(-INC_BATCH // CHUNK)
    _require(counts["H1"] == nb and counts["H2"] == want_h2,
             f"pca_incremental launches {counts}, want H1 {nb}, H2 {want_h2}")
    with _plain_route():
        ref = run()
    _require(frame.shape == (SIZE, SIZE) and np.isfinite(frame).all(),
             "pca_incremental: not a finite frame")
    err, scale = _rel_err(torch.as_tensor(frame), torch.as_tensor(ref))
    nocache = run_nocache()
    bf16 = run(wire_dtype="bfloat16")
    f64_err = float(np.abs(_incremental_f64(path, angles_np) - frame).max())
    print(f"pca_incremental {N_FRAMES}x{SIZE}x{SIZE} from a {size_gb:.3f} GB "
          f"FITS file (written in {t_write:.3f} s), batch {INC_BATCH}: "
          f"launches {counts}; max abs err vs plain route {err:.3e} (bound "
          f"{PIPE_TOL:.0e} x {scale:.3f}); cache off vs on "
          f"{float(np.abs(nocache - frame).max()):.3e}; bfloat16 wire vs "
          f"float32 {float(np.abs(bf16 - frame).max()):.3e}; pass-1 merge "
          f"in float64 vs float32 {f64_err:.3e} (frame max |x| "
          f"{float(np.abs(frame).max()):.3e})", flush=True)
    _require(err <= PIPE_TOL * scale, "pca_incremental disagrees with the "
             "plain route")
    _require(np.array_equal(nocache, frame), "cache off changed the frame")
    return counts, {"cache on": run, "cache off": run_nocache,
                    "bfloat16 wire": lambda: run(wire_dtype="bfloat16")}


def _incremental_f64(path, angles_np):
    """``pca_incremental``'s frame with the pass-1 merge in float64 on the
    card (pass 2 as in float32 mode: the blocks, the basis and the mean in
    float32 through H2 and H1)."""
    from vip_tpu_torch.fits import open_fits
    from vip_tpu_torch.ops.pipeline import derotate_collapse
    from vip_tpu_torch.psfsub.utils_pca import (_incremental_merge_svd,
                                                _project_subtract_blk)

    lazy = open_fits(path, return_memmap=True, verbose=False)
    npx = SIZE * SIZE
    basis = torch.zeros((NCOMP, npx), dtype=torch.float64, device=DEVICE)
    mean = torch.zeros(npx, dtype=torch.float64, device=DEVICE)
    count = 0
    for lo in range(0, N_FRAMES, INC_BATCH):
        blk = torch.as_tensor(lazy[lo:lo + INC_BATCH].reshape(-1, npx),
                              device=DEVICE).double()
        basis, mean, count = _incremental_merge_svd(basis, blk, mean, count,
                                                    NCOMP)
    V = basis / basis.norm(dim=1, keepdim=True)
    V, mean = V.float(), mean.float()
    medians = []
    for lo in range(0, N_FRAMES, INC_BATCH):
        blk = torch.as_tensor(lazy[lo:lo + INC_BATCH].reshape(-1, npx),
                              device=DEVICE)
        resid = _project_subtract_blk(blk, mean, V).reshape(-1, SIZE, SIZE)
        medians.append(derotate_collapse(
            resid, torch.as_tensor(angles_np[lo:lo + INC_BATCH],
                                   device=DEVICE), chunk=CHUNK).cpu().numpy())
    return np.median(np.array(medians), axis=0)


def _gaussian_psf(size=21):
    """A Gaussian stamp of FWHM COMP_FWHM px."""
    q = np.arange(size) - size // 2
    two_sig2 = 2 * (COMP_FWHM / (2 * np.sqrt(2 * np.log(2)))) ** 2
    return np.exp(-(q[:, None] ** 2 + q[None, :] ** 2) / two_sig2)


def phase_contrast(cube, angles_np):
    """The contrast curve of the port's ``pca`` (ncomp 10, eigen, median)
    through its pandas-free ``_contrast_curve``: 3 patterns of injected
    companions plus the reduction without, injected and reduced on the
    card (H2, H1), against the plain route. Returns (counts, the columns,
    the run, the normalized PSF)."""
    from vip_tpu_torch.fm import normalize_psf
    from vip_tpu_torch.metrics.contrcurve import _contrast_curve
    from vip_tpu_torch.psfsub import pca

    psfn = normalize_psf(_gaussian_psf(), fwhm=COMP_FWHM, verbose=False)

    def run():
        return _contrast_curve(cube, angles_np, psfn, COMP_FWHM, CC_PXSCALE,
                               CC_STARPHOT, pca, nbranch=1, fc_rad_sep=3,
                               fc_snr=100, student=True, plot=False,
                               verbose=False, **CC_ALGO)[0]

    _reset_counts()
    cols = run()
    torch.cuda.synchronize()
    counts = _counts()
    _require(counts["H1"] == 4 and counts["H2"] > 0 and counts["H4"] == 0,
             f"contrast curve launches {counts}, want H1 4 (3 patterns and "
             "the empty reduction) and H2")
    with _plain_route():
        ref = run()
    worst = {}
    for name in ("sensitivity_student", "throughput"):
        got, want = cols[name], ref[name]
        _require(got.shape == want.shape and np.isfinite(got).all(),
                 f"contrast curve {name}: not finite")
        worst[name] = float(np.max(np.abs(got - want) / np.abs(want)))
    thr = cols["throughput"]
    print(f"contrast curve {N_FRAMES}x{SIZE}x{SIZE} ({len(thr)} radii "
          f"{cols['distance'][0]:.1f}..{cols['distance'][-1]:.1f} px): "
          f"launches {counts} (H1 = PCA reductions); throughput "
          f"{thr.min():.4f}..{thr.max():.4f}; student sensitivity "
          f"{cols['sensitivity_student'].min():.3e}.."
          f"{cols['sensitivity_student'].max():.3e}; max relative err vs "
          f"plain route: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       worst.items())
          + " (bound 1e-4)", flush=True)
    _require(max(worst.values()) <= 1e-4, "contrast curve disagrees with "
             "the plain route")
    _require(np.all((thr > 0) & (thr <= 1)), "a throughput outside (0, 1]")
    return counts, cols, run, psfn


def phase_completeness(cube, angles_np, psfn, cols):
    """``completeness_curve`` of the same algo at two radii (the depth cut
    to stay within the time limit), each probe injected and reduced on
    the card, starting from the contrast phase's Student contrast.
    Returns (counts, wall seconds)."""
    from vip_tpu_torch.fm import find_nearest
    from vip_tpu_torch.metrics import completeness_curve
    from vip_tpu_torch.psfsub import pca

    ini = [float(cols["sensitivity_student"][find_nearest(
        cols["distance"], a)]) for a in COMPL_RADII]
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    an_dist, levels = completeness_curve(
        cube, angles_np, psfn, COMP_FWHM, pca, an_dist=list(COMPL_RADII),
        ini_contrast=ini, starphot=CC_STARPHOT, n_fc=COMPL_NFC,
        snr_approximation=True, algo_dict=dict(CC_ALGO), plot=False,
        verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    _require(counts["H1"] > 1 and counts["H2"] > 0,
             f"completeness launches {counts}")
    _require(np.all(np.isfinite(levels)) and np.all(levels > 0),
             f"completeness levels {levels}")
    print(f"completeness_curve {N_FRAMES}x{SIZE}x{SIZE} at r = "
          f"{list(an_dist)} px, n_fc {COMPL_NFC}, 95%: levels "
          f"{[float(v) for v in levels]} (starting from {ini}); "
          f"{counts['H1'] - 1} probes (H1 launches less the empty "
          f"reduction); launches {counts}; {wall:.3f} s", flush=True)
    return counts, wall


def phase_stim(pcube, angles_np, src):
    """``normalized_stim_map`` of the PCA residual cube of the cube with
    the planted companion: two derotations through H2; the map's maximum
    within 3 px of the companion. Returns (counts, the run)."""
    from vip_tpu_torch.metrics import normalized_stim_map
    from vip_tpu_torch.psfsub import pca

    resid = pca(pcube, angles_np, ncomp=NCOMP, svd_mode="eigen",
                full_output=True, verbose=False)[3]

    def run():
        return normalized_stim_map(resid, angles_np)

    _reset_counts()
    smap = run()
    torch.cuda.synchronize()
    counts = _counts()
    _require(counts["H2"] > 0 and smap.is_cuda
             and bool(torch.isfinite(smap).all()),
             f"normalized_stim_map: launches {counts}")
    peak = np.unravel_index(int(smap.argmax()), smap.shape)
    print(f"normalized_stim_map {N_FRAMES}x{SIZE}x{SIZE}: launches {counts};"
          f" max {float(smap.max()):.3f} at (y, x) "
          f"{tuple(int(v) for v in peak)}, planted at {(src[1], src[0])}",
          flush=True)
    _require(_near([peak[0]], [peak[1]], src), "STIM maximum is not at the "
             "planted companion")
    return counts, run


def _nmf_iterations():
    """Wrap ``psfsub.nmf_fullfr.nmf_fit`` so that it records the
    iterations of each fit; returns the list it appends to."""
    from vip_tpu_torch.psfsub import nmf_fullfr

    fit, iters = nmf_fullfr.nmf_fit, []

    def counted(*args, **kwargs):
        W, H, it = fit(*args, **kwargs)
        iters.append(it)
        return W, H, it

    nmf_fullfr.nmf_fit = counted
    return iters


def _last_and_first(out):
    """(final frame, first pass's frame) of an entry point's output: a
    frame, or the full output of ``ipca`` (frame, it_cube, ...) or
    ``iroll`` (cube_res, cube_der, frame, the frames of every pass)."""
    if not isinstance(out, tuple):
        return out, out
    if len(out) == 4:
        return out[2], out[3][0]
    return out[0], out[1][0]


def phase_slice4(pcube, angles_np, src):
    """Slice 4 at full width: each new entry point through the kernels
    (launches counted from 0 just before it), through the plain route
    (``_plain_route``: the plain derotation and median), the two within
    PIPE_TOL of max(|ref|, 1) (the greedy loops: their first pass, and
    their last within GREEDY_TOL); its warm time (median of 3, or the counted
    run alone for the long ones); the planted companion detected where
    the frame keeps the full width. Returns {name: (counts, seconds)}."""
    from vip_tpu_torch import greedy, psfsub
    from vip_tpu_torch.metrics import detection

    t_phase = time.perf_counter()
    lo, hi = SIZE // 2 - SLICE4_CROP // 2, SIZE // 2 + SLICE4_CROP // 2
    crop = pcube[:, lo:hi, lo:hi].contiguous()
    crop5, ang5 = crop[::SLICE4_EVERY].contiguous(), \
        angles_np[::SLICE4_EVERY]
    crop10, ang10 = crop[::LOCI_EVERY].contiguous(), angles_np[::LOCI_EVERY]
    mid = float(np.mean(angles_np))
    low, high = angles_np <= mid, angles_np > mid
    rolls = np.where(low, angles_np[low].mean(), angles_np[high].mean())
    # annular NMF and INMF check each library's median for a sign before
    # any handle_neg: they take the cube shifted to positive values
    positive = pcube - pcube.min() + 1.0
    pos5 = (crop5 - pcube.min() + 1.0).contiguous()
    iters = _nmf_iterations()
    # (name, run, timed reps (1: the counted run), whether the median
    # collapse runs H1, detect the companion)
    cases = [
        ("nmf", lambda: psfsub.nmf(pcube, angles_np, verbose=False,
                                   **NMF4), 1, True, True),
        ("nmf_annular", lambda: psfsub.nmf_annular(
            pos5, ang5, verbose=False, **NMF_ANN4), 1, True, False),
        ("llsg", lambda: psfsub.llsg(crop5, ang5, verbose=False, **LLSG4),
         1, True, False),
        ("frame_diff", lambda: psfsub.frame_diff(
            crop, angles_np, verbose=False, **FD4), 1, True, False),
        ("frame_diff n_similar 4", lambda: psfsub.frame_diff(
            crop, angles_np, n_similar=4, verbose=False, **FD4), 1, True,
         False),
        ("xloci", lambda: psfsub.xloci(crop10, ang10, verbose=False,
                                       **LOCI4), 1, True, False),
        ("roll_sub", lambda: psfsub.roll_sub(pcube, rolls, verbose=False),
         3, False, False),
        # the greedy loops with full output: their first pass's frame is
        # compared too
        ("ipca", lambda: greedy.ipca(pcube, angles_np, ncomp=3, nit=3,
                                     full_output=True, verbose=False), 1,
         True, True),
        # inmf and iroll hand only their keyword arguments on to nmf and
        # roll_sub, as vip_tpu does
        ("inmf", lambda: greedy.inmf(cube=positive, angle_list=angles_np,
                                     verbose=False), 1, True, True),
        ("iroll", lambda: greedy.iroll(cube=pcube, angle_list=rolls,
                                       mode="individual", full_output=True,
                                       verbose=False), 1, False, False),
    ]
    out = {}
    for name, run, reps, median_collapse, detect in cases:
        del iters[:]
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame, first = _last_and_first(run())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        n_fits = len(iters)
        _require(frame.is_cuda and frame.dim() == 2
                 and bool(torch.isfinite(frame).all()),
                 f"{name}: not a finite CUDA frame")
        _require(counts["H2"] > 0 and (counts["H1"] > 0) == median_collapse
                 and counts["H3"] == counts["H4"] == 0,
                 f"{name}: launches {counts}")
        with _plain_route():
            ref, ref_first = _last_and_first(run())
        err, scale = _rel_err(frame, ref)
        err_first, scale_first = _rel_err(first, ref_first)
        del ref, ref_first
        # the greedy loops feed each frame back into the next pass: their
        # first pass is held to PIPE_TOL, their last to GREEDY_TOL
        _require(err_first <= PIPE_TOL * scale_first,
                 f"{name}: {err_first:.3e} from the plain route (first "
                 f"pass)")
        tol = GREEDY_TOL if first is not frame else PIPE_TOL
        _require(err <= tol * scale,
                 f"{name}: {err:.3e} from the plain route")
        if reps > 1:
            wall = float(np.median(_sync_times(run, reps)))
        line = (f"slice 4 {name}: launches {counts}; vs plain route "
                f"{err:.3e} (bound {tol:.0e} x {scale:.3f}"
                + (f"; first pass {err_first:.3e}, bound "
                   f"{PIPE_TOL:.0e} x {scale_first:.3f}"
                   if first is not frame else "") + "); "
                f"{'warm median of 3' if reps > 1 else 'one run'} "
                f"{wall:.4f} s")
        if n_fits:
            line += f"; NMF fits {n_fits}, iterations {sorted(set(iters))}"
        if detect:
            ys, xs = detection(frame, fwhm=COMP_FWHM, mode="lpeaks",
                               bkg_sigma=5, snr_thresh=5, full_output=False,
                               plot=False, verbose=False)
            found = _near(ys, xs, src)
            line += f"; companion detected: {found}"
            _require(found, f"{name}: the planted companion was missed")
        print(line, flush=True)
        out[name] = (counts, wall)
    print(f"slice 4 cuts: annular NMF, LLSG, frame differencing and LOCI "
          f"on the central {SLICE4_CROP}x{SLICE4_CROP} (annuli to 60 px); "
          f"annular NMF and LLSG on every {SLICE4_EVERY}th frame "
          f"({crop5.shape[0]} of {N_FRAMES}), LOCI on every {LOCI_EVERY}th "
          f"({crop10.shape[0]}); the phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _negfc_near(p, truth, tol):
    """Whether (r, theta, f) lies within ``tol`` = (px, degrees, relative
    flux) of ``truth``, theta compared modulo 360."""
    dth = (p[1] - truth[1] + 180) % 360 - 180
    return (abs(p[0] - truth[0]) < tol[0] and abs(dth) < tol[1]
            and abs(p[2] - truth[2]) < tol[2] * truth[2])


def phase_negfc(pcube, angles_np, src, profile=False):
    """NEGFC on the cube with the planted companion (slice 5): the truth
    (COMP_SEP, 0, f_true) with f_true the companion's flux in the units of
    the normalized PSF; ``firstguess`` (a 12-value flux grid, the simplex)
    and ``mcmc_negfc_sampling`` (NEGFC_MCMC) on every NEGFC_EVERY-th frame,
    each with its H1/H2 launches, the first guess and the posterior median
    of the chain's second half (and its ``confidence`` mode) held to the
    truth; 8 walkers (one out of bounds) through the kernels against the
    plain route and the host ``lnprob``; a half-step of 50 walkers timed
    (and with ``profile`` traced by torch.profiler: building its table
    takes minutes, the half-step's SVDs making ~90k device events); the
    likelihood at full depth and at bench.py's shape. Returns {path:
    counts} and the timings."""
    from vip_tpu_torch.fm import (confidence, firstguess, get_mu_and_sigma,
                                  lnprob, mcmc_negfc_sampling, normalize_psf)
    from vip_tpu_torch.ops.apertures import aperture_flux
    from vip_tpu_torch.ops.negfc_model import make_batched_lnprob

    t_phase = time.perf_counter()
    raw = _gaussian_psf()
    psfn = normalize_psf(raw, fwhm=COMP_FWHM, verbose=False)
    c = float(raw.shape[0] // 2)
    # the companion is COMP_PEAK times raw's unit-peak Gaussian, and psfn
    # is raw over its 1-FWHM aperture flux
    f_true = COMP_PEAK * float(aperture_flux(raw, np.array([c]),
                                             np.array([c]),
                                             COMP_FWHM / 2)[0])
    sigma = COMP_FWHM / (2 * np.sqrt(2 * np.log(2)))
    print(f"negfc truth: r {COMP_SEP}, theta 0, flux {f_true:.4f} in the "
          f"normalized PSF's units (COMP_PEAK pi sigma^2 = "
          f"{COMP_PEAK * np.pi * sigma ** 2:.4f})", flush=True)
    truth = (COMP_SEP, 0.0, f_true)
    cube = pcube[::NEGFC_EVERY].contiguous()
    angs = angles_np[::NEGFC_EVERY].astype(np.float64)
    counts, times = {}, {}

    def run(name, fn):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        counts[name] = _counts()
        _require(counts[name]["H1"] > 0 and counts[name]["H2"] > 0
                 and counts[name]["H3"] == counts[name]["H4"] == 0,
                 f"{name}: launches {counts[name]}")
        return out

    r0, th0, f0 = run("negfc firstguess", lambda: firstguess(
        cube, angs, psfn, [src],
        f_range=np.geomspace(f_true / 10, f_true * 10, 12), verbose=False))
    guess = (float(r0[0]), float(th0[0]), float(f0[0]))
    n_chi2 = counts["negfc firstguess"]["H1"] - 1
    print(f"negfc firstguess: ({guess[0]:.4f}, {guess[1]:.4f}, "
          f"{guess[2]:.4f}) in {times['negfc firstguess']:.3f} s, {n_chi2} "
          f"chi2 and 1 annulus statistics; launches "
          f"{counts['negfc firstguess']}", flush=True)
    _require(_negfc_near(guess, truth, NEGFC_FG_TOL),
             f"negfc firstguess {guess} is not within {NEGFC_FG_TOL} of "
             f"{truth}")

    # the first guess's theta in [0, 360): the initial ball scales with
    # theta, and a theta just below 0 makes it negative (as in vip_tpu)
    init = (guess[0], guess[1] % 360, guess[2])
    chain = run("negfc mcmc", lambda: mcmc_negfc_sampling(
        cube, angs, psfn, init, **NEGFC_MCMC))
    nw, steps = chain.shape[:2]
    evals = nw * (1 + steps)
    second = chain[:, steps // 2:].reshape(-1, 3)
    median = np.median(second, axis=0)
    mode, ci = confidence(second, bins=30, verbose=False,
                          labels=["r", "theta", "f"])
    print(f"negfc mcmc: {nw} walkers x {steps} steps, {evals} walker "
          f"evaluations in {times['negfc mcmc']:.3f} s "
          f"({evals / times['negfc mcmc']:.1f} walker-evals/s); launches "
          f"{counts['negfc mcmc']}; median of the second half "
          f"({median[0]:.4f}, {median[1]:.4f}, {median[2]:.4f}); confidence "
          f"mode " + ", ".join(f"{k} {v:.4f} [{ci[k][0]:.4f}, "
                               f"{ci[k][1]:.4f}]" for k, v in mode.items()),
          flush=True)
    _require(bool(np.isfinite(chain).all())
             and NEGFC_MCMC["niteration_min"] <= steps
             <= NEGFC_MCMC["niteration_limit"], "negfc mcmc: chain")
    # H1 once a batch: the two reductions of the annulus statistics, the
    # first batch and two half-steps a step
    _require(counts["negfc mcmc"]["H1"] == 3 + 2 * steps,
             f"negfc mcmc: {counts['negfc mcmc']['H1']} H1 launches for "
             f"{steps} steps")
    _require(_negfc_near(median, truth, NEGFC_MCMC_TOL),
             f"negfc mcmc: posterior median {median} is not within "
             f"{NEGFC_MCMC_TOL} of {truth}")

    # 8 walkers, one out of bounds, with the MCMC's statistics and bounds
    t0 = time.perf_counter()
    mu, sig = get_mu_and_sigma(cube, angs, 1, 8, 1, COMP_FWHM, guess[0],
                               guess[1], guess[2], psfn)
    print(f"negfc get_mu_and_sigma (the companion removed on the host): "
          f"({mu:.4e}, {sig:.4e}) in {time.perf_counter() - t0:.3f} s",
          flush=True)
    dth = 360.0 / (2 * np.pi * guess[0] / (COMP_FWHM / 2))
    bounds = [(guess[0] - 2, guess[0] + 2), (guess[1] - dth, guess[1] + dth),
              (0, 5 * guess[2])]
    rng = np.random.default_rng(16)
    step = np.array([0.5, 0.5 * dth, 0.2 * guess[2]])
    walkers = np.asarray(guess) + rng.uniform(-1, 1, (8, 3)) * step
    walkers[-1, 0] = guess[0] + 3
    args = (angs, psfn, 1, 8, guess[0], guess[1], 1, COMP_FWHM, mu,
            sig ** 2, bounds)
    lnp = make_batched_lnprob(cube, *args)
    got = run("negfc lnprob 8 walkers", lambda: lnp(walkers)).cpu().double()
    with _plain_route():
        plain = lnp(walkers).cpu().double()
    host = torch.tensor([
        lnprob(tuple(p), bounds, cube, angs, psfn, COMP_FWHM, 8, 1, 1,
               guess, mu_sigma=(mu, sig)) for p in walkers],
        dtype=torch.float64)
    fin = torch.isfinite(got)
    _require(fin.sum() == 7 and torch.equal(fin, torch.isfinite(plain))
             and torch.equal(fin, torch.isfinite(host)),
             "negfc lnprob: out-of-bounds walkers")
    err_plain = float(((got - plain).abs() / plain.abs())[fin].max())
    err_host = float(((got - host).abs() / host.abs())[fin].max())
    print(f"negfc lnprob of 8 walkers (one out of bounds) on "
          f"{cube.shape[0]}x{SIZE}^2: launches "
          f"{counts['negfc lnprob 8 walkers']}; against the plain route "
          f"{err_plain:.3e} relative (bound {PIPE_TOL:.0e}), against the "
          f"host lnprob {err_host:.3e} (bound {NEGFC_HOST_RTOL:.0e})",
          flush=True)
    _require(err_plain <= PIPE_TOL, "negfc lnprob disagrees with the plain "
             "route")
    _require(err_host <= NEGFC_HOST_RTOL, "negfc lnprob disagrees with the "
             "host lnprob")
    print(f"negfc: {time.perf_counter() - t_phase:.1f} s into the phase",
          flush=True)

    # a half-step: 50 proposals in bounds
    half = np.asarray(guess) \
        + rng.uniform(-1, 1, (NEGFC_MCMC["nwalkers"] // 2, 3)) * step
    t_half = _sync_times(lambda: lnp(half))
    print(f"negfc half-step (50 walkers x {cube.shape[0]} frames): "
          f"{_spread(t_half)} s, {50 / np.median(t_half):.1f} walker-evals/s;"
          f" {time.perf_counter() - t_phase:.1f} s into the phase",
          flush=True)
    if profile:
        t0 = time.perf_counter()
        prof_wall, table = _profile_table(lambda: lnp(half), rows=12)
        print(f"negfc half-step under the profiler {prof_wall:.4f} s (the "
              f"table took {time.perf_counter() - t0 - prof_wall:.1f} s); "
              f"top ops by device time:\n{table}", flush=True)

    full = make_batched_lnprob(pcube, angles_np.astype(np.float64), psfn,
                               *args[2:])
    full_walkers = np.asarray(guess) \
        + rng.uniform(-1, 1, (NEGFC_FULL_WALKERS, 3)) * step
    v = run("negfc lnprob full depth", lambda: full(full_walkers))
    _require(bool(torch.isfinite(v).all()), "negfc full depth: lnprob")
    t_full = times["negfc lnprob full depth"]
    print(f"negfc lnprob at full depth ({N_FRAMES}x{SIZE}^2, "
          f"{NEGFC_FULL_WALKERS} walkers, one call): {t_full:.3f} s, "
          f"{NEGFC_FULL_WALKERS / t_full:.2f} walker-evals/s; launches "
          f"{counts['negfc lnprob full depth']}", flush=True)
    del full

    # bench.py's NEGFC leg: 50x64x64, 16 walkers, ncomp 5
    yy, xx = np.mgrid[:13, :13]
    psf_b = np.exp(-((yy - 6.0) ** 2 + (xx - 6.0) ** 2)
                   / (2 * (4 / 2.355) ** 2))
    lnp_b = make_batched_lnprob(
        pcube[:50, :64, :64].contiguous(), angles_np[:50].astype(np.float64),
        psf_b, 5, 4, 20.0, 45.0, 2.0, 4.0, np.zeros(1), 1.0,
        [(10.0, 30.0), (10.0, 80.0), (0.1, 100.0)])
    wb = np.column_stack([rng.uniform(15, 25, 16), rng.uniform(30, 60, 16),
                          rng.uniform(1, 50, 16)])
    vb = run("negfc lnprob bench shape", lambda: lnp_b(wb))
    _require(bool(torch.isfinite(vb).all()), "negfc bench shape: lnprob")
    t_b = _sync_times(lambda: lnp_b(wb))
    print(f"negfc lnprob at bench.py's shape (50x64x64, 16 walkers, ncomp "
          f"5): {_spread(t_b)} s, {16 / np.median(t_b):.1f} walker-evals/s; "
          f"launches {counts['negfc lnprob bench shape']}", flush=True)
    times.update(half_step=float(np.median(t_half)),
                 bench_shape=float(np.median(t_b)))
    print(f"negfc cuts: the sampler on every {NEGFC_EVERY}th frame "
          f"({cube.shape[0]} of {N_FRAMES}); the phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts, times


def _invprob_configs(fwhm):
    """The goldens' ANDROMEDA and FMMF configurations (tests/gen_golden.py:
    invprob_configs): {name: (entry point, keywords)}."""
    oversamp = (NACO_LBDA / VLT_DIAM * 206265 / 2.0) / NACO_PLSC
    andro = dict(oversampling_fact=oversamp, filtering_fraction=0.25,
                 min_sep=0.5, annuli_width=1.0, roa=2, nsmooth_snr=18,
                 iwa=2, owa=None, precision=50, fast=False,
                 homogeneous_variance=True, ditimg=1.0, ditpsf=None,
                 tnd=1.0, total=False, multiply_gamma=True, verbose=False)
    fmmf = dict(fwhm=fwhm, var="FR", nproc=1, min_r=INV_WINDOW[0],
                max_r=INV_WINDOW[1], param=INV_FMMF_PARAM, crop=5,
                imlib="vip-fft", verbose=False)
    return {"andro_adi": ("andromeda", dict(andro, opt_method="lsq")),
            "androl1_adi": ("andromeda", dict(andro, opt_method="l1")),
            "fmmf_kl_adi": ("fmmf", dict(fmmf, model="KLIP")),
            "fmmf_lo_adi": ("fmmf", dict(fmmf, model="LOCI"))}


def _host64(t):
    return t.detach().cpu().double().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float64)


def _found(snr, fwhm, yx):
    """Whether the port's ``detection`` finds a source within 3 px of
    (y, x) on an S/N map (NaN read as 0)."""
    from vip_tpu_torch.metrics import detection

    ys, xs = detection(np.nan_to_num(_host64(snr)), fwhm=fwhm, mode="lpeaks",
                       bkg_sigma=5, matched_filter=False, mask=True,
                       snr_thresh=2, plot=False, verbose=False)
    return _near(ys, xs, (yx[1], yx[0]))


def phase_invprob(pcube, angles_np, profile=False):
    """Slice 6: ANDROMEDA (lsq, l1), FMMF (KLIP, LOCI) and FastPACO.

    1. The NACO replica through float64 CUDA tensors against the goldens
       (andro_adi, androl1_adi, fmmf_kl_adi, fmmf_lo_adi) at
       INV_GOLDEN_TOL, and in float32: each float32 map's error against the
       golden printed, each map's companions found with the port's
       ``detection`` (the planet on ANDROMEDA's and PACO's maps, the
       companions VIP found on the golden FMMF maps), FastPACO's float32
       S/N within PACO_F32_TOL of its float64 run.
    2. Full width (every INV_EVERY-th frame of the cube with the planted
       companion, its central INV_SIZE²): ``andromeda`` (lsq, oversampling
       2, iwa 2), ``FastPACO`` and ``fmmf`` KLIP over INV_FW_WINDOW, each
       finding the companion, timed once with its H2 launches.
    3. FMMF on one full-width annulus through H2 against the plain route.
    4. bench.py's three invprob legs (bench.py:460-509) in float32, warm
       median of 3; FMMF's batched form on one annulus of the replica
       (warm median of 3) and its serial form once.
    Returns {path: counts} and {name: seconds}."""
    import vip_tpu_torch.invprob as ip
    from vip_tpu_torch.var.shapes import get_annulus_segments

    t_phase = time.perf_counter()
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
    meta = np.load(os.path.join(golden, "meta.npz"))
    cube_np = np.load(os.path.join(golden, "inputs.npz"))["cube"]
    angles, psfn = meta["angles"], meta["psfn"]
    fwhm = float(meta["fwhm"])
    planet = tuple(meta["planet_yx"])
    configs = _invprob_configs(fwhm)
    counts, times, maps = {}, {}, {}

    def run(name, fn):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        counts[name] = _counts()
        _require(counts[name]["H1"] == counts[name]["H3"]
                 == counts[name]["H4"] == 0, f"{name}: {counts[name]}")
        return out

    def window_pixels(window):
        pix = [get_annulus_segments(cube_np[0], r, 1)[0]
               for r in range(*window)]
        return (np.concatenate([p[0] for p in pix]),
                np.concatenate([p[1] for p in pix]))

    win = window_pixels(INV_WINDOW)
    errs = {}
    for dt, tag in ((torch.float64, "float64"), (torch.float32, "float32")):
        cube_t = torch.as_tensor(cube_np, dtype=dt, device=DEVICE)
        for name, (fn, kw) in configs.items():
            res = run(f"{name} {tag}", lambda: getattr(ip, fn)(
                cube=cube_t, angle_list=angles, psf=psfn, **kw))
            if fn == "andromeda":
                pair = (res[0], res[2])
                refs = (f"{name}.npy",
                        f"{name.replace('_adi', '')}_snr_adi.npy")
                sel = (slice(None), slice(None))
            else:
                pair, refs, sel = res, (f"{name}.npy", f"{name}_snr.npy"), win
            maps[(name, tag)] = pair
            errs[(name, tag)] = [float(np.nanmax(np.abs(
                _host64(m)[sel] - np.load(os.path.join(golden, r))[sel])))
                for m, r in zip(pair, refs)]
        maps[("fastpaco", tag)] = run(f"fastpaco {tag}", lambda: ip.FastPACO(
            cube=cube_t, angles=angles, psf=psfn, fwhm=fwhm,
            pixscale=1.0).run()[0])
        del cube_t
    for name in configs:
        e64, e32 = errs[(name, "float64")], errs[(name, "float32")]
        print(f"invprob {name} against VIP's golden (max abs, map and S/N):"
              f" float64 {e64[0]:.3e}, {e64[1]:.3e} in "
              f"{times[name + ' float64']:.3f} s; float32 {e32[0]:.3e}, "
              f"{e32[1]:.3e} in {times[name + ' float32']:.3f} s; launches "
              f"{counts[name + ' float32']}", flush=True)
        _require(max(e64) <= INV_GOLDEN_TOL, f"invprob {name}: float64 "
                 f"{e64} from the golden, over {INV_GOLDEN_TOL}")
        found = np.load(os.path.join(golden, f"{name}_detect.npy"))
        expect = [c for c in (planet, tuple(meta["injected_yx"]))
                  if _near(found[:, 0], found[:, 1], (c[1], c[0]))]
        if name.startswith("andro"):
            _require(planet in expect, f"{name}: VIP missed the planet")
        for c in expect:
            _require(_found(maps[(name, "float32")][1], fwhm, c),
                     f"invprob {name} float32: the companion at {c} missed")
    s64 = _host64(maps[("fastpaco", "float64")])
    s32 = _host64(maps[("fastpaco", "float32")])
    fin = np.isfinite(s64)
    _require(np.array_equal(fin, np.isfinite(s32)), "fastpaco: NaN pixels")
    paco_err = float(np.abs(s32 - s64)[fin].max() / np.abs(s64[fin]).max())
    t64, t32 = times["fastpaco float64"], times["fastpaco float32"]
    print(f"invprob FastPACO on the replica: float64 {t64:.3f} s, float32 "
          f"{t32:.3f} s; "
          f"float32 S/N against float64 {paco_err:.3e} of max|snr| "
          f"{np.abs(s64[fin]).max():.3f} (bound {PACO_F32_TOL:.0e}); "
          f"launches {counts['fastpaco float32']}", flush=True)
    _require(paco_err <= PACO_F32_TOL, "fastpaco: float32 against float64")
    for tag in ("float64", "float32"):
        _require(_found(maps[("fastpaco", tag)], fwhm, planet),
                 f"fastpaco {tag}: the planet missed")
    print(f"invprob: {time.perf_counter() - t_phase:.1f} s into the phase",
          flush=True)

    # full width: the cube with the planted companion, cut
    c0 = (SIZE - INV_SIZE) // 2
    cube_fw = pcube[::INV_EVERY, c0:c0 + INV_SIZE, c0:c0 + INV_SIZE] \
        .contiguous()
    angs_fw = angles_np[::INV_EVERY].astype(np.float64)
    comp = (INV_SIZE // 2, INV_SIZE // 2 + COMP_SEP)
    yy, xx = np.mgrid[:20, :20]
    sig = COMP_FWHM / (2 * np.sqrt(2 * np.log(2)))
    psf20 = np.exp(-((yy - 10.0) ** 2 + (xx - 10.0) ** 2) / (2 * sig ** 2))
    fmmf_fw = dict(fwhm=COMP_FWHM, model="KLIP", var="FR",
                   param=INV_FMMF_PARAM, crop=5, imlib="vip-fft",
                   verbose=False)
    full = {
        "andromeda full width": lambda: ip.andromeda(
            cube=cube_fw, angle_list=angs_fw, psf=psf20,
            oversampling_fact=2, iwa=2, opt_method="lsq", verbose=False)[2],
        "fastpaco full width": lambda: ip.FastPACO(
            cube=cube_fw, angles=angs_fw, psf=psf20, fwhm=COMP_FWHM,
            pixscale=1.0).run()[0],
        "fmmf full width": lambda: ip.fmmf(
            cube=cube_fw, angle_list=angs_fw, psf=psf20 / psf20.sum(),
            min_r=INV_FW_WINDOW[0], max_r=INV_FW_WINDOW[1], **fmmf_fw)[1],
    }
    for name, fn in full.items():
        snr = run(name, fn)
        hit = _found(snr, COMP_FWHM, comp)
        print(f"invprob {name} ({cube_fw.shape[0]}x{INV_SIZE}^2): "
              f"{times[name]:.3f} s, launches {counts[name]}, max S/N "
              f"{float(np.nanmax(_host64(snr))):.2f}, companion at "
              f"{comp} found: {hit}", flush=True)
        _require(hit, f"invprob {name}: the companion at {comp} missed")
    _require(counts["fmmf full width"]["H2"] > 0, "fmmf: H2 never launched")

    # one full-width annulus through H2 and through the plain route
    r = int(COMP_SEP)
    one = dict(fmmf_fw, min_r=r, max_r=r + 1)
    kernel = ip.fmmf(cube=cube_fw, angle_list=angs_fw, psf=psf20, **one)
    with _plain_route():
        plain = ip.fmmf(cube=cube_fw, angle_list=angs_fw, psf=psf20, **one)
    plain_err = max(e / scale for e, scale in (
        _rel_err(k, p) for k, p in zip(kernel, plain)))
    print(f"invprob fmmf r={r} through H2 against the plain route: "
          f"{plain_err:.3e} of max(|ref|, 1) (bound {PIPE_TOL:.0e})",
          flush=True)
    _require(plain_err <= PIPE_TOL, "fmmf disagrees with the plain route")

    # bench.py's invprob legs, and FMMF's two forms on one annulus
    cube32 = torch.as_tensor(cube_np, dtype=torch.float32, device=DEVICE)
    legs = {
        "bench andromeda lsq": lambda: ip.andromeda(
            cube=cube32, angle_list=angles, psf=psfn,
            **configs["andro_adi"][1]),
        "bench fastpaco": lambda: ip.FastPACO(
            cube=cube32, angles=angles, psf=psfn, fwhm=fwhm,
            pixscale=1.0).run(),
        "bench fmmf klip r26-30": lambda: ip.fmmf(
            cube=cube32, angle_list=angles, psf=psfn,
            **dict(configs["fmmf_kl_adi"][1], min_r=INV_BENCH_WINDOW[0],
                   max_r=INV_BENCH_WINDOW[1])),
    }
    for name, fn in legs.items():
        t = _sync_times(fn)
        times[name] = float(np.median(t))
        print(f"timing {name} (61x101^2 float32, median [min, max] of 3): "
              f"{_spread(t)} s", flush=True)
    # the serial form once (7.8-16.2 s an annulus here, 17-48x the
    # batched one, on an H100 80GB HBM3 at 700 W: PERF.md), after the
    # batched form's warm median of 3
    kw26 = dict(configs["fmmf_kl_adi"][1], min_r=26, max_r=27)
    with _env("VIP_TPU_FMMF_BATCHED", "1"):
        t_batched = _sync_times(lambda: ip.fmmf(
            cube=cube32, angle_list=angles, psf=psfn, **kw26))
    with _env("VIP_TPU_FMMF_BATCHED", "0"):
        run("fmmf serial form", lambda: ip.fmmf(
            cube=cube32, angle_list=angles, psf=psfn, **kw26))
    t_serial = times["fmmf serial form"]
    times["fmmf r=26 batched"] = float(np.median(t_batched))
    print(f"timing fmmf one annulus of the replica (r=26, KLIP): "
          f"VIP_TPU_FMMF_BATCHED=1 {_spread(t_batched)} s, =0 (once) "
          f"{t_serial:.4f} s", flush=True)
    if profile:
        with _env("VIP_TPU_FMMF_BATCHED", "1"):
            prof_wall, table = _profile_table(lambda: ip.fmmf(
                cube=cube_fw, angle_list=angs_fw, psf=psf20, **one), rows=12)
        print(f"invprob fmmf r={r} full width under the profiler "
              f"{prof_wall:.4f} s; top ops by device time:\n{table}",
              flush=True)
    print(f"invprob cuts: the full-width runs on every {INV_EVERY}th frame "
          f"({cube_fw.shape[0]} of {N_FRAMES}) and the central {INV_SIZE}^2;"
          f" the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts, times


def _moffat_psf(size=39, fwhm=4.800919383981533, alpha=2.5, peak=1680.0):
    """The NACO replica's raw PSF (tests/naco_replica.py:moffat_psf)."""
    gamma = fwhm / (2.0 * np.sqrt(2.0 ** (1.0 / alpha) - 1.0))
    yy, xx = np.mgrid[:size, :size].astype(np.float64)
    c = (size - 1) / 2.0
    return peak * (1.0 + ((xx - c) ** 2 + (yy - c) ** 2) / gamma ** 2) \
        ** (-alpha)


def phase_f2():
    """F2: the goldens' configurations on the committed NACO replica in
    float32, on the card and on the CPU from the same float32 cube; each
    card frame's max abs error against VIP's float64 golden must stay
    within F2_RATIO times the CPU's (at least F2_FLOOR), and the 3-px
    detection oracle must pass; the golden injection's PSF normalization
    and its flux-300 / radius-30 injection, against the golden PSF and the
    float64 CPU injection."""
    import vip_tpu_torch
    import vip_tpu_torch.psfsub as tps
    from vip_tpu_torch.fm import cube_inject_companions, normalize_psf
    from vip_tpu_torch.metrics import detection

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
    meta = np.load(os.path.join(golden, "meta.npz"))
    cube32 = np.load(os.path.join(golden, "inputs.npz"))["cube"] \
        .astype(np.float32)
    fwhm = float(meta["fwhm"])
    frames = {}
    errs = _f2_frames(fwhm, meta["angles"], golden,
                      torch.as_tensor(cube32, device=DEVICE), frames)
    vip_tpu_torch.set_device("cpu")
    try:
        errs_cpu = _f2_frames(fwhm, meta["angles"], golden,
                              torch.as_tensor(cube32))
    finally:
        vip_tpu_torch.set_device(DEVICE)
    for name, frame in frames.items():
        _require(np.isfinite(frame).all(), f"F2 {name}: not finite")
        bound = max(F2_RATIO * errs_cpu[name], F2_FLOOR)
        _require(errs[name] <= bound,
                 f"F2 {name}: {errs[name]:.3e} from the golden on the card, "
                 f"over {bound:.3e} (the CPU's float32 {errs_cpu[name]:.3e})")
        found = np.load(os.path.join(golden, f"{name}_detect.npy"))
        ys, xs = detection(frame, fwhm=fwhm, mode="lpeaks", bkg_sigma=5,
                           matched_filter=False, mask=True, snr_thresh=2,
                           plot=False, verbose=False)
        for c in (tuple(meta["planet_yx"]), tuple(meta["injected_yx"])):
            if any(abs(y - c[0]) <= 3 and abs(x - c[1]) <= 3
                   for y, x in found):
                _require(_near(ys, xs, (c[1], c[0])),
                         f"F2 {name}: the companion at {c} was missed")
    psfn, _, fit_fwhm = normalize_psf(_moffat_psf(), fwhm="fit", size=20,
                                      force_odd=False, full_output=True,
                                      verbose=False)
    zeros = np.zeros((meta["angles"].shape[0], 101, 101))
    kw = dict(flevel=300.0, rad_dists=30.0, verbose=False)
    inj = cube_inject_companions(zeros, psfn, meta["angles"], **kw)
    vip_tpu_torch.set_device("cpu")
    try:
        inj64 = cube_inject_companions(zeros, psfn, meta["angles"], **kw)
    finally:
        vip_tpu_torch.set_device(DEVICE)
    print("F2 float32 vs the float64 goldens, max abs err on the card "
          "(on the CPU, ratio): " + ", ".join(
              f"{k} {v:.3e} ({errs_cpu[k]:.3e}, {v / errs_cpu[k]:.2f}x)"
              for k, v in errs.items())
          + f"; normalize_psf vs golden PSF "
          f"{float(np.abs(psfn - meta['psfn']).max()):.3e}, FWHM "
          f"{abs(float(fit_fwhm) - float(meta['fwhm'])):.3e}; injection "
          f"(flux 300, r 30) vs CPU float64 "
          f"{float(np.abs(inj - inj64).max()):.3e}; detection oracle "
          f"passed", flush=True)
    return errs


@contextlib.contextmanager
def _svd_routine(routine):
    """Every ``torch.linalg.svd`` of a CUDA tensor inside the block takes
    the cuSOLVER ``routine`` ("gesvd", "gesvdj", "gesvda"); None leaves
    PyTorch's choice."""
    svd = torch.linalg.svd

    def forced(A, full_matrices=True, *, driver=None, out=None):
        if A.is_cuda and forced.routine is not None:
            driver = forced.routine
        return svd(A, full_matrices=full_matrices, driver=driver)

    forced.routine = routine
    torch.linalg.svd = forced
    try:
        yield
    finally:
        torch.linalg.svd = svd


def _subspace_err(V, V_ref):
    """Largest norm of a (normalized) row of ``V`` outside the row space
    of the orthonormal ``V_ref``: the sine of its angle to that space,
    free of signs and rotations within the space."""
    Vd = V.detach().double().cpu()
    Vd = Vd / Vd.norm(dim=1, keepdim=True)
    Vr = V_ref.detach().double().cpu()
    return float((Vd - (Vd @ Vr.T) @ Vr).norm(dim=1).max())


def f2_bisect():
    """F2 step by step: ``pca(svd_mode="lapack")`` of the golden replica
    (61x101x101, ncomp 1) in float32 on the card and on the CPU from the
    same float32 inputs, each intermediate against the float64 CPU chain:
    the prepared matrix, the top-k basis (as a subspace), the residuals,
    the derotation and the collapse, each step fed the float64 chain's
    input cast to float32 so that it is measured alone; the card's SVD of
    the QR factor R under each cuSOLVER routine; and the four F2 frames
    under each routine. One line per step."""
    import vip_tpu_torch
    import vip_tpu_torch.psfsub as tps
    from vip_tpu_torch.ops.linalg import svd_top
    from vip_tpu_torch.preproc.derotation import cube_derotate
    from vip_tpu_torch.preproc.subsampling import cube_collapse
    from vip_tpu_torch.var.shapes import prepare_matrix

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
    meta = np.load(os.path.join(golden, "meta.npz"))
    cube32 = np.load(os.path.join(golden, "inputs.npz"))["cube"] \
        .astype(np.float32)
    angles = meta["angles"]
    n, y, x = cube32.shape
    ref_frame = np.load(os.path.join(golden, "pca_adi.npy"))

    def err(a, b):
        a = a.detach().double().cpu() if isinstance(a, torch.Tensor) else \
            torch.as_tensor(np.asarray(a, np.float64))
        b = b.detach().double().cpu() if isinstance(b, torch.Tensor) else \
            torch.as_tensor(np.asarray(b, np.float64))
        return float((a - b).abs().max())

    vip_tpu_torch.set_device("cpu")
    c64 = torch.as_tensor(cube32, dtype=torch.float64)
    M64 = prepare_matrix(c64, None, None, mode="fullfr", verbose=False)
    V64 = svd_top(M64, 1, "lapack")
    R64 = (M64 - (M64 @ V64.T) @ V64).reshape(n, y, x)
    D64 = cube_derotate(R64, angles)
    F64 = cube_collapse(D64, "median")
    print(f"F2 bisect: float64 chain on the CPU vs golden "
          f"{err(F64, ref_frame):.3e}; top singular value "
          f"{float(torch.linalg.svdvals(M64)[0]):.6e}", flush=True)
    rows = {}
    for dev in ("cpu", DEVICE):
        vip_tpu_torch.set_device(dev)
        c = torch.as_tensor(cube32, device=dev)
        M = prepare_matrix(c, None, None, mode="fullfr", verbose=False)
        V = svd_top(M, 1, "lapack")
        R = (M - (M @ V.T) @ V).reshape(n, y, x)
        V64c = V64.to(dev, torch.float32)
        R_own64 = (M - (M @ V64c.T) @ V64c).reshape(n, y, x)
        D = cube_derotate(R64.to(dev, torch.float32), angles)
        F = cube_collapse(D64.to(dev, torch.float32), "median")
        frame = tps.pca(cube=c, angle_list=angles, fwhm=float(meta["fwhm"]),
                        svd_mode="lapack", verbose=False)
        rows[dev] = dict(matrix=err(M, M64), basis=_subspace_err(V, V64),
                         residuals=err(R, R64),
                         residuals_f64_basis=err(R_own64, R64),
                         derotated=err(D, D64), collapsed=err(F, F64),
                         frame_vs_f64=err(frame, F64),
                         frame_vs_golden=err(frame, ref_frame))
        print(f"F2 bisect {dev} float32: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rows[dev].items()), flush=True)
    vip_tpu_torch.set_device(DEVICE)
    M = prepare_matrix(torch.as_tensor(cube32, device=DEVICE), None, None,
                       mode="fullfr", verbose=False)
    Q, R = torch.linalg.qr(M.T)
    Q64, R_64 = torch.linalg.qr(M64.T)
    line = []
    for routine in (None, "gesvd", "gesvdj", "gesvda"):
        Ur = torch.linalg.svd(R, full_matrices=False, driver=routine)[0]
        V = (Q @ Ur)[:, :1].T
        Vn = torch.linalg.svd(M.T, full_matrices=False, driver=routine)[0]
        line.append(f"{routine or 'default'}: R-factor SVD "
                    f"{_subspace_err(V, V64):.3e}, no-QR SVD "
                    f"{_subspace_err(Vn[:, :1].T, V64):.3e}")
    Ur_cpu = torch.linalg.svd(R.cpu(), full_matrices=False)[0]
    line.append(f"R factor's SVD on the CPU: "
                f"{_subspace_err((Q.cpu() @ Ur_cpu)[:, :1].T, V64):.3e}")
    e, EV = torch.linalg.eigh(M @ M.T)
    line.append(f"Gram eigh: "
                f"{_subspace_err((EV[:, -1:].T @ M), V64):.3e}")
    line.append(f"QR factor R vs float64 {err(R.abs(), R_64.abs()):.3e} "
                f"of {float(R_64.abs().max()):.3e}")
    print("F2 bisect, the card's top-1 basis (sine of the angle to the "
          "float64 basis) by SVD routine: " + "; ".join(line), flush=True)
    for routine in ("gesvd", "gesvdj"):
        with _svd_routine(routine):
            errs = _f2_frames(float(meta["fwhm"]), angles, golden,
                              torch.as_tensor(cube32, device=DEVICE))
        print(f"F2 frames on the card, SVD routine {routine}: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
              flush=True)
    # the cost of the fix: the lapack PCA at full size, before (gesvdj) and
    # after (gesvd), in the order before, after, after, before
    rng = np.random.default_rng(0)
    cube = torch.as_tensor(rng.standard_normal((N_FRAMES, SIZE, SIZE))
                           .astype(np.float32), device=DEVICE)
    ang = np.linspace(0.0, 80.0, N_FRAMES)

    def run():
        return tps.pca(cube, ang, ncomp=NCOMP, svd_mode="lapack",
                       verbose=False)

    times = {"gesvdj": [], "gesvd": []}
    for routine in ("gesvdj", "gesvd", "gesvd", "gesvdj"):
        with _svd_routine(routine):
            times[routine] += _sync_times(run, reps=2)
    print(f"F2 fix cost: pca(svd_mode='lapack', ncomp={NCOMP}) "
          f"{N_FRAMES}x{SIZE}x{SIZE}, warm, seconds: " + "; ".join(
              f"{k} {_spread(v)}" for k, v in times.items()), flush=True)


def _f2_frames(fwhm, angles, golden, cube, frames=None):
    """Max abs error of each F2 configuration's frame against its golden
    (the float64 frames into ``frames`` when given)."""
    import vip_tpu_torch.psfsub as tps

    errs = {}
    for name, fn, kwargs in F2_CONFIGS:
        frame = getattr(tps, fn)(cube=cube, angle_list=angles, fwhm=fwhm,
                                 verbose=False, **kwargs)
        frame = frame.cpu().double().numpy() \
            if isinstance(frame, torch.Tensor) else np.asarray(frame, float)
        errs[name] = float(np.abs(
            frame - np.load(os.path.join(golden, f"{name}.npy"))).max())
        if frames is not None:
            frames[name] = frame
    return errs


def svd_costs(reps=3):
    """CUDA-event times (ms, median of ``reps``) of the dense
    factorizations the slice-4 paths call, at their shapes on the
    1000x512x512 cube: the top-k SVD of an (n, p) segment or frame matrix
    by cuSOLVER's gesvd (the port's routine since F2) and gesvdj
    (PyTorch's default), through the (n, n) R factor of a QR where p >
    4n; the eigh of the (n, n) Gram; and a batch of 200 (200, 200)
    masked Grams by eigh (one cuSOLVER call a matrix), LOCI's segment."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    out = {}

    def ms(fn):
        times = []
        for _ in range(reps + 1):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return float(np.median(times[1:]))

    for n, p in ((1000, 3200), (1000, 262144), (200, 3200)):
        M = torch.randn((n, p), generator=gen, device=DEVICE)
        A = torch.linalg.qr(M.T)[1] if p > 4 * n else M.T
        for drv in ("gesvd", "gesvdj"):
            out[f"svd {drv} ({n}, {p})"] = ms(
                lambda: torch.linalg.svd(A, full_matrices=False, driver=drv))
        out[f"QR of ({p}, {n})"] = ms(lambda: torch.linalg.qr(M.T))
        out[f"eigh Gram ({n}, {p})"] = ms(
            lambda: torch.linalg.eigh(M @ M.T))
        del M, A
    B = torch.randn((200, 200, 200), generator=gen, device=DEVICE)
    B = B @ B.transpose(-1, -2)
    out["eigh batch (200, 200, 200)"] = ms(lambda: torch.linalg.eigh(B))
    L = torch.randn((1000, 208, 1500), generator=gen, device=DEVICE)
    G = L @ L.transpose(-1, -2)
    out["eigh batch (1000, 208, 208)"] = ms(lambda: torch.linalg.eigh(G),)
    out["svd gesvd batch (100, 1500, 208)"] = ms(
        lambda: torch.linalg.svd(L[:100].transpose(-1, -2),
                                 full_matrices=False, driver="gesvd"))
    del B, L, G
    # NEGFC: the batched top-1 SVD of a half-step's walkers (50 annulus
    # matrices of the 200-frame cut) and of 16 at full depth
    from vip_tpu_torch.ops.linalg import svd_top

    for W, n in ((1, 200), (50, 200), (1, 1000), (16, 1000)):
        M = torch.randn((W, n, 3000), generator=gen, device=DEVICE)
        out[f"svd_top lapack batch ({W}, {n}, 3000)"] = ms(
            lambda: svd_top(M, 1, "lapack"))
        del M
    return out


def _profile_table(fn, rows=15):
    """torch.profiler over one call of ``fn``: wall seconds and the top
    rows by device self time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=rows, max_name_column_width=48)
    return wall, table


def _h2_split(frames, angles, geom, reps=3):
    """H2 on one chunk, each step timed apart with CUDA events (median of
    ``reps`` warm runs, ms): the wrapper's set-up (quadrants and shear
    coefficients), the x-shear of the occupied rows (row kernel, reading
    the frames' rot90 in place), the y-shear of every column (column
    kernel), the x-shear of the crop rows (row kernel). The launches are
    those of ``rotate_fft_exact_fused``."""
    from vip_tpu_torch.ops import shear

    N, py0, px0, cy0, cy1, cx0, cx1 = geom
    B, y = frames.shape[0], frames.shape[-1]
    R1, R2, W3 = y + 1, cy1 - cy0, cx1 - cx0
    dev = frames.device
    s1 = torch.empty((B, R1, N), dtype=torch.complex64, device=dev)
    s2 = torch.empty((B, R2, N), dtype=torch.complex64, device=dev)
    out = torch.empty((B, R2, W3), dtype=torch.float32, device=dev)
    got = {}

    def setup():
        got["s"] = shear._exact_setup(frames, angles, N, "H2 split")

    def x1():
        lib, a, _, tables, k = got["s"]
        shear._shear(lib, frames, s1, a, tables, R1, N, py0, (y * y, y, 1),
                     y, px0, (R1 * N, N, 1), N, 0, "H2 split", quad=k)

    def yy():
        lib, _, b, tables, _ = got["s"]
        shear._shear(lib, s1, s2, b, tables, N, N, 0, (R1 * N, 1, N), R1,
                     py0, (R2 * N, 1, N), R2, cy0, "H2 split")

    def x3():
        lib, a, _, tables, _ = got["s"]
        shear._shear(lib, s2, out, a, tables, R2, N, cy0, (R2 * N, N, 1), N,
                     0, (R2 * W3, W3, 1), W3, cx0, "H2 split")

    steps = (("set-up", setup), ("x-shear rows", x1),
             ("y-shear columns", yy), ("x-shear crop rows", x3))
    times = {name: [] for name, _ in steps}
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        ev[0].record()
        for i, (_, fn) in enumerate(steps):
            fn()
            ev[i + 1].record()
        torch.cuda.synchronize()
        for i, (name, _) in enumerate(steps):
            times[name].append(ev[i].elapsed_time(ev[i + 1]))
    return {k: float(np.median(v[1:])) for k, v in times.items()}


def _h4_split(frames, angles, geom=None, G=None, reps=3):
    """H4 on one chunk, its steps timed apart (median of ``reps`` warm
    runs, ms): the wrapper's set-up (quadrants and shear coefficients) and
    the launch (scratch allocation and the cooperative kernel), with CUDA
    events; inside the kernel its three stages, by block 0's %globaltimer
    stamps at the start and after each grid barrier, summed over the
    groups. Exact with ``geom`` (frames y², rows y + 1 .. crop), else
    small (N² canvases); G frames a group (None: the wrapper's own).
    Returns (frames a group, [set-up, launch, stage 1, stage 2, stage
    3])."""
    from vip_tpu_torch.ops import shear

    B, y = frames.shape[0], frames.shape[-1]
    if geom is not None:
        N, py0, px0, cy0, cy1, cx0, cx1 = geom
        R1, R2, W3 = y + 1, cy1 - cy0, cx1 - cx0
    else:
        N, py0, px0, cy0, cx0 = y, 0, 0, 0, 0
        R1 = R2 = W3 = N

    def setup():
        if geom is not None:
            return shear._exact_setup(frames, angles, N, "H4 split")
        return shear._small_setup(frames, angles, "H4 split")

    G = shear._fused3_group(B, R1 * N * 8) if G is None else G
    groups = -(-B // G)
    stamps = torch.zeros(1 + 3 * groups, dtype=torch.int64,
                         device=frames.device)
    out = torch.empty((B, R2, W3), dtype=torch.float32, device=frames.device)
    runs = []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        lib, a, b, tables, k = setup()
        ev[1].record()
        shear._fused3(lib, frames, k, out, a, b, tables, N, R1, py0, px0, R2,
                      cy0, W3, cx0, "H4 split", stamps=stamps, G=G)
        ev[2].record()
        torch.cuda.synchronize()
        ns = stamps.cpu().numpy().astype(np.int64)
        runs.append([ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])]
                    + (np.diff(ns).reshape(groups, 3).sum(0) / 1e6).tolist())
    return G, np.median(np.array(runs[1:]), axis=0).tolist()


def _cufft_lines_ms(lines, N):
    """The yardstick of the FFT work alone on a library: one
    ``torch.fft.fft`` then one ``torch.fft.ifft`` (cuFFT) over ``lines``
    complex64 lines of N points, CUDA events, median of 3 warm runs (ms).
    Used nowhere in the port."""
    z = torch.randn((lines, N), dtype=torch.complex64, device=DEVICE)

    def run():
        return torch.fft.ifft(torch.fft.fft(z, dim=1), dim=1)

    run()
    times = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    del z
    return float(np.median(times))


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()

    rng = np.random.default_rng(0)
    cube_np = rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32)
    angles_np = np.linspace(0.0, 80.0, N_FRAMES).astype(np.float32)
    cube = torch.as_tensor(cube_np, device=DEVICE)
    del cube_np

    h1_err, cube_bisect = phase_median(cube)
    (frames, rot_angles, geom, frames160, angles160, geom160,
     h2_err) = phase_rotation()
    canvas, small_angles, h3_err = phase_small_rotation()
    h4_err, h4s_err = phase_fused3(frames, rot_angles, geom, frames160,
                                   angles160, geom160, canvas, small_angles)
    counts, run_kernel, run_plain = phase_main_path(cube, angles_np)
    run_small = phase_small_pipeline(cube, angles_np)
    h4s_counts, run_small3 = phase_small_pipeline_fused3(run_small)
    ann_counts, run_annular = phase_annular(cube, angles_np)
    phase_small_reference()
    phase_small_annular_reference()
    pcube, src = _plant_companion(cube, angles_np)
    h4_counts, search_runs, ms_frame = phase_companion_search(
        pcube, angles_np, src)
    t_ann_ms = phase_annular_median(pcube, angles_np, src)
    phase_small_companion_reference()
    with tempfile.TemporaryDirectory() as tmpdir:
        inc_counts, inc_runs = phase_incremental(cube, angles_np, tmpdir)
        t_inc = {k: _sync_times(fn, reps=3 if k == "cache on" else 1)
                 for k, fn in inc_runs.items()}
    cc_counts, cc_cols, run_cc, psfn = phase_contrast(cube, angles_np)
    compl_counts, t_compl = phase_completeness(cube, angles_np, psfn,
                                               cc_cols)
    stim_counts, run_stim = phase_stim(pcube, angles_np, src)
    phase_f2()
    slice4 = phase_slice4(pcube, angles_np, src)
    negfc_counts, negfc_times = phase_negfc(pcube, angles_np, src)
    invprob_counts, invprob_times = phase_invprob(pcube, angles_np)
    new_paths = {"incremental": inc_counts, "contrast": cc_counts,
                 "completeness": compl_counts, "stim": stim_counts}
    new_paths.update({k: v[0] for k, v in slice4.items()})
    new_paths.update(negfc_counts)
    new_paths.update(invprob_counts)

    from vip_tpu_torch.metrics import snrmap, snrmap_fast
    from vip_tpu_torch.ops.fft import (rotate_fft_exact_pruned,
                                       rotate_fft_fast_batch,
                                       rotate_fft_small_plain)
    from vip_tpu_torch.ops.median import (median_config, nanmedian_axis0,
                                          nanmedian_plain)
    from vip_tpu_torch.ops.shear import (fused3_config,
                                         rotate_fft_exact_fused,
                                         rotate_fft_exact_fused3,
                                         rotate_fft_small_fused,
                                         rotate_fft_small_fused3)

    cube999 = cube[:N_FRAMES - 1].contiguous()
    t_h1 = _sync_time(lambda: nanmedian_axis0(cube))
    t_h1p = _sync_time(lambda: nanmedian_plain(cube, 0))
    t_h1o = _sync_time(lambda: nanmedian_axis0(cube999))
    t_h1lib = _sync_time(lambda: torch.nanmedian(cube999, dim=0))
    t_h1b = _sync_time(lambda: nanmedian_axis0(cube_bisect))
    t_h1bp = _sync_time(lambda: nanmedian_plain(cube_bisect, 0))
    del cube_bisect
    t_h4 = _sync_time(lambda: rotate_fft_exact_fused3(frames, rot_angles,
                                                      *geom))
    t_h2 = _sync_time(lambda: rotate_fft_exact_fused(frames, rot_angles,
                                                     *geom))
    t_h2p = _sync_time(lambda: rotate_fft_exact_pruned(frames, rot_angles,
                                                       *geom))
    t_h4b = _sync_time(lambda: rotate_fft_exact_fused3(frames, rot_angles,
                                                       *geom))
    t_h4m = _sync_time(lambda: rotate_fft_exact_fused3(frames160, angles160,
                                                       *geom160))
    t_h2m = _sync_time(lambda: rotate_fft_exact_fused(frames160, angles160,
                                                      *geom160))
    t_h2mp = _sync_time(lambda: rotate_fft_exact_pruned(frames160, angles160,
                                                        *geom160))
    m0 = (canvas.shape[-1] - SIZE) // 2
    t_h4s = _sync_time(lambda: rotate_fft_small_fused3(canvas, small_angles))
    t_h3 = _sync_time(lambda: rotate_fft_small_fused(canvas, small_angles))
    t_h3p = _sync_time(lambda: rotate_fft_small_plain(canvas, small_angles))
    t_h3k = _sync_time(lambda: rotate_fft_fast_batch(
        canvas, small_angles, support_rows=(m0, SIZE + 1)))
    # H4's stages apart, with its default group (a whole chunk) and with
    # a group whose scratch fits the L2 cache; the launch configurations of
    # the kernels redesigned last
    h4_split = {}
    for g_ex, g_sm in ((None, None), L2_GROUPS):
        h4_split[g_ex] = (_h4_split(frames, rot_angles, geom, G=g_ex),
                          _h4_split(canvas, small_angles, G=g_sm))
    configs = {"H4 N=2048": fused3_config(geom[0]),
               "H4 N=640": fused3_config(canvas.shape[-1]),
               f"H1 n={N_FRAMES}": median_config(N_FRAMES)}

    t_e2e_runs = _sync_times(run_kernel)
    with _env("VIP_EXACT_SHEAR", "fused3"):
        t_e2e4_runs = _sync_times(run_kernel)
    t_e2e = float(np.median(t_e2e_runs))
    t_e2ep = _sync_time(run_plain)

    def run_packed():
        with _env("VIP_SMALL_SHEAR", "packed"):
            return run_small()

    t_small_runs = _sync_times(run_small)
    t_packed = _sync_time(run_packed)
    t_small3_runs = _sync_times(run_small3)
    t_small2_runs = _sync_times(run_small)
    t_search = {}
    for route, (medsub, grid, mode) in search_runs.items():
        with _env("VIP_EXACT_SHEAR", mode):
            t_search[route] = (_sync_times(medsub), _sync_times(grid))
    t_snr = _sync_time(lambda: snrmap(ms_frame, COMP_FWHM, verbose=False))
    t_snrf = _sync_time(lambda: snrmap_fast(ms_frame, COMP_FWHM))
    t_cc_runs = _sync_times(run_cc)
    t_stim = _sync_time(run_stim)
    t_ann = _sync_time(run_annular, reps=2)
    prof_wall, table = _profile_table(run_annular)
    with _env("VIP_EXACT_SHEAR", "auto"):
        ms_wall, ms_table = _profile_table(search_runs["H2"][0], rows=10)
    split = _h2_split(frames, rot_angles, geom)
    n_lines = CHUNK * (SIZE + 1 + geom[0] + geom[4] - geom[3])
    t_fft2 = _cufft_lines_ms(n_lines, geom[0])
    n_lines3 = SMALL_CHUNK * 3 * canvas.shape[-1]
    t_fft3 = _cufft_lines_ms(n_lines3, canvas.shape[-1])

    print(f"timing H1 median {N_FRAMES}x{SIZE}x{SIZE}: kernel "
          f"{t_h1 * 1e3:.3f} ms, plain {t_h1p * 1e3:.3f} ms; at "
          f"{N_FRAMES - 1} frames kernel {t_h1o * 1e3:.3f} ms, "
          f"torch.nanmedian {t_h1lib * 1e3:.3f} ms; at {BISECT_FRAMES} "
          f"frames (bisection body) kernel {t_h1b * 1e3:.3f} ms, plain "
          f"{t_h1bp * 1e3:.3f} ms", flush=True)
    print(f"timing exact rotation {CHUNK}x{SIZE}^2 (N=2048): H4 "
          f"{t_h4 * 1e3:.3f} ms, H2 {t_h2 * 1e3:.3f} ms "
          f"({CHUNK / t_h2:.1f} frames/s), plain {t_h2p * 1e3:.3f} ms "
          f"({CHUNK / t_h2p:.1f} frames/s), H4 again {t_h4b * 1e3:.3f} ms",
          flush=True)
    print(f"timing exact rotation {SMALL_CHUNK}x160^2 (N=640): H4 "
          f"{t_h4m * 1e3:.3f} ms, H2 {t_h2m * 1e3:.3f} ms, plain "
          f"{t_h2mp * 1e3:.3f} ms", flush=True)
    print(f"timing small rotation {SMALL_CHUNK}x{SIZE}^2 on 640^2: H4 "
          f"{t_h4s * 1e3:.3f} ms, H3 {t_h3 * 1e3:.3f} ms "
          f"({SMALL_CHUNK / t_h3:.1f} frames/s), plain {t_h3p * 1e3:.3f} ms, "
          f"packed torch.fft path {t_h3k * 1e3:.3f} ms "
          f"({SMALL_CHUNK / t_h3k:.1f} frames/s)", flush=True)
    for G, ((g_ex, st_ex), (g_sm, st_sm)) in h4_split.items():
        print(f"timing H4 by step (median of 3, ms: set-up and launch by "
              f"CUDA events; x-shear rows, y-shear columns, x-shear crop "
              f"rows inside the kernel by globaltimer stamps), "
              f"{'default' if G is None else 'L2-sized'} groups: exact "
              f"{CHUNK}x{SIZE}^2, {g_ex} frames a group: "
              + ", ".join(f"{v:.3f}" for v in st_ex)
              + f" (stages {sum(st_ex[2:]):.3f}); small {SMALL_CHUNK} on "
              f"{canvas.shape[-1]}^2, {g_sm} a group: "
              + ", ".join(f"{v:.3f}" for v in st_sm)
              + f" (stages {sum(st_sm[2:]):.3f})", flush=True)
    print("launch configuration: " + "; ".join(
        f"{k} " + ", ".join(f"{kk} {vv}" for kk, vv in v.items())
        for k, v in configs.items()), flush=True)
    print(f"timing pca_adi_pipeline {N_FRAMES}x{SIZE}x{SIZE} rot_mode=fft "
          f"(median [min, max] of 3): H2 {_spread(t_e2e_runs)} s, H4 "
          f"(VIP_EXACT_SHEAR=fused3) {_spread(t_e2e4_runs)} s, plain path "
          f"{t_e2ep:.4f} s", flush=True)
    print(f"timing pca_adi_pipeline {N_FRAMES}x{SIZE}x{SIZE} "
          f"rot_mode=fft-small chunk {SMALL_CHUNK} (median [min, max] of 3): "
          f"H3 {_spread(t_small_runs)} s, packed {t_packed:.4f} s, H4 "
          f"{_spread(t_small3_runs)} s, H3 again {_spread(t_small2_runs)} s",
          flush=True)
    for route, (t_ms, t_grid) in t_search.items():
        print(f"timing companion search {N_FRAMES}x{SIZE}x{SIZE} ({route} "
              f"route; median [min, max] of 3): median_sub {_spread(t_ms)} s,"
              f" pca_grid ncomp {GRID_PCS[0]}..{GRID_PCS[1]} "
              f"{_spread(t_grid)} s", flush=True)
    print(f"timing median_sub annular {N_FRAMES}x{SIZE}x{SIZE}: "
          f"{t_ann_ms:.4f} s (once); snrmap {SIZE}^2 {t_snr:.4f} s, "
          f"snrmap_fast {t_snrf:.4f} s", flush=True)
    print(f"timing pca_incremental {N_FRAMES}x{SIZE}x{SIZE} from FITS, "
          f"batch {INC_BATCH} (warm): " + ", ".join(
              f"{k} {_spread(v)} s" for k, v in t_inc.items())
          + f"; contrast curve (3 patterns + empty) {_spread(t_cc_runs)} s;"
          f" completeness (2 radii, once) {t_compl:.4f} s; "
          f"normalized_stim_map {t_stim:.4f} s", flush=True)
    print("launches on the new paths: " + "; ".join(
        f"{k} {v}" for k, v in new_paths.items()), flush=True)
    print("timing slice 4 (s; see the phase 15 lines): " + ", ".join(
        f"{k} {v[1]:.4f}" for k, v in slice4.items()), flush=True)
    print("timing NEGFC (s; see the phase 16 lines): " + ", ".join(
        f"{k} {v:.4f}" for k, v in negfc_times.items()), flush=True)
    print("timing slice 6 (s; see the phase 17 lines): " + ", ".join(
        f"{k} {v:.4f}" for k, v in invprob_times.items()), flush=True)
    print(f"timing pca_annular {N_FRAMES}x{SIZE}x{SIZE} vip-fft-small "
          f"(ncomp 10, fwhm 4, asize 4): {t_ann:.4f} s; under the profiler "
          f"{prof_wall:.4f} s; top ops by device time:\n{table}", flush=True)
    print(f"timing H2 {CHUNK}x{SIZE}^2 by launch (CUDA events, median of "
          f"3): " + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()),
          flush=True)
    print(f"yardstick cuFFT torch.fft.fft + ifft: {n_lines} lines of "
          f"{geom[0]} (one H2 chunk) {t_fft2:.3f} ms; {n_lines3} lines of "
          f"{canvas.shape[-1]} (one H3 chunk) {t_fft3:.3f} ms", flush=True)
    print(f"profile median_sub {N_FRAMES}x{SIZE}x{SIZE}, H2 route: "
          f"{ms_wall:.4f} s under the profiler; top ops by device time:\n"
          f"{ms_table}", flush=True)

    def exact_work(n, y, g):
        """Bytes and float32 operations of the exact rotation of n frames
        of y²: y + 1 slab rows, N columns and the crop rows are sheared."""
        N, R2, W3 = g[0], g[4] - g[3], g[6] - g[5]
        return (n * (y * y + R2 * W3) * 4,
                _shear_flop(n * (y + 1 + N + R2), N))

    N3 = canvas.shape[-1]
    work = {
        # the median: each input read once, the frame written once; about
        # one comparison per input value
        "H1": ((N_FRAMES + 1) * SIZE * SIZE * 4, N_FRAMES * SIZE * SIZE),
        "H2/H4 exact 512^2": exact_work(CHUNK, SIZE, geom),
        "H2/H4 exact 160^2": exact_work(SMALL_CHUNK, 160, geom160),
        "H3/H4 small 640^2": (SMALL_CHUNK * N3 * N3 * 4 * 2,
                              _shear_flop(SMALL_CHUNK * 3 * N3, N3)),
    }
    bounds = {k: _bound(*v) for k, v in work.items()}
    print("bounds: " + "; ".join(
        f"{k} {v[0] / 1e9:.4f} GB, {v[1] / 1e9:.4f} Gflop -> "
        f"{bounds[k][0]:.4f} ms ({bounds[k][1]})" for k, v in work.items()),
        flush=True)
    h1_bound = bounds["H1"]
    exact_bound = bounds["H2/H4 exact 512^2"]
    small_bound = bounds["H3/H4 small 640^2"]

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound,
              library_ms=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library_ms}

    def on_new_paths(kernel):
        return {k: v[kernel] for k, v in new_paths.items()}

    kernels = [
        dict(entry("nanmedian_axis0", "vip_tpu_torch/csrc/nanmedian.cu",
                   "vip_tpu/ops/pallas_median.py:104", counts["H1"], h1_err,
                   t_h1 * 1e3, t_h1p * 1e3, h1_bound, t_h1lib * 1e3),
             bisection_frames=BISECT_FRAMES, bisection_ms=t_h1b * 1e3,
             bisection_plain_ms=t_h1bp * 1e3,
             launches_new_paths=on_new_paths("H1")),
        dict(entry("rotate_fft_exact_fused", "vip_tpu_torch/csrc/fft_shear.cu",
                   "vip_tpu/ops/pallas_shear.py:550", counts["H2"], h2_err,
                   t_h2 * 1e3, t_h2p * 1e3, exact_bound),
             cufft_lines_ms=t_fft2, launches_new_paths=on_new_paths("H2")),
        dict(entry("rotate_fft_small_fused", "vip_tpu_torch/csrc/fft_shear.cu",
                   "vip_tpu/ops/pallas_shear.py:918", ann_counts["H3"],
                   h3_err, t_h3 * 1e3, t_h3p * 1e3, small_bound),
             cufft_lines_ms=t_fft3),
        entry("rotate_fft_exact_fused3", "vip_tpu_torch/csrc/fft_shear3.cu",
              "vip_tpu/ops/pallas_shear.py:845", h4_counts["H4"], h4_err,
              t_h4 * 1e3, t_h2p * 1e3, exact_bound),
        entry("rotate_fft_small_fused3", "vip_tpu_torch/csrc/fft_shear3.cu",
              "vip_tpu/ops/pallas_shear.py:890", h4s_counts["H4"], h4s_err,
              t_h4s * 1e3, t_h3p * 1e3, small_bound),
    ]
    print(f"wall time of chip_smoke.py: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def negfc_only():
    """Phase 16 alone (``--negfc``): the build, the cube with the planted
    companion, NEGFC."""
    phase_device()
    phase_build()
    rng = np.random.default_rng(0)
    cube = torch.as_tensor(
        rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    angles_np = np.linspace(0.0, 80.0, N_FRAMES).astype(np.float32)
    pcube, src = _plant_companion(cube, angles_np)
    del cube
    counts, times = phase_negfc(pcube, angles_np, src, profile=True)
    print("launches: " + "; ".join(f"{k} {v}" for k, v in counts.items()),
          flush=True)


def invprob_only():
    """Phase 17 alone (``--invprob``): the build, the cube with the planted
    companion, slice 6, with a torch.profiler table of one FMMF
    annulus."""
    phase_device()
    phase_build()
    rng = np.random.default_rng(0)
    cube = torch.as_tensor(
        rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    angles_np = np.linspace(0.0, 80.0, N_FRAMES).astype(np.float32)
    pcube, _ = _plant_companion(cube, angles_np)
    del cube
    counts, _ = phase_invprob(pcube, angles_np, profile=True)
    print("launches: " + "; ".join(f"{k} {v}" for k, v in counts.items()),
          flush=True)


def kernel_digests(root):
    """SHA-256 (first 16 hex digits) of the outputs of H1 (both propagate
    modes), H2 (512² and 160²) and H3 on the inputs of phases 3-5, with the
    port of the checkout at ``root``: this checkout or a tree under its
    ``chip_archive/``."""
    import hashlib

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.realpath(root)
    archive = os.path.join(os.path.realpath(here), "chip_archive")
    _require(root == os.path.realpath(here)
             or os.path.commonpath([root, archive]) == archive,
             f"--digests: {root} is neither this checkout nor under "
             f"{archive}")
    sys.path.insert(0, root)
    import vip_tpu_torch
    from vip_tpu_torch.ops.median import nanmedian_axis0
    from vip_tpu_torch.ops.shear import (rotate_fft_exact_fused,
                                         rotate_fft_small_fused)

    vip_tpu_torch.set_device(DEVICE)
    rng = np.random.default_rng(0)
    cube = torch.as_tensor(
        rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    (frames, angles, geom, frames160, angles160, geom160,
     _) = phase_rotation()
    canvas, small_angles, _ = phase_small_rotation()
    outs = {"H1": nanmedian_axis0(cube),
            "H1 propagate": nanmedian_axis0(cube, propagate=True),
            "H2 512^2": rotate_fft_exact_fused(frames, angles, *geom),
            "H2 160^2": rotate_fft_exact_fused(frames160, angles160,
                                               *geom160),
            "H3 640^2": rotate_fft_small_fused(canvas, small_angles)}
    torch.cuda.synchronize()
    print(json.dumps({"root": root, "digests": {
        k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16]
        for k, v in outs.items()}}))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device")
    if len(sys.argv) == 2 and sys.argv[1] == "--svd":
        print("svd costs (ms, CUDA events): " + "; ".join(
            f"{k} {v:.3f}" for k, v in svd_costs().items()), flush=True)
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--f2":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        phase_build()
        f2_bisect()
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--digests":
        kernel_digests(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--negfc":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        negfc_only()
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--invprob":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        invprob_only()
        sys.exit(0)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
