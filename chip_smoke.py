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
and the MCMC of the planted companion), slice 6 (ANDROMEDA, FMMF,
PACO), slice 7 (the 4-d IFS paths), slice 8a (the bad-pixel filters,
stats, subsampling, cosmetics, ``randomized_svd_gpu``, ``pca(smooth=)``),
slice 8b (registration and recentering, bad-pixel correction,
bad-frame detection), slice 8c (the interpolation imlibs, ``edge_blend``,
``rot_mode="interp"``), slice 9 (the scattered-light disk, its
injection, NEGFD), slice 10 (the object layer, ``EvalRoc``, the
native FITS codec), slice 11 (several devices: the sharded steps on a
one-rank NCCL group, and in 4 gloo ranks sharing the card) and slice 12
(the last public functions of vip_tpu's modules).
Phases, one line each:

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
    run (its kernels by device time) and one ``median_sub`` (its
    operators, H2 route, so that the x- and y-shear kernels show apart);
15. slice 4 on the cube with the planted companion (run before the
    timings of 14, printed with them): ``psfsub.nmf``, ``nmf_annular``,
    ``llsg``, ``frame_diff`` (two configurations), ``xloci``,
    ``roll_sub`` and ``greedy.ipca``, ``inmf``, ``iroll``, each through
    the kernels with its H1/H2 launches, against the plain route, timed,
    and the companion detected on the full-width frames (the cuts are
    printed);
16. slice 5, NEGFC, on every 10th frame of the cube with the planted
    companion (100 x 512²; run before the timings of 14): ``firstguess``
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
    at full width (every 20th frame of the cube with the planted
    companion, its central 256²: each finds the companion, FMMF through
    H2); FMMF through H2 against the plain route; bench.py's three invprob
    legs and FMMF's serial and batched forms timed;
18. slice 7, the 4-d IFS paths (run before the timings of 14), on a
    synthetic SPHERE-IFS sequence (39 channels of 0.95-1.35 µm, 100 even
    288² frames over 40°, a halo and speckles scaling with λ, one
    companion of a flat spectrum at 40 px): ``pca`` single pass (ncomp
    10), double pass (2, 10), per-channel ADI and an ncomp grid with
    ``scale_list``; ``pca_annular`` (1, 2); ``median_sub`` fullfr and
    annular; ``xloci`` double; a contrast curve of the single pass;
    ``FastPACO`` with ``rescaling_factor=2`` on the NACO replica;
    NEGFC's ``firstguess``. Each through the kernels with its H1/H2
    launches against the plain route on the card within 1e-5 of
    max(|ref|, 1); the PCA passes timed warm (median of 3); the single
    and double pass and the 4-d ``median_sub`` find the companion within
    3 px (the cuts are printed);
19. slice 8a (run before the timings of 14) on the full cube, each step
    synchronized with its wall time and its H1/H2 launches:
    ``cube_correct_nan`` of the whole cube with ~0.1% NaN pixels (single
    pixels and 3x3-5x5 clumps made on the card from a seeded
    ``torch.Generator``), its route bit-equal to its dense plain version
    with the same sweep counts, 3 frames within 1 ulp of the host loop;
    ``clip_array`` with 5-px neighbourhoods, with and without the MAD,
    the same indices as its host route; ``cube_subsample`` ('mean',
    'median' in one H1 launch, 'trimmean', with ``parallactic``) every 10
    frames and ``cube_subsample_trimmean``, bit-equal to the plain route;
    ``cube_filter_iuwt`` of 100 frames; ``frame_deconvolution`` (30
    iterations, a 21² PSF) against host scipy in float64;
    ``cube_distance`` with every distance; ``randomized_svd_gpu`` of the
    1000x262144 matrix (the cube plus a decaying rank-10 structure)
    against ``ops.linalg.svd``; ``pca(ncomp=10, smooth=2)`` against
    ``pca`` then ``frame_filter_lowpass``, the companion found within
    3 px; ``approx_stellar_position`` of a 39-channel star cube;
20. slice 8b (run before the timings of 14), each step synchronized with
    its wall time (a warm median of 3 under 1 s) and its H1 launches, each
    batched route against its plain version (the per-frame loop of the
    same functions, the plain median; maps equal, frames within 1e-5 of
    max(|ref|, 1)): on the noise cube with a Moffat star jittered by up to
    1.5 px, ``cube_recenter_dft_upsampling`` (upsample 100, ``subi_size``
    9: one H1 launch, the shifts within 0.05 px of the jitter, the batched
    registration within 0.01 px of the per-frame loop on 20 frames), its
    masked variant on 100 frames, ``cube_recenter_2dfit`` ('gauss' on all
    frames, 'moff' on 100), ``cube_recenter_via_speckles`` (101² crops,
    5 iterations, 5 H1 launches) and once with ``recenter_median`` and the
    annulus fit on 50 frames (its 160,000-point grid timed alone);
    ``cube_recenter_satspots``, ``frame_center_radon`` and
    ``cube_recenter_radon`` on 100 coronagraphic frames with four spots at
    40 px, the Radon column-only cost against the full sinogram row; on
    the cube with hot pixels and clumps, ``cube_fix_badpix_isolated``
    (shared map on all frames, ``frame_by_frame`` on 100),
    ``cube_fix_badpix_clump`` and ``cube_fix_badpix_annuli`` on 100 (recall
    and false positives), ``cube_fix_badpix_interp`` 'fft' on 10 (nit 500;
    float64 on the card against the per-frame loop within 1e-10, equal
    iterations) and 'gauss' on 100, ``cube_fix_badpix_ifs`` on the star
    cube of 19 (one H1 launch); the three bad-frame detectors on 30
    damaged frames (elongated, dimmed, shifted), with their hits.
21. slices 8c and 9 (run before the timings of 14), each step
    synchronized with its wall time and its H1, H2 and H3 launches:
    ``cube_derotate`` of all 1000 frames with 'opencv' (lanczos4, bicubic,
    bilinear, nearneig), 'skimage' biquintic and 'tpu-interp' bicubic,
    each against its per-frame loop and in float32 against float64 on the
    card; ``pca_adi_pipeline(rot_mode="interp")`` (ncomp 10, H1) against
    the plain median; ``cube_shift`` 'opencv' lanczos4 (reflect) of all
    frames, 'ndimage-interp' biquintic of 50 (host scipy);
    ``cube_px_resampling`` 'opencv' at 0.5 and 1.37; ``edge_blend=
    "noise+interp"`` on 50 frames (the blended 2048² canvases through
    H3, held to the plain rotation); a 512² ``ScatteredLightDisk`` (HG,
    float32 against float64), injected into all 1000 frames (H2), one
    ``chisquare_fd`` at full depth (pca ncomp 10, 'vip-fft': H1 and H2)
    and ``firstguess_fd`` ('skimage' / biquintic) on every 10th frame,
    recovering the planted flux within 10%;
22. slice 10 (run before the timings of 14) on the cube with the planted
    companion: the native FITS codec on the whole cube (``write_fits``'s
    data block against the plain encoder's bytes; ``open_fits``, the lazy
    HDU's slices and a decode into pinned memory against the plain
    decode, bit for bit; both encodes and decodes timed); phase 11's
    streamed PCA through the codec and through the plain decode, in
    turns, bit-equal; a ``Dataset`` of the whole cube (no copy) with
    ``PPPCA`` classic and ``PPMedianSub`` (their H1/H2 launches) bit-equal
    to direct calls of ``pca`` and ``median_sub`` and within PIPE_TOL of
    the plain route, ``make_snrmap``, ``compute_significance`` and
    ``Frame.detect_blobs`` at the companion, the sessions through
    ``PPResult``'s FITS file and back; ``PPPCA`` grid (ncomp 1..10),
    annulus and annular (phase 14's annuli), all at full width and
    depth, bit-equal to their direct calls; the six other PP classes on
    phases 15's and 17's cuts, bit-equal to those phases' frames
    (annular NMF, LLSG and LOCI held to direct calls on the same frames;
    NMF, ANDROMEDA and FMMF finding the companion); ``EvalRoc``
    (4 injections on every 10th frame,
    ``PPPCA`` and ``PPMedianSub``) with every injection found at
    threshold 3; one host injection at full depth timed; ``Dataset.save``
    and ``load`` of the first 50 frames, bit-equal, the cube back on the
    card.
23. slice 11, several devices (run before the timings of 14): (a) a
    one-rank NCCL group in this process and, at full width, the sharded
    PCA-ADI (mean, median) and median-ADI against ``pca_adi_pipeline``
    and ``median_adi_pipeline``, the sharded annular PCA on every 10th
    frame against ``pca_annular(svd_mode="eigen")``, the sharded S/N map
    of the median frame against ``snrmap_fast``, ``contrast_curve(pattern_mesh=)`` against phase 12's
    curve, ``pca_incremental(pixel_mesh=)`` of phase 11's FITS batches
    against ``pixel_mesh=None``, ``sharded_pca_sdi_single`` of phase 18's
    sequence against ``pca(adimsdi="single", svd_mode="eigen")``, in
    float32 (H1, H2) and in float64 on every 10th frame, the sharded walker
    likelihood (16 walkers) and 2 steps of ``mcmc_negfc_sampling(
    walker_mesh=)`` on phase 16's cut against the unsharded ones, bit for
    bit; each with its time and its H1/H2 launches; (b) 4 gloo ranks
    spawned on the same card (``vip_tpu_torch.dryrun.run_ranks``), each
    checking that neither jax nor vip_tpu is loaded, every entry point of
    (a) on the first 200 frames (the SDI on 36 channels and 8 frames)
    against the same call at world size 1, the ranks' results equal; the
    float32 PCAs whose last PCs turn with the order of the sums (the SDI
    pass, the streamed PCA) again in float64.
24. slice 12 on the main path's cube, each step's synchronized wall time
    on its own line beside the card's name and power limit:
    ``get_pca_coeffs`` of the 1000x512² cube with phase 7's 10 PCs, and
    VIP's torch rotation ``tensor_rotate_fft`` of a 512² and a 511²
    frame at 0, 30, 60, 135 and 300 degrees, each in float32 within
    PIPE_TOL of max(|ref|, 1) of the same call in float64 on the card;
    ``tree_to_numpy`` of a nested structure of card tensors; the FITS
    codec's ``available()``.
25. K5, the batched one-sided Jacobi SVD of ``ops.linalg.svd``'s route
    for CUDA float32 matrices of sides <= 64, on R factors of tall
    matrices with a decaying spectrum at the double pass's shape (100 of
    39 rows) and the NACO replica's (one of 61): one launch a call, every
    matrix converged, singular values within 1e-6 of the largest and
    top-5 projectors within 1e-4 of its plain version's on the card,
    reconstruction beside gesvd's; the kernel (CUDA events, warm median
    of 10) against its bound, its plain version and the per-matrix gesvd
    loop it replaces, beside the card's name and power limit.

Every phase ends with a line of its wall time (phase 14's timings run
last); the cuts of an earlier path to a smaller depth are printed by
their phases.

Phase 13 also runs the F2 configuration pca_incr_adi in float64 on the
card against the CPU's float64 frame (ROADMAP Q3-3), and phase 15
``greedy.ipca`` in float64 on the card against its two float32 runs
(Q3-2).

``python3 chip_smoke.py --f2`` instead bisects F2 on the card and the CPU
(the golden PCA step by step, the card's SVD routines, the four frames
under gesvd and gesvdj, the lapack PCA at full size under each), and
``--svd`` times the dense factorizations the slice-4 and NEGFC paths
call.
``python3 chip_smoke.py --negfc`` runs phase 16 alone (with the build),
with a torch.profiler table of one half-step; ``--invprob`` runs phase 17
alone, with a torch.profiler table of one FMMF annulus; ``--ifs`` runs
phase 18 alone, with torch.profiler tables of one single-pass and one
double-pass ``pca`` call.
``--slice8a`` runs phase 19 alone, with torch.profiler tables of
``cube_correct_nan`` and ``randomized_svd_gpu``; ``--slice8b`` runs
phase 20 alone, with torch.profiler tables of its two slowest steps;
``--slice8c9`` runs phase 21 alone, with torch.profiler tables of its two
slowest warps; ``--slice10`` runs phase 22 alone (the PP classes'
functions run there too); ``--slice11`` runs phase 23 alone (phase 12's
contrast curve and phase 18's sequence made there too); ``--slice12``
runs phase 24 alone; ``--jacobi`` runs phase 25 alone.
``--seed N`` (with any of the above) makes phase 18's sequence from seed
N (default 0).
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

import concurrent.futures
import contextlib
import json
import multiprocessing
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
# angles are the cube's angles split at their mean into two rolls. Halved
# (every 10th and 20th frame, from every 5th and 10th: the phase 54.0 s
# against 103.0 s on an H100 80GB HBM3 at 700 W) when phase 23 took the
# full script to 1122.6 s, past the 1100 s it keeps to of its 1200 s.
# LOCI on every 40th since the script took 1018.4 s with phase 24 (the
# build cached): its time follows its frames (3.73 s on 50, 0.27 s on 25),
# where annular NMF's and LLSG's do not (LLSG 5.29 s on 100 frames, 6.13 s
# on 50, on two H100 80GB HBM3 at 700 W; PERF.md)
SLICE4_CROP, SLICE4_EVERY, LOCI_EVERY = 120, 10, 40
# The greedy loops against their plain route, after their first pass: a
# change of 1e-7 in the frame fed back (the derotations differ by that)
# redraws the float32 rounding of the next PCA's residuals (~1e-5 of the
# frame at 200x128² on a CPU, 1.9e-3 at 1000x512² on an H100 80GB HBM3
# at 700 W, PERF.md), and can flip a pixel of a STIM mask thresholded at 0
GREEDY_TOL = 1e-2
# NEGFC (phase 16): firstguess and the MCMC on every NEGFC_EVERY-th frame
# of the cube with the planted companion (100 x 512²): each walker's
# likelihood takes one cuSOLVER gesvd of its (100, ~3000) annulus matrix
# (19-20 ms at (200, 3200), ``--svd``, an H100 80GB HBM3 at 700 W) beside
# the derotation of its 100 frames (H2); every 10th frame since the
# script took 1018.4 s with phase 24 and the build cached (phase 16 59.9 s
# at every 5th; PERF.md); the likelihood once at full depth
# (1000 frames) for NEGFC_FULL_WALKERS walkers; bench.py's NEGFC leg shape (50x64x64, 16
# walkers, ncomp 5, bench.py:289-312). The acceptance bounds (px, degrees,
# relative flux) of the first guess and of the posterior median
NEGFC_EVERY, NEGFC_FULL_WALKERS = 10, 16
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
# PSF); FMMF over INV_FW_WINDOW around the companion's 60 px. Every 20th
# frame since the script took 1018.4 s with phase 24 (every 10th: the
# three 7.88 s, FMMF 4.55 s of it, on an H100 80GB HBM3 at 700 W; PERF.md)
INV_EVERY, INV_SIZE, INV_FW_WINDOW = 20, 256, (58, 62)
INV_FMMF_PARAM = {"ncomp": 10, "tolerance": 0.005, "delta_rot": 0.5}
# Slice 7 (phase 18): one synthetic SPHERE-IFS sequence (YJ band,
# 0.95-1.35 µm in IFS_Z channels, scale_list = λmax/λ up to 1.42; the
# channel count of VIP's sphere_v471tau fixture, tests/test_pca_4d.py:135)
# of IFS_N even IFS_SIZE² frames (about SPHERE-IFS's reduced field; the
# derotation's canvas 4·288 = 9·128 is one H2 takes, where 290's 1162 is
# not, and 290² frames take the plain route), made
# from IFS_SEED with numpy: a halo and two speckle patterns that scale
# radially with λ (the second breathing through the sequence), white
# noise, parallactic angles over IFS_ROT degrees, and one companion of a
# flat spectrum at IFS_SEP px planted with ``fm.cube_inject_companions``
IFS_Z, IFS_N, IFS_SIZE, IFS_ROT, IFS_SEED = 39, 100, 288, 40.0, 0
IFS_SEP, IFS_FWHM, IFS_FLUX = 40.0, 4.0, 60.0
IFS_NCOMP, IFS_DOUBLE, IFS_GRID = 10, (2, 10), (5, 15, 5)
# the cuts of phase 18 (each printed): annular PCA on the central
# IFS_ANN_CROP² of every IFS_ANN_EVERY-th frame in annuli of IFS_ANN_ASIZE
# px (its SDI stage is one QR and one gesvd a frame, annulus and channel,
# ~8 ms a gesvd of a 38-row factor: 41.7 s for the 10,920 of every 5th
# frame of the central 120² in 4-px annuli, 11.5 s for the 1365 of every
# 20th in 8-px annuli, on an H100 80GB HBM3 at 700 W, PERF.md), LOCI on
# the central IFS_LOCI_CROP² of
# every IFS_LOCI_EVERY-th frame (an eigh a frame, segment and channel),
# the contrast curve on the central IFS_CC_CROP² of every IFS_CC_EVERY-th
# (each of its ~36 rungs injected into the 4-d cube on the host: 52.7 s
# at every 5th frame of 288²) and NEGFC on every IFS_NEGFC_EVERY-th
# frame (each χ² one gesvd a channel)
IFS_ANN_CROP, IFS_ANN_EVERY, IFS_ANN_ASIZE = 80, 20, 8
IFS_LOCI_CROP, IFS_LOCI_EVERY = 120, 20
IFS_CC_EVERY, IFS_CC_CROP, IFS_NEGFC_EVERY = 10, 160, 5
# the 4-d contrast columns against the plain route: the throughput to
# IFS_CC_TOL (it lies in [0, 1]), the sensitivity relative to IFS_CC_TOL
# where the throughput is at least CC_THR_MIN. Both are ratios of
# aperture sums over frames that differ by ~1.4e-6 of max(|ref|, 1), and
# the sensitivity divides by the throughput: on an H100 80GB HBM3 at
# 700 W 1.6e-4 apart at throughputs from 0.05 (phase 12's 3-d curve, at
# higher throughputs, holds 1e-4), 1.6e-2 where the single SDI pass
# removes the companion (a throughput near 0)
IFS_CC_TOL, CC_THR_MIN = 1e-3, 0.05
IFS_PXSCALE, IFS_STARPHOT = 0.00746, 1e5      # SPHERE-IFS's 7.46 mas/px
IFS_PROFILE_EVERY = 10
# FastPACO's rescaling on every IFS_PACO_EVERY-th frame of the replica
# (every 2nd until the script took 1018.4 s with phase 24: 4.46 s a run on
# an H100 80GB HBM3 at 700 W; PERF.md)
IFS_PACO_EVERY = 4
# Slice 8a (phase 19) on the full cube: NaN damage made on the card (a
# fraction S8A_SINGLE of single pixels, S8A_CLUMPS clumps of 3x3 to 5x5 px
# a frame: ~0.1% in all); the host loops on S8A_HOST_FRAMES frames;
# windows of S8A_WINDOW frames; the IUWT of S8A_IUWT_FRAMES frames;
# float32 on the card against the CPU float64 mode within S8A_F32_TOL of
# max(|ref|, 1) (the bound of the slice 7 card tests), Richardson-Lucy
# against scipy within S8A_DECONV_TOL of max|ref|; randomized_svd_gpu of
# the cube plus a rank-S8A_NCOMP structure whose singular values fall
# from 10^3 to 10^1.5 times the noise's top one; a 39-channel star cube
# (S8A_STAR_SIZE², the SPHERE-IFS field of phase 18) with hot patches in
# the outlier channels
S8A_SINGLE, S8A_CLUMPS, S8A_HOST_FRAMES = 7e-4, 4, 3
S8A_WINDOW, S8A_IUWT_FRAMES, S8A_NCOMP = 10, 100, 10
S8A_F32_TOL, S8A_DECONV_TOL, S8A_SPECTRUM = 1e-4, 1e-4, (3.0, 1.5)
S8A_STAR_Z, S8A_STAR_SIZE, S8A_STAR_OUTLIERS = 39, 288, [5, 17, 30]
S8A_REPS = 3
# Slice 8b (phase 20) on the full cube: the NACO replica's Moffat star
# (``_moffat_psf``, FWHM S8B_FWHM) jittered by up to S8B_JITTER px a frame
# (seed 12) over the noise cube; recovered shifts within S8B_SHIFT_TOL px
# of the jitter; the batched registration against the per-frame loop on
# S8B_LOOP_FRAMES frames; the masked registration (a disk of
# S8B_MASK_RADIUS px), the Moffat fit, the per-frame bad-pixel routes and
# the Gaussian interpolation on S8B_SUB_FRAMES frames; the speckle
# alignment in S8B_SUBFRAME² crops, with the annulus fit on
# S8B_ANN_FRAMES frames; S8B_SAT_FRAMES coronagraphic frames with four
# spots (a tenth of the star) on the 'x' diagonals at S8B_SAT_SEP px,
# jittered by up to 1 px (seed 13), S8B_RADON_FRAMES of them through
# cube_recenter_radon (S8B_RADON_CROP² crops, centers within S8B_RADON_TOL
# px); a static map of
# hot pixels (S8B_HOT of all, +S8B_HOT_VALUE sigma) and S8A_CLUMPS clumps a
# frame (+S8B_CLUMP_VALUE sigma; seed 14), the shared map found at recall
# S8B_RECALL at least; the FFT fill on S8B_FFT_FRAMES frames; the IFS
# correction on phase 19's star cube; S8B_BAD_FRAMES damaged frames
S8B_FWHM, S8B_JITTER, S8B_SHIFT_TOL = 4.800919383981533, 1.5, 0.05
S8B_LOOP_FRAMES, S8B_SUB_FRAMES, S8B_MASK_RADIUS = 20, 100, 100
S8B_SUBFRAME, S8B_ANN_FRAMES = 101, 50
S8B_SAT_FRAMES, S8B_SAT_SEP, S8B_RADON_FRAMES = 100, 40, 10
S8B_RADON_TOL, S8B_RADON_CROP = 0.25, 161
S8B_HOT, S8B_HOT_VALUE, S8B_CLUMP_VALUE, S8B_RECALL = 1e-3, 50.0, 30.0, 0.99
S8B_FFT_FRAMES, S8B_BAD_FRAMES = 10, 30
# shifts of a route through host fits against its per-frame route in
# float32 (the fits see float32 rounding of another order), and the float64
# bound of the routes compared in float64 on the card
S8B_FIT_TOL, S8B_F64_TOL = 1e-4, 1e-10
# the cuts of the plain-route checks (each printed): routes whose frames
# depend on each other (a median of all) on a cube of the first
# S8B_PLAIN_CUBE frames, per-frame loops on the first S8B_PLAIN_FRAMES,
# the float64 FFT fill on S8B_FFT64_FRAMES, the full sinograms on a
# S8B_RADON_GRID² grid
S8B_PLAIN_CUBE, S8B_PLAIN_FRAMES, S8B_FFT64_FRAMES, S8B_RADON_GRID = \
    100, 4, 3, 7
# Slices 8c and 9 (phase 21) on the full cube: each batched warp against
# its per-frame loop on the first S8C_LOOP_FRAMES frames within
# S8C_LOOP_TOL of max(|ref|, 1), and in float32 against the same call in
# float64 on the card within S8C_F32_TOL (the bilinear float32 bound of
# tests/test_torch_imlibs.py); the host scipy shift and edge_blend on
# S8C_HOST_FRAMES frames; resampling at S8C_RESAMPLE. The disk: an HG
# phase function (g S9_G) seen at S9_ITILT degrees, a = S9_A au, slopes
# S9_AIN / S9_AOUT, at S9_DIST pc with NACO's S9_PXSCALE arcsec px,
# S9_SLICES half slices; its float32 map within S9_DISK_TOL of its peak of
# the float64 one; scaled to a peak of S9_PEAK, planted at flux S9_FLUX
# (noise sigma 1) and held in the ring S9_MASK px; the first guess on
# every S9_EVERY-th frame within S9_FLUX_TOL of the flux (the bound of
# tests/test_fm_negfd.py:86, 0.3 on 3.0), its simplex cut to S9_SIMPLEX;
# the χ² at the planted flux within S9_CHI_TOL of the noise cube's
# (S8C_HOST_FRAMES 100 until the script took 1018.4 s with phase 24:
# the 'ndimage-interp' shift of 100 frames 5.42 s on an H100 80GB HBM3 at
# 700 W, PERF.md)
S8C_LOOP_FRAMES, S8C_LOOP_TOL, S8C_F32_TOL = 4, 1e-6, 1e-4
S8C_HOST_FRAMES, S8C_RESAMPLE = 50, (0.5, 1.37)
S9_G, S9_ITILT, S9_A, S9_AIN, S9_AOUT = 0.4, 70.0, 40.0, 10.0, -5.0
S9_DIST, S9_PXSCALE, S9_SLICES, S9_DISK_TOL = 50.0, 0.01225, 25, 1e-4
S9_PEAK, S9_FLUX, S9_MASK, S9_EVERY = 10.0, 3.0, (30, 110), 10
S9_FLUX_TOL, S9_CHI_TOL = 0.1, 1e-3
S9_SIMPLEX = {"xatol": 1e-3, "fatol": 1e-4, "maxiter": 60, "maxfev": 80}
# Slice 10 (phase 22) on the cube with the planted companion: the FITS
# codec on the whole cube; Dataset, PPPCA (classic, grid over GRID_PCS,
# annulus S10_ANNULUS_WIDTH px wide at the companion, annular with
# phase 14's annuli) and PPMedianSub at full width and depth (annular
# PCA below 512 frames takes an eigh a frame and annulus, below 128 its
# per-frame host branch: on an H100 80GB HBM3 at 700 W 23.7 s for every
# 7th frame, 64.0 s for every 10th, against ~10 s for all 1000); the six
# other PP classes on the cuts of phases 15 and 17 (held bit for bit to
# those phases' frames, or, run alone, to the same calls here), annular
# NMF and LLSG on every S10_SLICE4_EVERY-th frame of phase 15's crop and
# LOCI on every S10_LOCI_EVERY-th (held to direct calls on the same
# frames: phase 15's cuts);
# EvalRoc on every S10_EVERY-th frame with S10_ROC_INJECTIONS injections
# of fluxes S10_ROC_FLUX (PSF normalized to a unit 1-FWHM aperture:
# peaks of ~0.1 per unit flux, noise sigma 1), thresholds S10_ROC_THRESH,
# each injection found at threshold 3 in a map; Dataset.save/load on the
# first S10_SAVE_FRAMES frames (5.61 s for the save of 100, PERF.md)
S10_EVERY, S10_SLICE4_EVERY, S10_LOCI_EVERY = 10, 10, 40
S10_ANNULUS_WIDTH, S10_SAVE_FRAMES = 12, 50
S10_ROC_INJECTIONS, S10_ROC_FLUX, S10_ROC_THRESH = 4, ("uniform", 50, 150), \
    (1, 2, 3, 4, 5)
S10_PX_SCALE = 0.0272
# Slice 11 (phase 23), several devices. (a) NCCL at world size 1 in this
# process, at full width: the sharded PCA-ADI (mean and median) and
# median-ADI of the cube against the port's pipelines; the sharded annular
# PCA on every S11_ANN_EVERY-th frame against pca_annular(svd_mode=
# "eigen") (S11_ANN: asize 32 for bench.py's 4, each annulus costing one
# cuSOLVER eigh a frame: 2.99 s for asize 16 on an H100 80GB HBM3 at
# 700 W); the sharded S/N map of the median frame
# against snrmap_fast; the contrast curve with pattern_mesh against
# phase 12's; pca_incremental with pixel_mesh against pixel_mesh=None
# (phase 11's batches of a FITS file); the walker likelihood of
# S11_WALKERS walkers and S11_MCMC_STEPS steps of the MCMC of
# S11_MCMC_WALKERS walkers (draws from seed 23) on phase 16's cut against
# the unsharded ones, bit for bit; the
# ADI+mSDI single pass on phase 18's sequence against pca(adimsdi=
# "single", svd_mode="eigen"): in float32 (H1, H2) within S11_SDI_F32_TOL
# and, on every S11_SDI64_EVERY-th frame, in float64 within PIPE_TOL, the
# bound of tests/test_sharding.py:306 (pca's zoom keeps vip_tpu's float32
# canvas, the sharded pass rounds through float32 once: 1.372e-07 on the
# CPU, 3.447e-09 on an H100 80GB HBM3 at 700 W). In float32 the two
# zooms' roundings differ by float32's epsilon, and the residual is a
# small part of the halo-dominated frames it is cut from, so the frames
# differ by more: 8.235e-04 and 8.413e-04 of max(|ref|, 1) in two runs
# (before and after the sharded zoom took one channel at a time; an H100
# 80GB HBM3 at 700 W); S11_SDI_F32_TOL is three times the larger.
# (b) gloo at world size S11_RANKS, every rank on cuda:0, spawned through
# vip_tpu_torch.dryrun: on the first S11_B_FRAMES frames (the annular PCA
# on every S11_ANN_EVERY-th of them, the contrast curve on their central
# S11_B_CC_CROP² pixels: its first call in a process builds cuFFT plans
# for each companion's shift of the map: phase 12's curve took 34.70 s
# in phase 23 run alone against 2.36 s after phase 12, and 20.5 s at
# 256² in four fresh ranks at once, on an H100 80GB HBM3 at 700 W), an
# S/N map of the cube's first frame, the SDI on the first S11_B_SDI
# (channels, frames) of phase 18's sequence (39 channels do not divide by
# 4), the likelihood and the MCMC on (a)'s inputs; each entry point
# against the same call at world size 1 here within PIPE_TOL of
# max(|ref|, 1), except the float32 streamed PCA, whose merge sums the
# ranks' Grams of their pixel slabs in another order than one Gram: the
# top PCs of white noise turn with that order (3.777e-04 of max(|ref|, 1)
# in each of six runs on an H100 80GB HBM3 at 700 W), so it is held to
# S11_INC_F32_TOL, three times that reading, beside a float64 twin held
# to Q33_TOL
S11_ANN_EVERY, S11_WALKERS, S11_MCMC_STEPS, S11_RANKS = 10, 16, 2, 4
S11_MCMC_WALKERS = 8
S11_ANN = dict(ncomp=NCOMP, fwhm=4.0, asize=32, delta_rot=0.5, n_segments=1)
S11_B_FRAMES, S11_B_SDI, S11_B_CC_CROP, S11_B_TIMEOUT = 200, (36, 8), 128, \
    300.0
S11_SDI64_EVERY, S11_SDI_F32_TOL, S11_INC_F32_TOL = 10, 2.5e-3, 1.2e-3
# (b)'s ranks share the card with this process, which keeps to
# S11_MAIN_MEMORY of it meanwhile (its cache otherwise grows to the whole
# card and a rank runs out); the float64 twin of the streamed PCA takes
# the plain rotation (up to 8 GiB of canvases a rank at 512²), so it
# runs on the central S11_B_INC64_CROP² pixels
S11_MAIN_MEMORY, S11_B_INC64_CROP = 0.6, 128
# Slice 12 (phase 24) on the main path's cube: get_pca_coeffs with the
# NCOMP PCs of phase 7's main path, and VIP's torch rotation
# tensor_rotate_fft of an even SIZE² and an odd (SIZE - 1)² frame at
# S12_ANGLES (each quadrant's branch of its rot90 split, a residual of
# either sign); each in float32 on the card within PIPE_TOL of max(|ref|,
# 1) of the same call in float64 on the card
S12_ANGLES = (0.0, 30.0, 60.0, 135.0, 300.0)
# Q3-2 (phase 15): ipca in float32 through the kernels may stand at most
# Q32_RATIO times as far from its float64 run on the card as the float32
# plain route does. Q3-3 (phase 13): pca_incr_adi in float64 on the card
# within Q33_TOL of max(|ref|, 1) of the CPU's float64 frame (the float64
# bound of the slice 7 card tests)
Q32_RATIO, Q33_TOL = 3.0, 1e-8
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
    from vip_tpu_torch.ops import linalg, median, shear

    median.launches = shear.launches = shear.small_launches = 0
    shear.fused3_launches = linalg.jacobi_launches = 0
    linalg.subspace_matrices = 0


def _counts():
    from vip_tpu_torch.ops import linalg, median, shear

    return {"H1": median.launches, "H2": shear.launches,
            "H3": shear.small_launches, "H4": shear.fused3_launches,
            "K5": linalg.jacobi_launches,
            "subspace": linalg.subspace_matrices}


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


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_device():
    import vip_tpu_torch

    _require(torch.cuda.is_available(), "CUDA is not available")
    smi = _card()
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
    a block; the counts of the rotation and median kernels must not move
    inside it (K5, the route of the small SVDs, runs on both sides)."""
    from vip_tpu_torch.preproc import subsampling

    supported = subsampling.nanmedian_supported
    subsampling.nanmedian_supported = lambda arr, ax=0: False
    try:
        with _env("VIP_EXACT_SHEAR", "pruned"):
            before = _counts()
            yield
            after = _counts()
            _require(all(after[k] == before[k]
                         for k in ("H1", "H2", "H3", "H4")),
                     f"the plain route launched kernels: {before} -> "
                     f"{after}")
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


def _slice4_cuts(pcube, angles_np, every=SLICE4_EVERY,
                 loci_every=LOCI_EVERY):
    """Phase 15's cuts of the cube with the planted companion: the
    central SLICE4_CROP², every ``every``-th frame of it (and shifted to
    positive values, for annular NMF, which checks each library's median
    for a sign before any handle_neg) and every ``loci_every``-th."""
    lo, hi = SIZE // 2 - SLICE4_CROP // 2, SIZE // 2 + SLICE4_CROP // 2
    crop = pcube[:, lo:hi, lo:hi].contiguous()
    crop5, ang5 = crop[::every].contiguous(), angles_np[::every]
    crop10, ang10 = crop[::loci_every].contiguous(), \
        angles_np[::loci_every]
    pos5 = (crop5 - pcube.min() + 1.0).contiguous()
    return crop, crop5, ang5, crop10, ang10, pos5


def phase_slice4(pcube, angles_np, src, keep=None):
    """Slice 4 at full width: each new entry point through the kernels
    (launches counted from 0 just before it), through the plain route
    (``_plain_route``: the plain derotation and median), the two within
    PIPE_TOL of max(|ref|, 1) (the greedy loops: their first pass, and
    their last within GREEDY_TOL); its warm time (median of 3, or the counted
    run alone for the long ones); the planted companion detected where
    the frame keeps the full width. Returns {name: (counts, seconds)};
    ``keep`` (a dict) receives {name: (frame, seconds)} of the counted
    runs, which phase 22 holds its PP objects to."""
    from vip_tpu_torch import greedy, psfsub
    from vip_tpu_torch.metrics import detection

    t_phase = time.perf_counter()
    crop, crop5, ang5, crop10, ang10, pos5 = _slice4_cuts(pcube, angles_np)
    mid = float(np.mean(angles_np))
    low, high = angles_np <= mid, angles_np > mid
    rolls = np.where(low, angles_np[low].mean(), angles_np[high].mean())
    # INMF checks each library's median for a sign before any handle_neg:
    # it takes the cube shifted to positive values
    positive = pcube - pcube.min() + 1.0
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
        if name == "ipca":
            _ipca_float64(pcube, angles_np, frame, first, ref, ref_first)
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
        if keep is not None:
            keep[name] = (frame, wall)
    print(f"slice 4 cuts: annular NMF, LLSG, frame differencing and LOCI "
          f"on the central {SLICE4_CROP}x{SLICE4_CROP} (annuli to 60 px); "
          f"annular NMF and LLSG on every {SLICE4_EVERY}th frame "
          f"({crop5.shape[0]} of {N_FRAMES}), LOCI on every {LOCI_EVERY}th "
          f"({crop10.shape[0]}), cut from every 5th and 10th, then LOCI from "
          f"every 20th, to keep the script within its time limit; the "
          f"phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _ipca_float64(pcube, angles_np, frame, first, ref, ref_first):
    """Q3-2: ``greedy.ipca`` of phase 15 in float64 on the card (H1 and H2
    take float32 alone, so it runs the plain versions), against its
    float32 runs through the kernels (``frame``, ``first``) and through
    the plain route (``ref``, ``ref_first``). Rounding shows as both
    float32 routes standing as far from the float64 run; a fault of the
    kernels' route as that route alone standing farther (more than
    Q32_RATIO times the plain route)."""
    from vip_tpu_torch import greedy

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f64, first64 = _last_and_first(greedy.ipca(
        pcube.double(), angles_np, ncomp=3, nit=3, full_output=True,
        verbose=False))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _require(f64.dtype == torch.float64 and _counts() == dict.fromkeys(
        ("H1", "H2", "H3", "H4", "K5", "subspace"), 0),
        "ipca float64: launches or dtype")
    errs = {k: _rel_err(a, b)[0] for k, (a, b) in {
        "kernels": (frame, f64), "plain": (ref, f64),
        "kernels vs plain": (frame, ref), "first kernels": (first, first64),
        "first plain": (ref_first, first64)}.items()}
    print(f"Q3-2 ipca float64 on the card ({wall:.4f} s, no launch): "
          "max abs distance of the float32 frames, last pass "
          f"(first pass): kernels {errs['kernels']:.3e} "
          f"({errs['first kernels']:.3e}), plain route {errs['plain']:.3e} "
          f"({errs['first plain']:.3e}); kernels vs plain "
          f"{errs['kernels vs plain']:.3e}", flush=True)
    _require(errs["kernels"] <= Q32_RATIO * errs["plain"],
             "Q3-2: the kernels' route stands farther from float64 than "
             "the plain route")


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


def _invprob_full_width(pcube, angles_np):
    """Phase 17's full-width inputs: every INV_EVERY-th frame of the cube
    with the planted companion, its central INV_SIZE², the float64
    angles, a 20² Gaussian PSF of FWHM COMP_FWHM, FMMF's keywords and the
    companion's (y, x) there."""
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
    return cube_fw, angs_fw, psf20, fmmf_fw, comp


def phase_invprob(pcube, angles_np, profile=False, keep=None):
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
    Returns {path: counts} and {name: seconds}; ``keep`` (a dict)
    receives {name: (result, seconds)} of the full-width runs, which
    phase 22 holds its PP objects to."""
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
    cube_fw, angs_fw, psf20, fmmf_fw, comp = _invprob_full_width(
        pcube, angles_np)
    # (run, the index of its S/N map)
    full = {
        "andromeda full width": (lambda: ip.andromeda(
            cube=cube_fw, angle_list=angs_fw, psf=psf20,
            oversampling_fact=2, iwa=2, opt_method="lsq", verbose=False),
            2),
        "fastpaco full width": (lambda: ip.FastPACO(
            cube=cube_fw, angles=angs_fw, psf=psf20, fwhm=COMP_FWHM,
            pixscale=1.0).run(), 0),
        "fmmf full width": (lambda: ip.fmmf(
            cube=cube_fw, angle_list=angs_fw, psf=psf20 / psf20.sum(),
            min_r=INV_FW_WINDOW[0], max_r=INV_FW_WINDOW[1], **fmmf_fw), 1),
    }
    for name, (fn, pick) in full.items():
        res = run(name, fn)
        snr = res[pick]
        if keep is not None:
            keep[name] = (res, times[name])
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


def _ifs_cube(seed=None):
    """The synthetic IFS sequence of phase 18 as a float32 tensor on the
    card, with its angles, scale_list, normalized PSF cube and the
    companion's derotated (x, y)."""
    from scipy.ndimage import gaussian_filter

    from vip_tpu_torch.fm import cube_inject_companions, normalize_psf
    from vip_tpu_torch.preproc.rescaling import frame_rescaling

    rng = np.random.default_rng(IFS_SEED if seed is None else seed)
    z, n, size = IFS_Z, IFS_N, IFS_SIZE
    wl = np.linspace(0.95, 1.35, z)
    scal = wl[-1] / wl
    c = size // 2
    yy, xx = np.mgrid[:size, :size]
    halo = 80.0 * np.exp(-((yy - c) ** 2 + (xx - c) ** 2) / (2 * 24.0 ** 2))
    speck = [gaussian_filter(rng.standard_normal((size, size)), 2.0) * 20
             for _ in range(2)]
    breath = np.linspace(-1.0, 1.0, n, dtype=np.float32)[:, None, None]
    cube = np.empty((z, n, size, size), dtype=np.float32)
    for ch in range(z):
        # speckles and halo closer to the star at shorter λ
        a, b, h = (frame_rescaling(torch.as_tensor(f, device=DEVICE),
                                   scale=1 / scal[ch]).cpu().numpy()
                   for f in (speck[0], speck[1], halo))
        # white noise of unit variance (uniform: numpy draws it at a
        # fraction of the cost of normal deviates, 3.2e8 of them here)
        cube[ch] = (h + a)[None] + breath * (0.3 * b)[None] + (
            rng.random((n, size, size), dtype=np.float32) - 0.5) * 12 ** 0.5
    angles = np.linspace(0.0, IFS_ROT, n)
    q = np.arange(15) - 7
    psf = np.stack([np.exp(-(q[:, None] ** 2 + q[None, :] ** 2)
                           / (2 * (IFS_FWHM / scal[ch] / 2.355) ** 2))
                    for ch in range(z)])
    psfn = normalize_psf(psf, fwhm=list(IFS_FWHM / scal), verbose=False)
    t_inject = time.perf_counter()
    cube = cube_inject_companions(cube, psfn, angles, flevel=IFS_FLUX,
                                  rad_dists=[IFS_SEP], theta=0.0,
                                  verbose=False)
    cube_t = torch.as_tensor(cube, dtype=torch.float32, device=DEVICE)
    print(f"ifs cube: the companion injected and the cube on the card in "
          f"{time.perf_counter() - t_inject:.1f} s", flush=True)
    return cube_t, angles, scal, psfn, (c + IFS_SEP, float(c))


def phase_ifs(profile=False, keep=None):
    """Slice 7, the 4-d IFS paths, on the synthetic sequence of
    ``_ifs_cube``: ``pca`` single pass (ncomp 10, crop_ifs), double pass
    (ncomp (2, 10)), per-channel ADI and an ncomp grid with scale_list;
    ``pca_annular`` (ncomp (1, 2)); ``median_sub`` fullfr and annular;
    ``xloci`` (double); a contrast curve of the single pass;
    ``FastPACO`` with ``rescaling_factor=2`` on the NACO replica; NEGFC's
    ``firstguess`` (one flux for all channels). Each runs through the
    kernels with its H1/H2 launches and through the plain route on the
    card, within PIPE_TOL of max(|ref|, 1); the PCA passes are timed warm
    (median of 3), the rest once; the single pass, the double pass and
    the 4-d median_sub find the companion within 3 px. With ``profile``
    also torch.profiler tables of one single-pass and one double-pass
    call. ``keep`` receives the sequence under "ifs" (phase 23 runs on
    it). Returns {path: counts} and {name: seconds}."""
    import vip_tpu_torch.fm as tfm
    import vip_tpu_torch.invprob as ip
    import vip_tpu_torch.psfsub as tps
    from vip_tpu_torch.metrics.contrcurve import _contrast_curve

    t_phase = time.perf_counter()
    cube, angles, scal, psfn, src = _ifs_cube()
    if keep is not None:
        keep["ifs"] = (cube, angles, scal)
    t_make = time.perf_counter() - t_phase
    print(f"ifs cube {tuple(cube.shape)} float32 "
          f"({cube.numel() * 4 / 1e9:.2f} GB on the card), scale_list "
          f"{scal.min():.3f}..{scal.max():.3f}, companion at (x, y) {src}: "
          f"made in {t_make:.1f} s", flush=True)
    counts, times, errs = {}, {}, {}
    yx = (src[1], src[0])

    def c2(every=1, crop=None):
        sub = cube[:, ::every]
        if crop is not None:
            c0 = (IFS_SIZE - crop) // 2
            sub = sub[..., c0:c0 + crop, c0:c0 + crop]
        return sub.contiguous(), angles[::every]

    def check(name, fn, reps=0, tol=PIPE_TOL, found=False):
        """``fn`` through the kernels (counted, timed), then ``reps``
        more warm timed calls, then the plain route; the outputs (an
        array or tensor, a tuple of them, or a float) held within
        ``tol`` of max(|ref|, 1)."""
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts[name] = _counts()
        _require(counts[name]["H3"] == counts[name]["H4"] == 0,
                 f"{name}: {counts[name]}")
        runs = [_timed(fn) for _ in range(reps)] if reps else [first]
        times[name] = float(np.median(runs))
        with _plain_route():
            ref = fn()
        outs = list(got) if isinstance(got, tuple) else [got]
        refs = list(ref) if isinstance(ref, tuple) else [ref]
        worst = 0.0
        for g, r in zip(outs, refs):
            e, scale = _rel_err(torch.as_tensor(g).cpu(),
                                torch.as_tensor(r).cpu())
            worst = max(worst, e / scale)
        errs[name] = worst
        hit = None
        if found:
            hit = _found(outs[0], IFS_FWHM, yx)
        print(f"ifs {name}: {times[name]:.4f} s ("
              + (f"warm median of {reps}: {_spread(runs)}" if reps else
                 "once") + f"), launches {counts[name]}, against the plain "
              f"route {worst:.3e} of max(|ref|, 1) (bound {tol:.0e})"
              + ("" if hit is None else f", companion found: {hit}"),
              flush=True)
        _require(worst <= tol, f"ifs {name} disagrees with the plain route")
        if found:
            _require(hit, f"ifs {name}: the companion at {yx} missed")
        return got

    single = dict(scale_list=scal, ncomp=IFS_NCOMP, adimsdi="single",
                  crop_ifs=True, verbose=False)
    double = dict(scale_list=scal, ncomp=IFS_DOUBLE, adimsdi="double",
                  verbose=False)
    check("pca single pass", lambda: tps.pca(cube, angles, **single),
          reps=3, found=True)
    _require(counts["pca single pass"]["H2"] > 0, "single pass: no H2")
    check("pca double pass", lambda: tps.pca(cube, angles, **double),
          reps=3, found=True)
    check("pca per-channel ADI", lambda: tps.pca(
        cube, angles, ncomp=IFS_NCOMP, verbose=False), reps=3)
    check("pca grid single pass", lambda: tps.pca(
        cube, angles, scale_list=scal, ncomp=IFS_GRID, adimsdi="single",
        verbose=False))
    ann_cube, ann_angles = c2(IFS_ANN_EVERY, IFS_ANN_CROP)
    check("pca_annular sdi+adi", lambda: tps.pca_annular(
        ann_cube, ann_angles, scale_list=scal, ncomp=(1, 2), fwhm=IFS_FWHM,
        asize=IFS_ANN_ASIZE, radius_int=4, delta_sep=0.1, verbose=False))
    check("median_sub fullfr", lambda: tps.median_sub(
        cube, angles, scale_list=scal, fwhm=IFS_FWHM, mode="fullfr",
        verbose=False), found=True)
    _require(counts["median_sub fullfr"]["H1"] == 4,
             f"median_sub fullfr: {counts['median_sub fullfr']}, want 4 H1 "
             "(the channel medians of all frames, the channel collapse, the "
             "temporal median, the final collapse)")
    check("median_sub annular", lambda: tps.median_sub(
        cube, angles, scale_list=scal, fwhm=IFS_FWHM, mode="annular",
        radius_int=4, asize=4, delta_sep=0.1, nframes=None, verbose=False))
    loci_cube, loci_angles = c2(IFS_LOCI_EVERY, IFS_LOCI_CROP)
    check("xloci double", lambda: tps.xloci(
        loci_cube, loci_angles, scale_list=scal, adimsdi="double",
        fwhm=IFS_FWHM, asize=8, radius_int=4, delta_sep=0.1, delta_rot=0.3,
        verbose=False))
    cc_cube, cc_angles = c2(IFS_CC_EVERY, IFS_CC_CROP)
    cc_host, cc_cols = cc_cube.cpu().numpy(), []

    def contrast():
        """The 4-d contrast curve: its reduced frames out, its columns
        kept aside."""
        cols, fc_all, nofc, _ = _contrast_curve(
            cc_host, cc_angles, psfn, IFS_FWHM, IFS_PXSCALE, IFS_STARPHOT,
            tps.pca, nbranch=1, fc_rad_sep=3, plot=False, verbose=False,
            scale_list=scal, ncomp=IFS_NCOMP, adimsdi="single")
        cc_cols.append(cols)
        return fc_all, nofc

    check("contrast curve", contrast)
    thr = cc_cols[0]["throughput"]
    ok = cc_cols[-1]["throughput"] >= CC_THR_MIN
    got_s, ref_s = (c["sensitivity_student"][ok]
                    for c in (cc_cols[0], cc_cols[-1]))
    worst = max(_rel_err(torch.as_tensor(thr),
                         torch.as_tensor(cc_cols[-1]["throughput"]))[0],
                float(np.max(np.abs(got_s - ref_s) / np.abs(ref_s))))
    print(f"ifs contrast curve ({cc_host.shape[1]}x{IFS_CC_CROP}^2, "
          f"{len(thr)} radii): throughput {thr.min():.4f}..{thr.max():.4f}, "
          f"student sensitivity {cc_cols[0]['sensitivity_student'].min():.3e}"
          f"..{cc_cols[0]['sensitivity_student'].max():.3e} ("
          f"{int(np.sum(thr <= 0))} radii at or below zero throughput); "
          f"columns against the plain route {worst:.3e} (bound "
          f"{IFS_CC_TOL:.0e}; the sensitivity at the {int(ok.sum())} radii "
          f"of throughput >= {CC_THR_MIN})", flush=True)
    _require(worst <= IFS_CC_TOL, "ifs contrast curve columns disagree")
    # the column is the throughputs' spline (vip_tpu's), which may dip a
    # hair below 0 where the SDI pass removes the companion whole
    _require(np.all(np.isfinite(thr)) and 0 < thr.max() <= 1,
             "contrast curve: no throughput in (0, 1]")

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
    meta = np.load(os.path.join(golden, "meta.npz"))
    rep = torch.as_tensor(np.load(os.path.join(golden, "inputs.npz"))["cube"],
                          dtype=torch.float32, device=DEVICE)
    rep = rep[::IFS_PACO_EVERY].contiguous()
    rep_angles = meta["angles"][::IFS_PACO_EVERY]
    snr = check("FastPACO rescaling 2", lambda: ip.FastPACO(
        cube=rep, angles=rep_angles, psf=meta["psfn"],
        fwhm=float(meta["fwhm"]), pixscale=1.0, rescaling_factor=2.0).run())
    print(f"ifs FastPACO rescaling 2 on every {IFS_PACO_EVERY}th frame of "
          f"the replica ({rep.shape[0]}x{rep.shape[-1]}^2): S/N map "
          f"{tuple(snr[0].shape)}", flush=True)

    ng_cube, ng_angles = c2(IFS_NEGFC_EVERY)
    xy = (src[0], src[1])
    fg = dict(ncomp=IFS_NCOMP, fwhm=IFS_FWHM, annulus_width=4,
              aperture_radius=1, bin_spec=True,
              f_range=np.geomspace(IFS_FLUX / 4, IFS_FLUX * 4, 9),
              simplex_options={"xatol": 1e-2, "fatol": 1e-2, "maxiter": 30,
                               "maxfev": 40}, verbose=False)
    _reset_counts()
    t0 = time.perf_counter()
    r0, th0, f0 = tfm.firstguess(ng_cube, ng_angles, psfn, xy, **fg)
    torch.cuda.synchronize()
    times["negfc firstguess"] = time.perf_counter() - t0
    counts["negfc firstguess"] = _counts()
    fit = (float(r0[0]), float(th0[0]), float(f0[0]))
    print(f"ifs negfc firstguess (bin_spec, {ng_cube.shape[1]} frames): "
          f"{times['negfc firstguess']:.3f} s, launches "
          f"{counts['negfc firstguess']}; fit (r, theta, f) "
          f"({fit[0]:.3f}, {fit[1]:.3f}, {fit[2]:.3f}) against the truth "
          f"({IFS_SEP}, 0, {IFS_FLUX})", flush=True)
    _require(abs(fit[0] - IFS_SEP) < 1.0
             and abs((fit[1] + 180) % 360 - 180) < 2.0
             and abs(fit[2] - IFS_FLUX) < 0.3 * IFS_FLUX,
             f"negfc firstguess {fit} far from the truth")
    check("negfc chisquare", lambda: tfm.chisquare(
        fit, ng_cube, ng_angles, psfn, IFS_FWHM, 4, 1, fit[:2], IFS_NCOMP,
        bin_spec=True))

    if profile:
        _ifs_stages(cube, angles, scal)
        # torch.profiler on every IFS_PROFILE_EVERY-th frame: cuSOLVER's
        # gesvd of the full single pass's 3900² factor launches too many
        # small kernels for the profiler's table within the time limit
        sub, sub_angles = c2(IFS_PROFILE_EVERY)
        for name, kw in (("single pass", single), ("double pass", double)):
            wall, table = _profile_table(
                lambda: tps.pca(sub, sub_angles, **kw), rows=15)
            print(f"ifs pca {name} on every {IFS_PROFILE_EVERY}th frame "
                  f"({tuple(sub.shape)}) under the profiler {wall:.4f} s; "
                  f"top ops by device time:\n{table}", flush=True)
    print(f"ifs cuts: pca_annular on the central {IFS_ANN_CROP}^2 of every "
          f"{IFS_ANN_EVERY}th frame in {IFS_ANN_ASIZE}-px annuli, xloci on "
          f"the central {IFS_LOCI_CROP}^2 of every {IFS_LOCI_EVERY}th, the "
          f"contrast curve on the central {IFS_CC_CROP}^2 of every "
          f"{IFS_CC_EVERY}th, FastPACO on every {IFS_PACO_EVERY}th of the "
          f"replica and NEGFC on every "
          f"{IFS_NEGFC_EVERY}th frame; "
          f"the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts, times


def _damage(cube, seed):
    """A copy of ``cube`` with NaN pixels made on the card from a seeded
    ``torch.Generator``: single pixels (S8A_SINGLE of all) and
    S8A_CLUMPS clumps a frame of 3x3 to 5x5 px, anywhere in the frame.
    Returns the copy and its NaN fraction."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n, ny, nx = cube.shape
    out = cube.clone()
    out[torch.rand(out.shape, generator=g, device=DEVICE) < S8A_SINGLE] = \
        torch.nan
    k = n * S8A_CLUMPS
    f = torch.arange(n, device=DEVICE).repeat_interleave(S8A_CLUMPS)
    y0 = torch.randint(0, ny - 4, (k,), generator=g, device=DEVICE)
    x0 = torch.randint(0, nx - 4, (k,), generator=g, device=DEVICE)
    side = torch.randint(3, 6, (k,), generator=g, device=DEVICE)
    d = torch.arange(5, device=DEVICE)
    keep = (d[None, :, None] < side[:, None, None]) \
        & (d[None, None, :] < side[:, None, None])
    fi = f[:, None, None].expand(-1, 5, 5)[keep]
    yi = (y0[:, None, None] + d[None, :, None]).expand(-1, 5, 5)[keep]
    xi = (x0[:, None, None] + d[None, None, :]).expand(-1, 5, 5)[keep]
    out[fi, yi, xi] = torch.nan
    return out, float(torch.isnan(out).float().mean())


def _rl_scipy(frame, psf, n_it):
    """Richardson-Lucy with ``scipy.signal.convolve(mode="same")`` on the
    host in float64, as vip_tpu computes it (vip_tpu filters.py:290)."""
    from scipy.signal import convolve

    im = np.full(frame.shape, 0.5)
    mirror = psf[::-1, ::-1]
    for _ in range(n_it):
        conv = convolve(im, psf, mode="same")
        im *= convolve(frame / np.where(conv == 0, 1e-12, conv), mirror,
                       mode="same")
    return im


def _step(name, fn):
    """Run ``fn`` once with the counts reset just before it, synchronized:
    (result, counts, seconds); prints one line."""
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    print(f"slice 8a {name}: {wall:.4f} s (the counted run), launches H1 "
          f"{counts['H1']}, H2 {counts['H2']}", flush=True)
    return out, counts, wall


def _ulps32(got, ref):
    """Largest distance of float32 ``got`` from ``ref`` in float32 ulps of
    ``ref``, NaNs in the same places."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    _require(np.array_equal(np.isnan(got), np.isnan(ref)), "NaN pattern")
    fin = ~np.isnan(ref)
    return float(np.max(np.abs(got[fin].astype(np.float64) - ref[fin])
                        / np.spacing(np.abs(ref[fin]))))


def _subspace_gap(A, B):
    """||B − B Aᵀ A||_F in float64 for two row-orthonormal (k, p) bases:
    the root sum of squared sines of their principal angles (the rank-k
    projectors' Frobenius distance over √2), without the cancellation of
    2k − 2||A Bᵀ||²."""
    A, B = A.double(), B.double()
    return float(torch.linalg.matrix_norm(B - (B @ A.T) @ A))


def phase_slice8a(cube, angles_np, pcube, src):
    """Slice 8a at full width (1000x512² float32; see the module
    docstring, phase 19). Returns ({name: counts}, {name: seconds})."""
    import vip_tpu_torch
    from vip_tpu_torch import psfsub, stats
    from vip_tpu_torch.metrics import detection
    from vip_tpu_torch.ops import badpix
    from vip_tpu_torch.ops.linalg import svd
    from vip_tpu_torch.preproc import cosmetics, subsampling
    from vip_tpu_torch.stats import clip_sigma
    from vip_tpu_torch.var import (cube_filter_iuwt, frame_deconvolution,
                                   frame_filter_lowpass)

    t_phase = time.perf_counter()
    counts, times = {}, {}

    def record(name, fn):
        out, c, wall = _step(name, fn)
        _require(c["H3"] == c["H4"] == 0, f"{name}: launches {c}")
        # the counted run pays first-use costs (cuFFT plans, allocator
        # growth): the time kept is the warm median of S8A_REPS more
        counts[name], times[name] = c, _sync_time(fn, reps=S8A_REPS)
        print(f"slice 8a {name}: warm median of {S8A_REPS} "
              f"{times[name]:.4f} s", flush=True)
        return out

    # cube_correct_nan: the gathered route, its dense plain version, the
    # host loop on S8A_HOST_FRAMES frames
    dmg, frac = _damage(cube, 11)
    out, nnan, nits = record("cube_correct_nan", lambda:
                             cosmetics._correct_nan_frames(dmg, False))
    _require(counts["cube_correct_nan"]["H1"] == 0, "NaN filter launched H1")
    t0 = time.perf_counter()
    dense, dnits = badpix._sigma_filter_dense(dmg, torch.isnan(dmg), 3)
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    _require(torch.equal(out.nan_to_num(7.0), dense.nan_to_num(7.0))
             and torch.equal(nits, dnits),
             "cube_correct_nan: the route and its dense plain version "
             "differ")
    del dense
    host_ulps = 0.0
    for i in range(S8A_HOST_FRAMES):
        fr = dmg[i].cpu().numpy()
        ref = clip_sigma._sigma_filter_host(fr.copy(), np.isnan(fr))
        host_ulps = max(host_ulps, _ulps32(out[i].cpu().numpy(), ref))
        _, nit1 = badpix.sigma_filter_device(dmg[i], torch.isnan(dmg[i]))
        _require(int(nit1) == int(nits[i]), "sweeps of one frame alone")
    _require(host_ulps <= 1, f"cube_correct_nan: {host_ulps} ulps from the "
             f"host loop")
    _require(not torch.isnan(out).any(), "NaNs left")
    print(f"slice 8a cube_correct_nan: {frac * 100:.4f}% NaN pixels "
          f"({int(nnan.sum())}), sweeps {int(nits.min())}..{int(nits.max())}"
          f"; the dense plain version {t_dense:.4f} s, bit-equal, the same "
          f"sweeps; {S8A_HOST_FRAMES} frames within {host_ulps:.0f} ulp of "
          f"the host loop", flush=True)
    del out, dmg

    # clip_array with neighbours on one frame against the host route
    frame = pcube[0].clone()
    g = torch.Generator(device=DEVICE).manual_seed(12)
    hot = torch.rand(frame.shape, generator=g, device=DEVICE) < 1e-3
    frame[hot] += 8.0
    host = frame.cpu().numpy()
    gpm = np.ones(host.shape, bool)
    for mad in (False, True):
        idx = record(f"clip_array mad={mad}", lambda: stats.clip_array(
            frame, 3.0, 3.0, neighbor=True, num_neighbor=5, mad=mad))
        t0 = time.perf_counter()
        ref = np.where(clip_sigma._clip_neighbor_host(
            host, gpm, 3.0, 3.0, 2, 2, mad, None))
        t_host = time.perf_counter() - t0
        _require(all(np.array_equal(a, b) for a, b in zip(idx, ref)),
                 f"clip_array mad={mad}: indices differ from the host route")
        print(f"slice 8a clip_array mad={mad}: {idx[0].size} clipped, the "
              f"same indices as the host route ({t_host:.4f} s)", flush=True)

    # subsampling, kernels against the plain route
    pa = angles_np.astype(np.float64)
    sub_runs = {
        "cube_subsample mean": lambda: subsampling.cube_subsample(
            cube, S8A_WINDOW, "mean", parallactic=pa, verbose=False),
        "cube_subsample median": lambda: subsampling.cube_subsample(
            cube, S8A_WINDOW, "median", parallactic=pa, verbose=False),
        "cube_subsample trimmean": lambda: subsampling.cube_subsample(
            cube, S8A_WINDOW, "trimmean", parallactic=pa, verbose=False),
        "cube_subsample_trimmean": lambda: (subsampling.
                                            cube_subsample_trimmean(
                                                cube, 6, S8A_WINDOW), pa),
    }
    t_plain = {}
    for name, run in sub_runs.items():
        (got, ang) = record(name, run)
        with _plain_route():
            ref, ref_ang = run()
            t_plain[name] = _sync_time(run, reps=S8A_REPS)
        _require(torch.equal(got, ref) and np.array_equal(ang, ref_ang),
                 f"{name}: differs from the plain route")
        want = 1 if name.endswith("median") else 0
        _require(counts[name]["H1"] == want, f"{name}: {counts[name]}")
    print(f"slice 8a subsampling: every {S8A_WINDOW} frames, bit-equal to "
          f"the plain route; the plain route's warm median of "
          f"{S8A_REPS}: " + ", ".join(f"{k} {v:.4f} s"
                                      for k, v in t_plain.items()),
          flush=True)

    # IUWT of S8A_IUWT_FRAMES frames; frame 0 against the CPU float64 mode
    coeffs = record("cube_filter_iuwt", lambda: cube_filter_iuwt(
        pcube[:S8A_IUWT_FRAMES], coeff=5, full_output=True)[1])
    vip_tpu_torch.set_device("cpu")
    try:
        ref = cube_filter_iuwt(pcube[:1].cpu().double(), coeff=5,
                               full_output=True)[1]
    finally:
        vip_tpu_torch.set_device(DEVICE)
    err, scale = _rel_err(coeffs[0].cpu(), ref[0])
    _require(err <= S8A_F32_TOL * scale, f"IUWT {err:.3e}")
    print(f"slice 8a cube_filter_iuwt: {tuple(coeffs.shape)}, frame 0 "
          f"{err:.3e} from the CPU float64 mode (bound {S8A_F32_TOL:.0e} x "
          f"{scale:.3f})", flush=True)
    del coeffs

    # Richardson-Lucy against scipy in float64
    psf = _gaussian_psf(21)
    psf /= psf.sum()
    pos = pcube[0] - pcube[0].min() + 1.0
    dec = record("frame_deconvolution", lambda: frame_deconvolution(
        pos, psf, n_it=30))
    t0 = time.perf_counter()
    ref = _rl_scipy(pos.cpu().double().numpy(), psf, 30)
    t_host = time.perf_counter() - t0
    err = float(np.abs(dec.cpu().double().numpy() - ref).max()
                / np.abs(ref).max())
    _require(err <= S8A_DECONV_TOL, f"frame_deconvolution {err:.3e}")
    print(f"slice 8a frame_deconvolution: {err:.3e} of max|ref| from host "
          f"scipy in float64 ({t_host:.4f} s)", flush=True)

    # every distance of the frames to frame 0; the first S8A_HOST_FRAMES
    # against the CPU float64 mode
    for dist in ("sad", "euclidean", "mse", "pearson", "spearman", "ssim"):
        got = record(f"cube_distance {dist}", lambda: stats.cube_distance(
            cube, 0, dist=dist, plot=False))
        _require(got.shape == (N_FRAMES,) and bool(torch.isfinite(got).all()),
                 f"cube_distance {dist}")
        vip_tpu_torch.set_device("cpu")
        try:
            ref = stats.cube_distance(cube[:S8A_HOST_FRAMES].cpu().double(),
                                      0, dist=dist, plot=False)
        finally:
            vip_tpu_torch.set_device(DEVICE)
        err, scale = _rel_err(got[:S8A_HOST_FRAMES].cpu(), ref)
        _require(err <= S8A_F32_TOL * scale, f"cube_distance {dist}: "
                 f"{err:.3e} from the CPU float64 mode")
    print(f"slice 8a cube_distance: the 6 distances of {N_FRAMES} frames, "
          f"the first {S8A_HOST_FRAMES} within {S8A_F32_TOL:.0e} of the CPU "
          f"float64 mode", flush=True)

    # randomized_svd_gpu of a decaying spectrum: the noise cube plus a
    # rank-S8A_NCOMP structure from 10^S8A_SPECTRUM[0] down to
    # 10^S8A_SPECTRUM[1] times the noise's top singular value
    g = torch.Generator(device=DEVICE).manual_seed(13)
    M = cube.reshape(N_FRAMES, -1)
    Ul = torch.linalg.qr(torch.randn((N_FRAMES, S8A_NCOMP), generator=g,
                                     device=DEVICE))[0]
    Vl = torch.linalg.qr(torch.randn((M.shape[1], S8A_NCOMP), generator=g,
                                     device=DEVICE))[0]
    noise_top = np.sqrt(N_FRAMES) + np.sqrt(M.shape[1])
    s_l = torch.as_tensor(noise_top * np.logspace(*S8A_SPECTRUM, S8A_NCOMP),
                          dtype=M.dtype, device=DEVICE)
    M = M + (Ul * s_l) @ Vl.T
    del Ul, Vl
    U, S, Vh = record("randomized_svd_gpu", lambda: psfsub.randomized_svd_gpu(
        M, S8A_NCOMP, random_state=0))
    t0 = time.perf_counter()
    u, s, vh = svd(M)
    torch.cuda.synchronize()
    t_svd = time.perf_counter() - t0
    s_err = float(((S - s[:S8A_NCOMP]).abs() / s[:S8A_NCOMP]).max())
    v_gap = _subspace_gap(Vh, vh[:S8A_NCOMP])
    u_gap = _subspace_gap(U.T, u[:, :S8A_NCOMP].T)
    _require(s_err <= S8A_F32_TOL and max(v_gap, u_gap) <= S8A_F32_TOL,
             f"randomized_svd_gpu: singular values {s_err:.3e}, projectors "
             f"{v_gap:.3e}, {u_gap:.3e}")
    print(f"slice 8a randomized_svd_gpu {N_FRAMES}x{M.shape[1]} ncomp "
          f"{S8A_NCOMP}: singular values within {s_err:.3e}, the right and "
          f"left rank-{S8A_NCOMP} projectors {v_gap:.3e}, {u_gap:.3e} "
          f"(Frobenius) of ops.linalg.svd ({t_svd:.4f} s)", flush=True)
    del M, U, S, Vh, u, s, vh

    # pca(smooth=) against pca then the Gaussian low-pass; the companion
    smooth = record("pca smooth", lambda: psfsub.pca(
        pcube, angles_np, ncomp=NCOMP, smooth=2, verbose=False))
    base, base_counts, _ = _step("pca", lambda: psfsub.pca(
        pcube, angles_np, ncomp=NCOMP, verbose=False))
    _require(counts["pca smooth"] == base_counts,
             f"pca smooth launches {counts['pca smooth']} against "
             f"{base_counts}")
    err, scale = _rel_err(smooth, frame_filter_lowpass(base, mode="gauss",
                                                      fwhm_size=2))
    _require(err <= PIPE_TOL * scale, f"pca smooth: {err:.3e}")
    ys, xs = detection(smooth, fwhm=COMP_FWHM, mode="lpeaks", bkg_sigma=5,
                       snr_thresh=5, full_output=False, plot=False,
                       verbose=False)
    _require(_near(ys, xs, src), "pca smooth: the planted companion was "
             "missed")
    print(f"slice 8a pca smooth=2: {err:.3e} from pca then "
          f"frame_filter_lowpass; the companion found within 3 px",
          flush=True)

    # the star of an IFS-like cube made on the card
    star = record("approx_stellar_position", lambda: cosmetics.
                  approx_stellar_position(_star_cube(), 4.0,
                                          return_test=True))
    idx, test = star
    truth = _star_truth()
    good = ~np.isin(np.arange(S8A_STAR_Z), S8A_STAR_OUTLIERS)
    _require(np.abs(idx - truth).max() <= 1.0
             and not test[S8A_STAR_OUTLIERS].any() and test[good].all(),
             f"approx_stellar_position: {idx.tolist()} {test.tolist()}")
    print(f"slice 8a approx_stellar_position: {S8A_STAR_Z} channels within "
          f"1 px of the star, outliers {S8A_STAR_OUTLIERS} flagged and "
          f"replaced; the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts, times


def _star_truth():
    """The star's (y, x) in each channel: a chromatic drift of 0.2 px
    inside one pixel (the sigma clip of the peaks' pixels, whose spread
    is then 0, flags any other pixel)."""
    z = np.arange(S8A_STAR_Z)
    c = S8A_STAR_SIZE // 2
    return np.stack([c + 0.3 + 0.2 * z / S8A_STAR_Z,
                     c - 0.3 - 0.2 * z / S8A_STAR_Z], axis=1)


def _star_cube():
    """S8A_STAR_Z channels of a Gaussian star (FWHM 4 px, peak 1000)
    drifting as ``_star_truth`` over unit noise from a seeded generator,
    and a hot 3x3 patch far from the star in each outlier channel."""
    g = torch.Generator(device=DEVICE).manual_seed(14)
    n = S8A_STAR_SIZE
    q = torch.arange(n, device=DEVICE, dtype=torch.float32)
    t = torch.as_tensor(_star_truth(), dtype=torch.float32, device=DEVICE)
    two_sig2 = 2 * (4.0 / (2 * np.sqrt(2 * np.log(2)))) ** 2
    gy = torch.exp(-(q[None, :] - t[:, :1]) ** 2 / two_sig2)
    gx = torch.exp(-(q[None, :] - t[:, 1:]) ** 2 / two_sig2)
    cube = 1000 * gy[:, :, None] * gx[:, None, :] + torch.randn(
        (S8A_STAR_Z, n, n), generator=g, device=DEVICE)
    for k, z in enumerate(S8A_STAR_OUTLIERS):
        y0 = 10 + k * (n // 4)
        cube[z, y0:y0 + 3, 10:13] += 5000
    return cube


def _ifs_stages(cube, angles, scal):
    """The single and the double pass of phase 18 step by step at full
    depth, each step synchronized and timed once warm: where their time
    goes, without the profiler."""
    from vip_tpu_torch.ops.linalg import svd
    from vip_tpu_torch.preproc.cosmetics import cube_crop_frames
    from vip_tpu_torch.preproc.derotation import cube_derotate
    from vip_tpu_torch.preproc.rescaling import _scwave
    from vip_tpu_torch.preproc.subsampling import cube_collapse

    z, n, y, x = cube.shape

    def run(steps):
        out, times = None, {}
        for _ in range(2):               # the second pass is the warm one
            out = None
            for name, fn in steps:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(out)
                torch.cuda.synchronize()
                times[name] = time.perf_counter() - t0
        return times

    def project(m, qr, k):
        Q, R = qr
        Ur = svd(R)[0]
        V = (Q @ Ur)[..., :k].mT
        return m - (m @ V.mT) @ V

    st = {}
    single = run([
        ("rescale (39 batched zooms)", lambda _: cube_crop_frames(
            _scwave(cube, scal, collapse=None)[0], y, verbose=False)
         .transpose(0, 1).reshape(z * n, y * x)),
        ("QR of the (y*x, z*n) matrix", lambda m: (
            m, torch.linalg.qr(m.mT))),
        ("gesvd of R and project", lambda a: project(a[0], a[1],
                                                     IFS_NCOMP)),
        ("rescale back, channel mean", lambda r: _scwave(
            r.reshape(n, z, y, x).transpose(0, 1), scal, inverse=True,
            y_in=y, x_in=x, collapse="mean", keep_cube=False)[1]),
        ("derotate (H2)", lambda f: cube_derotate(f, angles)),
        ("median (H1)", lambda d: cube_collapse(d, mode="median")),
    ])
    st["single"] = single
    Y = _scwave(cube[:, :1], scal, collapse=None)[0].shape[-1]  # padded
    double = run([
        ("rescale (39 batched zooms)", lambda _: _scwave(
            cube, scal, collapse=None)[0]),
        ("QR of the 100 (Y*X, z) matrices", lambda r: (
            r.transpose(0, 1).reshape(n, z, -1),
            torch.linalg.qr(r.transpose(0, 1).reshape(n, z, -1).mT))),
        ("100 gesvd of R and project", lambda a: project(
            a[0], a[1], IFS_DOUBLE[0])),
        ("rescale back, channel mean", lambda r: _scwave(
            r.reshape(n, z, Y, Y).transpose(0, 1), scal, inverse=True,
            y_in=y, x_in=x, collapse="mean", keep_cube=False)[1]),
        ("ADI PCA (100, y*x)", lambda f: project(
            f.reshape(n, -1), torch.linalg.qr(f.reshape(n, -1).mT),
            IFS_DOUBLE[1]).reshape(n, y, x)),
        ("derotate (H2)", lambda f: cube_derotate(f, angles)),
        ("median (H1)", lambda d: cube_collapse(d, mode="median")),
    ])
    st["double"] = double
    for name, times in st.items():
        total = sum(times.values())
        print(f"ifs pca {name} pass by step (warm, synchronized, "
              f"{total:.4f} s in all): " + ", ".join(
                  f"{k} {v:.4f} s ({100 * v / total:.0f}%)"
                  for k, v in times.items()), flush=True)


# ----------------------------------------------------------------------
# Slice 8b (phase 20): registration and recentering, bad pixels, bad
# frames


def _step8b(name, fn, warm=True):
    """Run ``fn`` with the counts reset just before it, synchronized, and
    when it took under 1 s its warm median of 3: (result, counts, seconds).
    Prints one line."""
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    how = "once"
    if warm and wall < 1.0:
        wall, how = _sync_time(fn, reps=3), "warm median of 3"
    print(f"slice 8b {name}: {wall:.4f} s ({how}), launches H1 "
          f"{counts['H1']}, H2 {counts['H2']}", flush=True)
    return out, counts, wall


def _quiet(fn):
    """``fn`` with its standard output discarded (vip_tpu's routines print
    unconditionally)."""
    def run(*args, **kwargs):
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def _per_frame_route():
    """The plain version of each batched route of slice 8b, for a block:
    every ``cube_shift`` a loop of ``frame_shift``, every batched
    bad-pixel pass (isolated, clump, annulus, FFT fill) and the satellite
    spots' filters and stamps a loop over frames of the same function.
    (The Radon grid's plain version, a loop of ``_radon_costf``, and the
    IFS pair zooms', a loop of ``frame_rescaling``, are held to them
    apart.) With ``_plain_route`` it also takes the plain median."""
    from vip_tpu_torch.preproc import badpixremoval as bp
    from vip_tpu_torch.preproc import recentering as rc

    saved = {(rc, k): getattr(rc, k) for k in
             ("cube_shift", "_satspots_centroids")}
    saved.update({(bp, k): getattr(bp, k) for k in
                  ("_isolated_frames", "_clump_frames", "_ann_removal_frames",
                   "_fft_fill_frames")})

    def orig(mod, name):
        return saved[(mod, name)]

    def cube_shift(cube, shift_y, shift_x, imlib="vip-fft", *a, **k):
        n = cube.shape[0]
        sy = np.broadcast_to(np.asarray(shift_y, float), (n,))
        sx = np.broadcast_to(np.asarray(shift_x, float), (n,))
        return torch.stack([rc.frame_shift(cube[i], sy[i], sx[i], imlib=imlib)
                            for i in range(n)])

    def satspots(frames, xys, *args):
        outs = [orig(rc, "_satspots_centroids")(frames[i:i + 1], xys[i:i + 1],
                                                *args)
                for i in range(frames.shape[0])]
        return (torch.cat([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]),
                np.concatenate([o[2] for o in outs]))

    def isolated(frames, bpm, correct_only, sig, nn, size, protect, cys,
                 cxs, mad, ignore_nan, excl):
        outs = [orig(bp, "_isolated_frames")(
            frames[i:i + 1], None if bpm is None else bpm[i:i + 1],
            correct_only, sig, nn, size, protect, [cys[i]], [cxs[i]], mad,
            ignore_nan, excl[i:i + 1]) for i in range(frames.shape[0])]
        return tuple(torch.cat(o) for o in zip(*outs))

    def clump(frames, cys, cxs, fwhms, *args):
        sig, protect, seeds, excls = args[:4]
        outs = [orig(bp, "_clump_frames")(
            frames[i:i + 1], [cys[i]], [cxs[i]], [fwhms[i]], sig, protect,
            seeds[i:i + 1], excls[i:i + 1], *args[4:])
            for i in range(frames.shape[0])]
        return tuple(torch.cat(o) for o in zip(*outs))

    def annuli(frames, cys, cxs, fwhms, sig, protect, seeds, excls, *args):
        outs = [orig(bp, "_ann_removal_frames")(
            frames[i:i + 1], [cys[i]], [cxs[i]], [fwhms[i]], sig, protect,
            seeds[i:i + 1], excls[i:i + 1], *args)
            for i in range(frames.shape[0])]
        return tuple(torch.cat(o) for o in zip(*outs))

    def fft_fill(frames, masks, *args):
        outs = [orig(bp, "_fft_fill_frames")(frames[i:i + 1],
                                             masks[i:i + 1], *args)
                for i in range(frames.shape[0])]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]),
                np.concatenate([o[2] for o in outs]))

    patch = {(rc, "cube_shift"): cube_shift,
             (rc, "_satspots_centroids"): satspots,
             (bp, "_isolated_frames"): isolated, (bp, "_clump_frames"): clump,
             (bp, "_ann_removal_frames"): annuli,
             (bp, "_fft_fill_frames"): fft_fill}
    try:
        for (mod, name), fn in patch.items():
            setattr(mod, name, fn)
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def _s8b_star_template(stretch=1.0):
    """The NACO replica's Moffat star (``_moffat_psf``, FWHM S8B_FWHM) at
    the center of a SIZE² frame, optionally stretched along x, on the
    card."""
    size, fwhm = SIZE, S8B_FWHM
    c = size // 2
    psf = _moffat_psf(fwhm=fwhm)
    if stretch != 1.0:
        gamma = fwhm / (2.0 * np.sqrt(2.0 ** (1.0 / 2.5) - 1.0))
        yy, xx = np.mgrid[:39, :39].astype(np.float64) - 19.0
        psf = 1680.0 * (1.0 + (xx ** 2 / stretch ** 2 + yy ** 2)
                        / gamma ** 2) ** (-2.5)
    frame = torch.zeros((size, size), dtype=torch.float32, device=DEVICE)
    frame[c - 19:c + 20, c - 19:c + 20] = torch.as_tensor(psf,
                                                         dtype=torch.float32)
    return frame


def _s8b_shifted(template, jitter):
    """``template`` shifted to each (dy, dx) of ``jitter`` (n, 2) by
    ``fourier_shift_batch`` (pad margin 2), in chunks."""
    from vip_tpu_torch.ops.fft import fourier_shift_batch

    n = jitter.shape[0]
    out = torch.empty((n,) + tuple(template.shape), dtype=torch.float32,
                      device=DEVICE)
    for s in range(0, n, 200):
        e = min(n, s + 200)
        out[s:e] = fourier_shift_batch(template.expand(e - s, -1, -1),
                                       jitter[s:e, 0], jitter[s:e, 1], 2)
    return out


def _s8b_jitter(n, seed, amp=S8B_JITTER):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    j = (torch.rand((n, 2), generator=g, device=DEVICE) * 2 - 1) * amp
    return j.double().cpu().numpy()


def _s8b_hot(cube, seed):
    """A copy of ``cube`` with a static map of hot pixels (S8B_HOT of all,
    +S8B_HOT_VALUE, the same in every frame) and S8A_CLUMPS hot clumps of
    3x3 to 5x5 px a frame (+S8B_CLUMP_VALUE), made on the card from a
    seeded ``torch.Generator`` as ``_damage`` makes its NaNs. Returns the
    copy, the static map and the clump map (bool)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    n, ny, nx = cube.shape
    static = torch.rand((ny, nx), generator=g, device=DEVICE) < S8B_HOT
    out = cube + static * S8B_HOT_VALUE
    k = n * S8A_CLUMPS
    f = torch.arange(n, device=DEVICE).repeat_interleave(S8A_CLUMPS)
    y0 = torch.randint(0, ny - 4, (k,), generator=g, device=DEVICE)
    x0 = torch.randint(0, nx - 4, (k,), generator=g, device=DEVICE)
    side = torch.randint(3, 6, (k,), generator=g, device=DEVICE)
    d = torch.arange(5, device=DEVICE)
    keep = (d[None, :, None] < side[:, None, None]) \
        & (d[None, None, :] < side[:, None, None])
    fi = f[:, None, None].expand(-1, 5, 5)[keep]
    yi = (y0[:, None, None] + d[None, :, None]).expand(-1, 5, 5)[keep]
    xi = (x0[:, None, None] + d[None, None, :]).expand(-1, 5, 5)[keep]
    clumps = torch.zeros(cube.shape, dtype=torch.bool, device=DEVICE)
    clumps[fi, yi, xi] = True
    out[clumps] += S8B_CLUMP_VALUE
    return out, static, clumps


def _at(t0):
    """' (t+s s)': the seconds since ``t0``, for a phase's summary lines."""
    return f" (t+{time.perf_counter() - t0:.1f} s)"


def _recall(found, truth):
    """(recall, false positives) of a found map against a planted one."""
    found, truth = found.bool(), truth.bool()
    hit = int((found & truth).sum())
    return hit / max(int(truth.sum()), 1), int((found & ~truth).sum())


def _held(name, got, ref, tol=PIPE_TOL):
    """Frames of the batched route within ``tol`` of max(|ref|, 1) of the
    plain route's; maps equal. Returns the error."""
    err, scale = _rel_err(got, ref)
    _require(err <= tol * scale, f"{name}: {err:.3e} from the plain route "
             f"(scale {scale:.3e})")
    return err / scale


def phase_slice8b(cube):
    """Slice 8b at full width (see the module docstring, phase 20). Returns
    ({name: counts}, {name: seconds})."""
    from vip_tpu_torch.ops.registration import (dft_registration,
                                                dft_registration_batch,
                                                masked_register_translation)
    from vip_tpu_torch.ops.median import nanmedian_plain
    from vip_tpu_torch.preproc import badframes as bf
    from vip_tpu_torch.preproc import badpixremoval as bp
    from vip_tpu_torch.preproc import recentering as rc
    from vip_tpu_torch.preproc import rescaling
    from vip_tpu_torch.preproc.cosmetics import frame_crop

    t_phase = time.perf_counter()
    counts, times = {}, {}

    def record(name, fn, warm=True):
        out, c, wall = _step8b(name, fn, warm)
        _require(c["H3"] == c["H4"] == 0, f"{name}: launches {c}")
        counts[name], times[name] = c, wall
        return out

    n, c = cube.shape[0], SIZE // 2
    # --- registration on a jittered star cube
    jitter = _s8b_jitter(n, 12)
    star = _s8b_star_template()
    stars = cube + _s8b_shifted(star, jitter)

    def dft(k=n):
        return rc.cube_recenter_dft_upsampling(
            stars[:k], center_fr1=(c, c), upsample_factor=100, subi_size=9,
            fwhm=S8B_FWHM, full_output=True, verbose=False, plot=False)

    rec, y, x = record("cube_recenter_dft_upsampling", dft)
    _require(counts["cube_recenter_dft_upsampling"]["H1"] == 1,
             "dft_upsampling: H1 launches")
    err_truth = max(np.abs(y + jitter[:, 0]).max(),
                    np.abs(x + jitter[:, 1]).max())
    _require(err_truth <= S8B_SHIFT_TOL, f"dft_upsampling: shifts "
             f"{err_truth:.4f} px from the jitter")
    ref_f = torch.fft.fft2(stars[0])
    loop = torch.stack([dft_registration(ref_f, torch.fft.fft2(stars[i]), 100)
                        for i in range(1, S8B_LOOP_FRAMES + 1)])
    batch = dft_registration_batch(stars[0], stars[1:S8B_LOOP_FRAMES + 1], 100)
    reg_err = float((loop - batch).abs().max())
    _require(reg_err <= 0.01 + 1e-6, f"registration: the batch {reg_err} px "
             "from the per-frame loop")
    # the plain route on the first S8B_PLAIN_CUBE frames (the median
    # couples the frames: both routes run on that cube)
    rec, y, x = dft(S8B_PLAIN_CUBE)
    with _plain_route(), _per_frame_route():
        ref, ry, rx = dft(S8B_PLAIN_CUBE)
    e = _held("dft_upsampling", rec, ref)
    _require(max(np.abs(y - ry).max(), np.abs(x - rx).max()) <= S8B_FIT_TOL,
             "dft_upsampling: shifts differ from the plain route")
    print(f"slice 8b cube_recenter_dft_upsampling {n}x{SIZE}^2: shifts "
          f"within {err_truth:.4f} px of the jitter; the batched "
          f"registration within {reg_err:.4f} px of the per-frame loop on "
          f"{S8B_LOOP_FRAMES} frames; on {S8B_PLAIN_CUBE} frames, frames "
          f"{e:.3e} from the plain route{_at(t_phase)}", flush=True)
    del rec, ref

    nm = S8B_SUB_FRAMES
    yy, xx = np.mgrid[:SIZE, :SIZE]
    mask = (yy - c) ** 2 + (xx - c) ** 2 < S8B_MASK_RADIUS ** 2
    rec, my, mx = record("dft_upsampling mask", lambda: rc.
                         cube_recenter_dft_upsampling(
                             stars[:nm], mask=mask, full_output=True,
                             verbose=False, plot=False))
    rel = jitter[:nm] - jitter[0]
    err_m = max(np.abs(my + rel[:, 0]).max(), np.abs(mx + rel[:, 1]).max())
    _require(err_m <= 1.0, f"masked registration: {err_m} px")
    one = rc.cube_recenter_dft_upsampling(stars[:5], mask=mask,
                                          full_output=True, verbose=False,
                                          plot=False)
    _require(np.array_equal(one[1], my[:5]) and np.array_equal(one[2], mx[:5])
             and all(np.array_equal(masked_register_translation(
                 stars[0], stars[i], mask), [my[i], mx[i]])
                 for i in range(1, 5)),
             "masked registration: the batch differs from one frame at a time")
    print(f"slice 8b dft_upsampling mask (r < {S8B_MASK_RADIUS} px) "
          f"{nm} frames: integer shifts within {err_m:.3f} px of the jitter, "
          f"the batch equal to one frame at a time", flush=True)
    del rec

    for model, nf in (("gauss", n), ("moff", nm)):
        name = f"cube_recenter_2dfit {model}"
        run = lambda m=model, k=nf: rc.cube_recenter_2dfit(  # noqa: E731
            stars[:k], fwhm=S8B_FWHM, subi_size=9, model=m, full_output=True,
            verbose=False, plot=False)
        rec, fy, fx = record(name, run, warm=False)
        err = max(np.abs(fy + jitter[:nf, 0]).max(),
                  np.abs(fx + jitter[:nf, 1]).max())
        _require(err <= S8B_SHIFT_TOL, f"{name}: {err:.4f} px")
        msg = ""
        if model == "moff":
            with _plain_route(), _per_frame_route():
                ref = run()
            _require(np.abs(ref[1] - fy).max() <= S8B_FIT_TOL,
                     f"{name}: shifts")
            msg = f"; frames {_held(name, rec, ref[0]):.3e} from the plain " \
                "route"
        print(f"slice 8b {name} {nf} frames: shifts within {err:.4f} px of "
              f"the jitter{msg}{_at(t_phase)}", flush=True)
        del rec

    def speckles(k=n, src=stars, **kw):
        return rc.cube_recenter_via_speckles(
            src[:k], subframesize=S8B_SUBFRAME, alignment_iter=5,
            fwhm=S8B_FWHM, plot=False, full_output=True, **kw)

    # the float32 run through H1; the batched route against the per-frame
    # one in float64 on the card: in float32 a frame's registration peak
    # may move to a neighbouring point of the 0.01 px grid between the two
    speckles = _quiet(speckles)
    sp = record("cube_recenter_via_speckles", speckles, warm=False)
    stars64 = stars[:S8B_PLAIN_CUBE].double()
    sp64 = speckles(S8B_PLAIN_CUBE, src=stars64)
    with _plain_route(), _per_frame_route():
        sp_ref = speckles(S8B_PLAIN_CUBE, src=stars64)
    _require(counts["cube_recenter_via_speckles"]["H1"] == 5,
             "speckles: H1 launches")
    _require(np.array_equal(sp64[3], sp_ref[3])
             and np.array_equal(sp64[4], sp_ref[4]), "speckles: shifts")
    e = _held("speckles", sp64[0], sp_ref[0], S8B_F64_TOL)
    del sp64, sp_ref, stars64
    rel = jitter - jitter.mean(axis=0)
    off = np.median(sp[4] + rel[:, 0]), np.median(sp[3] + rel[:, 1])
    err_sp = max(np.abs(sp[4] + rel[:, 0] - off[0]).max(),
                 np.abs(sp[3] + rel[:, 1] - off[1]).max())
    print(f"slice 8b cube_recenter_via_speckles {n} frames (subframe "
          f"{S8B_SUBFRAME}, 5 iterations): cumulated shifts within "
          f"{err_sp:.4f} px of the jitter (up to a common offset "
          f"{off[0]:.3f}, {off[1]:.3f}); on {S8B_PLAIN_CUBE} frames in "
          f"float64 on the card, the same shifts and frames {e:.3e} from the "
          f"per-frame route{_at(t_phase)}", flush=True)
    _require(err_sp <= S8B_SHIFT_TOL, f"speckles: {err_sp:.4f} px")
    del sp

    record("speckles recenter_median ann", lambda: speckles(
        S8B_ANN_FRAMES, recenter_median=True, fit_type="ann",
        negative=False), warm=False)
    stamp = rc._host(stars[0, c - 11:c + 12, c - 11:c + 12])
    grid = np.arange(-2, 2, 0.01)
    fl = record("annulus grid 160000 points", lambda: rc._annulus_flux_grid(
        torch.as_tensor(stamp, device=DEVICE), grid, grid, [2.4], 2.4))
    coarse = np.arange(-2, 2, 0.1)
    g_b = rc._annulus_flux_grid(torch.as_tensor(stamp, device=DEVICE),
                                coarse, coarse, [2.4], 2.4)[0]
    from vip_tpu_torch.stats import frame_basic_stats

    g_p = np.array([[frame_basic_stats(rc.frame_shift(
        torch.as_tensor(stamp, device=DEVICE), yv, xv), "annulus",
        inner_radius=2.4, size=2.4, plot=False) for yv in coarse]
        for xv in coarse])
    g_p = np.maximum(g_p, 0)
    e = np.abs(g_b - g_p).max() / max(np.abs(g_p).max(), 1.0)
    _require(e <= PIPE_TOL, f"annulus grid: {e:.3e}")
    print(f"slice 8b annulus grid: {fl[0].size} points; the {coarse.size}² "
          f"grid {e:.3e} from the per-point loop{_at(t_phase)}", flush=True)

    # --- satellite spots and Radon
    ns = S8B_SAT_FRAMES
    d = S8B_SAT_SEP / np.sqrt(2)
    spot = _s8b_star_template()
    sat = torch.zeros_like(spot)
    for sy, sx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        sat += 0.1 * torch.roll(spot, (int(round(sy * d)), int(round(sx * d))),
                                dims=(0, 1))
    sjit = _s8b_jitter(ns, 13, 1.0)
    sats = cube[:ns] + _s8b_shifted(sat, sjit)
    xy = ((c - round(d), c - round(d)), (c + round(d), c - round(d)),
          (c - round(d), c + round(d)), (c + round(d), c + round(d)))

    def satspots():
        np.random.seed(12)
        return rc.cube_recenter_satspots(sats, xy, fit_type="moff",
                                         plot=False, verbose=False,
                                         full_output=True)

    srec = record("cube_recenter_satspots", satspots, warm=False)
    err_s = max(np.abs(srec[1] + sjit[:, 0]).max(),
                np.abs(srec[2] + sjit[:, 1]).max())
    _require(err_s <= S8B_SHIFT_TOL, f"satspots: {err_s:.4f} px")
    # the per-frame route on the first S8B_PLAIN_FRAMES frames (the same
    # first host draws)
    k = S8B_PLAIN_FRAMES
    with _plain_route(), _per_frame_route():
        np.random.seed(12)
        sref = rc.cube_recenter_satspots(sats[:k], xy, fit_type="moff",
                                         plot=False, verbose=False,
                                         full_output=True)
    _require(all(np.abs(a[:k] - b).max() <= S8B_FIT_TOL
                 for a, b in zip(srec[1:], sref[1:])),
             "satspots: the fits differ from the per-frame route")
    e = _held("satspots", srec[0][:k], sref[0])
    print(f"slice 8b cube_recenter_satspots {ns} frames: the spots' centre "
          f"within {err_s:.4f} px of the truth; on {k} frames, frames "
          f"{e:.3e} from the per-frame route{_at(t_phase)}", flush=True)

    def radon1():
        return rc.frame_center_radon(sats[0], cropsize=S8B_RADON_CROP,
                                     satspots_cfg="x",
                                     full_output=True, verbose=False,
                                     plot=False)

    @_quiet
    def radon(src):
        return rc.cube_recenter_radon(
            src[:S8B_RADON_FRAMES], full_output=True, verbose=False,
            cropsize=S8B_RADON_CROP, satspots_cfg="x")

    r1 = record("frame_center_radon", _quiet(radon1), warm=False)
    rr = record("cube_recenter_radon", lambda: radon(sats), warm=False)
    with _plain_route(), _per_frame_route():
        rr_ref = radon(sats)
    err_r = max(abs(r1[0] - c - sjit[0, 0]), abs(r1[1] - c - sjit[0, 1]))
    _require(np.array_equal(rr[1], rr_ref[1])
             and np.array_equal(rr[2], rr_ref[2]),
             "cube_recenter_radon: shifts differ from the per-frame route")
    e = _held("cube_recenter_radon", rr[0], rr_ref[0])
    err_rc = max(np.abs(rr[1] - sjit[:S8B_RADON_FRAMES, 0]).max(),
                 np.abs(rr[2] - sjit[:S8B_RADON_FRAMES, 1]).max())
    _require(max(err_r, err_rc) <= S8B_RADON_TOL,
             f"radon: {err_r:.3f} / {err_rc:.3f} px from the truth")
    print(f"slice 8b frame_center_radon (crop {S8B_RADON_CROP}, 'x'): "
          f"{err_r:.4f} px from "
          f"the truth; cube_recenter_radon {S8B_RADON_FRAMES} frames "
          f"{err_rc:.4f} px, frames {e:.3e} from the per-frame "
          f"route{_at(t_phase)}", flush=True)
    fr = frame_crop(sats[0], S8B_RADON_CROP, verbose=False)
    half = S8B_RADON_CROP // 2
    coords = [(a, b) for a in np.linspace(-1, 1, 21)
              for b in np.linspace(-1, 1, 21)]
    record("radon column-only cost 441 points", lambda: rc._radon_costs(
        fr, half, 0, coords, "x"))
    # against the full sinogram's row on a S8B_RADON_GRID² grid (a full
    # sinogram a point: 441 take seconds)
    g = np.linspace(-1, 1, S8B_RADON_GRID)
    coords = [(a, b) for a in g for b in g]
    col = rc._radon_costs(fr, half, 0, coords, "x")
    t0 = time.perf_counter()
    full = np.array([rc._radon_costf(fr, half, 0, co, "x") for co in coords])
    t_full = time.perf_counter() - t0
    e = np.abs(col - full).max() / np.abs(full).max()
    _require(e <= PIPE_TOL, f"radon cost: {e:.3e}")
    print(f"slice 8b radon cost grid {S8B_RADON_GRID}²: column-only {e:.3e} "
          f"from the full sinogram row (the full one {t_full:.4f} s)"
          f"{_at(t_phase)}", flush=True)
    del sats

    # --- bad pixels on the cube
    hot, static, clumps = _s8b_hot(cube, 14)
    truth = static[None] | clumps
    iso = record("cube_fix_badpix_isolated shared", lambda: bp.
                 cube_fix_badpix_isolated(hot, full_output=True,
                                          verbose=False))
    rcl, fp = _recall(iso[1], static)
    _require(rcl >= S8B_RECALL, f"isolated shared: recall {rcl}")
    with _plain_route(), _per_frame_route():
        iso_ref = bp.cube_fix_badpix_isolated(hot, full_output=True,
                                              verbose=False)
    _require(torch.equal(iso[1], iso_ref[1]), "isolated shared: maps")
    e = _held("isolated shared", iso[0], iso_ref[0])
    print(f"slice 8b cube_fix_badpix_isolated shared map {n} frames: "
          f"recall {rcl:.4f} of the static hot pixels, {fp} false "
          f"positives; frames {e:.3e} from the plain route{_at(t_phase)}",
          flush=True)
    del iso, iso_ref

    sub = hot[:nm]
    k = S8B_PLAIN_FRAMES
    thr = dict(min_thr=float(sub.min()) - 1, max_thr=float(sub.max()) - 1)
    for name, run in (
            ("cube_fix_badpix_isolated frame_by_frame", lambda f: bp.
             cube_fix_badpix_isolated(f, frame_by_frame=True,
                                      full_output=True, verbose=False)),
            ("cube_fix_badpix_clump", lambda f: bp.cube_fix_badpix_clump(
                f, full_output=True, verbose=False)),
            ("cube_fix_badpix_annuli", lambda f: (
                np.random.seed(12), bp.cube_fix_badpix_annuli(
                    f, S8B_FWHM, full_output=True, verbose=False,
                    **thr))[1])):
        out = record(name, lambda: run(sub), warm=False)
        # the per-frame loop on the first S8B_PLAIN_FRAMES frames
        with _plain_route(), _per_frame_route():
            ref = run(sub[:k])
        _require(torch.equal(out[1][:k].bool(), ref[1].bool()),
                 f"{name}: maps")
        e = _held(name, out[0][:k], ref[0])
        rcl, fp = _recall(out[1], truth[:nm])
        print(f"slice 8b {name} {nm} frames: recall {rcl:.4f} of the planted "
              f"hot pixels, {fp} false positives; on {k} frames, maps equal "
              f"and frames {e:.3e} from the per-frame route{_at(t_phase)}",
              flush=True)
    del out, ref

    nf = S8B_FFT_FRAMES
    bpm = truth[:nf]
    fft32 = record("cube_fix_badpix_interp fft", lambda: bp.
                   cube_fix_badpix_interp(hot[:nf], bpm, mode="fft", nit=500,
                                          tol=1), warm=False)
    kf = S8B_FFT64_FRAMES
    h64 = hot[:kf].double()
    res, _, its = bp._fft_fill_frames(h64, bpm[:kf], 500, 1, 2, False)
    with _per_frame_route():
        lres, _, lits = bp._fft_fill_frames(h64, bpm[:kf], 500, 1, 2, False)
    _require(np.array_equal(its, lits), f"fft: iterations {its} / {lits}")
    e64 = _held("fft float64", res, lres, S8B_F64_TOL)
    _require(bool(torch.isfinite(fft32).all()), "fft: not finite")
    print(f"slice 8b cube_fix_badpix_interp fft {nf}x{SIZE}^2 nit 500: "
          f"on {kf} frames in float64 on the card, iterations "
          f"{its.tolist()} and frames {e64:.3e} from the per-frame loop"
          f"{_at(t_phase)}", flush=True)
    del res, lres, h64
    gauss = record("cube_fix_badpix_interp gauss", lambda: bp.
                   cube_fix_badpix_interp(sub, truth[:nm], mode="gauss",
                                          fwhm=S8B_FWHM))
    gref = torch.stack([bp.cube_fix_badpix_interp(sub[i], truth[i],
                                                  mode="gauss",
                                                  fwhm=S8B_FWHM)
                        for i in range(k)])
    e = _held("interp gauss", gauss[:k], gref)
    print(f"slice 8b cube_fix_badpix_interp gauss {nm} frames: on {k} "
          f"frames {e:.3e} from the per-frame loop{_at(t_phase)}", flush=True)
    del gauss, gref, hot, sub

    star_ifs = _star_cube()
    lbdas = np.linspace(0.95, 1.35, S8A_STAR_Z)
    found = {}
    real_scal = rescaling.find_scal_vector

    def kept_scal(*a, **k):
        found["v"] = real_scal(*a, **k)
        return found["v"]

    rescaling.find_scal_vector = kept_scal
    try:
        ifs = record("cube_fix_badpix_ifs", _quiet(
            lambda: bp.cube_fix_badpix_ifs(star_ifs, lbdas, mad=True,
                                           full_output=True, verbose=False)),
            warm=False)
    finally:
        rescaling.find_scal_vector = real_scal
    _require(counts["cube_fix_badpix_ifs"]["H1"] == 1, "ifs: H1 launches")
    # the residuals against the plain median of the same batched zooms
    # (bit-equal) and of the per-pair frame_rescaling loop (the operator
    # and the FFT forms of a zoom round apart); the clump and isolated
    # passes on them are the per-frame routes held above
    z = S8A_STAR_Z

    def residuals(diffs):
        stack = diffs.permute(1, 0, 2, 3).reshape(z - 1, -1, S8A_STAR_SIZE)
        return nanmedian_plain(stack, 0, propagate=True).reshape(
            star_ifs.shape)

    res_same = residuals(bp._sdi_diffs_batched(star_ifs, *found["v"]))
    res_plain = residuals(bp._sdi_diffs_plain(star_ifs, *found["v"], None,
                                              "vip-fft", "lanczos4"))
    _require(torch.equal(ifs[2], res_same), "ifs: H1 residuals")
    e_res = _held("ifs residuals", ifs[2], res_plain)
    del res_same, res_plain
    patches = sum(bool(ifs[1][z, 10 + k * (S8A_STAR_SIZE // 4) + 1, 11])
                  for k, z in enumerate(S8A_STAR_OUTLIERS))
    print(f"slice 8b cube_fix_badpix_ifs {S8A_STAR_Z}x{S8A_STAR_SIZE}^2: "
          f"{patches}/{len(S8A_STAR_OUTLIERS)} hot patches flagged; the "
          f"residuals bit-equal to the plain median of the same zooms and "
          f"{e_res:.3e} from the per-pair frame_rescaling loop{_at(t_phase)}",
          flush=True)
    _require(patches == len(S8A_STAR_OUTLIERS), "ifs: hot patches missed")
    del ifs, star_ifs, stars

    # --- bad frames: the star at the center of every frame, then
    # S8B_BAD_FRAMES frames damaged: a third elongated, a third dimmed, a
    # third shifted by 4 px
    stride = n // S8B_BAD_FRAMES
    kinds = (np.arange(S8B_BAD_FRAMES) * stride + stride // 2).reshape(3, -1)
    dmg = cube + star
    dmg[kinds[0]] = cube[kinds[0]] + _s8b_star_template(stretch=2.0)
    dmg[kinds[1]] = cube[kinds[1]] + 0.3 * star
    dmg[kinds[2]] = cube[kinds[2]] + _s8b_shifted(
        star, np.tile([0.0, 4.0], (kinds.shape[1], 1)))
    hits = {}
    for name, run, want in (
            ("cube_detect_badfr_pxstats", lambda: bf.cube_detect_badfr_pxstats(
                dmg, mode="annulus", in_radius=2, width=6, top_sigma=3,
                low_sigma=3, plot=False, verbose=False), kinds[1]),
            ("cube_detect_badfr_ellipticity", lambda: bf.
             cube_detect_badfr_ellipticity(dmg, fwhm=S8B_FWHM, crop_size=30,
                                           plot=False, verbose=False),
             kinds[0]),
            ("cube_detect_badfr_correlation", lambda: bf.
             cube_detect_badfr_correlation(dmg, 0, crop_size=30,
                                           dist="pearson",
                                           percentile=100 * S8B_BAD_FRAMES
                                           / n,
                                           plot=False, verbose=False),
             np.r_[kinds[0], kinds[2]])):
        good, bad = record(name, run)
        got = set(bad.tolist())
        hits[name] = {k: len(got & set(kinds[i].tolist()))
                      for i, k in enumerate(("elongated", "dimmed",
                                             "shifted"))}
        _require(set(want.tolist()) <= got, f"{name}: {sorted(got)[:40]}")
        print(f"slice 8b {name}: {len(got)} flagged; hits {hits[name]} of "
              f"{kinds.shape[1]} each{_at(t_phase)}", flush=True)
    print(f"slice 8b: the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts, times


# ----------------------------------------------------------------------
# Slices 8c and 9 (phase 21): the interpolation imlibs, then the disks


def _step21(name, fn, warm=True, label="slice 8c/9"):
    """Run ``fn`` with the counts reset just before it, synchronized, and
    when it took under 1 s its warm median of 3: (result, counts,
    seconds). Prints one line, headed ``label``."""
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    how = "once"
    if warm and wall < 1.0:
        wall, how = _sync_time(fn, reps=3), "warm median of 3"
    print(f"{label} {name}: {wall:.4f} s ({how}), launches H1 "
          f"{counts['H1']}, H2 {counts['H2']}, H3 {counts['H3']}",
          flush=True)
    return out, counts, wall


def _s9_disk(dtype=torch.float64, flux_max=None):
    """Phase 21's disk model: ScatteredLightDisk at the cube's 512² with
    an HG phase function (see S9_*), computed on the card."""
    from vip_tpu_torch.fm import ScatteredLightDisk

    disk = ScatteredLightDisk(
        nx=SIZE, ny=SIZE, distance=S9_DIST, itilt=S9_ITILT,
        pxInArcsec=S9_PXSCALE, flux_max=flux_max,
        density_dico={'name': '2PowerLaws', 'ain': S9_AIN, 'aout': S9_AOUT,
                      'a': S9_A, 'e': 0., 'ksi0': 1., 'gamma': 2.,
                      'beta': 1., 'dens_at_r0': 1.},
        spf_dico={'name': 'HG', 'g': S9_G, 'polar': False})
    return disk.compute_scattered_light(halfNbSlices=S9_SLICES, dtype=dtype)


def phase_slice8c9(cube, angles_np):
    """Slices 8c and 9 at full width (see the module docstring, phase
    21). Returns ({name: counts}, {name: seconds})."""
    from vip_tpu_torch.fm import (chisquare_fd, cube_inject_fakedisk,
                                  firstguess_fd)
    from vip_tpu_torch.ops.fft import rotate_fft_batch, rotate_fft_small_plain
    from vip_tpu_torch.ops.pipeline import pca_adi_pipeline
    from vip_tpu_torch.preproc.derotation import (_prepad_placement,
                                                  cube_derotate, frame_rotate)
    from vip_tpu_torch.preproc.recentering import cube_shift, frame_shift
    from vip_tpu_torch.preproc.rescaling import cube_px_resampling

    t_phase = time.perf_counter()
    counts, times = {}, {}
    n = cube.shape[0]
    angles = torch.as_tensor(angles_np, device=DEVICE)
    four = cube[:S8C_LOOP_FRAMES]
    four64 = four.double()

    def record(name, fn, warm=True):
        out, c, wall = _step21(name, fn, warm)
        counts[name], times[name] = c, wall
        return out

    def against_loop(name, batched, loop, tol=S8C_LOOP_TOL):
        """The first frames of a batched warp against the per-frame calls
        of the same function on the card."""
        err, scale = _rel_err(batched[:S8C_LOOP_FRAMES], loop)
        _require(err <= tol * scale, f"{name}: {err:.3e} from its per-frame "
                 f"loop (scale {scale:.3e})")
        return err / scale

    # --- warps of the whole cube, each held to its per-frame loop and, in
    # float32, to the same call in float64 on the card
    warps = [("opencv", "lanczos4"), ("opencv", "bicubic"),
             ("opencv", "bilinear"), ("opencv", "nearneig"),
             ("skimage", "biquintic"), ("tpu-interp", "bicubic")]
    for imlib, intp in warps:
        name = f"cube_derotate {imlib} {intp}"
        kw = dict(imlib=imlib, interpolation=intp)
        out = record(name, lambda: cube_derotate(cube, angles, **kw))
        _require(tuple(out.shape) == tuple(cube.shape)
                 and bool(torch.isfinite(out).all()), f"{name}: output")
        loop = torch.stack([frame_rotate(four[i], -float(angles_np[i]), **kw)
                            for i in range(S8C_LOOP_FRAMES)]) \
            if imlib != "tpu-interp" else torch.cat(
                [cube_derotate(four[i:i + 1], angles[i:i + 1], **kw)
                 for i in range(S8C_LOOP_FRAMES)])
        e_loop = against_loop(name, out, loop)
        ref64 = cube_derotate(four64, angles[:S8C_LOOP_FRAMES].double(),
                              **kw)
        err, scale = _rel_err(out[:S8C_LOOP_FRAMES], ref64)
        _require(err <= S8C_F32_TOL * scale, f"{name}: float32 {err:.3e} "
                 f"from float64 on the card")
        print(f"slice 8c {name} {n}x{SIZE}^2: per-frame loop on the first "
              f"{S8C_LOOP_FRAMES} frames {e_loop:.3e}, float32 against "
              f"float64 on the card {err / scale:.3e}{_at(t_phase)}",
              flush=True)
        del out, loop, ref64

    # --- the main path of slice 8c: PCA-ADI with the interpolation
    # rotation, its median through H1, against the plain median
    frame = record("pca_adi_pipeline rot_mode=interp", lambda: pca_adi_pipeline(
        cube, angles, ncomp=NCOMP, rot_mode="interp"))
    _require(counts["pca_adi_pipeline rot_mode=interp"]["H1"] >= 1,
             "rot_mode=interp: H1 did not launch")
    with _plain_route():
        plain = pca_adi_pipeline(cube, angles, ncomp=NCOMP, rot_mode="interp")
    e_main = _held("rot_mode=interp", frame, plain)
    print(f"slice 8c pca_adi_pipeline rot_mode=interp ncomp {NCOMP}: "
          f"{e_main:.3e} from the plain median{_at(t_phase)}", flush=True)
    del frame, plain

    # --- shifts and resampling
    rng = np.random.default_rng(21)
    sy, sx = rng.uniform(-2.5, 2.5, (2, n))
    kw = dict(imlib="opencv", interpolation="lanczos4", border_mode="reflect")
    out = record("cube_shift opencv lanczos4", lambda: cube_shift(
        cube, sy, sx, **kw))
    loop = torch.stack([frame_shift(four[i], sy[i], sx[i], **kw)
                        for i in range(S8C_LOOP_FRAMES)])
    e_loop = against_loop("cube_shift opencv", out, loop)
    err, scale = _rel_err(out[:S8C_LOOP_FRAMES], cube_shift(
        four64, sy[:S8C_LOOP_FRAMES], sx[:S8C_LOOP_FRAMES], **kw))
    _require(err <= S8C_F32_TOL * scale, "cube_shift opencv: float64")
    print(f"slice 8c cube_shift opencv lanczos4 reflect {n} frames: "
          f"per-frame loop {e_loop:.3e}, float64 {err / scale:.3e}"
          f"{_at(t_phase)}", flush=True)
    del out, loop
    sub = cube[:S8C_HOST_FRAMES]
    out = record("cube_shift ndimage-interp biquintic", lambda: cube_shift(
        sub, sy[:S8C_HOST_FRAMES], sx[:S8C_HOST_FRAMES],
        imlib="ndimage-interp", interpolation="biquintic"), warm=False)
    _require(bool(torch.isfinite(out).all()), "ndimage-interp: output")
    print(f"slice 8c cube_shift ndimage-interp biquintic (host scipy) on the "
          f"first {S8C_HOST_FRAMES} frames: finite{_at(t_phase)}", flush=True)
    for scale_f in S8C_RESAMPLE:
        name = f"cube_px_resampling opencv x{scale_f}"
        out = record(name, lambda: cube_px_resampling(
            cube, scale_f, imlib="opencv", verbose=False))
        want = int(np.rint(SIZE * scale_f))
        _require(tuple(out.shape) == (n, want, want), f"{name}: shape")
        ref64 = cube_px_resampling(four64, scale_f, imlib="opencv",
                                   verbose=False)
        err, sc = _rel_err(out[:S8C_LOOP_FRAMES], ref64)
        _require(err <= S8C_F32_TOL * sc, f"{name}: float64")
        print(f"slice 8c {name}: {tuple(out.shape)}, float32 against float64"
              f" on the card {err / sc:.3e}{_at(t_phase)}", flush=True)
        del out, ref64

    # --- edge_blend: the blended 4x canvases rotate whole through
    # rotate_fft_batch, H3 on the card; the draws are handed in so that the
    # per-frame loop sees the same noise
    sub = cube[:S8C_HOST_FRAMES]
    ny_c, nx_c = _prepad_placement(SIZE, SIZE)[:2]
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    draws = torch.randn((S8C_HOST_FRAMES, ny_c, nx_c), generator=gen,
                        device=DEVICE)
    out = record("cube_derotate edge_blend noise+interp", lambda:
                 cube_derotate(sub, angles[:S8C_HOST_FRAMES],
                               edge_blend="noise+interp", draws=draws))
    c_blend = counts["cube_derotate edge_blend noise+interp"]
    _require(c_blend["H3"] >= 3, "edge_blend: H3 did not launch")
    loop = torch.stack([frame_rotate(sub[i], -float(angles_np[i]),
                                     edge_blend="noise+interp",
                                     draws=draws[i])
                        for i in range(S8C_LOOP_FRAMES)])
    e_loop = against_loop("edge_blend", out, loop, tol=ROT_TOL)
    # H3 against the plain batched rotate_fft on blended canvases
    canv = torch.zeros((S8C_LOOP_FRAMES, 4 * SIZE, 4 * SIZE), device=DEVICE)
    canv[:, 3 * SIZE // 2:5 * SIZE // 2, 3 * SIZE // 2:5 * SIZE // 2] = four
    a4 = -angles[:S8C_LOOP_FRAMES]
    err, scale = _rel_err(rotate_fft_batch(canv, a4),
                          rotate_fft_small_plain(canv, a4))
    _require(err <= ROT_TOL * scale, f"rotate_fft_batch H3: {err:.3e}")
    print(f"slice 8c edge_blend noise+interp {S8C_HOST_FRAMES} frames: "
          f"per-frame loop {e_loop:.3e}; rotate_fft_batch on {4 * SIZE}^2 "
          f"canvases through H3 {err / scale:.3e} from the plain version "
          f"(ROT_TOL {ROT_TOL}){_at(t_phase)}", flush=True)
    del out, loop, canv, draws

    # --- disks: the model at 512², float32 against float64 on the card
    disk64 = record(f"ScatteredLightDisk {SIZE}^2", lambda: _s9_disk())
    disk32 = _s9_disk(torch.float32)
    peak = float(disk64.max())
    e_disk = float((disk32.double() - disk64).abs().max()) / peak
    _require(peak > 0 and e_disk <= S9_DISK_TOL,
             f"disk map float32: {e_disk:.3e} of its peak")
    disk = (disk64 * (S9_PEAK / peak)).float()
    print(f"slice 9 ScatteredLightDisk {SIZE}^2 halfNbSlices {S9_SLICES}: "
          f"peak {peak:.4e}, float32 {e_disk:.3e} of the peak from float64"
          f"{_at(t_phase)}", flush=True)
    del disk32
    injected = record("cube_inject_fakedisk", lambda: cube_inject_fakedisk(
        disk, angles_np))
    _require(counts["cube_inject_fakedisk"]["H2"] >= 3,
             "cube_inject_fakedisk: H2 did not launch")
    mask = np.zeros((SIZE, SIZE), dtype=bool)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    r = np.hypot(yy - SIZE // 2, xx - SIZE // 2)
    mask[(r > S9_MASK[0]) & (r < S9_MASK[1])] = True
    dcube = cube + S9_FLUX * injected
    del injected
    opts = {"ncomp": NCOMP, "verbose": False}
    chi = record("chisquare_fd pca vip-fft", lambda: chisquare_fd(
        (S9_FLUX,), dcube, angles_np, disk, mask, (0.0, 0.0, 0.0, 1.0),
        (1, 1, 1, 1, 0), algo_options=opts, imlib="vip-fft"))
    c_chi = counts["chisquare_fd pca vip-fft"]
    _require(c_chi["H1"] >= 1 and c_chi["H2"] >= 3,
             f"chisquare_fd: launches {c_chi}")
    # at the planted flux the model cancels the disk: the χ² of the noise
    # cube alone, up to the float32 rounding of the subtraction
    chi_noise = chisquare_fd((0.0,), cube, angles_np, disk, mask,
                             (0.0, 0.0, 0.0, 1.0), (1, 1, 1, 1, 0),
                             algo_options=opts, imlib="vip-fft")
    chi0 = chisquare_fd((0.0,), dcube, angles_np, disk, mask,
                        (0.0, 0.0, 0.0, 1.0), (1, 1, 1, 1, 0),
                        algo_options=opts, imlib="vip-fft")
    _require(abs(chi - chi_noise) <= S9_CHI_TOL * chi_noise,
             f"chisquare_fd: {chi} at the planted flux, {chi_noise} of the "
             f"noise alone")
    print(f"slice 9 chisquare_fd {n}x{SIZE}^2 pca ncomp {NCOMP}: chi2r "
          f"{chi:.6f} at the planted flux, {chi_noise:.6f} of the noise "
          f"cube alone, {chi0:.6f} without the model{_at(t_phase)}",
          flush=True)
    del dcube
    every = cube[::S9_EVERY]
    a_every = angles_np[::S9_EVERY]
    fg_cube = every + S9_FLUX * cube_inject_fakedisk(disk, a_every)
    res = record("firstguess_fd skimage biquintic", lambda: firstguess_fd(
        fg_cube, a_every, disk, mask, f_range=np.geomspace(0.5, 10, 12),
        algo_options=opts, simplex_options=S9_SIMPLEX, verbose=False),
        warm=False)
    f0 = float(res[4])
    print(f"slice 9 firstguess_fd {fg_cube.shape[0]}x{SIZE}^2 (every "
          f"{S9_EVERY}-th frame; 'skimage' rotation, 'ndimage-interp' shift, "
          f"biquintic; grid of 12 fluxes, then a simplex of at most "
          f"{S9_SIMPLEX['maxfev']} evaluations): (x, y, theta, scal, f) = "
          + ", ".join(f"{float(v):.4f}" for v in res)
          + f", planted flux {S9_FLUX}{_at(t_phase)}", flush=True)
    _require(abs(f0 - S9_FLUX) < S9_FLUX_TOL * S9_FLUX,
             f"firstguess_fd: flux {f0} for {S9_FLUX}")
    del fg_cube
    print(f"slice 8c/9: the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return counts, times


def slice8c9_only():
    """Phase 21 alone (``--slice8c9``): the build, the noise cube, slices
    8c and 9, with torch.profiler tables of its two slowest steps."""
    from vip_tpu_torch.preproc.derotation import cube_derotate
    from vip_tpu_torch.preproc.recentering import cube_shift

    phase_device()
    phase_build()
    rng = np.random.default_rng(0)
    cube = torch.as_tensor(
        rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    angles_np = np.linspace(0.0, 80.0, N_FRAMES).astype(np.float32)
    counts, times = phase_slice8c9(cube, angles_np)
    print("launches: " + "; ".join(f"{k} {v}" for k, v in counts.items()),
          flush=True)
    angles = torch.as_tensor(angles_np, device=DEVICE)
    runs = {f"cube_derotate {i} {p}": (lambda i=i, p=p: cube_derotate(
        cube, angles, imlib=i, interpolation=p))
        for i, p in (("opencv", "lanczos4"), ("opencv", "bicubic"),
                     ("opencv", "bilinear"), ("opencv", "nearneig"),
                     ("skimage", "biquintic"), ("tpu-interp", "bicubic"))}
    runs["cube_shift opencv lanczos4"] = lambda: cube_shift(
        cube, 0.3, -1.7, imlib="opencv", border_mode="reflect")
    slowest = [k for k in sorted(times, key=times.get, reverse=True)
               if k in runs][:2]
    for name in slowest:
        with contextlib.redirect_stdout(sys.stderr):
            wall, table = _profile_table(runs[name])
        print(f"profile {name} {N_FRAMES}x{SIZE}x{SIZE}: {wall:.4f} s under "
              f"the profiler; top ops by device time:\n{table}", flush=True)
    others = [k for k in sorted(times, key=times.get, reverse=True)
              if k not in runs][:2]
    print("slowest steps without a profile table (host-bound or "
          "once-only): " + ", ".join(f"{k} {times[k]:.4f} s"
                                     for k in others), flush=True)


# Slice 10 (phase 22): the object layer and the native FITS codec


class _PlainDecodeHDU:
    """A lazy HDU read the way the port read it before the codec: each
    slice of frames decoded by the plain numpy decode into a new array,
    which ``pca_incremental`` then casts and copies into pinned memory."""

    def __init__(self, lazy):
        self.lazy, self.shape = lazy, lazy.shape

    def __getitem__(self, key):
        from vip_tpu_torch.fits import _native

        lo, hi, _ = key.indices(self.shape[0])
        hdu = self.lazy._hdu
        frame_bytes = int(np.prod(self.shape[1:])) * abs(hdu["bitpix"]) // 8
        return _native._decode_plain(
            self.lazy._path, hdu["offset"] + lo * frame_bytes,
            (hi - lo,) + tuple(self.shape[1:]), hdu["bitpix"], 1.0, 0.0,
            np.float32)


def _bits_equal(a, b):
    """Whether two float32 arrays or tensors hold the same bits."""
    a, b = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else
            np.asarray(x) for x in (a, b))
    return a.shape == b.shape and a.dtype == b.dtype \
        and np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _s10_codec(pcube, tmpdir):
    """The codec on the whole cube: ``write_fits`` (native encoder) and
    its data block against the plain encoder's bytes; ``open_fits``, the
    lazy HDU's slices and a decode into pinned memory against the plain
    decode, bit for bit; the native and plain encode and decode timed.
    Returns (path, lazy HDU, {name: seconds})."""
    from vip_tpu_torch.fits import _native, open_fits, write_fits
    from vip_tpu_torch.fits.fits import _scan_hdus

    host = pcube.cpu().numpy()
    path = os.path.join(tmpdir, "pcube.fits")
    times = {"write_fits": _timed(lambda: write_fits(path, host,
                                                     verbose=False))}
    hdu = _scan_hdus(path)[0]
    with open(path, "rb") as fh:
        fh.seek(hdu["offset"])
        block = np.frombuffer(fh.read(hdu["nbytes"]), np.uint8)
    t0 = time.perf_counter()
    plain_bytes = _native._encode_plain(host)
    times["encode plain"] = time.perf_counter() - t0
    _require(np.array_equal(block, plain_bytes),
             "write_fits: the data block is not the plain encoder's bytes")
    del block, plain_bytes
    times["encode"] = _sync_time(lambda: _native.encode(host))
    args = (path, hdu["offset"], hdu["shape"], hdu["bitpix"], 1.0, 0.0,
            np.float32)
    t0 = time.perf_counter()
    plain = _native._decode_plain(*args)
    times["decode plain"] = time.perf_counter() - t0
    _require(_bits_equal(plain, host), "the plain decode is not the cube")
    _require(_bits_equal(open_fits(path, verbose=False), plain),
             "open_fits differs from the plain decode")
    times["decode"] = _sync_time(lambda: _native.decode(*args))
    lazy = open_fits(path, return_memmap=True)
    for key in (slice(100, 300), slice(0, N_FRAMES, 7), N_FRAMES - 1):
        _require(_bits_equal(lazy[key], plain[key]),
                 f"the lazy HDU's [{key}] differs from the plain decode")
    lo = N_FRAMES // 2
    pinned = torch.empty((INC_BATCH, SIZE * SIZE), dtype=torch.float32,
                         pin_memory=True)
    lazy._read_frames(lo, lo + INC_BATCH, out=pinned)
    _require(pinned.is_pinned() and _bits_equal(
        pinned, plain[lo:lo + INC_BATCH].reshape(INC_BATCH, -1)),
        "the decode into pinned memory differs from the plain decode")
    gb = hdu["nbytes"] / 1e9
    print(f"slice 10 FITS codec, {N_FRAMES}x{SIZE}x{SIZE} float32 "
          f"({gb:.3f} GB): write_fits {times['write_fits']:.4f} s (once); "
          f"encode {times['encode']:.4f} s (warm median of 3), plain "
          f"{times['encode plain']:.4f} s (once); decode "
          f"{times['decode']:.4f} s (warm median of 3, "
          f"{gb / times['decode']:.2f} GB/s), plain "
          f"{times['decode plain']:.4f} s (once); the file's block, "
          f"open_fits, the lazy HDU's slices and the decode into pinned "
          f"memory bit-equal to the plain versions", flush=True)
    return path, lazy, times


def _s10_streamed(lazy, angles_np):
    """``pca_incremental`` of the FITS cube (phase 11's call) through the
    codec's decode into pinned memory and through the plain decode then a
    pinned copy (the route before the codec), in turns: the frames bit
    for bit equal. Returns {route: seconds}."""
    from vip_tpu_torch.psfsub.utils_pca import pca_incremental

    routes = {"codec into pinned memory": lazy,
              "numpy decode, pinned copy": _PlainDecodeHDU(lazy)}
    pca_incremental(lazy, angles_np, batch=INC_BATCH, ncomp=NCOMP,
                    verbose=False)                    # warm
    frames, times = {}, {}
    for route in (*routes, *reversed(routes)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame = pca_incremental(routes[route], angles_np, batch=INC_BATCH,
                                ncomp=NCOMP, verbose=False)
        torch.cuda.synchronize()
        times.setdefault(route, []).append(time.perf_counter() - t0)
        frames.setdefault(route, []).append(frame)
    first = frames["codec into pinned memory"][0]
    _require(all(np.array_equal(f, first) for fs in frames.values()
                 for f in fs), "pca_incremental: the routes' frames differ")
    print(f"slice 10 pca_incremental {N_FRAMES}x{SIZE}x{SIZE} from FITS, "
          f"batch {INC_BATCH} (two runs each, in turns): " + ", ".join(
              f"{k} " + " / ".join(f"{t:.4f}" for t in v) + " s"
              for k, v in times.items())
          + "; frames bit-equal",
          flush=True)
    return {k: float(np.mean(v)) for k, v in times.items()}


def phase_slice10(pcube, angles_np, src, tmpdir, refs=None):
    """Slice 10 at full width (see the module docstring, phase 22).
    ``refs``: phases 15's and 17's {name: (result, seconds)}, which the
    PP objects are held to; without them the same calls run here.
    Returns ({name: counts}, {name: seconds})."""
    from vip_tpu_torch import invprob as ip
    from vip_tpu_torch import psfsub
    from vip_tpu_torch.config.device import as_tensor
    from vip_tpu_torch.fm import cube_inject_companions
    from vip_tpu_torch.metrics import EvalRoc, detection
    from vip_tpu_torch.objects import (AndroBuilder, Dataset, FMMFBuilder,
                                       Frame, FrameDiffBuilder, LLSGBuilder,
                                       LOCIBuilder, MedianBuilder,
                                       NMFBuilder, PCABuilder, PPResult)

    t_phase = time.perf_counter()
    counts, times = {}, {}
    refs = {} if refs is None else refs

    def record(name, fn, warm=True):
        out, c, wall = _step21(name, fn, warm, label="slice 10")
        counts[name], times[name] = c, wall
        return out

    def held(name, got, ref):
        _require(_bits_equal(got, ref), f"slice 10 {name}: the object's "
                 f"frame is not its function's, bit for bit")

    path, lazy, t_codec = _s10_codec(pcube, tmpdir)
    times.update({f"FITS {k}": v for k, v in t_codec.items()})
    times.update({f"pca_incremental {k}": v for k, v in
                  _s10_streamed(lazy, angles_np).items()})
    print(f"slice 10: {time.perf_counter() - t_phase:.1f} s into the phase",
          flush=True)

    # the object layer at full width and depth
    ds = Dataset(cube=pcube, angles=angles_np, psf=_gaussian_psf(39),
                 fwhm=COMP_FWHM, px_scale=S10_PX_SCALE)
    _require(ds.cube is pcube and ds.psf.device == pcube.device,
             "Dataset: the cube was copied, or the PSF is not beside it")
    _quiet(ds.normalize_psf)(fit_fwhm=COMP_FWHM, verbose=False)
    _require(ds.psfn.device == pcube.device and ds.fwhm == COMP_FWHM,
             "normalize_psf: psfn not beside the cube, or another fwhm")
    pca_obj = PCABuilder(dataset=ds, ncomp=NCOMP, verbose=False).build()
    record("PPPCA classic", lambda: _quiet(pca_obj.run)(verbose=False))

    def pca_direct():
        return psfsub.pca(cube=ds.cube, angle_list=ds.angles, ncomp=NCOMP,
                          fwhm=ds.fwhm, full_output=True, verbose=False)

    held("PPPCA classic", pca_obj.frame_final,
         record("pca direct", pca_direct)[0])
    med_obj = MedianBuilder(dataset=ds, verbose=False).build()
    record("PPMedianSub", lambda: _quiet(med_obj.run)())

    def med_direct():
        return psfsub.median_sub(ds.cube, ds.angles, fwhm=ds.fwhm,
                                 full_output=True, verbose=False)

    held("PPMedianSub", med_obj.frame_final,
         record("median_sub direct", med_direct)[2])
    errs = {}
    with _plain_route():
        for name, obj, fn, i in (("PPPCA classic", pca_obj, pca_direct, 0),
                                 ("PPMedianSub", med_obj, med_direct, 2)):
            errs[name] = _rel_err(obj.frame_final, fn()[i])
    for name in ("PPPCA classic", "PPMedianSub"):
        c = counts[name]
        _require(c["H1"] >= 1 and c["H2"] >= 1 and c["H3"] == c["H4"] == 0,
                 f"slice 10 {name}: launches {c}")
        err, scale = errs[name]
        print(f"slice 10 {name}: bit-equal to its direct call; against the "
              f"plain route {err:.3e} (bound {PIPE_TOL:.0e} x {scale:.3f})",
              flush=True)
        _require(err <= PIPE_TOL * scale, f"slice 10 {name}: plain route")

    # S/N map, significance and blob detection; the sessions to FITS
    results = PPResult()
    pca_obj.results = med_obj.results = results
    _quiet(pca_obj.run)(verbose=False)
    record("make_snrmap", lambda: _quiet(pca_obj.make_snrmap)(), warm=False)
    _quiet(pca_obj.compute_significance)(source_xy=src)
    cy, cx = int(src[1]), int(src[0])
    fr = _quiet(Frame)(pca_obj.frame_final, fwhm=ds.fwhm)
    fr.detect_blobs(ds.psfn, bkg_sigma=5, plot=False, full_output=False)
    ys, xs = fr.detection_results
    found = _near(ys, xs, src)
    print(f"slice 10 PPPCA classic: S/N at the companion "
          f"{float(pca_obj.snr_map[cy, cx]):.3f}, significance "
          f"{pca_obj.signf:.3f} sigma; Frame.detect_blobs (y, x) "
          f"{list(zip(np.atleast_1d(ys).tolist(), np.atleast_1d(xs).tolist()))}"
          f", planted at {(src[1], src[0])}: found {found}", flush=True)
    _require(found and pca_obj.signf > 3, "slice 10: the companion missed")
    _quiet(med_obj.run)()
    fits = os.path.join(tmpdir, "sessions.fits")
    _quiet(results.results_to_fits)(fits)
    back = PPResult(load_from_path=fits)
    _require(len(back.sessions) == len(results.sessions) == 2
             and all(_bits_equal(b.frame, r.frame)
                     and b.algo_name == r.algo_name
                     for b, r in zip(back.sessions, results.sessions))
             and _bits_equal(back.sessions[0].snr_map,
                             results.sessions[0].snr_map)
             and back.sessions[1].snr_map is None,
             "PPResult: the FITS round trip changed the sessions")
    print(f"slice 10 PPResult: {len(back.sessions)} sessions "
          f"({', '.join(s.algo_name for s in back.sessions)}) through FITS "
          f"and back, frames and S/N map bit-equal", flush=True)

    # the other run modes
    grid_obj = PCABuilder(dataset=ds, range_pcs=GRID_PCS,
                          verbose=False).build()
    record("PPPCA grid", lambda: _quiet(grid_obj.run)(runmode="grid",
                                                      verbose=False))
    grid = record("pca_grid direct", lambda: psfsub.pca_grid(
        ds.cube, ds.angles, fwhm=ds.fwhm, range_pcs=GRID_PCS, plot=False,
        full_output=True, verbose=False))
    held("PPPCA grid", grid_obj.final_residuals_cube, grid[0])
    ann_obj = PCABuilder(dataset=ds, ncomp=NCOMP,
                         annulus_width=S10_ANNULUS_WIDTH, r_guess=COMP_SEP,
                         verbose=False).build()
    record("PPPCA annulus", lambda: _quiet(ann_obj.run)(runmode="annulus",
                                                        verbose=False))
    held("PPPCA annulus", ann_obj.frame_final, record(
        "pca_annulus direct", lambda: psfsub.pca_annulus(
            ds.cube, ds.angles, NCOMP, S10_ANNULUS_WIDTH, COMP_SEP)))
    peak = np.unravel_index(int(ann_obj.frame_final.argmax()), (SIZE, SIZE))
    _require(_near([peak[0]], [peak[1]], src),
             f"PPPCA annulus: the frame's peak {peak} is not the companion")
    annular = {k: v for k, v in ANN.items() if k != "fwhm"}
    annular_obj = PCABuilder(dataset=ds, verbose=False, **annular).build()
    record("PPPCA annular", lambda: _quiet(annular_obj.run)(
        runmode="annular", verbose=False), warm=False)
    held("PPPCA annular", annular_obj.frame_final, record(
        "pca_annular direct", lambda: psfsub.pca_annular(
            ds.cube, ds.angles, fwhm=ds.fwhm, full_output=True,
            verbose=False, **annular), warm=False)[2])
    annular_obj.cube_residuals = annular_obj.cube_residuals_der = None
    print(f"slice 10 PPPCA grid ({GRID_PCS[0]}..{GRID_PCS[1]}), annulus "
          f"(r {COMP_SEP:.0f}, {S10_ANNULUS_WIDTH} px; peak at (y, x) "
          f"{tuple(int(v) for v in peak)}) and annular (phase 14's annuli, "
          f"'vip-fft'): bit-equal to their direct calls"
          f"{_at(t_phase)}", flush=True)

    # the six other PP classes on phases 15's and 17's cuts, annular NMF,
    # LLSG and LOCI on fewer of their frames
    crop, crop5, ang5, crop10, ang10, pos5 = _slice4_cuts(
        pcube, angles_np, S10_SLICE4_EVERY, S10_LOCI_EVERY)
    sub = ("nmf_annular", "llsg", "xloci")
    cube_fw, angs_fw, psf20, fmmf_fw, comp = _invprob_full_width(
        pcube, angles_np)

    def data(cube, angles, psfn=None):
        return Dataset(cube=cube, angles=angles, psfn=psfn, fwhm=COMP_FWHM,
                       px_scale=S10_PX_SCALE)

    fmmf_kw = dict(fmmf_fw, min_r=INV_FW_WINDOW[0], max_r=INV_FW_WINDOW[1])
    andro_kw = dict(oversampling_fact=2, iwa=2, opt_method="lsq",
                    verbose=False)
    # (phase key, builder, dataset, keywords, run keywords, the function,
    # the result's (frame, S/N map) indices or None for a frame)
    pp = [
        ("nmf", NMFBuilder, data(pcube, angles_np), NMF4, {},
         lambda: psfsub.nmf(pcube, angles_np, verbose=False, **NMF4), None),
        ("nmf_annular", NMFBuilder, data(pos5, ang5), NMF_ANN4,
         dict(runmode="annular"), lambda: psfsub.nmf_annular(
             pos5, ang5, verbose=False, **NMF_ANN4), None),
        ("llsg", LLSGBuilder, data(crop5, ang5), LLSG4, {},
         lambda: psfsub.llsg(crop5, ang5, verbose=False, **LLSG4), None),
        ("frame_diff", FrameDiffBuilder, data(crop, angles_np), FD4, {},
         lambda: psfsub.frame_diff(crop, angles_np, verbose=False, **FD4),
         None),
        ("xloci", LOCIBuilder, data(crop10, ang10), LOCI4, {},
         lambda: psfsub.xloci(crop10, ang10, verbose=False, **LOCI4), None),
        ("andromeda full width", AndroBuilder,
         data(cube_fw, angs_fw, psf20), andro_kw, {},
         lambda: ip.andromeda(cube=cube_fw, angle_list=angs_fw, psf=psf20,
                              **andro_kw), (0, 2)),
        ("fmmf full width", FMMFBuilder,
         data(cube_fw, angs_fw, psf20 / psf20.sum()), fmmf_kw, {},
         lambda: ip.fmmf(cube=cube_fw, angle_list=angs_fw,
                         psf=psf20 / psf20.sum(), **fmmf_kw), (0, 1)),
    ]
    for key, builder, dset, kw, run_kw, fn, pick in pp:
        obj = builder(dataset=dset, **dict(kw, verbose=False)).build()
        name = f"{type(obj).__name__} ({key})"
        record(name, lambda: _quiet(obj.run)(**run_kw), warm=False)
        if key in refs and key not in sub:
            ref, t_ref = refs[key]
            where = "its phase's"
        else:
            t0 = time.perf_counter()
            ref = fn()
            torch.cuda.synchronize()
            t_ref, where = time.perf_counter() - t0, "this phase's"
        if pick is None:
            held(name, obj.frame_final, _last_and_first(ref)[0])
        else:
            held(name, obj.frame_final, ref[pick[0]])
            held(name + " S/N", obj.snr_map, ref[pick[1]])
        line = (f"slice 10 {name}: bit-equal to {where} function call "
                f"({t_ref:.4f} s)")
        if key == "nmf":
            ys, xs = detection(obj.frame_final, fwhm=COMP_FWHM,
                               mode="lpeaks", bkg_sigma=5, snr_thresh=5,
                               full_output=False, plot=False, verbose=False)
            line += f"; companion detected: {_near(ys, xs, src)}"
            _require(_near(ys, xs, src), f"{name}: the companion missed")
        elif pick is not None:
            hit = _found(obj.snr_map, COMP_FWHM, comp)
            line += f"; companion at {comp} found: {hit}"
            _require(hit, f"{name}: the companion missed")
        print(line + _at(t_phase), flush=True)

    # EvalRoc on every S10_EVERY-th frame; one injection at full depth
    roc_ds = Dataset(cube=pcube[::S10_EVERY].contiguous(),
                     angles=angles_np[::S10_EVERY], psf=ds.psfn,
                     fwhm=COMP_FWHM, px_scale=S10_PX_SCALE)
    roc = EvalRoc(roc_ds, plsc=S10_PX_SCALE, n_injections=S10_ROC_INJECTIONS,
                  dist_flux=S10_ROC_FLUX)
    roc.add_algo("pca", PCABuilder(dataset=roc_ds, ncomp=NCOMP,
                                   verbose=False).build(), "r", "o",
                 list(S10_ROC_THRESH))
    roc.add_algo("medsub", MedianBuilder(dataset=roc_ds,
                                         verbose=False).build(), "b", "^",
                 list(S10_ROC_THRESH))
    record("EvalRoc inject_and_postprocess", lambda: _quiet(
        roc.inject_and_postprocess)(rng=np.random.RandomState(10)),
        warm=False)
    t0 = time.perf_counter()
    _quiet(roc.compute_tpr_fps)()
    times["EvalRoc compute_tpr_fps"] = time.perf_counter() - t0
    i3 = S10_ROC_THRESH.index(3)
    dets = {m["name"]: [int(d[i3]) for d in m["detections"]]
            for m in roc.methods}
    found = [any(dets[k][i] for k in dets) for i in range(roc.n_injections)]
    print(f"slice 10 EvalRoc ({roc_ds.n}x{SIZE}^2, {roc.n_injections} "
          f"injections; compute_tpr_fps on the host "
          f"{times['EvalRoc compute_tpr_fps']:.4f} s; fluxes {np.round(roc.fluxes, 1).tolist()} at "
          f"{[round(float(d), 1) for d in roc.dists]} px, CEVR 0.9 -> "
          f"{int(roc.optpcs)} PCs): detections at threshold 3 {dets}; "
          f"false positives at 3 "
          f"{ {m['name']: [int(f[i3]) for f in m['fps']] for m in roc.methods} }"
          f"{_at(t_phase)}", flush=True)
    _require(all(found), "EvalRoc: an injection was found in no map")
    record("cube_inject_companions full depth", lambda: as_tensor(
        cube_inject_companions(pcube, ds.psfn, angles_np, flevel=100,
                               rad_dists=[30], plsc=S10_PX_SCALE, theta=45),
        device=pcube.device, dtype=pcube.dtype), warm=False)

    # Dataset.save / load on the first frames
    ds_save = Dataset(cube=pcube[:S10_SAVE_FRAMES].contiguous(),
                      angles=angles_np[:S10_SAVE_FRAMES], psf=ds.psf,
                      psfn=ds.psfn, fwhm=ds.fwhm, px_scale=S10_PX_SCALE)
    ds_save.injections_yx = [(src[1], src[0])]
    npz = os.path.join(tmpdir, "dataset")
    times["Dataset.save"] = _timed(lambda: ds_save.save(npz))
    t0 = time.perf_counter()
    loaded = Dataset.load(npz)
    times["Dataset.load"] = time.perf_counter() - t0
    _require(all(getattr(loaded, k).device == pcube.device
                 and _bits_equal(getattr(loaded, k), getattr(ds_save, k))
                 for k in ("cube", "psf", "psfn"))
             and np.array_equal(loaded.angles, ds_save.angles)
             and loaded.fwhm == ds_save.fwhm and loaded.cuberef is None
             and [tuple(p) for p in loaded.injections_yx]
             == ds_save.injections_yx
             and (loaded.n, loaded.y, loaded.x) == (S10_SAVE_FRAMES, SIZE,
                                                    SIZE),
             "Dataset: the save/load round trip changed it")
    print(f"slice 10 Dataset.save / load of {S10_SAVE_FRAMES}x{SIZE}^2: "
          f"{times['Dataset.save']:.4f} s / {times['Dataset.load']:.4f} s "
          f"(once), {os.path.getsize(npz + '.npz') / 1e6:.1f} MB; the cube "
          f"back on the card, bit-equal", flush=True)
    print(f"slice 10 cuts: EvalRoc on every {S10_EVERY}th frame "
          f"({roc_ds.n} of {N_FRAMES}); the six other PP classes on "
          f"phases 15's and 17's cuts (annular NMF and LLSG on every "
          f"{S10_SLICE4_EVERY}th frame of the central {SLICE4_CROP}^2 and "
          f"LOCI on every {S10_LOCI_EVERY}th, each held to its function on "
          f"the same frames; frame differencing on all frames of it, "
          f"ANDROMEDA and FMMF on every {INV_EVERY}th frame of the central "
          f"{INV_SIZE}^2); Dataset.save on the first {S10_SAVE_FRAMES}; the "
          f"phase took {time.perf_counter() - t_phase:.1f} s on {_card()}",
          flush=True)
    return counts, times


def slice10_only():
    """Phase 22 alone (``--slice10``): the build, the cube with the
    planted companion, slice 10 (the PP classes' functions run here)."""
    phase_device()
    phase_build()
    rng = np.random.default_rng(0)
    cube = torch.as_tensor(
        rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    angles_np = np.linspace(0.0, 80.0, N_FRAMES).astype(np.float32)
    pcube, src = _plant_companion(cube, angles_np)
    del cube
    with tempfile.TemporaryDirectory() as tmpdir:
        counts, _ = phase_slice10(pcube, angles_np, src, tmpdir)
    print("launches: " + "; ".join(f"{k} {v}" for k, v in counts.items()),
          flush=True)


def _s11_negfc_inputs(pcube, angles_np):
    """Phase 16's cut (every NEGFC_EVERY-th frame of the cube with the
    planted companion), its normalized PSF, S11_WALKERS walkers about the
    truth, the likelihood's arguments and the MCMC's draws (seed 23)."""
    from vip_tpu_torch.fm import normalize_psf

    ncube = pcube[::NEGFC_EVERY].contiguous()
    nangs = angles_np[::NEGFC_EVERY].astype(np.float64)
    psfn = normalize_psf(_gaussian_psf(), fwhm=COMP_FWHM, verbose=False)
    rng = np.random.default_rng(23)
    truth = np.array([COMP_SEP, 0.0, 2.0 * np.pi * COMP_PEAK])
    walkers = truth + rng.uniform(-1, 1, (S11_WALKERS, 3)) * [0.5, 0.5, 1.0]
    bounds = [(COMP_SEP - 2, COMP_SEP + 2), (-5.0, 5.0), (0.0, 50.0)]
    lnp_args = (ncube, nangs, psfn, 1, 8, COMP_SEP, 0.0, 1, COMP_FWHM, 0.0,
                1.0, bounds)
    half = S11_MCMC_WALKERS // 2
    table = [(rng.random(half), rng.integers(0, half, half),
              rng.random(half)) for _ in range(2 * S11_MCMC_STEPS)]
    mcmc = dict(kind="mcmc", cube=ncube, angles=nangs, psfn=psfn,
                initial_state=(COMP_SEP, 360.0, float(truth[2])),
                draws_table=table, nwalkers=S11_MCMC_WALKERS,
                niteration_min=S11_MCMC_STEPS,
                niteration_limit=S11_MCMC_STEPS, conv_test="gb",
                verbosity=0)
    return walkers, lnp_args, mcmc


def _s11_err(label, name, got, ref):
    """The worst error of the arrays of ``got`` (an array, a tuple or a
    dict of columns) against ``ref``'s, of max(|ref|, 1); raises on a
    shape that differs or a value that is not finite."""
    if isinstance(got, dict):
        pairs = [(got[k], ref[k]) for k in ref]
    elif isinstance(got, tuple):
        pairs = list(zip(got, ref))
    else:
        pairs = [(got, ref)]
    worst = 0.0
    for g, r in pairs:
        g, r = torch.as_tensor(np.asarray(g)), torch.as_tensor(np.asarray(r))
        _require(g.shape == r.shape and bool(torch.isfinite(g).all()),
                 f"slice 11 {label} {name}: shape {tuple(g.shape)} (want "
                 f"{tuple(r.shape)}) or values not finite")
        err, scale = _rel_err(g, r)
        worst = max(worst, err / scale)
    return worst


def phase_slice11(cube, angles_np, pcube, ifs, tmpdir, refs=None):
    """Slice 11, several devices (see the module docstring, phase 23):
    (a) NCCL at world size 1 at full width, each sharded entry point
    against its single-device counterpart; (b) S11_RANKS gloo ranks on
    cuda:0, started first so that they reach the card while (a) runs and
    computing once it has ended, each entry point against world size 1
    on the same inputs.
    ``ifs``: phase 18's (cube, angles, scale_list); ``refs``: phase 12's
    contrast columns under "contrast" (computed here without it).
    Returns ({name: counts}, {name: seconds})."""
    import torch.distributed as dist

    from vip_tpu_torch.config import frame_mesh
    from vip_tpu_torch.dryrun import entry_points, run_ranks
    from vip_tpu_torch.fits import write_fits
    from vip_tpu_torch.fm import mcmc_negfc_sampling
    from vip_tpu_torch.metrics import snrmap_fast
    from vip_tpu_torch.metrics.contrcurve import _contrast_curve
    from vip_tpu_torch.ops.negfc_model import make_batched_lnprob
    from vip_tpu_torch.ops.pipeline import (median_adi_pipeline,
                                            pca_adi_pipeline)
    from vip_tpu_torch.psfsub import pca, pca_annular
    from vip_tpu_torch.psfsub.utils_pca import pca_incremental

    refs = {} if refs is None else refs
    t_phase = time.perf_counter()
    counts, times = {}, {}
    ifs_cube, ifs_angles, scal = ifs
    walkers, lnp_args, mcmc = _s11_negfc_inputs(pcube, angles_np)
    # phase 12's contrast curve (its PSF is phase 16's)
    psfn = lnp_args[2]
    cc_kw = dict(nbranch=1, fc_rad_sep=3, fc_snr=100, student=True,
                 plot=False, verbose=False, **CC_ALGO)
    cc = dict(psf=psfn, fwhm=COMP_FWHM, pxscale=CC_PXSCALE,
              starphot=CC_STARPHOT, **cc_kw)

    # (b)'s inputs to files, and its ranks started: they share the card
    # with this process, so the card gets back the blocks earlier phases
    # left in this process's cache
    torch.cuda.empty_cache()
    b, (zb, nb), cb, ci = S11_B_FRAMES, S11_B_SDI, S11_B_CC_CROP, \
        S11_B_INC64_CROP
    c0, c1 = (SIZE - cb) // 2, (SIZE - ci) // 2
    files = {}
    for key, arr in (("cube", cube[:b]), ("ann", cube[:b:S11_ANN_EVERY]),
                     ("ifs", ifs_cube[:zb, :nb]), ("negfc", mcmc["cube"]),
                     ("cc", cube[:b, c0:c0 + cb, c0:c0 + cb]),
                     ("inc64", cube[:b, c1:c1 + ci, c1:c1 + ci])):
        files[key] = os.path.join(tmpdir, f"s11_{key}.npy")
        np.save(files[key], arr.contiguous().cpu().numpy())
    ang_b = angles_np[:b]
    sdi_b = dict(kind="sdi", cube=files["ifs"], angles=ifs_angles[:nb],
                 scal_list=scal[:zb], ncomp=IFS_NCOMP, crop_ifs=True)
    specs_b = {
        "pca_adi": dict(kind="pca_adi", cube=files["cube"], angles=ang_b,
                        ncomp=NCOMP),
        "pca_adi median": dict(kind="pca_adi", cube=files["cube"],
                               angles=ang_b, ncomp=NCOMP, collapse="median"),
        "median_adi": dict(kind="median_adi", cube=files["cube"],
                           angles=ang_b),
        "pca_annular": dict(kind="pca_annular", cube=files["ann"],
                            angles=angles_np[:b:S11_ANN_EVERY], **S11_ANN),
        "snrmap": dict(kind="snrmap", frame=cube[0].cpu().numpy(),
                       fwhm=COMP_FWHM),
        "contrast": dict(cc, kind="contrast", cube=files["cc"],
                         angles=ang_b),
        "incremental": dict(kind="incremental", cube=files["cube"],
                            angles=ang_b, batch=INC_BATCH, ncomp=NCOMP),
        "incremental float64": dict(kind="incremental",
                                    cube=files["inc64"], angles=ang_b,
                                    batch=INC_BATCH, ncomp=NCOMP,
                                    float64=True),
        "lnprob": dict(kind="lnprob", walkers=walkers,
                       args=(files["negfc"],) + lnp_args[1:], kwargs={}),
        "mcmc": dict(mcmc, cube=files["negfc"]),
        "sdi": sdi_b,
        "sdi float64": dict(sdi_b, float64=True),
    }
    print(f"slice 11 (b) cuts: {b} of {N_FRAMES} frames (the annular PCA on "
          f"every {S11_ANN_EVERY}th of them, the contrast curve on their "
          f"central {cb}² pixels, the streamed PCA's float64 twin on the "
          f"central {ci}²), the SDI on {zb} of {ifs_cube.shape[0]} "
          f"channels and {nb} of {ifs_cube.shape[1]} frames; inputs written "
          f"in {time.perf_counter() - t_phase:.2f} s", flush=True)
    t_b = time.perf_counter()
    # this process keeps to S11_MAIN_MEMORY of the card while the ranks run
    torch.cuda.set_per_process_memory_fraction(S11_MAIN_MEMORY)
    # the ranks start now (~8 s each to reach the card) and wait for (a)
    # to end before they compute: four processes time-slicing the card
    # with (a)'s kernels ran both slower (the phase 66.0 s against (a)'s
    # 34.4 s, on an H100 80GB HBM3 at 700 W)
    go = multiprocessing.get_context("spawn").Event()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    spawned = pool.submit(run_ranks, "entry_points", S11_RANKS,
                          backend="gloo", device="cuda:0", args=(specs_b,),
                          timeout=S11_B_TIMEOUT, wait_for=go)
    try:
        # (a) full width, world size 1
        t0 = time.perf_counter()
        mesh = frame_mesh()
        _require(dist.get_backend(mesh.get_group()) == "nccl"
                 and mesh.size() == 1, "slice 11: not a one-rank NCCL mesh")
        print(f"slice 11 (a): a one-rank NCCL group on "
              f"{torch.cuda.current_device()} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        fits_path = os.path.join(tmpdir, "s11.fits")
        write_fits(fits_path, cube.cpu().numpy(), verbose=False)
        # the SDI pass in float64 on every S11_SDI64_EVERY-th frame
        ifs64 = ifs_cube[:, ::S11_SDI64_EVERY].double()
        ifs_angles64 = ifs_angles[::S11_SDI64_EVERY]
        specs = {
            "pca_adi": dict(kind="pca_adi", cube=cube, angles=angles_np,
                            ncomp=NCOMP),
            "pca_adi median": dict(kind="pca_adi", cube=cube,
                                   angles=angles_np, ncomp=NCOMP,
                                   collapse="median"),
            "median_adi": dict(kind="median_adi", cube=cube,
                               angles=angles_np),
            "pca_annular": dict(kind="pca_annular",
                                cube=cube[::S11_ANN_EVERY].contiguous(),
                                angles=angles_np[::S11_ANN_EVERY],
                                **S11_ANN),
            "contrast": dict(kind="contrast", cube=cube, angles=angles_np,
                             **cc),
            "incremental": dict(kind="incremental", cube=fits_path,
                                angles=angles_np, batch=INC_BATCH,
                                ncomp=NCOMP),
            "lnprob": dict(kind="lnprob", walkers=walkers, args=lnp_args,
                           kwargs={}),
            "mcmc": mcmc,
            "sdi": dict(kind="sdi", cube=ifs_cube, angles=ifs_angles,
                        scal_list=scal, ncomp=IFS_NCOMP, crop_ifs=True),
            "sdi float64": dict(kind="sdi", cube=ifs64,
                                angles=ifs_angles64, scal_list=scal,
                                ncomp=IFS_NCOMP, crop_ifs=True),
        }
        res = entry_points(dict(list(specs.items())[:4]))
        res.update(entry_points({"snrmap": dict(
            kind="snrmap", frame=res["pca_adi median"]["out"],
            fwhm=COMP_FWHM)}))
        res.update(entry_points(dict(list(specs.items())[4:])))
        cc_ref = refs.get("contrast")
        if cc_ref is None:
            cc_ref = _contrast_curve(cube, angles_np, psfn, COMP_FWHM,
                                     CC_PXSCALE, CC_STARPHOT, pca,
                                     **cc_kw)[0]
        mcmc_kw = {k: v for k, v in mcmc.items()
                   if k not in ("kind", "cube", "angles", "psfn",
                                "initial_state", "draws_table")}
        table = mcmc["draws_table"]
        single = {
            "pca_adi": lambda: pca_adi_pipeline(
                cube, angles_np, ncomp=NCOMP, method="eigen",
                collapse="mean"),
            "pca_adi median": lambda: pca_adi_pipeline(
                cube, angles_np, ncomp=NCOMP, method="eigen",
                collapse="median"),
            "median_adi": lambda: median_adi_pipeline(cube, angles_np),
            "pca_annular": lambda: pca_annular(
                specs["pca_annular"]["cube"], specs["pca_annular"]["angles"],
                svd_mode="eigen", verbose=False, **S11_ANN),
            "snrmap": lambda: snrmap_fast(res["pca_adi median"]["out"],
                                          COMP_FWHM),
            "incremental": lambda: pca_incremental(
                fits_path, angles_np, batch=INC_BATCH, ncomp=NCOMP,
                verbose=False),
            "sdi": lambda: pca(
                ifs_cube, ifs_angles, scale_list=scal, ncomp=IFS_NCOMP,
                adimsdi="single", crop_ifs=True, svd_mode="eigen",
                verbose=False),
            "sdi float64": lambda: pca(
                ifs64, ifs_angles64, scale_list=scal, ncomp=IFS_NCOMP,
                adimsdi="single", crop_ifs=True, svd_mode="eigen",
                verbose=False),
            "lnprob": lambda: make_batched_lnprob(*lnp_args)(walkers),
            "mcmc": lambda: mcmc_negfc_sampling(
                mcmc["cube"], mcmc["angles"], mcmc["psfn"],
                mcmc["initial_state"],
                draws=lambda s, h, ns0, n1: table[2 * s + h], **mcmc_kw),
            "contrast": lambda: cc_ref,
        }
        tols = {"sdi": S11_SDI_F32_TOL, "contrast": 1e-4, "lnprob": 0.0,
                "mcmc": 0.0}
        fails = []       # every comparison prints before the phase fails

        def held(label, name, err, tol):
            if err > tol:
                fails.append(f"{label} {name}: {err:.3e} of max(|ref|, 1) "
                             f"(bound {tol:.1e})")

        for name, r in res.items():
            if name == "device":
                continue
            counts[name], times[name] = r["counts"], r["s"]
            t0 = time.perf_counter()
            ref = single[name]()
            t_ref = time.perf_counter() - t0
            if isinstance(ref, torch.Tensor):
                ref = ref.cpu().numpy()
            err = _s11_err("(a)", name, r["out"], ref)
            held("(a)", name, err, tols.get(name, PIPE_TOL))
            print(f"slice 11 (a) {name}: {r['s']:.4f} s, launches "
                  f"{r['counts']}; against its single-device call "
                  f"{err:.3e} of max(|ref|, 1) (bound "
                  f"{tols.get(name, PIPE_TOL):.1e}; the call {t_ref:.4f} s)",
                  flush=True)
        for name in ("pca_adi median", "median_adi", "pca_annular",
                     "incremental", "sdi", "lnprob", "mcmc"):
            _require(counts[name]["H1"] > 0 and counts[name]["H2"] > 0,
                     f"slice 11 (a) {name}: launches {counts[name]}")
        t_a = time.perf_counter() - t_phase
        del ifs64

        # (b): the ranks, and world size 1 here on their inputs
        go.set()
        one = entry_points(specs_b)
        ranks = spawned.result()
    finally:
        go.set()
        pool.shutdown(wait=True)
        torch.cuda.set_per_process_memory_fraction(1.0)
        if dist.is_initialized():
            dist.destroy_process_group()
    t_b = time.perf_counter() - t_b
    _require(all(r["device"] == "cuda:0" for r in ranks),
             f"slice 11 (b): ranks on {[r['device'] for r in ranks]}")
    # the streamed PCA's merge sums its Grams in another order than one
    # Gram: S11_INC_F32_TOL in float32, Q33_TOL for its float64 twin
    tols_b = {"sdi float64": Q33_TOL, "incremental": S11_INC_F32_TOL,
              "incremental float64": Q33_TOL}
    for name in specs_b:
        for r in ranks[1:]:
            held("(b) ranks", name, _s11_err("(b) ranks", name,
                                              r[name]["out"],
                                              ranks[0][name]["out"]), 0.0)
        err = _s11_err("(b)", name, ranks[0][name]["out"], one[name]["out"])
        held("(b)", name, err, tols_b.get(name, PIPE_TOL))
        h = {k: sum(r[name]["counts"][k] for r in ranks)
             for k in ("H1", "H2", "H3", "H4", "K5", "subspace")}
        slow = max(r[name]["s"] for r in ranks)
        print(f"slice 11 (b) {name}: {slow:.4f} s on the slowest of "
              f"{S11_RANKS} ranks (world size 1: {one[name]['s']:.4f} s), "
              f"launches over the ranks {h}; against world size 1 "
              f"{err:.3e} of max(|ref|, 1) (bound "
              f"{tols_b.get(name, PIPE_TOL):.1e})", flush=True)
        times[f"(b) {name}"] = slow
    _require(not fails, "slice 11: " + "; ".join(fails))
    total = {k: sum(c[k] for c in counts.values())
             for k in ("H1", "H2", "H3", "H4", "K5", "subspace")}
    print(f"slice 11: (a) {t_a:.1f} s, with (b)'s {S11_RANKS} ranks "
          f"starting beside it; (b) from the spawn to the last rank's result "
          f"{t_b:.1f} s; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s; launches of (a) {total}",
          flush=True)
    return counts, times


def slice11_only():
    """Phase 23 alone (``--slice11``): the build, the cube with the
    planted companion, phase 18's sequence, slice 11 (phase 12's contrast
    curve runs here)."""
    phase_device()
    phase_build()
    rng = np.random.default_rng(0)
    cube = torch.as_tensor(
        rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    angles_np = np.linspace(0.0, 80.0, N_FRAMES).astype(np.float32)
    pcube, _ = _plant_companion(cube, angles_np)
    ifs_cube, ifs_angles, scal, _, _ = _ifs_cube()
    with tempfile.TemporaryDirectory() as tmpdir:
        counts, _ = phase_slice11(cube, angles_np, pcube,
                                  (ifs_cube, ifs_angles, scal), tmpdir)
    print("launches: " + "; ".join(f"{k} {v}" for k, v in counts.items()),
          flush=True)


def phase_slice12(cube):
    """Slice 12 (see the module docstring, phase 24): the last public
    functions of vip_tpu's modules on the main path's cube, each float32
    call on the card against the same call in float64 on the card, each
    step's synchronized wall time on its own line beside the card's name
    and power limit. Returns {step: seconds}."""
    from vip_tpu_torch.config.parallel import tree_to_numpy
    from vip_tpu_torch.fits import _native
    from vip_tpu_torch.ops.linalg import svd_top
    from vip_tpu_torch.preproc.derotation import tensor_rotate_fft
    from vip_tpu_torch.psfsub.pca_fullfr import get_pca_coeffs

    head = f"slice 12 (card: {_card()})"
    times = {}

    def step(name, fn):
        out, _, times[name] = _step21(name, fn, warm=False, label=head)
        return out

    def held(name, got, ref):
        got, ref = torch.as_tensor(got), torch.as_tensor(ref)
        _require(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                 f"slice 12 {name}: shape {tuple(got.shape)} (want "
                 f"{tuple(ref.shape)}) or values not finite")
        err, scale = _rel_err(got, ref)
        print(f"slice 12 {name}: max abs err vs float64 on the card "
              f"{err:.3e}; bound {PIPE_TOL:.0e} x {scale:.3f}", flush=True)
        _require(err <= PIPE_TOL * scale,
                 f"slice 12 {name}: float32 disagrees with float64")
        return err / scale

    n = cube.shape[0]
    # phase 7's PCs: the main path's eigh of the frames' Gram matrix
    pcs = svd_top(cube.reshape(n, -1), NCOMP, method="eigen")
    coeffs = step(f"get_pca_coeffs {n}x{SIZE}^2 ncomp {NCOMP} float32",
                  lambda: get_pca_coeffs(cube, pcs, NCOMP, verbose=False))
    cube64 = cube.double()
    ref = step(f"get_pca_coeffs {n}x{SIZE}^2 ncomp {NCOMP} float64",
               lambda: get_pca_coeffs(cube64, pcs.double(), NCOMP,
                                      verbose=False))
    del cube64
    _require(coeffs.shape == (NCOMP, n), f"get_pca_coeffs: shape "
             f"{coeffs.shape}, want {(NCOMP, n)}")
    worst = {"get_pca_coeffs": held("get_pca_coeffs", coeffs, ref)}

    rotated = {}
    for size in (SIZE, SIZE - 1):
        frame = cube[:1, :size, :size].contiguous()
        frame64 = frame.double()
        for angle in S12_ANGLES:
            label = f"tensor_rotate_fft {size}^2 at {angle:g} deg"
            got = step(f"{label} float32",
                       lambda: tensor_rotate_fft(frame, angle))
            ref = step(f"{label} float64",
                       lambda: tensor_rotate_fft(frame64, angle))
            _require(got.dtype == torch.float32 and got.is_cuda
                     and tuple(got.shape) == (1, size, size),
                     f"{label}: {got.dtype} {tuple(got.shape)} on "
                     f"{got.device}")
            worst[label] = held(label, got, ref)
            rotated[(size, angle)] = got

    tree = {"coeffs": pcs[:, :8], "frames": [rotated[(SIZE, 30.0)],
            (rotated[(SIZE - 1, 135.0)], "odd", SIZE - 1)], "none": None}
    host = step("tree_to_numpy", lambda: tree_to_numpy(tree))
    _require(isinstance(host["coeffs"], np.ndarray)
             and isinstance(host["frames"][1], tuple)
             and host["frames"][1][1:] == ("odd", SIZE - 1)
             and host["none"] is None, "tree_to_numpy: structure changed")
    for got, t in ((host["coeffs"], tree["coeffs"]),
                   (host["frames"][0], tree["frames"][0]),
                   (host["frames"][1][0], tree["frames"][1][0])):
        _require(isinstance(got, np.ndarray)
                 and np.array_equal(got, t.cpu().numpy()),
                 "tree_to_numpy: a leaf differs from its tensor")
    ok = step("fits._native.available", _native.available)
    _require(ok is True, "fits._native.available() is not True")
    print("slice 12: worst error of max(|ref|, 1): " + ", ".join(
        f"{k} {v:.3e}" for k, v in worst.items()), flush=True)
    return times


def slice12_only():
    """Phase 24 alone (``--slice12``): the build and slice 12 on the main
    path's cube."""
    phase_device()
    phase_build()
    rng = np.random.default_rng(0)
    cube = torch.as_tensor(
        rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    _phase(24, "slice 12", phase_slice12, cube)


# K5: (batch, rows) of its R factors, the double pass's and the NACO
# replica's
JACOBI_SHAPES = ((100, 39), (1, 61))


def _jacobi_bound(batch, n, sweeps):
    """K5's (bound_ms, bound_by) on ``batch`` n x n float32 matrices that
    took ``sweeps`` sweeps (a list), by :func:`_bound`: the float32
    operations at the float32 peak and the bytes (the matrix in, U, S and
    Vh out). Each sweep visits the n (n - 1) / 2 pairs; every visit forms
    three dot products of n (6 n); every visit of a sweep but the last,
    which rotates nothing, also rotates two columns of n and two of the
    rotations (12 n). Late sweeps rotate fewer pairs, so this overcounts
    the rotations, and the bound errs high."""
    pairs = n * (n - 1) // 2
    flop = pairs * n * (6 * sum(sweeps) + 12 * (sum(sweeps) - batch))
    return _bound(batch * 4 * (3 * n * n + n), flop)


def phase_jacobi():
    """Phase 25 (see the module docstring): K5 at each of JACOBI_SHAPES.
    Returns {(batch, n): (kernel ms, (bound ms, bound by), plain ms,
    gesvd ms, largest absolute error of the singular values against the
    plain version's)}."""
    from vip_tpu_torch.ops import linalg

    head = f"K5 (card: {_card()})"
    out = {}

    def ms(fn, reps):
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

    for batch, n in JACOBI_SHAPES:
        g = torch.Generator(device=DEVICE).manual_seed(n)
        M = torch.randn((batch, 50 * n, n), generator=g, device=DEVICE)
        M = M * torch.logspace(2, -2, n, device=DEVICE)
        R = torch.linalg.qr(M)[1]
        del M
        linalg.jacobi_launches = 0
        U, S, Vh, info = linalg.svd_jacobi(R, with_info=True)
        _require(linalg.jacobi_launches == 1,
                 f"K5 ({batch}, {n}, {n}): {linalg.jacobi_launches} "
                 f"launches, want 1")
        Up, Sp, Vhp, infop = linalg.svd_jacobi_plain(R, with_info=True)
        Ug, Sg, Vhg = torch.linalg.svd(R, full_matrices=False,
                                       driver="gesvd")
        sweeps = info.tolist()
        _require(min(sweeps) > 0 and int(infop.min()) > 0,
                 f"K5 ({batch}, {n}, {n}): a matrix did not converge "
                 f"(kernel {min(sweeps)}, plain {int(infop.min())})")
        s_err = float(((S - Sp).abs() / S[:, :1]).max())
        p_err = max(float((X @ X.mT - Y @ Y.mT).abs().max())
                    for X, Y in ((U[..., :5], Up[..., :5]),
                                 (Vh[:, :5].mT, Vhp[:, :5].mT)))
        R64 = R.double()

        def rec(U, S, Vh):
            return float(((U.double() * S.double()[:, None]) @ Vh.double()
                          - R64).abs().max() / R64.abs().max())

        s64 = torch.linalg.svd(R64).S
        print(f"{head} ({batch}, {n}, {n}): sweeps {min(sweeps)}-"
              f"{max(sweeps)}; singular values vs plain {s_err:.3e}, top-5 "
              f"projectors vs plain {p_err:.3e}; reconstruction "
              f"{rec(U, S, Vh):.3e} (gesvd {rec(Ug, Sg, Vhg):.3e}); "
              f"singular values vs float64 "
              f"{float(((S - s64).abs() / s64[:, :1]).max()):.3e} (gesvd "
              f"{float(((Sg - s64).abs() / s64[:, :1]).max()):.3e})",
              flush=True)
        _require(s_err <= 1e-6 and p_err <= 1e-4,
                 f"K5 ({batch}, {n}, {n}): kernel and plain version differ")
        t_k = ms(lambda: linalg.svd_jacobi(R), 10)
        t_p = ms(lambda: linalg.svd_jacobi_plain(R), 3)
        t_g = ms(lambda: torch.linalg.svd(R, full_matrices=False,
                                          driver="gesvd"), 3)
        bound = _jacobi_bound(batch, n, sweeps)
        print(f"timing {head} ({batch}, {n}, {n}): kernel {t_k:.3f} ms "
              f"(bound {bound[0]:.4f} ms by {bound[1]}, {t_k / bound[0]:.0f}"
              f"x; {sum(sweeps) / batch:.1f} sweeps of {n + n % 2 - 1} "
              f"steps a matrix), plain {t_p:.3f} ms, gesvd loop "
              f"{t_g:.3f} ms", flush=True)
        out[(batch, n)] = (t_k, bound, t_p, t_g,
                           float((S - Sp).abs().max()))
    return out


def jacobi_only():
    """Phase 25 alone (``--jacobi``): the build and K5."""
    phase_device()
    phase_build()
    _phase(25, "K5", phase_jacobi)


def _phase(number, name, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, then one line with the phase's wall time
    (the card synchronized)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    print(f"phase {number} ({name}) wall time: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


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
    _incr_float64(fwhm, meta["angles"], golden, cube32, errs, errs_cpu)
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


def _incr_float64(fwhm, angles, golden, cube32, errs, errs_cpu):
    """Q3-3: the F2 configuration pca_incr_adi in float64 on the card
    (a float64 tensor keeps its precision there) against the CPU's
    float64 run of the same float32-rounded cube, within Q33_TOL of
    max(|ref|, 1); each beside the golden."""
    import vip_tpu_torch
    import vip_tpu_torch.psfsub as tps

    kw = dict(angle_list=angles, fwhm=fwhm, verbose=False, batch=30)
    t0 = time.perf_counter()
    card = tps.pca(cube=torch.as_tensor(cube32, dtype=torch.float64,
                                        device=DEVICE), **kw)
    wall = time.perf_counter() - t0
    vip_tpu_torch.set_device("cpu")
    try:
        cpu = tps.pca(cube=torch.as_tensor(cube32, dtype=torch.float64),
                      **kw)
    finally:
        vip_tpu_torch.set_device(DEVICE)
    gold = np.load(os.path.join(golden, "pca_incr_adi.npy"))
    err = float(np.abs(card - cpu).max()) / max(float(np.abs(cpu).max()),
                                                1.0)
    print(f"Q3-3 pca_incr_adi float64 on the card ({wall:.4f} s): "
          f"{err:.3e} of max(|ref|, 1) from the CPU float64 (bound "
          f"{Q33_TOL:.0e}); from the golden: float64 card "
          f"{np.abs(card - gold).max():.3e}, CPU {np.abs(cpu - gold).max():.3e}"
          f"; float32 card {errs['pca_incr_adi']:.3e}, CPU "
          f"{errs_cpu['pca_incr_adi']:.3e}", flush=True)
    _require(err <= Q33_TOL, "Q3-3: pca_incr_adi in float64 on the card "
             "differs from the CPU")


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


def _kernel_table(fn, rows=15):
    """torch.profiler over one call of ``fn``, the card's activity alone:
    wall seconds, the seconds of device time in kernels and copies, and
    the top rows of that time summed by kernel name from the profiler's
    raw events. ``_profile_table`` attributes each kernel to its operator
    through the tree of every host and device event, which the profiler
    builds in Python: for one ``pca_annular`` of 1000x512² that took
    minutes (phase 14, PERF.md)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, calls = {}, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            name = ev.name()
            total[name] = total.get(name, 0) + ev.duration_ns()
            calls[name] = calls.get(name, 0) + 1
    top = sorted(total, key=total.get, reverse=True)[:rows]
    table = "\n".join([f"{'device ms':>12} {'calls':>8}  kernel"] + [
        f"{total[k] / 1e6:12.3f} {calls[k]:8d}  {k[:100]}" for k in top])
    return wall, sum(total.values()) / 1e9, table


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
    smi = _phase(1, "device", phase_device)
    _phase(2, "build", phase_build)

    rng = np.random.default_rng(0)
    cube_np = rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32)
    angles_np = np.linspace(0.0, 80.0, N_FRAMES).astype(np.float32)
    cube = torch.as_tensor(cube_np, device=DEVICE)
    del cube_np

    h1_err, cube_bisect = _phase(3, "H1", phase_median, cube)
    (frames, rot_angles, geom, frames160, angles160, geom160,
     h2_err) = _phase(4, "H2", phase_rotation)
    canvas, small_angles, h3_err = _phase(5, "H3", phase_small_rotation)
    h4_err, h4s_err = _phase(6, "H4", phase_fused3, frames, rot_angles, geom,
                             frames160, angles160, geom160, canvas,
                             small_angles)
    counts, run_kernel, run_plain = _phase(7, "main path, exact",
                                           phase_main_path, cube, angles_np)

    def phase8():
        run_small = phase_small_pipeline(cube, angles_np)
        return (run_small,) + phase_small_pipeline_fused3(run_small) \
            + phase_annular(cube, angles_np)

    (run_small, h4s_counts, run_small3, ann_counts,
     run_annular) = _phase(8, "main path, fft-small and annular", phase8)

    def phase9():
        phase_small_reference()
        phase_small_annular_reference()

    _phase(9, "small inputs against the CPU", phase9)

    def phase10():
        pcube, src = _plant_companion(cube, angles_np)
        h4_counts, search_runs, ms_frame = phase_companion_search(
            pcube, angles_np, src)
        t_ann_ms = phase_annular_median(pcube, angles_np, src)
        phase_small_companion_reference()
        return pcube, src, h4_counts, search_runs, ms_frame, t_ann_ms

    (pcube, src, h4_counts, search_runs, ms_frame,
     t_ann_ms) = _phase(10, "companion search", phase10)

    def phase11():
        with tempfile.TemporaryDirectory() as tmpdir:
            inc_counts, inc_runs = phase_incremental(cube, angles_np, tmpdir)
            t_inc = {k: _sync_times(fn, reps=3 if k == "cache on" else 1)
                     for k, fn in inc_runs.items()}
        return inc_counts, t_inc

    inc_counts, t_inc = _phase(11, "streamed PCA", phase11)

    def phase12():
        cc_counts, cc_cols, run_cc, psfn = phase_contrast(cube, angles_np)
        compl_counts, t_compl = phase_completeness(cube, angles_np, psfn,
                                                   cc_cols)
        stim_counts, run_stim = phase_stim(pcube, angles_np, src)
        return (cc_counts, cc_cols, run_cc, compl_counts, t_compl,
                stim_counts, run_stim)

    (cc_counts, cc_cols, run_cc, compl_counts, t_compl, stim_counts,
     run_stim) = _phase(12, "contrast, completeness, STIM", phase12)
    _phase(13, "F2", phase_f2)
    pp_refs = {}     # phases 15's, 17's and 18's results, for 22 and 23
    slice4 = _phase(15, "slice 4", phase_slice4, pcube, angles_np, src,
                    keep=pp_refs)
    negfc_counts, negfc_times = _phase(16, "NEGFC", phase_negfc, pcube,
                                       angles_np, src)
    invprob_counts, invprob_times = _phase(17, "slice 6", phase_invprob,
                                           pcube, angles_np, keep=pp_refs)
    ifs_counts, ifs_times = _phase(18, "slice 7", phase_ifs, keep=pp_refs)
    s8a_counts, s8a_times = _phase(19, "slice 8a", phase_slice8a, cube,
                                   angles_np, pcube, src)
    s8b_counts, s8b_times = _phase(20, "slice 8b", phase_slice8b, cube)
    s89_counts, s89_times = _phase(21, "slices 8c and 9", phase_slice8c9,
                                   cube, angles_np)
    with tempfile.TemporaryDirectory() as tmpdir:
        s10_counts, s10_times = _phase(22, "slice 10", phase_slice10, pcube,
                                       angles_np, src, tmpdir, pp_refs)
    with tempfile.TemporaryDirectory() as tmpdir:
        s11_counts, s11_times = _phase(
            23, "slice 11", phase_slice11, cube, angles_np, pcube,
            pp_refs["ifs"], tmpdir, {"contrast": cc_cols})
    del pp_refs
    s12_times = _phase(24, "slice 12", phase_slice12, cube)
    jacobi = _phase(25, "K5", phase_jacobi)
    t14 = time.perf_counter()
    new_paths = {"incremental": inc_counts, "contrast": cc_counts,
                 "completeness": compl_counts, "stim": stim_counts}
    new_paths.update({k: v[0] for k, v in slice4.items()})
    new_paths.update(negfc_counts)
    new_paths.update(invprob_counts)
    new_paths.update({f"ifs {k}": v for k, v in ifs_counts.items()})
    new_paths.update({f"8a {k}": v for k, v in s8a_counts.items()})
    new_paths.update({f"8b {k}": v for k, v in s8b_counts.items()})
    new_paths.update({f"8c/9 {k}": v for k, v in s89_counts.items()})
    new_paths.update({f"10 {k}": v for k, v in s10_counts.items()})
    new_paths["slice11"] = {
        k: sum(c[k] for c in s11_counts.values())
        for k in ("H1", "H2", "H3", "H4", "K5", "subspace")}

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
    t0 = time.perf_counter()
    prof_wall, busy, table = _kernel_table(run_annular)
    t_prof = time.perf_counter() - t0
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
          f"batch {INC_BATCH} (warm; the codec's decode into pinned memory;"
          f" phase 22's numpy decode and pinned copy "
          f"{s10_times['pca_incremental numpy decode, pinned copy']:.4f} s"
          f"): " + ", ".join(
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
    print("timing slice 7 (s; see the phase 18 lines): " + ", ".join(
        f"{k} {v:.4f}" for k, v in ifs_times.items()), flush=True)
    print("timing slice 8a (s, one run each; see the phase 19 lines): "
          + ", ".join(f"{k} {v:.4f}" for k, v in s8a_times.items()),
          flush=True)
    print("timing slice 8b (s; see the phase 20 lines): "
          + ", ".join(f"{k} {v:.4f}" for k, v in s8b_times.items()),
          flush=True)
    print("timing slices 8c and 9 (s; see the phase 21 lines): "
          + ", ".join(f"{k} {v:.4f}" for k, v in s89_times.items()),
          flush=True)
    print("timing slice 10 (s; see the phase 22 lines): "
          + ", ".join(f"{k} {v:.4f}" for k, v in s10_times.items()),
          flush=True)
    print("timing slice 11 (s, one run each; see the phase 23 lines): "
          + ", ".join(f"{k} {v:.4f}" for k, v in s11_times.items()),
          flush=True)
    print("timing slice 12 (s, one run each; see the phase 24 lines): "
          + ", ".join(f"{k} {v:.4f}" for k, v in s12_times.items()),
          flush=True)
    print(f"timing pca_annular {N_FRAMES}x{SIZE}x{SIZE} vip-fft-small "
          f"(ncomp 10, fwhm 4, asize 4): {t_ann:.4f} s; under the profiler "
          f"(the card's activity) {prof_wall:.4f} s, {busy:.4f} s of it in "
          f"kernels and copies, the profile with its table {t_prof:.1f} s; "
          f"top kernels by device time:\n{table}", flush=True)
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
             cufft_lines_ms=t_fft3, launches_new_paths={
                 k: v["H3"] for k, v in new_paths.items() if v["H3"]}),
        entry("rotate_fft_exact_fused3", "vip_tpu_torch/csrc/fft_shear3.cu",
              "vip_tpu/ops/pallas_shear.py:845", h4_counts["H4"], h4_err,
              t_h4 * 1e3, t_h2p * 1e3, exact_bound),
        entry("rotate_fft_small_fused3", "vip_tpu_torch/csrc/fft_shear3.cu",
              "vip_tpu/ops/pallas_shear.py:890", h4s_counts["H4"], h4s_err,
              t_h4s * 1e3, t_h3p * 1e3, small_bound),
    ]
    # K5 replaces no TPU kernel; its path is the double pass of phase 18,
    # its times phase 25's at the first of JACOBI_SHAPES, the rest beside
    k5_ms, k5_bound, k5_plain, k5_gesvd, k5_err = jacobi[JACOBI_SHAPES[0]]
    kernels.append(dict(
        entry("svd_jacobi", "vip_tpu_torch/csrc/svd_jacobi.cu", None,
              ifs_counts["pca double pass"]["K5"], k5_err, k5_ms, k5_plain,
              k5_bound, k5_gesvd),
        shapes={f"{b}x{n}x{n}": {"ms": v[0], "bound_ms": v[1][0],
                                 "bound_by": v[1][1], "plain_ms": v[2],
                                 "library_ms": v[3], "max_abs_err": v[4]}
                for (b, n), v in jacobi.items()},
        launches_new_paths={k: v["K5"] for k, v in new_paths.items()
                            if v["K5"]}))
    # the top-ncomp SVD route is no kernel: the counted paths it took, with
    # the matrices it returned converged
    print(json.dumps({"subspace_svd_paths": {
        k: v["subspace"] for k, v in new_paths.items() if v["subspace"]}}))
    print(f"phase 14 (timings) wall time: {time.perf_counter() - t14:.1f} s",
          flush=True)
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


def ifs_only():
    """Phase 18 alone (``--ifs``): the build and slice 7, with
    torch.profiler tables of one single-pass and one double-pass call."""
    phase_device()
    phase_build()
    counts, _ = phase_ifs(profile=True)
    print("launches: " + "; ".join(f"{k} {v}" for k, v in counts.items()),
          flush=True)


def slice8a_only():
    """Phase 19 alone (``--slice8a``): the build, the cube with the planted
    companion, slice 8a, with torch.profiler tables of
    ``cube_correct_nan`` and ``randomized_svd_gpu``."""
    phase_device()
    phase_build()
    rng = np.random.default_rng(0)
    cube = torch.as_tensor(
        rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    angles_np = np.linspace(0.0, 80.0, N_FRAMES).astype(np.float32)
    pcube, src = _plant_companion(cube, angles_np)
    counts, _ = phase_slice8a(cube, angles_np, pcube, src)
    print("launches: " + "; ".join(f"{k} {v}" for k, v in counts.items()),
          flush=True)
    from vip_tpu_torch.preproc import cosmetics
    from vip_tpu_torch.psfsub import randomized_svd_gpu

    dmg, _ = _damage(cube, 11)
    wall, table = _profile_table(
        lambda: cosmetics._correct_nan_frames(dmg, False))
    print(f"profile cube_correct_nan {N_FRAMES}x{SIZE}x{SIZE}: {wall:.4f} s "
          f"under the profiler; top ops by device time:\n{table}",
          flush=True)
    del dmg
    M = cube.reshape(N_FRAMES, -1)
    wall, table = _profile_table(lambda: randomized_svd_gpu(M, S8A_NCOMP))
    print(f"profile randomized_svd_gpu {N_FRAMES}x{M.shape[1]} ncomp "
          f"{S8A_NCOMP}: {wall:.4f} s under the profiler; top ops by device "
          f"time:\n{table}", flush=True)


def slice8b_only():
    """Phase 20 alone (``--slice8b``): the build, the noise cube, slice 8b,
    with torch.profiler tables of its two slowest steps."""
    phase_device()
    phase_build()
    rng = np.random.default_rng(0)
    cube = torch.as_tensor(
        rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    counts, times = phase_slice8b(cube)
    print("launches: " + "; ".join(f"{k} {v}" for k, v in counts.items()),
          flush=True)
    from vip_tpu_torch.preproc import recentering as rc

    jitter = _s8b_jitter(N_FRAMES, 12)
    stars = cube + _s8b_shifted(_s8b_star_template(), jitter)
    runs = {
        "cube_recenter_via_speckles": lambda: rc.cube_recenter_via_speckles(
            stars, subframesize=S8B_SUBFRAME, alignment_iter=5,
            fwhm=S8B_FWHM, plot=False),
        "cube_recenter_2dfit gauss": lambda: rc.cube_recenter_2dfit(
            stars, fwhm=S8B_FWHM, subi_size=9, verbose=False, plot=False),
        "cube_recenter_dft_upsampling": lambda: rc.
        cube_recenter_dft_upsampling(stars, upsample_factor=100, subi_size=9,
                                     fwhm=S8B_FWHM, verbose=False,
                                     plot=False)}
    slowest = [k for k in sorted(times, key=times.get, reverse=True)
               if k in runs][:2]
    for name in slowest:
        with contextlib.redirect_stdout(sys.stderr):
            wall, table = _profile_table(runs[name])
        print(f"profile {name} {N_FRAMES}x{SIZE}x{SIZE}: {wall:.4f} s under "
              f"the profiler; top ops by device time:\n{table}", flush=True)


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
    if "--seed" in sys.argv:
        # the seed of phase 18's synthetic IFS sequence
        i = sys.argv.index("--seed")
        IFS_SEED = int(sys.argv[i + 1])
        del sys.argv[i:i + 2]
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
    if len(sys.argv) == 2 and sys.argv[1] == "--ifs":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        ifs_only()
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--slice8a":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        slice8a_only()
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--slice8b":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        slice8b_only()
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--slice8c9":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        slice8c9_only()
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--slice10":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        slice10_only()
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--slice11":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        slice11_only()
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--jacobi":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        jacobi_only()
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--slice12":
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        slice12_only()
        sys.exit(0)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
