"""Smoke run of the vip_tpu_torch port on one CUDA card (an H100).

    python3 chip_smoke.py

Drives the port's main path, full-frame PCA-ADI, on the card through the
entry points a user calls (``ops.pipeline.pca_adi_pipeline`` and the
public ``psfsub.pca``) at bench.py's full size: a 1000x512x512 float32
cube of seeded random frames. Phases, one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ``vip_tpu_torch/csrc`` with nvcc;
3. H1 (radix-select median) against its plain version, bit for bit, and
   against numpy's nanmedian/median within 1 ulp;
4. H2 (FFT-shear rotation) against its plain version at float32 and at
   float64 on the card;
5. main path: both entry points, with the kernels' launch counts, against
   the same steps through the plain versions on the card, plus a small
   input against the float64 CPU parity mode;
6. timings, kernel beside plain, warm median of 3.

Prints a JSON line of the kernels, then as its last line
``{"ok": true, "device": {...}}``. Any failed phase raises, and the script
exits non-zero without that line; so does a host with no CUDA card.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES, SIZE, NCOMP, CHUNK = 1000, 512, 10, 50   # bench.py's workload
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


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _sync_time(fn, reps=3):
    """Warm median of ``reps`` timed calls, synchronized, in seconds."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


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


def phase_median(cube):
    """H1 on the main path's shape, with NaNs, even and odd frame counts,
    both propagate modes."""
    from vip_tpu_torch.ops.median import nanmedian_axis0, nanmedian_plain

    rng = np.random.default_rng(1)
    cube = cube.clone()
    flat = cube.view(-1)
    nan_at = torch.as_tensor(rng.choice(flat.numel(), 3000, replace=False),
                             device=cube.device)
    flat[nan_at] = torch.nan
    cube[:, 0, 0] = torch.nan              # all-NaN pixel
    cube[::2, 0, 1] = torch.nan            # half-NaN pixel
    cube[:, 0, 2] = -0.0
    max_err = 0.0
    for n in (N_FRAMES, N_FRAMES - 1):
        sub = cube[:n].contiguous()
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
    print(f"H1 nanmedian_axis0 vs plain: bit-equal at n={N_FRAMES} and "
          f"{N_FRAMES - 1}, both propagate modes; within 1 ulp of numpy on "
          f"16 rows", flush=True)
    return max_err


def phase_rotation():
    """H2 on 50 frames of 512^2 with angles in all four quadrants,
    including 45 and 90 degrees exactly."""
    from vip_tpu_torch.ops.fft import rotate_fft_exact_pruned
    from vip_tpu_torch.ops.shear import rotate_fft_exact_fused
    from vip_tpu_torch.preproc.derotation import _fft_rotate_geometry

    rng = np.random.default_rng(2)
    frames = torch.as_tensor(
        rng.standard_normal((CHUNK, SIZE, SIZE)).astype(np.float32),
        device=DEVICE)
    angles = np.linspace(-190.0, 350.0, CHUNK)
    angles[:8] = [0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0, -45.0]
    angles = torch.as_tensor(angles.astype(np.float32), device=DEVICE)
    pad_y, _, py0, px0, cy0, cy1, cx0, cx1 = _fft_rotate_geometry(SIZE, SIZE)
    geom = (pad_y, py0, px0, cy0, cy1, cx0, cx1)

    got = rotate_fft_exact_fused(frames, angles, *geom)
    ref32 = rotate_fft_exact_pruned(frames, angles, *geom)
    ref64 = rotate_fft_exact_pruned(frames.double(), angles.double(), *geom)
    torch.cuda.synchronize()
    err32, s32 = _rel_err(got, ref32)
    err64, s64 = _rel_err(got, ref64)
    plain_err, _ = _rel_err(ref32, ref64)
    print(f"H2 rotate_fft_exact_fused vs plain: max abs err {err32:.3e} "
          f"(f32 plain), {err64:.3e} (f64 plain); plain f32 vs f64 "
          f"{plain_err:.3e}; bound {ROT_TOL:.0e} x {s64:.3f}", flush=True)
    _require(err32 <= ROT_TOL * s32, "H2 disagrees with the f32 plain path")
    _require(err64 <= ROT_TOL * s64, "H2 disagrees with the f64 plain path")
    return frames, angles, geom, max(err32, err64)


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


def main():
    smi = phase_device()
    phase_build()

    rng = np.random.default_rng(0)
    cube_np = rng.standard_normal((N_FRAMES, SIZE, SIZE)).astype(np.float32)
    angles_np = np.linspace(0.0, 80.0, N_FRAMES).astype(np.float32)
    cube = torch.as_tensor(cube_np, device=DEVICE)
    del cube_np

    h1_err = phase_median(cube)
    frames, rot_angles, geom, h2_err = phase_rotation()
    counts, run_kernel, run_plain = phase_main_path(cube, angles_np)
    phase_small_reference()

    from vip_tpu_torch.ops.fft import rotate_fft_exact_pruned
    from vip_tpu_torch.ops.median import nanmedian_axis0, nanmedian_plain
    from vip_tpu_torch.ops.shear import rotate_fft_exact_fused

    t_h1 = _sync_time(lambda: nanmedian_axis0(cube))
    t_h1p = _sync_time(lambda: nanmedian_plain(cube, 0))
    t_h2 = _sync_time(lambda: rotate_fft_exact_fused(frames, rot_angles,
                                                     *geom))
    t_h2p = _sync_time(lambda: rotate_fft_exact_pruned(frames, rot_angles,
                                                       *geom))
    t_e2e = _sync_time(run_kernel)
    t_e2ep = _sync_time(run_plain)
    print(f"timing H1 median {N_FRAMES}x{SIZE}x{SIZE}: kernel "
          f"{t_h1 * 1e3:.3f} ms, plain {t_h1p * 1e3:.3f} ms", flush=True)
    print(f"timing H2 rotation {CHUNK}x{SIZE}^2: kernel {t_h2 * 1e3:.3f} ms "
          f"({CHUNK / t_h2:.1f} frames/s), plain {t_h2p * 1e3:.3f} ms "
          f"({CHUNK / t_h2p:.1f} frames/s)", flush=True)
    print(f"timing pca_adi_pipeline {N_FRAMES}x{SIZE}x{SIZE} rot_mode=fft: "
          f"kernels {t_e2e:.4f} s, plain path {t_e2ep:.4f} s", flush=True)

    kernels = [
        {"name": "nanmedian_axis0", "route": "cuda",
         "source": "vip_tpu_torch/csrc/nanmedian.cu",
         "replaces": "vip_tpu/ops/pallas_median.py:104",
         "launches": counts["H1"], "max_abs_err": h1_err,
         "ms": t_h1 * 1e3, "plain_ms": t_h1p * 1e3},
        {"name": "rotate_fft_exact_fused", "route": "cuda",
         "source": "vip_tpu_torch/csrc/fft_shear.cu",
         "replaces": "vip_tpu/ops/pallas_shear.py:550",
         "launches": counts["H2"], "max_abs_err": h2_err,
         "ms": t_h2 * 1e3, "plain_ms": t_h2p * 1e3},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
