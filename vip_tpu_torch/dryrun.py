"""Ranks on one host: spawn them, run the port's sharded entry points in
each, and bring their results back (the twin of vip_tpu's
``__graft_entry__.dryrun_multichip``).

:func:`run_ranks` spawns ``n`` processes (multiprocessing's spawn
method), joins them in one process group on a free localhost port
(``tcp://127.0.0.1:<port>``, a 60 s timeout), points each at the port's
device (``set_device``; several gloo ranks may share one card) and calls
a function of this module in every rank. A rank that fails makes the
call raise with its traceback; a deadline kills every rank and raises,
so a hung collective never hangs the caller. The device "cuda" puts
rank r on card r (NCCL on several cards); "cuda:0" puts every rank on
card 0 (gloo ranks sharing one card). Each rank checks that
neither ``jax`` nor ``vip_tpu`` is loaded in it.

:func:`entry_points` is the rank function that tests and
``chip_smoke.py`` share: it runs every sharded entry point named in its
``specs`` (the kinds of :data:`ENTRY_KINDS`) on meshes over all ranks and
returns each result as host numpy, with its time and kernel launches.
:func:`dryrun_multichip` runs every entry point of ``__graft_entry__``'s
dry run at its tiny shapes.

    python -m vip_tpu_torch.dryrun 4 --backend gloo --device cpu
"""

import datetime
import multiprocessing as _mp
import os
import queue
import sys
import time
import traceback

import numpy as np
import torch

#: Seconds a spawned call may take, from the spawn to the last result.
JOIN_TIMEOUT = 120.0
#: A rank's CPU threads (torch's, and its BLAS and OpenMP pools'): ranks
#: share the host's cores.
RANK_THREADS = 1
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _clean_modules():
    """True when neither jax nor vip_tpu is loaded in this process."""
    return not any(m == "jax" or m.startswith("jax.") or m == "vip_tpu"
                   or m.startswith("vip_tpu.") for m in sys.modules)


def _rank_main(fn_name, rank, world, port, backend, device, args, results,
               wait_for, timeout):
    """One rank: the process group, the device, then (once ``wait_for``
    is set, when given) ``fn_name(*args)``."""
    import torch.distributed as dist

    import vip_tpu_torch

    try:
        if not _clean_modules():
            raise RuntimeError("jax or vip_tpu is loaded in a rank")
        torch.set_num_threads(RANK_THREADS)
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            # "cuda": one card a rank, as torchrun's LOCAL_RANK does
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        vip_tpu_torch.set_device(dev)
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=60))
        try:
            if wait_for is not None and not wait_for.wait(timeout):
                raise TimeoutError(f"rank {rank} waited {timeout:.0f} s")
            out = globals()[fn_name](*args)
            if not _clean_modules():
                raise RuntimeError("jax or vip_tpu was loaded in a rank")
            results.put((rank, True, out))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn_name, n_ranks, *, backend="gloo", device="cpu", args=(),
              timeout=JOIN_TIMEOUT, wait_for=None):
    """Spawn ``n_ranks`` ranks that each run this module's function
    ``fn_name(*args)`` on ``device`` in one ``backend`` group; the list of
    their results in rank order, each rank on :data:`RANK_THREADS` CPU
    threads. ``wait_for``: an Event of
    the spawn context (``multiprocessing.get_context("spawn").Event()``)
    that the ranks wait for, once in their group, before they compute.
    Raises RuntimeError when a rank fails, TimeoutError (every rank
    killed) past ``timeout`` seconds."""
    from .config.parallel import free_port

    if fn_name not in globals() or not callable(globals()[fn_name]):
        raise ValueError(f"{fn_name!r} is not a function of {__name__}")
    ctx = _mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn_name, r, n_ranks, port, backend,
                               str(device), args, results, wait_for,
                               timeout))
             for r in range(n_ranks)]
    # the ranks' BLAS and OpenMP pools take RANK_THREADS threads too: a
    # rank starts with this environment, and these are read at import
    before = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: str(RANK_THREADS) for k in _THREAD_VARS})
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in before.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n_ranks} ranks of {fn_name} did not "
                                   f"finish in {timeout:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of {fn_name} died "
                                       f"(exit {procs[dead[0]].exitcode})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn_name} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10 if len(got) == n_ranks else 0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [got[r] for r in range(n_ranks)]


# ---------------------------------------------------------------------------
# The entry points, one function a kind: (spec's inputs) -> host result
# ---------------------------------------------------------------------------


def _mesh(axis_name):
    from .config.parallel import frame_mesh

    return frame_mesh(axis_name=axis_name)


def _loaded(v):
    """A ``.npy`` path read as a (copy-on-write) memory map; anything
    else as it is."""
    if isinstance(v, str) and v.endswith(".npy"):
        return np.load(v, mmap_mode="c")
    return v


def _pca_adi(cube, angles, ncomp, collapse="mean"):
    from .config.parallel import shard_cube
    from .psfsub.sharded import make_sharded_pca_adi, sharded_pca_adi

    mesh = _mesh("frames")
    if collapse == "mean":
        return sharded_pca_adi(cube, angles, ncomp=ncomp, mesh=mesh)
    fn = make_sharded_pca_adi(mesh, ncomp, collapse=collapse)
    return fn(shard_cube(cube, mesh), shard_cube(angles, mesh))


def _median_adi(cube, angles):
    from .config.parallel import shard_cube
    from .psfsub.sharded import make_sharded_median_adi

    mesh = _mesh("frames")
    return make_sharded_median_adi(mesh)(shard_cube(cube, mesh),
                                         shard_cube(angles, mesh))


def _pca_annular(cube, angles, **kw):
    from .psfsub.sharded import sharded_pca_annular

    return sharded_pca_annular(cube, angles, mesh=_mesh("frames"), **kw)


def _snrmap(frame, fwhm, step=False, **kw):
    """``sharded_snrmap`` (float32, as vip_tpu's), or with ``step`` the
    bare step of ``make_sharded_snrmap`` in the frame's dtype."""
    from .metrics.sharded import make_sharded_snrmap, sharded_snrmap

    mesh = _mesh("px")
    if step:
        return make_sharded_snrmap(mesh, frame.shape, fwhm, **kw)(frame)
    return sharded_snrmap(frame, fwhm, mesh=mesh, **kw)


def _patterns(cubes, angles, **kw):
    from .metrics.sharded import sharded_pattern_frames

    return sharded_pattern_frames([_loaded(c) for c in cubes], angles,
                                  mesh=_mesh("patterns"), **kw)


def _sdi(cube, angles, scal_list, **kw):
    from .psfsub.sharded import sharded_pca_sdi_single

    return sharded_pca_sdi_single(cube, angles, scal_list,
                                  mesh=_mesh("channels"), **kw)


def _incremental(cube, angles, **kw):
    from .psfsub.utils_pca import pca_incremental

    out = pca_incremental(cube, angles, verbose=False,
                          pixel_mesh=_mesh("px"), **kw)
    return tuple(o for o in out if o is not None) \
        if isinstance(out, tuple) else out


def _lnprob(walkers, args, kwargs):
    from .fm.sharded import make_sharded_batched_lnprob

    return make_sharded_batched_lnprob(_mesh("walkers"),
                                       *(_loaded(a) for a in args),
                                       **kwargs)(walkers)


def _mcmc(cube, angles, psfn, initial_state, draws_table=None, **kw):
    """The MCMC with ``walker_mesh``; ``draws_table`` lists the stretch
    moves' (u_z, partners, u_accept) of each half-update in order."""
    from .fm.negfc_mcmc import mcmc_negfc_sampling

    def draws(step, half, ns0, n1):
        return draws_table[2 * step + half]

    return mcmc_negfc_sampling(
        cube, angles, psfn, initial_state, walker_mesh=_mesh("walkers"),
        draws=None if draws_table is None else draws, **kw)


def _contrast(cube, angles, psf, fwhm, pxscale, starphot, **kw):
    from .metrics.contrcurve import _contrast_curve
    from .psfsub import pca

    return _contrast_curve(cube, angles, psf, fwhm, pxscale, starphot, pca,
                           pattern_mesh=_mesh("patterns"), **kw)[0]


def _raises(what):
    """The ValueError message of the entry point of spec ``what`` that
    must refuse its inputs (None when it does not raise)."""
    spec = dict(what)
    fn = ENTRY_KINDS[spec.pop("kind")]
    try:
        fn(**{k: _loaded(v) for k, v in spec.items()})
    except ValueError as e:
        return str(e)
    return None


#: The entry points a spec may name, by kind.
ENTRY_KINDS = {"pca_adi": _pca_adi, "median_adi": _median_adi,
               "pca_annular": _pca_annular, "snrmap": _snrmap,
               "patterns": _patterns, "sdi": _sdi,
               "incremental": _incremental, "lnprob": _lnprob,
               "mcmc": _mcmc, "contrast": _contrast, "raises": _raises}


def _host(out):
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, tuple):
        return tuple(_host(o) for o in out)
    if isinstance(out, dict):
        return {k: _host(v) for k, v in out.items()}
    return out


def _float64(v):
    """A float numpy cube (3 or more dims) as a float64 tensor on the
    port's device (the port's policy would take it to float32 on a
    card)."""
    from .config.device import get_device

    if isinstance(v, np.ndarray) and v.dtype.kind == "f" and v.ndim >= 3:
        return torch.as_tensor(np.asarray(v), dtype=torch.float64,
                               device=get_device())
    return v


def entry_points(specs):
    """Every entry point of ``specs`` ({name: {"kind": kind, **inputs}},
    inputs as the kind's function takes them, ``.npy`` paths read as
    memory maps; ``"float64": True`` turns the float arrays into float64
    tensors on the port's device) on meshes over every rank of the
    default group, in order. Returns {"device": the device of a shard's
    tensor, name: {"out": host result, "s": seconds, "counts": H1-H4
    and K5 launches, and the matrices of the top-ncomp SVD route}}."""
    from .config.device import get_device
    from .config.parallel import frame_mesh, shard_cube
    from .ops import linalg, median, shear

    dev, mesh = get_device(), frame_mesh()
    out = {"device": str(shard_cube(np.zeros(mesh.size()),
                                    mesh).to_local().device)}
    for name, spec in specs.items():
        spec = dict(spec)
        fn = ENTRY_KINDS[spec.pop("kind")]
        wide = _float64 if spec.pop("float64", False) else (lambda v: v)
        inputs = {k: wide(_loaded(v)) for k, v in spec.items()}
        median.launches = shear.launches = shear.small_launches = 0
        shear.fused3_launches = linalg.jacobi_launches = 0
        linalg.subspace_matrices = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = _host(fn(**inputs))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[name] = {"out": res, "s": time.perf_counter() - t0,
                     "counts": {"H1": median.launches, "H2": shear.launches,
                                "H3": shear.small_launches,
                                "H4": shear.fused3_launches,
                                "K5": linalg.jacobi_launches,
                                "subspace": linalg.subspace_matrices}}
    return out


def _dryrun_size(n_devices):
    """The frames' side: vip_tpu's 8n, grown to a multiple of 8n of at
    least 64 (its size on 8 devices) so that the NEGFC annulus at r = 10
    fits in the frame and the rows divide over the ranks."""
    return 8 * n_devices * -(-8 // n_devices)


def _dryrun_specs(n_devices):
    """``__graft_entry__.dryrun_multichip``'s inputs for n devices: a
    (4n, s, s) cube of seeded noise (s of :func:`_dryrun_size`) and its
    entry points."""
    n_frames, size = 4 * n_devices, _dryrun_size(n_devices)
    rng = np.random.default_rng(0)
    cube = rng.standard_normal((n_frames, size, size)).astype(np.float32)
    angles = np.linspace(0.0, 40.0, n_frames).astype(np.float32)
    cube64 = cube.astype(float)
    q = np.mgrid[:9, :9] - 4.0
    psfn = np.exp(-(q[0] ** 2 + q[1] ** 2) / (2 * (4 / 2.355) ** 2))
    psf_cc = np.exp(-(q[0] ** 2 + q[1] ** 2)
                    / (2 * (3 / 2.355) ** 2)).astype(np.float32)
    bounds = [(6.0, 14.0), (10.0, 50.0), (0.1, 50.0)]
    walkers = np.column_stack([np.linspace(8, 12, 2 * n_devices),
                               np.linspace(20, 40, 2 * n_devices),
                               np.linspace(1, 10, 2 * n_devices)])
    z = n_devices
    return {
        "pca_adi": dict(kind="pca_adi", cube=cube, angles=angles, ncomp=3),
        "pca_adi median": dict(kind="pca_adi", cube=cube, angles=angles,
                               ncomp=3, collapse="median"),
        "median_adi": dict(kind="median_adi", cube=cube, angles=angles),
        "pca_annular": dict(kind="pca_annular", cube=cube64, angles=angles,
                            ncomp=3, fwhm=4.0, asize=4, delta_rot=0.1,
                            radius_int=2, n_segments=2),
        "snrmap": dict(kind="snrmap", frame=cube[0], fwhm=4.0),
        "lnprob": dict(kind="lnprob", walkers=walkers, args=(
            cube64, angles, psfn, 2, 4, 10.0, 30.0, 2.0, 4.0, np.zeros(1),
            1.0, bounds), kwargs={}),
        "mcmc": dict(kind="mcmc", cube=cube64, angles=angles, psfn=psfn,
                     initial_state=(10.0, 30.0, 5.0), ncomp=2,
                     annulus_width=4, aperture_radius=2, fwhm=4.0,
                     nwalkers=4 * n_devices, niteration_limit=3,
                     niteration_min=3, verbosity=0),
        "patterns": dict(kind="patterns", cubes=[cube + 0.01 * i for i in
                                                 range(n_devices + 1)],
                         angles=angles, ncomp=2),
        "sdi": dict(kind="sdi", cube=np.stack([cube * (1 + 0.02 * ch)
                                               for ch in range(z)]),
                    angles=angles, scal_list=np.linspace(1.0, 1.3, z),
                    ncomp=2),
        "incremental": dict(kind="incremental", cube=cube64, angles=angles,
                            batch=6, ncomp=2),
        "contrast": dict(kind="contrast", cube=cube64, angles=angles,
                         psf=psf_cc, fwhm=3.0, pxscale=0.01, starphot=100.0,
                         sigma=3, nbranch=1, inner_rad=1, fc_rad_sep=3,
                         plot=False, verbose=False, ncomp=2),
    }


def _dryrun_rank(n_devices):
    """One rank of :func:`dryrun_multichip`: every entry point, its
    shape and finiteness checked."""
    size = _dryrun_size(n_devices)
    res = entry_points(_dryrun_specs(n_devices))
    want = {"lnprob": (2 * n_devices,), "mcmc": (4 * n_devices, 3, 3),
            "patterns": (n_devices + 1, size, size)}
    for name, r in res.items():
        if name in ("device", "contrast"):
            continue
        shape = want.get(name, (size, size))
        if r["out"].shape != shape or (name != "lnprob" and not np.isfinite(
                r["out"]).all()):
            raise RuntimeError(f"dryrun {name}: shape {r['out'].shape} "
                               f"(want {shape}) or values not finite")
    if not np.isfinite(res["contrast"]["out"]["distance"]).all():
        raise RuntimeError("dryrun contrast curve: distances not finite")
    return {k: (v if k == "device" else v["counts"]) for k, v in res.items()}


def dryrun_multichip(n_devices, *, backend=None, device=None):
    """Spawn ``n_devices`` ranks and run every sharded entry point of
    vip_tpu's dry run (``__graft_entry__.py``) at its tiny shapes: PCA-ADI
    (mean and median), median-ADI, annular PCA, the S/N map, the walker
    likelihood and the MCMC with ``walker_mesh``, the injection patterns,
    the ADI+mSDI PCA, ``pca_incremental(pixel_mesh=)`` and the contrast
    curve with ``pattern_mesh``. ``device`` defaults to the port's
    (``config.get_device()``), ``backend`` to the device's ("nccl" on a
    card, "gloo" on the CPU). Returns rank 0's {entry: launches} and
    prints one line."""
    from .config.device import get_device
    from .config.parallel import backend_for

    device = get_device() if device is None else torch.device(device)
    backend = backend_for(device) if backend is None else backend
    out = run_ranks("_dryrun_rank", n_devices, backend=backend,
                    device=device, args=(n_devices,))[0]
    print(f"dryrun_multichip OK on {n_devices} {backend} ranks "
          f"({out['device']}): " + ", ".join(k for k in out if k != "device"))
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=dryrun_multichip.__doc__)
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    if a.device is not None:
        import vip_tpu_torch

        vip_tpu_torch.set_device(a.device)
    dryrun_multichip(a.n_devices, backend=a.backend, device=a.device)
