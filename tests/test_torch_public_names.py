"""Every public name of each subpackage that vip_tpu and the port share
is a name of the port's subpackage too, less an explicit list of the
names still to port, by the ROADMAP slice that ports them (ROADMAP Queue
3, Q3-1: ``vip_tpu_torch.var`` lacked the filters and the 2-d fits).

A public name is an attribute of the subpackage that does not start with
'_' and is not a module. The still-to-port list must stay true: each name
on it is absent from the port, so a slice that ports one takes it off.
"""

import importlib
import types

import pytest

import vip_tpu_torch

SHARED = ("config", "var", "preproc", "ops", "psfsub", "metrics", "fm",
          "fits", "greedy", "invprob", "stats", "objects")

# {subpackage: {slice: names}}: vip_tpu's public names the port has not
# ported yet (ROADMAP Queue 1); slice 11 ported the last ones
STILL_TO_PORT = {}

# slice 11's names (ROADMAP Queue 1): config's, and the sharded modules'
SLICE_11 = {"chunked_vmap", "device_put_sharded_frames", "frame_mesh",
            "shard_cube", "sharded_frame_map"}
SHARDED = ("psfsub.sharded", "metrics.sharded", "fm.sharded")

# slice 10's names (ROADMAP Queue 1): none may be left
SLICE_10 = {
    "config": {"Progressbar", "Saveable", "make_chunks", "redirect_output",
               "time_fin", "vip_figdpi", "vip_figsize", "device_trace",
               "annotate_trace", "GPI_IFS", "KECK_NIRC2", "LBT", "VLT_NACO",
               "VLT_SINFONI", "VLT_SPHERE_IFS", "VLT_SPHERE_IRDIS"},
    "metrics": {"EvalRoc"},
    "objects": {"Dataset", "Frame", "PostProc", "PPResult", "ALL_SESSIONS",
                "LAST_SESSION", "PCABuilder", "PPPCA", "MedianBuilder",
                "PPMedianSub", "AndroBuilder", "PPAndromeda", "FMMFBuilder",
                "PPFMMF", "FrameDiffBuilder", "PPFrameDiff", "LLSGBuilder",
                "PPLLSG", "LOCIBuilder", "PPLOCI", "NMFBuilder", "PPNMF"},
}

# slice 9's names (ROADMAP Queue 1): none may be left
SLICE_9 = {"DustEllipticalDistribution2PowerLaws", "Dust_distribution",
           "Phase_function", "ScatteredLightDisk", "chisquare_fd",
           "cube_disk_free", "cube_inject_fakedisk", "cube_inject_trace",
           "firstguess_fd", "firstguess_fd_from_coord", "interpolate_model"}

# slice 8b's functions (ROADMAP Queue 1): none may be left
SLICE_8B = {"cube_detect_badfr_correlation", "cube_detect_badfr_ellipticity",
            "cube_detect_badfr_pxstats", "cube_fix_badpix_annuli",
            "cube_fix_badpix_clump", "cube_fix_badpix_ifs",
            "cube_fix_badpix_interp", "cube_fix_badpix_isolated",
            "cube_recenter_2dfit", "cube_recenter_dft_upsampling",
            "cube_recenter_radon", "cube_recenter_satspots",
            "cube_recenter_via_speckles", "frame_center_radon",
            "frame_center_satspots", "frame_fix_badpix_fft",
            "frame_fix_badpix_isolated"}

# slice 8a's functions (ROADMAP Queue 1): none may be left
SLICE_8A = {"frame_or_shape", "pol_to_eq", "QU_to_QUphi", "mask_ellipse",
            "get_ellipse", "get_ell_annulus", "mask_roi",
            "create_ringed_spider_mask", "create_synth_psf",
            "fit_2d2gaussian", "cube_filter_iuwt", "frame_deconvolution",
            "sigma_filter", "clip_array", "cube_distance",
            "spectral_correlation", "frame_histo_stats",
            "frame_average_radprofile", "descriptive_stats",
            "frame_basic_stats", "cube_basic_stats", "bkg_star_proba",
            "cube_subsample", "cube_subsample_trimmean", "frame_pad",
            "cube_drop_frames", "frame_remove_stripes", "cube_correct_nan",
            "approx_stellar_position", "compute_paral_angles",
            "compute_derot_angles_pa", "compute_derot_angles_cd",
            "randomized_svd_gpu"}


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _public(package):
    mod = importlib.import_module(package)
    return {n for n in dir(mod) if not n.startswith("_")
            and not isinstance(getattr(mod, n), types.ModuleType)}


def _waiting(sub):
    return set().union(*STILL_TO_PORT.get(sub, {}).values())


@pytest.mark.parametrize("sub", SHARED)
def test_port_has_vip_tpu_public_names(sub):
    theirs, ours = _public(f"vip_tpu.{sub}"), _public(f"vip_tpu_torch.{sub}")
    missing = theirs - ours - _waiting(sub)
    assert not missing, f"vip_tpu_torch.{sub} lacks {sorted(missing)}"
    # the list names only what is still missing, and only vip_tpu's names
    assert not _waiting(sub) & ours, sorted(_waiting(sub) & ours)
    assert _waiting(sub) <= theirs, sorted(_waiting(sub) - theirs)


def test_no_slice_8a_name_is_still_to_port():
    waiting = set().union(*(_waiting(s) for s in SHARED))
    assert not waiting & SLICE_8A
    everywhere = set().union(*(_public(f"vip_tpu_torch.{s}")
                               for s in SHARED))
    assert SLICE_8A <= everywhere, sorted(SLICE_8A - everywhere)


def test_no_slice_8b_name_is_still_to_port():
    waiting = set().union(*(_waiting(s) for s in SHARED))
    assert not waiting & SLICE_8B
    assert len(SLICE_8B) == 17
    assert SLICE_8B <= _public("vip_tpu_torch.preproc"), \
        sorted(SLICE_8B - _public("vip_tpu_torch.preproc"))


def test_no_slice_9_name_is_still_to_port():
    waiting = set().union(*(_waiting(s) for s in SHARED))
    assert not waiting & SLICE_9
    assert len(SLICE_9) == 11
    assert SLICE_9 <= _public("vip_tpu_torch.fm"), \
        sorted(SLICE_9 - _public("vip_tpu_torch.fm"))


def test_no_slice_10_name_is_still_to_port():
    waiting = set().union(*(_waiting(s) for s in SHARED))
    for sub, names in SLICE_10.items():
        assert not waiting & names, sorted(waiting & names)
        assert names <= _public(f"vip_tpu_torch.{sub}"), \
            sorted(names - _public(f"vip_tpu_torch.{sub}"))
    # every name of vip_tpu.objects is one of slice 10's
    assert _public("vip_tpu.objects") == SLICE_10["objects"]
    # nothing is left to port
    assert STILL_TO_PORT == {}
    from vip_tpu.vip_ds9 import Ds9Window as Theirs
    from vip_tpu_torch.vip_ds9 import Ds9Window

    public = {n for n in dir(Theirs) if not n.startswith("_")}
    assert public <= {n for n in dir(Ds9Window) if not n.startswith("_")}


def test_no_slice_11_name_is_still_to_port():
    assert STILL_TO_PORT == {}
    assert SLICE_11 <= _public("vip_tpu_torch.config"), \
        sorted(SLICE_11 - _public("vip_tpu_torch.config"))
    theirs = importlib.import_module("vip_tpu.config.parallel")
    ours = importlib.import_module("vip_tpu_torch.config.parallel")
    assert ours.__all__ == theirs.__all__


@pytest.mark.parametrize("module", SHARDED)
def test_sharded_modules_export_vip_tpus_names(module):
    theirs = importlib.import_module(f"vip_tpu.{module}")
    ours = importlib.import_module(f"vip_tpu_torch.{module}")
    assert ours.__all__ == theirs.__all__
    for name in ours.__all__:
        assert callable(getattr(ours, name)), name
