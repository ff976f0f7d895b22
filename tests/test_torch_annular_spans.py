"""The spans of the port's annular PCA (``psfsub.pca_annular``) on the
CPU: a traced call holds one ``api.pca_annular`` root over the annular
layer's spans, every library factored counted once (n frames x annuli in
all, whichever route factors them: an annulus at a time on the host
branch, all at once on the resident one), and nothing is recorded while
the profiler is off."""

import importlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vip_tpu_torch
from vip_tpu_torch.psfsub import pca_annular

timing = importlib.import_module("vip_tpu_torch.config.timing")

RNG = np.random.default_rng(21)
PX, ANNULI = 32, 4                    # int((32 / 2) / asize 4) annuli

# frames, forced method, the spans expected, the factorization's span
ROUTES = {
    "host": (40, None, {"api.pca_annular", "annular.libraries",
                        "annular.svd", "factorization.svd",
                        "derotation.cube_derotate",
                        "collapse.cube_collapse"}, "annular.svd"),
    "resident-eigh": (128, None, {"api.pca_annular", "annular.libraries",
                                  "annular.segment", "annular.eigh",
                                  "derotation.frames"}, "annular.eigh"),
    "resident-subspace": (128, "subspace",
                          {"api.pca_annular", "annular.libraries",
                           "annular.segment", "annular.subspace",
                           "derotation.frames"}, "annular.subspace"),
}


@pytest.fixture(autouse=True)
def fresh():
    vip_tpu_torch.set_device("cpu")
    timing.clear_spans()
    yield
    timing.clear_spans()


def _call(frames):
    cube = RNG.standard_normal((frames, PX, PX))
    return pca_annular(cube, np.linspace(0.0, 40.0, frames), fwhm=3.34,
                       ncomp=3, verbose=False)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_traced_call_holds_its_spans(route, monkeypatch):
    frames, method, names, factorization = ROUTES[route]
    if method is None:
        monkeypatch.delenv("VIP_TPU_ANNULAR_METHOD", raising=False)
    else:
        monkeypatch.setenv("VIP_TPU_ANNULAR_METHOD", method)
    with profile(activities=[ProfilerActivity.CPU]):
        _call(frames)
    got = timing.spans()
    roots = [s for s in got if s[3] is None]
    assert [(s[0], s[5]) for s in roots] == [("api.pca_annular", frames)]
    assert all(s[4] == 0 and s[2] is not None for s in got)
    assert {s[0] for s in got} == names
    factored = [s[5] for s in got if s[0] == factorization]
    libraries = [s[5] for s in got if s[0] == "annular.libraries"]
    if route == "host":
        # an annulus at a time
        assert factored == [frames] * ANNULI
        assert sum(libraries) >= frames * ANNULI
    else:
        # every annulus's libraries built, then factored, as one batch
        assert factored == [frames * ANNULI]
        assert libraries == [frames * ANNULI]
        seg = [s[5] for s in got if s[0] == "annular.segment"]
        assert len(seg) == 1 and seg[0] > 0
        assert [s[5] for s in got if s[0] == "derotation.frames"] == [frames]


def test_nothing_is_recorded_without_the_profiler():
    a = _call(128)
    assert timing.spans() == [] and timing.spans_dropped() == 0
    assert isinstance(a, torch.Tensor)
