"""The port's bad-pixel window filters (``ops.badpix``) against vip_tpu,
on the CPU at float64.

- The sigma filter (``sigma_filter_device``, ``cube_sigma_filter_device``):
  the frames and the sweep counts equal, on scattered bad pixels, an even
  good-neighbour count (the two middles averaged), pixels on the edges and
  corners (the window shifted inward), a clump eroded over several sweeps
  and a stalled clump (a sweep that fixes nothing ends the loop). The
  port's route (the windows of the bad pixels alone) and its dense plain
  version agree bit for bit, and both with vip_tpu's host loop.
- ``clip_neighbor_device`` (standard deviation and MAD, ``min_std``, odd
  and even windows, with bad pixels) and ``median_filter_device``: equal
  masks and frames.
"""

import numpy as np
import pytest
import scipy.ndimage
import torch

import vip_tpu_torch
from vip_tpu.ops import badpix as jbp
from vip_tpu.stats import clip_sigma as jcs
from vip_tpu_torch.ops import badpix as tbp


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _case(name):
    """A (frame, bad-pixel map) pair from seed 5."""
    rng = np.random.default_rng(5)
    frame = rng.standard_normal((24, 20))
    bp = np.zeros(frame.shape, dtype=bool)
    if name == "scattered":
        bp[rng.random(frame.shape) < 0.05] = True
    elif name == "even":
        # (5, 5) has 4 good neighbours: the median averages two middles
        bp[4:7, 4:7] = True
        bp[4, 4] = bp[4, 6] = bp[6, 4] = bp[6, 6] = False
        bp[5, 4] = bp[4, 5] = False
    elif name == "edges":
        bp[0, 0] = bp[0, 7] = bp[23, 19] = bp[12, 0] = bp[23, 3] = True
        bp[0, 1] = bp[1, 0] = True
    elif name == "clump":
        bp[6:14, 5:12] = True
    elif name == "stalled":
        # all bad but three pixels on a diagonal: no window of a bad pixel
        # holds three good ones after the first sweep's few
        bp[:] = True
        bp[0, 0] = bp[5, 5] = bp[10, 10] = False
    frame[bp] = np.nan
    return frame, bp


CASES = ("scattered", "even", "edges", "clump", "stalled")


@pytest.mark.parametrize("name", CASES)
def test_sigma_filter_frames_and_sweeps(name):
    frame, bp = _case(name)
    ref, nit = jbp.sigma_filter_device(frame, bp, min_neighbors=3)
    out, tnit = tbp.sigma_filter_device(frame, bp, min_neighbors=3)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(tnit) == int(nit)


@pytest.mark.parametrize("name", CASES)
def test_route_equals_dense_plain_version(name):
    frame, bp = _case(name)
    cube = torch.as_tensor(np.stack([frame, frame[::-1].copy()]))
    bps = torch.as_tensor(np.stack([bp, bp[::-1].copy()]))
    out, nit = tbp._sigma_filter_gathered(cube, bps, 3)
    dense, dnit = tbp._sigma_filter_dense(cube, bps, 3)
    assert torch.equal(out.nan_to_num(7.0), dense.nan_to_num(7.0))
    assert torch.equal(nit, dnit)


@pytest.mark.parametrize("name", ("scattered", "even", "edges", "clump"))
def test_sigma_filter_against_the_host_loop(name):
    frame, bp = _case(name)
    ref = jcs._sigma_filter_host(frame.copy(), bp.astype(int))
    out, _ = tbp.sigma_filter_device(frame, bp)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_cube_sigma_filter_sweeps_per_frame():
    frames, bps = zip(*(_case(n) for n in CASES))
    cube, bp = np.stack(frames), np.stack(bps)
    ref, nits = jbp.cube_sigma_filter_device(cube, bp)
    out, tnits = tbp.cube_sigma_filter_device(cube, bp)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tnits.numpy(), np.asarray(nits))
    assert len(set(tnits.tolist())) > 1
    # the stalled frame stops after the sweep that fixed nothing, its bad
    # pixels left as they were
    assert torch.isnan(out[CASES.index("stalled")]).any()


def test_integer_frames_become_float32():
    frame, bp = _case("scattered")
    raw = np.nan_to_num(frame * 100).astype(np.int32)
    ref, _ = jbp.sigma_filter_device(raw, bp)
    out, _ = tbp.sigma_filter_device(raw, bp)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("hw", ((1, 1), (2, 2), (1, 2)))
@pytest.mark.parametrize("mad", (False, True))
@pytest.mark.parametrize("min_std", (None, 0.8))
def test_clip_neighbor(hw, mad, min_std):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((21, 18))
    a[rng.random(a.shape) < 0.03] += 8
    gpm = rng.random(a.shape) > 0.1
    kw = dict(mad=mad, has_min_std=min_std is not None,
              min_std=0.0 if min_std is None else min_std)
    ref = jbp.clip_neighbor_device(a, gpm, 2.5, 2.0, *hw, **kw)
    out = tbp.clip_neighbor_device(a, gpm, 2.5, 2.0, *hw, **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("size", (3, 5))
def test_median_filter(size):
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((2, 3, 15, 12))
    ref = np.asarray(jbp.median_filter_device(frames, size))
    out = tbp.median_filter_device(frames, size).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        out[1, 2], scipy.ndimage.median_filter(frames[1, 2], size,
                                               mode="mirror"))
