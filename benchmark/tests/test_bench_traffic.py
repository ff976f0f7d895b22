"""The request maker and the sequences are deterministic for a seed, and
every seed sends the same work in another order."""

import collections

import numpy as np
import torch

from yardstick import sequences
from yardstick.traffic import Stream, combinations, warmup_requests

from conftest import tiny


def _drawn(traffic, seed, n, pool=4):
    s = Stream(traffic, seed, pool)
    return [(r.member, tuple(sorted(r.drawn.items())))
            for r in (s.next() for _ in range(n))]


def test_the_stream_is_deterministic_for_a_seed():
    for name in ("adi512.pca_fullfr", "ifs290.pca_single",
                 "ifs290.pca_double"):
        tr = tiny(name).traffic
        big = 2 ** 31 + 12345
        assert _drawn(tr, big, 100) == _drawn(tr, big, 100)
        assert _drawn(tr, big, 100) != _drawn(tr, big + 1, 100)


def test_every_seed_draws_the_same_values_in_another_order():
    tr = tiny("ifs290.pca_double").traffic
    block = len(combinations(tr))
    assert block == 3 * 11
    counts = [collections.Counter(d for _, d in _drawn(tr, seed, 2 * block))
              for seed in (1, 2 ** 31 + 7)]
    assert counts[0] == counts[1]
    assert set(counts[0].values()) == {2}


def test_warm_up_covers_the_ends_of_the_draws():
    tr = tiny("adi512.pca_fullfr").traffic
    assert [r.drawn["ncomp"] for r in warmup_requests(tr)] == [5, 30]


def test_sequences_are_deterministic_for_a_seed():
    for name in ("adi512.pca_fullfr", "ifs290.pca_double"):
        cfg = tiny(name).config
        a = sequences.make_sequence(cfg, 2 ** 31 + 99, 1, torch.device("cpu"))
        b = sequences.make_sequence(cfg, 2 ** 31 + 99, 1, torch.device("cpu"))
        c = sequences.make_sequence(cfg, 2 ** 31 + 98, 1, torch.device("cpu"))
        assert torch.equal(a.cube, b.cube) and not torch.equal(a.cube, c.cube)
        np.testing.assert_array_equal(a.angles, b.angles)
        assert a.cube.dtype == torch.float32
        assert np.array_equal(a.angles.astype(np.float32), a.angles)


def test_the_ifs_speckles_align_after_rescaling():
    """A speckle pattern at λ is the pattern at λmax shrunk by λ/λmax, so
    VIP's zoom by λmax/λ aligns it with the λmax channel."""
    from yardstick import plain

    rng = np.random.default_rng(3)
    s = 1.4210526
    pats = sequences._patterns(rng, 1, 96, [s, 1.0], 1 / 4.55,
                               torch.device("cpu"))[0]
    zoomed = plain.zoom(pats[:1], s)[0] * s ** 2     # flux-conserving zoom
    core = slice(28, 68)
    a, b = zoomed[core, core].flatten(), pats[1][core, core].flatten()
    raw = pats[0][core, core].flatten()
    assert torch.corrcoef(torch.stack((a, b)))[0, 1] > 0.99
    assert abs(torch.corrcoef(torch.stack((raw, b)))[0, 1]) < 0.5
