"""The selection plan of H1's digit body (csrc/nanmedian.cu,
``nanmedian_digits_kernel``), on the CPU: a numpy emulation of its
sweeps over the uint32 keys, step for step, against the plain median.

The emulation keeps the kernel's layout: a block of 32 pixels (one a lane)
and 32 warps, warp w holding the keys of frames w, w + 32, ... in its slots
(w + 32·j, lane); the top-digit histogram of the load sweep; 16-bit
counters two bins a word; each warp's scan of its 8 bins, the lower warps'
totals as its base; r1's and r2's bins and ranks; the second sweep's
compaction of r1's top-digit bin into each thread's first slots (written in
place, never past the slot being read); the later sweeps over those
candidates alone; r2 parting from r1 and its key as its bin's minimum, or
the bin itself after the last histogram. The output must equal
``nanmedian_plain`` bit for bit, and numpy's nanmedian / median within one
float32 ulp, on NaNs, all-NaN and half-NaN pixels, ±0.0, denormals, ±inf,
heavy duplicates, one and two frames, odd and even counts, both propagate
modes. Which body takes which frame count is a pure function of n
(``ops.median.median_body``), tested here too.
"""

import numpy as np
import pytest
import torch

import vip_tpu_torch

from vip_tpu_torch.ops import median

WARPS, PX, BINS, CHUNK = 32, 32, 256, 8
NAN_KEY = np.uint32(0xFFFFFFFF)


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    """The port runs numpy input on the CUDA card unless asked otherwise;
    this module asks for the CPU (float64 parity mode). It decides nothing
    by probing for a card."""
    vip_tpu_torch.set_device("cpu")


def _to_key(x):
    u = x.astype(np.float32).view(np.uint32)
    k = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(x), NAN_KEY, k)


def _from_key(k):
    u = np.where(k & 0x80000000, k ^ 0x80000000, ~k).astype(np.uint32)
    return u.view(np.float32)


def _bump(words, k, on, s):
    """The kernel's bump of digit (k >> s) & 255 where `on`: bins 2i and
    2i+1 in the low and high half of word i of the lane's pixel."""
    d = (k >> s) & 255
    add = np.where(on, np.uint64(1) << ((d & 1) << 4).astype(np.uint64), 0)
    np.add.at(words, (d >> 1, np.arange(PX)), add)


def _unpack(words):
    assert np.all(words < 2 ** 32)          # no carry out of a word
    hist = np.empty((BINS, PX), dtype=np.int64)
    hist[0::2], hist[1::2] = words & 0xFFFF, words >> 16
    return hist


def _scan(hist, r):
    """The warps' scan: warp w's 8 bins, its base the lower warps' totals;
    the warp whose bins hold rank r finds the bin and the count below."""
    tot = hist.reshape(WARPS, CHUNK, PX).sum(1)
    base = np.cumsum(tot, 0) - tot
    d = np.full(PX, -1)
    below = np.zeros(PX, dtype=np.int64)
    for w in range(WARPS):
        mine = (base[w] < r) & (r <= base[w] + tot[w])
        acc = base[w].copy()
        found = np.zeros(PX, dtype=bool)
        for j in range(CHUNK):
            c = hist[w * CHUNK + j]
            hit = mine & ~found & (acc + c >= r)
            d = np.where(hit, w * CHUNK + j, d)
            below = np.where(hit, acc, below)
            found |= hit
            acc = acc + c
    assert np.all(d >= 0)        # exactly one warp finds every rank
    return d.astype(np.uint32), r - below


def _digits_median(x, propagate):
    """The digit body on one block: x is (n, 32) float32."""
    n = x.shape[0]
    keys = _to_key(x)
    slots = [keys[w::WARPS].copy() for w in range(WARPS)]
    nf = [sl.shape[0] for sl in slots]
    nc = [np.zeros(PX, dtype=np.int64) for _ in range(WARPS)]
    pre = np.zeros(PX, dtype=np.uint32)
    split = np.zeros(PX, dtype=bool)
    pre2 = np.zeros(PX, dtype=np.uint32)
    sh2 = np.zeros(PX, dtype=np.uint32)
    min2 = np.full(PX, NAN_KEY)
    words = np.zeros((BINS // 2, PX), dtype=np.uint64)
    for w in range(WARPS):                   # the load sweep
        for j in range(nf[w]):
            _bump(words, slots[w][j], np.ones(PX, dtype=bool), 24)
    m = (keys != NAN_KEY).sum(0)
    r1 = np.where(m > 0, (m - 1) // 2 + 1, 1)
    r2 = m // 2 + 1
    for s in (24, 16, 8, 0):
        if s < 24:
            words = np.zeros((BINS // 2, PX), dtype=np.uint64)
            take_min = split & (sh2 == s + 8)
            for w in range(WARPS):
                lim = np.full(PX, nf[w]) if s == 16 else nc[w].copy()
                for j in range(int(lim.max(initial=0))):
                    k = slots[w][j].copy()
                    live = j < lim
                    on = live & ((k >> (s + 8)) == pre)
                    _bump(words, k, on, s)
                    if s == 16:              # keep r1's top-digit bin
                        at = nc[w][on]
                        assert np.all(at <= j)   # in place, no clobber
                        slots[w][at, np.arange(PX)[on]] = k[on]
                        nc[w] += on
                    want = live & take_min & ((k >> sh2) == pre2)
                    min2 = np.where(want, np.minimum(min2, k), min2)
        hist = _unpack(words)
        d1, q1 = _scan(hist, r1)
        d2, q2 = _scan(hist, np.where(split, r1, r2))
        part = ~split & (d2 != d1)
        pre2 = np.where(part, (pre << 8) | d2, pre2).astype(np.uint32)
        sh2 = np.where(part, s, sh2).astype(np.uint32)
        r2 = np.where(split, r2, q2)
        split |= part
        pre = ((pre << 8) | d1).astype(np.uint32)
        r1 = q1
    k2 = np.where(~split, pre, np.where(sh2 == 0, pre2, min2))
    with np.errstate(all="ignore"):
        med = np.float32(0.5) * (_from_key(pre) + _from_key(k2))
    bad = (m == 0) | ((m < n) if propagate else False)
    return np.where(bad, np.float32(np.nan), med).astype(np.float32)


def _pixels(n, seed):
    """32 pixels of n frames: ±inf, ±0.0, zeros, half-NaN and all-NaN
    pixels, denormals, heavy duplicates, a constant pixel (every key a
    candidate), two values, a median between two bins, consecutive
    floats, middles that part at each histogram, values over many
    decades."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 32)) * 100
    i = np.arange(n)
    x[min(3, n - 1), 1] = np.inf
    x[min(5, n - 1), 2] = -np.inf
    x[:, 3] = -0.0
    x[: n // 2, 4] = 0.0
    x[::2, 5] = np.nan
    x[:, 6] = np.nan
    x[min(7, n - 1), 7] = 1e-42
    x[min(8, n - 1), 8] = -1e-42
    x[:, 9] = np.round(rng.standard_normal(n) * 2)
    x[:, 10] = 3.0
    x[:, 11] = np.where(i % 2, 1.0, 2.0 ** -20)
    x[:, 12] = np.where(i < n // 2, -1.0, 1.0)
    x[:, 13] = rng.choice([1e-42, -1e-42, 0.0, -0.0], n)
    x[:, 14] = 1.0 + i * 2.0 ** -23
    x[min(1, n - 1), 15] = np.nan
    x[:, 16] = np.where(i % 3 == 0, np.inf, -np.inf)
    # two middles whose keys first differ in the second, third and fourth
    # digit: r2 parts from r1 after each of those histograms
    for col, ulps in ((17, 2 ** 16), (18, 2 ** 8), (19, 1)):
        x[:, col] = np.where(i < n // 2, 1.0, 1.0 + ulps * 2.0 ** -23)
    x[:, 20:] *= 10.0 ** rng.integers(-35, 35, size=12)
    return x.astype(np.float32)


@pytest.mark.parametrize("propagate", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 16, 17, 64, 301])
def test_digit_selection_is_the_plain_median(n, propagate):
    x = _pixels(n, seed=n)
    got = _digits_median(x, propagate)
    ref = median.nanmedian_plain(torch.from_numpy(x), 0, propagate).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    with np.errstate(all="ignore"):
        npref = (np.median if propagate else np.nanmedian)(
            x.astype(np.float64), axis=0)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(npref))
    ok = np.isfinite(npref)
    ulp = np.spacing(np.abs(npref[ok]).astype(np.float32))
    assert np.all(np.abs(got[ok] - npref[ok]) <= ulp)
    inf = np.isinf(npref)
    np.testing.assert_array_equal(got[inf], npref[inf])


def test_gate_is_a_function_of_the_frame_count():
    """Up to 1650 frames the digit body (32 pixels of keys, the packed
    histograms, the warps' totals and six state words a pixel within a
    block's 227 KB), up to 3600 the bisection body (16 pixels of keys and
    two partial-count buffers), none beyond; no frame count that H1 took
    falls to the plain sort."""
    smem = 232448
    digit_fixed = 4 * PX * (BINS // 2 + WARPS + 6)
    assert median._DIGIT_MAX_FRAMES == (smem - digit_fixed) // (4 * PX)
    assert median._MAX_FRAMES == (smem - 2 * 16 * 16 * 4) // (4 * 16)
    for n in range(0, 3700):
        body = median.median_body(n)
        want = (None if not 1 <= n <= 3600
                else "digits" if n <= 1650 else "bisection")
        assert body == want, n