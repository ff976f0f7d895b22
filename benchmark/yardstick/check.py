"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests it completed, drawn
from the seed, is reduced again by the plain reference, on the same
device, from the same sequences and keywords: once in float64 and once in
float32 with TF32 off (a plain float32 witness). ``frame_gap`` of a frame
is its largest absolute difference from the float64 frame, as a share of
the largest absolute value of the input sequence.

The number compared is ``gap_vs_float32``: the program's frame_gap over
the witness's, the worst over the sample: how many times farther from
float64 the program lands than a plain float32 computation of the same
reduction. The gap alone swings with the request: the more components a
full-frame PCA subtracts, the nearer the last of them lie, and the more
float32 turns them (up to a hundredfold between ncomp 5 and 30 at
1000x512², in the program and the witness alike), while computing in
TF32 lands tens of times farther than float32 on every request. A
request that failed, or a frame that is not finite or not of the
reference's shape, reads as infinite.
"""

import math

import numpy as np
import torch


def input_scale(cube):
    """The largest absolute value of a sequence."""
    return float(cube.abs().max())


def frame_gap(frame, ref, scale):
    """max |frame - ref| / scale; infinite for a missing, misshapen or
    non-finite frame."""
    ref = ref.detach().to(torch.float64).cpu().numpy()
    if frame is None or np.shape(frame) != ref.shape \
            or not np.all(np.isfinite(frame)):
        return math.inf
    return float(np.max(np.abs(frame.astype(np.float64) - ref)) / scale)


def sample(records, count, seed):
    """Indices of ``count`` records drawn from the seed (all of them when
    there are fewer)."""
    rng = np.random.default_rng([seed, 11])
    k = min(count, len(records))
    return sorted(int(i) for i in rng.choice(len(records), k, replace=False))


def reference_gaps(records, idx, pool, reduce_ref):
    """[(program frame_gap, witness frame_gap)] of each sampled record,
    against ``reduce_ref`` run on its request's sequence and keywords."""
    gaps = []
    for i in idx:
        rec = records[i]
        if rec.error:
            gaps.append((math.inf, 1.0))
            continue
        seq = pool[rec.request.member]
        scale = input_scale(seq.cube)
        ref = reduce_ref(seq.cube, seq.angles, rec.request.kwargs, "float64")
        wit = reduce_ref(seq.cube, seq.angles, rec.request.kwargs, "float32")
        gaps.append((frame_gap(rec.frame, ref, scale),
                     frame_gap(wit.to(torch.float64).cpu().numpy(), ref,
                               scale)))
        del ref, wit
    return gaps


def verdict(gaps, records, limits):
    """(correct, numbers): numbers is {name: {"value", "limit"}}."""
    failed = sum(r.error is not None for r in records)
    ratio = max((p / w for p, w in gaps), default=math.inf)
    numbers = {"gap_vs_float32": {"value": ratio,
                                  "limit": limits["gap_vs_float32"]},
               "failed": {"value": failed, "limit": 0}}
    correct = failed == 0 and ratio <= limits["gap_vs_float32"]
    return correct, numbers
