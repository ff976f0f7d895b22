"""The one request generator: it reads a traffic file and turns the seed
into the cell's stream of requests.

A traffic file (``benchmark/traffic/<name>.json``) gives:

- ``entry``: the program's function each request calls, as
  "module:attribute";
- ``args``: the names of the sequence's fields passed positionally
  ("cube", "angles"), ``inputs``: keywords taken from the sequence's
  extras (such as "scale_list"), ``kwargs``: fixed keywords;
- ``draws``: keywords drawn per request, each {"int": [lo, hi]} or
  {"tuple": [draw, ...]}, inclusive;
- ``reference``: the name of the plain reference under
  ``benchmark/references``;
- ``warmup``: requests made during set-up, ``trace_requests``: requests a
  ``--trace 1`` run traces, and ``check``: how many requests the
  comparison samples and the limit of each number it compares.

Requests run in a closed loop, one client: the next is sent when the
last one's frame is back. Request i reduces pool member i mod pool. Every
seed draws the same values in another order: the drawn keywords cycle
through all their combinations, each block of combinations shuffled by
the seed, so no seed changes the work.
"""

import importlib
import itertools
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    index: int
    member: int
    drawn: dict
    frames: int = 0
    kwargs: dict = field(default_factory=dict)


def _values(draw):
    if "int" in draw:
        lo, hi = draw["int"]
        return [int(v) for v in range(lo, hi + 1)]
    if "tuple" in draw:
        return [tuple(c) for c in itertools.product(
            *[_values(d) for d in draw["tuple"]])]
    raise ValueError(f"unknown draw {draw!r}")


def combinations(traffic):
    """Every combination of the drawn keywords, as dicts, in a fixed
    order."""
    names = sorted(traffic.get("draws", {}))
    vals = [_values(traffic["draws"][k]) for k in names]
    return [dict(zip(names, c)) for c in itertools.product(*vals)]


def resolve_entry(traffic):
    mod, attr = traffic["entry"].split(":")
    return getattr(importlib.import_module(mod), attr)


class Stream:
    """The requests of one run: ``next()`` gives request after request."""

    def __init__(self, traffic, seed, pool_size):
        self.traffic = traffic
        self.combos = combinations(traffic)
        self.rng = np.random.default_rng([seed, 7])
        self.pool_size = pool_size
        self.order = []
        self.count = 0

    def next(self):
        i = self.count
        if not self.order:
            self.order = list(self.rng.permutation(len(self.combos)))
        drawn = dict(self.combos[self.order.pop(0)])
        self.count += 1
        return Request(i, i % self.pool_size, drawn)


def warmup_requests(traffic):
    """Set-up's requests: the first and the last combination, on pool
    member 0 (every shape the traffic sends: only the drawn values
    differ between requests)."""
    combos = combinations(traffic)
    picks = [combos[0], combos[-1]][:traffic.get("warmup", 2)]
    return [Request(-1 - j, 0, dict(c)) for j, c in enumerate(picks)]


def call_arguments(traffic, seq, req):
    """(args, kwargs) of the program's call for request ``req`` on the
    sequence ``seq``; the keywords are also kept on the request, for the
    reference."""
    fields = {"cube": seq.cube, "angles": seq.angles}
    args = [fields[a] for a in traffic["args"]]
    kwargs = dict(traffic.get("kwargs", {}))
    for k, src in traffic.get("inputs", {}).items():
        kwargs[k] = seq.extras[src]
    kwargs.update(req.drawn)
    req.kwargs = kwargs
    req.frames = int(seq.cube.numel() // (seq.cube.shape[-1]
                                          * seq.cube.shape[-2]))
    return args, kwargs
