"""The one generator every traffic mix goes through.

A mix file (``bench/mixes/<traffic>.json``) gives, for each parameter of
a request, a draw rule; this module turns a rule, the run's seed and the
parameter's name into values. Rules:

    {"fixed": v}                    v every time
    {"permutation": [lo, hi]}       the integers lo..hi in a seeded order,
                                    request k takes the k-th (no repeats)
    {"repeat": [v0, v1, ...]}       the list over and over, the same for
                                    every seed: every window of one
                                    length carries the same sizes
    {"cycle": [w0, w1, ...]}        blocks holding each i w_i times, each
                                    block in a seeded order
    {"uniform": [lo, hi]}           real, uniform (per-request vectors)
    {"log_uniform": [lo, hi]}       real, uniform in log

`Sequence` gives request k's value of a parameter (the first four);
`sample` draws n values at once for a per-request vector.
Streams are keyed by the seed, the parameter's name and, for vectors,
the request's index, so runs with one seed send the same requests.
"""
from __future__ import annotations

import zlib
from typing import Any, Dict, List

import numpy as np


def _stream(seed: int, name: str, *extra: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**63 - 1), zlib.crc32(name.encode()),
                                  *extra])


class Sequence:
    """Request k's value of one parameter under one rule."""

    def __init__(self, rule: Dict[str, Any], seed: int, name: str):
        (self.kind, self.arg), = rule.items()
        self.rng = _stream(seed, name)
        self.values: List[Any] = []
        if self.kind == "permutation":
            lo, hi = self.arg
            self.values = self.rng.permutation(np.arange(lo, hi + 1)).tolist()
        elif self.kind == "repeat":
            self.values = list(self.arg)
        elif self.kind not in ("fixed", "cycle"):
            raise ValueError(f"rule {self.kind!r} makes no sequence")

    def _block(self) -> List[int]:
        block = np.repeat(np.arange(len(self.arg)), self.arg)
        return self.rng.permutation(block).tolist()

    def __getitem__(self, k: int) -> Any:
        if self.kind == "fixed":
            return self.arg
        if self.kind == "repeat":
            return self.values[k % len(self.values)]
        if self.kind == "permutation":
            if k >= len(self.values):
                raise IndexError(f"the mix has only {len(self.values)} "
                                 "distinct values for this parameter")
            return self.values[k]
        while k >= len(self.values):
            self.values += self._block()
        return self.values[k]


def sample(rule: Dict[str, Any], rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` draws of one rule as f64."""
    (kind, arg), = rule.items()
    if kind == "fixed":
        return np.full(n, float(arg))
    if kind == "uniform":
        return rng.uniform(arg[0], arg[1], n)
    if kind == "log_uniform":
        return np.exp(rng.uniform(np.log(arg[0]), np.log(arg[1]), n))
    raise ValueError(f"rule {kind!r} draws no vector")


def request_stream(seed: int, name: str, k: int) -> np.random.Generator:
    """The generator of request ``k``'s vectors."""
    return _stream(seed, name, k)
