"""The one traffic generator: a mix file of parameters -> each client's
list of requests, from ``--seed``.

A mix is a closed loop: ``clients`` clients each send their next
request as soon as the last one completes. Lengths are drawn so that
every seed gives the same work in another order: round r (the r-th
request of every client) takes the ``clients`` stratified quantiles
(i + 1/2) / clients of each length distribution, in a pairing fixed for
the round, and the seed only deals them out among the clients.
Documents (a mix with ``document``) are one per client, stratified the
same way, and are sent whole once during set-up so that the prefix
cache holds them. Token ids are drawn from the seed, uniform over the
vocabulary.

Distributions: ``{"dist": "uniform", "min": a, "max": b}`` (integers,
both ends included) and ``{"dist": "lognormal", "median": m, "sigma":
s, "min": a, "max": b}`` (clipped to [a, b]).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import List

import numpy as np


@dataclasses.dataclass
class Request:
    client: int
    round: int
    prompt: List[int]
    max_tokens: int
    doc_len: int = 0        # leading tokens that are the client's document


def quantiles(spec: dict, n: int) -> List[int]:
    """The n stratified quantiles (i + 1/2) / n of ``spec``."""
    qs = [(i + 0.5) / n for i in range(n)]
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        vals = [lo + q * (hi - lo + 1) - 0.5 for q in qs]
    elif spec["dist"] == "lognormal":
        nd = statistics.NormalDist()
        vals = [spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf(q))
                for q in qs]
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return [min(hi, max(lo, int(round(v)))) for v in vals]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the run's seed (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


class Traffic:
    """The requests of one mix and seed, made on demand: ``request(c, r)``
    is client c's r-th request (the same for the same seed).

    Sizes do not depend on the seed: in round r, the client of rank k
    takes the k-th entry of fixed permutations of the stratified prompt
    and output lengths (and the k-th document length), so every seed
    serves the same (document, prompt, output) triples in every round.
    The seed deals the ranks to the clients, which sets the order the
    start's burst arrives in, and draws every token id."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        n = self.clients = int(mix["clients"])
        self.rank = rng_for(seed, 1).permutation(n)
        self._p = quantiles(mix["prompt"], n)
        self._o = quantiles(mix["output"], n)
        spec = mix.get("document")
        rng = rng_for(seed, 2)
        if spec:
            lens = quantiles(spec, n)
            self.docs = [rng.integers(0, vocab, lens[self.rank[c]]).tolist()
                         for c in range(n)]
        else:
            self.docs = [[] for _ in range(n)]
        self._rounds = {}

    def _round(self, r: int):
        got = self._rounds.get(r)
        if got is None:
            fixed = np.random.default_rng([1000, r])
            got = (fixed.permutation(self._p), fixed.permutation(self._o))
            self._rounds[r] = got
        return got

    def request(self, client: int, r: int) -> Request:
        p_len, o_len = self._round(r)
        k = self.rank[client]
        rng = np.random.default_rng([self.seed % (1 << 64), 3, r, client])
        fresh = rng.integers(0, self.vocab, int(p_len[k])).tolist()
        doc = self.docs[client]
        return Request(client, r, doc + fresh, int(o_len[k]), len(doc))


def max_context(mix: dict) -> int:
    """The longest sequence (document, prompt and output) the mix makes."""
    doc = int(mix["document"]["max"]) if mix.get("document") else 0
    return doc + int(mix["prompt"]["max"]) + int(mix["output"]["max"])
