"""The one general traffic generator: every mix is a data file of
parameters (``gpubench/traffic/<name>.json``) that this module reads.

Lengths and gaps are stratified: ``n`` draws of a distribution are its
quantiles at ``(i + 0.5) / n``, in an order the seed permutes. Every
seed then offers the same set of sizes and arrivals in another order, so
the seed changes which request comes when, not how much work a run
holds. Token ids are uniform over the vocabulary, drawn from the seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, Iterator, List

import numpy as np

_TAGS = {"prompt": 1, "output": 2, "gaps": 3, "tokens": 4, "docs": 5,
         "sample": 7}


def rng(seed: int, tag: str) -> np.random.Generator:
    """A generator for one purpose of one run: seeds of any size, each
    purpose its own stream."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2 ** 64,
                                                         _TAGS[tag]]))


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """``n`` stratified draws of ``dist`` in ascending order: a lognormal
    (``median``, ``sigma``) or an exponential (``mean``), rounded to
    whole numbers and clipped to ``[min, max]`` where given."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "exponential":
        return -np.log1p(-u) * dist["mean"]
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    x = np.rint(x)
    return np.clip(x, dist.get("min", 1), dist.get("max", np.inf)).astype(np.int64)


@dataclass
class Req:
    rid: int
    due_s: float          # offset from the window's start (open loop)
    prompt: np.ndarray    # int32 token ids
    max_new: int


def _tokens(r: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return r.integers(0, vocab, n, dtype=np.int64).astype(np.int32)


def open_loop(traffic: Dict, rate: float, seconds: float, seed: int,
              vocab: int) -> List[Req]:
    """Poisson arrivals at ``rate`` a second over ``[0, seconds)``: the
    ``round(rate * seconds)`` requests' gaps are exponential quantiles
    scaled to sum to ``seconds``, each request's prompt and answer
    lengths the traffic's quantiles, each of the three permuted on its
    own by the seed."""
    n = max(1, int(round(rate * seconds)))
    prompts = rng(seed, "prompt").permutation(quantiles(traffic["prompt"], n))
    outs = rng(seed, "output").permutation(quantiles(traffic["output"], n))
    gaps = rng(seed, "gaps").permutation(
        quantiles({"dist": "exponential", "mean": 1.0 / rate}, n))
    gaps = gaps * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    tr = rng(seed, "tokens")
    return [Req(i, float(due[i]), _tokens(tr, int(prompts[i]), vocab), int(outs[i]))
            for i in range(n)]


def closed_loop(traffic: Dict, seed: int, vocab: int,
                table: int = 256) -> Iterator[Req]:
    """An endless stream of requests for a closed loop: a table of
    ``table`` prompt and answer lengths (the traffic's quantiles, each
    permuted by the seed), taken in turn and begun again when spent."""
    prompts = rng(seed, "prompt").permutation(quantiles(traffic["prompt"], table))
    outs = rng(seed, "output").permutation(quantiles(traffic["output"], table))
    tr = rng(seed, "tokens")
    i = 0
    while True:
        k = i % table
        yield Req(i, 0.0, _tokens(tr, int(prompts[k]), vocab), int(outs[k]))
        i += 1


def packed_layout(traffic: Dict, rows: int, seq_len: int, seed: int) -> np.ndarray:
    """Segment ids ``[rows, seq_len + 1]`` (1-based within a row) of
    documents packed end to end: enough of the document-length quantiles
    to fill every row, in the seed's order; a document that reaches a
    row's end is cut there and goes on as the next row's first
    segment."""
    doc = traffic["doc"]
    width = seq_len + 1
    need = rows * width
    n = max(1, int(math.ceil(need / max(1.0, doc["median"]))) * 2)
    lengths = quantiles(doc, n)
    while lengths.sum() < need:
        n *= 2
        lengths = quantiles(doc, n)
    lengths = list(rng(seed, "docs").permutation(lengths))
    segs = np.zeros((rows, width), np.int32)
    for b in range(rows):
        pos, seg = 0, 1
        while pos < width:
            take = min(int(lengths[0]), width - pos)
            segs[b, pos:pos + take] = seg
            if take < lengths[0]:
                lengths[0] -= take
            else:
                lengths.pop(0)
            pos += take
            seg += 1
    return segs


def doc_lengths(segs_row: np.ndarray) -> List[int]:
    """The lengths of a row's segments, in order."""
    out, start = [], 0
    for i in range(1, len(segs_row) + 1):
        if i == len(segs_row) or segs_row[i] != segs_row[start]:
            out.append(i - start)
            start = i
    return out


def sample_indices(n: int, weights: List[int], want: int, seed: int) -> List[int]:
    """Indices of finished requests to check: the one with the most
    served tokens, then others in the seed's order until their tokens
    reach ``want``."""
    if n == 0:
        return []
    first = int(np.argmax(weights))
    order = [int(i) for i in rng(seed, "sample").permutation(n) if i != first]
    picked, total = [first], weights[first]
    for i in order:
        if total >= want:
            break
        picked.append(i)
        total += weights[i]
    return picked
