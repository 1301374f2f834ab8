"""The general traffic generator: deterministic in the seed, the stated
distributions, the same work for every seed."""

import numpy as np
import pytest

from gpubench.harness import spec
from gpubench.harness import traffic as tr

CHAT = spec.traffic_file("chat")
DOCS = spec.traffic_file("packed_docs")


def test_open_loop_is_deterministic_in_the_seed():
    a = tr.open_loop(CHAT, 4.0, 30, 2 ** 31 + 12345, 32000)
    b = tr.open_loop(CHAT, 4.0, 30, 2 ** 31 + 12345, 32000)
    c = tr.open_loop(CHAT, 4.0, 30, 2 ** 31 + 12346, 32000)
    assert [(q.due_s, q.max_new, q.prompt.tolist()) for q in a] == \
        [(q.due_s, q.max_new, q.prompt.tolist()) for q in b]
    assert [q.prompt.size for q in a] != [q.prompt.size for q in c]


def test_every_seed_offers_the_same_work_in_another_order():
    a = tr.open_loop(CHAT, 4.0, 30, 1, 32000)
    b = tr.open_loop(CHAT, 4.0, 30, 2, 32000)
    assert sorted(q.prompt.size for q in a) == sorted(q.prompt.size for q in b)
    assert sorted(q.max_new for q in a) == sorted(q.max_new for q in b)
    assert len(a) == len(b) == 120
    assert [q.prompt.size for q in a] != [q.prompt.size for q in b]
    assert max(q.due_s for q in a + b) < 30


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 1])
def test_open_loop_draws_the_stated_distributions(seed):
    reqs = tr.open_loop(CHAT, 5.0, 200, seed, 32000)
    p = np.array([q.prompt.size for q in reqs])
    o = np.array([q.max_new for q in reqs])
    assert p.min() >= 64 and p.max() <= 2048 and o.min() >= 16 and o.max() <= 512
    assert abs(np.median(p) - 512) <= 2 and abs(np.median(o) - 128) <= 2
    # lognormal: the log's quartiles at median * exp(+-0.674 sigma)
    q1, q3 = np.percentile(np.log(p), [25, 75])
    assert abs((q3 - q1) / 2 - 0.6745 * 0.8) < 0.02
    due = np.array([q.due_s for q in reqs])
    assert due[0] == 0 and np.all(np.diff(due) > 0) and due[-1] < 200
    gaps = np.diff(due)
    assert abs(gaps.mean() - 0.2) < 0.01
    assert abs(np.median(gaps) / gaps.mean() - np.log(2)) < 0.05   # exponential
    assert all(0 <= q.prompt.min() and q.prompt.max() < 32000 for q in reqs)


def test_closed_loop_cycles_its_table():
    s = tr.closed_loop(CHAT, 3, 1000, table=16)
    first = [next(s) for _ in range(32)]
    assert [q.max_new for q in first[:16]] == [q.max_new for q in first[16:]]
    assert [q.rid for q in first] == list(range(32))


@pytest.mark.parametrize("seed", [1, 99])
def test_packed_layout_fills_every_row(seed):
    segs = tr.packed_layout(DOCS, 8, 4096, seed)
    assert segs.shape == (8, 4097) and segs.min() >= 1
    lengths = [n for row in segs for n in tr.doc_lengths(row)]
    assert sum(lengths) == 8 * 4097 and max(lengths) <= 4096
    assert np.array_equal(segs, tr.packed_layout(DOCS, 8, 4096, seed))
    for row in segs:
        assert np.all(np.diff(row) >= 0) and row[0] == 1


def test_doc_lengths_and_sample_indices():
    assert tr.doc_lengths(np.array([1, 1, 2, 3, 3, 3])) == [2, 1, 3]
    idx = tr.sample_indices(5, [3, 10, 2, 2, 2], 14, seed=4)
    assert idx[0] == 1 and sum([3, 10, 2, 2, 2][i] for i in idx) >= 14
    assert tr.sample_indices(0, [], 10, 1) == []
